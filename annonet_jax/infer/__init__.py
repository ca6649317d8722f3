"""Inference library (reference L3): tiled large-image inference with
on-device blending, plus evaluation (confusion matrices)."""

from annonet_jax.infer.core import (
    TiledInferer,
    annonet_infer,
    annonet_infer_batch,
)
from annonet_jax.infer.tiling import TilePlan, TilingParameters, plan_tiles
from annonet_jax.infer.evaluation import (
    ConfusionMatrix,
    format_confusion_matrix,
    update_confusion_matrix_per_pixel,
    update_confusion_matrix_per_region,
)

__all__ = [
    "ConfusionMatrix",
    "TiledInferer",
    "TilePlan",
    "TilingParameters",
    "annonet_infer",
    "format_confusion_matrix",
    "plan_tiles",
    "update_confusion_matrix_per_pixel",
    "update_confusion_matrix_per_region",
]
