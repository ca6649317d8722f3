"""Model abstraction (reference L1): the JAX SegmentationNet replacing the
dlib-dnn-pimpl-wrapper NetPimpl TrainingNet/RuntimeNet pair."""

from annonet_jax.models.folded_runtime import (
    apply_runtime_folded,
    fold_runtime_params,
)
from annonet_jax.models.quantized_runtime import (
    apply_folded_int8,
    collect_calibration,
    quantize_folded,
)
from annonet_jax.models.segnet import (
    SegNetConfig,
    apply_runtime,
    apply_train,
    fold_batchnorm,
    init_state,
    recommended_input_dimension,
    required_input_dimension,
)

__all__ = [
    "SegNetConfig",
    "apply_folded_int8",
    "apply_runtime_folded",
    "collect_calibration",
    "fold_runtime_params",
    "quantize_folded",
    "apply_runtime",
    "apply_train",
    "fold_batchnorm",
    "init_state",
    "recommended_input_dimension",
    "required_input_dimension",
]
