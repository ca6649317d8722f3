"""annonet_jax — a JAX/XLA semantic-segmentation framework.

A from-scratch rebuild of the capabilities of reunanen/annonet (a C++17/dlib
toolkit for training and applying semantic-segmentation CNNs on images
annotated with the "anno" labeling tool), redesigned for accelerators:

  * the DNN engine is JAX/XLA (NHWC, bfloat16 compute) instead of
    dlib/cuDNN (reference L0, see the reference's vcxproj file lists);
  * the model abstraction (`annonet_jax.models.SegmentationNet`) replaces the
    dlib-dnn-pimpl-wrapper TrainingNet/RuntimeNet pair (reference L1);
  * tiled large-image inference is batched XLA execution with on-device
    overlap blending (reference `annonet_infer.cpp`);
  * data parallelism is a `jax.sharding.Mesh` + shard_map gradient-psum
    (the reference is single-device; see SURVEY.md §2.3).

Public layering mirrors the reference's five layers (SURVEY.md §1):
  L0 engine          -> jax/XLA (annonet_jax.ops)
  L1 model           -> annonet_jax.models
  L2 data layer      -> annonet_jax.data, annonet_jax.classes
  L3 train/infer lib -> annonet_jax.train, annonet_jax.infer
  L4 CLI             -> annonet_jax.cli (annonet_train / annonet_infer)
"""

from annonet_jax.utils.environment import check_environment

check_environment()

from annonet_jax.classes import (  # noqa: E402
    AnnoClass,
    IGNORE_LABEL,
    RGBA_IGNORE,
    default_anno_classes,
    parse_anno_classes,
)

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level exports of the heavyweight (jax-importing) API."""
    if name in ("SegNetConfig",):
        from annonet_jax.models.segnet import SegNetConfig

        return SegNetConfig
    if name in ("Trainer", "TrainerConfig"):
        from annonet_jax.train import trainer

        return getattr(trainer, name)
    if name in ("TiledInferer", "annonet_infer"):
        from annonet_jax.infer import core

        return getattr(core, name)
    if name in ("save_model", "load_model"):
        from annonet_jax import serialization

        return getattr(serialization, name)
    if name in ("ServeClient", "ServeError"):
        # jax-free: talks to an annonet_serve sidecar over HTTP
        from annonet_jax import client

        return getattr(client, name)
    raise AttributeError(f"module 'annonet_jax' has no attribute {name!r}")


__all__ = [
    "AnnoClass",
    "IGNORE_LABEL",
    "RGBA_IGNORE",
    "SegNetConfig",
    "ServeClient",
    "ServeError",
    "TiledInferer",
    "Trainer",
    "TrainerConfig",
    "annonet_infer",
    "default_anno_classes",
    "load_model",
    "parse_anno_classes",
    "save_model",
    "__version__",
]
