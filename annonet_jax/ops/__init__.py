"""Compute-path ops (reference L0 equivalents): loss weighting, weighted
per-pixel cross-entropy, tile blending, connected components."""

from annonet_jax.ops.augment import augment_batch
from annonet_jax.ops.blobs import label_connected_blobs
from annonet_jax.ops.loss import weighted_pixel_cross_entropy
from annonet_jax.ops.weighting import batched_label_weights, set_weights

__all__ = [
    "augment_batch",
    "batched_label_weights",
    "label_connected_blobs",
    "set_weights",
    "weighted_pixel_cross_entropy",
]
