"""Weighted per-pixel multiclass log loss.

The device-side equivalent of dlib's ``loss_multiclass_log_per_pixel_weighted``
(used via NetPimpl, see annonet_train.h:80 and SURVEY.md §2.2): per-pixel
softmax cross-entropy where each pixel's contribution (and gradient) is
scaled by its weight; ignored pixels carry weight 0. The loss is averaged
over all pixels of the minibatch (dlib convention: scale 1/(N*H*W)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from annonet_jax.classes import IGNORE_LABEL


def weighted_pixel_cross_entropy(
    logits: jnp.ndarray,  # [N, H, W, K] float
    labels: jnp.ndarray,  # [N, H, W] integer (IGNORE_LABEL allowed)
    weights: jnp.ndarray,  # [N, H, W] float
) -> jnp.ndarray:
    """Scalar loss = mean over all pixels of weight * CE(softmax(logits), label)."""
    n, h, w, k = logits.shape
    valid = labels != IGNORE_LABEL
    safe = jnp.where(valid, labels, 0).astype(jnp.int32)
    log_probs = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    # one-hot select instead of take_along_axis: the gather (and its scatter
    # transpose in the backward) is avoided; compare-select fuses
    onehot = safe[..., None] == jnp.arange(k, dtype=jnp.int32)
    ce = -jnp.sum(jnp.where(onehot, log_probs, 0.0), axis=-1)
    ce = jnp.where(valid, ce, 0.0)
    return jnp.sum(ce * weights) / (n * h * w)
