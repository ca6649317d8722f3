"""Per-pixel loss weighting: class/image balance interpolation.

Reference math reproduced from set_weights (annonet_train.h:20-83):

  * per-crop class histogram over non-ignored pixels
  * unnormalized per-class weight (average_count / count) ** class_weight —
    the average_count factor is constant across classes, so after
    normalization the weights are exactly ``count ** -class_weight`` rescaled
  * normalization so the total weight equals
    ``total_count * (nr*nc / total_count) ** image_weight``
  * ignored pixels get weight 0

class_weight interpolates pixel-balanced (0) <-> class-balanced (1);
image_weight pixel-balanced (0) <-> image-balanced (1). Golden vectors in
tests/test_weighting.py match test/annonet_test.cpp:54-120 exactly.

Two implementations:
  * ``set_weights`` — NumPy, one crop, vectorized (replaces the reference's
    per-pixel loops)
  * ``batched_label_weights`` — JAX, a whole [N,H,W] batch at once, jittable,
    meant to be fused into the train step so weighting runs on the device
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from annonet_jax.classes import IGNORE_LABEL


def set_weights(
    unweighted_label_image: np.ndarray,
    class_weight: float,
    image_weight: float,
) -> np.ndarray:
    """Compute the float32 weight image for one uint16 label crop.

    The reference represents the result as a matrix of
    ``weighted_label{label, weight}`` pairs (annonet_train.h:80); here labels
    and weights travel as two parallel arrays, which is the natural device
    layout.
    """
    labels = np.asarray(unweighted_label_image)
    nr, nc = labels.shape
    valid = labels != IGNORE_LABEL
    vals = labels[valid].astype(np.int64)
    total_count = vals.size

    out = np.zeros((nr, nc), dtype=np.float32)
    if total_count == 0:
        return out

    counts = np.bincount(vals)
    present = counts > 0
    unnormalized = np.zeros(counts.shape, dtype=np.float64)
    # (average_count/count)**cw with the constant average_count**cw dropped —
    # it cancels in the normalization below (annonet_train.h:60,67-71)
    unnormalized[present] = counts[present].astype(np.float64) ** (-class_weight)
    total_unnormalized = float((counts * unnormalized).sum())

    target_total = total_count * (nr * nc / total_count) ** image_weight
    label_weights = unnormalized * (target_total / total_unnormalized)

    out[valid] = label_weights[vals].astype(np.float32)
    return out


def batched_label_weights(
    labels: jnp.ndarray,
    class_weight: float,
    image_weight: float,
    class_count: int,
) -> jnp.ndarray:
    """Device-side batched set_weights: [N,H,W] int labels -> [N,H,W] f32.

    Same math as ``set_weights`` per batch element, fused into XLA (histogram
    via one-hot reduction — a matmul-shaped op). Labels equal
    to IGNORE_LABEL contribute nothing and get weight 0.
    """
    n, h, w = labels.shape
    valid = labels != IGNORE_LABEL
    safe = jnp.where(valid, labels, 0).astype(jnp.int32)

    # [N,H,W,K] one-hot as compare+mask: XLA fuses this into the reductions
    # and the final select below, so nothing K-wide is materialized and no
    # gather appears anywhere (compare-select fuses elementwise, where a
    # take_along_axis would be a separate gather)
    k_ids = jnp.arange(class_count, dtype=jnp.int32)
    onehot = (safe[..., None] == k_ids) & valid[..., None]

    # [N, K] histogram of valid pixels
    counts = jnp.sum(onehot, axis=(1, 2), dtype=jnp.float32)
    total = jnp.sum(counts, axis=-1, keepdims=True)  # [N,1]

    present = counts > 0
    # counts**-cw on absent classes would be inf: guard before the power
    unnormalized = jnp.where(
        present, jnp.maximum(counts, 1.0) ** (-class_weight), 0.0
    )
    total_unnormalized = jnp.sum(counts * unnormalized, axis=-1, keepdims=True)

    pixels = jnp.float32(h * w)
    safe_total = jnp.maximum(total, 1.0)
    target_total = total * (pixels / safe_total) ** image_weight
    scale = jnp.where(
        total_unnormalized > 0, target_total / total_unnormalized, 0.0
    )
    label_weights = unnormalized * scale  # [N,K]

    per_pixel = jnp.sum(
        jnp.where(onehot, label_weights[:, None, None, :], 0.0), axis=-1
    )
    return jnp.where(valid, per_pixel, 0.0)
