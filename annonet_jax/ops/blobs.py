"""Connected-component labeling of label images (8-connectivity, equal-value).

The device side of the framework never needs blob identities during the hot
compute loop — blobs are a host post-processing step, exactly as in the
reference where dlib::label_connected_blobs runs on the CPU
(annonet_train_main.cpp:450, annonet_infer.cpp:217,
annonet_infer_main.cpp:217-218). Semantics reproduced:

  * 8-connected neighbors (dlib::neighbors_8)
  * two pixels connect only if their values are equal
    (dlib::connected_if_equal)
  * background pixels get blob id 0; the returned count includes the
    background label (dlib convention: count = max label + 1)
  * background predicates: ``zero_pixels_are_background`` (value 0) and
    ``zero_and_ignored_pixels_are_background`` (0 or IGNORE_LABEL,
    annonet.h:26-37)

The flood-fill runs in the native C++ module when available (one two-pass
union-find sweep over all values at once, native/annonet_native.cpp) and
falls back to scipy.ndimage per-value labeling otherwise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage

from annonet_jax.classes import IGNORE_LABEL

_STRUCTURE_8 = np.ones((3, 3), dtype=bool)


def label_connected_blobs(
    label_image: np.ndarray,
    zero_is_background: bool = True,
    ignore_is_background: bool = False,
) -> Tuple[np.ndarray, int]:
    """Label equal-valued 8-connected blobs.

    Returns (blobs int32 array, count) where background pixels are 0 and
    count = highest label + 1 (matching dlib's return convention so callers
    can size per-blob vectors directly).
    """
    labels = np.asarray(label_image)

    if labels.dtype == np.uint16:
        from annonet_jax.native import label_connected_blobs_native

        native_result = label_connected_blobs_native(
            labels, zero_is_background, ignore_is_background
        )
        if native_result is not None:
            return native_result

    background = np.zeros(labels.shape, dtype=bool)
    if zero_is_background:
        background |= labels == 0
    if ignore_is_background:
        background |= labels == IGNORE_LABEL

    blobs = np.zeros(labels.shape, dtype=np.int32)
    next_label = 1
    for value in np.unique(labels[~background]) if (~background).any() else []:
        mask = (labels == value) & ~background
        value_blobs, n = ndimage.label(mask, structure=_STRUCTURE_8)
        if n:
            blobs[mask] = value_blobs[mask] + (next_label - 1)
            next_label += n
    return blobs, next_label
