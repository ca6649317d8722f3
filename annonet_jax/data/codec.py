"""RGBA <-> class-index label codec, vectorized with NumPy.

Reference behavior reproduced from:
  * /root/reference/annonet.cpp:22-58 (rgba_label_to_index_label,
    decode_rgba_label_image + labeled_points_by_class construction)
  * /root/reference/annonet_infer_main.cpp:67-86 (index -> RGBA encode)

Unlike the reference's per-pixel loops, decoding an HxW RGBA mask is a single
vectorized pass: pack RGBA into a uint32 key and translate through a lookup
built from the class palette. Unknown colors raise with the same message
format as annonet.cpp:32-38.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from annonet_jax.classes import AnnoClass, IGNORE_LABEL, RGBA_IGNORE


def _pack_rgba(r, g, b, a):
    """Pack RGBA components into a uint32 key (vectorized)."""
    return (
        (np.uint32(r) << np.uint32(24))
        | (np.uint32(g) << np.uint32(16))
        | (np.uint32(b) << np.uint32(8))
        | np.uint32(a)
    )


def rgba_label_to_index_label(
    rgba: Sequence[int], anno_classes: Sequence[AnnoClass]
) -> int:
    """Single-pixel RGBA -> index mapping (annonet.cpp:22-39)."""
    rgba = tuple(int(v) for v in rgba)
    if rgba == RGBA_IGNORE:
        return IGNORE_LABEL
    for anno_class in anno_classes:
        if anno_class.rgba_label == rgba:
            return anno_class.index
    raise RuntimeError(
        "Unknown class: r = %d, g = %d, b = %d, alpha = %d" % rgba
    )


def decode_rgba_label_image(
    rgba_label_image: np.ndarray, anno_classes: Sequence[AnnoClass]
) -> np.ndarray:
    """Decode an (H, W, 4) uint8 RGBA mask into (H, W) uint16 class indices.

    RGBA (0,0,0,0) decodes to IGNORE_LABEL; unknown colors raise
    (annonet.cpp:32-38).
    """
    if rgba_label_image.ndim != 3 or rgba_label_image.shape[-1] != 4:
        raise ValueError("expected an (H, W, 4) RGBA mask")

    keys = _pack_rgba(
        rgba_label_image[..., 0],
        rgba_label_image[..., 1],
        rgba_label_image[..., 2],
        rgba_label_image[..., 3],
    )

    table: Dict[int, int] = {int(_pack_rgba(*RGBA_IGNORE)): IGNORE_LABEL}
    for anno_class in anno_classes:
        table[int(_pack_rgba(*anno_class.rgba_label))] = anno_class.index

    unique_keys = np.unique(keys)
    out = np.empty(keys.shape, dtype=np.uint16)
    for key in unique_keys:
        key_int = int(key)
        if key_int not in table:
            r = (key_int >> 24) & 0xFF
            g = (key_int >> 16) & 0xFF
            b = (key_int >> 8) & 0xFF
            a = key_int & 0xFF
            raise RuntimeError(
                "Unknown class: r = %d, g = %d, b = %d, alpha = %d"
                % (r, g, b, a)
            )
        out[keys == key] = table[key_int]
    return out


def labeled_points_by_class(
    label_image: np.ndarray,
) -> Dict[int, np.ndarray]:
    """Group non-ignored pixel coordinates by class.

    Returns {class_index: (N, 2) int array of (x, y) points} — the same
    information the reference keeps in sample_type::labeled_points_by_class
    (annonet.h:56, built at annonet.cpp:49-57). Points are in row-major scan
    order, matching the reference's push_back order.
    """
    result: Dict[int, np.ndarray] = {}
    labels = np.unique(label_image)
    for label in labels:
        label_int = int(label)
        if label_int == IGNORE_LABEL:
            continue
        ys, xs = np.nonzero(label_image == label)
        result[label_int] = np.stack([xs, ys], axis=1).astype(np.int64)
    return result


def index_label_image_to_rgba_label_image(
    index_label_image: np.ndarray, anno_classes: Sequence[AnnoClass]
) -> np.ndarray:
    """Encode (H, W) uint16 class indices into an (H, W, 4) RGBA image.

    Parity with index_label_image_to_rgba_label_image
    (annonet_infer_main.cpp:74-86). Like the reference, assumes every label
    is a valid class index (the reference would index out of bounds
    otherwise); raises IndexError if not.
    """
    palette = np.zeros((len(anno_classes), 4), dtype=np.uint8)
    for anno_class in anno_classes:
        palette[anno_class.index] = anno_class.rgba_label
    idx = index_label_image.astype(np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= len(anno_classes)):
        raise IndexError(
            "label image contains indices outside the class palette"
        )
    return palette[idx]
