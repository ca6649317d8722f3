"""On-device crop extraction from an HBM-resident image pool.

The device-side replacement for the per-step pixel upload: instead of
shipping B x dim^2 x (3+2) bytes of crop pixels host->device every
minibatch, the decoded images live in a device pool
(annonet_jax.train.device_cache.DeviceImagePool) and the host ships only
crop DECISIONS — (slot, y0, x0, valid_h, valid_w) int32 per crop, ~20
bytes — which this op turns into the exact crops the host path produces.

Semantics are bit-identical to data/crop.py::extract_crop (the fused
extract_image_chip + outpaint + set_to_unknown_outside of
annonet_train_main.cpp:149-179):

  * image pixels outside the valid [0,h)x[0,w) area replicate the nearest
    edge pixel (clamped-index gather);
  * label pixels outside the valid area become IGNORE_LABEL.

Layout: per crop, one dynamic_slice pulls a contiguous [dim, dim] window
whose start is clamped so the window stays inside the valid area whenever
the image is at least dim wide/tall; the (rare) out-of-bounds remainder is
then fixed up with in-tile one-hot PERMUTATION MATMULS (P_rows @ tile @
P_cols^T). The slice start arithmetic guarantees every clamped source
index lands inside the window (proof in _gather_one), and the matmuls are
exact: each permutation row has exactly one 1.0, uint8 pixels are exact
in bf16 (<= 255 < 2^8 mantissa) and uint16 labels in f32 (< 2^24).

The one-hot form was chosen where gathers were slow; on a GPU a direct
clamped gather is the obvious alternative to measure (ROADMAP speed
item 6).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from annonet_jax.classes import IGNORE_LABEL


def gather_crops(
    pool_images: jnp.ndarray,  # [S, Hp, Wp, C] uint8
    pool_labels: jnp.ndarray,  # [S, Hp, Wp] uint16
    slot: jnp.ndarray,  # [B] int32 — pool slot per crop
    y0: jnp.ndarray,  # [B] int32 — crop top (may be negative / OOB)
    x0: jnp.ndarray,  # [B] int32 — crop left
    valid_h: jnp.ndarray,  # [B] int32 — the slot image's real height
    valid_w: jnp.ndarray,  # [B] int32 — the slot image's real width
    dim: int,
    flip_lr: jnp.ndarray = None,  # optional [B] bool — mirror crop cols
    flip_ud: jnp.ndarray = None,  # optional [B] bool — mirror crop rows
):
    """Extract B [dim, dim] crops: (images uint8 [B,dim,dim,C],
    labels int32 [B,dim,dim] with IGNORE_LABEL outside the valid area).

    ``flip_lr`` / ``flip_ud`` mirror the crop as it is extracted: the flip
    rides the clamp's permutation matmuls for FREE (a mirrored permutation
    costs the same matmul as the identity), replacing the materialized
    ``reverse`` copies the in-step augmentation would otherwise emit
    (docs/DESIGN.md par.17). Exact:
    flipping an extracted crop equals extracting with mirrored index maps,
    including the replicate-pad clamp and the IGNORE region (the
    augmentation order is flip-first, annonet_train_main.cpp:184-194, so
    flipping at extraction time is bit-identical to flipping in
    augment_batch)."""
    iota = jnp.arange(dim, dtype=jnp.int32)
    rev = dim - 1 - iota
    use_lr = flip_lr is not None
    use_ud = flip_ud is not None
    if not use_lr:
        flip_lr = jnp.zeros(slot.shape, jnp.bool_)
    if not use_ud:
        flip_ud = jnp.zeros(slot.shape, jnp.bool_)

    def _gather_one(s, yy, xx, h, w, fl, fu):
        # Clamped window start: sy = clip(yy, 0, max(0, h - dim)). Every
        # desired source row clip(yy + i, 0, h - 1) then lies in
        # [sy, sy + dim): for yy < 0 the window starts at 0 and desired
        # rows stop at yy + dim - 1 < dim (or h - 1 < dim when h < dim);
        # for yy + dim > h it starts at max(0, h - dim) and desired rows
        # start at clip(yy, 0, h-1) >= sy; otherwise sy == yy exactly.
        sy = jnp.clip(yy, 0, jnp.maximum(0, h - dim))
        sx = jnp.clip(xx, 0, jnp.maximum(0, w - dim))
        img = jax.lax.dynamic_slice(
            pool_images[s], (sy, sx, 0),
            (dim, dim, pool_images.shape[-1]),
        )
        lab = jax.lax.dynamic_slice(pool_labels[s], (sy, sx), (dim, dim))

        # mirrored index maps implement the flips inside the same
        # permutation matmuls (identity-cost); see the function docstring
        ridx = jnp.where(fu, rev, iota) if use_ud else iota
        cidx = jnp.where(fl, rev, iota) if use_lr else iota
        rows = jnp.clip(yy + ridx, 0, h - 1) - sy  # in [0, dim)
        cols = jnp.clip(xx + cidx, 0, w - 1) - sx
        # in-tile clamp as exact permutation matmuls (identity for
        # fully-interior crops)
        c = img.shape[-1]
        pr = (rows[:, None] == iota[None, :]).astype(jnp.bfloat16)
        pc = (cols[:, None] == iota[None, :]).astype(jnp.bfloat16)
        imgf = pr @ img.astype(jnp.bfloat16).reshape(dim, dim * c)
        imgf = jnp.einsum("ij,hjc->hic", pc, imgf.reshape(dim, dim, c))
        img = imgf.astype(jnp.uint8)
        labf = pr.astype(jnp.float32) @ lab.astype(jnp.float32)
        labf = labf @ pc.astype(jnp.float32).T
        lab = labf.astype(jnp.int32)

        inside = (
            ((yy + ridx >= 0) & (yy + ridx < h))[:, None]
            & ((xx + cidx >= 0) & (xx + cidx < w))[None, :]
        )
        lab = jnp.where(inside, lab, IGNORE_LABEL)
        return img, lab

    return jax.vmap(_gather_one)(
        slot, y0, x0, valid_h, valid_w, flip_lr, flip_ud
    )


def gather_crops_packed(
    pool_images, pool_labels, packed, dim: int,
    flip_lr=None, flip_ud=None,
):
    """gather_crops with the decisions packed as ONE [5, B] int32 array —
    rows (slot, y0, x0, valid_h, valid_w) — so a host caller ships a
    single argument whose upload rides the dispatch."""
    return gather_crops(
        pool_images, pool_labels,
        packed[0], packed[1], packed[2], packed[3], packed[4], dim,
        flip_lr=flip_lr, flip_ud=flip_ud,
    )
