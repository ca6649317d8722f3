"""Width-folded 3x3 convolution: small-channel convs at wide matmul shapes.

The model family's convs have 3-32 channels (dlib's default widths). XLA
lowers a spatial conv as per-tap matmuls whose contraction/output dims equal
the channel counts, so a 16->16 conv is a chain of 16x16 products that
leave a wide matrix unit mostly idle.

The fix folds F width-adjacent pixels into the channel dimension — a FREE
reshape in NHWC row-major layout — and rewrites the 3x3 conv as an
equivalent 3x3 conv over folded pixels with a (F*cin) x (F*cout)
block-Toeplitz kernel built from the original weights. With F=8 and 16
channels the matmuls have K=N=128: ~8x more (mostly-zero) FLOPs at much
wider shapes.

out[p] = sum_{dy,dx} x[p+(dy,dx)] w[dy,dx]  becomes, for folded width blocks,
out'[pb] = sum_{dy,dxb} x'[pb+(dy,dxb)] W'[dy,dxb]  with
W'[dy, dxb][i*cin+ci, j*cout+co] = w[dy, dx+1][ci, co] where i = j+dx-F*dxb.
SAME padding of the folded conv zero-pads one whole block; only the one
border pixel has nonzero weights, so the math matches the original SAME
(zero) padding exactly. Verified numerically against lax.conv in tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

_DN = ("NHWC", "HWIO", "NHWC")


def fold_width_kernel(w, fold: int):
    """Build the folded [kh, 3, fold*cin, fold*cout] kernel from
    [kh, 3, cin, cout] (width kernel size must be 3).

    Pure jnp indexing so it traces (weights are jit arguments); for a
    BN-folded runtime net XLA constant-folds it once per compilation, and
    under autodiff the scatter is linear so training gradients flow to the
    original weights unchanged.
    """
    kh, kw, cin, cout = w.shape
    assert kw == 3, "width folding is implemented for 3-tap width kernels"
    w = jnp.asarray(w)
    i_idx = jnp.arange(fold)[:, None]
    j_idx = jnp.arange(fold)[None, :]
    blocks = []
    for dxb in range(3):
        kx = fold * (dxb - 1) + i_idx - j_idx + 1  # [fold, fold]
        valid = (kx >= 0) & (kx <= 2)
        block = w[:, jnp.clip(kx, 0, 2)]  # [kh, fold, fold, cin, cout]
        block = jnp.where(valid[None, :, :, None, None], block, 0)
        block = block.transpose(0, 1, 3, 2, 4).reshape(
            kh, fold * cin, fold * cout
        )
        blocks.append(block)
    return jnp.stack(blocks, axis=1)  # [kh, 3, fold*cin, fold*cout]


def pick_fold(width: int, cin: int, max_channels: int = 128) -> int:
    """Largest power-of-two fold with fold*cin <= max_channels dividing width."""
    fold = 1
    while (
        fold * 2 * cin <= max_channels
        and width % (fold * 2) == 0
        and fold * 2 <= width
    ):
        fold *= 2
    return fold


@partial(jax.jit, static_argnames=("fold",))
def conv3x3_folded(x: jnp.ndarray, w_folded: jnp.ndarray, fold: int) -> jnp.ndarray:
    """Stride-1 SAME 3x3 conv via width folding.

    x: [n, h, w, cin] with w % fold == 0; w_folded from fold_width_kernel.
    Returns [n, h, w, cout].
    """
    n, h, width, cin = x.shape
    cout = w_folded.shape[3] // fold
    x_folded = x.reshape(n, h, width // fold, fold * cin)
    out = lax.conv_general_dilated(
        x_folded,
        w_folded.astype(x.dtype),
        window_strides=(1, 1),
        padding="SAME",
        dimension_numbers=_DN,
    )
    return out.reshape(n, h, width, cout)
