"""int8 forward convolutions for TRAINING (straight-through estimator).

Matrix units run int8 products at twice their bf16 rate (docs/DESIGN.md
§9-10). This op quantizes each conv's operands dynamically per step —
symmetric, per-tensor for activations and per-output-channel for
weights — runs the conv in int8 with int32 accumulation, dequantizes,
and routes gradients through the EXACT bf16 conv (straight-through): the
backward pass is bit-identical to the unquantized step's, only the
forward values carry int8 grid noise.

Dynamic (abs-max) scales need no calibration and adapt as activations
drift during training; the two max-reductions per conv are cheap.

Opt-in via TrainerConfig(int8_forward=True). A/B results (throughput and
loss-trajectory agreement) are recorded in docs/DESIGN.md §12.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

_DN = ("NHWC", "HWIO", "NHWC")


def _quantize_sym(v: jnp.ndarray, axes, eps=1e-12, axis_name=None):
    """Symmetric int8 quantization along all-but-``axes``: returns
    (q int8, scale f32 broadcastable against v). ``axis_name`` also
    reduces the abs-max across a mesh axis (global-batch scale)."""
    vf = v.astype(jnp.float32)
    amax = jnp.max(jnp.abs(vf), axis=axes, keepdims=True)
    if axis_name is not None:
        amax = lax.pmax(amax, axis_name)
    scale = jnp.maximum(amax, eps) / 127.0
    q = jnp.clip(jnp.round(vf / scale), -127, 127).astype(jnp.int8)
    return q, scale


@partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def _int8_conv(x, w, stride, axis_name):
    # forward: int8 x int8 -> int32, dequantized to x.dtype. Keep the
    # int32 sum's only consumer the float32 convert: XLA:GPU lowers an
    # integer conv to cuDNN only with s8 input and filter and an s8 or f32
    # output, so it fuses conv + convert into one s8 -> f32 cuDNN call and
    # refuses (UNIMPLEMENTED) a conv whose s32 result is used as such
    # (scripts/probe_int8_conv.py)
    xq, sx = _quantize_sym(x, axes=None, axis_name=axis_name)
    wq, sw = _quantize_sym(w, axes=(0, 1, 2))  # per-output-channel
    acc = lax.conv_general_dilated(
        xq,
        wq,
        (stride, stride),
        "SAME",
        dimension_numbers=_DN,
        preferred_element_type=jnp.int32,
    )
    out = acc.astype(jnp.float32) * (sx * sw.reshape(1, 1, 1, -1))
    return out.astype(x.dtype)


def _int8_conv_fwd(x, w, stride, axis_name):
    return _int8_conv(x, w, stride, axis_name), (x, w)


def _int8_conv_bwd(stride, axis_name, res, g):
    # straight-through: gradients of the EXACT conv at the unquantized
    # operands (dgrad + wgrad identical to the bf16 step's)
    x, w = res
    _, vjp = jax.vjp(
        lambda a, b: lax.conv_general_dilated(
            a, b, (stride, stride), "SAME", dimension_numbers=_DN
        ),
        x,
        w,
    )
    return vjp(g)


_int8_conv.defvjp(_int8_conv_fwd, _int8_conv_bwd)


def int8_conv_ste(x, w, stride, dtype, axis_name=None):
    """Drop-in for models.segnet._conv on the training forward path.

    ``axis_name``: under data parallelism the per-tensor activation scale
    is pmax'd over the mesh axis, so DP quantization sees the GLOBAL
    batch's abs-max — the DP int8 step then computes the same function as
    the single-device int8 step (the scale analog of sync BN)."""
    return _int8_conv(x.astype(dtype), w.astype(dtype), stride, axis_name)
