"""int8 quantized width-folded inference net (opt-in).

Matrix units run int8 products at twice their bf16 rate, and the folded
convs are matrix-bound, so quantizing the conv stack targets the largest
share of the inference program. The transpose convs stay bf16 with int8
requant epilogues (an int8 transpose conv lowers through lhs_dilation,
which compilers handle poorly).

Quantization scheme (standard symmetric static PTQ, arranged so every
scale lives inside an op XLA fuses anyway):

- activations: int8 in [0,127] (post-ReLU, so zero-point 0; conv padding
  zeros stay consistent), one scale per REAL channel, calibrated once on
  the first inferred image's tiles (the reference's own timing excludes
  the first image as warm-up, annonet_infer_main.cpp:466-480);
- the input image quantizes exactly: q = round((u/255 - 0.5) * 254), a
  symmetric [-127,127] grid whose error (<= 1/508 of the input range) is
  below the sensor noise the augmentations model;
- weights: per-output-channel scales; the INPUT activation scales are
  folded into the weight rows before quantizing (w' = w * s_in[ci]), which
  makes per-channel activation scales free and lets the two halves of a
  skip concat carry different scales through the dec conv's permuted rows;
- each conv's epilogue is f32: acc * s_w[co] + bias, ReLU, then requant to
  the next layer's int8 grid (clip saturates out-of-calibration values);
  the head emits f32 logits, so blending/argmax/detection are untouched.

This is an execution-dtype transform of the same folded function
(models/folded_runtime.py) and therefore of NetPimpl::RuntimeNet::Forward
(annonet_infer.cpp:77); it is opt-in (`TiledInferer(quantize="int8")`,
`annonet_infer --quantize int8`) because the label map is no longer
bit-identical to the f32 path — agreement is asserted in
tests/test_quantized.py and the synthetic-config accuracy floors
(PARITY_TARGETS.json) hold under it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from annonet_jax.models.segnet import SegNetConfig, _normalize_input
from annonet_jax.models.folded_runtime import FOLDED_CONV_GEOMETRY

# A/B knob for the 1x1 head: conv vs explicit dot (docs/DESIGN.md
# par.24). Read at trace time so the composed A/B scripts can flip it per
# arm (each arm compiles its own program).
import os as _os


def _head_dot() -> bool:
    # int8 default: dot (bit-identical labels to the conv form)
    return _os.environ.get("ANNONET_HEAD_DOT", "1") != "0"

_DN = ("NHWC", "HWIO", "NHWC")

# exact input grid: q = round(a * 254) for a = u/255 - 0.5 in [-0.5, 0.5]
_INPUT_SCALE = 1.0 / 254.0


def _walk_folds(fold0: int, spec) -> List[Optional[int]]:
    """The fold factor of each layer's OUTPUT, parallel to ``spec``.

    Mirrors fold_runtime_params' fold bookkeeping: s2 halves (folded form
    only), up doubles, everything else preserves. Bookkeeping entries get
    None; concat restores the saved skip's fold (asserted equal).
    """
    f = fold0
    folds: List[Optional[int]] = []
    skips: Dict[str, int] = {}
    for kind in spec:
        if kind.startswith("pad_input"):
            folds.append(None)
        elif kind.startswith("save_skip"):
            skips[kind.split(":")[1]] = f
            folds.append(None)
        elif kind.startswith("concat_skip"):
            assert skips[kind.split(":")[1]] == f
            folds.append(None)
        elif kind == "s2":
            f //= 2
            folds.append(f)
        elif kind == "up":
            f *= 2
            folds.append(f)
        elif kind in ("s1", "s1_plain", "s2_plain", "head"):
            folds.append(f)
        else:  # pragma: no cover
            raise ValueError(f"unsupported spec entry for int8: {kind}")
    return folds


def collect_calibration(
    arrays, x_uint8: jnp.ndarray, config: SegNetConfig, *, fold0: int, spec
) -> Tuple[jnp.ndarray, ...]:
    """bf16 folded forward that returns each conv/up layer's post-ReLU
    output maxima per REAL channel (jit-friendly; tuple parallel to spec,
    zero-length vectors for bookkeeping entries and the f32 head)."""
    from annonet_jax.models.folded_runtime import pad_input_channels

    dtype = jnp.dtype(config.compute_dtype)
    folds = _walk_folds(fold0, spec)
    n, h, width, _cin = x_uint8.shape
    assert width % fold0 == 0
    x_uint8 = pad_input_channels(x_uint8, spec)
    cin = x_uint8.shape[-1]
    x = _normalize_input(x_uint8, dtype)
    x = x.reshape(n, h, width // fold0, fold0 * cin)

    def conv(x, w, b, strides, padding):
        out = lax.conv_general_dilated(
            x, w.astype(dtype), strides, padding, dimension_numbers=_DN
        )
        return jnp.maximum(out + b, 0.0).astype(dtype)

    def channel_max(x, fold):
        c = x.shape[-1] // fold
        v = x.astype(jnp.float32).reshape(-1, fold, c)
        return jnp.max(v, axis=(0, 1))

    empty = jnp.zeros((0,), jnp.float32)
    maxima: List[jnp.ndarray] = []
    skips = {}
    for kind, entry, f_out in zip(spec, arrays, folds):
        if kind.startswith("pad_input"):
            maxima.append(empty)
            continue
        if kind.startswith("save_skip"):
            skips[kind.split(":")[1]] = x
            maxima.append(empty)
            continue
        if kind.startswith("concat_skip"):
            x = jnp.concatenate([x, skips[kind.split(":")[1]]], axis=-1)
            maxima.append(empty)
            continue
        if kind in FOLDED_CONV_GEOMETRY:
            strides, padding = FOLDED_CONV_GEOMETRY[kind]
            x = conv(x, entry[0], entry[1], strides, padding)
        elif kind == "up":
            out = lax.conv_transpose(
                x, entry[0].astype(dtype), strides=(2, 1),
                padding="SAME", dimension_numbers=_DN,
            )
            x = jnp.maximum(out + entry[1], 0.0).astype(dtype)
        elif kind == "head":
            maxima.append(empty)  # head output is f32 logits, never requantized
            continue
        maxima.append(channel_max(x, f_out))
    return tuple(maxima)


def quantize_folded(
    spec,
    arrays,
    calib: Tuple[np.ndarray, ...],
    config: SegNetConfig,
    fold0: int,
) -> Tuple[Tuple, Tuple]:
    """Host-side (numpy, once per model) int8 parameter builder.

    Returns (qspec, qarrays) for apply_folded_int8: qspec mirrors spec with
    "q" prefixes on the int8 conv kinds. ReLU + round + requant are
    pre-combined into one affine per entry (see apply_folded_int8.requant):
    int8 convs carry (w_q int8 [kh,kw,CIN,COUT], scale f32 [COUT],
    offset f32 [COUT]); up entries stay bf16 kernels plus
    (s_in [CIN], scale [COUT], offset [COUT]); the head carries
    (w_q, s_w, bias) and emits f32 logits.
    """
    folds = _walk_folds(fold0, spec)
    qspec: List[str] = []
    qarrays: List[Any] = []

    # effective input channels: the bf16 folded spec may already pad
    # grayscale to 3 channels (pad_input marker, fold_runtime_params)
    cin_eff = config.in_channels
    if spec and str(spec[0]).startswith("pad_input:"):
        cin_eff = int(str(spec[0]).split(":")[1])

    # current activation scale per FOLDED channel (input-layout order)
    s_cur = np.full(fold0 * cin_eff, _INPUT_SCALE, np.float32)
    skip_scales: Dict[str, np.ndarray] = {}

    # the stem conv's folded input (fold0 * 3 channels) is padded to
    # fold0 * 4: int8 conv and GEMM kernels want channel counts in
    # multiples of 4. Kernel rows are interleaved (i*cin + ci), so the
    # zero rows go in per fold position, and apply_folded_int8 pads the
    # uint8 input.
    pad_stem = fold0 > 1 and cin_eff < 4
    if pad_stem:
        s4 = np.ones(fold0 * 4, np.float32)
        for i in range(fold0):
            s4[i * 4 : i * 4 + cin_eff] = s_cur[
                i * cin_eff : (i + 1) * cin_eff
            ]
        s_cur = s4
    stem_conv_pending = True

    def out_scale_vec(calib_vec: np.ndarray, fold: int) -> np.ndarray:
        # per-real-channel maxima -> per-folded-channel scales, tiled in the
        # same (fold-major, channel-minor) order as _tile_bias
        s = np.maximum(np.asarray(calib_vec, np.float32), 1e-12) / 127.0
        return np.tile(s, fold)

    for kind, entry, f_out, cal in zip(spec, arrays, folds, calib):
        if kind.startswith("pad_input"):
            qspec.append(kind)
            qarrays.append(None)
            continue
        if kind.startswith("save_skip"):
            skip_scales[kind.split(":")[1]] = s_cur
            qspec.append(kind)
            qarrays.append(None)
            continue
        if kind.startswith("concat_skip"):
            s_cur = np.concatenate(
                [s_cur, skip_scales[kind.split(":")[1]]]
            )
            qspec.append(kind)
            qarrays.append(None)
            continue

        w = np.asarray(entry[0], np.float32)
        b = np.asarray(entry[1], np.float32)

        first_conv = stem_conv_pending
        stem_conv_pending = False
        if pad_stem and first_conv:  # the stem conv
            kh, kw, rows, cout = w.shape
            assert rows == fold0 * cin_eff
            w4 = np.zeros((kh, kw, fold0 * 4, cout), np.float32)
            for i in range(fold0):
                w4[:, :, i * 4 : i * 4 + cin_eff] = w[
                    :, :, i * cin_eff : (i + 1) * cin_eff
                ]
            w = w4

        if kind == "up":
            # bf16 conv_transpose; int8 only at its boundaries
            s_out = out_scale_vec(cal, f_out)
            inv = (1.0 / s_out).astype(np.float32)
            qspec.append("up")
            qarrays.append(
                (
                    jnp.asarray(w),
                    jnp.asarray(s_cur),
                    jnp.asarray(inv),
                    jnp.asarray(b * inv + 0.5),
                )
            )
            s_cur = s_out
            continue

        # int8 conv: fold input scales into the rows, per-out-channel scale
        w_scaled = w * s_cur[None, None, :, None]
        s_w = np.max(np.abs(w_scaled), axis=(0, 1, 2)) / 127.0
        s_w = np.maximum(s_w, 1e-20)
        w_q = np.clip(np.rint(w_scaled / s_w), -127, 127).astype(np.int8)

        if kind == "head":
            qspec.append("qhead")
            qarrays.append(
                (jnp.asarray(w_q), jnp.asarray(s_w), jnp.asarray(b))
            )
            continue

        s_out = out_scale_vec(cal, f_out)
        inv = (1.0 / s_out).astype(np.float32)
        suffix = ":pad4" if (pad_stem and first_conv) else ""
        qspec.append("q" + kind + suffix)  # qs1[:pad4] / qs2 / ..._plain
        qarrays.append(
            (
                jnp.asarray(w_q),
                jnp.asarray(s_w * inv),
                jnp.asarray(b * inv + 0.5),
            )
        )
        s_cur = s_out

    return tuple(qspec), tuple(qarrays)


def ycat_stem_qspec(qspec, qarrays):
    """Rewrite the stem conv into y-tap-concat form ("qy1").

    The stem has the narrowest contraction in the int8 program
    (docs/DESIGN.md §26): its folded input has only fold0*C' <= 32
    channels. Concatenating the y-1/y/y+1 neighbor rows on the channel axis
    turns it into a (1, 3) conv with 3x the input channels at identical
    FLOPs. Bit-exact by construction: int32 accumulations of the same
    integer products (integer addition is associative), verified in
    tests/test_quantized.py. Opt-in via ANNONET_STEM_YCAT=1 pending a
    composed device A/B (scripts/ab_stem_ycat.py); the trade is an extra
    device-memory pass over the 3x-wide stem input vs the narrow conv.
    """
    qspec = list(qspec)
    qarrays = list(qarrays)
    for i, kind in enumerate(qspec):
        base = str(kind).split(":")[0]
        if base in ("save_skip", "concat_skip") or base == "pad_input":
            continue
        if base != "qs1":
            break  # the stem is the first conv; nothing to rewrite
        w_q, scale, offset = qarrays[i]
        w = np.asarray(w_q)
        kh, kw, cin, cout = w.shape
        assert (kh, kw) == (3, 3)
        # rows ky-major then channel, matching the apply-side concat order
        w_ycat = np.ascontiguousarray(
            w.transpose(1, 0, 2, 3).reshape(kw, kh * cin, cout)
        )[None]
        suffix = kind[len(base):]  # keeps :pad4 (quantize_input scans it)
        qspec[i] = "qy1" + suffix
        qarrays[i] = (jnp.asarray(w_ycat), scale, offset)
        break
    return tuple(qspec), tuple(qarrays)


def quantize_input(x_uint8: jnp.ndarray, fold0: int, qspec) -> jnp.ndarray:
    """uint8 [..., H, W, C] -> int8 width-folded [..., H, W/f0, f0*C'].

    The exact affine requant of _normalize_input — q = round((u/255-0.5) *
    254) — plus the stem alignment pad (see quantize_folded; the matching
    kernel rows are zero, so padded lane values are don't-cares). Exposed
    separately so tiled inference can quantize the padded image ONCE and
    gather int8 tiles from it instead of re-quantizing every overlapping
    tile pixel.
    """
    *lead, h, w, cin = x_uint8.shape
    assert w % fold0 == 0
    q = jnp.round(
        x_uint8.astype(jnp.float32) * (254.0 / 255.0) - 127.0
    ).astype(jnp.int8)
    target = cin
    if qspec and str(qspec[0]).startswith("pad_input:"):
        target = int(str(qspec[0]).split(":")[1])
    if any(k.endswith(":pad4") for k in qspec):
        target = 4
    if target > cin:
        q = jnp.pad(q, ((0, 0),) * (len(lead) + 2) + ((0, target - cin),))
        cin = target
    return q.reshape(*lead, h, w // fold0, fold0 * cin)


def apply_folded_int8(
    qarrays, x_uint8: jnp.ndarray, config: SegNetConfig, *, fold0: int, qspec,
    folded_output: bool = False, pre_folded: bool = False
) -> jnp.ndarray:
    """[N,H,W,C]u8 -> [N,H,W,K]f32 logits via the int8 folded net (or
    class-major folded logits [N,H,W/f,K*f] with ``folded_output``). With
    ``pre_folded`` the input is already quantize_input-processed int8."""
    dtype = jnp.dtype(config.compute_dtype)
    if pre_folded:
        assert x_uint8.dtype == jnp.int8
        x = x_uint8
    else:
        x = quantize_input(x_uint8, fold0, qspec)

    # "qs1[:pad4]" etc. -> the shared folded conv geometry
    geometry = {
        "q" + kind: sp for kind, sp in FOLDED_CONV_GEOMETRY.items()
    }

    def qconv(x, w_q, strides, padding):
        # every caller converts the int32 sum to float32 and uses nothing
        # else of it: XLA:GPU lowers an integer conv to cuDNN only with s8
        # input and filter and an s8 or f32 output, so conv + convert
        # become one s8 -> f32 cuDNN call, while an s32 result used as
        # such fails to compile (UNIMPLEMENTED; scripts/probe_int8_conv.py)
        return lax.conv_general_dilated(
            x, w_q, strides, padding, dimension_numbers=_DN,
            preferred_element_type=jnp.int32,
        )

    def requant(acc, scale, offset):
        # ReLU + requant collapsed into ONE affine + clamp: relu then clip
        # to [0,127] IS clip(., 0, 127), and the +0.5 (round-half-up,
        # values are non-negative) rides in the offset — the epilogue is a
        # single multiply-add/clamp/convert XLA keeps as one fused pass
        f = acc.astype(jnp.float32) * scale + offset
        return jnp.clip(f, 0.0, 127.0).astype(jnp.int8)

    skips = {}
    for kind, entry in zip(qspec, qarrays):
        if kind.startswith("pad_input"):
            pass  # handled inside quantize_input
        elif kind.startswith("save_skip"):
            skips[kind.split(":")[1]] = x
        elif kind.startswith("concat_skip"):
            x = jnp.concatenate([x, skips[kind.split(":")[1]]], axis=-1)
        elif kind.split(":")[0] == "qy1":
            # stem as a y-tap-concat (1,3) conv: 3x the input channels
            # (ycat_stem_qspec; bit-exact — int32 sums of the same
            # integer products). Row blocks are ky-major: x[y-1], x[y],
            # x[y+1], zeros outside (== the conv's y zero-padding).
            w_q, scale, offset = entry
            z = jnp.zeros_like(x[:, :1])
            xc = jnp.concatenate(
                [
                    jnp.concatenate([z, x[:, :-1]], axis=1),
                    x,
                    jnp.concatenate([x[:, 1:], z], axis=1),
                ],
                axis=-1,
            )
            x = requant(
                qconv(xc, w_q, (1, 1), [(0, 0), (1, 1)]), scale, offset
            )
        elif kind.split(":")[0] in geometry:
            strides, padding = geometry[kind.split(":")[0]]
            w_q, scale, offset = entry
            x = requant(qconv(x, w_q, strides, padding), scale, offset)
        elif kind == "up":
            w, s_in, scale, offset = entry
            xf = (x.astype(dtype) * s_in.astype(dtype)).astype(dtype)
            out = lax.conv_transpose(
                xf, w.astype(dtype), strides=(2, 1),
                padding="SAME", dimension_numbers=_DN,
            )
            x = requant(out, scale, offset)
        elif kind == "qhead":
            w_q, s_w, b = entry
            if _head_dot():
                # the 1x1 head as an explicit int8 matmul
                # (docs/DESIGN.md par.24)
                n_, h_, wb_, c_ = x.shape
                acc = lax.dot_general(
                    x.reshape(n_ * h_ * wb_, c_),
                    jnp.asarray(w_q)[0, 0],
                    (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.int32,
                ).reshape(n_, h_, wb_, -1)
            else:
                acc = qconv(x, w_q, (1, 1), "SAME")
            x = acc.astype(jnp.float32) * s_w + b
        else:  # pragma: no cover
            raise ValueError(kind)

    if folded_output:
        return x
    from annonet_jax.models.folded_runtime import unfold_logits

    return unfold_logits(x, config.class_count)
