"""SegmentationNet: an accelerator-first conv/BN/ReLU encoder-decoder.

This is the L1 model abstraction replacing the reference's
dlib-dnn-pimpl-wrapper (NetPimpl.cpp / NetDimensions.cpp; API reconstructed
from call sites, see SURVEY.md §2.2). Capability parity:

  * configurable depth: ``level_count`` (0-3+) downsample stages — the
    runtime analog of the reference's compile-time
    DLIB_DNN_PIMPL_WRAPPER_LEVEL_COUNT (appveyor.yml:6-23)
  * configurable width: ``width_scaler`` / ``min_filter_count`` — SetNetWidth
    (annonet_train_main.cpp:402)
  * grayscale or RGB uint8 input — the runtime analog of
    DLIB_DNN_PIMPL_WRAPPER_GRAYSCALE_INPUT
  * ``required_input_dimension()`` (receptive field) and
    ``recommended_input_dimension()`` (stride alignment) COMPUTED from the
    architecture — GetRequiredInputDimension / GetRecommendedInputDimension
    (annonet_train_main.cpp:376-383, annonet_infer.cpp:49)
  * train-time batch norm vs. run-time folded affine — GetRuntimeNet's
    BN-folding (annonet_train_main.cpp:558)

Accelerator-first design choices (NOT a translation of the dlib net):
  * NHWC layout, bfloat16 compute with float32 accumulation in the matrix
    units, float32 parameters and BN statistics
  * static shapes everywhere; spatial dims must be multiples of
    2**level_count (enforced via recommended_input_dimension) so stride-2
    downsampling and 2x upsampling tile cleanly onto the hardware
  * everything is pure-functional pytrees — no framework dependency — so
    the train step jits/shards with pjit/shard_map unchanged
  * uint8 -> normalized float conversion happens ON DEVICE inside the jitted
    apply, keeping host->device transfers at 1 byte/pixel

Topology (U-Net-shaped; ``L = level_count``):
    stem:   conv3x3 -> BN -> ReLU, conv3x3 -> BN -> ReLU         (width w0)
    enc i:  conv3x3 s2 -> BN -> ReLU, conv3x3 -> BN -> ReLU      (width wi)
    dec i:  2x2 transpose-conv s2 -> BN -> ReLU, concat skip,
            conv3x3 -> BN -> ReLU                                (width w(i-1))
    head:   conv1x1 -> class_count logits (pre-softmax scores — per-class
            gains are added in logit space downstream, annonet_infer.cpp:177)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
from jax import lax

Params = Dict[str, Any]

_BN_EPS = 1e-5
_DN = ("NHWC", "HWIO", "NHWC")


@dataclasses.dataclass(frozen=True)
class SegNetConfig:
    """Architecture configuration.

    The two compile-time knobs of the reference (LEVEL_COUNT, grayscale)
    plus the runtime knobs of NetPimpl (class count, width scaler, minimum
    filter count) are all runtime config here.
    """

    class_count: int = 2
    level_count: int = 2
    width_scaler: float = 1.0
    min_filter_count: int = 1
    grayscale: bool = False
    base_width: int = 16
    compute_dtype: str = "bfloat16"

    @property
    def in_channels(self) -> int:
        return 1 if self.grayscale else 3

    def width(self, level: int) -> int:
        """Filter count at pyramid level ``level`` (0 = full resolution)."""
        base = self.base_width * (2 ** min(level, 3))
        return max(self.min_filter_count, int(round(base * self.width_scaler)))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SegNetConfig":
        return SegNetConfig(**d)


# --------------------------------------------------------------------------
# Dimension queries (computed from the architecture, SURVEY.md §7 hard parts)
# --------------------------------------------------------------------------


def required_input_dimension(config: SegNetConfig) -> int:
    """Worst-case receptive field of one output pixel, in input pixels.

    Replaces NetPimpl::TrainingNet::GetRequiredInputDimension
    (annonet_train_main.cpp:376). Computed EXACTLY by propagating the
    influence interval of a single input pixel through the op sequence with
    XLA SAME-padding index maps, maximized over all 2**level_count parity
    classes (stride-2 downsampling and 2x upsampling make the footprint
    parity-dependent; the naive (k-1)*scale sum underestimates it by up to
    one pixel per resolution round-trip). Keys crop sizing, tile overlap and
    region-ignore thresholds, so it must be an upper bound on true influence.
    """
    L = config.level_count

    # Exact influence maps for one op, interval [lo, hi] of affected indices
    # (all maps derived from XLA SAME padding on dims that are multiples of
    # 2**L, where a stride-2 k=3 conv pads (0, 1) and a 2x2 s2 transpose conv
    # maps feature u -> outputs {2u, 2u+1}).
    def conv3_s1(lo, hi):
        return lo - 1, hi + 1

    def conv3_s2(lo, hi):
        # output o taps inputs {2o, 2o+1, 2o+2}
        return -(-(lo - 2) // 2), hi // 2

    def up2(lo, hi):
        return 2 * lo, 2 * hi + 1

    best = 1
    base = 4 ** (L + 2)  # keep all intermediate indices positive
    for parity in range(2**L):
        lo = hi = base + parity
        lo, hi = conv3_s1(lo, hi)  # stem conv0
        lo, hi = conv3_s1(lo, hi)  # stem conv1
        for _ in range(L):
            lo, hi = conv3_s2(lo, hi)  # encoder downsample conv
            lo, hi = conv3_s1(lo, hi)  # encoder conv
        for _ in range(L):
            lo, hi = up2(lo, hi)  # decoder transpose conv
            lo, hi = conv3_s1(lo, hi)  # decoder conv
        best = max(best, hi - lo + 1)
    return best


def recommended_input_dimension(config: SegNetConfig, requested: int) -> int:
    """Round ``requested`` up so the net tiles cleanly (output stride 1,
    spatial dims divisible by 2**level_count).

    Replaces NetPimpl::RuntimeNet::GetRecommendedInputDimension
    (annonet_train_main.cpp:382, annonet_infer.cpp:49). Always >= requested
    (asserted by the reference at annonet_infer.cpp:54-55).
    """
    align = 2 ** config.level_count
    d = max(int(requested), align)
    return ((d + align - 1) // align) * align


# --------------------------------------------------------------------------
# Initialization
# --------------------------------------------------------------------------


def _he_conv(key, kh, kw, cin, cout):
    fan_in = kh * kw * cin
    std = (2.0 / fan_in) ** 0.5
    return jax.random.normal(key, (kh, kw, cin, cout), jnp.float32) * std


def _bn_params(c):
    return {"gamma": jnp.ones((c,), jnp.float32), "beta": jnp.zeros((c,), jnp.float32)}


def _bn_stats(c):
    return {"mean": jnp.zeros((c,), jnp.float32), "var": jnp.ones((c,), jnp.float32)}


def init_state(key: jax.Array, config: SegNetConfig) -> Tuple[Params, Params]:
    """Initialize (params, bn_stats) pytrees for the training net."""
    keys = iter(jax.random.split(key, 64))
    L = config.level_count
    params: Params = {}
    stats: Params = {}

    w0 = config.width(0)
    params["stem"] = {
        "conv0": _he_conv(next(keys), 3, 3, config.in_channels, w0),
        "bn0": _bn_params(w0),
        "conv1": _he_conv(next(keys), 3, 3, w0, w0),
        "bn1": _bn_params(w0),
    }
    stats["stem"] = {"bn0": _bn_stats(w0), "bn1": _bn_stats(w0)}

    for i in range(1, L + 1):
        cin = config.width(i - 1)
        cout = config.width(i)
        params[f"enc{i}"] = {
            "conv0": _he_conv(next(keys), 3, 3, cin, cout),
            "bn0": _bn_params(cout),
            "conv1": _he_conv(next(keys), 3, 3, cout, cout),
            "bn1": _bn_params(cout),
        }
        stats[f"enc{i}"] = {"bn0": _bn_stats(cout), "bn1": _bn_stats(cout)}

    for i in range(L, 0, -1):
        cin = config.width(i)
        cout = config.width(i - 1)
        params[f"dec{i}"] = {
            "up": _he_conv(next(keys), 2, 2, cin, cout),
            "bnu": _bn_params(cout),
            # input = upsampled (cout) concat skip (cout)
            "conv0": _he_conv(next(keys), 3, 3, 2 * cout, cout),
            "bn0": _bn_params(cout),
        }
        stats[f"dec{i}"] = {"bnu": _bn_stats(cout), "bn0": _bn_stats(cout)}

    params["head"] = {
        "w": _he_conv(next(keys), 1, 1, w0, config.class_count),
        "b": jnp.zeros((config.class_count,), jnp.float32),
    }
    return params, stats


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------


def _check_input(x: jnp.ndarray, config: SegNetConfig) -> None:
    if x.ndim != 4 or x.shape[-1] != config.in_channels:
        raise ValueError(
            f"expected input [N,H,W,{config.in_channels}] "
            f"({'grayscale' if config.grayscale else 'RGB'}), got {x.shape}"
        )
    align = 2**config.level_count
    if x.shape[1] % align or x.shape[2] % align:
        raise ValueError(
            f"input H,W {x.shape[1]}x{x.shape[2]} must be multiples of "
            f"{align} (= 2**level_count); round sizes up with "
            f"recommended_input_dimension()"
        )


def _normalize_input(x_uint8: jnp.ndarray, dtype) -> jnp.ndarray:
    """uint8 [N,H,W,C] -> centered float in the compute dtype, on device."""
    return (x_uint8.astype(jnp.float32) * (1.0 / 255.0) - 0.5).astype(dtype)


def _conv(x, w, stride, dtype, allow_fold=False):
    # Convs run wholly in the compute dtype (bf16 in/out by default): the
    # matrix units accumulate bf16 products in f32 internally, and keeping
    # operand/cotangent dtypes uniform is required for the autodiff transpose
    # (an f32 preferred_element_type would make the backward conv see an f32
    # cotangent against bf16 operands, which lax rejects).
    #
    # Stride-1 3x3 convs with small channel counts go through the
    # width-folded path (ops/folded_conv.py): XLA's per-tap lowering
    # contracts over only cin channels per tap; folding 8 width pixels into
    # channels widens the contraction and output dims 8x.
    kh, kw = w.shape[0], w.shape[1]
    if allow_fold and stride == 1 and kh == 3 and kw == 3:
        from annonet_jax.ops.folded_conv import conv3x3_folded, fold_width_kernel, pick_fold

        fold = pick_fold(int(x.shape[2]), int(w.shape[2]))
        if fold > 1:
            wf = fold_width_kernel(w.astype(dtype), fold)
            return conv3x3_folded(x.astype(dtype), wf, fold)
    return lax.conv_general_dilated(
        x.astype(dtype),
        w.astype(dtype),
        window_strides=(stride, stride),
        padding="SAME",
        dimension_numbers=_DN,
    )


def _conv_transpose(x, w, dtype):
    return lax.conv_transpose(
        x.astype(dtype),
        w.astype(dtype),
        strides=(2, 2),
        padding="SAME",
        dimension_numbers=_DN,
    )


def _bn_train(h, bn, axis_name=None):
    """Batch norm over (N,H,W) with f32 statistics; returns (out, mean, var).

    With ``axis_name`` set (inside shard_map), the statistics are all-reduced
    over that mesh axis — cross-replica ("sync") BN, so data-parallel
    training computes EXACTLY the same function as single-device training.
    The collectives move only 2*C floats per BN layer over ICI.
    """
    # f32 statistics WITHOUT materializing an f32 copy of h: the upcast
    # happens inside the fused reductions, and the normalization runs in
    # the compute dtype (mean/scale/shift are rounded once per channel,
    # not per pixel) so forward activations and backward residuals stay
    # bf16 — half the HBM traffic of normalizing in f32
    h32 = h.astype(jnp.float32)
    mean = jnp.mean(h32, axis=(0, 1, 2))
    mean_sq = jnp.mean(jnp.square(h32), axis=(0, 1, 2))
    if axis_name is not None:
        mean = lax.pmean(mean, axis_name)
        mean_sq = lax.pmean(mean_sq, axis_name)
    var = jnp.maximum(mean_sq - jnp.square(mean), 0.0)
    inv = lax.rsqrt(var + _BN_EPS)
    scale = (inv * bn["gamma"]).astype(h.dtype)
    shift = (bn["beta"] - mean * inv * bn["gamma"]).astype(h.dtype)
    out = h * scale + shift
    return out, mean, var


def _bn_update(stats, mean, var, momentum):
    return {
        "mean": stats["mean"] * momentum + mean * (1.0 - momentum),
        "var": stats["var"] * momentum + var * (1.0 - momentum),
    }


def apply_train(
    params: Params,
    bn_stats: Params,
    x_uint8: jnp.ndarray,
    config: SegNetConfig,
    bn_momentum: float = 0.99,
    axis_name=None,
    remat: bool = False,
    conv_impl=None,
) -> Tuple[jnp.ndarray, Params]:
    """Training forward pass: batch-stat BN, returns (logits f32, new stats).

    ``bn_momentum`` plays the role of the reference's BN running-stats window
    (SetAllBatchNormalizationRunningStatsWindowSizes,
    annonet_train_main.cpp:410): momentum = 1 - 1/window. ``axis_name``
    enables cross-replica BN statistics under shard_map (see _bn_train).
    ``remat`` rematerializes each conv+BN+ReLU unit in the backward pass
    (jax.checkpoint), trading ~1/3 more FLOPs for activation memory — this
    is what lets the batch-size autotuner reach large minibatches.
    ``conv_impl`` overrides the standard conv for the encoder/decoder 3x3
    units only (ops/int8_train.py's STE conv) — transpose convs and the
    head stay exact.
    """
    _check_input(x_uint8, config)
    dtype = jnp.dtype(config.compute_dtype)
    L = config.level_count
    new_stats: Params = {k: dict(v) for k, v in bn_stats.items()}

    if conv_impl is None:
        conv = _conv
    else:
        # conv_impl sees the mesh axis too (e.g. the int8 STE conv pmax'es
        # its activation scale cross-replica, like the sync BN statistics)
        def conv(x, p, stride, dtype):
            return conv_impl(x, p, stride, dtype, axis_name=axis_name)

    def unit(x, p, bn, name, stride):
        if name == "bnu":
            h = _conv_transpose(x, p, dtype)
        else:
            h = conv(x, p, stride, dtype)
        h, mean, var = _bn_train(h, bn, axis_name)
        return jnp.maximum(h, 0.0).astype(dtype), mean, var

    if remat:
        unit = jax.checkpoint(unit, static_argnums=(3, 4))

    def block(x, p, s, names, strides):
        for name, stride in zip(names, strides):
            conv_name = "up" if name == "bnu" else name.replace("bn", "conv")
            x, mean, var = unit(x, p[conv_name], p[name], name, stride)
            s[name] = _bn_update(s[name], mean, var, bn_momentum)
        return x

    x = _normalize_input(x_uint8, dtype)
    x = block(x, params["stem"], new_stats["stem"], ["bn0", "bn1"], [1, 1])
    skips = [x]
    for i in range(1, L + 1):
        x = block(x, params[f"enc{i}"], new_stats[f"enc{i}"], ["bn0", "bn1"], [2, 1])
        if i < L:
            skips.append(x)
    for i in range(L, 0, -1):
        p = params[f"dec{i}"]
        s = new_stats[f"dec{i}"]
        x = block(x, p, s, ["bnu"], [2])
        x = jnp.concatenate([x, skips[i - 1]], axis=-1)
        x = block(x, p, s, ["bn0"], [1])

    logits = _conv(x, params["head"]["w"], 1, dtype) + params["head"]["b"]
    return logits.astype(jnp.float32), new_stats


def fold_batchnorm(params: Params, bn_stats: Params, config: SegNetConfig) -> Params:
    """Fold running BN statistics into conv weights + biases.

    Produces the runtime (inference) parameter pytree — the analog of
    TrainingNet::GetRuntimeNet (annonet_train_main.cpp:558): each conv+BN
    pair becomes conv(W * gamma/sqrt(var+eps)) + (beta - mean*gamma/sqrt(..)).
    """
    L = config.level_count
    folded: Params = {}

    def fold(w, bn, st):
        scale = bn["gamma"] / jnp.sqrt(st["var"] + _BN_EPS)
        return w * scale, bn["beta"] - st["mean"] * scale

    def fold_block(pname, pairs):
        out = {}
        for conv_name, bn_name in pairs:
            w, b = fold(
                params[pname][conv_name],
                params[pname][bn_name],
                bn_stats[pname][bn_name],
            )
            out[conv_name] = {"w": w, "b": b}
        return out

    folded["stem"] = fold_block("stem", [("conv0", "bn0"), ("conv1", "bn1")])
    for i in range(1, L + 1):
        folded[f"enc{i}"] = fold_block(f"enc{i}", [("conv0", "bn0"), ("conv1", "bn1")])
    for i in range(L, 0, -1):
        folded[f"dec{i}"] = fold_block(f"dec{i}", [("up", "bnu"), ("conv0", "bn0")])
    folded["head"] = {"w": params["head"]["w"], "b": params["head"]["b"]}
    return folded


def apply_runtime(
    runtime_params: Params, x_uint8: jnp.ndarray, config: SegNetConfig
) -> jnp.ndarray:
    """Inference forward pass on BN-folded params: [N,H,W,C]u8 -> [N,H,W,K]f32.

    The analog of RuntimeNet::Forward (annonet_infer.cpp:77). Output is
    per-class pre-softmax scores; per-class gains are added in logit space
    by the caller, matching annonet_infer.cpp:170-185.
    """
    _check_input(x_uint8, config)
    dtype = jnp.dtype(config.compute_dtype)
    L = config.level_count

    def cbr(x, p, stride):
        # allow_fold stays off: in the fused tiled program the per-layer
        # fold/unfold reshapes make XLA insert relayout copies between
        # neighbors (the whole-net fold is models/folded_runtime.py)
        h = _conv(x, p["w"], stride, dtype) + p["b"]
        return jnp.maximum(h, 0.0).astype(dtype)

    def ubr(x, p):
        h = _conv_transpose(x, p["w"], dtype) + p["b"]
        return jnp.maximum(h, 0.0).astype(dtype)

    x = _normalize_input(x_uint8, dtype)
    x = cbr(x, runtime_params["stem"]["conv0"], 1)
    x = cbr(x, runtime_params["stem"]["conv1"], 1)
    skips = [x]
    for i in range(1, L + 1):
        x = cbr(x, runtime_params[f"enc{i}"]["conv0"], 2)
        x = cbr(x, runtime_params[f"enc{i}"]["conv1"], 1)
        if i < L:
            skips.append(x)
    for i in range(L, 0, -1):
        x = ubr(x, runtime_params[f"dec{i}"]["up"])
        x = jnp.concatenate([x, skips[i - 1]], axis=-1)
        x = cbr(x, runtime_params[f"dec{i}"]["conv0"], 1)

    logits = (
        _conv(x, runtime_params["head"]["w"], 1, dtype) + runtime_params["head"]["b"]
    )
    return logits.astype(jnp.float32)
