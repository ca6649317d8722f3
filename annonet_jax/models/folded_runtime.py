"""Fully width-folded inference network: every conv at wide channel counts.

The model family's channel counts (3..128, dlib's default widths) give
convs tiny contraction and output dims: a 3x3/16-channel conv is a chain
of per-tap K=16 matmuls that leave a matrix unit mostly idle. Folding F
width-adjacent pixels into the channel dimension widens the shapes, but
folding/unfolding around individual convs makes XLA insert relayout
copies that eat the win.

So this module folds the WHOLE runtime net once: the input image is
reshaped (free, channel-minor NHWC) to width blocks at fold F0, and every
layer consumes and produces folded activations — the fold factor halves
through each stride-2 encoder stage and doubles through each 2x upsample,
so the folded channel count stays 128-256 everywhere:

  layer           real ch   fold   folded ch (K -> N)
  stem conv0      3 -> 16    8      24 -> 128
  stem conv1     16 -> 16    8     128 -> 128
  enc-i s2 conv  c -> 2c    f->f/2 128 -> 128
  enc-i s1 conv  2c -> 2c   f/2    128 -> 128
  dec-i up       2c -> c    f->2f  128 -> 128
  dec-i conv     2c -> c    2f     256 -> 128
  head 1x1       16 -> K     8     128 -> 8K

All geometry transformations (stride-2 taps, transpose-conv upsampling,
skip concatenation order) are baked into block-structured kernels built
ONCE on the host from the BN-folded runtime params (fold_runtime_params),
so the device program is a plain chain of dense convs + bias/ReLU.
Equivalence with models.segnet.apply_runtime is exact (same ops, reordered)
and covered by tests.

Reference parity: this is purely an execution-layout transform of the same
function computed by NetPimpl::RuntimeNet::Forward (annonet_infer.cpp:77).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from annonet_jax.models.segnet import SegNetConfig, _normalize_input

_DN = ("NHWC", "HWIO", "NHWC")

# (strides, padding) of each folded conv kind, shared by EVERY spec walker
# (the two bf16 applies here and quantized_runtime's calibrate/int8 applies)
# so the execution paths cannot silently diverge on geometry
FOLDED_CONV_GEOMETRY = {
    "s1": ((1, 1), [(1, 1), (1, 1)]),
    "s2": ((2, 1), [(0, 1), (0, 1)]),
    "s1_plain": ((1, 1), "SAME"),
    "s2_plain": ((2, 2), "SAME"),
}


# ---------------------------------------------------------------------------
# Host-side kernel builders (numpy, run once per loaded model)
# ---------------------------------------------------------------------------


def _fold_s1_kernel(w: np.ndarray, fold: int) -> np.ndarray:
    """Stride-1 3x3 conv kernel -> [3, 3, fold*cin, fold*cout].

    out block taps in blocks dxb in {-1,0,1}: row (i,ci) -> col (j,co) gets
    w[dy, dx] where i = j + dx - fold*dxb, dx = kx-1.
    """
    kh, kw, cin, cout = w.shape
    assert (kh, kw) == (3, 3)
    out = np.zeros((3, 3, fold * cin, fold * cout), w.dtype)
    for kx in range(3):
        dx = kx - 1
        for j in range(fold):
            i = j + dx
            dxb = i // fold
            out[:, dxb + 1, (i % fold) * cin : (i % fold + 1) * cin,
                j * cout : (j + 1) * cout] = w[:, kx]
    return out


def _fold_s2_kernel(w: np.ndarray, fold: int) -> np.ndarray:
    """Stride-2 3x3 conv kernel -> [3, 2, fold*cin, (fold//2)*cout].

    XLA SAME padding for k=3 s=2 on even dims is (0, 1), so output pixel o
    taps inputs 2o+dx, dx in {0,1,2}. In folded space (output fold fold//2):
    i = 2j + dx - fold*dxb with dxb in {0, 1}; the device conv then runs
    with height stride 2 / width-block stride 1, padding ((0,1),(0,1)).
    """
    kh, kw, cin, cout = w.shape
    assert (kh, kw) == (3, 3) and fold % 2 == 0
    half = fold // 2
    out = np.zeros((3, 2, fold * cin, half * cout), w.dtype)
    for dx in range(3):
        for j in range(half):
            i = 2 * j + dx
            dxb = i // fold
            out[:, dxb, (i % fold) * cin : (i % fold + 1) * cin,
                j * cout : (j + 1) * cout] = w[:, dx]
    return out


def _fold_up_kernel(w: np.ndarray, fold: int) -> np.ndarray:
    """2x2 stride-2 transpose-conv kernel -> [2, 1, fold*cin, 2*fold*cout]
    for lax.conv_transpose with strides (2, 1).

    Verified semantics of the original: out[2i+u, 2j+v] = x[i,j] w[1-u, 1-v].
    lax.conv_transpose flips the kernel, so Kf[q, 0] must map
    (i, ci) -> (2i+v, co) with weight w[q, 1-v].
    """
    kh, kw, cin, cout = w.shape
    assert (kh, kw) == (2, 2)
    out = np.zeros((2, 1, fold * cin, 2 * fold * cout), w.dtype)
    for q in range(2):
        for v in range(2):
            for i in range(fold):
                j_out = 2 * i + v
                out[q, 0, i * cin : (i + 1) * cin,
                    j_out * cout : (j_out + 1) * cout] = w[q, 1 - v]
    return out


def _fold_1x1_kernel(
    w: np.ndarray, fold: int, class_major: bool = False
) -> np.ndarray:
    """1x1 conv kernel -> [1, 1, fold*cin, fold*cout] (block diagonal).

    With ``class_major`` the output columns are ordered co*fold + i
    (class-major) instead of i*cout + co: each class's fold group is then
    a CONTIGUOUS lane slice, so the tiled-inference blend can take per-
    class planes with a free lane slice + width-unfold reshape instead of
    the full [.., f*K] -> [.., W, K] unfold (which XLA lowers to a
    relayout chain).
    """
    kh, kw, cin, cout = w.shape
    assert (kh, kw) == (1, 1)
    out = np.zeros((1, 1, fold * cin, fold * cout), w.dtype)
    for i in range(fold):
        for co in range(cout):
            col = co * fold + i if class_major else i * cout + co
            out[0, 0, i * cin : (i + 1) * cin, col] = w[0, 0, :, co]
    return out


def _concat_perm(fold: int, c1: int, c2: int) -> np.ndarray:
    """Row permutation mapping actual concat layout -> packed folded layout.

    Folded kernels index input rows as (i, c) with c over c1+c2 channels
    per pixel; a channel concat of two folded tensors instead yields
    [i*c1+c ...] followed by [fold*c1 + i*c2 + c ...]. Returns perm with
    W_actual[a] = W_packed[perm[a]].
    """
    perm = np.empty(fold * (c1 + c2), np.int64)
    for a in range(fold * c1):
        i, c = divmod(a, c1)
        perm[a] = i * (c1 + c2) + c
    for a2 in range(fold * c2):
        i, c = divmod(a2, c2)
        perm[fold * c1 + a2] = i * (c1 + c2) + c1 + c
    return perm


def _tile_bias(b: np.ndarray, fold: int) -> np.ndarray:
    return np.tile(np.asarray(b), fold)


def fold_runtime_params(
    runtime_params: Any,
    config: SegNetConfig,
    fold0: int = 8,
) -> Dict[str, Any]:
    """Precompute the fully folded kernel/bias set from a BN-folded runtime
    net (host-side, once per loaded model).

    Dec-layer kernels absorb the skip-concat row permutation.
    """

    def emit_s1(layers, w, b, f, cin, row_perm=None):
        if f <= 1:
            layers.append(("s1_plain", w, b))
            return
        wk = _fold_s1_kernel(w, f)
        if row_perm is not None:
            wk = wk[:, :, row_perm, :]
        layers.append(("s1", wk, _tile_bias(b, f)))
    def to_np(tree):
        if isinstance(tree, dict):
            return {k: to_np(v) for k, v in tree.items()}
        return np.asarray(tree, np.float32)

    rp = to_np(runtime_params)
    # the head group is {"w","b"} directly (no conv sub-dict)
    rp["head"] = {"conv": {"w": rp["head"]["w"], "b": rp["head"]["b"]}}
    L = config.level_count
    fp: Dict[str, Any] = {"fold0": fold0, "layers": []}
    layers: List[Tuple] = fp["layers"]

    f = fold0
    cin = config.in_channels
    w0 = config.width(0)

    w0k = rp["stem"]["conv0"]["w"]
    if f > 1 and cin == 1:
        # grayscale: pad the stem input to 3 channels, the RGB shape, so
        # both color modes compile the same folded stem (an 8-channel
        # folded stem input once hit a pathological compile time).
        # The padded kernel rows are zero, so the extra lanes are inert.
        w0k = np.concatenate(
            [w0k, np.zeros((3, 3, 2, w0k.shape[3]), w0k.dtype)], axis=2
        )
        cin = 3
        layers.append(("pad_input", cin, None))
    emit_s1(layers, w0k, rp["stem"]["conv0"]["b"], f, cin)
    emit_s1(layers, rp["stem"]["conv1"]["w"], rp["stem"]["conv1"]["b"], f, w0)
    layers.append(("save_skip", 0, None))

    folds = {0: f}
    for i in range(1, L + 1):
        cout = config.width(i)
        if f >= 2:
            layers.append(("s2", _fold_s2_kernel(rp[f"enc{i}"]["conv0"]["w"], f),
                           _tile_bias(rp[f"enc{i}"]["conv0"]["b"], f // 2)))
            f //= 2
        else:
            layers.append(("s2_plain", rp[f"enc{i}"]["conv0"]["w"],
                           rp[f"enc{i}"]["conv0"]["b"]))
        emit_s1(layers, rp[f"enc{i}"]["conv1"]["w"],
                rp[f"enc{i}"]["conv1"]["b"], f, cout)
        folds[i] = f
        if i < L:
            layers.append(("save_skip", i, None))

    for i in range(L, 0, -1):
        cskip = config.width(i - 1)
        if f >= 1:
            layers.append(("up", _fold_up_kernel(rp[f"dec{i}"]["up"]["w"], f),
                           _tile_bias(rp[f"dec{i}"]["up"]["b"], 2 * f)))
            f *= 2
        assert f == folds[i - 1], (f, folds)
        layers.append(("concat_skip", i - 1, None))
        # the conv after concat sees [up(cskip) ++ skip(cskip)] in concat
        # layout; bake the permutation into the kernel's input rows
        perm = _concat_perm(f, cskip, cskip)
        emit_s1(layers, rp[f"dec{i}"]["conv0"]["w"],
                rp[f"dec{i}"]["conv0"]["b"], f, 2 * cskip, row_perm=perm)

    layers.append(
        (
            "head",
            _fold_1x1_kernel(rp["head"]["conv"]["w"], f, class_major=True),
            np.repeat(np.asarray(rp["head"]["conv"]["b"]), f),
        )
    )
    fp["final_fold"] = f
    return fp


def split_folded(fparams: Dict[str, Any]):
    """Split the folded net into (static spec, array pytree) so the spec can
    close over a jit while the kernels travel as traced arguments.

    spec: tuple of strings ("s1", "s2", ..., "save_skip:0", "concat_skip:1")
    arrays: tuple of (w, b) pairs (None for the skip bookkeeping entries)
    """
    spec = []
    arrays = []
    for kind, a, b in fparams["layers"]:
        if kind in ("save_skip", "concat_skip", "pad_input"):
            spec.append(f"{kind}:{a}")
            arrays.append(None)
        else:
            spec.append(kind)
            arrays.append((jnp.asarray(a), jnp.asarray(b)))
    return (fparams["fold0"], tuple(spec)), tuple(arrays)


def pad_input_channels(x_uint8: jnp.ndarray, spec) -> jnp.ndarray:
    """Apply the spec's leading ``pad_input:N`` marker (grayscale stem
    alignment — see fold_runtime_params): zero-pad the channel dim to N.
    The matching kernel rows are zero, so the values are don't-cares."""
    if spec and str(spec[0]).startswith("pad_input:"):
        n_ch = int(str(spec[0]).split(":")[1])
        x_uint8 = jnp.pad(
            x_uint8,
            ((0, 0),) * (x_uint8.ndim - 1)
            + ((0, n_ch - x_uint8.shape[-1]),),
        )
    return x_uint8


def unfold_logits(x: jnp.ndarray, class_count: int) -> jnp.ndarray:
    """[n, h, wb, K*f] class-major folded logits -> [n, h, w, K]."""
    n, h, wb, ckf = x.shape
    f = ckf // class_count
    x = x.reshape(n, h, wb, class_count, f)
    x = jnp.swapaxes(x, -1, -2)
    return x.reshape(n, h, wb * f, class_count)


def apply_folded_split(
    arrays, x_uint8: jnp.ndarray, config: SegNetConfig, *, fold0: int, spec,
    folded_output: bool = False
) -> jnp.ndarray:
    """Jit-friendly folded forward: ``spec``/``fold0`` static, ``arrays``
    traced. Same function as apply_runtime. With ``folded_output`` the
    logits stay width-folded [n, h, w/f, K*f] with CLASS-MAJOR lanes
    (class k's plane = lanes [k*f, (k+1)*f) — see _fold_1x1_kernel)."""
    dtype = jnp.dtype(config.compute_dtype)
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

    skips = {}
    for kind, entry in zip(spec, arrays):
        if kind.startswith("pad_input"):
            continue
        if kind.startswith("save_skip"):
            skips[kind.split(":")[1]] = x
        elif kind.startswith("concat_skip"):
            x = jnp.concatenate([x, skips[kind.split(":")[1]]], axis=-1)
        elif kind in FOLDED_CONV_GEOMETRY:
            strides, padding = FOLDED_CONV_GEOMETRY[kind]
            x = conv(x, entry[0], entry[1], strides, padding)
        elif kind == "up":
            out = lax.conv_transpose(
                x, entry[0].astype(dtype), strides=(2, 1),
                padding="SAME", dimension_numbers=_DN,
            )
            x = jnp.maximum(out + entry[1], 0.0).astype(dtype)
        elif kind == "head":
            x = _head_matmul(x, entry[0], entry[1], dtype)
        else:  # pragma: no cover
            raise ValueError(kind)

    if folded_output:
        return x
    return unfold_logits(x, config.class_count)


def _head_matmul(x, w, b, dtype, default_dot: bool = False):
    """The 1x1 head as an explicit matmul (identical math to the SAME-pad
    conv) or as a conv, per each path's default (docs/DESIGN.md par.24):
    the int8 twin passes default_dot=True, while this bf16 path keeps the
    conv, whose fusion also carries the blend epilogue. ANNONET_HEAD_DOT=1/0
    force-overrides either way for A/B."""
    import os as _os

    env = _os.environ.get("ANNONET_HEAD_DOT")
    use_dot = default_dot if env is None else env != "0"
    if not use_dot:
        out = lax.conv_general_dilated(
            x, jnp.asarray(w).astype(dtype), (1, 1), "SAME",
            dimension_numbers=_DN,
        )
        return (out + jnp.asarray(b)).astype(jnp.float32)
    n_, h_, wb_, c_ = x.shape
    w2 = jnp.asarray(w).astype(dtype).reshape(c_, -1)
    out = lax.dot_general(
        x.reshape(n_ * h_ * wb_, c_), w2,
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    ).reshape(n_, h_, wb_, -1)
    return (out + jnp.asarray(b)).astype(jnp.float32)


def folding_supported(config: SegNetConfig, tile_width: int) -> int:
    """The fold factor to use for this config/tile, or 0 when folding
    doesn't apply (width not divisible / nothing to gain / the fold
    schedule cannot mirror through the decoder).

    The encoder halves the fold at every stride-2 level and the decoder
    doubles it back at every up layer, so a valid base fold must survive
    ``level_count`` halvings without flooring at 1: fold0 >= 2^L.
    Configs whose stem width forbids that (e.g. base_width 24/32 at
    level_count 3: 8 * width(0) > 128 lanes caps fold0 at 4 < 2^3) run
    the plain unfolded net — previously they passed this gate and then
    crashed fold_runtime_params' decoder mirror assert (found by the
    round-5 detection sweep's width arm)."""
    fold = 8
    while fold > 1 and (
        tile_width % fold or fold * config.width(0) > 128
    ):
        fold //= 2
    if fold < (1 << config.level_count):
        return 0
    return fold if fold > 1 else 0


# ---------------------------------------------------------------------------
# Device-side forward
# ---------------------------------------------------------------------------


def apply_runtime_folded(
    fparams: Dict[str, Any], x_uint8: jnp.ndarray, config: SegNetConfig
) -> jnp.ndarray:
    """[N,H,W,C]u8 -> [N,H,W,K]f32 logits; same function as apply_runtime."""
    dtype = jnp.dtype(config.compute_dtype)
    fold0 = fparams["fold0"]
    n, h, width, _cin = x_uint8.shape
    assert width % fold0 == 0, (
        f"width {width} must be a multiple of the base fold {fold0}"
    )
    if fparams["layers"] and fparams["layers"][0][0] == "pad_input":
        x_uint8 = pad_input_channels(
            x_uint8, (f"pad_input:{fparams['layers'][0][1]}",)
        )
    cin = x_uint8.shape[-1]
    x = _normalize_input(x_uint8, dtype)
    x = x.reshape(n, h, width // fold0, fold0 * cin)

    def conv(x, w, b, strides, padding):
        out = lax.conv_general_dilated(
            x, jnp.asarray(w).astype(dtype), strides, padding,
            dimension_numbers=_DN,
        )
        return jnp.maximum(out + jnp.asarray(b), 0.0).astype(dtype)

    skips = {}
    for kind, a, b in fparams["layers"]:
        if kind == "pad_input":
            pass
        elif kind == "save_skip":
            skips[a] = x
        elif kind == "concat_skip":
            x = jnp.concatenate([x, skips[a]], axis=-1)
        elif kind in FOLDED_CONV_GEOMETRY:
            strides, padding = FOLDED_CONV_GEOMETRY[kind]
            x = conv(x, a, b, strides, padding)
        elif kind == "up":
            out = lax.conv_transpose(
                x, jnp.asarray(a).astype(dtype), strides=(2, 1),
                padding="SAME", dimension_numbers=_DN,
            )
            x = jnp.maximum(out + jnp.asarray(b), 0.0).astype(dtype)
        elif kind == "head":
            x = _head_matmul(x, a, b, dtype)
        else:  # pragma: no cover
            raise ValueError(kind)

    return unfold_logits(x, config.class_count)


# ---------------------------------------------------------------------------
# Folded TRAINING forward (kernels folded from traced weights each step)
# ---------------------------------------------------------------------------


def _fold_s2_kernel_jnp(w, fold: int):
    """Traceable version of _fold_s2_kernel."""
    kh, kw, cin, cout = w.shape
    half = fold // 2
    out = jnp.zeros((3, 2, fold * cin, half * cout), w.dtype)
    for dx in range(3):
        for j in range(half):
            i = 2 * j + dx
            dxb = i // fold
            out = out.at[:, dxb, (i % fold) * cin : (i % fold + 1) * cin,
                         j * cout : (j + 1) * cout].set(w[:, dx])
    return out


def _fold_up_kernel_jnp(w, fold: int):
    """Traceable version of _fold_up_kernel."""
    kh, kw, cin, cout = w.shape
    out = jnp.zeros((2, 1, fold * cin, 2 * fold * cout), w.dtype)
    for q in range(2):
        for v in range(2):
            for i in range(fold):
                j_out = 2 * i + v
                out = out.at[q, 0, i * cin : (i + 1) * cin,
                             j_out * cout : (j_out + 1) * cout].set(
                    w[q, 1 - v]
                )
    return out


def _fold_1x1_kernel_jnp(w, fold: int):
    kh, kw, cin, cout = w.shape
    out = jnp.zeros((1, 1, fold * cin, fold * cout), w.dtype)
    for i in range(fold):
        out = out.at[0, 0, i * cin : (i + 1) * cin,
                     i * cout : (i + 1) * cout].set(w[0, 0])
    return out


def _bn_train_folded(h, bn, fold: int, axis_name=None):
    """Batch-norm over a FOLDED activation: statistics per REAL channel.

    h: [n, hh, wb, fold*c]; the fold groups are extra reduction elements.
    Returns (normalized h [same shape], mean [c], var [c]) — identical math
    to segnet._bn_train on the unfolded activation.
    """
    c = h.shape[-1] // fold
    h32 = h.astype(jnp.float32)
    hv = h32.reshape(*h.shape[:-1], fold, c)
    mean = jnp.mean(hv, axis=(0, 1, 2, 3))
    mean_sq = jnp.mean(jnp.square(hv), axis=(0, 1, 2, 3))
    if axis_name is not None:
        mean = lax.pmean(mean, axis_name)
        mean_sq = lax.pmean(mean_sq, axis_name)
    var = jnp.maximum(mean_sq - jnp.square(mean), 0.0)
    inv = lax.rsqrt(var + 1e-5)
    # normalize in the compute dtype (see segnet._bn_train): per-channel
    # scale/shift rounded once, activations/residuals stay bf16
    gamma_t = jnp.tile(bn["gamma"] * inv, fold).astype(h.dtype)
    beta_t = jnp.tile(
        bn["beta"] - bn["gamma"] * inv * mean, fold
    ).astype(h.dtype)
    return h * gamma_t + beta_t, mean, var


def apply_train_folded(
    params,
    bn_stats,
    x_uint8,
    config: SegNetConfig,
    bn_momentum: float = 0.99,
    axis_name=None,
    fold0: int = 8,
):
    """Width-folded training forward: same function as segnet.apply_train
    (identical logits and new BN stats, reassociated arithmetic), with every
    conv at wide folded channel counts. Kernels are folded from the live
    weights inside the step — a handful of tiny scatters — and gradients
    flow back through them to the original parameter tensors.
    """
    from annonet_jax.models.segnet import _bn_update
    from annonet_jax.ops.folded_conv import fold_width_kernel

    dtype = jnp.dtype(config.compute_dtype)
    L = config.level_count
    n, h, width, cin = x_uint8.shape
    assert width % fold0 == 0 and width >= fold0
    new_stats = {k: dict(v) for k, v in bn_stats.items()}

    def conv(x, wf, strides, padding):
        return lax.conv_general_dilated(
            x, wf.astype(dtype), strides, padding, dimension_numbers=_DN
        )

    def unit(x, p, s, conv_name, bn_name, kind, fold):
        w = p[conv_name].astype(dtype)
        if kind == "s1":
            if fold > 1:
                hpre = conv(x, fold_width_kernel(w, fold), (1, 1),
                            [(1, 1), (1, 1)])
            else:
                hpre = conv(x, w, (1, 1), "SAME")
            fold_out = fold
        elif kind == "s2":
            if fold > 1:
                hpre = conv(x, _fold_s2_kernel_jnp(w, fold), (2, 1),
                            [(0, 1), (0, 1)])
                fold_out = fold // 2
            else:
                hpre = conv(x, w, (2, 2), "SAME")
                fold_out = 1
        elif kind == "up":
            if fold >= 1:
                wf = _fold_up_kernel_jnp(w, fold)
                hpre = lax.conv_transpose(
                    x, wf.astype(dtype), strides=(2, 1), padding="SAME",
                    dimension_numbers=_DN,
                )
                fold_out = 2 * fold
        normed, mean, var = _bn_train_folded(
            hpre, p[bn_name], fold_out, axis_name
        )
        s[bn_name] = _bn_update(s[bn_name], mean, var, bn_momentum)
        return jnp.maximum(normed, 0.0).astype(dtype), fold_out

    x = _normalize_input(x_uint8, dtype)
    x = x.reshape(n, h, width // fold0, fold0 * cin)
    f = fold0

    p, s = params["stem"], new_stats["stem"]
    x, f = unit(x, p, s, "conv0", "bn0", "s1", f)
    x, f = unit(x, p, s, "conv1", "bn1", "s1", f)
    skips = [(x, f)]
    folds = {0: f}
    for i in range(1, L + 1):
        p, s = params[f"enc{i}"], new_stats[f"enc{i}"]
        x, f = unit(x, p, s, "conv0", "bn0", "s2", f)
        x, f = unit(x, p, s, "conv1", "bn1", "s1", f)
        folds[i] = f
        if i < L:
            skips.append((x, f))
    for i in range(L, 0, -1):
        p, s = params[f"dec{i}"], new_stats[f"dec{i}"]
        x, f = unit(x, p, s, "up", "bnu", "up", f)
        skip_x, skip_f = skips[i - 1]
        assert skip_f == f, (skip_f, f)
        x = jnp.concatenate([x, skip_x], axis=-1)
        # concat layout -> packed folded layout via a static kernel-row perm
        cskip = config.width(i - 1)
        w = params[f"dec{i}"]["conv0"].astype(dtype)
        if f > 1:
            wk = fold_width_kernel(w, f)
            perm = _concat_perm(f, cskip, cskip)
            wk = wk[:, :, perm, :]
            hpre = conv(x, wk, (1, 1), [(1, 1), (1, 1)])
        else:
            hpre = conv(x, w, (1, 1), "SAME")
        normed, mean, var = _bn_train_folded(
            hpre, params[f"dec{i}"]["bn0"], f, axis_name
        )
        s["bn0"] = _bn_update(s["bn0"], mean, var, bn_momentum)
        x = jnp.maximum(normed, 0.0).astype(dtype)

    wh = params["head"]["w"].astype(dtype)
    if f > 1:
        logits = conv(x, _fold_1x1_kernel_jnp(wh, f), (1, 1), "SAME")
        bias = jnp.tile(params["head"]["b"], f)
    else:
        logits = conv(x, wh, (1, 1), "SAME")
        bias = params["head"]["b"]
    logits = (logits + bias).astype(jnp.float32)
    return logits.reshape(n, h, width, config.class_count), new_stats
