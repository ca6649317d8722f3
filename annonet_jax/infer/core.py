"""Tiled inference: batched tile forward, on-device blending, argmax + gains,
detection-level blob filtering.

The accelerator re-design of annonet_infer (annonet_infer.cpp:32-240):

  reference (per image, per tile, host loops)      here (per image, one jit)
  -------------------------------------------      -------------------------
  sequential per-tile net.Forward                  ONE batched [n,T,T,C] forward
  host-side per-pixel ramp blending (:116-164)     device scatter-add with a
                                                   shared ramp weight map
  host-side argmax + gains (:170-185)              device argmax over blended
                                                   logits + gain vector
  detection seeds (:187-212)                       device seed mask
  dlib::label_connected_blobs veto (:217-238)      host blob veto (ops.blobs)

Per-class gains are added in LOGIT space after blending and detection levels
compare blended logit margins (gain enters the argmax, the seed test uses
gain-free outputs, annonet_infer.cpp:170-212) — with one documented
deviation: the blend is normalized by the ramp sum BEFORE gains are added,
so gains/detection levels mean the same thing at every pixel, whereas the
reference compares against unnormalized (ramp-sum-inflated) logits inside
tile-overlap bands (PARITY.md "Documented behavioral deviations";
pinned by tests/test_infer.py::
test_gain_semantics_in_overlap_bands_documented_deviation). The opt-in
compat mode (--reference-blend-semantics /
TiledInferer(reference_blend_semantics=True)) reproduces the reference's
unnormalized comparisons in this framework's own grid, so tuned
gains/levels carry over from reference deployments.

Compilation: one XLA program per (padded size, tile shape, tile-count
bucket); gains/detection levels are traced arguments so changing them never
recompiles.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from annonet_jax.utils.compile_opts import opt_jit

from annonet_jax.models.segnet import (
    SegNetConfig,
    apply_runtime,
    required_input_dimension,
)
from annonet_jax.infer.tiling import (
    TilePlan,
    TilingParameters,
    bucket_dim,
    inverse_weight_sum,
    plan_for_counts,
    plan_tiles,
    ramp_weights,
    weight_sum_factors,
)

from annonet_jax.ops.blobs import label_connected_blobs

# images are padded up to compile buckets before tracing, so nearby image
# sizes share compiled programs (see tiling.bucket_dim)
_CANVAS_BUCKET = 128

# The tile forward's live activations may take this share of the memory
# the device reports as its limit (memory_stats()["bytes_limit"], the pool
# JAX reserved). The rest holds the padded canvas, the blend accumulator,
# the parameters and XLA's own temporaries, which the per-pixel activation
# estimate in TiledInferer._get_compiled does not count.
ACTIVATION_SHARE = 0.25
# The CPU backend reports no memory limit; host RAM is its budget, and
# this stated constant keeps CPU programs unchunked at the sizes tests use.
CPU_ACTIVATION_BUDGET = 8 << 30


def activation_budget_bytes(device) -> int:
    """Bytes of tile-forward activations one batched call may hold on
    ``device`` before the forward is chunked (lax.map over tile chunks).

    Derived from the device's own memory limit; no size is assumed for a
    device that reports none."""
    if device.platform == "cpu":
        return CPU_ACTIVATION_BUDGET
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"device {device} reports no memory limit; pass forward_chunk "
            "to TiledInferer to size the tile forward explicitly"
        )
    return int(limit * ACTIVATION_SHARE)


def _gather_sublane() -> bool:
    """A/B knob for the tile-gather axis order (trace-time, like _head_dot).

    When the conv kernels want the tile batch second-minor, a leading-axis
    jnp.stack costs a separate relayout copy of the whole tile batch.
    Stacking with the tile axis second-minor and transposing back is
    logically identical but lets XLA keep the stack's natural row-major
    layout and turn the transpose into a relabel. Composed A/B:
    scripts/ab_gather_order.py."""
    import os

    return os.environ.get("ANNONET_GATHER_ORDER") == "sublane"


def _blend_strips() -> bool:
    """A/B knob (trace-time): accumulate the blend canvas as per-tile-row
    strips + one concat overlap-add along H, instead of a
    tile-count-deep serialized dynamic-update-slice chain.

    Composed A/B: scripts/ab_blend_strips.py. NOT bit-identical in
    y-overlap bands (the strip pre-sums regroup the adds: (a1+a2)+(b1+b2)
    vs (((a1+a2)+b1)+b2)). Default OFF."""
    import os

    return os.environ.get("ANNONET_BLEND_STRIPS") == "1"


def _accumulate_canvas(
    weighted, tile_yx, m, hp, row_width, tile_h, piece_w, x_to_col, bd
):
    """Sum ramp-weighted tile contributions into the [m, hp, row_width]
    canvas. weighted is [n, m, tile_h, piece_w]; tile i covers rows
    [y, y+tile_h) and columns [x_to_col(x), x_to_col(x)+piece_w).

    SHIPPED layout: the flat serialized update-slice chain. The strip
    alternative (per-tile-row strips + one H-concat; opt-in via
    ANNONET_BLEND_STRIPS=1) regroups the float adds in y-overlap bands —
    see _blend_strips."""
    ys = sorted({y for y, _ in tile_yx})
    usable = (
        _blend_strips()
        and len(ys) > 1
        and ys[0] == 0
        and ys[-1] + tile_h == hp
        # full coverage, and only CONSECUTIVE strips may overlap
        and all(yb - ya <= tile_h for ya, yb in zip(ys, ys[1:]))
        and all(yb - ya >= tile_h for ya, yb in zip(ys, ys[2:]))
    )
    if not usable:
        acc = jnp.zeros((m, hp, row_width), bd)
        for i, (y, x) in enumerate(tile_yx):
            col = x_to_col(x)
            acc = acc.at[:, y : y + tile_h, col : col + piece_w].add(
                weighted[i]
            )
        return acc

    strips = {}
    for i, (y, x) in enumerate(tile_yx):
        col = x_to_col(x)
        strip = strips.get(y)
        if strip is None:
            strip = jnp.zeros((m, tile_h, row_width), bd)
        strips[y] = strip.at[:, :, col : col + piece_w].add(weighted[i])

    pieces = []
    prev_tail = None
    for j, y in enumerate(ys):
        lo = 0 if j == 0 else ys[j - 1] + tile_h - y
        hi = tile_h if j + 1 == len(ys) else ys[j + 1] - y
        if j > 0 and lo > 0:
            # overlap band with the previous strip: per-pixel add order
            # matches the flat chain (earlier tile row first)
            pieces.append(prev_tail + strips[y][:, :lo])
        if hi > lo:
            pieces.append(strips[y][:, lo:hi])
        prev_tail = strips[y][:, hi:]
    return jnp.concatenate(pieces, axis=1)


def _stack_tiles(slices):
    """jnp.stack(slices) (-> [n, m, th, tw, c]) with a layout-motivated
    axis order (see _gather_sublane)."""
    if _gather_sublane():
        tiles = jnp.stack(slices, axis=3)  # [m, th, tw, n, c]
        return jnp.transpose(tiles, (3, 0, 1, 2, 4))
    return jnp.stack(slices)


def _tiled_forward(
    params,
    image: jnp.ndarray,  # [H, W, C] uint8 (unpadded)
    gains: jnp.ndarray,  # [K] float32
    detection_levels: jnp.ndarray,  # [K] float32
    ramp: jnp.ndarray,  # [th, tw] float32
    inv_wsum: jnp.ndarray,  # [Hp, Wp] float32 (per-plan constant)
    *,
    config: SegNetConfig,
    padded_h: int,
    padded_w: int,
    tile_yx: Tuple[Tuple[int, int], ...],  # STATIC tile positions
    tile_h: int,
    tile_w: int,
    forward_chunk: int,
    with_detection: bool,
    folded=None,  # (fold0, spec): params is then the folded array tuple
    quantized: bool = False,  # spec/params are the int8 qspec/qarrays
    wsum_factors=None,  # (wy[Hp], wx[Wp]) np: wsum separable over the grid
    blend_dtype=jnp.float32,  # accumulation dtype of the blend epilogue
    mesh=None,
    mesh_axis: str = "batch",
    # reference-blend compat (annonet_infer.cpp:146-161,176-185,205-211):
    # compare gains and detection-seed margins against the UNNORMALIZED
    # ramp-sum accumulation s(p)*blended — the reference's semantics
    # inside tile-overlap bands — instead of normalizing first. With zero
    # gains and levels the label maps are identical (argmax is invariant
    # under the positive per-pixel scale s); under nonzero gains/levels
    # this lets reference users carry tuned values over unchanged.
    reference_blend: bool = False,
):
    # Tile positions are a deterministic function of the compile key (padded
    # canvas + tile shape + overlap), so they are baked in as constants:
    # the gather and the blend below use STATIC slices XLA can fuse and
    # schedule without dynamic-update-slice copies, and no bucket-padding
    # dummy tiles are ever forwarded.
    #
    # An optional leading image-batch dim M rides through the whole program
    # (tile gather, forward batch = M*T tiles, blend, argmax): same-sized
    # images share one plan, and batching amortizes per-call host overhead
    # for directories of small images (DESIGN.md §13 has the per-call
    # transfer roofline).
    batched = image.ndim == 4
    if not batched:
        image = image[None]
    m = image.shape[0]
    n = len(tile_yx)
    h, w, c = image.shape[1:]
    hp, wp = padded_h, padded_w
    k = config.class_count

    # replicate-pad on device (outpaint parity, annonet_infer.cpp:71-75)
    padded_image = jnp.pad(
        image, ((0, 0), (0, hp - h), (0, wp - w), (0, 0)), mode="edge"
    )

    # under the folded net the logits stay width-folded with class-major
    # channels all the way into the blend (the full unfold reshape is a
    # relayout chain; per-class channel slices are free).
    # Requires fold-aligned tile x offsets (tiling._positions snaps to 8;
    # the guard covers its rare unsnapped fallback).
    folded_out = folded is not None and all(
        x % folded[0] == 0 for (_, x) in tile_yx
    )
    pre_quantize = quantized and folded_out

    if pre_quantize:
        # quantize + width-fold the whole padded image ONCE and gather int8
        # tiles from it: overlapping pixels quantize once, and the tile
        # batch materializes directly (re-quantizing per tile costs an
        # int8 relayout between the quantize and the stem)
        from annonet_jax.models.quantized_runtime import quantize_input

        f0 = folded[0]
        q_img = quantize_input(padded_image, f0, folded[1])
        lanes = q_img.shape[-1]
        tiles = _stack_tiles(
            [
                lax.slice(
                    q_img,
                    (0, y, x // f0, 0),
                    (m, y + tile_h, (x + tile_w) // f0, lanes),
                )
                for (y, x) in tile_yx
            ]
        )  # [n, m, th, twb, f0*C'] int8
    else:
        tiles = _stack_tiles(
            [
                lax.slice(
                    padded_image,
                    (0, y, x, 0),
                    (m, y + tile_h, x + tile_w, c),
                )
                for (y, x) in tile_yx
            ]
        )  # [n, m, th, tw, C]
    tiles = tiles.reshape((n * m,) + tiles.shape[2:])

    if folded is not None and quantized:
        # int8 folded net: int8 conv stack, bf16 up layers, f32 logits
        # out (models/quantized_runtime.py)
        from annonet_jax.models.quantized_runtime import apply_folded_int8

        fold0, qspec = folded
        run_net = lambda batch: apply_folded_int8(  # noqa: E731
            params, batch, config, fold0=fold0, qspec=qspec,
            folded_output=folded_out, pre_folded=pre_quantize,
        )
    elif folded is not None:
        # fully width-folded net: every conv runs at wide folded channel
        # counts (models/folded_runtime.py)
        from annonet_jax.models.folded_runtime import apply_folded_split

        fold0, spec = folded
        run_net = lambda batch: apply_folded_split(  # noqa: E731
            params, batch, config, fold0=fold0, spec=spec,
            folded_output=folded_out,
        )
    else:
        run_net = lambda batch: apply_runtime(params, batch, config)  # noqa: E731

    if mesh is not None:
        # tile-parallel inference (the spatial analog of context/sequence
        # parallelism, SURVEY.md §2.3): shard the tile batch over the mesh;
        # GSPMD partitions the batched convs, one all-gather brings the
        # logits back for blending
        from jax.sharding import NamedSharding, PartitionSpec as P

        sharded = NamedSharding(mesh, P(mesh_axis))
        tiles = lax.with_sharding_constraint(tiles, sharded)
        logits = run_net(tiles)
        logits = lax.with_sharding_constraint(
            logits, NamedSharding(mesh, P())
        )
    elif n * m > forward_chunk and (n * m) % forward_chunk == 0:
        # chunk the batch so device memory holds one chunk of activations
        # at a time while the convs stay large and batched
        # (shape-agnostic: pre-quantized tiles are already width-folded)
        tiles = tiles.reshape(
            (n * m // forward_chunk, forward_chunk) + tiles.shape[1:]
        )
        logits = lax.map(run_net, tiles)  # [nm/chunk, chunk, th, tw|twb, *]
    else:
        logits = run_net(tiles)
    logits = logits.reshape((n, m, tile_h) + logits.shape[-2:])

    # blend PER CLASS PLANE: every tensor in the blend keeps its two
    # spatial dims minor, never letting the tiny class/tile dims become
    # the minor ones — a bulk transpose to [n,K,th,tw] here lets XLA pick
    # layouts that pad the small (n,K) pair with large memory blowups. The
    # per-class planes also mirror the reference's own representation
    # (annonet_infer.cpp:86-89). inv_wsum is a per-plan host constant.
    if folded_out:
        # the ENTIRE blend/argmax/detection epilogue stays width-folded:
        # the K*f class-major channels ride through the scatter-add (tile x
        # offsets are always fold-multiples — tiling._positions snaps to 8),
        # per-pixel constants (ramp, inv_wsum) fold with free reshapes, and
        # only the final uint8 label map unfolds (unfolding f32 planes
        # instead costs relayout chains).
        f = logits.shape[-1] // k
        wpb = wp // f
        kf = k * f
        # FLAT 2-D accumulation: a [Hp, WPb, K*f] accumulator would make
        # the tiny K*f dim minor, which tiled layouts pad — a memory
        # multiple on every link of the add chain. Merging (WPb, K*f) keeps
        # the minor dim wide and tile updates contiguous (each width-block
        # owns its full K*f channel group).
        twb = tile_w // f
        # the blend epilogue re-traverses a [M, Hp, WPb*K*f] accumulator
        # (201 MB f32 at 4096²) several times — ramp multiply, add chain,
        # inv-wsum multiply, argmax relayout — all memory-bound. On the
        # int8 path (already non-bit-exact, floors asserted) the whole
        # chain runs in bf16: the convert fuses into the head epilogue and
        # every pass moves half the bytes. The float path stays f32 for
        # bit-parity with the unbatched/unfolded paths.
        bd = jnp.dtype(blend_dtype)
        ramp_cm = jnp.broadcast_to(
            ramp.reshape(tile_h, twb, 1, f), (tile_h, twb, k, f)
        ).reshape(tile_h, twb * kf).astype(bd)
        weighted = (
            logits.reshape(n, m, tile_h, twb * kf).astype(bd)
            * ramp_cm[None, None]
        )
        acc = _accumulate_canvas(
            weighted, tile_yx, m, hp, wpb * kf, tile_h, twb * kf,
            lambda x: (x // f) * kf, bd,
        )
        import os as _os

        if reference_blend:
            # compat: gains/margins meet the raw ramp-sum accumulation —
            # no normalization pass at all (cheaper than either branch
            # below; the semantics difference IS the absence of 1/wsum)
            b4 = acc.reshape(m, hp, wpb, k, f)
            labels4 = jnp.argmax(
                b4 + gains.astype(bd)[None, None, None, :, None], axis=3
            ).astype(jnp.int32)  # [M, Hp, WPb, f]
        elif (
            not with_detection
            and quantized
            and wsum_factors is not None
            and _os.environ.get("ANNONET_NO_ARGMAX_FOLD") != "1"
        ):
            # argmax is invariant to the shared positive per-pixel
            # normalization 1/wsum: argmax_k(acc*inv + g) ==
            # argmax_k(acc + g*wsum). wsum factorizes exactly over grid
            # plans (tiling.weight_sum_factors), so the gain term enters
            # the argmax as fused 1-D broadcasts and the full-canvas
            # inv-wsum broadcast/convert/multiply passes disappear
            # (composed A/B: scripts/ab_argmax_norm.py). int8-path only:
            # skipping the normalize reorders float rounding near exact
            # ties, and the float path pins bit-parity with the
            # unbatched/unfolded reference blending.
            wy, wx = wsum_factors
            acc4 = acc.reshape(m, hp, wpb, k, f)
            gain_term = (
                gains.astype(bd)[None, None, None, :, None]
                * jnp.asarray(wy, bd)[None, :, None, None, None]
                * jnp.asarray(wx.reshape(wpb, f), bd)[None, None, :, None, :]
            )
            labels4 = jnp.argmax(acc4 + gain_term, axis=3).astype(
                jnp.int32
            )  # [M, Hp, WPb, f]
        else:
            inv_cm = jnp.broadcast_to(
                inv_wsum.reshape(hp, wpb, 1, f), (hp, wpb, k, f)
            ).reshape(hp, wpb * kf).astype(bd)
            b4 = (acc * inv_cm[None]).reshape(m, hp, wpb, k, f)
            labels4 = jnp.argmax(
                b4 + gains.astype(bd)[None, None, None, :, None], axis=3
            ).astype(jnp.int32)  # [M, Hp, WPb, f]
        out_dtype = jnp.uint8 if k <= 255 else jnp.int32
        labels = labels4.reshape(m, hp, wp)
        if not batched:
            labels = labels[0]
        if not with_detection:
            return labels.astype(out_dtype)
        clean4 = b4[:, :, :, 0, :]
        onehot4 = (
            labels4[:, :, :, None, :]
            == jnp.arange(k, dtype=jnp.int32)[None, None, None, :, None]
        )
        dlev = detection_levels.astype(bd)
        label_output = jnp.sum(
            jnp.where(onehot4, b4, jnp.zeros((), bd)), axis=3
        )
        label_level = jnp.sum(
            jnp.where(
                onehot4, dlev[None, None, None, :, None], jnp.zeros((), bd)
            ),
            axis=3,
        )
        seeds4 = (labels4 > 0) & (
            label_output - clean4 > label_level - dlev[0]
        )
        seeds = seeds4.reshape(m, hp, wp)
        if not batched:
            seeds = seeds[0]
        return labels.astype(out_dtype), seeds

    planes = []
    for c in range(k):
        weighted_c = logits[..., c] * ramp[None, None]  # [n, m, th, tw]
        acc_c = jnp.zeros((m, hp, wp), jnp.float32)
        for i, (y, x) in enumerate(tile_yx):
            acc_c = acc_c.at[:, y : y + tile_h, x : x + tile_w].add(
                weighted_c[i]
            )
        # compat mode: gains/margins meet the raw ramp-sum scale
        planes.append(acc_c if reference_blend else acc_c * inv_wsum[None])
    blended = jnp.stack(planes)  # [K, M, Hp, Wp]

    labels = jnp.argmax(
        blended + gains[:, None, None, None], axis=0
    ).astype(jnp.int32)  # [M, Hp, Wp]
    # small class counts travel as uint8: host readback is 4x lighter
    out_dtype = jnp.uint8 if k <= 255 else jnp.int32

    if not with_detection:
        labels = labels if batched else labels[0]
        return labels.astype(out_dtype)

    # detection seeds compare gain-free blended logits
    # (annonet_infer.cpp:205-211). One-hot selects instead of
    # take_along_axis/fancy indexing: compare-select fuses into the argmax
    # (same choice as ops/loss.py).
    clean_output = blended[0]
    onehot = (
        labels[None] == jnp.arange(k, dtype=jnp.int32)[:, None, None, None]
    )
    label_output = jnp.sum(jnp.where(onehot, blended, 0.0), axis=0)
    label_level = jnp.sum(
        jnp.where(onehot, detection_levels[:, None, None, None], 0.0), axis=0
    )
    seeds = (labels > 0) & (
        label_output - clean_output > label_level - detection_levels[0]
    )
    if not batched:
        labels, seeds = labels[0], seeds[0]
    return labels.astype(out_dtype), seeds


class TiledInferer:
    """Holds a runtime net and serves tiled inference on arbitrary images.

    The stateful analog of (RuntimeNet, annonet_infer_temp, tiling
    parameters) on the reference side; per-shape compiled programs are
    cached internally.
    """

    def __init__(
        self,
        runtime_params,
        config: SegNetConfig,
        tiling: Optional[TilingParameters] = None,
        forward_chunk: Optional[int] = None,
        use_folded_net: bool = True,
        quantize: Optional[str] = None,  # "int8" = quantized conv stack
        calibration_images: int = 1,
        calibration=None,  # pre-computed per-layer maxima (export/…load)
        blend_dtype: Optional[str] = None,  # None = auto (bf16 iff int8)
        # opt-in reference-blend compat (--reference-blend-semantics):
        # gains and detection-seed margins are compared against the
        # UNNORMALIZED ramp-sum accumulation, matching the reference's
        # overlap-band semantics (annonet_infer.cpp:146-161,176-185,
        # 205-211) in this framework's own tile grid, so tuned gains/
        # levels carry over from reference deployments. Identical output
        # when all gains and detection levels are zero. PARITY.md
        # "Documented behavioral deviations".
        reference_blend_semantics: bool = False,
        mesh=None,
        mesh_axis: str = "batch",
        # None = auto; an explicit list of preferred tile widths steers
        # the plan, () disables — for A/B harnesses that must pin both
        # arms to one plan
        prefer_tile_widths: Optional[Sequence[int]] = None,
        # measured plan selection: on the first image of each canvas
        # bucket, compile the default plan AND its neighbouring grid
        # counts, time each on the device, and keep the fastest
        # (docs/DESIGN.md par.22: per-shape conv rates are non-monotonic
        # in tile size, so the static heuristic can sit on a cliff for
        # canvas sizes the sweep never measured). Costs one extra XLA
        # compile per extra candidate per canvas.
        plan_autotune: bool = False,
    ):
        self.params = jax.tree_util.tree_map(jnp.asarray, runtime_params)
        self.config = config
        self.use_folded_net = use_folded_net
        if quantize not in (None, "int8"):
            raise ValueError(f"unsupported quantize mode: {quantize!r}")
        if quantize and not use_folded_net:
            raise ValueError("quantize requires the folded net")
        # int8 applies once the first `calibration_images` images have
        # calibrated the activation scales (models/quantized_runtime.py):
        # per-channel maxima accumulate across those images, images seen
        # before the freeze run the exact bf16 path, and everything after
        # runs int8. The default 1 calibrates on (and quantizes from) the
        # first image alone — representative first images are assumed;
        # raise calibration_images for mixed-exposure directories. Geometry
        # that can't fold (fold0 == 0) falls back to the bf16 path per plan.
        self.quantize = quantize
        if calibration_images < 1:
            raise ValueError("calibration_images must be >= 1")
        self.calibration_images = calibration_images
        # blend accumulation dtype: the int8 path defaults to bf16 (every
        # pass over the memory-bound blend accumulator moves half the
        # bytes, DESIGN.md §15); the float path stays f32
        # for bit-parity. Override with "float32"/"bfloat16" to pin either.
        if blend_dtype is None:
            blend_dtype = "bfloat16" if quantize else "float32"
        self.blend_dtype = jnp.dtype(blend_dtype)
        self.reference_blend_semantics = bool(reference_blend_semantics)
        if self.blend_dtype not in (
            jnp.dtype(jnp.float32), jnp.dtype(jnp.bfloat16)
        ):
            raise ValueError(f"unsupported blend_dtype: {blend_dtype!r}")
        self._quantized_cache: Dict[int, Tuple] = {}
        self._calibrate_fns: Dict[Tuple, object] = {}
        self._calib_accum: Dict[int, list] = {}
        self._calib_seen: Dict[int, int] = {}
        self._calib_frozen: Dict[int, list] = {}
        # pre-computed calibration (serialization.load_calibration or
        # export_calibration): per-REAL-channel activation maxima are
        # fold-agnostic, so a loaded set freezes the int8 net immediately
        # for ANY tile plan — every image (including the first) runs int8
        # and deployments are reproducible across restarts
        if calibration is not None and quantize is None:
            raise ValueError("calibration requires quantize='int8'")
        self._preloaded_calib = (
            [np.asarray(v, np.float32) for v in calibration]
            if calibration is not None else None
        )
        self._folded_cache: Dict[int, Tuple] = {}
        if tiling is None:
            # the same tile default as the CLIs (tiling.default_tile_max)
            from annonet_jax.infer.tiling import default_tile_max

            tile_max = default_tile_max()
            overlap = required_input_dimension(config)
            tiling = TilingParameters(tile_max, tile_max, overlap, overlap)
        if tiling.overlap_x < 0 or tiling.overlap_y < 0:
            raise ValueError("tile overlap must be non-negative")
        self.tiling = tiling
        # None = auto: forward the whole tile batch in one XLA call unless
        # the activation estimate exceeds the device-memory budget
        # (activation_budget_bytes; a chunked lax.map runs the convs at a
        # smaller batch)
        self.forward_chunk = forward_chunk
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        # stem y-tap-concat rewrite (quantized_runtime.ycat_stem_qspec):
        # bit-exact, opt-in pending the composed device A/B
        # (scripts/ab_stem_ycat.py). Read once — program identity.
        import os as _os

        self.stem_ycat = (
            _os.environ.get("ANNONET_STEM_YCAT") == "1"
            and self.quantize == "int8"
        )
        self._ycat_cache: Dict[int, Tuple] = {}
        self._prefer_tile_widths = prefer_tile_widths
        self._compiled: Dict[Tuple, object] = {}
        self._plan_constants: Dict[TilePlan, Tuple] = {}
        self.plan_autotune = plan_autotune
        # canvas bucket (h, w) -> chosen TilePlan, and the measurement
        # record behind each choice: [(plan, Mpx/s), ...] fastest-first
        self._autotune_cache: Dict[Tuple[int, int], TilePlan] = {}
        self.autotune_reports: Dict[Tuple[int, int], list] = {}
        self._plan_override: Optional[TilePlan] = None
        self._autotuning = False
        self._calibration_paused = False

    def update_params(self, runtime_params) -> None:
        """Swap in a new parameter set of the SAME architecture, keeping
        every compiled program.

        Parameters are traced call arguments and the program cache is
        keyed on geometry only, so every ALREADY-COMPILED program is
        reused as-is — checkpoint-over-checkpoint evaluation
        (annonet_train --validation-directory) and embedder hot weight
        swaps recompile nothing they have run before. Param-derived
        caches are dropped: the folded/int8 kernels rebuild on the host
        (cheap), int8 activation calibration restarts exactly like a
        fresh inferer, and any preloaded calibration is discarded — it is
        fingerprinted to the old weights (serialization.save_calibration);
        construct a new inferer to pin one for new weights. Caveat for
        int8-with-preloaded-calibration inferers: the post-swap
        recalibration may compile programs the preloaded path never
        needed (the calibration collector, and the bf16 fallback when
        calibration_images > 1) — those are first-time compiles, not
        recompiles.
        """
        prior_folds = list(self._folded_cache.keys())
        self.params = jax.tree_util.tree_map(jnp.asarray, runtime_params)
        self._folded_cache.clear()
        self._quantized_cache.clear()
        self._ycat_cache.clear()
        self._calib_accum.clear()
        self._calib_seen.clear()
        self._calib_frozen.clear()
        self._preloaded_calib = None
        # eagerly rebuild the folded variants that were in use, so the
        # first call after a hot swap doesn't pay the host fold + param
        # upload on the request path (the int8 quantization is
        # calibration-dependent and rebuilds on the next image as
        # documented)
        for fold0 in prior_folds:
            self._get_folded(fold0)

    # ------------------------------------------------------------- planning

    def plan(self, image_height: int, image_width: int) -> TilePlan:
        if self._plan_override is not None:
            return self._plan_override
        if self.plan_autotune:
            chosen = self._autotune_cache.get(
                (
                    bucket_dim(image_height, _CANVAS_BUCKET),
                    bucket_dim(image_width, _CANVAS_BUCKET),
                )
            )
            if chosen is not None:
                return chosen
        lane_align = True
        prefer_widths = None
        if self.use_folded_net:
            from annonet_jax.models.folded_runtime import folding_supported

            # under the folded net the lane dim is the folded channels, so
            # tiles only need to divide the fold — skipping the 128 round-up
            # trims ~5% redundant tile pixels
            fold = folding_supported(self.config, 8 * 128)
            lane_align = not fold
        if self._prefer_tile_widths is not None:
            prefer_widths = list(self._prefer_tile_widths) or None
        plan = plan_tiles(
            image_height,
            image_width,
            self.config,
            self.tiling,
            canvas_bucket=_CANVAS_BUCKET,
            lane_align_tiles=lane_align,
            prefer_tile_widths=prefer_widths,
        )
        if not lane_align and prefer_widths is None:
            # count-cliff bump (docs/DESIGN.md par.24-25): a grid with
            # exactly 3 tiles on an axis is replaced by 4 smaller tiles
            # (the user's max-tile cap still holds, at a few per cent more
            # overlap area). A heuristic from earlier measurements; the
            # plan sweep (scripts/sweep_tile_plans.py) re-checks it.
            ny = len({y for y, _ in plan.tile_yx})
            nx = len({x for _, x in plan.tile_yx})
            if ny == 3 or nx == 3:
                bumped = plan_for_counts(
                    image_height, image_width, self.config, self.tiling,
                    4 if ny == 3 else ny, 4 if nx == 3 else nx,
                    canvas_bucket=_CANVAS_BUCKET,
                    lane_align_tiles=lane_align,
                )
                if bumped is not None:
                    plan = bumped
        return plan

    def _autotune_for(self, image2d: np.ndarray) -> None:
        """Measure the default plan and its neighbouring grid counts for
        this canvas on the device; cache the fastest for every later image
        in the bucket.

        Why measured: per-shape conv rates are non-monotonic in tile size
        (docs/DESIGN.md par.22), so for canvas sizes the static default was
        never measured on, the only robust selector is the composed
        program itself. Candidates are the default plan plus denser grids
        (count+1, count+2 per axis) — the max-tile flags stay a hard cap,
        so only SMALLER tiles are explored. Each candidate is timed with
        jax.block_until_ready around ``ANNONET_AUTOTUNE_ITERS`` calls on
        the same uploaded image. The int8
        path's calibration (if not yet frozen) happens during the first
        candidate's warm-up, so all timed loops run the production
        execution path.
        """
        import os as _os
        import time as _time

        h, w = image2d.shape[:2]
        key = (bucket_dim(h, _CANVAS_BUCKET), bucket_dim(w, _CANVAS_BUCKET))
        if key in self._autotune_cache:
            return
        default = self.plan(h, w)
        ny = len({y for y, _ in default.tile_yx})
        nx = len({x for _, x in default.tile_yx})
        candidates = [default]
        lane_align = True
        if self.use_folded_net:
            from annonet_jax.models.folded_runtime import folding_supported

            lane_align = not folding_supported(self.config, 8 * 128)
        for dy, dx in ((1, 1), (2, 2)):
            p = plan_for_counts(
                h, w, self.config, self.tiling, ny + dy, nx + dx,
                canvas_bucket=_CANVAS_BUCKET, lane_align_tiles=lane_align,
            )
            if p is not None and p not in candidates:
                candidates.append(p)
        if len(candidates) == 1:
            self._autotune_cache[key] = default
            self.autotune_reports[key] = [(default, 0.0)]
            return
        # pre-pad once and upload once: the timed loop must not move
        # pixels host->device per iteration
        h_b, w_b = key
        padded = np.pad(
            image2d, ((0, h_b - h), (0, w_b - w), (0, 0)), mode="edge"
        )
        img_dev = jax.block_until_ready(jnp.asarray(padded))
        iters = max(
            1, int(_os.environ.get("ANNONET_AUTOTUNE_ITERS", "3"))
        )
        results = []
        self._autotuning = True
        try:
            for p in candidates:
                self._plan_override = p
                try:
                    # warm-up with the HOST array: compiles the program and
                    # (first candidate, int8 path) runs calibration, whose
                    # walkers expect host pixels
                    jax.block_until_ready(
                        self._infer(padded, False, None, None, True)
                    )
                    t0 = _time.perf_counter()
                    for _ in range(iters):
                        labels, _ = self._infer(
                            img_dev, False, None, None, True
                        )
                    jax.block_until_ready(labels)
                    elapsed = max(1e-9, _time.perf_counter() - t0)
                finally:
                    self._plan_override = None
                results.append((h * w * iters / 1e6 / elapsed, p))
        finally:
            self._autotuning = False
        results.sort(key=lambda t: -t[0])
        self._autotune_cache[key] = results[0][1]
        self.autotune_reports[key] = [(p, r) for r, p in results]

    def _get_compiled(
        self, plan: TilePlan, with_detection: bool, image_batch: int = 0
    ):
        # image_batch 0 = the unbatched [H,W,C] entry; M >= 1 = the batched
        # [M,H,W,C] entry (infer_arrays_batch) — distinct compiled programs
        # the tile layout is a pure function of the canvas/tile geometry, so
        # positions are compile-time constants; the key deliberately
        # excludes the raw image size — inputs arrive bucket-padded, so all
        # images sharing a bucket share one compiled program
        fold0 = 0
        if self.use_folded_net:
            from annonet_jax.models.folded_runtime import folding_supported

            fold0 = folding_supported(self.config, plan.tile_width)
        # int8 only once calibration has frozen (the first
        # calibration_images images run the exact bf16 program)
        quantized = (
            bool(self.quantize)
            and fold0 > 0
            and fold0 in self._quantized_cache
        )
        key = (
            plan.padded_height,
            plan.padded_width,
            plan.tile_height,
            plan.tile_width,
            plan.tile_yx,
            with_detection,
            fold0,
            quantized,
            image_batch,
            str(self.blend_dtype),
            self.reference_blend_semantics,
        )
        fn = self._compiled.get(key)
        if fn is None:
            n = plan.tile_count * max(1, image_batch)
            if self.forward_chunk is not None:
                chunk = max(1, self.forward_chunk)
            else:
                # ~bytes of live activations per tile pixel at the stem
                # width (bf16, generous multiplier for skips/temporaries)
                per_px = max(1, self.config.width(0)) * 16
                budget = activation_budget_bytes(self._device())
                max_tiles = max(
                    1, budget // (per_px * plan.tile_height * plan.tile_width)
                )
                chunk = min(n, max_tiles)
            while n % chunk:
                chunk -= 1
            folded = None
            if quantized:
                # calibration must already have run (infer_arrays does)
                qspec, _qarrays = self._get_quantized(fold0)
                folded = (fold0, qspec)
            elif fold0:
                folded = self._get_folded(fold0)[0]
            # opt_jit == jax.jit unless ANNONET_COMPILER_OPTIONS is set
            # (per-program compiler options, utils/compile_opts.py)
            fn = opt_jit(
                partial(
                    _tiled_forward,
                    config=self.config,
                    padded_h=plan.padded_height,
                    padded_w=plan.padded_width,
                    tile_yx=plan.tile_yx,
                    tile_h=plan.tile_height,
                    tile_w=plan.tile_width,
                    forward_chunk=chunk,
                    with_detection=with_detection,
                    folded=folded,
                    quantized=quantized,
                    wsum_factors=weight_sum_factors(plan),
                    blend_dtype=self.blend_dtype,
                    mesh=self.mesh,
                    mesh_axis=self.mesh_axis,
                    reference_blend=self.reference_blend_semantics,
                )
            )
            self._compiled[key] = fn
        return fn, fold0, quantized

    def _get_quantized(self, fold0: int):
        """The (qspec, qarrays) to EXECUTE: the int8 net, with the stem
        y-cat rewrite applied when that knob is on (cached)."""
        plain = self._quantized_cache[fold0]
        if not self.stem_ycat:
            return plain
        cached = self._ycat_cache.get(fold0)
        if cached is None:
            from annonet_jax.models.quantized_runtime import ycat_stem_qspec

            cached = ycat_stem_qspec(*plain)
            self._ycat_cache[fold0] = cached
        return cached

    def _get_folded(self, fold0: int):
        """(static (fold0, spec), device array tuple) for the folded net."""
        cached = self._folded_cache.get(fold0)
        if cached is None:
            from annonet_jax.models.folded_runtime import (
                fold_runtime_params,
                split_folded,
            )

            fparams = fold_runtime_params(self.params, self.config, fold0)
            cached = split_folded(fparams)
            self._folded_cache[fold0] = cached
        return cached

    def _device(self):
        """The device this inferer's programs run on (the mesh's first
        device under tile parallelism)."""
        if self.mesh is not None:
            return self.mesh.devices.flat[0]
        return jax.devices()[0]

    def _collect_calib(self, fold0: int, plan: TilePlan, padded_image):
        """Per-REAL-channel post-ReLU activation maxima of one image: up to
        4 tiles spread across the plan, through the bf16 folded net
        (models/quantized_runtime.py::collect_calibration)."""
        (f0, spec), arrays = self._get_folded(fold0)
        positions = list(plan.tile_yx)
        if len(positions) > 4:
            # spread the picks across the whole plan (first/last included),
            # not just its top rows — activation maxima must see the image
            idx = np.linspace(0, len(positions) - 1, 4).round().astype(int)
            positions = [positions[i] for i in dict.fromkeys(idx)]
        tiles = np.stack(
            [
                padded_image[y : y + plan.tile_height, x : x + plan.tile_width]
                for (y, x) in positions
            ]
        )
        cal_key = (fold0, tiles.shape)
        cal_fn = self._calibrate_fns.get(cal_key)
        if cal_fn is None:
            from annonet_jax.models.quantized_runtime import (
                collect_calibration,
            )

            cal_fn = jax.jit(
                partial(
                    collect_calibration,
                    config=self.config,
                    fold0=f0,
                    spec=spec,
                )
            )
            self._calibrate_fns[cal_key] = cal_fn
        return [np.asarray(m) for m in cal_fn(arrays, jnp.asarray(tiles))]

    def _ensure_quantized(self, fold0: int, plan: TilePlan, padded_image):
        """Accumulate one image's calibration maxima; freeze the int8 net
        once ``calibration_images`` images have contributed.

        The reference's own timing treats the first image as warm-up
        (annonet_infer_main.cpp:466-480); calibration rides that slot.
        Images seen before the freeze run the exact bf16 program, so
        raising calibration_images trades a few float-path images for
        scales that have seen the directory's exposure range.
        """
        if fold0 in self._quantized_cache:
            return
        if self._preloaded_calib is not None:
            from annonet_jax.models.quantized_runtime import quantize_folded

            (f0, spec), arrays = self._get_folded(fold0)
            expected = len(spec)
            if len(self._preloaded_calib) != expected:
                raise ValueError(
                    f"calibration has {len(self._preloaded_calib)} layer "
                    f"vectors, model expects {expected} (wrong model?)"
                )
            self._calib_frozen[fold0] = self._preloaded_calib
            self._quantized_cache[fold0] = quantize_folded(
                spec, arrays, self._preloaded_calib, self.config, f0
            )
            return
        calib = self._collect_calib(fold0, plan, padded_image)
        accum = self._calib_accum.get(fold0)
        if accum is None:
            accum = calib
        else:
            accum = [np.maximum(a, c) for a, c in zip(accum, calib)]
        self._calib_accum[fold0] = accum
        self._calib_seen[fold0] = self._calib_seen.get(fold0, 0) + 1
        if self._calib_seen[fold0] < self.calibration_images:
            return
        from annonet_jax.models.quantized_runtime import quantize_folded

        (f0, spec), arrays = self._get_folded(fold0)
        self._calib_frozen[fold0] = accum
        self._quantized_cache[fold0] = quantize_folded(
            spec, arrays, accum, self.config, f0
        )

    def export_calibration(self, partial: bool = False):
        """The frozen per-layer, per-REAL-channel activation maxima, or
        None if no int8 net has been frozen yet (run at least
        ``calibration_images`` images first). Fold-agnostic: persist with
        serialization.save_calibration and pass back as
        ``TiledInferer(..., calibration=...)`` to skip runtime
        calibration entirely (reproducible deployments; the first image
        then runs int8 too).

        ``partial=True`` also includes accumulations that have not yet
        reached ``calibration_images`` (more images only widen the
        maxima, never narrow them) — used by multi-host
        ``--save-calibration``, where a rank's shard can be smaller than
        the calibration-image budget but its activations should still
        contribute to the cluster-merged file."""
        sources = list(self._calib_frozen.values())
        if partial:
            # _calib_frozen aliases the accumulator at freeze time, so
            # double inclusion is a no-op under the element-wise max
            sources.extend(self._calib_accum.values())
        if not sources:
            return None
        # maxima are per-REAL-channel, so when several tile plans froze
        # different fold0 nets (mixed image sizes in one run), the
        # order-independent union is the element-wise max across folds
        merged = None
        for frozen in sources:
            vecs = [np.asarray(v, np.float32) for v in frozen]
            merged = vecs if merged is None else [
                np.maximum(a, b) for a, b in zip(merged, vecs)
            ]
        return merged

    def calibration_layer_shapes(self):
        """Per-layer lengths of the export_calibration vectors — an
        architecture property (per-REAL-channel, fold-agnostic), computed
        WITHOUT inferring any image, or None when this config cannot fold
        (folded_runtime.folding_supported == 0, so int8 never applies).

        Multi-host ``--save-calibration`` uses this so a rank whose image
        shard produced no calibration data can still participate in the
        fixed-shape maxima allgather with max-identity zeros (post-ReLU
        maxima are nonnegative)."""
        from annonet_jax.models.folded_runtime import folding_supported
        from annonet_jax.models.quantized_runtime import collect_calibration

        if self._calib_accum or self._calib_frozen:
            fold0 = next(iter(self._calib_accum or self._calib_frozen))
        else:
            # any valid fold works — the vectors are per-REAL-channel
            fold0 = folding_supported(self.config, 64)
            if fold0 == 0:
                return None
        (f0, spec), arrays = self._get_folded(fold0)
        dummy = jax.ShapeDtypeStruct(
            (1, 64, 64, self.config.in_channels), jnp.uint8
        )
        shapes = jax.eval_shape(
            lambda a, x: collect_calibration(
                a, x, self.config, fold0=f0, spec=spec
            ),
            arrays, dummy,
        )
        return [int(s.shape[0]) for s in shapes]

    def pause_calibration(self):
        """Context manager: images inferred inside do NOT contribute to
        (or freeze) int8 activation calibration — they run the exact bf16
        path if quantization is not yet frozen, int8 as usual if it is.

        For synthetic traffic that must not poison the scales: e.g.
        annonet_serve's flat mid-gray --warmup image would otherwise
        freeze calibration on a constant image and silently clip every
        real request's activations (the reference has no analog — its
        engine has no calibration state to protect).
        """
        import contextlib

        @contextlib.contextmanager
        def _pause():
            prev = self._calibration_paused
            self._calibration_paused = True
            try:
                yield self
            finally:
                self._calibration_paused = prev

        return _pause()

    def calibration_overshoot(self, image: np.ndarray) -> float:
        """Clip-saturation telemetry: how far ``image``'s activations
        exceed the frozen int8 calibration range.

        Returns the max over layers/channels of
        (this image's activation max) / (calibrated max) — 1.0 means the
        image fits the calibrated range exactly; e.g. 2.0 means some
        channel's activations reach double the calibrated maximum and are
        clipped to half their range by the int8 requant. Use it to detect
        distribution shift (an unrepresentative calibration set). Returns
        0.0 when no quantized net has been frozen yet.
        """
        if not self._calib_frozen:
            return 0.0
        h, w = image.shape[:2]
        plan = self.plan(h, w)
        from annonet_jax.models.folded_runtime import folding_supported

        fold0 = folding_supported(self.config, plan.tile_width)
        frozen = self._calib_frozen.get(fold0)
        if frozen is None:
            return 0.0
        full = np.pad(
            image,
            (
                (0, plan.padded_height - h),
                (0, plan.padded_width - w),
                (0, 0),
            ),
            mode="edge",
        )
        calib = self._collect_calib(fold0, plan, full)
        worst = 0.0
        for cal, frz in zip(calib, frozen):
            if cal.size == 0 or frz.size == 0:
                continue
            mask = frz > 0
            if mask.any():
                worst = max(worst, float((cal[mask] / frz[mask]).max()))
        return worst

    # ------------------------------------------------------------- inference

    def infer_arrays(
        self,
        image: np.ndarray,  # (H, W, C) uint8
        gains: Optional[Sequence[float]] = None,
        detection_levels: Optional[Sequence[float]] = None,
        device_output: bool = False,
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Raw device pass: returns (labels [H,W], seeds [H,W] or None).

        Seeds are produced only when any detection level is positive. With
        ``device_output=True`` the (padded) results stay on device — for
        benchmarking and pipelines that keep consuming on-device.
        """
        if image.ndim != 3 or image.shape[2] != self.config.in_channels:
            raise ValueError(
                f"expected (H, W, {self.config.in_channels}) input, got {image.shape}"
            )
        return self._infer(
            image, False, gains, detection_levels, device_output
        )

    def infer_arrays_batch(
        self,
        images: np.ndarray,  # (M, H, W, C) uint8, same-size images
        gains: Optional[Sequence[float]] = None,
        detection_levels: Optional[Sequence[float]] = None,
        device_output: bool = False,
        pad_to_bucket=True,  # True | False | int target size
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Batched pass over M same-size images: (labels [M,H,W], seeds).

        One plan, one device program: all M images' tiles forward as a
        single M*T batch. This is the throughput path for directories of
        small same-size images — a single 512² image is a batch-1 forward
        while the same image inside a batch rides the full tile batch.
        Per-image results equal infer_arrays exactly.

        ``pad_to_bucket`` controls the compile-vs-padded-compute trade:
        True (default) buckets M UP to the next power of two by
        replicating the last image (results sliced back) so odd batches
        reuse compiled programs instead of paying a fresh XLA compile
        each — the same trade the canvas bucketing makes for
        H/W. False compiles an exact-M program: right for a batch size
        the caller uses REPEATEDLY (every full --image-batch group).
        An int pads M up to exactly that size — right for a one-off
        remainder batch when a program of that size already exists
        (the CLI's final group pads to the full-group size rather than
        compiling a fresh power-of-two program)."""
        if images.ndim != 4 or images.shape[3] != self.config.in_channels:
            raise ValueError(
                f"expected (M, H, W, {self.config.in_channels}) input, "
                f"got {images.shape}"
            )
        m = images.shape[0]
        if m < 1:
            raise ValueError("image batch must contain at least one image")
        if pad_to_bucket is True:
            m_b = 1 << (m - 1).bit_length()
        elif pad_to_bucket is False:
            m_b = m
        else:
            m_b = int(pad_to_bucket)
            if m_b < m:
                raise ValueError(
                    f"pad_to_bucket target {m_b} is below the batch size {m}"
                )
        if m_b != m:
            images = np.concatenate(
                [images, np.repeat(images[-1:], m_b - m, axis=0)]
            )
        labels, seeds = self._infer(
            images, True, gains, detection_levels, device_output
        )
        if m_b != m:
            labels = labels[:m]
            seeds = None if seeds is None else seeds[:m]
        return labels, seeds

    def _infer(
        self,
        image: np.ndarray,
        batched: bool,
        gains,
        detection_levels,
        device_output: bool,
    ):
        h, w = image.shape[-3:-1]
        k = self.config.class_count
        gains_arr = np.zeros(k, np.float32) if gains is None else np.asarray(
            gains, np.float32
        )
        det_arr = (
            np.zeros(k, np.float32)
            if detection_levels is None
            else np.asarray(detection_levels, np.float32)
        )
        if gains_arr.shape != (k,) or det_arr.shape != (k,):
            raise ValueError(f"gains/detection levels must have length {k}")

        with_detection = bool((det_arr > 0.0).any())

        if (
            self.plan_autotune
            and not self._autotuning
            and self._plan_override is None
        ):
            # first image of a canvas bucket: measure candidate plans now
            # (one np.asarray: a device-resident input is pulled back once)
            self._autotune_for(np.asarray(image[0] if batched else image))

        plan = self.plan(h, w)
        # host-side replicate pad up to the canvas bucket (<= bucket-1 rows/
        # cols); the device pads the remainder for the small-image case.
        # All images in a bucket then trace with the same input shape.
        h_b = min(bucket_dim(h, _CANVAS_BUCKET), plan.padded_height)
        w_b = min(bucket_dim(w, _CANVAS_BUCKET), plan.padded_width)
        if (h_b, w_b) != (h, w):
            lead = ((0, 0),) if batched else ()
            widths = lead + ((0, h_b - h), (0, w_b - w), (0, 0))
            if isinstance(image, jax.Array):
                # a device-resident input must be padded ON DEVICE —
                # np.pad would silently round-trip the pixels through the
                # host
                image = jnp.pad(image, widths, mode="edge")
            else:
                image = np.pad(image, widths, mode="edge")
        constants = self._plan_constants.get(plan)
        if constants is None:
            ramp = jnp.asarray(
                ramp_weights(
                    plan.tile_height,
                    plan.tile_width,
                    plan.overlap_y,
                    plan.overlap_x,
                )
            )
            inv_wsum = jnp.asarray(inverse_weight_sum(plan))
            constants = (ramp, inv_wsum)
            self._plan_constants[plan] = constants
        ramp, inv_wsum = constants

        if self.quantize:
            from annonet_jax.models.folded_runtime import folding_supported

            q_fold0 = folding_supported(self.config, plan.tile_width)
            if (
                q_fold0
                and q_fold0 not in self._quantized_cache
                and not self._calibration_paused
            ):
                # each not-yet-frozen call contributes one image (or, when
                # batched, as many of the batch as calibration still needs)
                candidates = image if batched else image[None]
                for one in candidates:
                    full = np.pad(
                        one,
                        (
                            (0, plan.padded_height - one.shape[0]),
                            (0, plan.padded_width - one.shape[1]),
                            (0, 0),
                        ),
                        mode="edge",
                    )
                    self._ensure_quantized(q_fold0, plan, full)
                    if q_fold0 in self._quantized_cache:
                        break

        fn, fold0, quantized = self._get_compiled(
            plan, with_detection,
            image_batch=image.shape[0] if batched else 0,
        )
        if quantized:
            exec_params = self._get_quantized(fold0)[1]
        else:
            exec_params = (
                self._get_folded(fold0)[1] if fold0 else self.params
            )
        out = fn(
            exec_params,
            jnp.asarray(image),
            jnp.asarray(gains_arr),
            jnp.asarray(det_arr),
            ramp,
            inv_wsum,
        )
        labels, seeds = out if with_detection else (out, None)
        if device_output:
            return labels, seeds
        crop = (slice(None), slice(0, h), slice(0, w)) if batched else (
            slice(0, h), slice(0, w)
        )
        labels = np.asarray(labels)[crop].astype(np.int32)
        if seeds is not None:
            seeds = np.asarray(seeds)[crop]
        return labels, seeds


def annonet_infer(
    inferer: TiledInferer,
    input_image: np.ndarray,  # (H, W, C) uint8
    gains: Optional[Sequence[float]] = None,
    detection_levels: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Full inference for one image: (H, W) uint16 label map.

    Parity with annonet_infer (annonet_infer.cpp:32-240) including the
    detection-level pass: when any detection level is positive, connected
    non-background blobs of the argmax map that contain no seed pixel are
    reset to background (:217-238).
    """
    labels, seeds = inferer.infer_arrays(input_image, gains, detection_levels)
    return detection_veto(labels, seeds)


def annonet_infer_batch(
    inferer: TiledInferer,
    input_images: np.ndarray,  # (M, H, W, C) uint8, same-size images
    gains: Optional[Sequence[float]] = None,
    detection_levels: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Full inference for M same-size images: (M, H, W) uint16 label maps.

    One device program serves all M images (TiledInferer.infer_arrays_batch)
    — the throughput path for directories of small same-size images.
    Per-image
    results equal annonet_infer exactly; the blob veto runs per image.
    """
    labels, seeds = inferer.infer_arrays_batch(
        input_images, gains, detection_levels
    )
    return np.stack(
        [
            detection_veto(
                labels[i], None if seeds is None else seeds[i]
            )
            for i in range(labels.shape[0])
        ]
    )


def detection_veto(labels: np.ndarray, seeds: Optional[np.ndarray]) -> np.ndarray:
    """Host post-pass: reset non-background blobs without a detection seed
    (annonet_infer.cpp:217-238). No-op when seeds is None (no detection
    levels active). Returns the final uint16 label map."""
    if seeds is not None:
        blobs, _count = label_connected_blobs(labels, zero_is_background=True)
        detected = np.unique(blobs[seeds]) if seeds.any() else np.empty(0, np.int32)
        keep = np.isin(blobs, detected)
        labels = np.where((blobs > 0) & ~keep, 0, labels)
    return labels.astype(np.uint16)
