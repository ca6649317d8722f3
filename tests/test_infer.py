"""Tiled-inference and evaluation tests, including the tiling golden test the
reference lacks (SURVEY.md §4): multi-tile output must match single-tile
output away from blend regions."""

import numpy as np
import jax
import pytest

from annonet_jax.classes import IGNORE_LABEL, default_anno_classes
from annonet_jax.infer.core import TiledInferer, annonet_infer
from annonet_jax.infer.evaluation import (
    format_confusion_matrix,
    new_confusion_matrix,
    update_confusion_matrix_per_pixel,
    update_confusion_matrix_per_region,
)
from annonet_jax.infer.tiling import TilingParameters, plan_tiles, ramp_weights
from annonet_jax.models.segnet import (
    SegNetConfig,
    fold_batchnorm,
    init_state,
    required_input_dimension,
)


def small_config(**kw):
    defaults = dict(
        class_count=3, level_count=1, base_width=4, compute_dtype="float32"
    )
    defaults.update(kw)
    return SegNetConfig(**defaults)


def runtime_net(config, seed=0):
    params, stats = init_state(jax.random.PRNGKey(seed), config)
    return fold_batchnorm(params, stats, config)


# ---------------------------------------------------------------- tiling


def test_plan_single_tile_small_image():
    config = small_config()
    plan = plan_tiles(20, 30, config, TilingParameters(64, 64, 4, 4))
    assert plan.tile_count == 1
    assert plan.tile_yx == ((0, 0),)
    # canvas holds the whole image and is stride-aligned
    assert plan.padded_width >= 30 and plan.padded_height >= 20
    assert plan.tile_width % 2**config.level_count == 0


def test_plan_grid_covers_image_with_overlap():
    config = small_config()
    params = TilingParameters(
        max_tile_width=32, max_tile_height=32, overlap_x=8, overlap_y=8
    )
    plan = plan_tiles(100, 70, config, params)
    assert plan.tile_count > 1
    covered = np.zeros((plan.padded_height, plan.padded_width), bool)
    for y, x in plan.tile_yx:
        assert 0 <= y <= plan.padded_height - plan.tile_height
        assert 0 <= x <= plan.padded_width - plan.tile_width
        covered[y : y + plan.tile_height, x : x + plan.tile_width] = True
    assert covered.all()
    # adjacent tiles overlap at least the requested amount
    xs = sorted({x for _, x in plan.tile_yx})
    for a, b in zip(xs, xs[1:]):
        assert b - a <= plan.tile_width - params.overlap_x


def test_weight_sum_factors_exact_factorization():
    # wsum(y,x) = wy(y)*wx(x) exactly for grid plans: the separable-gain
    # argmax fold (infer/core.py) relies on it
    from annonet_jax.infer.tiling import inverse_weight_sum, weight_sum_factors

    config = small_config()
    for (h, w, mt) in ((100, 70, 32), (20, 30, 64), (96, 200, 48)):
        plan = plan_tiles(h, w, config, TilingParameters(mt, mt, 8, 8))
        factors = weight_sum_factors(plan)
        assert factors is not None
        wy, wx = factors
        assert wy.shape == (plan.padded_height,)
        assert wx.shape == (plan.padded_width,)
        np.testing.assert_allclose(
            wy[:, None] * wx[None, :],
            1.0 / inverse_weight_sum(plan),
            rtol=1e-5,
        )
    # a non-grid layout is refused, not mis-factored
    import dataclasses

    assert plan.tile_count > 1
    broken = dataclasses.replace(plan, tile_yx=plan.tile_yx[:-1])
    assert weight_sum_factors(broken) is None


def test_int8_argmax_fold_matches_normalize_path():
    # the folded-gain argmax (skip inv-wsum normalize when detection is
    # off) must agree with the normalizing path, including NONZERO gains
    import os

    config = small_config()
    params = runtime_net(config)
    rng = np.random.default_rng(11)
    image = rng.integers(0, 256, size=(96, 96, 3), dtype=np.uint8)
    tiling = TilingParameters(64, 64, 8, 8)
    gains = [0.0, 0.7, -0.3]

    outs = {}
    for name, env in (("normalize", "1"), ("folded-gain", "")):
        os.environ["ANNONET_NO_ARGMAX_FOLD"] = env
        try:
            inf = TiledInferer(params, config, tiling, quantize="int8")
            inf.infer_arrays(image)  # calibration pass (bf16 program)
            labels, _ = inf.infer_arrays(image, gains=gains)
        finally:
            os.environ.pop("ANNONET_NO_ARGMAX_FOLD", None)
        outs[name] = labels
    agree = (outs["normalize"] == outs["folded-gain"]).mean()
    assert agree > 0.999, f"only {agree:.5f} agreement"


def test_ramp_weights_partition_of_unity():
    t, ov = 32, 8
    ramp = ramp_weights(t, t, ov, ov)
    stride = t - ov
    # two adjacent tiles: ramps sum to exactly 1 across the overlap band
    total = np.zeros(t + stride, np.float64)
    total[:t] += ramp[t // 2]  # a middle row (1.0 in y)
    total[stride:] += ramp[t // 2]
    interior = total[ov : t + stride - ov]
    np.testing.assert_allclose(interior, 1.0, rtol=1e-6)


# ---------------------------------------------------------------- inference


def test_single_vs_multi_tile_interior_match():
    config = small_config()
    params = runtime_net(config)
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, size=(96, 96, 3), dtype=np.uint8)

    overlap = required_input_dimension(config)
    single = TiledInferer(
        params,
        config,
        TilingParameters(128, 128, overlap, overlap),
    )
    multi = TiledInferer(
        params,
        config,
        TilingParameters(64, 64, overlap, overlap),
    )
    labels_single = annonet_infer(single, image)
    labels_multi = annonet_infer(multi, image)
    assert labels_single.shape == (96, 96)
    # overall agreement must be near-total; blend bands may flip rare
    # near-tie pixels
    agree = (labels_single == labels_multi).mean()
    assert agree > 0.99, f"only {agree:.4f} agreement between tilings"


def test_gains_shift_argmax():
    config = small_config()
    params = runtime_net(config)
    image = np.full((32, 32, 3), 128, dtype=np.uint8)
    inferer = TiledInferer(params, config)
    base = annonet_infer(inferer, image)
    # huge gain on class 2 must win every pixel
    boosted = annonet_infer(inferer, image, gains=[0.0, 0.0, 1e6])
    assert (boosted == 2).all()
    assert base.shape == boosted.shape


def test_detection_level_blob_veto():
    config = small_config()
    params = runtime_net(config)
    image = np.full((32, 32, 3), 128, dtype=np.uint8)
    inferer = TiledInferer(params, config)
    # raise class 1 everywhere via gain, then demand an enormous detection
    # margin: every blob lacks seeds and is reset to background
    labels = annonet_infer(
        inferer,
        image,
        gains=[0.0, 1e6, 0.0],
        detection_levels=[0.0, 1e9, 0.0],
    )
    assert (labels == 0).all()


def test_grayscale_inference():
    config = small_config(grayscale=True)
    params = runtime_net(config)
    image = np.random.default_rng(1).integers(
        0, 256, size=(40, 40, 1), dtype=np.uint8
    )
    inferer = TiledInferer(params, config)
    labels = annonet_infer(inferer, image)
    assert labels.shape == (40, 40)


def test_infer_rejects_wrong_channels():
    config = small_config()
    inferer = TiledInferer(runtime_net(config), config)
    with pytest.raises(ValueError):
        inferer.infer_arrays(np.zeros((16, 16, 1), np.uint8))


# ---------------------------------------------------------------- evaluation


def test_confusion_matrix_per_pixel():
    cm = new_confusion_matrix(3)
    points = {
        0: np.array([[0, 0], [1, 0]]),  # (x, y)
        1: np.array([[2, 2]]),
    }
    result = np.zeros((3, 3), dtype=np.uint16)
    result[2, 2] = 1  # correct for class 1
    result[0, 1] = 2  # point (1,0) predicted 2, gt 0
    n = update_confusion_matrix_per_pixel(cm, points, result)
    assert n == 3
    assert cm[0][0] == 1 and cm[0][2] == 1 and cm[1][1] == 1


def test_confusion_matrix_per_region_correct_detection():
    cm = new_confusion_matrix(2)
    gt = np.zeros((8, 8), dtype=np.uint16)
    gt[2:4, 2:4] = 1
    pred = gt.copy()
    ys, xs = np.nonzero(gt == 1)
    points = {
        1: np.stack([xs, ys], axis=1),
        0: np.array([[0, 0], [7, 7]]),
    }
    update_confusion_matrix_per_region(cm, points, gt, pred)
    # gt pass: background blob votes 0->0; defect blob votes 1->1.
    # result pass: same blobs again (two-way counts twice).
    assert cm[1][1] == 2
    assert cm[0][0] == 2
    assert cm.sum() == 4


def test_confusion_matrix_per_region_detection_bias():
    """A tiny predicted defect inside a large gt defect blob counts as a
    detection: background votes are discarded."""
    cm = new_confusion_matrix(2)
    gt = np.zeros((8, 8), dtype=np.uint16)
    gt[1:7, 1:7] = 1  # large defect
    pred = np.zeros((8, 8), dtype=np.uint16)
    pred[3, 3] = 1  # only one pixel found
    ys, xs = np.nonzero(gt == 1)
    points = {1: np.stack([xs, ys], axis=1)}
    update_confusion_matrix_per_region(cm, points, gt, pred)
    # gt-blob pass: background votes discarded -> counted as detected (1,1).
    # result-blob pass: the found pixel's blob votes (1,1) again, and the 35
    # undetected points fall in the result's background region, whose
    # prediction is background-only -> one (1,0).
    # This two-way accounting is exactly the reference's
    # (annonet_infer_main.cpp:246-271 runs vote_blob_class on both maps).
    assert cm[1][1] == 2
    assert cm[1][0] == 1


def test_confusion_matrix_per_region_miss():
    cm = new_confusion_matrix(2)
    gt = np.zeros((8, 8), dtype=np.uint16)
    gt[1:3, 1:3] = 1
    pred = np.zeros((8, 8), dtype=np.uint16)  # nothing predicted
    ys, xs = np.nonzero(gt == 1)
    points = {1: np.stack([xs, ys], axis=1)}
    update_confusion_matrix_per_region(cm, points, gt, pred)
    # the miss is counted by BOTH passes (gt blob and result background blob)
    assert cm[1][0] == 2
    assert cm[1][1] == 0


def test_format_confusion_matrix_smoke():
    cm = new_confusion_matrix(3)
    cm[0][0] = 90
    cm[0][1] = 10
    cm[1][1] = 50
    cm[2][2] = 7
    text = format_confusion_matrix(cm, default_anno_classes())
    assert "predicted" in text and "recall" in text
    assert "precision" in text and "accuracy" in text
    assert "90" in text and "50" in text
    # recall of class 0 = 90%
    assert "90.00 %" in text


def test_gain_semantics_in_overlap_bands_documented_deviation():
    """Pins the DOCUMENTED deviation from the reference's overlap-blend
    semantics under nonzero gains (PARITY.md "Blend semantics").

    The reference accumulates UNNORMALIZED t-ramp contributions in overlap
    bands (annonet_infer.cpp:146-161): adjacent tile ramps sum to
    s(p) in (1, ~2-1/ov], and gains/detection margins are compared against
    those inflated logits (:176-185), so a gain's effective strength is
    divided by s(p) inside overlap bands. This framework normalizes the
    blend by the ramp sum (infer/tiling.py::inverse_weight_sum) BEFORE
    adding gains, so a gain has the same effect at every pixel.

    The test constructs a net with constant logits [0, m] (zero conv
    weights, head bias = margin m) and a gain g on class 0 with
    m < g < s_max * m: under this framework's semantics EVERY pixel flips
    to class 0; under the reference's rule, pixels in overlap bands where
    s(p) * m > g would have kept class 1 — a real disagreement, pinned
    here so the deviation stays intentional and visible.
    """
    import jax

    from annonet_jax.infer.core import TiledInferer
    from annonet_jax.infer.tiling import (
        TilingParameters,
        inverse_weight_sum,
    )
    from annonet_jax.models.segnet import (
        SegNetConfig,
        fold_batchnorm,
        init_state,
    )

    mc = SegNetConfig(
        class_count=2, level_count=1, base_width=4, compute_dtype="float32"
    )
    params, stats = init_state(jax.random.PRNGKey(0), mc)
    runtime = fold_batchnorm(params, stats, mc)
    # zero every weight and bias, then set the head bias to [0, m]:
    # the net now outputs exactly these logits at every pixel
    margin = 0.5
    runtime = jax.tree_util.tree_map(lambda a: np.zeros_like(a), runtime)
    runtime["head"]["b"] = np.array([0.0, margin], np.float32)

    tiling = TilingParameters(48, 48, 8, 8)
    image = np.full((96, 96, 3), 128, np.uint8)

    inferer = TiledInferer(runtime, mc, tiling)
    # the INFERER's plan (which may differ from raw plan_tiles — e.g. the
    # folded path's 3->4 tile-count bump): the s map must describe the
    # grid actually executed
    plan = inferer.plan(96, 96)
    assert plan.tile_count > 1
    s = 1.0 / inverse_weight_sum(plan)
    s_max = float(s.max())
    assert s_max > 1.2, s_max

    gain0 = margin * (1.0 + s_max) / 2.0  # m < g < s_max * m
    assert margin < gain0 < s_max * margin

    labels, _ = inferer.infer_arrays(image, gains=[gain0, 0.0])

    # this framework: uniform gain semantics -> ALL pixels flip to class 0
    assert (labels == 0).all()

    # the simulated reference decision (argmax of s * logits + gain)
    # disagrees on at least one overlap-band pixel of this very plan
    ref_keeps_class1 = s[: labels.shape[0], : labels.shape[1]] * margin > gain0
    assert ref_keeps_class1.any()

    # and with zero gains the two semantics agree everywhere (argmax is
    # invariant under the positive per-pixel scale s)
    labels_nogain, _ = inferer.infer_arrays(image)
    assert (labels_nogain == 1).all()

    # --- the opt-in compat mode reproduces the REFERENCE-side decisions
    # (annonet_infer.cpp:176-185 semantics in this framework's own grid):
    # argmax over the unnormalized s * logits + gain, pixel for pixel
    compat = TiledInferer(
        runtime, mc, tiling, reference_blend_semantics=True
    )
    labels_compat, _ = compat.infer_arrays(image, gains=[gain0, 0.0])
    h, w = labels_compat.shape
    expected_ref = np.where(s[:h, :w] * margin > gain0, 1, 0)
    # decided: pixels safely away from the threshold (float rounding of
    # the ramp accumulation may flip exact-tie pixels either way)
    decided = np.abs(s[:h, :w] * margin - gain0) > 1e-4
    assert decided.mean() > 0.99
    assert (labels_compat == expected_ref)[decided].all()
    # the compat mode actually disagrees with the default mode here —
    # the deviation is real, and the flag closes it
    assert (labels_compat != labels).any()
    # with zero gains the modes are identical (argmax invariant under s)
    labels_compat_nogain, _ = compat.infer_arrays(image)
    assert (labels_compat_nogain == 1).all()


def test_reference_blend_semantics_detection_seed_margins():
    """Detection-SEED margins under the compat mode also meet the
    unnormalized accumulation (annonet_infer.cpp:205-211): a seed fires
    where s(p)*(logit[label] - logit[0]) > det[label] - det[0], so a
    level between m and s_max*m seeds ONLY inside overlap bands where the
    ramp sum s(p) inflates the margin — the exact reference behavior the
    normalized default (margin identical everywhere -> no seeds at all at
    that level) cannot express."""
    import jax

    from annonet_jax.infer.core import TiledInferer
    from annonet_jax.infer.tiling import (
        TilingParameters,
        inverse_weight_sum,
    )
    from annonet_jax.models.segnet import (
        SegNetConfig,
        fold_batchnorm,
        init_state,
    )

    mc = SegNetConfig(
        class_count=2, level_count=1, base_width=4, compute_dtype="float32"
    )
    params, stats = init_state(jax.random.PRNGKey(0), mc)
    runtime = fold_batchnorm(params, stats, mc)
    margin = 0.5
    runtime = jax.tree_util.tree_map(lambda a: np.zeros_like(a), runtime)
    runtime["head"]["b"] = np.array([0.0, margin], np.float32)

    tiling = TilingParameters(48, 48, 8, 8)
    image = np.full((96, 96, 3), 128, np.uint8)
    # default (normalized) semantics: margin is exactly m everywhere,
    # m < level -> no seed anywhere -> the veto erases every label
    plain = TiledInferer(runtime, mc, tiling)
    # the executed grid's ramp-sum map (inferer.plan, not raw plan_tiles:
    # the folded path's tile-count bump can change the grid)
    plan = plain.plan(96, 96)
    s = 1.0 / inverse_weight_sum(plan)
    s_max = float(s.max())
    assert s_max > 1.2

    level1 = margin * (1.0 + s_max) / 2.0  # m < level < s_max * m
    _, seeds_plain = plain.infer_arrays(
        image, detection_levels=[0.0, level1]
    )
    assert seeds_plain is not None and not seeds_plain.any()

    # compat semantics: seeds exactly where s(p) * m > level
    compat = TiledInferer(
        runtime, mc, tiling, reference_blend_semantics=True
    )
    _, seeds_compat = compat.infer_arrays(
        image, detection_levels=[0.0, level1]
    )
    h, w = seeds_compat.shape
    expected = s[:h, :w] * margin > level1
    decided = np.abs(s[:h, :w] * margin - level1) > 1e-4
    assert expected.any() and not expected.all()
    assert decided.mean() > 0.99
    assert (seeds_compat == expected)[decided].all()


def test_batch_exact_size_no_padding_matches_bucketed():
    """pad_to_bucket=False compiles an exact-M program (zero padded
    compute for recurring full --image-batch groups); results equal the
    power-of-two-bucketed path exactly."""
    import jax

    from annonet_jax.models.segnet import (
        SegNetConfig, fold_batchnorm, init_state,
    )
    from annonet_jax.infer.core import TiledInferer
    from annonet_jax.infer.tiling import TilingParameters

    config = SegNetConfig(class_count=3, level_count=0, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    tiling = TilingParameters(48, 48, 10, 10)
    inferer = TiledInferer(runtime, config, tiling)
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, size=(3, 60, 60, 3), dtype=np.uint8)

    bucketed, _ = inferer.infer_arrays_batch(images)  # pads 3 -> 4
    exact, _ = inferer.infer_arrays_batch(images, pad_to_bucket=False)
    np.testing.assert_array_equal(exact, bucketed)
    assert exact.shape == (3, 60, 60)


def test_batch_pad_to_bucket_int_target():
    """pad_to_bucket=<int> pads a remainder batch up to an existing
    program's exact size (the CLI's final-group path); results equal the
    default bucketing, and an undersized target is rejected."""
    import jax
    import pytest

    from annonet_jax.models.segnet import (
        SegNetConfig, fold_batchnorm, init_state,
    )
    from annonet_jax.infer.core import TiledInferer
    from annonet_jax.infer.tiling import TilingParameters

    config = SegNetConfig(class_count=3, level_count=0, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    tiling = TilingParameters(48, 48, 10, 10)
    inferer = TiledInferer(runtime, config, tiling)
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, size=(2, 60, 60, 3), dtype=np.uint8)

    padded, _ = inferer.infer_arrays_batch(images, pad_to_bucket=6)
    default, _ = inferer.infer_arrays_batch(images)
    np.testing.assert_array_equal(padded, default)
    assert padded.shape == (2, 60, 60)
    with pytest.raises(ValueError, match="below the batch size"):
        inferer.infer_arrays_batch(images, pad_to_bucket=1)


# ------------------------------------------------------- plan autotune


def test_plan_for_counts_geometry():
    from annonet_jax.infer.tiling import plan_for_counts

    config = small_config()
    params = TilingParameters(
        max_tile_width=96, max_tile_height=96, overlap_x=8, overlap_y=8
    )
    base = plan_tiles(200, 200, config, params, lane_align_tiles=False)
    ny = len({y for y, _ in base.tile_yx})
    nx = len({x for _, x in base.tile_yx})
    # the denser grid covers the same canvas with smaller tiles
    denser = plan_for_counts(
        200, 200, config, params, ny + 1, nx + 1, lane_align_tiles=False
    )
    assert denser is not None
    assert denser.tile_count == (ny + 1) * (nx + 1)
    assert denser.tile_width <= base.tile_width
    covered = np.zeros((denser.padded_height, denser.padded_width), bool)
    for y, x in denser.tile_yx:
        covered[y:y + denser.tile_height, x:x + denser.tile_width] = True
    assert covered.all()
    # counts that cannot cover (overlap deeper than tiles allow) -> None
    assert plan_for_counts(
        200, 200, config, params, 60, 60, lane_align_tiles=False
    ) is None
    # the max-tile flags stay a hard cap: a 1-tile plan over a canvas
    # larger than the max is rejected
    assert plan_for_counts(
        200, 200, config, params, 1, 1, lane_align_tiles=False
    ) is None


def test_plan_autotune_selects_caches_and_matches_pinned(monkeypatch):
    """Measured plan selection (extension, docs/DESIGN.md par.22):
    the first image of a canvas measures candidate plans, later images
    reuse the cached winner, and the output equals a twin inferer pinned
    to the chosen plan exactly."""
    monkeypatch.setenv("ANNONET_AUTOTUNE_ITERS", "1")
    config = small_config()
    params = runtime_net(config)
    rng = np.random.default_rng(1)
    image = rng.integers(0, 256, size=(150, 150, 3), dtype=np.uint8)
    overlap = required_input_dimension(config)
    tiling = TilingParameters(96, 96, overlap, overlap)

    tuned = TiledInferer(params, config, tiling, plan_autotune=True)
    labels, _ = tuned.infer_arrays(image)
    assert labels.shape == (150, 150)
    assert len(tuned.autotune_reports) == 1
    (key, report), = tuned.autotune_reports.items()
    assert len(report) >= 2, "expected alternative grid counts"
    chosen = report[0][0]
    assert tuned.plan(150, 150) == chosen
    # rates are fastest-first
    rates = [r for _, r in report]
    assert rates == sorted(rates, reverse=True)

    # second call reuses the cache (no new measurement entries)
    labels2, _ = tuned.infer_arrays(image)
    np.testing.assert_array_equal(labels, labels2)
    assert len(tuned.autotune_reports) == 1

    # exact equality with a twin pinned to the chosen plan
    twin = TiledInferer(params, config, tiling)
    twin._plan_override = chosen
    pinned, _ = twin.infer_arrays(image)
    np.testing.assert_array_equal(labels, pinned)


def test_plan_count_cliff_bump():
    """The static planner bumps a 3-tile axis to 4 on the folded path
    (measured ~2x count cliff, docs/DESIGN.md par.24-25); the bumped
    tiles are smaller, so the max-tile cap still holds."""
    config = small_config(base_width=4)  # folds: 8 * width(0) <= 128
    params = runtime_net(config)
    ov = required_input_dimension(config)
    # canvas/tile ratio that lands on 3 tiles per axis
    inferer = TiledInferer(
        params, config, TilingParameters(96, 96, ov, ov)
    )
    plan = inferer.plan(232, 232)
    ny = len({y for y, _ in plan.tile_yx})
    nx = len({x for _, x in plan.tile_yx})
    assert 3 not in (ny, nx), (ny, nx)
    assert plan.tile_width <= 96 and plan.tile_height <= 96
    # coverage invariant
    covered = np.zeros((plan.padded_height, plan.padded_width), bool)
    for y, x in plan.tile_yx:
        covered[y:y + plan.tile_height, x:x + plan.tile_width] = True
    assert covered.all()


def test_update_params_swaps_weights_without_recompiling():
    """TiledInferer.update_params: same-architecture weight swap keeps
    every compiled program (params are traced arguments) and produces
    EXACTLY what a fresh inferer over the new params produces — float
    path bit-exact; int8 recalibrates like a fresh inferer."""
    import jax

    from annonet_jax.models.segnet import fold_batchnorm, init_state

    config = SegNetConfig(class_count=3, level_count=1, base_width=16)
    nets = []
    for seed in (0, 1):
        params, bn = init_state(jax.random.PRNGKey(seed), config)
        nets.append(fold_batchnorm(params, bn, config))
    tiling = TilingParameters(64, 64, 20, 20)
    rng = np.random.default_rng(2)
    image = rng.integers(0, 256, size=(100, 90, 3), dtype=np.uint8)

    inferer = TiledInferer(nets[0], config, tiling)
    first = annonet_infer(inferer, image)
    programs = len(inferer._compiled)
    assert programs >= 1

    inferer.update_params(nets[1])
    # the folded variants that were in use are eagerly rebuilt (off the
    # request path), and no compiled programs were dropped
    assert inferer._folded_cache
    swapped = annonet_infer(inferer, image)
    assert len(inferer._compiled) == programs  # zero new compiles
    fresh = annonet_infer(TiledInferer(nets[1], config, tiling), image)
    np.testing.assert_array_equal(swapped, fresh)
    assert (first != swapped).any()  # the weights really changed

    # int8: the swap drops calibration; the next image recalibrates and
    # the result matches a fresh int8 inferer over the new params
    q = TiledInferer(nets[0], config, tiling, quantize="int8")
    annonet_infer(q, image)
    q.update_params(nets[1])
    assert not q._quantized_cache and not q._calib_frozen
    got = annonet_infer(q, image)
    ref = annonet_infer(
        TiledInferer(nets[1], config, tiling, quantize="int8"), image
    )
    np.testing.assert_array_equal(got, ref)
