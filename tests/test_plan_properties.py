"""Randomized property sweep over the tile planner.

The planner (infer/tiling.py) carries several interacting rules — even
spreading, sublane snapping, lane alignment, the 3-count bump, canvas
buckets, prefer-width snapping — each added for a measured reason
(docs/DESIGN.md §22-25). This sweep pins the INVARIANTS that must hold for
every one of them, across a seeded random sample of image sizes, model
configs, and tile limits (the reference's single invariant — tiles cover
the image with >= overlap shared pixels, annonet_infer.cpp:42-66 — plus
the ones the batched device path additionally relies on):

  1. coverage: every padded-canvas pixel is inside >= 1 tile
  2. overlap: adjacent tiles share >= the requested overlap (receptive
     field), so every output pixel has one full-context tile
  3. alignment: tile dims are stride-aligned (recommended_input_dimension
     fixpoints) — the skip-connection concats require it
  4. bounds: tile dims never exceed the caller's max (the memory-proxy
     contract of -w/-h) and tiles never leave the canvas
  5. the blend denominator is strictly positive and factorizes exactly
     (the int8 argmax fold's precondition, weight_sum_factors)
"""

import numpy as np
import pytest

from annonet_jax.infer.tiling import (
    TilingParameters,
    plan_tiles,
    ramp_weights,
    weight_sum_factors,
)
from annonet_jax.models.segnet import (
    SegNetConfig,
    recommended_input_dimension,
    required_input_dimension,
)


def _check_plan_invariants(plan, params, config):
    th, tw = plan.tile_height, plan.tile_width
    assert th <= max(
        recommended_input_dimension(config, params.max_tile_height),
        recommended_input_dimension(config, plan.padded_height),
    )
    assert tw > 0 and th > 0
    # (3) stride alignment: recommended_input_dimension is a fixpoint
    assert recommended_input_dimension(config, th) == th
    assert recommended_input_dimension(config, tw) == tw
    # (4) tiles stay on the canvas
    for y, x in plan.tile_yx:
        assert 0 <= y <= plan.padded_height - th
        assert 0 <= x <= plan.padded_width - tw

    # (1) coverage and (2) pairwise overlap along each axis
    for canvas, dim, overlap, positions in (
        (plan.padded_height, th, plan.overlap_y,
         sorted({y for y, _ in plan.tile_yx})),
        (plan.padded_width, tw, plan.overlap_x,
         sorted({x for _, x in plan.tile_yx})),
    ):
        assert positions[0] == 0
        assert positions[-1] + dim >= canvas
        for a, b in zip(positions, positions[1:]):
            shared = a + dim - b
            assert shared >= overlap, (canvas, dim, overlap, positions)

    # (5) positive, exactly factorized blend denominator. The 2-D
    # reconstruction is checked on sampled rows (a full [Hp,Wp] float64
    # canvas per random plan would dominate the sweep's runtime).
    factors = weight_sum_factors(plan)
    assert factors is not None
    wy, wx = factors
    assert np.all(wy > 0) and np.all(wx > 0)
    assert np.all(np.isfinite(wy)) and np.all(np.isfinite(wx))
    ramp = ramp_weights(th, tw, plan.overlap_y, plan.overlap_x)
    rows = {0, plan.padded_height - 1, plan.padded_height // 2,
            min(plan.overlap_y, plan.padded_height - 1)}
    for row in rows:
        expect = np.zeros(plan.padded_width, np.float64)
        for y, x in plan.tile_yx:
            if y <= row < y + th:
                expect[x : x + tw] += ramp[row - y]
        np.testing.assert_allclose(
            expect, (wy[row] * wx).astype(np.float64), rtol=1e-5
        )


@pytest.mark.parametrize("level_count", [0, 1, 2, 3])
def test_plan_invariants_random_sweep(level_count):
    rng = np.random.default_rng(level_count)
    config = SegNetConfig(
        class_count=2, level_count=level_count, width_scaler=1.0
    )
    overlap = required_input_dimension(config)
    for _ in range(40):
        h = int(rng.integers(1, 4200))
        w = int(rng.integers(1, 4200))
        # keep max_tile well above the overlap: a tile barely larger than
        # the receptive field produces thousands-of-tiles plans that no
        # real configuration uses and that only stress the test's own
        # O(tiles * tile_area) wsum reconstruction
        max_tile = int(rng.integers(max(256, 4 * overlap), 2200))
        params = TilingParameters(
            max_tile_width=max_tile,
            max_tile_height=max_tile,
            overlap_x=overlap,
            overlap_y=overlap,
        )
        plan = plan_tiles(h, w, config, params)
        assert plan.padded_height >= h and plan.padded_width >= w
        _check_plan_invariants(plan, params, config)


def test_plan_invariants_prefer_widths_and_degenerate_sizes():
    config = SegNetConfig(class_count=3, level_count=2)
    overlap = required_input_dimension(config)
    params = TilingParameters(1088, 1088, overlap, overlap)
    for h, w in [(1, 1), (1, 4096), (4096, 1), (overlap, overlap),
                 (1087, 1089), (3000, 3000)]:
        plan = plan_tiles(
            h, w, config, params, prefer_tile_widths=(96, 104, 128)
        )
        _check_plan_invariants(plan, params, config)
