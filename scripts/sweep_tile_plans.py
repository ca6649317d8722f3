"""Composed-program rate vs tile plan for the shipped int8 path.

The auto plan at the reference's 1024 max-tile default tiles a 4096^2
image as 25x 872^2 (13.3% redundant overlap area). Larger tiles cut
redundancy, but tile WIDTH also moves the folded width WB = tile_w/8,
which the conv kernels may be sensitive to; tile HEIGHT changes only the
area. This sweep measures the COMPOSED program (bench.py methodology:
chained iterations ended by jax.block_until_ready) across (tile_h,
tile_w) plans to find the best real plan.

Run alone on the GPU (one process per card).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from annonet_jax.cli.common import apply_platform_env

apply_platform_env()

import jax
import jax.numpy as jnp
import numpy as np

from annonet_jax.infer.core import TiledInferer
from annonet_jax.infer.tiling import TilingParameters
from annonet_jax.models.segnet import (
    SegNetConfig,
    fold_batchnorm,
    init_state,
    required_input_dimension,
)

SIZE = int(os.environ.get("SWEEP_SIZE", "4096"))
ITERS = 5

# (max_tile_h, max_tile_w) candidates; None = SIZE (full-canvas dimension)
PLANS = [
    (1024, 1024),   # the auto default (infer.tiling.default_tile_max)
    (1088, 1088),   # a 4x4 grid of 1072-px tiles at 4096^2
    (1440, 1440),   # a 3x3 grid
    (1072, None),   # full-width slabs; None = full canvas dimension
]


def main() -> None:
    config = SegNetConfig(class_count=3, level_count=3, base_width=16)
    params, bn_stats = init_state(jax.random.PRNGKey(0), config)
    rp = fold_batchnorm(params, bn_stats, config)
    overlap = required_input_dimension(config)

    rng = np.random.default_rng(0)
    image = jax.block_until_ready(jnp.asarray(
        rng.integers(0, 256, size=(SIZE, SIZE, 3), dtype=np.uint8)
    ))

    ref_labels = None
    for max_h, max_w in PLANS:
        th = SIZE if max_h is None else max_h
        tw = SIZE if max_w is None else max_w
        tiling = TilingParameters(tw, th, overlap, overlap)
        inferer = TiledInferer(rp, config, tiling, quantize="int8")
        plan = inferer.plan(SIZE, SIZE)
        area = (
            plan.tile_height * plan.tile_width * len(plan.tile_yx)
            / (SIZE * SIZE)
        )
        t0 = time.perf_counter()
        labels, _ = jax.block_until_ready(
            inferer.infer_arrays(image, device_output=True)
        )
        compile_s = time.perf_counter() - t0
        # label agreement vs the first (shipped) plan
        if ref_labels is None:
            ref_labels = labels
            agree = "ref"
        else:
            n_diff = int(jnp.sum(labels != ref_labels))
            agree = f"{n_diff} px differ"
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(ITERS):
                labels, _ = inferer.infer_arrays(image, device_output=True)
            jax.block_until_ready(labels)
            el = max(1e-9, time.perf_counter() - t0)
            rates.append(SIZE * SIZE * ITERS / 1e6 / el)
        med = sorted(rates)[1]
        print(
            f"plan max=({max_h},{max_w}) -> tile {plan.tile_height}x"
            f"{plan.tile_width} n={len(plan.tile_yx)} area={area:.3f} "
            f"WB={plan.tile_width // 8}: {med:.1f} Mpx/s "
            f"(passes {['%.0f' % r for r in rates]}, compile {compile_s:.0f}s,"
            f" labels: {agree})",
            flush=True,
        )


if __name__ == "__main__":
    main()
