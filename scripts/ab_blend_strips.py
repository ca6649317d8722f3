"""A/B: flat DUS-chain vs per-row-strip blend accumulate (int8 path).

The flat chain serializes tile_count dynamic-update-slices into one
zero-initialized canvas. Strips build one accumulator per tile ROW
(independent chains of depth count_x) and join them with ONE concat whose
only arithmetic is the strip-overlap bands.

NOT bit-identical: the strip pre-sums regroup the float adds in
y-overlap bands ((a1+a2)+(b1+b2) vs (((a1+a2)+b1)+b2)). The flat chain
is the default; ANNONET_BLEND_STRIPS=1 selects strips (docs/DESIGN.md
§26).

Run alone on the GPU (one process per card).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from annonet_jax.cli.common import apply_platform_env

apply_platform_env()

import jax
import jax.numpy as jnp
import numpy as np

from ab_util import run_interleaved_ab
from annonet_jax.infer.core import TiledInferer
from annonet_jax.infer.tiling import TilingParameters
from annonet_jax.models.segnet import (
    SegNetConfig,
    fold_batchnorm,
    init_state,
    required_input_dimension,
)

SIZE = int(os.environ.get("AB_SIZE", "4096"))
TILE = int(os.environ.get("AB_TILE", "1024"))


def main() -> None:
    config = SegNetConfig(class_count=3, level_count=3, base_width=16)
    params, bn_stats = init_state(jax.random.PRNGKey(0), config)
    rp = fold_batchnorm(params, bn_stats, config)
    overlap = required_input_dimension(config)
    tiling = TilingParameters(TILE, TILE, overlap, overlap)

    rng = np.random.default_rng(0)
    image = jnp.asarray(
        rng.integers(0, 256, size=(SIZE, SIZE, 3), dtype=np.uint8)
    )
    jax.block_until_ready(image)

    run_interleaved_ab(
        lambda: TiledInferer(rp, config, tiling, quantize="int8"),
        [
            ("flat-chain", {"ANNONET_BLEND_STRIPS": "0"}),
            ("strips", {"ANNONET_BLEND_STRIPS": "1"}),
        ],
        image,
    )


if __name__ == "__main__":
    main()
