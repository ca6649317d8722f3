"""A/B: tile-gather axis order (leading vs sublane) on the composed
int8 inference program.

The "sublane" order stacks the tiles with the tile axis second-minor and
transposes back, which XLA may keep as a relabel instead of a relayout
copy of the tile batch. The leading order is the default;
ANNONET_GATHER_ORDER=sublane selects the other (docs/DESIGN.md §26).

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
MODE = os.environ.get("AB_MODE", "int8")


def main() -> None:
    config = SegNetConfig(class_count=3, level_count=3, base_width=16)
    params, bn_stats = init_state(jax.random.PRNGKey(0), config)
    rp = fold_batchnorm(params, bn_stats, config)
    overlap = required_input_dimension(config)
    tiling = TilingParameters(TILE, TILE, overlap, overlap)
    quant = "int8" if MODE == "int8" else None

    rng = np.random.default_rng(0)
    image = jnp.asarray(
        rng.integers(0, 256, size=(SIZE, SIZE, 3), dtype=np.uint8)
    )
    jax.block_until_ready(image)

    run_interleaved_ab(
        lambda: TiledInferer(rp, config, tiling, quantize=quant),
        [
            ("leading", {"ANNONET_GATHER_ORDER": None}),
            ("sublane", {"ANNONET_GATHER_ORDER": "sublane"}),
        ],
        image,
    )


if __name__ == "__main__":
    main()
