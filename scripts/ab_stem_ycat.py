"""A/B: the stem conv as a y-tap-concat (1,3) conv vs the plain 3x3.

The stem has the narrowest contraction in the int8 program (docs/DESIGN.md
§26: fold0 * 4 folded input channels). ANNONET_STEM_YCAT=1 rewrites it
(quantized_runtime.ycat_stem_qspec): concatenate the y-1/y/y+1 rows on the
channel axis and run a (1,3) conv — identical integer math (bit-exact,
tested), trading an extra device-memory pass over the 3x-wide stem input
for a 3x wider contraction. Label disagreements must be 0.

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
            ("plain-3x3", {"ANNONET_STEM_YCAT": None}),
            ("ycat-1x3", {"ANNONET_STEM_YCAT": "1"}),
        ],
        image,
    )


if __name__ == "__main__":
    main()
