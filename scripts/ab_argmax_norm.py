"""A/B: normalize-then-argmax vs gain-folded argmax on the int8 path.

The no-detection label map only needs argmax_k(acc*inv_wsum + g), which
equals argmax_k(acc + g*wsum); wsum factorizes over grid plans
(tiling.weight_sum_factors), so the gain term becomes two 1-D broadcasts
fused into the argmax and the full-canvas inv-wsum broadcast/convert/
multiply passes disappear. Label disagreements are expected near 0 (only
near-tie bf16 rounding can flip). The folded form is the default;
ANNONET_NO_ARGMAX_FOLD=1 selects the normalize path.

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
            ("normalize", {"ANNONET_NO_ARGMAX_FOLD": "1"}),
            ("folded-gain", {"ANNONET_NO_ARGMAX_FOLD": None}),
        ],
        image,
    )


if __name__ == "__main__":
    main()
