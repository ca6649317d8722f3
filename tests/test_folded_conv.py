"""Width-folded conv: exact equivalence with lax.conv (ops/folded_conv.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from annonet_jax.ops.folded_conv import (
    conv3x3_folded,
    fold_width_kernel,
    pick_fold,
)


@pytest.mark.parametrize(
    "n,h,w,cin,cout,fold",
    [
        (2, 8, 16, 16, 16, 8),
        (1, 5, 24, 3, 16, 8),
        (2, 7, 32, 32, 16, 4),
        (1, 4, 8, 16, 8, 2),
        (1, 6, 64, 4, 4, 16),
    ],
)
def test_folded_matches_lax_conv(n, h, w, cin, cout, fold):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n, h, w, cin)).astype(np.float32))
    wgt = jnp.asarray(rng.normal(size=(3, 3, cin, cout)).astype(np.float32))
    ref = lax.conv_general_dilated(
        x, wgt, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")
    )
    got = conv3x3_folded(x, fold_width_kernel(wgt, fold), fold)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-4)


def test_pick_fold():
    assert pick_fold(896, 16) == 8
    assert pick_fold(896, 3) == 32
    assert pick_fold(896, 32) == 4
    assert pick_fold(896, 128) == 1
    assert pick_fold(7, 16) == 1  # width not divisible
