"""Checks that only the card can make (marker ``gpu``; they skip on CPU).

Run them on a machine with the GPU:

    ANNONET_TEST_GPU=1 python -m pytest -m gpu tests/

The int8 forms must compile on the card and stay exact: integer
accumulation has no rounding, so the card's int32 sums equal numpy's int64
sums bit for bit. As in the int8 net, the int32 accumulator feeds a float32
epilogue: XLA:GPU lowers an integer conv to cuDNN only with s8 input and
filter and an s8 or f32 output, and refuses a conv whose s32 result is the
program's output (UNIMPLEMENTED at compile time; scripts/probe_int8_conv.py
shows both forms). The sums stay below 2**24, so the conversion is exact
too. The float checks run at "highest" matmul
precision, so float32 products do not drop to TF32.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax

pytestmark = pytest.mark.gpu


def _conv_s8_numpy(x, w, stride, padding):
    """Exact int64 reference of an NHWC/HWIO int8 convolution."""
    kh, kw, _, cout = w.shape
    (pt, pb), (pl, pr) = padding
    xp = np.pad(x.astype(np.int64), ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    n, hp, wp, _ = xp.shape
    ho = (hp - kh) // stride[0] + 1
    wo = (wp - kw) // stride[1] + 1
    out = np.zeros((n, ho, wo, cout), np.int64)
    for dy in range(kh):
        for dx in range(kw):
            tap = xp[:, dy : dy + (ho - 1) * stride[0] + 1 : stride[0],
                     dx : dx + (wo - 1) * stride[1] + 1 : stride[1]]
            out += tap @ w[dy, dx].astype(np.int64)
    return out


@pytest.mark.parametrize(
    "shape, cout, stride, padding",
    [
        # the folded int8 net's widths: stem (fold 8 x 4 padded channels),
        # a stride-1 layer, and the folded stride-2 layer
        ((4, 256, 128, 32), 128, (1, 1), ((1, 1), (1, 1))),
        ((4, 256, 128, 128), 128, (1, 1), ((1, 1), (1, 1))),
        ((4, 256, 128, 128), 128, (2, 1), ((0, 1), (0, 1))),
        # the int8 training forward's RGB stem (3 input channels)
        ((8, 96, 96, 3), 16, (1, 1), ((1, 1), (1, 1))),
    ],
)
def test_int8_conv_is_exact_on_the_card(gpu_device, shape, cout, stride,
                                        padding):
    rng = np.random.default_rng(0)
    # post-ReLU activations are int8 in [0, 127] (models/quantized_runtime)
    x = rng.integers(0, 128, size=shape, dtype=np.int8)
    w = rng.integers(-127, 128, size=(3, 3, shape[-1], cout), dtype=np.int8)
    conv = jax.jit(lambda a, b: lax.conv_general_dilated(
        a, b, stride, padding, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32))
    out = conv(jax.device_put(x, gpu_device), jax.device_put(w, gpu_device))
    expected = _conv_s8_numpy(x, w, stride, padding)
    assert np.abs(expected).max() < 2**24
    np.testing.assert_array_equal(np.asarray(out), expected)


def test_int8_head_dot_is_exact_on_the_card(gpu_device):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 128, size=(4096, 128), dtype=np.int8)
    w = rng.integers(-127, 128, size=(128, 24), dtype=np.int8)
    dot = jax.jit(lambda a, b: lax.dot_general(
        a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32,
    ).astype(jnp.float32))
    np.testing.assert_array_equal(
        np.asarray(dot(x, w)), x.astype(np.int64) @ w.astype(np.int64)
    )


def test_folded_float32_matches_plain_on_the_card(gpu_device):
    import dataclasses

    from annonet_jax.models.folded_runtime import (
        apply_folded_split,
        fold_runtime_params,
        split_folded,
    )
    from annonet_jax.models.segnet import (
        SegNetConfig,
        apply_runtime,
        fold_batchnorm,
        init_state,
    )

    config = dataclasses.replace(
        SegNetConfig(class_count=3, level_count=3, base_width=16),
        compute_dtype="float32",
    )
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    (fold0, spec), arrays = split_folded(
        fold_runtime_params(runtime, config, 8)
    )
    x = np.random.default_rng(2).integers(
        0, 256, size=(2, 512, 512, 3), dtype=np.uint8
    )
    with jax.default_matmul_precision("highest"):
        folded = apply_folded_split(arrays, x, config, fold0=fold0, spec=spec)
        plain = apply_runtime(runtime, x, config)
    np.testing.assert_allclose(
        np.asarray(folded), np.asarray(plain), rtol=1e-4, atol=1e-4
    )
