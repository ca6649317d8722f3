"""Fully folded runtime net == reference runtime net, exactly (up to dtype
reassociation; tested in float32)."""

import jax
import numpy as np
import pytest

from annonet_jax.models.folded_runtime import (
    apply_runtime_folded,
    fold_runtime_params,
)
from annonet_jax.models.segnet import (
    SegNetConfig,
    apply_runtime,
    fold_batchnorm,
    init_state,
)


@pytest.mark.parametrize("level_count", [0, 1, 2, 3])
@pytest.mark.parametrize("grayscale", [False, True])
def test_folded_matches_runtime(level_count, grayscale):
    config = SegNetConfig(
        class_count=3,
        level_count=level_count,
        base_width=4,
        grayscale=grayscale,
        compute_dtype="float32",
    )
    params, stats = init_state(jax.random.PRNGKey(level_count), config)
    runtime = fold_batchnorm(params, stats, config)

    rng = np.random.default_rng(0)
    x = rng.integers(
        0, 256, size=(2, 16, 32, config.in_channels), dtype=np.uint8
    )

    ref = np.asarray(apply_runtime(runtime, x, config))
    fparams = fold_runtime_params(runtime, config, fold0=8)
    got = np.asarray(apply_runtime_folded(fparams, x, config))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_folded_matches_runtime_wide():
    """Default widths (the flagship config) on a larger input."""
    config = SegNetConfig(
        class_count=2, level_count=3, base_width=16, compute_dtype="float32"
    )
    params, stats = init_state(jax.random.PRNGKey(7), config)
    runtime = fold_batchnorm(params, stats, config)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, size=(1, 24, 64, 3), dtype=np.uint8)
    ref = np.asarray(apply_runtime(runtime, x, config))
    got = np.asarray(
        apply_runtime_folded(fold_runtime_params(runtime, config, 8), x, config)
    )
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_folded_rejects_bad_width():
    config = SegNetConfig(
        class_count=2, level_count=1, base_width=4, compute_dtype="float32"
    )
    params, stats = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, stats, config)
    fparams = fold_runtime_params(runtime, config, 8)
    x = np.zeros((1, 16, 20, 3), np.uint8)  # 20 % 8 != 0
    with pytest.raises(AssertionError):
        apply_runtime_folded(fparams, x, config)


def test_folding_gate_requires_decoder_mirrorable_fold():
    """Configs whose lane cap forces fold0 below 2^level_count must NOT
    fold: the encoder would floor the fold at 1 mid-schedule and the
    decoder's fold-doubling mirror breaks (previously an AssertionError
    deep in fold_runtime_params — found by the round-5 detection sweep's
    base_width-24 arm). folding_supported now rejects them, and tiled
    inference runs the plain net instead of crashing."""
    from annonet_jax.infer.core import TiledInferer
    from annonet_jax.infer.tiling import TilingParameters
    from annonet_jax.models.folded_runtime import folding_supported

    for level_count, base_width in ((3, 24), (3, 32), (2, 64)):
        config = SegNetConfig(
            class_count=3, level_count=level_count, base_width=base_width,
            compute_dtype="float32",
        )
        assert folding_supported(config, 128) == 0, (level_count, base_width)

    # the flagship and every reference CI config still fold
    for level_count in (0, 1, 2, 3):
        config = SegNetConfig(
            class_count=3, level_count=level_count, base_width=16,
            compute_dtype="float32",
        )
        assert folding_supported(config, 128) == 8, level_count

    # end-to-end: the rejected config infers through the plain path and
    # matches the explicitly-unfolded inferer exactly
    config = SegNetConfig(
        class_count=3, level_count=3, base_width=24,
        compute_dtype="float32",
    )
    params, stats = init_state(jax.random.PRNGKey(3), config)
    runtime = fold_batchnorm(params, stats, config)
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, size=(96, 96, 3), dtype=np.uint8)
    tiling = TilingParameters(64, 64, 8, 8)
    folded_default = TiledInferer(runtime, config, tiling)
    plain = TiledInferer(runtime, config, tiling, use_folded_net=False)
    labels_a, _ = folded_default.infer_arrays(image)
    labels_b, _ = plain.infer_arrays(image)
    assert (labels_a == labels_b).all()
