"""Tests for the SegmentationNet model core.

Mirrors the reference CI matrix (appveyor.yml:6-23): level_count x
{RGB, grayscale} — here as runtime parametrization instead of 8 separate
builds. Also pins the computed dimension queries against an empirical
receptive-field measurement, which the reference never does (its
GetRequiredInputDimension is trusted compile-time template math).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from annonet_jax.models import (
    SegNetConfig,
    apply_runtime,
    apply_train,
    fold_batchnorm,
    init_state,
    recommended_input_dimension,
    required_input_dimension,
)


def _cfg(**kw):
    defaults = dict(
        class_count=3,
        level_count=1,
        base_width=4,
        compute_dtype="float32",
    )
    defaults.update(kw)
    return SegNetConfig(**defaults)


# ------------------------------------------------------------- dimensions


@pytest.mark.parametrize("level_count", [0, 1, 2, 3])
def test_recommended_dimension_properties(level_count):
    cfg = _cfg(level_count=level_count)
    align = 2**level_count
    for requested in [1, 7, 16, 33, 100, 1024]:
        d = recommended_input_dimension(cfg, requested)
        assert d >= requested  # asserted by reference at annonet_infer.cpp:54
        assert d % align == 0
        # idempotent
        assert recommended_input_dimension(cfg, d) == d


@pytest.mark.parametrize("level_count,expected_rf", [(0, 5), (1, 14), (2, 30), (3, 62)])
def test_required_input_dimension_formula(level_count, expected_rf):
    """Pin the computed worst-case influence widths (regression values
    cross-checked by the empirical test below)."""
    cfg = _cfg(level_count=level_count)
    assert required_input_dimension(cfg) == expected_rf


@pytest.mark.parametrize("level_count", [0, 1, 2])
def test_required_input_dimension_is_empirical_receptive_field(level_count):
    """Make the net transparent (positive weights, zero bias, ReLU-open),
    bump single pixels covering every stride parity class, and check the
    worst-case output footprint equals required_input_dimension exactly."""
    cfg = _cfg(level_count=level_count, grayscale=True, class_count=2)
    rf = required_input_dimension(cfg)
    dim = recommended_input_dimension(cfg, 2 * rf + 2 ** (level_count + 1) + 9)
    key = jax.random.PRNGKey(0)
    params, stats = init_state(key, cfg)
    params = jax.tree_util.tree_map(jnp.abs, params)
    runtime = fold_batchnorm(params, stats, cfg)
    # zero the folded biases so the net is linear-with-positive-weights
    runtime = jax.tree_util.tree_map(
        lambda x: jnp.zeros_like(x) if x.ndim == 1 else x, runtime
    )

    # normalized input is (v/255 - 0.5): use values > 127 so every activation
    # stays positive and ReLU is transparent
    x0 = np.full((1, dim, dim, 1), 200, dtype=np.uint8)
    y0 = np.asarray(apply_runtime(runtime, jnp.asarray(x0), cfg))

    worst = 0
    for parity in range(2**level_count):
        x1 = x0.copy()
        cy = cx = dim // 2 + parity
        x1[0, cy, cx, 0] = 255
        y1 = np.asarray(apply_runtime(runtime, jnp.asarray(x1), cfg))
        diff = np.abs(y1 - y0).max(axis=(0, 3))
        rows = np.nonzero(diff.max(axis=1) > 1e-6)[0]
        span = rows[-1] - rows[0] + 1
        assert span <= rf  # never exceeds the computed bound
        worst = max(worst, span)
    assert worst == rf  # and the bound is tight


# ------------------------------------------------------------- shapes


@pytest.mark.parametrize("level_count", [0, 1, 2, 3])
@pytest.mark.parametrize("grayscale", [False, True])
def test_forward_shapes_ci_matrix(level_count, grayscale):
    """The 8-config matrix of appveyor.yml:6-23 as runtime parametrization."""
    cfg = _cfg(level_count=level_count, grayscale=grayscale)
    dim = recommended_input_dimension(cfg, 16)
    key = jax.random.PRNGKey(1)
    params, stats = init_state(key, cfg)
    x = jnp.zeros((2, dim, dim, cfg.in_channels), jnp.uint8)

    logits, new_stats = apply_train(params, stats, x, cfg)
    assert logits.shape == (2, dim, dim, cfg.class_count)
    assert logits.dtype == jnp.float32

    runtime = fold_batchnorm(params, stats, cfg)
    y = apply_runtime(runtime, x, cfg)
    assert y.shape == (2, dim, dim, cfg.class_count)


def test_forward_rectangular_input():
    cfg = _cfg(level_count=2)
    params, stats = init_state(jax.random.PRNGKey(2), cfg)
    x = jnp.zeros((1, 16, 32, 3), jnp.uint8)
    logits, _ = apply_train(params, stats, x, cfg)
    assert logits.shape == (1, 16, 32, 3)


# ------------------------------------------------------------- BN folding


def test_bn_folding_matches_batch_stats_forward():
    """With momentum 0 the running stats ARE the batch stats, so the folded
    runtime net must reproduce the training forward exactly (float32)."""
    cfg = _cfg(level_count=2, class_count=4)
    dim = recommended_input_dimension(cfg, 24)
    params, stats = init_state(jax.random.PRNGKey(3), cfg)
    x = jax.random.randint(jax.random.PRNGKey(4), (2, dim, dim, 3), 0, 255, jnp.uint8)

    train_logits, new_stats = apply_train(params, stats, x, cfg, bn_momentum=0.0)
    runtime = fold_batchnorm(params, new_stats, cfg)
    run_logits = apply_runtime(runtime, x, cfg)

    np.testing.assert_allclose(
        np.asarray(train_logits), np.asarray(run_logits), rtol=1e-4, atol=1e-4
    )


def test_bn_stats_update_momentum():
    cfg = _cfg(level_count=0)
    params, stats = init_state(jax.random.PRNGKey(5), cfg)
    x = jax.random.randint(jax.random.PRNGKey(6), (2, 8, 8, 3), 0, 255, jnp.uint8)
    _, s1 = apply_train(params, stats, x, cfg, bn_momentum=0.9)
    # stats moved away from init (mean 0, var 1) but only by 10%
    m = np.asarray(s1["stem"]["bn0"]["mean"])
    assert np.any(m != 0.0)
    _, s_full = apply_train(params, stats, x, cfg, bn_momentum=0.0)
    np.testing.assert_allclose(
        m, 0.1 * np.asarray(s_full["stem"]["bn0"]["mean"]), rtol=1e-5
    )


# ------------------------------------------------------------- widths / jit


def test_width_scaler_and_min_filters():
    cfg = _cfg(level_count=2, width_scaler=0.5, min_filter_count=3, base_width=16)
    assert cfg.width(0) == 8
    assert cfg.width(1) == 16
    cfg2 = _cfg(width_scaler=0.01, min_filter_count=3)
    assert cfg2.width(0) == 3  # floor at min_filter_count


def test_runtime_forward_jits():
    cfg = _cfg(level_count=1)
    params, stats = init_state(jax.random.PRNGKey(7), cfg)
    runtime = fold_batchnorm(params, stats, cfg)
    fn = jax.jit(lambda p, x: apply_runtime(p, x, cfg))
    x = jnp.zeros((1, 16, 16, 3), jnp.uint8)
    y = fn(runtime, x)
    assert y.shape == (1, 16, 16, 3)


def test_config_round_trip():
    cfg = _cfg(level_count=3, grayscale=True, width_scaler=2.0)
    assert SegNetConfig.from_dict(cfg.to_dict()) == cfg
