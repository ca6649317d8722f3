"""Tests for the plateau detector, loss, and the training driver."""

import numpy as np
import pytest

import jax.numpy as jnp

from annonet_jax.classes import IGNORE_LABEL
from annonet_jax.models import SegNetConfig, apply_runtime
from annonet_jax.ops.loss import weighted_pixel_cross_entropy
from annonet_jax.train import (
    Trainer,
    TrainerConfig,
    count_steps_without_decrease,
    count_steps_without_decrease_robust,
)


# ------------------------------------------------------------- plateau


def test_decreasing_series_counts_zero():
    losses = list(np.linspace(10.0, 1.0, 200) + np.random.default_rng(0).normal(0, 0.01, 200))
    assert count_steps_without_decrease(losses) < 10


def test_flat_series_counts_large_window():
    # For a flat noisy series P(slope>0) per window is ~uniform, so the
    # largest not-confidently-decreasing window is large but fluctuates;
    # the trainer-level test below pins the actual LR-shrink contract.
    rng = np.random.default_rng(1)
    losses = list(1.0 + rng.normal(0, 0.05, 300))
    assert count_steps_without_decrease(losses) >= 100


def test_recent_plateau_after_decrease():
    rng = np.random.default_rng(2)
    decreasing = np.linspace(5.0, 1.0, 200)
    flat = 1.0 + rng.normal(0, 0.01, 150)
    losses = list(np.concatenate([decreasing, flat]))
    count = count_steps_without_decrease(losses)
    assert 140 <= count <= 260  # the flat tail dominates, not the old decrease


def test_robust_ignores_spikes():
    rng = np.random.default_rng(3)
    losses = np.linspace(5.0, 1.0, 300) + rng.normal(0, 0.01, 300)
    # a few huge spikes would fool the plain detector into "no decrease"
    losses[::50] = 100.0
    assert count_steps_without_decrease_robust(list(losses)) < 20


def test_empty_and_tiny_series():
    assert count_steps_without_decrease([]) == 0
    assert count_steps_without_decrease([1.0]) == 0
    assert count_steps_without_decrease([1.0, 2.0]) == 0


# ------------------------------------------------------------- loss


def test_loss_ignores_weight_zero_pixels():
    logits = jnp.zeros((1, 2, 2, 3))
    labels = jnp.array([[[0, 1], [2, 0]]], dtype=jnp.int32)
    weights = jnp.array([[[1.0, 0.0], [1.0, 1.0]]])
    loss = float(weighted_pixel_cross_entropy(logits, labels, weights))
    # uniform logits: CE = log(3); 3 weighted pixels / 4 total
    assert loss == pytest.approx(np.log(3) * 3 / 4, rel=1e-5)


def test_loss_handles_ignore_label_without_nan():
    logits = jnp.zeros((1, 1, 2, 3))
    labels = jnp.array([[[0, IGNORE_LABEL]]], dtype=jnp.int32)
    weights = jnp.array([[[1.0, 0.0]]])
    loss = float(weighted_pixel_cross_entropy(logits, labels, weights))
    assert np.isfinite(loss)


# ------------------------------------------------------------- trainer


def _toy_batch(n=4, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    images = np.zeros((n, dim, dim, 3), np.uint8)
    images[:, :, dim // 2 :] = 220
    images += rng.integers(0, 16, images.shape).astype(np.uint8)
    labels = np.zeros((n, dim, dim), np.uint16)
    labels[:, :, dim // 2 :] = 1
    weights = np.ones((n, dim, dim), np.float32)
    return images, labels, weights


def _small_cfgs(**kw):
    mc = SegNetConfig(class_count=2, level_count=1, base_width=4, compute_dtype="float32")
    tc = TrainerConfig(
        initial_learning_rate=0.1,
        iterations_without_progress_threshold=50,
        previous_loss_values_dump_amount=10,
        bn_stats_window=10,
        **kw,
    )
    return mc, tc


def test_trainer_loss_decreases_and_runtime_net_predicts():
    mc, tc = _small_cfgs()
    trainer = Trainer(mc, tc, seed=0)
    images, labels, weights = _toy_batch()
    losses = [trainer.train_step(images, labels, weights) for _ in range(40)]
    assert losses[-1] < losses[0] * 0.5

    runtime = trainer.runtime_net()
    pred = np.asarray(
        jnp.argmax(apply_runtime(runtime, jnp.asarray(images), mc), axis=-1)
    )
    assert (pred == labels).mean() > 0.9


def test_learning_rate_shrinks_on_plateau():
    mc, tc = _small_cfgs()
    trainer = Trainer(mc, tc, seed=0)
    # feed a synthetic flat loss history instead of real steps
    rng = np.random.default_rng(0)
    for v in 1.0 + rng.normal(0, 0.001, 60):
        trainer._record_loss(float(v))
    assert trainer.learning_rate == pytest.approx(0.1 * tc.learning_rate_shrink_factor)
    # window cleared at the shrink; only post-shrink losses remain
    assert len(trainer.previous_loss_values) < 15


def test_sync_file_round_trip(tmp_path):
    sync = str(tmp_path / "state.dat")
    mc, tc = _small_cfgs(sync_file=sync)
    trainer = Trainer(mc, tc, seed=0)
    images, labels, weights = _toy_batch()
    for _ in range(3):
        trainer.train_step(images, labels, weights)
    trainer.learning_rate = 0.025
    trainer.save_sync_file()

    resumed = Trainer(mc, tc, seed=123)  # different seed: must load, not re-init
    assert resumed.step_count == 3
    assert resumed.learning_rate == pytest.approx(0.025)
    np.testing.assert_allclose(
        np.asarray(resumed.params["head"]["w"]),
        np.asarray(trainer.params["head"]["w"]),
    )
    # resumed trainer continues training
    loss = resumed.train_step(images, labels, weights)
    assert np.isfinite(loss)


def test_sync_file_config_mismatch_raises(tmp_path):
    sync = str(tmp_path / "state.dat")
    mc, tc = _small_cfgs(sync_file=sync)
    Trainer(mc, tc, seed=0).save_sync_file()
    other_mc = SegNetConfig(class_count=3, level_count=1, base_width=4, compute_dtype="float32")
    with pytest.raises(RuntimeError, match="different model config"):
        Trainer(other_mc, tc, seed=0)


# ---------------------------------------------------------- BN stats window


def test_bn_momentum_for_step_schedule():
    """dlib bn_ semantics: update factor 1/min(t, W) — cumulative average
    until the window fills, then an EMA with momentum 1 - 1/W."""
    from annonet_jax.train.trainer import bn_momentum_for_step

    W = 5
    assert bn_momentum_for_step(0, W) == 0.0  # first update: full replace
    assert bn_momentum_for_step(1, W) == pytest.approx(1 - 1 / 2)
    assert bn_momentum_for_step(3, W) == pytest.approx(1 - 1 / 4)
    assert bn_momentum_for_step(4, W) == pytest.approx(1 - 1 / 5)
    assert bn_momentum_for_step(100, W) == pytest.approx(1 - 1 / 5)


def test_bn_running_stats_are_true_windowed_average():
    """While the window is filling, the running stats must equal the plain
    average of the per-batch statistics — the 'windowed statistics'
    interpretation of SetAllBatchNormalizationRunningStatsWindowSizes
    (annonet_train_main.cpp:410) — and the BN-folded nets built from either
    must be identical."""
    import jax

    from annonet_jax.models.segnet import (
        apply_train,
        fold_batchnorm,
        init_state,
    )
    from annonet_jax.train.trainer import bn_momentum_for_step

    cfg = SegNetConfig(
        class_count=2, level_count=1, base_width=4, compute_dtype="float32"
    )
    params, stats0 = init_state(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    batches = [
        rng.integers(0, 256, size=(2, 16, 16, 3), dtype=np.uint8)
        for _ in range(4)
    ]

    window = 100  # larger than the step count: pure cumulative average
    running = stats0
    per_batch = []
    for t, batch in enumerate(batches):
        # bn_momentum=0.0 returns exactly this batch's statistics
        _, batch_stats = apply_train(
            params, stats0, jnp.asarray(batch), cfg, bn_momentum=0.0
        )
        per_batch.append(batch_stats)
        _, running = apply_train(
            params,
            running,
            jnp.asarray(batch),
            cfg,
            bn_momentum=bn_momentum_for_step(t, window),
        )

    mean_stats = jax.tree_util.tree_map(
        lambda *leaves: np.mean(np.stack(leaves), axis=0), *per_batch
    )
    for got, want in zip(
        jax.tree_util.tree_leaves(running),
        jax.tree_util.tree_leaves(mean_stats),
    ):
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6
        )

    # the folded runtime nets agree too (long-run output comparison)
    folded_a = fold_batchnorm(params, running, cfg)
    folded_b = fold_batchnorm(params, mean_stats, cfg)
    for a, b in zip(
        jax.tree_util.tree_leaves(folded_a),
        jax.tree_util.tree_leaves(folded_b),
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6
        )


def test_first_trainer_step_has_no_init_bias():
    """After ONE training step the running stats must be exactly that
    batch's statistics (dlib's first update has factor 1/1), not a 99:1
    blend with the zeros/ones initialization."""
    config = SegNetConfig(
        class_count=2, level_count=0, base_width=4, compute_dtype="float32"
    )
    trainer = Trainer(config, TrainerConfig())
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, size=(2, 16, 16, 3), dtype=np.uint8)
    labels = rng.integers(0, 2, size=(2, 16, 16)).astype(np.uint16)
    weights = np.ones((2, 16, 16), np.float32)
    trainer.train_step(images, labels, weights)
    # init var is 1.0; with a 16x16x2 batch of uint8 data the true batch
    # var of normalized inputs differs from 1 — a 0.99 EMA would still be
    # ~0.99*init. Check the stem stats moved far from init in one step.
    stem_mean = np.asarray(trainer.bn_stats["stem"]["bn0"]["mean"])
    assert np.any(np.abs(stem_mean) > 1e-3)  # init was exactly 0
    stem_var = np.asarray(trainer.bn_stats["stem"]["bn0"]["var"])
    assert np.any(np.abs(stem_var - 1.0) > 0.05)  # far from init in 1 step


def test_train_step_lowers_without_gathers():
    """Round 2's 9x training speedup came from eliminating per-pixel
    gathers (loss/weighting take_along_axis) whose scatter transposes
    dominated the backward. Guard the whole fused step's lowering so they
    cannot creep back in."""
    import re

    import jax
    from annonet_jax.data.crop import CropOptions
    from annonet_jax.models.segnet import init_state
    from annonet_jax.train.trainer import make_fused_train_step

    cfg = SegNetConfig(class_count=3, level_count=2, base_width=8)
    co = CropOptions(
        dim=32,
        allow_flip_left_right=True,
        noise_level_stddev=2.0,
        multiplicative_brightness_change_probability=0.5,
        allow_random_color_offset=True,
    )
    step = make_fused_train_step(cfg, TrainerConfig(), co)
    params, stats = init_state(jax.random.PRNGKey(0), cfg)
    vel = jax.tree_util.tree_map(jnp.zeros_like, params)
    im = jnp.zeros((2, 32, 32, 3), jnp.uint8)
    lb = jnp.zeros((2, 32, 32), jnp.uint16)
    txt = jax.jit(step).lower(
        params, stats, vel, jnp.float32(0.1), jnp.float32(0.9),
        jax.random.PRNGKey(1), im, lb,
    ).as_text()
    offenders = [
        line.strip()[:120]
        for line in txt.splitlines()
        if re.search(r"stablehlo\.[a-z_]*(gather|scatter)", line)
    ]
    assert not offenders, offenders


def test_verbose_progress_lines_with_batched_flush(capsys):
    """With loss_sync_interval > 1, the per-100-step progress line must
    print exactly once per 100 RECORDED losses (keyed on the recorded
    count, not step_count — a batched flush records several losses under
    one step_count)."""
    from annonet_jax.models.segnet import SegNetConfig
    from annonet_jax.data.crop import CropOptions
    from annonet_jax.train import Trainer, TrainerConfig

    mc = SegNetConfig(
        class_count=2, level_count=0, base_width=4, compute_dtype="float32"
    )
    co = CropOptions(dim=16)
    trainer = Trainer(
        mc,
        TrainerConfig(
            initial_learning_rate=0.01, loss_sync_interval=8, verbose=True
        ),
        seed=0,
    )
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    labels = rng.integers(0, 2, (2, 16, 16)).astype(np.uint16)
    for _ in range(210):
        trainer.train_step_crops(images, labels, co)
    trainer.flush_losses()
    out = capsys.readouterr().out
    lines = [
        ln for ln in out.splitlines()
        if ln.startswith("step ") and "average loss" in ln
    ]
    assert [ln.split(":")[0] for ln in lines] == ["step 100", "step 200"], lines


def test_non_finite_loss_raises():
    """A NaN/inf loss poisons the parameters (the update already ran), so
    recording it must raise instead of cycling the plateau detector on NaN
    forever; the CLI's training-loop catch maps this to exit 2."""
    import math

    import pytest

    config = SegNetConfig(class_count=2, level_count=0, base_width=4)
    trainer = Trainer(config, TrainerConfig())
    with pytest.raises(RuntimeError, match="diverged"):
        trainer._record_loss(float("nan"))
    with pytest.raises(RuntimeError, match="diverged"):
        trainer._record_loss(math.inf)
