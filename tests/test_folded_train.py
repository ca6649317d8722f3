"""Folded training forward == segnet.apply_train exactly (float32)."""

import jax
import numpy as np
import pytest

from annonet_jax.models.folded_runtime import apply_train_folded
from annonet_jax.models.segnet import SegNetConfig, apply_train, init_state


@pytest.mark.parametrize("level_count", [0, 1, 2, 3])
def test_folded_train_forward_matches(level_count):
    config = SegNetConfig(
        class_count=3,
        level_count=level_count,
        base_width=4,
        compute_dtype="float32",
    )
    params, stats = init_state(jax.random.PRNGKey(level_count), config)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(2, 16, 32, 3), dtype=np.uint8)

    ref_logits, ref_stats = apply_train(params, stats, x, config, 0.9)
    got_logits, got_stats = apply_train_folded(
        params, stats, x, config, 0.9, fold0=8
    )
    np.testing.assert_allclose(
        np.asarray(got_logits), np.asarray(ref_logits), rtol=1e-4, atol=1e-4
    )
    for a, b in zip(
        jax.tree_util.tree_leaves(ref_stats),
        jax.tree_util.tree_leaves(got_stats),
    ):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=1e-4, atol=1e-5
        )


def test_folded_train_gradients_match():
    """Gradients w.r.t. the ORIGINAL parameters must match the unfolded
    path (the kernel folding is linear)."""
    import jax.numpy as jnp

    config = SegNetConfig(
        class_count=2, level_count=2, base_width=4, compute_dtype="float32"
    )
    params, stats = init_state(jax.random.PRNGKey(3), config)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.integers(0, 256, size=(1, 16, 16, 3), dtype=np.uint8))

    def loss_ref(p):
        logits, _ = apply_train(p, stats, x, config, 0.9)
        return jnp.sum(logits**2)

    def loss_folded(p):
        logits, _ = apply_train_folded(p, stats, x, config, 0.9, fold0=8)
        return jnp.sum(logits**2)

    g_ref = jax.grad(loss_ref)(params)
    g_folded = jax.grad(loss_folded)(params)
    for a, b in zip(
        jax.tree_util.tree_leaves(g_ref), jax.tree_util.tree_leaves(g_folded)
    ):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=1e-3, atol=1e-4
        )
