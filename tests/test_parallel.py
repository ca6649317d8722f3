"""Data-parallel tests on the virtual 8-device CPU mesh (SURVEY.md §4)."""

import jax
import numpy as np
import pytest

from annonet_jax.data.crop import CropOptions
from annonet_jax.models.segnet import SegNetConfig
from annonet_jax.parallel.mesh import make_mesh
from annonet_jax.parallel.train import DataParallelTrainer, make_dp_train_step
from annonet_jax.train.trainer import Trainer, TrainerConfig


def test_mesh_uses_all_devices():
    mesh = make_mesh()
    assert mesh.shape["batch"] == len(jax.devices()) == 8


def test_mesh_subset_and_validation():
    mesh = make_mesh(4)
    assert mesh.shape["batch"] == 4
    with pytest.raises(ValueError):
        make_mesh(100)


def make_batch(n=8, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(n, dim, dim, 3), dtype=np.uint8)
    labels = rng.integers(0, 2, size=(n, dim, dim)).astype(np.uint16)
    return images, labels


def test_dp_step_matches_single_device():
    """The DP update on 8 devices must equal the single-device update
    (identical batch, no stochastic augmentation)."""
    mc = SegNetConfig(
        class_count=2, level_count=1, base_width=4, compute_dtype="float32"
    )
    tc = TrainerConfig(initial_learning_rate=0.01)
    co = CropOptions(dim=16)  # no augmentation enabled
    images, labels = make_batch()

    single = Trainer(mc, tc, seed=0)
    dp = DataParallelTrainer(mc, tc, seed=0, mesh=make_mesh(8))

    loss_single = single.train_step_crops(images, labels, co)
    loss_dp = dp.train_step_crops(images, labels, co)

    # sync BN makes DP compute the SAME function as single-device; only
    # float reduction-order noise remains
    assert np.isclose(loss_single, loss_dp, rtol=1e-4), (
        loss_single, loss_dp,
    )
    for s, d in zip(
        jax.tree_util.tree_leaves(single.params),
        jax.tree_util.tree_leaves(dp.params),
    ):
        np.testing.assert_allclose(
            np.asarray(s), np.asarray(d), rtol=1e-3, atol=1e-5
        )
    for s, d in zip(
        jax.tree_util.tree_leaves(single.bn_stats),
        jax.tree_util.tree_leaves(dp.bn_stats),
    ):
        np.testing.assert_allclose(
            np.asarray(s), np.asarray(d), rtol=1e-3, atol=1e-5
        )


def test_dp_step_trains():
    mc = SegNetConfig(
        class_count=2, level_count=1, base_width=4, compute_dtype="float32"
    )
    tc = TrainerConfig(initial_learning_rate=0.05)
    co = CropOptions(dim=16, allow_flip_left_right=True, noise_level_stddev=2.0)
    dp = DataParallelTrainer(mc, tc, seed=1, mesh=make_mesh(8))

    rng = np.random.default_rng(0)
    losses = []
    for step in range(10):
        # separable task: class = bright vs dark
        labels = rng.integers(0, 2, size=(16, 16, 16)).astype(np.uint16)
        images = np.where(
            labels[..., None] == 1, 200, 50
        ).astype(np.uint8).repeat(3, axis=-1)
        losses.append(dp.train_step_crops(images, labels, co))
    assert losses[-1] < losses[0]
    assert dp.step_count == 10


def test_tile_parallel_inference_matches_single_device():
    from annonet_jax.infer.core import TiledInferer, annonet_infer
    from annonet_jax.infer.tiling import TilingParameters
    from annonet_jax.models.segnet import fold_batchnorm, init_state

    mc = SegNetConfig(
        class_count=3, level_count=1, base_width=4, compute_dtype="float32"
    )
    params, stats = init_state(jax.random.PRNGKey(0), mc)
    runtime = fold_batchnorm(params, stats, mc)
    rng = np.random.default_rng(2)
    image = rng.integers(0, 256, size=(96, 96, 3), dtype=np.uint8)
    tiling = TilingParameters(48, 48, 8, 8)

    single = TiledInferer(runtime, mc, tiling)
    sharded = TiledInferer(runtime, mc, tiling, mesh=make_mesh(8))
    labels_single = annonet_infer(single, image)
    labels_sharded = annonet_infer(sharded, image)
    np.testing.assert_array_equal(labels_single, labels_sharded)


def test_dp_rejects_indivisible_batch():
    mc = SegNetConfig(
        class_count=2, level_count=1, base_width=4, compute_dtype="float32"
    )
    dp = DataParallelTrainer(mc, TrainerConfig(), mesh=make_mesh(8))
    images, labels = make_batch(n=6)
    with pytest.raises(ValueError, match="divisible"):
        dp.train_step_crops(images, labels, CropOptions(dim=16))
