"""The multi-device equivalence check: data-parallel training and
tile-parallel inference over a mesh against the single-device programs.

One function, ``multichip_check``, shared by the virtual-CPU dry run
(__graft_entry__.dryrun_multichip) and the on-card smoke test
(chip_smoke.py --four-cards). Everything runs under
``jax.default_matmul_precision("highest")``, so a float32 product on a GPU
does not drop to TF32 and the stated tolerances hold on every backend:

* one DP step (sync BN, pmean-before-grad) == the single-device step:
  loss to rtol 1e-4, params and BN stats to rtol 1e-3 / atol 1e-5;
* ten DP steps with the full augmentation path reduce the loss;
* DP crop decisions against a mesh-replicated device image pool == the
  same crops uploaded as pixels (loss rtol 1e-4);
* the DP scan superstep == the same steps dispatched one by one;
* tile-parallel labels == single-device labels, bit for bit.

It also asserts that the mesh and the DP trainer's state span all of the
mesh's devices, so nothing silently runs on the first one alone.
"""

from __future__ import annotations

from typing import Optional


def _require(ok, message="check failed") -> None:
    """A check that stays on under ``python -O``, unlike ``assert``."""
    if not ok:
        raise AssertionError(message)


def multichip_check(
    mesh,
    config=None,
    crop_dim: int = 16,
    crops_per_device: int = 2,
    image_size: int = 64,
    tile: int = 32,
) -> dict:
    """Run every check over ``mesh``; raises AssertionError on the first
    that fails and returns the measured values otherwise."""
    import jax

    with jax.default_matmul_precision("highest"):
        return _check(
            mesh, config, crop_dim, crops_per_device, image_size, tile
        )


def _check(mesh, config: Optional[object], crop_dim: int,
           crops_per_device: int, image_size: int, tile: int) -> dict:
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec

    from annonet_jax.data.crop import CropOptions, extract_crop
    from annonet_jax.infer.core import TiledInferer, annonet_infer
    from annonet_jax.infer.tiling import TilingParameters
    from annonet_jax.models.segnet import SegNetConfig
    from annonet_jax.parallel.train import DataParallelTrainer
    from annonet_jax.train.device_cache import DeviceImagePool
    from annonet_jax.train.trainer import Trainer, TrainerConfig

    n_devices = mesh.devices.size
    mesh_devices = set(mesh.devices.flat)
    _require(len(mesh_devices) == n_devices, (
        f"mesh repeats devices: {mesh.devices}"
    ))
    model_config = config or SegNetConfig(
        class_count=3, level_count=2, base_width=8, compute_dtype="float32"
    )
    trainer_config = TrainerConfig(initial_learning_rate=0.05)
    dim = crop_dim
    rng = np.random.default_rng(0)
    batch = crops_per_device * n_devices

    # --- 1. The DP step over n devices computes the SAME function as the
    # single-device fused step. A wrong collective placement that still
    # yields a finite loss fails HERE, not just on a crash
    # (tests/test_parallel.py::test_dp_step_matches_single_device is the
    # in-repo version of this check).
    no_aug = CropOptions(dim=dim)
    images = rng.integers(0, 256, size=(batch, dim, dim, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, size=(batch, dim, dim)).astype(np.uint16)

    single = Trainer(model_config, trainer_config, seed=0)
    dp = DataParallelTrainer(model_config, trainer_config, seed=0, mesh=mesh)
    loss_single = float(single.train_step_crops(images, labels, no_aug))
    loss_dp = float(dp.train_step_crops(images, labels, no_aug))
    _require(np.isfinite(loss_dp), f"non-finite DP loss {loss_dp}")
    _require(np.isclose(loss_single, loss_dp, rtol=1e-4), (
        f"DP loss {loss_dp} != single-device loss {loss_single}"
    ))
    for leaf in jax.tree_util.tree_leaves(dp.params):
        _require(set(leaf.sharding.device_set) == mesh_devices, (
            f"DP params live on {leaf.sharding.device_set}, not the mesh"
        ))
    worst = {"params": 0.0, "bn_stats": 0.0}
    for name in worst:
        for s, d in zip(
            jax.tree_util.tree_leaves(getattr(single, name)),
            jax.tree_util.tree_leaves(getattr(dp, name)),
        ):
            s, d = np.asarray(s), np.asarray(d)
            np.testing.assert_allclose(
                s, d, rtol=1e-3, atol=1e-5,
                err_msg=f"DP {name} diverged from the single-device step",
            )
            worst[name] = max(worst[name], float(np.max(np.abs(s - d))))

    # --- 2. Ten DP steps on a separable task (with the full augmentation
    # path enabled) must reduce the loss.
    aug = CropOptions(
        dim=dim,
        allow_flip_left_right=True,
        allow_flip_upside_down=True,
        multiplicative_brightness_change_probability=0.5,
        noise_level_stddev=2.0,
        allow_random_color_offset=True,
    )
    losses = []
    for _ in range(10):
        step_labels = rng.integers(0, 2, size=(batch, dim, dim)).astype(
            np.uint16
        )
        step_images = (
            np.where(step_labels[..., None] == 1, 200, 50)
            .astype(np.uint8)
            .repeat(3, axis=-1)
        )
        losses.append(
            float(dp.train_step_crops(step_images, step_labels, aug))
        )
    _require(losses[-1] < losses[0], (
        f"10-step DP loss did not decrease: {losses[0]} -> {losses[-1]}"
    ))

    # --- 3. The replicated device-image pool feeding the DP step: crop
    # DECISIONS against a mesh-replicated pool must train identically to
    # uploading the same crops' pixels (the multi-device decision path;
    # tests/test_device_cache.py::test_dp_pool_decisions_match_dp_pixels).
    class _Sample:
        def __init__(self, img, lab):
            self.input_image = img
            self.label_image = lab

    pool = DeviceImagePool(
        slots=2, sharding=NamedSharding(mesh, PartitionSpec())
    )
    sample_h, sample_w = 2 * dim + 8, 3 * dim
    sample = _Sample(
        rng.integers(0, 256, size=(sample_h, sample_w, 3), dtype=np.uint8),
        rng.integers(0, 3, size=(sample_h, sample_w)).astype(np.uint16),
    )
    rects = [
        (int(x), int(y), int(x) + dim - 1, int(y) + dim - 1)
        for x, y in zip(
            rng.integers(-4, sample_w - dim + 4, size=batch),
            rng.integers(-4, sample_h - dim + 4, size=batch),
        )
    ]
    dp_pool = DataParallelTrainer(
        model_config, trainer_config, seed=0, mesh=mesh
    )
    dp_pix = DataParallelTrainer(
        model_config, trainer_config, seed=0, mesh=mesh
    )
    loss_pool = dp_pool.train_step_decisions(
        pool, [sample] * batch, rects, aug, seed=3
    )
    crops = [
        extract_crop(sample.input_image, sample.label_image, r)
        for r in rects
    ]
    loss_pix = dp_pix.train_step_crops(
        np.stack([c[0] for c in crops]),
        np.stack([c[1] for c in crops]),
        aug,
        seed=3,
    )
    _require(np.isclose(loss_pool, loss_pix, rtol=1e-4), (
        f"DP pool-decision loss {loss_pool} != DP pixel loss {loss_pix}"
    ))

    # --- 4. The DP scan superstep: K decision steps in ONE shard_mapped
    # lax.scan dispatch must reproduce K single DP dispatches (the --mesh
    # --steps-per-dispatch path; tests/test_device_cache.py::
    # test_dp_superstep_matches_dp_single_dispatches).
    super_cfg = TrainerConfig(
        initial_learning_rate=0.05, steps_per_dispatch=2,
        loss_sync_interval=2,
    )
    dp_super = DataParallelTrainer(model_config, super_cfg, seed=0, mesh=mesh)
    dp_ref = DataParallelTrainer(
        model_config, trainer_config, seed=0, mesh=mesh
    )
    ref_losses = []
    for _ in range(2):
        dp_super.train_step_decisions(
            pool, [sample] * batch, rects, aug, seed=3
        )
        ref_losses.append(
            dp_ref.train_step_decisions(
                pool, [sample] * batch, rects, aug, seed=3
            )
        )
    dp_super.flush_pending_steps()
    dp_super.flush_losses()
    _require(dp_super.step_count == 2)
    _require(np.allclose(dp_super.previous_loss_values, ref_losses, rtol=1e-4), (
        f"DP superstep losses {dp_super.previous_loss_values} != "
        f"single-dispatch DP losses {ref_losses}"
    ))

    # --- 5. Tile-parallel (spatial-parallel) inference over the same mesh
    # must match single-device tiled inference bit for bit.
    runtime = dp.runtime_net()
    overlap = max(8, tile // 4)
    tiling = TilingParameters(tile, tile, overlap, overlap)
    image = rng.integers(
        0, 256, size=(image_size, image_size, 3), dtype=np.uint8
    )
    sharded = TiledInferer(runtime, model_config, tiling, mesh=mesh)
    unsharded = TiledInferer(runtime, model_config, tiling)
    result = annonet_infer(sharded, image)
    _require(result.shape == (image_size, image_size))
    reference = annonet_infer(unsharded, image)
    differing = int(np.count_nonzero(result != reference))
    _require(differing == 0, (
        f"tile-parallel labels differ from single-device at {differing} px"
    ))
    return {
        "devices": n_devices,
        "loss_dp": loss_dp,
        "loss_single": loss_single,
        "max_abs_param_diff": worst["params"],
        "max_abs_bn_stat_diff": worst["bn_stats"],
        "loss_10_steps": (losses[0], losses[-1]),
        "loss_pool": float(loss_pool),
        "loss_pixels": float(loss_pix),
        "tile_parallel_pixels_differing": differing,
    }
