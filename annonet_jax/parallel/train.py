"""Data-parallel training: shard_map over a device mesh with gradient psum.

The accelerator scale-out of the reference's single-device trainer
(SURVEY.md §2.3): the minibatch is sharded over the mesh "batch" axis, each
device runs the fused augment + weight + forward/backward step on its shard,
gradients/losses are all-reduced over ICI (lax.pmean), and the identical SGD
update keeps parameters replicated without any explicit broadcast.

Batch normalization is CROSS-REPLICA ("sync BN"): the per-layer batch
statistics are all-reduced over the mesh axis inside the forward pass
(apply_train's axis_name), so the data-parallel step computes exactly the
same function — and the same gradients — as the single-device step on the
full batch. The extra collectives move only 2*C floats per BN layer.
"""

from __future__ import annotations


from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from annonet_jax.models.segnet import SegNetConfig, apply_train
from annonet_jax.ops.augment import augment_batch
from annonet_jax.ops.loss import weighted_pixel_cross_entropy
from annonet_jax.ops.weighting import batched_label_weights
from annonet_jax.train.trainer import Trainer, TrainerConfig
from annonet_jax.utils.compile_opts import opt_jit


def _make_local_step(
    model_config: SegNetConfig,
    trainer_config: TrainerConfig,
    crop_options,  # annonet_jax.data.crop.CropOptions
    axis: str,
    flips_pre_applied: bool = False,
) -> Callable:
    """The per-device step body shared by every DP entry point:

    (params, bn_stats, velocity, lr, bn_momentum, key, images, labels)
        -> (params, bn_stats, velocity, loss)

    ``key`` must already be device-local (callers fold in the axis index);
    ``images``/``labels`` are the device's batch shard. Augmentation, loss
    weighting, forward/backward with sync BN, loss pmean-before-grad, and
    the SGD update — identical math to the single-device fused step.
    ``flips_pre_applied``: crops were mirrored at extraction time (the pool
    gather's flip path); augment_batch skips flips but keeps its key
    stream.
    """
    mu = trainer_config.momentum
    wd = trainer_config.weight_decay
    co = crop_options

    def loss_fn(params, bn_stats, bn_momentum, images, labels, weights):
        use_folded = (
            trainer_config.folded_training
            and not trainer_config.remat
            and images.shape[2] % 8 == 0
            # grayscale folds to an 8-channel stem input, which once hit a
            # pathological compile time (DESIGN.md par.10); the unfolded
            # path is also the default at training shapes
            and model_config.in_channels >= 3
        )
        if use_folded:
            from annonet_jax.models.folded_runtime import apply_train_folded

            logits, new_stats = apply_train_folded(
                params, bn_stats, images, model_config,
                bn_momentum=bn_momentum, axis_name=axis, fold0=8,
            )
        else:
            conv_impl = None
            if trainer_config.int8_forward:
                from annonet_jax.ops.int8_train import int8_conv_ste

                conv_impl = int8_conv_ste
            logits, new_stats = apply_train(
                params,
                bn_stats,
                images,
                model_config,
                bn_momentum=bn_momentum,
                axis_name=axis,  # sync BN over the mesh
                remat=trainer_config.remat,
                conv_impl=conv_impl,
            )
        loss = weighted_pixel_cross_entropy(logits, labels, weights)
        # all-reduce the loss BEFORE differentiation: with sync BN the loss
        # is coupled across devices, so grad-then-pmean would mis-route the
        # cross-device cotangents; grad of the pmean'd scalar yields the
        # exact global-batch gradient, replicated, with no extra collective
        # (the psum rides the BN transposes over ICI)
        loss = lax.pmean(loss, axis)
        return loss, new_stats

    def local_step(params, bn_stats, velocity, lr, bn_momentum, key, images,
                   labels):
        labels = labels.astype(jnp.int32)  # shipped uint16, widened on device
        images_f, labels = augment_batch(
            key,
            images,
            labels,
            flips_pre_applied=flips_pre_applied,
            allow_flip_left_right=co.allow_flip_left_right,
            allow_flip_upside_down=co.allow_flip_upside_down,
            multiplicative_brightness_change_probability=(
                co.multiplicative_brightness_change_probability
            ),
            multiplicative_brightness_change_sigma=(
                co.multiplicative_brightness_change_sigma
            ),
            noise_level_stddev=co.noise_level_stddev,
            allow_random_color_offset=co.allow_random_color_offset,
        )
        weights = batched_label_weights(
            labels, co.class_weight, co.image_weight, model_config.class_count
        )
        # loss/stats/grads come out replicated: the loss is pmean'd inside
        # loss_fn and the BN stats are pmean'd inside apply_train
        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, bn_stats, bn_momentum, images_f, labels, weights
        )

        def upd(p, v, g):
            decay = wd * p if p.ndim == 4 else 0.0
            v = mu * v - lr * (g + decay)
            return p + v, v

        flat_p, treedef = jax.tree_util.tree_flatten(params)
        flat_v = treedef.flatten_up_to(velocity)
        flat_g = treedef.flatten_up_to(grads)
        new_pv = [upd(p, v, g) for p, v, g in zip(flat_p, flat_v, flat_g)]
        new_params = jax.tree_util.tree_unflatten(
            treedef, [p for p, _ in new_pv]
        )
        new_velocity = jax.tree_util.tree_unflatten(
            treedef, [v for _, v in new_pv]
        )
        return new_params, new_stats, new_velocity, loss

    return local_step


def make_dp_train_step(
    model_config: SegNetConfig,
    trainer_config: TrainerConfig,
    crop_options,  # annonet_jax.data.crop.CropOptions
    mesh: Mesh,
    axis: str = "batch",
) -> Callable:
    """Build the jitted data-parallel train step.

    (params, bn_stats, velocity, lr, bn_momentum, key, images, labels)
        -> (params, bn_stats, velocity, loss)

    ``images``/``labels`` are global arrays whose leading (batch) dimension
    is sharded over ``axis``; everything else is replicated. The per-device
    body is identical to the single-device fused step plus three pmeans
    (grads, loss, BN stats). ``bn_momentum`` is a traced scalar following
    dlib's windowed-stats schedule (trainer.bn_momentum_for_step).
    """
    inner = _make_local_step(model_config, trainer_config, crop_options, axis)

    def local_step(params, bn_stats, velocity, lr, bn_momentum, key, images,
                   labels):
        # decorrelate augmentation randomness across devices
        key = jax.random.fold_in(key, lax.axis_index(axis))
        return inner(
            params, bn_stats, velocity, lr, bn_momentum, key, images, labels
        )

    replicated = P()
    batch_sharded = P(axis)
    sharded = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            replicated,  # params
            replicated,  # bn_stats
            replicated,  # velocity
            replicated,  # lr
            replicated,  # bn_momentum
            replicated,  # key
            batch_sharded,  # images
            batch_sharded,  # labels
        ),
        out_specs=(replicated, replicated, replicated, replicated),
    )
    return opt_jit(sharded)


def _make_dp_pool_local(
    model_config: SegNetConfig,
    trainer_config: TrainerConfig,
    crop_options,
    dim: int,
    mesh: Mesh,
    axis: str,
) -> Callable:
    """The per-device POOL step body: decisions in, update out.

    (params, bn_stats, velocity, lr, bn_momentum, key,
     pool_images, pool_labels, packed[5, B])
        -> (params, bn_stats, velocity, loss)

    The pool arrays and the packed decisions arrive REPLICATED; each device
    slices its own B/N decision columns and gathers only its crops from its
    pool replica (no collectives, no pixels host->device) — the DP analog
    of trainer.make_fused_pool_step, with the flips likewise riding the
    gather's permutation matmuls (ops/crop_gather.py)."""
    from annonet_jax.ops.augment import flip_decisions
    from annonet_jax.ops.crop_gather import gather_crops_packed

    co = crop_options
    flips_in_gather = bool(
        co.allow_flip_left_right or co.allow_flip_upside_down
    )
    inner = _make_local_step(
        model_config, trainer_config, crop_options, axis,
        flips_pre_applied=flips_in_gather,
    )
    n = int(mesh.shape[axis])

    def pool_local(params, bn_stats, velocity, lr, bn_momentum, key,
                   pool_images, pool_labels, packed):
        idx = lax.axis_index(axis)
        b_local = packed.shape[1] // n
        local = lax.dynamic_slice_in_dim(packed, idx * b_local, b_local, 1)
        # same per-device key as the pixel path (fold_in BEFORE flips, so
        # the flip booleans match augment_batch's on this device's shard)
        key = jax.random.fold_in(key, idx)
        flip_lr, flip_ud = flip_decisions(
            key, b_local, co.allow_flip_left_right, co.allow_flip_upside_down
        )
        images, labels = gather_crops_packed(
            pool_images, pool_labels, local, dim,
            flip_lr=flip_lr, flip_ud=flip_ud,
        )
        return inner(
            params, bn_stats, velocity, lr, bn_momentum, key, images, labels
        )

    return pool_local


def _dp_pool_in_specs():
    r = P()
    return (r, r, r, r, r, r, r, r, r)


def make_dp_pool_step(
    model_config: SegNetConfig,
    trainer_config: TrainerConfig,
    crop_options,
    dim: int,
    mesh: Mesh,
    axis: str = "batch",
) -> Callable:
    """ONE-program data-parallel pool step (gather fused into the
    shard_mapped update): one XLA dispatch per train step under --mesh,
    like the single-device make_fused_pool_step."""
    pool_local = _make_dp_pool_local(
        model_config, trainer_config, crop_options, dim, mesh, axis
    )
    replicated = P()
    sharded = shard_map(
        pool_local,
        mesh=mesh,
        in_specs=_dp_pool_in_specs(),
        out_specs=(replicated,) * 4,
    )
    return opt_jit(sharded)


def make_dp_pool_superstep(
    model_config: SegNetConfig,
    trainer_config: TrainerConfig,
    crop_options,
    dim: int,
    k: int,
    mesh: Mesh,
    axis: str = "batch",
) -> Callable:
    """lax.scan ``k`` DP pool steps into ONE XLA dispatch (the --mesh analog
    of trainer.make_fused_pool_superstep; same signature and key-carry
    semantics, every scan iteration identical to one make_dp_pool_step):

    (params, bn_stats, velocity, lr, bn_momenta[k], carry_key,
     pool_images, pool_labels, packed[k, 5, B])
        -> (params, bn_stats, velocity, losses[k], next_carry)
    """
    pool_local = _make_dp_pool_local(
        model_config, trainer_config, crop_options, dim, mesh, axis
    )

    def superstep_local(params, bn_stats, velocity, lr, bn_momenta,
                        carry_key, pool_images, pool_labels, packed):
        assert bn_momenta.shape[0] == packed.shape[0] == k, (
            bn_momenta.shape, packed.shape, k
        )

        def body(carry, xs):
            p, b, v, key = carry
            momentum, pk = xs
            next_key, step_key = jax.random.split(key)
            p, b, v, loss = pool_local(
                p, b, v, lr, momentum, step_key, pool_images, pool_labels, pk
            )
            return (p, b, v, next_key), loss

        (params, bn_stats, velocity, carry_key), losses = jax.lax.scan(
            body, (params, bn_stats, velocity, carry_key),
            (bn_momenta, packed),
        )
        return params, bn_stats, velocity, losses, carry_key

    replicated = P()
    sharded = shard_map(
        superstep_local,
        mesh=mesh,
        in_specs=_dp_pool_in_specs(),
        out_specs=(replicated,) * 5,
    )
    return opt_jit(sharded)


class DataParallelTrainer(Trainer):
    """Trainer whose raw-crop step runs data-parallel over a mesh.

    Same plateau/LR/sync behavior as Trainer; only the device step differs.
    The minibatch size must divide by the mesh's batch-axis size (the CLI
    pads the final partial batch by repetition if needed).
    """

    def __init__(
        self,
        model_config: SegNetConfig,
        trainer_config: TrainerConfig = TrainerConfig(),
        seed: int = 0,
        mesh: Optional[Mesh] = None,
        axis: str = "batch",
    ):
        super().__init__(model_config, trainer_config, seed=seed)
        if mesh is None:
            from annonet_jax.parallel.mesh import make_mesh

            mesh = make_mesh(axis_names=(axis,))
        self.mesh = mesh
        self.axis = axis
        self._dp_step_fn = None
        # Multi-host: the mesh spans processes (--coordinator). The model
        # is SPMD with host replication — every process runs the identical
        # host program on the identical data, so replicated inputs are
        # consistent by construction. Trainer state must start as global
        # replicated arrays (a single-device-committed array would be
        # rejected by the mesh programs), non-zero ranks skip file writes,
        # and time-triggered sync saves must not flush (trainer.py).
        self._multiprocess = (
            len({d.process_index for d in np.asarray(mesh.devices).ravel()})
            > 1
        )
        if self._multiprocess:
            replicated = NamedSharding(mesh, P())
            as_global = lambda tree: jax.device_put(  # noqa: E731
                jax.tree_util.tree_map(np.asarray, tree), replicated
            )
            self.params = as_global(self.params)
            self.bn_stats = as_global(self.bn_stats)
            self.velocity = as_global(self.velocity)
            self.io_process = jax.process_index() == 0
            self.sync_flush = False

    @property
    def device_count(self) -> int:
        return int(self.mesh.shape[self.axis])

    def _build_pool_step_fn(self, dim, crop_options):
        # ONE shard_mapped program per step: each device slices its
        # decision columns and gathers its crops from its pool replica
        from annonet_jax.train.trainer import with_key_carry

        return opt_jit(
            with_key_carry(
                make_dp_pool_step(
                    self.model_config, self.config, crop_options, dim,
                    self.mesh, self.axis,
                )
            )
        )

    def _build_pool_superstep_fn(self, dim, crop_options, k):
        return make_dp_pool_superstep(
            self.model_config, self.config, crop_options, dim, k,
            self.mesh, self.axis,
        )

    def _decision_batch_multiple(self) -> int:
        return self.device_count

    def train_step_crops(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        crop_options,
        seed: int = 0,
    ) -> float:
        # a pixel batch (e.g. the pipeline's pin-budget fallback) must not
        # overtake buffered superstep decisions — same contract as the
        # base Trainer.train_step_crops: flush them first so step order
        # and the BN-momentum schedule stay sequential
        self.flush_pending_steps()
        n = self.device_count
        if images.shape[0] % n:
            raise ValueError(
                f"minibatch size {images.shape[0]} must be divisible by the "
                f"mesh batch-axis size {n}"
            )
        if self._dp_step_fn is None:
            from annonet_jax.train.trainer import with_key_carry

            # the key split runs inside the same jit (one dispatch/step);
            # the inner jitted DP program is inlined by the outer trace
            self._dp_step_fn = opt_jit(
                with_key_carry(
                    make_dp_train_step(
                        self.model_config, self.config, crop_options,
                        self.mesh, self.axis,
                    )
                )
            )
        self._ensure_fused_key(seed)

        batch_sharding = NamedSharding(self.mesh, P(self.axis))

        def to_device(x):
            # device arrays (the pool gather's output, already
            # batch-sharded) pass straight through — np.asarray would
            # round-trip the crop pixels through the host
            if isinstance(x, jax.Array):
                return x
            arr = np.asarray(x)
            if self._multiprocess:
                # every process holds the identical full batch (SPMD host
                # replication); each contributes its addressable shards
                return jax.make_array_from_callback(
                    arr.shape, batch_sharding, lambda idx: arr[idx]
                )
            return jax.device_put(arr, batch_sharding)

        images_dev = to_device(images)
        labels_dev = to_device(labels)
        (
            self.params,
            self.bn_stats,
            self.velocity,
            loss,
            self._fused_key,
        ) = self._dp_step_fn(
            self.params,
            self.bn_stats,
            self.velocity,
            np.float32(self.learning_rate),
            np.float32(self._bn_momentum()),
            self._fused_key,
            images_dev,
            labels_dev,
        )
        return self._finish_step(loss)
