"""The training driver: SGD + plateau-driven learning-rate decay.

Replaces the dlib dnn_trainer semantics behind NetPimpl::TrainingNet
(call sites at annonet_train_main.cpp:396-410,569-577,609):

  * momentum SGD with weight decay (dlib defaults: momentum 0.9, wd 5e-4)
  * a window of recent loss values; when both the plain and robust
    steps-without-decrease counts exceed
    ``iterations_without_progress_threshold``, the learning rate is
    multiplied by ``learning_rate_shrink_factor`` and the window clears
    (GetLearningRate then drives the stop condition at
    annonet_train_main.cpp:569-571)
  * a synchronization file written at most every ``sync_interval_seconds``
    (SetSynchronizationFile(..., 10min), annonet_train_main.cpp:403) holding
    the FULL training state, auto-resumed on construction
  * BN running-stats window (SetAllBatchNormalizationRunningStatsWindowSizes)
    mapped to an EMA momentum of 1 - 1/window

Accelerator-first: the whole update (forward, loss, backward, SGD, BN-stats EMA) is
ONE jitted function; uint8 crops and uint16 labels cross the host->device
boundary, everything else stays on device. The pure step function is exposed
as ``make_train_step`` so annonet_jax.parallel can wrap it in shard_map for
data parallelism without touching this class.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from annonet_jax import serialization
from annonet_jax.models.segnet import (
    SegNetConfig,
    apply_train,
    fold_batchnorm,
    init_state,
)
from annonet_jax.ops.augment import augment_batch
from annonet_jax.utils.compile_opts import opt_jit
from annonet_jax.ops.loss import weighted_pixel_cross_entropy
from annonet_jax.ops.weighting import batched_label_weights
from annonet_jax.train.plateau import (
    count_steps_without_decrease,
    count_steps_without_decrease_robust,
)


@dataclasses.dataclass
class TrainerConfig:
    """Knobs mirroring the NetPimpl::TrainingNet setters (SURVEY.md §2.2)."""

    initial_learning_rate: float = 0.1  # SetLearningRate
    learning_rate_shrink_factor: float = 0.1  # SetLearningRateShrinkFactor
    min_learning_rate: float = 1e-6
    iterations_without_progress_threshold: int = 4000  # rel_training_len*2000
    previous_loss_values_dump_amount: int = 800  # rel_training_len*400
    bn_stats_window: int = 200  # rel_training_len*100
    momentum: float = 0.9
    weight_decay: float = 0.0005
    remat: bool = False  # rematerialize conv units in backward (memory saver)
    # width-folded training forward (models/folded_runtime.py): identical
    # math (equivalence + gradient tests). Default OFF — at training batch
    # shapes the batch dimension already widens the convs, and the folded
    # forward was the slower one (scripts/profile_train.py times both), so
    # folding targets inference's few-large-tiles shapes.
    folded_training: bool = False
    # int8 FORWARD convs with exact bf16 backward (straight-through;
    # ops/int8_train.py): dynamic abs-max scales, opt-in. A/B numbers in
    # docs/DESIGN.md §12.
    int8_forward: bool = False
    # Device losses are read back in batches of this size: with 1 every step
    # blocks on the device (reference-like); larger values let the host
    # prepare the next minibatches while steps are in flight, at the cost of
    # the plateau detector seeing losses up to that many steps late.
    loss_sync_interval: int = 1
    # lax.scan K pool-fed steps into ONE XLA dispatch (single-device
    # device-pool path only): amortizes per-dispatch host overhead
    # across K steps. Numerically
    # equivalent to K single dispatches (same key stream, per-step BN
    # momenta ride the scan; the scan-body compilation may reorder
    # reductions — equivalence tested to 1e-5). The buffer flushes early (as single steps) whenever
    # a batch references a non-resident image, so pool uploads/evictions
    # never land under buffered decisions. LR/plateau logic already lags
    # via loss_sync_interval; a superstep adds at most K-1 steps of lag.
    steps_per_dispatch: int = 1
    sync_file: Optional[str] = None
    sync_interval_seconds: float = 600.0
    verbose: bool = False


def bn_momentum_for_step(step_count: int, window: int) -> float:
    """dlib's exact BN running-stats schedule (dlib bn_ layer, referenced by
    SetAllBatchNormalizationRunningStatsWindowSizes at
    annonet_train_main.cpp:410): the update factor is 1/min(t, window) for
    the t-th update, i.e. a cumulative average until the window fills, then
    an EMA with momentum 1 - 1/window. ``step_count`` is the number of
    updates already applied (0 on the first step, making the first running
    stats exactly the first batch's stats — no init bias)."""
    return 1.0 - 1.0 / max(1, min(step_count + 1, window))


def make_train_step(
    model_config: SegNetConfig, trainer_config: TrainerConfig
) -> Callable:
    """Build the pure, jittable train-step function.

    (params, bn_stats, velocity, lr, bn_momentum, images, labels, weights)
        -> (params, bn_stats, velocity, loss)

    ``lr`` and ``bn_momentum`` are traced scalars so LR decay and the
    windowed BN-stats schedule (bn_momentum_for_step) never trigger
    recompilation.
    """
    mu = trainer_config.momentum
    wd = trainer_config.weight_decay

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
                bn_momentum=bn_momentum, fold0=8,
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
                remat=trainer_config.remat,
                conv_impl=conv_impl,
            )
        loss = weighted_pixel_cross_entropy(logits, labels, weights)
        return loss, new_stats

    def step(params, bn_stats, velocity, lr, bn_momentum, images, labels,
             weights):
        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, bn_stats, bn_momentum, images, labels, weights
        )

        def upd(p, v, g):
            # weight decay on conv kernels only (not BN affine / biases)
            decay = wd * p if p.ndim == 4 else 0.0
            v = mu * v - lr * (g + decay)
            return p + v, v

        flat_p, treedef = jax.tree_util.tree_flatten(params)
        flat_v = treedef.flatten_up_to(velocity)
        flat_g = treedef.flatten_up_to(grads)
        new_p, new_v = [], []
        for p, v, g in zip(flat_p, flat_v, flat_g):
            np_, nv_ = upd(p, v, g)
            new_p.append(np_)
            new_v.append(nv_)
        return (
            jax.tree_util.tree_unflatten(treedef, new_p),
            new_stats,
            jax.tree_util.tree_unflatten(treedef, new_v),
            loss,
        )

    return step


def make_fused_train_step(
    model_config: SegNetConfig,
    trainer_config: TrainerConfig,
    crop_options,  # annonet_jax.data.crop.CropOptions (duck-typed)
    flips_pre_applied: bool = False,
) -> Callable:
    """Build the fully fused train step: raw uint8 crops in, update out.

    (params, bn_stats, velocity, lr, bn_momentum, key, images_u8, labels_u16)
        -> (params, bn_stats, velocity, loss)

    This is the accelerator-first composition of what the reference does per-crop on
    loader threads (randomly_crop_image's set_weights + augmentations,
    annonet_train_main.cpp:182-231) followed by StartTraining: augmentation,
    loss weighting, normalization, forward, backward, and the SGD update all
    trace into ONE XLA program, so the host only ships 1 byte/pixel.

    ``flips_pre_applied``: the caller mirrored the crops already (the pool
    gather's flip path) — augment_batch skips its flip stages but keeps the
    key stream, so results stay bit-identical.
    """
    inner = make_train_step(model_config, trainer_config)
    co = crop_options

    def step(params, bn_stats, velocity, lr, bn_momentum, key, images,
             labels):
        # labels cross the host->device boundary in their native uint16
        # (2 bytes/pixel; IGNORE_LABEL = 0xFFFF survives) and widen here
        labels = labels.astype(jnp.int32)
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
        return inner(
            params, bn_stats, velocity, lr, bn_momentum, images_f, labels,
            weights
        )

    return step


def make_fused_pool_step(
    model_config: SegNetConfig,
    trainer_config: TrainerConfig,
    crop_options,  # annonet_jax.data.crop.CropOptions (duck-typed)
    dim: int,
) -> Callable:
    """The fused step fed from the HBM-resident image pool, as ONE program.

    (params, bn_stats, velocity, lr, bn_momentum, key,
     pool_images, pool_labels, packed)
        -> (params, bn_stats, velocity, loss)

    ``packed`` is one [5, B] int32 host array — rows (slot, y0, x0,
    valid_h, valid_w) — so the per-step index upload rides the single
    dispatch. Identical math to make_fused_train_step: the on-device
    gather (ops/crop_gather.py) reproduces extract_crop bit-for-bit, so
    only ~20 bytes/crop of indices cross the host->device boundary
    instead of ~dim^2*(C+2) bytes of pixels.

    This single program IS the shipped single-device path (one XLA
    dispatch per train step).

    Flips are applied INSIDE the gather's permutation matmuls (free — a
    mirrored permutation costs the same matmul as the identity) instead
    of as augment_batch's materialized ``reverse`` copies (docs/DESIGN.md
    par.17): flip_decisions draws the same booleans from
    the same key split, so the result is bit-identical to the in-step
    flip path (tested)."""
    from annonet_jax.ops.augment import flip_decisions
    from annonet_jax.ops.crop_gather import gather_crops_packed

    co = crop_options
    flips_in_gather = bool(
        co.allow_flip_left_right or co.allow_flip_upside_down
    )
    inner = make_fused_train_step(
        model_config, trainer_config, crop_options,
        flips_pre_applied=flips_in_gather,
    )

    def step(params, bn_stats, velocity, lr, bn_momentum, key,
             pool_images, pool_labels, packed):
        flip_lr, flip_ud = flip_decisions(
            key, packed.shape[1],
            co.allow_flip_left_right, co.allow_flip_upside_down,
        )
        images, labels = gather_crops_packed(
            pool_images, pool_labels, packed, dim,
            flip_lr=flip_lr, flip_ud=flip_ud,
        )
        # labels are already int32 with IGNORE applied; the inner step's
        # astype(int32) is a no-op on them
        return inner(
            params, bn_stats, velocity, lr, bn_momentum, key, images, labels
        )

    return step


def make_fused_pool_superstep(
    model_config: SegNetConfig,
    trainer_config: TrainerConfig,
    crop_options,
    dim: int,
    k: int,
) -> Callable:
    """lax.scan ``k`` pool-fed train steps into ONE XLA program.

    (params, bn_stats, velocity, lr, bn_momenta[k], carry_key,
     pool_images, pool_labels, packed[k, 5, B])
        -> (params, bn_stats, velocity, losses[k], next_carry)

    Each scan iteration is the with_key_carry'd make_fused_pool_step
    body (same key stream, per-step BN momentum from ``bn_momenta``), so
    a superstep is numerically equivalent to ``k`` single dispatches
    (the scan-body compilation may reorder reductions within float
    tolerance) — only the host/link round trip per step is amortized.
    The image pool is a scan invariant: callers must not upload/evict
    between the buffered decisions (Trainer flushes the buffer on any
    non-resident batch)."""
    inner = with_key_carry(
        make_fused_pool_step(model_config, trainer_config, crop_options, dim)
    )

    def superstep(params, bn_stats, velocity, lr, bn_momenta, carry_key,
                  pool_images, pool_labels, packed):
        assert bn_momenta.shape[0] == packed.shape[0] == k, (
            bn_momenta.shape, packed.shape, k
        )

        def body(carry, xs):
            p, b, v, key = carry
            momentum, idx = xs
            p, b, v, loss, key = inner(
                p, b, v, lr, momentum, key, pool_images, pool_labels, idx
            )
            return (p, b, v, key), loss

        (params, bn_stats, velocity, carry_key), losses = jax.lax.scan(
            body, (params, bn_stats, velocity, carry_key),
            (bn_momenta, packed),
        )
        return params, bn_stats, velocity, losses, carry_key

    return superstep


def with_key_carry(step_fn: Callable) -> Callable:
    """Wrap a fused step so the per-step augmentation-key split happens
    INSIDE the step's XLA program:

    (params, bn_stats, velocity, lr, bn_momentum, carry_key, images, labels)
        -> (params, bn_stats, velocity, loss, next_carry)

    Replaces the host-side ``jax.random.split`` per step — a separate
    tiny-op dispatch whose round-trip latency adds to every step. The key
    STREAM is bit-identical to
    the old host-side unpacking: split(carry) row 0 is the next carry,
    row 1 the step key."""

    def stepped(params, bn_stats, velocity, lr, bn_momentum, carry_key,
                *data):
        next_carry, step_key = jax.random.split(carry_key)
        out = step_fn(params, bn_stats, velocity, lr, bn_momentum, step_key,
                      *data)
        return (*out, next_carry)

    return stepped


class Trainer:
    """Stateful wrapper: owns params/optimizer/LR schedule, checks plateaus,
    writes the sync file, and exports the BN-folded runtime net."""

    def __init__(
        self,
        model_config: SegNetConfig,
        trainer_config: TrainerConfig = TrainerConfig(),
        seed: int = 0,
    ):
        self.model_config = model_config
        self.config = trainer_config
        key = jax.random.PRNGKey(seed)
        self.params, self.bn_stats = init_state(key, model_config)
        self.velocity = jax.tree_util.tree_map(jnp.zeros_like, self.params)
        self.learning_rate = trainer_config.initial_learning_rate
        self.step_count = 0
        # step index of the last RECORDED loss: with batched loss flushes
        # step_count runs ahead of the losses being recorded, so verbose
        # progress lines key off this counter (== step_count when
        # loss_sync_interval == 1)
        self._recorded_steps = 0
        self.previous_loss_values: list = []
        self._pending_losses: list = []
        self.steps_without_progress = 0
        # optional structured-metrics callback: called with a dict for every
        # RECORDED loss ({"event": "loss", step, loss, learning_rate,
        # steps_without_progress}) and each LR shrink
        # ({"event": "learning_rate_shrink", ...}). Under
        # loss_sync_interval > 1 events fire at flush time, in step order —
        # the same lag the plateau detector sees. The CLI wires
        # --metrics-jsonl to this.
        self.metrics_hook = None
        # multi-process (multi-host) coordination: non-zero ranks skip
        # file writes, and time-based sync saves must not flush (a flush
        # DISPATCHES collective programs, and its wall-clock trigger would
        # desynchronize the dispatch sequence across processes — a
        # collective mismatch). DataParallelTrainer sets these when its
        # mesh spans processes; single-process behavior is unchanged.
        self.io_process = True
        self.sync_flush = True
        self._last_sync = time.monotonic()
        # opt_jit == jax.jit unless ANNONET_COMPILER_OPTIONS is set
        # (per-program compiler options, utils/compile_opts.py)
        self._step_fn = opt_jit(make_train_step(model_config, trainer_config))
        self._fused_step_fn = None
        self._fused_key = None
        self._pool_step_fns: Dict[int, Callable] = {}
        # superstep buffer (steps_per_dispatch > 1): (pool, dim, packed
        # [5,B], bn_momentum) per buffered step, dispatched as ONE
        # lax.scan program when full
        self._superstep_buffer: list = []
        self._loss_window_cap = (
            trainer_config.iterations_without_progress_threshold
            + trainer_config.previous_loss_values_dump_amount
        )
        if trainer_config.sync_file:
            self._try_resume(trainer_config.sync_file)

    # ----------------------------------------------------------- train

    def train_step(
        self,
        images: np.ndarray,  # [N,H,W,C] uint8
        labels: np.ndarray,  # [N,H,W] uint16 (IGNORE_LABEL allowed)
        weights: np.ndarray,  # [N,H,W] float32
    ) -> float:
        """One minibatch update (the StartTraining analog,
        annonet_train_main.cpp:609). Returns the minibatch loss."""
        # buffered superstep decisions must land first: they claimed the
        # preceding BN-momentum step indices and dataset order
        self.flush_pending_steps()
        self.params, self.bn_stats, self.velocity, loss = self._step_fn(
            self.params,
            self.bn_stats,
            self.velocity,
            jnp.float32(self.learning_rate),
            jnp.float32(self._bn_momentum()),
            jnp.asarray(images),
            jnp.asarray(labels.astype(np.int32)),
            jnp.asarray(weights),
        )
        return self._finish_step(loss)

    def train_step_crops(
        self,
        images: np.ndarray,  # [N,H,W,C] uint8 raw crops
        labels: np.ndarray,  # [N,H,W] uint16 (IGNORE_LABEL allowed)
        crop_options,  # annonet_jax.data.crop.CropOptions
        seed: int = 0,
    ) -> float:
        """One minibatch update from RAW crops: augmentation + loss weighting
        + forward/backward/SGD fused in one jitted call (the accelerator-first
        replacement for the reference's host-side per-crop work +
        StartTraining)."""
        # a pixel batch (e.g. the pipeline's pin-budget fallback) must not
        # overtake buffered superstep decisions: flush them first so step
        # order and the BN-momentum schedule stay sequential
        self.flush_pending_steps()
        if self._fused_step_fn is None:
            self._fused_step_fn = opt_jit(
                with_key_carry(
                    make_fused_train_step(
                        self.model_config, self.config, crop_options
                    )
                )
            )
        self._ensure_fused_key(seed)
        (
            self.params,
            self.bn_stats,
            self.velocity,
            loss,
            self._fused_key,
        ) = self._fused_step_fn(
            self.params,
            self.bn_stats,
            self.velocity,
            # host scalars: uploaded WITH the step dispatch (an eager
            # jnp.float32() would be its own tiny transfer per step)
            np.float32(self.learning_rate),
            np.float32(self._bn_momentum()),
            self._fused_key,
            jnp.asarray(images),
            jnp.asarray(labels),  # uint16: half the transfer of int32
        )
        return self._finish_step(loss)

    def _ensure_fused_key(self, seed: int) -> None:
        """One shared augmentation-key stream for BOTH fused entries
        (pixel crops and pool decisions), so a run that mixes the two —
        e.g. the pin-budget fallback interleaving pixel batches — draws
        the same augmentations as either path alone. The carry advances
        on device inside each step (with_key_carry)."""
        if self._fused_key is None:
            # numpy, not a committed device array: a single-device-committed
            # input would be rejected by a multi-process mesh program. Only
            # the first dispatch uploads it — afterwards the carry is the
            # step program's own (correctly sharded) output.
            self._fused_key = np.asarray(jax.random.PRNGKey(seed ^ 0x5EED))

    def train_step_decisions(
        self,
        pool,  # annonet_jax.train.device_cache.DeviceImagePool
        samples,  # list[Sample], one per crop (repeats allowed)
        rects,  # list[(l, t, r, b)] inclusive crop rects
        crop_options,  # annonet_jax.data.crop.CropOptions
        seed: int = 0,
    ) -> Optional[float]:
        """One minibatch update from crop DECISIONS against the device
        image pool: the pixels never leave the device (the
        host ships ~20 bytes per crop). Bit-identical to
        train_step_crops on the same decisions (tested).

        Single-device, this is ONE XLA dispatch: the on-device gather and
        the fused step trace into one program (make_fused_pool_step) with
        the key carry folded in and the packed [5,B] index array uploaded
        as a call argument. DataParallelTrainer overrides the step-builder
        hooks so the same dispatch/buffering logic runs its one-program
        shard_mapped pool step instead (parallel.train.make_dp_pool_step:
        each device slices its decision columns and gathers from its pool
        replica — still one dispatch per step, or per K steps with
        supersteps)."""
        fdf = crop_options.further_downscaling_factor
        if fdf > 1.0:
            raise ValueError(
                "train_step_decisions requires further_downscaling_factor "
                "<= 1 (the resize path materializes pixels on the host)"
            )
        dim = int(round(crop_options.dim * fdf))
        # superstep buffering treats the pool as a scan invariant: a batch
        # that touches a NON-resident image is about to upload/evict pool
        # slots, so dispatch the buffered steps first (as single steps),
        # BEFORE ensure() mutates anything the buffer references. The same
        # flush covers a caller switching pools / crop geometry mid-run —
        # buffered entries must all reference ONE pool state and dim.
        if self._superstep_buffer and (
            not pool.all_resident(samples)
            or self._superstep_buffer[0][0] is not pool
            or self._superstep_buffer[0][1] != dim
        ):
            self.flush_pending_steps()
        # the gather dynamic_slices a [dim, dim] window from a slot, so
        # slots must be at least crop-sized even when every image is
        # smaller than the crop
        slot_idx = pool.ensure(samples, min_dim=dim)
        valid_h, valid_w = pool.valid_dims(slot_idx)
        y0 = np.asarray([r[1] for r in rects], np.int32)
        x0 = np.asarray([r[0] for r in rects], np.int32)
        # one [5,B] host array passed straight to the jitted call: the
        # upload rides the dispatch instead of five eager transfers
        packed = np.stack(
            [np.asarray(slot_idx, np.int32), y0, x0,
             np.asarray(valid_h, np.int32), np.asarray(valid_w, np.int32)]
        )
        multiple = self._decision_batch_multiple()
        if packed.shape[1] % multiple:
            raise ValueError(
                f"minibatch size {packed.shape[1]} must be divisible by "
                f"the mesh batch-axis size {multiple}"
            )

        if (self.config.steps_per_dispatch > 1
                and self.config.loss_sync_interval > 1):
            # scan-superstep path: buffer this step's decisions; one
            # lax.scan program dispatches K of them at once (pool
            # residency was guaranteed above). loss_sync_interval == 1
            # means the caller wants BLOCKING per-step losses (reference
            # behavior) — incompatible with buffering, so it wins.
            self._ensure_fused_key(seed)
            momentum = bn_momentum_for_step(
                self.step_count + len(self._superstep_buffer),
                max(1, self.config.bn_stats_window),
            )
            self._superstep_buffer.append(
                (pool, dim, crop_options, packed, momentum)
            )
            if len(self._superstep_buffer) >= self.config.steps_per_dispatch:
                self._dispatch_superstep()
            return None

        self._ensure_fused_key(seed)
        loss = self._dispatch_single_pool_step(
            pool, dim, crop_options, packed, self._bn_momentum()
        )
        return self._finish_step(loss)

    def _dispatch_single_pool_step(
        self, pool, dim, crop_options, packed, momentum
    ):
        """ONE pool-fed fused step dispatch (shared by the direct path
        and the superstep buffer's single-step flush); returns the device
        loss scalar. Callers do the step bookkeeping."""
        step_fn = self._pool_step_fns.get(("fused", dim))
        if step_fn is None:
            step_fn = self._build_pool_step_fn(dim, crop_options)
            self._pool_step_fns[("fused", dim)] = step_fn
        (
            self.params,
            self.bn_stats,
            self.velocity,
            loss,
            self._fused_key,
        ) = step_fn(
            self.params,
            self.bn_stats,
            self.velocity,
            np.float32(self.learning_rate),
            np.float32(momentum),
            self._fused_key,
            pool.images,
            pool.labels,
            packed,
        )
        return loss

    def _dispatch_superstep(self) -> None:
        """Run the buffered decision steps as ONE lax.scan program."""
        buffer, self._superstep_buffer = self._superstep_buffer, []
        if not buffer:
            return
        pool, dim, crop_options, _p, _m = buffer[0]
        assert all(b[1] == dim for b in buffer)
        k = len(buffer)
        fn = self._pool_step_fns.get(("superstep", dim, k))
        if fn is None:
            fn = self._build_pool_superstep_fn(dim, crop_options, k)
            self._pool_step_fns[("superstep", dim, k)] = fn
        packed = np.stack([b[3] for b in buffer])  # [K, 5, B]
        momenta = np.asarray([b[4] for b in buffer], np.float32)
        (
            self.params,
            self.bn_stats,
            self.velocity,
            losses,
            self._fused_key,
        ) = fn(
            self.params,
            self.bn_stats,
            self.velocity,
            np.float32(self.learning_rate),
            momenta,
            self._fused_key,
            pool.images,
            pool.labels,
            packed,
        )
        self.step_count += k
        self._pending_losses.append(losses)  # [K] device array
        if len(self._pending_losses) >= 2 * max(
            1, self.config.loss_sync_interval // k
        ):
            self.flush_losses(
                max(1, self.config.loss_sync_interval // k)
            )

    def flush_pending_steps(self) -> None:
        """Dispatch any buffered superstep decisions now, as SINGLE steps
        — the buffer only ever holds a partial tail (full buffers
        dispatch immediately as the K-length scan), and a one-off scan
        length would cost a fresh compile."""
        buffer, self._superstep_buffer = self._superstep_buffer, []
        for pool, dim, crop_options, packed, momentum in buffer:
            loss = self._dispatch_single_pool_step(
                pool, dim, crop_options, packed, momentum
            )
            self._finish_step(loss)

    def _build_pool_step_fn(self, dim: int, crop_options) -> Callable:
        """The single pool-fed step program (overridden by
        DataParallelTrainer with the shard_mapped equivalent)."""
        return opt_jit(
            with_key_carry(
                make_fused_pool_step(
                    self.model_config, self.config, crop_options, dim
                )
            )
        )

    def _build_pool_superstep_fn(self, dim: int, crop_options,
                                 k: int) -> Callable:
        """The K-step scan program (overridden by DataParallelTrainer)."""
        return opt_jit(
            make_fused_pool_superstep(
                self.model_config, self.config, crop_options, dim, k
            )
        )

    def _decision_batch_multiple(self) -> int:
        """Decision batches must be a multiple of this (the DP mesh's
        batch-axis size; 1 single-device)."""
        return 1

    def _bn_momentum(self) -> float:
        """Windowed BN running-stats momentum for the NEXT update; tracks
        dlib's cumulative-average-then-EMA schedule exactly. step_count is
        persisted in the sync file, so resumed runs keep the schedule."""
        return bn_momentum_for_step(
            self.step_count, max(1, self.config.bn_stats_window)
        )

    def _finish_step(self, loss) -> Optional[float]:
        """Book-keep one dispatched step. Returns the loss as a float when
        loss_sync_interval == 1 (blocking, reference behavior); with larger
        intervals losses are pulled in batches and None is returned."""
        self.step_count += 1
        if self.config.loss_sync_interval <= 1:
            loss_value = float(loss)
            self._record_loss(loss_value)
            self._maybe_sync()
            return loss_value
        self._pending_losses.append(loss)
        # LAGGED flush: only once 2x the interval is pending, pull the
        # OLDEST interval's losses. Those steps are interval dispatches
        # behind the newest, so by readback time the device has already
        # produced them — the host never drains the in-flight pipeline
        # (a flush of the NEWEST losses would stall for
        # interval x step_time every interval steps). Plateau/LR logic
        # sees losses at most 2*interval-1 steps late.
        if len(self._pending_losses) >= 2 * self.config.loss_sync_interval:
            self.flush_losses(self.config.loss_sync_interval)
        return None

    def flush_losses(self, count: Optional[int] = None) -> None:
        """Pull pending device losses (the oldest ``count``, default all)
        to the host and run the plateau logic on them, in order."""
        if not self._pending_losses:
            return
        if count is None or count >= len(self._pending_losses):
            batch, self._pending_losses = self._pending_losses, []
        else:
            batch = self._pending_losses[:count]
            self._pending_losses = self._pending_losses[count:]
        # entries are scalars (single steps) or [K] arrays (supersteps);
        # concatenate ON DEVICE so the host does ONE blocking readback per
        # flush, not one round trip per entry
        values = np.asarray(
            jnp.concatenate([jnp.atleast_1d(b) for b in batch])
        ).tolist()
        for value in values:
            self._record_loss(float(value))
        self._maybe_sync()

    def _record_loss(self, loss_value: float) -> None:
        self._recorded_steps += 1
        if not math.isfinite(loss_value):
            # A non-finite loss means the parameters are already poisoned
            # (the SGD update ran before the loss was read back), so every
            # later step is garbage: fail loudly instead of letting the
            # plateau detector cycle on NaN forever. The CLI's training-loop
            # catch turns this into exit 2 (annonet_train_main.cpp:616-620).
            raise RuntimeError(
                f"training diverged: loss is {loss_value} at step "
                f"{self._recorded_steps} (learning rate "
                f"{self.learning_rate:g}) — lower --initial-learning-rate"
            )
        self.previous_loss_values.append(loss_value)
        if len(self.previous_loss_values) > self._loss_window_cap:
            del self.previous_loss_values[
                : len(self.previous_loss_values) - self._loss_window_cap
            ]
        threshold = self.config.iterations_without_progress_threshold
        self.steps_without_progress = count_steps_without_decrease(
            self.previous_loss_values
        )
        if self.steps_without_progress > threshold:
            robust = count_steps_without_decrease_robust(self.previous_loss_values)
            if robust > threshold:
                self.learning_rate *= self.config.learning_rate_shrink_factor
                self.previous_loss_values.clear()
                self.steps_without_progress = 0
                if self.config.verbose:
                    print(
                        f"step {self._recorded_steps}: learning rate "
                        f"shrunk to {self.learning_rate:g}"
                    )
                if self.metrics_hook is not None:
                    self.metrics_hook({
                        "event": "learning_rate_shrink",
                        "step": self._recorded_steps,
                        "learning_rate": self.learning_rate,
                    })
        if self.metrics_hook is not None:
            self.metrics_hook({
                "event": "loss",
                "step": self._recorded_steps,
                "loss": loss_value,
                "learning_rate": self.learning_rate,
                "steps_without_progress": self.steps_without_progress,
            })
        if self.config.verbose and self._recorded_steps % 100 == 0:
            dump = self.previous_loss_values[
                -self.config.previous_loss_values_dump_amount :
            ]
            avg = sum(dump) / max(1, len(dump))
            print(
                f"step {self._recorded_steps}: learning rate "
                f"{self.learning_rate:g}, "
                f"average loss {avg:.6f}, steps without apparent progress "
                f"{self.steps_without_progress}"
            )

    @property
    def total_steps(self) -> int:
        """ABSOLUTE step count: includes steps restored from a sync-file
        resume and superstep decisions buffered but not yet dispatched.
        This is the numbering the loss / learning_rate_shrink metrics
        events use, so CLI save/done events keyed off it line up with
        them across resumed runs (a resumed phase's run-relative counter
        does not)."""
        return self.step_count + len(self._superstep_buffer)

    @property
    def should_stop(self) -> bool:
        """True once plateau-driven decay pushed the learning rate below
        ``min_learning_rate`` — the stop condition of the reference's
        training loop (annonet_train_main.cpp:569-571)."""
        return self.learning_rate < self.config.min_learning_rate

    # ----------------------------------------------------------- export

    def runtime_net(self):
        """BN-folded inference params (the GetRuntimeNet analog)."""
        return fold_batchnorm(self.params, self.bn_stats, self.model_config)

    # ----------------------------------------------------------- sync

    def _state_trees(self) -> Dict[str, Any]:
        return {
            "params": self.params,
            "bn_stats": self.bn_stats,
            "velocity": self.velocity,
        }

    def save_sync_file(
        self, path: Optional[str] = None, flush: bool = True
    ) -> None:
        """Write the full training state. ``flush=False`` saves the state
        as-dispatched without draining buffered steps/losses (the loss
        window in the file then lags the step count by up to the pending
        readbacks) — required for time-triggered saves in multi-process
        runs, where a flush would dispatch collective programs at a
        wall-clock point the other processes don't share."""
        if flush:
            self.flush_pending_steps()
            self.flush_losses()
        self._last_sync = time.monotonic()
        if not self.io_process:
            return
        path = path or self.config.sync_file
        if not path:
            return
        meta = {
            "learning_rate": self.learning_rate,
            "step_count": self.step_count,
            "previous_loss_values": self.previous_loss_values[-self._loss_window_cap:],
            "model_config": self.model_config.to_dict(),
            # identifies the exact weights: the multi-host resume
            # pre-check allgathers this so ranks holding checkpoints that
            # merely coincide on (step, lr) still fail fast
            "weights_fingerprint": serialization.weights_fingerprint(
                self.params
            ),
        }
        serialization.save_trainer_state(path, self._state_trees(), meta)

    def _maybe_sync(self) -> None:
        if (
            self.config.sync_file
            and time.monotonic() - self._last_sync
            >= self.config.sync_interval_seconds
        ):
            self.save_sync_file(flush=self.sync_flush)

    def _try_resume(self, path: str) -> None:
        import os

        if not os.path.exists(path):
            return
        try:
            trees, meta = serialization.load_trainer_state(path)
        except Exception as e:
            raise RuntimeError(
                f"cannot resume: synchronization file {path} is unreadable "
                f"or corrupt ({e}); delete it to start fresh"
            ) from e
        if meta.get("model_config") != self.model_config.to_dict():
            raise RuntimeError(
                f"sync file {path} was written for a different model config; "
                "delete it or match the configuration"
            )
        as_jnp = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
        self.params = as_jnp(trees["params"])
        self.bn_stats = as_jnp(trees["bn_stats"])
        self.velocity = as_jnp(trees["velocity"])
        self.learning_rate = float(meta["learning_rate"])
        self.step_count = int(meta["step_count"])
        self._recorded_steps = self.step_count  # all prior losses recorded
        self.previous_loss_values = [float(v) for v in meta["previous_loss_values"]]
        if self.config.verbose:
            print(
                f"resumed from {path} at step {self.step_count}, "
                f"learning rate {self.learning_rate:g}"
            )
