"""Ablation profile of the fused train step.

Times each slice of the training step on the flagship config, on the host
clock up to jax.block_until_ready, so the bottleneck is attributable:

  fwd        forward only (loss value; no grad)
  fwd_folded forward only through apply_train_folded
  grad       value_and_grad (forward + backward), no SGD/EMA
  full       the shipped fused step (augment + weighting + fwd/bwd + SGD)
  full_folded the fused step with folded_training=True
  aug        augmentation + weighting alone

Run ONE at a time on the GPU: python -u scripts/profile_train.py
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(fn, args_builder, iters, sync):
    """Seconds per call over `iters` chained calls, ended by
    jax.block_until_ready (the first call compiles and is not timed)."""
    import jax

    state = args_builder()
    jax.block_until_ready(sync(fn(*state)))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*state)
        state = update_state(state, out)
    jax.block_until_ready(sync(out))
    elapsed = max(1e-9, time.perf_counter() - t0)
    return elapsed / iters


def update_state(state, out):
    return state  # overridden per-variant below when state must chain


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--dim", type=int, default=192)
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--level-count", type=int, default=3)
    parser.add_argument("--variants", default="aug,fwd,fwd_folded,grad,full,full_folded")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from annonet_jax.data.crop import CropOptions
    from annonet_jax.models.segnet import (
        SegNetConfig,
        apply_train,
        init_state,
    )
    from annonet_jax.models.folded_runtime import apply_train_folded
    from annonet_jax.ops.augment import augment_batch
    from annonet_jax.ops.loss import weighted_pixel_cross_entropy
    from annonet_jax.ops.weighting import batched_label_weights
    from annonet_jax.train.trainer import (
        TrainerConfig,
        make_fused_train_step,
    )

    config = SegNetConfig(
        class_count=3, level_count=args.level_count, base_width=16
    )
    co = CropOptions(
        dim=args.dim,
        allow_flip_left_right=True,
        allow_flip_upside_down=True,
        multiplicative_brightness_change_probability=0.5,
        noise_level_stddev=2.0,
        allow_random_color_offset=True,
    )
    B, D = args.batch, args.dim
    params, bn_stats = init_state(jax.random.PRNGKey(0), config)
    velocity = jax.tree_util.tree_map(jnp.zeros_like, params)
    rng = np.random.default_rng(0)
    images = jnp.asarray(
        rng.integers(0, 256, size=(B, D, D, 3), dtype=np.uint8)
    )
    labels = jnp.asarray(
        rng.integers(0, 3, size=(B, D, D)).astype(np.int32)
    )
    weights = jnp.ones((B, D, D), jnp.float32)
    lr = jnp.float32(0.1)
    m = jnp.float32(0.99)
    key = jax.random.PRNGKey(1)
    jax.block_until_ready(images)  # finish uploads

    # forward FLOPs per 192^2 crop of the level-3 flagship net
    fwd_flop_per_crop = 2.44187136e9

    results = {}

    def report(name, sec):
        crops_s = B / sec
        tflops = {
            "fwd": 1, "fwd_folded": 1, "grad": 3, "full": 3,
            "full_folded": 3, "aug": 0,
        }[name] * fwd_flop_per_crop * B / sec / 1e12
        results[name] = {
            "ms": round(sec * 1e3, 2),
            "crops_per_s": round(crops_s, 1),
            "TFLOP_s": round(tflops, 2),
        }
        print(name, json.dumps(results[name]), flush=True)

    wanted = set(args.variants.split(","))

    if "aug" in wanted:
        @jax.jit
        def aug_fn(key, images, labels):
            imf, lab = augment_batch(
                key, images, labels,
                allow_flip_left_right=True, allow_flip_upside_down=True,
                multiplicative_brightness_change_probability=0.5,
                multiplicative_brightness_change_sigma=0.1,
                noise_level_stddev=2.0, allow_random_color_offset=True,
            )
            w = batched_label_weights(lab, 0.5, 0.5, config.class_count)
            return jnp.sum(imf) + jnp.sum(w)

        sec = timed(
            aug_fn, lambda: (key, images, labels), args.iters,
            lambda o: o,
        )
        report("aug", sec)

    if "fwd" in wanted:
        @jax.jit
        def fwd_fn(params, bn_stats, images):
            logits, _ = apply_train(
                params, bn_stats, images, config, bn_momentum=0.99
            )
            return jnp.sum(logits)

        sec = timed(
            fwd_fn, lambda: (params, bn_stats, images), args.iters,
            lambda o: o,
        )
        report("fwd", sec)

    if "fwd_folded" in wanted:
        @jax.jit
        def fwdf_fn(params, bn_stats, images):
            logits, _ = apply_train_folded(
                params, bn_stats, images, config, bn_momentum=0.99, fold0=8
            )
            return jnp.sum(logits)

        sec = timed(
            fwdf_fn, lambda: (params, bn_stats, images), args.iters,
            lambda o: o,
        )
        report("fwd_folded", sec)

    if "grad" in wanted:
        def loss_fn(params, bn_stats, images, labels, weights):
            logits, new_stats = apply_train(
                params, bn_stats, images, config, bn_momentum=0.99
            )
            return weighted_pixel_cross_entropy(logits, labels, weights)

        grad_fn = jax.jit(jax.value_and_grad(loss_fn))

        def g_fn(params, bn_stats, images, labels, weights):
            loss, grads = grad_fn(params, bn_stats, images, labels, weights)
            return loss

        sec = timed(
            g_fn, lambda: (params, bn_stats, images, labels, weights),
            args.iters, lambda o: o,
        )
        report("grad", sec)

    for name, folded in (("full", False), ("full_folded", True)):
        if name not in wanted:
            continue
        tc = TrainerConfig(folded_training=folded)
        step = jax.jit(make_fused_train_step(config, tc, co))

        def full_builder():
            return [params, bn_stats, velocity, lr, m, key, images, labels]

        state = full_builder()
        out = jax.block_until_ready(step(*state))
        p, s, v, loss = out
        t0 = time.perf_counter()
        for i in range(args.iters):
            p, s, v, loss = step(p, s, v, lr, m, key, images, labels)
        jax.block_until_ready(loss)
        sec = max(1e-9, time.perf_counter() - t0) / args.iters
        report(name, sec)

    print(json.dumps({"profile": results}), flush=True)


if __name__ == "__main__":
    main()
