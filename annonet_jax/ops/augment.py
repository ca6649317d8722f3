"""Batched on-device training augmentations.

The reference applies all augmentations per-crop on the host with scalar
loops (randomly_crop_image, annonet_train_main.cpp:184-231, and
add_random_noise, :73-103). Here the whole minibatch is augmented in ONE
jitted pass on the device, fused into the train step, so the host
only ships raw uint8 crops:

  * random horizontal / vertical flips of image+labels
    (annonet_train_main.cpp:184-194)
  * multiplicative brightness: with probability p, multiply by
    exp(N(0, sigma)), round, clamp (:196-218)
  * additive noise: per-crop level L = round(|N(0, sigma)|), per-pixel
    integer noise uniform in [-L, L], clamp (add_random_noise, :73-103)
  * random color offset (RGB only): random gamma + per-channel scale,
    modeled on dlib's apply_random_color_offset (:226-231; the dlib
    submodule is empty in the snapshot, so the transform is reimplemented
    from dlib's documented random_color_transform semantics: gamma drawn
    near 1, per-channel scales <= 1 normalized by their max)

All stages keep integer-valued float32 pixels (round + clamp like the
reference's uint8 intermediate stores) and are independent per crop, keyed
by a fold of the step RNG key.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _per_sample_uniform(key, n):
    return jax.random.uniform(key, (n,), jnp.float32)


def flip_decisions(
    key: jax.Array, n: int,
    allow_flip_left_right: bool, allow_flip_upside_down: bool,
):
    """The flip booleans augment_batch would draw from ``key`` (same split,
    same comparisons) — exposed so the device pool's crop gather can apply
    them at extraction time (``flips_pre_applied``) with a bit-identical
    stream. Returns (flip_lr, flip_ud); None where the flag is off."""
    k_lr, k_ud = jax.random.split(key, 8)[:2]
    flip_lr = (
        jax.random.uniform(k_lr, (n,)) > 0.5
        if allow_flip_left_right else None
    )
    flip_ud = (
        jax.random.uniform(k_ud, (n,)) > 0.5
        if allow_flip_upside_down else None
    )
    return flip_lr, flip_ud


def _round_clamp(x):
    return jnp.clip(jnp.round(x), 0.0, 255.0)


def augment_batch(
    key: jax.Array,
    images: jnp.ndarray,  # [N,H,W,C] uint8 or float
    labels: jnp.ndarray,  # [N,H,W] integer
    *,
    allow_flip_left_right: bool = False,
    allow_flip_upside_down: bool = False,
    multiplicative_brightness_change_probability: float = 0.0,
    multiplicative_brightness_change_sigma: float = 0.1,
    noise_level_stddev: float = 0.0,
    allow_random_color_offset: bool = False,
    flips_pre_applied: bool = False,
):
    """Augment a minibatch on device. Returns (images float32 0..255, labels).

    The boolean/probability knobs are Python-static (they come from CLI
    flags), so disabled stages compile to nothing.

    ``flips_pre_applied`` marks that the caller already mirrored the crops
    (the device pool's gather applies flip_decisions' booleans inside its
    permutation matmuls — ops/crop_gather.py); the flip stages are then
    skipped here WITHOUT touching the key stream, so all later stages draw
    exactly what they would with in-step flips (flips come first in the
    reference too, annonet_train_main.cpp:184-194).
    """
    n = images.shape[0]
    x = images.astype(jnp.float32)
    k_lr, k_ud, k_bp, k_bs, k_nl, k_nv, k_cg, k_cs = jax.random.split(key, 8)

    if allow_flip_left_right and not flips_pre_applied:
        flip = jax.random.uniform(k_lr, (n,)) > 0.5
        sel = flip[:, None, None]
        x = jnp.where(sel[..., None], x[:, :, ::-1, :], x)
        labels = jnp.where(sel, labels[:, :, ::-1], labels)

    if allow_flip_upside_down and not flips_pre_applied:
        flip = jax.random.uniform(k_ud, (n,)) > 0.5
        sel = flip[:, None, None]
        x = jnp.where(sel[..., None], x[:, ::-1, :, :], x)
        labels = jnp.where(sel, labels[:, ::-1, :], labels)

    if multiplicative_brightness_change_probability > 0.0:
        apply = (
            _per_sample_uniform(k_bp, n)
            < multiplicative_brightness_change_probability
        )
        factor = jnp.exp(
            jax.random.normal(k_bs, (n,))
            * multiplicative_brightness_change_sigma
        )
        factor = jnp.where(apply, factor, 1.0)
        x = _round_clamp(x * factor[:, None, None, None])

    if noise_level_stddev > 0.0:
        # per-crop integer noise level L = round(|N(0, sigma)|); per-pixel
        # noise uniform over the 2L integers in [-L, L-1]: dlib's
        # rand::get_integer_in_range(begin, end) is HALF-OPEN, so
        # get_integer_in_range(-L, L) at annonet_train_main.cpp:82 never
        # draws +L (and returns 0 when L == 0)
        level = jnp.round(
            jnp.abs(jax.random.normal(k_nl, (n,)) * noise_level_stddev)
        )
        u = jax.random.uniform(k_nv, x.shape)
        span = (2.0 * level)[:, None, None, None]
        noise = jnp.floor(u * span) - level[:, None, None, None]
        x = jnp.clip(x + noise, 0.0, 255.0)

    if allow_random_color_offset and x.shape[-1] == 3:
        # dlib random_color_transform: gamma = max(0, 1 + 0.5*(u - 0.5));
        # per-channel scale 1 - 0.2*u normalized so the largest is 1
        gamma = jnp.maximum(
            0.0, 1.0 + 0.5 * (_per_sample_uniform(k_cg, n) - 0.5)
        )
        scales = 1.0 - 0.2 * jax.random.uniform(k_cs, (n, 3))
        scales = scales / jnp.max(scales, axis=-1, keepdims=True)
        v = jnp.power(
            jnp.maximum(x, 0.0) / 255.0, gamma[:, None, None, None]
        )
        x = _round_clamp(255.0 * v * scales[:, None, None, :])

    return x, labels
