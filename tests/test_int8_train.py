"""Tests for the int8-forward (straight-through) training path.

ops/int8_train.py quantizes each encoder/decoder conv's operands to int8
for the FORWARD pass only, while the backward routes gradients through
the exact conv at the unquantized operands.  These tests pin the two
properties that make that safe:

  * STE: gradients are bit-identical to the unquantized step's
  * forward noise is bounded by the int8 grid (per-tensor activation /
    per-channel weight scales)

plus end-to-end trainability via TrainerConfig(int8_forward=True)
(reference hot loop being accelerated: annonet_train_main.cpp:609).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax

from annonet_jax.data.crop import CropOptions
from annonet_jax.models import SegNetConfig
from annonet_jax.models.segnet import apply_train, init_state
from annonet_jax.ops.int8_train import int8_conv_ste
from annonet_jax.train.trainer import TrainerConfig, make_fused_train_step

_DN = ("NHWC", "HWIO", "NHWC")


def _exact_conv(x, w, stride):
    return lax.conv_general_dilated(
        x, w, (stride, stride), "SAME", dimension_numbers=_DN
    )


def _rand_xw(key, n=2, h=12, cin=8, cout=16, k=3):
    kx, kw = jax.random.split(key)
    x = jax.random.normal(kx, (n, h, h, cin), jnp.float32)
    w = jax.random.normal(kw, (k, k, cin, cout), jnp.float32) * 0.1
    return x, w


# ---------------------------------------------------------------- STE


@pytest.mark.parametrize("stride", [1, 2])
def test_ste_backward_bit_identical_to_exact(stride):
    x, w = _rand_xw(jax.random.PRNGKey(0))

    # The cotangent entering the conv in a real loss is a function of the
    # (quantized) forward value, so whole-loss grads differ by forward
    # noise; the STE contract is about the conv's OWN backward rule: feed
    # a FIXED cotangent through both vjps and require bit equality.
    g = jax.random.normal(
        jax.random.PRNGKey(1), _exact_conv(x, w, stride).shape, jnp.float32
    )
    _, vjp_i = jax.vjp(lambda a, b: int8_conv_ste(a, b, stride, jnp.float32), x, w)
    _, vjp_e = jax.vjp(lambda a, b: _exact_conv(a, b, stride), x, w)
    for a, b in zip(vjp_i(g), vjp_e(g)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_int8_forward_error_bounded_by_grid():
    x, w = _rand_xw(jax.random.PRNGKey(2), cin=16, cout=16)
    out_q = np.asarray(int8_conv_ste(x, w, 1, jnp.float32))
    out_e = np.asarray(_exact_conv(x, w, 1))
    # per-tensor activation scale + per-channel weight scale: the error of
    # each of the 9*cin accumulated products is <= (sx/2)*|w| + (sw/2)*|x|
    sx = np.abs(np.asarray(x)).max() / 127.0
    sw = np.abs(np.asarray(w)).max(axis=(0, 1, 2)) / 127.0
    taps = 9 * x.shape[-1]
    bound = taps * (
        sx / 2 * np.abs(np.asarray(w)).max() + sw / 2 * np.abs(np.asarray(x)).max()
    )
    assert np.max(np.abs(out_q - out_e)) <= bound.max()
    # and in practice much tighter than the worst case
    rel = np.abs(out_q - out_e).max() / (np.abs(out_e).max() + 1e-9)
    assert rel < 0.05


def test_int8_conv_jits_and_matches_eager():
    x, w = _rand_xw(jax.random.PRNGKey(3))
    eager = int8_conv_ste(x, w, 1, jnp.float32)
    jitted = jax.jit(lambda a, b: int8_conv_ste(a, b, 1, jnp.float32))(x, w)
    np.testing.assert_allclose(
        np.asarray(eager), np.asarray(jitted), rtol=1e-6, atol=1e-6
    )


# ----------------------------------------------------- network-level


def _tiny_config():
    return SegNetConfig(class_count=2, level_count=1, base_width=8)


def test_apply_train_conv_impl_close_to_exact():
    config = _tiny_config()
    params, bn_stats = init_state(jax.random.PRNGKey(0), config)
    x = jnp.asarray(
        np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), np.uint8)
    )
    logits_e, _ = apply_train(params, bn_stats, x, config)
    logits_q, _ = apply_train(
        params, bn_stats, x, config, conv_impl=int8_conv_ste
    )
    # BN renormalizes each conv's output, so int8 grid noise stays small
    # through depth; the logits must agree to a few percent of their range
    diff = np.abs(np.asarray(logits_e) - np.asarray(logits_q)).max()
    rng = np.abs(np.asarray(logits_e)).max() + 1e-9
    assert diff / rng < 0.1


def test_fused_step_int8_trains_separable_task():
    config = _tiny_config()
    co = CropOptions(dim=64)
    step = jax.jit(
        make_fused_train_step(config, TrainerConfig(int8_forward=True), co)
    )
    params, bn_stats = init_state(jax.random.PRNGKey(0), config)
    velocity = jax.tree_util.tree_map(jnp.zeros_like, params)
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(4)
    losses = []
    for i in range(12):
        lab = rng.integers(0, 2, (4, 64, 64)).astype(np.uint16)
        img = np.where(lab[..., None] == 1, 200, 50).astype(np.uint8)
        img = np.repeat(img, 3, axis=-1)
        key, sub = jax.random.split(key)
        params, bn_stats, velocity, loss = step(
            params,
            bn_stats,
            velocity,
            jnp.float32(0.05),
            jnp.float32(min(0.99, 1.0 - 1.0 / (i + 1))),
            sub,
            jnp.asarray(img),
            jnp.asarray(lab),
        )
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.5


def test_int8_forward_composes_with_remat():
    config = _tiny_config()
    params, bn_stats = init_state(jax.random.PRNGKey(0), config)
    x = jnp.asarray(
        np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3), np.uint8)
    )
    lab = jnp.zeros((2, 64, 64), jnp.int32)
    wts = jnp.ones((2, 64, 64), jnp.float32)

    from annonet_jax.ops.loss import weighted_pixel_cross_entropy

    def loss_fn(p):
        logits, _ = apply_train(
            p, bn_stats, x, config, remat=True, conv_impl=int8_conv_ste
        )
        return weighted_pixel_cross_entropy(logits, lab, wts)

    val, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    assert np.isfinite(float(val))
    leaves = jax.tree_util.tree_leaves(grads)
    assert all(np.isfinite(np.asarray(g)).all() for g in leaves)


def test_int8_forward_active_under_data_parallel():
    """TrainerConfig(int8_forward=True) must reach the DP step's convs
    (annonet_train --mesh N --int8-training): without augmentation and
    with sync BN, the DP int8 step equals the single-device int8 step,
    and both differ from the bf16 forward's loss."""
    from annonet_jax.parallel.mesh import make_mesh
    from annonet_jax.parallel.train import DataParallelTrainer
    from annonet_jax.train.trainer import Trainer

    mc = SegNetConfig(
        class_count=2, level_count=1, base_width=8, compute_dtype="float32"
    )
    co = CropOptions(dim=32)  # no stochastic augmentation
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (8, 32, 32, 3), np.uint8)
    labels = rng.integers(0, 2, (8, 32, 32)).astype(np.uint16)

    tc_int8 = TrainerConfig(initial_learning_rate=0.01, int8_forward=True)
    single = Trainer(mc, tc_int8, seed=0)
    dp = DataParallelTrainer(mc, tc_int8, seed=0, mesh=make_mesh(8))
    loss_single = single.train_step_crops(images, labels, co)
    loss_dp = dp.train_step_crops(images, labels, co)
    assert np.isclose(loss_single, loss_dp, rtol=1e-4), (loss_single, loss_dp)

    bf16 = Trainer(mc, TrainerConfig(initial_learning_rate=0.01), seed=0)
    loss_bf16 = bf16.train_step_crops(images, labels, co)
    # int8 grid noise makes the forward (and loss) measurably different
    assert abs(loss_bf16 - loss_dp) > 1e-7


def test_qat_trained_net_serves_int8_with_high_agreement():
    """The QAT loop end-to-end: train under int8 forward noise
    (--int8-training), fold BN, deploy through the int8 quantized
    inference runtime — the trained task must be solved and int8 labels
    must agree with the float path (the deployment the flag exists for)."""
    from annonet_jax.infer.core import TiledInferer
    from annonet_jax.infer.tiling import TilingParameters
    from annonet_jax.models.segnet import fold_batchnorm
    from annonet_jax.train.trainer import Trainer

    config = SegNetConfig(class_count=2, level_count=1, base_width=8)
    trainer = Trainer(
        config,
        TrainerConfig(initial_learning_rate=0.05, int8_forward=True),
        seed=0,
    )
    co = CropOptions(dim=48)
    rng = np.random.default_rng(5)
    for i in range(25):
        lab = rng.integers(0, 2, (8, 48, 48)).astype(np.uint16)
        img = np.repeat(
            np.where(lab[..., None] == 1, 200, 50).astype(np.uint8), 3, -1
        )
        trainer.train_step_crops(img, lab, co, seed=1)

    runtime = fold_batchnorm(trainer.params, trainer.bn_stats, config)
    tiling = TilingParameters(64, 64, 16, 16)
    lab = rng.integers(0, 2, (96, 96)).astype(np.uint16)
    img = np.repeat(
        np.where(lab[..., None] == 1, 200, 50).astype(np.uint8), 3, -1
    )
    float_inf = TiledInferer(runtime, config, tiling)
    int8_inf = TiledInferer(runtime, config, tiling, quantize="int8")
    labels_f, _ = float_inf.infer_arrays(img)
    int8_inf.infer_arrays(img)  # image 1 calibrates (float output)
    labels_q, _ = int8_inf.infer_arrays(img)  # quantized from image 2
    acc_f = (labels_f == lab).mean()
    acc_q = (labels_q == lab).mean()
    agreement = (labels_f == labels_q).mean()
    assert acc_f > 0.95, acc_f
    assert acc_q > 0.95, acc_q
    assert agreement > 0.98, agreement


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_int8_conv_sum_feeds_only_a_float32_convert(dtype):
    """The training forward's int8 conv keeps the form XLA:GPU lowers to
    one s8 -> f32 cuDNN call: its int32 sum is used only through a
    float32 convert."""
    from tests.test_quantized import int8_conv_sum_consumers

    jaxpr = jax.make_jaxpr(lambda a, b: int8_conv_ste(a, b, 1, dtype))(
        jnp.ones((1, 8, 8, 3), dtype), jnp.ones((3, 3, 3, 4), dtype)
    )
    assert int8_conv_sum_consumers(jaxpr) == [
        ("convert_element_type", jnp.float32)
    ]
