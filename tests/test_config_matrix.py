"""The reference's CI matrix as a runtime test matrix.

AppVeyor builds and runs the reference's unit binary in 8 configurations —
DLIB_DNN_PIMPL_WRAPPER_LEVEL_COUNT in {0,1,2,3} x {RGB, grayscale}
(appveyor.yml:6-23). Those are compile-time knobs there; here they are
runtime config, so the whole matrix runs as one parametrized test: init,
train step, BN folding, tiled inference for every cell.
"""

import jax
import numpy as np
import pytest

from annonet_jax.data.crop import CropOptions
from annonet_jax.infer.core import TiledInferer, annonet_infer
from annonet_jax.infer.tiling import TilingParameters
from annonet_jax.models.segnet import (
    SegNetConfig,
    fold_batchnorm,
    recommended_input_dimension,
    required_input_dimension,
)
from annonet_jax.train.trainer import Trainer, TrainerConfig


@pytest.mark.parametrize("level_count", [0, 1, 2, 3])
@pytest.mark.parametrize("grayscale", [False, True])
def test_full_cycle_per_config(level_count, grayscale):
    config = SegNetConfig(
        class_count=2,
        level_count=level_count,
        grayscale=grayscale,
        base_width=4,
        compute_dtype="float32",
    )
    rf = required_input_dimension(config)
    assert rf >= 1
    dim = recommended_input_dimension(config, 2 * rf)
    assert dim >= 2 * rf and dim % 2**level_count == 0

    channels = 1 if grayscale else 3
    rng = np.random.default_rng(level_count)
    labels = rng.integers(0, 2, size=(2, dim, dim)).astype(np.uint16)
    images = np.where(labels[..., None] == 1, 200, 50).astype(np.uint8)
    images = np.repeat(images, channels, axis=-1)

    trainer = Trainer(config, TrainerConfig(initial_learning_rate=0.02))
    opts = CropOptions(dim=dim, allow_flip_left_right=True)
    first = trainer.train_step_crops(images, labels, opts)
    last = first
    for _ in range(4):
        last = trainer.train_step_crops(images, labels, opts)
    assert np.isfinite(last)

    runtime = trainer.runtime_net()
    inferer = TiledInferer(
        runtime,
        config,
        TilingParameters(max(dim, 32), max(dim, 32), rf, rf),
    )
    image = rng.integers(
        0, 256, size=(dim + 7, dim + 3, channels), dtype=np.uint8
    )
    result = annonet_infer(inferer, image)
    assert result.shape == (dim + 7, dim + 3)
    assert result.dtype == np.uint16
    assert set(np.unique(result)) <= {0, 1}


@pytest.mark.parametrize("level_count", [0, 1, 2, 3])
def test_receptive_field_is_tight_upper_bound(level_count):
    """Empirically verify required_input_dimension: perturbing the input
    center pixel must not change logits farther than rf/2 away, and the
    computed rf must actually be reached by some influence."""
    config = SegNetConfig(
        class_count=2,
        level_count=level_count,
        base_width=4,
        compute_dtype="float32",
    )
    rf = required_input_dimension(config)
    dim = recommended_input_dimension(config, 4 * rf)

    from annonet_jax.models.segnet import apply_runtime, init_state

    params, stats = init_state(jax.random.PRNGKey(1), config)
    runtime = fold_batchnorm(params, stats, config)

    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, size=(1, dim, dim, 3), dtype=np.uint8)
    perturbed = base.copy()
    c = dim // 2
    perturbed[0, c, c] = 255 - perturbed[0, c, c]

    out_base = np.asarray(apply_runtime(runtime, base, config))
    out_pert = np.asarray(apply_runtime(runtime, perturbed, config))
    diff = np.abs(out_base - out_pert).sum(axis=-1)[0]
    ys, xs = np.nonzero(diff > 1e-6)
    assert len(ys) > 0
    spread = max(ys.max() - ys.min() + 1, xs.max() - xs.min() + 1)
    assert spread <= rf, f"influence {spread} exceeds computed rf {rf}"
