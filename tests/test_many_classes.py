"""High class counts: the reference supports arbitrary classes from
anno_classes.json (class index = array position,
annonet_parse_anno_classes.cpp:79), but most tests run K in {2,3,4}.

K = 17 is chosen adversarially for the folded layouts: the folded head
packs K*fold = 136 class-major channels (past a 128-wide boundary), the
int8 head dot gets a non-power-of-two N, and unfold_logits must keep the
class-major slicing straight past that boundary.
"""

import jax
import numpy as np
import pytest

from annonet_jax.infer.core import TiledInferer, annonet_infer
from annonet_jax.infer.tiling import TilingParameters
from annonet_jax.models.folded_runtime import (
    apply_runtime_folded,
    fold_runtime_params,
)
from annonet_jax.models.segnet import (
    SegNetConfig,
    apply_runtime,
    fold_batchnorm,
    init_state,
    required_input_dimension,
)

K = 17


def _runtime(level_count=2, base_width=8, dtype="float32"):
    config = SegNetConfig(
        class_count=K, level_count=level_count, base_width=base_width,
        compute_dtype=dtype,
    )
    params, stats = init_state(jax.random.PRNGKey(3), config)
    return fold_batchnorm(params, stats, config), config


def test_folded_runtime_matches_at_k17():
    runtime, config = _runtime()
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(2, 16, 32, 3), dtype=np.uint8)
    ref = np.asarray(apply_runtime(runtime, x, config))
    got = np.asarray(
        apply_runtime_folded(fold_runtime_params(runtime, config, 8), x, config)
    )
    assert ref.shape == (2, 16, 32, K)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_tiled_multi_tile_matches_whole_image_argmax_at_k17():
    runtime, config = _runtime()
    rng = np.random.default_rng(1)
    image = rng.integers(0, 256, size=(96, 96, 3), dtype=np.uint8)
    overlap = required_input_dimension(config)
    tiling = TilingParameters(
        max_tile_width=48, max_tile_height=48,
        overlap_x=overlap, overlap_y=overlap,
    )
    multi = TiledInferer(runtime, config, tiling)
    labels, _ = multi.infer_arrays(image)
    single = TiledInferer(
        runtime, config,
        TilingParameters(128, 128, overlap, overlap),
    )
    labels_single, _ = single.infer_arrays(image)
    whole = np.asarray(
        apply_runtime(runtime, image[None], config)
    )[0].argmax(-1)
    assert labels.shape == (96, 96)
    # one tile == the whole-image forward's argmax exactly (no blending)
    np.testing.assert_array_equal(labels_single, whole)
    # blend bands may flip near-tie pixels (K=17 random logit channels
    # make close seconds common); every flip must BE a near-tie: the
    # whole-image logit gap between the two contending labels at each
    # disagreeing pixel stays a tiny fraction of the logit spread
    agree = (labels == labels_single).mean()
    assert agree > 0.95, f"only {agree:.4f} agreement between tilings"
    logits = np.asarray(apply_runtime(runtime, image[None], config))[0]
    flips = np.argwhere(labels != labels_single)
    spread = logits.max() - logits.min()
    for y, x in flips:
        gap = abs(
            logits[y, x, labels[y, x]] - logits[y, x, labels_single[y, x]]
        )
        assert gap < 0.05 * spread, (y, x, gap, spread)
    assert len(np.unique(labels)) > 1  # random init still uses >1 class


def test_gains_and_detection_vectors_of_17_apply():
    runtime, config = _runtime()
    rng = np.random.default_rng(2)
    image = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    inferer = TiledInferer(runtime, config)
    gains = [0.0] * K
    gains[13] = 1e6
    boosted = annonet_infer(inferer, image, gains=gains)
    assert (boosted == 13).all()
    # an enormous detection level with no qualifying seeds vetoes every
    # class-13 blob back to background (annonet_infer.cpp:219-238)
    detection = [0.0] * K
    detection[13] = 1e9
    vetoed = annonet_infer(
        inferer, image, gains=gains, detection_levels=detection
    )
    assert (vetoed == 0).all()


def test_int8_agrees_with_float_at_k17():
    runtime, config = _runtime(dtype="bfloat16")
    rng = np.random.default_rng(3)
    image = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    exact = TiledInferer(runtime, config)
    quant = TiledInferer(runtime, config, quantize="int8")
    ref, _ = exact.infer_arrays(image)
    quant.infer_arrays(image)  # calibration pass
    got, _ = quant.infer_arrays(image)
    agreement = float((ref == got).mean())
    assert agreement > 0.97, agreement


def test_confusion_matrix_formatter_at_k17():
    from annonet_jax.classes import AnnoClass
    from annonet_jax.infer.evaluation import (
        format_confusion_matrix,
        new_confusion_matrix,
        update_confusion_matrix_per_pixel,
    )

    classes = [
        AnnoClass(i, (i, 2 * i, 3 * i, 128), f"class_{i}") for i in range(K)
    ]
    rng = np.random.default_rng(4)
    pred = rng.integers(0, K, size=(40, 40)).astype(np.uint16)
    # labeled points for every class: column-major (x, y) point lists
    points_by_class = {}
    for cls in range(K):
        ys, xs = np.divmod(np.arange(cls * 40, cls * 40 + 40), 40)
        points_by_class[cls] = np.stack([xs, ys], axis=1)
    matrix = new_confusion_matrix(K)
    n = update_confusion_matrix_per_pixel(matrix, points_by_class, pred)
    assert n == K * 40 and matrix.sum() == K * 40
    out = format_confusion_matrix(matrix, classes)
    assert "predicted" in out and "recall" in out
    assert str(K - 1) in out  # the 17th class row/column is rendered
