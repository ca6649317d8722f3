"""Tests for the input pipeline: crop sampling, filters, cache, augmentation,
threaded loading. Models the reference's test strategy (SURVEY.md §4) plus
what it lacks: pipeline integration coverage."""

import os

import numpy as np
import pytest

from annonet_jax.classes import IGNORE_LABEL, AnnoClass
from annonet_jax.data.cache import SharedLruCache
from annonet_jax.data.crop import (
    CropOptions,
    centered_rect,
    extract_crop,
    random_rect_containing_point,
    randomly_crop_sample,
)
from annonet_jax.data.dataset import ImageFilenames
from annonet_jax.data.filters import ignore_classes, ignore_large_nonzero_regions
from annonet_jax.data.pipeline import CropPipeline, RegionFilterOptions
from annonet_jax.data.sample import Sample
from annonet_jax.data.codec import labeled_points_by_class
from annonet_jax.ops.blobs import label_connected_blobs


def make_sample(label_image, image=None):
    label_image = np.asarray(label_image, dtype=np.uint16)
    h, w = label_image.shape
    if image is None:
        image = np.random.default_rng(0).integers(
            0, 256, size=(h, w, 3), dtype=np.uint8
        )
    return Sample(
        image_filenames=ImageFilenames("img.png", "img.png_mask.png"),
        original_width=w,
        original_height=h,
        input_image=image,
        label_image=label_image,
        labeled_points_by_class=labeled_points_by_class(label_image),
    )


# ---------------------------------------------------------------- geometry


def test_random_rect_contains_point():
    # parity with test/annonet_test.cpp:122-130
    rng = np.random.default_rng(42)
    for _ in range(200):
        x, y = int(rng.integers(-50, 50)), int(rng.integers(-50, 50))
        w, h = int(rng.integers(1, 20)), int(rng.integers(1, 20))
        l, t, r, b = random_rect_containing_point(rng, (x, y), w, h)
        assert r - l + 1 == w and b - t + 1 == h
        assert l <= x <= r and t <= y <= b


def test_centered_rect_dlib_semantics():
    assert centered_rect(5, 5, 4, 4) == (3, 3, 6, 6)
    assert centered_rect(5, 5, 3, 3) == (4, 4, 6, 6)


def test_extract_crop_interior_and_padding():
    labels = np.arange(25, dtype=np.uint16).reshape(5, 5)
    image = np.stack([labels.astype(np.uint8)] * 3, axis=-1)
    img_crop, lab_crop = extract_crop(image, labels, (1, 1, 3, 3))
    np.testing.assert_array_equal(lab_crop, labels[1:4, 1:4])

    # crop hanging off the top-left corner: image replicates, labels ignore
    img_crop, lab_crop = extract_crop(image, labels, (-2, -2, 2, 2))
    assert lab_crop.shape == (5, 5)
    assert (lab_crop[:2, :] == IGNORE_LABEL).all()
    assert (lab_crop[:, :2] == IGNORE_LABEL).all()
    np.testing.assert_array_equal(lab_crop[2:, 2:], labels[:3, :3])
    # replicate padding clamps to pixel (0,0)
    assert (img_crop[0, 0] == image[0, 0]).all()
    np.testing.assert_array_equal(img_crop[2:, 2:], image[:3, :3])


def test_randomly_crop_sample_contains_labeled_point():
    labels = np.zeros((32, 32), dtype=np.uint16)
    labels[10, 20] = 1  # single labeled defect point
    labels[labels == 0] = IGNORE_LABEL
    labels[10, 20] = 1
    sample = make_sample(labels)
    rng = np.random.default_rng(7)
    opts = CropOptions(dim=8)
    for _ in range(20):
        img, lab = randomly_crop_sample(sample, opts, rng)
        assert img.shape == (8, 8, 3)
        assert lab.shape == (8, 8)
        assert (lab == 1).sum() == 1  # the point is inside every crop


def test_randomly_crop_sample_further_downscaling():
    labels = np.ones((64, 64), dtype=np.uint16)
    sample = make_sample(labels)
    rng = np.random.default_rng(3)
    opts = CropOptions(dim=16, further_downscaling_factor=2.0)
    img, lab = randomly_crop_sample(sample, opts, rng)
    assert img.shape == (16, 16, 3)
    assert lab.shape == (16, 16)


# ---------------------------------------------------------------- filters


def test_ignore_classes():
    labels = np.array([[0, 1, 2], [1, 1, 2], [0, 0, 2]], dtype=np.uint16)
    sample = make_sample(labels)
    ignore_classes(sample, [1])
    assert 1 not in sample.labeled_points_by_class
    assert (sample.label_image == IGNORE_LABEL).sum() == 3
    assert (sample.label_image == 2).sum() == 3


def test_blob_labeling_equal_values_8conn():
    labels = np.array(
        [
            [1, 1, 0, 2],
            [0, 1, 0, 2],
            [0, 0, 1, 0],
            [3, 0, 0, 0],
        ],
        dtype=np.uint16,
    )
    blobs, count = label_connected_blobs(labels)
    assert blobs[0, 0] == blobs[0, 1] == blobs[1, 1]
    # 8-connectivity links (1,1) and (2,2) diagonally
    assert blobs[2, 2] == blobs[1, 1]
    assert blobs[0, 3] == blobs[1, 3] != blobs[0, 0]
    assert blobs[3, 0] not in (0, blobs[0, 0], blobs[0, 3])
    assert (blobs[labels == 0] == 0).all()
    assert count == blobs.max() + 1


def test_ignore_large_nonzero_regions_by_area():
    labels = np.zeros((20, 20), dtype=np.uint16)
    labels[0:10, 0:10] = 1  # 100-pixel blob
    labels[15, 15] = 2  # 1-pixel blob
    sample = make_sample(labels)
    # receptive field 2 -> area threshold 1.0 * 4 = 4 pixels
    ignore_large_nonzero_regions(sample, receptive_field_side=2, by_area=1.0)
    assert 1 not in sample.labeled_points_by_class
    assert 2 in sample.labeled_points_by_class
    assert (sample.label_image[0:10, 0:10] == IGNORE_LABEL).all()
    assert sample.label_image[15, 15] == 2
    # background stays
    assert sample.label_image[19, 0] == 0


def test_ignore_large_nonzero_regions_keeps_background_blob():
    labels = np.zeros((16, 16), dtype=np.uint16)  # all background
    labels[2, 2] = 1
    sample = make_sample(labels)
    ignore_large_nonzero_regions(
        sample, receptive_field_side=1, by_width=0.5
    )  # width threshold < 1 still keeps 1x1? no: width 1 > 0.5 -> ignored
    assert 1 not in sample.labeled_points_by_class
    assert 0 in sample.labeled_points_by_class  # background always kept


# ---------------------------------------------------------------- cache


def test_lru_cache_eviction_and_reload():
    loads = []

    def factory(k):
        loads.append(k)
        return k * 10

    cache = SharedLruCache(factory, capacity=2)
    assert cache(1) == 10
    assert cache(2) == 20
    assert cache(1) == 10  # hit
    assert loads == [1, 2]
    cache(3)  # evicts 2 (LRU)
    assert cache(2) == 20
    assert loads == [1, 2, 3, 2]


def test_lru_cache_concurrent_single_load():
    import threading
    import time

    loads = []

    def slow_factory(k):
        loads.append(k)
        time.sleep(0.05)
        return k

    cache = SharedLruCache(slow_factory, capacity=4)
    threads = [threading.Thread(target=cache, args=(7,)) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert loads == [7]


# ---------------------------------------------------------------- augment


def test_augment_noop_passthrough():
    import jax

    images = np.random.default_rng(0).integers(
        0, 256, size=(2, 8, 8, 3), dtype=np.uint8
    )
    labels = np.random.default_rng(1).integers(
        0, 3, size=(2, 8, 8)
    ).astype(np.int32)
    from annonet_jax.ops.augment import augment_batch

    out_img, out_lab = augment_batch(
        jax.random.PRNGKey(0), images, labels
    )
    np.testing.assert_array_equal(np.asarray(out_img), images.astype(np.float32))
    np.testing.assert_array_equal(np.asarray(out_lab), labels)


def test_augment_flip_consistency():
    """When a flip happens, image and labels flip together."""
    import jax

    # make labels encode pixel position so flips are detectable
    h = w = 8
    base = np.arange(h * w, dtype=np.int32).reshape(1, h, w)
    images = base[..., None].astype(np.uint8)  # truncated is fine
    labels = base.copy()
    from annonet_jax.ops.augment import augment_batch

    flipped_any = False
    for seed in range(8):
        out_img, out_lab = augment_batch(
            jax.random.PRNGKey(seed),
            images,
            labels,
            allow_flip_left_right=True,
            allow_flip_upside_down=True,
        )
        out_img = np.asarray(out_img)[..., 0]
        out_lab = np.asarray(out_lab)
        # image (mod 256) must track the label permutation exactly
        np.testing.assert_array_equal(
            out_img.astype(np.int32), out_lab % 256
        )
        if not np.array_equal(out_lab, labels):
            flipped_any = True
    assert flipped_any


def test_augment_brightness_and_noise_bounds():
    import jax

    images = np.full((2, 8, 8, 3), 128, dtype=np.uint8)
    labels = np.zeros((2, 8, 8), dtype=np.int32)
    from annonet_jax.ops.augment import augment_batch

    out_img, _ = augment_batch(
        jax.random.PRNGKey(5),
        images,
        labels,
        multiplicative_brightness_change_probability=1.0,
        multiplicative_brightness_change_sigma=0.5,
        noise_level_stddev=10.0,
        allow_random_color_offset=True,
    )
    out = np.asarray(out_img)
    assert out.min() >= 0.0 and out.max() <= 255.0
    assert (out == np.round(out)).all()  # integer-valued like uint8 stages


# ---------------------------------------------------------------- pipeline


@pytest.fixture
def tiny_dataset(tmp_path):
    from PIL import Image

    from annonet_jax.classes import default_anno_classes

    anno_classes = default_anno_classes()
    rng = np.random.default_rng(0)
    files = []
    for i in range(3):
        img = rng.integers(0, 256, size=(24, 24, 3), dtype=np.uint8)
        mask = np.zeros((24, 24, 4), dtype=np.uint8)
        # half clean (class 0), one defect square (class 1)
        mask[:, :12] = anno_classes[0].rgba_label
        mask[4:8, 14:18] = anno_classes[1].rgba_label
        img_path = tmp_path / f"im{i}.png"
        Image.fromarray(img).save(img_path)
        Image.fromarray(mask, mode="RGBA").save(
            tmp_path / f"im{i}.png_mask.png"
        )
        files.append(
            ImageFilenames(str(img_path), str(img_path) + "_mask.png")
        )
    return files, anno_classes


def test_crop_pipeline_minibatch(tiny_dataset):
    files, anno_classes = tiny_dataset
    opts = CropOptions(dim=16)
    with CropPipeline(
        files,
        anno_classes,
        opts,
        thread_count=2,
        cached_image_count=2,
        queue_depth=8,
        seed=11,
    ) as pipe:
        images, labels = pipe.next_minibatch(4, warn=None)
    assert images.shape == (4, 16, 16, 3) and images.dtype == np.uint8
    assert labels.shape == (4, 16, 16) and labels.dtype == np.uint16
    valid = labels[labels != IGNORE_LABEL]
    assert valid.size > 0 and set(np.unique(valid)) <= {0, 1}


def test_crop_pipeline_warning_on_empty_labels(tmp_path):
    from PIL import Image

    from annonet_jax.classes import default_anno_classes

    anno_classes = default_anno_classes()
    img = np.zeros((16, 16, 3), dtype=np.uint8)
    mask = np.zeros((16, 16, 4), dtype=np.uint8)  # all-ignore mask
    img_path = tmp_path / "empty.png"
    Image.fromarray(img).save(img_path)
    Image.fromarray(mask, mode="RGBA").save(tmp_path / "empty.png_mask.png")
    files = [ImageFilenames(str(img_path), str(img_path) + "_mask.png")]

    warnings = []
    with CropPipeline(
        files, anno_classes, CropOptions(dim=8), thread_count=1, seed=0
    ) as pipe:
        import queue as _q
        import threading

        # the pipeline only produces warnings; grab a few crops directly
        for _ in range(3):
            crop = pipe._queue.get()
            if crop.warning:
                warnings.append(crop.warning)
    assert any("no labeled points" in w for w in warnings)


def test_fused_train_step_runs(tiny_dataset):
    from annonet_jax.models.segnet import SegNetConfig
    from annonet_jax.train.trainer import Trainer, TrainerConfig

    files, anno_classes = tiny_dataset
    opts = CropOptions(
        dim=16,
        allow_flip_left_right=True,
        noise_level_stddev=2.0,
        multiplicative_brightness_change_probability=0.5,
    )
    model_config = SegNetConfig(class_count=3, level_count=1, base_width=4)
    trainer = Trainer(model_config, TrainerConfig(initial_learning_rate=0.01))
    with CropPipeline(
        files, anno_classes, opts, thread_count=2, seed=5
    ) as pipe:
        images, labels = pipe.next_minibatch(2, warn=None)
        loss1 = trainer.train_step_crops(images, labels, opts)
        loss2 = trainer.train_step_crops(images, labels, opts)
    assert np.isfinite(loss1) and np.isfinite(loss2)
    assert trainer.step_count == 2


def test_batched_extraction_matches_per_crop_path(tiny_dataset):
    """Decision mode (one native batch-extract per minibatch) must produce
    byte-identical batches to the legacy per-crop path: same rng stream,
    same extraction semantics."""
    files, classes = tiny_dataset
    options = CropOptions(dim=24)

    def batches(force_legacy):
        with CropPipeline(
            files, classes, options, thread_count=1, seed=7,
            force_per_crop_extraction=force_legacy,
        ) as pipe:
            out = [pipe.next_minibatch(6, warn=None) for _ in range(3)]
        return out

    fast = batches(force_legacy=False)
    legacy = batches(force_legacy=True)
    for (fi, fl), (li, ll) in zip(fast, legacy):
        np.testing.assert_array_equal(fi, li)
        np.testing.assert_array_equal(fl, ll)


def test_batched_extraction_python_fallback(tiny_dataset, monkeypatch):
    """With the native module disabled the decision mode falls back to the
    per-crop Python extraction and still matches."""
    monkeypatch.setenv("ANNONET_NO_NATIVE", "1")
    import annonet_jax.native as native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", True)

    files, classes = tiny_dataset
    options = CropOptions(dim=24)
    with CropPipeline(
        files, classes, options, thread_count=1, seed=7
    ) as pipe:
        images, labels = pipe.next_minibatch(6, warn=None)
    assert images.shape == (6, 24, 24, 3)
    assert labels.shape == (6, 24, 24)
    assert labels.dtype == np.uint16


def test_extract_crops_batch_native_vs_single():
    """The native batch call equals per-crop extract_crop, including
    out-of-bounds rects (replicate/ignore padding) and multi-threading."""
    from annonet_jax.data.crop import extract_crop
    from annonet_jax.native import extract_crops_batch_native, get_lib

    if get_lib() is None:
        import pytest

        pytest.skip("native module unavailable")
    rng = np.random.default_rng(3)
    sources, rects = [], []
    for i in range(9):
        h, w = int(rng.integers(20, 40)), int(rng.integers(20, 40))
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        lbl = rng.integers(0, 4, size=(h, w)).astype(np.uint16)
        sources.append((img, lbl))
        # rects deliberately hanging over every edge
        top = int(rng.integers(-10, h))
        left = int(rng.integers(-10, w))
        rects.append((top, left))
    dim = 16
    out_i = np.empty((9, dim, dim, 3), np.uint8)
    out_l = np.empty((9, dim, dim), np.uint16)
    assert extract_crops_batch_native(
        sources, rects, dim, dim, out_i, out_l, thread_count=3
    )
    for i, ((img, lbl), (top, left)) in enumerate(zip(sources, rects)):
        want_i, want_l = extract_crop(
            img, lbl, (left, top, left + dim - 1, top + dim - 1)
        )
        np.testing.assert_array_equal(out_i[i], want_i)
        np.testing.assert_array_equal(out_l[i], want_l)


def test_pipeline_error_propagates_in_decision_mode(tmp_path):
    """A corrupt mask travels through the queue as data and raises in
    next_minibatch (annonet_train_main.cpp:594-596 semantics), with the
    pipeline shutting down cleanly afterwards."""
    from PIL import Image

    from annonet_jax.classes import default_anno_classes

    anno_classes = default_anno_classes()
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(24, 24, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "im0.png")
    # mask with the wrong size -> read_sample records an error
    bad = np.zeros((7, 9, 4), np.uint8)
    Image.fromarray(bad, mode="RGBA").save(tmp_path / "im0.png_mask.png")
    files = [
        ImageFilenames(
            str(tmp_path / "im0.png"), str(tmp_path / "im0.png_mask.png")
        )
    ]
    with CropPipeline(
        files, anno_classes, CropOptions(dim=16), thread_count=2, seed=0
    ) as pipe:
        assert pipe._decision_mode
        with pytest.raises(RuntimeError):
            pipe.next_minibatch(4, warn=None)


def test_further_downscaling_factor_crop_sizes(tiny_dataset):
    """Reference semantics (annonet_train_main.cpp:174-180): factors <= 1
    extract round(dim*fdf) chips WITHOUT resizing (decision mode handles
    them); factors > 1 extract bigger chips and resize down to dim
    (per-crop path)."""
    files, classes = tiny_dataset
    for fdf, expect_dim, expect_decision in (
        (0.5, 8, True), (1.0, 16, True), (2.0, 16, False),
    ):
        options = CropOptions(dim=16, further_downscaling_factor=fdf)
        with CropPipeline(
            files, classes, options, thread_count=1, seed=3
        ) as pipe:
            assert pipe._decision_mode == expect_decision, fdf
            images, labels = pipe.next_minibatch(4, warn=None)
        assert images.shape == (4, expect_dim, expect_dim, 3), fdf
        assert labels.shape == (4, expect_dim, expect_dim), fdf


def test_pin_budget_fallback_is_identical(tiny_dataset):
    """With a zero pin budget every producer extracts its own pixels (same
    drawn rect), so batches are byte-identical to unconstrained decision
    mode, and the accounting returns to zero."""
    files, classes = tiny_dataset
    options = CropOptions(dim=24)

    def batches(budget):
        with CropPipeline(
            files, classes, options, thread_count=1, seed=7,
            pinned_bytes_budget=budget,
        ) as pipe:
            out = [pipe.next_minibatch(6, warn=None) for _ in range(3)]
            pinned = pipe._pinned_bytes
        return out, pinned

    fast, pinned_fast = batches(512 << 20)
    tight, pinned_tight = batches(0)
    # queued (not yet consumed) decisions may still hold pins; the budget
    # bounds them. With budget 0 nothing ever pins.
    assert 0 <= pinned_fast <= 512 << 20
    assert pinned_tight == 0
    for (fi, fl), (ti, tl) in zip(fast, tight):
        np.testing.assert_array_equal(fi, ti)
        np.testing.assert_array_equal(fl, tl)


def test_pin_budget_fallback_throughput_under_stress(tmp_path):
    """The zero-budget fallback (every producer extracts its own pixels,
    data/pipeline.py::_make_crop) must keep flowing under multi-threaded
    stress — no lock serialization, no deadlock — at a throughput
    comparable to the pinned decision path on the same box.

    Uses larger images than tiny_dataset so pin accounting is exercised
    with realistic per-sample sizes; the ratio bound is deliberately
    generous (the fallback adds one extract_crop per crop, which is cheap
    next to the shared decode) — it exists to catch pathological
    serialization, not to benchmark."""
    import time

    from PIL import Image

    from annonet_jax.classes import default_anno_classes

    anno_classes = default_anno_classes()
    rng = np.random.default_rng(1)
    files = []
    for i in range(4):
        img = rng.integers(0, 256, size=(256, 256, 3), dtype=np.uint8)
        mask = np.zeros((256, 256, 4), dtype=np.uint8)
        mask[:, :128] = anno_classes[0].rgba_label
        mask[60:90, 160:200] = anno_classes[1].rgba_label
        img_path = tmp_path / f"im{i}.png"
        Image.fromarray(img).save(img_path)
        Image.fromarray(mask, mode="RGBA").save(
            tmp_path / f"im{i}.png_mask.png"
        )
        files.append(
            ImageFilenames(str(img_path), str(img_path) + "_mask.png")
        )

    options = CropOptions(dim=64)

    def run(budget):
        with CropPipeline(
            files, anno_classes, options, thread_count=4, seed=11,
            cached_image_count=4, queue_depth=64,
            pinned_bytes_budget=budget,
        ) as pipe:
            pipe.next_minibatch(32, warn=None)  # warm the decode cache
            t0 = time.monotonic()
            n = 0
            for _ in range(8):
                images, labels = pipe.next_minibatch(32, warn=None)
                n += images.shape[0]
            dt = time.monotonic() - t0
            assert pipe._pinned_bytes <= max(0, budget)
        return n / dt

    pinned_rate = run(512 << 20)
    fallback_rate = run(0)
    # sanity floor + no-serialization bound (both loose for CI boxes)
    assert fallback_rate > 50, fallback_rate
    assert fallback_rate > 0.1 * pinned_rate, (fallback_rate, pinned_rate)


def test_deterministic_stream_is_thread_count_invariant(tiny_dataset):
    """deterministic=True pins the crop-decision stream to (seed, dataset):
    the sequence of (source image, rect) decisions is identical for 1 and 4
    loader threads (with 4, threads 2-4 are decode prefetchers that cannot
    reorder decisions), and differs for a different seed."""
    files, classes = tiny_dataset
    options = CropOptions(dim=16)

    def stream(threads, seed, batches=4, batch=8):
        out = []
        with CropPipeline(
            files, classes, options, thread_count=threads, seed=seed,
            cached_image_count=2, queue_depth=8, deterministic=True,
        ) as pipe:
            for _ in range(batches):
                kind, samples, rects = pipe.next_decisions(batch, warn=None)
                assert kind == "decisions"
                out.extend(
                    (s.image_filenames.image_filename, r)
                    for s, r in zip(samples, rects)
                )
        return out

    base = stream(1, seed=5)
    assert stream(4, seed=5) == base
    assert stream(4, seed=5) == base  # and stable across runs
    assert stream(4, seed=6) != base


def test_deterministic_mode_minibatch_and_single_thread(tiny_dataset):
    """deterministic=True with thread_count=1 (no prefetchers) still
    produces valid minibatches through the pixel-assembly path."""
    files, classes = tiny_dataset
    options = CropOptions(dim=16)
    with CropPipeline(
        files, classes, options, thread_count=1, seed=3,
        cached_image_count=2, queue_depth=8, deterministic=True,
    ) as pipe:
        images, labels = pipe.next_minibatch(4, warn=None)
    assert images.shape == (4, 16, 16, 3)
    assert labels.shape == (4, 16, 16)
    valid = labels[labels != IGNORE_LABEL]
    assert valid.size > 0 and set(np.unique(valid)) <= {0, 1}
