"""Tests for the data layer: codec, scanner, sample reader, outpaint.

Covers the reference behaviors cited in SURVEY.md §2.1 (dataset scanner,
sample reader, label codec, outpainting) with hand-built fixtures.
"""

import os

import numpy as np
import pytest
from PIL import Image

from annonet_jax.classes import IGNORE_LABEL, default_anno_classes
from annonet_jax.data import (
    ImageFilenames,
    decode_rgba_label_image,
    find_image_files,
    index_label_image_to_rgba_label_image,
    outpaint,
    read_sample,
    resize_label_image,
    rgba_label_to_index_label,
)
from annonet_jax.data.codec import labeled_points_by_class

CLASSES = default_anno_classes()


# ---------------------------------------------------------------- codec


def test_rgba_to_index_single_pixel():
    assert rgba_label_to_index_label((0, 0, 0, 0), CLASSES) == IGNORE_LABEL
    assert rgba_label_to_index_label((0, 255, 0, 64), CLASSES) == 0
    assert rgba_label_to_index_label((255, 255, 0, 128), CLASSES) == 1
    assert rgba_label_to_index_label((255, 0, 0, 128), CLASSES) == 2
    with pytest.raises(RuntimeError, match="Unknown class: r = 9, g = 8, b = 7, alpha = 6"):
        rgba_label_to_index_label((9, 8, 7, 6), CLASSES)


def test_decode_rgba_label_image():
    rgba = np.zeros((2, 3, 4), dtype=np.uint8)
    rgba[0, 0] = (0, 255, 0, 64)     # class 0
    rgba[0, 1] = (255, 255, 0, 128)  # class 1
    rgba[0, 2] = (0, 0, 0, 0)        # ignore
    rgba[1, 0] = (255, 0, 0, 128)    # class 2
    rgba[1, 1] = (0, 255, 0, 64)
    rgba[1, 2] = (0, 255, 0, 64)
    labels = decode_rgba_label_image(rgba, CLASSES)
    assert labels.dtype == np.uint16
    expected = np.array([[0, 1, IGNORE_LABEL], [2, 0, 0]], dtype=np.uint16)
    np.testing.assert_array_equal(labels, expected)


def test_decode_unknown_color_raises():
    rgba = np.zeros((1, 1, 4), dtype=np.uint8)
    rgba[0, 0] = (1, 2, 3, 4)
    with pytest.raises(RuntimeError, match="Unknown class: r = 1, g = 2, b = 3, alpha = 4"):
        decode_rgba_label_image(rgba, CLASSES)


def test_labeled_points_by_class_skips_ignore():
    labels = np.array([[0, IGNORE_LABEL, 1], [0, 0, 1]], dtype=np.uint16)
    points = labeled_points_by_class(labels)
    assert set(points.keys()) == {0, 1}
    # points are (x, y)
    np.testing.assert_array_equal(points[1], [[2, 0], [2, 1]])
    np.testing.assert_array_equal(points[0], [[0, 0], [0, 1], [1, 1]])


def test_encode_round_trip():
    labels = np.array([[0, 1], [2, 0]], dtype=np.uint16)
    rgba = index_label_image_to_rgba_label_image(labels, CLASSES)
    back = decode_rgba_label_image(rgba, CLASSES)
    np.testing.assert_array_equal(labels, back)


# ---------------------------------------------------------------- scanner


def _write_png(path, arr):
    Image.fromarray(arr).save(path)


def test_find_image_files(tmp_path):
    d = tmp_path / "data"
    sub = d / "sub"
    sub.mkdir(parents=True)

    img = np.zeros((4, 4, 3), dtype=np.uint8)
    mask = np.zeros((4, 4, 4), dtype=np.uint8)

    _write_png(str(d / "a.png"), img)
    _write_png(str(d / "a.png_mask.png"), mask)
    _write_png(str(d / "b.jpg"), img)                 # no mask
    _write_png(str(sub / "c.png"), img)
    _write_png(str(sub / "c.png_mask.png"), mask)
    _write_png(str(d / "a.png_result.png"), img)      # excluded
    _write_png(str(d / "d.bmp"), img)                 # wrong extension

    with_gt = find_image_files(str(d), require_ground_truth=True, verbose=False)
    assert sorted(os.path.basename(f.image_filename) for f in with_gt) == ["a.png", "c.png"]
    for f in with_gt:
        assert f.label_filename == f.image_filename + "_mask.png"

    without_gt = find_image_files(str(d), require_ground_truth=False, verbose=False)
    names = sorted(os.path.basename(f.image_filename) for f in without_gt)
    assert names == ["a.png", "b.jpg", "c.png"]
    by_name = {os.path.basename(f.image_filename): f for f in without_gt}
    assert by_name["b.jpg"].label_filename == ""


# ---------------------------------------------------------------- outpaint


def test_outpaint_replicates_interior_edges():
    img = np.arange(25, dtype=np.int32).reshape(5, 5)
    interior = img[1:4, 1:4].copy()
    out = outpaint(img, (1, 1, 3, 3))
    # interior untouched
    np.testing.assert_array_equal(out[1:4, 1:4], interior)
    # corners replicate interior corners
    assert out[0, 0] == interior[0, 0]
    assert out[0, 4] == interior[0, 2]
    assert out[4, 0] == interior[2, 0]
    assert out[4, 4] == interior[2, 2]
    # edges replicate nearest interior edge pixel
    assert out[0, 2] == interior[0, 1]
    assert out[2, 0] == interior[1, 0]
    assert out[2, 4] == interior[1, 2]
    assert out[4, 2] == interior[2, 1]


def test_outpaint_empty_interior_is_noop():
    img = np.arange(9, dtype=np.int32).reshape(3, 3)
    expected = img.copy()
    outpaint(img, (5, 5, 7, 7))  # entirely outside image
    np.testing.assert_array_equal(img, expected)


def test_outpaint_channels():
    img = np.random.default_rng(0).integers(0, 255, (6, 6, 3)).astype(np.uint8)
    out = outpaint(img.copy(), (2, 2, 3, 3))
    np.testing.assert_array_equal(out[0, 0], img[2, 2])
    np.testing.assert_array_equal(out[5, 5], img[3, 3])


# ---------------------------------------------------------------- resize


def test_resize_label_image_nearest():
    labels = np.array([[0, 1], [2, 3]], dtype=np.uint16)
    up = resize_label_image(labels, 4, 4)
    assert up.shape == (4, 4)
    # each source pixel becomes a 2x2 block
    np.testing.assert_array_equal(up[:2, :2], 0)
    np.testing.assert_array_equal(up[:2, 2:], 1)
    np.testing.assert_array_equal(up[2:, :2], 2)
    np.testing.assert_array_equal(up[2:, 2:], 3)
    # and back down
    down = resize_label_image(up, 2, 2)
    np.testing.assert_array_equal(down, labels)


# ---------------------------------------------------------------- read_sample


def _make_dataset(tmp_path, w=16, h=12):
    img = np.zeros((h, w, 3), dtype=np.uint8)
    img[:, : w // 2] = 255
    mask = np.zeros((h, w, 4), dtype=np.uint8)
    mask[:, : w // 2] = (0, 255, 0, 64)        # class 0
    mask[:, w // 2 :] = (255, 255, 0, 128)     # class 1
    img_path = str(tmp_path / "img.png")
    _write_png(img_path, img)
    _write_png(img_path + "_mask.png", mask)
    return ImageFilenames(img_path, img_path + "_mask.png")


def test_read_sample_basic(tmp_path):
    files = _make_dataset(tmp_path)
    sample = read_sample(files, CLASSES, require_ground_truth=True, downscaling_factor=1.0)
    assert sample.error == ""
    assert sample.original_width == 16 and sample.original_height == 12
    assert sample.input_image.shape == (12, 16, 3)
    assert sample.label_image.shape == (12, 16)
    assert set(sample.labeled_points_by_class.keys()) == {0, 1}


def test_read_sample_downscaling(tmp_path):
    files = _make_dataset(tmp_path)
    sample = read_sample(files, CLASSES, require_ground_truth=True, downscaling_factor=2.0)
    assert sample.error == ""
    # original size still recorded pre-downscale
    assert sample.original_width == 16 and sample.original_height == 12
    assert sample.input_image.shape == (6, 8, 3)
    assert sample.label_image.shape == (6, 8)


def test_read_sample_size_mismatch(tmp_path):
    img = np.zeros((10, 10, 3), dtype=np.uint8)
    mask = np.zeros((8, 8, 4), dtype=np.uint8)
    mask[...] = (0, 255, 0, 64)
    img_path = str(tmp_path / "img.png")
    _write_png(img_path, img)
    _write_png(img_path + "_mask.png", mask)
    sample = read_sample(
        ImageFilenames(img_path, img_path + "_mask.png"),
        CLASSES,
        require_ground_truth=True,
        downscaling_factor=1.0,
    )
    assert sample.error == "Label image size mismatch"


def test_read_sample_missing_ground_truth(tmp_path):
    img_path = str(tmp_path / "img.png")
    _write_png(img_path, np.zeros((5, 5, 3), dtype=np.uint8))
    sample = read_sample(
        ImageFilenames(img_path, ""),
        CLASSES,
        require_ground_truth=True,
        downscaling_factor=1.0,
    )
    assert sample.error == "No ground truth available"
    # without the requirement there is no error, just no labels
    sample2 = read_sample(
        ImageFilenames(img_path, ""),
        CLASSES,
        require_ground_truth=False,
        downscaling_factor=1.0,
    )
    assert sample2.error == ""
    assert sample2.label_image is None


def test_read_sample_grayscale(tmp_path):
    files = _make_dataset(tmp_path)
    sample = read_sample(
        files, CLASSES, require_ground_truth=True, downscaling_factor=1.0, grayscale=True
    )
    assert sample.error == ""
    assert sample.input_image.shape == (12, 16, 1)


def test_read_sample_unreadable_file_error_captured(tmp_path):
    sample = read_sample(
        ImageFilenames(str(tmp_path / "missing.png"), ""),
        CLASSES,
        require_ground_truth=False,
        downscaling_factor=1.0,
    )
    assert sample.error != ""
