"""Native C++ host-runtime module: build, parity vs Python fallbacks."""

import os

import numpy as np
import pytest

from annonet_jax.classes import IGNORE_LABEL
from annonet_jax import native


requires_native = pytest.mark.skipif(
    native.get_lib() is None, reason="native module unavailable"
)


@requires_native
def test_ccl_matches_python_fallback():
    rng = np.random.default_rng(0)
    for _ in range(10):
        labels = rng.integers(0, 4, size=(40, 50)).astype(np.uint16)
        labels[rng.random(labels.shape) < 0.1] = IGNORE_LABEL

        from annonet_jax.ops import blobs as blobs_mod

        native_blobs, native_count = native.label_connected_blobs_native(
            labels, True, True
        )
        os.environ["ANNONET_NO_NATIVE"] = "1"
        try:
            py_blobs, py_count = blobs_mod.label_connected_blobs(
                labels, zero_is_background=True, ignore_is_background=True
            )
        finally:
            del os.environ["ANNONET_NO_NATIVE"]

        assert native_count == py_count
        # same partition: blob ids must be a bijection of each other
        assert (native_blobs == 0).tolist() == (py_blobs == 0).tolist()
        pairs = set(zip(native_blobs.ravel().tolist(), py_blobs.ravel().tolist()))
        # each native id maps to exactly one python id and vice versa
        assert len({a for a, _ in pairs}) == len(pairs)
        assert len({b for _, b in pairs}) == len(pairs)


@requires_native
def test_extract_crop_matches_python_fallback():
    rng = np.random.default_rng(1)
    image = rng.integers(0, 256, size=(30, 20, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, size=(30, 20)).astype(np.uint16)

    from annonet_jax.data import crop as crop_mod

    for rect in [(-5, -7, 10, 8), (5, 5, 14, 14), (10, 25, 40, 35),
                 (-3, 28, 25, 33)]:
        native_img, native_lab = crop_mod.extract_crop(image, labels, rect)
        os.environ["ANNONET_NO_NATIVE"] = "1"
        try:
            py_img, py_lab = crop_mod.extract_crop(image, labels, rect)
        finally:
            del os.environ["ANNONET_NO_NATIVE"]
        np.testing.assert_array_equal(native_img, py_img)
        np.testing.assert_array_equal(native_lab, py_lab)


requires_image_io = pytest.mark.skipif(
    native.get_lib() is None
    or not hasattr(native.get_lib(), "annonet_decode_image"),
    reason="native image I/O unavailable",
)


@requires_image_io
def test_native_decode_matches_pil(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    rgba = rng.integers(0, 256, size=(21, 17, 4), dtype=np.uint8)
    png_path = str(tmp_path / "x.png")
    Image.fromarray(rgba, mode="RGBA").save(png_path)
    # RGBA round trip is exact
    np.testing.assert_array_equal(
        native.decode_image_native(png_path, 4), rgba
    )
    # RGB: alpha dropped
    np.testing.assert_array_equal(
        native.decode_image_native(png_path, 3), rgba[..., :3]
    )
    # grayscale matches PIL's L conversion exactly
    pil_gray = np.asarray(
        Image.fromarray(rgba[..., :3], mode="RGB").convert("L")
    )
    np.testing.assert_array_equal(
        native.decode_image_native(png_path, 1)[..., 0], pil_gray
    )

    # JPEG decode agrees with PIL (same libjpeg underneath)
    rgb = rng.integers(0, 256, size=(32, 48, 3), dtype=np.uint8)
    jpg_path = str(tmp_path / "y.jpg")
    Image.fromarray(rgb, mode="RGB").save(jpg_path, quality=90)
    pil_rgb = np.asarray(Image.open(jpg_path).convert("RGB"))
    native_rgb = native.decode_image_native(jpg_path, 3)
    assert native_rgb.shape == pil_rgb.shape
    assert np.abs(
        native_rgb.astype(int) - pil_rgb.astype(int)
    ).max() <= 1  # decoder rounding may differ by 1 LSB


@requires_image_io
def test_native_png_encode_round_trip(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    rgba = rng.integers(0, 256, size=(15, 23, 4), dtype=np.uint8)
    path = str(tmp_path / "out.png")
    assert native.encode_png_rgba_native(path, rgba)
    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(back, rgba)


@requires_image_io
def test_native_decode_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.decode_image_native(str(tmp_path / "missing.png"), 3)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\nnot really a png")
    with pytest.raises(OSError):
        native.decode_image_native(str(bad), 3)


@requires_native
def test_native_resize_matches_numpy_fallback():
    rng = np.random.default_rng(2)
    from annonet_jax.data import sample as sample_mod

    for shape, target in [((31, 45, 3), (17, 23)), ((64, 64, 1), (96, 128)),
                          ((10, 10), (7, 5))]:
        image = rng.integers(0, 256, size=shape, dtype=np.uint8)
        native_out = sample_mod.resize_image_bilinear(
            image, target[1], target[0]
        )
        os.environ["ANNONET_NO_NATIVE"] = "1"
        try:
            py_out = sample_mod.resize_image_bilinear(
                image, target[1], target[0]
            )
        finally:
            del os.environ["ANNONET_NO_NATIVE"]
        assert native_out.shape == py_out.shape
        # float rounding at the .5 boundary may differ by 1 LSB
        assert np.abs(
            native_out.astype(int) - py_out.astype(int)
        ).max() <= 1


@requires_native
def test_ccl_ignore_not_background_forms_blobs():
    labels = np.full((3, 3), IGNORE_LABEL, dtype=np.uint16)
    blobs, count = native.label_connected_blobs_native(labels, True, False)
    # ignore pixels are a regular equal-valued blob when not background
    assert count == 2
    assert (blobs == 1).all()
