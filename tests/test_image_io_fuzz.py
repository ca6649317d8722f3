"""Malformed-input robustness of the image I/O stack.

The reference inherits dlib's hardened libpng/libjpeg loaders
(/root/reference/annonet.cpp:150 dlib::load_image); our native decoder
(native/annonet_image_io.cpp) is new code parsing untrusted files, so it
gets a corpus-driven fuzz: truncated, bit-flipped, and adversarial
PNG/JPEG files (including crafted headers declaring absurd dimensions)
must produce errors-as-data (Sample.error, annonet.cpp:171-173 parity) —
never a crash, hang, or OOM — and the native path's accept/reject
classification must match the pure-PIL fallback's
(ANNONET_NO_NATIVE=1), because data/sample.py uses PIL as the final
arbiter on native decode errors.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from annonet_jax.classes import default_anno_classes
from annonet_jax.data.sample import (
    ImageFilenames,
    load_image,
    load_rgba,
    read_sample,
)


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def _crafted_png(width: int, height: int, idat: bytes = b"") -> bytes:
    """A syntactically valid PNG whose IHDR declares (width, height) —
    correct chunk CRCs, so the dimensions themselves are what the decoder
    must reject (not a checksum error)."""
    ihdr = struct.pack(">IIBBBBB", width & 0xFFFFFFFF, height & 0xFFFFFFFF,
                       8, 6, 0, 0, 0)  # 8-bit RGBA
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", ihdr)
        + _png_chunk(b"IDAT", idat or zlib.compress(b"\x00" * 8))
        + _png_chunk(b"IEND", b"")
    )


def _valid_png_bytes(mode: str = "RGB", size=(23, 17)) -> bytes:
    rng = np.random.default_rng(hash(mode) & 0xFFFF)
    if mode == "P":
        im = Image.fromarray(
            rng.integers(0, 8, size=size[::-1], dtype=np.uint8), "P"
        )
    elif mode in ("L", "LA", "RGB", "RGBA"):
        ch = len(mode)
        arr = rng.integers(0, 256, size=(size[1], size[0], ch), dtype=np.uint8)
        im = Image.fromarray(arr.squeeze() if ch == 1 else arr, mode)
    else:
        raise AssertionError(mode)
    buf = io.BytesIO()
    im.save(buf, "PNG")
    return buf.getvalue()


def _valid_jpeg_bytes(size=(23, 17)) -> bytes:
    rng = np.random.default_rng(7)
    arr = rng.integers(0, 256, size=(size[1], size[0], 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, "JPEG", quality=90)
    return buf.getvalue()


def _corpus() -> dict:
    """name -> file bytes. Everything an attacker-controlled dataset
    directory could contain."""
    png = _valid_png_bytes("RGB")
    jpg = _valid_jpeg_bytes()
    rng = np.random.default_rng(1234)

    cases = {
        "empty": b"",
        "garbage": bytes(rng.integers(0, 256, 512, dtype=np.uint8)),
        "png_magic_only": b"\x89PNG\r\n\x1a\n",
        "png_magic_garbage": b"\x89PNG\r\n\x1a\n"
        + bytes(rng.integers(0, 256, 256, dtype=np.uint8)),
        "jpeg_magic_garbage": b"\xff\xd8"
        + bytes(rng.integers(0, 256, 256, dtype=np.uint8)),
        "text_as_png": b"not an image at all, definitely",
        # truncations at several depths (header-only, mid-IDAT, just
        # before IEND)
        "png_trunc_20": png[:20],
        "png_trunc_half": png[: len(png) // 2],
        "png_trunc_almost": png[:-8],
        "jpeg_trunc_4": jpg[:4],
        "jpeg_trunc_half": jpg[: len(jpg) // 2],
        "jpeg_trunc_almost": jpg[:-6],
        # adversarial headers with CORRECT chunk CRCs: libpng reaches the
        # allocation decision, which must be capped, not attempted
        "png_dims_2^30": _crafted_png(1 << 30, 1 << 30),
        "png_dims_65500x65500": _crafted_png(65500, 65500),
        "png_dims_zero": _crafted_png(0, 0),
        "png_dims_zero_w": _crafted_png(0, 16),
        # IDAT that inflates to far less than H*W*4 (short data)
        "png_short_idat": _crafted_png(64, 64, zlib.compress(b"\x00" * 10)),
    }
    # seeded random byte flips over the valid files: CRC breaks, marker
    # corruption, chopped entropy data...
    for i in range(8):
        base = bytearray(png)
        for pos in rng.integers(8, len(base), 3):
            base[pos] ^= int(rng.integers(1, 256))
        cases[f"png_flip_{i}"] = bytes(base)
    for i in range(8):
        base = bytearray(jpg)
        for pos in rng.integers(2, len(base), 3):
            base[pos] ^= int(rng.integers(1, 256))
        cases[f"jpeg_flip_{i}"] = bytes(base)
    return cases


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fuzz_corpus")
    paths = {}
    for name, blob in _corpus().items():
        # every case gets a .png suffix: the dataset scanner only picks
        # up image endings, and the decoder sniffs magic bytes anyway
        p = d / f"{name}.png"
        p.write_bytes(blob)
        paths[name] = str(p)
    return paths


def test_native_decode_never_crashes(corpus_dir):
    """decode_image_native on the whole corpus: ndarray or OSError,
    never a segfault (the test process surviving IS the assertion) and
    never an uncapped allocation (the 2^30-square PNG would be 4 TiB)."""
    from annonet_jax.native import decode_image_native, get_lib

    if get_lib() is None or not hasattr(get_lib(), "annonet_decode_image"):
        pytest.skip("native image I/O unavailable")
    for name, path in corpus_dir.items():
        for channels in (1, 3, 4):
            try:
                arr = decode_image_native(path, channels)
            except OSError:
                continue  # includes FileNotFoundError; fine
            assert arr is None or (
                arr.dtype == np.uint8 and arr.ndim == 3
                and arr.shape[2] == channels
            ), f"{name}: bad decode result {type(arr)}"


def test_adversarial_dims_rejected_fast(corpus_dir):
    """The crafted huge-dimension PNGs are REJECTED by the native decoder
    (error code, no multi-GiB allocation). A wall-clock bound guards
    against quadratic/hanging behavior."""
    import time

    from annonet_jax.native import decode_image_native, get_lib

    if get_lib() is None or not hasattr(get_lib(), "annonet_decode_image"):
        pytest.skip("native image I/O unavailable")
    for name in ("png_dims_2^30", "png_dims_65500x65500", "png_dims_zero",
                 "png_dims_zero_w"):
        t0 = time.monotonic()
        with pytest.raises(OSError):
            decode_image_native(corpus_dir[name], 3)
        assert time.monotonic() - t0 < 5.0, f"{name} took too long"


def test_load_image_classification_matches_pure_pil(corpus_dir, monkeypatch):
    """For every corpus file, the full native+fallback chain (load_image /
    load_rgba) accepts or rejects EXACTLY when the pure-PIL path does,
    and accepted pixels are identical. This is the designed invariant of
    data/sample.py::_decode_with_fallback: PIL is the final arbiter."""
    results = {}
    for no_native in (False, True):
        if no_native:
            monkeypatch.setenv("ANNONET_NO_NATIVE", "1")
        else:
            monkeypatch.delenv("ANNONET_NO_NATIVE", raising=False)
        for name, path in corpus_dir.items():
            for fn, key in ((lambda p: load_image(p, False), "rgb"),
                            (lambda p: load_image(p, True), "gray"),
                            (load_rgba, "rgba")):
                try:
                    out = ("ok", fn(path))
                except Exception as e:
                    out = ("err", type(e).__name__)
                results.setdefault((name, key), {})[no_native] = out
    for (name, key), by_path in results.items():
        native_out, pil_out = by_path[False], by_path[True]
        assert native_out[0] == pil_out[0], (
            f"{name}/{key}: native chain {native_out} vs pure PIL {pil_out}"
        )
        if native_out[0] == "ok":
            np.testing.assert_array_equal(
                native_out[1], pil_out[1],
                err_msg=f"{name}/{key}: decoded pixels differ",
            )


def test_read_sample_errors_as_data(corpus_dir, monkeypatch):
    """read_sample over the corpus (as the IMAGE) never raises; bad files
    land in sample.error (annonet.cpp:171-173 parity), identically with
    and without the native module."""
    anno_classes = default_anno_classes()
    errors = {}
    for no_native in (False, True):
        if no_native:
            monkeypatch.setenv("ANNONET_NO_NATIVE", "1")
        else:
            monkeypatch.delenv("ANNONET_NO_NATIVE", raising=False)
        for name, path in corpus_dir.items():
            s = read_sample(
                ImageFilenames(image_filename=path),
                anno_classes, False, 1.0,
            )
            errors.setdefault(name, {})[no_native] = bool(s.error)
    for name, by_path in errors.items():
        assert by_path[False] == by_path[True], (
            f"{name}: native errored={by_path[False]} "
            f"vs fallback errored={by_path[True]}"
        )


def test_read_sample_corrupt_and_wrong_size_masks(tmp_path, monkeypatch):
    """Corrupt or wrong-size MASK files: errors-as-data, never a raise,
    same classification native vs fallback. Wrong-size masks must produce
    the reference's exact message (annonet.cpp:158-160)."""
    anno_classes = default_anno_classes()
    img_path = tmp_path / "img.png"
    Image.fromarray(
        np.zeros((20, 24, 3), np.uint8), "RGB"
    ).save(img_path)

    # wrong-size mask (valid PNG, 10x10 vs 20x24 image)
    wrong = tmp_path / "wrong_mask.png"
    Image.fromarray(np.zeros((10, 10, 4), np.uint8), "RGBA").save(wrong)
    # corrupt mask
    corrupt = tmp_path / "corrupt_mask.png"
    corrupt.write_bytes(_valid_png_bytes("RGBA")[:40])
    # adversarial-dims mask
    huge = tmp_path / "huge_mask.png"
    huge.write_bytes(_crafted_png(1 << 30, 1 << 30))

    for no_native in (False, True):
        if no_native:
            monkeypatch.setenv("ANNONET_NO_NATIVE", "1")
        else:
            monkeypatch.delenv("ANNONET_NO_NATIVE", raising=False)
        s = read_sample(
            ImageFilenames(str(img_path), str(wrong)),
            anno_classes, True, 1.0,
        )
        assert s.error == "Label image size mismatch"
        for bad in (corrupt, huge):
            s = read_sample(
                ImageFilenames(str(img_path), str(bad)),
                anno_classes, True, 1.0,
            )
            assert s.error, f"{bad} should have errored as data"


def test_exotic_but_valid_pngs_decode_identically(tmp_path, monkeypatch):
    """Palette, gray, gray+alpha, RGBA PNGs and a clean JPEG decode
    bit-identically through the native path and pure PIL (the native
    decoder normalizes via png_set_expand/gray_to_rgb/add_alpha +
    PIL-exact luma)."""
    files = {}
    for mode in ("P", "L", "LA", "RGB", "RGBA"):
        p = tmp_path / f"{mode}.png"
        p.write_bytes(_valid_png_bytes(mode))
        files[mode] = str(p)
    j = tmp_path / "clean.jpg"
    j.write_bytes(_valid_jpeg_bytes())
    files["JPEG"] = str(j)

    from annonet_jax.native import get_lib

    if get_lib() is None or not hasattr(get_lib(), "annonet_decode_image"):
        pytest.skip("native image I/O unavailable")

    for name, path in files.items():
        for fn in (lambda p: load_image(p, False),
                   lambda p: load_image(p, True),
                   load_rgba):
            monkeypatch.delenv("ANNONET_NO_NATIVE", raising=False)
            native = fn(path)
            monkeypatch.setenv("ANNONET_NO_NATIVE", "1")
            pil = fn(path)
            np.testing.assert_array_equal(
                native, pil, err_msg=f"{name} differs native vs PIL"
            )
