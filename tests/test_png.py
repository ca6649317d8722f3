"""The built-in PNG codec (data/png.py) and the PIL-free image paths.

The codec is the last fallback behind the native module and PIL, so the
PNG read/write path of train, infer and serve works with neither. Files
are checked against PIL (available in the test environment) where PIL is
the independent writer or reader, and the PIL-free paths are checked with
PIL made unimportable.
"""

import io
import struct
import sys
import zlib

import numpy as np
import pytest

from annonet_jax.data.png import decode_png, encode_png

MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _image(h, w, c, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=(h, w, c), dtype=np.uint8
    )


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filtered_png(image, filter_of_row):
    """An 8-bit PNG whose row y uses filter type filter_of_row(y) — a
    straightforward per-byte encoder, independent of the codec."""
    h, w, c = image.shape
    raw = bytearray()
    prev = [0] * (w * c)
    for y in range(h):
        row = image[y].reshape(-1).tolist()
        ft = filter_of_row(y)
        out = []
        for i, v in enumerate(row):
            a = row[i - c] if i >= c else 0
            b = prev[i]
            cc = prev[i - c] if i >= c else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, cc))[ft]
            out.append((v - pred) & 0xFF)
        raw.append(ft)
        raw.extend(out)
        prev = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("size", [(1, 1), (7, 5), (33, 64)])
@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_decode_every_filter_type(channels, size, filter_type):
    image = _image(*size, channels, seed=filter_type)
    png = _filtered_png(image, lambda y: filter_type)
    np.testing.assert_array_equal(decode_png(png), image)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_decode_mixed_filters_per_row(channels):
    image = _image(40, 37, channels, seed=9)
    png = _filtered_png(image, lambda y: (y * 3) % 5)
    np.testing.assert_array_equal(decode_png(png), image)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("size", [(1, 1), (5, 9), (64, 48)])
def test_encode_round_trip_and_pil_reads_it(channels, size):
    from PIL import Image

    image = _image(*size, channels, seed=1)
    png = encode_png(image)
    np.testing.assert_array_equal(decode_png(png), image)
    with Image.open(io.BytesIO(png)) as im:
        assert im.mode == MODES[channels]
        pil = np.asarray(im)
    np.testing.assert_array_equal(
        pil if pil.ndim == 3 else pil[..., None], image
    )


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_decodes_what_pil_writes(channels):
    """PIL's encoder picks its own (adaptive) row filters."""
    from PIL import Image

    image = _image(50, 70, channels, seed=2)
    buf = io.BytesIO()
    Image.fromarray(image if channels > 1 else image[..., 0],
                    mode=MODES[channels]).save(buf, format="PNG")
    np.testing.assert_array_equal(decode_png(buf.getvalue()), image)


def test_decodes_palette_png_with_transparency():
    from PIL import Image

    # 256 palette entries in use, so PIL writes 8-bit indices
    index = np.arange(9 * 32, dtype=np.uint32).reshape(9, 32) % 256
    palette = np.random.default_rng(3).integers(0, 256, size=768).tolist()
    im = Image.fromarray(index.astype(np.uint8), mode="P")
    im.putpalette(palette)
    buf = io.BytesIO()
    im.save(buf, format="PNG", transparency=bytes(range(0, 200, 2)))
    decoded = decode_png(buf.getvalue())
    expected = Image.open(io.BytesIO(buf.getvalue())).convert("RGBA")
    np.testing.assert_array_equal(decoded, np.asarray(expected))


@pytest.mark.parametrize("case, message", [
    (b"GIF89a", "not a PNG"),
    (b"\x89PNG\r\n\x1a\n", "truncated"),
])
def test_rejects_non_png_and_truncated(case, message):
    with pytest.raises(ValueError, match=message):
        decode_png(case)


def test_rejects_bad_crc_and_unsupported_variants():
    png = bytearray(encode_png(_image(4, 4, 3)))
    png[-20] ^= 0xFF  # inside the IDAT payload: the CRC no longer matches
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(png))

    def with_header(depth, color, interlace):
        ihdr = struct.pack(">IIBBBBB", 4, 4, depth, color, 0, 0, interlace)
        body = b"IHDR" + ihdr
        return (b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + body
                + struct.pack(">I", zlib.crc32(body))
                + b"\0\0\0\0IEND\xaeB`\x82")

    with pytest.raises(ValueError, match="bit depth 16"):
        decode_png(with_header(16, 2, 0))
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(with_header(8, 2, 1))


# ---------------------------------------------------------- PIL-free paths


@pytest.fixture
def no_pil_no_native(monkeypatch):
    """PIL unimportable and the native module disabled."""
    monkeypatch.setenv("ANNONET_NO_NATIVE", "1")
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401


def test_sample_io_without_pil(tmp_path, no_pil_no_native):
    from annonet_jax.data.sample import load_image, load_rgba, save_png

    rgb = _image(20, 30, 3, seed=4)
    rgba = _image(20, 30, 4, seed=5)
    save_png(str(tmp_path / "a.png"), rgb)
    save_png(str(tmp_path / "a.png_mask.png"), rgba)
    np.testing.assert_array_equal(load_image(str(tmp_path / "a.png"), False),
                                  rgb)
    np.testing.assert_array_equal(load_rgba(str(tmp_path / "a.png_mask.png")),
                                  rgba)
    gray = load_image(str(tmp_path / "a.png"), True)
    assert gray.shape == (20, 30, 1)


def test_jpeg_without_pil_names_what_is_missing(tmp_path, no_pil_no_native):
    from annonet_jax.data.sample import load_image

    path = tmp_path / "photo.jpg"
    path.write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    with pytest.raises(ValueError, match="PIL"):
        load_image(str(path), False)


def test_gray_conversion_matches_pil():
    """luma_601 is PIL's exact convert("L") fixed-point math."""
    from PIL import Image

    from annonet_jax.data.sample import convert_channels

    rgb = _image(31, 17, 3, seed=6)
    expected = np.asarray(Image.fromarray(rgb).convert("L"))
    np.testing.assert_array_equal(convert_channels(rgb, 1)[..., 0], expected)
    rgba = _image(5, 6, 4, seed=7)
    np.testing.assert_array_equal(
        convert_channels(rgba, 3), np.asarray(
            Image.fromarray(rgba, mode="RGBA").convert("RGB"))
    )
    np.testing.assert_array_equal(
        convert_channels(rgb[..., :1], 4), np.asarray(
            Image.fromarray(rgb[..., 0], mode="L").convert("RGBA"))
    )


def test_train_infer_serve_png_path_without_pil(tmp_path, no_pil_no_native):
    """The PNG path end to end with neither PIL nor the native module:
    a synthetic dataset is written, annonet_train trains on it,
    annonet_infer writes result PNGs, and annonet_serve decodes an
    encoded PNG request and encodes its PNG response."""
    from annonet_jax.cli.infer import main as infer_main
    from annonet_jax.cli.serve import build_parser, make_server
    from annonet_jax.cli.train import main as train_main
    from annonet_jax.data.sample import load_rgba
    from annonet_jax.data.synthetic import write_detection_dataset

    data = tmp_path / "data"
    write_detection_dataset(data, n_images=2, size=64, seed=0)
    model = str(tmp_path / "annonet.dnn")
    assert train_main([
        str(data), "--level-count", "0", "-b", "4", "--max-total-steps", "2",
        "--input-dimension-multiplier", "1.0",
        "--data-loader-thread-count", "1",
        "--output", model, "--sync-file", str(tmp_path / "sync.dat"),
    ]) == 0
    assert infer_main([str(data), "--model", model]) == 0
    result = load_rgba(str(data / "img0.png_result.png"))
    assert result.shape == (64, 64, 4)

    args = build_parser().parse_args(
        ["--model", model, "--port", "0",
         "--tile-max-width", "64", "--tile-max-height", "64"]
    )
    _server, service = make_server(args)
    image = service.decode(encode_png(_image(40, 48, 3, seed=8)))
    labels = service.infer(image, service.default_gains,
                           service.default_detection)
    png = service.encode_png(labels)
    assert decode_png(png).shape == (40, 48, 4)
    _server.server_close()
