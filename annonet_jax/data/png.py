"""PNG codec in numpy and zlib: the last fallback for image I/O.

The native module (libpng/libjpeg) and PIL decode and encode images when
either is installed (data/sample.py tries them first). This codec keeps the
PNG path working with neither: it reads 8-bit, non-interlaced grayscale,
gray+alpha, RGB, RGBA and palette PNGs with all five row filter types, and
writes 8-bit grayscale, RGB and RGBA. Other formats and PNG variants raise
ValueError naming what is missing.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples per pixel (8-bit depth only)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> color type


def _unsupported(what: str) -> ValueError:
    return ValueError(
        f"{what}: the built-in PNG codec reads only 8-bit non-interlaced "
        "PNG; install PIL (pillow) or build the native image module "
        "(libpng, libjpeg) for other files"
    )


def _chunks(data: bytes):
    if not data.startswith(_SIGNATURE):
        raise _unsupported("not a PNG file")
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        crc_bytes = data[pos + 8 + length : pos + 12 + length]
        if len(body) != length or len(crc_bytes) != 4:
            raise ValueError("truncated PNG file")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc_bytes)[0]:
            raise ValueError(f"broken PNG file: bad CRC in {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("truncated PNG file: no IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters of [H, W*bpp] filtered bytes (8-bit
    samples, so the "left" byte is the same sample of the previous
    pixel)."""
    h, row_bytes = raw.shape
    w = row_bytes // bpp
    if filters.max(initial=0) > 4:
        raise ValueError(f"broken PNG file: filter type {filters.max()}")
    px = raw.reshape(h, w, bpp)
    if not np.isin(filters, (3, 4)).any():
        # None/Sub/Up only: each row is one vectorized step
        out = np.empty_like(px)
        prior = np.zeros((w, bpp), np.uint8)
        for y in range(h):
            row = px[y]
            if filters[y] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif filters[y] == 2:
                row = row + prior
            out[y] = row
            prior = out[y]
        return out.reshape(h, row_bytes)
    # Average and Paeth depend on the left, upper and upper-left decoded
    # pixels, so decode along anti-diagonals y + x = d: every pixel of one
    # diagonal depends only on the two diagonals before it. A zero row on
    # top and a zero column on the left stand for the image border.
    out = np.zeros((h + 1, w + 1, bpp), np.int16)
    ft = filters.astype(np.int16)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        xs = d - ys
        a = out[ys + 1, xs]
        b = out[ys, xs + 1]
        c = out[ys, xs]
        f = ft[ys][:, None]
        pred = np.where(
            f == 1, a, np.where(
                f == 2, b, np.where(
                    f == 3, (a + b) >> 1, np.where(
                        f == 4, _paeth(a, b, c), 0))))
        out[ys + 1, xs + 1] = (px[ys, xs].astype(np.int16) + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(h, row_bytes)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8: C = 1 gray, 2 gray+alpha, 3 RGB,
    4 RGBA (palette images expand to RGB, or RGBA with a tRNS chunk)."""
    header = None
    palette = None
    alpha = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            alpha = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("broken PNG file: no IHDR chunk")
    width, height, depth, color, _comp, _filt, interlace = header
    if depth != 8 or color not in _CHANNELS:
        raise _unsupported(f"PNG with bit depth {depth}, color type {color}")
    if interlace:
        raise _unsupported("interlaced PNG")
    bpp = _CHANNELS[color]
    row_bytes = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (row_bytes + 1):
        raise ValueError("broken PNG file: image data has the wrong size")
    rows = raw.reshape(height, row_bytes + 1)
    pixels = _unfilter(rows[:, 1:], rows[:, 0], bpp).reshape(
        height, width, bpp
    )
    if color != 3:
        return pixels
    if palette is None:
        raise ValueError("broken PNG file: palette image without PLTE")
    index = pixels[..., 0]
    if alpha is None:
        return palette[index]
    table = np.full(len(palette), 255, np.uint8)
    table[: min(len(alpha), len(palette))] = alpha[: len(palette)]
    return np.concatenate([palette[index], table[index][..., None]], axis=-1)


def encode_png(pixels: np.ndarray, level: int = 6) -> bytes:
    """(H, W) or (H, W, C) uint8, C in 1-4 -> PNG bytes (filter None)."""
    pixels = np.asarray(pixels, np.uint8)
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    h, w, c = pixels.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"cannot encode {c}-channel PNG")
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), pixels.reshape(h, w * c)], axis=1
    )

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (
            struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body))
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (
        _SIGNATURE
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
        + chunk(b"IEND", b"")
    )
