"""Sample reading: image + RGBA mask -> downscaled input + uint16 labels.

Reference behavior reproduced from:
  * /root/reference/annonet.cpp:131-176 (read_sample: original-size recording,
    1/downscaling_factor bilinear resize, mask size validation against the
    ORIGINAL size, nearest-neighbor mask resize, errors-as-data)
  * /root/reference/annonet.h:49-58 (sample_type)
  * /root/reference/annonet.h:74-120 (outpaint: replicate-pad everything
    outside a valid interior rect)

The reference's compile-time DLIB_DNN_PIMPL_WRAPPER_GRAYSCALE_INPUT knob
(appveyor.yml:6-23) is a runtime ``grayscale`` flag here. Input images are
kept channel-last uint8 with an explicit channel axis: (H, W, 1) or (H, W, 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from annonet_jax.data.codec import decode_rgba_label_image, labeled_points_by_class
from annonet_jax.data.dataset import ImageFilenames


@dataclasses.dataclass
class Sample:
    """A loaded (and possibly downscaled) image with optional ground truth.

    Mirrors sample_type (annonet.h:49-58). ``error`` carries failures as data
    instead of exceptions, exactly like the reference (annonet.cpp:171-173);
    consumers decide when to throw.
    """

    original_width: int = 0
    original_height: int = 0
    image_filenames: ImageFilenames = dataclasses.field(
        default_factory=lambda: ImageFilenames("")
    )
    input_image: Optional[np.ndarray] = None  # (H, W, C) uint8
    label_image: Optional[np.ndarray] = None  # (H, W) uint16
    labeled_points_by_class: Dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict
    )
    error: str = ""


def _scaled_dim(dim: int, scale: float) -> int:
    """New dimension after scaling, rounded like dlib::resize_image(scale)."""
    return max(1, int(round(dim * scale)))


def resize_image_bilinear(image: np.ndarray, target_w: int, target_h: int) -> np.ndarray:
    """Bilinear resize of a (H, W, C) or (H, W) uint8/float image on the host.

    Half-pixel-center sampling with edge clamping (the standard convention;
    replaces dlib::resize_image + interpolate_bilinear, annonet.cpp:153).
    Pure NumPy so results are identical across platforms and match the
    device-side resize in annonet_jax.ops.resize.
    """
    src_h, src_w = image.shape[:2]
    if (src_h, src_w) == (target_h, target_w):
        return image.copy()

    if image.dtype == np.uint8:
        from annonet_jax.native import resize_bilinear_native

        native = resize_bilinear_native(image, target_w, target_h)
        if native is not None:
            return native

    in_dtype = image.dtype
    img = image.astype(np.float32)
    squeeze = False
    if img.ndim == 2:
        img = img[..., None]
        squeeze = True

    scale_y = src_h / target_h
    scale_x = src_w / target_w
    # half-pixel centers
    ys = (np.arange(target_h, dtype=np.float64) + 0.5) * scale_y - 0.5
    xs = (np.arange(target_w, dtype=np.float64) + 0.5) * scale_x - 0.5
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    wy = (ys - y0).astype(np.float32)
    wx = (xs - x0).astype(np.float32)
    y0c = np.clip(y0, 0, src_h - 1)
    y1c = np.clip(y0 + 1, 0, src_h - 1)
    x0c = np.clip(x0, 0, src_w - 1)
    x1c = np.clip(x0 + 1, 0, src_w - 1)

    top = img[y0c][:, x0c] * (1 - wx)[None, :, None] + img[y0c][:, x1c] * wx[None, :, None]
    bot = img[y1c][:, x0c] * (1 - wx)[None, :, None] + img[y1c][:, x1c] * wx[None, :, None]
    out = top * (1 - wy)[:, None, None] + bot * wy[:, None, None]

    if squeeze:
        out = out[..., 0]
    if np.issubdtype(in_dtype, np.integer):
        info = np.iinfo(in_dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    return out.astype(in_dtype)


def nearest_indices(src_size: int, dst_size: int) -> np.ndarray:
    """Nearest-neighbor source indices for a 1-D resize (half-pixel centers)."""
    idx = np.floor(
        (np.arange(dst_size, dtype=np.float64) + 0.5) * (src_size / dst_size)
    ).astype(np.int64)
    return np.clip(idx, 0, src_size - 1)


def resize_label_image(
    label_image: np.ndarray, target_w: int, target_h: int
) -> np.ndarray:
    """Nearest-neighbor resize of a label (or RGBA-mask) image.

    Replaces resize_label_image (annonet.cpp:131-141). Works for (H, W) index
    labels and (H, W, 4) RGBA masks alike.
    """
    src_h, src_w = label_image.shape[:2]
    if (src_h, src_w) == (target_h, target_w):
        return label_image.copy()
    yi = nearest_indices(src_h, target_h)
    xi = nearest_indices(src_w, target_w)
    return label_image[np.ix_(yi, xi)]


def outpaint(image: np.ndarray, inside_ltrb) -> np.ndarray:
    """Replicate-pad everything outside the valid interior rect, in place.

    ``inside_ltrb`` is (left, top, right, bottom) INCLUSIVE, like
    dlib::rectangle. Parity with outpaint (annonet.h:74-120): each outside
    pixel is clamped to the nearest edge pixel of the interior (9-region
    edge/corner replication). Implemented as one clamped-index gather instead
    of the reference's 9 explicit loops.
    """
    h, w = image.shape[:2]
    left, top, right, bottom = inside_ltrb
    # intersect with image bounds (annonet.h:82)
    left = max(0, left)
    top = max(0, top)
    right = min(w - 1, right)
    bottom = min(h - 1, bottom)
    if left > right or top > bottom:
        return image  # empty interior: no-op (annonet.h:83-86)

    yi = np.clip(np.arange(h), top, bottom)
    xi = np.clip(np.arange(w), left, right)
    image[...] = image[np.ix_(yi, xi)]
    return image


def luma_601(rgb: np.ndarray) -> np.ndarray:
    """(..., 3+) uint8 -> (...) uint8 ITU-R 601-2 luma with PIL's exact
    fixed-point rounding (Image.convert("L")), the same math as the
    native decoder's, so every decode path gives the same gray values."""
    rgb = np.asarray(rgb, np.uint32)
    return (
        (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
         + 0x8000) >> 16
    ).astype(np.uint8)


def convert_channels(image: np.ndarray, channels: int) -> np.ndarray:
    """(H, W, C) uint8 with C = 1 gray, 2 gray+alpha, 3 RGB or 4 RGBA ->
    (H, W, channels) for channels 1, 3 or 4, with PIL's convert()
    semantics: color to gray by luma_601, gray replicated to color, alpha
    dropped, or filled with 255 where the source has none."""
    c = image.shape[-1]
    if c == channels:
        return image
    if channels == 1:
        return (luma_601(image) if c >= 3 else image[..., 0])[..., None]
    color = image[..., :3] if c >= 3 else np.repeat(image[..., :1], 3, -1)
    if channels == 3:
        return np.ascontiguousarray(color)
    alpha = image[..., -1:] if c in (2, 4) else np.full(
        image.shape[:-1] + (1,), 255, np.uint8
    )
    return np.concatenate([color, alpha], axis=-1)


def decode_image_bytes(data: bytes, channels: int) -> np.ndarray:
    """Encoded image bytes -> (H, W, channels) uint8, channels 1, 3 or 4,
    without the native module: PIL when installed, else the built-in PNG
    codec (data/png.py)."""
    try:
        from PIL import Image
    except ImportError:
        from annonet_jax.data.png import decode_png

        return convert_channels(decode_png(data), channels)
    import io

    mode = {1: "L", 3: "RGB", 4: "RGBA"}[channels]
    with Image.open(io.BytesIO(data)) as im:
        arr = np.asarray(im.convert(mode), dtype=np.uint8)
    return arr[..., None] if channels == 1 else arr


def _decode_python(path: str, channels: int) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image_bytes(f.read(), channels)


def load_image(path: str, grayscale: bool) -> np.ndarray:
    """Load an image file as (H, W, 1) or (H, W, 3) uint8.

    Decoding runs in the native C++ module (libpng/libjpeg, GIL released;
    replaces dlib::load_image at annonet.cpp:150), falling back to PIL and
    then to the built-in PNG codec. The grayscale conversion is the exact
    ITU-R 601-2 fixed-point math (luma_601) in every path.
    """
    channels = 1 if grayscale else 3
    arr = _decode_with_fallback(path, channels)
    if arr is None:
        arr = _decode_python(path, channels)
    return arr


def _decode_with_fallback(path: str, channels: int):
    """Native decode, falling back on *decode* errors (not missing
    files): libpng/libjpeg reject some slightly malformed files that PIL
    still reads, and the native module must not make loading stricter than
    the pure-Python path."""
    from annonet_jax.native import decode_image_native

    try:
        return decode_image_native(path, channels)
    except FileNotFoundError:
        raise
    except OSError:
        return None


def load_rgba(path: str) -> np.ndarray:
    """Load a mask file as (H, W, 4) uint8 RGBA (native decode, then PIL,
    then the built-in PNG codec)."""
    arr = _decode_with_fallback(path, 4)
    if arr is not None:
        return arr
    return _decode_python(path, 4)


def save_png(path: str, image: np.ndarray) -> None:
    """Write (H, W) or (H, W, C) uint8, C in 1, 3, 4, as PNG: the native
    encoder for RGBA, else PIL when installed, else the built-in codec.

    Replaces dlib::save_png (annonet_infer_main.cpp:415)."""
    image = np.asarray(image, dtype=np.uint8)
    if image.ndim == 3 and image.shape[2] == 4:
        from annonet_jax.native import encode_png_rgba_native

        if encode_png_rgba_native(path, image):
            return
    try:
        from PIL import Image
    except ImportError:
        from annonet_jax.data.png import encode_png

        with open(path, "wb") as f:
            f.write(encode_png(image))
        return
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    Image.fromarray(image).save(path)


def save_png_rgba(path: str, rgba: np.ndarray) -> None:
    """Write (H, W, 4) RGBA uint8 as PNG (see save_png)."""
    save_png(path, rgba)


def read_sample(
    image_filenames: ImageFilenames,
    anno_classes,
    require_ground_truth: bool,
    downscaling_factor: float,
    grayscale: bool = False,
) -> Sample:
    """Load an image (+ optional mask), downscale, validate, decode.

    Parity with read_sample (annonet.cpp:143-176):
      * original W/H recorded before downscaling
      * the input image is bilinearly resized by 1/downscaling_factor
      * the mask must match the ORIGINAL image size ("Label image size
        mismatch", annonet.cpp:158-160)
      * the mask is nearest-neighbor resized to the downscaled input size,
        then decoded RGBA -> uint16 indices
      * any exception is captured into sample.error, not raised
    """
    sample = Sample(image_filenames=image_filenames)
    try:
        sample.input_image = load_image(image_filenames.image_filename, grayscale)
        sample.original_height, sample.original_width = sample.input_image.shape[:2]
        if downscaling_factor != 1.0:
            new_w = _scaled_dim(sample.original_width, 1.0 / downscaling_factor)
            new_h = _scaled_dim(sample.original_height, 1.0 / downscaling_factor)
            sample.input_image = resize_image_bilinear(
                sample.input_image, new_w, new_h
            )

        if image_filenames.label_filename:
            rgba_label_image = load_rgba(image_filenames.label_filename)
            if (
                rgba_label_image.shape[0] != sample.original_height
                or rgba_label_image.shape[1] != sample.original_width
            ):
                sample.error = "Label image size mismatch"
            else:
                h, w = sample.input_image.shape[:2]
                rgba_label_image = resize_label_image(rgba_label_image, w, h)
                sample.label_image = decode_rgba_label_image(
                    rgba_label_image, anno_classes
                )
                sample.labeled_points_by_class = labeled_points_by_class(
                    sample.label_image
                )
        elif require_ground_truth:
            sample.error = "No ground truth available"
    except Exception as e:  # noqa: BLE001 — parity: errors are data
        sample.error = str(e)

    return sample
