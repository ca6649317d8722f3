"""Embed annonet-jax inference in your own application.

The reference's annonet_infer.{h,cpp} is written "so that it can be
included in other applications as well" (annonet_infer.h:15-17); this is
the equivalent library surface here — no CLI, no threads, just:

    model artifact -> TiledInferer -> uint16 label map per image

Run:  python examples/embed_inference.py <model.npz> <image.png> [out.png]
"""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])  # repo root, if not installed

import numpy as np

from annonet_jax import serialization
from annonet_jax.classes import parse_anno_classes
from annonet_jax.data.codec import index_label_image_to_rgba_label_image
from annonet_jax.data.sample import load_image, save_png_rgba
from annonet_jax.infer.core import TiledInferer, annonet_infer


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__)
        return 1
    model_path, image_path = sys.argv[1], sys.argv[2]
    out_path = sys.argv[3] if len(sys.argv) > 3 else image_path + "_result.png"

    # the artifact is self-describing: weights + class palette + the
    # downscaling factor trained with (annonet.dnn analog, SURVEY.md §3.4)
    params, config, classes_json, downscale = serialization.load_model(
        model_path
    )
    anno_classes = parse_anno_classes(classes_json)

    # one inferer serves any number of images; compiled programs are
    # cached per image-size bucket. quantize="int8" opts into the int8
    # quantized conv stack (calibrated on the first image you pass).
    inferer = TiledInferer(params, config, quantize="int8")

    image = load_image(image_path, grayscale=config.grayscale)
    if downscale != 1.0:
        from annonet_jax.data.sample import resize_image_bilinear

        # same rounding + min-1 guard as read_sample (data/sample.py)
        h = max(1, int(round(image.shape[0] / downscale)))
        w = max(1, int(round(image.shape[1] / downscale)))
        image = resize_image_bilinear(image, w, h)

    labels = annonet_infer(inferer, image)  # (H, W) uint16 class indices

    counts = np.bincount(labels.ravel(), minlength=len(anno_classes))
    for cls, n in zip(anno_classes, counts):
        print(f"{cls.classlabel:>12s}: {n} px")

    save_png_rgba(out_path, index_label_image_to_rgba_label_image(
        labels, anno_classes
    ))
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
