"""Measure and pin accuracy targets for the synthetic parity config.

Accuracy-parity targets would come from running the reference build on the
synthetic config. That build cannot be made from the reference snapshot:
every reference dependency is an empty git submodule (dlib,
dlib-dnn-pimpl-wrapper, tiling, cxxopts, rapidjson, ...). So this script
PINS the rebuild's own measured accuracy on the synthetic config (a
2-class train -> infer round trip) as the standing regression target in
PARITY_TARGETS.json, which tests/test_end_to_end.py asserts against.

Run on CPU for determinism:

    JAX_PLATFORMS=cpu python scripts/measure_parity.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))


def run_once(seed: int) -> dict:
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")

    from test_end_to_end import write_synthetic_dataset

    from annonet_jax import serialization
    from annonet_jax.classes import parse_anno_classes
    from annonet_jax.data.crop import CropOptions
    from annonet_jax.data.dataset import find_image_files
    from annonet_jax.data.pipeline import CropPipeline
    from annonet_jax.data.sample import read_sample
    from annonet_jax.infer.core import TiledInferer, annonet_infer
    from annonet_jax.infer.evaluation import (
        new_confusion_matrix,
        update_confusion_matrix_per_pixel,
        update_confusion_matrix_per_region,
    )
    from annonet_jax.models.segnet import SegNetConfig
    from annonet_jax.train.trainer import Trainer, TrainerConfig

    with tempfile.TemporaryDirectory() as tmp:
        tmp_path = Path(tmp)
        write_synthetic_dataset(tmp_path)
        files = find_image_files(
            str(tmp_path), require_ground_truth=True, verbose=False
        )
        anno_classes_json = (tmp_path / "anno_classes.json").read_text()
        anno_classes = parse_anno_classes(anno_classes_json)

        model_config = SegNetConfig(
            class_count=len(anno_classes),
            level_count=1,
            base_width=8,
            compute_dtype="float32",
        )
        trainer = Trainer(
            model_config,
            TrainerConfig(initial_learning_rate=0.05),
            seed=seed,
        )
        crop_options = CropOptions(dim=16, allow_flip_left_right=True)
        with CropPipeline(
            files, anno_classes, crop_options, thread_count=2,
            seed=seed + 1, deterministic=True,
        ) as pipe:
            for _ in range(40):
                images, labels = pipe.next_minibatch(8, warn=None)
                trainer.train_step_crops(
                    images, labels, crop_options, seed=seed
                )

        inferer = TiledInferer(trainer.runtime_net(), model_config)
        cm_pixel = new_confusion_matrix(model_config.class_count)
        cm_region = new_confusion_matrix(model_config.class_count)
        for filenames in find_image_files(
            str(tmp_path), require_ground_truth=False, verbose=False
        ):
            sample = read_sample(
                filenames, anno_classes, require_ground_truth=False,
                downscaling_factor=1.0,
            )
            assert not sample.error
            result = annonet_infer(inferer, sample.input_image)
            update_confusion_matrix_per_pixel(
                cm_pixel, sample.labeled_points_by_class, result
            )
            update_confusion_matrix_per_region(
                cm_region, sample.labeled_points_by_class,
                sample.label_image, result,
            )

        pixel_acc = float(np.trace(cm_pixel) / cm_pixel.sum())
        region_acc = float(np.trace(cm_region) / max(1, cm_region.sum()))
        # per-class IoU -> mIoU over classes present in ground truth
        ious = []
        for c in range(model_config.class_count):
            tp = cm_pixel[c, c]
            denom = cm_pixel[c, :].sum() + cm_pixel[:, c].sum() - tp
            if cm_pixel[c, :].sum() > 0:
                ious.append(float(tp / max(1, denom)))
        return {
            "seed": seed,
            "pixel_accuracy": round(pixel_acc, 4),
            "region_accuracy": round(region_acc, 4),
            "miou": round(sum(ious) / len(ious), 4),
        }


def main() -> None:
    runs = [run_once(seed) for seed in (0, 1, 2)]
    summary = {
        "config": (
            "synthetic 2-class dataset, "
            "train 40 steps (batch 8, crop 16, level_count 1, width 8, "
            "lr 0.05, deterministic crop stream) -> tiled inference "
            "round trip, CPU f32"
        ),
        "reference_measurement": (
            "not possible: all reference dependencies are empty git "
            "submodules; these rebuild-measured numbers are the "
            "standing regression targets instead"
        ),
        "runs": runs,
        "pixel_accuracy_min": min(r["pixel_accuracy"] for r in runs),
        "miou_min": min(r["miou"] for r in runs),
        # regression floors: observed min minus a small stability margin
        "pinned_pixel_accuracy_floor": round(
            min(r["pixel_accuracy"] for r in runs) - 0.02, 4
        ),
        "pinned_miou_floor": round(min(r["miou"] for r in runs) - 0.05, 4),
    }
    out = REPO / "PARITY_TARGETS.json"
    out.write_text(json.dumps(summary, indent=2) + "\n")
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
