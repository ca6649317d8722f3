#!/usr/bin/env python
"""Measure (and optionally pin) the detection-graded benchmark floors.

The benchmark (annonet_jax/data/synthetic.py) is the severe regime the
reference's detection machinery exists for: ~1000:1 class imbalance,
defects smaller than the receptive field, defects straddling tile
boundaries, oversize mislabeled smears in the TRAIN split. This script
runs the full pipeline per seed:

  train dir (with smears) --region filter--> trainer
  eval dir (clean) --tiled inference with gains + detection levels-->
  per-pixel AND per-region confusion --> per-class region recall

and records, per seed, the region recall/precision per class plus pixel
metrics; `--pin` writes conservative floors into PARITY_TARGETS.json
(detection_* keys) which tests/test_detection_benchmark.py asserts.

A control arm (--no-filter) trains WITHOUT the region filter to record
the smear damage the filter prevents.

Usage: ANNONET_PLATFORM=cpu python scripts/measure_detection.py
           [--seeds 0 1 2] [--steps 150] [--pin] [--no-filter]
"""

import argparse
import json
import math
import os
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
os.environ.setdefault("ANNONET_PLATFORM", "cpu")

import numpy as np  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent

# ---- the benchmark configuration (mirrored by the test; keep in sync) ----
#
# THE RECOMMENDED DETECTION-REGIME CONFIGURATION (from a sweep of the
# training levers). Three levers moved the
# worst-seed background region recall 0.10 -> >=0.5 (i.e. false-positive
# blobs ~103 -> <=10 over the 6 eval images), each necessary:
#
#   * base_width 32 (capacity): the decisive FP suppressor — the width-16
#     net cannot separate clutter speckle from true minor defects on the
#     worst seed (103 FPs); width 32 cuts it to single digits. But raw
#     width OVERFITS: without augmentation the wide net memorizes the
#     training images' lighting planes / color noise and its eval pixel
#     accuracy collapses (0.93 on seed 0 at ANY learning rate).
#   * photometric augmentation (the reference's own flags,
#     annonet_train_main.cpp:73-103,184-231): brightness p=0.5 sigma 0.1,
#     noise stddev 2.0, color offset, flips — restores wide-net
#     generalization (seed-0 pixel accuracy 0.93 -> 0.9991).
#   * plateau window 120 (longer patience): augmentation shrinks logit
#     margins early in training; the longer schedule re-grows them so the
#     detection-level veto stops eating weak TRUE minors (seed-0 minor
#     region recall 0.30 -> 0.64 at the scored setting).
#
# level_count stays 2: the defects are sub-receptive-field blobs whose
# only tell vs background clutter is CONTEXT; level 1 (30 px field)
# over-predicts by the hundreds, level 3 spread FPs into the major class
# without helping. lr 0.02: width-32 nets train stably there (0.05 was
# tuned for width 16).
BENCH = dict(
    train_images=10,
    eval_images=6,
    size=256,
    defect_count=5,
    oversize_images=3,
    level_count=2,
    base_width=32,
    crop_dim=64,
    batch=8,
    lr=0.02,
    # the reference's natural control loop (annonet_train_main.cpp:569-577):
    # plateau -> LR shrink (x0.1) -> ... -> stop at min LR. The window is
    # scaled to this tiny problem (the reference default is 4000).
    plateau_window=120,
    min_lr=2e-4,  # 0.02 -> 2e-3 -> 2e-4 -> stop (2 shrinks + the stop one)
    max_steps=2500,
    # scored setting picked from the recorded round-5 scoring-grid sweeps
    # (same trained nets scored under 6+ gain/level settings per seed):
    # d_minor 1.5 keeps every seed's background recall >= 0.5 while the
    # window-120 margins keep minor recall >= 0.55; d_major 2.0 lifts
    # seed-0 major recall (0.938 -> 0.968) without costing the others
    gains=[0.0, 0.5, 0.5],
    detection_levels=[0.0, 1.5, 2.0],
    region_filter_area=8.0,  # x receptive-field area; smears exceed it
    # the reference's own augmentation flags — see the recipe note above
    noise_stddev=2.0,
    brightness_prob=0.5,
    brightness_stddev=0.1,
    color_offset=True,
)


def run_benchmark(seed, steps=None, use_filter=True, verbose=True,
                  score_settings=None, **overrides):
    """One full benchmark run. ``steps=None`` (the benchmark mode) runs
    the trainer's own plateau control loop to its natural min-LR stop;
    an explicit ``steps`` forces a fixed-length run (exploration).
    ``score_settings``: optional list of (gains, detection_levels) pairs
    — the SAME trained net is scored under each (the benchmark's scored
    arm is the BENCH default, the rest explore the gain/veto tradeoff);
    extra settings land in out["scored"]."""
    import jax

    jax.config.update("jax_platforms", "cpu")

    from annonet_jax.classes import parse_anno_classes
    from annonet_jax.data.crop import CropOptions
    from annonet_jax.data.dataset import find_image_files
    from annonet_jax.data.pipeline import CropPipeline, RegionFilterOptions
    from annonet_jax.data.sample import read_sample
    from annonet_jax.data.synthetic import write_detection_dataset
    from annonet_jax.infer.core import TiledInferer, annonet_infer
    from annonet_jax.infer.evaluation import (
        new_confusion_matrix,
        update_confusion_matrix_per_pixel,
        update_confusion_matrix_per_region,
    )
    from annonet_jax.infer.tiling import TilingParameters
    from annonet_jax.models.segnet import (
        SegNetConfig,
        required_input_dimension,
    )
    from annonet_jax.train.trainer import Trainer, TrainerConfig

    b = {**BENCH, **overrides}
    with tempfile.TemporaryDirectory() as td:
        td = pathlib.Path(td)
        write_detection_dataset(
            td / "train", n_images=b["train_images"], size=b["size"],
            seed=seed, defect_count=b["defect_count"],
            oversize_images=b["oversize_images"],
        )
        write_detection_dataset(
            td / "eval", n_images=b["eval_images"], size=b["size"],
            seed=seed + 1000, defect_count=b["defect_count"],
            oversize_images=0,
        )
        anno_classes = parse_anno_classes(
            (td / "train" / "anno_classes.json").read_text()
        )
        config = SegNetConfig(
            class_count=3, level_count=b["level_count"],
            base_width=b["base_width"], compute_dtype="float32",
        )
        rfield = required_input_dimension(config)
        files = find_image_files(
            str(td / "train"), require_ground_truth=True, verbose=False
        )
        region_filter = RegionFilterOptions(
            receptive_field_side=rfield,
            by_area=b["region_filter_area"] if use_filter else math.inf,
        )
        trainer = Trainer(
            config,
            TrainerConfig(
                initial_learning_rate=b["lr"],
                iterations_without_progress_threshold=b["plateau_window"],
                previous_loss_values_dump_amount=b["plateau_window"],
                min_learning_rate=b["min_lr"],
                int8_forward=b.get("int8_forward", False),
            ),
            seed=seed,
        )
        events = []
        trainer.metrics_hook = lambda e: (
            events.append(e) if e["event"] == "learning_rate_shrink" else None
        )
        crop_options = CropOptions(
            dim=b["crop_dim"], allow_flip_left_right=True,
            allow_flip_upside_down=True,
            multiplicative_brightness_change_probability=b["brightness_prob"],
            multiplicative_brightness_change_sigma=b["brightness_stddev"],
            noise_level_stddev=b["noise_stddev"],
            allow_random_color_offset=b["color_offset"],
        )
        with CropPipeline(
            files, anno_classes, crop_options, thread_count=2,
            seed=seed, deterministic=True, region_filter=region_filter,
        ) as pipe:
            losses = []
            while (len(losses) < b["max_steps"] if steps is None
                   else len(losses) < steps):
                if steps is None and trainer.should_stop:
                    break
                images, labels = pipe.next_minibatch(b["batch"], warn=None)
                losses.append(
                    trainer.train_step_crops(images, labels, crop_options)
                )

        params = trainer.runtime_net()
        tiling = TilingParameters(
            max_tile_width=b["size"] // 2, max_tile_height=b["size"] // 2,
            overlap_x=rfield, overlap_y=rfield,
        )
        inferer = TiledInferer(params, config, tiling)
        if score_settings is None:
            score_settings = [(b["gains"], b["detection_levels"])]
        eval_files = find_image_files(
            str(td / "eval"), require_ground_truth=True, verbose=False
        )
        samples = []
        for fns in eval_files:
            s = read_sample(fns, anno_classes, True, 1.0)
            assert not s.error, s.error
            samples.append(s)
        scored = []
        for gains, detection_levels in score_settings:
            cm_pixel = new_confusion_matrix(3)
            cm_region = new_confusion_matrix(3)
            for s in samples:
                result = annonet_infer(
                    inferer, s.input_image,
                    gains=gains, detection_levels=detection_levels,
                )
                update_confusion_matrix_per_pixel(
                    cm_pixel, s.labeled_points_by_class, result
                )
                update_confusion_matrix_per_region(
                    cm_region, s.labeled_points_by_class, s.label_image,
                    result,
                )
            scored.append((gains, detection_levels, cm_pixel, cm_region))
        # the benchmark's scored arm is the FIRST setting
        _, _, cm_pixel, cm_region = scored[0]

    def _recalls(cm):
        return [
            float(cm[c, c] / cm[c, :].sum()) if cm[c, :].sum() else None
            for c in range(3)
        ]

    def _precisions(cm):
        return [
            float(cm[c, c] / cm[:, c].sum()) if cm[:, c].sum() else None
            for c in range(3)
        ]

    out = {
        "seed": seed,
        "steps": len(losses),
        "stopped_at_min_lr": bool(steps is None and trainer.should_stop),
        "final_learning_rate": float(trainer.learning_rate),
        "lr_shrinks": [
            {"step": e["step"], "learning_rate": e["learning_rate"]}
            for e in events
        ],
        "filter": use_filter,
        "loss_first": float(np.mean(losses[:5])),
        "loss_last": float(np.mean(losses[-5:])),
        "pixel_accuracy": float(np.trace(cm_pixel) / cm_pixel.sum()),
        "region_recall": _recalls(cm_region),
        "region_precision": _precisions(cm_region),
        "pixel_recall": _recalls(cm_pixel),
        "region_cm": cm_region.tolist(),
        "bg_px_per_defect_px": float(
            cm_pixel[0, :].sum() / max(1, cm_pixel[1:, :].sum())
        ),
    }
    if len(scored) > 1:
        out["scored"] = [
            {
                "gains": list(g),
                "detection_levels": list(d),
                "region_recall": _recalls(cmr),
                "region_precision": _precisions(cmr),
                "pixel_accuracy": float(np.trace(cmp_) / cmp_.sum()),
                "region_cm": cmr.tolist(),
            }
            for g, d, cmp_, cmr in scored
        ]
    if verbose:
        print(json.dumps(out, indent=1))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--steps", type=int, default=None,
                    help="fixed step count (default: run the plateau "
                    "control loop to its natural min-LR stop)")
    ap.add_argument("--pin", action="store_true",
                    help="write floors into PARITY_TARGETS.json")
    ap.add_argument("--no-filter", action="store_true",
                    help="control arm: train WITHOUT the region filter")
    args = ap.parse_args()
    if args.pin and args.no_filter:
        ap.error(
            "--pin with --no-filter would pin floors measured from "
            "UNFILTERED (smear-damaged) training runs, corrupting the "
            "benchmark contract; --pin runs its own control arm"
        )

    runs = [
        run_benchmark(s, args.steps, use_filter=not args.no_filter)
        for s in args.seeds
    ]

    if args.pin:
        path = REPO / "PARITY_TARGETS.json"
        targets = json.loads(path.read_text())
        # region recall is None for a class with ZERO eval regions (the
        # test floors handle None; min() would TypeError) — a degenerate
        # seed/config must fail the pin with a diagnosis, not a traceback
        degenerate = [
            (r["seed"], c)
            for r in runs
            for c in range(3)
            if r["region_recall"][c] is None
        ]
        if degenerate:
            raise SystemExit(
                "refusing to pin: region recall is undefined (no eval "
                f"regions) for (seed, class) pairs {degenerate}; the eval "
                "set must contain regions of every class at every seed"
            )
        min_recall = [
            min(r["region_recall"][c] for r in runs) for c in range(3)
        ]
        min_px = min(r["pixel_accuracy"] for r in runs)
        # control arm: train ON the mislabeled smears (filter off) to
        # record the damage the region filter prevents; pinned so the
        # test can assert the filter is load-bearing without re-training
        control = run_benchmark(args.seeds[0], use_filter=False,
                                verbose=False)
        control_prec = control["region_precision"][1] or 0.0
        # SAME-seed comparison (training is deterministic in seed), so
        # the pinned margin is not polluted by cross-seed variance
        filtered_prec = next(
            r["region_precision"][1] or 0.0
            for r in runs if r["seed"] == control["seed"]
        )
        targets["detection_benchmark"] = {
            "config": (
                f"annonet_jax/data/synthetic.py detection set: "
                f"{BENCH['train_images']} train images "
                f"({BENCH['oversize_images']} with oversize smears, "
                f"region filter by_area={BENCH['region_filter_area']}) + "
                f"{BENCH['eval_images']} clean eval images, "
                f"{BENCH['size']}px, {BENCH['defect_count']} defects each, "
                f"plateau-driven training (window {BENCH['plateau_window']}, "
                f"min LR {BENCH['min_lr']}, cap {BENCH['max_steps']}) batch "
                f"{BENCH['batch']} crop "
                f"{BENCH['crop_dim']} level {BENCH['level_count']} width "
                f"{BENCH['base_width']} lr {BENCH['lr']}, scored with "
                f"gains {BENCH['gains']} detection levels "
                f"{BENCH['detection_levels']}, per-REGION confusion"
            ),
            "runs": runs,
            # floors: min over seeds minus margin (same convention as the
            # top-level pinned floors: measured min - 0.02/0.05)
            "pinned_region_recall_floor": [
                round(max(0.0, r - 0.05), 4) for r in min_recall
            ],
            "pinned_pixel_accuracy_floor": round(min_px - 0.005, 4),
        }
        if filtered_prec >= control_prec + 0.1:
            targets["detection_benchmark"]["no_filter_control"] = {
                "seed": control["seed"],
                "minor_region_precision": round(control_prec, 4),
                "filtered_minor_region_precision": round(filtered_prec, 4),
                "margin": 0.05,
                "control_run": control,
            }
        else:
            print(
                f"WARNING: filter benefit too small to pin "
                f"(filtered {filtered_prec:.3f} vs control "
                f"{control_prec:.3f}); no_filter_control not recorded"
            )
        path.write_text(json.dumps(targets, indent=2) + "\n")
        print(f"pinned floors written to {path}")


if __name__ == "__main__":
    main()
