"""Multi-host (multi-process) batch inference.

``annonet_infer --coordinator`` shards the IMAGE LIST across processes
(process i takes images i, i+P, ... of the deterministic
find_image_files order) — the embarrassingly-parallel axis for batch
inference over a directory, pairing ``annonet_train --coordinator``.
Each process runs its own shard's tiled inference and writes its own
``_result.png`` files; confusion matrices and timing aggregates are
all-gathered at the end (the gather doubles as the exit barrier) and
process 0 prints the merged report / writes --report-json.

These tests spawn real subprocesses (each needs its own JAX runtime,
collectives over gloo/TCP on CPU) and compare the merged results with a
single-process run of the same directory.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.test_end_to_end import write_synthetic_dataset
from tests.test_multihost import _env, _free_port

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_model(path, classes_json):
    import jax

    from annonet_jax import serialization
    from annonet_jax.models.segnet import (
        SegNetConfig, fold_batchnorm, init_state,
    )

    config = SegNetConfig(class_count=2, level_count=0, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(3), config)
    runtime = fold_batchnorm(params, bn, config)
    serialization.save_model(str(path), runtime, config, classes_json, 1.0)


def _infer_cmd(data_dir, model_path, report_path, extra=()):
    return [
        sys.executable, "-m", "annonet_jax.cli.infer",
        str(data_dir),
        "--model", str(model_path),
        "--tile-max-width", "64", "--tile-max-height", "64",
        "--full-image-reader-thread-count", "2",
        "--result-image-writer-thread-count", "2",
        "--report-json", str(report_path),
        *extra,
    ]


@pytest.fixture(scope="module")
def shard_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("mhinfer")
    data_single = root / "data_single"
    data_multi = root / "data_multi"
    for d in (data_single, data_multi):
        d.mkdir()
        # 5 images: an ODD count so the 2-process shards are uneven (3+2)
        write_synthetic_dataset(d, n_images=5, size=48, seed=11)
    model = root / "annonet.dnn"
    _write_model(model, (data_single / "anno_classes.json").read_text())

    # single-process reference arm
    report_single = root / "report_single.json"
    proc = subprocess.run(
        _infer_cmd(data_single, model, report_single),
        env=_env(1), capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr

    # 2-process --coordinator arm on an identical COPY of the dataset (so
    # result PNGs cannot leak between arms)
    port = _free_port()
    reports = [root / f"report_p{i}.json" for i in range(2)]
    procs = [
        subprocess.Popen(
            _infer_cmd(
                data_multi, model, reports[pid],
                extra=[
                    "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", "2",
                    "--process-id", str(pid),
                ],
            ),
            env=_env(1), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n===\n".join(logs)
    return {
        "data_single": data_single,
        "data_multi": data_multi,
        "report_single": report_single,
        "reports": reports,
        "logs": logs,
    }


def test_two_process_run_matches_single_process(shard_setup):
    single = json.loads(shard_setup["report_single"].read_text())
    merged = json.loads(shard_setup["reports"][0].read_text())

    assert merged["images"] == single["images"] == 5
    assert merged["processes"] == 2
    # the merged confusion matrices equal the single-process run exactly
    for key in ("confusion_per_pixel", "confusion_per_region"):
        assert merged[key]["matrix"] == single[key]["matrix"], key
        assert merged[key]["accuracy"] == single[key]["accuracy"], key
    # per-image records cover only process 0's shard (documented)
    assert len(merged["per_image"]) == 3


def test_result_pngs_identical_across_arms(shard_setup):
    from PIL import Image

    for i in range(5):
        a = shard_setup["data_single"] / f"img{i}.png_result.png"
        b = shard_setup["data_multi"] / f"img{i}.png_result.png"
        assert a.exists() and b.exists(), (a, b)
        with Image.open(a) as im_a, Image.open(b) as im_b:
            np.testing.assert_array_equal(
                np.asarray(im_a.convert("RGBA")),
                np.asarray(im_b.convert("RGBA")),
            )


def test_rank_roles(shard_setup):
    log0, log1 = shard_setup["logs"]
    assert "Multi-host inference: process 0 of 2" in log0
    assert "Multi-host inference: process 1 of 2" in log1
    # only process 0 prints the merged matrices and writes the report
    assert "Confusion matrix per pixel" in log0
    assert "Confusion matrix per pixel" not in log1
    assert not shard_setup["reports"][1].exists()
    # each rank infers its own shard
    assert "this process infers 3" in log0
    assert "this process infers 2" in log1


def _write_exposure_dataset(root, brightness_by_image, size=48, seed=7):
    """Like write_synthetic_dataset, but image i's pixel values are scaled
    by brightness_by_image[i] — so stride-sharded ranks see DIFFERENT
    exposure ranges and per-shard activation maxima genuinely differ."""
    from PIL import Image

    from tests.test_end_to_end import ANNO_CLASSES
    from annonet_jax.classes import anno_classes_to_json

    rng = np.random.default_rng(seed)
    (root / "anno_classes.json").write_text(
        anno_classes_to_json(ANNO_CLASSES)
    )
    for i, brightness in enumerate(brightness_by_image):
        labels = np.zeros((size, size), dtype=np.uint16)
        for _ in range(3):
            y, x = rng.integers(4, size - 10, size=2)
            h, w = rng.integers(4, 8, size=2)
            labels[y : y + h, x : x + w] = 1
        noise = rng.integers(0, 40, size=(size, size, 3))
        image = np.where(
            labels[..., None] == 1,
            np.array([220, 30, 30]) + noise - 20,
            np.array([40, 120, 40]) + noise - 20,
        )
        image = (image * brightness).clip(0, 255).astype(np.uint8)
        mask = np.zeros((size, size, 4), dtype=np.uint8)
        mask[labels == 0] = ANNO_CLASSES[0].rgba_label
        mask[labels == 1] = ANNO_CLASSES[1].rgba_label
        Image.fromarray(image).save(root / f"img{i}.png")
        Image.fromarray(mask, mode="RGBA").save(
            root / f"img{i}.png_mask.png"
        )


@pytest.fixture(scope="module")
def calibration_setup(tmp_path_factory):
    """4 images, alternating dark/bright, so the 2-process stride shards
    {img0, img2} (dark) and {img1, img3} (bright) calibrate to different
    activation maxima. Single-process --save-calibration over each shard
    directory gives the per-shard ground truth; the merged multi-host
    file must equal their element-wise max."""
    root = tmp_path_factory.mktemp("mhcalib")
    brightness = [0.35, 1.0, 0.35, 1.0]
    data = root / "data"
    data.mkdir()
    _write_exposure_dataset(data, brightness)
    shards = []
    for pid in range(2):
        d = root / f"shard{pid}"
        d.mkdir()
        (d / "anno_classes.json").write_text(
            (data / "anno_classes.json").read_text()
        )
        for i in range(pid, 4, 2):
            for suffix in (".png", ".png_mask.png"):
                (d / f"img{i}{suffix}").write_bytes(
                    (data / f"img{i}{suffix}").read_bytes()
                )
        shards.append(d)
    model = root / "annonet.dnn"
    _write_model(model, (data / "anno_classes.json").read_text())

    calib = [root / f"calib_s{i}.npz" for i in range(2)] + [
        root / "calib_merged.npz"
    ]
    int8 = ["--quantize", "int8", "--calibration-images", "2"]
    for pid in range(2):
        proc = subprocess.run(
            _infer_cmd(
                shards[pid], model, root / f"rs{pid}.json",
                extra=[*int8, "--save-calibration", str(calib[pid])],
            ),
            env=_env(1), capture_output=True, text=True, timeout=600,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr

    port = _free_port()
    procs = [
        subprocess.Popen(
            _infer_cmd(
                data, model, root / f"rm{pid}.json",
                extra=[
                    *int8, "--save-calibration", str(calib[2]),
                    "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", "2", "--process-id", str(pid),
                ],
            ),
            env=_env(1), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n===\n".join(logs)
    return {"calib": calib, "logs": logs, "model": model}


def test_merged_calibration_is_max_over_all_shards(calibration_setup):
    from annonet_jax import serialization
    from annonet_jax.models.segnet import SegNetConfig

    _, config, _, _ = serialization.load_model(
        str(calibration_setup["model"])
    )
    assert isinstance(config, SegNetConfig)
    s0, s1, merged = (
        serialization.load_calibration(str(p), config)
        for p in calibration_setup["calib"]
    )
    assert len(merged) == len(s0) == len(s1)
    # the dark and bright shards must calibrate to genuinely different
    # maxima somewhere, or this test is vacuous
    assert any(
        a.size and not np.array_equal(a, b) for a, b in zip(s0, s1)
    )
    for a, b, m in zip(s0, s1, merged):
        np.testing.assert_array_equal(np.maximum(a, b), m)


def test_merged_calibration_rank_roles(calibration_setup):
    log0, log1 = calibration_setup["logs"]
    assert "maxima merged across 2 of 2 processes" in log0
    assert "Saved int8 calibration" in log0
    assert "Saved int8 calibration" not in log1


def test_mesh_does_not_compose_with_coordinator(tmp_path):
    write_synthetic_dataset(tmp_path, n_images=1, size=48, seed=0)
    model = tmp_path / "annonet.dnn"
    _write_model(model, (tmp_path / "anno_classes.json").read_text())
    proc = subprocess.run(
        _infer_cmd(tmp_path, model, tmp_path / "r.json",
                   extra=["--coordinator", "127.0.0.1:1", "--mesh", "2",
                          "--num-processes", "1", "--process-id", "0"]),
        env=_env(1), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1
    assert "does not compose with --mesh" in proc.stdout
