"""CLI tests: the annonet_train / annonet_infer entry points run end-to-end
on a synthetic dataset, flags keep reference names/defaults."""

import os

import numpy as np
import pytest

from tests.test_end_to_end import write_synthetic_dataset


def test_train_parser_defaults():
    from annonet_jax.cli.train import build_parser

    args = build_parser().parse_args(["/data"])
    assert args.input_directory_positional == "/data"
    assert args.initial_downscaling_factor == 1.0
    assert args.further_downscaling_factor == 1.0
    assert args.class_weight == 0.5
    assert args.image_weight == 0.5
    assert args.minibatch_size == 100
    assert args.input_dimension_multiplier == 3.0
    assert args.net_width_scaler == 1.0
    assert args.net_width_min_filter_count == 1
    assert args.initial_learning_rate == 0.1
    assert args.learning_rate_shrink_factor == 0.1
    assert args.min_learning_rate == 1e-6
    assert args.save_interval == 1000
    assert args.relative_training_length == 2.0
    assert args.cached_image_count == 8
    # short flags
    args = build_parser().parse_args(
        ["-d", "2", "-f", "1.5", "-u", "-l", "-n", "3", "-o", "-b", "10",
         "-t", "1.0", "-c", "4", "-i", "/x"]
    )
    assert args.initial_downscaling_factor == 2.0
    assert args.further_downscaling_factor == 1.5
    assert args.allow_flip_upside_down and args.allow_flip_left_right
    assert args.noise_level_stddev == 3.0
    assert args.allow_random_color_offset
    assert args.minibatch_size == 10
    assert args.relative_training_length == 1.0
    assert args.cached_image_count == 4
    assert args.input_directory == "/x"


def test_infer_parser_defaults_and_h_flag():
    from annonet_jax.cli.infer import build_parser

    args = build_parser().parse_args(["/data"])
    # parse-time default is None = auto: 1024, the reference's default on
    # its CUDA build (annonet_infer_main.cpp:300-307)
    assert args.tile_max_width is None
    assert args.tile_max_height is None
    from annonet_jax.cli.common import default_tile_max

    assert default_tile_max() == 1024
    assert args.gain == [] and args.detection == []
    # -h means tile-max-height like the reference, NOT help
    args = build_parser().parse_args(["-w", "512", "-h", "256", "/data"])
    assert args.tile_max_width == 512
    assert args.tile_max_height == 256
    args = build_parser().parse_args(
        ["-g", "1:-0.5", "-g", "2:0.25", "-d", "1:1.5", "/data"]
    )
    assert args.gain == ["1:-0.5", "2:0.25"]
    assert args.detection == ["1:1.5"]


def test_parse_class_specific_values():
    from annonet_jax.cli.common import parse_class_specific_values

    assert parse_class_specific_values(["1:-0.5"], 3) == [0.0, -0.5, 0.0]
    with pytest.raises(ValueError, match="index:gain"):
        parse_class_specific_values(["nope"], 3)
    with pytest.raises(ValueError, match="only 3 classes"):
        parse_class_specific_values(["7:1.0"], 3)


def test_train_requires_input_directory(capsys):
    from annonet_jax.cli.train import main

    assert main([]) == 1
    out = capsys.readouterr().out
    assert "anno" in out


def test_grayscale_color_offset_warns(tmp_path, capsys):
    """-o with --grayscale is a no-op (reference grayscale builds omit -o
    from the flag table entirely, annonet_train_main.cpp:285-287); we
    accept it for a uniform surface but warn."""
    from annonet_jax.cli.train import main

    # empty directory -> exits 1 after the config echo, which is after
    # the warning — no training happens, the test stays fast
    assert main([str(tmp_path), "--grayscale", "-o"]) == 1
    out = capsys.readouterr().out
    assert "--allow-random-color-offset has no effect" in out

    assert main([str(tmp_path), "--grayscale"]) == 1
    out = capsys.readouterr().out
    assert "--allow-random-color-offset has no effect" not in out


@pytest.mark.slow
def test_cli_train_then_infer_round_trip(tmp_path, capsys):
    from annonet_jax.cli.infer import main as infer_main
    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path)
    model_path = str(tmp_path / "annonet.dnn")
    sync_path = str(tmp_path / "annonet_trainer_state_file.dat")

    rc = train_main(
        [
            str(tmp_path),
            "--max-total-steps", "25",
            "-b", "4",
            "--level-count", "1",
            "--net-width-scaler", "0.5",
            "--input-dimension-multiplier", "1.0",
            "--initial-learning-rate", "0.05",
            "--data-loader-thread-count", "2",
            "--output", model_path,
            "--sync-file", sync_path,
        ]
    )
    assert rc == 0
    assert os.path.exists(model_path)
    assert os.path.exists(sync_path)
    out = capsys.readouterr().out
    assert "Required input dimension" in out
    assert "images in dataset: 4" in out
    assert "saving network" in out

    rc = infer_main(
        [
            str(tmp_path),
            "--model", model_path,
            "-g", "1:0.1",
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "All result images written!" in out
    assert "Confusion matrix per pixel:" in out
    assert "Confusion matrix per region (two-way):" in out
    assert "accuracy" in out
    # result PNGs exist and decode to palette colors
    from PIL import Image

    for i in range(4):
        result_path = tmp_path / f"img{i}.png_result.png"
        assert result_path.exists()
        rgba = np.asarray(Image.open(result_path))
        assert rgba.shape == (48, 48, 4)


@pytest.mark.slow
def test_cli_train_with_mesh(tmp_path, capsys):
    """--mesh N trains data-parallel on the virtual 8-device CPU mesh."""
    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path, n_images=2, size=32)
    model_path = str(tmp_path / "annonet.dnn")
    rc = train_main(
        [
            str(tmp_path),
            "--mesh", "8",
            "--max-total-steps", "2",
            "-b", "9",  # rounds up to 16
            "--level-count", "1",
            "--net-width-scaler", "0.25",
            "--input-dimension-multiplier", "1.0",
            "--data-loader-thread-count", "1",
            "--output", model_path,
            "--sync-file", str(tmp_path / "sync.dat"),
            # validation under --mesh: the replicated (mesh-committed)
            # params must be pulled to host for the single-device
            # tiled-inference programs
            "--validation-directory", str(tmp_path),
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "rounded up to 16" in out
    assert "validation (step" in out
    assert os.path.exists(model_path)


@pytest.mark.slow
def test_cli_infer_with_mesh_and_int8(tmp_path, capsys):
    """--mesh N shards each image's tile batch across the virtual 8-device
    CPU mesh (tile-parallel inference), composing with --quantize int8."""
    from annonet_jax.cli.infer import main as infer_main
    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path, n_images=2, size=32)
    model_path = str(tmp_path / "annonet.dnn")
    rc = train_main(
        [
            str(tmp_path),
            "--max-total-steps", "2",
            "-b", "2",
            "--level-count", "0",
            "--net-width-scaler", "0.25",
            "--input-dimension-multiplier", "1.0",
            "--data-loader-thread-count", "1",
            "--output", model_path,
            "--sync-file", str(tmp_path / "sync.dat"),
        ]
    )
    assert rc == 0
    capsys.readouterr()
    rc = infer_main(
        [
            str(tmp_path),
            "--model", model_path,
            "--mesh", "8",
            "--quantize", "int8",
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "All result images written!" in out
    assert (tmp_path / "img0.png_result.png").exists()


@pytest.mark.slow
def test_cli_downscaling_factor_round_trip(tmp_path, capsys):
    """The downscaling factor persisted at train time is applied at
    inference and results are upscaled back to the original size
    (annonet_train_main.cpp:564, annonet_infer_main.cpp:398,413)."""
    from annonet_jax.cli.infer import main as infer_main
    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path, n_images=2, size=64)
    model_path = str(tmp_path / "annonet.dnn")

    rc = train_main(
        [
            str(tmp_path),
            "-d", "2",
            "--max-total-steps", "3",
            "-b", "2",
            "--level-count", "1",
            "--net-width-scaler", "0.25",
            "--input-dimension-multiplier", "1.0",
            "--data-loader-thread-count", "1",
            "--output", model_path,
            "--sync-file", str(tmp_path / "sync.dat"),
        ]
    )
    assert rc == 0

    from annonet_jax import serialization

    _, _, _, factor = serialization.load_model(model_path)
    assert factor == 2.0

    rc = infer_main([str(tmp_path), "--model", model_path])
    assert rc == 0
    capsys.readouterr()

    from PIL import Image

    rgba = np.asarray(Image.open(tmp_path / "img0.png_result.png"))
    assert rgba.shape == (64, 64, 4)  # upscaled back to original size


def test_infer_negative_detection_level_rejected(tmp_path, capsys):
    """annonet_infer.cpp:189 asserts detection levels >= 0; a negative level
    must be a clean one-line error, not silently accepted."""
    from annonet_jax.cli.common import parse_class_specific_values

    with pytest.raises(ValueError, match="non-negative"):
        parse_class_specific_values(["1:-0.5"], 3, require_non_negative=True)
    # gains may still be negative (the reference's own example is 1:-0.5)
    assert parse_class_specific_values(["1:-0.5"], 3) == [0.0, -0.5, 0.0]


def test_infer_missing_model_is_clean_error(tmp_path, capsys):
    """Top-level catch parity (annonet_infer_main.cpp tail): message + rc 1,
    no traceback, no hung threads."""
    from annonet_jax.cli.infer import main as infer_main

    write_synthetic_dataset(tmp_path)
    rc = infer_main([str(tmp_path), "--model", str(tmp_path / "missing.dnn")])
    assert rc == 1
    out = capsys.readouterr().out
    assert "missing.dnn" in out
    assert "Traceback" not in out


def test_infer_corrupt_input_is_clean_error(tmp_path, capsys):
    """A sample whose mask is corrupt surfaces as a one-line error with
    exit code 1, and the reader/writer threads shut down."""
    import threading

    from annonet_jax.cli.infer import main as infer_main
    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path)
    rc = train_main(
        [
            str(tmp_path),
            "--max-total-steps", "2",
            "-b", "2",
            "--level-count", "0",
            "--input-dimension-multiplier", "1.0",
            "--data-loader-thread-count", "1",
            "--output", str(tmp_path / "annonet.dnnx"),
            "--sync-file", str(tmp_path / "sync.dat"),
        ]
    )
    assert rc == 0
    capsys.readouterr()

    # corrupt one mask: wrong size triggers read_sample's error-as-data path
    from PIL import Image

    bad = np.zeros((7, 9, 4), np.uint8)
    Image.fromarray(bad).save(tmp_path / "img1.png_mask.png")

    threads_before = threading.active_count()
    rc = infer_main(
        [str(tmp_path), "--model", str(tmp_path / "annonet.dnnx")]
    )
    assert rc == 1
    out = capsys.readouterr().out
    assert "Traceback" not in out
    # give daemon threads a beat, then confirm none piled up
    import time as _time

    deadline = _time.monotonic() + 5.0
    while (
        threading.active_count() > threads_before
        and _time.monotonic() < deadline
    ):
        _time.sleep(0.05)
    assert threading.active_count() <= threads_before


def test_train_setup_error_is_clean(tmp_path, capsys):
    """Setup-phase failures (corrupt anno_classes.json) print one line and
    return 1 (annonet_train_main.cpp:640-644)."""
    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path)
    (tmp_path / "anno_classes.json").write_text("{not json")
    rc = train_main([str(tmp_path), "--max-total-steps", "1", "-b", "1"])
    assert rc == 1
    out = capsys.readouterr().out
    assert "Traceback" not in out


def test_index_ordered_results():
    """Reader results arriving out of order are consumed in file order."""
    import queue
    import threading

    from annonet_jax.cli.common import IndexOrderedResults

    q = queue.Queue(maxsize=4)
    arrival = [3, 0, 2, 5, 1, 4, 7, 6]

    def producer():
        for idx in arrival:
            q.put((idx, f"item{idx}"))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    ordered = IndexOrderedResults(q)
    assert [ordered.next() for _ in range(8)] == [
        f"item{i}" for i in range(8)
    ]
    t.join(timeout=5)


def test_infer_corrupt_model_is_clean_error(tmp_path, capsys):
    """A garbage annonet.dnn yields a one-line error and exit 1 (top-level
    catch parity), not a traceback."""
    from annonet_jax.cli.infer import main as infer_main

    write_synthetic_dataset(tmp_path)
    model = tmp_path / "annonet.dnn"
    model.write_bytes(b"not an npz at all \x00\x01\x02" * 16)
    rc = infer_main([str(tmp_path), "--model", str(model)])
    assert rc == 1
    out = capsys.readouterr().out
    assert "Traceback" not in out


@pytest.mark.slow
def test_cli_infer_image_batch_matches_unbatched(tmp_path, capsys):
    """--image-batch N groups same-size images into one device forward;
    results (confusion matrices, result PNGs) are identical to the
    per-image default."""
    from annonet_jax.cli.infer import main as infer_main
    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path, n_images=4, size=48)
    model_path = str(tmp_path / "annonet.dnn")
    rc = train_main(
        [
            str(tmp_path),
            "--max-total-steps", "10",
            "-b", "4",
            "--level-count", "0",
            "--net-width-scaler", "0.25",
            "--input-dimension-multiplier", "1.0",
            "--data-loader-thread-count", "1",
            "--output", model_path,
            "--sync-file", str(tmp_path / "sync.dat"),
        ]
    )
    assert rc == 0
    capsys.readouterr()

    def run(extra):
        rc = infer_main([str(tmp_path), "--model", model_path, *extra])
        assert rc == 0
        out = capsys.readouterr().out
        import re

        matrices = out[out.index("Confusion matrix per pixel"):]
        pngs = {
            p.name: np.asarray(__import__("PIL.Image", fromlist=["Image"])
                               .open(p))
            for p in sorted(tmp_path.glob("*_result.png"))
        }
        return matrices, pngs

    base_out, base_pngs = run([])
    batch_out, batch_pngs = run(["--image-batch", "3"])  # 4 imgs -> 3+1
    assert base_out == batch_out
    assert base_pngs.keys() == batch_pngs.keys()
    for name in base_pngs:
        np.testing.assert_array_equal(base_pngs[name], batch_pngs[name])


def test_train_parse_error_exit_codes(tmp_path, capsys):
    """cxxopts parse-error parity (annonet_train_main.cpp:329-335): the
    message, a blank line, and the FULL help text go to stderr, exit 2."""
    from annonet_jax.cli.train import main as train_main

    # unknown flag
    rc = train_main(["--no-such-flag", str(tmp_path)])
    assert rc == 2
    err = capsys.readouterr().err
    assert "--initial-downscaling-factor" in err  # full help, not brief usage

    # flags present but no input-directory: parse-error path, NOT the
    # argc==1 usage blurb (which is stdout + exit 1)
    rc = train_main(["-b", "4"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "Option 'input-directory' is required but not present" in err

    # non-positive downscaling factor: the three echo lines still print to
    # stdout first (they sit inside the reference's parse try-block,
    # annonet_train_main.cpp:322-328), then message + help to stderr
    rc = train_main([str(tmp_path), "-d", "0"])
    assert rc == 2
    captured = capsys.readouterr()
    assert "Initial downscaling factor = 0" in captured.out
    assert "strictly positive" in captured.err


def test_infer_parse_error_exit_codes(tmp_path, capsys):
    """Same parity for annonet_infer (annonet_infer_main.cpp:335-340)."""
    from annonet_jax.cli.infer import main as infer_main

    rc = infer_main(["--no-such-flag", str(tmp_path)])
    assert rc == 2
    err = capsys.readouterr().err
    assert "--tile-max-width" in err

    rc = infer_main(["-w", "512"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "Option 'input-directory' is required but not present" in err


def test_train_loop_error_exits_2(tmp_path, capsys):
    """Errors thrown from inside the training loop (here: every mask has
    the wrong size, so the first crop dequeues as an error) print the
    message and exit 2 (annonet_train_main.cpp:616-620) — unlike setup
    errors, which exit 1 through the outer catch (:640-644)."""
    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path, n_images=2, size=32)
    from PIL import Image

    bad = np.zeros((7, 9, 4), np.uint8)
    for mask in tmp_path.glob("*_mask.png"):
        Image.fromarray(bad).save(mask)

    rc = train_main(
        [
            str(tmp_path),
            "--max-total-steps", "2",
            "-b", "2",
            "--level-count", "0",
            "--input-dimension-multiplier", "1.0",
            "--data-loader-thread-count", "1",
            "--output", str(tmp_path / "m.dnn"),
            "--sync-file", str(tmp_path / "sync.dat"),
        ]
    )
    assert rc == 2
    out = capsys.readouterr().out
    assert "Traceback" not in out
    assert "mismatch" in out  # the sample error surfaced as the message
    # the final network save is skipped on loop errors (reference parity)
    assert not (tmp_path / "m.dnn").exists()


def test_infer_gain_format_error_exits_1(tmp_path, capsys):
    """Gain/detection format errors are thrown AFTER cxxopts parsing
    (annonet_infer_main.cpp:36-63, called at :357-358), so they hit the
    outer catch: message to stdout, exit 1 — not the parse-error exit 2."""
    from annonet_jax.cli.infer import main as infer_main
    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path, n_images=2, size=32)
    model_path = str(tmp_path / "annonet.dnn")
    rc = train_main(
        [
            str(tmp_path),
            "--max-total-steps", "2",
            "-b", "2",
            "--level-count", "0",
            "--input-dimension-multiplier", "1.0",
            "--data-loader-thread-count", "1",
            "--output", model_path,
            "--sync-file", str(tmp_path / "sync.dat"),
        ]
    )
    assert rc == 0
    capsys.readouterr()

    rc = infer_main([str(tmp_path), "--model", model_path, "-g", "nope"])
    assert rc == 1
    captured = capsys.readouterr()
    assert "index:gain" in captured.out

    # out-of-range class index: same path
    rc = infer_main([str(tmp_path), "--model", model_path, "-g", "9:1.0"])
    assert rc == 1
    assert "only" in capsys.readouterr().out


@pytest.mark.slow
def test_infer_pipelined_timing_not_double_counted(tmp_path, capsys):
    """At the default --pipeline-depth 2 the per-group timing intervals are
    disjoint (device-busy time), so the printed 'actual inference' total
    can never exceed the wall-clock total — the reference's sequential
    timing invariant (annonet_infer_main.cpp:466-507). Before the fix,
    dispatch->readback spans overlapped and the sum could exceed wall."""
    import re

    from annonet_jax.cli.infer import main as infer_main
    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path, n_images=6, size=48)
    model_path = str(tmp_path / "annonet.dnn")
    rc = train_main(
        [
            str(tmp_path),
            "--max-total-steps", "2",
            "-b", "2",
            "--level-count", "0",
            "--input-dimension-multiplier", "1.0",
            "--data-loader-thread-count", "1",
            "--output", model_path,
            "--sync-file", str(tmp_path / "sync.dat"),
        ]
    )
    assert rc == 0
    capsys.readouterr()

    rc = infer_main(
        [str(tmp_path), "--model", model_path, "--pipeline-depth", "2"]
    )
    assert rc == 0
    out = capsys.readouterr().out
    m = re.search(
        r"processed in ([0-9.]+) seconds!"
        r" \(actual inference: ([0-9.]+) seconds\)",
        out,
    )
    assert m, out
    wall, inference = float(m.group(1)), float(m.group(2))
    assert inference <= wall + 0.05
    assert "Processing time excluding the first image:" in out


def test_platform_env_pins_backend_in_subprocess():
    """ANNONET_PLATFORM=cpu must pin the backend with JAX_PLATFORMS
    unset — the CLIs call apply_platform_env before backend init."""
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["ANNONET_PLATFORM"] = "cpu"
    code = (
        "from annonet_jax.cli.common import apply_platform_env;"
        "apply_platform_env();"
        "import jax;"
        "print(jax.devices()[0].platform)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "cpu"


def test_cli_infer_save_and_load_calibration(tmp_path, capsys):
    """--save-calibration persists the frozen int8 scales; --calibration
    loads them so the run skips runtime calibration (extension)."""
    from annonet_jax.cli.infer import main as infer_main
    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path, n_images=2, size=32)
    model_path = str(tmp_path / "annonet.dnn")
    rc = train_main(
        [
            str(tmp_path),
            "--max-total-steps", "2",
            "-b", "2",
            "--level-count", "0",
            "--net-width-scaler", "0.25",
            "--input-dimension-multiplier", "1.0",
            "--data-loader-thread-count", "1",
            "--output", model_path,
            "--sync-file", str(tmp_path / "sync.dat"),
        ]
    )
    assert rc == 0
    capsys.readouterr()

    calib_path = str(tmp_path / "annonet.calib")
    rc = infer_main(
        [
            str(tmp_path),
            "--model", model_path,
            "--quantize", "int8",
            "--save-calibration", calib_path,
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert f"Saved int8 calibration to {calib_path}" in out
    import os

    assert os.path.exists(calib_path)

    rc = infer_main(
        [
            str(tmp_path),
            "--model", model_path,
            "--quantize", "int8",
            "--calibration", calib_path,
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert f"Loaded int8 calibration from {calib_path}" in out
    assert "All result images written!" in out

    # both flags require --quantize int8 (reference-style outer catch ->
    # message + exit 1)
    rc = infer_main(
        [str(tmp_path), "--model", model_path,
         "--calibration", calib_path]
    )
    assert rc == 1


def test_cli_infer_blend_dtype_flag(tmp_path, capsys):
    """--blend-dtype float32 pins the pre-bf16 blend on the int8 path
    (escape hatch for bit-parity with the float path's blending)."""
    from annonet_jax.cli.infer import main as infer_main
    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path, n_images=2, size=32)
    model_path = str(tmp_path / "annonet.dnn")
    rc = train_main(
        [
            str(tmp_path),
            "--max-total-steps", "2",
            "-b", "2",
            "--level-count", "0",
            "--net-width-scaler", "0.25",
            "--input-dimension-multiplier", "1.0",
            "--data-loader-thread-count", "1",
            "--output", model_path,
            "--sync-file", str(tmp_path / "sync.dat"),
        ]
    )
    assert rc == 0
    capsys.readouterr()
    rc = infer_main(
        [
            str(tmp_path),
            "--model", model_path,
            "--quantize", "int8",
            "--blend-dtype", "float32",
        ]
    )
    assert rc == 0
    assert "All result images written!" in capsys.readouterr().out


def test_every_entry_point_pins_the_platform():
    """Each process entry point (CLIs + bench.py) must call
    apply_platform_env before backend init, so ANNONET_PLATFORM pins every
    process the same way (two entry points once shipped without the pin;
    this guards the class)."""
    import inspect
    import os

    import annonet_jax.cli.autotune
    import annonet_jax.cli.infer
    import annonet_jax.cli.inspect
    import annonet_jax.cli.serve
    import annonet_jax.cli.train

    for mod in (
        annonet_jax.cli.autotune,
        annonet_jax.cli.infer,
        annonet_jax.cli.inspect,
        annonet_jax.cli.serve,
        annonet_jax.cli.train,
    ):
        src = inspect.getsource(mod.main)
        assert "apply_platform_env" in src, mod.__name__
    bench = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "bench.py",
    )
    with open(bench) as f:
        assert "apply_platform_env" in f.read()


@pytest.mark.slow
def test_train_metrics_jsonl(tmp_path, capsys):
    """--metrics-jsonl appends a structured event stream: start, every
    recorded loss at --metrics-interval 1, model saves, and done (an
    extension — the printed verbose output is unchanged)."""
    import json

    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path)
    metrics_path = tmp_path / "metrics.jsonl"
    rc = train_main(
        [
            str(tmp_path),
            "--max-total-steps", "6",
            "-b", "4",
            "--level-count", "0",
            "--net-width-scaler", "0.5",
            "--input-dimension-multiplier", "1.0",
            "--data-loader-thread-count", "1",
            "--loss-sync-interval", "2",
            "--steps-per-dispatch", "2",
            "--output", str(tmp_path / "annonet.dnn"),
            "--sync-file", str(tmp_path / "sync.dat"),
            "--metrics-jsonl", str(metrics_path),
            "--metrics-interval", "1",
        ]
    )
    assert rc == 0
    events = [
        json.loads(line)
        for line in metrics_path.read_text().splitlines()
    ]
    kinds = [e["event"] for e in events]
    assert kinds[0] == "start"
    assert kinds[-1] == "done"
    assert "save" in kinds
    start = events[0]
    assert start["minibatch_size"] == 4
    assert start["class_count"] == 2
    losses = [e for e in events if e["event"] == "loss"]
    # all 6 dispatched steps' losses are recorded by exit (flushed), in order
    assert [e["step"] for e in losses] == list(range(1, 7))
    for e in losses:
        assert np.isfinite(e["loss"])
        assert e["learning_rate"] > 0
        assert "steps_without_progress" in e
        assert "time" in e
    done = events[-1]
    assert done["steps"] == 6
    assert done["wall_seconds"] > 0
    saves = [e for e in events if e["event"] == "save"]
    assert saves[-1]["step"] == 6 and saves[0]["step"] == 0


@pytest.mark.slow
def test_infer_report_json(tmp_path, capsys):
    """--report-json writes the machine-readable run report: per-image
    timings, timing summary, and both confusion-matrix summaries with
    per-class recall/precision (extension)."""
    import json

    from annonet_jax.cli.infer import main as infer_main
    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path)
    model_path = str(tmp_path / "annonet.dnn")
    rc = train_main(
        [
            str(tmp_path),
            "--max-total-steps", "2",
            "-b", "4",
            "--level-count", "0",
            "--net-width-scaler", "0.5",
            "--input-dimension-multiplier", "1.0",
            "--data-loader-thread-count", "1",
            "--output", model_path,
            "--sync-file", str(tmp_path / "sync.dat"),
        ]
    )
    assert rc == 0
    report_path = tmp_path / "report.json"
    rc = infer_main(
        [
            str(tmp_path),
            "--model", model_path,
            "-g", "1:0.25",
            "--report-json", str(report_path),
        ]
    )
    assert rc == 0
    assert "Report written to" in capsys.readouterr().out
    report = json.loads(report_path.read_text())
    assert report["images"] == 4
    assert len(report["per_image"]) == 4
    for rec in report["per_image"]:
        assert rec["width"] == 48 and rec["height"] == 48
        assert rec["milliseconds"] > 0
    assert report["gains"][1] == 0.25
    assert report["wall_seconds"] >= report["inference_seconds"] > 0
    assert report["excluding_first"]["count"] > 0
    for key in ("confusion_per_pixel", "confusion_per_region"):
        cm = report[key]
        assert len(cm["matrix"]) == 2
        assert cm["total"] > 0
        assert 0.0 <= cm["accuracy"] <= 1.0
        names = [c["name"] for c in cm["classes"]]
        assert names == ["clean", "defect"]


@pytest.mark.slow
def test_train_divergence_in_tail_flush_exits_2(tmp_path, capsys):
    """A non-finite loss surfacing only in the post-loop tail flush (all
    losses still buffered under --loss-sync-interval) must keep the
    training-loop error contract: exit 2, error event in --metrics-jsonl,
    and NO final model save of the poisoned weights."""
    import json

    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path)
    model_path = tmp_path / "annonet.dnn"
    metrics_path = tmp_path / "metrics.jsonl"
    rc = train_main(
        [
            str(tmp_path),
            "--max-total-steps", "4",
            "-b", "4",
            "--level-count", "0",
            "--net-width-scaler", "0.5",
            "--input-dimension-multiplier", "1.0",
            "--data-loader-thread-count", "1",
            "--initial-learning-rate", "1e20",
            "--loss-sync-interval", "8",
            "--steps-per-dispatch", "1",
            "--save-interval", "1000",
            "--output", str(model_path),
            "--sync-file", str(tmp_path / "sync.dat"),
            "--metrics-jsonl", str(metrics_path),
        ]
    )
    assert rc == 2
    assert "diverged" in capsys.readouterr().out
    events = [
        json.loads(line) for line in metrics_path.read_text().splitlines()
    ]
    assert events[-1]["event"] == "error"
    assert "diverged" in events[-1]["message"]
    # the minibatch-0 periodic save ran (reference parity; absolute step
    # 1 — one step already dispatched); the FINAL save of the
    # now-poisoned weights must not have
    saves = [e for e in events if e["event"] == "save"]
    assert [e["step"] for e in saves] == [1]


@pytest.mark.slow
def test_train_validation_directory(tmp_path, capsys):
    """--validation-directory evaluates the exported net on a held-out
    anno dir after every save: per-pixel accuracy + per-class recall
    printed and recorded as metrics events (extension)."""
    import json

    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path)
    val_dir = tmp_path / "val"
    val_dir.mkdir()
    write_synthetic_dataset(val_dir, n_images=2, seed=7)
    metrics_path = tmp_path / "metrics.jsonl"
    rc = train_main(
        [
            str(tmp_path),
            "--max-total-steps", "2",
            "-b", "4",
            "--level-count", "0",
            "--net-width-scaler", "0.5",
            "--input-dimension-multiplier", "1.0",
            "--data-loader-thread-count", "1",
            "--output", str(tmp_path / "annonet.dnn"),
            "--sync-file", str(tmp_path / "sync.dat"),
            "--validation-directory", str(val_dir),
            "--metrics-jsonl", str(metrics_path),
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "validation (step" in out
    assert "accuracy = " in out
    events = [
        json.loads(line) for line in metrics_path.read_text().splitlines()
    ]
    vals = [e for e in events if e["event"] == "validation"]
    # one validation per save: the minibatch-0 periodic save (its one
    # decision still buffered in the superstep window, so 0 steps applied
    # to the exported weights) and the final save. Steps are ABSOLUTE
    # DISPATCHED counts, matching loss/shrink events across resumes
    # (round-5 numbering fix).
    assert [v["step"] for v in vals] == [0, 2]
    for v in vals:
        assert 0.0 <= v["accuracy"] <= 1.0
        assert v["images"] == 2
        assert v["labeled_pixels"] > 0
        assert len(v["classes"]) == 2

    # a missing/empty validation dir is a setup error: exit 1
    rc = train_main(
        [
            str(tmp_path),
            "--max-total-steps", "1",
            "-b", "4",
            "--level-count", "0",
            "--input-dimension-multiplier", "1.0",
            "--output", str(tmp_path / "annonet.dnn"),
            "--sync-file", str(tmp_path / "sync2.dat"),
            "--validation-directory", str(tmp_path / "nope"),
        ]
    )
    assert rc == 1


@pytest.mark.slow
def test_train_validation_quantize_int8(tmp_path, capsys):
    """--validation-quantize int8 validates the deployed (quantized) path;
    calibration restarts per save via update_params."""
    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path)
    rc = train_main(
        [
            str(tmp_path),
            "--max-total-steps", "2",
            "-b", "4",
            "--level-count", "0",
            "--net-width-scaler", "0.5",
            "--input-dimension-multiplier", "1.0",
            "--data-loader-thread-count", "1",
            "--output", str(tmp_path / "annonet.dnn"),
            "--sync-file", str(tmp_path / "sync.dat"),
            "--validation-directory", str(tmp_path),
            "--validation-quantize", "int8",
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("validation (step") == 2
    assert "accuracy = " in out


@pytest.mark.slow
def test_validation_edge_cases(tmp_path, capsys):
    """(a) --validation-quantize without --validation-directory is a setup
    error (exit 1); (b) a validation set whose masks are entirely the
    ignore color reports accuracy n/a instead of crashing; (c) unreadable
    validation data surfaces at SETUP (exit 1), not at the first save."""
    import numpy as np
    from PIL import Image

    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path)
    base = [
        str(tmp_path),
        "--max-total-steps", "1",
        "-b", "4",
        "--level-count", "0",
        "--net-width-scaler", "0.5",
        "--input-dimension-multiplier", "1.0",
        "--data-loader-thread-count", "1",
        "--output", str(tmp_path / "annonet.dnn"),
    ]
    rc = train_main(
        base + ["--sync-file", str(tmp_path / "s1.dat"),
                "--validation-quantize", "int8"]
    )
    assert rc == 1
    assert "requires --validation-directory" in capsys.readouterr().out

    # all-ignore masks: zero labeled pixels -> accuracy n/a, no crash
    ignore_dir = tmp_path / "ignore_val"
    ignore_dir.mkdir()
    img = np.zeros((32, 32, 3), np.uint8)
    Image.fromarray(img).save(ignore_dir / "a.png")
    Image.fromarray(
        np.zeros((32, 32, 4), np.uint8), mode="RGBA"
    ).save(ignore_dir / "a.png_mask.png")
    rc = train_main(
        base + ["--sync-file", str(tmp_path / "s2.dat"),
                "--validation-directory", str(ignore_dir)]
    )
    assert rc == 0
    assert "accuracy = n/a (no labeled pixels)" in capsys.readouterr().out

    # size-mismatched masks: every sample errors -> setup error, exit 1
    bad_dir = tmp_path / "bad_val"
    bad_dir.mkdir()
    Image.fromarray(img).save(bad_dir / "b.png")
    Image.fromarray(
        np.zeros((16, 16, 4), np.uint8), mode="RGBA"
    ).save(bad_dir / "b.png_mask.png")
    rc = train_main(
        base + ["--sync-file", str(tmp_path / "s3.dat"),
                "--validation-directory", str(bad_dir)]
    )
    assert rc == 1
    out = capsys.readouterr().out
    assert "Label image size mismatch" in out
    assert "No readable validation samples" in out


def test_inspect_describes_artifact(tmp_path, capsys):
    """annonet_inspect prints the self-describing artifact as JSON:
    config, classes, dimension queries, parameter totals, fingerprint,
    and a calibration file's match status."""
    import json

    import jax

    from annonet_jax import serialization
    from annonet_jax.classes import anno_classes_to_json, default_anno_classes
    from annonet_jax.cli.inspect import main as inspect_main
    from annonet_jax.models.segnet import (
        SegNetConfig,
        fold_batchnorm,
        init_state,
    )

    config = SegNetConfig(class_count=3, level_count=1, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    model_path = str(tmp_path / "annonet.dnn")
    serialization.save_model(
        model_path, runtime, config,
        anno_classes_to_json(default_anno_classes()), 2.0,
    )
    calib_path = str(tmp_path / "calib.npz")
    serialization.save_calibration(
        calib_path, [np.ones(16, np.float32)], config, runtime
    )

    rc = inspect_main([model_path, "--calibration", calib_path])
    assert rc == 0
    info = json.loads(capsys.readouterr().out)
    assert info["model_config"]["class_count"] == 3
    assert info["downscaling_factor"] == 2.0
    assert [c["name"] for c in info["classes"]][:1] == ["clean"]
    assert info["required_input_dimension"] > 0
    assert info["parameters"] > 0 and info["bytes"] > 0
    assert len(info["weights_fingerprint"]) == 64
    assert info["calibration"]["matches_model"] is True

    # a calibration from different weights reports the mismatch
    params2, bn2 = init_state(jax.random.PRNGKey(5), config)
    serialization.save_calibration(
        calib_path, [np.ones(16, np.float32)], config,
        fold_batchnorm(params2, bn2, config),
    )
    rc = inspect_main([model_path, "--calibration", calib_path])
    assert rc == 0
    info = json.loads(capsys.readouterr().out)
    assert info["calibration"]["matches_model"] is False

    # a non-artifact errors with exit 1
    rc = inspect_main([str(tmp_path / "missing.npz")])
    assert rc == 1
