"""chip_smoke.py's phases at tiny sizes on CPU, and its refusal to run
anywhere but a GPU. The full-size run happens on the card
(``python chip_smoke.py``); these tests keep its control flow, its
reference and its comparisons checked without one."""

import importlib.util
import json
import pathlib

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _load()

# small enough for CPU: 2 images of 96², level 1, 32 steps of batch 4 (four
# 8-step scan dispatches) — enough training that few pixels sit at
# near-tie logits, where bf16 rounding may move the label
TRAIN = dict(image_size=96, n_images=2, batch=4, steps=32, level_count=1,
             extra_args=("--input-dimension-multiplier", "1.0",
                         "--data-loader-thread-count", "1"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("smoke")
    model, losses = chip_smoke.train_phase(str(out), **TRAIN)
    return str(out), model, losses


def test_device_check_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.check_device()
    # without the requirement it describes the device JAX sees
    assert chip_smoke.check_device(require_gpu=False)["platform"] == "cpu"


def test_main_fails_without_gpu_and_prints_no_result(tmp_path, capsys):
    assert chip_smoke.main(["--out", str(tmp_path)]) == 1
    assert '"ok"' not in capsys.readouterr().out


def test_train_phase_writes_artifact_with_finite_loss(trained):
    _out, model, losses = trained
    assert pathlib.Path(model).stat().st_size > 0
    assert len(losses) == TRAIN["steps"]
    assert np.all(np.isfinite(losses))


def test_train_phase_refuses_a_partial_superstep(tmp_path):
    with pytest.raises(AssertionError, match="multiple of K"):
        chip_smoke.train_phase(str(tmp_path), **{**TRAIN, "steps": 12})


def test_superstep_spy_sees_only_the_scan_dispatches(tmp_path):
    """With the superstep switched off, the train phase's check that the
    default path ran fails."""
    with pytest.raises(AssertionError, match="scan dispatches"):
        chip_smoke.train_phase(str(tmp_path), **{
            **TRAIN, "steps": 8,
            "extra_args": TRAIN["extra_args"] + ("--steps-per-dispatch", "1"),
        })


def test_int8_train_phase_finite():
    assert np.isfinite(chip_smoke.int8_train_phase(batch=2, dim=32,
                                                   level_count=1))


def test_folded_phase_within_tolerance(trained):
    _out, model, _ = trained
    runtime, config, _ = chip_smoke.load_model(model)
    err = chip_smoke.folded_phase(runtime, config, tile=64)
    assert err <= chip_smoke.FOLDED_TOLERANCE


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_infer_phase_agrees_with_reference(trained, quantize):
    out, model, _ = trained
    r = chip_smoke.infer_phase(model, out, image_size=128, quantize=quantize)
    floor = (chip_smoke.INT8_AGREEMENT if quantize == "int8"
             else chip_smoke.FLOAT_AGREEMENT)
    assert r["floor"] == floor
    assert floor <= r["agreement"] <= 1.0
    assert r["differing"] == round((1.0 - r["agreement"]) * 128 * 128)
    assert sum(r["reference_shares"]) == pytest.approx(1.0)


@pytest.fixture(scope="module")
def random_net(tmp_path_factory):
    out = tmp_path_factory.mktemp("random")
    return str(out), chip_smoke.random_model(str(out), level_count=1)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_infer_phase_random_net_spreads_over_classes(random_net, quantize):
    out, model = random_net
    floor = (chip_smoke.INT8_AGREEMENT if quantize == "int8"
             else chip_smoke.FLOAT_RANDOM_AGREEMENT)
    r = chip_smoke.infer_phase(
        model, out, image=chip_smoke.noise_image(128), quantize=quantize,
        floor=floor, min_class_share=chip_smoke.MIN_CLASS_SHARE,
    )
    assert floor <= r["agreement"] <= 1.0
    assert sum(s >= chip_smoke.MIN_CLASS_SHARE
               for s in r["reference_shares"]) >= 2


def test_infer_phase_refuses_a_one_class_reference(trained):
    """The trained net labels the noise-free inspection image almost all
    background, so demanding a second class there must fail."""
    out, model, _ = trained
    with pytest.raises(AssertionError, match="fewer than two classes"):
        chip_smoke.infer_phase(model, out, image_size=128,
                               min_class_share=chip_smoke.MIN_CLASS_SHARE)


def test_class_shares():
    labels = np.array([[0, 0, 1], [2, 0, 1]])
    assert chip_smoke.class_shares(labels, 3) == pytest.approx(
        [0.5, 2 / 6, 1 / 6]
    )


def test_reference_labels_match_the_float32_tiled_inferer(trained):
    """The smoke test's host-blended reference agrees with the library's
    own unfolded float32 tiled inference on the same plan."""
    import dataclasses

    from annonet_jax.infer.core import TiledInferer, annonet_infer
    from annonet_jax.infer.tiling import TilingParameters

    _out, model, _ = trained
    runtime, config, _ = chip_smoke.load_model(model)
    cfg32 = dataclasses.replace(config, compute_dtype="float32")
    image = chip_smoke.smoke_image(128, seed=5)
    inferer = TiledInferer(runtime, cfg32, TilingParameters(64, 64, 16, 16),
                           use_folded_net=False)
    plan = inferer.plan(128, 128)
    reference = chip_smoke.reference_labels(runtime, config, plan, image)
    assert np.mean(reference == annonet_infer(inferer, image)) > 0.999


def test_serve_phase_matches_annonet_infer(trained):
    _out, model, _ = trained
    assert chip_smoke.serve_phase(
        model, sizes=((64, 64), (80, 96)), warmup="64x64"
    ) == 4


def test_four_cards_phase_on_virtual_devices():
    """The --four-cards check on 4 of the suite's virtual CPU devices, at
    the dry run's tiny sizes, over the CLIs' own --mesh 4 mesh."""
    from annonet_jax.cli.common import make_cli_mesh
    from annonet_jax.parallel.check import multichip_check

    mesh = make_cli_mesh(4)
    assert len(set(mesh.devices.flat)) == 4
    result = multichip_check(mesh)
    assert result["devices"] == 4
    assert result["tile_parallel_pixels_differing"] == 0
    json.dumps(result)  # the smoke test prints it as JSON
