"""Batch-size autotuner search logic (find_max_mini-batch_size.cmd port)."""

import pytest

from annonet_jax.cli import autotune


def searcher(max_working):
    """Simulate a device where sizes <= max_working pass."""
    calls = []

    def fake_probe(size, args):
        calls.append(size)
        return size <= max_working

    return fake_probe, calls


def test_search_finds_exact_boundary(monkeypatch):
    for boundary in [1, 7, 100, 137, 400, 1000]:
        fake_probe, calls = searcher(boundary)
        monkeypatch.setattr(autotune, "probe", fake_probe)
        found = autotune.find_max_minibatch_size([], start=100)
        assert found == boundary, (boundary, found, calls)


def test_search_raises_when_nothing_works(monkeypatch):
    fake_probe, _ = searcher(0)
    monkeypatch.setattr(autotune, "probe", fake_probe)
    import pytest

    with pytest.raises(RuntimeError):
        autotune.find_max_minibatch_size([], start=100)


def test_deferred_loss_sync_matches_blocking():
    """loss_sync_interval > 1 must record the same losses, just later."""
    import numpy as np

    from annonet_jax.data.crop import CropOptions
    from annonet_jax.models.segnet import SegNetConfig
    from annonet_jax.train.trainer import Trainer, TrainerConfig

    mc = SegNetConfig(
        class_count=2, level_count=1, base_width=4, compute_dtype="float32"
    )
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(2, 16, 16, 3), dtype=np.uint8)
    labels = rng.integers(0, 2, size=(2, 16, 16)).astype(np.uint16)
    opts = CropOptions(dim=16)

    blocking = Trainer(mc, TrainerConfig(initial_learning_rate=0.01), seed=0)
    deferred = Trainer(
        mc,
        TrainerConfig(initial_learning_rate=0.01, loss_sync_interval=4),
        seed=0,
    )
    block_losses = [
        blocking.train_step_crops(images, labels, opts) for _ in range(6)
    ]
    for _ in range(6):
        assert deferred.train_step_crops(images, labels, opts) is None
    # the lagged auto-flush triggers at 2x the interval (8 pending);
    # at 6 steps everything is still queued — drain explicitly
    deferred.flush_losses()
    np.testing.assert_allclose(
        deferred.previous_loss_values, block_losses, rtol=1e-6
    )
    assert deferred.step_count == blocking.step_count == 6


def test_remat_matches_no_remat():
    """Remat must not change the computed update, only the schedule."""
    import jax
    import numpy as np

    from annonet_jax.data.crop import CropOptions
    from annonet_jax.models.segnet import SegNetConfig
    from annonet_jax.train.trainer import Trainer, TrainerConfig

    mc = SegNetConfig(
        class_count=2, level_count=1, base_width=4, compute_dtype="float32"
    )
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(2, 16, 16, 3), dtype=np.uint8)
    labels = rng.integers(0, 2, size=(2, 16, 16)).astype(np.uint16)
    opts = CropOptions(dim=16)

    plain = Trainer(mc, TrainerConfig(initial_learning_rate=0.01), seed=0)
    remat = Trainer(
        mc, TrainerConfig(initial_learning_rate=0.01, remat=True), seed=0
    )
    loss_plain = plain.train_step_crops(images, labels, opts)
    loss_remat = remat.train_step_crops(images, labels, opts)
    assert np.isclose(loss_plain, loss_remat, rtol=1e-6)
    for a, b in zip(
        jax.tree_util.tree_leaves(plain.params),
        jax.tree_util.tree_leaves(remat.params),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5)


@pytest.mark.slow
def test_autotune_with_mesh_end_to_end(tmp_path):
    """Autotuned minibatch + data-parallel training. The search probes and the real run all pass --mesh 8 through
    to the train CLI on the virtual mesh."""
    import os
    import subprocess
    import sys

    from tests.test_end_to_end import write_synthetic_dataset

    write_synthetic_dataset(tmp_path)
    env = dict(os.environ)
    env["ANNONET_VIRTUAL_MESH"] = "1"  # fake 8 CPU devices in probes
    # the subprocess runs from tmp_path; make the repo importable whether or
    # not the package is pip-installed (fresh sandboxes are not)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [
            sys.executable, "-m", "annonet_jax.cli.autotune",
            "--start", "8",
            str(tmp_path),
            "--mesh", "8",
            "--level-count", "0",
            "--net-width-scaler", "0.25",
            "--input-dimension-multiplier", "1.0",
            "--max-total-steps", "3",
            "--data-loader-thread-count", "1",
            "--output", str(tmp_path / "annonet.dnn"),
            "--sync-file", str(tmp_path / "sync.dat"),
        ],
        capture_output=True,
        text=True,
        timeout=900,
        cwd=str(tmp_path),
        env=env,
    )
    assert out.returncode == 0, out.stdout[-1500:] + out.stderr[-800:]
    assert "max working minibatch size:" in out.stdout
    assert (tmp_path / "annonet.dnn").exists()


def test_autotune_help_does_not_probe(capsys):
    """--help and no-args print usage instead of forwarding into probe
    subprocesses (every OTHER flag passes through to annonet_train)."""
    from annonet_jax.cli.autotune import main

    assert main(["--help"]) == 0
    out = capsys.readouterr().out
    assert "annonet_autotune" in out and "probing" not in out
    assert main([]) == 1
    out = capsys.readouterr().out
    assert "probing" not in out
