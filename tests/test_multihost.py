"""Multi-host (multi-process) data-parallel training.

``annonet_train --coordinator`` spans the DP mesh over several processes
(jax.distributed; CPU cross-process collectives ride gloo/TCP in these
tests, ICI/DCN on real pods). The execution model is SPMD with host
replication: every process runs the identical host program — same
dataset, same seed, deterministic decision stream (--deterministic-data:
one decision thread, the other loaders prefetch decodes) — so replicated
inputs (pool contents, crop decisions, keys) are consistent by
construction, and the
2-process x 4-device run computes the same global batches as the
1-process x 8-device run. The reference has no distributed story at all
(SURVEY.md §2.3: single process, one GPU) — this is the accelerator
scale-out axis its trainer points at.

These tests spawn real subprocesses (each needs its own JAX runtime) and
compare the final model artifacts numerically.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from tests.test_end_to_end import write_synthetic_dataset

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(local_devices: int) -> dict:
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={local_devices}"
    )
    env["ANNONET_PLATFORM"] = "cpu"
    env["ANNONET_NO_COMPILATION_CACHE"] = "1"
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _train_cmd(data_dir, out_path, sync_path, extra=(), steps=6):
    return [
        sys.executable, "-m", "annonet_jax.cli.train",
        str(data_dir),
        "--max-total-steps", str(steps),
        "-b", "8",
        "--mesh", "8",
        "--level-count", "0",
        "--net-width-scaler", "0.5",
        "--input-dimension-multiplier", "1.0",
        "--initial-learning-rate", "0.02",
        # 2 loader threads + --deterministic-data: the decision stream is
        # pinned to (seed, dataset) while decode prefetch runs in parallel
        # (the multi-host arms force deterministic mode; the single-process
        # reference arm must opt in to draw the SAME stream)
        "--data-loader-thread-count", "2",
        "--deterministic-data",
        "--steps-per-dispatch", "2",
        "--loss-sync-interval", "2",
        "--seed", "0",
        "--save-interval", "1000",
        "--output", str(out_path),
        "--sync-file", str(sync_path),
        *extra,
    ]


def _run_pair(data, outs, syncs, steps=6, timeout=600, extra=()):
    """Launch a 2-process --coordinator training; returns (returncodes,
    logs)."""
    port = _free_port()
    procs = []
    for pid in range(2):
        cmd = _train_cmd(
            data, outs[pid], syncs[pid], steps=steps,
            extra=[
                "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", "2",
                "--process-id", str(pid),
                *extra,
            ],
        )
        procs.append(subprocess.Popen(
            cmd, env=_env(4), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [p.returncode for p in procs], logs


def _assert_artifacts_close(path_a, path_b):
    from annonet_jax import serialization

    p_a, cfg_a, json_a, factor_a = serialization.load_model(str(path_a))
    p_b, cfg_b, json_b, factor_b = serialization.load_model(str(path_b))
    assert cfg_a.to_dict() == cfg_b.to_dict()
    assert json_a == json_b and factor_a == factor_b
    flat_a = serialization.flatten_tree(p_a)
    flat_b = serialization.flatten_tree(p_b)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_allclose(
            flat_a[k], flat_b[k], rtol=2e-5, atol=1e-6,
            err_msg=f"artifacts diverged at {k}",
        )


@pytest.mark.slow
def test_two_process_training_matches_single_process(tmp_path):
    """2 processes x 4 devices == 1 process x 8 devices (same seed, same
    decision stream, sync-BN DP over the same global batch); process 0
    writes the artifact, process 1 does not."""
    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_dataset(data, n_images=3, size=40)

    # --- reference arm: one process, 8 virtual devices
    single_out = tmp_path / "single.dnn"
    r = subprocess.run(
        _train_cmd(data, single_out, tmp_path / "single_sync.dat"),
        env=_env(8), capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert single_out.exists()

    # --- multi-host arm: two processes, 4 virtual devices each
    outs = [tmp_path / "mh0.dnn", tmp_path / "mh1.dnn"]
    rcs, logs = _run_pair(
        data, outs,
        [tmp_path / "mh0_sync.dat", tmp_path / "mh1_sync.dat"],
    )
    assert rcs[0] == 0, logs[0]
    assert rcs[1] == 0, logs[1]
    assert "Multi-host training: process 0 of 2" in logs[0]
    # only process 0 writes the artifact and the sync file
    assert outs[0].exists()
    assert not outs[1].exists()
    assert (tmp_path / "mh0_sync.dat").exists()
    assert not (tmp_path / "mh1_sync.dat").exists()

    # --- numerical equivalence (up to collective reduction order)
    _assert_artifacts_close(single_out, outs[0])


@pytest.mark.slow
def test_multihost_resume_through_shared_sync_file(tmp_path):
    """Stop + resume through a SHARED --sync-file: every process resumes
    from the same state (production contract: same path on a shared
    filesystem), and the continued run matches a single-process run with
    the same stop/resume pattern."""
    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_dataset(data, n_images=3, size=40)

    # single-process arm with the same stop/resume pattern
    single_out = tmp_path / "single.dnn"
    single_sync = tmp_path / "single_sync.dat"
    for steps in (3, 6):
        r = subprocess.run(
            _train_cmd(data, single_out, single_sync, steps=steps),
            env=_env(8), capture_output=True, text=True, timeout=600,
        )
        assert r.returncode == 0, r.stdout + r.stderr

    # multi-host arm: BOTH ranks point at the same sync file
    outs = [tmp_path / "mh0.dnn", tmp_path / "mh1.dnn"]
    shared = tmp_path / "shared_sync.dat"
    rcs, logs = _run_pair(data, outs, [shared, shared], steps=3)
    assert rcs == [0, 0], logs
    assert shared.exists()
    rcs, logs = _run_pair(data, outs, [shared, shared], steps=6)
    assert rcs == [0, 0], logs
    for log in logs:
        assert "resumed from" in log and "at step 3" in log, log

    _assert_artifacts_close(single_out, outs[0])


@pytest.mark.slow
def test_multihost_resume_mismatch_fails(tmp_path):
    """Per-rank --sync-file paths leave rank 1 with no checkpoint (only
    process 0 writes one): a restart must fail the resume-consistency
    check on every rank instead of silently training from divergent
    states."""
    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_dataset(data, n_images=3, size=40)

    outs = [tmp_path / "mh0.dnn", tmp_path / "mh1.dnn"]
    syncs = [tmp_path / "mh0_sync.dat", tmp_path / "mh1_sync.dat"]
    rcs, logs = _run_pair(data, outs, syncs, steps=3)
    assert rcs == [0, 0], logs
    assert syncs[0].exists() and not syncs[1].exists()

    rcs, logs = _run_pair(data, outs, syncs, steps=6)
    assert rcs == [1, 1], logs
    for log in logs:
        assert "multi-host resume mismatch" in log, log


@pytest.mark.slow
def test_multihost_int8_training_and_validation(tmp_path):
    """Composition: --int8-training's dynamic activation scales are
    pmax'd over the mesh axis — across PROCESSES here — and
    --validation-directory runs on process 0 only. The int8-training run
    must still match the single-process mesh run."""
    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_dataset(data, n_images=3, size=40)

    single_out = tmp_path / "single.dnn"
    r = subprocess.run(
        _train_cmd(
            data, single_out, tmp_path / "single_sync.dat",
            extra=["--int8-training"],
        ),
        env=_env(8), capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout + r.stderr

    outs = [tmp_path / "mh0.dnn", tmp_path / "mh1.dnn"]
    rcs, logs = _run_pair(
        data, outs,
        [tmp_path / "mh0_sync.dat", tmp_path / "mh1_sync.dat"],
        extra=["--int8-training", "--validation-directory", str(data)],
    )
    assert rcs == [0, 0], logs
    assert "validation (step" in logs[0]       # process 0 validates...
    assert "validation (step" not in logs[1]   # ...process 1 does not
    _assert_artifacts_close(single_out, outs[0])


def test_autotune_refuses_coordinator(capsys):
    """Probe subprocesses would wait forever for peers that never probe;
    the autotuner rejects --coordinator (both spellings) with guidance."""
    from annonet_jax.cli.autotune import main

    rc = main(["/nonexistent", "--coordinator", "127.0.0.1:1"])
    assert rc == 2
    assert "single-host" in capsys.readouterr().err
    rc = main(["/nonexistent", "--coordinator=127.0.0.1:1"])
    assert rc == 2
    assert "single-host" in capsys.readouterr().err


def test_resume_state_vector_distinguishes_same_step_checkpoints(tmp_path):
    """(step, LR) can coincide across unrelated runs — the pre-check
    vector includes the weights fingerprint recorded at save time, and
    distinct sentinels for missing vs unreadable checkpoints."""
    from annonet_jax import serialization
    from annonet_jax.cli.train import _resume_state_vector
    from annonet_jax.models.segnet import SegNetConfig
    from annonet_jax.train.trainer import Trainer, TrainerConfig

    mc = SegNetConfig(
        class_count=2, level_count=0, base_width=4, compute_dtype="float32"
    )
    a, b = tmp_path / "a.dat", tmp_path / "b.dat"
    for seed, path in ((0, a), (1, b)):
        Trainer(
            mc, TrainerConfig(sync_file=str(path)), seed=seed
        ).save_sync_file()

    meta = serialization.load_trainer_meta(str(a))
    assert meta["step_count"] == 0
    assert len(meta["weights_fingerprint"]) == 64  # sha256 hex

    va, vb = _resume_state_vector(str(a)), _resume_state_vector(str(b))
    assert va.shape == vb.shape == (48,)
    assert np.array_equal(va[:16], vb[:16])  # same step + LR...
    assert not np.array_equal(va, vb)        # ...different weights

    missing = _resume_state_vector(str(tmp_path / "nope.dat"))
    (tmp_path / "junk.dat").write_bytes(b"not-an-npz")
    junk = _resume_state_vector(str(tmp_path / "junk.dat"))
    assert not np.array_equal(missing, va)
    assert not np.array_equal(junk, missing)


def test_coordinator_requires_mesh(tmp_path):
    """--coordinator without --mesh is a setup error (exit 1), before any
    distributed initialization is attempted."""
    from annonet_jax.cli.train import main

    (tmp_path / "anno_classes.json").write_text("")
    rc = main([
        str(tmp_path),
        "--coordinator", "127.0.0.1:1",
    ])
    assert rc == 1


def test_mesh_must_cover_global_devices():
    """make_cli_mesh(multiprocess=True) rejects a partial global mesh."""
    from annonet_jax.cli.common import make_cli_mesh

    with pytest.raises(ValueError, match="global device count"):
        make_cli_mesh(3, multiprocess=True)  # 8 virtual devices visible


# --------------------------------------------------------- failure injection

def _launch_pair_logged(tmp_path, data, outs, syncs, steps, prefix="rank"):
    """Launch the 2-process pair with per-rank LOG FILES (unbuffered child
    stdout) so the test can poll progress and inject failures."""
    port = _free_port()
    procs, log_paths = [], []
    for pid in range(2):
        cmd = _train_cmd(
            data, outs[pid], syncs[pid], steps=steps,
            extra=[
                "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", "2", "--process-id", str(pid),
            ],
        )
        env = _env(4)
        env["PYTHONUNBUFFERED"] = "1"
        log = tmp_path / f"{prefix}{pid}.log"
        handle = open(log, "w")
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=handle, stderr=subprocess.STDOUT, text=True,
        ))
        handle.close()  # the child holds its own fd
        log_paths.append(log)
    return procs, log_paths


def _wait_for_line(paths, needle, procs, timeout=240):
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(needle in p.read_text(errors="replace") for p in paths):
            return
        if any(p.poll() is not None for p in procs):
            raise AssertionError(
                f"a rank exited before '{needle}' appeared:\n"
                + "\n===\n".join(p.read_text(errors="replace") for p in paths)
            )
        time.sleep(0.5)
    raise AssertionError(
        f"'{needle}' did not appear within {timeout}s:\n"
        + "\n===\n".join(p.read_text(errors="replace") for p in paths)
    )


_PEER_DIAGNOSES = (
    # the CLI's classified report (cli.common.exit_on_peer_failure) ...
    "multi-host peer failure detected",
    # ... or the coordination-service heartbeat backstop's process abort
    "JAX distributed service detected fatal errors",
)


@pytest.mark.slow
def test_rank_death_mid_training_is_bounded_and_diagnosed(tmp_path):
    """Kill rank 1 mid-training: rank 0 must exit within a BOUNDED time
    (the gloo collective timeout raises ~30 s after peer death; the
    coordination heartbeat abort backstops at 100 s) with a non-zero code
    and an actionable peer-failure diagnosis — never a silent wedge.
    Restarting both ranks afterwards resumes from the shared sync file's
    last checkpoint."""
    import time

    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_dataset(data, n_images=3, size=40)
    outs = [tmp_path / "mh0.dnn", tmp_path / "mh1.dnn"]
    shared = tmp_path / "shared_sync.dat"

    # phase A: a clean short run writes the shared checkpoint
    rcs, logs = _run_pair(data, outs, [shared, shared], steps=3)
    assert rcs == [0, 0], logs
    assert shared.exists()

    # phase B: relaunch open-ended, kill rank 1 once both are training
    procs, log_paths = _launch_pair_logged(
        tmp_path, data, outs, [shared, shared], steps=5000,
    )
    try:
        _wait_for_line(log_paths, "Multi-host training: process", procs)
        time.sleep(3)  # let some steps/collectives get in flight
        procs[1].kill()
        t_kill = time.monotonic()
        procs[0].wait(timeout=240)  # BOUNDED: no indefinite gloo hang
        elapsed = time.monotonic() - t_kill
        assert procs[0].returncode != 0
        log0 = log_paths[0].read_text(errors="replace")
        assert any(d in log0 for d in _PEER_DIAGNOSES), (elapsed, log0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    # phase C: restart every rank -> resume from the shared checkpoint
    rcs, logs = _run_pair(data, outs, [shared, shared], steps=6)
    assert rcs == [0, 0], logs
    for log in logs:
        assert "resumed from" in log and "at step 3" in log, log


@pytest.mark.slow
def test_rank_death_mid_inference_is_bounded_and_diagnosed(tmp_path):
    """Kill rank 1 during multi-host batch inference: rank 0 must fail
    its merge all-gather within a bounded time with the peer-failure
    diagnosis instead of blocking forever."""
    import time

    from tests.test_multihost_infer import _infer_cmd, _write_model

    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_dataset(data, n_images=6, size=48, seed=5)
    model = tmp_path / "annonet.dnn"
    _write_model(model, (data / "anno_classes.json").read_text())

    port = _free_port()
    procs, log_paths = [], []
    for pid in range(2):
        cmd = _infer_cmd(
            data, model, tmp_path / f"report{pid}.json",
            extra=[
                "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", "2", "--process-id", str(pid),
            ],
        )
        env = _env(1)
        env["PYTHONUNBUFFERED"] = "1"
        log = tmp_path / f"irank{pid}.log"
        handle = open(log, "w")
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=handle, stderr=subprocess.STDOUT, text=True,
        ))
        handle.close()
        log_paths.append(log)
    try:
        _wait_for_line(
            [log_paths[1]], "Multi-host inference: process 1", [procs[1]],
        )
        procs[1].kill()
        t_kill = time.monotonic()
        procs[0].wait(timeout=240)
        elapsed = time.monotonic() - t_kill
        assert procs[0].returncode != 0
        log0 = log_paths[0].read_text(errors="replace")
        assert any(d in log0 for d in _PEER_DIAGNOSES), (elapsed, log0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.mark.slow
def test_coordinator_death_mid_training_is_bounded(tmp_path):
    """Kill rank 0 — the process hosting the coordination SERVICE and
    owning the artifact writes — mid-training: rank 1 must still exit
    within a bounded window (its collectives fail, or its heartbeats to
    the dead service abort it) with a non-zero code, never a silent
    wedge."""
    import time

    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_dataset(data, n_images=3, size=40)
    outs = [tmp_path / "mh0.dnn", tmp_path / "mh1.dnn"]
    shared = tmp_path / "shared_sync.dat"

    procs, log_paths = _launch_pair_logged(
        tmp_path, data, outs, [shared, shared], steps=5000,
    )
    try:
        _wait_for_line(log_paths, "Multi-host training: process", procs)
        time.sleep(3)
        procs[0].kill()
        t_kill = time.monotonic()
        procs[1].wait(timeout=240)
        elapsed = time.monotonic() - t_kill
        assert procs[1].returncode != 0
        log1 = log_paths[1].read_text(errors="replace")
        assert any(
            d in log1 for d in (*_PEER_DIAGNOSES, "coordinator")
        ), (elapsed, log1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def test_peer_failure_classifier_measured_phrases_only():
    """peer_failure_diagnosis classifies the MEASURED collective/
    coordination error catalog — and nothing broader. A rank-local error
    whose text merely contains a generic transport string (NFS reset,
    HTTP connection refused) must NOT be diagnosed as a dead peer: that
    would os._exit past the rank-local abort path that deliberately
    unblocks peers (advisor finding, round 4)."""
    from annonet_jax.cli.common import peer_failure_diagnosis

    classified = [
        # the measured mid-training survivor error
        "Gloo context initialization failed: DEADLINE_EXCEEDED: "
        "GetKeyValue() timed out",
        # coordination-service heartbeat verdict
        "Task /job:jax_worker/task:1 heartbeat timeout",
        "coordination service reported an error",
        "Barrier failed at annonet_train exit",
        # gloo TCP pair severed mid-collective
        "read: Connection closed by peer 127.0.0.1:12345",
        "Gloo connectFullMesh failed with ...",
    ]
    for text in classified:
        assert peer_failure_diagnosis(RuntimeError(text)) is not None, text

    rank_local = [
        # data-loader I/O against a network filesystem
        "OSError: [Errno 104] Connection reset by peer: "
        "'/mnt/nfs/data/img_0001.png'",
        # a misconfigured metrics sink
        "ConnectionRefusedError: [Errno 111] Connection refused",
        # an unrelated timeout that merely says DEADLINE_EXCEEDED
        "DEADLINE_EXCEEDED: rpc to storage backend timed out",
        "training diverged: loss is nan at step 7",
        "device probe failed: something",
    ]
    for text in rank_local:
        assert peer_failure_diagnosis(RuntimeError(text)) is None, text


def test_peer_failure_exit_code_is_one_value():
    """Every CLI handler exits classified peer failures with the SAME
    documented code (advisor finding: train's setup handler used 1 while
    its loop handlers used 2, so restart policy couldn't key off one
    value)."""
    import inspect

    from annonet_jax.cli import common

    assert common.PEER_FAILURE_EXIT_CODE == 3
    # no call site may override exit_code anymore
    import annonet_jax.cli.infer as infer_mod
    import annonet_jax.cli.train as train_mod

    for mod in (train_mod, infer_mod):
        src = inspect.getsource(mod)
        for line_no, line in enumerate(src.splitlines(), 1):
            if "exit_on_peer_failure(" in line and "def " not in line:
                # collect the full call text (may span lines)
                tail = "\n".join(src.splitlines()[line_no - 1:line_no + 6])
                call = tail.split(")")[0]
                assert "exit_code=" not in call, (mod.__name__, call)


@pytest.mark.slow
def test_supervised_recovery_drill_end_to_end(tmp_path):
    """The full recovery story, supervised:

      rank 1 dies mid-PLATEAU-DRIVEN training
        -> rank 0 exits bounded with the classified diagnosis and THE
           peer-failure exit code (3) an orchestrator keys restarts off
        -> the supervisor (this test) restarts BOTH ranks with the same
           command
        -> they resume from the shared sync file's checkpoint and run to
           the NATURAL min-LR stop
        -> the exported artifact clears the pinned parity pixel-accuracy
           floor

    Recovery wall-times are measured and printed (recorded in
    docs/RUNBOOK.md). Round 4 proved bounded *failure*; this proves
    *recovery*."""
    import json
    import time

    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_dataset(data, n_images=3, size=40)
    outs = [tmp_path / "r0.dnn", tmp_path / "r1.dnn"]
    shared = tmp_path / "shared_sync.dat"
    metrics = [tmp_path / "m0.jsonl", tmp_path / "m1.jsonl"]
    # plateau config: lr 0.02, window 20 (-t 0.01). Phase 1 uses a min LR
    # it can never reach (the run must still be training when the kill
    # lands); the RESTARTED phase uses min LR 2.5e-3 -> ONE shrink
    # (0.02 -> 2e-3 < 2.5e-3) then the natural stop. The 500-step cap is
    # a safety net the restarted run must NOT hit.
    phase_min_lr = ["1e-12"]
    drill_extra = lambda pid: [  # noqa: E731
        "--min-learning-rate", phase_min_lr[0],
        "-t", "0.01",
        "--metrics-jsonl", str(metrics[pid]),
    ]

    def launch():
        port = _free_port()
        procs, logs = [], []
        for pid in range(2):
            cmd = _train_cmd(
                data, outs[pid], shared, steps=500,
                extra=[
                    "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", "2", "--process-id", str(pid),
                    *drill_extra(pid),
                ],
            )
            env = _env(4)
            env["PYTHONUNBUFFERED"] = "1"
            # tight checkpoint period so the kill happens with a genuine
            # MID-RUN checkpoint on disk (the reference period is 10 min,
            # annonet_train_main.cpp:403 — far longer than this test)
            env["ANNONET_SYNC_INTERVAL_SECONDS"] = "2"
            log = tmp_path / f"drill{pid}_{port}.log"
            handle = open(log, "w")
            procs.append(subprocess.Popen(
                cmd, env=env, stdout=handle, stderr=subprocess.STDOUT,
                text=True,
            ))
            handle.close()
            logs.append(log)
        return procs, logs

    # --- phase 1: launch, wait for a MID-RUN checkpoint, kill rank 1
    procs, logs = launch()
    try:
        _wait_for_line(logs, "Now training", procs)
        deadline = time.monotonic() + 120
        while not shared.exists() and time.monotonic() < deadline:
            assert all(p.poll() is None for p in procs), [
                log.read_text(errors="replace") for log in logs
            ]
            time.sleep(0.5)
        time.sleep(1)  # past the atomic replace; more steps in flight
        procs[1].kill()
        t_kill = time.monotonic()
        procs[0].wait(timeout=240)
        t_diagnosis = time.monotonic() - t_kill
        log0 = logs[0].read_text(errors="replace")
        assert procs[0].returncode != 0
        # the ONE documented restart-policy key: exit code 3 (classified
        # peer failure, cli/common.py::PEER_FAILURE_EXIT_CODE) — unless
        # the coordination service's async abort won the race (rc 1 +
        # its own fatal-error line), which the backstop also bounds
        classified = procs[0].returncode == 3
        assert classified or (
            "JAX distributed service detected fatal errors" in log0
        ), (procs[0].returncode, log0[-2000:])
        if classified:
            assert "multi-host peer failure detected" in log0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert shared.exists(), "no sync checkpoint was written before the kill"

    # --- phase 2: supervisor restarts BOTH ranks; resume + natural stop
    phase_min_lr[0] = "2.5e-3"
    t_restart = time.monotonic()
    procs, logs = launch()
    try:
        for p in procs:
            p.wait(timeout=600)
        t_complete = time.monotonic() - t_restart
        rcs = [p.returncode for p in procs]
        texts = [log.read_text(errors="replace") for log in logs]
        assert rcs == [0, 0], texts
        for text in texts:
            assert "resumed from" in text
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    # natural min-LR stop, not the 500-step safety cap
    events = [
        json.loads(line)
        for line in metrics[0].read_text().splitlines()
    ]
    done = [e for e in events if e["event"] == "done"][-1]
    assert done["steps"] < 500, done
    shrinks = [e for e in events if e["event"] == "learning_rate_shrink"]
    assert shrinks and shrinks[-1]["learning_rate"] < 2.5e-3, shrinks

    # --- phase 3: the recovered artifact clears the parity floor
    import io
    from contextlib import redirect_stdout

    from annonet_jax.cli.infer import main as infer_main

    report = tmp_path / "report.json"
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = infer_main([
            str(data), "--model", str(outs[0]),
            "--report-json", str(report),
        ])
    assert rc == 0, buf.getvalue()
    rep = json.loads(report.read_text())
    accuracy = rep["confusion_per_pixel"]["accuracy"]
    floors = json.loads(
        (pathlib.Path(REPO_ROOT) / "PARITY_TARGETS.json").read_text()
    )
    floor = floors["pinned_pixel_accuracy_floor"]
    assert accuracy >= floor, (accuracy, floor)

    print(
        "recovery drill: diagnosis "
        f"{t_diagnosis:.1f}s after kill (rc={3 if classified else 'abort'}),"
        f" restart->natural-stop {t_complete:.1f}s at step {done['steps']}, "
        f"artifact accuracy {accuracy:.4f} (floor {floor})"
    )
