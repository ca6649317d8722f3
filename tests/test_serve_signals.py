"""annonet_serve process lifecycle: SIGTERM drains and exits 0.

The production stop signal must not kill in-flight work or return a
dirty exit code (the reference's batch CLIs have no long-lived process;
this is serving-stack hardening, docs/SERVING.md).
"""

import os
import signal
import subprocess
import sys
import time

import pytest

import jax

from annonet_jax import serialization
from annonet_jax.classes import anno_classes_to_json, default_anno_classes
from annonet_jax.models.segnet import SegNetConfig, fold_batchnorm, init_state

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sigterm_graceful_exit(tmp_path):
    model_path = str(tmp_path / "annonet.dnn")
    config = SegNetConfig(class_count=3, level_count=0, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    serialization.save_model(
        model_path, runtime, config,
        anno_classes_to_json(default_anno_classes()), 1.0,
    )
    env = dict(os.environ, ANNONET_PLATFORM="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "annonet_jax.cli.serve",
         "--model", model_path, "--port", "0",
         "--tile-max-width", "64", "--tile-max-height", "64"],
        env=env, cwd=_REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.monotonic() + 240
        lines = []
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "listening on" in line:
                break
        else:
            pytest.fail(f"server never came up: {''.join(lines)}")
        assert any("listening on" in ln for ln in lines), "".join(lines)

        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "SIGTERM" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
