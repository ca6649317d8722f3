"""device_probe: bounded first-device-op check (cli/common.py).

A wedged device runtime makes the first real device op block forever —
minutes into startup, looking exactly like a framework hang. The probe
bounds one upload -> compute -> readback and fails fast with triage
text. These tests pin the three outcomes (ok / timeout / device error),
the env-var off switch, and that every device-driving entry point
actually calls it before its first real device work."""

import inspect
import time

import pytest

from annonet_jax.cli.common import device_probe


def test_probe_passes_on_live_backend():
    t0 = time.monotonic()
    device_probe(timeout_s=60.0)
    assert time.monotonic() - t0 < 30.0


def test_probe_timeout_raises_with_triage_text():
    with pytest.raises(RuntimeError, match="did not complete within 0.2"):
        device_probe(
            timeout_s=0.2, _op=lambda: time.sleep(5.0), on_timeout="raise"
        )
    # the probe thread is a daemon: the failed call must not block exit
    # (nothing to assert beyond returning promptly, which the raise did)


def test_probe_timeout_default_mode_exits_1():
    """The CLI default (on_timeout="exit") must terminate the process
    with exit code 1 and the triage message — os._exit, because normal
    interpreter teardown under a thread abandoned inside backend-init
    Python frames segfaults (observed: exit 139 on the real CLI)."""
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-c",
         "import time\n"
         "from annonet_jax.cli.common import device_probe\n"
         "device_probe(timeout_s=0.2, _op=lambda: time.sleep(60))\n"
         "raise SystemExit(99)  # must be unreachable\n"],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1, (proc.returncode, proc.stderr)
    assert "did not complete within 0.2" in proc.stdout


def test_probe_error_propagates():
    def boom():
        raise ValueError("backend exploded")

    with pytest.raises(RuntimeError, match="backend exploded"):
        device_probe(timeout_s=5.0, _op=boom)


def test_probe_env_zero_disables(monkeypatch):
    monkeypatch.setenv("ANNONET_DEVICE_PROBE_TIMEOUT", "0")

    def must_not_run():
        raise AssertionError("probe ran while disabled")

    device_probe(_op=must_not_run)  # returns without touching _op


def test_probe_env_sets_default_timeout(monkeypatch):
    monkeypatch.setenv("ANNONET_DEVICE_PROBE_TIMEOUT", "0.1")
    with pytest.raises(RuntimeError, match="within 0.1"):
        device_probe(_op=lambda: time.sleep(5.0), on_timeout="raise")


def test_every_device_entry_point_probes():
    """train/infer's _run_impl and serve's main must call device_probe
    after device selection, before real device work (same style as the
    platform-pin wiring test in test_cli.py)."""
    from annonet_jax.cli import infer, serve, train

    for fn in (train._run_impl, infer._run_impl, serve.main):
        src = inspect.getsource(fn)
        assert "device_probe(" in src, fn.__qualname__
        # the probe must target the --device selection (thread-local
        # default_device does not reach the probe thread otherwise)
        assert "device_index=args.device" in src, fn.__qualname__
        # ...and must run BEFORE anything else initializes the backend
        # (select_device's jax.devices(), mesh construction)
        assert src.index("device_probe(") < src.index("make_cli_mesh("), (
            fn.__qualname__
        )
        assert src.index("device_probe(") < src.index("select_device(args"), (
            fn.__qualname__
        )
