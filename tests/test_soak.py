"""Short serve soak: concurrent load + hot reloads, RSS bounded.

Runs scripts/soak_serve.py against a REAL annonet_serve subprocess for
~25 s — the mechanical version of the reference's manual "run it and
watch" robustness check. Asserts zero request/reload errors under
concurrency with reloads in flight, and that the server's resident set
is flat in steady state (no per-request or per-reload leak).
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_soak_serve_short():
    env = dict(os.environ, ANNONET_PLATFORM="cpu")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [
            sys.executable, os.path.join(REPO, "scripts", "soak_serve.py"),
            "--duration", "25", "--threads", "3", "--reload-interval", "6",
            "--height", "64", "--width", "80", "--tile-max", "48",
        ],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["errors"] == 0, summary
    assert summary["requests"] >= 30, summary
    assert summary["reloads"] >= 2, summary
    # steady-state RSS: the second half of the run must not keep growing.
    # 48 MB of headroom absorbs allocator/arena jitter while still
    # catching a real per-request leak (~1000 requests in the window).
    assert summary["rss_tail_growth_mb"] < 48, summary
