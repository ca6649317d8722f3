"""Short training soak: a real annonet_train subprocess, RSS bounded.

Runs scripts/soak_train.py for a few hundred steps on CPU — the
trainer-side sibling of tests/test_soak.py. Asserts the run completes,
actually trains (loss drops), the step rate does not decay, and the
resident set is flat in steady state (the device pool, superstep
buffers, LRU cache and metrics writer are all bounded by design).
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_soak_train_short():
    env = dict(os.environ, ANNONET_PLATFORM="cpu")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [
            sys.executable, os.path.join(REPO, "scripts", "soak_train.py"),
            "--steps", "400", "--batch", "16", "--image-size", "80",
            "--metrics-interval", "20",
        ],
        capture_output=True, text=True, timeout=1200, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["rc"] == 0, summary
    assert summary["steps"] == 400, summary
    # trivially separable data: the loss must have moved well below its
    # start by step 400 (the e2e round-trip tests pin accuracy; this
    # just catches "soaked but silently not training")
    assert summary["final_loss"] < summary["first_loss"], summary
    # steady state: cumulative steps/s must not decay from mid to end
    # (a slowly poisoned dispatch path shows up here), and the resident
    # set must be flat in the tail. 25% rate and 64 MB RSS headroom
    # absorb host jitter while catching real per-step leaks.
    assert summary["sps_end"] >= 0.75 * summary["sps_mid"], summary
    assert summary["rss_tail_growth_mb"] < 64, summary
