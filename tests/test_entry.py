"""The entry points of __graft_entry__ must keep working — a multichip
check once failed solely because __graft_entry__ never bootstrapped a
virtual mesh. Exercise both entries under the conftest 8-CPU mesh
AND in a pristine subprocess with no pre-set env, which is exactly how
the driver invokes them.
"""

import os
import subprocess
import sys

import jax
import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

import __graft_entry__  # noqa: E402


def test_entry_compiles_and_runs():
    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    out = jax.block_until_ready(out)
    assert np.all(np.isfinite(np.asarray(out, dtype=np.float32)))


def test_dryrun_multichip_in_process():
    # conftest already forces the 8-device CPU mesh, so this runs the
    # in-process path
    __graft_entry__.dryrun_multichip(8)


def test_dryrun_multichip_fresh_subprocess():
    """Simulate the driver: fresh python, no XLA_FLAGS/JAX_PLATFORMS set."""
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "_ANNONET_DRYRUN_REEXEC")
    }
    result = subprocess.run(
        [
            sys.executable,
            "-c",
            "import __graft_entry__; __graft_entry__.dryrun_multichip(8)",
        ],
        cwd=REPO_ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert result.returncode == 0, result.stderr[-2000:]
    assert "8-device DP step OK" in result.stdout
