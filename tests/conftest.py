"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Per SURVEY.md §4, multi-device (data-parallel) logic is tested on a fake CPU
mesh via --xla_force_host_platform_device_count so the full sharding path
runs without accelerator hardware. This must happen before jax is imported.

Tests marked ``gpu`` need the card. They take the ``gpu_device`` fixture,
which skips them on CPU; on a machine with the card run them with
``ANNONET_TEST_GPU=1 python -m pytest -m gpu tests/``, which leaves JAX's
platform choice alone.
"""

import os
import sys

import pytest

_ON_GPU = os.environ.get("ANNONET_TEST_GPU") == "1"
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
# In-process CLI tests must not persist XLA programs into a compile cache
# that outlives the pytest session.
os.environ["ANNONET_NO_COMPILATION_CACHE"] = "1"
_flags = os.environ.get("XLA_FLAGS", "")
if not _ON_GPU and "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Make the repo root importable regardless of where pytest is invoked from.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: slower end-to-end tests")
    config.addinivalue_line(
        "markers", "gpu: needs the GPU; skips elsewhere (gpu_device fixture)"
    )


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {device.platform}")
    return device
