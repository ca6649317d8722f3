"""The check of ANNONET_* environment variables (utils/environment.py):
a variable the package does not read is refused, with the name it most
likely meant, instead of being ignored."""

import pathlib
import re
import subprocess
import sys

import pytest

from annonet_jax.utils.environment import (
    KNOWN,
    REMOVED,
    check_environment,
    suggestion,
)

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_known_variables_pass():
    check_environment({**{name: "1" for name in KNOWN}, "HOME": "/nowhere"})


@pytest.mark.parametrize(
    "name, meant",
    [
        # a name with one word too many before the known part
        ("ANNONET_OLD_PLATFORM", "ANNONET_PLATFORM"),
        ("ANNONET_OLD_NO_COMPILATION_CACHE", "ANNONET_NO_COMPILATION_CACHE"),
        # a misspelling
        ("ANNONET_PLATFORMS", "ANNONET_PLATFORM"),
        ("ANNONET_NO_NATVE", "ANNONET_NO_NATIVE"),
    ],
)
def test_unknown_variable_is_refused_with_its_replacement(name, meant):
    assert suggestion(name) == meant
    with pytest.raises(RuntimeError, match=f"{name} is not read.*{meant}"):
        check_environment({name: "1"})


def test_removed_variable_says_what_to_do_instead():
    for name, advice in REMOVED.items():
        with pytest.raises(RuntimeError, match=re.escape(advice)):
            check_environment({name: "/somewhere"})


def test_unrelated_variables_are_ignored():
    check_environment({"JAX_PLATFORMS": "cpu", "ANNONETX": "1"})


def test_every_variable_the_code_reads_is_known():
    """Each ANNONET_* name the program's sources mention is either read
    (KNOWN) or named as removed (REMOVED)."""
    sources = [
        *(REPO / "annonet_jax").rglob("*.py"),
        *(REPO / "scripts").glob("*.py"),
        REPO / "bench.py", REPO / "chip_smoke.py",
        REPO / "__graft_entry__.py",
    ]
    names = set()
    for path in sources:
        names |= set(re.findall(r"\bANNONET_[A-Z0-9_]*[A-Z0-9]",
                                path.read_text()))
    assert names, "no variable found: the scan is broken"
    assert names <= KNOWN | set(REMOVED)


def test_importing_the_package_refuses_an_unknown_variable():
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "ANNONET_OLD_PLATFORM": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-c", "import annonet_jax"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "ANNONET_PLATFORM" in proc.stderr
