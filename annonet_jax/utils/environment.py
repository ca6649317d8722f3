"""The ANNONET_* environment variables this package reads.

A misspelt or outdated variable would otherwise be ignored without a
word, and the program would run with a behaviour the user did not ask
for. ``check_environment`` (run when the package is imported) refuses any
set ANNONET_* variable that is not listed here, and names the variable it
most likely meant.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

PREFIX = "ANNONET_"

KNOWN = frozenset({
    "ANNONET_AUTOTUNE_ITERS",
    "ANNONET_BLEND_STRIPS",
    "ANNONET_COMPILER_OPTIONS",
    "ANNONET_DEVICE_PROBE_ON_TIMEOUT",
    "ANNONET_DEVICE_PROBE_TIMEOUT",
    "ANNONET_DRYRUN_REEXEC",
    "ANNONET_GATHER_ORDER",
    "ANNONET_HEAD_DOT",
    "ANNONET_HEARTBEAT_TIMEOUT",
    "ANNONET_NO_ARGMAX_FOLD",
    "ANNONET_NO_COMPILATION_CACHE",
    "ANNONET_NO_NATIVE",
    "ANNONET_PLATFORM",
    "ANNONET_SHUTDOWN_TIMEOUT",
    "ANNONET_STEM_YCAT",
    "ANNONET_STEP_TIMING",
    "ANNONET_SYNC_INTERVAL_SECONDS",
    "ANNONET_TEST_GPU",
    "ANNONET_VIRTUAL_MESH",
})

# variables that are no longer read, with what to do instead
REMOVED = {
    "ANNONET_COMPILATION_CACHE": (
        "set JAX_COMPILATION_CACHE_DIR to choose the compile cache's "
        "directory"
    ),
}


def suggestion(name: str) -> Optional[str]:
    """The known variable that ``name`` most likely meant: one that ends
    like it after the prefix (a name with an extra word), else the
    closest spelling."""
    import difflib

    rest = name[len(PREFIX):]
    for known in sorted(KNOWN):
        if rest.endswith("_" + known[len(PREFIX):]):
            return known
    close = difflib.get_close_matches(name, sorted(KNOWN), n=1, cutoff=0.8)
    return close[0] if close else None


def check_environment(environ: Optional[Mapping[str, str]] = None) -> None:
    """Raise RuntimeError naming every set ANNONET_* variable this package
    does not read, with the replacement for each."""
    environ = os.environ if environ is None else environ
    problems = []
    for name in sorted(environ):
        if not name.startswith(PREFIX) or name in KNOWN:
            continue
        if name in REMOVED:
            problems.append(f"{name} is no longer read: {REMOVED[name]}")
            continue
        hint = suggestion(name)
        problems.append(
            f"{name} is not read by annonet_jax"
            + (f"; the variable for this is {hint}" if hint else "")
        )
    if problems:
        raise RuntimeError(
            "unknown environment variables (unset them or use the names "
            "in docs/MIGRATION.md): " + "; ".join(problems)
        )
