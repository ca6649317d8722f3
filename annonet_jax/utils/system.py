"""Process-level politeness.

The reference lowers its own priority so long trainings don't starve the
workstation (set_low_priority, annonet.cpp:178-187 — implemented there for
Windows only, called from both mains). Here the POSIX side is covered too.
"""

from __future__ import annotations

import os
import sys


def set_low_priority() -> None:
    """Drop process priority; silently a no-op where unsupported."""
    try:
        if hasattr(os, "nice"):
            os.nice(10)
        elif sys.platform == "win32":  # pragma: no cover
            import ctypes

            BELOW_NORMAL_PRIORITY_CLASS = 0x4000
            handle = ctypes.windll.kernel32.GetCurrentProcess()
            ctypes.windll.kernel32.SetPriorityClass(
                handle, BELOW_NORMAL_PRIORITY_CLASS
            )
    except OSError:  # pragma: no cover
        pass


def gpu_name_and_power_limit() -> str:
    """Each card's name and power limit as nvidia-smi reports them
    (``--query-gpu=name,power.limit --format=csv,noheader``), one line per
    card. A card set below its maximum power runs slower under load, so
    every timing is reported beside this line. Raises RuntimeError when
    nvidia-smi is missing or fails."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"nvidia-smi failed: {e}") from e
    if not out:
        raise RuntimeError("nvidia-smi reported no GPU")
    return out
