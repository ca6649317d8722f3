"""Shared CLI helpers: class-specific value parsing, device selection."""

from __future__ import annotations

from typing import List, Sequence


def parse_class_specific_value(string_from_command_line: str):
    """Parse one "index:value" item.

    Parity with parse_class_specific_value (annonet_infer_main.cpp:36-46),
    including the error message.
    """
    colon_pos = string_from_command_line.find(":")
    if colon_pos < 1 or colon_pos >= len(string_from_command_line) - 1:
        raise ValueError(
            "The gains must be supplied in the format index:gain (e.g., 1:-0.5)"
        )
    return (
        int(string_from_command_line[:colon_pos]),
        float(string_from_command_line[colon_pos + 1 :]),
    )


def parse_class_specific_values(
    strings_from_command_line: Sequence[str],
    class_count: int,
    require_non_negative: bool = False,
) -> List[float]:
    """Expand repeated "index:value" flags into a dense per-class vector.

    Parity with parse_class_specific_values (annonet_infer_main.cpp:49-63).
    require_non_negative enforces the reference's detection-level contract
    (annonet_infer.cpp:189 asserts value >= 0.0; a negative level would
    flip the seed inequality silently).
    """
    values = [0.0] * class_count
    for item in strings_from_command_line:
        index, value = parse_class_specific_value(item)
        if index >= class_count:
            raise ValueError(
                f"Can't define class-specific value for index {index} "
                f"when there are only {class_count} classes"
            )
        if require_non_negative and value < 0.0:
            raise ValueError(
                f"Class-specific value for index {index} must be "
                f"non-negative (got {value:g})"
            )
        values[index] = value
    return values


class IndexOrderedResults:
    """Reorder (index, item) pairs from a queue into 0,1,2,... order.

    Reader threads complete out of order; inference must still process
    images in find_image_files order (the reference's sequential loop,
    annonet_infer_main.cpp:440-494) so result ordering and the
    "excluding the first image" timing are deterministic. The buffer is
    bounded only if the PRODUCERS bound their read-ahead (cli/infer.py's
    read_ahead semaphore): without that, one slow in-order item would let
    the other readers race ahead and this buffer would absorb them all.
    """

    def __init__(self, results_queue):
        self._queue = results_queue
        self._pending = {}
        self._next = 0

    def next(self):
        while self._next not in self._pending:
            index, item = self._queue.get()
            self._pending[index] = item
        item = self._pending.pop(self._next)
        self._next += 1
        return item


def apply_platform_env() -> None:
    """Honor ANNONET_PLATFORM=cpu|cuda|... before backend init.

    A per-tool override of JAX's platform choice, applied through
    jax.config so it holds even when jax was imported first. Both CLIs
    call this first; it must run before anything initializes the JAX
    backend."""
    import os

    platform = os.environ.get("ANNONET_PLATFORM")
    if platform:
        import jax

        jax.config.update("jax_platforms", platform)


def default_tile_max() -> int:
    """The auto (-w/-h unset) max-tile dimension.

    Canonical definition lives with the tile planner
    (annonet_jax.infer.tiling.default_tile_max) so TiledInferer's own
    no-tiling default uses it too; this alias keeps the CLI-layer import
    path.
    """
    from annonet_jax.infer.tiling import default_tile_max as _impl

    return _impl()


def select_device(device_index):
    """--device N -> make jax device N the default (the analog of
    --primary-cuda-device -> dlib::cuda::set_device,
    annonet_train_main.cpp:392-394). Returns the context manager."""
    import jax

    devices = jax.devices()
    if device_index < 0 or device_index >= len(devices):
        raise ValueError(
            f"device index {device_index} out of range; "
            f"{len(devices)} device(s) available"
        )
    return jax.default_device(devices[device_index])


def device_probe(timeout_s=None, _op=None, on_timeout=None,
                 device_index=None):
    """Bounded first-device-op probe: fail fast, with an actionable
    message, when the accelerator runtime is unreachable or wedged.

    Without it, a broken device runtime makes an entry point's FIRST real
    device op fail late or block: backend init can stall in the PJRT
    client setup (a driver fault, a card another process holds), or the
    first host<->device transfer can fail to complete. Both look like a
    hang in this framework's own code, minutes into startup. So the CLIs
    and the server probe the device up front: one tiny upload -> compute
    -> readback on a daemon thread, bounded by ``timeout_s``.

    BACKEND INIT HAPPENS INSIDE THE PROBE THREAD: the CLIs call this
    BEFORE anything else touches jax (select_device's jax.devices(),
    mesh construction), so a hang in PJRT client init itself is bounded
    too — not just the first transfer. ``device_index`` targets the
    probe at the device ``--device N`` will select (jax.default_device
    is a thread-local context, so the caller's selection would NOT apply
    to the probe thread; an out-of-range index is ignored here so
    select_device can raise its canonical error afterward).

    Cost: one scalar round trip (milliseconds; the tiny program is
    compile-cached). ANNONET_DEVICE_PROBE_TIMEOUT overrides the
    default 120 s; 0 disables the probe. ``_op`` is a test seam.

    ``on_timeout="exit"`` (the CLI default) prints the triage message and
    ``os._exit(1)``s: the timed-out probe thread is abandoned inside
    backend-init/transfer code that includes PYTHON frames (e.g. the
    PJRT client-init retry loop), and normal interpreter finalization
    under such a thread segfaults — exiting without teardown is the only
    clean report. ``on_timeout="raise"`` raises RuntimeError instead.
    Library embedders calling the CLI mains in-process can force the
    exception contract with ANNONET_DEVICE_PROBE_ON_TIMEOUT=raise
    (accepting the teardown hazard at their own process exit).
    """
    import os
    import threading

    if timeout_s is None:
        timeout_s = float(
            os.environ.get("ANNONET_DEVICE_PROBE_TIMEOUT", "120")
        )
    if on_timeout is None:
        on_timeout = os.environ.get(
            "ANNONET_DEVICE_PROBE_ON_TIMEOUT", "exit"
        )
    if timeout_s <= 0:
        return
    if _op is None:
        # Import on THIS thread: imports never hang (no network/device
        # I/O) — only backend init and transfers do. The probe thread
        # must not be abandoned mid-import: interpreter finalization
        # under an importing daemon thread segfaults at exit, whereas a
        # thread parked in a GIL-released C call (the hang being
        # detected) tears down cleanly.
        import contextlib

        import jax
        import jax.numpy as jnp

        def _op():
            # jax.devices() initializes the backend — inside the bounded
            # thread, so a stuck PJRT client init is caught too
            devices = jax.devices()
            ctx = contextlib.nullcontext()
            if device_index is not None and 0 <= device_index < len(devices):
                ctx = jax.default_device(devices[device_index])
            with ctx:
                value = float(jnp.full((8, 8), 3.0, jnp.float32).sum())
            if value != 192.0:
                raise RuntimeError(f"device computed {value}, expected 192.0")

    result = {}

    def run():
        try:
            _op()
            result["ok"] = True
        except Exception as e:  # noqa: BLE001 — reported on the main thread
            result["error"] = e

    thread = threading.Thread(
        target=run, daemon=True, name="annonet-device-probe"
    )
    thread.start()
    thread.join(timeout_s)
    if thread.is_alive():
        # Do NOT touch jax from this thread here: if init itself is what
        # stalled, any backend query would hang the error path too.
        message = (
            f"device probe did not complete within {timeout_s:g} s: the "
            "accelerator runtime is unreachable or wedged (backend init "
            "or the first host<->device transfer stalled). Triage: check "
            "the driver (nvidia-smi), look for leftover processes holding "
            "the accelerator, or retry once it recovers. "
            "ANNONET_DEVICE_PROBE_TIMEOUT adjusts this timeout (0 "
            "disables the probe)."
        )
        if on_timeout == "raise":
            raise RuntimeError(message)
        import sys

        print(message, flush=True)
        sys.stderr.flush()
        os._exit(1)
    if "error" in result:
        raise RuntimeError(
            f"device probe failed: {result['error']}"
        ) from result["error"]


# Substrings that identify a failed PEER (a rank that died, was preempted,
# or became unreachable) in the errors the distributed runtime raises into
# this process: gloo collective/context failures (CPU cross-process
# collectives time out after ~30 s), coordination-service barrier and
# heartbeat verdicts (multi-host clusters). Measured catalog: killing a rank
# mid-training raises "Gloo context initialization failed:
# DEADLINE_EXCEEDED: GetKeyValue() timed out" on the survivor ~30 s later,
# and the coordination service independently declares "Task .../task:N
# heartbeat timeout" at heartbeat_timeout_seconds (default 100).
#
# Every marker names the COLLECTIVE/COORDINATION runtime specifically —
# generic transport strings (bare "gloo", "connection reset/refused",
# "deadline_exceeded") were removed after review: a rank-LOCAL error whose
# text merely contains one (a network-filesystem read error, a
# misconfigured coordinator address timing out at init) would be
# misdiagnosed as a dead peer and os._exit, bypassing the rank-local abort
# path that deliberately unblocks peers. Misses are backstopped by the
# coordination service's own heartbeat abort ("JAX distributed service
# detected fatal errors", default 100 s) — the failure stays bounded
# either way, only the diagnosis line differs.
_PEER_FAILURE_MARKERS = (
    "gloo context",          # "Gloo context initialization failed: ..."
    "connectfullmesh",       # gloo rendezvous with a vanished peer
    "closed by peer",        # gloo TCP pair severed mid-collective
    "heartbeat timeout",     # coordination-service verdict
    "coordination service",
    "barrier failed",
    "getkeyvalue",           # coordination KV timeouts inside collectives
)


def peer_failure_diagnosis(exc) -> "str | None":
    """Classify an exception as a multi-host PEER failure; returns the
    actionable diagnosis line, or None for unrelated errors."""
    text = str(exc).lower()
    if not any(marker in text for marker in _PEER_FAILURE_MARKERS):
        return None
    return (
        "multi-host peer failure detected: a peer process died, was "
        "preempted, or became unreachable (collective/coordination "
        "error above). This rank is exiting now; restart the job on "
        "EVERY host (training resumes from the shared --sync-file; "
        "batch inference simply reruns)."
    )


#: The ONE exit code for classified multi-host peer failures, in every
#: CLI and every handler (setup-phase collectives, the training loop, the
#: tail flush, inference merges). Distinct from the reference's setup (1)
#: and run-loop (2) contracts so orchestrators can key "restart ALL
#: hosts" off a single value instead of parsing logs (docs/RUNBOOK.md).
PEER_FAILURE_EXIT_CODE = 3


def exit_on_peer_failure(exc, multihost: bool,
                         exit_code: int = PEER_FAILURE_EXIT_CODE,
                         before_exit=None) -> None:
    """The multi-host analog of device_probe's wedge handling: when a
    collective raises because a PEER died, report and leave IMMEDIATELY.

    A classified peer failure must not return through normal unwinding:
    the coordination client has (or soon will) declare the job fatal and
    abort the process from a background thread (client.h "Terminating
    process because the JAX distributed service detected fatal errors"),
    and interpreter exit blocks in the distributed shutdown barrier until
    heartbeat timeout — measured: the survivor lingered 100 s and died by
    async abort with the CLI's own diagnosis lost in the race. Printing
    (flushed) and ``os._exit``ing wins that race: bounded (~30 s after
    peer death, the gloo collective timeout), diagnosable, and with the
    documented exit code. No-op when the error is not a peer failure.

    ``before_exit``: best-effort last-words hook (e.g. writing a final
    --metrics-jsonl error event) run after the diagnosis is printed;
    its own failure never blocks the exit.
    """
    if not multihost:
        return
    diagnosis = peer_failure_diagnosis(exc)
    if diagnosis is None:
        return
    import os
    import sys

    print(exc, flush=True)
    print(diagnosis, flush=True)
    if before_exit is not None:
        try:
            before_exit()
        except Exception:  # noqa: BLE001 — last words must not block exit
            pass
    sys.stderr.flush()
    os._exit(exit_code)


def default_compilation_cache_dir() -> str:
    """The compile cache's fixed home. In a checkout (the package sits
    beside pyproject.toml): ``.jax_cache`` in the checkout (listed in
    .gitignore). In an installed package: ``annonet_jax/jax`` in the
    user's cache directory, never inside site-packages. A fixed path,
    because the path is part of what makes a cached program found again."""
    import os

    package_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.dirname(package_dir)
    if os.path.isfile(os.path.join(root, "pyproject.toml")):
        return os.path.join(root, ".jax_cache")
    user_cache = (os.environ.get("XDG_CACHE_HOME")
                  or os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(user_cache, "annonet_jax", "jax")


def enable_compilation_cache() -> None:
    """Persistent XLA compilation cache for the CLI entry points.

    The reference's binaries start instantly; here the first image or
    minibatch pays an XLA compile per process, and JAX's persistent cache
    makes warm process starts skip it. Enabled by default in the CLIs:

    * JAX_COMPILATION_CACHE_DIR set: JAX reads it itself and this sets no
      directory;
    * otherwise the cache goes to default_compilation_cache_dir();
    * ANNONET_NO_COMPILATION_CACHE=1 or --no-compilation-cache turns the
      cache off, whichever directory it would use.
    """
    import os

    import jax

    if os.environ.get("ANNONET_NO_COMPILATION_CACHE") == "1":
        jax.config.update("jax_enable_compilation_cache", False)
        return
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    cache_dir = default_compilation_cache_dir()
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:  # a read-only install: the cache is an optimization
        return
    jax.config.update("jax_compilation_cache_dir", cache_dir)


def prepare_mesh_flags(n_devices: int) -> None:
    """Set --mesh's virtual-device XLA flags WITHOUT initializing the
    backend. Must run before device_probe (which performs the process's
    first backend init inside its bounded thread); make_cli_mesh can
    then build the mesh from the already-initialized backend. No-op
    unless ANNONET_VIRTUAL_MESH=1 (production --mesh uses the real
    devices)."""
    import os

    if os.environ.get("ANNONET_VIRTUAL_MESH") == "1":
        from annonet_jax.parallel.mesh import _set_virtual_device_flags

        _set_virtual_device_flags(n_devices)


def make_cli_mesh(n_devices: int, multiprocess: bool = False):
    """--mesh N -> a jax.sharding.Mesh, shared by both CLIs.

    Behind ANNONET_VIRTUAL_MESH=1, fakes an N-device CPU mesh on
    single-device hosts (testing aid; explicit opt-in so a production
    --mesh run is never silently moved to CPU). MUST be called before
    anything initializes the JAX backend (e.g. select_device), or the
    virtual-device flags come too late.

    ``multiprocess``: the caller already ran initialize_distributed
    (--coordinator); N must then equal the GLOBAL device count — every
    device of every process joins the data-parallel mesh (a partial
    global mesh would leave some processes with no devices to drive).
    """
    import os

    from annonet_jax.parallel.mesh import ensure_virtual_devices, make_mesh

    if multiprocess:
        import jax

        total = len(jax.devices())
        if n_devices != total:
            raise ValueError(
                f"--mesh {n_devices} must equal the global device count "
                f"({total}) when training multi-process (--coordinator): "
                f"every device of every process joins the mesh"
            )
        return make_mesh(n_devices)
    if os.environ.get("ANNONET_VIRTUAL_MESH") == "1":
        ensure_virtual_devices(n_devices)
    return make_mesh(n_devices)
