"""Device-mesh construction helpers."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def _set_virtual_device_flags(n_devices: int) -> None:
    """Point this process at ``n_devices`` virtual CPU devices. Must run
    before the JAX backend initializes: sets
    --xla_force_host_platform_device_count and forces the cpu platform
    (through jax.config too, which holds even after jax was imported).
    """
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n_devices}"
        ).strip()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    try:
        # no-op if the backend is already initialized on another platform
        jax.config.update("jax_platforms", "cpu")
    except RuntimeError:
        pass


def ensure_virtual_devices(n_devices: int) -> bool:
    """Make at least ``n_devices`` JAX devices visible, virtualizing on CPU.

    Returns True if n_devices are now visible, False if the backend was
    already initialized with fewer. Used by the driver's dryrun_multichip
    and, behind ANNONET_VIRTUAL_MESH=1, by the train CLI's --mesh for
    multi-device testing on single-device hosts.
    """
    _set_virtual_device_flags(n_devices)
    return len(jax.devices()) >= n_devices


def initialize_distributed(
    coordinator: str,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_virtual_devices: Optional[int] = None,
):
    """Multi-host (DCN) bootstrap: ``jax.distributed.initialize`` for
    ``annonet_train --coordinator``.

    Must run before the JAX backend initializes. ``coordinator`` is
    ``"host:port"`` of process 0 (every process passes the same address,
    plus --num-processes/--process-id), or ``"auto"`` on clusters whose
    scheduler JAX's cluster auto-detection understands (e.g. SLURM).

    ``local_virtual_devices``: fake that many CPU devices in THIS process
    (testing aid — the multi-host analog of ensure_virtual_devices; the
    flag must be set before backend init, hence here).

    Failure-detection knobs (both env-tunable): the coordination-service
    heartbeat declares a silent peer dead after
    ANNONET_HEARTBEAT_TIMEOUT seconds (default 100, JAX's default)
    and ABORTS this process — the backstop bound when no collective
    raises first (cli.common.exit_on_peer_failure handles the raising
    path); ANNONET_SHUTDOWN_TIMEOUT (default 300) bounds the exit
    barrier a clean shutdown waits on.

    Returns (process_index, process_count).
    """
    import os

    if local_virtual_devices:
        _set_virtual_device_flags(local_virtual_devices)

    def _timeout_env(name: str, default: int) -> int:
        raw = os.environ.get(name, "")
        if not raw:
            return default
        try:
            value = int(raw)
        except ValueError:
            raise ValueError(
                f"{name}={raw!r} is not an integer number of seconds"
            ) from None
        if value <= 0:
            raise ValueError(f"{name}={raw!r} must be a positive integer")
        return value

    heartbeat = _timeout_env("ANNONET_HEARTBEAT_TIMEOUT", 100)
    shutdown = _timeout_env("ANNONET_SHUTDOWN_TIMEOUT", 300)
    try:
        # cross-process CPU collectives ride gloo/TCP; the option only
        # affects the CPU client, so it is harmless on GPUs (whose
        # collectives ride NCCL)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:  # noqa: BLE001 — unavailable on some jaxlib builds
        pass
    if coordinator == "auto":
        jax.distributed.initialize(
            heartbeat_timeout_seconds=heartbeat,
            shutdown_timeout_seconds=shutdown,
        )
    else:
        if num_processes is None or process_id is None:
            raise ValueError(
                "--coordinator host:port requires --num-processes and "
                "--process-id (or use --coordinator auto on a cluster "
                "whose scheduler JAX detects)"
            )
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
            heartbeat_timeout_seconds=heartbeat,
            shutdown_timeout_seconds=shutdown,
        )
    return jax.process_index(), jax.process_count()


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("batch",),
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build a Mesh over the first ``n_devices`` devices.

    Default is a 1-D "batch" (data-parallel) mesh — the natural axis for
    this workload (SURVEY.md §2.3: DP is THE parallelism axis; there is no
    attention/TP to shard). Multi-axis shapes are supported for forward
    compatibility (e.g. ("batch", "tiles")).
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"requested {n_devices} devices but only {len(devices)} available"
        )
    if shape is None:
        shape = (n_devices,) if len(axis_names) == 1 else None
    if shape is None or len(shape) != len(axis_names):
        raise ValueError("shape must match axis_names")
    if int(np.prod(shape)) != n_devices:
        raise ValueError(f"mesh shape {shape} does not use {n_devices} devices")
    mesh_devices = np.asarray(devices[:n_devices]).reshape(shape)
    return Mesh(mesh_devices, axis_names)
