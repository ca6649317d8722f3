"""annonet_serve soak: sustained concurrent load + periodic hot reloads.

Robustness probe for the production serving surface (docs/SERVING.md):
spawns a REAL `annonet_serve` subprocess, hammers it with N concurrent
jax-free ServeClient threads (zero-codec raw /infer), hot-reloads the
artifact every few seconds while requests are in flight, and samples the
server's VmRSS throughout. The point is what the reference's manual
"run it overnight" workflow would catch — leaks, reload races, latency
drift — asserted mechanically (tests/test_soak.py runs a short one).

Prints ONE summary JSON line:
  {"requests": N, "errors": 0, "reloads": R,
   "p50_ms": ..., "p99_ms": ...,
   "rss_start_mb": ..., "rss_mid_mb": ..., "rss_end_mb": ...,
   "rss_tail_growth_mb": ...}

Usage: python scripts/soak_serve.py [--duration 60] [--threads 4]
           [--reload-interval 10] [--quantize int8] [--model PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _make_model(path: str) -> None:
    """Tiny self-describing artifact (same recipe as the serve tests)."""
    import jax

    from annonet_jax import serialization
    from annonet_jax.classes import anno_classes_to_json, default_anno_classes
    from annonet_jax.models.segnet import SegNetConfig, fold_batchnorm, init_state

    config = SegNetConfig(class_count=3, level_count=0, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    serialization.save_model(
        path, runtime, config, anno_classes_to_json(default_anno_classes()), 1.0
    )


def _rss_mb(pid: int) -> float:
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    raise RuntimeError("VmRSS not found")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None, help="artifact path (default: tiny synthetic)")
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--reload-interval", type=float, default=10.0,
                    help="seconds between hot reloads; 0 disables")
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--quantize", choices=["none", "int8"], default="none")
    ap.add_argument("--tile-max", type=int, default=64,
                    help="small tiles so the soak exercises multi-tile blending")
    ap.add_argument("--max-batch", type=int, default=1,
                    help="serve-side request batching (annonet_serve "
                    "--max-batch); >1 exercises the dispatcher under load")
    ap.add_argument("--startup-timeout", type=float, default=180.0)
    args = ap.parse_args(argv)

    import numpy as np

    from annonet_jax.cli.common import apply_platform_env
    from annonet_jax.client import ServeClient, ServeError

    apply_platform_env()  # the script's own jax (model creation) honors
    # ANNONET_PLATFORM just like the CLIs; the serve subprocess
    # inherits the environment and pins itself.

    tmp = None
    model_path = args.model
    if model_path is None:
        tmp = tempfile.TemporaryDirectory(prefix="annonet_soak_")
        model_path = os.path.join(tmp.name, "annonet.dnn")
        _make_model(model_path)

    port = _free_port()
    cmd = [
        sys.executable, "-m", "annonet_jax.cli.serve",
        "--model", model_path, "--host", "127.0.0.1", "--port", str(port),
        "--tile-max-width", str(args.tile_max), "--tile-max-height", str(args.tile_max),
        "--quantize", args.quantize,
        "--max-batch", str(args.max_batch),
    ]
    proc = subprocess.Popen(cmd)
    client = ServeClient("127.0.0.1", port, timeout=120.0)

    lock = threading.Lock()
    latencies: list[float] = []
    errors: list[str] = []
    reloads = [0]
    server_stats: dict = {}
    stop = threading.Event()

    try:
        deadline = time.monotonic() + args.startup_timeout
        while True:
            try:
                client.healthz()
                break
            except Exception:
                if proc.poll() is not None:
                    raise RuntimeError(f"server exited rc={proc.returncode} during startup")
                if time.monotonic() > deadline:
                    raise RuntimeError("server did not become healthy in time")
                time.sleep(0.5)

        rng = np.random.default_rng(0)
        pixels = rng.integers(0, 256, size=(args.height, args.width, 3), dtype=np.uint8)

        # one warm-up request so the compile doesn't pollute latencies
        client.infer(pixels)

        end = time.monotonic() + args.duration

        def load_worker(seed: int) -> None:
            local = np.random.default_rng(seed)
            img = pixels.copy()
            n = 0
            while time.monotonic() < end and not stop.is_set():
                # vary pixels and gains so requests are not byte-identical
                img[local.integers(0, args.height), local.integers(0, args.width)] = (
                    local.integers(0, 256, size=3, dtype=np.uint8)
                )
                gains = {1: float(local.uniform(-0.5, 0.5))} if n % 3 else None
                t0 = time.monotonic()
                try:
                    labels = client.infer(img, gains=gains)
                    assert labels.shape == (args.height, args.width)
                    with lock:
                        latencies.append((time.monotonic() - t0) * 1e3)
                except (ServeError, OSError, AssertionError) as e:  # noqa: PERF203
                    with lock:
                        errors.append(f"{type(e).__name__}: {e}")
                n += 1

        def reload_worker() -> None:
            from annonet_jax import serialization

            while not stop.is_set() and time.monotonic() < end:
                if stop.wait(min(args.reload_interval, max(0.0, end - time.monotonic()))):
                    return
                if time.monotonic() >= end:
                    return
                try:
                    # re-save (atomic; new mtime) then hot-reload: exercises
                    # the fast weight-swap path under in-flight requests
                    params, config, classes_json, factor = serialization.load_model(model_path)
                    serialization.save_model(model_path, params, config, classes_json, factor)
                    client.reload()
                    with lock:
                        reloads[0] += 1
                except (ServeError, OSError) as e:
                    with lock:
                        errors.append(f"reload {type(e).__name__}: {e}")

        rss = [(time.monotonic(), _rss_mb(proc.pid))]
        workers = [
            threading.Thread(target=load_worker, args=(i + 1,), daemon=True)
            for i in range(args.threads)
        ]
        if args.reload_interval > 0:
            workers.append(threading.Thread(target=reload_worker, daemon=True))
        for w in workers:
            w.start()
        while time.monotonic() < end:
            time.sleep(1.0)
            rss.append((time.monotonic(), _rss_mb(proc.pid)))
        for w in workers:
            w.join(timeout=130.0)
        try:
            server_stats = client.stats()
        except Exception:  # noqa: BLE001 — stats are best-effort
            server_stats = {}
    finally:
        stop.set()
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
        if tmp is not None:
            tmp.cleanup()

    latencies.sort()
    mid = rss[len(rss) // 2][1]
    summary = {
        "requests": len(latencies),
        "errors": len(errors),
        "reloads": reloads[0],
        "p50_ms": round(latencies[len(latencies) // 2], 2) if latencies else None,
        "p99_ms": round(latencies[int(len(latencies) * 0.99)], 2) if latencies else None,
        "rss_start_mb": round(rss[0][1], 1),
        "rss_mid_mb": round(mid, 1),
        "rss_end_mb": round(rss[-1][1], 1),
        "rss_tail_growth_mb": round(rss[-1][1] - mid, 1),
    }
    served = server_stats.get("requests_served")
    batches = server_stats.get("batches_dispatched")
    if served and batches:
        # dynamic-batching occupancy: requests per device batch (1.0 =
        # no grouping; approaches --max-batch under saturated load)
        summary["batch_occupancy"] = round(served / batches, 2)
    for e in errors[:10]:
        print("ERROR:", e, file=sys.stderr, flush=True)
    print(json.dumps(summary), flush=True)
    return 0 if not errors else 1


if __name__ == "__main__":
    sys.exit(main())
