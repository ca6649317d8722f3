"""annonet_train soak: a REAL training subprocess, leak- and rate-checked.

The trainer-side counterpart of scripts/soak_serve.py: runs the actual
`annonet_train` CLI on a synthetic dataset for N steps, samples the
child's VmRSS throughout, and summarizes what the reference's manual
"run it overnight and watch" workflow would catch mechanically:

- the run completes (rc 0) and trains (final loss < first recorded loss)
- resident set is flat in steady state (no per-step/per-flush leak:
  the device pool, superstep buffers, metrics writer and LRU cache all
  have bounded footprints by design — this checks the design holds)
- the cumulative step rate does not decay between the middle and the
  end of the run (no slow poisoning of the dispatch path)

Prints ONE summary JSON line:
  {"rc": 0, "steps": N, "first_loss": ..., "final_loss": ...,
   "sps_mid": ..., "sps_end": ...,
   "rss_start_mb": ..., "rss_mid_mb": ..., "rss_end_mb": ...,
   "rss_tail_growth_mb": ...}

Usage: python scripts/soak_train.py [--steps 600] [--batch 16] ...
(tests/test_soak_train.py runs a short CPU one)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _make_dataset(root: str, n_images: int, size: int, seed: int = 0) -> None:
    """Separable 3-class data using the default palette (classes.py)."""
    import numpy as np

    from annonet_jax.classes import anno_classes_to_json, default_anno_classes
    from annonet_jax.data.sample import save_png

    classes = default_anno_classes()
    with open(os.path.join(root, "anno_classes.json"), "w") as f:
        f.write(anno_classes_to_json(classes))
    rng = np.random.default_rng(seed)
    for i in range(n_images):
        labels = np.zeros((size, size), np.uint16)
        for cls in (1, 2):
            for _ in range(2):
                y, x = rng.integers(2, size - 10, size=2)
                h, w = rng.integers(4, 9, size=2)
                labels[y : y + h, x : x + w] = cls
        base = np.array([[40, 120, 40], [220, 30, 30], [30, 30, 220]])
        image = base[labels].astype(np.int16)
        image += rng.integers(-15, 16, size=image.shape)
        mask = np.zeros((size, size, 4), np.uint8)
        for cls in (0, 1, 2):
            mask[labels == cls] = classes[cls].rgba_label
        save_png(os.path.join(root, f"img{i}.png"),
                 image.clip(0, 255).astype(np.uint8))
        save_png(
            os.path.join(root, f"img{i}.png_mask.png"), mask
        )


def _rss_mb(pid: int) -> float:
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    raise RuntimeError("VmRSS not found")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--images", type=int, default=6)
    ap.add_argument("--image-size", type=int, default=96)
    ap.add_argument("--level-count", type=int, default=2)
    ap.add_argument("--net-width-scaler", type=float, default=0.5)
    ap.add_argument("--input-dimension-multiplier", type=float, default=1.0)
    ap.add_argument("--metrics-interval", type=int, default=20)
    ap.add_argument("--timeout", type=float, default=1800.0)
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="annonet_soak_train_") as tmp:
        ds = os.path.join(tmp, "ds")
        os.makedirs(ds)
        _make_dataset(ds, args.images, args.image_size)
        metrics_path = os.path.join(tmp, "metrics.jsonl")
        cmd = [
            sys.executable, "-m", "annonet_jax.cli.train", ds,
            "-b", str(args.batch),
            "--max-total-steps", str(args.steps),
            "--level-count", str(args.level_count),
            "--net-width-scaler", str(args.net_width_scaler),
            "--input-dimension-multiplier",
            str(args.input_dimension_multiplier),
            "--metrics-jsonl", metrics_path,
            "--metrics-interval", str(args.metrics_interval),
            "--output", os.path.join(tmp, "annonet.dnn"),
            "--sync-file", os.path.join(tmp, "sync.dat"),
            "--seed", "0",
        ]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        rss = []
        deadline = time.monotonic() + args.timeout
        while proc.poll() is None:
            try:
                rss.append(_rss_mb(proc.pid))
            except (FileNotFoundError, ProcessLookupError, RuntimeError):
                break
            if time.monotonic() > deadline:
                proc.kill()
                out = proc.communicate()[0]
                print(out[-2000:], file=sys.stderr, flush=True)
                print(json.dumps({"rc": -9, "error": "timeout"}), flush=True)
                return 1
            time.sleep(0.5)
        out = proc.communicate()[0]
        rc = proc.returncode
        if rc != 0:
            print(out[-2000:], file=sys.stderr, flush=True)

        losses = []
        done = {}
        try:
            with open(metrics_path) as f:
                for line in f:
                    ev = json.loads(line)
                    if ev.get("event") == "loss":
                        losses.append(ev)
                    elif ev.get("event") == "done":
                        done = ev
        except FileNotFoundError:
            pass

        mid_rss = rss[len(rss) // 2] if rss else None
        mid_loss = losses[len(losses) // 2] if losses else {}
        summary = {
            "rc": rc,
            "steps": done.get("steps"),
            "first_loss": round(losses[0]["loss"], 4) if losses else None,
            "final_loss": round(losses[-1]["loss"], 4) if losses else None,
            "sps_mid": mid_loss.get("steps_per_second"),
            "sps_end": losses[-1].get("steps_per_second") if losses else None,
            "rss_start_mb": round(rss[0], 1) if rss else None,
            "rss_mid_mb": round(mid_rss, 1) if rss else None,
            "rss_end_mb": round(rss[-1], 1) if rss else None,
            "rss_tail_growth_mb": (
                round(rss[-1] - mid_rss, 1) if rss else None
            ),
        }
        print(json.dumps(summary), flush=True)
        return 0 if rc == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
