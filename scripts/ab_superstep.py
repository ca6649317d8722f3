"""E2e CLI A/B of --steps-per-dispatch (scan superstep K).

DESIGN.md §18 describes the superstep. This sweep asks what each K buys:
it runs the REAL `annonet_train` CLI as a subprocess on a synthetic
dataset for each K, one after another (one process per card),
interleaved (K-order round-robin, two rounds, so drift of the card's
clock hits all arms equally), and reports the steady-state mean wall
ms/step from ANNONET_STEP_TIMING lines.

Run on hardware:  python scripts/ab_superstep.py --ks 4 8 16
Quick CPU smoke:  ANNONET_PLATFORM=cpu python scripts/ab_superstep.py \
                      --ks 1 2 --steps 12 --size 256 --batch 8
"""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STEP_RE = re.compile(r"\[step (\d+)\] ([0-9.]+)s")


def make_dataset(root: str, images: int, size: int) -> None:
    import numpy as np

    from annonet_jax.classes import default_anno_classes
    from annonet_jax.data.sample import save_png

    anno_classes = default_anno_classes()
    rng = np.random.default_rng(0)
    for i in range(images):
        img = rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
        mask = np.zeros((size, size, 4), dtype=np.uint8)
        mask[...] = anno_classes[0].rgba_label
        mask[::7, ::5] = anno_classes[1].rgba_label
        save_png(os.path.join(root, f"im{i}.png"), img)
        save_png(os.path.join(root, f"im{i}.png_mask.png"), mask)


def run_cli(root: str, k: int, args) -> list:
    """One annonet_train run; returns per-step wall seconds by index."""
    env = dict(os.environ, ANNONET_STEP_TIMING="1")
    out_model = os.path.join(root, f"annonet_k{k}.dnn")
    sync = os.path.join(root, f"sync_k{k}.dat")
    # a fresh sync file per run: never resume across arms
    if os.path.exists(sync):
        os.remove(sync)
    cmd = [
        sys.executable, "-u", "-m", "annonet_jax.cli.train", root,
        "-b", str(args.batch),
        "--max-total-steps", str(args.steps),
        "--steps-per-dispatch", str(k),
        "--save-interval", "1000000",
        "--output", out_model,
        "--sync-file", sync,
        "--level-count", str(args.level_count),
        "--seed", "0",
    ]
    proc = subprocess.run(
        cmd, cwd=REPO, env=env, capture_output=True, text=True,
        timeout=1800,
    )
    if proc.returncode != 0:
        print(proc.stdout[-2000:])
        print(proc.stderr[-2000:])
        raise RuntimeError(f"K={k} run failed rc={proc.returncode}")
    times = {}
    for m in STEP_RE.finditer(proc.stdout):
        times[int(m.group(1))] = float(m.group(2))
    return [times[i] for i in sorted(times)]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--ks", type=int, nargs="+", default=[4, 8, 16])
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--warm", type=int, default=10,
                        help="steps excluded from the steady-state mean")
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--images", type=int, default=8)
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--level-count", type=int, default=3)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()

    results = {k: [] for k in args.ks}
    with tempfile.TemporaryDirectory() as root:
        make_dataset(root, args.images, args.size)
        for r in range(args.rounds):
            for k in args.ks:
                times = run_cli(root, k, args)
                steady = times[args.warm:]
                # superstep buffering makes per-step walls lumpy (K-1
                # near-zero buffered steps + one dispatch); the MEAN is
                # the per-step rate. Align to whole supersteps.
                steady = steady[: (len(steady) // k) * k] or steady
                ms = statistics.mean(steady) * 1e3
                results[k].append(ms)
                print(f"round {r} K={k}: {ms:.2f} ms/step "
                      f"({args.batch / ms * 1e3:.0f} crops/s)", flush=True)

    print()
    summary = {}
    for k in args.ks:
        ms = statistics.mean(results[k])
        summary[k] = ms
        print(f"K={k:3d}: {ms:6.2f} ms/step mean of {results[k]} "
              f"-> {args.batch / ms * 1e3:6.0f} crops/s")
    print(json.dumps({"ab": "superstep_k", "batch": args.batch,
                      "ms_per_step": summary}))


if __name__ == "__main__":
    main()
