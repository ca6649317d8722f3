"""Host data-pipeline throughput: can the loaders feed the train step?

The loader must outrun the device step's consumption for the CLI loop to
be device-bound. This measures what CropPipeline produces on this host
(synthetic dataset, real PNG decode, real crop extraction) at several
thread counts.

Run: python scripts/bench_loader.py [--dim 192] [--images 8] [--size 2048]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dim", type=int, default=192)
    parser.add_argument("--images", type=int, default=8)
    parser.add_argument("--size", type=int, default=2048)
    parser.add_argument("--crops", type=int, default=512)
    parser.add_argument(
        "--pinned-budget", type=int, action="append", default=None,
        metavar="BYTES",
        help="Also sweep pinned_bytes_budget values (0 forces the "
             "extract-inline fallback at data/pipeline.py::_make_crop); "
             "default sweeps [default-budget, 0]",
    )
    args = parser.parse_args()

    import numpy as np

    from annonet_jax.classes import default_anno_classes, anno_classes_to_json
    from annonet_jax.data.crop import CropOptions
    from annonet_jax.data.dataset import find_image_files
    from annonet_jax.data.pipeline import CropPipeline
    from annonet_jax.data.sample import save_png

    anno_classes = default_anno_classes()
    rng = np.random.default_rng(0)

    with tempfile.TemporaryDirectory() as root:
        for i in range(args.images):
            img = rng.integers(
                0, 256, size=(args.size, args.size, 3), dtype=np.uint8
            )
            mask = np.zeros((args.size, args.size, 4), dtype=np.uint8)
            mask[...] = anno_classes[0].rgba_label
            mask[:: 7, :: 5] = anno_classes[1].rgba_label
            save_png(os.path.join(root, f"im{i}.png"), img)
            save_png(os.path.join(root, f"im{i}.png_mask.png"), mask)

        files = find_image_files(root, True, verbose=False)
        opts = CropOptions(dim=args.dim)

        budgets = args.pinned_budget or [512 << 20, 0]
        for threads in (2, 4, 8, os.cpu_count() or 8):
            for budget in budgets:
                with CropPipeline(
                    files,
                    anno_classes,
                    opts,
                    thread_count=threads,
                    cached_image_count=args.images,
                    queue_depth=256,
                    seed=1,
                    pinned_bytes_budget=budget,
                ) as pipe:
                    # warm the cache (first touch decodes all images)
                    pipe.next_minibatch(64, warn=None)
                    t0 = time.monotonic()
                    pipe.next_minibatch(args.crops, warn=None)
                    dt = time.monotonic() - t0
                print(
                    f"threads={threads} budget={budget >> 20}M: "
                    f"{args.crops / dt:.0f} crops/s "
                    f"({args.crops * args.dim * args.dim / dt / 1e6:.1f} "
                    f"Mpx/s)",
                    flush=True,
                )


if __name__ == "__main__":
    main()
