"""Benchmark: tiled-inference throughput (Mpx/s/chip) on the flagship net,
plus secondary framework metrics.

Output: first a line with the card's name and power limit (nvidia-smi),
then one JSON object per line, each naming the device it ran on:
  tiled_inference_throughput     — the int8 tiled-inference rate at 4096²
  tiled_inference_throughput_f32 — the exact bf16/f32 float arm
  train_step_crops_per_s         — the fused pool train step at the
                                   pinned batch/dim (DESIGN.md §17)
  loader_crops_per_s             — host CropPipeline feed rate
``--headline-only`` prints only the first metric. A failed secondary arm
is reported on stderr and makes the exit code non-zero.

The scenario mirrors the reference's headline loop (annonet_infer per image,
annonet_infer_main.cpp:466-480): a large RGB image is tiled, every tile is
forwarded, the per-class outputs are overlap-blended and argmaxed into a
label map on device.

Timing: N iterations are enqueued back to back on a device-resident input
and the host clock stops at jax.block_until_ready on the last result.
Without ``--quick`` the benchmark refuses to run anywhere but a GPU.
"""

from __future__ import annotations

import argparse
import json
import time


def measure_tiled_inference(inferer, image, image_size: int, iters: int,
                            passes: int) -> float:
    """Median Mpx/s over ``passes`` measurement passes."""
    import jax

    # warm-up (compile), like the reference's excluded first image
    jax.block_until_ready(inferer.infer_arrays(image, device_output=True))

    megapixels = image_size * image_size * iters / 1e6
    results = []
    for _ in range(max(1, passes)):
        t0 = time.perf_counter()
        for _ in range(iters):
            labels, _ = inferer.infer_arrays(image, device_output=True)
        jax.block_until_ready(labels)
        elapsed = max(1e-9, time.perf_counter() - t0)
        assert labels.shape[0] >= image.shape[0]
        results.append(megapixels / elapsed)

    # median over passes: robust to one slow pass (host GC, clock boost)
    return sorted(results)[len(results) // 2]


def measure_train_step(batch: int, dim: int, iters: int) -> dict:
    """The fused pool train step (the CLI's hot path: gather from the
    device image pool + augment + weighting + fwd/bwd + SGD in ONE XLA
    program) at the pinned flagship configuration (DESIGN.md §17). Keys
    are pre-split so the timed loop is exactly one dispatch per step."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from annonet_jax.data.crop import CropOptions
    from annonet_jax.models.segnet import SegNetConfig, init_state
    from annonet_jax.train.trainer import (
        TrainerConfig,
        make_fused_pool_step,
    )

    config = SegNetConfig(class_count=3, level_count=3, base_width=16)
    crop_options = CropOptions(
        dim=dim,
        allow_flip_left_right=True,
        allow_flip_upside_down=True,
        multiplicative_brightness_change_probability=0.5,
        noise_level_stddev=2.0,
        allow_random_color_offset=True,
    )
    step = jax.jit(
        make_fused_pool_step(config, TrainerConfig(), crop_options, dim)
    )

    rng = np.random.default_rng(0)
    image_size = 2 * dim
    n_pool = 4
    pool_images = jnp.asarray(rng.integers(
        0, 256, size=(n_pool, image_size, image_size, 3), dtype=np.uint8
    ))
    pool_labels = jnp.asarray(rng.integers(
        0, 3, size=(n_pool, image_size, image_size)
    ).astype(np.uint16))
    # packed [5, B] int32 decision rows: slot, y0, x0, valid_h, valid_w
    packed = jnp.asarray(np.stack([
        rng.integers(0, n_pool, size=batch).astype(np.int32),
        rng.integers(-8, image_size - dim + 8, size=batch).astype(np.int32),
        rng.integers(-8, image_size - dim + 8, size=batch).astype(np.int32),
        np.full(batch, image_size, np.int32),
        np.full(batch, image_size, np.int32),
    ]))

    params, bn_stats = init_state(jax.random.PRNGKey(0), config)
    velocity = jax.tree_util.tree_map(jnp.zeros_like, params)
    lr = jnp.float32(0.1)
    momentum = jnp.float32(0.99)
    key = jax.random.PRNGKey(1)

    # warm-up/compile
    params, bn_stats, velocity, loss = step(
        params, bn_stats, velocity, lr, momentum, key,
        pool_images, pool_labels, packed,
    )
    jax.block_until_ready(loss)

    # PRE-SPLIT keys: a host-side jax.random.split inside the timed loop
    # would add a dispatch and a sync per iteration
    subs = jax.block_until_ready(list(jax.random.split(key, iters)))
    t0 = time.perf_counter()
    for i in range(iters):
        params, bn_stats, velocity, loss = step(
            params, bn_stats, velocity, lr, momentum, subs[i],
            pool_images, pool_labels, packed,
        )
    jax.block_until_ready(loss)
    elapsed = max(1e-9, time.perf_counter() - t0)
    final_loss = float(loss)
    per_step = elapsed / iters
    return {
        "crops_per_s": batch / per_step,
        "ms_per_step": per_step * 1000,
        "batch": batch,
        "dim": dim,
        "final_loss": final_loss,
    }


def measure_loader(dim: int, crops: int, threads: int = 2) -> dict:
    """Host CropPipeline feed rate in crops/s (synthetic dataset, real PNG
    decode, real crop extraction) — must outrun the device step's
    consumption for the CLI loop to be device-bound."""
    import pathlib
    import tempfile

    import numpy as np

    from annonet_jax.classes import (
        anno_classes_to_json,
        default_anno_classes,
        parse_anno_classes,
    )
    from annonet_jax.data.crop import CropOptions
    from annonet_jax.data.dataset import find_image_files
    from annonet_jax.data.pipeline import CropPipeline

    anno_classes = parse_anno_classes(
        anno_classes_to_json(default_anno_classes())
    )
    from annonet_jax.data.sample import save_png

    with tempfile.TemporaryDirectory() as td:
        root = pathlib.Path(td)
        rng = np.random.default_rng(0)
        size = 1024
        palette = np.array([c.rgba_label for c in anno_classes], np.uint8)
        for i in range(6):
            img = rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
            labels = rng.integers(0, 3, size=(size, size)).astype(np.int32)
            save_png(str(root / f"img{i}.png"), img)
            save_png(str(root / f"img{i}.png_mask.png"), palette[labels])
        files = find_image_files(str(root), True, verbose=False)
        options = CropOptions(
            dim=dim, allow_flip_left_right=True, allow_flip_upside_down=True
        )
        batch = 64
        with CropPipeline(
            files, anno_classes, options, thread_count=threads, seed=0
        ) as pipe:
            pipe.next_minibatch(batch, warn=None)  # warm the cache
            t0 = time.monotonic()
            produced = 0
            while produced < crops:
                images, labels = pipe.next_minibatch(batch, warn=None)
                produced += images.shape[0]
            elapsed = max(1e-9, time.monotonic() - t0)
    return {
        "crops_per_s": produced / elapsed,
        "dim": dim,
        "threads": threads,
    }


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--image-size", type=int, default=4096)
    parser.add_argument(
        "--tile-size", type=int, default=None,
        help="max tile dimension (default: auto — infer.tiling."
             "default_tile_max)",
    )
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument(
        "--passes", type=int, default=3,
        help="independent measurement passes; the MEDIAN is reported",
    )
    parser.add_argument(
        "--quick", action="store_true",
        help="small sizes for CPU smoke-testing",
    )
    parser.add_argument(
        "--plan-autotune", action="store_true",
        help="measured tile-plan selection: also compile the neighbouring "
             "grid counts at warm-up and bench with the fastest "
             "(infer/core.py::_autotune_for)",
    )
    parser.add_argument(
        "--quantize", choices=["none", "int8"], default="int8",
        help="int8 (default) runs the int8 conv stack (accuracy above the "
             "pinned parity floors, tests/test_end_to_end.py); 'none' "
             "measures the exact bf16 float path",
    )
    parser.add_argument(
        "--headline-only", action="store_true",
        help="print only the headline tiled-inference line (skip the "
             "f32 arm, the train step, and the loader metrics)",
    )
    args = parser.parse_args()
    if args.quick:
        args.image_size = min(args.image_size, 512)
        args.tile_size = min(args.tile_size or 1024, 256)
        args.iters = min(args.iters, 2)
        args.passes = min(args.passes, 2)

    from annonet_jax.cli.common import (
        apply_platform_env,
        default_tile_max,
        device_probe,
    )

    apply_platform_env()  # ANNONET_PLATFORM=cpu pins the backend
    device_probe(on_timeout="raise")

    if args.tile_size is None:
        args.tile_size = default_tile_max()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from annonet_jax.infer.core import TiledInferer
    from annonet_jax.infer.tiling import TilingParameters
    from annonet_jax.models.segnet import (
        SegNetConfig,
        fold_batchnorm,
        init_state,
        required_input_dimension,
    )

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if dev.platform == "gpu":
        from annonet_jax.utils.system import gpu_name_and_power_limit

        print(gpu_name_and_power_limit(), flush=True)
    elif not args.quick:
        raise SystemExit(
            f"bench: no GPU (JAX's first device is {dev.platform}); "
            "--quick runs the small CPU smoke sizes"
        )

    config = SegNetConfig(class_count=3, level_count=3, base_width=16)
    params, bn_stats = init_state(jax.random.PRNGKey(0), config)
    runtime_params = fold_batchnorm(params, bn_stats, config)

    overlap = required_input_dimension(config)
    tiling = TilingParameters(
        max_tile_width=args.tile_size,
        max_tile_height=args.tile_size,
        overlap_x=overlap,
        overlap_y=overlap,
    )

    rng = np.random.default_rng(0)
    image = rng.integers(
        0, 256, size=(args.image_size, args.image_size, 3), dtype=np.uint8
    )
    # upload once and iterate on the device-resident image: the CLI
    # pipeline overlaps uploads with compute, so the device rate is the
    # rate of the program alone
    image = jax.block_until_ready(jnp.asarray(image))

    def make_inferer(quantize):
        return TiledInferer(
            runtime_params, config, tiling,
            quantize=quantize, plan_autotune=args.plan_autotune,
        )

    def emit(metric, value, unit, **extra):
        print(json.dumps({
            "metric": metric,
            "value": round(value, 3),
            "unit": unit,
            "device": device,
            **extra,
        }), flush=True)

    headline_quant = None if args.quantize == "none" else args.quantize
    mpx_per_s = measure_tiled_inference(
        make_inferer(headline_quant), image, args.image_size,
        args.iters, args.passes,
    )
    emit("tiled_inference_throughput", mpx_per_s, "Mpx/s/chip")

    if args.headline_only:
        return 0

    # secondary metrics: each arm runs even when another failed, and any
    # failure is reported and turns the exit code non-zero
    import sys
    import traceback

    failed = []

    def arm(name, fn):
        try:
            fn()
        except Exception:  # noqa: BLE001 — reported, then counted
            traceback.print_exc(file=sys.stderr)
            failed.append(name)

    def f32_arm():
        if headline_quant is not None:
            f32 = measure_tiled_inference(
                make_inferer(None), image, args.image_size,
                args.iters, max(1, args.passes - 1),
            )
            emit("tiled_inference_throughput_f32", f32, "Mpx/s/chip")

    def train_arm():
        t = measure_train_step(
            batch=32 if args.quick else 128,
            dim=64 if args.quick else 192,
            iters=3 if args.quick else 10,
        )
        emit("train_step_crops_per_s", t["crops_per_s"], "crops/s/chip",
             ms_per_step=round(t["ms_per_step"], 3), batch=t["batch"],
             dim=t["dim"])

    def loader_arm():
        ld = measure_loader(
            dim=64 if args.quick else 192,
            crops=128 if args.quick else 1024,
        )
        emit("loader_crops_per_s", ld["crops_per_s"], "crops/s/host",
             dim=ld["dim"], threads=ld["threads"])

    arm("tiled_inference_throughput_f32", f32_arm)
    arm("train_step_crops_per_s", train_arm)
    arm("loader_crops_per_s", loader_arm)
    if failed:
        print(f"bench: failed arms: {', '.join(failed)}", file=sys.stderr,
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
