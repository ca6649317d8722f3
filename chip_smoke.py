#!/usr/bin/env python3
"""Smoke test of the whole system on one GPU, through its user entry points.

    python chip_smoke.py               # one GPU: train, infer, serve
    python chip_smoke.py --four-cards  # four GPUs: the multi-device check

The default run drives the flagship model (SegNetConfig(class_count=3,
level_count=3, base_width=16), RGB, bf16 compute) in ONE process, one phase
after another, each printing one line:

  device  refuses anything but a GPU; prints the card (nvidia-smi name and
          power limit), JAX's device kind, count, version and memory limit
  train   annonet_train on a seeded synthetic anno dataset (8 images of
          1024², batch 128, device image cache on, 24 steps) on the CLI's
          default path (8 steps per lax.scan dispatch, losses read back in
          batches): the artifact is written and every loss is finite;
          plus one int8-forward fused step with a finite loss
  folded  the width-folded float32 net vs the plain unfolded reference on
          one 1024² tile: logits within rtol = atol = 1e-4
  infer   annonet_infer at 4096², the float path and --quantize int8, each
          label map against the plain reference. The trained net on a
          seeded inspection image: agreement >= 99.5% (float) and >= 95%
          (int8). A randomly initialised net on seeded noise, whose logits
          sit near ties and whose reference spreads over the classes (at
          least two classes >= 1% each): >= 98% (float), >= 95% (int8).
          Each line prints the reference's class shares
  serve   annonet_serve in-process with --warmup; 4 raw-pixel requests at
          two image sizes through ServeClient equal annonet_infer's labels

The plain reference is models/segnet.py::apply_runtime with a float32
config on the production plan's tiles, blended with the same ramp weights
in float64 on the host. Every comparison runs under
jax.default_matmul_precision("highest"), so float32 products on the card do
not drop to TF32.

``--four-cards`` runs only parallel/check.py::multichip_check over a
4-device mesh (sync-BN data-parallel training and tile-parallel inference
against the single-device programs) at the flagship widths in float32.

Any failed phase exits non-zero and prints no result line. On success the
last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import math
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

FLAGSHIP = {"class_count": 3, "level_count": 3, "base_width": 16}
FLOAT_AGREEMENT = 0.995
INT8_AGREEMENT = 0.95
# a random net's logits are near ties almost everywhere, so bf16 rounding
# moves more labels there than in a trained net
FLOAT_RANDOM_AGREEMENT = 0.98
# the random net's reference must spread over at least two classes
MIN_CLASS_SHARE = 0.01
FOLDED_TOLERANCE = 1e-4


def _require(ok, message="check failed") -> None:
    """A check that stays on under ``python -O``, unlike ``assert``."""
    if not ok:
        raise AssertionError(message)


def _print(*parts) -> None:
    print(*parts, flush=True)


@contextlib.contextmanager
def phase(name: str):
    """Time one phase; its summary line is printed by the caller."""
    t0 = time.perf_counter()
    holder = {}
    yield holder
    _print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s: "
           f"{holder.get('summary', '')}")


def check_device(require_gpu: bool = True) -> dict:
    """JAX's first device, refusing anything but a GPU. Prints the card,
    JAX's view of it, and the memory JAX may use."""
    import jax

    devices = jax.devices()
    dev = devices[0]
    if require_gpu and dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this smoke test runs on the card only"
        )
    if dev.platform == "gpu":
        from annonet_jax.utils.system import gpu_name_and_power_limit

        _print(gpu_name_and_power_limit())
    stats = dev.memory_stats() or {}
    _print(f"jax {jax.__version__}: {len(devices)} x {dev.device_kind} "
           f"({dev.platform}), bytes_limit={stats.get('bytes_limit')}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}


def flagship_config(**overrides):
    from annonet_jax.models.segnet import SegNetConfig

    return SegNetConfig(**{**FLAGSHIP, **overrides})


# ------------------------------------------------------------------ train


@contextlib.contextmanager
def superstep_spy():
    """Record the length of every K-step scan program the trainer
    dispatches (Trainer._dispatch_superstep), so the train phase can show
    that the CLI's default superstep path ran."""
    from annonet_jax.train.trainer import Trainer

    lengths = []
    original = Trainer._dispatch_superstep

    def spy(self):
        if self._superstep_buffer:
            lengths.append(len(self._superstep_buffer))
        return original(self)

    Trainer._dispatch_superstep = spy
    try:
        yield lengths
    finally:
        Trainer._dispatch_superstep = original


def train_phase(out_dir: str, *, image_size: int = 1024, n_images: int = 8,
                batch: int = 128, steps: int = 24,
                level_count: int = FLAGSHIP["level_count"],
                extra_args=()) -> tuple:
    """annonet_train on a seeded synthetic dataset, on the CLI's default
    training path: K steps per lax.scan dispatch and losses read back in
    batches (``steps`` is a multiple of K). Returns (model path, the
    recorded losses)."""
    import pathlib

    from annonet_jax.cli.train import build_parser
    from annonet_jax.cli.train import main as train_main
    from annonet_jax.data.synthetic import write_detection_dataset

    k = build_parser().get_default("steps_per_dispatch")
    _require(steps % k == 0, f"{steps} steps is not a multiple of K = {k}")
    root = pathlib.Path(out_dir) / "dataset"
    write_detection_dataset(root, n_images=n_images, size=image_size, seed=0)
    model = os.path.join(out_dir, "annonet.dnn")
    metrics = os.path.join(out_dir, "train_metrics.jsonl")
    for stale in (model, metrics):
        if os.path.exists(stale):
            os.unlink(stale)
    with superstep_spy() as supersteps:
        rc = train_main([
            str(root),
            "--level-count", str(level_count),
            "-b", str(batch),
            "--device-image-cache", "on",
            "--max-total-steps", str(steps),
            "--output", model,
            "--sync-file", os.path.join(out_dir, "trainer_state.dat"),
            "--metrics-jsonl", metrics,
            # keep every loss event in the JSONL (the default keeps every
            # 100th); this thins the file only, not what the device runs
            "--metrics-interval", "1",
            *extra_args,
        ])
    _require(rc == 0, f"annonet_train exited {rc}")
    _require(os.path.getsize(model) > 0, "no model artifact written")
    _require(supersteps == [k] * (steps // k), (
        f"expected {steps // k} scan dispatches of {k} steps, "
        f"got {supersteps}"
    ))
    with open(metrics) as f:
        events = [json.loads(line) for line in f]
    losses = [e["loss"] for e in events if e.get("event") == "loss"]
    _require(len(losses) == steps,
             f"{len(losses)} loss events for {steps} steps")
    _require(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    done = [e for e in events if e.get("event") == "done"]
    _require(done and done[-1]["steps"] == steps, f"done event {done}")
    return model, losses


def int8_train_phase(*, batch: int = 128, dim: int = 192,
                     level_count: int = FLAGSHIP["level_count"]) -> float:
    """One fused train step with int8 forward convs; returns its loss."""
    import numpy as np

    from annonet_jax.data.crop import CropOptions
    from annonet_jax.train.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, size=(batch, dim, dim, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, size=(batch, dim, dim)).astype(np.uint16)
    trainer = Trainer(
        flagship_config(level_count=level_count),
        TrainerConfig(int8_forward=True), seed=0,
    )
    loss = float(trainer.train_step_crops(images, labels, CropOptions(dim=dim)))
    _require(math.isfinite(loss), f"non-finite int8-forward loss {loss}")
    return loss


# ------------------------------------------------------------ reference


def load_model(model_path: str):
    from annonet_jax import serialization

    runtime, config, anno_json, _factor = serialization.load_model(model_path)
    return runtime, config, anno_json


def folded_phase(runtime, config, tile: int = 1024) -> float:
    """Folded float32 logits vs apply_runtime float32 on one tile; returns
    the largest |difference| / (1 + |reference|)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from annonet_jax.models.folded_runtime import (
        apply_folded_split,
        fold_runtime_params,
        folding_supported,
        split_folded,
    )
    from annonet_jax.models.segnet import apply_runtime

    cfg32 = dataclasses.replace(config, compute_dtype="float32")
    fold0 = folding_supported(cfg32, tile)
    _require(fold0, f"the flagship net does not fold at tile {tile}")
    (f0, spec), arrays = split_folded(
        fold_runtime_params(runtime, cfg32, fold0)
    )
    rng = np.random.default_rng(2)
    x = jnp.asarray(
        rng.integers(0, 256, size=(1, tile, tile, 3), dtype=np.uint8)
    )
    with jax.default_matmul_precision("highest"):
        folded = jax.jit(
            lambda a, t: apply_folded_split(a, t, cfg32, fold0=f0, spec=spec)
        )(arrays, x)
        plain = jax.jit(lambda p, t: apply_runtime(p, t, cfg32))(runtime, x)
    folded, plain = np.asarray(folded), np.asarray(plain)
    np.testing.assert_allclose(
        folded, plain, rtol=FOLDED_TOLERANCE, atol=FOLDED_TOLERANCE,
        err_msg="folded float32 logits differ from apply_runtime",
    )
    return float(np.max(np.abs(folded - plain) / (1.0 + np.abs(plain))))


def reference_labels(runtime, config, plan, image):
    """The plain reference label map: apply_runtime in float32 on each
    tile of ``plan``, blended on the host in float64 with the production
    ramp weights, argmax over classes."""
    import jax
    import numpy as np

    from annonet_jax.infer.tiling import ramp_weights
    from annonet_jax.models.segnet import apply_runtime

    cfg32 = dataclasses.replace(config, compute_dtype="float32")
    h, w = image.shape[:2]
    hp, wp = plan.padded_height, plan.padded_width
    th, tw = plan.tile_height, plan.tile_width
    padded = np.pad(image, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    ramp = np.asarray(
        ramp_weights(th, tw, plan.overlap_y, plan.overlap_x), np.float64
    )
    acc = np.zeros((hp, wp, config.class_count), np.float64)
    wsum = np.zeros((hp, wp), np.float64)
    forward = jax.jit(lambda p, t: apply_runtime(p, t, cfg32))
    with jax.default_matmul_precision("highest"):
        for y, x in plan.tile_yx:
            logits = np.asarray(
                forward(runtime, padded[None, y : y + th, x : x + tw])[0],
                np.float64,
            )
            acc[y : y + th, x : x + tw] += logits * ramp[..., None]
            wsum[y : y + th, x : x + tw] += ramp
    return np.argmax(acc / wsum[..., None], axis=-1)[:h, :w]


def smoke_image(size: int, seed: int = 3):
    """A seeded inspection-style test image: a mosaic of synthetic
    detection images (data/synthetic.py), each at most 1024 px."""
    import numpy as np

    from annonet_jax.data.synthetic import generate_detection_image

    block = min(size, 1024)
    _require(size % block == 0)
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(size // block):
        rows.append(np.concatenate([
            generate_detection_image(rng, size=block, defect_count=16)[0]
            for _ in range(size // block)
        ], axis=1))
    return np.concatenate(rows, axis=0)


def noise_image(size: int, seed: int = 6):
    """A seeded uniform-noise RGB image."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)


def random_model(out_dir: str, seed: int = 0, **overrides) -> str:
    """Write a randomly initialised flagship artifact and return its path.
    Its class logits sit close together almost everywhere, so rounding in
    the bf16 and int8 paths moves labels far more often than in a trained
    net, and its label map spreads over every class."""
    import jax

    from annonet_jax import serialization
    from annonet_jax.classes import anno_classes_to_json, default_anno_classes
    from annonet_jax.models.segnet import fold_batchnorm, init_state

    config = flagship_config(**overrides)
    params, bn = init_state(jax.random.PRNGKey(seed), config)
    path = os.path.join(out_dir, "random.dnn")
    serialization.save_model(
        path, fold_batchnorm(params, bn, config), config,
        anno_classes_to_json(default_anno_classes()), 1.0,
    )
    return path


def class_shares(labels, class_count: int) -> list:
    """The share of pixels of each class."""
    import numpy as np

    counts = np.bincount(labels.ravel(), minlength=class_count)
    return [float(c) / labels.size for c in counts[:class_count]]


# ------------------------------------------------------------------ infer


def infer_phase(model_path: str, out_dir: str, *, image=None,
                image_size: int = 4096, quantize: str = "none",
                floor: float = None, min_class_share: float = None,
                references=None) -> dict:
    """annonet_infer on a seeded image (``image``, else smoke_image of
    ``image_size``), its label map compared with the plain reference.
    Asserts the agreement is at least ``floor`` (default: the path's own
    floor) and, given ``min_class_share``, that at least two classes each
    cover that share of the reference, so that a path writing one class
    everywhere cannot pass. Returns the agreement, the pixels that differ
    and the reference's class shares.
    ``references`` (a dict) keeps the reference labels for the next call
    on the same model and image."""
    import numpy as np

    from annonet_jax.classes import parse_anno_classes
    from annonet_jax.cli.infer import main as infer_main
    from annonet_jax.data.codec import decode_rgba_label_image
    from annonet_jax.data.sample import load_rgba, save_png
    from annonet_jax.infer.core import TiledInferer
    from annonet_jax.infer.tiling import TilingParameters, default_tile_max
    from annonet_jax.models.segnet import required_input_dimension

    runtime, config, anno_json = load_model(model_path)
    if image is None:
        image = smoke_image(image_size)
    name = os.path.splitext(os.path.basename(model_path))[0]
    in_dir = os.path.join(out_dir, f"infer_{name}_{quantize}")
    os.makedirs(in_dir, exist_ok=True)
    image_path = os.path.join(in_dir, "image.png")
    save_png(image_path, image)
    result_path = image_path + "_result.png"
    if os.path.exists(result_path):
        os.unlink(result_path)
    rc = infer_main([in_dir, "--model", model_path, "--quantize", quantize])
    _require(rc == 0, f"annonet_infer exited {rc}")
    labels = decode_rgba_label_image(
        load_rgba(result_path), parse_anno_classes(anno_json)
    )
    _require(labels.shape == image.shape[:2], labels.shape)

    # the plan the CLI ran: its default tiling, planned by the same inferer
    overlap = required_input_dimension(config)
    tile = default_tile_max()
    plan = TiledInferer(
        runtime, config, TilingParameters(tile, tile, overlap, overlap)
    ).plan(*image.shape[:2])
    references = {} if references is None else references
    key = (model_path, hashlib.sha1(np.ascontiguousarray(image)).hexdigest())
    if key not in references:
        references[key] = reference_labels(runtime, config, plan, image)
    reference = references[key]
    shares = class_shares(reference, config.class_count)
    if min_class_share is not None:
        _require(sum(s >= min_class_share for s in shares) >= 2, (
            f"reference class shares {shares}: fewer than two classes "
            f"cover {min_class_share}"
        ))
    differing = int(np.count_nonzero(labels != reference))
    agreement = 1.0 - differing / labels.size
    if floor is None:
        floor = INT8_AGREEMENT if quantize == "int8" else FLOAT_AGREEMENT
    _require(agreement >= floor, (
        f"{quantize} labels agree with the reference on {agreement:.7f} "
        f"of pixels, below {floor}; reference class shares {shares}"
    ))
    return {"agreement": agreement, "differing": differing,
            "floor": floor, "reference_shares": shares}


# ------------------------------------------------------------------ serve


def serve_phase(model_path: str, *, sizes=((1024, 1024), (1536, 2048)),
                warmup: str = "1024x1024") -> int:
    """annonet_serve in-process: --warmup, then two raw-pixel requests at
    each size through ServeClient; each must equal annonet_infer on the
    server's own inferer. Returns the number of requests checked."""
    import numpy as np

    from annonet_jax.cli.serve import _warmup, build_parser, make_server
    from annonet_jax.client import ServeClient
    from annonet_jax.infer.core import annonet_infer

    args = build_parser().parse_args(
        ["--model", model_path, "--port", "0", "--warmup", warmup]
    )
    server, service = make_server(args)
    _warmup(service, args.warmup)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        client = ServeClient(host, port, timeout=600)
        rng = np.random.default_rng(4)
        checked = 0
        for h, w in sizes:
            for _ in range(2):
                image = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
                served = client.infer(image)
                expected = annonet_infer(service.inferer, image)
                _require(served.shape == (h, w), served.shape)
                np.testing.assert_array_equal(
                    served, expected,
                    err_msg=f"served labels differ at {h}x{w}",
                )
                checked += 1
    finally:
        server.shutdown()
        server.server_close()
    return checked


# ------------------------------------------------------------- four cards


def four_cards_phase(n_devices: int = 4, *, crop_dim: int = 192,
                     crops_per_device: int = 4, image_size: int = 2048,
                     tile: int = 1024) -> dict:
    """parallel.check.multichip_check over the CLIs' own --mesh N mesh at
    the flagship widths in float32."""
    from annonet_jax.cli.common import make_cli_mesh
    from annonet_jax.parallel.check import multichip_check

    mesh = make_cli_mesh(n_devices)
    return multichip_check(
        mesh, config=flagship_config(compute_dtype="float32"),
        crop_dim=crop_dim, crops_per_device=crops_per_device,
        image_size=image_size, tile=tile,
    )


# ------------------------------------------------------------------- main


def run(out_dir: str, four_cards: bool) -> dict:
    with phase("device") as p:
        device = check_device()
        p["summary"] = json.dumps(device)
    if four_cards:
        if device["count"] < 4:
            raise RuntimeError(f"--four-cards needs 4 GPUs, found "
                               f"{device['count']}")
        with phase("four-cards") as p:
            p["summary"] = json.dumps(four_cards_phase())
        device["count"] = 4
        return device
    with phase("train") as p:
        model, losses = train_phase(out_dir)
        int8_loss = int8_train_phase()
        p["summary"] = (f"annonet_train {len(losses)} steps, loss "
                        f"{losses[0]:.6f} -> {losses[-1]:.6f}; int8-forward "
                        f"step loss {int8_loss:.6f}")
    runtime, config, _ = load_model(model)
    with phase("folded") as p:
        err = folded_phase(runtime, config)
        p["summary"] = (f"max |folded - plain| / (1 + |plain|) = {err:.3e} "
                        f"(bound {FOLDED_TOLERANCE})")
    references = {}
    random_net = random_model(out_dir)
    noise = noise_image(4096)
    cases = [
        ("trained", model, None, {}),
        ("random", random_net, noise,
         {"min_class_share": MIN_CLASS_SHARE}),
    ]
    for net, path, image, extra in cases:
        for quantize in ("none", "int8"):
            with phase(f"infer-{quantize}-{net}") as p:
                floor = (INT8_AGREEMENT if quantize == "int8"
                         else FLOAT_RANDOM_AGREEMENT if net == "random"
                         else FLOAT_AGREEMENT)
                r = infer_phase(path, out_dir, image=image,
                                quantize=quantize, floor=floor,
                                references=references, **extra)
                shares = ", ".join(f"{s:.4f}" for s in r["reference_shares"])
                p["summary"] = (
                    f"4096² label agreement with the reference "
                    f"{r['agreement']:.7f}, {r['differing']} px differ "
                    f"(floor {floor}); reference class shares [{shares}]"
                )
    with phase("serve") as p:
        p["summary"] = (f"{serve_phase(model)} raw-pixel requests equal "
                        "annonet_infer")
    return device


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the four-GPU data-parallel and tile-parallel check",
    )
    parser.add_argument(
        "--out", default=os.path.join(
            os.path.dirname(os.path.abspath(__file__)), ".chip_smoke"
        ),
        help="scratch directory for the dataset, artifact and results",
    )
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    try:
        device = run(args.out, args.four_cards)
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        return 1
    _print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
