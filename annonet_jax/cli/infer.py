"""annonet_infer: run tiled inference over a directory of images.

Flag parity with the reference (annonet_infer_main.cpp:309-337), including
`-h` meaning --tile-max-height (help is --help only, as in cxxopts where -h
was taken). The flow matches annonet_infer_main.cpp:283-532: deserialize the
self-describing model, spawn full-image reader threads and result-image
writer threads around the sequential per-image inference loop, accumulate
per-pixel and per-region confusion matrices when ground truth exists, write
<image>_result.png color masks upscaled to the original size, and print the
timing report (total; average/max excluding the first, compile-warm-up,
image).

The default tile size is auto: 1024, the reference's default on its CUDA
build (annonet_infer_main.cpp:300-307; 4096 on its CPU build). Tune with
-w/-h, or let --plan-autotune measure the neighbouring plans.
"""

from __future__ import annotations

import argparse
import os
import queue
import sys
import threading
import time

from annonet_jax.cli._parser import ReferenceParser


def build_parser() -> argparse.ArgumentParser:
    p = ReferenceParser(
        prog="annonet_infer",
        description="Do inference using trained semantic-segmentation networks",
        add_help=False,
    )
    p.add_argument("--help", action="help")
    p.add_argument("input_directory_positional", nargs="?", metavar="input-directory")
    p.add_argument("-i", "--input-directory", dest="input_directory")
    p.add_argument("-g", "--gain", action="append", default=[],
                   help="Supply a class-specific gain, for example: 1:-0.5")
    p.add_argument("-d", "--detection", action="append", default=[],
                   help="Supply a class-specific detection level that _comes on top of gain_, for example: 1:1.5")
    p.add_argument("-w", "--tile-max-width", type=int, default=None,
                   help="Max tile width (default: auto — 1024, the "
                        "reference's CUDA default)")
    p.add_argument("-h", "--tile-max-height", type=int, default=None,
                   help="Max tile height (default: auto, like -w)")
    p.add_argument("--full-image-reader-thread-count", type=int,
                   default=os.cpu_count() or 1)
    p.add_argument("--result-image-writer-thread-count", type=int,
                   default=os.cpu_count() or 1)
    p.add_argument("--model", default="annonet.dnn",
                   help="Model artifact path (reference name: annonet.dnn)")
    p.add_argument("--device", "--primary-cuda-device", dest="device",
                   type=int, default=None, help="Device (GPU) index")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Capture a jax.profiler trace of the inference loop")
    p.add_argument("--report-json", default=None, metavar="PATH",
                   help="Write a machine-readable run report ("
                        "extension; printed output is unchanged): per-image "
                        "timings, the timing summary, and — when ground "
                        "truth exists — both confusion matrices with "
                        "per-class recall/precision and total accuracy")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="Images in flight on the device: the next image is "
                        "dispatched before the current result is read back "
                        "(1 = fully sequential like the reference). At "
                        "depth > 1 the per-image timing stats report "
                        "device-busy time (overlap with host work is not "
                        "double-counted)")
    p.add_argument("--image-batch", type=int, default=1, metavar="N",
                   help="Forward up to N consecutive SAME-SIZE images as "
                        "one device batch (15x on 512px images: a lone "
                        "small image underfills the chip). Full groups "
                        "compile one exact-size program (any N is fine); "
                        "only the final remainder group is bucketed UP to "
                        "a power of two with replicated images. Per-image "
                        "results are numerically equivalent to unbatched "
                        "runs (bit-identical on the tested backends); "
                        "per-image timings become the batch average")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="Tile-parallel inference over an N-device "
                        "jax.sharding.Mesh: each image's tile batch is "
                        "sharded across the mesh (the spatial analog of "
                        "context parallelism)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="Multi-host batch inference: initialize "
                        "jax.distributed and shard the IMAGE LIST across "
                        "processes (process i infers images i, i+P, ... "
                        "of the scan order and writes their result PNGs). "
                        "Confusion matrices and timing are merged at the "
                        "end; process 0 prints them and writes "
                        "--report-json. Pass process 0's host:port on "
                        "every host (+ --num-processes/--process-id), or "
                        "'auto' where JAX detects the cluster. Does not compose with --mesh "
                        "(tile-parallel is the in-process axis)")
    p.add_argument("--num-processes", type=int, default=None, metavar="P",
                   help="Total process (host) count for --coordinator")
    p.add_argument("--process-id", type=int, default=None, metavar="I",
                   help="This process's index (0..P-1) for --coordinator")
    p.add_argument("--no-compilation-cache", action="store_true",
                   help="Disable the persistent XLA compilation cache "
                        "(JAX_COMPILATION_CACHE_DIR if set, else .jax_cache "
                        "in the checkout)")
    p.add_argument("--quantize", choices=["none", "int8"], default="none",
                   help="Quantized inference (extension): int8 runs the "
                        "conv stack in int8 with int32 accumulation, "
                        "calibrated on the first image (see "
                        "--calibration-images; the first image is assumed "
                        "representative of the directory's exposure range); "
                        "label maps may differ from the float path on "
                        "near-tie pixels (accuracy floors are covered by "
                        "tests). An activation clip-saturation figure is "
                        "printed after the run")
    p.add_argument("--reference-blend-semantics", action="store_true",
                   help="Compat mode: compare per-class gains (-g) and "
                        "detection levels (-d) against the UNNORMALIZED "
                        "ramp-sum blend accumulation inside tile-overlap "
                        "bands, exactly like the reference "
                        "(annonet_infer.cpp:146-161,176-185,205-211), "
                        "instead of normalizing first. Use when carrying "
                        "gains/levels tuned on a reference deployment. "
                        "Identical output when all gains and levels are "
                        "zero (PARITY.md)")
    p.add_argument("--calibration-images", type=int, default=1, metavar="N",
                   help="Spread int8 activation calibration over the first "
                        "N images (with --quantize int8): per-channel "
                        "maxima accumulate across them, pre-freeze images "
                        "run the exact float path, and quantization "
                        "freezes on image N. With --image-batch > 1 the "
                        "granularity is the batch: the whole batch "
                        "containing image N (including its earlier images) "
                        "runs quantized. Raise for directories whose first "
                        "image is unrepresentative (dark, low-contrast)")
    p.add_argument("--plan-autotune", action="store_true",
                   help="Measured tile-plan selection (extension): on "
                        "the first image of each canvas size, compile the "
                        "default tile plan AND its neighbouring grid "
                        "counts, time each on the device, and use the "
                        "fastest for the rest of the run. Per-shape conv "
                        "rates are non-monotonic in tile size, so this "
                        "rescues canvas sizes where the static default "
                        "sits on a slow shape — at the cost of one extra "
                        "20-40 s compile per candidate per canvas size. "
                        "Chosen plans are printed after the run")
    p.add_argument("--blend-dtype", choices=["auto", "float32", "bfloat16"],
                   default="auto",
                   help="Accumulation dtype of the tile-blend epilogue. "
                        "auto = bfloat16 iff --quantize int8 (half the "
                        "bytes per blend pass; the int8 path is already "
                        "non-bit-exact), float32 otherwise. Pin float32 "
                        "to make the int8 path's blending match the "
                        "float path's bit-for-bit")
    p.add_argument("--calibration", default=None, metavar="PATH",
                   help="Load persisted int8 activation calibration "
                        "(written by --save-calibration): skips runtime "
                        "calibration so EVERY image (including the first) "
                        "runs int8, reproducibly across runs")
    p.add_argument("--save-calibration", default=None, metavar="PATH",
                   help="After the run, persist the frozen int8 "
                        "calibration maxima for --calibration / "
                        "annonet_serve --calibration. Under "
                        "--coordinator the maxima are merged across ALL "
                        "processes (element-wise max over each rank's "
                        "calibrated images) and process 0 writes the file")
    return p


def main(argv=None) -> int:
    from annonet_jax.cli.common import apply_platform_env

    apply_platform_env()  # ANNONET_PLATFORM=cpu pins the backend
    if argv is None:
        argv = sys.argv[1:]
    if not argv:
        # argc == 1: usage to stdout, exit 1 (annonet_infer_main.cpp:285-293)
        print("You call this program like this: ")
        print("./annonet_infer /path/to/image/data")
        print()
        print("You will also need a trained 'annonet.dnn' file. ")
        print()
        return 1

    parser = build_parser()
    try:
        args = parser.parse_args(argv)
        input_directory = (
            args.input_directory or args.input_directory_positional
        )
        if not input_directory:
            parser.error("Option 'input-directory' is required but not present")
    except SystemExit as e:
        return int(e.code or 0)
    # Top-level catch: print the message and exit 1, parity with the
    # reference's catch(std::exception&) wrapper at the tail of
    # annonet_infer_main.cpp (no traceback, threads shut down in _run's
    # finally block).
    try:
        return _run(args, input_directory)
    except Exception as e:  # noqa: BLE001
        from annonet_jax.cli.common import exit_on_peer_failure

        # a dead PEER surfaces here as a gloo/coordination error (the
        # merge all-gather, or any sharded-batch collective): report and
        # leave before the coordination client's async process abort
        exit_on_peer_failure(e, bool(getattr(args, "coordinator", None)))
        print(e)
        if getattr(args, "coordinator", None):
            # a rank-local failure leaves peers blocked in the final
            # merge all-gather until this death severs their transport
            print(
                "multi-host: this rank is exiting; peer processes may "
                "block in the final merge. Restart the job on every host."
            )
        return 1


def _run(args, input_directory) -> int:
    # ExitStack scopes the optional select_device context to this call, so
    # library embedders calling main() repeatedly don't leak device
    # contexts (they were previously entered and never exited).
    import contextlib

    with contextlib.ExitStack() as stack:
        return _run_impl(args, input_directory, stack)


def _run_impl(args, input_directory, stack) -> int:
    print(f"Input directory = {input_directory}")

    if not args.no_compilation_cache:
        from annonet_jax.cli.common import enable_compilation_cache

        enable_compilation_cache()

    import numpy as np

    from annonet_jax import serialization
    from annonet_jax.classes import parse_anno_classes
    from annonet_jax.cli.common import parse_class_specific_values, select_device
    from annonet_jax.data.codec import index_label_image_to_rgba_label_image
    from annonet_jax.data.dataset import find_image_files
    from annonet_jax.data.sample import read_sample, resize_label_image
    from annonet_jax.infer.core import TiledInferer, detection_veto
    from annonet_jax.infer.evaluation import (
        format_confusion_matrix,
        new_confusion_matrix,
        update_confusion_matrix_per_pixel,
        update_confusion_matrix_per_region,
    )
    from annonet_jax.infer.tiling import TilingParameters
    from annonet_jax.models.segnet import required_input_dimension

    runtime_params, model_config, anno_classes_json, downscaling_factor = (
        serialization.load_model(args.model)
    )
    print(f"Deserializing annonet, downscaling factor = {downscaling_factor:g}")
    anno_classes = parse_anno_classes(anno_classes_json)
    assert len(anno_classes) >= 2

    # Format errors here raise ValueError and reach main()'s outer catch:
    # message to stdout, exit 1 — the reference's std::runtime_error from
    # parse_class_specific_value (annonet_infer_main.cpp:36-63) is thrown
    # after cxxopts parsing, so it hits the outer catch, not the exit-2
    # parse-error path.
    gains = parse_class_specific_values(args.gain, len(anno_classes))
    detection_levels = parse_class_specific_values(
        args.detection, len(anno_classes), require_non_negative=True
    )

    print("Using gains:", " ".join(
        f"{i}:{g:g}" for i, g in enumerate(gains)))
    print("Using detection levels:", " ".join(
        f"{i}:{d:g}" for i, d in enumerate(detection_levels)))

    # Multi-host bootstrap (--coordinator) must precede everything that
    # initializes the JAX backend. Batch inference over a directory is
    # embarrassingly parallel, so the multi-host axis is the IMAGE LIST
    # (process i takes images i, i+P, ...) — each process runs its own
    # single-process tiled inference; only the final confusion/timing
    # merge is a collective (which doubles as the exit barrier).
    multihost = bool(args.coordinator)
    proc_id, nproc = 0, 1
    if multihost:
        if args.mesh:
            raise RuntimeError(
                "--coordinator shards images across processes and does "
                "not compose with --mesh (tile-parallel inference is the "
                "in-process axis; for cross-host serving see "
                "docs/SERVING.md)"
            )
        from annonet_jax.parallel.mesh import initialize_distributed

        proc_id, nproc = initialize_distributed(
            args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
        print(f"Multi-host inference: process {proc_id} of {nproc}")
    io_process = proc_id == 0

    # Ordering: --mesh's virtual-device flags first (no backend init),
    # then the device probe — the process's FIRST backend init happens
    # inside its bounded thread, so a wedged runtime exits 1 with triage
    # text instead of hanging in jax.devices()/mesh construction — and
    # only then mesh construction and --device selection (instant once
    # the probe has initialized the backend).
    from annonet_jax.cli.common import device_probe, prepare_mesh_flags

    if args.mesh:
        prepare_mesh_flags(args.mesh)
    # multi-process backend init legitimately takes longer (pod-scale
    # client setup), so the wedge threshold defaults higher there
    device_probe(
        timeout_s=(
            float(os.environ.get("ANNONET_DEVICE_PROBE_TIMEOUT", "600"))
            if multihost else None
        ),
        device_index=args.device,
    )

    mesh = None
    if args.mesh:
        from annonet_jax.cli.common import make_cli_mesh

        mesh = make_cli_mesh(args.mesh)

    if args.device is not None:
        stack.enter_context(select_device(args.device))

    # resolve the auto tile default only now: default_tile_max initializes
    # the backend, which must come after mesh setup / --device
    if args.tile_max_width is None or args.tile_max_height is None:
        from annonet_jax.cli.common import default_tile_max

        auto_tile = default_tile_max()
        if args.tile_max_width is None:
            args.tile_max_width = auto_tile
        if args.tile_max_height is None:
            args.tile_max_height = auto_tile

    min_input_dimension = required_input_dimension(model_config)
    if args.tile_max_width < min_input_dimension or args.tile_max_height < min_input_dimension:
        # DLIB_CASSERT at annonet_infer_main.cpp:429-430 throws -> outer
        # catch -> message + exit 1
        raise RuntimeError(f"Tile size must be at least {min_input_dimension}")
    tiling = TilingParameters(
        max_tile_width=args.tile_max_width,
        max_tile_height=args.tile_max_height,
        overlap_x=min_input_dimension,
        overlap_y=min_input_dimension,
    )
    if args.calibration_images < 1:
        raise RuntimeError("--calibration-images must be >= 1")
    if (args.calibration or args.save_calibration) and args.quantize != "int8":
        raise RuntimeError(
            "--calibration/--save-calibration require --quantize int8"
        )
    calibration = None
    if args.calibration:
        calibration = serialization.load_calibration(
            args.calibration, model_config, runtime_params
        )
        print(f"Loaded int8 calibration from {args.calibration}")
    inferer = TiledInferer(
        runtime_params, model_config, tiling,
        quantize=None if args.quantize == "none" else args.quantize,
        calibration_images=args.calibration_images,
        calibration=calibration,
        blend_dtype=(None if args.blend_dtype == "auto"
                     else args.blend_dtype),
        reference_blend_semantics=args.reference_blend_semantics,
        mesh=mesh,
        plan_autotune=args.plan_autotune,
    )

    files = find_image_files(input_directory, require_ground_truth=False)
    total_image_count = len(files)
    if multihost:
        # every process runs the identical scan (shared filesystem, the
        # same deterministic order — the contract --coordinator training
        # already relies on), then keeps its stride-P shard
        files = files[proc_id::nproc]
        print(
            f"images in dataset: {total_image_count}; this process infers "
            f"{len(files)} (stride {nproc} from {proc_id})"
        )

    # ---- reader threads: paths -> samples (annonet_infer_main.cpp:382-401).
    # Each result is tagged with its file index and the consumer reorders,
    # so images are always processed in find_image_files order regardless
    # of reader-thread count (the reference's sequential loop order).
    read_requests: "queue.Queue" = queue.Queue()
    for index, f in enumerate(files):
        read_requests.put((index, f))
    reader_count = max(1, args.full_image_reader_thread_count)
    read_results: "queue.Queue" = queue.Queue(maxsize=reader_count)
    stop = threading.Event()
    # Read-ahead window: readers take a new request only when fewer than
    # `window` samples are taken-but-unconsumed. Without it, one slow image
    # at the next in-order index would let the other readers decode ahead
    # through the whole file list into the consumer's reorder buffer
    # (full decoded images — unbounded memory). Requests are taken in index
    # order, so the needed index is always within the window: no deadlock.
    read_ahead = threading.Semaphore(
        reader_count
        + max(1, args.pipeline_depth) * max(1, args.image_batch)
        + 2
    )

    def reader():
        while not stop.is_set():
            if not read_ahead.acquire(timeout=0.1):
                continue
            try:
                index, filenames = read_requests.get_nowait()
            except queue.Empty:
                read_ahead.release()
                return
            read_results.put(
                (
                    index,
                    read_sample(
                        filenames,
                        anno_classes,
                        require_ground_truth=False,
                        downscaling_factor=downscaling_factor,
                        grayscale=model_config.grayscale,
                    ),
                )
            )

    readers = [threading.Thread(target=reader, daemon=True)
               for _ in range(reader_count)]
    for t in readers:
        t.start()

    from annonet_jax.cli.common import IndexOrderedResults

    ordered_samples = IndexOrderedResults(read_results)

    # ---- writer threads: results -> PNGs (annonet_infer_main.cpp:403-419)
    writer_count = max(1, args.result_image_writer_thread_count)
    write_requests: "queue.Queue" = queue.Queue(maxsize=writer_count)
    write_results: "queue.Queue" = queue.Queue()

    def writer():
        from annonet_jax.data.sample import save_png_rgba

        while True:
            item = write_requests.get()
            if item is None:
                return
            filename, original_w, original_h, label_image = item
            try:
                label_image = resize_label_image(
                    label_image, original_w, original_h
                )
                rgba = index_label_image_to_rgba_label_image(
                    label_image, anno_classes
                )
                save_png_rgba(filename, rgba)
                write_results.put(True)
            except Exception as e:  # noqa: BLE001
                write_results.put(e)

    writers = [threading.Thread(target=writer, daemon=True)
               for _ in range(writer_count)]
    for t in writers:
        t.start()

    from annonet_jax.utils import profiler_trace, set_low_priority

    set_low_priority()  # annonet_infer_main.cpp:375

    per_image_records: list = []
    confusion_matrix_per_pixel = new_confusion_matrix(len(anno_classes))
    confusion_matrix_per_region = new_confusion_matrix(len(anno_classes))
    ground_truth_count = 0

    t0 = time.monotonic()
    total_inference = 0.0
    total_inference_excl_first = 0.0
    max_inference_excl_first = 0.0
    excl_first_count = 0

    profile_ctx = profiler_trace(args.profile)
    profile_ctx.__enter__()

    # The device pipeline: the next image's tiled forward is dispatched
    # before the previous image's labels are read back, so device compute
    # overlaps the host's readback/blob-veto/confusion work. Depth 1
    # reproduces the reference's strictly sequential loop
    # (annonet_infer_main.cpp:440-494).
    import collections

    in_flight = collections.deque()
    pipeline_depth = max(1, args.pipeline_depth)
    image_batch = max(1, args.image_batch)
    completed = 0
    dispatched = 0
    pending_sample = [None]  # one-sample pushback for size-group breaks
    last_image = [None]  # most recent pixels, for int8 saturation telemetry

    def next_sample():
        if pending_sample[0] is not None:
            sample, pending_sample[0] = pending_sample[0], None
            return sample
        sample = ordered_samples.next()
        read_ahead.release()  # one consumed -> one more may be read ahead
        if sample.error:
            raise RuntimeError(sample.error)
        return sample

    def dispatch_group():
        # up to --image-batch CONSECUTIVE same-size images share one
        # forward (TiledInferer.infer_arrays_batch); a size change closes
        # the group (the odd sample is pushed back, order preserved)
        nonlocal dispatched
        group = [next_sample()]
        dispatched += 1
        shape = group[0].input_image.shape
        while len(group) < image_batch and dispatched < len(files):
            sample = next_sample()
            if sample.input_image.shape != shape:
                pending_sample[0] = sample
                break
            group.append(sample)
            dispatched += 1
        t_start = time.monotonic()
        if len(group) == 1:
            labels_dev, seeds_dev = inferer.infer_arrays(
                group[0].input_image, gains, detection_levels,
                device_output=True,
            )
        else:
            # full groups recur for the whole directory -> compile one
            # EXACT-size program (no padded compute even for odd
            # --image-batch values); the final remainder group pads up to
            # that already-compiled size instead of paying a fresh
            # power-of-two compile for a one-off batch
            labels_dev, seeds_dev = inferer.infer_arrays_batch(
                np.stack([s.input_image for s in group]),
                gains, detection_levels, device_output=True,
                pad_to_bucket=(
                    False if len(group) == image_batch else image_batch
                ),
            )
        in_flight.append((group, labels_dev, seeds_dev, t_start))

    # End of the previous group's measured interval, for the device-busy
    # timing at pipeline depth > 1 (see complete_group).
    prev_group_done = [None]
    completed_groups = [0]

    def complete_group():
        nonlocal total_inference, total_inference_excl_first
        nonlocal max_inference_excl_first, ground_truth_count, completed
        nonlocal excl_first_count
        group, labels_dev, seeds_dev, t_start = in_flight.popleft()
        labels_np = np.asarray(labels_dev)
        seeds_np = None if seeds_dev is None else np.asarray(seeds_dev)
        t_done = time.monotonic()
        # The reference times each annonet_infer call strictly sequentially
        # (annonet_infer_main.cpp:466-480). With groups in flight, wall time
        # from dispatch to readback would double-count overlap, so charge
        # each group only the interval after the previous group finished:
        # the device executes groups in dispatch order, so
        # t_done - max(t_start, prev_done) is this group's device-busy time
        # (+ readback). At --pipeline-depth 1 this reduces exactly to
        # t_done - t_start, the reference's sequential measure.
        if prev_group_done[0] is None:
            duration = t_done - t_start
        else:
            duration = t_done - max(t_start, prev_group_done[0])
        prev_group_done[0] = t_done
        first_group = completed_groups[0] == 0
        completed_groups[0] += 1
        share = duration / len(group)
        for j, sample in enumerate(group):
            h, w = sample.input_image.shape[:2]
            sel = (j,) if len(group) > 1 else ()
            labels = labels_np[sel + (slice(0, h), slice(0, w))].astype(
                np.int32
            )
            seeds = (
                None if seeds_np is None
                else seeds_np[sel + (slice(0, h), slice(0, w))]
            )
            result = detection_veto(labels, seeds)
            if args.report_json:
                per_image_records.append(
                    {
                        "image": sample.image_filenames.image_filename,
                        "width": sample.original_width,
                        "height": sample.original_height,
                        "milliseconds": round(share * 1000.0, 3),
                        "first_group": first_group,
                    }
                )
            total_inference += share
            # The whole first group is excluded from the excl-first stats:
            # the reference excludes the first (compile/warm-up) image
            # (annonet_infer_main.cpp:475-480), and with --image-batch > 1
            # every image of the first dispatched group shares that one-time
            # cost, so none of them reflects steady state.
            if not first_group:
                total_inference_excl_first += share
                max_inference_excl_first = max(
                    max_inference_excl_first, share
                )
                excl_first_count += 1

            ground_truth_count += update_confusion_matrix_per_pixel(
                confusion_matrix_per_pixel,
                sample.labeled_points_by_class,
                result,
            )
            if sample.label_image is not None:
                update_confusion_matrix_per_region(
                    confusion_matrix_per_region,
                    sample.labeled_points_by_class,
                    sample.label_image,
                    result,
                )
            write_requests.put(
                (
                    sample.image_filenames.image_filename + "_result.png",
                    sample.original_width,
                    sample.original_height,
                    result,
                )
            )
            last_image[0] = sample.input_image
            completed += 1

    try:
        while dispatched < len(files):
            dispatch_group()
            print(f"\rProcessing image {dispatched} of {len(files)}...",
                  end="", flush=True)
            if len(in_flight) >= pipeline_depth:
                complete_group()
        while in_flight:
            complete_group()

        profile_ctx.__exit__(None, None, None)
        t1 = time.monotonic()
        print(f"\nAll {len(files)} images processed in {t1 - t0:.3f} seconds!"
              f" (actual inference: {total_inference:.6f} seconds)")
        if len(files) > 1 and excl_first_count > 0:
            print(
                "Processing time excluding the first image: "
                f"average = {total_inference_excl_first * 1000.0 / excl_first_count:.3f} ms, "
                f"max = {max_inference_excl_first * 1000.0:.3f} ms"
            )

        for _ in range(completed):
            ok = write_results.get()
            if isinstance(ok, Exception):
                raise ok
        print("All result images written!")

        if args.plan_autotune:
            for key, report in sorted(inferer.autotune_reports.items()):
                parts = ", ".join(
                    f"{p.tile_height}x{p.tile_width}x{p.tile_count}"
                    + (f" = {r:.1f} Mpx/s" if r else "")
                    for p, r in report
                )
                print(
                    f"Plan autotune for canvas {key[0]}x{key[1]}: "
                    f"chose {parts.split(',')[0].strip()} "
                    f"(candidates: {parts})"
                )

        if args.quantize == "int8" and last_image[0] is not None:
            # clip-saturation telemetry: how far the LAST image's
            # activations exceed the frozen calibration range (>~1.2x
            # suggests the calibration images were unrepresentative —
            # rerun with a larger --calibration-images)
            overshoot = inferer.calibration_overshoot(last_image[0])
            if overshoot > 0.0:
                print(
                    "int8 calibration: "
                    f"{inferer.calibration_images} image(s); activation "
                    f"range overshoot on the last image = {overshoot:.2f}x"
                    + (" (consider raising --calibration-images)"
                       if overshoot > 1.2 else "")
                )
        if args.save_calibration and multihost:
            # deferred: the maxima are merged across ranks after the
            # final allgather barrier (below), then process 0 writes
            pass
        elif args.save_calibration:
            exported = inferer.export_calibration()
            if exported is None:
                print("No int8 net was frozen; nothing to save "
                      "(fewer images than --calibration-images?)")
            else:
                serialization.save_calibration(
                    args.save_calibration, exported, model_config,
                    runtime_params,
                )
                print(f"Saved int8 calibration to {args.save_calibration}")
    finally:
        # Clean shutdown on success AND error: stop readers (draining
        # read_results so none stays blocked on a full queue), then send
        # writer sentinels and join everything.
        stop.set()
        while any(t.is_alive() for t in readers):
            try:
                read_results.get(timeout=0.05)
            except queue.Empty:
                pass
        for _ in writers:
            write_requests.put(None)
        for t in writers:
            t.join(timeout=5.0)
        for t in readers:
            t.join(timeout=5.0)

    wall_seconds = t1 - t0
    if multihost:
        # Merge the shard-local results across processes. ONE allgather
        # carries everything (scalars + both flattened matrices) and also
        # serves as the exit barrier: no rank leaves while another still
        # computes or writes. Counts survive the float64 ride exactly
        # (they are far below 2^53).
        from jax.experimental import multihost_utils

        k2 = confusion_matrix_per_pixel.size
        scalars = np.asarray(
            [
                float(ground_truth_count),
                total_inference,
                total_inference_excl_first,
                float(excl_first_count),
                max_inference_excl_first,
                wall_seconds,
            ],
            np.float64,
        )
        gathered = np.asarray(
            multihost_utils.process_allgather(
                np.concatenate(
                    [
                        scalars,
                        confusion_matrix_per_pixel.astype(np.float64).ravel(),
                        confusion_matrix_per_region.astype(
                            np.float64
                        ).ravel(),
                    ]
                )
            )
        ).reshape(nproc, 6 + 2 * k2)
        ground_truth_count = int(gathered[:, 0].sum())
        total_inference = float(gathered[:, 1].sum())
        total_inference_excl_first = float(gathered[:, 2].sum())
        excl_first_count = int(gathered[:, 3].sum())
        max_inference_excl_first = float(gathered[:, 4].max())
        wall_seconds = float(gathered[:, 5].max())
        shape = confusion_matrix_per_pixel.shape
        dtype = confusion_matrix_per_pixel.dtype
        confusion_matrix_per_pixel = (
            gathered[:, 6 : 6 + k2].sum(axis=0).astype(dtype).reshape(shape)
        )
        confusion_matrix_per_region = (
            gathered[:, 6 + k2 :].sum(axis=0).astype(dtype).reshape(shape)
        )
        if io_process:
            print(
                f"\nCluster totals: {total_image_count} images across "
                f"{nproc} processes in {wall_seconds:.3f} seconds "
                f"(summed device inference: {total_inference:.6f} seconds)"
            )
            if excl_first_count > 0:
                print(
                    "Cluster processing time excluding each process's "
                    "first image: average = "
                    f"{total_inference_excl_first * 1000.0 / excl_first_count:.3f} ms, "
                    f"max = {max_inference_excl_first * 1000.0:.3f} ms"
                )

        if args.save_calibration:
            # Merge each rank's activation maxima (element-wise max of
            # the per-layer, per-REAL-channel vectors) so the saved file
            # covers the WHOLE directory, not just one rank's shard
            # (each rank calibrates on the first --calibration-images
            # images of its own shard; partial accumulations below the
            # budget contribute too — more images only widen maxima).
            # Every rank joins the fixed-shape allgather: shard-empty
            # ranks contribute zeros (the identity for the max of
            # post-ReLU maxima), and a trailing flag counts contributing
            # ranks so "no rank calibrated" stays distinguishable from
            # all-zero activations.
            # args.save_calibration without --quantize int8 cannot reach
            # here: the upfront validation raises (see "--calibration/
            # --save-calibration require --quantize int8" above), so the
            # "fewer images than --calibration-images?" hint below is
            # accurate — every rank really was int8-calibrating.
            lengths = inferer.calibration_layer_shapes()
            local = inferer.export_calibration(partial=True)
            if lengths is None:
                if io_process:
                    print("No int8 net was frozen; nothing to save "
                          "(this config cannot fold to int8)")
            else:
                flat = np.zeros(sum(lengths) + 1, np.float64)
                if local is not None:
                    flat[:-1] = np.concatenate(
                        [np.asarray(v, np.float64).ravel() for v in local]
                        or [np.zeros(0, np.float64)]
                    )
                    flat[-1] = 1.0
                ranks = np.asarray(
                    multihost_utils.process_allgather(flat)
                ).reshape(nproc, -1)
                contributed = int(ranks[:, -1].sum())
                if contributed == 0:
                    if io_process:
                        print("No int8 net was frozen; nothing to save "
                              "(fewer images than --calibration-images?)")
                elif io_process:
                    merged_flat = (
                        ranks[:, :-1].max(axis=0).astype(np.float32)
                    )
                    merged, off = [], 0
                    for n in lengths:
                        merged.append(merged_flat[off:off + n])
                        off += n
                    serialization.save_calibration(
                        args.save_calibration, merged, model_config,
                        runtime_params,
                    )
                    print(
                        f"Saved int8 calibration to "
                        f"{args.save_calibration} (maxima merged across "
                        f"{contributed} of {nproc} processes)"
                    )

    if ground_truth_count and io_process:
        print("\nConfusion matrix per pixel:")
        print(format_confusion_matrix(confusion_matrix_per_pixel, anno_classes))
        print("\nConfusion matrix per region (two-way):")
        print(format_confusion_matrix(confusion_matrix_per_region, anno_classes))

    if args.report_json and not io_process:
        print(
            "Multi-host: only process 0 writes --report-json "
            "(it holds the merged matrices and timing)"
        )
    if args.report_json and io_process:
        import json

        from annonet_jax.infer.evaluation import confusion_matrix_summary

        report = {
            "model": args.model,
            "input_directory": input_directory,
            # global count; under --coordinator the per_image list covers
            # only THIS process's shard (each rank reads/writes its own
            # images), while matrices/timing aggregates are cluster-wide
            "images": total_image_count,
            "processes": nproc,
            "quantize": args.quantize,
            "image_batch": image_batch,
            "pipeline_depth": pipeline_depth,
            "gains": [float(g) for g in gains],
            "detection_levels": [float(d) for d in detection_levels],
            "wall_seconds": round(wall_seconds, 6),
            "inference_seconds": round(total_inference, 6),
            "excluding_first": (
                {
                    "average_ms": round(
                        total_inference_excl_first * 1000.0
                        / excl_first_count, 3
                    ),
                    "max_ms": round(max_inference_excl_first * 1000.0, 3),
                    "count": excl_first_count,
                }
                if excl_first_count > 0 else None
            ),
            "per_image": per_image_records,
            "confusion_per_pixel": (
                confusion_matrix_summary(
                    confusion_matrix_per_pixel, anno_classes
                )
                if ground_truth_count else None
            ),
            "confusion_per_region": (
                confusion_matrix_summary(
                    confusion_matrix_per_region, anno_classes
                )
                if ground_truth_count else None
            ),
        }
        with open(args.report_json, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=1)
            fh.write("\n")
        print(f"Report written to {args.report_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
