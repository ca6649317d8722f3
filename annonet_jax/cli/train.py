"""annonet_train: train semantic-segmentation networks on anno data.

Flag-for-flag CLI parity with the reference trainer
(annonet_train_main.cpp:276-311): every runtime flag keeps its reference
name and default. The reference's two compile-time knobs become runtime
flags here (SURVEY.md §5):

  --level-count     (was DLIB_DNN_PIMPL_WRAPPER_LEVEL_COUNT, appveyor.yml)
  --grayscale       (was DLIB_DNN_PIMPL_WRAPPER_GRAYSCALE_INPUT)

and --primary-cuda-device is carried over as an alias of --device (GPU
index).

Outputs keep the reference contract: the self-describing deployable model
``annonet.dnn`` (class JSON + combined downscaling factor + BN-folded
inference net, annonet_train_main.cpp:557-565) saved every --save-interval
minibatches and at exit, and the trainer synchronization state
``annonet_trainer_state_file.dat`` written every 10 minutes and auto-resumed
(annonet_train_main.cpp:403).
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

from annonet_jax.cli._parser import ReferenceParser


def build_parser() -> argparse.ArgumentParser:
    p = ReferenceParser(
        prog="annonet_train",
        description="Train semantic-segmentation networks using data generated in anno",
    )
    p.add_argument("input_directory_positional", nargs="?", metavar="input-directory")
    p.add_argument("-i", "--input-directory", dest="input_directory")
    p.add_argument("-d", "--initial-downscaling-factor", type=float, default=1.0,
                   help="The initial downscaling factor (>= 1.0)")
    p.add_argument("-f", "--further-downscaling-factor", type=float, default=1.0,
                   help="The further downscaling factor (>= 1.0)")
    p.add_argument("-u", "--allow-flip-upside-down", action="store_true",
                   help="Randomly flip input images upside down")
    p.add_argument("-l", "--allow-flip-left-right", action="store_true",
                   help="Randomly flip input images horizontally")
    p.add_argument("--multiplicative-brightness-change-probability",
                   type=float, default=0.0)
    p.add_argument("--multiplicative-brightness-change-sigma",
                   type=float, default=0.1)
    p.add_argument("-n", "--noise-level-stddev", type=float, default=0.0,
                   help="Set the standard deviation of the noise to add")
    p.add_argument("-o", "--allow-random-color-offset", action="store_true",
                   help="Randomly apply color offsets")
    p.add_argument("--ignore-class", type=int, action="append", default=[],
                   help="Ignore specific classes by index")
    p.add_argument("--ignore-large-nonzero-regions-by-area", type=float,
                   default=math.inf)
    p.add_argument("--ignore-large-nonzero-regions-by-width", type=float,
                   default=math.inf)
    p.add_argument("--ignore-large-nonzero-regions-by-height", type=float,
                   default=math.inf)
    p.add_argument("--class-weight", type=float, default=0.5,
                   help="Try 0.0 for equally balanced pixels, and 1.0 for equally balanced classes")
    p.add_argument("--image-weight", type=float, default=0.5,
                   help="Try 0.0 for equally balanced pixels, and 1.0 for equally balanced images")
    p.add_argument("-b", "--minibatch-size", type=int, default=100)
    p.add_argument("--input-dimension-multiplier", type=float, default=3.0,
                   help="Size of input patches, relative to minimum required")
    p.add_argument("--net-width-scaler", type=float, default=1.0)
    p.add_argument("--net-width-min-filter-count", type=int, default=1)
    p.add_argument("--initial-learning-rate", type=float, default=0.1)
    p.add_argument("--learning-rate-shrink-factor", type=float, default=0.1)
    p.add_argument("--min-learning-rate", type=float, default=1e-6)
    p.add_argument("--save-interval", type=int, default=1000,
                   help="Save the resulting inference network every this many steps")
    p.add_argument("-t", "--relative-training-length", type=float, default=2.0)
    p.add_argument("--max-total-steps", type=int, default=None)
    p.add_argument("-c", "--cached-image-count", type=int, default=8)
    p.add_argument("--data-loader-thread-count", type=int,
                   default=os.cpu_count() or 1)
    p.add_argument("--deterministic-data", action="store_true",
                   help="Draw the crop-decision stream from a single "
                        "deterministic generator, independent of "
                        "--data-loader-thread-count (the other loader "
                        "threads become decode prefetchers, so decode "
                        "still runs in parallel). Forced on by "
                        "--coordinator: every process must compute the "
                        "identical stream")
    p.add_argument("--no-empty-label-image-warning", action="store_true")
    p.add_argument("--device", "--primary-cuda-device", dest="device",
                   type=int, default=None, help="Device (GPU) index")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="Train data-parallel over an N-device "
                        "jax.sharding.Mesh (sync-BN DP; minibatch is "
                        "rounded up to a multiple of N)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="Multi-host training: initialize "
                        "jax.distributed across processes before building "
                        "the --mesh (which must then equal the GLOBAL "
                        "device count). Every process runs this same "
                        "command against the same dataset with the same "
                        "seed, differing only in --process-id; gradients "
                        "and sync-BN statistics all-reduce across hosts. "
                        "'auto' uses JAX's cluster detection "
                        "(no --num-processes/--process-id needed)")
    p.add_argument("--num-processes", type=int, default=None, metavar="P",
                   help="Total process (host) count for --coordinator")
    p.add_argument("--process-id", type=int, default=None, metavar="I",
                   help="This process's index (0..P-1) for --coordinator; "
                        "process 0 writes the model/sync/metrics files")
    # runtime versions of the reference's compile-time knobs
    p.add_argument("--level-count", type=int, default=2,
                   help="Downsampling level count (was DLIB_DNN_PIMPL_WRAPPER_LEVEL_COUNT)")
    p.add_argument("--grayscale", action="store_true",
                   help="Grayscale input (was DLIB_DNN_PIMPL_WRAPPER_GRAYSCALE_INPUT)")
    p.add_argument("--output", default="annonet.dnn",
                   help="Model artifact path (reference name: annonet.dnn)")
    p.add_argument("--sync-file", default="annonet_trainer_state_file.dat")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Capture a jax.profiler trace of the training loop")
    p.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                   help="Append structured training metrics as JSON lines "
                        "(extension; printed output is unchanged): "
                        "per-step loss/LR events (downsampled to every "
                        "--metrics-interval'th recorded step), LR shrinks, "
                        "model saves, and start/done/error records")
    p.add_argument("--metrics-interval", type=int, default=100, metavar="N",
                   help="Keep every Nth recorded loss event in "
                        "--metrics-jsonl (default 100, the verbose print "
                        "cadence; 1 = every step)")
    p.add_argument("--validation-directory", default=None, metavar="DIR",
                   help="Evaluate the exported net on a held-out anno "
                        "directory after every model save ("
                        "extension): per-pixel accuracy and per-class "
                        "recall are printed and, with --metrics-jsonl, "
                        "recorded as validation events. Automates the "
                        "reference's manual train-then-annonet_infer "
                        "check; validation shares the chip, so training "
                        "pauses while it runs (tune --save-interval)")
    p.add_argument("--validation-quantize", choices=["none", "int8"],
                   default="none",
                   help="Run validation through the int8 quantized path "
                        "instead of the exact float path — validate what "
                        "an `annonet_infer --quantize int8` deployment "
                        "will serve (activation scales recalibrate on "
                        "the first validation image after each save)")
    p.add_argument("--remat", action="store_true",
                   help="Rematerialize activations in the backward pass "
                        "(fits larger minibatches; ~1/3 more compute)")
    p.add_argument("--int8-training", action="store_true",
                   help="Quantization-aware training: run the forward's "
                        "convs through int8 (dynamic symmetric scales) "
                        "while gradients flow through the exact bf16 conv "
                        "(straight-through). Trains the net under the same "
                        "grid noise annonet_infer --quantize adds, closing "
                        "the int8 deployment gap; ~9%% slower per step")
    p.add_argument("--no-compilation-cache", action="store_true",
                   help="Disable the persistent XLA compilation cache "
                        "(JAX_COMPILATION_CACHE_DIR if set, else .jax_cache "
                        "in the checkout)")
    p.add_argument("--device-image-cache", choices=["auto", "on", "off"],
                   default="auto",
                   help="Keep the decoded-image cache in device HBM and "
                        "extract crops on device, so each step uploads "
                        "~20 bytes/crop of indices instead of the crop "
                        "pixels (extension; the host LRU still owns "
                        "decode lifetimes). Under --mesh the pool is "
                        "replicated across the mesh and each device "
                        "gathers its shard of the batch. auto = on when "
                        "--further-downscaling-factor <= 1; off = always "
                        "upload pixels (reference-like)")
    p.add_argument("--loss-sync-interval", type=int, default=8,
                   help="Read device losses back every N steps (default 8). "
                        "dlib's dnn_trainer behind the reference's "
                        "StartTraining (annonet_train_main.cpp:609) runs "
                        "steps on its own thread and surfaces losses with a "
                        "lag, so batched readback matches its semantics; the "
                        "plateau detector sees losses up to 2N-1 steps late "
                        "(the flush lags a full interval so it never stalls "
                        "the in-flight pipeline). "
                        "1 = block per step (fully synchronous)")
    p.add_argument("--steps-per-dispatch", type=int, default=8,
                   help="lax.scan K train steps into ONE device dispatch "
                        "(device-image-cache path, single-device and "
                        "--mesh): amortizes per-dispatch host overhead "
                        "across K steps (scripts/ab_superstep.py measures "
                        "it); numerically equivalent to K "
                        "single dispatches (scan compilation may reorder "
                        "reductions). Losses are read back in K-sized "
                        "batches, so the plateau detector can see them up "
                        "to 2*max(K, --loss-sync-interval) steps late. "
                        "Disabled by --loss-sync-interval 1 (blocking "
                        "per-step losses win). 1 = one dispatch per step")
    return p


def main(argv=None) -> int:
    from annonet_jax.cli.common import apply_platform_env

    apply_platform_env()  # ANNONET_PLATFORM=cpu pins the backend
    if argv is None:
        argv = sys.argv[1:]
    if not argv:
        # argc == 1: usage to stdout, exit 1 (annonet_train_main.cpp:262-269)
        print("To run this program you need data annotated using the anno program.")
        print()
        print("You call this program like this: ")
        print("./annonet_train /path/to/anno/data")
        return 1

    parser = build_parser()
    try:
        args = parser.parse_args(argv)
        input_directory = (
            args.input_directory or args.input_directory_positional
        )
        if not input_directory:
            parser.error("Option 'input-directory' is required but not present")

        # The reference echoes these three lines inside the parse try-block
        # (annonet_train_main.cpp:322-328) before validating the factors, so
        # a validation failure still prints them, then the message + help to
        # stderr with exit 2 (:329-335).
        print(f"Input directory = {input_directory}")
        print(f"Initial downscaling factor = {args.initial_downscaling_factor:g}")
        print(f"Further downscaling factor = {args.further_downscaling_factor:g}")
        if (
            args.initial_downscaling_factor <= 0.0
            or args.further_downscaling_factor <= 0.0
        ):
            parser.error("The downscaling factors have to be strictly positive.")
    except SystemExit as e:
        return int(e.code or 0)

    # Top-level catch covering setup (dataset scan, class parsing, model
    # deserialization): print the message and exit 1, parity with
    # catch(std::exception&) at annonet_train_main.cpp:640-644. Errors
    # thrown from inside the training loop exit 2 instead (handled in
    # _run, annonet_train_main.cpp:616-620).
    try:
        return _run(args, input_directory)
    except Exception as e:  # noqa: BLE001
        from annonet_jax.cli.common import exit_on_peer_failure

        # setup-phase collectives (the resume pre-check all-gather, the
        # first mesh step's gloo context init) surface a dead peer HERE:
        # report + leave before the coordination client's async abort.
        # Same exit code as the loop handlers (PEER_FAILURE_EXIT_CODE) —
        # the root cause is the same, so orchestrators see one value.
        exit_on_peer_failure(e, bool(getattr(args, "coordinator", None)))
        print(e)
        return 1


def _sync_interval_seconds() -> float:
    """The sync-file write period: the reference's 10 minutes
    (annonet_train_main.cpp:403), overridable via
    ANNONET_SYNC_INTERVAL_SECONDS (must be > 0; invalid values get
    the same one-line validation error the timeout knobs do)."""
    import os

    raw = os.environ.get("ANNONET_SYNC_INTERVAL_SECONDS")
    if raw is None:
        return 600.0
    try:
        value = float(raw)
    except ValueError:
        value = -1.0
    if not value > 0.0:
        raise RuntimeError(
            f"ANNONET_SYNC_INTERVAL_SECONDS={raw!r} must be a "
            "positive number of seconds"
        )
    return value


def _resume_state_vector(sync_file):
    """The multi-host resume pre-check's per-rank state, as one comparable
    uint8 vector: int64 step | float64 learning rate | 32-byte weights
    fingerprint. Sentinels: step -1 = no checkpoint, -2 = unreadable
    (consistent-if-everywhere; the trainer then raises the real
    corruption error identically on every rank). Reads only the npz meta
    member — never the parameter payload (every rank runs this)."""
    import os as _os

    import numpy as np

    from annonet_jax import serialization

    step, lr = -1, -1.0  # no checkpoint
    fingerprint = b"\x00" * 32
    if sync_file and _os.path.exists(sync_file):
        try:
            meta = serialization.load_trainer_meta(sync_file)
            step = int(meta["step_count"])
            lr = float(meta["learning_rate"])
            fp_hex = meta.get("weights_fingerprint", "")
            if fp_hex:
                fingerprint = bytes.fromhex(fp_hex)
        except Exception:  # noqa: BLE001 — rank-local verdict only
            step, lr = -2, -2.0
    return np.concatenate([
        np.asarray([step], np.int64).view(np.uint8),
        np.asarray([lr], np.float64).view(np.uint8),
        np.frombuffer(fingerprint, np.uint8),
    ])


def _run(args, input_directory) -> int:
    # ExitStack scopes the optional select_device context to this call, so
    # library embedders calling main() repeatedly don't leak device
    # contexts (they were previously entered and never exited).
    import contextlib

    with contextlib.ExitStack() as stack:
        return _run_impl(args, input_directory, stack)


def _run_impl(args, input_directory, stack) -> int:
    from annonet_jax.cli.common import exit_on_peer_failure

    if not args.no_compilation_cache:
        from annonet_jax.cli.common import enable_compilation_cache

        enable_compilation_cache()

    # echo configuration, parity with annonet_train_main.cpp:336-374 (the
    # first three echo lines print from main(), inside the parse try-block)
    print("Allow flipping input images upside down =",
          "yes" if args.allow_flip_upside_down else "no")
    print(f"Minibatch size = {args.minibatch_size}")
    print(f"Net width scaler = {args.net_width_scaler:g}, "
          f"min filter count = {args.net_width_min_filter_count}")
    print(f"Initial learning rate = {args.initial_learning_rate:g}")
    print(f"Learning rate shrink factor = {args.learning_rate_shrink_factor:g}")
    print(f"Min learning rate = {args.min_learning_rate:g}")
    print(f"Save interval = {args.save_interval}")
    print(f"Relative training length = {args.relative_training_length:g}")
    print(f"Cached image count = {args.cached_image_count}")
    print(f"Data loader thread count = {args.data_loader_thread_count}")
    if args.deterministic_data:
        print("Deterministic data stream = true")
    if args.ignore_class:
        print("Classes to ignore =", " ".join(str(c) for c in args.ignore_class))

    # heavy imports after flag validation so --help stays fast
    from annonet_jax.classes import parse_anno_classes
    from annonet_jax.cli.common import select_device
    from annonet_jax.data.crop import CropOptions
    from annonet_jax.data.dataset import find_image_files, read_anno_classes_file
    from annonet_jax.data.pipeline import CropPipeline, RegionFilterOptions
    from annonet_jax.models.segnet import (
        SegNetConfig,
        recommended_input_dimension,
        required_input_dimension,
    )
    from annonet_jax.train.trainer import Trainer, TrainerConfig
    from annonet_jax import serialization

    relative_training_length = max(0.01, args.relative_training_length)

    if args.grayscale and args.allow_random_color_offset:
        # grayscale reference builds omit -o from the flag table entirely
        # (annonet_train_main.cpp:285-287 ifdef); we accept it for a
        # uniform surface but it cannot apply to 1-channel input
        print(
            "Warning: --allow-random-color-offset has no effect with "
            "--grayscale (color offsets need RGB input)"
        )

    model_config = SegNetConfig(
        class_count=2,  # fixed up after parsing anno classes
        level_count=args.level_count,
        width_scaler=args.net_width_scaler,
        min_filter_count=args.net_width_min_filter_count,
        grayscale=args.grayscale,
    )

    required_dim = required_input_dimension(model_config)
    print(f"Required input dimension = {required_dim}")
    requested_dim = int(round(args.input_dimension_multiplier * required_dim))
    print(f"Requested input dimension = {requested_dim}")
    actual_dim = recommended_input_dimension(model_config, requested_dim)
    print(f"Actual input dimension = {actual_dim}")

    anno_classes_json = read_anno_classes_file(input_directory)
    anno_classes = parse_anno_classes(anno_classes_json)
    model_config = SegNetConfig(
        class_count=len(anno_classes),
        level_count=args.level_count,
        width_scaler=args.net_width_scaler,
        min_filter_count=args.net_width_min_filter_count,
        grayscale=args.grayscale,
    )

    # Multi-host bootstrap (--coordinator) must precede mesh setup, which
    # must precede select_device: distributed init and the virtual-device
    # flags only take effect before the JAX backend initializes.
    multihost = bool(args.coordinator)
    io_process = True
    if multihost:
        if not args.mesh:
            raise RuntimeError(
                "--coordinator requires --mesh N (the global device count "
                "across all processes)"
            )
        from annonet_jax.parallel.mesh import initialize_distributed

        local_virtual = None
        if (
            os.environ.get("ANNONET_VIRTUAL_MESH") == "1"
            and args.num_processes
        ):
            local_virtual = max(1, args.mesh // args.num_processes)
        proc_id, nproc = initialize_distributed(
            args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            local_virtual_devices=local_virtual,
        )
        io_process = proc_id == 0
        print(f"Multi-host training: process {proc_id} of {nproc}")
        # Every process must draw the IDENTICAL crop-decision stream (the
        # model is SPMD with host replication: replicated pool contents
        # and decision uploads are only consistent if every host computes
        # the same ones). The deterministic pipeline mode pins the stream
        # to (seed, dataset) while keeping the loader threads as parallel
        # decode prefetchers; the pin-budget fallback is disabled because
        # it is timing-dependent and flips which (collective) program a
        # batch dispatches through.
        if not args.deterministic_data:
            print(
                "Multi-host: forcing --deterministic-data (every process "
                "must draw the identical crop-decision stream)"
            )
            args.deterministic_data = True

    # Ordering: the multihost bootstrap above set any virtual-device
    # flags; single-process --mesh flags come next (no backend init),
    # then the device probe — the process's FIRST backend init happens
    # inside its bounded thread, so a wedged runtime exits 1 (setup
    # contract) with triage text instead of hanging in
    # jax.devices()/mesh construction — then mesh + --device selection.
    from annonet_jax.cli.common import device_probe, prepare_mesh_flags

    if args.mesh and not multihost:
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

        mesh = make_cli_mesh(args.mesh, multiprocess=multihost)

    if args.device is not None:
        stack.enter_context(select_device(args.device))

    trainer_config = TrainerConfig(
        initial_learning_rate=args.initial_learning_rate,
        learning_rate_shrink_factor=args.learning_rate_shrink_factor,
        min_learning_rate=args.min_learning_rate,
        iterations_without_progress_threshold=int(
            round(relative_training_length * 2000)
        ),
        previous_loss_values_dump_amount=int(
            round(relative_training_length * 400)
        ),
        bn_stats_window=int(round(relative_training_length * 100)),
        remat=args.remat,
        int8_forward=args.int8_training,
        loss_sync_interval=max(1, args.loss_sync_interval),
        steps_per_dispatch=max(1, args.steps_per_dispatch),
        sync_file=args.sync_file,
        # 10 minutes, the reference's SetSynchronizationFile period
        # (annonet_train_main.cpp:403). ANNONET_SYNC_INTERVAL_SECONDS
        # overrides — operators running preemptible fleets can checkpoint
        # tighter, and the recovery drill (tests/test_multihost.py) uses
        # it to exercise a genuine MID-RUN checkpoint resume.
        sync_interval_seconds=_sync_interval_seconds(),
        verbose=True,
    )
    if multihost:
        # Resume consistency, checked BEFORE trainer construction: every
        # process must resume from the SAME state — the same --sync-file
        # on a shared filesystem. A rank that missed the file (e.g.
        # per-host sync paths: only process 0 writes one), or one holding
        # a checkpoint from a DIFFERENT run that merely coincides on
        # step/LR, would silently train from divergent "replicated"
        # arrays. The vector includes the weights fingerprint recorded at
        # save time, so the check is sound, not just plausible.
        import numpy as np
        from jax.experimental import multihost_utils

        gathered = np.asarray(multihost_utils.process_allgather(
            _resume_state_vector(args.sync_file)
        ))
        if not bool(np.all(gathered == gathered[0])):
            raise RuntimeError(
                "multi-host resume mismatch: processes see different "
                "trainer checkpoints (step/learning-rate/weights "
                "fingerprint differ across ranks) — point every process "
                "at the SAME --sync-file on a shared filesystem, or "
                "delete it everywhere to start fresh"
            )

    minibatch_size = args.minibatch_size
    if args.mesh:
        from annonet_jax.parallel.train import DataParallelTrainer

        if minibatch_size % args.mesh:
            minibatch_size += args.mesh - minibatch_size % args.mesh
            print(f"Minibatch size rounded up to {minibatch_size} "
                  f"(multiple of the {args.mesh}-device mesh)")
        trainer = DataParallelTrainer(
            model_config, trainer_config, seed=args.seed, mesh=mesh
        )
    else:
        trainer = Trainer(model_config, trainer_config, seed=args.seed)

    metrics = None
    if args.metrics_jsonl and io_process:
        from annonet_jax.utils.metrics import MetricsWriter

        metrics = MetricsWriter(args.metrics_jsonl, args.metrics_interval)
        stack.callback(metrics.close)
        trainer.metrics_hook = metrics.hook
        metrics.event(
            "start",
            input_directory=input_directory,
            minibatch_size=minibatch_size,
            class_count=len(anno_classes),
            level_count=args.level_count,
            grayscale=args.grayscale,
            net_width_scaler=args.net_width_scaler,
            initial_learning_rate=args.initial_learning_rate,
            min_learning_rate=args.min_learning_rate,
            initial_downscaling_factor=args.initial_downscaling_factor,
            further_downscaling_factor=args.further_downscaling_factor,
            mesh=args.mesh,
            seed=args.seed,
            resumed_at_step=trainer.step_count,
        )

    print("\nSCANNING ANNO DATASET\n")
    image_files = find_image_files(input_directory, require_ground_truth=True)
    print(f"images in dataset: {len(image_files)}")
    if not image_files:
        print("Didn't find an anno dataset. ")
        return 1

    crop_options = CropOptions(
        dim=actual_dim,
        further_downscaling_factor=args.further_downscaling_factor,
        class_weight=args.class_weight,
        image_weight=args.image_weight,
        allow_flip_left_right=args.allow_flip_left_right,
        allow_flip_upside_down=args.allow_flip_upside_down,
        multiplicative_brightness_change_probability=(
            args.multiplicative_brightness_change_probability
        ),
        multiplicative_brightness_change_sigma=(
            args.multiplicative_brightness_change_sigma
        ),
        noise_level_stddev=args.noise_level_stddev,
        allow_random_color_offset=args.allow_random_color_offset,
    )
    region_filter = RegionFilterOptions(
        receptive_field_side=required_dim,
        by_area=args.ignore_large_nonzero_regions_by_area,
        by_width=args.ignore_large_nonzero_regions_by_width,
        by_height=args.ignore_large_nonzero_regions_by_height,
    )

    downscaling_total = (
        args.initial_downscaling_factor * args.further_downscaling_factor
    )

    # --validation-directory: held-out evaluation after every save. The
    # dataset is scanned up front (setup errors keep the exit-1 contract);
    # samples are read lazily on the first validation and cached.
    validation_samples: list = []
    validation_state: list = []
    if args.validation_quantize != "none" and not args.validation_directory:
        raise RuntimeError(
            "--validation-quantize requires --validation-directory"
        )
    if args.validation_directory:
        # read + validate the whole validation set up front: data problems
        # must surface as setup errors (exit 1), not abort a long training
        # run at its first save (exit 2) hours in
        from annonet_jax.data.sample import read_sample

        validation_files = find_image_files(
            args.validation_directory, require_ground_truth=True
        )
        if not validation_files:
            raise RuntimeError(
                "Didn't find an anno dataset in --validation-directory "
                f"{args.validation_directory}"
            )
        for f in validation_files:
            s = read_sample(
                f, anno_classes, True, downscaling_total, args.grayscale
            )
            if s.error:
                print(f"validation: skipping {f.image_filename}: {s.error}")
                continue
            validation_samples.append(s)
        if not validation_samples:
            raise RuntimeError(
                "No readable validation samples in "
                f"{args.validation_directory}"
            )

    def run_validation(runtime_net):
        import jax
        import numpy as np

        from annonet_jax.infer.core import TiledInferer, annonet_infer
        from annonet_jax.infer.evaluation import (
            confusion_matrix_summary,
            new_confusion_matrix,
            update_confusion_matrix_per_pixel,
        )

        # validation always runs single-device: under --mesh the trainer's
        # params are replicated (mesh-committed) arrays, so pull them to
        # host first — the tiled-inference programs are not mesh programs
        runtime_net = jax.tree_util.tree_map(np.asarray, runtime_net)
        # one inferer across validations: update_params swaps the weights
        # while keeping every compiled program (params are traced
        # arguments), so validations after the first are compile-free
        if validation_state:
            inferer = validation_state[0]
            inferer.update_params(runtime_net)
        else:
            inferer = TiledInferer(
                runtime_net, model_config,
                quantize=(
                    None if args.validation_quantize == "none" else
                    args.validation_quantize
                ),
            )
            validation_state.append(inferer)
        cm = new_confusion_matrix(len(anno_classes))
        px = 0
        for s in validation_samples:
            labels = annonet_infer(inferer, s.input_image)
            px += update_confusion_matrix_per_pixel(
                cm, s.labeled_points_by_class, labels
            )
        summary = confusion_matrix_summary(cm, anno_classes)
        recalls = " ".join(
            f"{c['index']}:{c['recall'] * 100.0:.2f}%"
            for c in summary["classes"]
            if c["recall"] is not None
        )
        accuracy = summary["accuracy"]
        accuracy_text = (
            f"{accuracy * 100.0:.2f} %" if accuracy is not None
            else "n/a (no labeled pixels)"
        )
        print(
            f"validation (step {trainer.step_count}): accuracy = "
            f"{accuracy_text} over {px} labeled px, "
            f"{len(validation_samples)} images; recall {recalls}"
        )
        if metrics is not None:
            metrics.event(
                "validation",
                step=trainer.step_count,  # absolute, like loss events
                accuracy=accuracy,
                labeled_pixels=px,
                images=len(validation_samples),
                classes=summary["classes"],
            )

    def save_inference_net():
        if not io_process:
            # params are replicated: process 0's artifact is everyone's.
            # (All processes still reach this deterministic point — only
            # the local-device export/validation work is skipped.)
            return
        print("saving network")
        runtime_net = trainer.runtime_net()
        serialization.save_model(
            args.output,
            runtime_net,
            model_config,
            anno_classes_json,
            downscaling_factor=downscaling_total,
        )
        if metrics is not None:
            # ABSOLUTE DISPATCHED step, matching the loss/
            # learning_rate_shrink events' numbering — a resumed phase's
            # run-relative counter would disagree with them (observed in
            # a plateau run). step_count, not total_steps:
            # the artifact reflects only steps already applied to the
            # weights, not superstep decisions still buffered.
            metrics.event("save", step=trainer.step_count,
                          path=args.output)
        if validation_samples:
            run_validation(runtime_net)

    print("\nNow training...")
    from annonet_jax.utils import profiler_trace, set_low_priority

    set_low_priority()  # annonet_train_main.cpp:514
    warnings_already_printed = set()
    minibatch = 0
    train_started = time.monotonic()

    # Device-resident image cache (extension, docs/DESIGN.md):
    # crops are gathered on device from an HBM pool mirroring the host LRU;
    # only the further-downscaling path uses the classic pixel-upload loop.
    # Under --mesh the pool is REPLICATED over the DP mesh (one upload +
    # broadcast per decoded image) and each device gathers its own shard of
    # the crop batch. Any batch that fell back to pixels (pin budget)
    # still trains identically through train_step_crops.
    device_pool = None
    if args.device_image_cache != "off" and (
        args.further_downscaling_factor <= 1.0
    ):
        from annonet_jax.train.device_cache import DeviceImagePool

        pool_sharding = None
        if args.mesh:
            from jax.sharding import NamedSharding, PartitionSpec

            pool_sharding = NamedSharding(trainer.mesh, PartitionSpec())
        device_pool = DeviceImagePool(
            slots=max(1, args.cached_image_count), sharding=pool_sharding
        )
    elif args.device_image_cache == "on":
        raise RuntimeError(
            "--device-image-cache on requires "
            "--further-downscaling-factor <= 1"
        )

    with CropPipeline(
        image_files,
        anno_classes,
        crop_options,
        initial_downscaling_factor=args.initial_downscaling_factor,
        grayscale=args.grayscale,
        classes_to_ignore=args.ignore_class,
        region_filter=region_filter,
        cached_image_count=args.cached_image_count,
        thread_count=max(1, args.data_loader_thread_count),
        queue_depth=2 * args.minibatch_size,
        seed=args.seed,
        # multi-host: the pin-budget fallback is timing-dependent (it
        # flips decision batches into pixel batches, i.e. into a DIFFERENT
        # collective program), so it must never trigger
        pinned_bytes_budget=(1 << 62) if multihost else 512 << 20,
        deterministic=args.deterministic_data,
    ) as pipe:
        # Errors thrown from inside the training loop (bad crops, device
        # failures) print the message and exit 2, parity with the loop's
        # catch at annonet_train_main.cpp:616-620 (the final network save
        # is skipped, :634-636; loader shutdown is the pipeline context).
        step_timing = os.environ.get("ANNONET_STEP_TIMING") == "1"
        try:
            with profiler_trace(args.profile):
                while True:
                    _t0 = time.monotonic()
                    if trainer.should_stop:
                        break
                    if (
                        args.max_total_steps is not None
                        and minibatch >= args.max_total_steps
                    ):
                        break
                    warn = (
                        None if args.no_empty_label_image_warning else print
                    )
                    if device_pool is not None:
                        kind, a, b = pipe.next_decisions(
                            minibatch_size,
                            warn=warn,
                            warnings_already_printed=warnings_already_printed,
                        )
                        if kind == "decisions":
                            trainer.train_step_decisions(
                                device_pool, a, b, crop_options,
                                seed=args.seed,
                            )
                        else:
                            trainer.train_step_crops(
                                a, b, crop_options, seed=args.seed
                            )
                    else:
                        images, labels = pipe.next_minibatch(
                            minibatch_size,
                            warn=warn,
                            warnings_already_printed=warnings_already_printed,
                        )
                        trainer.train_step_crops(
                            images, labels, crop_options, seed=args.seed
                        )
                    if step_timing:
                        extra = ""
                        if device_pool is not None:
                            extra = f" uploads={device_pool.uploads}"
                        print(
                            f"[step {minibatch}] "
                            f"{time.monotonic() - _t0:.3f}s{extra}",
                            flush=True,
                        )
                    if minibatch % args.save_interval == 0:
                        save_inference_net()
                    minibatch += 1
        except Exception as e:  # noqa: BLE001
            # dead peer: report + write the final metrics event, leave now
            exit_on_peer_failure(
                e, multihost,
                before_exit=(
                    None if metrics is None
                    else lambda: metrics.event("error", message=str(e))
                ),
            )
            print(e)
            if multihost:
                # data errors raise identically on every rank (identical
                # decision streams), but a rank-LOCAL failure (device loss,
                # local OOM) leaves peers blocked in their next collective
                # until its death severs their transport — name the hazard
                print(
                    "multi-host: this rank is exiting; peer processes may "
                    "block or fail in their next collective. Restart the "
                    "job on every host (resume from the shared --sync-file)."
                )
            if metrics is not None:
                metrics.event("error", message=str(e))
            return 2

    # The tail flush is still training-loop work: buffered losses land here,
    # so a divergence surfacing in them must keep the loop's exit-2 contract
    # — and must be detected BEFORE save_inference_net overwrites --output
    # with the poisoned weights.
    try:
        trainer.flush_pending_steps()  # dispatch any buffered superstep tail
        trainer.flush_losses()  # a buffered divergence must veto the save
        save_inference_net()
        trainer.save_sync_file()
    except Exception as e:  # noqa: BLE001
        exit_on_peer_failure(
            e, multihost,
            before_exit=(
                None if metrics is None
                else lambda: metrics.event("error", message=str(e))
            ),
        )
        print(e)
        if multihost:
            print(
                "multi-host: this rank is exiting; peer processes may "
                "block or fail in their next collective. Restart the "
                "job on every host (resume from the shared --sync-file)."
            )
        if metrics is not None:
            metrics.event("error", message=str(e))
        return 2
    if metrics is not None:
        metrics.event(
            "done",
            # absolute, like loss/shrink events (the tail flush above has
            # dispatched any buffered supersteps, so this is also the
            # number of weight updates applied)
            steps=trainer.step_count,
            steps_this_run=minibatch,
            wall_seconds=round(time.monotonic() - train_started, 3),
        )
    if multihost:
        # hold every process until the final save/flush completed
        # everywhere (process 0 hosts the coordination service, so it must
        # not exit while peers still have work in flight)
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("annonet_train exit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
