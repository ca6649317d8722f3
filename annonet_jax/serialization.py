"""Model and trainer-state serialization.

The deployable artifact keeps the reference's self-describing contract
(annonet_train_main.cpp:557-565, annonet_infer_main.cpp:340-351): ONE file —
by convention still named ``annonet.dnn`` — containing

  1. the raw anno_classes.json string,
  2. the combined downscaling factor (initial * further),
  3. the inference (BN-folded) network,

so the class palette, scale, and weights travel together and inference needs
no side files (SURVEY.md §3.4 calls this the compatibility contract).

Container format: NumPy .npz (zip) with a JSON metadata entry plus one array
per parameter leaf, keyed by its pytree path. No pickle — the file is
portable and safe to load.

The trainer synchronization file (annonet_trainer_state_file.dat in the
reference, written every 10 minutes via SetSynchronizationFile,
annonet_train_main.cpp:403) uses the same container with a different
metadata schema and holds the FULL training state: params, BN stats,
optimizer momentum, learning rate, step, and the recent-loss window, so a
restarted run resumes exactly.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, Sequence, Tuple

import numpy as np
from numpy.lib import format as npformat

from annonet_jax.models.segnet import SegNetConfig

_FORMAT = "annonet-jax-npz-v1"
# artifacts written before the package took its present name carry the
# same layout under the project's former name: any "annonet-<name>-npz-v1"
# tag loads
_FORMAT_RE = re.compile(r"annonet-[a-z]+-npz-v1")
_SEP = "/"


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a nested dict-of-arrays pytree into {path: array}."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            key = f"{prefix}{_SEP}{k}" if prefix else str(k)
            out.update(flatten_tree(v, key))
    else:
        out[prefix] = np.asarray(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Any:
    """Inverse of flatten_tree."""
    root: Dict[str, Any] = {}
    for path, value in flat.items():
        parts = path.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def _atomic_savez(path: str, **arrays) -> None:
    """Write an npz atomically (the sync file may be overwritten while a
    previous copy is being read by a resuming process)."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


# ---------------------------------------------------------------------------
# Untrusted-input validation
#
# These artifacts are parsed from arbitrary files (a served model directory,
# a shared sync file, an operator-supplied --calibration), exactly like the
# image path the round-4 fuzzing hardened — so the loaders validate the
# CONTAINER (zip + npy headers) and the DECLARED shapes/dtypes against the
# architecture BEFORE decompressing any array data. That turns truncation,
# dimension/allocation bombs (a zero-filled multi-GB array compresses to
# kilobytes), mismatched trees, and hostile embedded JSON into clean
# RuntimeErrors with bounded memory, instead of MemoryErrors, KeyErrors, or
# shape explosions deep inside jit tracing. The reference inherits dlib's
# throwing deserialize here (annonet_infer_main.cpp:343).
# ---------------------------------------------------------------------------

_MAX_META_BYTES = 16 << 20  # __meta__ carries anno_classes.json; cap it
_CONFIG_FIELDS = {
    "class_count", "level_count", "width_scaler", "min_filter_count",
    "grayscale", "base_width", "compute_dtype",
}


def _corrupt(path, kind: str, why: str) -> RuntimeError:
    return RuntimeError(
        f"{_describe(path)} is not a valid annonet-jax {kind} file: {why}"
    )


def _describe(path) -> str:
    """Path string, or a readable tag for file-like inputs (the serve
    client hands load_calibration a BytesIO)."""
    return path if isinstance(path, (str, os.PathLike)) else "<in-memory file>"


def _rewound(path):
    """Loaders scan headers first and then np.load the same source; a
    file-like input must be rewound between (and before) the passes."""
    if hasattr(path, "seek"):
        path.seek(0)
    return path


# numpy's public npy header readers, by format version (np.save writes
# 1.0, or 2.0 for headers past 64 KiB)
_NPY_HEADER_READERS = {
    (1, 0): npformat.read_array_header_1_0,
    (2, 0): npformat.read_array_header_2_0,
}


def _scan_npz(path: str, kind: str):
    """Parse the zip directory + every member's npy HEADER (shape, dtype)
    without decompressing array data; parse and return the __meta__ JSON.

    Returns (meta_dict, {member_name: (shape, dtype)}). Raises a clean
    RuntimeError for anything malformed."""
    import io
    import zipfile

    headers: Dict[str, Tuple[tuple, np.dtype]] = {}
    try:
        with zipfile.ZipFile(_rewound(path)) as zf:
            names = zf.namelist()
            if "__meta__.npy" not in names:
                raise _corrupt(path, kind, "missing __meta__ entry")
            meta_info = zf.getinfo("__meta__.npy")
            if meta_info.file_size > _MAX_META_BYTES:
                raise _corrupt(
                    path, kind,
                    f"__meta__ declares {meta_info.file_size} bytes "
                    f"(cap {_MAX_META_BYTES})",
                )
            for name in names:
                if not name.endswith(".npy"):
                    raise _corrupt(path, kind, f"unexpected member {name!r}")
                with zf.open(name) as f:
                    version = npformat.read_magic(f)
                    reader = _NPY_HEADER_READERS.get(version)
                    if reader is None:
                        raise _corrupt(
                            path, kind,
                            f"member {name!r} has npy format version "
                            f"{version}",
                        )
                    shape, _fortran, dtype = reader(f)
                if dtype.hasobject:
                    raise _corrupt(
                        path, kind, f"member {name!r} has object dtype"
                    )
                headers[name[: -len(".npy")]] = (tuple(shape), dtype)
            meta_bytes = zf.read("__meta__.npy")
    except RuntimeError:
        raise
    except Exception as e:  # zipfile/format/header errors — corrupt container
        raise _corrupt(path, kind, f"unreadable npz container ({e})") from e
    try:
        meta_arr = np.load(io.BytesIO(meta_bytes), allow_pickle=False)
        meta = json.loads(bytes(meta_arr).decode("utf-8"))
    except Exception as e:
        raise _corrupt(path, kind, f"unreadable __meta__ ({e})") from e
    if not isinstance(meta, dict):
        raise _corrupt(path, kind, "__meta__ is not a JSON object")
    fmt = meta.get("format")
    if (
        not isinstance(fmt, str)
        or not _FORMAT_RE.fullmatch(fmt)
        or meta.get("kind") != kind
    ):
        # the historical message for a wrong-kind/foreign file, asserted
        # by existing tests and printed by the CLIs
        raise RuntimeError(
            f"{_describe(path)} is not an annonet-jax {_KIND_NAMES[kind]}"
        )
    return meta, headers


_KIND_NAMES = {
    "runtime_net": "model file",
    "trainer_state": "trainer state file",
    "int8_calibration": "calibration file",
}


def _validated_config(raw, path: str, kind: str) -> SegNetConfig:
    """SegNetConfig from untrusted meta: reject unknown fields, wrong
    types, and absurd ranges BEFORE any shape computation keys off them
    (a hostile level_count/base_width would otherwise size multi-GB
    expected trees or spin the dimension queries)."""
    if not isinstance(raw, dict):
        raise _corrupt(path, kind, "model_config is not an object")
    unknown = set(raw) - _CONFIG_FIELDS
    missing = _CONFIG_FIELDS - set(raw)
    if unknown or missing:
        raise _corrupt(
            path, kind,
            f"model_config fields unknown={sorted(unknown)} "
            f"missing={sorted(missing)}",
        )
    def _int(name, lo, hi):
        v = raw[name]
        if not isinstance(v, int) or isinstance(v, bool) or not lo <= v <= hi:
            raise _corrupt(
                path, kind, f"model_config.{name}={v!r} outside [{lo}, {hi}]"
            )
        return v

    _int("class_count", 1, 65535)
    _int("level_count", 0, 8)
    _int("base_width", 1, 8192)
    _int("min_filter_count", 1, 8192)
    ws = raw["width_scaler"]
    if not isinstance(ws, (int, float)) or isinstance(ws, bool) or not (
        0.0 < float(ws) <= 1024.0 and np.isfinite(ws)
    ):
        raise _corrupt(path, kind, f"model_config.width_scaler={ws!r}")
    if not isinstance(raw["grayscale"], bool):
        raise _corrupt(path, kind, "model_config.grayscale is not a bool")
    if raw["compute_dtype"] not in ("bfloat16", "float32"):
        raise _corrupt(
            path, kind,
            f"model_config.compute_dtype={raw['compute_dtype']!r}",
        )
    return SegNetConfig.from_dict(raw)


def _expected_shapes(config: SegNetConfig, trees: Sequence[str]):
    """{member_name: (shape, dtype)} the architecture dictates, computed
    WITHOUT any real compute (jax.eval_shape over init/fold)."""
    import jax

    from annonet_jax.models.segnet import fold_batchnorm, init_state

    key = jax.ShapeDtypeStruct((2,), np.uint32)

    def build(k):
        params, bn_stats = init_state(k, config)
        out = {}
        if "params" in trees and "bn_stats" not in trees:
            # runtime artifact: the BN-folded net
            out["params"] = fold_batchnorm(params, bn_stats, config)
        if "params" in trees and "bn_stats" in trees:
            out["params"] = params
        if "bn_stats" in trees:
            out["bn_stats"] = bn_stats
        if "velocity" in trees:
            out["velocity"] = jax.tree_util.tree_map(lambda a: a, params)
        return out

    shaped = jax.eval_shape(build, key)
    expected: Dict[str, Tuple[tuple, np.dtype]] = {}
    for name, tree in shaped.items():
        for k, v in flatten_tree_specs(tree).items():
            expected[name + _SEP + k] = v
    return expected


def flatten_tree_specs(tree: Any, prefix: str = ""):
    """flatten_tree for ShapeDtypeStructs: {path: (shape, dtype)}."""
    out: Dict[str, Tuple[tuple, np.dtype]] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            key = f"{prefix}{_SEP}{k}" if prefix else str(k)
            out.update(flatten_tree_specs(v, key))
    else:
        out[prefix] = (tuple(tree.shape), np.dtype(tree.dtype))
    return out


def _check_tree_headers(path, kind, headers, expected):
    """Every expected parameter present with the declared shape/dtype,
    nothing extra — BEFORE decompression, so bombs never allocate."""
    stored = {k: v for k, v in headers.items() if k != "__meta__"}
    missing = sorted(set(expected) - set(stored))
    extra = sorted(set(stored) - set(expected))
    if missing or extra:
        raise _corrupt(
            path, kind,
            f"parameter tree mismatch vs declared architecture "
            f"(missing {missing[:4]}{'...' if len(missing) > 4 else ''}, "
            f"unexpected {extra[:4]}{'...' if len(extra) > 4 else ''})",
        )
    total = 0
    for name, (shape, dtype) in expected.items():
        got_shape, got_dtype = stored[name]
        # dtype may legitimately differ (e.g. f32 params saved from a
        # bf16-configured net) — bound the SIZE instead, and require a
        # plain numeric dtype
        if got_shape != shape or got_dtype.kind not in "fiu":
            raise _corrupt(
                path, kind,
                f"parameter {name!r} has shape {got_shape} dtype "
                f"{got_dtype}, architecture expects shape {shape}",
            )
        total += int(np.prod(got_shape, dtype=np.int64)) * got_dtype.itemsize
    if total > (8 << 30):
        # the declared config itself implies a tree no real annonet net
        # reaches (flagship < 100 MB) — treat as hostile
        raise _corrupt(
            path, kind, f"declared parameter tree is {total} bytes"
        )


def save_model(
    path: str,
    runtime_params: Any,
    config: SegNetConfig,
    anno_classes_json: str,
    downscaling_factor: float,
) -> None:
    """Write the self-describing inference artifact (the annonet.dnn analog)."""
    meta = {
        "format": _FORMAT,
        "kind": "runtime_net",
        "anno_classes_json": anno_classes_json,
        "downscaling_factor": float(downscaling_factor),
        "model_config": config.to_dict(),
    }
    arrays = {
        "params" + _SEP + k: v for k, v in flatten_tree(runtime_params).items()
    }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    )
    _atomic_savez(path, **arrays)


def load_model(path: str) -> Tuple[Any, SegNetConfig, str, float]:
    """Read back (runtime_params, config, anno_classes_json, downscaling).

    The file is UNTRUSTED (see the validation block above): container,
    meta fields, and declared array shapes are all verified against the
    declared architecture before any array data is decompressed."""
    kind = "runtime_net"
    meta, headers = _scan_npz(path, kind)
    config = _validated_config(meta.get("model_config"), path, kind)
    anno_classes_json = meta.get("anno_classes_json")
    if not isinstance(anno_classes_json, str):
        raise _corrupt(path, kind, "anno_classes_json is not a string")
    downscaling = meta.get("downscaling_factor")
    if (
        not isinstance(downscaling, (int, float))
        or isinstance(downscaling, bool)
        or not np.isfinite(downscaling)
        or not 0.0 < float(downscaling) <= 1e6
    ):
        raise _corrupt(
            path, kind, f"downscaling_factor={downscaling!r}"
        )
    _check_tree_headers(
        path, kind, headers, _expected_shapes(config, ("params",))
    )
    with np.load(_rewound(path), allow_pickle=False) as z:
        flat = {
            k[len("params" + _SEP) :]: z[k]
            for k in z.files
            if k.startswith("params" + _SEP)
        }
    params = unflatten_tree(flat)
    return params, config, anno_classes_json, float(downscaling)


def save_trainer_state(path: str, trees: Dict[str, Any], meta: Dict[str, Any]) -> None:
    """Write full training state: ``trees`` maps names (params/bn_stats/velocity)
    to pytrees; ``meta`` holds JSON-serializable scalars (lr, step, losses)."""
    arrays: Dict[str, np.ndarray] = {}
    for name, tree in trees.items():
        for k, v in flatten_tree(tree).items():
            arrays[name + _SEP + k] = v
    payload = {"format": _FORMAT, "kind": "trainer_state", "meta": meta,
               "tree_names": sorted(trees.keys())}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(payload).encode("utf-8"), dtype=np.uint8
    )
    _atomic_savez(path, **arrays)


def load_trainer_meta(path: str) -> Dict[str, Any]:
    """Read ONLY the meta dict of a trainer-state file (single-member
    bounded read — the multi-host resume pre-check runs on every rank and
    must not decompress the full parameter payload twice per rank)."""
    kind = "trainer_state"
    payload, _headers = _scan_npz(path, kind)
    meta = payload.get("meta")
    if not isinstance(meta, dict):
        raise _corrupt(path, kind, "meta is not an object")
    return meta


def load_trainer_state(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read back (trees, meta) written by save_trainer_state.

    UNTRUSTED input (a shared sync file on a network filesystem):
    container, tree names, and declared shapes are validated against the
    architecture the file itself declares (meta.model_config — the
    trainer additionally requires it to equal ITS config) before any
    array decompression."""
    kind = "trainer_state"
    payload, headers = _scan_npz(path, kind)
    meta = payload.get("meta")
    if not isinstance(meta, dict):
        raise _corrupt(path, kind, "meta is not an object")
    if payload.get("tree_names") != ["bn_stats", "params", "velocity"]:
        raise _corrupt(
            path, kind, f"tree_names={payload.get('tree_names')!r}"
        )
    config = _validated_config(meta.get("model_config"), path, kind)
    _check_tree_headers(
        path, kind, headers,
        _expected_shapes(config, ("params", "bn_stats", "velocity")),
    )
    losses = meta.get("previous_loss_values", [])
    if not isinstance(losses, list) or len(losses) > 1_000_000 or any(
        not isinstance(v, (int, float)) or isinstance(v, bool)
        for v in losses
    ):
        raise _corrupt(path, kind, "previous_loss_values is malformed")
    step = meta.get("step_count")
    if not isinstance(step, int) or isinstance(step, bool) or not (
        0 <= step <= 10**12
    ):
        raise _corrupt(path, kind, f"step_count={step!r}")
    lr = meta.get("learning_rate")
    if (
        not isinstance(lr, (int, float)) or isinstance(lr, bool)
        or not np.isfinite(lr)
    ):
        raise _corrupt(path, kind, f"learning_rate={lr!r}")
    with np.load(_rewound(path), allow_pickle=False) as z:
        trees: Dict[str, Any] = {}
        for name in payload["tree_names"]:
            flat = {
                k[len(name + _SEP) :]: z[k]
                for k in z.files
                if k.startswith(name + _SEP)
            }
            trees[name] = unflatten_tree(flat)
    return trees, meta


def weights_fingerprint(runtime_params: Any) -> str:
    """sha256 over the flattened parameter tree (paths + raw bytes):
    identifies the exact trained weights, not just the architecture."""
    import hashlib

    h = hashlib.sha256()
    for key, arr in sorted(flatten_tree(runtime_params).items()):
        h.update(key.encode("utf-8"))
        a = np.ascontiguousarray(np.asarray(arr))
        h.update(str(a.dtype).encode("utf-8"))
        h.update(str(a.shape).encode("utf-8"))
        h.update(a.tobytes())
    return h.hexdigest()


def save_calibration(
    path: str,
    calibration,
    config: SegNetConfig,
    runtime_params: Any = None,
) -> None:
    """Persist int8 activation-calibration maxima (extension beyond the reference).

    ``calibration`` is TiledInferer.export_calibration()'s list of
    per-layer, per-REAL-channel post-ReLU activation maxima. Persisting
    them makes int8 deployments reproducible across restarts — a server
    or CLI started with the saved set skips runtime calibration and runs
    int8 from the very first image. The model config AND (when
    ``runtime_params`` is given) a weights fingerprint travel along and
    are verified at load: activation ranges depend on the trained
    weights, so a calibration from a retrained model must not silently
    apply even when the architecture matches.
    """
    _atomic_savez(path, **_calibration_arrays(
        calibration, config, runtime_params
    ))


def calibration_npz_bytes(
    calibration,
    config: SegNetConfig,
    runtime_params: Any = None,
) -> bytes:
    """The save_calibration npz as in-memory bytes — byte-compatible with
    the file format, so load_calibration reads it back verbatim. Backs
    annonet_serve's ``GET /calibration`` download (export the scales a
    live int8 server froze on real traffic, for reproducible redeploys
    via ``--calibration``)."""
    import io

    buf = io.BytesIO()
    np.savez(buf, **_calibration_arrays(calibration, config, runtime_params))
    return buf.getvalue()


def _calibration_arrays(calibration, config, runtime_params):
    if not calibration:
        raise ValueError("empty calibration (no frozen int8 net to export)")
    meta = {
        "format": _FORMAT,
        "kind": "int8_calibration",
        "model_config": config.to_dict(),
        "layer_count": len(calibration),
    }
    if runtime_params is not None:
        meta["weights_sha256"] = weights_fingerprint(runtime_params)
    arrays = {
        f"layer{_SEP}{i:03d}": np.asarray(v, np.float32)
        for i, v in enumerate(calibration)
    }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    )
    return arrays


def load_calibration(path: str, config: SegNetConfig,
                     runtime_params: Any = None):
    """Read back a save_calibration file; raises if it was produced for a
    different model config, or (when both sides carry a fingerprint) for
    different trained weights. UNTRUSTED input: the container and the
    declared layer-vector shapes are validated before decompression."""
    kind = "int8_calibration"
    meta, headers = _scan_npz(path, kind)
    layer_count = meta.get("layer_count")
    if not isinstance(layer_count, int) or isinstance(layer_count, bool) or (
        not 1 <= layer_count <= 4096
    ):
        raise _corrupt(path, kind, f"layer_count={layer_count!r}")
    expected_names = {f"layer{_SEP}{i:03d}" for i in range(layer_count)}
    stored = set(headers) - {"__meta__"}
    if stored != expected_names:
        raise _corrupt(
            path, kind,
            f"layer members do not match layer_count={layer_count}",
        )
    for name in expected_names:
        shape, dtype = headers[name]
        if len(shape) != 1 or shape[0] > (1 << 20) or dtype.kind != "f":
            raise _corrupt(
                path, kind,
                f"member {name!r} has shape {shape} dtype {dtype} "
                "(expected a small 1-D float vector)",
            )
    with np.load(_rewound(path), allow_pickle=False) as z:
        if meta["model_config"] != config.to_dict():
            raise RuntimeError(
                f"{path} was calibrated for a different model config "
                f"({meta['model_config']} != {config.to_dict()})"
            )
        if runtime_params is not None and "weights_sha256" in meta:
            actual = weights_fingerprint(runtime_params)
            if meta["weights_sha256"] != actual:
                raise RuntimeError(
                    f"{path} was calibrated for different trained weights "
                    "(same architecture, different model — recalibrate "
                    "with --save-calibration)"
                )
        return [
            z[f"layer{_SEP}{i:03d}"] for i in range(meta["layer_count"])
        ]
