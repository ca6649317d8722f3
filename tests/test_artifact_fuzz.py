"""Malformed-artifact fuzzing: model npz / trainer sync file / calibration.

The round-4 fuzz pass hardened the IMAGE inputs (tests/test_image_io_fuzz.py);
these artifacts are parsed from untrusted files exactly the same way — a
served model directory, a shared sync file on a network filesystem, an
operator-supplied --calibration — and np.load on a zip container has its own
failure surface: truncation, dimension/allocation bombs (multi-GB zero
arrays compress to kilobytes), mismatched trees vs the declared
architecture, hostile embedded JSON. The reference inherits dlib's throwing
deserialize here (annonet_infer_main.cpp:343); this framework's loaders
(serialization.py) validate container + npy HEADERS + declared config
before decompressing anything, so every corpus entry must fail with a
clean RuntimeError (CLIs: one-line message + exit 1) with bounded memory —
never a MemoryError, KeyError, zipfile traceback, or jit-time shape
explosion.
"""

import io
import json
import os
import zipfile

import numpy as np
import pytest

from annonet_jax import serialization
from annonet_jax.models.segnet import (
    SegNetConfig,
    fold_batchnorm,
    init_state,
)

CONFIG = SegNetConfig(
    class_count=2, level_count=1, base_width=4, compute_dtype="float32"
)


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    """A small VALID model artifact to mutate."""
    import jax

    path = tmp_path_factory.mktemp("artifacts") / "annonet.dnn"
    params, stats = init_state(jax.random.PRNGKey(0), CONFIG)
    runtime = fold_batchnorm(params, stats, CONFIG)
    from annonet_jax.classes import (
        anno_classes_to_json,
        default_anno_classes,
    )

    serialization.save_model(
        str(path), runtime, CONFIG,
        anno_classes_to_json(default_anno_classes()), 1.0,
    )
    return path


def _npy_bytes(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _fake_npy_header(shape, dtype="<f4") -> bytes:
    """An npy member DECLARING ``shape`` but carrying (almost) no data —
    the allocation-bomb construction: tiny on disk, huge if trusted."""
    buf = io.BytesIO()
    from numpy.lib import format as npformat

    # write_array_header_1_0 emits the magic itself
    npformat.write_array_header_1_0(
        buf, {"descr": dtype, "fortran_order": False, "shape": tuple(shape)}
    )
    buf.write(b"\x00" * 64)  # far fewer bytes than the header declares
    return buf.getvalue()


def _rewrite_npz(src_path, out_path, mutate):
    """Copy an npz, letting ``mutate(name, data) -> data | None`` replace
    (or drop, on None) each member."""
    with zipfile.ZipFile(src_path) as zin, zipfile.ZipFile(
        out_path, "w", zipfile.ZIP_DEFLATED
    ) as zout:
        for info in zin.infolist():
            data = mutate(info.filename, zin.read(info.filename))
            if data is not None:
                zout.writestr(info.filename, data)


def _meta_of(path) -> dict:
    with zipfile.ZipFile(path) as zf:
        arr = np.load(io.BytesIO(zf.read("__meta__.npy")),
                      allow_pickle=False)
    return json.loads(bytes(arr).decode("utf-8"))


def _with_meta(src_path, out_path, meta) -> None:
    _rewrite_npz(
        src_path, out_path,
        lambda name, data: _npy_bytes(np.frombuffer(
            json.dumps(meta).encode(), np.uint8
        )) if name == "__meta__.npy" else data,
    )


# ---------------------------------------------------------------------------
# load_model
# ---------------------------------------------------------------------------


def test_model_truncations_fail_cleanly(model_file, tmp_path):
    raw = model_file.read_bytes()
    for frac in (0.0, 0.1, 0.5, 0.9, 0.99):
        p = tmp_path / f"trunc_{frac}.dnn"
        p.write_bytes(raw[: int(len(raw) * frac)])
        with pytest.raises(RuntimeError):
            serialization.load_model(str(p))


def test_model_garbage_and_foreign_files(tmp_path):
    cases = {
        "empty.dnn": b"",
        "random.dnn": np.random.default_rng(0).bytes(4096),
        "text.dnn": b"not a model\n" * 100,
        # a valid zip that is not our container
        "zip.dnn": None,
    }
    p = tmp_path / "zip.dnn"
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("hello.txt", "hi")
    cases["zip.dnn"] = p.read_bytes()
    for name, data in cases.items():
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(RuntimeError):
            serialization.load_model(str(path))


def test_model_meta_mutations_fail_cleanly(model_file, tmp_path):
    good = _meta_of(model_file)
    mutations = [
        ("not_json", b"\xff\xfe{{{"),
        ("json_list", json.dumps([1, 2, 3]).encode()),
    ]
    for name, payload in mutations:
        p = tmp_path / f"meta_{name}.dnn"
        _rewrite_npz(
            model_file, p,
            lambda n, d, payload=payload: _npy_bytes(
                np.frombuffer(payload, np.uint8)
            ) if n == "__meta__.npy" else d,
        )
        with pytest.raises(RuntimeError):
            serialization.load_model(str(p))

    bad_metas = {
        "wrong_kind": {**good, "kind": "trainer_state"},
        "wrong_format": {**good, "format": "annonet-jax-npz-v999"},
        "config_not_dict": {**good, "model_config": "lol"},
        "config_missing": {k: v for k, v in good.items()
                           if k != "model_config"},
        "level_count_bomb": {**good, "model_config": {
            **good["model_config"], "level_count": 10**6}},
        "width_bomb": {**good, "model_config": {
            **good["model_config"], "base_width": 10**9}},
        "scaler_nan": {**good, "model_config": {
            **good["model_config"], "width_scaler": float("nan")}},
        "unknown_field": {**good, "model_config": {
            **good["model_config"], "evil": 1}},
        "dtype_evil": {**good, "model_config": {
            **good["model_config"], "compute_dtype": "float128"}},
        "classes_not_str": {**good, "anno_classes_json": 7},
        "downscale_nan": {**good, "downscaling_factor": float("nan")},
        "downscale_neg": {**good, "downscaling_factor": -2.0},
    }
    for name, meta in bad_metas.items():
        p = tmp_path / f"meta_{name}.dnn"
        _with_meta(model_file, p, meta)
        with pytest.raises(RuntimeError):
            serialization.load_model(str(p))


def test_model_allocation_bomb_rejected_before_decompression(
    model_file, tmp_path
):
    """A member DECLARING a multi-GB array (tiny on disk) must be rejected
    from its header — the shape disagrees with the architecture — without
    the allocation ever happening."""
    import resource

    with zipfile.ZipFile(model_file) as zf:
        victim = next(n for n in zf.namelist() if n != "__meta__.npy")
    p = tmp_path / "bomb.dnn"
    _rewrite_npz(
        model_file, p,
        lambda n, d: _fake_npy_header((65536, 65536)) if n == victim else d,
    )
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    with pytest.raises(RuntimeError):
        serialization.load_model(str(p))
    after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    # 65536^2 f32 = 16 GB if trusted; peak RSS must not have moved by
    # even 1% of that
    assert (after - before) < 160 * 1024, (before, after)  # KB units


def test_model_tree_mutations_fail_cleanly(model_file, tmp_path):
    with zipfile.ZipFile(model_file) as zf:
        members = [n for n in zf.namelist() if n != "__meta__.npy"]
    victim = members[0]

    # dropped parameter
    p = tmp_path / "missing.dnn"
    _rewrite_npz(model_file, p,
                 lambda n, d: None if n == victim else d)
    with pytest.raises(RuntimeError):
        serialization.load_model(str(p))

    # extra parameter
    p = tmp_path / "extra.dnn"
    with zipfile.ZipFile(model_file) as zin, zipfile.ZipFile(
        p, "w", zipfile.ZIP_DEFLATED
    ) as zout:
        for info in zin.infolist():
            zout.writestr(info.filename, zin.read(info.filename))
        zout.writestr("params/evil.npy", _npy_bytes(np.zeros(4, np.float32)))
    with pytest.raises(RuntimeError):
        serialization.load_model(str(p))

    # wrong shape for a declared parameter
    p = tmp_path / "reshaped.dnn"
    _rewrite_npz(
        model_file, p,
        lambda n, d: _npy_bytes(np.zeros((3, 3), np.float32))
        if n == victim else d,
    )
    with pytest.raises(RuntimeError):
        serialization.load_model(str(p))

    # object-dtype member (pickle smuggling)
    p = tmp_path / "object.dnn"
    buf = io.BytesIO()
    np.save(buf, np.array([{"a": 1}], dtype=object), allow_pickle=True)
    _rewrite_npz(
        model_file, p,
        lambda n, d: buf.getvalue() if n == victim else d,
    )
    with pytest.raises(RuntimeError):
        serialization.load_model(str(p))


def test_model_corrupt_member_payload_fails_cleanly(model_file, tmp_path):
    """Valid headers but corrupted compressed payload (bit flips past the
    header) must still raise cleanly at decompression time."""
    raw = bytearray(model_file.read_bytes())
    # flip bytes in the back half (array data, not the zip directory is
    # at the very end — flip mid-file)
    for i in range(len(raw) // 2, len(raw) // 2 + 64):
        raw[i] ^= 0xFF
    p = tmp_path / "bitflip.dnn"
    p.write_bytes(bytes(raw))
    with pytest.raises((RuntimeError, Exception)):
        serialization.load_model(str(p))


# ---------------------------------------------------------------------------
# trainer sync file
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sync_file(tmp_path_factory):
    from annonet_jax.train.trainer import Trainer, TrainerConfig

    path = tmp_path_factory.mktemp("artifacts") / "sync.dat"
    trainer = Trainer(CONFIG, TrainerConfig(initial_learning_rate=0.01))
    trainer.save_sync_file(str(path))
    return path


def test_sync_file_roundtrip_still_works(sync_file):
    trees, meta = serialization.load_trainer_state(str(sync_file))
    assert set(trees) == {"params", "bn_stats", "velocity"}
    assert meta["step_count"] == 0


def test_sync_file_truncations_fail_cleanly(sync_file, tmp_path):
    raw = sync_file.read_bytes()
    for frac in (0.0, 0.3, 0.95):
        p = tmp_path / f"sync_{frac}.dat"
        p.write_bytes(raw[: int(len(raw) * frac)])
        with pytest.raises(RuntimeError):
            serialization.load_trainer_state(str(p))
        with pytest.raises(RuntimeError):
            serialization.load_trainer_meta(str(p))


def test_sync_file_meta_mutations_fail_cleanly(sync_file, tmp_path):
    good = _meta_of(sync_file)
    bad = {
        "kind": {**good, "kind": "runtime_net"},
        "trees": {**good, "tree_names": ["params"]},
        "losses": {**good, "meta": {**good["meta"],
                                    "previous_loss_values": "evil"}},
        "step": {**good, "meta": {**good["meta"], "step_count": -3}},
        "lr": {**good, "meta": {**good["meta"],
                                "learning_rate": float("inf")}},
        "config_bomb": {**good, "meta": {**good["meta"], "model_config": {
            **good["meta"]["model_config"], "base_width": 10**9}}},
    }
    for name, meta in bad.items():
        p = tmp_path / f"sync_{name}.dat"
        _with_meta(sync_file, p, meta)
        with pytest.raises(RuntimeError):
            serialization.load_trainer_state(str(p))


def test_trainer_resume_from_corrupt_sync_file_is_a_clean_error(
    sync_file, tmp_path
):
    """Trainer resume (_try_resume) on a corrupt file must raise the
    loader's clean RuntimeError ("cannot resume: ... unreadable") — the
    CLI turns it into a one-line exit-1 — not crash."""
    from annonet_jax.train.trainer import Trainer, TrainerConfig

    p = tmp_path / "sync_bad.dat"
    p.write_bytes(sync_file.read_bytes()[:300])
    trainer = Trainer(CONFIG, TrainerConfig(initial_learning_rate=0.01))
    with pytest.raises(RuntimeError, match="cannot resume"):
        trainer._try_resume(str(p))


# ---------------------------------------------------------------------------
# calibration file
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def calibration_file(tmp_path_factory):
    import jax

    path = tmp_path_factory.mktemp("artifacts") / "cal.npz"
    params, stats = init_state(jax.random.PRNGKey(0), CONFIG)
    runtime = fold_batchnorm(params, stats, CONFIG)
    cal = [np.ones(4, np.float32), np.ones(8, np.float32)]
    serialization.save_calibration(str(path), cal, CONFIG, runtime)
    return path, runtime


def test_calibration_mutations_fail_cleanly(calibration_file, tmp_path):
    path, runtime = calibration_file
    raw = path.read_bytes()
    for frac in (0.0, 0.4, 0.95):
        p = tmp_path / f"cal_{frac}.npz"
        p.write_bytes(raw[: int(len(raw) * frac)])
        with pytest.raises(RuntimeError):
            serialization.load_calibration(str(p), CONFIG, runtime)

    good = _meta_of(path)
    bad_metas = {
        "count_str": {**good, "layer_count": "9"},
        "count_huge": {**good, "layer_count": 10**6},
        "count_mismatch": {**good, "layer_count": 1},
    }
    for name, meta in bad_metas.items():
        p = tmp_path / f"cal_{name}.npz"
        _with_meta(path, p, meta)
        with pytest.raises(RuntimeError):
            serialization.load_calibration(str(p), CONFIG, runtime)

    # a giant declared layer vector (allocation bomb)
    p = tmp_path / "cal_bomb.npz"
    _rewrite_npz(
        path, p,
        lambda n, d: _fake_npy_header((1 << 30,)) if n == "layer/000.npy"
        else d,
    )
    with pytest.raises(RuntimeError):
        serialization.load_calibration(str(p), CONFIG, runtime)

    # wrong model config and wrong weights still rejected (pre-existing
    # contract, now after the container checks)
    other = SegNetConfig(
        class_count=3, level_count=1, base_width=4,
        compute_dtype="float32",
    )
    with pytest.raises(RuntimeError):
        serialization.load_calibration(str(path), other)


# ---------------------------------------------------------------------------
# CLI surfaces: one-line error + exit 1 (annonet_infer / annonet_inspect)
# ---------------------------------------------------------------------------


def _write_corpus(tmp_path, model_file):
    corpus = {}
    corpus["trunc.dnn"] = model_file.read_bytes()[:500]
    corpus["garbage.dnn"] = b"\x89PNG\r\n\x1a\nnot a model"
    meta = _meta_of(model_file)
    bomb = tmp_path / "bomb_src.dnn"
    _with_meta(model_file, bomb, {**meta, "model_config": {
        **meta["model_config"], "base_width": 8192, "width_scaler": 1024.0}})
    corpus["bomb.dnn"] = bomb.read_bytes()
    paths = []
    for name, data in corpus.items():
        p = tmp_path / name
        p.write_bytes(data)
        paths.append(p)
    return paths


def test_cli_infer_corrupt_model_exits_1(model_file, tmp_path, capsys):
    from annonet_jax.cli.infer import main as infer_main

    data_dir = tmp_path / "data"
    data_dir.mkdir()
    from PIL import Image

    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(
        data_dir / "img.png"
    )
    for p in _write_corpus(tmp_path, model_file):
        rc = infer_main([str(data_dir), "--model", str(p)])
        out = capsys.readouterr()
        assert rc == 1, (p.name, out.out, out.err)
        # a clean one-line diagnosis naming the file, not a traceback
        assert "Traceback" not in out.out + out.err
        assert p.name in out.out + out.err


def test_cli_inspect_corrupt_model_exits_1(model_file, tmp_path, capsys):
    from annonet_jax.cli.inspect import main as inspect_main

    for p in _write_corpus(tmp_path, model_file):
        rc = inspect_main([str(p)])
        out = capsys.readouterr()
        assert rc == 1, (p.name, out.out, out.err)
        assert "Traceback" not in out.out + out.err
