"""Where the program keeps its compile cache, how much device memory the
tile forward may take, and how artifacts' npy headers are read — the
parts of the runtime environment that differ between machines."""

import io
import os
import pathlib
import zipfile

import jax
import numpy as np
import pytest

from annonet_jax.cli.common import (
    default_compilation_cache_dir,
    enable_compilation_cache,
)
from annonet_jax.infer import core

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def jax_cache_config(monkeypatch):
    """Restore jax's compile-cache settings after the test."""
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_enable_compilation_cache)
    monkeypatch.delenv("ANNONET_NO_COMPILATION_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_enable_compilation_cache", saved[1])


def test_default_cache_dir_is_fixed_inside_the_checkout():
    path = default_compilation_cache_dir()
    assert path == str(REPO / ".jax_cache")
    assert path == default_compilation_cache_dir()  # nothing time/pid-derived
    assert str(os.getpid()) not in path
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_installed_package_caches_in_the_user_cache_dir(monkeypatch,
                                                        tmp_path):
    """Outside a checkout (no pyproject.toml beside the package) the cache
    goes to the user's cache directory, not into site-packages."""
    from annonet_jax.cli import common

    site = tmp_path / "site-packages"
    monkeypatch.setattr(
        common, "__file__", str(site / "annonet_jax" / "cli" / "common.py")
    )
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    path = default_compilation_cache_dir()
    assert path == str(tmp_path / "cache" / "annonet_jax" / "jax")
    assert not path.startswith(str(site))


def test_cache_goes_to_the_checkout_when_jax_has_no_directory(
    jax_cache_config,
):
    enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    assert (REPO / ".jax_cache").is_dir()


def test_jax_compilation_cache_dir_is_honoured(jax_cache_config,
                                               monkeypatch, tmp_path):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    enable_compilation_cache()
    # the program sets no directory of its own: JAX reads the variable
    assert jax.config.jax_compilation_cache_dir is None


def test_no_compilation_cache_turns_the_cache_off(jax_cache_config,
                                                  monkeypatch):
    monkeypatch.setenv("ANNONET_NO_COMPILATION_CACHE", "1")
    enable_compilation_cache()
    assert jax.config.jax_enable_compilation_cache is False


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_activation_budget_follows_the_device_memory_limit():
    limit = 63_763_120_128
    device = _FakeDevice("gpu", {"bytes_limit": limit, "bytes_in_use": 7})
    assert core.activation_budget_bytes(device) == int(
        limit * core.ACTIVATION_SHARE
    )


def test_activation_budget_on_cpu_is_the_stated_constant():
    assert (core.activation_budget_bytes(jax.devices("cpu")[0])
            == core.CPU_ACTIVATION_BUDGET)


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_activation_budget_assumes_nothing_for_an_unknown_device(stats):
    with pytest.raises(RuntimeError, match="no memory limit"):
        core.activation_budget_bytes(_FakeDevice("gpu", stats))


def test_small_budget_chunks_the_forward_without_changing_labels(
    monkeypatch,
):
    from annonet_jax.infer.core import TiledInferer, annonet_infer
    from annonet_jax.infer.tiling import TilingParameters
    from annonet_jax.models.segnet import (
        SegNetConfig,
        fold_batchnorm,
        init_state,
    )

    config = SegNetConfig(class_count=3, level_count=1, base_width=8)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    tiling = TilingParameters(48, 48, 12, 12)
    image = np.random.default_rng(0).integers(
        0, 256, size=(120, 120, 3), dtype=np.uint8
    )
    whole = annonet_infer(TiledInferer(runtime, config, tiling), image)
    # a budget of about one tile's activations forces lax.map chunking
    devices = []
    monkeypatch.setattr(core, "activation_budget_bytes",
                        lambda device: devices.append(device) or 8 * 16 * 48 * 48)
    mapped = []
    real_map = core.lax.map
    monkeypatch.setattr(core.lax, "map", lambda f, xs: mapped.append(
        xs.shape[:2]) or real_map(f, xs))
    chunked = annonet_infer(TiledInferer(runtime, config, tiling), image)
    np.testing.assert_array_equal(chunked, whole)
    assert devices == [jax.devices()[0]]
    assert mapped and mapped[0][0] > 1  # several chunks of tiles


def _rewrite_member(path, member, version):
    """Rewrite one npz member with an npy header of ``version``."""
    with zipfile.ZipFile(path) as zf:
        members = {n: zf.read(n) for n in zf.namelist()}
    arr = np.load(io.BytesIO(members[member]))
    buf = io.BytesIO()
    np.lib.format.write_array(buf, arr, version=version)
    members[member] = buf.getvalue()
    with zipfile.ZipFile(path, "w") as zf:
        for name, data in members.items():
            zf.writestr(name, data)
    return arr


@pytest.mark.parametrize("version, loads", [((1, 0), True), ((2, 0), True),
                                             ((3, 0), False)])
def test_artifact_npy_header_versions(tmp_path, version, loads):
    from annonet_jax import serialization
    from annonet_jax.classes import anno_classes_to_json, default_anno_classes
    from annonet_jax.models.segnet import (
        SegNetConfig,
        fold_batchnorm,
        init_state,
    )

    config = SegNetConfig(class_count=3, level_count=0, base_width=8)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    path = str(tmp_path / "annonet.dnn")
    serialization.save_model(
        path, fold_batchnorm(params, bn, config), config,
        anno_classes_to_json(default_anno_classes()), 1.0,
    )
    with zipfile.ZipFile(path) as zf:
        member = next(n for n in zf.namelist() if n != "__meta__.npy")
    _rewrite_member(path, member, version)
    if loads:
        runtime, loaded_config, _, _ = serialization.load_model(path)
        assert loaded_config == config
    else:
        with pytest.raises(RuntimeError, match="npy format version"):
            serialization.load_model(path)
