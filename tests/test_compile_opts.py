"""utils/compile_opts.py: the env-gated per-program compiler-options hook.

Backend-specific option names cannot be validated on the CPU test
backend; these tests cover the contract around them — parsing, the jit-identical default
path, signature caching, and the fallback for unrepresentable arguments.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from annonet_jax.utils.compile_opts import (
    _signature,
    get_compiler_options,
    opt_jit,
)


def test_parse_unset(monkeypatch):
    monkeypatch.delenv("ANNONET_COMPILER_OPTIONS", raising=False)
    assert get_compiler_options() is None
    monkeypatch.setenv("ANNONET_COMPILER_OPTIONS", "   ")
    assert get_compiler_options() is None


def test_parse_pairs(monkeypatch):
    monkeypatch.setenv(
        "ANNONET_COMPILER_OPTIONS",
        "xla_a=1, xla_b=true xla_c=2.5",
    )
    assert get_compiler_options() == {
        "xla_a": "1", "xla_b": "true", "xla_c": "2.5"
    }


def test_parse_rejects_bare_token(monkeypatch):
    monkeypatch.setenv("ANNONET_COMPILER_OPTIONS", "xla_no_value")
    with pytest.raises(ValueError):
        get_compiler_options()


def test_default_path_matches_jit(monkeypatch):
    monkeypatch.delenv("ANNONET_COMPILER_OPTIONS", raising=False)
    f = opt_jit(lambda x: x * 2 + 1)
    x = jnp.arange(8, dtype=jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(f(x)), np.asarray(jax.jit(lambda x: x * 2 + 1)(x))
    )


def test_option_path_compiles_and_caches(monkeypatch):
    # an EMPTY-VALUE known-shape exercise: CPU accepts generic options via
    # the AOT path only if the name is known; use a debug option the CPU
    # compiler understands on all backends
    monkeypatch.setenv(
        "ANNONET_COMPILER_OPTIONS", "xla_embed_ir_in_executable=True"
    )
    calls = {"n": 0}

    def fn(x):
        calls["n"] += 1
        return jnp.sum(x * x)

    f = opt_jit(fn)
    x = jnp.arange(16, dtype=jnp.float32)
    a = float(f(x))
    b = float(f(x))  # second call: cached executable, no retrace
    assert a == b == float(np.sum(np.arange(16.0) ** 2))
    assert calls["n"] == 1
    assert len(f._compiled) == 1
    # a new signature compiles separately
    y = jnp.arange(8, dtype=jnp.float32)
    float(f(y))
    assert len(f._compiled) == 2


def test_host_scalars_ride_signature(monkeypatch):
    monkeypatch.setenv(
        "ANNONET_COMPILER_OPTIONS", "xla_embed_ir_in_executable=True"
    )
    f = opt_jit(lambda x, lr: x * lr)
    x = jnp.ones((4,), jnp.float32)
    # np scalars are traced (not baked): different VALUES share one program
    a = np.asarray(f(x, np.float32(2.0)))
    b = np.asarray(f(x, np.float32(3.0)))
    np.testing.assert_array_equal(a, np.full(4, 2.0, np.float32))
    np.testing.assert_array_equal(b, np.full(4, 3.0, np.float32))
    assert len(f._compiled) == 1


def test_unrepresentable_args_fall_back(monkeypatch):
    # a pytree leaf with neither shape/dtype nor scalar type cannot be
    # keyed -> the wrapper must route to the plain jitted callable
    # (defensive: no shipped call site passes such leaves)
    assert _signature(({"a": object()},)) is None


def test_bogus_option_rejected_at_compile(monkeypatch):
    monkeypatch.setenv(
        "ANNONET_COMPILER_OPTIONS", "xla_totally_bogus_option_xyz=1"
    )
    f = opt_jit(lambda x: x + 1)
    with pytest.raises(Exception):
        f(jnp.ones((2,)))
