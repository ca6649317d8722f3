"""Opt-in per-program XLA compiler options (a backend tuning hook).

Options are passed per compile through the AOT path (``jax.jit(f).lower(
args).compile(compiler_options=...)``), which ships them to the backend
compiler — the backend parses them for real (bogus names are rejected).
Unlike ``XLA_FLAGS``, they apply to the wrapped programs only.

``ANNONET_COMPILER_OPTIONS`` holds space- or comma-separated ``k=v``
pairs, e.g.::

    ANNONET_COMPILER_OPTIONS="xla_gpu_enable_latency_hiding_scheduler=true"

When unset (the default) ``opt_jit`` is exactly ``jax.jit`` — zero
overhead, zero behavior change. When set, compiled executables are cached
per abstract argument signature (shape/dtype), mirroring jit's own cache;
anything the signature scheme cannot represent falls back to the plain
jitted call rather than failing.

This exists for performance exploration on real deployments (the
reference has no analog — its dlib/CUDA path has no compiler to tune);
the shipped defaults never set it.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import jax

_ENV = "ANNONET_COMPILER_OPTIONS"


def get_compiler_options() -> Optional[Dict[str, str]]:
    """Parse ``ANNONET_COMPILER_OPTIONS`` (None when unset/empty)."""
    raw = os.environ.get(_ENV, "").strip()
    if not raw:
        return None
    opts: Dict[str, str] = {}
    for token in raw.replace(",", " ").split():
        if "=" not in token:
            raise ValueError(
                f"{_ENV}: expected k=v pairs, got {token!r}"
            )
        k, v = token.split("=", 1)
        opts[k] = v
    return opts or None


def _signature(tree: Any) -> Optional[tuple]:
    """Hashable abstract signature of a pytree of call arguments."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    sig = []
    for leaf in leaves:
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            # weak_type distinguishes python-scalar-promoted arrays; jit
            # itself keys on it, so the AOT cache must too
            weak = bool(getattr(leaf, "weak_type", False))
            sig.append((tuple(leaf.shape), str(leaf.dtype), weak))
        elif isinstance(leaf, (bool, int, float, complex, str, bytes)):
            sig.append((type(leaf).__name__, leaf))
        else:
            return None  # unrepresentable -> caller falls back to jit
    return (treedef, tuple(sig))


class _OptJit:
    """jax.jit plus per-signature AOT compiles carrying compiler options."""

    def __init__(self, fn: Callable, jit_kwargs: Dict[str, Any]):
        self._jitted = jax.jit(fn, **jit_kwargs)
        self._compiled: Dict[tuple, Any] = {}

    def __call__(self, *args, **kwargs):
        opts = get_compiler_options()
        if opts is None:
            return self._jitted(*args, **kwargs)
        key = _signature((args, kwargs))
        if key is None:
            return self._jitted(*args, **kwargs)
        exe = self._compiled.get(key)
        if exe is None:
            exe = self._jitted.lower(*args, **kwargs).compile(
                compiler_options=opts
            )
            self._compiled[key] = exe
        return exe(*args, **kwargs)

    # pass-throughs so callers can still .lower() for inspection
    def lower(self, *args, **kwargs):
        return self._jitted.lower(*args, **kwargs)


def opt_jit(fn: Callable, **jit_kwargs) -> Callable:
    """Drop-in ``jax.jit`` honoring ``ANNONET_COMPILER_OPTIONS``.

    The env var is re-read per call, so a long-lived process (or a sweep
    script) can flip options between compiles of new signatures; already
    compiled signatures keep the options they were built with.
    """
    return _OptJit(fn, jit_kwargs)
