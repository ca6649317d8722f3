#!/usr/bin/env python3
"""Which int8 convolution forms XLA:GPU compiles and runs, and into what.

    python scripts/probe_int8_conv.py

For each int8 conv shape of the int8 net and of the int8 training forward
(the shapes of tests/test_gpu.py), and for the int8 head dot, two forms:

  s32      the int32 accumulator is the program's output
  s32->f32 the int32 accumulator feeds a float32 epilogue, as in
           models/quantized_runtime.py and ops/int8_train.py

Each line says whether the form compiled and ran (and if so whether it is
exact against numpy's int64 sums), the library calls XLA made of it
(custom-call target with its operand and result types), or the first lines
of the error. A last section lists the library calls of the whole int8
flagship net on one 1024² tile. Runs on a GPU only.
"""

from __future__ import annotations

import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

SHAPES = [
    # (input NHWC, cout, stride, padding)
    ((4, 256, 128, 32), 128, (1, 1), ((1, 1), (1, 1))),
    ((4, 256, 128, 128), 128, (1, 1), ((1, 1), (1, 1))),
    ((4, 256, 128, 128), 128, (2, 1), ((0, 1), (0, 1))),
    ((8, 96, 96, 3), 16, (1, 1), ((1, 1), (1, 1))),
]

_INSTR = re.compile(
    r"^\s*(?:ROOT\s+)?(%?[\w.\-]+) = (\([^=]*?\)|\S+) ([\w\-]+)\((.*?)\)"
)


def library_calls(hlo_text: str) -> list:
    """'target: operand types -> result type' for each custom call in the
    optimized HLO."""
    types, calls = {}, []
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        name, result, op, operands = m.groups()
        types[name.lstrip("%")] = result
        target = re.search(r'custom_call_target="([^"]+)"', line)
        if op == "custom-call" and target:
            args = [types.get(a.strip().lstrip("%"), a.strip())
                    for a in operands.split(",") if a.strip()]
            calls.append(f"{target.group(1)}: {', '.join(args)} -> {result}")
    return calls


def first_error_lines(exc: BaseException, limit: int = 12) -> str:
    lines = []
    for line in str(exc).splitlines():
        if line.strip().startswith(("StackFrames", "HloModule", "ENTRY")):
            break
        if line.strip():
            lines.append(line.strip())
    return " | ".join(lines[:limit])


def conv_numpy(x, w, stride, padding):
    """Exact int64 NHWC/HWIO convolution."""
    kh, kw, _, cout = w.shape
    (pt, pb), (pl, pr) = padding
    xp = np.pad(x.astype(np.int64), ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    n, hp, wp, _ = xp.shape
    ho = (hp - kh) // stride[0] + 1
    wo = (wp - kw) // stride[1] + 1
    out = np.zeros((n, ho, wo, cout), np.int64)
    for dy in range(kh):
        for dx in range(kw):
            tap = xp[:, dy : dy + (ho - 1) * stride[0] + 1 : stride[0],
                     dx : dx + (wo - 1) * stride[1] + 1 : stride[1]]
            out += tap @ w[dy, dx].astype(np.int64)
    return out


def probe(label: str, fn, args, expected) -> None:
    try:
        compiled = jax.jit(fn).lower(*args).compile()
    except Exception as e:  # noqa: BLE001 — the probe reports every failure
        print(f"{label}: compile FAILED: {first_error_lines(e)}", flush=True)
        return
    calls = library_calls(compiled.as_text())
    try:
        out = np.asarray(compiled(*args))
    except Exception as e:  # noqa: BLE001
        print(f"{label}: compiled {calls}; run FAILED: "
              f"{first_error_lines(e)}", flush=True)
        return
    exact = bool(np.array_equal(out.astype(np.int64), expected))
    print(f"{label}: ok, exact={exact}; {calls}", flush=True)


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX's first device is {dev.platform}", flush=True)
        return 1
    from annonet_jax.utils.system import gpu_name_and_power_limit

    print(gpu_name_and_power_limit(), flush=True)
    print(f"jax {jax.__version__}, {dev.device_kind}", flush=True)
    rng = np.random.default_rng(0)
    for shape, cout, stride, padding in SHAPES:
        x = rng.integers(0, 128, size=shape, dtype=np.int8)
        w = rng.integers(-127, 128, size=(3, 3, shape[-1], cout),
                         dtype=np.int8)
        expected = conv_numpy(x, w, stride, padding)

        def conv(a, b, stride=stride, padding=padding):
            return lax.conv_general_dilated(
                a, b, stride, padding,
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                preferred_element_type=jnp.int32,
            )

        base = f"conv {shape} -> {cout} stride {stride}"
        probe(f"{base} [s32]", conv, (x, w), expected)
        probe(f"{base} [s32->f32]",
              lambda a, b, conv=conv: conv(a, b).astype(jnp.float32),
              (x, w), expected)

    x = rng.integers(0, 128, size=(4096, 128), dtype=np.int8)
    w = rng.integers(-127, 128, size=(128, 24), dtype=np.int8)
    expected = x.astype(np.int64) @ w.astype(np.int64)

    def dot(a, b):
        return lax.dot_general(a, b, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)

    probe("head dot (4096,128)x(128,24) [s32]", dot, (x, w), expected)
    probe("head dot (4096,128)x(128,24) [s32->f32]",
          lambda a, b: dot(a, b).astype(jnp.float32), (x, w), expected)

    net_calls()
    return 0


def net_calls(tile: int = 1024) -> None:
    """The library calls of the int8 flagship net on one tile."""
    from annonet_jax.models.folded_runtime import (
        fold_runtime_params,
        split_folded,
    )
    from annonet_jax.models.quantized_runtime import (
        apply_folded_int8,
        collect_calibration,
        quantize_folded,
    )
    from annonet_jax.models.segnet import (
        SegNetConfig,
        fold_batchnorm,
        init_state,
    )

    config = SegNetConfig(class_count=3, level_count=3, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    (fold0, spec), arrays = split_folded(
        fold_runtime_params(runtime, config, 8)
    )
    x = jnp.asarray(np.random.default_rng(1).integers(
        0, 256, size=(1, tile, tile, 3), dtype=np.uint8))
    calib = [np.asarray(m) for m in collect_calibration(
        arrays, x, config, fold0=fold0, spec=spec)]
    qspec, qarrays = quantize_folded(spec, arrays, calib, config, fold0)
    compiled = jax.jit(
        lambda a, t: apply_folded_int8(a, t, config, fold0=fold0,
                                       qspec=qspec)
    ).lower(qarrays, x).compile()
    print(f"int8 flagship net, one {tile}² tile:", flush=True)
    for call in library_calls(compiled.as_text()):
        print(f"  {call}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
