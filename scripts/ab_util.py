"""Shared interleaved-A/B harness for composed inference measurements.

One process, arms interleaved (A B A B ...) so clock and power drift of
the card hits every arm equally (DESIGN.md §14); each pass is timed on the
host clock up to jax.block_until_ready on its last result. Used by
scripts/ab_argmax_norm.py, ab_blend_strips.py, ab_gather_order.py and
ab_stem_ycat.py.
"""

import os
import time


def run_interleaved_ab(make_inferer, arms, image, *, warmup_calls=2,
                       iters=5, rounds=4):
    """Measure len(arms) trace-time-knob variants of one composed program.

    make_inferer: () -> TiledInferer, built fresh per arm AFTER that
        arm's env vars are set (trace-time knobs; each inferer caches its
        own compiled programs, so the knob value at warm-up is the one
        that sticks).
    arms: [(name, {env_key: value_or_None})] — None deletes the key.
        All touched keys are restored to their pre-run values afterwards
        (no env leak into whatever runs in-process next).
    image: device-resident jnp uint8 input.
    warmup_calls: calls per arm before timing (compile + calibration).

    Prints label disagreements of every arm vs the first, then median
    rates over `rounds` interleaved passes of `iters` chained calls.
    """
    import jax
    import jax.numpy as jnp

    h, w = image.shape[:2]
    mpx = h * w * iters / 1e6
    touched = {k for _, env in arms for k in env}
    saved = {k: os.environ.get(k) for k in touched}

    inferers = {}
    outs = {}
    try:
        for name, env in arms:
            for k in touched:
                os.environ.pop(k, None)
            for k, v in env.items():
                if v is not None:
                    os.environ[k] = v
            inf = make_inferer()
            for _ in range(warmup_calls):
                labels, _ = jax.block_until_ready(
                    inf.infer_arrays(image, device_output=True)
                )
            inferers[name] = inf
            outs[name] = labels
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    ref_name = arms[0][0]
    for name, _ in arms[1:]:
        mism = int(jnp.sum(outs[ref_name] != outs[name]))
        print(f"label disagreement {ref_name}-vs-{name}: {mism} px "
              f"({mism / h / w:.5%})", flush=True)

    rates = {name: [] for name, _ in arms}
    for _r in range(rounds):
        for name, inf in inferers.items():
            t0 = time.perf_counter()
            for _ in range(iters):
                labels, _ = inf.infer_arrays(image, device_output=True)
            jax.block_until_ready(labels)
            rates[name].append(
                mpx / max(1e-9, time.perf_counter() - t0)
            )
    for name, rs in rates.items():
        med = sorted(rs)[len(rs) // 2]
        print(f"{name}: median {med:.1f} Mpx/s  "
              f"({['%.1f' % r for r in rs]})", flush=True)
    return rates
