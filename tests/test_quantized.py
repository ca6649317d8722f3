"""int8 quantized folded runtime (models/quantized_runtime.py).

The quantized net computes the same function as the bf16 folded net up to
int8 grid rounding; these tests pin the error envelope (logit error, label
agreement) on random nets — where near-tie logits make agreement HARDEST —
and the API contract. End-to-end accuracy floors under int8 are asserted in
tests/test_end_to_end.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from annonet_jax.models.segnet import SegNetConfig, fold_batchnorm, init_state
from annonet_jax.models.folded_runtime import (
    apply_folded_split,
    fold_runtime_params,
    split_folded,
)
from annonet_jax.models.quantized_runtime import (
    apply_folded_int8,
    collect_calibration,
    quantize_folded,
    quantize_input,
)
from annonet_jax.infer.core import TiledInferer, annonet_infer
from annonet_jax.infer.tiling import TilingParameters


def _quantized_setup(config, image_shape, seed=0):
    params, bn = init_state(jax.random.PRNGKey(seed), config)
    runtime = fold_batchnorm(params, bn, config)
    fparams = fold_runtime_params(runtime, config, 8)
    (fold0, spec), arrays = split_folded(fparams)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=image_shape, dtype=np.uint8)
    calib = [
        np.asarray(m)
        for m in collect_calibration(
            arrays, jnp.asarray(x), config, fold0=fold0, spec=spec
        )
    ]
    qspec, qarrays = quantize_folded(spec, arrays, calib, config, fold0)
    return runtime, (fold0, spec, arrays), (qspec, qarrays), x


@pytest.mark.parametrize(
    "config",
    [
        SegNetConfig(class_count=3, level_count=2, base_width=16),
        SegNetConfig(class_count=2, level_count=0, base_width=16),
        SegNetConfig(class_count=4, level_count=1, base_width=16,
                     grayscale=True),
    ],
    ids=["rgb-l2", "rgb-l0", "gray-l1"],
)
def test_int8_logits_track_bf16(config):
    shape = (2, 64, 64, config.in_channels)
    _, (fold0, spec, arrays), (qspec, qarrays), x = _quantized_setup(
        config, shape
    )
    ref = np.asarray(
        apply_folded_split(
            arrays, jnp.asarray(x), config, fold0=fold0, spec=spec
        ),
        np.float32,
    )
    got = np.asarray(
        apply_folded_int8(
            qarrays, jnp.asarray(x), config, fold0=fold0, qspec=qspec
        )
    )
    # int8 grid error stays a small fraction of the logit spread, and the
    # argmax agrees except at near-ties (random nets are all near-ties)
    spread = ref.std()
    assert np.abs(got - ref).mean() < 0.1 * spread
    agreement = (got.argmax(-1) == ref.argmax(-1)).mean()
    assert agreement > 0.95, agreement


def test_pre_folded_input_matches_uint8_path():
    config = SegNetConfig(class_count=3, level_count=1, base_width=16)
    shape = (1, 32, 32, 3)
    _, (fold0, _spec, _arrays), (qspec, qarrays), x = _quantized_setup(
        config, shape
    )
    a = apply_folded_int8(
        qarrays, jnp.asarray(x), config, fold0=fold0, qspec=qspec
    )
    q = quantize_input(jnp.asarray(x), fold0, qspec)
    b = apply_folded_int8(
        qarrays, q, config, fold0=fold0, qspec=qspec, pre_folded=True
    )
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_folded_output_is_class_major_unfold():
    config = SegNetConfig(class_count=3, level_count=1, base_width=16)
    shape = (1, 32, 32, 3)
    _, (fold0, _spec, _arrays), (qspec, qarrays), x = _quantized_setup(
        config, shape
    )
    full = np.asarray(
        apply_folded_int8(
            qarrays, jnp.asarray(x), config, fold0=fold0, qspec=qspec
        )
    )
    folded = np.asarray(
        apply_folded_int8(
            qarrays, jnp.asarray(x), config, fold0=fold0, qspec=qspec,
            folded_output=True,
        )
    )
    n, h, wb, kf = folded.shape
    f = kf // config.class_count
    # class c's plane is the contiguous lane slice [c*f, (c+1)*f)
    for c in range(config.class_count):
        plane = folded[..., c * f : (c + 1) * f].reshape(n, h, wb * f)
        np.testing.assert_array_equal(plane, full[..., c])


def test_tiled_inferer_int8_agreement_and_detection():
    config = SegNetConfig(class_count=3, level_count=1, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    tiling = TilingParameters(64, 64, 20, 20)
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, size=(100, 100, 3), dtype=np.uint8)

    base = TiledInferer(runtime, config, tiling)
    quant = TiledInferer(runtime, config, tiling, quantize="int8")
    lb = annonet_infer(base, image)
    lq = annonet_infer(quant, image)
    assert lq.shape == lb.shape and lq.dtype == lb.dtype
    assert (lb == lq).mean() > 0.95

    # detection path: seeds come back and the veto composes
    lq2, seeds = quant.infer_arrays(
        image, detection_levels=[0.0, 0.2, 0.2]
    )
    assert seeds is not None and seeds.shape == lq2.shape

    # the compiled-program caches are per-mode: flipping back to the float
    # inferer still matches its own earlier output
    np.testing.assert_array_equal(annonet_infer(base, image), lb)


def test_chunked_forward_with_quantize():
    """Large images chunk the tile batch through lax.map; the chunk reshape
    must preserve the pre-quantized WIDTH-FOLDED tile shape (regression:
    an unfolded-shape reshape broke 8192^2 int8 inference)."""
    config = SegNetConfig(class_count=3, level_count=0, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    tiling = TilingParameters(48, 48, 10, 10)
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, size=(120, 120, 3), dtype=np.uint8)
    base = TiledInferer(runtime, config, tiling)
    chunked = TiledInferer(
        runtime, config, tiling, forward_chunk=2, quantize="int8"
    )
    unchunked = TiledInferer(runtime, config, tiling, quantize="int8")
    assert chunked.plan(*image.shape[:2]).tile_count > 2
    lc = annonet_infer(chunked, image)
    lu = annonet_infer(unchunked, image)
    np.testing.assert_array_equal(lc, lu)
    assert (lc == annonet_infer(base, image)).mean() > 0.95


def test_quantize_option_validation():
    config = SegNetConfig(class_count=3, level_count=1, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    with pytest.raises(ValueError):
        TiledInferer(runtime, config, quantize="int4")
    with pytest.raises(ValueError):
        TiledInferer(runtime, config, quantize="int8", use_folded_net=False)


def test_batched_inference_equals_per_image():
    """infer_arrays_batch / annonet_infer_batch: M same-size images in one
    device program, per-image results EXACTLY equal the single-image path
    (bf16 and int8), including detection seeds and the blob veto."""
    from annonet_jax.infer.core import annonet_infer_batch

    config = SegNetConfig(class_count=3, level_count=0, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    tiling = TilingParameters(48, 48, 10, 10)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(3, 80, 80, 3), dtype=np.uint8)
    det = [0.0, 0.1, 0.1]

    for kw in ({}, {"quantize": "int8"}):
        inf = TiledInferer(runtime, config, tiling, **kw)
        lb, sb = inf.infer_arrays_batch(images, detection_levels=det)
        assert lb.shape == (3, 80, 80) and sb.shape == (3, 80, 80)
        full = annonet_infer_batch(inf, images, detection_levels=det)
        for i in range(3):
            li, si = inf.infer_arrays(images[i], detection_levels=det)
            np.testing.assert_array_equal(li, lb[i])
            np.testing.assert_array_equal(si, sb[i])
            np.testing.assert_array_equal(
                full[i], annonet_infer(inf, images[i], detection_levels=det)
            )
        with pytest.raises(ValueError):
            inf.infer_arrays_batch(images[0])
        with pytest.raises(ValueError):
            inf.infer_arrays_batch(images[:0])


def test_calibration_images_accumulate_and_defer_freeze():
    """--calibration-images N semantics: the first N-1 images run the exact
    bf16 float program (bit-identical to the unquantized inferer), maxima
    accumulate across all N, and quantization freezes on image N."""
    config = SegNetConfig(class_count=3, level_count=1, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    tiling = TilingParameters(64, 64, 20, 20)
    rng = np.random.default_rng(1)
    images = [
        rng.integers(0, 256, size=(100, 100, 3), dtype=np.uint8)
        for _ in range(3)
    ]

    base = TiledInferer(runtime, config, tiling)
    quant = TiledInferer(
        runtime, config, tiling, quantize="int8", calibration_images=3
    )

    # images 1 and 2: float path, bit-identical to the unquantized inferer
    for img in images[:2]:
        np.testing.assert_array_equal(
            annonet_infer(quant, img), annonet_infer(base, img)
        )
        assert not quant._quantized_cache  # not frozen yet

    # image 3 freezes the int8 net and runs quantized
    l3 = annonet_infer(quant, images[2])
    assert quant._quantized_cache
    assert (l3 == annonet_infer(base, images[2])).mean() > 0.9

    # the frozen maxima dominate every contributing image's maxima
    fold0 = next(iter(quant._calib_frozen))
    assert quant._calib_seen[fold0] == 3

    with pytest.raises(ValueError, match="calibration_images"):
        TiledInferer(runtime, config, tiling, quantize="int8",
                     calibration_images=0)


def test_calibration_distribution_shift_detection_and_mitigation():
    """Calibrate dark -> infer bright: the overshoot telemetry must flag
    the shift, and spreading calibration over both exposures
    (calibration_images=2) must restore label agreement with the float
    path to the representative-calibration level."""
    config = SegNetConfig(class_count=3, level_count=1, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    tiling = TilingParameters(64, 64, 20, 20)
    rng = np.random.default_rng(2)
    # dark: a narrow low range; bright: full range
    dark = rng.integers(0, 32, size=(100, 100, 3), dtype=np.uint8)
    bright = rng.integers(0, 256, size=(100, 100, 3), dtype=np.uint8)

    base = TiledInferer(runtime, config, tiling)
    bright_float = annonet_infer(base, bright)

    # calibrated on the dark image only
    q_dark = TiledInferer(runtime, config, tiling, quantize="int8")
    annonet_infer(q_dark, dark)  # calibrates + freezes on dark
    agree_shifted = (annonet_infer(q_dark, bright) == bright_float).mean()

    # telemetry detects the shift: bright activations overshoot the
    # dark-calibrated range; the dark image itself fits (~1.0)
    overshoot_bright = q_dark.calibration_overshoot(bright)
    overshoot_dark = q_dark.calibration_overshoot(dark)
    assert overshoot_bright > 1.2, overshoot_bright
    assert overshoot_dark <= 1.05, overshoot_dark

    # mitigation: calibrate over BOTH images
    q_both = TiledInferer(
        runtime, config, tiling, quantize="int8", calibration_images=2
    )
    annonet_infer(q_both, dark)
    annonet_infer(q_both, bright)  # freeze includes bright maxima
    assert q_both._quantized_cache
    agree_mitigated = (annonet_infer(q_both, bright) == bright_float).mean()
    assert q_both.calibration_overshoot(bright) <= 1.05

    # representative calibration keeps the float-agreement floor; the
    # mitigated calibration must reach it and beat the shifted one
    assert agree_mitigated >= 0.95, (agree_shifted, agree_mitigated)
    assert agree_mitigated >= agree_shifted


def test_batched_calibration_uses_multiple_batch_images():
    """infer_arrays_batch feeds as many of its first batch as calibration
    still needs, so a single batched call can satisfy
    calibration_images > 1."""
    config = SegNetConfig(class_count=3, level_count=1, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    tiling = TilingParameters(64, 64, 20, 20)
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, size=(4, 100, 100, 3), dtype=np.uint8)

    quant = TiledInferer(
        runtime, config, tiling, quantize="int8", calibration_images=3
    )
    labels, _ = quant.infer_arrays_batch(images)
    assert labels.shape == (4, 100, 100)
    assert quant._quantized_cache  # froze inside the one batched call
    fold0 = next(iter(quant._calib_frozen))
    assert quant._calib_seen[fold0] == 3


def test_blend_dtype_default_and_override():
    """bf16 blend is the default iff the conv stack is int8 (measured
    +14% composed win, docs/DESIGN.md §15); float paths keep f32 for
    bit-parity. Explicit overrides pin either; labels stay in high
    agreement across blend dtypes."""
    config = SegNetConfig(class_count=3, level_count=1, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    tiling = TilingParameters(64, 64, 20, 20)

    assert TiledInferer(runtime, config, tiling).blend_dtype == jnp.float32
    q_auto = TiledInferer(runtime, config, tiling, quantize="int8")
    assert q_auto.blend_dtype == jnp.bfloat16
    q_f32 = TiledInferer(
        runtime, config, tiling, quantize="int8", blend_dtype="float32"
    )
    assert q_f32.blend_dtype == jnp.float32
    with pytest.raises(ValueError):
        TiledInferer(runtime, config, tiling, blend_dtype="float16")

    rng = np.random.default_rng(1)
    image = rng.integers(0, 256, size=(100, 100, 3), dtype=np.uint8)
    l_bf16 = annonet_infer(q_auto, image)
    l_f32 = annonet_infer(q_f32, image)
    assert (l_bf16 == l_f32).mean() > 0.99

    # the detection/seed path also runs under the bf16 blend
    labels, seeds = q_auto.infer_arrays(
        image, detection_levels=[0.0, 0.2, 0.2]
    )
    assert seeds is not None and seeds.shape == labels.shape


def test_calibration_export_load_roundtrip(tmp_path):
    """Persisted calibration (extension beyond the reference): export after freeze,
    load into a fresh inferer -> identical int8 labels from the FIRST
    image on, with no runtime calibration pass; config mismatch rejected."""
    from annonet_jax import serialization

    config = SegNetConfig(class_count=3, level_count=1, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    tiling = TilingParameters(64, 64, 20, 20)
    rng = np.random.default_rng(0)
    images = [
        rng.integers(0, 256, size=(100, 100, 3), dtype=np.uint8)
        for _ in range(2)
    ]

    source = TiledInferer(runtime, config, tiling, quantize="int8")
    assert source.export_calibration() is None  # nothing frozen yet
    labels = [annonet_infer(source, im) for im in images]

    path = str(tmp_path / "annonet.calib")
    exported = source.export_calibration()
    assert exported is not None
    serialization.save_calibration(path, exported, config)

    loaded = serialization.load_calibration(path, config)
    assert len(loaded) == len(exported)
    fresh = TiledInferer(
        runtime, config, tiling, quantize="int8", calibration=loaded
    )
    # image 0 ran the float path in `source` (pre-freeze); in `fresh` it
    # runs int8 immediately — so compare via a SECOND source pass where
    # both are frozen with identical scales
    np.testing.assert_array_equal(
        annonet_infer(fresh, images[1]), annonet_infer(source, images[1])
    )
    np.testing.assert_array_equal(
        annonet_infer(fresh, images[0]), annonet_infer(source, images[0])
    )
    # no runtime calibration ran in the fresh inferer
    assert fresh._calibrate_fns == {}

    other = SegNetConfig(class_count=3, level_count=2, base_width=16)
    with pytest.raises(RuntimeError, match="different model config"):
        serialization.load_calibration(path, other)
    with pytest.raises(ValueError, match="requires quantize"):
        TiledInferer(runtime, config, tiling, calibration=loaded)
    with pytest.raises(ValueError, match="layer"):
        TiledInferer(
            runtime, config, tiling, quantize="int8",
            calibration=loaded[:-1],
        ).infer_arrays(images[0])


def test_calibration_weights_fingerprint_rejects_retrained_model(tmp_path):
    """Same architecture, different trained weights -> load refuses
    (activation ranges are weight-dependent)."""
    from annonet_jax import serialization

    config = SegNetConfig(class_count=3, level_count=1, base_width=16)
    params_a, bn_a = init_state(jax.random.PRNGKey(0), config)
    runtime_a = fold_batchnorm(params_a, bn_a, config)
    params_b, bn_b = init_state(jax.random.PRNGKey(7), config)
    runtime_b = fold_batchnorm(params_b, bn_b, config)
    tiling = TilingParameters(64, 64, 20, 20)
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, size=(100, 100, 3), dtype=np.uint8)

    source = TiledInferer(runtime_a, config, tiling, quantize="int8")
    annonet_infer(source, image)
    path = str(tmp_path / "annonet.calib")
    serialization.save_calibration(
        path, source.export_calibration(), config, runtime_a
    )

    # same weights: loads fine
    serialization.load_calibration(path, config, runtime_a)
    # different weights, same config: refused
    with pytest.raises(RuntimeError, match="different trained weights"):
        serialization.load_calibration(path, config, runtime_b)
    # loader without params still works (fingerprint check is opt-in)
    assert serialization.load_calibration(path, config) is not None


def test_head_dot_and_conv_agree_exactly(monkeypatch):
    """The 1x1 int8 head as dot_general vs the conv emitter: identical
    integer math, so labels must agree bit-for-bit (docs/DESIGN.md
    par.24)."""
    config = SegNetConfig(class_count=3, level_count=1, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    tiling = TilingParameters(64, 64, 20, 20)
    rng = np.random.default_rng(3)
    image = rng.integers(0, 256, size=(100, 100, 3), dtype=np.uint8)

    out = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("ANNONET_HEAD_DOT", flag)
        inferer = TiledInferer(runtime, config, tiling, quantize="int8")
        out[flag] = annonet_infer(inferer, image)
    np.testing.assert_array_equal(out["0"], out["1"])


def test_stem_ycat_agrees_exactly(monkeypatch):
    """The stem as a y-tap-concat (1,3) conv vs the plain 3x3 emitter
    (ANNONET_STEM_YCAT=1, quantized_runtime.ycat_stem_qspec): int32
    accumulations of the same integer products, so logits and labels must
    agree bit-for-bit — including the grayscale :pad4 stem and image
    heights where the tile grid clamps tiles flush to the edge."""
    for config, seed in (
        (SegNetConfig(class_count=3, level_count=1, base_width=16), 3),
        (SegNetConfig(class_count=2, level_count=0, base_width=16,
                      grayscale=True), 5),
    ):
        params, bn = init_state(jax.random.PRNGKey(seed), config)
        runtime = fold_batchnorm(params, bn, config)
        tiling = TilingParameters(64, 64, 20, 20)
        rng = np.random.default_rng(seed)
        image = rng.integers(
            0, 256, size=(100, 90, config.in_channels), dtype=np.uint8
        )

        out = {}
        for flag in ("0", "1"):
            monkeypatch.setenv("ANNONET_STEM_YCAT", flag)
            inferer = TiledInferer(runtime, config, tiling, quantize="int8")
            out[flag] = annonet_infer(inferer, image)
            if flag == "1":
                # the rewrite must actually be in the executed spec
                rewritten = [
                    qspec for (qspec, _) in inferer._ycat_cache.values()
                ]
                assert rewritten and any(
                    k.split(":")[0] == "qy1" for k in rewritten[0]
                ), rewritten
        np.testing.assert_array_equal(out["0"], out["1"])


def test_stem_ycat_rewrites_only_the_stem():
    """ycat_stem_qspec rewrites the stem into a (1,3) kernel and leaves
    every later entry of the int8 spec as it was."""
    from annonet_jax.models.quantized_runtime import ycat_stem_qspec

    config = SegNetConfig(class_count=3, level_count=1, base_width=16)
    _, _, (qspec, qarrays), _ = _quantized_setup(config, (1, 64, 64, 3))
    yspec, yarrays = ycat_stem_qspec(qspec, qarrays)
    assert yspec[0].split(":")[0] in ("qy1",), yspec
    # everything after the stem is unchanged by the ycat rewrite
    assert yspec[1:] == tuple(qspec[1:])
    assert all(a is b for a, b in zip(yarrays[1:], qarrays[1:]))
    kh, kw, cin, cout = np.asarray(yarrays[0][0]).shape
    assert (kh, kw) == (1, 3) and cin % 3 == 0


def int8_conv_sum_consumers(closed_jaxpr) -> list:
    """How the program uses the int32 sum of each int8 x int8 conv, in a
    jaxpr and the jaxprs nested in it: (primitive, dtype) per use, or
    ("output", dtype) where the sum leaves its jaxpr."""
    uses = []

    def walk(jaxpr):
        for i, eqn in enumerate(jaxpr.eqns):
            for value in eqn.params.values():
                sub = getattr(value, "jaxpr", value)
                if hasattr(sub, "eqns"):
                    walk(sub)
            if eqn.primitive.name != "conv_general_dilated" or any(
                v.aval.dtype != jnp.int8 for v in eqn.invars
            ):
                continue
            total = eqn.outvars[0]
            for later in jaxpr.eqns[i + 1:]:
                if any(v is total for v in later.invars):
                    uses.append((later.primitive.name,
                                 later.outvars[0].aval.dtype))
            if any(v is total for v in jaxpr.outvars):
                uses.append(("output", total.aval.dtype))

    walk(closed_jaxpr.jaxpr)
    return uses


@pytest.mark.parametrize("head_dot", ["1", "0"])
def test_int8_conv_sums_feed_only_a_float32_convert(monkeypatch, head_dot):
    """XLA:GPU lowers an integer conv to cuDNN only with an s8 or f32
    output, so the int32 sum of every int8 conv must be used only through
    a float32 convert (which XLA folds into the cuDNN call)."""
    monkeypatch.setenv("ANNONET_HEAD_DOT", head_dot)
    config = SegNetConfig(class_count=3, level_count=2, base_width=16)
    _, (fold0, _spec, _arrays), (qspec, qarrays), x = _quantized_setup(
        config, (1, 64, 64, 3)
    )
    jaxpr = jax.make_jaxpr(
        lambda a, t: apply_folded_int8(a, t, config, fold0=fold0, qspec=qspec)
    )(qarrays, jnp.asarray(x))
    uses = int8_conv_sum_consumers(jaxpr)
    convs = sum(k.startswith("q") and k != "qhead" for k in qspec)
    assert len(uses) == convs + (head_dot == "0")
    assert set(uses) == {("convert_element_type", np.dtype("float32"))}
