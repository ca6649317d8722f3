"""Device-resident training data path.

The HBM image pool + on-device crop gather must reproduce the host
extraction path bit-for-bit — same crops, same random stream, same
training trajectory — while moving only ~20 bytes/crop host->device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from annonet_jax.classes import IGNORE_LABEL
from annonet_jax.data.crop import CropOptions, extract_crop
from annonet_jax.models.segnet import SegNetConfig
from annonet_jax.ops.crop_gather import gather_crops
from annonet_jax.train.device_cache import DeviceImagePool
from annonet_jax.train.trainer import Trainer, TrainerConfig


class FakeSample:
    def __init__(self, rng, h, w, c=3):
        self.input_image = rng.integers(
            0, 256, size=(h, w, c), dtype=np.uint8
        )
        self.label_image = rng.integers(
            0, 3, size=(h, w), dtype=np.uint16
        )


def test_gather_crops_matches_extract_crop_bit_exact():
    """The device gather (clamped-slice + in-tile takes + IGNORE mask)
    equals data/crop.py::extract_crop for interior, edge-overhanging,
    corner, and smaller-than-crop images."""
    rng = np.random.default_rng(0)
    dim = 24
    samples = [
        FakeSample(rng, 64, 80),
        FakeSample(rng, 40, 40),
        FakeSample(rng, 16, 20),  # smaller than the crop dim
    ]
    pool = DeviceImagePool(slots=4)

    cases = [
        (0, (10, 10, 33, 33)),      # interior
        (0, (-5, -7, 18, 16)),      # top-left overhang
        (0, (60, 45, 83, 68)),      # bottom-right overhang
        (1, (20, 20, 43, 43)),      # bottom-right edge
        (2, (-4, -2, 19, 21)),      # image smaller than dim
        (2, (0, 0, 23, 23)),
    ]
    batch_samples = [samples[i] for i, _ in cases]
    rects = [r for _, r in cases]
    slot_idx = pool.ensure(batch_samples)
    vh, vw = pool.valid_dims(slot_idx)
    y0 = np.asarray([r[1] for r in rects], np.int32)
    x0 = np.asarray([r[0] for r in rects], np.int32)

    images, labels = jax.jit(
        lambda *a: gather_crops(*a, dim=dim)
    )(
        pool.images, pool.labels,
        jnp.asarray(slot_idx), jnp.asarray(y0), jnp.asarray(x0),
        jnp.asarray(vh), jnp.asarray(vw),
    )
    images = np.asarray(images)
    labels = np.asarray(labels)

    for b, (si, rect) in enumerate(cases):
        exp_img, exp_lab = extract_crop(
            samples[si].input_image, samples[si].label_image, rect
        )
        np.testing.assert_array_equal(images[b], exp_img)
        np.testing.assert_array_equal(labels[b], exp_lab.astype(np.int64))
        if rect[0] < 0 or rect[1] < 0:
            assert (labels[b] == IGNORE_LABEL).any()


def test_gather_crops_flips_equal_flip_after_extract():
    """flip_lr/flip_ud inside the gather's permutation matmuls must equal
    mirroring the extracted crop afterwards — including the replicate-pad
    clamp and the IGNORE region — for interior, overhanging, and
    smaller-than-crop images and all four flip combinations."""
    rng = np.random.default_rng(7)
    dim = 24
    samples = [
        FakeSample(rng, 64, 80),
        FakeSample(rng, 16, 20),  # smaller than the crop dim
    ]
    pool = DeviceImagePool(slots=4)
    cases = [
        (0, (10, 10, 33, 33)),   # interior
        (0, (-5, -7, 18, 16)),   # top-left overhang
        (0, (60, 45, 83, 68)),   # bottom-right overhang
        (1, (-4, -2, 19, 21)),   # image smaller than dim
    ]
    batch_samples = [samples[i] for i, _ in cases]
    rects = [r for _, r in cases]
    slot_idx = pool.ensure(batch_samples)
    vh, vw = pool.valid_dims(slot_idx)
    y0 = np.asarray([r[1] for r in rects], np.int32)
    x0 = np.asarray([r[0] for r in rects], np.int32)
    args = (
        pool.images, pool.labels,
        jnp.asarray(slot_idx), jnp.asarray(y0), jnp.asarray(x0),
        jnp.asarray(vh), jnp.asarray(vw),
    )

    for lr, ud in [(False, False), (True, False), (False, True),
                   (True, True)]:
        fl = jnp.full(len(cases), lr)
        fu = jnp.full(len(cases), ud)
        images, labels = jax.jit(
            lambda *a: gather_crops(*a, dim=dim, flip_lr=fl, flip_ud=fu)
        )(*args)
        images, labels = np.asarray(images), np.asarray(labels)
        for b, (si, rect) in enumerate(cases):
            exp_img, exp_lab = extract_crop(
                samples[si].input_image, samples[si].label_image, rect
            )
            exp_lab = exp_lab.astype(np.int64)
            if lr:
                exp_img, exp_lab = exp_img[:, ::-1], exp_lab[:, ::-1]
            if ud:
                exp_img, exp_lab = exp_img[::-1], exp_lab[::-1]
            np.testing.assert_array_equal(images[b], exp_img)
            np.testing.assert_array_equal(labels[b], exp_lab)


def test_pool_residency_lru_growth_and_telemetry():
    rng = np.random.default_rng(1)
    pool = DeviceImagePool(slots=2)
    a, b, c = (FakeSample(rng, 32, 32) for _ in range(3))

    idx1 = pool.ensure([a, b, a])
    assert pool.uploads == 2
    assert idx1[0] == idx1[2] != idx1[1]

    # cache hit: no new uploads
    pool.ensure([b, a])
    assert pool.uploads == 2

    # third distinct sample evicts the least recently used (a was used
    # last, so b is evicted... both used in the last call; LRU by tick:
    # a and b share the last tick, c must evict ONE of them)
    pool.ensure([c])
    assert pool.uploads == 3
    resident_ids = set(pool._by_id.keys())
    assert id(c) in resident_ids and len(resident_ids) == 2

    # geometry growth (bigger image) re-uploads residents once
    big = FakeSample(rng, 300, 200)
    before = pool.uploads
    pool.ensure([big])
    assert pool.shape[1] >= 300 and pool.shape[2] >= 256
    # big upload + re-upload of the surviving residents
    assert pool.uploads >= before + 1
    # a batch with more distinct samples than slots grows the slot count
    many = [FakeSample(rng, 32, 32) for _ in range(5)]
    idx = pool.ensure(many)
    assert pool.shape[0] >= 5
    assert len(set(int(i) for i in idx)) == 5


def test_train_step_decisions_matches_train_step_crops():
    """Same decisions, same seed: the pool path and the pixel-upload path
    produce the same losses and parameters (the gather is bit-exact, the
    inner step is the same function)."""
    rng = np.random.default_rng(2)
    mc = SegNetConfig(
        class_count=3, level_count=1, base_width=4, compute_dtype="float32"
    )
    tc = TrainerConfig(initial_learning_rate=0.05)
    co = CropOptions(
        dim=16, allow_flip_left_right=True, noise_level_stddev=1.0
    )
    samples = [FakeSample(rng, 48, 64), FakeSample(rng, 30, 30)]
    pool = DeviceImagePool(slots=4)

    t_pix = Trainer(mc, tc, seed=0)
    t_pool = Trainer(mc, tc, seed=0)

    for step in range(4):
        batch_samples, rects = [], []
        for _ in range(8):
            s = samples[int(rng.integers(0, 2))]
            h, w = s.label_image.shape
            y = int(rng.integers(-8, h))
            x = int(rng.integers(-8, w))
            batch_samples.append(s)
            rects.append((x, y, x + co.dim - 1, y + co.dim - 1))

        images = np.stack(
            [
                extract_crop(s.input_image, s.label_image, r)[0]
                for s, r in zip(batch_samples, rects)
            ]
        )
        labels = np.stack(
            [
                extract_crop(s.input_image, s.label_image, r)[1]
                for s, r in zip(batch_samples, rects)
            ]
        )
        loss_pix = t_pix.train_step_crops(images, labels, co, seed=5)
        loss_pool = t_pool.train_step_decisions(
            pool, batch_samples, rects, co, seed=5
        )
        assert np.isclose(loss_pix, loss_pool, rtol=1e-5), (
            step, loss_pix, loss_pool,
        )

    for p1, p2 in zip(
        jax.tree_util.tree_leaves(t_pix.params),
        jax.tree_util.tree_leaves(t_pool.params),
    ):
        np.testing.assert_allclose(
            np.asarray(p1), np.asarray(p2), rtol=1e-5, atol=1e-7
        )
    # steady state: only the two distinct images ever uploaded
    assert pool.uploads == 2


def test_pipeline_next_decisions_matches_next_minibatch(tmp_path):
    """next_decisions consumes the same random stream as next_minibatch:
    extracting its decisions on the host reproduces the pixel batches."""
    from PIL import Image

    from annonet_jax.classes import default_anno_classes
    from annonet_jax.data.dataset import ImageFilenames
    from annonet_jax.data.pipeline import CropPipeline

    anno_classes = default_anno_classes()
    rng = np.random.default_rng(3)
    files = []
    for i in range(2):
        img = rng.integers(0, 256, size=(40, 40, 3), dtype=np.uint8)
        mask = np.zeros((40, 40, 4), dtype=np.uint8)
        mask[:, :20] = anno_classes[0].rgba_label
        mask[5:9, 25:30] = anno_classes[1].rgba_label
        p = tmp_path / f"im{i}.png"
        Image.fromarray(img).save(p)
        Image.fromarray(mask, mode="RGBA").save(
            tmp_path / f"im{i}.png_mask.png"
        )
        files.append(ImageFilenames(str(p), str(p) + "_mask.png"))

    options = CropOptions(dim=16)

    with CropPipeline(
        files, anno_classes, options, thread_count=1, seed=42
    ) as pipe:
        batches_px = [pipe.next_minibatch(4, warn=None) for _ in range(2)]
    with CropPipeline(
        files, anno_classes, options, thread_count=1, seed=42
    ) as pipe:
        batches_dec = [pipe.next_decisions(4, warn=None) for _ in range(2)]

    for (pi, pl), (kind, samples, rects) in zip(batches_px, batches_dec):
        assert kind == "decisions"
        for j, (s, r) in enumerate(zip(samples, rects)):
            img, lab = extract_crop(s.input_image, s.label_image, r)
            np.testing.assert_array_equal(pi[j], img)
            np.testing.assert_array_equal(pl[j], lab)


def test_next_decisions_pixel_fallback(tmp_path):
    """With a zero pin budget every crop materializes, so next_decisions
    degrades to the classic pixel batch — same contents."""
    from PIL import Image

    from annonet_jax.classes import default_anno_classes
    from annonet_jax.data.dataset import ImageFilenames
    from annonet_jax.data.pipeline import CropPipeline

    anno_classes = default_anno_classes()
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8)
    mask = np.zeros((32, 32, 4), dtype=np.uint8)
    mask[...] = anno_classes[0].rgba_label
    mask[4:8, 4:8] = anno_classes[1].rgba_label
    p = tmp_path / "im.png"
    Image.fromarray(img).save(p)
    Image.fromarray(mask, mode="RGBA").save(tmp_path / "im.png_mask.png")
    files = [ImageFilenames(str(p), str(p) + "_mask.png")]
    options = CropOptions(dim=16)

    with CropPipeline(
        files, anno_classes, options, thread_count=1, seed=9,
        pinned_bytes_budget=0,
    ) as pipe:
        kind, images, labels = pipe.next_decisions(4, warn=None)
    assert kind == "pixels"
    with CropPipeline(
        files, anno_classes, options, thread_count=1, seed=9,
        pinned_bytes_budget=0,
    ) as pipe:
        images2, labels2 = pipe.next_minibatch(4, warn=None)
    np.testing.assert_array_equal(images, images2)
    np.testing.assert_array_equal(labels, labels2)


@pytest.mark.slow
def test_cli_train_device_image_cache_round_trip(tmp_path, capsys):
    """annonet_train with the device image cache (default auto=on) trains
    end-to-end and exports a working model."""
    from tests.test_end_to_end import write_synthetic_dataset
    from annonet_jax.cli.infer import main as infer_main
    from annonet_jax.cli.train import main as train_main

    write_synthetic_dataset(tmp_path, n_images=3, size=48)
    model_path = str(tmp_path / "annonet.dnn")
    rc = train_main(
        [
            str(tmp_path),
            "--max-total-steps", "12",
            "-b", "4",
            "--level-count", "1",
            "--net-width-scaler", "0.5",
            "--input-dimension-multiplier", "1.0",
            "--initial-learning-rate", "0.05",
            "--data-loader-thread-count", "2",
            "--device-image-cache", "on",
            "--output", model_path,
            "--sync-file", str(tmp_path / "sync.dat"),
        ]
    )
    assert rc == 0
    capsys.readouterr()
    rc = infer_main([str(tmp_path), "--model", model_path])
    assert rc == 0
    out = capsys.readouterr().out
    assert "All result images written!" in out

    # --mesh + pool: the pool replicates over the DP mesh and the run
    # trains end-to-end (round-3 multi-chip extension)
    rc = train_main(
        [
            str(tmp_path),
            "--mesh", "2",
            "--device-image-cache", "on",
            "--max-total-steps", "4",
            "-b", "4",
            "--level-count", "1",
            "--net-width-scaler", "0.5",
            "--input-dimension-multiplier", "1.0",
            "--output", str(tmp_path / "annonet_dp.dnn"),
            "--sync-file", str(tmp_path / "sync_dp.dat"),
        ]
    )
    assert rc == 0
    capsys.readouterr()


def test_dp_pool_decisions_match_dp_pixels():
    """The replicated-pool DP path == the DP pixel path: the pool is
    replicated over the mesh and the ONE-program shard_mapped pool step
    slices each device's decision columns and gathers its crops in place
    — no collectives, no pixels host->device (round-3 multi-chip
    extension of the §11 design). Single-device comparison is only valid
    without stochastic augmentation (each DP shard draws its own local
    augment stream — see test_parallel.py), so the cross-check here is
    DP-vs-DP with augmentation on."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from annonet_jax.parallel.mesh import make_mesh
    from annonet_jax.parallel.train import DataParallelTrainer

    rng = np.random.default_rng(7)
    mc = SegNetConfig(
        class_count=3, level_count=1, base_width=4, compute_dtype="float32"
    )
    tc = TrainerConfig(initial_learning_rate=0.05)
    co = CropOptions(
        dim=16, allow_flip_left_right=True, noise_level_stddev=1.0
    )
    samples = [FakeSample(rng, 48, 64), FakeSample(rng, 30, 30)]

    mesh = make_mesh(axis_names=("batch",))
    t_dp_pool = DataParallelTrainer(mc, tc, seed=0, mesh=mesh)
    t_dp_pix = DataParallelTrainer(mc, tc, seed=0, mesh=mesh)
    pool_dp = DeviceImagePool(
        slots=4, sharding=NamedSharding(mesh, P())
    )

    for step in range(3):
        batch_samples, rects = [], []
        for _ in range(8):
            s = samples[int(rng.integers(0, 2))]
            h, w = s.label_image.shape
            y = int(rng.integers(-8, h))
            x = int(rng.integers(-8, w))
            batch_samples.append(s)
            rects.append((x, y, x + co.dim - 1, y + co.dim - 1))

        loss_dp_pool = t_dp_pool.train_step_decisions(
            pool_dp, batch_samples, rects, co, seed=5
        )
        images = np.stack(
            [
                extract_crop(s.input_image, s.label_image, r)[0]
                for s, r in zip(batch_samples, rects)
            ]
        )
        labels = np.stack(
            [
                extract_crop(s.input_image, s.label_image, r)[1]
                for s, r in zip(batch_samples, rects)
            ]
        )
        loss_dp_pix = t_dp_pix.train_step_crops(images, labels, co, seed=5)
        assert np.isclose(loss_dp_pix, loss_dp_pool, rtol=1e-5), (
            step, loss_dp_pix, loss_dp_pool,
        )

    for p1, p2 in zip(
        jax.tree_util.tree_leaves(t_dp_pix.params),
        jax.tree_util.tree_leaves(t_dp_pool.params),
    ):
        np.testing.assert_allclose(
            np.asarray(p1), np.asarray(p2), rtol=1e-5, atol=1e-7
        )
    # the decisions ran through the ONE-program shard_mapped pool step
    # (gather fused in), against a pool that stayed replicated
    assert ("fused", co.dim) in t_dp_pool._pool_step_fns
    assert pool_dp.images.sharding.spec in (P(), P(None, None, None, None))
    assert pool_dp.uploads == 2
    # decision batches not divisible by the mesh axis are rejected
    with pytest.raises(ValueError, match="divisible"):
        t_dp_pool.train_step_decisions(
            pool_dp, [samples[0]] * 3, [(0, 0, 15, 15)] * 3, co, seed=5
        )


def test_dp_superstep_matches_dp_single_dispatches():
    """--mesh + --steps-per-dispatch K: the shard_mapped lax.scan
    superstep (ONE dispatch for K DP steps) reproduces K single DP pool
    dispatches — same key stream, flips-in-gather, sync BN, and plateau
    bookkeeping; scan compilation may reorder reductions (1e-5)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from annonet_jax.parallel.mesh import make_mesh
    from annonet_jax.parallel.train import DataParallelTrainer

    rng = np.random.default_rng(13)
    mc = SegNetConfig(
        class_count=3, level_count=1, base_width=4, compute_dtype="float32"
    )
    co = CropOptions(
        dim=16, allow_flip_left_right=True, allow_flip_upside_down=True,
        noise_level_stddev=1.0,
    )
    samples = [FakeSample(rng, 48, 64), FakeSample(rng, 30, 30)]
    plans = []
    plan_rng = np.random.default_rng(14)
    for _ in range(6):
        batch_samples, rects = [], []
        for _ in range(8):
            s = samples[int(plan_rng.integers(0, 2))]
            h, w = s.label_image.shape
            y = int(plan_rng.integers(-8, h))
            x = int(plan_rng.integers(-8, w))
            batch_samples.append(s)
            rects.append((x, y, x + co.dim - 1, y + co.dim - 1))
        plans.append((batch_samples, rects))

    def run(k):
        tc = TrainerConfig(
            initial_learning_rate=0.05,
            steps_per_dispatch=k,
            loss_sync_interval=2 if k > 1 else 1,
        )
        mesh = make_mesh(axis_names=("batch",))
        t = DataParallelTrainer(mc, tc, seed=0, mesh=mesh)
        pool = DeviceImagePool(slots=4, sharding=NamedSharding(mesh, P()))
        for batch_samples, rects in plans:
            t.train_step_decisions(pool, batch_samples, rects, co, seed=5)
        t.flush_pending_steps()
        t.flush_losses()
        return t

    t1, t3 = run(1), run(3)
    assert t1.step_count == t3.step_count == len(plans)
    np.testing.assert_allclose(
        t1.previous_loss_values, t3.previous_loss_values, rtol=1e-5
    )
    for p1, p2 in zip(
        jax.tree_util.tree_leaves(t1.params),
        jax.tree_util.tree_leaves(t3.params),
    ):
        np.testing.assert_allclose(
            np.asarray(p1), np.asarray(p2), rtol=1e-5, atol=1e-7
        )


def test_pool_slots_allocate_lazily_and_crop_dim_floor():
    """Slot allocation grows with distinct residents (not eagerly to
    --cached-image-count), and slots are at least crop-dim-sized even
    when every image is smaller than the crop (the gather dynamic_slice
    needs a [dim, dim] window)."""
    rng = np.random.default_rng(11)
    pool = DeviceImagePool(slots=64)  # capacity 64, nothing allocated yet
    assert pool.shape[0] == 0

    small = [FakeSample(rng, 40, 48) for _ in range(2)]
    dim = 300  # larger than both the images and the 256-px bucket
    slot_idx = pool.ensure([small[0], small[1], small[0]], min_dim=dim)
    s, h, w, _c = pool.shape
    assert s == 2  # pow2(resident count), NOT 64
    assert h >= dim and w >= dim

    vh, vw = pool.valid_dims(slot_idx)
    rects = [(-4, -6, -4 + dim - 1, -6 + dim - 1)] * 3
    y0 = np.asarray([r[1] for r in rects], np.int32)
    x0 = np.asarray([r[0] for r in rects], np.int32)
    images, labels = jax.jit(
        lambda *a: gather_crops(*a, dim=dim)
    )(pool.images, pool.labels, jnp.asarray(slot_idx),
      jnp.asarray(y0), jnp.asarray(x0), jnp.asarray(vh), jnp.asarray(vw))
    for i, (sample, r) in enumerate(zip([small[0], small[1], small[0]], rects)):
        ref_img, ref_lab = extract_crop(
            sample.input_image, sample.label_image, r
        )
        np.testing.assert_array_equal(np.asarray(images[i]), ref_img)
        np.testing.assert_array_equal(
            np.asarray(labels[i]), ref_lab.astype(np.int32)
        )

    # LRU still honors capacity: adding a third image grows to 4 slots
    pool.ensure([FakeSample(rng, 40, 48)], min_dim=dim)
    assert pool.shape[0] == 4


def test_superstep_matches_single_dispatches_bit_exact():
    """steps_per_dispatch=K (ONE lax.scan program) reproduces K single
    dispatches: same key stream and per-step BN momenta; the scan-body
    compilation may reorder reductions, so equality is numerical
    (1e-5), not bit-level. Also covers the residency-guard flush (a
    non-resident batch mid-buffer) and the end-of-run tail flush."""
    rng = np.random.default_rng(4)
    mc = SegNetConfig(
        class_count=3, level_count=1, base_width=4, compute_dtype="float32"
    )
    co = CropOptions(
        dim=16, allow_flip_left_right=True, noise_level_stddev=1.0
    )
    samples = [FakeSample(rng, 48, 64), FakeSample(rng, 30, 30)]
    extra = FakeSample(rng, 40, 40)  # appears mid-run: triggers the guard

    def decisions(step_rng):
        batch_samples, rects = [], []
        for _ in range(8):
            pick = int(step_rng.integers(0, 3))
            s = (samples + [extra])[pick]
            h, w = s.label_image.shape
            y = int(step_rng.integers(-8, h))
            x = int(step_rng.integers(-8, w))
            batch_samples.append(s)
            rects.append((x, y, x + co.dim - 1, y + co.dim - 1))
        return batch_samples, rects

    def run(k):
        t = Trainer(
            mc,
            TrainerConfig(
                initial_learning_rate=0.05,
                steps_per_dispatch=k,
                loss_sync_interval=4,
            ),
            seed=0,
        )
        pool = DeviceImagePool(slots=4)
        step_rng = np.random.default_rng(11)
        for _ in range(7):  # 7 steps: K=3 leaves a 1-step tail to flush
            t.train_step_decisions(pool, *decisions(step_rng), co, seed=5)
        t.flush_pending_steps()
        t.flush_losses()
        return t

    t1 = run(1)
    t3 = run(3)
    assert t1.step_count == t3.step_count == 7
    np.testing.assert_allclose(
        np.asarray(t1.previous_loss_values),
        np.asarray(t3.previous_loss_values), rtol=1e-5,
    )
    for p1, p2 in zip(
        jax.tree_util.tree_leaves(t1.params),
        jax.tree_util.tree_leaves(t3.params),
    ):
        np.testing.assert_allclose(
            np.asarray(p1), np.asarray(p2), rtol=1e-4, atol=1e-6
        )
    for b1, b2 in zip(
        jax.tree_util.tree_leaves(t1.bn_stats),
        jax.tree_util.tree_leaves(t3.bn_stats),
    ):
        np.testing.assert_allclose(
            np.asarray(b1), np.asarray(b2), rtol=1e-4, atol=1e-6
        )


def test_pixel_batch_flushes_superstep_buffer():
    """A pixel batch (the pipeline's pin-budget fallback path) must not
    overtake buffered superstep decisions: train_step_crops flushes the
    buffer first, keeping step order and the BN-momentum schedule
    sequential, and the trajectory equals the steps_per_dispatch=1 run."""
    rng = np.random.default_rng(6)
    mc = SegNetConfig(
        class_count=3, level_count=1, base_width=4, compute_dtype="float32"
    )
    co = CropOptions(dim=16, allow_flip_left_right=True)
    samples = [FakeSample(rng, 48, 64), FakeSample(rng, 30, 30)]

    def decisions(step_rng):
        batch_samples, rects = [], []
        for _ in range(8):
            s = samples[int(step_rng.integers(0, 2))]
            h, w = s.label_image.shape
            y = int(step_rng.integers(-8, h))
            x = int(step_rng.integers(-8, w))
            batch_samples.append(s)
            rects.append((x, y, x + co.dim - 1, y + co.dim - 1))
        return batch_samples, rects

    def pixel_batch(step_rng):
        bs, rects = decisions(step_rng)
        images = np.stack(
            [extract_crop(s.input_image, s.label_image, r)[0]
             for s, r in zip(bs, rects)]
        )
        labels = np.stack(
            [extract_crop(s.input_image, s.label_image, r)[1]
             for s, r in zip(bs, rects)]
        )
        return images, labels

    def run(k):
        t = Trainer(
            mc,
            TrainerConfig(
                initial_learning_rate=0.05, steps_per_dispatch=k,
                loss_sync_interval=4,
            ),
            seed=0,
        )
        pool = DeviceImagePool(slots=4)
        step_rng = np.random.default_rng(13)
        # 2 decision steps (buffered under K=4), then a PIXEL step, then
        # 2 more decision steps
        for _ in range(2):
            t.train_step_decisions(pool, *decisions(step_rng), co, seed=5)
        if k > 1:
            assert len(t._superstep_buffer) == 2
        t.train_step_crops(*pixel_batch(step_rng), co, seed=5)
        if k > 1:  # the pixel step flushed the buffer before running
            assert t._superstep_buffer == []
        assert t.step_count == 3
        for _ in range(2):
            t.train_step_decisions(pool, *decisions(step_rng), co, seed=5)
        t.flush_pending_steps()
        t.flush_losses()
        return t

    t1, t4 = run(1), run(4)
    np.testing.assert_allclose(
        np.asarray(t1.previous_loss_values),
        np.asarray(t4.previous_loss_values), rtol=1e-5,
    )


def test_dp_pixel_batch_flushes_superstep_buffer():
    """DataParallelTrainer.train_step_crops must flush buffered superstep
    decisions before a pixel batch, like the base Trainer (the pin-budget
    fallback's batches must not overtake the buffered steps' BN-momentum
    indices): trajectory equals the steps_per_dispatch=1 run."""
    from annonet_jax.parallel.mesh import make_mesh
    from annonet_jax.parallel.train import DataParallelTrainer

    rng = np.random.default_rng(21)
    mc = SegNetConfig(
        class_count=3, level_count=1, base_width=4, compute_dtype="float32"
    )
    co = CropOptions(dim=16, allow_flip_left_right=True)
    samples = [FakeSample(rng, 48, 64), FakeSample(rng, 30, 30)]
    mesh = make_mesh(8)

    def decisions(step_rng):
        batch_samples, rects = [], []
        for _ in range(8):
            s = samples[int(step_rng.integers(0, 2))]
            h, w = s.label_image.shape
            y = int(step_rng.integers(-8, h))
            x = int(step_rng.integers(-8, w))
            batch_samples.append(s)
            rects.append((x, y, x + co.dim - 1, y + co.dim - 1))
        return batch_samples, rects

    def pixel_batch(step_rng):
        bs, rects = decisions(step_rng)
        images = np.stack(
            [extract_crop(s.input_image, s.label_image, r)[0]
             for s, r in zip(bs, rects)]
        )
        labels = np.stack(
            [extract_crop(s.input_image, s.label_image, r)[1]
             for s, r in zip(bs, rects)]
        )
        return images, labels

    def run(k):
        from jax.sharding import NamedSharding, PartitionSpec

        t = DataParallelTrainer(
            mc,
            TrainerConfig(
                initial_learning_rate=0.05, steps_per_dispatch=k,
                loss_sync_interval=4,
            ),
            seed=0,
            mesh=mesh,
        )
        pool = DeviceImagePool(
            slots=4, sharding=NamedSharding(mesh, PartitionSpec())
        )
        step_rng = np.random.default_rng(13)
        for _ in range(2):
            t.train_step_decisions(pool, *decisions(step_rng), co, seed=5)
        if k > 1:
            assert len(t._superstep_buffer) == 2
        t.train_step_crops(*pixel_batch(step_rng), co, seed=5)
        if k > 1:  # the pixel step flushed the buffer before running
            assert t._superstep_buffer == []
        assert t.step_count == 3
        for _ in range(2):
            t.train_step_decisions(pool, *decisions(step_rng), co, seed=5)
        t.flush_pending_steps()
        t.flush_losses()
        return t

    t1, t4 = run(1), run(4)
    assert t1.step_count == t4.step_count == 5
    for p1, p2 in zip(
        jax.tree_util.tree_leaves(t1.params),
        jax.tree_util.tree_leaves(t4.params),
    ):
        np.testing.assert_allclose(
            np.asarray(p1), np.asarray(p2), rtol=1e-4, atol=1e-6
        )
