"""Golden tests for per-pixel loss weighting.

The expected values are the reference's own unit-test vectors
(test/annonet_test.cpp:54-120) — the label row [0, ignore, 1, 0, 0] under
class_weight in {0, 0.5, 1} x image_weight in {0, 1}.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from annonet_jax.classes import IGNORE_LABEL
from annonet_jax.ops import batched_label_weights, set_weights


@pytest.fixture
def label_row():
    row = np.zeros((1, 5), dtype=np.uint16)
    row[0, 1] = IGNORE_LABEL
    row[0, 2] = 1
    return row


def test_weighs_pixels_equivalent(label_row):
    w = set_weights(label_row, 0.0, 0.0)
    np.testing.assert_allclose(w, [[1.0, 0.0, 1.0, 1.0, 1.0]])
    assert w.sum() == pytest.approx(4.0)


def test_weighs_classes_equivalent(label_row):
    w = set_weights(label_row, 1.0, 0.0)
    np.testing.assert_allclose(
        w, [[2 / 3, 0.0, 2.0, 2 / 3, 2 / 3]], atol=1e-6
    )
    assert w.sum() == pytest.approx(4.0, abs=1e-6)


def test_weighs_even_in_between(label_row):
    w = set_weights(label_row, 0.5, 0.0)
    e = 0.845299
    np.testing.assert_allclose(
        w, [[e, 0.0, e * math.sqrt(3), e, e]], atol=1e-6
    )
    assert w.sum() == pytest.approx(4.0, abs=1e-6)


def test_weighs_images_equivalent(label_row):
    w = set_weights(label_row, 0.0, 1.0)
    np.testing.assert_allclose(w, [[1.25, 0.0, 1.25, 1.25, 1.25]])
    assert w.sum() == pytest.approx(5.0)


def test_all_ignored_gives_zero():
    labels = np.full((3, 3), IGNORE_LABEL, dtype=np.uint16)
    w = set_weights(labels, 0.5, 0.5)
    np.testing.assert_array_equal(w, np.zeros((3, 3), np.float32))


@pytest.mark.parametrize("cw,iw", [(0, 0), (1, 0), (0.5, 0), (0, 1), (0.7, 0.3)])
def test_device_batched_matches_numpy(cw, iw, label_row):
    """The fused on-device weighting must agree with the golden host math."""
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 3, (4, 6, 7)).astype(np.uint16)
    batch[0, 0, 0] = IGNORE_LABEL
    batch[2] = IGNORE_LABEL  # one fully-ignored crop
    batch[3] = 1  # one single-class crop

    expected = np.stack([set_weights(b, cw, iw) for b in batch])
    got = np.asarray(batched_label_weights(jnp.asarray(batch.astype(np.int32)), cw, iw, 3))
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)

    got_row = np.asarray(
        batched_label_weights(jnp.asarray(label_row.astype(np.int32))[None], cw, iw, 2)
    )[0]
    np.testing.assert_allclose(got_row, set_weights(label_row, cw, iw), rtol=1e-5, atol=1e-6)
