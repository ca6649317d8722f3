"""Concurrency stress tests for the host runtime (the aux subsystem the
reference has no coverage for, SURVEY.md §5: thread safety rests on the
bounded pipe + shared LRU)."""

import threading

import numpy as np
import pytest

from annonet_jax.data.cache import SharedLruCache
from annonet_jax.data.crop import CropOptions
from annonet_jax.data.pipeline import CropPipeline


def test_cache_hammering_many_threads():
    """16 threads x 200 lookups over a 4-entry cache of 64 keys: every
    lookup must return the right value and each key loads at most a bounded
    number of times (re-loads only after eviction)."""
    loads = []
    lock = threading.Lock()

    def factory(k):
        with lock:
            loads.append(k)
        return k * 3

    cache = SharedLruCache(factory, capacity=4)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(200):
            k = int(rng.integers(0, 64))
            if cache(k) != k * 3:
                errors.append(k)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(loads) >= 64  # every key loaded at least once eventually


@pytest.mark.slow
def test_pipeline_sustained_throughput(tmp_path):
    """Many threads, tiny cache, sustained minibatch pulls: no deadlock, no
    duplicate-free starvation, clean shutdown."""
    from tests.test_end_to_end import write_synthetic_dataset, ANNO_CLASSES
    from annonet_jax.data.dataset import find_image_files

    write_synthetic_dataset(tmp_path, n_images=6, size=40)
    files = find_image_files(str(tmp_path), True, verbose=False)
    opts = CropOptions(dim=16)
    with CropPipeline(
        files,
        ANNO_CLASSES,
        opts,
        thread_count=8,
        cached_image_count=2,
        queue_depth=16,
        seed=3,
    ) as pipe:
        for _ in range(10):
            images, labels = pipe.next_minibatch(8, warn=None)
            assert images.shape == (8, 16, 16, 3)
            assert labels.shape == (8, 16, 16)
    # exiting the context joins all threads; reaching here means no deadlock
