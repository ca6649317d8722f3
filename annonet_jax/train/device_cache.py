"""HBM-resident decoded-image pool for training.

The device-side move the reference's LRU image cache
(annonet_train_main.cpp:504-510) points at: the host LRU already holds
decoded Samples; this pool mirrors the samples a minibatch references into
TWO device arrays — images [S, Hp, Wp, C] uint8 and labels [S, Hp, Wp]
uint16 — so each train step uploads ~20 bytes of crop indices per crop
instead of ~185 KB of crop pixels (the 60x gap between the device-step
rate and the e2e CLI rate on upload-bound hosts; docs/DESIGN.md §9).

Residency is keyed by Sample object identity: the host LRU owns decode
lifetimes, and a re-decoded image (new Sample) re-uploads, mirroring the
host cache's semantics exactly. Pool geometry grows monotonically (slot
count in powers of two, spatial dims in 256-px buckets) and every growth
re-uploads residents once; growth stops as soon as the pool has seen the
dataset's largest image.

Uploads update the pool in place via donated dynamic_update_slice jits
(one compiled updater per distinct image shape), so a cache hit steady
state moves zero image bytes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _bucket(v: int, b: int = 256) -> int:
    return ((v + b - 1) // b) * b


class DeviceImagePool:
    """Device-side LRU of decoded samples, host-managed."""

    def __init__(self, slots: int = 8, sharding=None):
        """``sharding``: an optional replicated NamedSharding(mesh, P()).
        When set, the pool arrays live replicated across the mesh so the
        data-parallel gather reads them without collectives — each image
        is uploaded once and broadcast, then every DP step ships only
        crop indices (the multi-chip version of the §11 design)."""
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self._sharding = sharding
        # LRU capacity (--cached-image-count analog). Slot ALLOCATION is
        # lazy: it grows in powers of two with the distinct residents
        # actually seen, so `--cached-image-count 64` on 4k-px images does
        # not eagerly pin 64 x bucketed-image HBM the run may never use.
        self._capacity = 1 << (slots - 1).bit_length()
        self._slots = 0  # allocated slots (grown by _ensure_geometry)
        self._height = 0
        self._width = 0
        self._channels = 0
        self.images: Optional[jnp.ndarray] = None  # [S, Hp, Wp, C] uint8
        self.labels: Optional[jnp.ndarray] = None  # [S, Hp, Wp] uint16
        # slot -> (sample_id, sample, h, w); LRU order by _tick
        self._resident: Dict[int, Tuple[int, object, int, int]] = {}
        self._by_id: Dict[int, int] = {}  # sample_id -> slot
        self._last_used: Dict[int, int] = {}  # slot -> tick
        self._tick = 0
        self._update_fns: Dict[Tuple, object] = {}
        self.uploads = 0  # telemetry: number of image uploads
        self.upload_bytes = 0

    # ------------------------------------------------------------ geometry

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return (self._slots, self._height, self._width, self._channels)

    def _ensure_geometry(self, h: int, w: int, c: int, needed_slots: int):
        """Grow the pool (slots and/or spatial dims) to fit; re-upload
        residents on growth."""
        new_slots = max(self._slots, 1)
        while new_slots < needed_slots:
            new_slots *= 2
        new_h = max(self._height, _bucket(h))
        new_w = max(self._width, _bucket(w))
        new_c = max(self._channels, c)
        if (
            self.images is not None
            and (new_slots, new_h, new_w, new_c) == self.shape
        ):
            return
        residents = list(self._resident.items())
        self._slots, self._height, self._width, self._channels = (
            new_slots, new_h, new_w, new_c,
        )
        self.images = self._zeros((new_slots, new_h, new_w, new_c), jnp.uint8)
        self.labels = self._zeros((new_slots, new_h, new_w), jnp.uint16)
        self._update_fns.clear()
        # re-upload the residents the host still references
        for slot, (sid, sample, sh, sw) in residents:
            self._upload(slot, sample)

    def _zeros(self, shape, dtype):
        if self._sharding is None:
            return jnp.zeros(shape, dtype)
        # allocate directly with the replicated sharding (no host round
        # trip, no reshard copy)
        return jax.jit(
            lambda: jnp.zeros(shape, dtype), out_shardings=self._sharding
        )()

    # ------------------------------------------------------------ residency

    def _upload(self, slot: int, sample) -> None:
        img = np.ascontiguousarray(sample.input_image)
        lab = np.ascontiguousarray(sample.label_image)
        key = (img.shape, lab.shape)
        fn = self._update_fns.get(key)
        if fn is None:
            # one compiled in-place updater per distinct image shape: the
            # upload then moves exactly the image's bytes, not the padded
            # slot's
            def update(pool_img, pool_lab, one_img, one_lab, s):
                pool_img = jax.lax.dynamic_update_slice(
                    pool_img, one_img[None], (s, 0, 0, 0)
                )
                pool_lab = jax.lax.dynamic_update_slice(
                    pool_lab, one_lab[None], (s, 0, 0)
                )
                return pool_img, pool_lab

            if self._sharding is None:
                fn = jax.jit(update, donate_argnums=(0, 1))
            else:
                fn = jax.jit(
                    update,
                    donate_argnums=(0, 1),
                    out_shardings=(self._sharding, self._sharding),
                )
            self._update_fns[key] = fn
        # np.int32, not jnp: the slot rides the update dispatch instead of
        # being its own eager transfer, and a committed single-device
        # scalar would be rejected by a multi-process (replicated) pool
        self.images, self.labels = fn(
            self.images, self.labels, img, lab, np.int32(slot)
        )
        self._resident[slot] = (
            id(sample), sample, img.shape[0], img.shape[1]
        )
        self._by_id[id(sample)] = slot
        self.uploads += 1
        self.upload_bytes += img.nbytes + lab.nbytes

    def all_resident(self, samples: List[object]) -> bool:
        """True when ensure() for this batch would be a pure lookup — no
        uploads, evictions, or pool-geometry growth. The trainer's
        superstep buffer requires this (buffered decisions reference pool
        slots by index, so the pool must stay untouched between them)."""
        return all(id(s) in self._by_id for s in samples)

    def ensure(self, samples: List[object], min_dim: int = 0) -> np.ndarray:
        """Make every sample resident; returns per-sample slot indices
        (int32 [len(samples)]). Grows the pool if the batch references
        more distinct samples than it has allocated, or a bigger image
        than it has seen.

        ``min_dim``: minimum spatial size of the pool's slots. The crop
        gather pulls a [min_dim, min_dim] dynamic_slice from a slot, so
        slots must be at least that large even when every IMAGE is
        smaller (images smaller than the crop dim are legal — the gather
        replicate-pads from the valid area, like host outpainting)."""
        distinct: Dict[int, object] = {}
        for s in samples:
            distinct.setdefault(id(s), s)
        max_h = max(s.input_image.shape[0] for s in distinct.values())
        max_w = max(s.input_image.shape[1] for s in distinct.values())
        channels = next(iter(distinct.values())).input_image.shape[2]
        missing = [
            s for sid, s in distinct.items() if sid not in self._by_id
        ]
        # lazy allocation target: everything resident after this call,
        # capped at the LRU capacity (beyond which eviction holds the
        # count) unless a single batch needs more distinct slots
        target_slots = max(
            len(distinct),
            min(len(self._resident) + len(missing), self._capacity),
        )
        self._ensure_geometry(
            max(max_h, min_dim), max(max_w, min_dim), channels, target_slots
        )
        if missing:
            # evict least-recently-used slots NOT referenced by this batch
            batch_ids = set(distinct.keys())
            free = [
                s for s in range(self._slots) if s not in self._resident
            ]
            evictable = sorted(
                (
                    s for s, (sid, *_rest) in self._resident.items()
                    if sid not in batch_ids
                ),
                key=lambda s: self._last_used.get(s, 0),
            )
            for sample in missing:
                slot = free.pop(0) if free else evictable.pop(0)
                old = self._resident.pop(slot, None)
                if old is not None:
                    self._by_id.pop(old[0], None)
                self._upload(slot, sample)

        self._tick += 1
        out = np.empty(len(samples), np.int32)
        for i, s in enumerate(samples):
            slot = self._by_id[id(s)]
            self._last_used[slot] = self._tick
            out[i] = slot
        return out

    def valid_dims(self, slot_idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Per-crop (valid_h, valid_w) int32 arrays for gather_crops."""
        hs = np.empty(len(slot_idx), np.int32)
        ws = np.empty(len(slot_idx), np.int32)
        for i, s in enumerate(slot_idx):
            _sid, _sample, h, w = self._resident[int(s)]
            hs[i] = h
            ws[i] = w
        return hs, ws
