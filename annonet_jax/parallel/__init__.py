"""Parallelism (SURVEY.md §2.3): device meshes, data-parallel training with
gradient psum over ICI, and tile-sharded inference.

The reference is strictly single-device (--primary-cuda-device picks one
GPU, annonet_train_main.cpp:392-394); this package is the scale-out axis the
rebuild adds: pjit/shard_map over a jax.sharding.Mesh."""

from annonet_jax.parallel.mesh import make_mesh
from annonet_jax.parallel.train import DataParallelTrainer, make_dp_train_step

__all__ = ["DataParallelTrainer", "make_dp_train_step", "make_mesh"]
