"""Device mesh + sharding helpers (SURVEY.md section 2.2 / 3.5).

The primary parallel axis is 'data': FASTQ read batches are sharded over
devices; the index is replicated (GRCh38's fits one device) or,
in sharded-index mode, split over an 'idx' axis with collective merges.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bitmapperbs_tpu.config import AlignerConfig


def make_mesh(cfg: AlignerConfig, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    n = int(np.prod(cfg.mesh_shape))
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(cfg.mesh_shape)
    return Mesh(dev, cfg.mesh_axes)


def data_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, reads, lengths):
    """Place a (B, m) read batch + lengths with B sharded over 'data'."""
    s = data_sharding(mesh)
    return jax.device_put(reads, s), jax.device_put(lengths, s)
