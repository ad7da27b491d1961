"""Device mesh construction.

The reference has no distribution at all — a shared-memory thread pool is
its only parallelism (SURVEY.md §2.4). Every sharded stage here splits one
row axis (frames, cells, queries, points) across the devices and keeps the
model-side state replicated, so the mesh has one axis, ROWS. The
production sharded execution lives in parallel.mesh_pipeline (the
pipeline steps) and parallel.sharded_ops (library ops with psum /
all_gather collectives).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

ROWS = 'rows'


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the first n_devices local devices (all by default)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (ROWS,))
