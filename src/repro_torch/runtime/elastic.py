"""Elastic scaling: degraded meshes and batch re-fitting.

The JAX package's ``runtime/elastic.py`` over the port's ``Mesh``.  When
a chiplet group (a mesh row) dies, the survivors form the largest
rectangular sub-mesh without it; the checkpoint restores onto the new
mesh by reshard-on-load (``checkpoint.manager.load_pytree(...,
shardings=)``).  Algorithm 2's wrap-around arithmetic keeps shard->group
affinity contiguous on the survivors.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from repro_torch.launch.mesh import Mesh


def degraded_mesh(axis_sizes: Tuple[int, int], failed_rows: Sequence[int],
                  devices=None):
    """(data, model) mesh minus failed data rows (chiplet groups).

    Returns (mesh, kept_rows).  The model axis is preserved; data
    parallelism shrinks.  ``devices`` defaults to the ranks
    ``0 .. data * model - 1``."""
    data, model = axis_sizes
    devices = list(range(data * model)) if devices is None else list(devices)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    arr = arr[:data * model].reshape(data, model)
    failed = set(failed_rows)
    kept = [r for r in range(data) if r not in failed]
    return Mesh(arr[kept, :], ("data", "model")), kept


def rebatch_for(global_batch: int, data_shards: int) -> int:
    """Largest batch <= global_batch divisible by the surviving shards."""
    return max(data_shards, (global_batch // data_shards) * data_shards)
