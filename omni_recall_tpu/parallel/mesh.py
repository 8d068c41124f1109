"""Device mesh helpers.

The reference has no distributed layer at all (single-process web app,
SURVEY.md §2.3); multi-device scaling is new scope. The chunk index shards
its row axis over a 1-D ``'shards'`` mesh: the cards of a host reach each
other all to all, so the mesh follows the algorithm alone. Multi-host runs
initialize via ``jax.distributed`` before mesh construction.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def shards_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the chunk axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(list(devices), axis_names=("shards",))


def row_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the leading (row) axis of an ndim-array over 'shards'."""
    return NamedSharding(mesh, P("shards", *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
