"""Multi-host initialization.

The devices of one host are scaled over by the 1-D 'shards' mesh
(parallel/mesh.py). For several hosts, JAX's distributed runtime must
initialize BEFORE any backend use; afterwards ``jax.devices()`` spans all
hosts and the same mesh/shard_map code applies unchanged — collectives
ride the intra-host links within a host and the network across hosts.

The index's host mirrors stay per-process: each host owns the global arrays
(they are small relative to HBM at 10M chunks) and uploads its shard via the
NamedSharding placement, which puts only the local rows on local devices.
"""

from __future__ import annotations

import os


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed from args or standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID). No-op
    when unconfigured (single-host)."""
    import jax

    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator_address:
        return
    num_processes = num_processes if num_processes is not None else int(
        os.environ.get("JAX_NUM_PROCESSES", "1")
    )
    process_id = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "0")
    )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
