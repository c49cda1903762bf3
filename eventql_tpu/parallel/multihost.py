"""Multi-host execution tier: one global device mesh over N processes.

The reference scales a query across machines by shipping serialized
plan shards to partition servers over TCP and merging result frames on
the coordinator (reference: server/sql/scheduler.cc:164-264,
transport/native/client_tcp.h:109). The device equivalent keeps
every mesh primitive in parallel/distributed.py unchanged and simply
enlarges the mesh: `jax.distributed` connects the processes, the mesh
spans all global devices, and XLA routes each collective over the device interconnect
within a host and DCN between hosts. A host owns the table rows that
live on its local devices — the moral analog of the reference's
partition-server data locality.

Used by tests/test_multihost.py, which spawns real worker processes
(the test/automate cluster.cc pattern) and checks the distributed
GROUP BY / sort / sharded GROUP BY primitives for exactness across
process boundaries.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P


def init_multihost(
    coordinator_address: str, num_processes: int, process_id: int
) -> None:
    """Join the global distributed runtime (idempotent per process)."""
    jax.distributed.initialize(
        coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "shards") -> Mesh:
    """A 1-D mesh over every device of every connected process."""
    return Mesh(np.array(jax.devices()), (axis,))


def make_global_array(
    mesh: Mesh, full: np.ndarray, axis: str = "shards"
) -> jax.Array:
    """Assemble a globally-sharded array (leading axis split across the
    whole mesh). Every process passes the same logical `full` array and
    places only the slices owned by its local devices — no cross-host
    data movement happens here; in production each host materializes
    only its own slice (the table rows it owns)."""
    devs = list(mesh.devices.flat)
    n = full.shape[0]
    if n % len(devs):
        raise ValueError(
            f"rows ({n}) must divide evenly over {len(devs)} devices"
        )
    per = n // len(devs)
    pos = {d: i for i, d in enumerate(devs)}
    sharding = NamedSharding(mesh, P(axis))
    local = [
        jax.device_put(full[pos[d] * per : (pos[d] + 1) * per], d)
        for d in jax.local_devices()
    ]
    return jax.make_array_from_single_device_arrays(
        full.shape, sharding, local
    )


def make_global_table(
    mesh: Mesh, arrays: Sequence[np.ndarray], axis: str = "shards"
):
    return tuple(make_global_array(mesh, a, axis=axis) for a in arrays)


def fetch_replicated(x: jax.Array) -> np.ndarray:
    """Pull a replicated result to the host (any process)."""
    return np.asarray(jax.device_get(x))


def fetch_sharded(x: jax.Array) -> np.ndarray:
    """Pull a fully-sharded result to every host (an all-gather over
    DCN under the hood — only for results, never for table data)."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
