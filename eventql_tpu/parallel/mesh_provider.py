"""Mesh-resident table provider: SQL over a multi-chip device mesh.

This is the missing link between the SQL engine and the mesh tier
(round-4 review item 1): the reference's distributed scheduler rewrites
a user query into per-partition partial plans fanned out over TCP
(reference: server/sql/scheduler.cc:55-264); here the analogous rewrite
keeps the table resident on an N-device `jax.sharding.Mesh`, sharded on
the row axis, and executes GROUP BY / top-k / join plans as ONE compiled
XLA program whose collectives (all_gather/psum/ppermute between devices) play
the role of the QUERY_PARTIALAGGR fan-out + coordinator merge
(reference: sql/statements/select/groupby.cc:504-714).

Every query shape the mesh routes cannot serve falls back transparently
to the host engine: the provider keeps the host Relation (it IS a
RelationTableProvider), so correctness never depends on mesh
eligibility. Composition with the TCP tier is by nesting: a cluster
worker process may hold its local partitions in a MeshTableProvider, so
partial aggregates fan out over TCP across hosts and between devices within a
host (see parallel/cluster.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from eventql_tpu.exec.runtime import RelationTableProvider


class MeshTableProvider(RelationTableProvider):
    """Tables live sharded across a device mesh; host copies remain for
    fallback paths and string dictionaries."""

    def __init__(self, mesh=None, n_devices: Optional[int] = None,
                 axis: str = "shards", row_block: int = 128):
        super().__init__()
        if mesh is None:
            from eventql_tpu.parallel.distributed import make_mesh

            mesh = make_mesh(n_devices, axis=axis)
        self.mesh = mesh
        self.axis = axis
        self.n_devices = int(mesh.shape[axis])
        # rows pad to a multiple of n_devices * row_block so every shard
        # gets equal static shapes and table growth shares programs
        self.row_block = row_block
        self._shard_cache: Dict[Tuple, Tuple] = {}

    def add_table(self, name, rel, stypes=None):
        super().add_table(name, rel, stypes)
        # drop stale shards for this table (columns are immutable; a
        # replaced relation must not serve old device arrays)
        for k in [k for k in self._shard_cache if k[0] == name]:
            del self._shard_cache[k]

    def padded_rows(self, n: int) -> int:
        unit = self.n_devices * self.row_block
        return max(unit, -(-n // unit) * unit)

    def sharded_scan_columns(self, table_name: str, input_columns):
        """Device columns for a scan, sharded on the row axis and padded
        to `padded_rows`. Returns (device_cols, n, n_p) where
        device_cols are jax_expr.DeviceCol with sharded (data, valid).

        Transfers cache per (table, column, relation identity): warm
        columns pay zero host->device traffic (same argument as
        device_exec._to_device_cols)."""
        import jax
        import numpy as np
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        from eventql_tpu.exec import jax_expr
        from eventql_tpu.exec.device_exec import _narrow_np

        rel = self.get_table_data(table_name)
        n = rel.num_rows
        n_p = self.padded_rows(n)
        sharding = NamedSharding(self.mesh, P(self.axis))
        by_name = dict(zip(rel.names, rel.columns))
        out = []
        for cname, _t in input_columns:
            c = by_name[cname]
            key = (table_name, cname, id(c), n_p)
            cached = self._shard_cache.get(key)
            if cached is None:
                data = _narrow_np(c)
                pad = n_p - n
                if pad:
                    data = np.pad(data, (0, pad))
                    valid = np.pad(c.valid, (0, pad))
                else:
                    valid = c.valid
                cached = (
                    jax.device_put(data, sharding),
                    jax.device_put(valid, sharding),
                )
                self._shard_cache[key] = cached
            out.append(jax_expr.DeviceCol(c.stype, cached[0], cached[1]))
        return out, n, n_p
