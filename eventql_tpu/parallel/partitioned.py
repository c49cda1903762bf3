"""Partitioned tables + distributed GROUP BY merge.

The reference auto-partitions tables across servers and executes
aggregations as: per-partition partial aggregation (shipped plans) →
serialized accumulator states → coordinator merge
(reference: server/sql/scheduler.cc:55-159, sql/statements/select/
groupby.cc:438-714 Partial/Merge pair, merge algebra vm.cc:274-326).

Here a table is hash-partitioned into shards; each shard runs the
partial aggregate (host engine or device kernels), and the partials
merge with the same accumulator algebra:

    count → sum of partial counts        sum → sum
    min   → min                          max → max
    mean  → (sum, count) pairs merged then finalized
    count_distinct → exact re-union of distinct values

The multi-chip execution of the same pipeline (partials + all-gather
across the mesh + replicated merge) is parallel/distributed.py; this module
provides the partitioning, the planner integration, and the host-side
reference semantics.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from eventql_tpu.core.errors import RuntimeError_
from eventql_tpu.core.types import SType
from eventql_tpu.exec.relation import Column, Relation, dtype_for
from eventql_tpu.exec.runtime import TableInfo
from eventql_tpu.plan import nodes as qn
from eventql_tpu.plan.builder import TableProvider


def hash_u64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — the shard hash (the reference hashes
    partition keys with SHA1; any collision-resistant mix works for
    placement, which never affects results)."""
    x = x.astype(np.uint64).copy()
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


def partition_relation(
    rel: Relation, key_column: str, num_shards: int
) -> List[Relation]:
    """Hash-partition rows by a key column."""
    try:
        idx = rel.names.index(key_column)
    except ValueError:
        raise RuntimeError_(f"partition key column not found: '{key_column}'")
    col = rel.columns[idx]
    if col.stype == SType.STRING:
        # hash the dictionary entries, gather per row
        dict_hashes = np.array(
            [_bytes_hash(bytes(d)) for d in col.dictionary], dtype=np.uint64
        )
        keys = dict_hashes[col.data]
    else:
        keys = hash_u64(col.data.view(np.uint64) if col.data.dtype.itemsize == 8 else col.data.astype(np.uint64))
    shard_of = (keys % np.uint64(num_shards)).astype(np.int64)
    return [
        rel.gather(np.nonzero(shard_of == s)[0]) for s in range(num_shards)
    ]


def _bytes_hash(b: bytes) -> int:
    h = 0xCBF29CE484222325
    for c in b:
        h ^= c
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class PartitionedTableProvider(TableProvider):
    """Serves hash-partitioned tables; queries over them run the
    partial-aggregate/merge pipeline (reference: TSDBTableProvider +
    eventql::Scheduler scatter/gather)."""

    def __init__(self, num_shards: int):
        self.num_shards = num_shards
        self._tables: Dict[str, List[Relation]] = {}
        self._schemas: Dict[str, TableInfo] = {}

    def add_table(self, name: str, rel: Relation, partition_key: str):
        self._tables[name] = partition_relation(rel, partition_key, self.num_shards)
        self._schemas[name] = TableInfo(
            name, [(n, c.stype) for n, c in zip(rel.names, rel.columns)]
        )

    def describe(self, table_name: str) -> Optional[TableInfo]:
        return self._schemas.get(table_name)

    def list_tables(self):
        return [self._schemas[n] for n in sorted(self._schemas)]

    def shards(self, table_name: str) -> List[Relation]:
        if table_name not in self._tables:
            raise RuntimeError_(f"table not found: '{table_name}'")
        return self._tables[table_name]

    def get_table_data(self, table_name: str) -> Relation:
        """Whole-table view (concatenation of shards) for operators that
        don't distribute."""
        shards = self.shards(table_name)
        names = shards[0].names
        cols = []
        for i in range(len(names)):
            cols.append(_concat_columns([s.columns[i] for s in shards]))
        return Relation(list(names), cols, sum(s.num_rows for s in shards))


def _concat_columns(cols: List[Column]) -> Column:
    stype = cols[0].stype
    if stype == SType.STRING:
        vals = []
        for c in cols:
            strs = c.materialize_strings()
            for i in range(len(c.data)):
                vals.append(bytes(strs[i]) if c.valid[i] else None)
        return Column.from_strings(vals)
    data = np.concatenate([c.data for c in cols])
    valid = np.concatenate([c.valid for c in cols])
    return Column(stype, data, valid)


# ---------------------------------------------------------------------------
# distributed GROUP BY (scatter partial aggregates, gather + merge)
# ---------------------------------------------------------------------------

_MERGEABLE = {"sum", "count", "min", "max", "mean", "count_distinct"}


def execute_partitioned_group_by(
    node: qn.GroupByNode, provider: PartitionedTableProvider, txn
) -> Optional[Relation]:
    """Run GroupBy(scan(partitioned table)) as partial aggregates per
    shard + a merge, exactly like GroupByMerge. Returns None when the
    plan shape isn't distributable (caller falls back to the
    whole-table path)."""
    from eventql_tpu.exec.operators import (
        _count_subject,
        _exec_group_by_local,
        _merge_partials,
    )
    from eventql_tpu.plan.exprs import CallExpressionNode, has_aggregate_call

    scan = node.table
    if not isinstance(scan, qn.SequentialScanNode):
        return None
    if scan.aggr_strategy != qn.SequentialScanNode.NO_AGGREGATION:
        return None
    # every aggregate must be mergeable
    for sl in node.select_list:
        if has_aggregate_call(sl.expr):
            stack = [sl.expr]
            while stack:
                e = stack.pop()
                if isinstance(e, CallExpressionNode) and e.is_aggregate():
                    if e.sfunction.aggregate.kind not in _MERGEABLE:
                        return None
                stack.extend(e.arguments())

    shards = provider.shards(scan.table_name)
    partials = []
    for shard in shards:
        partials.append(_exec_group_by_local(node, shard))
    return _merge_partials(node, partials)
