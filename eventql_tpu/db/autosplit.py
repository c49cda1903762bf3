"""Automatic partition splitting.

Reference behavior: LSMPartitionWriter::needsSplit checks each
partition against split thresholds (db/partition_writer.cc:459-487;
constants 512 MB / 2,000,000 rows at :64-65) and commitSplit issues a
METAOP_SPLIT_PARTITION metadata transaction carrying the partition's
midpoint key (:538-589); the leader's rebalance pass later finalizes
the split. Here the standalone registry applies splits
immediately (replicas keep the full keyrange; splits change query
scoping and future write routing — see COMPARISON.md), so automatic
splitting is a background pass: measure per-partition row counts on the
local store, split oversized partitions at their median partition key.

Only the cluster leader runs the pass (the reference dedups concurrent
splits via per-partition is_splitting state; a single splitter achieves
the same without cross-server coordination).
"""

from __future__ import annotations

import threading
from typing import List, Optional

from eventql_tpu.config.config_directory import ConfigDirectory
from eventql_tpu.db.metadata import TableMetadata, _cmp_key

# reference: db/partition_writer.cc:64-65
DEFAULT_SPLIT_THRESHOLD_ROWS = 2_000_000


def run_once(
    table_service,
    cdir: ConfigDirectory,
    db: str = "default",
    threshold_rows: int = DEFAULT_SPLIT_THRESHOLD_ROWS,
    remote_factory=None,
) -> List[str]:
    """One splitting pass over every partitioned table this server
    holds locally. Returns human-readable change lines."""
    if remote_factory is None:
        from eventql_tpu.db.metadata_transport import remote_factory_from_cdir

        remote_factory = remote_factory_from_cdir(cdir)
    changes: List[str] = []
    doc = cdir._read()
    tables = doc.get("namespaces", {}).get(db, {}).get("tables", {})
    for table_name, cfg in list(tables.items()):
        if "metadata" not in cfg:
            continue
        meta = TableMetadata.from_json(cfg["metadata"])
        try:
            rel = table_service.get_table_data(table_name)
        except Exception:
            continue  # table known in the registry but not held locally
        if rel is None or rel.num_rows == 0:
            continue
        try:
            pk_idx = rel.names.index(meta.partition_key)
        except ValueError:
            continue
        col = rel.columns[pk_idx]
        keys = [col.value_at(i).payload() for i in range(rel.num_rows)]
        if meta.keyspace == "uint64":
            keys = [int(k) for k in keys]
        else:
            keys = [str(k) for k in keys]

        dirty = False
        for entry in list(meta.entries):
            begin, end = meta.keyrange(entry.partition_id)
            in_range = sorted(
                k
                for k in keys
                if _cmp_key(meta.keyspace, begin, k) <= 0
                and (end == "" or _cmp_key(meta.keyspace, k, end) < 0)
            )
            if len(in_range) <= threshold_rows:
                continue
            midpoint = _split_point(meta.keyspace, begin, in_range)
            if midpoint is None:
                continue  # all rows share one key: nothing to split on
            if cfg.get("metadata_txnid") and remote_factory is not None:
                # the table has a METADATA transaction chain: issue a
                # CAS METAOP_SPLIT_PARTITION against the metadata
                # servers (reference: partition_writer.cc:538-589). The
                # replicas already hold the full keyrange, so the split
                # finalizes immediately with the same placements.
                _cas_split(
                    cdir, remote_factory, db, table_name, cfg,
                    entry.partition_id, midpoint, list(entry.servers),
                )
                # the head moved: later splits in this pass must CAS
                # against the new txnid
                cfg = cdir.get_table_config(db, table_name) or cfg
            else:
                meta.split(entry.partition_id, midpoint)
                dirty = True
            changes.append(
                f"{table_name}/{entry.partition_id}: split at"
                f" '{midpoint}' ({len(in_range)} rows >"
                f" {threshold_rows})"
            )
        if dirty:
            cdir.update_table_config(
                db, table_name, {"metadata": meta.to_json()}
            )
    return changes


def _cas_split(
    cdir, remote_factory, db, table_name, cfg, partition_id, midpoint, servers
):
    import hashlib as _hashlib

    from eventql_tpu.db.metadata_file import (
        METAOP_SPLIT_PARTITION,
        MetadataOperation,
    )
    from eventql_tpu.db.metadata_service import MetadataCoordinator
    from eventql_tpu.db.server_allocator import allocate

    # place each child on the least-loaded servers (reference:
    # partition_writer.cc:553-560 allocates split targets via
    # ServerAllocator). When the chosen targets already serve the
    # parent the split needs no data movement and finalizes in the
    # same transaction; otherwise the partition enters the splitting
    # state and the replication workers run the LOAD → FINALIZE_SPLIT
    # lifecycle (doc/internals/partitioning.txt §4.3).
    try:
        low_servers = allocate(cdir, len(servers), db)
        high_servers = allocate(cdir, len(servers), db)
    except Exception:
        low_servers = high_servers = list(servers)
    finalize_now = set(low_servers) <= set(servers) and set(
        high_servers
    ) <= set(servers)

    low_id = _hashlib.sha1(
        f"{partition_id}\x00low\x00{midpoint}".encode()
    ).hexdigest()[:20]
    high_id = _hashlib.sha1(
        f"{partition_id}\x00high\x00{midpoint}".encode()
    ).hexdigest()[:20]
    op = MetadataOperation(
        db,
        table_name,
        METAOP_SPLIT_PARTITION,
        {
            "partition_id": partition_id,
            "split_point": midpoint,
            "split_partition_id_low": low_id,
            "split_partition_id_high": high_id,
            "split_servers_low": low_servers,
            "split_servers_high": high_servers,
            "finalize_immediately": finalize_now,
        },
        input_txnid=cfg["metadata_txnid"],
    )
    MetadataCoordinator(
        cdir, remote_service_factory=remote_factory
    ).perform_and_commit_operation(db, table_name, op)


def _split_point(keyspace: str, begin, in_range_sorted):
    """The median in-range key, nudged so both halves are non-empty:
    must compare strictly greater than both the partition begin and the
    smallest in-range key (the low half keeps keys < midpoint)."""
    mid = in_range_sorted[len(in_range_sorted) // 2]
    lo = in_range_sorted[0]
    if _cmp_key(keyspace, mid, lo) > 0 and (
        begin == "" or _cmp_key(keyspace, mid, begin) > 0
    ):
        return mid
    # median equals the minimum (heavy low skew): use the first larger key
    for k in in_range_sorted:
        if _cmp_key(keyspace, k, lo) > 0:
            return k
    return None


class AutoSplitWorker:
    """Background splitter thread (reference analog: the compaction-path
    needsSplit check + split thread, db/partition_writer.cc:490-536)."""

    def __init__(
        self,
        table_service,
        config_path: str,
        leader=None,
        db: str = "default",
        threshold_rows: int = DEFAULT_SPLIT_THRESHOLD_ROWS,
        interval: float = 5.0,
    ):
        self.table_service = table_service
        self.cdir = ConfigDirectory(config_path)
        self.leader = leader
        self.db = db
        self.threshold_rows = threshold_rows
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run_once(self) -> List[str]:
        if self.leader is not None and not self.leader.is_leader:
            return []
        return run_once(
            self.table_service, self.cdir, self.db, self.threshold_rows
        )

    def start(self) -> "AutoSplitWorker":
        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.run_once()
                except Exception:
                    pass  # next pass retries; splitting is best-effort

        self._thread = threading.Thread(
            target=loop, name="autosplit", daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
