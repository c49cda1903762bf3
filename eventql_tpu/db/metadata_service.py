"""Metadata store + service + coordinator + client.

The reference replicates each table's METADATA file on N metadata
servers; the coordination service stores only the head pointer
(metadata_txnid, metadata_txnseq, metadata_servers), advanced by
compare-and-swap (reference: db/metadata_store.cc on-disk txn files,
db/metadata_service.cc RPC surface, db/metadata_coordinator.cc:43-140
CAS commit + majority store, doc/internals/partitioning.txt §5).

Layout here: every txn file is JSON at
``<datadir>/metadata/<db>/<table>/<txnid>.json``. The coordinator
fans METAOP requests to each metadata server — in-process when the
server is local, else via the native protocol's META_* ops — verifies
all produced files agree (checksum set size 1), tolerates a minority
of failures, then commits the new head into the ConfigDirectory if
and only if the head still equals the operation's input txnid.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

from eventql_tpu.core.errors import RuntimeError_
from eventql_tpu.db.metadata_file import (
    DiscoveryResponse,
    MetadataFile,
    MetadataOperation,
    discover_partition,
)


def file_checksum(f: MetadataFile) -> str:
    """Deterministic content hash (reference:
    MetadataFile::computeChecksum) — detects divergent application."""
    blob = json.dumps(f.to_json(), sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()


class MetadataStore:
    """On-disk chain of METADATA transaction files for the tables this
    server is a metadata server for (reference: db/metadata_store.cc)."""

    def __init__(self, datadir: str):
        self.datadir = datadir
        self._lock = threading.Lock()

    def _path(self, db: str, table: str, txnid: str) -> str:
        return os.path.join(self.datadir, "metadata", db, table, f"{txnid}.json")

    def has_file(self, db: str, table: str, txnid: str) -> bool:
        return os.path.exists(self._path(db, table, txnid))

    def get_file(self, db: str, table: str, txnid: str) -> MetadataFile:
        path = self._path(db, table, txnid)
        if not os.path.exists(path):
            raise RuntimeError_(f"metadata file not found: {table}@{txnid}")
        with open(path) as fh:
            return MetadataFile.from_json(json.load(fh))

    def store_file(self, db: str, table: str, f: MetadataFile) -> str:
        """Durably store one transaction file; returns its checksum."""
        path = self._path(db, table, f.txnid)
        with self._lock:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(f.to_json(), fh, sort_keys=True)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        return file_checksum(f)

    def drop_file(self, db: str, table: str, txnid: str):
        """Clean up an aborted transaction (reference: doc §5.1)."""
        try:
            os.remove(self._path(db, table, txnid))
        except FileNotFoundError:
            pass

    def latest_file(self, db: str, table: str) -> Optional[MetadataFile]:
        """Highest-sequence stored file (used to serve discovery with a
        min_txnseq floor when the head pointer is unavailable)."""
        d = os.path.join(self.datadir, "metadata", db, table)
        if not os.path.isdir(d):
            return None
        best = None
        for name in os.listdir(d):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(d, name)) as fh:
                    f = MetadataFile.from_json(json.load(fh))
            except (ValueError, KeyError):
                continue
            if best is None or f.seq > best.seq:
                best = f
        return best


class MetadataService:
    """Serves METADATA file operations for tables whose metadata lives
    on this server (reference: db/metadata_service.cc; native ops
    transport/native/ops/meta_*.cc)."""

    def __init__(self, store: MetadataStore):
        self.store = store

    def create_file(self, db: str, table: str, f: MetadataFile) -> str:
        if self.store.has_file(db, table, f.txnid):
            raise RuntimeError_("metadata file already exists")
        return self.store.store_file(db, table, f)

    def get_file(self, db: str, table: str, txnid: str) -> MetadataFile:
        return self.store.get_file(db, table, txnid)

    def drop_file(self, db: str, table: str, txnid: str):
        self.store.drop_file(db, table, txnid)

    def perform_operation(self, op: MetadataOperation) -> Tuple[str, dict]:
        """Apply op to the stored input file, store the output file;
        returns (checksum, output file json)."""
        input_file = self.store.get_file(op.db, op.table, op.input_txnid)
        output = op.apply(input_file)
        checksum = self.store.store_file(op.db, op.table, output)
        return checksum, output.to_json()

    def discover(
        self, db: str, table: str, min_txnseq: int, request: dict
    ) -> DiscoveryResponse:
        f = self.store.latest_file(db, table)
        if f is None or f.seq < min_txnseq:
            raise RuntimeError_("metadata file not available")
        return discover_partition(
            f,
            requester_id=request["requester_id"],
            partition_id=request["partition_id"],
            keyrange_begin=request.get("keyrange_begin"),
            keyrange_end=request.get("keyrange_end", ""),
            lookup_by_id=bool(request.get("lookup_by_id", False)),
        )


class MetadataCoordinator:
    """Performs CAS metadata transactions across the metadata-server
    set and advances the head pointer in the ConfigDirectory
    (reference: db/metadata_coordinator.cc:43-140)."""

    def __init__(
        self,
        cdir,
        local_server_id: Optional[str] = None,
        local_service: Optional[MetadataService] = None,
        remote_service_factory: Optional[Callable[[str], object]] = None,
    ):
        """remote_service_factory(server_id) returns an object with the
        MetadataService surface for a non-local metadata server (the
        native-protocol client wrapper), or raises if unreachable."""
        self.cdir = cdir
        self.local_server_id = local_server_id
        self.local_service = local_service
        self.remote_service_factory = remote_service_factory
        self._locks: Dict[str, threading.Lock] = {}
        self._lockmap_mutex = threading.Lock()

    def _table_lock(self, db: str, table: str) -> threading.Lock:
        key = f"{db}~{table}"
        with self._lockmap_mutex:
            return self._locks.setdefault(key, threading.Lock())

    def _service_for(self, server_id: str):
        if server_id == self.local_server_id and self.local_service:
            return self.local_service
        if self.remote_service_factory is None:
            raise RuntimeError_(f"no route to metadata server: {server_id}")
        return self.remote_service_factory(server_id)

    # -- table creation (doc §5.1 Create Metadata File) -------------------
    def create_file(
        self, db: str, table: str, f: MetadataFile, servers: List[str]
    ) -> None:
        if not servers:
            raise RuntimeError_("server list can't be empty")
        failures = 0
        for sid in servers:
            try:
                self._service_for(sid).create_file(db, table, f)
            except Exception:
                failures += 1
        max_failures = (len(servers) - 1) // 2 if len(servers) > 1 else 0
        if failures > max_failures:
            raise RuntimeError_("error while creating metadata file")
        self.cdir.update_table_config(
            db,
            table,
            {
                "metadata_txnid": f.txnid,
                "metadata_txnseq": f.seq,
                "metadata_servers": list(servers),
                "metadata": _derived_view(f),
            },
        )

    # -- transactional change (doc §5.1 Change Metadata File) -------------
    def perform_and_commit_operation(
        self, db: str, table: str, op: MetadataOperation
    ) -> MetadataFile:
        with self._table_lock(db, table):
            cfg = self.cdir.get_table_config(db, table) or {}
            head_txnid = cfg.get("metadata_txnid")
            servers = cfg.get("metadata_servers", [])
            if head_txnid is None:
                raise RuntimeError_("table has no metadata chain")
            if head_txnid != op.input_txnid:
                raise RuntimeError_("concurrent modification")

            output_file = self._perform_operation(db, table, op, servers)

            committed = self.cdir.commit_metadata_txn(
                db,
                table,
                input_txnid=op.input_txnid,
                output_txnid=op.output_txnid,
                seq=output_file.seq,
                derived_view=_derived_view(output_file),
            )
            if not committed:
                # lost the race: clean up the aborted txn files
                for sid in servers:
                    try:
                        self._service_for(sid).drop_file(
                            db, table, op.output_txnid
                        )
                    except Exception:
                        pass
                raise RuntimeError_("concurrent modification")
            return output_file

    def _perform_operation(
        self, db: str, table: str, op: MetadataOperation, servers: List[str]
    ) -> MetadataFile:
        if not servers:
            raise RuntimeError_("server list can't be empty")
        failures = 0
        checksums = set()
        output_json = None
        first_error: Optional[Exception] = None
        for sid in servers:
            try:
                checksum, out = self._service_for(sid).perform_operation(op)
                checksums.add(checksum)
                output_json = out
            except RuntimeError_ as e:
                first_error = first_error or e
                failures += 1
            except Exception as e:  # unreachable server
                first_error = first_error or e
                failures += 1
        if len(checksums) > 1:
            raise RuntimeError_("metadata operation would corrupt file")
        max_failures = (len(servers) - 1) // 2 if len(servers) > 1 else 0
        if failures > max_failures or output_json is None:
            # surface the op's own precondition error when every server
            # rejected it (e.g. "split point is out of range")
            if isinstance(first_error, RuntimeError_) and failures == len(
                servers
            ):
                raise first_error
            raise RuntimeError_("error while performing metadata operation")
        return MetadataFile.from_json(output_json)

    # -- reads -------------------------------------------------------------
    def get_head_file(self, db: str, table: str) -> Optional[MetadataFile]:
        cfg = self.cdir.get_table_config(db, table) or {}
        txnid = cfg.get("metadata_txnid")
        if txnid is None:
            return None
        last_err = None
        for sid in cfg.get("metadata_servers", []):
            try:
                return self._service_for(sid).get_file(db, table, txnid)
            except Exception as e:
                last_err = e
        raise RuntimeError_(f"no metadata server reachable: {last_err}")


def _derived_view(f: MetadataFile) -> dict:
    """The TableMetadata JSON consumed by the query/write routers:
    serving replicas only (joining servers receive replicated rows but
    no reads/writes — doc/internals/partitioning.txt §4.2)."""
    return {
        "keyspace": f.keyspace,
        "partition_key": f.partition_key,
        "partitions": [
            {
                "begin": e.begin,
                "partition_id": e.partition_id,
                "servers": [p.server_id for p in e.servers],
            }
            for e in f.entries
        ],
    }


class MetadataClient:
    """Partition lookup against the head file with a txnid-keyed cache
    (reference: db/metadata_client.cc findPartition/listPartitions +
    db/metadata_cache.cc)."""

    def __init__(self, coordinator: MetadataCoordinator):
        self.coordinator = coordinator
        self._cache: Dict[Tuple[str, str], MetadataFile] = {}

    def _head(self, db: str, table: str) -> Optional[MetadataFile]:
        cfg = self.coordinator.cdir.get_table_config(db, table) or {}
        txnid = cfg.get("metadata_txnid")
        if txnid is None:
            return None
        cached = self._cache.get((db, table))
        if cached is not None and cached.txnid == txnid:
            return cached
        f = self.coordinator.get_head_file(db, table)
        if f is not None:
            self._cache[(db, table)] = f
        return f

    def find_partition(self, db: str, table: str, key):
        f = self._head(db, table)
        if f is None:
            return None
        i = f.lookup_index(key)
        return f.entries[i]

    def list_partitions(self, db: str, table: str, begin="", end=""):
        f = self._head(db, table)
        if f is None:
            return []
        return [f.entries[i] for i in f.range_indices(begin, end)]

    def discover(self, db: str, table: str, request: dict) -> DiscoveryResponse:
        f = self._head(db, table)
        if f is None:
            raise RuntimeError_("table has no metadata chain")
        return discover_partition(
            f,
            requester_id=request["requester_id"],
            partition_id=request["partition_id"],
            keyrange_begin=request.get("keyrange_begin"),
            keyrange_end=request.get("keyrange_end", ""),
            lookup_by_id=bool(request.get("lookup_by_id", False)),
        )
