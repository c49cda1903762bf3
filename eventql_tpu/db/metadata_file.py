"""Versioned table METADATA files + transactional operations.

The reference stores each table's partition map in a METADATA file
replicated on N metadata servers, updated by compare-and-swap
transactions; the coordination service holds only the current
(txnid, sequence, server list) head pointer
(reference: db/metadata_file.h:49-66 PartitionMapEntry fields,
doc/internals/partitioning.txt §2.1/§5). Operations are applied as
pure functions file -> new partition map
(reference: db/metadata_operation.cc:75-96 dispatch):

  METAOP_REMOVE_DEAD_SERVERS   drop servers from every placement list
  METAOP_SPLIT_PARTITION       record an ongoing split (or subsplit of
                               a pending split child) on an entry
  METAOP_FINALIZE_SPLIT        replace a splitting entry by its two
                               children
  METAOP_JOIN_SERVERS          add servers to entries' joining lists
  METAOP_FINALIZE_JOIN         move one joining server to the active
                               server list
  METAOP_CREATE_PARTITION      add an entry (finite/user-defined
                               keyspaces only)

PartitionDiscovery computes a replica's lifecycle state — LOAD (still
catching up, serves nothing), SERVE (live), UNLOAD (no longer
responsible; may drop data once replicated) — plus the replication
targets it should push to (reference: db/partition_discovery.cc,
lifecycle doc doc/internals/partitioning.txt §3).

This file is host-side control plane: pure Python data + JSON
serialization (this engine ships JSON over its native protocol
instead of the reference's hand-rolled binary encoding).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from eventql_tpu.core.errors import RuntimeError_

# file flags (reference: metadata_file.h MFILE_*)
MFILE_FINITE = 1
MFILE_USERDEFINED = 2

# lifecycle states (reference: db/partition_state.proto:59-64)
PDISCOVERY_UNKNOWN = "UNKNOWN"
PDISCOVERY_LOAD = "LOAD"
PDISCOVERY_SERVE = "SERVE"
PDISCOVERY_UNLOAD = "UNLOAD"

KEYSPACE_UINT64 = "uint64"
KEYSPACE_STRING = "string"


def compare_keys(keyspace: str, a, b) -> int:
    """-1/0/1 compare of partition keys; '' is negative infinity (the
    first partition's begin key, reference: metadata_file.cc
    compareKeys over encoded keys)."""
    if a == "" and b == "":
        return 0
    if a == "":
        return -1
    if b == "":
        return 1
    if keyspace == KEYSPACE_UINT64:
        a, b = int(a), int(b)
    else:
        a, b = str(a), str(b)
    return -1 if a < b else (1 if a > b else 0)


def random_txnid() -> str:
    return hashlib.sha1(os.urandom(20)).hexdigest()[:40]


@dataclass
class Placement:
    """One replica assignment (reference: PartitionPlacement)."""

    server_id: str
    placement_id: int = 0

    def to_json(self):
        return {"server_id": self.server_id, "placement_id": self.placement_id}

    @staticmethod
    def from_json(d):
        return Placement(d["server_id"], int(d.get("placement_id", 0)))


@dataclass
class PartitionEntry:
    """One keyrange entry (reference: MetadataFile::PartitionMapEntry)."""

    begin: object  # "" = -inf; int (uint64 keyspace) or str
    partition_id: str
    servers: List[Placement] = field(default_factory=list)
    servers_joining: List[Placement] = field(default_factory=list)
    servers_leaving: List[Placement] = field(default_factory=list)
    end: object = ""  # only meaningful with MFILE_FINITE
    splitting: bool = False
    split_point: object = ""
    split_partition_id_low: str = ""
    split_partition_id_high: str = ""
    split_servers_low: List[Placement] = field(default_factory=list)
    split_servers_high: List[Placement] = field(default_factory=list)

    def all_server_ids(self) -> List[str]:
        return [
            p.server_id
            for p in (
                self.servers + self.servers_joining + self.servers_leaving
            )
        ]

    def copy(self) -> "PartitionEntry":
        return PartitionEntry.from_json(self.to_json())

    def to_json(self) -> dict:
        return {
            "begin": self.begin,
            "end": self.end,
            "partition_id": self.partition_id,
            "servers": [p.to_json() for p in self.servers],
            "servers_joining": [p.to_json() for p in self.servers_joining],
            "servers_leaving": [p.to_json() for p in self.servers_leaving],
            "splitting": self.splitting,
            "split_point": self.split_point,
            "split_partition_id_low": self.split_partition_id_low,
            "split_partition_id_high": self.split_partition_id_high,
            "split_servers_low": [p.to_json() for p in self.split_servers_low],
            "split_servers_high": [
                p.to_json() for p in self.split_servers_high
            ],
        }

    @staticmethod
    def from_json(d: dict) -> "PartitionEntry":
        pl = lambda key: [Placement.from_json(x) for x in d.get(key, [])]
        return PartitionEntry(
            begin=d["begin"],
            end=d.get("end", ""),
            partition_id=d["partition_id"],
            servers=pl("servers"),
            servers_joining=pl("servers_joining"),
            servers_leaving=pl("servers_leaving"),
            splitting=bool(d.get("splitting", False)),
            split_point=d.get("split_point", ""),
            split_partition_id_low=d.get("split_partition_id_low", ""),
            split_partition_id_high=d.get("split_partition_id_high", ""),
            split_servers_low=pl("split_servers_low"),
            split_servers_high=pl("split_servers_high"),
        )


@dataclass
class MetadataFile:
    """One immutable METADATA transaction (reference: MetadataFile)."""

    txnid: str
    seq: int
    keyspace: str
    partition_key: str
    entries: List[PartitionEntry] = field(default_factory=list)
    flags: int = 0

    # -- keyspace helpers -------------------------------------------------
    def compare(self, a, b) -> int:
        return compare_keys(self.keyspace, a, b)

    def has_finite_partitions(self) -> bool:
        return bool(self.flags & MFILE_FINITE)

    def has_user_defined_partitions(self) -> bool:
        return bool(self.flags & MFILE_USERDEFINED)

    def entry_end(self, i: int) -> object:
        """The exclusive end key of entry i ('' = +inf): explicit for
        finite keyspaces, else the next entry's begin
        (reference: partition_discovery.cc addReplicationTarget)."""
        if self.has_finite_partitions():
            return self.entries[i].end
        if self.has_user_defined_partitions():
            return ""
        if i + 1 < len(self.entries):
            return self.entries[i + 1].begin
        return ""

    # -- lookup (reference: metadata_file.cc getPartitionMapAt/Range*) ---
    def lookup_index(self, key) -> int:
        """Index of the entry owning `key` (last begin <= key)."""
        out = 0
        for i, e in enumerate(self.entries):
            if i == 0 or self.compare(e.begin, key) <= 0:
                out = i
            else:
                break
        return out

    def range_indices(self, begin, end) -> List[int]:
        """Indices of entries intersecting [begin, end)."""
        if not self.entries:
            return []
        lo = self.lookup_index(begin)
        out = []
        for i in range(lo, len(self.entries)):
            if end != "" and self.compare(self.entries[i].begin, end) >= 0:
                break
            out.append(i)
        return out

    # -- (de)serialization -------------------------------------------------
    def to_json(self) -> dict:
        return {
            "txnid": self.txnid,
            "seq": self.seq,
            "keyspace": self.keyspace,
            "partition_key": self.partition_key,
            "flags": self.flags,
            "partition_map": [e.to_json() for e in self.entries],
        }

    @staticmethod
    def from_json(d: dict) -> "MetadataFile":
        return MetadataFile(
            txnid=d["txnid"],
            seq=int(d["seq"]),
            keyspace=d["keyspace"],
            partition_key=d["partition_key"],
            flags=int(d.get("flags", 0)),
            entries=[PartitionEntry.from_json(e) for e in d["partition_map"]],
        )

    @staticmethod
    def initial(
        keyspace: str,
        partition_key: str,
        table_name: str,
        servers: List[str],
        placement_id: int = 0,
    ) -> "MetadataFile":
        """Seq-1 file: one partition covering the whole keyspace
        (reference: doc/internals/partitioning.txt §4/§5.1)."""
        pid = hashlib.sha1(f"{table_name}\x00".encode()).hexdigest()[:20]
        return MetadataFile(
            txnid=random_txnid(),
            seq=1,
            keyspace=keyspace,
            partition_key=partition_key,
            entries=[
                PartitionEntry(
                    "",
                    pid,
                    servers=[Placement(s, placement_id) for s in servers],
                )
            ],
        )


# ---------------------------------------------------------------------------
# operations (reference: db/metadata_operation.cc)
# ---------------------------------------------------------------------------

METAOP_REMOVE_DEAD_SERVERS = "REMOVE_DEAD_SERVERS"
METAOP_SPLIT_PARTITION = "SPLIT_PARTITION"
METAOP_FINALIZE_SPLIT = "FINALIZE_SPLIT"
METAOP_JOIN_SERVERS = "JOIN_SERVERS"
METAOP_FINALIZE_JOIN = "FINALIZE_JOIN"
METAOP_CREATE_PARTITION = "CREATE_PARTITION"


@dataclass
class MetadataOperation:
    """A CAS change request: apply to the file whose txnid ==
    input_txnid, producing the file for output_txnid at seq+1
    (reference: metadata_operation.h; doc §5.1 'Change Metadata
    File')."""

    db: str
    table: str
    optype: str
    opdata: dict
    input_txnid: str
    output_txnid: str = ""

    def __post_init__(self):
        if not self.output_txnid:
            self.output_txnid = random_txnid()

    def to_json(self) -> dict:
        return {
            "db": self.db,
            "table": self.table,
            "optype": self.optype,
            "opdata": self.opdata,
            "input_txnid": self.input_txnid,
            "output_txnid": self.output_txnid,
        }

    @staticmethod
    def from_json(d: dict) -> "MetadataOperation":
        return MetadataOperation(
            d["db"],
            d["table"],
            d["optype"],
            d["opdata"],
            d["input_txnid"],
            d.get("output_txnid", ""),
        )

    # -- application -------------------------------------------------------
    def apply(self, input_file: MetadataFile) -> MetadataFile:
        """Pure apply; raises RuntimeError_ on precondition failure with
        the reference's error texts."""
        performer = {
            METAOP_REMOVE_DEAD_SERVERS: _perform_remove_dead_servers,
            METAOP_SPLIT_PARTITION: _perform_split_partition,
            METAOP_FINALIZE_SPLIT: _perform_finalize_split,
            METAOP_JOIN_SERVERS: _perform_join_servers,
            METAOP_FINALIZE_JOIN: _perform_finalize_join,
            METAOP_CREATE_PARTITION: _perform_create_partition,
        }.get(self.optype)
        if performer is None:
            raise RuntimeError_("invalid metadata operation type")
        entries = performer(input_file, self.opdata)
        return MetadataFile(
            txnid=self.output_txnid,
            seq=input_file.seq + 1,
            keyspace=input_file.keyspace,
            partition_key=input_file.partition_key,
            entries=entries,
            flags=input_file.flags,
        )


def _strip_servers(dead: set, placements: List[Placement]) -> List[Placement]:
    return [p for p in placements if p.server_id not in dead]


def _perform_remove_dead_servers(f: MetadataFile, op: dict):
    # reference: metadata_operation.cc performRemoveDeadServers
    dead = set(op["server_ids"])
    out = []
    for e in f.entries:
        e = e.copy()
        e.servers = _strip_servers(dead, e.servers)
        e.servers_joining = _strip_servers(dead, e.servers_joining)
        e.servers_leaving = _strip_servers(dead, e.servers_leaving)
        e.split_servers_low = _strip_servers(dead, e.split_servers_low)
        e.split_servers_high = _strip_servers(dead, e.split_servers_high)
        out.append(e)
    return out


def _placements(server_ids: List[str], placement_id: int) -> List[Placement]:
    return [Placement(s, placement_id) for s in server_ids]


def _perform_split_partition(f: MetadataFile, op: dict):
    # reference: metadata_operation.cc performSplitPartition; handles
    # the unary case plus subsplits of a still-pending split child
    if f.has_user_defined_partitions():
        raise RuntimeError_("can't split user defined partitions")
    pid = op["partition_id"]
    if not op.get("split_servers_low") or not op.get("split_servers_high"):
        raise RuntimeError_("split server list can't be empty")

    entries = [e.copy() for e in f.entries]
    for i, e in enumerate(entries):
        is_subsplit_low = e.splitting and e.split_partition_id_low == pid
        is_subsplit_high = e.splitting and e.split_partition_id_high == pid
        if e.partition_id != pid and not (is_subsplit_low or is_subsplit_high):
            continue

        iter_end = f.entry_end(i)
        if e.partition_id == pid and e.splitting:
            raise RuntimeError_("partition is already splitting")

        if is_subsplit_low:
            new = _subsplit(f, op, e, low=True, iter_end=iter_end)
            entries[i : i + 1] = new
        elif is_subsplit_high:
            new = _subsplit(f, op, e, low=False, iter_end=iter_end)
            entries[i : i + 1] = new
        else:
            _check_split_range(f, op["split_point"], e.begin, iter_end)
            if op.get("finalize_immediately"):
                entries[i : i + 1] = _finalized_children(
                    f,
                    begin=e.begin,
                    end=e.end,
                    split_point=op["split_point"],
                    low_id=op["split_partition_id_low"],
                    high_id=op["split_partition_id_high"],
                    low=_placements(
                        op["split_servers_low"], op.get("placement_id", 0)
                    ),
                    high=_placements(
                        op["split_servers_high"], op.get("placement_id", 0)
                    ),
                )
            else:
                e.splitting = True
                e.split_point = op["split_point"]
                e.split_partition_id_low = op["split_partition_id_low"]
                e.split_partition_id_high = op["split_partition_id_high"]
                e.split_servers_low = _placements(
                    op["split_servers_low"], op.get("placement_id", 0)
                )
                e.split_servers_high = _placements(
                    op["split_servers_high"], op.get("placement_id", 0)
                )
        return entries
    raise RuntimeError_("partition not found")


def _check_split_range(f: MetadataFile, split_point, begin, end):
    if begin != "" and f.compare(split_point, begin) < 0:
        raise RuntimeError_("split point is out of range")
    if end != "" and f.compare(split_point, end) >= 0:
        raise RuntimeError_("split point is out of range")


def _finalized_children(
    f: MetadataFile, begin, end, split_point, low_id, high_id, low, high
):
    lower = PartitionEntry(
        begin=begin,
        partition_id=low_id,
        servers=low,
        end=split_point if f.has_finite_partitions() else "",
    )
    higher = PartitionEntry(
        begin=split_point,
        partition_id=high_id,
        servers=high,
        end=end if f.has_finite_partitions() else "",
    )
    return [lower, higher]


def _subsplit(f, op, e, low: bool, iter_end):
    """Split a pending split child: the parent entry is replaced by its
    two children with the requested child left splitting
    (reference: performSplitPartitionLow/High)."""
    if not e.splitting:
        raise RuntimeError_("partition is not splitting")
    sp = op["split_point"]
    if low:
        _check_split_range(f, sp, e.begin, e.split_point)
    else:
        _check_split_range(f, sp, e.split_point, iter_end)

    lower = PartitionEntry(
        begin=e.begin,
        partition_id=e.split_partition_id_low,
        servers=list(e.split_servers_low),
        end=e.split_point if f.has_finite_partitions() else "",
    )
    higher = PartitionEntry(
        begin=e.split_point,
        partition_id=e.split_partition_id_high,
        servers=list(e.split_servers_high),
        end=e.end if f.has_finite_partitions() else "",
    )
    target = lower if low else higher
    target.splitting = True
    target.split_point = sp
    target.split_partition_id_low = op["split_partition_id_low"]
    target.split_partition_id_high = op["split_partition_id_high"]
    target.split_servers_low = _placements(
        op["split_servers_low"], op.get("placement_id", 0)
    )
    target.split_servers_high = _placements(
        op["split_servers_high"], op.get("placement_id", 0)
    )
    return [lower, higher]


def _perform_finalize_split(f: MetadataFile, op: dict):
    # reference: metadata_operation.cc performFinalizeSplit
    pid = op["partition_id"]
    entries = [e.copy() for e in f.entries]
    for i, e in enumerate(entries):
        if e.partition_id != pid:
            continue
        if not e.splitting:
            raise RuntimeError_("partition is not splitting")
        entries[i : i + 1] = _finalized_children(
            f,
            begin=e.begin,
            end=e.end,
            split_point=e.split_point,
            low_id=e.split_partition_id_low,
            high_id=e.split_partition_id_high,
            low=list(e.split_servers_low),
            high=list(e.split_servers_high),
        )
        return entries
    raise RuntimeError_("partition not found")


def _perform_join_servers(f: MetadataFile, op: dict):
    # reference: metadata_operation.cc performJoinServers; op["ops"] =
    # [{partition_id, server_id, placement_id}]
    by_pid: Dict[str, list] = {}
    for o in op["ops"]:
        by_pid.setdefault(o["partition_id"], []).append(o)
    entries = [e.copy() for e in f.entries]
    for e in entries:
        for o in by_pid.get(e.partition_id, []):
            if o["server_id"] in e.all_server_ids():
                raise RuntimeError_("server already exists in server list")
            e.servers_joining.append(
                Placement(o["server_id"], o.get("placement_id", 0))
            )
    return entries


def _perform_finalize_join(f: MetadataFile, op: dict):
    # reference: metadata_operation.cc performFinalizeJoin
    pid = op["partition_id"]
    entries = [e.copy() for e in f.entries]
    for e in entries:
        if e.partition_id != pid:
            continue
        keep, found = [], False
        for p in e.servers_joining:
            if p.server_id == op["server_id"] and p.placement_id == op.get(
                "placement_id", 0
            ):
                found = True
            else:
                keep.append(p)
        if not found:
            raise RuntimeError_("server not included in join list")
        e.servers_joining = keep
        e.servers.append(
            Placement(op["server_id"], op.get("placement_id", 0))
        )
        return entries
    raise RuntimeError_("partition join not found")


def _perform_create_partition(f: MetadataFile, op: dict):
    # reference: metadata_operation.cc performCreatePartition — only
    # finite / user-defined keyspaces accept explicit partition creation
    if not f.has_finite_partitions() and not f.has_user_defined_partitions():
        raise RuntimeError_("partition create not allowed")
    new = PartitionEntry(
        begin=op["begin"],
        end=op.get("end", ""),
        partition_id=op["partition_id"],
        servers=_placements(op["servers"], op.get("placement_id", 0)),
    )
    entries = [e.copy() for e in f.entries]
    pos = len(entries)
    if f.has_finite_partitions():
        pos = 0
        while pos < len(entries) and not (
            f.compare(entries[pos].begin, new.end) >= 0
        ):
            pos += 1
        if pos > 0 and f.compare(entries[pos - 1].end, new.begin) > 0:
            raise RuntimeError_("overlapping partitions")
    else:  # user-defined
        pos = 0
        while pos < len(entries) and f.compare(entries[pos].begin, new.begin) < 0:
            pos += 1
        if pos < len(entries) and f.compare(entries[pos].begin, new.begin) == 0:
            raise RuntimeError_("overlapping partitions")
    entries.insert(pos, new)
    return entries


# ---------------------------------------------------------------------------
# partition discovery (reference: db/partition_discovery.cc)
# ---------------------------------------------------------------------------


@dataclass
class ReplicationTarget:
    """Where a replica must push its data (reference:
    PartitionDiscoveryReplicationTarget)."""

    server_id: str
    placement_id: int
    partition_id: str
    keyrange_begin: object
    keyrange_end: object
    is_joining: bool = False

    def to_json(self):
        return {
            "server_id": self.server_id,
            "placement_id": self.placement_id,
            "partition_id": self.partition_id,
            "keyrange_begin": self.keyrange_begin,
            "keyrange_end": self.keyrange_end,
            "is_joining": self.is_joining,
        }

    @staticmethod
    def from_json(d):
        return ReplicationTarget(
            d["server_id"],
            int(d.get("placement_id", 0)),
            d["partition_id"],
            d.get("keyrange_begin", ""),
            d.get("keyrange_end", ""),
            bool(d.get("is_joining", False)),
        )


@dataclass
class DiscoveryResponse:
    """(reference: PartitionDiscoveryResponse)"""

    code: str
    txnid: str
    txnseq: int
    replication_targets: List[ReplicationTarget] = field(default_factory=list)
    keyrange_begin: object = ""
    keyrange_end: object = ""
    is_splitting: bool = False
    split_partition_ids: List[str] = field(default_factory=list)

    def to_json(self):
        return {
            "code": self.code,
            "txnid": self.txnid,
            "txnseq": self.txnseq,
            "replication_targets": [
                t.to_json() for t in self.replication_targets
            ],
            "keyrange_begin": self.keyrange_begin,
            "keyrange_end": self.keyrange_end,
            "is_splitting": self.is_splitting,
            "split_partition_ids": list(self.split_partition_ids),
        }

    @staticmethod
    def from_json(d):
        return DiscoveryResponse(
            code=d["code"],
            txnid=d["txnid"],
            txnseq=int(d["txnseq"]),
            replication_targets=[
                ReplicationTarget.from_json(t)
                for t in d.get("replication_targets", [])
            ],
            keyrange_begin=d.get("keyrange_begin", ""),
            keyrange_end=d.get("keyrange_end", ""),
            is_splitting=bool(d.get("is_splitting", False)),
            split_partition_ids=list(d.get("split_partition_ids", [])),
        )


def _target(f: MetadataFile, i: int, p: Placement, is_joining: bool):
    e = f.entries[i]
    return ReplicationTarget(
        server_id=p.server_id,
        placement_id=p.placement_id,
        partition_id=e.partition_id,
        keyrange_begin=e.begin,
        keyrange_end=f.entry_end(i),
        is_joining=is_joining,
    )


def _split_targets(f: MetadataFile, i: int) -> List[ReplicationTarget]:
    e = f.entries[i]
    e_end = f.entry_end(i)
    out = [
        ReplicationTarget(
            p.server_id, p.placement_id, e.split_partition_id_low,
            e.begin, e.split_point,
        )
        for p in e.split_servers_low
    ]
    out += [
        ReplicationTarget(
            p.server_id, p.placement_id, e.split_partition_id_high,
            e.split_point, e_end,
        )
        for p in e.split_servers_high
    ]
    return out


def discover_partition(
    f: MetadataFile,
    requester_id: str,
    partition_id: str,
    keyrange_begin: object = None,
    keyrange_end: object = "",
    lookup_by_id: bool = False,
) -> DiscoveryResponse:
    """Compute a replica's lifecycle state + replication targets
    (reference: PartitionDiscovery::discoverPartition)."""
    if lookup_by_id or keyrange_begin is None:
        return _discover_by_id(f, requester_id, partition_id)
    return _discover_by_keyrange(
        f, requester_id, partition_id, keyrange_begin, keyrange_end
    )


def _discover_membership(f, i, requester_id, resp):
    """Shared SERVE/LOAD/UNLOAD membership scan over an entry's server
    lists; appends targets for the other replicas."""
    e = f.entries[i]
    skip_targets = e.splitting  # by-keyrange path skips plain targets
    for p in e.servers:
        if p.server_id == requester_id:
            resp.code = PDISCOVERY_SERVE
        elif not skip_targets:
            resp.replication_targets.append(_target(f, i, p, False))
    for p in e.servers_joining:
        if p.server_id == requester_id:
            resp.code = PDISCOVERY_LOAD
        elif not skip_targets:
            resp.replication_targets.append(_target(f, i, p, True))
    for p in e.servers_leaving:
        if p.server_id == requester_id:
            resp.code = PDISCOVERY_SERVE
        elif not skip_targets:
            resp.replication_targets.append(_target(f, i, p, False))


def _discover_by_keyrange(f, requester_id, partition_id, begin, end):
    resp = DiscoveryResponse(PDISCOVERY_UNKNOWN, f.txnid, f.seq)
    if not f.entries:
        raise RuntimeError_("invalid key range requested")
    i = f.lookup_index(begin)
    e = f.entries[i]

    if e.partition_id == partition_id:
        resp.keyrange_begin = e.begin
        resp.keyrange_end = f.entry_end(i)
        _discover_membership(f, i, requester_id, resp)
        if e.splitting:
            resp.replication_targets += _split_targets(f, i)
            resp.is_splitting = True
            resp.split_partition_ids = [
                e.split_partition_id_low,
                e.split_partition_id_high,
            ]
        if resp.code == PDISCOVERY_UNKNOWN:
            resp.code = PDISCOVERY_UNLOAD
    elif e.splitting and e.split_partition_id_low == partition_id:
        resp.code = PDISCOVERY_LOAD
        resp.keyrange_begin = e.begin
        resp.keyrange_end = e.split_point
        resp.replication_targets = [
            t
            for t in _split_targets(f, i)
            if t.partition_id == partition_id and t.server_id != requester_id
        ]
    elif e.splitting and e.split_partition_id_high == partition_id:
        resp.code = PDISCOVERY_LOAD
        resp.keyrange_begin = e.split_point
        resp.keyrange_end = f.entry_end(i)
        resp.replication_targets = [
            t
            for t in _split_targets(f, i)
            if t.partition_id == partition_id and t.server_id != requester_id
        ]
    else:
        # split or merged away: push leftovers to current owners, drop
        resp.code = PDISCOVERY_UNLOAD
        for j in f.range_indices(begin, end):
            ej = f.entries[j]
            if ej.splitting:
                resp.replication_targets += _split_targets(f, j)
            else:
                for p in ej.servers:
                    resp.replication_targets.append(_target(f, j, p, False))
                for p in ej.servers_joining:
                    resp.replication_targets.append(_target(f, j, p, True))
                for p in ej.servers_leaving:
                    resp.replication_targets.append(_target(f, j, p, False))
    return resp


def _discover_by_id(f, requester_id, partition_id):
    resp = DiscoveryResponse(PDISCOVERY_UNKNOWN, f.txnid, f.seq)
    for i, e in enumerate(f.entries):
        if e.partition_id == partition_id:
            resp.keyrange_begin = e.begin
            resp.keyrange_end = f.entry_end(i)
            # by-id path always reports plain targets, even mid-split
            for p in e.servers:
                if p.server_id == requester_id:
                    resp.code = PDISCOVERY_SERVE
                else:
                    resp.replication_targets.append(_target(f, i, p, False))
            for p in e.servers_joining:
                if p.server_id == requester_id:
                    resp.code = PDISCOVERY_LOAD
                else:
                    resp.replication_targets.append(_target(f, i, p, True))
            for p in e.servers_leaving:
                if p.server_id == requester_id:
                    resp.code = PDISCOVERY_SERVE
                else:
                    resp.replication_targets.append(_target(f, i, p, False))
            if e.splitting:
                resp.replication_targets += _split_targets(f, i)
                resp.is_splitting = True
                resp.split_partition_ids = [
                    e.split_partition_id_low,
                    e.split_partition_id_high,
                ]
            if resp.code == PDISCOVERY_UNKNOWN:
                resp.code = PDISCOVERY_UNLOAD
            return resp
        if e.splitting and e.split_partition_id_low == partition_id:
            resp.code = PDISCOVERY_LOAD
            resp.keyrange_begin = e.begin
            resp.keyrange_end = e.split_point
            resp.replication_targets = [
                t
                for t in _split_targets(f, i)
                if t.partition_id == partition_id
                and t.server_id != requester_id
            ]
            return resp
        if e.splitting and e.split_partition_id_high == partition_id:
            resp.code = PDISCOVERY_LOAD
            resp.keyrange_begin = e.split_point
            resp.keyrange_end = f.entry_end(i)
            resp.replication_targets = [
                t
                for t in _split_targets(f, i)
                if t.partition_id == partition_id
                and t.server_id != requester_id
            ]
            return resp
    resp.code = PDISCOVERY_UNLOAD
    return resp
