"""Per-segment primary-key → version indexes with an LRU cache.

The reference writes an LSMTableIndex file next to every LSM segment —
a binary array of 28-byte slots (20-byte SHA1 record id + uint64
version), sorted by id and binary-searched on lookup — and keeps loaded
indexes in a byte-budget LRU (reference: db/tablet_index.h:33-48,
tablet_index.cc write/lookup, db/tablet_index_cache.h:33-48 — default
budget server.c2s… lsm_index_cache_size 1 GB, evqld.cc:232).

Insert-time version checks consult these indexes so duplicate or stale
records (replayed replication pushes, repeated client retries) drop at
WRITE time instead of accumulating dead rows until compaction
(reference: partition_writer.cc:105-199).

The twist here: lookups are vectorized — a whole batch of record
ids resolves with one numpy searchsorted over the 8-byte id prefix plus
a short verify scan, instead of the reference's per-record binary
search."""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, List, Optional

import numpy as np

SLOT_SIZE = 28  # 20-byte id + uint64 version (reference tablet_index.h:56)
INDEX_SUFFIX = ".idx"


def index_path_for(segment_path: str) -> str:
    return segment_path + INDEX_SUFFIX


def write_index(path: str, id_versions: Dict[bytes, int]) -> None:
    """Write a sorted 28-byte-slot index file (atomic via tmp+rename,
    like segment files). The sort and slot packing are vectorized —
    this runs on the insert hot path at every arena flush."""
    n = len(id_versions)
    ids = np.frombuffer(
        b"".join(id_versions.keys()), np.uint8
    ).reshape(n, 20)
    versions = np.fromiter(
        id_versions.values(), dtype=np.uint64, count=n
    )
    order = np.argsort(
        np.frombuffer(ids.tobytes(), dtype="S20"), kind="stable"
    )
    out = np.empty((n, SLOT_SIZE), np.uint8)
    out[:, :20] = ids[order]
    out[:, 20:] = versions[order].astype("<u8").view(np.uint8).reshape(n, 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(out.tobytes())
    os.replace(tmp, path)


class TabletIndex:
    """A loaded segment index: sorted ids + versions, vector lookups."""

    def __init__(self, ids: np.ndarray, versions: np.ndarray):
        # ids: (n, 20) uint8 sorted lexicographically
        self.ids = ids
        self.versions = versions
        # 8-byte big-endian prefix sorts identically to the full id —
        # searchsorted narrows to a (almost always length-≤1) run that
        # the full 20-byte compare then verifies
        if len(ids):
            self._hi = (
                ids[:, :8].copy().view(">u8").reshape(-1).astype(np.uint64)
            )
        else:
            self._hi = np.zeros(0, np.uint64)

    @property
    def nbytes(self) -> int:
        return len(self.ids) * SLOT_SIZE

    @classmethod
    def load(cls, path: str) -> "TabletIndex":
        with open(path, "rb") as f:
            raw = f.read()
        n = len(raw) // SLOT_SIZE
        arr = np.frombuffer(raw[: n * SLOT_SIZE], dtype=np.uint8).reshape(
            n, SLOT_SIZE
        )
        ids = arr[:, :20]
        versions = arr[:, 20:].copy().view("<u8").reshape(-1)
        return cls(ids, versions)

    @classmethod
    def from_map(cls, id_versions: Dict[bytes, int]) -> "TabletIndex":
        items = sorted(id_versions.items())
        ids = np.zeros((len(items), 20), np.uint8)
        versions = np.zeros(len(items), np.uint64)
        for i, (rid, v) in enumerate(items):
            ids[i] = np.frombuffer(rid, np.uint8)
            versions[i] = v
        return cls(ids, versions)

    def lookup_max(
        self, rec_ids: List[bytes], head: np.ndarray
    ) -> np.ndarray:
        """Element-wise max of `head` and this index's version for each
        record id (0 when absent) — the vectorized analog of
        LSMTableIndex::lookup's map update (tablet_index.cc)."""
        if not len(self.ids) or not rec_ids:
            return head
        q = np.frombuffer(b"".join(rec_ids), np.uint8).reshape(-1, 20)
        q_hi = q[:, :8].copy().view(">u8").reshape(-1).astype(np.uint64)
        lo = np.searchsorted(self._hi, q_hi, side="left")
        hi = np.searchsorted(self._hi, q_hi, side="right")
        out = head.copy()
        # common case fully vectorized: a prefix run of length ≤ 1 —
        # verify the single candidate's full 20 bytes in one compare
        cand = np.minimum(lo, len(self.ids) - 1)
        simple = hi - lo <= 1
        match = (
            simple
            & (hi > lo)
            & (self.ids[cand] == q).all(axis=1)
        )
        np.maximum(out, np.where(match, self.versions[cand], 0), out=out)
        # adversarial 8-byte prefix collisions: scan the short run
        for i in np.flatnonzero(~simple):
            for j in range(lo[i], hi[i]):
                if bytes(self.ids[j]) == rec_ids[i]:
                    if self.versions[j] > out[i]:
                        out[i] = self.versions[j]
                    break
        return out


class TabletIndexCache:
    """Byte-budget LRU of loaded TabletIndex objects keyed by path
    (reference: db/tablet_index_cache.h:33-48)."""

    def __init__(self, max_bytes: int = 1024 * 1024 * 1024):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._cache: Dict[str, TabletIndex] = {}
        self._order: List[str] = []  # LRU order, oldest first
        self._bytes = 0

    def lookup(self, path: str) -> Optional[TabletIndex]:
        """Loaded index for a segment, or None when the segment has no
        index file (pre-index segments: no insert-time dedup there)."""
        with self._lock:
            idx = self._cache.get(path)
            if idx is not None:
                self._order.remove(path)
                self._order.append(path)
                return idx
        if not os.path.exists(path):
            return None
        idx = TabletIndex.load(path)
        with self._lock:
            if path not in self._cache:
                self._cache[path] = idx
                self._order.append(path)
                self._bytes += idx.nbytes
                while self._bytes > self.max_bytes and len(self._order) > 1:
                    old = self._order.pop(0)
                    self._bytes -= self._cache.pop(old).nbytes
        return idx

    def invalidate(self, path: str) -> None:
        with self._lock:
            idx = self._cache.pop(path, None)
            if idx is not None:
                self._order.remove(path)
                self._bytes -= idx.nbytes


_GLOBAL_CACHE: Optional[TabletIndexCache] = None
_GLOBAL_LOCK = threading.Lock()


def global_index_cache() -> TabletIndexCache:
    global _GLOBAL_CACHE
    with _GLOBAL_LOCK:
        if _GLOBAL_CACHE is None:
            _GLOBAL_CACHE = TabletIndexCache()
        return _GLOBAL_CACHE


# -- record versions ---------------------------------------------------------

_version_lock = threading.Lock()
_last_version = 0


def next_record_version() -> int:
    """Strictly monotone microsecond timestamp (reference:
    WallClock::unixMicros per record, partition_writer.cc:180 asserts
    versions exceed 1.4e15; monotone so same-microsecond upserts keep
    their insertion order)."""
    return next_record_version_block(1)


def next_record_version_block(n: int) -> int:
    """Reserve n consecutive versions; returns the first. Batch inserts
    stamp rows base..base+n-1 so in-batch upsert order is preserved
    without n clock calls."""
    global _last_version
    import time

    now = time.time_ns() // 1000
    with _version_lock:
        if now <= _last_version:
            now = _last_version + 1
        _last_version = now + n - 1
    return now
