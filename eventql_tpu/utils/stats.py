"""Stats counters + statsd push agent.

Re-implements the reference's stats toolkit surface
(reference: util/stats/counter.h Counter, statsrepository.h
StatsRepository + ExportMode, statsdagent.cc StatsdAgent — lines of
"path:value" batched into UDP packets under 48k, VALUE exports send
the current value, DELTA exports send the change since last report).
The server's counter set mirrors struct evqld_stats
(server/server_stats.h:30-42).
"""

from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Tuple


class Counter:
    """Thread-safe counter (reference: util/stats/counter.h)."""

    def __init__(self, value: int = 0):
        self._value = value
        self._lock = threading.Lock()

    def incr(self, n: int = 1):
        with self._lock:
            self._value += n

    def decr(self, n: int = 1):
        with self._lock:
            self._value -= n

    def set(self, v: int):
        with self._lock:
            self._value = v

    def get(self) -> int:
        with self._lock:
            return self._value


class ExportMode(Enum):
    EXPORT_NONE = 0
    EXPORT_VALUE = 1
    EXPORT_DELTA = 2


@dataclass
class ExportedStat:
    path: str
    stat: Counter
    export_mode: ExportMode


class StatsRepository:
    """Registry of exported stats (util/stats/statsrepository.h)."""

    _instance: Optional["StatsRepository"] = None

    def __init__(self):
        self._stats: List[ExportedStat] = []
        self._lock = threading.Lock()

    @classmethod
    def get(cls) -> "StatsRepository":
        if cls._instance is None:
            cls._instance = StatsRepository()
        return cls._instance

    def export_stat(
        self, path: str, stat: Counter, mode: ExportMode = ExportMode.EXPORT_VALUE
    ):
        with self._lock:
            self._stats.append(ExportedStat(path, stat, mode))

    def for_each_stat(self, fn: Callable[[ExportedStat], None]):
        with self._lock:
            stats = list(self._stats)
        for s in stats:
            fn(s)


class StatsdAgent:
    """Periodic UDP push of all exported stats
    (util/stats/statsdagent.cc:50-148)."""

    MAX_PACKET_SIZE = 1024 * 48  # statsdagent.h:39

    def __init__(
        self,
        addr: Tuple[str, int],
        report_interval: float = 10.0,
        stats_repo: Optional[StatsRepository] = None,
    ):
        self.addr = addr
        self.interval = report_interval
        self.repo = stats_repo or StatsRepository.get()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._last_values: Dict[str, int] = {}
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._running = False
        if self._thread:
            self._thread.join(timeout=self.interval + 1)
        self._sock.close()

    def _run(self):
        while self._running:
            deadline = time.time() + self.interval
            while self._running and time.time() < deadline:
                time.sleep(0.1)
            if not self._running:
                return
            try:
                self.report()
            except OSError:
                pass  # statsd push failed; retry next interval

    def report(self):
        lines: List[str] = []

        def one(stat: ExportedStat):
            if stat.export_mode == ExportMode.EXPORT_VALUE:
                lines.append(f"{stat.path}:{stat.stat.get()}")
            elif stat.export_mode == ExportMode.EXPORT_DELTA:
                cur = stat.stat.get()
                last = self._last_values.get(stat.path, 0)
                self._last_values[stat.path] = cur
                lines.append(f"{stat.path}:{cur - last}")

        self.repo.for_each_stat(one)
        self._send(lines)

    def _send(self, lines: List[str]):
        pkts: List[str] = []
        for line in lines:
            if not pkts or len(pkts[-1]) + len(line) + 2 >= self.MAX_PACKET_SIZE:
                pkts.append("")
            pkts[-1] += line + "\n"
        for pkt in pkts:
            self._sock.sendto(pkt.encode(), self.addr)


@dataclass
class EvqldStats:
    """The server's counter set (server/server_stats.h:30-42)."""

    num_partitions: Counter = field(default_factory=Counter)
    num_partitions_opened: Counter = field(default_factory=Counter)
    num_partitions_loading: Counter = field(default_factory=Counter)
    replication_queue_length: Counter = field(default_factory=Counter)
    compaction_queue_length: Counter = field(default_factory=Counter)
    mapreduce_reduce_memory: Counter = field(default_factory=Counter)
    mapreduce_num_map_tasks: Counter = field(default_factory=Counter)
    mapreduce_num_reduce_tasks: Counter = field(default_factory=Counter)
    cache_size: Counter = field(default_factory=Counter)
    num_queries: Counter = field(default_factory=Counter)
    num_inserts: Counter = field(default_factory=Counter)
    # total rows scanned across all queries (reference defines the
    # per-query wire fields but zeroes them; this is the process-wide
    # aggregate surfaced at /eventql/stats)
    num_rows_scanned: Counter = field(default_factory=Counter)
    # plan nodes answered by a single-device route (not the host engine)
    device_route_runs: Counter = field(default_factory=Counter)
    # device-route program cache: builds counts
    # unique key constructions, waits counts threads that blocked on
    # another thread's in-flight build — under concurrency,
    # builds == distinct keys proves single-flight (no duplicate
    # compiles)
    device_program_builds: Counter = field(default_factory=Counter)
    device_program_hits: Counter = field(default_factory=Counter)
    device_program_waits: Counter = field(default_factory=Counter)


_evqld_stats: Optional[EvqldStats] = None


def evqld_stats() -> EvqldStats:
    global _evqld_stats
    if _evqld_stats is None:
        _evqld_stats = EvqldStats()
        repo = StatsRepository.get()
        s = _evqld_stats
        repo.export_stat("evqld.num_partitions", s.num_partitions)
        repo.export_stat("evqld.num_partitions_opened", s.num_partitions_opened)
        repo.export_stat(
            "evqld.compaction_queue_length", s.compaction_queue_length
        )
        repo.export_stat(
            "evqld.replication_queue_length", s.replication_queue_length
        )
        repo.export_stat("evqld.cache_size", s.cache_size)
        repo.export_stat(
            "evqld.num_queries", s.num_queries, ExportMode.EXPORT_DELTA
        )
        repo.export_stat(
            "evqld.num_inserts", s.num_inserts, ExportMode.EXPORT_DELTA
        )
        repo.export_stat(
            "evqld.num_rows_scanned", s.num_rows_scanned,
            ExportMode.EXPORT_DELTA,
        )
        repo.export_stat("evqld.device_route_runs", s.device_route_runs)
        repo.export_stat(
            "evqld.device_program_builds", s.device_program_builds
        )
        repo.export_stat(
            "evqld.device_program_hits", s.device_program_hits
        )
        repo.export_stat(
            "evqld.device_program_waits", s.device_program_waits
        )
    return _evqld_stats
