"""MapReduce service.

Re-implements the reference's MapReduce subsystem surface
(reference: mapreduce/mapreduce_service.h:37-77 mapPartition /
reduceTables / saveResultToTable; task DAG from JSON specs,
mapreduce_task_builder.cc; scheduler with bounded shard concurrency,
mapreduce_scheduler.cc:49-115, 64 concurrent tasks) with Python user
functions instead of SpiderMonkey JavaScript — the host-side runtime
language choice, orthogonal to the device compute path.

Job spec (JSON), mirroring the reference's task ops:
  {"jobs": {
      "<name>": {"op": "map_table", "table": t, "map_fn": "<python>"},
      "<name>": {"op": "reduce", "sources": [names], "reduce_fn": ...,
                  "num_shards": n},
      "<name>": {"op": "return_results", "sources": [names]},
      "<name>": {"op": "save_to_table", "sources": [names], "table": t}
   },
   "execute": ["<name>", ...]}

map_fn(row: dict) -> list[(key, value)]
reduce_fn(key, values: iterator) -> list[(key, value)]
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from eventql_tpu.core.errors import RuntimeError_
from eventql_tpu.core.types import SType, SValue

# reference: mapreduce_scheduler.h kDefaultMaxConcurrentTasks
DEFAULT_MAX_CONCURRENT_TASKS = 64


def _is_js_source(source: str) -> bool:
    s = source.lstrip()
    return s.startswith("function") and "{" in s


def _compile_task_fn(spec: dict, key: str, kind: str):
    """Compile a task's user function. JavaScript sources (the
    reference's UDF language — SpiderMonkey in
    mapreduce/runtime/javascript/) run on the in-repo ES5 interpreter
    with the task's shipped globals/params closure; Python sources run
    natively."""
    source = spec[key]
    if spec.get("lang") == "js" or _is_js_source(source):
        from eventql_tpu.mapreduce.js_runtime import (
            js_map_adapter,
            js_reduce_adapter,
        )

        adapter = js_map_adapter if kind == "map" else js_reduce_adapter
        return adapter(source, spec.get("globals", ""), _params_json(spec))
    return _compile_fn(source, kind)


def _as_str(v) -> str:
    if isinstance(v, str):
        return v
    return json.dumps(v) if v else ""


def _params_json(spec: dict) -> str:
    p = spec.get("params", "")
    if isinstance(p, str):
        return p
    return json.dumps(p) if p else ""


def _compile_fn(source: str, name_hint: str):
    """Compile a user function from source: either a bare lambda
    expression or a module defining one or more functions (the last
    definition wins)."""
    try:
        v = eval(source.strip(), {})  # noqa: S307 — user jobs, like JS
        if callable(v):
            return v
    except Exception:
        pass
    env: Dict = {}
    try:
        exec(source, env)  # noqa: S102
    except Exception as e:
        raise RuntimeError_(f"invalid {name_hint} function: {e}")
    fns = [
        v
        for k, v in env.items()
        if callable(v) and not k.startswith("__")
    ]
    if not fns:
        raise RuntimeError_(f"no callable found in {name_hint} function")
    return fns[-1]


# FNV-1a 64 (reference: util/fnv.h — the ?sample= shard filter hash)
_FNV64_BASIS = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3


def fnv64(data: bytes) -> int:
    h = _FNV64_BASIS
    for b in data:
        h = ((h ^ b) * _FNV64_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


class MapReduceService:
    def __init__(
        self,
        table_service,
        max_concurrent_tasks: int = DEFAULT_MAX_CONCURRENT_TASKS,
        spill_dir=None,
        cachedir=None,
        namespace: str = "default",
        save_target_factory=None,
    ):
        self.table_service = table_service
        # save_to_table target: in a cluster, inserts route through the
        # partition-aware provider (reference: saveResultToTable goes
        # through TableService, mapreduce_service.cc:426-470); reads
        # (map_partition) always stay on the local store
        self.save_target_factory = save_target_factory
        self.max_concurrent_tasks = max_concurrent_tasks
        # result files: task outputs spill to sstable files like the
        # reference (mapreduce_service.cc:177 writes each task result as
        # an sstable; downstream tasks read cursors over them)
        self.spill_dir = spill_dir
        # content-addressed result store for the distributed task RPCs
        # (reference: mr-shard-<sha1>.sst files in cachedir,
        # mapreduce_service.cc:140-146,353-364)
        self.cachedir = cachedir
        self.namespace = namespace
        self.results: Dict[str, List[Tuple[str, str]]] = {}

    # -- content-addressed result store ---------------------------------
    def _result_path(self, result_id: str) -> str:
        import os as _os

        if self.cachedir is None:
            import tempfile as _tempfile

            self.cachedir = _tempfile.mkdtemp(prefix="evql_mr_cache_")
        _os.makedirs(self.cachedir, exist_ok=True)
        return _os.path.join(self.cachedir, f"mr-shard-{result_id}.sst")

    def get_result_filename(self, result_id: str) -> Optional[str]:
        """Path of a cached result, or None
        (reference: mapreduce_service.cc:353-364 getResultFilename)."""
        import os as _os

        path = self._result_path(result_id)
        return path if _os.path.exists(path) else None

    def store_result(self, result_id: str, pairs) -> str:
        """Write pairs as an sstable under a temp name and move into
        place (reference: output_path_tmp + FileUtil::mv,
        mapreduce_service.cc:150-199)."""
        import os as _os
        import uuid as _uuid

        from eventql_tpu.columnar.sstable import SSTableWriter

        path = self._result_path(result_id)
        tmp = f"{path}~{_uuid.uuid4().hex[:16]}"
        w = SSTableWriter(tmp, userdata=result_id.encode())
        for k, v in pairs:
            w.append(
                k if isinstance(k, bytes) else str(k).encode(),
                v if isinstance(v, bytes) else str(v).encode(),
            )
        w.finalize()
        _os.replace(tmp, path)
        return path

    def read_result(self, result_id: str, sample_mod: int = 0,
                    sample_idx: int = 0):
        """Yield (key, value) byte pairs from a cached result; when
        sample_mod > 0 keep only keys with FNV64(key) % mod == idx
        (reference: mapreduce_servlet.cc fetchResult ?sample=mod:idx)."""
        from eventql_tpu.columnar.sstable import SSTableReader

        path = self.get_result_filename(result_id)
        if path is None:
            raise RuntimeError_(f"result not found: {result_id}")
        for k, v in SSTableReader(path).cursor():
            if sample_mod == 0 or fnv64(k) % sample_mod == sample_idx:
                yield k, v

    def _table_version(self, table_name: str) -> str:
        """Data-version component of the map result id (the reference
        uses the partition snapshot version,
        mapreduce_service.cc:133-138); ours derives from the local
        store's mutation state."""
        svc = self.table_service
        for attr in ("table_version", "data_version"):
            fn = getattr(svc, attr, None)
            if fn is not None:
                try:
                    return str(fn(table_name))
                except Exception:
                    pass
        try:
            return str(svc.get_table_data(table_name).num_rows)
        except Exception:
            return "0"

    # -- distributed task entry points (reference: mapreduce_service.h:47-77)
    def map_partition(
        self,
        table_name: str,
        partition_id: str,
        map_fn: str,
        globals_src: str = "",
        params: str = "",
        required_columns=(),
        cache_only: bool = False,
        keyrange=None,
    ) -> Optional[str]:
        """Run the map function over the locally-held rows of one
        partition and cache the result sstable; returns the
        content-addressed result id, or None on a cache_only miss
        (reference: MapReduceService::mapPartition,
        mapreduce_service.cc:95-199)."""
        rc = ",".join(sorted(required_columns)) if required_columns else ""
        output_id = hashlib.sha1(
            "~".join(
                [
                    self.namespace,
                    table_name,
                    str(partition_id),
                    self._table_version(table_name),
                    hashlib.sha1(map_fn.encode()).hexdigest(),
                    hashlib.sha1(globals_src.encode()).hexdigest(),
                    hashlib.sha1(_as_str(params).encode()).hexdigest(),
                    rc,
                ]
            ).encode()
        ).hexdigest()

        if self.get_result_filename(output_id) is not None:
            return output_id
        if cache_only:
            return None

        spec = {"map_fn": map_fn, "globals": globals_src, "params": params}
        fn = _compile_task_fn(spec, "map_fn", "map")
        rel = self.table_service.get_table_data(table_name)
        if keyrange is not None:
            from eventql_tpu.exec.operators import _apply_keyrange

            rel = _apply_keyrange(rel, keyrange)
        pairs = self.map_table_shard(rel, fn, required_columns)
        self.store_result(output_id, pairs)
        return output_id

    def reduce_tables(
        self,
        input_table_urls,
        reduce_fn: str,
        globals_src: str = "",
        params: str = "",
        fetch=None,
        num_retries: int = 6,
        retry_delay: float = 0.2,
    ) -> Optional[str]:
        """Download map-result inputs (binary-framed HTTP streams),
        group, reduce, cache the output sstable; returns the result id
        or None when every input was empty (reference:
        MapReduceService::reduceTables, mapreduce_service.cc:205-350 —
        including the in-memory merge and per-input retries)."""
        import time as _time

        input_tables = sorted(str(u) for u in input_table_urls)
        output_id = hashlib.sha1(
            "~".join(
                [
                    self.namespace,
                    "|".join(input_tables),
                    hashlib.sha1(reduce_fn.encode()).hexdigest(),
                    hashlib.sha1(globals_src.encode()).hexdigest(),
                    hashlib.sha1(_as_str(params).encode()).hexdigest(),
                ]
            ).encode()
        ).hexdigest()

        if self.get_result_filename(output_id) is not None:
            return output_id

        if fetch is None:
            from eventql_tpu.mapreduce.distributed import download_result

            fetch = download_result

        groups: Dict[str, List[str]] = defaultdict(list)
        for url in input_tables:
            last_err = None
            for attempt in range(num_retries):
                try:
                    for k, v in fetch(url):
                        groups[k.decode("utf-8", "replace")].append(
                            v.decode("utf-8", "replace")
                        )
                    last_err = None
                    break
                except Exception as e:  # noqa: BLE001 — retry then record
                    last_err = e
                    _time.sleep(retry_delay * (attempt + 1))
            if last_err is not None:
                # reference tolerates undownloadable inputs with an error
                # log (mapreduce_service.cc:297-303); we fail the shard so
                # the scheduler can retry it on another server
                raise RuntimeError_(
                    f"error downloading mapreduce input {url}: {last_err}"
                )

        if not groups:
            return None

        spec = {"reduce_fn": reduce_fn, "globals": globals_src,
                "params": params}
        fn = _compile_task_fn(spec, "reduce_fn", "reduce")
        out: List[Tuple[str, str]] = []
        for k in sorted(groups):
            for rk, rv in fn(k, iter(groups[k])) or []:
                out.append((str(rk), str(rv)))
        self.store_result(output_id, out)
        return output_id

    def save_result_to_table(self, table_name: str, result_id: str) -> bool:
        """Insert a cached result's rows into a table (reference:
        MapReduceService::saveResultToTable,
        mapreduce_service.cc:426-470)."""
        if self.get_result_filename(result_id) is None:
            return False
        self._save_to_table(
            table_name,
            [
                (k.decode("utf-8", "replace"), v.decode("utf-8", "replace"))
                for k, v in self.read_result(result_id)
            ],
        )
        return True

    # -- task primitives (reference: mapreduce/tasks/) ------------------
    def map_table_shard(
        self, rel, map_fn, required_columns=()
    ) -> List[Tuple[str, str]]:
        keep = set(required_columns) if required_columns else None
        out: List[Tuple[str, str]] = []
        for i in range(rel.num_rows):
            row = {
                name: col.value_at(i).to_string()
                if col.value_at(i).is_null is False
                else None
                for name, col in zip(rel.names, rel.columns)
                if keep is None or name in keep
            }
            for k, v in map_fn(row) or []:
                out.append((str(k), str(v)))
        return out

    def reduce_shard(self, pairs: List[Tuple[str, str]], reduce_fn):
        grouped: Dict[str, List[str]] = defaultdict(list)
        for k, v in pairs:
            grouped[k].append(v)
        out: List[Tuple[str, str]] = []
        for k in sorted(grouped):
            for rk, rv in reduce_fn(k, iter(grouped[k])) or []:
                out.append((str(rk), str(rv)))
        return out

    # -- job execution --------------------------------------------------
    def execute(self, job_spec: dict) -> List[List[Tuple[str, str]]]:
        jobs = job_spec.get("jobs", {})
        targets = job_spec.get("execute", [])
        cache: Dict[str, List[Tuple[str, str]]] = {}
        outputs = []
        for t in targets:
            outputs.append(self._run_job(t, jobs, cache))
        return outputs

    def _run_job(self, name, jobs, cache):
        if name in cache:
            return cache[name]
        spec = jobs.get(name)
        if spec is None:
            raise RuntimeError_(f"unknown job: '{name}'")
        op = spec.get("op")

        if op == "map_table":
            table = spec.get("table") or spec["table_name"]
            map_fn = _compile_task_fn(spec, "map_fn", "map")
            shards = self._table_shards(
                table,
                spec.get("keyrange_begin"),
                spec.get("keyrange_limit"),
            )
            # bounded shard concurrency
            # (reference: mapreduce_scheduler.cc:49-115)
            with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(self.max_concurrent_tasks, max(len(shards), 1))
            ) as pool:
                parts = list(
                    pool.map(lambda s: self.map_table_shard(s, map_fn), shards)
                )
            out = [p for part in parts for p in part]
        elif op == "reduce":
            reduce_fn = _compile_task_fn(spec, "reduce_fn", "reduce")
            pairs: List[Tuple[str, str]] = []
            for src in spec.get("sources", []):
                pairs.extend(self._run_job(src, jobs, cache))
            num_shards = int(spec.get("num_shards", 1))
            if num_shards <= 1:
                out = self.reduce_shard(pairs, reduce_fn)
            else:
                buckets: List[List[Tuple[str, str]]] = [
                    [] for _ in range(num_shards)
                ]
                for k, v in pairs:
                    h = int(
                        hashlib.sha1(k.encode()).hexdigest()[:8], 16
                    ) % num_shards
                    buckets[h].append((k, v))
                with concurrent.futures.ThreadPoolExecutor(
                    max_workers=min(self.max_concurrent_tasks, num_shards)
                ) as pool:
                    parts = list(
                        pool.map(
                            lambda b: self.reduce_shard(b, reduce_fn), buckets
                        )
                    )
                out = [p for part in parts for p in part]
        elif op == "return_results":
            out = []
            for src in spec.get("sources", []):
                out.extend(self._run_job(src, jobs, cache))
            serialize_src = spec.get("serialize_fn") or ""
            if serialize_src:
                # reference: callSerializeFunction(key, value) per tuple
                # (javascript_context.cc:439+)
                from eventql_tpu.mapreduce.js_runtime import TaskContext

                ser = TaskContext(
                    serialize_src, spec.get("globals", ""),
                    _params_json(spec))
                # serialized results are raw output strings (empty ones
                # dropped, return_results.cc:102-108); key "" marks raw
                out = [
                    ("", s)
                    for s in (ser.call_serialize(k, v) for k, v in out)
                    if s
                ]
        elif op == "save_to_table":
            out = []
            for src in spec.get("sources", []):
                out.extend(self._run_job(src, jobs, cache))
            self._save_to_table(spec.get("table") or spec["table_name"], out)
        else:
            raise RuntimeError_(f"unknown mapreduce op: '{op}'")

        if self.spill_dir is not None:
            out = self._spill_roundtrip(name, out)
        cache[name] = out
        return out

    def _spill_roundtrip(self, name, pairs):
        """Persist a task result as an sstable file and read it back
        (reference: result ids map to sstable files,
        mapreduce_service.cc:442-462)."""
        import os as _os
        import uuid as _uuid

        from eventql_tpu.columnar.sstable import SSTableReader, SSTableWriter

        _os.makedirs(self.spill_dir, exist_ok=True)
        path = _os.path.join(
            self.spill_dir, f"mr-{name}-{_uuid.uuid4().hex[:12]}.sst"
        )
        w = SSTableWriter(path, userdata=name.encode())
        for k, v in pairs:
            w.append(k.encode(), v.encode())
        w.finalize()
        r = SSTableReader(path)
        return [(k.decode(), v.decode()) for k, v in r.cursor()]

    # -- JS job programs ---------------------------------------------------
    def execute_script(self, program: str):
        """Run a JavaScript MapReduce job program (the reference's
        MapReduceService::executeScript path: the script declares tasks
        through the EVQL/Z1 api and triggers them via evql_executemr;
        results stream back to the caller)."""
        from eventql_tpu.mapreduce.js_runtime import (
            JobContext,
            normalize_task_spec,
        )

        results: List[Tuple[str, str]] = []
        logs: List[str] = []

        def execute_tasks(task_list, root_id):
            jobs = {
                t["id"]: normalize_task_spec(t) for t in task_list
            }
            cache: Dict[str, List[Tuple[str, str]]] = {}
            results.extend(self._run_job(root_id, jobs, cache))

        ctx = JobContext(
            execute_tasks=execute_tasks,
            write_output=lambda s: results.append(("", s)),
            log_fn=logs.append,
        )
        ctx.run(program)
        return results, logs

    # -- helpers --------------------------------------------------------
    def _table_shards(self, table_name: str, keyrange_begin=None,
                      keyrange_limit=None):
        shards_fn = getattr(self.table_service, "shards", None)
        if shards_fn is not None:
            try:
                if keyrange_begin is not None or keyrange_limit is not None:
                    try:
                        return shards_fn(
                            table_name, keyrange_begin, keyrange_limit)
                    except TypeError:
                        pass
                return shards_fn(table_name)
            except Exception:
                pass
        return [self.table_service.get_table_data(table_name)]

    def _save_to_table(self, table_name: str, pairs):
        # rows land as {key, value} string columns (the reference stores
        # sstables of msgpacked rows; the observable surface is a table)
        svc = (
            self.save_target_factory()
            if self.save_target_factory is not None
            else self.table_service
        )
        if svc.describe(table_name) is None:
            from eventql_tpu.plan.nodes import ColumnDefinition, CreateTableNode

            svc.create_table(
                CreateTableNode(
                    table_name,
                    [
                        ColumnDefinition("key", "STRING"),
                        ColumnDefinition("value", "STRING"),
                    ],
                    ["key"],
                    None,
                    [],
                )
            )
        for k, v in pairs:
            svc.insert(
                table_name,
                ["key", "value"],
                [SValue.new_string(k), SValue.new_string(v)],
            )
