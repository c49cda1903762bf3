"""Smoke test of the SQL engine's device path on one GPU (or, with
--four, of the mesh path on four).

    python chip_smoke.py           # one card: gpu tests, server, timings
    python chip_smoke.py --four    # four cards: the mesh SQL path only

Phases (one card):

1. `pytest -m gpu` in a child process, before this process opens the
   card (a JAX process reserves most of the card's memory).
2. Server: evqld runs in this process with its device routes on. An
   event table of 2^24 rows (u64 time, a 1024-value string event type, a
   10-bit u64 value, a string country, a user id) and two dimension
   tables (1024 and 262,144 rows) load through the native-protocol bulk
   INSERT; each query then runs over the native protocol (one over
   HTTP) on the device routes and once on the host engine, and the rows
   must match. Prints first-call and warm p50 latency, and the device
   route counters from GET /eventql/stats.
3. Plain forms: the bounded GROUP BY scatter, top-k and the join probe,
   each checked against numpy and timed with block_until_ready;
   bandwidth as a share of the card's published HBM rate.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}};
any failed phase exits non-zero without it. Each phase is a function a
CPU test can run at a tiny size.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

EVENT_ROWS = 1 << 24
DIM_ROWS = (1024, 262144)
KEYS = 1024
USERS = 262144
COUNTRIES = 64


def log(*a):
    print(*a, flush=True)


# -- phase 1 -----------------------------------------------------------------


def gpu_tests_phase() -> None:
    """Run the gpu-marked tests on the card in a child process."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "tests/"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900,
    )
    log(r.stdout[-3000:])
    if r.returncode != 0:
        raise RuntimeError(f"gpu tests failed (rc={r.returncode})\n"
                           + r.stderr[-3000:])


# -- phase 2 -----------------------------------------------------------------


def event_records(rows: int, seed: int, start: int, stop: int):
    """JSON records [start, stop) of the event table, from `seed`.
    Times are unique (the primary key), microsecond timestamps."""
    import numpy as np

    rng = np.random.default_rng([seed, start])
    n = stop - start
    t0 = 1_600_000_000_000_000
    time_ = t0 + (np.arange(start, stop, dtype=np.int64) * 1000
                  + rng.integers(0, 1000, n))
    key = rng.integers(0, KEYS, n)
    v = rng.integers(0, 1024, n)
    country = rng.integers(0, COUNTRIES, n)
    user = rng.integers(0, USERS, n)
    fmt = ('{"time":%d,"event_type":"k%04d","v":%d,"country":"c%02d",'
           '"user_id":%d}')
    return [
        fmt % r for r in zip(time_.tolist(), key.tolist(), v.tolist(),
                             country.tolist(), user.tolist())
    ]


def _http(port: int, path: str, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        body = resp.read()
    return json.loads(body) if body else None


def load_tables(http_port: int, native_port: int, rows: int, dims,
                seed: int, batch: int = 1 << 18) -> float:
    """Create and bulk-load the event and dimension tables; returns
    the load's wall seconds."""
    from eventql_tpu.server.native_tcp import NativeTCPClient

    def create(name, cols, pk):
        _http(http_port, "/api/v1/tables/create", {
            "table": name,
            "schema": {"columns": [{"name": n, "type": t} for n, t in cols]},
            "primary_key": pk,
        })

    create("events", [("time", "DATETIME"), ("event_type", "STRING"),
                      ("v", "UINT64"), ("country", "STRING"),
                      ("user_id", "UINT64")], ["time"])
    create("tiers", [("v", "UINT64"), ("tier", "STRING")], ["v"])
    create("users", [("user_id", "UINT64"), ("plan", "STRING")],
           ["user_id"])
    t0 = time.perf_counter()
    client = NativeTCPClient("127.0.0.1", native_port)
    try:
        for start in range(0, rows, batch):
            client.insert_json(
                "events",
                event_records(rows, seed, start, min(rows, start + batch)),
            )
        client.insert_json("tiers", [
            '{"v":%d,"tier":"t%02d"}' % (i, i % 16) for i in range(dims[0])
        ])
        client.insert_json("users", [
            '{"user_id":%d,"plan":"p%d"}' % (i, (i * 7919) % 10)
            for i in range(dims[1])
        ])
    finally:
        client.close()
    return time.perf_counter() - t0


# (name, sql, float columns compared within F64_RTOL relative)
QUERIES = [
    ("groupby_fused",
     "select event_type, count(1), sum(v) from events where v < 512"
     " group by event_type order by event_type;", ()),
    ("groupby_count",
     "select country, count(1) from events group by country"
     " order by country;", ()),
    ("groupby_two_sums",
     "select event_type, sum(v), sum(user_id), count(1) from events"
     " where v < 900 group by event_type order by event_type;", ()),
    ("topk",
     "select time, event_type, v from events order by v desc limit 100;", ()),
    ("order_selective",
     "select time, v from events where v >= 1020 order by v desc, time;",
     ()),
    ("join_1024",
     "select t.tier, count(1), sum(e.user_id) from events e join tiers t"
     " on e.v = t.v group by t.tier order by t.tier;", ()),
    ("join_262144",
     "select u.plan, count(1), sum(e.v) from events e join users u"
     " on e.user_id = u.user_id group by u.plan order by u.plan;", ()),
    ("count_distinct",
     "select country, count_distinct(user_id) from events"
     " group by country order by country;", ()),
    ("groupby_float",
     "select v / 7, count(1), sum(v / 7) from events group by v / 7"
     " order by 1;", (2,)),
]
HTTP_QUERY = "groupby_fused"


F64_RTOL = 1e-12  # device atomics and scans add in another order


def row_difference(a, b, float_cols=()):
    """None when the printed rows `a` and `b` match, else the first
    difference. Equality is exact except in `float_cols`, where the
    printed values may differ by F64_RTOL relative plus one unit in the
    last printed digit: two doubles that close can round to
    neighbouring printed decimals (`f64_difference` checks the
    unrounded values)."""
    if len(a) != len(b):
        return f"{len(a)} rows against {len(b)}"
    for r, (ra, rb) in enumerate(zip(a, b)):
        if len(ra) != len(rb):
            return f"row {r}: {ra} against {rb}"
        for i, (x, y) in enumerate(zip(ra, rb)):
            if x == y:
                continue
            if i not in float_cols:
                return f"row {r}: {ra} against {rb}"
            fx, fy = float(x), float(y)
            unit = 10.0 ** -len(x.partition(".")[2])
            if abs(fx - fy) > F64_RTOL * max(abs(fx), abs(fy)) + unit:
                return (f"row {r} column {i}: {x} against {y}, "
                        f"gap {abs(fx - fy)!r}")
    return None


def f64_difference(dev, host):
    """(largest relative gap, first difference over F64_RTOL or None)
    between two lists of unrounded f64 result columns."""
    import numpy as np

    worst = 0.0
    for i, (d, h) in enumerate(zip(dev, host)):
        if d.shape != h.shape:
            return worst, f"column {i}: {d.shape} rows against {h.shape}"
        scale = np.maximum(np.abs(d), np.abs(h))
        gap = np.abs(d - h)
        rel = np.divide(gap, scale, out=np.zeros_like(gap), where=scale > 0)
        bad = np.flatnonzero(rel > F64_RTOL)
        if bad.size:
            r = bad[0]
            return worst, (f"column {i} row {r}: {d[r]!r} against {h[r]!r}, "
                           f"relative gap {rel[r]!r}")
        worst = max(worst, float(rel.max(initial=0.0)))
    return worst, None


class _host_engine:
    """Within the block, queries run on the host engine (the device
    routes' reference); the previous routing is restored after."""

    def __enter__(self):
        self.prev = os.environ.get("EVENTQL_TPU_DEVICE")
        os.environ["EVENTQL_TPU_DEVICE"] = "0"

    def __exit__(self, *exc):
        if self.prev is None:
            os.environ.pop("EVENTQL_TPU_DEVICE")
        else:
            os.environ["EVENTQL_TPU_DEVICE"] = self.prev


def _f64_check(server, name, sql, float_cols) -> float:
    """Run `sql` in the server's engine on the device routes and on the
    host engine and compare the unformatted f64 columns `float_cols`;
    returns the largest relative gap."""
    import numpy as np

    def columns():
        rt = server.runtime
        txn = rt.new_transaction(server.query_provider_factory())
        rel = rt.execute_query(txn, sql)[0].relation
        return [np.asarray(rel.columns[i].data, np.float64)
                for i in float_cols]

    dev = columns()
    with _host_engine():
        host = columns()
    worst, diff = f64_difference(dev, host)
    if diff is not None:
        raise RuntimeError(f"{name}: device f64 differs from host: {diff}")
    return worst


def _device_counter() -> int:
    from eventql_tpu.utils.stats import evqld_stats

    return evqld_stats().device_route_runs.get()


def server_phase(rows: int = EVENT_ROWS, dims=DIM_ROWS, seed: int = 0,
                 reps: int = 5) -> dict:
    """Start evqld in this process, load the tables, run QUERIES on the
    device routes and on the host engine, compare. Returns per-query
    timings and the route counters."""
    from eventql_tpu.cli import evqld
    from eventql_tpu.server.native_tcp import NativeTCPClient

    daemon = evqld.serve(["--listen_http", "127.0.0.1:0",
                          "--listen_native", "127.0.0.1:0"])
    results = {}
    try:
        load_s = load_tables(daemon.http_port, daemon.native_port, rows,
                             dims, seed)
        log(f"loaded {rows} event rows + dims {dims} in {load_s:.3f} s")
        client = NativeTCPClient("127.0.0.1", daemon.native_port)
        try:
            for name, sql, float_cols in QUERIES:
                before = _device_counter()
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    dev = client.query(sql)[0][1]
                    times.append(time.perf_counter() - t0)
                if _device_counter() < before + reps:
                    raise RuntimeError(f"{name}: a run missed the device")
                with _host_engine():
                    t0 = time.perf_counter()
                    host = client.query(sql)[0][1]
                    host_s = time.perf_counter() - t0
                diff = row_difference(dev, host, float_cols)
                if diff is not None:
                    raise RuntimeError(
                        f"{name}: device rows differ from host rows: {diff}")
                if float_cols:
                    worst = _f64_check(daemon.server, name, sql, float_cols)
                    printed = sum(ra != rb for ra, rb in zip(dev, host))
                    log(f"{name}: f64 largest relative gap {worst!r} "
                        f"(limit {F64_RTOL!r}); printed rows that differ "
                        f"{printed}")
                results[name] = {
                    "first_s": times[0],
                    "warm_p50_s": statistics.median(times[1:]),
                    "host_s": host_s,
                    "rows": len(dev),
                }
                log(f"{name}: rows={len(dev)} first={times[0]:.6f}s "
                    f"warm_p50={results[name]['warm_p50_s']:.6f}s "
                    f"host={host_s:.6f}s match=yes")
        finally:
            client.close()

        sql = dict((n, q) for n, q, _f in QUERIES)[HTTP_QUERY]
        dev = _http(daemon.http_port, "/api/v1/sql", {"query": sql})
        with _host_engine():
            host = _http(daemon.http_port, "/api/v1/sql", {"query": sql})
        dev_rows = dev["results"][0]["rows"]
        diff = row_difference(dev_rows, host["results"][0]["rows"])
        if diff is not None:
            raise RuntimeError(f"HTTP: device rows differ from host rows: {diff}")
        log(f"http {HTTP_QUERY}: rows={len(dev_rows)} match=yes")

        stats = _http(daemon.http_port, "/eventql/stats")
        counters = {k: stats.get(k) for k in (
            "evqld.device_route_runs", "evqld.device_program_builds",
            "evqld.device_program_hits", "evqld.device_program_waits")}
        log("stats", json.dumps(counters))
        if not (counters["evqld.device_route_runs"]
                and counters["evqld.device_program_builds"]
                and counters["evqld.device_program_hits"]):
            raise RuntimeError("device route counters show no device runs")
        from eventql_tpu.exec import device_exec

        routes = {"fused_groupby": device_exec.FUSED_GROUPBY_COUNT,
                  "multi_sum_groupby": device_exec.MULTI_SUM_GROUPBY_COUNT}
        log("routes", json.dumps(routes))
        if not all(routes.values()):
            raise RuntimeError(f"a bounded GROUP BY route never ran: {routes}")
        return {"load_s": load_s, "queries": results, "stats": counters}
    finally:
        daemon.stop()


# -- phase 3 -----------------------------------------------------------------


def _time(fn, *args, reps: int = 10):
    """(first-call seconds incl. compile, median warm seconds, the
    first call's result)."""
    import jax

    t0 = time.perf_counter()
    result = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, statistics.median(times), result


def _memory(fn, *args) -> str:
    try:
        return str(fn.lower(*args).compile().memory_analysis())
    except Exception as e:  # not every backend reports it
        return f"memory_analysis unavailable: {e}"


def plain_forms_phase(n: int = EVENT_ROWS, seed: int = 0,
                      reps: int = 10) -> dict:
    """Time the plain JAX forms that replaced the hand-written kernels,
    and check each against a numpy reference. Returns seconds and bytes
    per form; the caller divides by the card's peak."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from eventql_tpu.kernels import bucket_agg, join, sort

    rng = np.random.default_rng(seed)
    gid = rng.integers(0, KEYS, n).astype(np.int32)
    v = rng.integers(0, 1024, n).astype(np.int32)
    out = {}

    def run(name, fn, args, nbytes, check):
        first, warm, result = _time(fn, *args, reps=reps)
        if not check(result):
            raise RuntimeError(f"{name} differs from the numpy reference")
        out[name] = {"first_s": first, "s": warm, "bytes": nbytes}

    def same(x, y):
        return np.array_equal(np.asarray(x), np.asarray(y))

    # fused GROUP BY as served: i32 key and value streams, WHERE v < 512
    g_d, v_d = jnp.asarray(gid), jnp.asarray(v)
    keep = v < 512
    want_c = np.bincount(gid[keep], minlength=KEYS)
    want_s = np.bincount(gid[keep], weights=v[keep], minlength=KEYS)
    fused = jax.jit(lambda g, x: bucket_agg.fused_sum_count(
        g, x, jnp.int32(512), jnp.int32(n), KEYS, value_bits=16))
    run("groupby_fused_scatter", fused, (g_d, v_d), 8 * n,
        lambda r: same(r[0], want_c) and same(r[1], want_s.astype(np.uint64)))
    log("memory groupby_fused_scatter:", _memory(fused, g_d, v_d))
    count = jax.jit(lambda g: bucket_agg.fused_count(
        g, jnp.int32(-(1 << 31)), jnp.int32(n), KEYS))
    run("groupby_count_scatter", count, (g_d,), 4 * n,
        lambda r: same(r, np.bincount(gid, minlength=KEYS)))

    # two u64 sums in one scatter (the route for computed sum args)
    mask = jnp.ones((n,), bool)
    two_args = (mask, g_d, v_d.astype(jnp.uint64), g_d.astype(jnp.uint64))
    want_a = np.bincount(gid, weights=v, minlength=KEYS).astype(np.uint64)
    want_b = np.bincount(gid, weights=gid, minlength=KEYS).astype(np.uint64)
    two = jax.jit(lambda m, g, a, b: bucket_agg.bounded_grouped_aggregate(
        m, g, (a, b), ("sum", "sum"), KEYS))
    run("two_sums_scatter", two, two_args, 21 * n,
        lambda r: same(r[1][0], want_a) and same(r[1][1], want_b))

    # top-k over u64 and u32 keys, as the ORDER BY ... LIMIT route runs it
    k = 128
    for width, dt in ((64, np.uint64), (32, np.uint32)):
        keys = rng.integers(0, np.iinfo(dt).max, n, dtype=dt, endpoint=True)
        want = np.sort(keys)[::-1][:k]
        run(f"topk_u{width}", jax.jit(lambda x: sort.topk_permutation(x, k)),
            (jnp.asarray(keys),), (width // 8) * n,
            lambda r: same(keys[np.asarray(r)], want))

    # fact-dim join + GROUP BY: binary-search probe + gather + scatter
    fv = v.astype(np.uint64)
    for nd in DIM_ROWS:
        dim_keys = rng.permutation(nd).astype(np.uint64) * 3 + 1
        dim_bucket = rng.integers(0, 16, nd).astype(np.int32)
        fk = rng.integers(0, nd, n).astype(np.uint64) * 3 + 1
        args = (jnp.asarray(fk), jnp.asarray(fv), mask,
                jnp.asarray(dim_keys), jnp.asarray(dim_bucket))
        lut = np.zeros(nd * 3 + 2, np.int64)
        lut[dim_keys.astype(np.int64)] = dim_bucket
        b = lut[fk.astype(np.int64)]
        want_jc = np.bincount(b, minlength=16)
        want_js = np.bincount(b, weights=fv, minlength=16).astype(np.uint64)
        search = jax.jit(lambda a, b, c, d, e: join.fact_dim_join_aggregate(
            a, b, c, d, e, 16))
        run(f"join_{nd}_search", search, args, 17 * n,
            lambda r: same(r[0], want_jc) and same(r[1], want_js))
    return out


# -- four cards --------------------------------------------------------------


# (name, sql, the mesh_exec route counter the query must advance)
MESH_QUERIES = [
    ("mesh_groupby", "select k, count(1), sum(v) from t where v < 800000"
     " group by k order by k;", "MESH_GROUPBY_RUNS"),
    ("mesh_topk", "select k, v from t order by v desc limit 5;",
     "MESH_TOPK_RUNS"),
    ("mesh_order", "select k, v from t where v < 60 order by v desc;",
     "MESH_ORDER_RUNS"),
    ("mesh_having", "select k, sum(v) as s from t group by k"
     " having s > 100 order by k;", "MESH_GROUPBY_RUNS"),
    ("mesh_join", "select d.g, count(1), sum(t.v) from t join d"
     " on t.k = d.k group by d.g order by d.g;", "MESH_JOIN_RUNS"),
]


def _mesh_tables(n: int, seed: int):
    """The mesh phase's fact table t(k, v) and dim table d(k, g)."""
    import numpy as np

    from eventql_tpu.core.types import SType
    from eventql_tpu.exec.relation import Column, Relation

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 9, n).astype(np.uint64)
    vals = rng.integers(0, 1 << 20, n).astype(np.uint64)
    ones = np.ones(n, bool)
    t = Relation(["k", "v"], [Column(SType.UINT64, keys, ones),
                              Column(SType.UINT64, vals, ones)], n)
    d = Relation(["k", "g"], [
        Column(SType.UINT64, np.arange(9, dtype=np.uint64), np.ones(9, bool)),
        Column.from_strings([b"g%d" % (i % 4) for i in range(9)]),
    ], 9)
    return t, d


def _host_rows(sql: str, n: int, seed: int):
    """In a child process on the CPU backend: the host engine's rows for
    one mesh query over the same seeded tables."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["EVENTQL_TPU_DEVICE"] = "0"
    from eventql_tpu.exec.runtime import RelationTableProvider, Runtime

    t, d = _mesh_tables(n, seed)
    provider = RelationTableProvider()
    provider.add_table("t", t)
    provider.add_table("d", d)
    rt = Runtime()
    return rt.execute_query(rt.new_transaction(provider), sql)[0].rows


def mesh_phase(n_devices: int = 4, rows_per_device: int = EVENT_ROWS,
               seed: int = 1) -> dict:
    """The mesh SQL path (MeshTableProvider over a 1-D mesh of the
    devices) on the query shapes of __graft_entry__.dryrun_multichip
    (GROUP BY, top-k, full ORDER BY, HAVING) plus a fact-dim join, each
    compared with the host engine; prints each query's exchange bytes.
    Values are 20-bit so the full ORDER BY stays selective. The host
    engine's rows are computed meanwhile in child processes on the CPU
    backend (one JAX process per card)."""
    import concurrent.futures
    import multiprocessing

    import jax

    from eventql_tpu.exec import mesh_exec
    from eventql_tpu.exec.runtime import Runtime
    from eventql_tpu.parallel.distributed import exchange_tally, make_mesh
    from eventql_tpu.parallel.mesh_provider import MeshTableProvider

    devices = jax.devices()
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, found {len(devices)}")
    mesh = make_mesh(n_devices, devices=devices[:n_devices])
    n = n_devices * rows_per_device
    t, d = _mesh_tables(n, seed)
    rt = Runtime()
    mesh_p = MeshTableProvider(mesh=mesh, axis="shards")
    mesh_p.add_table("t", t)
    mesh_p.add_table("d", d)
    out = {}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
        len(MESH_QUERIES), mp_context=ctx
    ) as pool:
        host = {name: pool.submit(_host_rows, sql, n, seed)
                for name, sql, _c in MESH_QUERIES}
        for name, sql, counter in MESH_QUERIES:
            runs = getattr(mesh_exec, counter)
            t0 = time.perf_counter()
            with exchange_tally(allow_empty=True) as tally:
                mesh_rows = rt.execute_query(
                    rt.new_transaction(mesh_p), sql)[0].rows
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            mesh_rows = rt.execute_query(
                rt.new_transaction(mesh_p), sql)[0].rows
            warm = time.perf_counter() - t0
            if getattr(mesh_exec, counter) != runs + 2:
                raise RuntimeError(f"{name}: did not run on the mesh")
            if mesh_rows != host[name].result():
                raise RuntimeError(f"{name}: mesh rows differ from host rows")
            xbytes = sum(r["bytes_per_device"] for r in tally.records)
            out[name] = {"first_s": first, "warm_s": warm,
                         "rows": len(mesh_rows),
                         "exchange_bytes_per_device": xbytes,
                         "collectives": len(tally.records)}
            log(f"{name}: rows={len(mesh_rows)} first={first:.6f}s "
                f"warm={warm:.6f}s exchange_bytes_per_device={xbytes} "
                f"collectives={len(tally.records)} match=yes")
    return out


# -- driver ------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the mesh SQL path on four cards, nothing else")
    args = ap.parse_args(argv)

    try:
        import eventql_tpu  # noqa: F401
    except ImportError as e:
        log(f"chip_smoke: the eventql_tpu package is not here: {e}")
        return 2
    from eventql_tpu.utils.device_info import card_line, hbm_bytes_per_s

    card = card_line()
    if not args.four:
        gpu_tests_phase()

    import jax

    from eventql_tpu.exec.backend import require_gpu

    devices = require_gpu()
    dev = devices[0]
    log(card)
    log(f"jax {jax.__version__} devices {devices}")

    t0 = time.perf_counter()
    if args.four:
        mesh_phase(4)
        count = 4
    else:
        server_phase()
        log(f"server phase: {time.perf_counter() - t0:.3f} s")
        peak = hbm_bytes_per_s(dev.device_kind)
        for name, r in plain_forms_phase().items():
            rate = r["bytes"] / r["s"]
            log(f"{name}: first={r['first_s']:.6f}s warm={r['s']:.9f}s "
                f"bytes={r['bytes']} GB/s={rate / 1e9:.3f} "
                f"hbm_share={rate / peak:.4f} card=[{card}]")
        count = 1
    log(f"phases took {time.perf_counter() - t0:.3f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
