"""Benchmark configs: `BENCH_CONFIG=<name> python bench.py` (default
groupby). Each config prints one JSON line stamped with the device it
ran on (platform, device kind, device count, power limit —
eventql_tpu/utils/device_info.py); there is no CPU fallback.

Device configs time one call of their jitted step with
block_until_ready: the median of BENCH_REPS warm calls after one
compile call. `hbm_share` divides the bytes the step must read by the
time and the card's published HBM rate. The SQL configs time whole
queries through Runtime; the host configs (latency, insert, scaling,
*_vs_reference) time the server, protocol and process tiers.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def _emit(result: dict):
    from eventql_tpu.utils.device_info import device_stamp

    print(json.dumps({**result, **device_stamp()}))


def _env(name, default):
    return int(os.environ.get(name, default))


def _time(fn, *args):
    """(compile-call seconds, median warm seconds) of fn(*args)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(_env("BENCH_REPS", 10)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, statistics.median(ts)


def _device_result(metric, fn, args, rows, nbytes, **extra):
    import jax

    from eventql_tpu.utils.device_info import hbm_bytes_per_s

    first, s = _time(fn, *args)
    peak = hbm_bytes_per_s(jax.devices()[0].device_kind)
    return {
        "metric": metric,
        "value": rows / s,
        "unit": "rows/s",
        "seconds": s,
        "compile_call_seconds": first,
        "bytes_read": nbytes,
        "hbm_share": nbytes / s / peak,
        **extra,
    }


def _groupby_inputs(n, n_keys, seed=42):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    gid = jnp.asarray(rng.integers(0, n_keys, n).astype(np.int32))
    vals = jnp.asarray(rng.integers(0, 1000, n).astype(np.int32))
    return gid, vals


def bench_groupby():
    """scan + WHERE v < 800 + GROUP BY k sum(v), count(*) over i32
    key and value streams, as the SQL route serves it
    (kernels/bucket_agg.fused_sum_count)."""
    import jax
    import jax.numpy as jnp

    from eventql_tpu.kernels.bucket_agg import fused_sum_count

    n, k = _env("BENCH_ROWS", 1 << 24), _env("BENCH_KEYS", 1024)
    gid, vals = _groupby_inputs(n, k)
    fn = jax.jit(lambda g, v: fused_sum_count(
        g, v, jnp.int32(800), jnp.int32(n), k, value_bits=16))
    return _device_result("groupby_rows_per_sec", fn, (gid, vals), n, 8 * n)


def bench_groupby_count():
    """count(*)-only GROUP BY with the WHERE on a second stream."""
    import jax
    import jax.numpy as jnp

    from eventql_tpu.kernels.bucket_agg import fused_count

    n, k = _env("BENCH_ROWS", 1 << 24), _env("BENCH_KEYS", 1024)
    gid, vals = _groupby_inputs(n, k)
    fn = jax.jit(lambda g, v: fused_count(
        g, jnp.int32(800), jnp.int32(n), k, pred=v, pred_op="lt"))
    return _device_result(
        "groupby_count_only_rows_per_sec", fn, (gid, vals), n, 8 * n)


def bench_groupby_multisum():
    """sum(a), sum(b), count(*) GROUP BY k in one scatter."""
    import jax

    from eventql_tpu.kernels.bucket_agg import bounded_multi_sum

    n, k = _env("BENCH_ROWS", 1 << 24), _env("BENCH_KEYS", 1024)
    gid, a = _groupby_inputs(n, k)
    _g, b = _groupby_inputs(n, k, seed=43)
    fn = jax.jit(lambda g, x, y: bounded_multi_sum(
        x < 800, g, (x, y), (2, 2), k))
    return _device_result(
        "groupby_two_sums_rows_per_sec", fn, (gid, a, b), n, 12 * n)


def bench_skew():
    """The GROUP BY scatter under Zipf(1.2) keys (the hottest key takes
    ~30% of rows) against uniform keys; vs_uniform = zipf / uniform."""
    import jax
    import jax.numpy as jnp

    from eventql_tpu.kernels.bucket_agg import bounded_sum_count

    n, k = _env("BENCH_ROWS", 1 << 24), _env("BENCH_KEYS", 1024)
    rng = np.random.default_rng(23)
    uniform = rng.integers(0, k, n).astype(np.int32)
    zipf = ((np.minimum(rng.zipf(1.2, n), 1 << 30) - 1) % k).astype(np.int32)
    vals = jnp.asarray(rng.integers(0, 1000, n).astype(np.uint64))
    fn = jax.jit(lambda g, v: bounded_sum_count(v < 800, g, v, k))
    res = {
        name: _device_result("skewed_groupby_rows_per_sec", fn,
                             (jnp.asarray(g), vals), n, 12 * n)
        for name, g in (("uniform", uniform), ("zipf", zipf))
    }
    out = res["zipf"]
    out["uniform_rows_per_sec"] = res["uniform"]["value"]
    out["vs_uniform"] = out["value"] / res["uniform"]["value"]
    return out


def bench_scan():
    """Columnar scan + two-term predicate + count over two u16 streams
    (the FastCSTableScan analog, CSTableScan.cc:757-858)."""
    import jax
    import jax.numpy as jnp

    n = _env("BENCH_ROWS", 1 << 26)
    rng = np.random.default_rng(3)
    a = jnp.asarray(rng.integers(0, 1000, n).astype(np.uint16))
    b = jnp.asarray(rng.integers(0, 1000, n).astype(np.uint16))
    fn = jax.jit(lambda a, b: (
        (a.astype(jnp.uint64) < 800) & (b.astype(jnp.uint64) >= 100)
    ).sum(dtype=jnp.int64))
    return _device_result("scan_filter_rows_per_sec", fn, (a, b), n, 4 * n)


def bench_topk():
    """ORDER BY ... LIMIT k over one u64 key (kernels/sort.py)."""
    import jax
    import jax.numpy as jnp

    from eventql_tpu.kernels.sort import topk_permutation

    n, k = _env("BENCH_ROWS", 1 << 26), _env("BENCH_K", 100)
    rng = np.random.default_rng(7)
    keys = jnp.asarray(rng.integers(0, 1 << 62, n, dtype=np.uint64))
    fn = jax.jit(lambda x: topk_permutation(x, k))
    return _device_result("orderby_limit_topk_rows_per_sec", fn, (keys,),
                          n, 8 * n)


def bench_sort():
    """Full ORDER BY: stable sort of u64 keys with an i32 payload; the
    byte count is one pass, a lower bound for a sort."""
    import jax
    import jax.numpy as jnp

    from eventql_tpu.kernels.sort import order_permutation

    n = _env("BENCH_ROWS", 1 << 26)
    rng = np.random.default_rng(13)
    keys = jnp.asarray(rng.integers(0, 1 << 62, n, dtype=np.uint64))
    fn = jax.jit(lambda x: order_permutation((x,)))
    return _device_result("orderby_full_sort_rows_per_sec", fn, (keys,),
                          n, 12 * n)


def bench_join():
    """Fact-dim join + GROUP BY (kernels/join.fact_dim_join_aggregate):
    binary-search probe, payload gather, bounded scatter."""
    import jax
    import jax.numpy as jnp

    from eventql_tpu.kernels.join import fact_dim_join_aggregate

    n, nd = _env("BENCH_ROWS", 1 << 24), _env("BENCH_DIM", 1024)
    k = _env("BENCH_KEYS", 1024)
    rng = np.random.default_rng(9)
    dk = jnp.asarray(rng.permutation(nd).astype(np.uint64) * 7919 + 3)
    db = jnp.asarray(rng.integers(0, k, nd).astype(np.int32))
    fk = jnp.asarray(rng.integers(0, nd, n).astype(np.uint64) * 7919 + 3)
    fv = jnp.asarray(rng.integers(0, 1000, n).astype(np.uint64))
    fm = jnp.asarray(rng.random(n) < 0.8)
    fn = jax.jit(lambda a, b, c, d, e: fact_dim_join_aggregate(
        a, b, c, d, e, k))
    return _device_result("join_aggregate_rows_per_sec", fn,
                          (fk, fv, fm, dk, db), n, 17 * n, dims=nd)


def bench_multijoin():
    """Facts probe dim1 (bucket) and dim2 (flag filter), then one
    GROUP BY scatter: the per-device program of
    parallel/distributed.distributed_multi_join_aggregate."""
    import jax
    import jax.numpy as jnp

    from eventql_tpu.kernels.bucket_agg import bounded_sum_count
    from eventql_tpu.kernels.join import dim_join_gid

    n, k = _env("BENCH_ROWS", 1 << 24), _env("BENCH_KEYS", 1024)
    nd1, nd2 = _env("BENCH_DIM", 1024), _env("BENCH_DIM2", 256)
    rng = np.random.default_rng(31)
    d1k = jnp.asarray(rng.permutation(nd1).astype(np.uint64) * 7919 + 3)
    d1b = jnp.asarray(rng.integers(0, k, nd1).astype(np.int32))
    d2k = jnp.asarray(rng.permutation(nd2).astype(np.uint64) * 104729 + 11)
    d2f = jnp.asarray(rng.integers(0, 2, nd2).astype(np.int32))
    fk1 = jnp.asarray(rng.integers(0, nd1, n).astype(np.uint64) * 7919 + 3)
    fk2 = jnp.asarray(rng.integers(0, nd2, n).astype(np.uint64) * 104729 + 11)
    fv = jnp.asarray(rng.integers(0, 1000, n).astype(np.uint64))

    def step(fk1, fk2, fv, d1k, d1b, d2k, d2f):
        g1 = dim_join_gid(fk1, d1k, d1b)
        g2 = dim_join_gid(fk2, d2k, d2f)
        mask = (g2 == 1) & (g1 >= 0) & (fv < 800)
        return bounded_sum_count(mask, jnp.maximum(g1, 0), fv, k)

    return _device_result("multijoin_agg_rows_per_sec", jax.jit(step),
                          (fk1, fk2, fv, d1k, d1b, d2k, d2f), n, 24 * n)


def _sql_provider(n, seed=42):
    from eventql_tpu.core.types import SType
    from eventql_tpu.exec.relation import Column, Relation
    from eventql_tpu.exec.runtime import RelationTableProvider

    rng = np.random.default_rng(seed)
    k = _env("BENCH_KEYS", 1024)
    ones = np.ones(n, bool)
    rel = Relation(["k", "t", "v"], [
        Column(SType.STRING, rng.integers(0, k, n).astype(np.int32), ones,
               np.array([b"k%05d" % i for i in range(k)], dtype=object)),
        Column(SType.UINT64, rng.integers(0, 1 << 62, n, dtype=np.uint64),
               ones),
        Column(SType.UINT64, rng.integers(0, 1000, n).astype(np.uint64),
               ones),
    ], n)
    provider = RelationTableProvider()
    provider.add_table("t", rel)
    return provider


def _sql_result(metric, query, n):
    """Whole-query time through Runtime with a plan cache (the servers'
    serving configuration), device column caches warm."""
    from eventql_tpu.exec.runtime import PlanCache, Runtime

    provider = _sql_provider(n)
    rt = Runtime(plan_cache=PlanCache())

    def run():
        return rt.build_query_plan(rt.new_transaction(provider),
                                   query).execute(0)

    t0 = time.perf_counter()
    run()
    first = time.perf_counter() - t0
    ts = []
    for _ in range(_env("BENCH_REPS", 10)):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    s = statistics.median(ts)
    return {"metric": metric, "value": n / s, "unit": "rows/s",
            "query_seconds_p50": s, "first_query_seconds": first}


def bench_sql_groupby():
    return _sql_result(
        "sql_groupby_rows_per_sec",
        "select k, count(1), sum(v) from t where v < 800 group by k;",
        _env("BENCH_ROWS", 1 << 24))


def bench_sql_topk():
    return _sql_result(
        "sql_orderby_limit_rows_per_sec",
        "select t, v from t order by t desc limit 100;",
        _env("BENCH_ROWS", 1 << 24))


def bench_latency():
    """`select 1;` round trips over the native protocol on loopback
    (the evqlslap analog); the reference's only published number is a
    ~0.1 ms claim (README.md:44-45)."""
    from eventql_tpu.db.table_service import TableService
    from eventql_tpu.server.native_tcp import NativeTCPClient, NativeTCPServer

    srv = NativeTCPServer(TableService(), port=0).start()
    try:
        c = NativeTCPClient("127.0.0.1", srv.port)
        c.query("select 1;")
        ts = []
        for _ in range(_env("BENCH_REPS", 300)):
            t0 = time.perf_counter()
            c.query("select 1;")
            ts.append(time.perf_counter() - t0)
        c.close()
    finally:
        srv.stop()
    ts.sort()
    return {"metric": "minimal_sql_query_latency_p50",
            "value": ts[len(ts) // 2] * 1e3, "unit": "ms",
            "p99_ms": ts[int(len(ts) * 0.99)] * 1e3}


def bench_insert():
    """Batched native-protocol inserts into a durable LSM table served
    by an evqld child on the CPU backend (arena -> segment flush)."""
    import shutil
    import tempfile

    from eventql_tpu.server.native_tcp import NativeTCPClient

    rows, batch = _env("BENCH_ROWS", 200_000), _env("BENCH_BATCH", 2000)
    datadir = tempfile.mkdtemp(prefix="evql_insert_bench")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "eventql_tpu.cli.evqld",
         "--listen_http", "127.0.0.1:19180", "--datadir", datadir],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env,
        cwd=ROOT,
    )
    try:
        deadline = time.time() + 60
        c = None
        while c is None and time.time() < deadline:
            try:
                c = NativeTCPClient("127.0.0.1", 19180)
            except OSError:
                time.sleep(0.2)
        if c is None:
            raise RuntimeError("evqld did not come up")
        c.query("CREATE TABLE ev (id uint64, ts uint64, v uint64,"
                " PRIMARY KEY (id));")
        ids = np.random.default_rng(7).permutation(rows)
        batches = [
            ['{"id":%d,"ts":%d,"v":%d}' % (i, i * 1000, i % 997)
             for i in ids[off:off + batch].tolist()]
            for off in range(0, rows, batch)
        ]
        t0 = time.perf_counter()
        for recs in batches:
            c.insert_json("ev", recs)
        elapsed = time.perf_counter() - t0
        (_cols, rws), = c.query("select count(1) from ev;")
        if rws[0][0] != str(rows):
            raise RuntimeError(f"inserted {rws[0][0]} of {rows} rows")
        c.close()
    finally:
        proc.terminate()
        proc.wait()
        shutil.rmtree(datadir, ignore_errors=True)
    return {"metric": "insert_rows_per_sec_native_protocol",
            "value": rows / elapsed, "unit": "rows/s",
            "includes_client_json_framing": True}


def bench_scaling():
    """Distributed GROUP BY weak scaling over the process tier: W worker
    processes (on the CPU backend: this measures the TCP tier, and one
    JAX process per card is the rule) each own BENCH_ROWS_PER_WORKER
    rows; the coordinator ships partial-aggregate plans and merges."""
    from eventql_tpu.exec.runtime import Runtime
    from eventql_tpu.parallel.cluster import ClusterTableProvider

    rows = _env("BENCH_ROWS_PER_WORKER", 4_000_000)
    n_keys = _env("BENCH_KEYS", 1024)
    curve = sorted({int(x) for x in os.environ.get(
        "BENCH_WORKER_CURVE", "1,2").split(",")})
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")

    def measure(w):
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "scripts", "bench_worker.py"),
             str(1000 + i), str(rows), str(n_keys)],
            stdout=subprocess.PIPE, text=True, env=env,
        ) for i in range(w)]
        try:
            addrs = [("127.0.0.1", int(p.stdout.readline())) for p in procs]
            provider = ClusterTableProvider(addrs)
            rt = Runtime()
            q = "select dim, sum(v), count(1) from ev group by dim;"

            def once():
                res = rt.build_query_plan(
                    rt.new_transaction(provider), q).execute(0)
                if res.num_rows != n_keys:
                    raise RuntimeError("wrong group count")

            once()
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                once()
                ts.append(time.perf_counter() - t0)
            provider.close()
            return min(ts)
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.wait()

    times = {w: measure(w) for w in curve}
    wmax = curve[-1]
    return {
        "metric": f"distributed_groupby_weak_scaling_{wmax}_workers",
        "value": wmax * rows / times[wmax], "unit": "rows/s",
        "weak_scaling_efficiency": times[curve[0]] / times[wmax],
        "curve": [{"workers": w, "t_s": times[w]} for w in curve],
        "host_cpus": os.cpu_count(),
    }


def _ref_binary(name):
    from eventql_tpu.columnar.native import build_native

    if not build_native(name):
        raise RuntimeError(f"could not build native/build/{name}")
    return os.path.join(ROOT, "native", "build", name)


def _ref_rate(name, *args):
    out = subprocess.run([_ref_binary(name)] + [str(a) for a in args],
                         check=True, capture_output=True, text=True).stdout
    return json.loads(out)["rows_per_sec"]


def _vs_reference(metric, ours, ref_rows_per_sec):
    return {"metric": metric, "value": ours["value"] / ref_rows_per_sec,
            "unit": "x (one card vs one core of the reference's C++ model)",
            "rows_per_sec": ours["value"],
            "reference_rows_per_sec": ref_rows_per_sec}


def bench_groupby_vs_reference():
    """Against a C++ model of the reference's GroupBy loop (per-row SHA1
    group key + hash-map accumulate, groupby.cc:69-219)."""
    n, k = _env("BENCH_ROWS", 1 << 24), _env("BENCH_KEYS", 1024)
    return _vs_reference("groupby_speedup_vs_reference_engine",
                         bench_groupby(),
                         _ref_rate("ref_groupby_bench", n, k, 3))


def bench_topk_vs_reference():
    """Against the reference's ORDER BY ... LIMIT model: full std::sort
    of materialized rows, then trim (orderby.cc:58-168 + limit.cc)."""
    n, k = _env("BENCH_ROWS", 1 << 26), _env("BENCH_K", 100)
    return _vs_reference("orderby_limit_speedup_vs_reference_engine",
                         bench_topk(),
                         _ref_rate("ref_ops_bench", "orderby", n, k, 1))


def bench_join_vs_reference():
    """Against the reference's hash join model: multimap build + per-row
    probe + accumulate (hash_join.cc)."""
    n, nd = _env("BENCH_ROWS", 1 << 24), _env("BENCH_DIM", 1024)
    k = _env("BENCH_KEYS", 1024)
    return _vs_reference("join_aggregate_speedup_vs_reference_engine",
                         bench_join(),
                         _ref_rate("ref_ops_bench", "join", n, nd, k, 3))


CONFIGS = {
    name[len("bench_"):]: fn
    for name, fn in globals().items()
    if name.startswith("bench_") and callable(fn)
}


def main():
    from eventql_tpu.exec.backend import require_gpu

    require_gpu()
    cfg = os.environ.get("BENCH_CONFIG", "groupby")
    if cfg not in CONFIGS:
        raise SystemExit(f"unknown BENCH_CONFIG {cfg!r}: {sorted(CONFIGS)}")
    _emit(CONFIGS[cfg]())


if __name__ == "__main__":
    main()
