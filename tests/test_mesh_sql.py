"""SQL end-to-end over the device mesh (exec/mesh_exec.py).

Every query runs twice — host engine (RelationTableProvider) and mesh
tier (MeshTableProvider over the virtual 8-device CPU mesh, conftest) —
and must produce identical ResultLists. The route counter proves the
mesh program actually executed (no silent host fallback)."""

import numpy as np
import pytest

from eventql_tpu.core.types import SType
from eventql_tpu.exec.relation import Column, Relation
from eventql_tpu.exec.runtime import RelationTableProvider, Runtime
from eventql_tpu.parallel.mesh_provider import MeshTableProvider


def _make_relation(n=3000, seed=7):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 37, n).astype(np.uint64)
    vals = rng.integers(0, 1000, n).astype(np.uint64)
    ivals = rng.integers(-500, 500, n).astype(np.int64)
    fvals = np.round(rng.standard_normal(n) * 100, 3)
    cities = [f"city{int(k):02d}".encode() for k in rng.integers(0, 19, n)]
    valid = rng.random(n) < 0.9
    city_col = Column.from_strings(
        [c if rng.random() < 0.95 else None for c in cities]
    )
    return Relation(
        ["k", "v", "i", "f", "city"],
        [
            Column(SType.UINT64, keys, np.ones(n, bool)),
            Column(
                SType.UINT64, np.where(valid, vals, 0).astype(np.uint64), valid
            ),
            Column(SType.INT64, ivals, np.ones(n, bool)),
            Column(SType.FLOAT64, fvals, np.ones(n, bool)),
            city_col,
        ],
        n,
    )


def _host_provider(rel):
    p = RelationTableProvider()
    p.add_table("t", rel)
    return p


def _mesh_provider(rel, n_devices=8):
    p = MeshTableProvider(n_devices=n_devices)
    p.add_table("t", rel)
    return p


QUERIES = [
    "select k, count(1), sum(v) from t group by k order by k;",
    "select k, count(v) from t group by k order by k;",
    "select k, sum(f), min(f), max(f) from t group by k order by k;",
    "select k, mean(v) from t group by k order by k;",
    "select k % 5, sum(v + 1) from t where v < 500 group by k % 5 order by 2 desc;",
    "select k, sum(i) from t where i > -100 group by k order by k;",
    "select k, count_distinct(v) from t group by k order by k;",
    "select city, count(1), sum(v) from t group by city order by city;",
    "select city, k, sum(v) from t where k < 20 group by city, k order by city, k;",
    "select sum(v), count(1) from t where v < 900;",
    "select k + 1, sum(v) * 2 from t group by k + 1 order by 1;",
]


def _run(query, provider):
    rt = Runtime()
    txn = rt.new_transaction(provider)
    return rt.build_query_plan(txn, query).execute(0)


@pytest.fixture(scope="module")
def rel():
    return _make_relation()


@pytest.mark.parametrize("query", QUERIES)
def test_mesh_matches_host(query, rel):
    from eventql_tpu.exec import mesh_exec

    host = _run(query, _host_provider(rel))
    before = mesh_exec.MESH_GROUPBY_RUNS
    mesh = _run(query, _mesh_provider(rel))
    assert mesh_exec.MESH_GROUPBY_RUNS == before + 1, "mesh route not taken"
    assert mesh.columns == host.columns
    assert mesh.rows == host.rows


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_mesh_device_counts(rel, n_devices):
    q = "select k, count(1), sum(v) from t group by k order by k;"
    host = _run(q, _host_provider(rel))
    mesh = _run(q, _mesh_provider(rel, n_devices=n_devices))
    assert mesh.rows == host.rows


def test_non_mesh_shapes_fall_back(rel):
    """Shapes the mesh cannot serve execute on the host engine through
    the same provider — correctness never depends on eligibility."""
    queries = [
        "select count(1) from t;",  # no referenced columns
        "select k, v from t where v < 5 order by k, v limit 3;",
        "select substring(city, 1, 4), count(1) from t group by substring(city, 1, 4) order by 1;",
    ]
    for q in queries:
        host = _run(q, _host_provider(rel))
        mesh = _run(q, _mesh_provider(rel))
        assert mesh.rows == host.rows, q


def test_empty_filter_result(rel):
    q = "select k, sum(v) from t where v > 100000 group by k;"
    host = _run(q, _host_provider(rel))
    mesh = _run(q, _mesh_provider(rel))
    assert mesh.rows == host.rows == []


def test_ungrouped_empty_filter(rel):
    # reference parity: the hash-map GroupBy emits ZERO rows when no
    # row survives the filter, even ungrouped (groupby.cc:69-219 —
    # no group is ever created); host and mesh agree
    q = "select count(1), sum(v) from t where v > 100000;"
    host = _run(q, _host_provider(rel))
    mesh = _run(q, _mesh_provider(rel))
    assert mesh.rows == host.rows == []


TOPK_QUERIES = [
    "select k, v from t order by v desc limit 10;",
    "select k, v from t where v < 900 order by v desc limit 10;",
    "select k, v, f from t order by f limit 7;",
    "select city, v from t order by city limit 12;",
    "select k, v from t order by v desc limit 5 offset 3;",
    "select i from t where i > -400 order by i limit 9;",
]

ORDER_QUERIES = [
    "select k, v from t where v < 50 order by v desc, k;",
    "select city, k, v from t where v < 30 order by city, k desc, v;",
    "select f from t where v < 40 order by f desc;",
]


@pytest.mark.parametrize("query", TOPK_QUERIES)
def test_mesh_topk_matches_host(query, rel):
    from eventql_tpu.exec import mesh_exec

    host = _run(query, _host_provider(rel))
    before = mesh_exec.MESH_TOPK_RUNS
    mesh = _run(query, _mesh_provider(rel))
    assert mesh_exec.MESH_TOPK_RUNS == before + 1, "mesh top-k not taken"
    assert mesh.rows == host.rows


@pytest.mark.parametrize("query", ORDER_QUERIES)
def test_mesh_order_matches_host(query, rel):
    from eventql_tpu.exec import mesh_exec

    host = _run(query, _host_provider(rel))
    before = mesh_exec.MESH_ORDER_RUNS
    mesh = _run(query, _mesh_provider(rel))
    assert mesh_exec.MESH_ORDER_RUNS == before + 1, "mesh order not taken"
    assert mesh.rows == host.rows


def test_mesh_topk_ties_break_by_global_row(rel):
    """Value ties crossing shard boundaries must pick the lowest global
    row ids (the host's stable-sort order)."""
    n = 1024
    vals = np.full(n, 7, dtype=np.uint64)
    vals[[3, 200, 900]] = 9
    r = Relation(
        ["v", "rowid"],
        [
            Column(SType.UINT64, vals, np.ones(n, bool)),
            Column(
                SType.UINT64, np.arange(n, dtype=np.uint64), np.ones(n, bool)
            ),
        ],
        n,
    )
    q = "select rowid, v from t order by v desc limit 8;"
    host = _run(q, _host_provider(r))
    mesh = _run(q, _mesh_provider(r))
    assert mesh.rows == host.rows


def _make_join_tables(provider, n=4000, ndim=64, seed=13):
    rng = np.random.default_rng(seed)
    dim_keys = rng.permutation(np.arange(ndim, dtype=np.uint64) * 13 + 7)
    buckets = np.array(
        [f"r{i % 7}".encode() for i in range(ndim)], dtype=object
    )
    fact_keys = rng.integers(0, ndim * 2, n).astype(np.uint64) * 13 + 7
    fact_vals = rng.integers(0, 1000, n).astype(np.uint64)
    fvalid = rng.random(n) < 0.9
    facts = Relation(
        ["k", "v"],
        [
            Column(SType.UINT64, fact_keys, np.ones(n, bool)),
            Column(
                SType.UINT64,
                np.where(fvalid, fact_vals, 0).astype(np.uint64),
                fvalid,
            ),
        ],
        n,
    )
    dims = Relation(
        ["k", "region"],
        [
            Column(SType.UINT64, dim_keys, np.ones(ndim, bool)),
            Column.from_strings(list(buckets)),
        ],
        ndim,
    )
    provider.add_table("f", rel=facts)
    provider.add_table("d", rel=dims)
    return provider


JOIN_QUERIES = [
    "select d.region, count(1), sum(f.v) from f join d on f.k = d.k"
    " group by d.region order by d.region;",
    "select d.region, count(f.v) from f join d on f.k = d.k"
    " where f.v < 700 group by d.region order by d.region;",
    "select d.region, sum(f.v + 1) from f join d on f.k = d.k"
    " group by d.region order by 2 desc, d.region;",
    "select d.region, min(f.v), max(f.v), mean(f.v) from f"
    " join d on f.k = d.k group by d.region order by d.region;",
    "select d.region, count_distinct(f.v) from f join d on f.k = d.k"
    " group by d.region order by d.region;",
]


@pytest.mark.parametrize("query", JOIN_QUERIES)
def test_mesh_join_groupby_matches_host(query):
    from eventql_tpu.exec import mesh_exec

    host = _run(query, _make_join_tables(RelationTableProvider()))
    before = mesh_exec.MESH_JOIN_RUNS
    mesh = _run(query, _make_join_tables(MeshTableProvider(n_devices=8)))
    assert mesh_exec.MESH_JOIN_RUNS == before + 1, "mesh join not taken"
    assert mesh.rows == host.rows


def test_mesh_reuses_compiled_program(rel):
    """Second execution of the same plan shape hits the jit cache (the
    serving contract: one compile per plan shape per mesh)."""
    from eventql_tpu.exec import mesh_exec

    p = _mesh_provider(rel)
    q = "select k, sum(v) from t group by k order by k;"
    first = _run(q, p)
    before = mesh_exec.MESH_GROUPBY_RUNS
    second = _run(q, p)
    assert mesh_exec.MESH_GROUPBY_RUNS == before + 1
    assert first.rows == second.rows


# -- TCP-over-mesh composition: cluster workers aggregate on their mesh
#    (server/native_tcp.py _mesh_partial), GroupByMerge over TCP ------


def test_cluster_workers_aggregate_on_mesh(monkeypatch):
    import numpy as np

    from eventql_tpu.db.table_service import TableService
    from eventql_tpu.exec import mesh_exec
    from eventql_tpu.parallel.cluster import ClusterTableProvider
    from eventql_tpu.server.native_tcp import (
        NativeTCPClient,
        NativeTCPServer,
    )

    schema = (
        "CREATE TABLE ev (t uint64, k uint64, v uint64,"
        " PRIMARY KEY (t));"
    )
    rng = np.random.default_rng(31)

    def mkworker(t0, nrows):
        svc = TableService()
        server = NativeTCPServer(svc, port=0).start()
        c = NativeTCPClient("127.0.0.1", server.port)
        c.query(schema)
        rows = [
            '{"t": %d, "k": %d, "v": %d}'
            % (t0 + i, int(rng.integers(0, 7)), int(rng.integers(0, 100)))
            for i in range(nrows)
        ]
        c.insert_json("ev", rows)
        c.close()
        return server

    w1 = mkworker(0, 40)
    w2 = mkworker(1000, 40)
    provider = ClusterTableProvider(
        [("127.0.0.1", w1.port), ("127.0.0.1", w2.port)]
    )
    sql = (
        "select k, count(1), sum(v), min(v), max(v), mean(v) from ev"
        " where v < 90 group by k order by k;"
    )
    try:
        host_rows = _run(sql, provider)

        # now with worker meshes attached: each worker's partial runs
        # over its own 4-device mesh; results must be identical
        monkeypatch.setenv("EVENTQL_TPU_MESH_DEVICES", "4")
        before = mesh_exec.MESH_GROUPBY_RUNS
        mesh_rows = _run(sql, provider)
        assert mesh_exec.MESH_GROUPBY_RUNS >= before + 2, (
            "both workers must aggregate on their mesh"
        )
        assert mesh_rows.rows == host_rows.rows
    finally:
        provider.close()
        w1.stop()
        w2.stop()


def test_cluster_workers_serve_topk_on_mesh(monkeypatch):
    """Shipped LIMIT+ORDER BY pushdowns (QUERY_REMOTE) also execute on
    the worker's mesh when one is attached."""
    import numpy as np

    from eventql_tpu.db.table_service import TableService
    from eventql_tpu.exec import mesh_exec
    from eventql_tpu.parallel.cluster import ClusterTableProvider
    from eventql_tpu.server.native_tcp import (
        NativeTCPClient,
        NativeTCPServer,
    )

    schema = (
        "CREATE TABLE ev (t uint64, v uint64, PRIMARY KEY (t));"
    )
    rng = np.random.default_rng(41)

    def mkworker(t0, nrows):
        svc = TableService()
        server = NativeTCPServer(svc, port=0).start()
        c = NativeTCPClient("127.0.0.1", server.port)
        c.query(schema)
        rows = [
            '{"t": %d, "v": %d}' % (t0 + i, int(rng.integers(0, 10000)))
            for i in range(nrows)
        ]
        c.insert_json("ev", rows)
        c.close()
        return server

    w1 = mkworker(0, 300)
    w2 = mkworker(1000, 300)
    provider = ClusterTableProvider(
        [("127.0.0.1", w1.port), ("127.0.0.1", w2.port)]
    )
    sql = "select t, v from ev order by v desc limit 7;"
    try:
        host_rows = _run(sql, provider)
        monkeypatch.setenv("EVENTQL_TPU_MESH_DEVICES", "4")
        before = mesh_exec.MESH_TOPK_RUNS + mesh_exec.MESH_ORDER_RUNS
        mesh_rows = _run(sql, provider)
        assert (
            mesh_exec.MESH_TOPK_RUNS + mesh_exec.MESH_ORDER_RUNS
            >= before + 2
        ), "both workers must serve the pushdown on their mesh"
        assert mesh_rows.rows == host_rows.rows
    finally:
        provider.close()
        w1.stop()
        w2.stop()


def test_mesh_multikey_order_takes_packed_bucket_sort(rel):
    """Bounded multi-key specs pack into one u64 and ride the shipped
    sample sort (round-5): string ranks + narrowed numeric bounds sum
    under 64 bits for this spec."""
    from eventql_tpu.exec import mesh_exec

    q = "select city, k, v from t where v < 200 order by city, k desc, v;"
    host = _run(q, _host_provider(rel))
    before = mesh_exec.MESH_BUCKET_SORT_RUNS
    mesh = _run(q, _mesh_provider(rel))
    assert mesh_exec.MESH_BUCKET_SORT_RUNS == before + 1, (
        "packed bucket-sort path not taken"
    )
    assert mesh.rows == host.rows


def test_mesh_unbounded_multikey_falls_back_to_bitonic(rel):
    """A float key has no static bound (host float keys span u64):
    multi-key specs with one stay on the bitonic path — and still
    match the host engine."""
    from eventql_tpu.exec import mesh_exec

    q = "select f, k from t where v < 100 order by f, k;"
    host = _run(q, _host_provider(rel))
    b_before = mesh_exec.MESH_BUCKET_SORT_RUNS
    o_before = mesh_exec.MESH_ORDER_RUNS
    mesh = _run(q, _mesh_provider(rel))
    assert mesh_exec.MESH_ORDER_RUNS == o_before + 1
    assert mesh_exec.MESH_BUCKET_SORT_RUNS == b_before
    assert mesh.rows == host.rows


def test_mesh_topk_zero_key_corner_exact():
    """Round-5 review regression: a PASSING row whose host-order key is
    the maximum (flipped ktop == 0) displaced by a filtered tie must
    still be returned — the exactness guard's polarity was inverted
    and silently dropped it."""
    n = 1024
    vals = np.zeros(n, dtype=np.uint64)
    flag = np.ones(n, dtype=np.uint64)
    M = np.uint64(0xFFFFFFFFFFFFFFFF)
    vals[0] = M
    vals[1] = 5
    vals[700] = 7
    flag[700] = 0  # filtered high-value row forces the corner
    r = Relation(
        ["v", "flag", "rowid"],
        [
            Column(SType.UINT64, vals, np.ones(n, bool)),
            Column(SType.UINT64, flag, np.ones(n, bool)),
            Column(
                SType.UINT64, np.arange(n, dtype=np.uint64),
                np.ones(n, bool),
            ),
        ],
        n,
    )
    q = (
        "select rowid, v from t where flag = 1"
        " order by v desc limit 3;"
    )
    host = _run(q, _host_provider(r))
    mesh = _run(q, _mesh_provider(r, n_devices=2))
    assert mesh.rows == host.rows
    assert len(mesh.rows) == 3  # the v=0 zero-key rows survive
