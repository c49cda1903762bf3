"""Differential tests: device GroupBy fast path vs the host engine.

Every query runs twice (host engine, device path) and must produce
identical ResultLists."""

import os

import numpy as np
import pytest

from eventql_tpu.core.types import SType
from eventql_tpu.exec.relation import Column, Relation
from eventql_tpu.exec.runtime import RelationTableProvider, Runtime


def _make_table(n=5000, seed=7):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 37, n).astype(np.uint64)
    vals = rng.integers(0, 1000, n).astype(np.uint64)
    fvals = np.round(rng.standard_normal(n) * 100, 3)
    valid = rng.random(n) < 0.9
    rel = Relation(
        ["k", "v", "f"],
        [
            Column(SType.UINT64, keys, np.ones(n, bool)),
            Column(
                SType.UINT64, np.where(valid, vals, 0).astype(np.uint64), valid
            ),
            Column(SType.FLOAT64, fvals, np.ones(n, bool)),
        ],
        n,
    )
    p = RelationTableProvider()
    p.add_table("t", rel)
    return p


QUERIES = [
    "select k, count(1), sum(v) from t group by k order by k;",
    "select k, count(v) from t group by k order by k;",
    "select count(1) from t;",
    "select k, sum(f), min(f), max(f) from t group by k order by k;",
    "select k % 5, sum(v + 1) from t where v < 500 group by k % 5 order by 2 desc;",
    "select sum(v) + count(1) from t where k > 10;",
    "select k, count_distinct(v) from t group by k order by k;",
]


def _run(query, device: bool):
    prev = os.environ.get("EVENTQL_TPU_DEVICE")
    os.environ["EVENTQL_TPU_DEVICE"] = "1" if device else "0"
    try:
        rt = Runtime()
        txn = rt.new_transaction(_make_table())
        return rt.build_query_plan(txn, query).execute(0)
    finally:
        if prev is None:
            os.environ.pop("EVENTQL_TPU_DEVICE", None)
        else:
            os.environ["EVENTQL_TPU_DEVICE"] = prev


@pytest.mark.parametrize("query", QUERIES)
def test_device_matches_host(query):
    host = _run(query, device=False)
    dev = _run(query, device=True)
    assert dev.columns == host.columns
    assert dev.rows == host.rows


def test_device_path_is_taken():
    """Sanity: the eligibility check accepts the canonical pipeline."""
    from eventql_tpu.exec.device_exec import device_plan_eligible
    from eventql_tpu.sql.parser import Parser
    from eventql_tpu.plan.builder import QueryPlanBuilder

    rt = Runtime()
    txn = rt.new_transaction(_make_table(100))
    stmts = Parser().parse("select k, sum(v) from t group by k;")
    node = QueryPlanBuilder().build(stmts[0], txn.tables)
    assert device_plan_eligible(node)


def _make_string_table(n=5000, seed=11):
    rng = np.random.default_rng(seed)
    cities = [f"city{int(k):02d}".encode() for k in rng.integers(0, 19, n)]
    vals = rng.integers(0, 1000, n).astype(np.uint64)
    valid = rng.random(n) < 0.9
    rel = Relation(
        ["city", "v"],
        [
            Column.from_strings(cities),
            Column(
                SType.UINT64, np.where(valid, vals, 0).astype(np.uint64), valid
            ),
        ],
        n,
    )
    p = RelationTableProvider()
    p.add_table("t", rel)
    return p


STRING_KEY_QUERIES = [
    "select city, count(1), sum(v) from t group by city order by city;",
    "select city, count(v) from t where v < 500 group by city order by city;",
    "select city, sum(v) + count(1) from t group by city order by city;",
    # a narrow column's sum beside a computed sum wider than 16 bits
    "select city, sum(v), sum(v * 100000) from t group by city"
    " order by city;",
]


@pytest.mark.parametrize("query", STRING_KEY_QUERIES)
def test_string_key_pallas_route_matches_host(query):
    prev = os.environ.get("EVENTQL_TPU_DEVICE")
    try:
        os.environ["EVENTQL_TPU_DEVICE"] = "0"
        rt = Runtime()
        host = rt.build_query_plan(
            rt.new_transaction(_make_string_table()), query
        ).execute(0)
        os.environ["EVENTQL_TPU_DEVICE"] = "1"
        dev = rt.build_query_plan(
            rt.new_transaction(_make_string_table()), query
        ).execute(0)
    finally:
        if prev is None:
            os.environ.pop("EVENTQL_TPU_DEVICE", None)
        else:
            os.environ["EVENTQL_TPU_DEVICE"] = prev
    assert dev.columns == host.columns
    assert dev.rows == host.rows


def test_string_key_pallas_route_is_taken():
    from eventql_tpu.exec.device_exec import try_execute_bounded_groupby
    from eventql_tpu.plan.builder import QueryPlanBuilder
    from eventql_tpu.sql.parser import Parser

    rt = Runtime()
    txn = rt.new_transaction(_make_string_table(200))
    stmts = Parser().parse("select city, sum(v) from t group by city;")
    node = QueryPlanBuilder().build(stmts[0], txn.tables)
    assert try_execute_bounded_groupby(node, txn) is not None


# -- fused-predicate Pallas GROUP BY route (round 4) -------------------
def _make_fused_table(n=5000, seed=23, null_keys=False):
    rng = np.random.default_rng(seed)
    cities = [
        f"city{int(k):02d}".encode() for k in rng.integers(0, 19, n)
    ]
    if null_keys:
        for i in rng.integers(0, n, n // 20):
            cities[int(i)] = None
    vals = rng.integers(0, 1000, n).astype(np.uint64)
    wide = rng.integers(0, 1 << 20, n).astype(np.uint64)  # narrows to u32
    big = rng.integers(0, 1 << 35, n).astype(np.uint64)  # stays u64
    cat = rng.integers(100, 180, n).astype(np.uint64)  # numeric key, span 80
    # base-offset key: values far above 64K whose SPAN fits the fused
    # bucket bound only through the true-min stat (key - min in-program)
    epoch = (rng.integers(0, 500, n) + 20_000_000).astype(np.uint64)
    neg = rng.integers(-40, -10, n).astype(np.int64)  # int64 key, span 30
    vvalid = rng.random(n) < 0.9
    rel = Relation(
        ["city", "v", "w", "big", "cat", "neg", "epoch"],
        [
            Column.from_strings(cities),
            Column(
                SType.UINT64,
                np.where(vvalid, vals, 0).astype(np.uint64),
                vvalid,
            ),
            Column(SType.UINT64, wide, np.ones(n, bool)),
            Column(SType.UINT64, big, np.ones(n, bool)),
            Column(SType.UINT64, cat, np.ones(n, bool)),
            Column(SType.INT64, neg, np.ones(n, bool)),
            Column(SType.UINT64, epoch, np.ones(n, bool)),
        ],
        n,
    )
    p = RelationTableProvider()
    p.add_table("t", rel)
    return p


FUSED_QUERIES = [
    # (query, expect_fused_route)
    ("select city, count(1), sum(v) from t where v < 500"
     " group by city order by city;", True),
    ("select city, sum(v) from t where v >= 500"
     " group by city order by city;", True),
    ("select city, sum(v), count(1) from t where v = 17"
     " group by city order by city;", True),
    ("select city, sum(v) from t where v != 17"
     " group by city order by city;", True),
    # no WHERE: fused with the always-true predicate
    ("select city, sum(v) from t group by city order by city;", True),
    # flipped operand order
    ("select city, sum(v) from t where 500 > v"
     " group by city order by city;", True),
    # predicate on a column other than the summed one (stream mode)
    ("select city, count(1), sum(v) from t where w < 524288"
     " group by city order by city;", True),
    # u32-narrowed sum column with separate u16 predicate column
    ("select city, sum(w) from t where v < 500"
     " group by city order by city;", True),
    # u32 pred col whose cached max proves payloads < 2^31: eligible
    ("select city, sum(v) from t where w = 12345"
     " group by city order by city;", True),
    # computed predicate: fuses via the in-program mask stream (r5)
    ("select city, sum(v) from t where v + 1 < 500"
     " group by city order by city;", True),
    # pred col with payloads >= 2^31 (no narrowing): the two-slot
    # compare form is ineligible, but the r5 mask stream serves it
    ("select city, sum(v) from t where big < 2000000000"
     " group by city order by city;", True),
    # count-only shapes: no value stream (fused_count)
    ("select city, count(1) from t group by city order by city;", True),
    ("select city, count(1), count(v) from t where v < 500"
     " group by city order by city;", True),
    ("select city from t group by city order by city;", True),
    # numeric narrow-span keys: bucket = key - min via the in-program base
    ("select cat, count(1), sum(v) from t where v < 500"
     " group by cat order by cat;", True),
    ("select cat, sum(v) from t group by cat order by cat;", True),
    ("select cat, count(1) from t group by cat order by cat;", True),
    # WHERE on the key column itself
    ("select cat, count(1) from t where cat < 140"
     " group by cat order by cat;", True),
    # negative-range int64 key
    ("select neg, count(1), sum(v) from t where v >= 500"
     " group by neg order by neg;", True),
    # base-offset u64 key (values ~2e7, span 500): needs the true-min
    # stat + in-program base subtract
    ("select epoch, count(1), sum(v) from t where v < 500"
     " group by epoch order by epoch;", True),
    # numeric key with a wide span (> 64K buckets): not this route
    ("select w, count(1) from t group by w order by w limit 5;", False),
    # AND of two fusable compares: both fold into the program
    ("select city, count(1), sum(v) from t where v >= 100 and v < 700"
     " group by city order by city;", True),
    ("select city, sum(v) from t where v < 700 and w >= 262144"
     " group by city order by city;", True),
    ("select cat, count(1) from t where v < 500 and w < 524288"
     " group by cat order by cat;", True),
    ("select city, count(1) from t where cat >= 120 and cat < 160"
     " group by city order by city;", True),
    # OR of two fusable compares rides pred_combine
    ("select city, sum(v) from t where v < 100 or v >= 900"
     " group by city order by city;", True),
    # AND with one computed side: whole predicate via the mask stream
    ("select city, sum(v) from t where v < 700 and v + w < 500000"
     " group by city order by city;", True),
    # >=3 conjuncts: mask stream (r5)
    ("select city, count(1), sum(v) from t"
     " where v >= 100 and v < 700 and w < 524288"
     " group by city order by city;", True),
    # mixed and/or tree: mask stream (r5)
    ("select city, sum(v) from t where (v < 100 or v >= 900) and w < 524288"
     " group by city order by city;", True),
    # OR on two different columns (stream + stream slots)
    ("select city, sum(v) from t where v < 100 or w >= 262144"
     " group by city order by city;", True),
    # multi-sum: 2 summed columns share one scatter (bounded_multi_sum)
    ("select city, sum(v), sum(w), count(1) from t where v < 700"
     " group by city order by city;", False),
]


@pytest.mark.parametrize("null_keys", [False, True])
@pytest.mark.parametrize("query,expect_fused", FUSED_QUERIES)
def test_fused_groupby_matches_host(query, expect_fused, null_keys):
    from eventql_tpu.exec import device_exec

    prev = os.environ.get("EVENTQL_TPU_DEVICE")
    try:
        os.environ["EVENTQL_TPU_DEVICE"] = "0"
        rt = Runtime()
        host = rt.build_query_plan(
            rt.new_transaction(_make_fused_table(null_keys=null_keys)), query
        ).execute(0)
        os.environ["EVENTQL_TPU_DEVICE"] = "1"
        before = device_exec.FUSED_GROUPBY_COUNT
        dev = rt.build_query_plan(
            rt.new_transaction(_make_fused_table(null_keys=null_keys)), query
        ).execute(0)
        took_fused = device_exec.FUSED_GROUPBY_COUNT > before
    finally:
        if prev is None:
            os.environ.pop("EVENTQL_TPU_DEVICE", None)
        else:
            os.environ["EVENTQL_TPU_DEVICE"] = prev
    assert dev.columns == host.columns
    assert dev.rows == host.rows
    assert took_fused == expect_fused


def test_fused_groupby_env_kill_switch():
    from eventql_tpu.exec import device_exec

    prev = os.environ.get("EVENTQL_TPU_DEVICE")
    try:
        os.environ["EVENTQL_TPU_DEVICE"] = "1"
        os.environ["EVENTQL_TPU_NO_FUSED_GROUPBY"] = "1"
        rt = Runtime()
        before = device_exec.FUSED_GROUPBY_COUNT
        rt.build_query_plan(
            rt.new_transaction(_make_fused_table(500)),
            "select city, sum(v) from t where v < 500"
            " group by city order by city;",
        ).execute(0)
        assert device_exec.FUSED_GROUPBY_COUNT == before
    finally:
        os.environ.pop("EVENTQL_TPU_NO_FUSED_GROUPBY", None)
        if prev is None:
            os.environ.pop("EVENTQL_TPU_DEVICE", None)
        else:
            os.environ["EVENTQL_TPU_DEVICE"] = prev


# -- JOIN ... GROUP BY device route ------------------------------------
def _make_join_tables(n=4000, ndim=64, seed=13, null_fact_keys=False,
                      dup_dim_keys=False):
    rng = np.random.default_rng(seed)
    dim_keys = rng.permutation(np.arange(ndim, dtype=np.uint64) * 13 + 7)
    if dup_dim_keys:
        dim_keys[1] = dim_keys[0]
    buckets = np.array(
        [f"r{i % 7}".encode() for i in range(ndim)], dtype=object
    )
    fact_keys = rng.integers(0, ndim * 2, n).astype(np.uint64) * 13 + 7
    fact_vals = rng.integers(0, 1000, n).astype(np.uint64)
    fvalid = rng.random(n) < 0.9
    kvalid = (
        rng.random(n) < 0.95 if null_fact_keys else np.ones(n, bool)
    )
    facts = Relation(
        ["k", "v"],
        [
            Column(SType.UINT64, fact_keys, kvalid),
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
    p = RelationTableProvider()
    p.add_table("f", rel=facts)
    p.add_table("d", rel=dims)
    return p


JOIN_QUERIES = [
    "select d.region, count(1), sum(f.v) from f join d on f.k = d.k"
    " group by d.region order by d.region;",
    "select d.region, count(f.v) from f join d on f.k = d.k"
    " where f.v < 700 group by d.region order by d.region;",
    "select d.region, sum(f.v + 1) from f join d on f.k = d.k"
    " group by d.region order by 2 desc, d.region;",
    "select d.region, min(f.v), max(f.v), mean(f.v) from f"
    " join d on f.k = d.k group by d.region order by d.region;",
]


def _run_join(query, device: bool, **tbl_kwargs):
    prev = os.environ.get("EVENTQL_TPU_DEVICE")
    os.environ["EVENTQL_TPU_DEVICE"] = "1" if device else "0"
    try:
        p = _make_join_tables(**tbl_kwargs)
        rt = Runtime()
        txn = rt.new_transaction(p)
        return rt.build_query_plan(txn, query).execute(0).rows
    finally:
        if prev is None:
            os.environ.pop("EVENTQL_TPU_DEVICE", None)
        else:
            os.environ["EVENTQL_TPU_DEVICE"] = prev


@pytest.mark.parametrize("query", JOIN_QUERIES)
def test_device_join_groupby_matches_host(query):
    assert _run_join(query, False) == _run_join(query, True)


def test_device_join_route_is_taken():
    from unittest import mock

    from eventql_tpu.exec import device_exec

    called = []
    real = device_exec.try_execute_device_join_groupby

    def spy(node, txn):
        out = real(node, txn)
        called.append(out is not None)
        return out

    with mock.patch.object(
        device_exec, "try_execute_device_join_groupby", spy
    ):
        rows = _run_join(JOIN_QUERIES[0], True)
    assert called and called[0] is True
    assert rows  # non-empty join result


def test_device_join_falls_back_on_null_or_dup_keys():
    """NULL fact keys join by tag in the host engine; duplicate dim
    keys fan out — both shapes must take the host path and still agree
    (i.e. the device run returns host-exact rows via fallback)."""
    q = JOIN_QUERIES[0]
    for kwargs in ({"null_fact_keys": True}, {"dup_dim_keys": True}):
        assert _run_join(q, False, **kwargs) == _run_join(q, True, **kwargs)


def test_device_join_count_distinct_matches_host():
    q = ("select d.region, count_distinct(f.v) from f join d on"
         " f.k = d.k group by d.region order by d.region;")
    assert _run_join(q, False) == _run_join(q, True)


def _make_narrowing_table(n=4000, seed=23):
    """Columns exercising physical narrowing (device_exec._narrow_np):
    small u64 (narrows to u32), small-range int64 (narrows to i32),
    huge u64 (stays 64-bit), boundary values around 2^32 / int32 max."""
    rng = np.random.default_rng(seed)
    small_u = rng.integers(0, 1 << 20, n).astype(np.uint64)
    small_i = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64)
    big_u = rng.integers(1 << 40, 1 << 52, n).astype(np.uint64)
    edge = np.full(n, (1 << 32) - 1, dtype=np.uint64)
    edge[: n // 2] = 7
    # 16-bit narrowing cases: tiny u64 (-> u16), tiny int64 (-> i16),
    # boundary values around 2^16 / int16 extremes
    tiny_u = rng.integers(0, 1 << 12, n).astype(np.uint64)
    tiny_i = rng.integers(-(1 << 14), 1 << 14, n).astype(np.int64)
    edge16 = np.full(n, (1 << 16) - 1, dtype=np.uint64)
    edge16[: n // 2] = 3
    keys = rng.integers(0, 23, n).astype(np.uint64)
    rel = Relation(
        ["k", "su", "si", "bu", "e", "tu", "ti", "e16"],
        [
            Column(SType.UINT64, keys, np.ones(n, bool)),
            Column(SType.UINT64, small_u, np.ones(n, bool)),
            Column(SType.INT64, small_i, np.ones(n, bool)),
            Column(SType.UINT64, big_u, np.ones(n, bool)),
            Column(SType.UINT64, edge, np.ones(n, bool)),
            Column(SType.UINT64, tiny_u, np.ones(n, bool)),
            Column(SType.INT64, tiny_i, np.ones(n, bool)),
            Column(SType.UINT64, edge16, np.ones(n, bool)),
        ],
        n,
    )
    p = RelationTableProvider()
    p.add_table("t", rel)
    return p


NARROWING_QUERIES = [
    "select k, sum(su), min(si), max(si) from t group by k order by k;",
    "select k, sum(bu), count(1) from t where su < 500000 group by k order by k;",
    "select k, max(e), sum(e) from t where si > 0 group by k order by k;",
    "select k, sum(su + si) from t group by k order by k;",
    "select k, sum(tu), min(ti), max(ti) from t group by k order by k;",
    "select k, max(e16), sum(e16 + tu) from t where ti > 0 group by k order by k;",
    "select k, sum(tu + si), count(1) from t where tu < 2048 group by k order by k;",
]


@pytest.mark.parametrize("query", NARROWING_QUERIES)
def test_narrowed_columns_match_host(query):
    provider = _make_narrowing_table()
    prev = os.environ.get("EVENTQL_TPU_DEVICE")
    try:
        os.environ["EVENTQL_TPU_DEVICE"] = "0"
        rt = Runtime()
        host = rt.build_query_plan(
            rt.new_transaction(provider), query
        ).execute(0)
        os.environ["EVENTQL_TPU_DEVICE"] = "1"
        rt = Runtime()
        dev = rt.build_query_plan(
            rt.new_transaction(provider), query
        ).execute(0)
    finally:
        if prev is None:
            os.environ.pop("EVENTQL_TPU_DEVICE", None)
        else:
            os.environ["EVENTQL_TPU_DEVICE"] = prev
    assert dev.columns == host.columns
    assert dev.rows == host.rows


def test_narrowing_decisions():
    from eventql_tpu.exec.device_exec import _narrow_np

    n = 100
    small_u = Column(
        SType.UINT64, np.arange(n, dtype=np.uint64), np.ones(n, bool)
    )
    assert _narrow_np(small_u).dtype == np.uint16
    # cached second call returns the same array
    assert _narrow_np(small_u) is _narrow_np(small_u)

    mid_u = Column(
        SType.UINT64,
        np.full(n, 1 << 20, dtype=np.uint64),
        np.ones(n, bool),
    )
    assert _narrow_np(mid_u).dtype == np.uint32
    mid_i = Column(
        SType.INT64,
        np.full(n, -(1 << 20), dtype=np.int64),
        np.ones(n, bool),
    )
    assert _narrow_np(mid_i).dtype == np.int32
    tiny_i = Column(
        SType.INT64, np.arange(-50, 50, dtype=np.int64), np.ones(100, bool)
    )
    assert _narrow_np(tiny_i).dtype == np.int16
    edge16 = Column(
        SType.UINT64,
        np.full(n, (1 << 16) - 1, dtype=np.uint64),
        np.ones(n, bool),
    )
    assert _narrow_np(edge16).dtype == np.uint16

    big_u = Column(
        SType.UINT64,
        np.full(n, 1 << 32, dtype=np.uint64),
        np.ones(n, bool),
    )
    assert _narrow_np(big_u).dtype == np.uint64

    edge_u = Column(
        SType.UINT64,
        np.full(n, (1 << 32) - 1, dtype=np.uint64),
        np.ones(n, bool),
    )
    assert _narrow_np(edge_u).dtype == np.uint32

    small_i = Column(
        SType.INT64,
        np.array([-(1 << 31)] * n, dtype=np.int64),
        np.ones(n, bool),
    )
    assert _narrow_np(small_i).dtype == np.int32

    wide_i = Column(
        SType.INT64,
        np.array([-(1 << 31) - 1] * n, dtype=np.int64),
        np.ones(n, bool),
    )
    assert _narrow_np(wide_i).dtype == np.int64

    # STRING dictionary ids: small dictionary -> int16 stream
    s_small = Column.from_strings([b"a", b"b", b"c", b"a"] * 25)
    assert s_small.data.dtype == np.int32
    assert _narrow_np(s_small).dtype == np.int16
    # ids at/above 2^15 keep the int32 stream
    s_big = Column(
        SType.STRING,
        np.full(n, 1 << 15, dtype=np.int32),
        np.ones(n, bool),
        np.array([b"x"] * ((1 << 15) + 1), dtype=object),
    )
    assert _narrow_np(s_big).dtype == np.int32


def _make_string_narrowing_table(n=3000, seed=7):
    rng = np.random.default_rng(seed)
    cities = [b"ams", b"ber", b"nyc", b"par", b"sfo", b"tok"]
    ids = rng.integers(0, len(cities), n)
    valid = rng.random(n) > 0.05
    strs = [cities[i] if ok else None for i, ok in zip(ids, valid)]
    v = rng.integers(0, 1 << 10, n).astype(np.uint64)
    rel = Relation(
        ["city", "v"],
        [
            Column.from_strings(strs),
            Column(SType.UINT64, v, np.ones(n, bool)),
        ],
        n,
    )
    p = RelationTableProvider()
    p.add_table("t", rel)
    return p


@pytest.mark.parametrize(
    "query",
    [
        # pallas string-groupby route over int16-narrowed dictionary ids
        "select city, sum(v), count(1) from t group by city"
        " order by city;",
        # device order route: string sort key rides narrowed ids
        "select city, v from t where v < 600 order by city, v limit 40;",
        # string-column equality filter (ids compared post-widen)
        "select count(1) from t where city = city;",
    ],
)
def test_string_dict_id_narrowing_matches_host(query):
    provider = _make_string_narrowing_table()
    prev = os.environ.get("EVENTQL_TPU_DEVICE")
    try:
        os.environ["EVENTQL_TPU_DEVICE"] = "0"
        rt = Runtime()
        host = rt.build_query_plan(
            rt.new_transaction(provider), query
        ).execute(0)
        os.environ["EVENTQL_TPU_DEVICE"] = "1"
        rt = Runtime()
        dev = rt.build_query_plan(
            rt.new_transaction(provider), query
        ).execute(0)
    finally:
        if prev is None:
            os.environ.pop("EVENTQL_TPU_DEVICE", None)
        else:
            os.environ["EVENTQL_TPU_DEVICE"] = prev
    assert dev.columns == host.columns
    assert dev.rows == host.rows


def _run_join_merge(query, **tbl_kwargs):
    """Run the device JOIN ... GROUP BY route (large dim tables take the
    same binary-search probe as small ones)."""
    return _run_join(query, True, **tbl_kwargs)


@pytest.mark.parametrize("query", JOIN_QUERIES)
def test_merge_join_route_matches_host(query):
    assert _run_join(query, False) == _run_join_merge(query)


@pytest.mark.parametrize("query", JOIN_QUERIES)
def test_merge_join_route_matches_host_wide_dims(query):
    """A wider dim table."""
    host = _run_join(query, False, n=6000, ndim=1500, seed=29)
    dev = _run_join_merge(query, n=6000, ndim=1500, seed=29)
    assert host == dev


def test_merge_join_route_big_dims_route_taken():
    """A dim table of 8704 rows: the device route must still engage (no
    fallback to host) and agree with the host result."""
    from unittest import mock

    from eventql_tpu.exec import device_exec

    ndim = 8192 + 512
    q = JOIN_QUERIES[0]
    host = _run_join(q, False, n=4000, ndim=ndim, seed=31)

    called = []
    real = device_exec.try_execute_device_join_groupby

    def spy(node, txn):
        out = real(node, txn)
        called.append(out is not None)
        return out

    with mock.patch.object(
        device_exec, "try_execute_device_join_groupby", spy
    ):
        dev = _run_join_merge(q, n=4000, ndim=ndim, seed=31)
    assert called and called[0]
    assert host == dev


def test_multi_sum_route_is_taken():
    """2+ summed narrowed columns must take the multi-stream scatter
    (bounded_multi_sum)."""
    from eventql_tpu.exec import device_exec

    q = ("select city, sum(v), sum(w), count(1) from t where v < 700"
         " group by city order by city;")
    prev = os.environ.get("EVENTQL_TPU_DEVICE")
    try:
        os.environ["EVENTQL_TPU_DEVICE"] = "0"
        rt = Runtime()
        host = rt.build_query_plan(
            rt.new_transaction(_make_fused_table()), q
        ).execute(0)
        os.environ["EVENTQL_TPU_DEVICE"] = "1"
        before = device_exec.MULTI_SUM_GROUPBY_COUNT
        dev = rt.build_query_plan(
            rt.new_transaction(_make_fused_table()), q
        ).execute(0)
        assert device_exec.MULTI_SUM_GROUPBY_COUNT == before + 1
    finally:
        if prev is None:
            os.environ.pop("EVENTQL_TPU_DEVICE", None)
        else:
            os.environ["EVENTQL_TPU_DEVICE"] = prev
    assert dev.rows == host.rows
