"""Query cache tests (reference: sql/runtime/query_cache + cached
partial aggregates, groupby.cc:255-432)."""

from tests.conftest import reference_path

from eventql_tpu.columnar.providers import CSTableScanProvider
from eventql_tpu.exec.query_cache import QueryCache
from eventql_tpu.exec.runtime import Runtime

TESTTBL_CST = reference_path("test", "sql_testdata", "testtbl.cst")
QUERY = "select count(1) cnt, time from testtable group by TRUNCATE(time / 60000000) order by cnt desc;"


def test_cache_hit_produces_same_result(tmp_path, reference_dir):
    cache = QueryCache(str(tmp_path / "qcache"))
    rt = Runtime()

    txn = rt.new_transaction(
        CSTableScanProvider("testtable", TESTTBL_CST), query_cache=cache
    )
    cold = rt.build_query_plan(txn, QUERY).execute(0)

    import os

    entries = os.listdir(str(tmp_path / "qcache"))
    assert len(entries) == 1

    txn2 = rt.new_transaction(
        CSTableScanProvider("testtable", TESTTBL_CST), query_cache=cache
    )
    warm = rt.build_query_plan(txn2, QUERY).execute(0)
    assert warm.columns == cold.columns
    assert warm.rows == cold.rows


def test_cache_keyed_by_query(tmp_path, reference_dir):
    cache = QueryCache(str(tmp_path / "qcache"))
    rt = Runtime()
    txn = rt.new_transaction(
        CSTableScanProvider("testtable", TESTTBL_CST), query_cache=cache
    )
    r1 = rt.build_query_plan(txn, "select count(1) from testtable;").execute(0)
    r2 = rt.build_query_plan(
        txn, "select count(1) from testtable group by time;"
    ).execute(0)
    assert r1.rows != r2.rows

    import os

    assert len(os.listdir(str(tmp_path / "qcache"))) == 2


def test_volatile_tables_not_cached(tmp_path):
    from eventql_tpu.db.table_service import TableService

    cache = QueryCache(str(tmp_path / "qcache"))
    rt = Runtime()
    svc = TableService()
    txn = rt.new_transaction(svc, query_cache=cache)
    rt.build_query_plan(
        txn, "CREATE TABLE t (a uint64, PRIMARY KEY (a));"
    ).execute(0)
    rt.build_query_plan(txn, "INSERT INTO t (a) VALUES (1);").execute(0)
    r = rt.build_query_plan(txn, "select count(1) from t;").execute(0)
    assert r.rows == [["1"]]

    import os

    assert os.listdir(str(tmp_path / "qcache")) == []

    # mutation must be visible (no stale cache)
    rt.build_query_plan(txn, "INSERT INTO t (a) VALUES (2);").execute(0)
    r = rt.build_query_plan(txn, "select count(1) from t;").execute(0)
    assert r.rows == [["2"]]
