"""Nested/repeated-column scan parity (Dremel row assembly + WITHIN
RECORD). Expected values from reference Runtime_test.cc (cited)."""

import pytest

from tests.conftest import reference_path

from eventql_tpu.columnar.providers import CSTableScanProvider
from eventql_tpu.exec.runtime import Runtime

TESTTBL_CST = reference_path("test", "sql_testdata", "testtbl.cst")


def run(query):
    rt = Runtime()
    txn = rt.new_transaction(CSTableScanProvider("testtable", TESTTBL_CST))
    return rt.build_query_plan(txn, query).execute(0)


# Runtime_test.cc:193-210 (TestNestedCSTableAggregate)
def test_count_repeated_column(reference_dir):
    r = run("select count(event.search_query.time) from testtable;")
    assert r.num_rows == 1
    assert r.get_row(0)[0] == "704"


# Runtime_test.cc:211-243 (TestWithinRecordCSTableAggregate)
def test_sum_repeated_column(reference_dir):
    r = run("select sum(event.search_query.num_result_items) from testtable;")
    assert r.get_row(0)[0] == "24793"


def test_sum_count_within_record(reference_dir):
    r = run(
        "select sum(count(event.search_query.result_items.position)"
        " WITHIN RECORD) from testtable;"
    )
    assert r.get_row(0)[0] == "24793"


def test_within_record_rows(reference_dir):
    r = run(
        """
        select
          sum(event.search_query.num_result_items) WITHIN RECORD,
          count(event.search_query.result_items.position) WITHIN RECORD
        from testtable;"""
    )
    assert r.num_columns == 2
    assert r.num_rows == 213
    s = 0
    for i in range(r.num_rows):
        r1 = r.get_row(i)[0]
        r2 = r.get_row(i)[1]
        if r1 == "NULL":
            r1 = "0"
        if r2 == "NULL":
            r2 = "0"
        assert r1 == r2
        s += int(r1)
    assert s == 24793


# Runtime_test.cc:270-292 (deep repeated column row expansion)
def test_deep_nested_row_expansion(reference_dir):
    r = run("select event.search_query.result_items.position from testtable;")
    assert r.num_rows == 24866


def test_multi_level_aggregate(reference_dir):
    r = run(
        """
        select
          count(time),
          sum(count(event.search_query.time) WITHIN RECORD),
          sum(sum(event.search_query.num_result_items) WITHIN RECORD),
          sum(count(event.search_query.result_items.position) WITHIN RECORD)
        from testtable;"""
    )
    assert r.num_columns == 4
    assert r.columns[0] == "count(time)"
    assert r.columns[1] == "sum(count(event.search_query.time) WITHIN RECORD)"
    assert (
        r.columns[2]
        == "sum(sum(event.search_query.num_result_items) WITHIN RECORD)"
    )
    assert (
        r.columns[3]
        == "sum(count(event.search_query.result_items.position) WITHIN RECORD)"
    )
    assert r.num_rows == 1
    assert r.get_row(0)[0] == "213"
    assert r.get_row(0)[1] == "704"
    assert r.get_row(0)[2] == "24793"
    assert r.get_row(0)[3] == "24793"


# Runtime_test.cc:320-347 — same plus a summed combination
def test_multi_level_aggregate_combined(reference_dir):
    r = run(
        """
        select
          count(time),
          sum(count(event.search_query.time) WITHIN RECORD),
          sum(sum(event.search_query.num_result_items) WITHIN RECORD),
          sum(count(event.search_query.result_items.position) WITHIN RECORD),
          (
            count(time) +
            sum(count(event.search_query.time) WITHIN RECORD) +
            sum(sum(event.search_query.num_result_items) WITHIN RECORD) +
            sum(count(event.search_query.result_items.position) WITHIN RECORD)
          )
        from testtable;"""
    )
    assert r.num_rows == 1
    assert r.get_row(0)[0] == "213"
    assert r.get_row(0)[1] == "704"
    assert r.get_row(0)[2] == "24793"
    assert r.get_row(0)[3] == "24793"
    assert r.get_row(0)[4] == "50503"


# Runtime_test.cc:349-378 (TestMultiLevelNestedCSTableAggrgateWithGroup)
def test_nested_subquery_filter_aggregate(reference_dir):
    r = run(
        """
        select
          count(1) as num_items,
          sum(if(s.c, 1, 0)) as clicks
        from (
            select
                event.search_query.result_items.position as p,
                event.search_query.result_items.clicked as c
            from testtable) as s
            where s.p = 6;
        """
    )
    assert r.num_columns == 2
    assert r.num_rows == 1
    assert r.get_row(0)[0] == "688"
    assert r.get_row(0)[1] == "2"


# Runtime_test.cc:645-664 (TestWildcardSelect, row expansion count)
def test_wildcard_row_expansion(reference_dir):
    r = run("select * from testtable;")
    assert r.num_columns == 63
    assert r.columns[0] == "attr.ab_test_group"
    assert r.columns[62] == "user_id"
    assert r.num_rows == 24883


# Runtime_test.cc:666-685 (TestWildcardSelectWithOrderLimit)
def test_wildcard_order_limit(reference_dir):
    r = run("select * from testtable order by time desc limit 10;")
    assert r.num_columns == 63
    assert r.num_rows == 10


def test_deep_within_record_aggregation(reference_dir):
    """AGGREGATE_WITHIN_RECORD_DEEP emits one aggregated row per
    repeated-value step instead of one per record (reference:
    CSTableScan.cc:455-486; unreachable from SQL — the planner only
    sets FLAT at queryplanbuilder.cc:1388 — but part of the scan ABI)."""
    from eventql_tpu.columnar.nested_scan import execute_nested_scan
    from eventql_tpu.plan import nodes as qn

    rt = Runtime()
    provider = CSTableScanProvider("testtable", TESTTBL_CST)
    txn = rt.new_transaction(provider)
    plan = rt.build_query_plan(
        txn,
        "select sum(event.search_query.num_result_items) WITHIN RECORD"
        " from testtable;",
    )
    # dig the scan node out of the built plan and flip its strategy
    scan = plan.nodes[0]
    while not isinstance(scan, qn.SequentialScanNode):
        scan = (
            getattr(scan, "input_table", None)
            or getattr(scan, "table", None)
            or scan.children()[0]
        )
    assert scan.aggr_strategy == qn.SequentialScanNode.AGGREGATE_WITHIN_RECORD_FLAT
    scan.aggr_strategy = qn.SequentialScanNode.AGGREGATE_WITHIN_RECORD_DEEP

    reader = provider.get_reader("testtable")
    rel = execute_nested_scan(scan, reader)
    # one row per fetch step: 704 search_query instances + 69 records
    # with no events (cf. Runtime_test.cc:193-210's "704 of 773"), and
    # the same grand total the FLAT/global aggregations produce
    assert rel.num_rows == 773
    total = 0
    for i in range(rel.num_rows):
        v = rel.columns[0].value_at(i)
        if not v.is_null:
            total += int(v.payload())
    assert total == 24793
