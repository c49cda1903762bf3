"""Query-level parity tests over the reference's test fixtures
(reference: sql/runtime/Runtime_test.cc — cited per test; fixture data
from test/sql_testdata/). Cases that require nested-record scans are in
test_nested.py (deferred feature)."""

import pytest

from tests.conftest import reference_path

from eventql_tpu.columnar.providers import (
    CompositeTableProvider,
    CSTableScanProvider,
    CSVTableProvider,
)
from eventql_tpu.exec.runtime import Runtime

TESTTBL_CST = reference_path("test", "sql_testdata", "testtbl.cst")
TESTTBL1_CSV = reference_path("test", "sql_testdata", "testtbl1.csv")
TESTTBL2_CSV = reference_path("test", "sql_testdata", "testtbl2.csv")


def run(query, provider):
    rt = Runtime()
    txn = rt.new_transaction(provider)
    plan = rt.build_query_plan(txn, query)
    return plan.execute(0)


def cst_provider():
    return CSTableScanProvider("testtable", TESTTBL_CST)


def csv1_provider(name="testtable"):
    return CSVTableProvider(name, TESTTBL1_CSV, column_separator=b"\t")


def customers_provider():
    return CSVTableProvider("customers", TESTTBL2_CSV)


# Runtime_test.cc:146-174 (TestColumnReferenceWithTableNamePrefix)
def test_column_reference_with_prefix(reference_dir):
    r = run("select testtable.time from testtable;", cst_provider())
    assert r.num_columns == 1
    assert r.num_rows == 213


# Runtime_test.cc:175-192 (TestSimpleCSTableAggregate)
def test_simple_cstable_aggregate(reference_dir):
    r = run("select count(1) from testtable;", cst_provider())
    assert r.get_row(0) == ["213"]


# Runtime_test.cc:1431-1457 (TestSimpleSelect)
def test_simple_select_order(reference_dir):
    r = run(
        "SELECT customername FROM customers ORDER BY customername;",
        customers_provider(),
    )
    assert r.num_rows == 91
    assert r.get_row(0)[0] == "Alfreds Futterkiste"
    assert r.get_row(90)[0] == "Wolski"


# Runtime_test.cc:1459-1472 (TestSimpleTablelessSelect)
def test_tableless_select():
    r = run("select 123 as a, 435 as b;", CompositeTableProvider())
    assert r.columns == ["a", "b"]
    assert r.get_row(0) == ["123", "435"]


# Runtime_test.cc:1474-1487 (TestSimpleSubSelect)
def test_simple_subselect():
    r = run(
        "select t1.b, a from (select 123 as a, 435 as b) as t1",
        CompositeTableProvider(),
    )
    assert r.num_columns == 2
    assert r.get_row(0) == ["435", "123"]


# Runtime_test.cc:1489-1502 (TestWildcardOnSubselect)
def test_wildcard_on_subselect():
    r = run(
        "select * from (select 123 as a, 435 as b) as t1", CompositeTableProvider()
    )
    assert r.get_row(0) == ["123", "435"]


# Runtime_test.cc:1504-1523 (TestSubqueryInGroupBy)
def test_subquery_in_group_by(reference_dir):
    r = run(
        "select count(1), t1.fubar + t1.x from (select count(1) as x, 123 as"
        " fubar from testtable group by TRUNCATE(time / 2000000)) t1 GROUP BY"
        " t1.x;",
        cst_provider(),
    )
    assert r.num_columns == 2
    assert r.num_rows == 2
    rows = sorted(r.rows, key=lambda x: int(x[0]))
    assert rows[0] == ["1", "125"]
    assert rows[1] == ["211", "124"]


# Runtime_test.cc:1525-1540 (TestInternalOrderByWithSubquery)
def test_internal_order_by_with_subquery(reference_dir):
    r = run(
        "select t1.x from (select count(1) as x from testtable group by"
        " TRUNCATE(time / 2000000)) t1  order by t1.x DESC LIMIT 2;",
        cst_provider(),
    )
    assert r.num_columns == 1
    assert r.num_rows == 2


# Runtime_test.cc:1542-1562 (TestWildcardWithGroupBy)
def test_wildcard_with_group_by(reference_dir):
    r = run("select * from testtable group by time;", csv1_provider())
    assert r.columns == ["time", "value", "segment1", "segment2"]
    assert r.num_rows == 4


# Runtime_test.cc:687-750 (TestWildcardSelectWithSubqueries, CSV part)
def test_wildcard_select_with_subqueries(reference_dir):
    p = csv1_provider()
    r = run("select value, time from testtable;", p)
    assert r.columns == ["value", "time"]
    assert r.num_rows == 19

    r = run("select * from (select value, time from testtable);", p)
    assert r.columns == ["value", "time"]
    assert r.num_rows == 19

    r = run(
        "select * from (select * from (select value, time from testtable));", p
    )
    assert r.columns == ["value", "time"]
    assert r.num_rows == 19

    r = run("select * from (select * from (select * from testtable));", p)
    assert r.columns == ["time", "value", "segment1", "segment2"]
    assert r.num_rows == 19


# Runtime_test.cc:752-771 (TestSelectWithInternalAggrGroupColumns)
def test_internal_aggr_group_columns(reference_dir):
    r = run(
        "select count(1) cnt, time from testtable group by"
        " TRUNCATE(time / 60000000) order by cnt desc;",
        cst_provider(),
    )
    assert r.num_columns == 2
    assert r.num_rows == 129
    # two groups tie at count 6 (reference expectation picks one by
    # stale last-row-wins semantics; we assert the invariant parts)
    assert r.get_row(0)[0] == "6"
    assert r.get_row(1)[0] == "6"
    assert r.get_row(2)[0] == "5"


# Runtime_test.cc:773-791 (TestSelectWithInternalGroupColumns)
def test_internal_group_columns(reference_dir):
    r = run(
        "select time from testtable group by TRUNCATE(time / 60000000);",
        cst_provider(),
    )
    assert r.num_columns == 1
    assert r.num_rows == 129


# Runtime_test.cc:792-810 (TestSelectWithInternalOrderColumns)
def test_internal_order_columns(reference_dir):
    r = run(
        "select user_id from testtable order by time desc limit 10;",
        cst_provider(),
    )
    assert r.num_columns == 1
    assert r.num_rows == 10


# Runtime_test.cc:1564-1678 (TestInnerJoin)
def test_inner_join_cartesian(reference_dir):
    q = """
        SELECT
          t1.time, t2.time, t3.time, t1.x, t2.x, t1.x + t2.x, t1.x * 3 = t3.x, x1, x2, x3
        FROM
          (select TRUNCATE(time / 1000000) as time, count(1) as x, 123 as x1 from testtable group by TRUNCATE(time / 1200000000)) t1,
          (select TRUNCATE(time / 1000000) as time, sum(2) as x, 456 as x2 from testtable group by TRUNCATE(time / 1200000000)) AS t2,
          (select TRUNCATE(time / 1000000) as time, sum(3) as x, 789 as x3 from testtable group by TRUNCATE(time / 1200000000)) AS t3
        ORDER BY
          t1.time desc;
    """
    r = run(q, cst_provider())
    assert r.num_columns == 10
    assert r.num_rows == 12 * 12 * 12


# The reference test file's row values (Runtime_test.cc:1612-1633) date
# from a last-row-wins GroupBy; the shipped engine freezes the FIRST row
# of each group (groupby.cc:161-172, proven by golden test 00014), so
# these are the first-row-wins values for the same buckets/counts.
JOIN_EXPECT_FIRST = [
    "1438055327", "1438055327", "1438055327", "48", "96", "144",
    "true", "123", "456", "789",
]
JOIN_EXPECT_LAST = [
    "1438042484", "1438042484", "1438042484", "17", "34", "51",
    "true", "123", "456", "789",
]


def test_inner_join_on(reference_dir):
    q = """
        SELECT
          t1.time, t2.time, t3.time, t1.x, t2.x, t1.x + t2.x, t1.x * 3 = t3.x, x1, x2, x3
        FROM
          (select TRUNCATE(time / 1000000) as time, count(1) as x, 123 as x1 from testtable group by TRUNCATE(time / 1200000000)) t1
        JOIN
          (select TRUNCATE(time / 1000000) as time, sum(2) as x, 456 as x2 from testtable group by TRUNCATE(time / 1200000000)) AS t2
        JOIN
          (select TRUNCATE(time / 1000000) as time, sum(3) as x, 789 as x3 from testtable group by TRUNCATE(time / 1200000000)) AS t3
        ON
          t2.time = t1.time and t3.time = t2.time
        ORDER BY
          t1.time desc;
    """
    r = run(q, cst_provider())
    assert r.num_columns == 10
    assert r.num_rows == 12
    assert r.get_row(0) == JOIN_EXPECT_FIRST
    assert r.get_row(11) == JOIN_EXPECT_LAST


def test_inner_join_where(reference_dir):
    q = """
        SELECT
          t1.time, t2.time, t3.time, t1.x, t2.x, t1.x + t2.x, t1.x * 3 = t3.x, x1, x2, x3
        FROM
          (select TRUNCATE(time / 1000000) as time, count(1) as x, 123 as x1 from testtable group by TRUNCATE(time / 1200000000)) t1
        JOIN
          (select TRUNCATE(time / 1000000) as time, sum(2) as x, 456 as x2 from testtable group by TRUNCATE(time / 1200000000)) AS t2
        JOIN
          (select TRUNCATE(time / 1000000) as time, sum(3) as x, 789 as x3 from testtable group by TRUNCATE(time / 1200000000)) AS t3
        WHERE
          t2.time = t1.time AND t1.time = t3.time
        ORDER BY
          t1.time desc;
    """
    r = run(q, cst_provider())
    assert r.num_columns == 10
    assert r.num_rows == 12
    assert r.get_row(0) == JOIN_EXPECT_FIRST
    assert r.get_row(11) == JOIN_EXPECT_LAST


# Runtime_test.cc:2314-2336 (TestSumMinMaxCount)
def test_sum_min_max_count(reference_dir):
    r = run(
        "select sum(value), count(value), min(value), max(value) FROM testtable;",
        csv1_provider(),
    )
    assert r.num_columns == 4
    assert r.num_rows == 1
    assert r.get_row(0) == ["11409.000000", "19", "123.000000", "999.000000"]


# Runtime_test.cc:2120-2152 (TestShowTables) — structural check
def test_show_tables(reference_dir):
    r = run("show tables;", cst_provider())
    assert r.columns == ["table_name", "description"]
    assert r.get_row(0)[0] == "testtable"


def test_describe_table(reference_dir):
    r = run("describe testtable;", csv1_provider())
    assert r.columns == ["column_name", "type", "nullable", "description"]
    assert r.num_rows == 4
    assert r.get_row(0)[0] == "time"
    assert r.get_row(0)[1] == "string"


# -- natural / right / wildcard joins (Runtime_test.cc TestNaturalJoin,
# TestRightJoin, TestWildcardJoins; fixtures testtbl3-7.csv) -----------


def _dept_provider():
    return CompositeTableProvider(
        [
            CSVTableProvider(
                "departments",
                reference_path("test", "sql_testdata", "testtbl5.csv"),
                column_separator=b"\t",
            ),
            CSVTableProvider(
                "users",
                reference_path("test", "sql_testdata", "testtbl6.csv"),
                column_separator=b"\t",
            ),
            CSVTableProvider(
                "openinghours",
                reference_path("test", "sql_testdata", "testtbl7.csv"),
                column_separator=b"\t",
            ),
        ]
    )


def _orders_provider():
    return CompositeTableProvider(
        [
            CSVTableProvider(
                "employees",
                reference_path("test", "sql_testdata", "testtbl4.csv"),
                column_separator=b"\t",
            ),
            CSVTableProvider(
                "orders",
                reference_path("test", "sql_testdata", "testtbl3.csv"),
                column_separator=b"\t",
            ),
        ]
    )


def test_natural_join(reference_dir):
    r = run(
        "SELECT * FROM departments NATURAL JOIN users ORDER BY name;",
        _dept_provider(),
    )
    assert r.columns == ["deptid", "name", "username"]
    assert r.rows == [
        ["1", "eng", "laura"],
        ["1", "eng", "paul"],
        ["2", "sales", "hans"],
    ]


def test_natural_join_three_tables(reference_dir):
    r = run(
        "SELECT * FROM departments NATURAL JOIN openinghours"
        " NATURAL JOIN users ORDER BY name;",
        _dept_provider(),
    )
    assert r.columns == [
        "deptid",
        "name",
        "start_time",
        "end_time",
        "username",
    ]
    assert r.rows == [
        ["1", "eng", "13:00", "22:00", "laura"],
        ["1", "eng", "13:00", "22:00", "paul"],
        ["2", "sales", "10:00", "19:00", "hans"],
    ]


def test_natural_join_subqueries(reference_dir):
    # Runtime_test.cc:2084-2121 (TestNaturalJoin, aliased subquery case)
    r = run(
        "SELECT * FROM (SELECT * FROM departments) t1"
        " NATURAL JOIN (SELECT deptid, start_time, end_time"
        " FROM openinghours) t2"
        " NATURAL JOIN (SELECT * FROM users) t3 ORDER BY name;",
        _dept_provider(),
    )
    assert r.columns == [
        "deptid",
        "name",
        "start_time",
        "end_time",
        "username",
    ]
    assert r.rows == [
        ["1", "eng", "13:00", "22:00", "laura"],
        ["1", "eng", "13:00", "22:00", "paul"],
        ["2", "sales", "10:00", "19:00", "hans"],
    ]


def test_cross_join_limit_cursor(reference_dir):
    # Runtime_test.cc:2200-2233 (TestResultCursor): ON-less JOIN is a
    # cross join; the cursor pulls exactly LIMIT rows
    r = run(
        "SELECT * FROM departments JOIN users ORDER BY name LIMIT 5;",
        _dept_provider(),
    )
    assert r.num_rows == 5


def test_right_join(reference_dir):
    r = run(
        "SELECT orders.orderid, employees.firstname FROM orders"
        " RIGHT JOIN employees ON orders.employeeid=employees.employeeid"
        " ORDER BY orders.orderid;",
        _orders_provider(),
    )
    assert r.num_columns == 2
    assert r.num_rows == 197
    assert r.get_row(0) == ["10248", "Steven"]
    assert r.get_row(1) == ["10249", "Michael"]
    assert r.get_row(195) == ["10443", "Laura"]
    assert r.get_row(196) == ["NULL", "Adam"]


def test_right_join_with_where(reference_dir):
    r = run(
        "SELECT orders.orderid, employees.firstname FROM orders"
        " RIGHT JOIN employees ON orders.employeeid=employees.employeeid"
        " WHERE employees.firstname = 'Steven'"
        " ORDER BY orders.orderid;",
        _orders_provider(),
    )
    assert r.num_rows == 11
    assert r.get_row(0) == ["10248", "Steven"]
    assert r.get_row(1) == ["10254", "Steven"]
    assert r.get_row(10) == ["10397", "Steven"]


def test_wildcard_join_on(reference_dir):
    r = run(
        "SELECT * FROM departments JOIN users"
        " ON users.deptid = departments.deptid ORDER BY name;",
        _dept_provider(),
    )
    assert r.num_columns == 4
    assert r.columns[:2] == ["name", "deptid"]
    assert r.num_rows == 3


def test_wildcard_cross_join_where(reference_dir):
    r = run(
        "SELECT * FROM departments, users, openinghours"
        " WHERE users.deptid = departments.deptid"
        " AND openinghours.deptid = departments.deptid ORDER BY name;",
        _dept_provider(),
    )
    assert r.num_columns == 7
    assert r.columns[:3] == ["name", "deptid", "username"]
    assert r.num_rows == 3


def test_wildcard_join_subselect(reference_dir):
    r = run(
        "SELECT * FROM ("
        " SELECT * FROM departments, users, openinghours"
        " WHERE users.deptid = departments.deptid"
        " AND openinghours.deptid = departments.deptid"
        ") ORDER BY name;",
        _dept_provider(),
    )
    assert r.num_columns == 7
    assert r.num_rows == 3


def test_operator_trace(monkeypatch, reference_dir):
    """Per-operator timing trace (this engine's addition; SURVEY §5 notes
    the reference has no tracer). Pinned to the host path: the device
    top-k route legitimately fuses OrderBy+Limit into one traced op."""
    from eventql_tpu.exec.runtime import Runtime

    monkeypatch.setenv("EVENTQL_TPU_DEVICE", "0")
    rt = Runtime()
    txn = rt.new_transaction(csv1_provider())
    txn.trace = []
    plan = rt.build_query_plan(
        txn,
        "select time, value from testtable order by time limit 3;",
    )
    r = plan.execute(0)
    assert r.num_rows == 3
    ops = [t[0] for t in txn.trace]
    assert "LimitNode" in ops
    assert "OrderByNode" in ops
    assert "SequentialScanNode" in ops
    report = txn.trace_report()
    assert "ms" in report and "rows" in report


def _customers_orders_provider():
    return CompositeTableProvider(
        [
            CSVTableProvider(
                "customers",
                reference_path("test", "sql_testdata", "testtbl2.csv"),
            ),
            CSVTableProvider(
                "orders",
                reference_path("test", "sql_testdata", "testtbl3.csv"),
                column_separator=b"\t",
            ),
        ]
    )


def test_left_join(reference_dir):
    # reference: Runtime_test.cc:1679-1741 (TestLeftJoin)
    r = run(
        "SELECT customers.customername, orders.orderid"
        " FROM customers LEFT JOIN orders"
        " ON customers.customerid=orders.customerid"
        " ORDER BY customers.customername;",
        _customers_orders_provider(),
    )
    assert r.num_columns == 2
    assert r.num_rows == 213
    assert r.get_row(0) == ["Alfreds Futterkiste", "NULL"]
    assert r.get_row(1) == ["Ana Trujillo Emparedados y helados", "10308"]
    assert r.get_row(212) == ["Wolski", "10374"]

    r = run(
        "SELECT customers.customername, orders.orderid"
        " FROM customers LEFT JOIN orders"
        " ON customers.customerid=orders.customerid"
        " WHERE customers.country = 'UK'"
        " ORDER BY customers.customername;",
        _customers_orders_provider(),
    )
    assert r.num_rows == 13
    assert r.get_row(0) == ["Around the Horn", "10355"]
    assert r.get_row(1) == ["Around the Horn", "10383"]
    assert r.get_row(12) == ["Seven Seas Imports", "10388"]


def test_table_names_with_dots(reference_dir):
    # reference: Runtime_test.cc:461-530 (TestTableNamesWithDots)
    for quote in ("'", "`"):
        r = run(
            f"select count(1) from {quote}test.tbl{quote};",
            CSTableScanProvider("test.tbl", TESTTBL_CST),
        )
        assert r.num_columns == 1
        assert r.num_rows == 1
        assert r.get_row(0) == ["213"]


def test_select_invalid_column_error(reference_dir):
    # reference: Runtime_test.cc:571-586 (TestSelectInvalidColumn)
    import pytest as _pytest

    with _pytest.raises(Exception) as exc:
        run(
            "select fnord from testtable;",
            CSTableScanProvider("testtable", TESTTBL_CST),
        )
    assert "column(s) not found: 'fnord'" in str(exc.value)


def test_order_by_aggregate_expression():
    """ORDER BY sum(v) (the aggregate expression repeated, not an
    ordinal/alias) resolves against the select list — round-5 fix;
    previously raised 'no implementation for sum'."""
    import numpy as np

    from eventql_tpu.core.types import SType
    from eventql_tpu.exec.relation import Column, Relation
    from eventql_tpu.exec.runtime import RelationTableProvider, Runtime

    n = 300
    rel = Relation(
        ["k", "v"],
        [
            Column(
                SType.UINT64, (np.arange(n) % 7).astype(np.uint64),
                np.ones(n, bool),
            ),
            Column(
                SType.UINT64, np.arange(n, dtype=np.uint64),
                np.ones(n, bool),
            ),
        ],
        n,
    )
    p = RelationTableProvider()
    p.add_table("ev", rel)
    rt = Runtime()

    by_expr = rt.execute_query(
        rt.new_transaction(p),
        "select k, sum(v) from ev group by k order by sum(v) desc, k;",
    )[0].rows
    by_ord = rt.execute_query(
        rt.new_transaction(p),
        "select k, sum(v) from ev group by k order by 2 desc, k;",
    )[0].rows
    assert by_expr == by_ord

    # aliased select entry still resolvable by the expression form
    aliased = rt.execute_query(
        rt.new_transaction(p),
        "select k, sum(v) as s from ev group by k order by sum(v) desc, k;",
    )[0].rows
    assert [r[1] for r in aliased] == [r[1] for r in by_ord]

    # unprojected aggregate: clear error, not a VM crash
    import pytest

    from eventql_tpu.core.errors import RuntimeError_

    with pytest.raises(RuntimeError_, match="must appear in the select"):
        rt.execute_query(
            rt.new_transaction(p),
            "select k from ev group by k order by sum(v);",
        )


def test_explain_renders_plan(reference_dir):
    """EXPLAIN <select> renders the logical plan (the reference parses
    EXPLAIN — parser.cc:914 — but has no planner/executor for it; this
    build renders the real tree)."""
    from eventql_tpu.exec.runtime import Runtime

    rt = Runtime()
    txn = rt.new_transaction(csv1_provider())
    res = rt.execute_query(
        txn,
        "explain select time, sum(value) from testtable where value > 0"
        " group by time order by 2 desc limit 3;",
    )[0]
    assert res.columns == ["QUERY PLAN"]
    text = "\n".join(r[0] for r in res.rows)
    assert "Limit 3" in text
    assert "OrderBy" in text
    assert "GroupBy" in text
    assert "SequentialScan on testtable" in text
    assert "where" in text


def test_having_filters_groups():
    """HAVING filters aggregated groups. The reference PARSES the
    clause but silently drops it (no planner consumer of T_HAVING);
    implemented for real here — silently losing a filter is worse than
    either erroring or honoring it."""
    import numpy as np

    from eventql_tpu.core.types import SType
    from eventql_tpu.exec.relation import Column, Relation
    from eventql_tpu.exec.runtime import RelationTableProvider, Runtime

    n = 100
    rel = Relation(
        ["k", "v"],
        [
            Column(
                SType.UINT64, (np.arange(n) % 7).astype(np.uint64),
                np.ones(n, bool),
            ),
            Column(
                SType.UINT64, np.arange(n, dtype=np.uint64),
                np.ones(n, bool),
            ),
        ],
        n,
    )
    p = RelationTableProvider()
    p.add_table("ev", rel)
    rt = Runtime()

    rows = rt.execute_query(
        rt.new_transaction(p),
        "select k, sum(v) from ev group by k having sum(v) > 700"
        " order by k;",
    )[0].rows
    assert rows == [
        ["0", "735"], ["1", "750"], ["5", "707"], ["6", "721"],
    ]

    # group-key predicates + composition with ORDER BY/LIMIT
    rows = rt.execute_query(
        rt.new_transaction(p),
        "select k, sum(v) from ev group by k"
        " having k > 3 and sum(v) > 600 order by sum(v) desc limit 2;",
    )[0].rows
    assert rows == [["6", "721"], ["5", "707"]]

    # empty result
    rows = rt.execute_query(
        rt.new_transaction(p),
        "select k, count(1) from ev group by k having count(1) > 999;",
    )[0].rows
    assert rows == []

    # an aggregate outside the select list: clear error
    import pytest

    from eventql_tpu.core.errors import RuntimeError_

    with pytest.raises(RuntimeError_, match="must appear in the select"):
        rt.execute_query(
            rt.new_transaction(p),
            "select k from ev group by k having sum(v) > 700;",
        )


def test_having_device_route_parity(monkeypatch):
    """HAVING wraps the GroupBy node, so the device/mesh fast paths
    still serve the aggregation and the filter applies on top."""
    import numpy as np

    from eventql_tpu.core.types import SType
    from eventql_tpu.exec.relation import Column, Relation
    from eventql_tpu.exec.runtime import RelationTableProvider, Runtime

    n = 3000
    rng = np.random.default_rng(9)
    rel = Relation(
        ["k", "v"],
        [
            Column(
                SType.UINT64,
                rng.integers(0, 23, n).astype(np.uint64),
                np.ones(n, bool),
            ),
            Column(
                SType.UINT64,
                rng.integers(0, 1000, n).astype(np.uint64),
                np.ones(n, bool),
            ),
        ],
        n,
    )
    q = (
        "select k, count(1), sum(v) from ev group by k"
        " having count(1) >= 130 order by k;"
    )

    def run(device):
        monkeypatch.setenv("EVENTQL_TPU_DEVICE", "1" if device else "0")
        p = RelationTableProvider()
        p.add_table("ev", rel)
        rt = Runtime()
        return rt.execute_query(rt.new_transaction(p), q)[0].rows

    host = run(False)
    assert host  # non-vacuous
    assert run(True) == host


def test_having_aliases_and_order_by_unselected_key():
    """Round-5 review regressions: HAVING on a select-list alias
    (MySQL semantics, like ORDER BY ordinals) and ORDER BY on a
    grouped-but-unselected column above a HAVING both work."""
    import numpy as np

    from eventql_tpu.core.types import SType
    from eventql_tpu.exec.relation import Column, Relation
    from eventql_tpu.exec.runtime import RelationTableProvider, Runtime

    n = 120
    rel = Relation(
        ["city", "region", "v"],
        [
            Column.from_strings([b"c%d" % (i % 5) for i in range(n)]),
            Column.from_strings([b"r%d" % (i % 3) for i in range(n)]),
            Column(
                SType.UINT64, np.arange(n, dtype=np.uint64),
                np.ones(n, bool),
            ),
        ],
        n,
    )
    p = RelationTableProvider()
    p.add_table("t", rel)
    rt = Runtime()

    rows = rt.execute_query(
        rt.new_transaction(p),
        "select city, sum(v) as s from t group by city"
        " having s > 1420 order by s;",
    )[0].rows
    assert rows == [["c2", "1428"], ["c3", "1452"], ["c4", "1476"]]

    res = rt.execute_query(
        rt.new_transaction(p),
        "select city, count(1) as c from t group by city, region"
        " having count(1) >= 1 order by region, city;",
    )[0]
    assert res.columns == ["city", "c"]
    assert len(res.rows) == 15
    assert all(len(r) == 2 for r in res.rows)
