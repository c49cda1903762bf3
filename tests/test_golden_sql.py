"""Golden-file SQL conformance suite.

Runs the reference's golden SQL tests (reference: test/sql/*.sql +
*.result.txt, harness semantics from test/sql_tests.cc:201-320) against
our engine and compares row-for-row. The reference files are the
correctness contract; without the reference checkout the suite skips.
"""

import os
import re

import pytest

from tests.conftest import reference_path

from eventql_tpu.columnar.providers import (
    CompositeTableProvider,
    CSTableScanProvider,
    CSVTableProvider,
)
from eventql_tpu.core.errors import SQLError
from eventql_tpu.exec.runtime import Runtime

SQL_DIR = reference_path("test", "sql")
LIST_FILE = reference_path("test", "sql_tests.lst")


def _test_ids():
    try:
        with open(LIST_FILE) as f:
            return [line.strip() for line in f if line.strip()]
    except FileNotFoundError:
        return ["sql_tests.lst"]  # one case, skipped by reference_dir


TEST_IDS = _test_ids()

IMPORT_RE = re.compile(r"-- IMPORT (\w+) FROM ([a-zA-Z0-9-_\./]+)")


def _parse_result_csv(text: str):
    """Semicolon-CSV parsing with the reference's quote semantics
    (util/csv/CSVInputStream.cc:59-99)."""
    rows = []
    row = []
    field = []
    quoted = False
    ended = True
    for ch in text:
        ended = False
        if not quoted and ch == ";":
            row.append("".join(field))
            field = []
            continue
        if not quoted and ch == "\n":
            row.append("".join(field))
            rows.append(row)
            row = []
            field = []
            ended = True
            continue
        if ch == '"':
            quoted = not quoted
            continue
        field.append(ch)
    return rows


def _run_golden(test_id: str):
    sql_path = os.path.join(SQL_DIR, test_id + ".sql")
    result_path = os.path.join(SQL_DIR, test_id + ".result.txt")

    with open(sql_path, encoding="utf-8") as f:
        query = f.read()
    with open(result_path, encoding="utf-8") as f:
        expected_raw = f.read()

    expect_error = expected_raw.split("\n", 1)[0].rstrip("\r") == "ERROR!"

    tables = CompositeTableProvider()
    for m in IMPORT_RE.finditer(query):
        table, filename = m.group(1), m.group(2)
        path = reference_path(filename.lstrip("./"))
        if filename.endswith(".cst"):
            tables.add(CSTableScanProvider(table, path))
        elif filename.endswith(".csv"):
            tables.add(CSVTableProvider(table, path))
        else:
            raise RuntimeError("invalid table file type")

    runtime = Runtime()
    txn = runtime.new_transaction(tables)

    error_message = None
    result = None
    try:
        plan = runtime.build_query_plan(txn, query)
        result = plan.execute(0)
    except SQLError as e:
        error_message = e.message
        if not expect_error:
            raise

    if expect_error:
        expected_error = expected_raw.split("\n", 1)[1].rstrip("\n")
        assert error_message == expected_error
        return

    if result.num_columns == 1 and result.columns[0] == "__chart":
        # chart compare: whole SVG string
        assert result.num_rows == 1
        assert result.get_row(0)[0] == expected_raw
        return

    expected_rows = _parse_result_csv(expected_raw)
    header, expected_body = expected_rows[0], expected_rows[1:]

    assert result.columns == header, (
        f"column mismatch: {result.columns} != {header}"
    )
    assert result.num_rows == len(expected_body), (
        f"row count mismatch: {result.num_rows} != {len(expected_body)}"
    )
    for i, exp in enumerate(expected_body):
        got = result.get_row(i)
        assert got == exp, f"row {i}: {got} != {exp}"


@pytest.mark.parametrize("test_id", TEST_IDS)
def test_golden(test_id, reference_dir):
    _run_golden(test_id)
