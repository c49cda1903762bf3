"""cstable_tool CLI tests (reference: io/cstable/cstable_tool.cc —
dump / dump-json / index-lookup)."""

import hashlib
import io
import json
import os

from tests.conftest import reference_path
from eventql_tpu.cli.cstable_tool import main
from eventql_tpu.db.lsm import DurableTableService
from eventql_tpu.exec.runtime import Runtime


def run(svc, query):
    rt = Runtime()
    txn = rt.new_transaction(svc)
    return rt.build_query_plan(txn, query).execute(0)


def tool(*args):
    out = io.StringIO()
    rc = main(list(args), out=out)
    return rc, out.getvalue()


def test_dump_reference_fixture(reference_dir):
    rc, text = tool("dump", reference_path("test", "sql_testdata", "testtbl.cst"))
    assert rc == 0
    assert " >> number of records: 213" in text
    assert ">>  column_id=0, column_name=attr.ab_test_group" in text
    # per-value rows carry rlvl/dlvl/data like the reference's iputs line
    assert ">>  idx=1/1 rlvl=0 dlvl=" in text


def test_dump_v2_segment_and_index_lookup(tmp_path):
    d = str(tmp_path / "data")
    svc = DurableTableService(d, arena_flush_rows=100)
    run(svc, "CREATE TABLE ev (id uint64, name string, PRIMARY KEY (id));")
    run(svc, "INSERT INTO ev (id, name) VALUES (1, 'one');")
    run(svc, "INSERT INTO ev (id, name) VALUES (2, 'two');")
    svc.commit_all()

    seg_dir = os.path.join(d, "ev")
    seg = os.path.join(
        seg_dir, [f for f in sorted(os.listdir(seg_dir)) if f.endswith(".cst")][0]
    )
    rc, text = tool("dump", seg)
    assert rc == 0
    assert " >> number of records: 2" in text
    assert "== COLUMN DATA for" in text
    assert "'one'" in text
    # v0.2 files expose the page index (cstable_tool.cc:93-114)
    assert " type=DATA " in text

    # index-lookup: pk SHA1 → newest row position
    want = hashlib.sha1(b"2").hexdigest()
    rc, text = tool("index-lookup", seg_dir, want)
    assert rc == 0
    assert f"INDEXENT: {want} => 1" in text


def test_dump_json_with_message_schema(tmp_path):
    d = str(tmp_path / "data")
    svc = DurableTableService(d, arena_flush_rows=100)
    run(
        svc,
        "CREATE TABLE logs (id uint64, tags REPEATED string,"
        " evt RECORD (kind string, n uint64), PRIMARY KEY (id));",
    )
    svc.insert_json(
        "logs",
        json.dumps({"id": 1, "tags": ["a", "b"], "evt": {"kind": "x", "n": 7}}),
    )
    svc.insert_json(
        "logs", json.dumps({"id": 2, "tags": [], "evt": {"kind": "y", "n": 9}})
    )
    svc.commit_all()

    seg_dir = os.path.join(d, "logs")
    seg = os.path.join(
        seg_dir, [f for f in sorted(os.listdir(seg_dir)) if f.endswith(".cst")][0]
    )

    # reference MessageSchema JSON format (MessageSchema.cc:434-497)
    schema = {
        "name": "logs",
        "columns": [
            {"id": 1, "name": "id", "type": "uint64", "optional": True,
             "repeated": False},
            {"id": 2, "name": "tags", "type": "string", "optional": True,
             "repeated": True},
            {"id": 3, "name": "evt", "type": "object", "optional": True,
             "repeated": False,
             "schema": {"name": "evt", "columns": [
                 {"id": 4, "name": "kind", "type": "string",
                  "optional": True, "repeated": False},
                 {"id": 5, "name": "n", "type": "uint64",
                  "optional": True, "repeated": False},
             ]}},
        ],
    }
    spath = str(tmp_path / "schema.json")
    with open(spath, "w") as f:
        json.dump(schema, f)

    rc, text = tool("dump-json", seg, spath)
    assert rc == 0
    recs = [json.loads(line) for line in text.strip().splitlines()]
    assert len(recs) == 2
    assert recs[0]["id"] == 1
    assert recs[0]["tags"] == ["a", "b"]
    assert recs[0]["evt"] == {"kind": "x", "n": 7}
    assert recs[1]["evt"]["n"] == 9


def test_unknown_command():
    rc, _ = tool("frobnicate")
    assert rc == 1
