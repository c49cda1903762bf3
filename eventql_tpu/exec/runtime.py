"""Query runtime: parse → plan → execute.

Mirrors the reference's Runtime/Transaction/QueryPlan composition
(reference: sql/runtime/runtime.cc:35-85, sql/query_plan.cc,
sql/transaction.h) in a single embeddable object, exactly like the
golden-file SQL test harness uses it (reference: test/sql_tests.cc).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from eventql_tpu.core.errors import RuntimeError_, SQLError
from eventql_tpu.core.types import SType, SValue
from eventql_tpu.exec.operators import execute_node
from eventql_tpu.exec.relation import Relation
from eventql_tpu.exec.result import ResultList
from eventql_tpu.plan import nodes as qn
from eventql_tpu.plan.builder import QueryPlanBuilder, TableProvider
from eventql_tpu.plan.functions import DEFAULT_REGISTRY
from eventql_tpu.plan.scalar_eval import evaluate_scalar
from eventql_tpu.sql.parser import Parser


class TableInfo:
    def __init__(self, table_name: str, columns):
        self.table_name = table_name
        self.columns = columns  # List[(name, SType)]


class RelationTableProvider(TableProvider):
    """Serves queries from in-memory Relations (what the CSV / cstable
    ingest layers produce)."""

    def __init__(self):
        self._tables: Dict[str, Relation] = {}
        self._schema_version = 0

    def add_table(self, name: str, rel: Relation, stypes: Optional[List[SType]] = None):
        self._tables[name] = rel
        self._schema_version += 1

    def plan_cache_key(self):
        return self._schema_version

    def describe(self, table_name: str) -> Optional[TableInfo]:
        rel = self._tables.get(table_name)
        if rel is None:
            return None
        cols = [(n, c.stype) for n, c in zip(rel.names, rel.columns)]
        return TableInfo(table_name, cols)

    def list_tables(self):
        return [self.describe(n) for n in sorted(self._tables)]

    def get_table_data(self, table_name: str) -> Relation:
        rel = self._tables.get(table_name)
        if rel is None:
            raise RuntimeError_(f"table not found: '{table_name}'")
        return rel

    def get_table_chunks(self, table_name: str, chunk_rows: int):
        """Chunked view for the streaming cursor (bounds the downstream
        formatted-row footprint; the relation itself is in RAM)."""
        yield from self.get_table_data(table_name).iter_chunks(chunk_rows)


class Transaction:
    def __init__(self, tables: TableProvider, query_cache=None, trace=None):
        from eventql_tpu.exec.exec_context import ExecutionContext

        self.tables = tables
        self.query_cache = query_cache
        # per-query stats + shard progress (reference:
        # sql/scheduler/execution_context.h:30-54)
        self.exec_ctx = ExecutionContext()
        # per-operator timing (survey §5: the reference has no tracer —
        # this is this engine's addition): list of
        # (operator, depth, wall_seconds, output_rows) tuples, enabled
        # by passing trace=[] or EVENTQL_TRACE=1
        import os as _os

        if trace is None and _os.environ.get("EVENTQL_TRACE") == "1":
            trace = []
        self.trace = trace
        self._trace_depth = 0

    def get_table_data(self, table_name: str) -> Relation:
        rel = self.tables.get_table_data(table_name)
        # every operator-layer table materialization is a scan for the
        # query's stats (rows/bytes-scanned in QUERY_PROGRESS and
        # QUERY_RESULT; the reference defines those wire fields but
        # zeroes them, frames/query_progress.cc:63-70). Deduped per
        # (table, relation identity) within the transaction: the device
        # GROUP BY / top-k routes fetch the table while PROBING
        # eligibility and the fallback path fetches it again — one
        # logical scan must not count 2-3x.
        seen = getattr(self, "_scan_counted", None)
        if seen is None:
            seen = self._scan_counted = set()
        key = (table_name, id(rel))
        if key not in seen:
            seen.add(key)
            self.exec_ctx.count_scan(
                rel.num_rows,
                sum(c.data.nbytes + c.valid.nbytes for c in rel.columns),
            )
        return rel

    def trace_report(self) -> str:
        if not self.trace:
            return ""
        out = []
        for op, depth, secs, rows in self.trace:
            out.append(f"{'  ' * depth}{op}: {secs * 1e3:.3f} ms, {rows} rows")
        return "\n".join(out)


class PlanCache:
    """Server-side LRU cache of built plan-node lists, keyed by
    (provider identity, provider schema version, query text).

    The reference re-parses and re-plans every query per request (its
    only caching is of partial-aggregate RESULTS, QueryCache); repeated
    dashboard queries here skip parse + plan-build entirely. Plans are
    safe to share: execution never mutates plan nodes (device-route
    rewrites copy expressions first), and all table DATA is read through
    the transaction at execute time, so a cached plan stays correct
    across inserts. Schema changes invalidate via the provider's
    plan_cache_key() version. Only read-only statement plans are cached
    (DDL/DML re-build, and any DDL bumps the version key anyway)."""

    def __init__(self, max_entries: int = 256):
        import threading
        from collections import OrderedDict

        self._lock = threading.Lock()
        self._entries = OrderedDict()
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            nodes = self._entries.get(key)
            if nodes is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return nodes

    def put(self, key, nodes):
        with self._lock:
            self._entries[key] = nodes
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)


class QueryPlan:
    def __init__(self, runtime: "Runtime", txn: Transaction, nodes: List[qn.QueryTreeNode]):
        self.runtime = runtime
        self.txn = txn
        self.nodes = nodes

    @property
    def num_queries(self) -> int:
        return len(self.nodes)

    def execute(self, idx: int) -> ResultList:
        node = self.nodes[idx]
        if isinstance(node, qn.ExplainNode):
            # render the logical plan (reference parses EXPLAIN but
            # never plans it — parser.cc:914; this exceeds it)
            lines = qn.explain_lines(node.child)
            return ResultList(["QUERY PLAN"], [[l] for l in lines])
        rel = self._execute_traced(node)
        result_columns = node.get_result_columns()
        return ResultList.from_relation(result_columns, rel)

    def execute_stream(self, idx: int):
        """Execute statement `idx` with bounded memory when its plan
        shape allows: returns a StreamingResultList whose rows generator
        pulls storage chunks through the row-local operators as the
        transport consumes them (reference: ResultCursor,
        sql/result_cursor.h:35-75); falls back to the materializing
        execute() for blocking shapes (GROUP BY / ORDER BY / JOIN)."""
        import os as _os

        from eventql_tpu.exec import streaming

        node = self.nodes[idx]
        # differential-test escape hatch: force the materializing path
        if _os.environ.get("EVENTQL_TPU_NO_STREAMING") == "1":
            return self.execute(idx)
        if streaming.streamable(node, self.txn):
            return streaming.StreamingResultList(
                node.get_result_columns(),
                streaming.stream_node(node, self.txn),
            )
        return self.execute(idx)

    def _execute_traced(self, node):
        # XLA/Pallas profiler hook (survey §5 — the reference has no
        # profiler): EVENTQL_XLA_TRACE=<dir> captures a per-query
        # device trace viewable in TensorBoard/Perfetto, alongside the
        # host-side per-operator tracer (Transaction.trace)
        import os as _os

        trace_dir = _os.environ.get("EVENTQL_XLA_TRACE")
        if trace_dir:
            import jax

            with jax.profiler.trace(trace_dir):
                return execute_node(node, self.txn)
        return execute_node(node, self.txn)


class Runtime:
    def __init__(self, registry=DEFAULT_REGISTRY, plan_cache: Optional[PlanCache] = None):
        from eventql_tpu.exec.backend import install_compile_cache

        install_compile_cache()
        self.registry = registry
        self.plan_cache = plan_cache

    def new_transaction(
        self, tables: Optional[TableProvider] = None, query_cache=None
    ) -> Transaction:
        return Transaction(tables or RelationTableProvider(), query_cache)

    def build_query_plan(self, txn: Transaction, query: str) -> QueryPlan:
        key = None
        if self.plan_cache is not None:
            version_fn = getattr(txn.tables, "plan_cache_key", None)
            if version_fn is not None:
                key = (id(txn.tables), version_fn(), query)
                nodes = self.plan_cache.get(key)
                if nodes is not None:
                    return QueryPlan(self, txn, nodes)
        parser = Parser()
        statements = parser.parse(query)
        builder = QueryPlanBuilder(self.registry)
        nodes = builder.build_statements(statements, txn.tables)
        if key is not None and all(
            isinstance(n, qn.TableExpressionNode) for n in nodes
        ):
            self.plan_cache.put(key, nodes)
        return QueryPlan(self, txn, nodes)

    def execute_query(self, txn: Transaction, query: str) -> List[ResultList]:
        plan = self.build_query_plan(txn, query)
        return [plan.execute(i) for i in range(plan.num_queries)]

    def evaluate_const_expression(self, txn: Transaction, expr_str: str) -> SValue:
        # reference: Runtime::evaluateConstExpression (runtime.cc:126-150)
        parser = Parser()
        ast = parser.parse_value_expression(expr_str)
        builder = QueryPlanBuilder(self.registry)
        from eventql_tpu.plan.builder import _empty_resolver

        expr = builder.build_value_expression(ast, _empty_resolver)
        return evaluate_scalar(expr)
