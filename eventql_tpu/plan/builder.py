"""Query-plan builder: AST → typed logical plan.

Re-implements the reference's QueryPlanBuilder
(reference: sql/runtime/queryplanbuilder.cc) — dispatch order, implicit
column naming, constant folding, column resolution, and the same node
decomposition (LIMIT and ORDER BY peel off the AST outside-in; GROUP BY
builds a child scan with an empty select list that resolution then
populates).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from eventql_tpu.core.errors import RuntimeError_
from eventql_tpu.core.types import SType, SValue
from eventql_tpu.plan import nodes as qn
from eventql_tpu.plan.exprs import (
    CallExpressionNode,
    ColumnReferenceNode,
    IfExpressionNode,
    IsNullExpressionNode,
    LikeExpressionNode,
    LiteralExpressionNode,
    RegexExpressionNode,
    ValueExpressionNode,
    has_aggregate_call,
    is_constant,
)
from eventql_tpu.plan.functions import DEFAULT_REGISTRY, FN_AGGREGATE, FunctionRegistry
from eventql_tpu.plan.scalar_eval import evaluate_scalar
from eventql_tpu.sql.ast import ASTNode

# AST operator node type -> function name
# (reference: buildUnoptimizedValueExpression, queryplanbuilder.cc:1417-1475)
_OPERATOR_FN = {
    "T_EQ_EXPR": "eq",
    "T_NEQ_EXPR": "neq",
    "T_AND_EXPR": "logical_and",
    "T_OR_EXPR": "logical_or",
    "T_NEGATE_EXPR": "neg",
    "T_LT_EXPR": "lt",
    "T_LTE_EXPR": "lte",
    "T_GT_EXPR": "gt",
    "T_GTE_EXPR": "gte",
    "T_ADD_EXPR": "add",
    "T_SUB_EXPR": "sub",
    "T_MUL_EXPR": "mul",
    "T_DIV_EXPR": "div",
    "T_MOD_EXPR": "mod",
    "T_POW_EXPR": "pow",
}

# AST column naming (reference: ASTUtil::columnNameForExpression,
# parser/astutil.cc:32-213)
_OP_NAME_SEP = {
    "T_EQ_EXPR": " == ",
    "T_NEQ_EXPR": " != ",
    "T_LT_EXPR": " < ",
    "T_LTE_EXPR": " <= ",
    "T_GT_EXPR": " > ",
    "T_GTE_EXPR": " >= ",
    "T_AND_EXPR": " AND ",
    "T_OR_EXPR": " OR ",
    "T_ADD_EXPR": " + ",
    "T_SUB_EXPR": " - ",
    "T_MUL_EXPR": " * ",
    "T_DIV_EXPR": " / ",
    "T_MOD_EXPR": " % ",
    "T_POW_EXPR": " ^ ",
}


def column_name_for_expression(expr: ASTNode) -> str:
    t = expr.ntype
    if t == "T_LITERAL":
        return expr.token.value
    if t in ("T_COLUMN_NAME", "T_TABLE_NAME", "T_RESOLVED_COLUMN"):
        s = expr.token.value
        for c in expr.children:
            s += "." + column_name_for_expression(c)
        return s
    if t in ("T_RESOLVED_CALL", "T_METHOD_CALL"):
        args = ", ".join(column_name_for_expression(c) for c in expr.children)
        return f"{expr.token.value}({args})"
    if t == "T_METHOD_CALL_WITHIN_RECORD":
        args = ", ".join(column_name_for_expression(c) for c in expr.children)
        return f"{expr.token.value}({args}) WITHIN RECORD"
    if t == "T_IF_EXPR":
        args = ", ".join(column_name_for_expression(c) for c in expr.children)
        return f"if({args})"
    if t == "T_NEGATE_EXPR":
        args = ", ".join(column_name_for_expression(c) for c in expr.children)
        return f"!({args})"
    sep = _OP_NAME_SEP.get(t)
    if sep is not None:
        args = sep.join(column_name_for_expression(c) for c in expr.children)
        return f"({args})"
    return "<expr>"


# reserved column-index space marking HAVING refs already resolved to
# the GroupBy OUTPUT (select-list aliases); the output-resolver rewrites
# them to plain output indexes
_HAVING_OUT_BASE = 1 << 40

ColumnResolver = Callable[[str], Tuple[int, SType]]


def _empty_resolver(name: str) -> Tuple[int, SType]:
    return (qn.NOT_FOUND, SType.NIL)


class TableProvider:
    """Interface: maps table names to schemas and backing data
    (reference: sql/table_provider.h)."""

    def describe(self, table_name: str):
        """Return TableInfo-like object with .table_name and
        .columns: List[(name, SType)] — or None."""
        return None

    def list_tables(self):
        return []


class QueryPlanBuilder:
    def __init__(
        self,
        registry: FunctionRegistry = DEFAULT_REGISTRY,
        enable_constant_folding: bool = True,
    ):
        self.registry = registry
        self.enable_constant_folding = enable_constant_folding

    # ------------------------------------------------------------------
    # top level
    # ------------------------------------------------------------------
    def build(self, ast: ASTNode, tables: TableProvider) -> qn.QueryTreeNode:
        # reference: QueryPlanBuilder::build (queryplanbuilder.cc:68-151)
        if ast.ntype == "T_EXPLAIN_QUERY":
            # EXPLAIN <select>: the reference PARSES this (parser.cc:
            # 914) but nothing downstream consumes the node — here it
            # renders the built logical plan (this engine's addition)
            return qn.ExplainNode(self.build(ast.children[0], tables))
        if self._has_implicitly_named_columns(ast):
            self._assign_explicit_column_names(ast)

        node = self._build_limit_clause(ast, tables)
        if node is not None:
            return node

        if self._has_order_by_clause(ast):
            return self._build_order_by(ast, tables)

        if self._has_group_by_clause(ast) or self._has_aggregation_in_select_list(ast):
            return self._build_group_by(ast, tables)

        node = self._build_join(ast, tables)
        if node is not None:
            return node

        node = self._build_subquery(ast, tables)
        if node is not None:
            return node

        node = self._build_sequential_scan(ast, tables)
        if node is not None:
            return node

        node = self._build_select_expression(ast)
        if node is not None:
            return node

        if ast.ntype == "T_SHOW_TABLES":
            return qn.ShowTablesNode()
        if ast.ntype == "T_DESCRIBE_TABLE":
            return qn.DescribeTableNode(ast.children[0].token.value)
        if ast.ntype == "T_DESCRIBE_PARTITIONS":
            return qn.DescribePartitionsNode(ast.children[0].token.value)
        if ast.ntype == "T_CLUSTER_SHOW_SERVERS":
            return qn.ClusterShowServersNode()
        if ast.ntype == "T_DRAW":
            return qn.ChartNode(ast.token.ttype, list(ast.children), [])
        if ast.ntype == "T_CREATE_TABLE":
            return self._build_create_table(ast)
        if ast.ntype == "T_DROP_TABLE":
            return qn.DropTableNode(ast.children[0].token.value)
        if ast.ntype == "T_CREATE_DATABASE":
            return qn.CreateDatabaseNode(ast.children[0].token.value)
        if ast.ntype == "T_USE_DATABASE":
            return qn.UseDatabaseNode(ast.children[0].token.value)
        if ast.ntype == "T_INSERT_INTO":
            return self._build_insert_into(ast)
        if ast.ntype == "T_ALTER_TABLE":
            return self._build_alter_table(ast)

        raise RuntimeError_("can't figure out a query plan for this, sorry :(")

    # ------------------------------------------------------------------
    # DDL / DML (reference: queryplanbuilder.cc buildCreateTable etc. +
    # sql/qtree/nodes/*)
    # ------------------------------------------------------------------
    def _build_column_definition(self, col_ast) -> qn.ColumnDefinition:
        name = col_ast.children[0].token.value
        repeated = any(c.ntype == "T_REPEATED" for c in col_ast.children)
        not_null = any(c.ntype == "T_NOT_NULL" for c in col_ast.children)
        record = col_ast.find_first("T_RECORD")
        if record is not None:
            sub = [self._build_column_definition(c) for c in record.children]
            return qn.ColumnDefinition(name, "RECORD", repeated, not_null, sub)
        type_node = col_ast.find_first("T_COLUMN_TYPE")
        ctype = type_node.token.value if type_node and type_node.token else ""
        return qn.ColumnDefinition(name, ctype, repeated, not_null)

    def _build_create_table(self, ast):
        table_name = ast.children[0].token.value
        column_list = ast.children[1]
        columns, primary_key, partition_key = [], [], None
        for child in column_list.children:
            if child.ntype == "T_PRIMARY_KEY":
                for cn in child.children:
                    primary_key.append(cn.token.value)
            elif child.ntype == "T_PARTITION_KEY":
                partition_key = child.children[0].token.value
            elif child.ntype == "T_COLUMN":
                coldef = self._build_column_definition(child)
                if child.find_first("T_PRIMARY_KEY") is not None:
                    primary_key.append(coldef.column_name)
                columns.append(coldef)
        properties = []
        for child in ast.children[2:]:
            if child.ntype == "T_TABLE_PROPERTY_LIST":
                for prop in child.children:
                    key = prop.children[0].token.value
                    val = prop.children[1].token.value
                    properties.append((key, val))
        return qn.CreateTableNode(
            table_name, columns, primary_key, partition_key, properties
        )

    def _build_insert_into(self, ast):
        table_name = ast.children[0].token.value
        if len(ast.children) > 1 and ast.children[1].ntype == "T_JSON_STRING":
            return qn.InsertIntoNode(
                table_name, [], [], json_data=ast.children[1].token.value
            )
        columns = [c.token.value for c in ast.children[1].children]
        value_exprs = []
        for v in ast.children[2].children:
            expr = self.build_value_expression(v, _empty_resolver)
            value_exprs.append(expr)
        return qn.InsertIntoNode(table_name, columns, value_exprs)

    def _build_alter_table(self, ast):
        table_name = ast.children[0].token.value
        ops = []
        for child in ast.children[1:]:
            if child.ntype == "T_COLUMN":
                ops.append(
                    (qn.AlterTableNode.ADD_COLUMN, self._build_column_definition(child))
                )
            elif child.ntype == "T_COLUMN_NAME":
                ops.append((qn.AlterTableNode.DROP_COLUMN, child.token.value))
            elif child.ntype == "T_TABLE_PROPERTY":
                key = child.children[0].token.value
                val = child.children[1].token.value
                ops.append((qn.AlterTableNode.SET_PROPERTY, (key, val)))
        return qn.AlterTableNode(table_name, ops)

    def build_statements(
        self, statements: List[ASTNode], tables: TableProvider
    ) -> List[qn.QueryTreeNode]:
        # Consecutive DRAW statements with their trailing SELECTs fold
        # into one chart statement (reference: queryplanbuilder.cc:155-220)
        out: List[qn.QueryTreeNode] = []
        i = 0
        while i < len(statements):
            st = statements[i]
            if st.ntype == "T_DRAW":
                draw_nodes = []
                while i < len(statements) and statements[i].ntype == "T_DRAW":
                    draw_ast = statements[i]
                    subselects = []
                    i += 1
                    while i < len(statements):
                        if statements[i].ntype == "T_SELECT":
                            subselects.append(self.build(statements[i], tables))
                            i += 1
                            continue
                        if statements[i].ntype == "T_DRAW":
                            break
                        raise RuntimeError_(
                            "DRAW statments may only be followed by SELECT or "
                            "END DRAW statements"
                        )
                    draw_nodes.append(
                        qn.ChartNode(
                            draw_ast.token.ttype, list(draw_ast.children), subselects
                        )
                    )
                # a chart statement may carry several draw nodes; wrap in
                # the first for now, unioning their queries
                chart = draw_nodes[0]
                for extra in draw_nodes[1:]:
                    chart.union_queries.extend(extra.union_queries)
                out.append(chart)
            elif st.ntype in (
                "T_SELECT",
                "T_EXPLAIN_QUERY",
                "T_SHOW_TABLES",
                "T_DESCRIBE_TABLE",
                "T_DESCRIBE_PARTITIONS",
                "T_CLUSTER_SHOW_SERVERS",
                "T_CREATE_TABLE",
                "T_CREATE_DATABASE",
                "T_USE_DATABASE",
                "T_DROP_TABLE",
                "T_INSERT_INTO",
                "T_ALTER_TABLE",
            ):
                out.append(self.build(st, tables))
                i += 1
            else:
                # reference: queryplanbuilder.cc:214-216 — EXPLAIN and
                # anything else outside the allowlist
                raise RuntimeError_("invalid statement")
        return out

    # ------------------------------------------------------------------
    # predicates over the AST
    # ------------------------------------------------------------------
    def _has_implicitly_named_columns(self, ast: ASTNode) -> bool:
        # reference: queryplanbuilder.cc:273-296
        if ast.ntype != "T_SELECT":
            return False
        if not ast.children or ast.children[0].ntype != "T_SELECT_LIST":
            raise RuntimeError_("corrupt AST")
        if len(ast.children) == 1:
            return False
        for col in ast.children[0].children:
            if col.ntype == "T_DERIVED_COLUMN" and len(col.children) == 1:
                return True
        return False

    def _assign_explicit_column_names(self, ast: ASTNode):
        # reference: queryplanbuilder.cc:414-437
        from eventql_tpu.sql.tokens import Token

        select_list = ast.children[0]
        for col in select_list.children:
            if col.ntype == "T_DERIVED_COLUMN" and len(col.children) == 1:
                alias = col.append("T_COLUMN_ALIAS")
                alias.token = Token(
                    "T_IDENTIFIER", column_name_for_expression(col.children[0])
                )

    def _has_group_by_clause(self, ast: ASTNode) -> bool:
        if ast.ntype != "T_SELECT" or len(ast.children) < 2:
            return False
        return any(c.ntype == "T_GROUP_BY" for c in ast.children)

    def _has_order_by_clause(self, ast: ASTNode) -> bool:
        if ast.ntype != "T_SELECT" or len(ast.children) < 2:
            return False
        return any(c.ntype == "T_ORDER_BY" for c in ast.children)

    def _has_aggregation_in_select_list(self, ast: ASTNode) -> bool:
        if ast.ntype != "T_SELECT" or len(ast.children) < 2:
            return False
        return self._has_aggregation_expr(ast.children[0])

    def _has_aggregation_expr(self, ast: ASTNode) -> bool:
        if ast.ntype == "T_METHOD_CALL":
            if ast.token is None:
                raise RuntimeError_("corrupt AST")
            if self.registry.is_aggregate(ast.token.value):
                return True
        return any(self._has_aggregation_expr(c) for c in ast.children)

    def _has_within_record_expr(self, ast: ASTNode) -> bool:
        if ast.ntype == "T_METHOD_CALL_WITHIN_RECORD":
            return True
        return any(self._has_within_record_expr(c) for c in ast.children)

    # ------------------------------------------------------------------
    # LIMIT / ORDER BY / GROUP BY
    # ------------------------------------------------------------------
    def _build_limit_clause(self, ast, tables):
        # reference: queryplanbuilder.cc:524-581
        if ast.ntype != "T_SELECT" or len(ast.children) < 3:
            return None
        for child in ast.children:
            if child.ntype != "T_LIMIT":
                continue
            limit = int(child.token.value.split(".")[0] or "0")
            offset = 0
            if child.children:
                offset = int(child.children[0].token.value.split(".")[0] or "0")
            new_ast = ast.deep_copy()
            new_ast.remove_children_by_type("T_LIMIT")
            return qn.LimitNode(limit, offset, self.build(new_ast, tables))
        return None

    def _build_order_by(self, ast, tables):
        # reference: queryplanbuilder.cc:583-631
        child_ast = ast.deep_copy()
        child_ast.remove_children_by_type("T_ORDER_BY")
        subtree = self.build(child_ast, tables)

        sort_specs = []
        for child in ast.children:
            if child.ntype != "T_ORDER_BY":
                continue
            for sort in child.children:
                descending = (
                    sort.token is not None and sort.token.ttype == "T_DESC"
                )
                expr = self.build_value_expression(
                    sort.children[0],
                    lambda name: subtree.get_computed_column_info(name, True),
                )
                # ORDER BY <ordinal>: resolve a positive integer literal
                # to the select-list column (MySQL semantics). The
                # reference leaves the literal in place
                # (queryplanbuilder.cc:609-620), which sorts by a
                # constant — i.e. an UNSPECIFIED order under its
                # unstable std::sort — so resolving is a strict
                # refinement, never a divergence on defined behavior
                # (noted in COMPARISON.md).
                from eventql_tpu.plan.exprs import LiteralExpressionNode

                if isinstance(expr, LiteralExpressionNode) and not expr.value.is_null:
                    try:
                        pos = int(expr.value.payload())
                    except (TypeError, ValueError):
                        pos = None
                    ncols = len(subtree.get_result_columns())
                    if pos is not None and 1 <= pos <= ncols:
                        from eventql_tpu.plan.exprs import (
                            ColumnReferenceNode,
                        )

                        name = subtree.get_result_columns()[pos - 1]
                        expr = ColumnReferenceNode(
                            name,
                            subtree.get_column_type(pos - 1),
                            index=pos - 1,
                        )
                # ORDER BY <aggregate-expr> (e.g. ORDER BY sum(v)):
                # aggregates cannot evaluate inside the sort — resolve
                # the expression against the select list's output
                # columns by its SQL form (aliases already resolve via
                # the name resolver above; the reference compiles the
                # matching select-list output the same way,
                # sql/scheduler.cc:95-151)
                from eventql_tpu.plan.exprs import has_aggregate_call

                if has_aggregate_call(expr):
                    sql_form = expr.to_sql()
                    pos = None
                    select_list = getattr(subtree, "select_list", None)
                    if select_list is not None:
                        for i, sl in enumerate(select_list):
                            if sl.expr.to_sql() == sql_form:
                                pos = i
                                break
                    if pos is None:
                        raise RuntimeError_(
                            "ORDER BY aggregate expression must appear "
                            "in the select list"
                        )
                    from eventql_tpu.plan.exprs import (
                        ColumnReferenceNode,
                    )

                    expr = ColumnReferenceNode(
                        subtree.get_result_columns()[pos],
                        subtree.get_column_type(pos),
                        index=pos,
                    )
                sort_specs.append(qn.SortSpec(expr, descending))
        return qn.OrderByNode(sort_specs, subtree)

    def _build_group_by(self, ast, tables):
        # reference: queryplanbuilder.cc:439-522
        if ast.children[0].ntype != "T_SELECT_LIST":
            raise RuntimeError_("corrupt AST")
        select_list = ast.children[0].deep_copy()

        child_ast = ast.deep_copy()
        child_ast.remove_children_by_type("T_GROUP_BY")
        child_ast.remove_children_by_type("T_HAVING")
        child_ast.remove_child_at(0)
        child_ast.append_at(ASTNode("T_SELECT_LIST"), 0)

        subtree = self.build(child_ast, tables)

        group_exprs = []
        for child in ast.children:
            if child.ntype != "T_GROUP_BY":
                continue
            for group_expr in child.children:
                if self._has_aggregation_expr(group_expr):
                    raise RuntimeError_(
                        "GROUP clause can only contain pure functions"
                    )
                group_exprs.append(
                    self.build_value_expression(
                        group_expr,
                        lambda name: subtree.get_computed_column_info(name, True),
                    )
                )

        select_entries = []
        for sexpr in select_list.children:
            if sexpr.ntype == "T_ALL":
                for col in subtree.get_available_columns():
                    idx = subtree.get_computed_column_index(col.qualified_name, True)
                    select_entries.append(
                        qn.SelectListEntry(
                            ColumnReferenceNode(col.qualified_name, col.stype, idx),
                            alias=col.short_name,
                        )
                    )
            else:
                select_entries.append(
                    self._build_select_list_entry(
                        sexpr,
                        lambda name: subtree.get_computed_column_info(name, True),
                    )
                )

        self._push_within_record(select_entries, group_exprs, subtree)
        node = qn.GroupByNode(select_entries, group_exprs, subtree)

        having_ast = None
        for child in ast.children:
            if child.ntype == "T_HAVING":
                having_ast = child.children[0]
        if having_ast is not None:
            # name resolution: select-list ALIASES bind to the GroupBy
            # output (MySQL semantics, like ORDER BY ordinals) via a
            # reserved index space the output-resolver rewrites; other
            # names bind to the scan child as usual
            def having_resolver(name):
                for i, sl in enumerate(node.select_list):
                    if sl.alias is not None and sl.alias == name:
                        return (
                            _HAVING_OUT_BASE + i,
                            sl.expr.return_type(),
                        )
                return subtree.get_computed_column_info(name, True)

            having = self.build_value_expression(
                having_ast, having_resolver
            )
            having = self._resolve_aggregates_to_outputs(having, node)
            node = qn.HavingNode(node, having)
        return node

    def _resolve_aggregates_to_outputs(self, expr, group_node):
        """Rewrite a HAVING expression to run over the GroupBy OUTPUT
        relation: any subtree whose SQL form matches a select entry
        (a group key, a projected key expression, or an aggregate)
        becomes a reference to that output column (same matching as
        ORDER BY <aggregate-expr>); everything else must decompose
        into pure functions over such matches — an unmatched leaf
        would otherwise silently bind to the wrong relation."""
        if (
            isinstance(expr, ColumnReferenceNode)
            and expr.column_index is not None
            and expr.column_index >= _HAVING_OUT_BASE
        ):
            i = expr.column_index - _HAVING_OUT_BASE
            return ColumnReferenceNode(
                expr.column_name,
                group_node.select_list[i].expr.return_type(),
                index=i,
            )
        sql_form = expr.to_sql()
        for i, sl in enumerate(group_node.select_list):
            if sl.expr.to_sql() == sql_form:
                return ColumnReferenceNode(
                    group_node.get_result_columns()[i]
                    if i < len(group_node.output_columns)
                    else sl.column_name(),
                    sl.expr.return_type(),
                    index=i,
                )
        if isinstance(expr, LiteralExpressionNode):
            return expr
        if isinstance(expr, CallExpressionNode):
            if expr.sfunction.aggregate is not None:
                raise RuntimeError_(
                    "HAVING aggregate expression must appear in the "
                    "select list"
                )
            return CallExpressionNode(
                expr.function_name,
                expr.sfunction,
                [
                    self._resolve_aggregates_to_outputs(a, group_node)
                    for a in expr.args
                ],
                expr.within_record,
            )
        if isinstance(expr, IfExpressionNode):
            return IfExpressionNode(
                self._resolve_aggregates_to_outputs(expr.cond, group_node),
                self._resolve_aggregates_to_outputs(
                    expr.true_branch, group_node
                ),
                self._resolve_aggregates_to_outputs(
                    expr.false_branch, group_node
                ),
                expr.rtype,
            )
        if isinstance(expr, IsNullExpressionNode):
            return IsNullExpressionNode(
                self._resolve_aggregates_to_outputs(expr.arg, group_node)
            )
        if isinstance(expr, RegexExpressionNode):
            return RegexExpressionNode(
                self._resolve_aggregates_to_outputs(
                    expr.subject, group_node
                ),
                expr.pattern,
            )
        # a group-key expression not in the select list: project it as
        # a HIDDEN select entry (first-row-wins over a group key IS the
        # key) — HavingNode.n_visible strips it from the result
        for g in group_node.group_exprs:
            if g.to_sql() == sql_form:
                idx = len(group_node.select_list)
                hidden = f"__having_{idx}"
                # select_list only — NOT output_columns: the final
                # ResultList slice strips the hidden column the same
                # way ORDER BY's appended sort columns are stripped
                group_node.select_list.append(
                    qn.SelectListEntry(g, alias=hidden)
                )
                return ColumnReferenceNode(
                    hidden, g.return_type(), index=idx
                )
        raise RuntimeError_(
            "HAVING expression must reference grouped columns or "
            "select-list aggregates"
        )

    def _push_within_record(self, select_entries, group_exprs, subtree):
        """Move WITHIN RECORD aggregate subexpressions into the child
        scan, which evaluates them per record (the reference runs them
        inside CSTableScan via AggregationStrategy; reference:
        sql/CSTableScan.cc:455-500). The scan switches to one-row-per-
        record emission, so outer aggregates see per-record rows."""
        if not isinstance(subtree, qn.SequentialScanNode):
            return

        def substitute(expr):
            # replace refs to scan output columns with the scan's own
            # expressions (re-rooting the subtree onto scan inputs)
            if isinstance(expr, ColumnReferenceNode):
                if expr.column_index is not None:
                    return subtree.select_list[expr.column_index].expr
                return expr
            if isinstance(expr, CallExpressionNode):
                return CallExpressionNode(
                    expr.function_name,
                    expr.sfunction,
                    [substitute(a) for a in expr.args],
                    expr.within_record,
                )
            from eventql_tpu.plan.exprs import (
                IfExpressionNode,
                IsNullExpressionNode,
                RegexExpressionNode,
            )

            if isinstance(expr, IfExpressionNode):
                return IfExpressionNode(
                    substitute(expr.cond),
                    substitute(expr.true_branch),
                    substitute(expr.false_branch),
                    expr.rtype,
                )
            if isinstance(expr, IsNullExpressionNode):
                return IsNullExpressionNode(substitute(expr.arg))
            if isinstance(expr, RegexExpressionNode):
                return RegexExpressionNode(substitute(expr.subject), expr.pattern)
            return expr

        def rewrite(expr):
            if isinstance(expr, CallExpressionNode) and expr.within_record:
                inner = substitute(expr)
                inner.within_record = False
                idx = len(subtree.select_list)
                subtree.select_list.append(qn.SelectListEntry(inner, None))
                subtree.aggr_strategy = (
                    qn.SequentialScanNode.AGGREGATE_WITHIN_RECORD_FLAT
                )
                return ColumnReferenceNode(None, expr.return_type(), idx)
            if isinstance(expr, CallExpressionNode):
                return CallExpressionNode(
                    expr.function_name,
                    expr.sfunction,
                    [rewrite(a) for a in expr.args],
                    expr.within_record,
                )
            from eventql_tpu.plan.exprs import IfExpressionNode

            if isinstance(expr, IfExpressionNode):
                return IfExpressionNode(
                    rewrite(expr.cond),
                    rewrite(expr.true_branch),
                    rewrite(expr.false_branch),
                    expr.rtype,
                )
            return expr

        for entry in select_entries:
            entry.expr = rewrite(entry.expr)
        for i in range(len(group_exprs)):
            group_exprs[i] = rewrite(group_exprs[i])

    # ------------------------------------------------------------------
    # JOIN
    # ------------------------------------------------------------------
    _JOIN_AST_TYPES = {
        "T_INNER_JOIN": (qn.JoinNode.INNER, False),
        "T_LEFT_JOIN": (qn.JoinNode.LEFT, False),
        "T_RIGHT_JOIN": (qn.JoinNode.RIGHT, False),
        "T_NATURAL_INNER_JOIN": (qn.JoinNode.INNER, True),
        "T_NATURAL_LEFT_JOIN": (qn.JoinNode.LEFT, True),
        "T_NATURAL_RIGHT_JOIN": (qn.JoinNode.RIGHT, True),
    }

    def _build_join(self, ast, tables):
        # reference: queryplanbuilder.cc:772-948 (buildJoin +
        # buildJoinTableReference)
        if ast.ntype != "T_SELECT" or len(ast.children) < 2:
            return None
        join_ast = ast.children[1]
        if join_ast.ntype not in self._JOIN_AST_TYPES:
            return None
        select_list = ast.children[0]
        where_clause = None
        if len(ast.children) > 2 and ast.children[2].ntype == "T_WHERE":
            where_clause = ast.children[2]
        return self._build_join_table_reference(
            join_ast, select_list, where_clause, tables
        )

    def _build_table_reference(self, table_ref, tables):
        """Build a plan node for one side of a join: either a nested
        join, a subquery, or a sequential scan."""
        if table_ref.ntype in self._JOIN_AST_TYPES:
            empty_sl = ASTNode("T_SELECT_LIST")
            return self._build_join_table_reference(table_ref, empty_sl, None, tables, in_join=True)
        # T_FROM node wrapping either a select (subquery) or table name
        if table_ref.ntype != "T_FROM" or not table_ref.children:
            raise RuntimeError_("corrupt AST")
        inner = table_ref.children[0]
        if inner.ntype == "T_SELECT":
            empty_sl = ASTNode("T_SELECT_LIST")
            empty_sl.append("T_ALL")
            node = self._build_subquery_table_reference(
                table_ref, empty_sl, None, tables, in_join=True
            )
            return node
        node = self._build_seqscan_table_reference(
            table_ref, ASTNode("T_SELECT_LIST"), None, tables, in_join=True
        )
        return node

    def _build_join_table_reference(
        self, table_ref, select_list, where_clause, tables, in_join=False
    ):
        join_type, natural = self._JOIN_AST_TYPES[table_ref.ntype]

        base_table = self._build_table_reference(table_ref.children[0], tables)
        joined_table = self._build_table_reference(table_ref.children[1], tables)

        join_node = qn.JoinNode(join_type, base_table, joined_table)

        # WHERE
        if where_clause is not None:
            if len(where_clause.children) != 1:
                raise RuntimeError_("corrupt AST")
            e = where_clause.children[0]
            if self._has_aggregation_expr(e):
                raise RuntimeError_(
                    "where expressions can only contain pure functions\n"
                )
            join_node.where_expr = self.build_value_expression(
                e, lambda name: join_node.get_input_column_info(name, True)
            )

        all_columns = []
        if natural:
            # reference: queryplanbuilder.cc:973-1060 — equality over all
            # common short names, remaining columns appended
            base_cols = base_table.get_available_columns()
            joined_cols = joined_table.get_available_columns()
            joined_names = {c.short_name for c in joined_cols}
            common = {}
            for col in base_cols:
                if col.short_name in joined_names and col.short_name not in common:
                    all_columns.append(col)
                    common[col.short_name] = []
            for col in base_cols + joined_cols:
                if col.short_name in common:
                    common[col.short_name].append((col.qualified_name, col.stype))
                else:
                    all_columns.append(col)

            pred = None
            for _name, variants in common.items():
                for i1 in range(len(variants)):
                    for i2 in range(len(variants)):
                        if i1 == i2:
                            continue
                        n1, t1 = variants[i1]
                        n2, t2 = variants[i2]
                        a1 = ColumnReferenceNode(
                            n1, t1, join_node.get_input_column_index(n1, True)
                        )
                        a2 = ColumnReferenceNode(
                            n2, t2, join_node.get_input_column_index(n2, True)
                        )
                        cpred = self._make_call("eq", [a1, a2])
                        pred = (
                            cpred
                            if pred is None
                            else self._make_call("logical_and", [pred, cpred])
                        )
            if pred is not None:
                join_node.join_cond = pred
        else:
            all_columns = (
                base_table.get_available_columns()
                + joined_table.get_available_columns()
            )
            if len(table_ref.children) > 2:
                cond_ast = table_ref.children[2]
                if cond_ast.ntype == "T_JOIN_CONDITION":
                    e = cond_ast.children[0]
                    if self._has_aggregation_expr(e):
                        raise RuntimeError_(
                            "JOIN conditions can only contain pure functions\n"
                        )
                    join_node.join_cond = self.build_value_expression(
                        e, lambda name: join_node.get_input_column_info(name, True)
                    )
                elif cond_ast.ntype == "T_JOIN_COLUMNLIST":
                    raise RuntimeError_("USING joins are not yet implemented")
                else:
                    raise RuntimeError_("corrupt AST")

        for sexpr in select_list.children:
            if self._has_within_record_expr(sexpr):
                raise RuntimeError_(
                    "WITHIN RECORD can't be used together with JOIN in the same"
                    " SELECT statement. consider moving the WITHIN RECORD"
                    " expression into a subquery"
                )
            if sexpr.ntype == "T_ALL":
                prefix = sexpr.token.value + "." if sexpr.token else None
                for col in all_columns:
                    if prefix and not col.qualified_name.startswith(prefix):
                        continue
                    idx = join_node.get_input_column_index(col.qualified_name, True)
                    join_node.add_select_list(
                        qn.SelectListEntry(
                            ColumnReferenceNode(col.qualified_name, col.stype, idx),
                            alias=col.short_name,
                        )
                    )
            else:
                join_node.add_select_list(
                    self._build_select_list_entry(
                        sexpr,
                        lambda name: join_node.get_input_column_info(name, True),
                    )
                )

        if join_node.join_cond is None and join_node.join_type == qn.JoinNode.INNER:
            join_node.join_type = qn.JoinNode.CARTESIAN

        return join_node

    # ------------------------------------------------------------------
    # subquery / scan / tableless select
    # ------------------------------------------------------------------
    def _build_subquery(self, ast, tables):
        # reference: queryplanbuilder.cc:687-733
        if ast.ntype != "T_SELECT" or len(ast.children) < 2:
            return None
        from_list = ast.children[1]
        if from_list.ntype != "T_FROM" or not from_list.children:
            return None
        if from_list.children[0].ntype != "T_SELECT":
            return None
        select_list = ast.children[0]
        where_clause = None
        if len(ast.children) > 2 and ast.children[2].ntype == "T_WHERE":
            where_clause = ast.children[2]
        return self._build_subquery_table_reference(
            from_list, select_list, where_clause, tables
        )

    def _build_subquery_table_reference(
        self, table_ref, select_list, where_clause, tables, in_join=False
    ):
        # reference: queryplanbuilder.cc:1156-1259
        subquery_ast = table_ref.children[0]
        subquery_alias = ""
        if (
            len(table_ref.children) > 1
            and table_ref.children[1].ntype == "T_TABLE_ALIAS"
        ):
            subquery_alias = table_ref.children[1].token.value

        subquery = self.build(subquery_ast, tables)

        def resolver(name: str):
            col = name
            if subquery_alias and col.startswith(subquery_alias + "."):
                col = col[len(subquery_alias) + 1 :]
            return subquery.get_computed_column_info(col, True)

        select_entries = []
        for sexpr in select_list.children:
            if sexpr.ntype == "T_ALL":
                for col in subquery.get_result_columns():
                    idx = subquery.get_computed_column_index(col)
                    select_entries.append(
                        qn.SelectListEntry(
                            ColumnReferenceNode(
                                col, subquery.get_column_type(idx), idx
                            ),
                            alias=col,
                        )
                    )
            else:
                select_entries.append(
                    self._build_select_list_entry(sexpr, resolver)
                )

        where_expr = None
        if not in_join and where_clause is not None:
            e = where_clause.children[0]
            if self._has_aggregation_expr(e):
                raise RuntimeError_(
                    "where expressions can only contain pure functions\n"
                )
            where_expr = self.build_value_expression(e, resolver)

        node = qn.SubqueryNode(subquery, select_entries, where_expr)
        node.alias = subquery_alias
        return node

    def _build_sequential_scan(self, ast, tables):
        # reference: queryplanbuilder.cc:633-668
        if ast.ntype != "T_SELECT" or len(ast.children) < 2:
            return None
        from_list = ast.children[1]
        if from_list.ntype != "T_FROM" or not from_list.children:
            return None
        if from_list.children[0].ntype != "T_TABLE_NAME":
            return None
        select_list = ast.children[0]
        where_clause = None
        if len(ast.children) > 2 and ast.children[2].ntype == "T_WHERE":
            where_clause = ast.children[2]
        return self._build_seqscan_table_reference(
            from_list, select_list, where_clause, tables
        )

    def _build_seqscan_table_reference(
        self, table_ref, select_list, where_clause, tables, in_join=False
    ):
        # reference: queryplanbuilder.cc:1261-1392
        tbl_name = table_ref.children[0]
        table_name = tbl_name.token.value

        table_alias = ""
        if (
            len(table_ref.children) > 1
            and table_ref.children[1].ntype == "T_TABLE_ALIAS"
        ):
            table_alias = table_ref.children[1].token.value

        table_info = tables.describe(table_name)
        if table_info is None:
            raise RuntimeError_(f"table not found: '{table_name}'")

        seqscan = qn.SequentialScanNode(table_name, table_info.columns)
        if table_alias:
            seqscan.table_alias = table_alias

        if where_clause is not None and not in_join:
            e = where_clause.children[0]
            if self._has_aggregation_expr(e):
                raise RuntimeError_(
                    "where expressions can only contain pure functions\n"
                )
            seqscan.where_expr = self.build_value_expression(
                e, lambda name: seqscan.get_input_column_info(name, True)
            )

        has_aggregation = False
        has_within_record = False
        for sexpr in select_list.children:
            if sexpr.ntype == "T_ALL":
                for cname, ctype in table_info.columns:
                    idx = seqscan.get_input_column_index(cname, True)
                    seqscan.add_select_list(
                        qn.SelectListEntry(
                            ColumnReferenceNode(cname, ctype, idx), alias=cname
                        )
                    )
            else:
                if self._has_aggregation_expr(sexpr):
                    has_aggregation = True
                if self._has_within_record_expr(sexpr):
                    has_within_record = True
                seqscan.add_select_list(
                    self._build_select_list_entry(
                        sexpr,
                        lambda name: seqscan.get_input_column_info(name, True),
                    )
                )

        if has_aggregation and has_within_record:
            raise RuntimeError_(
                "invalid use of aggregation WITHIN RECORD functions"
            )
        if has_aggregation:
            seqscan.aggr_strategy = qn.SequentialScanNode.AGGREGATE_ALL
        if has_within_record:
            seqscan.aggr_strategy = (
                qn.SequentialScanNode.AGGREGATE_WITHIN_RECORD_FLAT
            )

        seqscan.normalize_column_names()
        return seqscan

    def _build_select_expression(self, ast):
        # reference: queryplanbuilder.cc:735-770
        if ast.ntype != "T_SELECT" or len(ast.children) != 1:
            return None
        select_list = ast.children[0]
        entries = []
        for sexpr in select_list.children:
            if sexpr.ntype == "T_ALL":
                raise RuntimeError_(
                    "Illegal use of wildcard * in free SELECT expression"
                )
            if self._has_aggregation_expr(sexpr) or self._has_within_record_expr(
                sexpr
            ):
                raise RuntimeError_(
                    "a SELECT without any tables can only contain pure functions"
                )
            entries.append(self._build_select_list_entry(sexpr, _empty_resolver))
        return qn.SelectExpressionNode(entries)

    # ------------------------------------------------------------------
    # value expressions
    # ------------------------------------------------------------------
    def _build_select_list_entry(self, ast, resolver) -> qn.SelectListEntry:
        # reference: buildSelectList (queryplanbuilder.cc:1725-1745)
        if not ast.children:
            raise RuntimeError_("internal error: corrupt ast")
        expr = self.build_value_expression(ast.children[0], resolver)
        alias = None
        if (
            ast.ntype == "T_DERIVED_COLUMN"
            and len(ast.children) > 1
            and ast.children[1].ntype == "T_COLUMN_ALIAS"
        ):
            alias = ast.children[1].token.value
        return qn.SelectListEntry(expr, alias)

    def build_value_expression(
        self, ast: ASTNode, resolver: ColumnResolver
    ) -> ValueExpressionNode:
        expr = self._build_unoptimized_value_expression(ast, resolver)
        if self.enable_constant_folding:
            expr = self.fold_constants(expr)
        return expr

    def fold_constants(self, expr: ValueExpressionNode) -> ValueExpressionNode:
        # reference: QueryTreeUtil::foldConstants (QueryTreeUtil.cc:46-57)
        if is_constant(expr) and not isinstance(expr, LiteralExpressionNode):
            return LiteralExpressionNode(evaluate_scalar(expr))
        return expr

    def _build_unoptimized_value_expression(self, ast, resolver):
        # reference: queryplanbuilder.cc:1408-1498
        t = ast.ntype

        fn_name = _OPERATOR_FN.get(t)
        if fn_name is not None:
            args = [
                self.build_value_expression(c, resolver) for c in ast.children
            ]
            return self._make_call(fn_name, args)

        if t == "T_REGEX_EXPR":
            return self._build_regex(ast, resolver)
        if t == "T_LIKE_EXPR":
            return self._build_like(ast, resolver)
        if t == "T_LITERAL":
            return self._build_literal(ast)
        if t == "T_VOID":
            return LiteralExpressionNode(SValue.new_null())
        if t == "T_IF_EXPR":
            args = [
                self.build_value_expression(c, resolver) for c in ast.children
            ]
            if len(args) != 3:
                raise RuntimeError_("if statement must have exactly 3 arguments")
            if args[0].return_type() != SType.BOOL:
                raise RuntimeError_("conditional of if statment must return bool")
            if args[1].return_type() != args[2].return_type():
                raise RuntimeError_(
                    "if statement branches return different types"
                )
            return IfExpressionNode(
                args[0], args[1], args[2], args[1].return_type()
            )
        if t == "T_COLUMN_NAME":
            return self._build_column_reference(ast, resolver)
        if t == "T_COLUMN_INDEX":
            raise RuntimeError_(
                "internal error: invalid column index reference"
            )
        if t == "T_TABLE_NAME":
            return self._build_column_reference(ast.children[0], resolver)
        if t in ("T_METHOD_CALL", "T_METHOD_CALL_WITHIN_RECORD"):
            return self._build_method_call(ast, resolver)

        raise RuntimeError_("internal error: can't build expression")

    def _build_literal(self, ast) -> LiteralExpressionNode:
        # reference: buildLiteral (queryplanbuilder.cc:1500-1545)
        token = ast.token
        if token is None:
            raise RuntimeError_("internal error: corrupt ast")
        tt = token.ttype
        if tt == "T_TRUE":
            v = SValue.new_bool(True)
        elif tt == "T_FALSE":
            v = SValue.new_bool(False)
        elif tt == "T_NUMERIC":
            s = token.value
            if "." not in s:
                v = SValue.new_uint64(int(s)) if "-" not in s else SValue.new_int64(int(s))
            else:
                v = SValue.new_float64(float(s))
        elif tt == "T_STRING":
            v = SValue.new_string(token.value)
        elif tt == "T_NULL":
            v = SValue.new_null()
        else:
            raise RuntimeError_("can't cast Token to SValue")
        return LiteralExpressionNode(v)

    def _build_column_reference(self, ast, resolver):
        # reference: buildColumnReference (queryplanbuilder.cc:1620-1650)
        parts = []
        cur = ast
        while cur is not None and cur.token is not None:
            parts.append(cur.token.value)
            if len(cur.children) != 1:
                break
            cur = cur.children[0]
        column_name = ".".join(parts)
        idx, stype = resolver(column_name)
        if idx == qn.NOT_FOUND:
            raise RuntimeError_(f"column(s) not found: '{column_name}'")
        return ColumnReferenceNode(column_name, stype, idx)

    def _build_method_call(self, ast, resolver):
        if ast.token is None or ast.token.ttype != "T_IDENTIFIER":
            raise RuntimeError_("corrupt AST")
        symbol = ast.token.value
        args = [self.build_value_expression(c, resolver) for c in ast.children]

        if symbol.lower() == "isnull" and len(args) == 1:
            return IsNullExpressionNode(args[0])

        within = ast.ntype == "T_METHOD_CALL_WITHIN_RECORD"
        return self._make_call(symbol, args, within_record=within)

    def _make_call(self, name, args, within_record=False) -> CallExpressionNode:
        # reference: CallExpressionNode::newNode (CallExpressionNode.cc:32-101)
        # — resolve overload, then physically wrap mismatched args in
        # to_<typename> conversion calls
        arg_types = [a.return_type() for a in args]
        fn = self.registry.resolve(name, arg_types)

        converted = []
        for arg, want in zip(args, fn.arg_types):
            if arg.return_type() == want:
                converted.append(arg)
            else:
                from eventql_tpu.core.types import sql_typename

                conv_name = "to_" + sql_typename(want)
                conv_fn = self.registry.resolve(conv_name, [arg.return_type()])
                converted.append(CallExpressionNode(conv_name, conv_fn, [arg]))

        return CallExpressionNode(name, fn, converted, within_record=within_record)

    def _build_regex(self, ast, resolver):
        # reference: buildRegex (queryplanbuilder.cc:1676-1698)
        if len(ast.children) != 2:
            raise RuntimeError_("internal error: corrupt ast")
        pat = ast.children[1]
        if (
            pat.ntype != "T_LITERAL"
            or pat.token is None
            or pat.token.ttype != "T_STRING"
        ):
            raise RuntimeError_(
                "second argument to REGEX operator must be a string literal"
            )
        subject = self.build_value_expression(ast.children[0], resolver)
        return RegexExpressionNode(subject, pat.token.value)

    def _build_like(self, ast, resolver):
        if len(ast.children) != 2:
            raise RuntimeError_("internal error: corrupt ast")
        pat = ast.children[1]
        if (
            pat.ntype != "T_LITERAL"
            or pat.token is None
            or pat.token.ttype != "T_STRING"
        ):
            raise RuntimeError_(
                "second argument to LIKE operator must be a string literal"
            )
        subject = self.build_value_expression(ast.children[0], resolver)
        return LikeExpressionNode(subject, pat.token.value)
