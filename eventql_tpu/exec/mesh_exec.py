"""SQL execution on a multi-device mesh (the mesh tier, reachable from SQL).

`try_execute_mesh_groupby` compiles Scan→Filter→GroupBy into ONE XLA
program over the provider's `jax.sharding.Mesh`: per-shard columnar
expression eval + partial aggregation (shard_map), an all-gather of the
fixed-width partial group tables between devices, and a replicated merge —
the collective replaces the reference's QUERY_PARTIALAGGR RPC fan-out
and coordinator accumulator merge (reference:
server/sql/scheduler.cc:55-264, sql/statements/select/groupby.cc:
504-714, vm.cc:274-326 mergeInstance).

Parity contract (same as the single-chip device route,
exec/device_exec.py): group identity folds value bits + a null tag per
key; NULL numeric payloads are stored as 0 so aggregates see them the
way the reference's tag-ignoring stack pops do (svalue.cc:928-934);
group output order is first-occurrence order (global row id, merged as
a min-plane); non-aggregated select entries are first-row-wins
evaluated on the HOST from the gathered first rows (groupby.cc:161-172).
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np

from eventql_tpu.core.types import SType
from eventql_tpu.exec import jax_expr
from eventql_tpu.exec.relation import Column, Relation, dtype_for
from eventql_tpu.plan import nodes as qn
from eventql_tpu.plan.exprs import CallExpressionNode, has_aggregate_call

# route counters (tests assert the mesh tier actually executed)
MESH_GROUPBY_RUNS = 0
MESH_TOPK_RUNS = 0
MESH_ORDER_RUNS = 0
MESH_JOIN_RUNS = 0
# ORDER BY served by the padded-bucket sample sort (vs the bitonic)
MESH_BUCKET_SORT_RUNS = 0

_MERGE_KIND = {"count": "sum", "sum": "sum", "min": "min", "max": "max"}


def _mesh_distinct_counts(mask, keys, dv, axis, nd, op):
    """COUNT(DISTINCT dv) per key group over the mesh, from inside a
    shard_map trace: locally deduplicate the (keys..., value) pairs
    (one sort — the per-shard analog of the reference's hash-set
    accumulator, aggregate.cc:74-120), all-gather the deduplicated
    pair tables across the mesh, and recount replicated. Group order equals
    masked_grouped_aggregate's (ascending key), so callers align the
    output positionally with their merged group table. Shared by the
    groupby and join mesh routes (review finding: two diverging copies
    of this sentinel/dedup logic)."""
    import jax
    import jax.numpy as jnp

    from eventql_tpu.kernels.groupby import (
        masked_grouped_count_distinct,
        sortable_u64,
    )
    from eventql_tpu.parallel.distributed import _xch_all_gather

    local_n = dv.shape[0]
    iota_l = jnp.arange(local_n, dtype=jnp.int64)
    sentinel = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    keyed = [
        jnp.where(mask, sortable_u64(k), sentinel) for k in keys
    ] + [jnp.where(mask, sortable_u64(dv), sentinel)]
    sorted_ops = jax.lax.sort(keyed + [iota_l], num_keys=len(keyed))
    perm = sorted_ops[-1]
    diff = jnp.zeros(local_n, dtype=jnp.bool_)
    for sk in sorted_ops[:-1]:
        diff = diff | jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), sk[1:] != sk[:-1]]
        )
    keep = diff & mask[perm]
    keys_dedup = tuple(k[perm] for k in keys)
    vals_dedup = dv[perm]
    keep_all = _xch_all_gather(keep, axis, nd, op=op, tiled=True)
    keys_all = tuple(
        _xch_all_gather(k, axis, nd, op=op, tiled=True)
        for k in keys_dedup
    )
    vals_all = _xch_all_gather(vals_dedup, axis, nd, op=op, tiled=True)
    return masked_grouped_count_distinct(keep_all, keys_all, vals_all)


def _mesh_groupby_eligible(node: qn.GroupByNode) -> bool:
    from eventql_tpu.exec.device_exec import device_plan_eligible

    if not device_plan_eligible(node):
        return False
    scan = node.table
    if not isinstance(scan, qn.SequentialScanNode):
        return False
    if not scan.input_columns:
        # no referenced columns (SELECT count(1) FROM t): nothing to
        # shard; the host engine is the right executor
        return False
    # reject STRING-typed min/max aggregate args: the device plane
    # would carry dictionary ids and the output column needs its
    # dictionary reattached — host path handles it
    from eventql_tpu.exec.operators import _strip_aggregates

    for sl in node.select_list:
        if has_aggregate_call(sl.expr):
            aggs: List[CallExpressionNode] = []
            _strip_aggregates(sl.expr, aggs)
            for a in aggs:
                kind = a.sfunction.aggregate.kind
                if (
                    kind in ("min", "max", "sum", "mean")
                    and a.args
                    and a.args[0].return_type() == SType.STRING
                ):
                    return False
    return True


def try_execute_mesh_groupby(
    node: qn.GroupByNode, txn, partial: bool = False
):
    """Scan→Filter→GroupBy over the mesh; None → caller falls back.

    partial=True returns a GroupByPartial (operators.GroupByPartial —
    the mergeable accumulator-state form the cluster tier ships as
    QUERY_PARTIALAGGR results) instead of a final Relation: this is
    the TCP-over-mesh composition — a cluster worker aggregates its
    local shard ON ITS MESH and only O(groups) states cross hosts
    (reference: PartialGroupByExpression feeding GroupByMerge,
    groupby.cc:438-714). count_distinct partials need the distinct
    VALUE SETS (not counts) for cross-host dedup, so those plans fall
    back to the host partial path."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from eventql_tpu.exec.device_exec import (
        _batched_device_get,
        _cached_jit,
        _device_compact_groups,
        _n_scalar,
        _plan_fingerprint_cached,
    )
    from eventql_tpu.exec.operators import _strip_aggregates
    from eventql_tpu.exec.vector_eval import EvalContext, evaluate_vector
    from eventql_tpu.kernels.groupby import (
        f64_sort_bits,
        masked_grouped_aggregate,
        masked_grouped_count_distinct,
        sortable_u64,
    )

    if not isinstance(node, qn.GroupByNode):
        return None
    if not _mesh_groupby_eligible(node):
        return None

    provider = txn.tables
    mesh, axis = provider.mesh, provider.axis
    scan: qn.SequentialScanNode = node.table
    table = txn.get_table_data(scan.table_name)
    n = table.num_rows
    if n == 0:
        return None
    from eventql_tpu.exec.device_exec import _scan_inputs_present

    if not _scan_inputs_present(table, scan):
        return None

    in_cols, n, n_p = provider.sharded_scan_columns(
        scan.table_name, scan.input_columns
    )
    stypes = [c.stype for c in in_cols]

    # gather aggregate calls; build value-plane layout
    entries = []
    all_aggs: List[CallExpressionNode] = []
    for sl in node.select_list:
        if has_aggregate_call(sl.expr):
            aggs: List[CallExpressionNode] = []
            emit = _strip_aggregates(sl.expr, aggs)
            base = len(all_aggs)
            all_aggs.extend(aggs)
            entries.append(("agg", emit, base, len(aggs)))
        else:
            entries.append(("first", sl.expr, None, 0))

    if partial and any(
        a.sfunction.aggregate.kind == "count_distinct" for a in all_aggs
    ):
        return None  # partial distinct needs value sets: host path

    # slot spec per aggregate: where its result comes from after merge
    plane_kinds: List[str] = []      # local kinds, one per main plane
    plane_exprs: List = []           # arg expr per plane (None = count)
    slots = []                       # ("plane", i) | ("mean", s, c) | ("distinct", j)
    distinct_exprs: List = []
    for a in all_aggs:
        kind = a.sfunction.aggregate.kind
        arg = a.args[0] if a.args else None
        if kind == "count":
            slots.append(("plane", len(plane_kinds)))
            plane_kinds.append("count")
            plane_exprs.append(None)
        elif kind == "mean":
            slots.append(("mean", len(plane_kinds), len(plane_kinds) + 1))
            plane_kinds.extend(["sum", "count"])
            plane_exprs.extend([("f64", arg), None])
        elif kind == "count_distinct":
            slots.append(("distinct", len(distinct_exprs)))
            distinct_exprs.append(arg)
        else:  # sum / min / max
            slots.append(("plane", len(plane_kinds)))
            plane_kinds.append(kind)
            plane_exprs.append(("native", arg))

    merge_kinds = tuple(_MERGE_KIND[k] for k in plane_kinds)
    nd = int(mesh.shape[axis])

    def make_program():
        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(
                tuple(P(axis) for _ in in_cols),
                tuple(P(axis) for _ in in_cols),
                P(),
            ),
            out_specs=(tuple(P() for _ in plane_kinds), P(), P(),
                       tuple(P() for _ in distinct_exprs)),
            check_vma=False,  # merge of gathered partials is replicated
        )
        def step(datas, valids, n_real):
            local_n = datas[0].shape[0]
            in_cols_l = [
                jax_expr.DeviceCol(st, d, v)
                for st, d, v in zip(stypes, datas, valids)
            ]
            scan_cols = [
                jax_expr.compile_expr(sl.expr, in_cols_l, local_n)
                for sl in scan.select_list
            ]
            if scan.where_expr is not None:
                mask = jax_expr.compile_expr(
                    scan.where_expr, in_cols_l, local_n
                ).data
            else:
                mask = jnp.ones((local_n,), jnp.bool_)
            shard_i = jax.lax.axis_index(axis).astype(jnp.int64)
            g0 = shard_i * jnp.int64(local_n)
            global_iota = g0 + jnp.arange(local_n, dtype=jnp.int64)
            mask = mask & (global_iota < n_real)

            key_cols = [
                jax_expr.compile_expr(g, scan_cols, local_n)
                for g in node.group_exprs
            ]
            if not key_cols:
                key_cols = [
                    jax_expr.DeviceCol(
                        SType.UINT64,
                        jnp.zeros((local_n,), jnp.uint64),
                        jnp.ones((local_n,), jnp.bool_),
                    )
                ]

            def key_bits(k):
                if k.data.dtype == jnp.float64:
                    bits = f64_sort_bits(k.data)
                else:
                    bits = k.data.astype(jnp.uint64)
                return jnp.where(k.valid, bits, jnp.uint64(0))

            key_arrays = tuple(key_bits(k) for k in key_cols)
            null_keys = tuple(
                (~k.valid).astype(jnp.uint64) for k in key_cols
            )
            keys = key_arrays + null_keys

            # main value planes
            planes = []
            for kind, spec in zip(plane_kinds, plane_exprs):
                if spec is None:
                    planes.append(jnp.zeros((local_n,), jnp.uint64))
                else:
                    how, arg = spec
                    c = jax_expr.compile_expr(arg, scan_cols, local_n)
                    planes.append(
                        c.data.astype(jnp.float64) if how == "f64" else c.data
                    )
            if not planes:
                planes = [jnp.zeros((local_n,), jnp.uint64)]
                local_kinds = ("count",)
                mkinds = ("sum",)
            else:
                local_kinds = tuple(plane_kinds)
                mkinds = merge_kinds

            gk, outs, first_local, ng_l = masked_grouped_aggregate(
                mask, keys, tuple(planes), local_kinds
            )
            valid_l = jnp.arange(local_n, dtype=jnp.int64) < ng_l
            first_global = g0 + first_local

            # exchange fixed-width partial tables between devices
            from eventql_tpu.parallel.distributed import _xch_all_gather

            gk_all = tuple(
                _xch_all_gather(k, axis, nd, op="sql_groupby_gather",
                                tiled=True)
                for k in gk
            )
            outs_all = tuple(
                _xch_all_gather(o, axis, nd, op="sql_groupby_gather",
                                tiled=True)
                for o in outs
            )
            first_all = _xch_all_gather(
                first_global, axis, nd, op="sql_groupby_gather", tiled=True
            )
            valid_all = _xch_all_gather(
                valid_l, axis, nd, op="sql_groupby_gather", tiled=True
            )

            # replicated merge (the GroupByMerge step)
            _mk, mouts, _mf, mng = masked_grouped_aggregate(
                valid_all, gk_all, outs_all + (first_all,),
                mkinds + ("min",),
            )
            main_out = mouts[:-1] if plane_kinds else ()

            # count_distinct planes: locally deduplicated (key, value)
            # pair tables exchange, replicated recount — the local
            # dedup is the per-shard hash set of the reference's
            # count_distinct accumulator (aggregate.cc:74-120)
            # group sets match the main pass (count groups every
            # masked row), both compacted in ascending key order ->
            # positional alignment with the merged table
            dcounts = [
                _mesh_distinct_counts(
                    mask, keys,
                    jax_expr.compile_expr(
                        arg, scan_cols, local_n
                    ).data.astype(jnp.uint64),
                    axis, nd, "sql_distinct_gather",
                )
                for arg in distinct_exprs
            ]

            return tuple(main_out), mouts[-1], mng, tuple(dcounts)

        def program(col_data, col_valid, n_real):
            return step(col_data, col_valid, n_real)

        return program

    key = (
        "mesh_groupby",
        _plan_fingerprint_cached(node),
        tuple(int(st) for st in stypes),
        nd,
        id(mesh),
        n_p,
    )
    fn = _cached_jit(key, make_program)
    col_data = tuple(c.data for c in in_cols)
    col_valid = tuple(c.valid for c in in_cols)
    main_out, first_global, ng, dcounts = fn(
        col_data, col_valid, _n_scalar(n)
    )
    ng = int(ng)
    if ng == 0:
        # empty group table: the host path builds the correct typed
        # empty relation / ungrouped-aggregate row semantics
        return None

    # O(groups) compaction before readback
    planes_list = list(main_out) + list(dcounts)
    compact, first_small, _rd, _rv = _device_compact_groups(
        planes_list, first_global, (), (), n, ng, False
    )
    got = _batched_device_get((list(compact), first_small))
    planes_h = [a[:ng] for a in got[0]]
    first_h = np.asarray(got[1])[:ng]

    main_h = planes_h[: len(plane_kinds)]
    dist_h = planes_h[len(plane_kinds):]

    # host group order: first global occurrence (groupby.cc hash-order
    # replaced by deterministic first-row order, same as the host engine)
    order = np.argsort(first_h, kind="stable")
    firsts_ordered = first_h[order].astype(np.int64)

    agg_cols: List[Column] = []
    for a, slot in zip(all_aggs, slots):
        rtype = a.sfunction.return_type
        if slot[0] == "plane":
            arr = main_h[slot[1]]
        elif slot[0] == "mean":
            s = main_h[slot[1]].astype(np.float64)
            c = main_h[slot[2]].astype(np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                arr = s / c
        else:
            arr = dist_h[slot[1]]
        agg_cols.append(
            Column(rtype, arr.astype(dtype_for(rtype)), np.ones(ng, bool))
        )
    agg_cols = [c.gather(order) for c in agg_cols]

    # first-row-wins select entries: evaluate on the HOST over the
    # gathered first rows (exact host semantics incl. strings)
    scan_host_cols = None
    if partial or any(kind == "first" for (kind, _e, _b, _n) in entries):
        by_name = dict(zip(table.names, table.columns))
        mini = [
            by_name[cname].gather(firsts_ordered)
            for cname, _t in scan.input_columns
        ]
        ctx_in = EvalContext(mini, ng)
        scan_host_cols = [
            evaluate_vector(sl.expr, ctx_in) for sl in scan.select_list
        ]

    global MESH_GROUPBY_RUNS
    if partial:
        # GroupByPartial: mergeable per-kind accumulator states, the
        # wire form the cluster tier serializes (cluster.py
        # partial_to_bytes) — mean stays decomposed as [sum, count]
        from eventql_tpu.exec.operators import GroupByPartial

        ctx_keys = EvalContext(scan_host_cols, ng)
        key_cols = [
            evaluate_vector(g, ctx_keys) for g in node.group_exprs
        ]
        p_entries = []
        for (kind, expr, base, nags) in entries:
            if kind == "first":
                ctx = EvalContext(scan_host_cols, ng)
                p_entries.append(
                    ("first", evaluate_vector(expr, ctx))
                )
                continue
            states = []
            for a, slot in zip(
                all_aggs[base : base + nags], slots[base : base + nags]
            ):
                akind = a.sfunction.aggregate.kind
                if slot[0] == "mean":
                    s_col = Column(
                        SType.FLOAT64,
                        main_h[slot[1]][order].astype(np.float64),
                        np.ones(ng, bool),
                    )
                    c_col = Column(
                        SType.UINT64,
                        main_h[slot[2]][order].astype(np.uint64),
                        np.ones(ng, bool),
                    )
                    states.append(("mean", [s_col, c_col]))
                else:
                    rtype = (
                        SType.UINT64
                        if akind == "count"
                        else a.sfunction.return_type
                    )
                    states.append(
                        (
                            akind,
                            [
                                Column(
                                    rtype,
                                    main_h[slot[1]][order].astype(
                                        dtype_for(rtype)
                                    ),
                                    np.ones(ng, bool),
                                )
                            ],
                        )
                    )
            p_entries.append(
                ("agg", expr, states, all_aggs[base : base + nags])
            )
        MESH_GROUPBY_RUNS += 1
        return GroupByPartial(key_cols, ng, p_entries)

    out_cols: List[Column] = []
    for (kind, expr, base, _nags) in entries:
        if kind == "agg":
            ctx = EvalContext(agg_cols[base:], ng)
            out_cols.append(evaluate_vector(expr, ctx))
        else:
            ctx = EvalContext(scan_host_cols, ng)
            out_cols.append(evaluate_vector(expr, ctx))

    MESH_GROUPBY_RUNS += 1
    names = [sl.column_name() for sl in node.select_list]
    return Relation(names, out_cols, ng)


# -- ORDER BY [LIMIT] over the mesh ------------------------------------


def _mesh_order_analysis(order_node: qn.OrderByNode, txn):
    """Host-side analysis shared by the mesh ORDER BY routes: plan
    eligibility, string null-rank precomputation, and exact host float
    keys. Mirrors the single-chip _prep_device_scan_order analysis
    (exec/device_exec.py) but leaves all device placement to the
    caller, which shards inputs over the mesh instead of one chip.

    Returns (scan, table, n, needed, null_ranks, host_keys) or None;
    host_keys[i] is a precomputed uint64 host-order key array for
    FLOAT64 plain-ref specs (exact IEEE bit order regardless of the
    device's f64 emulation), else None."""
    import bisect

    from eventql_tpu.exec.device_exec import (
        _dictionary_sorted,
        _host_float_order_key,
    )
    from eventql_tpu.plan.exprs import ColumnReferenceNode

    scan = order_node.table
    if not isinstance(scan, qn.SequentialScanNode):
        return None
    if scan.aggr_strategy != qn.SequentialScanNode.NO_AGGREGATION:
        return None
    if scan.keyrange is not None:
        return None  # partition-scoped: host path applies the range
    specs = order_node.sort_specs
    if not specs:
        return None
    if not scan.input_columns:
        return None
    if scan.where_expr is not None and not jax_expr.expr_is_device_compatible(
        scan.where_expr
    ):
        return None

    needed = set()
    stack = [s.expr for s in specs]
    while stack:
        e = stack.pop()
        if isinstance(e, ColumnReferenceNode):
            if e.column_index is None or e.column_index >= len(
                scan.select_list
            ):
                return None
            needed.add(e.column_index)
        stack.extend(e.arguments())
    for s in specs:
        if not jax_expr.expr_is_device_compatible(s.expr):
            return None
        if s.expr.return_type() == SType.STRING and not isinstance(
            s.expr, ColumnReferenceNode
        ):
            return None
    for i in needed:
        e = scan.select_list[i].expr
        if not jax_expr.expr_is_device_compatible(e):
            return None
        if e.return_type() == SType.STRING and not isinstance(
            e, ColumnReferenceNode
        ):
            return None

    table = txn.get_table_data(scan.table_name)
    n = table.num_rows
    if n == 0:
        return None
    from eventql_tpu.exec.device_exec import _scan_inputs_present

    if not _scan_inputs_present(table, scan):
        return None
    name_to_col = dict(zip(table.names, table.columns))

    null_ranks = [None] * len(specs)
    host_keys = [None] * len(specs)
    # static [lo, hi] bounds on each u64 host-order key (pre-descending
    # flip), same derivation as the single-chip route: string ranks
    # bounded by the dictionary size, plain numeric refs by their
    # physically-narrowed dtype. Bounded keys let multi-key specs PACK
    # into one u64 for the bucket-sort path.
    from eventql_tpu.exec.device_exec import _narrow_np

    _M64 = 0xFFFFFFFFFFFFFFFF
    _NARROW_BOUNDS = {
        np.dtype(np.uint16): (0, 0xFFFF),
        np.dtype(np.uint32): (0, 0xFFFFFFFF),
        np.dtype(np.int16): (
            (1 << 63) - (1 << 15), (1 << 63) + (1 << 15) - 1
        ),
        np.dtype(np.int32): (
            (1 << 63) - (1 << 31), (1 << 63) + (1 << 31) - 1
        ),
        np.dtype(np.bool_): (0, 1),
    }
    bounds = [None] * len(specs)
    for si, s in enumerate(specs):
        rt = s.expr.return_type()
        if rt == SType.STRING:
            inner = scan.select_list[s.expr.column_index].expr
            if not isinstance(inner, ColumnReferenceNode):
                return None
            src = name_to_col[scan.input_columns[inner.column_index][0]]
            if src.dictionary is None or not _dictionary_sorted(src):
                return None
            entries = list(src.dictionary.astype(bytes))
            null_ranks[si] = bisect.bisect_right(entries, b"NULL")
            bounds[si] = (0, len(entries))
        elif rt == SType.FLOAT64 and isinstance(s.expr, ColumnReferenceNode):
            inner = scan.select_list[s.expr.column_index].expr
            if isinstance(inner, ColumnReferenceNode):
                src = name_to_col[scan.input_columns[inner.column_index][0]]
                host_keys[si] = _host_float_order_key(src, s.descending)
        elif rt != SType.FLOAT64 and isinstance(s.expr, ColumnReferenceNode):
            inner = scan.select_list[s.expr.column_index].expr
            if isinstance(inner, ColumnReferenceNode) and (
                inner.column_index is not None
            ):
                src = name_to_col[scan.input_columns[inner.column_index][0]]
                bounds[si] = _NARROW_BOUNDS.get(_narrow_np(src).dtype)
        if bounds[si] is not None and s.descending:
            lo, hi = bounds[si]
            bounds[si] = ((~hi) & _M64, (~lo) & _M64)
    return scan, table, n, needed, null_ranks, host_keys, bounds


def _mesh_sharded_hostkeys(provider, host_keys, n, n_p):
    """Pad + shard the precomputed host float keys over the mesh,
    cached per (host array identity, pad) on the provider — a repeated
    float-key ORDER BY was re-transferring the whole key column per
    query while integer keys rode the warm shard cache (review
    finding). The host arrays themselves cache on the Column
    (_host_float_order_key), so identity is stable across queries."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    sharding = NamedSharding(provider.mesh, P(provider.axis))
    out = []
    for hk in host_keys:
        if hk is None:
            continue
        key = ("hostkey", id(hk), n_p)
        cached = provider._shard_cache.get(key)
        if cached is None:
            padded = np.pad(hk, (0, n_p - n)) if n_p > n else hk
            cached = (jax.device_put(padded, sharding),)
            provider._shard_cache[key] = cached
        out.append(cached[0])
    return tuple(out)


def _mesh_keys_in_shard(specs, scan_cols, null_ranks, hostkey_planes,
                        host_keys, local_n):
    """Per-shard sort-key construction: precomputed host planes where
    available, else the device host-order key transform."""
    from eventql_tpu.exec.device_exec import _device_host_order_key

    keys = []
    hk_i = 0
    for si, s in enumerate(specs):
        if host_keys[si] is not None:
            keys.append(hostkey_planes[hk_i])
            hk_i += 1
        else:
            c = jax_expr.compile_expr(s.expr, scan_cols, local_n)
            keys.append(
                _device_host_order_key(c, s.descending, null_ranks[si])
            )
    return keys


def try_execute_mesh_scan_topk(node: qn.LimitNode, txn) -> Optional[Relation]:
    """SELECT ... [WHERE] ORDER BY ... LIMIT k over the mesh: per-shard
    top-k of the host-order key, an O(k*P) candidate all-gather over
    the mesh, and a replicated tie-exact re-selection — the exchange is
    independent of table size (the reference streams EVERY row to the
    coordinator and std::sorts, orderby.cc:58-168). Only the k winning
    global row ids leave the device; the host materializes those rows.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from eventql_tpu.exec.device_exec import (
        _batched_device_get,
        _cached_jit,
        _emit_scan_rows,
        _n_scalar,
        _plan_fingerprint_cached,
    )
    from eventql_tpu.parallel.distributed import _xch_all_gather, _xch_psum

    order_node = node.table
    if not isinstance(order_node, qn.OrderByNode):
        return None
    w = node.offset + node.limit
    if w == 0:
        return None
    prep = _mesh_order_analysis(order_node, txn)
    if prep is None:
        return None
    scan, table, n, needed, null_ranks, host_keys, _bounds = prep
    specs = order_node.sort_specs
    if len(specs) != 1:
        # multi-key: the full mesh sort route handles it — with the
        # LIMIT window pushed down so only the window's rows
        # host-materialize (review finding: the k-row query paid an
        # O(n) emit)
        return try_execute_mesh_scan_order(
            order_node, txn,
            window=(node.offset, node.offset + node.limit),
        )

    provider = txn.tables
    mesh, axis = provider.mesh, provider.axis
    in_cols, n, n_p = provider.sharded_scan_columns(
        scan.table_name, scan.input_columns
    )
    stypes = [c.stype for c in in_cols]
    hostkey_planes = _mesh_sharded_hostkeys(provider, host_keys, n, n_p)
    nd = int(mesh.shape[axis])
    w_eff = min(w, n)

    def make_program():
        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(
                tuple(P(axis) for _ in in_cols),
                tuple(P(axis) for _ in in_cols),
                tuple(P(axis) for _ in hostkey_planes),
                P(),
            ),
            out_specs=(P(), P(), P(), P()),
            check_vma=False,
        )
        def step(datas, valids, hkeys, n_real):
            local_n = datas[0].shape[0]
            in_cols_l = [
                jax_expr.DeviceCol(st, d, v)
                for st, d, v in zip(stypes, datas, valids)
            ]
            scan_cols = [None] * len(scan.select_list)
            for i in needed:
                scan_cols[i] = jax_expr.compile_expr(
                    scan.select_list[i].expr, in_cols_l, local_n
                )
            if scan.where_expr is not None:
                mask = jax_expr.compile_expr(
                    scan.where_expr, in_cols_l, local_n
                ).data
            else:
                mask = jnp.ones((local_n,), jnp.bool_)
            shard_i = jax.lax.axis_index(axis).astype(jnp.int64)
            g0 = shard_i * jnp.int64(local_n)
            gidx = g0 + jnp.arange(local_n, dtype=jnp.int64)
            mask = mask & (gidx < n_real)

            (k0,) = _mesh_keys_in_shard(
                specs, scan_cols, null_ranks, hkeys, host_keys, local_n
            )
            # host-FIRST row <-> LARGEST flipped key; filtered rows
            # forced to 0 (single-chip convention, device_exec)
            ktop = jnp.where(mask, ~k0, jnp.uint64(0))
            npz = _xch_psum(
                jnp.sum(mask & (ktop == 0), dtype=jnp.int64), axis, nd,
                op="topk_npz",
            )

            kk = min(w_eff, local_n)
            top_vals, top_pos = jax.lax.top_k(ktop, kk)
            top_idx = gidx[top_pos]
            top_mask = mask[top_pos]
            all_vals = _xch_all_gather(
                top_vals, axis, nd, op="sql_topk_gather", tiled=True
            )
            all_idx = _xch_all_gather(
                top_idx, axis, nd, op="sql_topk_gather", tiled=True
            )
            all_mask = _xch_all_gather(
                top_mask, axis, nd, op="sql_topk_gather", tiled=True
            )
            # tie-exact final selection: host order is (key desc,
            # global row asc) — a lexicographic sort, not a value-only
            # top_k (value ties at the boundary must break toward the
            # LOWEST global row id across shards)
            s_vals, s_idx, s_mask = jax.lax.sort(
                [~all_vals, all_idx, all_mask.astype(jnp.int32)],
                num_keys=2,
            )
            return (
                (~s_vals)[:w_eff],
                s_idx[:w_eff],
                s_mask[:w_eff].astype(jnp.bool_),
                npz,
            )

        def program(col_data, col_valid, hkeys, n_real):
            return step(col_data, col_valid, hkeys, n_real)

        return program

    key = (
        "mesh_topk",
        _plan_fingerprint_cached(order_node),
        tuple(int(st) for st in stypes),
        nd,
        id(mesh),
        n_p,
        w_eff,
    )
    fn = _cached_jit(key, make_program)
    f_vals, f_idx, f_mask, npz = fn(
        tuple(c.data for c in in_cols),
        tuple(c.valid for c in in_cols),
        hostkey_planes,
        _n_scalar(n),
    )
    f_vals_h, f_idx_h, f_mask_h, npz_h = _batched_device_get(
        (f_vals, f_idx, f_mask, npz)
    )
    lo, hi = node.offset, node.offset + node.limit
    global MESH_TOPK_RUNS
    if bool(f_mask_h.all()):
        MESH_TOPK_RUNS += 1
        return _emit_scan_rows(scan, table, f_idx_h, lo, hi)
    # filtered rows inside the window: exact iff every passing
    # zero-key row was captured (rows beyond then all have key 0).
    # f_vals_h ARE the flipped ktop values (larger = host-first), so
    # zero-key rows are f_vals_h == 0 — NOT ~f_vals_h == 0, which
    # counted the host-FIRST rows and let a displaced passing zero-key
    # row slip silently (round-5 review finding, regression-tested)
    if int((f_mask_h & (f_vals_h == 0)).sum()) == int(npz_h):
        MESH_TOPK_RUNS += 1
        return _emit_scan_rows(scan, table, f_idx_h[f_mask_h], lo, hi)
    return None  # rare zero-key corner: host path is always exact


def try_execute_mesh_join_groupby(node: qn.GroupByNode, txn):
    """Fact-dim JOIN + GROUP BY over the mesh: the fact table stays
    sharded, the (host-evaluated, small) dimension side replicates to
    every shard — a broadcast join — and each shard probes + partially
    aggregates before the fixed-width accumulator exchange. Only
    O(groups) words cross chips; the reference re-joins row streams on
    the coordinator (hash_join.cc + QUERY_REMOTE row pull,
    transport/native/ops/query_remote.cc:40-140).

    Plan eligibility is shared with the single-chip route
    (device_exec.join_groupby_analysis)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from eventql_tpu.exec.device_exec import (
        _batched_device_get,
        _cached_jit,
        _device_compact_groups,
        _n_scalar,
        _plan_fingerprint_cached,
        join_groupby_analysis,
    )
    from eventql_tpu.exec.vector_eval import EvalContext, evaluate_vector
    from eventql_tpu.kernels.groupby import (
        masked_grouped_aggregate,
        masked_grouped_count_distinct,
        sortable_u64,
    )
    from eventql_tpu.kernels.join import build_side
    from eventql_tpu.parallel.distributed import _xch_all_gather

    plan = join_groupby_analysis(node, txn)
    if plan is None:
        return None
    scan = plan["scan"]
    table = plan["table"]
    where_base = plan["where_base"]
    bref = plan["bref"]
    entries = plan["entries"]
    all_aggs = plan["all_aggs"]
    dims = plan["dims"]
    dim_keys_h = plan["dim_keys_h"]
    dim_bucket_h = plan["dim_bucket_h"]
    firsts = plan["firsts"]
    group_col = plan["group_col"]

    provider = txn.tables
    mesh, axis = provider.mesh, provider.axis
    nd_mesh = int(mesh.shape[axis])
    from eventql_tpu.exec.device_exec import _scan_inputs_present

    if not _scan_inputs_present(table, scan):
        return None
    in_cols, n, n_p = provider.sharded_scan_columns(
        scan.table_name, scan.input_columns
    )
    stypes = [c.stype for c in in_cols]
    nd = int(dim_keys_h.shape[0])

    # plane layout (same scheme as the mesh GROUP BY route)
    plane_kinds: List[str] = []
    plane_specs: List = []  # None=count | ("f64"|"native", rsubj)
    slots = []
    distinct_exprs: List = []
    for _a, kind, rsubj in all_aggs:
        if kind == "count":
            slots.append(("plane", len(plane_kinds)))
            plane_kinds.append("count")
            plane_specs.append(None)
        elif kind == "mean":
            slots.append(("mean", len(plane_kinds), len(plane_kinds) + 1))
            plane_kinds.extend(["sum", "count"])
            plane_specs.extend([("f64", rsubj), None])
        elif kind == "count_distinct":
            slots.append(("distinct", len(distinct_exprs)))
            distinct_exprs.append(rsubj)
        else:
            slots.append(("plane", len(plane_kinds)))
            plane_kinds.append(kind)
            plane_specs.append(("native", rsubj))

    merge_kinds = tuple(_MERGE_KIND[k] for k in plane_kinds)

    def make_program():
        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(
                tuple(P(axis) for _ in in_cols),
                tuple(P(axis) for _ in in_cols),
                P(), P(), P(),
            ),
            out_specs=(P(), tuple(P() for _ in plane_kinds), P(), P(),
                       tuple(P() for _ in distinct_exprs)),
            check_vma=False,
        )
        def step(datas, valids, dimk, dimb, n_real):
            local_n = datas[0].shape[0]
            in_cols_l = [
                jax_expr.DeviceCol(st, d, v)
                for st, d, v in zip(stypes, datas, valids)
            ]
            scan_cols = [
                jax_expr.compile_expr(sl.expr, in_cols_l, local_n)
                for sl in scan.select_list
            ]
            mask = jnp.ones((local_n,), jnp.bool_)
            if scan.where_expr is not None:
                mask &= jax_expr.compile_expr(
                    scan.where_expr, in_cols_l, local_n
                ).data
            if where_base is not None:
                mask &= jax_expr.compile_expr(
                    where_base, scan_cols, local_n
                ).data
            shard_i = jax.lax.axis_index(axis).astype(jnp.int64)
            g0 = shard_i * jnp.int64(local_n)
            gidx = g0 + jnp.arange(local_n, dtype=jnp.int64)
            mask = mask & (gidx < n_real)

            fact_keys = scan_cols[bref[1]].data.astype(jnp.uint64)
            # broadcast probe: binary search into the replicated sorted
            # dim keys (always-correct tier; the compare kernel is the
            # single-device fast path)
            sdk, dperm = build_side(dimk)
            db_sorted = dimb.astype(jnp.int32)[dperm]
            pk = sortable_u64(fact_keys)
            pos = jnp.clip(
                jnp.searchsorted(sdk, pk, side="left"), 0, max(nd - 1, 0)
            )
            matched = sdk[pos] == pk
            gid = jnp.where(matched, db_sorted[pos], 0).astype(jnp.int32)
            m = mask & matched

            planes = []
            for spec in plane_specs:
                if spec is None:
                    planes.append(jnp.zeros((local_n,), jnp.uint64))
                else:
                    how, rsubj = spec
                    c = jax_expr.compile_expr(rsubj, scan_cols, local_n)
                    planes.append(
                        c.data.astype(jnp.float64) if how == "f64" else c.data
                    )
            local_kinds = tuple(plane_kinds) + ("min",)
            mkinds = merge_kinds + ("min",)
            planes.append(gidx)  # first-surviving-pair presentation order

            key = (gid.astype(jnp.uint64),)
            gk, outs, _f, ng_l = masked_grouped_aggregate(
                m, key, tuple(planes), local_kinds
            )
            valid_l = jnp.arange(local_n, dtype=jnp.int64) < ng_l

            gk_all = tuple(
                _xch_all_gather(k, axis, nd_mesh, op="sql_join_gather",
                                tiled=True)
                for k in gk
            )
            outs_all = tuple(
                _xch_all_gather(o, axis, nd_mesh, op="sql_join_gather",
                                tiled=True)
                for o in outs
            )
            valid_all = _xch_all_gather(
                valid_l, axis, nd_mesh, op="sql_join_gather", tiled=True
            )
            mk, mouts, _mf, mng = masked_grouped_aggregate(
                valid_all, gk_all, outs_all, mkinds
            )

            dcounts = [
                _mesh_distinct_counts(
                    m, key,
                    jax_expr.compile_expr(
                        rsubj, scan_cols, local_n
                    ).data.astype(jnp.uint64),
                    axis, nd_mesh, "sql_join_distinct",
                )
                for rsubj in distinct_exprs
            ]

            return mk[0], tuple(mouts[:-1]), mouts[-1], mng, tuple(dcounts)

        def program(col_data, col_valid, dimk, dimb, n_real):
            return step(col_data, col_valid, dimk, dimb, n_real)

        return program

    key = (
        "mesh_join",
        _plan_fingerprint_cached(node),
        tuple(int(st) for st in stypes),
        nd,
        nd_mesh,
        id(mesh),
        n_p,
    )
    fn = _cached_jit(key, make_program)
    gk, main_out, first_base, ng, dcounts = fn(
        tuple(c.data for c in in_cols),
        tuple(c.valid for c in in_cols),
        jnp.asarray(dim_keys_h),
        jnp.asarray(dim_bucket_h.astype(np.int32)),
        _n_scalar(n),
    )
    ng = int(ng)
    if ng == 0:
        return None  # host path builds the typed empty relation

    planes_list = list(main_out) + list(dcounts) + [gk]
    compact, first_small, _rd, _rv = _device_compact_groups(
        planes_list, first_base, (), (), n, ng, False
    )
    got = _batched_device_get((list(compact), first_small))
    planes_h = [a[:ng] for a in got[0]]
    first_h = np.asarray(got[1])[:ng]

    main_h = planes_h[: len(plane_kinds)]
    dist_h = planes_h[len(plane_kinds): len(plane_kinds) + len(distinct_exprs)]
    gk_h = planes_h[-1]

    order = np.argsort(first_h, kind="stable")
    buckets = gk_h.astype(np.int64)[order]

    agg_cols: List[Column] = []
    for (a, _kind, _subj), slot in zip(all_aggs, slots):
        rtype = a.sfunction.return_type
        if slot[0] == "plane":
            arr = main_h[slot[1]]
        elif slot[0] == "mean":
            s = main_h[slot[1]].astype(np.float64)
            c = main_h[slot[2]].astype(np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                arr = s / c
        else:
            arr = dist_h[slot[1]]
        agg_cols.append(
            Column(
                rtype, arr[order].astype(dtype_for(rtype)),
                np.ones(ng, bool),
            )
        )

    group_out = group_col.gather(firsts[buckets])

    out_cols: List[Column] = []
    for kind, expr, base_i in entries:
        if kind == "agg":
            ctx = EvalContext(agg_cols[base_i:], ng)
            out_cols.append(evaluate_vector(expr, ctx))
        else:
            out_cols.append(group_out)

    global MESH_JOIN_RUNS
    MESH_JOIN_RUNS += 1
    names = [sl.column_name() for sl in node.select_list]
    return Relation(names, out_cols, ng)


def try_execute_mesh_scan_order(
    order_node: qn.OrderByNode, txn, window=None
) -> Optional[Relation]:
    """Full SELECT ... [WHERE] ORDER BY over the mesh.

    Single-key specs take the PADDED-BUCKET SAMPLE SORT
    (distributed_bucket_sort — shipped round 5 after the probe
    projected 1.64x the bitonic at P=8, scripts/probe_bucket_sort.py:
    one fixed-capacity exchange round instead of log2(P)(log2(P)+1)/2
    full-run stages): filtered rows key to the sentinel and drop out of
    the exchange; the global row id rides as the tiebreak payload, so
    ties keep the host engine's stable order; splitter-overflow (heavy
    skew) falls back to the always-exact bitonic path below.

    Multi-key specs use the bitonic compare-split mesh sort
    (distributed_sort) with the filter mask as the leading key and the
    global row id as the trailing key (exact host stable order; the
    permutation IS the trailing key's sorted values)."""
    global MESH_ORDER_RUNS

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from eventql_tpu.exec.device_exec import (
        _cached_jit,
        _emit_scan_rows,
        _n_scalar,
        _plan_fingerprint_cached,
    )
    from eventql_tpu.parallel.distributed import (
        distributed_bucket_sort,
        distributed_sort,
    )

    provider = txn.tables
    mesh, axis = provider.mesh, provider.axis
    nd = int(mesh.shape[axis])
    if nd & (nd - 1):
        return None  # compare-split network needs power-of-two shards
    prep = _mesh_order_analysis(order_node, txn)
    if prep is None:
        return None
    scan, table, n, needed, null_ranks, host_keys, bounds = prep
    specs = order_node.sort_specs
    in_cols, n, n_p = provider.sharded_scan_columns(
        scan.table_name, scan.input_columns
    )
    stypes = [c.stype for c in in_cols]
    hostkey_planes = _mesh_sharded_hostkeys(provider, host_keys, n, n_p)

    def _shard_keys_body(datas, valids, hkeys, n_real):
        """Per-shard: scan exprs, WHERE mask, host-order keys, global
        row ids — shared by the bucket and bitonic programs."""
        local_n = datas[0].shape[0]
        in_cols_l = [
            jax_expr.DeviceCol(st, d, v)
            for st, d, v in zip(stypes, datas, valids)
        ]
        scan_cols = [None] * len(scan.select_list)
        for i in needed:
            scan_cols[i] = jax_expr.compile_expr(
                scan.select_list[i].expr, in_cols_l, local_n
            )
        if scan.where_expr is not None:
            mask = jax_expr.compile_expr(
                scan.where_expr, in_cols_l, local_n
            ).data
        else:
            mask = jnp.ones((local_n,), jnp.bool_)
        shard_i = jax.lax.axis_index(axis).astype(jnp.int64)
        gidx = shard_i * jnp.int64(local_n) + jnp.arange(
            local_n, dtype=jnp.int64
        )
        mask = mask & (gidx < n_real)
        keys = _mesh_keys_in_shard(
            specs, scan_cols, null_ranks, hkeys, host_keys, local_n
        )
        return keys, mask, gidx

    # multi-key packing: when every key is statically bounded and the
    # bit widths sum to <= 64, the lexicographic tuple packs into ONE
    # u64 ((k_i - lo_i) fields, first spec most significant) and the
    # bucket-sort path applies to `ORDER BY a, b` shapes too
    pack_plan = None
    if len(specs) > 1 and all(b is not None for b in bounds):
        bits = [max(1, (b[1] - b[0]).bit_length()) for b in bounds]
        if sum(bits) <= 64:
            pack_plan = (tuple(bounds), tuple(bits))

    if len(specs) == 1 or pack_plan is not None:
        # padded-bucket sample sort path (see docstring)
        def make_bucket_program():
            @functools.partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=(
                    tuple(P(axis) for _ in in_cols),
                    tuple(P(axis) for _ in in_cols),
                    tuple(P(axis) for _ in hostkey_planes),
                    P(),
                ),
                out_specs=(P(axis), P(axis), P(), P()),
                check_vma=False,
            )
            def bkeys_step(datas, valids, hkeys, n_real):
                from eventql_tpu.parallel.distributed import _xch_psum

                keys, mask, gidx = _shard_keys_body(
                    datas, valids, hkeys, n_real
                )
                sentinel = jnp.uint64(0xFFFFFFFFFFFFFFFF)
                if pack_plan is not None:
                    pb, pbits = pack_plan
                    packed = jnp.zeros_like(keys[0])
                    for k_i, (lo, _hi), nb in zip(keys, pb, pbits):
                        packed = (packed << jnp.uint64(nb)) | (
                            k_i - jnp.uint64(lo)
                        )
                    k0 = packed
                else:
                    k0 = keys[0]
                # a REAL key equal to the sentinel (u64 max / NaN-last)
                # cannot ride the bucket path (it would drop as
                # padding): detect and fall back
                collide = _xch_psum(
                    jnp.sum(mask & (k0 == sentinel), dtype=jnp.int64),
                    axis, nd, op="order_collide",
                )
                n_pass = _xch_psum(
                    jnp.sum(mask, dtype=jnp.int64), axis, nd,
                    op="order_npass",
                )
                bkey = jnp.where(mask, k0, sentinel)
                return bkey, gidx.astype(jnp.uint64), n_pass, collide

            def program(col_data, col_valid, hkeys, n_real):
                bkey, gidx, n_pass, collide = bkeys_step(
                    col_data, col_valid, hkeys, n_real
                )
                out_k, out_p, counts, overflow = distributed_bucket_sort(
                    mesh, bkey, gidx, axis=axis
                )
                return out_p, counts, overflow | (collide > 0), n_pass

            return program

        bkey_cache = (
            "mesh_order_bucket",
            _plan_fingerprint_cached(order_node),
            tuple(int(st) for st in stypes),
            nd,
            id(mesh),
            n_p,
            pack_plan,
        )
        fnb = _cached_jit(bkey_cache, make_bucket_program)
        out_p, counts, fallback, n_pass = fnb(
            tuple(c.data for c in in_cols),
            tuple(c.valid for c in in_cols),
            hostkey_planes,
            _n_scalar(n),
        )
        if not bool(fallback):
            op = np.asarray(out_p)
            cnt = np.asarray(counts)
            cap = op.shape[0] // nd
            perm_h = np.concatenate(
                [op[i * cap : i * cap + cnt[i]] for i in range(nd)]
            ).astype(np.int64)
            # belt-and-braces (no assert: it would vanish under -O and
            # the bitonic below is always exact): any count mismatch
            # falls through to the fallback path
            if len(perm_h) == int(n_pass):
                MESH_ORDER_RUNS += 1
                global MESH_BUCKET_SORT_RUNS
                MESH_BUCKET_SORT_RUNS += 1
                lo, hi = window if window is not None else (0, None)
                return _emit_scan_rows(scan, table, perm_h, lo, hi)
        # splitter overflow / sentinel collision: bitonic fallback

    def make_program():
        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(
                tuple(P(axis) for _ in in_cols),
                tuple(P(axis) for _ in in_cols),
                tuple(P(axis) for _ in hostkey_planes),
                P(),
            ),
            out_specs=(
                tuple(P(axis) for _ in specs),
                P(axis),
                P(axis),
                P(),
            ),
            check_vma=False,
        )
        def keys_step(datas, valids, hkeys, n_real):
            from eventql_tpu.parallel.distributed import _xch_psum

            keys, mask, gidx = _shard_keys_body(
                datas, valids, hkeys, n_real
            )
            n_pass = _xch_psum(
                jnp.sum(mask, dtype=jnp.int64), axis, nd, op="order_npass"
            )
            return (
                tuple(keys),
                (~mask).astype(jnp.uint64),
                gidx.astype(jnp.uint64),
                n_pass,
            )

        def program(col_data, col_valid, hkeys, n_real):
            keys, mkey, gidx, n_pass = keys_step(
                col_data, col_valid, hkeys, n_real
            )
            sorted_keys, _ = distributed_sort(
                mesh, (mkey,) + keys + (gidx,), (), axis=axis
            )
            return sorted_keys[-1], n_pass

        return program

    key = (
        "mesh_order",
        _plan_fingerprint_cached(order_node),
        tuple(int(st) for st in stypes),
        nd,
        id(mesh),
        n_p,
    )
    fn = _cached_jit(key, make_program)
    perm, n_pass = fn(
        tuple(c.data for c in in_cols),
        tuple(c.valid for c in in_cols),
        hostkey_planes,
        _n_scalar(n),
    )
    n_pass = int(n_pass)
    perm_h = np.asarray(perm)[:n_pass].astype(np.int64)
    MESH_ORDER_RUNS += 1
    lo, hi = window if window is not None else (0, None)
    return _emit_scan_rows(scan, table, perm_h, lo, hi)
