"""Device plan routing.

Routes eligible physical plans to compiled XLA pipelines instead of the
host columnar engine. Eligible today:

  GroupBy(sum/count/min/max/mean over device-compatible exprs)
    over Scan(device-compatible WHERE)        → one fused jit program
  (optionally under OrderBy/Limit of the aggregate output)

The host engine remains the semantic reference; the device path is
differentially tested against it (tests/test_device_exec.py). Plans
outside the subset fall back transparently.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from eventql_tpu.core.types import SType
from eventql_tpu.exec import jax_expr
from eventql_tpu.exec.relation import Column, Relation
from eventql_tpu.plan import nodes as qn
from eventql_tpu.plan.exprs import (
    CallExpressionNode,
    ColumnReferenceNode,
    LiteralExpressionNode,
    has_aggregate_call,
)

_DEVICE_AGGS = {"sum", "count", "count_distinct", "min", "max", "mean"}


# -- compiled-program cache --------------------------------------------------
# The GROUP BY and JOIN routes build their device program as a closure
# over the plan; a fresh closure per query means jax.jit re-traces AND
# XLA re-compiles EVERY execution.
# Caching the jitted callable keyed by a structural plan fingerprint
# makes repeated queries steady-state: the data arrays are passed as
# ARGUMENTS (shape/dtype changes re-trace automatically; the
# fingerprint covers everything else the closure reads). The reference
# re-plans per request but its compiled expression programs are
# per-process cached the same way (sql/runtime/runtime.cc).

_PROGRAM_CACHE: "OrderedDict" = None  # type: ignore[assignment]
_PROGRAM_CACHE_CAP = 64
# guards _PROGRAM_CACHE under the thread-per-connection server
# (reference: db/database.cc:555-573 — concurrent sessions are the
# normal case); build single-flight keeps two simultaneous clients
# from duplicating one compile
_PROGRAM_LOCK = None  # created lazily to keep import cheap


def _plan_fingerprint(obj, _depth=0) -> str:
    """Stable, EXHAUSTIVE serialization of a plan subtree: class names
    plus every attribute, recursively. Exhaustiveness is the safety
    property — two plans with equal fingerprints produce identical
    device programs because the program is a pure function of exactly
    this state (+ the array arguments)."""
    if _depth > 64:
        raise ValueError("plan fingerprint recursion limit")
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return repr(obj)
    if isinstance(obj, (list, tuple)):
        return (
            "[" + ",".join(_plan_fingerprint(x, _depth + 1) for x in obj)
            + "]"
        )
    if isinstance(obj, dict):
        return (
            "{"
            + ",".join(
                repr(k) + ":" + _plan_fingerprint(v, _depth + 1)
                for k, v in sorted(obj.items(), key=lambda kv: repr(kv[0]))
            )
            + "}"
        )
    if callable(obj) and hasattr(obj, "__qualname__"):
        return "fn:" + obj.__qualname__
    d = getattr(obj, "__dict__", None)
    if d is not None:
        return (
            type(obj).__qualname__
            + "{"
            + ",".join(
                k + "=" + _plan_fingerprint(v, _depth + 1)
                for k, v in sorted(d.items())
                if k != "_fp_cache"  # fingerprint memo must not feed itself
            )
            + "}"
        )
    return type(obj).__qualname__ + ":" + repr(obj)


def _plan_fingerprint_cached(node) -> str:
    """Per-node memo of _plan_fingerprint: plans are immutable once
    built (the server plan cache already relies on reuse), and the
    exhaustive walk costs ~0.5 ms per query on the serving path."""
    fp = getattr(node, "_fp_cache", None)
    if fp is None:
        fp = _plan_fingerprint(node)
        try:
            node._fp_cache = fp
        except AttributeError:
            pass
    return fp


class _ProgramEntry:
    """One program slot: the builder thread fills `fn` (or `err`) and
    sets `ready`; waiters block on `ready` instead of re-building. The
    first INVOCATION (where jit actually traces + compiles) is also
    serialized per entry, so concurrent first calls can't race JAX's
    dispatch into duplicate XLA compiles; once the first call returns,
    calls go straight through."""

    __slots__ = ("ready", "fn", "err", "_first_done", "_first_lock")

    def __init__(self):
        import threading

        self.ready = threading.Event()
        self.fn = None
        self.err = None
        self._first_done = threading.Event()
        self._first_lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        if not self._first_done.is_set():
            with self._first_lock:
                if not self._first_done.is_set():
                    try:
                        return self.fn(*args, **kwargs)
                    finally:
                        self._first_done.set()
        return self.fn(*args, **kwargs)


def _program_lock():
    global _PROGRAM_LOCK
    if _PROGRAM_LOCK is None:
        import threading

        # benign construction race: module import lock makes this
        # effectively once; worst case two locks exist momentarily
        # before one wins the global slot
        _PROGRAM_LOCK = threading.Lock()
    return _PROGRAM_LOCK


def _cached_jit(key, make_program):
    """Jitted program for `key`, building (and compiling) at most once
    across threads (single-flight); small LRU so long-lived servers
    don't accumulate dead plans."""
    global _PROGRAM_CACHE
    import jax

    from collections import OrderedDict

    from eventql_tpu.utils.stats import evqld_stats

    lock = _program_lock()
    with lock:
        if _PROGRAM_CACHE is None:
            _PROGRAM_CACHE = OrderedDict()
        entry = _PROGRAM_CACHE.get(key)
        if entry is None:
            entry = _ProgramEntry()
            _PROGRAM_CACHE[key] = entry
            while len(_PROGRAM_CACHE) > _PROGRAM_CACHE_CAP:
                _PROGRAM_CACHE.popitem(last=False)
            builder = True
        else:
            _PROGRAM_CACHE.move_to_end(key)
            builder = False
    if builder:
        evqld_stats().device_program_builds.incr()
        try:
            entry.fn = jax.jit(make_program())
        except BaseException as e:
            entry.err = e
            with lock:
                if _PROGRAM_CACHE.get(key) is entry:
                    del _PROGRAM_CACHE[key]
            raise
        finally:
            entry.ready.set()
        return entry
    if entry.ready.is_set():
        evqld_stats().device_program_hits.incr()
    else:
        evqld_stats().device_program_waits.incr()
        entry.ready.wait()
    if entry.err is not None:
        # the build failed after we started waiting: retry ourselves
        return _cached_jit(key, make_program)
    return entry


def device_plan_eligible(node) -> bool:
    """Is this plan node executable on the device fast path?"""
    if isinstance(node, qn.LimitNode):
        return device_plan_eligible(node.table)
    if isinstance(node, qn.OrderByNode):
        return all(
            jax_expr.expr_is_device_compatible(s.expr) for s in node.sort_specs
        ) and device_plan_eligible(node.table)
    if not isinstance(node, qn.GroupByNode):
        return False
    scan = node.table
    if not isinstance(scan, qn.SequentialScanNode):
        return False
    if scan.aggr_strategy != qn.SequentialScanNode.NO_AGGREGATION:
        return False
    if scan.keyrange is not None:
        # partition-scoped shipped plan: the device routes read whole
        # cached columns and would ignore the keyrange filter — the
        # host path applies it (operators._exec_seqscan_relation)
        return False
    # scan select exprs + where must be device compatible. STRING
    # columns flow as dictionary ids (dictionaries are np.unique-sorted
    # at ingest, so ids preserve both equality and byte order); only
    # plain column refs are routable — computed string exprs (concat,
    # substring, ...) have no device form and stay on the host.
    for sl in scan.select_list:
        if not jax_expr.expr_is_device_compatible(sl.expr):
            return False
        if sl.expr.return_type() == SType.STRING and not isinstance(
            sl.expr, ColumnReferenceNode
        ):
            return False
    for g in node.group_exprs:
        if g.return_type() == SType.STRING and not isinstance(
            g, ColumnReferenceNode
        ):
            return False
    if scan.where_expr is not None and not jax_expr.expr_is_device_compatible(
        scan.where_expr
    ):
        return False
    # group exprs device compatible, non-string output (string keys flow
    # as dictionary ids, which is fine since ids are equality-preserving)
    for g in node.group_exprs:
        if not jax_expr.expr_is_device_compatible(g):
            return False
    # select list: aggregates of device exprs; non-aggregates must be
    # group-key passthroughs or constants (first-row-wins needs gather,
    # which the kernel provides via first_index)
    for sl in node.select_list:
        if has_aggregate_call(sl.expr):
            aggs: List[CallExpressionNode] = []
            from eventql_tpu.exec.operators import _strip_aggregates

            emit = _strip_aggregates(sl.expr, aggs)
            for a in aggs:
                kind = a.sfunction.aggregate.kind
                if kind not in _DEVICE_AGGS:
                    return False
                if a.args and not jax_expr.expr_is_device_compatible(a.args[0]):
                    return False
                if (
                    kind == "count_distinct"
                    and a.args
                    and a.args[0].return_type() == SType.FLOAT64
                ):
                    # host truncates float payloads with np.uint64 C
                    # casts; the device bitcast would count bit
                    # patterns — parity requires the host path
                    return False
            if not jax_expr.expr_is_device_compatible(emit):
                return False
        else:
            if not jax_expr.expr_is_device_compatible(sl.expr):
                return False
    return True


def _narrow_np(c: Column) -> "np.ndarray":
    """Physical column narrowing: a logical 64-bit column whose values
    fit 32 (16) bits transfers (and streams from HBM) as a 32 (16)-bit
    array — half (a quarter) of the scan bytes per row. The expression
    compiler widens back to the logical dtype inside the traced
    program, where XLA fuses the convert into the consumer, so
    semantics are unchanged while the memory-bound scan roofline
    doubles (the reference's planner reads column statistics the same
    way). 16 bits is the narrowest width. Min/max stats cache on the
    Column (columns are rebuilt on mutation)."""
    cached = getattr(c, "_narrow_cache", None)
    if cached is not None:
        return cached
    with _column_cache_lock():
        cached = getattr(c, "_narrow_cache", None)
        if cached is not None:
            return cached
        return _narrow_np_build(c)


def _narrow_np_build(c: Column):
    data = c.data
    out = data
    if data.size:
        if data.dtype == np.uint64:
            mx = int(data.max())
            # true min matters: base-offset group keys (ids, years,
            # timestamps-in-days) only fit the fused route's 64K-bucket
            # bound as (key - min)
            c._stats_cache = (int(data.min()), mx)
            if mx < (1 << 16):
                out = data.astype(np.uint16)
            elif mx < (1 << 32):
                out = data.astype(np.uint32)
        elif data.dtype == np.int64:
            mn, mx = int(data.min()), int(data.max())
            c._stats_cache = (mn, mx)
            if -(1 << 15) <= mn and mx < (1 << 15):
                out = data.astype(np.int16)
            elif -(1 << 31) <= mn and mx < (1 << 31):
                out = data.astype(np.int32)
        elif data.dtype == np.int32 and c.stype == SType.STRING:
            # STRING dictionary ids: ids are [0, K) by construction
            # (relation.from_strings / dictionary unification), so a
            # dictionary that fits 15 bits streams as int16 — half the
            # scan bytes for string-keyed filters/sorts/groupbys.
            # jax_expr._widen restores int32 inside the traced program.
            # The stype gate enforces the dictionary-id invariant: a
            # future non-string int32 physical column must NOT take
            # this branch implicitly.
            mn, mx = int(data.min()), int(data.max())
            if -(1 << 15) <= mn and mx < (1 << 15):
                out = data.astype(np.int16)
    try:
        c._narrow_cache = out
    except AttributeError:
        pass
    return out


def _scan_inputs_present(table, scan) -> bool:
    """False when a scan references columns the materialized relation
    does not carry (nested/repeated leaves served by the Dremel scan
    path) — those queries belong to the host engine. Guarding here
    (not in plan eligibility, which has no table) keeps the device
    routes from KeyErroring on nested schemas (round-5 soak finding)."""
    names = set(table.names)
    return all(cname in names for cname, _t in scan.input_columns)


def _to_device_cols(rel_cols: List[Column], names: List[str], wanted):
    """Host → device transfer of the scan's input columns. The device
    arrays cache on the Column (columns are rebuilt on mutation, the
    same invalidation argument as _narrow_cache): a repeated query on
    warm columns pays ZERO transfer."""
    import jax.numpy as jnp

    out = []
    by_name = dict(zip(names, rel_cols))
    for cname, _t in wanted:
        c = by_name[cname]
        dev = getattr(c, "_device_cache", None)
        if dev is None:
            # double-checked under the column-cache lock: two
            # concurrent sessions must not duplicate a multi-second
            # host→device transfer of the same column (and the
            # transfer is hardware-serialized anyway)
            with _column_cache_lock():
                dev = getattr(c, "_device_cache", None)
                if dev is None:
                    dev = (jnp.asarray(_narrow_np(c)), jnp.asarray(c.valid))
                    try:
                        c._device_cache = dev
                    except AttributeError:
                        pass
        out.append(jax_expr.DeviceCol(c.stype, dev[0], dev[1]))
    return out


_COLUMN_CACHE_LOCK = None


def _column_cache_lock():
    global _COLUMN_CACHE_LOCK
    if _COLUMN_CACHE_LOCK is None:
        import threading

        # reentrant: _to_device_cols holds it while calling _narrow_np,
        # which takes it again on a narrow-cache miss
        _COLUMN_CACHE_LOCK = threading.RLock()
    return _COLUMN_CACHE_LOCK


def _pad_buckets(K: int) -> int:
    """Round the bucket count up to a multiple of 128 so distinct
    dictionary sizes share compiled programs."""
    return max(128, -(-K // 128) * 128)


# -- fused GROUP BY route -----------------------------------------------------
# For the canonical `SELECT key, count(*), sum(v) FROM t WHERE col CMP
# literal GROUP BY key` shape, the WHERE compare, the row-pad mask, and
# the filtered-row bucket fold compile into the same program as the
# scatter-add (kernels/bucket_agg.fused_sum_count), so the per-query
# device traffic is the raw column streams. Streams ride as cached
# int32 device copies.

_FUSED_OPS = {
    "lt": "lt",
    "lte": "le",
    "gt": "gt",
    "gte": "ge",
    "eq": "eq",
    "neq": "ne",
}
# observability: how many queries took the fused route (tests assert
# this so fused-path coverage can't silently fall back)
FUSED_GROUPBY_COUNT = 0
# multi-sum route (2+ summed columns in one scatter)
MULTI_SUM_GROUPBY_COUNT = 0
# accumulated wall seconds spent BLOCKED on device readbacks (the
# bench separates host-tail time from the device wait)
DEVICE_WAIT = [0.0]
import time as _time
_FUSED_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}
_I32_MIN = -(1 << 31)


def _column_all_valid(c: Column) -> bool:
    cached = getattr(c, "_all_valid_cache", None)
    if cached is None:
        cached = bool(np.all(c.valid))
        try:
            c._all_valid_cache = cached
        except AttributeError:
            pass
    return cached


def _device_i32_stream(host_c: Column, dev_padded):
    """Cached int32 device copy of a (padded) narrowed column stream.
    Built ON DEVICE from the already-cached narrow array (a host-side
    rebuild would re-transfer the column). uint32
    payloads convert modularly (same bits) — exact for value limbs,
    ineligible as predicate streams (callers gate)."""
    import jax.numpy as jnp

    want = dev_padded.shape[0]
    cached = getattr(host_c, "_device_cache_i32", None)
    if cached is not None and cached[0] == want:
        return cached[1]
    with _column_cache_lock():
        cached = getattr(host_c, "_device_cache_i32", None)
        if cached is None or cached[0] != want:
            dev = (
                dev_padded
                if dev_padded.dtype == jnp.int32
                else dev_padded.astype(jnp.int32)
            )
            cached = (want, dev)
            try:
                host_c._device_cache_i32 = cached
            except AttributeError:
                pass
    return cached[1]


def _fused_pred_eligible(host_c: Column, stype) -> bool:
    """May this column's i32 stream serve as the in-kernel predicate
    operand? Requires payloads whose i32 representation preserves the
    logical compare: u16 (zero-extends), i16 (sign-extends), i32
    (exact), and u32 only when the narrowing pass's cached max stat
    proves every payload < 2^31 (larger payloads flip sign)."""
    if stype not in (SType.UINT64, SType.INT64, SType.TIMESTAMP64):
        return False
    nd = _narrow_np(host_c)
    if nd.dtype in (np.uint16, np.int16, np.int32):
        return True
    if nd.dtype == np.uint32:
        stats = getattr(host_c, "_stats_cache", None)
        return stats is not None and stats[1] < (1 << 31)
    return False


def _flatten_bool(w, fn_name, out):
    if (
        isinstance(w, CallExpressionNode)
        and w.sfunction.name == fn_name
        and len(w.args) == 2
    ):
        _flatten_bool(w.args[0], fn_name, out)
        _flatten_bool(w.args[1], fn_name, out)
    else:
        out.append(w)


def _match_fused_where(scan, name_to_col):
    """Match the WHERE clause against the fused kernel's in-kernel
    predicate slots. Returns (conjuncts, combine) where conjuncts is a
    list of 1-2 (input_col_idx|None|'mask', op, thr) specs and combine
    is 'and'|'or' — [(None, 'ge', INT32_MIN)] is the always-true form
    for a missing WHERE. Shapes beyond the two compare slots (OR of 2
    rides the kernel's pred_combine; >=3 conjuncts, mixed and/or
    trees, arithmetic predicates) return the ('mask', 'ge', 1) spec:
    the route then evaluates the WHERE as one XLA pass producing a 0/1
    i32 stream the kernel compares against — still one dispatch, one
    extra row-width stream vs the reference's general
    evaluatePredicateVector (vm.cc:231-272). Returns None only when
    the WHERE is not device-compatible at all (caller pre-checks)."""
    w = scan.where_expr
    if w is None:
        return [(None, "ge", _I32_MIN)], "and"
    m = _match_simple_compare(w, scan, name_to_col)
    if m is not None:
        return [m], "and"
    for fn_name, combine in (("logical_and", "and"), ("logical_or", "or")):
        terms = []
        _flatten_bool(w, fn_name, terms)
        if len(terms) == 2:
            a = _match_simple_compare(terms[0], scan, name_to_col)
            b = _match_simple_compare(terms[1], scan, name_to_col)
            if a is not None and b is not None:
                return [a, b], combine
    # general predicate: one XLA pass -> 0/1 stream into the kernel
    return [("mask", "ge", 1)], "and"


def _match_simple_compare(w, scan, name_to_col):
    if not isinstance(w, CallExpressionNode):
        return None
    op = _FUSED_OPS.get(w.sfunction.name)
    if op is None or len(w.args) != 2:
        return None

    def _unwrap(e):
        # the planner wraps mismatched literal args in to_<type> calls
        # (reference: CallExpressionNode.cc:73-88); the raw payload
        # gates below reject any case where the conversion would wrap
        if (
            isinstance(e, CallExpressionNode)
            and e.sfunction.name in ("to_uint64", "to_int64", "to_timestamp64")
            and len(e.args) == 1
            and isinstance(e.args[0], LiteralExpressionNode)
        ):
            return e.args[0]
        return e

    a, b = _unwrap(w.args[0]), _unwrap(w.args[1])
    if isinstance(a, ColumnReferenceNode) and isinstance(
        b, LiteralExpressionNode
    ):
        col, lit = a, b
    elif isinstance(b, ColumnReferenceNode) and isinstance(
        a, LiteralExpressionNode
    ):
        col, lit = b, a
        op = _FUSED_FLIP[op]
    else:
        return None
    if col.column_index is None:
        return None
    sv = lit.value
    if getattr(sv, "is_null", False):
        return None
    payload = sv.payload() if hasattr(sv, "payload") else sv
    if isinstance(payload, bool) or not isinstance(payload, int):
        return None
    idx = col.column_index
    host_c = name_to_col.get(scan.input_columns[idx][0])
    if host_c is None or not _fused_pred_eligible(host_c, col.return_type()):
        return None
    unsigned = col.return_type() in (SType.UINT64, SType.TIMESTAMP64)
    if not (_I32_MIN < payload < (1 << 31)):
        return None
    if unsigned and payload < 0:
        return None
    return (idx, op, int(payload))


def _pad_rows(n: int, block: int = 8192) -> int:
    """Round the row count up to a coarse bucket (next power-of-two
    multiple of the kernel block) to bound jit recompiles across table
    sizes; callers mask the padding out."""
    nb = -(-n // block)
    p = 1
    while p < nb:
        p <<= 1
    return p * block


def try_execute_bounded_groupby(
    node: qn.GroupByNode, txn
) -> Optional[Relation]:
    """Fast route for the canonical analytics shape:

        SELECT key, agg(...), ... FROM t [WHERE ...] GROUP BY key

    where `key` is a dictionary-encoded STRING column (the dictionary
    bounds the bucket count statically) OR — round 4 — a NUMERIC column
    whose cached min/max stats bound its span to <=64K distinct buckets
    (narrowed u16/i16/u32/i32 storage; bucket = key - min, subtracted
    in-program via the gid_base scalar). The whole query runs as one
    bounded scatter-add aggregation (kernels/bucket_agg); count-only
    shapes read no value stream. Numeric keys require the
    fully-fused form (all-valid key column, fusable WHERE); anything
    else returns None and falls through to the general device path /
    host engine."""
    import jax
    import jax.numpy as jnp

    from eventql_tpu.exec.operators import _count_subject, _strip_aggregates
    from eventql_tpu.kernels import bucket_agg

    scan = node.table
    if not isinstance(scan, qn.SequentialScanNode):
        return None
    if scan.aggr_strategy != qn.SequentialScanNode.NO_AGGREGATION:
        return None
    if scan.keyrange is not None:
        return None  # partition-scoped: host path applies the range
    if len(node.group_exprs) != 1:
        return None

    # group key must resolve to a plain STRING input column
    g = node.group_exprs[0]
    if not isinstance(g, ColumnReferenceNode) or g.column_index is None:
        return None
    key_sl = scan.select_list[g.column_index]
    if not isinstance(key_sl.expr, ColumnReferenceNode):
        return None
    key_stype = key_sl.expr.return_type()
    if key_stype not in (
        SType.STRING,
        SType.UINT64,
        SType.INT64,
        SType.TIMESTAMP64,
    ):
        return None
    key_input_idx = key_sl.expr.column_index

    if scan.where_expr is not None and not jax_expr.expr_is_device_compatible(
        scan.where_expr
    ):
        return None

    # select entries: key passthrough or sum/count aggregates over
    # device-compatible numeric args
    entries = []
    for sl in node.select_list:
        if has_aggregate_call(sl.expr):
            aggs: List[CallExpressionNode] = []
            emit = _strip_aggregates(sl.expr, aggs)
            for a in aggs:
                kind = a.sfunction.aggregate.kind
                if kind not in ("sum", "count"):
                    return None
                if kind == "sum":
                    arg = a.args[0]
                    if not jax_expr.expr_is_device_compatible(arg):
                        return None
                    # u64 limb aggregation is exact for uint64 and (via
                    # two's-complement wraparound) int64; floats are not
                    if a.sfunction.return_type not in (
                        SType.UINT64,
                        SType.INT64,
                        SType.TIMESTAMP64,
                    ):
                        return None
                if kind == "count" and _count_subject(a) is not None:
                    subj = _count_subject(a)
                    if not jax_expr.expr_is_device_compatible(subj):
                        return None
            if not jax_expr.expr_is_device_compatible(emit):
                return None
            entries.append(("agg", emit, aggs))
        else:
            e = sl.expr
            if (
                isinstance(e, ColumnReferenceNode)
                and e.column_index == g.column_index
            ):
                entries.append(("key", None, None))
            else:
                return None

    table = txn.get_table_data(scan.table_name)
    n = table.num_rows
    if n == 0:
        return None
    if not _scan_inputs_present(table, scan):
        return None
    name_to_col = dict(zip(table.names, table.columns))
    key_col = name_to_col[scan.input_columns[key_input_idx][0]]
    key_base = 0
    # bucket-count cap: beyond it the sort-based route
    # (execute_device_groupby) is the unbounded tier
    K_CAP = 131072
    if key_stype == SType.STRING:
        K = len(key_col.dictionary)
        if K == 0 or K > K_CAP:
            return None
        num_buckets = K + 1  # bucket K = the NULL-key group
    else:
        # numeric key: the narrowing pass's cached min/max stats bound
        # the span; bucket = key - min (in-kernel gid_base subtract).
        # Requires the fully-fused route (checked below) and an
        # all-valid key column (no NULL bucket).
        nd = _narrow_np(key_col)
        stats = getattr(key_col, "_stats_cache", None)
        if stats is None or nd.dtype.itemsize > 4:
            return None
        mn, mx = stats
        K = mx - mn + 1
        if K <= 0 or K > K_CAP:
            return None
        if not _column_all_valid(key_col):
            return None
        key_base = mn
        num_buckets = K

    in_cols = _to_device_cols(table.columns, table.names, scan.input_columns)
    stypes = [c.stype for c in in_cols]

    # static plan metadata for the host-side emit (independent of data)
    layout = []
    entries_aggs_rtypes = {}
    kinds_static = []
    for tag, emit, aggs in entries:
        if tag != "agg":
            layout.append(("key", None, None))
            continue
        idxs = []
        for a in aggs:
            kind = a.sfunction.aggregate.kind
            kinds_static.append("count" if kind == "count" else "sum")
            idxs.append(len(kinds_static) - 1)
            entries_aggs_rtypes[(id(emit), len(idxs) - 1)] = (
                a.sfunction.return_type
            )
        layout.append(("agg", emit, idxs))
    if not kinds_static:
        kinds_static = ["count"]

    # column-statistics hint: the physically-narrowed device dtype of
    # the summed source column statically bounds the value width (the
    # narrowing pass already consulted the column's min/max)
    value_bits = 64
    sum_src_idx = None  # input-column index of a plain-colref summed col
    for (tag, emit, aggs) in entries:
        if tag != "agg":
            continue
        for a in aggs:
            if a.sfunction.aggregate.kind != "sum":
                continue
            arg = a.args[0]
            if (
                isinstance(arg, ColumnReferenceNode)
                and arg.column_index is not None
            ):
                src_e = scan.select_list[arg.column_index].expr
                if (
                    isinstance(src_e, ColumnReferenceNode)
                    and src_e.column_index is not None
                ):
                    dc = in_cols[src_e.column_index]
                    if dc.stype in (SType.UINT64, SType.TIMESTAMP64):
                        value_bits = dc.data.dtype.itemsize * 8
                        sum_src_idx = src_e.column_index
    value_bits = -(-value_bits // 8) * 8
    # pad the static dimensions to coarse grids so distinct queries
    # and table sizes share compiled kernel variants
    Kp = _pad_buckets(num_buckets)
    distinct_sums = sum(1 for k in kinds_static if k == "sum")

    # multi-sum plan: 2+ summed columns read as their narrowed i32
    # streams (kernels/bucket_agg.bounded_multi_sum). Streams must be
    # plain-colref unsigned columns whose narrowed width fits an i32
    # word (u16 -> 2 bytes, u32 -> 4; signed narrows are excluded: the
    # payload is the word's low bytes read unsigned, so negative values
    # would lose their sign-extension into the high bytes).
    multi_cfg = None
    if distinct_sums >= 2 and set(kinds_static) <= {"sum", "count"}:
        srcs = []
        for (tag, _emit, aggs) in entries:
            if tag != "agg" or srcs is None:
                continue
            for a in aggs:
                if a.sfunction.aggregate.kind != "sum":
                    continue
                arg = a.args[0]
                src_e = None
                if (
                    isinstance(arg, ColumnReferenceNode)
                    and arg.column_index is not None
                ):
                    src_e = scan.select_list[arg.column_index].expr
                if (
                    src_e is None
                    or not isinstance(src_e, ColumnReferenceNode)
                    or src_e.column_index is None
                ):
                    srcs = None
                    break
                dc = in_cols[src_e.column_index]
                if (
                    dc.stype not in (SType.UINT64, SType.TIMESTAMP64)
                    or dc.data.dtype.itemsize > 4
                    or dc.data.dtype.kind != "u"
                ):
                    srcs = None
                    break
                srcs.append((src_e.column_index, dc.data.dtype.itemsize))
        if srcs:
            multi_cfg = tuple(srcs)

    # fused route: one sum (+any counts), narrowable value stream,
    # WHERE fusable as an in-program compare (or absent), dict key. See
    # "fused GROUP BY route" above.
    fused_cfg = None
    count_only = distinct_sums == 0
    sum_fusable = (
        distinct_sums == 1 and sum_src_idx is not None and value_bits <= 32
    )
    if (
        (sum_fusable or count_only)
        and set(kinds_static) <= {"sum", "count"}
        and not os.environ.get("EVENTQL_TPU_NO_FUSED_GROUPBY")
    ):
        m = _match_fused_where(scan, name_to_col)
        if m is not None:
            conjuncts, fused_combine = m
            # map each conjunct's column to its kernel operand source:
            # the summed column itself rides "value" mode (no second
            # stream); a missing WHERE in a count-only query compares
            # on the key stream ("gid" mode); a general predicate
            # ("mask") is computed in-program; anything else streams
            specs = []
            for pred_idx, pred_op, thr in conjuncts:
                if pred_idx == "mask":
                    specs.append(("mask", pred_op, thr))
                elif pred_idx is not None and pred_idx == sum_src_idx:
                    specs.append(("value", pred_op, thr))
                elif pred_idx is None and count_only:
                    specs.append(("gid", pred_op, thr))
                elif pred_idx is None:
                    specs.append(("value", pred_op, thr))
                else:
                    specs.append((pred_idx, pred_op, thr))
            fused_cfg = (tuple(specs), fused_combine)
    if key_stype != SType.STRING and fused_cfg is None:
        return None  # numeric keys only take the fully-fused form
    key_all_valid = (
        _column_all_valid(key_col) if fused_cfg else False
    ) or key_stype != SType.STRING
    # the kernel subtracts the base modularly in i32 (exact for spans
    # < 2^31 even when u32 payloads bitcast negative); sign-fold the
    # python int into int32 range
    key_base_i32 = ((key_base & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000

    def program(col_data, col_valid, n_real, fused_streams=None):
        # ONE cached jitted program for the whole route: XLA fuses the
        # mask/gid/value preparation into single producer passes and
        # the serving path pays one dispatch instead of one per eager
        # op
        if fused_cfg is not None:
            # fully-fused: WHERE compare + pad mask + gid fold (+ the
            # numeric-key base subtract) + aggregation in ONE pass over
            # raw i32 streams
            fused_specs, fused_comb = fused_cfg
            spec1 = fused_specs[0]
            spec2 = fused_specs[1] if len(fused_specs) > 1 else None
            _src1, _op, _thr = spec1
            gid_i32, val_i32, pred_i32, pred2_i32 = fused_streams
            base = jnp.int32(key_base_i32)
            if not key_all_valid:
                # NULL keys take their own bucket K (tag participates
                # in the reference's group key, groupby.cc:129-135)
                gid_i32 = jnp.where(
                    col_valid[key_input_idx], gid_i32, jnp.int32(K)
                )
            if _src1 == "mask":
                # general predicate: evaluate the WHERE over the device
                # columns -> 0/1 i32 stream compared >= 1
                in_cols_l = [
                    jax_expr.DeviceCol(st, d, v)
                    for st, d, v in zip(stypes, col_data, col_valid)
                ]
                nn = col_data[0].shape[0]
                pred_i32 = jax_expr.compile_expr(
                    scan.where_expr, in_cols_l, nn
                ).data.astype(jnp.int32)
            p2kw = {}
            if spec2 is not None:
                _src2, _op2, _thr2 = spec2
                p2kw = dict(
                    pred2=pred2_i32,
                    pred2_op=_op2,
                    thr2=jnp.int32(_thr2),
                    pred_combine=fused_comb,
                )
            if val_i32 is None:
                counts = bucket_agg.fused_count(
                    gid_i32,
                    jnp.int32(_thr),
                    n_real,
                    Kp,
                    pred=pred_i32,
                    pred_op=_op,
                    gid_base=base,
                    **p2kw,
                )
                sums = counts
            else:
                if spec2 is not None and _src2 == "value":
                    p2kw["pred2_is_value"] = True
                counts, sums = bucket_agg.fused_sum_count(
                    gid_i32,
                    val_i32,
                    jnp.int32(_thr),
                    n_real,
                    Kp,
                    pred=pred_i32,
                    value_bits=value_bits,
                    pred_op=_op,
                    gid_base=base,
                    **p2kw,
                )
            counts = counts[:num_buckets]
            sums = sums[:num_buckets]
            outs = tuple(
                counts if k == "count" else sums for k in kinds_static
            )
            # ONE packed output array = ONE device->host transfer
            return jnp.stack([counts, *outs])
        in_cols_l = [
            jax_expr.DeviceCol(st, d, v)
            for st, d, v in zip(stypes, col_data, col_valid)
        ]
        nn = col_data[0].shape[0] if col_data else n
        scan_cols_l = []
        for sl in scan.select_list:
            if sl.expr.return_type() == SType.STRING:
                by_ref = (
                    isinstance(sl.expr, ColumnReferenceNode)
                    and sl.expr.column_index is not None
                )
                scan_cols_l.append(
                    jax_expr.compile_expr(sl.expr, in_cols_l, nn)
                    if by_ref
                    else None
                )
            else:
                scan_cols_l.append(
                    jax_expr.compile_expr(sl.expr, in_cols_l, nn)
                )
        if scan.where_expr is not None:
            mask = jax_expr.compile_expr(
                scan.where_expr, in_cols_l, nn
            ).data
        else:
            mask = jnp.ones((nn,), jnp.bool_)
        # rows arrive padded to a coarse bucket; mask the pad out
        mask = mask & (jnp.arange(nn, dtype=jnp.int32) < n_real)

        # bucket = dictionary id; NULL keys get their own bucket K
        # (NULL and b"" group separately — the tag participates in the
        # reference's group key, groupby.cc:129-135 / SURVEY A.8)
        key_dev = scan_cols_l[g.column_index]
        gid = jnp.where(
            key_dev.valid, key_dev.data.astype(jnp.int32), jnp.int32(K)
        )

        vals = []
        for tag, emit, aggs in entries:
            if tag != "agg":
                continue
            for a in aggs:
                if a.sfunction.aggregate.kind == "count":
                    # count(x) counts every accumulated row, NULL or
                    # not (reference: aggregate.cc:35-38); device
                    # tables are flat, so no occurrence gating
                    vals.append(jnp.zeros((nn,), jnp.uint64))
                else:
                    c = jax_expr.compile_expr(a.args[0], scan_cols_l, nn)
                    vals.append(c.data.astype(jnp.uint64))
        if not vals:
            vals = [jnp.zeros((nn,), jnp.uint64)]

        if multi_cfg is not None:
            # 2+ sums over narrowed unsigned streams, one scatter
            streams = tuple(
                col_data[src].astype(jnp.int32) for src, _lb in multi_cfg
            )
            limbs = tuple(lb for _src, lb in multi_cfg)
            counts, totals = bucket_agg.bounded_multi_sum(
                mask, gid, streams, limbs, Kp
            )
            counts = counts[:num_buckets]
            t_iter = iter(totals)
            outs = tuple(
                counts if k == "count" else next(t_iter)[:num_buckets]
                for k in kinds_static
            )
        else:
            # value_bits bounds the one plain-colref sum; computed or
            # signed sums beside it keep all 64 bits
            counts, outs = bucket_agg.bounded_grouped_aggregate(
                mask, gid, tuple(vals), tuple(kinds_static), Kp,
                value_bits=value_bits if distinct_sums <= 1 else 64,
            )
            counts = counts[:num_buckets]
            outs = tuple(o[:num_buckets] for o in outs)
        # ONE packed output array = ONE device->host transfer
        return jnp.stack([counts, *outs])

    key = (
        "string_groupby",
        _plan_fingerprint_cached(node),
        tuple(int(st) for st in stypes),
        K,
        value_bits,
        multi_cfg,
        n if not in_cols else None,
        fused_cfg,
        key_all_valid,
        key_base_i32,
        int(key_stype),
    )
    fn = _cached_jit(key, lambda: program)
    n_p = _pad_rows(n) if in_cols else n
    col_data, col_valid = _padded_device_arrays(
        table, scan.input_columns, in_cols, n, n_p
    )
    fused_streams = None
    if fused_cfg is not None:
        global FUSED_GROUPBY_COUNT
        FUSED_GROUPBY_COUNT += 1

        def _spec_stream(spec):
            src = spec[0]
            if isinstance(src, int):
                return _device_i32_stream(
                    name_to_col[scan.input_columns[src][0]], col_data[src]
                )
            # "value"/"gid" need no extra stream; "mask" computes
            # in-program from the device columns
            return None

        gid_i32 = _device_i32_stream(key_col, col_data[key_input_idx])
        val_i32 = (
            _device_i32_stream(
                name_to_col[scan.input_columns[sum_src_idx][0]],
                col_data[sum_src_idx],
            )
            if sum_src_idx is not None
            else None
        )
        pred_i32 = _spec_stream(fused_cfg[0][0])
        pred2_i32 = (
            _spec_stream(fused_cfg[0][1]) if len(fused_cfg[0]) > 1 else None
        )
        fused_streams = (gid_i32, val_i32, pred_i32, pred2_i32)
    if fused_cfg is None and multi_cfg is not None:
        global MULTI_SUM_GROUPBY_COUNT
        MULTI_SUM_GROUPBY_COUNT += 1
    packed = fn(
        tuple(col_data), tuple(col_valid), _n_scalar(n), fused_streams
    )

    # ONE transfer of the packed [counts, out0, ...] stack
    _t0 = _time.perf_counter()
    packed_h = np.asarray(packed)
    DEVICE_WAIT[0] += _time.perf_counter() - _t0
    counts_h, outs_h = packed_h[0], list(packed_h[1:])
    occupied = np.nonzero(counts_h > 0)[0]
    ng = len(occupied)

    from eventql_tpu.exec.vector_eval import EvalContext, evaluate_vector

    out_cols = []
    for tag, emit, idxs in layout:
        if tag == "key":
            if key_stype == SType.STRING:
                # bucket K is the NULL group: id 0 placeholder, valid
                # False
                is_null_grp = occupied == K
                out_cols.append(
                    Column(
                        SType.STRING,
                        np.where(is_null_grp, 0, occupied).astype(np.int32),
                        ~is_null_grp,
                        key_col.dictionary,
                    )
                )
            else:
                # numeric key: bucket id -> key value (base + id); the
                # route requires all-valid keys, so no NULL group
                from eventql_tpu.exec.relation import dtype_for

                payload = (
                    occupied.astype(np.int64) + np.int64(key_base)
                    if key_stype == SType.INT64
                    else occupied.astype(np.uint64) + np.uint64(key_base)
                )
                out_cols.append(
                    Column(
                        key_stype,
                        payload.astype(dtype_for(key_stype)),
                        np.ones(ng, bool),
                    )
                )
        else:
            agg_cols = []
            for slot, i in enumerate(idxs):
                rtype = entries_aggs_rtypes[(id(emit), slot)]
                data = outs_h[i][occupied].astype(np.uint64)
                if rtype == SType.INT64:
                    data = data.view(np.int64)
                agg_cols.append(
                    Column(rtype, data, np.ones(ng, bool))
                )
            ctx = EvalContext(agg_cols, ng)
            out_cols.append(evaluate_vector(emit, ctx))

    names = [sl.column_name() for sl in node.select_list]
    return Relation(names, out_cols, ng)


def execute_device_groupby(node: qn.GroupByNode, txn) -> Optional[Relation]:
    """Compile + run Scan→Filter→GroupBy as one device program.

    Returns None on empty tables: the host path builds the correct
    typed empty relation (0 groups) / ungrouped-aggregate row."""
    import jax
    import jax.numpy as jnp

    from eventql_tpu.exec.operators import _count_subject, _strip_aggregates
    from eventql_tpu.kernels.groupby import masked_grouped_aggregate

    scan: qn.SequentialScanNode = node.table
    table = txn.get_table_data(scan.table_name)
    n = table.num_rows
    if n == 0:
        return None
    if not _scan_inputs_present(table, scan):
        return None

    in_cols = _to_device_cols(table.columns, table.names, scan.input_columns)

    # gather all aggregate calls across select entries
    entries = []
    all_aggs: List[CallExpressionNode] = []
    for sl in node.select_list:
        if has_aggregate_call(sl.expr):
            aggs: List[CallExpressionNode] = []
            emit = _strip_aggregates(sl.expr, aggs)
            base = len(all_aggs)
            all_aggs.extend(aggs)
            entries.append(("agg", emit, base))
        else:
            entries.append(("first", sl.expr, None))

    # count(x) counts every row, NULL or not (aggregate.cc:35-38);
    # device tables are flat so no occurrence gating applies
    agg_kinds = [a.sfunction.aggregate.kind for a in all_aggs]

    stypes = [c.stype for c in in_cols]

    def program(col_data, col_valid, n_real):
        # the device arrays arrive as ARGUMENTS so the jitted program
        # is reusable across executions (the _cached_jit contract);
        # everything else the body reads is covered by the fingerprint.
        # Rows arrive padded to a coarse bucket (_pad_rows) so table
        # growth shares compiled programs; n_real masks the pad out.
        in_cols_l = [
            jax_expr.DeviceCol(st, d, v)
            for st, d, v in zip(stypes, col_data, col_valid)
        ]
        nn = col_data[0].shape[0] if col_data else n
        # scan select exprs (the child's computed columns)
        scan_cols = [
            jax_expr.compile_expr(sl.expr, in_cols_l, nn)
            for sl in scan.select_list
        ]
        if scan.where_expr is not None:
            mask = jax_expr.compile_expr(scan.where_expr, in_cols_l, nn).data
        else:
            mask = jnp.ones((nn,), jnp.bool_)
        mask = mask & (jnp.arange(nn, dtype=jnp.int32) < n_real)

        key_cols = [
            jax_expr.compile_expr(g, scan_cols, nn) for g in node.group_exprs
        ]
        if not key_cols:
            key_cols = [
                jax_expr.DeviceCol(
                    SType.UINT64,
                    jnp.zeros((nn,), jnp.uint64),
                    jnp.ones((nn,), jnp.bool_),
                )
            ]

        # aggregate inputs; count_distinct runs its own sort pass and
        # merges back positionally (group order is shared — both sort
        # by the same keys)
        vals = []
        kinds = []
        positions = []  # (slot, "main"|"distinct", idx)
        distinct_vals = []
        for a, kind in zip(all_aggs, agg_kinds):
            if kind == "count":
                positions.append(("main", len(vals)))
                vals.append(jnp.zeros((nn,), jnp.uint64))
                kinds.append("count")
            elif kind == "count_distinct":
                c = jax_expr.compile_expr(a.args[0], scan_cols, nn)
                positions.append(("distinct", len(distinct_vals)))
                # host convention: payloads truncate via uint64 cast
                distinct_vals.append(c.data.astype(jnp.uint64))
            else:
                c = jax_expr.compile_expr(a.args[0], scan_cols, nn)
                positions.append(("main", len(vals)))
                vals.append(c.data)
                kinds.append(kind)
        if not vals:
            vals = [jnp.zeros((nn,), jnp.uint64)]
            kinds = ["count"]

        # keys: fold validity into the key bits like the host engine
        def key_bits(k):
            if k.data.dtype == jnp.float64:
                # order/equality-preserving key
                from eventql_tpu.kernels.groupby import f64_sort_bits

                bits = f64_sort_bits(k.data)
            else:
                bits = k.data.astype(jnp.uint64)
            return jnp.where(k.valid, bits, jnp.uint64(0))

        key_arrays = tuple(key_bits(k) for k in key_cols)
        # null tag as an extra key column per key
        null_keys = tuple((~k.valid).astype(jnp.uint64) for k in key_cols)

        gk, main_out, first_idx, ng = masked_grouped_aggregate(
            mask, key_arrays + null_keys, tuple(vals), tuple(kinds)
        )
        if distinct_vals:
            from eventql_tpu.kernels.groupby import (
                masked_grouped_count_distinct,
            )

            distinct_out = [
                masked_grouped_count_distinct(
                    mask, key_arrays + null_keys, dv
                )
                for dv in distinct_vals
            ]
        else:
            distinct_out = []
        aggs_out = tuple(
            main_out[idx] if which == "main" else distinct_out[idx]
            for which, idx in positions
        )
        return gk, aggs_out, first_idx, ng, [c.data for c in scan_cols], [
            c.valid for c in scan_cols
        ]

    key = (
        "groupby",
        _plan_fingerprint_cached(node),
        tuple(int(st) for st in stypes),
        n if not in_cols else None,
    )
    fn = _cached_jit(key, lambda: program)
    # pad rows to a coarse static bucket so table growth (LSM serving)
    # shares compiled programs; the program masks the pad out via
    # n_real (the string route does the same, _pad_rows). The padded
    # transfers cache on the host Columns like _device_cache.
    n_p = _pad_rows(n) if in_cols else n
    col_data, col_valid = _padded_device_arrays(
        table, scan.input_columns, in_cols, n, n_p
    )
    gk, aggs_out, first_idx, ng, scan_data, scan_valid = fn(
        tuple(col_data), tuple(col_valid), _n_scalar(n)
    )
    ng = int(ng)

    # device-side compaction before ANY array readback: the program's
    # outputs are n-sized (static shapes under jit), but only ng rows
    # are real — transferring n-sized arrays makes device→host
    # bandwidth the whole route's bottleneck. One cached program slices the
    # aggregates/first-index to a power-of-two pad of ng and gathers
    # the per-group first rows of the scan columns, so the transfer is
    # O(groups), not O(rows).
    need_rows = any(kind == "first" for (kind, _e, _b) in entries)
    (aggs_small, first_small, rows_data, rows_valid) = (
        _device_compact_groups(
            aggs_out, first_idx, scan_data, scan_valid, n, ng, need_rows
        )
    )

    # ONE batched transfer for everything the host needs
    aggs_h, first_raw, rows_d_h, rows_v_h = _batched_device_get(
        (list(aggs_small), first_small, list(rows_data), list(rows_valid))
    )

    # host-side: build output columns
    agg_cols: List[Column] = []
    for a, arr in zip(all_aggs, aggs_h):
        rtype = a.sfunction.return_type
        arr = arr[:ng]
        from eventql_tpu.exec.relation import dtype_for

        agg_cols.append(
            Column(rtype, arr.astype(dtype_for(rtype)), np.ones(ng, bool))
        )

    first_idx_h = first_raw[:ng]
    # reorder groups by first occurrence (host-engine group order)
    order = np.argsort(first_idx_h, kind="stable")
    agg_cols = [c.gather(order) for c in agg_cols]

    from eventql_tpu.exec.vector_eval import EvalContext, evaluate_vector

    out_cols: List[Column] = []
    name_to_col = dict(zip(table.names, table.columns))
    scan_host_cols = []
    if need_rows:
        for sl, d, v in zip(scan.select_list, rows_d_h, rows_v_h):
            rtype = sl.expr.return_type()
            dictionary = None
            if rtype == SType.STRING:
                # device strings are dictionary ids (eligibility
                # restricts them to plain column refs); reattach the
                # input column's dictionary for the host-side emit
                src = scan.input_columns[sl.expr.column_index][0]
                dictionary = name_to_col[src].dictionary
            scan_host_cols.append(
                Column(rtype, d[:ng], v[:ng], dictionary)
            )
    for (kind, expr, base) in entries:
        if kind == "agg":
            ctx = EvalContext(agg_cols[base:], ng)
            out_cols.append(evaluate_vector(expr, ctx))
        else:
            # scan_host_cols already hold each group's FIRST row
            ctx = EvalContext(scan_host_cols, ng)
            out_cols.append(evaluate_vector(expr, ctx).gather(order))

    names = [sl.column_name() for sl in node.select_list]
    return Relation(names, out_cols, ng)


def _batched_device_get(tree):
    """device→host fetch with the transfers STARTED asynchronously for
    every leaf before any blocking wait — jax.device_get converts
    leaves one at a time, which serializes one transfer latency PER
    ARRAY; prefetching overlaps them."""
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(tree)
    for x in leaves:
        try:
            x.copy_to_host_async()
        except AttributeError:
            pass
    _t0 = _time.perf_counter()
    out = [np.asarray(x) for x in leaves]
    DEVICE_WAIT[0] += _time.perf_counter() - _t0
    return jax.tree_util.tree_unflatten(treedef, out)


_N_SCALAR_CACHE = {}


def _n_scalar(n: int):
    """Cached device scalar for the n_real program argument (a fresh
    jnp.int32 per query is a host->device put)."""
    import jax.numpy as jnp

    v = _N_SCALAR_CACHE.get(n)
    if v is None:
        if len(_N_SCALAR_CACHE) > 4096:
            _N_SCALAR_CACHE.clear()
        v = jnp.int32(n)
        _N_SCALAR_CACHE[n] = v
    return v


def _padded_device_arrays(table, input_columns, in_cols, n, n_p):
    """Device arrays padded to n_p rows, cached per host Column (same
    invalidation as _device_cache: columns rebuild on mutation). The
    pad keeps compiled programs shared across table sizes without an
    extra per-query device pad op."""
    import jax.numpy as jnp

    if n_p == n:
        return [c.data for c in in_cols], [c.valid for c in in_cols]
    by_name = dict(zip(table.names, table.columns))
    data_out, valid_out = [], []
    for (cname, _t), dc in zip(input_columns, in_cols):
        host_c = by_name[cname]
        cached = getattr(host_c, "_device_cache_pad", None)
        if cached is None or cached[0] != n_p:
            with _column_cache_lock():
                cached = getattr(host_c, "_device_cache_pad", None)
                if cached is None or cached[0] != n_p:
                    cached = (
                        n_p,
                        jnp.pad(dc.data, (0, n_p - n)),
                        jnp.pad(dc.valid, (0, n_p - n)),
                    )
                    try:
                        host_c._device_cache_pad = cached
                    except AttributeError:
                        pass
        data_out.append(cached[1])
        valid_out.append(cached[2])
    return data_out, valid_out


def _device_compact_groups(
    aggs_out, first_idx, scan_data, scan_valid, n, ng, need_rows
):
    """One cached device call compacting a group-aggregate program's
    n-sized outputs to a power-of-two pad of ng rows before transfer;
    when first-row entries exist, also gathers each group's first scan
    row (an O(groups) gather — cheap — instead of an O(rows)
    readback)."""
    import jax.numpy as jnp

    n_in = int(first_idx.shape[0])  # may exceed n (row padding)
    ngp = max(16, 1 << max(0, ng - 1).bit_length())
    ngp = min(ngp, max(n_in, 1))
    key = (
        "compact_groups",
        ngp,
        bool(need_rows),
        n,
        n_in,
        tuple(str(a.dtype) for a in aggs_out),
        tuple(str(d.dtype) for d in scan_data) if need_rows else (),
    )

    def make():
        def prog(aggs, fidx, sdata, svalid):
            f = fidx[:ngp]
            outs = tuple(a[:ngp] for a in aggs)
            if need_rows:
                fc = jnp.clip(f, 0, max(n - 1, 0))
                rows_d = tuple(d[fc] for d in sdata)
                rows_v = tuple(v[fc] for v in svalid)
            else:
                rows_d = ()
                rows_v = ()
            return outs, f, rows_d, rows_v

        return prog

    fn = _cached_jit(key, make)
    outs, f, rows_d, rows_v = fn(
        tuple(aggs_out),
        first_idx,
        tuple(scan_data) if need_rows else (),
        tuple(scan_valid) if need_rows else (),
    )
    return outs, f, rows_d, rows_v


# -- SELECT ... ORDER BY ... LIMIT on device (top-k scan) ---------------


def _dictionary_sorted(c: Column) -> bool:
    """True when the column dictionary is in ascending byte order (the
    ingest paths build dictionaries with np.unique, which sorts), so
    dictionary ids are order-preserving ranks. Cached per Column."""
    cached = getattr(c, "_dict_sorted_cache", None)
    if cached is None:
        e = c.dictionary
        cached = all(e[i] <= e[i + 1] for i in range(len(e) - 1))
        try:
            c._dict_sorted_cache = cached
        except AttributeError:
            pass
    return cached


def _device_host_order_key(c, descending: bool, null_rank):
    """uint64 keys whose ascending unsigned order equals the host
    engine's sort order for this column (operators._sort_key_arrays +
    its descending transforms):
      - NULL numerics sort as 0 of the dtype; NULL strings sort as the
        literal "NULL" among the dictionary entries (null_rank is the
        precomputed host rank of that label);
      - floats: -0.0 ties +0.0 (host compares values) and NaN sorts
        LAST in both directions (np.lexsort semantics);
      - descending is an order-reversing bijection (no INT64_MIN wrap).
    """
    import jax.numpy as jnp

    from eventql_tpu.kernels.groupby import sortable_u64

    if c.stype == SType.STRING:
        d = c.data.astype(jnp.int64)
        q = jnp.int64(null_rank)
        rank = jnp.where(c.valid, d + (d >= q).astype(jnp.int64), q)
        k = rank.astype(jnp.uint64)
        return ~k if descending else k
    if c.data.dtype == jnp.float64:
        x = jnp.where(c.valid, c.data, jnp.float64(0.0))
        x = x + jnp.float64(0.0)  # -0.0 -> +0.0: host value-compare ties
        k = sortable_u64(x)
        if descending:
            k = ~k
        return jnp.where(
            jnp.isnan(x), jnp.uint64(0xFFFFFFFFFFFFFFFF), k
        )
    zero = jnp.zeros((), c.data.dtype)
    x = jnp.where(c.valid, c.data, zero)
    k = sortable_u64(x)
    return ~k if descending else k


def _host_float_order_key(col: Column, descending: bool) -> "np.ndarray":
    """Exact uint64 host-order key for a FLOAT64 column, mirroring
    _device_host_order_key's float semantics bit-for-bit (NULL as 0.0,
    -0.0 normalized to +0.0, NaN last in both directions). Cached on
    the Column per direction (columns rebuild on mutation — the same
    invalidation as _narrow_cache), so repeated float-key sorts don't
    recompute or re-transfer the key column."""
    cache = getattr(col, "_host_fkey_cache", None)
    if cache is not None and descending in cache:
        return cache[descending]
    x = np.where(col.valid, col.data, 0.0) + 0.0
    bits = x.view(np.uint64)
    sign = bits >> np.uint64(63)
    k = np.where(sign == 1, ~bits, bits ^ np.uint64(1 << 63))
    if descending:
        k = ~k
    out = np.where(np.isnan(x), np.uint64(0xFFFFFFFFFFFFFFFF), k)
    try:
        if cache is None:
            cache = col._host_fkey_cache = {}
        cache[descending] = out
    except AttributeError:
        pass
    return out


def _emit_scan_rows(scan, table, cand: "np.ndarray", lo=0, hi=None) -> Relation:
    """Materialize the chosen rows through the HOST evaluator: the
    device decided only the ORDER (indices); values/formatting come
    from the exact host expression path, so no output-transport
    divergence is possible."""
    from eventql_tpu.exec.vector_eval import EvalContext, evaluate_vector

    cand = cand[lo:hi]
    name_to_col = dict(zip(table.names, table.columns))
    in_rows = [name_to_col[cname].gather(cand) for cname, _t in scan.input_columns]
    ctx = EvalContext(in_rows, len(cand))
    out_cols = [evaluate_vector(sl.expr, ctx) for sl in scan.select_list]
    names = [sl.column_name() for sl in scan.select_list]
    return Relation(names, out_cols, len(cand))


def _pad_window(w: int, n_p: int) -> int:
    """Round the top-k window up to a power of two (>=16) so distinct
    LIMIT values share compiled kernel variants."""
    p = 16
    while p < w:
        p <<= 1
    return min(p, n_p)


def _prep_device_scan_order(order_node: qn.OrderByNode, txn):
    """Shared front half of the device ORDER BY routes: eligibility,
    table fetch, scan/WHERE compile, host-order key construction.
    Returns (scan, table, mask, maskp, keys, n, n_p, pad) or None."""
    import bisect

    import jax.numpy as jnp

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
    if scan.where_expr is not None and not jax_expr.expr_is_device_compatible(
        scan.where_expr
    ):
        return None

    # select entries referenced by the sort exprs (only those compile
    # on device; the full select list is materialized by the host for
    # just the winning rows)
    needed = set()
    stack = [s.expr for s in specs]
    while stack:
        e = stack.pop()
        if isinstance(e, ColumnReferenceNode):
            if e.column_index is None or e.column_index >= len(scan.select_list):
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
    if not _scan_inputs_present(table, scan):
        return None
    name_to_col = dict(zip(table.names, table.columns))

    # STRING sort keys ride dictionary ids; ids are order-preserving
    # only for sorted dictionaries, and the host sorts NULL as the
    # literal "NULL" among the entries (operators._sort_key_arrays).
    null_ranks = [None] * len(specs)
    # static [lo, hi] bound on each u64 host-order key (pre-descending):
    # string ranks are bounded by the dictionary size, and plain-ref
    # numeric keys by the column's physically-narrowed dtype. A bounded
    # key downcasts to uint32 (or uint16) after the descending flip, so
    # the sort moves fewer bytes.
    bounds = [None] * len(specs)
    _M64 = 0xFFFFFFFFFFFFFFFF
    _NARROW_BOUNDS = {
        np.dtype(np.uint16): (0, 0xFFFF),
        np.dtype(np.uint32): (0, 0xFFFFFFFF),
        np.dtype(np.int16): ((1 << 63) - (1 << 15), (1 << 63) + (1 << 15) - 1),
        np.dtype(np.int32): ((1 << 63) - (1 << 31), (1 << 63) + (1 << 31) - 1),
        np.dtype(np.bool_): (0, 1),
    }
    for si, s in enumerate(specs):
        rt = s.expr.return_type()
        if rt == SType.STRING:
            inner = scan.select_list[s.expr.column_index].expr
            src = name_to_col[scan.input_columns[inner.column_index][0]]
            if src.dictionary is None or not _dictionary_sorted(src):
                return None
            entries = list(src.dictionary.astype(bytes))
            null_ranks[si] = bisect.bisect_right(entries, b"NULL")
            bounds[si] = (0, len(entries))
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

    n_p = _pad_rows(n)
    pad = n_p - n

    in_cols = _to_device_cols(table.columns, table.names, scan.input_columns)
    scan_cols = [None] * len(scan.select_list)
    for i in needed:
        scan_cols[i] = jax_expr.compile_expr(
            scan.select_list[i].expr, in_cols, n
        )
    if scan.where_expr is not None:
        mask = jax_expr.compile_expr(scan.where_expr, in_cols, n).data
    else:
        mask = jnp.ones((n,), jnp.bool_)
    keys = [
        _device_host_order_key(
            jax_expr.compile_expr(s.expr, scan_cols, n),
            s.descending,
            null_ranks[si],
        )
        for si, s in enumerate(specs)
    ]
    # downcast statically-bounded keys: (key - lo) is a strictly
    # monotonic bijection of [lo, hi] onto [0, hi - lo] that fits u32
    # (or u16 — dictionary ranks usually do); garbage values in
    # padded/filtered rows are harmless because the leading filter-mask
    # key sinks them and both routes drop them
    for si, b in enumerate(bounds):
        if b is None:
            continue
        span = b[1] - b[0]
        if span <= 0xFFFF:
            keys[si] = (keys[si] - jnp.uint64(b[0])).astype(jnp.uint16)
        elif span <= 0xFFFFFFFF:
            keys[si] = (keys[si] - jnp.uint64(b[0])).astype(jnp.uint32)
    maskp = jnp.pad(mask, (0, pad))
    return scan, table, mask, maskp, keys, n, n_p, pad


def try_execute_device_scan_topk(node: qn.LimitNode, txn) -> Optional[Relation]:
    """SELECT ... FROM t [WHERE ...] ORDER BY ... LIMIT k on device.

    The reference materializes every row and std::sorts with compiled
    comparators, then trims (orderby.cc:58-168 + limit.cc); here the
    scan + WHERE + sort keys evaluate on-device and the window comes
    from the device top-k (kernels/sort.py), falling back to the device
    full sort for multi-key specs. Only the winning row INDICES
    leave the device; the host evaluator materializes those few rows.

    Filtered rows are excluded by forcing their top-key to 0. A passing
    row whose key is legitimately 0 (the very last value in host order,
    e.g. NaN or UINT64_MAX) can then tie with filtered rows, so the
    host verifies the window (all passing-zero rows captured) and
    reruns via the always-exact masked full sort when the rare corner
    trips. Returns None when the plan shape is not routable."""
    import jax.numpy as jnp

    from eventql_tpu.kernels.sort import order_permutation, topk_permutation

    order_node = node.table
    if not isinstance(order_node, qn.OrderByNode):
        return None
    w = node.offset + node.limit
    if w == 0:
        return None
    prep = _prep_device_scan_order(order_node, txn)
    if prep is None:
        return None
    scan, table, mask, maskp, keys, n, n_p, pad = prep
    w = min(w, n)
    lo = node.offset
    hi = node.offset + node.limit

    if len(keys) == 1:
        # top-k fast path: host-FIRST row <-> LARGEST flipped key;
        # ties break toward the lowest row index = host stable order.
        # A statically-bounded (u32-downcast) key stays narrow
        k0 = keys[0]
        zero = jnp.zeros((), k0.dtype)
        ktop = jnp.where(mask, ~k0, zero)
        npz = jnp.sum(jnp.logical_and(mask, ktop == zero))
        ktop_p = jnp.pad(ktop, (0, pad))
        idx = topk_permutation(ktop_p, _pad_window(w, n_p))
        # ONE batched transfer (idx, window mask, window keys, zero-key
        # count) instead of one readback per array
        idx_h, mask_w, kw, npz_h = _batched_device_get(
            (idx, maskp[idx], ktop_p[idx], npz)
        )
        if bool(mask_w.all()):
            return _emit_scan_rows(scan, table, idx_h, lo, hi)
        # filtered rows in the window: exact iff every passing zero-key
        # row is inside it (rows outside then all have key 0)
        if int((mask_w & (kw == 0)).sum()) == int(npz_h):
            return _emit_scan_rows(scan, table, idx_h[mask_w], lo, hi)

    # multi-key specs / top-k corner: stable full sort with the
    # filter mask as the leading key (passing rows first, host order)
    mkey = (~maskp).astype(jnp.uint32)
    ops = (mkey,) + tuple(jnp.pad(k, (0, pad)) for k in keys)
    perm = order_permutation(ops)
    idx_h, mask_w = _batched_device_get((perm[:w], maskp[perm[:w]]))
    return _emit_scan_rows(scan, table, idx_h[mask_w], lo, hi)


def try_execute_device_scan_order(
    order_node: qn.OrderByNode, txn
) -> Optional[Relation]:
    """Full SELECT ... FROM t [WHERE ...] ORDER BY ... on device (no
    LIMIT above): the stable device sort over order-preserving keys
    replaces the host's np.lexsort (the reference std::sorts
    materialized SValue rows, orderby.cc:119). The filter mask leads
    the key tuple so filtered
    rows sink; the host materializes the passing rows in order."""
    import jax.numpy as jnp

    from eventql_tpu.kernels.sort import order_permutation

    prep = _prep_device_scan_order(order_node, txn)
    if prep is None:
        return None
    scan, table, mask, maskp, keys, n, n_p, pad = prep
    mkey = (~maskp).astype(jnp.uint32)
    ops = (mkey,) + tuple(jnp.pad(k, (0, pad)) for k in keys)
    perm = order_permutation(ops)[:n]
    idx_h, mask_w = _batched_device_get((perm, maskp[perm]))
    return _emit_scan_rows(scan, table, idx_h[mask_w])


# -- SQL JOIN ... GROUP BY on device -----------------------------------
def _join_ref(node, expr):
    """Resolve a join-input ColumnReferenceNode to its
    (table_idx, column_idx) or None."""
    if not isinstance(expr, ColumnReferenceNode):
        return None
    if expr.column_index is None:
        return None
    ref = node.input_map[expr.column_index]
    return ref.table_idx, ref.column_idx


def _rewrite_join_refs(node, expr, side: int):
    """Rewrite a join-input expression to reference one side's output
    columns directly; returns None if it touches the other side."""
    import copy

    if isinstance(expr, ColumnReferenceNode):
        r = _join_ref(node, expr)
        if r is None or r[0] != side:
            return None
        out = copy.copy(expr)
        out.column_index = r[1]
        return out
    if isinstance(expr, CallExpressionNode):
        new_args = []
        for a in expr.args:
            na = _rewrite_join_refs(node, a, side)
            if na is None:
                return None
            new_args.append(na)
        out = copy.copy(expr)
        out.args = new_args
        return out
    if isinstance(expr, LiteralExpressionNode):
        return expr
    return None


def _child_ref(join, expr):
    """Resolve a GroupBy-child-output ColumnReferenceNode through the
    join's select list to (table_idx, side_output_column_idx)."""
    if not isinstance(expr, ColumnReferenceNode):
        return None
    if expr.column_index is None:
        return None
    if expr.column_index >= len(join.select_list):
        return None
    jexpr = join.select_list[expr.column_index].expr
    return _join_ref(join, jexpr)


def _rewrite_child_refs(join, expr, side: int):
    """Rewrite a GroupBy-child-output expression into one side's output
    columns (two hops: child output → join input map → side output);
    returns None if it touches the other side or a non-ref join
    column."""
    import copy

    if isinstance(expr, ColumnReferenceNode):
        r = _child_ref(join, expr)
        if r is None or r[0] != side:
            return None
        out = copy.copy(expr)
        out.column_index = r[1]
        return out
    if isinstance(expr, CallExpressionNode):
        new_args = []
        for a in expr.args:
            na = _rewrite_child_refs(join, a, side)
            if na is None:
                return None
            new_args.append(na)
        out = copy.copy(expr)
        out.args = new_args
        return out
    if isinstance(expr, LiteralExpressionNode):
        return expr
    return None


def join_groupby_analysis(node: qn.GroupByNode, txn):
    """Shared plan analysis of the fact-dim JOIN + GROUP BY device
    shape (used by the single-chip route below and the mesh route in
    exec/mesh_exec.py): eligibility, join/group column resolution,
    host evaluation of the dimension side, aggregate rewrites.

    Returns None when the plan is outside the subset (the host engine
    takes over): non-INNER joins, multi-conjunction conditions,
    joined-side WHERE, duplicate/NULL join keys, non-u64 keys."""
    join = node.table
    if not isinstance(join, qn.JoinNode):
        return None
    if join.join_type != qn.JoinNode.INNER:
        return None
    base, joined = join.base_table, join.joined_table
    for scan in (base, joined):
        if not isinstance(scan, qn.SequentialScanNode):
            return None
        if scan.aggr_strategy != qn.SequentialScanNode.NO_AGGREGATION:
            return None
        if scan.keyrange is not None:
            return None  # partition-scoped: host path applies the range
    if join.join_cond is None:
        return None

    # exactly one equi conjunction of two bare column refs
    from eventql_tpu.exec.operators import (
        _count_subject,
        _find_join_conjunctions,
        _strip_aggregates,
        execute_node,
    )

    conjunctions = []
    _find_join_conjunctions(join, join.join_cond, conjunctions)
    if len(conjunctions) != 1:
        return None
    base_key_expr, joined_key_expr = conjunctions[0]
    bref = _join_ref(join, base_key_expr)
    jref = _join_ref(join, joined_key_expr)
    if bref is None or jref is None or bref[0] != 0 or jref[0] != 1:
        return None
    # the join condition must BE that single equality (no residual)
    cond = join.join_cond
    if not (
        isinstance(cond, CallExpressionNode) and cond.function_name == "eq"
    ):
        return None

    # WHERE must be fact-side only
    where_base = None
    if join.where_expr is not None:
        where_base = _rewrite_join_refs(join, join.where_expr, 0)
        if where_base is None or not jax_expr.expr_is_device_compatible(
            where_base
        ):
            return None

    # single joined-side group expression (a child-output column ref)
    if len(node.group_exprs) != 1:
        return None
    gref = _child_ref(join, node.group_exprs[0])
    if gref is None or gref[0] != 1:
        return None

    # select list: aggregates over fact-side exprs, or the group column
    entries = []
    all_aggs = []
    for sl in node.select_list:
        if has_aggregate_call(sl.expr):
            aggs: List[CallExpressionNode] = []
            emit = _strip_aggregates(sl.expr, aggs)
            rewritten = []
            for a in aggs:
                kind = a.sfunction.aggregate.kind
                if kind not in _DEVICE_AGGS:
                    return None  # e.g. count_distinct: host path
                if kind == "count":
                    # counts every joined row, NULL args included
                    # (aggregate.cc:35-38)
                    rewritten.append((a, "count", None))
                    continue
                subj = a.args[0] if a.args else None
                if subj is None:
                    rewritten.append((a, "count", None))
                    continue
                rsubj = _rewrite_child_refs(join, subj, 0)
                if rsubj is None or not jax_expr.expr_is_device_compatible(
                    rsubj
                ):
                    return None
                if (
                    kind == "count_distinct"
                    and rsubj.return_type() == SType.FLOAT64
                ):
                    return None  # host truncation parity (see above)
                rewritten.append((a, kind, rsubj))
            base_i = len(all_aggs)
            all_aggs.extend(rewritten)
            entries.append(("agg", emit, base_i))
        else:
            r = _child_ref(join, sl.expr)
            if r != gref:
                return None
            entries.append(("group", None, None))

    # joined side evaluates on host (dimension tables are small)
    dims = execute_node(joined, txn)
    dim_key_col = dims.columns[jref[1]]
    if dim_key_col.stype not in (SType.UINT64, SType.TIMESTAMP64):
        return None
    if not dim_key_col.valid.all():
        return None  # NULL keys join by tag in the host engine
    dim_keys_h = np.asarray(dim_key_col.data, dtype=np.uint64)
    if len(np.unique(dim_keys_h)) != len(dim_keys_h):
        return None  # duplicate dim keys fan out: host path

    # factorize the group column over dim rows → bucket per dim row
    from eventql_tpu.exec.operators import _factorize_rows, _group_key_matrix

    group_col = dims.columns[gref[1]]
    keys = _group_key_matrix([group_col], dims.num_rows)
    dim_bucket_h, firsts = _factorize_rows(keys)

    # fact side: the key scan-output expr must be a valid-everywhere
    # u64 column (NULL fact keys join by tag in the host engine)
    scan = base
    key_out_expr = scan.select_list[bref[1]].expr
    if not jax_expr.expr_is_device_compatible(key_out_expr):
        return None
    if key_out_expr.return_type() not in (SType.UINT64, SType.TIMESTAMP64):
        return None
    table = txn.get_table_data(scan.table_name)
    if table.num_rows == 0 or dims.num_rows == 0:
        return None  # empty inputs: host path builds the typed empty
    if not _scan_inputs_present(table, scan):
        return None
    if isinstance(key_out_expr, ColumnReferenceNode):
        in_name = scan.input_columns[key_out_expr.column_index][0]
        src = table.columns[table.names.index(in_name)]
        if not src.valid.all():
            return None
    else:
        return None  # only plain key columns prove non-NULL cheaply

    for sl in scan.select_list:
        if not jax_expr.expr_is_device_compatible(sl.expr):
            return None
    if scan.where_expr is not None and not jax_expr.expr_is_device_compatible(
        scan.where_expr
    ):
        return None

    return {
        "scan": scan,
        "table": table,
        "where_base": where_base,
        "bref": bref,
        "entries": entries,
        "all_aggs": all_aggs,
        "dims": dims,
        "dim_keys_h": dim_keys_h,
        "dim_bucket_h": dim_bucket_h,
        "firsts": firsts,
        "group_col": group_col,
    }


def try_execute_device_join_groupby(node: qn.GroupByNode, txn):
    """SELECT <group>, aggs(fact exprs) FROM facts JOIN dims ON
    f.k = d.k [WHERE fact-side predicate] GROUP BY <dim column> — as
    one device program: compiled scan + filter, binary-search dim join
    (kernels/join.py), fused masked group-aggregate. Returns None when
    the plan is outside the subset (the host engine takes over) — see
    join_groupby_analysis.

    The reference executes this shape as HashJoin feeding GroupBy
    (hash_join.cc + groupby.cc), row-at-a-time."""
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

    import jax
    import jax.numpy as jnp

    from eventql_tpu.kernels.groupby import masked_grouped_aggregate
    from eventql_tpu.kernels.join import dim_join_gid

    in_cols = _to_device_cols(table.columns, table.names, scan.input_columns)
    n = table.num_rows
    dim_keys_d = jnp.asarray(dim_keys_h)
    dim_bucket_d = jnp.asarray(dim_bucket_h.astype(np.int32))
    # bucket-space size for the bounded aggregate path (static: part
    # of the compiled-program cache key)
    K_static = len(firsts)

    stypes = [c.stype for c in in_cols]

    def program(col_data, col_valid, dimk, dimb):
        in_cols_l = [
            jax_expr.DeviceCol(st, d, v)
            for st, d, v in zip(stypes, col_data, col_valid)
        ]
        nn = col_data[0].shape[0] if col_data else n
        scan_cols = [
            jax_expr.compile_expr(sl.expr, in_cols_l, nn)
            for sl in scan.select_list
        ]
        mask = jnp.ones((nn,), jnp.bool_)
        if scan.where_expr is not None:
            mask &= jax_expr.compile_expr(
                scan.where_expr, in_cols_l, nn
            ).data
        if where_base is not None:
            mask &= jax_expr.compile_expr(where_base, scan_cols, nn).data

        fact_keys = scan_cols[bref[1]].data.astype(jnp.uint64)

        vals, kinds = [], []
        positions = []
        distinct_vals = []
        for _a, kind, rsubj in all_aggs:
            if kind == "count":
                positions.append(("main", len(vals)))
                vals.append(jnp.zeros((nn,), jnp.uint64))
                kinds.append("count")
            elif kind == "count_distinct":
                positions.append(("distinct", len(distinct_vals)))
                distinct_vals.append(
                    jax_expr.compile_expr(rsubj, scan_cols, nn)
                    .data.astype(jnp.uint64)
                )
            else:
                positions.append(("main", len(vals)))
                vals.append(jax_expr.compile_expr(rsubj, scan_cols, nn).data)
                kinds.append(kind)
        if not vals:
            vals = [jnp.zeros((nn,), jnp.uint64)]
            kinds = ["count"]

        # binary-search probe + payload gather (kernels/join.py)
        gid = dim_join_gid(fact_keys, dimk, dimb)
        m = mask & (gid >= 0)
        gid = jnp.maximum(gid, 0)
        iota = jnp.arange(nn, dtype=jnp.uint64)

        # bounded fast path: the join's gid is bounded by the dim
        # bucket count K, so sum/count aggregates take the one-pass
        # bounded scatter instead of the sort-based general kernel. The
        # first-surviving-base-row per bucket (presentation order)
        # comes from ONE single-operand sort of (gid<<32 | base_row)
        # probed with K searchsorteds.
        bounded_ok = (
            not distinct_vals
            and all(kk in ("sum", "count") for kk in kinds)
            and all(
                not jnp.issubdtype(v.dtype, jnp.floating) for v in vals
            )
            and nn < (1 << 32)
            and K_static > 0
        )
        if bounded_ok:
            from eventql_tpu.kernels.bucket_agg import (
                bounded_grouped_aggregate,
            )

            Kp = _pad_buckets(K_static)
            vals_u = tuple(v.astype(jnp.uint64) for v in vals)
            counts, outs = bounded_grouped_aggregate(
                m, gid, vals_u, tuple(kinds), Kp, value_bits=64
            )
            counts = counts[:K_static]
            outs = tuple(o[:K_static] for o in outs)
            packed = jnp.where(
                m,
                (gid.astype(jnp.uint64) << jnp.uint64(32)) | iota,
                jnp.uint64(0xFFFFFFFFFFFFFFFF),
            )
            ps = jax.lax.sort([packed], num_keys=1)[0]
            qk = jnp.arange(K_static, dtype=jnp.uint64) << jnp.uint64(32)
            pos = jnp.minimum(
                jnp.searchsorted(ps, qk, side="left"), nn - 1
            )
            hit = (ps[pos] >> jnp.uint64(32)) == jnp.arange(
                K_static, dtype=jnp.uint64
            )
            first = jnp.where(
                hit, ps[pos] & jnp.uint64(0xFFFFFFFF), jnp.uint64(nn)
            )
            occupied = counts > 0
            order = jnp.argsort(~occupied, stable=True)
            ng = occupied.sum()
            gk0 = order.astype(jnp.uint64)  # group keys = bucket ids
            aggs_out = tuple(outs[idx][order] for _w, idx in positions)
            return gk0, aggs_out, first[order], ng

        # general path (float sums, min/max/mean, count_distinct):
        # min base-row-index per bucket drives presentation order
        # (inner join on unique dim keys: first surviving pair = the
        # bucket's smallest base row index)
        vals.append(iota)
        kinds.append("min")

        key = (gid.astype(jnp.uint64),)
        gk, main_out, _first_idx, ng = masked_grouped_aggregate(
            m, key, tuple(vals), tuple(kinds)
        )
        from eventql_tpu.kernels.groupby import (
            masked_grouped_count_distinct,
        )

        distinct_out = [
            masked_grouped_count_distinct(m, key, dv)
            for dv in distinct_vals
        ]
        aggs_out = tuple(
            main_out[idx] if which == "main" else distinct_out[idx]
            for which, idx in positions
        )
        return gk[0], aggs_out, main_out[-1], ng

    key = (
        "join",
        _plan_fingerprint_cached(node),
        tuple(int(st) for st in stypes),
        K_static,
        n if not in_cols else None,
    )
    fn = _cached_jit(key, lambda: program)
    gk, aggs_out, first_base, ng = fn(
        tuple(c.data for c in in_cols),
        tuple(c.valid for c in in_cols),
        dim_keys_d,
        dim_bucket_d,
    )
    ng = int(ng)

    # single-call device compaction to O(groups) before readback (see
    # _device_compact_groups)
    smalls, first_small, _rd, _rv = _device_compact_groups(
        tuple(aggs_out) + (gk,),
        first_base,
        (),
        (),
        int(first_base.shape[0]),
        ng,
        False,
    )
    gk_small = smalls[-1]
    aggs_small = smalls[:-1]

    # present buckets in first-surviving-pair order (base-row-major,
    # like the reference's probe loop)
    from eventql_tpu.exec.relation import dtype_for
    from eventql_tpu.exec.vector_eval import EvalContext, evaluate_vector

    first_h_raw, gk_h, aggs_h = _batched_device_get(
        (first_small, gk_small, list(aggs_small))
    )
    first_h = first_h_raw[:ng]
    order = np.argsort(first_h, kind="stable")
    buckets = gk_h[:ng].astype(np.int64)[order]

    agg_cols: List[Column] = []
    for (a, _kind, _subj), out in zip(all_aggs, aggs_h):
        rtype = a.sfunction.return_type
        arr = out[:ng][order]
        agg_cols.append(
            Column(rtype, arr.astype(dtype_for(rtype)), np.ones(ng, bool))
        )

    group_out = group_col.gather(firsts[buckets])

    out_cols: List[Column] = []
    for kind, expr, base_i in entries:
        if kind == "agg":
            ctx = EvalContext(agg_cols[base_i:], ng)
            out_cols.append(evaluate_vector(expr, ctx))
        else:
            out_cols.append(group_out)
    names = [sl.column_name() for sl in node.select_list]
    return Relation(names, out_cols, ng)
