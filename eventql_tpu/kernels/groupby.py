"""Device grouped aggregation (sort-based, unbounded keys).

The reference's GroupBy is a per-row hash-map interpreter loop
(reference: sql/statements/select/groupby.cc:69-219). Here grouping is
a whole-column device program: lexicographic multi-key sort
(jax.lax.sort), segment-boundary detection, and segment reductions, all
inside one jit. Shapes are static: aggregates are returned padded to
`num_segments` groups with a group-count scalar.

Keys with a small static bound take the one-pass scatter form instead
(eventql_tpu.kernels.bucket_agg).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp

U64_SIGN = jnp.uint64(1 << 63)


def f64_sort_bits(data: jax.Array) -> jax.Array:
    """float64 -> uint64 keys whose unsigned ascending order equals the
    float order (and equality <-> key equality), for sort/group keys:
    the IEEE-754 total-order bit trick on the exact 64-bit pattern."""
    bits = jax.lax.bitcast_convert_type(data, jnp.uint64)
    sign = bits >> jnp.uint64(63)
    return jnp.where(sign == 1, ~bits, bits ^ U64_SIGN)


def sortable_u64(data: jax.Array, descending: bool = False) -> jax.Array:
    """Map a column to uint64 keys whose unsigned order equals the SQL
    order of the values (int64: flip sign bit; float64: IEEE-754 total
    order trick; bool/uint: identity)."""
    if data.dtype == jnp.uint64:
        k = data
    elif data.dtype == jnp.int64:
        k = data.astype(jnp.uint64) ^ U64_SIGN
    elif data.dtype == jnp.float64:
        k = f64_sort_bits(data)
    elif data.dtype == jnp.bool_:
        k = data.astype(jnp.uint64)
    elif data.dtype in (jnp.int32, jnp.uint32, jnp.int16, jnp.uint16):
        # via int64 so signed narrow values keep numeric order (a direct
        # uint64 cast would sign-extend negatives above every positive)
        k = data.astype(jnp.int64).astype(jnp.uint64) ^ U64_SIGN
    else:
        k = data.astype(jnp.uint64)
    if descending:
        k = ~k
    return k


def group_ids(
    key_arrays: Sequence[jax.Array],
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Assign group ids by multi-key sort.

    Returns (perm, gid_sorted, num_groups):
      perm        — permutation sorting rows by key tuple
      gid_sorted  — group id of each sorted row (dense, sorted order)
      num_groups  — scalar count of distinct key tuples
    """
    n = key_arrays[0].shape[0]
    iota = jnp.arange(n, dtype=jnp.int64)
    operands = [sortable_u64(k) for k in key_arrays] + [iota]
    sorted_ops = jax.lax.sort(operands, num_keys=len(key_arrays))
    sorted_keys, perm = sorted_ops[:-1], sorted_ops[-1]

    diff = jnp.zeros(n, dtype=jnp.bool_)
    for sk in sorted_keys:
        diff = diff | jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), sk[1:] != sk[:-1]]
        )
    gid = jnp.cumsum(diff.astype(jnp.int64)) - 1
    num_groups = gid[-1] + 1 if n > 0 else jnp.int64(0)
    return perm, gid, num_groups


@functools.partial(jax.jit, static_argnames=("agg_kinds",))
def grouped_aggregate(
    key_arrays: Tuple[jax.Array, ...],
    value_arrays: Tuple[jax.Array, ...],
    agg_kinds: Tuple[str, ...],
):
    """Aggregate value_arrays per distinct key tuple.

    agg_kinds[i] applies to value_arrays[i]: one of
    'sum', 'count', 'min', 'max', 'mean'.

    Returns (group_keys, aggregates, first_index, num_groups); all
    outputs padded to n rows, groups ordered by sorted key order.
    first_index is each group's smallest original row index (for
    first-row-wins semantics and first-occurrence ordering).
    """
    n = key_arrays[0].shape[0]
    perm, gid, num_groups = group_ids(key_arrays)

    group_keys = tuple(k[perm] for k in key_arrays)
    # representative (first sorted row) of each group
    seg_start = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), gid[1:] != gid[:-1]]
    )
    group_keys = tuple(
        jax.ops.segment_max(k, gid, num_segments=n) for k in group_keys
    )

    first_index = jax.ops.segment_min(perm, gid, num_segments=n)

    outs = []
    for vals, kind in zip(value_arrays, agg_kinds):
        v = vals[perm]
        if kind == "count":
            out = jax.ops.segment_sum(
                jnp.ones(n, dtype=jnp.uint64), gid, num_segments=n
            )
        elif kind == "sum":
            out = jax.ops.segment_sum(v, gid, num_segments=n)
        elif kind == "min":
            out = jax.ops.segment_min(v, gid, num_segments=n)
        elif kind == "max":
            out = jax.ops.segment_max(v, gid, num_segments=n)
        elif kind == "mean":
            s = jax.ops.segment_sum(v.astype(jnp.float64), gid, num_segments=n)
            c = jax.ops.segment_sum(
                jnp.ones(n, dtype=jnp.float64), gid, num_segments=n
            )
            out = s / c
        else:
            raise ValueError(f"unknown aggregate kind {kind}")
        outs.append(out)

    return group_keys, tuple(outs), first_index, num_groups


def _seg_scan(starts, vals, op):
    """Inclusive SEGMENTED scan over contiguous (sorted) segments:
    out[i] = op-fold of vals over [segment_start(i) .. i]. The
    (start-flag, value) combine is associative, so this lowers to
    jax.lax.associative_scan — log2(n) full-width vector passes."""

    def combine(a, b):
        af, av = a
        bf, bv = b
        return af | bf, jnp.where(bf, bv, op(av, bv))

    _f, out = jax.lax.associative_scan(combine, (starts, vals))
    return out


def _op_identity(dtype, kind):
    if kind == "min":
        if jnp.issubdtype(dtype, jnp.floating):
            return jnp.array(jnp.inf, dtype)
        return jnp.array(jnp.iinfo(dtype).max, dtype)
    if jnp.issubdtype(dtype, jnp.floating):
        return jnp.array(-jnp.inf, dtype)
    return jnp.array(jnp.iinfo(dtype).min, dtype)


@functools.partial(jax.jit, static_argnames=("agg_kinds",))
def masked_grouped_aggregate(
    mask: jax.Array,
    key_arrays: Tuple[jax.Array, ...],
    value_arrays: Tuple[jax.Array, ...],
    agg_kinds: Tuple[str, ...],
):
    """grouped_aggregate with a WHERE mask fused in: masked-out rows are
    routed to a sentinel key group that sorts last and is excluded from
    the group count — filter + aggregate in one device program, no
    host-side compaction (the reference evaluates the predicate vector
    then re-scans: sql/runtime/vm.cc:231-272).

    One multi-payload key sort carries the mask/row-index/original-key/
    value streams, per-group totals come from prefix sums or inclusive
    segmented scans (associative_scan, log2 n passes), and a single
    stable 1-bit partition sort compacts each group's end-of-segment row
    — where every scan holds its group's total — down to slot gid."""
    n = key_arrays[0].shape[0]
    # sentinel: all-ones keys sort last in unsigned order
    sentinel = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    keyed = tuple(
        jnp.where(mask, sortable_u64(k), sentinel) for k in key_arrays
    )
    nk = len(key_arrays)
    iota = jnp.arange(n, dtype=jnp.int32)
    operands = (
        list(keyed)
        + [mask, iota]
        + list(key_arrays)
        + list(value_arrays)
    )
    sorted_ops = jax.lax.sort(operands, num_keys=nk)
    sorted_keys = sorted_ops[:nk]
    mask_sorted = sorted_ops[nk]
    iota_s = sorted_ops[nk + 1]
    k_sorted = sorted_ops[nk + 2 : nk + 2 + nk]
    v_sorted = sorted_ops[nk + 2 + nk :]

    diff = jnp.zeros(n, dtype=jnp.bool_)
    for sk in sorted_keys:
        diff = diff | jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), sk[1:] != sk[:-1]]
        )
    gid = jnp.cumsum(diff.astype(jnp.int32)) - 1
    # number of groups among masked-in rows
    num_groups = jnp.where(
        mask_sorted.any(),
        jnp.max(jnp.where(mask_sorted, gid, -1)) + 1,
        0,
    ).astype(jnp.int64)

    # per-row scans whose value at each segment's END row recovers the
    # group total. Integer sum/count ride a PLAIN cumsum (native op;
    # the per-group total is the difference of adjacent compacted
    # prefix sums — exact mod 2^64); min/max/mean need the per-group
    # reset of a true segmented scan (associative_scan, log2 n passes;
    # mean stays segmented so f64 group sums don't cancel against the
    # whole-column prefix).
    scans = []
    prefix_diff = []  # which outputs need the post-compaction diff
    ones_u = jnp.where(mask_sorted, jnp.uint64(1), jnp.uint64(0))
    add = lambda a, b: a + b
    for vals, kind in zip(v_sorted, agg_kinds):
        if kind == "count":
            out = jnp.cumsum(ones_u)
            prefix_diff.append(True)
        elif kind == "sum":
            vz = jnp.where(mask_sorted, vals, jnp.zeros((), vals.dtype))
            if jnp.issubdtype(vz.dtype, jnp.integer):
                out = jnp.cumsum(vz)
                prefix_diff.append(True)
            else:
                out = _seg_scan(diff, vz, add)
                prefix_diff.append(False)
        elif kind in ("min", "max"):
            ident = _op_identity(vals.dtype, kind)
            vz = jnp.where(mask_sorted, vals, ident)
            op = jnp.minimum if kind == "min" else jnp.maximum
            out = _seg_scan(diff, vz, op)
            prefix_diff.append(False)
        elif kind == "mean":
            vz = jnp.where(mask_sorted, vals.astype(jnp.float64), 0.0)
            s = _seg_scan(diff, vz, add)
            c = _seg_scan(
                diff, jnp.where(mask_sorted, 1.0, 0.0), add
            )
            out = s / c
            prefix_diff.append(False)
        else:
            raise ValueError(f"unknown aggregate kind {kind}")
        scans.append(out)

    # per-group first (minimum) original row index WITHOUT a segmented
    # scan: gid is ascending, so cummax over pack = (gid << 32) |
    # (n - iota) can never be won by an earlier group (smaller gid ⇒
    # smaller pack), and within the group it maximizes n - iota, i.e.
    # minimizes iota. A native cummax replaces the log-depth
    # associative_scan — count/sum-only queries then compile with no
    # custom scan at all.
    pack = (gid.astype(jnp.int64) << 32) | jnp.where(
        mask_sorted, jnp.int64(n) - iota_s.astype(jnp.int64), jnp.int64(0)
    )
    packmax = jax.lax.cummax(pack)
    first_scan = jnp.where(
        (packmax & jnp.int64(0xFFFFFFFF)) > 0,
        jnp.int64(n) - (packmax & jnp.int64(0xFFFFFFFF)),
        jnp.int64(n),
    ).astype(jnp.int32)

    # compact each group's end row to slot gid: ends are already in
    # gid order, so a STABLE 1-bit partition sort is the whole gather
    is_end = jnp.concatenate([diff[1:], jnp.ones((1,), jnp.bool_)])
    pkey = jnp.where(is_end, jnp.int32(0), jnp.int32(1))
    comp = jax.lax.sort(
        [pkey, first_scan] + list(k_sorted) + scans,
        num_keys=1,
        is_stable=True,
    )
    first_index = comp[1].astype(jnp.int64)
    group_keys = tuple(comp[2 : 2 + nk])
    outs = []
    for out, needs_diff in zip(comp[2 + nk :], prefix_diff):
        if needs_diff:
            out = out - jnp.concatenate(
                [jnp.zeros((1,), out.dtype), out[:-1]]
            )
        outs.append(out)

    return group_keys, tuple(outs), first_index, num_groups


def masked_grouped_count_distinct(
    mask: jax.Array,
    key_arrays: Tuple[jax.Array, ...],
    values: jax.Array,
):
    """Per group: the number of distinct value payloads among masked-in
    rows (the reference's count_distinct is an exact hash-set per
    group, sql/expressions/aggregate.cc:74-120; the host engine
    np.uniques (gid, value) pairs). One extra sort keyed by
    (keys..., value); group order and count match
    masked_grouped_aggregate exactly (same key sort), so outputs align
    positionally with its groups."""
    n = key_arrays[0].shape[0]
    sentinel = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    keyed = tuple(
        jnp.where(mask, sortable_u64(k), sentinel) for k in key_arrays
    )
    vkey = jnp.where(mask, sortable_u64(values), sentinel)
    iota = jnp.arange(n, dtype=jnp.int64)
    sorted_ops = jax.lax.sort(
        list(keyed) + [vkey, iota], num_keys=len(keyed) + 1
    )
    skeys, svals, perm = sorted_ops[:-2], sorted_ops[-2], sorted_ops[-1]
    mask_sorted = mask[perm]

    group_diff = jnp.zeros(n, dtype=jnp.bool_)
    for sk in skeys:
        group_diff = group_diff | jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), sk[1:] != sk[:-1]]
        )
    val_diff = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), svals[1:] != svals[:-1]]
    )
    new_distinct = (group_diff | val_diff) & mask_sorted
    # scatter-free per-group totals: segmented scan + stable 1-bit
    # partition compaction (see masked_grouped_aggregate)
    scan = _seg_scan(
        group_diff,
        new_distinct.astype(jnp.uint64),
        lambda a, b: a + b,
    )
    is_end = jnp.concatenate([group_diff[1:], jnp.ones((1,), jnp.bool_)])
    pkey = jnp.where(is_end, jnp.int32(0), jnp.int32(1))
    comp = jax.lax.sort([pkey, scan], num_keys=1, is_stable=True)
    return comp[1]
