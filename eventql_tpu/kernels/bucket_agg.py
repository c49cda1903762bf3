"""GROUP BY over bounded integer keys as one scatter-add pass.

Every row's bucket id (a dictionary id, or a numeric key minus its
minimum) selects one of K accumulator slots; `jax.ops.segment_sum`
scatters count and sum into them. XLA compiles the predicate compares,
the padding mask, the key base subtract and the scatter into one fused
pass over the raw column streams. Rows that are filtered out, padding,
or outside [0, K) take bucket K, which the scatter drops. The reference
runs the same aggregation as a per-row hash-map loop
(sql/statements/select/groupby.cc:69-219).

Sums are exact modulo 2^64: each value contributes its unsigned payload
(the low `value_bits`, rounded up to whole bytes, of its two's-complement
bits), and uint64 additions wrap.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

_PRED_CMP = {
    "lt": jnp.less,
    "le": jnp.less_equal,
    "gt": jnp.greater,
    "ge": jnp.greater_equal,
    "eq": jnp.equal,
    "ne": jnp.not_equal,
}


def _as_i32(stream: jax.Array) -> jax.Array:
    """A narrowed column stream as int32: 16-bit unsigned payloads
    zero-extend, signed ones sign-extend, 64-bit streams keep their low
    word."""
    if stream.dtype.itemsize == 8:
        return jax.lax.bitcast_convert_type(
            stream.astype(jnp.uint64), jnp.uint32
        )[..., 0].astype(jnp.int32)
    return stream.astype(jnp.int32)


def _payload_u64(values: jax.Array, value_bits: int) -> jax.Array:
    """The unsigned payload each value adds to a sum: its two's-
    complement bits, cut to ceil(value_bits / 8) bytes."""
    nbytes = -(-max(1, min(value_bits, 64)) // 8)
    if values.dtype.itemsize == 8:
        v = values.astype(jnp.uint64)
    else:
        if nbytes > 4:
            raise ValueError("value_bits > 32 requires a 64-bit stream")
        v = values.astype(jnp.int32).astype(jnp.uint32).astype(jnp.uint64)
    if nbytes < 8:
        v = v & jnp.uint64((1 << (8 * nbytes)) - 1)
    return v


def _bucket(keep: jax.Array, gid: jax.Array, num_buckets: int) -> jax.Array:
    """Bucket id per row; rows not kept or out of range go to slot
    num_buckets, which the scatter drops."""
    ok = keep & (gid >= 0) & (gid < num_buckets)
    return jnp.where(ok, gid, jnp.int32(num_buckets))


def _scatter(bucket: jax.Array, columns, num_buckets: int):
    """One scatter-add of the stacked uint64 columns into K slots."""
    stacked = jnp.stack(columns, axis=1)
    out = jax.ops.segment_sum(stacked, bucket, num_segments=num_buckets)
    return tuple(out[:, i] for i in range(len(columns)))


def _ones(n: int) -> jax.Array:
    return jnp.ones((n,), jnp.uint64)


@functools.partial(jax.jit, static_argnames=("num_buckets", "value_bits"))
def bounded_sum_count(
    mask: jax.Array,
    gid: jax.Array,
    values: jax.Array,
    num_buckets: int,
    value_bits: int = 64,
):
    """Filter + GROUP BY sum(values), count(*) for 0 <= gid < num_buckets.
    Returns (counts u64[K], sums u64[K])."""
    b = _bucket(mask, gid.astype(jnp.int32), num_buckets)
    return _scatter(
        b, (_ones(b.shape[0]), _payload_u64(values, value_bits)), num_buckets
    )


@functools.partial(
    jax.jit, static_argnames=("num_buckets", "stream_limbs")
)
def bounded_multi_sum(
    mask: jax.Array,
    gid: jax.Array,
    streams: Tuple[jax.Array, ...],
    stream_limbs: Tuple[int, ...],
    num_buckets: int,
):
    """Filter + GROUP BY of several summed streams in one scatter. Each
    stream's payload is the low 8 * stream_limbs[i] bits of its int32
    word; sums are exact mod 2^64. Returns (counts u64[K], sums)."""
    b = _bucket(mask, gid.astype(jnp.int32), num_buckets)
    cols = [_ones(b.shape[0])] + [
        _payload_u64(s.astype(jnp.int32), 8 * nl)
        for s, nl in zip(streams, stream_limbs)
    ]
    out = _scatter(b, cols, num_buckets)
    return out[0], tuple(out[1:])


def _fused_keep(
    gid_i32, lo_i32, thr, n_real, pred, pred_op, pred_src,
    pred2, pred2_op, thr2, pred2_src, pred_combine,
):
    streams = {"gid": gid_i32, "value": lo_i32}
    p = _as_i32(pred) if pred_src == "stream" else streams[pred_src]
    keep = _PRED_CMP[pred_op](p, jnp.asarray(thr).astype(jnp.int32))
    if pred2_op is not None:
        p2 = _as_i32(pred2) if pred2_src == "stream" else streams[pred2_src]
        keep2 = _PRED_CMP[pred2_op](p2, jnp.asarray(thr2).astype(jnp.int32))
        keep = (keep | keep2) if pred_combine == "or" else (keep & keep2)
    row = jnp.arange(gid_i32.shape[0], dtype=jnp.int32)
    return keep & (row < jnp.asarray(n_real).astype(jnp.int32))


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_buckets", "value_bits", "pred_op", "pred2_op",
        "pred2_is_value", "pred_combine",
    ),
)
def fused_sum_count(
    gid: jax.Array,
    values: jax.Array,
    thr: jax.Array,
    n_real: jax.Array,
    num_buckets: int,
    pred: jax.Array = None,
    value_bits: int = 32,
    pred_op: str = "lt",
    gid_base: jax.Array = 0,
    pred2: jax.Array = None,
    pred2_op: str = None,
    thr2: jax.Array = 0,
    pred2_is_value: bool = False,
    pred_combine: str = "and",
):
    """Scan + WHERE + GROUP BY sum(values), count(*) over raw narrowed
    column streams, as one program:

    * keep = `pred <op> thr` (pred defaults to the value stream itself),
      optionally combined ('and'/'or') with `pred2 <pred2_op> thr2`
      (pred2_is_value compares the value stream);
    * rows at index >= n_real are padding;
    * bucket = gid - gid_base, in modular int32 arithmetic (exact for
      key spans < 2^31).

    Compares run on int32 lanes: callers guarantee that every predicate
    payload and literal fits int32. Returns (counts u64[K], sums u64[K]).
    Replaces the reference's per-row WHERE evaluation feeding its
    hash-map accumulate (sql/CSTableScan.cc:813, groupby.cc:344-407)."""
    gid_i32 = _as_i32(gid)
    keep = _fused_keep(
        gid_i32, _as_i32(values), thr, n_real,
        pred, pred_op, "value" if pred is None else "stream",
        pred2, pred2_op, thr2, "value" if pred2_is_value else "stream",
        pred_combine,
    )
    b = _bucket(keep, gid_i32 - jnp.asarray(gid_base).astype(jnp.int32),
                num_buckets)
    return _scatter(
        b, (_ones(b.shape[0]), _payload_u64(values, value_bits)), num_buckets
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_buckets", "pred_op", "pred_on_gid", "pred2_op", "pred_combine",
    ),
)
def fused_count(
    gid: jax.Array,
    thr: jax.Array,
    n_real: jax.Array,
    num_buckets: int,
    pred: jax.Array = None,
    pred_op: str = "ge",
    gid_base: jax.Array = 0,
    pred_on_gid: bool = False,
    pred2: jax.Array = None,
    pred2_op: str = None,
    thr2: jax.Array = 0,
    pred_combine: str = "and",
):
    """count(*)-only form of fused_sum_count: no value stream. With no
    predicate column, pass pred=None, pred_op='ge', thr=INT32_MIN
    (always true). pred=None or pred_on_gid compares the key stream
    itself (before the base subtract); pred2=None likewise. Returns
    counts u64[K]."""
    gid_i32 = _as_i32(gid)
    keep = _fused_keep(
        gid_i32, None, thr, n_real,
        pred, pred_op,
        "gid" if pred is None or pred_on_gid else "stream",
        pred2, pred2_op, thr2, "gid" if pred2 is None else "stream",
        pred_combine,
    )
    b = _bucket(keep, gid_i32 - jnp.asarray(gid_base).astype(jnp.int32),
                num_buckets)
    return _scatter(b, (_ones(b.shape[0]),), num_buckets)[0]


@functools.partial(
    jax.jit, static_argnames=("num_buckets", "agg_kinds", "value_bits")
)
def bounded_grouped_aggregate(
    mask: jax.Array,
    gid: jax.Array,
    value_arrays: Tuple[jax.Array, ...],
    agg_kinds: Tuple[str, ...],
    num_buckets: int,
    value_bits: int = 64,
):
    """count/sum aggregates (any number of sums) for bounded keys in one
    scatter. Returns (counts u64[K], per-aggregate u64[K])."""
    b = _bucket(mask, gid.astype(jnp.int32), num_buckets)
    cols = [_ones(b.shape[0])]
    slots = []
    for i, kind in enumerate(agg_kinds):
        if kind == "count":
            slots.append(0)
        elif kind == "sum":
            slots.append(len(cols))
            cols.append(_payload_u64(value_arrays[i], value_bits))
        else:
            raise ValueError(f"unknown aggregate kind {kind}")
    out = _scatter(b, cols, num_buckets)
    return out[0], tuple(out[s] for s in slots)
