"""Distributed query execution over a jax.sharding.Mesh.

The reference distributes GROUP BY by shipping partial-aggregate plans
to partition servers over TCP and merging serialized accumulator states
on the coordinator (reference: sql/statements/select/groupby.cc:438-714,
transport/native/client_tcp.h:109). Here tables stay sharded across
the device mesh and the whole exchange compiles into one XLA program:
per-shard partial aggregation, an all-gather of fixed-width
accumulator tables between devices, and a replicated merge — the
collective plays the role of the QUERY_PARTIALAGGR RPC fan-out.

Merge kinds mirror VM::mergeInstance (reference: sql/runtime/vm.cc:
274-326): count partials merge by sum; sum by sum; min/max by min/max;
count_distinct exchanges locally-deduplicated pair tables
(distributed_count_distinct) like the reference's hash-set union.
"""

from __future__ import annotations

import os
import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from eventql_tpu.kernels.groupby import (
    grouped_aggregate,
    masked_grouped_aggregate,
)

_MERGE_KIND = {
    "count": "sum",
    "sum": "sum",
    "min": "min",
    "max": "max",
}

# -- exchange-volume instrumentation (VERDICT r3 item 7) ---------------------
# Every mesh collective below routes through _xch_* helpers which, when
# a tally is active, record the TRACE-TIME exchange accounting: local
# bytes moved per device and the ring hop distance. Shapes under jit
# are static, so trace-time counting is exact for every execution of
# the compiled program (parallel/exchange_model.py holds the analytic
# byte model the tests check these counts against). NOTE: records
# populate when the program TRACES — a jit cache hit replays without
# recording.
_EXCHANGE_TALLY = None


class exchange_tally:
    """Context manager collecting per-collective exchange records:
    dicts of {op, bytes_per_device, hops, count}.

    Records populate at TRACE time (shapes are static under jit, so
    trace-time counting is exact for every execution of the compiled
    program). Eager distributed_* calls re-trace per call (verified by
    test: a repeated eager shard_map call still records), so direct
    use always counts. A user-jit-WRAPPED program, however, replays a
    cache hit without running any python — so a tally around it would
    silently read empty. Two defenses (round-4 review item 10):
      * every distributed_* entry point runs _tally_guard, raising when
        a tallied direct call recorded nothing, and
      * __exit__ raises when the whole context recorded nothing
        (pass allow_empty=True for intentionally-empty scopes).
    Partial under-counting (a multi-call context where only the
    jit-wrapped calls were cache hits) is not detectable from here:
    wrap tallies around freshly-built programs."""

    def __init__(self, allow_empty: bool = False):
        self.allow_empty = allow_empty

    def __enter__(self):
        global _EXCHANGE_TALLY
        self.records = []
        _EXCHANGE_TALLY = self.records
        return self

    def __exit__(self, exc_type, *exc):
        global _EXCHANGE_TALLY
        _EXCHANGE_TALLY = None
        if exc_type is None and not self.records and not self.allow_empty:
            raise RuntimeError(
                "exchange_tally recorded no collectives: either nothing "
                "distributed ran in the context, or a jit-wrapped program "
                "replayed a cache hit (records are trace-time only). "
                "Re-trace the program, or pass allow_empty=True."
            )
        return False

    def total_link_bytes(self, n_devices: int) -> int:
        """Per-device bytes weighted by ring hops: the per-link traffic
        a 1D-ring embedding carries (disjoint distance-j pairs load
        every link j times its message size)."""
        return sum(r["bytes_per_device"] * r["hops"] for r in self.records)


def _xch_record(op: str, nbytes: int, hops: int):
    if _EXCHANGE_TALLY is not None:
        _EXCHANGE_TALLY.append(
            {"op": op, "bytes_per_device": int(nbytes), "hops": int(hops)}
        )


import contextlib


@contextlib.contextmanager
def _tally_guard(what: str):
    """Fail loudly when a tallied distributed call records nothing —
    the jit/shard_map program was a cache hit and replayed without
    tracing, so the tally would silently read empty. Callers that want
    volumes for an already-compiled program must re-build it (e.g. a
    fresh mesh or cleared caches); callers that don't care must not
    hold a tally open around the call."""
    if _EXCHANGE_TALLY is None:
        yield
        return
    before = len(_EXCHANGE_TALLY)
    yield
    if len(_EXCHANGE_TALLY) == before:
        raise RuntimeError(
            f"exchange_tally active but {what} recorded no collectives: "
            "the program was a jit cache hit (records are trace-time "
            "only). Re-trace the program to count volumes."
        )


def _ring_hops(perm) -> int:
    """Max ring distance of a permutation's pairs (power-of-two XOR
    partners sit exactly j apart in index space; a 1D ring embedding
    pays that distance in links)."""
    h = 0
    for s, d in perm:
        n = len(perm)
        h = max(h, min((d - s) % n, (s - d) % n))
    return max(h, 1)


def _xch_ppermute(a, axis_name, perm, op="ppermute"):
    _xch_record(op, a.size * a.dtype.itemsize, _ring_hops(perm))
    return jax.lax.ppermute(a, axis_name, perm)


def _xch_all_gather(a, axis_name, n_devices, op="all_gather", **kw):
    # ring all-gather: each device forwards its neighbors' blocks for
    # P-1 steps of one hop each
    _xch_record(
        op, a.size * a.dtype.itemsize * max(n_devices - 1, 0), 1
    )
    return jax.lax.all_gather(a, axis_name, **kw)


def _xch_psum(a, axis_name, n_devices, op="psum"):
    # ring all-reduce: reduce-scatter + all-gather, 2(P-1)/P of the
    # buffer over one-hop links
    nb = a.size * a.dtype.itemsize
    _xch_record(op, nb * 2 * max(n_devices - 1, 0) // max(n_devices, 1), 1)
    return jax.lax.psum(a, axis_name)


def make_mesh(n_devices: int = None, axis: str = "shards", devices=None) -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.array(devs), (axis,))


def distributed_grouped_aggregate(
    mesh: Mesh,
    mask,
    key_arrays: Tuple[jax.Array, ...],
    value_arrays: Tuple[jax.Array, ...],
    agg_kinds: Tuple[str, ...],
    axis: str = "shards",
):
    """Filter + GROUP BY + distributed merge over a sharded table.

    Inputs are sharded on their leading axis across `axis`. Output
    accumulator tables are replicated: (group_keys, aggs, valid_mask).
    """
    merge_kinds = tuple(_MERGE_KIND[k] for k in agg_kinds)
    nkeys = len(key_arrays)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), tuple(P(axis) for _ in key_arrays), tuple(P(axis) for _ in value_arrays)),
        out_specs=(tuple(P() for _ in key_arrays), tuple(P() for _ in value_arrays), P()),
        check_vma=False,  # merge of all-gathered partials is replicated
    )
    def step(mask_l, keys_l, vals_l):
        n_local = keys_l[0].shape[0]
        gk, aggs, _first, ng = masked_grouped_aggregate(
            mask_l, keys_l, vals_l, agg_kinds
        )
        valid = jnp.arange(n_local, dtype=jnp.int64) < ng

        # exchange fixed-width partial tables between devices
        nd = mesh.shape[axis]
        gk_all = tuple(
            _xch_all_gather(k, axis, nd, op="groupby_gather", tiled=True)
            for k in gk
        )
        aggs_all = tuple(
            _xch_all_gather(a, axis, nd, op="groupby_gather", tiled=True)
            for a in aggs
        )
        valid_all = _xch_all_gather(
            valid, axis, nd, op="groupby_gather", tiled=True
        )

        # replicated merge of partials (the GroupByMerge step)
        mk, maggs, _mf, mng = masked_grouped_aggregate(
            valid_all, gk_all, aggs_all, merge_kinds
        )
        mvalid = jnp.arange(valid_all.shape[0], dtype=jnp.int64) < mng
        return mk, maggs, mvalid

    with _tally_guard("distributed_grouped_aggregate"):
        return step(mask, tuple(key_arrays), tuple(value_arrays))


def shard_table(mesh: Mesh, arrays, axis: str = "shards"):
    """Place host arrays onto the mesh, sharded on the leading axis."""
    sharding = NamedSharding(mesh, P(axis))
    return tuple(jax.device_put(a, sharding) for a in arrays)


def distributed_topk(
    mesh: Mesh,
    sort_key,
    payload_index,
    k: int,
    axis: str = "shards",
    key_bound=None,
):
    """Distributed ORDER BY ... LIMIT k: per-shard top-k (lax.top_k on
    the pre-transformed key), all-gather of the k·P candidates over
    the mesh, and a replicated re-top-k — exact, and the exchange volume is
    O(k·P) regardless of table size. This replaces the reference's
    fully-materialized coordinator sort (reference: sql/statements/
    select/orderby.cc:58-168 + streamed remote cursors).

    sort_key: uint64 keys (larger = earlier in output), sharded. A
      statically-bounded key (key_bound=(lo, hi) with a 32-bit span)
      runs the per-shard top_k and the candidate all-gather at uint32
      width — same monotonic-bijection argument as distributed_sort.
      With key_bound set, EVERY key value — including sentinel keys of
      filtered/excluded rows — must lie within [lo, hi]: out-of-range
      keys are clamped to the bound before the downcast (a key below
      lo would otherwise wrap modularly to a large uint32 and win the
      top-k silently; clamping sinks it to the bound's floor instead,
      matching the single-chip route's keys-forced-to-minimum
      convention).
    payload_index: int64 global row ids, sharded.
    Returns (keys[k], row_ids[k]) replicated (uint64 keys).
    """
    key_lo = None
    if key_bound is not None and (key_bound[1] - key_bound[0]) <= 0xFFFFFFFF:
        key_lo = key_bound[0]
        clamped = jnp.clip(
            sort_key, jnp.uint64(key_bound[0]), jnp.uint64(key_bound[1])
        )
        sort_key = (clamped - jnp.uint64(key_lo)).astype(jnp.uint32)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def step(key_l, idx_l):
        kk = min(k, key_l.shape[0])
        top_vals, top_pos = jax.lax.top_k(key_l, kk)
        top_idx = idx_l[top_pos]
        nd = mesh.shape[axis]
        all_vals = _xch_all_gather(
            top_vals, axis, nd, op="topk_gather", tiled=True
        )
        all_idx = _xch_all_gather(
            top_idx, axis, nd, op="topk_gather", tiled=True
        )
        f_vals, f_pos = jax.lax.top_k(all_vals, k)
        return f_vals, all_idx[f_pos]

    with _tally_guard("distributed_topk"):
        f_vals, f_idx = step(sort_key, payload_index)
    if key_lo is not None:
        f_vals = f_vals.astype(jnp.uint64) + jnp.uint64(key_lo)
    return f_vals, f_idx


def distributed_bounded_sum_count(
    mesh: Mesh,
    mask,
    gid,
    values,
    num_buckets: int,
    axis: str = "shards",
):
    """Multi-device scan+filter+GROUP BY sum/count: each device runs the
    bounded scatter-add aggregate on its shard, then the fixed-width
    accumulator tables merge with one psum — the collective equivalent
    of the reference's QUERY_PARTIALAGGR fan-out + merge (reference:
    groupby.cc:504-637). Hot (Zipf) keys are pre-combined by the
    per-device partial aggregation, so the exchange volume is
    O(num_buckets) regardless of skew.
    """
    from eventql_tpu.kernels.bucket_agg import bounded_sum_count

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def step(mask_l, gid_l, vals_l):
        counts, sums = bounded_sum_count(mask_l, gid_l, vals_l, num_buckets)
        nd = mesh.shape[axis]
        counts = _xch_psum(counts, axis, nd, op="groupby_psum")
        sums = _xch_psum(sums, axis, nd, op="groupby_psum")
        return counts, sums

    with _tally_guard("distributed_bounded_sum_count"):
        return step(mask, gid, values)


def distributed_multi_join_aggregate(
    mesh: Mesh,
    fact_k1,
    fact_k2,
    fact_values,
    fact_mask,
    dim1_keys,
    dim1_bucket,
    dim2_keys,
    dim2_flag,
    num_buckets: int,
    axis: str = "shards",
):
    """Multi-join + multi-aggregate over the mesh with the dim1 shuffle
    overlapped with compute (BASELINE.json config 5):

        SELECT d1.bucket, sum(f.v), count(1)
        FROM facts f JOIN dim1 d1 ON f.k1 = d1.k
                     JOIN dim2 d2 ON f.k2 = d2.k
        WHERE f.mask AND d2.flag = 1 GROUP BY d1.bucket

    Facts AND dim1 are sharded on the mesh (dim1 too large to
    broadcast); dim2 is replicated. Each chip probes its fact shard
    against the resident dim1 shard while `lax.ppermute` rotates the
    next dim1 shard around the device ring — the permute of step i+1
    has no data dependence on step i's probe, so XLA's latency-hiding
    scheduler runs the collective behind the compute (the reference's
    analog is its pipelined remote cursors, ops/query_remote.cc — there
    the coordinator overlaps row-stream RPCs with merging).
    Accumulator tables merge with one psum; only O(num_buckets) words
    cross chips after the ring.

    Cross-shard correctness of the rotating probe: each per-shard
    search compares the full 64-bit key, and dim keys are globally
    unique, so exactly one ring step can match a fact row; partial gids
    combine with max(-1, ...).
    """
    from eventql_tpu.kernels.bucket_agg import bounded_sum_count
    from eventql_tpu.kernels.join import dim_join_gid

    nshards = int(mesh.devices.size)
    ring = [(i, (i + 1) % nshards) for i in range(nshards)]

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(axis), P(axis), P(axis), P(axis),  # facts
            P(axis), P(axis),                    # dim1 (sharded)
            P(), P(),                            # dim2 (replicated)
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def step(fk1, fk2, fv, fm, d1k, d1b, d2k, d2f):
        # join 2 (replicated): WHERE d2.flag = 1
        gid2 = dim_join_gid(fk2, d2k, d2f)
        active = gid2 == 1

        # join 1: ring-rotate dim1 shards, probe local facts each step
        def body(_i, carry):
            gid, dk_cur, db_cur = carry
            # issue the permute FIRST: it has no dependence on the
            # probe below, so the collective overlaps the compute
            dk_nxt = _xch_ppermute(dk_cur, axis, ring, op="join_ring")
            db_nxt = _xch_ppermute(db_cur, axis, ring, op="join_ring")
            g = dim_join_gid(fk1, dk_cur, db_cur)
            return jnp.maximum(gid, g), dk_nxt, db_nxt

        gid0 = jnp.full(fk1.shape, -1, jnp.int32)
        gid, _, _ = jax.lax.fori_loop(
            0, nshards, body, (gid0, d1k, d1b)
        )

        mask = fm & active & (gid >= 0)
        gid = jnp.maximum(gid, 0)
        counts, sums = bounded_sum_count(mask, gid, fv, num_buckets)
        _ndev = mesh.shape[axis]
        return (
            _xch_psum(counts, axis, _ndev, op="join_psum"),
            _xch_psum(sums, axis, _ndev, op="join_psum"),
        )

    with _tally_guard("distributed_multi_join_aggregate"):
        return step(
            fact_k1, fact_k2, fact_values, fact_mask,
            dim1_keys, dim1_bucket, dim2_keys, dim2_flag,
        )


def distributed_join_aggregate(
    mesh: Mesh,
    fact_keys,
    fact_values,
    fact_mask,
    dim_keys,
    dim_bucket,
    num_buckets: int,
    axis: str = "shards",
):
    """Distributed fact-dim join + aggregate: the fact table stays
    sharded on the mesh, the dimension table replicates to every device
    (broadcast join), each device probes and partially aggregates its
    shard, and the fixed-width accumulator tables merge with one psum.
    The reference instead ships join subplans to every partition server
    and re-joins row streams on the coordinator (reference:
    sql/statements/select/hash_join.cc + the QUERY_REMOTE row pull,
    transport/native/ops/query_remote.cc:40-140) — here only
    O(num_buckets) accumulator words ever cross devices.
    """
    from eventql_tpu.kernels.bucket_agg import bounded_sum_count
    from eventql_tpu.kernels.join import dim_join_gid

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def step(fk_l, fv_l, fm_l, dk, db):
        gid = dim_join_gid(fk_l, dk, db)
        mask = fm_l & (gid >= 0)
        counts, sums = bounded_sum_count(
            mask, jnp.maximum(gid, 0), fv_l, num_buckets
        )
        _ndev = mesh.shape[axis]
        return (
            _xch_psum(counts, axis, _ndev, op="join_psum"),
            _xch_psum(sums, axis, _ndev, op="join_psum"),
        )

    with _tally_guard("distributed_join_aggregate"):
        return step(fact_keys, fact_values, fact_mask, dim_keys, dim_bucket)


def distributed_count_distinct(
    mesh: Mesh,
    mask,
    key_arrays: Tuple[jax.Array, ...],
    values,
    axis: str = "shards",
):
    """Exact distributed COUNT(DISTINCT value) GROUP BY keys over a
    sharded table. Each shard first deduplicates its local
    (keys, value) pairs (one sort), then the deduplicated pair tables
    all-gather across the mesh and a replicated pass recounts global
    distincts — the reference ships serialized per-shard hash SETS and
    unions them on the coordinator (count_distinct accumulator merge,
    sql/expressions/aggregate.cc:74-120 + groupby.cc mergeInstance);
    the local dedup plays the role of the per-shard set, bounding the
    exchange at the deduplicated size.

    Returns (group_keys, distinct_counts, valid_mask), replicated.
    """
    from eventql_tpu.kernels.groupby import (
        masked_grouped_aggregate,
        masked_grouped_count_distinct,
        sortable_u64,
    )

    nkeys = len(key_arrays)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), tuple(P(axis) for _ in key_arrays), P(axis)),
        out_specs=(tuple(P() for _ in key_arrays), P(), P()),
        check_vma=False,
    )
    def step(mask_l, keys_l, vals_l):
        n_local = keys_l[0].shape[0]
        # local dedup: sort (keys..., value), keep first of each run
        sentinel = jnp.uint64(0xFFFFFFFFFFFFFFFF)
        keyed = [
            jnp.where(mask_l, sortable_u64(k), sentinel) for k in keys_l
        ] + [jnp.where(mask_l, sortable_u64(vals_l), sentinel)]
        iota = jnp.arange(n_local, dtype=jnp.int64)
        sorted_ops = jax.lax.sort(
            keyed + [iota], num_keys=len(keyed)
        )
        perm = sorted_ops[-1]
        diff = jnp.zeros(n_local, dtype=jnp.bool_)
        for sk in sorted_ops[:-1]:
            diff = diff | jnp.concatenate(
                [jnp.ones((1,), jnp.bool_), sk[1:] != sk[:-1]]
            )
        keep = diff & mask_l[perm]
        keys_dedup = tuple(k[perm] for k in keys_l)
        vals_dedup = vals_l[perm]

        # exchange deduplicated pair tables between devices
        nd = mesh.shape[axis]
        keep_all = _xch_all_gather(
            keep, axis, nd, op="distinct_gather", tiled=True
        )
        keys_all = tuple(
            _xch_all_gather(k, axis, nd, op="distinct_gather", tiled=True)
            for k in keys_dedup
        )
        vals_all = _xch_all_gather(
            vals_dedup, axis, nd, op="distinct_gather", tiled=True
        )

        # replicated: global distinct count per group (cross-shard
        # duplicates collapse here) + the group key table
        counts = masked_grouped_count_distinct(
            keep_all, keys_all, vals_all
        )
        gk, _aggs, _first, ng = masked_grouped_aggregate(
            keep_all, keys_all, (vals_all,), ("count",)
        )
        valid = jnp.arange(keep_all.shape[0], dtype=jnp.int64) < ng
        return gk, counts, valid

    with _tally_guard("distributed_count_distinct"):
        return step(mask, tuple(key_arrays), values)


# u64 host-order-key bounds implied by sortable_u64 per input dtype:
# narrow ints bias by the sign flip to [2^63 - 2^b, 2^63 + 2^b - 1].
# A bounded key's 32-bit span lets the mesh sort exchange uint32.
_SIGN63 = 1 << 63
_SORTKEY_DTYPE_BOUNDS = {
    jnp.dtype(jnp.bool_): (0, 1),
    jnp.dtype(jnp.uint32): (_SIGN63, _SIGN63 + (1 << 32) - 1),
    jnp.dtype(jnp.int32): (_SIGN63 - (1 << 31), _SIGN63 + (1 << 31) - 1),
    jnp.dtype(jnp.uint16): (_SIGN63, _SIGN63 + (1 << 16) - 1),
    jnp.dtype(jnp.int16): (_SIGN63 - (1 << 15), _SIGN63 + (1 << 15) - 1),
}


def _lex_lt(a_tuple, b_tuple):
    """Elementwise lexicographic a < b over tuples of same-dtype
    unsigned arrays (u16/u32/u64 per key position — key_bounds narrows
    each position independently, so dtypes may differ ACROSS positions
    but both sides of a compare-split pair always share the dtype at
    each position; never mix widths per side)."""
    lt = jnp.zeros(a_tuple[0].shape, dtype=jnp.bool_)
    eq = jnp.ones(a_tuple[0].shape, dtype=jnp.bool_)
    for a, b in zip(a_tuple, b_tuple):
        lt = lt | (eq & (a < b))
        eq = eq & (a == b)
    return lt, eq


def _bitonic_merge_resort(keys_l, pays_l, nk, chunk=2048):
    """Sort a BITONIC run ascending — the compare-split's kept half is
    always bitonic (elementwise min/max over [asc ++ reversed-asc]
    leaves each half bitonic), so the full lax.sort's log²(n) stage
    network is wasted on it. Two phases:

      1. log2(n/chunk) vectorized compare-exchange rounds at distances
         ≥ chunk/2 via reshape — the minor dimension never drops below
         `chunk`
      2. the remaining per-chunk bitonic sub-runs sort in ONE
         lax.sort over the transposed (chunk, n/chunk) view, at
         log²(chunk) stages instead of log²(n)

    Requires a power-of-two run length (callers fall back to lax.sort
    otherwise). Ties never swap, matching the compare-split's
    keep-own-on-tie convention (final-phase ties may permute; the mesh
    sort is documented unstable on full-key ties)."""
    n = keys_l[0].shape[0]
    arrs = list(keys_l) + list(pays_l)
    m = n
    while m > chunk:
        h = m // 2
        los = [a.reshape(-1, 2, h)[:, 0, :] for a in arrs]
        his = [a.reshape(-1, 2, h)[:, 1, :] for a in arrs]
        lt, eq = _lex_lt(tuple(los[:nk]), tuple(his[:nk]))
        swap = ~(lt | eq)
        arrs = [
            jnp.stack(
                [jnp.where(swap, hi, lo), jnp.where(swap, lo, hi)],
                axis=1,
            ).reshape(n)
            for lo, hi in zip(los, his)
        ]
        m = h
    if m > 1:
        cols = [a.reshape(-1, m).T for a in arrs]
        out = jax.lax.sort(cols, dimension=0, num_keys=nk)
        arrs = [o.T.reshape(n) for o in out]
    return tuple(arrs[:nk]), tuple(arrs[nk:])


def distributed_sort(
    mesh: Mesh,
    sort_keys: Tuple[jax.Array, ...],
    payloads: Tuple[jax.Array, ...] = (),
    axis: str = "shards",
    key_bounds: Tuple = None,
):
    """Full distributed ORDER BY: globally sort a sharded table.

    The reference fully materializes every row on the coordinating node
    and std::sorts it single-threaded (reference: sql/statements/select/
    orderby.cc:58-168 over streamed remote cursors). Here the table
    stays sharded and the sort runs as a bitonic compare-split network
    over the mesh: each shard locally sorts its run once, then for each
    network stage exchanges its whole run with a partner shard
    (`lax.ppermute`), keeps the elementwise min (or max) half of the
    merged pair — the classic compare-split: low_i = min(X_i,
    reverse(Y)_i) takes exactly the n smallest of the 2n union — and
    re-sorts the (bitonic) kept half. log2(P)·(log2(P)+1)/2 stages.

    Chosen over sample-sort + all_to_all deliberately: compare-split
    exchanges are fixed-shape (XLA-compilable, no ragged collectives —
    ragged_all_to_all is also unsupported on XLA:CPU where the virtual
    mesh runs), deterministic under ANY key skew (sorted inputs and
    all-equal keys are the adversarial cases for splitter sampling),
    and the output is perfectly balanced: shard i ends holding exactly
    global ranks [i*n_local, (i+1)*n_local).

    sort_keys: tuple of uint64 arrays (lexicographic, ascending
      unsigned; pre-transform with make_sort_keys for dtype/DESC
      handling), sharded on the leading axis.
    payloads: arrays carried through the sort (e.g. int64 global row
      ids, which make the result the ORDER BY permutation).
    Returns (sorted_keys_tuple, sorted_payloads_tuple), sharded.

    Ties between rows equal on every key may permute (the reference's
    std::sort is likewise unstable; its golden tests avoid ties).

    key_bounds: optional per-key static (lo, hi) u64 bounds (post any
      descending flip). A key whose span fits 32 bits exchanges and
      compare-splits as uint32 — (key - lo) is a strictly monotonic
      bijection onto [0, hi - lo], so order and ties are bit-identical
      while the bitonic stages (operand-width bound, PERF.md) and the
      ppermute exchanges move half the bytes. Returned keys are
      restored to uint64.
    """
    n_shards = mesh.shape[axis]
    if n_shards & (n_shards - 1):
        raise ValueError(
            "distributed_sort requires a power-of-two mesh axis, got "
            f"{n_shards}"
        )
    nk = len(sort_keys)
    key_lo = [None] * nk
    if key_bounds is not None:
        sort_keys = list(sort_keys)
        for i, b in enumerate(key_bounds):
            if b is None:
                continue
            lo, hi = b
            if (hi - lo) <= 0xFFFF:
                sort_keys[i] = (
                    sort_keys[i] - jnp.uint64(lo)
                ).astype(jnp.uint16)
                key_lo[i] = lo
            elif (hi - lo) <= 0xFFFFFFFF:
                sort_keys[i] = (
                    sort_keys[i] - jnp.uint64(lo)
                ).astype(jnp.uint32)
                key_lo[i] = lo
        sort_keys = tuple(sort_keys)

    def local_sort(keys_l, pays_l):
        ops = jax.lax.sort(list(keys_l) + list(pays_l), num_keys=nk)
        return tuple(ops[:nk]), tuple(ops[nk:])

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            tuple(P(axis) for _ in sort_keys),
            tuple(P(axis) for _ in payloads),
        ),
        out_specs=(
            tuple(P(axis) for _ in sort_keys),
            tuple(P(axis) for _ in payloads),
        ),
        check_vma=False,
    )
    def step(keys_l, pays_l):
        keys_l, pays_l = local_sort(keys_l, pays_l)
        if n_shards == 1:
            return keys_l, pays_l
        rank = jax.lax.axis_index(axis)
        n_local = keys_l[0].shape[0]
        pow2_run = n_local & (n_local - 1) == 0

        # chunked compare-split (BASELINE config 5 / round-3 NEXT #5):
        # split each stage's run into C chunks and issue C smaller
        # ppermutes, selecting per chunk — chunk c's compare-select can
        # then run UNDER chunk c+1's transfer (XLA schedules the
        # independent collectives asynchronously on real devices; the
        # virtual CPU mesh only validates exactness). My ascending
        # chunk c pairs with the partner's REVERSED run, i.e. the
        # partner's chunk C-1-c reversed — both sides of a pair send
        # chunk C-1-c at step c, so the SPMD program stays symmetric.
        chunks = int(os.environ.get("EVENTQL_TPU_EXCHANGE_CHUNKS", "1"))
        if chunks > 1 and n_local % chunks:
            chunks = 1
        csize = n_local // max(chunks, 1)

        def exchange(arrs, perm):
            if chunks <= 1:
                return tuple(
                    _xch_ppermute(a, axis, perm, op="sort_exchange")[::-1]
                    for a in arrs
                )
            out = []
            for a in arrs:
                parts = [
                    _xch_ppermute(
                        a[(chunks - 1 - c) * csize : (chunks - c) * csize],
                        axis,
                        perm,
                        op="sort_exchange",
                    )[::-1]
                    for c in range(chunks)
                ]
                out.append(jnp.concatenate(parts))
            return tuple(out)

        k = 2
        while k <= n_shards:
            j = k // 2
            while j >= 1:
                perm = [(i, i ^ j) for i in range(n_shards)]
                # issue EVERY exchange up front — the payload permutes
                # are independent of the key compare, so XLA's latency
                # hiding overlaps their transfer with the key-side
                # compare-split compute (BASELINE config 5's
                # shuffle/compute overlap; the dependency chain forbids
                # overlapping ACROSS stages). The partner's ascending
                # run arrives reversed: [mine, rev] is bitonic and the
                # elementwise min/max is the compare-split.
                o_keys = exchange(keys_l, perm)
                o_pays = exchange(pays_l, perm)
                lt, eq = _lex_lt(keys_l, o_keys)
                # ascending block iff bit k of rank is clear; keep the
                # low half iff block direction matches pair position
                keep_low = ((rank & j) == 0) == ((rank & k) == 0)
                # low side takes mine when mine <= other; high side
                # takes mine when mine >= other — on key ties both
                # sides keep their own element (complementary pair)
                take_mine = jnp.where(keep_low, lt | eq, ~lt)
                keys_l = tuple(
                    jnp.where(take_mine, a, b)
                    for a, b in zip(keys_l, o_keys)
                )
                pays_l = tuple(
                    jnp.where(take_mine, a, b)
                    for a, b in zip(pays_l, o_pays)
                )
                # the kept half is BITONIC: log2(n) merge rounds
                # restore ascending order — the full lax.sort's
                # log²(n) network is redundant here (measured 3-4x
                # per-stage, PERF.md)
                if pow2_run:
                    keys_l, pays_l = _bitonic_merge_resort(
                        keys_l, pays_l, nk
                    )
                else:
                    keys_l, pays_l = local_sort(keys_l, pays_l)
                j //= 2
            k *= 2
        return keys_l, pays_l

    with _tally_guard("distributed_sort"):
        out_keys, out_pays = step(tuple(sort_keys), tuple(payloads))
    if any(lo is not None for lo in key_lo):
        out_keys = tuple(
            k.astype(jnp.uint64) + jnp.uint64(lo) if lo is not None else k
            for k, lo in zip(out_keys, key_lo)
        )
    return out_keys, out_pays


def distributed_order_permutation(
    mesh: Mesh,
    columns,
    descendings,
    axis: str = "shards",
):
    """Distributed ORDER BY permutation: sort the sharded table by the
    given columns/DESC flags and return the global row-id permutation,
    sharded (shard i holds the row ids of global ranks
    [i*n_local, (i+1)*n_local)).

    Columns whose dtype statically bounds the u64 host-order key within
    a 32-bit span (narrowed physical columns, dictionary ids, bools)
    sort as uint32 — the same static-bound downcast as the single-chip
    ORDER BY route — and the permutation payload rides int32 when the
    global row count fits (widened back to int64 on return)."""
    from eventql_tpu.kernels.sort import make_sort_keys

    _M64 = 0xFFFFFFFFFFFFFFFF
    bounds = []
    for c, d in zip(columns, descendings):
        b = _SORTKEY_DTYPE_BOUNDS.get(c.dtype)
        if b is not None and d:
            lo, hi = b
            b = ((~hi) & _M64, (~lo) & _M64)
        bounds.append(b)

    n = columns[0].shape[0]
    idx_dtype = jnp.int32 if n < (1 << 31) else jnp.int64
    iota = jnp.arange(n, dtype=idx_dtype)
    (iota_d,) = shard_table(mesh, [iota], axis=axis)
    keys = make_sort_keys(columns, descendings)
    _, (perm,) = distributed_sort(
        mesh, keys, (iota_d,), axis=axis, key_bounds=tuple(bounds)
    )
    return perm.astype(jnp.int64)


def distributed_grouped_aggregate_sharded(
    mesh: Mesh,
    mask,
    key_arrays: Tuple[jax.Array, ...],
    value_arrays: Tuple[jax.Array, ...],
    agg_kinds: Tuple[str, ...],
    axis: str = "shards",
):
    """High-cardinality distributed GROUP BY whose result STAYS SHARDED.

    distributed_grouped_aggregate all-gathers every shard's partial
    table and merges it replicated — O(P·n) memory per chip, the right
    trade when the group count fits one chip (it mirrors the
    reference's coordinator merge, sql/statements/select/groupby.cc:
    552-637). When the distinct-key count exceeds one chip's table,
    this variant keeps the groups sharded end to end:

      1. per-shard pre-combine (masked_grouped_aggregate) — bounds all
         later exchange at the deduplicated size and makes key skew
         irrelevant (a hot key is one row per shard afterwards; the
         reference has no online skew handling at all),
      2. a global sort of the (group key, partial state) tables by key
         over the mesh (distributed_sort — ppermute compare-split, so
         the exchange volume is fixed-shape regardless of how the hash
         of any key distributes),
      3. a second per-shard combine of the now key-contiguous runs,
      4. an O(P)-word boundary exchange: a group can span adjacent
         shards only through their first/last entries (middle shards
         of a long run collapse to a single entry in step 3), so one
         all_gather of each shard's two edge entries + a replicated
         merge patches the totals; the highest shard holding a key
         owns it, lower copies deactivate.

    Returns (group_keys, aggs, valid_mask), all sharded on `axis`;
    valid groups are globally unique and ascending in key order across
    shards. agg_kinds: sum/count/min/max (mean decomposes upstream).
    """
    merge_kinds = tuple(_MERGE_KIND[k] for k in agg_kinds)
    nk = len(key_arrays)
    na = len(value_arrays)
    n_shards = mesh.shape[axis]

    from eventql_tpu.kernels.groupby import (
        masked_grouped_aggregate,
        sortable_u64,
    )

    # static u64 key bounds from the key dtypes (dictionary ids /
    # narrowed physical columns): bounded keys ride the mesh sort as
    # uint32 — half the compare-split + ppermute bytes
    key_bounds_static = [
        _SORTKEY_DTYPE_BOUNDS.get(k.dtype) for k in key_arrays
    ]

    # --- step 1: per-shard pre-combine --------------------------------
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(axis),
            tuple(P(axis) for _ in key_arrays),
            tuple(P(axis) for _ in value_arrays),
        ),
        out_specs=(
            P(axis),
            tuple(P(axis) for _ in key_arrays),
            tuple(P(axis) for _ in key_arrays),
            tuple(P(axis) for _ in value_arrays),
        ),
        check_vma=False,
    )
    def precombine(mask_l, keys_l, vals_l):
        n_local = keys_l[0].shape[0]
        gk, aggs, _first, ng = masked_grouped_aggregate(
            mask_l, keys_l, vals_l, agg_kinds
        )
        iota = jnp.arange(n_local, dtype=jnp.int64)
        invalid = (iota >= ng).astype(jnp.uint64)
        # sort keys: validity first (a real group key may equal the
        # invalid-row sentinel), then the sortable group keys. Keys
        # with a static dtype bound clamp invalid rows to the bound's
        # max instead of all-ones so the key stays 32-bit-narrowable
        # (ordering among invalid rows is irrelevant — the leading
        # validity key already sinks them, and they are masked out
        # downstream).
        skeys = tuple(
            jnp.where(
                invalid == 0,
                sortable_u64(k),
                jnp.uint64(
                    b[1] if b is not None else 0xFFFFFFFFFFFFFFFF
                ),
            )
            for k, b in zip(gk, key_bounds_static)
        )
        return invalid, skeys, gk, aggs

    invalid, skeys, gk, aggs = precombine(
        mask, tuple(key_arrays), tuple(value_arrays)
    )

    # --- step 2: global sort by (validity, group key) over the mesh ---
    _, payload = distributed_sort(
        mesh,
        (invalid,) + skeys,
        tuple(gk) + tuple(aggs) + (invalid,),
        axis=axis,
        key_bounds=((0, 1),) + tuple(key_bounds_static),
    )
    gk_s = payload[:nk]
    aggs_s = payload[nk : nk + na]
    invalid_s = payload[nk + na]

    # --- steps 3+4: per-shard re-combine + boundary patch -------------
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            tuple(P(axis) for _ in range(nk)),
            tuple(P(axis) for _ in range(na)),
            P(axis),
        ),
        out_specs=(
            tuple(P(axis) for _ in range(nk)),
            tuple(P(axis) for _ in range(na)),
            P(axis),
        ),
        check_vma=False,
    )
    def combine(keys_l, aggs_l, invalid_l):
        n_local = keys_l[0].shape[0]
        valid_l = invalid_l == 0
        mk, maggs, _first, mng = masked_grouped_aggregate(
            valid_l, keys_l, aggs_l, merge_kinds
        )
        iota = jnp.arange(n_local, dtype=jnp.int64)
        valid_out = iota < mng
        if n_shards == 1:
            return mk, maggs, valid_out

        rank = jax.lax.axis_index(axis).astype(jnp.int64)
        last_pos = jnp.maximum(mng - 1, 0)

        # boundary entries: (first, last) of this shard's merged run.
        # a shard whose run is a single group contributes it once.
        def edge(arr, pos):
            return jax.lax.dynamic_index_in_dim(
                arr, pos, keepdims=False
            )

        contrib = jnp.stack([mng > 0, mng >= 2])  # (2,)
        ekeys = [
            jnp.stack([sortable_u64(edge(k, jnp.int64(0))),
                       sortable_u64(edge(k, last_pos))])
            for k in mk
        ]  # nk × (2,)
        eaggs = [
            jnp.stack([edge(a, jnp.int64(0)), edge(a, last_pos)])
            for a in maggs
        ]  # na × (2,)

        # O(P) exchange of the edge entries
        nd = mesh.shape[axis]
        bmask = _xch_all_gather(
            contrib, axis, nd, op="boundary_gather"
        ).reshape(-1)  # (2P,)
        bkeys = [
            _xch_all_gather(k, axis, nd, op="boundary_gather").reshape(-1)
            for k in ekeys
        ]
        baggs = [
            _xch_all_gather(a, axis, nd, op="boundary_gather").reshape(-1)
            for a in eaggs
        ]
        bshard = (
            jnp.arange(2 * n_shards, dtype=jnp.int64) // 2
        )

        def lookup(key_tuple):
            """merged total + owning shard + contributor count of a key
            over the replicated boundary table."""
            match = bmask
            for bk, k in zip(bkeys, key_tuple):
                match = match & (bk == k)
            cnt = match.sum()
            owner = jnp.max(jnp.where(match, bshard, jnp.int64(-1)))
            totals = []
            for ba, mkind in zip(baggs, merge_kinds):
                if mkind == "sum":
                    t = jnp.where(match, ba, jnp.zeros((), ba.dtype)).sum()
                elif mkind == "min":
                    t = jnp.min(
                        jnp.where(match, ba, jnp.asarray(_MAX_OF[ba.dtype.name], ba.dtype))
                    )
                else:  # max
                    t = jnp.max(
                        jnp.where(match, ba, jnp.asarray(_MIN_OF[ba.dtype.name], ba.dtype))
                    )
                totals.append(t)
            return cnt, owner, totals

        def patch(pos, active, maggs, valid_out):
            key_tuple = tuple(sortable_u64(edge(k, pos)) for k in mk)
            cnt, owner, totals = lookup(key_tuple)
            spans = active & (cnt > 1)
            is_owner = spans & (owner == rank)
            # owner entry takes the merged total
            maggs = tuple(
                jnp.where(
                    is_owner & (iota == pos),
                    jnp.asarray(t, a.dtype),
                    a,
                )
                for a, t in zip(maggs, totals)
            )
            # non-owner copies deactivate (merged elsewhere)
            drop = spans & (owner != rank)
            valid_out = valid_out & ~(drop & (iota == pos))
            return maggs, valid_out

        maggs, valid_out = patch(jnp.int64(0), mng > 0, maggs, valid_out)
        maggs, valid_out = patch(last_pos, mng >= 2, maggs, valid_out)
        return mk, maggs, valid_out

    with _tally_guard("distributed_grouped_aggregate_sharded"):
        return combine(tuple(gk_s), tuple(aggs_s), invalid_s)


_MAX_OF = {
    "uint64": 0xFFFFFFFFFFFFFFFF,
    "int64": (1 << 63) - 1,
    "float64": float("inf"),
    "uint32": 0xFFFFFFFF,
    "int32": (1 << 31) - 1,
}
_MIN_OF = {
    "uint64": 0,
    "int64": -(1 << 63),
    "float64": float("-inf"),
    "uint32": 0,
    "int32": -(1 << 31),
}


def distributed_bucket_sort(
    mesh: Mesh,
    sort_key,
    payload=None,
    axis: str = "shards",
    oversample: int = 64,
    capacity_factor: float = 2.0,
):
    """Padded-bucket sample sort (round-5 VERDICT item 5 probe): the
    one-exchange-round alternative to the bitonic compare-split
    network, kept static-shape with FIXED-capacity buckets.

    Stages (per shard, n_local rows):
      1. local sort;
      2. splitter sampling: `oversample` evenly-spaced keys from each
         sorted run all-gather (P*oversample words), replicated sort,
         P-1 quantile splitters — identical on every shard;
      3. partition the sorted run by splitters (one searchsorted) and
         pack each bucket's CONTIGUOUS slice into a (P, C) send buffer,
         C = capacity_factor * n_local / P (sentinel-padded);
      4. ONE all_to_all round (ppermute per destination) — total
         exchanged volume = capacity_factor * n_local words per shard
         regardless of P, vs the bitonic's log2(P)(log2(P)+1)/2 full-run
         exchanges;
      5. local sort of the received (P, C) rows -> shard i holds ALL of
         bucket i, globally ordered ACROSS shards (output is bucket-
         partitioned, not balanced: shard i returns a
         capacity_factor*n_local buffer with count m_i valid rows).

    Clamp-and-repair: a bucket exceeding its send capacity C on some
    source shard clamps (rows beyond C are dropped from the buffer) and
    the overflow FLAG returns true — the caller falls back to the
    always-exact bitonic `distributed_sort` (splitter sampling has no
    worst-case bound: all-equal keys put every row in one bucket).

    Returns (keys_out, payload_out, counts, overflow):
      keys_out  u64[cap] per shard (sentinel 0xFF..F beyond count)
      payload_out same layout (or None)
      counts    int64[P] replicated per-bucket valid counts
      overflow  bool scalar, replicated
    """
    n_shards = int(mesh.shape[axis])
    n_local = sort_key.shape[0] // n_shards
    C = max(1, int(capacity_factor * n_local / n_shards))
    cap = C * n_shards
    s = min(oversample, n_local)
    sentinel = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    has_pay = payload is not None

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis),) + ((P(axis),) if has_pay else ()),
        out_specs=(P(axis),) + ((P(axis),) if has_pay else ())
        + (P(axis), P()),
        check_vma=False,
    )
    def step(key_l, *pay):
        pay_l = pay[0] if has_pay else None
        # 1. local sort — WITH the payload as a secondary sort key:
        # ties then order by payload (for row-id payloads this IS the
        # host engine's stable order; callers relying on it pass
        # monotone payloads)
        if has_pay:
            key_s, pay_s = jax.lax.sort([key_l, pay_l], num_keys=2)
        else:
            key_s = jax.lax.sort([key_l], num_keys=1)[0]
            pay_s = None

        # 2. splitters from evenly-spaced samples of every sorted run
        idx = (jnp.arange(s) * n_local) // s
        samples = key_s[idx]
        all_samples = _xch_all_gather(
            samples, axis, n_shards, op="bucket_samples", tiled=True
        )
        sorted_samples = jnp.sort(all_samples)
        q = (jnp.arange(1, n_shards) * (n_shards * s)) // n_shards
        splitters = sorted_samples[q]  # (P-1,) replicated

        # 3. bucket ranges in the sorted run + fixed-capacity pack
        starts = jnp.searchsorted(key_s, splitters, side="left")
        starts = jnp.concatenate(
            [jnp.zeros((1,), starts.dtype), starts]
        )  # (P,)
        # sentinel-keyed rows (filtered/padding by contract: callers
        # must clamp REAL keys below the sentinel) are excluded from
        # the exchange entirely — the last bucket ends where they start
        n_valid = jnp.searchsorted(key_s, sentinel, side="left").astype(
            starts.dtype
        )
        ends = jnp.concatenate([starts[1:], n_valid[None]])
        ends = jnp.minimum(ends, n_valid)
        starts = jnp.minimum(starts, n_valid)
        counts_local = ends - starts
        overflow_l = jnp.any(counts_local > C)

        iota_c = jnp.arange(C)

        def pack(j, arr, fill):
            pos = jnp.minimum(starts[j] + iota_c, n_local - 1)
            vals = arr[pos]
            return jnp.where(iota_c < counts_local[j], vals, fill)

        jidx = jnp.arange(n_shards)
        send_keys = jax.vmap(lambda j: pack(j, key_s, sentinel))(jidx)
        if has_pay:
            send_pay = jax.vmap(
                lambda j: pack(j, pay_s, jnp.zeros((), pay_s.dtype))
            )(jidx)

        # 4. ONE exchange round: destination j receives row block j
        # from every source (P-1 ppermutes of one (1, C) block each —
        # the all_to_all decomposition the tally prices per hop)
        me = jax.lax.axis_index(axis)

        def _pick(arr2d, j):
            return jax.lax.dynamic_index_in_dim(
                arr2d, j % n_shards, keepdims=False
            )

        recv_keys = [_pick(send_keys, me)]
        recv_pay = [_pick(send_pay, me)] if has_pay else None
        for d in range(1, n_shards):
            perm = [(i, (i - d) % n_shards) for i in range(n_shards)]
            # source i ships its block for destination (i - d) % P
            recv_keys.append(
                _xch_ppermute(
                    _pick(send_keys, me - d), axis, perm,
                    op="bucket_all_to_all",
                )
            )
            if has_pay:
                recv_pay.append(
                    _xch_ppermute(
                        _pick(send_pay, me - d), axis, perm,
                        op="bucket_all_to_all",
                    )
                )

        got_keys = jnp.concatenate(recv_keys)  # (P*C,)

        # 5. local sort of the received bucket (sentinels sink to the
        # tail); payload again participates for stable tie order
        if has_pay:
            got_pay = jnp.concatenate(recv_pay)
            out_k, out_p = jax.lax.sort([got_keys, got_pay], num_keys=2)
        else:
            out_k = jax.lax.sort([got_keys], num_keys=1)[0]
            out_p = None
        m = jnp.sum(got_keys != sentinel).astype(jnp.int64)
        overflow = _xch_psum(
            overflow_l.astype(jnp.int32), axis, n_shards,
            op="bucket_overflow",
        ) > 0
        outs = (out_k,)
        if has_pay:
            outs = outs + (out_p,)
        # per-shard count rides out SHARDED (no collective needed)
        return outs + (m[None], overflow)

    with _tally_guard("distributed_bucket_sort"):
        res = step(sort_key, *((payload,) if has_pay else ()))
    if has_pay:
        out_k, out_p, counts, overflow = res
        return out_k, out_p, counts, overflow
    out_k, counts, overflow = res
    return out_k, None, counts, overflow
