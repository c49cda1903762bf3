"""Device hash-join kernels.

The reference's hash join builds a CPU multimap over the joined table
and probes per row (reference: sql/statements/select/hash_join.cc:
29-33, 123-230). On the device:

* build: sort the build side's keys once (order-preserving u64
  transform + lax.sort)
* probe: vectorized binary search (searchsorted) — every probe row
  resolves its match range in log2(build) steps, fully parallel; a
  unique-key (dimension) probe then gathers the build row's payload
* fact-dim join + aggregate (BASELINE config 3) feeds the probe's
  bucket ids straight into the bounded GROUP BY scatter, so no join
  pairs ever materialize

Unique-key (dim) joins return exact matches; multi-match joins expose
(start, count) ranges for the caller to expand (host path) or to feed
range-aware aggregation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from eventql_tpu.kernels.groupby import sortable_u64


@jax.jit
def build_side(keys: jax.Array):
    """Sort the build side: returns (sorted_transformed_keys, perm)."""
    k = sortable_u64(keys)
    iota = jnp.arange(k.shape[0], dtype=jnp.int64)
    sk, perm = jax.lax.sort([k, iota], num_keys=1)
    return sk, perm


@jax.jit
def probe_ranges(sorted_keys: jax.Array, probe_keys: jax.Array):
    """For each probe key: (start, count) of its match range in the
    sorted build side."""
    pk = sortable_u64(probe_keys)
    start = jnp.searchsorted(sorted_keys, pk, side="left")
    end = jnp.searchsorted(sorted_keys, pk, side="right")
    return start, (end - start)


@jax.jit
def dim_join_gather(
    sorted_keys: jax.Array, perm: jax.Array, probe_keys: jax.Array
):
    """Unique-key join: per probe row, the build row index (or -1)."""
    pk = sortable_u64(probe_keys)
    pos = jnp.searchsorted(sorted_keys, pk, side="left")
    pos = jnp.clip(pos, 0, sorted_keys.shape[0] - 1)
    matched = sorted_keys[pos] == pk
    idx = jnp.where(matched, perm[pos], -1)
    return idx, matched


@jax.jit
def dim_join_gid(fact_keys: jax.Array, dim_keys: jax.Array,
                 dim_bucket: jax.Array) -> jax.Array:
    """Per fact row: the joined dim's bucket id (int32), or -1 when the
    key has no dim match. Dim keys must be unique."""
    if dim_keys.shape[0] == 0:
        return jnp.full(fact_keys.shape, -1, jnp.int32)
    sk, perm = build_side(dim_keys)
    idx, matched = dim_join_gather(sk, perm, fact_keys)
    gid = dim_bucket.astype(jnp.int32)[jnp.maximum(idx, 0)]
    return jnp.where(matched, gid, -1)


@functools.partial(jax.jit, static_argnames=("num_buckets",))
def fact_dim_join_aggregate(
    fact_keys: jax.Array,
    fact_values: jax.Array,
    fact_mask: jax.Array,
    dim_keys: jax.Array,
    dim_bucket: jax.Array,
    num_buckets: int,
):
    """SELECT d.bucket, count(*), sum(f.value)
       FROM fact f JOIN dim d ON f.key = d.key [WHERE mask]
       GROUP BY d.bucket — as one device program.

    dim_bucket must be int32 in [0, num_buckets); dim keys are unique.
    Unmatched fact rows drop (inner join). Returns (counts u64[K],
    sums u64[K])."""
    from eventql_tpu.kernels.bucket_agg import bounded_sum_count

    gid = dim_join_gid(fact_keys, dim_keys, dim_bucket)
    return bounded_sum_count(
        fact_mask & (gid >= 0), gid, fact_values, num_buckets
    )
