"""Skewed-key distributed aggregation (BASELINE config 4).

Zipf(1.2) keys hash-partitioned across the mesh: the per-chip partial
aggregation pre-combines hot keys, so the merge exchanges only
O(num_buckets) accumulator state — skew cannot imbalance the exchange
(the reference has no online skew handling at all; its hot partitions
split offline, doc/internals/partitioning.txt)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eventql_tpu.parallel.distributed import (
    distributed_bounded_sum_count,
    make_mesh,
    shard_table,
)


def _zipf_keys(n, num_buckets, a=1.2, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.zipf(a, n)
    return ((k - 1) % num_buckets).astype(np.int32)


def test_distributed_zipf_groupby_exact():
    assert len(jax.devices()) >= 8
    mesh = make_mesh(8)
    n = 8 * 1024 * 4
    K = 128
    gid = _zipf_keys(n, K)
    rng = np.random.default_rng(1)
    values = rng.integers(0, 10**6, n).astype(np.uint64)
    mask = rng.random(n) < 0.9

    # heavy skew sanity: the hottest bucket is far above uniform share
    counts_np = np.bincount(gid, minlength=K)
    assert counts_np.max() > 20 * n / K

    mask_d, gid_d, vals_d = shard_table(mesh, [mask, gid, values])
    counts, sums = distributed_bounded_sum_count(mesh, mask_d, gid_d, vals_d, K)
    counts, sums = np.asarray(counts), np.asarray(sums)

    exp_counts = np.zeros(K, np.uint64)
    exp_sums = np.zeros(K, np.uint64)
    for g, v, m in zip(gid, values, mask):
        if m:
            exp_counts[g] += 1
            exp_sums[g] = np.uint64(exp_sums[g] + v)
    assert (counts == exp_counts).all()
    assert (sums == exp_sums).all()
