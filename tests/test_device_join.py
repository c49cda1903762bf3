"""Device join kernel tests."""

import jax.numpy as jnp
import numpy as np

from eventql_tpu.kernels.join import (
    build_side,
    dim_join_gather,
    fact_dim_join_aggregate,
    probe_ranges,
)


def test_probe_ranges():
    build = jnp.asarray(np.array([5, 1, 5, 9, 5, 1], dtype=np.uint64))
    sk, perm = build_side(build)
    probe = jnp.asarray(np.array([5, 2, 1, 9], dtype=np.uint64))
    start, count = probe_ranges(sk, probe)
    assert list(np.asarray(count)) == [3, 0, 2, 1]


def test_dim_join_gather():
    dim = jnp.asarray(np.array([10, 20, 30], dtype=np.uint64))
    sk, perm = build_side(dim)
    probe = jnp.asarray(np.array([20, 99, 10, 30, 30], dtype=np.uint64))
    idx, matched = dim_join_gather(sk, perm, probe)
    idx, matched = np.asarray(idx), np.asarray(matched)
    assert list(matched) == [True, False, True, True, True]
    assert list(idx[matched]) == [1, 0, 2, 2]


def test_fact_dim_join_aggregate():
    rng = np.random.default_rng(0)
    n_dim, n_fact, K = 200, 5000, 16
    dim_keys = rng.permutation(np.arange(1000, 1000 + n_dim)).astype(np.uint64)
    dim_bucket = rng.integers(0, K, n_dim).astype(np.int32)
    fact_keys = rng.integers(900, 1300, n_fact).astype(np.uint64)  # ~50% match
    fact_vals = rng.integers(0, 1000, n_fact).astype(np.uint64)
    fact_mask = rng.random(n_fact) < 0.8

    counts, sums = fact_dim_join_aggregate(
        jnp.asarray(fact_keys),
        jnp.asarray(fact_vals),
        jnp.asarray(fact_mask),
        jnp.asarray(dim_keys),
        jnp.asarray(dim_bucket),
        K,
    )
    counts, sums = np.asarray(counts), np.asarray(sums)

    dim_map = {int(k): int(b) for k, b in zip(dim_keys, dim_bucket)}
    exp_counts = np.zeros(K, np.uint64)
    exp_sums = np.zeros(K, np.uint64)
    for k, v, m in zip(fact_keys, fact_vals, fact_mask):
        if m and int(k) in dim_map:
            b = dim_map[int(k)]
            exp_counts[b] += 1
            exp_sums[b] += v
    assert (counts == exp_counts).all()
    assert (sums == exp_sums).all()


def test_fingerprint_join_gid():
    """Search probe + payload gather per fact row: the dim's bucket,
    or -1 on a miss (kernels/join.py dim_join_gid)."""
    import numpy as np

    from eventql_tpu.kernels.join import dim_join_gid

    rng = np.random.default_rng(13)
    nd, n = 777, 20000
    dim_keys = rng.permutation(np.arange(nd, dtype=np.uint64) * 104729 + 11)
    dim_bucket = rng.integers(0, 512, nd).astype(np.int32)
    fact = rng.integers(0, nd * 3, n).astype(np.uint64) * 104729 + 11
    gid = np.asarray(
        dim_join_gid(
            jnp.asarray(fact), jnp.asarray(dim_keys), jnp.asarray(dim_bucket)
        )
    )
    lut = {int(k): int(b) for k, b in zip(dim_keys, dim_bucket)}
    ref = np.array([lut.get(int(k), -1) for k in fact], dtype=np.int32)
    np.testing.assert_array_equal(gid, ref)


def test_fingerprint_join_gid_chunked():
    """A larger, odd-sized dim table: exact incl. misses, matches
    spread over the whole sorted key range."""
    import numpy as np

    from eventql_tpu.kernels.join import dim_join_gid

    rng = np.random.default_rng(29)
    nd, n = 5003, 20000
    dim_keys = rng.permutation(np.arange(nd, dtype=np.uint64) * 104729 + 11)
    dim_bucket = rng.integers(0, 512, nd).astype(np.int32)
    fact = rng.integers(0, nd * 2, n).astype(np.uint64) * 104729 + 11
    gid = np.asarray(
        dim_join_gid(
            jnp.asarray(fact), jnp.asarray(dim_keys), jnp.asarray(dim_bucket)
        )
    )
    lut = {int(k): int(b) for k, b in zip(dim_keys, dim_bucket)}
    ref = np.array([lut.get(int(k), -1) for k in fact], dtype=np.int32)
    np.testing.assert_array_equal(gid, ref)


def _numpy_join_agg(fact_keys, fact_vals, fact_mask, dim_keys, dim_bucket, K):
    lut = {int(k): int(b) for k, b in zip(dim_keys, dim_bucket)}
    counts = np.zeros(K, np.uint64)
    sums = np.zeros(K, np.uint64)
    for k, v, m in zip(fact_keys, fact_vals, fact_mask):
        if not m or int(k) not in lut:
            continue
        b = lut[int(k)]
        counts[b] += 1
        sums[b] += np.uint64(v)
    return counts, sums


def _join_agg(fact_keys, fact_vals, fact_mask, dim_keys, dim_bucket, K):
    counts, sums = fact_dim_join_aggregate(
        jnp.asarray(fact_keys),
        jnp.asarray(fact_vals),
        jnp.asarray(fact_mask),
        jnp.asarray(dim_keys),
        jnp.asarray(dim_bucket),
        K,
    )
    return list(np.asarray(counts)), list(np.asarray(sums))


def _want(*args):
    counts, sums = _numpy_join_agg(*args)
    return list(counts), list(sums)


def test_sorted_merge_join_aggregate_parity():
    """5000 dims, ~70% of fact keys matching, the rest arbitrary 62-bit
    misses."""
    rng = np.random.default_rng(3)
    n_dim, n_fact, K = 5000, 40000, 64
    dim_keys = rng.permutation(
        np.arange(n_dim, dtype=np.uint64) * 104729 + 17
    )
    dim_bucket = rng.integers(0, K, n_dim).astype(np.int32)
    fact_keys = np.where(
        rng.random(n_fact) < 0.7,
        rng.integers(0, n_dim, n_fact).astype(np.uint64) * 104729 + 17,
        rng.integers(0, 1 << 62, n_fact).astype(np.uint64),
    )
    fact_vals = rng.integers(0, 1000, n_fact).astype(np.uint64)
    fact_mask = rng.random(n_fact) < 0.8
    args = (fact_keys, fact_vals, fact_mask, dim_keys, dim_bucket, K)
    assert _join_agg(*args) == _want(*args)


def test_sorted_merge_join_key_bound_parity():
    """Keys above 2^32 whose span fits 32 bits, 16- and 64-bit values."""
    rng = np.random.default_rng(13)
    n_dim, n_fact, K = 3000, 30000, 32
    base = 7_000_000_000
    dim_keys = rng.permutation(
        np.arange(n_dim, dtype=np.uint64) * 977 + base
    )
    dim_bucket = rng.integers(0, K, n_dim).astype(np.int32)
    fact_keys = (
        rng.integers(0, n_dim, n_fact).astype(np.uint64) * 977 + base
    )
    fact_mask = rng.random(n_fact) < 0.8
    for top in (1 << 16, 1 << 48):
        fact_vals = rng.integers(0, top, n_fact).astype(np.uint64)
        args = (fact_keys, fact_vals, fact_mask, dim_keys, dim_bucket, K)
        assert _join_agg(*args) == _want(*args), top


def test_sorted_merge_join_overflow_fallback():
    """Facts spread uniformly over all 4000 dims, every fact kept."""
    rng = np.random.default_rng(4)
    n_dim, n_fact, K = 4000, 8192, 8
    dim_keys = np.arange(n_dim, dtype=np.uint64) * 3 + 1
    dim_bucket = (np.arange(n_dim) % K).astype(np.int32)
    fact_keys = rng.integers(0, n_dim, n_fact).astype(np.uint64) * 3 + 1
    fact_vals = rng.integers(0, 100, n_fact).astype(np.uint64)
    fact_mask = np.ones(n_fact, bool)
    args = (fact_keys, fact_vals, fact_mask, dim_keys, dim_bucket, K)
    assert _join_agg(*args) == _want(*args)


def test_merge_join_gid_edges():
    from eventql_tpu.kernels.join import dim_join_gid

    # empty dim table
    gid = dim_join_gid(
        jnp.asarray(np.array([1, 2, 3], np.uint64)),
        jnp.asarray(np.array([], np.uint64)),
        jnp.asarray(np.array([], np.int32)),
    )
    assert list(np.asarray(gid)) == [-1, -1, -1]

    # duplicate fact keys + extreme keys (0 and u64 max)
    dim_keys = np.array([0, 7, 0xFFFFFFFFFFFFFFFF], np.uint64)
    dim_bucket = np.array([2, 5, 9], np.int32)
    facts = np.array([0, 0, 7, 7, 8, 0xFFFFFFFFFFFFFFFF], np.uint64)
    gid = dim_join_gid(
        jnp.asarray(facts), jnp.asarray(dim_keys), jnp.asarray(dim_bucket)
    )
    assert list(np.asarray(gid)) == [2, 2, 5, 5, -1, 9]


def test_fact_dim_join_aggregate_large_dim_routes_merge():
    """A dim table larger than the fact key span's matches: exact."""
    rng = np.random.default_rng(5)
    n_dim, n_fact, K = 3000, 20000, 32
    dim_keys = rng.permutation(np.arange(n_dim, dtype=np.uint64) * 11 + 5)
    dim_bucket = rng.integers(0, K, n_dim).astype(np.int32)
    fact_keys = rng.integers(0, n_dim * 2, n_fact).astype(np.uint64) * 11 + 5
    fact_vals = rng.integers(0, 50, n_fact).astype(np.uint64)
    fact_mask = rng.random(n_fact) < 0.9
    args = (fact_keys, fact_vals, fact_mask, dim_keys, dim_bucket, K)
    assert _join_agg(*args) == _want(*args)


def test_sorted_merge_join_value_bits_packing():
    """20-bit values under a 50% filter."""
    rng = np.random.default_rng(6)
    n_dim, n_fact, K = 5000, 30000, 16
    dim_keys = rng.permutation(np.arange(n_dim, dtype=np.uint64) * 7 + 1)
    dim_bucket = rng.integers(0, K, n_dim).astype(np.int32)
    fact_keys = rng.integers(0, n_dim * 2, n_fact).astype(np.uint64) * 7 + 1
    fact_vals = rng.integers(0, 1 << 20, n_fact).astype(np.uint64)
    fact_mask = rng.random(n_fact) < 0.5
    args = (fact_keys, fact_vals, fact_mask, dim_keys, dim_bucket, K)
    assert _join_agg(*args) == _want(*args)


def test_merge_join_mixed_blocks_per_block_fallback():
    """One hot key for half the facts, the other half uniform over all
    dims: per-row results exact for both."""
    from eventql_tpu.kernels.join import dim_join_gid

    rng = np.random.default_rng(7)
    n_dim = 2000
    dim_keys = np.arange(n_dim, dtype=np.uint64) * 5 + 2
    dim_bucket = (np.arange(n_dim) % 7).astype(np.int32)
    hot = np.full(512, 42 * 5 + 2, np.uint64)
    uniform = rng.integers(0, n_dim * 2, 512).astype(np.uint64) * 5 + 2
    facts = np.concatenate([hot, uniform])
    gid = np.asarray(dim_join_gid(
        jnp.asarray(facts), jnp.asarray(dim_keys), jnp.asarray(dim_bucket)
    ))
    lut = {int(k): int(b) for k, b in zip(dim_keys, dim_bucket)}
    exp = np.array([lut.get(int(k), -1) for k in facts], np.int32)
    assert list(gid) == list(exp)
