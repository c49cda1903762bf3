"""Distributed fact-dim join + aggregate over the device mesh
(broadcast join: facts sharded, dims replicated, accumulators psum'd). The reference's analog re-joins remote row streams on the
coordinator (hash_join.cc + ops/query_remote.cc)."""

import jax
import jax.numpy as jnp
import numpy as np

from eventql_tpu.parallel.distributed import (
    distributed_join_aggregate,
    make_mesh,
    shard_table,
)


def _expected(fact_keys, fact_vals, fact_mask, dim_keys, dim_bucket, K):
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


def test_distributed_join_aggregate_exact():
    assert len(jax.devices()) >= 8
    mesh = make_mesh(8)
    n, n_dim, K = 8 * 4096, 300, 16
    rng = np.random.default_rng(2)
    dim_keys = rng.permutation(np.arange(n_dim, dtype=np.uint64) * 13 + 7)
    dim_bucket = rng.integers(0, K, n_dim).astype(np.int32)
    fact_keys = rng.integers(0, n_dim * 2, n).astype(np.uint64) * 13 + 7
    fact_vals = rng.integers(0, 1000, n).astype(np.uint64)
    fact_mask = rng.random(n) < 0.8

    fk, fv, fm = shard_table(mesh, [fact_keys, fact_vals, fact_mask])
    counts, sums = distributed_join_aggregate(
        mesh, fk, fv, fm,
        jnp.asarray(dim_keys), jnp.asarray(dim_bucket), K,
    )
    exp_counts, exp_sums = _expected(
        fact_keys, fact_vals, fact_mask, dim_keys, dim_bucket, K
    )
    assert list(np.asarray(counts)) == list(exp_counts)
    assert list(np.asarray(sums)) == list(exp_sums)


def test_distributed_join_aggregate_compare_probe():
    """The sharded probe agrees with the single-device join + aggregate
    (kernels/join.py) and with the host reference."""
    from eventql_tpu.kernels.join import fact_dim_join_aggregate

    assert len(jax.devices()) >= 8
    mesh = make_mesh(8)
    n, n_dim, K = 8 * 1024, 64, 8
    rng = np.random.default_rng(3)
    dim_keys = rng.permutation(np.arange(n_dim, dtype=np.uint64) * 9 + 1)
    dim_bucket = (np.arange(n_dim) % K).astype(np.int32)
    fact_keys = rng.integers(0, n_dim, n).astype(np.uint64) * 9 + 1
    fact_vals = rng.integers(0, 100, n).astype(np.uint64)
    fact_mask = np.ones(n, bool)

    fk, fv, fm = shard_table(mesh, [fact_keys, fact_vals, fact_mask])
    counts, sums = distributed_join_aggregate(
        mesh, fk, fv, fm,
        jnp.asarray(dim_keys), jnp.asarray(dim_bucket), K,
    )
    single = fact_dim_join_aggregate(
        jnp.asarray(fact_keys), jnp.asarray(fact_vals),
        jnp.asarray(fact_mask), jnp.asarray(dim_keys),
        jnp.asarray(dim_bucket), K,
    )
    got = (list(np.asarray(counts)), list(np.asarray(sums)))
    assert got == (list(np.asarray(single[0])), list(np.asarray(single[1])))
    exp_counts, exp_sums = _expected(
        fact_keys, fact_vals, fact_mask, dim_keys, dim_bucket, K
    )
    assert got == (list(exp_counts), list(exp_sums))


def _expected_multi(
    fk1, fk2, fv, fm, d1_keys, d1_bucket, d2_keys, d2_flag, K
):
    lut1 = {int(k): int(b) for k, b in zip(d1_keys, d1_bucket)}
    lut2 = {int(k): int(f) for k, f in zip(d2_keys, d2_flag)}
    counts = np.zeros(K, np.uint64)
    sums = np.zeros(K, np.uint64)
    for k1, k2, v, m in zip(fk1, fk2, fv, fm):
        if not m or int(k1) not in lut1 or lut2.get(int(k2)) != 1:
            continue
        b = lut1[int(k1)]
        counts[b] += 1
        sums[b] += np.uint64(v)
    return counts, sums


def test_distributed_multi_join_aggregate_ring():
    """Multi-join + multi-agg with dim1 SHARDED and ring-rotated over
    the mesh (shuffle overlapped with compute — BASELINE.json config 5):
    facts join dim1 (group bucket) and dim2 (flag filter)."""
    from eventql_tpu.parallel.distributed import (
        distributed_multi_join_aggregate,
    )

    assert len(jax.devices()) >= 8
    mesh = make_mesh(8)
    n, n_dim1, n_dim2, K = 8 * 2048, 8 * 40, 96, 12
    rng = np.random.default_rng(4)
    d1_keys = rng.permutation(np.arange(n_dim1, dtype=np.uint64) * 13 + 7)
    d1_bucket = rng.integers(0, K, n_dim1).astype(np.int32)
    d2_keys = rng.permutation(np.arange(n_dim2, dtype=np.uint64) * 5 + 3)
    d2_flag = rng.integers(0, 2, n_dim2).astype(np.int32)
    fk1 = rng.integers(0, n_dim1 * 2, n).astype(np.uint64) * 13 + 7
    fk2 = rng.integers(0, n_dim2, n).astype(np.uint64) * 5 + 3
    fv = rng.integers(0, 1000, n).astype(np.uint64)
    fm = rng.random(n) < 0.8

    fk1_d, fk2_d, fv_d, fm_d, d1k_d, d1b_d = shard_table(
        mesh, [fk1, fk2, fv, fm, d1_keys, d1_bucket]
    )
    counts, sums = distributed_multi_join_aggregate(
        mesh, fk1_d, fk2_d, fv_d, fm_d, d1k_d, d1b_d,
        jnp.asarray(d2_keys), jnp.asarray(d2_flag), K,
    )
    exp_counts, exp_sums = _expected_multi(
        fk1, fk2, fv, fm, d1_keys, d1_bucket, d2_keys, d2_flag, K
    )
    assert list(np.asarray(counts)) == list(exp_counts)
    assert list(np.asarray(sums)) == list(exp_sums)


def test_distributed_multi_join_compare_probe_ring():
    """Ring multi-join on a second data set: every dim1 shard matches
    some facts, and the flag filter drops about half."""
    from eventql_tpu.parallel.distributed import (
        distributed_multi_join_aggregate,
    )

    assert len(jax.devices()) >= 8
    mesh = make_mesh(8)
    n, n_dim1, n_dim2, K = 8 * 512, 8 * 16, 32, 6
    rng = np.random.default_rng(5)
    d1_keys = rng.permutation(np.arange(n_dim1, dtype=np.uint64) * 9 + 1)
    d1_bucket = rng.integers(0, K, n_dim1).astype(np.int32)
    d2_keys = rng.permutation(np.arange(n_dim2, dtype=np.uint64) * 3 + 2)
    d2_flag = rng.integers(0, 2, n_dim2).astype(np.int32)
    fk1 = rng.integers(0, n_dim1 * 2, n).astype(np.uint64) * 9 + 1
    fk2 = rng.integers(0, n_dim2, n).astype(np.uint64) * 3 + 2
    fv = rng.integers(0, 100, n).astype(np.uint64)
    fm = np.ones(n, bool)

    sharded = shard_table(mesh, [fk1, fk2, fv, fm, d1_keys, d1_bucket])
    counts, sums = distributed_multi_join_aggregate(
        mesh, *sharded,
        jnp.asarray(d2_keys), jnp.asarray(d2_flag), K,
    )
    exp = _expected_multi(
        fk1, fk2, fv, fm, d1_keys, d1_bucket, d2_keys, d2_flag, K
    )
    assert (list(np.asarray(counts)), list(np.asarray(sums))) == (
        list(exp[0]), list(exp[1])
    )


def test_distributed_count_distinct_exact():
    """Exact COUNT(DISTINCT v) GROUP BY k over the mesh: local dedup +
    all-gather + replicated recount collapses cross-shard duplicates."""
    from eventql_tpu.parallel.distributed import distributed_count_distinct

    assert len(jax.devices()) >= 8
    mesh = make_mesh(8)
    n = 8 * 2048
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 9, n).astype(np.uint64)
    vals = rng.integers(0, 40, n).astype(np.uint64)  # heavy duplication
    mask = rng.random(n) < 0.85

    k_d, v_d, m_d = shard_table(mesh, [keys, vals, mask])
    gk, counts, valid = distributed_count_distinct(mesh, m_d, (k_d,), v_d)
    got = {}
    gk0, counts_h, valid_h = map(np.asarray, (gk[0], counts, valid))
    for i in range(len(valid_h)):
        if valid_h[i]:
            got[int(gk0[i])] = int(counts_h[i])
    exp = {}
    for k, v, m in zip(keys, vals, mask):
        if m:
            exp.setdefault(int(k), set()).add(int(v))
    assert got == {k: len(s) for k, s in exp.items()}
