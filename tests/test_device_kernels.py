"""Device kernel tests: grouped aggregation, sort, and the distributed
group-by/merge pipeline on a virtual multi-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eventql_tpu.kernels.groupby import (
    grouped_aggregate,
    masked_grouped_aggregate,
    sortable_u64,
)
from eventql_tpu.kernels.sort import (
    make_sort_keys,
    order_permutation,
    topk_permutation,
)


def test_sortable_u64_orders():
    rng = np.random.default_rng(0)
    for arr in [
        rng.integers(-(2**62), 2**62, 100).astype(np.int64),
        rng.integers(0, 2**63, 100).astype(np.uint64),
        rng.standard_normal(100) * 1e6,
    ]:
        k = np.asarray(sortable_u64(jnp.asarray(arr)))
        assert (np.argsort(k, kind="stable") == np.argsort(arr, kind="stable")).all()


def test_grouped_aggregate_sum_count():
    keys = jnp.array([3, 1, 3, 2, 1, 3], dtype=jnp.uint64)
    vals = jnp.array([10, 20, 30, 40, 50, 60], dtype=jnp.uint64)
    gk, (sums, counts), first, ng = grouped_aggregate(
        (keys,), (vals, vals), ("sum", "count")
    )
    ng = int(ng)
    assert ng == 3
    out = {
        int(gk[0][i]): (int(sums[i]), int(counts[i])) for i in range(ng)
    }
    assert out == {1: (70, 2), 2: (40, 1), 3: (100, 3)}
    # first-occurrence indices
    firsts = {int(gk[0][i]): int(first[i]) for i in range(ng)}
    assert firsts == {3: 0, 1: 1, 2: 3}


def test_masked_grouped_aggregate():
    keys = jnp.array([1, 1, 2, 2, 3], dtype=jnp.uint64)
    vals = jnp.array([1.0, 2.0, 3.0, 4.0, 100.0])
    mask = jnp.array([True, True, True, False, False])
    gk, (sums,), first, ng = masked_grouped_aggregate(
        mask, (keys,), (vals,), ("sum",)
    )
    assert int(ng) == 2
    got = {int(gk[0][i]): float(sums[i]) for i in range(int(ng))}
    assert got == {1: 3.0, 2: 3.0}


def test_order_permutation_matches_lexsort():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 5, 64).astype(np.uint64)
    b = rng.standard_normal(64)
    keys = make_sort_keys([jnp.asarray(a), jnp.asarray(b)], [False, True])
    perm = np.asarray(order_permutation(keys))
    expected = np.lexsort((-b, a))
    assert (perm == expected).all()


def test_topk():
    x = jnp.asarray(np.random.default_rng(2).standard_normal(128))
    k = sortable_u64(x)
    idx = np.asarray(topk_permutation(k, 5))
    expected = np.argsort(-np.asarray(x))[:5]
    assert (idx == expected).all()


def test_distributed_grouped_aggregate():
    from eventql_tpu.parallel.distributed import (
        distributed_grouped_aggregate,
        make_mesh,
        shard_table,
    )

    assert len(jax.devices()) >= 8, "conftest should force 8 CPU devices"
    mesh = make_mesh(8)
    n = 8 * 64
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 17, n).astype(np.uint64)
    vals = rng.integers(0, 1000, n).astype(np.uint64)
    mask = rng.random(n) < 0.7

    keys_d, vals_d, mask_d = shard_table(mesh, [keys, vals, mask])
    gk, (sums, counts), valid = distributed_grouped_aggregate(
        mesh, mask_d, (keys_d,), (vals_d, vals_d), ("sum", "count")
    )
    gk, sums, counts, valid = map(np.asarray, (gk[0], sums, counts, valid))

    got = {
        int(gk[i]): (int(sums[i]), int(counts[i]))
        for i in range(len(valid))
        if valid[i]
    }
    expected = {}
    for k, v, m in zip(keys, vals, mask):
        if m:
            s, c = expected.get(int(k), (0, 0))
            expected[int(k)] = (s + int(v), c + 1)
    assert got == expected


def test_distributed_topk():
    from eventql_tpu.kernels.groupby import sortable_u64
    from eventql_tpu.parallel.distributed import (
        distributed_topk,
        make_mesh,
        shard_table,
    )

    mesh = make_mesh(8)
    n = 8 * 256
    rng = np.random.default_rng(9)
    vals = rng.standard_normal(n)
    keys = np.asarray(sortable_u64(jnp.asarray(vals)))  # ORDER BY vals DESC
    idx = np.arange(n, dtype=np.int64)

    keys_d, idx_d = shard_table(mesh, [keys, idx])
    top_keys, top_idx = distributed_topk(mesh, keys_d, idx_d, 10)
    top_idx = np.asarray(top_idx)

    expected = np.argsort(-vals)[:10]
    assert (top_idx == expected).all()

    # bounded keys (rank-encoded, span < 2^32) ride uint32 through the
    # per-shard top_k and all-gather; returned keys restore to uint64
    ranks = np.argsort(np.argsort(keys)).astype(np.uint64)
    rk_d = shard_table(mesh, [ranks])[0]
    bk, bi = distributed_topk(mesh, rk_d, idx_d, 10, key_bound=(0, n - 1))
    assert np.asarray(bk).dtype == np.uint64
    assert (np.asarray(bi) == expected).all()
    assert (np.asarray(bk) == ranks[expected]).all()


def test_fast_topk_histogram_threshold():
    """u64 top-k is exact and ordered, also when every key shares its
    top bits (kernels/sort.py topk_permutation)."""
    import numpy as np

    from eventql_tpu.kernels.sort import topk_permutation

    rng = np.random.default_rng(11)
    n, k = 1 << 22, 57
    keys = rng.integers(0, 1 << 63, n, dtype=np.uint64)
    idx = np.asarray(topk_permutation(jnp.asarray(keys), k))
    vals = keys[idx]
    assert (np.sort(vals)[::-1] == np.sort(keys)[::-1][:k]).all()
    assert (vals[:-1] >= vals[1:]).all()  # descending order

    # all keys share the top 12 bits
    skew = (np.uint64(0x5A5) << np.uint64(52)) | rng.integers(
        0, 1 << 52, n, dtype=np.uint64
    )
    idx2 = np.asarray(topk_permutation(jnp.asarray(skew), k))
    assert (np.sort(skew[idx2])[::-1] == np.sort(skew)[::-1][:k]).all()


def test_pallas_sum_count_large_cardinality_multipass():
    """Large key cardinality with 48-bit values: exact counts and
    mod-2^64 sums in every bucket."""
    import numpy as np
    from eventql_tpu.kernels.bucket_agg import bounded_sum_count

    rng = np.random.default_rng(8)
    n, K = 60000, 40000
    gid = rng.integers(0, K, n).astype(np.int32)
    vals = rng.integers(0, 1 << 48, n).astype(np.uint64)
    mask = rng.random(n) < 0.7

    counts, sums = bounded_sum_count(
        jnp.asarray(mask), jnp.asarray(gid), jnp.asarray(vals), K
    )
    counts, sums = np.asarray(counts), np.asarray(sums)

    exp_counts = np.zeros(K, np.uint64)
    exp_sums = np.zeros(K, np.uint64)
    for g, v, m in zip(gid, vals, mask):
        if m:
            exp_counts[g] += 1
            exp_sums[g] += v
    assert list(counts) == list(exp_counts)
    assert list(sums) == list(exp_sums)


def test_pallas_count_only():
    """count(*)-only fast path (no value planes, no value stream)."""
    import numpy as np
    from eventql_tpu.kernels.bucket_agg import bounded_grouped_aggregate

    rng = np.random.default_rng(11)
    n, K = 50000, 1024
    gid = rng.integers(0, K, n).astype(np.int32)
    mask = rng.random(n) < 0.6

    counts = np.asarray(
        bounded_grouped_aggregate(
            jnp.asarray(mask), jnp.asarray(gid), (), ("count",), K
        )[0]
    )
    exp = np.zeros(K, np.uint64)
    for g, m in zip(gid, mask):
        if m:
            exp[g] += 1
    assert list(counts) == list(exp)


def test_pallas_count_only_multipass():
    import numpy as np
    from eventql_tpu.kernels.bucket_agg import bounded_grouped_aggregate

    rng = np.random.default_rng(12)
    n, K = 40000, 40000
    gid = rng.integers(0, K, n).astype(np.int32)
    mask = np.ones(n, bool)
    counts = np.asarray(
        bounded_grouped_aggregate(
            jnp.asarray(mask), jnp.asarray(gid), (), ("count",), K
        )[0]
    )
    exp = np.bincount(gid, minlength=K).astype(np.uint64)
    assert (counts == exp).all()


def test_grouped_aggregate_count_only_routes_fast_path():
    import numpy as np
    from eventql_tpu.kernels.bucket_agg import bounded_grouped_aggregate

    rng = np.random.default_rng(13)
    n, K = 30000, 256
    gid = rng.integers(0, K, n).astype(np.int32)
    mask = rng.random(n) < 0.5
    counts, outs = bounded_grouped_aggregate(
        jnp.asarray(mask), jnp.asarray(gid), (), ("count",), K
    )
    exp = np.bincount(gid[mask], minlength=K).astype(np.uint64)
    assert (np.asarray(counts) == exp).all()
    assert (np.asarray(outs[0]) == exp).all()


def test_fast_topk_u32():
    """u32 top-k (the statically-bounded key path): exact, ordered,
    tie-stable toward the lowest index, also when every key shares its
    top bits (kernels/sort.py topk_permutation)."""
    import numpy as np

    from eventql_tpu.kernels.sort import topk_permutation

    rng = np.random.default_rng(13)
    n, k = 1 << 22, 57
    keys = rng.integers(0, 1 << 31, n, dtype=np.uint32)
    idx = np.asarray(topk_permutation(jnp.asarray(keys), k))
    vals = keys[idx]
    assert (np.sort(vals)[::-1] == np.sort(keys)[::-1][:k]).all()
    assert (vals[:-1] >= vals[1:]).all()

    # heavy ties: low-cardinality keys — lowest-index tie break
    ties = (rng.integers(0, 3, n) * 0x40000000).astype(np.uint32)
    idx2 = np.asarray(topk_permutation(jnp.asarray(ties), k))
    want = np.argsort(-ties.astype(np.int64), kind="stable")[:k]
    assert (idx2 == want).all()

    # all keys share the top 12 bits
    skew = (np.uint32(0x5A5) << np.uint32(20)) | rng.integers(
        0, 1 << 20, n, dtype=np.uint32
    )
    idx3 = np.asarray(topk_permutation(jnp.asarray(skew), k))
    assert (np.sort(skew[idx3])[::-1] == np.sort(skew)[::-1][:k]).all()


def test_topk_permutation_dispatches_u32():
    import numpy as np

    from eventql_tpu.kernels.sort import topk_permutation

    rng = np.random.default_rng(3)
    n = 1 << 22
    keys = rng.integers(0, 1 << 16, n, dtype=np.uint32)
    idx = np.asarray(topk_permutation(jnp.asarray(keys), 9))
    vals = keys[idx]
    assert (np.sort(vals)[::-1] == np.sort(keys)[::-1][:9]).all()


# -- fused-predicate bounded GROUP BY -----------------------------------
@pytest.mark.parametrize("op,npop", [
    ("lt", np.less), ("le", np.less_equal), ("gt", np.greater),
    ("ge", np.greater_equal), ("eq", np.equal), ("ne", np.not_equal),
])
def test_pallas_sum_count_fused_ops(op, npop):
    """Fused predicate: every compare op, with rows past n_real as
    padding (the row-pad mask)."""
    from eventql_tpu.kernels.bucket_agg import fused_sum_count

    rng = np.random.default_rng(3)
    n, K, thr = 20000, 300, 512
    gid = rng.integers(0, K, n).astype(np.int32)
    vals = rng.integers(0, 1000, n).astype(np.int32)

    # 1000 padding rows past n_real that every predicate would keep
    pad_gid = np.concatenate([gid, np.zeros(1000, np.int32)])
    pad_vals = np.concatenate([vals, np.full(1000, thr, np.int32)])
    counts, sums = fused_sum_count(
        jnp.asarray(pad_gid), jnp.asarray(pad_vals), jnp.int32(thr),
        jnp.int32(n), K, value_bits=16, pred_op=op,
    )
    counts, sums = np.asarray(counts), np.asarray(sums)

    m = npop(vals, thr)
    exp_counts = np.bincount(gid[m], minlength=K)
    exp_sums = np.bincount(
        gid[m], weights=vals[m].astype(np.float64), minlength=K
    ).astype(np.uint64)
    assert np.array_equal(counts, exp_counts)
    assert np.array_equal(sums, exp_sums)


def test_pallas_sum_count_fused_pred_stream_and_16bit():
    """Separate predicate stream; 16-bit gid/value/pred streams with
    unsigned payloads above 2^15 (zero-extended, not sign-extended)."""
    from eventql_tpu.kernels.bucket_agg import fused_sum_count

    rng = np.random.default_rng(4)
    n, K, thr = 30000, 129, 40000
    gid = rng.integers(0, K, n).astype(np.int16)
    vals = rng.integers(0, 60000, n).astype(np.uint16)
    pred = rng.integers(0, 65535, n).astype(np.uint16)

    counts, sums = fused_sum_count(
        jnp.asarray(gid), jnp.asarray(vals), jnp.int32(thr),
        jnp.int32(n), K, pred=jnp.asarray(pred), value_bits=16,
        pred_op="ge",
    )
    counts, sums = np.asarray(counts), np.asarray(sums)

    m = pred.astype(np.int64) >= thr
    exp_counts = np.bincount(gid[m], minlength=K)
    exp_sums = np.bincount(
        gid[m], weights=vals[m].astype(np.float64), minlength=K
    ).astype(np.uint64)
    assert np.array_equal(counts, exp_counts)
    assert np.array_equal(sums, exp_sums)


def test_pallas_sum_count_fused_multipass_u64():
    """Large key cardinality with a 64-bit value stream and an i32
    predicate stream."""
    from eventql_tpu.kernels.bucket_agg import fused_sum_count

    rng = np.random.default_rng(5)
    n, K, thr = 50000, 40000, 100000
    gid = rng.integers(0, K, n).astype(np.int32)
    vals = rng.integers(0, 1 << 48, n).astype(np.uint64)
    pred = rng.integers(0, 200000, n).astype(np.int32)

    counts, sums = fused_sum_count(
        jnp.asarray(gid), jnp.asarray(vals), jnp.int32(thr),
        jnp.int32(n), K, pred=jnp.asarray(pred), value_bits=64,
        pred_op="lt",
    )
    counts, sums = np.asarray(counts), np.asarray(sums)

    m = pred < thr
    exp_counts = np.zeros(K, np.uint64)
    exp_sums = np.zeros(K, np.uint64)
    for g, v, mm in zip(gid, vals, m):
        if mm:
            exp_counts[g] += 1
            exp_sums[g] += v
    assert np.array_equal(counts, exp_counts.astype(counts.dtype))
    assert np.array_equal(sums, exp_sums)


def test_pallas_multi_sum_exact():
    """Multi-stream aggregation: per-stream sums are full mod-2^64
    accumulations, for few and for many streams."""
    from eventql_tpu.kernels.bucket_agg import bounded_multi_sum

    rng = np.random.default_rng(1)
    n, K = 30000, 300
    gid = rng.integers(0, K, n).astype(np.int32)
    s1 = rng.integers(0, 1 << 16, n).astype(np.int32)
    s2 = rng.integers(0, 1 << 24, n).astype(np.int32)
    s3 = rng.integers(0, 256, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    counts, tots = bounded_multi_sum(
        jnp.asarray(mask), jnp.asarray(gid),
        (jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(s3)),
        (2, 3, 1), K,
    )
    counts = np.asarray(counts)
    ec = np.bincount(gid[mask], minlength=K)
    assert np.array_equal(counts, ec)
    for s, t in zip((s1, s2, s3), tots):
        want = np.bincount(
            gid[mask], weights=s[mask].astype(np.float64), minlength=K
        ).astype(np.uint64)
        assert np.array_equal(np.asarray(t), want)

    # many streams at a larger K
    Kb = 3000
    gid2 = rng.integers(0, Kb, n).astype(np.int32)
    streams = tuple(
        jnp.asarray(rng.integers(0, 1 << 24, n).astype(np.int32))
        for _ in range(12)
    )
    counts2, tots2 = bounded_multi_sum(
        jnp.asarray(mask), jnp.asarray(gid2), streams, (3,) * 12, Kb
    )
    assert np.array_equal(
        np.asarray(counts2), np.bincount(gid2[mask], minlength=Kb)
    )
    for s, t in zip(streams, tots2):
        want = np.bincount(
            gid2[mask],
            weights=np.asarray(s)[mask].astype(np.float64),
            minlength=Kb,
        ).astype(np.uint64)
        assert np.array_equal(np.asarray(t), want)


def test_pallas_count_fused_and_gid_base():
    """Count-only fused form: no value stream; always-true predicate
    via ge INT32_MIN; predicate-on-key (pred_on_gid); numeric-key base
    subtract (gid_base)."""
    from eventql_tpu.kernels.bucket_agg import fused_count, fused_sum_count

    rng = np.random.default_rng(9)
    n, K, base = 20000, 200, 1000
    keys = rng.integers(base, base + K, n).astype(np.int32)

    # always-true count
    counts = fused_count(
        jnp.asarray(keys), jnp.int32(-(1 << 31)), jnp.int32(n), K,
        pred_op="ge", gid_base=jnp.int32(base),
    )
    assert np.array_equal(
        np.asarray(counts), np.bincount(keys - base, minlength=K)
    )

    # predicate on the key column itself (pre-base compare)
    thr = base + 77
    counts = fused_count(
        jnp.asarray(keys), jnp.int32(thr), jnp.int32(n), K,
        pred_op="lt", pred_on_gid=True, gid_base=jnp.int32(base),
    )
    assert np.array_equal(
        np.asarray(counts),
        np.bincount((keys - base)[keys < thr], minlength=K),
    )

    # separate predicate stream + base
    pred = rng.integers(0, 1000, n).astype(np.int32)
    counts = fused_count(
        jnp.asarray(keys), jnp.int32(500), jnp.int32(n), K,
        pred=jnp.asarray(pred), pred_op="ge", gid_base=jnp.int32(base),
    )
    assert np.array_equal(
        np.asarray(counts),
        np.bincount((keys - base)[pred >= 500], minlength=K),
    )

    # sum variant with gid_base (numeric narrow keys)
    vals = rng.integers(0, 1000, n).astype(np.int32)
    counts, sums = fused_sum_count(
        jnp.asarray(keys), jnp.asarray(vals), jnp.int32(800),
        jnp.int32(n), K, pred_op="lt", value_bits=16,
        gid_base=jnp.int32(base),
    )
    m = vals < 800
    assert np.array_equal(
        np.asarray(counts), np.bincount((keys - base)[m], minlength=K)
    )
    assert np.array_equal(
        np.asarray(sums),
        np.bincount(
            (keys - base)[m], weights=vals[m].astype(np.float64),
            minlength=K,
        ).astype(np.uint64),
    )

    # u32-narrow keys above 2^31: the modular i32 base subtract stays
    # exact (key and base both bitcast negative; the difference is the
    # true span offset)
    kbig = (
        rng.integers(0, K, n).astype(np.uint64) + ((1 << 31) + 5)
    ).astype(np.uint32)
    base_i32 = np.uint32((1 << 31) + 5).astype(np.int64) - (1 << 32)
    counts = fused_count(
        jax.lax.bitcast_convert_type(jnp.asarray(kbig), jnp.int32),
        jnp.int32(-(1 << 31)), jnp.int32(n), K, pred_op="ge",
        gid_base=jnp.int32(int(base_i32)),
    )
    assert np.array_equal(
        np.asarray(counts),
        np.bincount(
            (kbig.astype(np.int64) - ((1 << 31) + 5)), minlength=K
        ),
    )
