"""Worker process for the multi-host tier test (spawned by
tests/test_multihost.py the way the reference's automation harness
spawns evqld processes, test/automate/cluster.cc:34-52).

Each worker joins the jax.distributed runtime with 4 virtual CPU
devices, forms the global mesh, and runs the mesh primitives over data
sharded across BOTH processes. Worker 0 verifies exactness against a
host reference and prints MULTIHOST_OK."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import numpy as np

    from eventql_tpu.parallel.multihost import (
        fetch_replicated,
        fetch_sharded,
        global_mesh,
        init_multihost,
        make_global_table,
    )

    init_multihost(f"127.0.0.1:{port}", nproc, pid)
    mesh = global_mesh()
    n_dev = len(jax.devices())
    assert n_dev == 4 * nproc, f"expected {4 * nproc} global devices"

    n = n_dev * 32
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 13, n).astype(np.uint64)
    vals = rng.integers(0, 100, n).astype(np.uint64)
    mask = rng.random(n) < 0.8
    keys_d, vals_d, mask_d = make_global_table(mesh, [keys, vals, mask])

    expected = {}
    for k, v, m in zip(keys, vals, mask):
        if m:
            s, c = expected.get(int(k), (0, 0))
            expected[int(k)] = (s + int(v), c + 1)

    # 1. replicated-merge distributed GROUP BY (psum/all-gather tier)
    from eventql_tpu.parallel.distributed import (
        distributed_grouped_aggregate,
        distributed_grouped_aggregate_sharded,
        distributed_sort,
    )

    gk, (sums, counts), valid = distributed_grouped_aggregate(
        mesh, mask_d, (keys_d,), (vals_d, vals_d), ("sum", "count")
    )
    gk0, s_h, c_h, v_h = (
        fetch_replicated(gk[0]),
        fetch_replicated(sums),
        fetch_replicated(counts),
        fetch_replicated(valid),
    )
    got = {
        int(gk0[i]): (int(s_h[i]), int(c_h[i]))
        for i in range(len(v_h))
        if v_h[i]
    }
    assert got == expected, "replicated group-by mismatch across hosts"

    # 2. sharded high-cardinality GROUP BY (compare-split sort exchange)
    sgk, saggs, svalid = distributed_grouped_aggregate_sharded(
        mesh, mask_d, (keys_d,), (vals_d, vals_d), ("sum", "count")
    )
    sgk0 = fetch_sharded(sgk[0])
    ss = fetch_sharded(saggs[0])
    sc = fetch_sharded(saggs[1])
    sv = fetch_sharded(svalid)
    got_sharded = {
        int(sgk0[i]): (int(ss[i]), int(sc[i]))
        for i in range(len(sv))
        if sv[i]
    }
    assert got_sharded == expected, "sharded group-by mismatch across hosts"

    # 3. full distributed ORDER BY (bitonic compare-split over DCN + the device interconnect)
    from eventql_tpu.kernels.groupby import sortable_u64
    import jax.numpy as jnp

    ids = np.arange(n, dtype=np.int64)
    (ids_d,) = make_global_table(mesh, [ids])
    (sk,), (sp,) = distributed_sort(
        mesh, (sortable_u64(vals_d.astype(jnp.uint64)),), (ids_d,)
    )
    sk_h = fetch_sharded(sk)
    sp_h = fetch_sharded(sp)
    assert (sk_h[:-1] <= sk_h[1:]).all(), "distributed sort not ordered"
    assert sorted(zip(sk_h.tolist(), sp_h.tolist())) == sorted(
        zip(vals.tolist(), ids.tolist())
    ), "distributed sort lost rows"

    if pid == 0:
        print("MULTIHOST_OK", flush=True)


if __name__ == "__main__":
    main()
