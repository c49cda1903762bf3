"""Tests that need the card: the device routes and kernels against
their references on the GPU. They skip elsewhere; run them with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_device_routes_default_on(gpu, monkeypatch):
    from eventql_tpu.exec.backend import device_routes_enabled

    monkeypatch.delenv("EVENTQL_TPU_DEVICE", raising=False)
    assert device_routes_enabled()
    monkeypatch.setenv("EVENTQL_TPU_DEVICE", "0")
    assert not device_routes_enabled()


def test_f64_sort_bits_exact_on_card(gpu):
    """Doubles equal in their top 48 bits stay distinct, ordered keys."""
    from eventql_tpu.kernels.groupby import f64_sort_bits

    base = np.float64(1234.5678)
    bits = base.view(np.uint64) + np.arange(8, dtype=np.uint64)
    x = np.concatenate([bits.view(np.float64), -bits.view(np.float64)])
    k = np.asarray(f64_sort_bits(jnp.asarray(x)))
    assert len(np.unique(k)) == len(x)
    assert np.array_equal(np.argsort(k, kind="stable"),
                          np.argsort(x, kind="stable"))


def test_bounded_scatter_exact_on_card(gpu):
    """Atomic scatter-add sums are exact u64 under heavy contention."""
    from eventql_tpu.kernels.bucket_agg import fused_sum_count

    rng = np.random.default_rng(0)
    n, K = 1 << 22, 1024
    gid = rng.integers(0, K, n).astype(np.int32)
    v = rng.integers(0, 1 << 16, n).astype(np.int32)
    counts, sums = fused_sum_count(
        jnp.asarray(gid), jnp.asarray(v), jnp.int32(1 << 15),
        jnp.int32(n), K, value_bits=16,
    )
    m = v < (1 << 15)
    assert np.array_equal(np.asarray(counts), np.bincount(gid[m], minlength=K))
    assert np.array_equal(
        np.asarray(sums),
        np.bincount(gid[m], weights=v[m], minlength=K).astype(np.uint64),
    )


def test_device_sql_matches_host_on_card(gpu):
    """A small chip_smoke server phase: every query's device rows match
    the host engine's."""
    import chip_smoke

    out = chip_smoke.server_phase(rows=1 << 16, dims=(1024, 4096), reps=2)
    assert set(out["queries"]) == {q[0] for q in chip_smoke.QUERIES}
