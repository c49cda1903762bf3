"""The backend decisions (exec/backend.py): where device routes run,
where compiled programs are cached, and that a requested device run
never falls back to the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eventql_tpu.exec import backend


@pytest.mark.parametrize("flag,platform,want", [
    (None, "gpu", True),
    ("0", "gpu", False),
    ("1", "gpu", True),
    (None, "cpu", False),
    ("0", "cpu", False),
    ("1", "cpu", True),
])
def test_device_routes_enabled(monkeypatch, flag, platform, want):
    if flag is None:
        monkeypatch.delenv(backend.DEVICE_ENV, raising=False)
    else:
        monkeypatch.setenv(backend.DEVICE_ENV, flag)
    monkeypatch.setattr(backend, "platform", lambda: platform)
    assert backend.device_routes_enabled() is want


def test_compile_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv(backend.CACHE_ENV, str(tmp_path))
    assert backend.compile_cache_dir() == str(tmp_path)
    monkeypatch.delenv(backend.CACHE_ENV)
    assert backend.compile_cache_dir() == os.path.join(
        backend.REPO_ROOT, ".jax_cache"
    )


def test_install_compile_cache_sets_only_the_repo_path(monkeypatch, tmp_path):
    prev = jax.config.jax_compilation_cache_dir
    try:
        # variable set: JAX reads it itself, nothing is set here
        jax.config.update("jax_compilation_cache_dir", None)
        monkeypatch.setenv(backend.CACHE_ENV, str(tmp_path))
        assert backend.install_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir is None
        # variable unset: the fixed path inside the checkout
        monkeypatch.delenv(backend.CACHE_ENV)
        path = backend.install_compile_cache()
        assert path == backend.DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == path
        assert os.path.isdir(path)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_runtime_installs_compile_cache(monkeypatch):
    from eventql_tpu.exec.runtime import Runtime

    calls = []
    monkeypatch.setattr(
        backend, "install_compile_cache", lambda: calls.append(1)
    )
    Runtime()
    assert calls == [1]


def test_require_gpu_raises_without_a_card():
    with pytest.raises(RuntimeError, match="GPU run was requested"):
        backend.require_gpu()


def test_dryrun_multichip_needs_enough_devices():
    """No silent fallback to other devices: too few raises."""
    from __graft_entry__ import dryrun_multichip

    with pytest.raises(RuntimeError, match="need 64"):
        dryrun_multichip(64)


def test_f64_sort_bits_distinguishes_low_bits():
    """Doubles that agree in every bit above bit 48 get distinct keys in
    float order (the exact IEEE bit path)."""
    from eventql_tpu.kernels.groupby import f64_sort_bits

    base = np.array([1234.5678, -0.001953125, 3.0e300]).view(np.uint64)
    bits = (base[:, None] + np.arange(0, 1 << 12, 97, dtype=np.uint64))
    x = bits.reshape(-1).view(np.float64)
    k = np.asarray(f64_sort_bits(jnp.asarray(x)))
    assert len(np.unique(k)) == len(x)
    assert np.array_equal(np.argsort(k, kind="stable"),
                          np.argsort(x, kind="stable"))


def test_float_sum_route_within_tolerance(monkeypatch):
    """Float sums on the device GROUP BY route agree with the host
    engine to a relative 1e-12 (they add in another order)."""
    from eventql_tpu.core.types import SType
    from eventql_tpu.exec.relation import Column, Relation
    from eventql_tpu.exec.runtime import RelationTableProvider, Runtime

    rng = np.random.default_rng(7)
    n = 50000
    k = rng.integers(0, 37, n).astype(np.uint64)
    f = rng.standard_normal(n) * 1e6
    rel = Relation(["k", "f"], [
        Column(SType.UINT64, k, np.ones(n, bool)),
        Column(SType.FLOAT64, f, np.ones(n, bool)),
    ], n)
    p = RelationTableProvider()
    p.add_table("t", rel)
    rt = Runtime()
    q = "select k, sum(f), mean(f) from t group by k order by k;"
    out = {}
    for flag in ("0", "1"):
        monkeypatch.setenv(backend.DEVICE_ENV, flag)
        out[flag] = rt.execute_query(rt.new_transaction(p), q)[0].rows
    assert len(out["0"]) == len(out["1"]) == 37
    for host, dev in zip(out["0"], out["1"]):
        assert host[0] == dev[0]
        for h, d in zip(host[1:], dev[1:]):
            h, d = float(h), float(d)
            assert abs(h - d) <= 1e-12 * max(abs(h), abs(d))
