"""Seeded randomized differential fuzz: host engine vs the MESH tier
(exec/mesh_exec.py over the virtual 8-device CPU mesh).

Reuses the device-parity fuzz generator (same tables, same query
grammar: GROUP BY over sum/count/min/max/mean/count_distinct,
WHERE and/or conjunctions, ORDER BY, LIMIT). Every query must produce
identical ResultLists whether served by the host engine or a
MeshTableProvider (which routes eligible shapes through the sharded
partial-aggregate + mesh exchange programs and host-falls-back
otherwise). Failures reproduce by seed."""

import random

import pytest

from eventql_tpu.exec.runtime import Runtime
from eventql_tpu.parallel.mesh_provider import MeshTableProvider

from tests.test_fuzz_device_parity import _gen_query, _make_table


def _mesh_provider_from(host_provider):
    p = MeshTableProvider(n_devices=8)
    p.add_table("t", host_provider.get_table_data("t"))
    return p


def _run(provider, query: str):
    rt = Runtime()
    txn = rt.new_transaction(provider)
    res = rt.build_query_plan(txn, query).execute(0)
    return (res.columns, res.rows)


@pytest.mark.parametrize("seed", range(40))
def test_fuzz_host_mesh_parity(seed):
    rng = random.Random(1000 + seed)
    host_p = _make_table(rng)
    query = _gen_query(rng)
    host = _run(host_p, query)
    mesh = _run(_mesh_provider_from(host_p), query)
    assert host == mesh, (
        f"seed={seed} query={query!r}\nhost={host[1][:8]}\nmesh={mesh[1][:8]}"
    )


def test_fuzz_mesh_is_not_vacuous():
    """A sizable share of the fuzzed queries must actually route
    through a mesh program, else this degrades to host-vs-host."""
    from eventql_tpu.exec import mesh_exec

    before = (
        mesh_exec.MESH_GROUPBY_RUNS
        + mesh_exec.MESH_TOPK_RUNS
        + mesh_exec.MESH_ORDER_RUNS
    )
    for seed in range(40):
        rng = random.Random(1000 + seed)
        host_p = _make_table(rng)
        query = _gen_query(rng)
        _run(_mesh_provider_from(host_p), query)
    after = (
        mesh_exec.MESH_GROUPBY_RUNS
        + mesh_exec.MESH_TOPK_RUNS
        + mesh_exec.MESH_ORDER_RUNS
    )
    assert after - before >= 15, (
        f"only {after - before}/40 fuzz queries took a mesh route"
    )
