"""eventql_tpu — a vectorized SQL query-execution engine on JAX.

A from-scratch reimplementation of the capability set of EventQL's csql
engine (the reference implementation, C++), redesigned for an accelerator:

* expressions compile to columnar JAX/XLA programs instead of a
  row-at-a-time stack VM (reference: sql/runtime/vm.cc:107-157)
* tables are columnar device arrays with validity masks and
  dictionary-encoded strings (reference SVector: sql/svalue.h:131)
* GroupBy is a device hash/segment aggregate (reference:
  sql/statements/select/groupby.cc), distributed GroupByMerge becomes
  partial aggregation + collectives over a jax.sharding.Mesh
* ORDER BY is a device sort (reference: orderby.cc uses std::sort)

Exact row parity with the reference's golden SQL test suite
(test/sql/*.sql) is the correctness contract.
"""

import jax

jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"


def Runtime(*args, **kwargs):
    """Construct the default query runtime (lazy import)."""
    from eventql_tpu.exec.runtime import Runtime as _Runtime

    return _Runtime(*args, **kwargs)


__all__ = ["Runtime", "__version__"]
