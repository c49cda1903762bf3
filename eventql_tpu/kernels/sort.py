"""Device sort / top-k kernels (ORDER BY [LIMIT]).

The reference materializes all rows and std::sorts them with compiled
comparators (reference: sql/statements/select/orderby.cc:58-168). Here
ORDER BY is a device multi-key sort over order-preserving unsigned keys
(jax.lax.sort), and ORDER BY + LIMIT k a top-k over a single key.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from eventql_tpu.kernels.groupby import sortable_u64


@jax.jit
def order_permutation(sort_keys: Tuple[jax.Array, ...]) -> jax.Array:
    """Stable permutation ordering rows by the given pre-transformed
    unsigned key arrays (ascending unsigned order; callers apply
    sortable_u64 with their descending flags, and may pass uint32 or
    uint16 keys where a static bound proves the u64 key fits: narrower
    keys move fewer bytes through the sort)."""
    n = sort_keys[0].shape[0]
    idx_dtype = jnp.int32 if n < (1 << 31) else jnp.int64
    iota = jnp.arange(n, dtype=idx_dtype)
    ops = list(sort_keys) + [iota]
    out = jax.lax.sort(ops, num_keys=len(sort_keys), is_stable=True)
    return out[-1]


def make_sort_keys(columns, descendings) -> Tuple[jax.Array, ...]:
    return tuple(
        sortable_u64(c, descending=d) for c, d in zip(columns, descendings)
    )


@functools.partial(jax.jit, static_argnames=("k",))
def topk_permutation(sort_key: jax.Array, k: int) -> jax.Array:
    """Indices of the k rows with the LARGEST pre-transformed keys, in
    descending key order. For ORDER BY x DESC LIMIT k pass
    sortable_u64(x); for ORDER BY x ASC LIMIT k pass
    sortable_u64(x, descending=True) (the flip makes the smallest x the
    largest key). Ties break toward the lowest row index."""
    if sort_key.dtype == jnp.uint16:
        # u16 keys exist for the full-sort route's benefit
        sort_key = sort_key.astype(jnp.uint32)
    _, idx = jax.lax.top_k(sort_key, k)
    return idx.astype(jnp.int64)
