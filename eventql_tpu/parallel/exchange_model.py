"""Analytic exchange-volume model of the distributed sort.

parallel/distributed.py routes every mesh collective through tallying
helpers (exchange_tally); shapes are static under jit, so the trace-time
counts are exact. This module states the same volumes in closed form,
so a test can check the tally against arithmetic.

A distance-j exchange (bitonic stage partners i ^ j sit j apart) loads
every ring link j times its message size, so a stage's hop-weighted
bytes per device are rows × row_bytes × j.
"""

from __future__ import annotations

from typing import List


def sort_stage_distances(n_devices: int) -> List[int]:
    """Bitonic compare-split network: for k = 2,4,..,P and j = k/2..1
    (halving), partners are i ^ j at ring distance j."""
    out = []
    k = 2
    while k <= n_devices:
        j = k // 2
        while j >= 1:
            out.append(j)
            j //= 2
        k *= 2
    return out


def sort_exchange_link_bytes(
    n_local: int, row_bytes: int, n_devices: int
) -> int:
    """Total hop-weighted bytes per device for a full distributed sort
    (what the _xch_ppermute tally records sum to)."""
    return sum(
        n_local * row_bytes * j for j in sort_stage_distances(n_devices)
    )
