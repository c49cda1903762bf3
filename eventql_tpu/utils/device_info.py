"""The card a measurement ran on, and its published peaks.

Every timing this repository reports is stamped with device_stamp():
JAX's platform, device kind and device count, and the card's power
limit as nvidia-smi reads it (a card below its maximum limit runs
slower under load). Rates are divided by the published peak of the
device kind; a kind missing from the table is an error, not a default.
"""

from __future__ import annotations

import subprocess

# Published HBM bandwidth in bytes/s, by JAX device_kind. Source: the
# NVIDIA H100 Tensor Core GPU data sheet (H100 SXM 3.35 TB/s, H100 PCIe
# 2.0 TB/s).
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def hbm_bytes_per_s(device_kind: str) -> float:
    try:
        return HBM_BYTES_PER_S[device_kind]
    except KeyError:
        raise KeyError(
            f"no published HBM peak for device kind {device_kind!r}"
        ) from None


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    for the first card; raises where there is no nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def device_stamp() -> dict:
    """The fields every result line carries; raises without a GPU."""
    from eventql_tpu.exec.backend import require_gpu

    devices = require_gpu()
    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "power_limit": card_line().split(",")[-1].strip(),
    }
