"""Roofline peak tables of the cards the port runs on: the single source.

Counterpart of ``mingpt_distributed_tpu/telemetry/peaks.py`` with the port's
own rows (the TPU rows mean nothing here). ``training/metrics.py`` (MFU,
roofline bounds), ``telemetry/attribution.py`` and ``chip_smoke.py`` read
these numbers from here. The rates are NVIDIA's data-sheet peaks (SXM part,
dense, no sparsity) at the card's full power limit (700 W for the H100
SXM); the capacity is what the CUDA driver reports
(``torch.cuda.get_device_properties``), not a table row.
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = [
    "H100_SXM",
    "PEAKS",
    "device_name",
    "peak_flops",
    "peak_flops_per_chip",
    "peak_hbm_bytes_per_chip",
    "peak_hbm_capacity_per_chip",
]

# keyed by a substring of torch.cuda.get_device_name(): operations per
# second by compute dtype, and device-memory bytes per second
PEAKS: Dict[str, Dict[str, float]] = {
    "H100": {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
             "hbm_bytes_per_s": 3.35e12},
}
H100_SXM = PEAKS["H100"]


def device_name(index: int = 0) -> Optional[str]:
    """The CUDA card's name, or None without one."""
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(index)


def peak_flops(name: Optional[str], dtype: str) -> Optional[float]:
    """Peak operations per second of card ``name`` for ``dtype``, or None
    when the card (or the CPU: ``name`` None) is not in the table."""
    for key, peaks in PEAKS.items():
        if name is not None and key in name:
            return peaks.get(dtype)
    return None


def peak_flops_per_chip(dtype: str = "bfloat16") -> Optional[float]:
    """This process's card's peak for ``dtype`` (None off the table)."""
    return peak_flops(device_name(), dtype)


def peak_hbm_bytes_per_chip() -> Optional[float]:
    """This process's card's device-memory bandwidth in bytes/s."""
    return peak_flops(device_name(), "hbm_bytes_per_s")


def peak_hbm_capacity_per_chip() -> Optional[float]:
    """This process's card's device memory in bytes, from the driver (None
    without a card)."""
    import torch

    if not torch.cuda.is_available():
        return None
    return float(torch.cuda.get_device_properties(0).total_memory)
