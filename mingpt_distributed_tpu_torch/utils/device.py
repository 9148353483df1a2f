"""Device choice for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. Without a GPU
and without an explicit request they raise: nothing falls back to the CPU
quietly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

Device = Union[str, torch.device]


def resolve_device(device: Optional[Device] = None) -> torch.device:
    """``cuda`` by default, ``cpu`` only when asked; raises when CUDA is
    requested (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
