"""KV-cache storage dtype: the fp32 path.

Counterpart of ``mingpt_distributed_tpu/serving/quant.py`` for its default
path. ``resolve_kv_dtype`` maps the ``--kv-dtype`` vocabulary to a
quantization descriptor; ``None`` means the plain ``{"k", "v"}`` cache in the
model's compute dtype, which is all the port's pool stores today. int8 and
fp8 payloads with power-of-two scale planes (``KVQuant`` with a real
``qdtype``) are ROADMAP.md Queue 1 item 14 and raise here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["KV_DTYPES", "KVQuant", "resolve_kv_dtype"]

#: the --kv-dtype vocabulary (serve.py, InferenceServer, DecodeEngine)
KV_DTYPES = ("fp32", "int8", "fp8")


@dataclasses.dataclass(frozen=True)
class KVQuant:
    """Quantization descriptor of a quantized pool (name, payload dtype,
    largest representable magnitude)."""

    name: str
    qdtype: Any
    qmax: float

    def __str__(self) -> str:
        return self.name


def resolve_kv_dtype(name: Optional[str]) -> Optional[KVQuant]:
    """None for the unquantized pool ("fp32", "float32" or None); raises
    NotImplementedError for a quantized dtype and ValueError for a name
    outside ``KV_DTYPES``."""
    if name is None or name in ("fp32", "float32"):
        return None
    if name in ("int8", "fp8"):
        raise NotImplementedError(
            f"kv_dtype={name!r}: the quantized KV pool is not ported yet "
            "(ROADMAP.md Queue 1 item 14)")
    raise ValueError(f"unknown kv_dtype {name!r} (choose from {KV_DTYPES})")
