"""Quantized KV-cache and weight-leaf storage.

Counterpart of ``mingpt_distributed_tpu/serving/quant.py``. Symmetric
per-channel quantization for the serving stack: KV rows are stored as int8
or fp8 (``torch.float8_e4m3fn``) with an fp32 *scale plane* beside the data.

**Power-of-two scales make requantization exactly idempotent.** The scale
of a channel is ``2**ceil(log2(amax / qmax))``: multiplying or dividing a
float by a power of two is exact, the element at ``amax`` maps back into
``(qmax/2, qmax]`` so the re-derived exponent is unchanged, and ``round()``
of an exactly recovered integer is that integer. So ``dequantize →
quantize`` returns the same payload and scale bit for bit, any number of
times, at the cost of at most one bit of quantization error. The JAX
engine relies on this to requantize a whole slot lane after every forward;
the port's engine quantizes only the rows a call writes
(``write_layer_rows``), which gives the same pool because every other row
would come back unchanged.

The scale is computed exactly here (from ``torch.frexp`` of the fp32
ratio: ratio / mantissa is an exact power of two), so the CPU and the card
agree. The JAX package takes ``exp2(ceil(log2(amax / qmax)))`` through
XLA, whose CPU ``log2`` misses some exact powers of two by ~2e-6 (2^k for
k in {-31, -30, -27, -26, -15, -13, 13, 15, 26, 27, 30, 31}: for the
negative ones its scale doubles when ``amax / qmax`` is exactly that
power) and whose CPU ``exp2`` is not exact at integers outside [-12, 12]
(2^-13 and below but -14, and 2^13, 2^15, ...: its scale is then not a
power of two). Inside that range the two packages give the same payloads
and scales bit for bit; ``tests/test_torch_quant.py`` pins what each gives
outside it.

fp8's round trip keeps the values but may renormalise a row once: a row
whose largest payload rounds down to exactly ``qmax / 2`` (e4m3 rounds
(224, 232] to 224) re-derives half the scale and doubles its payload on
its first requantization, the same numbers, and is stable from then on.
int8 cannot (its payload's largest magnitude stays above 63.5). The JAX
package has the same property.

Layout: a quantized cache, lane or prefix entry is the plain ``{"k", "v"}``
dict grown to ``{"k", "v", "k_scale", "v_scale"}``; the scale planes are
fp32 with the data's shape except ``head_dim -> 1`` (one scale per layer,
slot, row and kv head), so every slicing of the pool applies to them
unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = [
    "KV_DTYPES",
    "KVQuant",
    "SCALE_SUFFIX",
    "data_names",
    "dequantize",
    "dequantize_lane",
    "fp8_dtype",
    "init_quant_cache",
    "max_abs_logit_error",
    "quantize",
    "quantize_lane",
    "quantize_weight",
    "resolve_kv_dtype",
    "scale_bytes",
    "split_scales",
    "write_layer_rows",
]

#: the --kv-dtype vocabulary (serve.py, InferenceServer, DecodeEngine)
KV_DTYPES = ("fp32", "int8", "fp8")

#: scale planes are always fp32: exact powers of two over the whole fp32
#: exponent range, whatever the payload dtype
SCALE_DTYPE = torch.float32

#: cache leaf names carrying quantized payload (scales ride beside them as
#: ``<name>_scale``)
DATA_NAMES = ("k", "v")
SCALE_SUFFIX = "_scale"


@dataclasses.dataclass(frozen=True)
class KVQuant:
    """Quantization descriptor of a quantized pool: name, payload dtype and
    the largest magnitude the payload dtype represents."""

    name: str        # "int8" | "fp8"
    qdtype: Any      # storage dtype of the payload leaves
    qmax: float

    def __str__(self) -> str:
        return self.name


def fp8_dtype():
    """torch's e4m3 dtype, or None when this torch lacks it."""
    return getattr(torch, "float8_e4m3fn", None)


def resolve_kv_dtype(name) -> Optional[KVQuant]:
    """None (the unquantized pool: "fp32", "float32" or None) or a
    KVQuant. "fp8" raises ValueError where torch has no
    ``float8_e4m3fn``; a name outside ``KV_DTYPES`` raises ValueError."""
    if name is None or name in ("fp32", "float32"):
        return None
    if isinstance(name, KVQuant):
        return name
    if name == "int8":
        return KVQuant("int8", torch.int8, 127.0)
    if name == "fp8":
        dt = fp8_dtype()
        if dt is None:
            raise ValueError(
                "kv_dtype='fp8' needs a torch with float8_e4m3fn; this build "
                "lacks it: use 'int8' or 'fp32'")
        return KVQuant("fp8", dt, float(torch.finfo(dt).max))
    raise ValueError(f"unknown kv_dtype {name!r} (choose from {KV_DTYPES})")


def quant_for_payload(dtype: torch.dtype) -> KVQuant:
    """The descriptor of a pool whose payload leaves are ``dtype``."""
    return resolve_kv_dtype("int8" if dtype == torch.int8 else "fp8")


def _pow2_scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """2**ceil(log2(amax/qmax)) in fp32, taken exactly: with r = amax/qmax
    = m * 2**e, m in [0.5, 1) (``torch.frexp``), the power is 2**e = r / m
    (an exact quotient), or r itself when m == 0.5 (r a power of two). 0
    where amax == 0 (an all-zero channel quantizes and dequantizes to exact
    zeros)."""
    amax = amax.to(SCALE_DTYPE)
    # a tensor divisor: CUDA divides by a host scalar as a product with
    # its reciprocal, which is not correctly rounded
    ratio = amax / torch.full_like(amax, qmax)
    mant, _ = torch.frexp(ratio)
    scale = torch.where(mant == 0.5, ratio, ratio / mant)
    return torch.where(amax > 0, scale, 0.0)


def _to_payload(x: torch.Tensor, scale: torch.Tensor, q: KVQuant) -> torch.Tensor:
    safe = torch.where(scale > 0, scale, 1.0)
    y = x.to(SCALE_DTYPE) / safe
    if q.qdtype == torch.int8:
        return torch.round(y.clamp(-q.qmax, q.qmax)).to(torch.int8)
    return y.to(q.qdtype)


def quantize(x: torch.Tensor, q: KVQuant) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel quantize over the last axis: ``(payload,
    scale)``, the payload in ``q.qdtype`` with x's shape, the scale fp32
    with ``x.shape[:-1] + (1,)``."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = _pow2_scale(amax, q.qmax)
    return _to_payload(x, scale, q), scale


def dequantize(payload: torch.Tensor, scale: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """payload * scale in ``dtype`` (default fp32). Zero-scale channels hold
    zero payloads, so the product needs no guard."""
    out = payload.to(SCALE_DTYPE) * scale
    return out if dtype is None or dtype == SCALE_DTYPE else out.to(dtype)


def quantize_weight(w: torch.Tensor, q: KVQuant) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel quantize of a weight leaf: one scale per index of
    the LAST axis (the output features of every matmul leaf), reducing over
    all other axes."""
    amax = w.abs().amax(dim=tuple(range(w.ndim - 1)), keepdim=True)
    scale = _pow2_scale(amax, q.qmax)
    return _to_payload(w, scale, q), scale


# ---------------------------------------------------------------------------
# lane / cache structure
# ---------------------------------------------------------------------------


def data_names(cache: Dict[str, torch.Tensor]) -> Tuple[str, ...]:
    """The payload leaf names of a cache, lane or entry dict."""
    return tuple(n for n in sorted(cache) if not n.endswith(SCALE_SUFFIX))


def split_scales(cache: Dict[str, torch.Tensor]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(payload leaves, scale leaves)."""
    data = {n: a for n, a in cache.items() if not n.endswith(SCALE_SUFFIX)}
    scales = {n: a for n, a in cache.items() if n.endswith(SCALE_SUFFIX)}
    return data, scales


def init_quant_cache(cfg, n_slots: int, q: KVQuant,
                     device: Optional[torch.device] = None,
                     kv_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The quantized counterpart of ``generate.init_cache``: zeroed payload
    buffers in ``q.qdtype`` and zeroed fp32 scale planes. ``kv_heads``:
    this rank's share under tensor parallelism; a scale plane is per head
    and row, so the planes shard the same axis as the payloads."""
    shape = (cfg.n_layer, n_slots, cfg.block_size, kv_heads or cfg.kv_heads,
             cfg.head_dim)
    sshape = shape[:-1] + (1,)
    out: Dict[str, torch.Tensor] = {}
    for n in DATA_NAMES:
        out[n] = torch.zeros(shape, dtype=q.qdtype, device=device)
        out[n + SCALE_SUFFIX] = torch.zeros(sshape, dtype=SCALE_DTYPE, device=device)
    return out


def quantize_lane(lane: Dict[str, torch.Tensor], q: KVQuant) -> Dict[str, torch.Tensor]:
    """``{"k", "v"}`` lane -> quantized lane with scale planes."""
    out: Dict[str, torch.Tensor] = {}
    for n in DATA_NAMES:
        out[n], out[n + SCALE_SUFFIX] = quantize(lane[n], q)
    return out


def dequantize_lane(qlane: Dict[str, torch.Tensor],
                    dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Quantized lane -> fp32 (or ``dtype``) ``{"k", "v"}`` lane."""
    return {n: dequantize(qlane[n], qlane[n + SCALE_SUFFIX], dtype)
            for n in DATA_NAMES}


def scale_bytes(cfg, n_slots: int) -> int:
    """Bytes the scale planes add for this geometry (K and V)."""
    elems = cfg.n_layer * n_slots * cfg.block_size * cfg.kv_heads
    return 2 * elems * torch.finfo(SCALE_DTYPE).bits // 8


def write_layer_rows(cache: Dict[str, torch.Tensor], layer: int, offset,
                     k: torch.Tensor, v: torch.Tensor, dtype: torch.dtype
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cached forward's write and read of one layer of a quantized
    cache (``models/generate._cached_block``).

    ``k``/``v`` are the call's (B, T, KV, hd) rows at ``offset`` (one int,
    or a (B,) tensor of per-row positions with T = 1). Returns the layer's
    (B, S, KV, hd) K and V in ``dtype`` for attention: every stored row
    dequantized, and the call's rows as computed (in ``dtype``), which is
    what the JAX engine's dequantized lane holds during its forward. The
    call's rows are then quantized into the cache in place: only they
    change, and the rest of the lane is what the JAX engine's whole-lane
    requantization would give back, bit for bit (the idempotency above).
    """
    q = quant_for_payload(cache["k"].dtype)
    per_row = torch.is_tensor(offset) and offset.dim() == 1
    new = torch.stack([k, v]).to(dtype)  # K and V rows quantized together
    payload, s = quantize(new, q)
    if per_row:
        rows = torch.arange(new.shape[1], device=new.device)
    out = []
    for i, name in enumerate(DATA_NAMES):
        data, scale = cache[name], cache[name + SCALE_SUFFIX]
        full = dequantize(data[layer], scale[layer], dtype)
        if per_row:
            full[rows, offset] = new[i, :, 0]
            data[layer, rows, offset] = payload[i, :, 0]
            scale[layer, rows, offset] = s[i, :, 0]
        else:
            t = new.shape[2]
            full[:, offset:offset + t] = new[i]
            data[layer, :, offset:offset + t] = payload[i]
            scale[layer, :, offset:offset + t] = s[i]
        out.append(full)
    return out[0], out[1]


# ---------------------------------------------------------------------------
# quality probe
# ---------------------------------------------------------------------------


@torch.no_grad()
def max_abs_logit_error(params, cfg, tokens, q: KVQuant) -> float:
    """Max |logit(fp32 cache) - logit(quantized round-trip cache)| at a
    prompt's last position: the number the quant selftest samples into the
    ``mingpt_serve_quant_logit_err_max`` gauge.

    The same single-sequence cached forward runs twice: once against the
    exact cache of the prompt's first rows and once against that cache
    pushed through a quantize/dequantize round trip; the last token's row
    is written unquantized in both, so the difference isolates KV storage
    precision (weights and activations are the same in both runs)."""
    from mingpt_distributed_tpu_torch.models import generate as gen

    dev = params["wte"].device
    ids = torch.as_tensor([list(tokens)], dtype=torch.long, device=dev)
    length = ids.shape[1]
    cache = gen.init_cache(cfg, 1, dev)
    gen._forward_cached_hidden(params, ids, cache, 0, cfg)
    rt = dequantize_lane(quantize_lane(cache, q))
    rt = {n: rt[n].to(cache[n].dtype) for n in DATA_NAMES}
    last = ids[:, length - 1:length]
    hidden_exact = gen._forward_cached_hidden(params, last, cache,
                                              length - 1, cfg)
    hidden_rt = gen._forward_cached_hidden(params, last, rt, length - 1, cfg)
    exact = gen._head_logits(params, hidden_exact, cfg)
    approx = gen._head_logits(params, hidden_rt, cfg)
    return float((exact - approx).abs().max())
