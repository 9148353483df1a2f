"""Multi-head causal self-attention: the plain tensor oracle.

Counterpart of ``mingpt_distributed_tpu/ops/attention.py`` and, as there, the
definition of correctness: the flash kernel (ops/flash_attention.py) is held
against it. Logits and softmax run in float32, masked positions get the
finite ``NEG_INF`` (no NaN even for a fully masked row), and the output is
cast to q's dtype. Shapes: q (B, T, H, hd), k/v (B, S, KV, hd).

The cached decode path (models/generate.py) calls this oracle on the card
too, exactly as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30  # large-finite instead of -inf: keeps softmax NaN-free


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2-style logit soft-capping: cap * tanh(x / cap); identity when
    cap is None/0."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Expand KV heads for grouped-query attention: (B,S,KV,hd)->(B,S,KV*rep,hd)."""
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(
        b, s, kv * n_rep, hd)


def causal_attention(
    q: torch.Tensor,  # (B, T, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,  # (B, S, KV, hd)
    *,
    attn_pdrop: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    kv_offset: Union[int, torch.Tensor] = 0,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Causal scaled-dot-product attention, softmax in float32.

    ``kv_offset`` is the absolute position of q[0] relative to k[0]: 0 for
    self-attention (S == T), the cache length during incremental decoding.
    ``window`` keeps only the last ``window`` positions, the query's own
    included; ``logit_softcap`` caps the scores before masking. Attention
    dropout draws its mask from ``generator``. Returns (B, T, H, hd) in q's
    dtype.
    """
    b, t, h, hd = q.shape
    kv = k.shape[2]
    k = repeat_kv(k, h // kv)
    v = repeat_kv(v, h // kv)

    scale = 1.0 / math.sqrt(hd)
    # (B, H, T, S) logits in float32
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    logits = softcap(logits, logit_softcap)

    s = k.shape[1]
    q_pos = torch.arange(t, device=q.device)[:, None] + kv_offset
    k_pos = torch.arange(s, device=q.device)[None, :]
    allowed = q_pos >= k_pos
    if window is not None:
        allowed = allowed & (q_pos - k_pos < window)
    logits = torch.where(allowed[None, None], logits,
                         torch.full((), NEG_INF, device=q.device))

    probs = torch.softmax(logits, dim=-1)
    if not deterministic and attn_pdrop > 0.0:
        if generator is None:
            raise ValueError("attention dropout needs a torch.Generator")
        keep = 1.0 - attn_pdrop
        mask = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < keep
        probs = torch.where(mask, probs / keep, torch.zeros((), device=q.device))

    # probabilities rounded to v's dtype, products summed in float32
    out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embeddings at the given absolute positions.

    Returns (P, head_dim/2) float32 each, split-half (rotate-half) convention.
    """
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exponent)
    angles = positions.float()[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate (B, T, H, hd) by per-position tables (T, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    cos = cos[None, :, None, :].float()
    sin = sin[None, :, None, :].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
