"""Normalisation, activation, dropout and MLP building blocks.

Counterpart of ``mingpt_distributed_tpu/ops/layers.py``: plain functions on
tensors with the same mixed-precision rules. Normalisations run in float32
and cast back; matmuls run in the activation's compute dtype with the
float32 weight cast to it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 regardless of the input dtype."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in float32 regardless of the input dtype."""
    dtype = x.dtype
    x = x.float()
    y = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale).to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, the GPT-2 variant."""
    return F.gelu(x, approximate="tanh")


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout; identity when deterministic or rate == 0. The mask
    is drawn from ``generator``, which must live on x's device."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device)).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w (+ b) with the matmul in x's compute dtype."""
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def mlp_gelu(x: torch.Tensor, w_fc: torch.Tensor, b_fc: Optional[torch.Tensor],
             w_proj: torch.Tensor, b_proj: Optional[torch.Tensor]) -> torch.Tensor:
    """The transformer MLP: fc -> GELU -> proj."""
    return dense(gelu(dense(x, w_fc, b_fc)), w_proj, b_proj)


def mlp_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down(silu(gate(x)) * up(x))."""
    return dense(F.silu(dense(x, w_gate)) * dense(x, w_up), w_down)
