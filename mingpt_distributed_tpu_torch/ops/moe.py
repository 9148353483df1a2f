"""Mixture-of-experts MLP with capacity-based dispatch (GShard/Switch style).

Counterpart of ``mingpt_distributed_tpu/ops/moe.py`` at ep = 1: the same
routing and the same dense dispatch, so the port's outputs, aux loss and
gradients equal the JAX package's on the same weights. Dispatch and combine
are products against a one-hot (G, gs, E, cap) tensor, as in the JAX layer;
there is no hand-written kernel (the JAX layer has no Pallas kernel either).

Tokens are routed in groups of at most ``MAX_GROUP`` (the largest divisor of
the token count in [MIN_GROUP, MAX_GROUP], else one group), each with its own
per-expert capacity ``cap = max(1, ceil(top_k * gs / E * capacity_factor))``.
Routing: a float32 softmax router, top-k by repeated argmax (the first
maximum wins ties, as ``jnp.argmax`` does). k = 1 (Switch) scales an expert's
output by the raw router probability, so the router gets the task loss's
gradient; k >= 2 (GShard) renormalises the chosen gates to sum to 1. Tokens
past an expert's capacity are dropped for that choice (the block's residual
still carries them). The aux loss is Switch's E * sum_e f_e * P_e over all
tokens.

``per_row=True`` routes each batch row on its own (groups never span two
rows): the serving engine's batched decode step, one token per slot, which
the JAX engine runs as a ``vmap`` of the solo step over the slots, so no
slot competes with another for capacity. Every other call (training, the
prefill chunks, solo ``generate``, verify) routes its B*T tokens together,
as JAX does.

When capacity binds, which tokens drop depends on the set routed together,
so a KV-cached decode reproduces a full re-forward only where nothing
drops (capacity_factor >= E / k guarantees it).

Expert parallelism (the JAX layer's ``ep_axis``) is ROADMAP.md Queue 1
item 12b.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from mingpt_distributed_tpu_torch.ops import layers as L

MAX_GROUP = 1024
MIN_GROUP = 128


def _group_size(s: int) -> int:
    """Tokens routed as one group: s itself up to MAX_GROUP, else its largest
    divisor in [MIN_GROUP, MAX_GROUP], else s (one big group: more dispatch
    memory, but per-expert capacity never collapses toward 1)."""
    if s <= MAX_GROUP:
        return s
    for g in range(MAX_GROUP, MIN_GROUP - 1, -1):
        if s % g == 0:
            return g
    return s


def capacity(gs: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    """Per-group, per-expert buffer length."""
    return max(1, math.ceil(top_k * gs / n_experts * capacity_factor))


def _route_groups(probs: torch.Tensor, top_k: int, cap: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every group's dispatch and combine from (G, gs, E) float32 router
    probabilities: (dispatch (G, gs, E, cap), combine (G, gs, E, cap), the
    top-1 one-hot (G, gs, E)). The JAX ``_route_group``, vmapped."""
    n_groups, _, e = probs.shape
    remaining = probs
    gates: List[torch.Tensor] = []
    onehots: List[torch.Tensor] = []
    for _ in range(top_k):
        oh = F.one_hot(remaining.argmax(dim=-1), e).to(probs.dtype)
        gates.append((probs * oh).sum(dim=-1))  # the true prob, not masked
        onehots.append(oh)
        remaining = remaining * (1.0 - oh)
    denom = sum(gates) if top_k > 1 else torch.ones_like(gates[0])
    slots = torch.arange(cap, device=probs.device, dtype=probs.dtype)
    counts = probs.new_zeros((n_groups, 1, e))
    dispatch = combine = None
    for g, oh in zip(gates, onehots):
        # each token's place in its expert's buffer, after the tokens that
        # earlier choices placed there
        pos = counts + torch.cumsum(oh, dim=1) - oh           # (G, gs, E)
        keep = oh * (pos < cap)
        counts = counts + keep.sum(dim=1, keepdim=True)
        sel = keep[..., None] * (pos[..., None] == slots)     # (G, gs, E, cap)
        part = sel * (g / torch.clamp(denom, min=1e-9))[..., None, None]
        dispatch = sel if dispatch is None else dispatch + sel
        combine = part if combine is None else combine + part
    return dispatch, combine, onehots[0]


def moe_mlp(
    x: torch.Tensor,          # (B, T, D) post-norm activations
    w_router: torch.Tensor,   # (D, E)
    w_e1: torch.Tensor,       # (E, D, F)
    w_e2: torch.Tensor,       # (E, F, D)
    *,
    top_k: int = 2,
    capacity_factor: float = 1.25,
    w_gate: Optional[torch.Tensor] = None,  # (E, D, F): SwiGLU experts
    per_row: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-routed MLP: GELU experts, or SwiGLU when ``w_gate`` is given
    (h = silu(x w_gate) * (x w_e1), Mixtral-style). Returns (out (B, T, D) in
    x's dtype, the aux loss as a float32 scalar). The router runs in
    float32; the expert products in x's dtype with the float32 weights cast
    to it, summed in float32 by the matmul; the combine in float32."""
    b, t, d = x.shape
    e = w_e1.shape[0]
    if w_router.shape[1] != e:
        raise ValueError(f"router has {w_router.shape[1]} experts, weights imply {e}")
    s = b * t
    gs = _group_size(t if per_row else s)
    ng = s // gs
    xs = x.reshape(ng, gs, d)

    probs = torch.softmax(xs.float() @ w_router.float(), dim=-1)  # (G, gs, E)
    cap = capacity(gs, e, top_k, capacity_factor)
    dispatch, combine, top1 = _route_groups(probs, top_k, cap)

    # (G, gs, E*cap)^T x (G, gs, D) -> experts see (E, G*cap, D)
    expert_in = torch.einsum("gsc,gsd->gcd", dispatch.to(x.dtype).reshape(ng, gs, e * cap),
                             xs)
    expert_in = expert_in.reshape(ng, e, cap, d).transpose(0, 1).reshape(e, ng * cap, d)
    up = torch.bmm(expert_in, w_e1.to(x.dtype))
    if w_gate is not None:
        h = F.silu(torch.bmm(expert_in, w_gate.to(x.dtype)).float()) * up.float()
    else:
        h = L.gelu(up.float())
    expert_out = torch.bmm(h.to(x.dtype), w_e2.to(x.dtype)).float()  # (E, G*cap, D)
    expert_out = expert_out.reshape(e, ng, cap, d).transpose(0, 1).reshape(ng, e * cap, d)
    out = torch.bmm(combine.reshape(ng, gs, e * cap), expert_out).to(x.dtype)

    # Switch load-balancing loss on the top-1 assignment, over all tokens
    f = top1.reshape(s, e).mean(dim=0)     # fraction routed per expert
    p = probs.reshape(s, e).mean(dim=0)    # mean router prob per expert
    aux = e * (f * p).sum()
    return out.reshape(b, t, d), aux


def moe_flops(tokens: int, d: int, ffn: int, n_experts: int, top_k: int,
              capacity_factor: float, swiglu: bool, per_row: bool = False,
              rows: int = 1) -> int:
    """Multiply-add operations x 2 of one ``moe_mlp`` forward over ``tokens``
    tokens (``rows`` rows of tokens/rows when ``per_row``), as routed: the
    router, the dispatch and combine products, and every expert's FFN over
    its whole capacity buffer (the dense dispatch computes the padded
    slots too). Elementwise work is not counted, nor is the dispatch of a
    one-token group, which is a broadcast multiply: the count is
    ``torch.utils.flop_counter``'s."""
    t = tokens // rows if per_row else tokens
    gs = _group_size(t)
    ng = tokens // gs
    cap = capacity(gs, n_experts, top_k, capacity_factor)
    buffered = ng * n_experts * cap          # expert rows computed
    router = 2 * tokens * d * n_experts
    combine = 2 * ng * gs * n_experts * cap * d
    dispatch = combine if gs > 1 else 0
    experts = 2 * buffered * d * ffn * (3 if swiglu else 2)
    return router + dispatch + combine + experts
