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

Across processes (``exchange``, an ``Exchange`` the model builds from its
mesh): the ranks of distinct tokens hold the global (B, T) batch as a grid
of ``data_count / cols`` row blocks by ``cols`` column chunks (sequence
parallelism splits the columns); rank ``data_rank`` holds row block
``data_rank // cols`` and column chunk ``data_rank % cols``. The JAX
package routes the *global* batch under GSPMD, in groups of
``_group_size`` of the global token count taken in the flat order
b * T + t, so the groups, the capacity and each token's place in its
expert's buffer are global. A rank's tokens are **segments** of that
order: each of its rows' column chunk, or, with one column chunk, its
whole row block as one segment. Where every segment is whole groups,
routing them alone is exact. Otherwise each rank lays its tokens out in
the groups they belong to (zero rows elsewhere), and one all-gather of
every rank's per-(piece, choice, expert) counts (a piece: a segment's
part in one group) gives each token the count of the same group's
earlier pieces on every rank, and each choice the group's kept total
after the choices before it (``_route_groups``). The aux loss sums f and
P over the ranks before their product (``distributed.sum_from_group``,
whose backward keeps each rank's share).

Expert parallelism (``exchange.ep_group``: ``w_e1``, ``w_e2`` and ``w_eg``
hold this rank's ``E/ep`` experts, rank i the experts [i E/ep, (i+1) E/ep)
as ``PARAM_RULES`` lays them out): the expert inputs go to the ranks that
hold their experts with ``distributed.all_to_all`` (split 0, concat 1) and
the outputs come back with the inverse (split 1, concat 0), the JAX
layer's ``ep_axis`` exchange. Under tensor parallelism (``tp_group``) each
tp rank holds ``F/tp`` of every expert's hidden width: the router stays
replicated, the expert inputs and the combine weights enter the tp-split
part through ``copy_to_group`` (their gradients summed over tp) and the
combined outputs are summed over tp in float32 (``sum_from_group``).
"""

from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mingpt_distributed_tpu_torch.ops import layers as L
from mingpt_distributed_tpu_torch.parallel import distributed as D

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


class Exchange(NamedTuple):
    """A rank's tokens and experts in a job of processes."""

    data_group: Any       # the ranks of distinct tokens (this rank's tp coordinate)
    data_rank: int        # this rank's place there: row block * cols + column chunk
    data_count: int       # how many ranks of distinct tokens
    ep_group: Any = None  # the expert exchange (None: every expert here)
    ep: int = 1
    cols: int = 1         # column chunks of each row (sp)


def _segments(b: int, t: int, rank: int, cols: int) -> List[Tuple[int, int]]:
    """(global flat offset, length) of each run of rank ``rank``'s b x t
    tokens in the global (B, T) order, in the rank's own order."""
    block, col = divmod(rank, cols)
    if cols == 1:  # the row block's rows are adjacent: one segment
        return [(block * b * t, b * t)]
    width = t * cols
    return [((block * b + i) * width + col * t, t) for i in range(b)]


def _pieces(b: int, t: int, rank: int, cols: int, gs: int) -> List[Tuple[int, int, int]]:
    """Rank ``rank``'s segments cut at the group boundaries: (group, first
    place in the group, length), in the rank's own token order."""
    out = []
    for off, n in _segments(b, t, rank, cols):
        pos = off
        while pos < off + n:
            g = pos // gs
            end = min(off + n, (g + 1) * gs)
            out.append((g, pos - g * gs, end - pos))
            pos = end
    return out


class _Layout(NamedTuple):
    """Where a rank's tokens go when its groups are shared with other
    ranks: ``place`` (s,) each token's row in the (ng * gs) buffer of the
    groups it touches; ``piece`` (ng * gs,) each row's piece (-1: none);
    and the index lists that turn the gathered per-piece counts into
    ``marks`` (other ranks' earlier pieces, at their first place) and each
    group's ``totals``."""

    ng: int
    n_pieces: int
    place: torch.Tensor
    piece: torch.Tensor
    mark_src: torch.Tensor
    mark_dst: torch.Tensor
    total_src: torch.Tensor
    total_dst: torch.Tensor


def _layout(ex: Exchange, b: int, t: int, gs: int, device) -> _Layout:
    """The shared-group layout of this rank (see ``_Layout``), from every
    rank's pieces: each rank computes every rank's, so none is sent."""
    every = [_pieces(b, t, r, ex.cols, gs) for r in range(ex.data_count)]
    slots = [sorted({g for g, _, _ in ps}) for ps in every]
    ng = max(len(s) for s in slots)
    n_pieces = max(len(ps) for ps in every)
    mine = {g: i for i, g in enumerate(slots[ex.data_rank])}
    place, piece = [], [-1] * (ng * gs)
    for p, (g, first, n) in enumerate(every[ex.data_rank]):
        row = mine[g] * gs + first
        place.extend(range(row, row + n))
        piece[row:row + n] = [p] * n
    mark_src, mark_dst, total_src, total_dst = [], [], [], []
    for r, ps in enumerate(every):
        for p, (g, first, _) in enumerate(ps):
            if g not in mine:
                continue
            total_src.append(r * n_pieces + p)
            total_dst.append(mine[g])
            if r != ex.data_rank:
                mark_src.append(r * n_pieces + p)
                mark_dst.append(mine[g] * gs + first)
    as_t = lambda v: torch.tensor(v, dtype=torch.long, device=device)  # noqa: E731
    return _Layout(ng, n_pieces, as_t(place), as_t(piece), as_t(mark_src), as_t(mark_dst),
                   as_t(total_src), as_t(total_dst))


def capacity(gs: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    """Per-group, per-expert buffer length."""
    return max(1, math.ceil(top_k * gs / n_experts * capacity_factor))


def _route_groups(probs: torch.Tensor, top_k: int, cap: int,
                  valid: Optional[torch.Tensor] = None, counts_fn=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every group's dispatch and combine from (G, gs, E) float32 router
    probabilities: (dispatch (G, gs, E, cap), combine (G, gs, E, cap), the
    top-1 one-hot (G, gs, E)). The JAX ``_route_group``, vmapped. ``valid``
    (G, gs) marks this rank's rows of groups shared with other ranks;
    ``counts_fn(onehots)`` then gives, per choice, (G, gs, E) ``marks``
    (each other rank's piece's count at its first place in the group)
    and the group's (G, 1, E) total."""
    n_groups, _, e = probs.shape
    remaining = probs
    gates: List[torch.Tensor] = []
    onehots: List[torch.Tensor] = []
    for _ in range(top_k):
        oh = F.one_hot(remaining.argmax(dim=-1), e).to(probs.dtype)
        if valid is not None:
            oh = oh * valid[..., None]
        gates.append((probs * oh).sum(dim=-1))  # the true prob, not masked
        onehots.append(oh)
        remaining = remaining * (1.0 - oh)
    denom = sum(gates) if top_k > 1 else torch.ones_like(gates[0])
    slots = torch.arange(cap, device=probs.device, dtype=probs.dtype)
    counts = probs.new_zeros((n_groups, 1, e))
    marks = totals = None
    if counts_fn is not None:
        marks, totals = counts_fn(onehots)
    dispatch = combine = None
    for j, (g, oh) in enumerate(zip(gates, onehots)):
        # each token's place in its expert's buffer, after the tokens that
        # earlier choices (and earlier pieces of its group) placed there
        ahead = oh if marks is None else oh + marks[j]
        pos = counts + torch.cumsum(ahead, dim=1) - oh           # (G, gs, E)
        keep = oh * (pos < cap)
        if totals is None:
            counts = counts + keep.sum(dim=1, keepdim=True)
        else:  # what the whole group kept of this choice
            counts = torch.clamp(counts + totals[j], max=float(cap))
        sel = keep[..., None] * (pos[..., None] == slots)     # (G, gs, E, cap)
        part = sel * (g / torch.clamp(denom, min=1e-9))[..., None, None]
        dispatch = sel if dispatch is None else dispatch + sel
        combine = part if combine is None else combine + part
    return dispatch, combine, onehots[0]


def _shared_counts(ex: Exchange, lay: _Layout, gs: int):
    """``counts_fn`` for groups shared with other ranks: one all-gather,
    over the ranks of distinct tokens, of every rank's per-(piece, choice,
    expert) counts."""

    def counts_fn(onehots):
        k, e = len(onehots), onehots[0].shape[-1]
        flat = torch.stack(onehots).reshape(k, lay.ng * gs, e)
        local = flat.new_zeros((k, lay.n_pieces + 1, e)).index_add_(1, lay.piece + 1, flat)
        every = D.gather_tensor(local[None, :, 1:], ex.data_group, 0)  # (R, k, P, E)
        every = every.transpose(0, 1).reshape(k, -1, e)
        marks = flat.new_zeros((k, lay.ng * gs, e)).index_add_(
            1, lay.mark_dst, every[:, lay.mark_src])
        totals = flat.new_zeros((k, lay.ng, e)).index_add_(
            1, lay.total_dst, every[:, lay.total_src])
        return marks.reshape(k, lay.ng, gs, e), totals[:, :, None]

    return counts_fn


def moe_mlp(
    x: torch.Tensor,          # (B, T, D) post-norm activations
    w_router: torch.Tensor,   # (D, E)
    w_e1: torch.Tensor,       # (E/ep, D, F/tp)
    w_e2: torch.Tensor,       # (E/ep, F/tp, D)
    *,
    top_k: int = 2,
    capacity_factor: float = 1.25,
    w_gate: Optional[torch.Tensor] = None,  # (E/ep, D, F/tp): SwiGLU experts
    per_row: bool = False,
    exchange: Optional[Exchange] = None,
    tp_group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-routed MLP: GELU experts, or SwiGLU when ``w_gate`` is given
    (h = silu(x w_gate) * (x w_e1), Mixtral-style). Returns (out (B, T, D) in
    x's dtype, the aux loss as a float32 scalar). The router runs in
    float32; the expert products in x's dtype with the float32 weights cast
    to it, summed in float32 by the matmul; the combine in float32.
    ``exchange``: this rank's place among the ranks of a job (see the
    module's docstring); ``tp_group``: the expert weights hold this tp
    rank's F/tp columns and rows."""
    b, t, d = x.shape
    ex = exchange if exchange is not None and exchange.data_count > 1 else None
    if ex is not None and per_row:
        raise ValueError("per-row routing runs in one process")
    ep = exchange.ep if exchange is not None and exchange.ep_group is not None else 1
    e = w_e1.shape[0] * ep
    if w_router.shape[1] != e:
        raise ValueError(f"router has {w_router.shape[1]} experts, weights imply {e}")
    s = b * t
    count = 1 if ex is None else ex.data_count
    gs = _group_size(t if per_row else s * count)
    xs = x.reshape(s, d)
    valid = counts_fn = place = None
    if ex is not None and (t if ex.cols > 1 else s) % gs:
        # groups shared with other ranks: lay this rank's tokens out in theirs
        lay = _layout(ex, b, t, gs, x.device)
        xs = xs.new_zeros((lay.ng * gs, d)).index_copy(0, lay.place, xs)
        valid = (lay.piece >= 0).float().reshape(lay.ng, gs)
        counts_fn = _shared_counts(ex, lay, gs)
        place = lay.place
    ng = xs.shape[0] // gs
    xs = xs.reshape(ng, gs, d)

    probs = torch.softmax(xs.float() @ w_router.float(), dim=-1)  # (G, gs, E)
    cap = capacity(gs, e, top_k, capacity_factor)
    dispatch, combine, top1 = _route_groups(probs, top_k, cap, valid, counts_fn)

    # (G, gs, E*cap)^T x (G, gs, D) -> experts see (E, G*cap, D)
    expert_in = torch.einsum("gsc,gsd->gcd", dispatch.to(x.dtype).reshape(ng, gs, e * cap),
                             xs)
    expert_in = expert_in.reshape(ng, e, cap, d).transpose(0, 1).reshape(e, ng * cap, d)
    if tp_group is not None:
        expert_in = D.copy_to_group(expert_in, tp_group)
        combine = D.copy_to_group(combine, tp_group)
    if ep > 1:  # each rank gets its experts' rows from every rank
        expert_in = D.all_to_all(expert_in, exchange.ep_group, 0, 1)
    up = torch.bmm(expert_in, w_e1.to(x.dtype))
    if w_gate is not None:
        h = F.silu(torch.bmm(expert_in, w_gate.to(x.dtype)).float()) * up.float()
    else:
        h = L.gelu(up.float())
    expert_out = torch.bmm(h.to(x.dtype), w_e2.to(x.dtype)).float()  # (E/ep, ep*G*cap, D)
    if ep > 1:  # the outputs go back to the ranks whose tokens they are
        expert_out = D.all_to_all(expert_out, exchange.ep_group, 1, 0)
    expert_out = expert_out.reshape(e, ng, cap, d).transpose(0, 1).reshape(ng, e * cap, d)
    out = torch.bmm(combine.reshape(ng, gs, e * cap), expert_out)
    if tp_group is not None:
        out = D.sum_from_group(out, tp_group)
    out = out.to(x.dtype).reshape(ng * gs, d)
    if place is not None:
        out = out[place]

    # Switch load-balancing loss on the top-1 assignment, over all tokens
    if ex is None:
        f = top1.reshape(s, e).mean(dim=0)     # fraction routed per expert
        p = probs.reshape(s, e).mean(dim=0)    # mean router prob per expert
    else:  # f and P over every rank's tokens, then their product
        mask = 1.0 if valid is None else valid.reshape(-1, 1)
        fp = torch.stack([top1.reshape(-1, e).sum(0), (probs.reshape(-1, e) * mask).sum(0)])
        f, p = D.sum_from_group(fp, ex.data_group) / (s * count)
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
