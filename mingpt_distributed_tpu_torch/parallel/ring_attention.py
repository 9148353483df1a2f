"""Ring attention: sequence-parallel causal attention over the mesh's sp
ring.

Counterpart of ``mingpt_distributed_tpu/parallel/ring_attention.py``. There
a ``shard_map`` region runs the per-shard code on every device of the sp
axis; here each rank runs it on its own chunk, (B, c, H, hd) for q and
(B, c, KV, hd) for k/v (GQA by index in the kernels: the KV heads travel,
not their repeats), and K/V chunks move around the ring with the
differentiable ``distributed.ppermute``. Partial results merge exactly by
their log-sum-exp (``_fold``), with the K3/K4 kernels (``flash_with_lse``,
here ``flash_attention.attention_with_lse``) in every hop. The dispatch is
JAX's ``_ring_shard``:

* attention dropout: the float32 einsum ring, its masks drawn per global
  (q-chunk, k-chunk) pair (``pair_keep_mask``);
* a window: the banded ring, which runs only the hops that can meet the
  band (``t_live``): a fully in-band hop runs the non-causal kernel, a
  boundary hop the causal kernel with ``q_offset = t * c``;
* an even chunk: the zigzag ring: rank i holds the half-chunks (i,
  2n-1-i), three kernels at step 0, then one batch-stacked non-causal
  kernel per hop, 3 + (n - 1) K3 launches per call and as many K4a and
  K4b in the backward;
* otherwise the contiguous ring (n launches).

Differences from the JAX package, none of them faults: the kernels take any
chunk length, so JAX's "chunk must tile" fallback to the einsum ring does
not exist here; dropout masks come from ``torch.Generator``s, so they differ
from JAX's bits; and a hop whose result a rank folds with weight 0 is still
computed and folded, as in JAX, so that every rank runs the same
collectives in the backward (an unused ppermute output would leave its peer
waiting).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mingpt_distributed_tpu_torch.ops import attention as attn_ops
from mingpt_distributed_tpu_torch.ops import flash_attention as fa
from mingpt_distributed_tpu_torch.parallel import distributed as D

NEG_INF = -1e30


def _col(lse: torch.Tensor) -> torch.Tensor:
    """(B, H, c) lse -> (B, c, H, 1), to broadcast against (B, c, H, hd)."""
    return lse.transpose(1, 2).unsqueeze(-1)


def _start(o, lse):
    m = _col(lse)
    return m, torch.ones_like(m), o.float()


def _fold(state, o, lse_col):
    """Merge a partial result into the running (m, l, acc) by its lse."""
    m, l, acc = state
    m_new = torch.maximum(m, lse_col)
    alpha = torch.exp(m - m_new)
    w = torch.exp(lse_col - m_new)
    return m_new, l * alpha + w, acc * alpha + w * o.float()


def _finish(state, dtype):
    _, l, acc = state
    return (acc / l.clamp_min(1e-30)).to(dtype)


def _weight(lse_col, live: bool):
    """A chunk from the future folds with lse = NEG_INF: weight exactly 0."""
    return lse_col if live else torch.full_like(lse_col, NEG_INF)


def pair_keep_mask(base: int, dp_rank: int, pair: int, shape, pdrop: float,
                   device) -> torch.Tensor:
    """The keep mask of the global (q-chunk i, k-chunk j) pair, pair = i *
    n + j: a function of the pair id (and the dp replica), not of where the
    pair is computed."""
    g = torch.Generator(device=device).manual_seed(D.mix_seed(base, dp_rank, pair))
    return torch.rand(shape, generator=g, device=device) < 1.0 - pdrop


def _flash(q, k, v, scale, softcap, causal, window=None, q_offset=0):
    return fa.attention_with_lse(q, k, v, scale=scale, causal=causal,
                                 window=window, softcap=softcap,
                                 q_offset=q_offset)


def _ring_flash_banded(q, k, v, *, group, n, idx, scale, window, softcap):
    c = q.shape[1]
    state = _start(*_flash(q, k, v, scale, softcap, True, window))
    t_live = min(n - 1, (window + c - 2) // c)
    kc, vc = k, v
    for t in range(1, t_live + 1):
        kc, vc = D.ppermute([kc, vc], group, [D.shift_perm(n)] * 2)
        d = t * c
        if d + c - 1 < window:  # the whole pair is inside the band
            oi, lsei = _flash(q, kc, vc, scale, softcap, False)
        else:
            oi, lsei = _flash(q, kc, vc, scale, softcap, True, window, d)
        src = (idx - t) % n
        state = _fold(state, oi, _weight(_col(lsei), src < idx))
    return _finish(state, q.dtype)


def _ring_flash_zigzag(q, k, v, *, group, n, idx, scale, softcap):
    b, c = q.shape[:2]
    half = c // 2

    def owner(hc: int) -> int:
        return hc if hc < n else 2 * n - 1 - hc

    perm_even = [(i, owner(2 * i)) for i in range(n)]
    perm_odd = [(i, owner(2 * i + 1)) for i in range(n)]
    lo = [x[:, :half] for x in (q, k, v)]
    hi = [x[:, half:] for x in (q, k, v)]
    moved = D.ppermute(lo + hi, group, [perm_even] * 3 + [perm_odd] * 3)
    # this rank's pair {idx, 2n-1-idx} has one even member, sent by perm_even
    even_first = idx % 2 == 0
    (qe, ke, ve), (ql, kl, vl) = ((moved[:3], moved[3:]) if even_first
                                  else (moved[3:], moved[:3]))

    # step 0, the own pair: early x early and late x late are diagonal,
    # late x early is wholly past
    early = _start(*_flash(qe, ke, ve, scale, softcap, True))
    late = _start(*_flash(ql, kl, vl, scale, softcap, True))
    o, lse = _flash(ql, ke, ve, scale, softcap, False)
    late = _fold(late, o, _col(lse))
    for t in range(1, n):
        ke, kl, ve, vl = D.ppermute([ke, kl, ve, vl], group,
                                    [D.shift_perm(n)] * 4)
        past = (idx - t) % n < idx  # the pair now held comes from the past
        # two live half-blocks in one call: element a is q_early x k_early
        # (past) or q_late x k_early, element b q_late x k_early (past) or
        # q_late x k_late
        o2, lse2 = _flash(torch.cat([qe if past else ql, ql]),
                          torch.cat([ke, ke if past else kl]),
                          torch.cat([ve, ve if past else vl]),
                          scale, softcap, False)
        o_a, o_b, lse_a, lse_b = o2[:b], o2[b:], _col(lse2[:b]), _col(lse2[b:])
        if past:
            early = _fold(early, o_a, lse_a)
        late = _fold(late, o_b, lse_b)
        if not past:
            late = _fold(late, o_a, lse_a)
    out_e, out_l = _finish(early, q.dtype), _finish(late, q.dtype)
    even_out, odd_out = (out_e, out_l) if even_first else (out_l, out_e)
    inv_even = [(owner(2 * i), i) for i in range(n)]
    inv_odd = [(owner(2 * i + 1), i) for i in range(n)]
    lo_out, hi_out = D.ppermute([even_out, odd_out], group, [inv_even, inv_odd])
    return torch.cat([lo_out, hi_out], dim=1)


def _ring_flash(q, k, v, *, group, n, idx, scale, softcap):
    state = _start(*_flash(q, k, v, scale, softcap, True))
    kc, vc = k, v
    for i in range(1, n):
        kc, vc = D.ppermute([kc, vc], group, [D.shift_perm(n)] * 2)
        oi, lsei = _flash(q, kc, vc, scale, softcap, False)
        state = _fold(state, oi, _weight(_col(lsei), (idx - i) % n < idx))
    return _finish(state, q.dtype)


def _ring_einsum(q, k, v, *, group, n, idx, scale, window, softcap, pdrop,
                 generator, dp_rank):
    b, c, h, hd = q.shape
    rep = h // k.shape[2]
    qf = q.float() * scale
    q_pos = idx * c + torch.arange(c, device=q.device)[:, None]
    k_local = torch.arange(c, device=q.device)[None, :]
    base = D.dropout_base(generator) if pdrop > 0.0 else None

    def fold(m, l, acc, kc, vc, i):
        src = (idx - i) % n
        kf = attn_ops.repeat_kv(kc, rep).float()
        vf = attn_ops.repeat_kv(vc, rep).float()
        s = attn_ops.softcap(torch.einsum("bthd,bshd->bhts", qf, kf), softcap)
        k_pos = src * c + k_local
        ok = q_pos >= k_pos
        if window is not None:
            ok = ok & (q_pos - k_pos < window)
        s = torch.where(ok, s, torch.full((), NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        # dropout(softmax(s)) @ v: the mask scales the accumulator only
        if base is not None:
            keep = pair_keep_mask(base, dp_rank, idx * n + src, p.shape,
                                  pdrop, q.device)
            p = torch.where(keep, p, torch.zeros((), device=q.device)) / (1.0 - pdrop)
        acc = acc * alpha + torch.einsum("bhts,bshd->bhtd", p, vf)
        return m_new, l, acc

    m = torch.full((b, h, c, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, c, 1), device=q.device)
    acc = torch.zeros((b, h, c, hd), device=q.device)
    kc, vc = k, v
    for i in range(n - 1):
        m, l, acc = fold(m, l, acc, kc, vc, i)
        kc, vc = D.ppermute([kc, vc], group, [D.shift_perm(n)] * 2)
    m, l, acc = fold(m, l, acc, kc, vc, n - 1)
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def check_chunks(q: torch.Tensor, k: torch.Tensor, kv_offset) -> None:
    """Under sp > 1 the inputs are this rank's chunks of one sequence."""
    if q.shape[1] != k.shape[1] or not isinstance(kv_offset, int) or kv_offset:
        raise ValueError(
            "sequence-parallel attention takes this rank's q/k/v chunks of one "
            f"sequence: q {tuple(q.shape)}, k {tuple(k.shape)}, kv_offset "
            f"{kv_offset!r} (decoding runs without a mesh)")


def ring_causal_attention(
    q: torch.Tensor,  # (B, c, H, hd): this rank's chunk
    k: torch.Tensor,  # (B, c, KV, hd)
    v: torch.Tensor,
    mesh,
    *,
    attn_pdrop: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    kv_offset=0,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Sequence-parallel causal attention of this rank's chunk (chunk
    ``mesh.sp_rank`` of the sequence) -> (B, c, H, hd). Without a mesh or
    with sp == 1 it is the einsum oracle on the tensors given, as in the
    JAX package. Attention dropout draws its masks per (q-chunk, k-chunk)
    pair from a seed drawn from ``generator``."""
    sp = 1 if mesh is None else mesh.sp
    drop = not deterministic and attn_pdrop > 0.0
    if sp == 1:
        return attn_ops.causal_attention(
            q, k, v, attn_pdrop=attn_pdrop, generator=generator,
            deterministic=deterministic, kv_offset=kv_offset, window=window,
            logit_softcap=logit_softcap)
    check_chunks(q, k, kv_offset)
    if drop and generator is None:
        raise ValueError("attention dropout needs a torch.Generator")
    kw = dict(group=mesh.sp_group, n=sp, idx=mesh.sp_rank,
              scale=1.0 / math.sqrt(q.shape[3]),
              softcap=None if logit_softcap is None else float(logit_softcap))
    window = None if window is None else int(window)
    if drop:
        return _ring_einsum(q, k, v, window=window, pdrop=attn_pdrop,
                            generator=generator, dp_rank=mesh.dp_rank, **kw)
    if window is not None:
        return _ring_flash_banded(q, k, v, window=window, **kw)
    if q.shape[1] % 2 == 0:
        return _ring_flash_zigzag(q, k, v, **kw)
    return _ring_flash(q, k, v, **kw)
