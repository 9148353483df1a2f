"""Ulysses attention: all-to-all sequence parallelism over the mesh's sp
group.

Counterpart of ``mingpt_distributed_tpu/parallel/ulysses.py``: an
all-to-all turns this rank's (B, c, H, hd) chunk of every head into the
whole sequence of H / sp heads, the port's ``flash_attention.
causal_attention`` (K1, K2a, K2b) runs on it, and a second all-to-all
restores the chunk. q, k and v travel in one all-to-all (stacked); k/v are
repeated over the GQA group first, as in JAX. A window and softcap compose
for free (every rank holds the full sequence of its heads). With attention
dropout the local call draws its mask from a generator seeded from one
draw of ``generator``, this rank's dp replica and its head group.

When ``n_head % sp != 0`` JAX falls back to the dense oracle on the global
arrays, which GSPMD gathers implicitly; here the gather is explicit: q, k
and v are all-gathered over the sp group (differentiably), the oracle runs
on the whole sequence, and the rank keeps its chunk's rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from mingpt_distributed_tpu_torch.ops import attention as attn_ops
from mingpt_distributed_tpu_torch.ops import flash_attention as fa
from mingpt_distributed_tpu_torch.parallel import distributed as D
from mingpt_distributed_tpu_torch.parallel.ring_attention import check_chunks


def _gathered_oracle(q, k, v, mesh, **kw) -> torch.Tensor:
    c = q.shape[1]
    full = [D.all_gather(x, mesh.sp_group, axis=1) for x in (q, k, v)]
    out = attn_ops.causal_attention(*full, **kw)
    return out[:, mesh.sp_rank * c:(mesh.sp_rank + 1) * c]


def ulysses_causal_attention(
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
    """All-to-all sequence-parallel causal attention of this rank's chunk
    -> (B, c, H, hd); the einsum oracle without a mesh or with sp == 1."""
    kw = dict(attn_pdrop=attn_pdrop, generator=generator,
              deterministic=deterministic, window=window,
              logit_softcap=logit_softcap)
    sp = 1 if mesh is None else mesh.sp
    if sp == 1:
        return attn_ops.causal_attention(q, k, v, kv_offset=kv_offset, **kw)
    check_chunks(q, k, kv_offset)
    h = q.shape[2]
    k = attn_ops.repeat_kv(k, h // k.shape[2])
    v = attn_ops.repeat_kv(v, h // v.shape[2])
    if h % sp:
        return _gathered_oracle(q, k, v, mesh, **kw)
    if not deterministic and attn_pdrop > 0.0:
        if generator is None:
            raise ValueError("attention dropout needs a torch.Generator")
        kw["generator"] = torch.Generator(device=q.device).manual_seed(
            D.mix_seed(D.dropout_base(generator), mesh.dp_rank, mesh.sp_rank))
    # sequence chunk of all heads -> whole sequence of h / sp heads
    qh, kh, vh = D.all_to_all(torch.stack([q, k, v]), mesh.sp_group,
                              split_axis=3, concat_axis=2).unbind(0)
    out = fa.causal_attention(qh, kh, vh, **kw)
    return D.all_to_all(out, mesh.sp_group, split_axis=1, concat_axis=2)
