"""GPT as plain functions over a parameter dict (dense models).

Counterpart of ``mingpt_distributed_tpu/models/gpt.py`` with the same
parameter layout, so one converter (models/convert.py) maps the JAX pytree
onto it: ``{"wte", "wpe", "lnf_scale", "lnf_bias", "head", "blocks": {...}}``
where every block leaf is stacked on a leading n_layer axis and weights are
stored (in, out). Parameters are float32; activations run in ``cfg.dtype``;
normalisations, softmax and logits run in float32.

The trainer's loss-only mode (``return_logits=False``) runs the LM head and
the cross-entropy per sequence chunk under ``torch.utils.checkpoint``, so
the (B, T, V) float32 logits never exist; ``remat`` checkpoints every block.

Sequence parallelism (``attention`` "ring" or "ulysses" with a
``parallel.mesh.Mesh`` of sp > 1): each rank runs the forward on its chunk
of the sequence, chunk ``mesh.sp_rank``, so its positions (``wpe``, RoPE)
start at ``sp_rank * T_local``, which GSPMD does implicitly in the JAX
package; ``loss_terms`` returns the rank's token sum and count for the
trainer's global mean.

Parameter and tensor parallelism (a ``parallel.mesh.Mesh`` with fsdp or tp
above 1, whose ``shard_params`` made ``params`` this rank's slices): each
block gathers its layer's weights over fsdp just before it runs (under
``remat`` again in the backward), and ``wte``, ``wpe``, ``head`` and the
final norm are gathered whole. When ``mesh.tp_manual(cfg)`` the blocks run
the Megatron recipe, as the JAX package's manual-tp block does: each tp rank
holds ``n_head/tp`` query heads, ``kv_heads/tp`` KV heads and ``ffn/tp`` MLP
columns (wq, wk, wv, w_fc, w_gate and w_up column-parallel, wo, w_proj and
w_down row-parallel), attention runs on the local heads, and each residual
branch sums its partial outputs over tp once, before its output bias.
Otherwise tp gathers the weights whole and every tp rank computes alike.
Residual and embedding dropout draw the same masks on every tp rank (the
activations are replicated); attention dropout on a rank's own heads draws
its own (the tp rank mixed into its seed).

Mixture-of-experts blocks (``n_experts > 0``, ``ops/moe.py``) replace the
dense MLP with routed experts: the leaves ``w_router``, ``w_e1``, ``w_e2``
and, with SwiGLU, ``w_eg``; the loss adds ``moe_aux_weight * aux /
n_layer``, the per-layer sum of the Switch aux loss, as in the JAX package.
Across processes (dp, fsdp, ep and tp) the blocks route the global batch's
groups as JAX does (``moe.Exchange``: the ranks of distinct tokens, and the
expert exchange over ep); under Megatron tp each rank holds F/tp of every
expert. MoE beside sp raises (``check_supported``).

Pipeline stages (a mesh of pp > 1, ``parallel/pipeline.py``): ``params``
holds this stage's layers, and the forward, the loss and the training
step's backward run as the stage's schedule over microbatches
(``pipeline_terms``): stage 0 embeds, the last stage runs the final norm,
the head and the loss, and every stage's blocks run as above (gathered
over fsdp, Megatron tp, sp attention, the ep exchange). As in the JAX
pipeline's stage body, a microbatch's MoE layers route its tokens on their
own rank (the ep exchange still carries them to their experts), and the
aux loss is summed over the stages and averaged over the microbatches and
the batch shards. Dropout draws from one generator per microbatch and
stage, seeded from the rank's generator (which the trainer seeds from the
step and the data coordinate), the microbatch and the stage: microbatches
and data shards never share a mask, and both schedules draw the same.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.ops import attention as attn_ops
from mingpt_distributed_tpu_torch.ops import flash_attention
from mingpt_distributed_tpu_torch.ops import layers as L
from mingpt_distributed_tpu_torch.ops import moe
from mingpt_distributed_tpu_torch.parallel import distributed as D
from mingpt_distributed_tpu_torch.parallel import mesh as mesh_lib
from mingpt_distributed_tpu_torch.parallel import pipeline, ring_attention, ulysses

Params = Dict[str, Any]


def compute_dtype(cfg: GPTConfig) -> torch.dtype:
    dtype = getattr(torch, cfg.dtype, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    return dtype


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def param_spec(cfg: GPTConfig) -> Params:
    """Every parameter's (shape, init), init in {"normal", "resid", "ones",
    "zeros"}: the same tree ``mingpt_distributed_tpu.models.gpt.init``
    builds."""
    cfg.validate()
    d, nl, nh = cfg.n_embd, cfg.n_layer, cfg.n_head
    hd, kv = cfg.head_dim, cfg.kv_heads
    ffn = int(cfg.ffn_mult * d)
    use_bias = not (cfg.swiglu or cfg.rmsnorm)  # GPT-2 mode has biases everywhere

    blocks: Params = {
        "ln1_scale": ((nl, d), "ones"),
        "ln2_scale": ((nl, d), "ones"),
        "wq": ((nl, d, nh * hd), "normal"),
        "wk": ((nl, d, kv * hd), "normal"),
        "wv": ((nl, d, kv * hd), "normal"),
        "wo": ((nl, nh * hd, d), "resid"),
    }
    if not cfg.rmsnorm:
        blocks["ln1_bias"] = ((nl, d), "zeros")
        blocks["ln2_bias"] = ((nl, d), "zeros")
    if use_bias:
        blocks.update(bq=((nl, nh * hd), "zeros"), bk=((nl, kv * hd), "zeros"),
                      bv=((nl, kv * hd), "zeros"), bo=((nl, d), "zeros"))
    if cfg.n_experts:
        e = cfg.n_experts
        blocks.update(w_router=((nl, d, e), "normal"),
                      w_e1=((nl, e, d, ffn), "normal"),
                      w_e2=((nl, e, ffn, d), "resid"))
        if cfg.swiglu:  # Mixtral-style SwiGLU experts
            blocks["w_eg"] = ((nl, e, d, ffn), "normal")
    elif cfg.swiglu:
        blocks.update(w_gate=((nl, d, ffn), "normal"),
                      w_up=((nl, d, ffn), "normal"),
                      w_down=((nl, ffn, d), "resid"))
    else:
        blocks.update(w_fc=((nl, d, ffn), "normal"),
                      w_proj=((nl, ffn, d), "resid"))
        if use_bias:
            blocks.update(b_fc=((nl, ffn), "zeros"), b_proj=((nl, d), "zeros"))

    spec: Params = {
        "wte": ((cfg.vocab_size, d), "normal"),
        "blocks": blocks,
        "lnf_scale": ((d,), "ones"),
    }
    if not cfg.rope:
        spec["wpe"] = ((cfg.block_size, d), "zeros")
    if not cfg.rmsnorm:
        spec["lnf_bias"] = ((d,), "zeros")
    if not cfg.tie_weights:
        spec["head"] = ((d, cfg.vocab_size), "normal")
    return spec


def init(cfg: GPTConfig, generator: torch.Generator,
         device: Optional[torch.device] = None) -> Params:
    """Random parameters: weights N(0, 0.02), residual-path projections
    N(0, 0.02/sqrt(2L)), biases and ``wpe`` zero, norm scales one. Drawn
    on the generator's device in a fixed order, then moved to ``device``, so
    one seed gives the same weights on every device."""
    std = 0.02
    resid_std = 0.02 / math.sqrt(2 * cfg.n_layer)
    gen_device = generator.device

    def make(shape, kind):
        if kind == "ones":
            t = torch.ones(shape)
        elif kind == "zeros":
            t = torch.zeros(shape)
        else:
            s = std if kind == "normal" else resid_std
            t = torch.randn(shape, generator=generator, device=gen_device) * s
        return t.to(device or gen_device)

    spec = param_spec(cfg)
    params = {k: make(*v) for k, v in spec.items() if k != "blocks"}
    params["blocks"] = {k: make(*v) for k, v in spec["blocks"].items()}
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def check_supported(cfg: GPTConfig, mesh=None) -> None:
    """Raise for what this port does not run yet: mixture-of-experts blocks
    beside sequence parallelism (an sp rank's tokens interleave with the
    other sp ranks' in JAX's routing groups). ``mesh``: a
    ``parallel.mesh.Mesh`` or a dict of axis extents."""
    shape = getattr(mesh, "shape", mesh) or {}
    if cfg.n_experts and shape.get("sp", 1) > 1:
        raise NotImplementedError(
            "mixture-of-experts beside sp > 1 is not ported yet (ROADMAP.md "
            "Queue 1 item 12b.4)")


def check_pipeline(cfg: GPTConfig, mesh, seq_len: int) -> None:
    """The JAX pipeline's ValueErrors for a mesh of pp > 1 (``mesh``: a
    ``Mesh`` or a dict of extents) and a global sequence of ``seq_len``:
    layers that do not split over the stages, a sequence that does not
    split over sp, experts that do not split over ep, and Ulysses with a
    rank's heads not divisible by sp."""
    shape = getattr(mesh, "shape", mesh) or {}
    pp, sp, ep, tp = (shape.get(a, 1) for a in ("pp", "sp", "ep", "tp"))
    if pp <= 1:
        return
    mesh_lib.check_stages(cfg.n_layer, pp)
    seq_sharded = cfg.attention in ("ring", "ulysses") and sp > 1
    if seq_sharded and seq_len % sp:
        raise ValueError(f"T={seq_len} not divisible by sp={sp} under pp")
    if cfg.n_experts and ep > 1 and cfg.n_experts % ep:
        raise ValueError(f"n_experts={cfg.n_experts} not divisible by ep={ep}")
    if cfg.attention == "ulysses" and seq_sharded:
        local_heads = cfg.n_head // tp if mesh_lib.tp_manual(cfg, tp) else cfg.n_head
        if local_heads % sp:
            raise ValueError(f"ulysses needs (n_head/tp) % sp == 0 "
                             f"(got {local_heads} % {sp})")


def _moe_exchange(mesh) -> Optional["moe.Exchange"]:
    """The MoE layers' view of the mesh: the ranks of distinct tokens at
    this rank's tp coordinate, in batch order, and the expert exchange
    when the experts are split over ep. Under pp a microbatch's tokens are
    routed on their own rank, as in the JAX pipeline's stage body: only
    the expert exchange remains."""
    if mesh is None:
        return None
    ep_group = mesh.ep_group if mesh.ep_split("blocks/w_e1") else None
    if mesh.pp > 1:
        return None if ep_group is None else moe.Exchange(None, 0, 1, ep_group, mesh.ep)
    if mesh.batch_count <= 1:
        return None
    return moe.Exchange(mesh.batch_group, mesh.batch_index, mesh.batch_count,
                        ep_group, mesh.ep if ep_group is not None else 1)


def _attention_dispatch(cfg: GPTConfig, mesh=None) -> Callable[..., torch.Tensor]:
    """The attention implementation named by cfg.attention: "einsum" (the
    oracle), "flash" (the hand-written kernels), "ring" or "ulysses"
    (sequence parallel over ``mesh``; the oracle without one)."""
    sp = 1 if mesh is None else mesh.sp
    if cfg.attention == "ring":
        return functools.partial(ring_attention.ring_causal_attention, mesh=mesh)
    if cfg.attention == "ulysses":
        return functools.partial(ulysses.ulysses_causal_attention, mesh=mesh)
    if sp > 1:
        raise ValueError(f"attention={cfg.attention!r} sees only this rank's "
                         "chunk: a mesh with sp > 1 needs attention=ring or "
                         "ulysses")
    if cfg.attention == "einsum":
        return attn_ops.causal_attention
    return flash_attention.causal_attention


def _norm(x, scale, bias, cfg: GPTConfig):
    if cfg.rmsnorm:
        return L.rms_norm(x, scale, eps=cfg.norm_eps)
    return L.layer_norm(x, scale, bias, eps=cfg.norm_eps)


def _block(
    x: torch.Tensor,
    blk: Params,
    cfg: GPTConfig,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
    generator: Optional[torch.Generator],
    deterministic: bool,
    mesh=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One pre-LN transformer block: x + attn(ln1(x)); x + mlp(ln2(x)).
    Returns (x, the MoE aux loss, or None for a dense MLP). With a sharded
    ``mesh``, ``blk`` holds this rank's slices of the layer's weights: they
    are gathered here, and under ``mesh.tp_manual`` the block runs the
    Megatron recipe on this rank's heads and columns."""
    b, t, d = x.shape
    nh, kv, hd = cfg.n_head, cfg.kv_heads, cfg.head_dim
    tp_group = None
    if _sharded(mesh):
        manual = mesh.tp_manual(cfg)
        blk = {k: mesh.gather(f"blocks/{k}", v, keep_tp=manual, layer=True)
               for k, v in blk.items()}
        if manual:
            tp_group = mesh.tp_group
            nh, kv = nh // mesh.tp, kv // mesh.tp
    attn_gen = generator
    if tp_group is not None and generator is not None and not deterministic:
        attn_gen = torch.Generator(device=generator.device).manual_seed(
            D.mix_seed(D.dropout_base(generator), mesh.tp_rank))

    h = _norm(x, blk["ln1_scale"], blk.get("ln1_bias"), cfg)
    if tp_group is not None:
        h = D.copy_to_group(h, tp_group)
    q = L.dense(h, blk["wq"], blk.get("bq")).reshape(b, t, nh, hd)
    k = L.dense(h, blk["wk"], blk.get("bk")).reshape(b, t, kv, hd)
    v = L.dense(h, blk["wv"], blk.get("bv")).reshape(b, t, kv, hd)
    if rope is not None:
        cos, sin = rope
        q = attn_ops.apply_rope(q, cos, sin)
        k = attn_ops.apply_rope(k, cos, sin)
    attn_kw = {}
    if cfg.attention_window:
        attn_kw["window"] = cfg.attention_window
    if cfg.attn_logit_softcap:
        attn_kw["logit_softcap"] = cfg.attn_logit_softcap
    att = _attention_dispatch(cfg, mesh)(
        q, k, v,
        attn_pdrop=cfg.attn_pdrop,
        generator=attn_gen,
        deterministic=deterministic,
        **attn_kw,
    ).reshape(b, t, nh * hd)
    att = _row_parallel(att, blk["wo"], blk.get("bo"), tp_group)
    x = x + L.dropout(att, cfg.resid_pdrop, generator, deterministic)

    h2 = _norm(x, blk["ln2_scale"], blk.get("ln2_bias"), cfg)
    exchange = _moe_exchange(mesh) if cfg.n_experts else None
    m, aux = mlp(h2, blk, cfg, tp_group=tp_group, exchange=exchange)
    return x + L.dropout(m, cfg.resid_pdrop, generator, deterministic), aux


def _row_parallel(h, w, b, tp_group):
    """h @ w + b; under tensor parallelism h and w hold this rank's columns
    and rows, so the partial products are summed over tp before the bias
    (added once, not tp times)."""
    if tp_group is None:
        return L.dense(h, w, b)
    y = D.sum_from_group(L.dense(h, w), tp_group)
    return y if b is None else y + b.to(y.dtype)


def mlp(h: torch.Tensor, blk: Params, cfg: GPTConfig, per_row: bool = False,
        tp_group=None, exchange=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's MLP on ln2's output: routed experts (``per_row``: each
    batch row routed on its own; ``exchange``: the ranks of a job,
    ``moe.moe_mlp``), SwiGLU or GELU. Returns (out, the MoE aux loss, or
    None for a dense MLP). With ``tp_group`` the weights are this tp rank's
    columns and rows (``_row_parallel``; the experts' F/tp)."""
    if cfg.n_experts:
        return moe.moe_mlp(h, blk["w_router"], blk["w_e1"], blk["w_e2"],
                           top_k=cfg.moe_top_k,
                           capacity_factor=cfg.moe_capacity_factor,
                           w_gate=blk.get("w_eg"), per_row=per_row,
                           exchange=exchange, tp_group=tp_group)
    if tp_group is not None:
        h = D.copy_to_group(h, tp_group)
    if cfg.swiglu:
        inner = F.silu(L.dense(h, blk["w_gate"])) * L.dense(h, blk["w_up"])
        return _row_parallel(inner, blk["w_down"], None, tp_group), None
    inner = L.gelu(L.dense(h, blk["w_fc"], blk.get("b_fc")))
    return _row_parallel(inner, blk["w_proj"], blk.get("b_proj"), tp_group), None


def layer_params(params: Params, layer: int) -> Params:
    """One layer's slice of the stacked block leaves (views, no copies)."""
    return {name: w[layer] for name, w in params["blocks"].items()}


def _unstack(blocks: Params):
    """Every layer's parameters, from one ``unbind`` per stacked leaf: its
    backward writes each leaf's gradient once (a ``w[layer]`` per layer
    would add a full-size gradient per layer)."""
    names = list(blocks)
    for leaves in zip(*(blocks[n].unbind(0) for n in names)):
        yield dict(zip(names, leaves))


def _remat_block(x, blk, cfg, rope, generator, deterministic, mesh=None):
    """``_block`` under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward. The recomputation replays the block's
    dropout draws from ``generator``'s state at the block's start, then puts
    the generator back, so the masks match and the stream is undisturbed."""
    start = None if generator is None else generator.get_state()
    calls = []

    def run(x):
        replay = bool(calls) and start is not None
        calls.append(1)
        if replay:
            resume = generator.get_state()
            generator.set_state(start)
        try:
            return _block(x, blk, cfg, rope, generator, deterministic, mesh)
        finally:  # the recomputation may stop early by raising
            if replay:
                generator.set_state(resume)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


def head_logits(params: Params, x: torch.Tensor, cfg: GPTConfig,
                mesh=None) -> torch.Tensor:
    """LM head over (B, T, D) hidden states -> (B, T, V) float32 logits
    (``_head_matmul``), with the final softcap when configured: the one head
    of the forward, the chunked loss and decoding."""
    return attn_ops.softcap(_head_matmul(x, _head_weight(params, cfg, mesh)),
                            cfg.final_logit_softcap)


def _head_weight(params: Params, cfg: GPTConfig, mesh=None) -> torch.Tensor:
    if cfg.tie_weights:
        return _whole(params, "wte", mesh).t()
    return _whole(params, "head", mesh)


def _whole(params: Params, name: str, mesh) -> Optional[torch.Tensor]:
    """A top-level leaf, gathered whole from its slices under a sharded
    mesh (None when the config has no such leaf)."""
    leaf = params.get(name)
    if leaf is None or not _sharded(mesh):
        return leaf
    return mesh.gather(name, leaf)


def _sharded(mesh) -> bool:
    """Whether ``mesh`` splits the parameters (fsdp or tp above 1)."""
    return getattr(mesh, "sharded", False)


def forward(
    params: Params,
    tokens: torch.Tensor,  # (B, T) integer
    cfg: GPTConfig,
    *,
    targets: Optional[torch.Tensor] = None,  # (B, T), -1 = ignore
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    return_logits: bool = True,
    mesh=None,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Full forward pass -> (logits (B, T, V) float32, loss or None).

    The loss is the mean cross-entropy over targets != -1. Training mode
    (``deterministic=False``) draws its dropout masks from ``generator``.
    ``return_logits=False`` (the trainer's loss-only mode) returns
    ``(None, loss)`` and, when ``cfg.loss_chunks`` applies, never
    materialises the logits (``chunked_cross_entropy``). With a ``mesh`` of
    sp > 1, ``tokens`` is this rank's chunk of the sequence and everything
    returned is the chunk's; with pp > 1 the rows' logits and loss on every
    stage (``pipeline_terms``, forwards only).
    """
    if _pipelined(mesh):
        return _pipeline_forward(params, tokens, cfg, targets, generator,
                                 deterministic, return_logits, mesh)
    x, aux = _hidden(params, tokens, cfg, generator, deterministic, mesh)
    nc = _loss_chunks(cfg, tokens.shape[1])
    if targets is not None and not return_logits and nc > 1:
        loss = chunked_cross_entropy(x, _head_weight(params, cfg, mesh), targets, nc,
                                     softcap=cfg.final_logit_softcap)
        return None, _with_aux(loss, aux, cfg)
    logits = head_logits(params, x, cfg, mesh)
    loss = None
    if targets is not None:
        loss = _with_aux(cross_entropy(logits, targets), aux, cfg)
    return (logits if return_logits else None), loss


def _with_aux(loss: torch.Tensor, aux: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """The loss plus the per-layer mean of the MoE aux loss, weighted."""
    if not cfg.n_experts:
        return loss
    return loss + cfg.moe_aux_weight * aux / cfg.n_layer


def _hidden(params, tokens, cfg, generator, deterministic, mesh):
    """Embeddings, the blocks and the final norm -> ((B, T, D) hidden
    states, the blocks' summed MoE aux loss or None). Under sp > 1 the chunk's
    positions start at sp_rank * T."""
    check_supported(cfg, mesh)
    if not deterministic and generator is None:
        raise ValueError("training-mode forward needs a torch.Generator")
    pos0 = _pos0(cfg, mesh, tokens.shape[1])
    x = _embed(params, tokens, cfg, generator, deterministic, mesh, pos0)
    x, aux = _stack(params["blocks"], x, cfg, _rope(cfg, pos0, x), generator,
                    deterministic, mesh)
    return _final_norm(params, x, cfg, mesh), aux


def _pos0(cfg: GPTConfig, mesh, t: int) -> int:
    """The first position of these tokens: sp_rank * T under sp."""
    pos0 = 0 if mesh is None else mesh.sp_rank * t
    if pos0 + t > cfg.block_size:
        raise ValueError(f"positions up to {pos0 + t} > block_size "
                         f"{cfg.block_size}")
    return pos0


def _embed(params, tokens, cfg, generator, deterministic, mesh, pos0):
    """Token and position embeddings with their dropout, in the compute
    dtype."""
    t = tokens.shape[1]
    x = _whole(params, "wte", mesh)[tokens]  # (B, T, D) fp32 gather
    if not cfg.rope:
        x = x + _whole(params, "wpe", mesh)[pos0:pos0 + t]
    x = L.dropout(x, cfg.embd_pdrop, generator, deterministic)
    return x.to(compute_dtype(cfg))


def _rope(cfg, pos0, x):
    """The RoPE tables of positions pos0 .. pos0 + T of ``x`` (B, T, ...),
    or None."""
    if not cfg.rope:
        return None
    t = x.shape[1]
    return attn_ops.rope_tables(torch.arange(pos0, pos0 + t, device=x.device),
                                cfg.head_dim, cfg.rope_theta)


def _stack(blocks, x, cfg, rope, generator, deterministic, mesh):
    """The stacked layers of ``blocks`` in order -> (x, summed MoE aux or
    None)."""
    block = _remat_block if cfg.remat else _block
    aux = None
    for blk in _unstack(blocks):
        x, a = block(x, blk, cfg, rope, generator, deterministic, mesh)
        aux = a if aux is None else aux + a
    return x, aux


def _final_norm(params, x, cfg, mesh):
    return _norm(x, _whole(params, "lnf_scale", mesh), _whole(params, "lnf_bias", mesh),
                 cfg)


# ---------------------------------------------------------------------------
# Pipeline stages (pp > 1)
# ---------------------------------------------------------------------------


def _pipelined(mesh) -> bool:
    return getattr(mesh, "pp", 1) > 1


def pipeline_terms(
    params: Params,
    tokens: torch.Tensor,
    targets: Optional[torch.Tensor],
    cfg: GPTConfig,
    *,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    mesh,
    loss_scale: Optional[float] = None,
    aux_scale: float = 1.0,
    return_logits: bool = False,
):
    """This stage's schedule over its rows (``parallel/pipeline.py``) ->
    (total, aux, logits, stats).

    ``total``: the sum of the cross-entropy over the targets != -1 of these
    rows, on the last stage (0 on the others). ``aux``: this stage's share
    of the weighted MoE aux loss, ``moe_aux_weight * aux / n_layer`` with
    aux summed over the stage's layers and averaged over the microbatches
    and the batch shards (a sum over the stages and the batch shards gives
    the loss's term; 0 for a dense model). Both are detached.
    ``logits``: with ``return_logits``, the last stage's (B, T, V)
    float32 logits (None elsewhere). ``stats``: the ``PipelineStats``.

    With ``loss_scale`` every microbatch is backpropagated in the
    schedule: ``total_i * loss_scale`` on the last stage, and every stage's
    weighted aux times ``aux_scale`` beside its output; the parameters'
    ``.grad`` accumulate this stage's share. Without it only the forwards
    run."""
    check_supported(cfg, mesh)
    if not deterministic and generator is None:
        raise ValueError("training-mode forward needs a torch.Generator")
    b, t = tokens.shape
    check_pipeline(cfg, mesh, t * mesh.sp)
    backward = loss_scale is not None
    m = pipeline.microbatch_count(cfg.pp_microbatches, mesh.pp, b)
    pos0 = _pos0(cfg, mesh, t)
    rope = _rope(cfg, pos0, tokens)
    base = None if deterministic else D.dropout_base(generator)
    aux_w = (cfg.moe_aux_weight / (cfg.n_layer * m * mesh.batch_count)
             if cfg.n_experts else 0.0)
    ys = None if targets is None else targets.chunk(m)
    nc = _loss_chunks(cfg, t)
    totals: list = []
    auxes: list = []
    logits: list = []
    gens: Dict[int, Optional[torch.Generator]] = {}

    def gen(i):
        if base is None:
            return None
        if i not in gens:
            gens[i] = torch.Generator(device=generator.device).manual_seed(
                D.mix_seed(base, i, mesh.stage))
        return gens[i]

    def first(x_i, i):
        return _embed(params, x_i, cfg, gen(i), deterministic, mesh, pos0)

    def apply_stack(h, blocks, i):
        h, aux = _stack(blocks, h, cfg, rope, gen(i), deterministic, mesh)
        gens.pop(i, None)
        if aux is None:
            return h, None
        weighted = aux * aux_w
        auxes.append(weighted.detach())
        return h, (weighted * aux_scale if backward else None)

    def last(h, i):
        x = _final_norm(params, h, cfg, mesh)
        w = _head_weight(params, cfg, mesh)
        if return_logits:
            logits.append(head_logits(params, x, cfg, mesh).detach())
        if ys is None:
            return None
        if nc > 1:
            total = chunked_cross_entropy_sum(x, w, ys[i], nc,
                                              softcap=cfg.final_logit_softcap)
        else:
            total = _chunk_loss(x, w, ys[i], cfg.final_logit_softcap)
        totals.append(total.detach())
        return total * loss_scale if backward else None

    stats = pipeline.pipeline_blocks(
        tokens, params["blocks"], apply_stack, mesh, cfg.pp_microbatches,
        cfg.pp_schedule, first=first, last=last, act_shape=(b // m, t, cfg.n_embd),
        act_dtype=compute_dtype(cfg), backward=backward)
    zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
    total = torch.stack(totals).sum() if totals else zero
    aux = torch.stack(auxes).sum() if auxes else zero
    return total, aux, (torch.cat(logits) if logits else None), stats


def _pipeline_forward(params, tokens, cfg, targets, generator, deterministic,
                      return_logits, mesh):
    """``forward`` under pp: the forwards of the schedule; the logits are
    the last stage's, shared over pp (every stage returns them). The loss is
    the rows' mean cross-entropy plus the MoE term."""
    total, aux, logits, _ = pipeline_terms(
        params, tokens, targets, cfg, generator=generator, deterministic=deterministic,
        mesh=mesh, return_logits=True)
    b, t = tokens.shape
    if logits is None:
        logits = torch.zeros((b, t, cfg.vocab_size), dtype=torch.float32,
                             device=tokens.device)
    D.all_reduce(logits, mesh.pp_group)
    loss = None
    if targets is not None:
        count = (targets != -1).sum().clamp(min=1)
        stage_sum = torch.stack([total / count, aux])
        D.all_reduce(stage_sum, mesh.pp_group)
        loss = stage_sum[0]
        if cfg.n_experts:  # the aux term over the batch shards
            loss = loss + D.all_reduce(stage_sum[1:].clone(), mesh.batch_group)[0]
    return (logits if return_logits else None), loss


def _loss_chunks(cfg: GPTConfig, t: int) -> int:
    """The chunk count snaps to the largest divisor of T <= loss_chunks, so
    an awkward T gives fewer, larger chunks rather than the dense logits."""
    return max((d for d in range(1, cfg.loss_chunks + 1) if t % d == 0),
               default=1)


def loss_terms(
    params: Params,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    cfg: GPTConfig,
    *,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    mesh=None,
    with_aux: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """(sum of the cross-entropy over targets != -1, their count) of these
    tokens (this rank's rows and chunk), with the head and the softmax run
    per chunk as in the loss-only forward. A trainer divides the sums of
    both over the ranks. ``with_aux`` adds a third term: the MoE aux loss
    weighted as the loss takes it (``moe_aux_weight * aux / n_layer``, over
    every rank's tokens; 0 for a dense model), which each rank adds once.
    Under pp the forwards of the schedule run (no backward: an eval) and
    every stage returns the last stage's sum."""
    if _pipelined(mesh):
        total, aux, _, _ = pipeline_terms(params, tokens, targets, cfg, generator=generator,
                                          deterministic=deterministic, mesh=mesh)
        parts = torch.stack([total, aux])
        D.all_reduce(parts, mesh.pp_group)
        count = (targets != -1).sum()
        if not with_aux:
            return parts[0], count
        return parts[0], count, D.all_reduce(parts[1:].clone(), mesh.batch_group)[0]
    x, aux = _hidden(params, tokens, cfg, generator, deterministic, mesh)
    nc = _loss_chunks(cfg, tokens.shape[1])
    w = _head_weight(params, cfg, mesh)
    count = (targets != -1).sum()
    if nc > 1:
        total = chunked_cross_entropy_sum(x, w, targets, nc, softcap=cfg.final_logit_softcap)
    else:
        total = _chunk_loss(x, w, targets, cfg.final_logit_softcap)
    if not with_aux:
        return total, count
    extra = (cfg.moe_aux_weight * aux / cfg.n_layer if cfg.n_experts
             else total.new_zeros(()))
    return total, count, extra


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions with target != -1."""
    valid = targets != -1
    safe = torch.where(valid, targets, torch.zeros_like(targets))
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, safe[..., None].long())[..., 0]
    return -(ll * valid).sum() / valid.sum().clamp(min=1)


class _HeadMatmulF32Out(torch.autograd.Function):
    """x (N, D) in a 16-bit type times the float32 weight rounded to that
    type, with float32 output (cuBLAS sums the products in float32). The
    backward's products run in the 16-bit type; the weight gradient comes
    out in float32. ``torch.mm(..., out_dtype=)`` has no derivative."""

    @staticmethod
    def forward(ctx, x, w):
        wl = w.to(x.dtype)
        ctx.save_for_backward(x, wl)
        return torch.mm(x, wl, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, wl = ctx.saved_tensors
        gl = g.to(x.dtype)
        return gl @ wl.t(), torch.mm(x.t(), gl, out_dtype=torch.float32)


def _head_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., D) hidden states times the float32 (D, V) head weight rounded
    to x's dtype -> (..., V) float32 logits, products summed in float32."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        lead = x.shape[:-1]
        out = _HeadMatmulF32Out.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*lead, -1)
    return x.float() @ w.to(x.dtype).float()


def _chunk_loss(xc, w_head, tc, softcap):
    logits = attn_ops.softcap(_head_matmul(xc, w_head), softcap)
    valid = tc != -1
    safe = torch.where(valid, tc, torch.zeros_like(tc))
    lse = torch.logsumexp(logits, dim=-1)  # (B, c) float32
    s_t = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    return ((lse - s_t) * valid).sum()


def chunked_cross_entropy(
    x: torch.Tensor, w_head: torch.Tensor, targets: torch.Tensor,
    n_chunks: int, softcap: Optional[float] = None,
) -> torch.Tensor:
    """``chunked_cross_entropy_sum`` over the count of valid targets: the
    mean cross-entropy."""
    return (chunked_cross_entropy_sum(x, w_head, targets, n_chunks, softcap)
            / (targets != -1).sum().clamp(min=1))


def chunked_cross_entropy_sum(
    x: torch.Tensor, w_head: torch.Tensor, targets: torch.Tensor,
    n_chunks: int, softcap: Optional[float] = None,
) -> torch.Tensor:
    """The sum behind ``cross_entropy(head(x), targets)``, but the head matmul
    and the softmax run per sequence chunk under ``torch.utils.checkpoint``:
    at most one chunk's (B, T/n_chunks, V) float32 logits exist at a time,
    and the backward recomputes them. The per-chunk loss is
    ``sum(lse - logit_target)`` over valid targets (two reductions, no
    log-prob tensor). Counterpart of the JAX ``chunked_cross_entropy``,
    whose mean is ``chunked_cross_entropy``; this returns the sum."""
    b, t, _ = x.shape
    if t % n_chunks:
        raise ValueError(f"T={t} not divisible by n_chunks={n_chunks}")
    c = t // n_chunks
    total = x.new_zeros((), dtype=torch.float32)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(_chunk_loss, x[:, sl], w_head,
                                   targets[:, sl], softcap,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    return total


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------


def _leaves(params: Params):
    for v in params.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def param_count(params: Params) -> int:
    return sum(int(p.numel()) for p in _leaves(params))


def model_size_report(params: Params, cfg: GPTConfig) -> str:
    n = param_count(params)
    mb = sum(p.numel() * p.element_size() for p in _leaves(params)) / 2**20
    return (
        f"GPT: {cfg.n_layer}L/{cfg.n_head}H/{cfg.n_embd}d, "
        f"block {cfg.block_size}, vocab {cfg.vocab_size} — "
        f"{n/1e6:.2f}M params, {mb:.1f} MB (fp32 master)"
    )
