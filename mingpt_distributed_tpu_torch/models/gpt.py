"""GPT as plain functions over a parameter dict (dense models).

Counterpart of ``mingpt_distributed_tpu/models/gpt.py`` with the same
parameter layout, so one converter (models/convert.py) maps the JAX pytree
onto it: ``{"wte", "wpe", "lnf_scale", "lnf_bias", "head", "blocks": {...}}``
where every block leaf is stacked on a leading n_layer axis and weights are
stored (in, out). Parameters are float32; activations run in ``cfg.dtype``;
normalisations, softmax and logits run in float32.

Not in this slice: mixture-of-experts blocks, rematerialisation and the
pipeline/mesh paths (ring and Ulysses attention) raise NotImplementedError
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.ops import attention as attn_ops
from mingpt_distributed_tpu_torch.ops import flash_attention
from mingpt_distributed_tpu_torch.ops import layers as L

Params = Dict[str, Any]


def compute_dtype(cfg: GPTConfig) -> torch.dtype:
    dtype = getattr(torch, cfg.dtype, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    return dtype


def check_supported(cfg: GPTConfig) -> None:
    """Raise for the configurations this slice does not run yet."""
    if cfg.n_experts:
        raise NotImplementedError(
            "mixture-of-experts blocks are not ported yet (ROADMAP.md Queue 1)")
    if cfg.remat:
        raise NotImplementedError(
            "remat is a training-slice option, not ported yet (ROADMAP.md Queue 1)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def param_spec(cfg: GPTConfig) -> Params:
    """Every parameter's (shape, init), init in {"normal", "resid", "ones",
    "zeros"}: the same tree ``mingpt_distributed_tpu.models.gpt.init``
    builds."""
    cfg.validate()
    check_supported(cfg)
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
    if cfg.swiglu:
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


def _attention_dispatch(cfg: GPTConfig) -> Callable[..., torch.Tensor]:
    """The attention implementation named by cfg.attention: "einsum" (the
    oracle) or "flash" (the hand-written kernel)."""
    if cfg.attention == "einsum":
        return attn_ops.causal_attention
    if cfg.attention == "flash":
        return flash_attention.causal_attention
    raise NotImplementedError(
        f"attention={cfg.attention!r} (sequence parallel) is not ported yet "
        "(ROADMAP.md Queue 1, multi-GPU slice)")


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
) -> torch.Tensor:
    """One pre-LN transformer block: x + attn(ln1(x)); x + mlp(ln2(x))."""
    b, t, d = x.shape
    nh, kv, hd = cfg.n_head, cfg.kv_heads, cfg.head_dim

    h = _norm(x, blk["ln1_scale"], blk.get("ln1_bias"), cfg)
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
    att = _attention_dispatch(cfg)(
        q, k, v,
        attn_pdrop=cfg.attn_pdrop,
        generator=generator,
        deterministic=deterministic,
        **attn_kw,
    ).reshape(b, t, nh * hd)
    att = L.dense(att, blk["wo"], blk.get("bo"))
    x = x + L.dropout(att, cfg.resid_pdrop, generator, deterministic)

    h2 = _norm(x, blk["ln2_scale"], blk.get("ln2_bias"), cfg)
    if cfg.swiglu:
        m = L.mlp_swiglu(h2, blk["w_gate"], blk["w_up"], blk["w_down"])
    else:
        m = L.mlp_gelu(h2, blk["w_fc"], blk.get("b_fc"), blk["w_proj"],
                       blk.get("b_proj"))
    return x + L.dropout(m, cfg.resid_pdrop, generator, deterministic)


def layer_params(params: Params, layer: int) -> Params:
    """One layer's slice of the stacked block leaves (views, no copies)."""
    return {name: w[layer] for name, w in params["blocks"].items()}


def head_logits(params: Params, x: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """LM head over (B, T, D) hidden states -> (B, T, V) float32 logits: the
    weight is rounded to x's dtype and the products summed in float32, with
    the final softcap when configured (``generate._head_logits`` too)."""
    w_head = params["wte"].t() if cfg.tie_weights else params["head"]
    logits = x.float() @ w_head.to(x.dtype).float()
    return attn_ops.softcap(logits, cfg.final_logit_softcap)


def forward(
    params: Params,
    tokens: torch.Tensor,  # (B, T) integer
    cfg: GPTConfig,
    *,
    targets: Optional[torch.Tensor] = None,  # (B, T), -1 = ignore
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full forward pass -> (logits (B, T, V) float32, loss or None).

    The loss is the mean cross-entropy over targets != -1. Training mode
    (``deterministic=False``) draws its dropout masks from ``generator``.
    """
    check_supported(cfg)
    b, t = tokens.shape
    if t > cfg.block_size:
        raise ValueError(f"sequence length {t} > block_size {cfg.block_size}")
    if not deterministic and generator is None:
        raise ValueError("training-mode forward needs a torch.Generator")

    x = params["wte"][tokens]  # (B, T, D) fp32 gather
    if not cfg.rope:
        x = x + params["wpe"][:t]
    x = L.dropout(x, cfg.embd_pdrop, generator, deterministic)
    x = x.to(compute_dtype(cfg))

    rope = None
    if cfg.rope:
        rope = attn_ops.rope_tables(torch.arange(t, device=x.device),
                                    cfg.head_dim, cfg.rope_theta)
    for layer in range(cfg.n_layer):
        x = _block(x, layer_params(params, layer), cfg, rope, generator,
                   deterministic)

    x = _norm(x, params["lnf_scale"], params.get("lnf_bias"), cfg)
    logits = head_logits(params, x, cfg)
    loss = cross_entropy(logits, targets) if targets is not None else None
    return logits, loss


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions with target != -1."""
    valid = targets != -1
    safe = torch.where(valid, targets, torch.zeros_like(targets))
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, safe[..., None].long())[..., 0]
    return -(ll * valid).sum() / valid.sum().clamp(min=1)


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
