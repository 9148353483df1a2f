"""Autoregressive generation: KV-cached decode and the sliding window.

Counterpart of ``mingpt_distributed_tpu/models/generate.py``, with the same
contract and the same two modes, switched on the same condition:

* prompt + new tokens fit ``block_size``: prefill the prompt into a
  preallocated ``(L, B, block_size, KV, hd)`` cache, then decode one token
  at a time against it (attention through the oracle with ``kv_offset``,
  as in the JAX package: no kernel runs in this mode);
* otherwise: the reference's sliding window. Every step forwards the whole
  left-aligned ``(B, block_size)`` window with positions 0..len-1 through
  ``gpt.forward`` (so the flash kernel runs in every layer when
  ``attention="flash"``), reads the logits at ``length - 1`` and rolls the
  window once it is full.

PyTorch runs eagerly, so both modes are Python loops. Only greedy decoding
can be token-exact against the JAX package: ``jax.random`` and
``torch.Generator`` draw different numbers.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models import gpt
from mingpt_distributed_tpu_torch.ops import attention as attn_ops
from mingpt_distributed_tpu_torch.ops import layers as L
from mingpt_distributed_tpu_torch.utils.device import Device, resolve_device

Cache = Dict[str, torch.Tensor]  # {"k","v"}: (n_layer, B, block_size, KV, hd)


def init_cache(cfg: GPTConfig, batch: int, device: torch.device,
               dtype: Optional[torch.dtype] = None) -> Cache:
    shape = (cfg.n_layer, batch, cfg.block_size, cfg.kv_heads, cfg.head_dim)
    dtype = dtype or gpt.compute_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cached_block(
    x: torch.Tensor,      # (B, T, D): T = prompt length or 1
    blk: gpt.Params,      # one layer's params (no leading L axis)
    cache: Cache,         # FULL (L, B, S, KV, hd) buffers, written here
    layer: int,
    offset: int,          # absolute position of x[:, 0]
    cfg: GPTConfig,
) -> torch.Tensor:
    """One pre-LN block that writes this call's k/v into the cache at
    (layer, :, offset) and attends against the layer's cache slice.

    The cache is written IN PLACE. The JAX code returns an updated cache
    and relies on XLA aliasing its dynamic_update_slice into the old
    buffer; here the aliasing is explicit, so callers must not expect the
    cache they passed in to stay unchanged.
    """
    b, t, _ = x.shape
    nh, kv, hd = cfg.n_head, cfg.kv_heads, cfg.head_dim

    h = gpt._norm(x, blk["ln1_scale"], blk.get("ln1_bias"), cfg)
    q = L.dense(h, blk["wq"], blk.get("bq")).reshape(b, t, nh, hd)
    k = L.dense(h, blk["wk"], blk.get("bk")).reshape(b, t, kv, hd)
    v = L.dense(h, blk["wv"], blk.get("bv")).reshape(b, t, kv, hd)
    if cfg.rope:
        cos, sin = attn_ops.rope_tables(
            offset + torch.arange(t, device=x.device), hd, cfg.rope_theta)
        q = attn_ops.apply_rope(q, cos, sin)
        k = attn_ops.apply_rope(k, cos, sin)

    cache["k"][layer, :, offset:offset + t] = k.to(cache["k"].dtype)
    cache["v"][layer, :, offset:offset + t] = v.to(cache["v"].dtype)
    # attend against the whole cache slice: kv_offset makes the query
    # positions absolute, and the causal mask hides both future tokens and
    # never-written slots past offset + t
    att = attn_ops.causal_attention(
        q, cache["k"][layer], cache["v"][layer], kv_offset=offset,
        window=cfg.attention_window, logit_softcap=cfg.attn_logit_softcap,
    ).reshape(b, t, nh * hd)
    x = x + L.dense(att, blk["wo"], blk.get("bo"))

    h2 = gpt._norm(x, blk["ln2_scale"], blk.get("ln2_bias"), cfg)
    if cfg.swiglu:
        m = L.mlp_swiglu(h2, blk["w_gate"], blk["w_up"], blk["w_down"])
    else:
        m = L.mlp_gelu(h2, blk["w_fc"], blk.get("b_fc"), blk["w_proj"],
                       blk.get("b_proj"))
    return x + m


def _forward_cached_hidden(params: gpt.Params, tokens: torch.Tensor,
                           cache: Cache, offset: int, cfg: GPTConfig
                           ) -> torch.Tensor:
    """Forward (B, T) tokens at absolute position ``offset`` through all
    layers, writing the cache. Returns the final-norm hidden states."""
    t = tokens.shape[1]
    x = params["wte"][tokens]
    if not cfg.rope:
        x = x + params["wpe"][offset:offset + t]
    x = x.to(gpt.compute_dtype(cfg))
    for layer in range(cfg.n_layer):
        x = _cached_block(x, gpt.layer_params(params, layer), cache, layer,
                          offset, cfg)
    return gpt._norm(x, params["lnf_scale"], params.get("lnf_bias"), cfg)


# LM head over (B, t, D) hidden states -> (B, t, V) float32 logits; one
# function serves gpt.forward and decoding (the JAX package's _head_logits)
_head_logits = gpt.head_logits


def _forward_cached(params: gpt.Params, tokens: torch.Tensor, cache: Cache,
                    offset: int, cfg: GPTConfig) -> torch.Tensor:
    """Forward (B, T) tokens at ``offset``; last-position logits (B, V)."""
    x = _forward_cached_hidden(params, tokens, cache, offset, cfg)
    return _head_logits(params, x[:, -1:], cfg)[:, 0]


def _filter_logits(logits: torch.Tensor, temperature: float,
                   top_k: Optional[int], top_p: Optional[float]
                   ) -> torch.Tensor:
    """Temperature, then top-k and top-p filtering (filtered tokens get
    -inf): the JAX package's ``_select_next`` up to the draw."""
    logits = logits / max(temperature, 1e-8)
    neg_inf = torch.full((), float("-inf"), device=logits.device)
    if top_k is not None:
        k = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)  # keeps ties
    if top_p is not None and top_p < 1.0:
        desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose preceding cumulative mass is < top_p; the top
        # token always survives, so top_p -> 0 degenerates to greedy
        keep = (cum - probs) < top_p
        keep[..., 0] = True
        kth = torch.where(keep, desc, torch.full((), float("inf"),
                                                 device=logits.device))
        kth = kth.min(dim=-1, keepdim=True).values
        logits = torch.where(logits < kth, neg_inf, logits)
    return logits


def _select_next(
    logits: torch.Tensor, generator: Optional[torch.Generator],
    temperature: float, do_sample: bool, top_k: Optional[int],
    top_p: Optional[float] = None,
) -> torch.Tensor:
    """Filter (``_filter_logits``), then sample or argmax: (B, V) -> (B,)."""
    logits = _filter_logits(logits, temperature, top_k, top_p)
    if do_sample:
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


def _generate_cached(params, idx, generator, cfg, max_new_tokens,
                     temperature, do_sample, top_k, top_p) -> torch.Tensor:
    b, t0 = idx.shape
    cache = init_cache(cfg, b, idx.device)
    logits = _forward_cached(params, idx, cache, 0, cfg)
    tok = _select_next(logits, generator, temperature, do_sample, top_k, top_p)
    new = [tok]
    for pos in range(t0, t0 + max_new_tokens - 1):
        logits = _forward_cached(params, tok[:, None], cache, pos, cfg)
        tok = _select_next(logits, generator, temperature, do_sample, top_k,
                           top_p)
        new.append(tok)
    return torch.cat([idx, torch.stack(new, dim=1)], dim=1)


def _generate_sliding(params, idx, generator, cfg, max_new_tokens,
                      temperature, do_sample, top_k, top_p) -> torch.Tensor:
    """Every step forwards the (B, block_size) window, left-aligned; causal
    masking hides the unwritten tail from the read-out position. Returns
    only the (B, max_new_tokens) new tokens."""
    b, t0 = idx.shape  # t0 <= block_size (the caller crops)
    bs = cfg.block_size
    window = torch.zeros((b, bs), dtype=idx.dtype, device=idx.device)
    window[:, :t0] = idx
    length = t0
    new = []
    for _ in range(max_new_tokens):
        logits_all, _ = gpt.forward(params, window, cfg)
        nxt = _select_next(logits_all[:, length - 1], generator, temperature,
                           do_sample, top_k, top_p).to(window.dtype)
        if length >= bs:
            window = torch.roll(window, -1, dims=1)
            window[:, bs - 1] = nxt
        else:
            window[:, length] = nxt
            length += 1
        new.append(nxt)
    return torch.stack(new, dim=1)


@torch.no_grad()
def generate(
    params: gpt.Params,
    cfg: GPTConfig,
    idx,
    max_new_tokens: int,
    temperature: float = 1.0,
    do_sample: bool = False,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    device: Optional[Device] = None,
) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``idx`` (B, T0) or (T0,).

    Runs on ``device`` (cuda unless the caller asks for the CPU), where the
    params must already live. Sampling draws from ``generator`` (a fresh
    one seeded 0 when None).
    """
    dev = resolve_device(device)
    if params["wte"].device.type != dev.type:
        raise ValueError(
            f"params live on {params['wte'].device}, generation asked for {dev}")
    idx = torch.as_tensor(idx, dtype=torch.long, device=params["wte"].device)
    if idx.dim() == 1:
        idx = idx[None]
    if max_new_tokens < 1:
        return idx
    if generator is None:
        generator = torch.Generator(device=idx.device).manual_seed(0)
    args = (cfg, max_new_tokens, float(temperature), bool(do_sample),
            None if top_k is None else int(top_k),
            None if top_p is None else float(top_p))
    if idx.shape[1] + max_new_tokens <= cfg.block_size:
        # fits the window: KV-cached path (positions never slide)
        return _generate_cached(params, idx, generator, *args)
    # overflow: sliding window over the last block_size tokens; the full
    # prompt still heads the returned sequence
    new = _generate_sliding(params, idx[:, -cfg.block_size:], generator, *args)
    return torch.cat([idx, new], dim=1)
