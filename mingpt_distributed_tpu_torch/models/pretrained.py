"""from_pretrained: HuggingFace GPT-2 and Llama weights as the port's tree.

Counterpart of ``mingpt_distributed_tpu/models/pretrained.py``. The loaders
map a HuggingFace state dict onto the parameter tree both packages share
(numpy arrays, stacked on a leading layer axis, weights stored (in, out));
``models/convert.params_from_numpy`` turns it into the port's tensors on a
device. What the GPT-2 mapping encodes:

* HF GPT-2's Conv1D stores its weight (in_features, out_features), the
  tree's convention already, so **no transposes** (nn.Linear-based code,
  upstream minGPT's, must transpose; this must not);
* ``c_attn`` fuses Q/K/V along the output axis: split into wq/wk/wv;
* per-layer tensors stack on a leading layer axis;
* GPT-2 ties lm_head to wte: ``tie_weights=True`` and no "head" leaf;
* the activation is gelu_new (the tanh approximation), ``ops/layers.gelu``.

Llama's nn.Linear stores (out, in), so every projection transposes there;
RMSNorm scales and the embedding map straight across; rotary tables are
computed, not stored.

``load_hf_state_dict`` and ``load_hf_llama_state_dict`` are pure (dict ->
tree) and tested against small random ``transformers`` models built
locally; ``from_pretrained`` wraps the first with transformers' hub cache
(needs the network or a populated HF cache, and raises RuntimeError
otherwise).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

from mingpt_distributed_tpu_torch.config import ConfigError, GPTConfig

Params = Dict[str, Any]

# upstream minGPT's supported set
PRETRAINED_MODELS = ("gpt2", "gpt2-medium", "gpt2-large", "gpt2-xl")


def config_for_pretrained(model_type: str, **overrides: Any) -> GPTConfig:
    """The preset's config with the head tied to wte, as the checkpoints
    are."""
    if model_type not in PRETRAINED_MODELS:
        raise ConfigError(
            f"from_pretrained supports {PRETRAINED_MODELS}, got {model_type!r}")
    base = dict(model_type=model_type, tie_weights=True)
    base.update(overrides)
    return GPTConfig.make(**base)


def _get(sd: Mapping[str, Any], key: str) -> np.ndarray:
    if key not in sd:
        raise KeyError(f"HF state dict missing {key!r}")
    v = sd[key]
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)


def _f32(tree: Mapping[str, Any]) -> Params:
    return {k: np.asarray(v, dtype=np.float32) for k, v in tree.items()}


def load_hf_state_dict(sd: Mapping[str, Any], cfg: GPTConfig) -> Params:
    """A GPT2LMHeadModel state dict -> the parameter tree (float32 numpy)."""
    prefix = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    d, nl = cfg.n_embd, cfg.n_layer

    wte = _get(sd, f"{prefix}wte.weight")
    wpe = _get(sd, f"{prefix}wpe.weight")
    if wte.shape != (cfg.vocab_size, d) or wpe.shape[1] != d:
        raise ValueError(
            f"state dict shapes {wte.shape}/{wpe.shape} do not match config "
            f"({cfg.vocab_size}, {d})")
    if wpe.shape[0] < cfg.block_size:
        raise ValueError(
            f"checkpoint supports {wpe.shape[0]} positions < block_size "
            f"{cfg.block_size}")

    def stack(fmt: str) -> np.ndarray:
        return np.stack([_get(sd, prefix + fmt.format(i)) for i in range(nl)])

    wq, wk, wv = np.split(stack("h.{}.attn.c_attn.weight"), 3, axis=2)  # (L, D, 3D)
    bq, bk, bv = np.split(stack("h.{}.attn.c_attn.bias"), 3, axis=1)    # (L, 3D)
    blocks = {
        "ln1_scale": stack("h.{}.ln_1.weight"),
        "ln1_bias": stack("h.{}.ln_1.bias"),
        "wq": wq, "wk": wk, "wv": wv,
        "bq": bq, "bk": bk, "bv": bv,
        "wo": stack("h.{}.attn.c_proj.weight"),
        "bo": stack("h.{}.attn.c_proj.bias"),
        "ln2_scale": stack("h.{}.ln_2.weight"),
        "ln2_bias": stack("h.{}.ln_2.bias"),
        "w_fc": stack("h.{}.mlp.c_fc.weight"),
        "b_fc": stack("h.{}.mlp.c_fc.bias"),
        "w_proj": stack("h.{}.mlp.c_proj.weight"),
        "b_proj": stack("h.{}.mlp.c_proj.bias"),
    }
    params: Params = _f32({
        "wte": wte,
        "wpe": wpe[:cfg.block_size],
        "lnf_scale": _get(sd, f"{prefix}ln_f.weight"),
        "lnf_bias": _get(sd, f"{prefix}ln_f.bias"),
    })
    params["blocks"] = _f32(blocks)
    if not cfg.tie_weights:
        # untied variant: materialise the head from lm_head (or the tied wte)
        head = _get(sd, "lm_head.weight") if "lm_head.weight" in sd else params["wte"]
        params["head"] = np.asarray(head, dtype=np.float32).T.copy()
    return params


def load_hf_llama_state_dict(sd: Mapping[str, Any], cfg: GPTConfig) -> Params:
    """A LlamaForCausalLM state dict -> the parameter tree (float32 numpy);
    every projection transposes (nn.Linear stores (out, in))."""
    if not (cfg.rope and cfg.swiglu and cfg.rmsnorm):
        raise ValueError("llama mapping expects rope+swiglu+rmsnorm config")
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""
    nl = cfg.n_layer

    wte = _get(sd, f"{prefix}embed_tokens.weight")
    if wte.shape != (cfg.vocab_size, cfg.n_embd):
        raise ValueError(
            f"embed_tokens {wte.shape} != ({cfg.vocab_size}, {cfg.n_embd})")

    def stack(fmt: str, transpose: bool = False) -> np.ndarray:
        return np.stack([_get(sd, prefix + fmt.format(i)).T if transpose
                         else _get(sd, prefix + fmt.format(i)) for i in range(nl)])

    blocks = {
        "ln1_scale": stack("layers.{}.input_layernorm.weight"),
        "ln2_scale": stack("layers.{}.post_attention_layernorm.weight"),
        "wq": stack("layers.{}.self_attn.q_proj.weight", True),
        "wk": stack("layers.{}.self_attn.k_proj.weight", True),
        "wv": stack("layers.{}.self_attn.v_proj.weight", True),
        "wo": stack("layers.{}.self_attn.o_proj.weight", True),
        "w_gate": stack("layers.{}.mlp.gate_proj.weight", True),
        "w_up": stack("layers.{}.mlp.up_proj.weight", True),
        "w_down": stack("layers.{}.mlp.down_proj.weight", True),
    }
    params: Params = _f32({"wte": wte, "lnf_scale": _get(sd, f"{prefix}norm.weight")})
    params["blocks"] = _f32(blocks)
    if not cfg.tie_weights:
        params["head"] = np.asarray(_get(sd, "lm_head.weight"), np.float32).T.copy()
    return params


def from_pretrained(model_type: str = "gpt2", **config_overrides: Any
                    ) -> Tuple[GPTConfig, Params]:
    """OpenAI GPT-2 weights through transformers' hub cache: (cfg, the
    numpy parameter tree). Needs the network or a populated HF cache
    (``HF_HOME``); raises RuntimeError otherwise."""
    cfg = config_for_pretrained(model_type, **config_overrides)
    try:
        from transformers import GPT2LMHeadModel
    except ImportError as e:
        raise RuntimeError(f"transformers unavailable: {e}") from None
    try:
        hf = GPT2LMHeadModel.from_pretrained(model_type)
    except Exception as e:
        raise RuntimeError(
            f"could not load {model_type!r} weights (offline? set HF_HOME to "
            f"a populated cache): {e}") from None
    return cfg, load_hf_state_dict(hf.state_dict(), cfg)
