"""Configuration: dataclasses, presets, YAML files and CLI overrides.

The port's own copy of ``mingpt_distributed_tpu/config.py`` (the port imports
nothing of the JAX package). ``GPTConfig`` keeps every field of the original,
so the repository's YAML files load unchanged; fields that only steer JAX
compilation (``scan_unroll``, ``unroll_layers``) are accepted and have no
effect here, because PyTorch runs the layer loop eagerly.

``DataConfig`` carries what the character vocabulary needs. The optimizer
and trainer sections of a YAML file are kept as plain dicts
(``ExperimentConfig.pending``) until the training slice ports their
dataclasses.

PyYAML is imported inside the functions that parse YAML, so the rest of the
package works where it is not installed.
"""

from __future__ import annotations

import dataclasses
import io
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Sequence

MODEL_PRESETS: dict[str, dict[str, Any]] = {
    # name            layers heads  width   (params)
    "openai-gpt":    dict(n_layer=12, n_head=12, n_embd=768),    # 117M
    "gpt2":          dict(n_layer=12, n_head=12, n_embd=768),    # 124M
    "gpt2-medium":   dict(n_layer=24, n_head=16, n_embd=1024),   # 350M
    "gpt2-large":    dict(n_layer=36, n_head=20, n_embd=1280),   # 774M
    "gpt2-xl":       dict(n_layer=48, n_head=25, n_embd=1600),   # 1558M
    "gopher-44m":    dict(n_layer=8,  n_head=16, n_embd=512),
    "gpt-mini":      dict(n_layer=6,  n_head=6,  n_embd=192),
    "gpt-micro":     dict(n_layer=4,  n_head=4,  n_embd=128),
    "gpt-nano":      dict(n_layer=3,  n_head=3,  n_embd=48),
    # Llama-style presets (rotary + SwiGLU + RMSNorm)
    "llama-tiny":    dict(n_layer=4,  n_head=4,  n_embd=256,  n_kv_head=2,
                          rope=True, swiglu=True, rmsnorm=True, tie_weights=False),
    "llama-3-8b":    dict(n_layer=32, n_head=32, n_embd=4096, n_kv_head=8,
                          rope=True, swiglu=True, rmsnorm=True, tie_weights=False,
                          vocab_size=128256, block_size=8192, ffn_mult=3.5,
                          rope_theta=500000.0),
    # Mistral-style presets: Llama architecture + sliding-window attention
    "mistral-tiny":  dict(n_layer=4,  n_head=4,  n_embd=256,  n_kv_head=2,
                          rope=True, swiglu=True, rmsnorm=True, tie_weights=False,
                          attention_window=64),
    "mistral-7b":    dict(n_layer=32, n_head=32, n_embd=4096, n_kv_head=8,
                          rope=True, swiglu=True, rmsnorm=True, tie_weights=False,
                          vocab_size=32000, block_size=8192, ffn_mult=3.5,
                          rope_theta=1000000.0, attention_window=4096),
    # Mixtral-style sparse MoE presets (the MoE MLP is not ported yet)
    "mixtral-tiny":  dict(n_layer=4,  n_head=4,  n_embd=256,  n_kv_head=2,
                          rope=True, swiglu=True, rmsnorm=True, tie_weights=False,
                          n_experts=4, moe_top_k=2),
    "mixtral-8x7b":  dict(n_layer=32, n_head=32, n_embd=4096, n_kv_head=8,
                          rope=True, swiglu=True, rmsnorm=True, tie_weights=False,
                          vocab_size=32000, block_size=8192, ffn_mult=3.5,
                          rope_theta=1000000.0, n_experts=8, moe_top_k=2),
}


class ConfigError(ValueError):
    """Raised for invalid or inconsistent configuration."""


def _reject_unknown(cls, kwargs: Mapping[str, Any]) -> dict[str, Any]:
    valid = {f.name for f in dataclasses.fields(cls)}
    unknown = set(kwargs) - valid
    if unknown:
        raise ConfigError(
            f"{cls.__name__}: unknown key(s) {sorted(unknown)}; "
            f"valid keys: {sorted(valid)}"
        )
    return dict(kwargs)


@dataclass(frozen=True)
class GPTConfig:
    """Model hyperparameters.

    Either give ``model_type`` (a preset name) or the explicit dims
    ``n_layer/n_head/n_embd``, exactly one of the two. Frozen; evolve with
    ``dataclasses.replace``. Field meanings are those of the JAX package's
    ``GPTConfig``.
    """

    model_type: Optional[str] = None
    n_layer: Optional[int] = None
    n_head: Optional[int] = None
    n_embd: Optional[int] = None
    vocab_size: int = 50257
    block_size: int = 1024
    embd_pdrop: float = 0.1
    resid_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    # "einsum" (the oracle), "flash" (the hand-written kernel), "ring" and
    # "ulysses" (sequence parallel; not ported yet)
    attention: str = "einsum"
    attention_window: Optional[int] = None
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    # compute dtype for activations; params are kept in float32
    dtype: str = "bfloat16"
    remat: bool = False
    pp_microbatches: int = 0
    pp_schedule: str = "gpipe"
    tie_weights: bool = False
    rope: bool = False
    rope_theta: float = 10000.0
    swiglu: bool = False
    rmsnorm: bool = False
    n_kv_head: Optional[int] = None  # grouped-query attention; None = n_head
    ffn_mult: float = 4.0
    norm_eps: float = 1e-5
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    loss_chunks: int = 8
    scan_unroll: int = 1
    unroll_layers: bool = False

    @classmethod
    def make(cls, **kwargs: Any) -> "GPTConfig":
        """Build + resolve + validate in one step (accepts n_embed alias)."""
        kwargs = dict(kwargs)
        if "n_embed" in kwargs:
            kwargs.setdefault("n_embd", kwargs.pop("n_embed"))
        cfg = cls(**_reject_unknown(cls, kwargs))
        return cfg.resolved()

    def resolved(self) -> "GPTConfig":
        """Apply the preset table and validate (preset XOR explicit dims)."""
        dims = (self.n_layer, self.n_head, self.n_embd)
        type_given = self.model_type is not None
        dims_given = all(v is not None for v in dims)
        any_dim_given = any(v is not None for v in dims)
        if type_given and any_dim_given:
            raise ConfigError(
                "give either model_type (a preset) or explicit "
                "n_layer/n_head/n_embd, not both"
            )
        if not type_given and not dims_given:
            raise ConfigError(
                "model underspecified: give model_type or all of "
                "n_layer/n_head/n_embd"
            )
        out = self
        if type_given:
            if self.model_type not in MODEL_PRESETS:
                raise ConfigError(
                    f"unknown model_type {self.model_type!r}; "
                    f"presets: {sorted(MODEL_PRESETS)}"
                )
            out = dataclasses.replace(self, **MODEL_PRESETS[self.model_type])
        out.validate()
        return out

    def validate(self) -> None:
        if self.n_embd is None or self.n_head is None or self.n_layer is None:
            raise ConfigError("model dims unresolved; call .resolved() first")
        if self.n_embd % self.n_head != 0:
            raise ConfigError(
                f"n_embd={self.n_embd} not divisible by n_head={self.n_head}"
            )
        kv = self.n_kv_head if self.n_kv_head is not None else self.n_head
        if self.n_head % kv != 0:
            raise ConfigError(
                f"n_head={self.n_head} not divisible by n_kv_head={kv}"
            )
        if self.attention not in ("einsum", "flash", "ring", "ulysses"):
            raise ConfigError(f"unknown attention impl {self.attention!r}")
        if self.attention_window is not None and self.attention_window < 1:
            raise ConfigError(
                f"attention_window must be >= 1, got {self.attention_window}"
            )
        if self.attn_logit_softcap is not None and self.attn_logit_softcap <= 0:
            raise ConfigError(
                f"attn_logit_softcap must be > 0, got {self.attn_logit_softcap}"
            )
        if self.final_logit_softcap is not None and self.final_logit_softcap <= 0:
            raise ConfigError(
                f"final_logit_softcap must be > 0, got {self.final_logit_softcap}"
            )
        if self.scan_unroll < 1:
            raise ConfigError(f"scan_unroll must be >= 1, got {self.scan_unroll}")
        if self.pp_schedule not in ("gpipe", "1f1b"):
            raise ConfigError(
                f"unknown pp_schedule {self.pp_schedule!r} "
                "(choose 'gpipe' or '1f1b')"
            )
        if self.loss_chunks < 0:
            raise ConfigError(f"loss_chunks must be >= 0, got {self.loss_chunks}")
        if self.rope and (self.n_embd // self.n_head) % 2 != 0:
            raise ConfigError(
                f"rope needs an even head_dim, got {self.n_embd // self.n_head}"
            )
        if self.block_size <= 0 or self.vocab_size <= 0:
            raise ConfigError("block_size and vocab_size must be positive")
        if self.n_experts:
            if self.moe_top_k < 1 or self.moe_top_k > self.n_experts:
                raise ConfigError(
                    f"moe_top_k={self.moe_top_k} outside [1, {self.n_experts}]"
                )

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head if self.n_kv_head is not None else self.n_head


@dataclass
class DataConfig:
    """Corpus location, context length and tokenizer choice."""

    path: str = ""
    block_size: int = 128
    train_split: float = 0.9
    truncate: float = 1.0
    # "char" is ported; "bpe" waits for the training slice
    tokenizer: str = "char"
    bpe_vocab_size: int = 512
    bpe_path: Optional[str] = None

    @classmethod
    def make(cls, **kwargs: Any) -> "DataConfig":
        cfg = cls(**_reject_unknown(cls, kwargs))
        if not (0.0 < cfg.train_split <= 1.0):
            raise ConfigError(f"train_split={cfg.train_split} outside (0, 1]")
        if not (0.0 < cfg.truncate <= 1.0):
            raise ConfigError(f"truncate={cfg.truncate} outside (0, 1]")
        if cfg.tokenizer not in ("char", "bpe"):
            raise ConfigError(f"unknown tokenizer {cfg.tokenizer!r}")
        return cfg


@dataclass
class ExperimentConfig:
    """The sections of a config file: the two this slice uses, validated,
    and the optimizer/trainer sections kept raw in ``pending``."""

    gpt_config: GPTConfig
    data_config: DataConfig
    pending: Dict[str, dict] = field(default_factory=dict)

    PENDING_SECTIONS = ("optimizer_config", "trainer_config")

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "ExperimentConfig":
        known = {"gpt_config", "data_config", *cls.PENDING_SECTIONS}
        unknown = set(raw) - known
        if unknown:
            raise ConfigError(
                f"unknown config section(s) {sorted(unknown)}; "
                f"valid: {sorted(known)}"
            )
        return cls(
            gpt_config=GPTConfig.make(**dict(raw.get("gpt_config", {}))),
            data_config=DataConfig.make(**dict(raw.get("data_config", {}))),
            pending={s: dict(raw[s]) for s in cls.PENDING_SECTIONS if s in raw},
        )


def _parse_override_value(text: str) -> Any:
    """Parse an override value with YAML scalar rules (1 -> int, true ->
    bool), accepting ``1e-3`` (a string in YAML 1.1) as a float."""
    import yaml

    value = yaml.safe_load(io.StringIO(text))
    if isinstance(value, str):
        try:
            return int(value)
        except ValueError:
            pass
        try:
            return float(value)
        except ValueError:
            pass
    return value


def apply_overrides(raw: dict[str, Any], overrides: Sequence[str]) -> dict[str, Any]:
    """Apply ``section.key=value`` dotted overrides; ``~section.key``
    deletes. Nested keys use further dots."""
    out = {k: (dict(v) if isinstance(v, Mapping) else v) for k, v in raw.items()}
    for ov in overrides:
        ov = ov.strip()
        if not ov:
            continue
        if ov.startswith("~"):
            path, value, delete = ov[1:], None, True
        elif "=" in ov:
            path, text = ov.split("=", 1)
            value, delete = _parse_override_value(text), False
        else:
            raise ConfigError(f"malformed override {ov!r}; want key=value or ~key")
        keys = path.split(".")
        node = out
        for k in keys[:-1]:
            nxt = node.get(k)
            if not isinstance(nxt, dict):
                nxt = dict(nxt) if isinstance(nxt, Mapping) else {}
                node[k] = nxt
            node = nxt
        if delete:
            node.pop(keys[-1], None)
        else:
            node[keys[-1]] = value
    return out


def load_config(
    path: Optional[str] = None, overrides: Sequence[str] = ()
) -> ExperimentConfig:
    """Load a YAML config file (its ``hydra`` section ignored) and apply
    ``section.key=value`` CLI overrides."""
    raw: dict[str, Any] = {}
    if path is not None:
        import yaml

        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        if not isinstance(loaded, Mapping):
            raise ConfigError(f"config file {path} is not a mapping")
        raw = {k: v for k, v in loaded.items() if k != "hydra"}
    raw = apply_overrides(raw, overrides)
    return ExperimentConfig.from_dict(raw)
