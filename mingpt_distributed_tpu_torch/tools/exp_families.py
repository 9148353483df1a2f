"""One real train step per architecture family on the card: the
counterpart of ``tools/exp_families.py``.

Families: llama (RoPE, SwiGLU, RMSNorm, GQA, untied head), mistral (llama
and a sliding window), gemma (logit softcaps in attention and in the
head) and moe (switch-routed SwiGLU experts), each at 4 layers, width 512,
V 32000, T 1024, batch 4, bf16, flash attention. ``run`` takes 3 steps
(``make_optimizer``, ``make_train_step``) on one random batch whose
targets are its inputs, and raises unless the loss is finite and falling.

    python -m mingpt_distributed_tpu_torch.tools.exp_families [--device cpu]

Prints one JSON line per family, ``{"family", "losses", "grad_norm"}`` (as
the JAX tool, rounded to 4 and 3 places), or ``{"family", "error"}``, and
exits 1 if any family failed (the JAX tool exits 0 either way).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Optional

import numpy as np
import torch

from mingpt_distributed_tpu_torch.config import GPTConfig, OptimizerConfig
from mingpt_distributed_tpu_torch.models import convert, gpt
from mingpt_distributed_tpu_torch.training.optimizer import make_optimizer
from mingpt_distributed_tpu_torch.training.trainer import (
    TrainState,
    make_train_step,
    trainable,
)
from mingpt_distributed_tpu_torch.utils.device import resolve_device

FAMILIES = {
    # llama-tiny-shaped: RoPE + SwiGLU + RMSNorm + GQA + untied head
    "llama": dict(n_layer=4, n_head=8, n_kv_head=2, n_embd=512,
                  vocab_size=32000, block_size=1024, rope=True, swiglu=True,
                  rmsnorm=True, tie_weights=False),
    # mistral-shaped: llama + sliding window attention
    "mistral": dict(n_layer=4, n_head=8, n_kv_head=2, n_embd=512,
                    vocab_size=32000, block_size=1024, rope=True,
                    swiglu=True, rmsnorm=True, attention_window=256),
    # gemma2-shaped: logit soft-caps in attention and the final head
    "gemma": dict(n_layer=4, n_head=8, n_embd=512, vocab_size=32000,
                  block_size=1024, rope=True, swiglu=True, rmsnorm=True,
                  attn_logit_softcap=50.0, final_logit_softcap=30.0),
    # mixtral-shaped: switch-routed MoE experts (SwiGLU experts)
    "moe": dict(n_layer=4, n_head=8, n_embd=512, vocab_size=32000,
                block_size=1024, rope=True, swiglu=True, rmsnorm=True,
                n_experts=4, moe_top_k=2),
}
BATCH = 4
STEPS = 3
SEED_PARAMS, SEED_TOKENS = 0, 1


def config(kw: dict, dtype: str = "bfloat16") -> GPTConfig:
    """A family's model: ``kw`` at ``dtype``, flash attention, no dropout."""
    return GPTConfig.make(embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0,
                          dtype=dtype, attention="flash", unroll_layers=True, **kw)


def setup(kw: dict, *, device=None, dtype: str = "bfloat16",
          params: Optional[dict] = None, tokens: Optional[np.ndarray] = None):
    """(config, step, state, batch) of one family on ``device`` (cuda
    unless ``cpu``). The weights are drawn from ``torch.Generator`` seed
    SEED_PARAMS, the (BATCH, block_size) tokens from seed SEED_TOKENS,
    unless given: ``params`` a numpy tree in the JAX package's layout
    (``models/convert.py``), ``tokens`` an integer array (B, T); the batch
    is (tokens, tokens)."""
    dev = resolve_device(device)
    cfg = config(kw, dtype)
    if params is None:
        tree = gpt.init(cfg, torch.Generator(device=dev).manual_seed(SEED_PARAMS),
                        device=dev)
    else:
        tree = convert.params_from_numpy(params, cfg, dev)
    if tokens is None:
        g = torch.Generator(device=dev).manual_seed(SEED_TOKENS)
        toks = torch.randint(0, cfg.vocab_size, (BATCH, cfg.block_size),
                             generator=g, device=dev)
    else:
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=dev)
    tree = trainable(tree)
    state = TrainState(tree, make_optimizer(OptimizerConfig(), tree, 1.0))
    return cfg, make_train_step(cfg), state, (toks, toks)


def check_losses(name: str, losses: list) -> None:
    """Raise unless every loss is finite and the last is below the first."""
    if not all(math.isfinite(x) for x in losses):
        raise FloatingPointError(f"{name}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{name}: loss not falling {losses}")


def run(name: str, kw: dict, **setup_kw) -> dict:
    """STEPS steps of family ``name`` (``kw``; ``setup_kw`` as ``setup``):
    ``{"family", "losses", "grad_norm"}``, unrounded, the grad norm the last
    step's (before the clip)."""
    _, step, state, batch = setup(kw, **setup_kw)
    losses = []
    for _ in range(STEPS):
        m = step(state, batch)
        losses.append(m["loss"].item())
    check_losses(name, losses)
    return {"family": name, "losses": losses, "grad_norm": m["grad_norm"].item()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    failed = False
    for name, kw in FAMILIES.items():
        try:
            rec = run(name, kw, device=args.device)
            rec = {"family": name, "losses": [round(x, 4) for x in rec["losses"]],
                   "grad_norm": round(rec["grad_norm"], 3)}
        except Exception as e:  # noqa: BLE001  (one line per family, as the JAX tool)
            failed = True
            rec = {"family": name,
                   "error": (str(e).splitlines() or [type(e).__name__])[0][:160]}
        print(json.dumps(rec), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
