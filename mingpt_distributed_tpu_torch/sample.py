"""Sampling entry point of the port: build a model, generate text.

Counterpart of the repository's ``sample.py``. The vocabulary is the
character set of the corpus (``--data``, default: the config's
``data_config.path``); the weights come from ``--params FILE.npz`` (a JAX
parameter pytree flattened to ``"blocks/wq"``-style keys, see the README)
or from ``--random-init --seed N``. Runs on CUDA unless ``--device cpu``.

Usage:
  python -m mingpt_distributed_tpu_torch.sample --random-init \\
      --prompt "O God, O God!" --max-new-tokens 200 \\
      [--config gpt2_config.yaml] [--temperature 0.8] [--top-k 40] [--greedy]
      [section.key=value ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional

import numpy as np
import torch

from mingpt_distributed_tpu_torch.config import ExperimentConfig, load_config
from mingpt_distributed_tpu_torch.data.char_dataset import CharDataset
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import gpt as gpt_lib
from mingpt_distributed_tpu_torch.models.api import GPT
from mingpt_distributed_tpu_torch.utils.device import Device, resolve_device


def sample_text(
    exp: ExperimentConfig,
    *,
    prompt: str,
    max_new_tokens: int,
    params_path: Optional[str] = None,
    seed: int = 0,
    temperature: float = 1.0,
    greedy: bool = False,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    data_path: Optional[str] = None,
    device: Optional[Device] = None,
) -> str:
    """Prompt + continuation as text. Random weights seeded ``seed`` when
    ``params_path`` is None; sampling draws from a generator seeded
    ``seed``."""
    data_cfg = exp.data_config
    if data_path is not None:
        data_cfg = dataclasses.replace(data_cfg, path=data_path)
    if data_cfg.tokenizer != "char":
        raise NotImplementedError(
            "only the char tokenizer is ported (ROADMAP.md Queue 1)")
    dataset = CharDataset(data_cfg)
    gpt_cfg = dataclasses.replace(
        exp.gpt_config,
        vocab_size=dataset.vocab_size,
        block_size=dataset.block_size,
        embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0,  # inference
    )
    dev = resolve_device(device)
    params = None
    if params_path is not None:
        with np.load(params_path) as f:
            tree = convert.unflatten({k: f[k] for k in f.files})
        params = convert.params_from_numpy(tree, gpt_cfg, device=dev)
    model = GPT(gpt_cfg, params, seed=seed, device=dev)
    print(gpt_lib.model_size_report(model.params, gpt_cfg), file=sys.stderr)

    idx = dataset.encode(prompt)[None, :]
    out = model.generate(
        idx, max_new_tokens, temperature=temperature, do_sample=not greedy,
        top_k=top_k, top_p=top_p,
        generator=torch.Generator(device=dev).manual_seed(seed),
    )
    return dataset.decode(out[0].cpu().numpy())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="gpt2_config.yaml")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--params", help="flat .npz of the JAX parameter pytree")
    src.add_argument("--random-init", action="store_true",
                     help="random weights seeded --seed")
    p.add_argument("--data", default=None,
                   help="corpus for the char vocabulary (default: the "
                        "config's data_config.path)")
    p.add_argument("--prompt", default="\n")
    p.add_argument("--max-new-tokens", type=int, default=200)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None,
                   help="nucleus sampling: keep the smallest set of tokens "
                        "with cumulative probability >= top_p")
    p.add_argument("--greedy", action="store_true",
                   help="argmax decoding (default: sample)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    exp = load_config(args.config, args.overrides)
    print(sample_text(
        exp, prompt=args.prompt, max_new_tokens=args.max_new_tokens,
        params_path=args.params, seed=args.seed,
        temperature=args.temperature, greedy=args.greedy, top_k=args.top_k,
        top_p=args.top_p, data_path=args.data, device=args.device,
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
