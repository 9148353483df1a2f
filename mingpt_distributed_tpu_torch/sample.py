"""Sampling entry point of the port: build a model, generate text.

Counterpart of the repository's ``sample.py``. The vocabulary is the
corpus's (``--data``, default: the config's ``data_config.path``), by
``data_config.tokenizer``: its character set, or byte-level BPE. The
weights come from the trainer's snapshot at ``trainer_config.snapshot_path``
(by default; either backend: a ``.pt`` or ``.msgpack`` file or a sharded
directory, ``training/checkpoint.restore_inference_params``, as the JAX
``sample.py`` loads its snapshot), from ``--params FILE.npz`` (a JAX
parameter pytree flattened to ``"blocks/wq"``-style keys, see the README)
or from ``--random-init --seed N``. Runs on CUDA unless ``--device cpu``.

Usage:
  python -m mingpt_distributed_tpu_torch.sample [--random-init | --params F.npz] \\
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
from mingpt_distributed_tpu_torch.data.token_dataset import make_dataset
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import gpt as gpt_lib
from mingpt_distributed_tpu_torch.models.api import GPT
from mingpt_distributed_tpu_torch.training import checkpoint as ckpt_lib
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
    snapshot_path: Optional[str] = None,
) -> str:
    """Prompt + continuation as text. The weights of ``params_path``, else
    of the snapshot at ``snapshot_path`` (FileNotFoundError when there is
    none), else random ones seeded ``seed``; sampling draws from a
    generator seeded ``seed``."""
    data_cfg = exp.data_config
    if data_path is not None:
        data_cfg = dataclasses.replace(data_cfg, path=data_path)
    dataset = make_dataset(data_cfg)
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
    elif snapshot_path is not None:
        snap = ckpt_lib.restore_inference_params(snapshot_path, gpt_cfg, dev)
        if snap is None:
            raise FileNotFoundError(
                f"no snapshot at {snapshot_path}; train first (python -m "
                "mingpt_distributed_tpu_torch.train) or pass --params or --random-init")
        params = snap.params
        print(f"loaded snapshot step {snap.step} from {snapshot_path}", file=sys.stderr)
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
    src = p.add_mutually_exclusive_group()
    src.add_argument("--params", help="flat .npz of the JAX parameter pytree "
                                      "(default: the trainer's snapshot)")
    src.add_argument("--random-init", action="store_true",
                     help="random weights seeded --seed")
    p.add_argument("--data", default=None,
                   help="corpus for the vocabulary (default: the "
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
    snapshot = None
    if args.params is None and not args.random_init:
        snapshot = exp.trainer_config.snapshot_path or ckpt_lib.DEFAULT_SNAPSHOT_PATH
    try:
        text = sample_text(
            exp, prompt=args.prompt, max_new_tokens=args.max_new_tokens,
            params_path=args.params, seed=args.seed,
            temperature=args.temperature, greedy=args.greedy, top_k=args.top_k,
            top_p=args.top_p, data_path=args.data, device=args.device,
            snapshot_path=snapshot)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 1
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
