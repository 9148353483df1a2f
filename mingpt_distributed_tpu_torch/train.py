"""Training entry point of the port: config, data, trainer.

Counterpart of the repository's ``train.py``. Loads a YAML config with
``section.key=value`` overrides, builds the dataset (``data_config.tokenizer``:
the character vocabulary or byte-level BPE; its vocabulary and block size
override the model's), trains, and exits 75 after a
preemption (SIGTERM/SIGINT: stop at a step boundary, snapshot) so a
scheduler can requeue the run, which then resumes from the snapshot. Runs on
CUDA unless ``--device cpu``.

Usage:
  python -m mingpt_distributed_tpu_torch.train [--config gpt2_config.yaml] \\
      [--device cpu] [section.key=value ...]

Data and sequence parallel (dp x sp = the number of processes; the
backend is named, never guessed: nccl for one rank per GPU, gloo for CPU
ranks or ranks sharing one GPU):
  python -m torch.distributed.run --nproc-per-node 4 \\
      -m mingpt_distributed_tpu_torch.train --dist-backend gloo \\
      trainer_config.mesh.sp=4 gpt_config.attention=ring

The default config keeps every dropout at 0.1; attention dropout routes
attention to the einsum oracle, as in the JAX package, so set
``gpt_config.attn_pdrop=0`` to train through the flash kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from mingpt_distributed_tpu_torch.config import load_config
from mingpt_distributed_tpu_torch.data.token_dataset import make_dataset
from mingpt_distributed_tpu_torch.parallel import distributed
from mingpt_distributed_tpu_torch.training.trainer import (
    REQUEUE_EXIT_CODE,
    GPTTrainer,
)
from mingpt_distributed_tpu_torch.utils.device import resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="gpt2_config.yaml", help="YAML config file")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--dist-backend", choices=distributed.BACKENDS, default=None,
                   help="process-group backend of a torch.distributed.run job")
    p.add_argument("overrides", nargs="*", help="dotted overrides: section.key=value")
    args = p.parse_args(argv)

    cfg = load_config(args.config, args.overrides)
    device = resolve_device(args.device)
    distributed.initialize(args.dist_backend)
    try:
        return _train(cfg, distributed.device_for(args.dist_backend, device))
    finally:
        distributed.shutdown()


def _train(cfg, device) -> int:
    main_rank = distributed.rank() == 0
    dataset = make_dataset(cfg.data_config)
    train_view, test_view = dataset.split()
    gpt_cfg = dataclasses.replace(cfg.gpt_config, vocab_size=dataset.vocab_size,
                                  block_size=dataset.block_size)
    if main_rank:
        unit = "tokens" if cfg.data_config.tokenizer == "bpe" else "chars"
        print(f"data: {len(dataset.data)} {unit}, vocab {dataset.vocab_size}, "
              f"{len(train_view)} train / {len(test_view)} test windows",
              flush=True)

    trainer = GPTTrainer(cfg.trainer_config, gpt_cfg, cfg.optimizer_config,
                         train_view, test_view, experiment_config=cfg,
                         device=device)
    try:
        trainer.train()
    finally:
        trainer.close()
    if trainer.preempted:
        if main_rank:
            print(f"preempted at step {trainer.step}; snapshot committed, "
                  f"exiting {REQUEUE_EXIT_CODE} for requeue", flush=True)
        return REQUEUE_EXIT_CODE
    return 0


if __name__ == "__main__":
    sys.exit(main())
