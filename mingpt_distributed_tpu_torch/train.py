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
  python -m mingpt_distributed_tpu_torch.train --selftest-faults [--device cpu]
  python -m mingpt_distributed_tpu_torch.train --selftest-zero [--device cpu]

``--selftest-faults`` is the fault-injected snapshot save and restore gate
(every third object write fails transiently and retries absorb it; the
newest snapshot is torn and restore falls back to the one before).
``--selftest-zero`` is the ZeRO gate: two gloo ranks at dp = 2 train the
sharded update against the replicated one at grad_accum 1 and 2 (losses
and parameters within 2e-4) and each rank's Adam bytes must equal
``opt_moment_bytes`` (half the dense moments). Both need no config or
dataset and run on CUDA unless ``--device cpu`` (the two ranks of
``--selftest-zero`` then share the card).

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
    p.add_argument("--selftest-faults", action="store_true",
                   help="fault-injected snapshot save/restore smoke; no config "
                        "or dataset needed")
    p.add_argument("--selftest-zero", action="store_true",
                   help="ZeRO dp update-sharding parity + memory smoke on two "
                        "gloo ranks at dp=2; no config or dataset needed")
    p.add_argument("overrides", nargs="*", help="dotted overrides: section.key=value")
    args = p.parse_args(argv)
    if args.selftest_faults:
        return selftest_faults(args.device)
    if args.selftest_zero:
        return selftest_zero(args.device)

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


def selftest_faults(device=None) -> int:
    """Every third object write fails transiently while two snapshots of
    parameters on ``device`` (CUDA unless ``cpu``) are committed (the
    retries must absorb it); then the newest is torn on disk and restore
    must fall back to the one before, never load the torn one. Returns 0
    when both hold."""
    import tempfile

    import torch

    from mingpt_distributed_tpu_torch.training import checkpoint as ckpt
    from mingpt_distributed_tpu_torch.training import durability as dur
    from mingpt_distributed_tpu_torch.training.faults import FaultInjectionFileSystem

    dev = resolve_device(device)
    rc = 0
    fs = FaultInjectionFileSystem("write:every=3")
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/snap.pt"
        for step in (1, 2):
            ckpt.save_snapshot(path, {"params": {"w": torch.full((16,), float(step), device=dev)},
                                      "opt_state": {}, "step": step, "epoch": 0},
                               retry=dur.NO_WAIT, fs=fs)
        writes = fs.specs[0].count
        if writes <= 4:  # 2 commits x 2 writes + at least one retry
            print(f"selftest-faults FAIL: no injected write observed ({writes} writes)")
            rc = 1
        fs.clear_faults()
        with open(f"{d}/snap.pt.step-00000002", "r+b") as f:
            f.truncate(32)  # tear the latest snapshot
        snap = ckpt.load_snapshot(path, retry=dur.NO_WAIT)
        if snap is None or snap["step"] != 1:
            print(f"selftest-faults FAIL: expected fallback to step 1, got "
                  f"{None if snap is None else snap['step']}")
            rc = 1
        elif not torch.equal(snap["params"]["w"].cpu(), torch.full((16,), 1.0)):
            print("selftest-faults FAIL: fallback params corrupt")
            rc = 1
    print("selftest-faults", "PASSED" if rc == 0 else "FAILED")
    return rc


#: the ZeRO self-test's model, data and tolerance (the JAX self-test's)
ZERO_SELFTEST_CFG = dict(n_layer=2, n_head=4, n_embd=64, vocab_size=256, block_size=32,
                         embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0,
                         dtype="float32")
ZERO_SELFTEST_STEPS = 4
ZERO_SELFTEST_TOL = 2e-4


def _zero_rank(rank: int, device) -> dict:
    """One rank of the ZeRO self-test: the replicated and the sharded update
    at dp = 2 from the same weights and batches, at grad_accum 1 and 2."""
    import numpy as np
    import torch

    from mingpt_distributed_tpu_torch.config import GPTConfig, MeshConfig, OptimizerConfig
    from mingpt_distributed_tpu_torch.models import gpt
    from mingpt_distributed_tpu_torch.parallel import zero
    from mingpt_distributed_tpu_torch.parallel.mesh import Mesh
    from mingpt_distributed_tpu_torch.training import trainer as T
    from mingpt_distributed_tpu_torch.training.optimizer import make_optimizer

    torch.set_num_threads(1)
    dev = distributed.device_for("gloo", resolve_device(device))
    cfg = GPTConfig.make(**ZERO_SELFTEST_CFG)
    mesh = Mesh(MeshConfig(dp=2))
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (8, 32)), rng.integers(0, 256, (8, 32)))
               for _ in range(ZERO_SELFTEST_STEPS)]
    mine = slice(4 * mesh.dp_rank, 4 * mesh.dp_rank + 4)
    out = {}
    for ga in (1, 2):
        for sharded in (False, True):
            whole = gpt.init(cfg, torch.Generator().manual_seed(0), device=dev)
            plan = zero.make_plan(mesh, whole) if sharded else None
            params = T.trainable(whole)
            opt = make_optimizer(OptimizerConfig(), params, 1.0, mesh=mesh, zero=plan)
            opt.init_moments()
            state = T.TrainState(params, opt)
            step = T.make_train_step(cfg, grad_accum=ga, mesh=mesh)
            losses, update_norms = [], []
            for x, y in batches:
                m = step(state, (torch.from_numpy(x[mine]).to(dev),
                                 torch.from_numpy(y[mine]).to(dev)))
                losses.append(m["loss"].item())
                update_norms.append(m["update_norm"].item())
            out[(ga, sharded)] = dict(
                losses=losses, update_norms=update_norms,
                params={n: p.detach().cpu().numpy() for n, p in
                        zip(opt.names, opt.params)},
                moment_bytes=opt.moment_bytes(),
                planned_bytes=zero.opt_moment_bytes(whole, plan))
    return out


def selftest_zero(device=None) -> int:
    """ZeRO weight-update sharding against the replicated update on two
    gloo ranks (dp = 2, on ``device``: CUDA unless ``cpu``, the two ranks
    sharing one card): losses
    and parameters within ``ZERO_SELFTEST_TOL`` at grad_accum 1 and 2, a
    finite positive update norm, and each rank's Adam bytes equal to
    ``opt_moment_bytes`` and at most 0.7 of the replicated ones. Returns 0
    when all hold."""
    import numpy as np

    from mingpt_distributed_tpu_torch.parallel.spawn import run_ranks

    resolve_device(device)  # raise here, not in the ranks, without CUDA
    ranks = run_ranks(_zero_rank, 2, (device,), timeout_s=600)
    rc = 0
    for ga in (1, 2):
        for r, res in enumerate(ranks):
            base, zero = res[(ga, False)], res[(ga, True)]
            if not np.allclose(base["losses"], zero["losses"], rtol=ZERO_SELFTEST_TOL,
                               atol=ZERO_SELFTEST_TOL):
                print(f"selftest-zero FAIL: rank {r} grad_accum={ga} loss mismatch "
                      f"base={base['losses']} zero={zero['losses']}")
                rc = 1
            if not all(np.isfinite(v) and v > 0 for v in zero["update_norms"]):
                print(f"selftest-zero FAIL: bad update_norm {zero['update_norms']}")
                rc = 1
            bad = [n for n in base["params"] if not np.allclose(
                base["params"][n], zero["params"][n], rtol=ZERO_SELFTEST_TOL,
                atol=ZERO_SELFTEST_TOL)]
            if bad:
                print(f"selftest-zero FAIL: rank {r} grad_accum={ga} param mismatch "
                      f"after {ZERO_SELFTEST_STEPS} steps: {bad}")
                rc = 1
            if ga == 1:
                ratio = zero["moment_bytes"] / max(base["moment_bytes"], 1)
                print(f"selftest-zero: rank {r} Adam bytes {base['moment_bytes']} -> "
                      f"{zero['moment_bytes']} (ratio {ratio:.3f}, dp=2; "
                      f"opt_moment_bytes {zero['planned_bytes']})")
                if zero["moment_bytes"] != zero["planned_bytes"] or ratio > 0.7:
                    print("selftest-zero FAIL: the moments are not 1/dp "
                          "(opt_moment_bytes)")
                    rc = 1
    print("selftest-zero", "PASSED" if rc == 0 else "FAILED")
    return rc


if __name__ == "__main__":
    sys.exit(main())
