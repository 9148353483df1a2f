"""Where the time goes in a training step on the GPU.

Runs the port's train step (``make_train_step``) at the bench shape,
GPT-2 124M (12 layers, 12 heads, 768 wide, vocab 50257), T=1024, batch 16,
bfloat16, no dropout, flash attention, random weights and tokens from seed
0, under ``torch.profiler``, and prints as JSON lines: step ms (host clock
around synchronised steps), tokens/s, MFU against the card's bf16 peak, the
device busy share of the profiled window (device kernel time / wall time),
the device time by kind of kernel and by kernel (top entries), and the
three flash kernels' shares. Needs one CUDA device.

    python -m mingpt_distributed_tpu_torch.tools.profile_train
"""

from __future__ import annotations

import json
import sys
import time

import torch

from mingpt_distributed_tpu_torch.config import GPTConfig, OptimizerConfig
from mingpt_distributed_tpu_torch.models import gpt
from mingpt_distributed_tpu_torch.training.metrics import flops_per_token, peak_flops
from mingpt_distributed_tpu_torch.training.optimizer import make_optimizer
from mingpt_distributed_tpu_torch.training.trainer import (
    TrainState,
    make_train_step,
    trainable,
)

BATCH, SEQ = 16, 1024
STEPS = 3  # profiled steps, after 2 warm-up steps
TOP = 15  # kernel rows printed
FLASH = ("flash_fwd", "flash_dq", "flash_dkv")
# device kernels by kind, first match wins (substrings of the kernel name)
CATEGORIES = (
    ("flash kernels", FLASH),
    ("GEMMs, 8-aligned (cuBLAS/CUTLASS)", ("nvjet", "gemm", "sm90_xmma", "cutlass")),
    ("optimizer (AdamW, clip, norms)", ("AdamW", "multi_tensor", "foreach", "norm_kernel")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise", "copy", "Memcpy", "Memset", "fill")),
)


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def bench_state():
    """The bench configuration's config (bf16, flash, no dropout), train
    state and one batch."""
    cfg = GPTConfig.make(model_type="gpt2", vocab_size=50257, block_size=SEQ,
                         dtype="bfloat16", attention="flash", embd_pdrop=0.0,
                         resid_pdrop=0.0, attn_pdrop=0.0)
    params = trainable(gpt.init(cfg, torch.Generator().manual_seed(0),
                                device="cuda"))
    state = TrainState(params, make_optimizer(OptimizerConfig(), params, 1.0))
    g = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), generator=g,
                           device="cuda")
    return cfg, state, (tokens[:, :-1], tokens[:, 1:])


def categorize(rows):
    """{category: device us} over every kernel row; GEMMs whose name says
    align1 (an operand not 8-aligned: the vocabulary of 50257) apart."""
    out = {}
    for key, us, _ in rows:
        cat = "other"
        if "align1" in key:
            cat = "GEMMs, align1 (the LM head: V = 50257)"
        else:
            for name, needles in CATEGORIES:
                if any(n in key for n in needles):
                    cat = name
                    break
        out[cat] = out.get(cat, 0.0) + us
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, state, batch = bench_state()
    step = make_train_step(cfg)
    for _ in range(2):  # warm-up: kernel build, cuBLAS handles, allocator
        step(state, batch)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            m = step(state, batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    # device-side kernel events only: a CPU op's entry also carries the
    # device time of the kernels it launched, and a user annotation on the
    # device timeline ("Optimizer.step#AdamW.step") spans kernels counted
    # on their own
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    total_us = sum(r[1] for r in rows)
    name = torch.cuda.get_device_name(0)
    tokens_per_s = BATCH * SEQ * STEPS / wall_s
    peak = peak_flops(name, cfg.dtype)
    print(json.dumps({
        "phase": "profile_train", "config": "gpt2 124M", "dtype": cfg.dtype,
        "batch": BATCH, "seq": SEQ, "steps": STEPS,
        "step_ms": wall_s / STEPS * 1e3, "tokens_per_s": tokens_per_s,
        "mfu": flops_per_token(cfg, SEQ) * tokens_per_s / peak if peak else None,
        "device_kernel_s": total_us / 1e6, "device_busy_share": total_us / 1e6 / wall_s,
        **{f"{k}_share_of_device": sum(r[1] for r in rows if k in r[0]) / total_us
           for k in FLASH},
        "loss": m["loss"].item(), "card": name}), flush=True)
    for cat, us in sorted(categorize(rows).items(), key=lambda kv: -kv[1]):
        print(json.dumps({"category": cat, "device_ms_per_step": us / 1e3 / STEPS,
                          "share": us / total_us}), flush=True)
    for key, us, count in rows[:TOP]:
        print(json.dumps({"kernel": key[:120], "device_ms_per_step": us / 1e3 / STEPS,
                          "calls_per_step": count / STEPS,
                          "share": us / total_us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
