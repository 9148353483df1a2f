"""Where the time goes in sliding-window generation on the GPU.

Runs the port's main inference path (``GPT.generate`` past the context
window at GPT-2 124M width, random weights, the shape ``chip_smoke.py``
drives: batch 4, 1000-token prompts) under ``torch.profiler``, in bfloat16
and then float32, and prints for each, as JSON lines: the device time by
kernel name (top entries), the flash kernel's share, and the device busy
share of the profiled window (device kernel time / wall time). Needs one
CUDA device.

    python -m mingpt_distributed_tpu_torch.tools.profile_generate
"""

from __future__ import annotations

import json
import sys
import time

import torch

from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models.api import GPT

BATCH = 4
PROMPT_LEN = 1000
STEPS_PAST_WINDOW = 4  # new tokens beyond the 1024-token window
TOP = 12  # kernel rows printed per dtype


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def profile(dtype: str) -> None:
    cfg = GPTConfig.make(model_type="gpt2", attention="flash", dtype=dtype,
                         embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    model = GPT(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                            generator=g, device="cuda")
    n_new = cfg.block_size - PROMPT_LEN + STEPS_PAST_WINDOW
    model.generate(prompts, n_new)  # warm-up: cuBLAS handles, kernel build
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        model.generate(prompts, n_new)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    # device-side kernel events only: a CPU op's entry also carries the
    # device time of the kernels it launched, which would count them twice
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = [r for r in rows if r[1] > 0]
    rows.sort(key=lambda r: -r[1])
    total_us = sum(r[1] for r in rows)
    flash_us = sum(r[1] for r in rows if "flash_fwd" in r[0])
    print(json.dumps({
        "phase": "profile", "config": "gpt2 124M", "dtype": dtype,
        "batch": BATCH, "prompt": PROMPT_LEN, "new_tokens": n_new,
        "wall_s": wall_s, "device_kernel_s": total_us / 1e6,
        "device_busy_share": total_us / 1e6 / wall_s,
        "flash_fwd_share_of_device": flash_us / total_us if total_us else None,
        "tokens_per_s": BATCH * n_new / wall_s,
        "card": torch.cuda.get_device_name(0)}), flush=True)
    for name, us, count in rows[:TOP]:
        print(json.dumps({"dtype": dtype, "kernel": name[:120],
                          "device_ms": us / 1e3, "calls": count,
                          "share": us / total_us}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_generate: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in ("bfloat16", "float32"):
        profile(dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
