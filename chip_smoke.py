#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, drives the port's inference
path at GPT-2 124M width (random weights, seed 0) through the entry points a
user calls, checks that the path went through the kernels, and times them.
Imports nothing of JAX. Prints JSON lines as it goes; any failed check
raises, so the exit code is non-zero and the final line is never printed.

Phases:
  0. setup: the card's name and power limit, TF32 off, the kernel build;
  1. every kernel against its plain version at the main path's shapes and
     the edge cases (GQA, a window narrower than a tile, softcap, ragged T);
  2. the GPT forward at GPT-2 124M width: flash kernel vs plain attention;
  3. generation at the same width: sliding window (the main path: each new
     token re-forwards the window, one kernel launch per layer) and
     KV-cached decode (no kernel), then the sample entry point;
  4. times: kernel, plain version, bound and library yardstick; tokens/s;
     peak device memory.
The last three lines are the card, the kernels line and the ok line.
Exits 2 without CUDA, 1 on any failure.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet; dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate of its input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Tolerances of kernel vs plain version, max |out difference|:
#  bf16: both read the same bf16 inputs and work in float32; the output is
#        rounded to bf16 (relative 2^-8, outputs of order 1), and the two
#        sum in different orders, so a value can round to the neighbouring
#        bf16 number: 2e-2.
#  fp32: both sum up to T float32 products in different orders; the
#        difference stays near 1e-6, the check allows 1e-4.
OUT_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# The max alone sees a P.V fault only where it beats one bf16 step, so the
# mean |out difference| over the mean |out| is held too:
#  bf16: each output is rounded to bf16 (relative <= 2^-9) and the kernel
#        rounds each probability to bf16 before P.V (relative <= 2^-9 per
#        term, independent roundings that partly cancel over the keys), so
#        the ratio stays near 2^-9..2^-8 (2e-3..4e-3): 1e-2;
#  fp32: float32 sums in different orders, ~1e-7 relative per operation
#        over up to T terms: 1e-5.
OUT_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# lse is float32 from the same (bf16 or fp32) inputs in both: 1e-4.
LSE_TOL = 1e-4
# GPT-2 forward, fp32: flash kernel vs plain attention through 12 layers.
FWD_FP32_TOL = 1e-3
# GPT-2 forward, bf16. At random init the logits are nearly tied, so bf16
# rounding in the residual stream flips a few percent of argmaxes whatever
# the attention; top-1 agreement over all positions is printed, not held.
# It is held where the argmax is decided: at a position whose fp32 top-2
# gap exceeds 2e, where e bounds every logit's bf16 error, no bf16 path
# within e can move the argmax. With e the plain bf16 path's largest error
# and a margin of 3e, the plain path keeps the fp32 argmax there by
# construction and the kernel path must too, unless its error exceeds 1.5x
# the plain path's largest. Its top-1 agreement with the plain bf16 path
# over those positions must be at least 0.99, over at least 100 positions.
FWD_BF16_MARGIN_X = 3.0
FWD_BF16_TOP1_MIN = 0.99
FWD_BF16_MIN_POSITIONS = 100
# ... and its mean |logit error| against fp32 may exceed the plain bf16
# path's by at most 25%.
FWD_BF16_ERR_RATIO = 1.25


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 1: kernel vs plain version
# ---------------------------------------------------------------------------

# name, B, T, H, KV, hd, window, softcap
KERNEL_CASES = [
    ("gpt2_main", 4, 1024, 12, 12, 64, None, None),
    ("gqa_h8_kv2_hd128", 2, 512, 8, 2, 128, None, None),
    ("window16_t384", 2, 384, 12, 12, 64, 16, None),
    ("softcap50", 2, 512, 12, 12, 64, None, 50.0),
    ("ragged_t100", 2, 100, 12, 12, 64, None, None),
    ("ragged_t1", 2, 1, 12, 12, 64, None, None),
    ("hd16_t200", 2, 200, 4, 4, 16, None, None),
    ("hd32_gqa_window100_softcap30", 2, 300, 8, 4, 32, 100, 30.0),
]


def make_qkv(b, t, h, kv, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, t, h, hd), generator=g, device="cuda")
    k = torch.randn((b, t, kv, hd), generator=g, device="cuda")
    v = torch.randn((b, t, kv, hd), generator=g, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def attention_work(b, t, h, hd, window, dtype):
    """(bytes, operations) the causal attention forward must move and do:
    q, k, v read once, out and lse written once; two products of 2*hd
    operations for every (query, allowed key) pair."""
    if window is None:
        pairs = t * (t + 1) // 2
    else:
        w = min(window, t)
        pairs = w * (w + 1) // 2 + (t - w) * w
    elem = torch.finfo(dtype).bits // 8
    nbytes = 4 * b * t * h * hd * elem + b * h * t * 4
    flops = 4 * b * h * hd * pairs
    return nbytes, flops


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else
                                       "operations")


def kernel_errors(fa, q, k, v, *, scale, window, softcap):
    """Run the kernel and its plain version on the same inputs; return the
    differences of their outputs and lse."""
    out, lse = fa.flash_fwd(q, k, v, scale=scale, window=window,
                            softcap=softcap)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_fwd_plain(q, k, v, scale=scale, window=window,
                                      softcap=softcap)
    b, t, h, _ = q.shape
    check(out.shape == ref.shape and out.dtype == q.dtype,
          f"out {tuple(out.shape)} {out.dtype}")
    check(lse.shape == (b, h, t), f"lse {tuple(lse.shape)}")
    check(bool(torch.isfinite(out.float()).all()), "non-finite out")
    diff = (out.float() - ref.float()).abs()
    return {"max_abs_err": diff.max().item(),
            "mean_rel_err": (diff.mean() / ref.float().abs().mean().clamp_min(
                1e-30)).item(),
            "lse_max_abs_err": (lse - ref_lse).abs().max().item()}


def phase_kernels(fa):
    results = {}
    for i, (name, b, t, h, kv, hd, window, cap) in enumerate(KERNEL_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = make_qkv(b, t, h, kv, hd, dtype, seed=100 + i)
            errs = kernel_errors(fa, q, k, v, scale=1.0 / math.sqrt(hd),
                                 window=window, softcap=cap)
            dt = str(dtype).replace("torch.", "")
            emit({"phase": "kernel_check", "kernel": "flash_fwd", "case": name,
                  "dtype": dt, "shape": [b, t, h, kv, hd], "window": window,
                  "softcap": cap, **errs, "tol": OUT_TOL[dtype],
                  "rel_tol": OUT_REL_TOL[dtype], "lse_tol": LSE_TOL})
            err = errs["max_abs_err"]
            check(err <= OUT_TOL[dtype],
                  f"{name} {dt}: max |out diff| {err} > {OUT_TOL[dtype]}")
            check(errs["mean_rel_err"] <= OUT_REL_TOL[dtype],
                  f"{name} {dt}: mean |out diff| / mean |out| "
                  f"{errs['mean_rel_err']} > {OUT_REL_TOL[dtype]}")
            check(errs["lse_max_abs_err"] <= LSE_TOL,
                  f"{name} {dt}: max |lse diff| {errs['lse_max_abs_err']} > "
                  f"{LSE_TOL}")
            results[(name, dtype)] = (q, k, v, err)
    return results


# ---------------------------------------------------------------------------
# phase 2/3: the model at GPT-2 124M width
# ---------------------------------------------------------------------------


def gpt2_config(attention, dtype, block_size=1024, vocab_size=50257):
    from mingpt_distributed_tpu_torch.config import GPTConfig

    return GPTConfig.make(model_type="gpt2", vocab_size=vocab_size,
                          block_size=block_size, attention=attention,
                          dtype=dtype, embd_pdrop=0.0, resid_pdrop=0.0,
                          attn_pdrop=0.0)


def phase_forward(GPT, fa, model32):
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, 50257, (2, 1024), generator=g, device="cuda")
    params = model32.params
    n0 = fa.flash_fwd.launches
    flash32, _ = model32(tokens)
    check(fa.flash_fwd.launches - n0 == 12, "fp32 forward: 12 launches expected")
    plain32, _ = GPT(gpt2_config("einsum", "float32"), params, device="cuda")(tokens)
    check(flash32.shape == (2, 1024, 50257), f"logits {tuple(flash32.shape)}")
    check(bool(torch.isfinite(flash32).all()), "non-finite fp32 logits")
    err32 = (flash32 - plain32).abs().max().item()
    del flash32
    flash16, _ = GPT(gpt2_config("flash", "bfloat16"), params, device="cuda")(tokens)
    plain16, _ = GPT(gpt2_config("einsum", "bfloat16"), params, device="cuda")(tokens)
    flash_top1, plain_top1 = flash16.argmax(-1), plain16.argmax(-1)
    plain_err16 = (plain16 - plain32).abs().max().item()
    top2 = plain32.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > FWD_BF16_MARGIN_X * plain_err16
    n_decided = int(decided.sum().item())

    def agree(a, b):
        return (a == b).float().mean().item()

    rec = {"phase": "forward", "model": "gpt2 124M", "batch": 2, "seq": 1024,
           "fp32_max_abs_err": err32, "fp32_tol": FWD_FP32_TOL,
           "bf16_max_abs_err": (flash16 - plain16).abs().max().item(),
           "bf16_top1_agreement": agree(flash_top1, plain_top1),
           "bf16_plain_max_abs_err_vs_fp32": plain_err16,
           "bf16_decided_margin": FWD_BF16_MARGIN_X * plain_err16,
           "bf16_decided_positions": n_decided,
           "bf16_top1_agreement_decided":
               agree(flash_top1[decided], plain_top1[decided])
               if n_decided else None,
           "bf16_top1_decided_min": FWD_BF16_TOP1_MIN,
           "bf16_flash_top1_vs_fp32": agree(flash_top1, plain32.argmax(-1)),
           "bf16_plain_top1_vs_fp32": agree(plain_top1, plain32.argmax(-1)),
           "bf16_flash_mean_abs_err_vs_fp32":
               (flash16 - plain32).abs().mean().item(),
           "bf16_plain_mean_abs_err_vs_fp32":
               (plain16 - plain32).abs().mean().item(),
           "bf16_err_ratio_max": FWD_BF16_ERR_RATIO}
    emit(rec)
    check(err32 <= FWD_FP32_TOL, f"fp32 logits differ by {err32}")
    check(n_decided >= FWD_BF16_MIN_POSITIONS,
          f"bf16: only {n_decided} positions with a decided argmax")
    check(rec["bf16_top1_agreement_decided"] >= FWD_BF16_TOP1_MIN,
          f"bf16 top-1 agreement at decided positions below "
          f"{FWD_BF16_TOP1_MIN}")
    check(rec["bf16_flash_mean_abs_err_vs_fp32"]
          <= FWD_BF16_ERR_RATIO * rec["bf16_plain_mean_abs_err_vs_fp32"],
          "bf16 kernel path is further from the fp32 logits than allowed")


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_generate(GPT, fa, model32, card):
    """Returns the kernel launch count of the main path's run."""
    n_layer, new = 12, 32
    params = model32.params
    g = torch.Generator(device="cuda").manual_seed(2)
    long_prompts = torch.randint(0, 50257, (4, 1000), generator=g, device="cuda")
    short_prompts = torch.randint(0, 50257, (4, 128), generator=g, device="cuda")

    # sliding window, fp32: tokens must equal the plain-attention run
    fa.flash_fwd.launches = 0
    flash_tokens, dt32 = timed(lambda: model32.generate(long_prompts, new))
    launches32 = fa.flash_fwd.launches
    plain_model = GPT(gpt2_config("einsum", "float32"), params, device="cuda")
    plain_tokens, dt32_plain = timed(lambda: plain_model.generate(long_prompts, new))
    check(fa.flash_fwd.launches == launches32, "plain attention launched the kernel")
    check(flash_tokens.shape == (4, 1000 + new), f"tokens {tuple(flash_tokens.shape)}")
    check(launches32 == new * n_layer,
          f"sliding fp32: {launches32} launches, want {new * n_layer}")
    same = bool(torch.equal(flash_tokens, plain_tokens))
    emit({"phase": "generate_sliding_fp32", "batch": 4, "prompt": 1000,
          "new_tokens": new, "launches": launches32,
          "tokens_equal_plain": same, "tokens_per_s": 4 * new / dt32,
          "plain_tokens_per_s": 4 * new / dt32_plain, "card": card})
    check(same, "sliding fp32: kernel and plain-attention tokens differ")

    # the main path: sliding window in the default bf16 compute dtype
    model16 = GPT(gpt2_config("flash", "bfloat16"), params, device="cuda")
    fa.flash_fwd.launches = 0
    tokens16, dt16 = timed(lambda: model16.generate(long_prompts, new))
    main_launches = fa.flash_fwd.launches
    check(tokens16.shape == (4, 1000 + new), f"tokens {tuple(tokens16.shape)}")
    check(bool(((tokens16 >= 0) & (tokens16 < 50257)).all()), "bad token ids")
    check(torch.equal(tokens16[:, :1000], long_prompts), "prompt not kept")
    check(main_launches == new * n_layer,
          f"main path: {main_launches} launches, want {new * n_layer}")
    emit({"phase": "generate_sliding_bf16", "main_path": True, "batch": 4,
          "prompt": 1000, "new_tokens": new, "launches": main_launches,
          "tokens_per_s": 4 * new / dt16, "seconds": dt16, "card": card})

    # KV-cached decode: no kernel runs (the JAX package's decode runs none)
    for dtype, model in (("float32", model32), ("bfloat16", model16)):
        fa.flash_fwd.launches = 0
        cached, dtc = timed(lambda: model.generate(short_prompts, new))
        check(fa.flash_fwd.launches == 0, f"cached {dtype}: kernel launched")
        check(cached.shape == (4, 128 + new), f"cached {tuple(cached.shape)}")
        rec = {"phase": f"generate_cached_{dtype}", "batch": 4, "prompt": 128,
               "new_tokens": new, "launches": 0,
               "tokens_per_s": 4 * new / dtc, "card": card}
        if dtype == "float32":
            # reference: greedy re-forward of the whole growing sequence
            seq = short_prompts
            with torch.no_grad():
                for _ in range(new):
                    logits, _ = model(seq)
                    seq = torch.cat([seq, logits[:, -1].argmax(-1)[:, None]], 1)
            rec["tokens_equal_reforward"] = bool(torch.equal(seq, cached))
            emit(rec)
            check(rec["tokens_equal_reforward"],
                  "cached fp32 decode differs from the full re-forward")
        else:
            emit(rec)
    return main_launches


def phase_sample(fa, card):
    """The sample entry point on the repo's default sampling run: the
    gpt2_config.yaml data section (char vocabulary, block 128), GPT-2 width,
    200 new tokens, so the run slides the window past 128 tokens."""
    from mingpt_distributed_tpu_torch.config import DataConfig, ExperimentConfig
    from mingpt_distributed_tpu_torch.sample import sample_text

    exp = ExperimentConfig(
        gpt_config=gpt2_config("flash", "bfloat16"),
        data_config=DataConfig.make(path=os.path.join(REPO, "data", "input.txt"),
                                    block_size=128, truncate=0.05))
    fa.flash_fwd.launches = 0
    text, dt = timed(lambda: sample_text(exp, prompt="\n", max_new_tokens=200,
                                         seed=0, device="cuda"))
    emit({"phase": "sample_cli", "chars": len(text),
          "launches": fa.flash_fwd.launches, "seconds": dt, "card": card})
    check(len(text) == 201, f"sample: {len(text)} chars, want 201")
    check(fa.flash_fwd.launches == 200 * 12, "sample: want 2400 launches")


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------


def phase_times(fa, kernel_inputs, card):
    rows = {}
    b, t, h, hd = 4, 1024, 12, 64
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, err = kernel_inputs[("gpt2_main", dtype)]
        scale = 1.0 / math.sqrt(hd)
        n0 = fa.flash_fwd.launches
        ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, scale=scale))
        fa.flash_fwd.launches = n0  # timing launches are not the main path's
        plain_ms = cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, scale=scale),
                           iters=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        nbytes, flops = attention_work(b, t, h, hd, None, dtype)
        bms, by = bound_ms(nbytes, flops, dtype)
        dt = str(dtype).replace("torch.", "")
        rows[dtype] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                       "bound_by": by, "library_ms": library_ms,
                       "max_abs_err": err}
        emit({"phase": "time", "kernel": "flash_fwd", "dtype": dt,
              "shape": [b, t, h, h, hd], "bytes": nbytes, "flops": flops,
              **rows[dtype], "achieved_tflops": flops / (ms * 1e-3) / 1e12,
              "card": card})
    emit({"phase": "memory", "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
          "card": card})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    from mingpt_distributed_tpu_torch.models.api import GPT
    from mingpt_distributed_tpu_torch.ops import _build
    from mingpt_distributed_tpu_torch.ops import flash_attention as fa

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "setup", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})
    t0 = time.perf_counter()
    log = _build.build("flash_fwd", ptxas_verbose=True)
    emit({"phase": "build", "sources": ["flash_fwd"],
          "seconds": time.perf_counter() - t0})
    print(f"--- nvcc flash_fwd.cu ---\n{log}", file=sys.stderr)

    kernel_inputs = phase_kernels(fa)
    emit({"phase": "kernels_checked", "kernels": [
        {"name": "flash_fwd", "launches": fa.flash_fwd.launches}]})

    model32 = GPT(gpt2_config("flash", "float32"), seed=0, device="cuda")
    phase_forward(GPT, fa, model32)
    main_launches = phase_generate(GPT, fa, model32, card)
    phase_sample(fa, card)
    rows = phase_times(fa, kernel_inputs, card)

    bf16 = rows[torch.bfloat16]
    print(card_line(), flush=True)
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "mingpt_distributed_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "mingpt_distributed_tpu/ops/flash_attention.py:677",
        "launches": main_launches, **bf16}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
