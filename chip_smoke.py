#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, in parallel), holds each against its plain PyTorch version on
the card, drives the port's inference and training paths at GPT-2 124M width
(random weights, fixed seeds) through the entry points a user calls, checks
that each path went through the kernels, and times them. Imports nothing of
JAX. Prints JSON lines as it goes; any failed check raises, so the exit
code is non-zero and the final line is never printed.

Phases:
  0. setup: the card's name and power limit, TF32 off, the kernel builds;
  1. every kernel against its plain version at the main paths' shapes
     (generation at batch 4, the train step at batch 16) and the edge cases
     (GQA, a window narrower than a tile, softcap, ragged T): the forward
     (flash_fwd) and the backward (flash_bwd: dq and dk/dv);
  2. the GPT forward at GPT-2 124M width: flash kernel vs plain attention;
     the GPT gradients through the kernels vs plain attention;
  3. generation at the same width: sliding window (one forward kernel launch
     per layer per token) and KV-cached decode (no kernel), then the sample
     entry point;
  4. training, this slice's main path: the train step at the bench shape
     (GPT-2 124M, T=1024, batch 16, bf16, no dropout), 12 forward, 12 dq and
     12 dk/dv launches per step; then the train entry point on the corpus
     (loss falls, eval, snapshot, resume);
  5. times: kernels, plain versions, bounds and library yardsticks; peak
     device memory.
The last three lines are the card, the kernels line and the ok line.
Exits 2 without CUDA, 1 on any failure.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

from mingpt_distributed_tpu_torch.training.metrics import H100_SXM

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (the port's table, training/metrics.py): the
# bound of a kernel is the larger of its bytes over the memory rate and its
# operations over the peak rate of its input type.
HBM_BYTES_PER_S = H100_SXM["hbm_bytes_per_s"]
PEAK_FLOPS = {torch.bfloat16: H100_SXM["bfloat16"],
              torch.float32: H100_SXM["float32"]}

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
# Backward kernels vs flash_bwd_plain, on the same q, k, v, out, lse, dO
# (out and lse from flash_fwd_plain), for each of dq, dk, dv:
#  bf16: max |diff| <= 2^-7 * max(1, max |g|): one bf16 step at the largest
#        gradient (8 significant bits: a value in [2^e, 2^(e+1)) has a step
#        of 2^(e-7) <= 2^-7 |g|). The output is rounded to bf16 and the
#        kernel rounds P and dS to bf16 before its products (relative 2^-9
#        per term, partly cancelling over the sum), so a value can land one
#        step from the plain version's. Mean |diff| / mean |g| <= 1e-2
#        (the forward's: expected 2e-3..4e-3).
#  fp32: float32 sums in different orders and exp2 vs exp of the same
#        exponent (~1e-7 relative per operation over up to T terms): max
#        |diff| 1e-4, mean |diff| / mean |g| 1e-5.
# The mean ratio is held where the gradient is not zero: at T=1, dq and dk
# are exactly 0 (one key: p = 1 and dp = delta), both versions return
# rounding noise (max |g| < 1e-5) and only the max is held.
GRAD_TOL_X = {torch.bfloat16: 2.0 ** -7}
GRAD_TOL = {torch.float32: 1e-4}
GRAD_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
ZERO_GRAD_MAX = 1e-5
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
# GPT-2 gradients (T=1024, batch 2, loss-only mode), every parameter:
#  fp32: kernels vs plain attention, ||dg|| / ||g|| <= 1e-4 per parameter:
#        float32 sums in other orders, carried back through 12 layers
#        (expected 1e-6..1e-5). Not for blocks/bk, whose gradient is 0 in
#        exact arithmetic (a key bias adds the same q.b to every score of a
#        row, which the softmax ignores), so both paths return rounding
#        noise (first card run: relative "error" 1.79); it is held, with
#        every other parameter, by ||dg|| / ||g|| <= 1e-4 over the whole
#        gradient;
#  bf16: the kernel path's mean |g - g_fp32| over all parameters, against
#        the fp32 plain path's gradients, may exceed the plain bf16 path's
#        by at most 25% (the forward's gate).
GRAD_FP32_REL_TOL = 1e-4
ZERO_GRAD_PARAMS = ("blocks/bk",)
GRAD_BF16_ERR_RATIO = 1.25
# The train entry point on the corpus at GPT-2 width (block 1024, batch 16,
# no dropout): over its first 30 steps the loss must fall by at least 0.5
# (step 1 sits near ln(vocab) ~ 4.2; character statistics alone take it
# under 3.3).
ENTRY_STEPS = 30
ENTRY_LOSS_DROP = 0.5


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

# name, B, T, H, KV, hd, window, softcap; gpt2_train is the shape the
# training main path (the bench-shape train step) gives every kernel
KERNEL_CASES = [
    ("gpt2_main", 4, 1024, 12, 12, 64, None, None),
    ("gqa_h8_kv2_hd128", 2, 512, 8, 2, 128, None, None),
    ("window16_t384", 2, 384, 12, 12, 64, 16, None),
    ("softcap50", 2, 512, 12, 12, 64, None, 50.0),
    ("ragged_t100", 2, 100, 12, 12, 64, None, None),
    ("ragged_t1", 2, 1, 12, 12, 64, None, None),
    ("hd16_t200", 2, 200, 4, 4, 16, None, None),
    ("hd32_gqa_window100_softcap30", 2, 300, 8, 4, 32, 100, 30.0),
    ("gpt2_train", 16, 1024, 12, 12, 64, None, None),
]


def make_qkv(b, t, h, kv, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, t, h, hd), generator=g, device="cuda")
    k = torch.randn((b, t, kv, hd), generator=g, device="cuda")
    v = torch.randn((b, t, kv, hd), generator=g, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def attention_work(b, t, h, hd, window, dtype, kernel="flash_fwd", kv=None):
    """(bytes, operations) a kernel must move and do, each input read once
    and each output written once, for every (query, allowed key) pair:
      flash_fwd:     reads q, k, v; writes out, lse (fp32); 2 products;
      flash_bwd_dq:  reads q, k, v, dO, lse, delta; writes dq; 3 products
                     (S, dP, dS K);
      flash_bwd_dkv: reads q, k, v, dO, lse, delta; writes dk, dv; 4
                     products (S, dP, P^T dO, dS^T Q);
    each product 2*hd operations per pair."""
    kv = h if kv is None else kv
    if window is None:
        pairs = t * (t + 1) // 2
    else:
        w = min(window, t)
        pairs = w * (w + 1) // 2 + (t - w) * w
    elem = torch.finfo(dtype).bits // 8
    q_elems = b * t * h * hd  # q, out, dO, dq
    kv_elems = b * t * kv * hd  # k, v, dk, dv
    vec = b * h * t * 4  # one float32 per (batch, head, query)
    if kernel == "flash_fwd":
        nbytes, products = (2 * q_elems + 2 * kv_elems) * elem + vec, 2
    elif kernel == "flash_bwd_dq":
        nbytes, products = (3 * q_elems + 2 * kv_elems) * elem + 2 * vec, 3
    else:
        nbytes, products = (2 * q_elems + 4 * kv_elems) * elem + 2 * vec, 4
    return nbytes, 2 * products * b * h * hd * pairs


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
            results[(name, dtype)] = err
    return results


def bwd_kernel_errors(fa, q, k, v, do, *, scale, window, softcap):
    """Run both backward kernels and their plain version on the same
    inputs; return each gradient's max and mean relative difference."""
    out, lse = fa.flash_fwd_plain(q, k, v, scale=scale, window=window,
                                  softcap=softcap)
    got = fa.flash_bwd(q, k, v, out, lse, do, scale=scale, window=window,
                       softcap=softcap)
    torch.cuda.synchronize()
    want = fa.flash_bwd_plain(q, k, v, out, lse, do, scale=scale,
                              window=window, softcap=softcap)
    errs = {}
    for name, g, r, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        check(g.shape == x.shape and g.dtype == x.dtype,
              f"{name} {tuple(g.shape)} {g.dtype}")
        check(bool(torch.isfinite(g.float()).all()), f"non-finite {name}")
        diff = (g.float() - r.float()).abs()
        errs[f"{name}_max_abs_err"] = diff.max().item()
        errs[f"{name}_mean_rel_err"] = (
            diff.mean() / r.float().abs().mean().clamp_min(1e-30)).item()
        errs[f"{name}_max_abs"] = r.float().abs().max().item()
    return errs


def grad_tol(dtype, max_abs):
    if dtype in GRAD_TOL_X:
        return GRAD_TOL_X[dtype] * max(1.0, max_abs)
    return GRAD_TOL[dtype]


def bwd_case(fa, i, case, dtype):
    """Backward check case ``i`` of KERNEL_CASES in ``dtype``: its record
    (errors and tolerances) and the (gradient, message) of every check it
    fails."""
    name, b, t, h, kv, hd, window, cap = case
    q, k, v = make_qkv(b, t, h, kv, hd, dtype, seed=200 + i)
    g = torch.Generator(device="cuda").manual_seed(300 + i)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    errs = bwd_kernel_errors(fa, q, k, v, do, scale=1.0 / math.sqrt(hd),
                             window=window, softcap=cap)
    dt = str(dtype).replace("torch.", "")
    tols = {g: grad_tol(dtype, errs[f"{g}_max_abs"]) for g in ("dq", "dk", "dv")}
    rec = {"phase": "kernel_check", "kernel": "flash_bwd", "case": name,
           "dtype": dt, "shape": [b, t, h, kv, hd], "window": window,
           "softcap": cap, **errs, **{f"{g}_tol": tol for g, tol in tols.items()},
           "rel_tol": GRAD_REL_TOL[dtype]}
    fails = []
    for grad in ("dq", "dk", "dv"):
        err = errs[f"{grad}_max_abs_err"]
        rel = errs[f"{grad}_mean_rel_err"]
        if not err <= tols[grad]:
            fails.append((grad, f"{name} {dt}: max |{grad} diff| {err} > "
                                f"{tols[grad]}"))
        if not (errs[f"{grad}_max_abs"] < ZERO_GRAD_MAX
                or rel <= GRAD_REL_TOL[dtype]):
            fails.append((grad, f"{name} {dt}: mean |{grad} diff| / mean "
                                f"|{grad}| {rel} > {GRAD_REL_TOL[dtype]}"))
    return rec, fails


def phase_bwd_kernels(fa):
    """flash_bwd's two kernels against flash_bwd_plain on the forward's
    shapes; returns the records by (case, dtype)."""
    results = {}
    for i, case in enumerate(KERNEL_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            rec, fails = bwd_case(fa, i, case, dtype)
            emit(rec)
            check(not fails, "; ".join(msg for _, msg in fails))
            results[(case[0], dtype)] = rec
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


def phase_grads(fa, params32, card):
    """Every parameter's gradient through the kernels against plain
    attention, in the trainer's loss-only mode at T=1024, batch 2."""
    from mingpt_distributed_tpu_torch.models import convert, gpt
    from mingpt_distributed_tpu_torch.training.trainer import trainable

    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, 50257, (2, 1025), generator=g, device="cuda")
    x, y = tokens[:, :-1], tokens[:, 1:]

    def grads(attention, dtype):
        cfg = gpt2_config(attention, dtype)
        params = trainable(params32)
        names, leaves = zip(*convert.flatten(params).items())
        _, loss = gpt.forward(params, x, cfg, targets=y, return_logits=False)
        return loss.item(), dict(zip(names, torch.autograd.grad(loss, leaves)))

    n0 = (fa.flash_fwd.launches, fa.flash_bwd.dq_launches,
          fa.flash_bwd.dkv_launches)
    loss_f32, flash32 = grads("flash", "float32")
    n1 = (fa.flash_fwd.launches, fa.flash_bwd.dq_launches,
          fa.flash_bwd.dkv_launches)
    check(tuple(b - a for a, b in zip(n0, n1)) == (12, 12, 12),
          f"fp32 gradient: launches {n0} -> {n1}, want 12 of each")
    loss_p32, plain32 = grads("einsum", "float32")
    check(all(bool(torch.isfinite(v).all()) for v in flash32.values()),
          "non-finite fp32 gradient")
    rel = {n: ((flash32[n] - plain32[n]).norm() /
               plain32[n].norm().clamp_min(1e-30)).item()
           for n in plain32 if n not in ZERO_GRAD_PARAMS}
    worst = max(rel, key=rel.get)
    total_rel = (torch.stack([(flash32[n] - plain32[n]).norm() for n in plain32]).norm()
                 / torch.stack([plain32[n].norm() for n in plain32]).norm()).item()
    zero_norms = {n: (plain32[n].norm().item(), flash32[n].norm().item())
                  for n in ZERO_GRAD_PARAMS if n in plain32}

    def mean_err(gs):
        num = sum((gs[n] - plain32[n]).abs().sum() for n in plain32)
        den = sum(plain32[n].abs().sum() for n in plain32)
        return (num / den).item()

    _, flash16 = grads("flash", "bfloat16")
    err_flash16 = mean_err(flash16)
    del flash16
    _, plain16 = grads("einsum", "bfloat16")
    err_plain16 = mean_err(plain16)
    del plain16
    rec = {"phase": "gradients", "model": "gpt2 124M", "batch": 2, "seq": 1024,
           "fp32_loss_flash": loss_f32, "fp32_loss_plain": loss_p32,
           "fp32_max_rel_grad_err": rel[worst], "fp32_worst_param": worst,
           "fp32_total_rel_grad_err": total_rel,
           "fp32_zero_grad_norms_plain_flash": zero_norms,
           "fp32_max_grad_norm": max(v.norm().item() for v in plain32.values()),
           "fp32_rel_tol": GRAD_FP32_REL_TOL,
           "bf16_flash_mean_rel_err_vs_fp32": err_flash16,
           "bf16_plain_mean_rel_err_vs_fp32": err_plain16,
           "bf16_err_ratio": err_flash16 / err_plain16,
           "bf16_err_ratio_max": GRAD_BF16_ERR_RATIO, "card": card}
    emit(rec)
    check(rel[worst] <= GRAD_FP32_REL_TOL,
          f"fp32 gradient of {worst} differs by {rel[worst]} (relative)")
    check(total_rel <= GRAD_FP32_REL_TOL,
          f"fp32 gradient differs by {total_rel} (relative, all parameters)")
    check(err_flash16 <= GRAD_BF16_ERR_RATIO * err_plain16,
          "bf16 kernel-path gradients are further from fp32 than allowed")


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------


def reset_counts(fa):
    fa.flash_fwd.launches = 0
    fa.flash_bwd.dq_launches = 0
    fa.flash_bwd.dkv_launches = 0


def read_counts(fa):
    return {"flash_fwd": fa.flash_fwd.launches,
            "flash_bwd_dq": fa.flash_bwd.dq_launches,
            "flash_bwd_dkv": fa.flash_bwd.dkv_launches}


def phase_train_step(fa, card, steps=5):
    """The main path: make_train_step at the bench shape. Returns the
    launch counts of the measured steps."""
    from mingpt_distributed_tpu_torch.tools.profile_train import BATCH, SEQ, bench_state
    from mingpt_distributed_tpu_torch.training.metrics import flops_per_token
    from mingpt_distributed_tpu_torch.training.trainer import make_train_step

    cfg, state, batch = bench_state()
    step = make_train_step(cfg)
    losses = [step(state, batch)["loss"] for _ in range(2)]  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    counts = read_counts(fa)
    losses = [v.item() for v in losses]
    tokens_per_s = BATCH * SEQ / dt
    rec = {"phase": "train_step", "main_path": True, "model": "gpt2 124M",
           "batch": BATCH, "seq": SEQ, "dtype": cfg.dtype, "steps": steps,
           "launches": counts, "step_ms": dt * 1e3, "tokens_per_s": tokens_per_s,
           "mfu": flops_per_token(cfg, SEQ) * tokens_per_s / PEAK_FLOPS[torch.bfloat16],
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "losses": losses, "grad_norm": m["grad_norm"].item(),
           "update_norm": m["update_norm"].item(), "card": card}
    emit(rec)
    for name, n in counts.items():
        check(n == 12 * steps, f"train step: {n} {name} launches, want {12 * steps}")
    check(all(math.isfinite(v) for v in losses), "non-finite training loss")
    check(losses[-1] < losses[0], "the loss on a repeated batch did not fall")
    del state, batch
    torch.cuda.empty_cache()
    return counts


def run_entry(argv):
    """The train entry point's main(argv), its stdout captured and echoed."""
    from mingpt_distributed_tpu_torch.train import main as train_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_main(argv)
    out = buf.getvalue()
    sys.stderr.write(out)
    return rc, out


def phase_train_entry(fa, card):
    """python -m mingpt_distributed_tpu_torch.train, driven through main():
    GPT-2 width on the corpus, then a second call that resumes."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        snap = os.path.join(tmp, "snapshot.pt")
        argv = ["--config", os.path.join(REPO, "gpt2_config.yaml"),
                "gpt_config.model_type=gpt2", "~gpt_config.n_layer",
                "~gpt_config.n_head", "~gpt_config.n_embd",
                "gpt_config.attn_pdrop=0", "gpt_config.embd_pdrop=0",
                "gpt_config.resid_pdrop=0",
                f"data_config.path={os.path.join(REPO, 'data', 'input.txt')}",
                "data_config.block_size=1024", "data_config.truncate=1.0",
                "trainer_config.batch_size=16", "trainer_config.log_every=1",
                "trainer_config.eval_batches=4",
                f"trainer_config.snapshot_path={snap}"]
        reset_counts(fa)
        t0 = time.perf_counter()
        rc, out = run_entry(argv + [f"trainer_config.max_steps={ENTRY_STEPS}"])
        dt = time.perf_counter() - t0
        counts = read_counts(fa)
        losses = {int(a): float(b) for a, b in
                  re.findall(r"^step (\d+) \| loss ([0-9.e+-]+)", out, re.M)}
        evals = re.findall(r"eval_loss ([0-9.e+-]+)", out)
        check(rc == 0, f"train entry point exited {rc}")
        check(sorted(losses) == list(range(1, ENTRY_STEPS + 1)),
              f"logged steps {sorted(losses)}")
        drop = losses[1] - losses[ENTRY_STEPS]
        rc2, out2 = run_entry(argv + [f"trainer_config.max_steps={ENTRY_STEPS + 5}"])
        resumed = f"Resuming training from snapshot at epoch 0, step {ENTRY_STEPS}"
        losses2 = re.findall(r"^step (\d+) \| loss", out2, re.M)
        emit({"phase": "train_cli", "steps": ENTRY_STEPS, "seconds": dt,
              "launches": counts, "loss_first": losses[1],
              "loss_last": losses[ENTRY_STEPS], "loss_drop": drop,
              "loss_drop_min": ENTRY_LOSS_DROP,
              "eval_loss": float(evals[-1]) if evals else None,
              "snapshot_written": os.path.exists(snap),
              "resume_rc": rc2, "resumed_at_saved_step": resumed in out2,
              "resumed_steps": [int(v) for v in losses2], "card": card})
        check(drop >= ENTRY_LOSS_DROP, f"loss fell by {drop} < {ENTRY_LOSS_DROP}")
        check(len(evals) == 1 and math.isfinite(float(evals[0])), "no eval loss")
        check(os.path.exists(snap), "no snapshot written")
        check(counts["flash_bwd_dq"] == 12 * ENTRY_STEPS,
              f"train entry: {counts} launches")
        check(rc2 == 0 and resumed in out2, "second call did not resume")
        check([int(v) for v in losses2] == list(range(ENTRY_STEPS + 1, ENTRY_STEPS + 6)),
              f"resumed run logged steps {losses2}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------


def sdpa_backward(q, k, v, do):
    """The library yardstick: the gradient of scaled_dot_product_attention
    (is_causal) with respect to q, k, v; backward only."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)


def phase_times(fa, card):
    """Kernel, plain version and library yardstick times; returns the rows
    of the kernels line (bf16, training shape) by kernel name."""
    rows = {}
    # the generation shape: flash_fwd at batch 4
    b, t, h, hd = 4, 1024, 12, 64
    scale = 1.0 / math.sqrt(hd)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = make_qkv(b, t, h, h, hd, dtype, seed=100)  # gpt2_main's
        with preserved_counts(fa):
            ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, scale=scale))
        nbytes, flops = attention_work(b, t, h, hd, None, dtype)
        bms, by = bound_ms(nbytes, flops, dtype)
        emit({"phase": "time", "kernel": "flash_fwd", "shape_of": "generation",
              "dtype": str(dtype).replace("torch.", ""), "shape": [b, t, h, h, hd],
              "ms": ms, "bound_ms": bms, "bound_by": by,
              "achieved_tflops": flops / (ms * 1e-3) / 1e12, "card": card})
    # the training shape: batch 16
    b = 16
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).replace("torch.", "")
        q, k, v = make_qkv(b, t, h, h, hd, dtype, seed=400)
        g = torch.Generator(device="cuda").manual_seed(401)
        do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
        with preserved_counts(fa):
            out, lse = fa.flash_fwd(q, k, v, scale=scale)
            delta = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
            fwd_ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, scale=scale))
            dq_ms = cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, scale=scale))
            dkv_ms = cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                      scale=scale))
        fwd_plain = cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, scale=scale), iters=3)
        bwd_plain = cuda_ms(lambda: fa.flash_bwd_plain(q, k, v, out, lse, do,
                                                       scale=scale), iters=3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        fwd_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        bwd_lib = cuda_ms(sdpa_backward(q, k, v, do))
        for name, ms, plain, lib in (("flash_fwd", fwd_ms, fwd_plain, fwd_lib),
                                     ("flash_bwd_dq", dq_ms, bwd_plain, bwd_lib),
                                     ("flash_bwd_dkv", dkv_ms, bwd_plain, bwd_lib)):
            nbytes, flops = attention_work(b, t, h, hd, None, dtype, kernel=name)
            bms, by = bound_ms(nbytes, flops, dtype)
            row = {"ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                   "library_ms": lib}
            emit({"phase": "time", "kernel": name, "shape_of": "training",
                  "dtype": dt, "shape": [b, t, h, h, hd], "bytes": nbytes,
                  "flops": flops, **row,
                  "achieved_tflops": flops / (ms * 1e-3) / 1e12,
                  "plain_is": "flash_bwd_plain (dq, dk and dv)" if name != "flash_fwd"
                  else "flash_fwd_plain",
                  "library_is": "SDPA backward (dq, dk and dv)" if name != "flash_fwd"
                  else "SDPA forward", "card": card})
            if dtype == torch.bfloat16:
                rows[name] = row
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    emit({"phase": "memory", "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
          "card": card})
    return rows


@contextlib.contextmanager
def preserved_counts(fa):
    """Launches made to time or compare a kernel are not the main path's."""
    saved = read_counts(fa)
    try:
        yield
    finally:
        fa.flash_fwd.launches = saved["flash_fwd"]
        fa.flash_bwd.dq_launches = saved["flash_bwd_dq"]
        fa.flash_bwd.dkv_launches = saved["flash_bwd_dkv"]


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
    logs = _build.build_all(ptxas_verbose=True)
    emit({"phase": "build", "sources": list(logs),
          "seconds": time.perf_counter() - t0})
    for name, log in logs.items():
        print(f"--- nvcc {name}.cu ---\n{log}", file=sys.stderr)

    fwd_errors = phase_kernels(fa)
    bwd_errors = phase_bwd_kernels(fa)
    emit({"phase": "kernels_checked", "kernels": [
        {"name": n, "launches": c} for n, c in read_counts(fa).items()]})
    reset_counts(fa)

    model32 = GPT(gpt2_config("flash", "float32"), seed=0, device="cuda")
    phase_forward(GPT, fa, model32)
    phase_grads(fa, model32.params, card)
    generate_launches = phase_generate(GPT, fa, model32, card)
    phase_sample(fa, card)
    del model32
    torch.cuda.empty_cache()

    main_counts = phase_train_step(fa, card)
    phase_train_entry(fa, card)
    rows = phase_times(fa, card)

    # max_abs_err at the main path's shape: the training step's, bf16
    bf16 = torch.bfloat16
    errs = bwd_errors[("gpt2_train", bf16)]
    line = []
    for name, replaces, err in (
            ("flash_fwd", "mingpt_distributed_tpu/ops/flash_attention.py:677",
             fwd_errors[("gpt2_train", bf16)]),
            ("flash_bwd_dq", "mingpt_distributed_tpu/ops/flash_attention.py:750",
             errs["dq_max_abs_err"]),
            ("flash_bwd_dkv", "mingpt_distributed_tpu/ops/flash_attention.py:818",
             max(errs["dk_max_abs_err"], errs["dv_max_abs_err"]))):
        source = "flash_fwd.cu" if name == "flash_fwd" else "flash_bwd.cu"
        line.append({"name": name, "route": "cuda",
                     "source": f"mingpt_distributed_tpu_torch/ops/csrc/{source}",
                     "replaces": replaces, "launches": main_counts[name],
                     "max_abs_err": err, **rows[name]})
    emit({"phase": "launches_by_path", "train_step": main_counts,
          "generate_sliding_bf16": {"flash_fwd": generate_launches}})
    print(card_line(), flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
