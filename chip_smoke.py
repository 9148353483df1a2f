#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, in parallel), holds each against its plain PyTorch version on
the card, drives the port's inference, training and sequence-parallel
training paths at GPT-2 124M width (random weights, fixed seeds) through the
entry points a user calls, checks that each path went through the kernels,
and times them. Imports nothing of JAX. Prints JSON lines as it goes; any
failed check raises, so the exit code is non-zero and the final line is
never printed.

Phases:
  0. setup: the card's name and power limit, TF32 off, the kernel builds;
     ptxas's registers, spills and dynamic shared memory per forward and
     backward kernel (fwd_ptxas, bwd_ptxas) and each library's SASS
     (fwd_sass, bwd_sass: every bf16 forward, dq and dk/dv instantiation,
     K2c's four among them, issues HGMMA and UTMALDG, none HMMA);
  1. every kernel against its plain version at the main paths' shapes
     (generation at batch 4, the train step at batch 16, the sp path's
     zigzag hop, the prototype tool's shape) and the edge cases (GQA, a
     window narrower than a tile, softcap, ragged T), and the bf16
     kernels' rings of tiles at every head width (FWD_RING_CASES,
     BWD_RING_CASES, LSE_RING_CASES and NH_CASES: T = 1, 63, 65, ... 4096,
     strided q/k/v views of one qkv projection, GQA 12/4, offset bands,
     softcap): the forward (flash_fwd), the backward's prep pass
     (flash_bwd_prep: delta with and without an lse cotangent, K2c's dq
     zeroed) and the backward (flash_bwd: dq and dk/dv); the fused
     backward (flash_bwd_fused, K2c) against the plain version and against
     K2a/K2b; the ring's forward with lse (flash_lse_fwd: causal flag,
     q_offset, dead rows) and its backward with an lse cotangent
     (flash_lse_bwd: dq and dk/dv); the per-head-grid prototype's
     natural-base kernels (nh_fwd, nh_bwd_dq, nh_bwd_dkv: K5); the
     exp-vs-exp2 chain (exp_chain: K6) for each op at reps 1, 2, 5 and 64
     on a ragged shape and the tool's;
  2. the GPT forward at GPT-2 124M width: flash kernel vs plain attention;
     the GPT gradients through the kernels vs plain attention, fp32, with
     the split backward and with FLASH_FUSED_BWD=1;
  3. generation at the same width: sliding window (one forward kernel launch
     per layer per token) and KV-cached decode (no kernel), then the sample
     entry point;
  4. training: the train step at the bench shape (GPT-2 124M, T=1024, batch
     16, bf16, no dropout), 12 forward, 12 prep, 12 dq and 12 dk/dv
     launches per step; the same step with FLASH_FUSED_BWD=1, 12 forward,
     12 prep and 12 fused launches per step (K2c's path); then the train
     entry point on the corpus (loss falls, eval, snapshot, resume);
  4b. sequence parallel: 4 ranks spawned on the one card over gloo: ring
     and Ulysses attention at GPT-2 width (T=4096) against dense plain
     attention; the sp = 4 ring train step at full GPT-2 width, block 4096,
     global batch 4 (exactly 72 K3, 72 prep, 72 K4a and 72 K4b launches per
     rank per step), its loss against a single-process dense-attention
     step; a dp = 2 x sp = 2 Ulysses step at 2 layers;
  4c. the prototype tool (tools/proto_nh_kernel.py, K5's path) at its shape
     (B=16, T=1024, H=12, hd=64, bf16): its parity and time lines;
  5. times: kernels, plain versions, bounds and library yardsticks (K1 at
     the generation shape also its wrapper's host microseconds per launch);
     the prep pass with and without K2c's dq zero-fill; the whole fused
     backward (prep, K2c, cast) beside the split one (prep, K2a, K2b); peak
     device memory; then the exp-vs-exp2 tool (tools/exp_exp2.py, K6's
     path) through its main() at its shape (64 x 512 x 512 float32, 64
     reps), 64 reps timed against 32, and the opcodes of K6's compiled
     kernels. The SM clock, power and
     throttle reasons are logged before and after.
The last three lines are the card, the kernels line (twelve kernels) and the
ok line. Exits 2 without CUDA, 1 on any failure.
"""

from __future__ import annotations

import contextlib
import importlib
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

from mingpt_distributed_tpu_torch.tools.bwd_times import dq_f32_bytes
from mingpt_distributed_tpu_torch.training.metrics import (
    H100_SXM,
    roofline_ms,
    sfu_exp_rate,
)

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (the port's table, training/metrics.py): the
# bound of a kernel is the largest of its bytes over the memory rate, its
# products over the peak rate of their input type and its exponentials over
# the special-function units' rate at the card's max SM clock.
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
# The fused backward (K2c) against the split kernels (K2a/K2b) on the same
# inputs:
#  bf16: K2's own limits (GRAD_TOL_X, GRAD_REL_TOL): both round P and dS to
#        bf16 at the same points, the outputs to bf16, and sum in other
#        orders;
#  fp32: dk and dv come from the same code as K2b's (read equal to the
#        bit); dq is summed over the k tiles by float32 atomic adds in no
#        fixed order where K2a sums in registers (read: max |diff| <=
#        1.2e-6 over the cases, mean |diff| / mean |g| <= 2.7e-7): max
#        |diff| FUSED_SPLIT_TOL_FP32, about 10x the reading, mean 1e-5.
FUSED_SPLIT_TOL_FP32 = 1e-5
# The prep pass (flash_bwd_prep) against flash_bwd_prep_plain, delta per
# row: both sum hd <= 128 float32 products of the same inputs in other
# orders (each rounding <= 2^-24 of the running sum, so <= hd 2^-24 ~ 7.6e-6
# of the row's sum of |out * dO|) and subtract the same dlse: |diff| <=
# 1e-5 * max(1, sum |out * dO| + |dlse|). K2c's dq buffer, filled with NaN
# before, must come back exactly 0.
PREP_TOL = 1e-5
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


# Device cycles (~10 ms) the card is held busy before a timed run, so the
# host queues every call first and a kernel shorter than its host-side
# launch is timed back to back, not at the host's pace
HOLD_CYCLES = 20_000_000


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` back-to-back calls, queued
    behind a HOLD_CYCLES spin."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 20, batches: int = 11) -> float:
    """Host microseconds per call of fn: the median over ``batches`` of
    ``calls`` back-to-back calls each (the card runs behind; its queue does
    not fill), as the host's clock varies from batch to batch."""
    fn()
    per_call = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return sorted(per_call)[batches // 2]


@contextlib.contextmanager
def fused_switch(on: bool):
    """FLASH_FUSED_BWD set to "1" (on) or "0" inside the block, and put
    back as it was after it, failure or not."""
    saved = os.environ.get("FLASH_FUSED_BWD")
    os.environ["FLASH_FUSED_BWD"] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("FLASH_FUSED_BWD", None)
        else:
            os.environ["FLASH_FUSED_BWD"] = saved


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
# The bf16 forward's ring of k/v tiles (two stages of 128 keys) at every
# head width: one tile and its edges (T = 1, 63, 65), q/k/v as strided
# views of one qkv projection (T = 1000: 8 tiles), the ring wrapping 16
# times (T = 4096: 32 tiles), GQA 12/4 over an odd tile count (T = 1100: 9
# tiles), a window narrower than a tile (T = 640: 5 tiles). Forward only
# (phase_kernels); the last field is make_qkv's layout.
FWD_RING_CASES = [
    case for hd in (16, 32, 64, 128) for case in (
        (f"t1_hd{hd}", 2, 1, 4, 4, hd, None, None, "dense"),
        (f"t63_hd{hd}", 2, 63, 4, 4, hd, None, None, "dense"),
        (f"t65_hd{hd}", 2, 65, 4, 4, hd, None, None, "dense"),
        (f"t1000_qkv_view_hd{hd}", 2, 1000, 4, 4, hd, None, None, "qkv_view"),
        (f"t4096_hd{hd}", 1, 4096, 2, 2, hd, None, None, "dense"),
        (f"gqa12_4_t1100_hd{hd}", 1, 1100, 12, 4, hd, None, None, "dense"),
        (f"window50_t640_hd{hd}", 2, 640, 4, 4, hd, 50, None, "dense"),
    )
]


# The bf16 backward's rings (dq: two stages of 64 keys under items of 128
# query rows; dk/dv: two stages of 64-row Q/dO tiles under items of 128
# keys) at every head width: FWD_RING_CASES' shapes (one tile and its
# edges, strided q/k/v views of one qkv projection, the rings wrapping many
# times at T = 4096, GQA 12/4 over an odd tile count, a window narrower than
# a tile) and a softcap. Run by bwd_case (K2a/K2b) and fused_case (K2c).
BWD_RING_CASES = [
    case for hd in (16, 32, 64, 128) for case in (
        *((f"bwd_{c[0]}", *c[1:]) for c in FWD_RING_CASES if c[5] == hd),
        (f"bwd_softcap30_t300_hd{hd}", 2, 300, 4, 4, hd, None, 30.0, "dense"),
    )
]


def make_qkv(b, t, h, kv, hd, dtype, seed, layout="dense"):
    """q (B, T, H, hd), k and v (B, T, KV, hd) from ``seed``: dense, or with
    ``layout="qkv_view"`` strided views of one (B, T, 3, H, hd) tensor, as a
    fused qkv projection gives them (KV == H)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "qkv_view":
        assert kv == h, "qkv_view needs KV == H"
        x = torch.randn((b, t, 3, h, hd), generator=g, device="cuda").to(dtype)
        return x[:, :, 0], x[:, :, 1], x[:, :, 2]
    q = torch.randn((b, t, h, hd), generator=g, device="cuda")
    k = torch.randn((b, t, kv, hd), generator=g, device="cuda")
    v = torch.randn((b, t, kv, hd), generator=g, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def attention_work(b, t, h, hd, window, dtype, kernel="flash_fwd", kv=None,
                   causal=True):
    """(bytes, product operations, exponentials) a kernel must move and do,
    each input read once and each output written once; for every (query,
    allowed key) pair one exponential (the forward's P, which every backward
    kernel recomputes) and:
      flash_fwd, flash_lse_fwd, nh_fwd:  reads q, k, v; writes out, lse
                                 (fp32); 2 products;
      flash_bwd_dq, flash_lse_bwd_dq, nh_bwd_dq:  reads q, k, v, dO, lse,
                                 delta; writes dq; 3 products (S, dP, dS K);
      flash_bwd_dkv, flash_lse_bwd_dkv, nh_bwd_dkv:  reads q, k, v, dO, lse,
                                 delta; writes dk, dv; 4 products (S, dP,
                                 P^T dO, dS^T Q);
      flash_bwd_fused:           reads q, k, v, dO, lse, delta; writes dq,
                                 dk, dv; 5 products (S, dP, P^T dO, dS^T Q,
                                 dS K) (its float32 dq buffer is a cost of
                                 its design, not of the function:
                                 bwd_times.dq_f32_bytes);
      flash_bwd_prep:            prep_work's bytes and float32 operations
                                 (no exponential), without K2c's zero-fill;
    each product 2*hd operations per pair. Not causal: every pair."""
    if kernel == "flash_bwd_prep":
        return (*prep_work(b, t, h, hd, dtype), 0)
    kv = h if kv is None else kv
    if not causal:
        pairs = t * t
    elif window is None:
        pairs = t * (t + 1) // 2
    else:
        w = min(window, t)
        pairs = w * (w + 1) // 2 + (t - w) * w
    elem = torch.finfo(dtype).bits // 8
    q_elems = b * t * h * hd  # q, out, dO, dq
    kv_elems = b * t * kv * hd  # k, v, dk, dv
    vec = b * h * t * 4  # one float32 per (batch, head, query)
    if kernel.endswith("fwd"):
        nbytes, products = (2 * q_elems + 2 * kv_elems) * elem + vec, 2
    elif kernel.endswith("dq"):
        nbytes, products = (3 * q_elems + 2 * kv_elems) * elem + 2 * vec, 3
    elif kernel.endswith("fused"):
        nbytes, products = (3 * q_elems + 4 * kv_elems) * elem + 2 * vec, 5
    else:
        nbytes, products = (2 * q_elems + 4 * kv_elems) * elem + 2 * vec, 4
    return nbytes, 2 * products * b * h * hd * pairs, b * h * pairs


def prep_work(b, t, h, hd, dtype, zero_dq=False):
    """(bytes, float32 operations) of flash_bwd_prep: reads out and dO,
    writes delta (float32); with ``zero_dq`` also writes K2c's float32 dq
    buffer (its zero-fill); one multiply and one add per element."""
    elems = b * t * h * hd
    nbytes = 2 * elems * (torch.finfo(dtype).bits // 8) + b * h * t * 4
    return nbytes + (elems * 4 if zero_dq else 0), 2 * elems


def bound_ms(nbytes, flops, dtype, exps):
    return roofline_ms(nbytes, [(flops, PEAK_FLOPS[dtype]), (exps, sfu_exp_rate()[0])])


def kernel_errors(fa, q, k, v, *, scale, window, softcap):
    """Run the kernel and its plain version on the same inputs; return
    whether the kernel's out and lse are finite and the differences of their
    outputs and lse (or ``bad_shapes``)."""
    out, lse = fa.flash_fwd(q, k, v, scale=scale, window=window,
                            softcap=softcap)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_fwd_plain(q, k, v, scale=scale, window=window,
                                      softcap=softcap)
    b, t, h, _ = q.shape
    if out.shape != ref.shape or out.dtype != q.dtype or lse.shape != (b, h, t):
        return {"bad_shapes": f"out {tuple(out.shape)} {out.dtype}, "
                              f"lse {tuple(lse.shape)}"}
    diff = (out.float() - ref.float()).abs()
    return {"finite": bool(torch.isfinite(out.float()).all()
                           and torch.isfinite(lse).all()),
            "max_abs_err": diff.max().item(),
            "mean_rel_err": (diff.mean() / ref.float().abs().mean().clamp_min(
                1e-30)).item(),
            "lse_max_abs_err": (lse - ref_lse).abs().max().item()}


def fwd_case(fa, i, case, dtype):
    """Case ``i`` of KERNEL_CASES + FWD_RING_CASES in ``dtype``: K1
    (flash_fwd) against flash_fwd_plain on the same inputs. Returns its
    record and the ("fwd", message) of every check it fails."""
    name, b, t, h, kv, hd, window, cap, *layout = case
    layout = layout[0] if layout else "dense"
    dt = str(dtype).replace("torch.", "")
    q, k, v = make_qkv(b, t, h, kv, hd, dtype, seed=100 + i, layout=layout)
    errs = kernel_errors(fa, q, k, v, scale=1.0 / math.sqrt(hd), window=window,
                         softcap=cap)
    rec = {"phase": "kernel_check", "kernel": "flash_fwd", "case": name,
           "dtype": dt, "shape": [b, t, h, kv, hd], "layout": layout,
           "window": window, "softcap": cap, **errs, "tol": OUT_TOL[dtype],
           "rel_tol": OUT_REL_TOL[dtype], "lse_tol": LSE_TOL}
    if "bad_shapes" in errs:
        return rec, [("fwd", f"{name} {dt}: {errs['bad_shapes']}")]
    fails = [] if errs["finite"] else [("fwd", f"{name} {dt}: non-finite out or lse")]
    if not errs["max_abs_err"] <= OUT_TOL[dtype]:
        fails.append(("fwd", f"{name} {dt}: max |out diff| {errs['max_abs_err']} > "
                             f"{OUT_TOL[dtype]}"))
    if not errs["mean_rel_err"] <= OUT_REL_TOL[dtype]:
        fails.append(("fwd", f"{name} {dt}: mean |out diff| / mean |out| "
                             f"{errs['mean_rel_err']} > {OUT_REL_TOL[dtype]}"))
    if not errs["lse_max_abs_err"] <= LSE_TOL:
        fails.append(("fwd", f"{name} {dt}: max |lse diff| "
                             f"{errs['lse_max_abs_err']} > {LSE_TOL}"))
    return rec, fails


def phase_kernels(fa):
    """K1 against its plain version on KERNEL_CASES and FWD_RING_CASES in
    both dtypes; returns max |out diff| by (case, dtype)."""
    results = {}
    for i, case in enumerate(KERNEL_CASES + FWD_RING_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            rec, fails = fwd_case(fa, i, case, dtype)
            emit(rec)
            check(not fails, "; ".join(msg for _, msg in fails))
            results[(case[0], dtype)] = rec["max_abs_err"]
    return results


def grad_check(got, want, xs, dtype, label, max_tol=None, prefix=""):
    """Each of (dq, dk, dv) ``got`` against ``want``: the record's errors
    and the (gradient, message) of every check it fails. max |diff| is held
    to ``max_tol``, or else to one bf16 step at the largest gradient (bf16)
    or GRAD_TOL (fp32); mean |diff| / mean |ref| to GRAD_REL_TOL where the
    gradient is not zero."""
    rec, fails = {}, []
    for name, g, r, x in zip(("dq", "dk", "dv"), got, want, xs):
        check(g.shape == x.shape and g.dtype == x.dtype,
              f"{label}: {name} {tuple(g.shape)} {g.dtype}")
        if not bool(torch.isfinite(g.float()).all()):
            fails.append((name, f"{label}: non-finite {name}"))
        diff = (g.float() - r.float()).abs()
        max_abs = r.float().abs().max().item()
        err = diff.max().item()
        rel = (diff.mean() / r.float().abs().mean().clamp_min(1e-30)).item()
        tol = grad_tol(dtype, max_abs) if max_tol is None else max_tol
        rec.update({f"{prefix}{name}_max_abs_err": err,
                    f"{prefix}{name}_mean_rel_err": rel,
                    f"{prefix}{name}_max_abs": max_abs, f"{prefix}{name}_tol": tol})
        if not err <= tol:
            fails.append((name, f"{label}: max |{name} diff| {err} > {tol}"))
        if not (max_abs < ZERO_GRAD_MAX or rel <= GRAD_REL_TOL[dtype]):
            fails.append((name, f"{label}: mean |{name} diff| / mean |{name}| "
                                f"{rel} > {GRAD_REL_TOL[dtype]}"))
    return rec, fails


def grad_tol(dtype, max_abs):
    if dtype in GRAD_TOL_X:
        return GRAD_TOL_X[dtype] * max(1.0, max_abs)
    return GRAD_TOL[dtype]


def _bwd_inputs(fa, i, case, dtype):
    """Case ``i`` of KERNEL_CASES + BWD_RING_CASES in ``dtype``: q, k, v, dO
    and the plain forward's out and lse, with the kernels' keyword
    arguments."""
    name, b, t, h, kv, hd, window, cap, *layout = case
    q, k, v = make_qkv(b, t, h, kv, hd, dtype, seed=200 + i,
                       layout=layout[0] if layout else "dense")
    g = torch.Generator(device="cuda").manual_seed(300 + i)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    kw = dict(scale=1.0 / math.sqrt(hd), window=window, softcap=cap)
    out, lse = fa.flash_fwd_plain(q, k, v, **kw)
    return (q, k, v, out, lse, do), kw


def bwd_case(fa, i, case, dtype):
    """Backward check case ``i`` of KERNEL_CASES + BWD_RING_CASES in
    ``dtype``: K2a and K2b (flash_bwd with the fused switch off) against
    flash_bwd_plain on the same inputs. Returns its record and the
    (gradient, message) of every check it fails."""
    name, b, t, h, kv, hd, window, cap, *layout = case
    args, kw = _bwd_inputs(fa, i, case, dtype)
    with fused_switch(False):
        got = fa.flash_bwd(*args, **kw)
    torch.cuda.synchronize()
    want = fa.flash_bwd_plain(*args, **kw)
    dt = str(dtype).replace("torch.", "")
    errs, fails = grad_check(got, want, args[:3], dtype, f"{name} {dt}")
    rec = {"phase": "kernel_check", "kernel": "flash_bwd", "case": name,
           "dtype": dt, "shape": [b, t, h, kv, hd],
           "layout": layout[0] if layout else "dense", "window": window,
           "softcap": cap, **errs, "rel_tol": GRAD_REL_TOL[dtype]}
    return rec, fails


def fused_case(fa, i, case, dtype):
    """The fused backward (K2c, flash_bwd_fused) on bwd_case's inputs:
    against flash_bwd_plain at K2's limits, and against K2a/K2b
    (``vs_split_*``: bf16 at K2's limits, fp32 within
    FUSED_SPLIT_TOL_FP32)."""
    name, b, t, h, kv, hd, window, cap, *layout = case
    args, kw = _bwd_inputs(fa, i, case, dtype)
    got = fa.flash_bwd_fused(*args, **kw)
    with fused_switch(False):
        split = fa.flash_bwd(*args, **kw)
    torch.cuda.synchronize()
    want = fa.flash_bwd_plain(*args, **kw)
    dt = str(dtype).replace("torch.", "")
    errs, fails = grad_check(got, want, args[:3], dtype, f"fused {name} {dt}")
    vs, vs_fails = grad_check(
        got, split, args[:3], dtype, f"fused vs split {name} {dt}",
        max_tol=FUSED_SPLIT_TOL_FP32 if dtype == torch.float32 else None,
        prefix="vs_split_")
    rec = {"phase": "kernel_check", "kernel": "flash_bwd_fused", "case": name,
           "dtype": dt, "shape": [b, t, h, kv, hd],
           "layout": layout[0] if layout else "dense", "window": window,
           "softcap": cap, **errs, **vs, "rel_tol": GRAD_REL_TOL[dtype]}
    return rec, fails + vs_fails


def prep_case(fa, i, case, dtype):
    """The prep pass (flash_bwd_prep) against flash_bwd_prep_plain on case
    ``i`` of KERNEL_CASES + BWD_RING_CASES in ``dtype``: delta from random
    out and dO, with an lse cotangent (the ring's K4 path) and without, the
    latter also zeroing a NaN-filled float32 dq (K2c's path). Returns its
    record and the ("delta" or "dq", message) of every check it fails."""
    name, b, t, h, kv, hd, *_ = case
    dt = str(dtype).replace("torch.", "")
    g = torch.Generator(device="cuda").manual_seed(1300 + i)
    out = torch.randn((b, t, h, hd), generator=g, device="cuda").to(dtype)
    do = torch.randn((b, t, h, hd), generator=g, device="cuda").to(dtype)
    dlse = torch.randn((b, h, t), generator=g, device="cuda")
    row_abs = (out.float() * do.float()).abs().sum(-1).transpose(1, 2)
    rec = {"phase": "kernel_check", "kernel": "flash_bwd_prep", "case": name,
           "dtype": dt, "shape": [b, t, h, hd], "tol": PREP_TOL}
    fails = []
    for key, cot in (("delta", None), ("delta_dlse", dlse)):
        dq = (torch.full(out.shape, float("nan"), device="cuda") if cot is None
              else None)
        got = fa.flash_bwd_prep(out, do, cot, dq=dq)
        torch.cuda.synchronize()
        want = fa.flash_bwd_prep_plain(out, do, cot)
        scale = (row_abs + (0 if cot is None else cot.abs())).clamp_min(1.0)
        rec[f"{key}_max_abs_err"] = (got - want).abs().max().item()
        rec[f"{key}_max_rel_err"] = ((got - want).abs() / scale).max().item()
        if not (got.shape == (b, h, t) and bool(torch.isfinite(got).all())
                and rec[f"{key}_max_rel_err"] <= PREP_TOL):
            fails.append(("delta", f"prep {name} {dt}: {key} {tuple(got.shape)}, "
                                   f"max |diff| / scale {rec[f'{key}_max_rel_err']}"))
        if dq is not None:
            rec["dq_zeroed"] = bool((dq == 0).all())
            if not rec["dq_zeroed"]:
                fails.append(("dq", f"prep {name} {dt}: dq not zeroed"))
    return rec, fails


def phase_bwd_kernels(fa, case_fn=bwd_case):
    """``case_fn`` (bwd_case: K2a/K2b; fused_case: K2c; prep_case: the prep
    pass) on every case of KERNEL_CASES and BWD_RING_CASES in both dtypes;
    returns the records by (case, dtype)."""
    results = {}
    for i, case in enumerate(KERNEL_CASES + BWD_RING_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            rec, fails = case_fn(fa, i, case, dtype)
            emit(rec)
            check(not fails, "; ".join(msg for _, msg in fails))
            results[(case[0], dtype)] = rec
    return results


# K3/K4 cases: name, B, T, H, KV, hd, causal, window, softcap, q_offset.
# zigzag_hop is the shape the sp main path (T=4096, sp=4, batch 4) gives
# every hop's batch-stacked call (the JAX layout's (2*B*H, 512, 64)), and
# zigzag_own its step-0 causal calls; the offset cases are the banded
# ring's boundary hops: a q chunk c after its k chunk with a window, rows
# dead in every tile, and an offset inside the band.
LSE_CASES = [
    ("zigzag_hop", 8, 512, 12, 12, 64, False, None, None, 0),
    ("zigzag_own", 4, 512, 12, 12, 64, True, None, None, 0),
    ("offset_c_window_dead_rows", 2, 384, 12, 12, 64, True, 100, None, 384),
    ("offset_inside_band", 2, 256, 12, 12, 64, True, 200, None, 128),
    ("offset_gqa_hd32", 2, 200, 8, 4, 32, True, None, None, 64),
    ("non_causal_softcap30_gqa_hd128", 2, 300, 8, 2, 128, False, None, 30.0, 0),
    ("offset_window_softcap20_hd16", 2, 100, 4, 4, 16, True, 40, 20.0, 50),
    ("t1_causal", 2, 1, 12, 12, 64, True, None, None, 0),
    ("t1_non_causal", 2, 1, 12, 12, 64, False, None, None, 0),
    ("t100_non_causal", 2, 100, 12, 12, 64, False, None, None, 0),
]
# K3 through the bf16 forward's ring at every head width: the causal band
# wrapping the ring 16 times (T = 4096), an offset band with a window
# (T = 1000, query rows at key positions 300..1299: both band edges cross
# tiles, the last rows dead), q/k/v as strided views of one qkv projection
# over an odd tile count (non-causal, T = 640: 5 tiles), GQA 12/4 at one
# tile's edge (T = 65). The last field is make_qkv's layout. (lse_case's
# backward check needs the lse cotangent to move dk by 5x its tolerance:
# over 1100 or 4096 keys, non-causal, p ~ 1/T dilutes it below that at hd
# 64 and 128, so the long cases are causal.)
LSE_RING_CASES = [
    case for hd in (16, 32, 64, 128) for case in (
        (f"t4096_causal_hd{hd}", 1, 4096, 2, 2, hd, True, None, None, 0, "dense"),
        (f"offset300_window200_t1000_hd{hd}", 1, 1000, 4, 4, hd, True, 200, None,
         300, "dense"),
        (f"qkv_view_t640_non_causal_hd{hd}", 1, 640, 4, 4, hd, False, None,
         None, 0, "qkv_view"),
        (f"gqa12_4_t65_hd{hd}", 2, 65, 12, 4, hd, True, None, None, 0, "dense"),
    )
]
# A dead row (no key inside its offset band) must come out finite with
# lse <= DEAD_LSE and out exactly 0; its dq exactly 0.
DEAD_LSE = -1e29
# The lse cotangent must move dq and dk by at least this many times their
# tolerance, in the plain version, for the check to show that the kernels
# take it.
DLSE_EFFECT_X = 5.0


def lse_case(fa, i, case, dtype):
    """K3 (flash_lse_fwd) and K4a/K4b (flash_lse_bwd) against their plain
    versions on case ``i`` of LSE_CASES in ``dtype``, the backward with a
    random lse cotangent: the record and the (what, message) of every check
    it fails. Errors are taken over live rows; dead rows are held to the
    dead-row contract."""
    name, b, t, h, kv, hd, causal, window, cap, q_offset, *layout = case
    layout = layout[0] if layout else "dense"
    dt = str(dtype).replace("torch.", "")
    q, k, v = make_qkv(b, t, h, kv, hd, dtype, seed=600 + i, layout=layout)
    g = torch.Generator(device="cuda").manual_seed(700 + i)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    dlse = torch.randn((b, h, t), generator=g, device="cuda")
    kw = dict(scale=1.0 / math.sqrt(hd), causal=causal, window=window,
              softcap=cap, q_offset=q_offset)
    live = fa._allowed(t, window, "cuda", causal, q_offset).any(1)
    fails = []

    out, lse = fa.flash_lse_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_lse_fwd_plain(q, k, v, **kw)
    diff = (out.float() - ref.float())[:, live].abs()
    rec = {"phase": "kernel_check", "kernel": "flash_lse_fwd+flash_lse_bwd",
           "case": name, "dtype": dt, "shape": [b, t, h, kv, hd],
           "layout": layout, "causal": causal, "window": window, "softcap": cap,
           "q_offset": q_offset, "live_rows": int(live.sum().item()),
           "max_abs_err": diff.max().item(),
           "mean_rel_err": (diff.mean() / ref.float()[:, live].abs().mean()
                            .clamp_min(1e-30)).item(),
           "lse_max_abs_err": (lse - ref_lse)[..., live].abs().max().item(),
           "tol": OUT_TOL[dtype], "rel_tol": OUT_REL_TOL[dtype],
           "lse_tol": LSE_TOL}
    if not bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all()):
        fails.append(("fwd", f"{name} {dt}: non-finite out or lse"))
    if not rec["max_abs_err"] <= OUT_TOL[dtype]:
        fails.append(("fwd", f"{name} {dt}: max |out diff| {rec['max_abs_err']}"))
    if not rec["mean_rel_err"] <= OUT_REL_TOL[dtype]:
        fails.append(("fwd", f"{name} {dt}: mean rel out diff {rec['mean_rel_err']}"))
    if not rec["lse_max_abs_err"] <= LSE_TOL:
        fails.append(("fwd", f"{name} {dt}: max |lse diff| {rec['lse_max_abs_err']}"))
    if not bool(live.all()):
        dead_lse = lse[..., ~live]
        rec["dead_lse_max"] = dead_lse.max().item()
        rec["dead_out_max_abs"] = out[:, ~live].float().abs().max().item()
        if not (bool(torch.isfinite(dead_lse).all()) and rec["dead_lse_max"] <= DEAD_LSE
                and rec["dead_out_max_abs"] == 0.0):
            fails.append(("fwd", f"{name} {dt}: dead rows break the contract: lse "
                                 f"max {rec['dead_lse_max']}, |out| max "
                                 f"{rec['dead_out_max_abs']}"))

    out_p, lse_p = fa.flash_lse_fwd_plain(q, k, v, **kw)
    got = fa.flash_lse_bwd(q, k, v, out_p, lse_p, do, dlse, **kw)
    torch.cuda.synchronize()
    want = fa.flash_lse_bwd_plain(q, k, v, out_p, lse_p, do, dlse, **kw)
    without = fa.flash_lse_bwd_plain(q, k, v, out_p, lse_p, do, None, **kw)
    for grad, gg, r, r0, x in zip(("dq", "dk", "dv"), got, want, without, (q, k, v)):
        if gg.shape != x.shape or gg.dtype != x.dtype:
            fails.append((grad, f"{name} {dt}: {grad} {tuple(gg.shape)} {gg.dtype}"))
            continue
        d = (gg.float() - r.float()).abs()
        tol = grad_tol(dtype, r.float().abs().max().item())
        rec[f"{grad}_max_abs_err"] = d.max().item()
        rec[f"{grad}_mean_rel_err"] = (d.mean() / r.float().abs().mean()
                                       .clamp_min(1e-30)).item()
        rec[f"{grad}_max_abs"] = r.float().abs().max().item()
        rec[f"{grad}_tol"] = tol
        rec[f"{grad}_dlse_effect"] = (r.float() - r0.float()).abs().max().item()
        if not bool(torch.isfinite(gg.float()).all()):
            fails.append((grad, f"{name} {dt}: non-finite {grad}"))
        if not rec[f"{grad}_max_abs_err"] <= tol:
            fails.append((grad, f"{name} {dt}: max |{grad} diff| "
                                f"{rec[f'{grad}_max_abs_err']} > {tol}"))
        if not (rec[f"{grad}_max_abs"] < ZERO_GRAD_MAX
                or rec[f"{grad}_mean_rel_err"] <= GRAD_REL_TOL[dtype]):
            fails.append((grad, f"{name} {dt}: mean rel {grad} diff "
                                f"{rec[f'{grad}_mean_rel_err']}"))
        if grad in ("dq", "dk") and not rec[f"{grad}_dlse_effect"] >= DLSE_EFFECT_X * tol:
            fails.append((grad, f"{name} {dt}: dlse moves {grad} by only "
                                f"{rec[f'{grad}_dlse_effect']}"))
    if not bool(live.all()):
        rec["dead_dq_max_abs"] = got[0][:, ~live].float().abs().max().item()
        if rec["dead_dq_max_abs"] != 0.0:
            fails.append(("dq", f"{name} {dt}: dead rows' dq "
                                f"{rec['dead_dq_max_abs']} != 0"))
    rec["tol_rel"] = GRAD_REL_TOL[dtype]
    return rec, fails


def phase_lse_kernels(fa):
    """K3, K4a and K4b against their plain versions; returns the records
    by (case, dtype)."""
    results = {}
    for i, case in enumerate(LSE_CASES + LSE_RING_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            rec, fails = lse_case(fa, i, case, dtype)
            emit(rec)
            check(not fails, "; ".join(msg for _, msg in fails))
            results[(case[0], dtype)] = rec
    return results


# K5 cases (the prototype's contract: KV == H; the backward causal only):
# name, B, T, H, hd, window, softcap, dtype. proto_main is the tool's shape.
NH_CASES = [
    ("proto_main", 16, 1024, 12, 64, None, None, torch.bfloat16),
    ("ragged_t300_hd32", 2, 300, 4, 32, None, None, torch.float32),
    ("window40_softcap5", 2, 300, 4, 32, 40, 5.0, torch.float32),
    ("window40_softcap5", 2, 300, 4, 32, 40, 5.0, torch.bfloat16),
    # the bf16 forward's ring of 128-key tiles at every head width
    ("t1_hd64", 2, 1, 4, 64, None, None, torch.bfloat16),
    ("t65_hd16", 2, 65, 4, 16, None, None, torch.bfloat16),
    ("t63_hd32", 2, 63, 4, 32, None, None, torch.bfloat16),
    ("t4096_hd64", 1, 4096, 2, 64, None, None, torch.bfloat16),
    ("t1100_window50_hd128", 1, 1100, 2, 128, 50, None, torch.bfloat16),
]


def nh_case(nh, i, case):
    """K5 (nh_fwd; nh_bwd_dq and nh_bwd_dkv where the case has no window or
    softcap) against the plain versions, at K1's and K2's limits: the record
    and the (what, message) of every check it fails."""
    name, b, t, h, hd, window, cap, dtype = case
    dt = str(dtype).replace("torch.", "")
    q, k, v, do = nh.make_inputs(b, t, h, hd, dtype, "cuda", seed=1000 + i)
    scale = hd ** -0.5
    out, lse = nh.nh_fwd(q, k, v, h, scale, window, cap)
    torch.cuda.synchronize()
    ref, ref_lse = nh.nh_fwd_plain(q, k, v, h, scale, window, cap)
    check(out.shape == q.shape and out.dtype == dtype and lse.shape == (b, h, t, 1),
          f"nh {name} {dt}: out {tuple(out.shape)}, lse {tuple(lse.shape)}")
    diff = (out.float() - ref.float()).abs()
    rec = {"phase": "kernel_check", "kernel": "nh_fwd+nh_bwd", "case": name,
           "dtype": dt, "shape": [b, t, h, h, hd], "window": window,
           "softcap": cap, "max_abs_err": diff.max().item(),
           "mean_rel_err": (diff.mean() / ref.float().abs().mean()
                            .clamp_min(1e-30)).item(),
           "lse_max_abs_err": (lse - ref_lse).abs().max().item(),
           "tol": OUT_TOL[dtype], "rel_tol": OUT_REL_TOL[dtype], "lse_tol": LSE_TOL}
    fails = []
    if not bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all()):
        fails.append(("fwd", f"nh {name} {dt}: non-finite out or lse"))
    for key, tol in (("max_abs_err", OUT_TOL[dtype]), ("mean_rel_err", OUT_REL_TOL[dtype]),
                     ("lse_max_abs_err", LSE_TOL)):
        if not rec[key] <= tol:
            fails.append(("fwd", f"nh {name} {dt}: {key} {rec[key]} > {tol}"))
    if window is None and cap is None:
        delta = (ref.float().reshape(b, t, h, hd) * do.float().reshape(b, t, h, hd)
                 ).sum(-1).transpose(1, 2)[..., None]
        got = nh.nh_bwd(q, k, v, do, ref_lse, delta, h, scale)
        torch.cuda.synchronize()
        want = nh.nh_bwd_plain(q, k, v, do, ref_lse, delta, h, scale)
        errs, bwd_fails = grad_check(got, want, (q, k, v), dtype, f"nh {name} {dt}")
        rec.update(errs)
        fails += bwd_fails
    return rec, fails


def phase_nh_kernels(nh):
    """K5 against its plain versions on NH_CASES; returns the records by
    (case, dtype)."""
    results = {}
    for i, case in enumerate(NH_CASES):
        rec, fails = nh_case(nh, i, case)
        emit(rec)
        check(not fails, "; ".join(msg for _, msg in fails))
        results[(case[0], case[-1])] = rec
    return results


# K6 cases: name, shape, op, reps for each op and reps. "tool" is the tool's
# shape; "ragged" is no multiple of 4 or of a block, so the kernel's scalar
# tail runs. The chain y <- op(-|y| - 0.01) contracts to one fixed point
# (0.5635 for exp): by 32 reps every output is within 1.2e-7 of it
# whatever the input, so a kernel that ignored its input or skipped reps
# would pass at 64 reps alone. Reps 1, 2 and 5 are where it shows.
EXP_SHAPES = (("ragged", (3, 100, 77)), ("tool", (64, 512, 512)))
EXP_REPS = (1, 2, 5, 64)
EXP_OPS = ("exp", "exp2", "exp2*log2e")
EXP_CASES = [(name, shape, op, reps) for name, shape in EXP_SHAPES
             for reps in EXP_REPS for op in EXP_OPS]
# Kernel vs plain version, max |out difference|: both evaluate the same
# float32 steps, the kernel with the CUDA math library's expf/exp2f and the
# plain version with PyTorch's, each within a few ulps (2^-24 relative) of
# outputs in (0, 1]; each step's slope is below 1 in magnitude, so earlier
# steps' differences shrink: 1e-6.
EXP_TOL = 1e-6
# At reps = 1 the outputs exp(-|x| - 0.01) of standard-normal x spread over
# most of (0, 1): a spread above 0.5 shows that the input was read.
EXP_SPREAD_MIN = 0.5


def exp_case(ex, i, case):
    """K6 (exp_chain) against exp_chain_plain on case ``i`` of EXP_CASES:
    the record and the (what, message) of every check it fails."""
    name, shape, op, reps = case
    g = torch.Generator(device="cuda").manual_seed(1200 + i)
    x = torch.randn(shape, generator=g, device="cuda")
    out = ex.exp_chain(x, op, reps)
    torch.cuda.synchronize()
    ref = ex.exp_chain_plain(x, op, reps)
    check(out.shape == x.shape and out.dtype == torch.float32,
          f"exp_chain {name}: out {tuple(out.shape)} {out.dtype}")
    rec = {"phase": "kernel_check", "kernel": "exp_chain",
           "case": f"{name}_{op}_reps{reps}", "dtype": "float32", "shape": list(shape),
           "op": op, "reps": reps, "max_abs_err": (out - ref).abs().max().item(),
           "spread": (out.max() - out.min()).item(), "tol": EXP_TOL}
    fails = []
    if not bool(torch.isfinite(out).all()):
        fails.append(("exp", f"exp_chain {rec['case']}: non-finite out"))
    if not rec["max_abs_err"] <= EXP_TOL:
        fails.append(("exp", f"exp_chain {rec['case']}: max |out diff| "
                             f"{rec['max_abs_err']} > {EXP_TOL}"))
    if reps == 1:
        rec["spread_min"] = EXP_SPREAD_MIN
        if not rec["spread"] > EXP_SPREAD_MIN:
            fails.append(("exp", f"exp_chain {rec['case']}: output spread "
                                 f"{rec['spread']} <= {EXP_SPREAD_MIN}"))
    return rec, fails


def phase_exp_kernels(ex):
    """K6 against its plain version on EXP_CASES; returns the records by
    (shape name, op, reps)."""
    results = {}
    for i, case in enumerate(EXP_CASES):
        rec, fails = exp_case(ex, i, case)
        emit(rec)
        check(not fails, "; ".join(msg for _, msg in fails))
        results[(case[0], case[2], case[3])] = rec
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


def phase_grads(params32, card):
    """Every parameter's gradient through the kernels against plain
    attention, in the trainer's loss-only mode at T=1024, batch 2: fp32
    through K1 + K2a/K2b and through K1 + K2c (FLASH_FUSED_BWD=1), bf16
    through K1 + K2a/K2b."""
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

    def counted_grads(fused):
        reset_counts()
        with fused_switch(fused):
            loss, gs = grads("flash", "float32")
        want = (expected(flash_fwd=12, flash_bwd_prep=12, flash_bwd_fused=12) if fused
                else expected(flash_fwd=12, flash_bwd_prep=12, flash_bwd_dq=12,
                              flash_bwd_dkv=12))
        check(read_counts() == want,
              f"fp32 gradient (fused {fused}): launches {read_counts()}, want {want}")
        check(all(bool(torch.isfinite(v).all()) for v in gs.values()),
              f"non-finite fp32 gradient (fused {fused})")
        return loss, gs

    def rel_errs(gs):
        """Per parameter (but ZERO_GRAD_PARAMS) and over all parameters:
        ||g - g_plain|| / ||g_plain||."""
        rel = {n: ((gs[n] - plain32[n]).norm() /
                   plain32[n].norm().clamp_min(1e-30)).item()
               for n in plain32 if n not in ZERO_GRAD_PARAMS}
        total = (torch.stack([(gs[n] - plain32[n]).norm() for n in plain32]).norm()
                 / torch.stack([plain32[n].norm() for n in plain32]).norm()).item()
        return rel, total

    loss_f32, flash32 = counted_grads(False)
    loss_fused, fused32 = counted_grads(True)
    reset_counts()
    loss_p32, plain32 = grads("einsum", "float32")
    rel, total_rel = rel_errs(flash32)
    worst = max(rel, key=rel.get)
    rel_fused, total_fused = rel_errs(fused32)
    worst_fused = max(rel_fused, key=rel_fused.get)
    zero_norms = {n: (plain32[n].norm().item(), flash32[n].norm().item(),
                      fused32[n].norm().item())
                  for n in ZERO_GRAD_PARAMS if n in plain32}
    del fused32

    def mean_err(gs):
        num = sum((gs[n] - plain32[n]).abs().sum() for n in plain32)
        den = sum(plain32[n].abs().sum() for n in plain32)
        return (num / den).item()

    with fused_switch(False):
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
           "fp32_fused_loss": loss_fused,
           "fp32_fused_max_rel_grad_err": rel_fused[worst_fused],
           "fp32_fused_worst_param": worst_fused,
           "fp32_fused_total_rel_grad_err": total_fused,
           "fp32_zero_grad_norms_plain_flash_fused": zero_norms,
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
    check(rel_fused[worst_fused] <= GRAD_FP32_REL_TOL,
          f"fp32 fused-backward gradient of {worst_fused} differs by "
          f"{rel_fused[worst_fused]} (relative)")
    check(total_fused <= GRAD_FP32_REL_TOL,
          f"fp32 fused-backward gradient differs by {total_fused} (relative, "
          "all parameters)")
    check(err_flash16 <= GRAD_BF16_ERR_RATIO * err_plain16,
          "bf16 kernel-path gradients are further from fp32 than allowed")


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------


# every kernel's launch counter: (module, wrapper, attribute)
FA = "mingpt_distributed_tpu_torch.ops.flash_attention"
NH = "mingpt_distributed_tpu_torch.tools.proto_nh_kernel"
EX = "mingpt_distributed_tpu_torch.tools.exp_exp2"
COUNTERS = {"flash_fwd": (FA, "flash_fwd", "launches"),
            "flash_bwd_prep": (FA, "flash_bwd_prep", "launches"),
            "flash_bwd_dq": (FA, "flash_bwd", "dq_launches"),
            "flash_bwd_dkv": (FA, "flash_bwd", "dkv_launches"),
            "flash_bwd_fused": (FA, "flash_bwd", "fused_launches"),
            "flash_lse_fwd": (FA, "flash_lse_fwd", "launches"),
            "flash_lse_bwd_dq": (FA, "flash_lse_bwd", "dq_launches"),
            "flash_lse_bwd_dkv": (FA, "flash_lse_bwd", "dkv_launches"),
            "nh_fwd": (NH, "nh_fwd", "launches"),
            "nh_bwd_dq": (NH, "nh_bwd_dq", "launches"),
            "nh_bwd_dkv": (NH, "nh_bwd_dkv", "launches"),
            "exp_chain": (EX, "exp_chain", "launches")}


def _counter(name):
    module, fn, attr = COUNTERS[name]
    return getattr(importlib.import_module(module), fn), attr


def reset_counts():
    for name in COUNTERS:
        setattr(*_counter(name), 0)


def read_counts():
    return {name: getattr(*_counter(name)) for name in COUNTERS}


def expected(**launches):
    """A path's expected launch counts: those named, 0 for every other
    kernel."""
    return {name: launches.get(name, 0) for name in COUNTERS}


def phase_train_step(card, steps=5, fused=False, split=None):
    """make_train_step at the bench shape: the training main path (K1, the
    prep pass, K2a/K2b), or with ``fused`` the same step under
    FLASH_FUSED_BWD=1 (K1, the prep pass, K2c), reported beside ``split``,
    the split step's record. Returns the record; its launch counts are the
    measured steps'."""
    from mingpt_distributed_tpu_torch.tools.profile_train import BATCH, SEQ, bench_state
    from mingpt_distributed_tpu_torch.training.metrics import flops_per_token
    from mingpt_distributed_tpu_torch.training.trainer import make_train_step

    with fused_switch(fused):
        cfg, state, batch = bench_state()
        step = make_train_step(cfg)
        losses = [step(state, batch)["loss"] for _ in range(2)]  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            m = step(state, batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / steps
        counts = read_counts()
    losses = [v.item() for v in losses]
    tokens_per_s = BATCH * SEQ / dt
    want = (expected(flash_fwd=12 * steps, flash_bwd_prep=12 * steps,
                     flash_bwd_fused=12 * steps) if fused
            else expected(flash_fwd=12 * steps, flash_bwd_prep=12 * steps,
                          flash_bwd_dq=12 * steps, flash_bwd_dkv=12 * steps))
    rec = {"phase": "train_step_fused" if fused else "train_step",
           "main_path": True, "flash_fused_bwd": fused, "model": "gpt2 124M",
           "batch": BATCH, "seq": SEQ, "dtype": cfg.dtype, "steps": steps,
           "launches": counts, "launches_want": want, "step_ms": dt * 1e3,
           "tokens_per_s": tokens_per_s,
           "mfu": flops_per_token(cfg, SEQ) * tokens_per_s / PEAK_FLOPS[torch.bfloat16],
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "losses": losses, "grad_norm": m["grad_norm"].item(),
           "update_norm": m["update_norm"].item(), "card": card}
    if split is not None:
        rec.update({f"split_{key}": split[key] for key in
                    ("step_ms", "tokens_per_s", "mfu", "peak_allocated_bytes")})
    emit(rec)
    check(counts == want, f"train step (fused {fused}): launches {counts}, want {want}")
    check(all(math.isfinite(v) for v in losses), "non-finite training loss")
    check(losses[-1] < losses[0], "the loss on a repeated batch did not fall")
    del state, batch
    torch.cuda.empty_cache()
    return rec


def run_entry(argv):
    """The train entry point's main(argv), its stdout captured and echoed."""
    from mingpt_distributed_tpu_torch.train import main as train_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_main(argv)
    out = buf.getvalue()
    sys.stderr.write(out)
    return rc, out


def phase_train_entry(card):
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
        reset_counts()
        t0 = time.perf_counter()
        with fused_switch(False):
            rc, out = run_entry(argv + [f"trainer_config.max_steps={ENTRY_STEPS}"])
        dt = time.perf_counter() - t0
        counts = read_counts()
        losses = {int(a): float(b) for a, b in
                  re.findall(r"^step (\d+) \| loss ([0-9.e+-]+)", out, re.M)}
        evals = re.findall(r"eval_loss ([0-9.e+-]+)", out)
        check(rc == 0, f"train entry point exited {rc}")
        check(sorted(losses) == list(range(1, ENTRY_STEPS + 1)),
              f"logged steps {sorted(losses)}")
        drop = losses[1] - losses[ENTRY_STEPS]
        with fused_switch(False):
            rc2, out2 = run_entry(argv + [f"trainer_config.max_steps={ENTRY_STEPS + 5}"])
        resumed = f"Resuming training from snapshot at epoch 0, step {ENTRY_STEPS}"
        losses2 = re.findall(r"^step (\d+) \| loss", out2, re.M)
        emit({"phase": "train_cli", "steps": ENTRY_STEPS, "seconds": dt,
              "launches": counts, "loss_first": losses[1],
              "loss_last": losses[ENTRY_STEPS], "loss_drop": drop,
              "loss_drop_min": ENTRY_LOSS_DROP,
              "eval_loss": float(evals[-1]) if evals else None,
              "snapshot_committed": os.path.exists(snap + ".manifest.json"),
              "resume_rc": rc2, "resumed_at_saved_step": resumed in out2,
              "resumed_steps": [int(v) for v in losses2], "card": card})
        check(drop >= ENTRY_LOSS_DROP, f"loss fell by {drop} < {ENTRY_LOSS_DROP}")
        check(len(evals) == 1 and math.isfinite(float(evals[0])), "no eval loss")
        check(os.path.exists(snap + ".manifest.json"), "no snapshot committed")
        check(counts["flash_bwd_dq"] == 12 * ENTRY_STEPS,
              f"train entry: {counts} launches")
        check(rc2 == 0 and resumed in out2, "second call did not resume")
        check([int(v) for v in losses2] == list(range(ENTRY_STEPS + 1, ENTRY_STEPS + 6)),
              f"resumed run logged steps {losses2}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 4b: sequence parallel, 4 ranks sharing the card over gloo
# ---------------------------------------------------------------------------

# The sp main path: GPT-2 124M at full width, block 4096, ring attention
# over sp = 4 ranks (chunks of 1024, zigzag: half-chunks of 512), global
# batch 4, bf16, no dropout, random tokens, SP_STEPS steps. The card has
# one GPU, and NCCL refuses two ranks on one GPU, so the ranks are
# processes sharing cuda:0 over gloo: the kernels run on the card, the
# exchanges between ranks go through host memory.
SP = 4
SP_T = 4096
SP_BATCH = 4
SP_STEPS = 3
SP_DP2_LAYERS = 2
# Zigzag K3 launches per rank per layer and forward: 3 at step 0 (early x
# early and late x late causal, late x early full) and one batch-stacked
# call per hop, 3 + (n - 1); as many prep passes, K4a and K4b in the
# backward; K3 twice
# that with remat (the forward runs again in the backward). Remat is off.
SP_K3_PER_LAYER = 3 + (SP - 1)
# Each sp step's first step against a single process with dense (einsum)
# attention on the same parameters, batch and dtype; rank 0 runs it after
# the sp steps. Limits are about 10x the sound readings on the card.
#  bf16 (the main path): the activations round to bf16 at other places
#        (the ring rounds each hop's output before its float32 merge).
#        Loss |diff| <= 5e-4 (read 4e-5); grad_norm (before the clip)
#        within 0.5% relative (read 0.09%). Gradients are printed, not held:
#        per parameter they differ by up to 4.9% (read), so a ring that
#        drops a hop (12%) hides in the rounding; and at random init the
#        loss sits near ln(50257) = 10.8 whatever attention does (that ring
#        moves it by 2e-4).
#  fp32 (a ring step beside the main path, and the dp x sp step): every
#        parameter's first update (the gradient after the clip) within
#        ||g_sp - g_dense|| / ||g_dense|| <= GRAD_FP32_REL_TOL, as on one
#        card (phase_grads; read <= 3e-6, and 0.12 with a ring that drops
#        a hop), and over all parameters together; blocks/bk, whose
#        gradient is 0 in exact arithmetic (ZERO_GRAD_PARAMS), only within
#        the total. Loss |diff| <= 2e-5 (read 1.9e-6); grad_norm within
#        GRAD_FP32_REL_TOL relative (read equal).
# Later bf16 steps are printed beside the dense run's, not held: after an
# update Adam's normalised step turns bf16-level gradient differences into
# different moves wherever a gradient is near zero, so the two trajectories
# separate step by step (0.028 apart by step 3 on the card).
SP_LOSS_TOL = 5e-4
SP_GRAD_NORM_REL_TOL = 5e-3
SP_FP32_LOSS_TOL = 2e-5
# Ring and Ulysses attention at GPT-2 width (B=1, T=4096, H=12, hd=64) on 4
# ranks against the dense plain attention (the einsum oracle in float32 on
# the same, for bf16 rounded, inputs), per output and gradient, over all
# ranks' chunks:
#  fp32: float32 sums in other orders over up to 4096 terms: mean |diff| /
#        mean |ref| <= 1e-5, max |diff| <= 1e-4 * max(1, max |ref|);
#  bf16: the kernels round P and dS to bf16 and the outputs to bf16 (one
#        step at the largest value, as for K1/K2), and the ring rounds each
#        hop's partial output before merging it: mean <= 1e-2, max |diff|
#        <= 2^-6 * max(1, max |ref|) (two bf16 steps).
SP_ATTN_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 2.0 ** -6)}


def _sp_gpt_config(attention, n_layer=None, dtype="bfloat16"):
    from mingpt_distributed_tpu_torch.config import GPTConfig

    dims = (dict(model_type="gpt2") if n_layer is None
            else dict(n_layer=n_layer, n_head=12, n_embd=768))
    return GPTConfig.make(vocab_size=50257, block_size=SP_T, attention=attention,
                          dtype=dtype, embd_pdrop=0.0, resid_pdrop=0.0,
                          attn_pdrop=0.0, **dims)


def _sp_batch(seed):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, 50257, (SP_BATCH, SP_T + 1), generator=g)
    return tokens[:, :-1], tokens[:, 1:]


def _sp_state(cfg, device):
    from mingpt_distributed_tpu_torch.config import OptimizerConfig
    from mingpt_distributed_tpu_torch.models import gpt
    from mingpt_distributed_tpu_torch.training.optimizer import make_optimizer
    from mingpt_distributed_tpu_torch.training.trainer import TrainState, trainable

    params = trainable(gpt.init(cfg, torch.Generator().manual_seed(0), device=device))
    return TrainState(params, make_optimizer(OptimizerConfig(), params, 1.0))


def _grads(state):
    """The parameters' gradients, by name; a step's ``zero_grad`` drops
    them from the parameters, not from this dict."""
    from mingpt_distributed_tpu_torch.models import convert

    return {n: p.grad for n, p in convert.flatten(state.params).items()}


def sp_dense(cfg, seed, steps, device, sp_grads):
    """Single-process train steps with dense attention on the sp path's
    parameters and batch: their losses and grad norms, and every
    parameter's first-step gradient against ``sp_grads``, the sp path's."""
    import dataclasses

    from mingpt_distributed_tpu_torch.training.trainer import make_train_step

    dense = dataclasses.replace(cfg, attention="einsum", remat=True)
    state = _sp_state(dense, device)
    step = make_train_step(dense)
    x, y = _sp_batch(seed)
    batch = (x.to(device), y.to(device))
    out = {"losses": [], "grad_norms": []}
    for i in range(steps):
        m = step(state, batch)
        out["losses"].append(m["loss"].item())
        out["grad_norms"].append(m["grad_norm"].item())
        if i == 0:
            want = _grads(state)
            diff = {n: (sp_grads[n].float() - w.float()).norm() for n, w in want.items()}
            norm = {n: w.float().norm() for n, w in want.items()}
            out["grad_rel_err"] = {n: (diff[n] / norm[n].clamp_min(1e-30)).item()
                                   for n in want if n not in ZERO_GRAD_PARAMS}
            out["grad_total_rel_err"] = (torch.stack(list(diff.values())).norm()
                                         / torch.stack(list(norm.values())).norm()).item()
            del want
    del state, m
    torch.cuda.empty_cache()
    return out


def _err_stats(got, ref):
    d = (got.float() - ref.float()).abs()
    return {"max_abs_err": d.max().item(), "sum_abs_err": d.sum().item(),
            "sum_abs_ref": ref.float().abs().sum().item(),
            "max_abs_ref": ref.float().abs().max().item(),
            "finite": bool(torch.isfinite(got.float()).all())}


def _sp_attention(mesh, device):
    """Ring and Ulysses on this rank's chunk, in both dtypes, against the
    same chunk of the dense plain attention and its gradients."""
    from mingpt_distributed_tpu_torch.ops import attention as attn_ops
    from mingpt_distributed_tpu_torch.parallel.ring_attention import ring_causal_attention
    from mingpt_distributed_tpu_torch.parallel.ulysses import ulysses_causal_attention

    g = torch.Generator().manual_seed(800)
    full = [torch.randn((1, SP_T, 12, 64), generator=g) for _ in range(4)]
    c = SP_T // mesh.sp
    sl = slice(mesh.sp_rank * c, (mesh.sp_rank + 1) * c)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (x.to(device, dtype) for x in full)
        ref_in = [x.float().requires_grad_() for x in (q, k, v)]
        ref = attn_ops.causal_attention(*ref_in)
        ref_grads = torch.autograd.grad(ref, ref_in, do.float())
        want = [ref[:, sl].detach()] + [r[:, sl] for r in ref_grads]
        del ref, ref_grads, ref_in
        for name, fn in (("ring", ring_causal_attention),
                         ("ulysses", ulysses_causal_attention)):
            loc = [x[:, sl].contiguous().requires_grad_() for x in (q, k, v)]
            out = fn(*loc, mesh)
            grads = torch.autograd.grad(out, loc, do[:, sl].contiguous())
            dt = str(dtype).replace("torch.", "")
            res[f"{name}_{dt}"] = {key: _err_stats(gg, w) for key, gg, w in zip(
                ("out", "dq", "dk", "dv"), (out, *grads), want)}
        torch.cuda.empty_cache()
    return res


def _sp_train(cfg, mesh, device, seed, steps):
    """make_train_step on this rank's share of the global batch: counts
    set to 0 just before, read just after. Then one more all-reduce of the
    gradients alone, timed: the share of a step that is host traffic.
    Returns the record and the first step's gradients (after the clip)."""
    from mingpt_distributed_tpu_torch.training.trainer import (
        all_reduce_grads,
        make_train_step,
    )

    state = _sp_state(cfg, device)
    step = make_train_step(cfg, mesh=mesh)
    x, y = _sp_batch(seed)
    rows = SP_BATCH // mesh.dp
    c = SP_T // mesh.sp
    share = lambda a: a[mesh.dp_rank * rows:(mesh.dp_rank + 1) * rows,  # noqa: E731
                        mesh.sp_rank * c:(mesh.sp_rank + 1) * c].to(device)
    batch = (share(x), share(y))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, norms, seconds = [], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        m = step(state, batch)
        losses.append(m["loss"].item())  # synchronises
        norms.append(m["grad_norm"].item())
        seconds.append(time.perf_counter() - t0)
        if i == 0:
            first = _grads(state)
    counts = read_counts()
    t0 = time.perf_counter()
    all_reduce_grads(state.params)
    torch.cuda.synchronize()
    out = {"losses": losses, "grad_norms": norms, "seconds": seconds,
           "launches": counts, "grad_all_reduce_s": time.perf_counter() - t0,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    del state
    torch.cuda.empty_cache()
    return out, first


def sp_rank(rank):
    """One of the SP ranks (spawned by parallel.spawn.run_ranks, sharing
    cuda:0): the attention checks, the main path, the main path's ring in
    fp32, the dp x sp step (fp32). Rank 0 then runs each step's dense
    single-process reference (the others wait in their next collective)."""
    from mingpt_distributed_tpu_torch.config import MeshConfig
    from mingpt_distributed_tpu_torch.parallel.mesh import Mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = {"attention": _sp_attention(Mesh(MeshConfig(dp=1, sp=SP)), device)}
    for key, cfg, dp, seed, steps in (
            ("main", _sp_gpt_config("ring"), 1, 5, SP_STEPS),
            ("main_fp32", _sp_gpt_config("ring", dtype="float32"), 1, 5, 1),
            ("dp2_sp2", _sp_gpt_config("ulysses", SP_DP2_LAYERS, "float32"), 2, 6, 1)):
        mesh = Mesh(MeshConfig(dp=dp, sp=SP // dp))
        out[key], grads = _sp_train(cfg, mesh, device, seed, steps)
        if rank == 0:
            out[key]["dense"] = sp_dense(cfg, seed, steps, device, grads)
        del grads
        torch.cuda.empty_cache()
    return out


def _sp_step_fails(what, ms, dense, loss_tol, norm_rel_tol, grad_rel_tol=None):
    """The first step of an sp path, on every rank, against its dense
    reference; the gradients too when ``grad_rel_tol`` is given."""
    m = ms[0]
    fails = [f"{what}: the ranks' losses differ"
             for r in ms[1:] if r["losses"] != m["losses"]][:1]
    if not all(math.isfinite(v) for v in m["losses"]):
        fails.append(f"{what}: non-finite loss")
    if not abs(m["losses"][0] - dense["losses"][0]) <= loss_tol:
        fails.append(f"{what}: loss {m['losses'][0]} vs dense {dense['losses'][0]}")
    if not (abs(m["grad_norms"][0] - dense["grad_norms"][0])
            <= norm_rel_tol * dense["grad_norms"][0]):
        fails.append(f"{what}: grad_norm {m['grad_norms'][0]} vs dense "
                     f"{dense['grad_norms'][0]}")
    if grad_rel_tol is not None:
        rel = dense["grad_rel_err"]
        worst = max(rel, key=rel.get)
        if not rel[worst] <= grad_rel_tol:
            fails.append(f"{what}: gradient of {worst} differs by {rel[worst]} "
                         "(relative)")
        if not dense["grad_total_rel_err"] <= grad_rel_tol:
            fails.append(f"{what}: gradient differs by {dense['grad_total_rel_err']} "
                         "(relative, all parameters)")
    return fails


def _sp_step_record(phase, ms, dense, **kw):
    rel = dense["grad_rel_err"]
    return {"phase": phase, "losses": ms[0]["losses"],
            "grad_norms": ms[0]["grad_norms"], "dense_losses": dense["losses"],
            "dense_grad_norms": dense["grad_norms"],
            "grad_max_rel_err": max(rel.values()), "grad_worst_param": max(rel, key=rel.get),
            "grad_total_rel_err": dense["grad_total_rel_err"], "grad_rel_err": rel,
            "launches_per_rank": [m["launches"] for m in ms], **kw}


def sp_checks(ranks, card):
    """The records of the sp ranks' results and the (group, message) of
    every check they fail; groups "attention", "main" (the main path and
    its fp32 ring step) and "dp2"."""
    records, fails = [], []
    for key in ranks[0]["attention"]:
        rec = {"phase": "sp_attention", "case": key, "ranks": SP,
               "shape": [1, SP_T, 12, 64], "card": card}
        mean_tol, max_x = SP_ATTN_TOL[key.split("_")[1]]
        for name in ("out", "dq", "dk", "dv"):
            st = [r["attention"][key][name] for r in ranks]
            max_err = max(x["max_abs_err"] for x in st)
            mean_rel = sum(x["sum_abs_err"] for x in st) / sum(x["sum_abs_ref"] for x in st)
            tol = max_x * max(1.0, max(x["max_abs_ref"] for x in st))
            rec.update({f"{name}_max_abs_err": max_err, f"{name}_mean_rel_err": mean_rel,
                        f"{name}_tol": tol, f"{name}_rel_tol": mean_tol})
            if not all(x["finite"] for x in st):
                fails.append(("attention", f"sp {key}: non-finite {name}"))
            if not max_err <= tol:
                fails.append(("attention", f"sp {key}: max |{name} diff| {max_err} > {tol}"))
            if not mean_rel <= mean_tol:
                fails.append(("attention", f"sp {key}: mean rel {name} diff {mean_rel}"))
        records.append(rec)

    main = [r["main"] for r in ranks]
    per_step = SP_K3_PER_LAYER * 12
    want = expected(flash_lse_fwd=per_step * SP_STEPS,
                    flash_bwd_prep=per_step * SP_STEPS,
                    flash_lse_bwd_dq=per_step * SP_STEPS,
                    flash_lse_bwd_dkv=per_step * SP_STEPS)
    step_s = sum(sum(m["seconds"][1:]) for m in main) / (SP * (SP_STEPS - 1))
    records.append(_sp_step_record(
        "sp_train_step", main, main[0]["dense"], main_path=True, model="gpt2 124M",
        attention="ring (zigzag)", ranks=SP, backend="gloo, one shared card",
        global_batch=SP_BATCH, seq=SP_T, dtype="bfloat16", steps=SP_STEPS,
        launches_want=want, loss_tol=SP_LOSS_TOL, grad_norm_rel_tol=SP_GRAD_NORM_REL_TOL,
        step_ms=step_s * 1e3,
        grad_all_reduce_ms=[m["grad_all_reduce_s"] * 1e3 for m in main],
        shared_card_tokens_per_s=SP_BATCH * SP_T / step_s,
        peak_allocated_bytes_per_rank=[m["peak_allocated_bytes"] for m in main],
        card=card))
    fails += [("main", f"sp main path launches {m['launches']}, want {want}")
              for m in main if m["launches"] != want]
    fails += [("main", msg) for msg in _sp_step_fails(
        "sp", main, main[0]["dense"], SP_LOSS_TOL, SP_GRAD_NORM_REL_TOL)]
    if not main[0]["losses"][-1] < main[0]["losses"][0]:
        fails.append(("main", "sp loss did not fall"))

    # the main path's ring and model in float32, gradients held
    m32 = [r["main_fp32"] for r in ranks]
    want32 = expected(flash_lse_fwd=per_step, flash_bwd_prep=per_step,
                      flash_lse_bwd_dq=per_step, flash_lse_bwd_dkv=per_step)
    records.append(_sp_step_record(
        "sp_train_step_fp32", m32, m32[0]["dense"], attention="ring (zigzag)",
        dtype="float32", launches_want=want32, loss_tol=SP_FP32_LOSS_TOL,
        grad_rel_tol=GRAD_FP32_REL_TOL, card=card))
    fails += [("main", f"sp fp32 step launches {m['launches']}, want {want32}")
              for m in m32 if m["launches"] != want32]
    fails += [("main", msg) for msg in _sp_step_fails(
        "sp fp32", m32, m32[0]["dense"], SP_FP32_LOSS_TOL, GRAD_FP32_REL_TOL,
        GRAD_FP32_REL_TOL)]

    dp2 = [r["dp2_sp2"] for r in ranks]
    want2 = expected(flash_fwd=SP_DP2_LAYERS, flash_bwd_prep=SP_DP2_LAYERS,
                     flash_bwd_dq=SP_DP2_LAYERS, flash_bwd_dkv=SP_DP2_LAYERS)
    records.append(_sp_step_record(
        "sp_dp2_sp2_step", dp2, dp2[0]["dense"], attention="ulysses",
        layers=SP_DP2_LAYERS, dtype="float32", launches_want=want2, card=card))
    fails += [("dp2", f"dp2 x sp2 launches {m['launches']}, want {want2}")
              for m in dp2 if m["launches"] != want2]
    fails += [("dp2", msg) for msg in _sp_step_fails(
        "dp2 x sp2", dp2, dp2[0]["dense"], SP_FP32_LOSS_TOL, GRAD_FP32_REL_TOL,
        GRAD_FP32_REL_TOL)]
    return records, fails


def phase_sp(card):
    """The sp slice on SP ranks sharing the card. Returns the main path's
    launch counts (rank 0's)."""
    from mingpt_distributed_tpu_torch.parallel.spawn import run_ranks

    t0 = time.perf_counter()
    with fused_switch(False):  # the ranks inherit it: K2a/K2b in Ulysses
        ranks = run_ranks(sp_rank, SP, timeout_s=900)
    seconds = time.perf_counter() - t0
    records, fails = sp_checks(ranks, card)
    for rec in records:
        emit({**rec, "spawn_seconds": seconds} if rec.get("main_path") else rec)
    check(not fails, "; ".join(msg for _, msg in fails))
    return ranks[0]["main"]["launches"]


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------


def sdpa_backward(q, k, v, do, causal=True):
    """The library yardstick: the gradient of scaled_dot_product_attention
    with respect to q, k, v; backward only."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)


def emit_times(entries, shape, dtype, shape_of, card, causal=True):
    """One time line per (kernel, ms, plain ms, plain is, library ms,
    library is) of ``entries``, with the kernel's bound at ``shape`` (B, T,
    H, KV, hd) (the prep pass's without K2c's zero-fill: the split path's;
    K2c's with its float32 dq traffic beside it, ``dq_f32_bytes``); returns
    the kernels line's rows by kernel name."""
    b, t, h, kv, hd = shape
    rows = {}
    for name, ms, plain, plain_is, lib, lib_is in entries:
        nbytes, flops, exps = attention_work(b, t, h, hd, None, dtype, kernel=name,
                                             kv=kv, causal=causal)
        # the prep pass's operations are float32 FMAs whatever its inputs
        bms, by = bound_ms(nbytes, flops,
                           torch.float32 if name == "flash_bwd_prep" else dtype, exps)
        rows[name] = {"ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                      "library_ms": lib}
        design = ({"dq_f32_bytes": dq_f32_bytes(b, t, h, hd, causal)}
                  if name == "flash_bwd_fused" else {})
        emit({"phase": "time", "kernel": name, "shape_of": shape_of,
              "dtype": str(dtype).replace("torch.", ""), "shape": list(shape),
              "causal": causal, "bytes": nbytes, "flops": flops, "exps": exps,
              **rows[name], **design,
              "achieved_tflops": flops / (ms * 1e-3) / 1e12, "plain_is": plain_is,
              "library_is": lib_is, "card": card})
    return rows


def phase_times(fa, card):
    """Kernel, plain version and library yardstick times of K1, the prep
    pass, K2a, K2b and K2c, the prep pass with K2c's dq zero-fill, and the
    whole backward fused (prep + K2c + cast) and split (prep + K2a + K2b);
    returns the rows of the kernels line (bf16, training shape) by kernel
    name."""
    rows = {}
    # the generation shape: flash_fwd at batch 4
    b, t, h, hd = 4, 1024, 12, 64
    scale = 1.0 / math.sqrt(hd)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = make_qkv(b, t, h, h, hd, dtype, seed=100)  # gpt2_main's
        with preserved_counts():
            ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, scale=scale))
            us = host_us(lambda: fa.flash_fwd(q, k, v, scale=scale))
        nbytes, flops, exps = attention_work(b, t, h, hd, None, dtype)
        bms, by = bound_ms(nbytes, flops, dtype, exps)
        emit({"phase": "time", "kernel": "flash_fwd", "shape_of": "generation",
              "dtype": str(dtype).replace("torch.", ""), "shape": [b, t, h, h, hd],
              "ms": ms, "host_us_per_launch": us, "bound_ms": bms, "bound_by": by,
              "achieved_tflops": flops / (ms * 1e-3) / 1e12, "card": card})
    # the training shape: batch 16
    b = 16
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = make_qkv(b, t, h, h, hd, dtype, seed=400)
        g = torch.Generator(device="cuda").manual_seed(401)
        do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
        with preserved_counts(), fused_switch(False):
            out, lse = fa.flash_fwd(q, k, v, scale=scale)
            delta = fa.flash_bwd_prep(out, do)
            dq_acc = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
            fwd_ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, scale=scale))
            prep_ms = cuda_ms(lambda: fa.flash_bwd_prep(out, do))
            dq_zero = torch.empty(q.shape, dtype=torch.float32, device="cuda")
            prep_zero_ms = cuda_ms(lambda: fa.flash_bwd_prep(out, do, dq=dq_zero))
            dq_ms = cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, scale=scale))
            dkv_ms = cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                      scale=scale))
            # the kernel alone: it keeps adding into one dq buffer
            fused_ms = cuda_ms(lambda: fa.flash_bwd_dqkv(q, k, v, do, lse, delta,
                                                         dq_acc, scale=scale))
            split_all = cuda_ms(lambda: fa.flash_bwd(q, k, v, out, lse, do, scale=scale))
            fused_all = cuda_ms(lambda: fa.flash_bwd_fused(q, k, v, out, lse, do,
                                                           scale=scale))
        fwd_plain = cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, scale=scale), iters=3)
        prep_plain = cuda_ms(lambda: fa.flash_bwd_prep_plain(out, do), iters=3)
        bwd_plain = cuda_ms(lambda: fa.flash_bwd_plain(q, k, v, out, lse, do,
                                                       scale=scale), iters=3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        fwd_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        bwd_lib = cuda_ms(sdpa_backward(q, k, v, do))
        bwd_is = ("flash_bwd_plain (dq, dk and dv)", "SDPA backward (dq, dk and dv)")
        got = emit_times((("flash_fwd", fwd_ms, fwd_plain, "flash_fwd_plain", fwd_lib,
                           "SDPA forward"),
                          ("flash_bwd_prep", prep_ms, prep_plain,
                           "flash_bwd_prep_plain (delta)", None,
                           "none: no one PyTorch call sums out * dO in float32"),
                          ("flash_bwd_dq", dq_ms, bwd_plain, bwd_is[0], bwd_lib, bwd_is[1]),
                          ("flash_bwd_dkv", dkv_ms, bwd_plain, bwd_is[0], bwd_lib, bwd_is[1]),
                          ("flash_bwd_fused", fused_ms, bwd_plain, bwd_is[0], bwd_lib,
                           bwd_is[1])),
                         (b, t, h, h, hd), dtype, "training", card)
        nbytes, flops = prep_work(b, t, h, hd, dtype, zero_dq=True)
        bms, by = bound_ms(nbytes, flops, torch.float32, 0)
        emit({"phase": "time", "kernel": "flash_bwd_prep", "what": "with K2c's dq zero-fill",
              "shape_of": "training", "dtype": str(dtype).replace("torch.", ""),
              "shape": [b, t, h, h, hd], "bytes": nbytes, "ms": prep_zero_ms,
              "bound_ms": bms, "bound_by": by, "card": card})
        emit({"phase": "time", "what": "whole backward", "shape_of": "training",
              "dtype": str(dtype).replace("torch.", ""), "shape": [b, t, h, h, hd],
              "fused_ms": fused_all, "fused_is": "flash_bwd_fused: prep (delta, zeroed "
              "float32 dq), K2c, dq cast", "split_ms": split_all,
              "split_is": "flash_bwd: prep (delta), K2a, K2b",
              "split_kernels_ms": prep_ms + dq_ms + dkv_ms,
              "fused_kernels_ms": prep_zero_ms + fused_ms, "library_ms": bwd_lib,
              "card": card})
        if dtype == torch.bfloat16:
            rows.update(got)
        del q, k, v, do, out, lse, delta, dq_acc, dq_zero
        torch.cuda.empty_cache()
    emit({"phase": "memory", "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
          "card": card})
    return rows


def sdpa_with_lse(q, k, v):
    """The library yardstick of K3: one PyTorch call computing the
    non-causal attention and its log-sum-exp (flash for bf16, the
    memory-efficient kernel for fp32, which the flash one does not take)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.dtype == torch.bfloat16:
        return lambda: torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, False)
    return lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
        qt, kt, vt, None, True, 0.0, False)


def phase_lse_times(fa, card):
    """K3, K4a and K4b at the sp main path's zigzag hop shape (batch-stacked,
    non-causal): kernel, plain version and library times, bounds; returns
    the kernels line's rows (bf16)."""
    name, b, t, h, kv, hd, causal, _, _, _ = LSE_CASES[0]
    scale = 1.0 / math.sqrt(hd)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = make_qkv(b, t, h, kv, hd, dtype, seed=900)
        g = torch.Generator(device="cuda").manual_seed(901)
        do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
        kw = dict(scale=scale, causal=causal)
        with preserved_counts():
            out, lse = fa.flash_lse_fwd(q, k, v, **kw)
            delta = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
            fwd_ms = cuda_ms(lambda: fa.flash_lse_fwd(q, k, v, **kw))
            dq_ms = cuda_ms(lambda: fa.flash_lse_bwd_dq(q, k, v, do, lse, delta, **kw))
            dkv_ms = cuda_ms(lambda: fa.flash_lse_bwd_dkv(q, k, v, do, lse, delta, **kw))
        fwd_plain = cuda_ms(lambda: fa.flash_lse_fwd_plain(q, k, v, **kw), iters=3)
        bwd_plain = cuda_ms(lambda: fa.flash_lse_bwd_plain(q, k, v, out, lse, do, **kw),
                            iters=3)
        fwd_lib = cuda_ms(sdpa_with_lse(q, k, v))
        bwd_lib = cuda_ms(sdpa_backward(q, k, v, do, causal=causal))
        bwd_is = ("flash_lse_bwd_plain (dq, dk and dv)",
                  "SDPA backward, non-causal (dq, dk and dv)")
        got = emit_times((("flash_lse_fwd", fwd_ms, fwd_plain, "flash_lse_fwd_plain",
                           fwd_lib, "SDPA with lse, non-causal"),
                          ("flash_lse_bwd_dq", dq_ms, bwd_plain, bwd_is[0], bwd_lib,
                           bwd_is[1]),
                          ("flash_lse_bwd_dkv", dkv_ms, bwd_plain, bwd_is[0], bwd_lib,
                           bwd_is[1])),
                         (b, t, h, kv, hd), dtype, name, card, causal=causal)
        if dtype == torch.bfloat16:
            rows.update(got)
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    return rows


def phase_nh_times(nh, card):
    """K5 (nh_fwd, nh_bwd_dq, nh_bwd_dkv) at the prototype tool's shape:
    kernel, plain version and library (SDPA forward, backward) times,
    bounds; returns the kernels line's rows (bf16)."""
    name, b, t, h, hd = NH_CASES[0][:5]
    scale = hd ** -0.5
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = nh.make_inputs(b, t, h, hd, dtype, "cuda", seed=1100)
        with preserved_counts():
            out, lse = nh.nh_fwd(q, k, v, h, scale)
            delta = (out.float().reshape(b, t, h, hd) * do.float().reshape(b, t, h, hd)
                     ).sum(-1).transpose(1, 2).contiguous()
            args = (*(x.reshape(b, t, h, hd) for x in (q, k, v, do)),
                    lse.reshape(b, h, t).contiguous(), delta)
            fwd_ms = cuda_ms(lambda: nh.nh_fwd(q, k, v, h, scale))
            dq_ms = cuda_ms(lambda: nh.nh_bwd_dq(*args, scale=scale))
            dkv_ms = cuda_ms(lambda: nh.nh_bwd_dkv(*args, scale=scale))
        fwd_plain = cuda_ms(lambda: nh.nh_fwd_plain(q, k, v, h, scale), iters=3)
        bwd_plain = cuda_ms(lambda: nh.nh_bwd_plain(q, k, v, do, lse, delta[..., None],
                                                    h, scale), iters=3)
        qt, kt, vt = (x.transpose(1, 2) for x in args[:3])
        fwd_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        bwd_lib = cuda_ms(sdpa_backward(*args[:4]))
        bwd_is = ("nh_bwd_plain (dq, dk and dv)", "SDPA backward (dq, dk and dv)")
        got = emit_times((("nh_fwd", fwd_ms, fwd_plain, "nh_fwd_plain", fwd_lib,
                           "SDPA forward"),
                          ("nh_bwd_dq", dq_ms, bwd_plain, bwd_is[0], bwd_lib, bwd_is[1]),
                          ("nh_bwd_dkv", dkv_ms, bwd_plain, bwd_is[0], bwd_lib, bwd_is[1])),
                         (b, t, h, h, hd), dtype, name, card)
        if dtype == torch.bfloat16:
            rows.update(got)
        del q, k, v, do, out, lse, delta, args
        torch.cuda.empty_cache()
    return rows


def phase_proto(nh, card):
    """The prototype tool's path (K5's): its main() and main_bwd() at its
    shape, through the tool's functions, with the fused switch off (its
    "old" backward is K2a/K2b). Returns the launch counts: the tool's own
    parity calls and timed calls (WARMUP + ITERS per timed function)."""
    b, t, h, hd, dtype = 16, 1024, 12, 64, torch.bfloat16
    q, k, v, do = nh.make_inputs(b, t, h, hd, dtype, "cuda", seed=0)
    with fused_switch(False):
        reset_counts()
        t0 = time.perf_counter()
        recs = nh.main(q, k, v, h, timing=True) + nh.main_bwd(q, k, v, do, h, timing=True)
        seconds = time.perf_counter() - t0
        counts = read_counts()
    n = nh.WARMUP + nh.ITERS
    # the prep pass: once per new backward (1 + n) and per old one (n)
    want = expected(nh_fwd=2 + 2 * n, nh_bwd_dq=1 + n, nh_bwd_dkv=1 + n,
                    flash_bwd_prep=1 + 2 * n, flash_lse_fwd=n, flash_fwd=n,
                    flash_bwd_dq=n, flash_bwd_dkv=n)
    for rec in recs:
        emit({"phase": "proto_nh_kernel", **rec, "shape": [b, t, h, hd],
              "dtype": "bfloat16", "card": card})
    emit({"phase": "proto_nh_kernel", "launches": counts, "launches_want": want,
          "seconds": seconds})
    check(counts == want, f"proto tool: launches {counts}, want {want}")
    return counts


# The tool's times must show its reps: 64 reps against 32 at least this
# ratio (the SFU's time doubles; the bytes, ~0.04 of ~0.26 ms, do not).
EXP_REPS_RATIO_MIN = 1.5


def phase_exp_tool(ex, card):
    """The exp-vs-exp2 tool's path (K6's): its main() at its shape, stdout
    captured and echoed as exp_exp2 lines; then, beside the path, every op
    at 64 reps against 32 and the plain chain's time. Returns the launch
    counts of main() and the kernels line's row (the exp2 op's times: the
    flash kernels' exponential)."""
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = ex.main([])
    seconds = time.perf_counter() - t0
    counts = read_counts()
    recs = [json.loads(line) for line in buf.getvalue().splitlines()]
    want = expected(exp_chain=len(ex.OPS) * (ex.WARMUP + ex.ITERS))
    for rec in recs:
        emit({"phase": "exp_exp2", **rec, "card": card})
    emit({"phase": "exp_exp2", "launches": counts, "launches_want": want,
          "seconds": seconds})
    check(rc == 0, f"exp_exp2 tool exited {rc}")
    check(counts == want, f"exp_exp2 tool: launches {counts}, want {want}")
    by_op = {r["op"]: r for r in recs if "op" in r}
    check(list(by_op) == list(ex.OPS) and all(r["ms"] > 0 for r in by_op.values()),
          f"exp_exp2 tool records: {recs}")
    check(recs[-1].get("what") == "exp2 vs exp speedup" and recs[-1]["ratio"] > 0,
          f"exp_exp2 tool: no ratio line: {recs[-1]}")

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((64, ex.BLOCK, ex.BLOCK), generator=g, device="cuda")
    with preserved_counts():
        for op in ex.OPS:
            ms_half = cuda_ms(lambda: ex.exp_chain(x, op, ex.REPS // 2))
            ms_full = cuda_ms(lambda: ex.exp_chain(x, op, ex.REPS))
            ratio = ms_full / ms_half
            emit({"phase": "exp_exp2", "op": op, "what": "reps ratio",
                  f"ms_reps{ex.REPS // 2}": ms_half, f"ms_reps{ex.REPS}": ms_full,
                  "ratio": ratio, "ratio_min": EXP_REPS_RATIO_MIN, "card": card})
            check(ratio >= EXP_REPS_RATIO_MIN,
                  f"exp_chain {op}: {ex.REPS} reps / {ex.REPS // 2} reps = {ratio}")
    plain = cuda_ms(lambda: ex.exp_chain_plain(x, "exp2"), iters=3)
    r = by_op["exp2"]
    return counts, {"ms": r["ms"], "plain_ms": plain, "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": None, "op": "exp2",
                    "clock_mhz": r["clock_mhz"]}


def sass_opcodes(name):
    """Opcode counts per kernel of the built library ``name``
    (cuobjdump -sass)."""
    from mingpt_distributed_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = m.group(1)
            counts[kernel] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and kernel:
            counts[kernel][m.group(1)] = counts[kernel].get(m.group(1), 0) + 1
    return counts


def exp_sass(card):
    """Each K6 kernel's SASS opcodes, counted: MUFU.EX2 against the FP32
    and other instructions around it."""
    counts = sass_opcodes("exp_exp2")
    ops = {"ILi0E": "exp", "ILi1E": "exp2", "ILi2E": "exp2*log2e"}
    for kernel, c in counts.items():
        op = next((v for k, v in ops.items() if k in kernel), None)
        emit({"phase": "exp_sass", "kernel": kernel, "op": op, "mufu_ex2": c.get("MUFU.EX2", 0),
              "opcodes": dict(sorted(c.items())), "card": card})
    check(len(counts) == 3 and all(c.get("MUFU.EX2", 0) > 0 for c in counts.values()),
          f"exp_exp2 SASS: {len(counts)} kernels, {counts}")


# The bf16 forward's instantiations: 4 head widths x (K1, K3, K5 fwd)
FWD_BF16_KERNELS = 12
# The bf16 backward's TMA + wgmma instantiations, by template: 4 head widths
# x (K2a, K4a, K5 dq) and (K2b, K4b, K5 dkv, K2c)
BWD_BF16_KERNELS = {"flash_dq_bf16_kernel": 12, "flash_dkv_bf16_kernel": 16}


def _opcode_total(c, prefix):
    return sum(n for op, n in c.items() if op.startswith(prefix))


def _sass_record(phase, kernel, c, card):
    return {"phase": phase, "kernel": kernel, "hgmma": _opcode_total(c, "HGMMA"),
            "utmaldg": _opcode_total(c, "UTMALDG"), "hmma": _opcode_total(c, "HMMA"),
            "mufu_ex2": c.get("MUFU.EX2", 0), "instructions": sum(c.values()),
            "card": card}


def fwd_sass(card):
    """The flash_fwd library's kernels, counted by their SASS: every bf16
    instantiation must issue warpgroup products (HGMMA) and TMA tile loads
    (UTMALDG) and no mma.sync (HMMA); the fp32 kernels issue neither."""
    bf16 = {}
    for kernel, c in sass_opcodes("flash_fwd").items():
        rec = {**_sass_record("fwd_sass", kernel, c, card),
               "bf16": "flash_fwd_bf16_kernel" in kernel}
        emit(rec)
        if rec["bf16"]:
            bf16[kernel] = rec
    check(len(bf16) == FWD_BF16_KERNELS and all(
        r["hgmma"] > 0 and r["utmaldg"] > 0 and r["hmma"] == 0 for r in bf16.values()),
        f"flash_fwd SASS: {len(bf16)} bf16 kernels, want {FWD_BF16_KERNELS}, each with "
        f"HGMMA and UTMALDG and no HMMA: {bf16}")


def bwd_sass_check(counts):
    """The (template, records) of the flash_bwd library's bf16 kernels by
    their SASS opcode counts, and the message of every check they fail:
    each instantiation (BWD_BF16_KERNELS) must issue HGMMA and UTMALDG and
    no HMMA."""
    found = {name: [] for name in BWD_BF16_KERNELS}
    for kernel, c in counts.items():
        for name in found:
            if name in kernel:
                found[name].append(_sass_record("bwd_sass", kernel, c, ""))
    fails = []
    for name, recs in found.items():
        if len(recs) != BWD_BF16_KERNELS[name]:
            fails.append(f"{name}: {len(recs)} instantiations, want "
                         f"{BWD_BF16_KERNELS[name]}")
        for r in recs:
            if not (r["hgmma"] > 0 and r["utmaldg"] > 0 and r["hmma"] == 0):
                fails.append(f"{r['kernel']}: HGMMA {r['hgmma']}, UTMALDG "
                             f"{r['utmaldg']}, HMMA {r['hmma']}")
    return found, fails


def bwd_sass(card):
    """The flash_bwd library's kernels, counted by their SASS (one line
    each); fails unless every bf16 dq and dk/dv instantiation, K2c's among
    them, issues HGMMA and UTMALDG and no HMMA (bwd_sass_check)."""
    counts = sass_opcodes("flash_bwd")
    found, fails = bwd_sass_check(counts)
    bf16 = {r["kernel"] for recs in found.values() for r in recs}
    for kernel, c in counts.items():
        role = ("wgmma" if kernel in bf16 else
                "prep" if "flash_bwd_prep_kernel" in kernel else "fp32")
        emit({**_sass_record("bwd_sass", kernel, c, card), "role": role,
              "fused": kernel in bf16 and _dkv_fused(kernel)})
    check(not fails, "flash_bwd SASS: " + "; ".join(fails))


def ptxas_rows(log):
    """ptxas's resources per kernel from a build's -Xptxas -v output:
    registers, stack, spill stores and loads."""
    kernel, rows = None, []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and kernel:
            rows.append({"kernel": kernel, "stack": int(m.group(1)),
                         "spill_stores": int(m.group(2)),
                         "spill_loads": int(m.group(3))})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1]["kernel"] == kernel:
            rows[-1]["registers"] = int(m.group(1))
    return rows


def fwd_ptxas(log):
    """ptxas's resources per flash_fwd kernel (ptxas_rows); the bf16
    kernels' dynamic shared memory is Tiles<HD>::kSmem of flash_fwd.cu (Q,
    two stages of K and V, six barriers, 1024 bytes of alignment slack)."""
    rows = ptxas_rows(log)
    for r in rows:
        hd = re.search(r"ILi(\d+)E", r["kernel"])
        if "flash_fwd_bf16_kernel" in r["kernel"] and hd:
            r["dynamic_smem_bytes"] = 1280 * int(hd.group(1)) + 8 * 6 + 1024
        emit({"phase": "fwd_ptxas", **r})
    return rows


def _dkv_fused(kernel):
    """Whether a mangled flash_dkv_*_kernel name is a kFused (K2c)
    instantiation: its fourth template argument, after HD, kLse, kNat."""
    m = re.search(r"ILi\d+ELb[01]ELb[01]ELb([01])E", kernel)
    return bool(m and m.group(1) == "1")


def bwd_dynamic_smem(kernel):
    """The dynamic shared memory flash_bwd.cu's launch gives ``kernel`` (a
    mangled name), or None: DqTiles<HD>::kSmem (Q and dO of 128 rows, two
    stages of 64-key K and V tiles), DkvTiles<HD, kFused>::kSmem (K and V of
    128 keys, two stages of 64-row Q and dO tiles with their lse and delta;
    K2c also each consumer warpgroup's 64 x 64 bf16 dS^T tile and the dq
    exchange: 2 warpgroups x 2 parities x 128 threads x a float4 for each
    of min(hd, 64) / 16 column groups), each with six barriers and 1024
    bytes of alignment slack; the fp32 kernels' padded tiles; the prep
    kernel none."""
    m = re.search(r"ILi(\d+)E", kernel)
    if not m:
        return None
    hd = int(m.group(1))
    if "flash_dq_bf16_kernel" in kernel:
        return 1024 * hd + 8 * 6 + 1024
    if "flash_dkv_bf16_kernel" in kernel:
        ds = 2 * 64 * 64 * 2 + 2 * 2 * 128 * 16 * min(hd, 64) // 16 if _dkv_fused(kernel) else 0
        return 1024 * hd + 2 * 2 * 64 * 4 + ds + 8 * 6 + 1024
    if "flash_dq_f32_kernel" in kernel:
        return (4 * 64 * (hd + 4) + 64 * 68) * 4
    if "flash_dkv_f32_kernel" in kernel:
        return (4 * 64 * (hd + 4) + 2 * 64 * 68 + 2 * 64) * 4
    return None


def bwd_ptxas(log):
    """ptxas's resources per flash_bwd kernel (ptxas_rows) with its dynamic
    shared memory (bwd_dynamic_smem), one bwd_ptxas line each; then the
    message of every K2c instantiation at hd <= 64 that spills more bytes
    (stores or loads) than the plain-band dk/dv instantiation of its head
    width (K2b's), which the caller fails on."""
    rows = ptxas_rows(log)
    for r in rows:
        smem = bwd_dynamic_smem(r["kernel"])
        if smem is not None:
            r["dynamic_smem_bytes"] = smem
        emit({"phase": "bwd_ptxas", **r})
    dkv = {}
    for r in rows:
        m = re.search(r"flash_dkv_bf16_kernelILi(\d+)ELb0ELb0ELb([01])E", r["kernel"])
        if m:
            dkv[(int(m.group(1)), m.group(2) == "1")] = r
    fails = []
    for (hd, fused), r in sorted(dkv.items()):
        base = dkv.get((hd, False))
        if fused and hd <= 64 and base is not None and (
                r["spill_stores"] > base["spill_stores"]
                or r["spill_loads"] > base["spill_loads"]):
            fails.append(f"K2c at hd {hd} spills {r['spill_stores']}/{r['spill_loads']} "
                         f"bytes, dk/dv {base['spill_stores']}/{base['spill_loads']}")
    return rows, fails


# nvidia-smi fields logged around the time phases: K6's bound assumes the max
# SM clock, and a time read at a lower clock is slower by their ratio
CLOCK_FIELDS = ("clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu,"
                "clocks_throttle_reasons.active")


def emit_clocks(when):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={CLOCK_FIELDS}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    emit({"phase": "clocks", "when": when, "fields": CLOCK_FIELDS,
          "values": out.stdout.strip()})


@contextlib.contextmanager
def preserved_counts():
    """Launches made to time or compare a kernel are not the main path's."""
    saved = read_counts()
    try:
        yield
    finally:
        for name in COUNTERS:
            setattr(*_counter(name), saved[name])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    from mingpt_distributed_tpu_torch.models.api import GPT
    from mingpt_distributed_tpu_torch.ops import _build
    from mingpt_distributed_tpu_torch.ops import flash_attention as fa
    from mingpt_distributed_tpu_torch.tools import exp_exp2 as ex
    from mingpt_distributed_tpu_torch.tools import proto_nh_kernel as nh

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
    fwd_ptxas(logs["flash_fwd"])
    fwd_sass(card)
    _, spill_fails = bwd_ptxas(logs["flash_bwd"])
    check(not spill_fails, "; ".join(spill_fails))
    bwd_sass(card)

    fwd_errors = phase_kernels(fa)
    prep_errors = phase_bwd_kernels(fa, prep_case)
    bwd_errors = phase_bwd_kernels(fa)
    fused_errors = phase_bwd_kernels(fa, fused_case)
    lse_errors = phase_lse_kernels(fa)
    nh_errors = phase_nh_kernels(nh)
    exp_errors = phase_exp_kernels(ex)
    emit({"phase": "kernels_checked", "kernels": [
        {"name": n, "launches": c} for n, c in read_counts().items()]})
    reset_counts()

    model32 = GPT(gpt2_config("flash", "float32"), seed=0, device="cuda")
    phase_forward(GPT, fa, model32)
    phase_grads(model32.params, card)
    generate_launches = phase_generate(GPT, fa, model32, card)
    phase_sample(fa, card)
    del model32
    torch.cuda.empty_cache()

    split = phase_train_step(card)
    fused = phase_train_step(card, fused=True, split=split)
    phase_train_entry(card)
    sp_counts = phase_sp(card)
    proto_counts = phase_proto(nh, card)
    emit_clocks("before times")
    rows = phase_times(fa, card)
    rows.update(phase_lse_times(fa, card))
    rows.update(phase_nh_times(nh, card))
    exp_counts, rows["exp_chain"] = phase_exp_tool(ex, card)
    emit_clocks("after times")
    exp_sass(card)

    # max_abs_err at each path's shape, bf16: the training step's (K1, the
    # prep pass's delta, K2a, K2b, K2c), the sp path's zigzag hop (K3, K4a,
    # K4b) and the tools' (K5; K6 float32, every op at 64 reps); launches
    # from each kernel's path
    bf16 = torch.bfloat16
    errs = bwd_errors[("gpt2_train", bf16)]
    ferrs = fused_errors[("gpt2_train", bf16)]
    hop = lse_errors[("zigzag_hop", bf16)]
    nerrs = nh_errors[("proto_main", bf16)]
    jax_fa = "mingpt_distributed_tpu/ops/flash_attention.py"
    proto = "tools/proto_nh_kernel.py"
    csrc = "mingpt_distributed_tpu_torch/ops/csrc"
    fwd_cu, bwd_cu = f"{csrc}/flash_fwd.cu", f"{csrc}/flash_bwd.cu"
    line = []
    for name, source, replaces, err, launches in (
            ("flash_fwd", fwd_cu, f"{jax_fa}:677", fwd_errors[("gpt2_train", bf16)],
             split["launches"]),
            ("flash_bwd_prep", bwd_cu, f"{jax_fa}:1101",
             prep_errors[("gpt2_train", bf16)]["delta_max_abs_err"], split["launches"]),
            ("flash_bwd_dq", bwd_cu, f"{jax_fa}:750", errs["dq_max_abs_err"],
             split["launches"]),
            ("flash_bwd_dkv", bwd_cu, f"{jax_fa}:818",
             max(errs["dk_max_abs_err"], errs["dv_max_abs_err"]), split["launches"]),
            ("flash_bwd_fused", bwd_cu, f"{jax_fa}:896",
             max(ferrs[f"{g}_max_abs_err"] for g in ("dq", "dk", "dv")),
             fused["launches"]),
            ("flash_lse_fwd", fwd_cu, f"{jax_fa}:193", hop["max_abs_err"], sp_counts),
            ("flash_lse_bwd_dq", bwd_cu, f"{jax_fa}:346", hop["dq_max_abs_err"],
             sp_counts),
            ("flash_lse_bwd_dkv", bwd_cu, f"{jax_fa}:412",
             max(hop["dk_max_abs_err"], hop["dv_max_abs_err"]), sp_counts),
            ("nh_fwd", fwd_cu, f"{proto}:33", nerrs["max_abs_err"], proto_counts),
            ("nh_bwd_dq", bwd_cu, f"{proto}:210", nerrs["dq_max_abs_err"], proto_counts),
            ("nh_bwd_dkv", bwd_cu, f"{proto}:259",
             max(nerrs["dk_max_abs_err"], nerrs["dv_max_abs_err"]), proto_counts),
            ("exp_chain", f"{csrc}/exp_exp2.cu", "tools/exp_exp2.py:31",
             max(exp_errors[("tool", op, 64)]["max_abs_err"] for op in EXP_OPS),
             exp_counts)):
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, **rows[name]})
        if name == "flash_bwd_prep":
            line[-1]["replaces_is"] = "jnp.sum of out * dO (delta): no pallas_call"
    check(all(k["launches"] > 0 for k in line),
          f"a kernel never ran on its path: {[k['name'] for k in line]}")
    emit({"phase": "launches_by_path", "train_step": split["launches"],
          "train_step_fused": fused["launches"], "sp_train_step_rank0": sp_counts,
          "proto_nh_kernel": proto_counts, "exp_exp2": exp_counts,
          "generate_sliding_bf16": {"flash_fwd": generate_launches}})
    print(card_line(), flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
