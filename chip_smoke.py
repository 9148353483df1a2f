#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, in parallel), holds each against its plain PyTorch version on
the card, drives the port's inference, serving (one server and the
in-process fleet), traffic-lab, training and sequence-parallel training
paths at GPT-2 124M width and the mixture-of-experts path at Mixtral-8x7B
width (random weights, fixed seeds) through the entry points
a user calls, checks that each path went through the kernels,
and times them. Imports nothing of JAX. Prints JSON lines as it goes; any
failed check raises, so the exit code is non-zero and the final line is
never printed.

Phases:
  0. setup: the card's name and power limit, TF32 off, the kernel builds;
     ptxas's registers, spills and dynamic shared memory per forward and
     backward kernel (fwd_ptxas, bwd_ptxas) and each library's SASS, read
     by cuobjdump on the host while phase 1 runs and checked after it
     (fwd_sass, bwd_sass: every bf16 forward, dq and dk/dv instantiation,
     at head widths 16, 32, 64, 80, 96, 128 and 256 (K5's at 16 to 128), K2c's
     seven among them, issues HGMMA and UTMALDG, none HMMA); the float16
     phase's first part: the float16 libraries (flash_fwd_f16.cu,
     flash_bwd_f16.cu) by ptxas beside their bf16 twins at hd 64 and 256,
     and by SASS (every float16 instance, K1, K3, K2a, K4a, K2b, K4b and
     K2c at the seven widths, issues HGMMA on fp16 operands, UTMALDG and no
     HMMA, where every bf16 HGMMA names BF16);
  1. every kernel against its plain version at the main paths' shapes
     (generation at batch 4, the train step at batch 16, the sp path's
     zigzag hop, the sp x tp path's hop and own block on 6 of 12 heads
     (LSE_SP_TP_CASES), the prototype tool's shape) and the edge cases (GQA, a
     window narrower than a tile, softcap, ragged T), and the bf16
     kernels' rings of tiles at every head width, in bf16 and fp32
     (RING_HEAD_DIMS: the seven instances, and 48 and 8, which run the next
     instance up zero-padded; FWD_RING_CASES, BWD_RING_CASES,
     LSE_RING_CASES, LSE_WIDTH_CASES and NH_CASES: T = 1, 63, 65, ... 4096,
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
     entry point; float16 generate_sliding (gpt_config.dtype=float16: 4 x
     1000 prompt tokens, 32 new, the window sliding past 1024; 384 launches
     of K1's float16 instance; each step's decision held by the forward's
     gate with float16 constants, FWD_F16_*);
  3b. serving at the same width (serving/: the continuous-batching server
     on the KV-cached forward; no kernel on its path, 0 launches checked):
     serve_parity (fp32, 4 slots, 6 greedy requests of 5 to 700 prompt
     tokens, two sharing a 128-token head, 24 new tokens each, chunked
     prefill 256, prefix cache on: every token against the port's solo
     KV-cached generate, held where solo's top-2 gap exceeds 3x the run's
     largest engine-vs-solo logit difference); serve (the serving main
     path: bf16, block 1024, 8 slots, 32 requests of 32 to 896 prompt
     tokens, half sharing a 256-token head, 64 new tokens each, one in four
     sampled with top-k 50, chunked prefill 256, a 256 MiB prefix cache,
     warmup: tokens/s, TTFT and ITL p50/p99, host ms per decode step
     against its CUDA-event span and the profiler's kernel ms, peak
     memory, pool bytes, prefix hits, shape counts);
     serve_spec_parity (serve_parity's requests through the speculative
     server, k = 4, with the identical draft, accept rate exactly 1.0, and
     with the target's first layer; the tie rule; one verify shape);
     serve_quant_parity (the same requests with speculation at k = 2
     through int8 and fp8 pools against the fp32 pool: every divergence a
     near-tie of the KV round trip's logit error, the common greedy prefix
     reported, shapes equal, <= 0.27x the pool bytes, power-of-two scales,
     the logit-error gauge); serve_quant (serve's first 10 requests at int8
     and fp8, the decode step profiled over 3 steps: the same numbers and
     160,432,128 pool bytes); serve_spec (serve's first 10
     requests with the draft 'self:2' and 'self', k = 4: tokens/s, TTFT,
     ITL, accept rate, tokens per verify, host ms per propose, verify and
     round, beside serve's); serve_telemetry (serve's first 16 requests
     with request tracing, the flight recorder, attribution and the
     watchdog: the trace file, the flight dumps and /debug/flight, the
     attribution report and /attrib through the port's validators, the
     SLO report, the prefill and decode rows, 0 new shapes after warmup);
     0 launches of every kernel on each; graftaudit (the program audit of
     analysis/program_audit.py at serve's width, tp 1: serve's engine and a
     k = 2 speculative decoder with the draft 'self:2', each of their 21
     families run once: its collectives, its device<->host copies from
     torch.profiler's memcpy events, its pool leaves written in place, the
     K/V leaves' local heads, the allocator's growth, against the family's
     contract; the analytic costs against the committed budgets' section
     GRAFTAUDIT_SWEEP; 0 findings, 0 launches);
  3e. tensor-parallel serving (tp = 2: this process drives, one spawned
     follower process follows, gloo ranks sharing the card): serve_tp_parity
     (serve_parity's requests, fp32, with a 1-layer draft at k = SPEC_K so
     that rejections roll back, against the single-process server in this
     call: tokens by the tie rule, the largest logit difference, shapes
     equal, each rank's pool at half the bytes by the allocator, prefix
     entries of 6 of 12 heads, 0 launches on both ranks) and serve_tp
     (serve's traffic, bf16: tokens/s beside serve's, shared-card, not
     multi-GPU throughput; TTFT and ITL p99; host ms per decode step, the
     tp collectives' and the command broadcast's ms per step; greedy
     streams by the teacher-forced tie rule); serve_moe_tp_parity
     (serve_parity's requests at Mixtral-8x7B width, 1 layer, fp32,
     capacity factor 4, on the same group: the router replicated, each
     rank F/2 of every expert and 4 of 8 KV heads; tokens equal to the tp
     = 1 server's, the largest logit difference, each rank's pool half, 0
     launches on both ranks); the follower exits 0;
  3c. mixture of experts at Mixtral-8x7B width (d 4096, E 8, top-2,
     SwiGLU experts of 14336, 32/8 heads, V 32000): moe_check (the layer on
     256 tokens, bf16 against fp32 on the same bf16 input, and with one
     expert against the dense SwiGLU; the layer's ms and the per-call cost
     of casting its experts to bf16); serve_moe_parity (2 layers, block
     1024, fp32, capacity factor E / k = 4: serve_parity's requests and
     tie rule against solo decode) and serve_moe (2 layers, bf16,
     capacity factor 1.25, serve's traffic, attribution on: its rows and
     the HBM ledger against torch.cuda.memory_allocated); 0 launches;
  3d. the in-process fleet and the traffic lab at GPT-2 124M width (no
     kernel on their path, 0 launches checked; the router's crashes and
     step failures held to the injected ones): fleet_parity (fp32, 3
     replicas x 2 slots on a virtual clock under
     crash:nth=6:match=replica0;slow:every=1:delay=0.25:match=replica1, 6
     greedy requests of 5 to 300 prompt tokens, 24 new tokens: every stream
     equal to solo decode and to what the caller was streamed, the crash,
     retry, duplicate, health and drain counters, memory_allocated back
     within one pool after the restart, each replica's HBM owners beside
     one memory_allocated reading; the migration seam at fp32 and int8: a
     300-token prompt's 256 rows extracted, adopted into a second server's
     prefix store, hit, continued exactly, bit-equal); fleet (bf16, serve's
     32 requests through 2 replicas x 4 slots on the wall clock: tokens/s
     beside serve's, TTFT and ITL, host ms per router round, requests and
     prefix hits per replica; a second run with the engines' logits
     recorded, the same tokens, greedy rows under the tie rule at every
     step, teacher-forced); traffic (bf16, the traffic lab's canned sweep:
     poisson:rate=40, ladder 1 and 24, fifo and edf, 36 requests per rung,
     1 replica x 2 slots, V = 50257, the prefix cache scaled to the tiny
     model's row count: validation after a JSON round trip, the knee's
     pass->fail shape, EDF above FIFO at the overload rung, a byte-identical
     rerun, the report equal field for field to the tiny model's on the CPU
     with the same mix); traffic_controller (the controller axis: traffic
     --selftest-controller's down-ramp rung, FIFO static against FIFO with
     the SLO autoscaler, at V = 50257, twice: the CLI's gates, every
     control-log row strict-valid, the report and the log equal to the tiny
     model's on the CPU on the same mix);
  3f. autoscale: the SLO autoscaler over a process fleet at GPT-2 124M
     width, bf16 (one worker x 4 slots and one warm standby, 1..2
     replicas, the backfill on a thread): serve's first 24 requests as a burst of
     16 and then one every 3 router rounds; a replicas/up adopting the
     standby, a replicas/down whose worker exits 75 and gives the card its
     memory back, every stream exact, the greedy ones under the tie rule,
     the log strict-valid; tokens/s beside procfleet's, the seconds from the
     decision to the newcomer's first token and the backfill's;
  4. training: the train step at the bench shape (GPT-2 124M, T=1024, batch
     16, bf16, no dropout), 12 forward, 12 prep, 12 dq and 12 dk/dv
     launches per step; the same step with FLASH_FUSED_BWD=1, 12 forward,
     12 prep and 12 fused launches per step (K2c's path); then the train
     entry point on the corpus (loss falls, eval, snapshot, resume), twice
     more with its telemetry (train_cli_telemetry: spans_jsonl, a
     torch.profiler trace of steps 3-4 naming the split step's kernels,
     debug_nans on and off, step ms of each), and the serve entry point
     (serve_cli): --selftest, then --prompts-file over that snapshot, and
     with --replicas 1 --autoscale --control-log (serve_cli_autoscale:
     completions byte-equal, the log strict-valid) and with --mesh tp=2
     --dist-backend gloo (serve_cli_tp: completions byte-equal); the
     train CLI's first call writes its snapshot with async_save (the
     resume reads it) and gathers its batches with the C gather;
     moe_train_step (the MoE training path: 1 layer at Mixtral-8x7B width,
     T=4096, batch 2, bf16; first K1, the prep pass, K2a/K2b and K2c
     against their plain versions at its attention shape, 32 heads over 8
     KV heads, hd 128; its first loss against plain attention's; 1 K1, 1
     prep, 1 K2a and 1 K2b launch per step, and with FLASH_FUSED_BWD=1 1
     K1, 1 prep and 1 K2c: step ms, tokens/s, MFU by the JAX formula and
     by the routed operations, peak memory); float16 train_step (the bench
     shape with gpt_config.dtype=float16: the first loss against plain
     attention's within 1e-3 relative, every gradient of the first step
     finite, 3 steps of 12 K1, prep, K2a and K2b float16 launches each,
     step ms, MFU, peak memory, then one FLASH_FUSED_BWD=1 step of 12 K2c);
  4f. the repository tools: families (tools/exp_families.py's llama,
     mistral, gemma and moe at its widths, 4 layers, T 1024, batch 4,
     bf16, K1, the prep pass and K2a/K2b first against their plain
     versions at each attention shape they give them, then through run():
     3 steps each, the loss finite and falling, one K1, prep, K2a and K2b
     launch per layer per step; then the mistral family at the mistral-7b
     preset's widths cut to 2 layers, T 8192, batch 1: the kernels against
     their plain versions at (1, 8192, 32/8, 128) with window 4096 first,
     the plain version one KV group of 8/2 heads at a time, then 3 steps, each
     with its ms, 2 launches of each kernel and peak memory); head_widths
     (train steps at GPT-3 2.7B's widths, hd 80, T 2048, batch 4, at GPT-3
     Large's, hd 96, T 2048, batch 8, and at Gemma 2B's, hd 256 over 1 KV
     head, V 256000, T 8192, batch 1, each cut to 2 layers, bf16: K1, the
     prep pass and K2a/K2b (and K2c at hd 256) against their plain versions
     at the step's shape, the first loss against plain attention's, 3 steps
     of 2 K1, prep, K2a and K2b each with ms, MFU and peak memory, and at hd
     256 one FLASH_FUSED_BWD=1 step of 2 K2c); float16 kernel checks (K1,
     the prep pass, K2a/K2b and K2c at GPT-2's (16, 1024, 12, 64) and Gemma
     2B's (1, 8192, 8/1, 256) shapes, K3 and K4a/K4b there causal with a q
     offset and not causal, an lse cotangent of scale 8, against their
     plain versions at the fp16 tolerances); trace_summary
     (tools/trace_summary.py in this process on train_cli_telemetry's
     profile, the serve_telemetry request trace with --slo, the autoscale
     control log and the serve_telemetry attribution report: the device
     lane apart from the host threads, its busy share printed, each of the
     split step's kernels with as many events there as its counter
     counted launches in the profiled window, its top rows);
  4b. sequence parallel: 4 ranks spawned on the one card over gloo: ring and
     Ulysses attention at GPT-2 width (T=4096) against dense plain attention
     in fp32, bf16 and fp16 (the float16 ring: exactly 6 K3, 6 prep, 6 K4a
     and 6 K4b float16 launches per rank); the sp = 4 ring train step at
     full GPT-2 width, block 4096, global batch 4 (exactly 72 K3, 72 prep,
     72 K4a and 72 K4b launches per rank per step), its loss against a
     single-process dense-attention step; a dp = 2 x sp = 2 Ulysses step at
     2 layers; then on the same ranks sp_tp: the dp 1 x sp 2 x tp 2 ring
     step at GPT-2 124M, block 4096, bf16 (exactly 48 K3, 48 prep, 48 K4a
     and 48 K4b launches per rank per step on 6 of 12 heads; step ms and the
     collectives' ms) and fp32 legs at 2 layers, sp 2 x tp 2 and sp 2 x fsdp
     2, against one process (losses and gradients within 1e-5 relative);
  4d. fsdp x tp: the same 4 ranks (dp 1 x fsdp 2 x tp 2) on the one
     card over gloo: an fp32 leg at GPT-2 width, 2 layers (losses, every
     parameter's first gradient and the parameters after the first update
     against the single-process step on the same weights and batch), then
     the main path at GPT-2 124M, T=1024, global batch 16, bf16, split
     backward (exactly 12 K1, 12 prep, 12 K2a and 12 K2b launches per rank
     per step on (8, 1024, 6, 64) heads; step ms and the collectives' ms,
     shared-card, not multi-GPU throughput; each rank's parameter and Adam
     bytes against the rules; the downgrade counter);
  4e. zero and moe_ep: the same 4 ranks, still in the one spawn: zero (GPT-2
     124M at dp 4 with zero_dp, T 1024, global batch 16, bf16, the split
     backward, beside the same step with zero_dp off on the same seeds:
     losses, step ms, exactly 12 K1, 12 prep, 12 K2a and 12 K2b per rank
     per step at q (4, 1024, 12, 64), each rank's Adam bytes by the
     allocator against opt_moment_bytes (a quarter of dense), the
     reduce-scatter's and all-gather's ms) and its fp32 leg at 2 layers
     against one process (losses and gradients within 1e-5 relative,
     parameters within 1e-5 where |g| > 1e-6); the narrow MoE (2 layers, E
     8, k 2, capacity factor 0.5, one routing group spanning the ranks) at
     ep 2 x dp 2, ep 2 x tp 2 and fsdp 2 x ep 2, fp32, against one process
     by the same rule; moe_ep (Mixtral-8x7B widths at 1 layer, ep 4: 2 of 8
     experts per rank, T 4096, global batch 4, 4 whole routing groups per
     rank, bf16: 1 K1, prep, K2a and K2b per rank per step at q (1, 4096,
     32, 128), 4 all-to-alls per step and their ms, step ms, the first loss
     against rank 0's one-process forward of the 4 rows; K1, the prep pass
     and K2a/K2b held against their plain versions at that shape first);
     then MoE beside sp: the narrow MoE at sp 2 x dp 2 and sp 2 x ep 2 on
     the ring and sp 2 x tp 2 on Ulysses, fp32, one routing group of 1024
     tokens interleaving every rank's sp chunks, against one process by
     the same rule; moe_sp (Mixtral-8x7B widths at 1 layer, sp 2 on the
     zigzag ring x ep 2: 4 of 8 experts per rank, T 8192, global batch 2,
     each rank 1 row x 4096 columns, 4 whole routing groups, bf16, the
     forward, the backward and the gradient reduction without Adam
     moments: exactly 4 K3, 4 prep, 4 K4a and 4 K4b per rank per step at
     q (1, 2048, 32, 128) and (2, 2048, 32, 128), 4 all-to-alls per step
     and their ms, step ms, peak memory, the first loss within 5e-4
     relative and the gradient norm within 0.5% of rank 0's one-process
     step; K3, K4a/K4b and the prep pass held against their plain versions
     at those shapes first);
  4c. the prototype tool (tools/proto_nh_kernel.py, K5's path) at its shape
     (B=16, T=1024, H=12, hd=64, bf16): its parity and time lines;
  5. times: kernels, plain versions, bounds and library yardsticks (K1 at
     the generation shape also its wrapper's host microseconds per launch);
     the prep pass with and without K2c's dq zero-fill; the whole fused
     backward (prep, K2c, cast) beside the split one (prep, K2a, K2b); peak
     device memory; K1, the prep pass, K2a and K2b at the fsdp x tp local
     shape (8, 1024, 6, 64); K3, K4a and K4b at the sp x tp hop shape
     (8, 1024, 6, 64, non-causal); K1, the prep pass, K2a and K2b at
     zero's (4, 1024, 12, 64) and moe_ep's (1, 4096, 32/8, 128); K1, the
     prep pass, K2a, K2b, K2c, K3, K4a and K4b at head_widths' three
     shapes; K1, the prep pass, K2a, K2b and K2c at the training shape and
     K3, K4a and K4b at the zigzag hop in float16 too, beside SDPA's
     float16 time; then the exp-vs-exp2 tool (tools/exp_exp2.py, K6's
     path) through its main() at its shape (64 x 512 x 512 float32, 64
     reps), 64 reps timed against 32, and the opcodes of K6's compiled
     kernels. The SM clock, power and
     throttle reasons are logged before and after.
The seconds of the phases added with MoE and telemetry are one line
(phase_seconds), those of the fleet phases another (new_phase_seconds, with
the smoke's seconds so far), and a third (smoke_budget) gives the float16
phase's parts' seconds against ADDED_PHASES_BUDGET_S together, the
earlier slices' (tensor parallelism, the autoscaler, fsdp x tp, zero,
moe_ep, the pipeline, MoE beside sp, graftaudit, the families,
trace_summary, head_widths and its times) beside them, and the whole smoke
against SMOKE_BUDGET_S, reported, not failed. The last three lines are the
card, the kernels line (twelve kernels; K3, the prep pass, K4a and K4b also
with their moe_sp launches and errors; the eight flash kernels also with
their largest error at every head width checked and their launches and
times at head_widths' shapes; then the eight float16 instances, named with
"_f16", with their launches on the float16 paths) and the ok line. Exits 2
without CUDA, 1 on any failure.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from mingpt_distributed_tpu_torch.tools.bwd_times import dq_f32_bytes
from mingpt_distributed_tpu_torch.tools.profile_generate import device_us
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
              torch.float16: H100_SXM["float16"],
              torch.float32: H100_SXM["float32"]}

# Tolerances of kernel vs plain version, max |out difference|:
#  bf16: both read the same bf16 inputs and work in float32; the output is
#        rounded to bf16 (relative 2^-8, outputs of order 1), and the two
#        sum in different orders, so a value can round to the neighbouring
#        bf16 number: 2e-2.
#  fp32: both sum up to T float32 products in different orders; the
#        difference stays near 1e-6, the check allows 1e-4.
#  fp16: as bf16 with 3 more mantissa bits (a step of 2^-11 relative, 1.95e-3
#        at outputs in [2, 4)): one step from the output's rounding and at
#        most ~1e-3 from P's (relative 2^-12 per term over outputs of order
#        1): 5e-3, a quarter of bf16's.
OUT_TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}
# The max alone sees a P.V fault only where it beats one bf16 step, so the
# mean |out difference| over the mean |out| is held too:
#  bf16: each output is rounded to bf16 (relative <= 2^-9) and the kernel
#        rounds each probability to bf16 before P.V (relative <= 2^-9 per
#        term, independent roundings that partly cancel over the keys), so
#        the ratio stays near 2^-9..2^-8 (2e-3..4e-3): 1e-2;
#  fp32: float32 sums in different orders, ~1e-7 relative per operation
#        over up to T terms: 1e-5;
#  fp16: bf16's roundings 8x finer (2^-12..2^-11, 2.4e-4..4.9e-4): 1.5e-3.
OUT_REL_TOL = {torch.bfloat16: 1e-2, torch.float16: 1.5e-3, torch.float32: 1e-5}
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
#  fp16: the kernel rounds P and dS and the outputs to fp16 (11 significant
#        bits: a step of 2^(e-10) <= 2^-10 |g|): max |diff| <= 2^-9 *
#        max(1, max |g|), two fp16 steps, a quarter of bf16's limit; mean
#        |diff| / mean |g| <= 1.5e-3 (bf16's expected ratio 8x finer:
#        2.4e-4..4.9e-4).
# The mean ratio is held where the gradient is not zero: at T=1, dq and dk
# are exactly 0 (one key: p = 1 and dp = delta), both versions return
# rounding noise (max |g| < 1e-5) and only the max is held.
GRAD_TOL_X = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -9}
GRAD_TOL = {torch.float32: 1e-4}
GRAD_REL_TOL = {torch.bfloat16: 1e-2, torch.float16: 1.5e-3, torch.float32: 1e-5}
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


SMOKE_T0 = time.perf_counter()


def emit(obj) -> None:
    """``obj`` as a JSON line on stdout; on stderr, the seconds since the
    smoke started beside its phase (where the smoke's time goes)."""
    print(json.dumps(obj), flush=True)
    print(f"[chip_smoke +{time.perf_counter() - SMOKE_T0:.1f} s] {obj.get('phase', '')}",
          file=sys.stderr, flush=True)


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
# training main path (the bench-shape train step) gives every kernel, and
# fsdp_tp_local the shape the fsdp 2 x tp 2 step gives it on each rank (its
# rows over fsdp, its heads over tp)
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
    ("fsdp_tp_local", 8, 1024, 6, 6, 64, None, None),
]
# The head widths of the kernels' ring cases: the instances of PRs 1-8,
# then those of GPT-3 2.7B (80), GPT-3 Large (96) and Gemma 2B (256), then
# two widths that run the next instance up zero-padded (48 on 64, 8 on 16).
# The later widths come last, so the earlier cases keep their seeds.
RING_HEAD_DIMS = (16, 32, 64, 128, 80, 96, 256, 48, 8)
# The bf16 forward's ring of k/v tiles (two stages of 128 keys, 64 at hd
# 256) at every head width: one tile and its edges (T = 1, 63, 65), q/k/v as
# strided views of one qkv projection (T = 1000: 8 tiles), the ring
# wrapping 16 times (T = 4096: 32 tiles), GQA 12/4 over an odd tile count
# (T = 1100: 9 tiles; at hd 256 T = 1080, 17 tiles of 64 keys), a window
# narrower than a tile (T = 640: 5 tiles).
# Forward only (phase_kernels); the last field is make_qkv's layout.
FWD_RING_CASES = [
    case for hd in RING_HEAD_DIMS for case in (
        (f"t1_hd{hd}", 2, 1, 4, 4, hd, None, None, "dense"),
        (f"t63_hd{hd}", 2, 63, 4, 4, hd, None, None, "dense"),
        (f"t65_hd{hd}", 2, 65, 4, 4, hd, None, None, "dense"),
        (f"t1000_qkv_view_hd{hd}", 2, 1000, 4, 4, hd, None, None, "qkv_view"),
        (f"t4096_hd{hd}", 1, 4096, 2, 2, hd, None, None, "dense"),
        (f"gqa12_4_t{1100 if hd <= 128 else 1080}_hd{hd}", 1, 1100 if hd <= 128 else 1080,
         12, 4, hd, None, None, "dense"),
        (f"window50_t640_hd{hd}", 2, 640, 4, 4, hd, 50, None, "dense"),
    )
]


# The bf16 backward's rings (dq: two stages of 64 keys, 32 at hd 256, under
# items of 128 query rows; dk/dv: two stages of 64-row Q/dO tiles under
# items of 128 keys, 64 at hd 256) at every head width: FWD_RING_CASES'
# shapes (one tile and its edges, strided q/k/v views of one qkv
# projection, the rings wrapping many times at T = 4096, GQA 12/4 over an
# odd tile count, a window narrower than a tile) and a softcap. Run by
# bwd_case (K2a/K2b) and fused_case (K2c).
BWD_RING_CASES = [
    case for hd in RING_HEAD_DIMS for case in (
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


def by_kv_groups(plain, groups):
    """``plain`` (flash_fwd_plain or flash_bwd_plain) one KV group at a
    time: each of ``groups`` slices of H / groups query heads with their
    KV / groups key and value heads, the outputs joined along the head
    axis. Exact, since a query head reads only its own KV head; the float32
    scores held at once are one group's."""
    if groups == 1:
        return plain

    def run(q, k, v, *rest, **kw):
        h, kv = q.shape[2] // groups, k.shape[2] // groups
        parts = []
        for g in range(groups):
            qs, ks = slice(g * h, (g + 1) * h), slice(g * kv, (g + 1) * kv)
            extra = ()
            if rest:  # out, lse, dO
                out, lse, do = rest
                extra = (out[:, :, qs], lse[:, qs], do[:, :, qs])
            parts.append(plain(q[:, :, qs], k[:, :, ks], v[:, :, ks], *extra, **kw))
        # lse (B, H, T) has its heads on axis 1; out, dq, dk, dv on axis 2
        return tuple(torch.cat(xs, dim=1 if xs[0].dim() == 3 else 2)
                     for xs in zip(*parts))

    return run


def kernel_errors(fa, q, k, v, *, scale, window, softcap, plain_groups=1):
    """Run the kernel and its plain version (by_kv_groups) on the same
    inputs; return whether the kernel's out and lse are finite and the
    differences of their outputs and lse (or ``bad_shapes``)."""
    out, lse = fa.flash_fwd(q, k, v, scale=scale, window=window,
                            softcap=softcap)
    torch.cuda.synchronize()
    ref, ref_lse = by_kv_groups(fa.flash_fwd_plain, plain_groups)(
        q, k, v, scale=scale, window=window, softcap=softcap)
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


def fwd_case(fa, i, case, dtype, plain_groups=1):
    """Case ``i`` of KERNEL_CASES + FWD_RING_CASES in ``dtype``: K1
    (flash_fwd) against flash_fwd_plain (by ``plain_groups`` KV groups) on
    the same inputs. Returns its record and the ("fwd", message) of every
    check it fails."""
    name, b, t, h, kv, hd, window, cap, *layout = case
    layout = layout[0] if layout else "dense"
    dt = str(dtype).replace("torch.", "")
    q, k, v = make_qkv(b, t, h, kv, hd, dtype, seed=100 + i, layout=layout)
    errs = kernel_errors(fa, q, k, v, scale=1.0 / math.sqrt(hd), window=window,
                         softcap=cap, plain_groups=plain_groups)
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


def _bwd_inputs(fa, i, case, dtype, plain_groups=1):
    """Case ``i`` of KERNEL_CASES + BWD_RING_CASES in ``dtype``: q, k, v, dO
    and the plain forward's out and lse (by ``plain_groups`` KV groups),
    with the kernels' keyword arguments."""
    name, b, t, h, kv, hd, window, cap, *layout = case
    q, k, v = make_qkv(b, t, h, kv, hd, dtype, seed=200 + i,
                       layout=layout[0] if layout else "dense")
    g = torch.Generator(device="cuda").manual_seed(300 + i)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    kw = dict(scale=1.0 / math.sqrt(hd), window=window, softcap=cap)
    out, lse = by_kv_groups(fa.flash_fwd_plain, plain_groups)(q, k, v, **kw)
    return (q, k, v, out, lse, do), kw


def bwd_case(fa, i, case, dtype, plain_groups=1):
    """Backward check case ``i`` of KERNEL_CASES + BWD_RING_CASES in
    ``dtype``: K2a and K2b (flash_bwd with the fused switch off) against
    flash_bwd_plain (by ``plain_groups`` KV groups) on the same inputs.
    Returns its record and the (gradient, message) of every check it
    fails."""
    name, b, t, h, kv, hd, window, cap, *layout = case
    args, kw = _bwd_inputs(fa, i, case, dtype, plain_groups)
    with fused_switch(False):
        got = fa.flash_bwd(*args, **kw)
    torch.cuda.synchronize()
    want = by_kv_groups(fa.flash_bwd_plain, plain_groups)(*args, **kw)
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
    latter also zeroing a NaN-filled float32 dq (K2c's path) where the head
    width is an instance's (K2c's buffer has one: flash_bwd_fused pads
    other widths first). Returns its record and the ("delta" or "dq",
    message) of every check it fails."""
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
        dq = (torch.full(out.shape, float("nan"), device="cuda")
              if cot is None and hd in fa.NATIVE_HEAD_DIMS else None)
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
# 64 and 128, so the long cases are causal.) The widths after 128 are
# LSE_WIDTH_CASES, run after LSE_SP_TP_CASES.
LSE_RING_CASES = [
    case for hd in RING_HEAD_DIMS[:4] for case in (
        (f"t4096_causal_hd{hd}", 1, 4096, 2, 2, hd, True, None, None, 0, "dense"),
        (f"offset300_window200_t1000_hd{hd}", 1, 1000, 4, 4, hd, True, 200, None,
         300, "dense"),
        (f"qkv_view_t640_non_causal_hd{hd}", 1, 640, 4, 4, hd, False, None,
         None, 0, "qkv_view"),
        (f"gqa12_4_t65_hd{hd}", 2, 65, 12, 4, hd, True, None, None, 0, "dense"),
    )
]
# K3/K4 at the shapes the sp x tp main path (dp 1 x sp 2 x tp 2, T=4096,
# batch 4) gives each rank: the batch-stacked non-causal hop and the step-0
# causal own block, half-chunks of 1024 rows on 6 of 12 heads. Kept after
# the ring cases so that their seeds stay as they were.
LSE_SP_TP_CASES = [
    ("sp_tp_hop", 8, 1024, 6, 6, 64, False, None, None, 0),
    ("sp_tp_own", 4, 1024, 6, 6, 64, True, None, None, 0),
]
# LSE_RING_CASES' shapes at the later ring widths (80, 96, 256 and the
# padded 48 and 8), after LSE_SP_TP_CASES so that their seeds stay. At hd
# 256 the non-causal view case is T = 200 (4 tiles of 64 keys): over 640
# keys the lse cotangent moved dk by 4.5x its tolerance (H100, bf16),
# below DLSE_EFFECT_X.
LSE_WIDTH_CASES = [
    case for hd in RING_HEAD_DIMS[4:] for case in (
        (f"t4096_causal_hd{hd}", 1, 4096, 2, 2, hd, True, None, None, 0, "dense"),
        (f"offset300_window200_t1000_hd{hd}", 1, 1000, 4, 4, hd, True, 200, None,
         300, "dense"),
        (f"qkv_view_t{200 if hd == 256 else 640}_non_causal_hd{hd}", 1,
         200 if hd == 256 else 640, 4, 4, hd, False, None, None, 0, "qkv_view"),
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


def lse_case(fa, i, case, dtype, dlse_scale=1.0):
    """K3 (flash_lse_fwd) and K4a/K4b (flash_lse_bwd) against their plain
    versions on case ``i`` of LSE_CASES in ``dtype``, the backward with a
    random lse cotangent (N(0, 1) times ``dlse_scale``): the record and the
    (what, message) of every check it fails. Errors are taken over live
    rows; dead rows are held to the dead-row contract."""
    name, b, t, h, kv, hd, causal, window, cap, q_offset, *layout = case
    layout = layout[0] if layout else "dense"
    dt = str(dtype).replace("torch.", "")
    q, k, v = make_qkv(b, t, h, kv, hd, dtype, seed=600 + i, layout=layout)
    g = torch.Generator(device="cuda").manual_seed(700 + i)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    dlse = torch.randn((b, h, t), generator=g, device="cuda") * dlse_scale
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
    for i, case in enumerate(LSE_CASES + LSE_RING_CASES + LSE_SP_TP_CASES + LSE_WIDTH_CASES):
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


# ---------------------------------------------------------------------------
# phase 3b: serving (the continuous-batching server; no kernel on its path)
# ---------------------------------------------------------------------------


# serve_parity's tie rule, chip_smoke's margin rule for argmaxes: with e the
# largest engine-vs-solo logit difference of the run, a token is held where
# solo's fp32 top-2 gap exceeds SERVE_TIE_X * e; a divergence at a narrower
# gap ends that request's comparison (printed), and at least
# SERVE_COMPARED_MIN of the run's steps must have been compared
SERVE_TIE_X = 3.0
SERVE_COMPARED_MIN = 0.9
SERVE_SEED = 9


def _serve_prompts(rng, lengths, head, shared, vocab=50257):
    """Token prompts of ``lengths`` below ``vocab``; those flagged
    ``shared`` start with ``head``."""
    out = []
    for n, s in zip(lengths, shared):
        p = rng.integers(0, vocab, int(n)).tolist()
        if s:
            p[:len(head)] = head
        out.append(p)
    return out


@contextlib.contextmanager
def logit_tap(*servers):
    """Records the logits the target engine picks each request's tokens
    from, keyed (request id, token index), over one or more servers (a
    fleet's replicas): the engine's selector is wrapped, and each target's
    prefill, decode and verify calls mark what the next selection belongs
    to (the draft engine's calls are not recorded). A verify's row j gives
    token len(tokens) + j; the rows a round rejects are overwritten by the
    round that emits those indices."""
    from mingpt_distributed_tpu_torch.serving import engine as engine_mod

    rows, current = {}, {}
    kinds = {"prefill_chunk_call": "prefill", "verify_call": "verify",
             "decode_on_device": "decode"}
    real_select = engine_mod._select_next_slots
    real = [(srv, {name: getattr(srv.engine, name) for name in kinds})
            for srv in servers]

    def marked(server, kind, fn):
        def call(*args, **kwargs):
            current.update(kind=kind, server=server,
                           slot=args[0] if kind != "decode" else None)
            try:
                return fn(*args, **kwargs)
            finally:
                current.clear()
        return call

    def select(logits, *args):
        kind, server = current.get("kind"), current.get("server")
        if kind == "decode":
            for s in server.slots.decoding_slots():
                h = server.slots.handles[s]
                rows[(h.request_id, len(h.tokens))] = logits[s].clone()
        elif kind is not None:
            h = server.slots.handles[current["slot"]]
            if h is not None:
                start = 0 if kind == "prefill" else len(h.tokens)
                take = 1 if kind == "prefill" else logits.shape[0]
                for j in range(take):  # a prefill's last row gives token 0
                    rows[(h.request_id, start + j)] = logits[j].clone()
        return real_select(logits, *args)

    engine_mod._select_next_slots = select
    for srv, fns in real:
        for name, fn in fns.items():
            setattr(srv.engine, name, marked(srv, kinds[name], fn))
    try:
        yield rows
    finally:
        engine_mod._select_next_slots = real_select
        for srv, fns in real:
            for name in fns:
                delattr(srv.engine, name)


def solo_greedy(params, cfg, prompt, n):
    """The port's solo KV-cached greedy decode (generate()'s calls), with
    the logits of every step: (tokens, (n, V) logits)."""
    from mingpt_distributed_tpu_torch.models import generate as gen

    with torch.no_grad():
        cache = gen.init_cache(cfg, 1, torch.device("cuda"))
        logits = gen._forward_cached(
            params, torch.tensor([prompt], device="cuda"), cache, 0, cfg)
        toks, rows = [], []
        for pos in range(len(prompt), len(prompt) + n):
            rows.append(logits[0])
            tok = logits.argmax(-1)
            toks.append(int(tok))
            if len(toks) < n:
                logits = gen._forward_cached(params, tok[:, None], cache, pos, cfg)
    return toks, torch.stack(rows)


def tie_rule(handles, solo, rows, new):
    """serve_parity's comparison of a run's tokens with solo decode: the
    first diverging step of each request, the largest engine-vs-solo logit
    difference e up to it, the divergences with solo's top-2 gap there, and
    the steps compared. A divergence is allowed where that gap is at most
    SERVE_TIE_X * e."""
    firsts = [next((i for i, (a, b) in enumerate(zip(h.tokens, toks)) if a != b), new)
              for h, (toks, _) in zip(handles, solo)]
    e = max((rows[(h.request_id, i)] - ref[i]).abs().max().item()
            for h, (_, ref), d in zip(handles, solo, firsts)
            for i in range(min(d + 1, new)))
    divergences = []
    for h, (toks, ref), d in zip(handles, solo, firsts):
        if d < new:
            top2 = ref[d].topk(2).values
            divergences.append({"request": h.request_id, "step": d,
                                "server": h.tokens[d], "solo": toks[d],
                                "top2_gap": (top2[0] - top2[1]).item()})
    return {"compared_steps": sum(firsts), "max_logit_err": e,
            "tie_margin": SERVE_TIE_X * e, "divergences": divergences}


def check_tie_rule(phase, res, n_steps):
    check(all(d["top2_gap"] <= res["tie_margin"] for d in res["divergences"]),
          f"{phase}: a token differs where solo's top-2 gap exceeds "
          f"{SERVE_TIE_X} x {res['max_logit_err']}")
    check(res["compared_steps"] >= SERVE_COMPARED_MIN * n_steps,
          f"{phase}: {res['compared_steps']} of {n_steps} steps compared")


def parity_prompts(vocab=50257):
    """serve_parity's six prompts (5 to 700 tokens, two sharing a 128-token
    head) and their lengths."""
    rng = np.random.default_rng(SERVE_SEED)
    lengths = rng.integers(5, 701, 6)
    lengths[0], lengths[1] = 5, 700
    lengths[2], lengths[4] = rng.integers(129, 257), rng.integers(129, 701)
    head = rng.integers(0, vocab, 128).tolist()
    return _serve_prompts(rng, lengths, head, [i in (2, 4) for i in range(6)],
                          vocab), lengths


PARITY_NEW = 24


def phase_serve_parity(params32, card, cfg=None, phase="serve_parity",
                       model="gpt2 124M"):
    """The server at GPT-2 124M width (or ``cfg``'s), fp32: 4 slots, 6
    greedy requests (prompts of 5 to 700 tokens, two sharing a 128-token
    head), 24 new tokens each, chunked prefill (256) and the prefix cache
    on; every request's tokens against the port's solo KV-cached generate
    on the card under the tie rule. Returns (prompts, solo decode) for the
    speculative and quantized parity phases."""
    from mingpt_distributed_tpu_torch.models import generate as gen
    from mingpt_distributed_tpu_torch.serving import InferenceServer, Request

    cfg, new = cfg or gpt2_config("flash", "float32"), PARITY_NEW
    prompts, lengths = parity_prompts(cfg.vocab_size)
    server = InferenceServer(params32, cfg, n_slots=4, prefill_chunk=256,
                             prefix_cache_mb=64, device="cuda")
    reset_counts()
    with logit_tap(server) as rows:
        handles, dt = timed(lambda: server.generate_batch(
            [Request(prompt=p, max_new_tokens=new) for p in prompts]))
    launches = read_counts()
    solo = [solo_greedy(params32, cfg, p, new) for p in prompts]
    for p, (toks, _) in zip(prompts, solo):
        want = gen.generate(params32, cfg, [p], new, device="cuda")[0, len(p):]
        check(want.tolist() == toks, "solo decode differs from generate()")
    res = tie_rule(handles, solo, rows, new)
    rec = {"phase": phase, "model": model, "dtype": "float32",
           "slots": 4, "requests": 6, "prompt_lengths": [int(n) for n in lengths],
           "new_tokens": new, "prefill_chunk": 256, "steps": 6 * new,
           "compared_min": SERVE_COMPARED_MIN, **res,
           "prefix_hits": server.metrics.prefix_hits,
           "shapes": server.compile_counts(), "launches": launches,
           "seconds": dt, "card": card}
    if cfg.n_experts:
        rec["moe"] = {"experts": cfg.n_experts, "top_k": cfg.moe_top_k,
                      "capacity_factor": cfg.moe_capacity_factor}
    emit(rec)
    check(all(len(h.tokens) == new for h in handles), f"{phase}: a request fell short")
    check_tie_rule(phase, res, 6 * new)
    check(server.metrics.prefix_hits >= 1, f"{phase}: no prefix hit")
    check(not any(launches.values()), f"serving launched kernels: {launches}")
    return prompts, solo


SPEC_K = 4


def phase_serve_spec_parity(params32, card, parity):
    """serve_parity's requests through the speculative server (fp32, 4
    slots, k = 4): with the identical draft ('self': accept rate exactly
    1.0) and with the target's first layer ('self:1': rejections roll
    back); every request's tokens against solo decode under the tie rule,
    one verify shape and one draft decode shape, no kernel launched."""
    from mingpt_distributed_tpu_torch.serving import InferenceServer, Request

    from mingpt_distributed_tpu_torch.serve import draft_from

    cfg, new = gpt2_config("flash", "float32"), PARITY_NEW
    prompts, solo = parity
    launches_all = {}
    for draft in ("self", "self:1"):
        dparams, dcfg = draft_from(draft, params32, cfg, "cuda")
        server = InferenceServer(params32, cfg, n_slots=4, prefill_chunk=256,
                                 prefix_cache_mb=64, draft_params=dparams,
                                 draft_cfg=dcfg, spec_k=SPEC_K, device="cuda")
        reset_counts()
        with logit_tap(server) as rows:
            handles, dt = timed(lambda: server.generate_batch(
                [Request(prompt=p, max_new_tokens=new) for p in prompts]))
        launches = launches_all[draft] = read_counts()
        res = tie_rule(handles, solo, rows, new)
        m, counts = server.metrics, server.compile_counts()
        emit({"phase": "serve_spec_parity", "draft": draft, "spec_k": SPEC_K,
              "model": "gpt2 124M", "dtype": "float32", "slots": 4, "requests": 6,
              "new_tokens": new, "steps": 6 * new, **res,
              "spec_rounds": m.spec_rounds, "spec_proposed": m.spec_proposed,
              "spec_accepted": m.spec_accepted, "accept_rate": m.spec_accept_rate,
              "tokens_per_verify": m.spec_tokens_per_verify_mean,
              "per_request": [(h.spec_proposed, h.spec_accepted) for h in handles],
              "prefix_hits": m.prefix_hits, "shapes": counts, "launches": launches,
              "seconds": dt, "card": card})
        check(all(len(h.tokens) == new for h in handles),
              f"serve_spec_parity {draft}: a request fell short")
        check_tie_rule(f"serve_spec_parity {draft}", res, 6 * new)
        check(m.spec_rounds > 0, f"serve_spec_parity {draft}: no verify round")
        if draft == "self":
            check(m.spec_accept_rate == 1.0,
                  f"serve_spec_parity: identical draft accept rate {m.spec_accept_rate}")
        check(counts["verify"] == 1 and counts["draft_decode"] == 1,
              f"serve_spec_parity {draft}: shapes {counts}")
        check(not any(launches.values()), f"speculation launched kernels: {launches}")
        del server
    return launches_all


def phase_serve_quant_parity(params32, card, parity):
    """selftest-quant at GPT-2 124M width: serve_parity's requests with
    speculation (the identical draft, k = 2), chunks and the prefix cache,
    through an fp32, an int8 and an fp8 pool. Each quantized stream equals
    the fp32 server's, or leaves it only at a near-tie (the fp32 top-2 gap
    at most QUANT_TIE_X x the KV round trip's logit error at that context);
    the common greedy prefix (the JAX package's 0.9 gate) is reported.
    Shapes equal for every dtype, pool bytes <= 0.27x fp32, power-of-two
    scales, the logit-error gauge set, no kernel launched."""
    from mingpt_distributed_tpu_torch import serve as serve_mod
    from mingpt_distributed_tpu_torch import telemetry
    from mingpt_distributed_tpu_torch.serving import InferenceServer, Request
    from mingpt_distributed_tpu_torch.serving import quant as quant_lib

    cfg, new = gpt2_config("flash", "float32"), PARITY_NEW
    prompts, _ = parity

    def run(kv_dtype):
        reg = telemetry.MetricsRegistry()
        server = InferenceServer(params32, cfg, n_slots=4, prefill_chunk=256,
                                 prefix_cache_mb=64, draft_params=params32,
                                 draft_cfg=cfg, spec_k=2, kv_dtype=kv_dtype,
                                 registry=reg, device="cuda")
        reset_counts()
        handles, dt = timed(lambda: server.generate_batch(
            [Request(prompt=p, max_new_tokens=new) for p in prompts]))
        return server, reg, [h.tokens for h in handles], read_counts(), dt

    s32, _, toks32, launches32, _ = run("fp32")
    counts32 = s32.compile_counts()
    bytes32 = serve_mod.pool_bytes(s32.engine.pool.cache)
    del s32
    out = {"fp32": launches32}
    for kv_dtype in ("int8", "fp8"):
        server, reg, toks, launches, dt = run(kv_dtype)
        q = quant_lib.resolve_kv_dtype(kv_dtype)
        div = serve_mod.quant_divergences(params32, cfg, prompts, toks32, toks, q)
        err = quant_lib.max_abs_logit_error(params32, cfg, prompts[0], q)
        server.observe_quant_logit_error(err)
        page = telemetry.parse_prometheus(telemetry.render_prometheus(reg))
        gauge = next((v for n, _, v in page["samples"]
                      if n == "mingpt_serve_quant_logit_err_max"), None)
        pool = server.engine.pool.cache
        _, scales = quant_lib.split_scales(pool)
        qbytes = serve_mod.pool_bytes(pool)
        agree = sum(serve_mod.common_prefix(a, b) for a, b in zip(toks32, toks))
        total = sum(len(a) for a in toks32)
        counts = server.compile_counts()
        out[kv_dtype] = launches
        emit({"phase": "serve_quant_parity", "kv_dtype": kv_dtype, "model": "gpt2 124M",
              "dtype": "float32", "slots": 4, "requests": 6, "new_tokens": new,
              "spec_k": 2, "common_prefix": agree, "tokens": total,
              "common_prefix_share": agree / total, "jax_gate_share": 0.9,
              "divergences": div, "tie_x": serve_mod.QUANT_TIE_X,
              "max_abs_logit_err_prompt0": err, "err_gauge": gauge,
              "pool_bytes": qbytes, "scale_bytes": serve_mod.pool_bytes(scales),
              "fp32_pool_bytes": bytes32, "pool_ratio": qbytes / bytes32,
              "shapes": counts, "fp32_shapes": counts32,
              "spec_accept_rate": server.metrics.spec_accept_rate,
              "prefix_hits": server.metrics.prefix_hits, "launches": launches,
              "seconds": dt, "card": card})
        check(all(d["tie"] for d in div),
              f"serve_quant_parity {kv_dtype}: tokens leave the fp32 stream at a "
              f"gap wider than {serve_mod.QUANT_TIE_X} x the logit error: {div}")
        check(counts == counts32, f"serve_quant_parity {kv_dtype}: shapes {counts} "
              f"!= fp32 {counts32}")
        check(qbytes <= 0.27 * bytes32,
              f"serve_quant_parity {kv_dtype}: pool {qbytes} > 0.27 x {bytes32}")
        check(serve_mod.pow2_or_zero(scales),
              f"serve_quant_parity {kv_dtype}: a scale is not a power of two")
        check(gauge is not None and gauge == err and 0 < err < 0.5,
              f"serve_quant_parity {kv_dtype}: err gauge {gauge}, probe {err}")
        check(server.metrics.prefix_hits >= 1 and server.metrics.spec_rounds >= 1,
              f"serve_quant_parity {kv_dtype}: prefix hits / spec rounds missing")
        check(not any(launches.values()), f"quant serving launched kernels: {launches}")
        del server
    return out


def _percentiles(values):
    return {"p50": float(np.percentile(values, 50)),
            "p99": float(np.percentile(values, 99))}


def decode_device_ms(engine, tokens, positions, do_sample, steps=20):
    """One decode step at full occupancy, from device tensors (nothing in a
    step waits for the card): (ms per step over ``steps`` back-to-back
    steps ended by a synchronise; the card's kernel ms per step, summed by
    torch.profiler over its CUDA rows; kernels per step; the eight kernels
    with the most device time and the eight host ops with the most self
    CPU time, ms and calls per step each; the profiler's own overhead
    inflates the host ops' times). A step issues several hundred
    kernels, more than the launch queue holds, so a spin cannot hold them
    all back for CUDA events to time the card alone."""
    n = len(tokens)
    dev = torch.device("cuda")
    gens = [torch.Generator(device=dev).manual_seed(i) if on else None
            for i, on in enumerate(do_sample)]
    args = (torch.tensor(tokens, device=dev), torch.tensor(positions, device=dev),
            torch.ones(n, device=dev), torch.full((n,), 50, device=dev),
            torch.ones(n, device=dev), list(do_sample), gens)

    def run():
        for _ in range(steps):
            engine.decode_on_device(*args)
        torch.cuda.synchronize()

    run()
    _, wall_s = timed(run)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
    events = prof.key_averages()
    rows = [(e.key, device_us(e), e.count) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    top = [{"kernel": k[:80], "ms_per_step": us / 1e3 / steps}
           for k, us, _ in rows[:8]]
    host = sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    top_host = [{"op": e.key[:60], "self_ms_per_step": e.self_cpu_time_total / 1e3 / steps,
                 "calls_per_step": e.count / steps} for e in host[:8]]
    return (wall_s * 1e3 / steps, sum(r[1] for r in rows) / 1e3 / steps,
            sum(r[2] for r in rows) / steps, top, top_host)


SERVE_NEW = 64
# serve_spec's requests, the first of serve's 32: more than its 8 slots, so
# the sharers queued behind them hit the prefix the first sharer stored;
# fewer than 32, since the 'self' draft runs ~40 tokens/s and the smoke has
# a time budget (12 until the MoE-beside-sp and graftaudit legs were paid
# for: 28.7 s for both drafts at 12 on the card)
SERVE_SPEC_REQUESTS = 10
# serve_quant's requests: the first 10 of serve's 32, still more than its 8
# slots (its int8 and fp8 runs took 64.9 s of the smoke at 32 and 22.6 s at
# 16; the pool, the prefix hits and the decode step's profile are read
# alike); and the decode steps its profile reads per window (20 for serve):
# each quantized step issues ~1,340 kernels, whose profile takes most of
# the phase's seconds
SERVE_QUANT_REQUESTS = 10
# the fleets' and tp serving's share of serve's traffic: its first 12 of 32
# requests (at 32 the three phases took ~95 s of a 968.8 s smoke on a slow
# host, ~56 s at 16; the pipeline and checkpoint legs, then the
# MoE-beside-sp and graftaudit legs, are paid for with the cuts)
FLEET_REQUESTS = 12
QUANT_PROFILE_STEPS = 3


def serve_traffic(n_req, vocab=50257):
    """serve's traffic: the first ``n_req`` of its 32 requests (32 to 896
    prompt tokens below ``vocab``, half sharing a 256-token head, one in
    four sampled with top-k 50), 64 new tokens each. (requests, prompt
    lengths, sampled)."""
    from mingpt_distributed_tpu_torch.serving import Request

    rng = np.random.default_rng(SERVE_SEED + 1)
    shared = [i % 2 == 1 for i in range(32)]
    lengths = np.where(shared, rng.integers(257, 897, 32), rng.integers(32, 897, 32))
    lengths[1] = rng.integers(257, 513)  # the first sharer stores the head
    head = rng.integers(0, vocab, 256).tolist()
    prompts = _serve_prompts(rng, lengths, head, shared, vocab)
    sampled = [i % 4 == 3 for i in range(32)]
    reqs = [Request(prompt=p, max_new_tokens=SERVE_NEW, do_sample=s,
                    top_k=50 if s else None, seed=i)
            for i, (p, s) in enumerate(zip(prompts, sampled))]
    return reqs[:n_req], lengths[:n_req], sampled[:n_req]


def pool_bytes_want(cfg, slots, kv_dtype):
    """The bytes of a pool: K and V (one byte per element at int8/fp8, the
    compute dtype's otherwise) and, quantized, their fp32 scale planes (one
    per row and KV head)."""
    rows = 2 * slots * cfg.n_layer * cfg.block_size
    width = cfg.kv_heads * cfg.head_dim
    if kv_dtype == "fp32":
        return rows * width * torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    return rows * width + rows * cfg.kv_heads * 4


def phase_serve(params32, card, kv_dtype="fp32", draft=None, n_req=32, serve_rec=None,
                cfg=None, phase=None, model="gpt2 124M", attrib=False):
    """The serving main path at GPT-2 124M width, bf16, block 1024: 8 slots,
    serve's traffic (``serve_traffic``), chunked prefill (256), default
    buckets, a 256 MiB prefix cache, warmup. Tokens/s, TTFT and ITL
    percentiles, host ms per decode step, pool bytes, peak memory, prefix
    hits, shape counts; for the plain decode step (no ``draft``) also its
    CUDA-event span and the profiler's kernel ms and kernels per step. The
    phase is ``serve`` (the fp32 pool, the bf16 model's dtype),
    ``serve_quant`` (an int8 or fp8 pool) or ``serve_spec`` (a ``draft``:
    'self' or 'self:N', k = 4; host ms per propose, verify and round, set
    beside ``serve_rec``). ``cfg``, ``phase`` and ``model`` name another
    model (``serve_moe``); ``attrib`` turns the server's attribution on and
    adds its program rows and HBM ledger, audited against
    torch.cuda.memory_allocated, to the record."""
    from mingpt_distributed_tpu_torch.serve import draft_from
    from mingpt_distributed_tpu_torch.serving import InferenceServer

    phase = phase or ("serve_spec" if draft else "serve" if kv_dtype == "fp32"
                      else "serve_quant")
    cfg = cfg or gpt2_config("flash", "bfloat16")
    reqs, lengths, sampled = serve_traffic(n_req, cfg.vocab_size)
    token_times = {}

    def on_token(handle, _tok):
        token_times.setdefault(handle.request_id, []).append(time.perf_counter())

    spec_kw = {}
    if draft:
        dparams, dcfg = draft_from(draft, params32, cfg, "cuda")
        spec_kw = dict(draft_params=dparams, draft_cfg=dcfg, spec_k=SPEC_K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    server = InferenceServer(params32, cfg, n_slots=8, prefill_chunk=256,
                             prefix_cache_mb=256, warmup=True, kv_dtype=kv_dtype,
                             on_token=on_token, attrib=attrib, device="cuda", **spec_kw)
    eng = server.engine
    host_ms = {"decode_step": [], "propose": [], "verify": [], "spec_round": [],
               "decode_round": []}
    spans = []

    def host_timed(obj, name, key, events=False):
        real = getattr(obj, name)

        def call(*args):
            if events:
                # CUDA events around the step's work on the card: their
                # span includes the card's idle gaps while the host issues
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            out = real(*args)
            host_ms[key].append((time.perf_counter() - t0) * 1e3)
            if events:
                end.record()
                spans.append((start, end))
            return out
        setattr(obj, name, call)

    host_timed(eng, "decode_step", "decode_step", events=not draft)
    host_timed(server, "_decode_round", "decode_round")
    if draft:
        host_timed(server.spec, "propose", "propose")
        host_timed(server.spec, "verify", "verify")
        host_timed(server, "_spec_round", "spec_round")
    reset_counts()
    handles, dt = timed(lambda: server.generate_batch(reqs))
    launches = read_counts()
    for obj, name in ((eng, "decode_step"), (server, "_decode_round"),
                      (server.spec, "propose"), (server.spec, "verify"),
                      (server, "_spec_round")):
        if obj is not None and name in vars(obj):
            delattr(obj, name)
    torch.cuda.synchronize()
    generated = sum(len(h.tokens) for h in handles)
    itl = [b - a for ts in token_times.values() for a, b in zip(ts, ts[1:])]
    counts = server.compile_counts()
    m = server.metrics
    rec = {"phase": phase, "main_path": phase in ("serve", "serve_moe"), "model": model,
           "dtype": "bfloat16", "kv_dtype": kv_dtype, "block_size": cfg.block_size,
           "slots": 8, "requests": n_req, "sampled_top_k50": sum(sampled),
           "prompt_tokens": int(sum(lengths)), "new_tokens": SERVE_NEW,
           "generated_tokens": generated, "seconds": dt,
           "tokens_per_s": generated / dt,
           "ttft_s": _percentiles([h.ttft_s for h in handles]),
           "itl_s": _percentiles(itl), "decode_rounds": len(host_ms["decode_round"]),
           "decode_round_host_ms": _percentiles(host_ms["decode_round"]),
           "decode_steps": len(host_ms["decode_step"]),
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "pool_bytes": eng.pool.nbytes, "pool_bytes_want": pool_bytes_want(
               cfg, 8, kv_dtype),
           "prefix_hits": m.prefix_hits, "prefix_lookups": m.prefix_lookups,
           "prefill_chunks": m.prefill_chunks, "shapes": counts,
           "buckets": list(eng.buckets), "launches": launches, "card": card}
    if host_ms["decode_step"]:
        rec["decode_step_host_ms"] = _percentiles(host_ms["decode_step"])
    if draft:
        rec.update({
            "draft": draft, "spec_k": SPEC_K, "spec_rounds": m.spec_rounds,
            "accept_rate": m.spec_accept_rate,
            "tokens_per_verify": m.spec_tokens_per_verify_mean,
            "propose_host_ms": _percentiles(host_ms["propose"]),
            "verify_host_ms": _percentiles(host_ms["verify"]),
            "verifies_per_round": len(host_ms["verify"]) / max(1, len(host_ms["spec_round"])),
            "spec_round_host_ms": _percentiles(host_ms["spec_round"]),
            "propose_host_ms_total": sum(host_ms["propose"]),
            "verify_host_ms_total": sum(host_ms["verify"]),
            "decode_step_host_ms_total": sum(host_ms["decode_step"])})
    else:
        span_ms = [a.elapsed_time(b) for a, b in spans]
        positions = [min(int(n) + SERVE_NEW // 2, cfg.block_size - 1) for n in lengths[:8]]
        step_ms, kernel_ms, kernels, top, top_host = decode_device_ms(
            eng, [int(r.prompt[-1]) for r in reqs[:8]], positions, sampled[:8],
            steps=20 if kv_dtype == "fp32" else QUANT_PROFILE_STEPS)
        rec.update({
            "decode_step_event_span_ms": _percentiles(span_ms),
            "decode_ms_per_step_full": step_ms,
            "decode_device_kernel_ms_per_step": kernel_ms,
            "decode_device_busy_share": kernel_ms / step_ms,
            "host_bound": kernel_ms < 0.5 * step_ms,
            "decode_kernels_per_step": kernels, "decode_top_kernels": top,
            "decode_top_host_ops": top_host})
    if attrib:
        report = server.attrib_report(include_live=True)
        rec["attrib_rows"] = [r for r in report["programs"] if r["calls"]]
        rec["hbm"] = report["hbm"]
        rec["watchdog_recompiles"] = server.watchdog.recompiles
    if serve_rec is not None:
        rec["serve"] = {k: serve_rec[k] for k in (
            "tokens_per_s", "ttft_s", "itl_s", "decode_step_host_ms",
            "decode_round_host_ms", "pool_bytes", "peak_allocated_bytes")}
    emit(rec)
    rec["_streams"] = [list(h.tokens) for h in handles]  # serve_tp's reference
    check(all(h.finished and len(h.tokens) == SERVE_NEW and h.finish_reason == "length"
              for h in handles), f"{phase}: a request did not end with {SERVE_NEW} tokens")
    check(all(0 <= t < cfg.vocab_size for h in handles for t in h.tokens),
          f"{phase}: token ids out of range")
    check(counts["decode"] == 1 and all(
        counts[f] <= len(eng.buckets) for f in ("prefill", "prefix_load", "prefix_save")),
        f"{phase}: shapes {counts} outside the ladder {eng.buckets}")
    check(eng.pool.free_count == 8 and server.slots.occupied == 0
          and not server.queue, f"{phase}: a slot or pool row is still held")
    check(eng.pool.nbytes == rec["pool_bytes_want"],
          f"{phase}: pool holds {eng.pool.nbytes} bytes, want {rec['pool_bytes_want']}")
    check(m.prefix_hits >= 1, f"{phase}: no prefix hit")
    if draft:
        check(m.spec_rounds > 0 and counts["verify"] == 1 and counts["draft_decode"] == 1,
              f"{phase}: spec rounds {m.spec_rounds}, shapes {counts}")
        check(server.spec.draft.engine.pool.free_count == 8,
              f"{phase}: a draft slot is still held")
    check(not any(launches.values()), f"{phase} launched kernels: {launches}")
    if attrib:
        hbm = rec["hbm"]
        check(hbm["owners"]["kv_pool"] == eng.pool.nbytes
              and hbm["audit"]["live_bytes"] >= hbm["total_bytes"],
              f"{phase}: HBM ledger {hbm} against the pool's {eng.pool.nbytes} bytes")
        check(server.watchdog.recompiles == 0,
              f"{phase}: {server.watchdog.recompiles} new shapes after warmup")
    del server
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 3b': tensor-parallel serving (tp = 2: this process drives, one
# follower process, gloo, both on the one card)
# ---------------------------------------------------------------------------

# graftaudit: the program audit (analysis/program_audit.py) over the
# serving families at serve's width on cuda:0, tp 1, where the device<->host
# copies are real: serve's engine (bf16, block 1024, 8 slots, prefill chunk
# 256, the default ladder, a 256 MiB prefix store) and a k = 2 speculative
# decoder with the 2-layer draft 'self:2'; every family's call checked
# against its contract (0 findings), its analytic cost against the committed
# budgets' GRAFTAUDIT_SWEEP section. The serving path runs no kernel.
GRAFTAUDIT_SWEEP = "tp1-gpt2-124m"


def phase_graftaudit(params32, card):
    """The audit at serve's width: each family's collectives, host copies
    (exactly its contract's: every one the call makes by design), in-place
    leaves, local heads and allocator growth, the findings (0 expected)
    and the budget section (printed whole, to commit it)."""
    from mingpt_distributed_tpu_torch.analysis import program_audit as pa
    from mingpt_distributed_tpu_torch.serve import draft_from
    from mingpt_distributed_tpu_torch.serving.engine import DecodeEngine
    from mingpt_distributed_tpu_torch.serving.speculative import SpeculativeDecoder
    from mingpt_distributed_tpu_torch.tools import graftaudit as ga

    t0 = time.perf_counter()
    cfg = gpt2_config("flash", "bfloat16")
    dparams, dcfg = draft_from("self:2", params32, cfg, "cuda")

    def build():
        engine = DecodeEngine(params32, cfg, n_slots=8, prefill_chunk=256,
                              prefix_cache_mb=256, device="cuda")
        return engine, SpeculativeDecoder(engine, dparams, dcfg, k=2), ""

    reset_counts()
    ledger, contracts, findings = ga.audit([build])
    counts = read_counts()
    findings, rep = ga.report(ledger, contracts, findings, {"tp": 1, "device": "cuda"},
                              ga.load_budgets(ga.DEFAULT_BUDGETS), GRAFTAUDIT_SWEEP)
    arts = ledger.artifacts
    emit({"phase": "graftaudit", "sweep": GRAFTAUDIT_SWEEP, "model": "gpt2 124M",
          "programs": rep["programs"], "contracts": rep["contracts"],
          "host_transfers": {a.key: [c["kind"] for c in a.host_transfers]
                             for a in arts.values()},
          "alloc_growth_bytes": {a.key: a.alloc_growth for a in arts.values()},
          "findings": rep["findings"], "launches": counts,
          "budget_section": pa.build_budget_section(arts),
          "seconds": time.perf_counter() - t0, "card": card})
    check(not findings, "graftaudit: " + "; ".join(f.render() for f in findings))
    check(counts == expected(), f"graftaudit: the serving families launched {counts}")
    # the card's copies are the contracts' designed ones: a copy the
    # profiler missed would hide a finding
    short = {a.key: len(a.host_transfers) for a in arts.values()
             if len(a.host_transfers) != contracts[a.family].get("host_transfers", 0)}
    check(not short, f"graftaudit: host copies differ from the contracts: {short}")
    torch.cuda.empty_cache()


TP_SERVE = 2
# each rank's pool, read as the allocator's growth when it was made, within
# 1% of the tp = 1 pool's bytes over TP_SERVE
TP_POOL_REL_TOL = 0.01


def tp_serve_group():
    """The tp = 2 group the serving phases share: (group, seconds to spawn
    the follower and join). Started on a thread early in the smoke: until
    the serving phases take it, this process is rank 0 of a group of two
    and nothing else it runs reads the group."""
    from mingpt_distributed_tpu_torch.parallel.mesh import TP_TIMEOUT_S
    from mingpt_distributed_tpu_torch.serving.lockstep import TPGroup

    return timed(lambda: TPGroup(TP_SERVE, "gloo", torch.device("cuda"), TP_TIMEOUT_S))


def tp_rank_checks(phase, srv, want_heads, pool_total, counts):
    """Every rank's report (the driver's and the follower's): pool and
    prefix entries of ``want_heads`` heads, pool bytes by the allocator
    within TP_POOL_REL_TOL of ``pool_total`` / TP_SERVE, the driver's shape
    counts, no flash launch. Returns the reports."""
    reports = [srv.engine.local_report()] + srv.engine.follower_reports()
    want = pool_total / TP_SERVE
    for rep in reports:
        r = rep["rank"]
        check(rep["kv_heads"] == want_heads and rep["kv_shard_count"] == TP_SERVE,
              f"{phase}: rank {r} holds {rep['kv_heads']} pool heads, want {want_heads}")
        check(rep["prefix_heads"] and all(h == want_heads for h in rep["prefix_heads"]),
              f"{phase}: rank {r} prefix entries of {rep['prefix_heads']} heads")
        check(abs(rep["pool_alloc_bytes"] - want) <= TP_POOL_REL_TOL * want,
              f"{phase}: rank {r} pool took {rep['pool_alloc_bytes']} bytes, want {want}")
        check(not any(rep["launches"].values()),
              f"{phase}: rank {r} launched flash kernels {rep['launches']}")
        mine = {f: n for f, n in counts.items() if f in rep["compile_counts"]}
        check(rep["compile_counts"] == mine,
              f"{phase}: rank {r} shapes {rep['compile_counts']}, the driver's {mine}")
    return reports


def phase_serve_tp_parity(params32, card, group):
    """serve_parity's six requests (fp32, 4 slots, chunks of 256, the prefix
    cache) with a 1-layer draft (k = SPEC_K, so rejections roll back) at tp
    = 2 against the single-process server in the same call: tokens equal
    (else only at near-ties by the tie rule, with the tp = 1 server's logits
    as the reference), the largest logit difference, equal shapes, each
    rank's pool at half the bytes and its prefix entries at 6 of 12 heads,
    no flash launch on either rank."""
    from mingpt_distributed_tpu_torch.serve import first_layers
    from mingpt_distributed_tpu_torch.serving import InferenceServer, Request

    cfg, new = gpt2_config("flash", "float32"), PARITY_NEW
    prompts, lengths = parity_prompts(cfg.vocab_size)
    kw = dict(n_slots=4, prefill_chunk=256, prefix_cache_mb=64,
              draft_params=first_layers(params32, 1),
              draft_cfg=dataclasses.replace(cfg, n_layer=1), spec_k=SPEC_K)

    def run(mesh, device):
        server = InferenceServer(params32, cfg, mesh=mesh, device=device, **kw)
        reset_counts()
        with logit_tap(server) as rows:
            handles, dt = timed(lambda: server.generate_batch(
                [Request(prompt=p, max_new_tokens=new) for p in prompts]))
        return server, handles, rows, read_counts(), dt

    one, h1, rows1, _, dt1 = run(None, "cuda")
    ref = [(h.tokens, torch.stack([rows1[(h.request_id, i)] for i in range(new)]))
           for h in h1]
    counts1, pool1, draft_pool1 = (one.compile_counts(), one.engine.pool.nbytes,
                                   one.spec.draft.engine.pool.nbytes)
    del one, rows1
    torch.cuda.empty_cache()
    srv, h2, rows2, launches, dt2 = run(group.mesh, group.device)
    res = tie_rule(h2, ref, rows2, new)
    counts = srv.compile_counts()
    reports = tp_rank_checks("serve_tp_parity", srv, cfg.kv_heads // TP_SERVE, pool1,
                             counts)
    m = srv.metrics
    rec = {"phase": "serve_tp_parity", "model": "gpt2 124M", "dtype": "float32",
           "tp": TP_SERVE, "backend": "gloo, one shared card", "slots": 4,
           "requests": 6, "prompt_lengths": [int(n) for n in lengths], "new_tokens": new,
           "prefill_chunk": 256, "draft_layers": 1, "spec_k": SPEC_K,
           "tokens_equal": [a.tokens == b.tokens for a, b in zip(h1, h2)], **res,
           "spec_accepted": m.spec_accepted, "spec_proposed": m.spec_proposed,
           "prefix_hits": m.prefix_hits, "shapes": counts, "shapes_tp1": counts1,
           "pool_bytes_tp1": pool1, "draft_pool_bytes_tp1": draft_pool1,
           "pool_alloc_bytes_per_rank": [r["pool_alloc_bytes"] for r in reports],
           "prefix_heads_per_rank": [r["prefix_heads"] for r in reports],
           "launches": launches,
           "follower_launches": [r["launches"] for r in reports[1:]],
           "seconds_tp1": dt1, "seconds_tp2": dt2, "card": card}
    emit(rec)
    check(all(len(h.tokens) == new for h in h2), "serve_tp_parity: a request fell short")
    check_tie_rule("serve_tp_parity", res, 6 * new)
    check(counts == counts1, f"serve_tp_parity: shapes {counts} != tp = 1's {counts1}")
    check(m.spec_accepted < m.spec_proposed and m.prefix_hits >= 1,
          f"serve_tp_parity: accepted {m.spec_accepted} of {m.spec_proposed}, "
          f"{m.prefix_hits} prefix hits")
    check(not any(launches.values()), f"serve_tp_parity launched kernels: {launches}")
    del srv, rows2
    torch.cuda.empty_cache()


def phase_serve_tp(params32, card, group, serve_rec):
    """serve's traffic (bf16, 8 slots, its first FLEET_REQUESTS requests,
    64 new, chunks of 256, the prefix cache, warmup) through the tp = 2
    server: tokens/s, TTFT and
    ITL p99, host ms per decode step, the tp collectives' ms per step (the
    card synchronised before each: host traffic alone) and the command
    broadcast's, the ratio to serve's tokens/s in this call (shared card:
    not multi-GPU throughput); the greedy streams by serve's tie rule at
    bf16 (``forced_tie_rule``: each token solo's argmax, or within 3 e of
    it), and how many equal serve's own streams."""
    from mingpt_distributed_tpu_torch.parallel import distributed as D
    from mingpt_distributed_tpu_torch.serving import InferenceServer
    from mingpt_distributed_tpu_torch.serving import lockstep

    cfg = gpt2_config("flash", "bfloat16")
    reqs, lengths, sampled = serve_traffic(FLEET_REQUESTS, cfg.vocab_size)
    token_times = {}

    def on_token(handle, _tok):
        token_times.setdefault(handle.request_id, []).append(time.perf_counter())

    server = InferenceServer(params32, cfg, n_slots=8, prefill_chunk=256,
                             prefix_cache_mb=256, warmup=True, on_token=on_token,
                             mesh=group.mesh, device=group.device)
    eng = server.engine
    stats = {"step_ms": [], "coll_s": 0.0, "coll_calls": 0, "cmd_s": 0.0, "cmd_calls": 0}
    inside = []
    real = {"all_reduce": D.all_reduce, "reduce_to_first": D.reduce_to_first}
    real_send, real_step = lockstep.Channel.send, eng.decode_step

    def timed_collective(fn):
        def run(*args, **kwargs):
            if not inside:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                stats["coll_s"] += time.perf_counter() - t0
                stats["coll_calls"] += 1
        return run

    def send(ch, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real_send(ch, *args, **kwargs)
        finally:
            if inside:
                stats["cmd_s"] += time.perf_counter() - t0
                stats["cmd_calls"] += 1

    def decode_step(*args):
        inside.append(1)
        t0 = time.perf_counter()
        try:
            return real_step(*args)
        finally:
            stats["step_ms"].append((time.perf_counter() - t0) * 1e3)
            inside.clear()

    for name, fn in real.items():
        setattr(D, name, timed_collective(fn))
    lockstep.Channel.send = send
    eng.decode_step = decode_step
    reset_counts()
    try:
        with logit_tap(server) as rows:
            handles, dt = timed(lambda: server.generate_batch(reqs))
    finally:
        for name, fn in real.items():
            setattr(D, name, fn)
        lockstep.Channel.send = real_send
        del eng.decode_step
    launches = read_counts()
    greedy = [i for i, r in enumerate(reqs) if not r.do_sample]
    res = forced_tie_rule(params32, cfg, [(handles[i].request_id, list(reqs[i].prompt),
                                           handles[i].tokens) for i in greedy], rows)
    same = sum(handles[i].tokens == serve_rec["_streams"][i] for i in greedy)
    n_greedy = len(greedy)
    del rows
    generated = sum(len(h.tokens) for h in handles)
    itl = [b - a for ts in token_times.values() for a, b in zip(ts, ts[1:])]
    steps = len(stats["step_ms"])
    reports = tp_rank_checks("serve_tp", server, cfg.kv_heads // TP_SERVE,
                             pool_bytes_want(cfg, 8, "fp32"), server.compile_counts())
    rec = {"phase": "serve_tp", "model": "gpt2 124M", "dtype": "bfloat16", "tp": TP_SERVE,
           "backend": "gloo, one shared card", "slots": 8, "requests": len(reqs),
           "sampled_top_k50": sum(sampled), "prompt_tokens": int(sum(lengths)),
           "new_tokens": SERVE_NEW, "generated_tokens": generated, "seconds": dt,
           "tokens_per_s": generated / dt,
           "ratio_to_serve_tokens_per_s": generated / dt / serve_rec["tokens_per_s"],
           "throughput_note": "shared-card, not multi-GPU throughput: 2 gloo ranks on "
                              "one H100, collectives through host memory",
           "serve_tokens_per_s": serve_rec["tokens_per_s"],
           "ttft_s": _percentiles([h.ttft_s for h in handles]), "itl_s": _percentiles(itl),
           "decode_steps": steps, "decode_step_host_ms": _percentiles(stats["step_ms"]),
           "serve_decode_step_host_ms": serve_rec["decode_step_host_ms"],
           "tp_collective_ms_per_step": stats["coll_s"] * 1e3 / steps,
           "tp_collectives_per_step": stats["coll_calls"] / steps,
           "command_broadcast_ms_per_step": stats["cmd_s"] * 1e3 / steps,
           "commands_per_step": stats["cmd_calls"] / steps,
           "greedy_requests": n_greedy, "greedy_streams_equal_to_serve": same,
           "tie_rule": "teacher-forced (forced_tie_rule)", **res,
           "prefix_hits": server.metrics.prefix_hits,
           "shapes": server.compile_counts(),
           "pool_alloc_bytes_per_rank": [r["pool_alloc_bytes"] for r in reports],
           "launches": launches,
           "follower_launches": [r["launches"] for r in reports[1:]], "card": card}
    emit(rec)
    check(all(h.finished and len(h.tokens) == SERVE_NEW for h in handles),
          f"serve_tp: a request did not end with {SERVE_NEW} tokens")
    check_tie_rule("serve_tp", res, n_greedy * SERVE_NEW)
    check(not any(launches.values()), f"serve_tp launched kernels: {launches}")
    check(eng.pool.free_count == 8 and not server.queue, "serve_tp: a slot is still held")
    del server, eng
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 3c: mixture of experts at Mixtral-8x7B width
# ---------------------------------------------------------------------------

# Mixtral-8x7B's widths (the mixtral-8x7b preset: d 4096, 32 heads over 8
# KV heads, hd 128, SwiGLU experts of 14336, E = 8, top-2, V = 32000, RoPE
# theta 1e6), cut in depth to fit one card with room to train: 1 layer for
# the train step (1.71 G parameters, ~27 GB with fp32 gradients and Adam
# moments), 2 for serving (3.17 G, 12.66 GB fp32). Random weights from
# fixed seeds.
MOE_TOKENS = 256
# moe_check: the layer's bf16 output against fp32 on the same bf16-rounded
# input (so both route alike): max |diff| over max |fp32 out|
MOE_BF16_REL_TOL = 2e-2
# E = 1, k = 1, ample capacity: the MoE layer against the dense SwiGLU
# with the same weights, fp32 (the products are summed in another order)
MOE_E1_REL_TOL = 1e-4
MOE_TRAIN_T, MOE_TRAIN_B, MOE_TRAIN_STEPS = 4096, 2, 3
MOE_SERVE_LAYERS = 2
# K1/K2 at the shape the MoE train step gives them, bf16
MOE_KERNEL_CASE = ("mixtral_train", MOE_TRAIN_B, MOE_TRAIN_T, 32, 8, 128, None, None)
# the MoE step's first loss against the same step's loss through plain
# attention, relative
MOE_PLAIN_LOSS_REL_TOL = 1e-2


def mixtral_config(dtype, n_layer, block_size, attention="flash", capacity_factor=None):
    """The mixtral-8x7b preset at ``n_layer`` layers and ``block_size``
    positions (the preset's own 8192 would win over a block_size given to
    make), no dropout."""
    from mingpt_distributed_tpu_torch.config import GPTConfig

    cfg = GPTConfig.make(model_type="mixtral-8x7b", attention=attention, dtype=dtype,
                         embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    kw = {"n_layer": n_layer, "block_size": block_size}
    if capacity_factor is not None:
        kw["moe_capacity_factor"] = capacity_factor
    return dataclasses.replace(cfg, **kw)


def mixtral_params(cfg, seed=0):
    from mingpt_distributed_tpu_torch.models import gpt

    return gpt.init(cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")


def moe_layer_flops(cfg, tokens, per_row=False, rows=1):
    from mingpt_distributed_tpu_torch.ops import moe

    return moe.moe_flops(tokens, cfg.n_embd, int(cfg.ffn_mult * cfg.n_embd),
                         cfg.n_experts, cfg.moe_top_k, cfg.moe_capacity_factor,
                         cfg.swiglu, per_row=per_row, rows=rows)


def routed_train_flops_per_token(cfg, t, b):
    """Training operations per token as the step runs them: 3 x the
    forward's matrix products, the experts over their whole capacity
    buffers with the router, dispatch and combine (``moe_layer_flops``),
    plus flops_per_token's attention term 12 L d T. flops_per_token itself
    (the JAX formula) counts one dense FFN per layer."""
    d, kv = cfg.n_embd, cfg.kv_heads * cfg.head_dim
    proj = 2 * (d * (d + 2 * kv) + d * d)
    fwd = cfg.n_layer * (proj + moe_layer_flops(cfg, b * t) / (b * t)) \
        + 2 * d * cfg.vocab_size
    return 3 * fwd + 12 * cfg.n_layer * d * t


def phase_moe_check(card):
    """moe_mlp at Mixtral-8x7B width on 256 tokens: bf16 against fp32 on the
    same bf16-rounded input (the router runs in fp32 in both, so both route
    alike: equal aux loss), and with one expert against the dense SwiGLU
    MLP; device ms of the bf16 layer and of casting one layer's expert
    weights to bf16 (what every call pays), beside their routed operations
    and bytes."""
    from mingpt_distributed_tpu_torch.ops import layers as L
    from mingpt_distributed_tpu_torch.ops import moe

    cfg = mixtral_config("bfloat16", 1, MOE_TRAIN_T)
    d, f, e = cfg.n_embd, int(cfg.ffn_mult * cfg.n_embd), cfg.n_experts
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((1, MOE_TOKENS, d), generator=g, device="cuda").bfloat16()

    def w(*shape, std=0.02):
        return torch.randn(shape, generator=g, device="cuda") * std

    wr, w1, w2, wg = w(d, e, std=1.0), w(e, d, f), w(e, f, d), w(e, d, f)
    kw = dict(top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor, w_gate=wg)
    with torch.no_grad():
        out16, aux16 = moe.moe_mlp(x, wr, w1, w2, **kw)
        out32, aux32 = moe.moe_mlp(x.float(), wr, w1, w2, **kw)
        one, _ = moe.moe_mlp(x.float(), torch.zeros((d, 1), device="cuda"), w1[:1],
                             w2[:1], top_k=1, capacity_factor=2.0, w_gate=wg[:1])
        dense = L.mlp_swiglu(x.float(), wg[0], w1[0], w2[0])
        layer_ms = cuda_ms(lambda: moe.moe_mlp(x, wr, w1, w2, **kw), iters=5)
        cast_ms = cuda_ms(lambda: [t.to(torch.bfloat16) for t in (w1, w2, wg)], iters=5)
    err = ((out16.float() - out32).abs().max() / out32.abs().max()).item()
    e1_err = ((one - dense).abs().max() / dense.abs().max()).item()
    flops = moe_layer_flops(cfg, MOE_TOKENS)
    weight_bytes = 3 * e * d * f * 4
    rec = {"phase": "moe_check", "model": "mixtral-8x7b width", "tokens": MOE_TOKENS,
           "experts": e, "top_k": cfg.moe_top_k, "capacity_factor": cfg.moe_capacity_factor,
           "bf16_vs_fp32_max_rel_err": err, "tol": MOE_BF16_REL_TOL,
           "aux_bf16": aux16.item(), "aux_fp32": aux32.item(),
           "e1_vs_dense_swiglu_max_rel_err": e1_err, "e1_tol": MOE_E1_REL_TOL,
           "layer_ms_bf16": layer_ms, "routed_gflop": flops / 1e9,
           "layer_bound_ms": roofline_ms(weight_bytes, [(flops, H100_SXM["bfloat16"])])[0],
           "expert_cast_ms_per_layer": cast_ms,
           "expert_cast_bytes_per_layer": weight_bytes * 3 // 2,
           "expert_cast_bound_ms": roofline_ms(weight_bytes * 3 // 2)[0], "card": card}
    emit(rec)
    check(bool(torch.isfinite(out16).all()) and bool(torch.isfinite(out32).all()),
          "moe_check: non-finite output")
    check(err <= MOE_BF16_REL_TOL, f"moe_check: bf16 vs fp32 {err} > {MOE_BF16_REL_TOL}")
    check(aux16.item() == aux32.item(), "moe_check: bf16 and fp32 routed differently")
    check(e1_err <= MOE_E1_REL_TOL, f"moe_check: E=1 vs dense SwiGLU {e1_err}")
    del w1, w2, wg
    torch.cuda.empty_cache()
    return rec


def phase_moe_train(fa, card):
    """The MoE training path: make_train_step on the mixtral-8x7b preset
    at 1 layer, T = 4096, batch 2, bf16, flash attention, no dropout. First
    K1, the prep pass, K2a/K2b and K2c against their plain versions at the
    shape this step gives them (bf16); the step's first loss against the
    same forward through plain attention; then MOE_TRAIN_STEPS split steps
    (1 K1, 1 prep, 1 K2a, 1 K2b launch each) and MOE_TRAIN_STEPS with
    FLASH_FUSED_BWD=1 (1 K1, 1 prep, 1 K2c each) on one state: step ms,
    tokens/s, the trainer's MFU (flops_per_token, the JAX formula) and the
    routed-operations MFU, peak memory, launches. Returns (split, fused)
    records."""
    from mingpt_distributed_tpu_torch.config import OptimizerConfig
    from mingpt_distributed_tpu_torch.models import gpt
    from mingpt_distributed_tpu_torch.training.metrics import flops_per_token
    from mingpt_distributed_tpu_torch.training.optimizer import make_optimizer
    from mingpt_distributed_tpu_torch.training.trainer import (
        TrainState, make_train_step, trainable)

    i = len(KERNEL_CASES) + len(FWD_RING_CASES) + len(BWD_RING_CASES)
    for fn in (fwd_case, prep_case, bwd_case, fused_case):
        rec, fails = fn(fa, i, MOE_KERNEL_CASE, torch.bfloat16)
        emit(rec)
        check(not fails, "; ".join(msg for _, msg in fails))
    torch.cuda.empty_cache()

    cfg = mixtral_config("bfloat16", 1, MOE_TRAIN_T)
    t, b = MOE_TRAIN_T, MOE_TRAIN_B
    params = trainable(mixtral_params(cfg))
    state = TrainState(params, make_optimizer(OptimizerConfig(), params, 1.0))
    g = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (b, t + 1), generator=g, device="cuda")
    batch = (tokens[:, :-1], tokens[:, 1:])
    with torch.no_grad():
        _, plain_loss = gpt.forward(params, batch[0], dataclasses.replace(
            cfg, attention="einsum"), targets=batch[1], return_logits=False)
    plain_loss = plain_loss.item()
    torch.cuda.empty_cache()
    step = make_train_step(cfg)
    fpt = flops_per_token(cfg, t)
    routed = routed_train_flops_per_token(cfg, t, b)
    peak = PEAK_FLOPS[torch.bfloat16]
    recs = {}
    for fused in (False, True):
        with fused_switch(fused):
            first = step(state, batch)["loss"].item()  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            losses = [step(state, batch)["loss"] for _ in range(MOE_TRAIN_STEPS)]
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / MOE_TRAIN_STEPS
            counts = read_counts()
        n = MOE_TRAIN_STEPS
        want = (expected(flash_fwd=n, flash_bwd_prep=n, flash_bwd_fused=n) if fused
                else expected(flash_fwd=n, flash_bwd_prep=n, flash_bwd_dq=n,
                              flash_bwd_dkv=n))
        tps = b * t / dt
        phase = "moe_train_step_fused" if fused else "moe_train_step"
        rec = {"phase": phase, "main_path": not fused, "flash_fused_bwd": fused,
               "model": "mixtral-8x7b width, 1 layer", "params": gpt.param_count(params),
               "batch": b, "seq": t, "dtype": cfg.dtype, "steps": n,
               "experts": cfg.n_experts, "top_k": cfg.moe_top_k,
               "capacity_factor": cfg.moe_capacity_factor,
               "launches": counts, "launches_want": want, "step_ms": dt * 1e3,
               "tokens_per_s": tps, "flops_per_token": fpt, "mfu": fpt * tps / peak,
               "routed_flops_per_token": routed, "routed_mfu": routed * tps / peak,
               "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
               "warmup_loss": first, "losses": [v.item() for v in losses],
               "card": card}
        if not fused:
            rec.update(plain_attention_loss=plain_loss,
                       plain_loss_rel_err=abs(first - plain_loss) / abs(plain_loss),
                       plain_loss_tol=MOE_PLAIN_LOSS_REL_TOL)
        emit(rec)
        recs[fused] = rec
        check(counts == want, f"{phase}: launches {counts}, want {want}")
        check(all(math.isfinite(v) for v in rec["losses"]), f"{phase}: non-finite loss")
        check(rec["losses"][-1] < first, f"{phase}: the loss on a repeated batch did not fall")
    check(recs[False]["plain_loss_rel_err"] <= MOE_PLAIN_LOSS_REL_TOL,
          f"moe_train_step: first loss {recs[False]['warmup_loss']} against plain "
          f"attention's {plain_loss}")
    del state, params, batch, tokens
    torch.cuda.empty_cache()
    return recs[False], recs[True]


def phase_serve_moe(card):
    """Serving at Mixtral-8x7B width, 2 layers, block 1024 (serve's
    traffic needs at most 960 positions): serve_moe_parity (fp32, capacity
    factor E / k = 4 so no token drops and the server's per-slot routing
    equals solo decode's, serve_parity's requests and tie rule) and
    serve_moe (bf16 compute over the same fp32 weights, the preset's
    capacity factor 1.25, serve's traffic, attribution on: its prefill and
    decode rows and the HBM ledger against torch.cuda.memory_allocated).
    Returns (parity launches, serve_moe record)."""
    cfg32 = mixtral_config("float32", MOE_SERVE_LAYERS, 1024, capacity_factor=4.0)
    check(cfg32.moe_capacity_factor >= cfg32.n_experts / cfg32.moe_top_k,
          "serve_moe_parity: capacity binds")
    params = mixtral_params(cfg32)
    phase_serve_parity(params, card, cfg=cfg32, phase="serve_moe_parity",
                       model="mixtral-8x7b width, 2 layers")
    launches = read_counts()
    cfg16 = mixtral_config("bfloat16", MOE_SERVE_LAYERS, 1024)
    rec = phase_serve(params, card, cfg=cfg16, phase="serve_moe",
                      model="mixtral-8x7b width, 2 layers", attrib=True)
    del params
    torch.cuda.empty_cache()
    return launches, rec


def _served(params32, cfg, reqs, **kw):
    """serve's server (8 slots, chunked prefill 256, a 256 MiB prefix cache,
    warmup) over ``reqs`` with the options ``kw``: (server, handles,
    seconds, host ms of each decode step)."""
    from mingpt_distributed_tpu_torch.serving import InferenceServer

    server = InferenceServer(params32, cfg, n_slots=8, prefill_chunk=256,
                             prefix_cache_mb=256, warmup=True, device="cuda", **kw)
    eng, step_ms = server.engine, []
    real = eng.decode_step

    def decode_step(*args):
        t0 = time.perf_counter()
        out = real(*args)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    eng.decode_step = decode_step
    handles, dt = timed(lambda: server.generate_batch(reqs))
    del eng.decode_step
    return server, handles, dt, step_ms


def phase_serve_telemetry(params32, card, tmp):
    """serve (GPT-2 124M width, bf16, 8 slots) on its first 16 requests
    with request tracing (a JSONL sink), the flight recorder, attribution
    and a TelemetryServer: the trace file, the flight dump (on demand and
    from /debug/flight) and the attribution report (/attrib) through the
    port's validators; the SLO report over the traces; the prefill and
    decode rows; the watchdog at 0 after warmup; 0 launches. What the
    instruments cost: the same requests without them, before and after
    (plain, traced, plain), tokens/s and host ms per decode step."""
    import urllib.request

    from mingpt_distributed_tpu_torch import telemetry

    cfg = gpt2_config("flash", "bfloat16")
    reqs, _, _ = serve_traffic(16)
    plain = [_served(params32, cfg, reqs)[1:]]
    reg = telemetry.MetricsRegistry()
    flight = telemetry.FlightRecorder(out_dir=os.path.join(tmp, "flight"), registry=reg)
    flight.metrics_providers["process"] = lambda: telemetry.render_prometheus(reg)
    trace_path = os.path.join(tmp, "traces.jsonl")
    recorder = telemetry.TraceRecorder(sink=telemetry.trace_sink(trace_path),
                                       registry=reg, flight=flight)
    tserver = telemetry.TelemetryServer(reg, port=0)
    try:
        reset_counts()
        server, handles, dt, step_ms = _served(
            params32, cfg, reqs, registry=reg, trace_recorder=recorder, attrib=True,
            recompile_fail=True)
        launches = read_counts()
        tserver.flight_provider = lambda: flight.snapshot("on_demand")
        tserver.attrib_provider = server.attrib_report
        with urllib.request.urlopen(tserver.url("/attrib"), timeout=30) as resp:
            served = json.loads(resp.read().decode())
        with urllib.request.urlopen(tserver.url("/debug/flight"), timeout=30) as resp:
            snap = json.loads(resp.read().decode())
    finally:
        tserver.close()
    plain.append(_served(params32, cfg, reqs)[1:])
    flight.dump("smoke")
    recorder.close()
    traces = telemetry.load_trace_jsonl(trace_path)
    _, dumps = telemetry.load_flight_dir(flight.out_dir)
    telemetry.validate_flight_dump(snap)
    telemetry.validate_attrib_report(served)
    report = server.attrib_report()
    telemetry.validate_attrib_report(report)
    with open(os.path.join(tmp, "attrib.json"), "w") as f:  # for phase_trace_summary
        f.write(telemetry.dump_attrib_report(report))
    slo = telemetry.evaluate_slos(recorder.completed_requests(),
                                  telemetry.parse_slo_spec("default"))
    rows = [r for r in report["programs"] if r["family"] in ("prefill", "decode")
            and r["calls"]]
    generated = sum(len(h.tokens) for h in handles)
    rec = {"phase": "serve_telemetry", "model": "gpt2 124M", "dtype": "bfloat16",
           "slots": 8, "requests": len(reqs), "generated_tokens": generated,
           "seconds": dt, "tokens_per_s": generated / dt,
           "decode_step_host_ms": _percentiles(step_ms),
           "plain_tokens_per_s": [sum(len(h.tokens) for h in hs) / t for hs, t, _ in plain],
           "plain_decode_step_host_ms": [_percentiles(ms) for _, _, ms in plain],
           "tokens_equal_to_plain": [[h.tokens for h in handles] == [h.tokens for h in hs]
                                     for hs, _, _ in plain],
           "traces": len(traces), "trace_records": sum(
               len(v["spans"]) + len(v["events"]) + 1 for v in traces.values()),
           "flight_dumps": len(dumps), "flight_records": len(snap["records"]),
           "slo": {k: slo[k] for k in ("grade", "attained", "evaluable", "objectives")},
           "attrib_rows": rows, "hbm_owners": report["hbm"]["owners"],
           "watchdog_recompiles": server.watchdog.recompiles, "launches": launches,
           "card": card}
    emit(rec)
    check(len(traces) == len(reqs) and all(
        v["request"]["n_tokens"] == SERVE_NEW for v in traces.values()),
        f"serve_telemetry: {len(traces)} traces for {len(reqs)} requests")
    check(server.watchdog.recompiles == 0, "serve_telemetry: new shapes after warmup")
    check({r["family"] for r in rows} == {"prefill", "decode"},
          f"serve_telemetry: attribution rows {rows}")
    check(not any(launches.values()), f"serve_telemetry launched kernels: {launches}")
    del server
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 3d: the in-process fleet and the traffic lab at GPT-2 124M width
# ---------------------------------------------------------------------------

FLEET_CHAOS = "crash:nth=6:match=replica0;slow:every=1:delay=0.25:match=replica1"
FLEET_REPLICAS, FLEET_SLOTS = 3, 2
MIGRATE_PROMPT, MIGRATE_ROWS = 300, 256


@contextlib.contextmanager
def router_faults():
    """Counts every crash and step failure any fleet Router handles while
    open: {"crash": n, "step_failure": n}. The fleet phases hold these to
    the faults the injector fired, so a real error in a replica (a CUDA
    fault, say) cannot pass as injected chaos."""
    from mingpt_distributed_tpu_torch.serving import fleet

    seen = {"crash": 0, "step_failure": 0}
    real = {"crash": fleet.Router._handle_crash,
            "step_failure": fleet.Router._handle_step_failure}

    def counting(kind):
        def call(self, rep, exc):
            seen[kind] += 1
            print(f"[fleet] {kind} on {rep.name}: {exc!r}", file=sys.stderr)
            return real[kind](self, rep, exc)
        return call

    fleet.Router._handle_crash = counting("crash")
    fleet.Router._handle_step_failure = counting("step_failure")
    try:
        yield seen
    finally:
        fleet.Router._handle_crash = real["crash"]
        fleet.Router._handle_step_failure = real["step_failure"]


def fleet_prompts(router, n_per, lo=5, hi=300, vocab=50257, seed=SERVE_SEED + 2):
    """Seeded prompts of lo..hi tokens, ``n_per`` landing on each replica by
    the router's prefix affinity (the chaos spec names replicas, so work
    must reach the named ones), in replica order."""
    rng = np.random.default_rng(seed)
    per = {i: [] for i in range(len(router.supervisor.replicas))}
    while any(len(v) < n_per for v in per.values()):
        p = rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).tolist()
        i = router._affinity_index(p)
        if len(per[i]) < n_per:
            per[i].append(p)
    return [p for i in sorted(per) for p in per[i]]


def migrate_check(params32, cfg, kv_dtype):
    """The migration seam at full width: a 300-token prompt prefilled on a
    source server (chunked 256: rows 0-255, then the 44-row tail), its
    ``migratable_rows`` (256) extracted and adopted into a second server's
    prefix store; that server must hit all 256 rows, prefill only the tail
    and continue exactly as the source did, with the adopted payloads (and
    an int8 pool's scale planes) bit-equal to the extracted ones."""
    from mingpt_distributed_tpu_torch.serving import InferenceServer, Request

    rng = np.random.default_rng(SERVE_SEED + 3)
    prompt = rng.integers(0, cfg.vocab_size, MIGRATE_PROMPT).tolist()
    kw = dict(n_slots=2, prefill_chunk=256, kv_dtype=kv_dtype, device="cuda")
    src = InferenceServer(params32, cfg, **kw)
    h = src.submit(Request(prompt=prompt, max_new_tokens=PARITY_NEW))
    while h.prefilling or h.slot is None:
        src.step()
    rows = src.engine.migratable_rows(len(prompt), h.prefill_pos)
    entry = src.engine.extract_slot_rows(h.slot, rows)
    src.run_until_drained()
    dst = InferenceServer(params32, cfg, prefix_cache_mb=64, **kw)
    adopted = dst.engine.adopt_prefix_entry(prompt[:rows], entry)
    stored = dict(dst.engine.prefix_store.entries()).get(tuple(prompt[:rows]), {})
    h2 = dst.generate_batch([Request(prompt=prompt, max_new_tokens=PARITY_NEW)])[0]
    lane = {n: a[:, 0:1, :rows] for n, a in dst.engine.pool.cache.items()}
    bit_equal = (sorted(stored) == sorted(entry) and all(
        torch.equal(stored[n], entry[n]) and torch.equal(lane[n], entry[n])
        for n in entry))
    rec = {"kv_dtype": kv_dtype, "prompt_tokens": len(prompt), "rows": rows,
           "adopted": adopted, "leaves": {n: str(a.dtype) for n, a in entry.items()},
           "entry_bytes": sum(int(a.nbytes) for a in entry.values()),
           "hit_rows": h2.prefix_rows, "prefix_hits": dst.metrics.prefix_hits,
           "tokens_equal": h2.tokens == h.tokens, "bit_equal": bit_equal}
    check(rows == MIGRATE_ROWS and adopted and h2.prefix_rows == rows
          and dst.metrics.prefix_hits == 1,
          f"fleet_parity: migration at {kv_dtype} did not hit {MIGRATE_ROWS} rows: {rec}")
    check(rec["tokens_equal"] and len(h.tokens) == PARITY_NEW,
          f"fleet_parity: the adopted rows' continuation differs at {kv_dtype}: "
          f"{h2.tokens} vs {h.tokens}")
    check(bit_equal, f"fleet_parity: migrated {kv_dtype} rows are not bit-equal")
    return rec


def phase_fleet_parity(params32, card):
    """The in-process fleet at GPT-2 124M width, fp32: 3 replicas x 2 slots
    on one VirtualClock under the chaos spec FLEET_CHAOS (replica0 crashes
    in its 6th round, replica1 is slowed 0.25 virtual seconds per round), 6
    greedy requests of 5 to 300 prompt tokens (two landing on each replica
    by affinity), 24 new tokens each, attribution on each replica. Every
    stream token-identical to solo decode and to what the caller was
    streamed; the crash, retry, duplicate, health and drain counters; device
    memory back within one pool's bytes after the restart; each replica's
    HBM owners beside one memory_allocated reading (the shared tree once);
    then the migration seam at fp32 and int8 (``migrate_check``)."""
    from mingpt_distributed_tpu_torch.serving import (
        ReplicaSupervisor,
        Request,
        Router,
        ShedError,
        VirtualClock,
        default_server_factory,
    )
    from mingpt_distributed_tpu_torch.telemetry import tree_bytes
    from mingpt_distributed_tpu_torch.training.faults import ServingFaultInjector

    gc.collect()  # earlier phases' servers (reference cycles) go first
    cfg, new = gpt2_config("flash", "float32"), PARITY_NEW
    injector = ServingFaultInjector(FLEET_CHAOS)
    supervisor = ReplicaSupervisor(
        default_server_factory(params32, cfg, n_slots=FLEET_SLOTS, attrib=True,
                               device="cuda"),
        n_replicas=FLEET_REPLICAS, clock=VirtualClock(tick_s=0.001),
        injector=injector, max_restarts=1, restart_backoff_s=0.01, itl_slo_s=0.1)
    streamed = {}
    router = Router(supervisor, max_retries=3, retry_backoff_s=0.01,
                    breaker_reset_s=0.05,
                    on_token=lambda fh, t: streamed.setdefault(fh.request_id, []).append(t))
    memory = {}
    real_mark, real_poll = supervisor.mark_crashed, supervisor.poll_restarts

    def mark_crashed(rep):
        gc.collect()  # garbage of earlier phases is not the crashed server's
        torch.cuda.synchronize()
        memory["before_crash"] = torch.cuda.memory_allocated()
        memory["pool_bytes"] = rep.server.engine.pool.nbytes
        real_mark(rep)

    def poll_restarts():
        out = real_poll()
        if out:
            torch.cuda.synchronize()
            memory["after_restart"] = torch.cuda.memory_allocated()
        return out

    supervisor.mark_crashed, supervisor.poll_restarts = mark_crashed, poll_restarts
    prompts = fleet_prompts(router, FLEET_SLOTS)
    reset_counts()
    with router_faults() as faults:
        handles, dt = timed(lambda: router.generate_batch(
            [Request(prompt=p, max_new_tokens=new) for p in prompts]))
    launches = read_counts()
    summary = router.summary()
    solo = [solo_greedy(params32, cfg, p, new)[0] for p in prompts]
    exact = [h.tokens == want for h, want in zip(handles, solo)]
    reps = summary["replicas"]
    router.drain()
    try:
        router.submit(Request(prompt=prompts[0], max_new_tokens=2))
        drain_reason = None
    except ShedError as e:
        drain_reason = e.reason
    owners = {rep.name: rep.server.attrib_report(include_live=True)["hbm"]
              for rep in supervisor.replicas}
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    params_bytes = tree_bytes(params32)
    pools = sum(rep.server.engine.pool.nbytes for rep in supervisor.replicas)
    fired = {op: sum(f.startswith(op + ":") for f in injector.fired)
             for op in ("crash", "poison", "slow")}
    rec = {"phase": "fleet_parity", "model": "gpt2 124M", "dtype": "float32",
           "replicas": FLEET_REPLICAS, "slots": FLEET_SLOTS, "chaos": FLEET_CHAOS,
           "requests": len(prompts), "prompt_lengths": [len(p) for p in prompts],
           "new_tokens": new, "tokens_exact": sum(exact),
           "attempts": [h.attempts for h in handles],
           "replica_of": [h.replica for h in handles],
           "summary": summary, "fired": fired, "router_faults": faults,
           "drain_shed_reason": drain_reason, "memory": memory,
           "hbm_owners": {n: o["owners"] for n, o in owners.items()},
           "hbm_audit_live_bytes": {n: o["audit"]["live_bytes"] for n, o in owners.items()},
           "memory_allocated": allocated, "params_bytes_once": params_bytes,
           "pools_bytes": pools, "launches": launches, "seconds": dt, "card": card}
    rec["migration"] = [migrate_check(params32, cfg, kv) for kv in ("fp32", "int8")]
    emit(rec)
    check(all(h.finish_reason == "length" for h in handles) and all(exact),
          f"fleet_parity: {sum(exact)}/{len(handles)} streams equal solo decode")
    check(all(streamed.get(h.request_id) == h.tokens for h in handles),
          "fleet_parity: the caller's stream differs from the handle's (a "
          "duplicate or lost emission)")
    check(reps["replica0"]["crashes"] >= 1 and reps["replica0"]["state"] == "ready",
          f"fleet_parity: replica0 {reps['replica0']}")
    check(summary["retries_by_reason"]["crash"] >= 1
          and summary["duplicates_suppressed"] >= 1,
          f"fleet_parity: retries {summary['retries_by_reason']}, duplicates "
          f"{summary['duplicates_suppressed']}")
    check("itl_p99" in reps["replica1"]["health_reasons"],
          f"fleet_parity: replica1 not gated on itl_p99: {reps['replica1']}")
    check(drain_reason == "draining", f"fleet_parity: drain shed {drain_reason!r}")
    check(faults == {"crash": fired["crash"], "step_failure": fired["poison"]},
          f"fleet_parity: router faults {faults} beyond the injected {fired}")
    check({"before_crash", "after_restart"} <= set(memory) and abs(
        memory["after_restart"] - memory["before_crash"]) < memory["pool_bytes"],
        f"fleet_parity: device memory not back after the restart: {memory}")
    check(allocated - pools < 2 * params_bytes,
          f"fleet_parity: {allocated} bytes allocated for {pools} pool bytes and "
          f"{params_bytes} parameter bytes: a replica copied the tree")
    check(all(o["audit"]["live_bytes"] >= o["total_bytes"] for o in owners.values()),
          f"fleet_parity: a replica's HBM ledger exceeds the card's {owners}")
    check(not any(launches.values()), f"fleet_parity launched kernels: {launches}")
    del router, supervisor
    torch.cuda.empty_cache()
    return launches


def _fleet_run(params32, cfg, reqs, tap=False):
    """serve's requests through a fresh 2 x 4-slot fleet on the wall clock:
    (router, handles, seconds, token stamps per request, host ms per router
    round, router faults, launches, the engines' logit rows when ``tap``)."""
    from mingpt_distributed_tpu_torch.serving import (
        ReplicaSupervisor,
        Router,
        WallClock,
        default_server_factory,
    )

    supervisor = ReplicaSupervisor(
        default_server_factory(params32, cfg, n_slots=4, prefill_chunk=256,
                               prefix_cache_mb=256, warmup=True, device="cuda"),
        n_replicas=2, clock=WallClock())
    token_times = {}
    router = Router(supervisor, on_token=lambda fh, _t: token_times.setdefault(
        fh.request_id, []).append(time.perf_counter()))
    round_ms = []
    real_step = router.step

    def step():
        t0 = time.perf_counter()
        out = real_step()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    router.step = step
    servers = [rep.server for rep in supervisor.replicas]
    reset_counts()
    with router_faults() as faults, (logit_tap(*servers) if tap
                                     else contextlib.nullcontext({})) as rows:
        handles, dt = timed(lambda: router.generate_batch(reqs))
    launches = read_counts()
    del router.step
    return router, handles, dt, token_times, round_ms, faults, launches, rows


def phase_fleet(params32, card, serve_rec):
    """The fleet on serve's traffic (``serve_traffic``: FLEET_REQUESTS, bf16,
    64 new tokens, one in four sampled) through 2 replicas x 4 slots on the
    wall clock, each replica built like serve's server (chunked prefill 256,
    a 256 MiB prefix cache, warmup): tokens/s beside serve's (one server, 8
    slots, the same call), TTFT and ITL p99, the host ms of a router round,
    requests and prefix hits per replica. A second run with the engines'
    logits recorded (which costs host time, so the first run is the timed
    one) must give the same tokens (the schedule does not depend on the
    clock), and its greedy rows hold the tie rule against solo decoding at
    every step. No crash, no step failure, no kernel launch."""
    cfg = gpt2_config("flash", "bfloat16")
    reqs, lengths, sampled = serve_traffic(FLEET_REQUESTS, cfg.vocab_size)
    router, handles, dt, token_times, round_ms, faults, launches, _ = _fleet_run(
        params32, cfg, reqs)
    generated = sum(len(h.tokens) for h in handles)
    itl = [b - a for ts in token_times.values() for a, b in zip(ts, ts[1:])]
    supervisor = router.supervisor
    per_replica = {rep.name: {
        "requests": sum(h.replica == rep.name for h in handles),
        "prefix_hits": rep.server.metrics.prefix_hits,
        "prefix_lookups": rep.server.metrics.prefix_lookups,
        "shapes": rep.server.compile_counts()} for rep in supervisor.replicas}
    held = all(rep.server.engine.pool.free_count == 4 for rep in supervisor.replicas)
    summary = router.summary()
    del router, supervisor
    gc.collect()
    tapped = _fleet_run(params32, cfg, reqs, tap=True)
    same_tokens = [h.tokens for h in tapped[1]] == [h.tokens for h in handles]
    greedy = [(h, r) for h, r, s in zip(tapped[1], reqs, sampled) if not s]
    res = forced_tie_rule(params32, cfg, [(f"{h.request_id}-a1", list(r.prompt), h.tokens)
                                          for h, r in greedy], tapped[7])
    tps = generated / dt
    rec = {"phase": "fleet", "model": "gpt2 124M", "dtype": "bfloat16",
           "replicas": 2, "slots_per_replica": 4, "requests": len(reqs),
           "sampled_top_k50": sum(sampled), "prompt_tokens": int(sum(lengths)),
           "new_tokens": SERVE_NEW, "generated_tokens": generated, "seconds": dt,
           "tokens_per_s": tps, "serve_tokens_per_s": serve_rec["tokens_per_s"],
           "ratio_to_serve": tps / serve_rec["tokens_per_s"],
           "tapped_run_seconds": tapped[2],
           "ttft_s": _percentiles([h.first_token_at - h.submit_time for h in handles]),
           "itl_s": _percentiles(itl), "serve_ttft_s": serve_rec["ttft_s"],
           "serve_itl_s": serve_rec["itl_s"], "router_rounds": len(round_ms),
           "router_round_host_ms": _percentiles(round_ms),
           "serve_decode_round_host_ms": serve_rec["decode_round_host_ms"],
           "per_replica": per_replica, "greedy_requests": len(greedy),
           "tokens_equal_across_runs": same_tokens, **res,
           "divergence_count": len(res["divergences"]), "summary": summary,
           "router_faults": [faults, tapped[5]], "launches": launches, "card": card}
    emit(rec)
    check(all(h.finish_reason == "length" and len(h.tokens) == SERVE_NEW
              and h.attempts == 1 for h in handles),
          f"fleet: a request did not end with {SERVE_NEW} tokens on its first attempt")
    check(all(0 <= t < cfg.vocab_size for h in handles for t in h.tokens),
          "fleet: token ids out of range")
    check(same_tokens, "fleet: the recorded run's tokens differ from the timed run's")
    check_tie_rule("fleet", res, len(greedy) * SERVE_NEW)
    check(faults == tapped[5] == {"crash": 0, "step_failure": 0},
          f"fleet: the router handled faults with no injector: {faults}, {tapped[5]}")
    check(held, "fleet: a slot is still held")
    check(not any(launches.values()) and not any(tapped[6].values()),
          f"fleet launched kernels: {launches}, {tapped[6]}")
    del tapped
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec


def forced_tie_rule(params, cfg, streams, rows, e=None):
    """The tie rule along each stream, teacher-forced: solo logits at every
    generated position from ONE cached forward of the prompt and the
    stream's own tokens (``streams``: (request id, prompt, tokens)), so all
    steps are compared, not only those before a first divergence. e is the
    largest engine-vs-solo logit difference over every step; a token that
    is not solo's argmax is allowed where solo's top logit exceeds that
    token's by at most SERVE_TIE_X * e. At bf16 the engine's batched decode
    and chunked prefill round differently from one solo forward, and the
    random-init logits are near-tied often enough that a free-running solo
    decode would leave most steps uncompared. Without ``rows`` (a worker
    process's logits stay in it), ``e`` is given: a margin measured on the
    same engine code elsewhere."""
    from mingpt_distributed_tpu_torch.models import generate as gen

    refs, measure = [], e is None
    e = 0.0 if measure else e
    with torch.no_grad():
        for rid, prompt, toks in streams:
            cache = gen.init_cache(cfg, 1, torch.device("cuda"))
            seq = torch.tensor([prompt + toks[:-1]], device="cuda")
            x = gen._forward_cached_hidden(params, seq, cache, 0, cfg)
            ref = gen._head_logits(params, x[:, len(prompt) - 1:], cfg)[0].float()
            refs.append(ref)
            if measure:
                e = max(e, max((rows[(rid, i)].float() - ref[i]).abs().max().item()
                               for i in range(len(toks))))
    divergences = []
    for (rid, _, toks), ref in zip(streams, refs):
        for i, tok in enumerate(toks):
            top = ref[i].max()
            if int(ref[i].argmax()) != tok:
                divergences.append({"request": rid, "step": i, "server": tok,
                                    "solo": int(ref[i].argmax()),
                                    "top2_gap": (top - ref[i][tok]).item()})
    return {"compared_steps": sum(len(t) for _, _, t in streams), "max_logit_err": e,
            "tie_margin": SERVE_TIE_X * e, "divergences": divergences}


def _diff_paths(a, b, path=""):
    if isinstance(a, dict) and isinstance(b, dict):
        return [p for k in sorted(set(a) | set(b))
                for p in _diff_paths(a.get(k), b.get(k), f"{path}.{k}")]
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in _diff_paths(x, y, f"{path}[{i}]")]
    return [] if a == b else [path]


# Requests per rung of phase_traffic's sweeps, on the card and on the CPU
# (the self-test's 40, cut for the smoke's time: at 36 the tiny model's
# CPU sweep on the V = 50257 mix still puts EDF at 1.0 against FIFO's 0.857
# at the overload rung, and at 28 the two tie)
TRAFFIC_REQUESTS = 36


def phase_traffic(params32, card):
    """The traffic lab at GPT-2 124M width, bf16: the canned self-test sweep
    (poisson:rate=40, ladder 1 and 24, fifo and edf, TRAFFIC_REQUESTS per rung,
    1 replica x 2 slots, ttft_p95<=0.025,shed_rate<=0.5) over the self-test
    mix at V = 50257, the prefix cache scaled to hold as many rows as the
    tiny model's 0.5 MiB; the report validated after a JSON round trip, the
    knee's pass->fail shape, EDF strictly above FIFO at the overload rung, a
    second sweep byte-identical; the same sweep on the tiny model on the
    CPU, and the report fields that differ between the two."""
    from mingpt_distributed_tpu_torch import traffic as traffic_cli
    from mingpt_distributed_tpu_torch.models import gpt
    from mingpt_distributed_tpu_torch.trafficlab import run_sweep, runner
    from mingpt_distributed_tpu_torch.trafficlab.report import dump_report

    cfg = gpt2_config("flash", "bfloat16")
    tiny = traffic_cli.tiny_config()
    row_bytes = 2 * cfg.n_layer * cfg.kv_heads * cfg.head_dim * 2      # bf16
    tiny_row_bytes = 2 * tiny.n_layer * tiny.kv_heads * tiny.head_dim * 4  # fp32
    prefix_mb = 0.5 * row_bytes / tiny_row_bytes
    spec = dataclasses.replace(traffic_cli.selftest_sweep_spec(prefix_cache_mb=prefix_mb),
                               n_requests=TRAFFIC_REQUESTS)
    mix = traffic_cli.selftest_mix(cfg.vocab_size)
    cells = []
    real_run_one = runner._run_one

    def run_one(*args, **kwargs):
        t0 = time.perf_counter()
        cell = real_run_one(*args, **kwargs)
        cells.append({"policy": args[3], "wall_s": time.perf_counter() - t0,
                      "tokens": cell["tokens"], "rounds": cell["rounds"]})
        return cell

    runner._run_one = run_one
    reset_counts()
    try:
        with router_faults() as faults:
            report, dt = timed(lambda: run_sweep(params32, cfg, spec, mix=mix,
                                                 server_kwargs=dict(device="cuda")))
            report2, dt2 = timed(lambda: run_sweep(params32, cfg, spec, mix=mix,
                                                   server_kwargs=dict(device="cuda")))
    finally:
        runner._run_one = real_run_one
    launches = read_counts()
    rc = traffic_cli.selftest_checks(report, report2, tag="traffic")
    # the same sweep on the CPU at tiny width: with the self-test's V = 96
    # mix (the vocabulary keys the mix's RNG, so the rendered trace differs)
    # and with this phase's V = 50257 mix (the same trace)
    cpu = {}
    for vocab in (tiny.vocab_size, cfg.vocab_size):
        tcfg = dataclasses.replace(tiny, vocab_size=vocab)
        tparams = gpt.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
        cpu[vocab] = run_sweep(tparams, tcfg, dataclasses.replace(
                                   traffic_cli.selftest_sweep_spec(),
                                   n_requests=TRAFFIC_REQUESTS),
                               mix=traffic_cli.selftest_mix(vocab),
                               server_kwargs=dict(device="cpu"))
    differ = {v: _diff_paths(json.loads(json.dumps(r)), json.loads(json.dumps(report)))
              for v, r in cpu.items()}
    cpu_report = cpu[tiny.vocab_size]
    last = report["rungs"][-1]["policies"]
    tokens = sum(c["tokens"] for c in cells)
    rec = {"phase": "traffic", "model": "gpt2 124M", "dtype": "bfloat16",
           "arrival": spec.arrival, "ladder": list(spec.ladder),
           "policies": list(spec.policies), "requests_per_rung": spec.n_requests,
           "prefix_cache_mb": prefix_mb, "knee": report["knee"],
           "deadline_hit_rate": {p: c["deadline_hit_rate"] for p, c in last.items()},
           "cells": cells, "sweep_seconds": [dt, dt2],
           "tokens_per_wall_s": tokens / sum(c["wall_s"] for c in cells),
           "byte_identical_rerun": dump_report(report) == dump_report(report2),
           "cpu_tiny_knee": cpu_report["knee"],
           "fields_differing_from_cpu_tiny": {
               f"V{v}": {"paths": len(d), "fields": sorted({
                   re.sub(r"\[\d+\]", "[]", p) for p in d})} for v, d in differ.items()},
           "router_faults": faults, "launches": launches, "card": card}
    emit(rec)
    check(rc == 0, "traffic: a self-test gate failed (lines above)")
    check(report["knee"] == cpu_report["knee"] and (
        last["edf"]["deadline_hit_rate"] > last["fifo"]["deadline_hit_rate"]),
        f"traffic: verdicts differ from the CPU run's: {report['knee']} vs "
        f"{cpu_report['knee']}")
    check(differ[cfg.vocab_size] == [],
          f"traffic: the report differs from the tiny CPU run on the same mix "
          f"in {differ[cfg.vocab_size]}")
    check(faults == {"crash": 0, "step_failure": 0},
          f"traffic: the router handled faults with no injector: {faults}")
    check(not any(launches.values()), f"traffic launched kernels: {launches}")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 3e: the process fleet (worker subprocesses behind mingpt-rpc/1)
# ---------------------------------------------------------------------------

# The card's free memory after a SIGKILLed worker is reaped must rise by that
# worker's footprint (free memory before its spawn minus after it) within
# this margin: the parent is idle while it polls, so what moves the reading
# besides the dead context is allocator jitter in the other processes, a
# few MiB; 128 MiB bounds it with room to spare and is far below one
# worker's footprint (its CUDA context alone is several hundred MiB).
PROC_MEM_MARGIN = 128 << 20
PROC_MEM_WAIT_S = 30.0
# hang ladder (phase B of standby): the step RPC's socket timeout, the
# liveness deadline and the SIGTERM -> SIGKILL grace, seconds
HANG_RPC_S, HANG_DEADLINE_S, HANG_GRACE_S = 1.5, 1.0, 1.0


class TraceList:
    """A trace sink keeping the mingpt-trace/1 records in a list."""

    def __init__(self):
        self.records = []

    def write(self, kind, rec):
        from mingpt_distributed_tpu_torch.telemetry import TRACE_SCHEMA

        self.records.append({"schema": TRACE_SCHEMA, "kind": kind, **rec})

    def close(self):
        pass


def worker_spec(cfg, **server):
    """A worker spec on cuda:0 drawing ``cfg``'s weights from seed 0 on a
    CPU generator, as GPT(seed=0) draws the parent's."""
    from mingpt_distributed_tpu_torch.serving.procfleet import cfg_to_spec

    return {"cfg": cfg_to_spec(cfg), "init_seed": 0, "device": "cuda", "server": server}


def timed_spawns(spawns):
    """A ``proc_fleet`` wrap: every spawn (replicas, spares, respawns)
    logged with its seconds and the card's free memory before and after."""
    def wrap(factory):
        def make(name, clock, fault_hook):
            torch.cuda.synchronize()
            free0, t0 = torch.cuda.mem_get_info()[0], time.perf_counter()
            backend = factory(name=name, clock=clock, fault_hook=fault_hook)
            WORKERS.append(backend)
            spawns.append({"name": name, "pid": backend.pid,
                           "seconds": time.perf_counter() - t0, "free_before": free0,
                           "free_after": torch.cuda.mem_get_info()[0]})
            return backend
        return make
    return wrap


def proc_fleet(spec, spill, **kwargs):
    """serve's ``proc_fleet`` (2 worker subprocesses on the wall clock) with
    its spawns timed: (supervisor, router, streamed, spawns)."""
    from mingpt_distributed_tpu_torch.serve import proc_fleet as serve_proc_fleet

    spawns = []
    return (*serve_proc_fleet(spec, spill, wrap=timed_spawns(spawns), **kwargs), spawns)


def kill_mid_decode(supervisor, router, spawns, await_memory=True):
    """SIGKILL the worker of a replica decoding a request that has emitted a
    token, reap it (waitpid), and (``await_memory``) wait for the card to get
    its memory back: (victim name, exit code, memory record or None)."""
    from mingpt_distributed_tpu_torch.serve import mid_decode_replica, step_until

    victim = step_until(router, lambda: mid_decode_replica(supervisor, router))
    check(victim is not None, "process fleet: no replica ever mid-decode")
    pid = victim.backend.pid
    born = next(s for s in spawns if s["pid"] == pid)
    footprint = born["free_before"] - born["free_after"]
    torch.cuda.synchronize()
    free_kill = torch.cuda.mem_get_info()[0]
    os.kill(pid, signal.SIGKILL)
    code = victim.backend.proc.wait()
    if not await_memory:
        return victim.name, code, None
    t_reap = time.perf_counter()
    free = torch.cuda.mem_get_info()[0]
    while (free < free_kill + footprint - PROC_MEM_MARGIN
           and time.perf_counter() - t_reap < PROC_MEM_WAIT_S):
        time.sleep(0.005)
        free = torch.cuda.mem_get_info()[0]
    memory = {"worker_footprint_at_spawn": footprint, "free_before_kill": free_kill,
              "free_after_reap": free, "returned": free - free_kill,
              "margin": PROC_MEM_MARGIN,
              "release_s_after_waitpid": time.perf_counter() - t_reap}
    return victim.name, code, memory


def drain_and_respawn(supervisor, router, name):
    from mingpt_distributed_tpu_torch.serve import step_until

    router.run_until_drained(max_steps=500000)
    step_until(router, lambda: supervisor.replica_by_name(name).state == "ready",
               max_steps=500000)


def migrate_prompts(router, n_per=3):
    """Prompts a migration ships rows of: 130 to 300 tokens (128 or 256
    rows on the default ladder), seeded apart from the fleet's others, so no
    peer holds their entries already."""
    return fleet_prompts(router, n_per, lo=130, seed=SERVE_SEED + 5)


def migrate_leg(supervisor, router, streamed, prompts, new, records):
    """Drain with migration over the real socket: submit ``prompts`` (ones
    the fleet has not served: a peer skips an entry it holds already), migrate
    a mid-decode replica's state to its peer and retire it, drain. Then the
    checks' inputs: every shipped leaf against the peer's copy (the peer's
    own migrate_out blob), and the moved prompts run again on the peer,
    undisturbed. Returns the record (tokens under "tokens")."""
    from mingpt_distributed_tpu_torch.serve import mid_decode_replica, step_until
    from mingpt_distributed_tpu_torch.serving import Request
    from mingpt_distributed_tpu_torch.serving.procfleet import unpack_frames

    handles = [router.submit(Request(prompt=p, max_new_tokens=new)) for p in prompts]
    src = step_until(router, lambda: mid_decode_replica(supervisor, router))
    check(src is not None, "process migration: never mid-decode")
    shipped = []
    real_export = router.export_migrate_blob

    def export(rep):
        blob = real_export(rep)
        shipped.append(blob)
        return blob

    router.export_migrate_blob = export
    t0 = time.perf_counter()
    report = router.migrate_and_drain(src.name)
    migrate_s = time.perf_counter() - t0
    del router.export_migrate_blob
    router.run_until_drained(max_steps=500000)
    moved = [h for h in handles if h.request_id in report["requests_moved"]]
    again = [router.submit(Request(prompt=list(h.request.prompt), max_new_tokens=new))
             for h in moved]
    router.run_until_drained(max_steps=500000)
    dst = supervisor.replica_by_name(report["to"])
    peer = {(m["type"], tuple(m["key"])): (m["leaves"], payload) for m, payload in
            unpack_frames(dst.backend.transport.fetch_bytes("/rpc/migrate_out"))
            if m["type"] == "prefix_entry"}
    # the rows of this leg's prompts (a key the peer held already, from
    # traffic both served, is skipped on install and is the peer's own)
    heads = {tuple(p[:n]) for p in prompts for n in range(1, len(p) + 1)}
    sent = [(m, payload) for m, payload in unpack_frames(shipped[0])
            if m["type"] in ("prefix_entry", "slot_rows")
            and tuple(m["key"]) in heads] if shipped else []
    bit_equal = bool(sent) and all(
        peer.get(("prefix_entry", tuple(m["key"]))) == (m["leaves"], payload)
        for m, payload in sent)
    spanning = sum(len({e["replica"] for e in records
                        if e["kind"] == "event" and e["name"] == "emit"
                        and e["trace_id"] == h.request_id}) > 1 for h in moved)
    migrate_events = sum(any(e["kind"] == "event" and e["name"] == "migrate"
                             and e["trace_id"] == h.request_id for e in records)
                         for h in moved)
    return {"report": report, "migrate_s": migrate_s, "blob_bytes": len(shipped[0]) if shipped else 0,
            "leaves": sorted({leaf["dtype"] for m, _ in sent for leaf in m["leaves"]}),
            "frames_shipped": len(sent), "rows_bit_equal_on_peer": bit_equal,
            "moved": len(moved), "moved_equal_undisturbed_rerun": [
                h.tokens == a.tokens for h, a in zip(moved, again)],
            "streams_equal": [streamed.get(h.request_id) == h.tokens for h in handles],
            "finished": [h.finish_reason for h in handles],
            "traces_spanning_both": spanning, "migrate_events": migrate_events,
            "tokens": [h.tokens for h in handles]}


def check_migrate_leg(tag, rec, new):
    r = rec["report"]
    check(r["outcome"] == "ok" and r["entries_installed"] >= 1 and rec["moved"] >= 1,
          f"{tag}: migration {r}")
    check(r["src_exit_code"] == 75, f"{tag}: the drained worker exited {r['src_exit_code']}")
    check(all(f == "length" for f in rec["finished"])
          and all(len(t) == new for t in rec["tokens"]), f"{tag}: a request fell short")
    check(all(rec["streams_equal"]), f"{tag}: a caller stream differs from its handle "
          f"(a duplicate or lost token)")
    check(all(rec["moved_equal_undisturbed_rerun"]),
          f"{tag}: a migrated stream differs from its undisturbed rerun on the peer")
    check(rec["rows_bit_equal_on_peer"], f"{tag}: shipped rows are not bit-equal on the peer")
    check(rec["migrate_events"] == rec["moved"] and rec["traces_spanning_both"] >= 1,
          f"{tag}: traces {rec['migrate_events']} migrate events, "
          f"{rec['traces_spanning_both']} spanning both replicas")


def stream_leg(supervisor, router, prompt, new):
    """/rpc/stream over the real socket, consumed on a thread while the
    router drives the rounds: (streamed tokens, stream_end docs, handle)."""
    import threading

    from mingpt_distributed_tpu_torch.serving import Request

    h = router.submit(Request(prompt=prompt, max_new_tokens=new))
    router.step()
    name, aid = next((name, aid) for (name, aid), (fh, _) in router._attempts.items()
                     if fh.request_id == h.request_id)
    transport = supervisor.replica_by_name(name).backend.transport
    got = []
    t = threading.Thread(target=lambda: got.extend(
        transport.stream(f"/rpc/stream?request_id={aid}")), daemon=True)
    t.start()
    router.run_until_drained(max_steps=500000)
    t.join(timeout=60.0)
    check(not t.is_alive(), "procfleet_parity: /rpc/stream never ended")
    return ([d["token"] for d in got if d["kind"] == "stream_token"],
            [d for d in got if d["kind"] == "stream_end"], h, name)


def phase_procfleet_parity(params32, card, tmp, then=None):
    """The process fleet at GPT-2 124M width, fp32: two worker processes x 2
    slots on the wall clock (a 256 MiB prefix cache each), each its own CUDA
    context on the card, the weights drawn in each from seed 0. Six greedy
    requests of 5 to 300 prompt tokens (three landing on each replica by
    affinity), 24 new tokens each; one worker SIGKILLed while it decodes:
    every stream token-identical to solo decoding and to what the caller was
    streamed, exit -9 reaped, the spill collected, the card's free memory
    back by the dead worker's footprint (``PROC_MEM_MARGIN``) and the
    seconds that took, the victim respawned cold (its recovery is the cold
    leg of ``standby``). Then the chunked /rpc/stream replay, drain with
    migration over the real socket at fp32 (``migrate_leg``; the peer's own
    migrate_out blob, read for the bit check, drains it too) and an
    int8-pool fleet's migration (bf16's is in ``procfleet``). Last, the same requests
    and the same kill through a LoopbackBackend fleet in this process: its
    ReplicaWorker code launches no kernel (the subprocesses' launches are
    their own counters, not counted here). The int8 fleet's workers and
    ``then`` (the next phase's) start on threads after the kill leg: no
    other spawn moves its memory readings or its cold respawn's time, and
    the later legs hold no time. Returns (launches, record, ``then``'s
    Background or None)."""
    from mingpt_distributed_tpu_torch.serving import Request, VirtualClock
    from mingpt_distributed_tpu_torch.serving.procfleet import (
        ProcessSupervisor,
        ProcRouter,
        loopback_backend_factory,
    )
    from mingpt_distributed_tpu_torch.telemetry import TraceRecorder, validate_trace_records
    from mingpt_distributed_tpu_torch.training.faults import ProcessFaultInjector

    gc.collect()
    torch.cuda.empty_cache()
    cfg, new = gpt2_config("flash", "float32"), PARITY_NEW
    spec = worker_spec(cfg, n_slots=2, prefix_cache_mb=256)
    sink = TraceList()
    recorder = TraceRecorder(sink=sink)
    t0 = time.perf_counter()
    supervisor, router, streamed, spawns = proc_fleet(
        spec, os.path.join(tmp, "procfleet-fp32"), trace_recorder=recorder)
    first_spawns_s = time.perf_counter() - t0
    prompts = fleet_prompts(router, 3)
    solo = [solo_greedy(params32, cfg, p, new)[0] for p in prompts]
    pids = {rep.name: rep.backend.pid for rep in supervisor.replicas}
    with router_faults() as faults:
        handles = [router.submit(Request(prompt=p, max_new_tokens=new)) for p in prompts]
        t0 = time.perf_counter()
        victim, code, memory = kill_mid_decode(supervisor, router, spawns)
        drain_and_respawn(supervisor, router, victim)
        kill_leg_s = time.perf_counter() - t0
        crash = next(c for c in supervisor.crash_reports if c["replica"] == victim)
        cold = supervisor.recovery_info(victim)
        summary = router.summary()
        exact = [h.tokens == want for h, want in zip(handles, solo)]
        # the kill leg's readings are taken: the int8 fleet's workers and
        # ``then`` start on threads while the legs below run
        sink8 = TraceList()
        int8_fleet = Background(lambda: proc_fleet(
            dict(spec, server=dict(spec["server"], kv_dtype="int8")),
            os.path.join(tmp, "procfleet-int8"), trace_recorder=TraceRecorder(sink=sink8)))
        upcoming = Background(then) if then is not None else None
        stream_toks, stream_ends, stream_h, stream_rep = stream_leg(
            supervisor, router, prompts[0], new)
        fresh = migrate_prompts(router)
        fp32 = migrate_leg(supervisor, router, streamed, fresh, new, sink.records)
    exits = supervisor.shutdown_all()
    recorder.close()
    validate_trace_records(sink.records)
    # an int8 pool's rows (payloads and scale planes) over the socket
    sup8, router8, streamed8, spawns8 = int8_fleet.result()
    try:
        int8 = migrate_leg(sup8, router8, streamed8, fresh, new, sink8.records)
    finally:
        exits8 = sup8.shutdown_all()
    # the same requests, the same kill, in this process: 0 launches
    loop_sup = ProcessSupervisor(
        loopback_backend_factory(params32, cfg, n_slots=2, prefix_cache_mb=256, device="cuda"),
        n_replicas=2, clock=VirtualClock(tick_s=0.001),
        process_injector=ProcessFaultInjector("kill:nth=3:match=replica0"),
        max_restarts=1, restart_backoff_s=0.01)
    loop_router = ProcRouter(loop_sup, max_retries=3, retry_backoff_s=0.01,
                             breaker_reset_s=0.05)
    reset_counts()
    loop_handles = loop_router.generate_batch(
        [Request(prompt=p, max_new_tokens=new) for p in prompts])
    launches = read_counts()
    loop_exits = loop_sup.shutdown_all()
    rec = {"phase": "procfleet_parity", "model": "gpt2 124M", "dtype": "float32",
           "workers": 2, "slots": 2, "requests": len(prompts),
           "prompt_lengths": [len(p) for p in prompts], "new_tokens": new,
           "spawns": spawns, "first_two_spawns_s": first_spawns_s,
           "killed": victim, "exit_code": code, "crash_report": crash,
           "tokens_exact": sum(exact), "attempts": [h.attempts for h in handles],
           "memory": memory, "cold_recovery": cold, "kill_leg_s": kill_leg_s,
           "summary": summary, "router_faults": faults,
           "migrate_fp32": {k: v for k, v in fp32.items() if k != "tokens"},
           "migrate_fp32_solo_equal": sum(
               t == solo_greedy(params32, cfg, p, new)[0] for t, p in zip(fp32["tokens"], fresh)),
           "migrate_int8": {k: v for k, v in int8.items() if k != "tokens"},
           "stream": {"tokens_equal": stream_toks == stream_h.tokens,
                      "end": stream_ends, "replica": stream_rep},
           "exits": exits, "exits_int8": exits8, "int8_spawns": spawns8,
           "loopback_tokens_exact": sum(h.tokens == want for h, want in zip(loop_handles, solo)),
           "loopback_exits": loop_exits, "launches": launches,
           "launches_subprocess_legs": "not counted (the workers' own counters)",
           "card": card}
    emit(rec)
    check(all(h.finish_reason == "length" for h in handles) and all(exact),
          f"procfleet_parity: {sum(exact)}/{len(handles)} streams equal solo decode")
    check(all(streamed.get(h.request_id) == h.tokens for h in handles),
          "procfleet_parity: a caller stream differs from its handle (a duplicate or lost token)")
    check(code == -9 and crash["exit_code"] == -9 and len(crash["spill_dumps"]) >= 1,
          f"procfleet_parity: reaped {crash}")
    check(memory["returned"] >= memory["worker_footprint_at_spawn"] - PROC_MEM_MARGIN,
          f"procfleet_parity: the card did not get the killed worker's memory back: {memory}")
    check(supervisor.replica_by_name(victim).backend.pid != pids[victim]
          and cold is not None and cold["path"] == "cold",
          f"procfleet_parity: the victim was not respawned cold: {cold}")
    check(summary["retries_by_reason"]["crash"] >= 1 and summary["duplicates_suppressed"] >= 1,
          f"procfleet_parity: retries {summary['retries_by_reason']}, duplicates "
          f"{summary['duplicates_suppressed']}")
    check(faults == {"crash": 1, "step_failure": 0},
          f"procfleet_parity: router faults {faults} beyond the one kill")
    check_migrate_leg("procfleet_parity fp32", fp32, new)
    check(fp32["leaves"] == ["float32"], f"procfleet_parity: fp32 leaves {fp32['leaves']}")
    check_migrate_leg("procfleet_parity int8", int8, new)
    check(int8["leaves"] == ["float32", "int8"], f"procfleet_parity: int8 leaves {int8['leaves']}")
    check(stream_toks == stream_h.tokens and len(stream_ends) == 1
          and stream_ends[0]["finish_reason"] == "length",
          f"procfleet_parity: /rpc/stream gave {stream_toks} {stream_ends} vs {stream_h.tokens}")
    check(all(c in (75, -9) for c in (*exits.values(), *exits8.values())),
          f"procfleet_parity: worker exits {exits} {exits8}")
    check(rec["loopback_tokens_exact"] == len(prompts),
          "procfleet_parity: the loopback fleet's streams differ from solo decode")
    check(not any(launches.values()), f"procfleet_parity launched kernels: {launches}")
    del loop_router, loop_sup
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec, upcoming


def procfleet_workers(tmp):
    """procfleet's fleet: 2 worker processes x 4 slots at GPT-2 124M width,
    bf16, each built like serve's server (chunked prefill 256, a 256 MiB
    prefix cache, warmup), traced into a list: (supervisor, router,
    streamed, spawns, trace list)."""
    from mingpt_distributed_tpu_torch.telemetry import TraceRecorder

    sink = TraceList()
    spec = worker_spec(gpt2_config("flash", "bfloat16"), n_slots=4, prefill_chunk=256,
                       prefix_cache_mb=256, warmup=True)
    return (*proc_fleet(spec, os.path.join(tmp, "procfleet-bf16"),
                        trace_recorder=TraceRecorder(sink=sink)), sink)


def phase_procfleet(params32, card, serve_rec, fleet_rec, workers):
    """serve's traffic (FLEET_REQUESTS, bf16, 64 new tokens, one in four
    sampled) through ``procfleet_workers`` (2 x 4 slots on the wall clock;
    built while procfleet_parity's later legs ran, idle since): tokens/s
    beside serve's and the thread fleet's, TTFT and ITL
    p50/p99, wall ms per router round and the step RPC's ms and bytes per
    round; the greedy rows under the teacher-forced tie rule, with the tie
    margin the thread fleet measured on its recorded logits (a worker's
    logits stay in its process). Then a bf16 migration on the same workers
    (``migrate_leg``)."""
    from mingpt_distributed_tpu_torch.serving.procfleet import transport as tr

    cfg = gpt2_config("flash", "bfloat16")
    reqs, lengths, sampled = serve_traffic(FLEET_REQUESTS, cfg.vocab_size)
    supervisor, router, streamed, spawns, sink = workers
    token_times = {}
    router.on_token = lambda fh, t: (streamed.setdefault(fh.request_id, []).append(t),
                                     token_times.setdefault(fh.request_id, []).append(
                                         time.perf_counter()))
    rpcs = []
    real_rt = tr.SocketTransport._roundtrip

    def roundtrip(self, method, path, body, timeout_s=None):
        t0 = time.perf_counter()
        status, payload = real_rt(self, method, path, body, timeout_s)
        rpcs.append((path, (time.perf_counter() - t0) * 1e3, len(body) + len(payload)))
        return status, payload

    round_ms = []
    real_step = router.step

    def step():
        t0 = time.perf_counter()
        out = real_step()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    tr.SocketTransport._roundtrip = roundtrip
    router.step = step
    try:
        with router_faults() as faults:
            handles, dt = timed(lambda: router.generate_batch(reqs))
    finally:
        tr.SocketTransport._roundtrip = real_rt
        del router.step
    steps = [(ms, n) for path, ms, n in rpcs if path == "/rpc/step"]
    generated = sum(len(h.tokens) for h in handles)
    itl = [b - a for ts in token_times.values() for a, b in zip(ts, ts[1:])]
    greedy = [(h, r) for h, r, s in zip(handles, reqs, sampled) if not s]
    res = forced_tie_rule(params32, cfg, [(h.request_id, list(r.prompt), h.tokens)
                                          for h, r in greedy], None,
                          e=fleet_rec["max_logit_err"])
    summary = router.summary()
    bf16 = migrate_leg(supervisor, router, streamed, migrate_prompts(router, 4),
                       SERVE_NEW, sink.records)
    exits = supervisor.shutdown_all()
    tps = generated / dt
    rec = {"phase": "procfleet", "model": "gpt2 124M", "dtype": "bfloat16",
           "workers": 2, "slots_per_worker": 4, "requests": len(reqs),
           "sampled_top_k50": sum(sampled), "prompt_tokens": int(sum(lengths)),
           "new_tokens": SERVE_NEW, "generated_tokens": generated, "seconds": dt,
           "tokens_per_s": tps, "serve_tokens_per_s": serve_rec["tokens_per_s"],
           "fleet_tokens_per_s": fleet_rec["tokens_per_s"],
           "ratio_to_serve": tps / serve_rec["tokens_per_s"],
           "ratio_to_fleet": tps / fleet_rec["tokens_per_s"],
           "ttft_s": _percentiles([h.first_token_at - h.submit_time for h in handles]),
           "itl_s": _percentiles(itl), "router_rounds": len(round_ms),
           "router_round_wall_ms": _percentiles(round_ms),
           "step_rpcs": len(steps), "step_rpcs_per_round": len(steps) / max(1, len(round_ms)),
           "step_rpc_ms": _percentiles([ms for ms, _ in steps]),
           "step_rpc_bytes": _percentiles([n for _, n in steps]),
           "step_rpc_bytes_per_round": sum(n for _, n in steps) / max(1, len(round_ms)),
           "rpc_paths": sorted({p for p, _, _ in rpcs}), "spawns": spawns,
           "greedy_requests": len(greedy), **res,
           "tie_margin_from": "the thread fleet's recorded logits (phase fleet)",
           "divergence_count": len(res["divergences"]), "summary": summary,
           "router_faults": faults,
           "migrate_bf16": {k: v for k, v in bf16.items() if k != "tokens"},
           "exits": exits, "launches": "not counted (the workers' own counters)",
           "card": card}
    emit(rec)
    check(all(h.finish_reason == "length" and len(h.tokens) == SERVE_NEW
              and h.attempts == 1 for h in handles),
          f"procfleet: a request did not end with {SERVE_NEW} tokens on its first attempt")
    check(all(streamed.get(h.request_id) == h.tokens for h in handles),
          "procfleet: a caller stream differs from its handle")
    check(all(0 <= t < cfg.vocab_size for h in handles for t in h.tokens),
          "procfleet: token ids out of range")
    check_tie_rule("procfleet", res, len(greedy) * SERVE_NEW)
    check(faults == {"crash": 0, "step_failure": 0},
          f"procfleet: the router handled faults with no injector: {faults}")
    check_migrate_leg("procfleet bf16", bf16, SERVE_NEW)
    check(bf16["leaves"] == ["bfloat16"], f"procfleet: bf16 leaves {bf16['leaves']}")
    check(all(c == 75 for c in exits.values()), f"procfleet: worker exits {exits}")
    return rec


def phase_standby(params32, card, cold, tmp, overlap=None):
    """selftest-standby's phases on the card. A, at GPT-2 124M width, fp32:
    procfleet_parity's fleet and requests with one warm spare, the same kill
    -9 of a mid-decode worker; its recovery (crash to the replacement
    serving) beside procfleet_parity's cold respawn (``cold``), strictly
    faster, the spare adopted by name and the pool backfilled, every stream
    token-identical to solo decoding. B and C at GPT-2 width with the depth
    cut to 2 layers, fp32, one fleet with one spare and self-speculation
    (k = 3): B, replica0's worker wedges in its third step RPC (the
    stuck_step process fault, worker-side) and refuses SIGTERM: the ladder
    sends SIGTERM at HANG_DEADLINE_S without progress and SIGKILL
    HANG_GRACE_S later, the crash path adopts the spare, streams exact; C,
    on the same workers, a migration ships draft-pool rows and the peer
    primes the migrated request from them, streams exact. B and C's
    workers, and ``overlap`` when given, start on threads with the phase:
    returns (record, ``overlap``'s Background or None)."""
    from mingpt_distributed_tpu_torch.models import gpt
    from mingpt_distributed_tpu_torch.serve import mid_decode_replica, step_until
    from mingpt_distributed_tpu_torch.serving import Request
    from mingpt_distributed_tpu_torch.telemetry import parse_prometheus

    cfg, new = gpt2_config("flash", "float32"), PARITY_NEW
    # B and C's workers (and ``overlap``) start with the phase, on threads:
    # A's checks hold no memory reading, and its recovery is an adoption
    cfg2 = dataclasses.replace(cfg, n_layer=2)
    spec = dict(worker_spec(cfg2, n_slots=2, prefix_cache_mb=256, warmup=True),
                draft="self", spec_k=3, process_faults="stuck_step:nth=3:match=replica0")
    bc_fleet = Background(lambda: proc_fleet(
        spec, os.path.join(tmp, "standby-bc"), rpc_timeout_s=HANG_RPC_S, standby=1,
        hang_deadline_s=HANG_DEADLINE_S, hang_kill_grace_s=HANG_GRACE_S))
    pending = Background(overlap) if overlap is not None else None
    supervisor, router, streamed, spawns = proc_fleet(
        worker_spec(cfg, n_slots=2, prefix_cache_mb=256),
        os.path.join(tmp, "standby-a"), standby=1)
    prompts = fleet_prompts(router, 3)
    solo = [solo_greedy(params32, cfg, p, new)[0] for p in prompts]
    handles = [router.submit(Request(prompt=p, max_new_tokens=new)) for p in prompts]
    victim, code, _ = kill_mid_decode(supervisor, router, spawns, await_memory=False)
    drain_and_respawn(supervisor, router, victim)
    stby = supervisor.recovery_info(victim)
    exact_a = [h.tokens == want and streamed.get(h.request_id) == h.tokens
               for h, want in zip(handles, solo)]
    pool_a = supervisor.standby_pool.available()
    exits_a = supervisor.shutdown_all()

    params2 = gpt.init(cfg2, torch.Generator().manual_seed(0), device="cuda")
    supervisor, router, streamed, spawns_bc = bc_fleet.result()
    spec.pop("process_faults")  # respawns and backfills come up clean
    first_pid = supervisor.replica_by_name("replica0").backend.pid
    solo2 = [solo_greedy(params2, cfg2, p, new)[0] for p in prompts]
    t0 = time.perf_counter()
    handles = [router.submit(Request(prompt=p, max_new_tokens=new)) for p in prompts]
    drain_and_respawn(supervisor, router, "replica0")
    hang_s = time.perf_counter() - t0
    esc = {labels.get("signal"): v for n, labels, v in
           parse_prometheus(router.fleet_metrics_page())["samples"]
           if n == "mingpt_fleet_hang_escalations_total"}
    crash = next((c for c in supervisor.crash_reports if c["replica"] == "replica0"), None)
    rec_b = supervisor.recovery_info("replica0")
    rep0 = supervisor.replica_by_name("replica0")
    replaced = rep0.state == "ready" and rep0.backend.pid != first_pid
    exact_b = [h.tokens == want and streamed.get(h.request_id) == h.tokens
               for h, want in zip(handles, solo2)]
    # C: draft rows ride the migration, on the same workers
    handles_c = [router.submit(Request(prompt=p, max_new_tokens=new)) for p in prompts]
    src = step_until(router, lambda: mid_decode_replica(supervisor, router))
    check(src is not None, "standby C: never mid-decode")
    report = router.migrate_and_drain(src.name)
    router.run_until_drained(max_steps=500000)
    dst = supervisor.replica_by_name(report["to"])
    primes = {labels.get("mode"): v for n, labels, v in
              parse_prometheus(dst.backend.transport.fetch_text("/metrics"))["samples"]
              if n == "mingpt_serve_spec_prime_total"}
    exact_c = [h.tokens == want and streamed.get(h.request_id) == h.tokens
               for h, want in zip(handles_c, solo2)]
    exits_bc = supervisor.shutdown_all()
    rec = {"phase": "standby", "card": card,
           "A": {"model": "gpt2 124M", "dtype": "float32", "workers": 2, "standby": 1,
                 "killed": victim, "exit_code": code,
                 "recovery_s": {"cold": cold["recovery_s"], "standby": stby["recovery_s"]},
                 "cold_from": "procfleet_parity's kill (same fleet, requests and fault)",
                 "adopted": stby.get("adopted"), "path": stby["path"],
                 "pool_after": pool_a, "streams_exact": sum(exact_a), "spawns": spawns,
                 "exits": exits_a},
           "B": {"model": "gpt2 width, 2 layers", "dtype": "float32",
                 "reduced": "n_layer 12 -> 2", "escalations": esc,
                 "exit_code": None if crash is None else crash["exit_code"],
                 "recovery": rec_b, "seconds": hang_s, "streams_exact": sum(exact_b),
                 "replaced_by_a_new_process": replaced},
           "C": {"migration": report, "spec_prime": primes, "streams_exact": sum(exact_c)},
           "spawns_bc": spawns_bc, "exits_bc": exits_bc,
           "launches": "not counted (the workers' own counters)"}
    emit(rec)
    check(all(exact_a), f"standby A: {sum(exact_a)}/{len(exact_a)} streams exact")
    check(code == -9 and stby["path"] == "standby"
          and str(stby.get("adopted")).startswith("standby"),
          f"standby A: recovery {stby}")
    check(stby["recovery_s"] < cold["recovery_s"],
          f"standby A: standby recovery {stby['recovery_s']} s not below cold "
          f"{cold['recovery_s']} s")
    check(pool_a == 1, f"standby A: the pool holds {pool_a} after the backfill")
    check(all(exact_b), f"standby B: {sum(exact_b)}/{len(exact_b)} streams exact")
    check(esc.get("term", 0) >= 1 and esc.get("kill", 0) >= 1,
          f"standby B: escalations {esc}")
    check(crash is not None and crash["exit_code"] == -9,
          f"standby B: the wedged worker's exit {crash}")
    check(replaced and rec_b is not None and rec_b["path"] == "standby",
          f"standby B: replica0's replacement {rec_b}")
    check(report["outcome"] == "ok" and report["draft_rows_installed"] >= 1
          and report["src_exit_code"] == 75, f"standby C: migration {report}")
    check(primes.get("adopted", 0) >= 1, f"standby C: primes {primes}")
    check(all(exact_c), f"standby C: {sum(exact_c)}/{len(exact_c)} streams exact")
    return rec, pending


CROSSHOST_RATE, CROSSHOST_LINK_DELAY = 1e7, 0.02  # bytes/s; s per chunk


class Background:
    """``fn()`` on a thread; ``result()`` joins it and re-raises its
    error. The smoke builds the next phase's workers while a phase whose
    checks hold no time runs; every one is in ``BACKGROUND``, which main
    joins before it stops the workers, so a failure leaves none spawning."""

    def __init__(self, fn):
        import threading

        self._out = {}
        self._thread = threading.Thread(target=self._run, args=(fn,), daemon=True)
        BACKGROUND.append(self)
        self._thread.start()

    def _run(self, fn):
        try:
            self._out["value"] = fn()
        except BaseException as e:  # handed to result()
            self._out["error"] = e

    def result(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


def crosshost_mesh(tmp):
    """crosshost's mesh: 2 localhost host agents x 2 worker processes at
    GPT-2 width, depth cut to 2 layers, fp32, signed control envelopes,
    quorum 1, pacing at CROSSHOST_RATE with real sleeps, slow_link on
    host0->host1. Built on a thread while standby runs (the spawns are most
    of its time)."""
    from mingpt_distributed_tpu_torch.models import gpt
    from mingpt_distributed_tpu_torch.serve import ProcDrill, build_crosshost_mesh

    cfg = dataclasses.replace(gpt2_config("flash", "float32"), n_layer=2)
    params = gpt.init(cfg, torch.Generator().manual_seed(0), device="cuda")
    drill = ProcDrill("crosshost", torch.device("cuda"), cfg, params,
                      fleet_prompts_n(6), PARITY_NEW, tmp)
    spawns = []
    t0 = time.perf_counter()
    frontend, agents, streamed = build_crosshost_mesh(
        drill, "mesh", 2, "crosshost-drill-secret",
        net_faults=f"slow_link:every=1:match=host0->host1:delay={CROSSHOST_LINK_DELAY}",
        paced_bytes_per_s=CROSSHOST_RATE,
        spec=worker_spec(cfg, n_slots=2, prefix_cache_mb=256, warmup=True),
        wrap=timed_spawns(spawns))
    return {"drill": drill, "frontend": frontend, "agents": agents, "streamed": streamed,
            "spawns": spawns, "seconds": time.perf_counter() - t0}


def phase_crosshost(card, mesh):
    """selftest-crosshost's legs on the card over ``crosshost_mesh``'s
    hosts, one mesh for the three legs (the paced migration first, while
    both hosts serve): B, a mid-decode replica of host0 migrated to host1
    through the PacedChannel under slow_link, the wall time at least the
    budget (bytes / CROSSHOST_RATE + CROSSHOST_LINK_DELAY per chunk); A,
    host0 dies whole (every worker SIGKILLed) while a request decodes
    there, every stream token-exact on host1; C, a tampered heartbeat
    rejected as BadSignature and counted as bad_mac. Then one rung of the
    traffic lab on the loopback host mesh in this process (2 hosts, a
    partition of host0), its report strictly valid, no kernel launched."""
    from mingpt_distributed_tpu_torch import traffic as traffic_cli
    from mingpt_distributed_tpu_torch.serve import crosshost_kill_leg, mid_decode_on, step_until
    from mingpt_distributed_tpu_torch.serving import Request
    from mingpt_distributed_tpu_torch.serving.procfleet import envelope
    from mingpt_distributed_tpu_torch.telemetry import parse_prometheus
    from mingpt_distributed_tpu_torch.trafficlab import SweepSpec, run_sweep, validate_traffic_report

    drill, frontend, agents, streamed = (mesh[k] for k in ("drill", "frontend", "agents",
                                                           "streamed"))
    cfg, params, prompts, new = drill.cfg, drill.params, drill.prompts, drill.max_new
    bytes_per_s, link_delay = CROSSHOST_RATE, CROSSHOST_LINK_DELAY
    try:
        handles = [frontend.submit(Request(prompt=p, max_new_tokens=new)) for p in prompts]
        check(step_until(frontend, lambda: mid_decode_on(frontend, "host0"),
                         max_steps=200000) is not None, "crosshost: nothing mid-decode on host0")
        t0 = time.perf_counter()
        report = frontend.migrate_crosshost("host0", "host1")
        wall = time.perf_counter() - t0
        frontend.run_until_drained(max_steps=500000)
        paced_ok = drill.parity("paced", handles, streamed)
        budget = report["bytes"] / bytes_per_s + link_delay * report["chunks"]
        handles_a = [frontend.submit(Request(prompt=p, max_new_tokens=new)) for p in prompts]
        victim = step_until(frontend, lambda: mid_decode_on(frontend, "host0"),
                            max_steps=200000)
        check(victim is not None, "crosshost: nothing mid-decode on host0 for the kill")
        t0 = time.perf_counter()
        kill_rc = crosshost_kill_leg(drill, frontend, agents, streamed, handles_a, victim)
        kill_s = time.perf_counter() - t0
        doc = envelope("heartbeat", host="host0", epoch=0, seq=10_000)
        agents["host0"].auth.sign(doc)
        doc["seq"] = 10_001  # tampered after signing
        resp = json.loads(agents["host1"].handle_host(
            "/host/heartbeat", json.dumps(doc, sort_keys=True).encode()))
        bad_mac = sum(v for n, labels, v in parse_prometheus(
            agents["host1"].router.fleet_metrics_page())["samples"]
            if n == "mingpt_fleet_auth_rejects_total" and labels.get("reason") == "bad_mac")
    finally:
        for host in sorted(agents):
            agents[host].router.supervisor.shutdown_all()
    # one rung of the traffic lab on the loopback host mesh, in this process
    chaos = ";".join(f"partition:nth=1:match={a}->{b}:delay=0.1"
                     for a, b in (("host0", "host1"), ("host1", "host0")))
    sweep = SweepSpec(arrival="poisson:rate=200.0", ladder=(1.0,), policies=("fifo", "edf"),
                      n_requests=10, seed=3, n_replicas=1, n_slots=2, n_hosts=2,
                      heartbeat_interval_s=0.005, slo="ttft_p95<=60,error_rate<=0.5",
                      recovery_slo_s=30.0, net_chaos_spec=chaos, prefix_cache_mb=64)
    reset_counts()
    lab, lab_s = timed(lambda: run_sweep(params, cfg, sweep,
                                         mix=traffic_cli.selftest_mix(cfg.vocab_size),
                                         server_kwargs=dict(device="cuda")))
    launches = read_counts()
    problems = validate_traffic_report(json.loads(json.dumps(lab)), strict=False)
    cells = lab["rungs"][0]["policies"]
    rec = {"phase": "crosshost", "model": "gpt2 width, 2 layers", "dtype": "float32",
           "reduced": "n_layer 12 -> 2", "hosts": 2, "workers_per_host": 2,
           "mesh_spawn_s": mesh["seconds"], "mesh_built_during": "standby",
           "spawns": mesh["spawns"],
           "B_paced": {"report": report, "budget_s": budget, "wall_s": wall,
                       "streams_exact": paced_ok},
           "A_host_death": {"rc": kill_rc, "recovery_s": victim.recovery_s,
                            "hosts": victim.hosts, "seconds": kill_s},
           "C_auth": {"reject": resp.get("error"), "bad_mac": bad_mac},
           "traffic_rung": {"cells": {p: {k: c[k] for k in ("completed", "shed", "expired",
                                                           "errors", "recovered", "tokens")}
                                      for p, c in cells.items()},
                            "problems": problems, "seconds": lab_s},
           "launches": launches, "launches_subprocess_legs": "not counted", "card": card}
    emit(rec)
    check(report["outcome"] == "ok" and report["src_exit_code"] == 75 and paced_ok,
          f"crosshost B: {report}")
    check(report["transfer_s"] >= 0.95 * budget and wall >= 0.95 * budget,
          f"crosshost B: transfer {report['transfer_s']} s, wall {wall} s, budget {budget} s")
    check(kill_rc == 0, "crosshost A: the host-death leg failed (lines above)")
    check(resp.get("kind") == "error" and resp.get("error") == "BadSignature" and bad_mac >= 1,
          f"crosshost C: {resp}, bad_mac {bad_mac}")
    check(problems == [] and all(c["completed"] + c["shed"] + c["expired"] + c["errors"] == 10
                                 for c in cells.values()),
          f"crosshost traffic rung: {problems}")
    check(not any(launches.values()), f"crosshost launched kernels: {launches}")
    torch.cuda.empty_cache()
    return launches, rec


def fleet_prompts_n(n, lo=5, hi=300, vocab=50257):
    """``n`` seeded prompts of lo..hi tokens (fleet_prompts' draw, without
    the affinity sort)."""
    rng = np.random.default_rng(SERVE_SEED + 4)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).tolist() for _ in range(n)]


SERVE_CLI_PROMPTS = ("the king ", "and so the ", "what is ", "o my lord. ")


def run_serve(argv):
    """The serve entry point's main(argv), its stdout captured and echoed."""
    from mingpt_distributed_tpu_torch.serve import main as serve_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_main(argv)
    out = buf.getvalue()
    sys.stderr.write(out)
    return rc, out


def served_texts(out):
    """The prompt + completion texts of ``serve.py --prompts-file``'s
    stdout: each follows its ``=== req-N (reason) ===`` header (``fleet-N``
    through a fleet) and may hold newlines; the summary's JSON line ends the
    output."""
    blocks = re.split(r"^=== (?:req|fleet)-\d+ \(\w+\) ===\n", out, flags=re.M)[1:]
    if blocks:
        blocks[-1] = blocks[-1].rsplit("\n{", 1)[0] + "\n"
    return [b[:-1] for b in blocks]


def phase_serve_cli(card, train_argv, tmp, new_seconds):
    """python -m mingpt_distributed_tpu_torch.serve, driven through main():
    --selftest on the card, then --prompts-file over the snapshot the train
    entry point wrote (GPT-2 width, char vocabulary); then the same prompts
    through --replicas 2 with --isolation thread and --isolation process
    (two worker processes, each restoring the snapshot itself): the
    completions byte-equal, the workers' exits 75 (its seconds in
    ``new_seconds``). Returns the plain run's texts."""
    rc, out = run_serve(["--selftest", "--log-every", "0"])
    check(rc == 0 and "selftest PASSED" in out, f"serve --selftest exited {rc}")
    path = os.path.join(tmp, "prompts.txt")
    with open(path, "w") as f:
        f.write("\n".join(SERVE_CLI_PROMPTS) + "\n")
    (rc2, out2), dt = timed(lambda: run_serve(
        ["--prompts-file", path, "--greedy", "--max-new-tokens", "32",
         "--slots", "2", "--log-every", "0", *train_argv]))
    texts = served_texts(out2)
    completions = [t[len(p):] for p, t in zip(SERVE_CLI_PROMPTS, texts)]
    emit({"phase": "serve_cli", "selftest_rc": rc, "prompts_file_rc": rc2,
          "completions": completions, "seconds": dt, "card": card})
    check(rc2 == 0, f"serve --prompts-file exited {rc2}")
    check(len(completions) == 4 and all(
        t.startswith(p) for p, t in zip(SERVE_CLI_PROMPTS, texts))
        and all(len(c) > 0 for c in completions),
        f"serve --prompts-file: completions {completions}")
    t0 = time.perf_counter()
    fleet_argv = ["--prompts-file", path, "--greedy", "--max-new-tokens", "32",
                  "--slots", "2", "--log-every", "0", "--replicas", "2"]
    rc_t, out_t = run_serve(fleet_argv + ["--isolation", "thread", *train_argv])
    rc_p, out_p = run_serve(fleet_argv + ["--isolation", "process", "--spill-dir",
                                          os.path.join(tmp, "serve-procfleet"), *train_argv])
    thread_texts, process_texts = served_texts(out_t), served_texts(out_p)
    new_seconds["serve_cli_process"] = time.perf_counter() - t0
    emit({"phase": "serve_cli_process", "thread_rc": rc_t, "process_rc": rc_p,
          "completions_equal": process_texts == thread_texts,
          "completions": [t[len(p):] for p, t in zip(SERVE_CLI_PROMPTS, process_texts)],
          "seconds": new_seconds["serve_cli_process"], "card": card})
    check(rc_t == 0 and rc_p == 0, f"serve --replicas 2 exited {rc_t} (thread), {rc_p} (process)")
    check(len(process_texts) == 4 and process_texts == thread_texts,
          f"serve --isolation process: {process_texts} != --isolation thread's {thread_texts}")
    return texts


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


def phase_train_entry(card, tmp):
    """python -m mingpt_distributed_tpu_torch.train, driven through main():
    GPT-2 width on the corpus with async_save (the snapshot written by a
    background thread, joined before train() returns; the batches gathered
    by the C gather), then a second call that resumes from that snapshot.
    The snapshot is written under ``tmp``; returns the arguments that name
    it and the model."""
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
        rc, out = run_entry(argv + [f"trainer_config.max_steps={ENTRY_STEPS}",
                                    "trainer_config.async_save=true"])
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
          "async_save": True, "async_snapshot_saved": ", async)" in out,
          "resume_rc": rc2, "resumed_at_saved_step": resumed in out2,
          "resumed_steps": [int(v) for v in losses2], "card": card})
    check(drop >= ENTRY_LOSS_DROP, f"loss fell by {drop} < {ENTRY_LOSS_DROP}")
    check(len(evals) == 1 and math.isfinite(float(evals[0])), "no eval loss")
    check(os.path.exists(snap + ".manifest.json"), "no snapshot committed")
    check(", async)" in out, "train entry: the snapshot was not written asynchronously")
    check(counts["flash_bwd_dq"] == 12 * ENTRY_STEPS,
          f"train entry: {counts} launches")
    check(rc2 == 0 and resumed in out2, "second call did not resume")
    check([int(v) for v in losses2] == list(range(ENTRY_STEPS + 1, ENTRY_STEPS + 6)),
          f"resumed run logged steps {losses2}")
    return argv


TELEMETRY_STEPS = 8
PROFILE_STEPS = (2, 4)
# the split step's kernels, by a fragment of their names in a profiler trace
TRACE_KERNELS = ("flash_fwd", "flash_bwd_prep", "flash_dq", "flash_dkv")


def step_spans(path):
    """The train.step spans of a spans_jsonl file: {step: host ms}."""
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("kind") == "span" and rec.get("name") == "train.step":
                out.setdefault(rec["step"], []).append(rec["dur_s"] * 1e3)
    return out


@contextlib.contextmanager
def profile_window_counts(edges):
    """Inside the block, the launch counts at each edge of a trainer's
    profile window (PROFILE_STEPS) go into ``edges`` by step, read just
    after the trainer opens or closes its profiler."""
    from mingpt_distributed_tpu_torch.training.trainer import GPTTrainer

    real = GPTTrainer._profile

    def profile(self, step):
        real(self, step)
        if self.config.profile_dir and step in PROFILE_STEPS:
            edges[step] = read_counts()

    GPTTrainer._profile = profile
    try:
        yield
    finally:
        GPTTrainer._profile = real


def phase_train_telemetry(card, argv, tmp):
    """The train entry point twice more, 8 steps each from scratch at
    train_cli's shape, logging every step: once with spans_jsonl,
    profile_dir over steps 3 and 4 and debug_nans on, once with spans_jsonl
    alone. One train.step span per step (phase_trace_summary reads the
    profile); the median step ms of the unprofiled steps 5-8 with
    debug_nans on and off. Returns the launches inside the profiled window
    (the counts at its closing edge less those at its opening one:
    debug_nans reads the card at the end of every step's backward, so no
    attention kernel of step 2 is still queued when the window opens)."""
    edges = {}
    runs = {}
    for name, extra in (("debug_nans_on", ["trainer_config.debug_nans=true",
                                           f"trainer_config.profile_dir={tmp}/prof",
                                           f"trainer_config.profile_steps={list(PROFILE_STEPS)}"]),
                        ("debug_nans_off", [])):
        spans = os.path.join(tmp, f"spans_{name}.jsonl")
        run_argv = [a for a in argv if not a.startswith(("trainer_config.snapshot_path",
                                                        "trainer_config.log_every"))]
        run_argv += [f"trainer_config.snapshot_path={tmp}/{name}.pt",
                     f"trainer_config.max_steps={TELEMETRY_STEPS}",
                     "trainer_config.log_every=1", f"trainer_config.spans_jsonl={spans}",
                     *extra]
        reset_counts()
        with fused_switch(False), profile_window_counts(edges):
            rc, out = run_entry(run_argv)
        per_step = step_spans(spans)
        runs[name] = {"rc": rc, "spans": per_step, "launches": read_counts(),
                      "step_ms_p50": float(np.median(
                          [per_step[s][0] for s in range(PROFILE_STEPS[1] + 1,
                                                         TELEMETRY_STEPS + 1)
                           if s in per_step]))}
        check(rc == 0, f"train entry ({name}) exited {rc}")
        check(sorted(per_step) == list(range(1, TELEMETRY_STEPS + 1))
              and all(len(v) == 1 for v in per_step.values()),
              f"train entry ({name}): step spans {per_step}")
    check(sorted(edges) == list(PROFILE_STEPS), f"profiled window's edges {sorted(edges)}")
    window = {k: edges[PROFILE_STEPS[1]][k] - edges[PROFILE_STEPS[0]][k] for k in COUNTERS}
    trace = os.path.join(tmp, "prof", "trace_steps_%d-%d.json" % PROFILE_STEPS)
    on, off = runs["debug_nans_on"], runs["debug_nans_off"]
    emit({"phase": "train_cli_telemetry", "steps": TELEMETRY_STEPS,
          "profile_steps": list(PROFILE_STEPS), "trace": os.path.basename(trace),
          "step_spans": {n: len(r["spans"]) for n, r in runs.items()},
          "step_ms": {n: [r["spans"][k][0] for k in sorted(r["spans"])]
                      for n, r in runs.items()},
          "step_ms_p50_debug_nans_on": on["step_ms_p50"],
          "step_ms_p50_debug_nans_off": off["step_ms_p50"],
          "debug_nans_cost_ms": on["step_ms_p50"] - off["step_ms_p50"],
          "launches": {n: r["launches"] for n, r in runs.items()},
          "launches_profiled_window": window, "card": card})
    check(all(r["launches"]["flash_bwd_dq"] == 12 * TELEMETRY_STEPS for r in runs.values()),
          f"train entry with telemetry: {[r['launches'] for r in runs.values()]}")
    return window


# ---------------------------------------------------------------------------
# phase 4f: the repository tools (tools/trace_summary.py, tools/exp_families.py)
# ---------------------------------------------------------------------------

# TRACE_KERNELS' counter names: each trace name fragment names one kernel
TRACE_COUNTERS = dict(zip(TRACE_KERNELS, ("flash_fwd", "flash_bwd_prep", "flash_bwd_dq",
                                          "flash_bwd_dkv")))
TRACE_TOP_ROWS = 8


def summary_run(argv):
    """trace_summary's main(argv): (exit code, stdout)."""
    from mingpt_distributed_tpu_torch.tools import trace_summary

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = trace_summary.main(argv)
    return rc, buf.getvalue()


def device_lanes(table):
    """The lanes of a trace_summary.lanes() table that hold a flash kernel
    (TRACE_KERNELS' first name), by key."""
    return {key: lane for key, lane in table.items()
            if any(TRACE_KERNELS[0] in name for name in lane["ops"])}


def trace_kernel_events(lane):
    """Events and total ms of each of TRACE_KERNELS in a lane: {fragment:
    [events, ms]} over every op name that holds the fragment."""
    out = {k: [0, 0.0] for k in TRACE_KERNELS}
    for name, (us, n) in lane["ops"].items():
        for k in TRACE_KERNELS:
            if k in name:
                out[k][0] += n
                out[k][1] += us / 1e3
    return out


def trace_summary_checks(out, table, t_min, t_max, window):
    """The profile's summary and lane table against the launch counters:
    (record, messages of the checks it fails). The device lane is one lane,
    apart from the host threads (no aten:: op in it), its line prints its
    busy share, and each of TRACE_KERNELS has as many kernel events there
    as its counter counted launches in the profiled window."""
    fails = []
    lanes = device_lanes(table)
    if len(lanes) != 1:
        return {"device_lanes": [list(k) for k in lanes]}, [
            f"trace_summary: {len(lanes)} lanes hold the flash kernels, want 1"]
    (key, lane), = lanes.items()
    events = trace_kernel_events(lane)
    span_ms = (t_max - t_min) / 1e3
    head = f"== lane {key[0]} / {key[1]}: busy "
    line = next((ln for ln in out.splitlines() if ln.startswith(head)), None)
    share = re.search(r"\((\d+)% of span\)", line or "")
    ops = sorted(lane["ops"].items(), key=lambda kv: kv[1][0], reverse=True)
    rec = {"device_lane": list(key), "device_busy_ms": lane["busy_us"] / 1e3,
           "span_ms": span_ms, "device_busy_share": lane["busy_us"] / 1e3 / span_ms,
           "printed_busy_share_pct": int(share.group(1)) if share else None,
           "lanes": len(table), "device_ops": len(lane["ops"]),
           "trace_kernel_events": {k: v[0] for k, v in events.items()},
           "trace_kernel_ms": {k: v[1] for k, v in events.items()},
           "counter_launches": {k: window[c] for k, c in TRACE_COUNTERS.items()},
           "device_top": [{"name": n[:90], "ms": us / 1e3, "events": c}
                          for n, (us, c) in ops[:TRACE_TOP_ROWS]]}
    if share is None:
        fails.append(f"trace_summary prints no busy share for the device lane: {line!r}")
    host = [n for n in lane["ops"] if n.startswith("aten::")]
    if host:
        fails.append(f"trace_summary: host ops on the device lane: {host[:3]}")
    for k, c in TRACE_COUNTERS.items():
        if events[k][0] != window[c] or window[c] == 0:
            fails.append(f"trace_summary: {events[k][0]} {k} events on the device lane, "
                         f"{window[c]} launches counted in the profiled window")
    return rec, fails


def phase_trace_summary(card, tmp, window):
    """The port's trace_summary, in this process, on what the smoke wrote:
    train_cli_telemetry's profile of steps 3-4 (its directory), the
    serve_telemetry request trace (with --slo), the autoscale control log
    and the serve_telemetry attribution report. Every run exits 0; the
    profile's device lane is checked against the launch counters
    (trace_summary_checks); its top rows are printed."""
    from mingpt_distributed_tpu_torch.tools import trace_summary

    prof = os.path.join(tmp, "prof")
    t0 = time.perf_counter()
    rc, out = summary_run([prof])
    seconds = {"profile": time.perf_counter() - t0}
    table, t_min, t_max = trace_summary.lanes(trace_summary.load_trace(prof))
    rec, fails = trace_summary_checks(out, table, t_min, t_max, window)
    if rc != 0:
        fails.append(f"trace_summary {prof} exited {rc}")
    runs = {}
    for kind, argv, want in (
            ("request_trace", [os.path.join(tmp, "traces.jsonl"), "--slo"], "SLO report"),
            ("control_log", [os.path.join(tmp, "autoscale-control.jsonl")],
             "control log (mingpt-control/1)"),
            ("attrib", [os.path.join(tmp, "attrib.json")], "Attribution report")):
        t0 = time.perf_counter()
        krc, kout = summary_run(argv)
        seconds[kind] = time.perf_counter() - t0
        runs[kind] = {"rc": krc, "lines": len(kout.splitlines()),
                      "first_line": kout.splitlines()[0] if kout else ""}
        if krc != 0 or want not in kout:
            fails.append(f"trace_summary {kind}: exit {krc}, {want!r} not printed")
    emit({"phase": "trace_summary", "profile": os.path.basename(prof),
          "profile_steps": list(PROFILE_STEPS), "rc": rc, "summary_lines": len(out.splitlines()),
          **rec, "other_inputs": runs, "seconds": seconds, "card": card})
    check(not fails, "; ".join(fails))


# The families on the card: tools/exp_families.py's four (4 layers, width 512,
# T 1024, batch 4, bf16) through run(), then the mistral family at the
# mistral-7b preset's widths (d 4096, 32/8 heads, hd 128, FFN 14336, V 32000,
# window 4096) cut to 2 layers, T 8192, batch 1. Before each, its attention
# kernels are held against their plain versions at the shapes it gives them;
# at Mistral-7B widths the plain version runs one KV group of 8/2 heads at a
# time (MISTRAL_7B_PLAIN_GROUPS: the plain scores of all 32 heads would take
# ~8.6 GB a pass).
FAMILY_LAYERS = 4
MISTRAL_7B_LAYERS = 2
MISTRAL_7B_T = 8192
MISTRAL_7B_KERNEL_CASE = ("mistral7b", 1, MISTRAL_7B_T, 32, 8, 128, 4096, None)
MISTRAL_7B_PLAIN_GROUPS = 4
FAMILY_KERNELS = ("flash_fwd", "flash_bwd_prep", "flash_bwd_dq", "flash_bwd_dkv")


def family_kernel_cases():
    """The attention shapes exp_families' FAMILIES give the kernels, one
    case each (name, B, T, H, KV, hd, window, softcap), named by the
    families that share it."""
    from mingpt_distributed_tpu_torch.tools import exp_families as ef

    shapes = {}
    for name, kw in ef.FAMILIES.items():
        cfg = ef.config(kw)
        key = (ef.BATCH, cfg.block_size, cfg.n_head, cfg.kv_heads, cfg.head_dim,
               cfg.attention_window, cfg.attn_logit_softcap)
        shapes.setdefault(key, []).append(name)
    return [("family_" + "_".join(names), *key) for key, names in shapes.items()]


def check_attention_kernels(fa, i, case, card, plain_groups=1):
    """K1, the prep pass and K2a/K2b against their plain versions on
    ``case`` in bf16 (seed index ``i``), outside the launch counts; fails
    on the first case that disagrees."""
    with preserved_counts():
        for fn in (fwd_case, prep_case, bwd_case):
            kw = {} if fn is prep_case else {"plain_groups": plain_groups}
            rec, kfails = fn(fa, i, case, torch.bfloat16, **kw)
            emit({**rec, "plain_groups": plain_groups, "card": card})
            check(not kfails, "; ".join(msg for _, msg in kfails))
    torch.cuda.empty_cache()


def mistral_7b_kw():
    """The mistral-7b preset's model at MISTRAL_7B_LAYERS layers."""
    from mingpt_distributed_tpu_torch.config import MODEL_PRESETS

    return dict(MODEL_PRESETS["mistral-7b"], n_layer=MISTRAL_7B_LAYERS,
                block_size=MISTRAL_7B_T)


def phase_families(fa, card):
    """K1, the prep pass and K2a/K2b against their plain versions at each
    of family_kernel_cases, then exp_families.run for each family on the
    card (split backward: one K1, prep, K2a and K2b launch per layer per
    step), then the 2-layer Mistral-7B-width step: the kernels against
    their plain versions at MISTRAL_7B_KERNEL_CASE (the plain version by
    MISTRAL_7B_PLAIN_GROUPS KV groups), then exp_families' 3 steps,
    each with its ms, MFU (the trainer's flops_per_token), launches (2 of
    each) and peak memory (the process's, and over what it held before the
    setup); the losses finite and falling. Returns the launches of each family's run and of
    the Mistral-7B-width step's first step."""
    from mingpt_distributed_tpu_torch.models import gpt
    from mingpt_distributed_tpu_torch.tools import exp_families as ef
    from mingpt_distributed_tpu_torch.training.metrics import flops_per_token

    i = len(KERNEL_CASES) + len(FWD_RING_CASES) + len(BWD_RING_CASES) + 2
    for j, case in enumerate(family_kernel_cases()):
        check_attention_kernels(fa, i + 1 + j, case, card)
    n = ef.STEPS
    want = expected(**{k: FAMILY_LAYERS * n for k in FAMILY_KERNELS})
    fails, launches = [], {}
    with fused_switch(False):
        for name, kw in ef.FAMILIES.items():
            reset_counts()
            t0 = time.perf_counter()
            rec = ef.run(name, kw, device="cuda")
            dt = time.perf_counter() - t0
            counts = launches[f"family_{name}"] = read_counts()
            emit({"phase": "family", **rec, "config": kw, "batch": ef.BATCH, "steps": n,
                  "dtype": "bfloat16", "launches": counts, "launches_want": want,
                  "seconds": dt, "card": card})
            if counts != want:
                fails.append(f"family {name}: launches {counts}, want {want}")
            torch.cuda.empty_cache()
    check(not fails, "; ".join(fails))

    check_attention_kernels(fa, i, MISTRAL_7B_KERNEL_CASE, card, MISTRAL_7B_PLAIN_GROUPS)

    fails = []
    kw = mistral_7b_kw()
    tokens = np.random.default_rng(17).integers(0, kw["vocab_size"], (1, MISTRAL_7B_T))
    per_step = expected(**{k: MISTRAL_7B_LAYERS for k in FAMILY_KERNELS})
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    with fused_switch(False):
        cfg, step, state, batch = ef.setup(kw, device="cuda", tokens=tokens)
        n_params = gpt.param_count(state.params)
        steps, losses = [], []
        for s in range(n):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            m = step(state, batch)
            losses.append(m["loss"].item())
            torch.cuda.synchronize()
            counts = read_counts()
            dt = time.perf_counter() - t0
            steps.append({"step": s + 1, "ms": dt * 1e3,
                          "mfu": flops_per_token(cfg, MISTRAL_7B_T) * MISTRAL_7B_T / dt
                          / PEAK_FLOPS[torch.bfloat16],
                          "launches": {k: v for k, v in counts.items() if v},
                          "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                          "peak_over_setup_bytes": torch.cuda.max_memory_allocated() - base,
                          "loss": losses[-1]})
            if counts != per_step:
                fails.append(f"mistral-7b width step {s + 1}: launches {counts}, "
                             f"want {per_step}")
    rec = {"phase": "family_mistral_7b_width", "model": "mistral-7b widths, 2 layers",
           "n_layer": cfg.n_layer, "n_embd": cfg.n_embd, "n_head": cfg.n_head,
           "n_kv_head": cfg.n_kv_head, "head_dim": cfg.head_dim, "window": cfg.attention_window,
           "vocab_size": cfg.vocab_size, "seq": MISTRAL_7B_T, "batch": 1, "dtype": cfg.dtype,
           "params": n_params, "fp32_weights_grads_adam_bytes": 16 * n_params,
           "allocated_before_setup_bytes": base,
           "launches_want_per_step": {k: v for k, v in per_step.items() if v},
           "steps": steps, "losses": losses, "grad_norm": m["grad_norm"].item(),
           "card": card}
    emit(rec)
    del state, batch, step
    torch.cuda.empty_cache()
    check(not fails, "; ".join(fails))
    ef.check_losses("mistral-7b width", losses)
    launches["family_mistral_7b_width_step_1"] = steps[0]["launches"]
    return launches


# ---------------------------------------------------------------------------
# phase 4g: the head widths of GPT-3 2.7B, GPT-3 Large and Gemma 2B
# ---------------------------------------------------------------------------

# Train steps at the widths of public models whose head widths the kernels
# have instances for beyond 16..128, each at full width and cut to 2 layers
# (name: model, batch, the model's keywords). GPT-3's are the GPT-2
# architecture of the JAX `gpt2` family at Brown et al. 2020, Table 2.1's
# widths (n_ctx 2048); Gemma 2B's is Gemma Team 2024, Table 1 (d_model
# 2048, 8 heads, 1 KV head, head size 256, FFN 16384, vocabulary 256000,
# context 8192) with rope, rmsnorm and tied embeddings; its gated MLP is the
# JAX package's SwiGLU where Gemma's is GeGLU.
HEAD_WIDTH_STEPS = {
    "gpt3_2p7b_width": ("GPT-3 2.7B widths (d_model 2560, 32 heads, d_head 80), 2 layers",
                        4, dict(n_layer=2, n_head=32, n_embd=2560, vocab_size=50257,
                                block_size=2048)),
    "gpt3_large_width": ("GPT-3 Large widths (d_model 1536, 16 heads, d_head 96), 2 layers",
                         8, dict(n_layer=2, n_head=16, n_embd=1536, vocab_size=50257,
                                 block_size=2048)),
    "gemma_2b_width": ("Gemma 2B widths (d_model 2048, 8 heads over 1 KV head, head size 256, "
                       "FFN 16384, V 256000), 2 layers; SwiGLU where Gemma has GeGLU",
                       1, dict(n_layer=2, n_head=8, n_kv_head=1, n_embd=2048,
                               vocab_size=256000, block_size=8192, ffn_mult=8.0, rope=True,
                               rmsnorm=True, swiglu=True, tie_weights=True)),
}
HEAD_WIDTH_STEP_COUNT = 3
# The plain versions of the kernel checks run over KV groups where one
# group's float32 scores (B x H / groups x T x T) keep them within memory;
# Gemma's single KV head is one group (8 x 8192^2 floats, 2.1 GB)
HEAD_WIDTH_PLAIN_GROUPS = {"gpt3_2p7b_width": 4, "gpt3_large_width": 4, "gemma_2b_width": 1}
# The first loss against the same weights' loss through plain attention,
# relative: moe_train_step's bound (the Mistral-7B-width step holds none)
HEAD_WIDTH_LOSS_REL_TOL = MOE_PLAIN_LOSS_REL_TOL


def head_width_case(name):
    """The kernel case (name, B, T, H, KV, hd, window, softcap) a
    HEAD_WIDTH_STEPS model gives the attention kernels."""
    _, batch, kw = HEAD_WIDTH_STEPS[name]
    hd = kw["n_embd"] // kw["n_head"]
    return (name, batch, kw["block_size"], kw["n_head"], kw.get("n_kv_head", kw["n_head"]),
            hd, None, None)


def phase_head_widths(fa, card):
    """For each of HEAD_WIDTH_STEPS: K1, the prep pass and K2a/K2b (and K2c
    at hd 256) against their plain versions at the step's attention shape
    (bf16, outside the counts); the first loss against the same weights'
    loss through plain attention; then HEAD_WIDTH_STEP_COUNT split steps of
    make_train_step (exp_families.setup: bf16, random weights, the batch its
    own targets), each with its ms, MFU by the JAX formula, launches (2 of
    K1, prep, K2a and K2b) and peak memory over the setup; at hd 256 one
    more step with FLASH_FUSED_BWD=1 (2 K1, prep and K2c). Returns the
    launches of each model's first split step and of the fused step."""
    from mingpt_distributed_tpu_torch.models import gpt
    from mingpt_distributed_tpu_torch.tools import exp_families as ef
    from mingpt_distributed_tpu_torch.training.metrics import flops_per_token

    i0 = len(KERNEL_CASES) + len(FWD_RING_CASES) + len(BWD_RING_CASES) + 16
    launches, fails = {}, []
    for j, (name, (model, batch, kw)) in enumerate(HEAD_WIDTH_STEPS.items()):
        case = head_width_case(name)
        check_attention_kernels(fa, i0 + j, case, card, HEAD_WIDTH_PLAIN_GROUPS[name])
        if case[5] == 256:
            with preserved_counts():
                rec, kfails = fused_case(fa, i0 + j, case, torch.bfloat16)
            emit({**rec, "card": card})
            check(not kfails, "; ".join(msg for _, msg in kfails))
        torch.cuda.empty_cache()

        t = kw["block_size"]
        tokens = np.random.default_rng(23 + j).integers(0, kw["vocab_size"], (batch, t))
        per_step = expected(**{k: kw["n_layer"] for k in FAMILY_KERNELS})
        base = torch.cuda.memory_allocated()  # what earlier phases still hold
        with fused_switch(False):
            cfg, step, state, xy = ef.setup(kw, device="cuda", tokens=tokens)
            with torch.no_grad():
                _, plain_loss = gpt.forward(state.params, xy[0], dataclasses.replace(
                    cfg, attention="einsum"), targets=xy[1], return_logits=False)
            plain_loss = plain_loss.item()
            torch.cuda.empty_cache()
            steps, losses = [], []
            for s in range(HEAD_WIDTH_STEP_COUNT):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                t0 = time.perf_counter()
                m = step(state, xy)
                losses.append(m["loss"].item())
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                counts = read_counts()
                steps.append({"step": s + 1, "ms": dt * 1e3,
                              "mfu": flops_per_token(cfg, t) * batch * t / dt
                              / PEAK_FLOPS[torch.bfloat16],
                              "launches": {k: v for k, v in counts.items() if v},
                              "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                              "peak_over_setup_bytes": torch.cuda.max_memory_allocated() - base,
                              "loss": losses[-1]})
                if counts != per_step:
                    fails.append(f"{name} step {s + 1}: launches {counts}, want {per_step}")
        launches[name] = steps[0]["launches"]
        rel = abs(losses[0] - plain_loss) / abs(plain_loss)
        rec = {"phase": "head_width_step", "name": name, "model": model,
               "n_layer": cfg.n_layer, "n_embd": cfg.n_embd, "n_head": cfg.n_head,
               "n_kv_head": cfg.kv_heads, "head_dim": cfg.head_dim, "ffn": int(cfg.ffn_mult
                                                                                * cfg.n_embd),
               "vocab_size": cfg.vocab_size, "seq": t, "batch": batch, "dtype": cfg.dtype,
               "params": gpt.param_count(state.params),
               "allocated_before_setup_bytes": base,
               "launches_want_per_step": {k: v for k, v in per_step.items() if v},
               "steps": steps, "losses": losses, "grad_norm": m["grad_norm"].item(),
               "plain_attention_loss": plain_loss, "plain_loss_rel_err": rel,
               "plain_loss_tol": HEAD_WIDTH_LOSS_REL_TOL, "card": card}
        if not rel <= HEAD_WIDTH_LOSS_REL_TOL:
            fails.append(f"{name}: first loss {losses[0]} against plain attention's "
                         f"{plain_loss} (relative {rel})")
        if cfg.head_dim == 256:
            want = expected(flash_fwd=cfg.n_layer, flash_bwd_prep=cfg.n_layer,
                            flash_bwd_fused=cfg.n_layer)
            with fused_switch(True):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                t0 = time.perf_counter()
                m = step(state, xy)
                loss = m["loss"].item()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                counts = read_counts()
            launches[f"{name}_fused"] = {k: v for k, v in counts.items() if v}
            rec["fused_step"] = {"ms": dt * 1e3, "mfu": flops_per_token(cfg, t) * batch * t
                                 / dt / PEAK_FLOPS[torch.bfloat16],
                                 "launches": launches[f"{name}_fused"], "loss": loss,
                                 "peak_over_setup_bytes":
                                     torch.cuda.max_memory_allocated() - base}
            if counts != want:
                fails.append(f"{name} fused step: launches {counts}, want {want}")
            if not math.isfinite(loss):
                fails.append(f"{name} fused step: non-finite loss {loss}")
        emit(rec)
        del state, xy, step, m
        torch.cuda.empty_cache()
        check(not fails, "; ".join(fails))
        ef.check_losses(name, losses)
    return launches


def phase_head_width_times(fa, card):
    """K1, the prep pass, K2a, K2b, K2c, K3, K4a and K4b at each
    HEAD_WIDTH_STEPS model's attention shape, bf16, causal (K3 and K4 as the
    ring's own block): kernel, plain version (over
    HEAD_WIDTH_PLAIN_GROUPS) and SDPA times with their bounds (time lines,
    shape_of the model's name; SDPA takes K and V repeated to the query
    heads; where it refuses a shape its time is null, with the reason).
    Returns the time rows by (model, kernel)."""
    dtype = torch.bfloat16
    rows = {}
    for name in HEAD_WIDTH_STEPS:
        _, b, t, h, kv, hd, _, _ = head_width_case(name)
        groups = HEAD_WIDTH_PLAIN_GROUPS[name]
        scale = 1.0 / math.sqrt(hd)
        q, k, v = make_qkv(b, t, h, kv, hd, dtype, seed=920)
        g = torch.Generator(device="cuda").manual_seed(921)
        do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
        kw = dict(scale=scale, causal=True)
        with preserved_counts(), fused_switch(False):
            out, lse = fa.flash_fwd(q, k, v, scale=scale)
            delta = fa.flash_bwd_prep(out, do)
            dq_acc = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
            fwd_ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, scale=scale))
            prep_ms = cuda_ms(lambda: fa.flash_bwd_prep(out, do))
            dq_ms = cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, scale=scale))
            dkv_ms = cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale=scale))
            fused_ms = cuda_ms(lambda: fa.flash_bwd_dqkv(q, k, v, do, lse, delta, dq_acc,
                                                         scale=scale))
            lse_fwd_ms = cuda_ms(lambda: fa.flash_lse_fwd(q, k, v, **kw))
            lse_dq_ms = cuda_ms(lambda: fa.flash_lse_bwd_dq(q, k, v, do, lse, delta, **kw))
            lse_dkv_ms = cuda_ms(lambda: fa.flash_lse_bwd_dkv(q, k, v, do, lse, delta, **kw))
        fwd_plain = cuda_ms(lambda: by_kv_groups(fa.flash_fwd_plain, groups)(
            q, k, v, scale=scale), iters=3)
        prep_plain = cuda_ms(lambda: fa.flash_bwd_prep_plain(out, do), iters=3)
        bwd_plain = cuda_ms(lambda: by_kv_groups(fa.flash_bwd_plain, groups)(
            q, k, v, out, lse, do, scale=scale), iters=3)
        kr, vr = (x.repeat_interleave(h // kv, dim=2) for x in (k, v))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, kr, vr))
        lib = {}
        for what, fn in (("fwd", lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                          is_causal=True)),
                         ("bwd", sdpa_backward(q, kr, vr, do))):
            try:
                lib[what] = (cuda_ms(fn), f"SDPA {'forward' if what == 'fwd' else 'backward'}")
            except RuntimeError as e:  # a yardstick only: the port never calls it
                lib[what] = (None, f"SDPA refused this shape: {str(e)[:120]}")
        bwd_is = "flash_bwd_plain (dq, dk and dv)"
        got = emit_times((("flash_fwd", fwd_ms, fwd_plain, "flash_fwd_plain", *lib["fwd"]),
                          ("flash_bwd_prep", prep_ms, prep_plain,
                           "flash_bwd_prep_plain (delta)", None,
                           "none: no one PyTorch call sums out * dO in float32"),
                          ("flash_bwd_dq", dq_ms, bwd_plain, bwd_is, *lib["bwd"]),
                          ("flash_bwd_dkv", dkv_ms, bwd_plain, bwd_is, *lib["bwd"]),
                          ("flash_bwd_fused", fused_ms, bwd_plain, bwd_is, *lib["bwd"]),
                          ("flash_lse_fwd", lse_fwd_ms, fwd_plain, "flash_fwd_plain",
                           *lib["fwd"]),
                          ("flash_lse_bwd_dq", lse_dq_ms, bwd_plain, bwd_is, *lib["bwd"]),
                          ("flash_lse_bwd_dkv", lse_dkv_ms, bwd_plain, bwd_is, *lib["bwd"])),
                         (b, t, h, kv, hd), dtype, name, card)
        rows.update({(name, k): r for k, r in got.items()})
        del q, k, v, do, out, lse, delta, dq_acc, kr, vr, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase float16: the float16 instances of the flash kernels
# ---------------------------------------------------------------------------

# The float16 instances' kernel checks: GPT-2's attention shape (the train
# step's) and Gemma 2B's (hd 256 over one KV head, T 8192), each for K1, the
# prep pass (with and without an lse cotangent), K2a/K2b and K2c; then K3
# and K4a/K4b at the same shapes, causal with a q offset and not causal
# (name, B, T, H, KV, hd, causal, window, softcap, q_offset).
F16_KERNEL_CASES = [
    ("f16_gpt2_train", 16, 1024, 12, 12, 64, None, None),
    ("f16_gemma_2b", 1, 8192, 8, 1, 256, None, None),
]
F16_LSE_CASES = [
    ("f16_gpt2_offset256", 16, 1024, 12, 12, 64, True, None, None, 256),
    ("f16_gpt2_non_causal", 16, 1024, 12, 12, 64, False, None, None, 0),
    ("f16_gemma_2b_offset2048", 1, 8192, 8, 1, 256, True, None, None, 2048),
    ("f16_gemma_2b_non_causal", 1, 8192, 8, 1, 256, False, None, None, 0),
]
# The lse cotangent of the float16 lse cases, drawn N(0, 1) times this: over
# 1024 and 8192 keys p ~ 1/T dilutes a unit cotangent's effect on dk to
# ~1-2x the fp16 tolerance at hd 256 (DLSE_EFFECT_X asks 5x); scaled, it
# shows that the kernels take it.
F16_DLSE_SCALE = 8.0
# The seeds' index offset of the float16 checks (their inputs differ from
# every earlier case's).
F16_SEED = 4000
# The float16 instances: K1 and K3 at the 7 head widths in
# flash_fwd_f16.cu's library; K2a and K4a (dq), K2b, K4b and K2c (dk/dv) in
# flash_bwd_f16.cu's. K5 keeps float32 and bfloat16.
FWD_F16_KERNELS = 2 * 7
BWD_F16_KERNELS = {"flash_dq_f16_kernel": 2 * 7, "flash_dkv_f16_kernel": 3 * 7}
# A warpgroup product's SASS names its operands' type after the
# accumulator's: ".BF16" for bf16, nothing (or ".F16") for fp16.
F16_HGMMA = re.compile(r"HGMMA\.64x\d+x16\.F32(\.F16)?")
# GPT-2 124M float16 train step (the bench shape, T 1024, batch 16): its
# first loss against the same weights' loss through plain attention at
# float16, relative: a tenth of the bf16 head-width steps' bound (fp16's
# 3 more mantissa bits).
F16_STEPS = 3
F16_LOSS_REL_TOL = 1e-3
# Float16 sliding-window generation at GPT-2 width (4 prompts of 1000
# tokens, 32 new: the window slides past 1024) held by the forward's gate
# (FWD_BF16_*) with float16 constants: at each step of the kernel path's
# own sequence, its window re-forwarded in fp32 (plain attention), in
# float16 through plain attention and through the kernel. Where the fp32
# top-2 gap exceeds 3e, with e the plain float16 path's largest logit error
# against fp32 over every step, no float16 path within e can move the
# argmax: there the kernel path's token must be the plain float16 path's
# argmax at 0.99 of the positions, over at least half of them; its mean
# logit error against fp32 may exceed the plain path's by 25%.
FWD_F16_MARGIN_X = 3.0
FWD_F16_TOP1_MIN = 0.99
FWD_F16_MIN_DECIDED = 0.5
FWD_F16_ERR_RATIO = 1.25
F16_GEN_NEW = 32


def phase_float16_kernels(fa, card):
    """K1, the prep pass, K2a/K2b and K2c (F16_KERNEL_CASES) and K3/K4a/K4b
    (F16_LSE_CASES) at float16 against their plain versions, outside the
    launch counts; fails on the first case that disagrees. Returns the
    records by (kind, case)."""
    dtype = torch.float16
    records = {}
    with preserved_counts(), fused_switch(False):
        for j, case in enumerate(F16_KERNEL_CASES):
            for kind, fn in (("fwd", fwd_case), ("prep", prep_case), ("bwd", bwd_case),
                             ("fused", fused_case)):
                rec, fails = fn(fa, F16_SEED + j, case, dtype)
                emit({**rec, "phase": "float16", "part": "kernel_check", "card": card})
                check(not fails, "float16: " + "; ".join(msg for _, msg in fails))
                records[(kind, case[0])] = rec
            torch.cuda.empty_cache()
        for j, case in enumerate(F16_LSE_CASES):
            rec, fails = lse_case(fa, F16_SEED + 100 + j, case, dtype,
                                  dlse_scale=F16_DLSE_SCALE)
            emit({**rec, "phase": "float16", "part": "kernel_check",
                  "dlse_scale": F16_DLSE_SCALE, "card": card})
            check(not fails, "float16: " + "; ".join(msg for _, msg in fails))
            records[("lse", case[0])] = rec
            torch.cuda.empty_cache()
    return records


def hgmma_ops(c):
    """The distinct HGMMA opcodes of a kernel's SASS opcode counts."""
    return sorted(op for op in c if op.startswith("HGMMA"))


def f16_sass_check(fwd_counts, bwd_counts, bf16_counts):
    """The float16 instances' SASS records by template and the message of
    every check they fail: FWD_F16_KERNELS and BWD_F16_KERNELS
    instantiations, each issuing HGMMA on fp16 operands (F16_HGMMA), UTMALDG
    and no HMMA; and, as the control that the opcode tells the types
    apart, every HGMMA of the bf16 instances (``bf16_counts``) names BF16."""
    want = {"flash_fwd_f16_kernel": FWD_F16_KERNELS, **BWD_F16_KERNELS}
    found = {name: [] for name in want}
    for counts in (fwd_counts, bwd_counts):
        for kernel, c in counts.items():
            for name in found:
                if name in kernel:
                    found[name].append({**_sass_record("float16", kernel, c, ""),
                                        "part": "sass", "hgmma_ops": hgmma_ops(c)})
    fails = []
    for name, recs in found.items():
        if len(recs) != want[name]:
            fails.append(f"{name}: {len(recs)} instantiations, want {want[name]}")
        for r in recs:
            if not (r["hgmma"] > 0 and r["utmaldg"] > 0 and r["hmma"] == 0
                    and all(F16_HGMMA.fullmatch(op) for op in r["hgmma_ops"])):
                fails.append(f"{r['kernel']}: HGMMA {r['hgmma_ops']}, UTMALDG "
                             f"{r['utmaldg']}, HMMA {r['hmma']}")
    bf16_ops = sorted({op for c in bf16_counts.values() for op in hgmma_ops(c)})
    if not bf16_ops or not all(op.endswith(".BF16") for op in bf16_ops):
        fails.append(f"the bf16 instances' HGMMA opcodes {bf16_ops} do not name BF16")
    return found, fails, bf16_ops


def phase_float16_sass(card, sass):
    """The float16 libraries' kernels by their SASS (f16_sass_check; one
    line per instance) beside the bf16 libraries' (``sass``: sass_opcodes
    by library): fails unless each issues HGMMA on fp16 operands and
    UTMALDG and no HMMA."""
    bf16 = {k: c for lib in ("flash_fwd", "flash_bwd") for k, c in sass[lib].items()
            if "_bf16_kernel" in k}
    found, fails, bf16_ops = f16_sass_check(sass["flash_fwd_f16"], sass["flash_bwd_f16"], bf16)
    for recs in found.values():
        for r in recs:
            emit({**r, "card": card})
    emit({"phase": "float16", "part": "sass_summary",
          "instances": {k: len(v) for k, v in found.items()},
          "f16_hgmma_ops": sorted({op for recs in found.values() for r in recs
                                   for op in r["hgmma_ops"]}),
          "bf16_hgmma_ops": bf16_ops, "card": card})
    check(not fails, "float16 SASS: " + "; ".join(fails))


def _ptxas_pick(rows, template, hd, flags):
    """The ptxas row of ``template`` at head width ``hd`` whose bool
    template arguments are ``flags`` (a string of 0/1), or None."""
    pat = re.compile(rf"{template}ILi{hd}E" + "".join(f"Lb{f}E" for f in flags))
    return next((r for r in rows if pat.search(r["kernel"])), None)


def float16_ptxas(bf16_rows, f16_rows):
    """ptxas's registers, stack, spills and dynamic shared memory of the
    float16 instances at hd 64 and 256 beside their bf16 twins (K1, K3, K2a,
    K4a, K2b, K4b, K2c): one record each."""
    kinds = (("K1", "flash_fwd_{}_kernel", "00"), ("K3", "flash_fwd_{}_kernel", "10"),
             ("K2a", "flash_dq_{}_kernel", "00"), ("K4a", "flash_dq_{}_kernel", "10"),
             ("K2b", "flash_dkv_{}_kernel", "000"), ("K4b", "flash_dkv_{}_kernel", "100"),
             ("K2c", "flash_dkv_{}_kernel", "001"))
    keep = ("registers", "stack", "spill_stores", "spill_loads", "dynamic_smem_bytes")
    out = []
    for hd in (64, 256):
        for kernel, template, flags in kinds:
            rec = {"phase": "float16", "part": "ptxas", "kernel": kernel, "hd": hd}
            for dt, rows in (("bf16", bf16_rows), ("f16", f16_rows)):
                r = _ptxas_pick(rows, template.format(dt), hd, flags) or {}
                rec[dt] = {k: r.get(k) for k in keep}
            out.append(rec)
    return out


def phase_float16_train(card, steps=F16_STEPS):
    """make_train_step at the bench shape (GPT-2 124M, T 1024, batch 16) with
    gpt_config.dtype=float16 and flash attention: the first loss against
    the same weights' loss through plain attention; every gradient of the
    first step finite; ``steps`` split steps with the counts set to 0 just
    before and read just after (12 K1, prep, K2a and K2b per step), their ms,
    MFU by the JAX formula (against the fp16 peak) and peak memory; then
    one step with FLASH_FUSED_BWD=1 (12 K1, prep and K2c). Returns the
    record (its launches are the split steps') and the fused step's
    launches."""
    from mingpt_distributed_tpu_torch.config import GPTConfig, OptimizerConfig
    from mingpt_distributed_tpu_torch.models import convert, gpt
    from mingpt_distributed_tpu_torch.tools.profile_train import BATCH, SEQ
    from mingpt_distributed_tpu_torch.training.metrics import flops_per_token
    from mingpt_distributed_tpu_torch.training.optimizer import make_optimizer
    from mingpt_distributed_tpu_torch.training.trainer import (
        TrainState,
        make_train_step,
        trainable,
    )

    cfg = GPTConfig.make(model_type="gpt2", vocab_size=50257, block_size=SEQ, dtype="float16",
                         attention="flash", embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    params = trainable(gpt.init(cfg, torch.Generator().manual_seed(0), device="cuda"))
    state = TrainState(params, make_optimizer(OptimizerConfig(), params, 1.0))
    g = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), generator=g, device="cuda")
    batch = (tokens[:, :-1], tokens[:, 1:])
    with torch.no_grad():
        _, plain = gpt.forward(params, batch[0], dataclasses.replace(cfg, attention="einsum"),
                               targets=batch[1], return_logits=False)
    plain_loss = plain.item()
    del plain
    torch.cuda.empty_cache()
    with fused_switch(False):
        step = make_train_step(cfg)
        with preserved_counts():
            first = step(state, batch)  # the first loss: the plain loss's weights
            first_loss = first["loss"].item()
            grads = _grads(state)
            finite = {n: bool(torch.isfinite(gr).all()) for n, gr in grads.items()
                      if gr is not None}
            del grads
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        losses = [step(state, batch)["loss"] for _ in range(steps)]
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / steps
        counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    with fused_switch(True):
        reset_counts()
        m = step(state, batch)
        fused_loss = m["loss"].item()
        fused_counts = read_counts()
    losses = [first_loss] + [v.item() for v in losses]
    tokens_per_s = BATCH * SEQ / dt
    n = cfg.n_layer * steps
    want = expected(flash_fwd=n, flash_bwd_prep=n, flash_bwd_dq=n, flash_bwd_dkv=n)
    want_fused = expected(flash_fwd=cfg.n_layer, flash_bwd_prep=cfg.n_layer,
                          flash_bwd_fused=cfg.n_layer)
    rel = abs(first_loss - plain_loss) / abs(plain_loss)
    rec = {"phase": "float16", "part": "train_step", "main_path": True, "model": "gpt2 124M",
           "batch": BATCH, "seq": SEQ, "dtype": cfg.dtype, "steps": steps,
           "launches": counts, "launches_want": want, "step_ms": dt * 1e3,
           "tokens_per_s": tokens_per_s,
           "mfu": flops_per_token(cfg, SEQ) * tokens_per_s / PEAK_FLOPS[torch.float16],
           "peak_allocated_bytes": peak, "allocated_before_setup_bytes": base,
           "peak_over_setup_bytes": peak - base, "losses": losses,
           "plain_attention_loss": plain_loss, "plain_loss_rel_err": rel,
           "plain_loss_tol": F16_LOSS_REL_TOL, "grads_checked": len(finite),
           "grads_finite": all(finite.values()), "grad_norm": m["grad_norm"].item(),
           "fused_step": {"launches": fused_counts, "launches_want": want_fused,
                          "loss": fused_loss}, "card": card}
    emit(rec)
    check(len(finite) == len(convert.flatten(state.params)) and all(finite.values()),
          f"float16 train step: non-finite gradients "
          f"{[n for n, ok in finite.items() if not ok]}")
    check(rel <= F16_LOSS_REL_TOL, f"float16 train step: first loss {first_loss} against "
                                   f"plain attention's {plain_loss} (relative {rel})")
    check(counts == want, f"float16 train step: launches {counts}, want {want}")
    check(fused_counts == want_fused,
          f"float16 fused step: launches {fused_counts}, want {want_fused}")
    check(all(math.isfinite(v) for v in losses + [fused_loss]), "non-finite float16 loss")
    check(losses[-1] < losses[0], "float16: the loss on a repeated batch did not fall")
    del state, batch, step, m
    torch.cuda.empty_cache()
    return rec, fused_counts


def phase_float16_generate(GPT, fa, params32, card, new=F16_GEN_NEW):
    """Sliding-window generation at GPT-2 width in float16 (the main path's
    generate, 12 K1 launches per token, counts set to 0 just before), then
    plain attention's at float16 on the same prompts (tokens printed), then
    the forward's gate over every step of the kernel path's own sequence
    (FWD_F16_*). Returns the main path's launch counts."""
    prompt = 1000
    g = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, 50257, (4, prompt), generator=g, device="cuda")
    model16 = GPT(gpt2_config("flash", "float16"), params32, device="cuda")
    n_layer, bs = model16.config.n_layer, model16.config.block_size
    plain16 = GPT(gpt2_config("einsum", "float16"), params32, device="cuda")
    plain32 = GPT(gpt2_config("einsum", "float32"), params32, device="cuda")
    reset_counts()
    tokens, seconds = timed(lambda: model16.generate(prompts, new))
    counts = read_counts()
    plain_tokens = plain16.generate(prompts, new)
    check(tokens.shape == (4, prompt + new) and torch.equal(tokens[:, :prompt], prompts),
          f"float16 generate: tokens {tuple(tokens.shape)}")
    want = expected(flash_fwd=new * n_layer)
    chosen, l16k, l16p, l32 = [], [], [], []
    with torch.no_grad(), preserved_counts():
        for i in range(new):
            n = prompt + i
            ctx = tokens[:, max(0, n - bs):n]
            l16k.append(model16(ctx)[0][:, -1].float())
            l16p.append(plain16(ctx)[0][:, -1].float())
            l32.append(plain32(ctx)[0][:, -1])
            chosen.append(tokens[:, n])
    chosen, l16k, l16p, l32 = (torch.stack(x) for x in (chosen, l16k, l16p, l32))
    e16 = (l16p - l32).abs().max().item()
    top2 = l32.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > FWD_F16_MARGIN_X * e16
    n_decided = int(decided.sum().item())
    agree = ((chosen == l16p.argmax(-1))[decided].float().mean().item()
             if n_decided else None)
    rec = {"phase": "float16", "part": "generate_sliding", "main_path": True,
           "model": "gpt2 124M", "batch": 4, "prompt": prompt, "new_tokens": new,
           "launches": counts, "launches_want": want, "tokens_per_s": 4 * new / seconds,
           "tokens_equal_plain": bool(torch.equal(tokens, plain_tokens)),
           "positions": chosen.numel(), "plain_max_abs_err_vs_fp32": e16,
           "decided_margin": FWD_F16_MARGIN_X * e16, "decided_positions": n_decided,
           "top1_agreement_decided": agree, "top1_decided_min": FWD_F16_TOP1_MIN,
           "kernel_top1_vs_fp32": (chosen == l32.argmax(-1)).float().mean().item(),
           "kernel_mean_abs_err_vs_fp32": (l16k - l32).abs().mean().item(),
           "plain_mean_abs_err_vs_fp32": (l16p - l32).abs().mean().item(),
           "err_ratio_max": FWD_F16_ERR_RATIO, "card": card}
    emit(rec)
    check(counts == want, f"float16 generate: launches {counts}, want {want}")
    check(n_decided >= FWD_F16_MIN_DECIDED * chosen.numel(),
          f"float16 generate: only {n_decided} of {chosen.numel()} positions decided")
    check(agree >= FWD_F16_TOP1_MIN,
          f"float16 generate: top-1 agreement {agree} at decided positions")
    check(rec["kernel_mean_abs_err_vs_fp32"]
          <= FWD_F16_ERR_RATIO * rec["plain_mean_abs_err_vs_fp32"],
          "float16 generate: the kernel path is further from fp32 than allowed")
    del model16, plain16, plain32
    torch.cuda.empty_cache()
    return counts


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
SP_STEPS = 2  # a loss that falls, within the smoke's time budget
SP_DP2_LAYERS = 2
# the main path's ring in fp32: 2 of its 12 layers (cut from 12 to 4 to pay
# for the pipeline legs, then to 2 for the MoE-beside-sp legs), the same
# ring per layer and the same T
SP_FP32_LAYERS = 2
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
#        <= 2^-6 * max(1, max |ref|) (two bf16 steps);
#  fp16: the same roundings in fp16: mean <= 1.5e-3 (GRAD_REL_TOL's), max
#        |diff| <= 2^-9 * max(1, max |ref|) (two fp16 steps).
SP_ATTN_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 2.0 ** -6),
               "float16": (1.5e-3, 2.0 ** -9)}


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


def _sp_attention(mesh, device, ring_f16_launches=None):
    """Ring and Ulysses on this rank's chunk, in each dtype, against the
    same chunk of the dense plain attention and its gradients. The float16
    ring (its K3, prep, K4a and K4b instances) runs with the launch counts
    set to 0 just before and read into ``ring_f16_launches`` just after."""
    from mingpt_distributed_tpu_torch.ops import attention as attn_ops
    from mingpt_distributed_tpu_torch.parallel.ring_attention import ring_causal_attention
    from mingpt_distributed_tpu_torch.parallel.ulysses import ulysses_causal_attention

    g = torch.Generator().manual_seed(800)
    full = [torch.randn((1, SP_T, 12, 64), generator=g) for _ in range(4)]
    c = SP_T // mesh.sp
    sl = slice(mesh.sp_rank * c, (mesh.sp_rank + 1) * c)
    res = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q, k, v, do = (x.to(device, dtype) for x in full)
        ref_in = [x.float().requires_grad_() for x in (q, k, v)]
        ref = attn_ops.causal_attention(*ref_in)
        ref_grads = torch.autograd.grad(ref, ref_in, do.float())
        want = [ref[:, sl].detach()] + [r[:, sl] for r in ref_grads]
        del ref, ref_grads, ref_in
        for name, fn in (("ring", ring_causal_attention),
                         ("ulysses", ulysses_causal_attention)):
            loc = [x[:, sl].contiguous().requires_grad_() for x in (q, k, v)]
            counted = (dtype == torch.float16 and name == "ring"
                       and ring_f16_launches is not None)
            if counted:
                reset_counts()
            out = fn(*loc, mesh)
            grads = torch.autograd.grad(out, loc, do[:, sl].contiguous())
            if counted:
                torch.cuda.synchronize()
                ring_f16_launches.update(read_counts())
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


# sp x tp and sp x fsdp (meshes of the SP ranks): the main path at dp 1 x
# sp 2 x tp 2 (GPT-2 124M, bf16, block SP_T, global batch SP_BATCH, the
# zigzag ring on each rank's 6 of 12 heads: 3 + (2 - 1) K3 launches per layer
# and as many of the prep pass, K4a and K4b in the backward, per rank per
# step); then fp32 legs at SP_DP2_LAYERS layers, global batch
# SP_TP_PARITY_BATCH, against one process: losses and every gradient within
# SP_TP_PARITY_REL_TOL relative, the parameters after the first update
# within FT_PARAM_ATOL (fsdp_tp's leg's gate: Adam's first step amplifies
# the summation order where |g| nears its eps)
SP_TP_MESH = dict(dp=1, sp=2, tp=2)
SP_FSDP_MESH = dict(dp=1, fsdp=2, sp=2)
SP_TP_STEPS = 2
SP_TP_PER_LAYER = 3 + (SP_TP_MESH["sp"] - 1)
SP_TP_PARITY_BATCH = 2
SP_TP_PARITY_REL_TOL = 1e-5


def _sptp_main(device, dense_loss):
    """The sp x tp main path: SP_TP_STEPS steps with the launch counts set
    to 0 just before and read just after, each step's wall ms, the ms in
    collectives (the card synchronised before each: host traffic alone),
    the q shapes K3 saw, and the first loss beside the dense single-process
    loss of the sp main path's model and batch (``dense_loss``, rank 0)."""
    from mingpt_distributed_tpu_torch.config import MeshConfig
    from mingpt_distributed_tpu_torch.ops import flash_attention as fa
    from mingpt_distributed_tpu_torch.parallel import distributed as D
    from mingpt_distributed_tpu_torch.parallel.mesh import Mesh
    from mingpt_distributed_tpu_torch.training.trainer import make_train_step

    t_leg = time.perf_counter()
    mesh = Mesh(MeshConfig(**SP_TP_MESH))
    cfg = _sp_gpt_config("ring")
    state = _ft_state(cfg, device, mesh)
    step = make_train_step(cfg, mesh=mesh)
    x, y = _sp_batch(5)
    batch = (_ft_rows(x, mesh, device), _ft_rows(y, mesh, device))
    spent, shapes = {"s": 0.0, "calls": 0}, set()
    real = {"_exchange": D._exchange, "all_reduce": D.all_reduce}
    real_lse = fa.attention_with_lse

    def timed_collective(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent["s"] += time.perf_counter() - t0
                spent["calls"] += 1
        return run

    def attention_with_lse(q, *args, **kwargs):
        shapes.add(tuple(q.shape))
        return real_lse(q, *args, **kwargs)

    for name, fn in real.items():
        setattr(D, name, timed_collective(fn))
    fa.attention_with_lse = attention_with_lse
    torch.cuda.synchronize()
    reset_counts()
    losses, seconds = [], []
    try:
        for _ in range(SP_TP_STEPS):
            t0 = time.perf_counter()
            losses.append(step(state, batch)["loss"].item())
            seconds.append(time.perf_counter() - t0)
        counts = read_counts()
    finally:
        for name, fn in real.items():
            setattr(D, name, fn)
        fa.attention_with_lse = real_lse
    del state, batch
    torch.cuda.empty_cache()
    return {"losses": losses, "seconds": seconds, "collective_s": spent["s"],
            "collective_calls": spent["calls"], "launches": counts,
            "q_shapes": sorted(shapes), "dense_loss": dense_loss,
            "coords": {"sp": mesh.sp_rank, "tp": mesh.tp_rank},
            "leg_s": time.perf_counter() - t_leg}


def _sptp_parity(mesh_kw, device):
    """An fp32 leg of the sp x tp or sp x fsdp mesh against one process."""
    from mingpt_distributed_tpu_torch.config import MeshConfig
    from mingpt_distributed_tpu_torch.parallel.mesh import Mesh

    t0 = time.perf_counter()
    tokens = _sp_batch(7)
    batch = tuple(a[:SP_TP_PARITY_BATCH] for a in tokens)
    out = _ft_parity(Mesh(MeshConfig(**mesh_kw)), device,
                     _sp_gpt_config("ring", SP_DP2_LAYERS, "float32"), batch)
    out["leg_s"] = time.perf_counter() - t0
    return out


def sp_rank(rank):
    """One of the SP ranks (spawned by parallel.spawn.run_ranks, sharing
    cuda:0): the attention checks, the main path, the main path's ring in
    fp32, the dp x sp step (fp32). Rank 0 then runs each step's dense
    single-process reference (the others wait in their next collective).
    Then the sp x tp main path and the sp x tp and sp x fsdp fp32 legs, the
    fsdp x tp slice (``ft_rank``), the zero and moe_ep slices
    (``zero_moe_rank``) and the pipeline and checkpoint slices
    (``pp_rank``): one spawn serves every phase."""
    from mingpt_distributed_tpu_torch.config import MeshConfig
    from mingpt_distributed_tpu_torch.parallel.mesh import Mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ring_f16 = {}
    out = {"attention": _sp_attention(Mesh(MeshConfig(dp=1, sp=SP)), device, ring_f16),
           "ring_float16_launches": ring_f16}
    for key, cfg, dp, seed, steps in (
            ("main", _sp_gpt_config("ring"), 1, 5, SP_STEPS),
            ("main_fp32", _sp_gpt_config("ring", SP_FP32_LAYERS, "float32"), 1, 5, 1),
            ("dp2_sp2", _sp_gpt_config("ulysses", SP_DP2_LAYERS, "float32"), 2, 6, 1)):
        mesh = Mesh(MeshConfig(dp=dp, sp=SP // dp))
        out[key], grads = _sp_train(cfg, mesh, device, seed, steps)
        if rank == 0:
            out[key]["dense"] = sp_dense(cfg, seed, steps, device, grads)
        del grads
        torch.cuda.empty_cache()
    dense = out["main"]["dense"]["losses"][0] if rank == 0 else None
    out["sp_tp"] = _sptp_main(device, dense)
    out["sp_tp_parity"] = _sptp_parity(SP_TP_MESH, device)
    out["sp_fsdp_parity"] = _sptp_parity(SP_FSDP_MESH, device)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["ft"] = ft_rank(rank)
    out["ft_seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    out["zm"] = zero_moe_rank(device)
    torch.cuda.empty_cache()
    out["ms"] = moe_sp_rank(device)
    torch.cuda.empty_cache()
    out["pp"] = pp_rank(device, rank)
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


def sp_attention_checks(ranks, card):
    """The sp_attention records (ring and Ulysses in each dtype against the
    dense plain attention, over every rank's chunk; the float16 ring's
    launches per rank) and the ("attention", message) of every check they
    fail."""
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
        if key == "ring_float16" and "ring_float16_launches" in ranks[0]:
            # the float16 path of K3, the prep pass, K4a and K4b: one layer's
            # zigzag ring, forward and backward
            want = expected(flash_lse_fwd=SP_K3_PER_LAYER, flash_bwd_prep=SP_K3_PER_LAYER,
                            flash_lse_bwd_dq=SP_K3_PER_LAYER,
                            flash_lse_bwd_dkv=SP_K3_PER_LAYER)
            got = [r["ring_float16_launches"] for r in ranks]
            rec.update({"launches_per_rank": got, "launches_want": want})
            fails += [("attention", f"sp ring float16 launches {g}, want {want}")
                      for g in got if g != want]
        records.append(rec)
    return records, fails


def sp_checks(ranks, card):
    """The records of the sp ranks' results and the (group, message) of
    every check they fail; groups "attention", "main" (the main path and
    its fp32 ring step) and "dp2"."""
    records, fails = sp_attention_checks(ranks, card)

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
    per_fp32 = SP_K3_PER_LAYER * SP_FP32_LAYERS
    want32 = expected(flash_lse_fwd=per_fp32, flash_bwd_prep=per_fp32,
                      flash_lse_bwd_dq=per_fp32, flash_lse_bwd_dkv=per_fp32)
    records.append(_sp_step_record(
        "sp_train_step_fp32", m32, m32[0]["dense"], attention="ring (zigzag)",
        layers=SP_FP32_LAYERS, dtype="float32", launches_want=want32, loss_tol=SP_FP32_LOSS_TOL,
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
    if "sp_tp" in ranks[0]:
        rec, more = sp_tp_checks(ranks, card)
        records += rec
        fails += [("sp_tp", msg) for msg in more]
    return records, fails


def sp_tp_checks(ranks, card):
    """The sp x tp main path's record and its fp32 legs' (every rank's
    K3/K4a/K4b/prep launches exactly SP_TP_PER_LAYER per layer per step,
    K3 at the tp-local head count), and the message of every failed
    check."""
    main = [r["sp_tp"] for r in ranks]
    m0 = main[0]
    per_step = SP_TP_PER_LAYER * 12
    want = expected(flash_lse_fwd=per_step * SP_TP_STEPS,
                    flash_bwd_prep=per_step * SP_TP_STEPS,
                    flash_lse_bwd_dq=per_step * SP_TP_STEPS,
                    flash_lse_bwd_dkv=per_step * SP_TP_STEPS)
    b, c, h = SP_BATCH, SP_T // SP_TP_MESH["sp"], 12 // SP_TP_MESH["tp"]
    local = sorted({(b, c // 2, h, 64), (2 * b, c // 2, h, 64)})
    step_s = sum(sum(m["seconds"][1:]) for m in main) / (SP * (SP_TP_STEPS - 1))
    coll_s = sum(m["collective_s"] for m in main) / (SP * SP_TP_STEPS)
    records = [{
        "phase": "sp_tp_train_step", "main_path": True, "model": "gpt2 124M",
        "mesh": SP_TP_MESH, "ranks": SP, "backend": "gloo, one shared card",
        "attention": "ring (zigzag), heads sharded over tp", "global_batch": SP_BATCH,
        "seq": SP_T, "dtype": "bfloat16", "steps": SP_TP_STEPS, "losses": m0["losses"],
        "dense_first_loss": m0["dense_loss"], "loss_tol": SP_LOSS_TOL,
        "step_ms": step_s * 1e3, "collective_ms_per_step": coll_s * 1e3,
        "collective_calls_per_step": m0["collective_calls"] / SP_TP_STEPS,
        "step_ms_per_rank": [sum(m["seconds"][1:]) / (SP_TP_STEPS - 1) * 1e3 for m in main],
        "shared_card_tokens_per_s": SP_BATCH * SP_T / step_s,
        "throughput_note": "shared-card, not multi-GPU throughput: 4 gloo ranks on one "
                           "H100, collectives through host memory",
        "launches_per_rank": [m["launches"] for m in main], "launches_want": want,
        "launches_per_rank_per_step": {k: v / SP_TP_STEPS
                                       for k, v in m0["launches"].items() if v},
        "k3_q_shapes": [list(q) for q in m0["q_shapes"]],
        "k3_q_shapes_want": [list(q) for q in local],
        "coords": [m["coords"] for m in main], "card": card}]
    fails = [f"sp_tp launches {m['launches']}, want {want}"
             for m in main if m["launches"] != want]
    if [tuple(q) for q in m0["q_shapes"]] != local:
        fails.append(f"sp_tp: K3 saw q shapes {m0['q_shapes']}, want {local}")
    if any(m["losses"] != m0["losses"] for m in main[1:]):
        fails.append("sp_tp: the ranks' losses differ")
    if not all(math.isfinite(v) for v in m0["losses"]):
        fails.append(f"sp_tp: losses {m0['losses']}")
    if not abs(m0["losses"][0] - m0["dense_loss"]) <= SP_LOSS_TOL:
        fails.append(f"sp_tp: loss {m0['losses'][0]} vs dense {m0['dense_loss']}")
    for key, mesh in (("sp_tp_parity", SP_TP_MESH), ("sp_fsdp_parity", SP_FSDP_MESH)):
        rec, more = parity_checks(
            [r[key] for r in ranks], f"{key[:-7]}_parity_fp32", card,
            (SP_TP_PARITY_REL_TOL, SP_TP_PARITY_REL_TOL), mesh=mesh, ranks=SP,
            layers=SP_DP2_LAYERS, global_batch=SP_TP_PARITY_BATCH, seq=SP_T)
        records.append(rec)
        fails += more
    legs_s = max(m["leg_s"] for m in main) + max(r["sp_tp_parity"]["leg_s"] for r in ranks) \
        + max(r["sp_fsdp_parity"]["leg_s"] for r in ranks)
    records[0]["legs_seconds"] = legs_s
    return records, fails


def phase_sp(card):
    """The sp slice on SP ranks sharing the card. Returns the main path's
    and the sp x tp main path's launch counts (rank 0's), the sp x tp legs'
    seconds, each rank's fsdp x tp results with their seconds, each rank's
    zero and moe_ep results, its moe_sp results and its pipeline and
    checkpoint results (the same ranks run them: ``phase_fsdp_tp``,
    ``phase_zero_moe``, ``phase_moe_sp`` and ``phase_pp`` check them), and
    rank 0's launch counts of the float16 ring (K3/K4's float16 path)."""
    from mingpt_distributed_tpu_torch.parallel.spawn import run_ranks

    t0 = time.perf_counter()
    with fused_switch(False):  # the ranks inherit it: K2a/K2b in Ulysses
        ranks = run_ranks(sp_rank, SP, timeout_s=900)
    seconds = time.perf_counter() - t0
    records, fails = sp_checks(ranks, card)
    for rec in records:
        emit({**rec, "spawn_seconds": seconds} if rec.get("main_path") else rec)
    check(not fails, "; ".join(msg for _, msg in fails))
    sp_tp = next(r for r in records if r["phase"] == "sp_tp_train_step")
    return (ranks[0]["main"]["launches"], ranks[0]["sp_tp"]["launches"],
            sp_tp["legs_seconds"], ([r["ft"] for r in ranks],
                                    max(r["ft_seconds"] for r in ranks)),
            [r["zm"] for r in ranks], [r["ms"] for r in ranks],
            [{"pp": r["pp"]} for r in ranks], ranks[0]["ring_float16_launches"])


# ---------------------------------------------------------------------------
# phase 3f: the SLO autoscaler (control/controller.py) over the process fleet
# ---------------------------------------------------------------------------

# The controller of the autoscale phase: the burst (16 requests at once on
# one replica of 4 slots: 12 queued) breaches a backlog of 2 per replica at
# the first tick, the standby is adopted, and 20 comfortable ticks in a row
# (a second with no backlog) drain the newcomer again. Evaluated every 50 ms
# of the wall clock.
AUTOSCALE_SPEC = ("auto:metric=queue_depth:target=2.0:comfort=0.5:interval_s=0.05"
                  ":cooldown_s=0.5:up_after=1:down_after=20:min_replicas=1:max_replicas=2")
AUTOSCALE_BURST = 16
# serve's first 24 requests (the burst, then 8 paced): a cut of serve's 32
# for the smoke's time; the scale-up rides the burst, the scale-down the
# drain after the last
AUTOSCALE_REQUESTS = 24
AUTOSCALE_PACE_ROUNDS = 3   # router rounds between the later arrivals
AUTOSCALE_DRAIN_WAIT_S = 30.0


def control_rows(text):
    """A mingpt-control/1 document's rows (none when it does not validate)
    and its validator's problems."""
    from mingpt_distributed_tpu_torch.control import validate_control_log

    problems = validate_control_log(text)
    rows = [] if problems else [json.loads(ln) for ln in text.splitlines() if ln.strip()]
    return rows, problems


def autoscale_arrivals(n_req, burst=AUTOSCALE_BURST, pace=AUTOSCALE_PACE_ROUNDS):
    """The router round at which each of ``n_req`` requests is submitted:
    ``burst`` at round 0, then one every ``pace`` rounds."""
    return [0] * min(burst, n_req) + [pace * (i + 1) for i in range(max(0, n_req - burst))]


def phase_autoscale(params32, card, tmp, procfleet_rec, fleet_rec):
    """The SLO autoscaler on a process fleet at GPT-2 124M width, bf16: one
    worker x 4 slots built like serve's server, one warm standby, the
    controller ``AUTOSCALE_SPEC`` (1..2 replicas) with its log on disk, the
    backfill on a thread (the fleet runs on the wall clock). serve's first
    AUTOSCALE_REQUESTS requests: a burst of 16, then one every 3 router
    rounds. Checks: a replicas/up row
    whose reason reads path=standby, a replicas/down after the traffic whose
    worker exits 75 and gives the card its memory back (PROC_MEM_MARGIN),
    every request's 64 tokens streamed once (no token lost or repeated), the
    greedy streams under the teacher-forced tie rule with the thread fleet's
    margin, every log row strict-valid mingpt-control/1. Prints tokens/s
    beside procfleet's, the seconds from the scale-up decision to the
    newcomer's first token, the adoption's seconds and the backfill's."""
    from mingpt_distributed_tpu_torch.control import SLOAutoscaler, parse_controller_spec

    cfg = gpt2_config("flash", "bfloat16")
    reqs, lengths, sampled = serve_traffic(AUTOSCALE_REQUESTS, cfg.vocab_size)
    spec = worker_spec(cfg, n_slots=4, prefill_chunk=256, prefix_cache_mb=256, warmup=True)
    t_build = time.perf_counter()
    supervisor, router, streamed, spawns = proc_fleet(
        spec, os.path.join(tmp, "autoscale"), n_replicas=1, standby=1)
    build_s = time.perf_counter() - t_build
    log_path = os.path.join(tmp, "autoscale-control.jsonl")
    controller = SLOAutoscaler(router, parse_controller_spec(AUTOSCALE_SPEC), log_path=log_path)
    router.controller = controller
    ups, retired = [], []
    real_up, real_retire = controller._scale_up, supervisor.retire_replica

    def scale_up(snap, reason):
        t0 = time.perf_counter()
        out = real_up(snap, reason)
        ups.append({"decided_at": t0, "seconds": time.perf_counter() - t0,
                    "actuator": out[0], "reason": out[1]})
        return out

    def retire(rep):
        # the backfill spawns the next standby on a thread: a spawn still
        # placing its weights or warming up while the card's free memory is
        # read takes its growth off what the retired worker gives back, so
        # the reading waits for the backfill to end
        t_join = time.perf_counter()
        supervisor.standby_pool.join()
        backfill_wait_s = time.perf_counter() - t_join
        torch.cuda.synchronize()
        free0, pid = torch.cuda.mem_get_info()[0], rep.backend.pid
        info = real_retire(rep)
        retired.append({"name": rep.name, "pid": pid, "free_before": free0,
                        "exit": info.get("exit_code"), "at": time.perf_counter(),
                        "backfill_wait_s": backfill_wait_s})
        return info

    controller._scale_up, supervisor.retire_replica = scale_up, retire
    first_token = {}  # replica -> first token's time
    router.on_token = lambda fh, t: (streamed.setdefault(fh.request_id, []).append(t),
                                     first_token.setdefault(fh.replica, time.perf_counter()))
    at = autoscale_arrivals(len(reqs))
    handles, rounds = [], 0
    t0 = time.perf_counter()
    with router_faults() as faults:
        while len(handles) < len(reqs) or not all(h.finished for h in handles):
            while len(handles) < len(reqs) and at[len(handles)] <= rounds:
                handles.append(router.submit(reqs[len(handles)]))
            router.step()
            rounds += 1
        dt = time.perf_counter() - t0
        supervisor.standby_pool.join()
        t_idle = time.perf_counter()
        while not retired and time.perf_counter() - t_idle < AUTOSCALE_DRAIN_WAIT_S:
            router.step()
            time.sleep(0.005)
    memory = None
    if retired:
        born = next(s for s in spawns if s["pid"] == retired[0]["pid"])
        footprint = born["free_before"] - born["free_after"]
        free = torch.cuda.mem_get_info()[0]
        while (free < retired[0]["free_before"] + footprint - PROC_MEM_MARGIN
               and time.perf_counter() - retired[0]["at"] < PROC_MEM_WAIT_S):
            time.sleep(0.005)
            free = torch.cuda.mem_get_info()[0]
        memory = {"worker_footprint_at_spawn": footprint,
                  "free_before_retire": retired[0]["free_before"], "free_after_exit": free,
                  "returned": free - retired[0]["free_before"], "margin": PROC_MEM_MARGIN,
                  "release_s_after_retire": time.perf_counter() - retired[0]["at"]}
    drained_exits = dict(supervisor.drained_exits)
    exits = supervisor.shutdown_all()
    with open(log_path) as f:
        rows, problems = control_rows(f.read())
    up_rows = [r for r in rows if r["action"] == {"actuator": "replicas", "direction": "up"}]
    down_rows = [r for r in rows if r["action"] == {"actuator": "replicas", "direction": "down"}]
    up = next((u for u in ups if u["actuator"] == "replicas"), None)
    newcomer = next((s["name"] for s in spawns if s["name"].startswith("standby")), None)
    new_replica = "replica1"
    first_new = first_token.get(new_replica)
    backfill = [s for s in spawns if s["name"] != newcomer and s["name"].startswith("standby")]
    generated = sum(len(h.tokens) for h in handles)
    greedy = [(h, r) for h, r, s in zip(handles, reqs, sampled) if not s]
    res = forced_tie_rule(params32, cfg, [(h.request_id, list(r.prompt), h.tokens)
                                          for h, r in greedy], None,
                          e=fleet_rec["max_logit_err"])
    tps = generated / dt
    rec = {"phase": "autoscale", "model": "gpt2 124M", "dtype": "bfloat16",
           "controller": AUTOSCALE_SPEC, "start_replicas": 1, "standby": 1,
           "slots_per_worker": 4, "requests": len(reqs), "burst": AUTOSCALE_BURST,
           "pace_rounds": AUTOSCALE_PACE_ROUNDS, "sampled_top_k50": sum(sampled),
           "prompt_tokens": int(sum(lengths)), "new_tokens": SERVE_NEW,
           "generated_tokens": generated, "seconds": dt, "router_rounds": rounds,
           "tokens_per_s": tps, "procfleet_tokens_per_s": procfleet_rec["tokens_per_s"],
           "ratio_to_procfleet": tps / procfleet_rec["tokens_per_s"],
           "build_seconds": build_s,
           "scale_up_actuation_s": up["seconds"] if up else None,
           "decision_to_first_new_replica_token_s": (
               first_new - up["decided_at"] if up and first_new else None),
           "backfill_spawn_s": [s["seconds"] for s in backfill],
           "requests_on_new_replica": sum(h.replica == new_replica for h in handles),
           "ticks": controller.tick, "actions": controller.action_counts(),
           "up_reasons": [r["reason"] for r in up_rows],
           "down_reasons": [r["reason"] for r in down_rows],
           "log_problems": problems, "retired": retired, "drained_exits": drained_exits,
           "memory": memory, "exits": exits, "spawns": spawns,
           "greedy_requests": len(greedy), **res,
           "divergence_count": len(res["divergences"]),
           "tie_margin_from": "the thread fleet's recorded logits (phase fleet)",
           "router_faults": faults, "summary": router.summary(),
           "launches": "not counted (the workers' own counters)",
           "wall_clock_note": "decisions ride the wall clock: ticks and timings vary by run",
           "card": card}
    emit(rec)
    check(not problems and rows, f"autoscale: control log problems {problems[:3]}")
    check(up_rows and "path=standby" in up_rows[0]["reason"],
          f"autoscale: no replicas/up adopting the standby: {rec['up_reasons']}")
    check(down_rows and retired and drained_exits.get(retired[0]["name"]) == 75,
          f"autoscale: no drained replica exiting 75: {drained_exits}, {retired}")
    check(memory is not None and memory["returned"] >= memory["worker_footprint_at_spawn"]
          - PROC_MEM_MARGIN, f"autoscale: the drained worker's memory did not come back: "
          f"{memory}")
    check(first_new is not None, "autoscale: the new replica never emitted a token")
    check(all(h.finish_reason == "length" and len(h.tokens) == SERVE_NEW for h in handles),
          f"autoscale: a request did not end with {SERVE_NEW} tokens")
    check(all(streamed.get(h.request_id) == h.tokens for h in handles),
          "autoscale: a caller stream lost or repeated a token")
    check_tie_rule("autoscale", res, len(greedy) * SERVE_NEW)
    check(faults == {"crash": 0, "step_failure": 0},
          f"autoscale: the router handled faults with no injector: {faults}")
    check(all(c == 75 for c in exits.values()), f"autoscale: worker exits {exits}")
    return rec


def phase_traffic_controller(params32, card):
    """The traffic lab's controller axis at GPT-2 124M width, bf16:
    ``traffic --selftest-controller``'s canned sweep (one down-ramp rung,
    FIFO static against FIFO autoscaled, 36 requests, 1 replica x 2 slots at
    first) over the self-test mix at V = 50257, twice, through the CLI's
    gates (the controller scales up and down, beats static on deadline hit
    rate and cost, a valid log, byte-identical reruns); the report and the
    control log equal field for field to the tiny model's on the CPU on the
    same mix."""
    from mingpt_distributed_tpu_torch import traffic as traffic_cli
    from mingpt_distributed_tpu_torch.models import gpt

    cfg = gpt2_config("flash", "bfloat16")
    tiny = traffic_cli.tiny_config()
    row_bytes = 2 * cfg.n_layer * cfg.kv_heads * cfg.head_dim * 2
    tiny_row_bytes = 2 * tiny.n_layer * tiny.kv_heads * tiny.head_dim * 4
    spec = dataclasses.replace(traffic_cli.selftest_controller_spec(),
                               prefix_cache_mb=0.5 * row_bytes / tiny_row_bytes)
    mix = traffic_cli.selftest_mix(cfg.vocab_size)
    reset_counts()
    with router_faults() as faults:
        (report, logs), dt = timed(lambda: traffic_cli.run_with_logs(
            params32, cfg, spec, mix, dict(device="cuda")))
        (report2, logs2), dt2 = timed(lambda: traffic_cli.run_with_logs(
            params32, cfg, spec, mix, dict(device="cuda")))
    launches = read_counts()
    rc = traffic_cli.controller_checks(report, logs, report2, logs2, tag="traffic_controller")
    tcfg = dataclasses.replace(tiny, vocab_size=cfg.vocab_size)
    tparams = gpt.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    cpu, cpu_logs = traffic_cli.run_with_logs(tparams, tcfg, traffic_cli.selftest_controller_spec(),
                                              mix, dict(device="cpu"))
    differ = _diff_paths(json.loads(json.dumps(cpu)), json.loads(json.dumps(report)))
    rows, problems = control_rows(logs.get((0, "fifo+auto"), ""))
    cells = report["rungs"][0]["policies"]
    emit({"phase": "traffic_controller", "model": "gpt2 124M", "dtype": "bfloat16",
          "arrival": spec.arrival, "controllers": list(spec.controllers),
          "requests": spec.n_requests, "prefix_cache_mb": spec.prefix_cache_mb,
          "deadline_hit_rate": {p: c["deadline_hit_rate"] for p, c in cells.items()},
          "cost": {p: c["cost"]["cost"] for p, c in cells.items()},
          "control": cells["fifo+auto"].get("control"), "log_rows": len(rows),
          "log_problems": problems, "sweep_seconds": [dt, dt2],
          "fields_differing_from_cpu_tiny": sorted({re.sub(r"\[\d+\]", "[]", p)
                                                     for p in differ}),
          "control_log_equal_to_cpu_tiny": logs == cpu_logs,
          "router_faults": faults, "launches": launches, "card": card})
    check(rc == 0, "traffic_controller: a self-test gate failed (lines above)")
    check(not problems, f"traffic_controller: control log problems {problems[:3]}")
    check(differ == [] and logs == cpu_logs,
          f"traffic_controller: the report differs from the tiny CPU run in {differ}")
    check(faults == {"crash": 0, "step_failure": 0},
          f"traffic_controller: the router handled faults: {faults}")
    check(not any(launches.values()), f"traffic_controller launched kernels: {launches}")
    torch.cuda.empty_cache()
    return launches


SERVE_CLI_AUTOSCALE = ("auto:metric=queue_depth:target=0.5:comfort=0.5:interval_s=0"
                       ":cooldown_s=0:up_after=1:down_after=1:min_replicas=1:max_replicas=2")


def phase_serve_cli_autoscale(card, train_argv, tmp, plain_texts):
    """serve --replicas 1 --autoscale SERVE_CLI_AUTOSCALE --control-log
    over the train entry point's snapshot (thread isolation): completions
    byte-equal to the plain --prompts-file run's, every log row strict-valid
    mingpt-control/1, the log's actions printed."""
    path = os.path.join(tmp, "prompts.txt")
    log = os.path.join(tmp, "serve-control.jsonl")
    (rc, out), dt = timed(lambda: run_serve(
        ["--prompts-file", path, "--greedy", "--max-new-tokens", "32", "--slots", "2",
         "--log-every", "0", "--replicas", "1", "--autoscale", SERVE_CLI_AUTOSCALE,
         "--control-log", log, *train_argv]))
    texts = served_texts(out)
    with open(log) as f:
        rows, problems = control_rows(f.read())
    acted = [r["action"] for r in rows if r["action"]["direction"] != "hold"]
    emit({"phase": "serve_cli_autoscale", "rc": rc, "controller": SERVE_CLI_AUTOSCALE,
          "completions_equal": texts == plain_texts, "log_rows": len(rows),
          "log_problems": problems, "actions": acted, "seconds": dt, "card": card})
    check(rc == 0, f"serve --autoscale exited {rc}")
    check(len(texts) == len(plain_texts) and texts == plain_texts,
          f"serve --autoscale: {texts} != the plain run's {plain_texts}")
    check(rows and not problems, f"serve --autoscale: control log problems {problems[:3]}")


def phase_serve_cli_tp(card, train_argv, tmp, plain_texts):
    """serve --mesh tp=2 --dist-backend gloo over the train entry point's
    snapshot (this process drives, one follower process on the card):
    completions byte-equal to the plain --prompts-file run's, the follower
    out by exit 0."""
    path = os.path.join(tmp, "prompts.txt")
    (rc, out), dt = timed(lambda: run_serve(
        ["--prompts-file", path, "--greedy", "--max-new-tokens", "32", "--slots", "2",
         "--log-every", "0", "--mesh", "tp=2", "--dist-backend", "gloo", *train_argv]))
    texts = served_texts(out)
    emit({"phase": "serve_cli_tp", "rc": rc, "completions_equal": texts == plain_texts,
          "completions": [t[len(p):] for p, t in zip(SERVE_CLI_PROMPTS, texts)],
          "seconds": dt, "card": card})
    check(rc == 0, f"serve --mesh tp=2 exited {rc}")
    check(len(texts) == len(plain_texts) and texts == plain_texts,
          f"serve --mesh tp=2: {texts} != the plain run's {plain_texts}")


# ---------------------------------------------------------------------------
# phase 4d: fsdp x tp training (dp 1 x fsdp 2 x tp 2, gloo ranks on one card)
# ---------------------------------------------------------------------------

FT_MESH = dict(dp=1, fsdp=2, tp=2)
FT_RANKS = 4
FT_T = 1024
FT_BATCH = 16
FT_STEPS = 1  # after the warm-up step, within the smoke's time budget
FT_PARITY_LAYERS = 2
FT_PARITY_BATCH = 4
FT_PARITY_STEPS = 2
# The fp32 parity leg against the single-process step on the same weights
# and batch (fp32 on the card: the collectives sum in another order than
# one process does; the kernels' own fp32 gates are 1e-5 forward, 2e-4
# gradients): losses within 1e-4 relative; every parameter's first gradient
# within GRAD_FP32_REL_TOL relative (norm-wise; blocks/bk, 0 in exact
# arithmetic, only within the total); the parameters after the first update
# within 1e-4 absolute. Adam's first update is lr * g / (|g| + eps): where |g|
# nears eps (1e-8) the update moves by lr * eps / (|g| + eps)^2 per unit of
# g, so the summation order moves those parameters most; the largest
# difference where |g| > 1e-6 is printed beside the largest of all (first
# card run: 1.2e-7 and 2.9e-5).
FT_LOSS_REL_TOL = 1e-4
FT_PARAM_ATOL = 1e-4
FT_STEADY_GRAD = 1e-6
# the main path's attention kernels per rank per step: one of each per layer
FT_PER_STEP = 12


def _ft_config(n_layer=None, dtype="bfloat16"):
    from mingpt_distributed_tpu_torch.config import GPTConfig

    dims = (dict(model_type="gpt2") if n_layer is None
            else dict(n_layer=n_layer, n_head=12, n_embd=768))
    return GPTConfig.make(vocab_size=50257, block_size=FT_T, attention="flash",
                          dtype=dtype, embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0,
                          **dims)


def _ft_batch(seed, rows):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, 50257, (rows, FT_T + 1), generator=g)
    return tokens[:, :-1], tokens[:, 1:]


def _ft_state(cfg, device, mesh=None, zero=False, seed=0, generator_device="cpu"):
    """A train state from seed ``seed``: this rank's slices under a sharded
    ``mesh``; with ``zero`` the optimizer on its 1/dp (a ZeRO plan)."""
    from mingpt_distributed_tpu_torch.config import OptimizerConfig
    from mingpt_distributed_tpu_torch.models import gpt
    from mingpt_distributed_tpu_torch.parallel import zero as zero_lib
    from mingpt_distributed_tpu_torch.training.optimizer import make_optimizer
    from mingpt_distributed_tpu_torch.training.trainer import TrainState, trainable

    params = gpt.init(cfg, torch.Generator(device=generator_device).manual_seed(seed),
                      device=device)
    plan = zero_lib.make_plan(mesh, params) if zero else None
    if mesh is not None and mesh.sharded:
        params = mesh.shard_params(params)
    params = trainable(params)
    return TrainState(params, make_optimizer(OptimizerConfig(), params, 1.0, mesh=mesh,
                                             zero=plan))


def _ft_rows(a, mesh, device):
    """This rank's rows of a global batch (its dp x fsdp share) and, under
    sp, its chunk of the sequence."""
    n, c = a.shape[0] // mesh.batch_count, a.shape[1] // mesh.sp
    return a[mesh.batch_index * n:(mesh.batch_index + 1) * n,
             mesh.sp_rank * c:(mesh.sp_rank + 1) * c].contiguous().to(device)


def _ft_whole(mesh, tree, grads=False, opt=None):
    """Every rank joins the gathers; the whole leaves (or gradients: under
    ZeRO, ``opt``'s shards' gathered back)."""
    from mingpt_distributed_tpu_torch.models import convert

    leaves = convert.flatten(tree)
    if opt is not None and opt.zero is not None and grads:
        leaves = {n: opt.gather_shard(n, s.grad) for n, s in zip(opt.names, opt.shards)}
    elif grads:
        leaves = {n: p.grad for n, p in leaves.items()}
    if not mesh.sharded:
        return {n: t.detach().clone() for n, t in leaves.items()}
    return {n: mesh.gather_full(n, t) for n, t in leaves.items()}


def _ft_parity(mesh, device, cfg=None, batch=None, zero=False):
    """The fp32 leg: FT_PARITY_STEPS sharded steps (``zero``: the update
    sharded over dp), then on rank 0 the single-process steps on the same
    weights and batch (``cfg`` with flash attention, K1 and K2, where
    ``cfg`` runs the ring); the comparisons. Default: fsdp_tp's leg
    (FT_PARITY_LAYERS, FT_PARITY_BATCH rows of FT_T)."""
    from mingpt_distributed_tpu_torch.models import convert
    from mingpt_distributed_tpu_torch.training.trainer import make_train_step

    cfg = cfg or _ft_config(FT_PARITY_LAYERS, "float32")
    x, y = batch or _ft_batch(11, FT_PARITY_BATCH)
    state = _ft_state(cfg, device, mesh, zero=zero)
    step = make_train_step(cfg, mesh=mesh)
    losses = []
    for i in range(FT_PARITY_STEPS):
        losses.append(step(state, (_ft_rows(x, mesh, device), _ft_rows(y, mesh, device)))
                      ["loss"].item())
        if i == 0:
            grads = _ft_whole(mesh, state.params, True, state.optimizer)
            params = _ft_whole(mesh, state.params)
    del state
    out = {"losses": losses}
    if mesh.rank == 0:
        one = dataclasses.replace(cfg, attention="flash")
        ref = _ft_state(one, device)
        before = {n: p.detach().clone() for n, p in convert.flatten(ref.params).items()}
        rstep = make_train_step(one)
        ref_losses = []
        for i in range(FT_PARITY_STEPS):
            ref_losses.append(rstep(ref, (x.to(device), y.to(device)))["loss"].item())
            if i == 0:
                rgrads = {n: p.grad for n, p in convert.flatten(ref.params).items()}
                rparams = {n: p.detach().clone() for n, p in convert.flatten(ref.params).items()}
        rel = {n: ((grads[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
               for n, g in rgrads.items()}
        total = (torch.stack([(grads[n] - g).norm() for n, g in rgrads.items()]).norm()
                 / torch.stack([g.norm() for g in rgrads.values()]).norm()).item()
        steady_err = max(((params[n] - w).abs()[rgrads[n].abs() > FT_STEADY_GRAD].max().item()
                          if (rgrads[n].abs() > FT_STEADY_GRAD).any() else 0.0)
                         for n, w in rparams.items())
        out.update(ref_losses=ref_losses, grad_rel_err=rel, grad_total_rel_err=total,
                   param_max_abs_err_steady=steady_err,
                   param_max_abs_err_all=max((params[n] - w).abs().max().item()
                                             for n, w in rparams.items()),
                   steady_share=(sum(int((rgrads[n].abs() > FT_STEADY_GRAD).sum())
                                     for n in rgrads)
                                 / sum(g.numel() for g in rgrads.values())),
                   update_max_abs=max((rparams[n] - before[n]).abs().max().item()
                                      for n in before))
        del ref, rgrads, rparams, before
    del grads, params
    torch.cuda.empty_cache()
    return out


def _ft_main(mesh, device):
    """The main path: GPT-2 124M, T 1024, global batch FT_BATCH, bf16, the
    split backward; one warm-up step, then FT_STEPS steps with the launch
    counts set to 0 just before and read just after, each step's wall ms
    and the ms spent in collectives (the device synchronised before each,
    so it is host traffic alone), the q shapes K1 saw, the bytes this rank
    holds against the unsharded tree's, and the downgrade counter."""
    from mingpt_distributed_tpu_torch import telemetry
    from mingpt_distributed_tpu_torch.ops import flash_attention as fa
    from mingpt_distributed_tpu_torch.parallel import distributed as D
    from mingpt_distributed_tpu_torch.training.trainer import make_train_step

    cfg = _ft_config(None, "bfloat16")
    state = _ft_state(cfg, device, mesh)
    step = make_train_step(cfg, mesh=mesh)
    x, y = _ft_batch(12, FT_BATCH)
    batch = (_ft_rows(x, mesh, device), _ft_rows(y, mesh, device))
    losses = [step(state, batch)["loss"].item()]  # warm-up
    spent = {"s": 0.0, "calls": 0}
    shapes = set()
    real = {"_exchange": D._exchange, "all_reduce": D.all_reduce}
    real_attention = fa.causal_attention

    def timed_collective(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent["s"] += time.perf_counter() - t0
                spent["calls"] += 1
        return run

    def causal_attention(q, *args, **kwargs):
        shapes.add(tuple(q.shape))
        return real_attention(q, *args, **kwargs)

    for name, fn in real.items():
        setattr(D, name, timed_collective(fn))
    fa.causal_attention = causal_attention
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    seconds = []
    try:
        for _ in range(FT_STEPS):
            t0 = time.perf_counter()
            m = step(state, batch)
            losses.append(m["loss"].item())
            seconds.append(time.perf_counter() - t0)
        counts = read_counts()
    finally:
        for name, fn in real.items():
            setattr(D, name, fn)
        fa.causal_attention = real_attention
    opt = state.optimizer
    moments = opt.adam_state()
    held = sum(p.numel() * p.element_size() for p in opt.params)
    whole = sum(math.prod(mesh.full_shapes[n]) * 4 for n in opt.names)
    fam = telemetry.get_registry().counter("mingpt_train_sharding_downgrades_total",
                                           labels=("param",))
    out = {"losses": losses, "seconds": seconds, "collective_s": spent["s"],
           "collective_calls": spent["calls"], "launches": counts,
           "q_shapes": sorted(shapes), "grad_norm": m["grad_norm"].item(),
           "param_bytes": held, "param_bytes_unsharded": whole,
           "moment_bytes": sum(t.numel() * t.element_size()
                               for d in (moments["mu"], moments["nu"]) for t in d.values()),
           "moment_bytes_unsharded": 2 * whole,
           "param_bytes_by_rule": ft_rule_bytes(mesh.full_shapes),
           "downgraded_leaves": {n: list(s) for n, s in mesh.specs.items()
                                 if s != mesh_lib_spec(n, len(s))},
           "downgrades": {lab["param"]: child.value for lab, child in fam.children()},
           "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    del state, batch
    torch.cuda.empty_cache()
    return out


def ft_rule_bytes(full_shapes, mesh=FT_MESH):
    """The float32 bytes one rank should hold, worked from PARAM_RULES and
    the leaves' whole shapes alone: each dimension split by its axis's
    extent where that divides it, kept whole where it does not."""
    total = 0
    for path, shape in full_shapes.items():
        n = math.prod(shape)
        for size, axis in zip(shape, mesh_lib_spec(path, len(shape))):
            extent = mesh.get(axis, 1) if axis else 1
            if size % extent == 0:
                n //= extent
        total += 4 * n
    return total


def mesh_lib_spec(path, ndim):
    """A leaf's PARAM_RULES spec padded to ``ndim`` (before downgrades)."""
    from mingpt_distributed_tpu_torch.parallel.mesh import PARAM_RULES

    spec = PARAM_RULES[path.rsplit("/", 1)[-1]]
    return tuple(spec) + (None,) * (ndim - len(spec))


def ft_rank(rank):
    """One of the FT_RANKS ranks (dp 1 x fsdp 2 x tp 2, sharing cuda:0 over
    gloo): the fp32 parity leg, then the main path."""
    from mingpt_distributed_tpu_torch.config import MeshConfig
    from mingpt_distributed_tpu_torch.parallel.mesh import Mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    mesh = Mesh(MeshConfig(**FT_MESH))
    return {"parity": _ft_parity(mesh, device), "main": _ft_main(mesh, device),
            "coords": {"fsdp": mesh.fsdp_rank, "tp": mesh.tp_rank}}


def parity_checks(pars, phase, card, rel_tol=(FT_LOSS_REL_TOL, GRAD_FP32_REL_TOL), **what):
    """The record of an fp32 parity leg (``_ft_parity`` on every rank) and
    the message of every check it fails: losses and gradients within
    ``rel_tol`` (loss, gradient) relative, parameters within
    FT_PARAM_ATOL."""
    loss_tol, grad_tol = rel_tol
    fails = []
    par = pars[0]
    tag = phase.replace("_parity_fp32", "")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(par["losses"], par["ref_losses"])]
    rel = {n: v for n, v in par["grad_rel_err"].items() if n not in ZERO_GRAD_PARAMS}
    record = {"phase": phase, **what,
              "losses": par["losses"], "single_process_losses": par["ref_losses"],
              "loss_rel_err": loss_rel, "loss_rel_tol": loss_tol,
              "grad_max_rel_err": max(rel.values()), "grad_worst_param": max(rel, key=rel.get),
              "grad_total_rel_err": par["grad_total_rel_err"],
              "grad_rel_tol": grad_tol,
              "param_max_abs_err_steady": par["param_max_abs_err_steady"],
              "param_max_abs_err_all": par["param_max_abs_err_all"],
              "steady_share": par["steady_share"], "param_atol": FT_PARAM_ATOL,
              "update_max_abs": par["update_max_abs"], "card": card}
    if any(r["losses"] != par["losses"] for r in pars[1:]):
        fails.append(f"{tag} parity: the ranks' losses differ")
    if not all(v <= loss_tol for v in loss_rel):
        fails.append(f"{tag} parity: loss rel err {loss_rel}")
    if not (max(rel.values()) <= grad_tol and par["grad_total_rel_err"] <= grad_tol):
        fails.append(f"{tag} parity: gradient rel err {max(rel.values())} "
                     f"({max(rel, key=rel.get)}), total {par['grad_total_rel_err']}")
    if not par["param_max_abs_err_all"] <= FT_PARAM_ATOL:
        fails.append(f"{tag} parity: post-update params {par['param_max_abs_err_all']}")
    return record, fails


def ft_checks(ranks, card, seconds):
    """The fsdp_tp records and the message of every check they fail."""
    record, fails = parity_checks(
        [r["parity"] for r in ranks], "fsdp_tp_parity_fp32", card, mesh=FT_MESH,
        ranks=FT_RANKS, layers=FT_PARITY_LAYERS, global_batch=FT_PARITY_BATCH, seq=FT_T)
    records = [record]

    main = [r["main"] for r in ranks]
    want = expected(flash_fwd=FT_PER_STEP * FT_STEPS, flash_bwd_prep=FT_PER_STEP * FT_STEPS,
                    flash_bwd_dq=FT_PER_STEP * FT_STEPS, flash_bwd_dkv=FT_PER_STEP * FT_STEPS)
    local = (FT_BATCH // FT_MESH["fsdp"], FT_T, 12 // FT_MESH["tp"], 64)
    step_s = sum(sum(m["seconds"]) for m in main) / (FT_RANKS * FT_STEPS)
    coll_s = sum(m["collective_s"] for m in main) / (FT_RANKS * FT_STEPS)
    m0 = main[0]
    records.append({
        "phase": "fsdp_tp_train_step", "main_path": True, "model": "gpt2 124M",
        "mesh": FT_MESH, "ranks": FT_RANKS, "backend": "gloo, one shared card",
        "global_batch": FT_BATCH, "seq": FT_T, "dtype": "bfloat16", "steps": FT_STEPS,
        "flash_fused_bwd": False, "losses": m0["losses"],
        "step_ms": step_s * 1e3, "collective_ms_per_step": coll_s * 1e3,
        "collective_calls_per_step": m0["collective_calls"] / FT_STEPS,
        "step_ms_per_rank": [sum(m["seconds"]) / FT_STEPS * 1e3 for m in main],
        "shared_card_tokens_per_s": FT_BATCH * FT_T / step_s,
        "throughput_note": "shared-card, not multi-GPU throughput: 4 gloo ranks on one "
                           "H100, collectives through host memory",
        "launches_per_rank": [m["launches"] for m in main], "launches_want": want,
        "launches_per_rank_per_step": {k: v / FT_STEPS for k, v in m0["launches"].items()
                                       if v},
        "attention_q_shapes": m0["q_shapes"], "local_attention_shape": list(local),
        "param_bytes_per_rank": [m["param_bytes"] for m in main],
        "param_bytes_unsharded": m0["param_bytes_unsharded"],
        "param_share": [m["param_bytes"] / m["param_bytes_unsharded"] for m in main],
        "moment_bytes_per_rank": [m["moment_bytes"] for m in main],
        "moment_bytes_unsharded": m0["moment_bytes_unsharded"],
        "downgraded_leaves": m0["downgraded_leaves"], "downgrade_counter": m0["downgrades"],
        "peak_allocated_bytes_per_rank": [m["peak_allocated_bytes"] for m in main],
        "seconds": seconds, "card": card})
    fails += [f"fsdp_tp launches {m['launches']}, want {want}"
              for m in main if m["launches"] != want]
    if m0["q_shapes"] != [local]:
        fails.append(f"fsdp_tp: K1 saw q shapes {m0['q_shapes']}, want {[local]}")
    if any(m["losses"] != m0["losses"] for m in main[1:]):
        fails.append("fsdp_tp: the ranks' losses differ")
    if not all(math.isfinite(v) for v in m0["losses"]) or not m0["losses"][-1] < m0["losses"][0]:
        fails.append(f"fsdp_tp: losses {m0['losses']}")
    if m0["downgrades"] != {"wte": 1.0, "head": 1.0}:
        fails.append(f"fsdp_tp: downgrade counter {m0['downgrades']}")
    for m in main:
        if m["param_bytes"] != m["param_bytes_by_rule"]:
            fails.append(f"fsdp_tp: rank holds {m['param_bytes']} parameter bytes, "
                         f"want {m['param_bytes_by_rule']}")
        if m["moment_bytes"] != 2 * m["param_bytes"]:
            fails.append(f"fsdp_tp: moments {m['moment_bytes']} != 2 x params")
    return records, fails


def phase_fsdp_tp(card, ft):
    """The fsdp x tp slice's checks over what FT_RANKS ranks sharing the
    card returned (``ft``: their results and seconds, from phase_sp's
    spawn). Returns rank 0's main-path launch counts."""
    ranks, seconds = ft
    records, fails = ft_checks(ranks, card, seconds)
    for rec in records:
        emit(rec)
    check(not fails, "; ".join(fails))
    return ranks[0]["main"]["launches"]


def phase_fsdp_tp_times(fa, card):
    """K1, the prep pass, K2a and K2b at the fsdp x tp main path's local
    attention shape (8, 1024, 6, 64), bf16: kernel, plain version and SDPA
    times with their bounds (time lines, shape_of "fsdp_tp")."""
    b, t, h, hd = FT_BATCH // FT_MESH["fsdp"], FT_T, 12 // FT_MESH["tp"], 64
    dtype, scale = torch.bfloat16, 1.0 / math.sqrt(64)
    q, k, v = make_qkv(b, t, h, h, hd, dtype, seed=900)
    g = torch.Generator(device="cuda").manual_seed(901)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    with preserved_counts(), fused_switch(False):
        out, lse = fa.flash_fwd(q, k, v, scale=scale)
        delta = fa.flash_bwd_prep(out, do)
        fwd_ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, scale=scale))
        prep_ms = cuda_ms(lambda: fa.flash_bwd_prep(out, do))
        dq_ms = cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, scale=scale))
        dkv_ms = cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale=scale))
    fwd_plain = cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, scale=scale), iters=3)
    prep_plain = cuda_ms(lambda: fa.flash_bwd_prep_plain(out, do), iters=3)
    bwd_plain = cuda_ms(lambda: fa.flash_bwd_plain(q, k, v, out, lse, do, scale=scale),
                        iters=3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fwd_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    bwd_lib = cuda_ms(sdpa_backward(q, k, v, do))
    bwd_is = ("flash_bwd_plain (dq, dk and dv)", "SDPA backward (dq, dk and dv)")
    rows = emit_times((("flash_fwd", fwd_ms, fwd_plain, "flash_fwd_plain", fwd_lib,
                        "SDPA forward"),
                       ("flash_bwd_prep", prep_ms, prep_plain, "flash_bwd_prep_plain (delta)",
                        None, "none: no one PyTorch call sums out * dO in float32"),
                       ("flash_bwd_dq", dq_ms, bwd_plain, bwd_is[0], bwd_lib, bwd_is[1]),
                       ("flash_bwd_dkv", dkv_ms, bwd_plain, bwd_is[0], bwd_lib, bwd_is[1])),
                      (b, t, h, h, hd), dtype, "fsdp_tp", card)
    del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# ZeRO and mixture-of-experts across ranks (the SP ranks, sharing cuda:0)
# ---------------------------------------------------------------------------

# zero: GPT-2 124M at dp 4 with zero_dp (the update on each rank's 1/dp,
# parallel/zero.py), T 1024, global batch 16, bf16, the split backward; beside
# it the same step with zero_dp off on the same seeds. Each rank's Adam bytes
# by the allocator against opt_moment_bytes (1 % for the allocator's
# rounding of ~150 tensors to its 512-byte blocks)
ZERO_MESH = dict(dp=4)
ZERO_T, ZERO_BATCH, ZERO_STEPS = 1024, 16, 1  # timed steps after the warm-up
ZERO_BYTES_REL_TOL = 0.01
# the fp32 legs (zero at 2 layers; the narrow MoE) against one process: the
# sharded legs' rule (sp x tp's): losses and every gradient within 1e-5
# relative, the parameters after the first update within 1e-5 wherever
# |g| > 1e-6 (and within FT_PARAM_ATOL everywhere)
ZM_PARITY_REL_TOL = 1e-5
ZM_STEADY_ATOL = 1e-5
# moe_ep: Mixtral-8x7B widths at 1 layer, ep 4 (2 of 8 experts per rank),
# T 4096, global batch 4 (each rank 4096 rows: 4 whole routing groups of
# 1024), bf16. ~660 M parameters per rank, ~10.6 GB with fp32 gradients and
# Adam moments, x 4 ranks on the card
MOE_EP_MESH = dict(dp=1, ep=4)
MOE_EP_T, MOE_EP_BATCH, MOE_EP_STEPS = 4096, 4, 1  # timed steps after the warm-up
MOE_EP_KERNEL_CASE = ("moe_ep_train", 1, MOE_EP_T, 32, 8, 128, None, None)
# the narrow fp32 MoE (2 layers, E 8, k 2, capacity factor 0.5: capacity
# binds) at three meshes of the 4 ranks; 4 rows of 256 tokens: one routing
# group of 1024 spans every rank of distinct data
MOE_NARROW = dict(n_layer=2, n_head=4, n_embd=256, vocab_size=4096, block_size=256,
                  n_experts=8, moe_top_k=2, moe_capacity_factor=0.5, swiglu=True)
MOE_NARROW_MESHES = {"ep2_dp2": dict(dp=2, ep=2), "ep2_tp2": dict(dp=1, ep=2, tp=2),
                     "fsdp2_ep2": dict(dp=1, fsdp=2, ep=2)}
MOE_NARROW_ROWS = 4


def _zero_adam_bytes(state):
    """(the allocator's growth when the moments are made, what
    opt_moment_bytes says they take)."""
    from mingpt_distributed_tpu_torch.parallel import zero as zero_lib

    opt = state.optimizer
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    opt.init_moments()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    shapes = {n: torch.empty(opt.zero.by_name[n].shape if opt.zero else p.shape,
                             device="meta") for n, p in zip(opt.names, opt.params)}
    from mingpt_distributed_tpu_torch.models import convert

    return grown, zero_lib.opt_moment_bytes(convert.unflatten(shapes), opt.zero)


def _timed_steps(step, state, batch, steps):
    """One warm-up step, then ``steps`` with the launch counts set to 0
    just before and read just after: (losses, seconds, counts)."""
    losses = [step(state, batch)["loss"].item()]
    torch.cuda.synchronize()
    reset_counts()
    seconds = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step(state, batch)["loss"].item())
        seconds.append(time.perf_counter() - t0)
    return losses, seconds, read_counts()


def _zero_main(device):
    """The zero main path and its dense twin on the same seeds: losses,
    step seconds, launches, the q shapes K1 saw, the Adam bytes, and the
    reduce-scatter's and all-gather's host seconds per step."""
    from mingpt_distributed_tpu_torch.config import MeshConfig
    from mingpt_distributed_tpu_torch.ops import flash_attention as fa
    from mingpt_distributed_tpu_torch.parallel.mesh import Mesh
    from mingpt_distributed_tpu_torch.training.trainer import make_train_step

    mesh = Mesh(MeshConfig(**ZERO_MESH))
    cfg = _ft_config(None, "bfloat16")
    x, y = _ft_batch(13, ZERO_BATCH)
    batch = (_ft_rows(x, mesh, device), _ft_rows(y, mesh, device))
    out = {}
    for leg, zero in (("dense", False), ("zero", True)):
        state = _ft_state(cfg, device, mesh, zero=zero)
        grown, planned = _zero_adam_bytes(state)
        state.optimizer.timings = {} if zero else None
        shapes = set()
        real = fa.causal_attention

        def causal_attention(q, *args, **kwargs):
            shapes.add(tuple(q.shape))
            return real(q, *args, **kwargs)

        fa.causal_attention = causal_attention
        try:
            losses, seconds, counts = _timed_steps(make_train_step(cfg, mesh=mesh), state,
                                                   batch, ZERO_STEPS)
        finally:
            fa.causal_attention = real
        t = state.optimizer.timings or {}
        out[leg] = {"losses": losses, "seconds": seconds, "launches": counts,
                    "q_shapes": sorted(shapes), "adam_alloc_bytes": grown,
                    "opt_moment_bytes": planned,
                    # the warm-up step's collectives are in the sums too
                    "reduce_scatter_ms_per_step": t.get("reduce_scatter", 0.0) * 1e3
                    / (ZERO_STEPS + 1),
                    "all_gather_ms_per_step": t.get("all_gather", 0.0) * 1e3
                    / (ZERO_STEPS + 1),
                    "shards": (state.optimizer.zero.dp if state.optimizer.zero else 1)}
        del state
        torch.cuda.empty_cache()
    return out


def _moe_ep_main(device):
    """moe_ep: rank 0 first runs the one-process forward of the 4 global rows
    (the others wait); then every rank builds its slices one rank at a time
    (the whole 1-layer model is 6.8 GB of fp32 weights), trains a warm-up
    step and MOE_EP_STEPS counted ones. The all-to-alls' count and host
    seconds per step, the local expert count and q shape, and the first
    loss against the one-process forward's."""
    from mingpt_distributed_tpu_torch.config import MeshConfig
    from mingpt_distributed_tpu_torch.models import gpt
    from mingpt_distributed_tpu_torch.ops import flash_attention as fa
    from mingpt_distributed_tpu_torch.parallel import distributed as D
    from mingpt_distributed_tpu_torch.parallel.mesh import Mesh
    from mingpt_distributed_tpu_torch.training.trainer import make_train_step

    t_start = time.perf_counter()
    mesh = Mesh(MeshConfig(**MOE_EP_MESH))
    cfg = mixtral_config("bfloat16", 1, MOE_EP_T)
    g = torch.Generator().manual_seed(31)
    tokens = torch.randint(0, cfg.vocab_size, (MOE_EP_BATCH, MOE_EP_T + 1), generator=g)
    x, y = tokens[:, :-1], tokens[:, 1:]
    one_loss = None
    if mesh.rank == 0:
        with torch.no_grad():
            params = gpt.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                              device=device)
            _, loss = gpt.forward(params, x.to(device), cfg, targets=y.to(device),
                                  return_logits=False)
            one_loss = loss.item()
        del params, loss
        torch.cuda.empty_cache()
    state = None
    for r in range(mesh.world_size):  # one rank at a time holds the whole model
        if r == mesh.rank:
            state = _ft_state(cfg, device, mesh, generator_device="cuda")
            torch.cuda.empty_cache()
        D.barrier()
    ex = {"calls": 0, "s": 0.0}
    real = {"forward": D._AllToAll.forward, "backward": D._AllToAll.backward}
    shapes = set()
    real_attention = fa.causal_attention

    def timed(fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                ex["s"] += time.perf_counter() - t0
                ex["calls"] += 1
        return staticmethod(run)

    def causal_attention(q, *args, **kwargs):
        shapes.add(tuple(q.shape))
        return real_attention(q, *args, **kwargs)

    batch = (_ft_rows(x, mesh, device), _ft_rows(y, mesh, device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.causal_attention = causal_attention
    try:
        step = make_train_step(cfg, mesh=mesh)
        first = step(state, batch)["loss"].item()
        torch.cuda.synchronize()
        reset_counts()
        for name, fn in real.items():
            setattr(D._AllToAll, name, timed(fn))
        losses, seconds = [first], []
        for _ in range(MOE_EP_STEPS):
            t0 = time.perf_counter()
            losses.append(step(state, batch)["loss"].item())
            seconds.append(time.perf_counter() - t0)
        counts = read_counts()
    finally:
        for name, fn in real.items():
            setattr(D._AllToAll, name, staticmethod(fn))
        fa.causal_attention = real_attention
    opt = state.optimizer
    out = {"losses": losses, "seconds": seconds, "launches": counts,
           "q_shapes": sorted(shapes), "one_process_loss": one_loss,
           "local_experts": int(state.params["blocks"]["w_e1"].shape[1]),
           "param_bytes": sum(p.numel() * p.element_size() for p in opt.params),
           "all_to_all_calls_per_step": ex["calls"] / MOE_EP_STEPS,
           "all_to_all_ms_per_step": ex["s"] * 1e3 / MOE_EP_STEPS,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "leg_s": time.perf_counter() - t_start}
    del state, batch, step
    torch.cuda.empty_cache()
    return out


def _moe_narrow_parity(mesh_kw, device, attention="flash"):
    """An fp32 narrow-MoE leg on ``mesh_kw`` (``attention`` ring or ulysses
    under sp) against one process."""
    from mingpt_distributed_tpu_torch.config import GPTConfig, MeshConfig
    from mingpt_distributed_tpu_torch.parallel.mesh import Mesh

    t0 = time.perf_counter()
    cfg = GPTConfig.make(attention=attention, dtype="float32", embd_pdrop=0.0,
                         resid_pdrop=0.0, attn_pdrop=0.0, **MOE_NARROW)
    g = torch.Generator().manual_seed(41)
    tokens = torch.randint(0, cfg.vocab_size, (MOE_NARROW_ROWS, cfg.block_size + 1),
                           generator=g)
    out = _ft_parity(Mesh(MeshConfig(**mesh_kw)), device, cfg, (tokens[:, :-1],
                                                                 tokens[:, 1:]))
    out["leg_s"] = time.perf_counter() - t0
    return out


def zero_moe_rank(device):
    """The ZeRO and MoE legs of an SP rank: zero's main path and its dense
    twin, zero's fp32 leg, the narrow MoE's fp32 legs, then moe_ep."""
    from mingpt_distributed_tpu_torch.config import MeshConfig
    from mingpt_distributed_tpu_torch.parallel.mesh import Mesh

    out, seconds = {}, {}
    t0 = time.perf_counter()
    out["zero"] = _zero_main(device)
    out["zero_parity"] = _ft_parity(Mesh(MeshConfig(**ZERO_MESH)), device, zero=True)
    seconds["zero"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for key, mesh_kw in MOE_NARROW_MESHES.items():
        out[f"moe_{key}"] = _moe_narrow_parity(mesh_kw, device)
    torch.cuda.empty_cache()
    out["moe_ep"] = _moe_ep_main(device)
    seconds["moe_ep"] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def zm_parity_checks(pars, phase, card, **what):
    """parity_checks at ZM_PARITY_REL_TOL, plus the parameters within
    ZM_STEADY_ATOL where |g| > FT_STEADY_GRAD."""
    record, fails = parity_checks(pars, phase, card,
                                  (ZM_PARITY_REL_TOL, ZM_PARITY_REL_TOL), **what)
    record["param_steady_atol"] = ZM_STEADY_ATOL
    if not pars[0]["param_max_abs_err_steady"] <= ZM_STEADY_ATOL:
        fails.append(f"{phase}: post-update params where |g| > {FT_STEADY_GRAD}: "
                     f"{pars[0]['param_max_abs_err_steady']}")
    return record, fails


def zero_checks(ranks, card):
    """The zero records and the message of every check they fail."""
    records, fails = [], []
    rec, more = zm_parity_checks([r["zero_parity"] for r in ranks], "zero_parity_fp32",
                                 card, mesh=ZERO_MESH, ranks=SP, zero_dp=True,
                                 layers=FT_PARITY_LAYERS, global_batch=FT_PARITY_BATCH,
                                 seq=FT_T)
    records.append(rec)
    fails += more
    want = expected(flash_fwd=FT_PER_STEP * ZERO_STEPS,
                    flash_bwd_prep=FT_PER_STEP * ZERO_STEPS,
                    flash_bwd_dq=FT_PER_STEP * ZERO_STEPS,
                    flash_bwd_dkv=FT_PER_STEP * ZERO_STEPS)
    local = (ZERO_BATCH // ZERO_MESH["dp"], ZERO_T, 12, 64)
    legs = {leg: [r["zero"][leg] for r in ranks] for leg in ("dense", "zero")}
    step_ms = {leg: sum(sum(m["seconds"]) for m in ms) / (SP * ZERO_STEPS) * 1e3
               for leg, ms in legs.items()}
    z0, d0 = legs["zero"][0], legs["dense"][0]
    records.append({
        "phase": "zero_train_step", "main_path": True, "model": "gpt2 124M",
        "mesh": ZERO_MESH, "zero_dp": True, "ranks": SP,
        "backend": "gloo, one shared card", "global_batch": ZERO_BATCH, "seq": ZERO_T,
        "dtype": "bfloat16", "steps": ZERO_STEPS, "losses": z0["losses"],
        "dense_losses": d0["losses"], "step_ms": step_ms["zero"],
        "dense_step_ms": step_ms["dense"],
        "step_ms_per_rank": [sum(m["seconds"]) / ZERO_STEPS * 1e3 for m in legs["zero"]],
        "reduce_scatter_ms_per_step": [m["reduce_scatter_ms_per_step"]
                                       for m in legs["zero"]],
        "all_gather_ms_per_step": [m["all_gather_ms_per_step"] for m in legs["zero"]],
        "adam_alloc_bytes_per_rank": [m["adam_alloc_bytes"] for m in legs["zero"]],
        "opt_moment_bytes": z0["opt_moment_bytes"],
        "dense_adam_alloc_bytes_per_rank": [m["adam_alloc_bytes"] for m in legs["dense"]],
        "dense_opt_moment_bytes": d0["opt_moment_bytes"],
        "adam_share": z0["adam_alloc_bytes"] / max(1, d0["adam_alloc_bytes"]),
        "shared_card_tokens_per_s": ZERO_BATCH * ZERO_T / (step_ms["zero"] / 1e3),
        "throughput_note": "shared-card, not multi-GPU throughput: 4 gloo ranks on one "
                           "H100, collectives through host memory",
        "launches_per_rank": [m["launches"] for m in legs["zero"]], "launches_want": want,
        "launches_per_rank_per_step": {k: v / ZERO_STEPS for k, v in z0["launches"].items()
                                       if v},
        "attention_q_shapes": z0["q_shapes"], "local_attention_shape": list(local),
        "card": card})
    for leg, ms in legs.items():
        fails += [f"zero {leg}: launches {m['launches']}, want {want}"
                  for m in ms if m["launches"] != want]
        if any(m["losses"] != ms[0]["losses"] for m in ms[1:]):
            fails.append(f"zero {leg}: the ranks' losses differ")
        if ms[0]["q_shapes"] != [local]:
            fails.append(f"zero {leg}: K1 saw {ms[0]['q_shapes']}, want {[local]}")
        for m in ms:
            if abs(m["adam_alloc_bytes"] - m["opt_moment_bytes"]) > \
                    ZERO_BYTES_REL_TOL * m["opt_moment_bytes"]:
                fails.append(f"zero {leg}: Adam took {m['adam_alloc_bytes']} bytes, "
                             f"opt_moment_bytes {m['opt_moment_bytes']}")
    if not all(math.isfinite(v) for v in z0["losses"]) or \
            not z0["losses"][-1] < z0["losses"][0]:
        fails.append(f"zero: losses {z0['losses']}")
    if abs(z0["losses"][0] - d0["losses"][0]) > SP_LOSS_TOL:
        fails.append(f"zero: first loss {z0['losses'][0]} vs dense {d0['losses'][0]}")
    if not 0.2 <= z0["opt_moment_bytes"] / d0["opt_moment_bytes"] <= 0.3:
        fails.append("zero: the moments are not a quarter of the dense ones")
    return records, fails


def moe_ep_checks(ranks, card):
    """The moe_ep records (and the narrow fp32 legs') and the message of
    every check they fail."""
    records, fails = [], []
    for key, mesh_kw in MOE_NARROW_MESHES.items():
        rec, more = zm_parity_checks(
            [r[f"moe_{key}"] for r in ranks], f"moe_{key}_parity_fp32", card, mesh=mesh_kw,
            ranks=SP, model=MOE_NARROW, global_batch=MOE_NARROW_ROWS,
            seq=MOE_NARROW["block_size"],
            routing="one group of 1024 tokens spans the ranks; capacity binds")
        rec["leg_s"] = max(r[f"moe_{key}"]["leg_s"] for r in ranks)
        records.append(rec)
        fails += more
    ms = [r["moe_ep"] for r in ranks]
    m0 = ms[0]
    n = MOE_EP_STEPS
    want = expected(flash_fwd=n, flash_bwd_prep=n, flash_bwd_dq=n, flash_bwd_dkv=n)
    local = (MOE_EP_BATCH // MOE_EP_MESH["ep"], MOE_EP_T, 32, 128)
    step_s = sum(sum(m["seconds"]) for m in ms) / (SP * n)
    rel = abs(m0["losses"][0] - m0["one_process_loss"]) / abs(m0["one_process_loss"])
    records.append({
        "phase": "moe_ep_train_step", "main_path": True,
        "model": "mixtral-8x7b width, 1 layer", "mesh": MOE_EP_MESH, "ranks": SP,
        "backend": "gloo, one shared card", "global_batch": MOE_EP_BATCH, "seq": MOE_EP_T,
        "dtype": "bfloat16", "steps": n, "losses": m0["losses"],
        "one_process_first_loss": m0["one_process_loss"], "first_loss_rel_err": rel,
        "first_loss_tol": MOE_PLAIN_LOSS_REL_TOL, "step_ms": step_s * 1e3,
        "step_ms_per_rank": [sum(m["seconds"]) / n * 1e3 for m in ms],
        "all_to_all_calls_per_step": [m["all_to_all_calls_per_step"] for m in ms],
        "all_to_all_ms_per_step": [m["all_to_all_ms_per_step"] for m in ms],
        "local_experts": [m["local_experts"] for m in ms],
        "param_bytes_per_rank": [m["param_bytes"] for m in ms],
        "peak_allocated_bytes_per_rank": [m["peak_allocated_bytes"] for m in ms],
        "launches_per_rank": [m["launches"] for m in ms], "launches_want": want,
        "attention_q_shapes": m0["q_shapes"], "local_attention_shape": list(local),
        "shared_card_tokens_per_s": MOE_EP_BATCH * MOE_EP_T / step_s,
        "leg_s": max(m["leg_s"] for m in ms), "card": card})
    fails += [f"moe_ep: launches {m['launches']}, want {want}" for m in ms
              if m["launches"] != want]
    fails += [f"moe_ep: rank holds {m['local_experts']} experts, want 2" for m in ms
              if m["local_experts"] != 2]
    fails += [f"moe_ep: {m['all_to_all_calls_per_step']} all-to-alls per step, want 4"
              for m in ms if m["all_to_all_calls_per_step"] != 4]
    if m0["q_shapes"] != [local]:
        fails.append(f"moe_ep: K1 saw {m0['q_shapes']}, want {[local]}")
    if any(m["losses"] != m0["losses"] for m in ms[1:]):
        fails.append("moe_ep: the ranks' losses differ")
    if not all(math.isfinite(v) for v in m0["losses"]) or \
            not m0["losses"][-1] < m0["losses"][0]:
        fails.append(f"moe_ep: losses {m0['losses']}")
    if not rel <= MOE_PLAIN_LOSS_REL_TOL:
        fails.append(f"moe_ep: first loss {m0['losses'][0]} vs one process "
                     f"{m0['one_process_loss']}")
    return records, fails


def phase_zero_moe(card, ranks):
    """The zero and moe_ep slices' checks over what the SP ranks returned
    (phase_sp's spawn). Returns rank 0's zero and moe_ep launch counts and
    the legs' seconds."""
    records, fails = zero_checks(ranks, card)
    more_records, more = moe_ep_checks(ranks, card)
    for rec in records + more_records:
        emit(rec)
    check(not (fails + more), "; ".join(fails + more))
    seconds = {k: max(r["seconds"][k] for r in ranks) for k in ranks[0]["seconds"]}
    return ranks[0]["zero"]["zero"]["launches"], ranks[0]["moe_ep"]["launches"], seconds


def phase_moe_ep_kernels(fa, card):
    """K1, the prep pass and K2a/K2b against their plain versions at the
    shape moe_ep gives them, bf16 (zero's (4, 1024, 12, 64) is KERNEL_CASES'
    gpt2_main)."""
    i = len(KERNEL_CASES) + len(FWD_RING_CASES) + len(BWD_RING_CASES) + 1
    with preserved_counts():
        for fn in (fwd_case, prep_case, bwd_case):
            rec, fails = fn(fa, i, MOE_EP_KERNEL_CASE, torch.bfloat16)
            emit({**rec, "card": card})
            check(not fails, "; ".join(msg for _, msg in fails))
    torch.cuda.empty_cache()


def phase_zero_moe_times(fa, card):
    """K1, the prep pass, K2a and K2b at zero's local attention shape (4,
    1024, 12, 64) and moe_ep's (1, 4096, 32 heads, 8 KV, 128), bf16:
    kernel, plain version and SDPA times with their bounds (time lines,
    shape_of "zero" and "moe_ep"; SDPA takes K and V repeated to 32
    heads)."""
    dtype = torch.bfloat16
    for shape_of, (b, t, h, kv, hd) in (("zero", (4, ZERO_T, 12, 12, 64)),
                                        ("moe_ep", (1, MOE_EP_T, 32, 8, 128))):
        scale = 1.0 / math.sqrt(hd)
        q, k, v = make_qkv(b, t, h, kv, hd, dtype, seed=910)
        g = torch.Generator(device="cuda").manual_seed(911)
        do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
        with preserved_counts(), fused_switch(False):
            out, lse = fa.flash_fwd(q, k, v, scale=scale)
            delta = fa.flash_bwd_prep(out, do)
            fwd_ms = cuda_ms(lambda: fa.flash_fwd(q, k, v, scale=scale))
            prep_ms = cuda_ms(lambda: fa.flash_bwd_prep(out, do))
            dq_ms = cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, scale=scale))
            dkv_ms = cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale=scale))
        fwd_plain = cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, scale=scale), iters=3)
        prep_plain = cuda_ms(lambda: fa.flash_bwd_prep_plain(out, do), iters=3)
        bwd_plain = cuda_ms(lambda: fa.flash_bwd_plain(q, k, v, out, lse, do, scale=scale),
                            iters=3)
        kr, vr = (x.repeat_interleave(h // kv, dim=2) for x in (k, v))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, kr, vr))
        fwd_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        bwd_lib = cuda_ms(sdpa_backward(q, kr, vr, do))
        bwd_is = ("flash_bwd_plain (dq, dk and dv)", "SDPA backward (dq, dk and dv)")
        emit_times((("flash_fwd", fwd_ms, fwd_plain, "flash_fwd_plain", fwd_lib,
                     "SDPA forward"),
                    ("flash_bwd_prep", prep_ms, prep_plain, "flash_bwd_prep_plain (delta)",
                     None, "none: no one PyTorch call sums out * dO in float32"),
                    ("flash_bwd_dq", dq_ms, bwd_plain, bwd_is[0], bwd_lib, bwd_is[1]),
                    ("flash_bwd_dkv", dkv_ms, bwd_plain, bwd_is[0], bwd_lib, bwd_is[1])),
                   (b, t, h, kv, hd), dtype, shape_of, card)
        del q, k, v, do, out, lse, delta, kr, vr, qt, kt, vt
        torch.cuda.empty_cache()


# moe_sp: Mixtral-8x7B widths at 1 layer beside sequence parallelism: sp 2
# (the zigzag ring) x ep 2 (4 of 8 experts per rank), T 8192 (the preset's
# block) and global batch 2: each rank holds 1 row x 4096 columns, 4 whole
# routing groups of 1024, bf16. ~1.01 B parameters per rank: with fp32
# gradients and Adam moments ~21.5 GB per rank would not fit 4 ranks on the
# card, so the leg runs the forward, the backward and the gradient reduction
# (the trainer's step without AdamW: ~4 GB weights, ~4 GB gradients and the
# activations per rank). Zigzag K3 launches per layer 3 + (sp - 1), as many
# prep passes, K4a and K4b in the backward.
MOE_SP_MESH = dict(dp=1, ep=2, sp=2)
MOE_SP_T, MOE_SP_BATCH, MOE_SP_STEPS = 8192, 2, 1  # timed steps after the warm-up
MOE_SP_PER_STEP = 3 + (MOE_SP_MESH["sp"] - 1)
# the first loss against rank 0's one-process step (flash attention, K1/K2,
# on the same weights and rows), relative: the ring's and the one-process
# attention round differently in bf16, and at Mixtral width the loss sits at
# ~11.2, where swapping flash for plain attention alone moves it by 2.6e-4
# at T 4096 (moe_train_step's plain_loss_rel_err, 2.3e-5); read 5.5e-5 here
# (6.2e-4 absolute, where the sp path's absolute SP_LOSS_TOL is 5e-4 at
# GPT-2's 10.98). The routing itself is held exactly by the fp32 legs.
MOE_SP_LOSS_REL_TOL = 5e-4
MOE_SP_KERNEL_CASES = [
    # the zigzag hop (both half-chunks of the row, non-causal) and the
    # step-0 own block (causal) at (rows, T / sp / 2, 32 heads, 8 KV, 128)
    ("moe_sp_hop", 2, MOE_SP_T // 4, 32, 8, 128, False, None, None, 0),
    ("moe_sp_own", 1, MOE_SP_T // 4, 32, 8, 128, True, None, None, 0),
]
# the narrow fp32 MoE beside sp: 4 rows of 256 tokens, one routing group of
# 1024 that interleaves every rank's sp chunks, capacity binding
#: the kernels of the moe_sp path
MOE_SP_KERNELS = ("flash_lse_fwd", "flash_bwd_prep", "flash_lse_bwd_dq", "flash_lse_bwd_dkv")
MOE_NARROW_SP_MESHES = {"sp2_dp2_ring": (dict(dp=2, sp=2), "ring"),
                        "sp2_ep2_ring": (dict(dp=1, ep=2, sp=2), "ring"),
                        "sp2_tp2_ulysses": (dict(dp=1, tp=2, sp=2), "ulysses")}


def _moe_sp_grad_norm(params, mesh):
    from mingpt_distributed_tpu_torch.models import convert
    from mingpt_distributed_tpu_torch.training.optimizer import sharded_norm

    flat = convert.flatten(params)
    return sharded_norm([p.grad for p in flat.values()], list(flat), mesh)


def _moe_sp_main(device):
    """moe_sp: rank 0 first runs the one-process forward and backward of
    the 2 global rows (flash attention, K1/K2; the others wait); then every
    rank builds its slices one rank at a time (the whole 1-layer model is
    6.8 GB of fp32 weights) and runs a warm-up step and MOE_SP_STEPS counted
    ones: the trainer's loss terms, backward and gradient reduction, and
    the gradient norm over the model group. The all-to-alls' count and
    host seconds per step, the local experts, the q shapes K3 saw, peak
    memory, and the first loss and gradient norm against one process's."""
    from mingpt_distributed_tpu_torch.config import MeshConfig
    from mingpt_distributed_tpu_torch.models import gpt
    from mingpt_distributed_tpu_torch.ops import flash_attention as fa
    from mingpt_distributed_tpu_torch.parallel import distributed as D
    from mingpt_distributed_tpu_torch.parallel.mesh import Mesh
    from mingpt_distributed_tpu_torch.training.optimizer import _global_norm
    from mingpt_distributed_tpu_torch.training.trainer import all_reduce_grads, trainable

    t_start = time.perf_counter()
    mesh = Mesh(MeshConfig(**MOE_SP_MESH))
    cfg = mixtral_config("bfloat16", 1, MOE_SP_T, attention="ring")
    g = torch.Generator().manual_seed(37)
    tokens = torch.randint(0, cfg.vocab_size, (MOE_SP_BATCH, MOE_SP_T + 1), generator=g)
    x, y = tokens[:, :-1], tokens[:, 1:]
    one = None
    if mesh.rank == 0:
        params = trainable(gpt.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                                    device=device))
        _, loss = gpt.forward(params, x.to(device), dataclasses.replace(cfg, attention="flash"),
                              targets=y.to(device), return_logits=False)
        loss.backward()
        norm = _global_norm([p.grad for p in gpt._leaves(params)])
        one = {"loss": loss.item(), "grad_norm": norm.item()}
        del params, loss, norm
        torch.cuda.empty_cache()
    params = None
    for r in range(mesh.world_size):  # one rank at a time holds the whole model
        if r == mesh.rank:
            whole = gpt.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                             device=device)
            params = trainable(mesh.shard_params(whole))
            del whole
            torch.cuda.empty_cache()
        D.barrier()
    xr, yr = _ft_rows(x, mesh, device), _ft_rows(y, mesh, device)
    leaves = list(gpt._leaves(params))
    ex = {"calls": 0, "s": 0.0}
    real = {"forward": D._AllToAll.forward, "backward": D._AllToAll.backward}
    shapes = set()
    real_lse = fa.attention_with_lse

    def timed(fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                ex["s"] += time.perf_counter() - t0
                ex["calls"] += 1
        return staticmethod(run)

    def attention_with_lse(q, *args, **kwargs):
        shapes.add(tuple(q.shape))
        return real_lse(q, *args, **kwargs)

    def step():
        """The trainer's distributed step up to its update."""
        for p in leaves:
            p.grad = None
        count = D.all_reduce((yr != -1).sum().float(), mesh.batch_group).clamp_min(1)
        total, _, aux = gpt.loss_terms(params, xr, yr, cfg, mesh=mesh, with_aux=True)
        (total / count + aux).backward()
        loss = D.all_reduce(total.detach(), mesh.batch_group) / count + aux.detach()
        all_reduce_grads(params, mesh)
        return loss.item(), _moe_sp_grad_norm(params, mesh).item()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.attention_with_lse = attention_with_lse
    try:
        first = step()
        torch.cuda.synchronize()
        reset_counts()
        shapes.clear()
        for name, fn in real.items():
            setattr(D._AllToAll, name, timed(fn))
        losses, norms, seconds = [first[0]], [first[1]], []
        for _ in range(MOE_SP_STEPS):
            t0 = time.perf_counter()
            loss, norm = step()
            seconds.append(time.perf_counter() - t0)
            losses.append(loss)
            norms.append(norm)
        counts = read_counts()
    finally:
        for name, fn in real.items():
            setattr(D._AllToAll, name, staticmethod(fn))
        fa.attention_with_lse = real_lse
    out = {"losses": losses, "grad_norms": norms, "seconds": seconds, "launches": counts,
           "q_shapes": sorted(shapes), "one_process": one,
           "local_experts": int(params["blocks"]["w_e1"].shape[1]),
           "param_bytes": sum(p.numel() * p.element_size() for p in leaves),
           "all_to_all_calls_per_step": ex["calls"] / MOE_SP_STEPS,
           "all_to_all_ms_per_step": ex["s"] * 1e3 / MOE_SP_STEPS,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "leg_s": time.perf_counter() - t_start}
    del params, leaves, xr, yr
    torch.cuda.empty_cache()
    return out


def moe_sp_rank(device):
    """The MoE-beside-sp legs of an SP rank: the narrow fp32 legs at the
    three meshes, then moe_sp."""
    out = {}
    for key, (mesh_kw, attention) in MOE_NARROW_SP_MESHES.items():
        out[f"moe_{key}"] = _moe_narrow_parity(mesh_kw, device, attention)
    torch.cuda.empty_cache()
    out["moe_sp"] = _moe_sp_main(device)
    return out


def moe_sp_checks(ranks, card):
    """The moe_sp records (and the narrow fp32 legs') and the message of
    every check they fail."""
    records, fails = [], []
    for key, (mesh_kw, attention) in MOE_NARROW_SP_MESHES.items():
        rec, more = zm_parity_checks(
            [r[f"moe_{key}"] for r in ranks], f"moe_{key}_parity_fp32", card, mesh=mesh_kw,
            attention=attention, ranks=SP, model=MOE_NARROW, global_batch=MOE_NARROW_ROWS,
            seq=MOE_NARROW["block_size"],
            routing="one group of 1024 tokens interleaves every rank's sp chunks; "
                    "capacity binds")
        rec["leg_s"] = max(r[f"moe_{key}"]["leg_s"] for r in ranks)
        records.append(rec)
        fails += more
    ms = [r["moe_sp"] for r in ranks]
    m0, one = ms[0], ms[0]["one_process"]
    n = MOE_SP_STEPS
    want = expected(flash_lse_fwd=n * MOE_SP_PER_STEP, flash_bwd_prep=n * MOE_SP_PER_STEP,
                    flash_lse_bwd_dq=n * MOE_SP_PER_STEP, flash_lse_bwd_dkv=n * MOE_SP_PER_STEP)
    half = MOE_SP_T // MOE_SP_MESH["sp"] // 2
    shapes = [(1, half, 32, 128), (2, half, 32, 128)]
    step_s = sum(sum(m["seconds"]) for m in ms) / (SP * n)
    loss_err = abs(m0["losses"][0] - one["loss"]) / abs(one["loss"])
    norm_rel = abs(m0["grad_norms"][0] - one["grad_norm"]) / one["grad_norm"]
    records.append({
        "phase": "moe_sp_train_step", "main_path": True,
        "model": "mixtral-8x7b width, 1 layer", "mesh": MOE_SP_MESH, "ranks": SP,
        "attention": "ring (zigzag)", "backend": "gloo, one shared card",
        "global_batch": MOE_SP_BATCH, "seq": MOE_SP_T, "dtype": "bfloat16", "steps": n,
        "update": "none: forward, backward and the gradient reduction (no Adam moments)",
        "losses": m0["losses"], "grad_norms": m0["grad_norms"],
        "one_process_first_loss": one["loss"], "first_loss_rel_err": loss_err,
        "first_loss_rel_tol": MOE_SP_LOSS_REL_TOL, "one_process_grad_norm": one["grad_norm"],
        "grad_norm_rel_err": norm_rel, "grad_norm_rel_tol": SP_GRAD_NORM_REL_TOL,
        "step_ms": step_s * 1e3, "step_ms_note": "shared card, not multi-GPU throughput",
        "step_ms_per_rank": [sum(m["seconds"]) / n * 1e3 for m in ms],
        "all_to_all_calls_per_step": [m["all_to_all_calls_per_step"] for m in ms],
        "all_to_all_ms_per_step": [m["all_to_all_ms_per_step"] for m in ms],
        "local_experts": [m["local_experts"] for m in ms],
        "param_bytes_per_rank": [m["param_bytes"] for m in ms],
        "peak_allocated_bytes_per_rank": [m["peak_allocated_bytes"] for m in ms],
        "launches_per_rank": [m["launches"] for m in ms], "launches_want": want,
        "k3_q_shapes": m0["q_shapes"], "k3_q_shapes_want": shapes,
        "leg_s": max(m["leg_s"] for m in ms), "card": card})
    fails += [f"moe_sp: launches {m['launches']}, want {want}" for m in ms
              if m["launches"] != want]
    fails += [f"moe_sp: rank holds {m['local_experts']} experts, want 4" for m in ms
              if m["local_experts"] != 4]
    fails += [f"moe_sp: {m['all_to_all_calls_per_step']} all-to-alls per step, want 4"
              for m in ms if m["all_to_all_calls_per_step"] != 4]
    if [list(s) for s in m0["q_shapes"]] != [list(s) for s in shapes]:
        fails.append(f"moe_sp: K3 saw {m0['q_shapes']}, want {shapes}")
    if any(m["losses"] != m0["losses"] or m["grad_norms"] != m0["grad_norms"]
           for m in ms[1:]):
        fails.append("moe_sp: the ranks' losses or gradient norms differ")
    if not all(math.isfinite(v) for v in m0["losses"] + m0["grad_norms"]):
        fails.append(f"moe_sp: losses {m0['losses']}, norms {m0['grad_norms']}")
    if not loss_err <= MOE_SP_LOSS_REL_TOL:
        fails.append(f"moe_sp: first loss {m0['losses'][0]} vs one process {one['loss']}")
    if not norm_rel <= SP_GRAD_NORM_REL_TOL:
        fails.append(f"moe_sp: grad_norm {m0['grad_norms'][0]} vs one process "
                     f"{one['grad_norm']}")
    return records, fails


def phase_moe_sp(card, ranks):
    """The moe_sp slice's checks over what the SP ranks returned (phase_sp's
    spawn). Returns rank 0's moe_sp launch counts and the legs' seconds."""
    records, fails = moe_sp_checks(ranks, card)
    for rec in records:
        emit(rec)
    check(not fails, "; ".join(fails))
    seconds = {"moe_sp_train_step": max(r["moe_sp"]["leg_s"] for r in ranks),
               "moe_sp_narrow_fp32": sum(max(r[f"moe_{k}"]["leg_s"] for r in ranks)
                                         for k in MOE_NARROW_SP_MESHES)}
    return ranks[0]["moe_sp"]["launches"], seconds


def phase_moe_sp_kernels(fa, card):
    """K3 and K4a/K4b against their plain versions at the shapes moe_sp
    gives them (MOE_SP_KERNEL_CASES), and the prep pass at the hop's, bf16;
    returns each kernel's largest error over them."""
    i = len(LSE_CASES) + len(LSE_RING_CASES) + len(LSE_SP_TP_CASES)
    errs = dict.fromkeys(MOE_SP_KERNELS, 0.0)
    with preserved_counts():
        for j, case in enumerate(MOE_SP_KERNEL_CASES):
            rec, fails = lse_case(fa, i + j, case, torch.bfloat16)
            emit({**rec, "card": card})
            check(not fails, "; ".join(msg for _, msg in fails))
            for name, err in (("flash_lse_fwd", rec["max_abs_err"]),
                              ("flash_lse_bwd_dq", rec["dq_max_abs_err"]),
                              ("flash_lse_bwd_dkv", max(rec["dk_max_abs_err"],
                                                        rec["dv_max_abs_err"]))):
                errs[name] = max(errs[name], err)
        name, b, t, h, kv, hd, *_ = MOE_SP_KERNEL_CASES[0]
        rec, fails = prep_case(fa, i, (name, b, t, h, kv, hd, None, None), torch.bfloat16)
        emit({**rec, "card": card})
        check(not fails, "; ".join(msg for _, msg in fails))
        errs["flash_bwd_prep"] = max(rec["delta_max_abs_err"], rec["delta_dlse_max_abs_err"])
    torch.cuda.empty_cache()
    return errs


def phase_serve_moe_tp_parity(card, group):
    """serve_moe_parity's requests (fp32, 4 slots, chunks of 256, the prefix
    cache; capacity factor 4 so nothing drops) at Mixtral-8x7B width, 1
    layer, on the tp = 2 group (the router replicated, each rank F/2 of
    every expert and 4 of 8 KV heads) against the tp = 1 server in the
    same call: tokens equal, the largest logit difference, each rank's
    pool half, the launches on both ranks."""
    from mingpt_distributed_tpu_torch.serving import InferenceServer, Request

    cfg = mixtral_config("float32", 1, 1024, capacity_factor=4.0)
    params = mixtral_params(cfg)
    prompts, lengths = parity_prompts(cfg.vocab_size)
    new = PARITY_NEW

    def run(mesh, device):
        server = InferenceServer(params, cfg, n_slots=4, prefill_chunk=256,
                                 prefix_cache_mb=64, mesh=mesh, device=device)
        reset_counts()
        with logit_tap(server) as rows:
            handles, dt = timed(lambda: server.generate_batch(
                [Request(prompt=p, max_new_tokens=new) for p in prompts]))
        return server, handles, rows, read_counts(), dt

    one, h1, rows1, _, dt1 = run(None, "cuda")
    ref = [(h.tokens, torch.stack([rows1[(h.request_id, i)] for i in range(new)]))
           for h in h1]
    pool1, counts1 = one.engine.pool.nbytes, one.compile_counts()
    # a server is a reference cycle: collect it before the tp = 2 pool's
    # allocator reading, so no collection runs inside it
    del one
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    srv, h2, rows2, launches, dt2 = run(group.mesh, group.device)
    res = tie_rule(h2, ref, rows2, new)
    counts = srv.compile_counts()
    reports = tp_rank_checks("serve_moe_tp_parity", srv, cfg.kv_heads // TP_SERVE, pool1,
                             counts)
    equal = [a.tokens == b.tokens for a, b in zip(h1, h2)]
    rec = {"phase": "serve_moe_tp_parity", "model": "mixtral-8x7b width, 1 layer",
           "dtype": "float32", "tp": TP_SERVE, "backend": "gloo, one shared card",
           "slots": 4, "requests": 6, "prompt_lengths": [int(n) for n in lengths],
           "new_tokens": new, "experts": cfg.n_experts, "top_k": cfg.moe_top_k,
           "capacity_factor": cfg.moe_capacity_factor, "tokens_equal": equal, **res,
           "shapes": counts, "shapes_tp1": counts1, "pool_bytes_tp1": pool1,
           "pool_alloc_bytes_per_rank": [r["pool_alloc_bytes"] for r in reports],
           "kv_heads_per_rank": [r["kv_heads"] for r in reports],
           "launches": launches, "follower_launches": [r["launches"] for r in reports[1:]],
           "seconds_tp1": dt1, "seconds_tp2": dt2, "card": card}
    emit(rec)
    check(all(equal), f"serve_moe_tp_parity: tokens differ from tp = 1's: {equal}")
    check(counts == counts1, f"serve_moe_tp_parity: shapes {counts} != {counts1}")
    check(not any(launches.values()), f"serve_moe_tp_parity launched kernels: {launches}")
    del srv, rows2, rows1, params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 4f: pipeline parallelism (parallel/pipeline.py) and the sharded
# directory snapshot (training/checkpoint_sharded.py), in the SP ranks' spawn
# ---------------------------------------------------------------------------

# The main path: GPT-2 124M (12 layers, 768 wide, V 50257), T 1024, bf16, no
# remat, pp 2 x dp 2, GPipe, PP_MICRO microbatches of the rank's PP_BATCH /
# dp rows: each stage runs 6 layers per microbatch, so exactly
# PP_PER_STEP = 6 x 4 launches each of K1, the prep pass, K2a and K2b per
# rank per step. The first step's loss against the one-process step on the
# same weights and batch (rank 0, afterwards) within SP_LOSS_TOL, the sp main
# path's bf16 limit. Each rank holds its stage's 6 layers and every leaf the
# stages replicate (wte, wpe, the final norm): PP_MESH's rule, by the bytes.
PP_MESH = dict(pp=2, dp=2)
PP_MICRO = 4
PP_BATCH = 8
PP_T = 1024
PP_STEPS = 2  # after the warm-up step
PP_PER_STEP = 6 * PP_MICRO
# The same model at pp 4 (3 layers a stage), PP4_MICRO microbatches, under
# GPipe and 1F1B from the same weights: 3 x 8 = 24 launches of each kernel
# per rank per step, the first losses bit-equal, and the schedule's peak of
# live microbatch graphs pp - stage under 1F1B against all 8 under GPipe.
PP4_MESH = dict(pp=4, dp=1)
PP4_MICRO = 8
# fp32 legs at 4 layers, T 256, V 4096, PP_PARITY_BATCH rows, dropout off, against
# one process on the same weights and batch: losses and every gradient
# within 1e-5 relative, the parameters after the first update within 1e-5
# where |g| > 1e-6 (tests/test_torch_sharded_train.py's rule) and within
# FT_PARAM_ATOL everywhere; pp 2 x sp 2 runs the ring, so K3, K4a and K4b
# launch on the pipeline's path.
PP_PARITY_MESHES = {"pp2_dp2": dict(pp=2, dp=2), "pp4": dict(pp=4, dp=1),
                    "pp2_tp2": dict(pp=2, dp=1, tp=2), "pp2_sp2": dict(pp=2, dp=1, sp=2)}
PP_PARITY_LAYERS = 4
PP_PARITY_T = 256
PP_PARITY_VOCAB = 4096  # narrow, as the narrow MoE legs' (GPT-2's 768 wide)
PP_PARITY_BATCH = 4
PP_PARITY_REL_TOL = 1e-5
# ckpt_sharded: the fsdp x tp ranks' GPT-2 124M state after one step on
# CKPT_BATCH rows goes to a directory (each rank its slices) and to one file
# (gathered); the directory restores at pp 2 x dp 2 and in one process
# (restore_inference_params), every leaf bit-equal to the one-file snapshot.
CKPT_BATCH = 4


def _pp_config(n_layer=None, dtype="bfloat16", schedule="gpipe", micro=PP_MICRO,
               attention="flash", block_size=PP_T, vocab_size=50257):
    from mingpt_distributed_tpu_torch.config import GPTConfig

    dims = (dict(model_type="gpt2") if n_layer is None
            else dict(n_layer=n_layer, n_head=12, n_embd=768))
    return GPTConfig.make(vocab_size=vocab_size, block_size=block_size, attention=attention,
                          dtype=dtype, embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0,
                          pp_schedule=schedule, pp_microbatches=micro, **dims)


def pp_rule_bytes(full_shapes, pp):
    """The float32 bytes one pp rank should hold: a block leaf's 1/pp of
    its layers, every other leaf whole."""
    return sum(4 * math.prod(s) // (pp if path.startswith("blocks/") else 1)
               for path, s in full_shapes.items())


def _pp_steps(cfg, mesh, device, steps, seed=13, rows=PP_BATCH):
    """A warm-up step, then ``steps`` steps with the launch counts set to 0
    just before and read just after: losses, each step's wall ms and its
    schedule's exchange seconds, the peak of live graphs, the parameter
    bytes this rank holds and its peak memory; and the state."""
    from mingpt_distributed_tpu_torch.parallel import pipeline
    from mingpt_distributed_tpu_torch.training.trainer import make_train_step

    state = _ft_state(cfg, device, mesh)
    step = make_train_step(cfg, mesh=mesh)
    x, y = _ft_batch(seed, rows)
    x, y = x[:, :cfg.block_size], y[:, :cfg.block_size]
    batch = (_ft_rows(x, mesh, device), _ft_rows(y, mesh, device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(state, batch)["loss"].item()]  # warm-up
    reset_counts()
    seconds, exchange = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step(state, batch)["loss"].item())
        seconds.append(time.perf_counter() - t0)
        exchange.append(pipeline.LAST.exchange_s)
    counts = read_counts()
    out = {"losses": losses, "seconds": seconds, "exchange_s": exchange,
           "launches": counts, "live_peak": pipeline.LAST.live_peak,
           "sent_bytes_per_step": pipeline.LAST.sent_bytes,
           "param_bytes": sum(p.numel() * p.element_size() for p in state.optimizer.params),
           "param_bytes_by_rule": pp_rule_bytes(mesh.full_shapes, mesh.pp),
           "param_bytes_unsharded": sum(4 * math.prod(s) for s in mesh.full_shapes.values()),
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "stage": mesh.stage}
    return out, state, (x, y)


def _pp_one_process_loss(cfg, device, batch):
    """The first loss of the one-process step on the same weights and
    batch."""
    from mingpt_distributed_tpu_torch.training.trainer import make_train_step

    state = _ft_state(cfg, device)
    loss = make_train_step(cfg)(state, tuple(a.to(device) for a in batch))["loss"].item()
    del state
    torch.cuda.empty_cache()
    return loss


def _pp_main(device, rank):
    """pp_train_step on this rank, then (rank 0) the one-process step."""
    from mingpt_distributed_tpu_torch.config import MeshConfig
    from mingpt_distributed_tpu_torch.parallel.mesh import Mesh

    t0 = time.perf_counter()
    cfg = _pp_config()
    out, state, batch = _pp_steps(cfg, Mesh(MeshConfig(**PP_MESH)), device, PP_STEPS)
    del state
    torch.cuda.empty_cache()
    out["one_process_loss"] = _pp_one_process_loss(cfg, device, batch) if rank == 0 else None
    out["leg_s"] = time.perf_counter() - t0
    return out


def _pp_1f1b(device):
    """pp_1f1b_train_step: the same model at pp 4 under both schedules,
    from the same weights."""
    from mingpt_distributed_tpu_torch.config import MeshConfig
    from mingpt_distributed_tpu_torch.parallel.mesh import Mesh

    t0 = time.perf_counter()
    mesh = Mesh(MeshConfig(**PP4_MESH))
    out = {}
    for schedule in ("gpipe", "1f1b"):
        cfg = _pp_config(schedule=schedule, micro=PP4_MICRO)
        out[schedule], state, _ = _pp_steps(cfg, mesh, device, 1)
        del state
        torch.cuda.empty_cache()
    out["leg_s"] = time.perf_counter() - t0
    return out


def _pp_parity(device):
    """pp_parity_fp32: each mesh's fp32 leg; the launches of the pp 2 x sp 2
    leg's pipeline steps (its one-process reference runs K1 and K2, never
    K3 or K4)."""
    from mingpt_distributed_tpu_torch.config import MeshConfig
    from mingpt_distributed_tpu_torch.parallel.mesh import Mesh

    out = {}
    x, y = _ft_batch(15, PP_PARITY_BATCH)
    batch = (x[:, :PP_PARITY_T] % PP_PARITY_VOCAB, y[:, :PP_PARITY_T] % PP_PARITY_VOCAB)
    for key, mesh_kw in PP_PARITY_MESHES.items():
        t0 = time.perf_counter()
        cfg = _pp_config(PP_PARITY_LAYERS, "float32", micro=0,
                         attention="ring" if "sp" in key else "flash",
                         block_size=PP_PARITY_T, vocab_size=PP_PARITY_VOCAB)
        reset_counts()
        out[key] = _ft_parity(Mesh(MeshConfig(**mesh_kw)), device, cfg, batch)
        out[key]["launches"] = read_counts()
        out[key]["leg_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return out


def _ckpt_state_bytes(state):
    opt = state.optimizer
    moments = opt.adam_state()
    return (sum(p.numel() * p.element_size() for p in opt.params)
            + sum(t.numel() * t.element_size()
                  for d in (moments["mu"], moments["nu"]) for t in d.values()))


def _ckpt_whole(mesh, state):
    """The whole parameters and Adam moments by name, in host memory (every
    rank joins the gathers)."""
    from mingpt_distributed_tpu_torch.models import convert

    full = lambda n, t: mesh.gather_full(n, t).cpu()  # noqa: E731
    out = {f"params/{n}": full(n, p) for n, p in convert.flatten(state.params).items()}
    adam = state.optimizer.adam_state()
    for g, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        out.update({f"{key}/{n}": full(n, t) for n, t in adam[g].items()})
    return out


def _ckpt_sharded(device, rank):
    """ckpt_sharded on this rank (see CKPT_BATCH's comment). Rank 0 returns
    the comparisons; every rank its held bytes and seconds."""
    import types

    from mingpt_distributed_tpu_torch.config import MeshConfig
    from mingpt_distributed_tpu_torch.models import convert
    from mingpt_distributed_tpu_torch.parallel import distributed as D
    from mingpt_distributed_tpu_torch.parallel.mesh import Mesh
    from mingpt_distributed_tpu_torch.training import checkpoint as ckpt_lib
    from mingpt_distributed_tpu_torch.training import checkpoint_sharded as cs
    from mingpt_distributed_tpu_torch.training.trainer import GPTTrainer, make_train_step

    t_leg = time.perf_counter()
    tmp = os.path.join(tempfile.gettempdir(), "chip_smoke_ckpt")
    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    D.barrier()
    d, one = os.path.join(tmp, "state"), os.path.join(tmp, "state.pt")
    cfg = _ft_config(None, "bfloat16")
    mesh = Mesh(MeshConfig(**FT_MESH))
    state = _ft_state(cfg, device, mesh, seed=3)
    x, y = _ft_batch(16, CKPT_BATCH)
    make_train_step(cfg, mesh=mesh)(state, (_ft_rows(x[:, :256], mesh, device),
                                            _ft_rows(y[:, :256], mesh, device)))
    stage_s = {"state_and_step": time.perf_counter() - t_leg}
    held = _ckpt_state_bytes(state)
    opt = state.optimizer
    by_id = {id(t): n for n, t in zip(opt.names, opt.shards)}
    opt_order = [by_id[id(t)] for grp in opt.opt.param_groups for t in grp["params"]]
    # the one-file save under msgpack_gather_limit_mb=0: the trainer's guard
    limited = types.SimpleNamespace(state=state, mesh=mesh, sharded=True,
                                    config=types.SimpleNamespace(msgpack_gather_limit_mb=0))
    try:
        GPTTrainer._check_gather_limit(limited)
        refusal = None
    except RuntimeError as e:
        refusal = str(e)
    meta = {"step": 1, "epoch": 0, "data_state": {}, "generator": [], "config": {}}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs.save(d, state.params, state.optimizer, mesh, meta)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    saved = _ckpt_whole(mesh, state)
    stage_s["gather"] = time.perf_counter() - t0
    # the canonical state dict of the whole moments already gathered
    opt_sd = state.optimizer.opt.state_dict()
    for i, n in zip([i for grp in opt_sd["param_groups"] for i in grp["params"]], opt_order):
        opt_sd["state"][i] = dict(opt_sd["state"][i], exp_avg=saved[f"exp_avg/{n}"],
                                  exp_avg_sq=saved[f"exp_avg_sq/{n}"])
    del state
    torch.cuda.empty_cache()
    # rank 0 writes the one-file snapshot on a thread while every rank
    # restores the directory (rank 0 reads the file only after both)
    one_file = {"params": convert.unflatten(
        {k[len("params/"):]: v for k, v in saved.items() if k.startswith("params/")}),
        "opt_state": opt_sd, **dict(meta, generator=torch.Generator().get_state())}
    writer = (Background(lambda: timed(lambda: ckpt_lib.save_snapshot(one, one_file))[1])
              if rank == 0 else None)
    # restore at pp 2 x dp 2 into a state of other weights
    pmesh = Mesh(MeshConfig(**PP_MESH))
    back = _ft_state(cfg, device, pmesh, seed=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_meta = cs.restore(d, back.params, back.optimizer, pmesh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = _ckpt_whole(pmesh, back)
    stage_s["gather_restored"] = time.perf_counter() - t0
    del back
    torch.cuda.empty_cache()
    one_file_save_s = writer.result() if writer is not None else None
    out = {"held_bytes": held, "save_s": save_s, "restore_s": restore_s,
           "one_file_save_s": one_file_save_s, "refusal": refusal,
           "restored_step": got_meta["step"] if got_meta else None}
    t0 = time.perf_counter()
    if rank == 0:
        snap = ckpt_lib.load_snapshot(one)
        want = {f"params/{n}": t for n, t in convert.flatten(snap["params"]).items()}
        for i, n in zip([i for g in snap["opt_state"]["param_groups"] for i in g["params"]],
                        opt_order):
            st = snap["opt_state"]["state"][i]
            want[f"exp_avg/{n}"], want[f"exp_avg_sq/{n}"] = st["exp_avg"], st["exp_avg_sq"]
        t0 = time.perf_counter()
        inference = ckpt_lib.restore_inference_params(d, cfg, device="cpu")
        one_process_s = time.perf_counter() - t0
        unequal = lambda got: sorted(k for k, w in want.items()  # noqa: E731
                                     if k in got and not torch.equal(got[k], w))
        out.update(
            leaves=len(want), saved_unequal=unequal(saved),
            saved_missing=sorted(set(want) - set(saved)),
            restored_unequal=unequal(restored),
            restored_missing=sorted(set(want) - set(restored)),
            inference_unequal=unequal({f"params/{n}": t for n, t in
                                       convert.flatten(inference.params).items()}),
            inference_step=inference.step, one_process_restore_s=one_process_s,
            written=cs.written_bytes(d),
            whole_bytes=sum(w.numel() * w.element_size() for w in want.values()))
        shutil.rmtree(tmp, ignore_errors=True)
    stage_s["compare"] = time.perf_counter() - t0
    out["stage_s"] = stage_s
    out["leg_s"] = time.perf_counter() - t_leg
    return out


def pp_rank(device, rank):
    """The pipeline and checkpoint legs of an SP rank, with their seconds."""
    out = {"main": _pp_main(device, rank)}
    torch.cuda.empty_cache()
    out["1f1b"] = _pp_1f1b(device)
    out["parity"] = _pp_parity(device)
    out["ckpt"] = _ckpt_sharded(device, rank)
    torch.cuda.empty_cache()
    return out


def pp_checks(ranks, card):
    """The pipeline and checkpoint records and the message of every check
    they fail."""
    records, fails = [], []
    main = [r["pp"]["main"] for r in ranks]
    m0 = main[0]
    want = expected(flash_fwd=PP_PER_STEP * PP_STEPS, flash_bwd_prep=PP_PER_STEP * PP_STEPS,
                    flash_bwd_dq=PP_PER_STEP * PP_STEPS, flash_bwd_dkv=PP_PER_STEP * PP_STEPS)
    step_s = sum(sum(m["seconds"]) for m in main) / (SP * PP_STEPS)
    records.append({
        "phase": "pp_train_step", "main_path": True, "model": "gpt2 124M",
        "mesh": PP_MESH, "schedule": "gpipe", "microbatches": PP_MICRO, "ranks": SP,
        "backend": "gloo, one shared card", "global_batch": PP_BATCH, "seq": PP_T,
        "dtype": "bfloat16", "steps": PP_STEPS, "losses": m0["losses"],
        "one_process_first_loss": m0["one_process_loss"], "loss_tol": SP_LOSS_TOL,
        "step_ms": step_s * 1e3,
        "step_ms_per_rank": [sum(m["seconds"]) / PP_STEPS * 1e3 for m in main],
        "exchange_ms_per_step_per_rank": [sum(m["exchange_s"]) / PP_STEPS * 1e3
                                          for m in main],
        "sent_bytes_per_step_per_rank": [m["sent_bytes_per_step"] for m in main],
        "shared_card_tokens_per_s": PP_BATCH * PP_T / step_s,
        "throughput_note": "shared-card, not multi-GPU throughput: 4 gloo ranks on one "
                           "H100, stage activations through host memory",
        "launches_per_rank": [m["launches"] for m in main], "launches_want": want,
        "param_bytes_per_rank": [m["param_bytes"] for m in main],
        "param_bytes_by_rule": m0["param_bytes_by_rule"],
        "param_bytes_unsharded": m0["param_bytes_unsharded"],
        "stages": [m["stage"] for m in main],
        "peak_allocated_bytes_per_rank": [m["peak_allocated_bytes"] for m in main],
        "leg_s": max(m["leg_s"] for m in main), "card": card})
    fails += [f"pp launches {m['launches']}, want {want}" for m in main
              if m["launches"] != want]
    if any(m["losses"] != m0["losses"] for m in main[1:]):
        fails.append("pp: the ranks' losses differ")
    if not all(math.isfinite(v) for v in m0["losses"]):
        fails.append(f"pp: losses {m0['losses']}")
    if not abs(m0["losses"][0] - m0["one_process_loss"]) <= SP_LOSS_TOL:
        fails.append(f"pp: first loss {m0['losses'][0]} vs one process "
                     f"{m0['one_process_loss']}")
    fails += [f"pp: a rank holds {m['param_bytes']} parameter bytes, want "
              f"{m['param_bytes_by_rule']}" for m in main
              if m["param_bytes"] != m["param_bytes_by_rule"]]

    g = [r["pp"]["1f1b"] for r in ranks]
    want4 = expected(flash_fwd=24, flash_bwd_prep=24, flash_bwd_dq=24, flash_bwd_dkv=24)
    rec = {"phase": "pp_1f1b_train_step", "model": "gpt2 124M", "mesh": PP4_MESH,
           "microbatches": PP4_MICRO, "ranks": SP, "global_batch": PP_BATCH, "seq": PP_T,
           "dtype": "bfloat16", "launches_want": want4,
           "leg_s": max(x["leg_s"] for x in g), "card": card}
    for schedule in ("gpipe", "1f1b"):
        runs = [x[schedule] for x in g]
        rec[schedule] = {
            "losses": runs[0]["losses"], "stages": [x["stage"] for x in runs],
            "live_peak_per_rank": [x["live_peak"] for x in runs],
            "peak_allocated_bytes_per_rank": [x["peak_allocated_bytes"] for x in runs],
            "step_ms_per_rank": [x["seconds"][0] * 1e3 for x in runs],
            "exchange_ms_per_rank": [x["exchange_s"][0] * 1e3 for x in runs],
            "launches_per_rank": [x["launches"] for x in runs]}
        fails += [f"pp4 {schedule} launches {x['launches']}, want {want4}" for x in runs
                  if x["launches"] != want4]
        peak_want = [PP4_MICRO if schedule == "gpipe" else PP4_MESH["pp"] - x["stage"]
                     for x in runs]
        if [x["live_peak"] for x in runs] != peak_want:
            fails.append(f"pp4 {schedule}: live graphs {[x['live_peak'] for x in runs]}, "
                         f"want {peak_want}")
    if g[0]["gpipe"]["losses"][0] != g[0]["1f1b"]["losses"][0]:
        fails.append(f"pp4: first losses differ: gpipe {g[0]['gpipe']['losses'][0]}, "
                     f"1f1b {g[0]['1f1b']['losses'][0]}")
    records.append(rec)

    for key, mesh_kw in PP_PARITY_MESHES.items():
        pars = [r["pp"]["parity"][key] for r in ranks]
        rec, more = parity_checks(pars, f"pp_parity_fp32_{key}", card,
                                  (PP_PARITY_REL_TOL, PP_PARITY_REL_TOL), mesh=mesh_kw,
                                  ranks=SP, layers=PP_PARITY_LAYERS,
                                  global_batch=PP_PARITY_BATCH, seq=PP_PARITY_T,
                                  launches=pars[0]["launches"],
                                  leg_s=max(p["leg_s"] for p in pars))
        rec["param_steady_atol"] = PP_PARITY_REL_TOL
        if not pars[0]["param_max_abs_err_steady"] <= PP_PARITY_REL_TOL:
            more.append(f"pp {key}: post-update params where |g| > {FT_STEADY_GRAD}: "
                        f"{pars[0]['param_max_abs_err_steady']}")
        if "sp" in key and not all(pars[0]["launches"][k] > 0 for k in (
                "flash_lse_fwd", "flash_lse_bwd_dq", "flash_lse_bwd_dkv")):
            more.append(f"pp {key}: K3/K4 did not launch: {pars[0]['launches']}")
        records.append(rec)
        fails += more

    ck = [r["pp"]["ckpt"] for r in ranks]
    c0 = ck[0]
    files = {f"__{i}_0.distcp": ck[i]["held_bytes"] for i in range(SP)}
    records.append({
        "phase": "ckpt_sharded", "model": "gpt2 124M", "saved_at": FT_MESH,
        "restored_at": [PP_MESH, "one process (restore_inference_params)"],
        "leaves": c0["leaves"], "whole_bytes": c0["whole_bytes"],
        "written_bytes_per_rank": [c0["written"].get(f, 0) for f in files],
        "held_bytes_per_rank": [x["held_bytes"] for x in ck],
        "save_s_per_rank": [x["save_s"] for x in ck],
        "restore_s_per_rank": [x["restore_s"] for x in ck],
        "one_file_save_s": c0["one_file_save_s"],
        "one_process_restore_s": c0["one_process_restore_s"],
        "one_file_refusal": c0["refusal"], "stage_s_rank0": c0["stage_s"],
        "leg_s": max(x["leg_s"] for x in ck),
        "card": card})
    if not c0["refusal"] or "sharded directory backend" not in c0["refusal"]:
        fails.append(f"ckpt: the one-file save under the limit did not refuse: "
                     f"{c0['refusal']}")
    for what in ("saved", "restored"):
        if c0[f"{what}_unequal"] or c0[f"{what}_missing"]:
            fails.append(f"ckpt: {what} leaves differ from the one-file snapshot: "
                         f"{c0[f'{what}_unequal'][:4]} missing {c0[f'{what}_missing'][:4]}")
    if c0["inference_unequal"] or c0["inference_step"] != 1:
        fails.append(f"ckpt: restore_inference_params differs: {c0['inference_unequal'][:4]}")
    if any(x["restored_step"] != 1 for x in ck):
        fails.append("ckpt: a rank restored no snapshot")
    if sorted(c0["written"]) != sorted(files) or \
            sum(c0["written"].values()) != c0["whole_bytes"]:
        fails.append(f"ckpt: written {c0['written']} against the whole "
                     f"{c0['whole_bytes']} bytes")
    fails += [f"ckpt: {f} holds {c0['written'].get(f)} bytes, more than its rank's "
              f"{held}" for f, held in files.items() if c0["written"].get(f, 0) > held]
    return records, fails


def phase_pp(card, ranks):
    """The pipeline and checkpoint slices' checks over what the SP ranks
    returned (phase_sp's spawn). Returns rank 0's main-path and pp 4 launch
    counts and the legs' seconds."""
    records, fails = pp_checks(ranks, card)
    for rec in records:
        emit(rec)
    check(not fails, "; ".join(fails))
    seconds = {"pp_train_step": max(r["pp"]["main"]["leg_s"] for r in ranks),
               "pp_1f1b_train_step": max(r["pp"]["1f1b"]["leg_s"] for r in ranks),
               "pp_parity_fp32": sum(max(r["pp"]["parity"][k]["leg_s"] for r in ranks)
                                     for k in PP_PARITY_MESHES),
               "ckpt_sharded": max(r["pp"]["ckpt"]["leg_s"] for r in ranks)}
    return (ranks[0]["pp"]["main"]["launches"], ranks[0]["pp"]["1f1b"]["1f1b"]["launches"],
            seconds)


# The time this slice's phases (the float16 phase's parts: SASS and
# ptxas, generation, the train steps, the kernel checks) may take
# together, and the whole smoke, in seconds of the command (a run is
# allowed 1200 s; recent runs read 747.2-1163.6 s by host). The earlier
# slices' phases are reported beside.
ADDED_PHASES_BUDGET_S = 60.0
SMOKE_BUDGET_S = 1050.0


def budget_record(added_seconds, smoke_seconds, earlier_seconds=None):
    """The budget line: each added phase's seconds, their total and the
    whole smoke's, each against its budget, and the previous slice's phases
    (``earlier_seconds``; reported; a slow host is not a failed check)."""
    total = sum(added_seconds.values())
    return {"phase": "smoke_budget", **{f"{k}_s": v for k, v in added_seconds.items()},
            "added_total_s": total, "added_budget_s": ADDED_PHASES_BUDGET_S,
            "added_within_budget": total <= ADDED_PHASES_BUDGET_S,
            "earlier_slice_s": earlier_seconds or {},
            "smoke_s": smoke_seconds, "smoke_budget_s": SMOKE_BUDGET_S,
            "smoke_within_budget": smoke_seconds <= SMOKE_BUDGET_S}


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
    returns the rows of the kernels line (training shape) by kernel name:
    bf16's under the kernel's, float16's under the name with "_f16"."""
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
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
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
        elif dtype == torch.float16:
            rows.update({f"{n}_f16": r for n, r in got.items()})
        del q, k, v, do, out, lse, delta, dq_acc, dq_zero
        torch.cuda.empty_cache()
    emit({"phase": "memory", "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
          "card": card})
    return rows


def sdpa_with_lse(q, k, v):
    """The library yardstick of K3: one PyTorch call computing the
    non-causal attention and its log-sum-exp (flash for bf16 and fp16, the
    memory-efficient kernel for fp32, which the flash one does not take)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.dtype in (torch.bfloat16, torch.float16):
        return lambda: torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, False)
    return lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
        qt, kt, vt, None, True, 0.0, False)


def phase_lse_times(fa, card):
    """K3, K4a and K4b at the sp main path's zigzag hop shape (batch-stacked,
    non-causal): kernel, plain version and library times, bounds; returns
    the kernels line's rows (bf16's by kernel name, float16's under the
    name with "_f16")."""
    name, b, t, h, kv, hd, causal, _, _, _ = LSE_CASES[0]
    return _lse_times(fa, card, name, (b, t, h, kv, hd), causal,
                      (torch.bfloat16, torch.float32, torch.float16))


def phase_sp_tp_times(fa, card):
    """K3, K4a and K4b at the sp x tp main path's local hop shape (the
    batch-stacked hop of SP_BATCH rows, half-chunks of SP_T / sp / 2, 6 of
    12 heads; non-causal), bf16 (time lines, shape_of "sp_tp_hop")."""
    b, c, h = SP_BATCH, SP_T // SP_TP_MESH["sp"], 12 // SP_TP_MESH["tp"]
    return _lse_times(fa, card, "sp_tp_hop", (2 * b, c // 2, h, h, 64), False,
                      (torch.bfloat16,))


def _lse_times(fa, card, name, shape, causal, dtypes):
    b, t, h, kv, hd = shape
    scale = 1.0 / math.sqrt(hd)
    rows = {}
    for dtype in dtypes:
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
        elif dtype == torch.float16:
            rows.update({f"{n}_f16": r for n, r in got.items()})
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
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)", line)
        if m and kernel:
            counts[kernel][m.group(1)] = counts[kernel].get(m.group(1), 0) + 1
    return counts


# The libraries whose SASS the smoke reads: cuobjdump runs on the host, one
# process each, all at once, while the kernel checks use the card
SASS_LIBRARIES = ("flash_fwd", "flash_bwd", "flash_fwd_f16", "flash_bwd_f16", "exp_exp2")


def sass_opcodes_all(names=SASS_LIBRARIES):
    """sass_opcodes of each library in ``names``, read concurrently."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {n: pool.submit(sass_opcodes, n) for n in names}
        return {n: f.result() for n, f in futures.items()}


def exp_sass(card, counts):
    """Each K6 kernel's SASS opcodes (``counts``, sass_opcodes of
    exp_exp2), counted: MUFU.EX2 against the FP32 and other instructions
    around it."""
    ops = {"ILi0E": "exp", "ILi1E": "exp2", "ILi2E": "exp2*log2e"}
    for kernel, c in counts.items():
        op = next((v for k, v in ops.items() if k in kernel), None)
        emit({"phase": "exp_sass", "kernel": kernel, "op": op, "mufu_ex2": c.get("MUFU.EX2", 0),
              "opcodes": dict(sorted(c.items())), "card": card})
    check(len(counts) == 3 and all(c.get("MUFU.EX2", 0) > 0 for c in counts.values()),
          f"exp_exp2 SASS: {len(counts)} kernels, {counts}")


# The bf16 forward's instantiations: 7 head widths (16, 32, 64, 80, 96, 128,
# 256) x (K1, K3) and the prototype tool's 4 (16 to 128) x K5 fwd
FWD_BF16_KERNELS = 2 * 7 + 4
# The bf16 backward's TMA + wgmma instantiations, by template: 7 head widths
# x (K2a, K4a) and 4 x K5 dq; 7 x (K2b, K4b, K2c) and 4 x K5 dkv
BWD_BF16_KERNELS = {"flash_dq_bf16_kernel": 2 * 7 + 4, "flash_dkv_bf16_kernel": 3 * 7 + 4}


def _opcode_total(c, prefix):
    return sum(n for op, n in c.items() if op.startswith(prefix))


def _sass_record(phase, kernel, c, card):
    return {"phase": phase, "kernel": kernel, "hgmma": _opcode_total(c, "HGMMA"),
            "utmaldg": _opcode_total(c, "UTMALDG"), "hmma": _opcode_total(c, "HMMA"),
            "mufu_ex2": c.get("MUFU.EX2", 0), "instructions": sum(c.values()),
            "card": card}


def fwd_sass(card, counts):
    """The flash_fwd library's kernels, counted by their SASS (``counts``,
    sass_opcodes of flash_fwd): every bf16 instantiation must issue
    warpgroup products (HGMMA) and TMA tile loads (UTMALDG) and no mma.sync
    (HMMA); the fp32 kernels issue neither."""
    bf16 = {}
    for kernel, c in counts.items():
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


def bwd_sass(card, counts):
    """The flash_bwd library's kernels, counted by their SASS (``counts``,
    sass_opcodes of flash_bwd; one line each); fails unless every bf16 dq
    and dk/dv instantiation, K2c's among them, issues HGMMA and UTMALDG and
    no HMMA (bwd_sass_check)."""
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
    """ptxas's resources per flash_fwd (or flash_fwd_f16) kernel
    (ptxas_rows); the 16-bit kernels' dynamic shared memory is
    Tiles<HD>::kSmem of flash_fwd.cu (Q of
    128 rows, two stages of K and V of 128 keys, 64 at hd 256, six
    barriers, 1024 bytes of alignment slack)."""
    rows = ptxas_rows(log)
    for r in rows:
        hd = re.search(r"ILi(\d+)E", r["kernel"])
        if re.search(r"flash_fwd_b?f16_kernel", r["kernel"]) and hd:
            hd = int(hd.group(1))
            keys = 64 if hd > 128 else 128
            r["dynamic_smem_bytes"] = 256 * hd + 8 * keys * hd + 8 * 6 + 1024
        emit({"phase": "fwd_ptxas", **r})
    return rows


def _dkv_fused(kernel):
    """Whether a mangled flash_dkv_*_kernel name is a kFused (K2c)
    instantiation: its fourth template argument, after HD, kLse, kNat."""
    m = re.search(r"ILi\d+ELb[01]ELb[01]ELb([01])E", kernel)
    return bool(m and m.group(1) == "1")


def box_cols(hd):
    """flash_common.cuh's box_cols: the columns of one TMA box of a bf16
    head (64, or 32 or 16 where hd is no multiple of 64)."""
    return 64 if hd % 64 == 0 else 32 if hd % 32 == 0 else 16


def bwd_dynamic_smem(kernel):
    """The dynamic shared memory flash_bwd.cu's launch gives ``kernel`` (a
    mangled name; the bf16 and fp16 kernels alike), or None:
    DqTiles<HD>::kSmem (Q and dO of 128 rows, two
    stages of K and V tiles of 64 keys, 32 at hd 256),
    DkvTiles<HD, kFused>::kSmem (K and V of 128 keys, 64 at hd 256, two
    stages of 64-row Q and dO tiles with their lse and delta; K2c also each
    consumer warpgroup's 64 x 64 16-bit dS^T tile and, below hd 256, the dq
    exchange: 2 warpgroups x 2 parities x 128 threads x a float4 for each
    of box_cols(hd) / 16 column groups), each with six barriers and 1024
    bytes of alignment slack; the fp32 kernels' padded tiles of 64 rows (32
    at hd 256); the prep kernel none."""
    m = re.search(r"ILi(\d+)E", kernel)
    if not m:
        return None
    hd = int(m.group(1))
    if re.search(r"flash_dq_b?f16_kernel", kernel):
        keys = 32 if hd > 128 else 64
        return 512 * hd + 8 * keys * hd + 8 * 6 + 1024
    if re.search(r"flash_dkv_b?f16_kernel", kernel):
        keys = 64 if hd > 128 else 128
        exchange = 0 if hd > 128 else 2 * 2 * 128 * 16 * box_cols(hd) // 16
        ds = 2 * 64 * 64 * 2 + exchange if _dkv_fused(kernel) else 0
        return 4 * keys * hd + 512 * hd + 2 * 2 * 64 * 4 + ds + 8 * 6 + 1024
    rows = 32 if hd > 128 else 64
    if "flash_dq_f32_kernel" in kernel:
        return (4 * rows * (hd + 4) + rows * (rows + 4)) * 4
    if "flash_dkv_f32_kernel" in kernel:
        return (4 * rows * (hd + 4) + 2 * rows * (rows + 4) + 2 * rows) * 4
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
        m = re.search(r"flash_dkv_b?f16_kernelILi(\d+)ELb0ELb0ELb([01])E", r["kernel"])
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


def instance_errors(name, records):
    """``name``'s largest error at each head width its checks ran (the
    ring cases: every instance and the padded 48 and 8), bf16 and fp32:
    {hd: {dtype: error}}, from ``records``, each check phase's records by
    (case name, dtype) ("fwd", "prep", "bwd", "fused", "lse")."""
    def grads(*names):
        return lambda rec: max(rec[f"{g}_max_abs_err"] for g in names)

    fwd_cases = KERNEL_CASES + FWD_RING_CASES
    bwd_cases = KERNEL_CASES + BWD_RING_CASES
    lse_cases = LSE_CASES + LSE_RING_CASES + LSE_SP_TP_CASES + LSE_WIDTH_CASES
    phase, cases, err = {
        "flash_fwd": ("fwd", fwd_cases, lambda e: e),
        "flash_bwd_prep": ("prep", bwd_cases, lambda r: r["delta_max_abs_err"]),
        "flash_bwd_dq": ("bwd", bwd_cases, grads("dq")),
        "flash_bwd_dkv": ("bwd", bwd_cases, grads("dk", "dv")),
        "flash_bwd_fused": ("fused", bwd_cases, grads("dq", "dk", "dv")),
        "flash_lse_fwd": ("lse", lse_cases, lambda r: r["max_abs_err"]),
        "flash_lse_bwd_dq": ("lse", lse_cases, grads("dq")),
        "flash_lse_bwd_dkv": ("lse", lse_cases, grads("dk", "dv")),
    }[name]
    out = {}
    for case in cases:
        for dtype in (torch.bfloat16, torch.float32):
            rec = records[phase].get((case[0], dtype))
            if rec is not None:
                slot = out.setdefault(case[5], {})
                dt = str(dtype).replace("torch.", "")
                slot[dt] = max(slot.get(dt, 0.0), err(rec))
    return dict(sorted(out.items()))


# The kernels whose line in the kernels record lists every instance's check
# and the head-width steps' launches and times
INSTANCE_KERNELS = ("flash_fwd", "flash_bwd_prep", "flash_bwd_dq", "flash_bwd_dkv",
                    "flash_bwd_fused", "flash_lse_fwd", "flash_lse_bwd_dq", "flash_lse_bwd_dkv")


#: every worker process the process-fleet phases spawned (``timed_spawns``),
#: SIGKILLed on the way out if a failed check left one running, once the
#: threads still spawning (``BACKGROUND``) are done
WORKERS = []
BACKGROUND = []


def main() -> int:
    try:
        return _main()
    finally:
        for pending in BACKGROUND:
            pending._thread.join()
        for backend in WORKERS:
            if backend.alive():
                backend.sigkill()
                backend.wait(timeout_s=30.0)


def _main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    from mingpt_distributed_tpu_torch.models.api import GPT
    from mingpt_distributed_tpu_torch.ops import _build
    from mingpt_distributed_tpu_torch.ops import flash_attention as fa
    from mingpt_distributed_tpu_torch.tools import exp_exp2 as ex
    from mingpt_distributed_tpu_torch.tools import proto_nh_kernel as nh

    smoke_t0 = time.perf_counter()
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
    added_seconds, earlier_seconds = {}, {}
    # the libraries' SASS is read on the host while the kernel checks run
    sass_pending = Background(sass_opcodes_all)
    fwd_rows = fwd_ptxas(logs["flash_fwd"])
    bwd_rows, spill_fails = bwd_ptxas(logs["flash_bwd"])
    check(not spill_fails, "; ".join(spill_fails))
    # the float16 instances' builds: ptxas beside their bf16 twins
    f16_rows = fwd_ptxas(logs["flash_fwd_f16"])
    f16_bwd_rows, spill_fails = bwd_ptxas(logs["flash_bwd_f16"])
    check(not spill_fails, "float16: " + "; ".join(spill_fails))
    for rec in float16_ptxas(fwd_rows + bwd_rows, f16_rows + f16_bwd_rows):
        emit({**rec, "card": card})
    # the tp serving phases' follower boots while the kernel checks (which
    # hold no time) run
    tp_pending = Background(tp_serve_group)

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
    t0 = time.perf_counter()
    sass = sass_pending.result()
    fwd_sass(card, sass["flash_fwd"])
    bwd_sass(card, sass["flash_bwd"])
    phase_float16_sass(card, sass)
    added_seconds["float16_sass"] = time.perf_counter() - t0

    model32 = GPT(gpt2_config("flash", "float32"), seed=0, device="cuda")
    phase_forward(GPT, fa, model32)
    phase_grads(model32.params, card)
    generate_launches = phase_generate(GPT, fa, model32, card)
    t0 = time.perf_counter()
    f16_generate = phase_float16_generate(GPT, fa, model32.params, card)
    added_seconds["float16_generate"] = time.perf_counter() - t0
    phase_sample(fa, card)
    parity = phase_serve_parity(model32.params, card)
    spec_parity = phase_serve_spec_parity(model32.params, card, parity)
    quant_parity = phase_serve_quant_parity(model32.params, card, parity)
    del parity
    serve = phase_serve(model32.params, card)
    serve_quant = {kv: phase_serve(model32.params, card, kv_dtype=kv,
                                   n_req=SERVE_QUANT_REQUESTS, serve_rec=serve)
                   for kv in ("int8", "fp8")}
    serve_spec = {d: phase_serve(model32.params, card, draft=d, n_req=SERVE_SPEC_REQUESTS,
                                 serve_rec=serve)
                  for d in ("self:2", "self")}
    t0 = time.perf_counter()
    phase_graftaudit(model32.params, card)
    earlier_seconds["graftaudit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    group, tp_spawn_s = tp_pending.result()
    try:
        phase_serve_tp_parity(model32.params, card, group)
        serve_tp = phase_serve_tp(model32.params, card, group, serve)
        earlier_seconds["serve_tp_parity+serve_tp"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        moe_tp_launches = phase_serve_moe_tp_parity(card, group)
        earlier_seconds["serve_moe_tp_parity"] = time.perf_counter() - t0
    finally:
        tp_exits = group.close()
    emit({"phase": "serve_tp_group", "follower_exit_codes": tp_exits,
          "spawn_seconds": tp_spawn_s, "card": card})
    check(tp_exits == [0], f"the tp follower exited {tp_exits}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    seconds = {}
    t0 = time.perf_counter()
    serve_telemetry = phase_serve_telemetry(model32.params, card, tmp)
    seconds["serve_telemetry"] = time.perf_counter() - t0
    fleet_launches, new_seconds = {}, {}
    t0 = time.perf_counter()
    fleet_launches["fleet_parity"] = phase_fleet_parity(model32.params, card)
    seconds["fleet_parity"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet_launches["fleet"], fleet_rec = phase_fleet(model32.params, card, serve)
    seconds["fleet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet_launches["traffic"] = phase_traffic(model32.params, card)
    seconds["traffic"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet_launches["traffic_controller"] = phase_traffic_controller(model32.params, card)
    earlier_seconds["traffic_controller"] = time.perf_counter() - t0
    # the process fleet: worker subprocesses, each its own CUDA context
    t0 = time.perf_counter()
    fleet_launches["procfleet_parity_loopback"], proc_parity, workers = phase_procfleet_parity(
        model32.params, card, tmp, then=lambda: procfleet_workers(tmp))
    new_seconds["procfleet_parity"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    procfleet_rec = phase_procfleet(model32.params, card, serve, fleet_rec, workers.result())
    new_seconds["procfleet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, mesh = phase_standby(model32.params, card, proc_parity["cold_recovery"], tmp,
                            overlap=lambda: crosshost_mesh(tmp))
    new_seconds["standby"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet_launches["crosshost_traffic_rung"], _ = phase_crosshost(card, mesh.result())
    new_seconds["crosshost"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_autoscale(model32.params, card, tmp, procfleet_rec, fleet_rec)
    earlier_seconds["autoscale"] = time.perf_counter() - t0
    del model32
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_moe_check(card)
    seconds["moe_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_moe_parity, serve_moe = phase_serve_moe(card)
    seconds["serve_moe_parity+serve_moe"] = time.perf_counter() - t0

    split = phase_train_step(card)
    fused = phase_train_step(card, fused=True, split=split)
    t0 = time.perf_counter()
    f16_train, f16_fused = phase_float16_train(card)
    added_seconds["float16_train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    moe_split, moe_fused = phase_moe_train(fa, card)
    seconds["moe_train_step+fused"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    family_launches = phase_families(fa, card)
    earlier_seconds["families"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    head_width_launches = phase_head_widths(fa, card)
    earlier_seconds["head_widths"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    f16_errors = phase_float16_kernels(fa, card)
    added_seconds["float16_kernels"] = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        train_argv = phase_train_entry(card, tmp)
        seconds["train_cli"] = time.perf_counter() - t0
        window = phase_train_telemetry(card, train_argv, tmp)
        t0 = time.perf_counter()
        phase_trace_summary(card, tmp, window)
        earlier_seconds["trace_summary"] = time.perf_counter() - t0
        plain_texts = phase_serve_cli(card, train_argv, tmp, new_seconds)
        t0 = time.perf_counter()
        phase_serve_cli_autoscale(card, train_argv, tmp, plain_texts)
        earlier_seconds["serve_cli_autoscale"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_serve_cli_tp(card, train_argv, tmp, plain_texts)
        earlier_seconds["serve_cli_tp"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    phase_moe_ep_kernels(fa, card)
    earlier_seconds["moe_ep_kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    moe_sp_errs = phase_moe_sp_kernels(fa, card)
    earlier_seconds["moe_sp_kernels"] = time.perf_counter() - t0
    (sp_counts, sp_tp_counts, earlier_seconds["sp_tp"], ft, zm, ms, pp,
     ring_f16) = phase_sp(card)
    ft_counts = phase_fsdp_tp(card, ft)
    earlier_seconds["fsdp_tp"] = ft[1]
    zero_counts, moe_ep_counts, zm_seconds = phase_zero_moe(card, zm)
    earlier_seconds.update(zm_seconds)
    moe_sp_counts, ms_seconds = phase_moe_sp(card, ms)
    earlier_seconds.update(ms_seconds)
    pp_counts, pp4_counts, pp_seconds = phase_pp(card, pp)
    earlier_seconds.update(pp_seconds)
    proto_counts = phase_proto(nh, card)
    emit_clocks("before times")
    rows = phase_times(fa, card)
    t0 = time.perf_counter()
    phase_fsdp_tp_times(fa, card)
    earlier_seconds["fsdp_tp_times"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_sp_tp_times(fa, card)
    earlier_seconds["sp_tp_times"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_zero_moe_times(fa, card)
    earlier_seconds["zero_moe_times"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    head_width_rows = phase_head_width_times(fa, card)
    earlier_seconds["head_width_times"] = time.perf_counter() - t0
    rows.update(phase_lse_times(fa, card))
    rows.update(phase_nh_times(nh, card))
    exp_counts, rows["exp_chain"] = phase_exp_tool(ex, card)
    emit_clocks("after times")
    exp_sass(card, sass["exp_exp2"])

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
    records = {"fwd": fwd_errors, "prep": prep_errors, "bwd": bwd_errors,
               "fused": fused_errors, "lse": lse_errors}
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
        if name in MOE_SP_KERNELS:  # the moe_sp path's launches and error too
            line[-1]["moe_sp_launches"] = moe_sp_counts[name]
            line[-1]["moe_sp_max_abs_err"] = moe_sp_errs[name]
        if name == "flash_bwd_prep":
            line[-1]["replaces_is"] = "jnp.sum of out * dO (delta): no pallas_call"
        if name in INSTANCE_KERNELS:  # every instance's check, and its train shapes
            line[-1]["instances"] = instance_errors(name, records)
            # K2c's launches are the fused step's (at hd 256), the others' the
            # split steps'
            line[-1]["head_width_steps"] = {
                model: {"launches": head_width_launches.get(
                    f"{model}_fused" if name == "flash_bwd_fused" else model, {}).get(name, 0),
                        **head_width_rows[(model, name)]}
                for model in HEAD_WIDTH_STEPS}
    # the float16 instances (flash_*_f16.cu: flash_fwd.cu and flash_bwd.cu
    # built for __half), their errors at GPT-2's shape (K3/K4 at the
    # non-causal hop of that shape), times at the training shape (K3/K4 at
    # the zigzag hop), launches on their float16 paths: the GPT-2 float16
    # train step (K1, prep, K2a, K2b), its fused step (K2c), the float16
    # ring on the sp ranks (K3, K4a, K4b, rank 0)
    f16e = {kind: f16_errors[(kind, "f16_gpt2_train")] for kind in ("fwd", "prep", "bwd",
                                                                      "fused")}
    f16hop = f16_errors[("lse", "f16_gpt2_non_causal")]
    fwd16_cu, bwd16_cu = f"{csrc}/flash_fwd_f16.cu", f"{csrc}/flash_bwd_f16.cu"
    for counter, source, replaces, err, launches in (
            ("flash_fwd", fwd16_cu, f"{jax_fa}:677", f16e["fwd"]["max_abs_err"],
             f16_train["launches"]),
            ("flash_bwd_prep", bwd16_cu, f"{jax_fa}:1101", f16e["prep"]["delta_max_abs_err"],
             f16_train["launches"]),
            ("flash_bwd_dq", bwd16_cu, f"{jax_fa}:750", f16e["bwd"]["dq_max_abs_err"],
             f16_train["launches"]),
            ("flash_bwd_dkv", bwd16_cu, f"{jax_fa}:818",
             max(f16e["bwd"]["dk_max_abs_err"], f16e["bwd"]["dv_max_abs_err"]),
             f16_train["launches"]),
            ("flash_bwd_fused", bwd16_cu, f"{jax_fa}:896",
             max(f16e["fused"][f"{g}_max_abs_err"] for g in ("dq", "dk", "dv")), f16_fused),
            ("flash_lse_fwd", fwd16_cu, f"{jax_fa}:193", f16hop["max_abs_err"], ring_f16),
            ("flash_lse_bwd_dq", bwd16_cu, f"{jax_fa}:346", f16hop["dq_max_abs_err"],
             ring_f16),
            ("flash_lse_bwd_dkv", bwd16_cu, f"{jax_fa}:412",
             max(f16hop["dk_max_abs_err"], f16hop["dv_max_abs_err"]), ring_f16)):
        line.append({"name": f"{counter}_f16", "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[counter],
                     "max_abs_err": err, **rows[f"{counter}_f16"], "dtype": "float16",
                     "counter": counter})
    next(k for k in line if k["name"] == "flash_fwd_f16")["generate_sliding_launches"] = \
        f16_generate["flash_fwd"]
    check(all(k["launches"] > 0 for k in line),
          f"a kernel never ran on its path: {[k['name'] for k in line]}")
    check(all(moe_sp_counts[k] > 0 for k in MOE_SP_KERNELS),
          f"a kernel never ran on the moe_sp path: {moe_sp_counts}")
    emit({"phase": "launches_by_path", "train_step": split["launches"],
          "train_step_fused": fused["launches"], "sp_train_step_rank0": sp_counts,
          "fsdp_tp_train_step_rank0": ft_counts, "sp_tp_train_step_rank0": sp_tp_counts,
          "zero_train_step_rank0": zero_counts, "moe_ep_train_step_rank0": moe_ep_counts,
          "moe_sp_train_step_rank0": moe_sp_counts,
          "pp_train_step_rank0": pp_counts, "pp_1f1b_train_step_rank0": pp4_counts,
          "serve_moe_tp_parity": moe_tp_launches,
          "serve_tp": serve_tp["launches"],
          "serve_tp_follower": serve_tp["follower_launches"][0],
          "proto_nh_kernel": proto_counts, "exp_exp2": exp_counts,
          "generate_sliding_bf16": {"flash_fwd": generate_launches},
          "train_step_float16": f16_train["launches"], "train_step_fused_float16": f16_fused,
          "generate_sliding_float16": f16_generate, "sp_ring_float16_rank0": ring_f16,
          "serve": serve["launches"],
          **{f"serve_spec_parity_{d}": v for d, v in spec_parity.items()},
          **{f"serve_quant_parity_{kv}": v for kv, v in quant_parity.items()},
          **{f"serve_quant_{kv}": r["launches"] for kv, r in serve_quant.items()},
          **{f"serve_spec_{d}": r["launches"] for d, r in serve_spec.items()},
          "serve_telemetry": serve_telemetry, "serve_moe_parity": serve_moe_parity,
          "serve_moe": serve_moe["launches"], "moe_train_step": moe_split["launches"],
          "moe_train_step_fused": moe_fused["launches"], **family_launches,
          **{f"head_width_{k}": v for k, v in head_width_launches.items()},
          **fleet_launches,
          "procfleet_subprocess_legs": "not counted: each worker process counts its own "
                                       "launches; the same ReplicaWorker code through a "
                                       "LoopbackBackend in this process is "
                                       "procfleet_parity_loopback"})
    emit({"phase": "phase_seconds", **seconds})
    emit({"phase": "new_phase_seconds", **new_seconds,
          "total": sum(new_seconds.values()),
          "smoke_so_far": time.perf_counter() - smoke_t0})
    emit(budget_record(added_seconds, time.perf_counter() - smoke_t0, earlier_seconds))
    print(card_line(), flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
