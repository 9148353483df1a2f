"""What an exponential costs on the card, exp against exp2: the
counterpart of ``tools/exp_exp2.py`` (K6).

The flash kernels exponentiate every score once: K1-K4 with ``exp2f`` of
log2(e)-scaled scores, K5 with the accurate ``expf``. On an H100 both end
in one MUFU.EX2 on the SM's special-function unit (SFU), 16 results per
clock per SM, where the FMA pipes give 128 results per clock; ``expf``
adds a range reduction of a few FMA-pipe instructions around it. This tool
measures the rate of each.

* ``exp_chain`` runs the kernel of ``ops/csrc/exp_exp2.cu`` (the JAX tool's
  ``_kernel``): for every element of a float32 array, ``y = x``, then
  ``reps`` times ``y = op(-|y| - 0.01)``. Each step waits on the last and
  the values stay in (0, 1], so the time is the exponentials' and not the
  memory's. ``op`` is ``exp`` (``expf``), ``exp2`` (``exp2f``) or
  ``exp2*log2e`` (``exp2f(y * log2(e))``), the flash kernels' own helpers.
  CPU tensors take ``exp_chain_plain`` (the same chain as torch ops); CUDA
  tensors launch the kernel, counted in ``exp_chain.launches``, or raise.
* ``run`` and ``main`` print the JAX tool's records, ``{"op", "ms",
  "gexp_per_sec"}`` for each op at (nblocks, BLOCK, BLOCK) float32 drawn
  from ``--seed`` with REPS steps, then the exp / exp2 time ratio. Times
  are CUDA events over ITERS launches after WARMUP. Each record also gives
  ``bound_ms``, the least time for its exponentials at the card's max SM
  clock (``clock_mhz``) or for its bytes, and ``implied_clock_mhz``, the
  clock at which the SFUs would give the measured rate. On the CPU the
  records carry no times.

    python -m mingpt_distributed_tpu_torch.tools.exp_exp2
    python -m mingpt_distributed_tpu_torch.tools.exp_exp2 --device cpu \\
        --nblocks 2 --block 64
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from typing import List

import torch

from mingpt_distributed_tpu_torch.ops import _build
from mingpt_distributed_tpu_torch.training.metrics import roofline_ms, sfu_exp_rate
from mingpt_distributed_tpu_torch.utils.device import resolve_device

BLOCK = 512
REPS = 64
WARMUP, ITERS = 3, 20  # launches per op and run: 23
LOG2E = 1.4426950408889634
# op: (its code in exp_exp2.cu, one step's exponential as a torch op)
OPS = {"exp": (0, torch.exp),
       "exp2": (1, torch.exp2),
       "exp2*log2e": (2, lambda y: torch.exp2(y * LOG2E))}
# exp_chain(x, out, n, reps, op, stream)
ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]


def _check(x: torch.Tensor, op: str, reps: int) -> None:
    if op not in OPS:
        raise ValueError(f"exp_chain: op must be one of {sorted(OPS)}, got {op!r}")
    if x.dtype != torch.float32:
        raise TypeError(f"exp_chain takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("exp_chain needs a contiguous tensor")
    if not isinstance(reps, int) or reps < 1:
        raise ValueError(f"exp_chain: reps must be an int >= 1, got {reps!r}")


def exp_chain_plain(x: torch.Tensor, op: str, reps: int = REPS) -> torch.Tensor:
    """What ``exp_chain`` computes, as ``reps`` steps of torch ops."""
    _check(x, op, reps)
    step = OPS[op][1]
    y = x
    for _ in range(reps):
        y = step(-torch.abs(y) - 0.01)
    return y


def exp_chain(x: torch.Tensor, op: str, reps: int = REPS) -> torch.Tensor:
    """``reps`` steps of y = op(-|y| - 0.01) from y = x, elementwise, for a
    contiguous float32 ``x`` of any shape. CPU tensors take
    ``exp_chain_plain``; CUDA tensors launch the kernel (counted in
    ``exp_chain.launches``) or raise."""
    _check(x, op, reps)
    if x.device.type == "cpu":
        return exp_chain_plain(x, op, reps)
    if x.device.type != "cuda":
        raise ValueError(f"exp_chain runs on cuda or cpu tensors, not {x.device}")
    lib = _build.load("exp_exp2")
    if lib.exp_chain.argtypes is None:
        lib.exp_chain.argtypes = ARGTYPES
        lib.exp_chain.restype = ctypes.c_int
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.exp_chain(x.data_ptr(), out.data_ptr(), x.numel(), reps,
                           OPS[op][0], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"exp_chain kernel launch failed: CUDA error {rc}")
    exp_chain.launches += 1
    return out


exp_chain.launches = 0


def run(op: str, nblocks: int = 64, block: int = BLOCK, device=None,
        seed: int = 0) -> dict:
    """The JAX tool's ``run`` for one op: its record at (nblocks, block,
    block) float32 from ``seed``. On the card: WARMUP + ITERS launches, the
    mean time of the last ITERS, the rate and the bound; the last output
    must be finite. On the CPU: one call of the plain chain, no times."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((nblocks, block, block), generator=g, device=device)
    rec = {"op": op, "shape": list(x.shape), "reps": REPS, "device": str(device)}
    if device.type != "cuda":
        out = exp_chain(x, op)
    else:
        for _ in range(WARMUP):
            exp_chain(x, op)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(ITERS):
            out = exp_chain(x, op)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / ITERS
        exps = x.numel() * REPS
        rate, mhz = sfu_exp_rate(device.index or 0)
        bound, by = roofline_ms(2 * x.numel() * 4, [(exps, rate)])
        rec.update({"ms": ms, "gexp_per_sec": exps / (ms * 1e-3) / 1e9,
                    "bound_ms": bound, "bound_by": by, "clock_mhz": mhz,
                    "implied_clock_mhz": mhz * exps / (ms * 1e-3) / rate,
                    "card": torch.cuda.get_device_name(device)})
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"exp_chain {op}: non-finite output")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--nblocks", type=int, default=64)
    ap.add_argument("--block", type=int, default=BLOCK)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    recs = [run(op, args.nblocks, args.block, args.device, args.seed) for op in OPS]
    for rec in recs:
        print(json.dumps(rec), flush=True)
    base, reb = recs[0].get("ms"), recs[1].get("ms")
    print(json.dumps({"what": "exp2 vs exp speedup",
                      "ratio": base / reb if base and reb else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
