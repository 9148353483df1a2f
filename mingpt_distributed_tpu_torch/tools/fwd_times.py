"""Time the forward kernels at their main paths' shapes, on the card.

K1 (``flash_fwd``) at the generation shape (B=4, T=1024, H=12, hd=64) and
the training shape (B=16), K3 (``flash_lse_fwd``) at the sp path's zigzag
hop (8, 512, 12, 64, non-causal) and K5's forward (``nh_fwd``) at the
prototype tool's shape (16, 1024, 12, 64), all bf16: device ms per launch
(CUDA events over 20 launches after 3 warm-up, queued behind a ~10 ms
spin so that the host's launch rate does not pace them) and the wrapper's
host microseconds per launch (the median of 11 batches of 20 back-to-back
calls), one JSON line each, with the card's name and power limit.

    python3 mingpt_distributed_tpu_torch/tools/fwd_times.py [--root DIR]

``--root DIR`` imports the package from the checkout at DIR (for example
an older commit unpacked with ``git archive``), so two versions can be
compared within one run on one card: time them in the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

# name, kernel, B, T, H, hd, kwargs
CASES = (
    ("generation", "flash_fwd", 4, 1024, 12, 64, {}),
    ("training", "flash_fwd", 16, 1024, 12, 64, {}),
    ("zigzag_hop", "flash_lse_fwd", 8, 512, 12, 64, {"causal": False}),
    ("proto_main", "nh_fwd", 16, 1024, 12, 64, {}),
)


# Device cycles (~10 ms) the card is held busy before a timed run, so the
# host queues every launch first and a kernel shorter than its host-side
# launch is timed back to back, not at the host's pace
HOLD_CYCLES = 20_000_000


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
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


def host_us(torch, fn, calls: int = 20, batches: int = 11) -> float:
    """The median over ``batches`` of the host's microseconds per call in
    ``calls`` back-to-back calls."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose package is timed")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("fwd_times: needs a CUDA device", file=sys.stderr)
        return 2
    fa = importlib.import_module("mingpt_distributed_tpu_torch.ops.flash_attention")
    assert os.path.abspath(fa.__file__).startswith(root), fa.__file__
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    for shape_of, kernel, b, t, h, hd, kw in CASES:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((b, t, h, hd), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        scale = 1.0 / math.sqrt(hd)
        if kernel == "nh_fwd":
            nh = importlib.import_module("mingpt_distributed_tpu_torch.tools.proto_nh_kernel")
            q, k, v = (x.reshape(b, t, h * hd) for x in (q, k, v))
            fn = lambda: nh.nh_fwd(q, k, v, h, scale)  # noqa: E731
        else:
            fn = lambda: getattr(fa, kernel)(q, k, v, scale=scale, **kw)  # noqa: E731
        ms = cuda_ms(torch, fn)
        us = host_us(torch, fn)
        print(json.dumps({"kernel": kernel, "shape_of": shape_of,
                          "shape": [b, t, h, hd], **kw, "ms": ms,
                          "host_us_per_launch": us, "root": root, "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
