"""Time the backward kernels at their main paths' shapes, on the card.

The prep pass (``flash_bwd_prep``: delta, and with K2c's dq zero-fill), K2a
(``flash_bwd_dq``), K2b (``flash_bwd_dkv``) and K2c (``flash_bwd_dqkv``,
the kernel alone, adding into one float32 buffer) at the training shape
(B=16, T=1024, H=12, hd=64, causal), K4a and K4b (``flash_lse_bwd_dq``,
``flash_lse_bwd_dkv``) at the sp path's zigzag hop (8, 512, 12, 64,
non-causal), K5's backward (``nh_bwd_dq``, ``nh_bwd_dkv``) at the prototype
tool's shape (16, 1024, 12, 64), all bf16; then the whole split backward
(``flash_bwd`` with FLASH_FUSED_BWD=0: delta, K2a, K2b), the whole fused
backward (``flash_bwd_fused``: delta and a zeroed float32 dq, K2c, the
cast) and SDPA's backward (the yardstick, dq, dk and dv) at the training
shape and at the hop. The delta the kernels are given is the plain torch
sum, so a package without the prep pass runs every case but the prep
pass's (printed with ``"absent": true``). Device
ms per call from CUDA events over 20 calls after 3 warm-up, queued behind a
~10 ms spin (``fwd_times.cuda_ms``), with each kernel's bound (the larger of
its bytes over 3.35 TB/s and its products over 989 TFLOP/s or its
exponentials over the SFU rate), its TFLOP/s and the card's name and power
limit, one JSON line each.

    python3 mingpt_distributed_tpu_torch/tools/bwd_times.py [--root DIR]
        [--kernel NAME ...]

``--root DIR`` imports the package from the checkout at DIR (for example
an older commit unpacked with ``git archive``), so two versions can be
compared within one run on one card: time them in the order A, B, B, A.
``--kernel NAME`` (repeatable) times only the cases of that name.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

# name, kernel (or what), B, T, H, hd, causal
CASES = (
    ("training", "flash_bwd_prep", 16, 1024, 12, 64, True),
    ("training", "flash_bwd_prep+zero", 16, 1024, 12, 64, True),
    ("training", "flash_bwd_dq", 16, 1024, 12, 64, True),
    ("training", "flash_bwd_dkv", 16, 1024, 12, 64, True),
    ("training", "flash_bwd_fused", 16, 1024, 12, 64, True),
    ("zigzag_hop", "flash_lse_bwd_dq", 8, 512, 12, 64, False),
    ("zigzag_hop", "flash_lse_bwd_dkv", 8, 512, 12, 64, False),
    ("proto_main", "nh_bwd_dq", 16, 1024, 12, 64, True),
    ("proto_main", "nh_bwd_dkv", 16, 1024, 12, 64, True),
    ("training", "whole split backward", 16, 1024, 12, 64, True),
    ("training", "whole fused backward", 16, 1024, 12, 64, True),
    ("training", "SDPA backward", 16, 1024, 12, 64, True),
    ("zigzag_hop", "SDPA backward", 8, 512, 12, 64, False),
)


def _fwd_times():
    """tools/fwd_times.py beside this file: its spin and timing helpers."""
    spec = importlib.util.spec_from_file_location(
        "fwd_times", Path(__file__).with_name("fwd_times.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def work(kernel, b, t, h, hd, causal):
    """(bytes, operations, exponentials) of a kernel, each input read once
    and each output written once. dq, dk/dv and K2c: q, k, v, dO, lse,
    delta in; dq, or dk and dv, or (K2c) dq, dk and dv out, in bf16; 3 (dq:
    S, dP, dS K), 4 (dk/dv: S, dP, P^T dO, dS^T Q) or 5 (K2c: all five)
    products of 2 * hd operations and one exponential per allowed pair.
    K2c's float32 dq buffer is a cost of its design, not of the function,
    and is counted apart (``dq_f32_bytes``). The prep pass: out and dO in,
    delta out (and, with the zero-fill, the float32 dq), 2 float32
    operations per element."""
    pairs = t * t if not causal else t * (t + 1) // 2
    elems = b * t * h * hd * 2  # one bf16 (B, T, H, hd) tensor
    vec = b * h * t * 4
    if kernel.startswith("flash_bwd_prep"):
        zero = 2 * elems if kernel.endswith("zero") else 0
        return 2 * elems + vec + zero, b * t * h * hd * 2, 0
    outs, products = {"dq": (1, 3), "fused": (3, 5)}.get(kernel.rsplit("_", 1)[1], (2, 4))
    return (4 + outs) * elems + 2 * vec, 2 * products * b * h * hd * pairs, b * h * pairs


def dq_f32_bytes(b, t, h, hd, causal):
    """K2c's float32 dq traffic, which its bound does not count: the zeroed
    buffer read and written back once, and its atomic adds (resolved in
    L2), every element once per (64-query tile, 128-key item) cell with an
    allowed pair."""
    elems = b * t * h * hd
    cells = sum(1 for i in range(-(-t // 64)) for j in range(-(-t // 128))
                if not causal or min(64 * i + 63, t - 1) >= 128 * j)
    return {"read": elems * 4, "write": elems * 4,
            "atomic_add": b * h * cells * 64 * hd * 4}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose package is timed")
    ap.add_argument("--kernel", action="append",
                    choices=sorted({c[1] for c in CASES}),
                    help="time only this case (repeatable; default: all)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bwd_times: needs a CUDA device", file=sys.stderr)
        return 2
    ft = _fwd_times()
    fa = importlib.import_module("mingpt_distributed_tpu_torch.ops.flash_attention")
    nh = importlib.import_module("mingpt_distributed_tpu_torch.tools.proto_nh_kernel")
    metrics = importlib.import_module("mingpt_distributed_tpu_torch.training.metrics")
    assert os.path.abspath(fa.__file__).startswith(root), fa.__file__
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    os.environ["FLASH_FUSED_BWD"] = "0"
    peak = metrics.H100_SXM["bfloat16"]
    for shape_of, kernel, b, t, h, hd, causal in CASES:
        if args.kernel and kernel not in args.kernel:
            continue
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn((b, t, h, hd), generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        scale = 1.0 / math.sqrt(hd)
        if kernel == "SDPA backward":
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            dot = do.transpose(1, 2)
            fn = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,  # noqa: E731
                                             retain_graph=True)
        elif kernel.startswith("flash_bwd_prep") and not hasattr(fa, "flash_bwd_prep"):
            print(json.dumps({"kernel": kernel, "shape_of": shape_of, "absent": True,
                              "root": root, "card": card}), flush=True)
            continue
        else:
            if causal:
                out, lse = fa.flash_fwd(q, k, v, scale=scale)
            else:
                out, lse = fa.flash_lse_fwd(q, k, v, scale=scale, causal=False)
            delta = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
            dq32 = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
            if kernel == "whole split backward":
                fn = lambda: fa.flash_bwd(q, k, v, out, lse, do, scale=scale)  # noqa: E731
            elif kernel == "whole fused backward":
                fn = lambda: fa.flash_bwd_fused(q, k, v, out, lse, do,  # noqa: E731
                                                scale=scale)
            elif kernel == "flash_bwd_prep":
                fn = lambda: fa.flash_bwd_prep(out, do)  # noqa: E731
            elif kernel == "flash_bwd_prep+zero":
                fn = lambda: fa.flash_bwd_prep(out, do, dq=dq32)  # noqa: E731
            elif kernel == "flash_bwd_fused":  # K2c alone, adding into one buffer
                fn = lambda: fa.flash_bwd_dqkv(q, k, v, do, lse, delta, dq32,  # noqa: E731
                                               scale=scale)
            elif kernel.startswith("nh_"):
                fn = lambda: getattr(nh, kernel)(q, k, v, do, lse, delta,  # noqa: E731
                                                 scale=scale)
            elif kernel.startswith("flash_lse_"):
                fn = lambda: getattr(fa, kernel)(q, k, v, do, lse, delta,  # noqa: E731
                                                 scale=scale, causal=causal)
            else:
                fn = lambda: getattr(fa, kernel)(q, k, v, do, lse, delta,  # noqa: E731
                                                 scale=scale)
        ms = ft.cuda_ms(torch, fn)
        rec = {"kernel": kernel, "shape_of": shape_of, "shape": [b, t, h, hd],
               "causal": causal, "dtype": "bfloat16", "ms": ms}
        if kernel.startswith("flash_bwd_prep"):
            nbytes, flops, _ = work(kernel, b, t, h, hd, causal)
            bound, by = metrics.roofline_ms(nbytes, [(flops, metrics.H100_SXM["float32"])])
            rec.update({"bytes": nbytes, "bound_ms": bound, "bound_by": by})
        elif kernel.endswith(("dq", "dkv", "fused")):
            nbytes, flops, exps = work(kernel, b, t, h, hd, causal)
            bound, by = metrics.roofline_ms(
                nbytes, [(flops, peak), (exps, metrics.sfu_exp_rate()[0])])
            rec.update({"bytes": nbytes, "flops": flops, "exps": exps,
                        "bound_ms": bound, "bound_by": by,
                        "achieved_tflops": flops / (ms * 1e-3) / 1e12})
            if kernel == "flash_bwd_fused":
                rec["dq_f32_bytes"] = dq_f32_bytes(b, t, h, hd, causal)
        print(json.dumps({**rec, "root": root, "card": card}), flush=True)
        del q, k, v, do, fn
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
