"""Run ``chip_smoke.py``'s MoE-beside-sp legs alone, on the card.

Builds the kernels, holds K3, the prep pass and K4a/K4b against their
plain versions at the shapes ``moe_sp`` gives them
(``chip_smoke.phase_moe_sp_kernels``), spawns the smoke's four gloo ranks
sharing cuda:0 and runs ``chip_smoke.moe_sp_rank`` on each: the narrow
fp32 MoE legs beside sp (sp 2 x dp 2 and sp 2 x ep 2 on the ring, sp 2 x
tp 2 on Ulysses; 4 rows of 256 tokens, one routing group interleaving the
sp chunks, capacity binding) and ``moe_sp`` (Mixtral-8x7B widths, 1
layer, sp 2 x ep 2 on the zigzag ring, T 8192, global batch 2, bf16: the
forward, the backward and the gradient reduction). ``chip_smoke.phase_moe_sp``
then holds them to the smoke's checks and prints their JSON records
(launches, the first loss and gradient norm against one process's, the
all-to-alls, step ms, peak memory) after the card's name and power limit.
Exits 1 if a check fails, 2 without CUDA.

    python3 mingpt_distributed_tpu_torch/tools/moe_sp_legs.py

It imports the checkout it lies in, so two versions (one unpacked with
``git archive``) compare within one run on one card by running each
checkout's copy in the order A, B, B, A.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _rank(_rank_index: int) -> dict:
    import torch

    import chip_smoke as C

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return C.moe_sp_rank(device)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("moe_sp_legs: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from mingpt_distributed_tpu_torch.ops import _build
    from mingpt_distributed_tpu_torch.ops import flash_attention as fa
    from mingpt_distributed_tpu_torch.parallel.spawn import run_ranks

    t0 = time.perf_counter()
    card = C.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    build_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    try:
        errs = C.phase_moe_sp_kernels(fa, card)
        kernels_s = time.perf_counter() - t1
        with C.fused_switch(False):
            ranks = run_ranks(_rank, C.SP, timeout_s=900)
        counts, seconds = C.phase_moe_sp(card, ranks)
    except C.SmokeFailure as e:
        print(f"moe_sp_legs: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"root": str(ROOT), "build_s": build_s, "kernels_s": kernels_s,
                      "legs_s": time.perf_counter() - t1, "seconds": seconds,
                      "max_abs_err": errs, "launches": counts, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
