"""Run ``chip_smoke.py``'s ZeRO and MoE-across-ranks legs alone, on the card.

Builds the kernels, spawns the smoke's four gloo ranks sharing cuda:0 and
runs ``chip_smoke.zero_moe_rank`` on each: ``zero`` (GPT-2 124M, dp 4
with ``zero_dp`` beside its dense twin, T 1024, global batch 16, bf16)
and its fp32 leg, the narrow fp32 MoE legs, and ``moe_ep`` (Mixtral-8x7B
widths, 1 layer, ep 4, T 4096). ``chip_smoke.phase_zero_moe`` then holds
them to the smoke's checks and prints their JSON records (step ms, the
reduce-scatter and all-gather ms, Adam bytes by the allocator, launches),
after the card's name and power limit. Exits 1 if a check fails, 2
without CUDA.

    python3 mingpt_distributed_tpu_torch/tools/zero_moe_legs.py

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
    return C.zero_moe_rank(device)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("zero_moe_legs: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from mingpt_distributed_tpu_torch.ops import _build
    from mingpt_distributed_tpu_torch.parallel.spawn import run_ranks

    t0 = time.perf_counter()
    card = C.card_line()
    print(card, flush=True)
    _build.build_all()
    build_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    try:
        with C.fused_switch(False):
            ranks = run_ranks(_rank, 4, timeout_s=900)
        C.phase_zero_moe(card, ranks)
    except C.SmokeFailure as e:
        print(f"zero_moe_legs: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"root": str(ROOT), "build_s": build_s,
                      "legs_s": time.perf_counter() - t1, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
