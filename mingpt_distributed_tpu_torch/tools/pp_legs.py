"""Run ``chip_smoke.py``'s pipeline and sharded-snapshot legs alone, on the
card.

Builds the kernels, spawns the smoke's four gloo ranks sharing cuda:0 and
runs ``chip_smoke.pp_rank`` on each: ``pp_train_step`` (GPT-2 124M, T
1024, bf16, pp 2 x dp 2, GPipe, 4 microbatches, global batch 8),
``pp_1f1b_train_step`` (pp 4, 8 microbatches, GPipe and 1F1B),
``pp_parity_fp32`` (4 layers, T 256, at pp 2 x dp 2, pp 4, pp 2 x tp 2 and
pp 2 x sp 2) and ``ckpt_sharded`` (the fsdp 2 x tp 2 GPT-2 124M state to a
directory, restored at pp 2 x dp 2 and in one process).
``chip_smoke.phase_pp`` then holds them to the smoke's checks and prints
their JSON records (step and exchange ms, launches, live graphs, peak
memory, save and restore seconds) after the card's name and power limit.
Exits 1 if a check fails, 2 without CUDA.

    python3 mingpt_distributed_tpu_torch/tools/pp_legs.py

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


def _rank(rank: int) -> dict:
    import torch

    import chip_smoke as C

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return {"pp": C.pp_rank(device, rank)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("pp_legs: no CUDA device", file=sys.stderr)
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
            ranks = run_ranks(_rank, C.SP, timeout_s=900)
        _, _, seconds = C.phase_pp(card, ranks)
    except C.SmokeFailure as e:
        print(f"pp_legs: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"root": str(ROOT), "build_s": build_s, "seconds": seconds,
                      "legs_s": time.perf_counter() - t1, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
