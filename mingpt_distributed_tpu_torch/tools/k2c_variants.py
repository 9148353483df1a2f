"""Time the design variants of K2c's dq reduce against the committed kernel.

K2c (the fused backward, ``flash_bwd_fused``) is K2b's bf16 dk/dv kernel
that also computes each (64-query tile, 128-key item) cell's dq = dS K and
adds it to a float32 dq in device memory. Each variant below is a copy of
this package with one edit to ``ops/csrc/flash_bwd.cu``, applied by text as
``plant_faults`` applies its faults (an anchor that does not appear as
often as expected fails the tool before anything runs):

  final       the committed kernel: the two consumer warpgroups sum their
              partials through shared memory and each adds half the
              columns by float2 atomics (every element once per cell);
  no_atomics  final without the atomic adds (dq wrong): what the reduce costs;
  no_dq       without the dq product, the exchange and the atomics (the dS^T
              store, its fence and barrier kept): what all of dq costs;
  own         each warpgroup adds its own 64-key partial, all columns, by
              float2 atomics (twice the atomic traffic, no exchange);
  own_f4      ``own`` with float4 atomics (lane pairs trade a pair of
              values by shuffle).

Each copy is timed by ``tools/bwd_times.py --root COPY`` (K2b and K2c
alone at the training shape, bf16), first in the order above and then in
the reverse order, one JSON line per case with the variant's name; every
number is a device time from that tool on this run's card.

    python -m mingpt_distributed_tpu_torch.tools.k2c_variants
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from mingpt_distributed_tpu_torch.tools.plant_faults import PACKAGE, ROOT, patch

SOURCE = "ops/csrc/flash_bwd.cu"

# the committed atomic adds, and the float4 form: lane t4 ^ 1 holds the
# other row's pair of the same columns, so each lane pair trades one pair
# and each lane adds four columns of one row
_F2 = """#pragma unroll
                for (int r = 0; r < 2; ++r) {
                  if (dq_row[r] >= p.T) continue;
                  float* const o = dq_head +
                                   (static_cast<long long>(b) * p.T + dq_row[r]) * p.H * HD +
                                   n * kDqN;
#pragma unroll
                  for (int j = 0; j < kDqN / 8; ++j) {
                    if (!pair || j / kHalf == cw) {
                      atomicAdd(reinterpret_cast<float2*>(o + 8 * j + 2 * t4),
                                make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]));
                    }
                  }
                }
"""
_F4 = """                const int rr = t4 & 1;
                const int row4 = rr ? dq_row[1] : dq_row[0];
                float* const o4 = dq_head + (static_cast<long long>(b) * p.T + row4) * p.H * HD +
                                  n * kDqN + 4 * (t4 >> 1);
#pragma unroll
                for (int j = 0; j < kDqN / 8; ++j) {
                  if (!pair || j / kHalf == cw) {
                    const float s0 = __shfl_xor_sync(0xffffffffu, rr ? dq[4 * j] : dq[4 * j + 2], 1);
                    const float s1 = __shfl_xor_sync(0xffffffffu, rr ? dq[4 * j + 1] : dq[4 * j + 3], 1);
                    const float4 val = rr ? make_float4(s0, s1, dq[4 * j + 2], dq[4 * j + 3])
                                          : make_float4(dq[4 * j], dq[4 * j + 1], s0, s1);
                    if (row4 < p.T) atomicAdd(reinterpret_cast<float4*>(o4 + 8 * j), val);
                  }
                }
"""
_OWN = ("              const bool pair =\n", "              const bool pair = false &&\n", 1)

# name: [(text, its replacement, count)]
VARIANTS = {
    "final": [],
    "no_atomics": [("if (dq_row[r] >= p.T) continue;", "if (dq_row[r] >= 0) continue;", 1)],
    "no_dq": [("for (int n = 0; n < HD / kDqN; ++n) {", "for (int n = 0; n < 0; ++n) {", 1)],
    "own": [_OWN],
    "own_f4": [_OWN, (_F2, _F4, 1)],
}
KERNELS = ("flash_bwd_dkv", "flash_bwd_fused")


def make_copy(name: str, tmp: Path) -> Path:
    """A copy of the package under ``tmp/name`` with the variant's edits
    (libraries already built come along and are reused where their source
    is unchanged)."""
    tree = tmp / name
    shutil.copytree(ROOT / PACKAGE, tree / PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = tree / PACKAGE / SOURCE
    path.write_text(patch(path.read_text(), VARIANTS[name]))
    return tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k2c_variants: needs a CUDA device", file=sys.stderr)
        return 2
    src = (ROOT / PACKAGE / SOURCE).read_text()
    for edits in VARIANTS.values():  # every anchor, before any run
        patch(src, edits)
    tool = ROOT / PACKAGE / "tools" / "bwd_times.py"
    args = [a for k in KERNELS for a in ("--kernel", k)]
    with tempfile.TemporaryDirectory(prefix="k2c_variants_") as tmp:
        trees = {name: make_copy(name, Path(tmp)) for name in VARIANTS}
        for name in [*VARIANTS, *reversed(VARIANTS)]:
            proc = subprocess.run([sys.executable, str(tool), "--root", str(trees[name]),
                                   *args], capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            for line in proc.stdout.splitlines():
                if line.startswith("{"):
                    print(json.dumps({"variant": name, **json.loads(line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
