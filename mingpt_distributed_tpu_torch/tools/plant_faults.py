"""Plant known faults in the backward kernels and show that the on-card
kernel checks catch them.

For each fault below (and once with none, as the control), copies
``chip_smoke.py`` and this package into a temporary directory, rewrites
``ops/csrc/flash_bwd.cu`` there, and runs ``chip_smoke.bwd_case`` (the
backward checks of ``chip_smoke.py``'s phase 1: every case of
``KERNEL_CASES`` in bfloat16 and float32) against the copy, which builds
its own kernels. Prints one JSON line per fault with the cases and
gradients that failed. Exits 0 when the control passes every check and
every fault fails at least one; needs one CUDA device.

    python -m mingpt_distributed_tpu_torch.tools.plant_faults
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = "mingpt_distributed_tpu_torch"
SOURCE = Path(PACKAGE) / "ops" / "csrc" / "flash_bwd.cu"

# name: (what it breaks, text in flash_bwd.cu, its replacement, count)
FAULTS = {
    "none": ("control: the kernels as committed", None, None, 0),
    # both dq kernels (fp32, bf16) read delta as 0: ds = p * dp
    "dq_drops_delta": ("K2a drops delta", "p.delta[vec]", "0.f", 2),
    # both dk/dv kernels stop one q tile short of the band's end
    "dkv_skips_last_q_tile": (
        "K2b skips the last q tile of the band",
        "for (int qt = qt_lo; qt <= qt_hi; ++qt) {",
        "for (int qt = qt_lo; qt < qt_hi; ++qt) {", 2),
}

# run inside the copy: every backward case, one JSON line each
CHECK = """
import json, sys, torch
import chip_smoke
from mingpt_distributed_tpu_torch.ops import flash_attention as fa
assert fa.__file__.startswith(sys.argv[1]), fa.__file__
for i, case in enumerate(chip_smoke.KERNEL_CASES):
    for dtype in (torch.bfloat16, torch.float32):
        rec, fails = chip_smoke.bwd_case(fa, i, case, dtype)
        print(json.dumps({"case": rec["case"], "dtype": rec["dtype"],
                          "failed": sorted({g for g, _ in fails})}), flush=True)
"""


def run_fault(name: str, tmp: Path) -> dict:
    what, old, new, count = FAULTS[name]
    tree = tmp / name
    shutil.copytree(ROOT / PACKAGE, tree / PACKAGE,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", tree / "chip_smoke.py")
    if old is not None:
        src = (tree / SOURCE).read_text()
        if src.count(old) != count:
            raise RuntimeError(f"{name}: {old!r} appears {src.count(old)} "
                               f"times in {SOURCE}, want {count}")
        (tree / SOURCE).write_text(src.replace(old, new))
    proc = subprocess.run([sys.executable, "-c", CHECK, str(tree)], cwd=tree,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: the check exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    cases = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    failed = [c for c in cases if c["failed"]]
    by_grad = {g: sum(g in c["failed"] for c in cases) for g in ("dq", "dk", "dv")}
    passed_cases = [f"{c['case']} {c['dtype']}" for c in cases if not c["failed"]]
    return {"fault": name, "breaks": what, "cases": len(cases),
            "cases_failed": len(failed), "failed_by_gradient": by_grad,
            "cases_passed": passed_cases if failed else "all"}


def main() -> int:
    if not torch.cuda.is_available():
        print("plant_faults: needs a CUDA device", file=sys.stderr)
        return 2
    ok = True
    with tempfile.TemporaryDirectory(prefix="plant_faults_") as tmp:
        for name in FAULTS:
            rec = run_fault(name, Path(tmp))
            caught = rec["cases_failed"] > 0
            rec["as_expected"] = not caught if name == "none" else caught
            ok = ok and rec["as_expected"]
            print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
