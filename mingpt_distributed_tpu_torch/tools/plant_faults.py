"""Plant known faults in the flash-attention kernels and the ring, and show
that the on-card checks catch them.

For each fault below (and once with none, as the control), copies
``chip_smoke.py`` and this package into a temporary directory, rewrites one
source there, and runs ``chip_smoke.py``'s checks against the copy, which
builds the kernels of the source it changed (libraries already built here
come along and are reused where their source is unchanged: they are keyed
by a hash of it). A kernel fault (a source under ``ops/csrc``) runs
phase 1's kernel checks: ``fwd_case`` (K1) on every case of
``KERNEL_CASES`` and ``FWD_RING_CASES``, ``bwd_case`` (K2a, K2b) and
``fused_case`` (K2c) on every case of ``KERNEL_CASES`` and
``BWD_RING_CASES``, ``lse_case``
(K3, K4a, K4b) on every case of ``LSE_CASES`` and ``LSE_RING_CASES``, each
in bfloat16 and float32, ``nh_case`` (K5) on every case of ``NH_CASES`` and
``exp_case`` (K6) on every case of ``EXP_CASES``. An edit whose text does
not appear in the source as often as expected fails the tool before
anything runs. A ring fault (a Python source)
runs the sp phase's ranks and ``sp_checks``, and must fail the main path's
model-level group ("main") on its own: the step's loss, grad norm and
every parameter's gradient against the dense single-process step. The
control runs both. Prints one JSON line per fault with the checks that
failed. Exits 0 when the control passes every check and every fault is
caught; needs one CUDA device.

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

# name: (what it breaks, source in the package, [(text, its replacement, count)])
FAULTS = {
    "none": ("control: the kernels and the ring as committed", None, []),
    # both dq kernels (fp32, bf16) read delta as 0: ds = p * dp
    "dq_drops_delta": ("K2a/K4a drop delta", "ops/csrc/flash_bwd.cu",
                       [("p.delta[vec]", "0.f", 2)]),
    # the dk/dv kernels (fp32, bf16; and K2c's, which shares the fp32 one's
    # loop) stop one q tile short of the band's end
    "dkv_skips_last_q_tile": (
        "K2b/K4b/K5 dkv (and K2c) skip the last q tile of the band",
        "ops/csrc/flash_bwd.cu",
        [("for (int qt = qt_lo; qt <= qt_hi; ++qt) {",
          "for (int qt = qt_lo; qt < qt_hi; ++qt) {", 2),
         ("return max(0, qt_hi - *qt_lo + 1);  // q tiles per query head",
          "return max(0, qt_hi - *qt_lo);  // q tiles per query head", 1)]),
    # the dk/dv kernels (fp32, bf16) stop one q tile short of an offset band
    # only
    "dkv_offset_band_skips_last_q_tile": (
        "K4b skips the last q tile of an offset band", "ops/csrc/flash_bwd.cu",
        [("*hi = q_last < 0 ? -1 : q_last / BQ;",
          "*hi = q_last < 0 ? -1 : q_last / BQ - (p.q_offset > 0);", 1)]),
    # the bf16 dk/dv consumers release each Q/dO stage (and its lse and
    # delta) as soon as it has landed, before dV += P^T dO and dK += dS^T Q
    # have read it: the producer refills the stage under them once the ring
    # wraps
    "bwd_releases_stage_early": (
        "K2b/K4b/K5's bf16 dk/dv frees a Q/dO stage before its products retire",
        "ops/csrc/flash_bwd.cu",
        [("          hopper::mbar_wait(bar_full + 8 * stage, phase);\n"
          "          const int cls = tile_class<kLse>(p, q0, kDkvRows, kc0, kWgRows);\n",
          "          hopper::mbar_wait(bar_full + 8 * stage, phase);\n"
          "          hopper::mbar_arrive(bar_empty + 8 * stage);\n"
          "          const int cls = tile_class<kLse>(p, q0, kDkvRows, kc0, kWgRows);\n",
          1),
         ("          hopper::mbar_arrive(bar_empty + 8 * stage);  "
          "// Q, dO, lse and delta of this stage are read\n", "", 1)]),
    # the forward kernels (fp32, bf16) leave rows with no live key unwritten
    "fwd_dead_rows_unwritten": (
        "K3 leaves dead rows unwritten", "ops/csrc/flash_fwd.cu",
        [("  if (q_pos < p.T) {", "  if (q_pos < p.T && m > kNegInf) {", 1),
         ("        if (row[r] >= p.T) continue;",
          "        if (row[r] >= p.T || m[r] == kNegInf) continue;", 1)]),
    # the bf16 forward's consumers release each K/V stage as soon as it has
    # landed, before its products (P V above all) have read it: the
    # producer refills the stage under them once the ring wraps
    "fwd_releases_stage_early": (
        "K1/K3/K5's bf16 forward frees a K/V stage before its P V retires",
        "ops/csrc/flash_fwd.cu",
        [("        hopper::mbar_wait(bar_full + 8 * stage, phase);\n\n",
          "        hopper::mbar_wait(bar_full + 8 * stage, phase);\n"
          "        hopper::mbar_arrive(bar_empty + 8 * stage);\n", 1),
         ("        hopper::mbar_arrive(bar_empty + 8 * stage);  "
          "// K and V of this stage are read\n", "", 1)]),
    # the fused backward's dq (fp32, bf16) skips the first q tile of each k
    # tile's band: the diagonal cell
    "fused_dq_skips_diagonal_cell": (
        "K2c's dq skips the diagonal cell", "ops/csrc/flash_bwd.cu",
        [("      if (kFused) {\n        // dq += dS K over this cell",
          "      if (kFused && qt != qt_lo) {\n        // dq += dS K over this cell",
          1),
         ("      // dq += dS K over this cell: warp w's queries",
          "      if (qt == qt_lo) continue;  // dq += dS K over this cell: warp w's queries",
          1)]),
    # the natural-base forward (fp32, bf16) ignores the softcap
    "nh_fwd_drops_softcap": (
        "K5's forward drops the softcap", "ops/csrc/flash_fwd.cu",
        [("    return p.softcap > 0.f ? p.softcap * tanhf(s * (p.scale / p.softcap))\n"
          "                           : s * p.scale;",
          "    return s * p.scale;", 1),
         ("  if (p.softcap > 0.f) {\n    const float cap = kNat",
          "  if (!kNat && p.softcap > 0.f) {\n    const float cap = kNat", 1)]),
    # the exp-vs-exp2 chain runs one rep fewer than asked: at the tool's 64
    # reps every element has reached the chain's fixed point, so only the
    # checks at small reps can see it
    "exp_chain_one_rep_short": (
        "K6 runs reps - 1 steps", "ops/csrc/exp_exp2.cu",
        [("  for (int r = 0; r < reps; ++r) {", "  for (int r = 1; r < reps; ++r) {",
          1)]),
    # the zigzag ring drops the first hop's block from every late half
    "ring_skips_hop_fold": (
        "the zigzag ring skips one hop's fold", "parallel/ring_attention.py",
        [("        late = _fold(late, o_b, lse_b)\n",
          "        late = late if t == 1 else _fold(late, o_b, lse_b)\n", 1)]),
}

# run inside the copy: every K1, K2a/K2b, K2c, K3/K4, K5 and K6 case, one
# JSON line each
KERNEL_CHECK = """
import json, sys, torch
import chip_smoke
from mingpt_distributed_tpu_torch.ops import flash_attention as fa
from mingpt_distributed_tpu_torch.tools import exp_exp2 as ex
from mingpt_distributed_tpu_torch.tools import proto_nh_kernel as nh
assert fa.__file__.startswith(sys.argv[1]), fa.__file__


def report(rec, fails):
    print(json.dumps({"kernel": rec["kernel"], "case": rec["case"],
                      "dtype": rec["dtype"], "reps": rec.get("reps"),
                      "failed": sorted({g for g, _ in fails})}), flush=True)


for check, cases in ((chip_smoke.fwd_case,
                      chip_smoke.KERNEL_CASES + chip_smoke.FWD_RING_CASES),
                     (chip_smoke.bwd_case,
                      chip_smoke.KERNEL_CASES + chip_smoke.BWD_RING_CASES),
                     (chip_smoke.fused_case,
                      chip_smoke.KERNEL_CASES + chip_smoke.BWD_RING_CASES),
                     (chip_smoke.lse_case,
                      chip_smoke.LSE_CASES + chip_smoke.LSE_RING_CASES)):
    for i, case in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            report(*check(fa, i, case, dtype))
for i, case in enumerate(chip_smoke.NH_CASES):
    report(*chip_smoke.nh_case(nh, i, case))
for i, case in enumerate(chip_smoke.EXP_CASES):
    report(*chip_smoke.exp_case(ex, i, case))
"""

# run inside the copy: the sp phase's ranks and checks, one JSON line
SP_CHECK = """
import json, sys
import chip_smoke
from mingpt_distributed_tpu_torch.ops import _build
from mingpt_distributed_tpu_torch.parallel import ring_attention
from mingpt_distributed_tpu_torch.parallel.spawn import run_ranks
assert ring_attention.__file__.startswith(sys.argv[1]), ring_attention.__file__
_build.build_all()
ranks = run_ranks(chip_smoke.sp_rank, chip_smoke.SP, timeout_s=900)
records, fails = chip_smoke.sp_checks(ranks, card="")
keys = ("losses", "dense_losses", "grad_norms", "dense_grad_norms",
        "grad_max_rel_err", "grad_worst_param", "grad_total_rel_err")
print(json.dumps({"failed": sorted({g for g, _ in fails}),
                  "messages": [m for _, m in fails],
                  "steps": {r["phase"]: {k: r[k] for k in keys}
                            for r in records if "grad_rel_err" in r}}), flush=True)
"""


def patch(source: str, edits) -> str:
    """The source with every edit applied; raises when a text does not
    appear exactly as often as expected."""
    for old, new, count in edits:
        if source.count(old) != count:
            raise RuntimeError(f"{old!r} appears {source.count(old)} times, "
                               f"want {count}")
        source = source.replace(old, new)
    return source


def _run(name: str, script: str, tree: Path) -> list:
    proc = subprocess.run([sys.executable, "-c", script, str(tree)], cwd=tree,
                          capture_output=True, text=True, timeout=1500)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: the check exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


def _kernel_record(cases: list) -> dict:
    failed = [c for c in cases if c["failed"]]
    exp = [c for c in cases if c["kernel"] == "exp_chain"]
    return {"cases": len(cases), "cases_failed": len(failed),
            "failed_by_check": {g: sum(g in c["failed"] for c in cases)
                                for g in ("fwd", "dq", "dk", "dv", "exp")},
            "exp_failed_by_reps": {r: sum(bool(c["failed"]) for c in exp if c["reps"] == r)
                                   for r in sorted({c["reps"] for c in exp})},
            "failed_cases": [f"{c['kernel']} {c['case']} {c['dtype']}: {c['failed']}"
                             for c in failed]}


def run_fault(name: str, tmp: Path) -> dict:
    what, source, edits = FAULTS[name]
    tree = tmp / name
    shutil.copytree(ROOT / PACKAGE, tree / PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", tree / "chip_smoke.py")
    if source is not None:
        path = tree / PACKAGE / source
        path.write_text(patch(path.read_text(), edits))
    rec = {"fault": name, "breaks": what}
    if source is None or source.endswith(".cu"):
        rec["kernels"] = _kernel_record(_run(name, KERNEL_CHECK, tree))
    if source is None or source.endswith(".py"):
        (rec["sp"],) = _run(name, SP_CHECK, tree)
    kernels_caught = rec.get("kernels", {}).get("cases_failed", 0) > 0
    sp_failed = rec.get("sp", {}).get("failed", [])
    if name == "none":
        rec["as_expected"] = not kernels_caught and not sp_failed
    elif source.endswith(".cu"):
        rec["as_expected"] = kernels_caught
    else:  # the model-level gate must see a broken ring by itself
        rec["as_expected"] = "main" in sp_failed
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("plant_faults: needs a CUDA device", file=sys.stderr)
        return 2
    from mingpt_distributed_tpu_torch.ops import _build

    for name, (_, source, edits) in FAULTS.items():  # every anchor, before any run
        if source is not None:
            patch((ROOT / PACKAGE / source).read_text(), edits)
    _build.build_all()  # once here; each copy rebuilds only what it changed
    ok = True
    with tempfile.TemporaryDirectory(prefix="plant_faults_") as tmp:
        for name in FAULTS:
            rec = run_fault(name, Path(tmp))
            ok = ok and rec["as_expected"]
            print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
