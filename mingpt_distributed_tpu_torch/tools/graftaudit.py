"""graftaudit: the program audit over every call family of the serving
stack and the trainer (checks in ``analysis/program_audit.py``).

Counterpart of ``tools/graftaudit.py``. It builds the JAX tool's canonical
stack: the serve CLI's ``--selftest-sharded`` tiny GPT (2 layers, 2 heads,
width 32, vocab 96, block 48, float32, weights from seed 0), a 2-slot
engine with a {8, 48} prefill ladder and the prefix store, a k = 2
speculative decoder whose draft is the same model, and the int8-pool twin
of both (families under the ``q8_`` prefix); on the tp = 1 sweep also the
tiny trainer. Each owner registers its families through
``register_attrib`` into an ``AuditLedger``; the engines are warmed up,
then one call of each family runs and is checked against its contract
(collectives, device<->host copies, in-place pool writes, the K/V leaves'
local heads) and against the committed analytic budgets.

    python -m mingpt_distributed_tpu_torch.tools.graftaudit [--tp {1,2}]
        [--json] [--budgets FILE] [--no-budgets] [--update-budgets]
        [--device cpu]

``--tp 2`` makes this process the driver of a tp = 2 group whose follower
is a second process, joined over gloo (the tp serving tests' way; two
ranks sharing one card on a GPU). ``--device`` defaults to CUDA, as every
entry point of the port; ``--device cpu`` runs it here. Budgets: the
package's ``analysis/program_budgets.json`` holds each sweep's exact
analytic flops and bytes (``tp1``, ``tp2``); drift is a finding and
``--update-budgets`` re-records the sweep's section. Exit codes: 0 clean,
1 findings, 2 usage or build error. The ``--json`` envelope
(``graftaudit/1``) is byte-identical across runs of one sweep.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile

import torch

from mingpt_distributed_tpu_torch.analysis import program_audit as pa

DEFAULT_BUDGETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                               "analysis", "program_budgets.json")
CFG = dict(n_layer=2, n_head=2, n_embd=32, vocab_size=96, block_size=48,
           embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
CORPUS = ("graftaudit runs one call of every program family to audit its "
          "collectives and its in-place writes. " * 24)


def build_serving(device, mesh=None):
    """The canonical stack, as builders of (engine, speculative decoder,
    family prefix): the float32 pool and its int8 twin. A tp group's
    follower holds one target engine at a time, so each is built when its
    turn comes."""
    from mingpt_distributed_tpu_torch.config import GPTConfig
    from mingpt_distributed_tpu_torch.models import gpt
    from mingpt_distributed_tpu_torch.serving.engine import DecodeEngine
    from mingpt_distributed_tpu_torch.serving.speculative import SpeculativeDecoder

    cfg = GPTConfig.make(**CFG)
    params = gpt.init(cfg, torch.Generator().manual_seed(0), device=device)

    def build(kv_dtype, prefix):
        engine = DecodeEngine(params, cfg, n_slots=2, prefill_buckets=(8, 48),
                              prefix_cache_mb=0.5, mesh=mesh, kv_dtype=kv_dtype,
                              device=device)
        return engine, SpeculativeDecoder(engine, params, cfg, k=2), prefix

    return [lambda: build(None, ""), lambda: build("int8", "q8_")]


def build_trainer(tmpdir: str, device):
    """The tiny one-process trainer whose ``train_step`` the tp = 1 sweep
    audits (the JAX tool's: block 16, batch 16, no dropout)."""
    from mingpt_distributed_tpu_torch.config import (
        DataConfig,
        GPTConfig,
        OptimizerConfig,
        TrainerConfig,
    )
    from mingpt_distributed_tpu_torch.data.char_dataset import CharDataset
    from mingpt_distributed_tpu_torch.training.trainer import GPTTrainer

    ds = CharDataset(DataConfig.make(block_size=16), text=CORPUS)
    train, test = ds.split()
    gcfg = GPTConfig.make(**dict(CFG, vocab_size=ds.vocab_size, block_size=16))
    tcfg = TrainerConfig.make(max_epochs=1, batch_size=16, grad_norm_clip=1.0,
                              save_every=100, log_every=1000, seed=7,
                              snapshot_path=os.path.join(tmpdir, "snap.pt"))
    return GPTTrainer(tcfg, gcfg, OptimizerConfig(learning_rate=1e-2), train, test,
                      device=device)


def audit(stacks, trainer=None, ledger=None):
    """Build, register, warm up and run every family of ``stacks``
    (builders of (engine, speculative decoder or None, family prefix)),
    one stack at a time, then ``trainer``'s: (the ledger, the contracts,
    the findings of checks a-c)."""
    ledger = ledger if ledger is not None else pa.AuditLedger()
    contracts = {}
    for build in stacks:
        engine, spec, prefix = build()
        engine.register_attrib(ledger, family_prefix=prefix)
        contracts.update(engine.audit_contracts(family_prefix=prefix))
        engine.warmup()
        probes = pa.engine_probes(engine, prefix)
        if spec is not None:
            spec.register_attrib(ledger, family_prefix=prefix)
            contracts.update(spec.audit_contracts(family_prefix=prefix))
            spec.warmup()
            probes.update(pa.speculative_probes(spec, prefix))
        pa.run_probes(ledger, probes)
    if trainer is not None:
        trainer.register_attrib(ledger, lambda: 0.0)
        contracts.update(trainer.audit_contracts())
        batch = next(iter(trainer.train_iter.epoch_batches()))
        pa.run_probes(ledger, pa.trainer_probes(trainer, batch))
    return ledger, contracts, pa.audit_programs(ledger.artifacts, contracts)


def load_budgets(path: str) -> dict:
    """The committed budgets document, or a fresh skeleton when the file
    does not exist yet; ValueError for a file of another schema."""
    if not os.path.exists(path):
        return {"schema": pa.BUDGETS_SCHEMA, "sweeps": {}}
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != pa.BUDGETS_SCHEMA:
        raise ValueError(f"{path}: not a {pa.BUDGETS_SCHEMA} document "
                         f"(schema={doc.get('schema')!r})")
    if not isinstance(doc.get("sweeps"), dict):
        raise ValueError(f"{path}: sweeps must be an object")
    return doc


def report(ledger, contracts, findings, sweep: dict, budgets_doc=None,
           sweep_key: str = ""):
    """The findings with the budget check (unless ``budgets_doc`` is None)
    and the validated ``graftaudit/1`` envelope."""
    if budgets_doc is not None:
        findings = sorted(findings + pa.check_budgets(
            ledger.artifacts, budgets_doc["sweeps"].get(sweep_key)),
            key=lambda x: x.sort_key)
    rep = pa.build_audit_report(sweep, ledger.artifacts, contracts, findings)
    pa.validate_audit_report(rep)
    return findings, rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="graftaudit", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tp", type=int, default=1, choices=(1, 2),
                    help="tensor-parallel extent of the audited serving mesh")
    ap.add_argument("--json", action="store_true",
                    help="emit the graftaudit/1 envelope instead of the table")
    ap.add_argument("--budgets", default=DEFAULT_BUDGETS, metavar="FILE",
                    help="committed cost budgets (default: the package's "
                         "analysis/program_budgets.json)")
    ap.add_argument("--no-budgets", action="store_true", help="skip the budget check")
    ap.add_argument("--update-budgets", action="store_true",
                    help="re-record this sweep's budgets in FILE")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from mingpt_distributed_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device)
        budgets_doc = load_budgets(args.budgets)
    except (OSError, RuntimeError, ValueError) as e:
        print(f"graftaudit: {e}", file=sys.stderr)
        return 2
    group = None
    # build and registration chatter goes to stderr: --json stdout stays one
    # document
    with contextlib.redirect_stdout(sys.stderr), tempfile.TemporaryDirectory() as tmp:
        try:
            if args.tp > 1:
                from mingpt_distributed_tpu_torch.parallel.mesh import TP_TIMEOUT_S
                from mingpt_distributed_tpu_torch.serving.lockstep import TPGroup

                group = TPGroup(args.tp, "gloo", device, TP_TIMEOUT_S)
                stacks = build_serving(group.device, group.mesh)
            else:
                stacks = build_serving(device)
            trainer = build_trainer(tmp, device) if args.tp == 1 else None
            ledger, contracts, findings = audit(stacks, trainer)
            if trainer is not None:
                trainer.close()
        finally:
            if group is not None:
                exits = group.close()
    if group is not None and exits != [0]:
        print(f"graftaudit: tp follower exit codes {exits}", file=sys.stderr)
        return 2
    sweep_key = f"tp{args.tp}"
    if args.update_budgets:
        budgets_doc["sweeps"][sweep_key] = pa.build_budget_section(ledger.artifacts)
        with open(args.budgets, "w") as f:
            json.dump(budgets_doc, f, sort_keys=True, indent=2)
            f.write("\n")
        print(f"graftaudit: recorded {sweep_key} budgets for "
              f"{len(ledger.artifacts)} programs in {args.budgets}", file=sys.stderr)
    findings, rep = report(ledger, contracts, findings,
                           {"tp": args.tp, "device": device.type},
                           None if args.no_budgets else budgets_doc, sweep_key)
    print(pa.dump_audit_report(rep) if args.json else pa.render_audit_human(rep))
    return pa.audit_exit_code(findings)


if __name__ == "__main__":
    sys.exit(main())
