"""The program audit: each call family of the serving stack and the trainer
checked against its contract.

Counterpart of ``mingpt_distributed_tpu/analysis/hlo_audit.py``. The JAX
auditor reads the artifacts XLA lowers (the HLO text's collectives, the
executable's ``input_output_alias`` table, ``output_shardings`` and
``cost_analysis()``). The port runs eagerly and lowers nothing, so the
audit runs one call of each family and watches what the call does; each
check observes the property its JAX counterpart observes:

* **collectives**: every collective the call issues through
  ``parallel/distributed.py`` (its ``collective_observers``, under the JAX
  programs' op names) must be in the contract's ``allowed_collectives``,
  and none may carry a result of ``pool_leaf_elems`` elements or more
  (reducing an activation over tp is the design, moving the pool is the
  regression). Device<->host copies beyond the contract's
  ``host_transfers`` are findings too: on a card they are read from
  ``torch.profiler``'s memcpy events (the CUDA runtime's memcpy calls, less
  the device-to-device copies; a small pageable upload can leave no device
  record), and every copy also reaches ``note_host_transfer``. The JAX contract allows no host transfer inside
  its program; the port's families are audited through their public
  calls, whose copies all lie outside the counterpart of that program
  (the prompt's or the step's tokens going up, the sampler's parameters
  going up, the chosen tokens coming down), and the contracts count
  exactly those. The lockstep command broadcasts of a tp group are the
  dispatch, not the program: they are not collectives here.
* **donation -> in place**: the JAX executable aliases each donated pool
  leaf to its output; here each state leaf (the pool's K/V leaves, or the
  trainer's parameters) must keep its storage (``data_ptr``), the number
  of leaves the call wrote in place must equal the contract's ``donated``
  (at least ``donated_min``), a ``donated`` of 0 (``prefix_save``) must
  leave the state's values unchanged, and on a card the allocator must
  grow by less than one pool leaf (``pool_leaf_bytes``).
* **sharding**: each K/V leaf's local heads must equal the rank's tp
  share the contract names (``kv_local_heads``), where JAX compares the
  outputs' NamedSharding.
* **budget**: the ledger's analytic ``flops`` and ``bytes_accessed``
  (``telemetry/attribution.forward_cost``) must equal a committed budgets
  file exactly: this package's ``program_budgets.json`` (the repository
  root's file is the JAX package's).

:class:`AuditLedger` subclasses ``telemetry/attribution.ProgramLedger``:
the owners' ``register_attrib`` seams enumerate the families, so a family
is auditable exactly when it is attributable, and a family registered
without a contract (or never run) is itself a finding. The report is a
``graftaudit/1`` envelope with sorted keys (byte-identical across runs:
it holds nothing measured in time), with a human rendering and exit
codes 0 (clean), 1 (findings) and 2 (usage).
"""

from __future__ import annotations

import contextlib
import itertools
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mingpt_distributed_tpu_torch.analysis.core import EXIT_CLEAN, EXIT_FINDINGS
from mingpt_distributed_tpu_torch.parallel import distributed as D
from mingpt_distributed_tpu_torch.telemetry.attribution import ProgramLedger

__all__ = [
    "AUDIT_SCHEMA",
    "BUDGETS_SCHEMA",
    "AuditFinding",
    "AuditLedger",
    "Probe",
    "ProgramArtifact",
    "audit_exit_code",
    "audit_programs",
    "build_audit_report",
    "build_budget_section",
    "check_budgets",
    "dump_audit_report",
    "engine_probes",
    "note_host_transfer",
    "render_audit_human",
    "run_probes",
    "speculative_probes",
    "trainer_probes",
    "validate_audit_report",
]

AUDIT_SCHEMA = "graftaudit/1"
BUDGETS_SCHEMA = "graftaudit-budgets/1"

#: the K/V leaves of a pool (a quantized pool's scale planes are split
#: over the same heads)
KV_LEAVES = ("k", "v", "k_scale", "v_scale")

#: callables told of every device<->host copy of an audited call
transfer_observers: List[Callable[[str, int], None]] = []


def note_host_transfer(kind: str, nbytes: int) -> None:
    """Report one device<->host copy (``kind`` "HtoD" or "DtoH") to the
    audit watching the current call."""
    for fn in transfer_observers:
        fn(kind, int(nbytes))


# ---------------------------------------------------------------------
# what one call did
# ---------------------------------------------------------------------


@dataclass
class ProgramArtifact:
    """One (family, variant): the ledger's analytic cost, and what its
    audited call did (empty until ``run_probes`` ran it)."""

    family: str
    variant: str
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    ran: bool = False
    collectives: List[Dict[str, Any]] = field(default_factory=list)
    host_transfers: List[Dict[str, Any]] = field(default_factory=list)
    written: List[str] = field(default_factory=list)   # changed, storage kept
    moved: List[str] = field(default_factory=list)     # storage replaced
    alloc_growth: Optional[int] = None
    kv_local_heads: Dict[str, int] = field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.family}:{self.variant}" if self.variant else self.family


class AuditLedger(ProgramLedger):
    """A ProgramLedger that also keeps an artifact per registered (family,
    variant): ``register_attrib`` is the only seam, so anything that
    registers with the attribution ledger is audited."""

    def __init__(self, registry=None):
        super().__init__(registry=registry)
        self.artifacts: Dict[Tuple[str, str], ProgramArtifact] = {}

    def observe_compile(self, family: str, compile_s: float,
                        flops: Optional[float], bytes_accessed: Optional[float],
                        variant: str = "") -> None:
        super().observe_compile(family, compile_s, flops, bytes_accessed,
                                variant=variant)
        art = self.artifacts.setdefault((family, variant),
                                        ProgramArtifact(family, variant))
        if flops is not None:
            art.flops = float(flops)
        if bytes_accessed is not None:
            art.bytes_accessed = float(bytes_accessed)


@dataclass
class Probe:
    """How to run one call of a family: ``call`` runs it, ``state`` names
    the leaves it may write (the pool, or the parameters), ``setup`` runs
    first, unwatched; ``kv``: the state is a K/V pool."""

    call: Callable[[], Any]
    state: Callable[[], Dict[str, torch.Tensor]]
    setup: Optional[Callable[[], Any]] = None
    kv: bool = True


def _device_of(state: Dict[str, torch.Tensor]) -> Optional[torch.device]:
    return next((t.device for t in state.values()), None)


def _sync(device) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _watch(art: ProgramArtifact, device):
    """Record the collectives and host copies of the code inside."""
    colls, copies = art.collectives, art.host_transfers
    on_coll = lambda op, n: colls.append({"op": op, "elems": n})  # noqa: E731
    on_copy = lambda kind, n: copies.append({"kind": kind, "bytes": n})  # noqa: E731
    D.collective_observers.append(on_coll)
    transfer_observers.append(on_copy)
    prof = None
    if device is not None and device.type == "cuda":
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    try:
        yield
    finally:
        if prof is not None:
            _sync(device)
            prof.__exit__(None, None, None)
            _note_profiled_copies(prof.events())
        D.collective_observers.remove(on_coll)
        transfer_observers.remove(on_copy)


def _note_profiled_copies(events) -> None:
    """The device<->host copies among a profile's events: every memcpy
    call of the CUDA runtime (the host's record of a copy) but those whose
    device record is device-to-device. A device record alone would not do:
    a small upload from pageable memory can run without one."""
    calls = d2d = d2h = 0
    for ev in events:
        if ev.name.startswith("cudaMemcpy"):
            calls += 1
        elif ev.name.startswith(("Memcpy DtoD", "Memcpy PtoP")):
            d2d += 1
        elif ev.name.startswith("Memcpy DtoH"):
            d2h += 1
    for kind, n in (("DtoH", d2h), ("HtoD", calls - d2d - d2h)):
        for _ in range(n):
            note_host_transfer(kind, 0)


def run_probe(art: ProgramArtifact, probe: Probe) -> None:
    """Run one audited call and record what it did on ``art``."""
    if probe.setup is not None:
        probe.setup()
    before = probe.state()
    device = _device_of(before)
    saved = {n: (t.data_ptr(), t.clone()) for n, t in before.items()}
    _sync(device)
    alloc = (torch.cuda.memory_allocated(device)
             if device is not None and device.type == "cuda" else None)
    art.collectives, art.host_transfers = [], []
    with _watch(art, device):
        probe.call()
    _sync(device)
    if alloc is not None:
        art.alloc_growth = int(torch.cuda.memory_allocated(device)) - int(alloc)
    after = probe.state()
    art.moved = sorted(n for n, t in after.items() if t.data_ptr() != saved[n][0])
    art.written = sorted(n for n, t in after.items()
                         if n not in art.moved and not torch.equal(t, saved[n][1]))
    art.kv_local_heads = ({n: int(t.shape[3]) for n, t in after.items() if n in KV_LEAVES}
                          if probe.kv else {})
    art.ran = True


def run_probes(ledger: AuditLedger, probes: Dict[Tuple[str, str], Probe]) -> None:
    """Run each registered family's probe, in the probes' order."""
    for key, probe in probes.items():
        if key in ledger.artifacts:
            run_probe(ledger.artifacts[key], probe)


# ---------------------------------------------------------------------
# the probes: one call of each family through its owner's public calls
# ---------------------------------------------------------------------


def engine_probes(engine, family_prefix: str = "", slot: int = 0
                  ) -> Dict[Tuple[str, str], Probe]:
    """A ``DecodeEngine``'s families, in the order they can run: a prefill
    per ladder bucket, the decode step over every slot, then per storable
    bucket a prefix save from ``slot`` and a load into the next slot. Each
    call draws its tokens from a counter, so a call run again writes new
    values (a writer that wrote nothing new would read as read-only)."""
    pool = lambda: dict(engine.pool.cache)  # noqa: E731
    cfg, s = engine.cfg, engine.n_slots
    draws = itertools.count()

    def tokens(n):
        base = next(draws)
        return [1 + (base * 7 + i) % (cfg.vocab_size - 1) for i in range(n)]

    def prefill(at, prompt):
        engine.prefill_chunk_call(at, prompt, 0, 1.0, None, None, False, None)

    out: Dict[Tuple[str, str], Probe] = {}
    for b in engine.buckets:
        out[(family_prefix + "prefill", f"b{b}")] = Probe(
            lambda b=b: prefill(slot, tokens(b)), pool)
    out[(family_prefix + "decode", "")] = Probe(
        lambda: engine.decode_step(
            np.asarray(tokens(s), np.int64), np.full(s, cfg.block_size - 1),
            np.ones(s, np.float32), np.zeros(s, np.int64), np.ones(s, np.float32),
            np.zeros(s, bool), [None] * s), pool)
    if engine.prefix_store is not None:
        for b in (b for b in engine.buckets if b <= engine.prefill_len - 1):
            saved: List[List[int]] = []

            def fill(b=b, saved=saved):
                """A fresh prompt prefilled into ``slot``, to be saved."""
                saved[:] = [tokens(b + 1)]
                prefill(slot, saved[0])

            def stored(b=b, saved=saved):
                """A prompt in the store, and the load's slot scribbled."""
                fill(b, saved)
                engine.save_prefix(slot, saved[0])
                prefill((slot + 1) % s, [0] * (b + 1))

            out[(family_prefix + "prefix_save", f"b{b}")] = Probe(
                lambda saved=saved: engine.save_prefix(slot, saved[0]), pool, setup=fill)
            out[(family_prefix + "prefix_load", f"b{b}")] = Probe(
                lambda saved=saved: engine.try_load_prefix((slot + 1) % s, saved[0]),
                pool, setup=stored)
    return out


def speculative_probes(spec, family_prefix: str = "", slot: int = 0
                       ) -> Dict[Tuple[str, str], Probe]:
    """A ``SpeculativeDecoder``'s families: verify (its k + 1 rows at slot
    ``slot``), then the draft engine's under the ``draft_`` prefix."""
    tgt = spec.target
    draws = itertools.count()
    out = {(f"{family_prefix}verify", f"k{spec.k}"): Probe(
        lambda: spec.verify(slot, [1 + (next(draws) + i) % (tgt.cfg.vocab_size - 1)
                                   for i in range(spec.rows)], 0, 1.0, None, None),
        lambda: dict(tgt.pool.cache))}
    out.update(engine_probes(spec.draft.engine, f"{family_prefix}draft_", slot))
    return out


def trainer_probes(trainer, batch) -> Dict[Tuple[str, str], Probe]:
    """A ``GPTTrainer``'s train step on one (x, y) batch: its state is the
    parameters, which AdamW updates in place."""
    from mingpt_distributed_tpu_torch.models import convert

    return {("train_step", trainer._attrib_variant or "dense"): Probe(
        lambda: trainer._train_step(trainer.state, trainer._put_batch(batch),
                                    trainer.generator),
        lambda: convert.flatten(trainer.state.params), kv=False)}


# ---------------------------------------------------------------------
# findings + checks
# ---------------------------------------------------------------------


@dataclass(frozen=True)
class AuditFinding:
    """One contract violation of one audited call."""

    family: str
    variant: str
    check: str      # contract | collectives | donation | sharding | budget
    message: str

    @property
    def sort_key(self):
        return (self.family, self.variant, self.check, self.message)

    def to_dict(self) -> Dict[str, str]:
        return {"family": self.family, "variant": self.variant,
                "check": self.check, "message": self.message}

    def render(self) -> str:
        where = f"{self.family}:{self.variant}" if self.variant else self.family
        return f"{where} [{self.check}] {self.message}"


def _audit_one(art: ProgramArtifact, contract: Dict[str, Any]) -> List[AuditFinding]:
    f: List[AuditFinding] = []

    def finding(check: str, message: str) -> None:
        f.append(AuditFinding(art.family, art.variant, check, message))

    # (a) collectives and host copies
    allowed = set(contract.get("allowed_collectives", ()))
    pool_elems = contract.get("pool_leaf_elems")
    for i, item in enumerate(art.collectives):
        if item["op"] not in allowed:
            finding("collectives",
                    f"undeclared collective {item['op']!r} (call {i} of the family's "
                    f"collectives; allowed: {sorted(allowed) or 'none'})")
        elif pool_elems is not None and item["elems"] >= pool_elems:
            finding("collectives",
                    f"{item['op']!r} (call {i}) moves {item['elems']} elements — at "
                    f"least one whole KV pool buffer ({pool_elems}); collectives may "
                    f"touch activations, never the pool")
    copies = len(art.host_transfers)
    if copies > contract.get("host_transfers", 0):
        kinds = ",".join(sorted({c["kind"] for c in art.host_transfers}))
        finding("collectives",
                f"{copies} device<->host copies ({kinds}), the contract allows "
                f"{contract.get('host_transfers', 0)}")

    # (b) donation: the state written in place
    for name in art.moved:
        finding("donation",
                f"state leaf {name!r} was copied instead of written in place (its "
                f"storage moved)")
    got, want = len(art.written), contract.get("donated")
    want_min = contract.get("donated_min")
    if want is not None and got != want:
        finding("donation",
                f"the call wrote {got} state leaves in place, contract requires "
                f"exactly {want}" + (" (a read-only family changed the state)"
                                     if want == 0 else ""))
    elif want_min is not None and got < want_min:
        finding("donation",
                f"the call wrote {got} state leaves in place, contract requires at "
                f"least {want_min}")
    leaf_bytes = contract.get("pool_leaf_bytes")
    if leaf_bytes is not None and art.alloc_growth is not None \
            and art.alloc_growth >= leaf_bytes:
        finding("donation",
                f"the allocator grew by {art.alloc_growth} bytes, at least one pool "
                f"leaf ({leaf_bytes}): the call copied the pool")

    # (c) sharding: the K/V leaves' local heads
    want_heads = contract.get("kv_local_heads")
    if want_heads is not None:
        for name, heads in sorted(art.kv_local_heads.items()):
            if heads != want_heads:
                finding("sharding",
                        f"K/V leaf {name!r} holds {heads} heads on this rank, the "
                        f"contract names {want_heads} (the rank's tp share)")
    return f


def audit_programs(artifacts: Dict[Tuple[str, str], ProgramArtifact],
                   contracts: Dict[str, Dict[str, Any]]) -> List[AuditFinding]:
    """Checks (a)-(c) for every registered artifact against its family's
    contract. A family with no contract, or registered but never run, is a
    finding (check ``contract``): audit coverage is part of the suite."""
    findings: List[AuditFinding] = []
    for (family, variant) in sorted(artifacts):
        art = artifacts[(family, variant)]
        contract = contracts.get(family)
        if contract is None:
            findings.append(AuditFinding(
                family, variant, "contract",
                f"program family {family!r} is registered in the attribution "
                f"ledger but declares no audit contract — add one beside its "
                f"register_attrib"))
            continue
        if not art.ran:
            findings.append(AuditFinding(
                family, variant, "contract",
                f"program family {family!r} is registered but no audited call ran "
                f"it — give it a probe"))
            continue
        findings.extend(_audit_one(art, contract))
    return sorted(findings, key=lambda x: x.sort_key)


# ---------------------------------------------------------------------
# cost budgets (check d)
# ---------------------------------------------------------------------


def build_budget_section(artifacts: Dict[Tuple[str, str], ProgramArtifact]
                         ) -> Dict[str, Dict[str, Optional[float]]]:
    """The committed-budget entries of one sweep: the analytic cost per
    program key (``family`` or ``family:variant``)."""
    return {art.key: {"flops": art.flops, "bytes_accessed": art.bytes_accessed}
            for _, art in sorted(artifacts.items())}


def check_budgets(artifacts: Dict[Tuple[str, str], ProgramArtifact],
                  budgets: Optional[Dict[str, Dict[str, Optional[float]]]]
                  ) -> List[AuditFinding]:
    """Exact-match comparison against one sweep's committed budgets: the
    analytic costs are properties of the call family's shapes, so any
    drift is a real change. Bless it with ``tools/graftaudit.py
    --update-budgets`` or fix the regression."""
    findings: List[AuditFinding] = []
    budgets = budgets or {}
    seen = set()
    for (family, variant) in sorted(artifacts):
        art = artifacts[(family, variant)]
        seen.add(art.key)
        want = budgets.get(art.key)
        if want is None:
            findings.append(AuditFinding(
                family, variant, "budget",
                f"no committed budget for {art.key!r} — run tools/graftaudit.py "
                f"--update-budgets and commit the budgets file"))
            continue
        for metric, got in (("flops", art.flops), ("bytes_accessed", art.bytes_accessed)):
            if got != want.get(metric):
                findings.append(AuditFinding(
                    family, variant, "budget",
                    f"{metric} = {got!r} != committed budget {want.get(metric)!r} "
                    f"(exact-match: bless intentional changes with --update-budgets)"))
    for key in sorted(set(budgets) - seen):
        family, _, variant = key.partition(":")
        findings.append(AuditFinding(
            family, variant, "budget",
            f"committed budget entry {key!r} matches no registered program — "
            f"stale entry, regenerate with --update-budgets"))
    return sorted(findings, key=lambda x: x.sort_key)


# ---------------------------------------------------------------------
# graftaudit/1 report
# ---------------------------------------------------------------------

_CONTRACT_KEYS = ("donated", "donated_min", "host_transfers", "kv_local_heads",
                  "pool_leaf_bytes", "pool_leaf_elems")


def _contract_row(contract: Dict[str, Any]) -> Dict[str, Any]:
    row: Dict[str, Any] = {"allowed_collectives":
                           sorted(contract.get("allowed_collectives", ()))}
    row.update({k: contract[k] for k in _CONTRACT_KEYS if k in contract})
    return row


def build_audit_report(sweep: Dict[str, Any],
                       artifacts: Dict[Tuple[str, str], ProgramArtifact],
                       contracts: Dict[str, Dict[str, Any]],
                       findings: List[AuditFinding]) -> Dict[str, Any]:
    """The versioned envelope: counts and shapes only (nothing measured in
    time, no allocator readout), so two runs serialize byte-identically."""
    programs = []
    for (family, variant) in sorted(artifacts):
        art = artifacts[(family, variant)]
        counts: Dict[str, int] = {}
        for item in art.collectives:
            counts[item["op"]] = counts.get(item["op"], 0) + 1
        heads = sorted(set(art.kv_local_heads.values()))
        programs.append({
            "family": family,
            "variant": variant,
            "collectives": dict(sorted(counts.items())),
            "largest_collective_elems": max((c["elems"] for c in art.collectives),
                                            default=0),
            "host_transfers": len(art.host_transfers),
            "donated": len(art.written),
            "kv_local_heads": heads[0] if len(heads) == 1 else None,
            "flops": art.flops,
            "bytes_accessed": art.bytes_accessed,
        })
    by_check: Dict[str, int] = {}
    for f in findings:
        by_check[f.check] = by_check.get(f.check, 0) + 1
    return {
        "schema": AUDIT_SCHEMA,
        "sweep": dict(sweep),
        "programs": programs,
        "contracts": {fam: _contract_row(c) for fam, c in sorted(contracts.items())},
        "findings": [f.to_dict() for f in findings],
        "summary": {"programs": len(programs), "findings": len(findings),
                    "by_check": dict(sorted(by_check.items()))},
    }


_PROGRAM_KEYS = ("family", "variant", "collectives", "largest_collective_elems",
                 "host_transfers", "donated", "kv_local_heads", "flops",
                 "bytes_accessed")
_FINDING_KEYS = ("family", "variant", "check", "message")


def validate_audit_report(report: Dict[str, Any]) -> None:
    """Strict structural validation (raises ValueError)."""
    if report.get("schema") != AUDIT_SCHEMA:
        raise ValueError(f"not a {AUDIT_SCHEMA} report: schema={report.get('schema')!r}")
    if not isinstance(report.get("sweep"), dict):
        raise ValueError("sweep must be an object")
    progs = report.get("programs")
    if not isinstance(progs, list):
        raise ValueError("programs must be a list")
    seen = set()
    for i, row in enumerate(progs):
        missing = set(_PROGRAM_KEYS) - set(row)
        if missing:
            raise ValueError(f"programs[{i}] missing {sorted(missing)}")
        key = (row["family"], row["variant"])
        if key in seen:
            raise ValueError(f"duplicate program row {key}")
        seen.add(key)
        if min(row["donated"], row["largest_collective_elems"], row["host_transfers"]) < 0:
            raise ValueError(f"programs[{i}] has negative accounting")
    finds = report.get("findings")
    if not isinstance(finds, list):
        raise ValueError("findings must be a list")
    for i, row in enumerate(finds):
        missing = set(_FINDING_KEYS) - set(row)
        if missing:
            raise ValueError(f"findings[{i}] missing {sorted(missing)}")
    summary = report.get("summary")
    if not isinstance(summary, dict):
        raise ValueError("summary must be an object")
    if summary.get("programs") != len(progs):
        raise ValueError("summary.programs != len(programs)")
    if summary.get("findings") != len(finds):
        raise ValueError("summary.findings != len(findings)")


def dump_audit_report(report: Dict[str, Any]) -> str:
    """Canonical serialization: sorted keys, fixed indent."""
    return json.dumps(report, sort_keys=True, indent=2)


def render_audit_human(report: Dict[str, Any]) -> str:
    sweep = report["sweep"]
    lines = [f"graftaudit ({report['schema']}): {report['summary']['programs']} "
             f"programs audited, tp={sweep.get('tp')} on {sweep.get('device')}"]
    lines.append(f"  {'family':<20} {'variant':<8} {'collectives':<28} {'host':>5} "
                 f"{'donated':>7} {'flops':>12} {'bytes':>12}")
    for row in report["programs"]:
        colls = ",".join(f"{op}x{n}" for op, n in row["collectives"].items()) or "-"
        fl = "n/a" if row["flops"] is None else f"{row['flops']:.6g}"
        by = "n/a" if row["bytes_accessed"] is None else f"{row['bytes_accessed']:.6g}"
        lines.append(f"  {row['family']:<20} {row['variant']:<8} {colls:<28} "
                     f"{row['host_transfers']:>5} {row['donated']:>7} {fl:>12} {by:>12}")
    if report["findings"]:
        lines.append(f"{report['summary']['findings']} finding(s):")
        for row in report["findings"]:
            where = (f"{row['family']}:{row['variant']}" if row["variant"]
                     else row["family"])
            lines.append(f"  {where} [{row['check']}] {row['message']}")
    else:
        lines.append("clean: every audited call honours its contract")
    return "\n".join(lines)


def audit_exit_code(findings: List[AuditFinding]) -> int:
    return EXIT_FINDINGS if findings else EXIT_CLEAN
