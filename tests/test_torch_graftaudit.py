"""The port's program audit (``analysis/program_audit.py``,
``tools/graftaudit.py``) and ``tools/perf_diff.py``: one counterpart for
each case of ``tests/test_graftaudit.py``, the cases of
``tests/test_attribution.py``'s perf_diff section, and parity checks
against the JAX perf_diff.

The JAX cases parse synthetic HLO text and lowered programs; the port's
audit watches an eager call, so each counterpart plants the same fault
in a call: a collective reported through ``distributed``'s observers, a
host copy through ``note_host_transfer``, a pool leaf replaced by a copy.
The tiny engine is the JAX test's (2 layers, width 32, vocab 50, block
32, buckets {4, 32}, the prefix store); the CLI sweeps (tp 1 in this
process's CPU, tp 2 with a follower process over gloo) must exit 0
against the committed budgets and print byte-identical ``--json`` twice.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mingpt_distributed_tpu_torch.analysis.program_audit import (
    AUDIT_SCHEMA,
    BUDGETS_SCHEMA,
    AuditLedger,
    Probe,
    ProgramArtifact,
    audit_programs,
    build_audit_report,
    build_budget_section,
    check_budgets,
    dump_audit_report,
    engine_probes,
    note_host_transfer,
    run_probe,
    run_probes,
    speculative_probes,
    validate_audit_report,
)
from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models import gpt
from mingpt_distributed_tpu_torch.parallel import distributed as D
from mingpt_distributed_tpu_torch.serving.engine import DecodeEngine
from mingpt_distributed_tpu_torch.serving.speculative import SpeculativeDecoder
from mingpt_distributed_tpu_torch.telemetry.attribution import (
    ProgramLedger,
    build_attrib_report,
    dump_attrib_report,
)
from mingpt_distributed_tpu_torch.telemetry.registry import MetricsRegistry
from mingpt_distributed_tpu_torch.tools import graftaudit
from mingpt_distributed_tpu_torch.tools import perf_diff
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGETS = os.path.join(REPO, "mingpt_distributed_tpu_torch", "analysis",
                       "program_budgets.json")
sys.path.insert(0, os.path.join(REPO, "tools"))

import perf_diff as j_perf_diff  # noqa: E402  (the JAX tool, by path)


# ---------------------------------------------------------------------
# the collective and host-copy inventories of a watched call
# ---------------------------------------------------------------------


def _state():
    """A toy pool: (layers, slots, rows, KV heads, head dim) leaves."""
    return {"k": torch.zeros(1, 2, 4, 2, 4), "v": torch.zeros(1, 2, 4, 2, 4)}


def _watched(call, state=None, kv=True):
    """Run ``call`` as an audited family over ``state`` -> its artifact."""
    state = _state() if state is None else state
    art = ProgramArtifact("decode", "", 1.0, 1.0)

    def both():
        state["k"].add_(1.0)
        state["v"].add_(1.0)
        call()

    run_probe(art, Probe(both, lambda: dict(state), kv=kv))
    return art


def test_collective_inventory_of_a_watched_call():
    """Every collective reaches the observers in order with its result's
    elements; nothing outside the watched call is recorded."""
    D.observe_collective("all-reduce", 99)  # before: not recorded
    art = _watched(lambda: (D.observe_collective("all-gather", 256),
                            D.observe_collective("all-reduce", 64),
                            D.observe_collective("collective-permute", 256)))
    assert [c["op"] for c in art.collectives] == ["all-gather", "all-reduce",
                                                 "collective-permute"]
    assert [c["elems"] for c in art.collectives] == [256, 64, 256]
    assert not D.collective_observers  # the watch removed its observer
    rep = build_audit_report({}, {("decode", ""): art}, {}, [])
    assert rep["programs"][0]["collectives"] == {"all-gather": 1, "all-reduce": 1,
                                                "collective-permute": 1}
    assert rep["programs"][0]["largest_collective_elems"] == 256


def test_host_transfer_through_the_hook_is_finding():
    art = _watched(lambda: note_host_transfer("DtoH", 64))
    assert art.host_transfers == [{"kind": "DtoH", "bytes": 64}]
    findings = audit_programs({("decode", ""): art},
                              {"decode": {"allowed_collectives": ("all-reduce",),
                                          "donated": 2}})
    assert [f.check for f in findings] == ["collectives"]
    assert "device<->host" in findings[0].message
    # the contract's allowance covers the designed copies
    assert audit_programs({("decode", ""): art},
                          {"decode": {"donated": 2, "host_transfers": 1}}) == []


def test_profiled_copies_are_the_runtime_memcpy_calls_less_device_copies():
    """On a card the host copies come from the profiler: every memcpy call
    of the CUDA runtime but the device-to-device ones. A small pageable
    upload may leave no device record, so its runtime call counts it."""
    from types import SimpleNamespace

    from mingpt_distributed_tpu_torch.analysis import program_audit as pa

    events = [SimpleNamespace(name=n) for n in
              ["cudaMemcpyAsync"] * 29 + ["Memcpy DtoD (Device -> Device)"] * 24
              + ["Memcpy HtoD (Pageable -> Device)"] * 3
              + ["Memcpy DtoH (Device -> Pinned)", "cudaLaunchKernel", "Memset (Device)"]]
    art = _watched(lambda: pa._note_profiled_copies(events))
    assert sorted(c["kind"] for c in art.host_transfers) == ["DtoH"] + ["HtoD"] * 4


def test_in_place_count_of_a_watched_call():
    assert _watched(lambda: None).written == ["k", "v"]
    state = _state()
    art = ProgramArtifact("prefix_save", "b4", 1.0, 1.0)
    run_probe(art, Probe(lambda: state["k"].sum(), lambda: dict(state)))
    assert art.written == [] and art.moved == []
    rep = build_audit_report({}, {("prefix_save", "b4"): art}, {}, [])
    assert rep["programs"][0]["donated"] == 0


def test_undeclared_collective_is_finding():
    art = _watched(lambda: (D.observe_collective("all-gather", 8),
                            D.observe_collective("collective-permute", 8)))
    findings = audit_programs({("decode", ""): art}, {"decode": {
        "allowed_collectives": ("all-gather", "all-reduce"), "donated": 2}})
    assert [f.check for f in findings] == ["collectives"]
    assert "collective-permute" in findings[0].message


def test_pool_sized_collective_is_finding():
    art = _watched(lambda: D.observe_collective("all-gather", 64))
    contract = {"allowed_collectives": ("all-gather",), "donated": 2,
                "pool_leaf_elems": 64}
    findings = audit_programs({("decode", ""): art}, {"decode": contract})
    assert findings and all(f.check == "collectives" for f in findings)
    assert "KV" in findings[0].message and "64" in findings[0].message


def test_missing_contract_is_finding():
    art = ProgramArtifact("mystery", "b8", 1.0, 1.0, ran=True)
    findings = audit_programs({("mystery", "b8"): art}, {})
    assert [(f.family, f.check) for f in findings] == [("mystery", "contract")]
    assert "no audit contract" in findings[0].message
    never = ProgramArtifact("decode", "", 1.0, 1.0)  # registered, never run
    findings = audit_programs({("decode", ""): never}, {"decode": {"donated": 2}})
    assert [f.check for f in findings] == ["contract"]


def test_sharding_drift_is_finding():
    art = _watched(lambda: None)
    assert art.kv_local_heads == {"k": 2, "v": 2}
    ok = {"decode": {"donated": 2, "kv_local_heads": 2}}
    assert audit_programs({("decode", ""): art}, ok) == []
    findings = audit_programs({("decode", ""): art},
                              {"decode": {"donated": 2, "kv_local_heads": 1}})
    assert [f.check for f in findings] == ["sharding", "sharding"]


# ---------------------------------------------------------------------
# in place: the pool's storage survives the call
# ---------------------------------------------------------------------


def test_in_place_write_verified():
    art = _watched(lambda: None)
    assert audit_programs({("decode", ""): art},
                          {"decode": {"allowed_collectives": (), "donated": 2}}) == []


def test_pool_copied_instead_of_written_in_place_is_finding(engine):
    """The silent fallback: a call that builds a new pool leaf where it
    should write in place still serves correct tokens; the audit names
    it (the JAX case: donation dropped, HBM doubles)."""
    ledger = _register(engine)
    probes = engine_probes(engine)
    key = ("decode", "")
    call = probes[key].call

    def copying():
        engine.pool.cache["k"] = engine.pool.cache["k"].clone()
        call()

    probes[key] = Probe(copying, probes[key].state)
    run_probes(ledger, probes)
    findings = [f for f in audit_programs(ledger.artifacts, engine.audit_contracts())
                if f.family == "decode"]
    assert [f.check for f in findings] == ["donation", "donation"]
    assert any("storage moved" in f.message for f in findings)
    # a read-only family that writes is named too
    probes = engine_probes(engine)
    save = probes[("prefix_save", "b4")]
    probes[("prefix_save", "b4")] = Probe(
        lambda: (save.call(), engine.pool.cache["v"].add_(1.0)), save.state, save.setup)
    ledger = _register(engine)
    run_probes(ledger, probes)
    findings = [f for f in audit_programs(ledger.artifacts, engine.audit_contracts())
                if f.family == "prefix_save"]
    assert len(findings) == 1 and "read-only" in findings[0].message


# ---------------------------------------------------------------------
# the tiny engine end to end
# ---------------------------------------------------------------------

CFG = dict(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32,
           embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")


@pytest.fixture(scope="module")
def engine():
    cfg = GPTConfig.make(**CFG)
    params = gpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = DecodeEngine(params, cfg, n_slots=2, prefill_buckets=(4, 32),
                       prefix_cache_mb=0.5, device="cpu")
    eng.warmup()
    return eng


def _register(engine):
    ledger = AuditLedger()
    engine.register_attrib(ledger)
    return ledger


def _audited(engine):
    ledger = _register(engine)
    run_probes(ledger, engine_probes(engine))
    return ledger


def test_every_engine_family_has_a_contract(engine):
    ledger = _register(engine)
    contracts = engine.audit_contracts()
    families = {family for (family, _) in ledger.artifacts}
    assert families == {"prefill", "decode", "prefix_save", "prefix_load"}
    assert families <= set(contracts)
    spec = SpeculativeDecoder(engine, engine.params, engine.cfg, k=2)
    spec.register_attrib(ledger)
    spec_families = {f for (f, _) in ledger.artifacts} - families
    assert spec_families and spec_families <= set(spec.audit_contracts())
    run_probes(ledger, {**engine_probes(engine), **speculative_probes(spec)})
    assert not [f for f in audit_programs(ledger.artifacts,
                                          {**contracts, **spec.audit_contracts()})
                if f.check == "contract"]


def test_tiny_engine_audits_clean(engine):
    ledger = _audited(engine)
    contracts = engine.audit_contracts()
    findings = audit_programs(ledger.artifacts, contracts)
    assert findings == [], [f.render() for f in findings]
    for (family, variant), art in ledger.artifacts.items():
        assert art.ran and art.collectives == [] and art.moved == [], (family, variant)
        assert len(art.written) == contracts[family]["donated"], (family, variant)
        assert set(art.kv_local_heads.values()) == {engine.cfg.kv_heads}


def test_audit_report_byte_identical_across_runs(engine):
    sweep = {"tp": 1, "device": "cpu"}

    def one():
        ledger = _audited(engine)
        contracts = engine.audit_contracts()
        findings = audit_programs(ledger.artifacts, contracts)
        return dump_audit_report(build_audit_report(sweep, ledger.artifacts, contracts,
                                                    findings))

    a, b = one(), one()
    assert a == b
    report = json.loads(a)
    validate_audit_report(report)
    assert report["schema"] == AUDIT_SCHEMA
    assert report["summary"]["findings"] == 0


def test_validate_audit_report_rejects_tampering(engine):
    ledger = _audited(engine)
    report = build_audit_report({"tp": 1}, ledger.artifacts, engine.audit_contracts(), [])
    validate_audit_report(report)
    bad = json.loads(dump_audit_report(report))
    bad["summary"]["programs"] += 1
    with pytest.raises(ValueError, match="summary.programs"):
        validate_audit_report(bad)
    bad2 = json.loads(dump_audit_report(report))
    del bad2["programs"][0]["donated"]
    with pytest.raises(ValueError, match="missing"):
        validate_audit_report(bad2)
    with pytest.raises(ValueError, match="schema"):
        validate_audit_report({"schema": "nope/1"})


# ---------------------------------------------------------------------
# cost budgets: exact match, missing, stale
# ---------------------------------------------------------------------


def _art(family, variant="", flops=100.0, byts=200.0):
    return ProgramArtifact(family, variant, flops, byts, ran=True)


def test_budget_exact_match_and_drift():
    arts = {("decode", ""): _art("decode")}
    budgets = {"decode": {"flops": 100.0, "bytes_accessed": 200.0}}
    assert check_budgets(arts, budgets) == []
    budgets["decode"]["bytes_accessed"] = 200.0000001
    findings = check_budgets(arts, budgets)
    assert [f.check for f in findings] == ["budget"]
    assert "--update-budgets" in findings[0].message


def test_budget_missing_and_stale_entries():
    arts = {("decode", ""): _art("decode"), ("prefill", "b8"): _art("prefill", "b8")}
    budgets = {"decode": {"flops": 100.0, "bytes_accessed": 200.0},
               "retired:b4": {"flops": 1.0, "bytes_accessed": 1.0}}
    msgs = {f.family: f.message for f in check_budgets(arts, budgets)}
    assert "no committed budget" in msgs["prefill"]
    assert "stale entry" in msgs["retired"]
    assert len(check_budgets(arts, None)) == 2


def test_budget_section_roundtrip():
    arts = {("prefill", "b8"): _art("prefill", "b8", 7.0, 9.0),
            ("decode", ""): _art("decode", "", 3.0, 4.0)}
    section = build_budget_section(arts)
    assert section == {"prefill:b8": {"flops": 7.0, "bytes_accessed": 9.0},
                       "decode": {"flops": 3.0, "bytes_accessed": 4.0}}
    assert check_budgets(arts, section) == []


def test_committed_budgets_file_is_valid():
    """The port's own file (the repository root's is the JAX package's):
    both sweeps, decode in each, train_step only at tp 1."""
    with open(BUDGETS) as f:
        doc = json.load(f)
    assert doc["schema"] == BUDGETS_SCHEMA
    assert {"tp1", "tp2"} <= set(doc["sweeps"])
    for sweep, progs in doc["sweeps"].items():
        assert "decode" in progs
        for key, metrics in progs.items():
            assert set(metrics) == {"flops", "bytes_accessed"}, (sweep, key)
    assert "train_step:dense" in doc["sweeps"]["tp1"]
    assert "train_step:dense" not in doc["sweeps"]["tp2"]
    assert graftaudit.load_budgets(BUDGETS) == doc


@pytest.mark.parametrize("tp", [1, 2])
def test_cli_sweep_is_clean_and_byte_identical(tp):
    """``tools/graftaudit.py --tp N --device cpu --json`` twice: exit 0
    against the committed budgets, the same bytes both times."""
    cmd = [sys.executable, "-m", "mingpt_distributed_tpu_torch.tools.graftaudit",
           "--tp", str(tp), "--device", "cpu", "--json"]
    outs = []
    for _ in range(2):
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=240,
                              env=dict(os.environ, PYTHONPATH=REPO))
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        outs.append(proc.stdout)
    assert outs[0] == outs[1]
    rep = json.loads(outs[0])
    validate_audit_report(rep)
    assert rep["summary"]["findings"] == 0 and rep["sweep"]["tp"] == tp
    rows = {(r["family"], r["variant"]): r for r in rep["programs"]}
    assert ("train_step", "dense") in rows if tp == 1 else ("train_step", "dense") not in rows
    decode = rows[("decode", "")]
    assert decode["collectives"] == ({} if tp == 1 else {"all-reduce": 6})
    assert decode["kv_local_heads"] == 2 // tp and decode["donated"] == 2
    assert rows[("q8_decode", "")]["donated"] == 4  # the scale planes too


def test_budget_drift_fails_the_cli(tmp_path):
    with open(BUDGETS) as f:
        doc = json.load(f)
    doc["sweeps"]["tp1"]["decode"]["flops"] += 1.0
    drifted = tmp_path / "budgets.json"
    drifted.write_text(json.dumps(doc))
    assert graftaudit.main(["--device", "cpu", "--budgets", str(drifted)]) == 1
    wrong = tmp_path / "wrong.json"
    wrong.write_text(json.dumps({"schema": "nope/1"}))
    assert graftaudit.main(["--device", "cpu", "--budgets", str(wrong)]) == 2


# ---------------------------------------------------------------------
# perf_diff: budgets mode
# ---------------------------------------------------------------------


def _budget_doc():
    return {"schema": BUDGETS_SCHEMA, "sweeps": {
        "tp1": {"decode": {"flops": 100.0, "bytes_accessed": 200.0}},
        "tp2": {"decode": {"flops": 50.0, "bytes_accessed": 90.0}}}}


def test_perf_diff_classifies_budgets():
    assert perf_diff.classify("x.json", _budget_doc()) == "budgets"


def test_perf_diff_budgets_same_and_regressed():
    a, b = _budget_doc(), _budget_doc()
    diff = perf_diff.diff_budget_reports(a, b)
    assert diff["regressions"] == 0
    assert all(r["verdict"] == "same" for r in diff["metrics"])
    b["sweeps"]["tp2"]["decode"]["bytes_accessed"] = 180.0
    b["sweeps"]["tp1"]["decode"]["flops"] = 80.0
    diff = perf_diff.diff_budget_reports(a, b)
    verdicts = {r["metric"]: r["verdict"] for r in diff["metrics"]}
    assert verdicts["tp2.decode.bytes_accessed"] == "regressed"
    assert verdicts["tp1.decode.flops"] == "improved"
    assert diff["regressions"] == 1
    b["sweeps"]["tp2"]["prefill:b8"] = {"flops": 1.0, "bytes_accessed": 1.0}
    diff = perf_diff.diff_budget_reports(a, b)
    assert {r["verdict"] for r in diff["metrics"]
            if r["metric"].startswith("tp2.prefill")} == {"n/a"}


def test_perf_diff_budgets_rejects_wrong_schema():
    with pytest.raises(ValueError, match=BUDGETS_SCHEMA):
        perf_diff.diff_budget_reports({"schema": "nope"}, _budget_doc())


# ---------------------------------------------------------------------
# perf_diff: attribution and bench reports
# ---------------------------------------------------------------------


def _tiny_report():
    led = ProgramLedger(registry=MetricsRegistry())
    led.observe_compile("decode", 0.1, 10.0, 20.0)
    led.observe_call("decode", 0.05, n=2)
    return build_attrib_report(led)


def _perturb(rep, family, **changes):
    rep = json.loads(json.dumps(rep))
    for row in rep["programs"]:
        if row["family"] == family:
            row.update(changes)
    return rep


def test_perf_diff_self_is_all_same():
    rep = _tiny_report()
    diff = perf_diff.diff_attrib_reports(rep, rep)
    assert diff["regressions"] == 0
    assert all(r["verdict"] == "same" for r in diff["programs"])


def test_perf_diff_timing_noise_needs_both_gates():
    rep = _tiny_report()
    small = _perturb(rep, "decode", compile_s=0.1 + 4e-4)
    assert perf_diff.diff_attrib_reports(rep, small, rel_tol=0.05,
                                         abs_floor_s=1e-3)["regressions"] == 0
    big = _perturb(rep, "decode", compile_s=0.2)
    diff = perf_diff.diff_attrib_reports(rep, big)
    assert diff["regressions"] == 1
    [row] = diff["programs"]
    assert row["metrics"]["compile_s"]["verdict"] == "regressed"
    diff = perf_diff.diff_attrib_reports(big, rep)
    assert diff["regressions"] == 0
    assert diff["programs"][0]["verdict"] == "improved"


def test_perf_diff_exact_metrics_have_no_noise_allowance():
    rep = _tiny_report()
    diff = perf_diff.diff_attrib_reports(rep, _perturb(rep, "decode", flops=10.5))
    assert diff["programs"][0]["metrics"]["flops"]["verdict"] == "regressed"


def test_perf_diff_unmatched_family_is_na_not_regression():
    led = ProgramLedger(registry=MetricsRegistry())
    led.observe_compile("prefill", 0.1, 5.0, 5.0, variant="b8")
    diff = perf_diff.diff_attrib_reports(_tiny_report(), build_attrib_report(led))
    assert diff["regressions"] == 0
    assert {r["verdict"] for r in diff["programs"]} == {"n/a"}


def _bench(value, metric="decode tok/s/device"):
    return {"n": 1, "cmd": "bench", "rc": 0, "tail": "",
            "parsed": {"metric": metric, "value": value, "unit": "tok/s",
                       "vs_baseline": None, "error": None}}


def test_perf_diff_bench_direction_and_null_handling():
    diff = perf_diff.diff_bench_reports(_bench(100.0), _bench(50.0))
    assert diff["regressions"] == 1
    assert diff["metrics"][0]["direction"] == "higher_better"
    diff = perf_diff.diff_bench_reports(_bench(1.0, "itl_seconds"),
                                        _bench(2.0, "itl_seconds"))
    assert diff["metrics"][0]["direction"] == "lower_better"
    assert diff["regressions"] == 1
    diff = perf_diff.diff_bench_reports(_bench(100.0), _bench(None))
    assert diff["regressions"] == 0 and diff["metrics"][0]["verdict"] == "n/a"
    failed = {"n": 1, "cmd": "bench", "rc": 1, "tail": "boom"}
    assert perf_diff.classify("f.json", failed) == "bench"
    diff = perf_diff.diff_bench_reports(failed, _bench(100.0))
    assert diff["regressions"] == 0 and diff["metrics"][0]["verdict"] == "n/a"


def test_perf_diff_cli_exit_codes(tmp_path):
    rep = _tiny_report()
    a = tmp_path / "a.json"
    a.write_text(dump_attrib_report(rep))
    b = tmp_path / "b.json"
    b.write_text(dump_attrib_report(_perturb(rep, "decode", compile_s=5.0)))
    garbage = tmp_path / "c.json"
    garbage.write_text(json.dumps({"schema": "what/9"}))
    assert perf_diff.main([str(a), str(a)]) == 0
    assert perf_diff.main([str(a), str(b)]) == 1
    assert perf_diff.main([str(a), str(garbage)]) == 2


# ---------------------------------------------------------------------
# parity with the JAX tool on the same files
# ---------------------------------------------------------------------


def _traffic(hit, cost):
    return {"schema": "mingpt-traffic/1", "rungs": [
        {"rung": 4, "policies": {"fifo": {"deadline_hit_rate": hit, "cost": {"cost": cost}},
                                 "edf": {"deadline_hit_rate": 0.9, "cost": {"cost": 2.0}}}}]}


def _pairs():
    rep = _tiny_report()
    budgets_b = _budget_doc()
    budgets_b["sweeps"]["tp2"]["decode"]["bytes_accessed"] = 180.0
    bench_b = _bench(80.0)
    bench_a = _bench(100.0)
    bench_a["multichip"] = {"sharded_serving": {"tp2": {"kv_pool_bytes_per_device": 10,
                                                        "decode_ms": 1.0}}}
    bench_b["multichip"] = {"sharded_serving": {"tp2": {"kv_pool_bytes_per_device": 12,
                                                        "decode_ms": 1.01}}}
    return {
        "attrib": (rep, _perturb(rep, "decode", compile_s=0.3, flops=9.0)),
        "budgets": (_budget_doc(), budgets_b),
        "bench": (bench_a, bench_b),
        "traffic": (_traffic(0.8, 3.0), _traffic(0.6, 2.0)),
    }


@pytest.mark.parametrize("kind", ["attrib", "budgets", "bench", "traffic"])
def test_perf_diff_gives_the_jax_tools_verdicts(tmp_path, kind, capsys):
    a, b = _pairs()[kind]
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(a))
    pb.write_text(json.dumps(b))
    outs = {}
    for name, tool in (("port", perf_diff), ("jax", j_perf_diff)):
        rc = tool.main([str(pa), str(pb), "--json", str(tmp_path / f"{name}.json")])
        outs[name] = (rc, json.loads((tmp_path / f"{name}.json").read_text()),
                      capsys.readouterr().out)
    assert outs["port"][0] == outs["jax"][0] == 1
    assert outs["port"][1] == outs["jax"][1]
    assert outs["port"][2] == outs["jax"][2]
    assert np.isfinite(outs["port"][1]["regressions"])
