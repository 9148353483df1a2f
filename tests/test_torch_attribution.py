"""The port's performance attribution (telemetry/attribution.py, the engine's
and the speculative decoder's ``register_attrib``, the scheduler's ledgers,
``/attrib`` and ``serve.py --selftest-attrib``), with the report held by the
JAX package's own ``validate_attrib_report``.

Counterparts of tests/test_attribution.py without its perf_diff cases
(those are in tests/test_torch_graftaudit.py, beside the port's
tools/perf_diff.py): the program ledger's rows,
costs and gauges, the roofline fields, the HBM ledger, the report's
validation, dump and render, and the fleet's merged scrape page
(``render_fleet_prometheus``: one TYPE line per family, the replica label,
a kind conflict raising, deterministic bytes; the same samples as the JAX
package's merge of the same observations). Then what the port adds: each family's analytic cost against ``torch.utils.flop_counter`` on a
real call, the HBM owners against the pools' tensors, the allocator audit,
and a served run's report. CPU, tiny config, fp32.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mingpt_distributed_tpu import telemetry as j_tel
from mingpt_distributed_tpu_torch import serve as t_serve
from mingpt_distributed_tpu_torch import telemetry
from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models import generate as gen
from mingpt_distributed_tpu_torch.models import gpt
from mingpt_distributed_tpu_torch.serving import InferenceServer, Request
from mingpt_distributed_tpu_torch.telemetry import attribution
from mingpt_distributed_tpu_torch.telemetry import (
    ATTRIB_SCHEMA,
    HBMLedger,
    MetricsRegistry,
    ProgramLedger,
    build_attrib_report,
    dump_attrib_report,
    parse_prometheus,
    render_attrib_report,
    tree_bytes,
    validate_attrib_report,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32,
            embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
MOE = dict(TINY, n_experts=4, moe_top_k=2, rope=True, swiglu=True, rmsnorm=True,
           n_kv_head=1)


class TickingClock:
    def __init__(self, dt=1e-3):
        self.t = 0.0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t


# ---------------------------------------------------------------------------
# ProgramLedger
# ---------------------------------------------------------------------------


def test_program_ledger_accumulates_and_sorts_rows():
    led = ProgramLedger(registry=MetricsRegistry())
    led.observe_compile("prefill", 0.5, 100.0, 50.0, variant="b16")
    led.observe_compile("decode", 0.25, 10.0, 40.0)
    led.observe_compile("prefill", 0.5, 200.0, 80.0, variant="b8")
    led.observe_call("decode", 0.01, n=3)
    led.observe_call("decode", 0.02)
    assert led.families() == ["decode", "prefill"]
    rows = {(r["family"], r["variant"]): r for r in led.rows()}
    assert [(r["family"], r["variant"]) for r in led.rows()] == sorted(rows)
    dec = rows[("decode", "")]
    assert dec["compiles"] == 1 and dec["compile_s"] == 0.25 and dec["calls"] == 4
    assert dec["device_s"] == pytest.approx(0.03)
    assert dec["arith_intensity"] == pytest.approx(0.25)
    assert rows[("prefill", "b8")]["calls"] == 0


def test_program_ledger_keeps_latest_non_none_cost():
    led = ProgramLedger(registry=MetricsRegistry())
    led.observe_compile("decode", 0.1, 10.0, 20.0)
    led.observe_compile("decode", 0.1, None, None)
    [row] = led.rows()
    assert row["compiles"] == 2 and row["compile_s"] == pytest.approx(0.2)
    assert row["flops"] == 10.0 and row["bytes_accessed"] == 20.0


def test_program_ledger_feeds_registry_gauges():
    reg = MetricsRegistry()
    led = ProgramLedger(registry=reg)
    led.observe_compile("verify", 0.5, 99.0, 11.0, variant="k3")
    led.observe_call("verify", 0.25, variant="k3", n=2)
    parsed = parse_prometheus(telemetry.render_prometheus(reg))
    assert parsed["types"]["mingpt_attrib_flops"] == "gauge"
    assert parsed["types"]["mingpt_attrib_calls_total"] == "counter"
    values = {(n, tuple(sorted(lb.items()))): v for n, lb, v in parsed["samples"]}
    lab = (("family", "verify"), ("variant", "k3"))
    assert values[("mingpt_attrib_flops", lab)] == 99.0
    assert values[("mingpt_attrib_calls_total", lab)] == 2
    assert values[("mingpt_attrib_device_seconds_total", lab)] == 0.25


def test_roofline_fields_against_injected_peaks(monkeypatch):
    monkeypatch.setattr(attribution, "peak_flops_per_chip", lambda: 100.0)
    monkeypatch.setattr(attribution, "peak_hbm_bytes_per_chip", lambda: 50.0)
    led = ProgramLedger(registry=MetricsRegistry())
    led.observe_compile("decode", 0.1, 40.0, 40.0)
    led.observe_call("decode", 2.0, n=2)
    led.observe_compile("prefill", 0.1, 400.0, 40.0)
    rows = {r["family"]: r for r in led.rows()}
    assert rows["decode"]["expected_mfu"] == pytest.approx(0.5)
    assert rows["decode"]["measured_mfu"] == pytest.approx(0.4)
    assert rows["prefill"]["expected_mfu"] == 1.0
    assert rows["prefill"]["measured_mfu"] is None


def test_the_peaks_are_none_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the CPU-only behaviour")
    led = ProgramLedger(registry=MetricsRegistry())
    led.observe_compile("decode", 0.0, 10.0, 20.0)
    led.observe_call("decode", 1.0)
    [row] = led.rows()
    assert row["expected_mfu"] is None and row["measured_mfu"] is None
    assert build_attrib_report(led)["peaks"] == {
        "flops_per_chip": None, "hbm_bandwidth_per_chip": None,
        "hbm_capacity_per_chip": None}


# ---------------------------------------------------------------------------
# HBMLedger
# ---------------------------------------------------------------------------


def test_hbm_ledger_is_declarative_and_sorted():
    led = HBMLedger(registry=MetricsRegistry(), capacity_bytes=1000)
    led.account("params", 300)
    led.account("kv_pool", 200)
    led.account("kv_pool", 250)
    assert led.owners() == {"kv_pool": 250, "params": 300}
    assert list(led.owners()) == ["kv_pool", "params"]
    assert led.total_bytes() == 550
    with pytest.raises(ValueError, match="negative"):
        led.account("params", -1)


def test_hbm_ledger_headroom_gauge():
    reg = MetricsRegistry()
    led = HBMLedger(registry=reg, capacity_bytes=1000)
    led.account("params", 600)
    parsed = parse_prometheus(telemetry.render_prometheus(reg))
    values = {(n, tuple(sorted(lb.items()))): v for n, lb, v in parsed["samples"]}
    assert values[("mingpt_attrib_hbm_bytes", (("owner", "params"),))] == 600
    assert values[("mingpt_attrib_hbm_total_bytes", ())] == 600
    assert values[("mingpt_attrib_hbm_headroom_bytes", ())] == 400


def test_hbm_audit_reads_the_cuda_allocator(monkeypatch):
    """The audit compares the owners with torch.cuda.memory_allocated on the
    ledger's card (stubbed here); a ledger of the CPU refuses to audit."""
    led = HBMLedger(registry=MetricsRegistry(), capacity_bytes=None,
                    device=torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 5000)
    assert led.audit() == {"owned_bytes": 0, "live_bytes": 5000,
                           "unattributed_bytes": 5000}
    led.account("params", 3000)
    assert led.audit()["unattributed_bytes"] == 2000
    with pytest.raises(RuntimeError, match="CUDA caching allocator"):
        HBMLedger(registry=MetricsRegistry(), device=torch.device("cpu")).audit()


def test_tree_bytes_match_real_buffers():
    tree = {"w": torch.ones((4, 4)), "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    assert tree_bytes(tree) == 4 * 4 * 4 + 4 * 2
    cfg = GPTConfig.make(**TINY)
    cache = gen.init_cache(cfg, 3, torch.device("cpu"))
    assert tree_bytes(cache) == 2 * 4 * cfg.n_layer * 3 * cfg.block_size * cfg.n_embd


# ---------------------------------------------------------------------------
# mingpt-attrib/1
# ---------------------------------------------------------------------------


def _tiny_report(with_hbm=True):
    led = ProgramLedger(registry=MetricsRegistry())
    led.observe_compile("decode", 0.1, 10.0, 20.0)
    led.observe_call("decode", 0.05, n=2)
    hbm = None
    if with_hbm:
        hbm = HBMLedger(registry=MetricsRegistry(), capacity_bytes=1000)
        hbm.account("params", 300)
    return build_attrib_report(led, hbm=hbm)


def test_report_roundtrip_validate_dump_render():
    rep = _tiny_report()
    validate_attrib_report(rep)
    j_tel.validate_attrib_report(rep)
    rep2 = json.loads(dump_attrib_report(rep))
    validate_attrib_report(rep2)
    assert dump_attrib_report(rep2) == dump_attrib_report(rep)
    text = render_attrib_report(rep)
    assert "1 program rows" in text and "decode" in text and "params" in text
    assert rep["hbm"]["headroom_bytes"] == 700 and rep["schema"] == ATTRIB_SCHEMA


def test_identically_built_ledgers_dump_identical_bytes():
    assert dump_attrib_report(_tiny_report()) == dump_attrib_report(_tiny_report())


@pytest.mark.parametrize("mutate,match", [
    (lambda r: r.update(schema="nope/9"), "schema"),
    (lambda r: r["programs"][0].pop("flops"), "missing"),
    (lambda r: r["programs"][0].update(calls=-1), "negative"),
    (lambda r: r["programs"].append(dict(r["programs"][0])), "duplicate"),
    (lambda r: r["hbm"].update(total_bytes=1), "total_bytes"),
    (lambda r: r["hbm"]["owners"].update(params=-5), "non-negative"),
    (lambda r: r["programs"][0].update(compile_s=None), "null"),
])
def test_validate_rejects_malformed_reports(mutate, match):
    rep = _tiny_report()
    mutate(rep)
    with pytest.raises(ValueError, match=match):
        validate_attrib_report(rep)
    with pytest.raises(ValueError, match=match):
        j_tel.validate_attrib_report(rep)


# ---------------------------------------------------------------------------
# the engine's families
# ---------------------------------------------------------------------------


def _flops_of(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("kw", [TINY, MOE], ids=["gpt2", "moe"])
def test_registered_costs_are_the_flop_counters(kw):
    """Each family's registered operations equal what
    torch.utils.flop_counter counts on a real call of that shape: a
    prefill bucket, the decode step at per-row positions and verify's
    k + 1 rows."""
    cfg = GPTConfig.make(**kw)
    params = gpt.init(cfg, torch.Generator().manual_seed(0))
    srv = InferenceServer(params, cfg, n_slots=3, prefill_buckets=(8, 32),
                          attrib=True, draft_params=params, draft_cfg=cfg, spec_k=2,
                          device="cpu")
    rows = {(r["family"], r["variant"]): r for r in srv.attrib.rows()}
    eng = srv.engine
    got = _flops_of(lambda: eng.prefill_chunk_call(0, [1, 2, 3], 0, 1.0, None, None,
                                                   False, None))
    assert rows[("prefill", "b8")]["flops"] == got
    tokens = torch.tensor([1, 2, 3])
    positions = torch.tensor([3, 9, 31])
    ones, zeros = torch.ones(3), torch.zeros(3, dtype=torch.long)
    got = _flops_of(lambda: eng.decode_on_device(tokens, positions, ones, zeros, ones,
                                                 [False] * 3, [None] * 3))
    assert rows[("decode", "")]["flops"] == got
    got = _flops_of(lambda: eng.verify_call(0, [1, 2, 3], 4, 1.0, None, None))
    assert rows[("verify", "k2")]["flops"] == got
    assert rows[("draft_decode", "")]["flops"] == rows[("decode", "")]["flops"]
    w = tree_bytes(params)
    assert rows[("decode", "")]["bytes_accessed"] == w + eng.kv_bytes_per_row() * (
        3 * cfg.block_size + 3)


def test_served_report_validates_and_owns_the_pools():
    """A served run with speculation, a quantized pool and the prefix store:
    the report passes both validators, every family that ran has calls,
    the HBM owners equal the bytes of the tensors they name (the draft
    shares the target's weights, so owns none of its own), and two runs
    on a ticking clock dump the same bytes."""
    cfg = GPTConfig.make(**dict(TINY, n_head=2, n_embd=64))
    params = gpt.init(cfg, torch.Generator().manual_seed(0))

    def run():
        srv = InferenceServer(params, cfg, n_slots=2, attrib=True, clock=TickingClock(),
                              registry=MetricsRegistry(), prefill_buckets=(8, 16, 32),
                              prefill_chunk=8, prefix_cache_mb=1.0, kv_dtype="int8",
                              draft_params=t_serve.first_layers(params, 1),
                              draft_cfg=GPTConfig.make(**dict(TINY, n_embd=64, n_layer=1)),
                              spec_k=2, warmup=True, device="cpu")
        shared = list(range(3, 20))
        srv.generate_batch([Request(prompt=p, max_new_tokens=6) for p in
                            (shared + [25], [1, 2, 3], shared + [26], [7, 8])])
        return srv, srv.attrib_report()

    srv, report = run()
    validate_attrib_report(report)
    j_tel.validate_attrib_report(report)
    ran = {fam for fam, n in srv.compile_counts().items() if n}
    called = {r["family"] for r in report["programs"] if r["calls"]}
    assert ran - {"decode"} <= called and "verify" in called
    owners = report["hbm"]["owners"]
    from mingpt_distributed_tpu_torch.serving import quant

    data, scales = quant.split_scales(srv.engine.pool.cache)
    assert owners["kv_pool"] == tree_bytes(data)
    assert owners["kv_scales"] == tree_bytes(scales)
    assert owners["params"] == tree_bytes(params)
    assert owners["prefix_store"] == srv.engine.prefix_store.used_bytes > 0
    assert owners["draft_params"] == 0
    assert owners["draft_pool"] == tree_bytes(srv.spec.draft.engine.pool.cache)
    assert srv.watchdog.armed and srv.watchdog.recompiles == 0
    assert dump_attrib_report(run()[1]) == dump_attrib_report(report)


def test_attrib_endpoint_serves_the_report():
    cfg = GPTConfig.make(**TINY)
    params = gpt.init(cfg, torch.Generator().manual_seed(0))
    reg = MetricsRegistry()
    srv = InferenceServer(params, cfg, n_slots=1, attrib=True, registry=reg, device="cpu")
    srv.generate_batch([Request(prompt=[1, 2], max_new_tokens=3)])
    ts = telemetry.TelemetryServer(reg, port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(ts.url("/attrib"), timeout=10)
        assert e.value.code == 404
        ts.attrib_provider = srv.attrib_report
        with urllib.request.urlopen(ts.url("/attrib"), timeout=10) as resp:
            doc = json.loads(resp.read().decode())
        j_tel.validate_attrib_report(doc)
        assert {r["family"] for r in doc["programs"]} >= {"prefill", "decode"}
    finally:
        ts.close()
    with pytest.raises(ValueError, match="attrib=True"):
        InferenceServer(params, cfg, n_slots=1, device="cpu").attrib_report()


def test_selftest_attrib_passes(tmp_path, capsys):
    path = tmp_path / "attrib.json"
    assert t_serve.main(["--selftest-attrib", "--device", "cpu", "--prefix-cache-mb", "1",
                         "--prefill-buckets", "8,16,48", "--attrib-json", str(path)]) == 0
    assert "selftest-attrib PASSED" in capsys.readouterr().out
    with open(path) as f:
        j_tel.validate_attrib_report(json.load(f))


def test_attribution_does_not_change_tokens():
    cfg = GPTConfig.make(**TINY)
    params = gpt.init(cfg, torch.Generator().manual_seed(0))
    reqs = lambda: [Request(prompt=[1, 2, 3], max_new_tokens=5),  # noqa: E731
                    Request(prompt=[4, 5], max_new_tokens=5)]
    a = InferenceServer(params, cfg, n_slots=2, attrib=True, device="cpu").generate_batch(reqs())
    b = InferenceServer(params, cfg, n_slots=2, device="cpu").generate_batch(reqs())
    assert [h.tokens for h in a] == [h.tokens for h in b]
    np.testing.assert_array_equal(np.array([len(h.tokens) for h in a]), [5, 5])


# ---------------------------------------------------------------------------
# the fleet's merged scrape
# ---------------------------------------------------------------------------


def _fleet_registries(tel):
    """Two replicas' ledgers and a base registry, built in package ``tel``."""
    regs = {}
    for name in ("replica0", "replica1"):
        reg = tel.MetricsRegistry()
        led = tel.ProgramLedger(registry=reg)
        led.observe_compile("decode", 0.1, 10.0, 20.0)
        led.observe_call("decode", 0.01)
        regs[name] = reg
    base = tel.MetricsRegistry()
    base.gauge("mingpt_fleet_replica_up", labels=("replica",)) \
        .labels(replica="replica0").set(1)
    return base, regs


def test_fleet_merge_one_type_line_per_family_with_replica_label():
    page = telemetry.render_fleet_prometheus(*_fleet_registries(telemetry))
    parsed = parse_prometheus(page)  # strict: no duplicate TYPE line survived
    assert page.count("# TYPE mingpt_attrib_flops gauge") == 1
    assert sorted(lb["replica"] for n, lb, _ in parsed["samples"]
                  if n == "mingpt_attrib_flops") == ["replica0", "replica1"]
    # base-registry families are emitted as they are
    assert ("mingpt_fleet_replica_up", {"replica": "replica0"}, 1.0) in parsed["samples"]
    # the JAX package's merge of the same observations: the same samples
    theirs = parse_prometheus(j_tel.render_fleet_prometheus(*_fleet_registries(j_tel)))
    assert parsed["types"] == theirs["types"]
    assert sorted(map(repr, parsed["samples"])) == sorted(map(repr, theirs["samples"]))


def test_fleet_merge_rejects_cross_replica_kind_conflict():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.counter("mingpt_test_thing_total")
    b.gauge("mingpt_test_thing_total")
    with pytest.raises(ValueError, match="incoherent"):
        telemetry.render_fleet_prometheus(None, {"replica0": a, "replica1": b})


def test_fleet_merge_page_is_deterministic():
    def build():
        regs = {}
        for name in ("r1", "r0"):
            reg = MetricsRegistry()
            ProgramLedger(registry=reg).observe_compile("decode", 0.5, 1.0, 2.0)
            regs[name] = reg
        return telemetry.render_fleet_prometheus(None, regs)

    assert build() == build()
    assert build().index('replica="r0"') < build().index('replica="r1"')
