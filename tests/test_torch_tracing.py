"""The port's request tracing, flight recorder and SLO engine
(telemetry/{tracing,flightrec,slo}.py, wired into serving/scheduler.py and
serve.py), with the schema held by the JAX package's own validators.

Counterparts of tests/test_tracing.py: the recorder, sampling, orphans,
validation, the exact quantile and SLO grading, the flight ring and its
manifest, a solo server that owns its traces, and the fleet's cases (a
crash and retry as one trace with no orphans, the scheduler's spans under
the fleet's attempt span, forced shed traces, the drain's and the crash's
flight dumps, /healthz's per-replica detail). The port's trace records, flight dumps and
attribution of a served run pass ``validate_trace_records`` /
``validate_flight_dump`` of both packages. Every timestamp comes from an
injected clock, so durations are exact. CPU, tiny config, fp32.
"""

import json
import os
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mingpt_distributed_tpu import telemetry as j_tel
from mingpt_distributed_tpu.config import GPTConfig as JConfig
from mingpt_distributed_tpu.models import gpt as j_gpt
from mingpt_distributed_tpu_torch import serve as t_serve
from mingpt_distributed_tpu_torch import telemetry
from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import generate as gen
from mingpt_distributed_tpu_torch.models import gpt
from mingpt_distributed_tpu_torch.serving import InferenceServer, Request
from mingpt_distributed_tpu_torch.telemetry import (
    FlightRecorder,
    MetricsRegistry,
    TraceRecorder,
    evaluate_slos,
    exact_quantile,
    load_flight_dir,
    load_trace_jsonl,
    parse_slo_spec,
    render_slo_report,
    trace_sink,
    validate_flight_dump,
    validate_trace_records,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32,
            embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")


class TickingClock:
    """Each read advances by a fixed quantum."""

    def __init__(self, dt=0.001):
        self.t = 0.0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t


@pytest.fixture(scope="module")
def cfg_params():
    cfg = GPTConfig.make(**TINY)
    return cfg, gpt.init(cfg, torch.Generator().manual_seed(0))


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# the recorder (no model)
# ---------------------------------------------------------------------------


def test_recorder_roundtrip_validates(tmp_path):
    path = str(tmp_path / "t.jsonl")
    rec = TraceRecorder(sink=trace_sink(path))
    ctx = rec.start_trace("req-0", now=1.0, baggage={"tenant": "a"})
    rec.add_event(ctx, "queued", 1.0, queue_depth=0)
    rec.add_span(ctx, "serve.queue_wait", ts=1.0, dur_s=0.5)
    attempt = rec.open_span(ctx, "fleet.attempt", 1.5, attempt=1)
    rec.add_span(attempt, "serve.prefill_chunk", ts=1.5, dur_s=0.25)
    rec.add_event(ctx, "emit", 2.0, token_index=0)
    rec.add_event(ctx, "emit", 2.5, token_index=1)
    rec.close_span(attempt, 2.5, outcome="length")
    summary = rec.end_trace(ctx, now=2.5, outcome="length", n_tokens=2)
    rec.close()
    assert summary["ttft_s"] == pytest.approx(1.0)
    assert summary["itl_mean_s"] == pytest.approx(0.5)
    assert summary["total_s"] == pytest.approx(1.5)
    assert summary["sampled"] and summary["baggage"]["tenant"] == "a"
    traces = load_trace_jsonl(path)
    j_tel.validate_trace_records(_records(path))  # the JAX package's validator
    t = traces["req-0"]
    assert {s["name"] for s in t["spans"]} == {
        "serve.queue_wait", "fleet.attempt", "serve.prefill_chunk"}
    prefill = next(s for s in t["spans"] if s["name"] == "serve.prefill_chunk")
    attempt_span = next(s for s in t["spans"] if s["name"] == "fleet.attempt")
    assert prefill["parent_id"] == attempt_span["span_id"]
    assert rec.active_traces == 0 and rec.orphan_records == 0


def test_sampling_deterministic_and_forced():
    rec = TraceRecorder(sample=0.0)
    s = rec.end_trace(rec.start_trace("happy", now=0.0), now=1.0, outcome="length",
                      n_tokens=1)
    assert not s["sampled"] and s["sample_cause"] is None
    s = rec.end_trace(rec.start_trace("sad", now=0.0), now=1.0, outcome="error")
    assert s["sampled"] and s["sample_cause"] == "forced"
    s = rec.end_trace(rec.start_trace("retried", now=0.0), now=1.0, outcome="length",
                      attempts=2)
    assert s["sampled"]
    ctx = rec.start_trace("marked", now=0.0)
    rec.mark_forced(ctx)
    assert rec.end_trace(ctx, now=1.0, outcome="length")["sampled"]
    assert len(rec.completed_requests()) == 4
    # the same ids sample alike here and in the JAX package (CRC32 of the id)
    a, b = TraceRecorder(sample=0.5), j_tel.TraceRecorder(sample=0.5)
    for i in range(32):
        sa = a.end_trace(a.start_trace(f"r{i}", now=0.0), now=1.0, outcome="length")
        sb = b.end_trace(b.start_trace(f"r{i}", now=0.0), now=1.0, outcome="length")
        assert sa["sampled"] == sb["sampled"]
    assert 0 < a.exported_traces < 32


def test_orphans_counted_and_unclosed_spans_recovered():
    rec = TraceRecorder(registry=MetricsRegistry())
    ctx = rec.start_trace("r", now=0.0)
    rec.close_span(ctx.child("s99"), 1.0)  # never opened: an orphan
    assert rec.orphan_records == 1
    rec.open_span(ctx, "fleet.attempt", 0.5)
    assert rec.end_trace(ctx, now=2.0, outcome="error") is not None
    collected = []

    class _Sink:
        schema = telemetry.TRACE_SCHEMA

        def write(self, kind, payload):
            collected.append(dict(payload, schema=self.schema, kind=kind))

        def close(self):
            pass

    rec2 = TraceRecorder(sample=1.0, sink=_Sink())
    c2 = rec2.start_trace("r2", now=0.0)
    rec2.open_span(c2, "fleet.attempt", 0.5)
    rec2.end_trace(c2, now=2.0, outcome="error")
    spans = [r for r in collected if r["kind"] == "span"]
    assert len(spans) == 1 and spans[0]["unclosed"] is True
    validate_trace_records(collected)
    j_tel.validate_trace_records(collected)


@pytest.mark.parametrize("validate", [validate_trace_records,
                                      j_tel.validate_trace_records],
                         ids=["port", "jax"])
def test_trace_validation_rejects_orphans_and_bad_totals(validate):
    rec = [
        {"schema": telemetry.TRACE_SCHEMA, "kind": "span", "trace_id": "t",
         "span_id": "s1", "parent_id": "s0", "name": "x", "ts": 0.0, "dur_s": 1.0},
        {"schema": telemetry.TRACE_SCHEMA, "kind": "request", "trace_id": "t",
         "ts": 0.0, "end_ts": 1.0, "total_s": 1.0, "outcome": "length",
         "n_tokens": 0, "attempts": 1, "request_id": "t"},
    ]
    validate(rec)
    with pytest.raises(ValueError, match="orphan"):
        validate([dict(rec[0], parent_id="s42"), rec[1]])
    with pytest.raises(ValueError, match="total_s"):
        validate([rec[0], dict(rec[1], total_s=2.0)])
    with pytest.raises(ValueError, match="request"):
        validate([rec[0]])


# ---------------------------------------------------------------------------
# the SLO engine
# ---------------------------------------------------------------------------


def test_exact_quantile_nearest_rank():
    xs = [0.1 * i for i in range(1, 101)]
    assert exact_quantile(xs, 0.50) == pytest.approx(5.0)
    assert exact_quantile(xs, 0.99) == pytest.approx(9.9)
    assert exact_quantile([7.0], 0.99) == 7.0
    assert exact_quantile([], 0.5) is None
    assert exact_quantile(xs, 0.99) not in telemetry.LATENCY_BUCKETS_S
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert exact_quantile(xs, q) == j_tel.exact_quantile(xs, q)


def test_slo_spec_parse_and_grading():
    objs = parse_slo_spec("ttft_p99<=0.5,itl_p50<=0.1,shed_rate<=0.05")
    assert [o.metric for o in objs] == ["ttft_p99", "itl_p50", "shed_rate"]
    assert parse_slo_spec("default")
    for bad in ("ttft_p999<=1", "nonsense<=1", "ttft_p99", ""):
        with pytest.raises(ValueError):
            parse_slo_spec(bad)

    def req(ttft, gaps, outcome="length"):
        return {"outcome": outcome, "ttft_s": ttft, "itl_s": gaps,
                "n_tokens": 1 + len(gaps), "attempts": 1}

    requests = [req(0.1, [0.01, 0.02]) for _ in range(9)] + [req(9.0, [5.0])]
    spec = "ttft_p50<=0.2,ttft_p99<=0.5"
    report = evaluate_slos(requests, parse_slo_spec(spec))
    by_name = {r["name"]: r for r in report["objectives"]}
    assert by_name["ttft_p50"]["pass"] is True and by_name["ttft_p99"]["pass"] is False
    assert report["attained"] == 1 and report["grade"] == "D"
    assert report == j_tel.evaluate_slos(requests, j_tel.parse_slo_spec(spec))
    requests.append(req(None, [], outcome="shed"))
    report = evaluate_slos(requests, parse_slo_spec("shed_rate<=0.05"))
    assert report["objectives"][0]["observed"] == pytest.approx(1 / 11)
    assert "FAIL" in render_slo_report(report)
    report = evaluate_slos([], parse_slo_spec("ttft_p99<=0.5"))
    assert report["objectives"][0]["pass"] is None and report["grade"] == "n/a"


def test_recovery_tail_slo_metric():
    objs = parse_slo_spec("recovery_p99<=0.5")
    requests = [{"outcome": "length", "ttft_s": 0.1, "itl_s": [], "recovery_s": 0.2},
                {"outcome": "length", "ttft_s": 0.1, "itl_s": [], "recovery_s": 0.9},
                {"outcome": "length", "ttft_s": 0.1, "itl_s": []}]
    row = evaluate_slos(requests, objs)["objectives"][0]
    assert row["observed"] == pytest.approx(0.9) and row["pass"] is False
    assert evaluate_slos(requests[2:], objs)["objectives"][0]["pass"] is None


def test_slo_diff_matches_jax():
    a = evaluate_slos([{"outcome": "length", "ttft_s": 0.1, "itl_s": [0.01]}],
                      parse_slo_spec("default"))
    b = evaluate_slos([{"outcome": "length", "ttft_s": 0.9, "itl_s": [0.01]}],
                      parse_slo_spec("default"))
    assert telemetry.diff_slo_reports(a, b) == j_tel.diff_slo_reports(a, b)
    assert telemetry.render_slo_diff(telemetry.diff_slo_reports(a, b))


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------


def test_flight_ring_dump_and_manifest(tmp_path):
    reg = MetricsRegistry()
    fl = FlightRecorder(capacity=8, out_dir=str(tmp_path), registry=reg)
    fl.metrics_providers["proc"] = lambda: telemetry.render_prometheus(reg)
    fl.source_providers["dead"] = lambda: 1 / 0  # must not kill a dump
    for i in range(12):
        fl.record("span", {"name": f"s{i}", "ts": float(i)})
    assert fl.dropped == 4
    path, doc = fl.dump("crash", replica="replica0")
    assert path is not None
    validate_flight_dump(doc)
    j_tel.validate_flight_dump(doc)
    assert len(doc["records"]) == 8 and doc["ring_dropped"] == 4
    assert doc["sources"]["dead"][0]["kind"] == "provider_error"
    fl.dump("sigterm_drain")
    manifest, docs = load_flight_dir(str(tmp_path))
    assert [d["trigger"] for d in docs] == ["crash", "sigterm_drain"]
    assert manifest["latest"].endswith("sigterm_drain.json")
    assert [d["trigger"] for d in j_tel.load_flight_dir(str(tmp_path))[1]] == [
        "crash", "sigterm_drain"]
    fl2 = FlightRecorder(capacity=2)
    fl2.record("event", {"name": "x", "ts": 0.0})
    validate_flight_dump(fl2.snapshot("on_demand"))
    p2, doc2 = fl2.dump("crash")
    assert p2 is None and validate_flight_dump(doc2)


def test_flight_max_dumps_bounded(tmp_path):
    fl = FlightRecorder(out_dir=str(tmp_path), max_dumps=2)
    fl.record("span", {"name": "s", "ts": 0.0})
    assert fl.dump("crash")[0] is not None
    assert fl.dump("crash")[0] is not None
    assert fl.dump("crash")[0] is None
    assert fl.dumps_skipped == 1
    assert len(load_flight_dir(str(tmp_path))[1]) == 2


# ---------------------------------------------------------------------------
# the scheduler's traces
# ---------------------------------------------------------------------------


def test_solo_server_owns_its_traces(cfg_params, tmp_path):
    """A server with a recorder mints each request's trace, records its
    emit events and ends it: one valid trace per request (both packages'
    validators), with the queue wait, the prefix lookup, the prefill
    chunks and one decode-round span per round, and no orphans."""
    cfg, params = cfg_params
    path = str(tmp_path / "trace.jsonl")
    rec = TraceRecorder(sink=trace_sink(path))
    server = InferenceServer(params, cfg, n_slots=2, trace_recorder=rec,
                             clock=TickingClock(), prefill_chunk=4,
                             prefill_buckets=(4, 8, 32), device="cpu")
    handles = server.generate_batch([Request(prompt=[1, 2, 3], max_new_tokens=4),
                                     Request(prompt=list(range(5, 15)), max_new_tokens=4),
                                     Request(prompt=[5, 6, 7], max_new_tokens=3)])
    rec.close()
    traces = load_trace_jsonl(path)
    j_tel.validate_trace_records(_records(path))
    assert set(traces) == {h.request_id for h in handles}
    for h in handles:
        t = traces[h.request_id]
        names = [s["name"] for s in t["spans"]]
        assert len([e for e in t["events"] if e["name"] == "emit"]) == len(h.tokens)
        assert t["request"]["outcome"] == "length"
        assert {"serve.queue_wait", "serve.prefix_lookup", "serve.prefill_chunk",
                "serve.decode_round"} <= set(names)
        assert names.count("serve.decode_round") == len(h.tokens) - 1
        assert names.count("serve.prefill_chunk") == -(-len(h.prompt_used) // 4)
        assert t["request"]["ttft_s"] == pytest.approx(h.ttft_s)
        assert not any(n == "fleet.attempt" for n in names)
    assert rec.active_traces == 0 and rec.orphan_records == 0
    assert [traces[h.request_id]["request"]["n_tokens"] for h in handles] == [4, 4, 3]


def test_speculative_rounds_and_failures_are_traced(cfg_params, tmp_path):
    """Speculation's rounds are ``serve.spec_round`` spans with the
    proposed and accepted counts and the summary carries the request's
    totals; a request whose deadline passes, and one whose callback
    raises, end forced-sampled with their outcome; every record passes
    the JAX validator."""
    cfg, params = cfg_params
    path = str(tmp_path / "trace.jsonl")
    rec = TraceRecorder(sink=trace_sink(path), sample=0.0)
    now = {"t": 0.0}

    def clock():
        now["t"] += 0.001
        return now["t"]

    def on_token(handle, tok):
        if handle.request.seed == 7:
            raise RuntimeError("boom")

    server = InferenceServer(params, cfg, n_slots=3, trace_recorder=rec, clock=clock,
                             draft_params=t_serve.first_layers(params, 1),
                             draft_cfg=GPTConfig.make(**dict(TINY, n_layer=1)),
                             spec_k=2, on_token=on_token, device="cpu")
    ok = server.submit(Request(prompt=[1, 2, 3], max_new_tokens=6))
    bad = server.submit(Request(prompt=[4, 5], max_new_tokens=6, seed=7))
    late = server.submit(Request(prompt=[8, 9], max_new_tokens=20, deadline_s=0.01))
    server.run_until_drained(max_steps=200)
    rec.close()
    records = _records(path)
    j_tel.validate_trace_records(records)
    traces = validate_trace_records(records)
    # happy paths are unsampled at 0.0; the failures export, forced
    assert set(traces) == {bad.request_id, late.request_id}
    assert traces[bad.request_id]["request"]["outcome"] == "error"
    assert traces[late.request_id]["request"]["outcome"] == "deadline"
    summary = next(s for s in rec.completed_requests() if s["trace_id"] == ok.request_id)
    assert summary["spec_proposed"] == ok.spec_proposed > 0
    assert summary["spec_accepted"] == ok.spec_accepted
    spec_spans = [s for t in traces.values() for s in t["spans"]
                  if s["name"] == "serve.spec_round"]
    assert spec_spans and all(s["proposed"] == 2 for s in spec_spans)


def test_a_request_with_a_trace_context_parents_into_it(cfg_params):
    """A request that arrives with a TraceContext (a caller's trace) gets
    its spans recorded under it, and the caller keeps the emit events and
    the end of the trace."""
    cfg, params = cfg_params
    rec = TraceRecorder()
    ctx = rec.start_trace("outer", now=0.0)
    server = InferenceServer(params, cfg, n_slots=1, trace_recorder=rec,
                             clock=TickingClock(), device="cpu")
    h = server.generate_batch([Request(prompt=[1, 2], max_new_tokens=3, trace=ctx)])[0]
    assert rec.active_traces == 1 and not h.trace_owner
    summary = rec.end_trace(ctx, now=1.0, outcome="length", n_tokens=0)
    assert summary["n_spans"] >= 3 and summary["n_events"] == 1  # queued


def test_drain_dumps_a_flight_record_the_jax_validator_accepts(cfg_params, tmp_path):
    """The recorder mirrors every trace record into the flight ring; a
    dump after a served run, with the registry's page, passes both
    validators and lists the requests' records."""
    cfg, params = cfg_params
    reg = MetricsRegistry()
    fl = FlightRecorder(out_dir=str(tmp_path / "flight"), registry=reg)
    fl.metrics_providers["process"] = lambda: telemetry.render_prometheus(reg)
    rec = TraceRecorder(registry=reg, flight=fl)
    server = InferenceServer(params, cfg, n_slots=2, trace_recorder=rec,
                             registry=reg, clock=TickingClock(), device="cpu")
    server.generate_batch([Request(prompt=[1, 2, 3], max_new_tokens=3)])
    _, doc = fl.dump("sigterm_drain")
    j_tel.validate_flight_dump(doc)
    _, docs = j_tel.load_flight_dir(str(tmp_path / "flight"))
    kinds = {r["kind"] for r in docs[0]["records"]}
    assert {"span", "event", "request"} <= kinds
    assert "mingpt_trace_exported_total" in docs[0]["metrics"]["process"]


def test_watchdog_dumps_the_flight_recorder_on_a_new_shape(cfg_params, tmp_path):
    """After warmup the watchdog is armed: a prefill bucket outside the
    warmed family is impossible, so grow the family by hand (a bucket the
    ladder lacks) and see the count, the dump and, under recompile_fail,
    the raise."""
    cfg, params = cfg_params
    fl = FlightRecorder(out_dir=str(tmp_path))
    server = InferenceServer(params, cfg, n_slots=1, warmup=True, device="cpu",
                             registry=MetricsRegistry())
    server.watchdog.on_recompile = lambda grown: fl.dump("watchdog_recompile",
                                                         families=grown)
    server.generate_batch([Request(prompt=[1, 2], max_new_tokens=3)])
    assert server.watchdog.armed and server.watchdog.recompiles == 0
    server.engine._shapes["prefill"].add(7)
    server.step()
    assert server.watchdog.recompiles == 1
    _, docs = load_flight_dir(str(tmp_path))
    assert docs[0]["trigger"] == "watchdog_recompile"
    assert docs[0]["attrs"]["families"] == {"prefill": 1}
    strict = InferenceServer(params, cfg, n_slots=1, warmup=True, device="cpu",
                             registry=MetricsRegistry(), recompile_fail=True)
    strict.engine._shapes["decode"].add(99)
    with pytest.raises(telemetry.RecompileError, match="decode"):
        strict.step()


def test_debug_flight_endpoint_serves_a_valid_snapshot(cfg_params):
    reg = MetricsRegistry()
    fl = FlightRecorder(registry=reg)
    fl.metrics_providers["process"] = lambda: telemetry.render_prometheus(reg)
    srv = telemetry.TelemetryServer(reg, port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url("/debug/flight"), timeout=10)
        assert e.value.code == 404
        srv.flight_provider = lambda: fl.snapshot("on_demand")
        fl.record("event", {"name": "x", "ts": 1.0})
        with urllib.request.urlopen(srv.url("/debug/flight"), timeout=10) as resp:
            doc = json.loads(resp.read().decode())
        j_tel.validate_flight_dump(doc)
        assert doc["trigger"] == "on_demand" and doc["records"][0]["name"] == "x"
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# the fleet: one trace per request across replicas and retries
# ---------------------------------------------------------------------------


def make_fleet(cfg_params, spec=None, registry=None, **router_kw):
    """tests/test_fleet.py's fleet: 2 replicas x 2 slots on a virtual clock
    with fast backoffs."""
    from mingpt_distributed_tpu_torch.serving import (
        ReplicaSupervisor,
        Router,
        VirtualClock,
        default_server_factory,
    )
    from mingpt_distributed_tpu_torch.training.faults import ServingFaultInjector

    cfg, params = cfg_params
    sup = ReplicaSupervisor(
        default_server_factory(params, cfg, n_slots=2, device="cpu"), n_replicas=2,
        clock=VirtualClock(tick_s=0.001),
        injector=ServingFaultInjector(spec) if spec else None, registry=registry,
        max_restarts=1, restart_backoff_s=0.01, itl_slo_s=0.1)
    return Router(sup, max_retries=3, retry_backoff_s=0.01, breaker_reset_s=0.05,
                  **router_kw)


def prompts_on(router, index, n, length=3):
    """n prompts whose affinity hash lands on replica ``index``."""
    out = [p for p in ([s + j for j in range(length)] for s in range(1, 40))
           if router._affinity_index(p) == index]
    return out[:n]


def test_crash_retry_is_one_trace_with_no_orphans(cfg_params, tmp_path):
    """A crash and retry yield ONE trace whose second attempt is a marked
    span, with no orphan record and emit events matching the stream; the
    file passes both packages' validators."""
    cfg, params = cfg_params
    path = str(tmp_path / "trace.jsonl")
    rec = TraceRecorder(sink=trace_sink(path))
    streamed = {}
    router = make_fleet(cfg_params, spec="crash:nth=6:match=replica0", trace_recorder=rec,
                        on_token=lambda fh, t: streamed.setdefault(fh.request_id, []).append(t))
    prompts = prompts_on(router, 0, 3)
    handles = router.generate_batch([Request(prompt=p, max_new_tokens=8) for p in prompts])
    assert any(h.attempts > 1 for h in handles)
    for p, h in zip(prompts, handles):
        assert h.finish_reason == "length"
        assert h.tokens == gen.generate(params, cfg, [p], 8, device="cpu")[0, 3:].tolist()
    assert rec.orphan_records == 0 and rec.active_traces == 0
    rec.close()
    validate_trace_records(_records(path))
    j_tel.validate_trace_records(_records(path))
    traces = load_trace_jsonl(path)
    assert set(traces) == {h.request_id for h in handles}
    for h in handles:
        t = traces[h.request_id]
        attempts = [sp for sp in t["spans"] if sp["name"] == "fleet.attempt"]
        retries = [e for e in t["events"] if e["name"] == "retry"]
        emits = [e for e in t["events"] if e["name"] == "emit"]
        assert len(attempts) == h.attempts and len(retries) == h.attempts - 1
        assert [e["token_index"] for e in emits] == list(range(len(h.tokens)))
        assert len(emits) == len(streamed[h.request_id])
        assert t["request"]["retried"] == (h.attempts > 1)
        if h.attempts > 1:
            assert retries[0]["reason"] == "crash"
            assert t["request"]["sample_cause"] == "forced"
            assert t["request"]["recovery_s"] > 0
        assert all("replica" in sp for sp in attempts)
        assert attempts[-1]["replica"] == h.replica


def test_scheduler_spans_join_fleet_trace(cfg_params, tmp_path):
    """The replica scheduler's spans parent under the fleet's attempt span
    through the context riding on the attempt Request."""
    path = str(tmp_path / "trace.jsonl")
    rec = TraceRecorder(sink=trace_sink(path))
    router = make_fleet(cfg_params, trace_recorder=rec)
    h = router.generate_batch([Request(prompt=[1, 2, 3], max_new_tokens=4)])[0]
    rec.close()
    t = load_trace_jsonl(path)[h.request_id]
    names = {sp["name"] for sp in t["spans"]}
    assert {"fleet.attempt", "serve.queue_wait", "serve.prefix_lookup",
            "serve.prefill_chunk", "serve.decode_round"} <= names
    attempt_id = next(sp["span_id"] for sp in t["spans"] if sp["name"] == "fleet.attempt")
    for sp in t["spans"]:
        if sp["name"].startswith("serve."):
            assert sp["parent_id"] == attempt_id


def test_shed_requests_get_forced_traces(cfg_params):
    from mingpt_distributed_tpu_torch.serving import ShedError

    rec = TraceRecorder(sample=0.0)  # sheds export regardless
    router = make_fleet(cfg_params, trace_recorder=rec)
    router.drain()
    with pytest.raises(ShedError):
        router.submit(Request(prompt=[1, 2, 3]))
    (summary,) = rec.completed_requests()
    assert summary["outcome"] == "shed" and summary["shed_reason"] == "draining"
    assert summary["sampled"] and summary["sample_cause"] == "forced"


def test_fleet_drain_dumps_strict_flight_record(cfg_params, tmp_path):
    """serve's SIGTERM-drain path under the fleet: the dump strict-parses
    through the manifest, mirrors the requests' records and carries each
    replica's registry page."""
    reg = MetricsRegistry()
    fl = FlightRecorder(out_dir=str(tmp_path / "flight"), registry=reg)
    rec = TraceRecorder(registry=reg, flight=fl)
    router = make_fleet(cfg_params, registry=reg, trace_recorder=rec, flight=fl)
    router.generate_batch([Request(prompt=[1, 2, 3], max_new_tokens=4),
                           Request(prompt=[9, 8, 7], max_new_tokens=4)])
    router.drain()
    path, _ = fl.dump("sigterm_drain")
    assert path is not None
    _, docs = load_flight_dir(str(tmp_path / "flight"))
    j_tel.validate_flight_dump(docs[-1])
    assert docs[-1]["trigger"] == "sigterm_drain"
    assert {"span", "event", "request"} <= {r["kind"] for r in docs[-1]["records"]}
    assert any(name.startswith("replica") for name in docs[-1]["metrics"])


def test_crash_triggers_flight_dump(cfg_params, tmp_path):
    fl = FlightRecorder(out_dir=str(tmp_path))
    rec = TraceRecorder(flight=fl)
    router = make_fleet(cfg_params, spec="crash:nth=6:match=replica0",
                        trace_recorder=rec, flight=fl)
    handles = router.generate_batch([Request(prompt=p, max_new_tokens=8)
                                     for p in prompts_on(router, 0, 3)])
    assert all(h.finish_reason == "length" for h in handles)
    _, docs = load_flight_dir(str(tmp_path))
    crash = [d for d in docs if d["trigger"] == "crash"]
    assert crash and crash[0]["attrs"]["replica"] == "replica0"


def test_healthz_carries_each_replicas_breaker_and_reasons(cfg_params):
    reg = MetricsRegistry()
    fl = FlightRecorder()
    fl.record("event", {"name": "x", "ts": 0.0})
    router = make_fleet(cfg_params, registry=reg, flight=fl)
    srv = telemetry.TelemetryServer(reg, port=0, health_provider=router.health_report,
                                    metrics_provider=router.fleet_metrics_page)
    try:
        srv.flight_provider = lambda: fl.snapshot("on_demand")
        with urllib.request.urlopen(srv.url("/healthz"), timeout=10) as resp:
            health = json.loads(resp.read().decode())
        assert health["status"] == "ok" and set(health["replicas"]) == {"replica0",
                                                                        "replica1"}
        for r in health["replicas"].values():
            assert r["breaker"] in ("closed", "half_open", "open")
            assert isinstance(r["reasons"], list)
        with urllib.request.urlopen(srv.url("/debug/flight"), timeout=10) as resp:
            j_tel.validate_flight_dump(json.loads(resp.read().decode()))
        with urllib.request.urlopen(srv.url("/metrics"), timeout=10) as resp:
            parsed = telemetry.parse_prometheus(resp.read().decode())
        assert parsed["types"]["mingpt_fleet_replica_up"] == "gauge"
        assert {lb.get("replica") for n, lb, _ in parsed["samples"]
                if n == "mingpt_serve_ttft_seconds_count"} == {"replica0", "replica1"}
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# serve.py's tracing flags
# ---------------------------------------------------------------------------

CORPUS = os.path.join(REPO, "data", "input.txt")
CLI_MODEL = ["--config", os.path.join(REPO, "gpt2_config.yaml"),
             "gpt_config.n_layer=2", "gpt_config.n_head=4", "gpt_config.n_embd=64",
             "gpt_config.dtype=float32", "gpt_config.attn_pdrop=0",
             f"data_config.path={CORPUS}", "data_config.block_size=32",
             "data_config.truncate=0.2"]


@pytest.fixture(scope="module")
def npz_params(tmp_path_factory):
    """A flat npz of a JAX parameter tree at CLI_MODEL's shape."""
    from mingpt_distributed_tpu_torch.config import load_config
    from mingpt_distributed_tpu_torch.data.char_dataset import CharDataset

    ds = CharDataset(load_config(CLI_MODEL[1], CLI_MODEL[2:]).data_config)
    jcfg = JConfig.make(n_layer=2, n_head=4, n_embd=64, dtype="float32",
                        embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0,
                        vocab_size=ds.vocab_size, block_size=32)
    tree = jax.device_get(j_gpt.init(jax.random.key(5), jcfg))
    path = tmp_path_factory.mktemp("npz") / "params.npz"
    np.savez(path, **convert.flatten(tree))
    return str(path)


def test_serve_cli_writes_traces_flight_slo_and_attribution(npz_params, tmp_path, capsys):
    """--trace-jsonl, --trace-sample, --flight-dir, --slo, --slo-json and
    --attrib-json on an offline batch: the trace file holds one trace per
    prompt and passes the JAX validator, the SLO report prints and its JSON
    is mingpt-slo/1, the attribution report validates under the JAX
    package's validator."""
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("the king \nand so \nwhat is \n")
    paths = {k: str(tmp_path / n) for k, n in (("trace", "t.jsonl"),
                                                ("slo", "slo.json"),
                                                ("attrib", "attrib.json"))}
    assert t_serve.main([
        "--prompts-file", str(prompts), "--params", npz_params, "--device", "cpu",
        "--greedy", "--max-new-tokens", "5", "--log-every", "0",
        "--trace-jsonl", paths["trace"], "--trace-sample", "1.0",
        "--flight-dir", str(tmp_path / "flight"), "--slo", "ttft_p99<=60",
        "--slo-json", paths["slo"], "--attrib-json", paths["attrib"],
        *CLI_MODEL]) == 0
    out = capsys.readouterr().out
    assert "SLO report (mingpt-slo/1)" in out
    records = _records(paths["trace"])
    j_tel.validate_trace_records(records)
    assert sum(r["kind"] == "request" for r in records) == 3
    with open(paths["slo"]) as f:
        slo = json.load(f)
    assert slo["schema"] == "mingpt-slo/1" and slo["requests"] == 3
    with open(paths["attrib"]) as f:
        report = json.load(f)
    j_tel.validate_attrib_report(report)
    assert {r["family"] for r in report["programs"] if r["calls"]} >= {"prefill", "decode"}


def test_trace_sample_outside_unit_interval_exits(npz_params, tmp_path):
    prompts = tmp_path / "p.txt"
    prompts.write_text("the \n")
    with pytest.raises(SystemExit, match="trace-sample"):
        t_serve.main(["--prompts-file", str(prompts), "--params", npz_params,
                      "--device", "cpu", "--trace-jsonl", str(tmp_path / "t.jsonl"),
                      "--trace-sample", "1.5", *CLI_MODEL])


def test_trace_module_reads_no_clock():
    """Clock discipline: tracing.py, slo.py and attribution.py import
    nothing that tells time."""
    import ast

    for name in ("tracing", "slo", "attribution"):
        path = os.path.join(REPO, "mingpt_distributed_tpu_torch", "telemetry", f"{name}.py")
        with open(path) as f:
            tree = ast.parse(f.read())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names} | {n.module for n in ast.walk(tree)
                                     if isinstance(n, ast.ImportFrom) and n.module}
        assert not mods & {"time", "datetime"}, (name, mods)


def test_solo_generate_is_unchanged_by_tracing(cfg_params):
    """Tracing observes: the traced server's greedy tokens equal solo
    generate's."""
    cfg, params = cfg_params
    server = InferenceServer(params, cfg, n_slots=2, trace_recorder=TraceRecorder(),
                             device="cpu")
    hs = server.generate_batch([Request(prompt=[3, 4, 5], max_new_tokens=6)])
    want = gen.generate(params, cfg, [[3, 4, 5]], 6, device="cpu")[0, 3:].tolist()
    assert hs[0].tokens == want
