"""The port's telemetry (registry, Prometheus render/parse, JSONL sink, span
tracer) against the JAX package's: the counterparts of
tests/test_telemetry.py's registry, exposition, JSONL and span tests, and
the same operations through both packages giving the same exposition page
and the same parse, the speculation families included; the HTTP endpoint
(``TelemetryServer``) scraped and parsed, and the trainer's gauges and
TensorBoard sink. The recompile watchdog is not ported (ROADMAP.md Queue 1
item 16)."""

import json
import os
import re

import pytest
import torch

from mingpt_distributed_tpu import telemetry as j_tel
from mingpt_distributed_tpu.serving.metrics import ServingMetrics as JServingMetrics
from mingpt_distributed_tpu_torch import telemetry
from mingpt_distributed_tpu_torch.serving.metrics import ServingMetrics
from mingpt_distributed_tpu_torch.telemetry import (
    LATENCY_BUCKETS_S,
    JsonlEventSink,
    MetricsRegistry,
    RateWindow,
    SpanTracer,
    log_event,
    parse_prometheus,
    render_prometheus,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# ---------------------------------------------------------------------------
# RateWindow edge cases
# ---------------------------------------------------------------------------


def test_rate_window_first_call_returns_none():
    assert RateWindow().observe(10.0) is None


def test_rate_window_marker_not_advancing_returns_none():
    w = RateWindow()
    w.observe(5.0, now=0.0)
    assert w.observe(5.0, now=1.0) is None   # unchanged marker
    assert w.observe(4.0, now=2.0) is None   # regressed marker
    # the window still slides: the next advance rates against t=2
    assert w.observe(8.0, now=4.0) == pytest.approx(2.0)


def test_rate_window_zero_elapsed_guard():
    w = RateWindow()
    w.observe(0.0, now=7.0)
    assert w.observe(100.0, now=7.0) is None


def test_rate_window_basic_rate():
    w = RateWindow()
    w.observe(100.0, now=0.0)
    assert w.observe(400.0, now=3.0) == pytest.approx(100.0)


# ---------------------------------------------------------------------------
# Registry semantics
# ---------------------------------------------------------------------------


def test_registry_get_or_create_returns_same_family():
    reg = MetricsRegistry()
    assert reg.counter("mingpt_test_total", help="h") is reg.counter(
        "mingpt_test_total")


def test_registry_conflicting_redefinition_raises():
    reg = MetricsRegistry()
    reg.counter("mingpt_test_total")
    with pytest.raises(ValueError, match="conflicting"):
        reg.gauge("mingpt_test_total")
    reg.counter("mingpt_labeled_total", labels=("a",))
    with pytest.raises(ValueError, match="conflicting"):
        reg.counter("mingpt_labeled_total", labels=("b",))


def test_registry_invalid_names_rejected():
    reg = MetricsRegistry()
    with pytest.raises(ValueError):
        reg.counter("0bad")
    with pytest.raises(ValueError):
        reg.counter("ok_total", labels=("bad-label",))


def test_counter_monotonic():
    c = MetricsRegistry().counter("c_total")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)


def test_labeled_family_memoises_children():
    fam = MetricsRegistry().counter("req_total", labels=("outcome",))
    fam.labels(outcome="ok").inc(3)
    assert fam.labels(outcome="ok").value == 3
    assert fam.labels(outcome="bad").value == 0
    with pytest.raises(ValueError):
        fam.labels(wrong="x")
    with pytest.raises(ValueError):
        fam.inc()  # label-less proxy refused on a labeled family


def test_histogram_buckets_cumulative_and_quantile():
    h = MetricsRegistry().histogram("lat_seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 0.5, 5.0):
        h.observe(v)
    assert h.count == 4
    assert h.sum == pytest.approx(6.05)
    assert h.cumulative() == [(0.1, 1), (1.0, 3), (float("inf"), 4)]
    assert h.quantile(0.5) == 1.0 and h.quantile(1.0) == float("inf")
    h.observe(0.1)  # a boundary value counts into its own bucket (le)
    assert h.cumulative()[0] == (0.1, 2)


def test_histogram_rejects_bad_ladders():
    reg = MetricsRegistry()
    for i, buckets in enumerate([(), (1.0, 1.0), (2.0, 1.0)]):
        with pytest.raises(ValueError):
            reg.histogram(f"h{i}_seconds", buckets=buckets)


# ---------------------------------------------------------------------------
# Prometheus exposition: render + strict parse
# ---------------------------------------------------------------------------


def test_render_and_parse_roundtrip_with_label_escaping():
    reg = MetricsRegistry()
    fam = reg.counter("esc_total", help="weird\nhelp \\ text", labels=("path",))
    nasty = 'a"b\\c\nd'
    fam.labels(path=nasty).inc(2)
    parsed = parse_prometheus(render_prometheus(reg))
    assert parsed["types"]["esc_total"] == "counter"
    [(name, labels, value)] = parsed["samples"]
    assert (name, labels, value) == ("esc_total", {"path": nasty}, 2)


def test_render_histogram_triplet_validated_by_parser():
    reg = MetricsRegistry()
    h = reg.histogram("ttft_seconds", help="ttft", buckets=(0.01, 0.1))
    for v in (0.005, 0.05, 7.0):
        h.observe(v)
    parsed = parse_prometheus(render_prometheus(reg))
    assert parsed["types"]["ttft_seconds"] == "histogram"
    samples = {(n, labels.get("le")): v for n, labels, v in parsed["samples"]}
    assert samples[("ttft_seconds_bucket", "0.01")] == 1
    assert samples[("ttft_seconds_bucket", "0.1")] == 2
    assert samples[("ttft_seconds_bucket", "+Inf")] == 3
    assert samples[("ttft_seconds_count", None)] == 3
    assert samples[("ttft_seconds_sum", None)] == pytest.approx(7.055)


def test_empty_labeled_family_still_renders_type_line():
    reg = MetricsRegistry()
    reg.counter("mingpt_recompiles_total", labels=("family",))
    parsed = parse_prometheus(render_prometheus(reg))
    assert parsed["types"]["mingpt_recompiles_total"] == "counter"
    assert parsed["samples"] == []


@pytest.mark.parametrize("bad", [
    "metric{] 1",
    "metric 1 2 3",
    'metric{le="0.1} 1',
    "# TYPE metric nonsense",
    "0bad_name 1",
])
def test_parse_rejects_malformed_lines(bad):
    with pytest.raises(ValueError):
        parse_prometheus(bad)
    with pytest.raises(ValueError):  # and so does the JAX parser
        j_tel.parse_prometheus(bad)


def test_parse_rejects_incoherent_histogram():
    bad = "\n".join(['# TYPE h histogram', 'h_bucket{le="0.1"} 5',
                     'h_bucket{le="+Inf"} 3', "h_sum 1.0", "h_count 3"])
    with pytest.raises(ValueError, match="cumulative"):
        parse_prometheus(bad)
    bad2 = "\n".join(["# TYPE h histogram", 'h_bucket{le="+Inf"} 3',
                      "h_sum 1.0", "h_count 4"])
    with pytest.raises(ValueError, match="_count"):
        parse_prometheus(bad2)


def _drive_serving_metrics(m):
    m.on_submit()
    m.on_submit()
    m.on_reject()
    m.on_prefill_chunk(n_tokens=5, bucket=8, seconds=0.01)
    m.on_prefill_chunk(n_tokens=3, bucket=4, seconds=0.01)
    m.on_prefill(ttft_s=0.02, stall_s=0.01)
    m.on_prefix_lookup(hit=True, rows=4)
    m.on_tokens(3)
    m.on_complete(n_generated=3, gen_span_s=0.02)
    m.on_step(queue_depth=0, slots_active=1, lanes_used=1)
    m.on_spec_prime("full")
    m.on_spec_round(proposed=3, emitted=4)
    m.on_spec_round(proposed=3, emitted=1)


def _serve_samples(page):
    """The mingpt_serve_* / mingpt_serving_* samples of a page, minus the
    wall-clock prefill-rate and tokens/s gauges."""
    out = {}
    for n, labels, v in parse_prometheus(page)["samples"]:
        if (n.startswith(("mingpt_serve_", "mingpt_serving_"))
                and not n.endswith("per_sec")):
            out[(n, tuple(sorted(labels.items())))] = v
    return out


def test_serving_page_matches_the_jax_package():
    """The same serving events through both packages' ServingMetrics give
    the same exposition samples (names, labels, values, histogram ladders)."""
    reg, jreg = MetricsRegistry(), j_tel.MetricsRegistry()
    _drive_serving_metrics(ServingMetrics(n_slots=2, registry=reg))
    _drive_serving_metrics(JServingMetrics(n_slots=2, registry=jreg))
    got, want = _serve_samples(render_prometheus(reg)), _serve_samples(
        j_tel.render_prometheus(jreg))
    assert got == pytest.approx(want)
    assert ("mingpt_serve_requests_total", (("outcome", "completed"),)) in got
    assert got[("mingpt_serve_spec_accept_rate", ())] == 0.5
    assert got[("mingpt_serve_spec_prime_total", (("mode", "full"),))] == 1


def test_unified_page_carries_serve_families():
    """One registry, one valid exposition page with TTFT/ITL histograms
    and the utilisation and prefix gauges, checked through the strict
    parser."""
    reg = MetricsRegistry()
    _drive_serving_metrics(ServingMetrics(n_slots=2, registry=reg))
    parsed = parse_prometheus(render_prometheus(reg))
    types = parsed["types"]
    assert types["mingpt_serve_ttft_seconds"] == "histogram"
    assert types["mingpt_serve_itl_seconds"] == "histogram"
    assert types["mingpt_serve_slot_utilization"] == "gauge"
    assert types["mingpt_serve_prefix_hit_rate"] == "gauge"
    values = {(n, tuple(sorted(lb.items()))): v for n, lb, v in parsed["samples"]}
    assert values[("mingpt_serve_prefix_hit_rate", ())] == 1.0
    assert values[("mingpt_serve_requests_total", (("outcome", "completed"),))] == 1
    les = sorted(float(lb["le"]) for n, lb, _ in parsed["samples"]
                 if n == "mingpt_serve_ttft_seconds_bucket" and lb["le"] != "+Inf")
    assert les == sorted(LATENCY_BUCKETS_S)


def test_render_matches_the_jax_package_byte_for_byte():
    """Registries driven alike render identical pages."""
    pages = []
    for tel in (telemetry, j_tel):
        reg = tel.MetricsRegistry()
        reg.counter("a_total", help="x\\y", labels=("k",)).labels(k='q"\n').inc(3)
        reg.gauge("b_value").set(2.5)
        h = reg.histogram("c_seconds", buckets=(0.5, 1.0))
        for v in (0.1, 0.7, 3.0):
            h.observe(v)
        pages.append(tel.render_prometheus(reg))
    assert pages[0] == pages[1]


def test_serving_metrics_backcompat_surface():
    m = ServingMetrics(n_slots=4)
    m.on_submit()
    m.on_submit()
    m.on_reject()
    m.on_prefill_chunk(n_tokens=5, bucket=8, seconds=0.01)
    m.on_prefill_chunk(n_tokens=3, bucket=4, seconds=0.01)
    m.on_prefill(ttft_s=0.1, stall_s=0.05)
    m.on_tokens(2)
    m.on_complete(n_generated=2, gen_span_s=0.1)
    m.on_step(queue_depth=1, slots_active=2, lanes_used=1)
    assert m.requests_submitted == 2
    assert m.requests_rejected == 1
    assert m.requests_completed == 1
    assert m.prefill_chunks == 2
    assert m.prefill_tokens == 8
    assert m.prefill_padded_tokens == 12
    assert m.bucket_histogram == {8: 1, 4: 1}
    assert m.ttft_mean_s == pytest.approx(0.1)
    assert m.itl_mean_s == pytest.approx(0.1)
    assert m.admission_stall_mean_s == pytest.approx(0.05)
    assert m.prefill_pad_overhead == pytest.approx(12 / 8)
    assert m.slot_utilization == pytest.approx(0.25)
    assert m.queue_depth == 1 and m.slots_active == 2
    s = m.summary()
    assert s["requests_submitted"] == 2
    assert s["bucket_histogram"] == {"4": 1, "8": 1}
    json.dumps(s)  # the summary stays JSON-serialisable


def test_serving_metrics_log_line(capsys):
    m = ServingMetrics(n_slots=2, log_every=2)
    m.on_submit()
    m.on_tokens(4)
    m.on_step(0, 1, 1)
    assert capsys.readouterr().out == ""
    m.on_step(0, 1, 1)
    line = capsys.readouterr().out
    assert re.match(r"^\[p0\] serve step 2 \| active 1/2 \| queued 0 \| "
                    r"done 0/1 \| tokens 4", line)


# ---------------------------------------------------------------------------
# JSONL event schema
# ---------------------------------------------------------------------------


def test_jsonl_sink_schema(tmp_path):
    p = tmp_path / "events.jsonl"
    sink = JsonlEventSink(str(p))
    sink.write("train_step", {"step": 1, "loss": 3.0})
    sink.write("custom", {"ts": 123.0, "x": "y"})
    sink.close()
    recs = [json.loads(ln) for ln in p.read_text().splitlines()]
    assert all(r["schema"] == telemetry.SCHEMA_VERSION == j_tel.SCHEMA_VERSION
               for r in recs)
    assert recs[0]["kind"] == "train_step" and recs[0]["loss"] == 3.0
    assert isinstance(recs[0]["ts"], float)
    assert recs[1]["ts"] == 123.0  # caller timestamps win


def test_jsonl_sink_needs_exactly_one_target(tmp_path):
    with pytest.raises(ValueError):
        JsonlEventSink()
    with open(tmp_path / "b", "w") as f, pytest.raises(ValueError):
        JsonlEventSink(str(tmp_path / "a"), file=f)


# ---------------------------------------------------------------------------
# Span tracer
# ---------------------------------------------------------------------------


def test_spans_nest_and_record_depth():
    tr = SpanTracer()
    with tr.span("serve.decode_round", lanes=3):
        with tr.span("serve.admit"):
            pass
    inner, outer = tr.records()  # inner exits (and records) first
    assert inner["name"] == "serve.admit" and inner["depth"] == 1
    assert outer["name"] == "serve.decode_round" and outer["depth"] == 0
    assert outer["lanes"] == 3
    assert outer["dur_s"] >= inner["dur_s"] >= 0
    assert outer["kind"] == "span"


def test_span_ring_is_bounded():
    tr = SpanTracer(capacity=8)
    for i in range(20):
        tr.event("e", i=i)
    assert len(tr.records()) == 8
    assert tr.emitted == 20 and tr.dropped == 12
    assert [r["i"] for r in tr.records()] == list(range(12, 20))
    with pytest.raises(ValueError):
        SpanTracer(capacity=0)


def test_disabled_tracer_is_noop_and_allocation_free():
    tr = SpanTracer(enabled=False)
    a, b = tr.span("x"), tr.span("y")
    assert a is b  # one shared no-op context manager
    with a:
        pass
    tr.event("e")
    assert tr.records() == []


def test_tracer_streams_to_jsonl(tmp_path):
    p = tmp_path / "spans.jsonl"
    tr = SpanTracer()
    tr.attach_jsonl(str(p))
    with tr.span("serve.decode_round", lanes=2):
        pass
    tr.event("recompile", family="decode")
    tr.close()
    recs = [json.loads(ln) for ln in p.read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["span", "event"]
    assert recs[0]["schema"] == telemetry.SCHEMA_VERSION
    assert recs[0]["name"] == "serve.decode_round" and recs[0]["lanes"] == 2
    assert recs[1]["family"] == "decode"


def test_log_event_prefixes_and_mirrors(capsys):
    tr = SpanTracer()
    log_event("Snapshot not found. Training model from scratch", tracer=tr)
    out = capsys.readouterr().out
    assert re.match(r"^\[p\d+\] Snapshot not found", out)
    [rec] = tr.records()
    assert rec["kind"] == "event" and rec["name"] == "log"
    assert "from scratch" in rec["message"]
    log_event("no tracer: printed only")
    assert "printed only" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the HTTP endpoint and the trainer's gauges
# ---------------------------------------------------------------------------


def _get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read().decode()


def test_telemetry_server_scrape_parses_and_healthz():
    """port=0 binds an ephemeral port; /metrics is the registry's page
    (through the strict parser, equal to render_prometheus), /healthz the
    liveness document with a provider's keys merged; unknown and unported
    routes answer 404."""
    import urllib.error

    reg = MetricsRegistry()
    _drive_serving_metrics(ServingMetrics(n_slots=2, registry=reg))
    srv = telemetry.TelemetryServer(reg, port=0)
    try:
        assert srv.port > 0 and srv.url("") == f"http://127.0.0.1:{srv.port}"
        status, ctype, body = _get(srv.url("/metrics"))
        assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
        assert body == render_prometheus(reg)
        parsed = parse_prometheus(body)
        assert parsed["types"]["mingpt_serve_spec_tokens_per_verify"] == "histogram"
        status, _, body = _get(srv.url("/healthz"))
        doc = json.loads(body)
        assert status == 200 and doc["status"] == "ok" and doc["uptime_s"] >= 0
        srv.health_provider = lambda: {"replicas": 1}
        assert json.loads(_get(srv.url("/healthz"))[2])["replicas"] == 1
        srv.health_provider = lambda: 1 / 0
        doc = json.loads(_get(srv.url("/healthz"))[2])
        assert doc["status"] == "error" and "ZeroDivisionError" in doc["health_provider_error"]
        srv.metrics_provider = lambda: "# TYPE x gauge\nx 1\n"
        assert parse_prometheus(_get(srv.url("/metrics"))[2])["types"] == {"x": "gauge"}
        for path in ("/debug/flight", "/attrib", "/nope"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(srv.url(path))
            assert e.value.code == 404
    finally:
        srv.close()


def test_the_process_registry_is_one():
    assert telemetry.get_registry() is telemetry.get_registry()
    assert isinstance(telemetry.get_registry(), MetricsRegistry)


def test_trainer_gauges_match_the_jax_logger_families():
    """The step line's scalars land on mingpt_train_* gauges, as the JAX
    logger's do (both loggers silent)."""
    from mingpt_distributed_tpu.config import GPTConfig as JConfig
    from mingpt_distributed_tpu.training.metrics import MetricsLogger as JLogger
    from mingpt_distributed_tpu_torch.config import GPTConfig
    from mingpt_distributed_tpu_torch.training.metrics import MetricsLogger

    kw = dict(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32)
    reg, jreg = MetricsRegistry(), j_tel.MetricsRegistry()
    t = MetricsLogger(GPTConfig.make(**kw), enabled=False, registry=reg)
    j = JLogger(JConfig.make(**kw), enabled=False, registry=jreg)
    for logger in (t, j):
        logger.log_step(3, 64, 32, {"loss": 2.5, "grad_norm": 1.25, "lr": 1e-3})
    names = lambda page, parse: {n: v for n, _, v in parse(page)["samples"]}  # noqa: E731
    got = names(render_prometheus(reg), parse_prometheus)
    want = names(j_tel.render_prometheus(jreg), j_tel.parse_prometheus)
    for key in ("mingpt_train_step", "mingpt_train_loss", "mingpt_train_grad_norm",
                "mingpt_train_lr"):
        assert got[key] == want[key]
    assert "mingpt_train_mfu" in got and "mingpt_train_mfu" in want


def test_tensorboard_sink_writes_scalars(tmp_path):
    from mingpt_distributed_tpu_torch.config import GPTConfig
    from mingpt_distributed_tpu_torch.training.metrics import MetricsLogger

    cfg = GPTConfig.make(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32)
    m = MetricsLogger(cfg, tensorboard_dir=str(tmp_path / "tb"))
    m.log_step(1, 64, 32, {"loss": 3.0})
    m.log_step(2, 64, 32, {"loss": 2.0})
    m.close()
    files = os.listdir(tmp_path / "tb")
    assert len(files) == 1 and files[0].startswith("events.out.tfevents")
    assert os.path.getsize(tmp_path / "tb" / files[0]) > 0


def test_tensorboard_sink_degrades_without_the_writer(tmp_path, monkeypatch, capsys):
    """Where torch.utils.tensorboard cannot be imported the logger says so
    and keeps its other sinks."""
    import builtins

    from mingpt_distributed_tpu_torch.config import GPTConfig
    from mingpt_distributed_tpu_torch.training.metrics import MetricsLogger

    real_import = builtins.__import__

    def no_tensorboard(name, *a, **kw):
        if name == "torch.utils.tensorboard":
            raise ImportError("no tensorboard here")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    cfg = GPTConfig.make(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32)
    m = MetricsLogger(cfg, tensorboard_dir=str(tmp_path / "tb"),
                      jsonl_path=str(tmp_path / "m.jsonl"))
    m.log_step(1, 64, 32, {"loss": 3.0})
    m.close()
    assert "tensorboard sink unavailable" in capsys.readouterr().out
    assert json.loads(open(tmp_path / "m.jsonl").read())["loss"] == 3.0


# ---------------------------------------------------------------------------
# the recompile watchdog (counterparts of tests/test_telemetry.py's)
# ---------------------------------------------------------------------------


def _counts_fn(box):
    return lambda: dict(box)


def test_watchdog_unarmed_is_dormant():
    box = {"prefill": 0, "decode": 0}
    wd = telemetry.RecompileWatchdog(_counts_fn(box), registry=MetricsRegistry())
    box["decode"] = 5  # shapes before warmup are free
    assert wd.check() == 0
    assert not wd.armed and wd.recompiles == 0


def test_watchdog_counts_each_new_shape_once():
    box = {"prefill": 2, "decode": 1}
    reg = MetricsRegistry()
    tr = SpanTracer()
    wd = telemetry.RecompileWatchdog(_counts_fn(box), registry=reg, tracer=tr)
    wd.arm()
    assert wd.check() == 0
    box["prefill"] = 4
    assert wd.check() == 2
    assert wd.check() == 0
    assert wd.recompiles == 2
    fam = reg.counter("mingpt_recompiles_total", labels=("family",))
    assert fam.labels(family="prefill").value == 2
    assert any(r["name"] == "recompile" for r in tr.records())


def test_watchdog_hard_fail_raises():
    box = {"decode": 1}
    wd = telemetry.RecompileWatchdog(_counts_fn(box), registry=MetricsRegistry(),
                                     hard_fail=True)
    wd.arm()
    box["decode"] = 2
    with pytest.raises(telemetry.RecompileError, match="decode"):
        wd.check()


def test_watchdog_hard_fail_via_env(monkeypatch):
    monkeypatch.setenv("MINGPT_RECOMPILE_FATAL", "1")
    box = {"decode": 0}
    wd = telemetry.RecompileWatchdog(_counts_fn(box), registry=MetricsRegistry())
    wd.arm()
    box["decode"] = 1
    with pytest.raises(telemetry.RecompileError):
        wd.check()


def test_server_watchdog_stays_at_zero_after_warmup():
    """The scheduler arms its watchdog after warmup and checks every round:
    a warmed server's traffic adds no shape; an unwarmed one is never
    armed."""
    from mingpt_distributed_tpu_torch.config import GPTConfig
    from mingpt_distributed_tpu_torch.models import gpt as t_gpt
    from mingpt_distributed_tpu_torch.serving import InferenceServer, Request

    cfg = GPTConfig.make(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32,
                         embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
    params = t_gpt.init(cfg, torch.Generator().manual_seed(0))
    reg = MetricsRegistry()
    srv = InferenceServer(params, cfg, n_slots=2, warmup=True, registry=reg,
                          recompile_fail=True, prefill_buckets=(8, 32), prefill_chunk=8,
                          prefix_cache_mb=1.0, device="cpu")
    srv.generate_batch([Request(prompt=list(range(1, 1 + n)), max_new_tokens=4)
                        for n in (3, 12, 20, 9)])
    assert srv.watchdog.armed and srv.watchdog.recompiles == 0
    assert ("mingpt_recompiles_total" in parse_prometheus(render_prometheus(reg))["types"])
    cold = InferenceServer(params, cfg, n_slots=1, registry=MetricsRegistry(), device="cpu")
    cold.generate_batch([Request(prompt=[1, 2], max_new_tokens=2)])
    assert not cold.watchdog.armed


# ---------------------------------------------------------------------------
# the peak table: one source (counterparts of tests/test_telemetry.py's)
# ---------------------------------------------------------------------------


def test_peak_table_is_the_h100s_and_finite():
    from mingpt_distributed_tpu_torch.telemetry import peaks

    assert set(peaks.PEAKS) == {"H100"}
    # float16's dense rate is bfloat16's (the data sheet's 989 TFLOP/s)
    assert peaks.H100_SXM == {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
                              "hbm_bytes_per_s": 3.35e12}
    assert peaks.peak_flops("NVIDIA H100 80GB HBM3", "bfloat16") == 989e12
    assert peaks.peak_flops("NVIDIA A100-SXM4-80GB", "bfloat16") is None
    assert peaks.peak_flops(None, "bfloat16") is None
    if not torch.cuda.is_available():
        assert peaks.peak_flops_per_chip() is None
        assert peaks.peak_hbm_bytes_per_chip() is None
        assert peaks.peak_hbm_capacity_per_chip() is None


def test_training_metrics_reexports_peaks():
    from mingpt_distributed_tpu_torch.telemetry import peaks
    from mingpt_distributed_tpu_torch.training import metrics as tm

    assert tm.PEAKS is peaks.PEAKS is telemetry.PEAKS
    assert tm.H100_SXM is peaks.H100_SXM
    assert tm.peak_flops is peaks.peak_flops


def test_get_registry_and_tracer_are_process_singletons():
    assert telemetry.get_registry() is telemetry.get_registry()
    assert telemetry.get_tracer() is telemetry.get_tracer()
