"""The port's trace_summary (mingpt_distributed_tpu_torch/tools/trace_summary.py)
against a real torch.profiler CPU capture, and against the JAX tool
(tools/trace_summary.py) on every input both read.

One counterpart per case of tests/test_trace_summary.py, with a
torch.profiler capture of a tiny port forward in place of the jax.profiler
one. For the span JSONL, mingpt-trace/1 (with and without --slo),
mingpt-control/1 and mingpt-attrib/1 inputs and --compare, one file is
written with the port's own writers and both tools' main must print
identical stdout. Then what only the port reads: a .json.gz trace, two
files of one directory, a CUDA-shaped trace whose device events are a lane
of their own, and the refusal of a .json that is neither a trace nor an
attribution report.
"""

import gzip
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

from mingpt_distributed_tpu_torch import telemetry
from mingpt_distributed_tpu_torch import traffic as traffic_cli
from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models import gpt
from mingpt_distributed_tpu_torch.serving import InferenceServer, Request
from mingpt_distributed_tpu_torch.telemetry import SpanTracer, TraceRecorder, trace_sink
from mingpt_distributed_tpu_torch.tools import trace_summary
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_trace_summary", os.path.join(REPO, "tools", "trace_summary.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_tool = _jax_tool()


@pytest.fixture(scope="module")
def cpu_trace_dir(tmp_path_factory):
    """A real torch.profiler capture of a tiny port forward on the CPU,
    written as the trainer writes its window."""
    outdir = tmp_path_factory.mktemp("trace")
    cfg = GPTConfig.make(n_layer=2, n_head=4, n_embd=64, vocab_size=96, block_size=32,
                         dtype="float32", embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    params = gpt.init(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 96, (2, 32))).long()
    gpt.forward(params, tokens, cfg)  # outside the trace, as the trainer's first steps
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            gpt.forward(params, tokens, cfg)
    prof.export_chrome_trace(str(outdir / "trace_steps_1-4.json"))
    return str(outdir)


def test_load_trace_finds_real_capture(cpu_trace_dir):
    trace = trace_summary.load_trace(cpu_trace_dir)
    events = trace["traceEvents"]
    assert events, "captured trace has no events"
    xs = [e for e in events if e.get("ph") == "X"]
    assert xs, "no complete (ph=X) events in the captured trace"
    assert any(float(e.get("dur", 0)) > 0 for e in xs)
    assert any(e.get("name", "").startswith("aten::") for e in xs)


def test_summarize_real_capture_structure(cpu_trace_dir):
    trace = trace_summary.load_trace(cpu_trace_dir)
    out = trace_summary.summarize(trace, top=5)
    text = "\n".join(out)
    assert out[0].startswith("trace span:")
    span_ms = float(out[0].split("trace span:")[1].split("ms")[0])
    assert span_ms > 0
    # the host thread is named from the process_name/thread_name metadata
    assert "== lane python" in text or "== lane " in text
    assert "aten::" in text
    for line in out:
        if line.startswith("\n== lane ") or line.startswith("== lane "):
            busy_ms = float(line.split("busy ")[1].split(" ms")[0])
            assert busy_ms <= span_ms * 1.001, line


def test_main_end_to_end(cpu_trace_dir, capsys):
    rc = trace_summary.main([cpu_trace_dir, "--top", "3"])
    assert rc == 0
    cap = capsys.readouterr()
    assert "trace span:" in cap.out
    assert "== lane " in cap.out
    # one file as the argument summarises the same
    rc = trace_summary.main([os.path.join(cpu_trace_dir, "trace_steps_1-4.json"),
                             "--top", "3"])
    assert rc == 0 and capsys.readouterr().out == cap.out


def test_main_missing_dir(tmp_path, capsys):
    rc = trace_summary.main([str(tmp_path / "nope")])
    assert rc == 1
    assert "no torch.profiler trace" in capsys.readouterr().err


def _fake_trace(events):
    return {"traceEvents": events}


def test_busy_union_on_overlapping_events():
    """Nested/overlapping events must not double-count busy time."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "devlane"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 2,
         "args": {"name": "stream 7"}},
        {"ph": "X", "pid": 1, "tid": 2, "name": "outer", "ts": 0.0,
         "dur": 100.0},
        {"ph": "X", "pid": 1, "tid": 2, "name": "inner", "ts": 10.0,
         "dur": 50.0},
        {"ph": "X", "pid": 1, "tid": 2, "name": "tail", "ts": 200.0,
         "dur": 50.0},
    ]
    out = trace_summary.summarize(_fake_trace(events), top=10)
    text = "\n".join(out)
    assert "trace span: 0.25 ms" in out[0]
    assert "busy 0.15 ms" in text
    assert "outer" in text and "inner" in text and "tail" in text
    assert out == jax_tool.summarize(_fake_trace(events), top=10)


def test_busy_union_chained_extension():
    events = [
        {"ph": "X", "pid": 9, "tid": 1, "name": "a", "ts": 0.0, "dur": 30.0},
        {"ph": "X", "pid": 9, "tid": 1, "name": "b", "ts": 20.0, "dur": 30.0},
        {"ph": "X", "pid": 9, "tid": 1, "name": "c", "ts": 40.0, "dur": 30.0},
    ]
    out = trace_summary.summarize(_fake_trace(events), top=10)
    assert "busy 0.07 ms" in "\n".join(out)
    table, t0, t1 = trace_summary.lanes(_fake_trace(events))
    assert (t0, t1) == (0.0, 70.0)
    assert table[("9", "1")] == {"ops": {"a": [30.0, 1], "b": [30.0, 1], "c": [30.0, 1]},
                                 "busy_us": 70.0}


def _spans(path):
    tr = SpanTracer()
    tr.attach_jsonl(str(path))
    with tr.span("train.step", step=1):
        with tr.span("train.snapshot"):
            pass
    with tr.span("serve.decode_round", lanes=2):
        pass
    tr.event("recompile", family="decode")  # no duration: must be skipped
    tr.close()


def test_span_jsonl_input(tmp_path, capsys):
    p = tmp_path / "spans.jsonl"
    _spans(p)
    trace = trace_summary.load_span_jsonl(str(p))
    assert all(e["ph"] == "X" for e in trace["traceEvents"])
    assert {e["tid"] for e in trace["traceEvents"]} == {"train", "serve"}
    assert len(trace["traceEvents"]) == 3

    rc = trace_summary.main([str(p), "--top", "5"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "trace span:" in out
    assert "train.step" in out and "serve.decode_round" in out


def test_span_jsonl_without_spans_errors(tmp_path, capsys):
    p = tmp_path / "empty.jsonl"
    p.write_text('{"schema": "mingpt-telemetry/1", "kind": "event"}\n')
    rc = trace_summary.main([str(p)])
    assert rc == 1
    assert "no span records" in capsys.readouterr().err


def _tiny_trace_doc(name, pid=7):
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0, "args": {"name": "python"}},
        {"ph": "X", "pid": pid, "tid": pid, "name": name, "ts": 0.0, "dur": 10.0}]}


def test_multirank_pid_namespacing(tmp_path, capsys):
    """Two ranks' (or two windows') files in one directory keep separate
    lanes, each pid namespaced by its file's name less the suffix; a
    .json.gz counts, and a JSON file that is no trace is skipped."""
    (tmp_path / "rank0.json").write_text(json.dumps(_tiny_trace_doc("op_rank0")))
    with gzip.open(tmp_path / "rank1.json.gz", "wt") as f:
        json.dump(_tiny_trace_doc("op_rank1"), f)
    (tmp_path / "attrib.json").write_text('{"schema": "mingpt-attrib/1"}')
    trace = trace_summary.load_trace(str(tmp_path))
    pids = {e["pid"] for e in trace["traceEvents"]}
    assert pids == {"rank0:7", "rank1:7"}
    out = "\n".join(trace_summary.summarize(trace, top=5))
    assert "op_rank0" in out and "op_rank1" in out
    # both processes are named "python": the names are namespaced too
    assert "lanes: 2" in out
    assert "== lane rank0:python / 7" in out and "== lane rank1:python / 7" in out


def _write_request_trace(path):
    """mingpt-trace/1 with the port's recorder: one clean request, one
    retried, one shed."""
    rec = TraceRecorder(sink=trace_sink(str(path)))
    ctx = rec.start_trace("req-0", now=0.0)
    rec.add_span(ctx, "serve.queue_wait", ts=0.0, dur_s=0.1)
    rec.add_event(ctx, "emit", 0.2, token_index=0)
    rec.add_event(ctx, "emit", 0.3, token_index=1)
    rec.end_trace(ctx, now=0.3, outcome="length", n_tokens=2)

    ctx = rec.start_trace("req-1", now=1.0)
    a1 = rec.open_span(ctx, "fleet.attempt", 1.0, attempt=1, replica="replica0")
    rec.close_span(a1, 1.1, outcome="crash")
    rec.add_event(ctx, "retry", 1.1, reason="crash", attempt=1)
    a2 = rec.open_span(ctx, "fleet.attempt", 1.2, attempt=2, replica="replica1")
    rec.add_event(ctx, "emit", 1.3, token_index=0)
    rec.close_span(a2, 1.4, outcome="length")
    rec.end_trace(ctx, now=1.4, outcome="length", n_tokens=1, attempts=2)

    ctx = rec.start_trace("shed-0", now=2.0)
    rec.add_event(ctx, "shed", 2.0, reason="draining")
    rec.end_trace(ctx, now=2.0, outcome="shed", n_tokens=0, attempts=0)
    rec.close()


def test_request_trace_timeline(tmp_path, capsys):
    p = tmp_path / "trace.jsonl"
    _write_request_trace(p)
    assert trace_summary.sniff_jsonl_schema(str(p)) == "mingpt-trace/1"
    rc = trace_summary.main([str(p)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "request traces: 3" in out
    assert "== req-0: outcome=length tokens=2" in out
    assert "serve.queue_wait" in out and "emit x2" in out
    assert "== req-1: " in out and "RETRIED" in out
    assert out.count("fleet.attempt") == 2
    assert "RETRY retry reason=crash" in out
    assert "== shed-0: outcome=shed" in out


def test_request_trace_slo_mode(tmp_path, capsys):
    p = tmp_path / "trace.jsonl"
    _write_request_trace(p)
    rc = trace_summary.main([str(p), "--slo", "ttft_p50<=1.0,shed_rate<=0.05"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "SLO report" in out
    assert "[ PASS ] ttft_p50" in out
    assert "[ FAIL ] shed_rate" in out


def test_request_trace_invalid_stream_errors(tmp_path, capsys):
    p = tmp_path / "bad.jsonl"
    p.write_text(json.dumps({
        "schema": "mingpt-trace/1", "kind": "span", "trace_id": "t",
        "span_id": "s1", "parent_id": "s9", "name": "x", "ts": 0.0,
        "dur_s": 1.0}) + "\n")
    rc = trace_summary.main([str(p)])
    assert rc == 1
    assert "invalid mingpt-trace/1 stream" in capsys.readouterr().err


def test_slo_flag_rejects_non_trace_input(tmp_path, capsys):
    p = tmp_path / "spans.jsonl"
    p.write_text('{"schema": "mingpt-telemetry/1", "kind": "span", '
                 '"name": "train.step", "ts": 0.0, "dur_s": 1.0}\n')
    rc = trace_summary.main([str(p), "--slo"])
    assert rc == 1
    assert "--slo needs a mingpt-trace/1" in capsys.readouterr().err


def _slo_report(spec, rows):
    return telemetry.evaluate_slos(rows, telemetry.parse_slo_spec(spec))


def _slo_pair(tmp_path):
    spec = "ttft_p50<=0.5,shed_rate<=0.5"
    fast = [{"ttft_s": 0.05, "itl_s": [0.01], "outcome": "length"}] * 4
    slow = [{"ttft_s": 0.90, "itl_s": [0.01], "outcome": "length"}] * 4
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps(_slo_report(spec, fast)))
    b.write_text(json.dumps(_slo_report(spec, slow)))
    return a, b


def test_compare_slo_reports(tmp_path, capsys):
    a, b = _slo_pair(tmp_path)
    rc = trace_summary.main(["--compare", str(a), str(b)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "SLO diff" in out and "grade A -> " in out
    assert "regressed" in out
    assert "same" in out
    rc = trace_summary.main(["--compare", str(b), str(a)])
    assert rc == 0
    assert "fixed" in capsys.readouterr().out


def test_compare_rejects_unreadable_or_wrong_schema(tmp_path, capsys):
    good = tmp_path / "good.json"
    good.write_text(json.dumps(_slo_report(
        "ttft_p50<=0.5", [{"ttft_s": 0.1, "itl_s": [], "outcome": "eos"}])))

    rc = trace_summary.main(["--compare", str(good), str(tmp_path / "missing.json")])
    assert rc == 1
    assert "cannot read SLO report" in capsys.readouterr().err

    bad = tmp_path / "bad.json"
    bad.write_text('{"schema": "something-else/9"}')
    rc = trace_summary.main(["--compare", str(good), str(bad)])
    assert rc == 1
    assert "not mingpt-slo/1" in capsys.readouterr().err


# -- the same stdout as the JAX tool, on files the port wrote ---------------------


def _control_log(path):
    """A mingpt-control/1 log from the port's autoscaler: traffic
    --selftest-controller's autoscaled cell on the tiny model."""
    cfg = traffic_cli.tiny_config()
    params = gpt.init(cfg, torch.Generator().manual_seed(0))
    _, logs = traffic_cli.run_with_logs(params, cfg, traffic_cli.selftest_controller_spec(),
                                        traffic_cli.selftest_mix(), dict(device="cpu"))
    (text,) = logs.values()
    path.write_text(text)


def _attrib_report(path):
    """A mingpt-attrib/1 report from the port's server with attribution on."""
    cfg = GPTConfig.make(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32,
                         embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
    params = gpt.init(cfg, torch.Generator().manual_seed(0))
    srv = InferenceServer(params, cfg, n_slots=2, attrib=True, device="cpu")
    srv.generate_batch([Request(prompt=[1, 2, 3], max_new_tokens=4),
                        Request(prompt=[4, 5], max_new_tokens=3)])
    path.write_text(telemetry.dump_attrib_report(srv.attrib_report()))


def _inputs(kind, tmp_path):
    """(argv, expected exit code) of one input kind, its file written."""
    if kind == "spans":
        p = tmp_path / "spans.jsonl"
        _spans(p)
        return [str(p), "--top", "2"], 0
    if kind in ("request_trace", "request_trace_slo"):
        p = tmp_path / "trace.jsonl"
        _write_request_trace(p)
        return [str(p)] + (["--slo"] if kind == "request_trace_slo" else []), 0
    if kind == "control":
        p = tmp_path / "control.jsonl"
        _control_log(p)
        return [str(p), "--top", "3"], 0
    if kind == "attrib":
        p = tmp_path / "attrib.json"
        _attrib_report(p)
        return [str(p)], 0
    a, b = _slo_pair(tmp_path)
    return ["--compare", str(a), str(b)], 0


@pytest.mark.parametrize("kind", ["spans", "request_trace", "request_trace_slo", "control",
                                  "attrib", "compare"])
def test_stdout_equals_the_jax_tools(kind, tmp_path, capsys):
    argv, want_rc = _inputs(kind, tmp_path)
    assert jax_tool.main(argv) == want_rc
    jax_out = capsys.readouterr().out
    assert trace_summary.main(argv) == want_rc
    out = capsys.readouterr().out
    assert out and out == jax_out


# -- what only the port reads -----------------------------------------------------


def test_gzipped_trace_file(cpu_trace_dir, tmp_path, capsys):
    src = os.path.join(cpu_trace_dir, "trace_steps_1-4.json")
    gz = tmp_path / "trace_steps_1-4.json.gz"
    with open(src, "rb") as f, gzip.open(gz, "wb") as g:
        shutil.copyfileobj(f, g)
    assert trace_summary.main([str(gz)]) == 0
    out = capsys.readouterr().out
    assert trace_summary.main([src]) == 0
    assert out == capsys.readouterr().out


# A CUDA-shaped trace as torch.profiler writes one on an H100: the host
# process and its thread, the device as pid 0 (named like the host, labelled
# "GPU 0") and its stream 7; kernels, a copy and a memset on the stream, and
# a record_function range drawn there (gpu_user_annotation); flow, instant
# and counter events, which carry no lane time
CUDA_TRACE = {"traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 4242, "tid": 0, "args": {"name": "python3"}},
    {"ph": "M", "name": "thread_name", "pid": 4242, "tid": 4242,
     "args": {"name": "thread 4242 (python3)"}},
    {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "python3"}},
    {"ph": "M", "name": "process_labels", "pid": 0, "tid": 0, "args": {"labels": "GPU 0"}},
    {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7 "}},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 4242, "tid": 4242,
     "ts": 0.0, "dur": 40.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 4242, "tid": 4242,
     "ts": 5.0, "dur": 10.0},
    {"ph": "X", "cat": "kernel", "name": "void flash_fwd_bf16_kernel<64>", "pid": 0, "tid": 7,
     "ts": 20.0, "dur": 30.0},
    {"ph": "X", "cat": "kernel", "name": "void flash_fwd_bf16_kernel<64>", "pid": 0, "tid": 7,
     "ts": 60.0, "dur": 30.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "pid": 0,
     "tid": 7, "ts": 90.0, "dur": 10.0},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0, "tid": 7,
     "ts": 150.0, "dur": 50.0},
    {"ph": "X", "cat": "gpu_user_annotation", "name": "Optimizer.step#AdamW.step", "pid": 0,
     "tid": 7, "ts": 20.0, "dur": 180.0},
    {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 4242, "tid": 4242, "ts": 5.0},
    {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 0, "tid": 7, "ts": 20.0,
     "bp": "e"},
    {"ph": "i", "cat": "cpu_instant_event", "name": "[memory]", "pid": 4242, "tid": 4242,
     "ts": 900.0, "s": "t"},
    {"ph": "C", "name": "memory", "pid": 0, "ts": 1000.0, "args": {"bytes": 1}},
]}


def test_cuda_trace_device_events_are_their_own_lane(tmp_path, capsys):
    table, t0, t1 = trace_summary.lanes(CUDA_TRACE)
    assert (t0, t1) == (0.0, 200.0)  # instant and counter events carry no time
    device = table[("python3", "stream 7 ")]
    assert device["busy_us"] == 30.0 + 40.0 + 50.0  # 20..50, 60..100, 150..200
    assert device["ops"]["void flash_fwd_bf16_kernel<64>"] == [60.0, 2]
    assert "Optimizer.step#AdamW.step" not in device["ops"]
    assert table[("python3", "stream 7  annotations")]["busy_us"] == 180.0
    assert table[("python3", "thread 4242 (python3)")]["busy_us"] == 40.0
    p = tmp_path / "cuda.json"
    p.write_text(json.dumps(CUDA_TRACE))
    assert trace_summary.main([str(p)]) == 0
    out = capsys.readouterr().out
    assert "trace span: 0.20 ms, lanes: 3" in out
    assert "== lane python3 / stream 7 : busy 0.12 ms (60% of span)" in out


def test_a_json_that_is_no_trace_and_no_attrib_report_is_refused(tmp_path, capsys):
    p = tmp_path / "other.json"
    p.write_text('{"schema": "mingpt-slo/1"}')
    assert trace_summary.main([str(p)]) == 1
    assert "expected a mingpt-attrib/1 report, got schema='mingpt-slo/1'" in \
        capsys.readouterr().err
    p.write_text("not json")
    assert trace_summary.main([str(p)]) == 1
    assert "cannot read" in capsys.readouterr().err


@pytest.mark.parametrize("window, want", [
    ((2, 4), [("enter", 1), ("step", 2), ("exit", 4)]),
    ((1, 3), [("enter", 0), ("step", 1), ("exit", 3)]),
])
def test_trainer_profile_window_warms_up_a_step_early(window, want, tmp_path, monkeypatch,
                                                     capsys):
    """The trainer's profile_dir window, trace_summary's profile input: its
    tracer starts one step before the window (torch.profiler's warmup, at
    the run's start for a window after step 1), records from the window's
    first edge and is written at its last."""
    from mingpt_distributed_tpu_torch import train as t_train
    from mingpt_distributed_tpu_torch.training.trainer import GPTTrainer

    calls, current = [], []

    class FakeProfile:
        def __init__(self, activities, schedule):
            assert schedule(0) == torch.profiler.ProfilerAction.WARMUP
            assert schedule(1) == torch.profiler.ProfilerAction.RECORD

        def __enter__(self):
            calls.append(("enter", current[-1]))
            return self

        def step(self):
            calls.append(("step", current[-1]))

        def __exit__(self, *exc):
            calls.append(("exit", current[-1]))

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": []}, f)

    real = GPTTrainer._profile

    def profile(self, step):
        current.append(step)
        real(self, step)

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(GPTTrainer, "_profile", profile)
    first, last = window
    assert t_train.main([
        "--config", os.path.join(REPO, "gpt2_config.yaml"), "--device", "cpu",
        "gpt_config.n_layer=1", "gpt_config.n_head=2", "gpt_config.n_embd=32",
        "gpt_config.dtype=float32", "gpt_config.attn_pdrop=0",
        f"data_config.path={os.path.join(REPO, 'data', 'input.txt')}",
        "data_config.block_size=16", "data_config.truncate=0.05",
        "trainer_config.batch_size=4", "trainer_config.eval_batches=1",
        "trainer_config.max_steps=5", f"trainer_config.profile_dir={tmp_path / 'prof'}",
        f"trainer_config.profile_steps=[{first},{last}]",
        f"trainer_config.snapshot_path={tmp_path / 'snap.pt'}"]) == 0
    assert calls == want
    assert os.listdir(tmp_path / "prof") == [f"trace_steps_{first}-{last}.json"]
