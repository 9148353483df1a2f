"""Continuous-batching inference server entry point of the port.

Counterpart of the repository's ``serve.py`` (its single-server branch):
where ``sample.py`` decodes one prompt per process, this drives the
``serving/`` package: a slot-based KV scheduler over the cached decode path
that admits new prompts mid-decode, streams tokens per request as they are
produced, and reports serving metrics (tokens/s, queue depth, slot
utilisation, TTFT, inter-token latency). Runs on CUDA unless ``--device
cpu``.

Modes:

  REPL (default)      read prompts from stdin one line at a time, stream
                      each completion as it decodes
  offline batch       drain a file of prompts (one per line) through the
                      scheduler concurrently, print the completions:
                        --prompts-file prompts.txt
  self-test           no weights needed: a random-init small model, three
                      canned prompts through 2 slots (forces queueing),
                      greedy outputs checked token-identical to solo
                      generate() and the shape counts bounded by the
                      bucket ladder: --selftest (with --metrics-port, its
                      own /metrics and /healthz scraped and parsed)
  spec self-test      speculative decoding token-identical to solo
                      generate() with an identical draft (accept rate 1)
                      and a 1-layer draft with chunks and prefix reuse,
                      one verify shape: --selftest-spec
  quant self-test     int8 (and fp8) KV pools with chunks, prefix reuse
                      and speculation against the fp32 pool: common greedy
                      prefix >= 0.9, equal shape counts, <= 0.27x the pool
                      bytes, power-of-two scales: --selftest-quant

Speculative decoding: ``--draft-config self|self:N|k=v,...`` with
``--spec-k K``; the KV pool's storage: ``--kv-dtype fp32|int8|fp8``;
``--metrics-port P`` serves the process registry on ``/metrics`` and
``/healthz`` (0 binds an ephemeral port, printed at start).

The weights (REPL and batch) come from the snapshot the port's trainer
wrote at ``trainer_config.snapshot_path`` (``training/checkpoint.py``
``restore_inference_params``) or from ``--params FILE.npz`` (a JAX
parameter pytree flattened to ``"blocks/wq"``-style keys, as ``sample.py``
takes). The vocabulary is the corpus's by ``data_config.tokenizer`` (char
or bpe), as in training; ``section.key=value`` overrides as in ``train.py``.

Usage:
  python -m mingpt_distributed_tpu_torch.serve --selftest [--device cpu]
  python -m mingpt_distributed_tpu_torch.serve --selftest-spec [--device cpu]
  python -m mingpt_distributed_tpu_torch.serve --selftest-quant [--device cpu]
  python -m mingpt_distributed_tpu_torch.serve --selftest-attrib [--device cpu]
  python -m mingpt_distributed_tpu_torch.serve --prompts-file prompts.txt \\
      [--config gpt2_config.yaml] [--slots 4] [--greedy] \\
      [--prefill-chunk 256] [--prefix-cache-mb 64] [--warmup] \\
      [trainer_config.snapshot_path=...] [section.key=value ...]

Telemetry: ``--trace-jsonl PATH`` exports request traces (mingpt-trace/1;
``--trace-sample P`` samples the happy path), ``--flight-dir DIR`` arms the
flight recorder (dumps on a post-warmup new shape and on a SIGTERM drain,
``/debug/flight`` on ``--metrics-port``), ``--slo [SPEC]`` and ``--slo-json
PATH`` grade SLOs from the traces at shutdown, ``--attrib-json PATH`` writes
the attribution report (``/attrib`` on ``--metrics-port``);
``--selftest-attrib`` is the attribution self-test.

SIGTERM (or one SIGINT) stops admission, drains in-flight requests, flushes
the metrics and exits 75 so a scheduler requeues the job; a second SIGINT
aborts. The JAX serve.py's other flags are parsed and refused (exit 2),
naming the ROADMAP.md Queue 1 item that brings them (``UNPORTED_FLAGS``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import sys
from typing import List

import numpy as np

from mingpt_distributed_tpu_torch.config import GPTConfig, load_config
from mingpt_distributed_tpu_torch.data.token_dataset import make_dataset
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import generate as gen
from mingpt_distributed_tpu_torch.models import gpt
from mingpt_distributed_tpu_torch import telemetry
from mingpt_distributed_tpu_torch.serving import InferenceServer, Request
from mingpt_distributed_tpu_torch.serving import quant as quant_lib
from mingpt_distributed_tpu_torch.training import checkpoint as ckpt_lib
from mingpt_distributed_tpu_torch.training.metrics import MetricsLogger
from mingpt_distributed_tpu_torch.training.trainer import REQUEUE_EXIT_CODE
from mingpt_distributed_tpu_torch.utils.device import resolve_device

# the JAX serve.py's flags that the port does not run yet, each with the
# ROADMAP.md Queue 1 item that brings it
UNPORTED_FLAGS = {
    "--mesh": "9", "--selftest-sharded": "9",
    "--replicas": "15", "--isolation": "15", "--autoscale": "15",
    "--slo-target": "15", "--control-log": "15", "--shed-watermark": "15",
    "--chaos-spec": "15", "--spill-dir": "15", "--standby": "15",
    "--hang-deadline": "15", "--hosts": "15", "--fleet-secret": "15",
    "--selftest-chaos": "15", "--selftest-procfleet": "15",
    "--selftest-standby": "15", "--selftest-crosshost": "15",
}

SELFTEST_PROMPTS = ["O God, O God!", "Once more unto", "All the world's"]
SELFTEST_SHARED = ["Once more unto the breach", "Once more unto the wall!"]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="gpt2_config.yaml")
    p.add_argument("--params", default=None,
                   help="flat .npz of the JAX parameter pytree (default: the "
                        "trainer's snapshot at trainer_config.snapshot_path)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-new-tokens", type=int, default=200)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--greedy", action="store_true",
                   help="argmax decoding (default: sample)")
    p.add_argument("--eos-text", default=None,
                   help="stop a request when this (single-token) text is "
                        "produced")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prompts-file", default=None,
                   help="offline batch mode: one prompt per line")
    p.add_argument("--selftest", action="store_true",
                   help="random-init small model + canned prompts; checks "
                        "greedy parity with generate() and exits")
    p.add_argument("--metrics-json", default=None,
                   help="write the serving metrics summary JSON here")
    p.add_argument("--log-every", type=int, default=20,
                   help="scheduler steps between metric log lines (0 = off)")
    p.add_argument("--queue-limit", type=int, default=None,
                   help="bound the request queue; over-limit submissions "
                        "are rejected (backpressure)")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="per-request deadline in seconds; expired requests "
                        "free their KV slot (finish_reason=deadline)")
    p.add_argument("--prefill-buckets", default=None,
                   help="comma-separated ladder of prefill lengths "
                        "(default: powers of two from 64 up to block_size); "
                        "prompts pad to the smallest covering bucket")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="prefill long prompts in chunks of this many tokens "
                        "between decode steps (default: whole prompt)")
    p.add_argument("--prefix-cache-mb", type=float, default=0.0,
                   help="LRU budget (MiB) for shared-prefix KV reuse; 0 "
                        "disables the prefix store")
    p.add_argument("--warmup", action="store_true",
                   help="run the prefill ladder and the decode step once "
                        "before serving")
    p.add_argument("--kv-dtype", choices=("fp32", "int8", "fp8"), default="fp32",
                   help="KV-cache storage dtype: int8 or fp8 payloads with "
                        "fp32 power-of-two scale planes (~0.27x the fp32 "
                        "pool bytes at head_dim >= 64); fp32 is the plain "
                        "pool in the model's dtype")
    p.add_argument("--draft-config", default=None,
                   help="speculative decoding draft model: 'self' (the "
                        "target's weights), 'self:N' (its first N layers) "
                        "or comma-separated GPTConfig overrides such as "
                        "'n_layer=2,n_embd=64' (random init); needs "
                        "--spec-k >= 1")
    p.add_argument("--spec-k", type=int, default=0,
                   help="draft tokens proposed per verify round (0 = "
                        "speculation off)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve Prometheus /metrics and /healthz on this "
                        "port (0 = an ephemeral port, printed at start)")
    p.add_argument("--selftest-spec", action="store_true",
                   help="random-init small model: speculative decoding "
                        "token-identical to solo generate() (identical and "
                        "1-layer drafts, chunked prefill, prefix reuse), "
                        "one verify shape; exits non-zero on a mismatch")
    p.add_argument("--selftest-quant", action="store_true",
                   help="int8 and fp8 KV pools against the fp32 pool with "
                        "chunks, prefix reuse and speculation: greedy "
                        "prefix >= 0.9, equal shape counts, pool bytes <= "
                        "0.27x, power-of-two scales; then exits")
    p.add_argument("--trace-jsonl", default=None,
                   help="export request-scoped traces (mingpt-trace/1 JSONL: "
                        "spans, emit events, one request summary per trace) "
                        "to this path")
    p.add_argument("--trace-sample", type=float, default=1.0,
                   help="happy-path trace sampling probability in [0, 1]; "
                        "errors, sheds and retried requests always export")
    p.add_argument("--flight-dir", default=None,
                   help="arm the flight recorder: dump recent spans, events "
                        "and metrics here (mingpt-flight/1, atomic write + "
                        "manifest) on a post-warmup new shape and on a "
                        "SIGTERM drain; also serves GET /debug/flight on "
                        "--metrics-port")
    p.add_argument("--slo", nargs="?", const="default", default=None,
                   metavar="SPEC",
                   help="print a graded SLO report at shutdown from exact "
                        "per-request trace durations; SPEC is "
                        "'metric<=threshold' clauses (ttft_pNN, itl_pNN, "
                        "shed_rate, error_rate) joined by ','; bare --slo "
                        "uses the default objectives")
    p.add_argument("--slo-json", default=None, metavar="PATH",
                   help="write the shutdown SLO report (mingpt-slo/1) as "
                        "JSON to PATH; objectives from --slo, or the "
                        "defaults")
    p.add_argument("--attrib-json", default=None, metavar="PATH",
                   help="performance attribution: write the mingpt-attrib/1 "
                        "report (per-family operations, bytes, calls, device "
                        "seconds, roofline; HBM bytes by owner) to PATH at "
                        "shutdown; also serves GET /attrib on --metrics-port")
    p.add_argument("--selftest-attrib", action="store_true",
                   help="random-init small model served with attribution "
                        "and speculation: every family in a valid report "
                        "with its operations, the HBM owners equal to the "
                        "pools' bytes, two runs on a ticking clock "
                        "byte-identical, /attrib scraped; then exits")
    for flag in UNPORTED_FLAGS:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    p.add_argument("overrides", nargs="*")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """The arguments; exits 2 naming the ROADMAP.md item of any unported
    flag given."""
    p = build_argparser()
    args = p.parse_args(argv)
    for flag, item in UNPORTED_FLAGS.items():
        value = getattr(args, flag[2:].replace("-", "_"))
        if value is None:
            continue
        p.error(f"{flag} is not ported yet (ROADMAP.md Queue 1 item {item})")
    return args


def _parse_buckets(spec):
    if spec is None:
        return None
    try:
        return tuple(int(b) for b in str(spec).split(",") if b.strip())
    except ValueError:
        raise SystemExit(f"--prefill-buckets must be comma-separated ints, "
                         f"got {spec!r}")


def _server_kwargs(args) -> dict:
    """The prefill knobs and the KV dtype, shared by every server
    construction."""
    return dict(prefill_buckets=_parse_buckets(args.prefill_buckets),
                prefill_chunk=args.prefill_chunk,
                prefix_cache_mb=args.prefix_cache_mb, warmup=args.warmup,
                kv_dtype=args.kv_dtype)


def first_layers(params, n: int):
    """The first ``n`` layers of a parameter tree (blocks are stacked on a
    leading layer axis), sharing the embeddings and the head."""
    out = dict(params)
    out["blocks"] = {k: v[:n] for k, v in params["blocks"].items()}
    return out


def draft_from(spec: str, params, cfg: GPTConfig, dev):
    """``--draft-config`` -> (draft params, draft config): 'self' shares
    the target's weights (accept rate 1.0), 'self:N' takes its first N
    layers, 'k=v,...' a random-init config off the target's dims."""
    if spec == "self":
        return params, cfg
    if spec.startswith("self:"):
        try:
            n = int(spec.split(":", 1)[1])
        except ValueError:
            raise SystemExit(f"--draft-config self:N needs an int, got {spec!r}")
        if not 1 <= n <= cfg.n_layer:
            raise SystemExit(f"--draft-config {spec!r}: N outside [1, {cfg.n_layer}]")
        return first_layers(params, n), dataclasses.replace(cfg, n_layer=n)
    overrides = {}
    for clause in spec.split(","):
        k, sep, v = clause.partition("=")
        if not sep or not k.strip():
            raise SystemExit(f"--draft-config clause {clause!r} is not k=v "
                             f"(or 'self' / 'self:N')")
        for cast in (int, float, str.strip):
            try:
                overrides[k.strip()] = cast(v)
                break
            except ValueError:
                continue
    try:
        dcfg = dataclasses.replace(cfg, **overrides).resolved()
        dcfg.validate()
    except Exception as e:
        raise SystemExit(f"--draft-config {spec!r}: {e}")
    import torch

    return gpt.init(dcfg, torch.Generator().manual_seed(1), device=dev), dcfg


def _spec_kwargs(args, params, cfg, dev) -> dict:
    """Speculative-decoding kwargs for InferenceServer (empty = off);
    --draft-config and --spec-k go together."""
    if args.spec_k <= 0 and args.draft_config is None:
        return {}
    if args.spec_k <= 0 or args.draft_config is None:
        raise SystemExit("--draft-config and --spec-k (>= 1) must be given together")
    dparams, dcfg = draft_from(args.draft_config, params, cfg, dev)
    return dict(draft_params=dparams, draft_cfg=dcfg, spec_k=args.spec_k)


def _start_telemetry(args, reg):
    """With --metrics-port, a TelemetryServer over ``reg`` (its /metrics and
    /healthz); else None."""
    if args.metrics_port is None:
        return None
    tserver = telemetry.TelemetryServer(reg, port=args.metrics_port)
    print(f"[serve] telemetry: /metrics and /healthz on {tserver.url('')}",
          file=sys.stderr)
    return tserver


def _selftest_scrape(tserver) -> int:
    """Scrape our own /healthz and /metrics over HTTP and hold the page to
    the strict exposition parser: the serving latency histograms, the
    utilisation and prefix gauges and the trainer's gauge families."""
    import urllib.request

    rc = 0
    with urllib.request.urlopen(tserver.url("/healthz"), timeout=10) as resp:
        health = json.loads(resp.read().decode())
    if health.get("status") != "ok":
        print(f"selftest FAIL: /healthz says {health}")
        rc = 1
    with urllib.request.urlopen(tserver.url("/metrics"), timeout=10) as resp:
        text = resp.read().decode()
    try:
        parsed = telemetry.parse_prometheus(text)
    except ValueError as e:
        print(f"selftest FAIL: /metrics is not valid exposition text: {e}")
        return 1
    required = {
        "mingpt_serve_ttft_seconds": "histogram",
        "mingpt_serve_itl_seconds": "histogram",
        "mingpt_serve_slot_utilization": "gauge",
        "mingpt_serve_prefix_hit_rate": "gauge",
        "mingpt_serve_kv_dtype": "gauge",
        "mingpt_train_loss": "gauge",
        "mingpt_train_mfu": "gauge",
    }
    for name, kind in required.items():
        got = parsed["types"].get(name)
        if got != kind:
            print(f"selftest FAIL: /metrics lacks {kind} {name} (got {got})")
            rc = 1
    print(f"selftest scrape: {len(parsed['samples'])} samples")
    return rc


def _make_observability(args, reg):
    """(TraceRecorder or None, FlightRecorder or None) from the tracing
    flags. The flight recorder samples the process registry and the span
    tracer's ring at dump time; the trace recorder mirrors every record
    into the flight ring. --slo needs the per-request summaries, so it
    makes a recorder even without an export path."""
    flight = None
    if args.flight_dir is not None:
        flight = telemetry.FlightRecorder(out_dir=args.flight_dir, registry=reg)
        flight.source_providers["tracer"] = telemetry.get_tracer().records
        flight.metrics_providers["process"] = lambda: telemetry.render_prometheus(reg)
    recorder = None
    if (args.trace_jsonl is not None or args.slo is not None
            or args.slo_json is not None or flight is not None):
        if not 0.0 <= args.trace_sample <= 1.0:
            raise SystemExit(f"--trace-sample must be in [0, 1], got {args.trace_sample}")
        sink = (telemetry.trace_sink(args.trace_jsonl)
                if args.trace_jsonl is not None else None)
        recorder = telemetry.TraceRecorder(sink=sink, sample=args.trace_sample,
                                           registry=reg, flight=flight)
    return recorder, flight


def _slo_report(args, recorder):
    """Grade the SLO objectives over the recorder's finished requests:
    print the report with --slo, write it as sorted-key JSON with
    --slo-json. Returns the report (None when neither flag is set)."""
    if (args.slo is None and args.slo_json is None) or recorder is None:
        return None
    report = telemetry.evaluate_slos(recorder.completed_requests(),
                                     telemetry.parse_slo_spec(args.slo or "default"))
    if args.slo is not None:
        print(telemetry.render_slo_report(report))
    if args.slo_json is not None:
        with open(args.slo_json, "w") as f:
            f.write(json.dumps(report, sort_keys=True, indent=2) + "\n")
        print(f"[serve] SLO report (mingpt-slo/1) written to {args.slo_json}",
              file=sys.stderr)
    return report


def _request_for(args, tokens, eos_id=None) -> Request:
    return Request(prompt=[int(t) for t in tokens],
                   max_new_tokens=args.max_new_tokens,
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p, do_sample=not args.greedy, eos_id=eos_id,
                   seed=args.seed, deadline_s=args.deadline_s)


class _ShutdownGuard:
    """SIGTERM/SIGINT → stop admission, drain, flush, exit 75 (the
    trainer's preemption contract). The first signal only sets the flag;
    a second SIGINT raises KeyboardInterrupt for a hard abort."""

    def __init__(self):
        self.stop_requested = False
        self._previous = {}

    def install(self) -> "_ShutdownGuard":
        def handler(signum, frame):
            if self.stop_requested and signum == signal.SIGINT:
                raise KeyboardInterrupt
            self.stop_requested = True
            print(f"[serve] caught signal {signum}: admission stopped, "
                  f"draining in-flight requests (SIGINT again to abort)",
                  file=sys.stderr, flush=True)

        for sig in (signal.SIGTERM, signal.SIGINT):
            self._previous[sig] = signal.signal(sig, handler)
        return self

    def restore(self) -> None:
        """Put back the handlers ``install`` replaced."""
        for sig, previous in self._previous.items():
            signal.signal(sig, previous)


def selftest(args) -> int:
    """Canned prompts through a random-init small model on 2 slots: greedy
    server output must be token-identical to solo generate(), with the
    shape family bounded by the bucket ladder (and, with
    --prefix-cache-mb, a prefix-store hit)."""
    import torch

    dev = resolve_device(args.device)
    cfg = GPTConfig.make(
        n_layer=2, n_head=2, n_embd=32, vocab_size=96, block_size=48,
        embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
    params = gpt.init(cfg, torch.Generator().manual_seed(0), device=dev)
    canned = list(SELFTEST_PROMPTS)
    if args.prefix_cache_mb > 0:
        # two prompts sharing a long head: the second must hit the store
        canned += SELFTEST_SHARED
    prompts = [[ord(c) % cfg.vocab_size for c in s] for s in canned]
    max_new = 12
    # one registry for the page: the serving instruments and the trainer's
    # gauge families (a silent MetricsLogger registers mingpt_train_*)
    reg = telemetry.MetricsRegistry()
    tserver = _start_telemetry(args, reg)
    MetricsLogger(cfg, enabled=False, registry=reg)
    server = InferenceServer(params, cfg, n_slots=2, log_every=args.log_every,
                             registry=reg, device=dev, **_server_kwargs(args))
    handles = server.generate_batch(
        [Request(prompt=p, max_new_tokens=max_new) for p in prompts])

    rc = 0
    for text, p, h in zip(canned, prompts, handles):
        want = gen.generate(params, cfg, [p], max_new,
                            device=dev)[0, len(p):].tolist()
        ok = h.tokens == want
        print(f"selftest {h.request_id} ({text!r}): "
              + ("OK" if ok else f"MISMATCH server={h.tokens} solo={want}"))
        rc |= not ok
    counts = server.compile_counts()
    ladder = len(server.engine.buckets)
    if counts["decode"] != 1 or counts["prefill"] > ladder:
        print(f"selftest FAIL: unbounded shapes: {counts} (ladder size "
              f"{ladder})")
        rc = 1
    if args.prefix_cache_mb > 0 and server.metrics.prefix_hits < 1:
        print("selftest FAIL: prefix store enabled but no hit recorded")
        rc = 1
    if tserver is not None:
        rc |= _selftest_scrape(tserver)
        tserver.close()
    summary = server.summary()
    print("selftest shapes:", json.dumps(counts))
    print("selftest metrics:", json.dumps(summary))
    if args.metrics_json:
        server.metrics.write_json(args.metrics_json)
    if summary["requests_completed"] != len(canned):
        print("selftest FAIL: not all requests completed")
        rc = 1
    print("selftest", "PASSED" if rc == 0 else "FAILED")
    return int(rc)


SPEC_CANNED = SELFTEST_PROMPTS + SELFTEST_SHARED


def _selftest_variant(tag, run) -> int:
    """Run one variant of a self-test; an exception fails it (printed)."""
    try:
        return run()
    except Exception as e:  # a planted or real fault must fail, not crash
        print(f"{tag} FAIL: {type(e).__name__}: {e}")
        return 1


def selftest_spec(args) -> int:
    """Speculative decoding must be token-identical to solo greedy
    generate(), with one verify shape for the server's lifetime. Two
    variants: an identical draft (every proposal accepted: accept rate
    exactly 1.0, k+1 tokens per verify, the backfill row), and the
    target's first layer as draft with 6-token chunks, a multi-bucket
    ladder and a prefix-store hit (real rejections roll back on both
    engines)."""
    import torch

    dev = resolve_device(args.device)
    cfg = GPTConfig.make(
        n_layer=2, n_head=2, n_embd=32, vocab_size=96, block_size=48,
        embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
    params = gpt.init(cfg, torch.Generator().manual_seed(0), device=dev)
    k = args.spec_k if args.spec_k > 0 else 3
    max_new = 12

    def check_parity(tag, canned, prompts, handles) -> int:
        bad = 0
        for text, p, h in zip(canned, prompts, handles):
            want = gen.generate(params, cfg, [p], max_new,
                                device=dev)[0, len(p):].tolist()
            ok = h.tokens == want
            print(f"selftest-spec [{tag}] {h.request_id} ({text!r}): "
                  + ("OK" if ok else f"MISMATCH spec={h.tokens} solo={want}"))
            bad |= not ok
        return int(bad)

    def identical() -> int:
        canned = SELFTEST_PROMPTS
        prompts = [[ord(c) % cfg.vocab_size for c in s] for s in canned]
        srv = InferenceServer(params, cfg, n_slots=2, warmup=True, device=dev,
                              kv_dtype=args.kv_dtype, draft_params=params,
                              draft_cfg=cfg, spec_k=k)
        handles = srv.generate_batch(
            [Request(prompt=p, max_new_tokens=max_new) for p in prompts])
        rc = check_parity("self", canned, prompts, handles)
        m = srv.metrics
        if m.spec_accept_rate != 1.0:
            print(f"selftest-spec FAIL: identical draft accept rate "
                  f"{m.spec_accept_rate} != 1.0")
            rc = 1
        if m.spec_tokens_per_verify_mean != k + 1:
            print(f"selftest-spec FAIL: identical draft emitted "
                  f"{m.spec_tokens_per_verify_mean} tokens/verify, want {k + 1}")
            rc = 1
        counts = srv.compile_counts()
        if counts["verify"] != 1 or counts["draft_decode"] != 1:
            print(f"selftest-spec FAIL: unbounded speculation shapes: {counts}")
            rc = 1
        print(f"selftest-spec [self] accept {m.spec_accepted}/{m.spec_proposed}, "
              f"tokens/verify {m.spec_tokens_per_verify_mean:.3g}, counts {counts}")
        return rc

    def truncated() -> int:
        canned = SPEC_CANNED
        prompts = [[ord(c) % cfg.vocab_size for c in s] for s in canned]
        srv = InferenceServer(
            params, cfg, n_slots=2, warmup=True, device=dev,
            kv_dtype=args.kv_dtype, prefill_chunk=6,
            prefill_buckets=(4, 6, 8, 16, 32, 48), prefix_cache_mb=4.0,
            draft_params=first_layers(params, 1),
            draft_cfg=dataclasses.replace(cfg, n_layer=1), spec_k=k)
        handles = srv.generate_batch(
            [Request(prompt=p, max_new_tokens=max_new) for p in prompts])
        rc = check_parity("self:1+chunk+prefix", canned, prompts, handles)
        m, counts = srv.metrics, srv.compile_counts()
        ladder = len(srv.engine.buckets)
        if counts["verify"] != 1:
            print(f"selftest-spec FAIL: verify family grew: {counts}")
            rc = 1
        if counts["prefill"] > ladder or counts["draft_prefill"] > ladder:
            print(f"selftest-spec FAIL: prefill families exceed the "
                  f"{ladder}-bucket ladder: {counts}")
            rc = 1
        if m.prefix_hits < 1:
            print("selftest-spec FAIL: prefix store enabled but no hit")
            rc = 1
        if m.spec_rounds < 1:
            print("selftest-spec FAIL: no verify rounds ran")
            rc = 1
        print(f"selftest-spec [self:1+chunk+prefix] accept "
              f"{m.spec_accepted}/{m.spec_proposed}, prefix_hits "
              f"{m.prefix_hits}, counts {counts}")
        print("selftest-spec metrics:", json.dumps(srv.summary()))
        return rc

    rc = _selftest_variant("selftest-spec [self]", identical)
    rc |= _selftest_variant("selftest-spec [self:1+chunk+prefix]", truncated)
    print("selftest-spec", "PASSED" if rc == 0 else "FAILED")
    return rc


def common_prefix(a, b) -> int:
    """Length of the common prefix of two token lists."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


# a quantized pool's greedy stream may leave the fp32 stream only at a
# near-tie: where the fp32 top-2 logit gap is at most QUANT_TIE_X times the
# KV round trip's own logit error at that context
QUANT_TIE_X = 3.0


def quant_divergences(params, cfg, prompts, ref, got, q):
    """Each request's first divergence between the fp32 pool's greedy tokens
    ``ref`` and a quantized pool's ``got``: its step, the fp32 top-2 logit
    gap there (a solo fp32 forward of the prompt and the common tokens),
    the KV round trip's logit error at that context
    (``quant.max_abs_logit_error``) and whether the gap is a near-tie
    (<= QUANT_TIE_X x the error). Requests that agree to the end are
    absent."""
    import torch

    out = []
    dev = params["wte"].device
    for i, (p, a, b) in enumerate(zip(prompts, ref, got)):
        d = common_prefix(a, b)
        if d == len(a) == len(b):
            continue
        ctx = list(p) + list(a[:d])
        with torch.no_grad():
            logits = gen._forward_cached(
                params, torch.tensor([ctx], device=dev),
                gen.init_cache(cfg, 1, dev), 0, cfg)[0]
        top2 = logits.topk(2).values
        gap = float(top2[0] - top2[1])
        err = quant_lib.max_abs_logit_error(params, cfg, ctx, q)
        out.append({"request": i, "step": d, "fp32": a[d] if d < len(a) else None,
                    "quant": b[d] if d < len(b) else None, "top2_gap": gap,
                    "logit_err": err, "tie": gap <= QUANT_TIE_X * err})
    return out


def pool_bytes(cache) -> int:
    return sum(int(a.nbytes) for a in cache.values())


def pow2_or_zero(scales) -> bool:
    """Whether every scale of the planes is an exact power of two or 0."""
    import torch

    return all(bool(((torch.frexp(s).mantissa == 0.5) | (s == 0)).all())
               for s in scales.values())


def selftest_quant(args) -> int:
    """An int8 (and, where torch has float8_e4m3fn, an fp8) KV pool with
    chunked prefill, the prefix store and speculation composed must track
    the fp32 server within tolerance at ~0.27x the pool bytes.

    The scale planes cost 4 bytes per (row, kv head) against head_dim
    payload bytes, so the 0.27 ratio needs head_dim >= 64: this runs
    n_embd=256, n_head=4. Checks: each request's greedy tokens equal the
    fp32 server's, or leave them only at a near-tie
    (``quant_divergences``: the JAX package's gate, a common prefix of
    >= 0.9 of the tokens, is printed beside it, but at random init it
    rides on where the near-ties fall); compile_counts() equal for every
    dtype; payload +
    scale bytes <= 0.27x the fp32 pool's, the scale planes exactly
    ``quant.scale_bytes``; every stored scale a power of two (or 0) and a
    dequantize/quantize round trip of the int8 pool bit-identical; the
    ``mingpt_serve_kv_dtype`` gauge and a sampled
    ``mingpt_serve_quant_logit_err_max``."""
    import torch

    dev = resolve_device(args.device)
    cfg = GPTConfig.make(
        n_layer=2, n_head=4, n_embd=256, vocab_size=96, block_size=48,
        embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
    params = gpt.init(cfg, torch.Generator().manual_seed(0), device=dev)
    prompts = [[ord(c) % cfg.vocab_size for c in s] for s in SPEC_CANNED]
    max_new = 12

    def run_once(kv_dtype):
        reg = telemetry.MetricsRegistry()
        srv = InferenceServer(
            params, cfg, n_slots=2, registry=reg, device=dev,
            prefill_buckets=(8, 48), prefill_chunk=6, prefix_cache_mb=0.5,
            warmup=True, draft_params=params, draft_cfg=cfg, spec_k=2,
            kv_dtype=kv_dtype, attrib=True)
        handles = srv.generate_batch(
            [Request(prompt=p, max_new_tokens=max_new) for p in prompts])
        return srv, reg, [h.tokens for h in handles]

    srv32, _, toks32 = run_once("fp32")
    c32 = srv32.compile_counts()
    bytes32 = srv32.attrib_report()["hbm"]["owners"]["kv_pool"]
    dtypes = ["int8"] + (["fp8"] if quant_lib.fp8_dtype() is not None else [])

    def check(kv_dtype) -> int:
        srv, reg, toks = run_once(kv_dtype)
        rc = 0
        q = quant_lib.resolve_kv_dtype(kv_dtype)
        div = {d["request"]: d for d in quant_divergences(
            params, cfg, prompts, toks32, toks, q)}
        for i, (text, a, b) in enumerate(zip(SPEC_CANNED, toks32, toks)):
            d = div.get(i)
            print(f"selftest-quant [{kv_dtype}] ({text!r}): " + (
                "OK" if d is None else
                f"prefix {d['step']}/{len(a)} at a top-2 gap of "
                f"{d['top2_gap']:.3g} (logit error {d['logit_err']:.3g}: "
                f"{'a near-tie' if d['tie'] else 'NOT a near-tie'}) "
                f"fp32={a} {kv_dtype}={b}"))
        agree = sum(common_prefix(a, b) for a, b in zip(toks32, toks))
        total = sum(len(a) for a in toks32)
        if not all(d["tie"] for d in div.values()):
            print(f"selftest-quant FAIL: {kv_dtype} tokens leave the fp32 "
                  f"stream where the fp32 top-2 gap exceeds {QUANT_TIE_X} x "
                  f"the quantization's logit error")
            rc = 1
        print(f"selftest-quant [{kv_dtype}] common greedy prefix {agree}/{total}")
        counts = srv.compile_counts()
        if counts != c32:
            print(f"selftest-quant FAIL: compile_counts diverge by dtype: "
                  f"fp32={c32} {kv_dtype}={counts}")
            rc = 1
        if srv.metrics.prefix_hits < 1 or srv.metrics.spec_rounds < 1:
            print(f"selftest-quant FAIL: {kv_dtype} prefix hits "
                  f"{srv.metrics.prefix_hits}, spec rounds "
                  f"{srv.metrics.spec_rounds} (want >= 1 each)")
            rc = 1
        # the pool's bytes as the HBM ledger accounts them, held against
        # the tensors it holds
        pool = srv.engine.pool.cache
        data, scales = quant_lib.split_scales(pool)
        owners = srv.attrib_report()["hbm"]["owners"]
        qbytes, sbytes = owners["kv_pool"] + owners["kv_scales"], owners["kv_scales"]
        if (owners["kv_pool"], sbytes) != (pool_bytes(data), pool_bytes(scales)):
            print(f"selftest-quant FAIL: {kv_dtype} HBM ledger owners {owners} "
                  f"!= the pool's {pool_bytes(data)} + {pool_bytes(scales)} bytes")
            rc = 1
        ratio = qbytes / bytes32
        if sbytes != quant_lib.scale_bytes(cfg, 2) or sbytes <= 0:
            print(f"selftest-quant FAIL: {kv_dtype} scale planes hold {sbytes} "
                  f"bytes, want {quant_lib.scale_bytes(cfg, 2)}")
            rc = 1
        if ratio > 0.27:
            print(f"selftest-quant FAIL: {kv_dtype} pool bytes ratio {ratio:.4f} > 0.27")
            rc = 1
        if not pow2_or_zero(scales):
            print(f"selftest-quant FAIL: a {kv_dtype} scale is not a power of two")
            rc = 1
        if kv_dtype == "int8":
            rt = quant_lib.quantize_lane(quant_lib.dequantize_lane(pool), q)
            if any(not torch.equal(rt[n], pool[n]) for n in pool):
                print("selftest-quant FAIL: the int8 pool's round trip is not "
                      "bit-identical")
                rc = 1
        err = quant_lib.max_abs_logit_error(params, cfg, prompts[0], q)
        srv.observe_quant_logit_error(err)
        if not (0.0 < err < 0.5):
            print(f"selftest-quant FAIL: {kv_dtype} max |dlogit| {err} out of range")
            rc = 1
        page = telemetry.parse_prometheus(telemetry.render_prometheus(reg))
        vals = {(n, tuple(sorted(lb.items()))): v for n, lb, v in page["samples"]}
        if vals.get(("mingpt_serve_kv_dtype", (("kv_dtype", kv_dtype),))) != 1.0:
            print(f"selftest-quant FAIL: mingpt_serve_kv_dtype{{kv_dtype={kv_dtype}}} "
                  "!= 1 in the scrape")
            rc = 1
        gerr = vals.get(("mingpt_serve_quant_logit_err_max", ()))
        if gerr is None or abs(gerr - err) > 1e-12:
            print(f"selftest-quant FAIL: quant err gauge {gerr} != sampled {err}")
            rc = 1
        print(f"selftest-quant [{kv_dtype}] bytes: payload+scales={qbytes} "
              f"(scales {sbytes}) fp32={bytes32} ratio={ratio:.4f} "
              f"err={err:.6f} counts={counts}")
        return rc

    rc = 0
    for kv_dtype in dtypes:
        rc |= _selftest_variant(f"selftest-quant [{kv_dtype}]",
                                lambda: check(kv_dtype))
    if "fp8" not in dtypes:
        print("selftest-quant: this torch has no float8_e4m3fn; fp8 skipped "
              "(--kv-dtype fp8 raises here)")
    print("selftest-quant", "PASSED" if rc == 0 else "FAILED")
    return rc


class TickingClock:
    """A deterministic clock: each read advances by a fixed quantum, so two
    identical runs observe identical timestamps and durations."""

    def __init__(self, dt: float = 1e-4):
        self.t = 0.0
        self.dt = dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def selftest_attrib(args) -> int:
    """Attribution on a random-init small model with speculation (and, with
    --prefix-cache-mb, the prefix store), on the CPU unless asked: every
    family registered and called appears in a ``mingpt-attrib/1`` report
    that validates, with nonzero operations; the HBM ledger's pool owners
    equal the pools' bytes; two runs on a ticking clock dump byte-identical
    reports (on the CPU, where the clock times the calls); ``/attrib``
    serves the report and the ``/metrics`` page carries the
    ``mingpt_attrib_*`` families."""
    import urllib.request

    import torch

    dev = resolve_device(args.device)
    cfg = GPTConfig.make(
        n_layer=2, n_head=2, n_embd=32, vocab_size=96, block_size=48,
        embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
    params = gpt.init(cfg, torch.Generator().manual_seed(0), device=dev)
    canned = list(SELFTEST_PROMPTS)
    if args.prefix_cache_mb > 0:
        canned += SELFTEST_SHARED
    prompts = [[ord(c) % cfg.vocab_size for c in s] for s in canned]
    spec_k = args.spec_k if args.spec_k > 0 else 2

    def run_once(reg):
        srv = InferenceServer(params, cfg, n_slots=2, clock=TickingClock(),
                              attrib=True, registry=reg, device=dev,
                              draft_params=first_layers(params, 1),
                              draft_cfg=dataclasses.replace(cfg, n_layer=1),
                              spec_k=spec_k, **_server_kwargs(args))
        srv.generate_batch([Request(prompt=p, max_new_tokens=8) for p in prompts])
        return srv, srv.attrib_report()

    rc = 0
    reg = telemetry.MetricsRegistry()
    srv, report = run_once(reg)
    try:
        telemetry.validate_attrib_report(report)
    except ValueError as e:
        print(f"selftest-attrib FAIL: the report does not validate: {e}")
        return 1
    rows = {(r["family"], r["variant"]): r for r in report["programs"]}
    families = {fam for fam, _ in rows}
    # every family that ran (compile_counts) is registered and was called;
    # with speculation the greedy rounds go through verify and the draft's
    # decode, and the plain decode may stay at 0 calls
    ran = {fam for fam, n in srv.compile_counts().items() if n}
    expected = {"prefill", "decode", "verify", "draft_prefill", "draft_decode"} | ran
    if expected - families:
        print(f"selftest-attrib FAIL: families missing: {sorted(expected - families)}")
        rc = 1
    for (fam, variant), row in sorted(rows.items()):
        if fam in ("prefill", "decode", "verify") and not row["flops"]:
            print(f"selftest-attrib FAIL: {fam}:{variant} has no operations")
            rc = 1
    for fam in ran:
        if sum(r["calls"] for (f, _), r in rows.items() if f == fam) < 1:
            print(f"selftest-attrib FAIL: no calls of {fam} observed")
            rc = 1
    owners = report["hbm"]["owners"]
    for owner, cache in (("kv_pool", srv.engine.pool.cache),
                         ("draft_pool", srv.spec.draft.engine.pool.cache)):
        if owners.get(owner) != pool_bytes(cache):
            print(f"selftest-attrib FAIL: hbm owner {owner} = {owners.get(owner)}, "
                  f"the pool holds {pool_bytes(cache)}")
            rc = 1
    if owners.get("params", 0) <= 0:
        print("selftest-attrib FAIL: params not accounted")
        rc = 1
    if srv.watchdog.recompiles:
        print(f"selftest-attrib FAIL: {srv.watchdog.recompiles} new shapes after warmup")
        rc = 1
    dump = telemetry.dump_attrib_report(report)
    if dev.type == "cpu":
        _, report_b = run_once(telemetry.MetricsRegistry())
        if telemetry.dump_attrib_report(report_b) != dump:
            print("selftest-attrib FAIL: two identical runs dumped different reports")
            rc = 1
    tserver = telemetry.TelemetryServer(reg, port=0 if args.metrics_port is None
                                        else args.metrics_port)
    tserver.attrib_provider = srv.attrib_report
    try:
        with urllib.request.urlopen(tserver.url("/attrib"), timeout=10) as resp:
            served = json.loads(resp.read().decode())
        telemetry.validate_attrib_report(served)
        with urllib.request.urlopen(tserver.url("/metrics"), timeout=10) as resp:
            types = telemetry.parse_prometheus(resp.read().decode())["types"]
        for name in ("mingpt_attrib_flops", "mingpt_attrib_calls_total",
                     "mingpt_attrib_hbm_bytes"):
            if name not in types:
                print(f"selftest-attrib FAIL: /metrics lacks {name}")
                rc = 1
    finally:
        tserver.close()
    if args.attrib_json:
        with open(args.attrib_json, "w") as f:
            f.write(dump + "\n")
        print(f"[serve] attribution report written to {args.attrib_json}",
              file=sys.stderr)
    print(telemetry.render_attrib_report(report))
    print("selftest-attrib", "PASSED" if rc == 0 else "FAILED")
    return rc


def _load_params(args, gpt_cfg, exp, dev):
    """(params, where they came from), or (None, why not)."""
    if args.params is not None:
        with np.load(args.params) as f:
            tree = convert.unflatten({k: f[k] for k in f.files})
        return convert.params_from_numpy(tree, gpt_cfg, dev), args.params
    path = exp.trainer_config.snapshot_path or ckpt_lib.DEFAULT_SNAPSHOT_PATH
    snap = ckpt_lib.restore_inference_params(path, gpt_cfg, dev)
    if snap is None:
        return None, (f"no snapshot at {path}; train first (python -m "
                      "mingpt_distributed_tpu_torch.train) or pass --params")
    return snap.params, f"snapshot step {snap.step} at {path}"


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.selftest:
        return selftest(args)
    if args.selftest_spec:
        return selftest_spec(args)
    if args.selftest_quant:
        return selftest_quant(args)
    if args.selftest_attrib:
        return selftest_attrib(args)

    dev = resolve_device(args.device)
    exp = load_config(args.config, args.overrides)
    dataset = make_dataset(exp.data_config)
    gpt_cfg = dataclasses.replace(
        exp.gpt_config, vocab_size=dataset.vocab_size,
        block_size=dataset.block_size,
        embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    params, source = _load_params(args, gpt_cfg, exp, dev)
    if params is None:
        print(source, file=sys.stderr)
        return 1
    print(f"loaded {source}", file=sys.stderr)

    eos_id = None
    if args.eos_text is not None:
        eos = dataset.encode(args.eos_text)
        if len(eos) != 1:
            print(f"--eos-text must encode to one token, got {len(eos)}",
                  file=sys.stderr)
            return 1
        eos_id = int(eos[0])

    guard = _ShutdownGuard().install()
    try:
        return _serve(args, dataset, gpt_cfg, params, dev, eos_id, guard)
    finally:
        guard.restore()


def _serve(args, dataset, gpt_cfg, params, dev, eos_id, guard) -> int:
    """The offline batch (``--prompts-file``) or the REPL."""
    # stream tokens as they decode: print the newly decoded text suffix of
    # each request (decode-accumulated-and-diff is tokenizer-agnostic)
    printed = {}

    def on_token(handle, _tok) -> None:
        text = dataset.decode(handle.tokens)
        sys.stdout.write(text[len(printed.get(handle.request_id, "")):])
        printed[handle.request_id] = text
        sys.stdout.flush()

    # the process registry is served with --metrics-port and dumped by the
    # flight recorder; without either each server keeps its own
    reg = (telemetry.get_registry()
           if args.metrics_port is not None or args.flight_dir is not None else None)
    tserver = _start_telemetry(args, reg)
    recorder, flight = _make_observability(args, reg)
    if tserver is not None and flight is not None:
        tserver.flight_provider = lambda: flight.snapshot("on_demand")
    spec_kw = _spec_kwargs(args, params, gpt_cfg, dev)

    def build_server(stream_cb) -> InferenceServer:
        server = InferenceServer(
            params, gpt_cfg, n_slots=args.slots, on_token=stream_cb,
            log_every=0 if stream_cb else args.log_every,
            max_queue=args.queue_limit, default_deadline_s=args.deadline_s,
            registry=reg, trace_recorder=recorder, attrib=bool(args.attrib_json),
            device=dev, **spec_kw, **_server_kwargs(args))
        if tserver is not None and args.attrib_json:
            tserver.attrib_provider = server.attrib_report
        if flight is not None:
            server.watchdog.on_recompile = (
                lambda grown: flight.dump("watchdog_recompile", families=grown))
        return server

    def shutdown(server: InferenceServer) -> int:
        """Drain in-flight work, flush the metrics, the SLO report and the
        attribution report; a flight dump after a signal; 75 after a
        signal."""
        server.run_until_drained()
        if guard.stop_requested and flight is not None:
            flight.dump("sigterm_drain")
        _slo_report(args, recorder)
        if args.attrib_json:
            with open(args.attrib_json, "w") as f:
                f.write(telemetry.dump_attrib_report(server.attrib_report()) + "\n")
            print(f"[serve] attribution report written to {args.attrib_json}",
                  file=sys.stderr)
        if recorder is not None:
            recorder.close()
        if args.metrics_json:
            server.metrics.write_json(args.metrics_json)
        if tserver is not None:
            tserver.close()
        if guard.stop_requested:
            print(f"[serve] drained after signal; exiting "
                  f"{REQUEUE_EXIT_CODE} (requeue)", file=sys.stderr)
            return REQUEUE_EXIT_CODE
        return 0

    if args.prompts_file:
        with open(args.prompts_file) as f:
            lines = [ln.rstrip("\n") for ln in f if ln.strip()]
        server = build_server(None)
        # per-request isolation: one bad prompt (encode failure, validation
        # error, queue rejection) is reported and skipped
        handles: List = []
        for ln in lines:
            if guard.stop_requested:
                print(f"[serve] admission stopped by signal; "
                      f"{len(lines) - len(handles)} prompt(s) not admitted",
                      file=sys.stderr)
                break
            try:
                handles.append((ln, server.submit(_request_for(
                    args, dataset.encode(ln), eos_id))))
            except (KeyError, ValueError, RuntimeError) as e:
                print(f"=== skipped ({type(e).__name__}: {e}) ===\n{ln}",
                      file=sys.stderr)
            server.step()  # drain as we go so a bounded queue makes progress
        rc = shutdown(server)
        for ln, h in handles:
            print(f"=== {h.request_id} ({h.finish_reason}) ===")
            print(ln + dataset.decode(h.tokens))
        print(json.dumps(server.summary()))
        return rc

    # REPL: one prompt per stdin line, streamed as it decodes
    server = build_server(on_token)
    interactive = sys.stdin.isatty()
    if interactive:
        print("prompt> ", end="", flush=True)
    try:
        for line in sys.stdin:
            prompt = line.rstrip("\n")
            if guard.stop_requested:
                break
            if prompt:
                # one failing request must not tear down the REPL
                try:
                    sys.stdout.write(prompt)
                    server.submit(_request_for(args, dataset.encode(prompt),
                                               eos_id))
                    server.run_until_drained()
                    print()
                except (KeyError, ValueError, RuntimeError) as e:
                    print(f"\n[serve] request failed ({type(e).__name__}: "
                          f"{e}); still serving", file=sys.stderr)
            if guard.stop_requested:
                break
            if interactive:
                print("prompt> ", end="", flush=True)
    except KeyboardInterrupt:
        # second SIGINT: skip further admission, still drain and flush
        print("\n[serve] interrupted again — draining and exiting",
              file=sys.stderr)
    return shutdown(server)


if __name__ == "__main__":
    sys.exit(main())
