"""Request-scoped tracing: one reconstructable timeline per serving
request, from submit through prefill chunks and decode rounds (or
speculation rounds) to its end.

The port's own copy of ``mingpt_distributed_tpu/telemetry/tracing.py``
(same records, same ``mingpt-trace/1`` schema, same validator), kept
because the port imports nothing of the JAX package.

* **Clock discipline.** This module never reads a clock. Every timestamp
  comes from the caller's injected clock (the scheduler's ``clock``), so
  ``ts`` fields are seconds in that clock's domain: durations and
  same-clock deltas are meaningful, absolute wall anchoring is not (the
  flight recorder carries the wall anchor).
* **One trace per request.** The trace_id is the request_id. Records for
  an unknown or already-ended trace are dropped and counted
  (``orphan_records``).
* **Sampling that never hides trouble.** Errors, sheds, deadline expiries
  and anything retried export unconditionally; happy-path traces export
  with probability ``sample``, decided from a CRC32 of the trace_id, so a
  given request id samples the same way in every process and rerun.
* **Bounded.** Per-trace record count and the completed-summary deque are
  capped; overflow increments a per-trace drop counter exported with the
  summary.

Export is ``mingpt-trace/1`` JSONL: ``kind`` is ``span`` | ``event`` |
``request`` (exactly one ``request`` summary per trace), validated by
``validate_trace_records`` / ``load_trace_jsonl``.
"""

import json
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

TRACE_SCHEMA = "mingpt-trace/1"

#: outcomes that count as a successful completion — anything else is
#: trouble and forces export regardless of the sampling probability
HAPPY_OUTCOMES = ("length", "eos")

#: the virtual parent id of root-level spans/events in every trace
ROOT_SPAN_ID = "s0"


@dataclass(frozen=True)
class TraceContext:
    """The propagation token: carried on a Request across the
    router/replica/scheduler boundary.  ``span_id`` is the id new child
    spans and events parent to."""

    trace_id: str
    span_id: str = ROOT_SPAN_ID
    baggage: Dict[str, Any] = field(default_factory=dict)

    def child(self, span_id: str) -> "TraceContext":
        return TraceContext(self.trace_id, span_id, self.baggage)


def prompt_hash(prompt: Sequence[int], head: int = 16) -> str:
    """Stable 8-hex-digit hash of the prompt head for trace baggage —
    groups shared-prefix traffic without storing token ids."""
    blob = repr([int(t) for t in list(prompt)[:head]]).encode("utf-8")
    return "%08x" % (zlib.crc32(blob) & 0xFFFFFFFF)


def trace_baggage(request: Any) -> Dict[str, Any]:
    """Standard per-request baggage: tenant + prompt-head hash."""
    bag: Dict[str, Any] = {"prompt_hash": prompt_hash(request.prompt)}
    tenant = getattr(request, "tenant", None)
    if tenant:
        bag["tenant"] = tenant
    return bag


class _Trace:
    """Mutable per-trace accumulation state (internal)."""

    __slots__ = ("trace_id", "request_id", "start_s", "baggage", "spans",
                 "events", "open_spans", "forced", "dropped", "_next_id")

    def __init__(self, trace_id: str, request_id: str, start_s: float,
                 baggage: Optional[Dict[str, Any]]):
        self.trace_id = trace_id
        self.request_id = request_id
        self.start_s = float(start_s)
        self.baggage = dict(baggage or {})
        self.spans: List[Dict[str, Any]] = []
        self.events: List[Dict[str, Any]] = []
        self.open_spans: Dict[str, Dict[str, Any]] = {}
        self.forced = False
        self.dropped = 0
        self._next_id = 0

    def new_span_id(self) -> str:
        self._next_id += 1
        return "s%d" % self._next_id

    @property
    def record_count(self) -> int:
        return len(self.spans) + len(self.events) + len(self.open_spans)


class TraceRecorder:
    """Collects per-request spans/events keyed by TraceContext and, at
    ``end_trace``, decides export and appends an exact-duration summary
    to the bounded ``completed`` deque (the SLO engine's input — kept
    for *every* trace, sampled or not).

    All records are mirrored into an attached FlightRecorder ring at
    record time, so crash dumps include recent activity even for traces
    that would not have been sampled.
    """

    def __init__(self, sink=None, sample: float = 1.0,
                 max_spans_per_trace: int = 512,
                 max_completed: int = 1024,
                 registry=None, flight=None):
        if not 0.0 <= float(sample) <= 1.0:
            raise ValueError(f"sample must be in [0, 1], got {sample}")
        self.sink = sink
        self.sample = float(sample)
        self.max_spans_per_trace = int(max_spans_per_trace)
        self.flight = flight
        self._active: Dict[str, _Trace] = {}
        self.completed: deque = deque(maxlen=int(max_completed))
        self.orphan_records = 0
        self.exported_traces = 0
        self.unsampled_traces = 0
        self._c_exported = self._c_dropped = self._c_orphans = None
        if registry is not None:
            self._c_exported = registry.counter(
                "mingpt_trace_exported_total",
                help="request traces exported to the JSONL sink",
                labels=("cause",))
            self._c_dropped = registry.counter(
                "mingpt_trace_unsampled_total",
                help="happy-path request traces dropped by sampling")
            self._c_orphans = registry.counter(
                "mingpt_trace_orphan_records_total",
                help="span/event records for unknown or ended traces "
                     "(dropped)")

    # -- lifecycle ----------------------------------------------------

    def start_trace(self, request_id: str, now: float,
                    baggage: Optional[Dict[str, Any]] = None,
                    ) -> TraceContext:
        if request_id in self._active:
            raise ValueError(f"trace {request_id!r} already active")
        tr = _Trace(request_id, request_id, now, baggage)
        self._active[request_id] = tr
        return TraceContext(request_id, ROOT_SPAN_ID, tr.baggage)

    def mark_forced(self, ctx: TraceContext) -> None:
        tr = self._active.get(ctx.trace_id)
        if tr is not None:
            tr.forced = True

    # -- recording ----------------------------------------------------

    def _lookup(self, ctx: TraceContext) -> Optional[_Trace]:
        tr = self._active.get(ctx.trace_id)
        if tr is None:
            self.orphan_records += 1
            if self._c_orphans is not None:
                self._c_orphans.inc()
        return tr

    def add_span(self, ctx: TraceContext, name: str, ts: float,
                 dur_s: float, **attrs) -> None:
        """Record a completed span parented to ``ctx``."""
        tr = self._lookup(ctx)
        if tr is None:
            return
        if tr.record_count >= self.max_spans_per_trace:
            tr.dropped += 1
            return
        rec = {"trace_id": tr.trace_id, "span_id": tr.new_span_id(),
               "parent_id": ctx.span_id, "name": name, "ts": float(ts),
               "dur_s": max(0.0, float(dur_s))}
        rec.update(attrs)
        tr.spans.append(rec)
        self._mirror("span", rec)

    def open_span(self, ctx: TraceContext, name: str, now: float,
                  **attrs) -> TraceContext:
        """Open a span and return the child context that parents work
        done inside it (the router's per-attempt span rides on the
        attempt Request this way).  Open spans don't count against the
        cap — they are bounded by in-flight attempts."""
        tr = self._lookup(ctx)
        if tr is None:
            return ctx
        sid = tr.new_span_id()
        tr.open_spans[sid] = {
            "trace_id": tr.trace_id, "span_id": sid,
            "parent_id": ctx.span_id, "name": name, "ts": float(now),
            **attrs}
        return ctx.child(sid)

    def close_span(self, ctx: TraceContext, now: float, **attrs) -> None:
        tr = self._lookup(ctx)
        if tr is None:
            return
        rec = tr.open_spans.pop(ctx.span_id, None)
        if rec is None:
            self.orphan_records += 1
            if self._c_orphans is not None:
                self._c_orphans.inc()
            return
        rec["dur_s"] = max(0.0, float(now) - rec["ts"])
        rec.update(attrs)
        tr.spans.append(rec)
        self._mirror("span", rec)

    def cancel_span(self, ctx: TraceContext) -> None:
        """Drop an open span without recording it (e.g. an attempt that
        never counted because the replica queue was full)."""
        tr = self._active.get(ctx.trace_id)
        if tr is not None:
            tr.open_spans.pop(ctx.span_id, None)

    def add_event(self, ctx: TraceContext, name: str, now: float,
                  **attrs) -> None:
        tr = self._lookup(ctx)
        if tr is None:
            return
        if tr.record_count >= self.max_spans_per_trace:
            tr.dropped += 1
            return
        rec = {"trace_id": tr.trace_id, "parent_id": ctx.span_id,
               "name": name, "ts": float(now)}
        rec.update(attrs)
        tr.events.append(rec)
        self._mirror("event", rec)

    # -- completion ---------------------------------------------------

    def end_trace(self, ctx: TraceContext, now: float, outcome: str,
                  n_tokens: int = 0, attempts: int = 1,
                  **attrs) -> Optional[Dict[str, Any]]:
        """Close the trace, compute the exact-duration summary, decide
        export, and return the summary (None for an orphan end)."""
        tr = self._active.pop(ctx.trace_id, None)
        if tr is None:
            self.orphan_records += 1
            if self._c_orphans is not None:
                self._c_orphans.inc()
            return None
        for rec in tr.open_spans.values():
            rec["dur_s"] = max(0.0, float(now) - rec["ts"])
            rec["unclosed"] = True
            tr.spans.append(rec)
            self._mirror("span", rec)
        tr.open_spans.clear()

        emit_ts = sorted(e["ts"] for e in tr.events if e["name"] == "emit")
        gaps = [b - a for a, b in zip(emit_ts, emit_ts[1:])]
        ttft = (emit_ts[0] - tr.start_s) if emit_ts else None
        retried = int(attempts) > 1
        forced = tr.forced or retried or outcome not in HAPPY_OUTCOMES
        sampled = forced or self._sample_hit(tr.trace_id)

        summary: Dict[str, Any] = {
            "trace_id": tr.trace_id, "request_id": tr.request_id,
            "ts": tr.start_s, "end_ts": float(now),
            "total_s": max(0.0, float(now) - tr.start_s),
            "outcome": outcome, "n_tokens": int(n_tokens),
            "attempts": int(attempts), "retried": retried,
            "ttft_s": ttft,
            "itl_s": gaps,
            "itl_mean_s": (sum(gaps) / len(gaps)) if gaps else None,
            "n_spans": len(tr.spans), "n_events": len(tr.events),
            "dropped_records": tr.dropped,
            "baggage": tr.baggage,
            "sampled": sampled,
            "sample_cause": ("forced" if forced else "probability")
                            if sampled else None,
        }
        summary.update(attrs)
        self.completed.append(summary)
        self._mirror("request", summary)

        if sampled:
            self.exported_traces += 1
            if self._c_exported is not None:
                self._c_exported.labels(
                    cause=summary["sample_cause"]).inc()
            if self.sink is not None:
                for rec in tr.spans:
                    self.sink.write("span", rec)
                for rec in tr.events:
                    self.sink.write("event", rec)
                self.sink.write("request", summary)
        else:
            self.unsampled_traces += 1
            if self._c_dropped is not None:
                self._c_dropped.inc()
        return summary

    def completed_requests(self) -> List[Dict[str, Any]]:
        """Every finished trace's summary (sampled or not) — the SLO
        engine's input."""
        return list(self.completed)

    @property
    def active_traces(self) -> int:
        return len(self._active)

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()

    # -- internals ----------------------------------------------------

    def _sample_hit(self, trace_id: str) -> bool:
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        h = zlib.crc32(trace_id.encode("utf-8")) & 0xFFFFFFFF
        return (h % 10_000) < int(self.sample * 10_000)

    def _mirror(self, kind: str, rec: Dict[str, Any]) -> None:
        if self.flight is not None:
            self.flight.record(kind, rec)


def trace_sink(path: str):
    """A JsonlEventSink stamped with the mingpt-trace/1 schema."""
    from .export import JsonlEventSink
    return JsonlEventSink(path, schema=TRACE_SCHEMA)


# ---------------------------------------------------------------------
# strict mingpt-trace/1 loading + validation
# ---------------------------------------------------------------------

_KINDS = ("span", "event", "request")


def _fail(where: str, msg: str) -> None:
    raise ValueError(f"mingpt-trace/1 validation: {where}: {msg}")


def _check_num(where: str, rec: Dict[str, Any], key: str,
               minimum: float = 0.0) -> float:
    v = rec.get(key)
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        _fail(where, f"{key!r} must be a number, got {v!r}")
    if v < minimum:
        _fail(where, f"{key!r} must be >= {minimum}, got {v!r}")
    return float(v)


def validate_trace_records(records: Sequence[Dict[str, Any]],
                           ) -> Dict[str, Dict[str, Any]]:
    """Strictly validate a decoded mingpt-trace/1 record stream and
    group it per trace.  Raises ValueError on the first violation.

    Enforced invariants (the chaos-selftest acceptance bar):

    * schema/kind/trace_id well-formed on every record;
    * exactly one ``request`` summary per trace_id;
    * zero orphans: every span/event parents to ``s0`` or to a span id
      present in the same trace;
    * durations non-negative, ``total_s`` coherent with start/end;
    * emit-event count equals the summary's ``n_tokens``, and the
    * summary's ``ttft_s``/``itl_mean_s`` reproduce exactly from the
      emit-event timestamps (same clock by construction).

    Cross-clock containment (a skewed replica's span falling inside the
    fleet-clock [start, end] window) is deliberately NOT asserted —
    clock skew is a feature of the chaos fleet, not a trace bug.
    """
    traces: Dict[str, Dict[str, Any]] = {}
    for i, rec in enumerate(records):
        where = f"record {i}"
        if not isinstance(rec, dict):
            _fail(where, f"not an object: {rec!r}")
        if rec.get("schema") != TRACE_SCHEMA:
            _fail(where, f"schema {rec.get('schema')!r} != {TRACE_SCHEMA!r}")
        kind = rec.get("kind")
        if kind not in _KINDS:
            _fail(where, f"kind {kind!r} not in {_KINDS}")
        tid = rec.get("trace_id")
        if not isinstance(tid, str) or not tid:
            _fail(where, f"trace_id {tid!r} must be a non-empty string")
        _check_num(where, rec, "ts")
        tr = traces.setdefault(
            tid, {"request": None, "spans": [], "events": []})
        if kind == "span":
            for key in ("span_id", "parent_id", "name"):
                if not isinstance(rec.get(key), str) or not rec[key]:
                    _fail(where, f"span {key!r} missing or empty")
            _check_num(where, rec, "dur_s")
            tr["spans"].append(rec)
        elif kind == "event":
            if not isinstance(rec.get("parent_id"), str):
                _fail(where, "event parent_id missing")
            if not isinstance(rec.get("name"), str) or not rec["name"]:
                _fail(where, "event name missing or empty")
            tr["events"].append(rec)
        else:
            if tr["request"] is not None:
                _fail(where, f"duplicate request summary for trace {tid!r}")
            if not isinstance(rec.get("outcome"), str) or not rec["outcome"]:
                _fail(where, "request outcome missing")
            for key in ("end_ts", "total_s"):
                _check_num(where, rec, key)
            for key in ("n_tokens", "attempts"):
                v = rec.get(key)
                if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                    _fail(where, f"request {key!r} must be an int >= 0")
            tr["request"] = rec

    for tid, tr in traces.items():
        where = f"trace {tid!r}"
        req = tr["request"]
        if req is None:
            _fail(where, "no request summary record")
        span_ids = {s["span_id"] for s in tr["spans"]}
        if len(span_ids) != len(tr["spans"]):
            _fail(where, "duplicate span ids")
        valid_parents = span_ids | {ROOT_SPAN_ID}
        for s in tr["spans"]:
            if s["parent_id"] not in valid_parents:
                _fail(where, f"orphan span {s['span_id']!r} "
                             f"(parent {s['parent_id']!r} unknown)")
        for e in tr["events"]:
            if e["parent_id"] not in valid_parents:
                _fail(where, f"orphan event {e['name']!r} "
                             f"(parent {e['parent_id']!r} unknown)")
        if abs((req["end_ts"] - req["ts"]) - req["total_s"]) > 1e-6:
            _fail(where, "total_s does not match end_ts - ts")
        emit_ts = sorted(e["ts"] for e in tr["events"]
                         if e["name"] == "emit")
        if len(emit_ts) != req["n_tokens"]:
            _fail(where, f"{len(emit_ts)} emit events != "
                         f"n_tokens {req['n_tokens']}")
        if emit_ts:
            ttft = emit_ts[0] - req["ts"]
            if req.get("ttft_s") is None or \
                    abs(req["ttft_s"] - ttft) > 1e-6:
                _fail(where, f"ttft_s {req.get('ttft_s')!r} does not "
                             f"reproduce from emit events ({ttft})")
            gaps = [b - a for a, b in zip(emit_ts, emit_ts[1:])]
            if gaps:
                mean = sum(gaps) / len(gaps)
                if req.get("itl_mean_s") is None or \
                        abs(req["itl_mean_s"] - mean) > 1e-6:
                    _fail(where, "itl_mean_s does not reproduce from "
                                 "emit events")
    return traces


def load_trace_jsonl(path: str) -> Dict[str, Dict[str, Any]]:
    """Read + strictly validate a mingpt-trace/1 JSONL file; returns
    ``{trace_id: {"request": rec, "spans": [...], "events": [...]}}``."""
    records = []
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{lineno}: not valid JSON: {e}") from e
    return validate_trace_records(records)
