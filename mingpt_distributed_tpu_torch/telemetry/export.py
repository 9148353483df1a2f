"""Telemetry exporters over one :class:`MetricsRegistry`.

Counterpart of the parts of ``mingpt_distributed_tpu/telemetry/export.py``
that serving needs:

* **Prometheus text exposition** (``render_prometheus``; a fleet's merged
  page, ``render_fleet_prometheus`` from live registries and
  ``merge_fleet_pages`` from rendered pages) and its strict counterpart
  ``parse_prometheus``: every non-comment line must match the
  exposition grammar and histogram triplets must be coherent, so tests
  check a page by parsing it, not by string matching.
* **Versioned JSONL events** (:class:`JsonlEventSink`): every line is
  ``{"schema": SCHEMA_VERSION, "kind": <kind>, "ts": <epoch s>, ...}`` with
  the producer's payload flat at the top level (``span`` and ``event``
  records of ``telemetry/spans.py``).

* **Pull endpoint** (:class:`TelemetryServer`): ``/metrics`` (the
  exposition) and ``/healthz`` (JSON liveness) on a daemon-threaded stdlib
  HTTP server, behind ``serve.py --metrics-port`` and the trainer's
  ``metrics_port``; ``/debug/flight`` (a flight-recorder snapshot) and
  ``/attrib`` (the attribution report) where their providers are set,
  404 otherwise.
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, TextIO, Tuple

from mingpt_distributed_tpu_torch.telemetry.registry import MetricsRegistry

__all__ = [
    "SCHEMA_VERSION",
    "JsonlEventSink",
    "TelemetryServer",
    "merge_fleet_pages",
    "parse_prometheus",
    "render_prometheus",
]

#: Version tag stamped on every JSONL line; bump on breaking layout
#: changes and document the migration in docs/RELEASE_NOTES.md.
SCHEMA_VERSION = "mingpt-telemetry/1"


class JsonlEventSink:
    """Append-only, versioned JSONL event stream (thread-safe)."""

    def __init__(self, path: Optional[str] = None, file: Optional[TextIO] = None,
                 schema: str = SCHEMA_VERSION):
        if (path is None) == (file is None):
            raise ValueError("give exactly one of path / file")
        self._file = file if file is not None else open(path, "a")
        self._lock = threading.Lock()
        #: per-sink schema tag — the trace recorder reuses this sink
        #: with "mingpt-trace/1" (payloads always carry their own ts)
        self.schema = schema

    def write(self, kind: str, data: Dict[str, Any]) -> None:
        rec = {"schema": self.schema, "kind": kind}
        rec.setdefault("ts", data.get("ts", time.time()))
        rec.update(data)
        line = json.dumps(rec) + "\n"
        with self._lock:
            self._file.write(line)
            self._file.flush()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None  # type: ignore[assignment]


# ---------------------------------------------------------------------------
# Prometheus text exposition (format version 0.0.4)
# ---------------------------------------------------------------------------


def _escape_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(s: str) -> str:
    return (
        s.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def _fmt(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _sample(name: str, labels: Dict[str, str], value: float) -> str:
    if labels:
        body = ",".join(
            f'{k}="{_escape_label(str(v))}"' for k, v in labels.items()
        )
        return f"{name}{{{body}}} {_fmt(value)}"
    return f"{name} {_fmt(value)}"


def _child_samples(name: str, kind: str, labels: Dict[str, str], child) -> List[str]:
    """One labelled child's sample lines: a histogram's cumulative buckets,
    sum and count, else its value."""
    if kind != "histogram":
        return [_sample(name, labels, child.value)]
    out = []
    for upper, cum in child.cumulative():
        le = "+Inf" if upper == float("inf") else _fmt(upper)
        out.append(_sample(name + "_bucket", {**labels, "le": le}, cum))
    out.append(_sample(name + "_sum", labels, child.sum))
    out.append(_sample(name + "_count", labels, child.count))
    return out


def render_prometheus(registry: MetricsRegistry) -> str:
    """The registry as Prometheus text exposition. Families with no
    children yet still emit HELP/TYPE lines, so a scrape can assert a
    labeled counter (e.g. the recompile watchdog's) is absent-thus-zero
    without special-casing."""
    out: List[str] = []
    for fam in registry.collect():
        if fam.help:
            out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        out.append(f"# TYPE {fam.name} {fam.kind}")
        for labels, child in fam.children():
            out.extend(_child_samples(fam.name, fam.kind, labels, child))
    return "\n".join(out) + "\n"


def render_fleet_prometheus(
    base_registry: Optional[MetricsRegistry],
    replica_registries: Dict[str, MetricsRegistry],
) -> str:
    """One exposition page for a fleet: every replica's private registry
    under an injected ``replica`` label, plus an optional base registry
    (the router's and supervisor's families) as it is.

    A family that several replicas share is emitted under ONE HELP/TYPE
    header (the strict parser rejects a second TYPE line); a name with two
    instrument kinds anywhere in the fleet raises, as a registry does
    within one process. Families in sorted name order, replicas in sorted
    name order: the same registry states give the same bytes."""
    sources: List[Tuple[Optional[str], MetricsRegistry]] = []
    if base_registry is not None:
        sources.append((None, base_registry))
    sources.extend(sorted(replica_registries.items()))
    fams: Dict[str, List[Tuple[Optional[str], Any]]] = {}
    kinds: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for replica, reg in sources:
        for fam in reg.collect():
            prev = kinds.get(fam.name)
            if prev is not None and prev != fam.kind:
                raise ValueError(
                    f"fleet merge: family {fam.name!r} is {fam.kind} on "
                    f"{replica or 'base'} but {prev} elsewhere — exposition "
                    f"would be incoherent")
            kinds[fam.name] = fam.kind
            if fam.help and fam.name not in helps:
                helps[fam.name] = fam.help
            fams.setdefault(fam.name, []).append((replica, fam))
    out: List[str] = []
    for name in sorted(fams):
        if helps.get(name):
            out.append(f"# HELP {name} {_escape_help(helps[name])}")
        out.append(f"# TYPE {name} {kinds[name]}")
        for replica, fam in fams[name]:
            for labels, child in fam.children():
                if replica is not None:
                    labels = {"replica": replica, **labels}
                out.extend(_child_samples(name, fam.kind, labels, child))
    return "\n".join(out) + "\n"


_TYPE_RE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) (counter|gauge|histogram|summary|untyped)$"
)
_HELP_RE = re.compile(r"^# HELP ([a-zA-Z_:][a-zA-Z0-9_:]*) (.*)$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*="     # labels: name=
    r'"(?:[^"\\\n]|\\["\\n])*"'             # "value" with \" \\ \n escapes
    r"(?:,[a-zA-Z_][a-zA-Z0-9_]*="
    r'"(?:[^"\\\n]|\\["\\n])*")*)?)\})?'
    r" (NaN|[+-]Inf|[+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)"  # value
    r"(?: [0-9]+)?$"                        # optional timestamp
)
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\\n]|\\["\\n])*)"'
)


def _unescape_label(s: str) -> str:
    # single pass, not chained str.replace: replacing "\n" first would
    # corrupt a literal backslash-then-n ("\\" + "n" must stay "\" + "n")
    out: List[str] = []
    i = 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt in ('"', "\\"):
                out.append(nxt)
                i += 2
                continue
        out.append(s[i])
        i += 1
    return "".join(out)


def _parse_value(s: str) -> float:
    if s == "NaN":
        return float("nan")
    if s == "+Inf":
        return float("inf")
    if s == "-Inf":
        return float("-inf")
    return float(s)


def parse_prometheus(text: str) -> Dict[str, Any]:
    """Strict exposition parser: every non-blank, non-comment line must
    match the sample grammar exactly, histogram families must expose
    coherent ``_bucket``/``_sum``/``_count`` triplets (cumulative,
    ``+Inf`` bucket == ``_count``). Raises ``ValueError`` on any
    violation. Returns ``{"types": {family: kind}, "samples":
    [(name, labels, value)]}``.
    """
    types: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            m = _TYPE_RE.match(line)
            if m:
                name, kind = m.groups()
                if name in types:
                    raise ValueError(f"line {lineno}: duplicate TYPE {name}")
                types[name] = kind
                continue
            if line.startswith("# TYPE"):
                # a TYPE line that failed the grammar must not pass as a
                # free-form comment — that's exactly the class of drift a
                # strict parser exists to catch
                raise ValueError(f"line {lineno}: malformed TYPE {line!r}")
            if _HELP_RE.match(line) or line.startswith("# "):
                continue
            raise ValueError(f"line {lineno}: malformed comment {line!r}")
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        name, labelblob, value = m.group(1), m.group(2), m.group(3)
        labels = {
            k: _unescape_label(v)
            for k, v in _LABEL_PAIR_RE.findall(labelblob or "")
        }
        samples.append((name, labels, _parse_value(value)))

    # histogram triplet coherence
    for fam, kind in types.items():
        if kind != "histogram":
            continue
        series: Dict[Tuple[Tuple[str, str], ...], Dict[str, Any]] = {}
        for name, labels, value in samples:
            base = {k: v for k, v in labels.items() if k != "le"}
            key = tuple(sorted(base.items()))
            rec = series.setdefault(key, {"buckets": [], "sum": None,
                                          "count": None})
            if name == fam + "_bucket":
                if "le" not in labels:
                    raise ValueError(f"{fam}_bucket sample without le label")
                rec["buckets"].append((_parse_value(labels["le"]), value))
            elif name == fam + "_sum":
                rec["sum"] = value
            elif name == fam + "_count":
                rec["count"] = value
        series = {k: v for k, v in series.items()
                  if v["buckets"] or v["sum"] is not None
                  or v["count"] is not None}
        for key, rec in series.items():
            if not rec["buckets"] or rec["sum"] is None or rec["count"] is None:
                raise ValueError(
                    f"histogram {fam}{dict(key)} missing one of "
                    f"_bucket/_sum/_count"
                )
            bounds = [b for b, _ in rec["buckets"]]
            counts = [c for _, c in rec["buckets"]]
            if bounds != sorted(bounds) or bounds[-1] != float("inf"):
                raise ValueError(
                    f"histogram {fam}: le bounds not increasing to +Inf")
            if counts != sorted(counts):
                raise ValueError(
                    f"histogram {fam}: bucket counts not cumulative")
            if counts[-1] != rec["count"]:
                raise ValueError(
                    f"histogram {fam}: +Inf bucket {counts[-1]} != _count "
                    f"{rec['count']}"
                )
    return {"types": types, "samples": samples}


def merge_fleet_pages(
    base_page: Optional[str],
    replica_pages: Dict[str, str],
    label: str = "replica",
) -> str:
    """A fleet's page merged from ALREADY-RENDERED exposition pages.

    :func:`render_fleet_prometheus` merges live registries, which needs every
    replica in the router's process; a process-isolated fleet has only each
    replica's ``/metrics`` text, fetched over its RPC socket. This merges
    those pages under the same contract: ONE HELP/TYPE header per family (the
    strict parser rejects a second TYPE line, so the pages cannot simply be
    concatenated), the ``label`` (``replica``) injected on every replica
    sample, a kind conflict anywhere in the fleet raises, and the output is
    sorted (families, then the base page before the replicas in sorted
    order) so the same pages give the same bytes. Every input page is
    strict-parsed first: a malformed replica page fails the merge.

    The cross-host fleet merges per-host pages, which carry ``replica``
    labels already, under ``label="host"``."""
    sources: List[Tuple[Optional[str], str]] = []
    if base_page is not None:
        sources.append((None, base_page))
    sources.extend(sorted(replica_pages.items()))
    kinds: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    fam_samples: Dict[str, List[Tuple[Optional[str], str, Dict[str, str], float]]] = {}
    for replica, page in sources:
        parsed = parse_prometheus(page)
        for fam, kind in parsed["types"].items():
            prev = kinds.get(fam)
            if prev is not None and prev != kind:
                raise ValueError(
                    f"fleet page merge: family {fam!r} is {kind} on "
                    f"{replica or 'base'} but {prev} elsewhere — exposition "
                    f"would be incoherent")
            kinds[fam] = kind
            fam_samples.setdefault(fam, [])
        for line in page.splitlines():
            m = _HELP_RE.match(line)
            if m and m.group(1) not in helps:
                helps[m.group(1)] = m.group(2)
        for name, labels, value in parsed["samples"]:
            fam = name
            if fam not in parsed["types"]:
                for suffix in ("_bucket", "_sum", "_count"):
                    stem = name[: -len(suffix)]
                    if name.endswith(suffix) and stem in parsed["types"]:
                        fam = stem
                        break
            if fam not in parsed["types"]:
                raise ValueError(f"fleet page merge: sample {name!r} on "
                                 f"{replica or 'base'} has no TYPE header")
            fam_samples[fam].append((replica, name, labels, value))
    out: List[str] = []
    for fam in sorted(kinds):
        if helps.get(fam):
            # help text comes off the wire already escaped: verbatim
            out.append(f"# HELP {fam} {helps[fam]}")
        out.append(f"# TYPE {fam} {kinds[fam]}")
        for replica, name, labels, value in fam_samples[fam]:
            if replica is not None:
                labels = {label: replica, **labels}
            out.append(_sample(name, labels, value))
    return "\n".join(out) + "\n"


class TelemetryServer:
    """``/metrics`` (Prometheus text) and ``/healthz`` (JSON liveness) on a
    daemon-threaded stdlib server. ``port=0`` binds an ephemeral port (read
    it from ``.port``), so parallel runs never collide.

    ``health_provider``, ``flight_provider``, ``attrib_provider`` and
    ``metrics_provider`` are settable attributes, read per request: the
    first returns a dict merged into the healthz document, the second a
    flight-recorder snapshot served on ``/debug/flight``, the third the
    ``mingpt-attrib/1`` report served on ``/attrib`` (each of the two 404
    without its provider), the last overrides the ``/metrics`` body."""

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1", health_provider=None,
                 flight_provider=None, attrib_provider=None,
                 metrics_provider=None):
        self.registry = registry
        self.health_provider = health_provider
        self.flight_provider = flight_provider
        self.attrib_provider = attrib_provider
        self.metrics_provider = metrics_provider
        self._t0 = time.time()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (the stdlib's name)
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    mp = outer.metrics_provider
                    body = (render_prometheus(outer.registry) if mp is None
                            else mp()).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/healthz":
                    doc = {"status": "ok",
                           "uptime_s": round(time.time() - outer._t0, 3)}
                    hp = outer.health_provider
                    if hp is not None:
                        try:
                            doc.update(hp())
                        except Exception as e:  # liveness must survive
                            doc["status"] = "error"
                            doc["health_provider_error"] = repr(e)
                    body = json.dumps(doc).encode()
                    ctype = "application/json"
                elif path in ("/debug/flight", "/attrib"):
                    provider = (outer.flight_provider if path == "/debug/flight"
                                else outer.attrib_provider)
                    if provider is None:
                        self.send_error(404, f"no {path[1:]} provider configured")
                        return
                    try:
                        doc = provider()
                    except Exception as e:  # the endpoint must survive
                        doc = {"error": repr(e)}
                    body = json.dumps(doc, sort_keys=True, default=repr).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404, "unknown path (try /metrics)")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:  # scrapes are noise
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="telemetry-http", daemon=True)
        self._thread.start()

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
