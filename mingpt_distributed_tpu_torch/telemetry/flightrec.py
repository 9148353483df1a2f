"""Flight recorder: a bounded ring of recent trace records plus registry
snapshots, dumped atomically when something goes wrong (a post-warmup
recompile, a SIGTERM drain) or on demand through TelemetryServer's
``/debug/flight``.

The port's own copy of ``mingpt_distributed_tpu/telemetry/flightrec.py``
(same ``mingpt-flight/1`` documents and manifest). The ring stores whatever
clock-domain ``ts`` the producer supplied; only the dump envelope carries a
wall anchor (``wall_ts``, one ``time.time()`` read) for correlating a dump
with logs.

Durability: each dump is written tmp + ``os.replace``, then the manifest
(``flight-manifest.json``, same idiom) is rewritten as the commit point, so
a reader that follows ``manifest["latest"]`` never sees a torn dump (the
idiom of ``training/durability.py``).
"""

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

FLIGHT_SCHEMA = "mingpt-flight/1"
MANIFEST_SCHEMA = "mingpt-flight-manifest/1"


def _atomic_write(path: str, blob: bytes) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(blob)
    os.replace(tmp, path)


class FlightRecorder:
    """Bounded ring + snapshot/dump machinery.

    ``source_providers`` are zero-arg callables returning a list of
    record dicts (e.g. a SpanTracer's ring, which carries log_events);
    ``metrics_providers`` return Prometheus exposition text (the shared
    process registry plus one per replica).  Both are sampled at
    snapshot time, so per-replica providers must be closures that
    survive respawn (resolve ``rep.server`` lazily).
    """

    def __init__(self, capacity: int = 2048, out_dir: Optional[str] = None,
                 max_dumps: int = 32, registry=None):
        self._ring: deque = deque(maxlen=int(capacity))
        self.capacity = int(capacity)
        self.out_dir = out_dir
        self.max_dumps = int(max_dumps)
        self.recorded = 0
        self.dumps_skipped = 0
        self.source_providers: Dict[str, Callable[[], List[dict]]] = {}
        self.metrics_providers: Dict[str, Callable[[], str]] = {}
        self._manifest_entries: List[Dict[str, Any]] = []
        self._seq = 0
        self._lock = threading.Lock()
        self._c_dumps = None
        if registry is not None:
            self._c_dumps = registry.counter(
                "mingpt_flight_dumps_total",
                help="flight-recorder dumps written, by trigger",
                labels=("trigger",))

    # -- the ring -----------------------------------------------------

    def record(self, kind: str, rec: Dict[str, Any]) -> None:
        """Append one record (``ts`` supplied by the producer's clock)."""
        with self._lock:
            self._ring.append({"kind": kind, **rec})
            self.recorded += 1

    @property
    def dropped(self) -> int:
        return max(0, self.recorded - self.capacity)

    # -- snapshot / dump ----------------------------------------------

    def snapshot(self, trigger: str, **attrs) -> Dict[str, Any]:
        """Assemble (but don't persist) a flight record document."""
        with self._lock:
            records = list(self._ring)
            seq = self._seq
        sources: Dict[str, List[dict]] = {}
        for name, fn in sorted(self.source_providers.items()):
            try:
                sources[name] = list(fn())
            except Exception as e:  # a dead provider must not kill a dump
                sources[name] = [{"kind": "provider_error",
                                  "error": repr(e)}]
        metrics: Dict[str, str] = {}
        for name, fn in sorted(self.metrics_providers.items()):
            try:
                metrics[name] = fn()
            except Exception as e:
                metrics[name] = f"# provider_error {e!r}\n"
        wall_ts = time.time()
        doc: Dict[str, Any] = {
            "schema": FLIGHT_SCHEMA, "trigger": trigger, "seq": seq,
            "wall_ts": wall_ts,
            "records": records, "recorded_total": self.recorded,
            "ring_dropped": self.dropped,
            "sources": sources, "metrics": metrics,
        }
        if attrs:
            doc["attrs"] = attrs
        return doc

    def dump(self, trigger: str, **attrs
             ) -> Tuple[Optional[str], Dict[str, Any]]:
        """Snapshot and persist atomically; returns (path, doc).
        ``path`` is None when no out_dir is configured or the dump cap
        was reached (counted in ``dumps_skipped``, never raised)."""
        doc = self.snapshot(trigger, **attrs)
        if self.out_dir is None:
            return None, doc
        with self._lock:
            if len(self._manifest_entries) >= self.max_dumps:
                self.dumps_skipped += 1
                return None, doc
            self._seq += 1
            doc["seq"] = self._seq
            fname = f"flight-{self._seq:04d}-{trigger}.json"
            entry = {"file": fname, "trigger": trigger,
                     "seq": self._seq, "wall_ts": doc["wall_ts"]}
            path = os.path.join(self.out_dir, fname)
            _atomic_write(path, json.dumps(doc, sort_keys=True,
                                           default=repr).encode("utf-8"))
            self._manifest_entries.append(entry)
            manifest = {"schema": MANIFEST_SCHEMA, "latest": fname,
                        "dumps": list(self._manifest_entries)}
            _atomic_write(os.path.join(self.out_dir,
                                       "flight-manifest.json"),
                          json.dumps(manifest, sort_keys=True,
                                     ).encode("utf-8"))
        if self._c_dumps is not None:
            self._c_dumps.labels(trigger=trigger).inc()
        return path, doc


# ---------------------------------------------------------------------
# strict validation / loading
# ---------------------------------------------------------------------


def _fail(msg: str) -> None:
    raise ValueError(f"mingpt-flight/1 validation: {msg}")


def validate_flight_dump(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Strictly validate one dump document.  Every ``metrics`` value
    must pass the strict Prometheus exposition parser — a flight record
    with an unscrapable registry snapshot is evidence lost."""
    from .export import parse_prometheus

    if not isinstance(doc, dict):
        _fail(f"not an object: {type(doc).__name__}")
    if doc.get("schema") != FLIGHT_SCHEMA:
        _fail(f"schema {doc.get('schema')!r} != {FLIGHT_SCHEMA!r}")
    if not isinstance(doc.get("trigger"), str) or not doc["trigger"]:
        _fail("trigger missing or empty")
    for key in ("wall_ts", "recorded_total", "ring_dropped"):
        v = doc.get(key)
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
            _fail(f"{key!r} must be a number >= 0, got {v!r}")
    records = doc.get("records")
    if not isinstance(records, list):
        _fail("records must be a list")
    for i, rec in enumerate(records):
        if not isinstance(rec, dict) or not rec.get("kind"):
            _fail(f"records[{i}] missing kind")
        ts = rec.get("ts")
        if not isinstance(ts, (int, float)) or isinstance(ts, bool):
            _fail(f"records[{i}] missing numeric ts")
    if not isinstance(doc.get("sources"), dict):
        _fail("sources must be an object")
    metrics = doc.get("metrics")
    if not isinstance(metrics, dict):
        _fail("metrics must be an object")
    for name, text in metrics.items():
        if not isinstance(text, str):
            _fail(f"metrics[{name!r}] must be exposition text")
        try:
            parse_prometheus(text)
        except ValueError as e:
            _fail(f"metrics[{name!r}] does not strict-parse: {e}")
    return doc


def load_flight_dir(out_dir: str
                    ) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Read + validate the manifest and every dump it lists; returns
    (manifest, [validated docs])."""
    mpath = os.path.join(out_dir, "flight-manifest.json")
    with open(mpath, "r", encoding="utf-8") as fh:
        manifest = json.load(fh)
    if manifest.get("schema") != MANIFEST_SCHEMA:
        _fail(f"manifest schema {manifest.get('schema')!r} != "
              f"{MANIFEST_SCHEMA!r}")
    entries = manifest.get("dumps")
    if not isinstance(entries, list) or not entries:
        _fail("manifest lists no dumps")
    if manifest.get("latest") != entries[-1].get("file"):
        _fail("manifest latest pointer does not match the last entry")
    docs = []
    for entry in entries:
        with open(os.path.join(out_dir, entry["file"]), "r",
                  encoding="utf-8") as fh:
            docs.append(validate_flight_dump(json.load(fh)))
    return manifest, docs
