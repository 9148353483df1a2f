"""Low-overhead span tracer.

Counterpart of ``mingpt_distributed_tpu/telemetry/spans.py``: nested
wall-time spans on the monotonic clock, recorded into a bounded ring buffer
(a deque with ``maxlen``, so a stuck exporter never grows host memory) and
optionally streamed to the versioned JSONL sink. The serving scheduler wraps
admission, prefill chunks and decode rounds in spans.

Overhead discipline: a disabled tracer returns one shared no-op context
manager (no allocation per call); an enabled span costs two clock reads,
one dict build and a deque append.

Record layout (also the JSONL ``kind: "span"`` payload):
``{"name", "ts" (epoch s, start), "dur_s", "depth", <attrs...>}``.
Point events (``tracer.event``) carry ``{"name", "ts", <attrs...>}``.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from mingpt_distributed_tpu_torch.telemetry.export import JsonlEventSink

__all__ = ["SpanTracer", "log_event", "process_index"]


def process_index() -> int:
    """This process's rank in an initialised ``torch.distributed`` group,
    else 0. Telemetry never initialises a process group itself."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class _NoopSpan:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "name", "attrs", "_t0", "_ts")

    def __init__(self, tracer: "SpanTracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        self._ts = time.time()
        self._tracer._depth_tls.depth = getattr(
            self._tracer._depth_tls, "depth", 0) + 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter() - self._t0
        depth = getattr(self._tracer._depth_tls, "depth", 1) - 1
        self._tracer._depth_tls.depth = depth
        rec = {"name": self.name, "ts": self._ts,
               "dur_s": dur, "depth": depth}
        if self.attrs:
            rec.update(self.attrs)
        self._tracer._record("span", rec)
        return False


class SpanTracer:
    """Nested spans + point events in a bounded ring, optional JSONL."""

    def __init__(
        self,
        capacity: int = 4096,
        sink: Optional[JsonlEventSink] = None,
        enabled: bool = True,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = enabled
        self.capacity = capacity
        self.sink = sink
        self.emitted = 0  # total ever recorded; ring keeps the newest
        self._ring: deque = deque(maxlen=capacity)
        self._depth_tls = threading.local()

    def span(self, name: str, **attrs: Any):
        """Context manager timing a nested phase. Near-free when the
        tracer is disabled (one shared no-op object)."""
        if not self.enabled:
            return _NOOP
        return _Span(self, name, attrs)

    def event(self, name: str, **attrs: Any) -> None:
        """A point-in-time event (no duration) — watchdog firings, log
        lines, phase markers."""
        if not self.enabled:
            return
        rec = {"name": name, "ts": time.time(),
               "depth": getattr(self._depth_tls, "depth", 0)}
        rec.update(attrs)
        self._record("event", rec)

    def _record(self, kind: str, rec: Dict[str, Any]) -> None:
        rec["kind"] = kind
        self._ring.append(rec)
        self.emitted += 1
        if self.sink is not None:
            payload = dict(rec)
            payload.pop("kind")
            self.sink.write(kind, payload)

    @property
    def dropped(self) -> int:
        return self.emitted - len(self._ring)

    def records(self) -> List[Dict[str, Any]]:
        """Snapshot of the ring, oldest first."""
        return list(self._ring)

    def attach_jsonl(self, path: str) -> None:
        """Start streaming spans/events to a JSONL file (idempotent for
        the same tracer: replaces any previous sink)."""
        if self.sink is not None:
            self.sink.close()
        self.sink = JsonlEventSink(path)

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()
            self.sink = None


def log_event(
    message: str,
    *,
    tracer: Optional[SpanTracer] = None,
    file=None,
    **attrs: Any,
) -> None:
    """Replacement for bare ``print()`` in multi-process code paths: the
    line is prefixed with the process index (so interleaved output stays
    attributable) and, when a tracer is given, mirrored into its event
    ring and JSONL."""
    print(f"[p{process_index()}] {message}", file=file or sys.stdout,
          flush=True)
    if tracer is not None:
        tracer.event("log", message=message, **attrs)
