"""Telemetry for the serving stack: one registry, spans, exporters.

* ``registry`` — counters, gauges and fixed-ladder histograms in one
  :class:`MetricsRegistry`, and ``RateWindow`` (windowed rates);
* ``spans``    — monotonic-clock nested spans in a bounded ring with an
  optional JSONL sink, and ``log_event``;
* ``export``   — Prometheus text exposition with its strict parser, the
  versioned JSONL event sink and the ``/metrics`` + ``/healthz`` endpoint
  (``TelemetryServer``).

``get_registry()`` is the process-wide registry the entry points export
from. The rest of the JAX package's ``telemetry/`` (the recompile
watchdog, request tracing, the flight recorder, SLO reports and
attribution) is ROADMAP.md Queue 1 item 16.
"""

from mingpt_distributed_tpu_torch.telemetry.export import (  # noqa: F401
    SCHEMA_VERSION,
    JsonlEventSink,
    TelemetryServer,
    parse_prometheus,
    render_prometheus,
)
from mingpt_distributed_tpu_torch.telemetry.registry import (  # noqa: F401
    LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricFamily,
    MetricsRegistry,
    RateWindow,
)
from mingpt_distributed_tpu_torch.telemetry.spans import (  # noqa: F401
    SpanTracer,
    log_event,
    process_index,
)

_registry = None


def get_registry() -> MetricsRegistry:
    """The process-wide registry every entry point exports from."""
    global _registry
    if _registry is None:
        _registry = MetricsRegistry()
    return _registry
