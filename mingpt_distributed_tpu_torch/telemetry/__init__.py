"""Telemetry for the serving stack and the trainer.

* ``registry``    — counters, gauges and fixed-ladder histograms in one
  :class:`MetricsRegistry`, and ``RateWindow`` (windowed rates);
* ``peaks``       — the card's peak table (the single source of MFU and
  roofline numbers);
* ``spans``       — monotonic-clock nested spans in a bounded ring with an
  optional JSONL sink, and ``log_event``;
* ``export``      — Prometheus text exposition (one registry, or a fleet's
  merged page) with its strict parser, the
  versioned JSONL event sink and the ``/metrics``, ``/healthz``,
  ``/debug/flight`` and ``/attrib`` endpoint (``TelemetryServer``);
* ``watchdog``    — post-warmup growth of the serving shape families;
* ``tracing``     — request-scoped ``mingpt-trace/1`` traces with their
  strict loader;
* ``flightrec``   — the bounded flight-recorder ring, dumped atomically;
* ``slo``         — graded SLO reports from exact per-request durations;
* ``attribution`` — the program and HBM ledgers and the ``mingpt-attrib/1``
  report.

``get_registry()`` and ``get_tracer()`` are the process-wide instances the
entry points export from.
"""

from __future__ import annotations

from typing import Optional

from mingpt_distributed_tpu_torch.telemetry.attribution import (  # noqa: F401
    ATTRIB_SCHEMA,
    HBMLedger,
    ProgramLedger,
    build_attrib_report,
    dump_attrib_report,
    forward_cost,
    per_device_tree_bytes,
    render_attrib_report,
    tree_bytes,
    validate_attrib_report,
)
from mingpt_distributed_tpu_torch.telemetry.export import (  # noqa: F401
    SCHEMA_VERSION,
    JsonlEventSink,
    TelemetryServer,
    merge_fleet_pages,
    parse_prometheus,
    render_fleet_prometheus,
    render_prometheus,
)
from mingpt_distributed_tpu_torch.telemetry.flightrec import (  # noqa: F401
    FLIGHT_SCHEMA,
    FlightRecorder,
    load_flight_dir,
    validate_flight_dump,
)
from mingpt_distributed_tpu_torch.telemetry.peaks import (  # noqa: F401
    PEAKS,
    peak_flops_per_chip,
    peak_hbm_bytes_per_chip,
    peak_hbm_capacity_per_chip,
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
from mingpt_distributed_tpu_torch.telemetry.slo import (  # noqa: F401
    SLO_SCHEMA,
    SLObjective,
    diff_slo_reports,
    evaluate_slos,
    exact_quantile,
    parse_slo_spec,
    render_slo_diff,
    render_slo_report,
)
from mingpt_distributed_tpu_torch.telemetry.spans import (  # noqa: F401
    SpanTracer,
    log_event,
    process_index,
)
from mingpt_distributed_tpu_torch.telemetry.tracing import (  # noqa: F401
    TRACE_SCHEMA,
    TraceContext,
    TraceRecorder,
    load_trace_jsonl,
    trace_baggage,
    trace_sink,
    validate_trace_records,
)
from mingpt_distributed_tpu_torch.telemetry.watchdog import (  # noqa: F401
    RecompileError,
    RecompileWatchdog,
)

_registry: Optional[MetricsRegistry] = None
_tracer: Optional[SpanTracer] = None


def get_registry() -> MetricsRegistry:
    """The process-wide registry every entry point exports from."""
    global _registry
    if _registry is None:
        _registry = MetricsRegistry()
    return _registry


def get_tracer() -> SpanTracer:
    """The process-wide tracer, enabled on process 0 only (one writer, as
    MetricsLogger): other processes get a disabled tracer."""
    global _tracer
    if _tracer is None:
        _tracer = SpanTracer(enabled=process_index() == 0)
    return _tracer
