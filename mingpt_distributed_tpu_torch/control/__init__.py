"""Control plane: signals → cost → decisions → actuation.

Counterpart of ``mingpt_distributed_tpu/control/``:

* :mod:`signals` — one typed, injected-clock snapshot of fleet state per
  control tick (rolling TTFT and deadline windows, queue depth, shed
  counts, replica readiness, HBM headroom), and the live-health view the
  ``health`` admission policy binds to;
* :mod:`cost` — the per-policy cost model (deadline misses per token
  served and shed-weighted goodput), one implementation for traffic-lab
  cells and live counters;
* :mod:`controller` — the SLO autoscaler: hysteresis and cooldown over the
  signals, actuating replica count, speculation, prefill chunk and shed
  watermark, every decision a ``mingpt-control/1`` JSONL row;
* :mod:`importer` — recorded ``mingpt-trace/1`` logs → ``recorded:``
  arrival specs, so sweeps replay production-shaped load exactly.

Imports no torch: the control plane reasons about the fleet through its
telemetry, never through device state.
"""

from mingpt_distributed_tpu_torch.control.controller import (
    CONTROL_SCHEMA,
    ControllerConfig,
    HysteresisGovernor,
    SLOAutoscaler,
    parse_controller_spec,
    render_control_log,
    validate_control_log,
)
from mingpt_distributed_tpu_torch.control.cost import (
    compute_cost,
    cost_from_cell,
    cost_from_signals,
)
from mingpt_distributed_tpu_torch.control.importer import (
    import_trace_arrivals,
    trace_arrival_times,
)
from mingpt_distributed_tpu_torch.control.signals import (
    ControlSnapshot,
    FleetSignalsView,
    SignalSampler,
)

__all__ = [
    "CONTROL_SCHEMA",
    "ControlSnapshot",
    "ControllerConfig",
    "FleetSignalsView",
    "HysteresisGovernor",
    "SLOAutoscaler",
    "SignalSampler",
    "compute_cost",
    "cost_from_cell",
    "cost_from_signals",
    "import_trace_arrivals",
    "parse_controller_spec",
    "render_control_log",
    "trace_arrival_times",
    "validate_control_log",
]
