"""Control plane: fleet signals and the cost model.

Counterpart of ``mingpt_distributed_tpu/control/``:

* :mod:`signals` — one typed, injected-clock snapshot of fleet state per
  control tick (rolling TTFT and deadline windows, queue depth, shed
  counts, replica readiness, HBM headroom), and the live-health view the
  ``health`` admission policy binds to;
* :mod:`cost` — the per-policy cost model (deadline misses per token
  served and shed-weighted goodput), one implementation for traffic-lab
  cells and live counters.

The SLO autoscaler (``controller.py``) and the trace importer
(``importer.py``) are ROADMAP.md Queue 1 item 15c. Imports no torch: the
control plane reasons about the fleet through its telemetry.
"""

from mingpt_distributed_tpu_torch.control.cost import (
    compute_cost,
    cost_from_cell,
    cost_from_signals,
)
from mingpt_distributed_tpu_torch.control.signals import (
    ControlSnapshot,
    FleetSignalsView,
    SignalSampler,
)

__all__ = [
    "ControlSnapshot",
    "FleetSignalsView",
    "SignalSampler",
    "compute_cost",
    "cost_from_cell",
    "cost_from_signals",
]
