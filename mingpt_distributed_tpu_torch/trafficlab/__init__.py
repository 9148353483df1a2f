"""Traffic lab: open-loop load generation, multi-tenant workload mixes,
and pluggable admission policies graded on the same arrival trace.

Counterpart of ``mingpt_distributed_tpu/trafficlab/``. The serving
question — "at what offered load does TTFT/ITL p99 fall off a cliff, and
which admission policy holds the SLO longest?" — needs an *open-loop*
generator: closed-loop selftests (submit, wait, submit) self-throttle and
can never expose queueing collapse, while open-loop arrivals keep offering
load whether or not the fleet keeps up. Everything here runs on the
fleet's VirtualClock: arrival schedules are virtual-timestamp *data*
sampled once from ``(seed, spec)``, so a 2-policy multi-rung sweep reads no
wall clock (``tests/test_torch_trafficlab.py`` pins this), and the same
seed replays the same report bytes — on the CPU and on a card alike.

* ``arrivals.py`` — seeded arrival processes (Poisson, bursty on/off,
  ramp) emitting absolute virtual timestamps via Lewis–Shedler thinning,
  plus ``recorded:`` literal replay.
* ``workloads.py`` — multi-tenant mixes (chat / completion / long-context
  / shared-prefix families) rendered into concrete ``Request``s;
  shared-prefix pools exercise the PrefixKVStore.
* ``policies.py`` — deadline-aware EDF and fair-share per-tenant
  ``AdmissionPolicy`` implementations plus the name registry (FIFO itself
  lives in serving/admission.py as the default).
* ``runner.py`` / ``report.py`` — the load-sweep runner (ladder of
  offered-load rungs, each policy replayed on the identical trace,
  ServingFaultInjector as an optional chaos axis) and the versioned
  ``mingpt-traffic/1`` report with SLO grades and knee location.

CLI: ``python -m mingpt_distributed_tpu_torch.traffic``.
"""

from mingpt_distributed_tpu_torch.trafficlab.arrivals import (
    BurstySpec,
    PoissonSpec,
    RampSpec,
    RecordedSpec,
    arrival_times,
    format_arrival_spec,
    parse_arrival_spec,
)
from mingpt_distributed_tpu_torch.trafficlab.policies import (
    POLICIES,
    DeadlinePolicy,
    FairSharePolicy,
    make_policy,
)
from mingpt_distributed_tpu_torch.trafficlab.report import (
    TRAFFIC_SCHEMA,
    locate_knees,
    render_traffic_report,
    validate_traffic_report,
)
from mingpt_distributed_tpu_torch.trafficlab.runner import SweepSpec, run_sweep
from mingpt_distributed_tpu_torch.trafficlab.workloads import (
    TenantSpec,
    TimedRequest,
    WorkloadMix,
    default_mix,
)

__all__ = [
    "BurstySpec",
    "DeadlinePolicy",
    "FairSharePolicy",
    "POLICIES",
    "PoissonSpec",
    "RampSpec",
    "RecordedSpec",
    "SweepSpec",
    "TRAFFIC_SCHEMA",
    "TenantSpec",
    "TimedRequest",
    "WorkloadMix",
    "arrival_times",
    "default_mix",
    "format_arrival_spec",
    "locate_knees",
    "make_policy",
    "parse_arrival_spec",
    "render_traffic_report",
    "run_sweep",
    "validate_traffic_report",
]
