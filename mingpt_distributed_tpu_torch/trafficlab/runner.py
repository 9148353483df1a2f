"""The load-sweep runner: offered-load ladder x admission policies on
one arrival trace, all on VirtualClock.

Counterpart of ``mingpt_distributed_tpu/trafficlab/runner.py``.
``run_sweep`` steps a base arrival spec through a ladder of load factors.
Per rung it samples the arrival trace ONCE and renders it ONCE; every
policy then replays that identical trace against a fresh fleet (fresh
VirtualClock, TraceRecorder, supervisor, router and policy instance —
nothing leaks between cells, and ``TimedRequest.to_request`` mints fresh
Request objects per policy so runs can't see each other's mutations). The
drive loop is open-loop: arrivals whose virtual timestamp has come due are
submitted whether or not the fleet kept up — ``ShedError`` becomes an
outcome row, not an exception — then the router steps (which ticks the
clock), and idle gaps fast-forward the clock to the next arrival instead
of burning rounds. No wall clock is read, so the same ``(seed, spec,
mix)`` gives the same report bytes on the CPU and on a card: the virtual
schedule depends on token counts, never on how long a forward took.

Grading joins the rendered trace against the TraceRecorder's per-request
summaries by fleet request id (the router's own ``fleet-shed-*`` traces are
deliberately NOT rows — the shed submissions already are, so sheds would
double-count) and hands the rows to ``telemetry.slo.evaluate_slos``. A
``ServingFaultInjector`` spec composes as a chaos axis: the same sweep,
graded under crashes. Every cell carries the cost model's block
(``control/cost.py``).

Not ported yet, each raising with its ROADMAP.md Queue 1 item: the
cross-host axis (``n_hosts > 1``, ``net_chaos_spec``), item 15b; autoscaled
cells (a controller other than ``"static"``), item 15c.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from mingpt_distributed_tpu_torch.control.cost import cost_from_cell
from mingpt_distributed_tpu_torch.control.signals import FleetSignalsView
from mingpt_distributed_tpu_torch.serving.fleet import (
    ReplicaSupervisor,
    Router,
    VirtualClock,
    default_server_factory,
)
from mingpt_distributed_tpu_torch.serving.requests import ShedError
from mingpt_distributed_tpu_torch.telemetry.slo import (
    DEFAULT_SLO_SPEC,
    evaluate_slos,
    parse_slo_spec,
)
from mingpt_distributed_tpu_torch.telemetry.tracing import TraceRecorder
from mingpt_distributed_tpu_torch.trafficlab.arrivals import (
    arrival_times,
    parse_arrival_spec,
    spec_to_json,
)
from mingpt_distributed_tpu_torch.trafficlab.policies import make_policy
from mingpt_distributed_tpu_torch.trafficlab.report import (
    TRAFFIC_SCHEMA,
    headline_knee,
    locate_knees,
    validate_traffic_report,
)
from mingpt_distributed_tpu_torch.trafficlab.workloads import (
    TimedRequest,
    WorkloadMix,
    default_mix,
    trace_digest,
)
from mingpt_distributed_tpu_torch.training.faults import ServingFaultInjector

__all__ = [
    "SweepSpec",
    "run_sweep",
]


def _refuse(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1 item {item})")


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Everything a sweep needs besides model params and the mix —
    (seed, SweepSpec, mix) fully determines the report bytes."""

    arrival: str = "poisson:rate=60.0"
    ladder: Tuple[float, ...] = (1.0, 2.0, 4.0)
    policies: Tuple[str, ...] = ("fifo", "edf")
    n_requests: int = 64
    seed: int = 0
    n_replicas: int = 2
    n_slots: int = 4
    tick_s: float = 0.001
    slo: str = "default"
    knee_objective: Optional[str] = None  # None: first objective in spec
    chaos_spec: Optional[str] = None
    #: recovery-tail objective: when set, appends ``recovery_p99<=X`` to
    #: the SLO spec — p99 of per-request fault -> first-replacement-token
    #: time, so a chaos sweep grades how fast failover is, not just
    #: whether streams stay exact
    recovery_slo_s: Optional[float] = None
    shed_watermark: Optional[int] = None
    prefix_cache_mb: float = 0.0
    max_rounds: int = 200_000
    #: the cross-host axis (item 15b): only 1 runs here
    n_hosts: int = 1
    #: network chaos over a host mesh (item 15b): only None runs here
    net_chaos_spec: Optional[str] = None
    #: the controller axis: ``"static"`` (no control loop) runs; an
    #: ``auto[:k=v...]`` autoscaler is item 15c
    controllers: Tuple[str, ...] = ("static",)

    def effective_slo(self) -> str:
        """The SLO spec with the recovery-tail objective folded in."""
        if self.recovery_slo_s is None:
            return self.slo
        base = (DEFAULT_SLO_SPEC if self.slo.strip() == "default"
                else self.slo)
        return f"{base},recovery_p99<={self.recovery_slo_s:g}"

    def validate(self) -> None:
        parse_arrival_spec(self.arrival)
        if len(self.ladder) < 1:
            raise ValueError("ladder needs at least one load factor")
        if any(b <= a for a, b in zip(self.ladder, self.ladder[1:])):
            raise ValueError(
                f"ladder must be strictly increasing, got {self.ladder}")
        if any(f <= 0 for f in self.ladder):
            raise ValueError("ladder factors must be > 0")
        if not self.policies or len(set(self.policies)) != len(self.policies):
            raise ValueError(f"bad policy list {self.policies}")
        for p in self.policies:
            make_policy(p)
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1")
        if self.recovery_slo_s is not None and self.recovery_slo_s <= 0:
            raise ValueError(
                f"recovery_slo_s must be > 0, got {self.recovery_slo_s}")
        if self.n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {self.n_hosts}")
        if self.n_hosts > 1:
            _refuse("the cross-host sweep axis (n_hosts > 1)", "15b")
        if self.net_chaos_spec:
            _refuse("network chaos over a host mesh (net_chaos_spec)", "15b")
        if not self.controllers or (
                len(set(self.controllers)) != len(self.controllers)):
            raise ValueError(f"bad controller list {self.controllers}")
        for ctrl in self.controllers:
            if ctrl.strip() != "static":
                _refuse(f"the SLO autoscaler (controller {ctrl!r})", "15c")
        parse_slo_spec(self.effective_slo())


def _run_one(params, cfg, spec: SweepSpec, policy_name: str,
             timed: List[TimedRequest],
             server_kwargs: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """One (rung, policy) cell: fresh fleet, replayed trace, SLO rows."""
    clock = VirtualClock(tick_s=spec.tick_s, start=0.0)
    # sheds are recorded as extra traces, so size the ring for both
    recorder = TraceRecorder(max_completed=2 * len(timed) + 64)
    policy = make_policy(policy_name)
    injector = (ServingFaultInjector(spec.chaos_spec)
                if spec.chaos_spec else None)
    factory = default_server_factory(
        params, cfg, n_slots=spec.n_slots,
        prefix_cache_mb=spec.prefix_cache_mb,
        admission_policy=policy, **(server_kwargs or {}))
    supervisor = ReplicaSupervisor(
        factory, n_replicas=spec.n_replicas, clock=clock,
        injector=injector)
    router = Router(
        supervisor, trace_recorder=recorder, admission_policy=policy,
        shed_watermark=spec.shed_watermark)
    if hasattr(policy, "bind"):
        # health-aware admission reads live fleet state through the
        # signals seam; binding after the router exists closes the loop
        policy.bind(FleetSignalsView(router))

    handles: Dict[str, Any] = {}
    shed: Dict[str, str] = {}
    i = 0
    rounds = 0
    in_flight = True
    while i < len(timed) or in_flight:
        now = clock.now()
        while i < len(timed) and timed[i].t <= now:
            tr = timed[i]
            try:
                handles[tr.request_id] = router.submit(tr.to_request())
            except ShedError as e:
                shed[tr.request_id] = e.reason
            i += 1
        in_flight = router.step()
        rounds += 1
        if not in_flight and i < len(timed) and timed[i].t > clock.now():
            # fleet idle until the next arrival: fast-forward instead of
            # spinning one tick at a time
            clock.advance(timed[i].t - clock.now())
        if rounds > spec.max_rounds:
            raise RuntimeError(
                f"sweep cell not drained after {spec.max_rounds} rounds "
                f"(policy={policy_name}, submitted={i}/{len(timed)})")

    summaries = {s["request_id"]: s
                 for s in recorder.completed_requests()}
    rows: List[Dict[str, Any]] = []
    counts = {"completed": 0, "shed": 0, "expired": 0, "errors": 0}
    tokens = 0
    deadline_total = deadline_hit = 0
    for tr in timed:
        if tr.request_id in shed:
            rows.append({"request_id": tr.request_id, "outcome": "shed",
                         "ttft_s": None, "itl_s": []})
            counts["shed"] += 1
            if tr.deadline_s is not None:
                deadline_total += 1
            continue
        fh = handles[tr.request_id]
        summary = summaries.get(fh.request_id)
        if summary is None:  # pragma: no cover - recorder ring overflow
            summary = {"request_id": fh.request_id,
                       "outcome": fh.finish_reason or "error",
                       "ttft_s": None, "itl_s": []}
        rows.append(summary)
        outcome = summary["outcome"]
        if outcome in ("length", "eos"):
            counts["completed"] += 1
        elif outcome == "deadline":
            counts["expired"] += 1
        else:
            counts["errors"] += 1
        tokens += len(fh.tokens)
        if tr.deadline_s is not None:
            deadline_total += 1
            if outcome in ("length", "eos"):
                deadline_hit += 1
    cell = {
        "slo": evaluate_slos(rows, parse_slo_spec(spec.effective_slo())),
        "deadline_hit_rate": (
            (deadline_hit / deadline_total) if deadline_total else None),
        "deadline_requests": deadline_total,
        # requests a crash re-routed (their summaries carry recovery_s:
        # fault observed -> first token from the replacement replica)
        "recovered": sum(1 for row in rows
                         if row.get("recovery_s") is not None),
        "completed": counts["completed"],
        "shed": counts["shed"],
        "expired": counts["expired"],
        "errors": counts["errors"],
        "tokens": tokens,
        "rounds": rounds,
        "virtual_duration_s": clock.now(),
    }
    cell["cost"] = cost_from_cell(cell)
    return cell


def run_sweep(params, cfg, spec: SweepSpec,
              mix: Optional[WorkloadMix] = None,
              server_kwargs: Optional[Dict[str, Any]] = None,
              ) -> Dict[str, Any]:
    """Run the full ladder x policy grid; returns a validated
    mingpt-traffic/1 report dict (see report.py for the shape).
    ``server_kwargs`` reach every replica's ``InferenceServer`` (``device``
    among them)."""
    spec.validate()
    if mix is None:
        mix = default_mix(vocab_size=cfg.vocab_size,
                          block_size=cfg.block_size)
    mix.validate()
    base = parse_arrival_spec(spec.arrival)
    objectives = parse_slo_spec(spec.effective_slo())
    knee_objective = (spec.knee_objective if spec.knee_objective
                      else objectives[0].name)
    if knee_objective not in {o.name for o in objectives}:
        raise ValueError(
            f"knee objective {knee_objective!r} not in SLO spec "
            f"{spec.slo!r}")
    # one column per policy: "static" cells keep the bare policy name
    labels = list(spec.policies)
    rungs: List[Dict[str, Any]] = []
    for rung_idx, factor in enumerate(spec.ladder):
        scaled = base.scaled(factor)
        times = arrival_times(scaled, spec.n_requests, spec.seed)
        # rendering draws from an RNG keyed by (seed, mix) only, so
        # every rung offers the SAME request bodies, just faster
        timed = mix.render(times, spec.seed)
        cells = {policy: _run_one(params, cfg, spec, policy, timed, server_kwargs)
                 for policy in labels}
        rungs.append({
            "rung": rung_idx,
            "load_factor": float(factor),
            "offered_rate": float(scaled.mean_rate()),
            "n_requests": len(timed),
            "trace_sha256": trace_digest(timed),
            "policies": cells,
        })
    report: Dict[str, Any] = {
        "schema": TRAFFIC_SCHEMA,
        "seed": spec.seed,
        "arrival": spec_to_json(base),
        "mix": mix.to_json(),
        "slo_spec": spec.effective_slo(),
        "knee_objective": knee_objective,
        "chaos_spec": spec.chaos_spec,
        "net_chaos_spec": spec.net_chaos_spec,
        "fleet": {"n_replicas": spec.n_replicas, "n_slots": spec.n_slots,
                  "tick_s": spec.tick_s, "n_hosts": spec.n_hosts},
        "ladder": [float(f) for f in spec.ladder],
        "controllers": list(spec.controllers),
        "policies": labels,
        "rungs": rungs,
    }
    report["knees"] = locate_knees(rungs, labels)
    report["knee"] = headline_knee(report)
    validate_traffic_report(report, strict=True)
    return report
