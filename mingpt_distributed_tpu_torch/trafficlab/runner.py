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

Network chaos is a second axis: ``n_hosts > 1`` runs every cell on the
loopback cross-host mesh (``build_loopback_fleet``: a CrossHostRouter over
per-host ProcessSupervisors, all on the cell's VirtualClock), and
``net_chaos_spec`` drives the shared ``NetworkFaultInjector``
(``partition`` / ``drop_frame`` / ``slow_link`` / ``host_kill``). Cross-host
failover rows carry the same per-request ``recovery_s`` the thread fleet's
rows do, so ``recovery_slo_s`` grades a partition's failovers as it grades a
crash's re-routes, and the sweep stays byte-replayable, partitions
included.

The controller axis: each entry of ``controllers`` is ``"static"`` (no
control loop) or an ``auto[:k=v...]`` SLO-autoscaler spec. Every policy runs
once per controller on the identical rung trace; an autoscaled cell hangs an
``SLOAutoscaler`` off its router (the control tick rides ``router.step()``,
so the closed loop replays byte-identically on the cell's VirtualClock), is
labelled ``policy+auto`` and carries a ``control`` block (spec, ticks,
actions, the replicas left and the sha256 of its ``mingpt-control/1`` log).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Tuple

# control submodules are imported directly (never ``control/__init__``):
# the package pulls in the trace importer, which imports
# trafficlab.arrivals — going through it from here would be a cycle
from mingpt_distributed_tpu_torch.control.controller import (
    SLOAutoscaler,
    parse_controller_spec,
)
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
from mingpt_distributed_tpu_torch.training.faults import (
    NetworkFaultInjector,
    ServingFaultInjector,
)

__all__ = [
    "SweepSpec",
    "run_sweep",
]


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
    #: the cross-host axis: > 1 runs every cell on the loopback host mesh
    #: (n_replicas becomes per host), where network chaos and quorum sheds
    #: exist
    n_hosts: int = 1
    #: NetworkFaultInjector grammar (partition / drop_frame / slow_link /
    #: host_kill); needs n_hosts > 1
    net_chaos_spec: Optional[str] = None
    heartbeat_interval_s: float = 0.05
    #: the controller axis: each entry is ``"static"`` (no control loop) or
    #: an ``auto[:k=v...]`` SLOAutoscaler spec; autoscaled cells are
    #: labelled ``policy+auto``
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
        if self.net_chaos_spec:
            # checks the op vocabulary (partition/drop_frame/...)
            NetworkFaultInjector(self.net_chaos_spec)
            if self.n_hosts < 2:
                raise ValueError(
                    "net_chaos_spec needs a mesh: set n_hosts >= 2 (network "
                    "faults have no single-host fault point)")
        if self.n_hosts > 1:
            if self.chaos_spec:
                raise ValueError(
                    "chaos_spec (ServingFaultInjector) is the thread-fleet "
                    "axis; on a host mesh use net_chaos_spec")
            if self.shed_watermark is not None:
                raise ValueError(
                    "shed_watermark is a single-host Router knob; the host "
                    "mesh sheds on lost quorum instead")
        if self.heartbeat_interval_s <= 0:
            raise ValueError(f"heartbeat_interval_s must be > 0, got "
                             f"{self.heartbeat_interval_s}")
        if not self.controllers or (
                len(set(self.controllers)) != len(self.controllers)):
            raise ValueError(f"bad controller list {self.controllers}")
        for ctrl in self.controllers:
            if (parse_controller_spec(ctrl) is not None
                    and self.n_hosts > 1):
                raise ValueError(
                    "autoscaled cells actuate the thread fleet's "
                    "router/supervisor seams; on a host mesh use "
                    "controllers=('static',)")
        parse_slo_spec(self.effective_slo())


def _run_one_crosshost(params, cfg, spec: SweepSpec, policy_name: str,
                       timed: List[TimedRequest],
                       server_kwargs: Optional[Dict[str, Any]],
                       ) -> Dict[str, Any]:
    """One cross-host (rung, policy) cell: the identical open-loop
    drive, but against a fresh loopback host mesh under network chaos.
    Rows are built from the CrossHandles (TTFT from the handle's first
    caller-visible token, ITL from per-token clock stamps collected at
    the frontend's on_token hook — the fence means a token is stamped
    exactly once), so a failed-over request's ``recovery_s`` grades the
    recovery-tail objective just like a thread-fleet crash row."""
    from mingpt_distributed_tpu_torch.serving.procfleet.hostplane import (
        build_loopback_fleet,
    )

    clock = VirtualClock(tick_s=spec.tick_s, start=0.0)
    policy = make_policy(policy_name)
    token_times: Dict[str, List[float]] = {}
    frontend, _agents, _net = build_loopback_fleet(
        params, cfg, n_hosts=spec.n_hosts, n_replicas=spec.n_replicas,
        clock=clock, net_faults=spec.net_chaos_spec or "",
        heartbeat_interval_s=spec.heartbeat_interval_s,
        server_kwargs=dict(n_slots=spec.n_slots,
                           prefix_cache_mb=spec.prefix_cache_mb,
                           admission_policy=policy,
                           **(server_kwargs or {})),
        on_token=lambda c, _t: token_times.setdefault(
            c.request_id, []).append(clock.now()))

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
                handles[tr.request_id] = frontend.submit(tr.to_request())
            except ShedError as e:
                shed[tr.request_id] = e.reason
            i += 1
        in_flight = frontend.step()
        rounds += 1
        if not in_flight and i < len(timed) and timed[i].t > clock.now():
            clock.advance(timed[i].t - clock.now())
        if rounds > spec.max_rounds:
            raise RuntimeError(
                f"cross-host sweep cell not drained after "
                f"{spec.max_rounds} rounds (policy={policy_name}, "
                f"submitted={i}/{len(timed)})")

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
        cross = handles[tr.request_id]
        outcome = cross.finish_reason or "error"
        stamps = token_times.get(cross.request_id, [])
        row = {
            "request_id": cross.request_id,
            "outcome": outcome,
            "ttft_s": (None if cross.first_token_time is None
                       else cross.first_token_time - cross.submit_time),
            "itl_s": [b - a for a, b in zip(stamps, stamps[1:])],
        }
        if cross.recovery_s is not None:
            row["recovery_s"] = cross.recovery_s
        rows.append(row)
        if outcome in ("length", "eos"):
            counts["completed"] += 1
        elif outcome == "deadline":
            counts["expired"] += 1
        else:
            counts["errors"] += 1
        tokens += len(cross.tokens)
        if tr.deadline_s is not None:
            deadline_total += 1
            if outcome in ("length", "eos"):
                deadline_hit += 1
    cell = {
        "slo": evaluate_slos(rows, parse_slo_spec(spec.effective_slo())),
        "deadline_hit_rate": (
            (deadline_hit / deadline_total) if deadline_total else None),
        "deadline_requests": deadline_total,
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


def _run_one(params, cfg, spec: SweepSpec, policy_name: str,
             timed: List[TimedRequest],
             server_kwargs: Optional[Dict[str, Any]],
             controller_spec: Optional[str] = None,
             control_sink: Optional[Callable[[str], None]] = None,
             ) -> Dict[str, Any]:
    """One (rung, policy, controller) cell: fresh fleet, replayed trace, SLO
    rows; with an ``auto:`` ``controller_spec``, an :class:`SLOAutoscaler`
    attached to the router, whose log goes to ``control_sink``."""
    if spec.n_hosts > 1:
        return _run_one_crosshost(params, cfg, spec, policy_name, timed,
                                  server_kwargs)
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
    controller = None
    if controller_spec is not None:
        ccfg = parse_controller_spec(controller_spec)
        if ccfg is not None:
            controller = SLOAutoscaler(router, ccfg)
            router.controller = controller

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
    if controller is not None:
        log_text = controller.render_log()
        cell["control"] = {
            "spec": controller_spec,
            "ticks": controller.tick,
            "actions": controller.action_counts(),
            "final_replicas": sum(
                1 for rep in supervisor.replicas
                if rep.state != "drained" and not rep.draining),
            "log_sha256": hashlib.sha256(log_text.encode("utf-8")).hexdigest(),
        }
        if control_sink is not None:
            control_sink(log_text)
    return cell


def _cell_plan(spec: SweepSpec) -> List[Tuple[str, str, Optional[str]]]:
    """``(label, policy, controller_spec_or_None)`` per cell, policy-major.
    "static" keeps the bare policy name; auto controllers suffix ``+auto``
    (indexed when there are several)."""
    auto_specs = [c for c in spec.controllers
                  if parse_controller_spec(c) is not None]
    plan: List[Tuple[str, str, Optional[str]]] = []
    for policy in spec.policies:
        for ctrl in spec.controllers:
            if parse_controller_spec(ctrl) is None:
                plan.append((policy, policy, None))
            else:
                suffix = ("auto" if len(auto_specs) == 1
                          else f"auto{auto_specs.index(ctrl)}")
                plan.append((f"{policy}+{suffix}", policy, ctrl))
    return plan


def run_sweep(params, cfg, spec: SweepSpec,
              mix: Optional[WorkloadMix] = None,
              server_kwargs: Optional[Dict[str, Any]] = None,
              control_log_sink: Optional[
                  Callable[[int, str, str], None]] = None,
              ) -> Dict[str, Any]:
    """Run the full ladder x policy x controller grid; returns a validated
    mingpt-traffic/1 report dict (see report.py for the shape).
    ``server_kwargs`` reach every replica's ``InferenceServer`` (``device``
    among them). ``control_log_sink(rung_index, cell_label, log_text)``
    receives each autoscaled cell's whole mingpt-control/1 document; the
    report carries only its sha256."""
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
    plan = _cell_plan(spec)
    labels = [label for label, _, _ in plan]
    rungs: List[Dict[str, Any]] = []
    for rung_idx, factor in enumerate(spec.ladder):
        scaled = base.scaled(factor)
        times = arrival_times(scaled, spec.n_requests, spec.seed)
        # rendering draws from an RNG keyed by (seed, mix) only, so
        # every rung offers the SAME request bodies, just faster
        timed = mix.render(times, spec.seed)
        cells = {}
        for label, policy, ctrl in plan:
            sink = None
            if control_log_sink is not None and ctrl is not None:
                sink = (lambda text, r=rung_idx, lb=label:
                        control_log_sink(r, lb, text))
            cells[label] = _run_one(params, cfg, spec, policy, timed,
                                    server_kwargs, controller_spec=ctrl,
                                    control_sink=sink)
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
