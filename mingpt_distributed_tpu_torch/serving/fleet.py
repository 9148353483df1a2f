"""The in-process serving fleet: supervised replicas behind a router.

Counterpart of ``mingpt_distributed_tpu/serving/fleet.py``. One
``InferenceServer`` is one failure domain: a crash loses every accepted
request and an overload stalls all of them. The fleet puts N replicas on
one device (each a full ``InferenceServer``: its own engine, KV pool,
prefix store and private metrics, all sharing one parameter tree) behind:

* :class:`ReplicaSupervisor` — owns N :class:`Replica` wrappers. A crashed
  replica's server is **never reused** (its host-side slot state may be
  mid-update): it is dropped, its KV pool, prefix store and draft engine
  freed, and a fresh server spawned after a backoff, within a bounded
  restart budget.
* :meth:`Replica.health` — readiness from the telemetry the replica already
  exports: crashed, queue depth over the watermark, ITL p99 over the SLO
  (the histogram's ladder quantile), post-warmup new shapes counted by
  the watchdog.
* :class:`Router` — fans requests out across replicas: prefix affinity
  (CRC32 of the prompt's head, so shared-prefix tenants land where the
  ``PrefixKVStore`` holds their rows), healthy replicas before degraded
  ones, least loaded within a tier; a :class:`CircuitBreaker` per replica
  with half-open probing; bounded retry with backoff of crashed or failed
  requests onto survivors; watermark, breaker and deadline shedding;
  graceful drain.

**Retries are idempotent.** A retried request is submitted again from its
ORIGINAL prompt, never from partial KV state, and the scheduler's
determinism (a greedy request's tokens depend only on params, prompt,
sampling parameters and seed, never on co-tenants) regenerates the same
token at every index. The router's emitter dedups by token index: indices
already streamed are dropped (counted in
``mingpt_fleet_duplicate_tokens_suppressed_total``), so the caller's stream
is append-only and token-identical to solo ``generate()`` however often the
request bounced. The scheduler's chaos fault point sits after the decode
step and before emission, so a replica failing mid-round loses computed
tokens and never streams them twice.

**Time.** The whole fleet runs on an injected clock. Chaos tests and
``serve --selftest-chaos`` use :class:`VirtualClock` (one tick per router
round, no wall-clock read, no sleep); an injected ``slow`` fault skews one
replica's :class:`SkewedClock`, which inflates its observed ITL and trips
the health gate while nobody sleeps. Live serving uses :class:`WallClock`,
the one reader of the wall clock in this module. Backoffs, breaker windows
and deadlines are all in the active clock's seconds; attribution's CUDA
event seconds stay out of it.

**Exceptions.** A replica round that raises :class:`ReplicaCrashed` is a
crash (breaker tripped, replica respawned, victims retried); a
``LockstepError`` (a tensor-parallel replica's group lost a rank) leaves the
router at once; any other exception is a step failure that costs a breaker
failure. Nothing moves
work to the CPU: a replica runs where its factory put it.

Exit code 75 (``REQUEUE_EXIT_CODE``) is the trainer's preemption code:
``serve`` exits with it after a SIGTERM-triggered drain. The process fleet
(``procfleet/``) re-bases this machinery onto worker processes with live
migration; the autoscaler that calls ``spawn_replica``/``retire_replica``
is ``control/controller.py``.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from mingpt_distributed_tpu_torch.serving.admission import AdmissionPolicy
from mingpt_distributed_tpu_torch.serving.lockstep import LockstepError
from mingpt_distributed_tpu_torch.serving.requests import (
    QueueFullError,
    Request,
    RequestHandle,
    ShedError,
)
from mingpt_distributed_tpu_torch.serving.scheduler import InferenceServer
from mingpt_distributed_tpu_torch.telemetry import (
    MetricsRegistry,
    render_fleet_prometheus,
    render_prometheus,
)
from mingpt_distributed_tpu_torch.telemetry.flightrec import FlightRecorder
from mingpt_distributed_tpu_torch.telemetry.tracing import (
    TraceContext,
    TraceRecorder,
    trace_baggage,
)
from mingpt_distributed_tpu_torch.training.faults import (
    InjectedAdmissionError,
    ReplicaCrashed,
    ServingFaultInjector,
)

#: Same convention as trainer.py (EX_TEMPFAIL): "requeue me, don't fail
#: me" — defined locally so the serving path never imports the trainer.
REQUEUE_EXIT_CODE = 75

__all__ = [
    "CircuitBreaker",
    "FleetHandle",
    "REQUEUE_EXIT_CODE",
    "Replica",
    "ReplicaHealth",
    "ReplicaSupervisor",
    "Router",
    "SkewedClock",
    "VirtualClock",
    "WallClock",
    "default_server_factory",
]


# ---------------------------------------------------------------------
# Clocks
# ---------------------------------------------------------------------

class VirtualClock:
    """Deterministic fleet time: advances only when told to. The router
    calls ``tick()`` once per scheduling round, so backoffs / breaker
    reset windows / deadlines are measured in rounds × ``tick_s`` and a
    chaos run is bit-reproducible with zero wall sleeps."""

    def __init__(self, tick_s: float = 0.001, start: float = 0.0):
        self.tick_s = tick_s
        self.t = start

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt

    def tick(self) -> None:
        self.t += self.tick_s


class WallClock:
    """Real time, same surface as VirtualClock (tick/advance are no-ops
    — wall time advances itself)."""

    def now(self) -> float:
        return time.perf_counter()

    def advance(self, dt: float) -> None:
        pass

    def tick(self) -> None:
        pass


class SkewedClock:
    """A replica's view of fleet time: base clock + accumulated skew.
    An injected "slow" fault adds its virtual delay to ``skew_s``, so the
    replica *observes* inflated latencies (ITL p99 crosses the SLO, the
    health gate fires) while the test harness never sleeps. Monotonic as
    long as skew only grows."""

    def __init__(self, base: Callable[[], float]):
        self.base = base
        self.skew_s = 0.0

    def __call__(self) -> float:
        return self.base() + self.skew_s


# ---------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------

class CircuitBreaker:
    """Per-replica admission gate. States (the gauge encoding in
    ``mingpt_fleet_breaker_state{replica}``):

    * ``CLOSED`` (0) — admitting; ``failure_threshold`` consecutive
      failures open it.
    * ``OPEN`` (2) — refusing; after ``reset_after_s`` the next
      ``allow()`` moves to half-open.
    * ``HALF_OPEN`` (1) — exactly one probe request may enter
      (``start_probe()``); its success closes the breaker, any failure
      while half-open re-opens immediately.
    """

    CLOSED, HALF_OPEN, OPEN = 0, 1, 2

    def __init__(
        self,
        clock: Callable[[], float],
        failure_threshold: int = 3,
        reset_after_s: float = 1.0,
    ):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.clock = clock
        self.failure_threshold = failure_threshold
        self.reset_after_s = reset_after_s
        self.state = self.CLOSED
        self.failures = 0
        self.opened_at: Optional[float] = None
        self._probe_out = False

    def allow(self) -> bool:
        if self.state == self.OPEN:
            if self.clock() - (self.opened_at or 0.0) >= self.reset_after_s:
                self.state = self.HALF_OPEN
                self._probe_out = False
            else:
                return False
        if self.state == self.HALF_OPEN:
            return not self._probe_out
        return True

    def start_probe(self) -> None:
        """The caller routed a request through a half-open breaker — no
        further requests until its verdict lands."""
        if self.state == self.HALF_OPEN:
            self._probe_out = True

    def record_success(self) -> None:
        self.state = self.CLOSED
        self.failures = 0
        self._probe_out = False

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == self.HALF_OPEN or self.failures >= self.failure_threshold:
            self._open()

    def trip(self) -> None:
        """Immediate open — a crash is not a 'failure budget' event."""
        self._open()

    def reset_to_probe(self) -> None:
        """A restarted replica goes straight to half-open: one probe
        verifies the fresh server before full traffic returns."""
        self.state = self.HALF_OPEN
        self.failures = 0
        self._probe_out = False

    def _open(self) -> None:
        self.state = self.OPEN
        self.opened_at = self.clock()
        self._probe_out = False


# ---------------------------------------------------------------------
# Replica + supervisor
# ---------------------------------------------------------------------

@dataclass
class ReplicaHealth:
    ready: bool
    reasons: List[str] = field(default_factory=list)


class Replica:
    """One supervised ``InferenceServer`` with its own skewed clock and
    the injector's fault points wired into its lifecycle."""

    #: control-plane scale-down flag: a draining replica keeps stepping
    #: (its in-flight streams finish in place — never re-routed) but the
    #: router stops placing new work on it; once idle the controller
    #: retires it through ``ReplicaSupervisor.retire_replica``
    draining = False

    def __init__(
        self,
        name: str,
        index: int,
        server_factory: Callable[..., InferenceServer],
        fleet_clock,
        injector: Optional[ServingFaultInjector] = None,
        queue_high_watermark: int = 8,
        itl_slo_s: Optional[float] = None,
    ):
        self.name = name
        self.index = index
        self._factory = server_factory
        self.clock = SkewedClock(fleet_clock.now)
        self.injector = injector
        self.queue_high_watermark = queue_high_watermark
        self.itl_slo_s = itl_slo_s
        self.state = "ready"          # "ready" | "crashed"
        self.crashes = 0
        self.crashed_at: Optional[float] = None  # fleet-clock crash time
        self.last_spawn_path = "cold"            # "cold" | "standby" (procfleet)
        self.server: InferenceServer = self._spawn()

    def _spawn(self) -> InferenceServer:
        hook = (self.injector.round_hook(self.name)
                if self.injector is not None else None)
        return self._factory(name=self.name, clock=self.clock,
                             fault_hook=hook)

    def respawn(self) -> None:
        """Replace the crashed server with a fresh one. The old object —
        engine, KV pool, prefix store, draft engine, slot table — is
        dropped, never reused: a crash mid-round may have left host-side
        slot state half-updated. It is freed before the new server
        allocates (the server's bound methods in its watchdog make a
        reference cycle, which only the collector breaks), so the device
        holds one pool per replica across a restart, not two."""
        self.server = None
        gc.collect()
        self.server = self._spawn()
        self.state = "ready"
        self.draining = False

    def submit(self, request: Request) -> RequestHandle:
        if self.injector is not None:
            self.injector.check_admit(self.name)
        return self.server.submit(request)

    def step(self) -> bool:
        if self.injector is not None:
            # may raise ReplicaCrashed; a "slow" fault lands as clock
            # skew — this replica observes the delay, nobody sleeps it
            self.clock.skew_s += self.injector.step_delay(self.name)
        return self.server.step()

    @property
    def load(self) -> int:
        return len(self.server.queue) + self.server.slots.occupied

    def health(self) -> ReplicaHealth:
        """Readiness from signals the replica already exports — the same
        numbers a /healthz endpoint would gate on."""
        reasons: List[str] = []
        if self.state == "drained":
            return ReplicaHealth(False, ["drained"])
        if self.state != "ready":
            reasons.append("crashed")
            return ReplicaHealth(False, reasons)
        if self.draining:
            reasons.append("draining")
        if len(self.server.queue) > self.queue_high_watermark:
            reasons.append("queue_depth")
        if self.itl_slo_s is not None:
            p99 = self.server.metrics.itl_p99_s
            if p99 is not None and p99 > self.itl_slo_s:
                reasons.append("itl_p99")
        if self.server.watchdog.recompiles > 0:
            reasons.append("recompiles")
        return ReplicaHealth(not reasons, reasons)


class ReplicaSupervisor:
    """Owns the replica set and the crash→backoff→respawn lifecycle.
    Restart policy: each crash schedules a respawn ``restart_backoff_s ×
    2^(restarts so far)`` in the future, up to ``max_restarts`` per
    replica; past the budget the replica stays down (flapping hardware
    should not be hammered forever)."""

    #: Replica wrapper class — a subclass swaps in a different isolation
    #: boundary (procfleet's ProcReplica) without copying the lifecycle.
    replica_cls = Replica

    def __init__(
        self,
        server_factory: Callable[..., InferenceServer],
        n_replicas: int = 2,
        clock=None,
        injector: Optional[ServingFaultInjector] = None,
        registry: Optional[MetricsRegistry] = None,
        max_restarts: int = 1,
        restart_backoff_s: float = 0.05,
        queue_high_watermark: int = 8,
        itl_slo_s: Optional[float] = None,
    ):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.clock = clock if clock is not None else VirtualClock()
        self.injector = injector
        self.registry = registry if registry is not None else MetricsRegistry()
        self.max_restarts = max_restarts
        self.restart_backoff_s = restart_backoff_s
        # kept for control-plane scale-up: spawn_replica builds late
        # replicas with the same factory/health gates as the first N
        self._server_factory = server_factory
        self.queue_high_watermark = queue_high_watermark
        self.itl_slo_s = itl_slo_s
        self._next_index = n_replicas
        self.replicas = [
            self.replica_cls(
                f"replica{i}", i, server_factory, self.clock, injector,
                queue_high_watermark=queue_high_watermark,
                itl_slo_s=itl_slo_s)
            for i in range(n_replicas)
        ]
        r = self.registry
        self._up = r.gauge(
            "mingpt_fleet_replica_up",
            help="1 while the replica's server is alive (0 = crashed, "
                 "awaiting restart or out of restart budget)",
            labels=("replica",))
        self._healthy = r.gauge(
            "mingpt_fleet_replica_healthy",
            help="1 while up AND passing every health gate (queue depth, "
                 "ITL p99 SLO, recompile watchdog)",
            labels=("replica",))
        self._crashes = r.counter(
            "mingpt_fleet_crashes_total",
            help="replica crashes observed by the supervisor",
            labels=("replica",))
        self._restarts = r.counter(
            "mingpt_fleet_restarts_total",
            help="fresh servers spawned to replace crashed ones",
            labels=("replica",))
        self._recovery = r.histogram(
            "mingpt_fleet_recovery_seconds",
            help="crash -> replacement-serving time per respawn, by "
                 "path: cold = spawn a fresh server (or worker), standby "
                 "= adopt a warm spare (procfleet)",
            labels=("path",))
        for rep in self.replicas:
            self._up.labels(replica=rep.name).set(1)
            self._healthy.labels(replica=rep.name).set(1)
            self._crashes.labels(replica=rep.name).inc(0)
            self._restarts.labels(replica=rep.name).inc(0)
        self._restart_due: Dict[str, float] = {}
        self._restarts_used: Dict[str, int] = {}
        #: respawn post-mortems in crash order: {replica, path,
        #: recovery_s, adopted}
        self.recovery_log: List[Dict] = []
        self.last_recovery: Dict[str, Dict] = {}

    def replica_by_name(self, name: str) -> Optional[Replica]:
        for rep in self.replicas:
            if rep.name == name:
                return rep
        return None

    def mark_crashed(self, replica: Replica) -> None:
        replica.state = "crashed"
        replica.crashes += 1
        replica.crashed_at = self.clock.now()
        self._crashes.labels(replica=replica.name).inc()
        self._up.labels(replica=replica.name).set(0)
        used = self._restarts_used.get(replica.name, 0)
        if used < self.max_restarts:
            self._restart_due[replica.name] = (
                self.clock.now() + self.restart_backoff_s * (2 ** used))

    def restarts_scheduled(self) -> bool:
        return bool(self._restart_due)

    def poll_restarts(self) -> List[Replica]:
        """Respawn every replica whose backoff elapsed; returns them so
        the router can rewire streaming + move breakers to half-open."""
        now = self.clock.now()
        restarted: List[Replica] = []
        for name, due in sorted(self._restart_due.items()):
            if now < due:
                continue
            del self._restart_due[name]
            rep = self.replica_by_name(name)
            assert rep is not None
            self._restarts_used[name] = self._restarts_used.get(name, 0) + 1
            rep.respawn()
            self._restarts.labels(replica=name).inc()
            self._up.labels(replica=name).set(1)
            if rep.crashed_at is not None:
                rec_s = max(0.0, self.clock.now() - rep.crashed_at)
                path = rep.last_spawn_path
                self._recovery.labels(path=path).observe(rec_s)
                info = {"replica": name, "path": path,
                        "recovery_s": rec_s,
                        "adopted": getattr(rep, "adopted_name", None)}
                self.recovery_log.append(info)
                self.last_recovery[name] = info
                rep.crashed_at = None
            restarted.append(rep)
        return restarted

    def poll_liveness(self) -> List[Tuple[str, str]]:
        """Hang-escalation hook: (replica, signal) pairs escalated this
        poll. The in-process fleet has no process to signal — a hung
        thread replica cannot exist on the cooperative scheduler — so
        this supervisor never escalates; procfleet's ProcessSupervisor
        overrides this with the SIGTERM→SIGKILL liveness ladder."""
        return []

    # -- control-plane actuation (the autoscaler's) -----------------------
    def _make_replica(self, name: str, index: int) -> Replica:
        """Construction hook for late (scale-up) replicas: a subclass
        pre-configures its isolation wiring here, before the first
        spawn."""
        return self.replica_cls(
            name, index, self._server_factory, self.clock, self.injector,
            queue_high_watermark=self.queue_high_watermark,
            itl_slo_s=self.itl_slo_s)

    def spawn_replica(self) -> Replica:
        """Grow the fleet by one replica (controller scale-up). Indices
        never recycle — a drained replica's name stays retired — and the
        newcomer gets the same per-replica gauge/counter initialisation
        as the construction-time set."""
        idx = self._next_index
        self._next_index += 1
        rep = self._make_replica(f"replica{idx}", idx)
        self.replicas.append(rep)
        self._up.labels(replica=rep.name).set(1)
        self._healthy.labels(replica=rep.name).set(1)
        self._crashes.labels(replica=rep.name).inc(0)
        self._restarts.labels(replica=rep.name).inc(0)
        return rep

    def retire_replica(self, replica: Replica) -> None:
        """Terminal, graceful exit (controller scale-down, post-drain):
        the replica leaves the routable set for good — no restart is
        scheduled and its gauges read down. The in-process fleet has no
        process to reap."""
        replica.state = "drained"
        self._restart_due.pop(replica.name, None)
        self._up.labels(replica=replica.name).set(0)
        self._healthy.labels(replica=replica.name).set(0)

    def recovery_info(self, name: str) -> Optional[Dict]:
        """The most recent respawn post-mortem for ``name`` (None before
        its first recovery) — the router stamps ``failover`` trace
        events from this."""
        return self.last_recovery.get(name)

    def refresh_health_gauges(self) -> None:
        for rep in self.replicas:
            self._up.labels(replica=rep.name).set(
                1.0 if rep.state == "ready" else 0.0)
            self._healthy.labels(replica=rep.name).set(
                1.0 if rep.health().ready else 0.0)

    def ready_replicas(self) -> List[Replica]:
        return [r for r in self.replicas if r.state == "ready"]


def default_server_factory(params, cfg, meshes=None, **server_kwargs):
    """Factory the supervisor calls per replica (and per respawn). Every
    replica, respawns included, gets the SAME ``params`` tree (the engine
    keeps a reference: nothing is copied or recast, so a card holds the
    weights once however many replicas serve them) and a PRIVATE metrics
    registry — N replicas re-registering ``mingpt_serve_*`` in one registry
    would alias their counters; the fleet-level families below live in the
    shared registry instead. ``server_kwargs`` go to every
    ``InferenceServer`` (``device`` among them).

    ``meshes`` ({replica name: serving mesh}) makes each replica a tensor-
    parallel server on its own lockstep group: a group runs one server at
    a time (a build replaces its followers' engines), so replicas never
    share one, and a respawn rebuilds the followers' engines with it."""

    def make(name: str, clock, fault_hook) -> InferenceServer:
        kw = dict(server_kwargs)
        if meshes is not None:
            if name not in meshes:
                raise ValueError(f"no tp group for {name}: meshes name "
                                 f"{sorted(meshes)}")
            kw["mesh"] = meshes[name]
        return InferenceServer(
            params, cfg, clock=clock, fault_hook=fault_hook, **kw)

    return make


# ---------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------

@dataclass
class FleetHandle:
    """Replica-independent view of one routed request. ``tokens`` is the
    caller-visible stream: append-only, deduped across retries."""

    request: Request
    request_id: str
    submit_time: float = 0.0
    deadline: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    finished: bool = False
    finish_reason: Optional[str] = None  # "length" | "eos" | "deadline" | "error"
    error: Optional[BaseException] = None
    attempts: int = 0                    # submissions so far (1 = no retry yet)
    replica: Optional[str] = None        # current / last placement
    duplicates_suppressed: int = 0       # re-emitted token indices dropped
    trace: Optional[TraceContext] = None  # the request's root trace context
    fault_at: Optional[float] = None     # fleet clock when a fault hit us
    recovery_s: Optional[float] = None   # fault -> first NEW token after it
    first_token_at: Optional[float] = None  # fleet clock at first emit (TTFT)


class Router:
    """Health- and affinity-aware request fan-out over a supervised
    replica set, with breakers, bounded retry, shedding and drain."""

    def __init__(
        self,
        supervisor: ReplicaSupervisor,
        on_token: Optional[Callable[[FleetHandle, int], None]] = None,
        affinity_len: int = 16,
        max_retries: int = 2,
        retry_backoff_s: float = 0.05,
        shed_watermark: Optional[int] = None,
        breaker_failure_threshold: int = 3,
        breaker_reset_s: float = 1.0,
        trace_recorder: Optional[TraceRecorder] = None,
        flight: Optional[FlightRecorder] = None,
        admission_policy: Optional[AdmissionPolicy] = None,
    ):
        self.supervisor = supervisor
        # admission ordering over the router's retry/pending queue.
        # None keeps the FIFO drain exactly; a
        # policy reorders only the entries whose backoff has elapsed.
        # Pass the SAME object to default_server_factory so replica-
        # level slot admission follows the same discipline.
        self.admission_policy = admission_policy
        self.clock = supervisor.clock
        self.on_token = on_token
        self.affinity_len = affinity_len
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.shed_watermark = shed_watermark
        # request-scoped tracing + flight recorder. The
        # router mints ONE trace per fleet request at submit; each
        # routed attempt is a fleet.attempt span whose child context
        # rides on the attempt Request into the replica scheduler.
        self.trace_recorder = trace_recorder
        self.flight = flight
        # control plane: an attached autoscaler gets one
        # on_round() per scheduling round; on_finish feeds its signal
        # windows one call per finished fleet request
        self.controller = None
        self.on_finish: Optional[Callable[[FleetHandle, str], None]] = None
        self.breaker_failure_threshold = breaker_failure_threshold
        self.breaker_reset_s = breaker_reset_s
        self._shed_ids = itertools.count()
        if flight is not None:
            # per-replica registry snapshots for crash dumps — lazy
            # closures over the Replica wrapper, so they keep working
            # after a respawn swaps rep.server
            for rep in supervisor.replicas:
                flight.metrics_providers.setdefault(
                    rep.name,
                    (lambda r=rep: render_prometheus(
                        r.server.metrics.registry)))
        self.breakers: Dict[str, CircuitBreaker] = {
            rep.name: CircuitBreaker(
                self.clock.now, breaker_failure_threshold, breaker_reset_s)
            for rep in supervisor.replicas
        }
        self._ids = itertools.count()
        # (replica_name, per-attempt request_id) -> (FleetHandle, RequestHandle)
        self._attempts: Dict[Tuple[str, str], Tuple[FleetHandle, RequestHandle]] = {}
        self._pending: Deque[Tuple[FleetHandle, float]] = deque()
        self.draining = False
        r = supervisor.registry
        self._rejected = r.counter(
            "mingpt_serving_rejected_total",
            help="refused admissions by reason (queue_full | shed | "
                 "breaker_open | deadline | draining)",
            labels=("reason",))
        for reason in ("queue_full", "shed", "breaker_open", "deadline",
                       "draining"):
            self._rejected.labels(reason=reason).inc(0)
        self._requests_total = r.counter(
            "mingpt_fleet_requests_total",
            help="routed requests by terminal outcome",
            labels=("outcome",))
        for outcome in ("completed", "deadline", "error"):
            self._requests_total.labels(outcome=outcome).inc(0)
        self._retries = r.counter(
            "mingpt_fleet_retries_total",
            help="re-submissions onto a surviving replica, by cause",
            labels=("reason",))
        for reason in ("crash", "admit", "error"):
            self._retries.labels(reason=reason).inc(0)
        self._routed = r.counter(
            "mingpt_fleet_routed_total",
            help="placements by affinity outcome (preferred = the prompt-"
                 "head hash replica; spilled = health/load moved it)",
            labels=("affinity",))
        for aff in ("preferred", "spilled"):
            self._routed.labels(affinity=aff).inc(0)
        self._breaker_gauge = r.gauge(
            "mingpt_fleet_breaker_state",
            help="circuit breaker per replica: 0 closed, 1 half-open, "
                 "2 open",
            labels=("replica",))
        self._queue_depth_g = r.gauge(
            "mingpt_fleet_queue_depth",
            help="requests waiting fleet-wide (router retry queue + "
                 "replica queues)")
        self._dup_suppressed = r.counter(
            "mingpt_fleet_duplicate_tokens_suppressed_total",
            help="token indices re-emitted by a retried attempt and "
                 "dropped by the dedup layer (the zero-double-emit "
                 "invariant at work)")
        self._step_failures = r.counter(
            "mingpt_fleet_step_failures_total",
            help="scheduling rounds that raised without killing the "
                 "replica (poisoned rounds; the round's tokens were "
                 "recomputed next round)",
            labels=("replica",))
        self._wire_streaming()
        self._update_gauges()

    # -- wiring ---------------------------------------------------------
    def _wire_streaming(self) -> None:
        for rep in self.supervisor.replicas:
            self._wire_replica(rep)

    def _wire_replica(self, rep: Replica) -> None:
        """Router-side hooks on a (possibly freshly respawned) replica
        server: streaming emitter, shared trace recorder, and the
        watchdog's recompile-triggered flight dump."""
        rep.server.on_token = self._make_emitter(rep.name)
        rep.server.trace_recorder = self.trace_recorder
        if self.flight is not None:
            rep.server.watchdog.on_recompile = (
                lambda grown, name=rep.name: self.flight.dump(
                    "watchdog_recompile", replica=name, families=grown))

    def add_replica(self, rep: Replica) -> None:
        """Wire a freshly spawned (scale-up) replica into the routing
        tier: breaker, streaming emitter + trace recorder, per-replica
        gauges, and the flight recorder's lazy metrics provider —
        everything ``__init__`` did for the construction-time set."""
        self.breakers[rep.name] = CircuitBreaker(
            self.clock.now, self.breaker_failure_threshold,
            self.breaker_reset_s)
        self._wire_replica(rep)
        if self.flight is not None:
            self.flight.metrics_providers.setdefault(
                rep.name,
                (lambda r=rep: render_prometheus(r.server.metrics.registry)))
        self._breaker_gauge.labels(replica=rep.name).set(
            CircuitBreaker.CLOSED)

    def shed_counts(self) -> Dict[str, int]:
        """Cumulative refused admissions by reason — the control
        plane's shed signal (same numbers ``summary()`` reports)."""
        return {labels["reason"]: int(child.value)
                for labels, child in self._rejected.children()}

    def _make_emitter(self, replica_name: str):
        def emit(rh: RequestHandle, token: int) -> None:
            entry = self._attempts.get((replica_name, rh.request_id))
            if entry is None:
                return
            fh, _ = entry
            idx = len(rh.tokens) - 1  # rh.tokens already holds this token
            if idx < len(fh.tokens):
                # a retried attempt re-deriving tokens the caller already
                # saw — greedy determinism makes them identical; drop them
                fh.duplicates_suppressed += 1
                self._dup_suppressed.inc()
                return
            fh.tokens.append(token)
            if fh.first_token_at is None:
                fh.first_token_at = self.clock.now()
            if fh.fault_at is not None:
                # first NEW caller-visible token since a fault hit this
                # request: the recovery tail the chaos sweeps grade
                # (recovery_pNN pools this per-request scalar)
                fh.recovery_s = self.clock.now() - fh.fault_at
                fh.fault_at = None
            # emit events on the FLEET clock, dedup-aware: only tokens
            # that actually reach the caller become events, so a trace's
            # emit count always equals the visible token count
            if self.trace_recorder is not None and fh.trace is not None:
                self.trace_recorder.add_event(
                    fh.trace, "emit", self.clock.now(),
                    token_index=len(fh.tokens) - 1, replica=replica_name)
            if self.on_token is not None:
                self.on_token(fh, token)
        return emit

    # -- placement -------------------------------------------------------
    def _affinity_index(self, prompt) -> int:
        head = np.asarray(list(prompt)[: self.affinity_len], np.uint32)
        return zlib.crc32(head.tobytes()) % len(self.supervisor.replicas)

    def _candidates(self, fh: FleetHandle) -> List[Replica]:
        """Breaker-admitted ready replicas: preferred (affinity) replica
        first when healthy, then healthy by load, then unhealthy-but-
        alive as the last-resort tier. Deterministic: stable sorts,
        index order breaks ties."""
        admitted = [rep for rep in self.supervisor.ready_replicas()
                    if not rep.draining
                    and self.breakers[rep.name].allow()]
        if not admitted:
            return []
        pref_idx = self._affinity_index(fh.request.prompt)
        healthy = [rep for rep in admitted if rep.health().ready]
        degraded = [rep for rep in admitted if not rep.health().ready]
        ordered: List[Replica] = []
        preferred = next((rep for rep in healthy if rep.index == pref_idx),
                         None)
        if preferred is not None:
            healthy.remove(preferred)
            ordered.append(preferred)
        ordered.extend(sorted(healthy, key=lambda rep: rep.load))
        ordered.extend(sorted(degraded, key=lambda rep: rep.load))
        return ordered

    def _attempt_request(self, fh: FleetHandle, rep: Replica) -> bool:
        now = self.clock.now()
        remaining: Optional[float] = None
        if fh.deadline is not None:
            remaining = fh.deadline - now
            if remaining <= 0:
                self._finalize(fh, "deadline")
                return True  # resolved (not placed) — stop trying
        fh.attempts += 1
        # each attempt is a span in the ONE per-request trace; the child
        # context rides on the attempt Request, so every span the
        # replica's scheduler records parents under this attempt
        attempt_ctx: Optional[TraceContext] = fh.trace
        if self.trace_recorder is not None and fh.trace is not None:
            attempt_ctx = self.trace_recorder.open_span(
                fh.trace, "fleet.attempt", now,
                attempt=fh.attempts, replica=rep.name)
        attempt_req = dataclasses.replace(
            fh.request,
            request_id=f"{fh.request_id}-a{fh.attempts}",
            deadline_s=remaining,
            trace=attempt_ctx,
        )
        breaker = self.breakers[rep.name]
        try:
            rh = rep.submit(attempt_req)
        except QueueFullError:
            fh.attempts -= 1  # a full queue is not a failed attempt
            if self.trace_recorder is not None and \
                    attempt_ctx is not fh.trace and attempt_ctx is not None:
                self.trace_recorder.cancel_span(attempt_ctx)
            return False
        except InjectedAdmissionError as e:
            fh.error = e
            if self.trace_recorder is not None and \
                    attempt_ctx is not fh.trace and attempt_ctx is not None:
                self.trace_recorder.close_span(
                    attempt_ctx, self.clock.now(), outcome="admit_error")
                self.trace_recorder.add_event(
                    fh.trace, "retry", self.clock.now(), reason="admit",
                    attempt=fh.attempts)
                self.trace_recorder.mark_forced(fh.trace)
            breaker.record_failure()
            self._retries.labels(reason="admit").inc()
            return False
        breaker.start_probe()
        self._attempts[(rep.name, attempt_req.request_id)] = (fh, rh)
        fh.replica = rep.name
        pref = self._affinity_index(fh.request.prompt) == rep.index
        self._routed.labels(
            affinity="preferred" if pref else "spilled").inc()
        return True

    def _try_route(self, fh: FleetHandle) -> bool:
        for rep in self._candidates(fh):
            if self._attempt_request(fh, rep):
                return True
        return False

    # -- admission -------------------------------------------------------
    def fleet_queue_depth(self) -> int:
        return len(self._pending) + sum(
            len(rep.server.queue) for rep in self.supervisor.ready_replicas())

    def _estimated_wait_s(self) -> float:
        """Backlog × observed mean ITL per ready replica — crude but
        monotone in load, which is all deadline shedding needs."""
        ready = self.supervisor.ready_replicas()
        itls = [rep.server.metrics.itl_mean_s for rep in ready
                if rep.server.metrics.itl_mean_s is not None]
        if not itls:
            return 0.0
        itl = sum(itls) / len(itls)
        return itl * (self.fleet_queue_depth() + 1) / max(1, len(ready))

    def submit(self, request: Request) -> FleetHandle:
        """Route one request. Raises :class:`ShedError` (draining, global
        watermark, unmeetable deadline, every breaker open) instead of
        accepting work the fleet cannot serve. If every candidate replica
        is merely queue-full, the request is accepted and parked in the
        router's retry queue — the global watermark, not per-replica
        queue bounds, is the fleet's admission limit."""
        request.validate()
        now = self.clock.now()
        if self.draining:
            self._rejected.labels(reason="draining").inc()
            self._trace_shed(request, "draining", now)
            raise ShedError("fleet is draining — not accepting new "
                            "requests", reason="draining")
        depth = self.fleet_queue_depth()
        if self.shed_watermark is not None and depth >= self.shed_watermark:
            self._rejected.labels(reason="shed").inc()
            self._trace_shed(request, "shed", now)
            raise ShedError(
                f"fleet queue depth {depth} >= watermark "
                f"{self.shed_watermark} — shedding",
                reason="shed",
                retry_after_s=self._estimated_wait_s() or 0.1)
        if request.deadline_s is not None:
            est = self._estimated_wait_s()
            if est > 0 and request.deadline_s <= est:
                self._rejected.labels(reason="deadline").inc()
                self._trace_shed(request, "deadline", now)
                raise ShedError(
                    f"deadline {request.deadline_s:.3f}s cannot be met: "
                    f"estimated queue wait {est:.3f}s — shedding now "
                    f"instead of expiring later",
                    reason="deadline",
                    retry_after_s=est)
        if not any(self.breakers[rep.name].allow()
                   for rep in self.supervisor.ready_replicas()
                   if not rep.draining):
            self._rejected.labels(reason="breaker_open").inc()
            self._trace_shed(request, "breaker_open", now)
            raise ShedError(
                "every replica's circuit breaker is open — shedding",
                reason="breaker_open",
                retry_after_s=min(
                    (b.reset_after_s for b in self.breakers.values()),
                    default=0.1))
        fh = FleetHandle(
            request=request,
            request_id=f"fleet-{next(self._ids)}",
            submit_time=now,
            deadline=(None if request.deadline_s is None
                      else now + request.deadline_s),
        )
        if self.trace_recorder is not None:
            fh.trace = self.trace_recorder.start_trace(
                fh.request_id, now=now, baggage=trace_baggage(request))
        if not self._try_route(fh):
            # every candidate was queue-full / errored: park for the next
            # round rather than dropping accepted work
            self._pending.append((fh, now + self.retry_backoff_s))
        return fh

    # -- failure handling ------------------------------------------------
    def _trace_shed(self, request: Request, reason: str,
                    now: float) -> None:
        """Shed decisions are traces too (always exported — trouble is
        never sampled away): a tiny trace with one shed event and an
        outcome of "shed"."""
        rec = self.trace_recorder
        if rec is None:
            return
        ctx = rec.start_trace(
            f"fleet-shed-{next(self._shed_ids)}", now=now,
            baggage=trace_baggage(request))
        rec.add_event(ctx, "shed", now, reason=reason)
        rec.end_trace(ctx, now=now, outcome="shed", n_tokens=0,
                      attempts=0, shed_reason=reason)

    def _finalize(self, fh: FleetHandle, reason: str) -> None:
        fh.finished = True
        fh.finish_reason = reason
        outcome = "completed" if reason in ("length", "eos") else reason
        self._requests_total.labels(outcome=outcome).inc()
        if self.on_finish is not None:
            self.on_finish(fh, outcome)
        if self.trace_recorder is not None and fh.trace is not None:
            attrs = {"replica": fh.replica,
                     "duplicates_suppressed": fh.duplicates_suppressed}
            if fh.recovery_s is not None:
                # only fault-touched requests carry the scalar, so an
                # undisturbed run's summaries stay byte-identical
                attrs["recovery_s"] = fh.recovery_s
            self.trace_recorder.end_trace(
                fh.trace, now=self.clock.now(), outcome=reason,
                n_tokens=len(fh.tokens), attempts=fh.attempts, **attrs)

    def _retry_or_fail(self, fh: FleetHandle, reason: str) -> None:
        if fh.attempts > self.max_retries:
            self._finalize(fh, "error")
            return
        self._retries.labels(reason=reason).inc()
        if self.trace_recorder is not None and fh.trace is not None:
            self.trace_recorder.add_event(
                fh.trace, "retry", self.clock.now(), reason=reason,
                attempt=fh.attempts)
            self.trace_recorder.mark_forced(fh.trace)
        backoff = self.retry_backoff_s * (2 ** max(0, fh.attempts - 1))
        self._pending.append((fh, self.clock.now() + backoff))

    def _close_attempt_span(self, fh: FleetHandle, rh: RequestHandle,
                            outcome: str) -> None:
        """Close the fleet.attempt span riding on this attempt's Request
        (must happen before the trace is ended)."""
        if self.trace_recorder is None:
            return
        ctx = rh.request.trace
        if ctx is not None and ctx is not fh.trace:
            self.trace_recorder.close_span(
                ctx, self.clock.now(), outcome=outcome)

    def _resolve_finished(self, replica_name: str, fh: FleetHandle,
                          rh: RequestHandle, crashed: bool) -> None:
        """A replica-level handle finished: translate to fleet outcome."""
        if fh.finished:
            return
        self._close_attempt_span(fh, rh, rh.finish_reason or "unknown")
        if rh.finish_reason in ("length", "eos"):
            fh.replica = replica_name
            self._finalize(fh, rh.finish_reason)
            if not crashed:
                self.breakers[replica_name].record_success()
        elif rh.finish_reason == "deadline":
            self._finalize(fh, "deadline")
        else:  # "error" — on_token raised or replica-internal failure
            fh.error = rh.error or fh.error
            self._retry_or_fail(fh, reason="error")

    def _handle_crash(self, rep: Replica, exc: BaseException) -> None:
        self.breakers[rep.name].trip()
        self.supervisor.mark_crashed(rep)
        victims: List[FleetHandle] = []
        for key in [k for k in self._attempts if k[0] == rep.name]:
            fh, rh = self._attempts.pop(key)
            if rh.finished:
                # retired earlier in this or a previous round — a real
                # completion, even though its server died afterwards
                self._resolve_finished(rep.name, fh, rh, crashed=True)
            elif not fh.finished:
                fh.error = exc
                fh.fault_at = self.clock.now()
                self._close_attempt_span(fh, rh, "crash")
                victims.append(fh)
        for fh in victims:
            self._retry_or_fail(fh, reason="crash")
        if self.flight is not None:
            self.flight.dump("crash", replica=rep.name, error=repr(exc),
                             victims=len(victims))

    def _handle_step_failure(self, rep: Replica, exc: BaseException) -> None:
        """A scheduling round raised without killing the replica (poison).
        Server state is consistent — the fault point sits before any
        per-slot mutation, so the next round recomputes the identical
        decode. Costs a breaker failure; repeated poison opens it."""
        self._step_failures.labels(replica=rep.name).inc()
        breaker = self.breakers[rep.name]
        was_open = breaker.state == CircuitBreaker.OPEN
        breaker.record_failure()
        if (self.flight is not None and not was_open
                and breaker.state == CircuitBreaker.OPEN):
            self.flight.dump("breaker_trip", replica=rep.name,
                             error=repr(exc))

    # -- the scheduling round ---------------------------------------------
    def step(self) -> bool:
        """One fleet round: restarts → re-route retries → step replicas →
        reconcile outcomes → gauges → clock tick. Returns True while any
        routed request is unfinished."""
        now = self.clock.now()
        for name, signal in self.supervisor.poll_liveness():
            # the ladder only SIGNALS the stuck process here; the death
            # is observed — and its requests re-routed — through the
            # ordinary crash path on the next step RPC
            if self.flight is not None:
                self.flight.dump("hang_escalation", replica=name,
                                 signal=signal)
        for rep in self.supervisor.poll_restarts():
            self._wire_replica(rep)
            self.breakers[rep.name].reset_to_probe()
            info = self.supervisor.recovery_info(rep.name)
            if info is not None and self.trace_recorder is not None:
                # failover event spanning dead replica -> its
                # replacement, on every in-flight request the crash
                # re-routed (their retries are still pending here)
                for fh, _ in self._pending:
                    if (fh.replica == rep.name and not fh.finished
                            and fh.trace is not None):
                        self.trace_recorder.add_event(
                            fh.trace, "failover", now,
                            from_replica=rep.name,
                            to_replica=info.get("adopted") or rep.name,
                            path=info["path"],
                            recovery_s=info["recovery_s"])

        if (self._pending
                and not self.supervisor.ready_replicas()
                and not self.supervisor.restarts_scheduled()):
            # nothing will ever serve these — fail loudly, don't spin
            while self._pending:
                fh, _ = self._pending.popleft()
                if not fh.finished:
                    self._finalize(fh, "error")

        still: Deque[Tuple[FleetHandle, float]] = deque()
        if self.admission_policy is None:
            while self._pending:
                fh, not_before = self._pending.popleft()
                if fh.finished:
                    continue
                if fh.deadline is not None and now >= fh.deadline:
                    self._finalize(fh, "deadline")
                    continue
                if now < not_before or not self._try_route(fh):
                    still.append((fh, not_before))
            self._pending = still
        else:
            # policy-ordered drain: entries whose backoff elapsed route
            # in admission order; the rest keep FIFO positions. The
            # policy's on_admit is NOT called here — slot claims happen
            # in the replica scheduler, which counts them.
            ready: List[Tuple[FleetHandle, float]] = []
            while self._pending:
                fh, not_before = self._pending.popleft()
                if fh.finished:
                    continue
                if fh.deadline is not None and now >= fh.deadline:
                    self._finalize(fh, "deadline")
                    continue
                if now < not_before:
                    still.append((fh, not_before))
                else:
                    ready.append((fh, not_before))
            for i in self.admission_policy.order(
                    [fh for fh, _ in ready], now):
                fh, not_before = ready[i]
                if not self._try_route(fh):
                    still.append((fh, not_before))
            self._pending = still

        for rep in self.supervisor.replicas:
            if rep.state != "ready":
                continue
            if not (rep.server.queue or rep.server.slots.occupied):
                continue
            try:
                rep.step()
            except ReplicaCrashed as e:
                self._handle_crash(rep, e)
            except LockstepError:
                raise  # a tp group lost a rank: never a retryable step failure
            except Exception as e:
                self._handle_step_failure(rep, e)

        for key in list(self._attempts.keys()):
            fh, rh = self._attempts.get(key, (None, None))
            if rh is None or not rh.finished:
                continue
            del self._attempts[key]
            self._resolve_finished(key[0], fh, rh, crashed=False)

        if self.controller is not None:
            # control tick AFTER outcomes reconcile (its signal windows
            # see this round's finishes) and BEFORE gauges/clock, so an
            # actuation lands in the same round's exported state
            self.controller.on_round()

        self._update_gauges()
        self.clock.tick()
        return bool(self._pending) or bool(self._attempts)

    def _update_gauges(self) -> None:
        self.supervisor.refresh_health_gauges()
        for name, breaker in self.breakers.items():
            # surface OPEN -> HALF_OPEN transitions that happened purely
            # by clock, not by an allow() call from routing
            breaker.allow()
            self._breaker_gauge.labels(replica=name).set(breaker.state)
        self._queue_depth_g.set(self.fleet_queue_depth())

    # -- drain -----------------------------------------------------------
    def drain(self) -> None:
        """Stop admission (submit() sheds with reason=draining); already-
        accepted work keeps stepping until done."""
        self.draining = True

    def run_until_drained(self, max_steps: Optional[int] = None) -> None:
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"fleet not drained after {max_steps} steps "
                    f"(pending={len(self._pending)}, "
                    f"in_flight={len(self._attempts)})")

    # -- offline convenience ----------------------------------------------
    def generate_batch(self, requests) -> List[FleetHandle]:
        handles = [self.submit(r) for r in requests]
        self.run_until_drained()
        return handles

    def health_report(self) -> Dict[str, Any]:
        """The /healthz payload: per-replica breaker state by
        NAME (not the internal int) plus the health-gate reasons the
        routing tier is acting on — what an operator needs to see why a
        replica is being avoided."""
        breaker_names = {CircuitBreaker.CLOSED: "closed",
                         CircuitBreaker.HALF_OPEN: "half_open",
                         CircuitBreaker.OPEN: "open"}
        replicas = {}
        for rep in self.supervisor.replicas:
            h = rep.health()
            replicas[rep.name] = {
                "state": rep.state,
                "breaker": breaker_names[self.breakers[rep.name].state],
                "healthy": h.ready,
                "reasons": h.reasons,
            }
        return {
            "replicas": replicas,
            "draining": self.draining,
            "pending": len(self._pending),
            "in_flight": len(self._attempts),
        }

    # -- fleet-wide observability -----------------------------------------
    def fleet_metrics_page(self) -> str:
        """One merged Prometheus page for the whole fleet: the shared
        (supervisor/router) registry as-is, plus every live replica's
        PRIVATE registry re-labelled under ``replica=<name>``. Built from
        the Replica wrappers — not captured server objects — so a respawn
        is picked up automatically, exactly like the flight recorder's
        lazy metrics providers."""
        return render_fleet_prometheus(
            self.supervisor.registry,
            {rep.name: rep.server.metrics.registry
             for rep in self.supervisor.replicas},
        )

    def attrib_report(self, include_live: bool = False) -> Dict[str, Any]:
        """Fleet attribution: one ``mingpt-attrib/1`` document per
        replica whose server was built with ``attrib=True``, keyed by
        replica name. Replicas without a ledger are skipped (a fleet may
        mix instrumented and plain servers); raises only when NO replica
        has attribution enabled."""
        replicas = {
            rep.name: rep.server.attrib_report(include_live=include_live)
            for rep in self.supervisor.replicas
            if rep.server.attrib is not None
        }
        if not replicas:
            raise ValueError(
                "no replica has attribution enabled — pass attrib=True "
                "to the server factory")
        return {"schema": "mingpt-attrib-fleet/1", "replicas": replicas}

    def summary(self) -> Dict[str, Any]:
        return {
            "replicas": {
                rep.name: {
                    "state": rep.state,
                    "crashes": rep.crashes,
                    "healthy": rep.health().ready,
                    "health_reasons": rep.health().reasons,
                    "clock_skew_s": rep.clock.skew_s,
                    "breaker_state": self.breakers[rep.name].state,
                    "load": rep.load if rep.state == "ready" else None,
                }
                for rep in self.supervisor.replicas
            },
            "pending": len(self._pending),
            "in_flight": len(self._attempts),
            "draining": self.draining,
            "rejected_by_reason": {
                labels["reason"]: int(child.value)
                for labels, child in self._rejected.children()
            },
            "retries_by_reason": {
                labels["reason"]: int(child.value)
                for labels, child in self._retries.children()
            },
            "requests_by_outcome": {
                labels["outcome"]: int(child.value)
                for labels, child in self._requests_total.children()
            },
            "duplicates_suppressed": int(self._dup_suppressed.value),
        }
