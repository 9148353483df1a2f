"""Process-isolated fleet: supervisor, router and live migration over the
procfleet RPC boundary.

Counterpart of ``mingpt_distributed_tpu/serving/procfleet/supervisor.py``.
The in-process fleet (``serving/fleet.py``) has the hard parts already:
breakers, bounded retry, token-index dedup, health-gated placement, the
crash → backoff → respawn lifecycle. This module moves its *failure domain*
from "a Python object we drop" to "an OS process we SIGKILL" without
rewriting any of that:

* :class:`ServerProxy` — duck-types the slice of ``InferenceServer`` the
  Router and Replica touch (``queue``, ``slots``, ``metrics``, ``watchdog``,
  ``submit``/``step``, ``on_token``) and forwards each call across a
  :class:`~.transport.SocketTransport` or the deterministic
  :class:`~.transport.LoopbackTransport`. The worker is **step-driven**:
  ``step()`` asks the replica for one scheduling round and applies the
  returned event batch to local handle mirrors, so the router's round loop,
  reconcile pass and dedup emitter run unchanged.

* :class:`ProcReplica` — a :class:`~..fleet.Replica` whose ``_spawn``
  produces a backend (a subprocess, or the in-process loopback twin)
  instead of a server. Liveness is the socket plus the OS: a dead process
  answers its next RPC with a connection error, which ``step()`` turns into
  :class:`~...training.faults.ProcessKilled` (a ``ReplicaCrashed``), so the
  router's crash path applies unchanged. The supervisor also reaps the
  corpse: the waitpid exit code (negative = the signal) and the flight
  dumps left in the dead replica's spill directory.

* :meth:`ProcRouter.migrate_and_drain` — live migration. The source ships
  its prefix-store entries and the bucket-quantized leading rows of every
  in-flight slot through the size-framed transfer channel; the destination
  installs them on its device. In-flight requests re-route from their
  ORIGINAL prompts (the retry-idempotency invariant that makes crash
  recovery token-exact), so the migrated stream is bit-identical while the
  shipped rows turn the re-prefill into a row copy. The drained process
  exits ``REQUEUE_EXIT_CODE`` (75).

Warm standby adds three mechanisms without changing that shape:

* :class:`StandbyPool` — N spare workers kept *fully spawned* (weights
  placed, the shape family warmed at worker start) behind the same backend
  factory. ``ProcReplica._spawn`` adopts a hot spare instead of paying spawn
  + restore + warmup, the supervisor collapses the restart backoff to "next
  round" when a spare is waiting, and the pool backfills after the adoption,
  off the recovery's critical path.

* the escalation ladder — :meth:`ProcessSupervisor.poll_liveness` watches
  each replica's step progress on the injected clock; a replica that holds
  work but completes no round for ``hang_deadline_s`` gets SIGTERM, and
  SIGKILL ``hang_kill_grace_s`` later if the process still lives (a worker
  wedged inside its step RPC ignores SIGTERM). The death then takes the
  ordinary crash path, standby adoption included.

* speculative-state-complete migration — the worker's migration frames
  carry the draft pool's rows too (``worker.migrate_out_frames``), so a
  migrated speculative request resumes *proposing* without a draft
  re-prefill.

One step RPC per replica per router round, one replica after the other, as
in the JAX package: on one card the replicas' rounds do not overlap.

Nothing here reads the wall clock: fleet time is the injected clock,
process liveness is ``waitpid``, and socket timeouts (an OS I/O deadline)
bound real-transport RPCs.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from mingpt_distributed_tpu_torch.serving.fleet import (
    REQUEUE_EXIT_CODE,
    Replica,
    ReplicaHealth,
    ReplicaSupervisor,
    Router,
    SkewedClock,
    WallClock,
)
from mingpt_distributed_tpu_torch.serving.procfleet.rpc import (
    EnvelopeError,
    TransportError,
    TransportTimeout,
    envelope,
    request_to_wire,
)
from mingpt_distributed_tpu_torch.serving.procfleet.transport import (
    LoopbackTransport,
    SocketTransport,
)
from mingpt_distributed_tpu_torch.serving.requests import QueueFullError
from mingpt_distributed_tpu_torch.telemetry import (
    MetricsRegistry,
    log_event,
    merge_fleet_pages,
    render_prometheus,
)
from mingpt_distributed_tpu_torch.training.faults import (
    InjectedAdmissionError,
    ProcessFaultInjector,
    ProcessKilled,
    WorkerStuck,
)

__all__ = [
    "ProcReplica",
    "ProcRouter",
    "ProcessBackend",
    "ProcessSupervisor",
    "ReplicaUnreachable",
    "ServerProxy",
    "StandbyPool",
    "LoopbackBackend",
    "loopback_backend_factory",
    "process_backend_factory",
]


class ReplicaUnreachable(InjectedAdmissionError):
    """submit() could not reach the replica process. Subclasses the
    admission-fault type so the router's existing admit-retry path
    (breaker failure + try the next candidate) handles it — the request
    is NOT lost, and the crash is confirmed by the next step RPC."""


# ---------------------------------------------------------------------
# InferenceServer proxy (the duck-typed slice the fleet layer touches)
# ---------------------------------------------------------------------

class _SizedQueue:
    """len()-able stand-in for the worker's request queue."""

    def __init__(self):
        self._n = 0

    def set(self, n: int) -> None:
        self._n = int(n)

    def __len__(self) -> int:
        return self._n


class _ProxySlots:
    occupied = 0


class _ProxyMetrics:
    """Mirrors the two latency numbers health/shedding read, plus an
    empty private registry (renders as an empty page — the real page is
    fetched over /metrics)."""

    def __init__(self):
        self.itl_mean_s: Optional[float] = None
        self.itl_p99_s: Optional[float] = None
        self.registry = MetricsRegistry()


class _ProxyWatchdog:
    def __init__(self):
        self.recompiles = 0
        self.on_recompile = None  # router wires this; fired via step RPC


class ServerProxy:
    """Client half of the step-driven contract: one of these per live
    backend, holding local :class:`RequestHandle` mirrors that the
    router's dedup emitter and reconcile pass consume exactly as they
    would in-process handles."""

    def __init__(self, transport, name: str, clock: Callable[[], float]):
        self.transport = transport
        self.name = name
        self.clock = clock
        self.queue = _SizedQueue()
        self.slots = _ProxySlots()
        self.metrics = _ProxyMetrics()
        self.watchdog = _ProxyWatchdog()
        self.on_token = None          # set by Router._wire_replica
        self.trace_recorder = None    # set by Router._wire_replica (unused:
        #                               the router owns spans and events)
        self.attrib = None            # truthy when the worker has a ledger
        self._handles: Dict[str, Any] = {}
        self._recompiles_seen = 0

    # -- submit ---------------------------------------------------------
    def submit(self, request):
        from mingpt_distributed_tpu_torch.serving.requests import RequestHandle

        doc = envelope("submit", request=request_to_wire(request))
        try:
            resp = self.transport.call("/rpc/submit", doc)
        except TransportError as e:
            raise ReplicaUnreachable(
                f"replica {self.name} unreachable at submit: {e}") from e
        if resp["kind"] == "error":
            err, msg = resp["error"], resp["message"]
            if err == "queue_full":
                raise QueueFullError(
                    msg, queue_depth=resp.get("queue_depth"),
                    retry_after_s=resp.get("retry_after_s"))
            if err in ("admit", "draining"):
                raise InjectedAdmissionError(msg)
            if err == "invalid":
                raise ValueError(msg)
            raise RuntimeError(f"submit to {self.name} failed: {err}: {msg}")
        if resp["kind"] != "submit_result":
            raise EnvelopeError(
                f"submit answered with {resp['kind']!r}")
        rh = RequestHandle(
            request=request,
            request_id=resp["request_id"],
            prompt_used=[int(t) for t in request.prompt],
            max_new_effective=request.max_new_tokens,
            submit_time=self.clock(),
        )
        self._handles[rh.request_id] = rh
        self.queue.set(resp["queue_depth"])
        return rh

    # -- one scheduling round --------------------------------------------
    def step(self) -> bool:
        resp = self.transport.call("/rpc/step", envelope("step"))
        if resp["kind"] == "error":
            # a poisoned round worker-side: replica alive, round lost —
            # surfaces as the router's generic step-failure (breaker
            # failure, recompute next round)
            raise RuntimeError(
                f"step on {self.name} failed: {resp['error']}: "
                f"{resp['message']}")
        if resp["kind"] != "step_result":
            raise EnvelopeError(f"step answered with {resp['kind']!r}")
        now = self.clock()
        for ev in resp["events"]:
            rh = self._handles.get(ev["request_id"])
            if rh is None:
                continue  # finished + reconciled in an earlier round
            if ev["type"] == "emit":
                if ev["token_index"] != len(rh.tokens):
                    raise EnvelopeError(
                        f"{self.name}: emit for {ev['request_id']} at "
                        f"index {ev['token_index']}, expected "
                        f"{len(rh.tokens)} — stream drift across the "
                        f"boundary")
                rh.tokens.append(ev["token"])
                if rh.first_token_time is None:
                    rh.first_token_time = now
                rh.last_token_time = now
                if self.on_token is not None:
                    self.on_token(rh, ev["token"])
            else:  # "finish"
                rh.finished = True
                rh.finish_reason = ev["finish_reason"]
                if ev["finish_reason"] == "error":
                    rh.error = RuntimeError(
                        ev.get("error", "replica-side error"))
                del self._handles[ev["request_id"]]
        self.queue.set(resp["queue_depth"])
        self.slots.occupied = resp["occupied"]
        self.watchdog.recompiles = resp["recompiles"]
        self.metrics.itl_mean_s = resp.get("itl_mean_s")
        self.metrics.itl_p99_s = resp.get("itl_p99_s")
        if (self.watchdog.recompiles > self._recompiles_seen
                and self.watchdog.on_recompile is not None):
            self.watchdog.on_recompile(
                self.watchdog.recompiles - self._recompiles_seen)
        self._recompiles_seen = self.watchdog.recompiles
        return bool(resp["busy"])

    # -- the rest of the surface the fleet layer touches -----------------
    def cancel(self, request_id: str) -> bool:
        resp = self.transport.call(
            "/rpc/cancel", envelope("cancel", request_id=request_id))
        return bool(resp.get("cancelled"))

    def attrib_report(self, include_live: bool = False) -> Dict[str, Any]:
        # live (uncommitted) call spans never cross the boundary — the
        # worker reports committed attribution only
        return self.transport.fetch_json("/attrib")

    def metrics_page(self) -> str:
        return self.transport.fetch_text("/metrics")

    def health_doc(self) -> Dict[str, Any]:
        return self.transport.call("/rpc/health")


# ---------------------------------------------------------------------
# Backends: what "a replica" physically is
# ---------------------------------------------------------------------

class LoopbackBackend:
    """The deterministic twin: a ReplicaWorker held in-process behind
    LoopbackTransport. Same byte-level RPC path, no sockets, no
    processes; kill/term emulate the OS verdicts (-9 / 75) so chaos
    reports are shape-identical across the seam."""

    kind = "loopback"
    pid = None

    def __init__(self, worker, spill_dir: Optional[str] = None,
                 attrib_enabled: bool = False):
        self.worker = worker
        self.transport = LoopbackTransport(worker)
        self.spill_dir = spill_dir
        self.attrib_enabled = attrib_enabled
        self.wedged = False
        self._exit_code: Optional[int] = None

    def alive(self) -> bool:
        return self._exit_code is None

    def mark_wedged(self) -> None:
        """The worker is stuck inside the step RPC. A real wedged worker
        holds the GIL in its signal-handling thread's stead, so SIGTERM's
        Python-level handler never runs — emulate that: only SIGKILL
        (which the OS delivers regardless) clears a wedged loopback."""
        self.wedged = True

    def sigkill(self) -> None:
        if self._exit_code is None:
            self._exit_code = -9
            self.transport.close()

    def sigterm(self) -> None:
        if self.wedged:
            return
        if self._exit_code is None:
            if self.worker.flight is not None:
                self.worker.flight.dump(
                    "drain", replica=self.worker.name,
                    unfinished=len(self.worker.server.unfinished()))
            self._exit_code = REQUEUE_EXIT_CODE
            self.transport.close()

    def wait(self, timeout_s: Optional[float] = None) -> Optional[int]:
        return self._exit_code

    def exit_code(self) -> Optional[int]:
        return self._exit_code

    def spill_dumps(self) -> List[str]:
        if not self.spill_dir:
            return []
        return sorted(glob.glob(os.path.join(self.spill_dir,
                                             "flight-*.json")))


class ProcessBackend:
    """A spawned worker subprocess + its socket transport. Exit codes
    follow waitpid convention: negative is the killing signal (-9 for
    SIGKILL), 75 is the drain/requeue contract."""

    kind = "process"

    def __init__(self, proc: subprocess.Popen, transport: SocketTransport,
                 pid: int, spill_dir: str, attrib_enabled: bool = False):
        self.proc = proc
        self.transport = transport
        self.pid = pid
        self.spill_dir = spill_dir
        self.attrib_enabled = attrib_enabled

    def alive(self) -> bool:
        return self.proc.poll() is None

    def mark_wedged(self) -> None:
        """No-op: a real subprocess wedges worker-side (the worker's own
        injector blocks the step RPC and its SIGTERM handler refuses to
        exit while wedged) — the OS, not this object, decides what
        signals do."""

    def sigkill(self) -> None:
        if self.alive():
            self.proc.kill()

    def sigterm(self) -> None:
        if self.alive():
            self.proc.terminate()

    def wait(self, timeout_s: Optional[float] = None) -> Optional[int]:
        try:
            return self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            return None

    def exit_code(self) -> Optional[int]:
        return self.proc.poll()

    def spill_dumps(self) -> List[str]:
        return sorted(glob.glob(os.path.join(self.spill_dir,
                                             "flight-*.json")))


def loopback_backend_factory(params, cfg, spill_root: Optional[str] = None,
                             **server_kwargs):
    """Backend factory for the deterministic seam: each spawn builds a
    full in-process InferenceServer (on the replica's SkewedClock, with
    the supervisor's serving-fault hook) wrapped in a ReplicaWorker."""
    from mingpt_distributed_tpu_torch.serving.procfleet.worker import ReplicaWorker
    from mingpt_distributed_tpu_torch.serving.scheduler import InferenceServer

    spawn_counts: Dict[str, int] = {}

    def make(name: str, clock, fault_hook) -> LoopbackBackend:
        n = spawn_counts.get(name, 0)
        spawn_counts[name] = n + 1
        server = InferenceServer(params, cfg, clock=clock,
                                 fault_hook=fault_hook, **server_kwargs)
        flight = None
        spill_dir = None
        if spill_root is not None:
            spill_dir = os.path.join(spill_root, f"{name}-s{n}")
            os.makedirs(spill_dir, exist_ok=True)
            from mingpt_distributed_tpu_torch.telemetry.flightrec import (
                FlightRecorder,
            )
            flight = FlightRecorder(capacity=256, out_dir=spill_dir,
                                    registry=server.metrics.registry)
        worker = ReplicaWorker(server, name=name, flight=flight)
        if flight is not None:
            # same on-disk evidence a real worker leaves at startup, so
            # a SIGKILL'd loopback replica still has a spill to collect
            flight.dump("spawn", replica=name, spawn=n)
        return LoopbackBackend(worker, spill_dir=spill_dir,
                               attrib_enabled=server.attrib is not None)

    return make


#: the checkout holding this package: a worker subprocess imports the port
#: from here whatever the caller's working directory is
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _worker_env() -> Dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_CHECKOUT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def process_backend_factory(spec_base: Dict[str, Any], spill_root: str,
                            rpc_timeout_s: float = 60.0):
    """Backend factory for real isolation: writes the worker spec under a
    per-spawn spill directory, spawns ``python -m
    mingpt_distributed_tpu_torch.serving.procfleet.worker`` (the checkout on
    its ``PYTHONPATH``, its stderr in the spill directory), reads the hello
    envelope off the child's stdout and binds a SocketTransport to the
    advertised ephemeral port. A worker that dies before its hello raises
    with the tail of its stderr (a ``cuda`` worker on a machine without a
    GPU, for one). ``fault_hook`` is ignored: serving faults cannot cross
    the process boundary as closures; put them in
    ``spec_base["serving_faults"]`` and the worker builds its own
    injector."""
    spill_root = os.path.abspath(spill_root)
    spawn_counts: Dict[str, int] = {}

    def make(name: str, clock, fault_hook) -> ProcessBackend:
        n = spawn_counts.get(name, 0)
        spawn_counts[name] = n + 1
        spill_dir = os.path.join(spill_root, f"{name}-s{n}")
        os.makedirs(spill_dir, exist_ok=True)
        spec = dict(spec_base, name=name, spill_dir=spill_dir)
        spec_path = os.path.join(spill_dir, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f, sort_keys=True)
        stderr_path = os.path.join(spill_dir, "stderr.log")
        with open(stderr_path, "wb") as errf:
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "mingpt_distributed_tpu_torch.serving.procfleet.worker",
                 spec_path],
                stdout=subprocess.PIPE, stderr=errf, text=True,
                env=_worker_env())
        line = proc.stdout.readline()  # blocks until hello or child EOF
        if not line:
            code = proc.wait()
            tail = ""
            try:
                with open(stderr_path) as f:
                    tail = f.read()[-2000:]
            except OSError:
                pass
            raise RuntimeError(
                f"worker {name} died before hello (exit {code}); stderr "
                f"tail:\n{tail}")
        from mingpt_distributed_tpu_torch.serving.procfleet.rpc import (
            validate_envelope,
        )
        hello = validate_envelope(json.loads(line), kind="hello")
        transport = SocketTransport("127.0.0.1", hello["port"],
                                    timeout_s=rpc_timeout_s)
        health = transport.call("/rpc/health")
        return ProcessBackend(proc, transport, pid=hello["pid"],
                              spill_dir=spill_dir,
                              attrib_enabled=bool(health.get("attrib")))

    return make


# ---------------------------------------------------------------------
# StandbyPool
# ---------------------------------------------------------------------

class StandbyPool:
    """N spare workers kept fully spawned behind the same backend
    factory the replicas use — weights placed and the shape family
    warmed at worker startup, so adoption is a pointer swap plus a
    health probe instead of spawn + restore + warmup.

    Each spare owns its :class:`~.fleet.SkewedClock` over the fleet
    clock; the adopting replica takes the clock along with the backend
    (the spare's server was built against it). Spares carry no
    serving-fault hook: round hooks close over a *replica* name, and a
    spare has none until adopted — process-level faults still apply,
    they key on the adopting replica's name at the RPC seam.

    ``fill()`` is synchronous and is called from ``poll_restarts`` —
    AFTER the adoption that emptied the slot — so backfill cost never
    sits on the recovery critical path. ``fill_in_background()`` runs the
    same fill on a thread (a fleet on the wall clock scaling up: a spawn
    takes seconds, and the router keeps stepping meanwhile); ``join()``
    waits for it and re-raises its failure.
    """

    def __init__(self, factory, fleet_clock, size: int,
                 registry: MetricsRegistry, name_prefix: str = "standby"):
        if size < 1:
            raise ValueError(f"standby pool size must be >= 1, got {size}")
        self.factory = factory
        self.fleet_clock = fleet_clock
        self.size = size
        self.name_prefix = name_prefix
        self._spares: List[Tuple[str, Any, SkewedClock]] = []
        self._spawned = 0
        # the background fill's thread, the spawns it has in flight and its
        # failure; the lock guards _spares, _spawned and _inflight
        self._lock = threading.Lock()
        self._filler: Optional[threading.Thread] = None
        self._inflight = 0
        self._fill_error: Optional[BaseException] = None
        self._gauge = registry.gauge(
            "mingpt_fleet_standby_pool_size",
            help="pre-warmed spare workers currently available for "
                 "adoption (dips on adoption, restored by backfill)")
        self._adoptions = registry.counter(
            "mingpt_fleet_standby_adoptions_total",
            help="crashed replicas recovered by adopting a hot spare "
                 "instead of a cold respawn")
        self._gauge.set(0)
        self._adoptions.inc(0)
        self.fill()

    def available(self) -> int:
        with self._lock:
            return len(self._spares)

    def fill(self) -> int:
        """Spawn spares until the pool holds ``size`` (counting spawns a
        background fill has in flight); returns how many were added."""
        added = 0
        while True:
            with self._lock:
                if len(self._spares) + self._inflight >= self.size:
                    break
                name = f"{self.name_prefix}{self._spawned}"
                self._spawned += 1
                self._inflight += 1
            try:
                clock = SkewedClock(self.fleet_clock.now)
                backend = self.factory(name=name, clock=clock, fault_hook=None)
            finally:
                with self._lock:
                    self._inflight -= 1
            with self._lock:
                self._spares.append((name, backend, clock))
                self._gauge.set(len(self._spares))
            added += 1
        return added

    def fill_in_background(self) -> None:
        """``fill()`` on a thread, unless one is running already."""
        if self._filler is not None and self._filler.is_alive():
            return

        def run():
            try:
                self.fill()
            except BaseException as e:  # noqa: BLE001 (re-raised by join)
                self._fill_error = e

        self._filler = threading.Thread(target=run, name="standby-backfill",
                                        daemon=True)
        self._filler.start()

    def join(self, timeout_s: Optional[float] = None) -> None:
        """Wait for a background fill; re-raise its failure."""
        if self._filler is not None:
            self._filler.join(timeout_s)
            if self._filler.is_alive():
                raise TimeoutError(f"standby backfill still running after {timeout_s} s")
            self._filler = None
        err, self._fill_error = self._fill_error, None
        if err is not None:
            raise RuntimeError("standby backfill failed") from err

    def acquire(self) -> Optional[Tuple[str, Any, SkewedClock]]:
        """Pop the oldest (warmest) spare, or None when exhausted. Does
        NOT backfill — the caller is mid-recovery."""
        while True:
            with self._lock:
                if not self._spares:
                    return None
                name, backend, clock = self._spares.pop(0)
                self._gauge.set(len(self._spares))
            if not backend.alive():
                # a spare that died while idle is not adoptable; skip it
                backend.transport.close()
                continue
            self._adoptions.inc()
            return name, backend, clock

    def shutdown(self) -> None:
        """Retire every remaining spare (test teardown / end of serving),
        once a background fill has finished."""
        self.join()
        for _, backend, _ in self._spares:
            if backend.alive():
                backend.sigterm()
                if backend.wait(timeout_s=10.0) is None:
                    backend.sigkill()
                    backend.wait(timeout_s=10.0)
            backend.transport.close()
        self._spares.clear()
        self._gauge.set(0)


# ---------------------------------------------------------------------
# ProcReplica
# ---------------------------------------------------------------------

class ProcReplica(Replica):
    """A Replica whose server lives behind the RPC boundary. The
    ``server_factory`` contract changes shape: it returns a *backend*
    (LoopbackBackend or ProcessBackend), and the Replica wraps it in a
    ServerProxy — everything above (submit, step, load, health) keeps
    the base types."""

    backend = None
    pinj: Optional[ProcessFaultInjector] = None
    draining = False
    #: set by ProcessSupervisor when a warm pool exists; class default
    #: None means construction-time spawns are always cold
    standby_pool: Optional[StandbyPool] = None
    #: spare identity adopted at the last standby-path spawn
    adopted_name: Optional[str] = None
    #: successfully completed step rounds — the liveness ladder's
    #: progress signal (a wedged replica's count stops advancing)
    steps_ok = 0

    def _spawn(self) -> ServerProxy:
        adopted = (self.standby_pool.acquire()
                   if self.standby_pool is not None else None)
        if adopted is not None:
            spare_name, backend, clock = adopted
            self.backend = backend
            # the spare's server was built against the spare's clock;
            # adopt the clock with it so skew faults keep one timeline
            self.clock = clock
            self.last_spawn_path = "standby"
            self.adopted_name = spare_name
        else:
            if self.standby_pool is not None:
                # a pool was provisioned but had nothing hot: say so
                # loudly — the operator sized it for the fault rate
                log_event(
                    f"[procfleet] standby pool exhausted: cold respawn "
                    f"for {self.name}", file=sys.stderr)
            hook = (self.injector.round_hook(self.name)
                    if self.injector is not None else None)
            self.backend = self._factory(name=self.name, clock=self.clock,
                                         fault_hook=hook)
            self.last_spawn_path = "cold"
            self.adopted_name = None
        proxy = ServerProxy(self.backend.transport, self.name,
                            clock=self.clock)
        if self.backend.attrib_enabled:
            proxy.attrib = True
        return proxy

    def respawn(self) -> None:
        old = self.backend
        if old is not None:
            if old.alive():
                old.sigkill()
                old.wait(timeout_s=10.0)
            old.transport.close()
        if self.pinj is not None:
            # a sticky stuck_step wedge belongs to the dead process, not
            # to the name — the replacement answers its RPCs
            self.pinj.reset(self.name)
        self.draining = False
        super().respawn()

    def step(self) -> bool:
        if self.backend is not None and self.backend.exit_code() is not None:
            # the liveness ladder (or the OS) killed the process between
            # rounds: observe the death BEFORE consulting injectors, or
            # a sticky wedge would mask the crash forever
            raise ProcessKilled(
                f"replica {self.name} process dead before step "
                f"(exit={self.backend.exit_code()})")
        if self.injector is not None:
            # in-process "slow" faults land as clock skew, same as the
            # thread fleet; crash-grade serving faults fire worker-side
            self.clock.skew_s += self.injector.step_delay(self.name)
        if self.pinj is not None:
            try:
                self.clock.skew_s += self.pinj.rpc_verdict(self.name)
            except ProcessKilled:
                # the fault IS the process dying: make it true, then let
                # the crash propagate through the normal path
                self.backend.sigkill()
                self.backend.wait(timeout_s=10.0)
                raise
            except WorkerStuck:
                # the worker wedged inside the step RPC: every later RPC
                # to it times out too, and SIGTERM's handler never runs.
                # Only the supervisor's SIGKILL rung clears it.
                self.backend.mark_wedged()
                raise
            # InjectedHang propagates: replica alive, round lost — the
            # router's step-failure path records a breaker failure
        try:
            busy = self.server.step()
        except TransportTimeout:
            raise  # lost round, process presumed alive
        except TransportError as e:
            self.backend.wait(timeout_s=10.0)
            raise ProcessKilled(
                f"replica {self.name} process died mid-step "
                f"(exit={self.backend.exit_code()}): {e}") from e
        self.steps_ok += 1
        return busy

    def health(self) -> ReplicaHealth:
        if self.state == "drained":
            return ReplicaHealth(False, ["drained"])
        h = super().health()
        if self.draining and h.ready:
            return ReplicaHealth(False, ["draining"])
        return h

    def reap(self) -> Dict[str, Any]:
        """Post-mortem of the current backend: exit code (waitpid
        convention) + the flight-recorder dumps the dead worker spilled."""
        b = self.backend
        if b is None:
            return {}
        if b.alive():
            b.wait(timeout_s=10.0)
        return {"backend": b.kind, "pid": b.pid,
                "exit_code": b.exit_code(),
                "spill_dumps": b.spill_dumps()}

    def shutdown(self, timeout_s: float = 10.0) -> Dict[str, Any]:
        """Graceful retirement: SIGTERM, wait for the requeue exit (75),
        escalate to SIGKILL only if the worker ignores the contract."""
        b = self.backend
        if b is None:
            return {}
        b.sigterm()
        code = b.wait(timeout_s=timeout_s)
        if code is None:
            b.sigkill()
            b.wait(timeout_s=timeout_s)
        b.transport.close()
        return {"backend": b.kind, "pid": b.pid,
                "exit_code": b.exit_code(),
                "spill_dumps": b.spill_dumps()}


# ---------------------------------------------------------------------
# ProcessSupervisor
# ---------------------------------------------------------------------

class ProcessSupervisor(ReplicaSupervisor):
    """ReplicaSupervisor over ProcReplica: the same backoff/budget
    lifecycle, plus OS-level crash forensics (exit codes, spill dumps),
    the process-restart / migration counters, and — when provisioned —
    the warm-standby pool and the hang-escalation liveness ladder.

    ``standby=N`` keeps N spares hot; a crash whose restart the budget
    allows is then rescheduled for *now* (adoption needs no backoff —
    the spare is already serving-ready) and ``poll_restarts`` backfills
    the pool afterwards. ``hang_deadline_s`` arms the ladder: a replica
    holding work that completes no round for that long (fleet clock)
    gets SIGTERM; if the process is still alive ``hang_kill_grace_s``
    later — a wedged worker ignores SIGTERM — it gets SIGKILL, and the
    death recovers through the ordinary crash path."""

    replica_cls = ProcReplica

    def __init__(self, backend_factory, n_replicas: int = 2, clock=None,
                 injector=None, process_injector=None, registry=None,
                 standby: int = 0,
                 hang_deadline_s: Optional[float] = None,
                 hang_kill_grace_s: float = 0.05,
                 **kwargs):
        super().__init__(backend_factory, n_replicas=n_replicas,
                         clock=clock, injector=injector,
                         registry=registry, **kwargs)
        self.process_injector = process_injector
        for rep in self.replicas:
            rep.pinj = process_injector
        self.hang_deadline_s = hang_deadline_s
        self.hang_kill_grace_s = hang_kill_grace_s
        #: replica -> {count, since, term_at}: step progress watermarks
        self._liveness: Dict[str, Dict[str, Any]] = {}
        r = self.registry
        self._proc_restarts = r.counter(
            "mingpt_fleet_process_restarts_total",
            help="replica worker processes respawned after a process "
                 "death (subset of mingpt_fleet_restarts_total where the "
                 "failure domain was the OS process)",
            labels=("replica",))
        self._migrations = r.counter(
            "mingpt_fleet_migrations_total",
            help="live KV/prefix migrations by outcome (ok = state "
                 "shipped and installed; failed = transfer failed, "
                 "requests still recovered by plain re-route)",
            labels=("outcome",))
        self._hang_esc = r.counter(
            "mingpt_fleet_hang_escalations_total",
            help="stuck-replica escalations by signal: term = polite "
                 "SIGTERM at the liveness deadline, kill = SIGKILL after "
                 "the grace window with the process still alive",
            labels=("signal",))
        for rep in self.replicas:
            self._proc_restarts.labels(replica=rep.name).inc(0)
        for outcome in ("ok", "failed"):
            self._migrations.labels(outcome=outcome).inc(0)
        for sig in ("term", "kill"):
            self._hang_esc.labels(signal=sig).inc(0)
        self.standby_pool: Optional[StandbyPool] = None
        if standby > 0:
            self.standby_pool = StandbyPool(
                backend_factory, self.clock, standby, r)
            for rep in self.replicas:
                rep.standby_pool = self.standby_pool
        #: post-mortems collected at mark_crashed time, in crash order
        self.crash_reports: List[Dict[str, Any]] = []
        #: replica name -> exit code recorded at graceful retirement
        self.drained_exits: Dict[str, Optional[int]] = {}

    def mark_crashed(self, replica) -> None:
        super().mark_crashed(replica)
        self._liveness.pop(replica.name, None)
        if (self.standby_pool is not None
                and self.standby_pool.available() > 0
                and replica.name in self._restart_due):
            # a hot spare is waiting: adoption needs no cold-spawn
            # backoff, so the replacement serves on the next round (the
            # restart *budget* still applies — the base scheduled this)
            self._restart_due[replica.name] = self.clock.now()
        self.crash_reports.append(
            {"replica": replica.name, **replica.reap()})

    def poll_restarts(self):
        restarted = super().poll_restarts()
        for rep in restarted:
            self._proc_restarts.labels(replica=rep.name).inc()
        if restarted and self.standby_pool is not None:
            # backfill AFTER the adoptions above — the spawn cost lands
            # here, not on the crash->serving window just recorded
            self.standby_pool.fill()
        return restarted

    def poll_liveness(self) -> List[Tuple[str, str]]:
        """The escalation ladder, driven once per router round on the
        injected clock. Progress = ``steps_ok`` advancing; only replicas
        that hold work are judged (the router does not step idle
        replicas, so an idle stall is not a hang). Returns the
        ``(replica, signal)`` escalations fired this poll."""
        escalated: List[Tuple[str, str]] = []
        if self.hang_deadline_s is None:
            return escalated
        now = self.clock.now()
        for rep in self.replicas:
            if (rep.state != "ready" or rep.backend is None
                    or rep.load == 0):
                self._liveness.pop(rep.name, None)
                continue
            if rep.backend.exit_code() is not None:
                continue  # already dead; the crash path observes it next
            st = self._liveness.get(rep.name)
            if st is None or rep.steps_ok != st["count"]:
                self._liveness[rep.name] = {
                    "count": rep.steps_ok, "since": now, "term_at": None}
                continue
            if st["term_at"] is None:
                if now - st["since"] >= self.hang_deadline_s:
                    rep.backend.sigterm()
                    st["term_at"] = now
                    self._hang_esc.labels(signal="term").inc()
                    escalated.append((rep.name, "term"))
            elif now - st["term_at"] >= self.hang_kill_grace_s:
                # grace expired with the process still alive: the worker
                # ignored SIGTERM (wedged inside the step RPC) — SIGKILL
                # is not ignorable
                rep.backend.sigkill()
                rep.backend.wait(timeout_s=10.0)
                self._hang_esc.labels(signal="kill").inc()
                escalated.append((rep.name, "kill"))
                self._liveness.pop(rep.name, None)
        return escalated

    # -- control-plane actuation (the autoscaler's) -----------------------
    def _make_replica(self, name: str, index: int):
        """Scale-up construction with the process wiring in place
        BEFORE the first spawn: the injector so chaos reaches the
        newcomer, and the standby pool so a scale-up adopts a hot spare
        (warm path) instead of paying a cold worker spawn when one is
        waiting."""
        rep = self.replica_cls.__new__(self.replica_cls)
        rep.pinj = self.process_injector
        if self.standby_pool is not None:
            rep.standby_pool = self.standby_pool
        rep.__init__(
            name, index, self._server_factory, self.clock, self.injector,
            queue_high_watermark=self.queue_high_watermark,
            itl_slo_s=self.itl_slo_s)
        return rep

    def spawn_replica(self):
        rep = super().spawn_replica()
        self._proc_restarts.labels(replica=rep.name).inc(0)
        if self.standby_pool is not None:
            # backfill after a possible adoption, same ordering contract
            # as poll_restarts. On the wall clock the spawn (seconds) runs
            # on a thread, so the router keeps stepping and routes to the
            # newcomer meanwhile; on an injected clock it runs in line and
            # the fleet replays deterministically
            if isinstance(self.clock, WallClock):
                self.standby_pool.fill_in_background()
            else:
                self.standby_pool.fill()
        return rep

    def retire_replica(self, replica) -> Dict[str, Any]:
        """Graceful, terminal shutdown (post-migration): the replica
        leaves the routable set for good — no restart is scheduled, and
        its exit code (75 per the requeue contract) is recorded."""
        info = replica.shutdown()
        self.drained_exits[replica.name] = info.get("exit_code")
        replica.state = "drained"
        self._restart_due.pop(replica.name, None)
        self._up.labels(replica=replica.name).set(0)
        self._healthy.labels(replica=replica.name).set(0)
        return info

    def shutdown_all(self) -> Dict[str, Optional[int]]:
        """Terminate every live backend — replicas AND unadopted spares
        (end of serving / test teardown)."""
        for rep in self.replicas:
            if rep.state != "drained" and rep.backend is not None \
                    and rep.backend.alive():
                info = rep.shutdown()
                self.drained_exits.setdefault(
                    rep.name, info.get("exit_code"))
        if self.standby_pool is not None:
            self.standby_pool.shutdown()
        return dict(self.drained_exits)


# ---------------------------------------------------------------------
# ProcRouter
# ---------------------------------------------------------------------

class ProcRouter(Router):
    """Router over a ProcessSupervisor. Placement additionally skips
    draining replicas; fleet observability is fetched over the RPC
    surface (a subprocess's private registry is not importable); and
    ``migrate_and_drain`` implements live migration."""

    def _candidates(self, fh):
        return [rep for rep in super()._candidates(fh)
                if not getattr(rep, "draining", False)]

    def fleet_metrics_page(self) -> str:
        """Merged Prometheus page: the shared supervisor/router registry
        plus every live replica's /metrics page fetched over RPC and
        re-labelled under ``replica=<name>`` — ONE TYPE line per family,
        same output contract as the in-process fleet page."""
        pages: Dict[str, str] = {}
        for rep in self.supervisor.replicas:
            if rep.state != "ready" or rep.backend is None:
                continue
            try:
                pages[rep.name] = rep.backend.transport.fetch_text(
                    "/metrics")
            except TransportError:
                continue  # dying replica: its crash path will run next
        return merge_fleet_pages(
            render_prometheus(self.supervisor.registry), pages)

    def export_migrate_blob(self, src) -> bytes:
        """Fetch ``src``'s size-framed migration blob (KV/prefix/draft
        state) over RPC. Building block shared with the cross-host
        :class:`~.hostplane.CrossHostRouter`, which pushes the same blob
        through a :class:`~.hostplane.PacedChannel` instead of a direct
        POST."""
        return src.backend.transport.fetch_bytes("/rpc/migrate_out")

    def install_migrate_blob(self, dst, blob: bytes) -> Dict[str, Any]:
        """Install a migration blob into ``dst``; returns the validated
        ``migrate_in_result`` envelope (raises EnvelopeError on a
        mismatched answer)."""
        resp = dst.backend.transport.post_bytes("/rpc/migrate_in", blob)
        if resp.get("kind") != "migrate_in_result":
            raise EnvelopeError(
                f"migrate_in answered with {resp.get('kind')!r}: "
                f"{resp.get('message')}")
        return resp

    def detach_unfinished(self, src_name: str,
                          to_label: str = "") -> List[Any]:
        """Pop every in-flight attempt off ``src_name``: finished ones
        resolve normally, unfinished ones get their attempt span closed
        as ``migrated`` (plus a trace event) and are returned for the
        caller to re-queue — locally into ``_pending`` or on another
        host entirely. The handles are NOT re-queued here."""
        now = self.clock.now()
        unfinished: List[Any] = []
        for key in [k for k in self._attempts if k[0] == src_name]:
            fh, rh = self._attempts.pop(key)
            if rh.finished:
                self._resolve_finished(src_name, fh, rh, crashed=False)
                continue
            self._close_attempt_span(fh, rh, "migrated")
            if self.trace_recorder is not None and fh.trace is not None:
                self.trace_recorder.add_event(
                    fh.trace, "migrate", now,
                    from_replica=src_name, to_replica=to_label)
                self.trace_recorder.mark_forced(fh.trace)
            unfinished.append(fh)
        return unfinished

    def drain_and_retire(self, src) -> Dict[str, Any]:
        """Best-effort drain envelope, then terminal retirement (exit
        75 per the requeue contract). Returns the shutdown info."""
        try:
            src.backend.transport.call(
                "/rpc/drain", envelope("drain", migrate=True))
        except TransportError:
            pass  # already unreachable; retirement reaps it either way
        info = self.supervisor.retire_replica(src)
        self._update_gauges()
        return info

    def migrate_and_drain(self, src_name: str,
                          dst_name: Optional[str] = None) -> Dict[str, Any]:
        """Drain ``src_name`` with zero loss: ship its prefix/KV state to
        a peer, re-route every in-flight request (bit-identical streams
        via the retry-idempotency invariant + dedup), then retire the
        source process (exit 75). Returns a ``mingpt-migrate/1`` report.

        A failed transfer degrades, never loses: the counter records
        ``outcome="failed"`` and the in-flight requests still re-route —
        they merely re-prefill from scratch on the peer."""
        src = self.supervisor.replica_by_name(src_name)
        if src is None or src.state != "ready":
            raise ValueError(
                f"cannot migrate from {src_name!r}: not a ready replica")
        src.draining = True  # no new placements while state ships
        if dst_name is not None:
            dst = self.supervisor.replica_by_name(dst_name)
        else:
            peers = [r for r in self.supervisor.ready_replicas()
                     if r.name != src_name
                     and not getattr(r, "draining", False)]
            dst = min(peers, key=lambda r: (r.load, r.index),
                      default=None)
        if dst is None or dst.state != "ready" or dst.name == src_name:
            src.draining = False
            raise ValueError(
                f"no migration destination for {src_name!r}")
        now = self.clock.now()
        outcome, installed, skipped, error = "ok", 0, 0, None
        draft_installed = 0
        try:
            blob = self.export_migrate_blob(src)
            resp = self.install_migrate_blob(dst, blob)
            installed = resp["installed"]
            skipped = resp["skipped"]
            draft_installed = resp.get("draft_installed", 0)
        except (TransportError, EnvelopeError) as e:
            outcome, error = "failed", repr(e)
        self.supervisor._migrations.labels(outcome=outcome).inc()
        # re-route every in-flight attempt from its ORIGINAL prompt; the
        # dedup emitter suppresses indices the caller already saw, so
        # the visible stream stays append-only and token-exact
        moved: List[str] = []
        for fh in self.detach_unfinished(src_name, to_label=dst.name):
            self._pending.append((fh, now))
            moved.append(fh.request_id)
        info = self.drain_and_retire(src)
        report = {
            "schema": "mingpt-migrate/1",
            "from": src_name,
            "to": dst.name,
            "outcome": outcome,
            "error": error,
            "entries_installed": installed,
            "entries_skipped": skipped,
            "draft_rows_installed": draft_installed,
            "requests_moved": sorted(moved),
            "src_exit_code": info.get("exit_code"),
        }
        if self.flight is not None:
            self.flight.dump("migration",
                             **{k: v for k, v in report.items()
                                if k != "schema"})
        return report
