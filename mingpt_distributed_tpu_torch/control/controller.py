"""SLO autoscaler: hold p99 under target by actuating the fleet's levers.

Counterpart of ``mingpt_distributed_tpu/control/controller.py``, the port's
own copy. It drives the thread fleet (``serving/fleet.Router``) and the
process fleet (``serving/procfleet.ProcRouter``, whose ``spawn_replica``
adopts a warm standby first) through the same seams: ``spawn_replica``,
``retire_replica``, ``Router.add_replica`` and ``Router.controller``.

Decision layer (:class:`HysteresisGovernor`) and actuation layer
(:class:`SLOAutoscaler`) are deliberately split: the governor is pure
state over (breach, comfort) observations — unit-testable against
synthetic noise with no fleet at all — while the autoscaler owns the
messy part: which lever to pull, in which order, and how to undo it.

**Hysteresis + cooldown.** A single noisy quantile crossing must not
flap the fleet. The governor requires ``up_after`` *consecutive* breach
ticks before scaling up and ``down_after`` consecutive comfort ticks
before scaling down (comfort = metric under ``comfort × target``, a
band strictly inside the breach threshold — the gap between the two is
the hysteresis dead zone where nothing ever actuates). After any action
a ``cooldown_s`` window (injected-clock seconds) discards observations
entirely, so one congestion episode produces one action, not a volley.

**Actuator priority.** Scale-up pulls levers in capacity order:

1. **replicas** — spawn through the supervisor (ProcessSupervisor's
   override adopts a warm standby when the pool has one) and wire into
   the router;
2. **spec** — gate speculation off: under saturation the draft model's
   propose/verify rounds spend compute on proposals that mostly get
   rejected; plain decode serves more aggregate tokens (gating is
   round-level and token-exact — verify guarantees parity, so on/off
   mid-stream never changes emitted tokens);
3. **prefill_chunk** — halve the chunk budget so long prompts yield the
   interleaved decode lanes more often (chunks pad to already-compiled
   ladder buckets: no recompile);
4. **shed_watermark** — lower the admission watermark: protect the p99
   of accepted work by refusing more at the door (last resort — sheds
   are a cost, see cost.py).

Scale-down restores in exactly the reverse order, so replicas drain
only after every cheaper lever is back at its resting value.

**Drain, never kill.** Replica scale-down marks the victim draining:
the router stops routing new work to it, but it keeps stepping until
its in-flight streams finish (``load == 0``), and only then is it
retired through ``supervisor.retire_replica``. In-flight requests are
never re-routed by a scale-down, so the caller-visible stream is
untouched — zero lost, zero duplicate tokens, by construction.

**Every decision is a record.** Each evaluated tick appends one
``mingpt-control/1`` row — tick, injected-clock time, signals digest,
metric value, action (actuator + direction) and reason — and non-hold
actions count in ``mingpt_control_actions_total{actuator,direction}``.
On VirtualClock the whole log is byte-identical across runs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from mingpt_distributed_tpu_torch.control.signals import ControlSnapshot, SignalSampler

__all__ = [
    "CONTROL_SCHEMA",
    "ControllerConfig",
    "HysteresisGovernor",
    "SLOAutoscaler",
    "parse_controller_spec",
    "render_control_log",
    "validate_control_log",
]

CONTROL_SCHEMA = "mingpt-control/1"

#: metric -> (snapshot field, treat-None-as) — quantile metrics have no
#: value until completions arrive; queue pressure always has one
_METRICS = ("ttft_p99", "itl_p99", "queue_depth", "deadline_miss")


@dataclass(frozen=True)
class ControllerConfig:
    """Parsed ``auto:`` controller spec. All times in injected-clock
    seconds; ``metric`` is what ``target`` bounds:

    * ``ttft_p99`` / ``itl_p99`` — rolling p99 seconds;
    * ``queue_depth`` — fleet backlog per routable replica;
    * ``deadline_miss`` — rolling (1 − deadline_hit_rate).

    ``queue_high`` is a standing scale-up guard on backlog per replica
    regardless of the chosen metric: quantiles only move when requests
    *finish*, but a fleet drowning in queue needs capacity before the
    first late completion reports in."""

    metric: str = "ttft_p99"
    target: float = 0.05
    comfort: float = 0.5          # comfort threshold = comfort * target
    min_replicas: int = 1
    max_replicas: int = 4
    interval_s: float = 0.05      # evaluation cadence
    cooldown_s: float = 0.25      # post-action observation blackout
    up_after: int = 2             # consecutive breach ticks to act
    down_after: int = 6           # consecutive comfort ticks to act
    queue_high: float = 8.0       # per-replica backlog breach guard
    min_chunk: int = 16           # prefill-chunk floor for actuation

    def validate(self) -> None:
        if self.metric not in _METRICS:
            raise ValueError(
                f"unknown controller metric {self.metric!r} "
                f"(known: {', '.join(_METRICS)})")
        if self.target <= 0:
            raise ValueError(f"target must be > 0, got {self.target}")
        if not 0.0 < self.comfort < 1.0:
            raise ValueError(
                f"comfort must be in (0, 1), got {self.comfort}")
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas {self.max_replicas} < min_replicas "
                f"{self.min_replicas}")
        if self.interval_s < 0 or self.cooldown_s < 0:
            raise ValueError("interval_s/cooldown_s must be >= 0")
        if self.up_after < 1 or self.down_after < 1:
            raise ValueError("up_after/down_after must be >= 1")
        if self.min_chunk < 1:
            raise ValueError(f"min_chunk must be >= 1, got {self.min_chunk}")


_INT_FIELDS = {"min_replicas", "max_replicas", "up_after", "down_after",
               "min_chunk"}
_FLOAT_FIELDS = {"target", "comfort", "interval_s", "cooldown_s",
                 "queue_high"}


def parse_controller_spec(spec: str) -> Optional[ControllerConfig]:
    """``"static"`` -> None; ``"auto[:k=v[:k=v...]]"`` -> config.

    Same colon-separated ``k=v`` grammar as arrival specs, e.g.
    ``auto:metric=ttft_p99:target=0.03:max_replicas=3``."""
    spec = spec.strip()
    if spec == "static":
        return None
    parts = spec.split(":")
    if parts[0] != "auto":
        raise ValueError(
            f"controller spec must be 'static' or start with 'auto:', "
            f"got {spec!r}")
    kwargs: Dict[str, Any] = {}
    for part in parts[1:]:
        if "=" not in part:
            raise ValueError(
                f"malformed controller field {part!r} in {spec!r} "
                f"(want k=v)")
        key, _, val = part.partition("=")
        if key in kwargs:
            raise ValueError(f"duplicate controller field {key!r} in {spec!r}")
        if key == "metric":
            kwargs[key] = val
        elif key in _INT_FIELDS:
            kwargs[key] = int(val)
        elif key in _FLOAT_FIELDS:
            kwargs[key] = float(val)
        else:
            raise ValueError(
                f"unknown controller field {key!r} in {spec!r}")
    cfg = ControllerConfig(**kwargs)
    cfg.validate()
    return cfg


def render_control_log(rows: List[Dict[str, Any]]) -> str:
    """The ``mingpt-control/1`` JSONL document: one sorted-key line per
    row — byte-identical whenever the rows are."""
    return "".join(json.dumps(r, sort_keys=True) + "\n" for r in rows)


_ROW_TYPES = {"schema": str, "tick": int, "now": (int, float), "signals": str,
              "metric": str, "queue_per_replica": (int, float),
              "replicas_ready": int, "action": dict, "reason": str}
_DIRECTIONS = ("up", "down", "hold")


def validate_control_log(text: str) -> List[str]:
    """Strict check of a ``mingpt-control/1`` document (the port's own;
    the JAX package reads these logs in ``tools/trace_summary.py``): every
    line a JSON row with exactly the keys ``_record`` writes, of their
    types, ``tick`` counting 1, 2, ... (an appended log restarts at 1),
    ``now`` never decreasing within a run, ``value`` a number or null, the
    action an actuator of the ladder (or "none" on a hold) with its
    direction. Returns the problems; an empty list is a valid log."""
    problems: List[str] = []
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        return ["no rows"]
    want_keys = set(_ROW_TYPES) | {"value"}
    prev_tick, prev_now = 0, None
    for i, line in enumerate(lines, start=1):
        try:
            row = json.loads(line)
        except ValueError as e:
            problems.append(f"line {i}: not JSON ({e})")
            continue
        if not isinstance(row, dict) or set(row) != want_keys:
            problems.append(f"line {i}: keys {sorted(row) if isinstance(row, dict) else row}")
            continue
        bad = [k for k, t in _ROW_TYPES.items()
               if not isinstance(row[k], t) or isinstance(row[k], bool)]
        if bad:
            problems.append(f"line {i}: wrong types for {bad}")
            continue
        if row["schema"] != CONTROL_SCHEMA:
            problems.append(f"line {i}: schema {row['schema']!r}")
        if row["metric"] not in _METRICS:
            problems.append(f"line {i}: metric {row['metric']!r}")
        if row["value"] is not None and not isinstance(row["value"], (int, float)):
            problems.append(f"line {i}: value {row['value']!r}")
        action = row["action"]
        if set(action) != {"actuator", "direction"} or (
                action["direction"] not in _DIRECTIONS) or (
                (action["actuator"] == "none") != (action["direction"] == "hold")) or (
                action["actuator"] not in (*SLOAutoscaler.ACTUATORS, "none")):
            problems.append(f"line {i}: action {action}")
        if row["tick"] == 1:
            prev_now = None
        elif row["tick"] != prev_tick + 1:
            problems.append(f"line {i}: tick {row['tick']} after {prev_tick}")
        if prev_now is not None and row["now"] < prev_now:
            problems.append(f"line {i}: now {row['now']} before {prev_now}")
        prev_tick, prev_now = row["tick"], row["now"]
    return problems


class HysteresisGovernor:
    """Pure breach/comfort debouncer: consecutive-tick thresholds plus
    a post-action cooldown. Knows nothing about fleets — feed it
    booleans, get back "up" / "down" / None."""

    def __init__(self, up_after: int, down_after: int, cooldown_s: float):
        self.up_after = up_after
        self.down_after = down_after
        self.cooldown_s = cooldown_s
        self.breach_ticks = 0
        self.comfort_ticks = 0
        self.cooldown_until: Optional[float] = None

    def observe(self, breach: bool, comfort: bool,
                now: float) -> Optional[str]:
        """One tick. Inside cooldown the observation is discarded (the
        fleet is still settling into the last action — counting it
        would double-trigger). Streaks reset on any non-matching tick,
        so noise never accumulates toward a threshold."""
        if self.cooldown_until is not None:
            if now < self.cooldown_until:
                return None
            self.cooldown_until = None
        self.breach_ticks = self.breach_ticks + 1 if breach else 0
        self.comfort_ticks = self.comfort_ticks + 1 if comfort else 0
        if self.breach_ticks >= self.up_after:
            self._acted(now)
            return "up"
        if self.comfort_ticks >= self.down_after:
            self._acted(now)
            return "down"
        return None

    def _acted(self, now: float) -> None:
        self.breach_ticks = 0
        self.comfort_ticks = 0
        self.cooldown_until = now + self.cooldown_s


class SLOAutoscaler:
    """The actuation layer over one router + supervisor.

    Driven by ``Router.step()`` once per scheduling round via
    ``on_round()``; evaluates at ``interval_s`` cadence on the injected
    clock. ``log_path`` (live serving) appends each decision row as it
    is made; ``decisions`` always holds the full in-memory log.
    """

    #: actuator ladder, scale-up order (scale-down walks it reversed)
    ACTUATORS = ("replicas", "spec", "prefill_chunk", "shed_watermark")

    def __init__(self, router, config: ControllerConfig,
                 sampler: Optional[SignalSampler] = None,
                 log_path: Optional[str] = None):
        config.validate()
        self.router = router
        self.supervisor = router.supervisor
        self.cfg = config
        self.clock = router.clock
        self.signals = sampler if sampler is not None else SignalSampler(router)
        self.governor = HysteresisGovernor(
            config.up_after, config.down_after, config.cooldown_s)
        self.tick = 0
        self.decisions: List[Dict[str, Any]] = []
        self.log_path = log_path
        self._next_eval: Optional[float] = None
        #: replicas we set draining and are waiting to retire
        self._draining: List[Any] = []
        #: boost levels: how far each reversible lever is from rest
        self._spec_gated = False
        self._chunk_halvings = 0
        self._watermark_halvings = 0
        self._orig_watermark = router.shed_watermark
        r = self.supervisor.registry
        self._actions = r.counter(
            "mingpt_control_actions_total",
            help="autoscaler actuations by lever and capacity direction "
                 "(up = more capacity / throughput, down = restore)",
            labels=("actuator", "direction"))
        self._target_g = r.gauge(
            "mingpt_control_target_replicas",
            help="replicas the controller currently wants routable "
                 "(provisioned minus draining)")
        self._target_g.set(self._provisioned())

    # -- driving --------------------------------------------------------
    def on_round(self) -> None:
        """Called by the router once per scheduling round."""
        self._finish_drains()
        now = self.clock.now()
        if self._next_eval is not None and now < self._next_eval:
            return
        self._next_eval = now + self.cfg.interval_s
        self.tick += 1
        snap = self.signals.snapshot(self.tick)
        breach, comfort, reason = self._classify(snap)
        verdict = self.governor.observe(breach, comfort, now)
        actuator, direction = None, "hold"
        if verdict == "up":
            actuator, reason = self._scale_up(snap, reason)
            direction = "up" if actuator else "hold"
        elif verdict == "down":
            actuator, reason = self._scale_down(snap, reason)
            direction = "down" if actuator else "hold"
        if actuator is not None:
            self._actions.labels(actuator=actuator,
                                 direction=direction).inc()
            self._target_g.set(self._provisioned())
        self._record(snap, actuator, direction, reason)

    # -- classification -------------------------------------------------
    def _metric_value(self, snap: ControlSnapshot) -> Optional[float]:
        if self.cfg.metric == "ttft_p99":
            return snap.ttft_p99_s
        if self.cfg.metric == "itl_p99":
            return snap.itl_p99_s
        if self.cfg.metric == "queue_depth":
            return snap.queue_per_replica
        if snap.deadline_hit_rate is None:
            return None
        return 1.0 - snap.deadline_hit_rate

    def _classify(self, snap: ControlSnapshot) -> Tuple[bool, bool, str]:
        """(breach, comfort, reason). The queue guard can force breach
        on its own; comfort additionally requires the backlog to be
        under the guard, so a quiet quantile over a growing queue never
        reads as comfortable."""
        value = self._metric_value(snap)
        queue_hot = snap.queue_per_replica > self.cfg.queue_high
        if value is not None and value > self.cfg.target:
            return True, False, (
                f"{self.cfg.metric}={value:.6g}>target={self.cfg.target:.6g}")
        if queue_hot:
            return True, False, (
                f"queue_per_replica={snap.queue_per_replica:.6g}>"
                f"queue_high={self.cfg.queue_high:.6g}")
        comfort_at = self.cfg.comfort * self.cfg.target
        if value is None:
            # no quantile signal: backlog alone decides comfort
            if snap.queue_per_replica <= self.cfg.queue_high * self.cfg.comfort:
                return False, True, "no_signal_queue_quiet"
            return False, False, "no_signal"
        if value <= comfort_at and not queue_hot:
            return False, True, (
                f"{self.cfg.metric}={value:.6g}<=comfort={comfort_at:.6g}")
        return False, False, (
            f"{self.cfg.metric}={value:.6g} in deadband")

    # -- actuation ------------------------------------------------------
    def _provisioned(self) -> int:
        """Replicas serving or about to serve: not drained, not marked
        draining — the count scale bounds apply to."""
        return sum(
            1 for rep in self.supervisor.replicas
            if rep.state != "drained" and not getattr(rep, "draining", False))

    def _servers(self):
        for rep in self.supervisor.replicas:
            if rep.state == "ready":
                yield rep

    def _scale_up(self, snap: ControlSnapshot,
                  reason: str) -> Tuple[Optional[str], str]:
        if self._provisioned() < self.cfg.max_replicas:
            rep = self.supervisor.spawn_replica()
            self.router.add_replica(rep)
            return "replicas", (
                f"{reason}; spawned {rep.name} "
                f"(path={rep.last_spawn_path})")
        if not self._spec_gated and self._any_spec_enabled():
            for rep in self._servers():
                if getattr(rep.server, "spec_enabled", None):
                    rep.server.spec_enabled = False
            self._spec_gated = True
            return "spec", f"{reason}; speculation gated off"
        chunk = self._min_live_chunk()
        if chunk is not None and chunk // 2 >= self.cfg.min_chunk:
            for rep in self._servers():
                eng = getattr(rep.server, "engine", None)
                if eng is not None and eng.prefill_chunk:
                    eng.prefill_chunk = max(
                        self.cfg.min_chunk, eng.prefill_chunk // 2)
            self._chunk_halvings += 1
            return "prefill_chunk", f"{reason}; chunk halved to >= {chunk // 2}"
        wm = self.router.shed_watermark
        if wm is not None and wm // 2 >= 1:
            self.router.shed_watermark = wm // 2
            self._watermark_halvings += 1
            return "shed_watermark", f"{reason}; watermark {wm}->{wm // 2}"
        return None, f"{reason}; saturated (no lever left)"

    def _scale_down(self, snap: ControlSnapshot,
                    reason: str) -> Tuple[Optional[str], str]:
        if self._watermark_halvings > 0:
            wm = self.router.shed_watermark
            assert wm is not None and self._orig_watermark is not None
            restored = min(self._orig_watermark, wm * 2)
            self.router.shed_watermark = restored
            self._watermark_halvings -= 1
            if restored >= self._orig_watermark:
                self._watermark_halvings = 0
            return "shed_watermark", f"{reason}; watermark {wm}->{restored}"
        if self._chunk_halvings > 0:
            for rep in self._servers():
                eng = getattr(rep.server, "engine", None)
                if eng is not None and eng.prefill_chunk:
                    eng.prefill_chunk = min(
                        eng.prefill_len, eng.prefill_chunk * 2)
            self._chunk_halvings -= 1
            return "prefill_chunk", f"{reason}; chunk doubled"
        if self._spec_gated:
            for rep in self._servers():
                if getattr(rep.server, "spec_enabled", None) is False:
                    rep.server.spec_enabled = True
            self._spec_gated = False
            return "spec", f"{reason}; speculation re-enabled"
        if self._provisioned() > self.cfg.min_replicas:
            victim = self._drain_candidate()
            if victim is not None:
                victim.draining = True
                self._draining.append(victim)
                return "replicas", f"{reason}; draining {victim.name}"
        return None, f"{reason}; at rest (no lever to restore)"

    def _any_spec_enabled(self) -> bool:
        return any(getattr(rep.server, "spec_enabled", None) is True
                   and getattr(rep.server, "spec", None) is not None
                   for rep in self._servers())

    def _min_live_chunk(self) -> Optional[int]:
        chunks = [rep.server.engine.prefill_chunk
                  for rep in self._servers()
                  if getattr(rep.server, "engine", None) is not None
                  and rep.server.engine.prefill_chunk]
        return min(chunks) if chunks else None

    def _drain_candidate(self):
        """Highest-index routable replica — deterministic, and the
        affinity hash (mod replica count at submit) keeps preferring
        low indices, so the tail replica holds the least sticky load."""
        live = [rep for rep in self.supervisor.replicas
                if rep.state == "ready"
                and not getattr(rep, "draining", False)]
        if len(live) <= self.cfg.min_replicas:
            return None
        return max(live, key=lambda rep: rep.index)

    def _finish_drains(self) -> None:
        """Retire draining replicas whose last in-flight stream has
        finished. ``load == 0`` plus no open router attempt means every
        token was emitted and reconciled — the replica leaves with
        nothing in its hands."""
        for rep in list(self._draining):
            if rep.state != "ready":
                # crashed while draining: the restart path owns it now
                # (respawn clears the draining flag); stop tracking
                self._draining.remove(rep)
                continue
            busy = rep.load > 0 or any(
                key[0] == rep.name for key in self.router._attempts)
            if not busy:
                self.supervisor.retire_replica(rep)
                self._draining.remove(rep)

    # -- the record -----------------------------------------------------
    def action_counts(self) -> Dict[str, Dict[str, int]]:
        """{actuator: {direction: count}} over the decision log —
        non-hold rows only (what the Prometheus counter also holds)."""
        out: Dict[str, Dict[str, int]] = {}
        for row in self.decisions:
            if row["action"]["direction"] == "hold":
                continue
            a = row["action"]["actuator"]
            d = row["action"]["direction"]
            out.setdefault(a, {}).setdefault(d, 0)
            out[a][d] += 1
        return out

    def render_log(self) -> str:
        return render_control_log(self.decisions)

    def _record(self, snap: ControlSnapshot, actuator: Optional[str],
                direction: str, reason: str) -> None:
        row = {
            "schema": CONTROL_SCHEMA,
            "tick": self.tick,
            "now": snap.now,
            "signals": snap.digest(),
            "metric": self.cfg.metric,
            "value": self._metric_value(snap),
            "queue_per_replica": snap.queue_per_replica,
            "replicas_ready": snap.replicas_ready,
            "action": {"actuator": actuator or "none",
                       "direction": direction},
            "reason": reason,
        }
        self.decisions.append(row)
        if self.log_path is not None:
            with open(self.log_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(row, sort_keys=True) + "\n")
