"""Control signals: one typed snapshot of fleet state per control tick.

Counterpart of ``mingpt_distributed_tpu/control/signals.py``. The
controller that consumes the snapshots is ROADMAP.md Queue 1 item 15c; the
traffic lab's ``health`` policy binds :class:`FleetSignalsView` now. The
controller decides from ONE immutable view of the fleet, sampled on the injected clock — never from ad-hoc pokes at router
internals scattered through the decision code. :class:`SignalSampler`
is that seam: it subscribes to the router's finish hook to maintain
rolling windows (TTFT, deadline outcomes — *rolling*, not cumulative,
so a recovered fleet's quantiles come back down and scale-down can
actually fire), and folds in the instantaneous surfaces the fleet
already exports: ``Router.health_report()``-grade replica readiness,
fleet queue depth, shed counters by reason, per-replica ITL p99 from
the shared serving histograms, and HBM ledger headroom when attribution
is on.

Every numeric in the snapshot is derived from the injected clock or
deterministic counters, so a VirtualClock sweep snapshots — and
therefore decides, and therefore logs — byte-identically across runs.

:class:`FleetSignalsView` is the lightweight live-health seam the
``health`` admission policy (serving/admission.py) binds to: just
``degraded()`` and ``queue_depth()``, cheap enough to consult per
sort key.
"""

from __future__ import annotations

import hashlib
import json
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Any, Deque, Dict, Optional

from mingpt_distributed_tpu_torch.telemetry.slo import exact_quantile

__all__ = ["ControlSnapshot", "FleetSignalsView", "SignalSampler"]


@dataclass(frozen=True)
class ControlSnapshot:
    """Immutable fleet view for one control tick. ``None`` means "no
    signal yet" (e.g. no completion carried a deadline), never zero —
    the controller treats absence as neither breach nor comfort for
    quantile metrics and falls back to queue pressure."""

    tick: int
    now: float
    replicas_total: int = 0
    replicas_ready: int = 0          # ready AND not draining (routable)
    replicas_draining: int = 0
    replicas_drained: int = 0
    queue_depth: int = 0             # router retry queue + replica queues
    queue_per_replica: float = 0.0   # depth / routable replicas
    in_flight: int = 0
    ttft_p99_s: Optional[float] = None       # rolling window
    itl_p99_s: Optional[float] = None        # max over ready replicas
    deadline_hit_rate: Optional[float] = None  # rolling window
    completed: int = 0               # cumulative finishes by outcome
    deadline_missed: int = 0
    errors: int = 0
    tokens: int = 0                  # cumulative caller-visible tokens
    shed_by_reason: Dict[str, int] = field(default_factory=dict)
    hbm_headroom_bytes: Optional[float] = None

    def to_json(self) -> Dict[str, Any]:
        return asdict(self)

    def digest(self) -> str:
        """Stable content hash logged with every decision so a replayed
        log proves the controller saw identical inputs."""
        blob = json.dumps(self.to_json(), sort_keys=True)
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


class FleetSignalsView:
    """Minimal live-health view over a router for admission decisions:
    no windows, no history — instantaneous readiness and backlog."""

    def __init__(self, router):
        self.router = router

    def queue_depth(self) -> int:
        return self.router.fleet_queue_depth()

    def degraded(self) -> bool:
        """True while any routable replica fails its health gate (queue
        watermark, ITL p99, recompiles) or no replica is routable at
        all — the moment admission ordering should start honouring
        deadlines over arrival order."""
        routable = [rep for rep in self.router.supervisor.ready_replicas()
                    if not getattr(rep, "draining", False)]
        if not routable:
            return True
        return any(not rep.health().ready for rep in routable)


class SignalSampler:
    """Maintains the rolling windows and assembles snapshots.

    Chains onto ``router.on_finish`` (composing with any hook already
    installed) so every finished fleet request feeds the windows exactly
    once, in finish order — deterministic on VirtualClock.
    """

    def __init__(self, router, window: int = 128):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.router = router
        self.clock = router.clock
        self.window = window
        self._ttft: Deque[float] = deque(maxlen=window)
        self._deadline_hits: Deque[float] = deque(maxlen=window)
        self.completed = 0
        self.deadline_missed = 0
        self.errors = 0
        self.tokens = 0
        self.deadline_requests = 0
        self.deadline_hit_total = 0
        prev = router.on_finish

        def hook(fh, outcome):
            if prev is not None:
                prev(fh, outcome)
            self.on_finish(fh, outcome)

        router.on_finish = hook

    # -- feed ----------------------------------------------------------
    def on_finish(self, fh, outcome: str) -> None:
        self.tokens += len(fh.tokens)
        if outcome == "completed":
            self.completed += 1
        elif outcome == "deadline":
            self.deadline_missed += 1
        else:
            self.errors += 1
        if fh.deadline is not None:
            hit = 1.0 if outcome == "completed" else 0.0
            self.deadline_requests += 1
            self.deadline_hit_total += int(hit)
            self._deadline_hits.append(hit)
        first = getattr(fh, "first_token_at", None)
        if first is not None:
            self._ttft.append(max(0.0, first - fh.submit_time))

    # -- live counter view (cost.py's live input) ----------------------
    def counts(self) -> Dict[str, int]:
        """Cumulative counts in the shape ``cost.compute_cost`` takes —
        the SAME shape a trafficlab cell reduces to, so one cost
        implementation serves both."""
        shed = sum(self.router.shed_counts().values())
        return {
            "completed": self.completed,
            "expired": self.deadline_missed,
            "errors": self.errors,
            "shed": shed,
            "tokens": self.tokens,
            "deadline_requests": self.deadline_requests,
            "deadline_hits": self.deadline_hit_total,
        }

    # -- snapshot ------------------------------------------------------
    def snapshot(self, tick: int) -> ControlSnapshot:
        sup = self.router.supervisor
        ready = draining = drained = 0
        itls = []
        headroom: Optional[float] = None
        for rep in sup.replicas:
            if rep.state == "drained":
                drained += 1
                continue
            if rep.state != "ready":
                continue
            if getattr(rep, "draining", False):
                draining += 1
                continue
            ready += 1
            metrics = getattr(rep.server, "metrics", None)
            p99 = getattr(metrics, "itl_p99_s", None)
            if p99 is not None:
                itls.append(float(p99))
            hbm = getattr(rep.server, "hbm", None)
            if hbm is not None and hbm.capacity_bytes is not None:
                h = float(hbm.capacity_bytes - hbm.total_bytes())
                headroom = h if headroom is None else min(headroom, h)
        depth = self.router.fleet_queue_depth()
        hits = list(self._deadline_hits)
        return ControlSnapshot(
            tick=tick,
            now=self.clock.now(),
            replicas_total=len(sup.replicas),
            replicas_ready=ready,
            replicas_draining=draining,
            replicas_drained=drained,
            queue_depth=depth,
            queue_per_replica=depth / max(1, ready),
            in_flight=len(self.router._attempts),
            ttft_p99_s=exact_quantile(list(self._ttft), 0.99),
            itl_p99_s=max(itls) if itls else None,
            deadline_hit_rate=(sum(hits) / len(hits) if hits else None),
            completed=self.completed,
            deadline_missed=self.deadline_missed,
            errors=self.errors,
            tokens=self.tokens,
            shed_by_reason=self.router.shed_counts(),
            hbm_headroom_bytes=headroom,
        )
