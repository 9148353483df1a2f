"""Recompile watchdog over the serving engine's bounded shape families.

Counterpart of ``mingpt_distributed_tpu/telemetry/watchdog.py``. The JAX
engine compiles a bounded family of programs and the watchdog counts XLA
traces after warmup; the port runs eagerly, so the count it watches is the
engine's ``compile_counts()``: the distinct input shapes each call family
has run (a later CUDA-graph capture needs exactly this bound). Arm it after
``warmup()``, then ``check()`` at scheduling-round boundaries: any growth
increments ``mingpt_recompiles_total{family=...}``, emits a telemetry
event, calls ``on_recompile`` (the flight recorder's dump) and, under the
hard-fail knob (``hard_fail=True`` or ``MINGPT_RECOMPILE_FATAL=1``), raises
:class:`RecompileError`.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

from mingpt_distributed_tpu_torch.telemetry.registry import MetricsRegistry
from mingpt_distributed_tpu_torch.telemetry.spans import SpanTracer, log_event

__all__ = ["RecompileError", "RecompileWatchdog"]


class RecompileError(RuntimeError):
    """A shape family grew after the watchdog was armed."""


class RecompileWatchdog:
    """Counts new shapes in a family after arming.

    ``counts_fn`` returns ``{family: distinct shapes}`` (e.g.
    ``InferenceServer.compile_counts``). Until :meth:`arm` the watchdog is
    dormant; after it, every :meth:`check` reports the growth since the
    previous baseline and advances the baseline, so each new shape is
    counted once."""

    def __init__(
        self,
        counts_fn: Callable[[], Dict[str, int]],
        registry: Optional[MetricsRegistry] = None,
        tracer: Optional[SpanTracer] = None,
        hard_fail: bool = False,
    ):
        if registry is None:
            from mingpt_distributed_tpu_torch import telemetry

            registry = telemetry.get_registry()
        self.tracer = tracer
        self.hard_fail = hard_fail or os.environ.get("MINGPT_RECOMPILE_FATAL") == "1"
        self._counts_fn = counts_fn
        self._baseline: Optional[Dict[str, int]] = None
        self._counter = registry.counter(
            "mingpt_recompiles_total",
            help="post-warmup new input shapes of a call family "
                 "(should stay 0 for the process lifetime)",
            labels=("family",),
        )
        self.recompiles = 0  # total counted by this watchdog
        #: called with {family: new shapes} whenever growth is detected,
        #: before any hard-fail raise (serve.py wires the flight dump here)
        self.on_recompile: Optional[Callable[[Dict[str, int]], None]] = None

    @property
    def armed(self) -> bool:
        return self._baseline is not None

    def arm(self) -> None:
        """Take the current counts as the allowed baseline (after warmup,
        when the whole family has run once)."""
        self._baseline = dict(self._counts_fn())

    def check(self) -> int:
        """New shapes since the last check; 0 when unarmed."""
        if self._baseline is None:
            return 0
        current = dict(self._counts_fn())
        grown = {fam: n - self._baseline.get(fam, 0)
                 for fam, n in current.items() if n > self._baseline.get(fam, 0)}
        if not grown:
            return 0
        self._baseline = current  # count each new shape once
        total = sum(grown.values())
        self.recompiles += total
        for fam, n in grown.items():
            self._counter.labels(family=fam).inc(n)
            if self.tracer is not None:
                self.tracer.event("recompile", family=fam, new_traces=n)
        detail = ", ".join(f"{fam}+{n}" for fam, n in sorted(grown.items()))
        log_event(f"recompile watchdog: {total} post-warmup new shape(s) ({detail})",
                  tracer=self.tracer)
        if self.on_recompile is not None:
            self.on_recompile(dict(grown))
        if self.hard_fail:
            raise RecompileError(
                f"post-warmup recompile detected: {detail}: the shape family "
                "must be bounded after warmup()")
        return total
