"""Pluggable admission ordering.

Counterpart of ``mingpt_distributed_tpu/serving/admission.py``. Which
waiting request takes the next free KV slot is an
:class:`AdmissionPolicy`'s decision (``InferenceServer(admission_policy=
...)``). :class:`FifoPolicy` selects index 0, the arrival order, and is the
default. The deadline-aware and fair-share policies of the JAX package's
traffic lab come with the fleet (ROADMAP.md Queue 1 item 15).

The contract: ``sort_key(handle, position, now)`` returns a total-order
key over *waiting* handles (smaller = admit sooner). Handles are duck-
typed: they expose ``.deadline`` (absolute clock seconds or None) and
``.request`` (with ``.tenant``), which is all the shipped policies read.
``on_admit`` fires when a handle actually claims a KV slot.

Determinism: every policy breaks ties by queue position (``sort_key``
includes it), so admission order, and with it the whole serving schedule
on an injected clock, is a pure function of the submitted sequence.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

__all__ = [
    "AdmissionPolicy",
    "FifoPolicy",
    "HealthAwarePolicy",
]


class AdmissionPolicy:
    """Order waiting requests for admission. Subclass and implement
    ``sort_key``; override ``on_admit`` for stateful policies."""

    #: registry/report name (trafficlab reports grade policies by it)
    name = "policy"

    def sort_key(self, handle: Any, position: int,
                 now: float) -> Tuple:  # pragma: no cover - interface
        """Total-order key for one waiting handle (smaller admits
        first). ``position`` is the handle's current queue index — every
        key must include it (last) so equal-priority requests keep FIFO
        order."""
        raise NotImplementedError

    def select(self, queue: Sequence[Any], now: float) -> int:
        """Index of the next handle to admit from ``queue`` (non-empty)."""
        best = 0
        best_key = self.sort_key(queue[0], 0, now)
        for i in range(1, len(queue)):
            key = self.sort_key(queue[i], i, now)
            if key < best_key:
                best, best_key = i, key
        return best

    def order(self, handles: Sequence[Any], now: float) -> List[int]:
        """Indices of ``handles`` in admission order (used by the fleet
        router to drain its retry queue policy-first)."""
        return sorted(range(len(handles)),
                      key=lambda i: self.sort_key(handles[i], i, now))

    def on_admit(self, handle: Any) -> None:
        """A handle claimed a KV slot. Default: stateless no-op."""


class FifoPolicy(AdmissionPolicy):
    """Arrival order — the extracted default. ``select`` always returns
    0, byte-identical to the old ``popleft()`` admission."""

    name = "fifo"

    def sort_key(self, handle: Any, position: int, now: float) -> Tuple:
        return (position,)

    def select(self, queue: Sequence[Any], now: float) -> int:
        return 0


class HealthAwarePolicy(AdmissionPolicy):
    """Admission that consults live fleet health: FIFO while
    every routable replica passes its health gates, earliest-deadline-
    first the moment any is degraded (queue over watermark, ITL p99
    over SLO, recompiles — or nothing routable at all).

    The rationale: under healthy capacity, arrival order is the fair
    and cache-friendly order; once the fleet is degraded, head-of-line
    blocking starts costing deadline misses, so ordering flips to
    honour urgency. ``bind`` attaches the signals seam (anything with
    ``degraded() -> bool``) after the router exists; unbound the policy
    is plain FIFO, so it degrades safely in a solo server.

    The degraded bit is re-read per ``select``/``order`` call, never
    mid-sort: fleet state cannot change inside one ordering pass, so
    every key in a pass comes from the same regime and stays a total
    order."""

    name = "health"

    def __init__(self):
        self._signals = None

    def bind(self, signals) -> None:
        self._signals = signals

    def _degraded(self) -> bool:
        return self._signals is not None and self._signals.degraded()

    def _key(self, handle: Any, position: int, degraded: bool) -> Tuple:
        if not degraded:
            return (0, 0, 0.0, position)
        deadline = getattr(handle, "deadline", None)
        if deadline is None:
            return (1, 1, 0.0, position)
        return (1, 0, float(deadline), position)

    def sort_key(self, handle: Any, position: int, now: float) -> Tuple:
        return self._key(handle, position, self._degraded())

    def select(self, queue: Sequence[Any], now: float) -> int:
        degraded = self._degraded()
        if not degraded:
            return 0
        return min(
            range(len(queue)),
            key=lambda i: self._key(queue[i], i, degraded))

    def order(self, handles: Sequence[Any], now: float) -> List[int]:
        degraded = self._degraded()
        return sorted(
            range(len(handles)),
            key=lambda i: self._key(handles[i], i, degraded))
