"""Admission policies beyond FIFO, plus the name registry.

Counterpart of ``mingpt_distributed_tpu/trafficlab/policies.py``.

The interface (:class:`AdmissionPolicy`) and the behavior-preserving
FIFO default live in ``serving/admission.py`` — the serving package
must not import trafficlab. This module holds the policies the traffic
lab actually compares, keyed by name for CLI/report use:

* ``edf`` — earliest-deadline-first: deadline-carrying requests admit
  in deadline order ahead of deadline-free ones. Under overload this
  trades batch-job latency for chat deadline hit-rate, which is exactly
  the separation the sweep report grades.
* ``fair`` — fair-share per tenant: the tenant with the fewest
  admissions so far goes first, so one bursty tenant cannot starve the
  rest of the mix. Stateful: the scheduler's ``on_admit`` maintains the
  counts, and because the fleet router deliberately does NOT call
  ``on_admit`` (serving/admission.py), sharing one policy object across
  router + replicas counts each admission exactly once.
* ``health`` — lives in ``serving/admission.py`` (it is a serving-side
  policy, registered here for grading): FIFO while the fleet is
  healthy, EDF once any routable replica fails a health gate.

Every ``sort_key`` ends in the queue position, so equal-priority
requests keep FIFO order and the whole schedule stays deterministic on
the VirtualClock.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from mingpt_distributed_tpu_torch.serving.admission import (
    AdmissionPolicy,
    FifoPolicy,
    HealthAwarePolicy,
)

__all__ = [
    "POLICIES",
    "DeadlinePolicy",
    "FairSharePolicy",
    "make_policy",
]


class DeadlinePolicy(AdmissionPolicy):
    """Earliest-deadline-first. Handles expose ``.deadline`` (absolute
    clock seconds or None) on both the scheduler and router queues;
    deadline-free handles sort after every deadline-carrying one."""

    name = "edf"

    def sort_key(self, handle: Any, position: int, now: float) -> Tuple:
        deadline = getattr(handle, "deadline", None)
        if deadline is None:
            return (1, 0.0, position)
        return (0, float(deadline), position)


class FairSharePolicy(AdmissionPolicy):
    """Least-admitted tenant first. Tenant comes from
    ``handle.request.tenant`` (None buckets to ``"_"``); counts update
    in ``on_admit`` — i.e. when a request actually claims a KV slot."""

    name = "fair"

    def __init__(self) -> None:
        self.admitted: Dict[str, int] = {}

    def _tenant(self, handle: Any) -> str:
        request = getattr(handle, "request", None)
        tenant = getattr(request, "tenant", None)
        return tenant if tenant is not None else "_"

    def sort_key(self, handle: Any, position: int, now: float) -> Tuple:
        return (self.admitted.get(self._tenant(handle), 0), position)

    def on_admit(self, handle: Any) -> None:
        tenant = self._tenant(handle)
        self.admitted[tenant] = self.admitted.get(tenant, 0) + 1


#: registry for CLI flags and report keys. Values are FACTORIES —
#: stateful policies (fair) must be fresh per run, never shared across
#: sweep rungs.
POLICIES = {
    "fifo": FifoPolicy,
    "edf": DeadlinePolicy,
    "fair": FairSharePolicy,
    # FIFO while healthy, EDF once any routable replica degrades; the
    # runner binds the live signals seam per cell
    "health": HealthAwarePolicy,
}


def make_policy(name: str) -> AdmissionPolicy:
    """Fresh policy instance by registry name."""
    try:
        factory = POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown admission policy {name!r} (want one of "
            f"{sorted(POLICIES)})")
    return factory()
