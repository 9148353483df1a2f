"""Trace→arrival-spec importer: replay production-shaped load exactly.

Counterpart of ``mingpt_distributed_tpu/control/importer.py``, the port's
own copy, reading traces through the port's ``telemetry/tracing``.

The synthetic arrival processes (poisson/bursty/ramp) answer "what
if" questions; the importer answers "what actually happened": it turns
a recorded ``mingpt-trace/1`` JSONL file — the native format every
serve.py run can already emit — into a ``recorded:`` arrival spec
(trafficlab/arrivals.py) whose rendered arrival times ARE the recorded
submit times, byte-identically. A trafficlab sweep over a recorded spec
grades policies and controllers against the production traffic shape,
not a Poisson approximation of it.

Submit timestamps come from each trace's request summary ``ts`` (the
router stamps it at ``submit()`` on the fleet clock); shed requests
are load too — the fleet refused them, but they arrived — so they are
included. Times are sorted and normalised to start at zero; the ladder
then stretches/compresses the *gaps* via ``RecordedSpec.scaled`` like
any other spec.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from mingpt_distributed_tpu_torch.telemetry.tracing import load_trace_jsonl
from mingpt_distributed_tpu_torch.trafficlab.arrivals import RecordedSpec

__all__ = ["import_trace_arrivals", "trace_arrival_times"]


def trace_arrival_times(path: str) -> Tuple[float, ...]:
    """Sorted, zero-based submit times of every request in the trace
    file (completed, expired, errored AND shed — arrivals all)."""
    traces = load_trace_jsonl(path)
    times = []
    for tr in traces.values():
        req = tr.get("request")
        if req is None:
            continue
        times.append(float(req["ts"]))
    if not times:
        raise ValueError(f"no request summaries in trace file {path!r}")
    times.sort()
    t0 = times[0]
    return tuple(t - t0 for t in times)


def import_trace_arrivals(path: str) -> Tuple[RecordedSpec, Dict[str, Any]]:
    """Build the replay spec plus a provenance dict (goes into sweep
    metadata so a report names the trace it replayed)."""
    times = trace_arrival_times(path)
    spec = RecordedSpec(times=times)
    meta = {
        "source": path,
        "n_requests": len(times),
        "duration_s": times[-1],
        "mean_rate": spec.mean_rate(),
    }
    return spec, meta
