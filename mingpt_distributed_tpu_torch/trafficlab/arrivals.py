"""Seeded open-loop arrival processes on virtual time.

Counterpart of ``mingpt_distributed_tpu/trafficlab/arrivals.py``, the
port's own copy: the same ``(seed, spec)`` gives the same timestamps in
both packages (numpy's ``RandomState``, seeded alike).

An arrival spec is a small frozen dataclass describing an intensity
function lambda(t) in requests per *virtual* second. ``arrival_times``
samples n absolute timestamps from it with Lewis–Shedler thinning: draw
candidate gaps from a homogeneous Poisson process at the peak rate,
keep each candidate with probability lambda(t)/peak. The RNG stream is
derived from ``(seed, canonical spec string)``, so the same pair always
reproduces the same trace byte-for-byte — reports are replayable and
two policies can be graded on the *identical* arrival sequence.

Specs never read a clock: timestamps are data, interpreted later by the
sweep runner against the serving ``VirtualClock``. The grammar mirrors
the fault-spec style used elsewhere in the repo::

    poisson:rate=50
    bursty:rate_on=200:rate_off=5:period=2.0:duty=0.25
    ramp:rate0=10:rate1=400:duration=20
    recorded:times=0.0;0.012;0.5;1.25

``scaled(f)`` multiplies every intensity by ``f`` — the sweep ladder is
"the same shape, offered harder".

``recorded:`` is the replay kind a trace importer (ROADMAP.md Queue 1
item 15c) emits: its times are not sampled at all —
``arrival_times`` returns them verbatim, so a sweep over a recorded
spec replays production-shaped load byte-identically. ``scaled(f)``
divides every timestamp by ``f`` (gap compression), which is the same
"shape preserved, offered harder" ladder semantics as the synthetic
kinds.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Tuple, Union

import numpy as np

__all__ = [
    "ArrivalSpec",
    "BurstySpec",
    "PoissonSpec",
    "RampSpec",
    "RecordedSpec",
    "arrival_times",
    "format_arrival_spec",
    "parse_arrival_spec",
    "spec_to_json",
]


def _fmt(x: float) -> str:
    """Canonical scalar rendering (``repr`` of float: shortest round-trip
    form, so format/parse/format is a fixed point and seeds derived from
    the string are stable)."""
    return repr(float(x))


@dataclasses.dataclass(frozen=True)
class PoissonSpec:
    """Homogeneous Poisson arrivals at ``rate`` req/s."""

    rate: float

    kind = "poisson"

    def rate_at(self, t: float) -> float:
        return self.rate

    def peak_rate(self) -> float:
        return self.rate

    def mean_rate(self) -> float:
        return self.rate

    def scaled(self, factor: float) -> "PoissonSpec":
        return PoissonSpec(rate=self.rate * factor)

    def to_string(self) -> str:
        return f"poisson:rate={_fmt(self.rate)}"


@dataclasses.dataclass(frozen=True)
class BurstySpec:
    """On/off (interrupted Poisson) arrivals: each ``period`` seconds
    spends ``duty`` fraction at ``rate_on`` and the rest at ``rate_off``.
    Models bursty tenants that overwhelm a fleet sized for the mean."""

    rate_on: float
    rate_off: float
    period: float
    duty: float

    kind = "bursty"

    def rate_at(self, t: float) -> float:
        phase = (t % self.period) / self.period
        return self.rate_on if phase < self.duty else self.rate_off

    def peak_rate(self) -> float:
        return max(self.rate_on, self.rate_off)

    def mean_rate(self) -> float:
        return self.rate_on * self.duty + self.rate_off * (1.0 - self.duty)

    def scaled(self, factor: float) -> "BurstySpec":
        return dataclasses.replace(self, rate_on=self.rate_on * factor,
                                   rate_off=self.rate_off * factor)

    def to_string(self) -> str:
        return (f"bursty:rate_on={_fmt(self.rate_on)}"
                f":rate_off={_fmt(self.rate_off)}"
                f":period={_fmt(self.period)}:duty={_fmt(self.duty)}")


@dataclasses.dataclass(frozen=True)
class RampSpec:
    """Linear ramp from ``rate0`` to ``rate1`` over ``duration`` seconds,
    holding ``rate1`` afterwards — a within-trace load sweep."""

    rate0: float
    rate1: float
    duration: float

    kind = "ramp"

    def rate_at(self, t: float) -> float:
        if t >= self.duration:
            return self.rate1
        frac = t / self.duration
        return self.rate0 + (self.rate1 - self.rate0) * frac

    def peak_rate(self) -> float:
        return max(self.rate0, self.rate1)

    def mean_rate(self) -> float:
        return 0.5 * (self.rate0 + self.rate1)

    def scaled(self, factor: float) -> "RampSpec":
        return dataclasses.replace(self, rate0=self.rate0 * factor,
                                   rate1=self.rate1 * factor)

    def to_string(self) -> str:
        return (f"ramp:rate0={_fmt(self.rate0)}:rate1={_fmt(self.rate1)}"
                f":duration={_fmt(self.duration)}")


@dataclasses.dataclass(frozen=True)
class RecordedSpec:
    """Literal arrival times imported from a ``mingpt-trace/1`` log.
    Nothing is sampled: ``arrival_times``
    returns these timestamps exactly (plus ``start``), so the seed is
    irrelevant and two renders are trivially identical."""

    times: Tuple[float, ...]

    kind = "recorded"

    def __post_init__(self):
        if not self.times:
            raise ValueError("recorded spec needs at least one time")
        prev = None
        for t in self.times:
            t = float(t)
            if t < 0.0:
                raise ValueError(f"recorded time {t} < 0")
            if prev is not None and t < prev:
                raise ValueError(
                    f"recorded times must be non-decreasing "
                    f"({t} after {prev})")
            prev = t

    def duration(self) -> float:
        return float(self.times[-1] - self.times[0])

    def rate_at(self, t: float) -> float:
        """Arrivals inside the 1-second window centred on ``t`` —
        descriptive only (generation never thins a recorded spec)."""
        return float(sum(1 for x in self.times if t - 0.5 <= x < t + 0.5))

    def peak_rate(self) -> float:
        """Busiest 1-second window (two-pointer sweep over the sorted
        times) — at least 1.0, so shared validation holds."""
        best, lo = 1, 0
        for hi in range(len(self.times)):
            while self.times[hi] - self.times[lo] > 1.0:
                lo += 1
            best = max(best, hi - lo + 1)
        return float(best)

    def mean_rate(self) -> float:
        dur = self.duration()
        if dur <= 0.0:
            return float(len(self.times))
        return (len(self.times) - 1) / dur

    def scaled(self, factor: float) -> "RecordedSpec":
        if factor <= 0.0:
            raise ValueError(f"scale factor must be > 0, got {factor}")
        return RecordedSpec(times=tuple(t / factor for t in self.times))

    def to_string(self) -> str:
        return "recorded:times=" + ";".join(_fmt(t) for t in self.times)


ArrivalSpec = Union[PoissonSpec, BurstySpec, RampSpec, RecordedSpec]

_SPEC_FIELDS = {
    "poisson": ("rate",),
    "bursty": ("rate_on", "rate_off", "period", "duty"),
    "ramp": ("rate0", "rate1", "duration"),
}
_SPEC_TYPES = {"poisson": PoissonSpec, "bursty": BurstySpec, "ramp": RampSpec}


def parse_arrival_spec(text: str) -> ArrivalSpec:
    """Parse ``kind:key=val:key=val`` into a spec, validating ranges."""
    parts = [p for p in text.strip().split(":") if p]
    if not parts:
        raise ValueError("empty arrival spec")
    kind = parts[0].strip().lower()
    if kind == "recorded":
        # different value grammar: one 'times' field holding a
        # semicolon-separated timestamp list (colons are field seps)
        if len(parts) != 2 or not parts[1].startswith("times="):
            raise ValueError(
                "recorded spec must be recorded:times=t0;t1;... "
                f"(got {text!r})")
        body = parts[1][len("times="):]
        try:
            times = tuple(float(v) for v in body.split(";") if v != "")
        except ValueError:
            raise ValueError(
                f"non-numeric timestamp in recorded spec {text!r}")
        return RecordedSpec(times=times)
    if kind not in _SPEC_FIELDS:
        raise ValueError(
            f"unknown arrival kind {kind!r} (want one of "
            f"{sorted(_SPEC_FIELDS)})")
    kwargs: Dict[str, float] = {}
    for part in parts[1:]:
        if "=" not in part:
            raise ValueError(f"malformed arrival field {part!r} "
                             "(want key=value)")
        key, _, val = part.partition("=")
        key = key.strip()
        if key not in _SPEC_FIELDS[kind]:
            raise ValueError(f"unknown field {key!r} for arrival kind "
                             f"{kind!r} (want {_SPEC_FIELDS[kind]})")
        if key in kwargs:
            raise ValueError(f"duplicate field {key!r} in arrival spec")
        try:
            kwargs[key] = float(val)
        except ValueError:
            raise ValueError(
                f"non-numeric value {val!r} for arrival field {key!r}")
    missing = [f for f in _SPEC_FIELDS[kind] if f not in kwargs]
    if missing:
        raise ValueError(f"arrival spec {kind!r} missing fields {missing}")
    spec = _SPEC_TYPES[kind](**kwargs)
    _validate(spec)
    return spec


def _validate(spec: ArrivalSpec) -> None:
    if spec.peak_rate() <= 0.0:
        raise ValueError("arrival spec needs a positive peak rate")
    if isinstance(spec, BurstySpec):
        if spec.period <= 0.0:
            raise ValueError("bursty period must be > 0")
        if not (0.0 < spec.duty <= 1.0):
            raise ValueError("bursty duty must be in (0, 1]")
        if spec.rate_on < 0.0 or spec.rate_off < 0.0:
            raise ValueError("bursty rates must be >= 0")
    elif isinstance(spec, RampSpec):
        if spec.duration <= 0.0:
            raise ValueError("ramp duration must be > 0")
        if spec.rate0 < 0.0 or spec.rate1 < 0.0:
            raise ValueError("ramp rates must be >= 0")
    elif spec.rate <= 0.0:
        raise ValueError("poisson rate must be > 0")


def format_arrival_spec(spec: ArrivalSpec) -> str:
    """Canonical string form — the replay key together with the seed."""
    return spec.to_string()


def spec_to_json(spec: ArrivalSpec) -> Dict[str, object]:
    """JSON-embeddable description for the mingpt-traffic/1 report."""
    out: Dict[str, object] = {"kind": spec.kind}
    if isinstance(spec, RecordedSpec):
        out["n"] = len(spec.times)
        out["duration"] = spec.duration()
    else:
        for field in _SPEC_FIELDS[spec.kind]:
            out[field] = float(getattr(spec, field))
    out["spec"] = spec.to_string()
    out["mean_rate"] = float(spec.mean_rate())
    out["peak_rate"] = float(spec.peak_rate())
    return out


def _stream_seed(seed: int, canonical: str) -> int:
    """Derive a 32-bit RNG seed from (user seed, canonical spec string)
    so distinct specs under one user seed get decorrelated streams while
    the same pair always replays the same trace."""
    return (seed * 1000003 + zlib.crc32(canonical.encode("utf-8"))) % (2**32)


def arrival_times(spec: ArrivalSpec, n: int, seed: int,
                  start: float = 0.0) -> List[float]:
    """Sample ``n`` absolute virtual timestamps from ``spec``.

    Lewis–Shedler thinning against the peak rate: exact for any bounded
    lambda(t), and O(n * peak/mean) draws. Deterministic in
    ``(seed, format_arrival_spec(spec), n, start)``.
    """
    if n <= 0:
        return []
    if isinstance(spec, RecordedSpec):
        # replay, never sample: the recorded gaps ARE the trace
        if n > len(spec.times):
            raise ValueError(
                f"recorded spec holds {len(spec.times)} arrivals, "
                f"{n} requested — size n_requests to the trace")
        return [float(start) + float(t) for t in spec.times[:n]]
    rng = np.random.RandomState(_stream_seed(seed, spec.to_string()))
    lam_max = spec.peak_rate()
    out: List[float] = []
    t = float(start)
    while len(out) < n:
        t += float(rng.exponential(1.0 / lam_max))
        if rng.uniform() * lam_max <= spec.rate_at(t - start):
            out.append(t)
    return out
