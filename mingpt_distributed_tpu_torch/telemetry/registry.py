"""One metrics registry for the serving stack: typed instruments.

Counterpart of ``mingpt_distributed_tpu/telemetry/registry.py``, the same
classes with the same semantics (the Prometheus data model):

* **Counter** — monotonically non-decreasing; ``inc(n)`` with ``n >= 0``.
* **Gauge** — a value that can go anywhere; ``set(v)``.
* **Histogram** — fixed upper-bound bucket ladder chosen at registration
  (never per-observation); exposition renders cumulative ``_bucket``
  series plus ``_sum``/``_count``.

Families may declare label names; ``family.labels(k=v)`` returns (and
memoises) the child for that label combination. Label-less families
proxy the instrument ops directly (``family.inc(...)``). Library classes
(``serving.metrics.ServingMetrics``) default to a fresh private registry;
an entry point passes one registry to every logger it builds, so one
exposition page (``telemetry/export.py``) covers the process.

Naming convention: every metric is
``mingpt_<subsystem>_<what>[_total|_seconds]``.
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS_S",
    "MetricFamily",
    "MetricsRegistry",
    "RateWindow",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Default latency ladder (seconds): 1ms .. 10s in a 1-2.5-5 progression.
#: Fixed at registration — the whole point of a bucket ladder is that a
#: scrape is comparable across time and across processes.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class RateWindow:
    """Windowed rate of a monotonically increasing marker (steps, tokens).

    ``observe(marker)`` returns the marker's change per second since the
    previous call, or None on the first call / when the marker did not
    advance / when no wall time elapsed (the zero-elapsed guard — two
    observations inside one clock tick must not divide by zero). Shared
    plumbing between the training MetricsLogger (steps/sec → tokens/sec/
    MFU) and ServingMetrics (tokens/sec), so both report rates over the
    same kind of log window.
    """

    def __init__(self) -> None:
        self._last: Optional[Tuple[float, float]] = None

    def observe(self, marker: float, now: Optional[float] = None) -> Optional[float]:
        if now is None:
            now = time.perf_counter()
        rate = None
        if self._last is not None:
            last_t, last_m = self._last
            if marker > last_m and now > last_t:
                rate = (marker - last_m) / (now - last_t)
        self._last = (now, marker)
        return rate


class Counter:
    """Monotonic counter. ``value`` is read by exporters."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0.0
        self._lock = lock

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter decrease not allowed (inc({n}))")
        with self._lock:
            self.value += n


class Gauge:
    """Set-anywhere gauge."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Histogram:
    """Fixed-ladder histogram: per-bucket counts (non-cumulative in
    memory; the exposition layer renders the cumulative ``le`` form),
    plus ``sum``/``count`` so means are derivable without a private
    accumulator next to the histogram."""

    __slots__ = ("uppers", "counts", "sum", "count", "_lock")

    def __init__(self, buckets: Sequence[float], lock: threading.Lock):
        uppers = tuple(float(b) for b in buckets)
        if not uppers:
            raise ValueError("histogram needs at least one bucket bound")
        if list(uppers) != sorted(set(uppers)):
            raise ValueError(f"bucket bounds must strictly increase: {uppers}")
        self.uppers = uppers
        self.counts = [0] * (len(uppers) + 1)  # +1: the implicit +Inf bucket
        self.sum = 0.0
        self.count = 0
        self._lock = lock

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.sum += v
            self.count += 1
            self.counts[bisect.bisect_left(self.uppers, v)] += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(upper_bound, cumulative_count)], ending with (inf, count)."""
        out, acc = [], 0
        with self._lock:
            for u, c in zip(self.uppers, self.counts):
                acc += c
                out.append((u, acc))
            out.append((float("inf"), self.count))
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Ladder-resolution quantile estimate: the smallest bucket upper
        bound at which the cumulative count reaches ``q * count`` — a
        conservative (upper-bound) estimate, which is the right bias for
        SLO gating: a replica is flagged slow no later than its true
        quantile crossing the threshold. None with no observations;
        ``inf`` when the quantile falls in the overflow bucket."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"quantile must be in (0, 1], got {q}")
        with self._lock:
            if not self.count:
                return None
            need = q * self.count
            acc = 0
            for u, c in zip(self.uppers, self.counts):
                acc += c
                if acc >= need:
                    return u
        return float("inf")


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """One named metric with a kind, optional label names, and one child
    instrument per label-value combination. Label-less families proxy the
    child ops (``inc``/``set``/``observe``) and read-outs directly."""

    def __init__(
        self,
        name: str,
        kind: str,
        help: str = "",
        label_names: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
        lock: Optional[threading.Lock] = None,
    ):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = tuple(label_names)
        if kind == "histogram":
            self.buckets = tuple(
                LATENCY_BUCKETS_S if buckets is None else buckets)
        else:
            self.buckets = None
        self._lock = lock or threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.label_names:
            self._children[()] = self._new_child()
        elif kind == "histogram":
            Histogram(self.buckets, self._lock)  # validate the ladder now,
            # not at the first labels() call deep inside serving code

    def _new_child(self):
        if self.kind == "histogram":
            return Histogram(self.buckets, self._lock)
        return _KINDS[self.kind](self._lock)

    def labels(self, **labelvalues: object):
        if set(labelvalues) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(labelvalues)} != declared "
                f"{sorted(self.label_names)}"
            )
        key = tuple(str(labelvalues[ln]) for ln in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
        return child

    @property
    def _default(self):
        if self.label_names:
            raise ValueError(
                f"{self.name} declares labels {self.label_names}; "
                f"use .labels(...)"
            )
        return self._children[()]

    # label-less proxies (AttributeError on kind mismatch is deliberate)
    def inc(self, n: float = 1.0) -> None:
        self._default.inc(n)

    def set(self, v: float) -> None:
        self._default.set(v)

    def observe(self, v: float) -> None:
        self._default.observe(v)

    def cumulative(self) -> List[Tuple[float, int]]:
        return self._default.cumulative()

    def quantile(self, q: float) -> Optional[float]:
        return self._default.quantile(q)

    @property
    def value(self) -> float:
        return self._default.value

    @property
    def sum(self) -> float:
        return self._default.sum

    @property
    def count(self) -> int:
        return self._default.count

    def children(self) -> List[Tuple[Dict[str, str], object]]:
        with self._lock:
            items = list(self._children.items())
        return [
            (dict(zip(self.label_names, key)), child) for key, child in items
        ]


class MetricsRegistry:
    """Get-or-create instrument registry; the unit every exporter reads.

    Re-registering an existing name with identical (kind, labels,
    buckets) returns the existing family — so independent modules can
    name the same metric without coordination — while a conflicting
    redefinition raises (silent kind drift would corrupt dashboards).
    """

    def __init__(self) -> None:
        self._families: Dict[str, MetricFamily] = {}
        self._lock = threading.Lock()

    def _get_or_create(
        self,
        name: str,
        kind: str,
        help: str,
        labels: Sequence[str],
        buckets: Optional[Sequence[float]] = None,
    ) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if (
                    fam.kind != kind
                    or fam.label_names != tuple(labels)
                    or (kind == "histogram"
                        and buckets is not None
                        and fam.buckets != tuple(buckets))
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.label_names} — conflicting "
                        f"redefinition as {kind}{tuple(labels)}"
                    )
                return fam
            fam = MetricFamily(name, kind, help, labels, buckets)
            self._families[name] = fam
            return fam

    def counter(
        self, name: str, help: str = "", labels: Sequence[str] = ()
    ) -> MetricFamily:
        return self._get_or_create(name, "counter", help, labels)

    def gauge(
        self, name: str, help: str = "", labels: Sequence[str] = ()
    ) -> MetricFamily:
        return self._get_or_create(name, "gauge", help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = LATENCY_BUCKETS_S,
        labels: Sequence[str] = (),
    ) -> MetricFamily:
        return self._get_or_create(name, "histogram", help, labels, buckets)

    def collect(self) -> Iterable[MetricFamily]:
        """Families sorted by name — the exposition order."""
        with self._lock:
            fams = list(self._families.values())
        return sorted(fams, key=lambda f: f.name)
