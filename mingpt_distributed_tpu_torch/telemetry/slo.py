"""SLO engine: grade named latency and availability objectives from exact
per-request trace durations.

The port's own copy of ``mingpt_distributed_tpu/telemetry/slo.py`` (same
grammar, grades and ``mingpt-slo/1`` report). The process histograms
(``Histogram.quantile``) answer from a fixed bucket ladder, whose upper
bound can overstate the true quantile by a bucket's width; the trace
recorder keeps every finished request's exact TTFT and inter-token gaps,
so attainment is computed here from the real order statistics
(``exact_quantile``) and the shed rate from outcome counts.

Spec grammar (``--slo`` and ``parse_slo_spec``)::

    ttft_p99<=0.5,itl_p99<=0.1,shed_rate<=0.05

Metrics: ``ttft_pNN`` (seconds, per-request time to first token),
``itl_pNN`` (seconds, inter-token gaps pooled over requests),
``recovery_pNN`` (seconds from a replica fault to the replacement's first
token; only requests a crash re-routed carry it, so a one-server run has
no sample), ``shed_rate`` and ``error_rate`` (fractions of all finished
requests).
"""

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

SLO_SCHEMA = "mingpt-slo/1"

DEFAULT_SLO_SPEC = "ttft_p99<=0.5,itl_p99<=0.1,shed_rate<=0.05"

_METRIC_RE = re.compile(r"^(ttft|itl|recovery)_p(\d{1,2})$")
_RATE_METRICS = ("shed_rate", "error_rate")

#: grade ladder: fraction of evaluable objectives attained -> letter
_GRADES = ((1.0, "A"), (0.8, "B"), (0.6, "C"), (0.4, "D"))


@dataclass(frozen=True)
class SLObjective:
    """One named objective: ``metric <= threshold``."""

    name: str
    metric: str
    threshold: float

    def __post_init__(self):
        if not _METRIC_RE.match(self.metric) and \
                self.metric not in _RATE_METRICS:
            raise ValueError(
                f"unknown SLO metric {self.metric!r} (want ttft_pNN, "
                f"itl_pNN, recovery_pNN, shed_rate or error_rate)")
        if not math.isfinite(self.threshold) or self.threshold < 0:
            raise ValueError(
                f"SLO threshold must be finite and >= 0, "
                f"got {self.threshold!r}")


def parse_slo_spec(spec: str) -> Tuple[SLObjective, ...]:
    """Parse ``metric<=threshold[,metric<=threshold...]``; the literal
    spec ``default`` expands to DEFAULT_SLO_SPEC."""
    if spec.strip() == "default":
        spec = DEFAULT_SLO_SPEC
    objectives = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "<=" not in part:
            raise ValueError(f"bad SLO clause {part!r}: want "
                             f"'metric<=threshold'")
        metric, _, raw = part.partition("<=")
        try:
            threshold = float(raw)
        except ValueError:
            raise ValueError(
                f"bad SLO threshold {raw!r} in {part!r}") from None
        metric = metric.strip()
        objectives.append(SLObjective(metric, metric, threshold))
    if not objectives:
        raise ValueError(f"SLO spec {spec!r} names no objectives")
    return tuple(objectives)


def exact_quantile(values: Sequence[float], q: float) -> Optional[float]:
    """Exact order-statistic quantile (nearest-rank on the sorted
    sample) — contrast with Histogram.quantile's bucket upper bound."""
    if not values:
        return None
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    xs = sorted(float(v) for v in values)
    rank = max(1, math.ceil(q * len(xs)))
    return xs[rank - 1]


def _observe(metric: str, requests: Sequence[Dict[str, Any]],
             ) -> Optional[float]:
    total = len(requests)
    m = _METRIC_RE.match(metric)
    if m is not None:
        field, pct = m.group(1), int(m.group(2)) / 100.0
        if field == "ttft":
            vals = [r["ttft_s"] for r in requests
                    if r.get("ttft_s") is not None]
        elif field == "recovery":
            # only requests a fault actually re-routed carry the sample
            # (fault observed -> first token from the replacement)
            vals = [r["recovery_s"] for r in requests
                    if r.get("recovery_s") is not None]
        else:
            vals = [g for r in requests for g in (r.get("itl_s") or [])]
        return exact_quantile(vals, pct)
    if total == 0:
        return None
    if metric == "shed_rate":
        return sum(1 for r in requests
                   if r.get("outcome") == "shed") / total
    if metric == "error_rate":
        bad = sum(1 for r in requests
                  if r.get("outcome") not in ("length", "eos", "shed"))
        return bad / total
    raise ValueError(f"unknown SLO metric {metric!r}")


def evaluate_slos(requests: Sequence[Dict[str, Any]],
                  objectives: Sequence[SLObjective],
                  ) -> Dict[str, Any]:
    """Grade ``objectives`` against per-request trace summaries (the
    TraceRecorder's ``completed_requests()`` or ``request`` records
    loaded from a mingpt-trace/1 JSONL).  Objectives with no data are
    reported but excluded from the grade."""
    requests = list(requests)
    rows = []
    evaluable = attained = 0
    for obj in objectives:
        observed = _observe(obj.metric, requests)
        ok: Optional[bool] = None
        margin: Optional[float] = None
        if observed is not None:
            ok = observed <= obj.threshold
            margin = obj.threshold - observed
            evaluable += 1
            attained += int(ok)
        rows.append({"name": obj.name, "metric": obj.metric,
                     "threshold": obj.threshold, "observed": observed,
                     "pass": ok, "margin": margin})
    attainment = (attained / evaluable) if evaluable else None
    grade = "n/a"
    if attainment is not None:
        grade = "F"
        for floor, letter in _GRADES:
            if attainment >= floor:
                grade = letter
                break
    outcomes: Dict[str, int] = {}
    for r in requests:
        o = str(r.get("outcome"))
        outcomes[o] = outcomes.get(o, 0) + 1
    return {
        "schema": SLO_SCHEMA,
        "requests": len(requests),
        "outcomes": outcomes,
        "objectives": rows,
        "evaluable": evaluable,
        "attained": attained,
        "attainment": attainment,
        "grade": grade,
    }


def render_slo_report(report: Dict[str, Any]) -> str:
    """Human-readable graded report (one block, stable layout)."""
    lines = [f"SLO report ({report['schema']}): grade "
             f"{report['grade']} — {report['attained']}/"
             f"{report['evaluable']} objectives attained over "
             f"{report['requests']} requests"]
    if report["outcomes"]:
        parts = ", ".join(f"{k}={v}" for k, v in
                          sorted(report["outcomes"].items()))
        lines.append(f"  outcomes: {parts}")
    for row in report["objectives"]:
        if row["observed"] is None:
            lines.append(f"  [ n/a  ] {row['name']:<12} "
                         f"<= {row['threshold']:g}  (no data)")
            continue
        verdict = "PASS" if row["pass"] else "FAIL"
        lines.append(
            f"  [ {verdict} ] {row['name']:<12} <= {row['threshold']:g}"
            f"  observed {row['observed']:.6g}"
            f"  margin {row['margin']:+.6g}")
    return "\n".join(lines)


def diff_slo_reports(a: Dict[str, Any], b: Dict[str, Any],
                     ) -> Dict[str, Any]:
    """Per-objective delta between two mingpt-slo/1 reports (e.g. two
    ``serve.py --slo-json`` runs, or one run before/after a change).

    Objectives are matched by name; rows present in only one report get
    ``observed`` None on the other side and no delta. ``delta`` is
    ``b.observed - a.observed`` (negative = b is better for these
    lower-is-better metrics); ``verdict`` summarizes the pass/fail
    transition (``same``, ``fixed``, ``regressed``, ``n/a``)."""
    for label, rep in (("a", a), ("b", b)):
        if rep.get("schema") != SLO_SCHEMA:
            raise ValueError(
                f"report {label} is not {SLO_SCHEMA}: "
                f"schema={rep.get('schema')!r}")
    rows_a = {row["name"]: row for row in a["objectives"]}
    rows_b = {row["name"]: row for row in b["objectives"]}
    names = list(rows_a)
    names.extend(n for n in rows_b if n not in rows_a)
    out_rows = []
    for name in names:
        ra, rb = rows_a.get(name), rows_b.get(name)
        oa = ra.get("observed") if ra else None
        ob = rb.get("observed") if rb else None
        delta = (ob - oa) if (oa is not None and ob is not None) else None
        pa = ra.get("pass") if ra else None
        pb = rb.get("pass") if rb else None
        if pa is None or pb is None:
            verdict = "n/a"
        elif pa == pb:
            verdict = "same"
        elif pb:
            verdict = "fixed"
        else:
            verdict = "regressed"
        out_rows.append({
            "name": name,
            "metric": (ra or rb)["metric"],
            "threshold": (ra or rb)["threshold"],
            "observed_a": oa,
            "observed_b": ob,
            "delta": delta,
            "pass_a": pa,
            "pass_b": pb,
            "verdict": verdict,
        })
    return {
        "schema": f"{SLO_SCHEMA}-diff",
        "requests_a": a["requests"],
        "requests_b": b["requests"],
        "grade_a": a["grade"],
        "grade_b": b["grade"],
        "objectives": out_rows,
    }


def render_slo_diff(diff: Dict[str, Any]) -> str:
    """Human-readable per-objective delta table for ``diff_slo_reports``."""
    lines = [f"SLO diff ({diff['schema']}): grade {diff['grade_a']} -> "
             f"{diff['grade_b']}  (requests {diff['requests_a']} -> "
             f"{diff['requests_b']})"]
    lines.append(f"  {'objective':<14} {'threshold':>10} {'a':>12} "
                 f"{'b':>12} {'delta':>12}  verdict")
    for row in diff["objectives"]:

        def _cell(v: Optional[float]) -> str:
            return "n/a" if v is None else f"{v:.6g}"

        lines.append(
            f"  {row['name']:<14} {row['threshold']:>10g} "
            f"{_cell(row['observed_a']):>12} {_cell(row['observed_b']):>12} "
            f"{_cell(row['delta']):>12}  {row['verdict']}")
    return "\n".join(lines)


def load_trace_requests(path: str) -> List[Dict[str, Any]]:
    """Pull the per-request summaries out of a mingpt-trace/1 JSONL
    (strictly validated) for offline SLO evaluation."""
    from .tracing import load_trace_jsonl

    traces = load_trace_jsonl(path)
    return [tr["request"] for tr in traces.values()]
