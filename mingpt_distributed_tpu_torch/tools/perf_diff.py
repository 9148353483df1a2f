"""Noise-aware perf-regression diff between two reports of one kind.

Counterpart of ``tools/perf_diff.py``, with its input kinds, verdicts and
exit codes; the attribution reports are validated with the port's own
``telemetry/attribution.validate_attrib_report``.

    python -m mingpt_distributed_tpu_torch.tools.perf_diff A.json B.json
        [--rel-tol F] [--abs-floor-s S] [--json OUT]

Input kinds (both files must be the same kind):

* ``mingpt-attrib/1`` reports (``serve --attrib-json``): rows are matched
  per program family and variant, and four metrics are compared:
  ``flops`` and ``bytes_accessed`` (exact: any drift beyond float noise is
  a real change) plus ``compile_s`` and ``device_s_per_call`` (timing:
  noisy, so a relative tolerance AND an absolute floor must both be
  exceeded before a delta counts). All four are lower-is-better.
* bench reports (``BENCH_r*.json``): the single ``parsed`` metric by
  name, its direction inferred from the name (latency-ish names
  lower-is-better, mfu and throughput higher-is-better); a null value or
  a failed round renders as n/a, never as a regression. The multichip
  extra's ``sharded_serving`` block and the serving probe's ``quantized``
  block are diffed too when both records carry them: bytes exact,
  ``max_slots_*`` exact and higher-is-better, ``*_ms`` leaves with the
  timing noise thresholds.
* ``graftaudit-budgets/1`` documents (the program audit's budgets):
  exact-match on every ``sweep.program.metric`` leaf; any flops or bytes
  growth is a regression.
* ``mingpt-traffic/1`` sweep reports (``traffic --out``): cells matched
  per (rung, cell label), ``deadline_hit_rate`` higher-is-better with the
  noise tolerance and the cost model's ``cost`` exact lower-is-better;
  cells on one side only render n/a.

Verdicts per metric: ``same`` | ``improved`` | ``regressed`` | ``n/a``.
Exit status: 0 when nothing regressed, 1 when anything did, 2 on
malformed input.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from mingpt_distributed_tpu_torch.analysis.program_audit import BUDGETS_SCHEMA
from mingpt_distributed_tpu_torch.telemetry.attribution import (
    ATTRIB_SCHEMA,
    validate_attrib_report,
)

TRAFFIC_SCHEMA = "mingpt-traffic/1"

#: attrib metrics compared per program row, in render order. The bool
#: is "timing?": timing metrics get the noise thresholds, exact ones
#: only float-epsilon slack.
_ATTRIB_METRICS = (
    ("flops", False),
    ("bytes_accessed", False),
    ("compile_s", True),
    ("device_s_per_call", True),
)

#: substrings marking a bench metric as lower-is-better
_LOWER_BETTER_HINTS = ("latency", "seconds", "time", "itl", "ttft")


def classify(path: str, doc: Any) -> str:
    """'attrib' | 'bench' | 'budgets' | 'traffic' (ValueError otherwise)."""
    if isinstance(doc, dict) and doc.get("schema") == ATTRIB_SCHEMA:
        return "attrib"
    if isinstance(doc, dict) and doc.get("schema") == BUDGETS_SCHEMA:
        return "budgets"
    if isinstance(doc, dict) and doc.get("schema") == TRAFFIC_SCHEMA:
        return "traffic"
    if isinstance(doc, dict) and isinstance(doc.get("parsed"), dict) \
            and "metric" in doc["parsed"]:
        return "bench"
    # a failed bench round (rc != 0) has no "parsed" block but is still
    # a bench record — diff it as n/a, don't reject the file
    if isinstance(doc, dict) and {"n", "cmd", "rc", "tail"} <= set(doc):
        return "bench"
    schema = doc.get("schema") if isinstance(doc, dict) else None
    raise ValueError(
        f"{path}: neither a {ATTRIB_SCHEMA} report nor a bench.py "
        f"report (schema={schema!r})")


def _verdict(
    a: Optional[float],
    b: Optional[float],
    rel_tol: float,
    abs_floor: float,
    lower_better: bool = True,
) -> Dict[str, Any]:
    """One metric's delta + verdict. A delta only counts when it clears
    BOTH the relative tolerance (vs the baseline magnitude) and the
    absolute floor — a 30% swing on a 2 microsecond compile is noise, a
    30% swing on 3 seconds is not."""
    if a is None or b is None:
        return {"a": a, "b": b, "delta": None, "verdict": "n/a"}
    delta = b - a
    gate = max(rel_tol * abs(a), abs_floor)
    if abs(delta) <= gate:
        verdict = "same"
    elif (delta > 0) == lower_better:
        verdict = "regressed"
    else:
        verdict = "improved"
    return {"a": a, "b": b, "delta": delta, "verdict": verdict}


def diff_attrib_reports(
    a: Dict[str, Any],
    b: Dict[str, Any],
    rel_tol: float = 0.05,
    abs_floor_s: float = 1e-3,
) -> Dict[str, Any]:
    """Per-program-family diff of two mingpt-attrib/1 reports."""
    for label, rep in (("a", a), ("b", b)):
        try:
            validate_attrib_report(rep)
        except ValueError as e:
            raise ValueError(f"report {label}: {e}") from None

    def _rows(rep):
        out = {}
        for row in rep["programs"]:
            r = dict(row)
            r["device_s_per_call"] = (
                row["device_s"] / row["calls"] if row["calls"] > 0 else None)
            out[(row["family"], row["variant"])] = r
        return out

    rows_a, rows_b = _rows(a), _rows(b)
    keys = list(rows_a)
    keys.extend(k for k in rows_b if k not in rows_a)
    out_rows: List[Dict[str, Any]] = []
    for key in sorted(keys):
        ra, rb = rows_a.get(key), rows_b.get(key)
        metrics = {}
        worst = "same" if (ra and rb) else "n/a"
        for name, timing in _ATTRIB_METRICS:
            cell = _verdict(
                ra.get(name) if ra else None,
                rb.get(name) if rb else None,
                rel_tol if timing else 1e-9,
                abs_floor_s if timing else 0.0,
            )
            metrics[name] = cell
            if cell["verdict"] == "regressed":
                worst = "regressed"
            elif cell["verdict"] == "improved" and worst == "same":
                worst = "improved"
        out_rows.append({
            "family": key[0],
            "variant": key[1],
            "metrics": metrics,
            "verdict": worst,
        })
    return {
        "schema": f"{ATTRIB_SCHEMA}-diff",
        "rel_tol": rel_tol,
        "abs_floor_s": abs_floor_s,
        "programs": out_rows,
        "regressions": sum(
            1 for r in out_rows if r["verdict"] == "regressed"),
    }


def _sharded_serving_rows(
    a: Dict[str, Any],
    b: Dict[str, Any],
    rel_tol: float,
) -> List[Dict[str, Any]]:
    """Diff rows for the multichip ``sharded_serving`` block when both
    reports carry one; [] otherwise, so old BENCH files diff
    exactly as before. Numeric leaves are flattened to dotted names
    (``tp2.kv_pool_bytes_per_device``). Byte counts and ratios are
    layout facts — exact, any drift is a real placement change; the
    ``*_ms`` leaves are CPU timings and get the relative tolerance plus
    a 0.05 ms floor. All leaves are lower-is-better (bytes per device
    IS the metric the sharding exists to shrink)."""
    sa = (a.get("multichip") or {}).get("sharded_serving")
    sb = (b.get("multichip") or {}).get("sharded_serving")
    if not (isinstance(sa, dict) and isinstance(sb, dict)):
        return []

    def _flatten(d, prefix=""):
        out = {}
        for k in sorted(d):
            v = d[k]
            if isinstance(v, dict):
                out.update(_flatten(v, f"{prefix}{k}."))
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                out[f"{prefix}{k}"] = float(v)
        return out

    fa, fb = _flatten(sa), _flatten(sb)
    rows = []
    for name in sorted(set(fa) | set(fb)):
        timing = name.endswith("_ms")
        cell = _verdict(
            fa.get(name), fb.get(name),
            rel_tol if timing else 1e-9,
            0.05 if timing else 0.0,
        )
        rows.append({
            "metric": f"sharded_serving.{name}",
            "unit": "ms" if timing else None,
            "direction": "lower_better",
            **cell,
        })
    return rows


def _quantized_rows(
    a: Dict[str, Any],
    b: Dict[str, Any],
    rel_tol: float,
) -> List[Dict[str, Any]]:
    """Diff rows for the serving probe's ``quantized`` block when both
    reports carry one; [] otherwise, so old BENCH files diff
    exactly as before. Bytes-per-slot and the bytes ratio are layout
    facts — exact, lower-is-better (shrinking the pool is the point of
    quantizing); ``max_slots_*`` is the slots-per-chip multiplier the
    feature exists to raise, so it is exact and HIGHER-is-better; the
    ``*_ms`` decode timings get the relative tolerance plus the same
    0.05 ms floor the sharded_serving rows use."""
    qa = (a.get("serving") or {}).get("quantized")
    qb = (b.get("serving") or {}).get("quantized")
    if not (isinstance(qa, dict) and isinstance(qb, dict)):
        return []
    rows = []
    for name in sorted(set(qa) | set(qb)):
        va, vb = qa.get(name), qb.get(name)
        if not all(isinstance(v, (int, float)) and not isinstance(v, bool)
                   for v in (va, vb) if v is not None):
            continue  # kv_dtype and any other string leaves
        timing = name.endswith("_ms")
        higher = "slots" in name
        cell = _verdict(
            None if va is None else float(va),
            None if vb is None else float(vb),
            rel_tol if timing else 1e-9,
            0.05 if timing else 0.0,
            lower_better=not higher,
        )
        rows.append({
            "metric": f"quantized.{name}",
            "unit": "ms" if timing else None,
            "direction": "higher_better" if higher else "lower_better",
            **cell,
        })
    return rows


def diff_budget_reports(
    a: Dict[str, Any],
    b: Dict[str, Any],
) -> Dict[str, Any]:
    """Diff two graftaudit budgets documents (``program_budgets.json``).

    Budgets are flops / bytes-accessed per program per sweep (the JAX
    package's ``cost_analysis``, the port's analytic counts): properties
    of the program, not measurements, so
    the comparison is EXACT: no relative tolerance, no absolute floor,
    any drift is a real program change. Both metrics are lower-is-better
    (a rewrite that halves decode bytes is an improvement; one that
    doubles them is the regression this diff exists to name). A program
    present on only one side renders n/a, never a regression — adding or
    retiring a family is an audit-coverage event, not a perf one."""
    for label, doc in (("a", a), ("b", b)):
        if doc.get("schema") != BUDGETS_SCHEMA or \
                not isinstance(doc.get("sweeps"), dict):
            raise ValueError(
                f"report {label}: not a {BUDGETS_SCHEMA} document")

    def _flatten(doc):
        out = {}
        for sweep in sorted(doc["sweeps"]):
            for prog, metrics in sorted(doc["sweeps"][sweep].items()):
                for metric in ("flops", "bytes_accessed"):
                    v = (metrics or {}).get(metric)
                    out[f"{sweep}.{prog}.{metric}"] = (
                        None if v is None else float(v))
        return out

    fa, fb = _flatten(a), _flatten(b)
    rows = []
    for name in sorted(set(fa) | set(fb)):
        cell = _verdict(fa.get(name), fb.get(name), 1e-9, 0.0)
        rows.append({
            "metric": name,
            "unit": None,
            "direction": "lower_better",
            **cell,
        })
    return {
        "schema": f"{BUDGETS_SCHEMA}-diff",
        "rel_tol": 0.0,
        "metrics": rows,
        "regressions": sum(
            1 for r in rows if r["verdict"] == "regressed"),
    }


def diff_traffic_reports(
    a: Dict[str, Any],
    b: Dict[str, Any],
    rel_tol: float = 0.05,
) -> Dict[str, Any]:
    """Diff two mingpt-traffic/1 sweep reports per (rung, cell label).

    ``deadline_hit_rate`` is HIGHER-is-better with the relative noise
    tolerance (comparing two *configurations* legitimately perturbs a
    handful of requests); the cost model's ``cost`` scalar is exact
    lower-is-better — it is integer-derived and byte-stable on
    VirtualClock, so any drift is a real behaviour change. A cell (or
    the ``cost`` block, in pre-controller reports) present on only one
    side renders n/a, never a regression."""
    for label, doc in (("a", a), ("b", b)):
        if doc.get("schema") != TRAFFIC_SCHEMA or \
                not isinstance(doc.get("rungs"), list):
            raise ValueError(
                f"report {label}: not a {TRAFFIC_SCHEMA} report")

    def _cells(doc):
        out = {}
        for rung in doc["rungs"]:
            for cell_label, cell in sorted(
                    rung.get("policies", {}).items()):
                out[(int(rung["rung"]), cell_label)] = cell
        return out

    ca, cb = _cells(a), _cells(b)
    rows = []
    for key in sorted(set(ca) | set(cb)):
        rung, cell_label = key
        xa, xb = ca.get(key), cb.get(key)
        hit = _verdict(
            None if xa is None else xa.get("deadline_hit_rate"),
            None if xb is None else xb.get("deadline_hit_rate"),
            rel_tol, 0.0, lower_better=False)
        rows.append({
            "metric": f"rung{rung}.{cell_label}.deadline_hit_rate",
            "unit": None, "direction": "higher_better", **hit})
        cost = _verdict(
            None if xa is None else (xa.get("cost") or {}).get("cost"),
            None if xb is None else (xb.get("cost") or {}).get("cost"),
            1e-9, 0.0)
        rows.append({
            "metric": f"rung{rung}.{cell_label}.cost",
            "unit": None, "direction": "lower_better", **cost})
    return {
        "schema": f"{TRAFFIC_SCHEMA}-diff",
        "rel_tol": rel_tol,
        "metrics": rows,
        "regressions": sum(
            1 for r in rows if r["verdict"] == "regressed"),
    }


def diff_bench_reports(
    a: Dict[str, Any],
    b: Dict[str, Any],
    rel_tol: float = 0.05,
) -> Dict[str, Any]:
    """Diff two bench.py reports on their single parsed metric, plus
    the multichip ``sharded_serving`` leaves when both reports have
    them. A report without a ``parsed`` block (a failed round)
    contributes a null value — n/a, never a regression."""
    pa = a.get("parsed") or {}
    pb = b.get("parsed") or {}
    name = pa.get("metric") or pb.get("metric") or "?"
    if pa.get("metric") and pb.get("metric") \
            and pa["metric"] != pb["metric"]:
        raise ValueError(
            f"bench reports measure different metrics: "
            f"{pa.get('metric')!r} vs {pb.get('metric')!r}")
    lower = any(h in name for h in _LOWER_BETTER_HINTS)
    cell = _verdict(pa.get("value"), pb.get("value"), rel_tol, 0.0,
                    lower_better=lower)
    rows = [{
        "metric": name,
        "unit": pa.get("unit"),
        "direction": "lower_better" if lower else "higher_better",
        **cell,
    }]
    rows.extend(_sharded_serving_rows(a, b, rel_tol))
    rows.extend(_quantized_rows(a, b, rel_tol))
    return {
        "schema": "mingpt-bench/1-diff",
        "rel_tol": rel_tol,
        "metrics": rows,
        "regressions": sum(
            1 for r in rows if r["verdict"] == "regressed"),
    }


def render_diff(diff: Dict[str, Any]) -> str:
    """render_slo_diff column idiom: one line per compared metric."""

    def _cell(v: Optional[float]) -> str:
        return "n/a" if v is None else f"{v:.6g}"

    lines = [f"Perf diff ({diff['schema']}): "
             f"{diff['regressions']} regression(s)"]
    lines.append(f"  {'program / metric':<34} {'a':>12} {'b':>12} "
                 f"{'delta':>12}  verdict")
    if "programs" in diff:
        for row in diff["programs"]:
            name = row["family"] + (f":{row['variant']}"
                                    if row["variant"] else "")
            lines.append(f"  {name:<34} {'':>12} {'':>12} {'':>12}  "
                         f"{row['verdict']}")
            for metric, _ in _ATTRIB_METRICS:
                m = row["metrics"][metric]
                lines.append(
                    f"    {metric:<32} {_cell(m['a']):>12} "
                    f"{_cell(m['b']):>12} {_cell(m['delta']):>12}  "
                    f"{m['verdict']}")
    else:
        for m in diff["metrics"]:
            lines.append(
                f"  {m['metric']:<34} {_cell(m['a']):>12} "
                f"{_cell(m['b']):>12} {_cell(m['delta']):>12}  "
                f"{m['verdict']} ({m['direction']})")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perf_diff", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("report_a", help="baseline report (.json)")
    ap.add_argument("report_b", help="candidate report (.json)")
    ap.add_argument("--rel-tol", type=float, default=0.05,
                    help="relative noise tolerance on timing metrics "
                         "(default 0.05 = 5%%)")
    ap.add_argument("--abs-floor-s", type=float, default=1e-3,
                    help="absolute floor (seconds) a timing delta must "
                         "also clear (default 1ms)")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="also write the diff document to OUT")
    args = ap.parse_args(argv)
    docs = []
    for path in (args.report_a, args.report_b):
        try:
            with open(path) as f:
                docs.append(json.load(f))
        except (OSError, ValueError) as e:
            print(f"cannot read report {path}: {e}", file=sys.stderr)
            return 2
    try:
        kinds = [classify(p, d)
                 for p, d in zip((args.report_a, args.report_b), docs)]
        if kinds[0] != kinds[1]:
            raise ValueError(
                f"cannot diff a {kinds[0]} report against a {kinds[1]} "
                f"report")
        if kinds[0] == "attrib":
            diff = diff_attrib_reports(
                docs[0], docs[1], rel_tol=args.rel_tol,
                abs_floor_s=args.abs_floor_s)
        elif kinds[0] == "budgets":
            diff = diff_budget_reports(docs[0], docs[1])
        elif kinds[0] == "traffic":
            diff = diff_traffic_reports(
                docs[0], docs[1], rel_tol=args.rel_tol)
        else:
            diff = diff_bench_reports(
                docs[0], docs[1], rel_tol=args.rel_tol)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    print(render_diff(diff))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(diff, f, sort_keys=True, indent=2)
            f.write("\n")
    return 1 if diff["regressions"] else 0


if __name__ == "__main__":
    sys.exit(main())
