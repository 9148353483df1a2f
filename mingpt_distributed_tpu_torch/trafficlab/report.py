"""The versioned ``mingpt-traffic/1`` sweep report.

Counterpart of ``mingpt_distributed_tpu/trafficlab/report.py``: the same
schema, validator, rendering and canonical dump, so a report from either
package validates under the other's validator.

One report captures one load sweep: an arrival-spec shape offered at
each rung of a load ladder, every admission policy replayed on the
IDENTICAL rendered trace per rung (the report embeds the trace sha256
so that claim is checkable), each (rung, policy) cell graded by the
telemetry SLO engine, plus knee location — the first rung where a
named objective fails. Shape::

    {
      "schema": "mingpt-traffic/1",
      "seed": ..., "arrival": {...}, "mix": {...},
      "slo_spec": "...", "knee_objective": "...",
      "chaos_spec": null | "crash:nth=...",
      "fleet": {"n_replicas": N, "n_slots": S, "tick_s": ...},
      "ladder": [f0, f1, ...], "policies": ["fifo", "edf"],
      "rungs": [{"rung": i, "load_factor": f, "offered_rate": r,
                 "n_requests": n, "trace_sha256": "...",
                 "policies": {"fifo": {"slo": <mingpt-slo/1>,
                                       "deadline_hit_rate": ...,
                                       "deadline_requests": ...,
                                       "completed": ..., "shed": ...,
                                       "expired": ..., "errors": ...,
                                       "tokens": ..., "rounds": ...,
                                       "virtual_duration_s": ...}, ...}}],
      "knees": {"fifo": {"ttft_p99": rung-or-null, ...}, ...},
      "knee": {"policy": ..., "objective": ..., "rung": ...,
               "valid": bool} | null
    }

``dump_report`` serializes with sorted keys and no timestamps, so the
same ``(seed, spec)`` always produces a byte-identical file.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

from mingpt_distributed_tpu_torch.telemetry.slo import SLO_SCHEMA

__all__ = [
    "TRAFFIC_SCHEMA",
    "dump_report",
    "headline_knee",
    "locate_knees",
    "render_traffic_report",
    "validate_traffic_report",
]

TRAFFIC_SCHEMA = "mingpt-traffic/1"

_POLICY_CELL_KEYS = frozenset({
    "slo", "deadline_hit_rate", "deadline_requests", "recovered",
    "completed", "shed", "expired", "errors", "tokens", "rounds",
    "virtual_duration_s",
})


def locate_knees(rungs: Sequence[Dict[str, Any]],
                 policies: Sequence[str],
                 ) -> Dict[str, Dict[str, Optional[int]]]:
    """Per policy, per objective name: the first rung index where the
    objective FAILS (``pass`` is False), or None if it never does.
    Rungs where an objective has no data (``pass`` None) neither fail
    nor reset the search — they're skipped."""
    knees: Dict[str, Dict[str, Optional[int]]] = {}
    for policy in policies:
        per_obj: Dict[str, Optional[int]] = {}
        for rung in rungs:
            cell = rung["policies"][policy]
            for row in cell["slo"]["objectives"]:
                name = row["name"]
                per_obj.setdefault(name, None)
                if per_obj[name] is None and row["pass"] is False:
                    per_obj[name] = int(rung["rung"])
        knees[policy] = per_obj
    return knees


def headline_knee(report: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The single knee the CLI prints: ``knee_objective`` under the
    first listed policy. ``valid`` means the textbook shape — passing at
    rung N-1, failing at rung N (a sweep that fails at rung 0 locates
    no knee, it just proves every rung is overloaded)."""
    policies = report["policies"]
    objective = report["knee_objective"]
    if not policies:
        return None
    policy = policies[0]
    rung_idx = report["knees"].get(policy, {}).get(objective)
    if rung_idx is None:
        return None
    valid = False
    if rung_idx > 0:
        prev = report["rungs"][rung_idx - 1]["policies"][policy]
        for row in prev["slo"]["objectives"]:
            if row["name"] == objective:
                valid = row["pass"] is True
    return {"policy": policy, "objective": objective,
            "rung": rung_idx, "valid": valid}


def validate_traffic_report(report: Dict[str, Any],
                            strict: bool = True) -> List[str]:
    """Structural validation; returns problems (raises when ``strict``)."""
    problems: List[str] = []

    def _fail(msg: str) -> None:
        problems.append(msg)

    if report.get("schema") != TRAFFIC_SCHEMA:
        _fail(f"schema is {report.get('schema')!r}, want {TRAFFIC_SCHEMA!r}")
    for key in ("seed", "arrival", "mix", "slo_spec", "knee_objective",
                "fleet", "ladder", "policies", "rungs", "knees"):
        if key not in report:
            _fail(f"missing top-level key {key!r}")
    if problems:
        if strict:
            raise ValueError("invalid traffic report: "
                             + "; ".join(problems))
        return problems
    ladder = report["ladder"]
    if len(ladder) < 1:
        _fail("empty load ladder")
    if any(b <= a for a, b in zip(ladder, ladder[1:])):
        _fail(f"ladder not strictly increasing: {ladder}")
    policies = report["policies"]
    if len(set(policies)) != len(policies) or not policies:
        _fail(f"bad policy list: {policies}")
    if len(report["rungs"]) != len(ladder):
        _fail(f"{len(report['rungs'])} rungs for {len(ladder)}-step ladder")
    for i, rung in enumerate(report["rungs"]):
        where = f"rung {i}"
        if rung.get("rung") != i:
            _fail(f"{where}: index says {rung.get('rung')}")
        if set(rung.get("policies", {})) != set(policies):
            _fail(f"{where}: policy cells {sorted(rung.get('policies', {}))}"
                  f" != declared {sorted(policies)}")
            continue
        if not rung.get("trace_sha256"):
            _fail(f"{where}: missing trace_sha256")
        for policy, cell in rung["policies"].items():
            pwhere = f"{where}/{policy}"
            missing = _POLICY_CELL_KEYS - set(cell)
            if missing:
                _fail(f"{pwhere}: missing keys {sorted(missing)}")
                continue
            slo = cell["slo"]
            if slo.get("schema") != SLO_SCHEMA:
                _fail(f"{pwhere}: embedded SLO schema "
                      f"{slo.get('schema')!r}")
            accounted = (cell["completed"] + cell["shed"]
                         + cell["expired"] + cell["errors"])
            if accounted != rung.get("n_requests"):
                _fail(f"{pwhere}: outcomes sum {accounted} != offered "
                      f"{rung.get('n_requests')}")
            dhr = cell["deadline_hit_rate"]
            if dhr is not None and not 0.0 <= dhr <= 1.0:
                _fail(f"{pwhere}: deadline_hit_rate {dhr} out of [0,1]")
    for policy in policies:
        if policy not in report["knees"]:
            _fail(f"knees missing policy {policy!r}")
    if strict and problems:
        raise ValueError("invalid traffic report: " + "; ".join(problems))
    return problems


def render_traffic_report(report: Dict[str, Any]) -> str:
    """Human-readable sweep table: one line per (rung, policy)."""
    arrival = report["arrival"]
    lines = [
        f"traffic sweep ({report['schema']}): {arrival['spec']} x "
        f"ladder {report['ladder']}, seed {report['seed']}, "
        f"policies {list(report['policies'])}",
        f"  slo: {report['slo_spec']}  (knee objective: "
        f"{report['knee_objective']})"
        + (f"  chaos: {report['chaos_spec']}" if report.get("chaos_spec")
           else "")
        + (f"  net-chaos: {report['net_chaos_spec']} "
           f"({report['fleet'].get('n_hosts', 1)} hosts)"
           if report.get("net_chaos_spec") else ""),
        f"  {'rung':>4} {'offered':>9} {'policy':<6} {'grade':>5} "
        f"{'attain':>7} {'done':>5} {'shed':>5} {'expired':>7} "
        f"{'dl-hit':>7}",
    ]
    for rung in report["rungs"]:
        for policy in report["policies"]:
            cell = rung["policies"][policy]
            slo = cell["slo"]
            att = slo["attainment"]
            dhr = cell["deadline_hit_rate"]
            lines.append(
                f"  {rung['rung']:>4} {rung['offered_rate']:>8.2f}/s "
                f"{policy:<6} {slo['grade']:>5} "
                f"{('n/a' if att is None else format(att, '.2f')):>7} "
                f"{cell['completed']:>5} {cell['shed']:>5} "
                f"{cell['expired']:>7} "
                f"{('n/a' if dhr is None else format(dhr, '.3f')):>7}")
    knee = report.get("knee")
    if knee is None:
        lines.append(f"  knee: not located ({report['knee_objective']} "
                     f"never fails on this ladder)")
    else:
        shape = "pass->fail" if knee["valid"] else "fails from rung 0"
        lines.append(
            f"  knee: {knee['objective']} under {knee['policy']} first "
            f"fails at rung {knee['rung']} ({shape})")
    return "\n".join(lines)


def dump_report(report: Dict[str, Any]) -> str:
    """Canonical serialization: sorted keys, stable indent, trailing
    newline. Byte-identical across same-seed runs by construction —
    nothing in the report reads a wall clock."""
    return json.dumps(report, sort_keys=True, indent=2) + "\n"
