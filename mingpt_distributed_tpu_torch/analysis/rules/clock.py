"""GL007 — wall-clock: direct ``time.*`` calls in clock-disciplined
paths.

The port's counterpart of the JAX package's rule. The serving chaos
harness is deterministic (crash and skew tests token-identical, no wall
sleeps) because every scheduling, deadline, backoff and health decision
reads an injectable clock (``VirtualClock``/``WallClock``/``SkewedClock``
in ``serving/fleet.py``, the scheduler's ``clock=`` parameter,
``RetryPolicy.sleep`` in durability). One stray ``time.time()`` in a
scheduling decision and the chaos tests either flake or quietly stop
testing what they claim.

Within the scoped paths (``Config.clock_paths``: ``serving/``,
``training/faults.py`` and the other injected-clock modules), flag
calls to ``time.time``/``time.sleep``/``time.monotonic``/
``time.perf_counter`` (including ``from time import sleep`` aliases),
except:

* inside a class whose name ends in ``Clock`` — that IS the
  abstraction (``WallClock.now`` must read the real clock somewhere);
* ``time.time()`` whose result is bound to a telemetry-timestamp name
  (``ts``, ``timestamp``, ``*_ts``, ``*_timestamp``) — epoch stamps on
  exported records are data, not control flow, and must NOT follow the
  virtual clock (a skewed export timestamp would corrupt real
  telemetry).

References to the functions (``sleep: Callable = time.sleep`` as an
injectable default) are fine — the rule flags *calls*, which is exactly
the line ``durability.RetryPolicy`` already walks.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from mingpt_distributed_tpu_torch.analysis.core import (
    FileContext, Finding, Rule, register_rule,
)

_WALL_FNS = {"time", "sleep", "monotonic", "perf_counter",
             "monotonic_ns", "perf_counter_ns", "time_ns"}


def _wall_call(node: ast.Call, time_aliases: Dict[str, str]) -> Optional[str]:
    """"time.sleep" when this call hits the wall clock, else None."""
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        if f.value.id == "time" and f.attr in _WALL_FNS:
            return f"time.{f.attr}"
    if isinstance(f, ast.Name) and f.id in time_aliases:
        return time_aliases[f.id]
    return None


def _time_aliases(tree: ast.Module) -> Dict[str, str]:
    """``from time import sleep as zzz`` -> {"zzz": "time.sleep"}."""
    out: Dict[str, str] = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom) and n.module == "time":
            for a in n.names:
                if a.name in _WALL_FNS:
                    out[a.asname or a.name] = f"time.{a.name}"
    return out


@register_rule
class WallClockRule(Rule):
    id = "GL007"
    name = "wall-clock"
    help = ("direct time.time/sleep/monotonic/perf_counter call in a "
            "clock-disciplined path — inject the Clock abstraction so "
            "chaos/fault tests stay deterministic and sleep-free")

    def check_file(self, ctx: FileContext) -> List[Finding]:
        if not ctx.config.clock_in_scope(ctx.relpath):
            return []
        aliases = _time_aliases(ctx.tree)
        findings: List[Finding] = []

        def visit(node: ast.AST, in_clock_class: bool,
                  assign_names: Tuple[str, ...]) -> None:
            for child in ast.iter_child_nodes(node):
                clock = in_clock_class
                names = assign_names
                if isinstance(child, ast.ClassDef):
                    clock = child.name.endswith("Clock")
                if isinstance(child, (ast.Assign, ast.AnnAssign,
                                      ast.AugAssign)):
                    targets = child.targets if isinstance(child, ast.Assign) \
                        else [child.target]
                    collected: List[str] = []
                    for t in targets:
                        for el in ast.walk(t):
                            if isinstance(el, ast.Name):
                                collected.append(el.id)
                            elif isinstance(el, ast.Attribute):
                                collected.append(el.attr)
                    names = tuple(collected)
                if isinstance(child, ast.Call) and not clock:
                    hit = _wall_call(child, aliases)
                    if hit is not None:
                        ts_ok = (hit == "time.time" and any(
                            ctx.config.clock_ts_allowed(nm) for nm in names))
                        if not ts_ok:
                            findings.append(self.finding(
                                ctx, child,
                                f"{hit}() called directly in a "
                                f"clock-disciplined path — take an "
                                f"injectable clock/sleep (see "
                                f"serving/fleet.py clocks, "
                                f"durability.RetryPolicy.sleep)"))
                visit(child, clock, names)

        visit(ctx.tree, False, ())
        return findings
