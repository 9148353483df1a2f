"""GL008/GL009 — metric naming and cross-file registry coherence.

The port's counterpart of the JAX package's rules. The unified
``MetricsRegistry`` is one catalog with one naming convention,
``mingpt_<subsystem>_<what>[_total|_seconds]``, which every exporter
reads. A misnamed family quietly
splits the scrape page; a name registered as a counter in one file and
a gauge in another raises deep inside exposition at runtime; a typo'd
name literal in a selftest assertion matches nothing and the assert
tests air.

* **GL008 metric-name** — the literal first argument of a
  ``.counter(...)``/``.gauge(...)``/``.histogram(...)`` registration
  must match ``mingpt_<subsystem>_<what>`` (f-strings are checked by
  their literal prefix, which must cover ``mingpt_<subsystem>_``).
* **GL009 metric-conflict** (cross-file, emitted in ``finalize``) —
  the same family name registered with two different instrument types
  anywhere in the scanned set (registering the same name with the SAME
  type in two files is fine and idiomatic: the registry get-or-creates,
  e.g. ``mingpt_serving_rejected_total`` shared by scheduler and
  fleet); and any standalone ``mingpt_*`` string literal that matches
  no registered family — a typo'd scrape assertion or dashboard key.
  The unregistered-literal check only runs when the scan actually saw
  registrations, so linting a single script never false-positives.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from mingpt_distributed_tpu_torch.analysis.core import (
    FileContext, Finding, Rule, call_name, register_rule,
)

_REGISTER_METHODS = {"counter", "gauge", "histogram"}
_NAME_RE = re.compile(r"^mingpt_[a-z][a-z0-9]*_[a-z0-9_]*[a-z0-9]$")
_PREFIX_RE = re.compile(r"^mingpt_[a-z][a-z0-9]*_")
#: a standalone literal that *looks like* one of our metric names
_LITERAL_RE = re.compile(r"^mingpt_[a-z0-9_]+$")


def _registration(node: ast.Call) -> Optional[Tuple[str, str, bool]]:
    """(name, instrument_type, is_fstring_prefix) when this call
    registers a metric family with a literal-ish name."""
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr in _REGISTER_METHODS):
        return None
    if not node.args:
        return None
    first = node.args[0]
    if isinstance(first, ast.Constant) and isinstance(first.value, str):
        return (first.value, f.attr, False)
    if isinstance(first, ast.JoinedStr) and first.values \
            and isinstance(first.values[0], ast.Constant) \
            and isinstance(first.values[0].value, str):
        return (first.values[0].value, f.attr, True)
    return None


@register_rule
class MetricNameRule(Rule):
    id = "GL008"
    name = "metric-name"
    help = ("registered metric names must match "
            "mingpt_<subsystem>_<what>")

    def check_file(self, ctx: FileContext) -> List[Finding]:
        findings: List[Finding] = []
        for n in ast.walk(ctx.tree):
            if not isinstance(n, ast.Call):
                continue
            reg = _registration(n)
            if reg is None:
                continue
            name, itype, is_prefix = reg
            ok = (_PREFIX_RE.match(name) if is_prefix
                  else _NAME_RE.match(name))
            if not ok:
                shown = f"{name}{{…}}" if is_prefix else name
                findings.append(self.finding(
                    ctx, n,
                    f"metric {itype} name {shown!r} does not follow "
                    f"mingpt_<subsystem>_<what> — one naming scheme is "
                    f"what keeps the scrape page one catalog"))
        return findings


@register_rule
class MetricConflictRule(Rule):
    id = "GL009"
    name = "metric-conflict"
    help = ("one family name registered with two instrument types, or a "
            "mingpt_* literal that matches no registered family (typo'd "
            "scrape assertion)")

    def __init__(self) -> None:
        # name -> (instrument_type, path, line) of first sighting
        self._families: Dict[str, Tuple[str, str, int]] = {}
        self._fstring_prefixes: List[str] = []
        self._conflicts: List[Finding] = []
        # (finding, literal) for post-scan resolution
        self._literals: List[Tuple[Finding, str]] = []

    def check_file(self, ctx: FileContext) -> List[Finding]:
        registration_nodes = set()
        for n in ast.walk(ctx.tree):
            if not isinstance(n, ast.Call):
                continue
            reg = _registration(n)
            if reg is None:
                continue
            registration_nodes.add(id(n.args[0]))
            name, itype, is_prefix = reg
            if is_prefix:
                self._fstring_prefixes.append(name)
                continue
            prev = self._families.get(name)
            if prev is None:
                self._families[name] = (itype, ctx.relpath, n.lineno)
            elif prev[0] != itype:
                self._conflicts.append(self.finding(
                    ctx, n,
                    f"metric {name!r} registered as {itype} here but as "
                    f"{prev[0]} at {prev[1]}:{prev[2]} — exposition "
                    f"would raise a type conflict at runtime"))
        # standalone literals that look like metric names (skip f-string
        # fragments — they are prefixes, not full names — and the
        # registration args themselves)
        parent_join = {id(v) for n in ast.walk(ctx.tree)
                       if isinstance(n, ast.JoinedStr) for v in n.values}
        for n in ast.walk(ctx.tree):
            if not (isinstance(n, ast.Constant) and isinstance(n.value, str)):
                continue
            if id(n) in registration_nodes or id(n) in parent_join:
                continue
            lit = n.value.split("{", 1)[0]
            # the package itself matches the lexical pattern — module
            # paths like "mingpt_distributed_tpu.serving" are not metric
            # names
            if lit.startswith("mingpt_distributed_tpu"):
                continue
            if _LITERAL_RE.match(lit):
                self._literals.append((self.finding(
                    ctx, n,
                    f"metric name literal {lit!r} matches no registered "
                    f"family — typo, or the family was renamed without "
                    f"updating this consumer"), lit))
        return self._conflicts_drain()

    def _conflicts_drain(self) -> List[Finding]:
        out, self._conflicts = self._conflicts, []
        return out

    def finalize(self) -> List[Finding]:
        if not self._families and not self._fstring_prefixes:
            return []  # scan saw no registrations: nothing to check against
        out: List[Finding] = []
        for f, lit in self._literals:
            known = any(lit == fam or lit.startswith(fam + "_")
                        for fam in self._families)
            if not known:
                known = any(lit.startswith(p) for p in self._fstring_prefixes)
            if not known:
                out.append(f)
        return out
