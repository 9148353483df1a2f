"""graftlint engine: file collection, rule execution, suppression and
baseline application, human/JSON rendering.

Counterpart of ``mingpt_distributed_tpu/analysis/engine.py``. The
engine never imports analysed code: everything is ``ast.parse`` over
file bytes, so linting ``serving/engine.py`` never touches a card.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from mingpt_distributed_tpu_torch.analysis.core import (
    SCHEMA,
    Baseline,
    BaselineEntry,
    Config,
    FileContext,
    Finding,
    Suppressions,
    all_rules,
)

#: directories never descended into (fixtures deliberately violate
#: every rule — sweeping them would be the lint linting its own tests)
EXCLUDE_DIRS = {
    "__pycache__", ".git", ".jax_test_cache", ".venv", "node_modules",
    "build", "dist", ".eggs", "lint_fixtures",
}


def collect_files(paths: Sequence[str]) -> List[str]:
    """Expand files/dirs into a sorted, de-duplicated .py file list.
    Explicitly named files are always included (that is how the fixture
    tests lint the corpus EXCLUDE_DIRS hides from sweeps)."""
    out: List[str] = []
    seen = set()

    def add(p: str) -> None:
        rp = os.path.realpath(p)
        if rp not in seen:
            seen.add(rp)
            out.append(p)

    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                add(path)
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in EXCLUDE_DIRS)
            for f in sorted(files):
                if f.endswith(".py"):
                    add(os.path.join(root, f))
    return sorted(out)


@dataclass
class RunResult:
    findings: List[Finding] = field(default_factory=list)
    files_scanned: int = 0
    parse_errors: List[str] = field(default_factory=list)
    stale_baseline: List[BaselineEntry] = field(default_factory=list)

    @property
    def active(self) -> List[Finding]:
        return [f for f in self.findings if f.active]

    @property
    def suppressed_count(self) -> int:
        return sum(1 for f in self.findings if f.suppressed)

    @property
    def baselined_count(self) -> int:
        return sum(1 for f in self.findings if f.baselined)

    @property
    def exit_code(self) -> int:
        return 1 if (self.active or self.parse_errors) else 0

    # -- rendering -----------------------------------------------------
    def to_json(self) -> dict:
        per_rule: Dict[str, int] = {}
        for f in self.active:
            per_rule[f.rule_id] = per_rule.get(f.rule_id, 0) + 1
        return {
            "schema": SCHEMA,
            "summary": {
                "files": self.files_scanned,
                "findings": len(self.active),
                "suppressed": self.suppressed_count,
                "baselined": self.baselined_count,
                "parse_errors": list(self.parse_errors),
                "per_rule": dict(sorted(per_rule.items())),
                "stale_baseline": [e.__dict__ for e in self.stale_baseline],
            },
            "findings": [f.to_dict() for f in self.findings],
        }

    def render_human(self, show_suppressed: bool = False) -> str:
        lines: List[str] = []
        for err in self.parse_errors:
            lines.append(f"error: {err}")
        for f in self.findings:
            if f.active:
                lines.append(f.render())
            elif show_suppressed:
                tag = "suppressed" if f.suppressed else "baselined"
                lines.append(f"{f.render()}  [{tag}]")
        for e in self.stale_baseline:
            lines.append(
                f"warning: stale baseline entry {e.rule} {e.path} "
                f"({e.contains!r}) matched nothing — prune it")
        n = len(self.active)
        lines.append(
            f"graftlint: {self.files_scanned} files, "
            f"{n} finding{'s' if n != 1 else ''} "
            f"({self.suppressed_count} suppressed, "
            f"{self.baselined_count} baselined)")
        return "\n".join(lines)


class Engine:
    """One lint run: fresh rule instances, deterministic output."""

    def __init__(
        self,
        config: Optional[Config] = None,
        baseline: Optional[Baseline] = None,
        select: Optional[Sequence[str]] = None,
        root: Optional[str] = None,
    ):
        self.config = config or Config()
        self.baseline = baseline
        self.root = os.path.realpath(root or os.getcwd())
        rules = all_rules()
        if select:
            wanted = {s.upper() for s in select}
            unknown = wanted - {r.id for r in rules}
            if unknown:
                raise ValueError(f"unknown rule ids: {sorted(unknown)}")
            rules = [r for r in rules if r.id in wanted]
        self.rules = [cls() for cls in rules]

    def _relpath(self, path: str) -> str:
        rp = os.path.realpath(path)
        if rp.startswith(self.root + os.sep):
            rp = rp[len(self.root) + 1:]
        return rp.replace(os.sep, "/")

    def run(self, paths: Sequence[str]) -> RunResult:
        result = RunResult()
        suppressions: Dict[str, Suppressions] = {}
        for path in collect_files(paths):
            relpath = self._relpath(path)
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    src = fh.read()
                tree = ast.parse(src, filename=path)
            except (OSError, SyntaxError, ValueError) as e:
                result.parse_errors.append(f"{relpath}: {e}")
                continue
            result.files_scanned += 1
            lines = src.splitlines()
            suppressions[relpath] = Suppressions(lines)
            ctx = FileContext(relpath=relpath, tree=tree, lines=lines,
                              config=self.config)
            for rule in self.rules:
                result.findings.extend(rule.check_file(ctx))
        for rule in self.rules:
            result.findings.extend(rule.finalize())
        # suppressions, then baseline (a suppressed finding never
        # consumes a baseline entry), then deterministic order
        for f in result.findings:
            sup = suppressions.get(f.path)
            if sup is not None and sup.covers(f):
                f.suppressed = True
        if self.baseline is not None:
            result.stale_baseline = self.baseline.apply(result.findings)
        result.findings.sort(key=Finding.sort_key)
        return result
