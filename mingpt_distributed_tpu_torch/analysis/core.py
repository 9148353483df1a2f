"""graftlint core: findings, the rule registry, scoping config,
inline suppressions, and the baseline file format.

Counterpart of ``mingpt_distributed_tpu/analysis/core.py``, with the same
``Finding``, ``Config``, ``Rule``, registry, suppression grammar and
baseline format; the scopes point at the port's package.

* **Pure ``ast``**: rules receive a parsed tree and its source lines,
  never an imported module, so linting ``serving/engine.py`` never
  touches a card.
* **Stable IDs**: every rule owns a ``GLxxx`` ID that appears in
  suppression comments and baseline entries; the ID (not the class name)
  is the key.
* **Deterministic output**: findings sort by (path, line, col, id); two
  runs over the same tree produce byte-identical reports.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

SCHEMA = "graftlint/1"
BASELINE_SCHEMA = "graftlint-baseline/1"

#: exit codes (the JAX package's: consumers key on these)
EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_USAGE = 2


# ---------------------------------------------------------------------
# Findings
# ---------------------------------------------------------------------


@dataclass
class Finding:
    """One rule violation at one source location."""

    rule_id: str
    rule_name: str
    path: str                 # repo-relative posix path
    line: int                 # 1-based
    col: int                  # 0-based (ast convention)
    message: str
    end_line: int = 0         # last physical line of the flagged node
    source: str = ""          # stripped text of the flagged line
    suppressed: bool = False  # inline `# graftlint: disable=`
    baselined: bool = False   # matched a baseline entry

    def __post_init__(self):
        if not self.end_line:
            self.end_line = self.line

    @property
    def active(self) -> bool:
        """True when this finding should fail the gate."""
        return not (self.suppressed or self.baselined)

    def sort_key(self) -> Tuple[str, int, int, str]:
        return (self.path, self.line, self.col, self.rule_id)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule_id,
            "name": self.rule_name,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "source": self.source,
            "suppressed": self.suppressed,
            "baselined": self.baselined,
        }

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col + 1}: "
                f"{self.rule_id} [{self.rule_name}] {self.message}")


# ---------------------------------------------------------------------
# Scoping config
# ---------------------------------------------------------------------


def _match_any(relpath: str, patterns: Sequence[str]) -> bool:
    """Substring match against a posix relpath — ``"serving/"`` matches
    every file under any ``serving`` directory; a full filename pattern
    like ``"training/faults.py"`` matches exactly that module."""
    return any(p in relpath for p in patterns)


@dataclass
class Config:
    """Per-rule path scopes and allowlists: the defaults encode the port's
    layout; the fixture tests pass their own scopes."""

    # GL007: paths where wall-clock calls must go through an injected
    # clock (substring matches, as in the JAX package): the serving
    # fleet, scheduler and procfleet (faults land as clock skew or raised
    # verdicts, never wall sleeps; socket timeouts are connection
    # attributes and stay allowed), the fault injector, the tracing,
    # flight-recorder and attribution modules (every timestamp arrives
    # from the caller), the traffic lab (arrival schedules are virtual
    # timestamps) and the control plane (its decisions read snapshot
    # timestamps off the router's clock)
    clock_paths: Tuple[str, ...] = (
        "serving/",
        "serving/procfleet/",
        "serving/procfleet/hostplane.py",
        "training/faults.py",
        "telemetry/tracing.py",
        "telemetry/flightrec.py",
        "telemetry/attribution.py",
        "trafficlab/",
        "control/",
    )
    # GL007: time.time() results bound to these names are telemetry
    # timestamps (epoch stamps on records), not scheduling decisions
    clock_ts_names: Tuple[str, ...] = (
        r"^ts$", r"^timestamp$", r".*_ts$", r".*_timestamp$",
    )
    # GL010: library paths where bare print() is banned (the library logs
    # through telemetry.spans.log_event)
    print_paths: Tuple[str, ...] = ("mingpt_distributed_tpu_torch/",)
    # GL010: the modules whose job is to print: this package's reports,
    # log_event itself, and the port's command lines
    print_exempt_paths: Tuple[str, ...] = (
        "mingpt_distributed_tpu_torch/analysis/",
        "telemetry/spans.py",
        "mingpt_distributed_tpu_torch/train.py",
        "mingpt_distributed_tpu_torch/serve.py",
        "mingpt_distributed_tpu_torch/sample.py",
        "mingpt_distributed_tpu_torch/traffic.py",
        "mingpt_distributed_tpu_torch/tools/",
    )

    def clock_in_scope(self, relpath: str) -> bool:
        return _match_any(relpath, self.clock_paths)

    def clock_ts_allowed(self, name: str) -> bool:
        return any(re.match(p, name) for p in self.clock_ts_names)

    def print_in_scope(self, relpath: str) -> bool:
        return (_match_any(relpath, self.print_paths)
                and not _match_any(relpath, self.print_exempt_paths))


def call_name(node: ast.AST) -> str:
    """Dotted name of a call target: ``torch.cuda.synchronize`` ->
    "torch.cuda.synchronize", ``self._f`` -> "self._f"; "" when not a
    simple dotted chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


# ---------------------------------------------------------------------
# Rule registry
# ---------------------------------------------------------------------


class Rule:
    """Base class. Subclasses set ``id``/``name``/``help`` and override
    ``check_file``; rules needing cross-file state accumulate it across
    ``check_file`` calls and emit in ``finalize`` (the engine
    instantiates a fresh rule object per run, so state never leaks
    between runs)."""

    id: str = ""
    name: str = ""
    help: str = ""

    def check_file(self, ctx: "FileContext") -> List[Finding]:
        return []

    def finalize(self) -> List[Finding]:
        return []

    # -- helpers shared by every rule ----------------------------------
    def finding(self, ctx: "FileContext", node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            rule_id=self.id,
            rule_name=self.name,
            path=ctx.relpath,
            line=line,
            col=getattr(node, "col_offset", 0),
            end_line=getattr(node, "end_lineno", line) or line,
            message=message,
            source=ctx.line_text(line),
        )


@dataclass
class FileContext:
    """Everything a rule sees for one file."""

    relpath: str
    tree: ast.Module
    lines: List[str]
    config: Config

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""


_RULES: Dict[str, type] = {}
_ID_RE = re.compile(r"^GL\d{3}$")


def register_rule(cls: type) -> type:
    """Class decorator adding a rule to the global registry. IDs are
    claimed forever: re-registering an ID with a different class is a
    programming error, not a merge strategy."""
    if not _ID_RE.match(getattr(cls, "id", "")):
        raise ValueError(f"rule {cls.__name__} needs an id matching GLxxx")
    prev = _RULES.get(cls.id)
    if prev is not None and prev is not cls:
        raise ValueError(
            f"rule id {cls.id} already registered by {prev.__name__}")
    _RULES[cls.id] = cls
    return cls


def all_rules() -> List[type]:
    """Registered rule classes, by ID (import side effect: registers)."""
    import mingpt_distributed_tpu_torch.analysis.rules  # noqa: F401
    return [_RULES[k] for k in sorted(_RULES)]


def get_rule(rule_id: str) -> type:
    import mingpt_distributed_tpu_torch.analysis.rules  # noqa: F401
    return _RULES[rule_id]


# ---------------------------------------------------------------------
# Inline suppressions
# ---------------------------------------------------------------------

_DISABLE_RE = re.compile(
    r"#\s*graftlint:\s*(disable|disable-next|disable-file)"
    r"\s*=\s*([A-Za-z0-9_,\s]+)")


class Suppressions:
    """Parsed ``# graftlint:`` comments for one file.

    * ``disable=GL001[,GL002]`` — suppresses findings whose flagged node
      touches that physical line;
    * ``disable-next=GL001`` — suppresses findings starting on the next
      line (for statements where a trailing comment won't fit);
    * ``disable-file=GL001`` — suppresses the rule for the whole file
      (only honoured in the first 20 lines, next to the docstring, so a
      reviewer can't miss it).

    ``all`` is accepted in place of an ID list.
    """

    def __init__(self, lines: Sequence[str]):
        self.on_line: Dict[int, set] = {}
        self.next_line: Dict[int, set] = {}
        self.whole_file: set = set()
        for i, text in enumerate(lines, start=1):
            m = _DISABLE_RE.search(text)
            if not m:
                continue
            kind = m.group(1)
            ids = {t.strip().upper() for t in m.group(2).split(",") if t.strip()}
            if kind == "disable":
                self.on_line.setdefault(i, set()).update(ids)
            elif kind == "disable-next":
                self.next_line.setdefault(i + 1, set()).update(ids)
            elif kind == "disable-file" and i <= 20:
                self.whole_file.update(ids)

    def _hit(self, ids: set, rule_id: str) -> bool:
        return rule_id in ids or "ALL" in ids

    def covers(self, f: Finding) -> bool:
        if self._hit(self.whole_file, f.rule_id):
            return True
        if self._hit(self.next_line.get(f.line, set()), f.rule_id):
            return True
        # a trailing comment anywhere on the flagged statement counts —
        # multi-line calls put it wherever black leaves room
        for ln in range(f.line, f.end_line + 1):
            if self._hit(self.on_line.get(ln, set()), f.rule_id):
                return True
        return False


# ---------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------


@dataclass
class BaselineEntry:
    rule: str
    path: str            # repo-relative posix path (suffix-matched)
    contains: str        # substring of the flagged source line
    justification: str   # required — an unexplained grandfather rots

    def matches(self, f: Finding) -> bool:
        return (f.rule_id == self.rule
                and (f.path == self.path or f.path.endswith("/" + self.path))
                and self.contains in f.source)


@dataclass
class Baseline:
    """Checked-in grandfathered findings. Matching is content-anchored
    (rule, path, line *text*) rather than line-numbered, so unrelated
    edits above a grandfathered site don't invalidate the baseline."""

    entries: List[BaselineEntry] = field(default_factory=list)
    path: Optional[str] = None

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, "r", encoding="utf-8") as fh:
            raw = json.load(fh)
        if raw.get("schema") != BASELINE_SCHEMA:
            raise ValueError(
                f"{path}: baseline schema {raw.get('schema')!r} != "
                f"{BASELINE_SCHEMA!r}")
        entries = []
        for e in raw.get("entries", []):
            missing = {"rule", "path", "contains", "justification"} - set(e)
            if missing:
                raise ValueError(
                    f"{path}: baseline entry {e!r} missing {sorted(missing)}")
            entries.append(BaselineEntry(
                rule=e["rule"], path=e["path"], contains=e["contains"],
                justification=e["justification"]))
        return cls(entries=entries, path=path)

    def apply(self, findings: List[Finding]) -> List[BaselineEntry]:
        """Mark matching findings baselined; return entries that matched
        nothing (stale — the violation was fixed, prune the entry)."""
        used = [False] * len(self.entries)
        for f in findings:
            if f.suppressed:
                continue
            for i, e in enumerate(self.entries):
                if e.matches(f):
                    f.baselined = True
                    used[i] = True
                    break
        return [e for i, e in enumerate(self.entries) if not used[i]]
