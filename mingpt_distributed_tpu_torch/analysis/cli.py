"""graftlint CLI: ``python -m mingpt_distributed_tpu_torch.analysis``.

Counterpart of ``mingpt_distributed_tpu/analysis/cli.py``, with its flags
and exit codes (stable, gate on them):
  0  no unsuppressed, unbaselined findings
  1  findings (or unparseable source)
  2  usage error (unknown rule id, unreadable baseline)

``--json`` emits the ``graftlint/1`` envelope on stdout. With no paths it
lints the port's package (its ``tools/`` included); the default baseline
is the package's own ``analysis/lint_baseline.json`` when present (the
repository root's ``lint_baseline.json`` is the JAX package's).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence

from mingpt_distributed_tpu_torch.analysis.core import (
    EXIT_USAGE, Baseline, all_rules,
)
from mingpt_distributed_tpu_torch.analysis.engine import Engine

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_BASELINE = os.path.join(PACKAGE_DIR, "analysis", "lint_baseline.json")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mingpt_distributed_tpu_torch.analysis",
        description="graftlint: the repository's static analysis, over the "
                    "PyTorch port (rule catalog: the analysis package's "
                    "docstring)",
    )
    p.add_argument("paths", nargs="*", default=None,
                   help="files/dirs to lint (default: the port's package)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the graftlint/1 JSON envelope")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="baseline file (default: the package's "
                        "analysis/lint_baseline.json when present)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline file")
    p.add_argument("--select", default=None, metavar="IDS",
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--show-suppressed", action="store_true",
                   help="include suppressed/baselined findings in the "
                        "human report")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def default_paths() -> List[str]:
    """The port's package, relative to the working directory when it lies
    under it (findings then carry repo-relative paths)."""
    rel = os.path.relpath(PACKAGE_DIR)
    return [PACKAGE_DIR if rel.startswith("..") else rel]


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for cls in all_rules():
            print(f"{cls.id}  {cls.name:<18} {cls.help}")
        return 0

    baseline = None
    if not args.no_baseline:
        path = args.baseline or (
            DEFAULT_BASELINE if os.path.isfile(DEFAULT_BASELINE) else None)
        if path is not None:
            try:
                baseline = Baseline.load(path)
            except (OSError, ValueError) as e:
                print(f"graftlint: bad baseline: {e}", file=sys.stderr)
                return EXIT_USAGE

    select = [s for s in (args.select or "").split(",") if s.strip()] or None
    try:
        engine = Engine(baseline=baseline, select=select)
    except ValueError as e:
        print(f"graftlint: {e}", file=sys.stderr)
        return EXIT_USAGE

    result = engine.run(args.paths or default_paths())
    if args.as_json:
        print(json.dumps(result.to_json(), indent=2, sort_keys=True))
    else:
        print(result.render_human(show_suppressed=args.show_suppressed))
    return result.exit_code
