"""GL010 — bare-print: library code prints without going through
``telemetry.spans.log_event``.

The port's counterpart of the JAX package's rule. An unprefixed line
from many processes is unattributable noise, and anything printed
outside ``log_event`` never reaches the span ring or the JSONL sink, so
the flight recorder has holes exactly where someone thought a message
mattered enough to print.

Scope: library paths only (``mingpt_distributed_tpu_torch/``). The
port's CLIs (``train.py``, ``serve.py``, ``sample.py``, ``traffic.py``,
``tools/``) print to their user by design and are out of scope, as is
``telemetry/spans.py`` itself (something has to own the actual
``print``). ``sys.stdout.write``/
``sys.stderr.write`` count too — they are the same hole with a
different spelling.
"""

from __future__ import annotations

import ast
from typing import List

from mingpt_distributed_tpu_torch.analysis.core import (
    FileContext, Finding, Rule, call_name, register_rule,
)


@register_rule
class BarePrintRule(Rule):
    id = "GL010"
    name = "bare-print"
    help = ("bare print() in library code — route through "
            "telemetry.spans.log_event so the line is process-prefixed "
            "and mirrored into the span ring/JSONL")

    def check_file(self, ctx: FileContext) -> List[Finding]:
        if not ctx.config.print_in_scope(ctx.relpath):
            return []
        findings: List[Finding] = []
        for n in ast.walk(ctx.tree):
            if not isinstance(n, ast.Call):
                continue
            fname = call_name(n.func)
            if fname == "print":
                findings.append(self.finding(
                    ctx, n,
                    "bare print() in library code — use "
                    "telemetry.spans.log_event (process-prefixed, "
                    "mirrored to the span ring and JSONL sink)"))
            elif fname in ("sys.stdout.write", "sys.stderr.write"):
                findings.append(self.finding(
                    ctx, n,
                    f"{fname}() in library code — same hole as bare "
                    f"print(); use telemetry.spans.log_event"))
        return findings
