"""graftlint and the program audit: the port's static analysis layer.

Counterpart of ``mingpt_distributed_tpu/analysis/``. graftlint's engine is
plain ``ast`` (no import of the analysed code, so a lint run never touches
a card), with a rule registry of stable ``GLxxx`` IDs, inline
``# graftlint: disable=GLxxx`` suppressions, a checked-in baseline for
grandfathered findings, human and ``--json`` output (the ``graftlint/1``
envelope) and exit codes 0 (clean), 1 (findings) and 2 (usage error).

Usage::

    python -m mingpt_distributed_tpu_torch.analysis            # the port's package
    python -m mingpt_distributed_tpu_torch.analysis --json PATH ...
    python -m mingpt_distributed_tpu_torch.analysis --list-rules

The rules, one by one. Those that concern any Python have counterparts
under the same ID, scoped to the port:

* GL007 ``wall-clock``: no direct ``time.*`` call in a clock-disciplined
  path (the port's ``serving/``, ``training/faults.py``, the tracing,
  flight-recorder and attribution modules, ``trafficlab/`` and
  ``control/``): the chaos and fault tests stay deterministic only
  through the injected clocks.
* GL008 ``metric-name`` and GL009 ``metric-conflict``: the
  ``mingpt_<subsystem>_<what>`` naming of every registered metric family,
  one instrument type per family, and no ``mingpt_*`` literal that names
  no family.
* GL010 ``bare-print``: no ``print`` in library code; the port's CLIs
  (``train.py``, ``serve.py``, ``sample.py``, ``traffic.py``, the
  procfleet worker's entry and ``tools/``), ``telemetry/spans.py`` and
  this package print by design.

The JAX-idiom rules get none, since their cause does not exist in an
eager PyTorch program:

* GL001 (donating restored arrays into a cached executable): the port
  compiles no program and donates no buffer; the pool's in-place writes
  are checked at run time by the program audit's ``donated`` check.
* GL002 to GL005 (host work, Python branches on traced values, jit
  wrappers built in loops, unhashable static arguments: each a silent
  retrace): nothing is traced or jitted; a Python branch on a tensor is
  an ordinary synchronisation, and the engine's shape counts
  (``compile_counts``) stay bounded by its bucket ladder.
* GL006 (a tracer leaking out of its trace): there are no tracers.
* GL011 (a ``PartitionSpec`` with a trailing ``None``, which compares
  unequal to XLA's normalised form): the port's specs are
  ``PARAM_RULES`` tuples compared by ``shard_by_rule`` after padding, and
  the audit's ``sharding`` check reads the local shapes themselves.

``program_audit`` is the counterpart of ``hlo_audit``: it runs one call
of each program family and checks what the call did against the
family's contract (collectives, in-place pool writes, the K/V leaves'
local shapes, the analytic cost budgets); ``tools/graftaudit.py`` drives
it over the serving stack and the trainer.
"""

from mingpt_distributed_tpu_torch.analysis.core import (
    Config,
    Finding,
    Rule,
    all_rules,
    get_rule,
    register_rule,
)
from mingpt_distributed_tpu_torch.analysis.engine import Engine, RunResult

__all__ = [
    "Config",
    "Engine",
    "Finding",
    "Rule",
    "RunResult",
    "all_rules",
    "get_rule",
    "register_rule",
]
