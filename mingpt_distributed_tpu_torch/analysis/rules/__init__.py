"""The port's rule battery. Importing this package registers every rule;
the modules are imported in ID order so ``--list-rules`` output is stable.
Which of the JAX package's rules have a counterpart here, and why the
others have none: ``mingpt_distributed_tpu_torch/analysis/__init__.py``."""

from mingpt_distributed_tpu_torch.analysis.rules import (  # noqa: F401
    clock,
    metric_names,
    print_discipline,
)
