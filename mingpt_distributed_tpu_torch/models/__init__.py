"""GPT forward, generation, parameter conversion and the GPT facade."""

from mingpt_distributed_tpu_torch.models.api import GPT  # noqa: F401
