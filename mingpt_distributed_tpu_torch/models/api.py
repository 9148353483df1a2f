"""GPT: the object-style facade over the functional core.

Counterpart of ``mingpt_distributed_tpu/models/api.py``: ``GPT(config)``
with ``forward(inputs, targets=None) -> (logits, loss)``,
``generate(idx, max_new_tokens, temperature, do_sample, top_k)`` and
``num_params``, plus an explicit ``device`` (cuda unless the caller asks
for the CPU). The parameters live in two ``nn.ParameterDict``s (top-level
and stacked blocks) so ``.to()`` and ``state_dict()`` work; the compute
goes through the same plain functions (models/gpt.py, models/generate.py).

This slice is inference-only: parameters do not require gradients and
``forward`` runs under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models import generate as _generate
from mingpt_distributed_tpu_torch.models import gpt as _gpt
from mingpt_distributed_tpu_torch.utils.device import Device, resolve_device


def _frozen(params) -> nn.ParameterDict:
    return nn.ParameterDict(
        {k: nn.Parameter(v, requires_grad=False) for k, v in params.items()})


class GPT(nn.Module):
    """Decoder-only transformer with the reference's public surface."""

    def __init__(
        self,
        config: GPTConfig,
        params: Optional[_gpt.Params] = None,
        *,
        seed: int = 0,
        device: Optional[Device] = None,
    ):
        super().__init__()
        # GPTConfig.make() already resolved a preset into explicit dims
        self.config = config if config.n_layer is not None else config.resolved()
        self.config.validate()
        self.device = resolve_device(device)
        if params is None:
            params = _gpt.init(self.config,
                               torch.Generator().manual_seed(seed),
                               device=self.device)
        self.top = _frozen({k: v.to(self.device) for k, v in params.items()
                            if k != "blocks"})
        self.blocks = _frozen({k: v.to(self.device)
                               for k, v in params["blocks"].items()})

    @property
    def params(self) -> _gpt.Params:
        return {**dict(self.top), "blocks": dict(self.blocks)}

    @torch.no_grad()
    def forward(self, inputs, targets=None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        inputs = torch.as_tensor(inputs, dtype=torch.long, device=self.device)
        if targets is not None:
            targets = torch.as_tensor(targets, dtype=torch.long,
                                      device=self.device)
        return _gpt.forward(self.params, inputs, self.config, targets=targets)

    def generate(
        self,
        idx,
        max_new_tokens: int,
        temperature: float = 1.0,
        do_sample: bool = False,
        top_k: Optional[int] = None,
        *,
        top_p: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Reference signature; KV-cached decode while the window holds the
        sequence, the sliding window past it."""
        return _generate.generate(
            self.params, self.config, idx, max_new_tokens,
            temperature=temperature, do_sample=do_sample, top_k=top_k,
            top_p=top_p, generator=generator, device=self.device,
        )

    @classmethod
    def from_pretrained(cls, model_type: str = "gpt2", **overrides) -> "GPT":
        raise NotImplementedError(
            "GPT-2 weights are not in the repository: convert a JAX snapshot "
            "with models/convert.py instead (README, PyTorch/H100 port)")

    @property
    def num_params(self) -> int:
        return _gpt.param_count(self.params)
