"""AdamW with the GPT-2 decay/no-decay partition, gradient clipping and the
learning-rate schedule.

Counterpart of ``mingpt_distributed_tpu/training/optimizer.py``, which
chains optax's ``clip_by_global_norm -> scale_by_adam ->
add_decayed_weights(mask) -> scale_by_learning_rate(schedule)``. Here
``torch.optim.AdamW`` with two parameter groups (decayed, not decayed) does
the Adam and decay part; around it ``AdamW.step`` reproduces what optax
does differently from PyTorch's usual recipe:

* the clip is optax's: gradients become ``g / norm * max_norm`` when
  ``norm >= max_norm`` (``clip_grad_norm_`` would divide by
  ``norm + 1e-6``);
* the schedule is read at optax's count: the first update uses
  ``schedule(0)``, which is 0 under warmup;
* ``decay_mask`` refuses a parameter name it does not know, as the
  reference's partition asserts do.

Under fsdp or tp (``mesh.sharded``) every rank updates only its slices of
the parameters, so its Adam moments are slices too. The global gradient
norm (and the update norm) sums each leaf's squares over ``mesh.model_group``
(the ranks that together hold one copy of the model) with the weight
1/``mesh.copies(leaf)``: a replicated leaf counts once, not once per rank,
and a leaf replicated along one axis and sharded along the other counts
once per distinct slice.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from mingpt_distributed_tpu_torch.config import OptimizerConfig

# weight decay on every matmul weight; none on biases, norms and embeddings
_DECAY_NAMES = frozenset(
    {"wq", "wk", "wv", "wo", "w_fc", "w_proj", "w_gate", "w_up", "w_down",
     "head", "w_router", "w_e1", "w_e2", "w_eg"})
_NO_DECAY_NAMES = frozenset(
    {"wte", "wpe", "bq", "bk", "bv", "bo", "b_fc", "b_proj",
     "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias",
     "lnf_scale", "lnf_bias"})


def decay_mask(params: Dict, _path: str = "") -> Dict:
    """The parameter tree with True where weight decay applies. Raises on
    a name that neither rule set covers."""
    out = {}
    for name, leaf in params.items():
        path = f"{_path}['{name}']"
        if isinstance(leaf, dict):
            out[name] = decay_mask(leaf, path)
        elif name in _DECAY_NAMES:
            out[name] = True
        elif name in _NO_DECAY_NAMES:
            out[name] = False
        else:
            raise ValueError(f"parameter {path!r} not covered by the "
                             f"decay/no-decay partition rules")
    return out


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def lr_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """step -> learning rate: constant (linear warmup from 0 when
    ``warmup_steps``), or linear warmup + cosine decay to
    ``learning_rate * min_lr_ratio`` at ``total_steps``; optax's formulas."""
    lr = cfg.learning_rate
    if cfg.schedule == "constant":
        if cfg.warmup_steps:
            return _linear(0.0, lr, cfg.warmup_steps)
        return lambda count: lr
    if cfg.schedule == "cosine":
        if cfg.total_steps is None:
            raise ValueError("cosine schedule needs optimizer_config.total_steps")
        warmup = cfg.warmup_steps
        decay_steps = cfg.total_steps - warmup
        if decay_steps <= 0:
            raise ValueError("cosine schedule needs total_steps > warmup_steps")
        alpha = 0.0 if lr == 0.0 else cfg.min_lr_ratio
        warm = _linear(0.0, lr, warmup)

        def schedule(count: int) -> float:
            if count < warmup:
                return warm(count)
            t = min(count - warmup, decay_steps)
            return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay_steps))
                         + alpha)

        return schedule
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def _leaves(tree: Dict, prefix: str = ""):
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _leaves(leaf, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", leaf


def _global_norm(tensors) -> torch.Tensor:
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


def sharded_norm(tensors, names, mesh) -> torch.Tensor:
    """The global norm of a tree whose leaves are this rank's slices: each
    leaf's sum of squares over its copies in ``mesh.model_group``, summed
    there."""
    from mingpt_distributed_tpu_torch.parallel import distributed as D

    sq = torch.stack([torch.linalg.vector_norm(t.float()).square() / mesh.copies(n)
                      for t, n in zip(tensors, names)]).sum()
    return D.all_reduce(sq, mesh.model_group).sqrt()


class AdamW:
    """clip -> AdamW (masked decay) -> lr(count) over a parameter tree whose
    leaves require grad. ``step(count)`` applies one update from the
    leaves' ``.grad`` and returns device scalars (no host sync): the
    pre-clip ``grad_norm`` and the ``update_norm`` of the applied update
    (new minus old parameters)."""

    def __init__(self, params: Dict, cfg: OptimizerConfig,
                 grad_norm_clip: Optional[float] = None,
                 schedule: Optional[Callable[[int], float]] = None,
                 mesh=None):
        self.names, self.params = zip(*_leaves(params))
        self.mesh = mesh if getattr(mesh, "sharded", False) else None
        mask = dict(_leaves(decay_mask(params)))
        groups = [
            {"params": [p for n, p in zip(self.names, self.params) if mask[n]],
             "weight_decay": cfg.weight_decay},
            {"params": [p for n, p in zip(self.names, self.params) if not mask[n]],
             "weight_decay": 0.0},
        ]
        self.opt = torch.optim.AdamW([g for g in groups if g["params"]],
                                     lr=0.0, betas=tuple(cfg.betas), eps=cfg.eps)
        self.clip = grad_norm_clip if grad_norm_clip and grad_norm_clip > 0 else None
        self.schedule = schedule or lr_schedule(cfg)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, count: int) -> Dict[str, torch.Tensor]:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        for p, g in zip(self.params, grads):
            p.grad = g
        grad_norm = self.norm(grads)
        if self.clip is not None:
            factor = torch.where(grad_norm < self.clip, 1.0,
                                 self.clip / grad_norm)
            for g in grads:
                g.mul_(factor)
        lr = float(self.schedule(count))
        for group in self.opt.param_groups:
            group["lr"] = lr
        old = [p.detach().clone() for p in self.params]
        self.opt.step()
        update_norm = self.norm([p - o for p, o in zip(self.params, old)])
        return {"grad_norm": grad_norm, "update_norm": update_norm}

    def norm(self, tensors) -> torch.Tensor:
        """The global norm of tensors shaped like the parameters (their
        slices under a sharded mesh)."""
        if self.mesh is None:
            return _global_norm(tensors)
        return sharded_norm(tensors, self.names, self.mesh)

    def canonical_state_dict(self, whole: Callable[[str, torch.Tensor], torch.Tensor]
                             ) -> Dict:
        """``opt.state_dict()`` with every moment passed through
        ``whole(name, tensor)``: under a sharded mesh, the moments gathered
        whole, the layout an unsharded run writes."""
        sd = self.opt.state_dict()
        by_id = {id(p): n for n, p in zip(self.names, self.params)}
        names = [by_id[id(p)] for g in self.opt.param_groups for p in g["params"]]
        order = [i for g in sd["param_groups"] for i in g["params"]]
        state = {}
        for i, name in zip(order, names):
            st = sd["state"].get(i)
            if st is not None:
                st = dict(st, exp_avg=whole(name, st["exp_avg"]),
                          exp_avg_sq=whole(name, st["exp_avg_sq"]))
                state[i] = st
        return dict(sd, state=state)

    def load_canonical_state_dict(self, sd: Dict,
                                  part: Callable[[str, torch.Tensor], torch.Tensor]
                                  ) -> None:
        """Load a state dict of whole moments, each cut to this rank's
        slice by ``part(name, tensor)``."""
        self.opt.load_state_dict(sd)
        for name, p in zip(self.names, self.params):
            st = self.opt.state.get(p)
            if st:
                st["exp_avg"] = part(name, st["exp_avg"])
                st["exp_avg_sq"] = part(name, st["exp_avg_sq"])

    # -- the Adam moments, by parameter name ---------------------------------
    def adam_state(self) -> Dict:
        """{"count", "mu": {name: tensor}, "nu": {...}}: the moments of every
        parameter that has taken an update."""
        count, mu, nu = 0, {}, {}
        for name, p in zip(self.names, self.params):
            st = self.opt.state.get(p)
            if st:
                count = int(st["step"])
                mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
        return {"count": count, "mu": mu, "nu": nu}

    def load_adam_state(self, count: int, mu: Dict, nu: Dict) -> None:
        """Set every parameter's moments and the update count."""
        for name, p in zip(self.names, self.params):
            self.opt.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu[name].to(p.device, torch.float32).clone(),
                "exp_avg_sq": nu[name].to(p.device, torch.float32).clone(),
            }


def make_optimizer(cfg: OptimizerConfig, params: Dict,
                   grad_norm_clip: Optional[float] = None,
                   schedule: Optional[Callable[[int], float]] = None,
                   mesh=None) -> AdamW:
    return AdamW(params, cfg, grad_norm_clip, schedule, mesh)
