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

Under pp, fsdp, ep or tp (``mesh.sharded``) every rank updates only its
slices of the parameters, so its Adam moments are slices too. The global
gradient norm (and the update norm) sums each leaf's squares over
``mesh.model_group`` (the ranks that together hold one copy of the model:
every stage's layers once) with the weight 1/``mesh.copies(leaf)``: a
replicated leaf counts once, not once per rank or per stage, and a leaf
replicated along one axis and sharded along the other counts once per
distinct slice.

ZeRO (``zero``, a ``parallel.zero.ZeroPlan`` with dp > 1): Adam runs on a
float32 buffer of this rank's 1/dp of each leaf's update view
(``shards``), so its moments are 1/dp too; the buffers cost 1/dp of the
parameter bytes beside them. Only ``step`` (through the all-gather) and
``load_canonical_state_dict`` (which refills the buffers) write the
parameters under ZeRO. ``reduce_grads`` replaces the trainer's
gradient all-reduce: one reduce-scatter over dp of every leaf's view (the
JAX package's GSPMD reduce-scatter), then one all-reduce of the shards over
each leaf's other data axes (sp, and fsdp or ep where they do not split the
leaf). The norm sums the shards' squares over the dp and model ranks
(``zero_group``); after the update one all-gather over dp rebuilds every
leaf. ``timings``, when a dict, collects the host seconds of the
reduce-scatter and the all-gather.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional

import torch

from mingpt_distributed_tpu_torch.config import OptimizerConfig
from mingpt_distributed_tpu_torch.parallel import distributed as D
from mingpt_distributed_tpu_torch.parallel import zero as Z

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
                 mesh=None, zero=None):
        self.names, self.params = zip(*_leaves(params))
        self.mesh = mesh if getattr(mesh, "sharded", False) else None
        self.zero = zero if zero is not None and zero.dp > 1 else None
        self.timings: Optional[Dict[str, float]] = None
        if self.zero is not None:
            self._zmesh = mesh
            self.zero_group = mesh.group_over(("pp", "dp", "fsdp", "ep", "tp"))
            # the tensors Adam updates: a float32 buffer of this rank's 1/dp
            # of each view, rebuilt into the parameters by _gather_params
            # and refilled from them on restore. Views of the parameters
            # instead (no buffer in dim mode) made the GPT-2 124M dp 4 step
            # slower on an H100 in every A/B pair run (PERF.md).
            self.shards = [self._shard(n, p.detach()).float().clone()
                           for n, p in zip(self.names, self.params)]
        else:
            self.shards = list(self.params)
        mask = dict(_leaves(decay_mask(params)))
        groups = [
            {"params": [s for n, s in zip(self.names, self.shards) if mask[n]],
             "weight_decay": cfg.weight_decay},
            {"params": [s for n, s in zip(self.names, self.shards) if not mask[n]],
             "weight_decay": 0.0},
        ]
        self.opt = torch.optim.AdamW([g for g in groups if g["params"]],
                                     lr=0.0, betas=tuple(cfg.betas), eps=cfg.eps)
        self.clip = grad_norm_clip if grad_norm_clip and grad_norm_clip > 0 else None
        self.schedule = schedule or lr_schedule(cfg)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
        if self.zero is not None:
            for s in self.shards:
                s.grad = None

    # -- ZeRO: the update view --------------------------------------------
    def _view(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return Z.local_view(self.zero.by_name[name], t, self.zero.dp)

    def _shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return Z.shard_of(self.zero.by_name[name], self._view(name, t), self.zero.dp,
                          self._zmesh.dp_rank)

    def _tick(self, key: str, t0: float) -> None:
        if self.timings is not None:
            self.timings[key] = self.timings.get(key, 0.0) + time.perf_counter() - t0

    def reduce_grads(self) -> None:
        """ZeRO: every leaf's gradient summed over the ranks of distinct
        data, this rank keeping its 1/dp (each shard's ``.grad``)."""
        mesh, dp = self._zmesh, self.zero.dp
        views = [self._view(n, (p.grad if p.grad is not None else torch.zeros_like(p))
                            .float()) for n, p in zip(self.names, self.params)]
        # one buffer of dp rows: row r holds every leaf's piece r
        rows = torch.stack([torch.cat([v.chunk(dp, Z.split_dim(self.zero.by_name[n]))[r]
                                       .reshape(-1) for n, v in zip(self.names, views)])
                            for r in range(dp)])
        t0 = time.perf_counter()
        mine = D.reduce_scatter(rows, mesh.dp_group, 0)[0]
        self._tick("reduce_scatter", t0)
        for p in self.params:
            p.grad = None
        parts = mine.split([s.numel() for s in self.shards])
        by_axes: Dict[tuple, List[int]] = {}
        for i, (n, s, g) in enumerate(zip(self.names, self.shards, parts)):
            s.grad = g.view_as(s)
            rest = tuple(a for a in (mesh.grad_axes(n) if mesh.sharded
                                     else ("dp", "sp")) if a != "dp")
            if any(mesh.shape[a] > 1 for a in rest):
                by_axes.setdefault(rest, []).append(i)
        for axes, idx in by_axes.items():
            flat = torch.cat([self.shards[i].grad.reshape(-1) for i in idx])
            D.all_reduce(flat, mesh.group_over(axes))
            for i, g in zip(idx, flat.split([self.shards[i].numel() for i in idx])):
                self.shards[i].grad = g.view_as(self.shards[i])

    def _gather_params(self) -> None:
        """ZeRO: every leaf rebuilt from the dp ranks' updated shards."""
        mesh, dp = self._zmesh, self.zero.dp
        t0 = time.perf_counter()
        every = D.gather_tensor(torch.cat([s.reshape(-1) for s in self.shards]),
                                mesh.dp_group, 0).reshape(dp, -1)
        self._tick("all_gather", t0)
        sizes = [s.numel() for s in self.shards]
        pieces = [row.split(sizes) for row in every]
        for i, (n, p, s) in enumerate(zip(self.names, self.params, self.shards)):
            lp = self.zero.by_name[n]
            view = torch.cat([pieces[r][i].view_as(s) for r in range(dp)],
                             Z.split_dim(lp))
            p.data.copy_(Z.from_local_view(lp, view, p.shape).to(p.dtype))

    # -- the update --------------------------------------------------------
    def grads(self) -> List[torch.Tensor]:
        """What the update reads: each leaf's gradient (each shard's under
        ZeRO, after ``reduce_grads``)."""
        return [t.grad if t.grad is not None else torch.zeros_like(t)
                for t in self.shards]

    @torch.no_grad()
    def step(self, count: int) -> Dict[str, torch.Tensor]:
        grads = self.grads()
        for t, g in zip(self.shards, grads):
            t.grad = g
        grad_norm = self.norm(grads)
        if self.clip is not None:
            factor = torch.where(grad_norm < self.clip, 1.0,
                                 self.clip / grad_norm)
            for g in grads:
                g.mul_(factor)
        lr = float(self.schedule(count))
        for group in self.opt.param_groups:
            group["lr"] = lr
        old = [t.detach().clone() for t in self.shards]
        self.opt.step()
        update_norm = self.norm([t - o for t, o in zip(self.shards, old)])
        if self.zero is not None:
            self._gather_params()
        return {"grad_norm": grad_norm, "update_norm": update_norm}

    def norm(self, tensors) -> torch.Tensor:
        """The global norm of tensors shaped like what Adam updates (the
        parameters, their slices under a sharded mesh, their shards under
        ZeRO)."""
        if self.zero is not None:
            mesh = self._zmesh
            w = [mesh.copies(n) if mesh.sharded else 1 for n in self.names]
            sq = torch.stack([torch.linalg.vector_norm(t.float()).square() / c
                              for t, c in zip(tensors, w)]).sum()
            return D.all_reduce(sq, self.zero_group).sqrt()
        if self.mesh is None:
            return _global_norm(tensors)
        return sharded_norm(tensors, self.names, self.mesh)

    def init_moments(self) -> None:
        """Allocate every moment now (zeros at count 0), as Adam's first
        step would: their bytes can then be read before training."""
        for t in self.shards:
            if not self.opt.state.get(t):
                self.opt.state[t] = {"step": torch.tensor(0.0),
                                     "exp_avg": torch.zeros_like(t),
                                     "exp_avg_sq": torch.zeros_like(t)}

    def moment_bytes(self) -> int:
        """Bytes of the Adam moments this rank holds."""
        return sum(st[k].numel() * st[k].element_size() for st in self.opt.state.values()
                   for k in ("exp_avg", "exp_avg_sq") if k in st)

    # -- snapshots: whole moments in the canonical layout ------------------
    def gather_shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a leaf-shaped tensor (a moment, a gradient)
        from its ZeRO shard ``t`` (every dp rank takes part)."""
        lp, dp = self.zero.by_name[name], self.zero.dp
        every = D.gather_tensor(t.reshape(-1), self._zmesh.dp_group, 0).reshape(dp, -1)
        view = torch.cat([row.view_as(t) for row in every], Z.split_dim(lp))
        p = self.params[self.names.index(name)]
        return Z.from_local_view(lp, view, p.shape)

    def canonical_state_dict(self, whole: Callable[[str, torch.Tensor], torch.Tensor]
                             ) -> Dict:
        """``opt.state_dict()`` with every moment passed through
        ``whole(name, tensor)``: under a sharded mesh, the moments gathered
        whole, the layout an unsharded run writes. Under ZeRO each moment is
        first rebuilt from the dp ranks' shards (every rank takes part), so
        the snapshot is the same with ``zero_dp`` on or off."""
        sd = self.opt.state_dict()
        by_id = {id(t): n for n, t in zip(self.names, self.shards)}
        names = [by_id[id(t)] for g in self.opt.param_groups for t in g["params"]]
        order = [i for g in sd["param_groups"] for i in g["params"]]
        local = ((lambda n, t: t) if self.zero is None else self.gather_shard)
        state = {}
        for i, name in zip(order, names):
            st = sd["state"].get(i)
            if st is not None:
                st = dict(st, exp_avg=whole(name, local(name, st["exp_avg"])),
                          exp_avg_sq=whole(name, local(name, st["exp_avg_sq"])))
                state[i] = st
        return dict(sd, state=state)

    def load_canonical_state_dict(self, sd: Dict,
                                  part: Callable[[str, torch.Tensor], torch.Tensor]
                                  ) -> None:
        """Load a state dict of whole moments, each cut to this rank's
        slice by ``part(name, tensor)`` (and to its 1/dp under ZeRO)."""
        self.opt.load_state_dict(sd)
        cut = part if self.zero is None else (lambda n, t: self._shard(n, part(n, t)))
        for name, t in zip(self.names, self.shards):
            st = self.opt.state.get(t)
            if st:
                st["exp_avg"] = cut(name, st["exp_avg"]).contiguous()
                st["exp_avg_sq"] = cut(name, st["exp_avg_sq"]).contiguous()
        if self.zero is not None:  # the buffers restart from the restored leaves
            with torch.no_grad():
                for name, p, t in zip(self.names, self.params, self.shards):
                    t.copy_(self._shard(name, p.detach()))

    # -- the Adam moments, by parameter name ---------------------------------
    def adam_state(self) -> Dict:
        """{"count", "mu": {name: tensor}, "nu": {...}}: the moments of every
        parameter that has taken an update (this rank's shards under
        ZeRO)."""
        count, mu, nu = 0, {}, {}
        for name, t in zip(self.names, self.shards):
            st = self.opt.state.get(t)
            if st:
                count = int(st["step"])
                mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
        return {"count": count, "mu": mu, "nu": nu}

    def load_adam_state(self, count: int, mu: Dict, nu: Dict) -> None:
        """Set every parameter's moments and the update count."""
        for name, t in zip(self.names, self.shards):
            self.opt.state[t] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu[name].to(t.device, torch.float32).clone(),
                "exp_avg_sq": nu[name].to(t.device, torch.float32).clone(),
            }


def make_optimizer(cfg: OptimizerConfig, params: Dict,
                   grad_norm_clip: Optional[float] = None,
                   schedule: Optional[Callable[[int], float]] = None,
                   mesh=None, zero=None) -> AdamW:
    return AdamW(params, cfg, grad_norm_clip, schedule, mesh, zero)
