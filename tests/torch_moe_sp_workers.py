"""Rank bodies of tests/test_torch_moe_sp.py: mixture-of-experts beside
sequence parallelism.

``parallel.spawn.run_ranks`` runs them in fresh processes, so this module
imports torch, numpy and the port only: never jax, never the JAX package
(the test file computes the JAX side in the parent). Each takes plain
arguments (numpy arrays, dicts) and returns numpy arrays and numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from mingpt_distributed_tpu_torch.config import GPTConfig, MeshConfig, OptimizerConfig
from mingpt_distributed_tpu_torch.models import convert, gpt
from mingpt_distributed_tpu_torch.ops import moe
from mingpt_distributed_tpu_torch.parallel import distributed as D
from mingpt_distributed_tpu_torch.parallel.mesh import Mesh
from mingpt_distributed_tpu_torch.training import trainer as t_trainer
from mingpt_distributed_tpu_torch.training.optimizer import make_optimizer
from tests.torch_sp_workers import _rows, _whole


def _block(a: np.ndarray, mesh) -> tuple:
    """This rank's rows (its batch shard) and columns (its sp chunk) of a
    global (B, T, ...) array, and where they start."""
    n, c = a.shape[0] // mesh.batch_count, a.shape[1] // mesh.sp
    r0, c0 = mesh.batch_index * n, mesh.sp_rank * c
    return np.ascontiguousarray(a[r0:r0 + n, c0:c0 + c]), (r0, n, c0, c)


def moe_sp_layer_cases(rank: int, cases: dict) -> dict:
    """``moe_mlp`` on this rank's rows and column chunk of each case's
    global (B, T, D) input over the case's mesh: the output block, the aux
    loss, the input's gradient block, and the whole gradients of the
    router and the expert weights (summed over the ranks, gathered from
    this rank's experts and columns), of sum(out * g) + aux."""
    out = {}
    for name, c in cases.items():
        mesh = Mesh(MeshConfig(**c["mesh"]))
        whole = {"blocks": {k: torch.from_numpy(v)[None] for k, v in c["w"].items()}}
        local = mesh.shard_params(whole)["blocks"] if mesh.sharded else whole["blocks"]
        leaves = {k: v[0].clone().requires_grad_() for k, v in local.items()}
        used = ({k: mesh.gather(f"blocks/{k}", v, keep_tp=True, layer=True)
                 for k, v in leaves.items()} if mesh.sharded else leaves)
        xb, where = _block(c["x"], mesh)
        gb, _ = _block(c["g"], mesh)
        x = torch.from_numpy(xb).requires_grad_()
        ex = gpt._moe_exchange(mesh)
        y, aux = moe.moe_mlp(x, used["w_router"], used["w_e1"], used["w_e2"],
                             w_gate=used.get("w_eg"), top_k=c["top_k"],
                             capacity_factor=c["cf"], exchange=ex,
                             tp_group=mesh.tp_group if mesh.tp > 1 else None)
        ((y * torch.from_numpy(gb)).sum() + aux).backward()
        grads = {}
        for k, v in leaves.items():
            path = f"blocks/{k}"
            gr = v.grad[None].contiguous()
            D.all_reduce(gr, mesh.grad_group(path))
            grads[k] = (mesh.gather_full(path, gr) if mesh.sharded else gr)[0].numpy()
        out[name] = dict(y=y.detach().numpy(), aux=aux.item(), grads=grads,
                         x_grad=x.grad.numpy(), where=where, cols=ex.cols,
                         count=ex.data_count)
    return out


def moe_sp_losses(rank: int, cfg_kw: dict, mesh_kw: dict, params_tree: dict,
                  batches: list, lr: float) -> dict:
    """``make_train_step`` on the mesh from the whole ``params_tree`` on
    this rank's rows and column chunk of each global batch: the losses,
    the weighted aux term of each step's parameters (``loss_terms``, every
    rank's tokens), the whole parameters and first Adam moment after the
    first step (rank 0) and this rank's expert count."""
    cfg = GPTConfig.make(**cfg_kw)
    mesh = Mesh(MeshConfig(**mesh_kw))
    params = t_trainer.trainable(mesh.shard_params(
        convert.params_from_numpy(params_tree, cfg, "cpu")))
    state = t_trainer.TrainState(params, make_optimizer(
        OptimizerConfig.make(learning_rate=lr), params, 1.0, mesh=mesh))
    step = t_trainer.make_train_step(cfg, mesh=mesh)
    losses, auxes, first = [], [], None
    for i, (x, y) in enumerate(batches):
        xr, yr = _rows(x, mesh), _rows(y, mesh)
        with torch.no_grad():
            auxes.append(gpt.loss_terms(state.params, xr, yr, cfg, mesh=mesh,
                                        with_aux=True)[2].item())
        losses.append(step(state, (xr, yr))["loss"].item())
        if i == 0:  # every rank joins the gathers; rank 0 keeps the result
            mu = state.optimizer.adam_state()["mu"]
            first = dict(params=_whole(mesh, state.params),
                         mu=_whole(mesh, convert.unflatten(mu)))
    return dict(losses=losses, auxes=auxes, first=first,
                local_experts=int(params["blocks"]["w_e1"].shape[1]))


def jobs(rank: int, todo: list) -> list:
    """Run several of this module's rank bodies in one spawn: ``todo`` is
    a list of (function name, arguments)."""
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    return [globals()[name](rank, *args) for name, args in todo]
