"""Rank bodies of the port's pipeline and sharded-snapshot tests
(tests/test_torch_pipeline.py, tests/test_torch_sharded_ckpt.py).

``parallel.spawn.run_ranks`` runs them in fresh processes, so this module
imports torch, numpy and the port only: never jax, never the JAX package
(the test files compute the JAX side in the parent). Each takes plain
arguments (numpy arrays, dicts) and returns numpy arrays and numbers.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mingpt_distributed_tpu_torch.config import (
    DataConfig,
    GPTConfig,
    MeshConfig,
    OptimizerConfig,
    TrainerConfig,
)
from mingpt_distributed_tpu_torch.data.char_dataset import CharDataset
from mingpt_distributed_tpu_torch.models import convert, gpt
from mingpt_distributed_tpu_torch.ops import moe
from mingpt_distributed_tpu_torch.parallel import distributed as D
from mingpt_distributed_tpu_torch.parallel.mesh import Mesh
from mingpt_distributed_tpu_torch.training import checkpoint as ckpt
from mingpt_distributed_tpu_torch.training import checkpoint_sharded as cs
from mingpt_distributed_tpu_torch.training import trainer as t_trainer
from mingpt_distributed_tpu_torch.training.optimizer import make_optimizer

_MESHES: dict = {}


def mesh_of(mesh_kw: dict) -> Mesh:
    """One Mesh per extents in this process: every rank builds the same
    ones in the same order, and none is built twice."""
    key = tuple(sorted(mesh_kw.items()))
    if key not in _MESHES:
        _MESHES[key] = Mesh(MeshConfig(**dict(dict(dp=1), **mesh_kw)))
    return _MESHES[key]


def rows(a: np.ndarray, mesh) -> torch.Tensor:
    """This rank's rows (its dp x fsdp x ep shard) and sp chunk of a global
    (B, T) array."""
    n, c = a.shape[0] // mesh.batch_count, a.shape[1] // mesh.sp
    return torch.from_numpy(np.ascontiguousarray(
        a[mesh.batch_index * n:(mesh.batch_index + 1) * n,
          mesh.sp_rank * c:(mesh.sp_rank + 1) * c])).long()


def where(mesh) -> dict:
    return dict(stage=mesh.stage, batch_index=mesh.batch_index,
                batch_count=mesh.batch_count, sp_rank=mesh.sp_rank, sp=mesh.sp,
                tp_rank=mesh.tp_rank)


def whole(mesh, tree: dict) -> dict:
    """Every leaf of this rank's slices of ``tree`` gathered whole (every
    rank joins; every rank gets them)."""
    return {n: mesh.gather_full(n, t).numpy() for n, t in convert.flatten(tree).items()}


def _params(cfg, mesh, tree):
    return t_trainer.trainable(mesh.shard_params(convert.params_from_numpy(tree, cfg, "cpu")))


def _global_loss(params, x, y, cfg, mesh, **kw) -> float:
    """The eval path's loss (``loss_terms`` under pp): the global token mean
    plus the MoE term."""
    total, count, aux = gpt.loss_terms(params, x, y, cfg, mesh=mesh, with_aux=True, **kw)
    return float(D.all_reduce(total, mesh.batch_group)
                 / D.all_reduce(count.float(), mesh.batch_group).clamp_min(1) + aux)


def _grads(params, x, y, cfg, mesh, gen=None):
    """The gradient of the global mean loss (the training schedule's
    backward, then ``all_reduce_grads``) and the loss, as the trainer
    forms them."""
    count = D.all_reduce((y != -1).sum().float(), mesh.batch_group).clamp_min(1)
    total, aux, _, stats = gpt.pipeline_terms(
        params, x, y, cfg, generator=gen, deterministic=gen is None, mesh=mesh,
        loss_scale=1.0 / count)
    t_trainer.all_reduce_grads(params, mesh)
    group = mesh.group_over(("pp", "dp", "fsdp", "ep", "sp"))
    loss = float(D.all_reduce(total / count + aux, group))
    grads = whole(mesh, {n: p.grad for n, p in convert.flatten(params).items()})
    return loss, grads, stats


def pp_case(rank: int, case: dict) -> dict:
    """One case of tests/test_torch_pipeline.py on this rank: ``case``
    holds its ``kind``, the model (``cfg``), the mesh, the whole JAX
    parameters (``tree``) and the global ``tokens`` (and ``targets``)."""
    cfg = GPTConfig.make(**case["cfg"])
    mesh = mesh_of(case["mesh"])
    params = _params(cfg, mesh, case["tree"])
    x = rows(case["tokens"], mesh)
    y = rows(case["targets"], mesh) if case.get("targets") is not None else None
    kind = case["kind"]
    out = dict(where(mesh))
    if kind == "forward":
        logits, _ = gpt.forward(params, x, cfg, mesh=mesh)
        out.update(logits=logits.detach().numpy(),
                   loss=_global_loss(params, x, y, cfg, mesh) if y is not None else None)
    elif kind == "grads":
        out["loss"], out["grads"], _ = _grads(params, x, y, cfg, mesh)
    elif kind == "dropout":
        gen = t_trainer.rank_generator(torch.Generator().manual_seed(case["seed"]),
                                       mesh.data_rank)
        logits, _ = gpt.forward(params, x, cfg, generator=gen, deterministic=False,
                                mesh=mesh)
        out["logits"] = logits.detach().numpy()
    elif kind == "dropout_loss":  # the same seed twice, then another
        losses = []
        for seed in case["seeds"]:
            for p in convert.flatten(params).values():
                p.grad = None
            gen = t_trainer.rank_generator(torch.Generator().manual_seed(seed),
                                           mesh.data_rank)
            loss, grads, _ = _grads(params, x, y, cfg, mesh, gen)
            losses.append(loss)
            out.setdefault("grads_finite", all(np.isfinite(g).all() for g in grads.values()))
        out["losses"] = losses
    elif kind == "schedules":  # the same step under both schedules
        for sched in ("gpipe", "1f1b"):
            c = GPTConfig.make(**dict(case["cfg"], pp_schedule=sched))
            for p in convert.flatten(params).values():
                p.grad = None
            gen = (None if t_trainer.deterministic(c) else t_trainer.rank_generator(
                torch.Generator().manual_seed(5), mesh.data_rank))
            loss, grads, stats = _grads(params, x, y, c, mesh, gen)
            out[sched] = dict(loss=loss, grads=grads, live_peak=stats.live_peak,
                              actions=stats.actions)
    elif kind == "shapes":  # what the stage's blocks compute with
        seen = {}
        real = mesh.gather

        def recording(path, local, keep_tp=False, layer=False):
            got = real(path, local, keep_tp=keep_tp, layer=layer)
            if layer:
                seen[path] = tuple(got.shape)
            return got

        mesh.gather = recording
        try:
            out["loss"] = _global_loss(params, x, y, cfg, mesh)
        finally:
            del mesh.gather
        out.update(used=seen, held={n: tuple(p.shape) for n, p in
                                    convert.flatten(params).items()})
    elif kind == "moe_shapes":  # what each MoE layer call holds
        seen = []
        real = moe.moe_mlp

        def capture(h, w_router, w_e1, w_e2, **kw):
            ex = kw.get("exchange")
            seen.append(dict(w_e1=tuple(w_e1.shape), router_e=int(w_router.shape[1]),
                             ep_exchange=ex is not None and ex.ep_group is not None))
            return real(h, w_router, w_e1, w_e2, **kw)

        moe.moe_mlp = capture
        try:
            out["loss"] = _global_loss(params, x, y, cfg, mesh)
        finally:
            moe.moe_mlp = real
        out["calls"] = seen
    else:
        raise ValueError(f"unknown case kind {kind!r}")
    return out


def pp_train(rank: int, cfg_kw: dict, mesh_kw: dict, tree: dict, batches: list,
             lr: float, zero: bool = False) -> dict:
    """``make_train_step`` on the mesh from the whole JAX parameters, on the
    rank's share of each global batch (``zero``: the update sharded over dp,
    ``zero_dp``): the losses and the block leaves' held shapes."""
    from mingpt_distributed_tpu_torch.parallel import zero as zero_lib

    cfg = GPTConfig.make(**cfg_kw)
    mesh = mesh_of(mesh_kw)
    whole = convert.params_from_numpy(tree, cfg, "cpu")
    plan = zero_lib.make_plan(mesh, whole) if zero else None
    params = t_trainer.trainable(mesh.shard_params(whole))
    state = t_trainer.TrainState(params, make_optimizer(
        OptimizerConfig.make(learning_rate=lr), params, 1.0, mesh=mesh, zero=plan))
    step = t_trainer.make_train_step(cfg, mesh=mesh)
    losses = [step(state, (rows(x, mesh), rows(y, mesh)))["loss"].item()
              for x, y in batches]
    return dict(where(mesh), losses=losses, wq=tuple(params["blocks"]["wq"].shape))


def corpus_trainer(text, snapshot, max_steps, mesh_kw, tree=None, **kw):
    """A GPTTrainer on ``text`` (the JAX tests' trainer setup: block 16,
    batch 16, lr 1e-2, seed 7, n_layer 2, n_head 2, n_embd 32, no dropout),
    its parameters set to the whole ``tree`` when given."""
    data = CharDataset(DataConfig.make(block_size=16), text=text)
    train, test = data.split()
    model_kw = kw.pop("model_kw", {})
    gcfg = GPTConfig.make(**dict(dict(
        n_layer=2, n_head=2, n_embd=32, vocab_size=data.vocab_size, block_size=16,
        dtype="float32", embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0), **model_kw))
    tcfg = TrainerConfig.make(**dict(dict(
        batch_size=16, max_steps=max_steps, log_every=1, eval_batches=1,
        snapshot_path=snapshot, seed=7, mesh=mesh_kw, save_every=100), **kw))
    tr = t_trainer.GPTTrainer(tcfg, gcfg, OptimizerConfig(learning_rate=1e-2),
                              train, test, device="cpu")
    if tree is not None and tr.state.step == 0:
        full = convert.params_from_numpy(tree, gcfg, "cpu")
        with torch.no_grad():
            for n, p in convert.flatten(tr.state.params).items():
                leaf = convert.flatten(full)[n]
                p.copy_(tr.mesh.shard(n, leaf) if tr.sharded else leaf)
    return tr


def first_eval_loss(tr) -> float:
    """The eval step on the first test batch."""
    from mingpt_distributed_tpu_torch.data.char_dataset import IteratorState

    tr.test_iter.state = IteratorState(seed=tr.config.seed)
    xy = next(iter(tr.test_iter.epoch_batches()))
    return float(tr._eval_step(tr.state, tr._put_batch(xy)))


def pp_trainer(rank: int, text: str, tmp: str, mesh_kw: dict) -> dict:
    """GPTTrainer at a pp mesh: each rank's ``wq`` (its stage's layers), 2
    steps with a one-file snapshot (gathered over pp too), and the eval
    loss; then 2 steps with ``zero_dp`` and its one-file snapshot (the
    canonical layout, which the parent resumes in one process)."""
    tr = corpus_trainer(text, os.path.join(tmp, "pp_trainer.pt"), 2, mesh_kw)
    last = tr.train()
    zt = corpus_trainer(text, os.path.join(tmp, "pp_zero.pt"), 2, mesh_kw, zero_dp=True)
    zlast = zt.train()
    return dict(where(tr.mesh), wq=tuple(tr.state.params["blocks"]["wq"].shape),
                wq_whole=tr.mesh.full_shapes["blocks/wq"], loss=last["loss"],
                eval_loss=last.get("eval_loss"), zero_loss=zlast["loss"],
                zero_dp=zt.zero_plan.dp, zero_whole=whole(zt.mesh, zt.state.params))


def jobs(rank: int, todo: list) -> list:
    """Run several of this module's rank bodies in one spawn: ``todo`` is
    a list of (function name, arguments)."""
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    return [globals()[name](rank, *args) for name, args in todo]


# -- sharded directory snapshots (tests/test_torch_sharded_ckpt.py) ----------

def _leaves_np(tr) -> dict:
    """The trainer's whole parameters and Adam moments by name (every rank
    joins the gathers)."""
    mesh = tr.mesh if tr.sharded else None
    full = ((lambda n, t: mesh.gather_full(n, t).numpy()) if mesh is not None
            else (lambda n, t: t.detach().numpy().copy()))
    out = {f"params/{n}": full(n, p) for n, p in convert.flatten(tr.state.params).items()}
    adam = tr.state.optimizer.adam_state()
    for g, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        out.update({f"{key}/{n}": full(n, t) for n, t in adam[g].items()})
    out["adam_count"] = adam["count"]
    return out


def one_file_leaves(tr, path: str) -> dict:
    """The one-file snapshot at ``path`` by leaf name, as ``_leaves_np``
    names them (its moments are in the optimizer's parameter order)."""
    snap = ckpt.load_snapshot(path)
    out = {f"params/{n}": t.numpy() for n, t in convert.flatten(snap["params"]).items()}
    opt = tr.state.optimizer
    sd = snap["opt_state"]
    order = [i for g in sd["param_groups"] for i in g["params"]]
    by_id = {id(t): n for n, t in zip(opt.names, opt.shards)}
    names = [by_id[id(t)] for g in opt.opt.param_groups for t in g["params"]]
    for i, n in zip(order, names):
        for key in ("exp_avg", "exp_avg_sq"):
            out[f"{key}/{n}"] = sd["state"][i][key].numpy()
    out["adam_count"] = int(sd["state"][order[0]]["step"])
    return out


def ckpt_reshard(rank: int, text: str, tmp: str, tree: dict) -> dict:
    """Train 3 steps at fsdp 2 x tp 2 and save both a directory and a
    one-file snapshot of that state; restore the directory at dp 4, save it
    again there, and restore that at pp 2 x dp 2. Returns the one-file
    snapshot's leaves (rank 0), each restored state whole, each rank's held
    bytes at fsdp 2 x tp 2, and the tensor bytes of each data file."""
    first, second = os.path.join(tmp, "reshard_22"), os.path.join(tmp, "reshard_dp4")
    one = os.path.join(tmp, "reshard_one.pt")
    tr = corpus_trainer(text, first, 3, dict(dp=1, fsdp=2, tp=2), tree=tree)
    tr.train()  # saves the directory at its end
    held = 3 * sum(p.numel() * p.element_size()  # the moments are slices like the leaves
                   for p in convert.flatten(tr.state.params).values())
    tr.snapshot_path, tr.sharded_snapshot = one, False
    tr.save_snapshot(epoch=1)
    out = dict(held_bytes=held, fsdp_tp=_leaves_np(tr),
               one_file=one_file_leaves(tr, one) if rank == 0 else None,
               written=cs.written_bytes(first) if rank == 0 else None)
    for name, path, mesh_kw in (("dp4", first, dict(dp=4)),
                                ("pp2_dp2", second, dict(pp=2, dp=2))):
        back = corpus_trainer(text, path, 3, mesh_kw)
        out[name] = dict(step=back.step, leaves=_leaves_np(back), wq=tuple(
            back.state.params["blocks"]["wq"].shape), eval_loss=first_eval_loss(back))
        if name == "dp4":
            back.snapshot_path = second
            back.save_snapshot(epoch=1)
    return out


def ckpt_resume(rank: int, text: str, tmp: str, tree: dict, mesh_kw: dict) -> dict:
    """The JAX ``test_orbax_backend_resume`` flow at ``mesh_kw``: an
    uninterrupted 8-step run, and 4 steps, a directory snapshot and a
    resume to 8; the eval loss on the first test batch after each."""
    full = corpus_trainer(text, os.path.join(tmp, "rfull"), 8, mesh_kw, tree=tree)
    full.train()
    half = corpus_trainer(text, os.path.join(tmp, "rhalf"), 4, mesh_kw, tree=tree)
    half.train()
    back = corpus_trainer(text, os.path.join(tmp, "rhalf"), 8, mesh_kw)
    at = back.step
    back.train()
    return dict(full=first_eval_loss(full), resumed=first_eval_loss(back), resumed_at=at)


def ckpt_gather_limit(rank: int, text: str, tmp: str) -> dict:
    """At fsdp 2 x tp 2 with ``msgpack_gather_limit_mb=0``: the one-file
    save refuses; following its advice (a directory) saves; the directory
    restores in a fresh trainer."""
    refused = corpus_trainer(text, os.path.join(tmp, "limit.pt"), 1,
                             dict(dp=1, fsdp=2, tp=2), msgpack_gather_limit_mb=0)
    try:
        refused.save_snapshot(epoch=0)
        refusal = None
    except RuntimeError as e:
        refusal = str(e)
    advised = corpus_trainer(text, os.path.join(tmp, "limit_dir"), 2,
                             dict(dp=1, fsdp=2, tp=2), msgpack_gather_limit_mb=0)
    advised.train()
    back = corpus_trainer(text, os.path.join(tmp, "limit_dir"), 2,
                          dict(dp=1, fsdp=2, tp=2), msgpack_gather_limit_mb=0)
    return dict(refusal=refusal, resumed_at=back.step,
                equal=all(np.array_equal(a, b) for a, b in zip(
                    _leaves_np(advised).values(), _leaves_np(back).values())
                    if isinstance(a, np.ndarray)))


def ckpt_one_process(path: str, cfg_kw: dict):
    """``restore_inference_params`` of a directory, in this process."""
    cfg = GPTConfig.make(**cfg_kw)
    snap = ckpt.restore_inference_params(path, cfg, "cpu")
    return snap.step, {n: p.numpy() for n, p in convert.flatten(snap.params).items()}
