"""Rank bodies of the port's multi-process tests (tests/test_torch_ring.py,
tests/test_torch_sp_train.py, tests/test_torch_sharded_train.py).

``parallel.spawn.run_ranks`` runs them in fresh processes, so this module
imports torch, numpy and the port only: never jax, never the JAX package
(the test files compute the JAX side in the parent). Each takes plain
arguments (numpy arrays, dicts) and returns numpy arrays and numbers.
"""

from __future__ import annotations

import contextlib
import os
import signal

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
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import gpt
from mingpt_distributed_tpu_torch.ops import flash_attention as fa
from mingpt_distributed_tpu_torch.parallel import ring_attention, ulysses
from mingpt_distributed_tpu_torch.parallel.mesh import Mesh
from mingpt_distributed_tpu_torch.training import trainer as t_trainer
from mingpt_distributed_tpu_torch.training.optimizer import make_optimizer

IMPLS = {"ring": ring_attention.ring_causal_attention,
         "ulysses": ulysses.ulysses_causal_attention}


def global_qkv(b, t, h, kv, hd, seed):
    """The global q, k, v and output cotangent of a case, float32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, hd)).astype(np.float32),
            rng.standard_normal((b, t, kv, hd)).astype(np.float32),
            rng.standard_normal((b, t, kv, hd)).astype(np.float32),
            rng.standard_normal((b, t, h, hd)).astype(np.float32))


def local(a: np.ndarray, dp: int, sp: int, dp_rank: int, sp_rank: int) -> np.ndarray:
    """This rank's rows (dp replica) and columns (sp chunk) of a global
    (B, T, ...) array."""
    rows, c = a.shape[0] // dp, a.shape[1] // sp
    return a[dp_rank * rows:(dp_rank + 1) * rows, sp_rank * c:(sp_rank + 1) * c]


def _local(a, mesh):
    return local(a, mesh.dp, mesh.sp, mesh.dp_rank, mesh.sp_rank)


@contextlib.contextmanager
def counting_kernel_calls(calls: list):
    """Record every K3 call (its batch of heads, q and k lengths, causal
    flag) and every K4 call of the ring, on the CPU where the wrappers run
    their plain versions and count nothing."""
    real_fwd, real_bwd = fa.attention_with_lse, fa.flash_lse_bwd

    def fwd(q, k, v, **kw):
        calls.append(("fwd", q.shape[0] * q.shape[2], q.shape[1], k.shape[1],
                      kw.get("causal", True), kw.get("q_offset", 0)))
        return real_fwd(q, k, v, **kw)

    def bwd(*a, **kw):
        calls.append(("bwd",))
        return real_bwd(*a, **kw)

    fa.attention_with_lse, fa.flash_lse_bwd = fwd, bwd
    try:
        yield
    finally:
        fa.attention_with_lse, fa.flash_lse_bwd = real_fwd, real_bwd


def attention_cases(rank: int, cases: dict) -> dict:
    """Every case whose dp x sp is this job's size: the rank's output and
    q/k/v gradients of sum(out * dO), and its K3/K4 calls."""
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    world = int(os.environ["WORLD_SIZE"])
    results = {}
    for name, case in cases.items():
        if case["dp"] * case["sp"] != world:
            continue
        mesh = Mesh(MeshConfig(dp=case["dp"], sp=case["sp"]))
        q, k, v, do = global_qkv(case["b"], case["t"], case["h"], case["kv"],
                                 case["hd"], case["seed"])
        qt, kt, vt = (torch.from_numpy(_local(a, mesh).copy()).requires_grad_()
                      for a in (q, k, v))
        kw = dict(case.get("kw", {}))
        if "gen_seed" in case:
            kw.update(generator=torch.Generator().manual_seed(case["gen_seed"]),
                      deterministic=False)
        calls: list = []
        with counting_kernel_calls(calls):
            out = IMPLS[case["impl"]](qt, kt, vt, mesh, **kw)
            (out * torch.from_numpy(_local(do, mesh).copy())).sum().backward()
        results[name] = dict(out=out.detach().numpy(), dq=qt.grad.numpy(),
                             dk=kt.grad.numpy(), dv=vt.grad.numpy(), calls=calls)
    return results


def train_losses(rank: int, cfg_kw: dict, mesh_kw: dict, params_tree: dict,
                 batches: list, lr: float) -> list:
    """``make_train_step`` with this job's mesh on the rank's share of each
    global batch; the losses of every step."""
    cfg = GPTConfig.make(**cfg_kw)
    mesh = Mesh(MeshConfig(**mesh_kw))
    params = t_trainer.trainable(convert.params_from_numpy(params_tree, cfg, "cpu"))
    state = t_trainer.TrainState(params, make_optimizer(
        OptimizerConfig.make(learning_rate=lr), params, 1.0))
    step = t_trainer.make_train_step(cfg, mesh=mesh)
    losses = []
    for x, y in batches:
        m = step(state, (torch.from_numpy(_local(x, mesh)).long(),
                         torch.from_numpy(_local(y, mesh)).long()))
        losses.append(m["loss"].item())
    return losses


def _trainer(text, snapshot, max_steps, mesh_kw, attention, seed=3):
    data = CharDataset(DataConfig.make(block_size=16), text=text)
    train, test = data.split()
    gcfg = GPTConfig.make(n_layer=2, n_head=2, n_embd=32, vocab_size=data.vocab_size,
                          block_size=16, dtype="float32", attention=attention,
                          embd_pdrop=0.1, resid_pdrop=0.1, attn_pdrop=0.0)
    tcfg = TrainerConfig.make(batch_size=8, max_steps=max_steps, log_every=1,
                              eval_batches=2, snapshot_path=snapshot, seed=seed,
                              mesh=mesh_kw)
    return t_trainer.GPTTrainer(tcfg, gcfg, OptimizerConfig(learning_rate=1e-3),
                                train, test, device="cpu")


def _params(tr) -> np.ndarray:
    return np.concatenate([p.detach().numpy().ravel()
                           for p in gpt._leaves(tr.state.params)])


def trainer_resume(rank: int, text: str, tmp: str, mesh_kw: dict,
                   attention: str) -> dict:
    """An uninterrupted 6-step run against 3 steps, a snapshot (rank 0
    writes) and a resumed run to 6 on every rank; then a stop requested on
    the last rank alone at step 2, which every rank must obey."""
    whole = _trainer(text, os.path.join(tmp, "whole.pt"), 6, mesh_kw, attention)
    last_whole = whole.train()
    first = _trainer(text, os.path.join(tmp, "part.pt"), 3, mesh_kw, attention)
    first.train()
    resumed = _trainer(text, os.path.join(tmp, "part.pt"), 6, mesh_kw, attention)
    resumed_at = resumed.step
    last_resumed = resumed.train()

    stopping = _trainer(text, os.path.join(tmp, "stop.pt"), 50, mesh_kw, attention)
    real = stopping._train_step
    world = int(os.environ["WORLD_SIZE"])

    def step_then_stop(state, batch, generator=None):
        m = real(state, batch, generator)
        if state.step == 2 and rank == world - 1:
            stopping._on_signal(signal.SIGTERM, None)
        return m

    stopping._train_step = step_then_stop
    stopping.train()
    return dict(resumed_at=resumed_at, whole=_params(whole), resumed=_params(resumed),
                whole_loss=last_whole["loss"], resumed_loss=last_resumed["loss"],
                eval_loss=last_whole.get("eval_loss"),
                stopped_at=stopping.step, preempted=stopping.preempted,
                generators_equal=bool(torch.equal(whole.generator.get_state(),
                                                  resumed.generator.get_state())))


def _whole(mesh, params) -> dict:
    """Every rank joins the gather; rank 0 returns the whole leaves."""
    out = {n: mesh.gather_full(n, p).numpy()
           for n, p in convert.flatten(params).items()}
    return out if mesh.rank == 0 else None


def _rows(a: np.ndarray, mesh) -> torch.Tensor:
    n = a.shape[0] // mesh.batch_count
    return torch.from_numpy(a[mesh.batch_index * n:(mesh.batch_index + 1) * n]).long()


def sharded_losses(rank: int, cfg_kw: dict, mesh_kw: dict, params_tree: dict,
                   batches: list, lr: float) -> dict:
    """``make_train_step`` on a dp x fsdp x tp mesh from the whole
    ``params_tree`` (this rank's slices of it) on its rows of each global
    batch: the losses, the whole parameters after the first and the last
    step (rank 0, with the first Adam moment after the first), this rank's
    and the whole ``wq`` sizes, the parameter and
    Adam-moment elements this rank holds, and the downgrade counter."""
    from mingpt_distributed_tpu_torch import telemetry

    cfg = GPTConfig.make(**cfg_kw)
    mesh = Mesh(MeshConfig(**mesh_kw))
    params = t_trainer.trainable(mesh.shard_params(
        convert.params_from_numpy(params_tree, cfg, "cpu")))
    state = t_trainer.TrainState(params, make_optimizer(
        OptimizerConfig.make(learning_rate=lr), params, 1.0, mesh=mesh))
    step = t_trainer.make_train_step(cfg, mesh=mesh)
    losses, first = [], None
    for i, (x, y) in enumerate(batches):
        losses.append(step(state, (_rows(x, mesh), _rows(y, mesh)))["loss"].item())
        if i == 0:  # every rank joins the gathers; rank 0 keeps the result
            mu = state.optimizer.adam_state()["mu"]
            first = dict(params=_whole(mesh, state.params),
                         mu=_whole(mesh, convert.unflatten(mu)))
    moments = state.optimizer.adam_state()
    fam = telemetry.get_registry().counter("mingpt_train_sharding_downgrades_total",
                                           labels=("param",))
    return dict(losses=losses, first=first, last=_whole(mesh, state.params),
                wq_local=params["blocks"]["wq"].numel(),
                wq_whole=int(np.prod(mesh.full_shapes["blocks/wq"])),
                param_elems=sum(p.numel() for p in gpt._leaves(params)),
                moment_elems=sum(t.numel() for t in moments["mu"].values())
                + sum(t.numel() for t in moments["nu"].values()),
                downgrades={tuple(sorted(lab.items())): child.value
                            for lab, child in fam.children()})


def _sharded_trainer(text, snapshot, max_steps, mesh_kw, **kw):
    """A GPTTrainer at n_head 4, no dropout, so runs on different meshes
    take the same steps."""
    data = CharDataset(DataConfig.make(block_size=16), text=text)
    train, test = data.split()
    gcfg = GPTConfig.make(n_layer=2, n_head=4, n_embd=32, vocab_size=data.vocab_size,
                          block_size=16, dtype="float32", embd_pdrop=0.0,
                          resid_pdrop=0.0, attn_pdrop=0.0)
    tcfg = TrainerConfig.make(batch_size=8, max_steps=max_steps, log_every=1,
                              eval_batches=2, snapshot_path=snapshot, seed=3,
                              mesh=mesh_kw, **kw)
    return t_trainer.GPTTrainer(tcfg, gcfg, OptimizerConfig(learning_rate=1e-3),
                                train, test, device="cpu")


def sharded_trainer(rank: int, text: str, tmp: str, mesh_kw: dict) -> dict:
    """GPTTrainer on the mesh: an uninterrupted 6-step run; 3 steps and a
    snapshot (every rank gathers, rank 0 writes) that the parent resumes in
    one process; a resume to 6 from the parent's one-process snapshot; and a
    save refused above ``msgpack_gather_limit_mb`` on every rank."""
    whole = _sharded_trainer(text, os.path.join(tmp, "whole22.pt"), 6, mesh_kw)
    last = whole.train()
    _sharded_trainer(text, os.path.join(tmp, "part22.pt"), 3, mesh_kw).train()
    resumed = _sharded_trainer(text, os.path.join(tmp, "one.pt"), 6, mesh_kw)
    resumed_at = resumed.step
    last_resumed = resumed.train()
    refused = _sharded_trainer(text, os.path.join(tmp, "refused.pt"), 1, mesh_kw,
                               msgpack_gather_limit_mb=0)
    try:
        refused.save_snapshot(epoch=0)
        refusal = None
    except RuntimeError as e:
        refusal = str(e)
    return dict(whole=_whole(whole.mesh, whole.state.params), whole_loss=last["loss"],
                eval_loss=last.get("eval_loss"), resumed_at=resumed_at,
                resumed=_whole(resumed.mesh, resumed.state.params),
                resumed_loss=last_resumed["loss"], refusal=refusal)


def jobs(rank: int, todo: list) -> list:
    """Run several of this module's rank bodies in one spawn: ``todo`` is
    a list of (function name, arguments)."""
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    return [globals()[name](rank, *args) for name, args in todo]
