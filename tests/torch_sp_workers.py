"""Rank bodies of the port's multi-process tests (tests/test_torch_ring.py,
tests/test_torch_sp_train.py, tests/test_torch_sharded_train.py,
tests/test_torch_sp_tp.py, tests/test_torch_sharded_serve.py).

``parallel.spawn.run_ranks`` runs them in fresh processes, so this module
imports torch, numpy and the port only: never jax, never the JAX package
(the test files compute the JAX side in the parent). Each takes plain
arguments (numpy arrays, dicts) and returns numpy arrays and numbers.
"""

from __future__ import annotations

import contextlib
import os
import signal
import time

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


def tp_attention_cases(rank: int, cases: dict) -> dict:
    """Ring and Ulysses at dp 1 x sp 2 x tp 2 on this rank's chunk of the
    sequence and its tp share of the heads (q's and, by the GQA group, the
    KV heads'): the output and the q/k/v gradients of sum(out * dO)."""
    torch.set_num_threads(1)
    mesh = Mesh(MeshConfig(sp=2, tp=2))
    results = {}
    for name, case in cases.items():
        q, k, v, do = global_qkv(case["b"], case["t"], case["h"], case["kv"],
                                 case["hd"], case["seed"])

        def mine(a):
            heads = a.shape[2] // mesh.tp
            a = local(a, 1, mesh.sp, 0, mesh.sp_rank)
            return a[:, :, mesh.tp_rank * heads:(mesh.tp_rank + 1) * heads].copy()

        qt, kt, vt = (torch.from_numpy(mine(a)).requires_grad_() for a in (q, k, v))
        out = IMPLS[case["impl"]](qt, kt, vt, mesh)
        (out * torch.from_numpy(mine(do))).sum().backward()
        results[name] = dict(out=out.detach().numpy(), dq=qt.grad.numpy(),
                             dk=kt.grad.numpy(), dv=vt.grad.numpy(),
                             coords=(mesh.sp_rank, mesh.tp_rank))
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
    """This rank's rows (its dp x fsdp shard) and, under sp, its chunk of
    the sequence."""
    n = a.shape[0] // mesh.batch_count
    c = a.shape[1] // mesh.sp
    return torch.from_numpy(np.ascontiguousarray(
        a[mesh.batch_index * n:(mesh.batch_index + 1) * n,
          mesh.sp_rank * c:(mesh.sp_rank + 1) * c])).long()


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


# -- tensor-parallel serving (tests/test_torch_sharded_serve.py) -------------

SERVE_PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13], [40, 41]]
SHARED = list(range(3, 20))  # 17 tokens: a 16-row storable prefix
COMPOSED = [(SHARED + [25, 26], 6), ([1, 2, 3, 4, 5], 8), (SHARED + [27], 5)]


def _solo(params, cfg, prompt, n):
    from mingpt_distributed_tpu_torch.models import generate as gen

    return gen.generate(params, cfg, torch.tensor(prompt)[None], n,
                        device="cpu")[0, len(prompt):].tolist()


def _composed(params, cfg, mesh, kv_dtype=None, attrib=False):
    """Chunked prefill, prefix reuse and a 1-layer draft (k 3), each request
    submitted while the previous ones are mid-flight."""
    import dataclasses

    from mingpt_distributed_tpu_torch.serving import InferenceServer, Request

    draft = dict(params)
    draft["blocks"] = {k: v[:1] for k, v in params["blocks"].items()}
    srv = InferenceServer(params, cfg, n_slots=2, prefill_buckets=(4, 8, 16, 32),
                          prefill_chunk=8, prefix_cache_mb=8.0, warmup=True,
                          draft_params=draft, draft_cfg=dataclasses.replace(cfg, n_layer=1),
                          spec_k=3, mesh=mesh, kv_dtype=kv_dtype, attrib=attrib, device="cpu")
    handles = []
    for prompt, n in COMPOSED:
        handles.append(srv.submit(Request(prompt=prompt, max_new_tokens=n)))
        srv.step()
    srv.run_until_drained(max_steps=200)
    return srv, [h.tokens for h in handles]


def _server_record(srv, tokens) -> dict:
    eng = srv.engine
    entries = eng.prefix_store.entries() if eng.prefix_store is not None else []
    return dict(tokens=tokens, counts=srv.compile_counts(),
                recompiles=srv.watchdog.recompiles, shard=eng.kv_shard_count,
                draft_shard=srv.spec.draft.engine.kv_shard_count if srv.spec else None,
                prefix_hits=srv.metrics.prefix_hits,
                spec=(srv.metrics.spec_accepted, srv.metrics.spec_proposed),
                entry_heads=[int(e["k"].shape[3]) for _, e in entries],
                reports=eng.follower_reports())


def tp_serving(rank: int, tree: dict, cfg_kw: dict) -> dict:
    """tp = 2 serving on two ranks: rank 0 drives every scenario, rank 1
    follows. Placement, slot free and re-admission, the composed parity
    run at tp 2 and tp 1 (and int8 pools), the HBM ledger's per-device
    column, a call that bypasses the dispatch, and the migration seam."""
    from mingpt_distributed_tpu_torch.parallel.mesh import Mesh
    from mingpt_distributed_tpu_torch.serving import DecodeEngine, InferenceServer, Request
    from mingpt_distributed_tpu_torch.serving.lockstep import LockstepError
    from mingpt_distributed_tpu_torch.telemetry import per_device_tree_bytes, tree_bytes

    torch.set_num_threads(1)
    mesh = Mesh.serving(timeout_s=60)
    if rank != 0:
        return {"commands": DecodeEngine.follow(mesh, "cpu")}
    cfg = GPTConfig.make(**cfg_kw)
    params = convert.params_from_numpy(tree, cfg, "cpu")
    out = {}
    eng = DecodeEngine(params, cfg, n_slots=2, mesh=mesh, device="cpu")
    solo = DecodeEngine(params, cfg, n_slots=2, device="cpu")
    out["placement"] = dict(
        shard=eng.kv_shard_count, solo_shard=solo.kv_shard_count,
        shape=tuple(eng.pool.cache["k"].shape), solo_shape=tuple(solo.pool.cache["k"].shape),
        per_device=per_device_tree_bytes(eng.pool.cache),
        total=tree_bytes(solo.pool.cache), report=eng.follower_reports()[0])

    srv = InferenceServer(params, cfg, n_slots=2, mesh=mesh, device="cpu")
    handles = [srv.submit(Request(prompt=p, max_new_tokens=6)) for p in SERVE_PROMPTS]
    srv.step()
    queued = len(srv.queue)
    srv.run_until_drained(max_steps=100)
    late = srv.submit(Request(prompt=SERVE_PROMPTS[0], max_new_tokens=4))
    srv.run_until_drained(max_steps=100)
    out["readmit"] = dict(queued=queued, tokens=[h.tokens for h in handles],
                          late=late.tokens, shard=srv.engine.kv_shard_count,
                          counts=srv.compile_counts(),
                          report=srv.engine.follower_reports()[0],
                          solo=[_solo(params, cfg, p, 6) for p in SERVE_PROMPTS],
                          solo_late=_solo(params, cfg, SERVE_PROMPTS[0], 4))
    # a driver call that skips the dispatch fails at once, and the group
    # still serves afterwards
    t0 = time.monotonic()
    try:
        srv.engine._op_decode(np.zeros(4, np.int64))
        missed = None
    except LockstepError as e:
        missed = str(e)
    out["missed_mirror"] = dict(error=missed, seconds=time.monotonic() - t0)
    again = srv.submit(Request(prompt=SERVE_PROMPTS[1], max_new_tokens=4))
    srv.run_until_drained(max_steps=100)
    out["missed_mirror"]["after"] = again.tokens

    for name, m in (("tp1", None), ("tp2", mesh)):
        s, toks = _composed(params, cfg, m, attrib=True)
        out[name] = _server_record(s, toks)
        hbm = s.attrib_report()["hbm"]
        out[name]["hbm"] = dict(owners=hbm["owners"], per_device=hbm["per_device_bytes"])
    out["solo"] = [_solo(params, cfg, p, n) for p, n in COMPOSED]
    for name, m in (("int8_tp1", None), ("int8_tp2", mesh)):
        s, toks = _composed(params, cfg, m, kv_dtype="int8")
        out[name] = _server_record(s, toks)
    out["seam"] = _seam(params, cfg, mesh)
    eng.shutdown()
    return out


def _seam(params, cfg, mesh) -> dict:
    """Migration's seam under tp: a slot's extracted rows are whole-head and
    equal the tp = 1 engine's; installed into another slot and adopted into
    the prefix store, they read back the same."""
    from mingpt_distributed_tpu_torch.serving import DecodeEngine

    kw = dict(n_slots=2, prefill_buckets=(4, 8, 16, 32), prefix_cache_mb=1.0, device="cpu")
    one = DecodeEngine(params, cfg, **kw)
    two = DecodeEngine(params, cfg, mesh=mesh, **kw)
    prompt = list(range(5, 17))
    for e in (one, two):
        e.prefill_chunk_call(0, prompt, 0, 1.0, None, None, False, None)
    want, got = one.extract_slot_rows(0, 8), two.extract_slot_rows(0, 8)
    two.install_slot_rows(1, got)
    back = two.extract_slot_rows(1, 8)
    adopted = two.adopt_prefix_entry(prompt[:8], got)
    hit = two.try_load_prefix(0, prompt)
    return dict(heads=int(got["k"].shape[3]),
                extract_err=max(float((got[n] - want[n]).abs().max()) for n in want),
                roundtrip_err=max(float((back[n] - got[n]).abs().max()) for n in got),
                adopted=adopted, hit=hit, report=two.follower_reports()[0])


def _affinity_prompts(router, index: int, n: int, length: int = 3) -> list:
    """``n`` prompts the router's prefix affinity sends to replica
    ``index``."""
    out = []
    for start in range(1, 200):
        p = [start + j for j in range(length)]
        if max(p) < 50 and router._affinity_index(p) == index:
            out.append(p)
            if len(out) == n:
                return out
    raise AssertionError(f"no {n} prompts hash to replica {index}")


def tp_fleet(rank: int, tree: dict, cfg_kw: dict, new: int) -> dict:
    """Two tp = 2 replicas whose drivers share rank 0 (groups {0, 1} and
    {0, 2}): replica0 crashes mid-decode (injected), its requests retry on
    the survivor, and the respawned replica rebuilds its follower's
    engines."""
    from mingpt_distributed_tpu_torch.parallel.mesh import serving_meshes
    from mingpt_distributed_tpu_torch.serving import (
        DecodeEngine,
        ReplicaSupervisor,
        Request,
        Router,
        VirtualClock,
        default_server_factory,
    )
    from mingpt_distributed_tpu_torch.training.faults import ServingFaultInjector

    torch.set_num_threads(1)
    meshes = serving_meshes([[0, 1], [0, 2]], timeout_s=60)
    if rank != 0:
        (mesh,) = meshes.values()
        return {"commands": DecodeEngine.follow(mesh, "cpu")}
    cfg = GPTConfig.make(**cfg_kw)
    params = convert.params_from_numpy(tree, cfg, "cpu")
    sup = ReplicaSupervisor(
        default_server_factory(params, cfg, meshes={"replica0": meshes[0],
                                                    "replica1": meshes[1]},
                               n_slots=2, device="cpu"),
        n_replicas=2, clock=VirtualClock(tick_s=0.001),
        injector=ServingFaultInjector("crash:nth=3:match=replica0"),
        max_restarts=1, restart_backoff_s=0.01)
    router = Router(sup, max_retries=3, retry_backoff_s=0.01, breaker_reset_s=0.05)
    prompts = _affinity_prompts(router, 0, 2) + _affinity_prompts(router, 1, 2)
    shards = [rep.server.engine.kv_shard_count for rep in sup.replicas]
    streamed = {}
    router.on_token = lambda fh, tok: streamed.setdefault(fh.request_id, []).append(tok)
    handles = router.generate_batch([Request(prompt=p, max_new_tokens=new) for p in prompts])
    s = router.summary()
    out = dict(shards=shards, crashes=s["replicas"]["replica0"]["crashes"],
               retries=s["retries_by_reason"].get("crash", 0),
               attempts=[h.attempts for h in handles],
               reasons=[h.finish_reason for h in handles],
               tokens=[h.tokens for h in handles],
               streamed=[streamed.get(h.request_id) for h in handles],
               solo=[_solo(params, cfg, p, new) for p in prompts],
               reports=[rep.server.engine.follower_reports()[0] for rep in sup.replicas])
    for rep in sup.replicas:
        rep.server.engine.shutdown()
    return out


def jobs(rank: int, todo: list) -> list:
    """Run several of this module's rank bodies in one spawn: ``todo`` is
    a list of (function name, arguments)."""
    torch.set_num_threads(1)  # the ranks share the test worker's cores
    return [globals()[name](rank, *args) for name, args in todo]


# -- ZeRO (tests/test_torch_zero.py) -------------------------------------------

def _opt(params, mesh, lr, zero, whole=None):
    """The plan of the whole parameters (``whole``, default ``params``) and
    an AdamW over ``params`` (this rank's slices)."""
    from mingpt_distributed_tpu_torch.parallel import zero as zero_lib

    plan = (zero_lib.make_plan(mesh, whole if whole is not None else params)
            if zero and mesh.dp > 1 else None)
    return plan, make_optimizer(OptimizerConfig.make(learning_rate=lr), params, 1.0,
                                mesh=mesh, zero=plan)


def _canonical_mu(opt, full) -> dict:
    """Every leaf's first Adam moment by name, whole and in the canonical
    layout (``canonical_state_dict``; every rank joins the gathers)."""
    sd = opt.canonical_state_dict(full)
    order = [i for g in sd["param_groups"] for i in g["params"]]
    by_id = {id(t): n for n, t in zip(opt.names, opt.shards)}
    names = [by_id[id(t)] for g in opt.opt.param_groups for t in g["params"]]
    return {n: sd["state"][i]["exp_avg"] for i, n in zip(order, names)}


def zero_losses(rank: int, cfg_kw: dict, mesh_kw: dict, params_tree: dict,
                batches: list, lr: float, grad_accum: int = 1, zero: bool = True) -> dict:
    """``make_train_step`` with ``zero_dp`` on a dp (x fsdp x tp) mesh from
    the whole ``params_tree``: the losses, the whole parameters and the
    canonical first Adam moment after the first step (rank 0), the whole
    parameters after the last, this rank's Adam bytes against
    ``opt_moment_bytes`` (and the dense moments' bytes), and the
    collectives' host seconds."""
    from mingpt_distributed_tpu_torch.parallel import zero as zero_lib

    cfg = GPTConfig.make(**cfg_kw)
    mesh = Mesh(MeshConfig(**mesh_kw))
    whole = convert.params_from_numpy(params_tree, cfg, "cpu")
    params = t_trainer.trainable(mesh.shard_params(whole) if mesh.sharded else whole)
    plan, opt = _opt(params, mesh, lr, zero, whole)
    opt.timings = {}
    opt.init_moments()
    moment_bytes = opt.moment_bytes()
    state = t_trainer.TrainState(params, opt)
    step = t_trainer.make_train_step(cfg, grad_accum=grad_accum, mesh=mesh)
    full = (lambda n, t: mesh.gather_full(n, t)) if mesh.sharded else (lambda n, t: t)

    def whole_params():
        if mesh.sharded:
            return _whole(mesh, state.params)
        return {n: p.detach().numpy().copy() for n, p in convert.flatten(state.params).items()}

    losses, first, norms = [], None, []
    for i, (x, y) in enumerate(batches):
        m = step(state, (_rows(x, mesh), _rows(y, mesh)))
        losses.append(m["loss"].item())
        norms.append((m["grad_norm"].item(), m["update_norm"].item()))
        if i == 0:  # every rank joins the gathers; rank 0 keeps the result
            mu = _canonical_mu(opt, full)
            first = dict(params=whole_params(), mu={n: t.numpy() for n, t in mu.items()})
    return dict(losses=losses, norms=norms, first=first if rank == 0 else None,
                last=whole_params(), moment_bytes=moment_bytes,
                planned_bytes=zero_lib.opt_moment_bytes(whole, plan),
                dense_bytes=zero_lib.opt_moment_bytes(whole, None),
                timings=dict(opt.timings),
                modes={n: lp.mode for n, lp in plan.by_name.items()} if plan else None)


def zero_flat_parity(rank: int) -> dict:
    """A leaf dp does not divide (5 elements at dp 4: flat mode, pad 3):
    the sharded clip + AdamW step against the replicated one in this
    process."""
    mesh = Mesh(MeshConfig(dp=-1))
    out = {}
    for zero in (False, True):
        p = {"lnf_bias": torch.linspace(-1.0, 1.0, 5).requires_grad_()}
        plan, opt = _opt(p, mesh, 1e-2, zero)
        p["lnf_bias"].grad = torch.linspace(3.0, -2.0, 5)
        if zero:
            opt.reduce_grads()
            # every rank held the same gradient: the sum over dp is dp times it
            for s in opt.shards:
                s.grad /= mesh.dp
        m = opt.step(0)
        out["zero" if zero else "dense"] = dict(
            value=p["lnf_bias"].detach().numpy(), grad_norm=m["grad_norm"].item(),
            mode=plan.by_name["lnf_bias"].mode if plan else None,
            pad=plan.by_name["lnf_bias"].pad if plan else None,
            shard=tuple(opt.shards[0].shape))
    return out


def _zero_trainer(text, snapshot, max_steps, mesh_kw, zero=True, **kw):
    return _sharded_trainer(text, snapshot, max_steps, mesh_kw, zero_dp=zero, **kw)


def _canonical(tr) -> dict:
    """The trainer's whole parameters and canonical Adam state (every rank
    joins the gathers)."""
    params, opt_state = (tr._gather_state() if tr.sharded or tr.zero_plan is not None
                         else ({n: p.detach() for n, p in
                                convert.flatten(tr.state.params).items()},
                               tr.state.optimizer.opt.state_dict()))
    flat = convert.flatten(params) if "blocks" in params else params
    moments = {f"{k}/{i}": st[k].numpy() for i, st in opt_state["state"].items()
               for k in ("exp_avg", "exp_avg_sq")}
    return dict(params={n: p.numpy() for n, p in flat.items()}, moments=moments)


def zero_trainer(rank: int, text: str, tmp: str) -> dict:
    """GPTTrainer with zero_dp at dp 4: an uninterrupted 8-step run; 4 steps
    and a snapshot, resumed to 8; the dp 4 snapshot restored at dp 2 x tp 2
    (a plan of dp 2) and gathered back; the moment bytes; the snapshot's
    shard objects."""
    full = _zero_trainer(text, os.path.join(tmp, "zfull.pt"), 8, dict(dp=-1))
    full_last = full.train()
    _zero_trainer(text, os.path.join(tmp, "zhalf.pt"), 4, dict(dp=-1)).train()
    resumed = _zero_trainer(text, os.path.join(tmp, "zhalf.pt"), 8, dict(dp=-1))
    resumed_at = resumed.step
    resumed_last = resumed.train()
    full_eval, resumed_eval = full.evaluate(), resumed.evaluate()
    # a dp 4 snapshot at step 4, read back at dp 2 x tp 2 (a dp 2 plan)
    dp4 = _zero_trainer(text, os.path.join(tmp, "z4.pt"), 4, dict(dp=-1))
    dp4.train()
    wrote = _canonical(dp4)
    at2 = _zero_trainer(text, os.path.join(tmp, "z4.pt"), 4, dict(dp=2, tp=2))
    read2 = _canonical(at2)
    opt = full.state.optimizer
    # attribution: the step registered as "zero", the moments at their share
    from mingpt_distributed_tpu_torch.parallel import zero as zero_lib
    from mingpt_distributed_tpu_torch.telemetry.attribution import HBMLedger, ProgramLedger

    attrib = {}
    for run, mesh_kw in (("dp4", dict(dp=-1)), ("dp2_fsdp2", dict(dp=2, fsdp=2))):
        ticks = iter(range(10 ** 6))
        ledger, hbm = ProgramLedger(), HBMLedger(capacity_bytes=1e12)
        attributed = _zero_trainer(text, os.path.join(tmp, f"zattr_{run}.pt"), 2, mesh_kw)
        attributed.register_attrib(ledger, lambda: float(next(ticks)), hbm)
        attributed.train()
        stats = ledger._programs[("train_step", attributed._attrib_variant)]
        whole = {n: torch.empty(s, device="meta")
                 for n, s in (attributed.mesh.full_shapes.items() if attributed.sharded
                              else ((n, p.shape) for n, p in
                                    convert.flatten(attributed.state.params).items()))}
        attrib[run] = dict(variant=attributed._attrib_variant, calls=stats.calls,
                           opt_state=hbm.owners()["opt_state"],
                           held=attributed.state.optimizer.moment_bytes(),
                           local=zero_lib.opt_moment_bytes(attributed.state.params,
                                                           attributed.zero_plan),
                           planned=zero_lib.opt_moment_bytes(convert.unflatten(whole),
                                                             attributed.zero_plan),
                           dense=zero_lib.opt_moment_bytes(convert.unflatten(whole)))
    return dict(full_loss=full_last["loss"], attrib=attrib, resumed_loss=resumed_last["loss"],
                full_eval=full_eval, resumed_eval=resumed_eval, resumed_at=resumed_at,
                full=_canonical(full)["params"], resumed=_canonical(resumed)["params"],
                wrote=wrote, read2=read2, at2_step=at2.step,
                at2_plan_dp=at2.zero_plan.dp if at2.zero_plan else None,
                moment_bytes=opt.moment_bytes(), shards=len(opt.shards),
                dense_bytes=sum(2 * p.numel() * 4 for p in opt.params),
                shard_files=sorted(f for f in os.listdir(tmp) if f.startswith("z4.pt")))


def reshard_tree() -> dict:
    """Three leaves of the ZeRO plan's modes at dp 4 and 2: ``wte`` (8, 3)
    split on dim 0, ``head`` (3, 8) on dim 1,
    ``lnf_bias`` (5,) flat (pad 3 at dp 4, 1 at dp 2)."""
    return {"wte": torch.arange(24.0).reshape(8, 3).requires_grad_(),
            "head": torch.arange(24.0).reshape(3, 8).mul(0.5).requires_grad_(),
            "lnf_bias": torch.arange(5.0).requires_grad_()}


def _state_arrays(sd) -> dict:
    """An optimizer state dict's moments and counts as numpy arrays."""
    return {f"{i}/{k}": v.detach().numpy().copy() for i, st in sd["state"].items()
            for k, v in st.items()}


def zero_reshard(rank: int, tmp: str) -> dict:
    """AdamW's snapshot path at dp 4 -> dp 2: a dp 4 ZeRO update over
    ``reshard_tree`` (each rank's gradients differ, so the reduce-scatter
    sums), its canonical state saved as 4 shard objects; restored at dp 2
    (x sp 2: the parameters whole on every rank) and saved again as 2.
    Returns both canonical states and each rank's shard shapes."""
    from mingpt_distributed_tpu_torch.parallel import distributed as D
    from mingpt_distributed_tpu_torch.training import checkpoint as ckpt
    from mingpt_distributed_tpu_torch.training.durability import NO_WAIT

    out = {}
    p4 = reshard_tree()
    _, opt4 = _opt(p4, Mesh(MeshConfig(dp=4)), 1e-2, True)
    for p in p4.values():
        p.grad = torch.linspace(-1.0, 2.0, p.numel()).reshape(p.shape) * (1 + rank)
    opt4.reduce_grads()
    opt4.step(0)
    sd4 = opt4.canonical_state_dict(lambda _n, t: t)
    out["shapes4"] = {n: tuple(t.shape) for n, t in zip(opt4.names, opt4.shards)}
    params = {n: p.detach().clone() for n, p in p4.items()}
    if rank == 0:
        ckpt.save_snapshot(os.path.join(tmp, "r4.pt"),
                           {"params": params, "opt_state": sd4, "step": 1, "epoch": 0},
                           retry=NO_WAIT, shards=4)
    D.barrier()
    snap = ckpt.load_snapshot(os.path.join(tmp, "r4.pt"), retry=NO_WAIT)
    p2 = reshard_tree()
    with torch.no_grad():
        for n, p in p2.items():
            p.copy_(snap["params"][n])
    _, opt2 = _opt(p2, Mesh(MeshConfig(dp=2, sp=2)), 1e-2, True)
    opt2.load_canonical_state_dict(snap["opt_state"], lambda _n, t: t)
    out["shapes2"] = {n: tuple(t.shape) for n, t in zip(opt2.names, opt2.shards)}
    sd2 = opt2.canonical_state_dict(lambda _n, t: t)
    if rank == 0:
        ckpt.save_snapshot(os.path.join(tmp, "r2.pt"),
                           {"params": params, "opt_state": sd2, "step": 1, "epoch": 0},
                           retry=NO_WAIT, shards=2)
    D.barrier()
    out.update(sd4=_state_arrays(sd4), sd2=_state_arrays(sd2),
               params={n: t.numpy() for n, t in params.items()})
    return out


# -- mixture of experts across ranks (tests/test_torch_moe_ep.py) -------------

def _exchange(mesh):
    return gpt._moe_exchange(mesh)


def moe_layer_cases(rank: int, cases: dict) -> dict:
    """``moe_mlp`` on this rank's rows of each case's global (B, T, D) input
    over the case's mesh: the output rows, the aux loss, and the whole
    gradients of the router, of the expert weights (summed over the ranks
    and gathered from this rank's experts and columns) and of the input
    rows, of sum(out * g) + aux."""
    from mingpt_distributed_tpu_torch.ops import moe
    from mingpt_distributed_tpu_torch.parallel import distributed as D

    out = {}
    for name, c in cases.items():
        mesh = Mesh(MeshConfig(**c["mesh"]))
        whole = {"blocks": {k: torch.from_numpy(v)[None] for k, v in c["w"].items()}}
        local = mesh.shard_params(whole)["blocks"] if mesh.sharded else whole["blocks"]
        leaves = {k: v[0].clone().requires_grad_() for k, v in local.items()}
        used = ({k: mesh.gather(f"blocks/{k}", v, keep_tp=True, layer=True)
                 for k, v in leaves.items()} if mesh.sharded else leaves)
        n = c["x"].shape[0] // mesh.batch_count
        rows = slice(mesh.batch_index * n, (mesh.batch_index + 1) * n)
        x = torch.from_numpy(c["x"][rows]).requires_grad_()
        y, aux = moe.moe_mlp(x, used["w_router"], used["w_e1"], used["w_e2"],
                             w_gate=used.get("w_eg"), top_k=c["top_k"],
                             capacity_factor=c["cf"], exchange=gpt._moe_exchange(mesh),
                             tp_group=mesh.tp_group if mesh.tp > 1 else None)
        ((y * torch.from_numpy(c["g"][rows])).sum() + aux).backward()
        grads = {}
        for k, v in leaves.items():
            path = f"blocks/{k}"
            gr = v.grad[None].contiguous()
            D.all_reduce(gr, mesh.grad_group(path))
            grads[k] = (mesh.gather_full(path, gr) if mesh.sharded else gr)[0].numpy()
        out[name] = dict(y=y.detach().numpy(), aux=aux.item(), grads=grads,
                         x_grad=x.grad.numpy(), rows=(rows.start, n))
    return out


def moe_forward(rank: int, cfg_kw: dict, mesh_kw: dict, params_tree: dict,
                tokens: np.ndarray) -> dict:
    """The MoE model's forward on this rank's rows of ``tokens`` over the
    mesh: its logits and the global loss (token mean plus the aux term)."""
    from mingpt_distributed_tpu_torch.parallel import distributed as D

    cfg = GPTConfig.make(**cfg_kw)
    mesh = Mesh(MeshConfig(**mesh_kw))
    whole = convert.params_from_numpy(params_tree, cfg, "cpu")
    params = mesh.shard_params(whole) if mesh.sharded else whole
    x = _rows(tokens, mesh)
    with torch.no_grad():
        logits, _ = gpt.forward(params, x, cfg, mesh=mesh)
        total, count, aux = gpt.loss_terms(params, x, x, cfg, mesh=mesh, with_aux=True)
    loss = D.all_reduce(total, mesh.batch_group) / D.all_reduce(
        count.float(), mesh.batch_group) + aux
    return dict(logits=logits.numpy(), loss=loss.item(),
                rows=(mesh.batch_index * x.shape[0], x.shape[0]),
                local_experts=int(params["blocks"]["w_e1"].shape[1]))


def moe_trainer(rank: int, text: str, tmp: str, mesh_kw: dict, moe_kw: dict) -> dict:
    """GPTTrainer on an MoE model over the mesh: 8 steps' losses, this
    rank's expert count and the eval loss."""
    data = CharDataset(DataConfig.make(block_size=16), text=text)
    train, test = data.split()
    gcfg = GPTConfig.make(n_layer=2, n_head=2, n_embd=32, vocab_size=data.vocab_size,
                          block_size=16, dtype="float32", embd_pdrop=0.0,
                          resid_pdrop=0.0, attn_pdrop=0.0, **moe_kw)
    tcfg = TrainerConfig.make(batch_size=16, max_steps=8, log_every=1, eval_batches=2,
                              grad_norm_clip=1.0, snapshot_path=os.path.join(tmp, "moe.pt"),
                              seed=7, mesh=mesh_kw)
    tr = t_trainer.GPTTrainer(tcfg, gcfg, OptimizerConfig(learning_rate=1e-2), train, test,
                              device="cpu")
    losses = []
    for xy in tr.train_iter.epoch_batches():
        losses.append(tr._train_step(tr.state, tr._put_batch(xy), tr.generator)["loss"].item())
        if len(losses) == 8:
            break
    return dict(losses=losses, local_experts=int(tr.state.params["blocks"]["w_e1"].shape[1]),
                eval_loss=tr.evaluate(), experts=gcfg.n_experts)


def moe_tp_serving(rank: int, tree: dict, cfg_kw: dict, prompts: list, new: int) -> dict:
    """An MoE model served at tp = 2 by ranks 0 and 1 (rank 0 drives; the
    other ranks hold no group) and at tp = 1 by rank 0: greedy tokens, each
    rank's pool and its experts' hidden width, and the largest logit
    difference of one prefill."""
    from mingpt_distributed_tpu_torch.parallel.mesh import serving_meshes
    from mingpt_distributed_tpu_torch.serving import DecodeEngine, InferenceServer, Request

    meshes = serving_meshes([[0, 1]], timeout_s=60)
    if rank > 1:
        return {}
    if rank == 1:
        (mesh,) = meshes.values()
        return {"commands": DecodeEngine.follow(mesh, "cpu")}
    cfg = GPTConfig.make(**cfg_kw)
    params = convert.params_from_numpy(tree, cfg, "cpu")
    out = {}
    for name, mesh in (("tp1", None), ("tp2", meshes[0])):
        srv = InferenceServer(params, cfg, n_slots=2, mesh=mesh, device="cpu")
        handles = [srv.submit(Request(prompt=p, max_new_tokens=new)) for p in prompts]
        srv.run_until_drained(max_steps=500)
        eng = srv.engine
        out[name] = dict(tokens=[h.tokens for h in handles],
                         pool=tuple(eng.pool.cache["k"].shape),
                         ffn_local=int(eng.params["blocks"]["w_e1"].shape[-1]),
                         reports=eng.follower_reports())
        if mesh is not None:
            eng.shutdown()
    return out
