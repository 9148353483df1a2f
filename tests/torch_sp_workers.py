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
