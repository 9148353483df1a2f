"""ZeRO weight-update sharding in the port (``parallel/zero.py``,
``zero_dp``), on 4 gloo CPU ranks, against the JAX package's trainer and
its ``parallel/zero.py``.

The JAX side is ``tests/test_trainer.py``'s setup (the inline corpus, vocab
25, block 16, global batch 16, AdamW lr 1e-2, clip 1.0, seed 7) at n_layer 2,
n_head 4, n_embd 32, no dropout, fp32, with ``zero_dp=True`` on the
conftest's CPU devices at dp 4 (grad_accum 1 and 2), dp 2 x fsdp 2 and
dp 2 x tp 2. Its initial parameters and first 4 global batches go to the
port's ranks, which train with ``make_train_step`` and a ZeRO plan on the
same mesh. Losses must equal the JAX trainer's within 1e-5 relative, the
first Adam moment (canonical layout) within 1e-5 relative, and the
parameters after the first update within 1e-5 wherever |g| > 1e-6. Each
rank's Adam bytes equal ``opt_moment_bytes`` (a quarter of the dense ones
at dp 4). ``make_plan`` equals JAX's leaf by leaf on GPT-2 124M and Llama
shapes at dp 2 and 4 and beside fsdp and tp.

Then ``GPTTrainer`` with ``zero_dp``: 4 + 4 steps resumed equal 8 straight,
a dp 4 snapshot (4 shard objects) restores bitwise at dp 2 x tp 2 and in
one process, and a directory snapshot path is refused. AdamW's snapshot
path reshards a dp 4 state to dp 2 and dp 1 bitwise. The sharded
manifest entries: a commit survives
every-third-write faults, a torn shard falls back to the entry before, and
``shards=1`` is the one-object save byte for byte. ``train.py
--selftest-faults`` and ``--selftest-zero`` pass. The ranks are spawned
once for the module; while they train, the parent runs the JAX trainers.
"""

import concurrent.futures
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from mingpt_distributed_tpu.config import GPTConfig as JConfig
from mingpt_distributed_tpu.config import MeshConfig as JMeshConfig
from mingpt_distributed_tpu.models import gpt as j_gpt
from mingpt_distributed_tpu.parallel import mesh as j_mesh
from mingpt_distributed_tpu.parallel import zero as j_zero
from mingpt_distributed_tpu_torch import train as t_train
from mingpt_distributed_tpu_torch.config import ConfigError, GPTConfig
from mingpt_distributed_tpu_torch.models import gpt
from mingpt_distributed_tpu_torch.parallel import zero
from mingpt_distributed_tpu_torch.parallel.spawn import run_ranks
from mingpt_distributed_tpu_torch.training import checkpoint as t_ckpt
from mingpt_distributed_tpu_torch.training import durability as dur
from mingpt_distributed_tpu_torch.training.durability import NO_WAIT
from mingpt_distributed_tpu_torch.training.faults import FaultInjectionFileSystem
from tests import test_trainer as tt
from tests import torch_sp_workers as W
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

STEPS = 4
LR = 1e-2
LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_ATOL = 1e-5
STEADY_GRAD = 1e-6
RUNS = {"dp4": (dict(dp=4), 1), "dp4_ga2": (dict(dp=4), 2),
        "dp2_fsdp2": (dict(dp=2, fsdp=2), 1), "dp2_tp2": (dict(dp=2, tp=2), 1)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_zero_run(tmp, name, mesh_kw, grad_accum):
    """The JAX trainer with zero_dp on ``mesh_kw``: its initial parameters,
    first STEPS batches and losses, and the parameters and canonical first
    moment after its first update."""
    orig = tt.tiny_gpt_cfg
    tt.tiny_gpt_cfg = lambda **kw: orig(**dict(dict(n_head=4), **kw))
    try:
        jtr = tt.make_trainer(tmp, mesh_cfg=JMeshConfig(**dict(dict(fsdp=1), **mesh_kw)),
                              snapshot=name, max_steps=STEPS, log_every=1, zero_dp=True,
                              grad_accum_steps=grad_accum)
    finally:
        tt.tiny_gpt_cfg = orig
    assert jtr.zero_plan is not None and jtr.zero_plan.dp == mesh_kw["dp"]
    params = jax.device_get(jtr.state["params"])
    batches, losses, first = [], [], None
    for xy in jtr.train_iter.epoch_batches():
        if len(batches) == STEPS:
            break
        batches.append(xy)
        jtr.state, m = jtr._train_step(jtr.state, jtr._put_batch(xy), jtr.base_rng)
        losses.append(float(jax.device_get(m["loss"])))
        if first is None:
            canon = j_zero.canonical_opt_state(jax.device_get(jtr.state["opt_state"]),
                                               jtr.zero_plan)
            adam = [s for s in jax.tree.leaves(
                canon, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
                if isinstance(s, optax.ScaleByAdamState)][0]
            first = dict(params=_flat(jax.device_get(jtr.state["params"])),
                         mu=_flat(adam.mu))
    return dict(params=params, batches=batches, losses=losses, first=first)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    tmp = tmp_path_factory.mktemp("zero")
    # the first JAX run gives the weights and batches every port run starts from
    ref = _jax_zero_run(tmp, "z_dp4.msgpack", *RUNS["dp4"])
    vocab = ref["params"]["wte"].shape[0]
    cfg_kw = dict(n_layer=2, n_head=4, n_embd=32, vocab_size=vocab, block_size=16,
                  embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
    todo = [("zero_losses", (cfg_kw, mesh, ref["params"], ref["batches"], LR, ga))
            for mesh, ga in RUNS.values()]
    todo.append(("zero_losses", (cfg_kw, dict(dp=4), ref["params"], ref["batches"], LR, 1,
                                 False)))
    todo += [("zero_flat_parity", ()), ("zero_trainer", (tt.CORPUS, str(tmp))),
             ("zero_reshard", (str(tmp),))]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, W.jobs, 4, (todo,), timeout_s=300)
        jax_runs = {"dp4": ref}
        for run, (mesh, ga) in RUNS.items():
            if run != "dp4":
                jax_runs[run] = _jax_zero_run(tmp, f"z_{run}.msgpack", mesh, ga)
        per_rank = ranks.result()
    n = len(RUNS)
    return dict(tmp=tmp, jax=jax_runs,
                port={run: [r[i] for r in per_rank] for i, run in enumerate(RUNS)},
                dense=[r[n] for r in per_rank], flat=[r[n + 1] for r in per_rank],
                trainer=[r[n + 2] for r in per_rank], reshard=[r[n + 3] for r in per_rank])


@pytest.mark.parametrize("run", sorted(RUNS))
def test_zero_losses_match_the_jax_zero_trainer(runs, run):
    want = runs["jax"][run]["losses"]
    assert len(want) == STEPS and want[-1] < want[0]
    for r in runs["port"][run]:
        assert r["losses"] == runs["port"][run][0]["losses"]  # every rank
        np.testing.assert_allclose(r["losses"], want, **LOSS_TOL)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_zero_post_update_parameters_match_the_jax_trainer(runs, run):
    """After the first update: the canonical first Adam moment within 1e-5
    relative, the parameters within 1e-5 where the gradient is above 1e-6
    (Adam's update divides by |g| + eps: near eps the float32
    reassociation of the sharded sums moves a parameter further)."""
    got = runs["port"][run][0]["first"]
    want = runs["jax"][run]["first"]
    assert set(got["params"]) == set(want["params"]) == set(got["mu"])
    n_steady = n_all = 0
    for name, w in want["params"].items():
        np.testing.assert_allclose(got["mu"][name], want["mu"][name], rtol=1e-5, atol=1e-9,
                                   err_msg=f"mu {name}")
        steady = np.abs(want["mu"][name]) > 0.1 * STEADY_GRAD
        n_steady, n_all = n_steady + steady.sum(), n_all + steady.size
        np.testing.assert_allclose(got["params"][name][steady], w[steady], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    assert n_steady > 0.9 * n_all


def test_zero_matches_the_replicated_update_of_the_port(runs):
    dense, sharded = runs["dense"][0], runs["port"]["dp4"][0]
    np.testing.assert_allclose(sharded["losses"], dense["losses"], **LOSS_TOL)
    for name, w in dense["last"].items():
        np.testing.assert_allclose(sharded["last"][name], w, rtol=0, atol=1e-4, err_msg=name)
    for (g, u), (gd, ud) in zip(sharded["norms"], dense["norms"]):
        np.testing.assert_allclose([g, u], [gd, ud], rtol=1e-5)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_each_ranks_adam_bytes_are_its_share(runs, run):
    """dp-axis accounting (``opt_moment_bytes``, the JAX package's): each
    rank's moments are its 1/dp of the update view; fsdp and tp cut their
    slices further."""
    mesh, _ = RUNS[run]
    for r in runs["port"][run]:
        assert r["dense_bytes"] == runs["dense"][0]["moment_bytes"]
        if set(mesh) == {"dp"}:
            assert r["moment_bytes"] == r["planned_bytes"]
            assert r["planned_bytes"] * 4 == r["dense_bytes"]
        else:
            assert r["planned_bytes"] * 2 == r["dense_bytes"]
            assert r["moment_bytes"] < r["planned_bytes"]
        assert r["timings"]["reduce_scatter"] > 0 and r["timings"]["all_gather"] > 0


def test_zero_flat_mode_update_parity(runs):
    """A 5-element leaf at dp 4 takes the flat path (pad 3): the pad slots
    stay inert and the sharded step equals the replicated one."""
    for r in runs["flat"]:
        assert r["zero"]["mode"] == zero.FLAT and r["zero"]["pad"] == 3
        assert r["zero"]["shard"] == (2,)
        np.testing.assert_allclose(r["zero"]["value"], r["dense"]["value"], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(r["zero"]["grad_norm"], r["dense"]["grad_norm"], rtol=1e-6)


def test_zero_dp_resume_continues_identically(runs):
    for r in runs["trainer"]:
        assert r["resumed_at"] == 4
        assert r["resumed_loss"] == r["full_loss"]
        assert r["resumed_eval"] == r["full_eval"]
        for name, w in r["full"].items():
            np.testing.assert_array_equal(r["resumed"][name], w, err_msg=name)


def test_a_dp4_snapshot_restores_bitwise_at_dp2_x_tp2(runs):
    for r in runs["trainer"]:
        assert r["at2_step"] == 4 and r["at2_plan_dp"] == 2
        for part in ("params", "moments"):
            assert set(r["read2"][part]) == set(r["wrote"][part])
            for name, w in r["wrote"][part].items():
                np.testing.assert_array_equal(r["read2"][part][name], w, err_msg=name)


def test_a_dp4_snapshot_restores_bitwise_in_one_process(runs):
    wrote = runs["trainer"][0]["wrote"]
    tr = W._zero_trainer(tt.CORPUS, str(runs["tmp"] / "z4.pt"), 4, dict(dp=-1))
    assert tr.step == 4 and tr.zero_plan is None  # dp 1: no plan
    got = W._canonical(tr)
    for part in ("params", "moments"):
        for name, w in wrote[part].items():
            np.testing.assert_array_equal(got[part][name], w, err_msg=name)


def test_a_zero_snapshot_is_written_as_dp_shard_objects(runs):
    files = runs["trainer"][0]["shard_files"]
    assert files == ["z4.pt.manifest.json"] + [
        f"z4.pt.step-00000004.shard-{i:04d}-of-0004" for i in range(4)]
    with open(runs["tmp"] / "z4.pt.manifest.json") as f:
        raw = json.load(f)
    assert raw["version"] == 2 and len(raw["checkpoints"][0]["shards"]) == 4


@pytest.mark.parametrize("mesh", ["dp4", "dp2_fsdp2"])
def test_register_attrib_accounts_the_zero_moments(runs, mesh):
    """``opt_state`` is the moments this rank holds: at dp 4 a quarter of
    the dense ones; at dp 2 x fsdp 2 half of its fsdp slices, less than
    the dp-axis count of the whole leaves."""
    for r in runs["trainer"]:
        a = r["attrib"][mesh]
        assert a["variant"] == "zero" and a["calls"] == 2
        assert a["opt_state"] == a["held"] == a["local"]
        if mesh == "dp4":
            assert a["opt_state"] == a["planned"] and a["opt_state"] * 4 == a["dense"]
        else:
            assert a["planned"] * 2 == a["dense"]
            assert a["dense"] <= 4 * a["opt_state"] and a["opt_state"] < a["planned"]


def test_zero_dp_with_a_directory_path_is_refused(tmp_path):
    """The JAX trainer's refusal and reason: the directory backend would
    persist the dp view layout."""
    with pytest.raises(ConfigError, match="zero_dp=True requires the one-file backend.*"
                                          "would persist the view layout"):
        W._zero_trainer(tt.CORPUS, str(tmp_path), 1, dict(dp=-1))


# -- the plan, leaf by leaf, against the JAX package's ------------------------

PLAN_MODELS = {
    "gpt2": dict(model_type="gpt2", vocab_size=50257, block_size=1024),
    "llama": dict(n_layer=4, n_head=8, n_embd=256, vocab_size=1000, block_size=128,
                  rope=True, swiglu=True, rmsnorm=True, n_kv_head=2, tie_weights=True),
    "mixtral": dict(model_type="mixtral-tiny", vocab_size=64, block_size=32),
}
PLAN_MESHES = {"dp2": dict(dp=2), "dp4": dict(dp=4), "dp2_fsdp2": dict(dp=2, fsdp=2),
               "dp2_tp2": dict(dp=2, tp=2), "dp2_ep2": dict(dp=2, ep=2)}


def _shapes(model):
    cfg = GPTConfig.make(**PLAN_MODELS[model])
    spec = gpt.param_spec(cfg)
    tree = {k: v[0] for k, v in spec.items() if k != "blocks"}
    tree["blocks"] = {k: v[0] for k, v in spec["blocks"].items()}
    jcfg = JConfig.make(**PLAN_MODELS[model])
    jshape = jax.eval_shape(lambda: j_gpt.init(jax.random.key(0), jcfg))
    return tree, jshape


def _jax_plan(mesh_kw, jshape, devices):
    full = dict(dict(pp=1, dp=1, fsdp=1, ep=1, tp=1, sp=1), **mesh_kw)
    n = int(np.prod(list(full.values())))
    mesh = j_mesh.make_mesh(JMeshConfig(**full), devices=devices[:n])
    return j_zero.make_plan(mesh, jshape), dict(mesh.shape)


@pytest.mark.parametrize("model", sorted(PLAN_MODELS))
@pytest.mark.parametrize("mesh", sorted(PLAN_MESHES))
def test_make_plan_matches_jax_leaf_by_leaf(model, mesh, eight_devices):
    tree, jshape = _shapes(model)
    jplan, shape = _jax_plan(PLAN_MESHES[mesh], jshape, eight_devices)
    plan = zero.make_plan(shape, tree)
    assert plan.dp == jplan.dp
    jleaves = dict(zip(_flat(jax.tree.map(lambda s: 0, jshape)),
                       jax.tree.leaves(jplan.leaves, is_leaf=lambda x: isinstance(
                           x, j_zero.LeafPlan))))
    assert set(jleaves) == set(plan.by_name)
    for path, jl in jleaves.items():
        lp = plan.by_name[path]
        assert (lp.mode, lp.dim, lp.pad) == (jl.mode, jl.dim, jl.pad), path
        assert (lp.shape, lp.view_shape) == (tuple(jl.shape), tuple(jl.view_shape)), path
        assert tuple(lp.spec) == tuple(jl.spec), path
    if model == "gpt2" and mesh == "dp4":  # the vocabulary takes the flat path nowhere
        assert {lp.mode for lp in plan.by_name.values()} == {zero.DIM}


@pytest.mark.parametrize("model", ["gpt2", "llama"])
@pytest.mark.parametrize("dp", [2, 4])
def test_opt_moment_bytes_matches_jax(model, dp, eight_devices):
    tree, jshape = _shapes(model)
    jplan, shape = _jax_plan(dict(dp=dp), jshape, eight_devices)
    as_tensors = zero.leaves(tree)
    meta = {p: torch.empty(s, device="meta") for p, s in as_tensors}
    from mingpt_distributed_tpu_torch.models import convert

    params = convert.unflatten(meta)
    plan = zero.make_plan(shape, tree)
    assert zero.opt_moment_bytes(params, plan) == j_zero.opt_moment_bytes(jshape, jplan)
    assert zero.opt_moment_bytes(params) == j_zero.opt_moment_bytes(jshape)


# -- canonical snapshots and sharded manifest entries -------------------------

def _zero_setup():
    """``tests/test_fault_tolerance.py``'s tree: ``wte`` (8, 3) in dim mode
    at dp <= 8, ``lnf_bias`` (5,) flat at dp 4 (pad 3) and 2 (pad 1)."""
    return {"wte": torch.arange(24, dtype=torch.float32).reshape(8, 3),
            "lnf_bias": torch.arange(5, dtype=torch.float32)}


def _canonical_moments(params):
    return {"mu": {k: v + 0.25 for k, v in params.items()},
            "nu": {k: v * 2.0 for k, v in params.items()}, "count": 7}


def _snap(params, moments, step):
    return {"params": params, "opt_state": moments, "step": step, "epoch": 0,
            "data_state": {"pos": step}, "config": {"n_layer": 2}}


def _assert_tree_equal(a, b):
    assert type(a) is type(b) or (torch.is_tensor(a) and torch.is_tensor(b))
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_reshard_on_restore_dp4_dp2_dp1_bitwise(runs, eight_devices):
    """AdamW's snapshot path: a dp 4 ZeRO state (4 shard objects) restores
    at dp 2 and writes the same canonical state (2 shard objects), which
    one process restores at dp 1: every moment and count bitwise equal."""
    tree = {n: t.detach() for n, t in W.reshard_tree().items()}
    plans = {dp: zero.make_plan(dict(dp=dp, fsdp=1, ep=1, tp=1, sp=1, pp=1), tree)
             for dp in (4, 2)}
    # the JAX package's plan of the same tree has the same views
    jtree = {k: v.numpy() for k, v in tree.items()}
    jmesh = j_mesh.make_mesh(JMeshConfig(dp=4), devices=eight_devices[:4])
    jplan = j_zero.make_plan(jmesh, jax.eval_shape(lambda: jtree))
    assert {k: tuple(jplan.leaves[k].view_shape) for k in jtree} == {
        k: plans[4].by_name[k].view_shape for k in jtree}
    assert [plans[dp].by_name[k].mode for dp in (4, 2) for k in tree] == [
        zero.DIM, zero.DIM, zero.FLAT] * 2
    for r in runs["reshard"]:
        assert r["shapes4"] == {"wte": (2, 3), "head": (3, 2), "lnf_bias": (2,)}
        assert r["shapes2"] == {"wte": (4, 3), "head": (3, 4), "lnf_bias": (3,)}
        for part in ("sd4", "sd2"):
            assert set(r[part]) == set(runs["reshard"][0]["sd4"])
            for k, w in runs["reshard"][0]["sd4"].items():
                np.testing.assert_array_equal(r[part][k], w, err_msg=f"{part} {k}")
    tmp = runs["tmp"]
    assert sorted(n for n in os.listdir(tmp) if n.startswith("r4.pt.step-")) == [
        f"r4.pt.step-00000001.shard-{i:04d}-of-0004" for i in range(4)]
    snap = t_ckpt.load_snapshot(str(tmp / "r2.pt"), retry=NO_WAIT)
    assert len(dur.load_manifest(str(tmp / "r2.pt")).latest.shards) == 2
    params = {n: t.clone().requires_grad_() for n, t in snap["params"].items()}
    for n, w in runs["reshard"][0]["params"].items():
        np.testing.assert_array_equal(params[n].detach().numpy(), w)
    opt = W.make_optimizer(W.OptimizerConfig.make(learning_rate=1e-2), params, 1.0)
    opt.load_canonical_state_dict(snap["opt_state"], lambda _n, t: t)
    got = W._state_arrays(opt.opt.state_dict())
    assert set(got) == set(runs["reshard"][0]["sd4"])
    for k, w in runs["reshard"][0]["sd4"].items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_sharded_commit_survives_injected_write_faults(tmp_path):
    fs = FaultInjectionFileSystem("write:every=3")
    path = str(tmp_path / "zsnap.pt")
    params = _zero_setup()
    canon = _canonical_moments(params)
    for step in (1, 2, 3):
        t_ckpt.save_snapshot(path, _snap({k: v * float(step) for k, v in params.items()},
                                         canon, step), retry=NO_WAIT, fs=fs, shards=4)
    assert fs.specs[0].count >= 5  # the injector fired on every commit
    fs.clear_faults()
    snap = t_ckpt.load_snapshot(path, retry=NO_WAIT, fs=fs)
    assert snap["step"] == 3
    _assert_tree_equal(snap["params"], {k: v * 3.0 for k, v in params.items()})
    _assert_tree_equal(snap["opt_state"], canon)


def test_torn_shard_fails_whole_entry_falls_back(tmp_path, capsys):
    path = str(tmp_path / "zsnap.pt")
    params = _zero_setup()
    canon = _canonical_moments(params)
    for step in (1, 2):
        t_ckpt.save_snapshot(path, _snap({k: v * float(step) for k, v in params.items()},
                                         canon, step), retry=NO_WAIT, shards=2)
    torn = str(tmp_path / "zsnap.pt.step-00000002.shard-0001-of-0002")
    with open(torn, "r+b") as f:
        f.truncate(10)
    snap = t_ckpt.load_snapshot(path, retry=NO_WAIT)
    assert snap["step"] == 1  # the whole step-2 entry is rejected, not patched
    _assert_tree_equal(snap["params"], params)
    assert "fell back to checkpoint step 1" in capsys.readouterr().out


def test_rotation_deletes_every_shard_of_a_dropped_entry(tmp_path):
    path = str(tmp_path / "zsnap.pt")
    params = _zero_setup()
    for step in (1, 2, 3):
        t_ckpt.save_snapshot(path, _snap(params, _canonical_moments(params), step),
                             keep=2, retry=NO_WAIT, shards=2)
    assert sorted(n for n in os.listdir(tmp_path) if ".step-" in n) == [
        f"zsnap.pt.step-0000000{s}.shard-000{i}-of-0002" for s in (2, 3) for i in (0, 1)]


def test_legacy_v1_manifest_still_loads(tmp_path):
    path = str(tmp_path / "snap.pt")
    params = _zero_setup()
    t_ckpt.save_snapshot(path, _snap(params, {}, 5), retry=NO_WAIT)
    mpath = str(tmp_path / "snap.pt.manifest.json")
    with open(mpath) as f:
        raw = json.load(f)
    assert raw["version"] == 2 and all("shards" not in e for e in raw["checkpoints"])
    raw["version"] = 1
    with open(mpath, "w") as f:
        json.dump(raw, f)
    snap = t_ckpt.load_snapshot(path, retry=NO_WAIT)
    assert snap["step"] == 5
    _assert_tree_equal(snap["params"], params)


def test_single_shard_save_is_byte_identical_to_blob_save(tmp_path):
    params = _zero_setup()
    snap = _snap(params, _canonical_moments(params), 3)
    t_ckpt.save_snapshot(str(tmp_path / "a.pt"), snap, retry=NO_WAIT)
    t_ckpt.save_snapshot(str(tmp_path / "b.pt"), snap, retry=NO_WAIT, shards=1)
    assert ((tmp_path / "a.pt.step-00000003").read_bytes()
            == (tmp_path / "b.pt.step-00000003").read_bytes())
    assert dur.load_manifest(str(tmp_path / "b.pt")).latest.shards is None


@pytest.mark.parametrize("shards", [2, 3, 7])
def test_any_shard_count_restores_the_same_snapshot(tmp_path, shards):
    """Chunks are contiguous pieces of each flattened tensor, so the shard
    count is a property of the write: 7 shards of a 5-element leaf leave
    two empty chunks, and a 0-d tensor lands in shard 0."""
    params = _zero_setup()
    moments = dict(_canonical_moments(params), count=torch.tensor(7.0))
    path = str(tmp_path / "s.pt")
    t_ckpt.save_snapshot(path, _snap(params, moments, 1), retry=NO_WAIT, shards=shards)
    _assert_tree_equal(t_ckpt.load_snapshot(path, retry=NO_WAIT)["opt_state"], moments)


@pytest.mark.parametrize("name", ["wte", "head", "lnf_bias"])
@pytest.mark.parametrize("dp", [1, 2, 4])
def test_local_view_and_shards_round_trip(name, dp):
    """Each rank's shard of a leaf's update view, put back together over dp
    and out of the view, is the leaf: the pad dropped in flat mode."""
    tree = {n: t.detach() for n, t in W.reshard_tree().items()}
    plan = zero.make_plan(dict(dp=dp, fsdp=1, ep=1, tp=1, sp=1, pp=1), tree)
    lp, t = plan.by_name[name], tree[name]
    view = zero.local_view(lp, t, dp)
    assert tuple(view.shape) == lp.view_shape
    pieces = [zero.shard_of(lp, view, dp, r) for r in range(dp)]
    assert all(p.numel() * dp == view.numel() for p in pieces)
    whole = zero.from_local_view(lp, torch.cat(pieces, zero.split_dim(lp)), t.shape)
    assert torch.equal(whole, t)
    if lp.mode == zero.FLAT:
        assert torch.count_nonzero(view[t.numel():]) == 0


# -- the train.py self-tests ------------------------------------------------------

def test_train_selftest_faults_passes(capsys):
    assert t_train.main(["--selftest-faults", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "fell back to checkpoint step 1" in out and "selftest-faults PASSED" in out


def test_train_selftest_zero_passes(capsys):
    assert t_train.main(["--selftest-zero", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("(ratio 0.500, dp=2;") == 2 and "selftest-zero PASSED" in out
