"""Mixture-of-experts beside sequence parallelism in the port, on gloo CPU
ranks, against one process and the JAX package.

The JAX package routes the global (B, T) batch under GSPMD, whatever the
sp sharding: groups of ``_group_size`` of the global token count in the
flat order b * T + t. Under sp a rank's tokens are one column chunk of
each of its rows, so a group holds the chunks of every sp rank in turn;
the port's ranks lay their tokens out as segments of that order and take
each token's place in its expert's buffer from one all-gather of every
rank's per-piece counts (``ops/moe.py``). At fp32, with capacity binding
(factor 0.5 unless stated):

* ``moe_mlp`` on meshes sp 4, dp 2 x sp 2, sp 2 x ep 2, sp 2 x tp 2
  (SwiGLU), fsdp 2 x sp 2 (k = 1), with one group of 256 tokens that
  interleaves every rank's chunks, with sp chunks that straddle a group
  boundary (sp 4, T 1536 in groups of 1024) and with whole groups per
  chunk (dp 2 x sp 2, chunks of 1024): its output block, aux loss and
  gradients equal one process's and the JAX ``moe_mlp``'s (and
  ``jax.grad``'s) within 1e-5;
* ``make_train_step`` on ``tests/test_torch_sharded_train.py``'s GPT with
  E 4, k 2 (vocab 25, block 16, global batch 16: one group of 256 tokens)
  at sp 2 (ring), sp 2 (Ulysses), dp 2 x sp 2, sp 2 x ep 2, sp 2 x tp 2
  (Ulysses) and pp 2 x sp 2: losses within 1e-5 relative of the JAX
  trainer's at mesh 1 and on the same mesh under GSPMD (dp 2 x sp 2), the
  weighted aux term of the first step within 1e-5 of the JAX forward's,
  the first Adam moment (0.1 x the clipped gradient) within 1e-5 norm-wise
  and the parameters after the first update within 1e-5 where |g| > 1e-6.
  Under pp 2 x sp 2 each stage routes its (microbatch, column chunk)
  locally, as the JAX pipeline's stage body does inside shard_map, so that
  mesh is held against the JAX trainer on pp 2 x sp 2, whose losses differ
  from mesh 1's where capacity binds.

The 4-rank meshes share one spawn and the 2-rank ones another; while they
run, the parent runs the JAX side.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mingpt_distributed_tpu.config import GPTConfig as JConfig
from mingpt_distributed_tpu.config import MeshConfig as JMeshConfig
from mingpt_distributed_tpu.models import gpt as j_gpt
from mingpt_distributed_tpu.parallel import mesh as j_mesh
from mingpt_distributed_tpu_torch.parallel.spawn import run_ranks
from tests import torch_moe_sp_workers as W
from tests import test_trainer as tt
from tests.test_torch_moe_ep import _jax_layer, _layer_case, _port_layer
from tests.test_torch_sharded_train import LR, STEPS, _cfg_kw, _flat, _jax_run

TOL = 1e-5
LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_ATOL = 1e-5
MOE = dict(n_experts=4, moe_top_k=2, moe_capacity_factor=0.5)

LAYER_CASES = {
    "sp4_one_group": _layer_case(11, 4, 64, 16, 32, 4, 2, 0.5, dict(dp=1, sp=4)),
    "dp2_sp2": _layer_case(12, 4, 64, 16, 32, 4, 2, 0.5, dict(dp=2, sp=2)),
    "sp2_ep2": _layer_case(13, 4, 64, 16, 32, 4, 2, 0.5, dict(dp=1, ep=2, sp=2)),
    "sp2_tp2_swiglu": _layer_case(14, 4, 64, 16, 32, 4, 2, 0.5, dict(dp=1, tp=2, sp=2),
                                  swiglu=True),
    "fsdp2_sp2_k1": _layer_case(15, 4, 64, 16, 32, 4, 1, 0.5, dict(dp=1, fsdp=2, sp=2)),
    "sp4_straddling": _layer_case(16, 2, 1536, 8, 16, 4, 2, 0.75, dict(dp=1, sp=4)),
    "dp2_sp2_whole_groups": _layer_case(17, 2, 2048, 16, 32, 8, 2, 1.25, dict(dp=2, sp=2)),
}
# name: (attention, port mesh, ranks)
TRAIN = {
    "sp2_ring": ("ring", dict(dp=1, sp=2), 2),
    "sp2_ulysses": ("ulysses", dict(dp=1, sp=2), 2),
    "dp2_sp2": ("ring", dict(dp=2, sp=2), 4),
    "sp2_ep2": ("ring", dict(dp=1, ep=2, sp=2), 4),
    "sp2_tp2_ulysses": ("ulysses", dict(dp=1, tp=2, sp=2), 4),
    "pp2_sp2": ("ring", dict(pp=2, dp=1, sp=2), 4),
}
JAX_MESHES = {"dp2_sp2": JMeshConfig(dp=2, fsdp=1, tp=1, sp=2),
              "pp2_sp2": JMeshConfig(pp=2, dp=1, fsdp=1, tp=1, sp=2)}


def _cfg(vocab, attention):
    return _cfg_kw(vocab, dict(MOE, attention=attention))


def _jax_aux(cfg_kw, params, batch, mesh_cfg=None, devices=None):
    """The weighted aux term of the JAX forward's loss on one global batch:
    the loss minus the loss at ``moe_aux_weight`` 0."""
    x, y = (jnp.asarray(a) for a in batch)
    mesh = None if mesh_cfg is None else j_mesh.make_mesh(mesh_cfg, devices=devices)

    def loss(weight):
        cfg = JConfig.make(**dict(cfg_kw, moe_aux_weight=weight))
        return float(jax.jit(lambda p: j_gpt.forward(p, x, cfg, targets=y, mesh=mesh)[1])(
            params))

    return loss(JConfig.make(**cfg_kw).moe_aux_weight) - loss(0.0)


def _jax_start(tmp):
    """The JAX trainer at mesh 1 before any step: its initial parameters
    and first STEPS global batches (the ranks start from these while the
    parent trains it, ``_jax_run`` as in ``tests/test_torch_sharded_train.py``)."""
    orig = tt.tiny_gpt_cfg
    tt.tiny_gpt_cfg = lambda **kw: orig(**dict(dict(n_head=4, **MOE), **kw))
    try:
        jtr = tt.make_trainer(tmp, mesh_cfg=JMeshConfig(dp=1, fsdp=1, tp=1, sp=1),
                              snapshot="start", max_steps=STEPS, log_every=1)
    finally:
        tt.tiny_gpt_cfg = orig
    batches = []
    for xy in jtr.train_iter.epoch_batches():
        if len(batches) == STEPS:
            break
        batches.append(xy)
    return jax.device_get(jtr.state["params"]), batches


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    tmp = tmp_path_factory.mktemp("moe_sp")
    params, batches = _jax_start(tmp)
    vocab = params["wte"].shape[0]
    todo = {2: [], 4: [("moe_sp_layer_cases", (LAYER_CASES,))]}
    for attention, mesh, world in TRAIN.values():
        todo[world].append(("moe_sp_losses", (_cfg(vocab, attention), mesh, params,
                                              batches, LR)))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranks = {w: pool.submit(run_ranks, W.jobs, w, (jobs,), timeout_s=300)
                 for w, jobs in todo.items()}
        one = _jax_run(tmp, "one", dict(MOE, attention="ring"),
                       JMeshConfig(dp=1, fsdp=1, tp=1, sp=1))
        jax_mesh = {m: _jax_run(tmp, m, dict(MOE, attention="ring"), c)
                    for m, c in JAX_MESHES.items()}
        jax_layers = {name: _jax_layer(c) for name, c in LAYER_CASES.items()}
        cfg = _cfg(vocab, "ring")
        jax_aux = dict(one=_jax_aux(cfg, one["params"], one["batches"][0]),
                       pp2_sp2=_jax_aux(cfg, one["params"], one["batches"][0],
                                        JAX_MESHES["pp2_sp2"], eight_devices[:4]))
        per_rank = {w: f.result() for w, f in ranks.items()}
    train, index = {}, {2: 0, 4: 1}  # the 4-rank spawn starts with the layers
    for name, (_, _, world) in TRAIN.items():
        train[name] = [r[index[world]] for r in per_rank[world]]
        index[world] += 1
    for run in (one, *jax_mesh.values()):  # the ranks' start is every JAX run's
        np.testing.assert_array_equal(run["params"]["wte"], params["wte"])
        np.testing.assert_array_equal(run["batches"][0][0], batches[0][0])
    return dict(one=one, jax_mesh=jax_mesh, jax_layers=jax_layers, jax_aux=jax_aux,
                layers=[r[0] for r in per_rank[4]], train=train)


def _block(a, where):
    r0, n, c0, c = where
    return a[r0:r0 + n, c0:c0 + c]


def _check_layer(got, want):
    np.testing.assert_allclose(got["y"], _block(want["y"], got["where"]), rtol=0, atol=TOL)
    np.testing.assert_allclose(got["x_grad"], _block(want["x_grad"], got["where"]), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=TOL, atol=TOL)
    for k, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], g, rtol=TOL, atol=TOL * max(
            1.0, float(np.abs(g).max())), err_msg=k)


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_mlp_beside_sp_matches_one_process(runs, case):
    want = _port_layer(LAYER_CASES[case])
    for r in runs["layers"]:
        _check_layer(r[case], want)


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_mlp_beside_sp_matches_jax(runs, case):
    for r in runs["layers"]:
        _check_layer(r[case], runs["jax_layers"][case])


def test_one_group_interleaves_every_sp_chunk(runs):
    """At sp 4 the one group of 256 tokens holds each row's four chunks in
    turn; routing a rank's block as a group of its own (what the port did
    for a contiguous block) gives a different output where capacity
    binds."""
    c = LAYER_CASES["sp4_one_group"]
    got = runs["layers"][1]["sp4_one_group"]
    assert got["cols"] == 4 and got["count"] == 4
    x, g = _block(c["x"], got["where"]), _block(c["g"], got["where"])
    alone = _port_layer(dict(c, x=np.ascontiguousarray(x), g=np.ascontiguousarray(g)))
    assert np.abs(alone["y"] - got["y"]).max() > 1e-3


def _reference(runs, mesh):
    return runs["jax_mesh"]["pp2_sp2"] if mesh == "pp2_sp2" else runs["one"]


@pytest.mark.parametrize("mesh", sorted(TRAIN))
def test_losses_match_the_jax_trainer(runs, mesh):
    want = _reference(runs, mesh)["losses"]
    assert want[-1] < want[0]
    for r in runs["train"][mesh]:
        assert r["losses"] == runs["train"][mesh][0]["losses"]  # every rank
        np.testing.assert_allclose(r["losses"], want, **LOSS_TOL)
    if mesh == "dp2_sp2":  # the JAX trainer under GSPMD on the same mesh
        np.testing.assert_allclose(runs["train"][mesh][0]["losses"],
                                   runs["jax_mesh"][mesh]["losses"], **LOSS_TOL)


@pytest.mark.parametrize("mesh", sorted(TRAIN))
def test_aux_term_matches_the_jax_forward(runs, mesh):
    want = runs["jax_aux"]["pp2_sp2" if mesh == "pp2_sp2" else "one"]
    assert want > 1e-3
    for r in runs["train"][mesh]:
        assert abs(r["auxes"][0] - want) <= TOL * max(1.0, abs(want))


@pytest.mark.parametrize("mesh", sorted(TRAIN))
def test_gradients_and_post_update_parameters_match(runs, mesh):
    got = runs["train"][mesh][0]["first"]
    want = _reference(runs, mesh)["first"]
    before = _flat(runs["one"]["params"])
    assert set(got["params"]) == set(want["params"]) == set(got["mu"])
    diff = {n: np.linalg.norm(got["mu"][n] - m) for n, m in want["mu"].items()}
    norm = {n: np.linalg.norm(m) for n, m in want["mu"].items()}
    assert np.linalg.norm(list(diff.values())) <= 1e-5 * np.linalg.norm(list(norm.values()))
    n_steady = n_all = 0
    for name, w in want["params"].items():
        steady = np.abs(want["mu"][name]) > 0.1 * 1e-6
        n_steady, n_all = n_steady + steady.sum(), n_all + steady.size
        np.testing.assert_allclose(got["params"][name][steady], w[steady], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    assert n_steady > 0.5 * n_all
    assert max(float(np.abs(got["params"][n] - before[n]).max()) for n in before) > 1e-3


def test_pp_sp_routes_each_chunk_locally(runs):
    """The JAX pipeline routes each shard's (microbatch, column chunk) on
    its own; with capacity binding that differs from global routing, and
    the port's pp 2 x sp 2 follows the pipeline, not mesh 1."""
    one, pp = runs["one"]["losses"], runs["jax_mesh"]["pp2_sp2"]["losses"]
    assert np.abs(np.asarray(one) - np.asarray(pp)).max() > 1e-4


def test_ep_beside_sp_holds_half_the_experts(runs):
    for r in runs["train"]["sp2_ep2"]:
        assert r["local_experts"] == MOE["n_experts"] // 2
    for r in runs["train"]["dp2_sp2"]:
        assert r["local_experts"] == MOE["n_experts"]
