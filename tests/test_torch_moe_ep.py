"""Mixture-of-experts across ranks in the port (ep > 1, dp, fsdp, tp), on 4
gloo CPU ranks, against one process and the JAX package.

The JAX package routes the global batch under GSPMD: groups of
``_group_size`` of the global token count, capacity and buffer positions
global. The port's ranks route their rows with the cross-rank counts where
a group spans ranks (``ops/moe.py``), exchange the expert rows over ep
with two all-to-alls, split each expert's F over tp, and sum f and P over
the ranks before the aux loss's product. At fp32:

* ``moe_mlp`` on meshes ep 4, dp 2 x ep 2, ep 2 x tp 2 (SwiGLU),
  fsdp 2 x ep 2, dp 4, with groups that span ranks and capacity binding
  (factor 0.5), with whole groups per rank (ep 4, 2048 tokens) and with
  groups that straddle rank boundaries (1536 tokens in groups of 768): its
  output rows, aux loss and gradients equal one process's and the JAX
  ``moe_mlp``'s (and ``jax.grad``'s) within 1e-5;
* the model at ep 4 (``tests/test_moe.py``'s case): logits and loss equal
  the single-device forward of both packages;
* ``make_train_step`` on an MoE model (E 4, k 2, capacity factor 0.5: one
  group of 256 tokens spans every data rank) at ep 2 x dp 2, ep 2 x tp 2,
  fsdp 2 x ep 2 and fsdp 2 x tp 2 gives the JAX trainer's losses at mesh 1
  and on the same mesh (dp 2 x ep 2, fsdp 2 x tp 2) within 1e-5 relative,
  and its first-update parameters within 1e-5 where |g| > 1e-6;
* ``GPTTrainer`` at ep 2 x dp 2 learns, each rank holding E / ep experts
  (``tests/test_moe.py``'s trainer case);
* a tp = 2 MoE server (the experts' F split, the router replicated, the
  decode step routing each slot alone) gives the tp = 1 server's and the
  JAX server's greedy tokens, with half the KV heads in each rank's pool.

The ranks are spawned once for the module; while they run, the parent runs
the JAX side.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingpt_distributed_tpu.config import GPTConfig as JConfig
from mingpt_distributed_tpu.config import MeshConfig as JMeshConfig
from mingpt_distributed_tpu.models import gpt as j_gpt
from mingpt_distributed_tpu.ops import moe as j_moe
from mingpt_distributed_tpu.serving import InferenceServer as JServer
from mingpt_distributed_tpu.serving import Request as JRequest
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.ops import moe
from mingpt_distributed_tpu_torch.parallel.spawn import run_ranks
from tests import test_trainer as tt
from tests import torch_sp_workers as W
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_ATOL = 1e-5
STEPS = 3
LR = 1e-2


def _layer_case(seed, b, t, d, f, e, k, cf, mesh, swiglu=False):
    rng = np.random.default_rng(seed)
    w = {"w_router": rng.standard_normal((d, e)).astype(np.float32) * 0.5,
         "w_e1": rng.standard_normal((e, d, f)).astype(np.float32) * 0.2,
         "w_e2": rng.standard_normal((e, f, d)).astype(np.float32) * 0.2}
    if swiglu:
        w["w_eg"] = rng.standard_normal((e, d, f)).astype(np.float32) * 0.2
    return dict(x=rng.standard_normal((b, t, d)).astype(np.float32),
                g=rng.standard_normal((b, t, d)).astype(np.float32), w=w, top_k=k,
                cf=cf, mesh=mesh)


LAYER_CASES = {
    "ep4_span": _layer_case(1, 8, 16, 16, 32, 4, 2, 0.5, dict(dp=1, ep=4)),
    "dp2_ep2_span": _layer_case(2, 8, 16, 16, 32, 4, 2, 0.5, dict(dp=2, ep=2)),
    "ep2_tp2_span_swiglu": _layer_case(3, 8, 16, 16, 32, 4, 2, 0.5, dict(dp=1, ep=2, tp=2),
                                       swiglu=True),
    "fsdp2_ep2_k1": _layer_case(4, 8, 16, 16, 32, 4, 1, 0.5, dict(dp=1, fsdp=2, ep=2)),
    "dp4_span": _layer_case(5, 8, 16, 16, 32, 4, 2, 0.5, dict(dp=4)),
    "ep4_whole_groups": _layer_case(6, 4, 512, 16, 32, 8, 2, 1.25, dict(dp=1, ep=4)),
    "straddling_groups": _layer_case(7, 4, 384, 16, 32, 4, 2, 0.75,
                                     dict(dp=1, fsdp=2, ep=2)),
}

MOE = dict(n_experts=4, moe_top_k=2, moe_capacity_factor=0.5)
TRAIN_MESHES = {"dp2_ep2": dict(dp=2, ep=2), "ep2_tp2": dict(dp=1, ep=2, tp=2),
                "fsdp2_ep2": dict(dp=1, fsdp=2, ep=2), "fsdp2_tp2": dict(dp=1, fsdp=2, tp=2)}
JAX_MESHES = ("dp2_ep2", "fsdp2_tp2")  # the JAX trainer on the same mesh too

FWD_CFG = dict(n_layer=2, n_head=2, n_embd=32, vocab_size=64, block_size=16,
               embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32",
               n_experts=4, moe_top_k=2)
SERVE_CFG = dict(n_layer=2, n_head=4, n_embd=32, vocab_size=50, block_size=32,
                 embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32",
                 n_experts=4, moe_top_k=2, moe_capacity_factor=0.5, swiglu=True)
SERVE_PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], list(range(10, 23)), [40, 41]]
SERVE_NEW = 8


def _jax_layer(c):
    """The JAX ``moe_mlp`` on the whole case and ``jax.grad`` of
    sum(out * g) + aux."""
    w = {k: jnp.asarray(v) for k, v in c["w"].items()}

    def f(x, w):
        y, aux = j_moe.moe_mlp(x, w["w_router"], w["w_e1"], w["w_e2"], top_k=c["top_k"],
                               capacity_factor=c["cf"], w_gate=w.get("w_eg"))
        return jnp.sum(y * c["g"]) + aux, (y, aux)

    (_, (y, aux)), (gx, gw) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(c["x"]), w)
    return dict(y=np.asarray(y), aux=float(aux), x_grad=np.asarray(gx),
                grads={k: np.asarray(v) for k, v in gw.items()})


def _port_layer(c):
    ws = {k: torch.from_numpy(v).requires_grad_() for k, v in c["w"].items()}
    x = torch.from_numpy(c["x"]).requires_grad_()
    y, aux = moe.moe_mlp(x, ws["w_router"], ws["w_e1"], ws["w_e2"], w_gate=ws.get("w_eg"),
                         top_k=c["top_k"], capacity_factor=c["cf"])
    ((y * torch.from_numpy(c["g"])).sum() + aux).backward()
    return dict(y=y.detach().numpy(), aux=aux.item(), x_grad=x.grad.numpy(),
                grads={k: v.grad.numpy() for k, v in ws.items()})


def _jax_trainer_run(tmp, name, mesh_cfg):
    orig = tt.tiny_gpt_cfg
    tt.tiny_gpt_cfg = lambda **kw: orig(**dict(dict(n_head=4, **MOE), **kw))
    try:
        jtr = tt.make_trainer(tmp, mesh_cfg=mesh_cfg, snapshot=name, max_steps=STEPS,
                              log_every=1)
    finally:
        tt.tiny_gpt_cfg = orig
    params = jax.device_get(jtr.state["params"])
    batches, losses, first = [], [], None
    for xy in jtr.train_iter.epoch_batches():
        if len(batches) == STEPS:
            break
        batches.append(xy)
        jtr.state, m = jtr._train_step(jtr.state, jtr._put_batch(xy), jtr.base_rng)
        losses.append(float(jax.device_get(m["loss"])))
        if first is None:
            first = _flat(jax.device_get(jtr.state["params"]))
    return dict(params=params, batches=batches, losses=losses, first=first)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    tmp = tmp_path_factory.mktemp("moe_ep")
    one = _jax_trainer_run(tmp, "one.msgpack", JMeshConfig(dp=1, fsdp=1, tp=1, sp=1))
    vocab = one["params"]["wte"].shape[0]
    cfg_kw = dict(n_layer=2, n_head=4, n_embd=32, vocab_size=vocab, block_size=16,
                  embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32", **MOE)
    fwd_tree = jax.device_get(j_gpt.init(jax.random.key(0), JConfig.make(**FWD_CFG)))
    tokens = np.asarray(jax.random.randint(jax.random.key(1), (8, 16), 0, 64))
    serve_tree = jax.device_get(j_gpt.init(jax.random.key(3), JConfig.make(**SERVE_CFG)))
    todo = [("moe_layer_cases", (LAYER_CASES,)),
            ("moe_forward", (FWD_CFG, dict(dp=1, ep=4), fwd_tree, tokens))]
    todo += [("sharded_losses", (cfg_kw, mesh, one["params"], one["batches"], LR))
             for mesh in TRAIN_MESHES.values()]
    todo += [("moe_trainer", (tt.CORPUS, str(tmp), dict(dp=2, ep=2),
                              dict(n_experts=4, moe_top_k=2))),
             ("moe_tp_serving", (serve_tree, SERVE_CFG, SERVE_PROMPTS, SERVE_NEW))]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, W.jobs, 4, (todo,), timeout_s=300)
        jax_mesh = {m: _jax_trainer_run(tmp, f"{m}.msgpack", JMeshConfig(
            **dict(dict(fsdp=1, tp=1, sp=1), **TRAIN_MESHES[m]))) for m in JAX_MESHES}
        jax_layers = {name: _jax_layer(c) for name, c in LAYER_CASES.items()}
        jcfg = JConfig.make(**FWD_CFG)
        want_logits, want_loss = j_gpt.forward(fwd_tree, jnp.asarray(tokens), jcfg,
                                               targets=jnp.asarray(tokens))
        jserver = JServer(serve_tree, JConfig.make(**SERVE_CFG), n_slots=2)
        jh = [jserver.submit(JRequest(prompt=p, max_new_tokens=SERVE_NEW))
              for p in SERVE_PROMPTS]
        jserver.run_until_drained(max_steps=500)
        per_rank = ranks.result()
    n = len(TRAIN_MESHES)
    return dict(
        layers=[r[0] for r in per_rank], jax_layers=jax_layers,
        forward=[r[1] for r in per_rank], fwd_tree=fwd_tree, tokens=tokens,
        jax_forward=dict(logits=np.asarray(want_logits), loss=float(want_loss)),
        train={m: [r[2 + i] for r in per_rank] for i, m in enumerate(TRAIN_MESHES)},
        jax_one=one, jax_mesh=jax_mesh, trainer=[r[2 + n] for r in per_rank],
        serve=per_rank[0][3 + n], follower=per_rank[1][3 + n],
        jax_serve=[h.tokens for h in jh])


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_mlp_across_ranks_matches_one_process(runs, case):
    want = _port_layer(LAYER_CASES[case])
    for r in runs["layers"]:
        got = r[case]
        start, n = got["rows"]
        np.testing.assert_allclose(got["y"], want["y"][start:start + n], rtol=0, atol=TOL)
        np.testing.assert_allclose(got["x_grad"], want["x_grad"][start:start + n], rtol=0,
                                   atol=TOL)
        assert abs(got["aux"] - want["aux"]) <= TOL
        for k, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g, rtol=TOL, atol=TOL * max(
                1.0, float(np.abs(g).max())), err_msg=k)


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_mlp_across_ranks_matches_jax(runs, case):
    """The global grouping: where capacity binds (factor 0.5), which tokens
    drop depends on the whole group, so a rank that routed its rows alone
    would differ here."""
    want = runs["jax_layers"][case]
    for r in runs["layers"]:
        got = r[case]
        start, n = got["rows"]
        np.testing.assert_allclose(got["y"], want["y"][start:start + n], rtol=0, atol=TOL)
        np.testing.assert_allclose(got["x_grad"], want["x_grad"][start:start + n], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=TOL)
        for k, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g, rtol=TOL, atol=TOL * max(
                1.0, float(np.abs(g).max())), err_msg=k)


def test_local_routing_would_drop_other_tokens(runs):
    """The cross-rank counts matter: routing ep 4's first rank's 2 rows as
    a group of their own gives a different output where capacity binds."""
    c = LAYER_CASES["ep4_span"]
    alone = _port_layer(dict(c, x=c["x"][:2], g=c["g"][:2]))
    got = runs["layers"][0]["ep4_span"]
    assert np.abs(alone["y"] - got["y"]).max() > 1e-3


def test_aux_loss_sums_f_and_p_over_ranks_before_the_product(runs):
    """Every rank's aux is the global one; the mean of per-rank aux losses
    is a different number."""
    c = LAYER_CASES["dp4_span"]
    per_rank = [_port_layer(dict(c, x=c["x"][2 * i:2 * i + 2], g=c["g"][2 * i:2 * i + 2]))
                ["aux"] for i in range(4)]
    want = runs["jax_layers"]["dp4_span"]["aux"]
    assert all(abs(r["dp4_span"]["aux"] - want) <= TOL for r in runs["layers"])
    assert abs(np.mean(per_rank) - want) > 1e-4


def test_ep4_logits_and_loss_match_the_single_device_forward(runs):
    from mingpt_distributed_tpu_torch.config import GPTConfig
    from mingpt_distributed_tpu_torch.models import gpt

    cfg = GPTConfig.make(**FWD_CFG)
    params = convert.params_from_numpy(runs["fwd_tree"], cfg, "cpu")
    tokens = torch.from_numpy(runs["tokens"]).long()
    with torch.no_grad():
        one, one_loss = gpt.forward(params, tokens, cfg, targets=tokens)
    want = runs["jax_forward"]
    for r in runs["forward"]:
        assert r["local_experts"] == 1  # 4 experts over ep 4
        start, n = r["rows"]
        np.testing.assert_allclose(r["logits"], one.numpy()[start:start + n], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(r["logits"], want["logits"][start:start + n], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(r["loss"], one_loss.item(), rtol=1e-5)
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)


@pytest.mark.parametrize("mesh", sorted(TRAIN_MESHES))
def test_moe_train_losses_match_the_jax_trainer(runs, mesh):
    want = runs["jax_one"]["losses"]
    assert want[-1] < want[0]
    for r in runs["train"][mesh]:
        assert r["losses"] == runs["train"][mesh][0]["losses"]  # every rank
        np.testing.assert_allclose(r["losses"], want, **LOSS_TOL)
        if mesh in runs["jax_mesh"]:
            np.testing.assert_allclose(r["losses"], runs["jax_mesh"][mesh]["losses"],
                                       **LOSS_TOL)


@pytest.mark.parametrize("mesh", sorted(TRAIN_MESHES))
def test_moe_post_update_parameters_match_the_jax_trainer(runs, mesh):
    got = runs["train"][mesh][0]["first"]
    want = runs["jax_one"]["first"]
    assert set(got["params"]) == set(want)
    n_steady = n_all = 0
    for name, w in want.items():
        steady = np.abs(got["mu"][name]) > 0.1 * 1e-6
        n_steady, n_all = n_steady + steady.sum(), n_all + steady.size
        np.testing.assert_allclose(got["params"][name][steady], w[steady], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    assert n_steady > 0.5 * n_all


def test_ep2_dp2_trainer_learns_with_half_the_experts_per_rank(runs):
    for r in runs["trainer"]:
        assert r["local_experts"] == r["experts"] // 2
        assert r["losses"][-1] < r["losses"][0] and np.isfinite(r["eval_loss"])
        assert r["losses"] == runs["trainer"][0]["losses"]


def test_tp2_moe_server_matches_tp1_and_jax(runs):
    s = runs["serve"]
    assert s["tp2"]["tokens"] == s["tp1"]["tokens"] == runs["jax_serve"]
    assert all(len(t) == SERVE_NEW for t in s["tp1"]["tokens"])


def test_tp2_moe_server_splits_the_pool_and_the_experts(runs):
    s = runs["serve"]
    assert s["tp2"]["pool"][3] * 2 == s["tp1"]["pool"][3]
    assert s["tp2"]["ffn_local"] * 2 == s["tp1"]["ffn_local"]
    (follower,) = s["tp2"]["reports"]
    assert follower["kv_heads"] * 2 == s["tp1"]["pool"][3]
    assert follower["kv_shard_count"] == 2
    assert runs["follower"]["commands"] > 0
