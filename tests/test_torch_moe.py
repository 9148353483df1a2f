"""The port's mixture-of-experts (ops/moe.py, the MoE blocks of models/gpt.py
and models/generate.py) against the JAX package.

The same numpy inputs, made from seeds, go through ``moe_mlp`` of both
packages (k = 1 and 2, GELU and SwiGLU experts, a binding capacity factor,
several groups, a token count without a divisor in [128, 1024]), forward and
aux loss within 1e-5 and gradients within 2e-4 at fp32; then the models
(mixtral-tiny cut to 2 layers, and a GELU MoE of width 64) on parameters
converted from one JAX tree: logits and loss with the aux term, gradients,
cached ``generate``, the serving engine's decode step and prefill, a
speculative and an int8 server, all against the JAX package; then the
port-side counterparts of tests/test_moe.py (the ep-sharded cases go with
ROADMAP.md item 12b). CPU, fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingpt_distributed_tpu.config import GPTConfig as JConfig
from mingpt_distributed_tpu.models import generate as j_gen
from mingpt_distributed_tpu.models import gpt as j_gpt
from mingpt_distributed_tpu.ops import moe as j_moe
from mingpt_distributed_tpu.serving import InferenceServer as JServer
from mingpt_distributed_tpu.serving import Request as JRequest
from mingpt_distributed_tpu_torch.config import ConfigError, GPTConfig
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import generate as gen
from mingpt_distributed_tpu_torch.models import gpt
from mingpt_distributed_tpu_torch.ops import layers as L
from mingpt_distributed_tpu_torch.ops import moe
from mingpt_distributed_tpu_torch.serving import InferenceServer, Request

FWD_TOL = 1e-5
GRAD_TOL = 2e-4

NO_DROP = dict(embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
GELU_MOE = dict(n_layer=2, n_head=2, n_embd=64, vocab_size=64, block_size=32,
                n_experts=4, moe_top_k=2, **NO_DROP)
MIXTRAL = dict(model_type="mixtral-tiny", vocab_size=64, block_size=32, **NO_DROP)


def _cfgs(kw, **over):
    """(JAX config, port config) of ``kw``, a preset cut to 2 layers."""
    jcfg, tcfg = JConfig.make(**kw), GPTConfig.make(**kw)
    over = dict(over)
    if "model_type" in kw:
        over.setdefault("n_layer", 2)
    return dataclasses.replace(jcfg, **over), dataclasses.replace(tcfg, **over)


def _both(kw, **over):
    """(JAX config, JAX params, port config, port params on the CPU)."""
    jcfg, tcfg = _cfgs(kw, **over)
    tree = j_gpt.init(jax.random.key(0), jcfg)
    return jcfg, tree, tcfg, convert.params_from_numpy(
        jax.tree.map(np.array, tree), tcfg, "cpu")


def _weights(seed, d, f, e, swiglu, scale=0.2):
    rng = np.random.default_rng(seed)
    w = {"wr": rng.standard_normal((d, e)).astype(np.float32),
         "w1": (rng.standard_normal((e, d, f)) * scale).astype(np.float32),
         "w2": (rng.standard_normal((e, f, d)) * scale).astype(np.float32)}
    if swiglu:
        w["wg"] = (rng.standard_normal((e, d, f)) * scale).astype(np.float32)
    return w


def _jax_moe(x, w, **kw):
    return j_moe.moe_mlp(jnp.asarray(x), jnp.asarray(w["wr"]), jnp.asarray(w["w1"]),
                         jnp.asarray(w["w2"]),
                         w_gate=jnp.asarray(w["wg"]) if "wg" in w else None, **kw)


def _port_moe(x, w, **kw):
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    return moe.moe_mlp(torch.from_numpy(x), t["wr"], t["w1"], t["w2"],
                       w_gate=t.get("wg"), **kw)


# (B, T, D, F, E, k, capacity factor, SwiGLU)
MLP_CASES = {
    "k1_gelu": (2, 8, 16, 32, 4, 1, 1.25, False),
    "k2_gelu": (2, 8, 16, 32, 4, 2, 1.25, False),
    "k1_swiglu": (2, 8, 16, 32, 4, 1, 1.25, True),
    "k2_swiglu": (2, 8, 16, 32, 4, 2, 1.25, True),
    "k2_binding_cap0.5": (2, 16, 16, 32, 4, 2, 0.5, True),
    "k2_groups_s2048": (1, 2048, 16, 8, 4, 2, 1.0, False),
    "k2_one_group_s1031": (1, 1031, 16, 8, 4, 2, 1.25, True),
}


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_moe_mlp_forward_and_aux_match_jax(case):
    b, t, d, f, e, k, cf, sw = MLP_CASES[case]
    x = np.random.default_rng(1).standard_normal((b, t, d)).astype(np.float32)
    w = _weights(2, d, f, e, sw)
    want, jaux = _jax_moe(x, w, top_k=k, capacity_factor=cf)
    got, aux = _port_moe(x, w, top_k=k, capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=FWD_TOL)


def test_group_size_matches_jax():
    for s in (1, 100, 1024, 1025, 1031, 2048, 3000, 4096, 8192, 127 * 131):
        assert moe._group_size(s) == j_moe._group_size(s)
    assert moe._group_size(2048) == 1024 and moe._group_size(1031) == 1031


@pytest.mark.parametrize("case", ["k1_gelu", "k2_swiglu", "k2_binding_cap0.5"])
def test_moe_mlp_gradients_match_jax_grad(case):
    """d(sum(out^2) + 0.01 aux) with respect to the router, every expert
    weight and the input, against jax.grad."""
    b, t, d, f, e, k, cf, sw = MLP_CASES[case]
    x = np.random.default_rng(3).standard_normal((b, t, d)).astype(np.float32)
    w = _weights(4, d, f, e, sw)

    def jloss(p, xx):
        out, aux = j_moe.moe_mlp(xx, p["wr"], p["w1"], p["w2"], top_k=k,
                                 capacity_factor=cf, w_gate=p.get("wg"))
        return jnp.sum(out ** 2) + 0.01 * aux

    jp = {n: jnp.asarray(v) for n, v in w.items()}
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {n: torch.from_numpy(v).requires_grad_() for n, v in w.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_mlp(tx, tp["wr"], tp["w1"], tp["w2"], top_k=k,
                           capacity_factor=cf, w_gate=tp.get("wg"))
    ((out ** 2).sum() + 0.01 * aux).backward()
    for n in w:
        np.testing.assert_allclose(tp[n].grad.numpy(), np.asarray(jg[n]),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=n)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=GRAD_TOL,
                               atol=GRAD_TOL)


def test_per_row_routing_is_the_jax_vmap_over_rows():
    """per_row=True on (S, 1, D) routes each row as its own group: the JAX
    engine's vmap of moe_mlp over the slots, here with a capacity factor
    that binds when the S rows are routed together."""
    s, d, f, e = 4, 16, 32, 4
    x = np.random.default_rng(5).standard_normal((s, 1, d)).astype(np.float32)
    w = _weights(6, d, f, e, True)
    kw = dict(top_k=2, capacity_factor=0.5)
    want = jax.vmap(lambda xi: _jax_moe(xi[None], w, **kw)[0][0])(jnp.asarray(x))
    got, _ = _port_moe(x, w, per_row=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FWD_TOL)
    together, _ = _port_moe(x, w, **kw)
    assert np.abs(together.numpy() - np.asarray(want)).max() > 1e-3


def test_moe_flops_counts_the_products_flop_counter_sees():
    """moe_flops (the attribution's and the smoke's routed count) equals
    torch.utils.flop_counter's count of moe_mlp's products, one-token
    groups (the decode step's per-row routing) included."""
    from torch.utils.flop_counter import FlopCounterMode

    for (b, t, d, f, e, k, cf, sw), per_row in (
            (MLP_CASES["k2_swiglu"], False), (MLP_CASES["k2_groups_s2048"], False),
            (MLP_CASES["k2_one_group_s1031"], False), ((4, 1, 16, 32, 4, 2, 0.5, True), True)):
        x = np.random.default_rng(7).standard_normal((b, t, d)).astype(np.float32)
        with FlopCounterMode(display=False) as fc:
            _port_moe(x, _weights(8, d, f, e, sw), top_k=k, capacity_factor=cf,
                      per_row=per_row)
        assert fc.get_total_flops() == moe.moe_flops(b * t, d, f, e, k, cf, sw,
                                                     per_row=per_row, rows=b)


# ---------------------------------------------------------------------------
# the model against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [MIXTRAL, GELU_MOE], ids=["mixtral_tiny", "gelu_moe"])
def test_forward_logits_and_loss_with_aux_match_jax(kw):
    jcfg, tree, tcfg, params = _both(kw)
    tokens = np.random.default_rng(9).integers(0, 64, (2, 32))
    want, jloss = j_gpt.forward(tree, jnp.asarray(tokens), jcfg,
                                targets=jnp.asarray(tokens))
    got, loss = gpt.forward(params, torch.from_numpy(tokens), tcfg,
                            targets=torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=FWD_TOL)
    # the aux term is in it: the same loss without it is lower in both
    _, j0 = j_gpt.forward(tree, jnp.asarray(tokens),
                          dataclasses.replace(jcfg, moe_aux_weight=0.0),
                          targets=jnp.asarray(tokens))
    _, t0 = gpt.forward(params, torch.from_numpy(tokens),
                        dataclasses.replace(tcfg, moe_aux_weight=0.0),
                        targets=torch.from_numpy(tokens))
    assert loss.item() > t0.item()
    np.testing.assert_allclose(loss.item() - t0.item(), float(jloss) - float(j0),
                               rtol=1e-4)


@pytest.mark.parametrize("kw", [MIXTRAL, GELU_MOE], ids=["mixtral_tiny", "gelu_moe"])
def test_loss_only_forward_and_gradients_match_jax(kw):
    """The trainer's loss-only forward (chunked cross-entropy) and the
    gradients of every leaf, the expert leaves included, against
    jax.grad of the JAX loss."""
    jcfg, tree, tcfg, params = _both(kw, loss_chunks=4)
    tokens = np.random.default_rng(10).integers(0, 64, (2, 32))
    jl, jg = jax.value_and_grad(lambda p: j_gpt.forward(
        p, jnp.asarray(tokens), jcfg, targets=jnp.asarray(tokens),
        return_logits=False)[1])(tree)
    leaves = {k: v.requires_grad_() for k, v in convert.flatten(params).items()}
    tp = convert.unflatten(leaves)
    _, loss = gpt.forward(tp, torch.from_numpy(tokens), tcfg,
                          targets=torch.from_numpy(tokens), return_logits=False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=FWD_TOL)
    want = convert.flatten(jax.tree.map(np.asarray, jg))
    assert {"blocks/w_router", "blocks/w_e1", "blocks/w_e2"} <= set(want)
    for name, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), want[name], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("kw", [MIXTRAL, GELU_MOE], ids=["mixtral_tiny", "gelu_moe"])
def test_cached_generate_matches_jax(kw):
    """generate at B = 2: the prompt's 2 x 5 tokens and then each step's 2
    tokens route as one group in both packages; greedy tokens exact."""
    jcfg, tree, tcfg, params = _both(kw)
    prompt = np.random.default_rng(11).integers(0, 64, (2, 5))
    want = np.asarray(j_gen.generate(tree, jcfg, jnp.asarray(prompt), 10))
    got = gen.generate(params, tcfg, prompt, 10, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_sliding_window_generate_matches_jax():
    """Past the window generate forwards the whole window each step
    (one group of B * block_size tokens) in both packages."""
    jcfg, tree, tcfg, params = _both(GELU_MOE, block_size=16)
    prompt = np.random.default_rng(12).integers(0, 64, (1, 12))
    want = np.asarray(j_gen.generate(tree, jcfg, jnp.asarray(prompt), 8))
    got = gen.generate(params, tcfg, prompt, 8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_decode_logits(tree, cfg, cache, tokens, positions):
    """The JAX engine's decode step: a vmap of the solo cached forward over
    the slots, up to the logits."""
    def one_slot(tok, cache_slot, pos):
        cache_b = jax.tree.map(lambda a: a[:, None], cache_slot)
        logits, lane = j_gen._forward_cached(tree, tok[None, None], cache_b, pos, cfg)
        return logits[0], jax.tree.map(lambda a: a[:, 0], lane)

    return jax.vmap(one_slot, in_axes=(0, 1, 0), out_axes=(0, 1))(
        tokens, cache, positions)


@pytest.mark.parametrize("kw", [MIXTRAL, GELU_MOE], ids=["mixtral_tiny", "gelu_moe"])
def test_engine_decode_step_routes_each_slot_alone_like_jax(kw):
    """Four slots, capacity factor 0.5, over one random cache: the port's
    batched decode step (one (4, 1) forward with per-row positions) against
    the JAX engine's vmap over the slots, logits within 1e-5. Routed as one
    group of four tokens, capacity would bind (one row per expert for
    eight choices) and the logits would differ: this test was checked to
    fail with the decode step's per-row routing switched off."""
    jcfg, tree, tcfg, params = _both(kw, moe_capacity_factor=0.5)
    rng = np.random.default_rng(13)
    shape = (tcfg.n_layer, 4, tcfg.block_size, tcfg.kv_heads, tcfg.head_dim)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    tokens, positions = np.array([4, 9, 33, 60]), np.array([5, 17, 30, 11])
    want, _ = _jax_decode_logits(tree, jcfg, {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
                                 jnp.asarray(tokens, jnp.int32),
                                 jnp.asarray(positions, jnp.int32))
    cache = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    got = gen._forward_cached(params, torch.from_numpy(tokens)[:, None], cache,
                              torch.from_numpy(positions), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FWD_TOL)


PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], list(range(10, 23)), [40, 41],
           list(range(3, 20)) + [25], [20, 21, 22]]


def _server_tokens(js, ts, prompts, news):
    jh = [js.submit(JRequest(prompt=p, max_new_tokens=n)) for p, n in zip(prompts, news)]
    th = [ts.submit(Request(prompt=p, max_new_tokens=n)) for p, n in zip(prompts, news)]
    js.run_until_drained(max_steps=300)
    ts.run_until_drained(max_steps=300)
    return [h.tokens for h in jh], [h.tokens for h in th]


@pytest.mark.parametrize("kw", [MIXTRAL, GELU_MOE], ids=["mixtral_tiny", "gelu_moe"])
def test_server_matches_the_jax_server_where_capacity_binds(kw):
    """Both servers, 4 slots, capacity factor 0.5, six greedy requests with
    chunked prefill (chunks of 8 padded to buckets 4, 8, 16 and 32: the
    pad tokens are routed and take capacity in both) and the prefix store:
    token-identical per request."""
    jcfg, tree, tcfg, params = _both(kw, moe_capacity_factor=0.5)
    opts = dict(n_slots=4, prefill_buckets=(4, 8, 16, 32), prefill_chunk=8,
                prefix_cache_mb=4.0)
    want, got = _server_tokens(JServer(tree, jcfg, **opts),
                               InferenceServer(params, tcfg, device="cpu", **opts),
                               PROMPTS, [6, 8, 5, 7, 4, 9])
    assert got == want


@pytest.mark.parametrize("extra", ["spec_self1", "int8"])
def test_speculative_and_int8_servers_match_jax(extra):
    """A speculative server (the target's first layer as draft, k = 2) and
    an int8 pool on the MoE model, each against the JAX server with the
    same options: token-identical."""
    jcfg, tree, tcfg, params = _both(MIXTRAL)
    if extra == "int8":
        jkw = tkw = dict(kv_dtype="int8")
    else:
        jtree1 = dict(tree, blocks={k: v[:1] for k, v in tree["blocks"].items()})
        jkw = dict(draft_params=jtree1, draft_cfg=dataclasses.replace(jcfg, n_layer=1),
                   spec_k=2)
        tkw = dict(draft_params=dict(params, blocks={k: v[:1] for k, v in
                                                     params["blocks"].items()}),
                   draft_cfg=dataclasses.replace(tcfg, n_layer=1), spec_k=2)
    opts = dict(n_slots=2, prefill_buckets=(8, 32))
    js, ts = JServer(tree, jcfg, **opts, **jkw), InferenceServer(
        params, tcfg, device="cpu", **opts, **tkw)
    want, got = _server_tokens(js, ts, PROMPTS[:4], [6, 6, 6, 6])
    assert got == want
    if extra != "int8":
        assert ts.metrics.spec_rounds > 0


@pytest.mark.parametrize("kw", [MIXTRAL, GELU_MOE], ids=["mixtral_tiny", "gelu_moe"])
def test_convert_round_trips_the_expert_leaves(kw):
    jcfg, tree, tcfg, params = _both(kw)
    back = convert.params_to_numpy(params)
    assert convert.flatten(back).keys() == convert.flatten(
        jax.tree.map(np.asarray, tree)).keys()
    for name, v in convert.flatten(jax.tree.map(np.asarray, tree)).items():
        np.testing.assert_array_equal(convert.flatten(back)[name], v)
    leaves = set(params["blocks"])
    assert {"w_router", "w_e1", "w_e2"} <= leaves
    assert ("w_eg" in leaves) == tcfg.swiglu
    assert not leaves & {"w_gate", "w_up", "w_down", "w_fc", "w_proj", "b_fc"}
    # the JAX tree's key order, leaf by leaf
    assert list(params["blocks"]) == list(tree["blocks"])


# ---------------------------------------------------------------------------
# counterparts of tests/test_moe.py
# ---------------------------------------------------------------------------


def test_single_expert_equals_dense_mlp():
    d, f = 16, 32
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, d), generator=g)
    w1, w2 = torch.randn((d, f), generator=g) * 0.2, torch.randn((f, d), generator=g) * 0.2
    out, aux = moe.moe_mlp(x, torch.zeros((d, 1)), w1[None], w2[None], top_k=1,
                           capacity_factor=2.0)
    torch.testing.assert_close(out, L.mlp_gelu(x, w1, None, w2, None), rtol=1e-5, atol=1e-5)
    assert aux.item() == pytest.approx(1.0, rel=1e-6)


def test_topk_routing_mixes_experts():
    x = np.random.default_rng(0).standard_normal((1, 32, 8)).astype(np.float32)
    w = _weights(1, 8, 16, 4, False)
    out1, _ = _port_moe(x, w, top_k=1, capacity_factor=4.0)
    out2, _ = _port_moe(x, w, top_k=2, capacity_factor=4.0)
    assert out1.shape == out2.shape == x.shape
    assert (out1 - out2).abs().max().item() > 1e-6


def test_capacity_overflow_drops_not_crashes():
    x = np.random.default_rng(0).standard_normal((1, 64, 8)).astype(np.float32)
    w = _weights(2, 8, 16, 2, False)
    w["wr"] = np.zeros((8, 2), np.float32)
    w["wr"][:, 0] = 5.0  # every token prefers expert 0
    out, aux = _port_moe(x, w, top_k=1, capacity_factor=0.25)
    assert torch.isfinite(out).all() and np.isfinite(aux.item())
    assert out[0].norm(dim=-1).min().item() == 0.0  # dropped tokens give 0


def test_switch_k1_router_gets_task_gradient():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 32, 8)).astype(np.float32))
    w = {k: torch.from_numpy(v).requires_grad_() for k, v in _weights(1, 8, 16, 4, False).items()}
    out, _ = moe.moe_mlp(x, w["wr"], w["w1"], w["w2"], top_k=1, capacity_factor=2.0)
    (out ** 2).sum().backward()  # no aux term
    assert w["wr"].grad.abs().max().item() > 0


def test_grouped_dispatch_matches_one_group():
    """S spanning several groups gives each row what it gives alone (the
    capacity does not bind)."""
    d, f, e = 8, 16, 2
    x = np.random.default_rng(0).standard_normal((2, moe.MAX_GROUP, d)).astype(np.float32)
    w = _weights(3, d, f, e, False)
    out, _ = _port_moe(x, w, top_k=1, capacity_factor=2.0)
    small, _ = _port_moe(x[:1], w, top_k=1, capacity_factor=2.0)
    torch.testing.assert_close(out[:1], small, rtol=1e-5, atol=1e-5)


def test_gradients_flow_to_router_and_experts():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 32, 8)).astype(np.float32))
    w = {k: torch.from_numpy(v).requires_grad_() for k, v in _weights(1, 8, 16, 4, False).items()}
    out, aux = moe.moe_mlp(x, w["wr"], w["w1"], w["w2"], top_k=2, capacity_factor=2.0)
    ((out ** 2).sum() + 0.01 * aux).backward()
    for name, t in w.items():
        assert t.grad.abs().max().item() > 0, name


def test_moe_forward_and_loss():
    cfg = GPTConfig.make(n_layer=2, n_head=2, n_embd=32, vocab_size=64, block_size=16,
                         n_experts=4, moe_top_k=2, **NO_DROP)
    params = gpt.init(cfg, torch.Generator().manual_seed(0))
    assert params["blocks"]["w_e1"].shape == (2, 4, 32, 128)
    tokens = torch.randint(0, 64, (2, 16), generator=torch.Generator().manual_seed(1))
    logits, loss = gpt.forward(params, tokens, cfg, targets=tokens)
    assert logits.shape == (2, 16, 64) and np.isfinite(loss.item())
    _, loss0 = gpt.forward(params, tokens, dataclasses.replace(cfg, moe_aux_weight=0.0),
                           targets=tokens)
    assert loss.item() > loss0.item()


def _dense_greedy(params, cfg, prompt, n):
    """Greedy decode by a full re-forward of the whole sequence per token."""
    seq = torch.as_tensor(prompt)
    for _ in range(n):
        logits, _ = gpt.forward(params, seq, cfg)
        seq = torch.cat([seq, logits[:, -1].argmax(-1, keepdim=True)], dim=1)
    return seq


def test_moe_generation_matches_dense_oracle():
    """With capacity that never binds (factor = E / k), the cached decode
    routes as the full re-forward does."""
    cfg = GPTConfig.make(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32,
                         n_experts=2, moe_top_k=1, moe_capacity_factor=2.0, **NO_DROP)
    params = gpt.init(cfg, torch.Generator().manual_seed(0))
    prompt = np.random.default_rng(1).integers(0, 50, (2, 5))
    got = gen.generate(params, cfg, prompt, 8, device="cpu")
    torch.testing.assert_close(got, _dense_greedy(params, cfg, prompt, 8))


def test_moe_config_validation():
    with pytest.raises(ConfigError, match="moe_top_k"):
        GPTConfig.make(n_layer=2, n_head=2, n_embd=32, n_experts=2, moe_top_k=3)


def test_swiglu_single_expert_equals_dense_swiglu():
    d, f = 16, 32
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, d), generator=g)
    wg, wu, wd = (torch.randn(s, generator=g) * 0.2 for s in ((d, f), (d, f), (f, d)))
    out, _ = moe.moe_mlp(x, torch.zeros((d, 1)), wu[None], wd[None], top_k=1,
                         capacity_factor=2.0, w_gate=wg[None])
    torch.testing.assert_close(out, L.mlp_swiglu(x, wg, wu, wd), rtol=1e-5, atol=1e-5)


def test_mixtral_style_model_trains_and_generates():
    cfg = GPTConfig.make(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32,
                         rope=True, swiglu=True, rmsnorm=True, n_kv_head=1,
                         tie_weights=True, n_experts=2, moe_top_k=2,
                         moe_capacity_factor=2.0, **NO_DROP)
    params = gpt.init(cfg, torch.Generator().manual_seed(0))
    assert params["blocks"]["w_eg"].shape == params["blocks"]["w_e1"].shape
    tokens = torch.randint(0, 50, (2, 16), generator=torch.Generator().manual_seed(1))
    w_eg = params["blocks"]["w_eg"].requires_grad_()
    _, loss = gpt.forward(params, tokens, cfg, targets=tokens)
    loss.backward()
    assert np.isfinite(loss.item()) and w_eg.grad.abs().max().item() > 0
    params["blocks"]["w_eg"] = w_eg.detach()
    prompt = np.random.default_rng(2).integers(0, 50, (1, 4))
    got = gen.generate(params, cfg, prompt, 6, device="cpu")
    torch.testing.assert_close(got, _dense_greedy(params, cfg, prompt, 6))


@pytest.mark.parametrize("preset", ["mixtral-tiny", "mixtral-8x7b"])
def test_mixtral_presets_resolve_and_run(preset):
    """Both presets resolve; mixtral-tiny runs a forward and a loss, and
    mixtral-8x7b's parameter tree has Mixtral's shapes (built on the meta
    device: 46.7 G parameters)."""
    cfg = GPTConfig.make(model_type=preset, **NO_DROP)
    assert cfg.n_experts and cfg.moe_top_k == 2 and cfg.swiglu
    if preset == "mixtral-8x7b":
        spec = gpt.param_spec(cfg)["blocks"]
        assert spec["w_e1"][0] == (32, 8, 4096, 14336)
        assert spec["w_eg"][0] == spec["w_e1"][0] and spec["w_router"][0] == (32, 4096, 8)
        return
    cfg = dataclasses.replace(cfg, block_size=16, vocab_size=64)
    params = gpt.init(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, 64, (2, 16), generator=torch.Generator().manual_seed(1))
    logits, loss = gpt.forward(params, toks, cfg, targets=toks)
    assert logits.shape == (2, 16, 64) and np.isfinite(loss.item())


def test_moe_trainer_learns_in_one_process(tmp_path):
    """Counterpart of tests/test_moe.py's trainer case at ep = 1: the MoE
    model trains through GPTTrainer on one process and the loss falls; MoE
    beside sp still raises, naming item 12b (dp, fsdp, ep and tp run:
    tests/test_torch_moe_ep.py)."""
    from mingpt_distributed_tpu_torch.config import OptimizerConfig, TrainerConfig
    from mingpt_distributed_tpu_torch.data.char_dataset import CharDataset
    from mingpt_distributed_tpu_torch.config import DataConfig
    from mingpt_distributed_tpu_torch.training.trainer import GPTTrainer

    text = "the quick brown fox jumps over the lazy dog. " * 40
    ds = CharDataset(DataConfig(path="<inline>", block_size=16, train_split=0.9), text=text)
    train, test = ds.split()
    gcfg = GPTConfig.make(n_layer=2, n_head=2, n_embd=32, vocab_size=ds.vocab_size,
                          block_size=16, n_experts=4, moe_top_k=2, **NO_DROP)
    tcfg = TrainerConfig.make(max_epochs=1, batch_size=16, grad_norm_clip=1.0,
                              save_every=100, log_every=1, seed=7, max_steps=8,
                              snapshot_path=str(tmp_path / "moe.pt"))
    tr = GPTTrainer(tcfg, gcfg, OptimizerConfig(learning_rate=1e-2), train, test,
                    device="cpu")
    losses = []
    for xy in tr.train_iter.epoch_batches():
        losses.append(tr._train_step(tr.state, tr._put_batch(xy), tr.generator)["loss"].item())
        if len(losses) == 8:
            break
    tr.close()
    assert losses[-1] < losses[0]
    gpt.check_supported(gcfg, dict(sp=2))  # MoE beside sp runs (tests/test_torch_moe_sp.py)
    gpt.check_supported(gcfg, dict(dp=2, fsdp=2, ep=2, tp=2))
