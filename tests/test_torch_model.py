"""The PyTorch port's GPT forward against the JAX package's.

The JAX parameters (``gpt.init``, perturbed so no bias or norm is trivial)
go through ``convert.params_from_numpy``; logits and loss must match
``gpt.forward`` at float32 within atol/rtol 1e-4 (the matmuls sum in a
different order). GPT-2-style and Llama-style small configs, with the
einsum oracle and the flash path (Pallas interpret mode on the JAX side,
the kernel's plain version on the port's).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingpt_distributed_tpu.config import GPTConfig as JConfig
from mingpt_distributed_tpu.models import gpt as j_gpt
from mingpt_distributed_tpu_torch.config import GPTConfig as TConfig
from mingpt_distributed_tpu_torch.models import GPT, convert
from mingpt_distributed_tpu_torch.models import gpt as t_gpt
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)

SMALL = dict(n_layer=2, n_head=4, n_embd=64, vocab_size=96, block_size=32,
             dtype="float32", embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
CONFIGS = {
    "gpt2": dict(SMALL),
    "llama": dict(SMALL, rope=True, swiglu=True, rmsnorm=True, n_kv_head=2,
                  tie_weights=True),
    "window_softcap": dict(SMALL, attention_window=8, attn_logit_softcap=20.0,
                           final_logit_softcap=15.0),
}


def jax_params(jcfg, seed=0):
    """JAX init, then every leaf perturbed so zero biases, unit norm scales
    and the zero position table take real values too."""
    tree = jax.device_get(j_gpt.init(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32),
        tree)


def both(name, attention):
    kw = dict(CONFIGS[name], attention=attention)
    return JConfig.make(**kw), TConfig.make(**kw)


@pytest.mark.parametrize("attention", ["einsum", "flash"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name, attention):
    jcfg, tcfg = both(name, attention)
    tree = jax_params(jcfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 96, (2, 32)).astype(np.int32)
    targets = rng.integers(0, 96, (2, 32)).astype(np.int32)
    targets[0, :5] = -1
    want_logits, want_loss = j_gpt.forward(
        tree, jnp.asarray(tokens), jcfg, targets=jnp.asarray(targets),
        return_logits=True)
    params = convert.params_from_numpy(tree, tcfg, device="cpu")
    got_logits, got_loss = t_gpt.forward(
        params, torch.from_numpy(tokens).long(), tcfg,
        targets=torch.from_numpy(targets).long())
    assert got_logits.dtype == torch.float32
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), **TOL)


def test_facade_forward_matches_jax_and_counts_params():
    jcfg, tcfg = both("gpt2", "flash")
    tree = jax_params(jcfg, seed=3)
    tokens = np.random.default_rng(2).integers(0, 96, (3, 20)).astype(np.int32)
    model = GPT(tcfg, convert.params_from_numpy(tree, tcfg, device="cpu"),
                device="cpu")
    logits, loss = model(tokens)
    assert loss is None
    want, _ = j_gpt.forward(tree, jnp.asarray(tokens), jcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    assert model.num_params == j_gpt.param_count(tree)
    assert not any(p.requires_grad for p in model.parameters())


def test_bf16_forward_runs_with_fp32_logits():
    _, tcfg = both("llama", "flash")
    model = GPT(TConfig.make(**dict(CONFIGS["llama"], dtype="bfloat16")),
                device="cpu")
    logits, _ = model(np.zeros((1, 8), np.int64))
    assert logits.dtype == torch.float32 and logits.shape == (1, 8, 96)
    assert bool(torch.isfinite(logits).all())


def test_init_matches_jax_tree_and_scales():
    jcfg, tcfg = both("gpt2", "einsum")
    jtree = jax.device_get(j_gpt.init(jax.random.key(0), jcfg))
    params = t_gpt.init(tcfg, torch.Generator().manual_seed(0))
    np_params = convert.params_to_numpy(params)
    assert jax.tree.structure(np_params) == jax.tree.structure(jtree)
    for a, b in zip(jax.tree.leaves(np_params), jax.tree.leaves(jtree)):
        assert a.shape == b.shape
    assert np.all(np_params["wpe"] == 0)
    assert abs(np_params["wte"].std() - 0.02) < 2e-3
    assert abs(np_params["blocks"]["wo"].std() - 0.02 / np.sqrt(4)) < 2e-3


def test_convert_round_trip_and_refusals():
    jcfg, tcfg = both("llama", "einsum")
    tree = jax_params(jcfg)
    back = convert.params_to_numpy(convert.params_from_numpy(tree, tcfg, "cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert "head" not in back  # tied weights
    flat = convert.flatten(tree)
    assert "blocks/wq" in flat and convert.unflatten(flat).keys() == tree.keys()
    bad_shape = dict(tree, wte=tree["wte"][:, :32])
    with pytest.raises(ValueError, match="wte"):
        convert.params_from_numpy(bad_shape, tcfg, "cpu")
    extra = dict(tree, head=np.zeros((64, 96), np.float32))
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_numpy(extra, tcfg, "cpu")


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (2, 5)).astype(np.int64)
    targets[1, 2] = -1
    want = j_gpt.cross_entropy(jnp.asarray(logits), jnp.asarray(targets))
    got = t_gpt.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("override,mesh,error,match", [
    # a rank's chunk under sp > 1 needs sequence-parallel attention
    (dict(attention="einsum"), SimpleNamespace(sp=2, sp_rank=0), ValueError,
     "needs attention=ring or ulysses"),
])
def test_unported_options_raise(override, mesh, error, match):
    cfg = TConfig.make(**dict(SMALL, **override))
    with pytest.raises(error, match=match):
        params = t_gpt.init(cfg, torch.Generator().manual_seed(0))
        t_gpt.forward(params, torch.zeros((1, 4), dtype=torch.long), cfg,
                      mesh=mesh)


@pytest.mark.parametrize("attention", ["einsum", "flash"])
def test_remat_gives_the_same_loss_and_grads(attention):
    # remat recomputes each block in the backward (torch.utils.checkpoint),
    # replaying the block's dropout draws, so loss and grads are unchanged
    kw = dict(SMALL, attention=attention, embd_pdrop=0.1, resid_pdrop=0.1)
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(0, 96, (2, 32))).long()
    results = []
    for remat in (False, True):
        cfg = TConfig.make(**dict(kw, remat=remat))
        params = t_gpt.init(cfg, torch.Generator().manual_seed(0))
        leaves = [params["wte"], params["blocks"]["wq"], params["blocks"]["w_fc"]]
        for w in leaves:
            w.requires_grad_()
        gen = torch.Generator().manual_seed(7)
        _, loss = t_gpt.forward(params, tokens, cfg, targets=tokens,
                                generator=gen, deterministic=False,
                                return_logits=False)
        grads = torch.autograd.grad(loss, leaves)
        results.append((loss, grads, gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = results
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
