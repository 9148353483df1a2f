"""Head widths the port's flash kernels take, against the JAX package.

The JAX Pallas kernels take any head width; the port's CUDA kernels have
instances at 16, 32, 64, 80, 96, 128 and 256 and run any other width from
8 to 256 on the next instance up, zero-padded by the wrapper
(``flash_attention.head_plan``). On the CPU the wrappers run the kernels'
plain versions, so these tests hold the port's functions to the JAX
package's (Pallas in interpret mode) at hd 8, 48, 80, 96 and 256, float32,
on the same numpy inputs:

* ``causal_attention``: forward within 1e-5, gradients within 2e-4 (the JAX
  tests' tolerances); ``flash_with_lse`` hops, causal with a q offset and
  not causal, with an lse cotangent;
* a 2-layer GPT at narrow widths with those head widths (gemma-like with 1
  KV head at hd 256): loss, every parameter's gradient and one AdamW step;
* greedy sliding-window generation past the window at hd 96, token-exact;
* the wrappers' width plan as a pure function, and the padding it implies
  (zero columns change no output, lse or gradient at the true width's
  scale), in float64;
* ``chip_smoke.py``'s SASS expectations at the seven instances.
"""

import math
import os
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mingpt_distributed_tpu.config import GPTConfig as JConfig
from mingpt_distributed_tpu.config import OptimizerConfig as JOptConfig
from mingpt_distributed_tpu.models import generate as j_gen
from mingpt_distributed_tpu.models import gpt as j_gpt
from mingpt_distributed_tpu.ops import flash_attention as j_flash
from mingpt_distributed_tpu.training import optimizer as j_opt
from mingpt_distributed_tpu_torch.config import GPTConfig, OptimizerConfig
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import generate as t_gen
from mingpt_distributed_tpu_torch.models import gpt as t_gpt
from mingpt_distributed_tpu_torch.ops import flash_attention as t_flash
from mingpt_distributed_tpu_torch.training import optimizer as t_opt
from mingpt_distributed_tpu_torch.training import trainer as t_trainer
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
WIDTHS = (8, 48, 80, 96, 256)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# causal_attention and flash_with_lse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd", WIDTHS)
def test_causal_attention_matches_jax(hd):
    """(2, 128, h/kv, hd): the JAX dispatch runs its Pallas kernels at every
    width here (T 128 tiles; at hd 8 on 16 heads, its lane pack, which 2
    heads would reach by zero-padding 14 more); GQA 2:1 at hd 256 and 80."""
    b, t, h = 2, 128, 16 if hd == 8 else 2
    kv = 1 if hd in (80, 256) else h
    rng = np.random.default_rng(hd)
    q, k, v = _rand(rng, b, t, h, hd), _rand(rng, b, t, kv, hd), _rand(rng, b, t, kv, hd)
    do = _rand(rng, b, t, h, hd)
    out, vjp = jax.vjp(lambda q, k, v: j_flash.causal_attention(q, k, v),
                       *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = t_flash.causal_attention(qt, kt, vt)
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **FWD_TOL)
    for g, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal_offset", "non_causal"])
@pytest.mark.parametrize("hd", WIDTHS)
def test_flash_with_lse_hop_matches_jax(hd, causal):
    """A ring hop (BH 2, T 64): causal with q_offset 16 and a window of 40,
    or not causal; the gradients with an lse cotangent."""
    bh, t, block = 2, 64, 32
    window, q_offset = (40, 16) if causal else (None, 0)
    scale = 1.0 / math.sqrt(hd)
    rng = np.random.default_rng(1000 + hd)
    q, k, v, do = (_rand(rng, bh, t, hd) for _ in range(4))
    dlse = _rand(rng, bh, t, 1)
    fn = lambda q, k, v: j_flash.flash_with_lse(  # noqa: E731
        q, k, v, scale, block, causal, window, None, q_offset)
    (out, lse), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(g) for g in vjp((jnp.asarray(do), jnp.asarray(dlse)))]
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got, got_lse = t_flash.flash_with_lse(qt, kt, vt, scale, causal, window, None, q_offset)
    torch.autograd.backward((got, got_lse), (torch.from_numpy(do), torch.from_numpy(dlse)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **FWD_TOL)
    np.testing.assert_allclose(got_lse.detach().numpy(), np.asarray(lse), **FWD_TOL)
    for g, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


# ---------------------------------------------------------------------------
# a 2-layer GPT at each width: loss, gradients, one AdamW step
# ---------------------------------------------------------------------------

SMALL = dict(n_layer=2, vocab_size=96, block_size=32, dtype="float32", embd_pdrop=0.0,
             resid_pdrop=0.0, attn_pdrop=0.0, attention="flash")
# head width: the model (n_embd / n_head)
GPT_WIDTHS = {
    8: dict(n_embd=128, n_head=16),  # 16 heads: JAX's lane pack at hd 8
    48: dict(n_embd=96, n_head=2),
    80: dict(n_embd=160, n_head=2),  # GPT-3 2.7B's head width
    96: dict(n_embd=192, n_head=2),  # GPT-3 Large's
    # Gemma 2B's: multi-query, rope, rmsnorm, gated MLP, tied embeddings
    256: dict(n_embd=512, n_head=2, n_kv_head=1, rope=True, rmsnorm=True, swiglu=True,
              tie_weights=True),
}


def _gpt(hd):
    kw = dict(SMALL, **GPT_WIDTHS[hd])
    jcfg, tcfg = JConfig.make(**kw), GPTConfig.make(**kw)
    assert jcfg.head_dim == tcfg.head_dim == hd
    tree = jax.device_get(j_gpt.init(jax.random.key(hd), jcfg))
    rng = np.random.default_rng(hd)
    tree = jax.tree.map(lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32),
                        tree)
    tok = rng.integers(0, 96, (2, 33)).astype(np.int32)
    return jcfg, tcfg, tree, tok[:, :-1], tok[:, 1:]


@pytest.mark.parametrize("hd", sorted(GPT_WIDTHS))
def test_gpt_loss_gradients_and_adamw_step_match_jax(hd):
    jcfg, tcfg, tree, x, y = _gpt(hd)
    jparams = jax.tree.map(jnp.asarray, tree)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: j_gpt.forward(
        p, jnp.asarray(x), jcfg, targets=jnp.asarray(y), return_logits=False)[1]))(jparams)
    params = t_trainer.trainable(convert.params_from_numpy(tree, tcfg, "cpu"))
    _, loss = t_gpt.forward(params, torch.from_numpy(x).long(), tcfg,
                            targets=torch.from_numpy(y).long(), return_logits=False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = convert.flatten(jax.device_get(jgrads))
    got = {name: p.grad.numpy() for name, p in convert.flatten(params).items()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **GRAD_TOL, err_msg=name)

    # one AdamW step: the port's train step against the JAX trainer's
    # optimizer (clip at 1.0, AdamW) on the JAX gradients above, which is
    # what the JAX train step applies to them
    jopt = j_opt.make_optimizer(JOptConfig(learning_rate=1e-3), 1.0)
    updates, _ = jopt.update(jgrads, jopt.init(jparams), jparams)
    jnew = optax.apply_updates(jparams, updates)
    params = t_trainer.trainable(convert.params_from_numpy(tree, tcfg, "cpu"))
    state = t_trainer.TrainState(params, t_opt.make_optimizer(
        OptimizerConfig.make(learning_rate=1e-3), params, 1.0))
    tm = t_trainer.make_train_step(tcfg)(state, (torch.from_numpy(x).long(),
                                                 torch.from_numpy(y).long()))
    np.testing.assert_allclose(tm["loss"].item(), float(jloss), rtol=1e-5)
    # the norm of gradients each held within 2e-4 above, at that tolerance
    np.testing.assert_allclose(tm["grad_norm"].item(), float(optax.global_norm(jgrads)),
                               rtol=2e-4)
    got = convert.flatten(convert.params_to_numpy(state.params))
    want = convert.flatten(jax.device_get(jnew))
    # Adam's first step moves a weight by ~lr g / |g|: where |g| is tiny
    # the two float32 gradients' last digits move it apart, so the trainer
    # parity tests' atol 1e-4 (a tenth of lr) applies
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-4, err_msg=name)


def test_sliding_window_generation_at_hd96_matches_jax():
    """Greedy decoding past the 32-position window (28 + 10 tokens), where
    both packages re-run the flash forward over the window each token."""
    kw = dict(SMALL, **GPT_WIDTHS[96])
    jcfg, tcfg = JConfig.make(**kw), GPTConfig.make(**kw)
    tree = jax.device_get(j_gpt.init(jax.random.key(3), jcfg))
    rng = np.random.default_rng(3)
    # larger weights than init: sharper logits, so greedy paths are not ties
    tree = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
                        tree)
    prompt = rng.integers(0, 96, (2, 28)).astype(np.int32)
    want = j_gen.generate(tree, jcfg, prompt, 10)
    params = convert.params_from_numpy(tree, tcfg, "cpu")
    got = t_gen.generate(params, tcfg, prompt, 10, device="cpu")
    assert got.shape == (2, 38)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the width plan and its padding
# ---------------------------------------------------------------------------


def test_native_widths_are_the_instances_of_both_sources():
    """NATIVE_HEAD_DIMS is what the C dispatchers switch on."""
    csrc = Path(REPO) / "mingpt_distributed_tpu_torch/ops/csrc"
    for name in ("flash_fwd.cu", "flash_bwd.cu"):
        cases = {int(c) for c in re.findall(r"case (\d+):", (csrc / name).read_text())}
        assert set(t_flash.NATIVE_HEAD_DIMS) <= cases
    assert t_flash.HEAD_DIM_RANGE == (8, 256)


@pytest.mark.parametrize("hd, want", [
    (8, (16, 8)), (16, (16, 0)), (17, (32, 15)), (24, (32, 8)), (48, (64, 16)),
    (64, (64, 0)), (72, (80, 8)), (80, (80, 0)), (88, (96, 8)), (96, (96, 0)),
    (112, (128, 16)), (128, (128, 0)), (160, (256, 96)), (192, (256, 64)),
    (255, (256, 1)), (256, (256, 0)),
])
def test_head_plan_runs_the_next_instance_up(hd, want):
    assert t_flash.head_plan(hd) == want


@pytest.mark.parametrize("hd", [0, 4, 7, 257, 320])
def test_head_plan_refuses_widths_outside_the_range(hd):
    with pytest.raises(ValueError, match=f"head_dim {hd} .*8..256"):
        t_flash.head_plan(hd)


@pytest.mark.parametrize("hd", [8, 48, 96])
def test_padding_copies_dense_and_native_widths_are_read_in_place(hd):
    """A native width's q/k/v (a strided view of one qkv projection here)
    reach the kernel as they are; any other width as a dense zero-padded
    copy, which the bf16 kernels read 16-byte aligned."""
    x = torch.randn(2, 5, 3, 4, hd).to(torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    _, pad = t_flash.head_plan(hd)
    got = t_flash._padded(pad, q, k, v)
    if pad == 0:
        assert all(a is b for a, b in zip(got, (q, k, v)))
        return
    for g, src in zip(got, (q, k, v)):
        assert g.is_contiguous() and g.shape == (2, 5, 4, hd + pad)
        assert torch.equal(g[..., :hd], src) and not g[..., hd:].any()
    (back,) = t_flash._true_width(pad, got[0])
    assert torch.equal(back, q)


@pytest.mark.parametrize("hd", [8, 24, 48, 112, 160])
def test_zero_columns_change_no_output_lse_or_gradient(hd):
    """The plain versions on zero-padded q/k/v at the true width's scale
    equal the unpadded ones (float64), forward and backward, causal with a
    window and GQA, and the lse hop with an offset: the padded kernel's
    function, restricted to the true width."""
    inst, pad = t_flash.head_plan(hd)
    rng = np.random.default_rng(hd)
    b, t, h, kv = 1, 40, 4, 2
    q, do = (torch.from_numpy(rng.standard_normal((b, t, h, hd))) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, t, kv, hd))) for _ in range(2))
    kw = dict(scale=1.0 / math.sqrt(hd), window=16)
    out, lse = t_flash.flash_fwd_plain(q, k, v, **kw)
    qp, kp, vp, dop = t_flash._padded(pad, q, k, v, do)
    outp, lsep = t_flash.flash_fwd_plain(qp, kp, vp, **kw)
    assert outp.shape[-1] == inst and not outp[..., hd:].any()
    torch.testing.assert_close(outp[..., :hd], out, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(lsep, lse, rtol=1e-12, atol=1e-12)
    grads = t_flash.flash_bwd_plain(q, k, v, out, lse, do, **kw)
    gradsp = t_flash.flash_bwd_plain(qp, kp, vp, outp, lsep, dop, **kw)
    for g, gp in zip(grads, t_flash._true_width(pad, *gradsp)):
        torch.testing.assert_close(gp, g, rtol=1e-12, atol=1e-12)
    lkw = dict(scale=1.0 / math.sqrt(hd), causal=True, window=24, q_offset=8)
    dlse = torch.from_numpy(rng.standard_normal((b, h, t)))
    out, lse = t_flash.flash_lse_fwd_plain(q, k, v, **lkw)
    outp, lsep = t_flash.flash_lse_fwd_plain(qp, kp, vp, **lkw)
    torch.testing.assert_close(lsep, lse, rtol=1e-12, atol=1e-12)
    grads = t_flash.flash_lse_bwd_plain(q, k, v, out, lse, do, dlse, **lkw)
    gradsp = t_flash.flash_lse_bwd_plain(qp, kp, vp, outp, lsep, dop, dlse, **lkw)
    for g, gp in zip(grads, t_flash._true_width(pad, *gradsp)):
        torch.testing.assert_close(gp, g, rtol=1e-12, atol=1e-12)


def test_low_level_backward_wrappers_take_only_instance_widths():
    """flash_bwd_dq and its kin launch on inputs already at an instance's
    width; flash_bwd and flash_lse_bwd pad before them."""
    x = torch.empty((1, 4, 2, 48), device="meta")
    vec = torch.empty((1, 2, 4), device="meta")
    for fn in (t_flash.flash_bwd_dq, t_flash.flash_lse_bwd_dq):
        with pytest.raises(ValueError, match="instance's width"):
            fn(x, x, x, x, vec, vec, scale=0.1)


# ---------------------------------------------------------------------------
# chip_smoke.py's SASS expectations
# ---------------------------------------------------------------------------


def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def test_sass_expects_every_bf16_instance_at_seven_widths():
    """K1, K3 and the dq/dk-dv kernels (K2a, K2b, K2c, K4a, K4b) at each of
    the 7 instances; K5's forward, dq and dk/dv at its tool's 4."""
    cs = _chip_smoke()
    native, proto = len(t_flash.NATIVE_HEAD_DIMS), 4
    assert native == 7
    assert cs.FWD_BF16_KERNELS == 2 * native + proto
    assert cs.BWD_BF16_KERNELS == {"flash_dq_bf16_kernel": 2 * native + proto,
                                   "flash_dkv_bf16_kernel": 3 * native + proto}
