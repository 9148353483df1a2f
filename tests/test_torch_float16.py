"""float16 through the port's flash path, against the JAX package.

The JAX flash kernels run float16 as they run bfloat16: P and dS rounded to
the input dtype before their products, float32 accumulation, lse and delta
in float32. The port's kernels have float16 instances of their own
(``csrc/flash_fwd_f16.cu``, ``csrc/flash_bwd_f16.cu``: dtype code 2); on
the CPU the wrappers run the kernels' plain versions, which keep P and dS
in float32. These tests hold the port to the JAX package (Pallas in
interpret mode) on the same numpy inputs, at float16:

* ``causal_attention``'s forward and gradients at hd 64 with GQA (4 query
  heads over 2 KV heads) and at hd 48, a width the kernels run zero-padded
  to 64: ``rtol = atol = 2e-3``. The JAX kernels' rounding of P and dS
  moves outputs of magnitude up to ~5 by about one float16 ulp (2^-11
  relative; 9.8e-4 to 3.9e-3 absolute measured), under half the tolerance;
* ``flash_with_lse`` hops (causal with a q offset and a window, and not
  causal) with an lse cotangent: out and gradients as above, the float32
  lse within 1e-5 (the float32 tests' tolerance; 4.8e-7 measured);
* a 2-layer GPT at ``dtype=float16``: the loss within 1e-5 relative
  (3e-6 measured), every float32 parameter's gradient within rtol 2e-3 and
  atol 5e-4 (activations' gradients round to float16 at other places in
  the two packages: 1.7e-4 beyond rtol measured, on the attention output
  bias), the clipped norm within 2e-4, and one AdamW step: where the JAX
  gradient is above 1e-3 (twice the gradient tolerance, so the two signs
  agree) the new weights within 1e-6; below it Adam's first step moves a
  weight by lr times the sign of a gradient within tolerance of 0;
* greedy sliding-window generation past the window, token for token;
* the dtype codes of the wrapper against the C sources' dispatch, and the
  libraries each dtype loads.
"""

import math
import re

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
from mingpt_distributed_tpu_torch.ops import _build
from mingpt_distributed_tpu_torch.ops import flash_attention as t_flash
from mingpt_distributed_tpu_torch.training import optimizer as t_opt
from mingpt_distributed_tpu_torch.training import trainer as t_trainer
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

F16_TOL = dict(rtol=2e-3, atol=2e-3)
LSE_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_REL_TOL = 1e-5
GRAD_TOL = dict(rtol=2e-3, atol=5e-4)
ADAM_GRAD_MIN = 1e-3
ADAM_ATOL = 1e-6


def _f16(rng, *shape):
    return rng.standard_normal(shape).astype(np.float16)


def _close(got: torch.Tensor, want, tol, name=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want).astype(np.float32), **tol, err_msg=name)


# ---------------------------------------------------------------------------
# causal_attention and flash_with_lse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h, kv, hd", [(4, 2, 64), (2, 1, 48)], ids=["hd64_gqa", "hd48_padded"])
def test_causal_attention_float16_matches_jax(h, kv, hd):
    b, t = 1, 128
    rng = np.random.default_rng(hd)
    q, k, v = _f16(rng, b, t, h, hd), _f16(rng, b, t, kv, hd), _f16(rng, b, t, kv, hd)
    do = _f16(rng, b, t, h, hd)
    out, vjp = jax.vjp(lambda q, k, v: j_flash.causal_attention(q, k, v),
                       *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    assert out.dtype == jnp.float16 and all(g.dtype == jnp.float16 for g in want)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = t_flash.causal_attention(qt, kt, vt)
    got.backward(torch.from_numpy(do))
    assert got.dtype == torch.float16
    _close(got, out, F16_TOL, "out")
    for name, g, w in zip("qkv", (qt.grad, kt.grad, vt.grad), want):
        assert g.dtype == torch.float16
        _close(g, w, F16_TOL, f"d{name}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal_offset", "non_causal"])
def test_flash_with_lse_hop_float16_matches_jax(causal):
    """A ring hop (BH 2, T 64, hd 64): causal with q_offset 16 and a window
    of 40, or not causal; the gradients with an lse cotangent."""
    bh, t, block, hd = 2, 64, 32, 64
    window, q_offset = (40, 16) if causal else (None, 0)
    scale = 1.0 / math.sqrt(hd)
    rng = np.random.default_rng(7)
    q, k, v, do = (_f16(rng, bh, t, hd) for _ in range(4))
    dlse = rng.standard_normal((bh, t, 1)).astype(np.float32)
    fn = lambda q, k, v: j_flash.flash_with_lse(  # noqa: E731
        q, k, v, scale, block, causal, window, None, q_offset)
    (out, lse), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got, got_lse = t_flash.flash_with_lse(qt, kt, vt, scale, causal, window, None, q_offset)
    torch.autograd.backward((got, got_lse), (torch.from_numpy(do), torch.from_numpy(dlse)))
    assert got.dtype == torch.float16 and got_lse.dtype == torch.float32
    _close(got, out, F16_TOL, "out")
    _close(got_lse, lse, LSE_TOL, "lse")
    for name, g, w in zip("qkv", (qt.grad, kt.grad, vt.grad), want):
        _close(g, w, F16_TOL, f"d{name}")


# ---------------------------------------------------------------------------
# a 2-layer GPT at float16: loss, gradients, one AdamW step; generation
# ---------------------------------------------------------------------------

SMALL = dict(n_layer=2, n_embd=128, n_head=4, n_kv_head=2, vocab_size=96, block_size=32,
             dtype="float16", embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0,
             attention="flash")


def _tree(cfg, seed, noise):
    """JAX init weights plus ``noise`` of Gaussian noise, float32."""
    tree = jax.device_get(j_gpt.init(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + noise * rng.standard_normal(a.shape)).astype(np.float32),
                        tree), rng


def test_gpt_float16_loss_gradients_and_adamw_step_match_jax():
    jcfg, tcfg = JConfig.make(**SMALL), GPTConfig.make(**SMALL)
    tree, rng = _tree(jcfg, 5, 0.02)
    tok = rng.integers(0, 96, (2, 33)).astype(np.int32)
    x, y = tok[:, :-1], tok[:, 1:]
    jparams = jax.tree.map(jnp.asarray, tree)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: j_gpt.forward(
        p, jnp.asarray(x), jcfg, targets=jnp.asarray(y), return_logits=False)[1]))(jparams)
    xt, yt = torch.from_numpy(x).long(), torch.from_numpy(y).long()
    params = t_trainer.trainable(convert.params_from_numpy(tree, tcfg, "cpu"))
    _, loss = t_gpt.forward(params, xt, tcfg, targets=yt, return_logits=False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_REL_TOL)
    want = convert.flatten(jax.device_get(jgrads))
    got = {name: p.grad.numpy() for name, p in convert.flatten(params).items()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **GRAD_TOL, err_msg=name)

    # one AdamW step (clip at 1.0): the port's train step against the JAX
    # optimizer on the JAX gradients, which is what the JAX train step
    # applies to them
    jopt = j_opt.make_optimizer(JOptConfig(learning_rate=1e-3), 1.0)
    jnew = jax.jit(lambda g, p: optax.apply_updates(p, jopt.update(g, jopt.init(p), p)[0]))(
        jgrads, jparams)
    jnew = convert.flatten(jax.device_get(jnew))
    params = t_trainer.trainable(convert.params_from_numpy(tree, tcfg, "cpu"))
    state = t_trainer.TrainState(params, t_opt.make_optimizer(
        OptimizerConfig.make(learning_rate=1e-3), params, 1.0))
    tm = t_trainer.make_train_step(tcfg)(state, (xt, yt))
    np.testing.assert_allclose(tm["loss"].item(), float(jloss), rtol=LOSS_REL_TOL)
    np.testing.assert_allclose(tm["grad_norm"].item(), float(optax.global_norm(jgrads)),
                               rtol=2e-4)
    new = convert.flatten(convert.params_to_numpy(state.params))
    steady = 0
    for name in jnew:
        mask = np.abs(want[name]) > ADAM_GRAD_MIN
        steady += int(mask.sum())
        np.testing.assert_allclose(new[name][mask], jnew[name][mask], rtol=0,
                                   atol=ADAM_ATOL, err_msg=name)
    assert steady > 0.5 * sum(a.size for a in want.values())


def test_sliding_window_generation_float16_matches_jax():
    """Greedy decoding past the 16-position window (12 + 8 tokens), where
    both packages re-run the flash forward over the window each token."""
    kw = dict(SMALL, block_size=16)
    jcfg, tcfg = JConfig.make(**kw), GPTConfig.make(**kw)
    # larger weights than init: sharper logits, so greedy paths are not ties
    tree, rng = _tree(jcfg, 3, 0.1)
    prompt = rng.integers(0, 96, (2, 12)).astype(np.int32)
    want = np.asarray(j_gen.generate(tree, jcfg, prompt, 8))
    got = t_gen.generate(convert.params_from_numpy(tree, tcfg, "cpu"), tcfg, prompt, 8,
                         device="cpu")
    assert got.shape == (2, 20)
    np.testing.assert_array_equal(np.asarray(got), want)


# ---------------------------------------------------------------------------
# the dtype codes and the libraries
# ---------------------------------------------------------------------------


def test_wrapper_dtype_codes_match_the_c_dispatch():
    """The wrapper's codes are the ones each library's dispatch takes: 0
    and 1 in flash_fwd.cu and flash_bwd.cu, 2 in their float16 builds (the
    same sources with FLASH_F16 defined); every dispatch refuses the rest."""
    assert t_flash._DTYPE_CODES == {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    for base in ("flash_fwd", "flash_bwd"):
        src = (_build.CSRC / f"{base}.cu").read_text()
        m = re.search(r"#ifdef FLASH_F16\nusing Elem16 = __half;\nconstexpr int kCode16 = (\d);"
                      r"\nconstexpr bool kWithF32 = false;\n#else\nusing Elem16 = __nv_bfloat16;"
                      r"\nconstexpr int kCode16 = (\d);\nconstexpr bool kWithF32 = true;", src)
        assert m, base
        assert int(m.group(1)) == t_flash._DTYPE_CODES[torch.float16]
        assert int(m.group(2)) == t_flash._DTYPE_CODES[torch.bfloat16]
        # float32 is read as code 0, inside kWithF32, and nowhere is a
        # 16-bit kernel chosen by "not float32"
        assert len(re.findall(r"if \(dtype == 0\)", src)) == (1 if base == "flash_fwd" else 3)
        assert "dtype == 1" not in src and "dtype != 0" not in src
        f16 = (_build.CSRC / f"{base}_f16.cu").read_text()
        assert re.search(rf'#define FLASH_F16 1\n#include "{base}.cu"\n$', f16)
        assert _build.included_sources(f"{base}_f16") == (base,)
        assert {base, f"{base}_f16"} <= set(_build.SOURCES)
    fwd = (_build.CSRC / "flash_fwd.cu").read_text()
    body = fwd[fwd.index("cudaError_t launch_hd("):]
    body = body[:body.index("\n}\n")]
    assert "kCode16" in body and body.rstrip().endswith("return cudaErrorInvalidValue;")
    bwd = (_build.CSRC / "flash_bwd.cu").read_text()
    for fn in ("cudaError_t launch_dq(", "cudaError_t launch_dkv(", 'int flash_bwd_prep('):
        body = bwd[bwd.index(fn):]
        body = body[:body.index("\n}\n")]
        assert re.search(r"if \(dtype [!=]= kCode16\)", body), fn
        assert "cudaErrorInvalidValue" in body, fn


@pytest.mark.parametrize("dtype, lib", [(torch.float32, "flash_bwd"),
                                        (torch.bfloat16, "flash_bwd"),
                                        (torch.float16, "flash_bwd_f16")])
def test_each_dtype_loads_its_library_and_passes_its_code(monkeypatch, dtype, lib):
    loaded = []

    class Entry:
        argtypes = None

    class Lib:
        def __getattr__(self, name):
            e = Entry()
            setattr(self, name, e)
            return e

    monkeypatch.setattr(_build, "load", lambda name: loaded.append(name) or Lib())
    got = t_flash._kernel("flash_bwd", dtype)
    assert loaded == [lib] and t_flash.library_name("flash_bwd", dtype) == lib
    # the float16 library has no K5 entry points
    assert ("nh_bwd_dq" in vars(got)) == (dtype != torch.float16)
    q = torch.zeros((1, 8, 2, 16), dtype=dtype)
    assert t_flash._tail(q, 0.25, None, None, 0)[-2] == t_flash._DTYPE_CODES[dtype]


def test_float16_library_hash_follows_the_source_it_includes(monkeypatch, tmp_path):
    """An edit to flash_fwd.cu rebuilds its float16 build as well."""
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("flash_fwd_f16")
    (tmp_path / "flash_fwd.cu").write_text((tmp_path / "flash_fwd.cu").read_text() + "\n")
    assert _build.library_path("flash_fwd_f16") != before


@pytest.mark.parametrize("fn", ["nh_bwd_dq", "nh_bwd_dkv"])
def test_the_prototype_kernels_refuse_float16(fn):
    """K5 keeps its JAX tool's dtypes: a float16 call raises before any
    library is loaded, and the wrapper's checks refuse it by name."""
    x = torch.zeros((1, 8, 2, 16), dtype=torch.float16)
    vec = torch.zeros((1, 2, 8))
    with pytest.raises(TypeError, match="no float16 instance"):
        t_flash._launch_bwd(fn, (), x, x, x, x, vec, vec, 0.25, None, None)
    with pytest.raises(TypeError, match="K5"):
        t_flash._check_cuda_inputs(x, x, x, "nh_bwd")


def test_h100_peak_takes_float16():
    from mingpt_distributed_tpu_torch.telemetry import peaks

    assert peaks.peak_flops("NVIDIA H100 80GB HBM3", "float16") == 989e12
