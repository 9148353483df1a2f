"""The port's ``flash_with_lse`` (K3 forward, K4a/K4b backward) against the
JAX package's.

* ``flash_with_lse`` on the CPU (the plain versions ``flash_lse_fwd_plain``
  and ``flash_lse_bwd_plain``) against the JAX ``flash_with_lse``, whose
  Pallas kernels ``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel`` run in
  interpret mode, on the same numpy q, k, v and cotangents (dO and a random
  lse cotangent). Layout (BH, T, hd), lse (BH, T, 1), as in JAX. Cases:
  causal, non-causal, a ``q_offset`` with a window that leaves rows dead in
  every tile, an offset inside the band, softcap. Tolerances are the JAX
  tests': forward 1e-5, gradients 2e-4, float32.
* Dead rows: JAX returns garbage ``out`` there by contract; the port returns
  0. Both give a finite lse <= -1e29, and the gradients agree everywhere.
* ``gradcheck`` of ``FlashLse`` in float64, both outputs.
* The CUDA wrappers' argument checks.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingpt_distributed_tpu.ops import flash_attention as j_flash
from mingpt_distributed_tpu_torch.ops import flash_attention as t_flash
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
DEAD_LSE = -1e29

# name: (BH, T, hd, causal, window, softcap, q_offset, JAX block)
CASES = {
    "causal": (4, 64, 16, True, None, None, 0, 32),
    "non_causal": (4, 64, 16, False, None, None, 0, 32),
    "offset_window_dead_rows": (4, 64, 16, True, 20, None, 64, 32),
    "offset_inside_band": (4, 64, 16, True, 40, None, 32, 32),
    "offset_no_window": (3, 64, 32, True, None, None, 16, 32),
    "softcap": (4, 64, 16, True, None, 5.0, 0, 32),
    "non_causal_softcap": (2, 64, 32, False, None, 3.0, 0, 64),
    "offset_window_softcap": (4, 64, 16, True, 24, 4.0, 40, 32),
}


def _inputs(bh, t, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, t, hd)).astype(np.float32)
            for _ in range(4)] + [rng.standard_normal((bh, t, 1)).astype(np.float32)]


def _live_rows(t, causal, window, q_offset):
    if not causal:
        return np.ones(t, bool)
    qg = np.arange(t)[:, None] + q_offset
    k = np.arange(t)[None, :]
    ok = qg >= k
    if window is not None:
        ok &= qg - k < window
    return ok.any(1)


def _jax(case, q, k, v, do, dlse):
    bh, t, hd, causal, window, cap, q_offset, block = CASES[case]
    scale = 1.0 / math.sqrt(hd)
    fn = lambda q, k, v: j_flash.flash_with_lse(  # noqa: E731
        q, k, v, scale, block, causal, window, cap, q_offset)
    (out, lse), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    grads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


def _torch(case, q, k, v, do, dlse):
    bh, t, hd, causal, window, cap, q_offset, _ = CASES[case]
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = t_flash.flash_with_lse(qt, kt, vt, 1.0 / math.sqrt(hd), causal,
                                      window, cap, q_offset)
    torch.autograd.backward((out, lse), (torch.from_numpy(do),
                                         torch.from_numpy(dlse)))
    return (out.detach().numpy(), lse.detach().numpy(),
            [x.grad.numpy() for x in (qt, kt, vt)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_with_lse_matches_jax(case):
    bh, t, hd, causal, window, cap, q_offset, _ = CASES[case]
    q, k, v, do, dlse = _inputs(bh, t, hd, seed=len(case))
    jout, jlse, jgrads = _jax(case, q, k, v, do, dlse)
    tout, tlse, tgrads = _torch(case, q, k, v, do, dlse)
    assert tout.shape == (bh, t, hd) and tlse.shape == (bh, t, 1)
    live = _live_rows(t, causal, window, q_offset)
    np.testing.assert_allclose(tout[:, live], jout[:, live], **FWD_TOL)
    np.testing.assert_allclose(tlse[:, live], jlse[:, live], **FWD_TOL)
    # the dead-row contract, in both packages
    assert np.isfinite(tlse).all() and np.isfinite(jlse).all()
    assert (tlse[:, ~live] <= DEAD_LSE).all() and (jlse[:, ~live] <= DEAD_LSE).all()
    assert (tout[:, ~live] == 0).all()
    for name, a, b in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD_TOL)
    if case == "offset_window_dead_rows":
        assert 0 < live.sum() < t
        assert (tgrads[0][:, ~live] == 0).all()  # dead rows: dq = 0


def test_the_lse_cotangent_reaches_dq_and_dk():
    q, k, v, do, dlse = _inputs(2, 48, 16, seed=3)
    _, _, with_dlse = _torch("offset_inside_band", q, k, v, do, dlse)
    _, _, without = _torch("offset_inside_band", q, k, v, do, np.zeros_like(dlse))
    assert not np.allclose(with_dlse[0], without[0], atol=1e-4)
    assert not np.allclose(with_dlse[1], without[1], atol=1e-4)
    np.testing.assert_allclose(with_dlse[2], without[2], atol=1e-6)  # dv: p^T dO


def test_model_layout_equals_the_jax_layout_with_gqa():
    rng = np.random.default_rng(5)
    b, t, h, kv, hd = 2, 40, 4, 2, 16
    q = torch.from_numpy(rng.standard_normal((b, t, h, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, t, kv, hd)).astype(np.float32))
            for _ in range(2))
    kw = dict(causal=True, window=12, softcap=None, q_offset=30)
    out, lse = t_flash.attention_with_lse(q, k, v, scale=0.25, **kw)
    rep = lambda x: x.repeat_interleave(h // kv, 2)  # noqa: E731
    to_bh = lambda x: x.permute(0, 2, 1, 3).reshape(b * h, t, hd)  # noqa: E731
    bout, blse = t_flash.flash_with_lse(to_bh(q), to_bh(rep(k)), to_bh(rep(v)),
                                        0.25, kw["causal"], kw["window"], None,
                                        kw["q_offset"])
    torch.testing.assert_close(to_bh(out), bout, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse.reshape(b * h, t, 1), blse, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0), (False, None, 0),
                                                    (True, 5, 9), (True, 3, 12)])
def test_flash_lse_gradcheck_float64(causal, window, q_offset):
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((1, 12, 2, 16), generator=g, dtype=torch.float64)
               .requires_grad_() for _ in range(3))

    def fn(q, k, v):
        return t_flash.attention_with_lse(q, k, v, scale=0.3, causal=causal,
                                          window=window, softcap=2.0,
                                          q_offset=q_offset)

    # fast mode: the Jacobian against random projections, not entry by entry
    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-5,
                                    fast_mode=True)


def test_cuda_wrappers_check_their_options_first():
    q = torch.zeros((1, 8, 1, 16))
    with pytest.raises(ValueError, match="q_offset"):
        t_flash.flash_lse_fwd(q, q, q, scale=1.0, q_offset=-1)
    with pytest.raises(ValueError, match="window"):
        t_flash.flash_lse_bwd(q, q, q, q, torch.zeros((1, 1, 8)), q, scale=1.0,
                              window=0)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_flash.flash_lse_fwd(meta, meta, meta, scale=1.0)
