"""The PyTorch port's flash-attention backward against the JAX package's.

* ``flash_bwd_plain``, the plain version of the port's two backward CUDA
  kernels, against ``_flash_bwd_btd`` (the function around the TPU kernels
  ``_dq_kernel_btd`` and ``_dkv_kernel_btd``) run in Pallas interpret mode,
  on the same q, k, v, out, lse and dO. The JAX lse is (B, H, T, 1), the
  port's (B, H, T). JAX repeats k/v over the GQA group before its kernels,
  so its dk/dv are summed over the group here. h=4, hd=32 (lane pack 4 on
  the JAX side). Tolerance 2e-4, the JAX tests' own
  (tests/test_flash_attention.py).
* Gradients through the port's ``causal_attention`` (the autograd Function)
  against ``jax.grad`` through the JAX ``causal_attention``.
* ``torch.autograd.gradcheck`` of the Function in float64 on the CPU.
* The CUDA wrapper's argument checks, which run before any kernel.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingpt_distributed_tpu.ops import flash_attention as j_flash
from mingpt_distributed_tpu_torch.ops import attention as t_attn
from mingpt_distributed_tpu_torch.ops import flash_attention as t_flash

TOL = dict(rtol=2e-4, atol=2e-4)

# name: (T, H, KV, hd, window, softcap, JAX block)
BWD_CASES = {
    "causal": (64, 4, 4, 32, None, None, 32),
    "gqa": (64, 4, 2, 32, None, None, 32),
    "window_narrower_than_block": (64, 4, 4, 32, 16, None, 32),
    "softcap": (64, 4, 4, 32, None, 5.0, 32),
    "window_softcap": (64, 4, 4, 32, 24, 5.0, 32),
    "t40_block40": (40, 4, 4, 32, None, None, 40),
}


def _inputs(b, t, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    do = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_plain_matches_tpu_kernels(case):
    t, h, kv, hd, window, cap, block = BWD_CASES[case]
    b = 2
    q, k, v, do = _inputs(b, t, h, kv, hd, seed=11)
    scale = 1 / math.sqrt(hd)
    rep = h // kv
    kr, vr = (np.repeat(a, rep, axis=2) for a in (k, v))
    flat = lambda a: jnp.asarray(a.reshape(b, t, h * hd))  # noqa: E731
    out, lse = j_flash._flash_fwd_btd(flat(q), flat(kr), flat(vr), h, scale,
                                      block, window=window, softcap=cap)
    jdq, jdk, jdv = j_flash._flash_bwd_btd(
        flat(q), flat(kr), flat(vr), out, lse, flat(do), h, scale, block,
        window=window, softcap=cap)
    out_t = torch.from_numpy(np.array(out).reshape(b, t, h, hd))
    lse_t = torch.from_numpy(np.array(lse)[..., 0])
    dq, dk, dv = t_flash.flash_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), out_t, lse_t,
        torch.from_numpy(do), scale=scale, window=window, softcap=cap)
    group_sum = lambda a: np.asarray(a).reshape(b, t, kv, rep, hd).sum(3)  # noqa: E731
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq).reshape(b, t, h, hd),
                               **TOL)
    np.testing.assert_allclose(dk.numpy(), group_sum(jdk), **TOL)
    np.testing.assert_allclose(dv.numpy(), group_sum(jdv), **TOL)


# name: (T, H, KV, hd, kwargs)
GRAD_CASES = {
    "causal": (64, 4, 4, 32, {}),
    "gqa_window_softcap": (48, 4, 2, 16, {"window": 10, "logit_softcap": 4.0}),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_causal_attention_grads_match_jax(case):
    t, h, kv, hd, kw = GRAD_CASES[case]
    q, k, v, w = _inputs(2, t, h, kv, hd, seed=12)

    def j_loss(q, k, v):
        return jnp.sum(j_flash.causal_attention(q, k, v, **kw) * w)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (t_flash.causal_attention(qt, kt, vt, **kw) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_flash_attention_function_gradcheck_float64():
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((1, 6, 2, 4), (1, 6, 1, 4), (1, 6, 1, 4)))
    for window, cap in ((None, None), (3, 2.0)):
        assert torch.autograd.gradcheck(
            lambda q, k, v: t_flash.FlashAttention.apply(q, k, v, 0.5, window, cap),
            (q, k, v))


def test_flash_path_grads_match_oracle_on_the_cpu():
    # on CPU tensors the Function's backward is flash_bwd_plain
    q, k, v, _ = _inputs(1, 20, 4, 2, 16, seed=14)
    grads = []
    for fn in (t_flash.causal_attention, t_attn.causal_attention):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        fn(*ts, window=7).square().sum().backward()
        grads.append([x.grad for x in ts])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_flash_bwd_on_cpu_is_the_plain_version():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 9, 2, 1, 16, seed=15))
    out, lse = t_flash.flash_fwd_plain(q, k, v, scale=0.25)
    n0 = (t_flash.flash_bwd.dq_launches, t_flash.flash_bwd.dkv_launches)
    got = t_flash.flash_bwd(q, k, v, out, lse, do, scale=0.25)
    want = t_flash.flash_bwd_plain(q, k, v, out, lse, do, scale=0.25)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (t_flash.flash_bwd.dq_launches, t_flash.flash_bwd.dkv_launches) == n0


def test_flash_bwd_rejects_other_devices():
    q = torch.empty((1, 4, 2, 16), device="meta")
    lse = torch.empty((1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_flash.flash_bwd(q, q, q, q, lse, q, scale=0.25)


# -- the CUDA wrapper's checks (they run before any kernel) ------------------

def _bf16(shape=(1, 8, 2, 16)):
    return torch.zeros(shape, dtype=torch.bfloat16)


# name: (make out, lse, do for q = _bf16())
BWD_REFUSALS = {
    "do_dtype": lambda: (_bf16(), torch.zeros(1, 2, 8), _bf16().float()),
    "do_shape": lambda: (_bf16(), torch.zeros(1, 2, 8), _bf16((1, 8, 2, 32))),
    "out_shape": lambda: (_bf16((1, 7, 2, 16)), torch.zeros(1, 2, 8), _bf16()),
    "lse_layout_b_h_t_1": lambda: (_bf16(), torch.zeros(1, 2, 8, 1), _bf16()),
    "lse_dtype": lambda: (_bf16(), torch.zeros(1, 2, 8, dtype=torch.bfloat16),
                          _bf16()),
}


@pytest.mark.parametrize("case", sorted(BWD_REFUSALS))
def test_flash_bwd_checks_refuse_bad_arguments(case):
    out, lse, do = BWD_REFUSALS[case]()
    with pytest.raises(ValueError):
        t_flash._check_bwd_inputs(_bf16(), out, lse, do)


def test_flash_bwd_checks_accept_matching_arguments():
    t_flash._check_bwd_inputs(_bf16(), _bf16(), torch.zeros(1, 2, 8), _bf16())


def test_stride_zero_gradient_is_made_dense():
    # the gradient of out.sum() reaches the backward expanded, stride 0
    do = torch.ones((), dtype=torch.bfloat16).expand(1, 8, 2, 16)
    assert do.stride() == (0, 0, 0, 0)
    dense = t_flash._dense(do)
    assert dense.is_contiguous() and dense.stride() == (256, 32, 16, 1)
    assert torch.equal(dense, do) and dense.data_ptr() % 16 == 0
    strided = _bf16((1, 8, 2, 32))[..., ::2]
    assert t_flash._dense(strided).is_contiguous()
    dense_in = _bf16()
    assert t_flash._dense(dense_in) is dense_in


def test_wrappers_refuse_to_run_inside_a_graph():
    # a kernel wrapper called with grad enabled on inputs that need a
    # gradient would silently drop it: it must go through FlashAttention
    q = _bf16().requires_grad_()
    with pytest.raises(RuntimeError, match="^flash_bwd: .*FlashAttention"):
        t_flash._check_cuda_inputs(q, _bf16(), _bf16(), "flash_bwd")
    with torch.no_grad():
        t_flash._check_cuda_inputs(q, _bf16(), _bf16(), "flash_bwd")


@pytest.mark.parametrize("name", ["dq_drops_delta", "dkv_skips_last_q_tile",
                                  "dkv_offset_band_skips_last_q_tile",
                                  "fwd_dead_rows_unwritten",
                                  "fwd_releases_stage_early",
                                  "bwd_releases_stage_early",
                                  "fused_dq_skips_diagonal_cell",
                                  "fused_releases_kv_early",
                                  "prep_drops_last_element",
                                  "nh_fwd_drops_softcap",
                                  "exp_chain_one_rep_short",
                                  "ring_skips_hop_fold"])
def test_planted_fault_patches_still_apply_to_the_kernel_source(name):
    """tools/plant_faults.py rewrites a kernel (or the ring's) source by
    text; each fault's anchors must appear in it as often as the tool
    expects (once per dtype's kernel where both carry it), or the tool
    refuses to run on the card."""
    from mingpt_distributed_tpu_torch.tools import plant_faults

    _, source, edits = plant_faults.FAULTS[name]
    src = (plant_faults.ROOT / plant_faults.PACKAGE / source).read_text()
    patched = plant_faults.patch(src, edits)
    for old, new, _ in edits:
        assert old not in patched and new in patched


@pytest.mark.parametrize("name", ["final", "no_atomics", "no_dq", "own", "own_f4"])
def test_k2c_design_variants_still_apply_to_the_kernel_source(name):
    """tools/k2c_variants.py times copies of the package with one edit to
    K2c's source each; every anchor must appear in it as often as the tool
    expects, or the tool refuses to run on the card."""
    from mingpt_distributed_tpu_torch.tools import k2c_variants, plant_faults

    src = (plant_faults.ROOT / plant_faults.PACKAGE / k2c_variants.SOURCE).read_text()
    edits = k2c_variants.VARIANTS[name]
    patched = plant_faults.patch(src, edits)
    assert (patched == src) == (not edits)
    for old, new, _ in edits:
        assert new in patched
