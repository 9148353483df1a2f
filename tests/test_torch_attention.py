"""The PyTorch port's attention against the JAX package's.

* the oracle (ops/attention.py) against the JAX oracle: kv_offset, window,
  softcap, GQA, rope (float32, tolerance 1e-5);
* flash_fwd_plain, the plain version of the port's CUDA kernel, against the
  JAX flash kernel run in Pallas interpret mode as
  tests/test_flash_attention.py runs it: out through
  ``flash.causal_attention`` and out + lse through ``_flash_fwd_btd`` (the
  TPU kernel the CUDA one replaces), tolerance 1e-5, the JAX tests' own;
* the dispatch rules and the CPU-only/no-nvcc error paths.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingpt_distributed_tpu.ops import attention as j_attn
from mingpt_distributed_tpu.ops import flash_attention as j_flash
from mingpt_distributed_tpu_torch.ops import _build
from mingpt_distributed_tpu_torch.ops import attention as t_attn
from mingpt_distributed_tpu_torch.ops import flash_attention as t_flash
from mingpt_distributed_tpu_torch.utils.device import resolve_device

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(b, t, h, kv, hd, s=None, seed=0):
    rng = np.random.default_rng(seed)
    s = t if s is None else s
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# name: (T, S, H, KV, hd, kwargs)
ORACLE_CASES = {
    "causal": (16, 16, 4, 4, 16, {}),
    "gqa": (16, 16, 4, 2, 16, {}),
    "kv_offset_decode": (3, 16, 4, 2, 16, {"kv_offset": 9}),
    "window": (16, 16, 4, 4, 16, {"window": 5}),
    "softcap": (16, 16, 4, 4, 16, {"logit_softcap": 2.0}),
    "all": (4, 24, 4, 2, 16, {"kv_offset": 20, "window": 7,
                              "logit_softcap": 3.0}),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_oracle_matches_jax(case):
    t, s, h, kv, hd, kw = ORACLE_CASES[case]
    q, k, v = _qkv(2, t, h, kv, hd, s=s, seed=1)
    want = j_attn.causal_attention(*_j(q, k, v), **kw)
    got = t_attn.causal_attention(*_t(q, k, v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_oracle_tensor_kv_offset_matches_int():
    q, k, v = _qkv(1, 2, 2, 2, 8, s=10, seed=2)
    a = t_attn.causal_attention(*_t(q, k, v), kv_offset=5)
    b = t_attn.causal_attention(*_t(q, k, v), kv_offset=torch.tensor(5))
    assert torch.equal(a, b)


def test_repeat_kv_matches_jax():
    (k,) = _qkv(2, 5, 2, 2, 4, seed=3)[1:2]
    np.testing.assert_array_equal(
        t_attn.repeat_kv(torch.from_numpy(k), 3).numpy(),
        np.asarray(j_attn.repeat_kv(jnp.asarray(k), 3)))


def test_rope_matches_jax():
    (x,) = _qkv(2, 12, 4, 4, 16, seed=4)[:1]
    pos = np.arange(12, dtype=np.int32) + 5
    jc, js = j_attn.rope_tables(jnp.asarray(pos), 16, 10000.0)
    tc, ts = t_attn.rope_tables(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(
        t_attn.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(j_attn.apply_rope(jnp.asarray(x), jc, js)), **TOL)


# -- the plain version of the CUDA kernel vs the Pallas kernel --------------

# name: (T, H, KV, hd, window, softcap)
FLASH_CASES = {
    "causal": (64, 4, 4, 32, None, None),
    "gqa": (64, 4, 2, 32, None, None),
    "window_narrower_than_block": (64, 4, 4, 32, 16, None),
    "softcap": (64, 4, 4, 32, None, 5.0),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_out_matches_jax_flash(case):
    t, h, kv, hd, window, cap = FLASH_CASES[case]
    q, k, v = _qkv(2, t, h, kv, hd, seed=5)
    want = j_flash.causal_attention(*_j(q, k, v), window=window,
                                    logit_softcap=cap)
    got, _ = t_flash.flash_fwd_plain(*_t(q, k, v), scale=1 / math.sqrt(hd),
                                     window=window, softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window,cap", [(None, None), (16, None), (None, 5.0)])
def test_flash_plain_out_and_lse_match_tpu_kernel(window, cap):
    # _flash_fwd_btd is the function around _fwd_kernel_btd; block 32 at
    # T=64 makes the Pallas kernel stream two k blocks per q block
    b, t, h, hd = 2, 64, 4, 32
    q, k, v = _qkv(b, t, h, h, hd, seed=6)
    scale = 1 / math.sqrt(hd)
    flat = [jnp.asarray(a.reshape(b, t, h * hd)) for a in (q, k, v)]
    want_out, want_lse = j_flash._flash_fwd_btd(*flat, h, scale, 32,
                                                window=window, softcap=cap)
    got_out, got_lse = t_flash.flash_fwd_plain(*_t(q, k, v), scale=scale,
                                               window=window, softcap=cap)
    np.testing.assert_allclose(got_out.numpy().reshape(b, t, h * hd),
                               np.asarray(want_out), **TOL)
    assert got_lse.shape == (b, h, t)
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(want_lse)[..., 0], **TOL)


def test_flash_fwd_on_cpu_is_the_plain_version():
    q, k, v = _t(*_qkv(1, 10, 2, 1, 16, seed=7))
    n0 = t_flash.flash_fwd.launches
    out, lse = t_flash.flash_fwd(q, k, v, scale=0.25, window=3)
    ref, ref_lse = t_flash.flash_fwd_plain(q, k, v, scale=0.25, window=3)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert t_flash.flash_fwd.launches == n0  # no kernel ran


# -- dispatch -----------------------------------------------------------------

# name: (T, S, kwargs, takes the kernel path)
DISPATCH_CASES = {
    "self_attention": (8, 8, {}, True),
    "window_softcap": (8, 8, {"window": 3, "logit_softcap": 2.0}, True),
    "dropout_rate_zero_in_training": (8, 8, {"deterministic": False}, True),
    "dropout_active": (8, 8, {"deterministic": False, "attn_pdrop": 0.1,
                              "generator": torch.Generator()}, False),
    "decode_lengths_differ": (1, 8, {"kv_offset": 7}, False),
    "nonzero_offset": (8, 8, {"kv_offset": 2}, False),
    "tensor_offset": (8, 8, {"kv_offset": torch.tensor(0)}, False),
}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_flash_dispatch_rules(case, monkeypatch):
    t, s, kw, kernel_path = DISPATCH_CASES[case]
    calls = []

    def fake_kernel(q, k, v, **_):
        calls.append("kernel")
        return torch.zeros_like(q), None

    def fake_oracle(q, k, v, **_):
        calls.append("oracle")
        return torch.zeros_like(q)

    monkeypatch.setattr(t_flash, "flash_fwd", fake_kernel)
    monkeypatch.setattr(t_flash.attn_ops, "causal_attention", fake_oracle)
    q, k, v = _t(*_qkv(1, t, 2, 2, 16, s=s, seed=8))
    t_flash.causal_attention(q, k, v, **kw)
    assert calls == ["kernel" if kernel_path else "oracle"]


def test_flash_dispatch_on_cpu_matches_oracle():
    q, k, v = _t(*_qkv(2, 16, 4, 2, 16, seed=9))
    got = t_flash.causal_attention(q, k, v, window=6, logit_softcap=4.0)
    want = t_attn.causal_attention(q, k, v, window=6, logit_softcap=4.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# -- no silent CPU fallback ------------------------------------------------------


def test_cuda_request_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_flash_fwd_rejects_other_devices():
    q = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_flash.flash_fwd(q, q, q, scale=0.25)


def test_kernel_build_without_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_kernel_sources_are_in_the_checkout():
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
        assert _build.library_path(name).parent == _build.BUILD_DIR


# name: (make q/k/v on the CPU, error): what the CUDA wrapper refuses
def _bf16(shape=(1, 8, 2, 16)):
    return torch.zeros(shape, dtype=torch.bfloat16)


WRAPPER_REFUSALS = {
    "requires_grad": (lambda: (_bf16().requires_grad_(), _bf16(), _bf16()),
                      NotImplementedError),
    "float16": (lambda: (_bf16().half(), _bf16().half(), _bf16().half()),
                TypeError),
    "mixed_dtypes": (lambda: (_bf16(), _bf16().float(), _bf16()), TypeError),
    "head_dim_48": (lambda: (_bf16((1, 8, 2, 48)),) * 3, ValueError),
    "kv_heads_not_dividing": (lambda: (_bf16((1, 8, 3, 16)), _bf16(), _bf16()),
                              ValueError),
    "kv_length_differs": (lambda: (_bf16(), _bf16((1, 9, 2, 16)),
                                   _bf16((1, 9, 2, 16))), ValueError),
    "strided_head_dim": (lambda: (_bf16((1, 8, 2, 32))[..., ::2],) * 3,
                         ValueError),
    "bf16_rows_not_16_byte_aligned": (
        lambda: (torch.zeros(1 * 8 * 2 * 16 + 1, dtype=torch.bfloat16)[1:]
                 .view(1, 8, 2, 16),) * 3, ValueError),
}


@pytest.mark.parametrize("case", sorted(WRAPPER_REFUSALS))
def test_cuda_wrapper_checks_refuse_what_the_kernel_does_not_take(case):
    make, error = WRAPPER_REFUSALS[case]
    with pytest.raises(error):
        t_flash._check_cuda_inputs(*make())


def test_cuda_wrapper_checks_accept_model_shaped_inputs():
    # q/k/v as the model makes them: views of one dense (B, T, H*hd) output
    x = torch.zeros((2, 8, 3 * 4 * 16), dtype=torch.bfloat16)
    q, k, v = (x[..., i * 64:(i + 1) * 64].reshape(2, 8, 4, 16).contiguous()
               for i in range(3))
    t_flash._check_cuda_inputs(q, k[:, :, :2].contiguous(), v[:, :, :2].contiguous())
