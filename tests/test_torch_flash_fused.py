"""The PyTorch port's fused flash-attention backward (K2c,
``FLASH_FUSED_BWD=1``) against the JAX package's.

* Gradients through the port's ``causal_attention`` with FLASH_FUSED_BWD=1
  against ``jax.grad`` through the JAX ``causal_attention`` with
  FLASH_FUSED_BWD=1, FLASH_BLOCK=128 and FLASH_LAYOUT=auto at T=256: the
  settings of tests/test_flash_attention.py's fused-backward parity test,
  under which the JAX fused kernel ``_dqkv_kernel_btd`` runs in Pallas
  interpret mode over two k tiles, so its cross-tile dq accumulation runs.
  On the CPU the port's backward is ``flash_bwd_plain``, the plain version
  of K2c. float32: tolerance 2e-4, the JAX test's. bfloat16 (both sides at
  bf16): within one bf16 step at the largest gradient, the resolution the
  JAX kernel's own bf16-vs-fp32 gap sets (below).
* ``flash_bwd_prep``'s plain version (what the prep kernel computes: delta
  and the lse cotangent folded in, K2c's dq zeroed) against the JAX
  package's delta expression, and the prep wrapper's argument checks.
* The switch is read at each call, and both settings give
  ``flash_bwd_plain``'s result on the CPU without a launch.
* ``_ENTRIES`` names the fused, the prep and the prototype's entry points,
  and every entry's ctypes argument list matches its C signature in
  ``ops/csrc`` (no compiler here can hold them together).
* The CUDA wrappers' argument checks raise before any launch.
"""

import ctypes
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingpt_distributed_tpu.ops import flash_attention as j_flash
from mingpt_distributed_tpu_torch.ops import flash_attention as t_flash

TOL = dict(rtol=2e-4, atol=2e-4)
# bfloat16: the port's plain version works in float32 from the bf16 inputs
# and rounds dq, dk and dv to bf16; the JAX fused kernel rounds P and dS to
# bf16 before its products. The JAX kernel's own bf16 gradients differ from
# its float32 ones on the same bf16 inputs by up to 2^-7.7 of the largest
# gradient (max |g| 2.2-6.0, max |diff| 0.0086-0.0253; mean |diff| / mean
# |g| 2.2e-3-2.9e-3), so two bf16 paths may sit one bf16 step apart at the
# top of the range: max |diff| <= 2^-7 max |g|, mean |diff| / mean |g| <=
# 1e-2 (read: 0.0156-0.0313 and 1.6e-3-2.5e-3).
BF16_TOL_X = 2.0 ** -7
BF16_REL_TOL = 1e-2

# name: (H, KV, causal_attention keyword arguments)
FUSED_CASES = {
    "causal": (4, 4, {}),
    "window40_softcap30": (4, 4, {"window": 40, "logit_softcap": 30.0}),
    "gqa_h4_kv2": (4, 2, {}),
}


def _inputs(b, t, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, hd)).astype(np.float32),
            rng.standard_normal((b, t, kv, hd)).astype(np.float32),
            rng.standard_normal((b, t, kv, hd)).astype(np.float32),
            rng.standard_normal((b, t, h, hd)).astype(np.float32))


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_backward_grads_match_the_jax_fused_kernel(case, monkeypatch):
    h, kv, kw = FUSED_CASES[case]
    monkeypatch.setenv("FLASH_FUSED_BWD", "1")
    monkeypatch.setenv("FLASH_BLOCK", "128")
    monkeypatch.setenv("FLASH_LAYOUT", "auto")
    q, k, v, w = _inputs(2, 256, h, kv, 32, seed=41)

    def j_loss(q, k, v):
        return jnp.sum(j_flash.causal_attention(q, k, v, **kw) * w)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (t_flash.causal_attention(qt, kt, vt, **kw) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_backward_bf16_grads_match_the_jax_fused_kernel(case, monkeypatch):
    # the settings above, both sides at bf16 on the same bf16 inputs
    h, kv, kw = FUSED_CASES[case]
    monkeypatch.setenv("FLASH_FUSED_BWD", "1")
    monkeypatch.setenv("FLASH_BLOCK", "128")
    monkeypatch.setenv("FLASH_LAYOUT", "auto")
    q, k, v, w = (jnp.asarray(a).astype(jnp.bfloat16)
                  for a in _inputs(2, 256, h, kv, 32, seed=41))

    def j_loss(q, k, v):
        return jnp.sum((j_flash.causal_attention(q, k, v, **kw) * w).astype(jnp.float32))

    want = jax.grad(j_loss, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt, wt = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                      for a in (q, k, v, w))
    leaves = [x.requires_grad_() for x in (qt, kt, vt)]
    (t_flash.causal_attention(*leaves, **kw).float() * wt.float()).sum().backward()
    for x, ref in zip(leaves, want):
        got, ref = x.grad.float().numpy(), np.asarray(ref.astype(jnp.float32))
        assert x.grad.dtype == torch.bfloat16
        diff = np.abs(got - ref)
        assert diff.max() <= BF16_TOL_X * np.abs(ref).max()
        assert diff.mean() / np.abs(ref).mean() <= BF16_REL_TOL


def test_fused_switch_is_read_at_each_call(monkeypatch):
    for value, on in (("1", True), ("0", False), ("true", False), ("1", True)):
        monkeypatch.setenv("FLASH_FUSED_BWD", value)
        assert t_flash.fused_bwd_enabled() is on
    monkeypatch.delenv("FLASH_FUSED_BWD")
    assert not t_flash.fused_bwd_enabled()

    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 70, 4, 2, 16, seed=42))
    kw = dict(scale=0.25, window=30, softcap=5.0)
    out, lse = t_flash.flash_fwd_plain(q, k, v, **kw)
    want = t_flash.flash_bwd_plain(q, k, v, out, lse, do, **kw)
    counters = ("dq_launches", "dkv_launches", "fused_launches")
    n0 = [getattr(t_flash.flash_bwd, c) for c in counters]
    for value in ("1", "0"):
        monkeypatch.setenv("FLASH_FUSED_BWD", value)
        got = t_flash.flash_bwd(q, k, v, out, lse, do, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = t_flash.flash_bwd_fused(q, k, v, out, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [getattr(t_flash.flash_bwd, c) for c in counters] == n0


def test_entries_name_the_fused_and_prototype_entry_points():
    assert {"flash_fwd", "flash_lse_fwd", "nh_fwd"} == set(t_flash._ENTRIES["flash_fwd"])
    assert {"flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused", "flash_lse_bwd_dq",
            "flash_lse_bwd_dkv", "nh_bwd_dq", "nh_bwd_dkv", "flash_bwd_prep"} == set(
                t_flash._ENTRIES["flash_bwd"])
    # nine pointers: q, k, v, do, lse, delta, dq (float32), dk, dv
    fused = t_flash._ENTRIES["flash_bwd"]["flash_bwd_fused"]
    assert fused[:9] == [ctypes.c_void_p] * 9 and fused[9] == ctypes.c_int


_CSRC = Path(t_flash.__file__).resolve().parent / "csrc"


def _ctype_name(t) -> str:
    return {ctypes.c_void_p: "void*", ctypes.c_int: "int",
            ctypes.c_longlong: "long long", ctypes.c_float: "float"}[t]


def _c_signature(source: str, entry: str):
    text = (_CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert m, f"no extern \"C\" {entry} in {source}.cu"
    types = []
    for param in m.group(1).split(","):
        words = param.replace("*", " * ").split()[:-1]  # drop the name
        types.append(" ".join(w for w in words if w != "const").replace(" *", "*"))
    return types


@pytest.mark.parametrize("entry", sorted(
    (lib, fn) for lib, fns in t_flash._ENTRIES.items() for fn in fns))
def test_entry_argument_types_match_the_c_signature(entry):
    lib, fn = entry
    assert _c_signature(lib, fn) == [_ctype_name(t) for t in t_flash._ENTRIES[lib][fn]]


# -- the CUDA wrappers' checks (they run before any kernel) ------------------

def _meta(shape=(1, 8, 2, 16)):
    return torch.empty(shape, device="meta")


def _refuse_meta_fused():
    lse = torch.empty((1, 2, 8), device="meta")
    t_flash.flash_bwd_fused(_meta(), _meta(), _meta(), _meta(), lse, _meta(),
                            scale=0.25)


def _refuse_dq_buffer(dtype, shape, offset=0):
    """flash_bwd_dqkv with a dq buffer of ``dtype`` and ``shape``, dense but
    ``offset`` elements past the start of its allocation."""
    q = torch.zeros((1, 8, 2, 16))
    lse = torch.zeros((1, 2, 8))
    dq = torch.zeros(offset + math.prod(shape), dtype=dtype)[offset:].view(shape)
    t_flash.flash_bwd_dqkv(q, q, q, q, lse, lse, dq, scale=0.25)


def _refuse_mixed_dtypes():
    q = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16)
    t_flash._check_cuda_inputs(q, q.float(), q, "flash_bwd_fused")


# name: (call, exception, message pattern)
FUSED_REFUSALS = {
    "meta_device": (_refuse_meta_fused, ValueError, "flash_bwd_fused runs on cuda or cpu"),
    "dq_buffer_bf16": (lambda: _refuse_dq_buffer(torch.bfloat16, (1, 8, 2, 16)),
                       ValueError, "dense float32"),
    "dq_buffer_shape": (lambda: _refuse_dq_buffer(torch.float32, (1, 8, 2, 8)),
                        ValueError, "dense float32"),
    # the float2 atomics need 8-byte alignment
    "dq_buffer_misaligned": (lambda: _refuse_dq_buffer(torch.float32, (1, 8, 2, 16), 1),
                             ValueError, "8-byte boundary"),
    "names_the_wrapper": (_refuse_mixed_dtypes, TypeError, "^flash_bwd_fused takes"),
}


@pytest.mark.parametrize("case", sorted(FUSED_REFUSALS))
def test_fused_wrapper_checks_refuse_bad_arguments(case):
    call, exc, pattern = FUSED_REFUSALS[case]
    with pytest.raises(exc, match=pattern):
        call()


def test_switch_sends_flash_bwd_to_the_fused_wrapper(monkeypatch):
    lse = torch.empty((1, 2, 8), device="meta")
    args = (_meta(), _meta(), _meta(), _meta(), lse, _meta())
    monkeypatch.setenv("FLASH_FUSED_BWD", "1")
    with pytest.raises(ValueError, match="^flash_bwd_fused runs"):
        t_flash.flash_bwd(*args, scale=0.25)
    monkeypatch.setenv("FLASH_FUSED_BWD", "0")
    with pytest.raises(ValueError, match="^flash_bwd runs"):
        t_flash.flash_bwd(*args, scale=0.25)


def test_fused_plain_version_is_the_oracles_gradient():
    # K2c's plain version against autograd through the einsum oracle (which
    # works in float32), with GQA and a window narrower than the kernels'
    # 64-row tile
    from mingpt_distributed_tpu_torch.ops import attention as t_attn

    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 90, 4, 2, 16, seed=43))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(
        (t_attn.causal_attention(*leaves, window=20) * do).sum(), leaves)
    scale = 1 / math.sqrt(16)
    out, lse = t_flash.flash_fwd_plain(q, k, v, scale=scale, window=20)
    got = t_flash.flash_bwd_fused(q, k, v, out, lse, do, scale=scale, window=20)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
