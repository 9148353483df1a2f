"""The PyTorch port's backward prep pass (``flash_bwd_prep``: delta, the lse
cotangent folded in, K2c's float32 dq zeroed) against the JAX package's
delta expressions, on the CPU.

* ``flash_bwd_prep_plain`` (what the CUDA kernel computes; the wrapper
  runs it for CPU tensors) against the JAX package's ``jnp.sum`` of
  out * dO in float32 (``_flash_bwd_btd``, ``flash_attention.py:1101``),
  minus the lse cotangent as ``_flash_bwd`` folds it (``:491-496``), for
  float32, bfloat16 and float16 inputs. Both sum hd float32 products; the orders
  may differ, so 1e-6 relative to the row's sum of |out * dO| (hd <= 64
  terms of 2^-24 each).
* On the CPU the wrapper launches nothing, and zeroes a dq buffer it is
  given; its argument checks refuse what the kernel does not take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingpt_distributed_tpu_torch.ops import flash_attention as t_flash
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REL_TOL = 1e-6


def _jax_delta(out, do, dlse):
    """The JAX package's delta: (B, T, H, hd) -> (B, H, T) float32, minus
    the lse cotangent (B, H, T) where there is one."""
    b, t, h, hd = out.shape
    delta = jnp.sum(out.astype(jnp.float32).reshape(b, t, h, hd)
                    * do.astype(jnp.float32).reshape(b, t, h, hd), axis=-1)
    delta = delta.transpose(0, 2, 1)
    if dlse is not None:
        delta = delta - dlse.astype(jnp.float32)
    return delta


def _inputs(b, t, h, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, hd)).astype(np.float32),
            rng.standard_normal((b, t, h, hd)).astype(np.float32),
            rng.standard_normal((b, h, t)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("with_dlse", [False, True])
def test_prep_plain_version_matches_the_jax_delta(dtype, with_dlse):
    out, do, dlse = _inputs(2, 70, 3, 64, seed=51)
    j_dtype = jnp.dtype(dtype)
    jo, jd = jnp.asarray(out).astype(j_dtype), jnp.asarray(do).astype(j_dtype)
    want = np.asarray(_jax_delta(jo, jd, jnp.asarray(dlse) if with_dlse else None))
    to, td = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
              for a in (jo, jd))
    got = t_flash.flash_bwd_prep_plain(to, td, torch.from_numpy(dlse) if with_dlse else None)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 70)
    scale = np.abs(np.asarray(jo.astype(jnp.float32)) * np.asarray(jd.astype(jnp.float32))
                   ).sum(-1).transpose(0, 2, 1)
    assert np.all(np.abs(got.numpy() - want) <= REL_TOL * np.maximum(scale, 1.0))


def test_prep_wrapper_on_the_cpu_runs_the_plain_version_and_zeroes_dq():
    out, do, dlse = (torch.from_numpy(a) for a in _inputs(1, 9, 2, 16, seed=52))
    dq = torch.full(out.shape, float("nan"))
    n0 = t_flash.flash_bwd_prep.launches
    got = t_flash.flash_bwd_prep(out, do, dlse, dq=dq)
    assert torch.equal(got, t_flash.flash_bwd_prep_plain(out, do, dlse))
    assert torch.equal(dq, torch.zeros_like(dq))
    assert t_flash.flash_bwd_prep.launches == n0


def test_lse_backward_plain_version_folds_dlse_into_delta():
    # flash_lse_bwd_plain takes delta - dlse from flash_bwd_prep_plain:
    # dlse moves dq (ds = p (dp - delta + dlse)) and leaves dv = p^T dO
    q, k, dlse = (torch.from_numpy(a) for a in _inputs(1, 12, 2, 16, seed=53))
    v, do, _ = (torch.from_numpy(a) for a in _inputs(1, 12, 2, 16, seed=54))
    out, lse = t_flash.flash_lse_fwd_plain(q, k, v, scale=0.25)
    got = t_flash.flash_lse_bwd_plain(q, k, v, out, lse, do, dlse, scale=0.25)
    without = t_flash.flash_lse_bwd_plain(q, k, v, out, lse, do, None, scale=0.25)
    assert not torch.allclose(got[0], without[0])
    torch.testing.assert_close(got[2], without[2])
    delta = t_flash.flash_bwd_prep_plain(out, do, dlse)
    torch.testing.assert_close(delta, (out * do).sum(-1).transpose(1, 2) - dlse,
                               rtol=0, atol=1e-6)


def _t(shape=(1, 8, 2, 16), dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


# name: (out, do, dlse, dq, message pattern)
PREP_REFUSALS = {
    "do_shape": (_t(), _t((1, 8, 2, 32)), None, None, "one shape"),
    "mixed_dtypes": (_t(), _t(dtype=torch.bfloat16), None, None, "dtype"),
    # float16 has kernels of its own (csrc/flash_bwd_f16.cu); float64 none
    "float64": (_t(dtype=torch.float64), _t(dtype=torch.float64), None, None, "dtype"),
    # outside the kernels' range 8..256
    "head_dim_4": (_t((1, 8, 2, 4)), _t((1, 8, 2, 4)), None, None, "head_dim 4 .*8..256"),
    "head_dim_320": (_t((1, 8, 2, 320)), _t((1, 8, 2, 320)), None, None,
                     "head_dim 320 .*8..256"),
    # K2c's dq buffer exists only at an instance's width
    "dq_at_padded_width": (_t((1, 8, 2, 8)), _t((1, 8, 2, 8)), None, _t((1, 8, 2, 8)),
                           "instance's width"),
    "dlse_shape": (_t(), _t(), torch.zeros(1, 8, 2), None, "dlse"),
    "dq_bf16": (_t(), _t(), None, _t(dtype=torch.bfloat16), "dense float32"),
    "dq_strided": (_t(), _t(), None, _t((1, 8, 2, 32))[..., ::2], "dense float32"),
    # dense, but one float past an aligned allocation: the float4 zero-fill
    # would fault on the card
    "dq_misaligned": (_t(), _t(), None, torch.zeros(1 + 8 * 2 * 16)[1:].view(1, 8, 2, 16),
                      "16-byte boundary"),
}


@pytest.mark.parametrize("case", sorted(PREP_REFUSALS))
def test_prep_checks_refuse_bad_arguments(case):
    out, do, dlse, dq, pattern = PREP_REFUSALS[case]
    with pytest.raises(ValueError, match=pattern):
        t_flash._check_prep_inputs(out, do, dlse, dq)


@pytest.mark.parametrize("hd", [8, 24, 80, 96, 200, 256])
def test_prep_checks_accept_every_width_in_the_kernels_range(hd):
    # head_dim 8 was refused before the kernels took every width from 8 to
    # 256 (the others run the next instance up, zero-padded)
    t_flash._check_prep_inputs(_t((1, 8, 2, hd)), _t((1, 8, 2, hd)), torch.zeros(1, 2, 8),
                               None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_prep_checks_accept_16_bit_inputs_with_and_without_dq(dtype):
    # float16 was refused before its kernels existed; K2c's dq stays float32
    t_flash._check_prep_inputs(_t(dtype=dtype), _t(dtype=dtype), torch.zeros(1, 2, 8), None)
    t_flash._check_prep_inputs(_t(dtype=dtype), _t(dtype=dtype), None, _t())


def test_prep_checks_accept_matching_arguments_and_other_devices_raise():
    t_flash._check_prep_inputs(_t(), _t(), torch.zeros(1, 2, 8), _t())
    meta = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="^flash_bwd_prep runs on cuda or cpu"):
        t_flash.flash_bwd_prep(meta, meta)


def test_prep_entry_is_in_the_flash_bwd_library():
    argtypes = t_flash._ENTRIES["flash_bwd"]["flash_bwd_prep"]
    assert len(argtypes) == 11 and argtypes[-1] is t_flash._PTR
