"""The PyTorch port's layers (mingpt_distributed_tpu_torch/ops/layers.py)
against the JAX package's (ops/layers.py): same numpy inputs, float32 on
the CPU, tolerance 1e-6 (model-sized values; only the summation order of
means and matmuls differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mingpt_distributed_tpu.ops import layers as jl
from mingpt_distributed_tpu_torch.ops import layers as tl
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-6, atol=1e-6)


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_layer_norm_matches_jax():
    x, scale, bias = _arrays(0, (2, 5, 64), (64,), (64,))
    scale = 1.0 + 0.1 * scale
    want = jl.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = tl.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                        torch.from_numpy(bias))
    _close(got, want)


def test_rms_norm_matches_jax():
    x, scale = _arrays(1, (2, 5, 64), (64,))
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(scale), eps=1e-6)
    got = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), eps=1e-6)
    _close(got, want)


def test_norms_keep_input_dtype():
    x = torch.randn(2, 3, 16, dtype=torch.bfloat16)
    ones, zeros = torch.ones(16), torch.zeros(16)
    assert tl.layer_norm(x, ones, zeros).dtype == torch.bfloat16
    assert tl.rms_norm(x, ones).dtype == torch.bfloat16


def test_gelu_is_tanh_approximation_like_jax():
    (x,) = _arrays(2, (4, 257), scale=3.0)
    _close(tl.gelu(torch.from_numpy(x)), jl.gelu(jnp.asarray(x)))


@pytest.mark.parametrize("with_bias", [True, False])
def test_dense_matches_jax(with_bias):
    x, w, b = _arrays(3, (2, 7, 64), (64, 48), (48,))
    w *= 0.02
    want = jl.dense(jnp.asarray(x), jnp.asarray(w),
                    jnp.asarray(b) if with_bias else None)
    got = tl.dense(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b) if with_bias else None)
    _close(got, want)


def test_dense_computes_in_activation_dtype():
    x = torch.randn(2, 4, 8, dtype=torch.bfloat16)
    assert tl.dense(x, torch.randn(8, 3), torch.randn(3)).dtype == torch.bfloat16


def test_mlp_gelu_matches_jax():
    x, w_fc, b_fc, w_proj, b_proj = _arrays(
        4, (2, 6, 32), (32, 128), (128,), (128, 32), (32,))
    w_fc *= 0.02
    w_proj *= 0.02
    j = [jnp.asarray(a) for a in (x, w_fc, b_fc, w_proj, b_proj)]
    t = [torch.from_numpy(a) for a in (x, w_fc, b_fc, w_proj, b_proj)]
    _close(tl.mlp_gelu(*t), jl.mlp_gelu(*j))


def test_mlp_swiglu_matches_jax():
    x, w_gate, w_up, w_down = _arrays(5, (2, 6, 32), (32, 96), (32, 96),
                                      (96, 32))
    w_gate *= 0.05
    w_up *= 0.05
    w_down *= 0.05
    j = [jnp.asarray(a) for a in (x, w_gate, w_up, w_down)]
    t = [torch.from_numpy(a) for a in (x, w_gate, w_up, w_down)]
    _close(tl.mlp_swiglu(*t), jl.mlp_swiglu(*j))


def test_dropout_identity_when_off():
    x = torch.randn(4, 8)
    assert tl.dropout(x, 0.5, None, deterministic=True) is x
    assert tl.dropout(x, 0.0, None, deterministic=False) is x
    with pytest.raises(ValueError):
        tl.dropout(x, 0.5, None, deterministic=False)


def test_dropout_is_inverted_and_reproducible():
    x = torch.ones(200, 200)
    a = tl.dropout(x, 0.25, torch.Generator().manual_seed(7), False)
    b = tl.dropout(x, 0.25, torch.Generator().manual_seed(7), False)
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.02
