"""The port's Ulysses attention on gloo CPU ranks against the JAX
``ulysses_causal_attention``, after tests/test_ulysses.py and
tests/test_sp_window_softcap.py: dp x sp, GQA, a window with softcap, the
``n_head % sp`` fallback (here an explicit all-gather, then the oracle),
sp = 2; attention dropout keyed by its generator. Output 1e-5, gradients
2e-4; cases marked dense are held against the JAX dense oracle, which the
JAX wrapper equals in the JAX package's tests, to keep the file's clock.
"""

import numpy as np
import pytest
import torch

from mingpt_distributed_tpu_torch.ops import attention as t_attn
from mingpt_distributed_tpu_torch.parallel import ulysses
from tests import torch_sp_parity as P
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CASES = {
    "dp2_sp2": P.case("ulysses", 2, 2, seed=0),
    "gqa_h8_kv2_sp4": P.case("ulysses", 1, 4, h=8, kv=2, seed=3),
    "window20_softcap_sp4": P.case("ulysses", 1, 4, seed=41, window=20,
                                   logit_softcap=5.0),
    "window24_dp2_sp2": P.case("ulysses", 2, 2, seed=43, window=24),
    "heads_indivisible_h3_sp4": P.case("ulysses", 1, 4, h=3, seed=5),
    "sp2": P.case("ulysses", 1, 2, t=48, seed=7),
}
JAX_ULYSSES = {"dp2_sp2", "gqa_h8_kv2_sp4", "heads_indivisible_h3_sp4", "sp2"}
DROP = dict(P.case("ulysses", 1, 4, b=2, t=32, h=4, hd=8, seed=7, attn_pdrop=0.5))
DROPOUT = {"dropout_a": dict(DROP, gen_seed=1), "dropout_b": dict(DROP, gen_seed=1),
           "dropout_c": dict(DROP, gen_seed=2)}


@pytest.fixture(scope="module")
def results():
    cases = dict(CASES, **DROPOUT)
    out = P.spawn_cases(cases, 4)
    out.update(P.spawn_cases(cases, 2))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_ulysses_matches_jax(results, name):
    P.check_against_jax(name, CASES[name], results[name],
                        dense=name not in JAX_ULYSSES)


def test_ulysses_dropout_is_keyed_by_its_generator(results):
    a, b, c = (P.assemble(results[n], "out", 1, 4) for n in sorted(DROPOUT))
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c, atol=1e-6)
    dense = t_attn.causal_attention(*(torch.from_numpy(x) for x in P.W.global_qkv(
        2, 32, 4, 4, 8, 7)[:3]))
    assert not np.allclose(a, dense.numpy(), atol=1e-6)  # it did drop
    for key in ("dq", "dk", "dv"):
        assert np.isfinite(P.assemble(results["dropout_a"], key, 1, 4)).all()


def test_without_a_mesh_ulysses_is_the_oracle():
    q, k, v, _ = (torch.from_numpy(a) for a in P.W.global_qkv(2, 30, 4, 2, 16, 9))
    want = t_attn.causal_attention(q, k, v, logit_softcap=3.0)
    got = ulysses.ulysses_causal_attention(q, k, v, None, logit_softcap=3.0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
