"""The port's banded (sliding-window) ring attention on gloo CPU ranks
against the JAX ``ring_causal_attention`` with a window, after
tests/test_sp_window_softcap.py: the band inside the own chunk, across two
and three past chunks, wider than the sequence, unaligned, with softcap,
dp x sp and sp = 2; and the static hop skipping (only the hops that can
meet the band run, in-band hops unmasked, boundary hops with ``q_offset =
t * c``). Output 1e-5, gradients 2e-4. Cases marked dense are held against
the JAX dense oracle, which the JAX banded ring equals in the JAX package's
tests, to keep the file's clock.
"""

import pytest

from tests import torch_sp_parity as P
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CASES = {
    "window1_sp4": P.case("ring", 1, 4, seed=1, window=1),
    "window8_sp4": P.case("ring", 1, 4, seed=8, window=8),
    "window20_sp4": P.case("ring", 1, 4, seed=20, window=20),
    "window40_sp4": P.case("ring", 1, 4, seed=40, window=40),
    "window64_sp4": P.case("ring", 1, 4, seed=64, window=64),
    "window11_unaligned_sp4": P.case("ring", 1, 4, t=48, seed=11, window=11),
    "window20_softcap_dp2_sp2": P.case("ring", 2, 2, seed=31, window=20,
                                       logit_softcap=5.0),
    "window13_softcap_gqa_sp4": P.case("ring", 1, 4, t=40, h=4, kv=2, seed=37,
                                       window=13, logit_softcap=3.0),
    "window16_sp2": P.case("ring", 1, 2, seed=16, window=16),
}
JAX_RING = {"window8_sp4", "window20_sp4", "window20_softcap_dp2_sp2"}


@pytest.fixture(scope="module")
def results():
    out = P.spawn_cases(CASES, 4)
    out.update(P.spawn_cases(CASES, 2))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_banded_ring_matches_jax(results, name):
    P.check_against_jax(name, CASES[name], results[name], dense=name not in JAX_RING)


@pytest.mark.parametrize("name", sorted(CASES))
def test_banded_ring_runs_only_the_hops_that_meet_the_band(results, name):
    c = CASES[name]
    n, window = c["sp"], c["kw"]["window"]
    cc = c["t"] // n
    t_live = min(n - 1, (window + cc - 2) // cc)
    for rank in results[name]:
        fwd = [x for x in rank["calls"] if x[0] == "fwd"]
        assert len(fwd) == len([x for x in rank["calls"] if x[0] == "bwd"])
        assert len(fwd) == 1 + t_live
        assert fwd[0][4:] == (True, 0)  # the own chunk: banded causal
        for hop, (*_, causal, q_offset) in enumerate(fwd[1:], start=1):
            d = hop * cc
            if d + cc - 1 < window:  # wholly in band: no mask
                assert (causal, q_offset) == (False, 0)
            else:  # boundary: the offset band
                assert (causal, q_offset) == (True, d)
