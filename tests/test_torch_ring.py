"""The port's ring attention, run on gloo CPU ranks, against the JAX
``ring_causal_attention`` on the conftest's 8 host devices.

The ranks are spawned once per world size (4, and 2), run every case, and
return their chunks of the output and of the q/k/v gradients of sum(out *
dO); the parent puts them together and holds them against the JAX wrapper
on the same numpy inputs: output 1e-5, gradients 2e-4 (the JAX tests');
two cases against the JAX dense oracle, which the JAX ring equals in the
JAX package's tests, to keep the file's clock.
The workers (tests/torch_sp_workers.py) import torch and the port only.
Cases after tests/test_ring_attention.py and
tests/test_sp_window_softcap.py: the zigzag ring (even chunks), GQA, dp x
sp, the contiguous ring (odd chunks), softcap; the zigzag's K3/K4 calls
counted against the exact causal share of the work; attention dropout
against a dense attention with the ring's per-pair masks.
"""

import numpy as np
import pytest
import torch

from mingpt_distributed_tpu_torch.ops import attention as t_attn
from mingpt_distributed_tpu_torch.parallel import distributed, ring_attention
from tests import torch_sp_parity as P
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CASES = {
    "zigzag_sp4": P.case("ring", 1, 4, seed=1),
    "zigzag_gqa_dp2_sp2": P.case("ring", 2, 2, h=4, kv=2, seed=3),
    "zigzag_hd8_dp2_sp2": P.case("ring", 2, 2, t=128, h=8, hd=8, seed=4),
    "contiguous_odd_chunk_sp4": P.case("ring", 1, 4, t=36, h=2, kv=1, hd=32, seed=5),
    "softcap_zigzag_sp4": P.case("ring", 1, 4, seed=29, logit_softcap=4.0),
    "zigzag_sp2": P.case("ring", 1, 2, b=2, t=48, h=2, hd=16, seed=6),
    "contiguous_odd_chunk_sp2": P.case("ring", 1, 2, t=30, h=2, hd=16, seed=7),
}
DROPOUT = dict(P.case("ring", 1, 4, b=2, t=32, h=2, hd=8, seed=7,
                      attn_pdrop=0.5), gen_seed=11)


@pytest.fixture(scope="module")
def results():
    cases = dict(CASES, dropout_sp4=DROPOUT)
    out = P.spawn_cases(cases, 4)
    out.update(P.spawn_cases(cases, 2))
    return out


# held against the JAX dense oracle instead of the JAX ring (which equals it
# in tests/test_ring_attention.py): its interpreted kernels cost seconds
DENSE = {"zigzag_hd8_dp2_sp2", "softcap_zigzag_sp4"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_matches_jax_ring(results, name):
    P.check_against_jax(name, CASES[name], results[name], dense=name in DENSE)


def test_zigzag_kernel_work_is_the_exact_causal_share(results):
    """Per rank: 3 K3 calls at step 0 and one per hop, 3 + (n - 1) in all,
    as many K4 calls in the backward, and kernel work (batch x q x k, a
    causal diagonal counting half) of exactly the causal triangle's share
    B H T^2 / (2n)."""
    c = CASES["zigzag_sp4"]
    n, bh, t = c["sp"], c["b"] * c["h"], c["t"]
    for rank in results["zigzag_sp4"]:
        fwd = [x for x in rank["calls"] if x[0] == "fwd"]
        bwd = [x for x in rank["calls"] if x[0] == "bwd"]
        assert len(fwd) == len(bwd) == 3 + (n - 1)
        work = sum(b * tq * tk * (0.5 if causal else 1.0)
                   for _, b, tq, tk, causal, _ in fwd)
        assert work == bh * t * t / (2 * n)


def test_contiguous_ring_runs_every_hop(results):
    for rank in results["contiguous_odd_chunk_sp4"]:
        fwd = [x for x in rank["calls"] if x[0] == "fwd"]
        assert [x[4] for x in fwd] == [True, False, False, False]


def test_ring_dropout_matches_a_dense_attention_with_its_pair_masks(results):
    """The einsum ring's masks are functions of the global (q-chunk,
    k-chunk) pair: a dense attention dropped with the same blocks is the
    same output; the gradients are finite and not zero."""
    c, ranks = DROPOUT, results["dropout_sp4"]
    n, b, t, h, hd = c["sp"], c["b"], c["t"], c["h"], c["hd"]
    q, k, v, _ = (torch.from_numpy(a) for a in P.W.global_qkv(
        b, t, h, c["kv"], hd, c["seed"]))
    base = distributed.dropout_base(torch.Generator().manual_seed(c["gen_seed"]))
    cc = t // n
    mask = torch.cat([torch.cat([
        ring_attention.pair_keep_mask(base, 0, i * n + j, (b, h, cc, cc), 0.5, "cpu")
        for j in range(n)], -1) for i in range(n)], -2)
    logits = torch.einsum("bthd,bshd->bhts", q, k) / np.sqrt(hd)
    allowed = torch.ones(t, t, dtype=torch.bool).tril()
    probs = torch.softmax(logits.masked_fill(~allowed, t_attn.NEG_INF), -1)
    want = torch.einsum("bhts,bshd->bthd", torch.where(mask, probs / 0.5, 0.0), v)
    got = P.assemble(ranks, "out", 1, n)
    np.testing.assert_allclose(got, want.numpy(), **P.OUT_TOL)
    for key in ("dq", "dk", "dv"):
        g = P.assemble(ranks, key, 1, n)
        assert np.isfinite(g).all() and np.abs(g).max() > 0
    assert not any(x[0] == "fwd" for r in ranks for x in r["calls"])  # no kernel


def test_without_a_mesh_the_ring_is_the_oracle():
    q, k, v, _ = (torch.from_numpy(a) for a in P.W.global_qkv(2, 30, 4, 4, 16, 9))
    want = t_attn.causal_attention(q, k, v, window=7)
    got = ring_attention.ring_causal_attention(q, k, v, None, window=7)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sp_needs_chunks_of_one_sequence():
    mesh = type("M", (), {"sp": 2})()
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="chunks of one"):
        ring_attention.ring_causal_attention(q, q[:, :1], q[:, :1], mesh)
    with pytest.raises(ValueError, match="chunks of one"):
        ring_attention.ring_causal_attention(q, q, q, mesh, kv_offset=3)
