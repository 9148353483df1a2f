"""Sequence parallelism beside tensor and parameter parallelism in the
port: sp x tp and sp x fsdp, on 4 gloo CPU ranks, against the JAX package.

Attention: ring and Ulysses at dp 1 x sp 2 x tp 2 take each rank's chunk of
the sequence and its tp share of the heads (heads are just batch to the
ring, as ``tests/test_ring_attention.py``'s dp 2 x sp 2 x tp 2 case says);
each rank's output and q/k/v gradients equal the matching block of the
dense oracle's, computed by the JAX package, within 1e-5. Ulysses'
all-to-all needs the tp share of the heads to divide by sp; 2 heads over
tp 2 leave 1 per rank, which takes the explicit all-gather fallback.

Training: ``tests/test_torch_sharded_train.py``'s GPT (vocab 25, block 16,
global batch 16, AdamW lr 1e-2, n_layer 2, n_head 4, n_embd 32, fp32, no
dropout) with ring attention at sp 2 x tp 2 and at sp 2 x fsdp 2: every
rank's losses equal the JAX trainer's at mesh 1 and on the same mesh, and
the port's one process', within 1e-5 relative; after the first update the
first Adam moment (0.1 x the clipped gradient) matches within 1e-5 relative
and the parameters within 1e-5 absolute where the gradient is above 1e-6.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mingpt_distributed_tpu.config import MeshConfig as JMeshConfig
from mingpt_distributed_tpu.ops import attention as j_attn
from mingpt_distributed_tpu_torch.parallel import mesh as mesh_lib
from mingpt_distributed_tpu_torch.parallel.spawn import run_ranks
from tests import test_trainer as tt
from tests import torch_sp_workers as W
from tests.test_torch_sharded_train import LR, STEPS, _cfg_kw, _flat, _jax_run
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_ATOL = 1e-5
# a key bias's gradient is 0 in exact arithmetic (softmax ignores a shift
# along the keys): only its share of the total is held
ZERO_GRAD = ("blocks/bk",)
ATTENTION = {
    "ring": dict(impl="ring", b=2, t=64, h=4, kv=4, hd=16, seed=17),
    "ring_gqa": dict(impl="ring", b=1, t=32, h=4, kv=2, hd=8, seed=18),
    "ulysses": dict(impl="ulysses", b=2, t=64, h=4, kv=4, hd=16, seed=19),
    "ulysses_gathered": dict(impl="ulysses", b=1, t=32, h=2, kv=2, hd=8, seed=20),
}
MESHES = {"sp2_tp2": dict(dp=1, sp=2, tp=2), "sp2_fsdp2": dict(dp=1, fsdp=2, sp=2)}
JAX_MESHES = {"sp2_tp2": JMeshConfig(dp=1, fsdp=1, tp=2, sp=2),
              "sp2_fsdp2": JMeshConfig(dp=1, fsdp=2, tp=1, sp=2)}


def _oracle(case):
    """The JAX dense oracle's output and q/k/v gradients of sum(out * dO)."""
    q, k, v, do = W.global_qkv(case["b"], case["t"], case["h"], case["kv"],
                               case["hd"], case["seed"])
    out, vjp = jax.vjp(j_attn.causal_attention, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(do)))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    tmp = tmp_path_factory.mktemp("sp_tp")
    jax_one = _jax_run(tmp, "one", {}, JMeshConfig(dp=1, fsdp=1, tp=1, sp=1))
    vocab = jax_one["params"]["wte"].shape[0]
    todo = [("tp_attention_cases", (ATTENTION,))]
    for mesh in MESHES.values():
        todo.append(("sharded_losses", (_cfg_kw(vocab, dict(attention="ring")), mesh,
                                        jax_one["params"], jax_one["batches"], LR)))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, W.jobs, 4, (todo,), timeout_s=240)
        jax_meshes = {m: _jax_run(tmp, m, {}, c) for m, c in JAX_MESHES.items()}
        one = W.sharded_losses(0, _cfg_kw(vocab, dict(attention="ring")), dict(dp=1),
                               jax_one["params"], jax_one["batches"], LR)
        per_rank = ranks.result()
    return dict(jax_one=jax_one, jax_meshes=jax_meshes, one=one,
                attention=[r[0] for r in per_rank],
                port={m: [r[1 + i] for r in per_rank] for i, m in enumerate(MESHES)})


@pytest.mark.parametrize("case", sorted(ATTENTION))
def test_attention_with_tp_sharded_heads_matches_the_oracle(runs, case):
    c = ATTENTION[case]
    want = _oracle(c)
    chunk = c["t"] // 2
    for r in runs["attention"]:
        got, (sp_rank, tp_rank) = r[case], r[case]["coords"]
        for key, w in zip(("out", "dq", "dk", "dv"), want):
            heads = w.shape[2] // 2
            block = w[:, sp_rank * chunk:(sp_rank + 1) * chunk,
                      tp_rank * heads:(tp_rank + 1) * heads]
            np.testing.assert_allclose(got[key], block, **TOL,
                                       err_msg=f"{case} {key} rank ({sp_rank}, {tp_rank})")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_losses_match_the_jax_trainer_and_one_process(runs, mesh):
    want_1 = runs["jax_one"]["losses"]
    want_mesh = runs["jax_meshes"][mesh]["losses"]
    assert len(want_1) == STEPS and want_1[-1] < want_1[0]
    np.testing.assert_allclose(runs["one"]["losses"], want_1, **LOSS_TOL)
    for r in runs["port"][mesh]:
        assert r["losses"] == runs["port"][mesh][0]["losses"]  # every rank
        np.testing.assert_allclose(r["losses"], want_1, **LOSS_TOL)
        np.testing.assert_allclose(r["losses"], want_mesh, **LOSS_TOL)
        np.testing.assert_allclose(r["losses"], runs["one"]["losses"], **LOSS_TOL)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_gradients_and_post_update_parameters_match(runs, mesh):
    """The first Adam moment (0.1 x the clipped gradient, summed over sp
    and reduce-scattered over fsdp) of every leaf against the JAX trainer's
    on the same mesh and the port's one process, norm-wise; the parameters
    where |g| > 1e-6."""
    got = runs["port"][mesh][0]["first"]
    refs = (runs["jax_meshes"][mesh]["first"], runs["one"]["first"])
    before = _flat(runs["jax_one"]["params"])
    for want in refs:
        assert set(got["params"]) == set(want["params"]) == set(got["mu"])
        n_steady = n_all = 0
        diff = {n: np.linalg.norm(got["mu"][n] - m) for n, m in want["mu"].items()}
        norm = {n: np.linalg.norm(m) for n, m in want["mu"].items()}
        assert np.linalg.norm(list(diff.values())) <= 1e-5 * np.linalg.norm(list(norm.values()))
        for name, w in want["params"].items():
            if name not in ZERO_GRAD:
                assert diff[name] <= 1e-5 * norm[name], f"mu {name}"
            steady = np.abs(want["mu"][name]) > 0.1 * 1e-6
            n_steady, n_all = n_steady + steady.sum(), n_all + steady.size
            np.testing.assert_allclose(got["params"][name][steady], w[steady], rtol=0,
                                       atol=PARAM_ATOL, err_msg=name)
        assert n_steady > 0.9 * n_all
    assert max(float(np.abs(got["params"][n] - before[n]).max()) for n in before) > 1e-3


def test_sp_tp_ranks_hold_their_tp_share_of_the_model(runs):
    """At sp 2 x tp 2 each rank holds half of wq (its tp columns); at sp 2
    x fsdp 2 half of it too (its fsdp rows); the moments match the
    parameters."""
    for mesh in MESHES:
        for r in runs["port"][mesh]:
            assert r["wq_local"] * 2 == r["wq_whole"]
            assert r["moment_elems"] == 2 * r["param_elems"]


@pytest.mark.parametrize("shape", [dict(fsdp=2, sp=2), dict(tp=2, sp=2),
                                   dict(dp=2, fsdp=2, tp=2, sp=2)])
def test_check_axes_accepts_sp_beside_fsdp_and_tp(shape):
    mesh_lib.check_axes(dict(dict(pp=1, dp=1, fsdp=1, ep=1, tp=1, sp=1), **shape))


@pytest.mark.parametrize("axis", ["pp", "ep"])
def test_check_axes_still_refuses_pp_and_ep_naming_12b(axis):
    """Both run beside sp x tp now: ep since item 12b.1 (a batch axis beside
    sp for a dense model), pp since item 12b.2, and an MoE model beside sp
    since item 12b.4 (tests/test_torch_moe_sp.py)."""
    from mingpt_distributed_tpu_torch.config import GPTConfig
    from mingpt_distributed_tpu_torch.models import gpt

    shape = dict(dict(pp=1, dp=1, fsdp=1, ep=1, tp=2, sp=2), **{axis: 2})
    mesh_lib.check_axes(shape)
    cfg = GPTConfig.make(n_layer=2, n_head=4, n_embd=32, vocab_size=64, block_size=16,
                         n_experts=2, attention="ring")
    gpt.check_supported(cfg, shape)
