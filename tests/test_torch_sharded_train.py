"""fsdp x tp training in the port, on 4 gloo CPU ranks, against the JAX
package's trainer.

The JAX side is ``tests/test_trainer.py``'s setup (the inline corpus, vocab
25, block 16, global batch 16, AdamW lr 1e-2, clip 1.0, seed 7) at n_layer 2,
n_head 4, n_embd 32, no dropout, fp32, for a GPT and a Llama config (RoPE,
SwiGLU, RMSNorm, GQA with 2 KV heads, tied embeddings). The JAX trainer runs
at mesh 1 and at its own fsdp 2 x tp 2 on the conftest's CPU devices; its
initial parameters and first 4 global batches go to the port's ranks, which
train with ``make_train_step`` on their rows and their slices of the
parameters at fsdp 2 x tp 2 and at dp 2 x fsdp 2. Every run's losses must
equal the JAX trainer's within 1e-5 relative at both JAX meshes, and its
parameters after the first update the JAX ones within 1e-5 absolute. Each
rank holds a quarter of ``wq``, and the downgrade counter (vocab 25 does not
split over fsdp) reads 1 per leaf after several meshes were built.

Then ``GPTTrainer`` at fsdp 2 x tp 2: a snapshot written there resumes in
one process and continues as an uninterrupted one-process run does, a
one-process snapshot resumes at fsdp 2 x tp 2 likewise, and a save above
``msgpack_gather_limit_mb`` is refused on every rank with the JAX message.
The ranks are spawned once for the module; while they train, the parent
runs the JAX trainers.
"""

import concurrent.futures
import os

import jax
import numpy as np
import optax
import pytest

from mingpt_distributed_tpu.config import MeshConfig as JMeshConfig
from mingpt_distributed_tpu_torch.parallel.spawn import run_ranks
from tests import test_trainer as tt
from tests import torch_sp_workers as W
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

STEPS = 4
LR = 1e-2
LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_ATOL = 1e-5
CONFIGS = {
    "gpt": dict(),
    "llama": dict(rope=True, swiglu=True, rmsnorm=True, n_kv_head=2, tie_weights=True),
}
MESHES = {"fsdp2_tp2": dict(dp=1, fsdp=2, tp=2), "dp2_fsdp2": dict(dp=2, fsdp=2, tp=1)}
RUNS = [(c, m) for c in CONFIGS for m in MESHES]


def _jax_run(tmp, name, model_kw, mesh_cfg):
    """The JAX trainer's first STEPS losses, with its initial parameters,
    batches and the parameters after its first update."""
    orig = tt.tiny_gpt_cfg
    tt.tiny_gpt_cfg = lambda **kw: orig(**dict(dict(n_head=4, **model_kw), **kw))
    try:
        jtr = tt.make_trainer(tmp, mesh_cfg=mesh_cfg, snapshot=name, max_steps=STEPS,
                              log_every=1)
    finally:
        tt.tiny_gpt_cfg = orig
    params = jax.device_get(jtr.state["params"])
    batches, losses, first = [], [], None
    for xy in jtr.train_iter.epoch_batches():
        if len(batches) == STEPS:
            break
        batches.append(xy)
        jtr.state, m = jtr._train_step(jtr.state, jtr._put_batch(xy), jtr.base_rng)
        losses.append(float(jax.device_get(m["loss"])))
        if first is None:
            adam = [s for s in jax.tree.leaves(
                jtr.state["opt_state"], is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
                if isinstance(s, optax.ScaleByAdamState)][0]
            first = dict(params=_flat(jax.device_get(jtr.state["params"])),
                         mu=_flat(jax.device_get(adam.mu)))
    return dict(params=params, batches=batches, losses=losses, first=first)


def _cfg_kw(vocab, model_kw):
    return dict(n_layer=2, n_head=4, n_embd=32, vocab_size=vocab, block_size=16,
                embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32",
                **model_kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    tmp = tmp_path_factory.mktemp("sharded_train")
    # the one-process snapshot the ranks resume at fsdp 2 x tp 2
    W._sharded_trainer(tt.CORPUS, str(tmp / "one.pt"), 3, dict(dp=-1)).train()
    jax_one = {c: _jax_run(tmp, f"{c}1", kw, JMeshConfig(dp=1, fsdp=1, tp=1, sp=1))
               for c, kw in CONFIGS.items()}
    todo = []
    for c, m in RUNS:
        ref = jax_one[c]
        vocab = ref["params"]["wte"].shape[0]
        todo.append(("sharded_losses", (_cfg_kw(vocab, CONFIGS[c]), MESHES[m],
                                        ref["params"], ref["batches"], LR)))
    todo.append(("sharded_trainer", (tt.CORPUS, str(tmp), MESHES["fsdp2_tp2"])))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, W.jobs, 4, (todo,), timeout_s=240)
        jax_22 = {c: _jax_run(tmp, f"{c}22", kw, JMeshConfig(dp=1, fsdp=2, tp=2, sp=1))
                  for c, kw in CONFIGS.items()}
        # one process: resume the fsdp 2 x tp 2 snapshot once the ranks wrote it,
        # and the uninterrupted run both resumes are held against
        single = W._sharded_trainer(tt.CORPUS, str(tmp / "single.pt"), 6, dict(dp=-1))
        single_last = single.train()
        per_rank = ranks.result()
    resumed = W._sharded_trainer(tt.CORPUS, str(tmp / "part22.pt"), 6, dict(dp=-1))
    resumed_at = resumed.step
    resumed_last = resumed.train()
    one = {n: p.detach().numpy() for n, p in W.convert.flatten(single.state.params).items()}
    here = {n: p.detach().numpy() for n, p in W.convert.flatten(resumed.state.params).items()}
    return dict(
        jax_one=jax_one, jax_22=jax_22,
        port={run: [r[i] for r in per_rank] for i, run in enumerate(RUNS)},
        trainer=[r[-1] for r in per_rank],
        single=dict(params=one, loss=single_last["loss"]),
        resumed_here=dict(params=here, loss=resumed_last["loss"], at=resumed_at))


@pytest.mark.parametrize("config, mesh", RUNS)
def test_losses_match_the_jax_trainer_at_mesh_1_and_at_fsdp2_tp2(runs, config, mesh):
    want_1 = runs["jax_one"][config]["losses"]
    want_22 = runs["jax_22"][config]["losses"]
    assert len(want_1) == STEPS and want_1[-1] < want_1[0]
    for r in runs["port"][(config, mesh)]:
        assert r["losses"] == runs["port"][(config, mesh)][0]["losses"]  # every rank
        np.testing.assert_allclose(r["losses"], want_1, **LOSS_TOL)
        np.testing.assert_allclose(r["losses"], want_22, **LOSS_TOL)


@pytest.mark.parametrize("config, mesh", RUNS)
def test_post_update_parameters_match_the_jax_trainer(runs, config, mesh):
    """After the first update: the first Adam moment (0.1 x the clipped
    gradient) equals the JAX trainer's within 1e-5 relative and 1e-9
    absolute on every element, and the parameters within 1e-5 absolute on
    every element whose gradient is above 1e-6. Adam's first update is
    lr * g / (|g| + 1e-8): where |g| nears its eps the update moves by
    lr * 1e-8 / (|g| + 1e-8)^2 per unit of g (2.5e5 at |g| = 1e-8), so the
    float32 reassociation of the sharded sums moves those few parameters
    (about 1 in 10^4 here) by up to ~5e-5."""
    got = runs["port"][(config, mesh)][0]["first"]
    want = runs["jax_one"][config]["first"]
    assert set(got["params"]) == set(want["params"]) == set(got["mu"])
    before = _flat(runs["jax_one"][config]["params"])
    n_steady = n_all = 0
    for name, w in want["params"].items():
        np.testing.assert_allclose(got["mu"][name], want["mu"][name], rtol=1e-5, atol=1e-9,
                                   err_msg=f"mu {name}")
        steady = np.abs(want["mu"][name]) > 0.1 * 1e-6
        n_steady, n_all = n_steady + steady.sum(), n_all + steady.size
        np.testing.assert_allclose(got["params"][name][steady], w[steady], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    assert n_steady > 0.9 * n_all
    assert max(float(np.abs(got["params"][n] - before[n]).max()) for n in before) > 1e-3


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_each_rank_holds_a_quarter_of_wq_and_its_moments(runs, config):
    for r in runs["port"][(config, "fsdp2_tp2")]:
        assert r["wq_local"] * 4 == r["wq_whole"]
        assert r["moment_elems"] == 2 * r["param_elems"]
    whole = sum(v.size for v in _flat(runs["jax_one"][config]["params"]).values())
    held = runs["port"][(config, "fsdp2_tp2")][0]["param_elems"]
    assert whole / 4 < held < whole / 2  # a quarter but the downgraded leaves


def test_downgrade_counter_reads_once_per_leaf(runs):
    """vocab 25 does not split over fsdp: wte's and head's vocabulary
    dimensions replicate, each counted once however many meshes and trees
    were sharded in the rank's process; nothing else downgrades."""
    for r in runs["port"][RUNS[-1]]:
        assert r["downgrades"] == {(("param", "wte"),): 1.0, (("param", "head"),): 1.0}


def test_a_2x2_snapshot_resumes_in_one_process_as_an_uninterrupted_run(runs):
    here, single = runs["resumed_here"], runs["single"]
    assert here["at"] == 3
    np.testing.assert_allclose(here["loss"], single["loss"], rtol=1e-5)
    for name, w in single["params"].items():
        np.testing.assert_allclose(here["params"][name], w, rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)


def test_a_one_process_snapshot_resumes_at_2x2_as_an_uninterrupted_run(runs):
    single = runs["single"]
    for r in runs["trainer"]:
        assert r["resumed_at"] == 3 and np.isfinite(r["eval_loss"])
        np.testing.assert_allclose(r["resumed_loss"], single["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["whole_loss"], single["loss"], rtol=1e-5)
    for run in ("whole", "resumed"):
        got = runs["trainer"][0][run]
        for name, w in single["params"].items():
            np.testing.assert_allclose(got[name], w, rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{run} {name}")


def test_msgpack_gather_limit_refuses_on_every_rank(runs):
    """The refusal advises the backend that exists: a directory
    snapshot_path (tests/test_torch_sharded_ckpt.py follows the advice)."""
    for r in runs["trainer"]:
        assert r["refusal"] is not None and "sharded directory backend" in r["refusal"]
        assert "neither .pt nor .msgpack" in r["refusal"]
        assert "msgpack_gather_limit_mb" in r["refusal"]


def test_multihost_msgpack_gather_refused_above_limit(tmp_path):
    """The JAX test's guard in one process: a job of several processes
    (``process_count``) refuses the gather above the limit before any
    collective, pointing at the sharded directory backend (the port's
    counterpart of the Orbax backend)."""
    tr = W._sharded_trainer(tt.CORPUS, str(tmp_path / "s.pt"), 1, dict(dp=-1),
                            msgpack_gather_limit_mb=0)
    tr.process_count = 2
    with pytest.raises(RuntimeError, match="sharded directory backend"):
        tr.save_snapshot(epoch=0)
    tr.process_count = 1
    tr.save_snapshot(epoch=0)  # one process gathers nothing: no refusal
    assert os.path.exists(str(tmp_path / "s.pt.manifest.json"))


def test_mixed_sp_and_tensor_parallel_meshes_name_item_9b():
    """sp beside fsdp or tp runs since item 9b was ported, ep since item
    12b.1 and pp since item 12b.2: check_axes accepts every such mesh, and
    no axis is left unported."""
    from mingpt_distributed_tpu_torch.parallel import mesh as mesh_lib

    mesh_lib.check_axes(dict(pp=1, dp=1, fsdp=2, ep=1, tp=1, sp=2))
    mesh_lib.check_axes(dict(pp=1, dp=1, fsdp=1, ep=1, tp=2, sp=2))
    mesh_lib.check_axes(dict(pp=1, dp=2, fsdp=2, ep=1, tp=2, sp=1))
    mesh_lib.check_axes(dict(pp=1, dp=1, fsdp=1, ep=2, tp=2, sp=2))
    mesh_lib.check_axes(dict(pp=2, dp=1, fsdp=1, ep=1, tp=2, sp=2))
    assert mesh_lib.UNPORTED_AXES == {}


def _strip(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_param_specs_and_shard_by_rule_match_jax(config, eight_devices):
    """PARAM_RULES by leaf, and the downgraded spec each leaf gets on the
    fsdp 2 x tp 2 mesh, equal the JAX package's."""
    from mingpt_distributed_tpu.models import gpt as j_gpt
    from mingpt_distributed_tpu.parallel import mesh as j_mesh
    from mingpt_distributed_tpu_torch.parallel import mesh as t_mesh

    jcfg = tt.tiny_gpt_cfg(n_head=4, vocab_size=25, **CONFIGS[config])
    shapes = jax.eval_shape(lambda: j_gpt.init(jax.random.key(0), jcfg))
    jmesh = j_mesh.make_mesh(JMeshConfig(dp=1, fsdp=2, tp=2, sp=1), devices=eight_devices[:4])
    want = _flat(jax.tree.map(lambda s: np.zeros(()), shapes))
    jspecs = dict(zip(want, jax.tree.leaves(j_mesh.param_specs(shapes),
                                           is_leaf=lambda x: isinstance(x, j_mesh.P))))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tspecs = _flat(jax.tree.map(lambda s: np.asarray(s, dtype=object),
                                t_mesh.param_specs(tree), is_leaf=lambda x: isinstance(x, tuple)))
    assert set(tspecs) == set(jspecs)
    for name, leaf in _flat(tree).items():
        assert tuple(tspecs[name]) == tuple(jspecs[name]), name
        got = t_mesh.shard_by_rule(dict(jmesh.shape), leaf.shape, tuple(tspecs[name]))
        ref = j_mesh.shard_by_rule(jmesh, leaf.shape, jspecs[name]).spec
        assert _strip(got) == _strip(ref), name
