"""dp x sp training in the port, on 4 gloo CPU ranks, against the JAX
package's ring trainer and the port's single process.

The JAX side is ``tests/test_trainer.py``'s setup (tiny float32 config:
2 layers, 2 heads, 32 wide, block 16, no dropout; AdamW lr 1e-2, clip 1.0;
global batch 16 of the inline corpus) with ``attention=ring`` on a dp=2 x
sp=4 mesh of host devices, as in ``test_train_step_ring_sp_matches_dp``.
Its initial parameters and its first 6 global batches go to the ranks,
which train with ``make_train_step`` on their share (dp rows, sp columns):
ring at dp=2 x sp=2 and at sp=4, Ulysses at dp=2 x sp=2. Every run's 6
losses must equal the JAX ring trainer's, and the port's single-process
einsum run's, within 2e-4 (the JAX equivalence tests' tolerance). While the
ranks train, the parent runs the JAX steps.

Then ``GPTTrainer`` across the ranks (dropout on, so the ranks' generators
matter): 3 steps, a snapshot written by rank 0 and a resume to 6 equal an
uninterrupted 6-step run bit for bit on every rank; a stop requested on one
rank alone stops every rank at the same step, with a snapshot.
"""

import concurrent.futures
import os

import jax
import numpy as np
import pytest
import torch

from mingpt_distributed_tpu.config import MeshConfig as JMeshConfig
from mingpt_distributed_tpu_torch.config import GPTConfig, OptimizerConfig
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.parallel.spawn import run_ranks
from mingpt_distributed_tpu_torch.training import trainer as t_trainer
from mingpt_distributed_tpu_torch.training.optimizer import make_optimizer
from tests import test_trainer as tt
from tests import torch_sp_workers as W
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=2e-4, atol=2e-4)
STEPS = 6
LR = 1e-2
RUNS = {  # name: (attention, mesh)
    "ring_dp2_sp2": ("ring", dict(dp=2, sp=2)),
    "ring_sp4": ("ring", dict(dp=1, sp=4)),
    "ulysses_dp2_sp2": ("ulysses", dict(dp=2, sp=2)),
}


def _cfg_kw(vocab, attention):
    return dict(n_layer=2, n_head=2, n_embd=32, vocab_size=vocab, block_size=16,
                embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32",
                attention=attention)


def _single_process(cfg_kw, params_tree, batches):
    cfg = GPTConfig.make(**cfg_kw)
    params = t_trainer.trainable(convert.params_from_numpy(params_tree, cfg, "cpu"))
    state = t_trainer.TrainState(params, make_optimizer(
        OptimizerConfig.make(learning_rate=LR), params, 1.0))
    step = t_trainer.make_train_step(cfg)
    return [step(state, (torch.from_numpy(x).long(), torch.from_numpy(y).long())
                 )["loss"].item() for x, y in batches]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    tmp = tmp_path_factory.mktemp("sp_train")
    orig = tt.tiny_gpt_cfg
    tt.tiny_gpt_cfg = lambda **kw: orig(**dict(dict(attention="ring"), **kw))
    try:
        jtr = tt.make_trainer(tmp, mesh_cfg=JMeshConfig(dp=2, fsdp=1, tp=1, sp=4),
                              snapshot="j.msgpack", max_steps=STEPS, log_every=1)
    finally:
        tt.tiny_gpt_cfg = orig
    params = jax.device_get(jtr.state["params"])
    batches = []
    for xy in jtr.train_iter.epoch_batches():
        batches.append(xy)
        if len(batches) == STEPS:
            break
    vocab = params["wte"].shape[0]
    todo = [("train_losses", (_cfg_kw(vocab, att), mesh, params, batches, LR))
            for att, mesh in RUNS.values()]
    todo.append(("trainer_resume", (tt.CORPUS, str(tmp), dict(dp=2, sp=2), "ring")))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, W.jobs, 4, (todo,), timeout_s=180)
        jax_losses = []
        for xy in batches:
            jtr.state, m = jtr._train_step(jtr.state, jtr._put_batch(xy), jtr.base_rng)
            jax_losses.append(float(jax.device_get(m["loss"])))
        single = _single_process(_cfg_kw(vocab, "einsum"), params, batches)
        per_rank = ranks.result()
    by_run = {name: [r[i] for r in per_rank] for i, name in enumerate(RUNS)}
    return dict(jax=jax_losses, single=single, resume=[r[-1] for r in per_rank],
                **by_run)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_sp_train_losses_match_the_jax_ring_trainer(runs, name):
    for rank_losses in runs[name]:
        assert len(rank_losses) == STEPS
        np.testing.assert_allclose(rank_losses, runs["jax"], **TOL)
        assert rank_losses == runs[name][0]  # every rank: the same global loss


@pytest.mark.parametrize("name", sorted(RUNS))
def test_sp_train_losses_match_the_single_process(runs, name):
    np.testing.assert_allclose(runs[name][0], runs["single"], **TOL)
    assert runs["single"][-1] < runs["single"][0]


def test_snapshot_resume_across_ranks_equals_an_uninterrupted_run(runs):
    for r in runs["resume"]:
        assert r["resumed_at"] == 3 and r["generators_equal"]
        np.testing.assert_array_equal(r["resumed"], r["whole"])
        assert r["resumed_loss"] == r["whole_loss"]
        assert np.isfinite(r["eval_loss"])
    first = runs["resume"][0]["whole"]
    for r in runs["resume"][1:]:  # replicated parameters stay equal
        np.testing.assert_array_equal(r["whole"], first)


def test_a_stop_on_one_rank_stops_every_rank(runs):
    for r in runs["resume"]:
        assert r["preempted"] and r["stopped_at"] == 2


def test_entry_point_refuses_a_job_without_a_backend(monkeypatch, tmp_path):
    from mingpt_distributed_tpu_torch import train as t_train

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="--dist-backend"):
        t_train.main(["--config", os.path.join(tt.__file__.rsplit("/tests/", 1)[0],
                                               "gpt2_config.yaml"),
                      "--device", "cpu"])
