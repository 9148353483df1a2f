"""The PyTorch port's training path against the JAX package's.

A tiny float32 config (2 layers, 4 heads, 64 wide, vocab 96, T=32), with the
flash path (the kernels' plain versions on the port's side, Pallas interpret
mode on the JAX side) and the einsum oracle. The same numpy parameters,
gradients and batches go through both packages:

* ``chunked_cross_entropy`` loss and gradients (1e-5);
* ``decay_mask`` and its refusal of unknown names;
* ``lr_schedule`` against optax at every step (relative 1e-6);
* one optimizer update from identical gradients and Adam state against
  optax's (1e-6): the same gradients on both sides keep Adam's first step,
  which is close to sign(g), from hiding gradient gaps;
* three ``make_train_step`` steps against the JAX step: loss, grad_norm and
  update_norm within 1e-5 relative; parameters within 1e-4 of each other
  elementwise, and their difference within 1e-3 of the three steps' total
  change. The gradients differ by float32 rounding (~1e-6 relative), and
  Adam's normalised update turns that into a visibly different step only
  where a gradient is near zero: a few elements move by a fraction of
  lr = 1e-3 differently. Also at grad_accum=2;
* the batch order of the data iterator, including after a resume;
* a snapshot resumed equals an uninterrupted run bit for bit;
* preemption gives exit 75; the entry point trains on the CPU; options that
  are not ported raise.
"""

import dataclasses
import json
import os
import re
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mingpt_distributed_tpu.config import GPTConfig as JConfig
from mingpt_distributed_tpu.config import OptimizerConfig as JOptConfig
from mingpt_distributed_tpu.data import char_dataset as j_data
from mingpt_distributed_tpu.config import DataConfig as JDataConfig
from mingpt_distributed_tpu.models import gpt as j_gpt
from mingpt_distributed_tpu.training import metrics as j_metrics
from mingpt_distributed_tpu.training import optimizer as j_opt
from mingpt_distributed_tpu.training import trainer as j_trainer
from mingpt_distributed_tpu_torch import telemetry
from mingpt_distributed_tpu_torch import train as t_train
from mingpt_distributed_tpu_torch.config import (
    UNPORTED_TRAINER_OPTIONS,
    DataConfig,
    GPTConfig,
    MeshConfig,
    OptimizerConfig,
    TrainerConfig,
)
from mingpt_distributed_tpu_torch.data import char_dataset as t_data
from mingpt_distributed_tpu_torch.data.prefetch import PrefetchIterator
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import gpt as t_gpt
from mingpt_distributed_tpu_torch.training import checkpoint as t_ckpt
from mingpt_distributed_tpu_torch.training import metrics as t_metrics
from mingpt_distributed_tpu_torch.training import optimizer as t_opt
from mingpt_distributed_tpu_torch.training import trainer as t_trainer
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_layer=2, n_head=4, n_embd=64, vocab_size=96, block_size=32,
             dtype="float32", embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)


def jax_params(jcfg, seed=0):
    """JAX init, every leaf perturbed so no bias or norm is trivial."""
    tree = jax.device_get(j_gpt.init(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32), tree)


def both(attention="flash", **kw):
    cfg = dict(SMALL, attention=attention, **kw)
    return JConfig.make(**cfg), GPTConfig.make(**cfg)


def to_numpy(tree):
    return convert.params_to_numpy(tree)


# -- chunked cross-entropy -----------------------------------------------------

@pytest.mark.parametrize("softcap", [None, 15.0])
def test_chunked_cross_entropy_matches_jax(softcap):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    w = (0.1 * rng.standard_normal((64, 96))).astype(np.float32)
    tg = rng.integers(0, 96, (2, 32)).astype(np.int32)
    tg[0, :7] = -1
    loss_fn = lambda x, w: j_gpt.chunked_cross_entropy(  # noqa: E731
        x, w, jnp.asarray(tg), 4, softcap=softcap)
    want, (jgx, jgw) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    got = t_gpt.chunked_cross_entropy(xt, wt, torch.from_numpy(tg).long(), 4,
                                      softcap=softcap)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("t,loss_chunks,chunks", [(32, 8, 8), (30, 8, 6), (7, 8, 7),
                                                  (32, 0, 1)])
def test_loss_only_mode_snaps_chunks_and_matches_dense_loss(t, loss_chunks, chunks,
                                                            monkeypatch):
    _, tcfg = both(loss_chunks=loss_chunks)
    params = t_gpt.init(tcfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 96, (2, t))).long()
    seen = []
    real = t_gpt.chunked_cross_entropy
    monkeypatch.setattr(t_gpt, "chunked_cross_entropy",
                        lambda *a, **k: seen.append(a[3]) or real(*a, **k))
    logits, dense = t_gpt.forward(params, tokens, tcfg, targets=tokens)
    none, loss = t_gpt.forward(params, tokens, tcfg, targets=tokens,
                               return_logits=False)
    assert none is None and logits.shape == (2, t, 96)
    assert seen == ([chunks] if chunks > 1 else [])
    torch.testing.assert_close(loss, dense, rtol=1e-6, atol=1e-6)


# -- optimizer -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_decay_mask_matches_jax(name):
    extra = dict(rope=True, swiglu=True, rmsnorm=True, n_kv_head=2) if name == "llama" else {}
    jcfg, tcfg = both(**extra)
    want = j_opt.decay_mask(jax.device_get(j_gpt.init(jax.random.key(0), jcfg)))
    got = t_opt.decay_mask(t_gpt.init(tcfg, torch.Generator().manual_seed(0)))
    assert got == jax.tree.map(bool, want)


def test_decay_mask_refuses_unknown_names():
    with pytest.raises(ValueError, match="not covered"):
        j_opt.decay_mask({"blocks": {"w_mystery": np.zeros(2)}})
    with pytest.raises(ValueError, match="not covered"):
        t_opt.decay_mask({"blocks": {"w_mystery": torch.zeros(2)}})


SCHEDULES = {
    "constant": dict(),
    "constant_warmup": dict(warmup_steps=7),
    "cosine": dict(schedule="cosine", warmup_steps=5, total_steps=30),
    "cosine_no_warmup": dict(schedule="cosine", total_steps=20, min_lr_ratio=0.0),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_optax(name):
    want = j_opt.lr_schedule(JOptConfig(**SCHEDULES[name]))
    got = t_opt.lr_schedule(OptimizerConfig.make(**SCHEDULES[name]))
    for step in range(40):
        # optax computes in float32: 1e-6 of the peak rate
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-6 * 3e-4)


@pytest.mark.parametrize("clip", [None, 1.0, 1e-3])  # 1e-3: the clip bites
def test_one_update_matches_optax(clip):
    jcfg, tcfg = both()
    tree = jax_params(jcfg)
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
    mu = jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32), tree)
    nu = jax.tree.map(lambda a: (0.01 * rng.random(a.shape)).astype(np.float32), tree)
    count = 3
    ocfg = dict(learning_rate=1e-3, warmup_steps=10)
    jopt = j_opt.make_optimizer(JOptConfig(**ocfg), clip)
    state = jopt.init(jax.tree.map(jnp.asarray, tree))
    state = jax.tree.map(  # every count (Adam's and the schedule's) = 3
        lambda leaf: jnp.asarray(count, leaf.dtype) if leaf.ndim == 0 else leaf, state)
    adam = [s for s in state if isinstance(s, optax.ScaleByAdamState)][0]
    state = tuple(s._replace(mu=jax.tree.map(jnp.asarray, mu),
                             nu=jax.tree.map(jnp.asarray, nu))
                  if isinstance(s, optax.ScaleByAdamState) else s for s in state)
    updates, new_state = jopt.update(jax.tree.map(jnp.asarray, grads), state,
                                     jax.tree.map(jnp.asarray, tree))
    want = jax.device_get(optax.apply_updates(jax.tree.map(jnp.asarray, tree), updates))
    want_adam = [s for s in new_state if isinstance(s, optax.ScaleByAdamState)][0]
    assert int(adam.count) == count

    params = t_trainer.trainable(convert.params_from_numpy(tree, tcfg, "cpu"))
    opt = t_opt.make_optimizer(OptimizerConfig.make(**ocfg), params, clip)
    convert.adam_state_from_numpy(opt, count, mu, nu)
    flat_grads = convert.flatten(grads)
    for name, p in convert.flatten(params).items():
        p.grad = torch.from_numpy(flat_grads[name].copy())
    metrics = opt.step(count)
    for a, b in zip(jax.tree.leaves(to_numpy(params)), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    back = convert.adam_state_to_numpy(opt)
    assert back["count"] == count + 1 == int(want_adam.count)
    for a, b in zip(jax.tree.leaves(back["mu"]), jax.tree.leaves(jax.device_get(want_adam.mu))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    for a, b in zip(jax.tree.leaves(back["nu"]), jax.tree.leaves(jax.device_get(want_adam.nu))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               float(optax.global_norm(grads)), rtol=1e-6)
    np.testing.assert_allclose(metrics["update_norm"].item(),
                               float(optax.global_norm(updates)), rtol=1e-4)


def test_adam_state_round_trip():
    jcfg, tcfg = both()
    tree = jax_params(jcfg)
    params = t_trainer.trainable(convert.params_from_numpy(tree, tcfg, "cpu"))
    opt = t_opt.make_optimizer(OptimizerConfig(), params)
    convert.adam_state_from_numpy(opt, 5, tree, jax.tree.map(np.abs, tree))
    back = convert.adam_state_to_numpy(opt)
    assert back["count"] == 5
    for a, b in zip(jax.tree.leaves(back["mu"]), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


# -- the train step against JAX's ------------------------------------------------

def _batches(n, b=4, t=32, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, 96, (b, t + 1)).astype(np.int32)
        out.append((tok[:, :-1], tok[:, 1:]))
    return out


@pytest.mark.parametrize("attention,grad_accum", [("flash", 1), ("einsum", 1),
                                                  ("flash", 2)])
def test_three_train_steps_match_jax(attention, grad_accum):
    jcfg, tcfg = both(attention)
    tree = jax_params(jcfg)
    ocfg = dict(learning_rate=1e-3)
    jopt_cfg = JOptConfig(**ocfg)
    sched = j_opt.lr_schedule(jopt_cfg)
    jopt = j_opt.make_optimizer(jopt_cfg, 1.0, schedule=sched)
    jstep = jax.jit(j_trainer.make_train_step(jcfg, jopt, grad_accum=grad_accum,
                                              lr_fn=sched))
    jtree = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jtree, "opt_state": jopt.init(jtree),
              "step": jnp.asarray(0, jnp.int32)}

    params = t_trainer.trainable(convert.params_from_numpy(tree, tcfg, "cpu"))
    state = t_trainer.TrainState(params, t_opt.make_optimizer(
        OptimizerConfig.make(**ocfg), params, 1.0))
    tstep = t_trainer.make_train_step(tcfg, grad_accum=grad_accum,
                                      lr_fn=t_opt.lr_schedule(OptimizerConfig.make(**ocfg)))
    for x, y in _batches(3):
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)), jax.random.key(0))
        tm = tstep(state, (torch.from_numpy(x).long(), torch.from_numpy(y).long()))
        for key in ("loss", "grad_norm", "update_norm", "lr"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]), rtol=1e-5)
    assert state.step == int(jstate["step"]) == 3
    got = np.concatenate([a.ravel() for a in jax.tree.leaves(to_numpy(state.params))])
    want = np.concatenate([a.ravel() for a in jax.tree.leaves(
        jax.device_get(jstate["params"]))])
    start = np.concatenate([a.ravel() for a in jax.tree.leaves(tree)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want - start)


def test_eval_step_is_the_forward_loss():
    jcfg, tcfg = both()
    tree = jax_params(jcfg)
    params = t_trainer.trainable(convert.params_from_numpy(tree, tcfg, "cpu"))
    state = t_trainer.TrainState(params, t_opt.make_optimizer(OptimizerConfig(), params))
    (x, y), = _batches(1)
    got = t_trainer.make_eval_step(tcfg)(state, (torch.from_numpy(x).long(),
                                                 torch.from_numpy(y).long()))
    want = j_trainer.make_eval_step(jcfg)({"params": jax.tree.map(jnp.asarray, tree)},
                                          (jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert not got.requires_grad


def test_deterministic_iff_every_dropout_is_zero():
    assert t_trainer.deterministic(GPTConfig.make(**SMALL))
    for key in ("embd_pdrop", "resid_pdrop", "attn_pdrop"):
        assert not t_trainer.deterministic(GPTConfig.make(**dict(SMALL, **{key: 0.1})))


# -- data ---------------------------------------------------------------------

TEXT = open(os.path.join(REPO, "data", "input.txt"), encoding="utf-8").read()[:6000]


def _views(block=16):
    jds = j_data.CharDataset(JDataConfig(block_size=block), text=TEXT)
    tds = t_data.CharDataset(DataConfig.make(block_size=block), text=TEXT)
    assert jds.stoi == tds.stoi
    np.testing.assert_array_equal(jds.data, tds.data)
    return jds.split(), tds.split()


@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_order_matches_jax_and_resumes(shuffle):
    (jtrain, _), (ttrain, _) = _views()
    jit = j_data.ShardedBatchIterator(jtrain, 64, shuffle=shuffle, seed=5)
    tit = t_data.ShardedBatchIterator(ttrain, 64, shuffle=shuffle, seed=5)
    assert jit.steps_per_epoch == tit.steps_per_epoch
    n = jit.steps_per_epoch + 3  # into the second epoch
    jb = [b for _ in range(2) for b in jit.epoch_batches()][:n]
    tb = [b for _ in range(2) for b in tit.epoch_batches()][:n]
    for (jx, jy), (tx, ty) in zip(jb, tb):
        np.testing.assert_array_equal(jx, tx)
        np.testing.assert_array_equal(jy, ty)
    # resume mid-epoch from a saved position, in both packages
    pos = dict(epoch=1, step_in_epoch=2, seed=5)
    jit.state = j_data.IteratorState.from_dict(pos)
    tit.state = t_data.IteratorState.from_dict(t_data.IteratorState(**pos).to_dict())
    jrest, trest = list(jit.epoch_batches()), list(tit.epoch_batches())
    assert len(jrest) == len(trest) == jit.steps_per_epoch - 2
    for (jx, _), (tx, _) in zip(jrest, trest):
        np.testing.assert_array_equal(jx, tx)
    assert tit.state.to_dict() == jit.state.to_dict()


def test_windows_and_split_match_jax():
    (jtrain, jtest), (ttrain, ttest) = _views()
    assert (len(jtrain), len(jtest)) == (len(ttrain), len(ttest))
    idx = np.array([0, 5, len(ttest) - 1])
    for a, b in zip(jtest.gather(idx), ttest.gather(idx)):
        np.testing.assert_array_equal(a, b)


def test_prefetch_yields_in_order_and_reraises():
    assert list(PrefetchIterator(iter(range(20)), depth=3)) == list(range(20))

    def broken():
        yield 1
        raise KeyError("source failed")

    it = PrefetchIterator(broken())
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)
    slow = PrefetchIterator(iter(range(100)), depth=1)
    next(slow)
    slow.close()
    assert not slow._thread.is_alive()


def test_step_line_and_jsonl_sink(tmp_path, capsys):
    _, tcfg = both()
    log = t_metrics.MetricsLogger(tcfg, jsonl_path=str(tmp_path / "m.jsonl"), peak=1e12)
    log.log_step(1, 64, 32, {"loss": 2.5, "lr": 1e-3})
    rec = log.log_step(3, 64, 32, {"loss": 2.0, "lr": 1e-3})
    log.close()
    assert rec["tokens_per_sec"] > 0 and rec["mfu"] > 0
    assert capsys.readouterr().out.splitlines()[1].startswith("step 3 | loss 2 |")
    lines = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    assert [x["step"] for x in lines] == [1, 3] and lines[0]["kind"] == "train_step"
    assert "mfu" not in lines[0] and lines[1]["mfu"] == rec["mfu"]


def test_flops_per_token_matches_jax():
    jcfg, tcfg = both(n_kv_head=2)
    assert t_metrics.flops_per_token(tcfg, 32) == j_metrics.flops_per_token(jcfg, 32)
    assert t_metrics.peak_flops("NVIDIA H100 80GB HBM3", "bfloat16") == 989e12
    assert t_metrics.peak_flops("cpu", "bfloat16") is None


# -- trainer: snapshots, preemption, entry point ----------------------------------

def _trainer(tmp_path, max_steps, **kw):
    data = t_data.CharDataset(DataConfig.make(block_size=32), text=TEXT)
    train, test = data.split()
    gcfg = GPTConfig.make(**dict(SMALL, vocab_size=data.vocab_size, embd_pdrop=0.1,
                                 resid_pdrop=0.1))
    tcfg = TrainerConfig.make(batch_size=8, max_steps=max_steps, log_every=2,
                              eval_batches=2, snapshot_path=str(tmp_path / "snap.pt"),
                              **kw)
    return t_trainer.GPTTrainer(tcfg, gcfg, OptimizerConfig(learning_rate=1e-3),
                                train, test, device="cpu")


def test_snapshot_resume_equals_an_uninterrupted_run(tmp_path):
    whole = _trainer(tmp_path / "a", 6)
    whole.train()
    first = _trainer(tmp_path / "b", 3)
    first.train()
    resumed = _trainer(tmp_path / "b", 6)
    assert resumed.step == 3
    resumed.train()
    assert resumed.step == whole.step == 6
    for a, b in zip(t_gpt._leaves(resumed.state.params), t_gpt._leaves(whole.state.params)):
        assert torch.equal(a, b)
    assert resumed.train_iter.state == whole.train_iter.state
    assert torch.equal(resumed.generator.get_state(), whole.generator.get_state())


def test_snapshot_file_is_checked(tmp_path):
    """The legacy single file at the bare path (no manifest) loads, and a
    torn or foreign one raises."""
    path = str(tmp_path / "s.pt")
    assert t_ckpt.load_snapshot(path) is None
    open(path, "wb").write(t_ckpt.encode({"step": 3, "w": torch.arange(4.0)}))
    assert t_ckpt.load_snapshot(path)["step"] == 3
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-10])  # torn
    with pytest.raises(t_ckpt.SnapshotError, match="digest"):
        t_ckpt.load_snapshot(path)
    open(path, "wb").write(b"\x89msgpack or anything else")
    with pytest.raises(t_ckpt.SnapshotError, match="not a snapshot"):
        t_ckpt.load_snapshot(path)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def _cli(tmp_path, *extra):
    return ["--config", os.path.join(REPO, "gpt2_config.yaml"), "--device", "cpu",
            "gpt_config.n_layer=2", "gpt_config.n_head=4", "gpt_config.n_embd=64",
            "gpt_config.dtype=float32", "gpt_config.attn_pdrop=0",
            f"data_config.path={os.path.join(REPO, 'data', 'input.txt')}",
            "data_config.block_size=32", "data_config.truncate=0.2",
            "trainer_config.batch_size=16", "trainer_config.eval_batches=2",
            f"trainer_config.snapshot_path={tmp_path / 'snap.pt'}", *extra]


def test_entry_point_trains_on_the_cpu(tmp_path, capsys):
    assert t_train.main(_cli(tmp_path, "trainer_config.max_steps=40",
                             "trainer_config.log_every=10")) == 0
    out = capsys.readouterr().out
    losses = [float(line.split("| loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 4 and losses[-1] < losses[0] - 0.3
    assert "eval_loss" in out and os.path.exists(tmp_path / "snap.pt.manifest.json")
    assert t_train.main(_cli(tmp_path, "trainer_config.max_steps=42",
                             "trainer_config.log_every=1")) == 0
    assert "Resuming training from snapshot at epoch 0, step 40" in capsys.readouterr().out


def test_stop_request_snapshots_and_exits_75(tmp_path, monkeypatch, capsys):
    real = t_trainer.make_train_step

    def stepping_then_sigterm(*a, **k):
        step = real(*a, **k)

        def run(state, batch, generator=None):
            m = step(state, batch, generator)
            if state.step == 2:
                signal.raise_signal(signal.SIGTERM)  # the preemption notice
            return m
        return run

    monkeypatch.setattr(t_trainer, "make_train_step", stepping_then_sigterm)
    before = signal.getsignal(signal.SIGTERM)
    assert t_train.main(_cli(tmp_path, "trainer_config.max_steps=50")) == 75
    out = capsys.readouterr().out
    assert "SIGTERM received" in out and "preempted at step 2" in out
    assert t_ckpt.load_snapshot(str(tmp_path / "snap.pt"))["step"] == 2
    assert signal.getsignal(signal.SIGTERM) is before  # handler restored


def test_entry_point_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the CPU-only behaviour")
    argv = [a for a in _cli(tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.main(argv)


NOT_PORTED = {"zero_dp": True, "msgpack_gather_limit_mb": 1}
# ported since: the save refuses a gather above the limit
# (test_torch_sharded_train); ZeRO over dp (test_torch_zero)
PORTED_SINCE = {"msgpack_gather_limit_mb", "zero_dp"}


@pytest.mark.parametrize("option", sorted(NOT_PORTED))
def test_unported_trainer_options_raise(option):
    cfg = TrainerConfig.make(**{option: NOT_PORTED[option]})
    if option in PORTED_SINCE:
        assert option not in UNPORTED_TRAINER_OPTIONS
        cfg.check_ported()
        return
    assert option in UNPORTED_TRAINER_OPTIONS
    with pytest.raises(NotImplementedError, match=option):
        cfg.check_ported()


def test_every_unported_option_is_checked():
    assert set(NOT_PORTED) - PORTED_SINCE == set(UNPORTED_TRAINER_OPTIONS)


@pytest.mark.parametrize("mesh", [dict(tp=2), dict(dp=2), dict(fsdp=2), dict(sp=2),
                                  dict(pp=2), dict(ep=2)])
def test_multi_device_meshes_raise(mesh):
    """Every axis runs across processes (pp since item 12b.2): in one
    process a mesh of 2 does not fit; in a job of 2 it does."""
    cfg = TrainerConfig.make(mesh=mesh)
    with pytest.raises(ValueError, match="torch.distributed.run"):
        cfg.check_ported()
    cfg.check_ported(world_size=2)


def test_yaml_defaults_and_one_device_meshes_are_accepted():
    for dp in (1, -1):
        TrainerConfig.make(mesh=dict(dp=dp)).check_ported()
    from mingpt_distributed_tpu_torch.config import load_config

    cfg = load_config(os.path.join(REPO, "gpt2_config.yaml"))
    cfg.trainer_config.check_ported()
    assert cfg.trainer_config.mesh == MeshConfig(dp=-1)
    assert cfg.optimizer_config.weight_decay == 0.1
    assert dataclasses.asdict(cfg)["trainer_config"]["save_every"] == 3


def test_bpe_tokenizer_raises(tmp_path, capsys):
    """The BPE tokenizer is ported: the entry point trains on BPE tokens
    (the merges learned from the corpus); only an unknown tokenizer
    raises."""
    assert t_train.main(_cli(tmp_path, "data_config.tokenizer=bpe",
                             "data_config.bpe_vocab_size=300",
                             "trainer_config.max_steps=2",
                             "trainer_config.log_every=1")) == 0
    out = capsys.readouterr().out
    assert re.search(r"^data: \d+ tokens, vocab 300,", out, re.M)
    assert "step 2 | loss" in out
    from mingpt_distributed_tpu_torch.config import ConfigError

    with pytest.raises(ConfigError, match="unknown tokenizer"):
        t_train.main(_cli(tmp_path, "data_config.tokenizer=wordpiece"))


# ---------------------------------------------------------------------------
# trainer telemetry: the options that raised naming item 5
# ---------------------------------------------------------------------------


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _telemetry_run(tmp_path, option):
    """A 6-step CPU run of the entry point with one telemetry option on;
    what it wrote."""
    extra = {
        "spans_jsonl": [f"trainer_config.spans_jsonl={tmp_path / 'spans.jsonl'}"],
        "tensorboard_dir": [f"trainer_config.tensorboard_dir={tmp_path / 'tb'}"],
        "profile_dir": [f"trainer_config.profile_dir={tmp_path / 'prof'}",
                        "trainer_config.profile_steps=[2,4]"],
        "profile_steps": [f"trainer_config.profile_dir={tmp_path / 'prof'}",
                          "trainer_config.profile_steps=[1,3]"],
        "debug_nans": ["trainer_config.debug_nans=true"],
        "metrics_port": [f"trainer_config.metrics_port={_free_port()}"],
    }[option]
    assert t_train.main(_cli(tmp_path, "trainer_config.max_steps=6",
                             "trainer_config.log_every=3", *extra)) == 0
    return sorted(os.listdir(tmp_path))


@pytest.mark.parametrize("option", ["spans_jsonl", "tensorboard_dir", "profile_dir",
                                    "profile_steps", "debug_nans", "metrics_port"])
def test_trainer_telemetry_options_run(tmp_path, option, capsys):
    files = _telemetry_run(tmp_path, option)
    out = capsys.readouterr().out
    assert "Snapshot saved" in out
    if option == "spans_jsonl":
        recs = [json.loads(line) for line in open(tmp_path / "spans.jsonl")]
        steps = [r["step"] for r in recs if r.get("name") == "train.step"]
        assert steps == list(range(1, 7))
        assert {"train.eval", "train.snapshot"} <= {r.get("name") for r in recs}
        assert all(r["schema"] == "mingpt-telemetry/1" for r in recs)
    elif option == "tensorboard_dir":
        assert "tb" in files and os.listdir(tmp_path / "tb")
    elif option.startswith("profile"):
        first, last = (2, 4) if option == "profile_dir" else (1, 3)
        name = f"trace_steps_{first}-{last}.json"
        assert os.listdir(tmp_path / "prof") == [name]
        trace = json.load(open(tmp_path / "prof" / name))
        assert any("addmm" in e.get("name", "") or "mm" in e.get("name", "")
                   for e in trace["traceEvents"])
        assert f"profiler trace written to {tmp_path / 'prof' / name}" in out
    elif option == "metrics_port":
        assert "telemetry: serving /metrics and /healthz on http://127.0.0.1:" in out


def test_debug_nans_stops_at_the_first_non_finite_step(tmp_path, monkeypatch):
    """A NaN planted in step 3's loss: debug_nans raises FloatingPointError
    naming step 3 before its update, and the parameters keep step 2's
    values; without debug_nans the step runs and the NaN reaches them."""
    real = t_gpt.forward
    calls = {"n": 0}

    def poisoned(params, x, cfg, *a, **kw):
        logits, loss = real(params, x, cfg, *a, **kw)
        if loss is not None and torch.is_grad_enabled():
            calls["n"] += 1
            if calls["n"] == 3:
                loss = loss * float("nan")
        return logits, loss

    monkeypatch.setattr(t_gpt, "forward", poisoned)
    tr = _trainer(tmp_path, 5, debug_nans=True)
    with pytest.raises(FloatingPointError, match="step 3"):
        tr.train()
    assert tr.step == 2
    assert all(bool(torch.isfinite(p).all()) for p in t_gpt._leaves(tr.state.params))
    calls["n"] = 0
    tr2 = _trainer(tmp_path / "off", 3)
    tr2.train()
    assert not all(bool(torch.isfinite(p).all()) for p in t_gpt._leaves(tr2.state.params))


def test_metrics_port_serves_the_trainer_gauges(tmp_path):
    """metrics_port: /metrics carries the mingpt_train_* gauges of the
    logged steps through the strict parser, /healthz says ok, the debug
    routes answer 404 (item 16)."""
    import urllib.error
    import urllib.request

    tr = _trainer(tmp_path, 4, metrics_port=_free_port())
    tr.train()
    srv = tr.telemetry_server
    with urllib.request.urlopen(srv.url("/metrics"), timeout=10) as resp:
        parsed = telemetry.parse_prometheus(resp.read().decode())
    vals = {n: v for n, _, v in parsed["samples"]}
    assert vals["mingpt_train_step"] == 4 and vals["mingpt_train_loss"] > 0
    assert parsed["types"]["mingpt_train_mfu"] == "gauge"
    with urllib.request.urlopen(srv.url("/healthz"), timeout=10) as resp:
        assert json.loads(resp.read())["status"] == "ok"
    for path in ("/debug/flight", "/attrib"):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url(path), timeout=10)
        assert e.value.code == 404
    tr.close()
    assert tr.telemetry_server is None


# ---------------------------------------------------------------------------
# the C batch gather and dl_num_workers
# ---------------------------------------------------------------------------


def test_c_gather_equals_the_numpy_gather_and_the_jax_package():
    """data/csrc/native_batcher.c, built with gcc at first use into
    data/_build/, gathers the same (x, y) windows as the numpy gather and
    the JAX package's CharView.gather (its C extension when built, else its
    numpy path) over random starts of both views."""
    from mingpt_distributed_tpu_torch.data import native_batcher

    port = t_data.CharDataset(DataConfig.make(block_size=32), text=TEXT)
    jax_ds = j_data.CharDataset(JDataConfig(path="<inline>", block_size=32), text=TEXT)
    rng = np.random.default_rng(0)
    for view, jview in zip(port.split(), jax_ds.split()):
        idx = rng.integers(0, len(view), 64)
        x, y = view.gather(idx)
        xn, yn = view.gather_numpy(idx)
        xj, yj = jview.gather(idx)
        assert x.dtype == y.dtype == np.int32 and x.shape == (64, 32)
        np.testing.assert_array_equal(x, xn)
        np.testing.assert_array_equal(y, yn)
        np.testing.assert_array_equal(x, np.asarray(xj))
        np.testing.assert_array_equal(y, np.asarray(yj))
    lib = native_batcher.library_path()
    assert lib.exists() and lib.parent.name == "_build"


def test_c_gather_refuses_windows_outside_the_corpus():
    from mingpt_distributed_tpu_torch.data import native_batcher

    data = np.arange(100, dtype=np.int32)
    np.testing.assert_array_equal(native_batcher.gather_windows(data, [0, 90], 9),
                                  np.stack([data[0:10], data[90:100]]))
    for bad in ([91], [-1], [0, 95]):
        with pytest.raises(IndexError, match="out of range"):
            native_batcher.gather_windows(data, bad, 9)
    with pytest.raises(ValueError, match="int32"):
        native_batcher.gather_windows(data.astype(np.int64), [0], 9)


def test_c_gather_from_many_threads_at_once():
    """Eight threads gather at once (the GIL is released in the C loop, and
    the library is built and loaded once under a lock), each equal to the
    numpy gather."""
    import sys
    import threading

    view = t_data.CharDataset(DataConfig.make(block_size=32), text=TEXT).split()[0]
    errors = []

    def work(seed):
        try:
            idx = np.random.default_rng(seed).integers(0, len(view), 256)
            for _ in range(20):
                x, y = view.gather(idx)
                xn, yn = view.gather_numpy(idx)
                assert np.array_equal(x, xn) and np.array_equal(y, yn)
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors


def test_dl_num_workers_is_accepted_as_in_the_jax_package(tmp_path):
    TrainerConfig.make(dl_num_workers=2).check_ported()
    tr = _trainer(tmp_path, 2, dl_num_workers=2)
    tr.train()
    assert tr.step == 2


# ---------------------------------------------------------------------------
# async_save
# ---------------------------------------------------------------------------


def _snapshot(tmp_path):
    return t_ckpt.load_snapshot(str(tmp_path / "snap.pt"))


def _assert_trees_equal(a, b):
    if torch.is_tensor(a):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        assert a == b


def test_async_snapshot_equals_a_synchronous_runs(tmp_path):
    """The snapshot an async_save run leaves when train() returns is the
    synchronous run's: parameters, Adam state, step, data position and
    generator. The host copy is whole: the parameters the writer saw are
    the step's, not the next update's."""
    sync = _trainer(tmp_path / "sync", 4)
    sync.train()
    tr = _trainer(tmp_path / "async", 4, async_save=True)
    tr.train()
    assert tr._save_thread is None  # joined before train() returned
    a, b = _snapshot(tmp_path / "async"), _snapshot(tmp_path / "sync")
    assert a["step"] == b["step"] == 4
    _assert_trees_equal(a["params"], b["params"])
    _assert_trees_equal(a["opt_state"], b["opt_state"])
    _assert_trees_equal({k: a[k] for k in ("epoch", "data_state", "generator")},
                        {k: b[k] for k in ("epoch", "data_state", "generator")})
    # a later in-place update does not reach the copy the writer was given
    snap = t_trainer._host_copy({"w": tr.state.params["wte"]})
    with torch.no_grad():
        tr.state.params["wte"].add_(1.0)
    assert not torch.equal(snap["w"], tr.state.params["wte"])


def test_async_writer_failure_is_reraised_at_the_next_save_and_at_return(
        tmp_path, monkeypatch, capsys):
    """Every write through a fault-injecting file system fails; the writer
    thread keeps the error, the next save re-raises it before writing, and
    train() re-raises at its end."""
    from mingpt_distributed_tpu_torch.training import faults

    faulty = faults.FaultInjectionFileSystem("write:every=1", sleep=lambda _: None)
    real = t_ckpt.save_snapshot
    monkeypatch.setattr(t_ckpt, "save_snapshot",
                        lambda *a, **k: real(*a, fs=faulty, **k))
    tr = _trainer(tmp_path, 2, async_save=True, io_retries=1, io_retry_delay_s=0.0)
    with pytest.raises(RuntimeError, match="async snapshot write") as e:
        tr.train()
    assert isinstance(e.value.__cause__, OSError)
    tr.save_snapshot(0)  # starts a write that fails in the thread
    tr._save_thread.join(timeout=60)
    with pytest.raises(RuntimeError, match="async snapshot write"):
        tr.save_snapshot(0)
    tr._join_pending_save()  # nothing pending, nothing kept
    assert "Snapshot saved" not in capsys.readouterr().out


def test_resume_from_an_async_snapshot(tmp_path):
    whole = _trainer(tmp_path / "a", 6)
    whole.train()
    _trainer(tmp_path / "b", 3, async_save=True).train()
    resumed = _trainer(tmp_path / "b", 6, async_save=True)
    assert resumed.step == 3
    resumed.train()
    for a, b in zip(t_gpt._leaves(resumed.state.params), t_gpt._leaves(whole.state.params)):
        assert torch.equal(a, b)
