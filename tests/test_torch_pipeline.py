"""Pipeline parallelism in the port (``parallel/pipeline.py``), on 8 gloo
CPU ranks, against the JAX package.

One counterpart for each case of ``tests/test_pipeline.py``, on that file's
inputs (``cfg_and_inputs``: n_layer 4, n_head 2, n_embd 32, vocab 64,
block 16, batch 8, float32, the JAX parameters and tokens of keys 0 and
1). Every port mesh uses the 8 ranks: where the JAX case runs on fewer
devices, dp (or the batch) grows to fill them, which leaves what the case
checks unchanged. The JAX side runs in the parent while the ranks work:
the dense forward and gradients (the reference of every case), the JAX
pipeline itself where the pipeline's routing differs from dense (MoE), and
the JAX trainers.

Tolerances: the loss within 1e-5 relative and the logits within 1e-5 of
the dense JAX forward; gradients within 2e-4; MoE losses within 1e-4 of
dense (JAX's own: a microbatch routes its tokens alone) and 1e-5 of the
JAX pipeline; trainer losses within 2e-4 of the JAX pp trainer, as
``test_pp_trainer_matches_dp``. 1F1B equals GPipe bit for bit. In place of
``test_pp_schedule_cost_model_is_measured`` (XLA's memory analysis), the
schedule's own count of live microbatch graphs: at most 2(pp-1)+1 under
1F1B, and below GPipe's m at pp 2, m 8.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mingpt_distributed_tpu.config import GPTConfig as JGPTConfig
from mingpt_distributed_tpu.config import MeshConfig as JMeshConfig
from mingpt_distributed_tpu.models import gpt as j_gpt
from mingpt_distributed_tpu.parallel import mesh as j_mesh
from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models import convert, gpt
from mingpt_distributed_tpu_torch.parallel import pipeline
from mingpt_distributed_tpu_torch.parallel.spawn import run_ranks
from tests import test_trainer as tt
from tests import torch_pp_workers as W
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLD = 8
BASE = dict(n_layer=4, n_head=2, n_embd=32, vocab_size=64, block_size=16,
            embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
MOE = dict(n_experts=2, moe_top_k=1, moe_capacity_factor=4.0)
LLAMA = dict(rope=True, swiglu=True, rmsnorm=True, tie_weights=True)
LOSS_TOL = dict(rtol=1e-5, atol=0)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
TRAIN_TOL = dict(rtol=2e-4, atol=2e-4)
LR = 1e-2
STEPS = 6
# name: (kind, model, mesh, batch, same rows in every batch row)
CASES = {
    "forward": ("forward", {}, dict(pp=4, dp=2), 8, False),
    "gradients": ("grads", {}, dict(pp=4, dp=2), 8, False),
    "more_microbatches": ("forward", dict(n_layer=2, pp_microbatches=4), dict(pp=2, dp=4),
                          16, False),
    "rope_llama": ("forward", dict(LLAMA, n_kv_head=1), dict(pp=4, dp=2), 8, False),
    "dropout": ("dropout", dict(n_layer=2, resid_pdrop=0.5, pp_microbatches=2),
                dict(pp=2, dp=4), 16, True),
    "ring_sp": ("forward", dict(attention="ring"), dict(pp=2, sp=4), 8, False),
    "ulysses_sp": ("forward", dict(attention="ulysses"), dict(pp=2, dp=2, sp=2), 8, False),
    "ring_sp_gradients": ("grads", dict(attention="ring"), dict(pp=2, sp=4), 8, False),
    "moe": ("forward", MOE, dict(pp=2, dp=4), 8, False),
    "ep": ("forward", MOE, dict(pp=2, dp=2, ep=2), 8, False),
    "ep_shapes": ("moe_shapes", MOE, dict(pp=2, dp=2, ep=2), 8, False),
    "ep_gradients": ("grads", MOE, dict(pp=2, dp=2, ep=2), 8, False),
    "tp_forward": ("forward", {}, dict(pp=2, dp=2, tp=2), 8, False),
    "tp_gradients": ("grads", {}, dict(pp=2, dp=2, tp=2), 8, False),
    "tp_swiglu_llama": ("forward", LLAMA, dict(pp=2, dp=2, tp=2), 8, False),
    "tp_fsdp_shapes": ("shapes", {}, dict(pp=2, fsdp=2, tp=2), 8, False),
    "1f1b_forward": ("forward", dict(pp_schedule="1f1b", pp_microbatches=4),
                     dict(pp=4, dp=2), 8, False),
    "1f1b_gradients": ("grads", dict(pp_schedule="1f1b", pp_microbatches=4),
                       dict(pp=4, dp=2), 8, False),
    "1f1b_tp_gradients": ("grads", dict(pp_schedule="1f1b"), dict(pp=2, dp=2, tp=2), 8,
                          False),
    "1f1b_vs_gpipe_dropout": ("schedules", dict(n_layer=2, resid_pdrop=0.3,
                                                pp_microbatches=2), dict(pp=2, dp=4), 8, True),
    "1f1b_moe_aux_gradients": ("grads", dict(MOE, pp_schedule="1f1b"), dict(pp=2, dp=4), 8,
                               False),
    "tp_sp_forward": ("forward", dict(n_head=4, attention="ring"), dict(pp=2, tp=2, sp=2),
                      8, False),
    "tp_sp_gradients": ("grads", dict(n_head=4, attention="ring"), dict(pp=2, tp=2, sp=2),
                        8, False),
    "tp_flash_window_softcap": ("forward", dict(attention="flash", attention_window=8,
                                                attn_logit_softcap=10.0),
                                dict(pp=2, dp=2, tp=2), 8, False),
    "sp_attention_dropout": ("dropout_loss", dict(attention="ring", attn_pdrop=0.5),
                             dict(pp=2, sp=4), 8, False),
    "ulysses_attention_dropout": ("dropout_loss", dict(n_head=4, attention="ulysses",
                                                       attn_pdrop=0.3),
                                  dict(pp=2, dp=2, sp=2), 8, False),
    "schedule_peak": ("schedules", dict(n_embd=64, vocab_size=128, block_size=32,
                                        pp_microbatches=8), dict(pp=2, dp=4), 32, False),
}
SEEDS = {"dropout": dict(seed=3), "sp_attention_dropout": dict(seeds=[3, 3, 4]),
         "ulysses_attention_dropout": dict(seeds=[0])}
# the JAX pipeline's own meshes for the MoE cases (a microbatch routes alone)
JAX_PP = {"moe": JMeshConfig(pp=2, dp=4, fsdp=1, tp=1, sp=1),
          "ep": JMeshConfig(pp=2, dp=2, fsdp=1, tp=1, sp=1, ep=2)}
TRAINERS = {"pp2_dp2": (JMeshConfig(pp=2, dp=2, fsdp=1), dict(pp=2, dp=4)),
            "pp2_tp2_dp2": (JMeshConfig(pp=2, dp=2, fsdp=1, tp=2), dict(pp=2, dp=2, tp=2))}
# the port's pp 2 x dp 4 step with zero_dp, held against the JAX trainers
ZERO_MESH = dict(pp=2, dp=4)


def _model(name):
    kw = dict(BASE, **CASES[name][1])
    t = kw["block_size"]
    return kw, t


# what leaves the parameters and the dense reference unchanged
_SCHEDULE_KEYS = ("pp_schedule", "pp_microbatches", "attention")
_INIT: dict = {}
_DENSE: dict = {}


def _key(kw):
    return tuple(sorted((k, v) for k, v in kw.items() if k not in _SCHEDULE_KEYS))


def _inputs(name):
    """The JAX config, parameters (numpy) and tokens of a case:
    ``cfg_and_inputs`` with the case's model and batch (one init per
    model)."""
    kw, t = _model(name)
    jcfg = JGPTConfig.make(**kw)
    if _key(kw) not in _INIT:
        _INIT[_key(kw)] = jax.device_get(j_gpt.init(jax.random.key(0), jcfg))
    batch, same = CASES[name][3], CASES[name][4]
    if same:
        tokens = np.tile(np.arange(t, dtype=np.int32)[None] % kw["vocab_size"], (batch, 1))
    else:
        tokens = np.asarray(jax.random.randint(jax.random.key(1), (batch, t), 0,
                                               kw["vocab_size"]))
    return jcfg, _INIT[_key(kw)], tokens


def _dense(jcfg, params, tokens):
    """The dense JAX forward's logits and loss and the loss's gradients
    (once per model and tokens)."""
    # the oracle in place of the sp wrappers (no mesh) and the Pallas kernel
    cfg = dataclasses.replace(jcfg, attention="einsum")
    key = (_key(dataclasses.asdict(cfg)), tokens.tobytes())
    if key in _DENSE:
        return _DENSE[key]
    t = jnp.asarray(tokens)

    def loss_fn(p):
        return j_gpt.forward(p, t, cfg, targets=t)[1]

    logits, loss = j_gpt.forward(params, t, cfg, targets=t)
    grads = jax.grad(loss_fn)(params)
    _DENSE[key] = dict(logits=np.asarray(logits), loss=float(loss),
                       grads=convert.flatten(jax.device_get(grads)))
    return _DENSE[key]


def _jax_pp_loss(jcfg, params, tokens, mesh_cfg, devices):
    mesh = j_mesh.make_mesh(mesh_cfg, devices=devices)
    t = jnp.asarray(tokens)
    return float(jax.jit(lambda p: j_gpt.forward(p, t, jcfg, targets=t, mesh=mesh)[1])(params))


def _jax_trainer(tmp, mesh_cfg, name, steps=STEPS):
    """The JAX trainer (``test_trainer.make_trainer``): its initial
    parameters, first STEPS global batches and (``steps`` > 0) losses."""
    jtr = tt.make_trainer(tmp, mesh_cfg=mesh_cfg, snapshot=name, max_steps=STEPS,
                          log_every=1)
    params = jax.device_get(jtr.state["params"])
    batches, losses = [], []
    for xy in jtr.train_iter.epoch_batches():
        if len(batches) == STEPS:
            break
        batches.append(xy)
        if steps:
            jtr.state, m = jtr._train_step(jtr.state, jtr._put_batch(xy), jtr.base_rng)
            losses.append(float(jax.device_get(m["loss"])))
    return dict(params=params, batches=batches, losses=losses)


def _trainer_cfg_kw(vocab):
    return dict(n_layer=2, n_head=2, n_embd=32, vocab_size=vocab, block_size=16,
                embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    tmp = tmp_path_factory.mktemp("pipeline")
    inputs = {name: _inputs(name) for name in CASES}
    todo = []
    for name, (kind, _, mesh, _, _) in CASES.items():
        jcfg, params, tokens = inputs[name]
        todo.append(("pp_case", (dict(kind=kind, cfg=_model(name)[0], mesh=mesh, tree=params,
                                      tokens=tokens, targets=tokens, **SEEDS.get(name, {})),)))
    # the trainers' initial parameters and batches come from the JAX trainer
    # (one init: the mesh does not change it); the JAX trainers train after
    start = _jax_trainer(tmp, JMeshConfig(dp=-1), "start", steps=0)
    vocab = start["params"]["wte"].shape[0]
    for name, (_, mesh) in TRAINERS.items():
        todo.append(("pp_train", (_trainer_cfg_kw(vocab), mesh, start["params"],
                                  start["batches"], LR)))
    todo.append(("pp_train", (_trainer_cfg_kw(vocab), ZERO_MESH, start["params"],
                              start["batches"], LR, True)))
    todo.append(("pp_trainer", (tt.CORPUS, str(tmp), dict(pp=2, dp=4))))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, W.jobs, WORLD, (todo,), timeout_s=600)
        dense = {name: _dense(*inputs[name]) for name in CASES
                 if CASES[name][0] in ("forward", "grads", "moe_shapes", "shapes")}
        jax_pp = {name: _jax_pp_loss(*inputs[name], mesh_cfg, eight_devices)
                  for name, mesh_cfg in JAX_PP.items()}
        jax_trainers = {name: _jax_trainer(tmp, mesh_cfg, name)["losses"]
                        for name, (mesh_cfg, _) in TRAINERS.items()}
        jax_dp = _jax_trainer(tmp, JMeshConfig(dp=-1), "dp")
        per_rank = ranks.result()
    n = len(CASES)
    return dict(inputs=inputs, dense=dense, jax_pp=jax_pp, jax_dp=jax_dp["losses"],
                jax_trainers=jax_trainers,
                port={name: [r[i] for r in per_rank] for i, name in enumerate(CASES)},
                train={name: [r[n + i] for r in per_rank] for i, name in enumerate(TRAINERS)},
                zero=[r[n + len(TRAINERS)] for r in per_rank],
                trainer=[r[-1] for r in per_rank], tmp=tmp)


def _assemble(ranks, key="logits"):
    """The global (B, T, ...) array from the ranks of stage 0 and tp rank 0
    (each holds its rows and its sp chunk)."""
    parts = {}
    for r in ranks:
        if r["stage"] == 0 and r["tp_rank"] == 0:
            parts[(r["batch_index"], r["sp_rank"])] = r[key]
    nb = max(b for b, _ in parts) + 1
    ns = max(s for _, s in parts) + 1
    return np.concatenate([np.concatenate([parts[(b, s)] for s in range(ns)], axis=1)
                           for b in range(nb)], axis=0)


def _check_forward(runs, name, loss_tol=LOSS_TOL):
    want = runs["dense"][name]
    got = runs["port"][name]
    np.testing.assert_allclose(_assemble(got), want["logits"], **LOGIT_TOL)
    for r in got:
        assert r["loss"] == got[0]["loss"]  # every rank
    np.testing.assert_allclose(got[0]["loss"], want["loss"], **loss_tol)


def _check_grads(runs, name, tol=GRAD_TOL, loss_tol=LOSS_TOL):
    want = runs["dense"][name]
    got = runs["port"][name]
    np.testing.assert_allclose(got[0]["loss"], want["loss"], **loss_tol)
    assert set(got[0]["grads"]) == set(want["grads"])
    for r in got:
        for leaf, g in want["grads"].items():
            np.testing.assert_allclose(r["grads"][leaf], g, **tol, err_msg=leaf)


def test_pp_forward_matches_dense(runs):
    _check_forward(runs, "forward")


def test_pp_gradients_match_dense(runs):
    _check_grads(runs, "gradients")


def test_pp_more_microbatches_than_stages(runs):
    _check_forward(runs, "more_microbatches")


def test_pp_rope_llama_mode(runs):
    _check_forward(runs, "rope_llama")


def test_pp_dropout_decorrelated_across_microbatches(runs):
    """Identical rows everywhere: each rank holds 4 rows in 2 microbatches
    of 2, so rows 0 and 2 share everything but the microbatch index."""
    la = _assemble(runs["port"]["dropout"])
    assert not np.allclose(la[0], la[1], atol=1e-6)  # two rows of one microbatch
    assert not np.allclose(la[0], la[2], atol=1e-6)  # the regression: mb 0 vs mb 1


def test_pp_layer_indivisible_rejected(eight_devices):
    kw = dict(BASE, n_layer=3)
    jcfg = JGPTConfig.make(**kw)
    params = j_gpt.init(jax.random.key(0), jcfg)
    tokens = jax.random.randint(jax.random.key(1), (8, 16), 0, 64)
    mesh = j_mesh.make_mesh(JMeshConfig(pp=4, dp=2, fsdp=1, tp=1, sp=1),
                            devices=eight_devices)
    with pytest.raises(ValueError, match="not divisible by pp"):
        j_gpt.forward(params, tokens, jcfg, mesh=mesh)
    with pytest.raises(ValueError, match="not divisible by pp"):
        gpt.check_pipeline(GPTConfig.make(**kw), dict(pp=4, dp=2), 16)


def test_pp_trainer_matches_dp(runs):
    """make_train_step at pp 2 x dp 4 from the JAX trainer's parameters and
    batches: the JAX pp 2 x dp 2 trainer's losses, and the dp trainer's."""
    for r in runs["train"]["pp2_dp2"]:
        np.testing.assert_allclose(r["losses"], runs["jax_trainers"]["pp2_dp2"], **TRAIN_TOL)
        np.testing.assert_allclose(r["losses"], runs["jax_dp"], **TRAIN_TOL)
    assert runs["jax_dp"][-1] < runs["jax_dp"][0]


def test_pp_params_sharded_by_stage(runs):
    """GPTTrainer at pp 2 x dp 4: each rank holds its stage's half of the
    layer axis; it trains (the snapshot gathers over pp) and evaluates."""
    for r in runs["trainer"]:
        assert r["wq"][0] == r["wq_whole"][0] // 2
        assert np.isfinite(r["loss"]) and np.isfinite(r["eval_loss"])
        assert r["loss"] == runs["trainer"][0]["loss"]
    assert {r["stage"] for r in runs["trainer"]} == {0, 1}


def test_pp_with_zero_dp_matches_dp(runs):
    """pp 2 x dp 4 with the update sharded over dp (``zero_dp``): the JAX
    trainers' losses; and GPTTrainer's zero_dp snapshot at that mesh is
    the canonical one-file layout, which resumes in one process."""
    for r in runs["zero"]:
        np.testing.assert_allclose(r["losses"], runs["jax_trainers"]["pp2_dp2"], **TRAIN_TOL)
        np.testing.assert_allclose(r["losses"], runs["jax_dp"], **TRAIN_TOL)
    t0 = runs["trainer"][0]
    assert t0["zero_dp"] == 4 and np.isfinite(t0["zero_loss"])
    back = W.corpus_trainer(tt.CORPUS, str(runs["tmp"] / "pp_zero.pt"), 2, dict(dp=-1))
    assert back.step == 2
    for name, p in convert.flatten(back.state.params).items():
        assert np.array_equal(p.detach().numpy(), t0["zero_whole"][name]), name


def test_pp_with_ring_sp_matches_dense(runs):
    _check_forward(runs, "ring_sp")


def test_pp_with_ulysses_sp_matches_dense(runs):
    _check_forward(runs, "ulysses_sp")


def test_pp_with_ring_sp_gradients(runs):
    _check_grads(runs, "ring_sp_gradients")


def _check_moe(runs, name):
    got = runs["port"][name]
    for r in got:
        assert r["loss"] == got[0]["loss"]
    np.testing.assert_allclose(got[0]["loss"], runs["dense"][name]["loss"], rtol=1e-4)
    np.testing.assert_allclose(got[0]["loss"], runs["jax_pp"][name], **LOSS_TOL)


def test_pp_with_moe_matches_no_pp(runs):
    """pp 2 x dp 4, experts on every stage: the loss with the aux term
    within 1e-4 of the dense model (JAX's tolerance) and 1e-5 of the JAX
    pipeline (whose microbatches route alone, as the port's do)."""
    _check_moe(runs, "moe")


def test_pp_with_ep_matches_no_pp(runs):
    _check_moe(runs, "ep")


def test_pp_with_ep_keeps_experts_sharded_in_region(runs):
    """Each MoE call inside a stage holds E/ep = 1 expert and sends the
    tokens through the ep exchange; the router sees every expert."""
    for r in runs["port"]["ep_shapes"]:
        assert r["calls"], "moe_mlp never called inside the pipeline"
        for rec in r["calls"]:
            assert rec["ep_exchange"]
            assert rec["w_e1"][0] == 1, rec
            assert rec["router_e"] == 2, rec


def test_pp_ep_gradients_match_dense(runs):
    _check_grads(runs, "ep_gradients", loss_tol=dict(rtol=1e-4, atol=0))


def test_pp_ep_indivisible_experts_refused(eight_devices):
    kw = dict(BASE, n_experts=3, moe_top_k=1, moe_capacity_factor=4.0)
    jcfg = JGPTConfig.make(**kw)
    params = j_gpt.init(jax.random.key(0), jcfg)
    tokens = jax.random.randint(jax.random.key(1), (8, 16), 0, 64)
    mesh = j_mesh.make_mesh(JMeshConfig(pp=2, dp=2, fsdp=1, tp=1, sp=1, ep=2),
                            devices=eight_devices)
    with pytest.raises(ValueError, match="not divisible by ep"):
        j_gpt.forward(params, tokens, jcfg, targets=tokens, mesh=mesh)
    with pytest.raises(ValueError, match="not divisible by ep"):
        gpt.check_pipeline(GPTConfig.make(**kw), dict(pp=2, dp=2, ep=2), 16)


def test_pp_tp_forward_matches_dense(runs):
    _check_forward(runs, "tp_forward")


def test_pp_tp_gradients_match_dense(runs):
    _check_grads(runs, "tp_gradients")


def test_pp_tp_swiglu_llama_mode(runs):
    _check_forward(runs, "tp_swiglu_llama")


def test_pp_tp_fsdp_params_stay_sharded_inside_region(runs):
    """pp 2 x fsdp 2 x tp 2: each rank holds half of a stage's wq rows
    (fsdp) and columns (tp); the blocks compute with the fsdp rows gathered
    and the tp columns still split."""
    d, nhd, ffn = 32, 32, 128
    for r in runs["port"]["tp_fsdp_shapes"]:
        assert r["used"]["blocks/wq"] == (d, nhd // 2), r["used"]
        assert r["used"]["blocks/w_fc"] == (d, ffn // 2), r["used"]
        assert r["used"]["blocks/wo"] == (nhd // 2, d), r["used"]
        assert r["held"]["blocks/wq"] == (2, d // 2, nhd // 2), r["held"]
        np.testing.assert_allclose(r["loss"], runs["dense"]["tp_fsdp_shapes"]["loss"],
                                   **LOSS_TOL)


def test_pp_tp_trainer_matches_dp(runs):
    for r in runs["train"]["pp2_tp2_dp2"]:
        np.testing.assert_allclose(r["losses"], runs["jax_trainers"]["pp2_tp2_dp2"],
                                   **TRAIN_TOL)
        np.testing.assert_allclose(r["losses"], runs["jax_dp"], **TRAIN_TOL)


def test_1f1b_forward_matches_dense(runs):
    _check_forward(runs, "1f1b_forward")


def test_1f1b_gradients_match_dense(runs):
    _check_grads(runs, "1f1b_gradients")


def test_1f1b_with_tp_gradients(runs):
    _check_grads(runs, "1f1b_tp_gradients")


def test_1f1b_matches_gpipe_with_dropout(runs):
    """The same generator: the same loss and gradients, bit for bit, under
    both schedules (the same forwards; the backwards accumulate in the same
    order)."""
    for r in runs["port"]["1f1b_vs_gpipe_dropout"]:
        assert r["gpipe"]["loss"] == r["1f1b"]["loss"]
        for leaf, g in r["gpipe"]["grads"].items():
            assert np.array_equal(g, r["1f1b"]["grads"][leaf]), leaf
        # the last stage interleaves under 1F1B; stage 0 runs both alike at m 2
        assert (r["gpipe"]["actions"] != r["1f1b"]["actions"]) == (r["stage"] == 1)


def test_1f1b_with_moe_aux_gradients(runs):
    _check_grads(runs, "1f1b_moe_aux_gradients", loss_tol=dict(rtol=1e-4, atol=0))


def test_pp_tp_sp_triple_composition(runs):
    _check_forward(runs, "tp_sp_forward")
    _check_grads(runs, "tp_sp_gradients")


def test_pp_tp_flash_window_softcap(runs):
    """The flash path (its plain version on the CPU) with a window and a
    softcap inside the stages, against the JAX einsum oracle."""
    _check_forward(runs, "tp_flash_window_softcap")


def test_pp_sp_attention_dropout_runs(runs):
    for r in runs["port"]["sp_attention_dropout"]:
        l1, l1b, l2 = r["losses"]
        assert np.isfinite(l1) and l1 == l1b and l1 != l2
        assert r["grads_finite"]


def test_pp_ulysses_sp_attention_dropout_runs(runs):
    for r in runs["port"]["ulysses_attention_dropout"]:
        assert np.isfinite(r["losses"][0]) and r["grads_finite"]


def test_pp_dropout_decorrelated_across_dp(runs):
    """Rows 0 and 4 are the first row of dp ranks 0 and 1: the same
    microbatch index, different data coordinates."""
    la = _assemble(runs["port"]["dropout"])
    assert not np.allclose(la[0], la[4], atol=1e-6)


def test_pp_schedule_live_graphs_are_bounded(runs):
    """In place of XLA's memory analysis: the schedule counts the
    microbatch graphs each stage keeps alive. 1F1B keeps pp - stage (within
    JAX's 2(pp-1)+1 stage inputs), GPipe all m = 8; both give the same
    loss."""
    pp, m = 2, 8
    for r in runs["port"]["schedule_peak"]:
        got = r["1f1b"]["live_peak"]
        assert got == pp - r["stage"] <= 2 * (pp - 1) + 1
        assert got < r["gpipe"]["live_peak"] == m
        assert r["1f1b"]["loss"] == r["gpipe"]["loss"]


@pytest.mark.parametrize("schedule", pipeline.SCHEDULES)
@pytest.mark.parametrize("pp, m", [(2, 2), (2, 8), (4, 4), (4, 8), (4, 2)])
def test_schedule_actions_pair_every_send_with_its_receive(schedule, pp, m):
    """Every stage runs each microbatch's forward, then its backward, once;
    stage s's forward of i comes after stage s-1's and its backward after
    stage s+1's in a simulation where a stage blocks only on receives (no
    deadlock); the live graphs peak at pp - stage under 1F1B, m under
    GPipe."""
    acts = {s: pipeline.schedule_actions(schedule, pp, s, m) for s in range(pp)}
    for s, a in acts.items():
        assert sorted(a) == sorted([("F", i) for i in range(m)] + [("B", i) for i in range(m)])
        assert all(a.index(("F", i)) < a.index(("B", i)) for i in range(m))
        live = [sum(1 if k == "F" else -1 for k, _ in a[:j + 1]) for j in range(len(a))]
        assert max(live) == (m if schedule == "gpipe" else min(pp - s, m))
    done, pos = set(), {s: 0 for s in range(pp)}
    while any(pos[s] < len(acts[s]) for s in range(pp)):
        moved = False
        for s in range(pp):
            if pos[s] == len(acts[s]):
                continue
            kind, i = acts[s][pos[s]]
            need = ((s - 1, "F", i) if kind == "F" and s > 0 else
                    (s + 1, "B", i) if kind == "B" and s < pp - 1 else None)
            if need is None or need in done:
                done.add((s, kind, i))
                pos[s] += 1
                moved = True
        assert moved, f"deadlock at {pos}"


def test_microbatch_count_refuses_an_uneven_split():
    assert pipeline.microbatch_count(0, 4, 8) == 4
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        pipeline.microbatch_count(3, 2, 8)
