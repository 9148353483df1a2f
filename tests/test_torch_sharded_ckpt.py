"""Sharded directory snapshots in the port
(``training/checkpoint_sharded.py``), on 4 gloo CPU ranks and in one
process, against the JAX package's Orbax backend.

The ranks run ``tests/test_trainer.py``'s setup (the inline corpus, vocab
25, block 16, global batch 16, AdamW lr 1e-2, clip 1.0, seed 7, n_layer 2,
n_head 2, n_embd 32, no dropout, fp32) from the JAX trainer's initial
parameters:

* 3 steps at fsdp 2 x tp 2 end in a directory snapshot and, of the same
  state, a one-file one; the directory restores at dp 4, is saved again
  there and restores at pp 2 x dp 2. Every parameter and Adam moment, and
  the one-process ``restore_inference_params`` of the first directory, is
  bit-equal to the one-file snapshot's. Each slice is written once: the
  data files hold the whole state's bytes together and each rank's file at
  most what the rank holds.
* ``test_orbax_backend_resume`` at fsdp 2 x tp 2: 4 steps, a directory
  snapshot and a resume to 8 end at the eval loss of an uninterrupted
  8-step run, and of the JAX trainer's (which runs at dp 2 x fsdp 4 with
  its Orbax directory), within 1e-5.
* With ``msgpack_gather_limit_mb=0`` the one-file save refuses on every
  rank, advising the directory backend; a directory saves and restores.

In one process: a transient write is retried and a torn one is refused on
load, through the fault-injecting file system (the port's ``faulty://``);
a JAX Orbax directory, written by the JAX trainer here, raises naming its
format; ``async_save`` and ``zero_dp`` with a directory raise the JAX
trainer's ``ConfigError``s.
"""

import concurrent.futures
import json
import os

import jax
import numpy as np
import pytest

from mingpt_distributed_tpu.config import MeshConfig as JMeshConfig
from mingpt_distributed_tpu_torch.config import ConfigError
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.parallel.spawn import run_ranks
from mingpt_distributed_tpu_torch.training import checkpoint_sharded as cs
from mingpt_distributed_tpu_torch.training.durability import SnapshotIntegrityError
from mingpt_distributed_tpu_torch.training.faults import FaultInjectionFileSystem
from tests import test_trainer as tt
from tests import torch_pp_workers as W
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

FSDP_TP = dict(dp=1, fsdp=2, tp=2)


def _jax_orbax(tmp):
    """The JAX trainer's uninterrupted 8-step run at dp 2 x fsdp 4 with an
    Orbax directory snapshot: its eval loss on the first test batch."""
    from tests.test_trainer import _fresh_eval_batch

    jtr = tt.make_trainer(tmp, mesh_cfg=JMeshConfig(dp=2, fsdp=4, tp=1, sp=1),
                          snapshot="ofull.ckpt", max_steps=8, max_epochs=1)
    assert jtr.ckpt_backend == "orbax"
    jtr.train()
    return float(jax.device_get(jtr._eval_step(
        jtr.state, jtr._put_batch(next(_fresh_eval_batch(jtr))))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    tmp = tmp_path_factory.mktemp("sharded_ckpt")
    start = tt.make_trainer(tmp, snapshot="start.msgpack")
    tree = jax.device_get(start.state["params"])
    todo = [("ckpt_reshard", (tt.CORPUS, str(tmp), tree)),
            ("ckpt_resume", (tt.CORPUS, str(tmp), tree, FSDP_TP)),
            ("ckpt_gather_limit", (tt.CORPUS, str(tmp)))]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, W.jobs, 4, (todo,), timeout_s=300)
        jax_loss = _jax_orbax(tmp)
        per_rank = ranks.result()
    cfg_kw = dict(n_layer=2, n_head=2, n_embd=32, vocab_size=tree["wte"].shape[0],
                  block_size=16)
    one_step, one_params = W.ckpt_one_process(str(tmp / "reshard_22"), cfg_kw)
    return dict(tmp=tmp, tree=tree, jax_loss=jax_loss, cfg_kw=cfg_kw,
                reshard=[r[0] for r in per_rank], resume=[r[1] for r in per_rank],
                limit=[r[2] for r in per_rank], one_step=one_step, one_params=one_params)


def _assert_bit_equal(got, want, what):
    assert set(got) == set(want), what
    for name, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[name].dtype == w.dtype and np.array_equal(got[name], w), \
                f"{what}: {name}"
        else:
            assert got[name] == w, f"{what}: {name}"


def test_a_2x2_directory_restores_at_dp4_then_pp2_dp2_bit_equal_to_one_file(runs):
    one_file = runs["reshard"][0]["one_file"]
    assert one_file["adam_count"] == 3
    for r in runs["reshard"]:
        _assert_bit_equal(r["fsdp_tp"], one_file, "fsdp 2 x tp 2, as saved")
        for mesh in ("dp4", "pp2_dp2"):
            assert r[mesh]["step"] == 3, mesh
            _assert_bit_equal(r[mesh]["leaves"], one_file, mesh)
            assert np.isfinite(r[mesh]["eval_loss"])
        assert r["pp2_dp2"]["wq"][0] == 1  # its stage's layer
        np.testing.assert_allclose(r["pp2_dp2"]["eval_loss"], r["dp4"]["eval_loss"],
                                   rtol=1e-5)


def test_each_slice_is_written_once_and_no_rank_writes_more_than_it_holds(runs):
    written = runs["reshard"][0]["written"]
    one_file = runs["reshard"][0]["one_file"]
    whole = sum(v.nbytes for v in one_file.values() if isinstance(v, np.ndarray))
    assert sorted(written) == [f"__{r}_0.distcp" for r in range(4)]
    assert sum(written.values()) == whole
    for r, rec in enumerate(runs["reshard"]):
        assert 0 < written[f"__{r}_0.distcp"] <= rec["held_bytes"]
    assert all(rec["held_bytes"] < whole / 2 for rec in runs["reshard"])


def test_restore_inference_params_reads_a_directory_in_one_process(runs):
    one_file = runs["reshard"][0]["one_file"]
    assert runs["one_step"] == 3
    _assert_bit_equal({f"params/{n}": v for n, v in runs["one_params"].items()},
                      {k: v for k, v in one_file.items() if k.startswith("params/")},
                      "restore_inference_params")


def test_directory_resume_matches_the_jax_orbax_resume(runs):
    """The port's counterpart of ``test_orbax_backend_resume``: the resumed
    run's eval loss equals the uninterrupted run's and the JAX trainer's."""
    for r in runs["resume"]:
        assert r["resumed_at"] == 4
        np.testing.assert_allclose(r["resumed"], r["full"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["full"], runs["jax_loss"], rtol=1e-5, atol=1e-5)


def test_gather_limit_advice_followed_to_a_successful_save(runs):
    """F3: the one-file save above the limit refuses on every rank, naming
    the directory backend; a directory snapshot_path then saves (no gather)
    and restores."""
    for r in runs["limit"]:
        assert r["refusal"] is not None
        assert "sharded directory backend" in r["refusal"]
        assert "msgpack_gather_limit_mb" in r["refusal"]
        assert r["resumed_at"] == 2 and r["equal"]


def test_a_jax_orbax_directory_raises_naming_its_format(runs):
    path = str(runs["tmp"] / "ofull.ckpt")
    assert os.path.isdir(path)
    with pytest.raises(cs.ForeignCheckpointError, match="JAX Orbax checkpoint"):
        cs.read_meta(path)
    with pytest.raises(cs.ForeignCheckpointError, match="JAX Orbax checkpoint"):
        W.corpus_trainer(tt.CORPUS, path, 1, dict(dp=-1))


def _one_process_save(tmp, name, faults):
    tr = W.corpus_trainer(tt.CORPUS, str(tmp / name), 2, dict(dp=-1), io_retry_delay_s=0.0)
    tr.train()
    fs = FaultInjectionFileSystem(faults)
    cs.save(tr.snapshot_path, tr.state.params, tr.state.optimizer, None,
            tr._snapshot_meta(0), tr._retry, fs=fs)
    return tr


def test_a_transient_write_is_retried(tmp_path, capsys):
    tr = _one_process_save(tmp_path, "transient", f"write:nth=1:match={cs.META}")
    assert "[durability] transient sharded save" in capsys.readouterr().out
    back = W.corpus_trainer(tt.CORPUS, tr.snapshot_path, 2, dict(dp=-1))
    assert back.step == 2
    for n, p in convert.flatten(tr.state.params).items():
        assert np.array_equal(convert.flatten(back.state.params)[n].detach().numpy(),
                              p.detach().numpy()), n


def test_a_torn_write_is_refused_on_load(tmp_path):
    tr = _one_process_save(tmp_path, "torn_meta", f"write:nth=1:mode=truncate:match={cs.META}")
    with pytest.raises(SnapshotIntegrityError, match="torn or corrupt"):
        W.corpus_trainer(tt.CORPUS, tr.snapshot_path, 2, dict(dp=-1))
    # a data file cut short after the commit: the sizes in META disagree
    tr = _one_process_save(tmp_path, "torn_data", "")
    data = os.path.join(tr.snapshot_path, "__0_0.distcp")
    with open(data, "r+b") as f:
        f.truncate(os.path.getsize(data) // 2)
    with pytest.raises(SnapshotIntegrityError, match="torn or partial"):
        cs.read_meta(tr.snapshot_path)


def test_missing_or_empty_directory_is_a_fresh_start_and_meta_is_json(tmp_path):
    assert cs.read_meta(str(tmp_path / "none")) is None
    # a one-file snapshot under a suffix-less path is never taken for none
    (tmp_path / "legacy").write_bytes(b"x")
    with pytest.raises(cs.ForeignCheckpointError, match="one-file snapshot"):
        cs.read_meta(str(tmp_path / "legacy"))
    (tmp_path / "empty").mkdir()
    tr = W.corpus_trainer(tt.CORPUS, str(tmp_path / "empty"), 1, dict(dp=-1))
    assert tr.step == 0
    tr.train()
    meta = json.loads((tmp_path / "empty" / cs.META).read_text())
    assert meta["format"] == cs.FORMAT and meta["step"] == 1 and meta["adam_count"] == 1
    assert not os.path.exists(str(tmp_path / "empty") + ".tmp")


@pytest.mark.parametrize("path, sharded", [("a/snap.pt", False), ("snap.msgpack", False),
                                           ("ckpt", True), ("runs/ckpt.d/", True),
                                           ("gpt_snapshot.pt", False)])
def test_backend_rule(path, sharded):
    assert cs.is_sharded_path(path) is sharded


def test_async_save_with_a_directory_is_refused(tmp_path):
    with pytest.raises(ConfigError, match="async_save=True only applies to the one-file"):
        W.corpus_trainer(tt.CORPUS, str(tmp_path / "dir"), 1, dict(dp=-1), async_save=True)


def test_zero_dp_with_a_directory_is_refused_with_the_jax_reason(tmp_path):
    with pytest.raises(ConfigError, match="would persist the view layout"):
        W.corpus_trainer(tt.CORPUS, str(tmp_path / "dir"), 1, dict(dp=-1), zero_dp=True)
