"""The port's durable snapshots (training/durability.py, training/faults.py,
training/checkpoint.py) against the JAX package's.

The pure functions are held against the JAX functions on the same inputs:
the error classification, the backoff delays of a seeded RetryPolicy and the
manifest's JSON. The rest ports ``tests/test_fault_tolerance.py``: retry,
give-up and never-retry; keep-last-K rotation; a truncated latest snapshot
falls back to the previous good one; all corrupt raises; the legacy single
file loads; missing means a fresh start; the fault injector's spec grammar,
failed and truncated writes, failed, missing and delayed reads. In the
probe that showed the port's fault (save steps 1 and 2, overwrite the last
8 bytes of the latest payload), both packages restore step 1. The trainer
keeps its last ``keep_snapshots`` and resumes past a corrupt one.
"""

import errno
import json
import os

import fsspec
import numpy as np
import pytest
import torch

from mingpt_distributed_tpu.training import checkpoint as j_ckpt
from mingpt_distributed_tpu.training import durability as j_dur
from mingpt_distributed_tpu.training import faults as j_faults  # registers faulty://
from mingpt_distributed_tpu_torch.config import DataConfig, GPTConfig, OptimizerConfig
from mingpt_distributed_tpu_torch.config import TrainerConfig
from mingpt_distributed_tpu_torch.data import char_dataset as t_data
from mingpt_distributed_tpu_torch.training import checkpoint as t_ckpt
from mingpt_distributed_tpu_torch.training import durability as dur
from mingpt_distributed_tpu_torch.training import faults
from mingpt_distributed_tpu_torch.training import trainer as t_trainer
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

NO_WAIT = dur.NO_WAIT


def snap(step=1, epoch=0, scale=1.0):
    return {"step": step, "epoch": epoch,
            "params": {"w": scale * torch.arange(6.0).reshape(2, 3)},
            "data_state": {"pos": step}}


def step_file(tmp_path, step):
    return str(tmp_path / f"snap.pt.step-{step:08d}")


@pytest.fixture()
def faulty():
    return faults.FaultInjectionFileSystem(sleep=lambda _: None)


# -- classification and retry ------------------------------------------------------

ERRORS = {
    "file_not_found": (FileNotFoundError("x"), dur.MISSING),
    "enoent": (OSError(errno.ENOENT, "no key"), dur.MISSING),
    "eio": (OSError(errno.EIO, "flaky"), dur.TRANSIENT),
    "timeout": (TimeoutError(), dur.TRANSIENT),
    "connection_reset": (ConnectionResetError(), dur.TRANSIENT),
    "permission": (PermissionError(), dur.PERMANENT),
    "is_a_directory": (IsADirectoryError(), dur.PERMANENT),
    "not_io": (ValueError("not io"), dur.PERMANENT),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_classify_io_error_matches_jax(name):
    exc, want = ERRORS[name]
    assert dur.classify_io_error(exc) == want == j_dur.classify_io_error(exc)
    assert dur.is_missing_error(exc) == j_dur.is_missing_error(exc)


def test_retry_transient_then_succeeds():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError(errno.EIO, "blip")
        return "ok"

    assert dur.with_retries(flaky, NO_WAIT) == "ok"
    assert calls["n"] == 3


def test_retry_gives_up_after_attempts():
    calls = {"n": 0}

    def always():
        calls["n"] += 1
        raise OSError(errno.EIO, "down")

    with pytest.raises(OSError):
        dur.with_retries(always, NO_WAIT)
    assert calls["n"] == NO_WAIT.attempts


@pytest.mark.parametrize("exc", [FileNotFoundError("gone"), PermissionError("denied")])
def test_retry_never_retries_missing_or_permanent(exc):
    calls = {"n": 0}

    def fail():
        calls["n"] += 1
        raise exc

    with pytest.raises(type(exc)):
        dur.with_retries(fail, NO_WAIT)
    assert calls["n"] == 1


def test_retry_sleeps_the_policys_delays():
    slept = []
    pol = dur.RetryPolicy(attempts=3, base_delay_s=0.5, seed=3, sleep=slept.append)

    def always():
        raise TimeoutError()

    with pytest.raises(TimeoutError):
        dur.with_retries(always, pol)
    assert slept == list(pol.delays()) and len(slept) == 2


@pytest.mark.parametrize("kw", [
    dict(attempts=4, base_delay_s=1.0, multiplier=2.0, max_delay_s=3.0, jitter=0.25, seed=7),
    dict(attempts=6, base_delay_s=0.5, seed=0),
    dict(attempts=1, base_delay_s=0.5, seed=1),
])
def test_backoff_delays_match_jax_and_are_seeded(kw):
    pol = dur.RetryPolicy(**kw)
    d1 = list(pol.delays())
    assert d1 == list(pol.delays()) == list(j_dur.RetryPolicy(**kw).delays())
    assert len(d1) == kw["attempts"] - 1
    base = [min(kw["base_delay_s"] * kw.get("multiplier", 2.0) ** i,
                kw.get("max_delay_s", 8.0)) for i in range(len(d1))]
    jitter = kw.get("jitter", 0.25)
    assert all((1.0 - jitter) * b <= d <= b for d, b in zip(d1, base))


# -- the manifest ----------------------------------------------------------------

def test_manifest_json_matches_jax():
    rows = [dict(key="snap.pt.step-00000002", step=2, epoch=0, sha256="ab" * 32, size=10),
            dict(key="snap.pt.step-00000003", step=3, epoch=1, sha256="cd" * 32, size=12)]
    ours = dur.Manifest([dur.ManifestEntry(**r) for r in rows])
    theirs = j_dur.Manifest([j_dur.ManifestEntry(**r) for r in rows])
    assert ours.to_json() == theirs.to_json()
    assert json.loads(ours.to_json())["latest"] == "snap.pt.step-00000003"
    back = dur.Manifest.from_json(theirs.to_json())
    assert [e.to_dict() for e in back.entries] == rows
    v1 = json.dumps({"version": 1, "latest": rows[0]["key"], "checkpoints": rows[:1]})
    assert dur.Manifest.from_json(v1).latest.step == 2
    with pytest.raises(ValueError, match="version"):
        dur.Manifest.from_json(json.dumps({"version": 9, "checkpoints": []}))


def test_object_keys_match_jax():
    for path in ("snap.pt", "/a/b/snap.pt"):
        assert dur.manifest_path(path) == j_dur.manifest_path(path)
        assert dur.object_key(path, 40) == j_dur.object_key(path, 40)


def test_sharded_manifest_entry_raises_not_implemented(tmp_path):
    path = str(tmp_path / "snap.pt")
    entry = dict(key="snap.pt.step-00000001.shard-0000-of-0002", step=1, epoch=0,
                 sha256="ab" * 32, size=4,
                 shards=[dict(key="k0", sha256="0" * 64, size=2)])
    with open(dur.manifest_path(path), "w") as f:
        f.write(json.dumps({"version": 2, "latest": entry["key"], "checkpoints": [entry]}))
    # sharded entries load since item 10 was ported: this one's shard object
    # is missing, so the whole entry fails verification (no older entry)
    with pytest.raises(dur.SnapshotIntegrityError, match="k0: unreadable"):
        t_ckpt.load_snapshot(path, retry=NO_WAIT)


def test_manifest_commit_rotation_keeps_last_k(tmp_path):
    path = str(tmp_path / "snap.pt")
    for step in (1, 2, 3, 4):
        t_ckpt.save_snapshot(path, snap(step=step, scale=float(step)), keep=3,
                             retry=NO_WAIT)
    assert sorted(os.listdir(tmp_path)) == [
        "snap.pt.manifest.json", "snap.pt.step-00000002", "snap.pt.step-00000003",
        "snap.pt.step-00000004"]  # step 1 rotated out; the bare path never written
    m = dur.load_manifest(path)
    assert [e.step for e in m.entries] == [2, 3, 4] and m.latest.step == 4
    got = t_ckpt.load_snapshot(path, retry=NO_WAIT)
    assert got["step"] == 4
    assert torch.equal(got["params"]["w"], snap(scale=4.0)["params"]["w"])


def test_resaving_a_step_replaces_its_entry(tmp_path):
    path = str(tmp_path / "snap.pt")
    t_ckpt.save_snapshot(path, snap(step=5, scale=1.0), retry=NO_WAIT)
    t_ckpt.save_snapshot(path, snap(step=5, scale=2.0), retry=NO_WAIT)
    assert [e.step for e in dur.load_manifest(path).entries] == [5]
    assert torch.equal(t_ckpt.load_snapshot(path)["params"]["w"],
                       snap(scale=2.0)["params"]["w"])


def test_keep_below_one_raises(tmp_path):
    with pytest.raises(ValueError, match="keep"):
        t_ckpt.save_snapshot(str(tmp_path / "snap.pt"), snap(), keep=0)


def test_truncated_latest_falls_back_to_previous_good(tmp_path, capsys):
    path = str(tmp_path / "snap.pt")
    t_ckpt.save_snapshot(path, snap(step=1, scale=1.0), retry=NO_WAIT)
    t_ckpt.save_snapshot(path, snap(step=2, scale=2.0), retry=NO_WAIT)
    with open(step_file(tmp_path, 2), "r+b") as f:
        f.truncate(50)
    got = t_ckpt.load_snapshot(path, retry=NO_WAIT)
    assert got["step"] == 1
    assert torch.equal(got["params"]["w"], snap(scale=1.0)["params"]["w"])
    assert "fell back to checkpoint step 1" in capsys.readouterr().out


def _jax_snapshot(step):
    return j_ckpt.Snapshot(params={"w": step * np.arange(6, dtype=np.float32)},
                           opt_state={"mu": np.ones(6, np.float32)}, step=step)


def test_f1_probe_both_packages_restore_the_previous_step(tmp_path):
    """Save steps 1 and 2, overwrite the last 8 bytes of the latest payload:
    the JAX package restores step 1, and so does the port."""
    def clobber(path):
        with open(path, "r+b") as f:
            f.seek(-8, os.SEEK_END)
            f.write(b"\xff" * 8)

    jpath = str(tmp_path / "jax" / "snap.msgpack")
    for step in (1, 2):
        j_ckpt.save_snapshot(jpath, _jax_snapshot(step), retry=j_dur.NO_WAIT)
    clobber(j_dur.object_key(jpath, 2))
    like = {"w": np.zeros(6, np.float32)}
    jgot = j_ckpt.load_snapshot(jpath, like, {"mu": np.zeros(6, np.float32)},
                                retry=j_dur.NO_WAIT)

    tpath = str(tmp_path / "port" / "snap.pt")
    for step in (1, 2):
        t_ckpt.save_snapshot(tpath, snap(step=step, scale=float(step)), retry=NO_WAIT)
    clobber(dur.object_key(tpath, 2))
    tgot = t_ckpt.load_snapshot(tpath, retry=NO_WAIT)

    assert jgot.step == tgot["step"] == 1
    np.testing.assert_array_equal(jgot.params["w"], tgot["params"]["w"].reshape(-1).numpy())


def test_all_checkpoints_corrupt_raises_not_fresh_start(tmp_path):
    """Every entry failing verification raises: a silent fresh start would
    let the next save overwrite the evidence."""
    path = str(tmp_path / "snap.pt")
    t_ckpt.save_snapshot(path, snap(step=1), retry=NO_WAIT)
    t_ckpt.save_snapshot(path, snap(step=2), retry=NO_WAIT)
    for step in (1, 2):
        with open(step_file(tmp_path, step), "r+b") as f:
            f.truncate(10)
    with pytest.raises(dur.SnapshotIntegrityError, match="passed verification"):
        t_ckpt.load_snapshot(path, retry=NO_WAIT)


def test_payload_that_does_not_load_falls_back(tmp_path):
    """An object whose digest matches the manifest but which is no snapshot
    of this format (written over by another tool, digest and all) is
    skipped like a torn one."""
    path = str(tmp_path / "snap.pt")
    t_ckpt.save_snapshot(path, snap(step=1), retry=NO_WAIT)
    dur.commit_blob(path, b"\x89 not a snapshot", step=2, epoch=0, policy=NO_WAIT)
    assert t_ckpt.load_snapshot(path, retry=NO_WAIT)["step"] == 1


def test_legacy_single_blob_still_loads(tmp_path):
    """Snapshots of the earlier layout (one file at the bare path, no
    manifest) keep restoring."""
    path = str(tmp_path / "snap.pt")
    t_ckpt.save_snapshot(path, snap(step=5), retry=NO_WAIT)
    os.replace(step_file(tmp_path, 5), path)
    os.remove(dur.manifest_path(path))
    assert t_ckpt.load_snapshot(path, retry=NO_WAIT)["step"] == 5


def test_missing_snapshot_is_fresh_start(tmp_path):
    assert t_ckpt.load_snapshot(str(tmp_path / "nope.pt"), retry=NO_WAIT) is None


def test_transient_read_errors_retry_then_raise(tmp_path, faulty):
    """A read that keeps failing transiently raises once the attempts are
    spent; it is never taken for a missing snapshot."""
    faulty.set_faults("read:every=1")
    with pytest.raises(OSError, match="injected transient read"):
        t_ckpt.load_snapshot(str(tmp_path / "snap.pt"), retry=NO_WAIT, fs=faulty)
    assert faulty.specs[0].count == NO_WAIT.attempts


# -- the fault injector ------------------------------------------------------------

def test_fault_spec_parsing_matches_jax():
    text = "write:every=3;read:nth=2:mode=truncate;read:nth=1:mode=delay:delay=2.5:match=step-"
    ours, theirs = faults.parse_faults(text), j_faults.parse_faults(text)
    fields = ("op", "nth", "every", "mode", "match", "delay_s")
    assert [[getattr(s, f) for f in fields] for s in ours] == \
        [[getattr(s, f) for f in fields] for s in theirs]
    assert ours[0].op == "write" and ours[0].every == 3
    assert ours[1].mode == "truncate" and ours[2].delay_s == 2.5


@pytest.mark.parametrize("text", ["write", "chmod:nth=1", "read:nth=1:mode=boom",
                                  "read:nth", "read:nth=1:color=red"])
def test_bad_fault_specs_raise(text):
    with pytest.raises(ValueError):
        faults.parse_faults(text)


def test_fault_clock_fires_nth_and_every():
    nth, every = faults.parse_faults("read:nth=2;write:every=2:match=step-")
    assert [nth.fires("read", "p") for _ in range(4)] == [False, True, False, False]
    assert not every.fires("write", "snap.manifest.json")
    assert [every.fires("write", "snap.step-1") for _ in range(4)] == [False, True, False, True]


def test_nth_write_fails_then_retry_commits_intact_manifest(tmp_path, faulty):
    """Every 3rd object write raises a transient error; the retries absorb
    it and every save commits."""
    faulty.set_faults("write:every=3")
    path = str(tmp_path / "snap.pt")
    for step in (1, 2, 3):
        t_ckpt.save_snapshot(path, snap(step=step, scale=float(step)), retry=NO_WAIT,
                             fs=faulty)
    assert faulty.specs[0].count > 6  # 3 saves x 2 writes, plus the retries
    faulty.clear_faults()
    got = t_ckpt.load_snapshot(path, retry=NO_WAIT, fs=faulty)
    assert got["step"] == 3 and [e.step for e in dur.load_manifest(path).entries] == [1, 2, 3]
    assert torch.equal(got["params"]["w"], snap(scale=3.0)["params"]["w"])
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_write_failing_past_its_retries_keeps_the_previous_snapshot(tmp_path, faulty):
    path = str(tmp_path / "snap.pt")
    t_ckpt.save_snapshot(path, snap(step=1), retry=NO_WAIT, fs=faulty)
    faulty.set_faults("write:every=1:match=manifest")
    with pytest.raises(OSError, match="injected transient write"):
        t_ckpt.save_snapshot(path, snap(step=2), retry=NO_WAIT, fs=faulty)
    faulty.clear_faults()
    assert t_ckpt.load_snapshot(path, retry=NO_WAIT)["step"] == 1


def test_injected_truncation_is_caught_by_digest(tmp_path, faulty):
    """A truncating write succeeds silently; restore rejects the object on
    its digest and falls back to the previous good one."""
    path = str(tmp_path / "snap.pt")
    t_ckpt.save_snapshot(path, snap(step=1, scale=1.0), retry=NO_WAIT, fs=faulty)
    faulty.set_faults("write:nth=1:mode=truncate:match=step-")
    t_ckpt.save_snapshot(path, snap(step=2, scale=2.0), retry=NO_WAIT, fs=faulty)
    faulty.clear_faults()
    assert os.path.getsize(step_file(tmp_path, 2)) < dur.load_manifest(path).latest.size
    got = t_ckpt.load_snapshot(path, retry=NO_WAIT, fs=faulty)
    assert got["step"] == 1
    assert torch.equal(got["params"]["w"], snap(scale=1.0)["params"]["w"])


def test_injected_read_failures_retry(tmp_path, faulty):
    path = str(tmp_path / "snap.pt")
    t_ckpt.save_snapshot(path, snap(step=4), retry=NO_WAIT, fs=faulty)
    faulty.set_faults("read:nth=1")
    assert t_ckpt.load_snapshot(path, retry=NO_WAIT, fs=faulty)["step"] == 4
    assert faulty.specs[0].count >= 2  # the first read failed, the retry read


def test_injected_truncated_read_falls_back(tmp_path, faulty):
    path = str(tmp_path / "snap.pt")
    for step in (1, 2):
        t_ckpt.save_snapshot(path, snap(step=step), retry=NO_WAIT, fs=faulty)
    faulty.set_faults("read:nth=1:mode=truncate:match=step-")
    assert t_ckpt.load_snapshot(path, retry=NO_WAIT, fs=faulty)["step"] == 1


def test_injected_missing_read_is_fresh_start(tmp_path, faulty):
    faulty.set_faults("read:nth=1:mode=missing")
    assert t_ckpt.load_snapshot(str(tmp_path / "absent.pt"), retry=NO_WAIT,
                                fs=faulty) is None


def test_delay_faults_use_injected_sleep(tmp_path):
    slept = []
    fs = faults.FaultInjectionFileSystem(sleep=slept.append)
    path = str(tmp_path / "snap.pt")
    fs.set_faults("write:nth=1:mode=delay:delay=7.5")
    t_ckpt.save_snapshot(path, snap(step=2), retry=NO_WAIT, fs=fs)
    fs.set_faults("read:nth=1:mode=delay:delay=2.5")
    assert t_ckpt.load_snapshot(path, retry=NO_WAIT, fs=fs)["step"] == 2
    assert slept == [7.5, 2.5]


def test_jax_faulty_fs_and_the_port_share_the_schedule(tmp_path):
    """The same spec on the same sequence of saves fires on the same
    operations in both injectors: every third write."""
    spec = "write:every=3"
    jfs = fsspec.filesystem("faulty")
    jfs.set_faults(spec)
    os.makedirs(tmp_path / "jax")  # a faulty:// write makes no directories
    try:
        for step in (1, 2, 3):
            j_ckpt.save_snapshot(f"faulty://{tmp_path}/jax/snap.msgpack",
                                 _jax_snapshot(step), retry=j_dur.NO_WAIT)
        jcount = jfs.specs[0].count
    finally:
        jfs.clear_faults()
    fs = faults.FaultInjectionFileSystem(spec)
    for step in (1, 2, 3):
        t_ckpt.save_snapshot(str(tmp_path / "port" / "snap.pt"), snap(step=step),
                             retry=NO_WAIT, fs=fs)
    assert fs.specs[0].count == jcount


# -- the trainer -------------------------------------------------------------------

TEXT = ("the quick brown fox jumps over the lazy dog. " * 40)


def _trainer(path, max_steps, **kw):
    data = t_data.CharDataset(DataConfig.make(block_size=16), text=TEXT)
    train, test = data.split()
    gcfg = GPTConfig.make(n_layer=1, n_head=2, n_embd=16, vocab_size=data.vocab_size,
                          block_size=16, dtype="float32", embd_pdrop=0.0,
                          resid_pdrop=0.0, attn_pdrop=0.0)
    tcfg = TrainerConfig.make(batch_size=4, max_steps=max_steps, log_every=100,
                              eval_batches=1, snapshot_path=str(path),
                              io_retry_delay_s=0.0, **kw)
    return t_trainer.GPTTrainer(tcfg, gcfg, OptimizerConfig(learning_rate=1e-3),
                                train, test, device="cpu")


def test_trainer_keeps_last_k_and_resumes_past_a_corrupt_snapshot(tmp_path):
    path = tmp_path / "snap.pt"
    for steps in (1, 2, 3):
        _trainer(path, steps, keep_snapshots=2).train()
    assert [e.step for e in dur.load_manifest(str(path)).entries] == [2, 3]
    with open(step_file(tmp_path, 3), "r+b") as f:
        f.truncate(100)
    assert _trainer(path, 4, keep_snapshots=2).step == 2


def test_trainer_defaults_keep_three_and_retry(tmp_path):
    t = _trainer(tmp_path / "snap.pt", 1)
    assert t.config.keep_snapshots == 3 and t._retry.attempts == 4
    assert t._retry.seed == t.config.seed
    t.config.check_ported()  # the durability options run: nothing raises
    for steps in (1, 2, 3, 4):
        _trainer(tmp_path / "snap.pt", steps).train()
    assert [e.step for e in dur.load_manifest(str(tmp_path / "snap.pt")).entries] == [2, 3, 4]
