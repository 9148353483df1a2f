"""Tensor-parallel serving in the port: the counterpart of
``tests/test_sharded.py``, on gloo CPU ranks.

The JAX package serves one model across a tp mesh from one controller; the
port runs one process per tp rank in lockstep (``serving/lockstep.py``).
The JAX tp = 2 server runs here on two of the conftest's forced host
devices; the port's tp = 2 server (rank 0 drives, rank 1 follows) and its
tp = 1 server get the same converted weights. With chunked prefill, prefix
reuse and a 1-layer draft (k 3, so rejections roll back) all three give the
same greedy tokens, and the port's tp = 2 and tp = 1 servers the same shape
counts (decode 1, verify 1). The pool, the draft's pool and every prefix
entry hold half the heads on each rank; slots freed and re-admitted keep
the split; an int8 pool under tp gives the int8 tp = 1 server's tokens; the
HBM ledger's per-device column holds half the pool; a call that bypasses
the lockstep dispatch fails at once; migration's seam moves whole-head rows.
A fleet of two tp = 2 replicas (drivers in one process, groups {0, 1} and
{0, 2}) survives a crash mid-decode with no duplicate token. A follower
killed, or one that raises, makes the driver raise within the group's
timeout and leaves no process behind. ``serve --selftest-sharded`` passes.

The ranks are spawned once per scenario group (two spawns for the module);
while they run, the parent runs the JAX server.
"""

import concurrent.futures
import dataclasses
import os
import signal
import time

import jax
import numpy as np
import pytest
import torch

from mingpt_distributed_tpu.config import GPTConfig as JConfig
from mingpt_distributed_tpu.config import MeshConfig as JMeshConfig
from mingpt_distributed_tpu.models import gpt as j_gpt
from mingpt_distributed_tpu.parallel import mesh as j_mesh
from mingpt_distributed_tpu.serving import InferenceServer as JServer
from mingpt_distributed_tpu.serving import Request as JRequest
from mingpt_distributed_tpu_torch import serve as t_serve
from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.parallel.spawn import run_ranks
from mingpt_distributed_tpu_torch.serving import InferenceServer, Request
from mingpt_distributed_tpu_torch.serving.kv_pool import SlotKVPool
from mingpt_distributed_tpu_torch.serving.lockstep import LockstepError, TPGroup, channel_for
from mingpt_distributed_tpu_torch.telemetry import (HBMLedger, parse_prometheus,
                                                    per_device_tree_bytes,
                                                    render_prometheus, tree_bytes)
from tests import torch_sp_workers as W
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32,
            embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
FLEET_NEW = 8
TIMEOUT_S = 60.0


def _jax_composed(jcfg, jparams):
    """The JAX tp = 2 server on W.COMPOSED (test_sharded.py's run)."""
    dcfg = dataclasses.replace(jcfg, n_layer=1)
    dparams = dict(jparams)
    dparams["blocks"] = jax.tree.map(lambda a: a[:1], jparams["blocks"])
    mesh = j_mesh.make_mesh(JMeshConfig(tp=2), devices=jax.devices()[:2])
    server = JServer(jparams, jcfg, n_slots=2, prefill_buckets=(4, 8, 16, 32),
                     prefill_chunk=8, prefix_cache_mb=8.0, warmup=True,
                     draft_params=dparams, draft_cfg=dcfg, spec_k=3, mesh=mesh)
    handles = []
    for prompt, n in W.COMPOSED:
        handles.append(server.submit(JRequest(prompt=prompt, max_new_tokens=n)))
        server.step()
    server.run_until_drained(max_steps=200)
    return dict(tokens=[h.tokens for h in handles], counts=server.compile_counts(),
                shard=server.engine.kv_shard_count)


@pytest.fixture(scope="module")
def runs(eight_devices):
    jcfg = JConfig.make(**TINY)
    jparams = j_gpt.init(jax.random.key(0), jcfg)
    tree = jax.tree.map(np.array, jparams)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        serving = pool.submit(run_ranks, W.tp_serving, 2, (tree, TINY), timeout_s=240)
        jax_run = _jax_composed(jcfg, jparams)
        ranks = serving.result()
    fleet = run_ranks(W.tp_fleet, 3, (tree, TINY, FLEET_NEW), timeout_s=240)
    return dict(port=ranks[0], follower=ranks[1], jax=jax_run, fleet=fleet[0],
                fleet_followers=fleet[1:])


# ---------------------------------------------------------------------------
# engine placement
# ---------------------------------------------------------------------------


def test_tp2_engine_shards_pool_halving_per_device_bytes(runs):
    p = runs["port"]["placement"]
    assert p["shard"] == 2 and p["solo_shard"] == 1
    # heads axis split in two, every other axis intact
    assert p["shape"] == p["solo_shape"][:3] + (p["solo_shape"][3] // 2,) + p["solo_shape"][4:]
    assert p["per_device"] * 2 == p["total"]
    assert p["report"]["kv_heads"] == 1 and p["report"]["pool_bytes"] == p["per_device"]


def test_tp2_slot_free_and_readmit_keeps_sharding(runs):
    r = runs["port"]["readmit"]
    assert r["queued"] == 2
    assert r["tokens"] == r["solo"] and r["late"] == r["solo_late"]
    assert r["shard"] == 2
    assert r["counts"] == {"prefill": 1, "decode": 1, "prefix_load": 0, "prefix_save": 0}
    # the follower's pool replayed every claim and release: all slots free
    assert r["report"]["free_slots"] == 2 and r["report"]["kv_heads"] == 1
    assert r["report"]["compile_counts"] == r["counts"]


# ---------------------------------------------------------------------------
# tp=2 vs tp=1 parity with everything composed, against JAX's tp=2 server
# ---------------------------------------------------------------------------


def test_tp2_vs_tp1_parity_chunked_prefix_and_speculative(runs):
    port, jax_run = runs["port"], runs["jax"]
    tp1, tp2 = port["tp1"], port["tp2"]
    assert tp2["tokens"] == tp1["tokens"] == jax_run["tokens"] == port["solo"]
    assert jax_run["shard"] == 2
    assert tp2["counts"] == tp1["counts"]
    assert tp2["counts"]["decode"] == 1 and tp2["counts"]["verify"] == 1
    assert tp2["recompiles"] == 0 and tp1["recompiles"] == 0
    assert tp2["shard"] == 2 and tp2["draft_shard"] == 2
    assert tp2["prefix_hits"] >= 1 and tp1["prefix_hits"] == tp2["prefix_hits"]
    accepted, proposed = tp2["spec"]
    assert accepted < proposed and tp2["spec"] == tp1["spec"]
    # the stored prefix entries hold half the heads on the driver and on
    # the follower: a hit is a rank-local row copy
    assert tp2["entry_heads"] and all(h == 1 for h in tp2["entry_heads"])
    (rep,) = tp2["reports"]
    assert rep["prefix_heads"] == tp2["entry_heads"] and rep["kv_heads"] == 1
    assert {f: n for f, n in tp2["counts"].items() if f in rep["compile_counts"]} \
        == rep["compile_counts"]
    assert not any(rep["launches"].values())


def test_tp2_int8_pool_matches_the_int8_tp1_server(runs):
    port = runs["port"]
    one, two = port["int8_tp1"], port["int8_tp2"]
    assert two["tokens"] == one["tokens"]
    assert two["counts"] == one["counts"] and two["shard"] == 2
    assert all(h == 1 for h in two["entry_heads"])


def test_missed_mirror_is_an_error_not_a_hang(runs):
    m = runs["port"]["missed_mirror"]
    assert m["error"] is not None and "outside the lockstep dispatch" in m["error"]
    assert m["seconds"] < 1.0
    assert m["after"] == runs["port"]["readmit"]["solo"][1][:4]


def test_migration_seam_moves_whole_head_rows(runs):
    seam = runs["port"]["seam"]
    assert seam["heads"] == TINY["n_head"]
    assert seam["extract_err"] <= 1e-6 and seam["roundtrip_err"] == 0.0
    assert seam["adopted"] and seam["hit"] == 8
    assert seam["report"]["prefix_heads"] == [1]


def test_follower_runs_every_command_and_leaves_on_shutdown(runs):
    assert runs["follower"]["commands"] > 100


# ---------------------------------------------------------------------------
# fleet of sharded replicas
# ---------------------------------------------------------------------------


def test_fleet_crash_retry_on_sharded_replicas(runs):
    f = runs["fleet"]
    assert f["shards"] == [2, 2]
    assert f["crashes"] == 1 and f["retries"] >= 1
    assert any(a > 1 for a in f["attempts"]), "the crash must force a retry"
    for toks, solo, streamed, reason in zip(f["tokens"], f["solo"], f["streamed"],
                                            f["reasons"]):
        assert reason == "length" and toks == solo
        assert streamed == toks  # every token streamed exactly once
    # the respawned replica0 rebuilt its follower's engines: one pool, empty
    assert [r["free_slots"] for r in f["reports"]] == [2, 2]
    assert all(r["kv_heads"] == 1 for r in f["reports"])
    assert all(r["commands"] > 0 for r in runs["fleet_followers"])


# ---------------------------------------------------------------------------
# accounting units
# ---------------------------------------------------------------------------


def test_per_device_tree_bytes_counts_shards():
    """A rank's tree is its own shard: a tp = 2 rank's pool counts half the
    whole pool's bytes."""
    cfg = GPTConfig.make(**TINY)
    whole = SlotKVPool(cfg, 2, device="cpu").cache
    half = SlotKVPool(cfg, 2, device="cpu", kv_heads=cfg.kv_heads // 2).cache
    assert per_device_tree_bytes(whole) == tree_bytes(whole)
    assert per_device_tree_bytes(half) * 2 == tree_bytes(whole)


def test_hbm_ledger_per_device_column():
    hbm = HBMLedger(capacity_bytes=None)
    hbm.account("params", 100)  # default: single-device truth
    hbm.account("kv_pool", 80, per_device_bytes=40)
    assert hbm.owners() == {"kv_pool": 80, "params": 100}
    assert hbm.per_device() == {"kv_pool": 40, "params": 100}
    hbm.account("kv_pool", 80, per_device_bytes=20)
    assert hbm.per_device()["kv_pool"] == 20
    with pytest.raises(ValueError):
        hbm.account("kv_pool", 80, per_device_bytes=81)
    with pytest.raises(ValueError):
        hbm.account("kv_pool", 80, per_device_bytes=-1)


def test_server_ledger_reports_the_pool_per_device(runs):
    tp1, tp2 = runs["port"]["tp1"]["hbm"], runs["port"]["tp2"]["hbm"]
    assert tp2["per_device"]["kv_pool"] * 2 == tp2["owners"]["kv_pool"]
    assert tp2["owners"]["kv_pool"] == tp1["owners"]["kv_pool"]
    assert tp1["per_device"]["kv_pool"] == tp1["owners"]["kv_pool"]
    assert tp2["per_device"]["draft_pool"] * 2 == tp2["owners"]["draft_pool"]


def test_tp_rank_audit_reads_its_own_share(runs, monkeypatch):
    """A tp = 2 driver's ledger (the owners and per-device columns its
    server reported) audits the rank's share against the rank's allocator:
    an allocation no owner holds shows as unattributed bytes, and the
    headroom is the card's capacity less the rank's share."""
    hbm = runs["port"]["tp2"]["hbm"]
    led = HBMLedger(capacity_bytes=10 ** 9, device=torch.device("cuda", 0))
    for owner, nbytes in hbm["owners"].items():
        led.account(owner, nbytes, per_device_bytes=hbm["per_device"][owner])
    mine = sum(hbm["per_device"].values())
    assert mine < led.total_bytes()
    leak = 4096
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: mine + leak)
    assert led.audit() == {"owned_bytes": mine, "live_bytes": mine + leak,
                           "unattributed_bytes": leak}
    parsed = parse_prometheus(render_prometheus(led.registry))
    values = {n: v for n, _, v in parsed["samples"]}
    assert values["mingpt_attrib_hbm_headroom_bytes"] == 10 ** 9 - mine
    assert values["mingpt_attrib_hbm_unattributed_bytes"] == leak


# ---------------------------------------------------------------------------
# failure: a dead or failing follower, never a fallback
# ---------------------------------------------------------------------------


def _tiny_port():
    cfg = GPTConfig.make(**TINY)
    tree = jax.tree.map(np.array, j_gpt.init(jax.random.key(0), JConfig.make(**TINY)))
    return cfg, convert.params_from_numpy(tree, cfg, "cpu")


@pytest.mark.parametrize("fault", ["killed", "raises"])
def test_a_failed_follower_makes_the_driver_raise_within_its_timeout(fault):
    cfg, params = _tiny_port()
    group = TPGroup(2, "gloo", "cpu", TIMEOUT_S)
    try:
        srv = InferenceServer(params, cfg, n_slots=2, mesh=group.mesh, device=group.device)
        h = srv.submit(Request(prompt=W.SERVE_PROMPTS[0], max_new_tokens=20))
        srv.step()
        srv.step()
        if fault == "killed":
            os.kill(group.procs[0].pid, signal.SIGKILL)
            group.procs[0].join(timeout=10)
        else:  # a command for an engine the follower does not hold
            channel_for(group.mesh).send("prefill", 12345, (0, 0, 1, 4, 1))
        t0 = time.monotonic()
        with pytest.raises(LockstepError):
            srv.run_until_drained(max_steps=50)
        elapsed = time.monotonic() - t0
        assert not h.finished
        assert elapsed <= TIMEOUT_S + 5.0
        with pytest.raises(LockstepError, match="broken"):  # no quiet tp=1 fallback
            srv.step()
    finally:
        exits = group.close()
    assert exits == ([-signal.SIGKILL] if fault == "killed" else [1])
    assert not any(p.is_alive() for p in group.procs)


def test_a_clean_shutdown_leaves_no_process(capsys):
    cfg, params = _tiny_port()
    group = TPGroup(2, "gloo", "cpu", TIMEOUT_S)
    try:
        srv = InferenceServer(params, cfg, n_slots=2, mesh=group.mesh, device=group.device)
        h = srv.submit(Request(prompt=W.SERVE_PROMPTS[2], max_new_tokens=5))
        srv.run_until_drained(max_steps=50)
    finally:
        exits = group.close()
    assert exits == [0] and not any(p.is_alive() for p in group.procs)
    assert h.tokens == W._solo(params, cfg, W.SERVE_PROMPTS[2], 5)


DRIVER_SRC = """
import sys, torch
from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models import gpt
from mingpt_distributed_tpu_torch.serving import InferenceServer, Request
from mingpt_distributed_tpu_torch.serving.lockstep import TPGroup

cfg = GPTConfig.make(**{tiny!r})
params = gpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
group = TPGroup(2, "gloo", "cpu", {timeout!r})
srv = InferenceServer(params, cfg, n_slots=2, mesh=group.mesh, device=group.device)
told = False
while True:
    srv.submit(Request(prompt=[1, 2, 3], max_new_tokens=20))
    for _ in range(10):
        srv.step()
        if not told:
            print(group.procs[0].pid, flush=True)
            told = True
"""
# a follower leaves within PARENT_POLL_S of its driver's death; the bound
# leaves room for a loaded host
DRIVER_DEATH_EXIT_S = 15.0


def _gone(pid):
    """Whether ``pid`` has exited (a zombie no reaper collected counts)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_a_killed_driver_leaves_no_follower_behind():
    """SIGKILL the driver process mid-decode: its spawned follower, blocked
    in the lockstep, exits on its own within DRIVER_DEATH_EXIT_S."""
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    driver = subprocess.Popen(
        [sys.executable, "-c", DRIVER_SRC.format(tiny=TINY, timeout=TIMEOUT_S)],
        stdout=subprocess.PIPE, env=env, text=True)
    follower = None
    try:
        follower = int(driver.stdout.readline())
        assert not _gone(follower)
        time.sleep(0.5)  # decoding
        assert driver.poll() is None
        driver.kill()
        driver.wait(timeout=10)
        t0 = time.monotonic()
        while not _gone(follower) and time.monotonic() - t0 < DRIVER_DEATH_EXIT_S:
            time.sleep(0.1)
        assert _gone(follower), f"follower {follower} outlived its driver"
    finally:
        if driver.poll() is None:
            driver.kill()
            driver.wait(timeout=10)
        if follower is not None and not _gone(follower):
            os.kill(follower, signal.SIGKILL)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


def test_serve_selftest_sharded_passes_and_prints_the_jax_lines(capsys):
    rc = t_serve.main(["--selftest-sharded", "--device", "cpu", "--prefix-cache-mb", "1",
                       "--prefill-chunk", "8", "--prefill-buckets", "8,16,48", "--warmup"])
    out = capsys.readouterr().out
    assert rc == 0, out
    for text in t_serve.SELFTEST_PROMPTS + t_serve.SELFTEST_SHARED:
        assert f"selftest-sharded ({text!r}): OK" in out
    assert "selftest-sharded compile_counts:" in out
    assert "selftest-sharded hbm: total=" in out and "per_device=" in out
    assert "selftest-sharded PASSED" in out


@pytest.mark.parametrize("spec, message", [
    ("tp=2,dp=2", "over tp only"), ("tq=2", "not axis=N"), ("tp=x", "must be an int")])
def test_serve_mesh_flag_is_parsed_and_refused_as_in_jax(spec, message):
    args = t_serve.parse_args(["--mesh", spec])
    with pytest.raises(SystemExit, match=message):
        t_serve._mesh_tp(args)


# the serve CLI with a fleet of tp = 2 replicas against the JAX CLI on the
# same weights (a JAX msgpack snapshot, and the port's --params npz of it)
CLI_MODEL = ["--config", os.path.join(REPO, "gpt2_config.yaml"), "gpt_config.n_layer=2",
             "gpt_config.n_head=4", "gpt_config.n_embd=64", "gpt_config.dtype=float32",
             "gpt_config.attn_pdrop=0", "gpt_config.attention=einsum",
             f"data_config.path={os.path.join(REPO, 'data', 'input.txt')}",
             "data_config.block_size=32", "data_config.truncate=0.2"]
CLI_PROMPTS = "the king \nand so \nwhat is \no my lord. \nthe \n"
CLI_AUTOSCALE = ("auto:metric=queue_depth:target=0.5:interval_s=0:cooldown_s=0"
                 ":up_after=1:down_after=1:max_replicas=2")


def _completions(out: str) -> list:
    """The completion lines of a serve CLI's stdout (the per-request
    banners and the summary JSON dropped)."""
    return [line for line in out.splitlines()
            if line and not line.startswith(("===", "{"))]


@pytest.fixture(scope="module")
def cli_weights(tmp_path_factory, eight_devices):
    import importlib.util

    from mingpt_distributed_tpu.data.char_dataset import CharDataset as JChars
    from mingpt_distributed_tpu.config import load_config as j_load
    from mingpt_distributed_tpu.training import checkpoint as j_ckpt

    tmp = tmp_path_factory.mktemp("tp_fleet_cli")
    exp = j_load(CLI_MODEL[1], CLI_MODEL[2:])
    ds = JChars(exp.data_config)
    jcfg = dataclasses.replace(exp.gpt_config, vocab_size=ds.vocab_size, block_size=32)
    tree = jax.device_get(j_gpt.init(jax.random.key(5), jcfg))
    tree = jax.tree.map(lambda a: a + np.float32(0.1) * np.sign(a), tree)
    np.savez(tmp / "params.npz", **convert.flatten(tree))
    j_ckpt.save_snapshot(str(tmp / "snap.msgpack"),
                         j_ckpt.Snapshot(params=tree, opt_state={}, step=1))
    (tmp / "prompts.txt").write_text(CLI_PROMPTS)
    spec = importlib.util.spec_from_file_location("jax_serve_cli",
                                                  os.path.join(REPO, "serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return tmp, mod


def _fleet_cli_pair(cli_weights, capsys, extra):
    tmp, j_cli = cli_weights
    common = ["--greedy", "--max-new-tokens", "10", "--prompts-file",
              str(tmp / "prompts.txt"), "--slots", "2", *extra]
    assert j_cli.main([*common, "--mesh", "tp=2", *CLI_MODEL,
                       f"trainer_config.snapshot_path={tmp / 'snap.msgpack'}"]) == 0
    want = _completions(capsys.readouterr().out)
    assert t_serve.main([*common, "--mesh", "tp=2", "--dist-backend", "gloo",
                         "--device", "cpu", "--params", str(tmp / "params.npz"),
                         *CLI_MODEL]) == 0
    got = capsys.readouterr()
    assert t_serve.main([*common, "--device", "cpu", "--params",
                         str(tmp / "params.npz"), *CLI_MODEL]) == 0
    plain = _completions(capsys.readouterr().out)
    return want, got, plain


def test_serve_mesh_tp2_with_two_replicas_matches_the_jax_cli(cli_weights, capsys):
    """``serve --mesh tp=2 --replicas 2``: two tp = 2 replicas, each on a
    lockstep group of its own, serve the JAX CLI's completions (its fleet
    shares one tp mesh) and the port's tp = 1 fleet's."""
    want, got, plain = _fleet_cli_pair(cli_weights, capsys, ["--replicas", "2"])
    assert len(want) == 5 and len(set(want)) > 1
    assert _completions(got.out) == want == plain
    assert "2 group(s) of 1 follower" in got.err and "tp=2 each" in got.err
    assert "[serve] tp follower exits: [0, 0]" in got.err


def test_serve_mesh_tp2_with_autoscale_matches_the_jax_cli(cli_weights, capsys):
    """``serve --mesh tp=2 --autoscale ...max_replicas=2``: a group for
    each replica the autoscaler may hold, the same completions as the JAX
    CLI's."""
    want, got, plain = _fleet_cli_pair(cli_weights, capsys,
                                       ["--replicas", "1", "--autoscale", CLI_AUTOSCALE])
    assert _completions(got.out) == want == plain
    assert "SLO autoscaler attached" in got.err
    assert "2 group(s) of 1 follower" in got.err
    assert "[serve] tp follower exits: [0, 0]" in got.err


def test_tp_mesh_pool_reuses_a_drained_replicas_group():
    """The fleet's replica indices never recycle: a scale-up after a
    scale-down takes the group the drained replica held, never a live
    replica's; a respawn keeps its group."""
    pool = t_serve.TPMeshPool(["g0", "g1"])
    assert pool["replica0"] == "g0" and pool["replica1"] == "g1"
    assert pool["replica1"] == "g1"  # a respawn
    with pytest.raises(KeyError, match="every one of the 2"):
        pool["replica2"]
    pool.live = lambda: {"replica0"}
    assert pool["replica2"] == "g1" and "replica9" in pool and len(pool) == 3
    pool.live = lambda: {"replica2"}
    assert pool["replica3"] == "g0"


def test_serve_mesh_refuses_process_isolation():
    with pytest.raises(SystemExit, match="--isolation process"):
        t_serve.main(["--mesh", "tp=2", "--isolation", "process", "--device", "cpu"])

