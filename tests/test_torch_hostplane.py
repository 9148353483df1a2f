"""The port's cross-host control plane (serving/procfleet/hostplane.py),
the network fault injector and the socket transport's retry budget against
the JAX package's.

Counterparts of the 22 tests of tests/test_hostplane.py, on the loopback
host mesh (``build_loopback_fleet``: per host a ProcessSupervisor of
loopback backends, a ProcRouter and a HostAgent, LoopbackHostLinks between
them) on one VirtualClock: the two-host mesh against solo greedy; the
partition drill (host0 cut off mid-decode, quarantined, its requests failed
over, the cable back in) byte-identical across two runs and its JSON report
equal to JAX's; the emission fence; quorum sheds; the heartbeat ladder's
hysteresis; paced cross-host migration with its exact token-bucket budget;
an exhausted transfer degrading to re-route; the PacedChannel battery; the
auth battery (unsigned, tampered, replayed, corrupted chunks); auth off by
default; the merged page; refused sockets; the injector's grammar and
verdicts. Every model-backed case runs in both packages on the same weights
(the port's converted from the JAX init) and the summaries, reports and each
request's tokens, hosts and attempts must be equal. The JAX test's quantized
tp=2 migration runs here at tp = 1 (tensor parallelism is ROADMAP.md Queue
1 item 9): the int8 payloads and fp32 scale planes cross hosts bit-equal.
CPU, the JAX tests' tiny config (2 layers, 2 heads, 32 wide, V = 50, block
32, fp32).
"""

import copy
import json
import socket
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mingpt_distributed_tpu.serving as j_serving
import mingpt_distributed_tpu.serving.procfleet as j_pf
from mingpt_distributed_tpu.config import GPTConfig as JConfig
from mingpt_distributed_tpu.models import generate as j_gen
from mingpt_distributed_tpu.models import gpt as j_gpt
from mingpt_distributed_tpu.serving.requests import ShedError as JShedError
from mingpt_distributed_tpu.telemetry import parse_prometheus as j_parse
from mingpt_distributed_tpu.telemetry import render_prometheus as j_render
from mingpt_distributed_tpu.training import faults as j_faults
from mingpt_distributed_tpu_torch import serving as t_serving
from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import generate as gen
from mingpt_distributed_tpu_torch.serving import procfleet as t_pf
from mingpt_distributed_tpu_torch.serving.requests import ShedError
from mingpt_distributed_tpu_torch.telemetry import parse_prometheus, render_prometheus
from mingpt_distributed_tpu_torch.training import faults as t_faults

TINY = dict(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32,
            embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13]]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tiny models' ops are too small to share out,
    and under the suite's parallel workers a thread per core contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pkgs():
    jcfg, tcfg = JConfig.make(**TINY), GPTConfig.make(**TINY)
    tree = j_gpt.init(jax.random.key(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.array, tree), tcfg, "cpu")
    jax_pkg = SimpleNamespace(
        name="jax", serving=j_serving, pf=j_pf, faults=j_faults, parse=j_parse,
        render=j_render, shed=JShedError, cfg=jcfg, params=tree, place={})
    port = SimpleNamespace(
        name="port", serving=t_serving, pf=t_pf, faults=t_faults, parse=parse_prometheus,
        render=render_prometheus, shed=ShedError, cfg=tcfg, params=tparams,
        place={"device": "cpu"})
    return jax_pkg, port


def solo_greedy(pkg, prompt, n):
    if pkg.name == "jax":
        out = j_gen.generate(pkg.params, pkg.cfg, jnp.asarray(prompt, jnp.int32)[None], n)
        return np.asarray(out)[0, len(prompt):].tolist()
    return gen.generate(pkg.params, pkg.cfg, [prompt], n, device="cpu")[0, len(prompt):].tolist()


def both(pkgs, scenario):
    jax_out, port_out = (scenario(pkg) for pkg in pkgs)
    assert port_out == jax_out
    return port_out


def mesh(pkg, server_kwargs=None, **kw):
    """``build_loopback_fleet`` in ``pkg``, the replicas placed on the CPU
    for the port."""
    return pkg.pf.build_loopback_fleet(
        pkg.params, pkg.cfg, server_kwargs=dict(n_slots=2, **pkg.place,
                                                **(server_kwargs or {})), **kw)


def samples(pkg, page_or_registry, family):
    text = (page_or_registry if isinstance(page_or_registry, str)
            else pkg.render(page_or_registry))
    return {tuple(sorted(labels.items())): value
            for name, labels, value in pkg.parse(text)["samples"] if name == family}


def cross_record(handles):
    return [(h.request_id, h.tokens, h.finish_reason, h.attempts, list(h.hosts),
             h.fenced, h.duplicates_suppressed) for h in handles]


# ---------------------------------------------------------------------------
# baseline, the partition drill, the fence, quorum, the ladder
# ---------------------------------------------------------------------------


def test_two_host_fleet_matches_solo_and_streams_exactly(pkgs):
    def run(pkg):
        streamed = {}
        frontend, _, _ = mesh(pkg, n_hosts=2, n_replicas=1,
                              on_token=lambda c, t: streamed.setdefault(
                                  c.request_id, []).append(t))
        handles = [frontend.submit(pkg.serving.Request(prompt=p, max_new_tokens=8))
                   for p in PROMPTS]
        frontend.run_until_drained(max_steps=5000)
        return (cross_record(handles), [streamed[h.request_id] == h.tokens for h in handles],
                frontend.summary())

    handles, streams_ok, summary = both(pkgs, run)
    for p, (_, tokens, reason, attempts, _, fenced, _) in zip(PROMPTS, handles):
        assert reason == "length" and tokens == solo_greedy(pkgs[1], p, 8)
        assert attempts == 1 and fenced == 0
    assert all(streams_ok)
    assert summary["declared_failed"] == []
    assert all(summary["hosts"][h]["admitting"] for h in ("host0", "host1"))


def _partition_drill(pkg):
    spec = ";".join(
        f"partition:nth=1:match={a}->{b}:delay=0.2"
        for a, b in [("host0", "host1"), ("host0", "host2"),
                     ("host1", "host0"), ("host2", "host0")])
    streamed = {}
    frontend, agents, _ = mesh(
        pkg, n_hosts=3, n_replicas=1, heartbeat_interval_s=0.01, net_faults=spec,
        on_token=lambda c, t: streamed.setdefault(c.request_id, []).append(t))
    handles = [frontend.submit(pkg.serving.Request(prompt=p, max_new_tokens=24))
               for p in PROMPTS]
    frontend.run_until_drained(max_steps=20000)
    for _ in range(300):
        frontend.step()
    report = json.dumps(frontend.summary(), sort_keys=True)
    return report, streamed, handles, frontend, agents


@pytest.fixture(scope="module")
def drills(pkgs):
    jax_pkg, port = pkgs
    return _partition_drill(jax_pkg), _partition_drill(port), _partition_drill(port)


def test_partition_drill_two_runs_byte_identical(pkgs, drills):
    (j_report, _, j_handles, j_front, j_agents), first, second = drills
    report1, streamed, handles, frontend, agents = first
    assert report1 == second[0]  # replayable
    assert report1 == j_report   # and JAX's report, byte for byte
    assert cross_record(handles) == cross_record(j_handles)
    for h, p in zip(handles, PROMPTS):
        assert h.finish_reason == "length"
        assert h.tokens == solo_greedy(pkgs[1], p, 24)
        assert streamed[h.request_id] == h.tokens
    summary = json.loads(report1)
    recovered = [r for r in summary["requests"].values() if r["recovered"]]
    assert recovered, "no request crossed hosts — the drill is vacuous"
    for r in recovered:
        assert r["attempts"] >= 2 and len(set(r["hosts"])) >= 2
        assert r["fenced"] > 0 or r["duplicates_suppressed"] > 0
    assert summary["fleet_epoch"] >= 1 and summary["declared_failed"] == []
    for host, info in summary["hosts"].items():
        assert info["admitting"], f"{host} still not admitting after heal"
        assert all(v == "alive" for v in info["peers"].values())
    rows = [row for agent in agents.values() for row in agent.router.supervisor.recovery_log
            if row.get("path") == "crosshost"]
    j_rows = [row for agent in j_agents.values()
              for row in agent.router.supervisor.recovery_log if row.get("path") == "crosshost"]
    assert rows == j_rows and rows and all(row["recovery_s"] > 0 for row in rows)
    assert any(row["replica"] == "host0" for row in rows)
    fenced = samples(pkgs[1], frontend.fleet_metrics_page(),
                     "mingpt_fleet_fenced_emissions_total")
    assert sum(v for labels, v in fenced.items() if dict(labels).get("host")) == sum(
        r["fenced"] for r in summary["requests"].values())


def test_stale_epoch_and_stale_placement_emissions_are_fenced(pkgs):
    def run(pkg):
        frontend, _, _ = mesh(pkg, n_hosts=2, n_replicas=1)
        h = frontend.submit(pkg.serving.Request(prompt=[1, 2, 3], max_new_tokens=6))
        frontend.run_until_drained(max_steps=5000)
        done = list(h.tokens)
        host, local_id = h.local_key
        h.finished = False
        h.fence_epoch = 5
        frontend._local[h.local_key] = (h, object())
        frontend._emissions.append((host, 0, local_id, len(h.tokens), 99))
        frontend._process_emissions()
        after_epoch = (list(h.tokens), h.fenced)
        h.fence_epoch = 0
        h.local_key = ("host1", "fleet-999")
        frontend._emissions.append((host, 0, local_id, len(h.tokens), 99))
        frontend._process_emissions()
        fenced = samples(pkg, frontend.registry, "mingpt_fleet_fenced_emissions_total")
        return done, after_epoch, (list(h.tokens), h.fenced), fenced[(("host", host),)]

    done, after_epoch, after_place, counted = both(pkgs, run)
    solo = solo_greedy(pkgs[1], [1, 2, 3], 6)
    assert done == solo and after_epoch == (solo, 1) and after_place == (solo, 2)
    assert counted == 2


def test_no_quorum_host_sheds_typed(pkgs):
    def run(pkg):
        frontend, agents, _ = mesh(pkg, n_hosts=3, n_replicas=1)
        a0 = agents["host0"]
        out = [a0.admitting]
        for st in a0.peers.values():
            st["state"] = "quarantined"
        out.append(a0.admitting)
        with pytest.raises(pkg.shed) as ei:
            a0.submit(pkg.serving.Request(prompt=[1, 2], max_new_tokens=2))
        out.append(ei.value.reason)
        for agent in agents.values():
            for st in agent.peers.values():
                st["state"] = "quarantined"
        with pytest.raises(pkg.shed) as ei:
            frontend.submit(pkg.serving.Request(prompt=[1, 2], max_new_tokens=2))
        out.append(ei.value.reason)
        return out

    assert both(pkgs, run) == [True, False, "no_quorum", "no_quorum"]


def test_heartbeat_ladder_hysteresis(pkgs):
    def run(pkg):
        clock = pkg.serving.VirtualClock(tick_s=0.001)
        _, agents, _ = mesh(pkg, n_hosts=2, n_replicas=1, clock=clock,
                            heartbeat_interval_s=0.05)
        a0 = agents["host0"]
        st = a0.peers["host1"]
        seen = []
        for dt, contact in ((0.075, 0), (0.055, 0), (0.13, 0), (0.25, 0),
                            (0.0, 1), (0.0, 1), (0.13, 0), (0.0, 1)):
            clock.advance(dt)
            if contact:
                a0.record_contact("host1")
            a0.refresh_peer_states()
            seen.append(st["state"])
        return seen

    assert both(pkgs, run) == ["alive", "suspect", "quarantined", "dead", "dead",
                               "alive", "suspect", "alive"]


# ---------------------------------------------------------------------------
# paced migration
# ---------------------------------------------------------------------------


def test_paced_crosshost_migration_budget_exact(pkgs):
    prompt = [5, 6, 7, 8, 9, 10, 11, 12, 13]

    def run(pkg):
        streamed = {}
        frontend, _, _ = mesh(
            pkg, n_hosts=2, n_replicas=1, secret="drill-secret",
            paced_bytes_per_s=1_000_000.0,
            net_faults="slow_link:every=1:match=host0->host1:delay=0.05",
            server_kwargs=dict(prefix_cache_mb=2.0, prefill_buckets=(8, 16, 32)),
            on_token=lambda c, t: streamed.setdefault(c.request_id, []).append(t))
        h = frontend.submit(pkg.serving.Request(prompt=prompt, max_new_tokens=12))
        for _ in range(4):
            frontend.step()
        mid = not h.finished
        report = frontend.migrate_crosshost("host0", "host1")
        frontend.run_until_drained(max_steps=5000)
        xfer = samples(pkg, frontend.fleet_metrics_page(), "mingpt_fleet_xfer_bytes_total")
        return mid, report, cross_record([h]), streamed[h.request_id] == h.tokens, xfer

    mid, report, ((rid, tokens, reason, _, _, _, _),), streamed_ok, xfer = both(pkgs, run)
    assert mid and report["outcome"] == "ok" and report["error"] is None
    assert report["requests_moved"] == [rid]
    assert report["entries_installed"] + report["chunks"] >= 1
    want = report["bytes"] / 1_000_000.0 + 0.05 * report["chunks"]
    assert abs(report["transfer_s"] - want) < 1e-9
    assert report["src_exit_code"] == 75
    assert reason == "length" and tokens == solo_greedy(pkgs[1], prompt, 12) and streamed_ok
    assert xfer[(("paced", "true"),)] >= report["bytes"] and xfer[(("paced", "false"),)] == 0


def test_exhausted_transfer_retries_degrade_to_reroute(pkgs):
    def run(pkg):
        frontend, agents, _ = mesh(pkg, n_hosts=2, n_replicas=1,
                                   net_faults="drop_frame:every=1:match=host0->host1")
        h = frontend.submit(pkg.serving.Request(prompt=[1, 2, 3, 4], max_new_tokens=8))
        for _ in range(3):
            frontend.step()
        report = frontend.migrate_crosshost("host0", "host1")
        frontend.run_until_drained(max_steps=5000)
        migrations = samples(pkg, agents["host0"].router.supervisor.registry,
                             "mingpt_fleet_migrations_total")
        return report, cross_record([h]), migrations.get((("outcome", "failed"),), 0)

    report, ((rid, tokens, reason, _, _, _, _),), failed = both(pkgs, run)
    assert report["outcome"] == "failed" and "PacedTransferError" in report["error"]
    assert report["to"] is None and report["entries_installed"] == 0
    assert report["requests_moved"] == [rid]
    assert reason == "length" and tokens == solo_greedy(pkgs[1], [1, 2, 3, 4], 8)
    assert failed == 1


def test_crosshost_migration_quantized_tp2_bit_identical(pkgs):
    """At tp = 1 (tensor parallelism is ROADMAP.md Queue 1 item 9): an int8
    engine's prefix rows cross hosts through the paced channel and arrive
    bit-identical (int8 payloads and fp32 scale planes, no requantization)
    in exactly bytes / rate on the clock; the port's entries equal JAX's."""
    prompt = [5, 6, 7, 8, 9, 10, 11, 12, 13]

    def run(pkg):
        frontend, agents, _ = mesh(
            pkg, n_hosts=2, n_replicas=1, paced_bytes_per_s=1_000_000.0,
            server_kwargs=dict(kv_dtype="int8", prefix_cache_mb=4.0,
                               prefill_buckets=(8, 16, 32)))
        h = frontend.submit(pkg.serving.Request(prompt=prompt, max_new_tokens=4))
        frontend.run_until_drained(max_steps=5000)
        src_host = h.hosts[0]
        dst_host = next(x for x in sorted(agents) if x != src_host)
        src_rep = agents[src_host].router.supervisor.replicas[0]
        before = {k: {n: np.asarray(a) for n, a in e.items()}
                  for k, e in src_rep.backend.worker.server.engine.prefix_store.entries()}
        report = frontend.migrate_crosshost(src_host, dst_host)
        dst = agents[dst_host].router.supervisor.replica_by_name(report["to"])
        after = {k: {n: np.asarray(a) for n, a in e.items()}
                 for k, e in dst.backend.worker.server.engine.prefix_store.entries()}
        return h.finish_reason, report, before, after

    (j_reason, j_report, j_before, j_after), (reason, report, before, after) = (
        run(pkg) for pkg in pkgs)
    assert reason == j_reason == "length"
    assert report == j_report and report["outcome"] == "ok"
    assert report["entries_installed"] >= 1
    assert abs(report["transfer_s"] - report["bytes"] / 1_000_000.0) < 1e-9
    assert before and sorted(after) == sorted(before) == sorted(j_after)
    for key, entry in after.items():
        assert sorted(entry) == ["k", "k_scale", "v", "v_scale"]
        assert entry["k"].dtype == np.int8 and entry["k_scale"].dtype == np.float32
        for name, arr in entry.items():
            assert np.array_equal(arr, before[key][name]), f"{name} drifted"
            assert arr.shape == j_after[key][name].shape


# ---------------------------------------------------------------------------
# PacedChannel
# ---------------------------------------------------------------------------


class _ChunkSink:
    def __init__(self, pf):
        self.pf = pf
        self.seen = []

    def post_bytes(self, path, blob):
        assert path == "/host/xfer_chunk"
        ((meta, chunk),) = self.pf.unpack_frames(blob)
        self.pf.validate_envelope(meta, kind="xfer_chunk")
        self.seen.append((meta["seq"], chunk))
        return self.pf.envelope("xfer_ack", xfer_id=meta["xfer_id"], seq=meta["seq"], ok=True)


def test_paced_channel_chunking_and_exact_budget(pkgs):
    def run(pkg):
        clock = pkg.serving.VirtualClock(tick_s=0.001)
        sink = _ChunkSink(pkg.pf)
        ch = pkg.pf.PacedChannel(clock, bytes_per_s=100.0, chunk_bytes=4)
        blob = bytes(range(10))
        report = ch.send(sink, blob, "x0", "a", "b")
        clock.advance(123.0)
        report2 = ch.send(_ChunkSink(pkg.pf), blob, "x1", "a", "b")
        return report, b"".join(c for _, c in sorted(sink.seen)) == blob, report2

    report, whole, report2 = both(pkgs, run)
    assert report["chunks"] == 3 and report["retries"] == 0 and whole
    assert abs(report["transfer_s"] - 0.1) < 1e-9 and abs(report2["transfer_s"] - 0.1) < 1e-9


def test_paced_channel_unpaced_is_instant_on_virtual_clock(pkgs):
    def run(pkg):
        clock = pkg.serving.VirtualClock(tick_s=0.001)
        return pkg.pf.PacedChannel(clock, chunk_bytes=4).send(
            _ChunkSink(pkg.pf), b"abcdefgh", "x0", "a", "b")

    report = both(pkgs, run)
    assert report["transfer_s"] == 0.0 and report["chunks"] == 2


def test_paced_channel_resumes_from_last_acked_chunk(pkgs):
    def run(pkg):
        clock = pkg.serving.VirtualClock(tick_s=0.001)
        net = pkg.faults.NetworkFaultInjector("drop_frame:nth=2:match=a->b", clock=clock)
        sink = _ChunkSink(pkg.pf)
        blob = bytes(range(12))
        report = pkg.pf.PacedChannel(clock, chunk_bytes=4).send(
            sink, blob, "x0", "a", "b", net=net)
        return report, [s for s, _ in sink.seen], b"".join(c for _, c in sorted(sink.seen)) == blob

    report, seqs, whole = both(pkgs, run)
    assert report["chunks"] == 3 and report["retries"] == 1
    assert seqs == [0, 1, 2] and whole


def test_paced_channel_exhausted_retries_raise_typed():
    clock = t_serving.VirtualClock(tick_s=0.001)
    net = t_faults.NetworkFaultInjector("drop_frame:every=1:match=a->b", clock=clock)
    ch = t_pf.PacedChannel(clock, chunk_bytes=4, max_retries=2)
    with pytest.raises(t_pf.PacedTransferError) as ei:
        ch.send(_ChunkSink(t_pf), b"abcd", "x0", "a", "b", net=net)
    assert isinstance(ei.value, t_pf.TransportError)
    jclock = j_serving.VirtualClock(tick_s=0.001)
    jnet = j_faults.NetworkFaultInjector("drop_frame:every=1:match=a->b", clock=jclock)
    with pytest.raises(j_pf.PacedTransferError) as ej:
        j_pf.PacedChannel(jclock, chunk_bytes=4, max_retries=2).send(
            _ChunkSink(j_pf), b"abcd", "x0", "a", "b", net=jnet)
    assert str(ei.value) == str(ej.value)


# ---------------------------------------------------------------------------
# auth
# ---------------------------------------------------------------------------


def test_auth_battery_unsigned_tampered_replayed(pkgs):
    def run(pkg):
        _, agents, _ = mesh(pkg, n_hosts=2, n_replicas=1, secret="s3cr3t")
        a0, a1 = agents["host0"], agents["host1"]

        def post(doc):
            raw = a1.handle_host("/host/heartbeat", json.dumps(doc, sort_keys=True).encode())
            return json.loads(raw.decode())

        doc = pkg.pf.envelope("heartbeat", host="host0", epoch=0, seq=1)
        out = [post(copy.deepcopy(doc))]
        signed = a0.auth.sign(copy.deepcopy(doc))
        tampered = copy.deepcopy(signed)
        tampered["seq"] = 999
        out += [post(tampered), post(signed), post(copy.deepcopy(signed))]
        return out, samples(pkg, a1.registry, "mingpt_fleet_auth_rejects_total")

    (unsigned, tampered, intact, replayed), rejects = both(pkgs, run)
    assert unsigned["error"] == "UnsignedEnvelope"
    assert tampered["error"] == "BadSignature"
    assert intact["kind"] == "heartbeat_ack"
    assert replayed["error"] == "ReplayedNonce"
    assert rejects == {(("reason", r),): v for r, v in
                       (("unsigned", 1), ("bad_mac", 1), ("replay", 1), ("frame_digest", 0))}


def test_auth_typed_errors_and_canonical_bytes():
    auth = t_pf.FleetAuth("k", sender="x")
    doc = t_pf.envelope("heartbeat", host="x", epoch=0, seq=1)
    with pytest.raises(t_pf.UnsignedEnvelope):
        auth.verify(copy.deepcopy(doc))
    for name in ("UnsignedEnvelope", "BadSignature", "ReplayedNonce"):
        assert getattr(t_pf, name).reason == getattr(j_pf, name).reason
    assert (t_pf.UnsignedEnvelope.reason, t_pf.BadSignature.reason,
            t_pf.ReplayedNonce.reason) == ("unsigned", "bad_mac", "replay")
    signed = auth.sign(copy.deepcopy(doc))
    assert t_pf.canonical_bytes(signed) == t_pf.canonical_bytes(doc) == j_pf.canonical_bytes(doc)
    assert t_pf.validate_envelope(copy.deepcopy(signed))["kind"] == "heartbeat"
    assert signed == j_pf.FleetAuth("k", sender="x").sign(copy.deepcopy(doc))


def test_corrupted_chunk_nacked_under_frame_digest(pkgs):
    def run(pkg):
        _, agents, _ = mesh(pkg, n_hosts=2, n_replicas=1, secret="s3cr3t")
        a0, a1 = agents["host0"], agents["host1"]
        meta = pkg.pf.envelope("xfer_chunk", xfer_id="t0", seq=0, n_chunks=1,
                               digest="0" * 64, total_bytes=3)
        a0.auth.sign(meta)
        ack = json.loads(a1.handle_host("/host/xfer_chunk",
                                        pkg.pf.pack_frames([(meta, b"abc")])).decode())
        return ack, samples(pkg, a1.registry, "mingpt_fleet_auth_rejects_total")

    ack, rejects = both(pkgs, run)
    assert ack["kind"] == "xfer_ack" and not ack["ok"] and "digest" in ack["message"]
    assert rejects[(("reason", "frame_digest"),)] == 1


def test_auth_off_by_default_streams_byte_identical(pkgs):
    def run(pkg, secret):
        frontend, agents, _ = mesh(pkg, n_hosts=2, n_replicas=1, secret=secret)
        hs = [frontend.submit(pkg.serving.Request(prompt=p, max_new_tokens=6))
              for p in PROMPTS[:2]]
        frontend.run_until_drained(max_steps=5000)
        return [h.tokens for h in hs], all(a.auth is None for a in agents.values())

    plain, off = both(pkgs, lambda pkg: run(pkg, None))
    signed, _ = both(pkgs, lambda pkg: run(pkg, "fleet-secret"))
    assert off and plain == signed


def test_fleet_metrics_page_strict_parses(pkgs):
    def run(pkg):
        frontend, _, _ = mesh(pkg, n_hosts=2, n_replicas=1, secret="s3cr3t",
                              paced_bytes_per_s=1_000_000.0)
        h = frontend.submit(pkg.serving.Request(prompt=[1, 2, 3], max_new_tokens=4))
        frontend.run_until_drained(max_steps=5000)
        page = frontend.fleet_metrics_page()
        got = pkg.parse(page)
        return (h.finish_reason,
                {f: got["types"][f] for f in ("mingpt_fleet_hosts",
                                              "mingpt_fleet_auth_rejects_total",
                                              "mingpt_fleet_xfer_seconds")},
                samples(pkg, page, "mingpt_fleet_hosts"),
                samples(pkg, page, "mingpt_fleet_cross_requests_total"),
                samples(pkg, page, "mingpt_fleet_xfer_bytes_total"))

    reason, types, hosts, outcomes, xfer = both(pkgs, run)
    assert reason == "length"
    assert types == {"mingpt_fleet_hosts": "gauge",
                     "mingpt_fleet_auth_rejects_total": "counter",
                     "mingpt_fleet_xfer_seconds": "histogram"}
    for host in ("host0", "host1"):
        assert hosts[(("host", host), ("state", "alive"))] == 2
        assert hosts[(("host", host), ("state", "dead"))] == 0
    assert outcomes[(("outcome", "completed"),)] == 1
    assert (("paced", "true"),) in xfer and (("paced", "false"),) in xfer


# ---------------------------------------------------------------------------
# SocketTransport, NetworkFaultInjector
# ---------------------------------------------------------------------------


def test_socket_transport_unavailable_after_bounded_backoff():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    delays = []
    t = t_pf.SocketTransport("127.0.0.1", port, timeout_s=1.0, connect_retries=2,
                             retry_backoff_s=0.01, sleep=delays.append)
    with pytest.raises(t_pf.TransportUnavailable) as ei:
        t.fetch_text("/metrics")
    assert "after 3 attempts" in str(ei.value)
    assert delays == [0.01, 0.02]


def test_network_injector_rejects_foreign_ops():
    for mod in (t_faults, j_faults):
        with pytest.raises(ValueError):
            mod.NetworkFaultInjector("kill:nth=1")


def _partition_story(mod, serving):
    clock = serving.VirtualClock(tick_s=0.001)
    net = mod.NetworkFaultInjector("partition:nth=1:match=a->b", clock=clock)
    out = []
    for src, dst in (("a", "b"), ("a", "b"), ("b", "a")):
        try:
            out.append(net.link_verdict(src, dst))
        except mod.LinkPartitioned as e:
            out.append(str(e))
    net.heal()
    out.append(net.link_verdict("a", "b"))
    return out, net.fired


def test_network_injector_partition_until_heal():
    got = _partition_story(t_faults, t_serving)
    assert got == _partition_story(j_faults, j_serving)
    (first, second, other, healed), fired = got
    assert "link a->b is down" in first and first == second
    assert other == 0.0 and healed == 0.0 and fired[0] == "partition:a->b"


def test_network_injector_timed_partition_heals_on_clock():
    clock = t_serving.VirtualClock(tick_s=0.001)
    net = t_faults.NetworkFaultInjector("partition:nth=1:match=a->b:delay=0.5", clock=clock)
    with pytest.raises(t_faults.LinkPartitioned):
        net.link_verdict("a", "b")
    clock.advance(0.4)
    with pytest.raises(t_faults.LinkPartitioned):
        net.link_verdict("a", "b")
    clock.advance(0.2)
    assert net.link_verdict("a", "b") == 0.0


def test_network_injector_slow_drop_and_host_kill():
    def run(mod, serving):
        clock = serving.VirtualClock(tick_s=0.001)
        net = mod.NetworkFaultInjector(
            "slow_link:every=1:delay=0.2:match=a->b;drop_frame:nth=2:match=a->b;"
            "host_kill:nth=1:match=hostX", clock=clock)
        return ([net.link_verdict("a", "b"), net.link_verdict("a", "c"),
                 net.frame_verdict("a", "b"), net.frame_verdict("a", "b"),
                 net.frame_verdict("a", "b"), net.host_verdict("hostY"),
                 net.host_verdict("hostX"), net.host_verdict("hostX")], net.fired)

    got = run(t_faults, t_serving)
    assert got == run(j_faults, j_serving)
    assert got[0] == [0.2, 0.0, False, True, False, False, True, False]


def test_selftest_crosshost_cli_real_subprocesses(capsys):
    """serve --selftest-crosshost: two host agents over real worker
    subprocesses (a host SIGKILLed, a paced migration, a tampered frame)."""
    from mingpt_distributed_tpu_torch import serve as t_serve

    assert t_serve.main(["--selftest-crosshost", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "selftest-crosshost PASSED" in out and "reject=BadSignature" in out


def test_procfleet_reads_no_clock():
    """Clock discipline, as the JAX package's lint holds it: procfleet's
    time is the injected clock; only ``transport.py`` names the ``time``
    module, for ``time.sleep`` as the socket retry's default sleep."""
    import ast
    import os

    pkg = os.path.dirname(t_pf.__file__)
    for name in sorted(os.listdir(pkg)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(pkg, name)) as f:
            tree = ast.parse(f.read())
        imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                    for a in n.names} & {"time", "datetime"}
        uses = {f"{n.value.id}.{n.attr}" for n in ast.walk(tree)
                if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
                and n.value.id in ("time", "datetime")}
        if name == "transport.py":
            assert imported == {"time"} and uses == {"time.sleep"}, uses
        else:
            assert not imported and not uses, (name, uses)
