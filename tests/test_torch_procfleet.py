"""The port's process fleet (serving/procfleet/: rpc, transport, worker,
supervisor) and the process fault injector against the JAX package's.

Counterparts of the 14 tests of tests/test_procfleet.py: the chaos report
(a kill -9 of replica0's third step RPC, a slow socket on replica1, then a
drain with migration) byte-identical across two runs and equal to JAX's,
token-exact and streamed once; the envelope, event and transfer-channel
tamper batteries; respawn-budget exhaustion; migration of a mid-prefill
request; warm-standby adoption beating a cold respawn; the SIGTERM ->
SIGKILL ladder; an exhausted standby pool falling back cold loudly; draft
rows riding a migration. Every model-backed case runs in BOTH packages on
the same weights (the port's converted from the JAX init) over the
loopback transport on virtual clocks, and the reports, summaries and each
request's tokens, replica and attempts must be equal. The JAX tests' tp=2
cases run here at tp = 1 (tensor parallelism is ROADMAP.md Queue 1 item 9):
the migrated entries land on the destination's device with every head.

Then the wire between the packages: JAX's validator accepts every envelope
of a port loopback run and the port's every JAX envelope; ``pack_frames``,
``canonical_bytes`` and ``FleetAuth`` MACs are byte-equal; a JAX migration
blob at fp32 and int8 installs in a port engine with the same continuation
and the reverse; bf16 and fp8 leaves make the round trip by dtype name. And
``serve --selftest-procfleet --device cpu`` with real worker subprocesses.
CPU, the JAX tests' tiny config (2 layers, 2 heads, 32 wide, V = 50, block
32, fp32).
"""

import json
import random
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
from mingpt_distributed_tpu.serving.procfleet import worker as j_worker
from mingpt_distributed_tpu.telemetry import parse_prometheus as j_parse
from mingpt_distributed_tpu.telemetry.tracing import TraceRecorder as JTraceRecorder
from mingpt_distributed_tpu.training import faults as j_faults
from mingpt_distributed_tpu_torch import serve as t_serve
from mingpt_distributed_tpu_torch import serving as t_serving
from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import generate as gen
from mingpt_distributed_tpu_torch.serving import procfleet as t_pf
from mingpt_distributed_tpu_torch.serving.procfleet import worker as t_worker
from mingpt_distributed_tpu_torch.serving.procfleet.transport import LoopbackTransport
from mingpt_distributed_tpu_torch.telemetry import parse_prometheus
from mingpt_distributed_tpu_torch.telemetry.tracing import TraceRecorder
from mingpt_distributed_tpu_torch.training import faults as t_faults

TINY = dict(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32,
            embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13], [40, 41]]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tiny models' ops are too small to share
    out, and under the suite's parallel workers a thread per core makes
    them contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pkgs():
    """(JAX, port) namespaces: serving, procfleet, fault modules, parser,
    trace recorder, config, params (the port's converted from the JAX
    init) and the server kwargs that place a replica."""
    jcfg, tcfg = JConfig.make(**TINY), GPTConfig.make(**TINY)
    tree = j_gpt.init(jax.random.key(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.array, tree), tcfg, "cpu")
    jax_pkg = SimpleNamespace(
        name="jax", serving=j_serving, pf=j_pf, faults=j_faults, parse=j_parse,
        recorder=JTraceRecorder, cfg=jcfg, params=tree, place={})
    port = SimpleNamespace(
        name="port", serving=t_serving, pf=t_pf, faults=t_faults, parse=parse_prometheus,
        recorder=TraceRecorder, cfg=tcfg, params=tparams, place={"device": "cpu"})
    return jax_pkg, port


def solo_greedy(pkg, prompt, n):
    if pkg.name == "jax":
        out = j_gen.generate(pkg.params, pkg.cfg, jnp.asarray(prompt, jnp.int32)[None], n)
        return np.asarray(out)[0, len(prompt):].tolist()
    return gen.generate(pkg.params, pkg.cfg, [prompt], n, device="cpu")[0, len(prompt):].tolist()


def both(pkgs, scenario):
    """``scenario(pkg)`` in both packages; the results must be equal.
    Returns the port's."""
    jax_out, port_out = (scenario(pkg) for pkg in pkgs)
    assert port_out == jax_out
    return port_out


def make_procfleet(pkg, n_replicas=2, pspec=None, server_kwargs=None,
                   sup_kwargs=None, **router_kw):
    """tests/test_procfleet.py's fleet in ``pkg``: loopback backends on a
    virtual clock with fast backoffs."""
    pinj = pkg.faults.ProcessFaultInjector(pspec) if pspec is not None else None
    sup = pkg.pf.ProcessSupervisor(
        pkg.pf.loopback_backend_factory(pkg.params, pkg.cfg, n_slots=2, **pkg.place,
                                        **(server_kwargs or {})),
        n_replicas=n_replicas, clock=pkg.serving.VirtualClock(tick_s=0.001),
        process_injector=pinj, max_restarts=router_kw.pop("max_restarts", 1),
        restart_backoff_s=0.01, **(sup_kwargs or {}))
    streamed = {}
    router = pkg.pf.ProcRouter(
        sup, on_token=lambda fh, t: streamed.setdefault(fh.request_id, []).append(t),
        max_retries=router_kw.pop("max_retries", 3), retry_backoff_s=0.01,
        breaker_reset_s=0.05, **router_kw)
    return router, sup, streamed


def handles_record(handles):
    return [(h.request_id, h.tokens, h.finish_reason, h.attempts, h.replica)
            for h in handles]


# ---------------------------------------------------------------------------
# the chaos report: byte-identical across runs, equal across packages
# ---------------------------------------------------------------------------


def _chaos_report(pkg) -> str:
    """A kill -9 on replica0's third step RPC, a slow socket on replica1
    (clock skew, never a sleep), then a drain with migration, as
    sorted-key JSON."""
    router, sup, streamed = make_procfleet(
        pkg, pspec="kill:nth=3:match=replica0;slow_socket:every=2:delay=0.01:match=replica1",
        server_kwargs=dict(prefix_cache_mb=2.0))
    handles = [router.submit(pkg.serving.Request(prompt=p, max_new_tokens=6))
               for p in PROMPTS]
    router.run_until_drained(max_steps=10000)
    src = next(rep.name for rep in sup.replicas if rep.state == "ready")
    migration = router.migrate_and_drain(src)
    doc = {
        "tokens": {h.request_id: h.tokens for h in handles},
        "reasons": {h.request_id: h.finish_reason for h in handles},
        "attempts": {h.request_id: h.attempts for h in handles},
        "replicas": {h.request_id: h.replica for h in handles},
        "streams": streamed,
        "fired": sup.process_injector.fired,
        "summary": router.summary(),
        "migration": migration,
        "exits": sup.shutdown_all(),
    }
    return json.dumps(doc, sort_keys=True)


@pytest.fixture(scope="module")
def chaos_reports(pkgs):
    jax_pkg, port = pkgs
    return _chaos_report(jax_pkg), _chaos_report(port), _chaos_report(port)


def test_chaos_report_byte_identical_across_runs(chaos_reports):
    jax_report, a, b = chaos_reports
    assert a == b
    assert a == jax_report  # the same story, byte for byte, in both packages
    doc = json.loads(a)
    assert set(doc["reasons"].values()) == {"length"}
    assert "kill:replica0" in doc["fired"]
    assert "slow_socket:replica1" in doc["fired"]
    assert doc["migration"]["outcome"] == "ok"
    assert doc["migration"]["src_exit_code"] == 75


def test_chaos_tokens_match_solo_and_streams_dedup(pkgs, chaos_reports):
    doc = json.loads(chaos_reports[1])
    for i, p in enumerate(PROMPTS):
        rid = f"fleet-{i}"
        assert doc["tokens"][rid] == solo_greedy(pkgs[1], p, 6) == solo_greedy(pkgs[0], p, 6)
        assert doc["streams"][rid] == doc["tokens"][rid]
    assert doc["summary"]["duplicates_suppressed"] >= 1


# ---------------------------------------------------------------------------
# mingpt-rpc/1 validators and the transfer channel
# ---------------------------------------------------------------------------


def _tamper_verdicts(pf):
    good = pf.envelope("submit_result", request_id="r1", queue_depth=0)
    pf.validate_envelope(good)
    pf.validate_envelope(good, kind="submit_result")
    out = []
    try:
        pf.validate_envelope(good, kind="step_result")
        out.append("accepted")
    except pf.EnvelopeError:
        out.append("rejected")
    tampers = [
        lambda d: d.pop("schema"),
        lambda d: d.update(schema="mingpt-rpc/2"),
        lambda d: d.pop("kind"),
        lambda d: d.update(kind="gossip"),
        lambda d: d.pop("request_id"),
        lambda d: d.update(request_id=7),
        lambda d: d.update(queue_depth="3"),
        lambda d: d.update(queue_depth=True),
    ]
    for tamper in tampers:
        doc = dict(good)
        tamper(doc)
        try:
            pf.validate_envelope(doc)
            out.append("accepted")
        except pf.EnvelopeError as e:
            out.append(str(e))
    return out


def test_envelope_validator_tamper_battery():
    got = _tamper_verdicts(t_pf)
    assert got == _tamper_verdicts(j_pf)  # the same verdicts, the same messages
    assert "accepted" not in got


def _event_verdicts(pf):
    ok = pf.envelope("step_result", events=[
        {"type": "emit", "request_id": "r", "token": 3, "token_index": 0},
        {"type": "finish", "request_id": "r", "finish_reason": "length", "n_tokens": 1},
    ], queue_depth=0, occupied=0, recompiles=0, busy=False)
    pf.validate_envelope(ok, kind="step_result")
    out = []
    for bad_ev in (
        {"type": "emit", "request_id": "r", "token": 3},
        {"type": "emit", "request_id": "r", "token": 3.5, "token_index": 0},
        {"type": "levitate", "request_id": "r"},
    ):
        try:
            pf.envelope("step_result", events=[bad_ev], queue_depth=0, occupied=0,
                        recompiles=0, busy=False)
            out.append("accepted")
        except pf.EnvelopeError as e:
            out.append(str(e))
    return out


def test_step_result_event_validation():
    got = _event_verdicts(t_pf)
    assert got == _event_verdicts(j_pf) and "accepted" not in got


def test_transfer_channel_tamper_battery():
    frames = [
        ({"type": "manifest", "replica": "replica0", "unfinished": [], "n_frames": 1}, b""),
        ({"type": "prefix_entry", "key": [1, 2, 3]}, b"\x01\x02\x03\x04"),
    ]
    blob = t_pf.pack_frames(frames)
    assert blob == j_pf.pack_frames(frames)
    assert t_pf.unpack_frames(blob) == frames
    assert t_pf.pack_frames(frames) == blob
    for bad in (b"NOTMAGIC" + blob[len(t_pf.FRAME_MAGIC):], blob[:-1],
                blob[: len(t_pf.FRAME_MAGIC) + 4], blob + b"\x00"):
        with pytest.raises(t_pf.EnvelopeError):
            t_pf.unpack_frames(bad)
        with pytest.raises(j_pf.EnvelopeError):
            j_pf.unpack_frames(bad)


# ---------------------------------------------------------------------------
# respawn-budget exhaustion
# ---------------------------------------------------------------------------


def test_respawn_budget_exhaustion_fails_loudly(pkgs):
    """Every step RPC SIGKILLs its worker and the restart budget runs out:
    the accepted requests end with finish_reason=error, every crash reaped
    as exit -9."""
    def run(pkg):
        router, sup, _ = make_procfleet(pkg, pspec="kill:every=1", max_retries=2)
        handles = [router.submit(pkg.serving.Request(prompt=p, max_new_tokens=4))
                   for p in PROMPTS[:2]]
        router.run_until_drained(max_steps=5000)
        return (handles_record(handles), router.summary(),
                [(c["replica"], c["exit_code"]) for c in sup.crash_reports],
                [rep.state for rep in sup.replicas])

    handles, s, crashes, states = both(pkgs, run)
    assert all(reason == "error" for _, _, reason, _, _ in handles)
    assert s["pending"] == 0 and s["in_flight"] == 0
    assert s["requests_by_outcome"]["error"] == 2
    assert crashes and all(code == -9 for _, code in crashes)
    assert states == ["crashed", "crashed"]


# ---------------------------------------------------------------------------
# live migration
# ---------------------------------------------------------------------------


def test_migration_mid_prefill_resumes_on_peer(pkgs):
    """A request migrated mid-prefill (chunks of 4, 24-token prompt):
    the shipped rows become a prefix entry on the peer, the re-submitted
    request hits it and ends bit-identical to an undisturbed run."""
    long_prompt = list(range(1, 25))

    def run(pkg):
        router, sup, streamed = make_procfleet(
            pkg, server_kwargs=dict(prefill_chunk=4, prefix_cache_mb=4.0))
        h = router.submit(pkg.serving.Request(prompt=long_prompt, max_new_tokens=6))
        src = None
        for _ in range(200):
            router.step()
            for rep in sup.replicas:
                for wh in rep.backend.worker.server.unfinished():
                    if wh.prefilling and wh.prefill_pos > 0:
                        src = rep
            if src is not None:
                break
        assert src is not None, "request never observed mid-prefill"
        report = router.migrate_and_drain(src.name)
        router.run_until_drained(max_steps=5000)
        dst = sup.replica_by_name(report["to"])
        return (report, handles_record([h]), streamed[h.request_id] == h.tokens,
                dst.backend.worker.server.metrics.prefix_hits,
                router.summary()["retries_by_reason"])

    report, ((rid, tokens, reason, _, _),), streamed_ok, hits, retries = both(pkgs, run)
    assert report["outcome"] == "ok" and rid in report["requests_moved"]
    assert report["entries_installed"] >= 1 and report["src_exit_code"] == 75
    assert reason == "length" and tokens == solo_greedy(pkgs[1], long_prompt, 6)
    assert streamed_ok and hits >= 1
    assert all(v == 0 for v in retries.values())


def test_migrated_prefix_entries_stay_head_sharded_tp2(pkgs):
    """At tp = 1 (tensor parallelism is ROADMAP.md Queue 1 item 9): the
    adopted entry lands on the destination engine's device with the pool's
    dtype and every KV head, bit-equal to the source's rows."""
    prompt = [5, 6, 7, 8, 9, 10, 11, 12, 13]

    def run(pkg):
        router, sup, _ = make_procfleet(
            pkg, server_kwargs=dict(prefix_cache_mb=4.0, prefill_buckets=(8, 16, 32)))
        h = router.submit(pkg.serving.Request(prompt=prompt, max_new_tokens=4))
        router.run_until_drained(max_steps=2000)
        src = sup.replica_by_name(h.replica)
        before = {k: {n: np.asarray(a) for n, a in e.items()}
                  for k, e in src.backend.worker.server.engine.prefix_store.entries()}
        report = router.migrate_and_drain(src.name)
        dst = sup.replica_by_name(report["to"])
        entries = dst.backend.worker.server.engine.prefix_store.entries()
        got = {k: {n: np.asarray(a) for n, a in e.items()} for k, e in entries}
        return report, h.finish_reason, before, got, entries

    (_, j_reason, j_before, j_got, _), (report, reason, before, got, entries) = (
        run(pkg) for pkg in pkgs)
    assert reason == j_reason == "length"
    assert report["outcome"] == "ok" and report["entries_installed"] >= 1
    assert sorted(got) == sorted(j_got) and got
    for key, entry in entries:
        for name, t in entry.items():
            assert t.device.type == "cpu" and t.dtype == torch.float32
            assert t.shape[3] == pkgs[1].cfg.kv_heads  # every head, one device
            assert np.array_equal(got[key][name], before[key][name])
            np.testing.assert_allclose(got[key][name], j_got[key][name], atol=1e-5)


# ---------------------------------------------------------------------------
# warm standby, the hang ladder
# ---------------------------------------------------------------------------


class _EventSink:
    def __init__(self):
        self.records = []

    def write(self, kind, rec):
        self.records.append((kind, rec))

    def close(self):
        pass


def _kill_run(pkg, standby):
    sink = _EventSink()
    router, sup, streamed = make_procfleet(
        pkg, pspec="kill:nth=3:match=replica0", sup_kwargs=dict(standby=standby),
        trace_recorder=pkg.recorder(sink=sink))
    handles = [router.submit(pkg.serving.Request(prompt=p, max_new_tokens=6))
               for p in PROMPTS]
    router.run_until_drained(max_steps=10000)
    for _ in range(500):
        if sup.recovery_log:
            break
        router.step()
    page = pkg.parse(router.fleet_metrics_page())
    got = {(n, tuple(sorted(lab.items()))): v for n, lab, v in page["samples"]}
    return {
        "handles": handles_record(handles),
        "streams_ok": [streamed[h.request_id] == h.tokens for h in handles],
        "recovery": [{k: r[k] for k in ("replica", "path", "adopted", "recovery_s")}
                     for r in sup.recovery_log],
        "pool": None if sup.standby_pool is None else sup.standby_pool.available(),
        "failovers": [{k: rec[k] for k in ("from_replica", "to_replica", "path")}
                      for kind, rec in sink.records
                      if kind == "event" and rec["name"] == "failover"],
        "adoptions": got.get(("mingpt_fleet_standby_adoptions_total", ())),
        "pool_gauge": got.get(("mingpt_fleet_standby_pool_size", ())),
    }


def test_standby_adoption_beats_cold_respawn(pkgs):
    runs = {path: both(pkgs, lambda pkg, s=standby: _kill_run(pkg, s))
            for path, standby in (("cold", 0), ("standby", 1))}
    for run in runs.values():
        for p, (_, tokens, reason, _, _) in zip(PROMPTS, run["handles"]):
            assert reason == "length" and tokens == solo_greedy(pkgs[1], p, 6)
        assert all(run["streams_ok"])
    rec_cold, rec_stby = runs["cold"]["recovery"][0], runs["standby"]["recovery"][0]
    assert rec_cold["path"] == "cold" and rec_cold["adopted"] is None
    assert rec_stby["path"] == "standby" and rec_stby["adopted"] == "standby0"
    assert rec_stby["recovery_s"] < rec_cold["recovery_s"]
    assert runs["standby"]["pool"] == 1
    events = runs["standby"]["failovers"]
    assert events and all(e == {"from_replica": "replica0", "to_replica": "standby0",
                                "path": "standby"} for e in events)
    assert runs["standby"]["adoptions"] == 1 and runs["standby"]["pool_gauge"] == 1


def test_hang_escalation_sigterm_then_sigkill(pkgs):
    """stuck_step wedges replica0: the ladder fires SIGTERM (refused),
    SIGKILL after the grace, and the crash path recovers by adoption."""
    def run(pkg):
        router, sup, streamed = make_procfleet(
            pkg, pspec="stuck_step:nth=3:match=replica0",
            sup_kwargs=dict(standby=1, hang_deadline_s=0.01, hang_kill_grace_s=0.005))
        ladder = []
        orig = sup.poll_liveness

        def spy():
            out = orig()
            ladder.extend(out)
            return out

        sup.poll_liveness = spy
        handles = [router.submit(pkg.serving.Request(prompt=p, max_new_tokens=6))
                   for p in PROMPTS]
        router.run_until_drained(max_steps=10000)
        crash = next(c for c in sup.crash_reports if c["replica"] == "replica0")
        rec = sup.recovery_info("replica0")
        page = pkg.parse(router.fleet_metrics_page())
        esc = {lab.get("signal"): v for n, lab, v in page["samples"]
               if n == "mingpt_fleet_hang_escalations_total"}
        return (handles_record(handles), [streamed[h.request_id] == h.tokens for h in handles],
                ladder, crash["exit_code"], rec["path"], sup.replica_by_name("replica0").state,
                esc)

    handles, streams_ok, ladder, code, path, state, esc = both(pkgs, run)
    for p, (_, tokens, reason, _, _) in zip(PROMPTS, handles):
        assert reason == "length" and tokens == solo_greedy(pkgs[1], p, 6)
    assert all(streams_ok)
    assert ladder == [("replica0", "term"), ("replica0", "kill")]
    assert code == -9 and path == "standby" and state == "ready"
    assert esc == {"term": 1, "kill": 1}


def test_hang_deadline_none_never_escalates(pkgs):
    def run(pkg):
        router, sup, _ = make_procfleet(pkg, sup_kwargs=dict(standby=0))
        first = sup.poll_liveness()
        h = router.submit(pkg.serving.Request(prompt=PROMPTS[0], max_new_tokens=4))
        router.run_until_drained(max_steps=2000)
        return first, h.finish_reason, sup.poll_liveness()

    assert both(pkgs, run) == ([], "length", [])


def test_standby_pool_exhausted_falls_back_cold_loudly(pkgs, capsys):
    """Both replicas die in the same round against a 1-deep pool: the
    first respawn adopts the spare, the second cold-spawns and says so on
    stderr."""
    def run(pkg):
        router, sup, streamed = make_procfleet(
            pkg, pspec="kill:nth=3:match=replica0;kill:nth=3:match=replica1",
            sup_kwargs=dict(standby=1))
        handles = [router.submit(pkg.serving.Request(prompt=p, max_new_tokens=6))
                   for p in PROMPTS]
        router.run_until_drained(max_steps=10000)
        for _ in range(500):
            if len(sup.recovery_log) >= 2:
                break
            router.step()
        err = capsys.readouterr().err
        return (handles_record(handles), [streamed[h.request_id] == h.tokens for h in handles],
                {r["replica"]: r["path"] for r in sup.recovery_log},
                "standby pool exhausted" in err,
                sup.replica_by_name("replica1").last_spawn_path,
                sup.standby_pool.available())

    handles, streams_ok, paths, loud, spawn_path, available = both(pkgs, run)
    for p, (_, tokens, reason, _, _) in zip(PROMPTS, handles):
        assert reason == "length" and tokens == solo_greedy(pkgs[1], p, 6)
    assert all(streams_ok)
    assert paths == {"replica0": "standby", "replica1": "cold"}
    assert loud and spawn_path == "cold" and available == 1


def _decode_src(router, sup):
    for _ in range(500):
        router.step()
        for rep in sup.replicas:
            for wh in rep.backend.worker.server.unfinished():
                if not wh.prefilling:
                    return rep
    return None


def _spec_migration(pkg, prompt):
    router, sup, streamed = make_procfleet(
        pkg, server_kwargs=dict(draft_params=pkg.params, draft_cfg=pkg.cfg, spec_k=3,
                                prefill_chunk=4, prefill_buckets=(8, 16, 32)))
    h = router.submit(pkg.serving.Request(prompt=prompt, max_new_tokens=6))
    src = _decode_src(router, sup)
    assert src is not None, "request never observed mid-decode"
    report = router.migrate_and_drain(src.name)
    spec_dec = sup.replica_by_name(report["to"]).backend.worker.server.spec
    return router, h, streamed, report, spec_dec


def test_migrated_spec_request_resumes_without_draft_prefill(pkgs):
    """Draft-pool rows ride the transfer channel: a bucket-aligned prompt
    re-primes on the peer with no draft prefill call."""
    prompt = list(range(1, 9))

    def run(pkg):
        router, h, streamed, report, spec_dec = _spec_migration(pkg, prompt)
        parked = bool(spec_dec.pending_draft)
        prefills = []
        orig = spec_dec.draft.engine.prefill_chunk_call
        spec_dec.draft.engine.prefill_chunk_call = (
            lambda *a, **kw: prefills.append(a) or orig(*a, **kw))
        router.run_until_drained(max_steps=5000)
        return (report, parked, handles_record([h]), streamed[h.request_id] == h.tokens,
                spec_dec.prime_adopted, len(prefills), bool(spec_dec.pending_draft))

    report, parked, ((_, tokens, reason, _, _),), streamed_ok, adopted, prefills, left = (
        both(pkgs, run))
    assert report["outcome"] == "ok" and report["draft_rows_installed"] >= 1
    assert parked and reason == "length" and streamed_ok
    assert tokens == solo_greedy(pkgs[1], prompt, 6)
    assert adopted == 1 and prefills == 0 and not left


def test_migrated_draft_rows_stay_head_sharded_tp2(pkgs):
    """At tp = 1 (tensor parallelism is ROADMAP.md Queue 1 item 9): the
    parked draft rows sit on the draft engine's device with every KV head
    in the draft pool's dtype, keyed by the prompt's head, and the adopted
    prime decodes token-exact."""
    prompt = list(range(1, 9))

    def run(pkg):
        router, h, _, report, spec_dec = _spec_migration(pkg, prompt)
        parked = {k: {n: tuple(a.shape) for n, a in e.items()}
                  for k, e in spec_dec.pending_draft.items()}
        tensors = list(spec_dec.pending_draft.items())
        router.run_until_drained(max_steps=5000)
        return (report["outcome"], report["draft_rows_installed"], parked,
                handles_record([h]), spec_dec.prime_adopted), tensors

    (jax_rec, _), (rec, tensors) = (run(pkg) for pkg in pkgs)
    assert rec == jax_rec
    outcome, installed, parked, ((_, tokens, reason, _, _),), adopted = rec
    assert outcome == "ok" and installed >= 1 and parked
    for key, entry in tensors:
        assert list(key) == prompt[:len(key)]
        for t in entry.values():
            assert t.device.type == "cpu" and t.shape[3] == pkgs[1].cfg.kv_heads
    assert reason == "length" and tokens == solo_greedy(pkgs[1], prompt, 6)
    assert adopted >= 1


# ---------------------------------------------------------------------------
# the wire between the packages
# ---------------------------------------------------------------------------


def _captured_envelopes(pkg, transport_cls, monkeypatch):
    """Every JSON envelope of a chaos run over ``pkg``'s loopback
    transport: the request bodies and the JSON responses."""
    seen = []
    real = transport_cls._dispatch

    def spy(self, method, path, body):
        status, ctype, payload = real(self, method, path, body)
        if body and path != "/rpc/migrate_in":
            seen.append(json.loads(body.decode()))
        if ctype == "application/json" and path != "/attrib":
            seen.append(json.loads(payload.decode()))
        return status, ctype, payload

    monkeypatch.setattr(transport_cls, "_dispatch", spy)
    _chaos_report(pkg)
    monkeypatch.undo()
    return seen


def test_envelopes_validate_across_packages(pkgs, monkeypatch):
    from mingpt_distributed_tpu.serving.procfleet.transport import (
        LoopbackTransport as JLoopbackTransport,
    )

    jax_pkg, port = pkgs
    port_docs = _captured_envelopes(port, LoopbackTransport, monkeypatch)
    jax_docs = _captured_envelopes(jax_pkg, JLoopbackTransport, monkeypatch)
    kinds = {d["kind"] for d in port_docs}
    assert {"submit", "submit_result", "step", "step_result", "drain", "drain_result",
            "migrate_in_result"} <= kinds
    for doc in port_docs:
        j_pf.validate_envelope(doc)
    for doc in jax_docs:
        t_pf.validate_envelope(doc)
    assert [d["kind"] for d in port_docs] == [d["kind"] for d in jax_docs]


def _random_frames(rng):
    frames = []
    for i in range(rng.randint(1, 5)):
        meta = {"type": rng.choice(["manifest", "prefix_entry", "slot_rows"]),
                "key": [rng.randint(0, 100) for _ in range(rng.randint(0, 9))],
                "n": i, "f": rng.random(), "s": "é\n\"x\"", "nested": {"b": [1, None]}}
        frames.append((meta, bytes(rng.randint(0, 255) for _ in range(rng.randint(0, 64)))))
    return frames


def test_pack_frames_and_canonical_bytes_equal_across_packages():
    rng = random.Random(0)
    for _ in range(20):
        frames = _random_frames(rng)
        blob = t_pf.pack_frames(frames)
        assert blob == j_pf.pack_frames(frames)
        assert j_pf.unpack_frames(blob) == t_pf.unpack_frames(blob) == frames
        doc = dict(frames[0][0], auth={"mac": "x"})
        assert t_pf.canonical_bytes(doc) == j_pf.canonical_bytes(doc)
    assert t_pf.RPC_SCHEMA == j_pf.RPC_SCHEMA and t_pf.FRAME_MAGIC == j_pf.FRAME_MAGIC


def test_fleet_auth_macs_equal_across_packages():
    port, jax_auth = t_pf.FleetAuth("s3cr3t", sender="host0"), j_pf.FleetAuth("s3cr3t", sender="host0")
    for seq in range(5):
        doc = t_pf.envelope("heartbeat", host="host0", epoch=seq, seq=seq)
        a = port.sign(dict(doc))
        b = jax_auth.sign(dict(doc))
        assert a == b and a["auth"]["nonce"] == seq
        # each package verifies the other's stamp
        j_pf.FleetAuth("s3cr3t", sender="host1").verify(dict(a))
        t_pf.FleetAuth("s3cr3t", sender="host1").verify(dict(b))
    with pytest.raises(t_pf.BadSignature):
        t_pf.FleetAuth("other", sender="x").verify(
            j_pf.FleetAuth("s3cr3t", sender="host0").sign(
                t_pf.envelope("heartbeat", host="host0", epoch=0, seq=1)))


def _prefilled_worker(pkg, worker_mod, prompt, kv_dtype):
    """A replica worker whose server ran ``prompt`` to completion with a
    prefix store (an 8-row entry on the 8/16/32 ladder): (worker, tokens)."""
    kw = dict(n_slots=2, prefix_cache_mb=4.0, prefill_buckets=(8, 16, 32),
              kv_dtype=kv_dtype, **pkg.place)
    server = pkg.serving.InferenceServer(pkg.params, pkg.cfg, **kw)
    worker = worker_mod.ReplicaWorker(server, name="src")
    h = server.generate_batch([pkg.serving.Request(prompt=prompt, max_new_tokens=6)])[0]
    return worker, h.tokens


def _install_and_continue(pkg, worker_mod, blob, prompt, kv_dtype):
    kw = dict(n_slots=2, prefix_cache_mb=4.0, prefill_buckets=(8, 16, 32),
              kv_dtype=kv_dtype, **pkg.place)
    server = pkg.serving.InferenceServer(pkg.params, pkg.cfg, **kw)
    worker = worker_mod.ReplicaWorker(server, name="dst")
    status, _, payload = worker.handle("POST", "/rpc/migrate_in", blob)
    resp = json.loads(payload.decode())
    h = server.generate_batch([pkg.serving.Request(prompt=prompt, max_new_tokens=6)])[0]
    entries = {k: {n: np.asarray(a.float() if isinstance(a, torch.Tensor) else a)
                   for n, a in e.items()}
               for k, e in server.engine.prefix_store.entries()}
    return status, resp, h.tokens, server.metrics.prefix_hits, entries


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_migrate_blob_installs_across_packages(pkgs, kv_dtype):
    """A JAX worker's migration blob installs in a port engine (and the
    port's in a JAX engine): the entry is hit and the continuation equals
    the source's, the leaves bit-equal to what was shipped."""
    jax_pkg, port = pkgs
    prompt = [5, 6, 7, 8, 9, 10, 11, 12, 13]
    pairs = ((jax_pkg, j_worker, port, t_worker), (port, t_worker, jax_pkg, j_worker))
    for src_pkg, src_mod, dst_pkg, dst_mod in pairs:
        worker, tokens = _prefilled_worker(src_pkg, src_mod, prompt, kv_dtype)
        frames = worker.migrate_out_frames()
        blob = (j_pf if src_pkg is jax_pkg else t_pf).pack_frames(frames)
        status, resp, got, hits, entries = _install_and_continue(
            dst_pkg, dst_mod, blob, prompt, kv_dtype)
        assert status == 200 and resp["kind"] == "migrate_in_result", resp
        assert resp["installed"] >= 1 and hits >= 1
        assert got == tokens == solo_greedy(port, prompt, 6)
        shipped = {tuple(m["key"]): m for m, _ in frames if m["type"] == "prefix_entry"}
        for key, entry in entries.items():
            meta = shipped[key]
            assert sorted(entry) == [leaf["name"] for leaf in meta["leaves"]]
            for leaf in meta["leaves"]:
                assert list(entry[leaf["name"]].shape) == leaf["shape"]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "float8_e4m3fn", "int8"])
def test_leaves_round_trip_by_dtype_name(dtype_name):
    """A leaf crosses as its raw bytes under the JAX package's dtype name:
    the port reads a JAX array's bytes back bit for bit, and JAX (numpy
    with ml_dtypes) reads the port's."""
    if not hasattr(torch, dtype_name):
        pytest.skip(f"this torch has no {dtype_name}")
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((2, 1, 8, 2, 16)).astype(np.float32) * 4
    if dtype_name == "int8":
        vals = np.clip(np.round(vals * 8), -127, 127)
    j_arr = np.asarray(jnp.asarray(vals, dtype=getattr(jnp, dtype_name)))
    assert str(j_arr.dtype) == dtype_name
    leaf = {"name": "k", "dtype": str(j_arr.dtype), "shape": list(j_arr.shape),
            "nbytes": int(j_arr.nbytes)}
    t = t_worker.tensor_from_wire(leaf, j_arr.tobytes())
    assert t.dtype == getattr(torch, dtype_name) and list(t.shape) == leaf["shape"]
    np.testing.assert_array_equal(t.float().numpy(), j_arr.astype(np.float32))
    meta, raw = t_worker.tensor_to_wire(t)
    assert meta == {k: leaf[k] for k in ("dtype", "shape", "nbytes")} and raw == j_arr.tobytes()
    back = np.frombuffer(raw, dtype=np.dtype(meta["dtype"])).reshape(meta["shape"])
    np.testing.assert_array_equal(back.astype(np.float32), j_arr.astype(np.float32))


def test_bf16_engine_rows_migrate_bit_equal():
    """A bf16 model's pool ships bf16 leaves: two port workers, the rows
    bit-equal on the peer and the continuation equal."""
    cfg = GPTConfig.make(**dict(TINY, dtype="bfloat16"))
    from mingpt_distributed_tpu_torch.models import gpt

    params = gpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    pkg = SimpleNamespace(serving=t_serving, params=params, cfg=cfg, place={"device": "cpu"})
    prompt = [5, 6, 7, 8, 9, 10, 11, 12, 13]
    worker, tokens = _prefilled_worker(pkg, t_worker, prompt, "fp32")
    frames = worker.migrate_out_frames()
    leaves = [leaf for m, _ in frames[1:] for leaf in m["leaves"]]
    assert leaves and all(leaf["dtype"] == "bfloat16" for leaf in leaves)
    src = dict(worker.server.engine.prefix_store.entries())
    status, resp, got, hits, _ = _install_and_continue(
        pkg, t_worker, t_pf.pack_frames(frames), prompt, "fp32")
    assert status == 200 and resp["installed"] >= 1 and hits >= 1 and got == tokens


# ---------------------------------------------------------------------------
# the process fault injector, the worker's spec, the CLI
# ---------------------------------------------------------------------------


def test_process_injector_schedule_matches_jax():
    spec = "kill:nth=2:match=replica0;hang:nth=1:match=replica1;stuck_step:nth=3:match=replica1"

    def run(mod):
        inj = mod.ProcessFaultInjector(spec)
        out = []
        for i in range(5):
            for rep in ("replica0", "replica1"):
                try:
                    out.append((rep, i, inj.rpc_verdict(rep)))
                except mod.InjectedServingFault as e:
                    out.append((rep, i, type(e).__name__))
        inj.reset("replica1")
        out.append(inj.is_stuck("replica1"))
        return out, inj.fired

    assert run(t_faults) == run(j_faults)
    with pytest.raises(ValueError, match="process fault op"):
        t_faults.ProcessFaultInjector("crash:nth=1")
    assert issubclass(t_faults.ProcessKilled, t_faults.ReplicaCrashed)
    assert issubclass(t_faults.WorkerStuck, t_faults.InjectedHang)


def test_worker_spec_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_worker.build_worker_from_spec({"cfg": TINY, "init_seed": 0})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_worker.build_worker_from_spec({"cfg": TINY, "init_seed": 0, "device": "cuda"})


def test_process_backend_raises_with_the_workers_stderr(tmp_path):
    """A worker that dies before its hello (here: asked for cuda on a
    machine without one) makes the factory raise with its stderr tail."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the CPU-only behaviour")
    make = t_pf.process_backend_factory({"cfg": TINY, "init_seed": 0, "device": "cuda"},
                                        str(tmp_path))
    with pytest.raises(RuntimeError, match="died before hello(.|\n)*no CUDA device"):
        make(name="replica0", clock=None, fault_hook=None)


def test_worker_weights_from_seed_and_params_equal_the_parents(pkgs, tmp_path):
    """``init_seed`` draws the port's init on a CPU generator (the parent's
    weights bit for bit); ``params`` reads a flat .npz of the JAX tree."""
    from mingpt_distributed_tpu_torch.models import gpt

    _, port = pkgs
    w = t_worker.build_worker_from_spec({"cfg": TINY, "init_seed": 3, "device": "cpu"})
    want = gpt.init(port.cfg, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(w.server.engine.params[k], want[k])
               for k in want if k != "blocks")
    path = str(tmp_path / "p.npz")
    np.savez(path, **convert.flatten(jax.tree.map(np.array, pkgs[0].params)))
    w2 = t_worker.build_worker_from_spec({"cfg": TINY, "params": path, "device": "cpu"})
    for k, v in w2.server.engine.params["blocks"].items():
        assert torch.equal(v, port.params["blocks"][k])


def test_selftest_procfleet_cli_real_subprocesses(capsys):
    assert t_serve.main(["--selftest-procfleet", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "selftest-procfleet PASSED" in out
    assert "kill -9" in out and '"src_exit_code": 75' in out


def test_serve_prompts_file_process_isolation_equals_thread(tmp_path, capsys):
    """serve --replicas 2 --isolation process over a trainer's snapshot:
    each worker restores the snapshot itself, and the completions equal
    --isolation thread's byte for byte; the drained workers exit 75."""
    import os
    import re

    from mingpt_distributed_tpu_torch import train as t_train

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = ["--config", os.path.join(repo, "gpt2_config.yaml"), "gpt_config.n_layer=2",
            "gpt_config.n_head=4", "gpt_config.n_embd=64", "gpt_config.dtype=float32",
            "gpt_config.attn_pdrop=0", f"data_config.path={os.path.join(repo, 'data', 'input.txt')}",
            "data_config.block_size=32", "data_config.truncate=0.2",
            f"trainer_config.snapshot_path={tmp_path / 'snap.pt'}"]
    assert t_train.main(["--device", "cpu", *argv, "trainer_config.batch_size=8",
                         "trainer_config.max_steps=3", "trainer_config.eval_batches=1"]) == 0
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("the king \nand so \nwhat is \n")
    capsys.readouterr()
    outs = {}
    for isolation in ("thread", "process"):
        assert t_serve.main(["--prompts-file", str(prompts), "--device", "cpu", "--greedy",
                             "--max-new-tokens", "7", "--slots", "2", "--replicas", "2",
                             "--isolation", isolation, "--spill-dir", str(tmp_path / "spill"),
                             *argv]) == 0
        cap = capsys.readouterr()
        outs[isolation] = re.split(r"^=== fleet-\d+ \(length\) ===\n", cap.out, flags=re.M)[1:]
        outs[isolation][-1] = outs[isolation][-1].rsplit("\n{", 1)[0]
        if isolation == "process":
            assert "process fleet: 2 worker processes x 2 slots" in cap.err
            assert "worker exits: {'replica0': 75, 'replica1': 75}" in cap.err
    assert len(outs["thread"]) == 3 and outs["process"] == outs["thread"]


def test_merge_fleet_pages_equals_jax():
    """merge_fleet_pages over rendered pages (what a process fleet has of
    its workers): byte-equal to the JAX package's, one TYPE line per family
    under the strict parser, and a kind conflict raises in both."""
    from mingpt_distributed_tpu.telemetry import merge_fleet_pages as j_merge
    from mingpt_distributed_tpu_torch.telemetry import (
        MetricsRegistry,
        merge_fleet_pages,
        render_prometheus,
    )

    def page(steps, label):
        reg = MetricsRegistry()
        reg.counter("mingpt_serve_steps_total", help='rounds "run"\\n').inc(steps)
        h = reg.histogram("mingpt_serve_ttft_seconds", help="ttft", labels=("tenant",))
        h.labels(tenant=label).observe(0.01 * steps)
        return render_prometheus(reg)

    base = MetricsRegistry()
    base.gauge("mingpt_fleet_hosts", help="hosts", labels=("state",)).labels(state="alive").set(2)
    pages = {"replica1": page(3, "b"), "replica0": page(5, "a")}
    for label in ("replica", "host"):
        got = merge_fleet_pages(render_prometheus(base), pages, label=label)
        assert got == j_merge(render_prometheus(base), pages, label=label)
        parsed = parse_prometheus(got)
        assert parsed["types"]["mingpt_serve_steps_total"] == "counter"
        steps = {s[1][label]: s[2] for s in parsed["samples"]
                 if s[0] == "mingpt_serve_steps_total"}
        assert steps == {"replica0": 5.0, "replica1": 3.0}
    bad = "# TYPE mingpt_serve_steps_total gauge\nmingpt_serve_steps_total 1\n"
    with pytest.raises(ValueError, match="incoherent"):
        merge_fleet_pages(None, {"a": pages["replica0"], "b": bad})
    with pytest.raises(ValueError):
        j_merge(None, {"a": pages["replica0"], "b": bad})


@pytest.mark.parametrize("cls, env, spec", [
    ("ProcessFaultInjector", "MINGPT_PROCESS_FAULTS", "kill:nth=1:match=replica0"),
    ("NetworkFaultInjector", "MINGPT_NET_FAULTS", "host_kill:nth=1:match=host0"),
])
def test_fault_env_knobs(monkeypatch, cls, env, spec):
    """With no spec given, each injector reads its environment knob, the
    JAX package's name for it."""
    assert getattr(t_faults, env.replace("MINGPT_", "").replace("FAULTS", "ENV_VAR")) == env
    monkeypatch.setenv(env, spec)
    port, jax_inj = getattr(t_faults, cls)(), getattr(j_faults, cls)()
    assert [(s.op, s.nth, s.match) for s in port.specs] == [
        (s.op, s.nth, s.match) for s in jax_inj.specs] == [(spec.split(":")[0], 1,
                                                           spec.rsplit("=", 1)[1])]
