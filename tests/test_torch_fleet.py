"""The port's in-process fleet (serving/fleet.py) and serving chaos
(training/faults.py's serving half) against the JAX package's.

Counterparts of the 19 tests of tests/test_fleet.py: circuit breakers, the
serving fault injector, routing and idempotent retry under crashes (with and
without speculation), restart, admission faults, poisoned rounds, the retry
budget, watermark / breaker / deadline / drain shedding, health gating and
the fleet's gauges. Every model-backed scenario runs in BOTH packages on the
same parameters (the port's converted from the JAX init, ``models/
convert.py``) and the same requests: the router's summaries (crashes, retries
by reason, duplicates suppressed, requests by outcome, rejections, health,
clock skew) and each request's tokens, outcome, replica and attempts must be
equal, besides the JAX tests' own assertions on the port. Greedy tokens are
exact. Then what only the port has: the chaos self-test's scenario (3
replicas x 2 slots, ``crash:nth=6:match=replica0;slow:...:match=replica1``)
against JAX's, a crashed server freed before its replacement allocates, the
fault hook once per round in both decode lanes, and the serve CLI's fleet
flags. CPU, the JAX tests' tiny config (2 layers, 2 heads, 32 wide, V = 50,
block 32, fp32), virtual clocks, no sleeps.
"""

import gc
import os
import weakref
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mingpt_distributed_tpu.serving as j_serving
import mingpt_distributed_tpu.telemetry as j_telemetry
from mingpt_distributed_tpu.config import GPTConfig as JConfig
from mingpt_distributed_tpu.models import generate as j_gen
from mingpt_distributed_tpu.models import gpt as j_gpt
from mingpt_distributed_tpu.telemetry.export import render_prometheus as j_render
from mingpt_distributed_tpu.training import faults as j_faults
from mingpt_distributed_tpu_torch import serve as t_serve
from mingpt_distributed_tpu_torch import serving as t_serving
from mingpt_distributed_tpu_torch import telemetry as t_telemetry
from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import generate as gen
from mingpt_distributed_tpu_torch.serving import CircuitBreaker, InferenceServer, Request
from mingpt_distributed_tpu_torch.telemetry import render_prometheus
from mingpt_distributed_tpu_torch.training import faults as t_faults
from mingpt_distributed_tpu_torch.training.faults import ServingFaultInjector

TINY = dict(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32,
            embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13], [40, 41]]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's tiny models: their ops are too
    small to share out, and when the suite runs in parallel workers each
    worker's default of one thread per core makes them contend (a sweep
    took 37 s instead of 2 under five busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pkgs():
    """The two packages over one parameter tree: (JAX, port) namespaces of
    serving modules, fault injector, metrics registry, config, params and
    the server kwargs that place a replica (the port's on the CPU)."""
    jcfg, tcfg = JConfig.make(**TINY), GPTConfig.make(**TINY)
    tree = j_gpt.init(jax.random.key(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.array, tree), tcfg, "cpu")
    jax_pkg = SimpleNamespace(
        name="jax", serving=j_serving, faults=j_faults, registry=j_telemetry.MetricsRegistry,
        render=j_render, cfg=jcfg, params=tree, place={})
    port = SimpleNamespace(
        name="port", serving=t_serving, faults=t_faults, registry=t_telemetry.MetricsRegistry,
        render=render_prometheus, cfg=tcfg, params=tparams, place={"device": "cpu"})
    return jax_pkg, port


def make_fleet(pkg, n_replicas=2, spec=None, n_slots=2, registry=None,
               factory_kwargs=None, **router_kw):
    """tests/test_fleet.py's fleet in ``pkg``: a virtual clock with fast
    backoffs, so every retry and restart resolves within a few ticks."""
    s = pkg.serving
    injector = pkg.faults.ServingFaultInjector(spec) if spec is not None else None
    sup = s.ReplicaSupervisor(
        s.default_server_factory(pkg.params, pkg.cfg, n_slots=n_slots,
                                 **pkg.place, **(factory_kwargs or {})),
        n_replicas=n_replicas, clock=s.VirtualClock(tick_s=0.001),
        injector=injector, registry=registry, max_restarts=1,
        restart_backoff_s=0.01, itl_slo_s=router_kw.pop("itl_slo_s", 0.1))
    return s.Router(sup, max_retries=router_kw.pop("max_retries", 3),
                    retry_backoff_s=0.01, breaker_reset_s=0.05, **router_kw)


def prompts_with_affinity(router, index, n, length=3):
    """n prompts whose affinity hash lands on replica ``index``."""
    out = []
    for start in range(1, 200):
        p = [start + j for j in range(length)]
        if max(p) < 50 and router._affinity_index(p) == index:
            out.append(p)
            if len(out) == n:
                return out
    raise AssertionError(f"no {n} prompts hash to replica {index}")


def solo_greedy(pkg, prompt, n):
    if pkg.name == "jax":
        out = j_gen.generate(pkg.params, pkg.cfg, jnp.asarray(prompt, jnp.int32)[None], n)
        return np.asarray(out)[0, len(prompt):].tolist()
    return gen.generate(pkg.params, pkg.cfg, [prompt], n, device="cpu")[0, len(prompt):].tolist()


def record(router, handles):
    """What the two packages' runs are held equal on."""
    return {"summary": router.summary(),
            "handles": [(h.tokens, h.finish_reason, h.attempts, h.replica,
                         h.duplicates_suppressed) for h in handles]}


def both(pkgs, scenario):
    """Run ``scenario(pkg)`` in both packages; its JAX and port results
    must be equal. Returns the port's."""
    jax_out, port_out = (scenario(pkg) for pkg in pkgs)
    assert port_out == jax_out
    return port_out


# ---------------------------------------------------------------------------
# circuit breaker (pure unit)
# ---------------------------------------------------------------------------


def _breaker_walk(cls):
    t = {"now": 0.0}
    b = cls(lambda: t["now"], failure_threshold=2, reset_after_s=1.0)
    seen = [(b.state, b.allow())]
    b.record_failure()
    seen.append(b.state)
    b.record_failure()
    seen.append((b.state, b.allow()))
    t["now"] = 1.5
    seen.append((b.allow(), b.state))
    b.start_probe()
    seen.append(b.allow())
    b.record_success()
    seen.append((b.state, b.failures))
    b.trip()
    t["now"] = 3.0
    seen.append(b.allow())
    b.start_probe()
    b.record_failure()
    seen.append(b.state)
    return seen


def test_breaker_transitions():
    seen = _breaker_walk(CircuitBreaker)
    assert seen == _breaker_walk(j_serving.CircuitBreaker)
    b = CircuitBreaker
    assert seen == [(b.CLOSED, True), b.CLOSED, (b.OPEN, False), (True, b.HALF_OPEN),
                    False, (b.CLOSED, 0), True, b.OPEN]


def test_breaker_trip_is_immediate():
    b = CircuitBreaker(lambda: 0.0, failure_threshold=5, reset_after_s=1.0)
    b.trip()
    assert b.state == b.OPEN and not b.allow()


# ---------------------------------------------------------------------------
# serving fault injector (pure unit)
# ---------------------------------------------------------------------------


def test_serving_injector_validates_ops():
    with pytest.raises(ValueError, match="serving fault op"):
        ServingFaultInjector("write:every=3")  # a file-system op
    with pytest.raises(ValueError, match="fault op"):
        ServingFaultInjector("kill:nth=1")  # the process fleet's op
    inj = ServingFaultInjector("slow:every=1:delay=0.5")
    assert inj.specs[0].mode == "delay"  # slow defaults to delay mode
    assert inj.specs[0].delay_s == 0.5


def test_serving_injector_deterministic_schedule():
    spec = "crash:nth=3:match=replica0;poison:every=2:match=replica1"

    def run(mod):
        inj = mod.ServingFaultInjector(spec)
        events = []
        for i in range(6):
            try:
                inj.step_delay("replica0")
            except mod.ReplicaCrashed:
                events.append(("crash", i))
            hook = inj.round_hook("replica1")
            try:
                hook("decode_round")
            except mod.InjectedServingFault:
                events.append(("poison", i))
        return events, inj.fired

    first, second = run(t_faults), run(t_faults)
    assert first == second == run(j_faults)
    assert ("crash", 2) in first[0]  # the 3rd visit, round 2
    assert [e for e in first[0] if e[0] == "poison"] == [
        ("poison", 1), ("poison", 3), ("poison", 5)]


def test_slow_fault_skews_clock_never_sleeps(monkeypatch):
    import time

    monkeypatch.setattr(time, "sleep", lambda s: pytest.fail("slept"))
    inj = ServingFaultInjector("slow:every=1:delay=2.0:match=replica1")
    assert inj.step_delay("replica0") == 0.0
    assert inj.step_delay("replica1") == 2.0  # returned, not slept


def test_serving_faults_env_knob(monkeypatch):
    monkeypatch.setenv(t_faults.SERVING_ENV_VAR, "admit:nth=1:match=replica1")
    inj = ServingFaultInjector()
    inj.check_admit("replica0")
    with pytest.raises(t_faults.InjectedAdmissionError):
        inj.check_admit("replica1")
    assert inj.fired == ["admit:replica1"]
    inj.reset_counters()
    assert inj.fired == [] and inj.specs[0].count == 0


# ---------------------------------------------------------------------------
# routing + retry (model-backed, both packages)
# ---------------------------------------------------------------------------


def test_fleet_plain_traffic_parity(pkgs):
    def run(pkg):
        router = make_fleet(pkg)
        handles = router.generate_batch(
            [pkg.serving.Request(prompt=p, max_new_tokens=6) for p in PROMPTS])
        return record(router, handles)

    rec = both(pkgs, run)
    for p, (tokens, reason, attempts, _, dups) in zip(PROMPTS, rec["handles"]):
        assert reason == "length" and attempts == 1 and dups == 0
        assert tokens == solo_greedy(pkgs[1], p, 6) == solo_greedy(pkgs[0], p, 6)
    assert rec["summary"]["requests_by_outcome"]["completed"] == len(PROMPTS)
    assert rec["summary"]["retries_by_reason"] == {"crash": 0, "admit": 0, "error": 0}


def test_affinity_same_prefix_same_replica(pkgs):
    jax_router, port_router = (make_fleet(pkg, n_replicas=3, affinity_len=4) for pkg in pkgs)
    rng = np.random.default_rng(0)
    for _ in range(64):  # the placement hash is the JAX router's
        p = rng.integers(0, 50, int(rng.integers(1, 24))).tolist()
        assert port_router._affinity_index(p) == jax_router._affinity_index(p)

    def run(pkg):
        router = make_fleet(pkg, n_replicas=3, affinity_len=4)
        shared = [5, 6, 7, 8]
        a = router.submit(pkg.serving.Request(prompt=shared + [1], max_new_tokens=3))
        b = router.submit(pkg.serving.Request(prompt=shared + [2], max_new_tokens=3))
        placed = (a.replica, b.replica)
        router.run_until_drained(max_steps=500)
        return placed, record(router, [a, b])

    (first, second), rec = both(pkgs, run)
    assert first == second  # the same prompt head -> the same replica
    assert rec["summary"]["requests_by_outcome"]["completed"] == 2


def _crash_run(pkg, spec, factory_kwargs=None, n=8):
    streamed = {}
    router = make_fleet(pkg, spec=spec, factory_kwargs=factory_kwargs)
    router.on_token = lambda fh, tok: streamed.setdefault(fh.request_id, []).append(tok)
    # two prompts pinned on the doomed replica, two on the survivor
    prompts = prompts_with_affinity(router, 0, 2) + prompts_with_affinity(router, 1, 2)
    handles = router.generate_batch(
        [pkg.serving.Request(prompt=p, max_new_tokens=n) for p in prompts])
    rec = record(router, handles)
    rec["streamed_equal"] = [streamed[h.request_id] == h.tokens for h in handles]
    rec["prompts"] = prompts
    return rec


def test_crash_mid_decode_retries_on_survivor(pkgs):
    """replica0 dies mid-decode; its in-flight requests finish on a
    survivor, token-identical, with no duplicate streamed token, and the
    router's summary is JAX's."""
    rec = both(pkgs, lambda pkg: _crash_run(pkg, "crash:nth=3:match=replica0"))
    s = rec["summary"]
    assert s["replicas"]["replica0"]["crashes"] == 1
    assert s["retries_by_reason"]["crash"] >= 1 and s["duplicates_suppressed"] >= 1
    assert any(attempts > 1 for _, _, attempts, _, _ in rec["handles"])
    for p, (tokens, reason, _, _, _) in zip(rec["prompts"], rec["handles"]):
        assert reason == "length" and tokens == solo_greedy(pkgs[1], p, 8)
    assert all(rec["streamed_equal"])


def test_crash_mid_decode_with_speculation_never_double_emits(pkgs):
    """The decode_round fault point fires before any of a verify round's
    burst is emitted: a crashed replica loses the whole burst and the
    survivor's re-decode dedups by token index."""
    def run(pkg):
        spec_kw = dict(draft_params=pkg.params, draft_cfg=pkg.cfg, spec_k=3)
        return _crash_run(pkg, "crash:nth=2:match=replica0", factory_kwargs=spec_kw)

    rec = both(pkgs, run)
    s = rec["summary"]
    assert s["replicas"]["replica0"]["crashes"] == 1 and s["retries_by_reason"]["crash"] >= 1
    assert any(attempts > 1 for _, _, attempts, _, _ in rec["handles"])
    for p, (tokens, reason, _, _, _) in zip(rec["prompts"], rec["handles"]):
        assert reason == "length" and tokens == solo_greedy(pkgs[1], p, 8)
    assert all(rec["streamed_equal"])


def test_crashed_replica_restarts_and_serves_again(pkgs):
    def run(pkg):
        router = make_fleet(pkg, spec="crash:nth=1:match=replica0")
        router.generate_batch([pkg.serving.Request(prompt=p, max_new_tokens=4)
                               for p in prompts_with_affinity(router, 0, 2)])
        for _ in range(50):  # idle rounds: the backoff elapses, the respawn lands
            router.step()
        s = router.summary()
        h = router.generate_batch([pkg.serving.Request(prompt=[9, 9, 9],
                                                       max_new_tokens=3)])[0]
        return s, record(router, [h])

    s, rec = both(pkgs, run)
    assert s["replicas"]["replica0"]["crashes"] == 1
    assert s["replicas"]["replica0"]["state"] == "ready"  # respawned
    assert rec["handles"][0][1] == "length"


def test_admission_fault_retries_elsewhere(pkgs):
    def run(pkg):
        router = make_fleet(pkg, spec="admit:every=1:match=replica0")
        prompt = next(p for p in ([i, i + 1, i + 2] for i in range(1, 40))
                      if router._affinity_index(p) == 0)
        h = router.generate_batch([pkg.serving.Request(prompt=prompt, max_new_tokens=4)])[0]
        return record(router, [h])

    rec = both(pkgs, run)
    _, reason, _, replica, _ = rec["handles"][0]
    assert reason == "length" and replica == "replica1"
    assert rec["summary"]["retries_by_reason"]["admit"] >= 1


def test_poisoned_round_recomputes_without_double_emit(pkgs):
    """A poison fault raises after the decode step but before emission: the
    round's tokens are lost, recomputed next round, never streamed twice."""
    def run(pkg):
        streamed = {}
        router = make_fleet(pkg, n_replicas=1, spec="poison:nth=2:match=replica0")
        router.on_token = lambda fh, tok: streamed.setdefault(fh.request_id, []).append(tok)
        h = router.generate_batch([pkg.serving.Request(prompt=PROMPTS[0], max_new_tokens=6)])[0]
        return record(router, [h]), streamed[h.request_id] == h.tokens

    rec, streamed_equal = both(pkgs, run)
    tokens, reason, _, _, _ = rec["handles"][0]
    assert reason == "length" and tokens == solo_greedy(pkgs[1], PROMPTS[0], 6)
    assert streamed_equal
    assert rec["summary"]["duplicates_suppressed"] == 0  # nothing re-emitted
    assert rec["summary"]["replicas"]["replica0"]["crashes"] == 0  # survived


def test_retry_budget_exhaustion_fails_loudly(pkgs):
    """Every round of both replicas crashes and the restart budget runs
    out: accepted requests end with finish_reason=error, no spinning."""
    def run(pkg):
        router = make_fleet(pkg, spec="crash:every=1", max_retries=2)
        handles = [router.submit(pkg.serving.Request(prompt=p, max_new_tokens=4))
                   for p in PROMPTS[:2]]
        router.run_until_drained(max_steps=5000)
        return record(router, handles), all(h.finished for h in handles)

    rec, finished = both(pkgs, run)
    assert finished and all(reason == "error" for _, reason, _, _, _ in rec["handles"])
    s = rec["summary"]
    assert s["requests_by_outcome"]["error"] == 2
    assert s["pending"] == 0 and s["in_flight"] == 0


# ---------------------------------------------------------------------------
# overload control
# ---------------------------------------------------------------------------


def test_watermark_shed(pkgs):
    def run(pkg):
        router = make_fleet(pkg, n_replicas=1, n_slots=1, shed_watermark=2)
        for p in PROMPTS[:2]:
            router.submit(pkg.serving.Request(prompt=p, max_new_tokens=4))
        with pytest.raises(pkg.serving.ShedError) as ei:
            router.submit(pkg.serving.Request(prompt=[3, 3], max_new_tokens=4))
        shed = router.summary()["rejected_by_reason"]["shed"]
        router.run_until_drained(max_steps=500)
        return ei.value.reason, shed, router.summary()

    reason, shed, _ = both(pkgs, run)
    assert reason == "shed" and shed == 1


def test_all_breakers_open_sheds(pkgs):
    def run(pkg):
        router = make_fleet(pkg)
        for b in router.breakers.values():
            b.trip()
        with pytest.raises(pkg.serving.ShedError) as ei:
            router.submit(pkg.serving.Request(prompt=[1, 2], max_new_tokens=2))
        return (ei.value.reason, ei.value.retry_after_s,
                router.summary()["rejected_by_reason"]["breaker_open"])

    reason, retry_after, n = both(pkgs, run)
    assert reason == "breaker_open" and retry_after is not None and n == 1


def test_deadline_aware_shed(pkgs):
    def run(pkg):
        router = make_fleet(pkg, n_replicas=1)
        # ITL history, so the wait estimate is nonzero
        router.generate_batch([pkg.serving.Request(prompt=PROMPTS[0], max_new_tokens=6)])
        with pytest.raises(pkg.serving.ShedError) as ei:
            router.submit(pkg.serving.Request(prompt=PROMPTS[1], max_new_tokens=4,
                                              deadline_s=1e-9))
        return ei.value.reason, ei.value.retry_after_s, router.summary()

    reason, _, s = both(pkgs, run)
    assert reason == "deadline" and s["rejected_by_reason"]["deadline"] == 1


def test_graceful_drain(pkgs):
    def run(pkg):
        router = make_fleet(pkg)
        handles = [router.submit(pkg.serving.Request(prompt=p, max_new_tokens=6))
                   for p in PROMPTS[:2]]
        router.step()  # work is in flight
        router.drain()
        with pytest.raises(pkg.serving.ShedError) as ei:
            router.submit(pkg.serving.Request(prompt=[4, 4], max_new_tokens=2))
        router.run_until_drained(max_steps=500)
        return ei.value.reason, record(router, handles)

    reason, rec = both(pkgs, run)
    assert reason == "draining"
    for p, (tokens, finish, _, _, _) in zip(PROMPTS, rec["handles"]):
        assert finish == "length" and tokens == solo_greedy(pkgs[1], p, 6)
    assert rec["summary"]["rejected_by_reason"]["draining"] == 1


# ---------------------------------------------------------------------------
# health gating
# ---------------------------------------------------------------------------


def test_slow_replica_health_gated(pkgs):
    """An injected-slow replica accumulates clock skew, its observed ITL p99
    crosses the SLO, and routing steers new work to the healthy replica
    while the slow one still finishes what it has."""
    def run(pkg):
        router = make_fleet(pkg, spec="slow:every=1:delay=0.25:match=replica0",
                            itl_slo_s=0.1, affinity_len=4)
        prompt = next(p for p in ([i, i + 1, i + 2] for i in range(1, 40))
                      if router._affinity_index(p) == 0)
        first = router.generate_batch([pkg.serving.Request(prompt=prompt,
                                                           max_new_tokens=6)])[0]
        rep0 = router.supervisor.replica_by_name("replica0")
        health = rep0.health()
        h = router.submit(pkg.serving.Request(prompt=prompt, max_new_tokens=3))
        placed = h.replica
        router.run_until_drained(max_steps=500)
        return (first.finish_reason, rep0.clock.skew_s, health.ready, health.reasons,
                placed, record(router, [first, h]))

    first_reason, skew, ready, reasons, placed, rec = both(pkgs, run)
    assert first_reason == "length"  # slow, not broken
    assert skew > 0 and not ready and "itl_p99" in reasons
    assert placed == "replica1"  # same-affinity traffic spills to the healthy one
    assert rec["handles"][1][1] == "length"


def test_health_gauges_exported(pkgs):
    def run(pkg):
        reg = pkg.registry()
        router = make_fleet(pkg, registry=reg, spec="crash:nth=1:match=replica1")
        router.generate_batch([pkg.serving.Request(prompt=p, max_new_tokens=3)
                               for p in prompts_with_affinity(router, 1, 2)])
        for _ in range(50):  # the restart backoff elapses, the respawn lands
            router.step()
        page = pkg.render(reg)
        parsed = t_telemetry.parse_prometheus(page)
        return page, parsed["types"], parsed["samples"]

    # the same families and samples (the HELP texts are each package's own)
    pages = [run(pkg) for pkg in pkgs]
    assert pages[1][1:] == pages[0][1:]
    page = pages[1][0]
    for needle in ('mingpt_fleet_replica_up{replica="replica0"} 1',
                   'mingpt_fleet_crashes_total{replica="replica1"} 1',
                   'mingpt_fleet_restarts_total{replica="replica1"} 1',
                   "mingpt_fleet_breaker_state",
                   'mingpt_serving_rejected_total{reason="queue_full"} 0'):
        assert needle in page, f"missing {needle!r} in exposition"


# ---------------------------------------------------------------------------
# the chaos self-test's scenario, the port's lifecycle and CLI
# ---------------------------------------------------------------------------

CHAOS_SPEC = "crash:nth=6:match=replica0;slow:every=1:delay=0.25:match=replica1"
CHAOS_CFG = dict(TINY, vocab_size=96, block_size=48)


@pytest.fixture(scope="module")
def chaos_runs():
    """serve --selftest-chaos's fleet in both packages: 3 replicas x 2 slots,
    the canned prompts, 12 new tokens, on the same converted weights."""
    jcfg, tcfg = JConfig.make(**CHAOS_CFG), GPTConfig.make(**CHAOS_CFG)
    tree = j_gpt.init(jax.random.key(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.array, tree), tcfg, "cpu")
    prompts = [[ord(c) % 96 for c in s] for s in t_serve.CHAOS_CANNED]
    out = {}
    for pkg in (SimpleNamespace(name="jax", serving=j_serving, faults=j_faults,
                                cfg=jcfg, params=tree, place={}),
                SimpleNamespace(name="port", serving=t_serving, faults=t_faults,
                                cfg=tcfg, params=tparams, place={"device": "cpu"})):
        streamed = {}
        s = pkg.serving
        sup = s.ReplicaSupervisor(
            s.default_server_factory(pkg.params, pkg.cfg, n_slots=2, **pkg.place),
            n_replicas=3, clock=s.VirtualClock(tick_s=0.001),
            injector=pkg.faults.ServingFaultInjector(CHAOS_SPEC), max_restarts=1,
            restart_backoff_s=0.01, itl_slo_s=0.1)
        router = s.Router(sup, max_retries=3, retry_backoff_s=0.01, breaker_reset_s=0.05,
                          on_token=lambda fh, t, d=streamed: d.setdefault(
                              fh.request_id, []).append(t))
        handles = router.generate_batch([s.Request(prompt=p, max_new_tokens=12)
                                         for p in prompts])
        out[pkg.name] = dict(record(router, handles), streamed=streamed,
                             handle_tokens={h.request_id: h.tokens for h in handles},
                             solo=[solo_greedy(pkg, p, 12) for p in prompts])
    return out


def test_chaos_fleet_matches_jax(chaos_runs):
    """The acceptance scenario: crashes, retries by reason, duplicates
    suppressed, requests by outcome, the health gate and each request's
    replica and attempts equal the JAX fleet's, and every stream is
    token-identical to JAX's solo generate."""
    j, t = chaos_runs["jax"], chaos_runs["port"]
    assert t["summary"] == j["summary"]
    assert t["handles"] == j["handles"]
    assert [tokens for tokens, *_ in t["handles"]] == j["solo"] == t["solo"]
    assert t["streamed"] == t["handle_tokens"]  # no duplicate or lost emission
    s = t["summary"]
    assert s["replicas"]["replica0"]["crashes"] == 1
    assert s["replicas"]["replica0"]["state"] == "ready"
    assert s["retries_by_reason"]["crash"] >= 1 and s["duplicates_suppressed"] >= 1
    assert "itl_p99" in s["replicas"]["replica1"]["health_reasons"]


def test_crashed_server_is_freed_before_the_respawn(pkgs):
    """A crashed server is never reused: once its replica respawns, nothing
    holds it (its KV pool, prefix store and draft engine go with it), and
    every replica, respawns included, serves the one parameter tree."""
    _, port = pkgs
    router = make_fleet(port, spec="crash:nth=1:match=replica0",
                        factory_kwargs=dict(prefix_cache_mb=1.0))
    rep0 = router.supervisor.replica_by_name("replica0")
    old = weakref.ref(rep0.server)
    old_pool = weakref.ref(rep0.server.engine.pool.cache["k"])
    router.generate_batch([Request(prompt=p, max_new_tokens=4)
                           for p in prompts_with_affinity(router, 0, 2)])
    for _ in range(50):
        router.step()
    assert rep0.state == "ready" and rep0.crashes == 1
    assert old() is None and old_pool() is None
    for rep in router.supervisor.replicas:
        assert rep.server.engine.params is port.params


def test_fault_hook_fires_once_per_round_in_both_lanes(pkgs):
    """decode_round is reached once per round whether the round's lanes take
    the plain step, speculate, or both, and before any of its tokens is
    emitted."""
    _, port = pkgs
    calls, emitted_at_hook = [], []
    tokens = []

    def hook(where):
        calls.append(where)
        emitted_at_hook.append(len(tokens))

    s = InferenceServer(port.params, port.cfg, n_slots=2, device="cpu",
                        draft_params=port.params, draft_cfg=port.cfg, spec_k=3,
                        fault_hook=hook, on_token=lambda h, t: tokens.append(t))
    s.submit(Request(prompt=PROMPTS[0], max_new_tokens=8))  # speculates (greedy)
    s.submit(Request(prompt=PROMPTS[1], max_new_tokens=8, do_sample=True, seed=1))
    rounds = 0
    while s.step():
        rounds += 1
    assert s.metrics.spec_rounds > 0
    assert set(calls) == {"decode_round"}
    decode_rounds = len(calls)
    assert 1 <= decode_rounds <= rounds + 1
    # the hook saw the tokens of earlier rounds only: never a round's own
    assert emitted_at_hook == sorted(emitted_at_hook) and emitted_at_hook[0] == 2


def test_fleet_attrib_report_and_merged_page(pkgs):
    _, port = pkgs
    router = make_fleet(port, factory_kwargs=dict(attrib=True))
    router.generate_batch([Request(prompt=p, max_new_tokens=4) for p in PROMPTS])
    doc = router.attrib_report()
    assert doc["schema"] == "mingpt-attrib-fleet/1"
    assert set(doc["replicas"]) == {"replica0", "replica1"}
    for rep in doc["replicas"].values():
        t_telemetry.validate_attrib_report(rep)
        j_telemetry.validate_attrib_report(rep)
    parsed = t_telemetry.parse_prometheus(router.fleet_metrics_page())
    assert {lb["replica"] for n, lb, _ in parsed["samples"]
            if n == "mingpt_attrib_flops"} == {"replica0", "replica1"}
    health = router.health_report()
    assert set(health["replicas"]) == {"replica0", "replica1"}
    with pytest.raises(ValueError, match="attribution"):
        make_fleet(port).attrib_report()


def test_scale_seams_spawn_drain_and_retire(pkgs):
    """The supervisor's and router's scale seams (the autoscaler's, item
    15c, calls them): a spawned replica gets the next index and is routed
    to once added; a draining replica takes no new work but finishes what
    it holds; a retired one reads drained and down. The same in both
    packages."""
    def run(pkg):
        reg = pkg.registry()
        router = make_fleet(pkg, n_replicas=1, registry=reg)
        sup = router.supervisor
        rep = sup.spawn_replica()
        router.add_replica(rep)
        first = router.submit(pkg.serving.Request(prompt=PROMPTS[0], max_new_tokens=4))
        second = router.submit(pkg.serving.Request(prompt=PROMPTS[1], max_new_tokens=4))
        placed = [first.replica, second.replica]
        sup.replicas[0].draining = True
        third = router.submit(pkg.serving.Request(prompt=PROMPTS[2], max_new_tokens=4))
        router.run_until_drained(max_steps=500)
        sup.retire_replica(sup.replicas[0])
        health = sup.replicas[0].health()
        parsed = t_telemetry.parse_prometheus(pkg.render(reg))
        up = {lb["replica"]: v for n, lb, v in parsed["samples"]
              if n == "mingpt_fleet_replica_up"}
        return (rep.name, placed, third.replica, health.ready, health.reasons, up,
                record(router, [first, second, third]))

    name, placed, third, ready, reasons, up, rec = both(pkgs, run)
    assert name == "replica1" and "replica1" in placed
    assert third == "replica1"  # the draining replica takes no new work
    assert all(reason == "length" for _, reason, _, _, _ in rec["handles"])
    assert not ready and reasons == ["drained"]
    assert up == {"replica0": 0.0, "replica1": 1.0}


def test_selftest_chaos_cli(capsys):
    assert t_serve.main(["--selftest-chaos", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "selftest-chaos PASSED" in out and "selftest-chaos scrape:" in out


def test_serve_fleet_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.main(["--selftest-chaos"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.main(["--replicas", "2", "--prompts-file", os.devnull])


@pytest.mark.parametrize("argv, item", [
    (["--isolation", "process"], "item 15b"),
    (["--replicas", "2", "--isolation", "process"], "item 15b"),
])
def test_process_isolation_exits_naming_its_item(argv, item, capsys):
    """Process isolation (item 15b) is ported: the flags parse, nothing
    exits, and no refused flag names the item any more."""
    args = t_serve.parse_args(argv)
    assert args.isolation == "process" and capsys.readouterr().err == ""
    assert item.split()[1] not in t_serve.UNPORTED_FLAGS.values()


def test_fleet_flags_parse():
    args = t_serve.parse_args(["--replicas", "3", "--isolation", "thread",
                               "--shed-watermark", "16", "--chaos-spec",
                               "crash:nth=6:match=replica0"])
    assert (args.replicas, args.isolation, args.shed_watermark) == (3, "thread", 16)
    assert args.chaos_spec == "crash:nth=6:match=replica0"


def test_respawned_replica_memory_stays_one_pool(pkgs):
    """What the card's fleet_parity phase reads with memory_allocated, held
    here through the collector: across a crash and restart the live KV
    tensors of the fleet stay one pool per replica."""
    _, port = pkgs
    router = make_fleet(port, spec="crash:nth=2:match=replica0")

    def pools():
        gc.collect()
        return sum(1 for o in gc.get_objects() if isinstance(o, t_serving.SlotKVPool))

    before = pools()
    router.generate_batch([Request(prompt=p, max_new_tokens=4)
                           for p in prompts_with_affinity(router, 0, 2)])
    for _ in range(50):
        router.step()
    assert router.summary()["replicas"]["replica0"]["crashes"] == 1
    assert pools() == before == 2
