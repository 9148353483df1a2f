"""The port's traffic lab (trafficlab/), cost model and signals (control/)
and traffic CLI against the JAX package's.

Counterparts of tests/test_trafficlab.py's tests of arrivals, workloads,
policies and the sweep (its cross-host cases on the loopback host mesh
included) and of tests/test_control.py's cost-model tests, each held against the
JAX function on the same inputs where one exists: the same ``(seed, spec)``
gives the same arrival times, the same ``(seed, mix)`` the same rendered
requests and digest, the policies the same order. The canned self-test
sweep (``traffic --selftest-traffic``'s geometry) on the same tiny weights
(converted from the JAX init) gives a ``mingpt-traffic/1`` report equal to
the JAX package's byte for byte — no field is exempt: every request is
greedy, so no sampled token comes from the other package's RNG, and the
virtual schedule reads no wall clock — and it validates under both
packages' validators. A second run is byte-identical. Then the port's CLI
and what raises naming its item. CPU, tiny config (2 layers, 2 heads, 32
wide, V = 96, block 48, fp32).
"""

import ast
import dataclasses
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import traffic as j_traffic_cli
from mingpt_distributed_tpu import trafficlab as j_lab
from mingpt_distributed_tpu.control import cost as j_cost
from mingpt_distributed_tpu.serving import admission as j_admission
from mingpt_distributed_tpu.trafficlab.report import dump_report as j_dump
from mingpt_distributed_tpu.trafficlab.workloads import trace_digest as j_digest
from mingpt_distributed_tpu_torch import traffic as traffic_cli
from mingpt_distributed_tpu_torch import trafficlab as t_lab
from mingpt_distributed_tpu_torch.control import (
    FleetSignalsView,
    SignalSampler,
    compute_cost,
    cost_from_cell,
    cost_from_signals,
)
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.serving import (
    AdmissionPolicy,
    FifoPolicy,
    HealthAwarePolicy,
    InferenceServer,
    ReplicaSupervisor,
    Request,
    Router,
    VirtualClock,
    default_server_factory,
)
from mingpt_distributed_tpu_torch.trafficlab import (
    DeadlinePolicy,
    FairSharePolicy,
    SweepSpec,
    TenantSpec,
    WorkloadMix,
    arrival_times,
    format_arrival_spec,
    make_policy,
    parse_arrival_spec,
    run_sweep,
    validate_traffic_report,
)
from mingpt_distributed_tpu_torch.trafficlab.report import dump_report
from mingpt_distributed_tpu_torch.trafficlab.workloads import trace_digest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")


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
def cfg_params():
    """The tiny self-test model: the JAX init, and the port's conversion."""
    jcfg, tree = j_traffic_cli._tiny_model()
    cfg = traffic_cli.tiny_config()
    params = convert.params_from_numpy(jax.tree.map(np.array, tree), cfg, "cpu")
    return cfg, params, jcfg, tree


@pytest.fixture(scope="module")
def sweep_report(cfg_params):
    """ONE 3-rung FIFO-vs-EDF sweep on the CLI's canned geometry, shared by
    the knee, monotonicity and separation tests below."""
    cfg, params, _, _ = cfg_params
    spec = traffic_cli.selftest_sweep_spec(ladder=(1.0, 8.0, 24.0))
    return run_sweep(params, cfg, spec, mix=traffic_cli.selftest_mix(), server_kwargs=CPU)


@pytest.fixture(scope="module")
def canned_reports(cfg_params):
    """The canned self-test sweep (ladder 1, 24) in both packages, and the
    port's a second time."""
    cfg, params, jcfg, tree = cfg_params
    port = [run_sweep(params, cfg, traffic_cli.selftest_sweep_spec(),
                      mix=traffic_cli.selftest_mix(), server_kwargs=CPU)
            for _ in range(2)]
    jax_report = j_lab.run_sweep(tree, jcfg, j_traffic_cli.selftest_sweep_spec(),
                                 mix=j_traffic_cli.selftest_mix())
    return port, jax_report


# ---------------------------------------------------------------------
# arrivals
# ---------------------------------------------------------------------


def test_arrival_trace_is_byte_identical_and_seeded():
    spec = parse_arrival_spec("poisson:rate=50")
    a = arrival_times(spec, 64, seed=3)
    b = arrival_times(spec, 64, seed=3)
    assert json.dumps(a) == json.dumps(b)
    assert a == j_lab.arrival_times(j_lab.parse_arrival_spec("poisson:rate=50"), 64, seed=3)
    assert a == sorted(a) and len(a) == 64 and a[0] > 0.0
    assert arrival_times(spec, 64, seed=4) != a
    # distinct specs under one seed decorrelate their streams
    assert arrival_times(parse_arrival_spec("poisson:rate=50.5"), 64, seed=3) != a


def test_arrival_mean_rate_is_roughly_offered():
    spec = parse_arrival_spec("poisson:rate=200")
    times = arrival_times(spec, 400, seed=0)
    observed = len(times) / times[-1]
    assert 0.7 * 200 < observed < 1.3 * 200
    fast = arrival_times(spec.scaled(4.0), 400, seed=0)  # the same shape 4x
    assert fast[-1] < times[-1]


@pytest.mark.parametrize("text", [
    "bursty:rate_on=100:rate_off=1:period=2.0:duty=0.25",
    "ramp:rate0=10:rate1=110:duration=10",
    "recorded:times=0.0;0.012;0.5;1.25",
])
def test_every_arrival_kind_matches_jax(text):
    ours, theirs = parse_arrival_spec(text), j_lab.parse_arrival_spec(text)
    assert format_arrival_spec(ours) == j_lab.format_arrival_spec(theirs)
    assert arrival_times(ours, 4 if "recorded" in text else 50, seed=5) == \
        j_lab.arrival_times(theirs, 4 if "recorded" in text else 50, seed=5)
    assert arrival_times(ours.scaled(3.0), 4, seed=5) == \
        j_lab.arrival_times(theirs.scaled(3.0), 4, seed=5)


def test_bursty_and_ramp_shapes():
    bursty = parse_arrival_spec("bursty:rate_on=100:rate_off=1:period=2.0:duty=0.25")
    assert bursty.rate_at(0.1) == 100.0 and bursty.rate_at(1.0) == 1.0
    assert bursty.mean_rate() == pytest.approx(100 * 0.25 + 1 * 0.75)
    ramp = parse_arrival_spec("ramp:rate0=10:rate1=110:duration=10")
    assert ramp.rate_at(0.0) == 10.0
    assert ramp.rate_at(5.0) == pytest.approx(60.0)
    assert ramp.rate_at(99.0) == 110.0  # holds the top rate after the ramp


def test_spec_roundtrip_is_a_fixed_point():
    for text in ("poisson:rate=50.0",
                 "bursty:rate_on=100.0:rate_off=1.0:period=2.0:duty=0.25",
                 "ramp:rate0=10.0:rate1=110.0:duration=10.0"):
        spec = parse_arrival_spec(text)
        assert format_arrival_spec(spec) == text
        assert parse_arrival_spec(format_arrival_spec(spec)) == spec


@pytest.mark.parametrize("bad", [
    "", "warp:rate=5", "poisson", "poisson:rate",
    "poisson:rate=fast", "poisson:rate=0", "poisson:rate=5:rate=6",
    "poisson:burst=5", "bursty:rate_on=1:rate_off=1:period=0:duty=0.5",
    "bursty:rate_on=1:rate_off=1:period=1:duty=1.5",
    "ramp:rate0=1:rate1=2:duration=0",
])
def test_malformed_arrival_specs_rejected(bad):
    with pytest.raises(ValueError):
        parse_arrival_spec(bad)


# ---------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------


def test_render_is_deterministic_and_digested():
    mix = traffic_cli.selftest_mix()
    times = arrival_times(parse_arrival_spec("poisson:rate=80"), 40, seed=1)
    a = mix.render(times, seed=1)
    b = mix.render(times, seed=1)
    assert [t.to_json() for t in a] == [t.to_json() for t in b]
    assert trace_digest(a) == trace_digest(b)
    # the JAX package renders the same requests from the same seed and mix
    theirs = j_traffic_cli.selftest_mix().render(times, seed=1)
    assert [t.to_json() for t in a] == [t.to_json() for t in theirs]
    assert trace_digest(a) == j_digest(theirs)
    assert trace_digest(mix.render(times, seed=2)) != trace_digest(a)
    assert [t.t for t in a] == times
    assert {t.tenant for t in a} <= {"chat", "batch", "assist"}


def test_default_mix_matches_jax():
    ours = traffic_cli.selftest_mix().__class__  # WorkloadMix
    for vocab, block in ((96, 48), (50257, 1024)):
        a = __import__("mingpt_distributed_tpu_torch.trafficlab", fromlist=["x"]) \
            .default_mix(vocab_size=vocab, block_size=block)
        b = j_lab.default_mix(vocab_size=vocab, block_size=block)
        assert isinstance(a, ours) and a.canonical() == b.canonical()


def test_shared_prefix_tenants_draw_from_their_pool():
    mix = WorkloadMix(vocab_size=96, tenants=(
        TenantSpec(name="assist", family="prefix", prompt_len=(8, 12),
                   max_new=(2, 4), prefix_pool=2, prefix_len=5),
    ))
    times = arrival_times(parse_arrival_spec("poisson:rate=50"), 30, seed=0)
    timed = mix.render(times, seed=0)
    heads = {t.prompt[:5] for t in timed}
    assert len(heads) == 2  # every prompt opens with one of the 2 prefixes
    assert all(len(t.prompt) >= 6 for t in timed)  # unique suffix appended


def test_timed_request_mints_fresh_requests():
    mix = traffic_cli.selftest_mix()
    times = arrival_times(parse_arrival_spec("poisson:rate=50"), 4, seed=0)
    tr = mix.render(times, seed=0)[0]
    r1, r2 = tr.to_request(), tr.to_request()
    assert r1 is not r2 and r1.prompt == r2.prompt and isinstance(r1, Request)
    r1.trace = object()  # a router stamping one run must not leak...
    assert tr.to_request().trace is None  # ...into the next policy's run


def test_workload_validation_rejects_bad_mixes():
    with pytest.raises(ValueError):
        WorkloadMix(vocab_size=96, tenants=()).validate()
    with pytest.raises(ValueError):
        TenantSpec(name="x", family="warp").validate()
    with pytest.raises(ValueError):
        TenantSpec(name="x", prompt_len=(4, 2)).validate()
    with pytest.raises(ValueError):  # prefix at least as long as prompts
        TenantSpec(name="x", prompt_len=(4, 8), prefix_pool=2, prefix_len=4).validate()
    with pytest.raises(ValueError):  # duplicate tenant names
        WorkloadMix(vocab_size=96, tenants=(
            TenantSpec(name="a"), TenantSpec(name="a"))).validate()


# ---------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------


def _handle(deadline=None, tenant=None):
    return SimpleNamespace(deadline=deadline, request=SimpleNamespace(tenant=tenant))


def test_fifo_policy_is_popleft():
    p = FifoPolicy()
    queue = [_handle(deadline=1.0), _handle(), _handle(deadline=0.1)]
    assert p.select(queue, now=0.0) == 0
    assert p.order(queue, now=0.0) == [0, 1, 2]


def test_edf_orders_by_deadline_with_fifo_tiebreak():
    p = DeadlinePolicy()
    queue = [_handle(), _handle(deadline=9.0), _handle(deadline=2.0),
             _handle(deadline=2.0), _handle()]
    assert p.select(queue, now=0.0) == 2
    # deadlines first (earliest wins, ties by position), deadline-free
    # handles keep arrival order at the back
    assert p.order(queue, now=0.0) == [2, 3, 1, 0, 4]
    assert p.order(queue, now=0.0) == j_lab.DeadlinePolicy().order(queue, now=0.0)


def test_fair_share_counts_admissions_per_tenant():
    p = FairSharePolicy()
    a1, a2, b1 = _handle(tenant="a"), _handle(tenant="a"), _handle(tenant="b")
    assert p.select([a1, a2, b1], now=0.0) == 0  # all zero: FIFO
    p.on_admit(a1)
    assert p.select([a2, b1], now=0.0) == 1  # b has fewer admissions
    p.on_admit(b1)
    assert p.select([a2], now=0.0) == 0
    assert p.admitted == {"a": 1, "b": 1}
    assert p._tenant(_handle()) == "_"  # tenant-less bucket


def test_health_policy_flips_to_edf_when_degraded():
    queue = [_handle(), _handle(deadline=9.0), _handle(deadline=2.0)]
    view = SimpleNamespace(degraded=lambda: False)
    ours, theirs = HealthAwarePolicy(), j_admission.HealthAwarePolicy()
    assert ours.order(queue, 0.0) == [0, 1, 2]  # unbound: FIFO
    for policy in (ours, theirs):
        policy.bind(view)
    assert ours.order(queue, 0.0) == theirs.order(queue, 0.0) == [0, 1, 2]
    view.degraded = lambda: True
    assert ours.order(queue, 0.0) == theirs.order(queue, 0.0) == [2, 1, 0]
    assert ours.select(queue, 0.0) == 2


def test_make_policy_registry():
    assert isinstance(make_policy("fifo"), FifoPolicy)
    assert isinstance(make_policy("edf"), AdmissionPolicy)
    assert isinstance(make_policy("health"), HealthAwarePolicy)
    # stateful policies come out fresh per call, never shared
    assert make_policy("fair") is not make_policy("fair")
    assert sorted(__import__("mingpt_distributed_tpu_torch.trafficlab",
                             fromlist=["x"]).POLICIES) == sorted(j_lab.POLICIES)
    with pytest.raises(ValueError):
        make_policy("lifo")


def test_scheduler_admission_follows_the_policy(cfg_params):
    """Three requests queued before the first step on a one-slot server
    complete in policy order — EDF by deadline (deadline-free last), FIFO by
    arrival. Same geometry, same requests, same (frozen) clock."""
    cfg, params, _, _ = cfg_params

    def completion_order(policy):
        server = InferenceServer(params, cfg, n_slots=1, clock=lambda: 0.0,
                                 admission_policy=policy, device="cpu")
        handles = [
            ("first", server.submit(Request(prompt=[1, 2], max_new_tokens=2))),
            ("relaxed", server.submit(Request(prompt=[3, 4], max_new_tokens=2,
                                              deadline_s=90.0))),
            ("urgent", server.submit(Request(prompt=[5, 6], max_new_tokens=2,
                                             deadline_s=5.0))),
        ]
        order = []
        for _ in range(200):
            alive = server.step()
            for name, h in handles:
                if h.finished and name not in order:
                    order.append(name)
            if not alive:
                break
        assert all(h.finished for _, h in handles)
        return order

    assert completion_order(make_policy("edf")) == ["urgent", "relaxed", "first"]
    assert completion_order(make_policy("fifo")) == ["first", "relaxed", "urgent"]


# ---------------------------------------------------------------------
# the cost model and the signals
# ---------------------------------------------------------------------


def test_compute_cost_hand_counts():
    counts = {"completed": 6, "shed": 2, "expired": 1, "errors": 1,
              "tokens": 100, "deadline_requests": 5, "deadline_hits": 3}
    c = compute_cost(counts)
    assert c == j_cost.compute_cost(counts)
    # demanded = 10, shed_rate = 0.2; misses = 2, miss/tok = 0.02
    assert c["shed_rate"] == pytest.approx(0.2)
    assert c["deadline_miss_per_ktok"] == pytest.approx(20.0)
    assert c["goodput_tokens"] == pytest.approx(80.0)
    assert c["cost"] == pytest.approx(0.02 + 0.2)


def test_compute_cost_edges():
    zeros = {k: 0 for k in ("completed", "shed", "expired", "errors", "tokens",
                            "deadline_requests", "deadline_hits")}
    assert compute_cost(zeros) == {"deadline_miss_per_ktok": 0.0, "shed_rate": 0.0,
                                   "goodput_tokens": 0.0, "cost": 0.0}
    # zero tokens but misses: the miss count passes through undivided
    c = compute_cost(dict(zeros, shed=4, deadline_requests=3))
    assert c["shed_rate"] == 1.0 and c["cost"] == pytest.approx(4.0)
    for bad in ({k: v for k, v in zeros.items() if k != "tokens"},
                dict(zeros, completed=-1), dict(zeros, deadline_hits=1)):
        with pytest.raises(ValueError):
            compute_cost(bad)


def test_cost_from_cell_matches_and_handles_none_rate():
    cell = {"completed": 6, "shed": 2, "expired": 1, "errors": 1,
            "tokens": 100, "deadline_requests": 5, "deadline_hit_rate": 3 / 5}
    assert cost_from_cell(cell) == j_cost.cost_from_cell(cell) == compute_cost({
        "completed": 6, "shed": 2, "expired": 1, "errors": 1,
        "tokens": 100, "deadline_requests": 5, "deadline_hits": 3})
    quiet = dict(cell, deadline_requests=0, deadline_hit_rate=None)
    assert cost_from_cell(quiet)["deadline_miss_per_ktok"] == 0.0


def test_signal_sampler_and_view_over_a_live_fleet(cfg_params):
    """The signals seam over a running fleet: the sampler's windows fill
    from the router's finish hook, its counts feed the same cost as a
    cell's, snapshots are deterministic on the virtual clock, and the view
    reads degraded while a replica is health-gated."""
    cfg, params, _, _ = cfg_params

    def run():
        sup = ReplicaSupervisor(default_server_factory(params, cfg, n_slots=2, **CPU),
                                n_replicas=2, clock=VirtualClock(tick_s=0.001),
                                queue_high_watermark=1)
        router = Router(sup)
        sampler, view = SignalSampler(router, window=8), FleetSignalsView(router)
        for i in range(6):
            router.submit(Request(prompt=[1 + i, 2, 3], max_new_tokens=3,
                                  deadline_s=0.5 if i % 2 else None))
        degraded = view.degraded()
        depth = view.queue_depth()
        router.run_until_drained(max_steps=500)
        return sampler, view, degraded, depth

    sampler, view, degraded, depth = run()
    assert degraded and depth > 0  # queues past the watermark of 1
    assert not view.degraded() and view.queue_depth() == 0
    snap = sampler.snapshot(tick=1)
    assert snap.completed == 6 and snap.replicas_ready == 2 and snap.tokens == 18
    assert snap.deadline_hit_rate == 1.0 and snap.ttft_p99_s is not None
    assert cost_from_signals(sampler) == compute_cost(sampler.counts())
    assert snap.digest() == run()[0].snapshot(tick=1).digest()


# ---------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------


def test_canned_sweep_report_equals_jax_byte_for_byte(canned_reports):
    """The acceptance comparison: the port's mingpt-traffic/1 report of the
    canned sweep equals the JAX package's dump byte for byte (trace
    digests, every rung's grades, deadline_hit_rate, knee and cost among
    them) and validates under both packages' validators."""
    (port, again), jax_report = canned_reports
    assert dump_report(port) == j_dump(jax_report)
    assert dump_report(port) == dump_report(again)
    parsed = json.loads(dump_report(port))
    assert validate_traffic_report(parsed, strict=True) == []
    assert j_lab.validate_traffic_report(parsed, strict=True) == []
    assert validate_traffic_report(json.loads(j_dump(jax_report)), strict=True) == []
    assert parsed["knee"]["valid"]
    last = parsed["rungs"][-1]["policies"]
    assert last["edf"]["deadline_hit_rate"] > last["fifo"]["deadline_hit_rate"]


def test_sweep_report_validates_and_is_byte_identical(cfg_params):
    cfg, params, _, _ = cfg_params
    spec = SweepSpec(arrival="poisson:rate=40.0", ladder=(1.0, 4.0),
                     policies=("fifo",), n_requests=12, seed=7,
                     n_replicas=1, n_slots=2, slo="ttft_p95<=0.025,shed_rate<=0.5")
    mix = traffic_cli.selftest_mix()
    a = run_sweep(params, cfg, spec, mix=mix, server_kwargs=CPU)
    b = run_sweep(params, cfg, spec, mix=mix, server_kwargs=CPU)
    assert dump_report(a) == dump_report(b)
    assert validate_traffic_report(json.loads(dump_report(a)), strict=False) == []
    # a different seed is a different trace, hence a different report
    c = run_sweep(params, cfg, dataclasses.replace(spec, seed=8), mix=mix, server_kwargs=CPU)
    assert dump_report(c) != dump_report(a)
    assert c["rungs"][0]["trace_sha256"] != a["rungs"][0]["trace_sha256"]


def test_rungs_share_the_identical_arrival_trace(sweep_report):
    digests = [r["trace_sha256"] for r in sweep_report["rungs"]]
    assert len(set(digests)) == len(digests)
    for rung in sweep_report["rungs"]:
        assert set(rung["policies"]) == {"fifo", "edf"}
        for cell in rung["policies"].values():
            accounted = cell["completed"] + cell["shed"] + cell["expired"] + cell["errors"]
            assert accounted == rung["n_requests"]
            assert cell["cost"] == cost_from_cell(cell)


def test_grades_never_improve_as_load_rises(sweep_report):
    for policy in sweep_report["policies"]:
        attainments, failed = [], set()
        for rung in sweep_report["rungs"]:
            slo = rung["policies"][policy]["slo"]
            attainments.append(slo["attainment"])
            for row in slo["objectives"]:
                if row["pass"] is False:
                    failed.add(row["name"])
                elif row["pass"] is True:
                    assert row["name"] not in failed, (
                        f"{policy}/{row['name']} recovered at higher load")
        assert attainments == sorted(attainments, reverse=True)


def test_knee_located_with_pass_fail_shape(sweep_report):
    knee = sweep_report["knee"]
    assert knee is not None and knee["valid"] and knee["objective"] == "ttft_p95"
    rung = knee["rung"]
    assert rung >= 1
    prev = sweep_report["rungs"][rung - 1]["policies"][knee["policy"]]
    curr = sweep_report["rungs"][rung]["policies"][knee["policy"]]

    def row(cell):
        return next(r for r in cell["slo"]["objectives"] if r["name"] == knee["objective"])

    assert row(prev)["pass"] is True and row(curr)["pass"] is False


def test_edf_beats_fifo_on_deadline_hit_rate_under_overload(sweep_report):
    last = sweep_report["rungs"][-1]["policies"]
    edf, fifo = last["edf"], last["fifo"]
    assert edf["deadline_requests"] == fifo["deadline_requests"] > 0
    assert edf["deadline_hit_rate"] > fifo["deadline_hit_rate"]


CHAOS = SweepSpec(arrival="poisson:rate=40.0", ladder=(1.0,), policies=("fifo",),
                  n_requests=12, seed=0, n_replicas=2, n_slots=2,
                  slo="ttft_p95<=0.5,error_rate<=0.5",
                  chaos_spec="crash:nth=4:match=replica0")


def test_chaos_spec_composes_and_still_validates(cfg_params):
    """The same sweep under an injected replica crash, in both packages:
    requests retry on the survivor, the report validates and equals JAX's
    byte for byte, outcomes account for every offered request."""
    cfg, params, jcfg, tree = cfg_params
    report = run_sweep(params, cfg, CHAOS, mix=traffic_cli.selftest_mix(), server_kwargs=CPU)
    jax_spec = j_lab.SweepSpec(**{f.name: getattr(CHAOS, f.name)
                                  for f in dataclasses.fields(CHAOS)})
    assert dump_report(report) == j_dump(
        j_lab.run_sweep(tree, jcfg, jax_spec, mix=j_traffic_cli.selftest_mix()))
    assert validate_traffic_report(json.loads(dump_report(report)), strict=False) == []
    assert report["chaos_spec"] == "crash:nth=4:match=replica0"
    cell = report["rungs"][0]["policies"]["fifo"]
    assert cell["completed"] + cell["shed"] + cell["expired"] + cell["errors"] == 12
    assert cell["completed"] > 0


def test_recovery_tail_objective_composes_with_chaos(cfg_params):
    cfg, params, _, _ = cfg_params
    spec = dataclasses.replace(CHAOS, slo="ttft_p95<=60,error_rate<=0.5",
                               recovery_slo_s=30.0)
    assert spec.effective_slo() == "ttft_p95<=60,error_rate<=0.5,recovery_p99<=30"
    report = run_sweep(params, cfg, spec, mix=traffic_cli.selftest_mix(), server_kwargs=CPU)
    assert validate_traffic_report(json.loads(dump_report(report)), strict=False) == []
    assert report["slo_spec"] == spec.effective_slo()
    cell = report["rungs"][0]["policies"]["fifo"]
    assert cell["recovered"] >= 1
    row = next(r for r in cell["slo"]["objectives"] if r["name"] == "recovery_p99")
    assert row["observed"] is not None and row["observed"] > 0
    assert row["pass"] is True  # virtual-clock failover is fast


def test_recovery_objective_without_chaos_has_no_data(cfg_params):
    cfg, params, _, _ = cfg_params
    spec = SweepSpec(arrival="poisson:rate=40.0", ladder=(1.0,), policies=("fifo",),
                     n_requests=6, seed=0, n_replicas=2, n_slots=2,
                     slo="ttft_p95<=60", recovery_slo_s=1.0)
    report = run_sweep(params, cfg, spec, mix=traffic_cli.selftest_mix(), server_kwargs=CPU)
    cell = report["rungs"][0]["policies"]["fifo"]
    assert cell["recovered"] == 0
    row = next(r for r in cell["slo"]["objectives"] if r["name"] == "recovery_p99")
    assert row["observed"] is None and row["pass"] is None


def test_sweep_spec_recovery_validation():
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError):
            SweepSpec(recovery_slo_s=bad).validate()
    SweepSpec(recovery_slo_s=0.5).validate()
    assert SweepSpec().effective_slo() == SweepSpec().slo
    assert "recovery_p99<=0.5" in SweepSpec(recovery_slo_s=0.5).effective_slo()


def test_validator_rejects_tampered_reports(sweep_report):
    good = json.loads(dump_report(sweep_report))
    assert validate_traffic_report(good, strict=False) == []
    tampered = []
    broken = json.loads(dump_report(sweep_report))
    del broken["rungs"][1]
    tampered.append(broken)
    broken = json.loads(dump_report(sweep_report))
    broken["ladder"] = list(reversed(broken["ladder"]))
    tampered.append(broken)
    broken = json.loads(dump_report(sweep_report))
    broken["rungs"][0]["policies"]["fifo"]["completed"] += 1
    tampered.append(broken)
    for doc in tampered:
        assert validate_traffic_report(doc, strict=False)
        assert j_lab.validate_traffic_report(doc, strict=False)
    broken = json.loads(dump_report(sweep_report))
    broken["schema"] = "mingpt-traffic/0"
    with pytest.raises(ValueError):
        validate_traffic_report(broken, strict=True)


def test_sweep_spec_validation():
    for bad in (dict(ladder=(2.0, 1.0)), dict(policies=("fifo", "fifo")),
                dict(arrival="warp:rate=1"), dict(slo="vibes<=0.5")):
        with pytest.raises(ValueError):
            SweepSpec(**bad).validate()
    SweepSpec().validate()


@pytest.mark.parametrize("fields, item", [
    (dict(n_hosts=3), "item 15b"),
    (dict(net_chaos_spec="partition:nth=1:match=host0->host1"), "item 15b"),
    (dict(controllers=("static", "auto:target=0.03")), "item 15c"),
])
def test_unported_sweep_axes_raise_naming_their_item(fields, item):
    """Both axes are ported. The host axis of item 15b: a host mesh
    validates, and network chaos without one is refused as the JAX package
    refuses it. The autoscaler axis of item 15c validates on one host and is
    refused on a host mesh, as in the JAX package."""
    if item == "item 15b":
        spec = SweepSpec(**fields)
        if spec.n_hosts > 1:
            spec.validate()
        else:
            with pytest.raises(ValueError, match="needs a mesh"):
                spec.validate()
        SweepSpec(**dict(fields, n_hosts=3)).validate()
        return
    for mod in (t_lab, j_lab):
        mod.SweepSpec(**fields).validate()
        with pytest.raises(ValueError, match="host mesh"):
            mod.SweepSpec(**dict(fields, n_hosts=3)).validate()


# -- the cross-host axis ---------------------------------------------------

# host0 cut off from its peers (both directions) at the first heartbeat
# crossing, healing 0.1 virtual seconds later, past the quarantine threshold
# (5x the 5 ms heartbeat): the survivors declare host0 failed and adopt its
# in-flight requests mid-partition
_CROSSHOST_CHAOS = ";".join(
    f"partition:nth=1:match={a}->{b}:delay=0.1"
    for a, b in [("host0", "host1"), ("host0", "host2"),
                 ("host1", "host0"), ("host2", "host0")])


def _crosshost_spec(mod, **overrides):
    base = dict(arrival="poisson:rate=200.0", ladder=(1.0,), policies=("fifo", "edf"),
                n_requests=10, seed=3, n_replicas=1, n_slots=2, n_hosts=3,
                heartbeat_interval_s=0.005, slo="ttft_p95<=60,error_rate<=0.5",
                recovery_slo_s=30.0, net_chaos_spec=_CROSSHOST_CHAOS)
    base.update(overrides)
    return mod.SweepSpec(**base)


def test_crosshost_partition_sweep_recovers_and_is_byte_identical(cfg_params):
    """An EDF-vs-FIFO sweep on a 3-host loopback mesh under a partition that
    cuts host0 off mid-decode: the report strict-validates with every
    request accounted for, a request rides a cross-host failover graded by
    the recovery-tail objective, two runs are byte-identical, and the
    report equals the JAX package's byte for byte."""
    cfg, params, jcfg, tree = cfg_params
    spec = _crosshost_spec(j_lab)
    report = run_sweep(params, cfg, _crosshost_spec(t_lab),
                       mix=traffic_cli.selftest_mix(), server_kwargs=CPU)
    assert validate_traffic_report(json.loads(dump_report(report)), strict=False) == []
    assert report["net_chaos_spec"] == _CROSSHOST_CHAOS
    assert report["fleet"]["n_hosts"] == 3
    assert report["slo_spec"] == spec.effective_slo()
    cells = report["rungs"][0]["policies"]
    for policy in ("fifo", "edf"):
        cell = cells[policy]
        assert cell["completed"] + cell["shed"] + cell["expired"] + cell["errors"] == 10
        assert cell["completed"] > 0
    recovered = [c for c in cells.values() if c["recovered"] >= 1]
    assert recovered, "no request crossed hosts — vacuous drill"
    for cell in recovered:
        row = next(r for r in cell["slo"]["objectives"] if r["name"] == "recovery_p99")
        assert row["observed"] is not None and row["observed"] > 0 and row["pass"] is True
    again = run_sweep(params, cfg, _crosshost_spec(t_lab),
                      mix=traffic_cli.selftest_mix(), server_kwargs=CPU)
    assert dump_report(report) == dump_report(again)
    jax_report = j_lab.run_sweep(tree, jcfg, spec, mix=j_traffic_cli.selftest_mix())
    assert dump_report(report) == j_dump(jax_report)


def test_sweep_spec_crosshost_validation():
    for mod in (t_lab, j_lab):
        for bad in (dict(net_chaos_spec=_CROSSHOST_CHAOS),        # chaos needs a mesh
                    dict(n_hosts=3, chaos_spec="crash:nth=1"),    # thread-fleet axis
                    dict(n_hosts=3, shed_watermark=4),            # sheds on lost quorum
                    dict(n_hosts=0),
                    dict(n_hosts=2, heartbeat_interval_s=0.0),
                    dict(n_hosts=2, net_chaos_spec="gremlins:nth=1")):
            with pytest.raises(ValueError):
                mod.SweepSpec(**bad).validate()
        mod.SweepSpec(n_hosts=3, net_chaos_spec=_CROSSHOST_CHAOS).validate()


# ---------------------------------------------------------------------
# the CLI and clock discipline
# ---------------------------------------------------------------------


def test_selftest_traffic_cli(capsys):
    assert traffic_cli.main(["--device", "cpu", "--selftest-traffic"]) == 0
    out = capsys.readouterr().out
    assert "selftest-traffic PASSED" in out and "knee:" in out


def test_random_init_sweep_cli(tmp_path, capsys):
    out_path = str(tmp_path / "r.json")
    argv = ["--device", "cpu", "--random-init", "--ladder", "1,4", "--requests", "8",
            "--replicas", "1", "--slots", "2", "--policies", "fifo,edf,fair",
            "--out", out_path, "gpt_config.n_layer=1", "gpt_config.n_head=2",
            "gpt_config.n_embd=32", "gpt_config.dtype=float32",
            "data_config.block_size=48"]
    assert traffic_cli.main(argv) == 0
    with open(out_path) as f:
        report = json.load(f)
    assert validate_traffic_report(report, strict=True) == []
    assert report["policies"] == ["fifo", "edf", "fair"]
    assert "traffic sweep (mingpt-traffic/1)" in capsys.readouterr().out


def test_crosshost_sweep_cli(tmp_path, capsys):
    """traffic --hosts 2 --net-chaos-spec: every cell on the loopback host
    mesh, the net-chaos line in the rendered table."""
    out_path = str(tmp_path / "r.json")
    chaos = "partition:nth=1:match=host0->host1:delay=0.05"
    argv = ["--device", "cpu", "--random-init", "--ladder", "1", "--requests", "6",
            "--replicas", "1", "--slots", "2", "--hosts", "2", "--net-chaos-spec", chaos,
            "--out", out_path, "gpt_config.n_layer=1", "gpt_config.n_head=2",
            "gpt_config.n_embd=32", "gpt_config.dtype=float32",
            "data_config.block_size=48"]
    assert traffic_cli.main(argv) == 0
    with open(out_path) as f:
        report = json.load(f)
    assert validate_traffic_report(report, strict=True) == []
    assert report["fleet"]["n_hosts"] == 2 and report["net_chaos_spec"] == chaos
    assert f"net-chaos: {chaos} (2 hosts)" in capsys.readouterr().out


def test_traffic_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        traffic_cli.main(["--selftest-traffic"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        traffic_cli.main(["--random-init"])


@pytest.mark.parametrize("argv, item", [
    (["--hosts", "3"], "item 15b"),
    (["--net-chaos-spec", "partition:nth=1"], "item 15b"),
    (["--controllers", "static,auto:target=0.03"], "item 15c"),
    (["--selftest-controller"], "item 15c"),
])
def test_unported_traffic_flags_exit_naming_their_item(argv, item, capsys):
    """Every flag here is ported now and parses: item 15b's host flags (the
    sweep spec checks --net-chaos-spec against --hosts) and item 15c's
    controller axis and self-test."""
    args = traffic_cli.parse_args(argv)
    assert capsys.readouterr().err == ""
    if item == "item 15b":
        assert (args.hosts, args.net_chaos_spec) in ((3, None), (1, "partition:nth=1"))
    elif "--controllers" in argv:
        assert traffic_cli._sweep_spec(args).controllers == ("static", "auto:target=0.03")
    else:
        assert args.selftest_controller


def test_every_jax_traffic_flag_is_ported_or_refused():
    theirs = {o for a in j_traffic_cli.build_argparser()._actions for o in a.option_strings
              if o.startswith("--")}
    ours = {o for a in traffic_cli.build_argparser()._actions for o in a.option_strings
            if o.startswith("--")}
    assert theirs <= ours and ours - theirs == {"--device"}


def _clock_reads(path):
    """(imported time/datetime modules, the functions that call time.*)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names} | {
        n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    callers = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for n in ast.walk(fn):
            if (isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
                    and n.value.id in ("time", "datetime")):
                callers.add(fn.name)
    return mods & {"time", "datetime"}, callers


def test_trafficlab_and_fleet_read_no_clock():
    """Clock discipline: nothing in trafficlab/ or control/ imports a module
    that tells time, and in serving/fleet.py only WallClock.now reads one
    (everything else runs on the injected clock)."""
    pkg = os.path.join(REPO, "mingpt_distributed_tpu_torch")
    for sub in ("trafficlab", "control"):
        for name in sorted(os.listdir(os.path.join(pkg, sub))):
            if name.endswith(".py"):
                assert _clock_reads(os.path.join(pkg, sub, name)) == (set(), set()), name
    mods, callers = _clock_reads(os.path.join(pkg, "serving", "fleet.py"))
    assert mods == {"time"} and callers == {"now"}
    with open(os.path.join(pkg, "serving", "fleet.py")) as f:
        tree = ast.parse(f.read())
    wall = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "WallClock")
    others = [n for n in tree.body if n is not wall]
    assert not any(isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
                   and n.value.id == "time" for top in others for n in ast.walk(top))
