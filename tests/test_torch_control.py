"""The port's control plane (control/controller.py, control/importer.py), the
traffic lab's controller axis and serve's autoscaler flags, against the JAX
package's.

Counterparts of tests/test_control.py's tests: the hysteresis governor on
noise, a sustained breach and a comfort streak; the controller spec grammar
and its rejects (each reject refused by both packages); the cost model's
hand counts; the trace importer's exact round trip through the port's
``load_trace_jsonl`` and its empty-trace refusal; an autoscaled sweep
byte-identical across runs; a scale-down that drains and never kills, in
both packages on the same converted weights with equal summaries. Then what
the port adds: ``traffic --selftest-controller``'s canned sweep, whose
``mingpt-traffic/1`` report and ``mingpt-control/1`` log equal the JAX
package's byte for byte on the same converted tiny model and seed; a
process fleet (loopback backends, virtual clock) that scales up by adopting
its warm standby and drains a replica to exit 75; a halved prefill chunk
that compiles no new shape; and ``serve --replicas 1 --autoscale`` under
``--isolation thread`` and ``--isolation process`` (real CPU worker
subprocesses) over a trainer's snapshot, whose completions equal the plain
run's and whose control log is valid. CPU, tiny fp32 configs.
"""

import json
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mingpt_distributed_tpu.serving as j_serving
import traffic as j_traffic_cli
from mingpt_distributed_tpu import trafficlab as j_lab
from mingpt_distributed_tpu.config import GPTConfig as JConfig
from mingpt_distributed_tpu.control import controller as j_ctrl
from mingpt_distributed_tpu.control import importer as j_importer
from mingpt_distributed_tpu.models import generate as j_gen
from mingpt_distributed_tpu.models import gpt as j_gpt
from mingpt_distributed_tpu.serving import procfleet as j_pf
from mingpt_distributed_tpu.trafficlab.report import dump_report as j_dump
from mingpt_distributed_tpu_torch import serve as t_serve
from mingpt_distributed_tpu_torch import serving as t_serving
from mingpt_distributed_tpu_torch import traffic as traffic_cli
from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.control import (
    CONTROL_SCHEMA,
    ControllerConfig,
    HysteresisGovernor,
    SLOAutoscaler,
    compute_cost,
    cost_from_cell,
    import_trace_arrivals,
    parse_controller_spec,
    render_control_log,
    trace_arrival_times,
)
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import generate as gen
from mingpt_distributed_tpu_torch.serving import procfleet as t_pf
from mingpt_distributed_tpu_torch.telemetry import TraceRecorder, trace_sink
from mingpt_distributed_tpu_torch.trafficlab import (
    SweepSpec,
    arrival_times,
    parse_arrival_spec,
    render_traffic_report,
    validate_traffic_report,
)
from mingpt_distributed_tpu_torch.trafficlab.report import dump_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_SCHEMA = "mingpt-trace/1"
TINY = dict(n_layer=2, n_head=2, n_embd=32, vocab_size=50, block_size=32,
            embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
AUTO_SPEC = traffic_cli.AUTO_SPEC
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13], [40, 41]]
DRAIN_SPEC = ("auto:metric=queue_depth:target=4.0:comfort=0.5"
              ":interval_s=0.002:cooldown_s=0.01:up_after=2:down_after=3"
              ":min_replicas=1:max_replicas=2")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tiny models' ops are too small to share out,
    and under the suite's parallel workers a thread per core makes them
    contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pkgs():
    """(JAX, port) namespaces over one parameter tree (tests/test_control.py's
    tiny config; the port's weights converted from the JAX init)."""
    jcfg, tcfg = JConfig.make(**TINY), GPTConfig.make(**TINY)
    tree = j_gpt.init(jax.random.key(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.array, tree), tcfg, "cpu")
    jax_pkg = SimpleNamespace(name="jax", serving=j_serving, pf=j_pf, ctrl=j_ctrl,
                              cfg=jcfg, params=tree, place={})
    port = SimpleNamespace(name="port", serving=t_serving, pf=t_pf,
                           ctrl=SimpleNamespace(SLOAutoscaler=SLOAutoscaler,
                                                parse_controller_spec=parse_controller_spec),
                           cfg=tcfg, params=tparams, place={"device": "cpu"})
    return jax_pkg, port


def solo_greedy(pkg, prompt, n):
    if pkg.name == "jax":
        out = j_gen.generate(pkg.params, pkg.cfg, jnp.asarray(prompt, jnp.int32)[None], n)
        return np.asarray(out)[0, len(prompt):].tolist()
    return gen.generate(pkg.params, pkg.cfg, [prompt], n, device="cpu")[0, len(prompt):].tolist()


# ---------------------------------------------------------------------------
# hysteresis governor
# ---------------------------------------------------------------------------


def test_governor_alternating_noise_never_acts():
    g = HysteresisGovernor(up_after=2, down_after=2, cooldown_s=0.0)
    for i in range(100):
        breach = i % 2 == 0
        assert g.observe(breach, not breach, now=i * 0.01) is None
    assert g.breach_ticks <= 1 and g.comfort_ticks <= 1


def test_governor_sustained_breach_acts_once_then_cooldown():
    g = HysteresisGovernor(up_after=3, down_after=4, cooldown_s=1.0)
    assert g.observe(True, False, now=0.0) is None
    assert g.observe(True, False, now=0.1) is None
    assert g.observe(True, False, now=0.2) == "up"
    for i in range(8):  # discarded inside the cooldown, not accumulated
        assert g.observe(True, False, now=0.3 + i * 0.1) is None
    assert g.breach_ticks == 0
    assert g.observe(True, False, now=1.3) is None
    assert g.observe(True, False, now=1.4) is None
    assert g.observe(True, False, now=1.5) == "up"


def test_governor_comfort_streak_scales_down_and_resets():
    g = HysteresisGovernor(up_after=2, down_after=3, cooldown_s=0.0)
    assert g.observe(False, True, now=0.0) is None
    assert g.observe(False, True, now=0.1) is None
    assert g.observe(False, False, now=0.2) is None  # a deadband tick resets
    assert g.observe(False, True, now=0.3) is None
    assert g.observe(False, True, now=0.4) is None
    assert g.observe(False, True, now=0.5) == "down"
    assert g.breach_ticks == 0 and g.comfort_ticks == 0


def test_governor_decisions_equal_jax_on_a_seeded_noise_stream():
    rng = np.random.default_rng(0)
    flips = rng.integers(0, 3, size=400)
    ours = HysteresisGovernor(up_after=2, down_after=3, cooldown_s=0.05)
    theirs = j_ctrl.HysteresisGovernor(up_after=2, down_after=3, cooldown_s=0.05)
    got = [(ours.observe(f == 0, f == 1, now=i * 0.01),
            theirs.observe(f == 0, f == 1, now=i * 0.01)) for i, f in enumerate(flips)]
    assert all(a == b for a, b in got)
    assert {a for a, _ in got} == {None, "up", "down"}


# ---------------------------------------------------------------------------
# controller spec grammar
# ---------------------------------------------------------------------------


def test_parse_controller_spec_static_and_defaults():
    assert parse_controller_spec("static") is None
    cfg = parse_controller_spec("auto")
    assert isinstance(cfg, ControllerConfig)
    assert cfg.metric == "ttft_p99" and cfg.min_replicas == 1
    assert vars(cfg) == vars(j_ctrl.parse_controller_spec("auto"))


def test_parse_controller_spec_overrides_round_trip():
    text = ("auto:metric=queue_depth:target=2.0:comfort=0.25:up_after=3"
            ":down_after=7:min_replicas=2:max_replicas=3:interval_s=0.01"
            ":cooldown_s=0.1:queue_high=4.0:min_chunk=8")
    cfg = parse_controller_spec(text)
    assert cfg.metric == "queue_depth"
    assert cfg.target == 2.0 and cfg.comfort == 0.25
    assert (cfg.up_after, cfg.down_after) == (3, 7)
    assert (cfg.min_replicas, cfg.max_replicas) == (2, 3)
    assert cfg.interval_s == 0.01 and cfg.cooldown_s == 0.1
    assert cfg.queue_high == 4.0 and cfg.min_chunk == 8
    assert vars(cfg) == vars(j_ctrl.parse_controller_spec(text))


@pytest.mark.parametrize("bad", [
    "manual",
    "auto:metric",
    "auto:target=1:target=2",
    "auto:frobnicate=1",
    "auto:metric=ttft_p50",
    "auto:target=-1",
    "auto:min_replicas=3:max_replicas=1",
    "auto:comfort=1.5",
])
def test_parse_controller_spec_rejects(bad):
    with pytest.raises(ValueError) as ours:
        parse_controller_spec(bad)
    with pytest.raises(ValueError) as theirs:
        j_ctrl.parse_controller_spec(bad)
    assert str(ours.value) == str(theirs.value)


def test_render_control_log_equals_jax():
    rows = [{"schema": CONTROL_SCHEMA, "tick": 1, "b": [1.5, None], "a": "x"},
            {"tick": 2, "schema": CONTROL_SCHEMA, "action": {"z": 1, "y": 2}}]
    assert render_control_log(rows) == j_ctrl.render_control_log(rows)
    assert render_control_log(rows).splitlines()[0].startswith('{"a": "x"')


# ---------------------------------------------------------------------------
# cost model units
# ---------------------------------------------------------------------------


def test_compute_cost_hand_counts():
    c = compute_cost({"completed": 6, "shed": 2, "expired": 1, "errors": 1,
                      "tokens": 100, "deadline_requests": 5, "deadline_hits": 3})
    assert c["shed_rate"] == pytest.approx(0.2)
    assert c["deadline_miss_per_ktok"] == pytest.approx(20.0)
    assert c["goodput_tokens"] == pytest.approx(80.0)
    assert c["cost"] == pytest.approx(0.02 + 0.2)


def test_compute_cost_edges():
    zeros = {k: 0 for k in ("completed", "shed", "expired", "errors", "tokens",
                            "deadline_requests", "deadline_hits")}
    assert compute_cost(zeros) == {"deadline_miss_per_ktok": 0.0, "shed_rate": 0.0,
                                   "goodput_tokens": 0.0, "cost": 0.0}
    c = compute_cost(dict(zeros, shed=4, deadline_requests=3))
    assert c["shed_rate"] == 1.0 and c["cost"] == pytest.approx(4.0)
    for bad in ({k: v for k, v in zeros.items() if k != "tokens"},
                dict(zeros, completed=-1), dict(zeros, deadline_hits=1)):
        with pytest.raises(ValueError):
            compute_cost(bad)


def test_cost_from_cell_matches_and_handles_none_rate():
    cell = {"completed": 6, "shed": 2, "expired": 1, "errors": 1, "tokens": 100,
            "deadline_requests": 5, "deadline_hit_rate": 3 / 5}
    assert cost_from_cell(cell) == compute_cost({
        "completed": 6, "shed": 2, "expired": 1, "errors": 1, "tokens": 100,
        "deadline_requests": 5, "deadline_hits": 3})
    quiet = dict(cell, deadline_requests=0, deadline_hit_rate=None)
    assert cost_from_cell(quiet)["deadline_miss_per_ktok"] == 0.0


# ---------------------------------------------------------------------------
# trace importer
# ---------------------------------------------------------------------------


def _write_trace(path, stamps, outcomes=None):
    """A minimal valid mingpt-trace/1 file: one request summary per arrival,
    deliberately out of order (the importer sorts)."""
    outcomes = outcomes or ["completed"] * len(stamps)
    with open(path, "w", encoding="utf-8") as fh:
        for i, (ts, outcome) in enumerate(zip(stamps, outcomes)):
            fh.write(json.dumps({
                "schema": TRACE_SCHEMA, "kind": "request",
                "trace_id": f"t{i}", "request_id": f"r{i}",
                "ts": ts, "end_ts": ts + 0.5, "total_s": 0.5,
                "outcome": outcome, "n_tokens": 0, "attempts": 1,
            }) + "\n")


def test_importer_roundtrip_exact(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    _write_trace(path, stamps=[3.5, 1.25, 1.75, 9.0],
                 outcomes=["completed", "completed", "shed", "expired"])
    times = trace_arrival_times(path)
    assert times == (0.0, 0.5, 2.25, 7.75)
    assert times == j_importer.trace_arrival_times(path)
    spec, meta = import_trace_arrivals(path)
    assert meta["n_requests"] == 4
    assert meta["duration_s"] == pytest.approx(7.75)
    assert meta["mean_rate"] == pytest.approx(3 / 7.75)
    j_spec, j_meta = j_importer.import_trace_arrivals(path)
    assert meta == j_meta and spec.to_string() == j_spec.to_string()
    for seed in (0, 1, 12345):
        assert arrival_times(spec, 4, seed) == [0.0, 0.5, 2.25, 7.75]
    assert arrival_times(spec, 2, 0, start=10.0) == [10.0, 10.5]
    with pytest.raises(ValueError):
        arrival_times(spec, 5, 0)
    assert parse_arrival_spec(spec.to_string()).times == spec.times


def test_importer_rejects_empty_trace(tmp_path):
    path = str(tmp_path / "empty.jsonl")
    open(path, "w").close()
    with pytest.raises(ValueError):
        trace_arrival_times(path)


def test_importer_reads_a_recorded_fleet_trace(pkgs, tmp_path):
    """A trace the port's fleet wrote replays at its recorded submit times."""
    port = pkgs[1]
    path = str(tmp_path / "fleet.jsonl")
    recorder = TraceRecorder(sink=trace_sink(path))
    sup = t_serving.ReplicaSupervisor(
        t_serving.default_server_factory(port.params, port.cfg, n_slots=2, device="cpu"),
        n_replicas=1, clock=t_serving.VirtualClock(tick_s=0.001))
    router = t_serving.Router(sup, trace_recorder=recorder)
    for p in PROMPTS:
        router.submit(t_serving.Request(prompt=p, max_new_tokens=3))
        router.step()
    router.run_until_drained(max_steps=500)
    recorder.close()
    times = trace_arrival_times(path)
    assert len(times) == len(PROMPTS) and times[0] == 0.0
    assert list(times) == sorted(times) and times[-1] > 0
    assert times == j_importer.trace_arrival_times(path)


# ---------------------------------------------------------------------------
# autoscaled sweeps
# ---------------------------------------------------------------------------


def test_autoscaled_sweep_byte_identical(pkgs):
    """Two runs of one autoscaled sweep give the same report bytes and the
    same control-log bytes (the controller runs on the virtual clock)."""
    port = pkgs[1]
    spec = SweepSpec(arrival="ramp:rate0=1400.0:rate1=4.0:duration=0.04",
                     ladder=(1.0,), policies=("fifo",), controllers=("static", AUTO_SPEC),
                     n_requests=16, seed=0, n_replicas=1, n_slots=2,
                     slo="ttft_p95<=0.025,shed_rate<=0.5", prefix_cache_mb=0.5)

    def run_once():
        return traffic_cli.run_with_logs(port.params, port.cfg, spec, None,
                                         dict(device="cpu"))

    report_a, logs_a = run_once()
    report_b, logs_b = run_once()
    validate_traffic_report(report_a)
    assert report_a["policies"] == ["fifo", "fifo+auto"]
    assert render_traffic_report(report_a) == render_traffic_report(report_b)
    assert dump_report(report_a) == dump_report(report_b)
    assert logs_a == logs_b and (0, "fifo+auto") in logs_a
    cell = report_a["rungs"][0]["policies"]["fifo+auto"]
    assert cell["control"]["spec"] == AUTO_SPEC
    rows = [json.loads(line) for line in logs_a[(0, "fifo+auto")].splitlines()]
    assert rows and all(r["schema"] == CONTROL_SCHEMA for r in rows)
    assert cell["control"]["ticks"] == len(rows)
    static = report_a["rungs"][0]["policies"]["fifo"]
    assert "control" not in static and "cost" in static


@pytest.fixture(scope="module")
def controller_selftests():
    """``traffic --selftest-controller``'s canned sweep: the port's (twice)
    and the JAX package's, on the tiny self-test model (the port's weights
    converted from the JAX init)."""
    jcfg, tree = j_traffic_cli._tiny_model()
    cfg = traffic_cli.tiny_config()
    params = convert.params_from_numpy(jax.tree.map(np.array, tree), cfg, "cpu")
    port = [traffic_cli.run_with_logs(params, cfg, traffic_cli.selftest_controller_spec(),
                                      traffic_cli.selftest_mix(), dict(device="cpu"))
            for _ in range(2)]
    logs = {}
    jax_report = j_lab.run_sweep(
        tree, jcfg, j_traffic_cli.selftest_controller_spec(), mix=j_traffic_cli.selftest_mix(),
        control_log_sink=lambda r, lb, text: logs.__setitem__((r, lb), text))
    return port, (jax_report, logs)


def test_selftest_controller_report_and_log_equal_jax_byte_for_byte(controller_selftests):
    (report, logs), _ = controller_selftests[0]
    jax_report, jax_logs = controller_selftests[1]
    assert dump_report(report) == j_dump(jax_report)
    assert logs == jax_logs and set(logs) == {(0, "fifo+auto")}
    # each package's validator accepts the other's report
    parsed = json.loads(dump_report(report))
    assert j_lab.validate_traffic_report(parsed, strict=True) == []
    assert validate_traffic_report(json.loads(j_dump(jax_report)), strict=True) == []


def test_selftest_controller_gates_hold(controller_selftests):
    (report, logs), (report2, logs2) = controller_selftests[0]
    assert traffic_cli.controller_checks(report, logs, report2, logs2) == 0
    actions = report["rungs"][0]["policies"]["fifo+auto"]["control"]["actions"]
    assert actions["replicas"]["up"] >= 1 and actions["replicas"]["down"] >= 1


def test_selftest_controller_cli(capsys):
    assert traffic_cli.main(["--device", "cpu", "--selftest-controller"]) == 0
    out = capsys.readouterr().out
    assert "selftest-controller PASSED" in out and "fifo+auto" in out


def test_controllers_flag_runs_an_autoscaled_sweep(tmp_path, capsys):
    out_path = str(tmp_path / "r.json")
    argv = ["--device", "cpu", "--random-init", "--ladder", "1", "--requests", "12",
            "--replicas", "1", "--slots", "2", "--policies", "fifo",
            "--arrival", "ramp:rate0=1400:rate1=4:duration=0.04",
            "--controllers", f"static,{AUTO_SPEC}", "--out", out_path,
            "gpt_config.n_layer=1", "gpt_config.n_head=2", "gpt_config.n_embd=32",
            "gpt_config.dtype=float32", "data_config.block_size=48"]
    assert traffic_cli.main(argv) == 0
    with open(out_path) as f:
        report = json.load(f)
    assert validate_traffic_report(report, strict=True) == []
    assert report["policies"] == ["fifo", "fifo+auto"]
    assert report["controllers"] == ["static", AUTO_SPEC]
    assert "fifo+auto" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# drain, never kill
# ---------------------------------------------------------------------------


def _drain_scenario(pkg):
    """tests/test_control.py's scale-down scenario in ``pkg``: an idle
    2-replica fleet drains one replica down to min_replicas."""
    s = pkg.serving
    sup = s.ReplicaSupervisor(
        s.default_server_factory(pkg.params, pkg.cfg, n_slots=2, **pkg.place),
        n_replicas=2, clock=s.VirtualClock(tick_s=0.001),
        max_restarts=1, restart_backoff_s=0.01)
    router = s.Router(sup, max_retries=3, retry_backoff_s=0.01)
    controller = pkg.ctrl.SLOAutoscaler(router, pkg.ctrl.parse_controller_spec(DRAIN_SPEC))
    router.controller = controller
    handles = [router.submit(s.Request(prompt=p, max_new_tokens=4)) for p in PROMPTS]
    router.run_until_drained(max_steps=500)
    for _ in range(200):
        router.step()
        if any(rep.state == "drained" for rep in sup.replicas):
            break
    summary = router.summary()
    late = router.submit(s.Request(prompt=[6, 7, 8], max_new_tokens=3))
    router.run_until_drained(max_steps=500)
    return dict(
        handles=[(h.tokens, h.finish_reason, h.duplicates_suppressed) for h in handles],
        states=[rep.state for rep in sup.replicas],
        actions=controller.action_counts(), summary=summary,
        late=(late.tokens, late.replica, late.finished),
        drained=[rep.name for rep in sup.replicas if rep.state == "drained"],
        log=controller.render_log(), ticks=controller.tick)


def test_scale_down_drains_never_kills(pkgs):
    jax_run, run = (_drain_scenario(pkg) for pkg in pkgs)
    assert run == jax_run
    for (tokens, reason, dups), p in zip(run["handles"], PROMPTS):
        assert reason == "length" and dups == 0
        assert tokens == solo_greedy(pkgs[1], p, 4)
    assert run["states"].count("drained") == 1
    assert run["actions"]["replicas"]["down"] == 1
    assert run["summary"]["requests_by_outcome"].get("error", 0) == 0
    assert run["summary"]["requests_by_outcome"]["completed"] == len(PROMPTS)
    assert run["summary"]["retries_by_reason"] == {"crash": 0, "admit": 0, "error": 0}
    tokens, replica, finished = run["late"]
    assert finished and tokens == solo_greedy(pkgs[1], [6, 7, 8], 3)
    assert replica not in run["drained"]
    rows = [json.loads(line) for line in run["log"].splitlines()]
    assert rows and all(r["schema"] == CONTROL_SCHEMA for r in rows)
    assert run["ticks"] == len(rows)
    assert any(r["action"] == {"actuator": "replicas", "direction": "down"} for r in rows)


def _procfleet_autoscale(pkg):
    """A process fleet (loopback backends, virtual clock) at 1 replica with
    one warm standby: a burst scales it up by adopting the standby, then the
    idle fleet drains the newcomer, which retires with exit 75."""
    s, pf = pkg.serving, pkg.pf
    sup = pf.ProcessSupervisor(
        pf.loopback_backend_factory(pkg.params, pkg.cfg, n_slots=2, **pkg.place),
        n_replicas=1, clock=s.VirtualClock(tick_s=0.001), max_restarts=1,
        restart_backoff_s=0.01, standby=1)
    router = pf.ProcRouter(sup, max_retries=3, retry_backoff_s=0.01)
    controller = pkg.ctrl.SLOAutoscaler(router, pkg.ctrl.parse_controller_spec(
        "auto:metric=queue_depth:target=1.0:comfort=0.5:interval_s=0.002"
        ":cooldown_s=0.01:up_after=1:down_after=3:min_replicas=1:max_replicas=2"))
    router.controller = controller
    prompts = [[1 + i, 2 + i, 3 + i] for i in range(10)]
    handles = [router.submit(s.Request(prompt=p, max_new_tokens=5)) for p in prompts]
    router.run_until_drained(max_steps=5000)
    for _ in range(400):
        router.step()
        if any(rep.state == "drained" for rep in sup.replicas):
            break
    rows = [json.loads(line) for line in controller.render_log().splitlines()]
    out = dict(
        tokens=[h.tokens for h in handles], reasons=[h.finish_reason for h in handles],
        dups=sum(h.duplicates_suppressed for h in handles),
        ups=[r["reason"] for r in rows if r["action"] == {"actuator": "replicas",
                                                          "direction": "up"}],
        downs=[r["reason"] for r in rows if r["action"] == {"actuator": "replicas",
                                                            "direction": "down"}],
        states=[(rep.name, rep.state) for rep in sup.replicas],
        retries=router.summary()["retries_by_reason"],
        exits=dict(sup.drained_exits), schema_ok=all(r["schema"] == CONTROL_SCHEMA
                                                     for r in rows))
    out["final_exits"] = sup.shutdown_all()
    return out, prompts


def test_process_fleet_scales_up_from_standby_and_drains_to_exit_75(pkgs):
    (jax_run, prompts), (run, _) = (_procfleet_autoscale(pkg) for pkg in pkgs)
    assert run == jax_run
    assert all(r == "length" for r in run["reasons"]) and run["dups"] == 0
    for tokens, p in zip(run["tokens"], prompts):
        assert tokens == solo_greedy(pkgs[1], p, 5)
    assert run["ups"] and "path=standby" in run["ups"][0]
    assert run["downs"] and run["schema_ok"]
    drained = [name for name, state in run["states"] if state == "drained"]
    assert len(drained) == 1 and run["exits"] == {drained[0]: 75}
    assert run["retries"] == {"crash": 0, "admit": 0, "error": 0}


# ---------------------------------------------------------------------------
# the prefill-chunk lever
# ---------------------------------------------------------------------------


def test_halved_prefill_chunk_compiles_no_new_shape(pkgs):
    """After warmup, the controller's halved chunk pads to ladder buckets
    already run: compile_counts() reads no new prefill shape, and the tokens
    stay solo greedy's."""
    port = pkgs[1]
    server = t_serving.InferenceServer(port.params, port.cfg, n_slots=2, device="cpu",
                                       prefill_chunk=16)
    server.engine.warmup()
    before = server.compile_counts()
    sup = SimpleNamespace(replicas=[SimpleNamespace(state="ready", server=server)])
    ctrl = SLOAutoscaler.__new__(SLOAutoscaler)
    ctrl.supervisor, ctrl.cfg = sup, parse_controller_spec("auto:min_chunk=4")
    ctrl._chunk_halvings = 0
    ctrl._servers = lambda: iter(sup.replicas)
    assert ctrl._min_live_chunk() == 16
    server.engine.prefill_chunk = max(ctrl.cfg.min_chunk, server.engine.prefill_chunk // 2)
    prompt = list(range(1, 30))
    h = server.submit(t_serving.Request(prompt=prompt, max_new_tokens=3))
    server.run_until_drained(max_steps=200)
    assert server.engine.prefill_chunk == 8
    assert server.compile_counts() == before
    assert h.tokens == solo_greedy(port, prompt, 3)


# ---------------------------------------------------------------------------
# serve --autoscale
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained_snapshot(tmp_path_factory):
    """A 3-step snapshot of a small GPT on the corpus, and its overrides."""
    from mingpt_distributed_tpu_torch import train as t_train

    tmp = tmp_path_factory.mktemp("autoscale_serve")
    argv = ["--config", os.path.join(REPO, "gpt2_config.yaml"), "gpt_config.n_layer=2",
            "gpt_config.n_head=4", "gpt_config.n_embd=64", "gpt_config.dtype=float32",
            "gpt_config.attn_pdrop=0", f"data_config.path={os.path.join(REPO, 'data', 'input.txt')}",
            "data_config.block_size=32", "data_config.truncate=0.2",
            f"trainer_config.snapshot_path={tmp / 'snap.pt'}"]
    assert t_train.main(["--device", "cpu", *argv, "trainer_config.batch_size=8",
                         "trainer_config.max_steps=3", "trainer_config.eval_batches=1"]) == 0
    prompts = tmp / "prompts.txt"
    prompts.write_text("the king \nand so \nwhat is \nto be \nmy lord \nthe end \n")
    return tmp, argv, prompts


def _completions(out):
    parts = re.split(r"^=== (?:fleet-|req-)?\d+ \(length\) ===\n", out, flags=re.M)[1:]
    parts[-1] = parts[-1].rsplit("\n{", 1)[0]
    return parts


@pytest.mark.parametrize("isolation", ["thread", "process"])
def test_serve_replicas_1_autoscale_equals_plain_serving(trained_snapshot, isolation, capsys):
    """serve --replicas 1 --autoscale builds a fleet (real worker
    subprocesses under --isolation process), scales it up under the burst of
    prompts, and prints the same completions as plain serving; every row of
    --control-log is a mingpt-control/1 decision."""
    tmp, argv, prompts = trained_snapshot
    common = ["--prompts-file", str(prompts), "--device", "cpu", "--greedy",
              "--max-new-tokens", "6", "--slots", "2", *argv]
    capsys.readouterr()
    assert t_serve.main(common) == 0
    plain = _completions(capsys.readouterr().out)
    log = tmp / f"control-{isolation}.jsonl"
    spec = ("auto:metric=queue_depth:target=0.5:comfort=0.5:interval_s=0:cooldown_s=0"
            ":up_after=1:down_after=1:min_replicas=1:max_replicas=2")
    standby = ["--standby", "1"] if isolation == "process" else []
    assert t_serve.main(["--replicas", "1", "--autoscale", spec, "--control-log", str(log),
                         "--isolation", isolation, "--spill-dir", str(tmp / "spill"),
                         *standby, *common]) == 0
    cap = capsys.readouterr()
    assert "[serve] SLO autoscaler attached" in cap.err
    assert len(plain) == 6 and _completions(cap.out) == plain
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert rows and all(r["schema"] == CONTROL_SCHEMA for r in rows)
    assert [r["tick"] for r in rows] == list(range(1, len(rows) + 1))
    ups = [r for r in rows if r["action"] == {"actuator": "replicas", "direction": "up"}]
    assert ups and "spawned replica1" in ups[0]["reason"]
    if isolation == "process":  # the warm spare adopted, backfilled on a thread
        assert "path=standby" in ups[0]["reason"]
        assert "process fleet: 1 worker processes x 2 slots" in cap.err
        exits = re.search(r"worker exits: (\{.*\})", cap.err).group(1)
        assert set(re.findall(r": (-?\d+)", exits)) == {"75"}


def test_slo_target_is_shorthand_for_auto_target():
    args = t_serve.parse_args(["--slo-target", "0.03"])
    assert t_serve._autoscale_spec(args) == "auto:target=0.03"
    assert t_serve._autoscale_spec(t_serve.parse_args(["--autoscale", "static"])) is None
    with pytest.raises(SystemExit, match="bad --autoscale spec"):
        t_serve._autoscale_spec(t_serve.parse_args(["--autoscale", "auto:comfort=2"]))


# ---------------------------------------------------------------------------
# the warm-standby backfill on a thread, and the control-log validator
# ---------------------------------------------------------------------------


class _FakeBackend:
    def __init__(self, name):
        self.name = name

    def alive(self):
        return True


def test_standby_backfill_in_background_refills_and_reraises():
    """A scale-up on the wall clock backfills the pool on a thread: the
    pool refills to its size without counting twice what is in flight, and
    a failed spawn is re-raised by ``join``."""
    import threading

    from mingpt_distributed_tpu_torch.serving.procfleet.supervisor import StandbyPool
    from mingpt_distributed_tpu_torch.telemetry import MetricsRegistry

    gate, made = threading.Event(), []

    def factory(name, clock, fault_hook):
        gate.wait(10)
        made.append(name)
        return _FakeBackend(name)

    gate.set()
    pool = StandbyPool(factory, t_serving.VirtualClock(), 2, MetricsRegistry())
    assert pool.available() == 2 and made == ["standby0", "standby1"]
    assert pool.acquire()[0] == "standby0" and pool.available() == 1
    gate.clear()
    pool.fill_in_background()
    pool.fill_in_background()  # one thread at a time
    assert pool.fill() == 0    # the spawn in flight counts toward the size
    gate.set()
    pool.join(timeout_s=10)
    assert pool.available() == 2 and made[2:] == ["standby2"]

    def broken(name, clock, fault_hook):
        raise OSError("no worker")

    pool.factory = broken
    pool.acquire()
    pool.fill_in_background()
    with pytest.raises(RuntimeError, match="backfill failed"):
        pool.join(timeout_s=10)


def test_control_log_validator_accepts_both_packages_logs(controller_selftests):
    from mingpt_distributed_tpu_torch.control import validate_control_log

    (_, logs), _ = controller_selftests[0]
    _, jax_logs = controller_selftests[1]
    for text in (*logs.values(), *jax_logs.values()):
        assert validate_control_log(text) == []
    rows = logs[(0, "fifo+auto")].splitlines()
    assert validate_control_log("\n".join(rows[:3] + rows[4:]))  # a tick lost
    assert validate_control_log(rows[0].replace('"replicas_ready": 1', '"replicas_ready": "1"'))
