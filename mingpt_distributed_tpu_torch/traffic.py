"""Traffic lab CLI of the port: open-loop load sweeps over the serving fleet.

Counterpart of the repository's ``traffic.py``. Drives
``mingpt_distributed_tpu_torch/trafficlab`` end to end: a seeded arrival
process (Poisson / bursty / ramp) is offered at each rung of a load ladder,
every admission policy (fifo / edf / fair / health) replays the IDENTICAL
arrival trace per rung against a fresh fleet on the VirtualClock, each
(rung, policy) cell is graded by the telemetry SLO engine, and the result is
a versioned ``mingpt-traffic/1`` JSON report with the knee rung (the first
rung where the named objective fails). No wall clock is read: the same seed
reproduces the report byte for byte, on the CPU and on a card. Runs on CUDA
unless ``--device cpu``.

Modes:

  sweep (default)     restore the training snapshot (as serve does) and
                      sweep it:
                        python -m mingpt_distributed_tpu_torch.traffic \\
                            --arrival poisson:rate=60 --ladder 1,2,4 \\
                            --policies fifo,edf --out r.json
                      (--random-init skips the checkpoint: random weights at
                      the config's dims — the schedule's shape, no real text)
  self-test           random-init tiny model, 2-rung FIFO-vs-EDF sweep on a
                      deadline-mixed workload; asserts the report
                      strict-parses, the knee is located (the objective
                      passes at rung 0 and fails at rung 1), EDF beats FIFO
                      on deadline hit rate at the overload rung, and a
                      second run is byte-identical:
                        python -m mingpt_distributed_tpu_torch.traffic \\
                            --device cpu --selftest-traffic
  controller test     one down-ramp rung, static vs SLO-autoscaled FIFO on
                      the identical trace; asserts the controller scales up
                      AND back down, beats static on deadline hit rate and
                      on the cost model, the control log is valid
                      mingpt-control/1, and a rerun is byte-identical
                      (report and log):
                        python -m mingpt_distributed_tpu_torch.traffic \\
                            --device cpu --selftest-controller

Knobs: --arrival SPEC (poisson:rate=R | bursty:rate_on=..:rate_off=..:
period=..:duty=.. | ramp:rate0=..:rate1=..:duration=..), --ladder
"f1,f2,..." (load multipliers, strictly increasing), --policies
"fifo,edf,fair", --requests N per rung, --seed, --replicas/--slots (fleet
geometry), --slo SPEC (telemetry/slo.py grammar), --knee-objective NAME
(default: the first objective), --chaos-spec SPEC (ServingFaultInjector
grammar — the same sweep graded under crashes), --shed-watermark D,
--prefix-cache-mb M, --out PATH (report JSON), --hosts N (> 1: every cell
on the loopback cross-host mesh, --replicas per host) with
--net-chaos-spec SPEC (NetworkFaultInjector grammar: partition, drop_frame,
slow_link, host_kill), --controllers "static,auto:..." (the SLO-autoscaler
axis: every policy runs once per controller on the identical trace).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from mingpt_distributed_tpu_torch.utils.device import resolve_device


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="gpt2_config.yaml")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--arrival", default="poisson:rate=60.0",
                   help="base arrival spec (see module docstring); the "
                        "ladder multiplies its rates")
    p.add_argument("--ladder", default="1,2,4",
                   help="comma-separated load factors, strictly increasing")
    p.add_argument("--policies", default="fifo,edf",
                   help="admission policies to compare on the identical "
                        "trace (fifo | edf | fair | health)")
    p.add_argument("--requests", type=int, default=64,
                   help="arrivals per rung")
    p.add_argument("--seed", type=int, default=0,
                   help="replay seed: (seed, specs) fully determine the "
                        "report bytes")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--slots", type=int, default=4,
                   help="KV slots per replica")
    p.add_argument("--tick-s", type=float, default=0.001,
                   help="virtual seconds per fleet scheduling round")
    p.add_argument("--slo", default="default",
                   help="SLO spec to grade each cell with "
                        "(telemetry/slo.py grammar; 'default' = stock "
                        "objectives)")
    p.add_argument("--knee-objective", default=None,
                   help="objective name the knee is located on (default: "
                        "first objective in --slo)")
    p.add_argument("--chaos-spec", default=None,
                   help="ServingFaultInjector spec: grade the same sweep "
                        "under injected faults")
    p.add_argument("--hosts", type=int, default=1,
                   help="> 1 runs every cell on the loopback cross-host "
                        "mesh (--replicas becomes per host)")
    p.add_argument("--net-chaos-spec", default=None,
                   help="NetworkFaultInjector spec (partition / drop_frame / "
                        "slow_link / host_kill) over the host mesh; needs "
                        "--hosts >= 2")
    p.add_argument("--controllers", default="static",
                   help="comma-separated controller axis: each entry is "
                        "'static' or an 'auto[:k=v...]' SLO-autoscaler "
                        "spec; every policy runs once per controller on "
                        "the identical trace (autoscaled cells are "
                        "labelled policy+auto)")
    p.add_argument("--shed-watermark", type=int, default=None,
                   help="fleet-wide queue depth that sheds new arrivals")
    p.add_argument("--prefix-cache-mb", type=float, default=0.0,
                   help="per-replica shared-prefix KV budget (MiB); >0 "
                        "lets shared-prefix tenants hit the store")
    p.add_argument("--out", default=None,
                   help="write the mingpt-traffic/1 report JSON here")
    p.add_argument("--random-init", action="store_true",
                   help="skip checkpoint restore: random weights at the "
                        "config's dims (scheduling study only)")
    p.add_argument("--selftest-traffic", action="store_true",
                   help="tiny random-init model, canned 2-rung FIFO/EDF "
                        "sweep; asserts knee + policy separation + "
                        "byte-identical replay, then exits")
    p.add_argument("--selftest-controller", action="store_true",
                   help="tiny random-init model, one down-ramp rung, "
                        "static vs SLO-autoscaled cells on the identical "
                        "trace; asserts the controller scales up AND back "
                        "down, beats static on deadline hit-rate and "
                        "cost, and replays byte-identically (report and "
                        "mingpt-control/1 log), then exits")
    p.add_argument("overrides", nargs="*")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    return build_argparser().parse_args(argv)


def _parse_ladder(text: str):
    try:
        ladder = tuple(float(f) for f in text.split(",") if f.strip())
    except ValueError:
        raise SystemExit(f"--ladder must be comma-separated floats, "
                         f"got {text!r}")
    if not ladder:
        raise SystemExit("--ladder is empty")
    return ladder


def _sweep_spec(args):
    from mingpt_distributed_tpu_torch.trafficlab import SweepSpec

    spec = SweepSpec(
        arrival=args.arrival,
        ladder=_parse_ladder(args.ladder),
        policies=tuple(p.strip() for p in args.policies.split(",")
                       if p.strip()),
        n_requests=args.requests,
        seed=args.seed,
        n_replicas=args.replicas,
        n_slots=args.slots,
        tick_s=args.tick_s,
        slo=args.slo,
        knee_objective=args.knee_objective,
        chaos_spec=args.chaos_spec,
        n_hosts=args.hosts,
        net_chaos_spec=args.net_chaos_spec,
        controllers=tuple(c.strip() for c in args.controllers.split(",")
                          if c.strip()),
        shed_watermark=args.shed_watermark,
        prefix_cache_mb=args.prefix_cache_mb,
    )
    try:
        spec.validate()
    except ValueError as e:
        raise SystemExit(f"bad sweep parameters: {e}")
    return spec


def tiny_config():
    """The repository's tiny self-test geometry (serve --selftest's)."""
    from mingpt_distributed_tpu_torch.config import GPTConfig

    return GPTConfig.make(
        n_layer=2, n_head=2, n_embd=32, vocab_size=96, block_size=48,
        embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")


def selftest_mix(vocab_size: int = 96):
    """The tuned self-test workload: a deadline-tight chat tenant that EDF
    saves under overload, a deadline-free batch tenant whose long decodes
    clog FIFO queues, and a shared-prefix tenant for the PrefixKVStore.
    The virtual schedule depends on token counts only, so the same mix at
    another ``vocab_size`` (GPT-2's 50257 on the card) keeps its verdicts."""
    from mingpt_distributed_tpu_torch.trafficlab import TenantSpec, WorkloadMix

    return WorkloadMix(vocab_size=vocab_size, tenants=(
        TenantSpec(name="chat", family="chat", weight=3.0,
                   prompt_len=(3, 8), max_new=(2, 4), deadline_s=0.035),
        TenantSpec(name="batch", family="completion", weight=3.0,
                   prompt_len=(4, 10), max_new=(10, 16)),
        TenantSpec(name="assist", family="prefix", weight=2.0,
                   prompt_len=(8, 14), max_new=(2, 6), deadline_s=0.08,
                   prefix_pool=2, prefix_len=6),
    ))


def selftest_sweep_spec(ladder=(1.0, 24.0), prefix_cache_mb: float = 0.5):
    """The canned self-test sweep: rung 0 well under the 1 x 2-slot fleet's
    capacity, the last rung strongly over it."""
    from mingpt_distributed_tpu_torch.trafficlab import SweepSpec

    return SweepSpec(
        arrival="poisson:rate=40.0",
        ladder=ladder,
        policies=("fifo", "edf"),
        n_requests=40,
        seed=0,
        n_replicas=1,
        n_slots=2,
        slo="ttft_p95<=0.025,shed_rate<=0.5",
        prefix_cache_mb=prefix_cache_mb,
    )


def selftest_checks(report, report2, tag: str = "selftest-traffic") -> int:
    """The self-test's gates on a report and its rerun: strict validation
    after a JSON round trip, a knee with the pass->fail shape, EDF strictly
    above FIFO on deadline hit rate at the overload rung (the same trace:
    the report's trace_sha256 says so) and byte-identical replay. Prints a
    line per gate; returns 0 when all hold."""
    from mingpt_distributed_tpu_torch.trafficlab import validate_traffic_report
    from mingpt_distributed_tpu_torch.trafficlab.report import dump_report

    rc = 0

    def check(ok: bool, what: str) -> None:
        nonlocal rc
        print(f"{tag} {'OK' if ok else 'FAIL'}: {what}")
        if not ok:
            rc = 1

    parsed = json.loads(dump_report(report))
    problems = validate_traffic_report(parsed, strict=False)
    check(not problems, f"report strict-parses (problems={problems})")
    knee = parsed.get("knee")
    check(knee is not None and knee["valid"],
          f"knee located with pass->fail shape (knee={knee})")
    last = parsed["rungs"][-1]["policies"]
    fifo_hit = last["fifo"]["deadline_hit_rate"]
    edf_hit = last["edf"]["deadline_hit_rate"]
    check(fifo_hit is not None and edf_hit is not None and edf_hit > fifo_hit,
          f"EDF > FIFO on deadline-hit-rate at the overload rung "
          f"(edf={edf_hit} fifo={fifo_hit})")
    check(dump_report(report) == dump_report(report2),
          "same-seed rerun is byte-identical")
    return rc


def selftest_traffic(args) -> int:
    """The canned sweep on the tiny random-init model, run twice, through
    ``selftest_checks``."""
    import torch

    from mingpt_distributed_tpu_torch.models import gpt
    from mingpt_distributed_tpu_torch.trafficlab import (
        render_traffic_report,
        run_sweep,
    )

    dev = resolve_device(args.device)
    cfg = tiny_config()
    params = gpt.init(cfg, torch.Generator().manual_seed(0), device=dev)
    spec, mix = selftest_sweep_spec(), selftest_mix()
    kw = dict(device=dev)
    report = run_sweep(params, cfg, spec, mix=mix, server_kwargs=kw)
    print(render_traffic_report(report))
    report2 = run_sweep(params, cfg, spec, mix=mix, server_kwargs=kw)
    rc = selftest_checks(report, report2)
    print("selftest-traffic " + ("PASSED" if rc == 0 else "FAILED"))
    return rc


AUTO_SPEC = ("auto:metric=queue_depth:target=2.0:comfort=0.5"
             ":interval_s=0.002:cooldown_s=0.02:up_after=2:down_after=5"
             ":min_replicas=1:max_replicas=3")


def selftest_controller_spec():
    """The canned controller geometry: a DOWN-ramp, so one cell runs both
    directions — the early burst (~300/s against a 1 x 2-slot fleet) forces
    scale-ups, the sparse tail (~6/s) leaves the extra replicas comfortable
    long enough to drain back down."""
    from mingpt_distributed_tpu_torch.trafficlab import SweepSpec

    return SweepSpec(
        arrival="ramp:rate0=1400.0:rate1=4.0:duration=0.04",
        ladder=(1.0,),
        policies=("fifo",),
        controllers=("static", AUTO_SPEC),
        n_requests=36,
        seed=0,
        n_replicas=1,
        n_slots=2,
        slo="ttft_p95<=0.025,shed_rate<=0.5",
        prefix_cache_mb=0.5,
    )


def controller_checks(report, logs, report2, logs2,
                      tag: str = "selftest-controller") -> int:
    """The controller self-test's gates on a report, its control logs
    (``{(rung, label): text}``) and their rerun: strict validation after a
    JSON round trip, the ``policy+auto`` label, at least one replica
    scale-up and one scale-down, the autoscaled cell above the static one on
    deadline hit rate and below it on cost, every log line a
    ``mingpt-control/1`` row (one per tick) and byte-identical replay of
    both. Prints a line per gate; returns 0 when all hold."""
    from mingpt_distributed_tpu_torch.control.controller import CONTROL_SCHEMA
    from mingpt_distributed_tpu_torch.trafficlab import validate_traffic_report
    from mingpt_distributed_tpu_torch.trafficlab.report import dump_report

    rc = 0

    def check(ok: bool, what: str) -> None:
        nonlocal rc
        print(f"{tag} {'OK' if ok else 'FAIL'}: {what}")
        if not ok:
            rc = 1

    parsed = json.loads(dump_report(report))
    problems = validate_traffic_report(parsed, strict=False)
    check(not problems, f"report strict-parses (problems={problems})")
    check(parsed["policies"] == ["fifo", "fifo+auto"],
          f"cell labels carry the controller axis ({parsed['policies']})")
    rung = parsed["rungs"][0]
    static_cell = rung["policies"]["fifo"]
    auto_cell = rung["policies"]["fifo+auto"]
    control = auto_cell.get("control") or {}
    rep_actions = (control.get("actions") or {}).get("replicas", {})
    check(rep_actions.get("up", 0) >= 1,
          f"controller scaled up (replica actions={rep_actions})")
    check(rep_actions.get("down", 0) >= 1,
          f"controller scaled back down (replica actions={rep_actions})")
    s_hit, a_hit = (static_cell["deadline_hit_rate"],
                    auto_cell["deadline_hit_rate"])
    check(s_hit is not None and a_hit is not None and a_hit > s_hit,
          f"autoscaled beats static on deadline hit-rate "
          f"(auto={a_hit} static={s_hit})")
    s_cost, a_cost = static_cell["cost"]["cost"], auto_cell["cost"]["cost"]
    check(a_cost < s_cost,
          f"autoscaled cell is cheaper under the cost model "
          f"(auto={a_cost:.6g} static={s_cost:.6g})")
    rows = [json.loads(line)
            for line in logs.get((0, "fifo+auto"), "").splitlines()]
    check(bool(rows) and all(r.get("schema") == CONTROL_SCHEMA for r in rows),
          f"control log is valid {CONTROL_SCHEMA} JSONL ({len(rows)} rows)")
    check(control.get("ticks") == len(rows),
          f"cell ticks match log rows ({control.get('ticks')} vs {len(rows)})")
    check(dump_report(report) == dump_report(report2),
          "same-seed rerun report is byte-identical")
    check(logs == logs2, "same-seed rerun control log is byte-identical")
    return rc


def run_with_logs(params, cfg, spec, mix, server_kwargs):
    """``run_sweep`` plus its autoscaled cells' control logs, keyed by
    (rung, cell label)."""
    from mingpt_distributed_tpu_torch.trafficlab import run_sweep

    logs = {}
    report = run_sweep(params, cfg, spec, mix=mix, server_kwargs=server_kwargs,
                       control_log_sink=lambda r, lb, text: logs.__setitem__(
                           (r, lb), text))
    return report, logs


def selftest_controller(args) -> int:
    """Static and autoscaled cells replay the IDENTICAL down-ramp trace on
    the tiny random-init model, twice, through ``controller_checks``."""
    import torch

    from mingpt_distributed_tpu_torch.models import gpt
    from mingpt_distributed_tpu_torch.trafficlab import render_traffic_report

    dev = resolve_device(args.device)
    cfg = tiny_config()
    params = gpt.init(cfg, torch.Generator().manual_seed(0), device=dev)
    spec, mix, kw = selftest_controller_spec(), selftest_mix(), dict(device=dev)
    report, logs = run_with_logs(params, cfg, spec, mix, kw)
    print(render_traffic_report(report))
    report2, logs2 = run_with_logs(params, cfg, spec, mix, kw)
    rc = controller_checks(report, logs, report2, logs2)
    print("selftest-controller " + ("PASSED" if rc == 0 else "FAILED"))
    return rc


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.selftest_traffic:
        return selftest_traffic(args)
    if args.selftest_controller:
        return selftest_controller(args)

    import torch

    from mingpt_distributed_tpu_torch.config import load_config
    from mingpt_distributed_tpu_torch.models import gpt
    from mingpt_distributed_tpu_torch.trafficlab import (
        render_traffic_report,
        run_sweep,
    )
    from mingpt_distributed_tpu_torch.trafficlab.report import dump_report

    dev = resolve_device(args.device)
    spec = _sweep_spec(args)
    exp = load_config(args.config, args.overrides)
    gpt_cfg = dataclasses.replace(
        exp.gpt_config, embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0).resolved()
    if args.random_init:
        params = gpt.init(gpt_cfg, torch.Generator().manual_seed(0), device=dev)
        print(f"random-init model at {gpt_cfg.n_layer}L/{gpt_cfg.n_embd}d "
              f"(no checkpoint)", file=sys.stderr)
    else:
        from mingpt_distributed_tpu_torch.data.token_dataset import make_dataset
        from mingpt_distributed_tpu_torch.training import checkpoint as ckpt_lib

        dataset = make_dataset(exp.data_config)
        gpt_cfg = dataclasses.replace(
            gpt_cfg, vocab_size=dataset.vocab_size, block_size=dataset.block_size)
        path = exp.trainer_config.snapshot_path or ckpt_lib.DEFAULT_SNAPSHOT_PATH
        snap = ckpt_lib.restore_inference_params(path, gpt_cfg, dev)
        if snap is None:
            print(f"no snapshot at {path}; train first or pass --random-init",
                  file=sys.stderr)
            return 1
        params = snap.params
        print(f"loaded snapshot step {snap.step} from {path}", file=sys.stderr)

    report = run_sweep(params, gpt_cfg, spec, server_kwargs=dict(device=dev))
    print(render_traffic_report(report))
    if args.out is not None:
        with open(args.out, "w") as f:
            f.write(dump_report(report))
        print(f"mingpt-traffic/1 report written to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
