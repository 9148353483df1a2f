"""Summarise a torch.profiler trace: top ops by total duration, per lane.

Counterpart of ``tools/trace_summary.py``, with its functions, input kinds,
output lines and exit codes; what changes is the profile input.

Input: a directory of ``torch.profiler`` Chrome traces (``*.json`` and
``*.json.gz`` files with a top-level ``traceEvents``, such as the
trainer's ``profile_dir`` window ``trace_steps_<a>-<b>.json``, written by
``export_chrome_trace``), or one such file. Complete events
(``"ph": "X"``) are summed by name for each process/thread lane; flow,
instant, counter and metadata events carry no lane time and are skipped.
On a CUDA trace the device's ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
events sit on the device's process and stream, so the device is a lane of
its own beside the host threads, and its busy share of the span is the
device's busy share (record_function ranges drawn on the stream are a lane
apart).

Usage: python -m mingpt_distributed_tpu_torch.tools.trace_summary DIR [--top N]
       ... TRACE.json[.gz] [--top N]
       ... SPANS.jsonl [--top N]
       ... TRACE.jsonl [--slo [SPEC]]
       ... CONTROL.jsonl [--top N]
       ... ATTRIB.json
       ... --compare A.json B.json

A ``.json`` file argument is sorted by its content: a ``traceEvents``
document is a profile, one whose ``schema`` is ``mingpt-attrib/1`` an
attribution report; anything else is refused.

A ``.jsonl`` file argument is a telemetry span stream
(``mingpt-telemetry/1`` records with ``kind: "span"``, as written by
``TrainerConfig.spans_jsonl`` or ``SpanTracer.attach_jsonl``): spans are
converted to the same trace-event shape, one lane per span-name prefix
(``train``, ``serve``), and summarised by the same aggregation.

A ``.jsonl`` whose records carry the ``mingpt-trace/1`` schema (``serve
--trace-jsonl``) is a request-scoped trace stream: the file is
strict-validated and rendered as one timeline per request (queue wait,
prefix lookup, prefill chunks, decode rounds and the emitted-token window
in submit-relative time, with retry attempts flagged). ``--slo [SPEC]``
also grades the request summaries against named objectives (exact
quantiles, ``telemetry.slo``) and prints the attainment report.

A ``.jsonl`` whose records carry the ``mingpt-control/1`` schema (``serve
--control-log``, or a traffic-lab autoscaled cell) is an SLO-autoscaler
decision log: rendered as the per-actuator action table, the actuation
timeline in virtual time, and the grouped reason mix (values elided,
holds included).

A ``mingpt-attrib/1`` report (``serve --attrib-json``) is strict-validated
and rendered as the per-program-family table: operations and bytes, calls,
device seconds and MFU where the roofline peaks are known.

``--compare A.json B.json`` takes two ``mingpt-slo/1`` reports (``serve
--slo-json``) and prints a per-objective delta table: observed values,
deltas (negative = B better) and pass/fail transitions.

The busiest lanes come first; a lane's busy time is the union of its
events' intervals (nested events are not counted twice), so device idle
time shows as the gap between the device lane's busy total and the span.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re
import sys
from collections import defaultdict

from mingpt_distributed_tpu_torch import telemetry
from mingpt_distributed_tpu_torch.control import CONTROL_SCHEMA
from mingpt_distributed_tpu_torch.telemetry import TRACE_SCHEMA

PROFILE_SUFFIXES = (".json.gz", ".json")


def sniff_jsonl_schema(path: str):
    """The ``schema`` field of the first JSON record (None if the first
    line isn't JSON): how a request-trace stream is told apart from a
    plain span stream without reading the whole file."""
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                return None
            return rec.get("schema") if isinstance(rec, dict) else None
    return None


def summarize_requests(traces: dict) -> list[str]:
    """One timeline per request from a validated mingpt-trace/1 stream
    (``load_trace_jsonl`` output). Offsets are relative to the trace's
    submit timestamp; spans recorded by a skew-injected replica clock
    may land outside the fleet-clock window: that is the skew being
    visible, not a rendering bug."""
    out = [f"request traces: {len(traces)}"]
    order = sorted(traces.items(), key=lambda kv: kv[1]["request"]["ts"])
    for tid, t in order:
        r = t["request"]
        ttft = f"{r['ttft_s']:.4f}s" if r.get("ttft_s") is not None else "-"
        itl = (f"{r['itl_mean_s']:.4f}s"
               if r.get("itl_mean_s") is not None else "-")
        out.append(
            f"\n== {tid}: outcome={r['outcome']} tokens={r['n_tokens']} "
            f"attempts={r['attempts']} ttft={ttft} itl_mean={itl} "
            f"total={r['total_s']:.4f}s"
            + (" RETRIED" if r.get("retried") else ""))
        t0 = float(r["ts"])
        rows = []
        for s in t["spans"]:
            extra = "".join(
                f" {k}={s[k]}" for k in
                ("attempt", "replica", "pos", "tokens", "hit_rows", "lanes")
                if k in s)
            rows.append((
                float(s["ts"]),
                f"  +{float(s['ts']) - t0:9.4f}s {float(s['dur_s']):9.4f}s  "
                f"{s['name']}{extra}"))
        emits = [e for e in t["events"] if e.get("name") == "emit"]
        for e in t["events"]:
            if e.get("name") == "emit":
                continue
            flag = "RETRY " if e.get("name") == "retry" else ""
            extra = "".join(
                f" {k}={e[k]}" for k in
                ("reason", "attempt", "queue_depth", "shed_reason")
                if k in e)
            rows.append((
                float(e["ts"]),
                f"  +{float(e['ts']) - t0:9.4f}s          -  "
                f"{flag}{e['name']}{extra}"))
        if emits:
            first = min(float(e["ts"]) for e in emits)
            last = max(float(e["ts"]) for e in emits)
            rows.append((
                first,
                f"  +{first - t0:9.4f}s {last - first:9.4f}s  "
                f"emit x{len(emits)} (first..last token)"))
        rows.sort(key=lambda kv: kv[0])
        out.extend(line for _, line in rows)
    return out


def load_control_jsonl(path: str) -> list[dict]:
    """Strict-load a ``mingpt-control/1`` decision log (one JSON row
    per evaluated controller tick)."""
    rows = []
    with open(path) as f:
        for i, line in enumerate(f):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                raise ValueError(f"line {i + 1}: not JSON ({e})")
            if rec.get("schema") != CONTROL_SCHEMA:
                raise ValueError(
                    f"line {i + 1}: schema {rec.get('schema')!r}, "
                    f"want {CONTROL_SCHEMA!r}")
            missing = [k for k in ("tick", "now", "action", "reason")
                       if k not in rec]
            if missing:
                raise ValueError(f"line {i + 1}: missing keys {missing}")
            rows.append(rec)
    if not rows:
        raise ValueError(f"no {CONTROL_SCHEMA} rows in {path}")
    return rows


def _reason_key(reason: str) -> str:
    """Group controller reasons by shape: the observed values vary per
    tick, the comparison they triggered doesn't, so the numbers are
    elided and the mix table counts regimes, not floats."""
    return re.sub(r"-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?", "*",
                  reason.split(";", 1)[0].strip())


def summarize_control(rows: list[dict], top: int = 12) -> list[str]:
    """Render one autoscaler decision log: action table per actuator,
    the actuation timeline in virtual time, and the grouped reason
    mix (holds included: what the controller saw and declined on)."""
    t0, t1 = float(rows[0]["now"]), float(rows[-1]["now"])
    metric = rows[0].get("metric", "?")
    acted = [r for r in rows
             if r["action"].get("direction") != "hold"]
    out = [
        f"control log ({CONTROL_SCHEMA}): {len(rows)} ticks over "
        f"{t1 - t0:.3f}s, metric={metric}",
        f"actions: {len(acted)} (holds: {len(rows) - len(acted)})",
    ]
    counts: dict = defaultdict(lambda: defaultdict(int))
    for r in acted:
        counts[r["action"]["actuator"]][r["action"]["direction"]] += 1
    for actuator in sorted(counts):
        for direction in sorted(counts[actuator]):
            out.append(f"  {actuator:<16} {direction:<5} "
                       f"{counts[actuator][direction]:>4}")
    if acted:
        out.append("\ntimeline:")
        for r in acted:
            out.append(
                f"  tick {r['tick']:>4} +{float(r['now']) - t0:8.3f}s  "
                f"{r['action']['actuator']:<14} "
                f"{r['action']['direction']:<4} {r['reason']}")
    out.append("\nreason mix:")
    mix: dict = defaultdict(int)
    for r in rows:
        mix[_reason_key(r["reason"])] += 1
    ranked = sorted(mix.items(), key=lambda kv: kv[1], reverse=True)
    for key, n in ranked[:top]:
        out.append(f"  {n:>5}x  {key}")
    if len(ranked) > top:
        out.append(f"  (+{len(ranked) - top} more reason shapes)")
    return out


def _read_json(path: str):
    """One JSON document, gzip-compressed when the name ends in .gz."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def is_profile(doc) -> bool:
    """Whether a JSON document is a Chrome trace (a top-level
    ``traceEvents``), as ``export_chrome_trace`` writes one."""
    return isinstance(doc, dict) and "traceEvents" in doc


def merge_traces(docs: list) -> dict:
    """One trace of the ``(path, document)`` pairs' events. With several
    files each pid and each process name is namespaced by its file's name
    (less the suffix): every rank's process is named alike (``python``),
    so two profile windows or two ranks would otherwise share a lane."""
    merged: dict = {"traceEvents": []}
    for path, doc in docs:
        prefix = os.path.basename(path)
        for suffix in PROFILE_SUFFIXES:
            if prefix.endswith(suffix):
                prefix = prefix[:-len(suffix)]
                break
        for e in doc.get("traceEvents", []):
            if len(docs) > 1 and "pid" in e:
                e["pid"] = f"{prefix}:{e['pid']}"
                if e.get("ph") == "M" and e.get("name") == "process_name":
                    e["args"] = dict(e.get("args", {}),
                                     name=f"{prefix}:{e.get('args', {}).get('name', '')}")
            merged["traceEvents"].append(e)
    return merged


def load_trace(path: str) -> dict:
    """Merge every torch.profiler trace of a directory (several profile
    windows or ranks write one file each; summarising only one would hide
    the others' lanes), or load one such file. Files of the directory that
    are not traces are skipped."""
    if os.path.isfile(path):
        paths = [path]
    else:
        paths = sorted({p for suffix in PROFILE_SUFFIXES
                        for p in glob.glob(os.path.join(path, "*" + suffix))})
    docs = []
    for i, p in enumerate(paths):
        print(f"loading [{i + 1}/{len(paths)}] {p}", file=sys.stderr)
        try:
            doc = _read_json(p)
        except (OSError, ValueError, EOFError):
            continue
        if is_profile(doc):
            docs.append((p, doc))
    if not docs:
        raise FileNotFoundError(
            f"no torch.profiler trace under {path} (expected *.json or "
            "*.json.gz files with a top-level traceEvents)")
    return merge_traces(docs)


def load_span_jsonl(path: str) -> dict:
    """Telemetry span JSONL -> Chrome trace-event dict for summarize().

    Each ``kind: "span"`` record becomes a complete ("X") event; the lane
    (tid) is the span name's subsystem prefix (``train.step`` -> lane
    ``train``), so trainer and serving phases summarise as separate lanes
    the way device and host lanes do for profiler traces. Non-span records
    (point events, logs) carry no duration and are skipped."""
    events = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            if rec.get("kind") != "span":
                continue
            events.append({
                "ph": "X",
                "name": rec.get("name", "?"),
                "ts": float(rec.get("ts", 0.0)) * 1e6,     # s -> us
                "dur": float(rec.get("dur_s", 0.0)) * 1e6,
                "pid": "spans",
                "tid": str(rec.get("name", "?")).split(".", 1)[0],
            })
    if not events:
        raise FileNotFoundError(
            f"no span records (kind == \"span\") in {path}"
        )
    return {"traceEvents": events}


def lanes(trace: dict) -> tuple[dict, float, float]:
    """Each lane's ops and busy time, and the trace's first and last
    microsecond: ``{(process name, thread name): {"ops": {name: [total
    us, events]}, "busy_us": union of the lane's intervals}}``. Lane
    names come from the ``process_name`` and ``thread_name`` metadata
    events; only complete ("X") events count. torch.profiler's
    ``gpu_user_annotation`` events (record_function ranges, such as
    ``Optimizer.step#AdamW.step``, drawn on a device stream) go to a lane
    ``<stream> annotations`` beside their stream's."""
    events = trace.get("traceEvents", [])
    pids: dict = {}
    tids: dict = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pids[e["pid"]] = e["args"].get("name", str(e["pid"]))
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tids[(e["pid"], e.get("tid"))] = e["args"].get("name", "")

    ops: dict = defaultdict(dict)
    lane_spans: dict = defaultdict(list)
    t_min, t_max = float("inf"), 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        dur = float(e.get("dur", 0.0))  # microseconds
        ts = float(e.get("ts", 0.0))
        t_min = min(t_min, ts)
        t_max = max(t_max, ts + dur)
        key = (
            pids.get(e.get("pid"), str(e.get("pid"))),
            tids.get((e.get("pid"), e.get("tid")), str(e.get("tid"))),
        )
        if e.get("cat") == "gpu_user_annotation":
            # a record_function range drawn on the device's stream spans
            # the gaps between the kernels it encloses: a lane of its own,
            # so that the stream's busy time is its kernels' and copies'
            key = (key[0], f"{key[1]} annotations")
        row = ops[key].setdefault(e.get("name", "?"), [0.0, 0])
        row[0] += dur  # inclusive, like trace viewers
        row[1] += 1
        lane_spans[key].append((ts, ts + dur))

    # busy = UNION of the lane's intervals (events nest, e.g. an aten op
    # inside its caller, so a plain sum over-counts)
    out: dict = {}
    for key, spans in lane_spans.items():
        spans.sort()
        total, cur_s, cur_e = 0.0, None, None
        for s, e in spans:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        out[key] = {"ops": ops[key], "busy_us": total}
    return out, t_min, t_max


def summarize(trace: dict, top: int = 12) -> list[str]:
    table, t_min, t_max = lanes(trace)
    span_ms = (t_max - t_min) / 1e3 if t_max > t_min else 0.0
    out = [f"trace span: {span_ms:.2f} ms, lanes: {len(table)}"]
    # busiest lanes first: the device lane is what matters for MFU
    for key in sorted(table, key=lambda k: table[k]["busy_us"], reverse=True):
        pname, tname = key
        busy = table[key]["busy_us"]
        busy_ms = busy / 1e3
        out.append(
            f"\n== lane {pname} / {tname}: busy {busy_ms:.2f} ms"
            + (f" ({100 * busy_ms / span_ms:.0f}% of span)" if span_ms else "")
        )
        ops = sorted(((name, row[0]) for name, row in table[key]["ops"].items()),
                     key=lambda kv: kv[1], reverse=True)
        for name, dur in ops[:top]:
            pct = 100 * dur / busy if busy else 0
            out.append(f"  {dur / 1e3:9.2f} ms  {pct:5.1f}%  {name[:90]}")
        if len(ops) > top:
            rest = sum(d for _, d in ops[top:])
            out.append(f"  {rest / 1e3:9.2f} ms         (+{len(ops) - top} more)")
    return out


def _attrib(path: str, doc) -> int:
    """Render a mingpt-attrib/1 report; refuse any other document."""
    schema = doc.get("schema") if isinstance(doc, dict) else None
    if schema != telemetry.ATTRIB_SCHEMA:
        print(f"{path}: expected a {telemetry.ATTRIB_SCHEMA} "
              f"report, got schema={schema!r} (for mingpt-slo/1 "
              f"reports use --compare)", file=sys.stderr)
        return 1
    try:
        telemetry.validate_attrib_report(doc)
    except ValueError as e:
        print(f"invalid {telemetry.ATTRIB_SCHEMA} report: {e}",
              file=sys.stderr)
        return 1
    print(telemetry.render_attrib_report(doc))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("profile_dir", nargs="?", default=None,
                    help="a directory of torch.profiler traces or one trace "
                         "(.json, .json.gz), a telemetry span .jsonl, "
                         "a mingpt-trace/1 request-trace .jsonl, a "
                         "mingpt-control/1 autoscaler decision .jsonl, "
                         "or a mingpt-attrib/1 attribution report .json "
                         "(omitted with --compare)")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--compare", nargs=2, default=None,
                    metavar=("A.json", "B.json"),
                    help="diff two mingpt-slo/1 reports (serve "
                         "--slo-json output): per-objective observed "
                         "values, deltas and pass/fail transitions")
    ap.add_argument("--slo", nargs="?", const="default", default=None,
                    metavar="SPEC",
                    help="request-trace input only: grade the request "
                         "summaries against 'metric<=threshold' "
                         "objectives (default: the standard set) and "
                         "print the attainment report")
    args = ap.parse_args(argv)
    if args.compare is not None:
        reports = []
        for path in args.compare:
            try:
                with open(path) as f:
                    reports.append(json.load(f))
            except (OSError, ValueError) as e:
                print(f"cannot read SLO report {path}: {e}",
                      file=sys.stderr)
                return 1
        try:
            diff = telemetry.diff_slo_reports(reports[0], reports[1])
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
        print(telemetry.render_slo_diff(diff))
        return 0
    if args.profile_dir is None:
        ap.error("profile_dir is required unless --compare is given")
    path = args.profile_dir
    profile = None
    if os.path.isfile(path) and path.endswith(".json"):
        # a profile or a mingpt-attrib/1 report, told apart by content
        try:
            doc = _read_json(path)
        except (OSError, ValueError) as e:
            print(f"cannot read {path}: {e}", file=sys.stderr)
            return 1
        if not is_profile(doc):
            return _attrib(path, doc)
        profile = merge_traces([(path, doc)])
    span_input = os.path.isfile(path) and path.endswith(".jsonl")
    if span_input and sniff_jsonl_schema(path) == TRACE_SCHEMA:
        try:
            traces = telemetry.load_trace_jsonl(path)
        except ValueError as e:
            print(f"invalid {TRACE_SCHEMA} stream: {e}", file=sys.stderr)
            return 1
        print("\n".join(summarize_requests(traces)))
        if args.slo is not None:
            report = telemetry.evaluate_slos(
                [t["request"] for t in traces.values()],
                telemetry.parse_slo_spec(args.slo))
            print(telemetry.render_slo_report(report))
        return 0
    if span_input and sniff_jsonl_schema(path) == CONTROL_SCHEMA:
        try:
            rows = load_control_jsonl(path)
        except (OSError, ValueError) as e:
            print(f"invalid {CONTROL_SCHEMA} stream: {e}", file=sys.stderr)
            return 1
        print("\n".join(summarize_control(rows, args.top)))
        return 0
    if args.slo is not None:
        print("--slo needs a mingpt-trace/1 request-trace .jsonl input",
              file=sys.stderr)
        return 1
    if profile is None:
        try:
            profile = (load_span_jsonl(path) if span_input
                       else load_trace(path))
        except FileNotFoundError as e:
            print(str(e), file=sys.stderr)
            return 1
    print("\n".join(summarize(profile, args.top)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
