"""Continuous-batching inference server entry point of the port.

Counterpart of the repository's ``serve.py`` (its single-server branch):
where ``sample.py`` decodes one prompt per process, this drives the
``serving/`` package: a slot-based KV scheduler over the cached decode path
that admits new prompts mid-decode, streams tokens per request as they are
produced, and reports serving metrics (tokens/s, queue depth, slot
utilisation, TTFT, inter-token latency). Runs on CUDA unless ``--device
cpu``.

Modes:

  REPL (default)      read prompts from stdin one line at a time, stream
                      each completion as it decodes
  offline batch       drain a file of prompts (one per line) through the
                      scheduler concurrently, print the completions:
                        --prompts-file prompts.txt
  self-test           no weights needed: a random-init small model, three
                      canned prompts through 2 slots (forces queueing),
                      greedy outputs checked token-identical to solo
                      generate() and the shape counts bounded by the
                      bucket ladder: --selftest (with --metrics-port, its
                      own /metrics and /healthz scraped and parsed)
  spec self-test      speculative decoding token-identical to solo
                      generate() with an identical draft (accept rate 1)
                      and a 1-layer draft with chunks and prefix reuse,
                      one verify shape: --selftest-spec
  quant self-test     int8 (and fp8) KV pools with chunks, prefix reuse
                      and speculation against the fp32 pool: common greedy
                      prefix >= 0.9, equal shape counts, <= 0.27x the pool
                      bytes, power-of-two scales: --selftest-quant
  chaos self-test     3 supervised replicas on a virtual clock, replica0
                      crashed mid-decode and replica1 slowed by injected
                      faults: greedy parity with solo generate(), no
                      duplicate streamed token, the fleet's counters on a
                      strict-parsed /metrics scrape: --selftest-chaos
  process self-tests  real worker subprocesses behind mingpt-rpc/1:
                      kill -9 mid-decode, drain with live KV migration and
                      the chunked stream (--selftest-procfleet); cold
                      against warm-standby recovery, the SIGTERM->SIGKILL
                      hang ladder and draft rows riding a migration
                      (--selftest-standby); two host agents, a whole host
                      SIGKILLed, a paced migration under slow_link and a
                      tampered frame (--selftest-crosshost)

Fleet: ``--replicas N`` serves through N supervised replicas behind the
health/affinity router (``serving/fleet.py``): a crashed replica restarts
with a backoff and its requests retry idempotently on survivors;
``--shed-watermark D`` sheds new requests once the fleet-wide queue depth
reaches D; ``--chaos-spec`` (or ``MINGPT_SERVING_FAULTS``) injects
deterministic serving faults (crash, poison, slow, admit). With
``--isolation thread`` (the default) the replicas are in-process servers on
one device sharing one parameter tree; with ``--isolation process`` each is
a worker subprocess (``serving/procfleet``) that derives the same weights
from the snapshot (or ``--params``), SIGKILL-able and drained with exit 75,
with ``--standby N`` warm spares, ``--hang-deadline S`` for the liveness
ladder, ``--spill-dir`` for each worker's spec, stderr and flight dumps,
and process faults from ``MINGPT_PROCESS_FAULTS``. With
``--metrics-port``, /healthz carries each replica's breaker and health
reasons and /metrics the merged page (each replica's families under a
``replica`` label; a process fleet's pages fetched over RPC).

Autoscaling: ``--autoscale auto[:k=v...]`` (``control/controller.py``'s
grammar; ``--slo-target X`` is shorthand for ``auto:target=X``) hangs the
SLO autoscaler off the fleet router, under either isolation, and builds a
fleet even at ``--replicas 1``: it spawns replicas (a process fleet adopts a
warm ``--standby`` spare first), gates speculation, halves the prefill
chunk and lowers the shed watermark under breach, and restores them in
reverse, draining a replica before it retires (exit 75 for a worker
process). ``--control-log PATH`` appends each ``mingpt-control/1`` decision
row as it is made.

Speculative decoding: ``--draft-config self|self:N|k=v,...`` with
``--spec-k K``; the KV pool's storage: ``--kv-dtype fp32|int8|fp8``;
``--metrics-port P`` serves the process registry on ``/metrics`` and
``/healthz`` (0 binds an ephemeral port, printed at start).

The weights (REPL and batch) come from the snapshot the port's trainer
wrote at ``trainer_config.snapshot_path`` (``training/checkpoint.py``
``restore_inference_params``) or from ``--params FILE.npz`` (a JAX
parameter pytree flattened to ``"blocks/wq"``-style keys, as ``sample.py``
takes). The vocabulary is the corpus's by ``data_config.tokenizer`` (char
or bpe), as in training; ``section.key=value`` overrides as in ``train.py``.

Usage:
  python -m mingpt_distributed_tpu_torch.serve --selftest [--device cpu]
  python -m mingpt_distributed_tpu_torch.serve --selftest-spec [--device cpu]
  python -m mingpt_distributed_tpu_torch.serve --selftest-quant [--device cpu]
  python -m mingpt_distributed_tpu_torch.serve --selftest-attrib [--device cpu]
  python -m mingpt_distributed_tpu_torch.serve --selftest-chaos [--device cpu]
  python -m mingpt_distributed_tpu_torch.serve --selftest-procfleet [--device cpu]
  python -m mingpt_distributed_tpu_torch.serve --selftest-standby [--device cpu]
  python -m mingpt_distributed_tpu_torch.serve --selftest-crosshost [--device cpu] \\
      [--hosts N] [--fleet-secret S]
  python -m mingpt_distributed_tpu_torch.serve --selftest-sharded \\
      [--dist-backend gloo] [--device cpu]
  python -m mingpt_distributed_tpu_torch.serve --mesh tp=2 --dist-backend gloo \\
      --prompts-file p.txt [--greedy] [section.key=value ...]
  python -m mingpt_distributed_tpu_torch.serve --replicas 2 --prompts-file p.txt \\
      [--chaos-spec 'crash:nth=6:match=replica0'] [--shed-watermark 16] ...
  python -m mingpt_distributed_tpu_torch.serve --prompts-file prompts.txt \\
      [--config gpt2_config.yaml] [--slots 4] [--greedy] \\
      [--prefill-chunk 256] [--prefix-cache-mb 64] [--warmup] \\
      [trainer_config.snapshot_path=...] [section.key=value ...]

Telemetry: ``--trace-jsonl PATH`` exports request traces (mingpt-trace/1;
``--trace-sample P`` samples the happy path), ``--flight-dir DIR`` arms the
flight recorder (dumps on a post-warmup new shape and on a SIGTERM drain,
``/debug/flight`` on ``--metrics-port``), ``--slo [SPEC]`` and ``--slo-json
PATH`` grade SLOs from the traces at shutdown, ``--attrib-json PATH`` writes
the attribution report (``/attrib`` on ``--metrics-port``);
``--selftest-attrib`` is the attribution self-test.

Tensor parallelism: ``--mesh tp=N`` shards one model and its KV pool's
heads over N ranks (``serving/engine.py``, item 6). This process is the
driver, rank 0, and spawns N - 1 follower processes
(``serving/lockstep.TPGroup``) that run every engine call in lockstep with
it; ``--dist-backend nccl`` (the default) puts each rank on its own GPU,
``--dist-backend gloo`` lets the ranks share one card (or the CPU, with
``--device cpu``). A follower that fails makes the driver raise within
``parallel.mesh.TP_TIMEOUT_S`` (60 s); nothing falls back to tp = 1.
``--selftest-sharded`` is the tp = 2 against tp = 1 gate. With
``--replicas`` above 1 or ``--autoscale`` each replica is a tp server on a
lockstep group of its own: this process drives one group per replica the
fleet may hold (``--replicas``, or the autoscaler's ``max_replicas``), each
with its own tp - 1 followers, and a replica takes a group no live replica
holds (``TPMeshPool``). ``--mesh`` does not combine with ``--isolation
process``, whose workers are processes of their own.

SIGTERM (or one SIGINT) stops admission, drains in-flight requests, flushes
the metrics and exits 75 so a scheduler requeues the job; a second SIGINT
aborts. A JAX serve.py flag the port does not run yet would be parsed and
refused (exit 2), naming the ROADMAP.md Queue 1 item that brings it
(``UNPORTED_FLAGS``); none is left.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
from collections.abc import Mapping
from typing import Dict, List

import numpy as np

from mingpt_distributed_tpu_torch.config import GPTConfig, load_config
from mingpt_distributed_tpu_torch.data.token_dataset import make_dataset
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import generate as gen
from mingpt_distributed_tpu_torch.models import gpt
from mingpt_distributed_tpu_torch import telemetry
from mingpt_distributed_tpu_torch.serving import InferenceServer, Request
from mingpt_distributed_tpu_torch.serving import quant as quant_lib
from mingpt_distributed_tpu_torch.training import checkpoint as ckpt_lib
from mingpt_distributed_tpu_torch.training.metrics import MetricsLogger
from mingpt_distributed_tpu_torch.training.trainer import REQUEUE_EXIT_CODE
from mingpt_distributed_tpu_torch.utils.device import resolve_device

# the JAX serve.py's flags that the port does not run yet, each with the
# ROADMAP.md Queue 1 item that brings it (none left)
UNPORTED_FLAGS: dict = {}

SELFTEST_PROMPTS = ["O God, O God!", "Once more unto", "All the world's"]
SELFTEST_SHARED = ["Once more unto the breach", "Once more unto the wall!"]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="gpt2_config.yaml")
    p.add_argument("--params", default=None,
                   help="flat .npz of the JAX parameter pytree (default: the "
                        "trainer's snapshot at trainer_config.snapshot_path)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-new-tokens", type=int, default=200)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--greedy", action="store_true",
                   help="argmax decoding (default: sample)")
    p.add_argument("--eos-text", default=None,
                   help="stop a request when this (single-token) text is "
                        "produced")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prompts-file", default=None,
                   help="offline batch mode: one prompt per line")
    p.add_argument("--selftest", action="store_true",
                   help="random-init small model + canned prompts; checks "
                        "greedy parity with generate() and exits")
    p.add_argument("--metrics-json", default=None,
                   help="write the serving metrics summary JSON here")
    p.add_argument("--log-every", type=int, default=20,
                   help="scheduler steps between metric log lines (0 = off)")
    p.add_argument("--queue-limit", type=int, default=None,
                   help="bound the request queue; over-limit submissions "
                        "are rejected (backpressure)")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="per-request deadline in seconds; expired requests "
                        "free their KV slot (finish_reason=deadline)")
    p.add_argument("--prefill-buckets", default=None,
                   help="comma-separated ladder of prefill lengths "
                        "(default: powers of two from 64 up to block_size); "
                        "prompts pad to the smallest covering bucket")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="prefill long prompts in chunks of this many tokens "
                        "between decode steps (default: whole prompt)")
    p.add_argument("--prefix-cache-mb", type=float, default=0.0,
                   help="LRU budget (MiB) for shared-prefix KV reuse; 0 "
                        "disables the prefix store")
    p.add_argument("--warmup", action="store_true",
                   help="run the prefill ladder and the decode step once "
                        "before serving")
    p.add_argument("--kv-dtype", choices=("fp32", "int8", "fp8"), default="fp32",
                   help="KV-cache storage dtype: int8 or fp8 payloads with "
                        "fp32 power-of-two scale planes (~0.27x the fp32 "
                        "pool bytes at head_dim >= 64); fp32 is the plain "
                        "pool in the model's dtype")
    p.add_argument("--draft-config", default=None,
                   help="speculative decoding draft model: 'self' (the "
                        "target's weights), 'self:N' (its first N layers) "
                        "or comma-separated GPTConfig overrides such as "
                        "'n_layer=2,n_embd=64' (random init); needs "
                        "--spec-k >= 1")
    p.add_argument("--spec-k", type=int, default=0,
                   help="draft tokens proposed per verify round (0 = "
                        "speculation off)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve Prometheus /metrics and /healthz on this "
                        "port (0 = an ephemeral port, printed at start)")
    p.add_argument("--selftest-spec", action="store_true",
                   help="random-init small model: speculative decoding "
                        "token-identical to solo generate() (identical and "
                        "1-layer drafts, chunked prefill, prefix reuse), "
                        "one verify shape; exits non-zero on a mismatch")
    p.add_argument("--selftest-quant", action="store_true",
                   help="int8 and fp8 KV pools against the fp32 pool with "
                        "chunks, prefix reuse and speculation: greedy "
                        "prefix >= 0.9, equal shape counts, pool bytes <= "
                        "0.27x, power-of-two scales; then exits")
    p.add_argument("--trace-jsonl", default=None,
                   help="export request-scoped traces (mingpt-trace/1 JSONL: "
                        "spans, emit events, one request summary per trace) "
                        "to this path")
    p.add_argument("--trace-sample", type=float, default=1.0,
                   help="happy-path trace sampling probability in [0, 1]; "
                        "errors, sheds and retried requests always export")
    p.add_argument("--flight-dir", default=None,
                   help="arm the flight recorder: dump recent spans, events "
                        "and metrics here (mingpt-flight/1, atomic write + "
                        "manifest) on a post-warmup new shape and on a "
                        "SIGTERM drain; also serves GET /debug/flight on "
                        "--metrics-port")
    p.add_argument("--slo", nargs="?", const="default", default=None,
                   metavar="SPEC",
                   help="print a graded SLO report at shutdown from exact "
                        "per-request trace durations; SPEC is "
                        "'metric<=threshold' clauses (ttft_pNN, itl_pNN, "
                        "shed_rate, error_rate) joined by ','; bare --slo "
                        "uses the default objectives")
    p.add_argument("--slo-json", default=None, metavar="PATH",
                   help="write the shutdown SLO report (mingpt-slo/1) as "
                        "JSON to PATH; objectives from --slo, or the "
                        "defaults")
    p.add_argument("--attrib-json", default=None, metavar="PATH",
                   help="performance attribution: write the mingpt-attrib/1 "
                        "report (per-family operations, bytes, calls, device "
                        "seconds, roofline; HBM bytes by owner) to PATH at "
                        "shutdown; also serves GET /attrib on --metrics-port")
    p.add_argument("--selftest-attrib", action="store_true",
                   help="random-init small model served with attribution "
                        "and speculation: every family in a valid report "
                        "with its operations, the HBM owners equal to the "
                        "pools' bytes, two runs on a ticking clock "
                        "byte-identical, /attrib scraped; then exits")
    p.add_argument("--replicas", type=int, default=1,
                   help="serve through N supervised in-process replicas on "
                        "one device (sharing one parameter tree) behind the "
                        "health/affinity router (default 1: one server, no "
                        "fleet layer)")
    p.add_argument("--autoscale", default=None, metavar="SPEC",
                   help="attach the SLO autoscaler to the fleet router: "
                        "'auto[:k=v...]' (control/controller.py grammar), "
                        "e.g. auto:metric=ttft_p99:target=0.05:"
                        "max_replicas=4; implies the fleet path even at "
                        "--replicas 1")
    p.add_argument("--slo-target", type=float, default=None, metavar="X",
                   help="shorthand for --autoscale auto:target=X (TTFT "
                        "p99 seconds the controller defends)")
    p.add_argument("--control-log", default=None, metavar="PATH",
                   help="append each mingpt-control/1 autoscaler "
                        "decision row to this JSONL file as it is made")
    p.add_argument("--isolation", choices=("thread", "process"), default="thread",
                   help="fleet replica isolation: 'thread' (in-process "
                        "replicas sharing one parameter tree, the default); "
                        "'process' = each replica a spawned worker "
                        "subprocess behind the mingpt-rpc/1 socket surface, "
                        "SIGKILL-able and drained with exit 75")
    p.add_argument("--spill-dir", default=None,
                   help="process isolation: root directory of each worker's "
                        "spill state (spec.json, stderr.log, flight dumps "
                        "collected when the process dies); default: a temp "
                        "directory")
    p.add_argument("--standby", type=int, default=0, metavar="N",
                   help="process isolation: keep N warm spare workers; a "
                        "crashed replica adopts a spare instead of a cold "
                        "respawn, and the pool backfills afterwards "
                        "(default 0: cold respawns only)")
    p.add_argument("--hang-deadline", type=float, default=None, metavar="SECONDS",
                   help="process isolation: arm the liveness ladder: a "
                        "replica holding work that completes no round for "
                        "this long gets SIGTERM, then SIGKILL after a grace "
                        "window if it ignored the term; default: no ladder")
    p.add_argument("--hosts", type=int, default=1, metavar="N",
                   help="roster size of the cross-host drill "
                        "(--selftest-crosshost; at least 2)")
    p.add_argument("--fleet-secret", default=None, metavar="SECRET",
                   help="shared fleet secret of the cross-host drill: every "
                        "control envelope HMAC-signed over its canonical "
                        "bytes (default: a fixed drill secret)")
    p.add_argument("--selftest-procfleet", action="store_true",
                   help="2 real replica subprocesses behind mingpt-rpc/1: "
                        "kill -9 one mid-decode (greedy parity, no duplicate "
                        "or lost token, exit -9 reaped, spill collected), "
                        "drain with live migration (streams bit-identical, "
                        "exit 75, traces spanning both replicas), the "
                        "chunked stream endpoint; then exits")
    p.add_argument("--selftest-standby", action="store_true",
                   help="real replica subprocesses: kill -9 under a warm "
                        "spare recovers strictly faster than a cold respawn; "
                        "a wedged worker is cleared by SIGTERM then SIGKILL; "
                        "draft rows ride a migration; then exits")
    p.add_argument("--selftest-crosshost", action="store_true",
                   help="two (or --hosts) localhost host agents, each with "
                        "real replica subprocesses: a whole host SIGKILLed "
                        "mid-decode (streams exact on the peer), a paced "
                        "migration under slow_link (wall time >= the "
                        "bandwidth budget), a tampered frame rejected as "
                        "BadSignature; then exits")
    p.add_argument("--shed-watermark", type=int, default=None,
                   help="fleet mode: shed new requests once the fleet-wide "
                        "queue depth reaches this watermark")
    p.add_argument("--chaos-spec", default=None,
                   help="deterministic serving fault spec, e.g. "
                        "'crash:nth=6:match=replica0;slow:every=1:"
                        "delay=0.25:match=replica1' (default: the "
                        "MINGPT_SERVING_FAULTS environment variable; ops "
                        "crash|poison|slow|admit)")
    p.add_argument("--selftest-chaos", action="store_true",
                   help="random-init small model through 3 replicas on a "
                        "virtual clock under an injected crash and a slow "
                        "replica: greedy parity with solo generate(), no "
                        "duplicate streamed token, the fleet's counters on a "
                        "strict-parsed /metrics and /healthz; then exits")
    p.add_argument("--mesh", default=None, metavar="tp=N",
                   help="tensor-parallel serving: shard the model and the KV "
                        "pool's heads over N ranks, this process driving N - 1 "
                        "follower processes")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="the tp group's backend: nccl (the default), one rank "
                        "per GPU; gloo, the ranks share the device (one card, or "
                        "the CPU). The self-tests default to gloo on the CPU "
                        "and on one card")
    p.add_argument("--selftest-sharded", action="store_true",
                   help="random-init small model served at tp = 2 and tp = 1: "
                        "identical greedy tokens and shape counts, a "
                        "head-sharded pool and prefix store; then exits")
    for flag in UNPORTED_FLAGS:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    p.add_argument("overrides", nargs="*")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """The arguments; exits 2 naming the ROADMAP.md item of any unported
    flag given."""
    p = build_argparser()
    args = p.parse_args(argv)
    for flag, item in UNPORTED_FLAGS.items():
        value = getattr(args, flag[2:].replace("-", "_"))
        if value is None:
            continue
        p.error(f"{flag} is not ported yet (ROADMAP.md Queue 1 item {item})")
    if args.replicas < 1:
        p.error(f"--replicas must be >= 1, got {args.replicas}")
    return args


def _parse_buckets(spec):
    if spec is None:
        return None
    try:
        return tuple(int(b) for b in str(spec).split(",") if b.strip())
    except ValueError:
        raise SystemExit(f"--prefill-buckets must be comma-separated ints, "
                         f"got {spec!r}")


def _server_kwargs(args) -> dict:
    """The prefill knobs and the KV dtype, shared by every server
    construction."""
    return dict(prefill_buckets=_parse_buckets(args.prefill_buckets),
                prefill_chunk=args.prefill_chunk,
                prefix_cache_mb=args.prefix_cache_mb, warmup=args.warmup,
                kv_dtype=args.kv_dtype)


def _mesh_tp(args) -> int:
    """--mesh 'axis=N,...' resolved to the tp extent (1 without the flag).
    Serving shards over tp only: another axis above 1 exits, as does a
    malformed clause (the JAX serve.py's ``_mesh_kwargs`` grammar)."""
    if args.mesh is None:
        return 1
    from mingpt_distributed_tpu_torch.parallel.mesh import AXES

    sizes = {}
    for clause in str(args.mesh).split(","):
        k, sep, v = clause.partition("=")
        k = k.strip()
        if not sep or k not in AXES:
            raise SystemExit(f"--mesh clause {clause!r} is not axis=N "
                             f"(axes: {', '.join(AXES)})")
        try:
            sizes[k] = int(v)
        except ValueError:
            raise SystemExit(f"--mesh {k}={v!r}: extent must be an int")
    others = {k: n for k, n in sizes.items() if k != "tp" and n != 1}
    if others:
        raise SystemExit(f"--mesh {args.mesh!r}: serving shards one replica "
                         f"over tp only, not {others}")
    tp = sizes.get("tp", 1)
    if tp < 1:
        raise SystemExit(f"--mesh tp={tp}: the extent must be >= 1")
    return tp


def tp_group(n: int, args, dev, selftest: bool = False, replicas: int = 1):
    """``replicas`` tp = ``n`` serving groups driven by this process
    (``TPGroup``), on ``--dist-backend`` (nccl by default; a self-test's
    default is gloo where nccl cannot run, on the CPU or one card); its
    ``close()`` releases the followers."""
    import torch

    from mingpt_distributed_tpu_torch.parallel.mesh import TP_TIMEOUT_S
    from mingpt_distributed_tpu_torch.serving.lockstep import TPGroup

    backend = args.dist_backend
    if backend is None:
        shared = dev.type == "cpu" or torch.cuda.device_count() < n
        backend = "gloo" if selftest and shared else "nccl"
    return TPGroup(n, backend, dev, TP_TIMEOUT_S, replicas=replicas)


class TPMeshPool(Mapping):
    """{replica name: serving mesh} for ``default_server_factory(meshes=)``
    over a fixed set of tp groups: a replica keeps the group it first took
    (a respawn rebuilds the same followers), and a new one takes a group
    that no live replica holds. The supervisor's replica indices never
    recycle, so after a scale-down the next scale-up reuses the drained
    replica's group. ``live`` gives the names of the replicas still
    serving (all that took a group, until the supervisor is set)."""

    def __init__(self, meshes):
        self.meshes = list(meshes)
        self.owner: Dict[str, int] = {}
        self.live = lambda: set(self.owner)

    def __getitem__(self, name: str):
        if name not in self.owner:
            held = {self.owner[n] for n in self.live() if n in self.owner}
            free = [i for i in range(len(self.meshes)) if i not in held]
            if not free:
                raise KeyError(f"{name}: every one of the {len(self.meshes)} tp "
                               "groups serves a live replica")
            self.owner[name] = free[0]
        return self.meshes[self.owner[name]]

    def __contains__(self, name) -> bool:
        return isinstance(name, str) and name.startswith("replica")

    def __iter__(self):
        return iter(self.owner)

    def __len__(self) -> int:
        return len(self.owner)


def first_layers(params, n: int):
    """The first ``n`` layers of a parameter tree (blocks are stacked on a
    leading layer axis), sharing the embeddings and the head."""
    out = dict(params)
    out["blocks"] = {k: v[:n] for k, v in params["blocks"].items()}
    return out


def draft_from(spec: str, params, cfg: GPTConfig, dev):
    """``--draft-config`` -> (draft params, draft config): 'self' shares
    the target's weights (accept rate 1.0), 'self:N' takes its first N
    layers, 'k=v,...' a random-init config off the target's dims."""
    if spec == "self":
        return params, cfg
    if spec.startswith("self:"):
        try:
            n = int(spec.split(":", 1)[1])
        except ValueError:
            raise SystemExit(f"--draft-config self:N needs an int, got {spec!r}")
        if not 1 <= n <= cfg.n_layer:
            raise SystemExit(f"--draft-config {spec!r}: N outside [1, {cfg.n_layer}]")
        return first_layers(params, n), dataclasses.replace(cfg, n_layer=n)
    overrides = {}
    for clause in spec.split(","):
        k, sep, v = clause.partition("=")
        if not sep or not k.strip():
            raise SystemExit(f"--draft-config clause {clause!r} is not k=v "
                             f"(or 'self' / 'self:N')")
        for cast in (int, float, str.strip):
            try:
                overrides[k.strip()] = cast(v)
                break
            except ValueError:
                continue
    try:
        dcfg = dataclasses.replace(cfg, **overrides).resolved()
        dcfg.validate()
    except Exception as e:
        raise SystemExit(f"--draft-config {spec!r}: {e}")
    import torch

    return gpt.init(dcfg, torch.Generator().manual_seed(1), device=dev), dcfg


def _spec_kwargs(args, params, cfg, dev) -> dict:
    """Speculative-decoding kwargs for InferenceServer (empty = off);
    --draft-config and --spec-k go together."""
    if args.spec_k <= 0 and args.draft_config is None:
        return {}
    if args.spec_k <= 0 or args.draft_config is None:
        raise SystemExit("--draft-config and --spec-k (>= 1) must be given together")
    dparams, dcfg = draft_from(args.draft_config, params, cfg, dev)
    return dict(draft_params=dparams, draft_cfg=dcfg, spec_k=args.spec_k)


def _start_telemetry(args, reg):
    """With --metrics-port, a TelemetryServer over ``reg`` (its /metrics and
    /healthz); else None."""
    if args.metrics_port is None:
        return None
    tserver = telemetry.TelemetryServer(reg, port=args.metrics_port)
    print(f"[serve] telemetry: /metrics and /healthz on {tserver.url('')}",
          file=sys.stderr)
    return tserver


def _selftest_scrape(tserver) -> int:
    """Scrape our own /healthz and /metrics over HTTP and hold the page to
    the strict exposition parser: the serving latency histograms, the
    utilisation and prefix gauges and the trainer's gauge families."""
    import urllib.request

    rc = 0
    with urllib.request.urlopen(tserver.url("/healthz"), timeout=10) as resp:
        health = json.loads(resp.read().decode())
    if health.get("status") != "ok":
        print(f"selftest FAIL: /healthz says {health}")
        rc = 1
    with urllib.request.urlopen(tserver.url("/metrics"), timeout=10) as resp:
        text = resp.read().decode()
    try:
        parsed = telemetry.parse_prometheus(text)
    except ValueError as e:
        print(f"selftest FAIL: /metrics is not valid exposition text: {e}")
        return 1
    required = {
        "mingpt_serve_ttft_seconds": "histogram",
        "mingpt_serve_itl_seconds": "histogram",
        "mingpt_serve_slot_utilization": "gauge",
        "mingpt_serve_prefix_hit_rate": "gauge",
        "mingpt_serve_kv_dtype": "gauge",
        "mingpt_train_loss": "gauge",
        "mingpt_train_mfu": "gauge",
    }
    for name, kind in required.items():
        got = parsed["types"].get(name)
        if got != kind:
            print(f"selftest FAIL: /metrics lacks {kind} {name} (got {got})")
            rc = 1
    print(f"selftest scrape: {len(parsed['samples'])} samples")
    return rc


def _make_observability(args, reg):
    """(TraceRecorder or None, FlightRecorder or None) from the tracing
    flags. The flight recorder samples the process registry and the span
    tracer's ring at dump time; the trace recorder mirrors every record
    into the flight ring. --slo needs the per-request summaries, so it
    makes a recorder even without an export path."""
    flight = None
    if args.flight_dir is not None:
        flight = telemetry.FlightRecorder(out_dir=args.flight_dir, registry=reg)
        flight.source_providers["tracer"] = telemetry.get_tracer().records
        flight.metrics_providers["process"] = lambda: telemetry.render_prometheus(reg)
    recorder = None
    if (args.trace_jsonl is not None or args.slo is not None
            or args.slo_json is not None or flight is not None):
        if not 0.0 <= args.trace_sample <= 1.0:
            raise SystemExit(f"--trace-sample must be in [0, 1], got {args.trace_sample}")
        sink = (telemetry.trace_sink(args.trace_jsonl)
                if args.trace_jsonl is not None else None)
        recorder = telemetry.TraceRecorder(sink=sink, sample=args.trace_sample,
                                           registry=reg, flight=flight)
    return recorder, flight


def _slo_report(args, recorder):
    """Grade the SLO objectives over the recorder's finished requests:
    print the report with --slo, write it as sorted-key JSON with
    --slo-json. Returns the report (None when neither flag is set)."""
    if (args.slo is None and args.slo_json is None) or recorder is None:
        return None
    report = telemetry.evaluate_slos(recorder.completed_requests(),
                                     telemetry.parse_slo_spec(args.slo or "default"))
    if args.slo is not None:
        print(telemetry.render_slo_report(report))
    if args.slo_json is not None:
        with open(args.slo_json, "w") as f:
            f.write(json.dumps(report, sort_keys=True, indent=2) + "\n")
        print(f"[serve] SLO report (mingpt-slo/1) written to {args.slo_json}",
              file=sys.stderr)
    return report


def _request_for(args, tokens, eos_id=None) -> Request:
    return Request(prompt=[int(t) for t in tokens],
                   max_new_tokens=args.max_new_tokens,
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p, do_sample=not args.greedy, eos_id=eos_id,
                   seed=args.seed, deadline_s=args.deadline_s)


class _ShutdownGuard:
    """SIGTERM/SIGINT → stop admission, drain, flush, exit 75 (the
    trainer's preemption contract). The first signal only sets the flag;
    a second SIGINT raises KeyboardInterrupt for a hard abort."""

    def __init__(self):
        self.stop_requested = False
        self._previous = {}

    def install(self) -> "_ShutdownGuard":
        def handler(signum, frame):
            if self.stop_requested and signum == signal.SIGINT:
                raise KeyboardInterrupt
            self.stop_requested = True
            print(f"[serve] caught signal {signum}: admission stopped, "
                  f"draining in-flight requests (SIGINT again to abort)",
                  file=sys.stderr, flush=True)

        for sig in (signal.SIGTERM, signal.SIGINT):
            self._previous[sig] = signal.signal(sig, handler)
        return self

    def restore(self) -> None:
        """Put back the handlers ``install`` replaced."""
        for sig, previous in self._previous.items():
            signal.signal(sig, previous)


def selftest(args) -> int:
    """Canned prompts through a random-init small model on 2 slots: greedy
    server output must be token-identical to solo generate(), with the
    shape family bounded by the bucket ladder (and, with
    --prefix-cache-mb, a prefix-store hit)."""
    import torch

    dev = resolve_device(args.device)
    cfg = GPTConfig.make(
        n_layer=2, n_head=2, n_embd=32, vocab_size=96, block_size=48,
        embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
    params = gpt.init(cfg, torch.Generator().manual_seed(0), device=dev)
    canned = list(SELFTEST_PROMPTS)
    if args.prefix_cache_mb > 0:
        # two prompts sharing a long head: the second must hit the store
        canned += SELFTEST_SHARED
    prompts = [[ord(c) % cfg.vocab_size for c in s] for s in canned]
    max_new = 12
    # one registry for the page: the serving instruments and the trainer's
    # gauge families (a silent MetricsLogger registers mingpt_train_*)
    reg = telemetry.MetricsRegistry()
    tserver = _start_telemetry(args, reg)
    MetricsLogger(cfg, enabled=False, registry=reg)
    server = InferenceServer(params, cfg, n_slots=2, log_every=args.log_every,
                             registry=reg, device=dev, **_server_kwargs(args))
    handles = server.generate_batch(
        [Request(prompt=p, max_new_tokens=max_new) for p in prompts])

    rc = 0
    for text, p, h in zip(canned, prompts, handles):
        want = gen.generate(params, cfg, [p], max_new,
                            device=dev)[0, len(p):].tolist()
        ok = h.tokens == want
        print(f"selftest {h.request_id} ({text!r}): "
              + ("OK" if ok else f"MISMATCH server={h.tokens} solo={want}"))
        rc |= not ok
    counts = server.compile_counts()
    ladder = len(server.engine.buckets)
    if counts["decode"] != 1 or counts["prefill"] > ladder:
        print(f"selftest FAIL: unbounded shapes: {counts} (ladder size "
              f"{ladder})")
        rc = 1
    if args.prefix_cache_mb > 0 and server.metrics.prefix_hits < 1:
        print("selftest FAIL: prefix store enabled but no hit recorded")
        rc = 1
    if tserver is not None:
        rc |= _selftest_scrape(tserver)
        tserver.close()
    summary = server.summary()
    print("selftest shapes:", json.dumps(counts))
    print("selftest metrics:", json.dumps(summary))
    if args.metrics_json:
        server.metrics.write_json(args.metrics_json)
    if summary["requests_completed"] != len(canned):
        print("selftest FAIL: not all requests completed")
        rc = 1
    print("selftest", "PASSED" if rc == 0 else "FAILED")
    return int(rc)


SPEC_CANNED = SELFTEST_PROMPTS + SELFTEST_SHARED


def _selftest_variant(tag, run) -> int:
    """Run one variant of a self-test; an exception fails it (printed)."""
    try:
        return run()
    except Exception as e:  # a planted or real fault must fail, not crash
        print(f"{tag} FAIL: {type(e).__name__}: {e}")
        return 1


def selftest_spec(args) -> int:
    """Speculative decoding must be token-identical to solo greedy
    generate(), with one verify shape for the server's lifetime. Two
    variants: an identical draft (every proposal accepted: accept rate
    exactly 1.0, k+1 tokens per verify, the backfill row), and the
    target's first layer as draft with 6-token chunks, a multi-bucket
    ladder and a prefix-store hit (real rejections roll back on both
    engines)."""
    import torch

    dev = resolve_device(args.device)
    cfg = GPTConfig.make(
        n_layer=2, n_head=2, n_embd=32, vocab_size=96, block_size=48,
        embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
    params = gpt.init(cfg, torch.Generator().manual_seed(0), device=dev)
    k = args.spec_k if args.spec_k > 0 else 3
    max_new = 12

    def check_parity(tag, canned, prompts, handles) -> int:
        bad = 0
        for text, p, h in zip(canned, prompts, handles):
            want = gen.generate(params, cfg, [p], max_new,
                                device=dev)[0, len(p):].tolist()
            ok = h.tokens == want
            print(f"selftest-spec [{tag}] {h.request_id} ({text!r}): "
                  + ("OK" if ok else f"MISMATCH spec={h.tokens} solo={want}"))
            bad |= not ok
        return int(bad)

    def identical() -> int:
        canned = SELFTEST_PROMPTS
        prompts = [[ord(c) % cfg.vocab_size for c in s] for s in canned]
        srv = InferenceServer(params, cfg, n_slots=2, warmup=True, device=dev,
                              kv_dtype=args.kv_dtype, draft_params=params,
                              draft_cfg=cfg, spec_k=k)
        handles = srv.generate_batch(
            [Request(prompt=p, max_new_tokens=max_new) for p in prompts])
        rc = check_parity("self", canned, prompts, handles)
        m = srv.metrics
        if m.spec_accept_rate != 1.0:
            print(f"selftest-spec FAIL: identical draft accept rate "
                  f"{m.spec_accept_rate} != 1.0")
            rc = 1
        if m.spec_tokens_per_verify_mean != k + 1:
            print(f"selftest-spec FAIL: identical draft emitted "
                  f"{m.spec_tokens_per_verify_mean} tokens/verify, want {k + 1}")
            rc = 1
        counts = srv.compile_counts()
        if counts["verify"] != 1 or counts["draft_decode"] != 1:
            print(f"selftest-spec FAIL: unbounded speculation shapes: {counts}")
            rc = 1
        print(f"selftest-spec [self] accept {m.spec_accepted}/{m.spec_proposed}, "
              f"tokens/verify {m.spec_tokens_per_verify_mean:.3g}, counts {counts}")
        return rc

    def truncated() -> int:
        canned = SPEC_CANNED
        prompts = [[ord(c) % cfg.vocab_size for c in s] for s in canned]
        srv = InferenceServer(
            params, cfg, n_slots=2, warmup=True, device=dev,
            kv_dtype=args.kv_dtype, prefill_chunk=6,
            prefill_buckets=(4, 6, 8, 16, 32, 48), prefix_cache_mb=4.0,
            draft_params=first_layers(params, 1),
            draft_cfg=dataclasses.replace(cfg, n_layer=1), spec_k=k)
        handles = srv.generate_batch(
            [Request(prompt=p, max_new_tokens=max_new) for p in prompts])
        rc = check_parity("self:1+chunk+prefix", canned, prompts, handles)
        m, counts = srv.metrics, srv.compile_counts()
        ladder = len(srv.engine.buckets)
        if counts["verify"] != 1:
            print(f"selftest-spec FAIL: verify family grew: {counts}")
            rc = 1
        if counts["prefill"] > ladder or counts["draft_prefill"] > ladder:
            print(f"selftest-spec FAIL: prefill families exceed the "
                  f"{ladder}-bucket ladder: {counts}")
            rc = 1
        if m.prefix_hits < 1:
            print("selftest-spec FAIL: prefix store enabled but no hit")
            rc = 1
        if m.spec_rounds < 1:
            print("selftest-spec FAIL: no verify rounds ran")
            rc = 1
        print(f"selftest-spec [self:1+chunk+prefix] accept "
              f"{m.spec_accepted}/{m.spec_proposed}, prefix_hits "
              f"{m.prefix_hits}, counts {counts}")
        print("selftest-spec metrics:", json.dumps(srv.summary()))
        return rc

    rc = _selftest_variant("selftest-spec [self]", identical)
    rc |= _selftest_variant("selftest-spec [self:1+chunk+prefix]", truncated)
    print("selftest-spec", "PASSED" if rc == 0 else "FAILED")
    return rc


def common_prefix(a, b) -> int:
    """Length of the common prefix of two token lists."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


# a quantized pool's greedy stream may leave the fp32 stream only at a
# near-tie: where the fp32 top-2 logit gap is at most QUANT_TIE_X times the
# KV round trip's own logit error at that context
QUANT_TIE_X = 3.0


def quant_divergences(params, cfg, prompts, ref, got, q):
    """Each request's first divergence between the fp32 pool's greedy tokens
    ``ref`` and a quantized pool's ``got``: its step, the fp32 top-2 logit
    gap there (a solo fp32 forward of the prompt and the common tokens),
    the KV round trip's logit error at that context
    (``quant.max_abs_logit_error``) and whether the gap is a near-tie
    (<= QUANT_TIE_X x the error). Requests that agree to the end are
    absent."""
    import torch

    out = []
    dev = params["wte"].device
    for i, (p, a, b) in enumerate(zip(prompts, ref, got)):
        d = common_prefix(a, b)
        if d == len(a) == len(b):
            continue
        ctx = list(p) + list(a[:d])
        with torch.no_grad():
            logits = gen._forward_cached(
                params, torch.tensor([ctx], device=dev),
                gen.init_cache(cfg, 1, dev), 0, cfg)[0]
        top2 = logits.topk(2).values
        gap = float(top2[0] - top2[1])
        err = quant_lib.max_abs_logit_error(params, cfg, ctx, q)
        out.append({"request": i, "step": d, "fp32": a[d] if d < len(a) else None,
                    "quant": b[d] if d < len(b) else None, "top2_gap": gap,
                    "logit_err": err, "tie": gap <= QUANT_TIE_X * err})
    return out


def pool_bytes(cache) -> int:
    return sum(int(a.nbytes) for a in cache.values())


def pow2_or_zero(scales) -> bool:
    """Whether every scale of the planes is an exact power of two or 0."""
    import torch

    return all(bool(((torch.frexp(s).mantissa == 0.5) | (s == 0)).all())
               for s in scales.values())


def selftest_quant(args) -> int:
    """An int8 (and, where torch has float8_e4m3fn, an fp8) KV pool with
    chunked prefill, the prefix store and speculation composed must track
    the fp32 server within tolerance at ~0.27x the pool bytes.

    The scale planes cost 4 bytes per (row, kv head) against head_dim
    payload bytes, so the 0.27 ratio needs head_dim >= 64: this runs
    n_embd=256, n_head=4. Checks: each request's greedy tokens equal the
    fp32 server's, or leave them only at a near-tie
    (``quant_divergences``: the JAX package's gate, a common prefix of
    >= 0.9 of the tokens, is printed beside it, but at random init it
    rides on where the near-ties fall); compile_counts() equal for every
    dtype; payload +
    scale bytes <= 0.27x the fp32 pool's, the scale planes exactly
    ``quant.scale_bytes``; every stored scale a power of two (or 0) and a
    dequantize/quantize round trip of the int8 pool bit-identical; the
    ``mingpt_serve_kv_dtype`` gauge and a sampled
    ``mingpt_serve_quant_logit_err_max``."""
    import torch

    dev = resolve_device(args.device)
    cfg = GPTConfig.make(
        n_layer=2, n_head=4, n_embd=256, vocab_size=96, block_size=48,
        embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
    params = gpt.init(cfg, torch.Generator().manual_seed(0), device=dev)
    prompts = [[ord(c) % cfg.vocab_size for c in s] for s in SPEC_CANNED]
    max_new = 12

    def run_once(kv_dtype):
        reg = telemetry.MetricsRegistry()
        srv = InferenceServer(
            params, cfg, n_slots=2, registry=reg, device=dev,
            prefill_buckets=(8, 48), prefill_chunk=6, prefix_cache_mb=0.5,
            warmup=True, draft_params=params, draft_cfg=cfg, spec_k=2,
            kv_dtype=kv_dtype, attrib=True)
        handles = srv.generate_batch(
            [Request(prompt=p, max_new_tokens=max_new) for p in prompts])
        return srv, reg, [h.tokens for h in handles]

    srv32, _, toks32 = run_once("fp32")
    c32 = srv32.compile_counts()
    bytes32 = srv32.attrib_report()["hbm"]["owners"]["kv_pool"]
    dtypes = ["int8"] + (["fp8"] if quant_lib.fp8_dtype() is not None else [])

    def check(kv_dtype) -> int:
        srv, reg, toks = run_once(kv_dtype)
        rc = 0
        q = quant_lib.resolve_kv_dtype(kv_dtype)
        div = {d["request"]: d for d in quant_divergences(
            params, cfg, prompts, toks32, toks, q)}
        for i, (text, a, b) in enumerate(zip(SPEC_CANNED, toks32, toks)):
            d = div.get(i)
            print(f"selftest-quant [{kv_dtype}] ({text!r}): " + (
                "OK" if d is None else
                f"prefix {d['step']}/{len(a)} at a top-2 gap of "
                f"{d['top2_gap']:.3g} (logit error {d['logit_err']:.3g}: "
                f"{'a near-tie' if d['tie'] else 'NOT a near-tie'}) "
                f"fp32={a} {kv_dtype}={b}"))
        agree = sum(common_prefix(a, b) for a, b in zip(toks32, toks))
        total = sum(len(a) for a in toks32)
        if not all(d["tie"] for d in div.values()):
            print(f"selftest-quant FAIL: {kv_dtype} tokens leave the fp32 "
                  f"stream where the fp32 top-2 gap exceeds {QUANT_TIE_X} x "
                  f"the quantization's logit error")
            rc = 1
        print(f"selftest-quant [{kv_dtype}] common greedy prefix {agree}/{total}")
        counts = srv.compile_counts()
        if counts != c32:
            print(f"selftest-quant FAIL: compile_counts diverge by dtype: "
                  f"fp32={c32} {kv_dtype}={counts}")
            rc = 1
        if srv.metrics.prefix_hits < 1 or srv.metrics.spec_rounds < 1:
            print(f"selftest-quant FAIL: {kv_dtype} prefix hits "
                  f"{srv.metrics.prefix_hits}, spec rounds "
                  f"{srv.metrics.spec_rounds} (want >= 1 each)")
            rc = 1
        # the pool's bytes as the HBM ledger accounts them, held against
        # the tensors it holds
        pool = srv.engine.pool.cache
        data, scales = quant_lib.split_scales(pool)
        owners = srv.attrib_report()["hbm"]["owners"]
        qbytes, sbytes = owners["kv_pool"] + owners["kv_scales"], owners["kv_scales"]
        if (owners["kv_pool"], sbytes) != (pool_bytes(data), pool_bytes(scales)):
            print(f"selftest-quant FAIL: {kv_dtype} HBM ledger owners {owners} "
                  f"!= the pool's {pool_bytes(data)} + {pool_bytes(scales)} bytes")
            rc = 1
        ratio = qbytes / bytes32
        if sbytes != quant_lib.scale_bytes(cfg, 2) or sbytes <= 0:
            print(f"selftest-quant FAIL: {kv_dtype} scale planes hold {sbytes} "
                  f"bytes, want {quant_lib.scale_bytes(cfg, 2)}")
            rc = 1
        if ratio > 0.27:
            print(f"selftest-quant FAIL: {kv_dtype} pool bytes ratio {ratio:.4f} > 0.27")
            rc = 1
        if not pow2_or_zero(scales):
            print(f"selftest-quant FAIL: a {kv_dtype} scale is not a power of two")
            rc = 1
        if kv_dtype == "int8":
            rt = quant_lib.quantize_lane(quant_lib.dequantize_lane(pool), q)
            if any(not torch.equal(rt[n], pool[n]) for n in pool):
                print("selftest-quant FAIL: the int8 pool's round trip is not "
                      "bit-identical")
                rc = 1
        err = quant_lib.max_abs_logit_error(params, cfg, prompts[0], q)
        srv.observe_quant_logit_error(err)
        if not (0.0 < err < 0.5):
            print(f"selftest-quant FAIL: {kv_dtype} max |dlogit| {err} out of range")
            rc = 1
        page = telemetry.parse_prometheus(telemetry.render_prometheus(reg))
        vals = {(n, tuple(sorted(lb.items()))): v for n, lb, v in page["samples"]}
        if vals.get(("mingpt_serve_kv_dtype", (("kv_dtype", kv_dtype),))) != 1.0:
            print(f"selftest-quant FAIL: mingpt_serve_kv_dtype{{kv_dtype={kv_dtype}}} "
                  "!= 1 in the scrape")
            rc = 1
        gerr = vals.get(("mingpt_serve_quant_logit_err_max", ()))
        if gerr is None or abs(gerr - err) > 1e-12:
            print(f"selftest-quant FAIL: quant err gauge {gerr} != sampled {err}")
            rc = 1
        print(f"selftest-quant [{kv_dtype}] bytes: payload+scales={qbytes} "
              f"(scales {sbytes}) fp32={bytes32} ratio={ratio:.4f} "
              f"err={err:.6f} counts={counts}")
        return rc

    rc = 0
    for kv_dtype in dtypes:
        rc |= _selftest_variant(f"selftest-quant [{kv_dtype}]",
                                lambda: check(kv_dtype))
    if "fp8" not in dtypes:
        print("selftest-quant: this torch has no float8_e4m3fn; fp8 skipped "
              "(--kv-dtype fp8 raises here)")
    print("selftest-quant", "PASSED" if rc == 0 else "FAILED")
    return rc


class TickingClock:
    """A deterministic clock: each read advances by a fixed quantum, so two
    identical runs observe identical timestamps and durations."""

    def __init__(self, dt: float = 1e-4):
        self.t = 0.0
        self.dt = dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def selftest_attrib(args) -> int:
    """Attribution on a random-init small model with speculation (and, with
    --prefix-cache-mb, the prefix store), on the CPU unless asked: every
    family registered and called appears in a ``mingpt-attrib/1`` report
    that validates, with nonzero operations; the HBM ledger's pool owners
    equal the pools' bytes; two runs on a ticking clock dump byte-identical
    reports (on the CPU, where the clock times the calls); ``/attrib``
    serves the report and the ``/metrics`` page carries the
    ``mingpt_attrib_*`` families."""
    import urllib.request

    import torch

    dev = resolve_device(args.device)
    cfg = GPTConfig.make(
        n_layer=2, n_head=2, n_embd=32, vocab_size=96, block_size=48,
        embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
    params = gpt.init(cfg, torch.Generator().manual_seed(0), device=dev)
    canned = list(SELFTEST_PROMPTS)
    if args.prefix_cache_mb > 0:
        canned += SELFTEST_SHARED
    prompts = [[ord(c) % cfg.vocab_size for c in s] for s in canned]
    spec_k = args.spec_k if args.spec_k > 0 else 2

    def run_once(reg):
        srv = InferenceServer(params, cfg, n_slots=2, clock=TickingClock(),
                              attrib=True, registry=reg, device=dev,
                              draft_params=first_layers(params, 1),
                              draft_cfg=dataclasses.replace(cfg, n_layer=1),
                              spec_k=spec_k, **_server_kwargs(args))
        srv.generate_batch([Request(prompt=p, max_new_tokens=8) for p in prompts])
        return srv, srv.attrib_report()

    rc = 0
    reg = telemetry.MetricsRegistry()
    srv, report = run_once(reg)
    try:
        telemetry.validate_attrib_report(report)
    except ValueError as e:
        print(f"selftest-attrib FAIL: the report does not validate: {e}")
        return 1
    rows = {(r["family"], r["variant"]): r for r in report["programs"]}
    families = {fam for fam, _ in rows}
    # every family that ran (compile_counts) is registered and was called;
    # with speculation the greedy rounds go through verify and the draft's
    # decode, and the plain decode may stay at 0 calls
    ran = {fam for fam, n in srv.compile_counts().items() if n}
    expected = {"prefill", "decode", "verify", "draft_prefill", "draft_decode"} | ran
    if expected - families:
        print(f"selftest-attrib FAIL: families missing: {sorted(expected - families)}")
        rc = 1
    for (fam, variant), row in sorted(rows.items()):
        if fam in ("prefill", "decode", "verify") and not row["flops"]:
            print(f"selftest-attrib FAIL: {fam}:{variant} has no operations")
            rc = 1
    for fam in ran:
        if sum(r["calls"] for (f, _), r in rows.items() if f == fam) < 1:
            print(f"selftest-attrib FAIL: no calls of {fam} observed")
            rc = 1
    owners = report["hbm"]["owners"]
    for owner, cache in (("kv_pool", srv.engine.pool.cache),
                         ("draft_pool", srv.spec.draft.engine.pool.cache)):
        if owners.get(owner) != pool_bytes(cache):
            print(f"selftest-attrib FAIL: hbm owner {owner} = {owners.get(owner)}, "
                  f"the pool holds {pool_bytes(cache)}")
            rc = 1
    if owners.get("params", 0) <= 0:
        print("selftest-attrib FAIL: params not accounted")
        rc = 1
    if srv.watchdog.recompiles:
        print(f"selftest-attrib FAIL: {srv.watchdog.recompiles} new shapes after warmup")
        rc = 1
    dump = telemetry.dump_attrib_report(report)
    if dev.type == "cpu":
        _, report_b = run_once(telemetry.MetricsRegistry())
        if telemetry.dump_attrib_report(report_b) != dump:
            print("selftest-attrib FAIL: two identical runs dumped different reports")
            rc = 1
    tserver = telemetry.TelemetryServer(reg, port=0 if args.metrics_port is None
                                        else args.metrics_port)
    tserver.attrib_provider = srv.attrib_report
    try:
        with urllib.request.urlopen(tserver.url("/attrib"), timeout=10) as resp:
            served = json.loads(resp.read().decode())
        telemetry.validate_attrib_report(served)
        with urllib.request.urlopen(tserver.url("/metrics"), timeout=10) as resp:
            types = telemetry.parse_prometheus(resp.read().decode())["types"]
        for name in ("mingpt_attrib_flops", "mingpt_attrib_calls_total",
                     "mingpt_attrib_hbm_bytes"):
            if name not in types:
                print(f"selftest-attrib FAIL: /metrics lacks {name}")
                rc = 1
        rc |= _selftest_attrib_fleet(args, params, cfg, prompts, tserver)
    finally:
        tserver.close()
    rc |= _selftest_attrib_tp(args, params, cfg, dev)
    if args.attrib_json:
        with open(args.attrib_json, "w") as f:
            f.write(dump + "\n")
        print(f"[serve] attribution report written to {args.attrib_json}",
              file=sys.stderr)
    print(telemetry.render_attrib_report(report))
    print("selftest-attrib", "PASSED" if rc == 0 else "FAILED")
    return rc


def _selftest_attrib_tp(args, params, cfg, dev) -> int:
    """The tp = 2 half: a server on a two-rank group declares the pool's
    total bytes and half of them per device, and each rank holds that half
    (the allocator's growth when the pool was made on a card, the pool's
    own bytes on the CPU)."""
    group = tp_group(2, args, dev, selftest=True)
    rc = 0
    try:
        srv = InferenceServer(params, cfg, n_slots=2, attrib=True,
                              mesh=group.mesh, device=group.device,
                              **_server_kwargs(args))
        hbm = srv.attrib_report()["hbm"]
        total, per_dev = hbm["owners"]["kv_pool"], hbm["per_device_bytes"]["kv_pool"]
        if per_dev * 2 != total:
            print(f"selftest-attrib FAIL: sharded kv_pool per-device {per_dev} "
                  f"!= total {total} / 2")
            rc = 1
        held = [_held_pool_bytes(srv.engine.local_report())] + [
            _held_pool_bytes(r) for r in srv.engine.follower_reports()]
        if any(abs(h - per_dev) > 0.01 * per_dev for h in held):
            print(f"selftest-attrib FAIL: ledger says {per_dev} pool bytes per "
                  f"device, the ranks hold {held}")
            rc = 1
        print(f"selftest-attrib tp=2: kv_pool total {total}, per device "
              f"{per_dev}, held by rank {held}")
    finally:
        group.close()
    return rc


def _held_pool_bytes(report) -> int:
    """What a rank holds of its pool: the allocator's growth when it was
    made (on a card), else the pool's bytes."""
    alloc = report["pool_alloc_bytes"]
    return report["pool_bytes"] if alloc is None else alloc


def _selftest_attrib_fleet(args, params, cfg, prompts, tserver) -> int:
    """The fleet half of --selftest-attrib: 2 instrumented replicas on a
    virtual clock serve the prompts; ``Router.attrib_report`` must be a
    ``mingpt-attrib-fleet/1`` document with one valid report per replica,
    and through ``tserver`` the merged /metrics page must strict-parse (one
    TYPE line per family) with per-replica ``mingpt_attrib_*`` samples under
    the replica label, and /attrib must serve the per-replica union."""
    import urllib.request

    from mingpt_distributed_tpu_torch.serving import (
        ReplicaSupervisor,
        Router,
        VirtualClock,
        default_server_factory,
    )

    rc = 0
    supervisor = ReplicaSupervisor(
        default_server_factory(params, cfg, n_slots=2, attrib=True,
                               device=params["wte"].device, **_server_kwargs(args)),
        n_replicas=2, clock=VirtualClock(tick_s=0.001))
    router = Router(supervisor)
    handles = [router.submit(Request(prompt=p, max_new_tokens=8)) for p in prompts]
    router.run_until_drained(max_steps=5000)
    if any(h.finish_reason != "length" for h in handles):
        print("selftest-attrib FAIL: fleet requests did not complete")
        rc = 1
    doc = router.attrib_report()
    names = {"replica0", "replica1"}
    if doc.get("schema") != "mingpt-attrib-fleet/1" or set(doc.get("replicas", {})) != names:
        print(f"selftest-attrib FAIL: fleet attrib report malformed: "
              f"{sorted(doc.get('replicas', {}))}")
        rc = 1
    for name, rep in doc.get("replicas", {}).items():
        try:
            telemetry.validate_attrib_report(rep)
        except ValueError as e:
            print(f"selftest-attrib FAIL: fleet replica {name} report invalid: {e}")
            rc = 1
    tserver.attrib_provider = router.attrib_report
    tserver.metrics_provider = router.fleet_metrics_page
    with urllib.request.urlopen(tserver.url("/metrics"), timeout=10) as resp:
        text = resp.read().decode()
    try:
        parsed = telemetry.parse_prometheus(text)
    except ValueError as e:
        print(f"selftest-attrib FAIL: the fleet's merged /metrics is not valid "
              f"exposition text: {e}")
        return 1
    for name, kind in (("mingpt_attrib_flops", "gauge"),
                       ("mingpt_attrib_calls_total", "counter"),
                       ("mingpt_attrib_hbm_bytes", "gauge"),
                       ("mingpt_fleet_replica_up", "gauge")):
        if parsed["types"].get(name) != kind:
            print(f"selftest-attrib FAIL: merged page lacks {kind} {name} "
                  f"(got {parsed['types'].get(name)})")
            rc = 1
    per_replica = {}
    for n, labels, v in parsed["samples"]:
        if n != "mingpt_attrib_flops":
            continue
        if "replica" not in labels:
            print(f"selftest-attrib FAIL: unlabelled attrib sample on the merged "
                  f"page: {labels}")
            rc = 1
        elif labels.get("family") == "decode" and v > 0:
            per_replica[labels["replica"]] = v
    if set(per_replica) != names:
        print(f"selftest-attrib FAIL: merged page missing per-replica decode "
              f"operations (got {sorted(per_replica)})")
        rc = 1
    with urllib.request.urlopen(tserver.url("/attrib"), timeout=10) as resp:
        served = json.loads(resp.read().decode())
    if set(served.get("replicas", {})) != names:
        print(f"selftest-attrib FAIL: /attrib fleet document lacks replicas: "
              f"{sorted(served.get('replicas', {}))}")
        rc = 1
    print(f"selftest-attrib fleet scrape: {len(parsed['samples'])} samples, decode "
          f"operations per replica { {k: per_replica[k] for k in sorted(per_replica)} }")
    return rc


CHAOS_CANNED = ["O God, O God!", "Once more unto", "All the world's",
                "Now is the winter", "Friends, Romans", "To be, or not"]
CHAOS_SPEC = "crash:nth=6:match=replica0;slow:every=1:delay=0.25:match=replica1"


def selftest_chaos(args) -> int:
    """Canned prompts through 3 supervised replicas (2 slots each) on a
    virtual clock while the injector crashes replica0 mid-decode and makes
    replica1 slow: every request must finish on a surviving replica with
    greedy output token-identical to solo generate(), the caller-visible
    stream must hold no duplicate token, the breaker, retry, crash and shed
    counters must be on a strict-parsed /metrics scrape and the per-replica
    breaker state on /healthz; a drained router sheds with reason
    "draining". With tracing flags, the trace stream and flight dumps are
    held too (``_chaos_observability_checks``)."""
    import torch

    from mingpt_distributed_tpu_torch.serving import (
        ReplicaSupervisor,
        Router,
        ShedError,
        VirtualClock,
        default_server_factory,
    )
    from mingpt_distributed_tpu_torch.training.faults import ServingFaultInjector

    dev = resolve_device(args.device)
    cfg = GPTConfig.make(
        n_layer=2, n_head=2, n_embd=32, vocab_size=96, block_size=48,
        embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
    params = gpt.init(cfg, torch.Generator().manual_seed(0), device=dev)
    prompts = [[ord(c) % cfg.vocab_size for c in s] for s in CHAOS_CANNED]
    max_new = 12
    n_replicas = args.replicas if args.replicas > 1 else 3
    if args.metrics_port is None:
        args.metrics_port = 0  # the scrape is part of the gate
    reg = telemetry.MetricsRegistry()
    tserver = _start_telemetry(args, reg)
    recorder, flight = _make_observability(args, reg)
    if flight is not None:
        tserver.flight_provider = lambda: flight.snapshot("on_demand")
    supervisor = ReplicaSupervisor(
        default_server_factory(params, cfg, n_slots=2, device=dev,
                               **_server_kwargs(args)),
        n_replicas=n_replicas, clock=VirtualClock(tick_s=0.001),
        injector=ServingFaultInjector(args.chaos_spec or CHAOS_SPEC),
        registry=reg, max_restarts=1, restart_backoff_s=0.01, itl_slo_s=0.1)
    streamed = {}

    def on_token(fh, tok):
        streamed.setdefault(fh.request_id, []).append(tok)

    router = Router(supervisor, on_token=on_token, max_retries=3,
                    retry_backoff_s=0.01, breaker_reset_s=0.05,
                    shed_watermark=args.shed_watermark,
                    trace_recorder=recorder, flight=flight)
    tserver.health_provider = router.health_report
    tserver.metrics_provider = router.fleet_metrics_page
    handles = [router.submit(Request(prompt=p, max_new_tokens=max_new))
               for p in prompts]
    router.run_until_drained(max_steps=5000)
    summary = router.summary()
    print("selftest-chaos fleet:", json.dumps(summary))

    rc = 0
    for text, p, h in zip(CHAOS_CANNED, prompts, handles):
        want = gen.generate(params, cfg, [p], max_new, device=dev)[0, len(p):].tolist()
        ok = h.finish_reason == "length" and h.tokens == want
        if streamed.get(h.request_id, []) != h.tokens:
            print(f"selftest-chaos FAIL {h.request_id}: streamed "
                  f"{streamed.get(h.request_id)} != handle {h.tokens} "
                  f"(duplicate or lost emission)")
            rc = 1
        print(f"selftest-chaos {h.request_id} ({text!r}): attempts={h.attempts} "
              f"replica={h.replica} dups_suppressed={h.duplicates_suppressed} "
              + ("OK" if ok else f"MISMATCH reason={h.finish_reason} "
                                 f"server={h.tokens} solo={want}"))
        rc |= not ok
    reps = summary["replicas"]
    for what, ok in (
            ("replica0 crashed at least once", reps["replica0"]["crashes"] >= 1),
            ("crashed replica was restarted",
             summary["requests_by_outcome"]["completed"] == len(prompts)
             and reps["replica0"]["state"] == "ready"),
            ("crash retries were counted", summary["retries_by_reason"]["crash"] >= 1),
            ("re-emitted tokens were suppressed, not double-streamed",
             summary["duplicates_suppressed"] >= 1),
            ("slow replica accumulated injected clock skew",
             reps["replica1"]["clock_skew_s"] > 0),
            ("slow replica is health-gated on ITL p99",
             "itl_p99" in reps["replica1"]["health_reasons"])):
        if not ok:
            print(f"selftest-chaos FAIL: {what}")
            rc = 1

    # drain: admission stops with a typed, counted rejection
    router.drain()
    try:
        router.submit(Request(prompt=prompts[0], max_new_tokens=2))
        print("selftest-chaos FAIL: draining fleet accepted a request")
        rc = 1
    except ShedError as e:
        if e.reason != "draining":
            print(f"selftest-chaos FAIL: drain shed reason {e.reason!r}")
            rc = 1
    if router.summary()["rejected_by_reason"]["draining"] < 1:
        print("selftest-chaos FAIL: draining rejection not counted")
        rc = 1
    if flight is not None:
        flight.dump("sigterm_drain")  # the dump a signalled shutdown writes
    if recorder is not None:
        rc |= _chaos_observability_checks(args, recorder, flight, handles)
    rc |= _chaos_scrape(tserver, has_flight=flight is not None)
    tserver.close()
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(router.summary(), f, indent=2)
            f.write("\n")
    print("selftest-chaos", "PASSED" if rc == 0 else "FAILED")
    return rc


def _chaos_observability_checks(args, recorder, flight, handles) -> int:
    """Under tracing flags: every request yields exactly ONE strict-valid
    trace whose attempt spans match its retries and whose emit events match
    its streamed tokens, with the scheduler's spans joined; exactly one
    forced shed trace; the crash and drain flight dumps strict-parse
    through the manifest; --slo grades from the exact trace durations."""
    rc = 0
    if recorder.active_traces:
        print(f"selftest-chaos FAIL: {recorder.active_traces} trace(s) still "
              f"open after drain")
        rc = 1
    if recorder.orphan_records:
        print(f"selftest-chaos FAIL: {recorder.orphan_records} orphan trace record(s)")
        rc = 1
    report = _slo_report(args, recorder)
    if args.slo is not None and (report is None or not report.get("grade")):
        print("selftest-chaos FAIL: --slo produced no graded report")
        rc = 1
    recorder.close()  # flush the JSONL sink before loading it
    if args.trace_jsonl is not None:
        try:
            traces = telemetry.load_trace_jsonl(args.trace_jsonl)
        except ValueError as e:
            print(f"selftest-chaos FAIL: trace stream invalid: {e}")
            return 1
        retried = 0
        for h in handles:
            t = traces.get(h.request_id)
            if t is None:
                print(f"selftest-chaos FAIL: no trace for {h.request_id}")
                rc = 1
                continue
            emits = [e for e in t["events"] if e["name"] == "emit"]
            attempts = [sp for sp in t["spans"] if sp["name"] == "fleet.attempt"]
            retries = [e for e in t["events"] if e["name"] == "retry"]
            for what, ok in (
                    ("one emit event per streamed token", len(emits) == len(h.tokens)),
                    ("one attempt span per attempt", len(attempts) == h.attempts),
                    ("retry events mark every extra attempt",
                     len(retries) == h.attempts - 1),
                    ("summary agrees with the handle",
                     t["request"]["attempts"] == h.attempts
                     and t["request"]["n_tokens"] == len(h.tokens)
                     and t["request"]["outcome"] == h.finish_reason),
                    ("scheduler spans joined the fleet trace",
                     {"serve.queue_wait", "serve.prefix_lookup", "serve.decode_round"}
                     <= {sp["name"] for sp in t["spans"]})):
                if not ok:
                    print(f"selftest-chaos FAIL {h.request_id}: {what}")
                    rc = 1
            retried += h.attempts > 1
        if not retried:
            print("selftest-chaos FAIL: no retried request in the trace stream")
            rc = 1
        shed = [t for t in traces.values() if t["request"]["outcome"] == "shed"]
        if len(shed) != 1:
            print(f"selftest-chaos FAIL: expected 1 forced shed trace, got {len(shed)}")
            rc = 1
        print(f"selftest-chaos traces: {len(traces)} trace(s), {retried} retried, "
              f"{len(shed)} shed")
    if flight is not None and flight.out_dir is not None:
        try:
            manifest, docs = telemetry.load_flight_dir(flight.out_dir)
        except (OSError, ValueError) as e:
            print(f"selftest-chaos FAIL: flight dir invalid: {e}")
            return 1
        triggers = [d["trigger"] for d in docs]
        for want in ("crash", "sigterm_drain"):
            if want not in triggers:
                print(f"selftest-chaos FAIL: no {want!r} flight dump (got {triggers})")
                rc = 1
        print(f"selftest-chaos flight: {len(docs)} dump(s) {triggers}, "
              f"latest {manifest['latest']}")
    return rc


def _chaos_scrape(tserver, has_flight: bool = False) -> int:
    """Strict-parse the fleet's /metrics page and hold it to the fleet's
    resilience families (breaker state, retries, crashes, restarts,
    rejections by reason, duplicate suppression) with >= 1 crash and retry;
    /healthz must carry each replica's breaker and health reasons and, with
    the flight recorder armed, /debug/flight a strict-valid snapshot."""
    import urllib.request

    rc = 0
    with urllib.request.urlopen(tserver.url("/healthz"), timeout=10) as resp:
        health = json.loads(resp.read().decode())
    reps = health.get("replicas")
    if not isinstance(reps, dict) or not all(
            "breaker" in v and "reasons" in v for v in reps.values()):
        print(f"selftest-chaos FAIL: /healthz lacks per-replica breaker state "
              f"and health reasons: {health}")
        rc = 1
    if has_flight:
        with urllib.request.urlopen(tserver.url("/debug/flight"), timeout=10) as resp:
            snap = json.loads(resp.read().decode())
        try:
            telemetry.validate_flight_dump(snap)
        except ValueError as e:
            print(f"selftest-chaos FAIL: /debug/flight snapshot invalid: {e}")
            rc = 1
    with urllib.request.urlopen(tserver.url("/metrics"), timeout=10) as resp:
        text = resp.read().decode()
    try:
        parsed = telemetry.parse_prometheus(text)
    except ValueError as e:
        print(f"selftest-chaos FAIL: /metrics is not valid exposition text: {e}")
        return 1
    required = {
        "mingpt_serving_rejected_total": "counter",
        "mingpt_fleet_retries_total": "counter",
        "mingpt_fleet_crashes_total": "counter",
        "mingpt_fleet_restarts_total": "counter",
        "mingpt_fleet_breaker_state": "gauge",
        "mingpt_fleet_replica_up": "gauge",
        "mingpt_fleet_replica_healthy": "gauge",
        "mingpt_fleet_duplicate_tokens_suppressed_total": "counter",
        "mingpt_serve_ttft_seconds": "histogram",
    }
    for name, kind in required.items():
        got = parsed["types"].get(name)
        if got != kind:
            print(f"selftest-chaos FAIL: /metrics lacks {kind} {name} (got {got})")
            rc = 1
    crashes = sum(v for n, _l, v in parsed["samples"] if n == "mingpt_fleet_crashes_total")
    retries = sum(v for n, _l, v in parsed["samples"] if n == "mingpt_fleet_retries_total")
    if crashes < 1 or retries < 1:
        print(f"selftest-chaos FAIL: scrape shows crashes={crashes:g} "
              f"retries={retries:g} (expected >= 1 each)")
        rc = 1
    replicas = {lb.get("replica") for n, lb, _v in parsed["samples"]
                if n == "mingpt_serve_ttft_seconds_count"}
    if not {"replica0", "replica1"} <= replicas:
        print(f"selftest-chaos FAIL: the merged page lacks per-replica serving "
              f"samples (replicas {sorted(r for r in replicas if r)})")
        rc = 1
    print(f"selftest-chaos scrape: {len(parsed['samples'])} samples, crashes_total "
          f"{crashes:g}, retries_total {retries:g}")
    return rc


# -- the process fleet's self-tests (real worker subprocesses) -------------------

PROCFLEET_CANNED = ["O God, O God!", "Once more unto", "All the world's",
                    "Now is the winter", "Friends, Romans", "To be, or not"]
PROCFLEET_CFG = dict(n_layer=2, n_head=2, n_embd=32, vocab_size=96, block_size=48,
                     embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")


class ProcDrill:
    """What the process self-tests (and the card's smoke phases) share: the
    model (its weights drawn from seed 0 on a CPU generator, as each worker
    draws them from the spec's ``init_seed``), the prompts, solo greedy
    decoding, the workers' spec, the spill root and the parity checks."""

    def __init__(self, tag, dev, cfg, params, prompts, max_new, spill_root):
        self.tag, self.dev, self.cfg, self.params = tag, dev, cfg, params
        self.prompts, self.max_new, self.spill_root = prompts, max_new, spill_root
        self._solo = {}

    @classmethod
    def tiny(cls, args, tag: str, n_prompts: int, max_new: int) -> "ProcDrill":
        """The self-tests' tiny model and canned prompts on --device."""
        import tempfile

        import torch

        dev = resolve_device(args.device)
        cfg = GPTConfig.make(**PROCFLEET_CFG)
        params = gpt.init(cfg, torch.Generator().manual_seed(0), device=dev)
        prompts = [[ord(c) % cfg.vocab_size for c in s]
                   for s in PROCFLEET_CANNED[:n_prompts]]
        return cls(tag, dev, cfg, params, prompts, max_new,
                   args.spill_dir or tempfile.mkdtemp(prefix=f"{tag}-"))

    def spec(self, **server):
        """A worker spec: this model on this device from seed 0, 2 slots
        with chunks of 8 unless ``server`` says otherwise (one intra-op
        thread on the CPU, where the workers share the cores)."""
        from mingpt_distributed_tpu_torch.serving.procfleet import cfg_to_spec

        out = {"cfg": cfg_to_spec(self.cfg), "init_seed": 0, "device": str(self.dev),
               "server": {"n_slots": 2, "prefill_chunk": 8, **server}}
        if self.dev.type == "cpu":
            out["threads"] = 1
        return out

    def solo(self, p):
        key = tuple(p)
        if key not in self._solo:
            self._solo[key] = gen.generate(self.params, self.cfg, [p], self.max_new,
                                           device=self.dev)[0, len(p):].tolist()
        return self._solo[key]

    def parity(self, label, handles, streamed) -> bool:
        """Every request finished by length with solo's tokens, streamed
        once each."""
        ok = True
        for p, h in zip(self.prompts, handles):
            want = self.solo(p)
            if h.finish_reason != "length" or h.tokens != want:
                print(f"{self.tag} FAIL ({label}) {h.request_id}: reason="
                      f"{h.finish_reason} fleet={h.tokens} solo={want}")
                ok = False
            if streamed.get(h.request_id, []) != h.tokens:
                print(f"{self.tag} FAIL ({label}) {h.request_id}: streamed "
                      f"{streamed.get(h.request_id)} != handle {h.tokens} "
                      f"(duplicate or lost emission)")
                ok = False
        return ok

    def gate(self, label, checks) -> int:
        rc = 0
        for what, ok in checks:
            if not ok:
                print(f"{self.tag} FAIL ({label}): {what}")
                rc = 1
        return rc


class _TraceList:
    """A trace sink keeping the mingpt-trace/1 records in a list."""

    def __init__(self):
        self.records = []

    def write(self, kind, rec):
        self.records.append({"schema": telemetry.TRACE_SCHEMA, "kind": kind, **rec})

    def close(self):
        pass


def mid_decode_replica(supervisor, router):
    """A ready replica decoding a request that has emitted at least one
    token: killing (or migrating) it makes the retry re-derive tokens the
    caller saw, which the dedup must absorb."""
    for (name, _), (_fh, rh) in router._attempts.items():
        rep = supervisor.replica_by_name(name)
        if rep.state == "ready" and not rh.finished and len(rh.tokens) >= 1:
            return rep
    return None


def step_until(router, cond, max_steps=2000):
    """Step the router until ``cond()`` is truthy; returns its value."""
    for _ in range(max_steps):
        router.step()
        out = cond()
        if out:
            return out
    return None


def _samples(page, family):
    """{labels tuple: value} of one family on a strict-parsed page."""
    return {tuple(sorted(labels.items())): value
            for name, labels, value in telemetry.parse_prometheus(page)["samples"]
            if name == family}


def selftest_sharded(args) -> int:
    """The tensor-parallel gate (the JAX serve.py's --selftest-sharded):
    one server at tp = 2 (this process and one follower process) and one
    at tp = 1 over the same random-init weights and canned prompts must
    give identical greedy tokens and identical ``compile_counts()``, no
    new shape after warmup, prefix-hit parity, a pool and prefix entries
    holding half the heads on every rank, and ``per_device_bytes`` = total
    / 2 for the pool in the attribution report; the follower exits 0."""
    import torch

    dev = resolve_device(args.device)
    cfg = GPTConfig.make(
        n_layer=2, n_head=2, n_embd=32, vocab_size=96, block_size=48,
        embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype="float32")
    params = gpt.init(cfg, torch.Generator().manual_seed(0), device=dev)
    canned = list(SELFTEST_PROMPTS)
    if args.prefix_cache_mb > 0:
        canned += SELFTEST_SHARED
    prompts = [[ord(c) % cfg.vocab_size for c in s] for s in canned]
    max_new = 10
    group = tp_group(2, args, dev, selftest=True)
    try:
        def run_once(mesh, device):
            srv = InferenceServer(params, cfg, n_slots=2, attrib=True, mesh=mesh,
                                  device=device, **_server_kwargs(args))
            handles = srv.generate_batch(
                [Request(prompt=p, max_new_tokens=max_new) for p in prompts])
            return srv, [h.tokens for h in handles]

        srv1, toks1 = run_once(None, dev)
        srv2, toks2 = run_once(group.mesh, group.device)
        rc = _sharded_checks(args, cfg, canned, srv1, toks1, srv2, toks2)
    finally:
        exits = group.close()
    if exits != [0]:
        print(f"selftest-sharded FAIL: follower exit codes {exits}")
        rc = 1
    print("selftest-sharded", "PASSED" if rc == 0 else "FAILED")
    return rc


def _sharded_checks(args, cfg, canned, srv1, toks1, srv2, toks2) -> int:
    rc = 0
    for text, a, b in zip(canned, toks1, toks2):
        ok = a == b
        print(f"selftest-sharded ({text!r}): "
              + ("OK" if ok else f"MISMATCH tp1={a} tp2={b}"))
        rc |= not ok
    c1, c2 = srv1.compile_counts(), srv2.compile_counts()
    if c1 != c2:
        print(f"selftest-sharded FAIL: compile_counts diverge under "
              f"sharding: tp1={c1} tp2={c2}")
        rc = 1
    ladder = len(srv2.engine.buckets)
    if c2["decode"] != 1 or c2["prefill"] > ladder:
        print(f"selftest-sharded FAIL: unbounded compilation: {c2} "
              f"(ladder size {ladder})")
        rc = 1
    for name, srv in (("tp1", srv1), ("tp2", srv2)):
        if srv.watchdog.recompiles:
            print(f"selftest-sharded FAIL: {name} watchdog counted "
                  f"{srv.watchdog.recompiles} post-warmup recompile(s)")
            rc = 1
    if args.warmup and not srv2.watchdog.armed:
        print("selftest-sharded FAIL: --warmup set but watchdog not armed")
        rc = 1
    if srv2.engine.kv_shard_count != 2:
        print(f"selftest-sharded FAIL: tp=2 pool is split over "
              f"{srv2.engine.kv_shard_count} device(s), expected 2")
        rc = 1
    half = cfg.kv_heads // 2
    reports = srv2.engine.follower_reports()
    for rep in [srv2.engine.local_report()] + reports:
        if rep["kv_heads"] != half or any(h != half for h in rep["prefix_heads"]):
            print(f"selftest-sharded FAIL: rank {rep['rank']} holds "
                  f"{rep['kv_heads']} pool heads and prefix entries of "
                  f"{rep['prefix_heads']} heads, expected {half}")
            rc = 1
        if sum(rep["launches"].values()):
            print(f"selftest-sharded FAIL: rank {rep['rank']} launched flash "
                  f"kernels while serving: {rep['launches']}")
            rc = 1
    for rep in reports:
        mine = {f: n for f, n in c2.items() if f in rep["compile_counts"]}
        if rep["compile_counts"] != mine:
            print(f"selftest-sharded FAIL: rank {rep['rank']} ran shapes "
                  f"{rep['compile_counts']}, the driver {mine}")
            rc = 1
    if args.prefix_cache_mb > 0:
        for name, srv in (("tp1", srv1), ("tp2", srv2)):
            if srv.metrics.prefix_hits < 1:
                print(f"selftest-sharded FAIL: no prefix hit on {name}")
                rc = 1
        if not srv2.engine.prefix_store.entries():
            print("selftest-sharded FAIL: the tp=2 prefix store is empty")
            rc = 1
    report = srv2.attrib_report()
    try:
        telemetry.validate_attrib_report(report)
    except ValueError as e:
        print(f"selftest-sharded FAIL: attrib report invalid: {e}")
        return 1
    owners = report["hbm"]["owners"]
    per_dev = report["hbm"]["per_device_bytes"]
    if per_dev.get("kv_pool", -1) * 2 != owners.get("kv_pool", 0):
        print(f"selftest-sharded FAIL: kv_pool per-device bytes "
              f"{per_dev.get('kv_pool')} != total {owners.get('kv_pool')} / 2")
        rc = 1
    base_owners = srv1.attrib_report()["hbm"]["owners"]
    if owners.get("kv_pool") != base_owners.get("kv_pool"):
        print(f"selftest-sharded FAIL: sharding changed the pool's total "
              f"bytes: tp1={base_owners.get('kv_pool')} "
              f"tp2={owners.get('kv_pool')}")
        rc = 1
    print(f"selftest-sharded compile_counts: {c2}")
    print(f"selftest-sharded hbm: total={owners} per_device={per_dev}")
    return rc


def selftest_procfleet(args) -> int:
    """Two replica worker subprocesses behind the mingpt-rpc/1 socket.

    Phase A, ``kill -9`` one worker mid-decode: every request finishes on
    the survivor (and the respawned worker) token-identical to solo
    generate(), its stream holding no duplicate or lost token; the
    supervisor reaped exit -9 and collected the dead worker's flight spill.

    Phase B, drain with migration: the source ships its KV/prefix state to
    the peer and exits 75; every in-flight request completes bit-identical
    to an undisturbed run, and its strict-validated mingpt-trace/1 timeline
    spans both replicas (emits on the source, a migrate event, emits on the
    destination).

    Phase C, the chunked /rpc/stream endpoint replays one request's tokens
    over the real socket, equal to its handle."""
    d = ProcDrill.tiny(args, "selftest-procfleet", n_prompts=6, max_new=12)
    sink = _TraceList()
    records = sink.records
    recorder = telemetry.TraceRecorder(sink=sink)
    supervisor, router, streamed = proc_fleet(d.spec(prefix_cache_mb=4.0), d.spill_root,
                                              trace_recorder=recorder)
    pids = {rep.name: rep.backend.pid for rep in supervisor.replicas}
    print(f"selftest-procfleet workers: {pids} (spill: {d.spill_root})")
    try:
        rc = _procfleet_phases(d, supervisor, router, streamed, records, pids)
    finally:
        exits = supervisor.shutdown_all()
    recorder.close()
    if recorder.active_traces:
        print(f"selftest-procfleet FAIL: {recorder.active_traces} trace(s) still open")
        rc = 1
    try:
        telemetry.validate_trace_records(records)
    except ValueError as e:
        print(f"selftest-procfleet FAIL: trace validation: {e}")
        rc = 1
    bad_exits = {n: c for n, c in exits.items() if c not in (75, -signal.SIGKILL)}
    if bad_exits:
        print(f"selftest-procfleet FAIL: unexpected worker exit codes {bad_exits} "
              f"(want 75 for drained, -9 for killed)")
        rc = 1
    print(f"selftest-procfleet worker exits: {exits}")
    print("selftest-procfleet", "PASSED" if rc == 0 else "FAILED")
    return rc


def _procfleet_phases(d, supervisor, router, streamed, records, pids) -> int:
    import threading

    from mingpt_distributed_tpu_torch.serving import Request

    # -- phase A: kill -9 mid-decode -----------------------------------------
    handles = [router.submit(Request(prompt=p, max_new_tokens=d.max_new))
               for p in d.prompts]
    victim = step_until(router, lambda: mid_decode_replica(supervisor, router))
    if victim is None:
        print("selftest-procfleet FAIL: no replica ever mid-decode")
        return 1
    os.kill(victim.backend.pid, signal.SIGKILL)
    print(f"selftest-procfleet kill -9 {victim.name} (pid {victim.backend.pid}) "
          f"mid-decode")
    router.run_until_drained(max_steps=20000)
    # the restart backoff is wall time: idle-step until the victim is back
    step_until(router, lambda: supervisor.replica_by_name(victim.name).state == "ready")
    ok_a = d.parity("kill", handles, streamed)
    for h in handles:
        print(f"selftest-procfleet {h.request_id}: attempts={h.attempts} "
              f"replica={h.replica}")
    summary = router.summary()
    crash = next((c for c in supervisor.crash_reports
                  if c["replica"] == victim.name), None)
    reborn = supervisor.replica_by_name(victim.name)
    rc = d.gate("phase A", [
        ("streams stayed exact through the kill", ok_a),
        ("crash retries were counted", summary["retries_by_reason"].get("crash", 0) >= 1),
        ("re-derived tokens were suppressed, not double-streamed",
         summary["duplicates_suppressed"] >= 1),
        ("supervisor reaped exit code -9",
         crash is not None and crash["exit_code"] == -signal.SIGKILL),
        ("dead worker's flight spill was collected",
         crash is not None and len(crash["spill_dumps"]) >= 1),
        ("killed worker was respawned as a new process",
         reborn.state == "ready" and reborn.backend.pid != pids[victim.name])])

    # -- phase B: drain with migration ----------------------------------------
    handles_b = [router.submit(Request(prompt=p, max_new_tokens=d.max_new))
                 for p in d.prompts]
    src = step_until(router, lambda: mid_decode_replica(supervisor, router))
    if src is None:
        print("selftest-procfleet FAIL: phase B never reached mid-decode")
        return 1
    report = router.migrate_and_drain(src.name)
    print(f"selftest-procfleet migration: {json.dumps(report)}")
    router.run_until_drained(max_steps=20000)
    ok_b = d.parity("migrate", handles_b, streamed)
    moved = set(report["requests_moved"])
    spanning = 0
    for h in handles_b:
        if h.request_id not in moved:
            continue
        events = [r for r in records
                  if r["kind"] == "event" and r["trace_id"] == h.request_id]
        if not any(e["name"] == "migrate" for e in events):
            print(f"selftest-procfleet FAIL: migrated {h.request_id} has no "
                  f"migrate event")
            rc = 1
        if len({e["replica"] for e in events if e["name"] == "emit"}) > 1:
            spanning += 1
    rc |= d.gate("phase B", [
        ("migrated streams stayed exact", ok_b),
        ("migration shipped state (outcome=ok)", report["outcome"] == "ok"),
        ("drained worker exited with the requeue code (75)",
         report["src_exit_code"] == 75),
        ("prefix/KV entries were installed on the peer",
         report["entries_installed"] >= 1),
        ("at least one in-flight request was migrated", len(moved) >= 1),
        ("a migrated request's timeline spans both replicas", spanning >= 1)])

    # -- phase C: the chunked token stream over the real socket ----------------
    h = router.submit(Request(prompt=d.prompts[0], max_new_tokens=d.max_new))
    router.step()
    attempt = next(((name, aid) for (name, aid), (fh, _) in router._attempts.items()
                    if fh.request_id == h.request_id), None)
    if attempt is None:
        print("selftest-procfleet FAIL: phase C request not in flight")
        return 1
    name, aid = attempt
    transport = supervisor.replica_by_name(name).backend.transport
    got = []
    t = threading.Thread(target=lambda: got.extend(
        transport.stream(f"/rpc/stream?request_id={aid}")), daemon=True)
    t.start()
    router.run_until_drained(max_steps=20000)
    t.join(timeout=60.0)
    toks = [doc["token"] for doc in got if doc["kind"] == "stream_token"]
    ends = [doc for doc in got if doc["kind"] == "stream_end"]
    rc |= d.gate("phase C", [
        (f"the stream endpoint gave tokens={toks} ends={ends} vs handle={h.tokens}",
         not t.is_alive() and toks == h.tokens and ends
         and ends[0]["finish_reason"] == "length")])

    # -- fleet observability over the socket ----------------------------------
    page = router.fleet_metrics_page()  # strict: one TYPE line per family
    migrations = _samples(page, "mingpt_fleet_migrations_total")
    restarts = _samples(page, "mingpt_fleet_process_restarts_total")
    steps = _samples(page, "mingpt_serve_steps_total")
    rc |= d.gate("scrape", [
        ("merged page counts the migration",
         migrations.get((("outcome", "ok"),), 0) >= 1),
        ("merged page counts the process restart",
         any(v >= 1 for v in restarts.values())),
        ("worker pages merged under the replica label",
         any("replica" in dict(k) for k in steps))])
    return rc


def proc_fleet(spec, spill, rpc_timeout_s=120.0, trace_recorder=None, wrap=None,
               n_replicas=2, **sup_kwargs):
    """(supervisor, router, streamed) over ``n_replicas`` worker
    subprocesses of ``spec`` on the wall clock, fast backoffs; ``wrap``
    (factory -> factory) decorates every spawn (the card's smoke times
    them)."""
    from mingpt_distributed_tpu_torch.serving import (
        ProcessSupervisor,
        ProcRouter,
        WallClock,
        process_backend_factory,
    )

    factory = process_backend_factory(spec, spill, rpc_timeout_s=rpc_timeout_s)
    streamed = {}
    supervisor = ProcessSupervisor(
        wrap(factory) if wrap is not None else factory, n_replicas=n_replicas,
        clock=WallClock(), max_restarts=1, restart_backoff_s=0.05, **sup_kwargs)
    router = ProcRouter(supervisor, max_retries=3, retry_backoff_s=0.01,
                        breaker_reset_s=0.05, trace_recorder=trace_recorder,
                        on_token=lambda fh, t: streamed.setdefault(
                            fh.request_id, []).append(t))
    return supervisor, router, streamed


def standby_kill_run(d, label, spec, standby):
    """The kill -9 of a mid-decode worker over a fleet of ``spec`` with
    ``standby`` warm spares, drained and stepped until the victim serves
    again: (recovery row or None, streams exact, supervisor)."""
    from mingpt_distributed_tpu_torch.serving import Request

    supervisor, router, streamed = proc_fleet(
        spec, os.path.join(d.spill_root, label), standby=standby)
    handles = [router.submit(Request(prompt=p, max_new_tokens=d.max_new))
               for p in d.prompts]
    victim = step_until(router, lambda: mid_decode_replica(supervisor, router))
    if victim is None:
        print(f"{d.tag} FAIL ({label}): never mid-decode")
        return None, False, supervisor
    os.kill(victim.backend.pid, signal.SIGKILL)
    router.run_until_drained(max_steps=20000)
    step_until(router, lambda: supervisor.replica_by_name(victim.name).state == "ready")
    ok = d.parity(label, handles, streamed)
    return supervisor.recovery_info(victim.name), ok, supervisor


def selftest_standby(args) -> int:
    """Real worker subprocesses again.

    Phase A, cold against standby on the same fault: kill -9 a mid-decode
    worker twice, over a plain supervisor and with one warm spare. Both
    runs stay token-exact with no duplicate or lost stream token; the
    standby run records a strictly smaller crash-to-serving recovery,
    labelled ``path="standby"``, and backfills its pool.

    Phase B, the hang ladder: a worker wedges inside its step RPC (the
    ``stuck_step`` process fault, worker-side) and refuses SIGTERM; the
    liveness ladder escalates SIGTERM -> SIGKILL, the crash path recovers
    through standby adoption, and every stream stays exact.

    Phase C, draft rows ride the migration: the workers self-speculate
    (k = 3); ``migrate_and_drain`` ships draft-pool rows and the peer primes
    the migrated request from them (``spec_prime_total{mode="adopted"}``),
    token-identical to solo generate()."""
    from mingpt_distributed_tpu_torch.serving import Request

    d = ProcDrill.tiny(args, "selftest-standby", n_prompts=4, max_new=10)
    rc = 0

    # -- phase A: cold against standby recovery on the same fault -------------
    rec_cold, ok_cold, sup_cold = standby_kill_run(d, "cold", d.spec(), standby=0)
    sup_cold.shutdown_all()
    rec_stby, ok_stby, sup_stby = standby_kill_run(d, "standby", d.spec(), standby=1)
    pool_refilled = (sup_stby.standby_pool is not None
                     and sup_stby.standby_pool.available() == 1)
    sup_stby.shutdown_all()
    if rec_cold and rec_stby:
        print(f"selftest-standby recovery: cold={rec_cold['recovery_s']:.3f}s "
              f"standby={rec_stby['recovery_s']:.3f}s (adopted {rec_stby['adopted']})")
    rc |= d.gate("phase A", [
        ("cold run stayed token-exact", ok_cold),
        ("standby run stayed token-exact", ok_stby),
        ("cold respawn recorded path=cold",
         rec_cold is not None and rec_cold["path"] == "cold"),
        ("standby respawn recorded path=standby",
         rec_stby is not None and rec_stby["path"] == "standby"),
        ("a spare was adopted by name",
         rec_stby is not None and str(rec_stby["adopted"]).startswith("standby")),
        ("standby recovery strictly beat cold on the same fault",
         rec_cold is not None and rec_stby is not None
         and rec_stby["recovery_s"] < rec_cold["recovery_s"]),
        ("the pool was backfilled after adoption", pool_refilled)])

    # -- phase B: stuck_step -> SIGTERM -> SIGKILL ----------------------------
    spec_b = dict(d.spec(), process_faults="stuck_step:nth=3:match=replica0")
    supervisor, router, streamed = proc_fleet(
        spec_b, os.path.join(d.spill_root, "hang"), rpc_timeout_s=2.0,
        standby=1, hang_deadline_s=1.0, hang_kill_grace_s=1.0)
    # the first workers and the spare read their specs already; respawns
    # and backfills come up clean, or the replacement wedges again
    spec_b.pop("process_faults")
    try:
        first_pid = supervisor.replica_by_name("replica0").backend.pid
        handles = [router.submit(Request(prompt=p, max_new_tokens=d.max_new))
                   for p in d.prompts]
        router.run_until_drained(max_steps=20000)
        step_until(router, lambda: supervisor.replica_by_name("replica0").state == "ready")
        ok_b = d.parity("hang", handles, streamed)
        esc = {dict(k).get("signal"): v for k, v in _samples(
            router.fleet_metrics_page(), "mingpt_fleet_hang_escalations_total").items()}
        crash = next((c for c in supervisor.crash_reports
                      if c["replica"] == "replica0"), None)
        rep0 = supervisor.replica_by_name("replica0")
        rc |= d.gate("phase B", [
            ("streams stayed exact through the wedge", ok_b),
            ("the ladder fired SIGTERM first", esc.get("term", 0) >= 1),
            ("SIGTERM was refused, SIGKILL followed", esc.get("kill", 0) >= 1),
            ("the wedged worker died of SIGKILL",
             crash is not None and crash["exit_code"] == -signal.SIGKILL),
            ("the replacement is a new, serving process",
             rep0.state == "ready" and rep0.backend.pid != first_pid)])
        print(f"selftest-standby escalations: {esc} "
              f"(exit={None if crash is None else crash['exit_code']})")
    finally:
        supervisor.shutdown_all()

    # -- phase C: draft rows ride the migration -------------------------------
    spec_c = dict(d.spec(prefix_cache_mb=4.0), draft="self", spec_k=3)
    supervisor, router, streamed = proc_fleet(spec_c, os.path.join(d.spill_root, "spec"))
    try:
        handles = [router.submit(Request(prompt=p, max_new_tokens=d.max_new))
                   for p in d.prompts]
        src = step_until(router, lambda: mid_decode_replica(supervisor, router))
        report = {}
        if src is None:
            print("selftest-standby FAIL (phase C): never mid-decode")
            rc = 1
        else:
            report = router.migrate_and_drain(src.name)
            print(f"selftest-standby migration: {json.dumps(report)}")
            router.run_until_drained(max_steps=20000)
        ok_c = d.parity("spec", handles, streamed)
        adopted_primes = 0.0
        dst = supervisor.replica_by_name(report["to"]) if report.get("to") else None
        if dst is not None and dst.backend is not None:
            primes = _samples(dst.backend.transport.fetch_text("/metrics"),
                              "mingpt_serve_spec_prime_total")
            adopted_primes = primes.get((("mode", "adopted"),), 0.0)
        rc |= d.gate("phase C", [
            ("migrated speculative streams stayed token-exact", ok_c),
            ("migration shipped state (outcome=ok)", report.get("outcome") == "ok"),
            ("draft-pool rows rode the transfer channel",
             report.get("draft_rows_installed", 0) >= 1),
            ("the peer primed from shipped rows, not a re-prefill",
             adopted_primes >= 1)])
    finally:
        exits = supervisor.shutdown_all()
    print(f"selftest-standby worker exits: {exits}")
    print("selftest-standby", "PASSED" if rc == 0 else "FAILED")
    return rc


def build_crosshost_mesh(d, label, n_hosts, secret, net_faults="",
                         paced_bytes_per_s=None, spec=None, wrap=None):
    """``n_hosts`` localhost HostAgents on the wall clock, each with a
    ProcessSupervisor of 2 worker subprocesses, HMAC-signed control
    envelopes, quorum 1, the frontend pacing with real sleeps: (frontend,
    agents, streamed)."""
    import time

    from mingpt_distributed_tpu_torch.serving import WallClock
    from mingpt_distributed_tpu_torch.serving.procfleet import (
        CrossHostRouter,
        HostAgent,
        LoopbackHostLink,
        PacedChannel,
    )
    from mingpt_distributed_tpu_torch.training.faults import NetworkFaultInjector

    clock = WallClock()
    net = NetworkFaultInjector(net_faults)
    roster = [f"host{i}" for i in range(n_hosts)]
    agents = {}
    for host in roster:
        supervisor, router, _ = proc_fleet(
            spec or d.spec(prefix_cache_mb=4.0),
            os.path.join(d.spill_root, f"{label}-{host}"), wrap=wrap,
            registry=telemetry.MetricsRegistry())
        agents[host] = HostAgent(host, router, roster, clock, secret=secret,
                                 heartbeat_interval_s=0.05, quorum=1)
    for src in roster:
        agents[src].connect({dst: LoopbackHostLink(src, dst, agents[dst], net=net)
                             for dst in roster if dst != src})
    streamed = {}
    frontend = CrossHostRouter(
        agents, clock, net=net,
        on_token=lambda c, t: streamed.setdefault(c.request_id, []).append(t))
    # real waits: the drill paces against the wall clock
    frontend.paced = PacedChannel(clock, bytes_per_s=paced_bytes_per_s,
                                  registry=frontend.registry, sleep=time.sleep)
    return frontend, agents, streamed


def mid_decode_on(frontend, host):
    for c in frontend.handles.values():
        if c.current_host == host and not c.finished and len(c.tokens) >= 1:
            return c
    return None


def _shutdown_hosts(agents):
    for host in sorted(agents):
        agents[host].router.supervisor.shutdown_all()


def selftest_crosshost(args) -> int:
    """Two (or ``--hosts``) localhost HostAgents on the wall clock, each
    owning a ProcessSupervisor of real worker subprocesses, exchanging
    HMAC-signed control envelopes. Quorum is 1: a majority of two is two,
    which no single-failure drill survives.

    Leg A, host death: SIGKILL every worker of host0 while one of its
    requests is mid-decode and stop its agent. The peer's heartbeat ladder
    quarantines it, the frontend declares it failed and re-places its
    requests, and every caller stream stays token-exact with no duplicate
    or lost emission (``recovery_log`` path ``crosshost`` on the adopting
    host).

    Leg B, paced migration under ``slow_link``: live-migrate a mid-decode
    replica host0 -> host1 through the PacedChannel with real sleeps; the
    wall transfer time is at least the token-bucket budget (bytes over the
    rate plus the injected latency per chunk) and the migrated streams stay
    token-exact.

    Leg C: a control frame tampered after signing is rejected with the
    typed ``BadSignature`` error and counted under
    ``mingpt_fleet_auth_rejects_total{reason="bad_mac"}``."""
    import time

    from mingpt_distributed_tpu_torch.serving import Request
    from mingpt_distributed_tpu_torch.serving.procfleet import envelope

    d = ProcDrill.tiny(args, "selftest-crosshost", n_prompts=6, max_new=12)
    secret = args.fleet_secret or "crosshost-drill-secret"
    n_hosts = max(2, args.hosts)
    rc = 0

    # -- leg A: SIGKILL a whole host mid-decode -------------------------------
    frontend, agents, streamed = build_crosshost_mesh(d, "kill", n_hosts, secret)
    try:
        pids = {h: [r.backend.pid for r in a.router.supervisor.replicas]
                for h, a in agents.items()}
        print(f"selftest-crosshost workers: {pids} (spill: {d.spill_root})")
        handles = [frontend.submit(Request(prompt=p, max_new_tokens=d.max_new))
                   for p in d.prompts]
        victim = step_until(frontend, lambda: mid_decode_on(frontend, "host0"),
                             max_steps=20000)
        if victim is None:
            print("selftest-crosshost FAIL (kill): nothing mid-decode on host0")
            rc = 1
        else:
            rc |= crosshost_kill_leg(d, frontend, agents, streamed, handles, victim)
    finally:
        _shutdown_hosts(agents)

    # -- leg B: paced migration under slow_link -------------------------------
    bytes_per_s, link_delay = 1e6, 0.02
    frontend, agents, streamed = build_crosshost_mesh(
        d, "paced", n_hosts, secret,
        net_faults=f"slow_link:every=1:match=host0->host1:delay={link_delay}",
        paced_bytes_per_s=bytes_per_s)
    try:
        handles = [frontend.submit(Request(prompt=p, max_new_tokens=d.max_new))
                   for p in d.prompts]
        step_until(frontend, lambda: mid_decode_on(frontend, "host0"), max_steps=20000)
        t0 = time.monotonic()
        report = frontend.migrate_crosshost("host0", "host1")
        elapsed = time.monotonic() - t0
        print(f"selftest-crosshost migration: {json.dumps(report)}")
        frontend.run_until_drained(max_steps=200000)
        ok_paced = d.parity("paced", handles, streamed)
        budget = report["bytes"] / bytes_per_s + link_delay * report["chunks"]
        shipped = _samples(frontend.fleet_metrics_page(),
                           "mingpt_fleet_xfer_bytes_total").get((("paced", "true"),), 0)
        rc |= d.gate("paced", [
            ("migration shipped state (outcome=ok)", report["outcome"] == "ok"),
            ("migrated streams stayed token-exact", ok_paced),
            ("the source replica retired with the requeue exit code",
             report["src_exit_code"] == 75),
            (f"the wall transfer respected the bandwidth budget (transfer_s="
             f"{report['transfer_s']:.3f}s budget={budget:.3f}s wall={elapsed:.3f}s)",
             report["transfer_s"] >= 0.95 * budget and elapsed >= 0.95 * budget),
            ("pacing waited, not stalled (within 2 s of the budget)",
             report["transfer_s"] <= budget + 2.0),
            ("the paced byte counter saw the transfer", shipped >= report["bytes"])])

        # -- leg C: a tampered frame -> typed reject + counter ------------------
        doc = envelope("heartbeat", host="host0", epoch=0, seq=10_000)
        agents["host0"].auth.sign(doc)
        doc["seq"] = 10_001  # tampered after signing
        resp = json.loads(agents["host1"].handle_host(
            "/host/heartbeat", json.dumps(doc, sort_keys=True).encode()))
        bad_mac = _samples(agents["host1"].router.fleet_metrics_page(),
                           "mingpt_fleet_auth_rejects_total").get((("reason", "bad_mac"),), 0)
        rc |= d.gate("auth", [
            ("tampered frame rejected with the typed error",
             resp.get("kind") == "error" and resp.get("error") == "BadSignature"),
            ("the bad_mac reject counter incremented", bad_mac >= 1)])
        print(f"selftest-crosshost auth: reject={resp.get('error')} bad_mac={bad_mac}")
    finally:
        _shutdown_hosts(agents)
    print("selftest-crosshost", "PASSED" if rc == 0 else "FAILED")
    return rc


def crosshost_kill_leg(d, frontend, agents, streamed, handles, victim) -> int:
    """Leg A after ``victim`` (a request mid-decode on host0) was found:
    host0 dies whole, the mesh drains, the checks. Returns 0 or 1."""
    agents["host0"].kill_host()  # SIGKILLs every host0 worker
    rc = 0
    try:
        frontend.run_until_drained(max_steps=200000)
    except RuntimeError as e:
        print(f"{d.tag} FAIL (kill): {e}")
        rc = 1
    ok_kill = d.parity("kill", handles, streamed)
    rows = [row for a in agents.values() for row in a.router.supervisor.recovery_log
            if row.get("path") == "crosshost"]
    failovers = _samples(frontend.fleet_metrics_page(),
                         "mingpt_fleet_crosshost_failovers_total")
    rc |= d.gate("kill", [
        ("streams stayed exact across the host death", ok_kill),
        ("the frontend declared host0 failed",
         "host0" in frontend.summary()["declared_failed"]),
        ("the victim request failed over cross-host",
         victim.recovery_s is not None and len(set(victim.hosts)) >= 2),
        ("the adopting host logged path=crosshost recovery rows",
         bool(rows) and all(r["recovery_s"] > 0 for r in rows)),
        ("the failover counter names host0",
         failovers.get((("from_host", "host0"),), 0) >= 1)])
    if victim.recovery_s is not None:
        print(f"{d.tag} host-death recovery: {victim.recovery_s:.3f}s over hosts "
              f"{victim.hosts}")
    return rc


def _load_params(args, gpt_cfg, exp, dev):
    """(params, where they came from), or (None, why not)."""
    if args.params is not None:
        with np.load(args.params) as f:
            tree = convert.unflatten({k: f[k] for k in f.files})
        return convert.params_from_numpy(tree, gpt_cfg, dev), args.params
    path = exp.trainer_config.snapshot_path or ckpt_lib.DEFAULT_SNAPSHOT_PATH
    snap = ckpt_lib.restore_inference_params(path, gpt_cfg, dev)
    if snap is None:
        return None, (f"no snapshot at {path}; train first (python -m "
                      "mingpt_distributed_tpu_torch.train) or pass --params")
    return snap.params, f"snapshot step {snap.step} at {path}"


def _autoscale_spec(args):
    """--autoscale / --slo-target as one controller spec, or None; a
    malformed spec exits. ``--autoscale static`` is an explicit no-op, so a
    script can parameterise the flag."""
    spec = args.autoscale
    if spec is None and args.slo_target is not None:
        spec = f"auto:target={args.slo_target}"
    if spec is None:
        return None
    from mingpt_distributed_tpu_torch.control.controller import parse_controller_spec

    try:
        if parse_controller_spec(spec) is None:
            return None
    except ValueError as e:
        raise SystemExit(f"bad --autoscale spec: {e}")
    return spec


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.selftest_procfleet:
        return selftest_procfleet(args)
    if args.selftest_standby:
        return selftest_standby(args)
    if args.selftest_crosshost:
        return selftest_crosshost(args)
    if args.selftest:
        return selftest(args)
    if args.selftest_spec:
        return selftest_spec(args)
    if args.selftest_quant:
        return selftest_quant(args)
    if args.selftest_attrib:
        return selftest_attrib(args)
    if args.selftest_chaos:
        return selftest_chaos(args)
    if args.selftest_sharded:
        return selftest_sharded(args)

    dev = resolve_device(args.device)
    tp = _mesh_tp(args)
    if tp > 1 and args.isolation == "process":
        raise SystemExit("--mesh does not combine with --isolation process: "
                         "each worker process serves one tp = 1 replica")
    n_groups = _tp_replicas(args) if tp > 1 else 1
    exp = load_config(args.config, args.overrides)
    dataset = make_dataset(exp.data_config)
    gpt_cfg = dataclasses.replace(
        exp.gpt_config, vocab_size=dataset.vocab_size,
        block_size=dataset.block_size,
        embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    params, source = _load_params(args, gpt_cfg, exp, dev)
    if params is None:
        print(source, file=sys.stderr)
        return 1
    print(f"loaded {source}", file=sys.stderr)

    eos_id = None
    if args.eos_text is not None:
        eos = dataset.encode(args.eos_text)
        if len(eos) != 1:
            print(f"--eos-text must encode to one token, got {len(eos)}",
                  file=sys.stderr)
            return 1
        eos_id = int(eos[0])

    # where a process fleet's workers read the same weights
    if args.params is not None:
        weights = {"params": os.path.abspath(args.params)}
    else:
        weights = {"snapshot": os.path.abspath(
            exp.trainer_config.snapshot_path or ckpt_lib.DEFAULT_SNAPSHOT_PATH)}
    guard = _ShutdownGuard().install()
    fleets = []  # process fleets: their workers are stopped however we leave
    group = None
    try:
        if tp > 1:
            group = tp_group(tp, args, dev, replicas=n_groups)
            print(f"[serve] tensor parallel: tp={tp} on {args.dist_backend or 'nccl'}, "
                  f"this process drives {n_groups} group(s) of {tp - 1} follower "
                  f"process(es)", file=sys.stderr)
        rc = _serve(args, dataset, gpt_cfg, params, dev, eos_id, guard, weights,
                    fleets, None if group is None else group.meshes)
    finally:
        for supervisor in fleets:
            supervisor.shutdown_all()
        exits = [] if group is None else group.close()
        guard.restore()
    if group is not None:
        print(f"[serve] tp follower exits: {exits}", file=sys.stderr)
    return 1 if rc == 0 and any(exits) else rc


def _tp_replicas(args) -> int:
    """How many replicas a fleet may hold at once: ``--replicas``, or with
    ``--autoscale`` the controller's ``max_replicas`` (at least
    ``--replicas``); 1 for one server."""
    spec = _autoscale_spec(args)
    if spec is None:
        return max(1, args.replicas)
    from mingpt_distributed_tpu_torch.control.controller import parse_controller_spec

    return max(args.replicas, parse_controller_spec(spec).max_replicas)


def _serve(args, dataset, gpt_cfg, params, dev, eos_id, guard, weights, fleets,
           meshes=None) -> int:
    """The offline batch (``--prompts-file``) or the REPL; ``meshes``: the
    tp groups this process drives (one per replica the fleet may hold)."""
    mesh = None if meshes is None else meshes[0]
    # stream tokens as they decode: print the newly decoded text suffix of
    # each request (decode-accumulated-and-diff is tokenizer-agnostic)
    printed = {}

    def on_token(handle, _tok) -> None:
        text = dataset.decode(handle.tokens)
        sys.stdout.write(text[len(printed.get(handle.request_id, "")):])
        printed[handle.request_id] = text
        sys.stdout.flush()

    # the process registry is served with --metrics-port and dumped by the
    # flight recorder; without either each server keeps its own
    reg = (telemetry.get_registry()
           if args.metrics_port is not None or args.flight_dir is not None else None)
    tserver = _start_telemetry(args, reg)
    recorder, flight = _make_observability(args, reg)
    if tserver is not None and flight is not None:
        tserver.flight_provider = lambda: flight.snapshot("on_demand")
    spec_kw = _spec_kwargs(args, params, gpt_cfg, dev)
    autoscale = _autoscale_spec(args)

    def attach_controller(router):
        """Hang the SLO autoscaler off the router; the control tick rides
        router.step(), so no extra thread is needed."""
        if not autoscale:
            return
        from mingpt_distributed_tpu_torch.control.controller import (
            SLOAutoscaler,
            parse_controller_spec,
        )
        router.controller = SLOAutoscaler(
            router, parse_controller_spec(autoscale), log_path=args.control_log)
        print("[serve] SLO autoscaler attached (" + autoscale + ")"
              + (f"; decisions -> {args.control_log}" if args.control_log else ""),
              file=sys.stderr)

    def build_fleet(stream_cb):
        """--replicas N: N supervised in-process replicas sharing ``params``
        on ``dev`` behind the router, on the wall clock, with --chaos-spec's
        (or MINGPT_SERVING_FAULTS') faults; /healthz, the merged /metrics
        page and, with --attrib-json, /attrib wired to the router."""
        from mingpt_distributed_tpu_torch.serving import (
            ReplicaSupervisor,
            Router,
            WallClock,
            default_server_factory,
        )
        from mingpt_distributed_tpu_torch.training.faults import ServingFaultInjector

        injector = ServingFaultInjector(args.chaos_spec)
        pool = None if meshes is None else TPMeshPool(meshes)
        supervisor = ReplicaSupervisor(
            default_server_factory(
                params, gpt_cfg, meshes=pool, n_slots=args.slots,
                max_queue=args.queue_limit, default_deadline_s=args.deadline_s,
                attrib=bool(args.attrib_json), device=dev, **spec_kw,
                **_server_kwargs(args)),
            n_replicas=args.replicas, clock=WallClock(),
            injector=injector if injector.specs else None, registry=reg)
        if pool is not None:
            pool.live = lambda: {r.name for r in supervisor.replicas
                                 if r.state != "drained"}
        router = Router(supervisor, on_token=stream_cb,
                        shed_watermark=args.shed_watermark,
                        trace_recorder=recorder, flight=flight)
        attach_controller(router)
        if tserver is not None:
            tserver.health_provider = router.health_report
            tserver.metrics_provider = router.fleet_metrics_page
            if args.attrib_json:
                tserver.attrib_provider = router.attrib_report
        print(f"[serve] fleet: {args.replicas} replicas x {args.slots} slots"
              + (f", chaos {args.chaos_spec}" if injector.specs else "")
              + ("" if pool is None else f", tp={meshes[0].tp} each"),
              file=sys.stderr)
        return router

    def build_process_fleet(stream_cb):
        """--isolation process: N worker subprocesses (``serving/procfleet``)
        on ``dev``, each restoring ``weights`` itself, behind the process
        router on the wall clock: --chaos-spec's serving faults ride in the
        workers' spec, process faults come from MINGPT_PROCESS_FAULTS, with
        --standby warm spares and --hang-deadline's ladder; /metrics merges
        the workers' pages fetched over RPC."""
        import tempfile

        from mingpt_distributed_tpu_torch.serving import (
            ProcessSupervisor,
            ProcRouter,
            WallClock,
            process_backend_factory,
        )
        from mingpt_distributed_tpu_torch.serving.procfleet import cfg_to_spec
        from mingpt_distributed_tpu_torch.training.faults import ProcessFaultInjector

        spec = {"cfg": cfg_to_spec(gpt_cfg), "device": str(dev), **weights,
                "server": {"n_slots": args.slots, "max_queue": args.queue_limit,
                           "default_deadline_s": args.deadline_s,
                           "attrib": bool(args.attrib_json), **_server_kwargs(args)},
                "serving_faults": args.chaos_spec}
        if spec_kw:
            if args.draft_config != "self":
                raise SystemExit("--isolation process speculates with "
                                 "--draft-config self only (each worker is "
                                 "its own draft)")
            spec.update(draft="self", spec_k=args.spec_k)
        spill_root = args.spill_dir or tempfile.mkdtemp(prefix="procfleet-")
        pinj = ProcessFaultInjector()
        supervisor = ProcessSupervisor(
            process_backend_factory(spec, spill_root),
            n_replicas=args.replicas, clock=WallClock(),
            process_injector=pinj if pinj.specs else None, registry=reg,
            standby=max(0, args.standby), hang_deadline_s=args.hang_deadline)
        fleets.append(supervisor)
        router = ProcRouter(supervisor, on_token=stream_cb,
                            shed_watermark=args.shed_watermark,
                            trace_recorder=recorder, flight=flight)
        attach_controller(router)
        if tserver is not None:
            tserver.health_provider = router.health_report
            tserver.metrics_provider = router.fleet_metrics_page
            if args.attrib_json:
                tserver.attrib_provider = router.attrib_report
        print(f"[serve] process fleet: {args.replicas} worker processes x "
              f"{args.slots} slots (spill: {spill_root})", file=sys.stderr)
        return router

    def build_server(stream_cb):
        """One InferenceServer, or with --replicas N > 1 or --autoscale the
        fleet router in front of N replicas (``build_fleet``;
        ``build_process_fleet`` with --isolation process, at any N); each
        takes submit, step, run_until_drained and summary, and streams
        through ``stream_cb``."""
        if args.isolation == "process":
            return build_process_fleet(stream_cb)
        if args.replicas > 1 or autoscale:
            return build_fleet(stream_cb)
        server = InferenceServer(
            params, gpt_cfg, n_slots=args.slots, on_token=stream_cb,
            log_every=0 if stream_cb else args.log_every,
            max_queue=args.queue_limit, default_deadline_s=args.deadline_s,
            registry=reg, trace_recorder=recorder, attrib=bool(args.attrib_json),
            mesh=mesh, device=dev, **spec_kw, **_server_kwargs(args))
        if tserver is not None and args.attrib_json:
            tserver.attrib_provider = server.attrib_report
        if flight is not None:
            server.watchdog.on_recompile = (
                lambda grown: flight.dump("watchdog_recompile", families=grown))
        return server

    def shutdown(server) -> int:
        """Drain in-flight work (a fleet stops admission first after a
        signal), flush the metrics, the SLO report and the attribution
        report; a flight dump after a signal; 75 after a signal."""
        if guard.stop_requested and hasattr(server, "drain"):
            server.drain()
        server.run_until_drained()
        if guard.stop_requested and flight is not None:
            flight.dump("sigterm_drain")
        _slo_report(args, recorder)
        if args.attrib_json:
            doc = server.attrib_report()
            with open(args.attrib_json, "w") as f:
                f.write((json.dumps(doc, sort_keys=True, indent=2) if "replicas" in doc
                         else telemetry.dump_attrib_report(doc)) + "\n")
            print(f"[serve] attribution report written to {args.attrib_json}",
                  file=sys.stderr)
        if recorder is not None:
            recorder.close()
        supervisor = getattr(server, "supervisor", None)
        if hasattr(supervisor, "shutdown_all"):  # a process fleet's workers
            exits = supervisor.shutdown_all()
            print(f"[serve] worker exits: {exits}", file=sys.stderr)
        if args.metrics_json:
            if hasattr(server, "metrics"):
                server.metrics.write_json(args.metrics_json)
            else:
                with open(args.metrics_json, "w") as f:
                    json.dump(server.summary(), f, indent=2)
                    f.write("\n")
        if tserver is not None:
            tserver.close()
        if guard.stop_requested:
            print(f"[serve] drained after signal; exiting "
                  f"{REQUEUE_EXIT_CODE} (requeue)", file=sys.stderr)
            return REQUEUE_EXIT_CODE
        return 0

    if args.prompts_file:
        with open(args.prompts_file) as f:
            lines = [ln.rstrip("\n") for ln in f if ln.strip()]
        server = build_server(None)
        # per-request isolation: one bad prompt (encode failure, validation
        # error, queue rejection) is reported and skipped
        handles: List = []
        for ln in lines:
            if guard.stop_requested:
                print(f"[serve] admission stopped by signal; "
                      f"{len(lines) - len(handles)} prompt(s) not admitted",
                      file=sys.stderr)
                break
            try:
                handles.append((ln, server.submit(_request_for(
                    args, dataset.encode(ln), eos_id))))
            except (KeyError, ValueError, RuntimeError) as e:
                print(f"=== skipped ({type(e).__name__}: {e}) ===\n{ln}",
                      file=sys.stderr)
            server.step()  # drain as we go so a bounded queue makes progress
        rc = shutdown(server)
        for ln, h in handles:
            print(f"=== {h.request_id} ({h.finish_reason}) ===")
            print(ln + dataset.decode(h.tokens))
        print(json.dumps(server.summary()))
        return rc

    # REPL: one prompt per stdin line, streamed as it decodes
    server = build_server(on_token)
    interactive = sys.stdin.isatty()
    if interactive:
        print("prompt> ", end="", flush=True)
    try:
        for line in sys.stdin:
            prompt = line.rstrip("\n")
            if guard.stop_requested:
                break
            if prompt:
                # one failing request must not tear down the REPL
                try:
                    sys.stdout.write(prompt)
                    server.submit(_request_for(args, dataset.encode(prompt),
                                               eos_id))
                    server.run_until_drained()
                    print()
                except (KeyError, ValueError, RuntimeError) as e:
                    print(f"\n[serve] request failed ({type(e).__name__}: "
                          f"{e}); still serving", file=sys.stderr)
            if guard.stop_requested:
                break
            if interactive:
                print("prompt> ", end="", flush=True)
    except KeyboardInterrupt:
        # second SIGINT: skip further admission, still drain and flush
        print("\n[serve] interrupted again — draining and exiting",
              file=sys.stderr)
    return shutdown(server)


if __name__ == "__main__":
    sys.exit(main())
