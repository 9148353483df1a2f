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
                      bucket ladder: --selftest

The weights (REPL and batch) come from the snapshot the port's trainer
wrote at ``trainer_config.snapshot_path`` (``training/checkpoint.py``
``restore_inference_params``) or from ``--params FILE.npz`` (a JAX
parameter pytree flattened to ``"blocks/wq"``-style keys, as ``sample.py``
takes). The vocabulary is the corpus's by ``data_config.tokenizer`` (char
or bpe), as in training; ``section.key=value`` overrides as in ``train.py``.

Usage:
  python -m mingpt_distributed_tpu_torch.serve --selftest [--device cpu]
  python -m mingpt_distributed_tpu_torch.serve --prompts-file prompts.txt \\
      [--config gpt2_config.yaml] [--slots 4] [--greedy] \\
      [--prefill-chunk 256] [--prefix-cache-mb 64] [--warmup] \\
      [trainer_config.snapshot_path=...] [section.key=value ...]

SIGTERM (or one SIGINT) stops admission, drains in-flight requests, flushes
the metrics and exits 75 so a scheduler requeues the job; a second SIGINT
aborts. The JAX serve.py's other flags are parsed and refused (exit 2),
naming the ROADMAP.md Queue 1 item that brings them (``UNPORTED_FLAGS``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import sys
from typing import List

import numpy as np

from mingpt_distributed_tpu_torch.config import GPTConfig, load_config
from mingpt_distributed_tpu_torch.data.token_dataset import make_dataset
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import generate as gen
from mingpt_distributed_tpu_torch.models import gpt
from mingpt_distributed_tpu_torch.serving import InferenceServer, Request
from mingpt_distributed_tpu_torch.training import checkpoint as ckpt_lib
from mingpt_distributed_tpu_torch.training.trainer import REQUEUE_EXIT_CODE
from mingpt_distributed_tpu_torch.utils.device import resolve_device

# the JAX serve.py's flags that the port does not run yet, each with the
# ROADMAP.md Queue 1 item that brings it; --kv-dtype fp32 is accepted
UNPORTED_FLAGS = {
    "--metrics-port": "5",
    "--mesh": "9", "--selftest-sharded": "9",
    "--kv-dtype": "14", "--draft-config": "14", "--spec-k": "14",
    "--selftest-spec": "14", "--selftest-quant": "14",
    "--replicas": "15", "--isolation": "15", "--autoscale": "15",
    "--slo-target": "15", "--control-log": "15", "--shed-watermark": "15",
    "--chaos-spec": "15", "--spill-dir": "15", "--standby": "15",
    "--hang-deadline": "15", "--hosts": "15", "--fleet-secret": "15",
    "--selftest-chaos": "15", "--selftest-procfleet": "15",
    "--selftest-standby": "15", "--selftest-crosshost": "15",
    "--trace-jsonl": "16", "--trace-sample": "16", "--flight-dir": "16",
    "--slo": "16", "--slo-json": "16", "--attrib-json": "16",
    "--selftest-attrib": "16",
}

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
        if value is None or (flag == "--kv-dtype" and value == "fp32"):
            continue
        p.error(f"{flag} is not ported yet (ROADMAP.md Queue 1 item {item})")
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
    """The prefill knobs, shared by every server construction."""
    return dict(prefill_buckets=_parse_buckets(args.prefill_buckets),
                prefill_chunk=args.prefill_chunk,
                prefix_cache_mb=args.prefix_cache_mb, warmup=args.warmup)


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
    server = InferenceServer(params, cfg, n_slots=2, log_every=args.log_every,
                             device=dev, **_server_kwargs(args))
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


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.selftest:
        return selftest(args)

    dev = resolve_device(args.device)
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

    guard = _ShutdownGuard().install()
    try:
        return _serve(args, dataset, gpt_cfg, params, dev, eos_id, guard)
    finally:
        guard.restore()


def _serve(args, dataset, gpt_cfg, params, dev, eos_id, guard) -> int:
    """The offline batch (``--prompts-file``) or the REPL."""
    # stream tokens as they decode: print the newly decoded text suffix of
    # each request (decode-accumulated-and-diff is tokenizer-agnostic)
    printed = {}

    def on_token(handle, _tok) -> None:
        text = dataset.decode(handle.tokens)
        sys.stdout.write(text[len(printed.get(handle.request_id, "")):])
        printed[handle.request_id] = text
        sys.stdout.flush()

    def build_server(stream_cb) -> InferenceServer:
        return InferenceServer(
            params, gpt_cfg, n_slots=args.slots, on_token=stream_cb,
            log_every=0 if stream_cb else args.log_every,
            max_queue=args.queue_limit, default_deadline_s=args.deadline_s,
            device=dev, **_server_kwargs(args))

    def shutdown(server: InferenceServer) -> int:
        """Drain in-flight work, flush the metrics; 75 after a signal."""
        server.run_until_drained()
        if args.metrics_json:
            server.metrics.write_json(args.metrics_json)
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
