"""Replica worker: one ``InferenceServer`` behind the ``mingpt-rpc/1``
surface.

Counterpart of ``mingpt_distributed_tpu/serving/procfleet/worker.py``.
:class:`ReplicaWorker` is the transport-agnostic core, a dispatch table from
(method, path, body) to envelope responses, used directly by the loopback
transport and wrapped by :class:`RpcHttpServer` (the ``TelemetryServer``
recipe: stdlib ``ThreadingHTTPServer``, daemon threads, ephemeral
``port=0``) when this module runs as a spawned subprocess::

    python -m mingpt_distributed_tpu_torch.serving.procfleet.worker spec.json

Endpoints::

    POST /rpc/submit       submit envelope  -> submit_result | error
    POST /rpc/step         one scheduling round -> step_result (events)
    GET  /rpc/stream?request_id=ID   chunked stream_token lines
    POST /rpc/cancel       -> cancel_result
    POST /rpc/drain        -> drain_result (stops admission)
    GET  /rpc/health       -> health envelope
    GET  /rpc/migrate_out  -> size-framed KV/prefix blob (octet-stream)
    POST /rpc/migrate_in   size-framed blob -> migrate_in_result
    GET  /metrics          Prometheus text page (private registry)
    GET  /attrib           mingpt-attrib/1 JSON (404 without a ledger)

**Step-driven.** The worker never decodes on its own: each ``/rpc/step``
runs exactly one scheduling round and returns the round's emitted tokens
(with explicit ``token_index``) and finish verdicts as an event batch. The
router keeps control of rounds over both transports, which makes a kill -9
the in-process crash the retry and dedup machinery was built against: a
step whose response never arrives loses that round's events (tokens are
lost, never duplicated), and the retried attempt regenerates them while the
router's token-index dedup suppresses what the caller already saw. The
chunked ``/rpc/stream`` endpoint is fed from the same per-request buffers
as rounds complete.

**Migration.** ``/rpc/migrate_out`` ships every prefix-store entry and the
bucket-quantized leading prompt rows of every in-flight slot (the engine's
``extract_slot_rows``) through the size-framed transfer channel;
``/rpc/migrate_in`` installs them into the peer's prefix store on its
device (``adopt_prefix_entry``). Generated-token rows are not shipped: a
migrated request is admitted again from its original prompt, hits the
migrated entry as a device-side row copy and re-derives its decoded suffix
under the router's dedup. With speculation on, the blob also carries
``draft_rows`` frames (the draft pool's leading prompt rows), parked on the
peer until ``SpeculativeDecoder.prime`` adopts them.

**Leaves cross as bytes.** Each leaf's manifest names its dtype as the JAX
package does (``float32``, ``bfloat16``, ``int8``, ``float8_e4m3fn``); the
payload is the tensor's raw bytes (``view(torch.uint8)``), read back with
``torch.frombuffer(...).view(dtype)``. Nothing is recast, numpy (which has
no bf16 or fp8) is never on the path, and a blob that a JAX worker packs
installs here, and the reverse.

**Hangs.** A ``stuck_step`` process fault wedges the worker INSIDE the step
RPC while it holds the dispatch lock: the RPC never answers, every later
RPC times out behind the lock, and the SIGTERM handler refuses to exit while
wedged (a real wedge, a C loop holding the GIL, never runs the Python
handler). Only SIGKILL, the supervisor's second rung, clears the process.

**Kernels.** The serving path runs no kernel of ``ops/`` (the KV-cached
forward is plain PyTorch), so a worker launches none; the launch counters
of a subprocess are its own and the parent cannot read them.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from mingpt_distributed_tpu_torch.serving.procfleet.rpc import (
    EnvelopeError,
    envelope,
    pack_frames,
    request_from_wire,
    unpack_frames,
    validate_envelope,
)
from mingpt_distributed_tpu_torch.serving.requests import QueueFullError
from mingpt_distributed_tpu_torch.training.faults import (
    InjectedAdmissionError,
    InjectedServingFault,
    ProcessKilled,
    WorkerStuck,
)

__all__ = ["ReplicaWorker", "RpcHttpServer", "build_worker_from_spec", "cfg_to_spec",
           "main", "tensor_from_wire", "tensor_to_wire", "wire_dtype"]

#: the dtype names a leaf manifest carries (the JAX package's
#: ``str(arr.dtype)``) for the pools' leaves: rows in the model's dtype, int8
#: and fp8 payloads, fp32 scale planes; fp8 where this torch has it
WIRE_DTYPES: Dict[str, torch.dtype] = {
    name: getattr(torch, name)
    for name in ("float32", "bfloat16", "float16", "int8", "float8_e4m3fn")
    if hasattr(torch, name)
}
_DTYPE_NAMES = {dt: name for name, dt in WIRE_DTYPES.items()}


def wire_dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest's dtype name; raises on a name this
    torch cannot hold (never a silent recast)."""
    try:
        return WIRE_DTYPES[name]
    except KeyError:
        raise EnvelopeError(f"transfer channel: unsupported leaf dtype {name!r}")


def tensor_to_wire(t: torch.Tensor) -> Tuple[Dict[str, Any], bytes]:
    """A leaf's manifest fields (dtype, shape, nbytes) and its raw bytes,
    read off any device."""
    name = _DTYPE_NAMES.get(t.dtype)
    if name is None:
        raise EnvelopeError(f"transfer channel: no wire name for {t.dtype}")
    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return {"dtype": name, "shape": list(t.shape), "nbytes": len(raw)}, raw


def tensor_from_wire(leaf: Dict[str, Any], payload: bytes) -> torch.Tensor:
    """The CPU tensor a leaf's manifest and bytes describe."""
    dtype = wire_dtype(leaf["dtype"])
    shape = [int(d) for d in leaf["shape"]]
    if len(payload) != int(leaf["nbytes"]):
        raise EnvelopeError(
            f"transfer channel: leaf {leaf.get('name')!r} holds "
            f"{len(payload)} bytes, its manifest says {leaf['nbytes']}")
    raw = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    return raw.view(dtype).reshape(shape)


def _json_body(doc: Dict[str, Any]) -> bytes:
    return json.dumps(doc, sort_keys=True).encode()


def _error(status: int, error: str, message: str,
           **extra: Any) -> Tuple[int, str, bytes]:
    return (status, "application/json",
            _json_body(envelope("error", error=error, message=message,
                                **extra)))


class ReplicaWorker:
    """One InferenceServer behind the RPC dispatch table. Thread-safe:
    the HTTP server is threaded, so every server mutation happens under
    one lock; the stream endpoint waits on a condition fed by the same
    emit path and never holds the lock while blocked."""

    def __init__(self, server, name: str = "replica", flight=None,
                 pinj=None):
        self.server = server
        self.name = name
        self.flight = flight
        self.pinj = pinj  # worker-side ProcessFaultInjector (or None)
        #: set when a stuck_step fault wedged this worker — main()'s
        #: SIGTERM handler consults it to model an unkillable wedge
        self.wedged = threading.Event()
        self.draining = False
        self._lock = threading.RLock()
        # round event batch (drained by each step RPC)
        self._events: List[Dict[str, Any]] = []
        self._tracked: Dict[str, Any] = {}
        self._finish_reported: set = set()
        # per-request live stream buffers for /rpc/stream
        self._stream_cv = threading.Condition()
        self._streams: Dict[str, Dict[str, Any]] = {}
        server.on_token = self._on_token

    # -- emit plumbing --------------------------------------------------
    def _on_token(self, rh, token: int) -> None:
        idx = len(rh.tokens) - 1  # rh.tokens already holds this token
        ev = {"type": "emit", "request_id": rh.request_id,
              "token": int(token), "token_index": idx}
        self._events.append(ev)
        with self._stream_cv:
            buf = self._streams.setdefault(
                rh.request_id, {"tokens": [], "finish": None})
            buf["tokens"].append((idx, int(token)))
            self._stream_cv.notify_all()

    def _note_finishes(self) -> None:
        for rid, h in list(self._tracked.items()):
            if not h.finished or rid in self._finish_reported:
                continue
            self._finish_reported.add(rid)
            reason = h.finish_reason or "error"
            ev = {"type": "finish", "request_id": rid,
                  "finish_reason": reason, "n_tokens": len(h.tokens)}
            if h.error is not None:
                ev["error"] = repr(h.error)
            self._events.append(ev)
            if self.flight is not None:
                self.flight.record("request_finish", dict(
                    ts=self.server.clock(), request_id=rid, reason=reason,
                    n_tokens=len(h.tokens)))
            with self._stream_cv:
                buf = self._streams.setdefault(
                    rid, {"tokens": [], "finish": None})
                buf["finish"] = reason
                self._stream_cv.notify_all()

    # -- endpoint bodies ------------------------------------------------
    def _submit(self, doc: Dict[str, Any]) -> Tuple[int, str, bytes]:
        if self.draining:
            return _error(503, "draining",
                          f"replica {self.name} is draining")
        request = request_from_wire(doc["request"])
        try:
            with self._lock:
                rh = self.server.submit(request)
        except QueueFullError as e:
            return _error(429, "queue_full", str(e),
                          queue_depth=e.queue_depth,
                          retry_after_s=e.retry_after_s)
        except InjectedAdmissionError as e:
            return _error(503, "admit", str(e))
        except ValueError as e:
            return _error(400, "invalid", str(e))
        self._tracked[rh.request_id] = rh
        if self.flight is not None:
            self.flight.record("request_submit", dict(
                ts=self.server.clock(), request_id=rh.request_id,
                prompt_len=len(rh.prompt_used)))
        return (200, "application/json", _json_body(envelope(
            "submit_result", request_id=rh.request_id,
            queue_depth=len(self.server.queue))))

    def _maybe_process_fault(self) -> None:
        """Worker-side process faults, consulted inside the step RPC
        while the dispatch lock is held. ``stuck_step`` wedges: the RPC
        thread blocks forever on a never-set event WITH the lock, so
        this response and every later RPC time out at the client —
        exactly the sticky client-side (loopback) semantics. ``kill``
        makes the fault true: the process SIGKILLs itself mid-RPC."""
        if self.pinj is None:
            return
        try:
            self.pinj.rpc_verdict(self.name)
        except WorkerStuck:
            self.wedged.set()
            if self.flight is not None:
                self.flight.dump("stuck_step", replica=self.name,
                                 pid=os.getpid())
            threading.Event().wait()  # the wedge: never returns
        except ProcessKilled:
            import signal

            os.kill(os.getpid(), signal.SIGKILL)

    def _step(self) -> Tuple[int, str, bytes]:
        with self._lock:
            self._maybe_process_fault()
            try:
                busy = self.server.step()
            except InjectedServingFault as e:
                # a poisoned round: server state is consistent (the fault
                # point sits before any per-slot mutation) — report the
                # failure, keep the process alive
                self._events.clear()
                return _error(500, "step_failure", repr(e))
            self._note_finishes()
            events, self._events = self._events, []
            m = self.server.metrics
            doc = envelope(
                "step_result", events=events,
                queue_depth=len(self.server.queue),
                occupied=self.server.slots.occupied,
                recompiles=self.server.watchdog.recompiles,
                busy=bool(busy),
                itl_mean_s=m.itl_mean_s, itl_p99_s=m.itl_p99_s)
        return (200, "application/json", _json_body(doc))

    def _cancel(self, doc: Dict[str, Any]) -> Tuple[int, str, bytes]:
        with self._lock:
            ok = self.server.cancel(doc["request_id"])
            self._note_finishes()
        return (200, "application/json",
                _json_body(envelope("cancel_result", cancelled=bool(ok))))

    def _drain(self, doc: Dict[str, Any]) -> Tuple[int, str, bytes]:
        with self._lock:
            self.draining = True
            unfinished = len(self.server.unfinished())
            if self.flight is not None:
                self.flight.dump("drain", replica=self.name,
                                 unfinished=unfinished,
                                 migrate=bool(doc["migrate"]))
        return (200, "application/json", _json_body(envelope(
            "drain_result", draining=True, unfinished=unfinished)))

    def _health(self) -> Tuple[int, str, bytes]:
        with self._lock:
            m = self.server.metrics
            doc = envelope(
                "health",
                queue_depth=len(self.server.queue),
                occupied=self.server.slots.occupied,
                draining=self.draining,
                recompiles=self.server.watchdog.recompiles,
                pid=os.getpid(),
                itl_mean_s=m.itl_mean_s, itl_p99_s=m.itl_p99_s,
                attrib=self.server.attrib is not None)
        return (200, "application/json", _json_body(doc))

    def _metrics(self) -> Tuple[int, str, bytes]:
        from mingpt_distributed_tpu_torch.telemetry import render_prometheus
        with self._lock:
            page = render_prometheus(self.server.metrics.registry)
        return (200, "text/plain; version=0.0.4; charset=utf-8",
                page.encode())

    def _attrib(self) -> Tuple[int, str, bytes]:
        if self.server.attrib is None:
            return _error(404, "no_attrib",
                          "no attribution ledger configured")
        with self._lock:
            doc = self.server.attrib_report()
        return (200, "application/json",
                json.dumps(doc, sort_keys=True).encode())

    # -- migration ------------------------------------------------------
    def migrate_out_frames(self) -> List[Tuple[Dict[str, Any], bytes]]:
        """Everything a peer needs to take over this replica's KV reuse
        state: every prefix-store entry and the shippable leading rows of
        every in-flight slot, as transfer-channel frames."""

        def entry_frame(kind: str, key, entry: Dict[str, Any]):
            # a per-leaf manifest: a quantized lane ships its payload leaves
            # and scale planes, a plain lane just k and v; the payload is
            # each leaf's raw bytes in manifest order
            leaves = []
            blobs = []
            for name in sorted(entry):
                leaf, raw = tensor_to_wire(entry[name])
                leaves.append({"name": name, **leaf})
                blobs.append(raw)
            meta = {"type": kind, "key": [int(t) for t in key],
                    "leaves": leaves}
            return meta, b"".join(blobs)

        eng = self.server.engine
        spec_dec = getattr(self.server, "spec", None)
        frames: List[Tuple[Dict[str, Any], bytes]] = []
        shipped = set()
        draft_shipped = set()
        if eng.prefix_store is not None:
            for key, entry in eng.prefix_store.entries():
                frames.append(entry_frame("prefix_entry", key, entry))
                shipped.add(tuple(key))
        for h in self.server.slots.live_handles():
            if h.finished or h.slot is None:
                continue
            frontier = (h.prefill_pos if h.prefilling
                        else len(h.prompt_used))
            rows = eng.migratable_rows(len(h.prompt_used), frontier)
            if rows > 0:
                key = tuple(int(t) for t in h.prompt_used[:rows])
                if key not in shipped:
                    entry = eng.extract_slot_rows(h.slot, rows)
                    frames.append(entry_frame("slot_rows", key, entry))
                    shipped.add(key)
            if spec_dec is None or h.prefilling:
                continue
            # speculation: the DRAFT pool's leading prompt rows ship too
            # (the draft slot mirrors the target's, so its index is
            # h.slot); a draft regenerates no logits from the last prompt
            # row, so the whole bucket <= prompt_len ships and a
            # bucket-aligned prompt resumes with no draft prefill
            drows = spec_dec.migratable_draft_rows(len(h.prompt_used))
            if drows <= 0:
                continue
            dkey = tuple(int(t) for t in h.prompt_used[:drows])
            if dkey in draft_shipped:
                continue
            dentry = spec_dec.extract_draft_rows(h.slot, drows)
            frames.append(entry_frame("draft_rows", dkey, dentry))
            draft_shipped.add(dkey)
        manifest = {
            "type": "manifest", "replica": self.name,
            "unfinished": [h.request_id for h in self.server.unfinished()],
            "n_frames": len(frames),
        }
        return [(manifest, b"")] + frames

    def _migrate_out(self) -> Tuple[int, str, bytes]:
        with self._lock:
            self.draining = True  # shipping state implies no new tenants
            blob = pack_frames(self.migrate_out_frames())
        return (200, "application/octet-stream", blob)

    def _migrate_in(self, blob: bytes) -> Tuple[int, str, bytes]:
        try:
            frames = unpack_frames(blob)
        except EnvelopeError as e:
            return _error(400, "bad_frames", str(e))
        installed = skipped = draft_installed = 0
        with self._lock:
            eng = self.server.engine
            spec_dec = getattr(self.server, "spec", None)
            for meta, payload in frames:
                kind = meta.get("type")
                if kind == "manifest":
                    continue
                if kind not in ("prefix_entry", "slot_rows", "draft_rows"):
                    return _error(400, "bad_frames",
                                  f"unknown frame type {kind!r}")
                entry: Dict[str, Any] = {}
                off = 0
                for leaf in meta["leaves"]:
                    n = int(leaf["nbytes"])
                    entry[leaf["name"]] = tensor_from_wire(
                        leaf, payload[off:off + n])
                    off += n
                if kind == "draft_rows":
                    # parked for SpeculativeDecoder.prime; a peer
                    # without speculation skips: degrade, never fail
                    if spec_dec is not None and spec_dec.adopt_draft_rows(
                            tuple(meta["key"]), entry):
                        draft_installed += 1
                    else:
                        skipped += 1
                elif eng.adopt_prefix_entry(meta["key"], entry):
                    installed += 1
                else:
                    skipped += 1
        return (200, "application/json", _json_body(envelope(
            "migrate_in_result", installed=installed, skipped=skipped,
            draft_installed=draft_installed)))

    # -- streaming ------------------------------------------------------
    def stream_iter(self, request_id: str,
                    max_idle_waits: int = 240,
                    wait_s: float = 0.5) -> Iterator[Dict[str, Any]]:
        """Live token stream for one request: yields ``stream_token``
        envelopes as rounds emit them, then one ``stream_end``. Ends
        with an ``error`` envelope if the request never shows up or the
        stream idles out (the step loop died)."""
        sent = 0
        idle = 0
        while True:
            with self._stream_cv:
                buf = self._streams.get(request_id)
                fresh = [] if buf is None else buf["tokens"][sent:]
                finish = None if buf is None else buf["finish"]
                if not fresh and finish is None:
                    if not self._stream_cv.wait(wait_s):
                        idle += 1
                        if idle >= max_idle_waits:
                            yield envelope(
                                "error", error="stream_idle",
                                message=f"no progress for request "
                                        f"{request_id!r}")
                            return
                    continue
            idle = 0
            for idx, tok in fresh:
                sent += 1
                yield envelope("stream_token", request_id=request_id,
                               token=tok, token_index=idx)
            if finish is not None:
                yield envelope("stream_end", request_id=request_id,
                               finish_reason=finish)
                return

    # -- dispatch -------------------------------------------------------
    def handle(self, method: str, path: str,
               body: bytes) -> Tuple[int, str, bytes]:
        try:
            if method == "POST" and path in ("/rpc/submit", "/rpc/cancel",
                                             "/rpc/drain", "/rpc/step"):
                kind = path.rsplit("/", 1)[1]
                try:
                    doc = validate_envelope(
                        json.loads(body.decode() or "{}"), kind=kind)
                except (ValueError, EnvelopeError) as e:
                    return _error(400, "bad_envelope", str(e))
                if path == "/rpc/submit":
                    return self._submit(doc)
                if path == "/rpc/cancel":
                    return self._cancel(doc)
                if path == "/rpc/drain":
                    return self._drain(doc)
                return self._step()
            if method == "POST" and path == "/rpc/migrate_in":
                return self._migrate_in(body)
            if method == "GET" and path == "/rpc/health":
                return self._health()
            if method == "GET" and path == "/rpc/migrate_out":
                return self._migrate_out()
            if method == "GET" and path == "/metrics":
                return self._metrics()
            if method == "GET" and path == "/attrib":
                return self._attrib()
            return _error(404, "not_found",
                          f"unknown endpoint {method} {path}")
        except Exception as e:  # the boundary never leaks a traceback
            if self.flight is not None:
                self.flight.dump("rpc_error", replica=self.name,
                                 path=path, error=repr(e))
            return _error(500, "internal", repr(e))


class RpcHttpServer:
    """The worker's socket face — the TelemetryServer recipe (stdlib
    ``ThreadingHTTPServer``, daemon threads, ephemeral ``port=0``) grown
    a POST surface and chunked streaming for ``/rpc/stream``."""

    def __init__(self, worker: ReplicaWorker, port: int = 0,
                 host: str = "127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs

        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _reply(self, status: int, ctype: str, body: bytes) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802 — stdlib contract
                path, _, query = self.path.partition("?")
                if path == "/rpc/stream":
                    rid = parse_qs(query).get("request_id", [""])[0]
                    self.send_response(200)
                    self.send_header("Content-Type", "application/jsonl")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    try:
                        for doc in outer.worker.stream_iter(rid):
                            data = (json.dumps(doc, sort_keys=True)
                                    + "\n").encode()
                            self.wfile.write(
                                f"{len(data):x}\r\n".encode()
                                + data + b"\r\n")
                            self.wfile.flush()
                        self.wfile.write(b"0\r\n\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass  # client went away mid-stream
                    return
                self._reply(*outer.worker.handle("GET", path, b""))

            def do_POST(self) -> None:  # noqa: N802 — stdlib contract
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n)
                path = self.path.partition("?")[0]
                self._reply(*outer.worker.handle("POST", path, body))

            def log_message(self, *args) -> None:  # scrapes are noise
                pass

        self.worker = worker
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="procfleet-rpc",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()


# ---------------------------------------------------------------------
# Subprocess entry point
# ---------------------------------------------------------------------

def cfg_to_spec(cfg) -> Dict[str, Any]:
    """A GPTConfig as the spec's ``cfg`` (``GPTConfig.make`` kwargs): the
    resolved dims without ``model_type`` (make() takes a preset XOR the
    dims)."""
    import dataclasses

    doc = dataclasses.asdict(cfg)
    doc.pop("model_type", None)
    return doc


def _params_from_spec(spec: Dict[str, Any], cfg, dev, name: str):
    """The worker's weights from the spec's one weight key: ``snapshot``
    (the port trainer's snapshot), ``params`` (a flat ``.npz`` of the JAX
    parameter tree, as ``serve --params`` takes) or ``init_seed`` (the
    port's ``gpt.init`` drawn on a CPU generator and moved to ``dev``, so
    every worker's weights equal the parent's bit for bit)."""
    import numpy as np

    from mingpt_distributed_tpu_torch.models import convert, gpt

    if spec.get("snapshot"):
        from mingpt_distributed_tpu_torch.training import checkpoint as ckpt_lib

        snap = ckpt_lib.restore_inference_params(spec["snapshot"], cfg, dev)
        if snap is None:
            raise FileNotFoundError(
                f"worker {name}: no snapshot at {spec['snapshot']!r}")
        return snap.params
    if spec.get("params"):
        with np.load(spec["params"]) as f:
            tree = convert.unflatten({k: f[k] for k in f.files})
        return convert.params_from_numpy(tree, cfg, dev)
    gen = torch.Generator().manual_seed(int(spec.get("init_seed", 0)))
    return gpt.init(cfg, gen, device=dev)


def build_worker_from_spec(spec: Dict[str, Any]) -> ReplicaWorker:
    """The replica's InferenceServer from a JSON spec: ``{"name", "cfg":
    {GPTConfig.make kwargs}, "device" ("cuda" unless "cpu"), one of
    "snapshot" / "params" / "init_seed", "server": {InferenceServer kwargs},
    "spill_dir", "serving_faults", "process_faults", "draft": "self" with
    "spec_k", "threads"}``. Every replica derives the weights the parent
    would, without shipping them over the boundary. A ``cuda`` worker
    without a GPU raises (``resolve_device``): nothing falls back to the
    CPU."""
    from mingpt_distributed_tpu_torch.config import GPTConfig
    from mingpt_distributed_tpu_torch.serving.fleet import WallClock
    from mingpt_distributed_tpu_torch.serving.scheduler import InferenceServer
    from mingpt_distributed_tpu_torch.training.faults import ServingFaultInjector
    from mingpt_distributed_tpu_torch.utils.device import resolve_device

    name = spec.get("name", "replica")
    if spec.get("threads"):
        torch.set_num_threads(int(spec["threads"]))
    dev = resolve_device(spec.get("device", "cuda"))
    cfg = GPTConfig.make(**spec["cfg"])
    params = _params_from_spec(spec, cfg, dev, name)
    injector = (ServingFaultInjector(spec["serving_faults"])
                if spec.get("serving_faults") else None)
    hook = injector.round_hook(name) if injector is not None else None
    server_kwargs = dict(spec.get("server", {}))
    if spec.get("draft") == "self" and int(spec.get("spec_k", 0)) >= 1:
        # self-speculation: the target is its own draft, the cheapest real
        # draft pool a subprocess worker can have (migration ships its rows)
        server_kwargs.update(draft_params=params, draft_cfg=cfg,
                             spec_k=int(spec["spec_k"]))
    server = InferenceServer(params, cfg, clock=WallClock().now,
                             fault_hook=hook, device=dev, **server_kwargs)
    flight = None
    spill = spec.get("spill_dir")
    if spill:
        from mingpt_distributed_tpu_torch.telemetry import (
            FlightRecorder,
            render_prometheus,
        )

        os.makedirs(spill, exist_ok=True)
        flight = FlightRecorder(capacity=256, out_dir=spill,
                                registry=server.metrics.registry)
        flight.metrics_providers[name] = (
            lambda: render_prometheus(server.metrics.registry))
    pinj = None
    if spec.get("process_faults"):
        from mingpt_distributed_tpu_torch.training.faults import ProcessFaultInjector

        # no sleep: slow_socket is a client-side fault; the worker-side
        # verdicts that matter are stuck_step and kill
        pinj = ProcessFaultInjector(spec["process_faults"])
    return ReplicaWorker(server, name=name, flight=flight, pinj=pinj)


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m ...procfleet.worker spec.json``: build the server, bind
    the RPC socket, print the hello envelope on stdout (the supervisor's
    handshake), then wait for SIGTERM and exit with the fleet's requeue code
    (75)."""
    import signal
    import sys

    from mingpt_distributed_tpu_torch.serving.fleet import REQUEUE_EXIT_CODE

    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) != 1:
        # graftlint: disable-next=GL010 (a usage error before telemetry starts)
        print("usage: python -m mingpt_distributed_tpu_torch.serving."
              "procfleet.worker <spec.json>", file=sys.stderr)
        return 2
    with open(args[0]) as f:
        spec = json.load(f)
    worker = build_worker_from_spec(spec)
    httpd = RpcHttpServer(worker, port=int(spec.get("port", 0)))
    if worker.flight is not None:
        worker.flight.dump("spawn", replica=worker.name, pid=os.getpid())
    # stdout IS the wire here: the supervisor blocks on this hello line to
    # learn the bound port
    # graftlint: disable-next=GL010 (the wire, not a log line)
    print(json.dumps(envelope("hello", port=httpd.port, pid=os.getpid(),
                              name=worker.name), sort_keys=True), flush=True)
    stop = threading.Event()

    def _on_term(*_):
        if worker.wedged.is_set():
            # wedged inside the step RPC: a real wedge (a C loop holding the
            # GIL) never runs this handler; refuse the graceful exit so the
            # supervisor's SIGKILL rung is needed
            return
        stop.set()

    signal.signal(signal.SIGTERM, _on_term)
    stop.wait()
    if worker.flight is not None:
        worker.flight.dump("drain", replica=worker.name,
                           unfinished=len(worker.server.unfinished()))
    httpd.close()
    return REQUEUE_EXIT_CODE


if __name__ == "__main__":
    raise SystemExit(main())
