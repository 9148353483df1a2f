"""The process fleet's transport seam.

Counterpart of ``mingpt_distributed_tpu/serving/procfleet/transport.py``.
Two implementations of one small surface (JSON envelopes in, JSON envelopes
out, plus raw text and bytes for the metrics page and the size-framed
migration channel):

* :class:`SocketTransport` — real HTTP over a 127.0.0.1 socket to a spawned
  replica subprocess. A socket timeout bounds every call (an OS-level I/O
  deadline, the one form of wall-clock coupling in this package);
  connection failures surface as :class:`~.rpc.TransportError` and
  timeouts as :class:`~.rpc.TransportTimeout`, which the supervisor turns
  into crash and lost-round verdicts. ``stream()`` reads the worker's
  chunked token stream line by line.

* :class:`LoopbackTransport` — the deterministic in-process twin: the same
  byte-level request/response path (envelopes are serialized to JSON bytes
  and parsed again, so loopback runs the exact wire encoding) against a
  :class:`~.worker.ReplicaWorker` held in-process. No sockets, threads or
  wall clock: the chaos tests run on a ``VirtualClock`` and two identical
  runs give byte-identical reports.

* :class:`LoopbackHostLink` — the multi-host twin, between two
  :class:`~.hostplane.HostAgent` objects.

Both directions validate every envelope: a malformed document raises
:class:`~.rpc.EnvelopeError` at the boundary it crossed.
"""

from __future__ import annotations

import http.client
import json
import socket
import time
from typing import Any, Callable, Dict, Iterator, Optional

from mingpt_distributed_tpu_torch.serving.procfleet.rpc import (
    EnvelopeError,
    TransportError,
    TransportTimeout,
    TransportUnavailable,
    validate_envelope,
)

__all__ = ["LoopbackTransport", "SocketTransport", "LoopbackHostLink"]


class LoopbackTransport:
    """In-process transport over a :class:`ReplicaWorker` — the
    deterministic half of the seam. Envelopes round-trip through JSON
    bytes so the loopback path is byte-faithful to the socket path."""

    def __init__(self, worker):
        self.worker = worker

    def _dispatch(self, method: str, path: str, body: bytes):
        if self.worker is None:
            raise TransportError("loopback worker is gone (killed)")
        return self.worker.handle(method, path, body)

    def call(self, path: str, doc: Optional[Dict[str, Any]] = None,
             ) -> Dict[str, Any]:
        """POST an envelope (or GET when ``doc`` is None); returns the
        validated response envelope — including ``error`` envelopes,
        which the caller maps to typed exceptions."""
        if doc is None:
            method, body = "GET", b""
        else:
            method = "POST"
            body = json.dumps(validate_envelope(doc), sort_keys=True).encode()
        _status, _ctype, payload = self._dispatch(method, path, body)
        try:
            parsed = json.loads(payload.decode())
        except ValueError as e:
            raise EnvelopeError(f"loopback {path}: non-JSON response: {e}")
        return validate_envelope(parsed)

    def fetch_text(self, path: str) -> str:
        status, _ctype, payload = self._dispatch("GET", path, b"")
        if status != 200:
            raise TransportError(f"loopback GET {path} -> {status}")
        return payload.decode()

    def fetch_json(self, path: str) -> Dict[str, Any]:
        """Raw JSON (non-envelope) endpoints — /attrib."""
        status, _ctype, payload = self._dispatch("GET", path, b"")
        if status != 200:
            raise TransportError(f"loopback GET {path} -> {status}")
        return json.loads(payload.decode())

    def fetch_bytes(self, path: str) -> bytes:
        status, _ctype, payload = self._dispatch("GET", path, b"")
        if status != 200:
            raise TransportError(f"loopback GET {path} -> {status}")
        return payload

    def post_bytes(self, path: str, blob: bytes) -> Dict[str, Any]:
        _status, _ctype, payload = self._dispatch("POST", path, blob)
        return validate_envelope(json.loads(payload.decode()))

    def close(self) -> None:
        self.worker = None


class SocketTransport:
    """Real-HTTP transport to a replica subprocess. One connection per
    call — simple, and robust to the server dying between rounds (a
    kept-alive connection to a SIGKILLed process fails in stranger
    ways). ``timeout_s`` is a socket timeout on connect AND read.

    Connection refused/reset is retried up to ``connect_retries`` times
    with geometric backoff (``sleep`` is injectable per the
    ``RetryPolicy.sleep`` idiom, so tests count delays instead of
    waiting), then surfaces as a typed
    :class:`~.rpc.TransportUnavailable` — distinct from
    :class:`~.rpc.TransportTimeout` because nothing was in flight: the
    caller may safely re-route instead of charging a lost round."""

    def __init__(self, host: str, port: int, timeout_s: float = 30.0,
                 connect_retries: int = 2, retry_backoff_s: float = 0.05,
                 sleep: Callable[[float], None] = time.sleep):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self.connect_retries = connect_retries
        self.retry_backoff_s = retry_backoff_s
        self.sleep = sleep

    def _roundtrip(self, method: str, path: str, body: bytes,
                   timeout_s: Optional[float] = None):
        for attempt in range(self.connect_retries + 1):
            conn = http.client.HTTPConnection(
                self.host, self.port,
                timeout=self.timeout_s if timeout_s is None else timeout_s)
            try:
                conn.request(method, path, body=body or None,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                return resp.status, resp.read()
            except socket.timeout as e:
                raise TransportTimeout(
                    f"{method} {path} to {self.host}:{self.port} timed "
                    f"out: {e}")
            except (ConnectionRefusedError, ConnectionResetError,
                    BrokenPipeError) as e:
                if attempt >= self.connect_retries:
                    raise TransportUnavailable(
                        f"{method} {path} to {self.host}:{self.port} "
                        f"unreachable after {attempt + 1} attempts: {e!r}")
                self.sleep(self.retry_backoff_s * (2 ** attempt))
            except (OSError, http.client.HTTPException) as e:
                raise TransportError(
                    f"{method} {path} to {self.host}:{self.port} failed: "
                    f"{e!r}")
            finally:
                conn.close()

    def call(self, path: str, doc: Optional[Dict[str, Any]] = None,
             ) -> Dict[str, Any]:
        if doc is None:
            method, body = "GET", b""
        else:
            method = "POST"
            body = json.dumps(validate_envelope(doc), sort_keys=True).encode()
        _status, payload = self._roundtrip(method, path, body)
        try:
            parsed = json.loads(payload.decode())
        except ValueError as e:
            raise EnvelopeError(f"{path}: non-JSON response: {e}")
        return validate_envelope(parsed)

    def fetch_text(self, path: str) -> str:
        status, payload = self._roundtrip("GET", path, b"")
        if status != 200:
            raise TransportError(f"GET {path} -> HTTP {status}")
        return payload.decode()

    def fetch_json(self, path: str) -> Dict[str, Any]:
        status, payload = self._roundtrip("GET", path, b"")
        if status != 200:
            raise TransportError(f"GET {path} -> HTTP {status}")
        return json.loads(payload.decode())

    def fetch_bytes(self, path: str) -> bytes:
        status, payload = self._roundtrip("GET", path, b"")
        if status != 200:
            raise TransportError(f"GET {path} -> HTTP {status}")
        return payload

    def post_bytes(self, path: str, blob: bytes) -> Dict[str, Any]:
        _status, payload = self._roundtrip(
            "POST", path, blob,
            # migration blobs can be big; give the copy more room than a
            # one-envelope RPC
            timeout_s=self.timeout_s * 4)
        return validate_envelope(json.loads(payload.decode()))

    def stream(self, path: str,
               timeout_s: Optional[float] = None) -> Iterator[Dict[str, Any]]:
        """Consume a chunked token stream: yields validated
        ``stream_token`` envelopes, ends after ``stream_end`` (or an
        ``error`` envelope, which is yielded last)."""
        conn = http.client.HTTPConnection(
            self.host, self.port,
            timeout=self.timeout_s if timeout_s is None else timeout_s)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            for raw in resp:
                line = raw.strip()
                if not line:
                    continue
                doc = validate_envelope(json.loads(line.decode()))
                yield doc
                if doc["kind"] in ("stream_end", "error"):
                    return
        except socket.timeout as e:
            raise TransportTimeout(f"stream {path} timed out: {e}")
        except (OSError, http.client.HTTPException) as e:
            raise TransportError(f"stream {path} failed: {e!r}")
        finally:
            conn.close()

    def close(self) -> None:
        pass


class LoopbackHostLink:
    """The multi-host twin of :class:`LoopbackTransport`: a
    deterministic in-process link from one :class:`~.hostplane.HostAgent`
    to another. Control-plane envelopes round-trip through JSON bytes
    (byte-faithful to the socket path) and every crossing consults the
    shared :class:`~mingpt_distributed_tpu_torch.training.faults.NetworkFaultInjector`
    first — a partitioned link raises :class:`~.rpc.TransportUnavailable`
    exactly like a refused socket, so the heartbeat ladder can't tell a
    drill from a cable pull.

    Data-plane chunks (:meth:`post_bytes`) are a dumb pipe on purpose:
    the :class:`~.hostplane.PacedChannel` applies link/frame verdicts
    itself *before* handing bytes over, so fault counters advance
    exactly once per chunk."""

    def __init__(self, src: str, dst: str, dst_agent, net=None):
        self.src = src
        self.dst = dst
        self.dst_agent = dst_agent
        self.net = net

    def _require_up(self) -> None:
        if self.dst_agent is None or not getattr(self.dst_agent, "alive",
                                                 True):
            raise TransportUnavailable(
                f"host link {self.src}->{self.dst}: peer host is down")

    def call(self, path: str, doc: Dict[str, Any]) -> Dict[str, Any]:
        """Send one signed control envelope; returns the validated
        response envelope. Partition -> TransportUnavailable."""
        if self.net is not None:
            from mingpt_distributed_tpu_torch.training.faults import LinkPartitioned
            try:
                self.net.link_verdict(self.src, self.dst)
            except LinkPartitioned as e:
                raise TransportUnavailable(str(e))
        self._require_up()
        wire = json.dumps(validate_envelope(doc), sort_keys=True).encode()
        resp = self.dst_agent.handle_host(path, wire)
        return validate_envelope(json.loads(resp.decode()))

    def post_bytes(self, path: str, blob: bytes) -> Dict[str, Any]:
        """Deliver one raw transfer-channel chunk (verdicts already
        applied by the caller); returns the validated ack envelope."""
        self._require_up()
        resp = self.dst_agent.handle_host(path, blob)
        return validate_envelope(json.loads(resp.decode()))

    def close(self) -> None:
        self.dst_agent = None
