"""``mingpt-rpc/1``: the versioned envelope grammar of the process fleet's
socket boundary.

Counterpart of ``mingpt_distributed_tpu/serving/procfleet/rpc.py``, and
byte-compatible with it: the same envelope fields, the same canonical bytes,
the same frame layout and the same MAC for the same secret, sender and
nonce, so a JAX worker and a port worker speak one wire.

Every JSON document that crosses the replica boundary (request or response,
loopback or real HTTP) is an *envelope*: ``{"schema": "mingpt-rpc/1",
"kind": <kind>, ...}`` with a per-kind table of required fields enforced by
:func:`validate_envelope`. Both transports validate every envelope in BOTH
directions, so a drifting worker fails at the boundary instead of
corrupting the router's state.

Binary state (migrated KV rows and prefix-store entries) does not ride in
JSON: it moves through the **size-framed transfer channel**,
``pack_frames``/``unpack_frames``. A blob is ``MAGIC`` + frame count, then
per frame a length-prefixed JSON meta header and a length-prefixed raw
payload; lengths are u64 big-endian; truncation, trailing garbage and a
wrong magic raise. Meta JSON is sorted-key, so the same frames give the
same bytes.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import struct
from typing import Any, Dict, List, Optional, Tuple

RPC_SCHEMA = "mingpt-rpc/1"

#: magic + version tag opening every transfer-channel blob
FRAME_MAGIC = b"MGPTRPC1"

__all__ = [
    "RPC_SCHEMA",
    "FRAME_MAGIC",
    "EnvelopeError",
    "TransportError",
    "TransportTimeout",
    "TransportUnavailable",
    "AuthError",
    "UnsignedEnvelope",
    "BadSignature",
    "ReplayedNonce",
    "FleetAuth",
    "canonical_bytes",
    "envelope",
    "validate_envelope",
    "pack_frames",
    "unpack_frames",
    "request_to_wire",
    "request_from_wire",
]


class EnvelopeError(ValueError):
    """An envelope failed schema validation — protocol drift, not load."""


class TransportError(RuntimeError):
    """The socket (or loopback channel) failed mid-RPC: connection
    refused/reset, short read, dead subprocess. The replica may be dead —
    the supervisor decides by looking at the process."""


class TransportTimeout(TransportError):
    """The RPC timed out (socket timeout / injected hang). The replica
    is presumed alive; the round is lost, the breaker records a
    failure."""


class TransportUnavailable(TransportError):
    """The peer could not be reached at all (connection refused/reset
    through the bounded retry budget). Distinct from
    :class:`TransportTimeout`: nothing was in flight, so the call is
    safe to re-route rather than treat as a lost round."""


class AuthError(EnvelopeError):
    """An envelope failed fleet authentication. Subclasses carry a
    ``reason`` label matching ``mingpt_fleet_auth_rejects_total``."""

    reason = "auth"


class UnsignedEnvelope(AuthError):
    """Auth is required but the envelope carries no ``auth`` field."""

    reason = "unsigned"


class BadSignature(AuthError):
    """The HMAC over the canonical bytes does not verify — tampering or
    a wrong fleet secret."""

    reason = "bad_mac"


class ReplayedNonce(AuthError):
    """A verified envelope arrived with a non-monotonic nonce — a
    replayed (or badly reordered) frame."""

    reason = "replay"


# ---------------------------------------------------------------------
# Envelope grammar
# ---------------------------------------------------------------------

#: kind -> {field: type-or-tuple-of-types}; every field is required.
#: Optional payload rides beyond these (validated values, open fields —
#: the same posture as the trace schema: pin the contract, let
#: attributes grow).
_KIND_FIELDS: Dict[str, Dict[str, Any]] = {
    # client -> worker
    "submit": {"request": dict},
    "step": {},
    "cancel": {"request_id": str},
    "drain": {"migrate": bool},
    # worker -> client
    "hello": {"port": int, "pid": int, "name": str},
    "submit_result": {"request_id": str, "queue_depth": int},
    "step_result": {"events": list, "queue_depth": int, "occupied": int,
                    "recompiles": int, "busy": bool},
    "cancel_result": {"cancelled": bool},
    "drain_result": {"draining": bool, "unfinished": int},
    "health": {"queue_depth": int, "occupied": int, "draining": bool,
               "recompiles": int, "pid": int},
    "migrate_in_result": {"installed": int, "skipped": int,
                          "draft_installed": int},
    "stream_token": {"request_id": str, "token": int, "token_index": int},
    "stream_end": {"request_id": str, "finish_reason": str},
    "error": {"error": str, "message": str},
    # host <-> host (the cross-host mesh, hostplane.py)
    "heartbeat": {"host": str, "epoch": int, "seq": int},
    "heartbeat_ack": {"host": str, "epoch": int, "seq": int},
    "xfer_chunk": {"xfer_id": str, "seq": int, "n_chunks": int,
                   "digest": str, "total_bytes": int},
    "xfer_ack": {"xfer_id": str, "seq": int, "ok": bool},
}

#: event types allowed inside step_result.events
_EVENT_FIELDS: Dict[str, Dict[str, Any]] = {
    "emit": {"request_id": str, "token": int, "token_index": int},
    "finish": {"request_id": str, "finish_reason": str, "n_tokens": int},
}


def envelope(kind: str, **fields: Any) -> Dict[str, Any]:
    """Mint a validated ``mingpt-rpc/1`` envelope."""
    doc = {"schema": RPC_SCHEMA, "kind": kind, **fields}
    validate_envelope(doc, kind=kind)
    return doc


def _check_fields(where: str, doc: Dict[str, Any],
                  table: Dict[str, Any]) -> None:
    for fname, ftype in table.items():
        if fname not in doc:
            raise EnvelopeError(f"{where}: missing field {fname!r}")
        if not isinstance(doc[fname], ftype):
            raise EnvelopeError(
                f"{where}: field {fname!r} must be "
                f"{getattr(ftype, '__name__', ftype)}, "
                f"got {type(doc[fname]).__name__}")
        if ftype is int and isinstance(doc[fname], bool):
            raise EnvelopeError(
                f"{where}: field {fname!r} must be int, got bool")


def validate_envelope(doc: Any, kind: Optional[str] = None) -> Dict[str, Any]:
    """Strict structural check; returns ``doc`` for chaining. ``kind``
    pins the expected kind (a submit_result answering a cancel is
    protocol drift even if well-formed)."""
    if not isinstance(doc, dict):
        raise EnvelopeError(f"envelope must be a JSON object, got "
                            f"{type(doc).__name__}")
    if doc.get("schema") != RPC_SCHEMA:
        raise EnvelopeError(
            f"schema must be {RPC_SCHEMA!r}, got {doc.get('schema')!r}")
    k = doc.get("kind")
    if k not in _KIND_FIELDS:
        raise EnvelopeError(f"unknown envelope kind {k!r}")
    if kind is not None and k != kind:
        raise EnvelopeError(f"expected kind {kind!r}, got {k!r}")
    _check_fields(f"envelope {k}", doc, _KIND_FIELDS[k])
    if k == "step_result":
        for i, ev in enumerate(doc["events"]):
            if not isinstance(ev, dict):
                raise EnvelopeError(f"step_result.events[{i}] must be an "
                                    f"object")
            et = ev.get("type")
            if et not in _EVENT_FIELDS:
                raise EnvelopeError(
                    f"step_result.events[{i}]: unknown event type {et!r}")
            _check_fields(f"event {et}", ev, _EVENT_FIELDS[et])
    if k == "submit":
        _check_fields("submit.request", doc["request"], {"prompt": list})
    return doc


# ---------------------------------------------------------------------
# Request wire form
# ---------------------------------------------------------------------

#: Request fields that cross the boundary. The trace context is carried
#: as ids+baggage (propagation), never as a live object.
_REQUEST_FIELDS = ("prompt", "max_new_tokens", "temperature", "top_k",
                   "top_p", "do_sample", "eos_id", "seed", "deadline_s",
                   "request_id", "tenant")


def request_to_wire(request) -> Dict[str, Any]:
    """Serialize a ``Request`` for the submit envelope. The trace
    context rides as ``{"trace_id", "span_id", "baggage"}`` so a
    migrated request's timeline can span processes."""
    doc = {f: getattr(request, f) for f in _REQUEST_FIELDS}
    doc["prompt"] = [int(t) for t in doc["prompt"]]
    ctx = getattr(request, "trace", None)
    if ctx is not None:
        doc["trace"] = {"trace_id": ctx.trace_id, "span_id": ctx.span_id,
                        "baggage": dict(ctx.baggage)}
    return doc


def request_from_wire(doc: Dict[str, Any]):
    """Rebuild a ``Request`` worker-side. The propagated trace context is
    intentionally dropped into ``None`` — in-worker spans have no
    cross-process recorder to land in; the router (trace owner) records
    attempt spans and emit/migrate events on the fleet clock."""
    from mingpt_distributed_tpu_torch.serving.requests import Request

    kwargs = {f: doc[f] for f in _REQUEST_FIELDS if f in doc}
    kwargs["prompt"] = [int(t) for t in kwargs.get("prompt", ())]
    return Request(**kwargs)


# ---------------------------------------------------------------------
# Size-framed transfer channel
# ---------------------------------------------------------------------

_U64 = struct.Struct(">Q")


def pack_frames(frames: List[Tuple[Dict[str, Any], bytes]]) -> bytes:
    """``[(meta, payload), ...]`` -> one blob. Meta is sorted-key JSON so
    identical migrations serialize byte-identically."""
    out = [FRAME_MAGIC, _U64.pack(len(frames))]
    for meta, payload in frames:
        mb = json.dumps(meta, sort_keys=True).encode()
        out.append(_U64.pack(len(mb)))
        out.append(mb)
        out.append(_U64.pack(len(payload)))
        out.append(payload)
    return b"".join(out)


def unpack_frames(blob: bytes) -> List[Tuple[Dict[str, Any], bytes]]:
    """Inverse of :func:`pack_frames`; raises ``EnvelopeError`` on magic
    drift, truncation, or trailing garbage."""
    if not blob.startswith(FRAME_MAGIC):
        raise EnvelopeError("transfer channel: bad magic")
    pos = len(FRAME_MAGIC)

    def take(n: int) -> bytes:
        nonlocal pos
        if pos + n > len(blob):
            raise EnvelopeError("transfer channel: truncated blob")
        piece = blob[pos:pos + n]
        pos += n
        return piece

    (count,) = _U64.unpack(take(8))
    frames: List[Tuple[Dict[str, Any], bytes]] = []
    for _ in range(count):
        (mlen,) = _U64.unpack(take(8))
        try:
            meta = json.loads(take(mlen).decode())
        except ValueError as e:
            raise EnvelopeError(f"transfer channel: bad meta JSON: {e}")
        if not isinstance(meta, dict):
            raise EnvelopeError("transfer channel: meta must be an object")
        (plen,) = _U64.unpack(take(8))
        frames.append((meta, take(plen)))
    if pos != len(blob):
        raise EnvelopeError(
            f"transfer channel: {len(blob) - pos} trailing bytes")
    return frames


# ---------------------------------------------------------------------
# Fleet authentication (the cross-host mesh's)
# ---------------------------------------------------------------------


def canonical_bytes(doc: Dict[str, Any]) -> bytes:
    """The byte form an envelope is signed over: sorted-key JSON of the
    document WITHOUT its ``auth`` field. Deterministic by construction —
    the same discipline as the transfer-channel frame meta."""
    body = {k: v for k, v in doc.items() if k != "auth"}
    return json.dumps(body, sort_keys=True).encode()


class FleetAuth:
    """HMAC-SHA256 envelope signer/verifier with monotonic per-sender
    nonces — the shared-secret trust boundary of the cross-host mesh.

    ``sign`` stamps ``doc["auth"] = {"sender", "nonce", "mac"}`` where
    the MAC covers ``canonical_bytes(doc) + sender + nonce``; extra
    fields are open in the envelope grammar, so signed and unsigned
    envelopes validate identically and auth-off stays byte-identical.

    ``verify`` raises typed :class:`AuthError` subclasses and bumps
    ``mingpt_fleet_auth_rejects_total{reason}`` when given a registry:
    missing auth → :class:`UnsignedEnvelope`; MAC mismatch →
    :class:`BadSignature`; a nonce at-or-below the last one seen from
    that sender → :class:`ReplayedNonce`. Nonces are per-sender counters
    (monotonic, not random), so replay detection needs no clock and two
    identical runs verify identically."""

    def __init__(self, secret: str, sender: str, registry=None):
        if not secret:
            raise ValueError("fleet secret must be non-empty")
        self._key = secret.encode()
        self.sender = sender
        self._next_nonce = 0
        self._last_seen: Dict[str, int] = {}
        self._rejects = None
        if registry is not None:
            self._rejects = registry.counter(
                "mingpt_fleet_auth_rejects_total",
                help="envelopes/frames rejected by fleet auth, by reason",
                labels=("reason",))

    def _mac(self, payload: bytes, sender: str, nonce: int) -> str:
        msg = payload + b"|" + sender.encode() + b"|" + str(nonce).encode()
        return hmac.new(self._key, msg, hashlib.sha256).hexdigest()

    def _reject(self, exc_cls, msg: str):
        if self._rejects is not None:
            self._rejects.labels(reason=exc_cls.reason).inc()
        raise exc_cls(msg)

    def sign(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        """Return ``doc`` with a fresh ``auth`` stamp (mutates in
        place; signing is the last step before serialization)."""
        nonce = self._next_nonce
        self._next_nonce += 1
        doc["auth"] = {"sender": self.sender, "nonce": nonce,
                       "mac": self._mac(canonical_bytes(doc),
                                        self.sender, nonce)}
        return doc

    def verify(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        """Verify and return ``doc``; typed raise + counter on reject."""
        auth = doc.get("auth")
        if auth is None:
            self._reject(UnsignedEnvelope,
                         f"unsigned envelope kind={doc.get('kind')!r}")
        if (not isinstance(auth, dict)
                or not isinstance(auth.get("sender"), str)
                or not isinstance(auth.get("nonce"), int)
                or isinstance(auth.get("nonce"), bool)
                or not isinstance(auth.get("mac"), str)):
            self._reject(BadSignature, "malformed auth stamp")
        sender, nonce = auth["sender"], auth["nonce"]
        want = self._mac(canonical_bytes(doc), sender, nonce)
        if not hmac.compare_digest(want, auth["mac"]):
            self._reject(BadSignature,
                         f"bad MAC on {doc.get('kind')!r} from {sender}")
        last = self._last_seen.get(sender)
        if last is not None and nonce <= last:
            self._reject(ReplayedNonce,
                         f"replayed nonce {nonce} (last {last}) from "
                         f"{sender}")
        self._last_seen[sender] = nonce
        return doc

    def reject_frame_digest(self, msg: str) -> None:
        """Count + raise a transfer-chunk digest mismatch under the same
        rejects family (reason ``frame_digest``)."""
        if self._rejects is not None:
            self._rejects.labels(reason="frame_digest").inc()
        raise BadSignature(msg)
