"""Cross-host fleet control plane.

Counterpart of ``mingpt_distributed_tpu/serving/procfleet/hostplane.py``.
The process fleet supervises replica *processes* on one machine. This module
adds the layer above: a mesh of **hosts**, each running a :class:`HostAgent`
that owns its local :class:`~.supervisor.ProcessSupervisor` and
:class:`~.supervisor.ProcRouter` and speaks to its peers over the same
``mingpt-rpc/1`` envelope grammar (heartbeats, signed control frames, and
the size-framed transfer channel, bandwidth-paced). A
:class:`CrossHostRouter` fronts the mesh: it routes requests to admitting
hosts, collects token emissions, and fails requests over *across* hosts
when a whole machine dies or partitions away.

* **Failure detection is a ladder, not a bit.** Peers are seeded from a
  static roster; liveness comes from heartbeats on the injected clock. A
  peer degrades ``alive → suspect → quarantined → dead`` on elapsed silence
  (2.5× / 5× / 10× the heartbeat interval by default) and recovers only
  after ``recover_beats`` consecutive good beats, so one missed beat never
  flaps a peer.

* **Split-brain is fenced twice.** A host that loses quorum contact stops
  *admitting* within one heartbeat deadline (``submit`` sheds with
  ``reason="no_quorum"``). A partitioned host keeps decoding what it holds,
  so the frontend fences its stale emissions: every token carries the
  emitting host and epoch, and tokens from a (host, attempt) that is no
  longer the request's placement, or from an epoch below the request's
  fence, are dropped and counted, never emitted twice. Failing a victim
  over bumps the fleet epoch and pushes it to every quorate host, so a
  partitioned-then-healed host rejoins *behind* the fence.

* **Trust is explicit.** With a shared fleet secret every control envelope
  is HMAC-signed over its canonical bytes with a per-sender monotonic nonce
  (:class:`~.rpc.FleetAuth`); unsigned, tampered and replayed frames are
  rejected with typed errors and distinct
  ``mingpt_fleet_auth_rejects_total{reason}`` counts. Auth is off by
  default.

* **Bandwidth is a budget.** Cross-host migration ships the same
  ``MGPTRPC1`` blob as local migration, through a token-bucket
  :class:`PacedChannel`: chunks are charged against ``bytes_per_s`` on the
  injected clock (this module reads no wall clock and never sleeps unless
  a caller injects ``sleep``), each chunk carries a sha256 digest, a
  dropped or partitioned link retries from the last acked chunk, and an
  exhausted retry budget degrades to plain re-route: requests are never
  lost, they re-prefill.

Network chaos (``partition`` / ``drop_frame`` / ``slow_link`` /
``host_kill``) rides
:class:`~mingpt_distributed_tpu_torch.training.faults.NetworkFaultInjector`,
and :func:`build_loopback_fleet` wires a whole multi-host mesh in-process
over :class:`~.transport.LoopbackHostLink`: two identical partition drills
on a ``VirtualClock`` give byte-identical reports, no sockets involved.
"""

from __future__ import annotations

import hashlib
import itertools
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from mingpt_distributed_tpu_torch.serving.fleet import VirtualClock
from mingpt_distributed_tpu_torch.serving.procfleet.rpc import (
    RPC_SCHEMA,
    AuthError,
    EnvelopeError,
    FleetAuth,
    TransportError,
    envelope,
    pack_frames,
    unpack_frames,
    validate_envelope,
)
from mingpt_distributed_tpu_torch.serving.requests import Request, ShedError
from mingpt_distributed_tpu_torch.telemetry import (
    MetricsRegistry,
    merge_fleet_pages,
    render_prometheus,
)
from mingpt_distributed_tpu_torch.training.faults import (
    LinkPartitioned,
    NetworkFaultInjector,
)

__all__ = [
    "PacedTransferError",
    "PacedChannel",
    "HostAgent",
    "CrossHandle",
    "CrossHostRouter",
    "build_loopback_fleet",
]

#: help text shared with FleetAuth so both land in the ONE counter family
_AUTH_REJECTS_HELP = "envelopes/frames rejected by fleet auth, by reason"

_HOST_STATES = ("alive", "suspect", "quarantined", "dead")


# ---------------------------------------------------------------------
# PacedChannel — the bandwidth-budgeted transfer channel
# ---------------------------------------------------------------------

class PacedTransferError(TransportError):
    """A paced transfer exhausted its per-chunk retry budget. The blob
    did NOT arrive; the caller degrades to plain re-route (requests
    re-prefill on the destination) — degraded, never lost."""


class PacedChannel:
    """Token-bucket pacing over the size-framed transfer channel.

    The bucket starts empty and refills at ``bytes_per_s`` (burst capped
    at one chunk), so on a virtual clock a transfer of B bytes takes
    exactly ``B / bytes_per_s`` seconds plus any injected ``slow_link``
    latency. Waiting is ``clock.advance`` by default (two identical runs
    pace identically); against a wall clock pass ``sleep=time.sleep`` *at
    the call site* (serve's cross-host drill does) and the wait is real.

    ``send`` is resumable: every chunk carries a sha256 digest and a
    sequence number, the receiver acks each chunk, and a partitioned
    link / dropped frame / digest NACK retries the *same* chunk — from
    the last acked frame, never from zero. Retried chunks are charged
    against the bandwidth budget again (the bytes crossed the wire
    again). ``bytes_per_s=None`` disables pacing (label
    ``paced="false"`` on the transfer counters)."""

    def __init__(self, clock, bytes_per_s: Optional[float] = None,
                 chunk_bytes: int = 65536, max_retries: int = 3,
                 burst_bytes: Optional[float] = None, registry=None,
                 sleep: Optional[Callable[[float], None]] = None):
        if chunk_bytes <= 0:
            raise ValueError("chunk_bytes must be positive")
        self.clock = clock
        self.bytes_per_s = bytes_per_s
        self.chunk_bytes = chunk_bytes
        self.max_retries = max_retries
        self.burst_bytes = float(burst_bytes if burst_bytes is not None
                                 else chunk_bytes)
        self.sleep = sleep
        self._tokens = 0.0
        self._last_refill = clock.now()
        self._xfer_bytes = None
        self._xfer_seconds = None
        if registry is not None:
            self._xfer_bytes = registry.counter(
                "mingpt_fleet_xfer_bytes_total",
                help="transfer-channel bytes shipped cross-host (includes "
                     "retried chunks — bytes that crossed the wire)",
                labels=("paced",))
            self._xfer_seconds = registry.histogram(
                "mingpt_fleet_xfer_seconds",
                help="end-to-end paced transfer durations on the fleet "
                     "clock",
                labels=("paced",))
            for paced in ("true", "false"):
                self._xfer_bytes.labels(paced=paced).inc(0)

    @property
    def _paced_label(self) -> str:
        return "true" if self.bytes_per_s is not None else "false"

    def _wait(self, dt: float) -> None:
        if dt <= 0:
            return
        if self.sleep is not None:
            self.sleep(dt)
        else:
            self.clock.advance(dt)

    def charge(self, nbytes: int, extra_s: float = 0.0) -> None:
        """Block (virtually or really) until ``nbytes`` fit the budget.
        ``extra_s`` is injected link latency — it is waited but does NOT
        refill the bucket: latency is not bandwidth."""
        if self.bytes_per_s is not None:
            now = self.clock.now()
            self._tokens = min(
                self.burst_bytes,
                self._tokens + (now - self._last_refill) * self.bytes_per_s)
            self._last_refill = now
        if extra_s > 0:
            self._wait(extra_s)
            if self.bytes_per_s is not None:
                self._last_refill = self.clock.now()
        if self.bytes_per_s is None or nbytes <= 0:
            return
        if self._tokens < nbytes:
            self._wait((nbytes - self._tokens) / self.bytes_per_s)
            self._last_refill = self.clock.now()
            self._tokens = float(nbytes)
        self._tokens -= nbytes

    def send(self, link, blob: bytes, xfer_id: str, src: str, dst: str,
             net: Optional[NetworkFaultInjector] = None,
             auth: Optional[FleetAuth] = None,
             meta_extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Ship ``blob`` to the peer behind ``link`` in paced, digested,
        individually-acked chunks. Returns a transfer report (the final
        ack rides in ``"ack"`` — for a migration it carries the install
        result). Raises :class:`PacedTransferError` when any single
        chunk exhausts ``max_retries``."""
        chunks = [blob[i:i + self.chunk_bytes]
                  for i in range(0, len(blob), self.chunk_bytes)] or [b""]
        start = self.clock.now()
        # every transfer starts with an EMPTY bucket: idle time between
        # transfers never becomes burst credit, so a paced transfer of B
        # bytes takes exactly B/bytes_per_s (+ injected latency) — the
        # deterministic budget the tests hold
        self._tokens = 0.0
        self._last_refill = start
        retries = 0
        last_ack: Dict[str, Any] = {}
        seq = 0
        while seq < len(chunks):
            chunk = chunks[seq]
            for attempt in itertools.count():
                def _retry(why: str) -> None:
                    nonlocal retries
                    retries += 1
                    if attempt >= self.max_retries:
                        raise PacedTransferError(
                            f"transfer {xfer_id} chunk {seq}/{len(chunks)} "
                            f"({src}->{dst}) failed after "
                            f"{attempt + 1} attempts: {why}")
                extra_s = 0.0
                if net is not None:
                    try:
                        extra_s = net.link_verdict(src, dst)
                    except LinkPartitioned as e:
                        _retry(str(e))
                        continue
                # the chunk occupies the link whether or not it survives:
                # pace first, then roll the drop dice
                self.charge(len(chunk), extra_s)
                if self._xfer_bytes is not None:
                    self._xfer_bytes.labels(paced=self._paced_label).inc(
                        len(chunk))
                if net is not None and net.frame_verdict(src, dst):
                    _retry("frame dropped in flight")
                    continue
                meta = envelope(
                    "xfer_chunk", xfer_id=xfer_id, seq=seq,
                    n_chunks=len(chunks),
                    digest=hashlib.sha256(chunk).hexdigest(),
                    total_bytes=len(blob), **(meta_extra or {}))
                if auth is not None:
                    auth.sign(meta)
                try:
                    ack = link.post_bytes("/host/xfer_chunk",
                                          pack_frames([(meta, chunk)]))
                except (TransportError, EnvelopeError) as e:
                    _retry(repr(e))
                    continue
                if ack.get("kind") != "xfer_ack" or not ack.get("ok"):
                    _retry(f"peer NACK: {ack.get('message', ack.get('kind'))}")
                    continue
                if auth is not None:
                    try:
                        auth.verify(ack)
                    except AuthError as e:
                        _retry(f"unverifiable ack: {e}")
                        continue
                last_ack = ack
                break
            seq += 1
        elapsed = self.clock.now() - start
        if self._xfer_seconds is not None:
            self._xfer_seconds.labels(paced=self._paced_label).observe(
                elapsed)
        return {"xfer_id": xfer_id, "bytes": len(blob),
                "chunks": len(chunks), "retries": retries,
                "transfer_s": elapsed, "ack": last_ack}


# ---------------------------------------------------------------------
# HostAgent — one host's membership, auth, and serving authority
# ---------------------------------------------------------------------

class HostAgent:
    """One host in the mesh: owns the local router/supervisor, beats its
    roster peers on the injected clock, tracks their state ladder, and
    — critically — refuses to admit new work the moment it cannot see a
    quorum of the roster (the first half of split-brain prevention; the
    frontend's emission fence is the second)."""

    def __init__(self, host: str, router, roster, clock,
                 secret: Optional[str] = None, registry=None,
                 heartbeat_interval_s: float = 0.05,
                 suspect_after_s: Optional[float] = None,
                 quarantine_after_s: Optional[float] = None,
                 dead_after_s: Optional[float] = None,
                 recover_beats: int = 2,
                 quorum: Optional[int] = None):
        if host not in roster:
            raise ValueError(f"host {host!r} is not in its own roster")
        self.host = host
        self.router = router
        self.roster = sorted(roster)
        self.clock = clock
        self.registry = (registry if registry is not None
                         else router.supervisor.registry)
        self.heartbeat_interval_s = heartbeat_interval_s
        # one missed beat can never suspect a peer: the earliest rung of
        # the ladder sits past two intervals
        self.suspect_after_s = (suspect_after_s if suspect_after_s
                                is not None else 2.5 * heartbeat_interval_s)
        self.quarantine_after_s = (quarantine_after_s if quarantine_after_s
                                   is not None else 5.0 * heartbeat_interval_s)
        self.dead_after_s = (dead_after_s if dead_after_s is not None
                             else 10.0 * heartbeat_interval_s)
        self.recover_beats = recover_beats
        self.quorum = (quorum if quorum is not None
                       else len(self.roster) // 2 + 1)
        self.auth: Optional[FleetAuth] = None
        if secret:
            self.auth = FleetAuth(secret, sender=host,
                                  registry=self.registry)
        self.alive = True
        self.epoch = 0
        self._seq = 0
        self._next_beat = clock.now()
        self.links: Dict[str, Any] = {}
        #: peer -> {"last_contact", "state", "good_beats"}
        self.peers: Dict[str, Dict[str, Any]] = {}
        #: in-flight chunked transfers: xfer_id -> {"meta", "chunks"}
        self._xfers: Dict[str, Dict[str, Any]] = {}
        self._hosts_gauge = self.registry.gauge(
            "mingpt_fleet_hosts",
            help="roster hosts by membership state, from this host's "
                 "view (self counts as alive while serving)",
            labels=("state",))
        for state in _HOST_STATES:
            self._hosts_gauge.labels(state=state).set(0)
        # same family FleetAuth bumps — registered here too so the
        # reasons pre-exist on the scrape even before a first reject,
        # and so the digest NACK path can count without auth enabled
        self._rejects = self.registry.counter(
            "mingpt_fleet_auth_rejects_total",
            help=_AUTH_REJECTS_HELP, labels=("reason",))
        for reason in ("unsigned", "bad_mac", "replay", "frame_digest"):
            self._rejects.labels(reason=reason).inc(0)

    # -- membership -------------------------------------------------------
    def connect(self, links: Dict[str, Any]) -> None:
        """Wire peer links (host -> link object). Every roster peer is
        seeded ``alive`` as of now — the ladder needs silence to
        degrade, not evidence to trust."""
        self.links = dict(links)
        now = self.clock.now()
        for peer in self.roster:
            if peer == self.host:
                continue
            self.peers[peer] = {"last_contact": now, "state": "alive",
                                "good_beats": 0}

    def record_contact(self, peer: str) -> None:
        st = self.peers.get(peer)
        if st is None:
            return  # not in the roster: membership is static, ignore
        st["last_contact"] = self.clock.now()
        st["good_beats"] += 1

    def beat(self) -> None:
        """Send one heartbeat round when the interval has elapsed. A
        peer that can't be reached (partition, dead host, bad auth on
        the ack) simply misses contact — the ladder, not this method,
        decides what that means."""
        now = self.clock.now()
        if now < self._next_beat:
            return
        self._next_beat = now + self.heartbeat_interval_s
        for peer in sorted(self.links):
            self._seq += 1
            doc = envelope("heartbeat", host=self.host, epoch=self.epoch,
                           seq=self._seq)
            if self.auth is not None:
                self.auth.sign(doc)
            try:
                ack = self.links[peer].call("/host/heartbeat", doc)
            except (TransportError, EnvelopeError):
                continue  # missed beat
            if ack.get("kind") != "heartbeat_ack":
                continue  # peer rejected us (auth / drift): no contact
            if self.auth is not None:
                try:
                    self.auth.verify(ack)
                except AuthError:
                    continue
            self.epoch = max(self.epoch, ack["epoch"])
            self.record_contact(peer)

    def refresh_peer_states(self) -> None:
        """Advance the ladder from elapsed silence. Recovery out of
        quarantined/dead requires ``recover_beats`` consecutive good
        beats (hysteresis); suspect recovers immediately — it is the
        'one more missed beat and I worry' rung, not a verdict."""
        now = self.clock.now()
        for peer in sorted(self.peers):
            st = self.peers[peer]
            elapsed = now - st["last_contact"]
            if elapsed >= self.dead_after_s:
                cand = "dead"
            elif elapsed >= self.quarantine_after_s:
                cand = "quarantined"
            elif elapsed >= self.suspect_after_s:
                cand = "suspect"
            else:
                cand = "alive"
            if cand != "alive":
                st["good_beats"] = 0
            elif (st["state"] in ("quarantined", "dead")
                    and st["good_beats"] < self.recover_beats):
                cand = st["state"]  # hold the verdict until proven
            st["state"] = cand

    def has_quorum(self) -> bool:
        """Can this host see a majority of the roster (itself
        included)? Quorum is over *alive* peers only — a suspect peer
        already doesn't count, which is what makes 'stop admitting
        within one heartbeat deadline' hold."""
        seen = 1 + sum(1 for st in self.peers.values()
                       if st["state"] == "alive")
        return seen >= self.quorum

    @property
    def admitting(self) -> bool:
        return self.alive and self.has_quorum()

    # -- serving ----------------------------------------------------------
    def submit(self, request: Request):
        if not self.admitting:
            raise ShedError(
                f"host {self.host} cannot see a quorum of "
                f"{self.roster} — refusing to admit (split-brain guard)",
                reason="no_quorum")
        return self.router.submit(request)

    def kill_host(self) -> None:
        """The whole machine dies: every local replica SIGKILLed, the
        agent stops beating and answering. Used by ``host_kill`` chaos
        and the serve.py drill."""
        self.alive = False
        for rep in self.router.supervisor.replicas:
            if rep.state != "drained" and rep.backend is not None:
                try:
                    rep.backend.sigkill()
                except OSError:
                    pass

    def step(self) -> bool:
        """One host round: beat → ladder → gauges → local router round.
        A dead host does nothing (its peers' ladders do the talking)."""
        if not self.alive:
            return False
        self.beat()
        self.refresh_peer_states()
        counts = {state: 0 for state in _HOST_STATES}
        counts["alive"] = 1  # self
        for st in self.peers.values():
            counts[st["state"]] += 1
        for state, n in counts.items():
            self._hosts_gauge.labels(state=state).set(n)
        return self.router.step()

    # -- the host RPC surface ---------------------------------------------
    def handle_host(self, path: str, body: bytes) -> bytes:
        """Serve one peer call. Auth/validation failures answer with an
        ``error`` envelope (the counter was already bumped by
        FleetAuth) — byte-faithful to what a socket server would
        return, so loopback drills exercise the reject path exactly."""
        try:
            if path == "/host/heartbeat":
                return self._handle_heartbeat(body)
            if path == "/host/xfer_chunk":
                return self._handle_xfer_chunk(body)
            return self._error_bytes("not_found",
                                     f"unknown host path {path!r}")
        except (AuthError, EnvelopeError) as e:
            return self._error_bytes(type(e).__name__, str(e))

    @staticmethod
    def _to_bytes(doc: Dict[str, Any]) -> bytes:
        return json.dumps(doc, sort_keys=True).encode()

    def _error_bytes(self, error: str, message: str) -> bytes:
        return self._to_bytes({"schema": RPC_SCHEMA, "kind": "error",
                               "error": error, "message": message})

    def _handle_heartbeat(self, body: bytes) -> bytes:
        doc = validate_envelope(json.loads(body.decode()),
                                kind="heartbeat")
        if self.auth is not None:
            self.auth.verify(doc)
        self.record_contact(doc["host"])
        self.epoch = max(self.epoch, doc["epoch"])
        ack = envelope("heartbeat_ack", host=self.host, epoch=self.epoch,
                       seq=doc["seq"])
        if self.auth is not None:
            self.auth.sign(ack)
        return self._to_bytes(ack)

    def _handle_xfer_chunk(self, body: bytes) -> bytes:
        frames = unpack_frames(body)
        if len(frames) != 1:
            raise EnvelopeError(
                f"xfer_chunk carries exactly one frame, got {len(frames)}")
        meta, chunk = frames[0]
        validate_envelope(meta, kind="xfer_chunk")
        if self.auth is not None:
            self.auth.verify(meta)
        xfer_id, seq = meta["xfer_id"], meta["seq"]
        if hashlib.sha256(chunk).hexdigest() != meta["digest"]:
            # corrupted in flight: NACK so the sender retries this chunk;
            # counted under the auth-rejects family (reason=frame_digest)
            self._rejects.labels(reason="frame_digest").inc()
            return self._ack_bytes(xfer_id, seq, ok=False,
                                   message="frame digest mismatch")
        st = self._xfers.setdefault(xfer_id, {"meta": meta, "chunks": {}})
        st["chunks"][seq] = chunk
        extra: Dict[str, Any] = {"complete": False}
        if len(st["chunks"]) == meta["n_chunks"]:
            blob = b"".join(st["chunks"][i]
                            for i in range(meta["n_chunks"]))
            del self._xfers[xfer_id]
            extra["complete"] = True
            if meta.get("purpose") == "migrate":
                extra.update(self._install_migration(meta, blob))
        return self._ack_bytes(xfer_id, seq, ok=True, **extra)

    def _ack_bytes(self, xfer_id: str, seq: int, ok: bool,
                   **extra: Any) -> bytes:
        ack = envelope("xfer_ack", xfer_id=xfer_id, seq=seq, ok=ok,
                       **extra)
        if self.auth is not None:
            self.auth.sign(ack)
        return self._to_bytes(ack)

    def _install_migration(self, meta: Dict[str, Any],
                           blob: bytes) -> Dict[str, Any]:
        """A fully reassembled migration blob: install into the named
        (or least-loaded ready) local replica. An install failure is
        reported in the ack, NOT as a transport failure — the transfer
        itself succeeded, retrying chunks would not help."""
        sup = self.router.supervisor
        dst = None
        if meta.get("dst_replica"):
            dst = sup.replica_by_name(meta["dst_replica"])
        else:
            cands = [r for r in sup.ready_replicas()
                     if not getattr(r, "draining", False)]
            dst = min(cands, key=lambda r: (r.load, r.index), default=None)
        if dst is None or dst.state != "ready":
            return {"install_error": "no ready replica to install into",
                    "installed": 0, "skipped": 0, "draft_installed": 0}
        try:
            resp = self.router.install_migrate_blob(dst, blob)
        except (TransportError, EnvelopeError) as e:
            return {"install_error": repr(e), "installed": 0,
                    "skipped": 0, "draft_installed": 0}
        return {"installed": resp["installed"],
                "skipped": resp["skipped"],
                "draft_installed": resp.get("draft_installed", 0),
                "to_replica": dst.name}


# ---------------------------------------------------------------------
# CrossHostRouter — the fleet frontend over the mesh
# ---------------------------------------------------------------------

@dataclass
class CrossHandle:
    """Host-independent view of one request routed through the mesh.
    ``tokens`` is the caller-visible stream: append-only, deduped
    across retries AND fenced against stale hosts."""

    request: Request
    request_id: str
    submit_time: float = 0.0
    tokens: List[int] = field(default_factory=list)
    finished: bool = False
    finish_reason: Optional[str] = None
    error: Optional[str] = None
    current_host: Optional[str] = None
    #: (host, local fleet request_id) of the CURRENT attempt — tokens
    #: from any other key are stale by definition
    local_key: Optional[Tuple[str, str]] = None
    fence_epoch: int = 0
    attempts: int = 1                     # host placements so far
    hosts: List[str] = field(default_factory=list)
    duplicates_suppressed: int = 0
    fenced: int = 0                       # stale-host emissions dropped
    fault_at: Optional[float] = None
    recovery_s: Optional[float] = None
    failed_from: Optional[str] = None
    first_token_time: Optional[float] = None
    last_token_time: Optional[float] = None


class CrossHostRouter:
    """Routes requests over the :class:`HostAgent` mesh and owns the
    second half of split-brain prevention: the emission fence.

    Token emissions are *collected*, not streamed through: each local
    router's ``on_token`` hook appends ``(host, epoch-at-emit,
    local_request_id, index, token)`` and :meth:`step` replays them in
    deterministic order — dropping (and counting) any emission whose
    (host, attempt) is no longer the request's current placement or
    whose epoch sits below the request's fence. A partitioned host can
    decode all it wants; its tokens cannot reach the caller twice.

    Cross-host failover: when every quorate peer's ladder holds a host
    at ``quarantined``/``dead``, the host is declared failed — the
    fleet epoch bumps, pushes to the quorate hosts, and every unfinished
    request placed there re-submits on the least-loaded admitting host
    with ``recovery_log`` path ``crosshost`` stamped on its first
    post-fault token."""

    def __init__(self, agents: Dict[str, "HostAgent"], clock,
                 net: Optional[NetworkFaultInjector] = None,
                 on_token: Optional[Callable[[CrossHandle, int],
                                             None]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 max_failovers: int = 2,
                 paced: Optional[PacedChannel] = None):
        self.agents = dict(agents)
        self.clock = clock
        self.net = net
        self.on_token = on_token
        self.registry = registry if registry is not None else MetricsRegistry()
        self.max_failovers = max_failovers
        self.paced = (paced if paced is not None
                      else PacedChannel(clock, registry=self.registry))
        self.fleet_epoch = 0
        self.handles: Dict[str, CrossHandle] = {}
        #: (host, local request_id) -> (CrossHandle, local FleetHandle)
        self._local: Dict[Tuple[str, str], Tuple[CrossHandle, Any]] = {}
        self._emissions: List[Tuple[str, int, str, int, int]] = []
        self._pending: List[CrossHandle] = []
        self._declared_failed: set = set()
        self._ids = itertools.count()
        self._xfer_ids = itertools.count()
        self._fenced = self.registry.counter(
            "mingpt_fleet_fenced_emissions_total",
            help="stale-host token emissions dropped at the frontend "
                 "fence (the cross-host zero-double-emit invariant)",
            labels=("host",))
        self._failovers = self.registry.counter(
            "mingpt_fleet_crosshost_failovers_total",
            help="requests re-placed on a surviving host after their "
                 "host was declared failed by the quorate ladder view",
            labels=("from_host",))
        self._requests = self.registry.counter(
            "mingpt_fleet_cross_requests_total",
            help="cross-host routed requests by terminal outcome",
            labels=("outcome",))
        for outcome in ("completed", "deadline", "error"):
            self._requests.labels(outcome=outcome).inc(0)
        for host in sorted(self.agents):
            self._fenced.labels(host=host).inc(0)
            self._failovers.labels(from_host=host).inc(0)
            self.agents[host].router.on_token = self._make_collector(host)

    def _make_collector(self, host: str):
        agent = self.agents[host]

        def collect(fh, token: int) -> None:
            # epoch is captured AT EMIT TIME: tokens computed behind a
            # partition carry the stale epoch even if processed after
            self._emissions.append(
                (host, agent.epoch, fh.request_id, len(fh.tokens) - 1,
                 token))
        return collect

    # -- admission --------------------------------------------------------
    def _admitting_agents(self, prefer: Optional[str] = None,
                          avoid: Optional[str] = None) -> List["HostAgent"]:
        cands = [a for a in self.agents.values()
                 if a.admitting and a.host != avoid]
        cands.sort(key=lambda a: (a.host != prefer,
                                  a.router.fleet_queue_depth()
                                  + len(a.router._attempts), a.host))
        return cands

    def submit(self, request: Request) -> CrossHandle:
        """Route one request to the least-loaded admitting host. Raises
        :class:`ShedError` (``reason="no_quorum"``) when no host can
        see a quorum — the fleet would rather refuse work than serve it
        from both sides of a partition."""
        last_shed: Optional[ShedError] = None
        for agent in self._admitting_agents():
            try:
                fh = agent.submit(request)
            except ShedError as e:
                last_shed = e
                continue
            cross = CrossHandle(
                request=request,
                request_id=f"cross-{next(self._ids)}",
                submit_time=self.clock.now(),
                current_host=agent.host,
                local_key=(agent.host, fh.request_id))
            cross.hosts.append(agent.host)
            self.handles[cross.request_id] = cross
            self._local[cross.local_key] = (cross, fh)
            return cross
        if last_shed is not None:
            raise last_shed
        raise ShedError(
            "no host can see a quorum — refusing to admit into a "
            "partitioned fleet", reason="no_quorum")

    def _resubmit(self, cross: CrossHandle, prefer: Optional[str] = None,
                  avoid: Optional[str] = None) -> bool:
        """Place an existing request on a (new) admitting host. The
        current placement changes, which fences every emission from the
        old one. Parks in the retry queue when nowhere admits."""
        for agent in self._admitting_agents(prefer=prefer, avoid=avoid):
            try:
                fh = agent.submit(cross.request)
            except ShedError:
                continue
            cross.attempts += 1
            cross.current_host = agent.host
            cross.local_key = (agent.host, fh.request_id)
            cross.hosts.append(agent.host)
            self._local[cross.local_key] = (cross, fh)
            return True
        if cross not in self._pending:
            self._pending.append(cross)
        return False

    # -- the cross-host round ---------------------------------------------
    def step(self) -> bool:
        """One mesh round: host_kill verdicts → every live agent's host
        round (sorted order — deterministic) → fence + dedup the
        collected emissions → reconcile finished local attempts →
        declare/fail-over dead hosts → retry parked requests. Returns
        True while any cross-host request is unfinished."""
        if self.net is not None:
            for host in sorted(self.agents):
                agent = self.agents[host]
                if agent.alive and self.net.host_verdict(host):
                    agent.kill_host()
        for host in sorted(self.agents):
            self.agents[host].step()
        self._process_emissions()
        self._reconcile_local()
        self._detect_failed_hosts()
        if self._pending:
            parked, self._pending = self._pending, []
            for cross in parked:
                if not cross.finished:
                    self._resubmit(cross, avoid=cross.failed_from)
        return any(not c.finished for c in self.handles.values())

    def run_until_drained(self, max_steps: Optional[int] = None) -> None:
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps >= max_steps:
                unfinished = [cid for cid, c in self.handles.items()
                              if not c.finished]
                raise RuntimeError(
                    f"cross-host fleet not drained after {max_steps} "
                    f"steps (unfinished={unfinished})")

    def _process_emissions(self) -> None:
        emissions, self._emissions = self._emissions, []
        for host, epoch, local_id, idx, token in emissions:
            entry = self._local.get((host, local_id))
            if entry is None:
                continue  # not cross-managed (or already reconciled away)
            cross, _fh = entry
            if cross.finished:
                continue
            if ((host, local_id) != cross.local_key
                    or epoch < cross.fence_epoch):
                # THE fence: a stale placement (failed-over request) or
                # a stale epoch (partitioned-then-healed host) can never
                # reach the caller — counted, never delivered
                cross.fenced += 1
                self._fenced.labels(host=host).inc()
                continue
            if idx < len(cross.tokens):
                # a re-routed attempt re-deriving tokens the caller
                # already saw — deterministic decode makes them equal
                cross.duplicates_suppressed += 1
                continue
            if idx > len(cross.tokens):
                raise RuntimeError(
                    f"{cross.request_id}: stream gap — emission index "
                    f"{idx} with {len(cross.tokens)} tokens delivered")
            cross.tokens.append(token)
            now = self.clock.now()
            if cross.first_token_time is None:
                cross.first_token_time = now
            cross.last_token_time = now
            if cross.fault_at is not None:
                # first NEW caller-visible token since the host fault:
                # the cross-host recovery tail, logged on the ADOPTING
                # host's supervisor under path="crosshost"
                rec = now - cross.fault_at
                cross.recovery_s = rec
                cross.fault_at = None
                sup = self.agents[host].router.supervisor
                info = {"replica": cross.failed_from, "path": "crosshost",
                        "recovery_s": rec, "adopted": host}
                sup.recovery_log.append(info)
                sup._recovery.labels(path="crosshost").observe(rec)
            if self.on_token is not None:
                self.on_token(cross, token)

    def _finalize(self, cross: CrossHandle, reason: str) -> None:
        cross.finished = True
        cross.finish_reason = reason
        outcome = "completed" if reason in ("length", "eos") else reason
        self._requests.labels(outcome=outcome).inc()

    def _reconcile_local(self) -> None:
        for key in list(self._local.keys()):
            cross, fh = self._local[key]
            if not fh.finished:
                continue
            del self._local[key]
            if key != cross.local_key or cross.finished:
                continue  # a stale attempt concluded: nothing to adopt
            if fh.finish_reason in ("length", "eos"):
                self._finalize(cross, fh.finish_reason)
            elif fh.finish_reason == "deadline":
                self._finalize(cross, "deadline")
            else:  # local error, retries exhausted on that host
                cross.error = repr(fh.error) if fh.error else "error"
                if cross.attempts > self.max_failovers:
                    self._finalize(cross, "error")
                else:
                    self._resubmit(cross)

    def _detect_failed_hosts(self) -> None:
        """Declare a host failed when every *quorate* peer's ladder
        holds it at quarantined/dead — one suspicious peer is a flaky
        link, unanimity among hosts that can see a majority is a
        verdict. Healing (all quorate views back to alive, which the
        per-agent hysteresis already gates) lifts the declaration."""
        now = self.clock.now()
        quorate = {h: a for h, a in sorted(self.agents.items())
                   if a.alive and a.has_quorum()}
        for host in sorted(self.agents):
            views = [qa.peers[host]["state"]
                     for qh, qa in quorate.items()
                     if qh != host and host in qa.peers]
            if not views:
                continue
            if host in self._declared_failed:
                if all(v == "alive" for v in views):
                    self._declared_failed.discard(host)
                continue
            if not all(v in ("quarantined", "dead") for v in views):
                continue
            self._declared_failed.add(host)
            # epoch fence: everything the failed host computes from here
            # on is behind this number
            self.fleet_epoch = max(
                [self.fleet_epoch] + [a.epoch for a in quorate.values()]
            ) + 1
            for agent in quorate.values():
                agent.epoch = max(agent.epoch, self.fleet_epoch)
            for cross in self.handles.values():
                if cross.finished or cross.current_host != host:
                    continue
                if cross.fault_at is None:
                    cross.fault_at = now
                cross.fence_epoch = self.fleet_epoch
                cross.failed_from = host
                self._failovers.labels(from_host=host).inc()
                self._resubmit(cross, avoid=host)

    # -- cross-host migration ---------------------------------------------
    def migrate_crosshost(self, src_host: str, dst_host: str,
                          replica: Optional[str] = None,
                          dst_replica: Optional[str] = None,
                          ) -> Dict[str, Any]:
        """Live-migrate one replica's KV/prefix/draft state from
        ``src_host`` to ``dst_host`` through the paced channel, re-route
        its in-flight requests to the destination host, and retire the
        source replica. A failed transfer (exhausted chunk retries, or
        an install error on the far side) degrades to plain re-route —
        ``outcome="failed"`` on the migration counter, zero requests
        lost. Returns a ``mingpt-migrate-crosshost/1`` report."""
        if src_host == dst_host:
            raise ValueError("cross-host migration needs two hosts; use "
                             "migrate_and_drain for a local move")
        src_agent = self.agents[src_host]
        dst_agent = self.agents[dst_host]
        if not dst_agent.alive:
            raise ValueError(f"destination host {dst_host!r} is down")
        router = src_agent.router
        sup = router.supervisor
        if replica is not None:
            src_rep = sup.replica_by_name(replica)
        else:
            cands = [r for r in sup.ready_replicas()
                     if not getattr(r, "draining", False)]
            src_rep = max(cands, key=lambda r: (r.load, -r.index),
                          default=None)
        if src_rep is None or src_rep.state != "ready":
            raise ValueError(
                f"no ready replica to migrate off {src_host!r}")
        src_rep.draining = True
        blob = router.export_migrate_blob(src_rep)
        xfer_id = f"xfer-{src_host}-{next(self._xfer_ids)}"
        meta_extra: Dict[str, Any] = {"purpose": "migrate"}
        if dst_replica is not None:
            meta_extra["dst_replica"] = dst_replica
        outcome, error = "ok", None
        xfer: Dict[str, Any] = {"bytes": len(blob), "chunks": 0,
                                "retries": 0, "transfer_s": 0.0,
                                "ack": {}}
        try:
            xfer = self.paced.send(
                src_agent.links[dst_host], blob, xfer_id, src_host,
                dst_host, net=self.net, auth=src_agent.auth,
                meta_extra=meta_extra)
        except (PacedTransferError, TransportError, EnvelopeError) as e:
            outcome, error = "failed", repr(e)
        ack = xfer.get("ack") or {}
        if outcome == "ok" and ack.get("install_error"):
            outcome, error = "failed", ack["install_error"]
        sup._migrations.labels(outcome=outcome).inc()
        # re-route the source replica's in-flight requests onto the
        # DESTINATION host: the shipped prefix/KV state lives there now,
        # so the re-derive is a warm hit when the transfer landed
        moved: List[str] = []
        now = self.clock.now()
        for fh in router.detach_unfinished(src_rep.name,
                                           to_label=dst_host):
            entry = self._local.pop((src_host, fh.request_id), None)
            if entry is None:
                # not cross-managed (submitted straight at the local
                # router): re-queue locally, same as migrate_and_drain
                router._pending.append((fh, now))
                continue
            cross, _ = entry
            self._resubmit(cross, prefer=dst_host)
            moved.append(cross.request_id)
        info = router.drain_and_retire(src_rep)
        return {
            "schema": "mingpt-migrate-crosshost/1",
            "from_host": src_host,
            "to_host": dst_host,
            "from": src_rep.name,
            "to": ack.get("to_replica"),
            "outcome": outcome,
            "error": error,
            "bytes": xfer["bytes"],
            "chunks": xfer["chunks"],
            "retries": xfer["retries"],
            "transfer_s": xfer["transfer_s"],
            "entries_installed": ack.get("installed", 0),
            "entries_skipped": ack.get("skipped", 0),
            "draft_rows_installed": ack.get("draft_installed", 0),
            "requests_moved": sorted(moved),
            "src_exit_code": info.get("exit_code"),
        }

    # -- observability ----------------------------------------------------
    def fleet_metrics_page(self) -> str:
        """The whole mesh on one strict-parsed page: the frontend's own
        registry as-is, plus every live host's merged fleet page
        re-labelled under ``host=<name>`` (per-replica labels inside
        each host page survive — inner labels win on merge)."""
        pages: Dict[str, str] = {}
        for host in sorted(self.agents):
            agent = self.agents[host]
            if not agent.alive:
                continue
            pages[host] = agent.router.fleet_metrics_page()
        return merge_fleet_pages(render_prometheus(self.registry), pages,
                                 label="host")

    def summary(self) -> Dict[str, Any]:
        """Deterministic drill report — the byte-identity surface of the
        two-run partition drills (JSON-dump it sorted)."""
        return {
            "fleet_epoch": self.fleet_epoch,
            "declared_failed": sorted(self._declared_failed),
            "pending": len(self._pending),
            "hosts": {
                host: {
                    "alive": agent.alive,
                    "epoch": agent.epoch,
                    "admitting": agent.admitting,
                    "peers": {p: st["state"]
                              for p, st in sorted(agent.peers.items())},
                }
                for host, agent in sorted(self.agents.items())
            },
            "requests": {
                cid: {
                    "finish_reason": c.finish_reason,
                    "n_tokens": len(c.tokens),
                    "hosts": list(c.hosts),
                    "attempts": c.attempts,
                    "duplicates_suppressed": c.duplicates_suppressed,
                    "fenced": c.fenced,
                    "recovered": c.recovery_s is not None,
                }
                for cid, c in sorted(self.handles.items())
            },
        }


# ---------------------------------------------------------------------
# Loopback mesh builder — multi-host drills without sockets
# ---------------------------------------------------------------------

def build_loopback_fleet(params, cfg, n_hosts: int = 2,
                         n_replicas: int = 2, clock=None,
                         secret: Optional[str] = None,
                         net_faults: Optional[str] = None,
                         heartbeat_interval_s: float = 0.05,
                         quorum: Optional[int] = None,
                         on_token=None,
                         paced_bytes_per_s: Optional[float] = None,
                         max_failovers: int = 2,
                         server_kwargs: Optional[Dict[str, Any]] = None,
                         supervisor_kwargs: Optional[Dict[str, Any]] = None,
                         router_kwargs: Optional[Dict[str, Any]] = None,
                         agent_kwargs: Optional[Dict[str, Any]] = None,
                         ) -> Tuple[CrossHostRouter,
                                    Dict[str, HostAgent],
                                    NetworkFaultInjector]:
    """Wire an entire multi-host mesh in one process: per host a fresh
    registry + ProcessSupervisor (loopback backends) + ProcRouter +
    HostAgent, full-mesh :class:`~.transport.LoopbackHostLink` wiring
    through one shared :class:`NetworkFaultInjector`, and a
    :class:`CrossHostRouter` frontend — all on one shared clock, so a
    drill replayed with the same faults is byte-identical. Returns
    ``(frontend, agents, net)``."""
    from mingpt_distributed_tpu_torch.serving.procfleet.supervisor import (
        ProcessSupervisor,
        ProcRouter,
        loopback_backend_factory,
    )
    from mingpt_distributed_tpu_torch.serving.procfleet.transport import (
        LoopbackHostLink,
    )

    if clock is None:
        clock = VirtualClock(tick_s=0.001)
    net = NetworkFaultInjector(net_faults if net_faults is not None
                               else "", clock=clock)
    roster = [f"host{i}" for i in range(n_hosts)]
    agents: Dict[str, HostAgent] = {}
    for host in roster:
        sup = ProcessSupervisor(
            loopback_backend_factory(params, cfg,
                                     **(server_kwargs or {})),
            n_replicas=n_replicas, clock=clock,
            registry=MetricsRegistry(),
            **(supervisor_kwargs or {}))
        router = ProcRouter(sup, **(router_kwargs or {}))
        agents[host] = HostAgent(
            host, router, roster, clock, secret=secret,
            heartbeat_interval_s=heartbeat_interval_s, quorum=quorum,
            **(agent_kwargs or {}))
    for src in roster:
        agents[src].connect({
            dst: LoopbackHostLink(src, dst, agents[dst], net=net)
            for dst in roster if dst != src})
    frontend = CrossHostRouter(
        agents, clock, net=net, on_token=on_token,
        max_failovers=max_failovers)
    frontend.paced = PacedChannel(clock, bytes_per_s=paced_bytes_per_s,
                                  registry=frontend.registry)
    return frontend, agents, net
