"""procfleet: process-isolated replicas over a real socket boundary, with
live KV and prefix migration, warm standby, the hang ladder and the
cross-host control plane.

Counterpart of ``mingpt_distributed_tpu/serving/procfleet/``. Layering (each
module imports only the ones above it):

* :mod:`.rpc` — the ``mingpt-rpc/1`` envelope grammar and strict validator,
  the request wire form, the size-framed transfer channel and fleet
  authentication; byte-compatible with the JAX package's.
* :mod:`.transport` — the transport seam: :class:`SocketTransport` (real
  HTTP to a subprocess), :class:`LoopbackTransport` (the byte-faithful
  in-process twin) and :class:`LoopbackHostLink` (host to host).
* :mod:`.worker` — one ``InferenceServer`` behind the RPC surface: the
  step-driven endpoint table, chunked token streaming, migration export
  and import (leaves as bytes, by dtype name), and the subprocess entry
  point (hello handshake, SIGTERM → exit 75).
* :mod:`.supervisor` — :class:`ProcReplica` / :class:`ProcessSupervisor` /
  :class:`ProcRouter`: the in-process fleet re-based onto the boundary,
  warm standby, the SIGTERM → SIGKILL ladder and ``migrate_and_drain``.
* :mod:`.hostplane` — the cross-host control plane: :class:`HostAgent`
  membership, auth and quorum per host, :class:`CrossHostRouter`
  epoch-fenced failover and paced cross-host migration,
  :class:`PacedChannel` bandwidth budgets, and the loopback multi-host
  mesh for deterministic partition drills.
"""

from mingpt_distributed_tpu_torch.serving.procfleet.hostplane import (
    CrossHandle,
    CrossHostRouter,
    HostAgent,
    PacedChannel,
    PacedTransferError,
    build_loopback_fleet,
)
from mingpt_distributed_tpu_torch.serving.procfleet.rpc import (
    AuthError,
    BadSignature,
    EnvelopeError,
    FRAME_MAGIC,
    FleetAuth,
    RPC_SCHEMA,
    ReplayedNonce,
    TransportError,
    TransportTimeout,
    TransportUnavailable,
    UnsignedEnvelope,
    canonical_bytes,
    envelope,
    pack_frames,
    request_from_wire,
    request_to_wire,
    unpack_frames,
    validate_envelope,
)
from mingpt_distributed_tpu_torch.serving.procfleet.supervisor import (
    LoopbackBackend,
    ProcReplica,
    ProcRouter,
    ProcessBackend,
    ProcessSupervisor,
    ReplicaUnreachable,
    ServerProxy,
    StandbyPool,
    loopback_backend_factory,
    process_backend_factory,
)
from mingpt_distributed_tpu_torch.serving.procfleet.transport import (
    LoopbackHostLink,
    LoopbackTransport,
    SocketTransport,
)
from mingpt_distributed_tpu_torch.serving.procfleet.worker import (
    ReplicaWorker,
    RpcHttpServer,
    cfg_to_spec,
)

__all__ = [
    "AuthError",
    "BadSignature",
    "CrossHandle",
    "CrossHostRouter",
    "EnvelopeError",
    "FRAME_MAGIC",
    "FleetAuth",
    "HostAgent",
    "LoopbackBackend",
    "LoopbackHostLink",
    "LoopbackTransport",
    "PacedChannel",
    "PacedTransferError",
    "ProcReplica",
    "ProcRouter",
    "ProcessBackend",
    "ProcessSupervisor",
    "RPC_SCHEMA",
    "ReplayedNonce",
    "ReplicaUnreachable",
    "ReplicaWorker",
    "RpcHttpServer",
    "ServerProxy",
    "SocketTransport",
    "StandbyPool",
    "TransportError",
    "TransportTimeout",
    "TransportUnavailable",
    "UnsignedEnvelope",
    "build_loopback_fleet",
    "canonical_bytes",
    "cfg_to_spec",
    "envelope",
    "loopback_backend_factory",
    "pack_frames",
    "process_backend_factory",
    "request_from_wire",
    "request_to_wire",
    "unpack_frames",
    "validate_envelope",
]
