"""Continuous-batching inference serving on the port's KV-cached forward.

Counterpart of ``mingpt_distributed_tpu/serving/``:

* ``SlotKVPool`` (kv_pool.py) — a fixed (L, S_slots, block_size, KV, hd)
  cache where each slot holds one in-flight request, with a deterministic
  host-side free list; ``PrefixKVStore`` is the byte-bounded LRU of
  shared-prefix KV entries behind prefix reuse.
* ``DecodeEngine`` (engine.py) — bucket-laddered prefill-at-offset, a
  one-token-per-step decode over all slots (per-slot positions and
  sampling params) and device-side prefix row copies, with a bounded set
  of input shapes for the server's lifetime. With a ``Mesh.serving`` mesh
  of tp > 1 it shards the model and the KV pool's heads over a lockstep
  group of processes: the driver's engine broadcasts every call
  (``lockstep.py``) and the other ranks run ``DecodeEngine.follow``.
* ``InferenceServer`` (scheduler.py) — the scheduler: a policy-ordered
  request queue (``AdmissionPolicy``, FIFO default), admission into free
  slots at decode-step boundaries (prefix hit → chunked prefill
  interleaved with decode → first token), retirement on per-request stop
  conditions, token streaming via callbacks and request handles.
* ``SpeculativeDecoder`` (speculative.py) — a draft model's engine with
  a mirrored slot pool proposes k tokens per greedy lane, the target
  verifies them in one forward per slot and the round emits the matching
  prefix plus the target's bonus token.
* ``quant`` (quant.py) — int8/fp8 KV payloads with power-of-two fp32 scale
  planes (``kv_dtype``).
* ``ServingMetrics`` (metrics.py) — tokens/s, queue depth, slot
  utilisation, TTFT, inter-token latency and speculation on the telemetry
  registry.

* ``Router`` / ``ReplicaSupervisor`` (fleet.py) — the in-process fleet:
  supervised replicas sharing one parameter tree behind a prefix-affinity,
  health- and breaker-aware router with idempotent retries, shedding and
  drain, on an injected clock (``VirtualClock``, ``WallClock``).

* ``ProcessSupervisor`` / ``ProcRouter`` (procfleet/) — the same fleet
  with the failure domain moved to an OS process: replicas are spawned
  worker subprocesses behind the versioned ``mingpt-rpc/1`` HTTP surface
  (with a deterministic in-process loopback twin for chaos tests),
  SIGKILL-able crash detection through the socket and waitpid, warm
  standby, the hang ladder, live KV/prefix migration, and the cross-host
  control plane (``procfleet/hostplane.py``).

``serve.py`` drives it (REPL, offline batch, ``--replicas N``,
``--isolation process``, ``--selftest``, ``--selftest-spec``,
``--selftest-quant``, ``--selftest-attrib``, ``--selftest-chaos``,
``--selftest-procfleet``, ``--selftest-standby``,
``--selftest-crosshost``, ``--mesh tp=N``, ``--selftest-sharded``) and
``traffic.py`` sweeps it (``trafficlab/``).
"""

from mingpt_distributed_tpu_torch.serving import quant  # noqa: F401
from mingpt_distributed_tpu_torch.serving.admission import (  # noqa: F401
    AdmissionPolicy,
    FifoPolicy,
    HealthAwarePolicy,
)
from mingpt_distributed_tpu_torch.serving.engine import DecodeEngine, bucket_ladder  # noqa: F401
from mingpt_distributed_tpu_torch.serving.fleet import (  # noqa: F401
    REQUEUE_EXIT_CODE,
    CircuitBreaker,
    FleetHandle,
    Replica,
    ReplicaHealth,
    ReplicaSupervisor,
    Router,
    SkewedClock,
    VirtualClock,
    WallClock,
    default_server_factory,
)
from mingpt_distributed_tpu_torch.serving.kv_pool import PrefixKVStore, SlotKVPool  # noqa: F401
from mingpt_distributed_tpu_torch.serving.lockstep import LockstepError  # noqa: F401
from mingpt_distributed_tpu_torch.serving.metrics import ServingMetrics  # noqa: F401
from mingpt_distributed_tpu_torch.serving.procfleet import (  # noqa: F401
    ProcRouter,
    ProcessSupervisor,
    loopback_backend_factory,
    process_backend_factory,
)
from mingpt_distributed_tpu_torch.serving.requests import (  # noqa: F401
    QueueFullError,
    Request,
    RequestHandle,
    ShedError,
)
from mingpt_distributed_tpu_torch.serving.scheduler import (  # noqa: F401
    InferenceServer,
    SlotTable,
)
from mingpt_distributed_tpu_torch.serving.speculative import (  # noqa: F401
    DraftEngine,
    SpeculativeDecoder,
)
