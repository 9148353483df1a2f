"""The command channel of a tensor-parallel serving group.

The JAX package serves one model across a tp mesh from one controller:
GSPMD runs every engine call on every device. PyTorch has no such
controller, so the port runs one process per tp rank and keeps them in
lockstep: the group's first rank, the **driver**, owns the scheduler, the
sampler, the prefix store's keys and the metrics, and before each engine
call it broadcasts one command (a fixed 64-integer header, the call's small
integer arguments inline when they fit, and an optional byte payload) over
the mesh's ``cmd_group``. Every other rank, a **follower**, runs
``DecodeEngine.follow``: it receives one command at a time and runs the same
call on its own shard, joining the forward's collectives on the mesh's
``tp_group``. The tokens the driver samples reach the followers in the next
command; followers never sample.

Failure is loud, never a fallback:

* a follower that raises exits its process; the driver's next collective
  on ``tp_group`` then fails (at once on a closed socket, after the mesh's
  ``timeout_s`` at the latest) and the driver raises ``LockstepError``,
  after which the channel refuses every further call;
* a header with the wrong magic or sequence number, or a command for an
  engine the follower does not hold, raises ``LockstepError`` there;
* a spawned follower (``TPGroup``) watches its driver's process and exits
  (code 1) within ``PARENT_POLL_S`` of the driver's death, SIGKILL
  included, wherever in ``follow`` it waits;
* an engine call that needs the group run outside the channel's dispatch
  (``Channel.active`` is 0: a call the driver forgot to mirror) raises
  ``LockstepError`` at once instead of waiting on peers that will never
  join.

The payload helpers (``send_tensors``, ``recv_tensors``) move a list of
tensors between two ranks as one byte buffer on the host: a build's
parameter shards and migration's K/V rows.

``TPGroup`` is how one process serves at tp = N (the serve CLI): it
becomes the driver, rank 0, and spawns N - 1 follower processes on this
host that join a process group with it and run ``DecodeEngine.follow``.
With ``replicas`` R it drives R such groups (a fleet of tp replicas), each
of its own N - 1 followers: 1 + R (N - 1) ranks, group i the driver and
ranks 1 + i (N - 1) ... (i + 1)(N - 1). Under ``nccl`` each rank takes its
own GPU (``cuda:rank``); under ``gloo`` the ranks share the requested
device (one card, or the CPU).
"""

from __future__ import annotations

import os
import pickle
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mingpt_distributed_tpu_torch.parallel import distributed

MAGIC = 0x6D696E677074  # "mingpt"
HEADER = 64
_FIXED = 6  # magic, sequence, op, engine, integer count, payload bytes
INLINE = HEADER - _FIXED

#: how often a spawned follower checks that its driver's process lives
PARENT_POLL_S = 0.5

OPS = ("build", "prefill", "decode", "verify", "prefix_save", "prefix_load",
       "extract", "install", "adopt", "slot", "warm", "report", "shutdown")
OP = {name: i for i, name in enumerate(OPS)}


class LockstepError(Exception):
    """A tp serving group fell out of step or lost a rank. Deliberately not
    a RuntimeError: the serving loops that survive a failed request must
    not survive this."""


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes, in order, as one uint8 tensor on the host."""
    parts = [t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
             for t in tensors]
    return torch.cat(parts) if parts else torch.empty(0, dtype=torch.uint8)


def _unpack(buf: torch.Tensor, likes: Sequence[Tuple[tuple, torch.dtype]]
            ) -> List[torch.Tensor]:
    out, at = [], 0
    for shape, dtype in likes:
        n = int(np.prod(shape, dtype=np.int64)) * torch.empty(0, dtype=dtype).element_size()
        out.append(buf[at:at + n].clone().view(dtype).reshape(shape))
        at += n
    if at != buf.numel():
        raise LockstepError(f"payload of {buf.numel()} bytes, expected {at}")
    return out


def _nbytes(likes) -> int:
    return sum(int(np.prod(s, dtype=np.int64)) * torch.empty(0, dtype=d).element_size()
               for s, d in likes)


class Channel:
    """One serving mesh's command channel (one per mesh and process:
    ``channel_for``). On the driver ``send`` broadcasts a command; on a
    follower ``recv`` returns the next one. ``engines`` maps a follower's
    engine ids to the engines its driver's builds made."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = mesh.cmd_group
        self.is_driver = mesh.rank == mesh.driver
        self.seq = 0
        self.next_eid = 0
        self.engines: Dict[int, Any] = {}
        self.active = 0  # depth of mirrored calls running on this rank
        self.broken: Optional[BaseException] = None

    @property
    def followers(self) -> List[int]:
        return self.mesh.ranks[1:]

    # -- commands -------------------------------------------------------
    def send(self, op: str, eid: int, ints: Sequence[int] = (),
             blob: bytes = b"") -> None:
        """Broadcast one command to the followers (driver only)."""
        if self.broken is not None:
            raise LockstepError(f"tp group {self.mesh.ranks} is broken: "
                                f"{self.broken}") from self.broken
        ints = np.asarray(list(ints), np.int64)
        head = torch.zeros(HEADER, dtype=torch.int64)
        head[:_FIXED] = torch.tensor([MAGIC, self.seq, OP[op], eid, len(ints),
                                      len(blob)])
        inline = len(ints) <= INLINE
        if inline and len(ints):
            head[_FIXED:_FIXED + len(ints)] = torch.from_numpy(ints)
        try:
            dist.broadcast(head, src=self.mesh.driver, group=self.group)
            if not inline:
                dist.broadcast(torch.from_numpy(ints), src=self.mesh.driver,
                               group=self.group)
            if blob:
                dist.broadcast(torch.frombuffer(bytearray(blob), dtype=torch.uint8),
                               src=self.mesh.driver, group=self.group)
        except Exception as e:
            self.fail(e)
            raise LockstepError(f"tp group {self.mesh.ranks}: the {op} "
                                f"command did not reach the followers: {e}") from e
        self.seq += 1

    def recv(self) -> Tuple[str, int, np.ndarray, bytes]:
        """The next command (a follower): (op, engine id, ints, payload)."""
        head = torch.empty(HEADER, dtype=torch.int64)
        dist.broadcast(head, src=self.mesh.driver, group=self.group)
        magic, seq, op, eid, n, nb = (int(v) for v in head[:_FIXED])
        if magic != MAGIC or seq != self.seq or not 0 <= op < len(OPS):
            raise LockstepError(
                f"rank {self.mesh.rank}: command header out of step (magic "
                f"{magic:#x}, sequence {seq}, expected {self.seq}, op {op})")
        if n <= INLINE:
            ints = head[_FIXED:_FIXED + n].numpy().copy()
        else:
            buf = torch.empty(n, dtype=torch.int64)
            dist.broadcast(buf, src=self.mesh.driver, group=self.group)
            ints = buf.numpy()
        blob = b""
        if nb:
            buf = torch.empty(nb, dtype=torch.uint8)
            dist.broadcast(buf, src=self.mesh.driver, group=self.group)
            blob = buf.numpy().tobytes()
        self.seq += 1
        return OPS[op], eid, ints, blob

    def fail(self, exc: BaseException) -> None:
        """Mark the group broken: every later ``send`` raises."""
        if self.broken is None:
            self.broken = exc

    # -- payloads between two ranks ---------------------------------------
    def send_tensors(self, tensors: Sequence[torch.Tensor], dst: int) -> None:
        dist.send(_pack(tensors), dst=dst, group=self.group)

    def recv_tensors(self, likes: Sequence[Tuple[tuple, torch.dtype]],
                     src: int) -> List[torch.Tensor]:
        """Tensors of the (shape, dtype)s ``likes`` from rank ``src``, on
        the host."""
        buf = torch.empty(_nbytes(likes), dtype=torch.uint8)
        dist.recv(buf, src=src, group=self.group)
        return _unpack(buf, likes)

    def send_object(self, obj: Any, dst: int) -> None:
        data = pickle.dumps(obj)
        dist.send(torch.tensor([len(data)], dtype=torch.int64), dst=dst, group=self.group)
        dist.send(torch.frombuffer(bytearray(data), dtype=torch.uint8), dst=dst,
                  group=self.group)

    def recv_object(self, src: int) -> Any:
        n = torch.empty(1, dtype=torch.int64)
        dist.recv(n, src=src, group=self.group)
        buf = torch.empty(int(n), dtype=torch.uint8)
        dist.recv(buf, src=src, group=self.group)
        return pickle.loads(buf.numpy().tobytes())


def channel_for(mesh) -> Channel:
    """The mesh's channel, made on first use."""
    ch = getattr(mesh, "channel", None)
    if ch is None:
        ch = mesh.channel = Channel(mesh)
    return ch


def release(mesh) -> bool:
    """Send the followers of ``mesh`` out of ``follow`` (the driver; a
    broken group is not told). Returns whether the command went out."""
    ch = channel_for(mesh)
    if not ch.is_driver or ch.broken is not None:
        return False
    ch.send("shutdown", -1)
    return True


def _exit_with(parent: int) -> None:
    """Exit this process (code 1) once ``parent`` is no longer its parent:
    the driver died, and nothing will ever send the next command."""
    while os.getppid() == parent:
        time.sleep(PARENT_POLL_S)
    print(f"tp follower {os.getpid()}: driver {parent} is gone; exiting",
          file=sys.stderr, flush=True)
    os._exit(1)


def group_ranks(n: int, replicas: int) -> List[List[int]]:
    """The ranks of each of ``replicas`` tp = ``n`` groups that share one
    driver, rank 0."""
    return [[0] + [1 + i * (n - 1) + j for j in range(n - 1)] for i in range(replicas)]


def _follower_main(rank: int, world: int, port: int, backend: str, device: str,
                   timeout_s: float, parent: int, groups: List[List[int]]) -> None:
    """A spawned follower: watch the driver, join the group, follow the
    driver, leave."""
    from mingpt_distributed_tpu_torch.parallel.mesh import serving_meshes
    from mingpt_distributed_tpu_torch.serving.engine import DecodeEngine

    threading.Thread(target=_exit_with, args=(parent,), daemon=True,
                     name="tp-driver-watch").start()
    os.environ.update(LOCAL_RANK=str(rank))
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    distributed.initialize(backend, timeout_s, rank=rank, world=world, port=port)
    try:
        (mesh,) = serving_meshes(groups, timeout_s).values()
        DecodeEngine.follow(mesh, distributed.device_for(backend, torch.device(device)))
    finally:
        distributed.shutdown()


class TPGroup:
    """This process as the driver of ``replicas`` tp = ``n`` serving
    groups, each with ``n - 1`` follower processes of its own (module
    docstring). ``meshes`` (one per group) and ``device`` are the driver's,
    ``mesh`` the first group's; ``close()`` releases the followers (they
    leave ``follow`` on the engine's shutdown, or are killed after
    ``grace_s``) and leaves the process group."""

    def __init__(self, n: int, backend: str, device, timeout_s: float,
                 replicas: int = 1):
        from mingpt_distributed_tpu_torch.parallel.mesh import serving_meshes
        from mingpt_distributed_tpu_torch.parallel.spawn import free_port

        if n < 2:
            raise ValueError(f"a tp group needs >= 2 ranks, got {n}")
        if distributed.world_size() > 1:
            raise RuntimeError("this process already belongs to a process group")
        requested = torch.device(device)
        port = free_port()
        groups = group_ranks(n, replicas)
        world = 1 + replicas * (n - 1)
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_follower_main, daemon=True,
                                  args=(r, world, port, backend, str(requested), timeout_s,
                                        os.getpid(), groups))
                      for r in range(1, world)]
        for p in self.procs:
            p.start()
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        distributed.initialize(backend, timeout_s, rank=0, world=world, port=port)
        by_index = serving_meshes(groups, timeout_s)
        self.meshes = [by_index[i] for i in range(replicas)]
        self.mesh = self.meshes[0]
        self.device = distributed.device_for(backend, requested)

    def close(self, grace_s: float = 30.0) -> List[Optional[int]]:
        """Release the followers from ``follow`` (unless the group broke),
        wait for them to exit (kill those still running after ``grace_s``,
        or after 5 s once the group broke: a follower that failed is on its
        way out) and leave the process group; returns their exit codes."""
        chs = [channel_for(m) for m in self.meshes]
        try:
            for m in self.meshes:
                release(m)
        finally:
            broken = any(ch.broken is not None for ch in chs)
            deadline = time.monotonic() + (min(grace_s, 5.0) if broken else grace_s)
            for p in self.procs:
                p.join(timeout=max(0.1, deadline - time.monotonic()))
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
            distributed.shutdown()
        return [p.exitcode for p in self.procs]
