"""The process group and the collectives the port's parallel paths use.

Counterpart of ``mingpt_distributed_tpu/parallel/distributed.py`` (the
runtime's lifecycle) and of the collectives XLA inserts for the JAX
package: ``lax.ppermute`` and ``lax.all_to_all`` become the differentiable
``ppermute`` and ``all_to_all`` here, each a ``torch.autograd.Function``
whose backward is the inverse exchange; ``all_gather`` and
``reduce_scatter`` are each other's backward (fsdp's parameter gather and
gradient reduce-scatter); ``gather_replicated``, ``copy_to_group`` and
``sum_from_group`` are tensor parallelism's (a gather whose backward keeps
this rank's slice, and Megatron's f and g); ``all_reduce`` sums gradients
and loss terms; ``reduce_to_first`` sums serving's partial logits to the
driver.

``initialize(backend)`` joins the job that ``torch.distributed.run`` (or
``spawn.run_ranks``) describes in the environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT); in a single process it does nothing,
as the JAX package's does. The backend is always named by the caller,
never chosen because another failed:

* ``nccl``: one rank per GPU (``cuda:LOCAL_RANK``);
* ``gloo``: ranks on the CPU, or several ranks sharing one GPU. The
  collectives here then copy device tensors to the host and back, so gloo's
  own CUDA support (which has no send/recv) is never needed.

Every exchange is one ``batch_isend_irecv`` of all its sends and receives,
so no rank can block on a send while its peer is sending too. Every rank of
a group must run the same exchanges in the same order, in the forward and
in the backward.

Beside the job's group, ``initialize`` opens a gloo group over the same
ranks for host-side flags (``any_rank``): they never wait for a card.
``mix_seed`` and ``dropout_base`` give each rank, pair of chunks or head
group its own dropout seed from one shared generator.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
_backend: Optional[str] = None
_host_group = None  # gloo, every rank: flags exchanged on the host

Perm = Sequence[Tuple[int, int]]  # (source, destination) ranks of a group


def initialize(backend: Optional[str] = None, timeout_s: float = 600.0, *,
               rank: Optional[int] = None, world: Optional[int] = None,
               port: Optional[int] = None) -> None:
    """Join the process group the environment describes (or ``rank``,
    ``world`` and ``port`` on 127.0.0.1, when given); a no-op when the
    world is 1, or when already joined. A job of several processes needs
    ``backend`` ("nccl" or "gloo")."""
    global _backend, _host_group
    if world is None:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 or dist.is_initialized():
        return
    if backend not in BACKENDS:
        raise ValueError(f"WORLD_SIZE={world}: name the backend, one of "
                         f"{BACKENDS} (train.py: --dist-backend), got {backend!r}")
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1") if port is None else "127.0.0.1"
    port = os.environ["MASTER_PORT"] if port is None else port
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{port}",
        rank=int(os.environ["RANK"]) if rank is None else rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    _backend = backend
    _host_group = dist.new_group(backend="gloo")


def shutdown() -> None:
    """destroy_process_group, when one was joined."""
    global _backend, _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _backend = _host_group = None


def backend() -> Optional[str]:
    """The joined group's backend; None in a single process."""
    return _backend


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def device_for(backend: Optional[str], requested: torch.device) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` under nccl; under gloo the
    requested device, CUDA ranks sharing the node's cards round-robin."""
    if backend == "nccl":
        if requested.type != "cuda":
            raise ValueError("the nccl backend runs one rank per GPU: drop "
                             "--device cpu, or use --dist-backend gloo")
        return torch.device("cuda", local_rank())
    if requested.type == "cuda" and world_size() > 1:
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return requested


def _host_hop() -> bool:
    return _backend == "gloo"


def _wire(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.cpu() if _host_hop() and x.is_cuda else x


def _global(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def _group_rank(group) -> int:
    return dist.get_rank(group)


def _group_size(group) -> int:
    return dist.get_world_size(group)


def _exchange(group, sends, recvs) -> List[torch.Tensor]:
    """One batch of point-to-point transfers within ``group``: ``sends``
    are (tensor, group rank, tag), ``recvs`` (like-tensor, group rank, tag).
    Returns the received tensors, on the like-tensors' devices."""
    ops, bufs = [], []
    for x, peer, tag in sends:
        ops.append(dist.P2POp(dist.isend, _wire(x), _global(group, peer),
                              group, tag))
    for like, peer, tag in recvs:
        wire_dev = "cpu" if _host_hop() else like.device
        buf = torch.empty(like.shape, dtype=like.dtype, device=wire_dev)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, _global(group, peer), group, tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(like.device) for b, (like, _, _) in zip(bufs, recvs)]


def send_async(group, x: torch.Tensor, peer: int, tag: int):
    """Start sending ``x`` to group rank ``peer`` and return at once: a
    handle whose ``wait()`` joins the send. Under gloo the bytes go from a
    host copy, which the handle keeps alive. The receiver takes it with
    ``_exchange(group, [], [(like, rank, tag)])``. A pipeline stage never
    blocks on a send, only on what it receives, so no two stages can wait
    for each other's sends."""
    wire = _wire(x)
    return _Pending(dist.isend(wire, _global(group, peer), group=group, tag=tag), wire)


class _Pending:
    def __init__(self, work, wire):
        self.work, self.wire = work, wire

    def wait(self) -> None:
        self.work.wait()


def _permute(group, perms: Sequence[Perm], xs: Sequence[torch.Tensor]):
    """Tensor j goes from each source to its destination in ``perms[j]``;
    a rank that no source sends to receives zeros (``lax.ppermute``)."""
    me = _group_rank(group)
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    sends, recvs, slots = [], [], []
    for j, (x, perm) in enumerate(zip(xs, perms)):
        dst = dict(perm).get(me)
        src = {d: s for s, d in perm}.get(me)
        if dst == me:
            out[j] = x.clone()
            continue
        if dst is not None:
            sends.append((x, dst, j))
        if src is not None:
            recvs.append((x, src, j))
            slots.append(j)
        else:
            out[j] = torch.zeros_like(x)
    for j, got in zip(slots, _exchange(group, sends, recvs)):
        out[j] = got
    return out


def _inverse(perms: Sequence[Perm]) -> List[List[Tuple[int, int]]]:
    return [[(d, s) for s, d in perm] for perm in perms]


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, perms, *xs):
        ctx.group, ctx.perms = group, perms
        ctx.likes = [torch.empty_like(x, device="meta") for x in xs]
        return tuple(_permute(group, perms, xs))

    @staticmethod
    def backward(ctx, *gs):
        # an unused output still takes part in the reverse exchange: its
        # peers wait for it
        dev = next((g.device for g in gs if g is not None), None)
        gs = [torch.zeros(like.shape, dtype=like.dtype, device=dev)
              if g is None else g for g, like in zip(gs, ctx.likes)]
        return (None, None, *_permute(ctx.group, _inverse(ctx.perms), gs))


def ppermute(xs: Sequence[torch.Tensor], group, perms: Sequence[Perm]
             ) -> List[torch.Tensor]:
    """Differentiable ``lax.ppermute`` of several tensors in one exchange:
    ``xs[j]`` moves along ``perms[j]``, a list of (source, destination)
    ranks of ``group``. Its backward is the inverse permutation."""
    if len(xs) != len(perms):
        raise ValueError(f"{len(xs)} tensors, {len(perms)} permutations")
    return list(_PPermute.apply(group, [list(p) for p in perms], *xs))


def shift_perm(n: int) -> List[Tuple[int, int]]:
    """The ring shift j -> j + 1 (mod n)."""
    return [(j, (j + 1) % n) for j in range(n)]


def _all_to_all(group, chunks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """chunks[r] goes to rank r; returns what each rank sent here."""
    me = _group_rank(group)
    sends = [(c, r, 0) for r, c in enumerate(chunks) if r != me]
    recvs = [(chunks[me], r, 0) for r in range(len(chunks)) if r != me]
    got = iter(_exchange(group, sends, recvs))
    return [chunks[me].clone() if r == me else next(got)
            for r in range(len(chunks))]


def _split(x: torch.Tensor, n: int, axis: int) -> List[torch.Tensor]:
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split "
                         f"into {n}")
    return [c.contiguous() for c in x.chunk(n, axis)]


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, split_axis, concat_axis, x):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        n = _group_size(group)
        return torch.cat(_all_to_all(group, _split(x, n, split_axis)), concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        n = _group_size(ctx.group)
        parts = _all_to_all(ctx.group, _split(g, n, concat_axis))
        return None, None, None, torch.cat(parts, split_axis)


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int
               ) -> torch.Tensor:
    """Differentiable tiled ``lax.all_to_all``: x is cut into n pieces
    along ``split_axis``, piece r goes to rank r, and the pieces received
    are concatenated along ``concat_axis`` in rank order. Its backward is
    the inverse all-to-all."""
    return _AllToAll.apply(group, split_axis, concat_axis, x)


def gather_tensor(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """All-gather along ``axis`` in rank order (no gradient)."""
    return torch.cat(_all_to_all(group, [x] * _group_size(group)), axis)


def _reduce_scatter(group, x: torch.Tensor, axis: int) -> torch.Tensor:
    """x cut into n pieces along ``axis``; rank r gets the sum over the
    group of everyone's piece r (no gradient)."""
    parts = _all_to_all(group, _split(x, _group_size(group), axis))
    return torch.stack(parts).sum(0)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, axis, x):
        ctx.group, ctx.axis = group, axis
        return gather_tensor(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return None, None, _reduce_scatter(ctx.group, g, ctx.axis)


def all_gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Differentiable all-gather along ``axis`` in rank order; its backward
    is the reduce-scatter: each rank's slice of the gradient summed over the
    group (the ranks computed on different data)."""
    return _AllGather.apply(group, axis, x)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, axis, x):
        ctx.group, ctx.axis = group, axis
        return _reduce_scatter(group, x, axis)

    @staticmethod
    def backward(ctx, g):
        return None, None, gather_tensor(g, ctx.group, ctx.axis)


def reduce_scatter(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Differentiable reduce-scatter: x cut into n pieces along ``axis``,
    rank r gets piece r summed over the group. Its backward is the
    all-gather."""
    return _ReduceScatter.apply(group, axis, x)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, axis, x):
        ctx.axis, ctx.n, ctx.me = axis, _group_size(group), _group_rank(group)
        return gather_tensor(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return None, None, g.chunk(ctx.n, ctx.axis)[ctx.me].contiguous()


def gather_replicated(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """All-gather along ``axis`` for a computation the group replicates (tp
    ranks on the same rows): every rank's gradient of the whole is the same,
    so the backward keeps this rank's slice and sends nothing."""
    return _GatherReplicated.apply(group, axis, x)


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of x, summed in float32, in x's dtype."""
    y = x.float().contiguous()
    if y is x:
        y = y.clone()
    all_reduce(y, group)
    return y.to(x.dtype)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, _sum_over(g, ctx.group)


class _SumFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        return _sum_over(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, g


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: identity forward; the backward sums the gradient over
    the group (each tp rank's column-parallel matmuls see only their
    columns of the replicated input's gradient)."""
    return _CopyToGroup.apply(group, x)


def sum_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the forward sums the row-parallel partial outputs over
    the group (in float32); the backward passes the replicated gradient
    through."""
    return _SumFromGroup.apply(group, x)


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``x`` over ``group`` (the world by default), in place; returns
    x. Not differentiable: it sums gradients and loss terms."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x
    wire = _wire(x)
    dist.all_reduce(wire, group=group)
    if wire is not x:
        x.copy_(wire)
    return x


def reduce_to_first(x: torch.Tensor, group) -> torch.Tensor:
    """Sum x over ``group`` into x on the group's first rank; x is
    returned, and on the other ranks its contents are undefined after the
    call. Not differentiable: serving's partial logits go to the driver."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    wire = _wire(x)
    dist.reduce(wire, dst=_global(group, 0), group=group)
    if wire is not x:
        x.copy_(wire)
    return x


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank; every rank must call it. The
    exchange runs on the host group, so it never waits for the card's
    queue."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([float(flag)])
    dist.all_reduce(t, group=_host_group)
    return t.item() > 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def mix_seed(*parts: int) -> int:
    """One 63-bit seed from integers (a base seed and coordinates)."""
    h = 0
    for p in parts:
        h = (h * 0x9E3779B97F4A7C15 + int(p) + 1) % (1 << 63)
    return h


def dropout_base(generator: torch.Generator) -> int:
    """One draw from ``generator``: the base seed of a call's masks."""
    return int(torch.randint(0, 1 << 62, (1,), generator=generator,
                             device=generator.device).item())
