"""Run one function on N local ranks, each a process of its own.

    results = run_ranks(fn, world_size, args, timeout_s=300)

Starts ``world_size`` processes (the ``spawn`` start method), gives each the
environment ``torch.distributed.run`` would (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR=127.0.0.1, a free MASTER_PORT; GLOO_SOCKET_IFNAME=lo unless
set), joins the process group with ``distributed.initialize("gloo")`` (the
ranks share this host, and its cards if they use any),
calls ``fn(rank, *args)`` and returns every rank's result in rank order.
``fn`` must be importable by name in a fresh interpreter and return a
picklable value (numpy arrays, not tensors). A rank that raises, exits or
outlives ``timeout_s`` fails the whole run: every process is stopped and
the first error is raised here.
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch.multiprocessing as mp

from mingpt_distributed_tpu_torch.parallel import distributed


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, args, results, timeout_s):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        distributed.initialize("gloo", timeout_s=timeout_s)
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        distributed.shutdown()


def run_ranks(fn: Callable[..., Any], world_size: int, args: Sequence = (), *,
              timeout_s: float = 300.0) -> List[Any]:
    """``fn(rank, *args)`` on ``world_size`` fresh processes; returns their
    results in rank order or raises the first failure."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(fn, r, world_size, port, tuple(args),
                               results, timeout_s))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world_size:
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(got))}"
                                   f" did not finish within {timeout_s} s")
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            got[rank] = payload
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [got[r] for r in range(world_size)]
