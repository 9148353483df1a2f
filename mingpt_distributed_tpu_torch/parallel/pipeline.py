"""Pipeline parallelism over the ``pp`` mesh axis: each stage's schedule.

Counterpart of ``mingpt_distributed_tpu/parallel/pipeline.py``
(``pipeline_blocks``, ``_make_1f1b``). As there, the stacked layer axis of
every block leaf is split over pp (``parallel/mesh.py``), so stage s holds
layers [s L/pp, (s+1) L/pp), and the local batch is split into
``m = pp_microbatches or pp`` microbatches. Stage 0 embeds each
microbatch; the last stage runs the final norm, the head and the loss.

The JAX package writes the whole schedule as one differentiable scan that
autodiff transposes. Here each stage runs an explicit list of actions
(``schedule_actions``): ("F", i), the forward of microbatch i through the
stage's layers, and ("B", i), its backward, one
``torch.autograd.backward`` of the stage's output against the gradient
the next stage sent back (the last stage backpropagates its loss term).
Activations go to the next stage and their gradients to the one before
with ``distributed.send_async`` and ``distributed._exchange``, over
``mesh.pp_group`` (under gloo through host memory). A stage blocks only
on what it receives, never on what it sends, and every stage takes its
microbatches in ascending order in both directions, so each receive meets
its send.

* ``"gpipe"``: every forward, then every backward. A stage keeps the
  graphs of all m microbatches alive between the two.
* ``"1f1b"``: ``pp - 1 - stage`` warm-up forwards, then one forward and one
  backward in turn, then the cool-down backwards. A stage keeps at most
  ``pp - stage`` microbatch graphs alive (``PipelineStats.live_peak``
  counts them), within the JAX 1F1B's bound of ``2(pp-1)+1`` stage inputs.
  The JAX 1F1B re-runs the forward inside its custom vjp; here the graph
  of the forward is kept instead, so nothing is computed twice. The
  numbers equal GPipe's: the same forwards in the same microbatches, and
  the backwards accumulate the parameter gradients in the same order.

Bubble actions compute nothing: a stage simply waits for its next input.
The collectives of tp, sp, fsdp and ep run inside a stage's actions; they
stay among the stage's peers (the ranks of the same pp coordinate), which
run the same action list, so they meet in the same order.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Tuple

import torch

from mingpt_distributed_tpu_torch.parallel import distributed as D

SCHEDULES = ("gpipe", "1f1b")

Action = Tuple[str, int]


def schedule_actions(schedule: str, pp: int, stage: int, m: int) -> List[Action]:
    """Stage ``stage``'s actions over ``m`` microbatches: ("F", i) and
    ("B", i) in the order they run."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pp_schedule {schedule!r}; valid: {SCHEDULES}")
    if schedule == "gpipe":
        return [("F", i) for i in range(m)] + [("B", i) for i in range(m)]
    warm = min(pp - 1 - stage, m)
    out = [("F", i) for i in range(warm)]
    for i in range(m - warm):
        out += [("F", warm + i), ("B", i)]
    return out + [("B", i) for i in range(m - warm, m)]


def microbatch_count(n_microbatches: int, pp: int, local_batch: int) -> int:
    """``n_microbatches or pp``; the JAX ValueError when the local batch
    does not split into that many."""
    m = n_microbatches or pp
    if local_batch % m:
        raise ValueError(
            f"local batch {local_batch} not divisible by {m} microbatches "
            f"(global batch / (dp*fsdp) must divide pp_microbatches)")
    return m


@dataclasses.dataclass
class PipelineStats:
    """One run of a stage's schedule: its actions, the most microbatch
    graphs it held alive for their backward at once (counted as it runs),
    and the host seconds and bytes of its exchanges (sends posted,
    receives waited for)."""

    schedule: str
    stage: int
    microbatches: int
    actions: List[Action]
    live_peak: int = 0
    exchange_s: float = 0.0
    sent_bytes: int = 0


#: the stats of the last schedule this process ran
LAST: Optional[PipelineStats] = None


def pipeline_blocks(
    x: torch.Tensor,
    stage_blocks: Any,
    apply_stack: Callable[[torch.Tensor, Any, int], Tuple[torch.Tensor, Optional[torch.Tensor]]],
    mesh,
    n_microbatches: int = 0,
    schedule: str = "gpipe",
    *,
    first: Callable[[torch.Tensor, int], torch.Tensor],
    last: Callable[[torch.Tensor, int], Optional[torch.Tensor]],
    act_shape: Tuple[int, ...],
    act_dtype: torch.dtype,
    backward: bool = True,
) -> PipelineStats:
    """Run this stage's share of the pipeline over the local batch ``x``
    (split into microbatches along its first dimension).

    ``first(x_i, i)``: stage 0's input of microbatch i (the embedding).
    ``apply_stack(h, stage_blocks, i)``: the stage's layers on one
    microbatch -> (output, a scalar to backpropagate beside it, or None).
    ``last(h, i)``: on the last stage, the microbatch's scalar objective
    (backpropagated when ``backward``) or, without ``backward``, anything
    (the caller collects what it needs). ``act_shape`` and ``act_dtype``:
    one microbatch's activations, as they move between stages.

    With ``backward`` every stage runs the backward of each microbatch,
    which accumulates the ``.grad`` of the stage's parameters; without it
    only the forwards run (an eval or a logits forward). Returns the run's
    ``PipelineStats`` (also kept in ``LAST``)."""
    global LAST
    pp, stage, group = mesh.pp, mesh.stage, mesh.pp_group
    m = microbatch_count(n_microbatches, pp, x.shape[0])
    xs = x.chunk(m)
    acts = (schedule_actions(schedule, pp, stage, m) if backward
            else [("F", i) for i in range(m)])
    stats = PipelineStats(schedule, stage, m, acts)
    like = torch.empty(act_shape, dtype=act_dtype, device=x.device)
    is_first, is_last = stage == 0, stage == pp - 1
    pending: List[Any] = []
    held = {}  # microbatch -> (stage input, [tensors to backpropagate])

    def send(t: torch.Tensor, peer: int, tag: int) -> None:
        t0 = time.perf_counter()
        pending.append(D.send_async(group, t.detach(), peer, tag))
        stats.exchange_s += time.perf_counter() - t0
        stats.sent_bytes += t.numel() * t.element_size()

    def receive(peer: int, tag: int) -> torch.Tensor:
        t0 = time.perf_counter()
        got = D._exchange(group, [], [(like, peer, tag)])[0]
        stats.exchange_s += time.perf_counter() - t0
        return got

    for kind, i in acts:
        if kind == "F":
            if is_first:
                h_in = None
                h = first(xs[i], i)
            else:
                h_in = receive(stage - 1, 2 * i)
                if backward:
                    h_in.requires_grad_(True)
                h = h_in
            h, extra = apply_stack(h, stage_blocks, i)
            if is_last:
                out = last(h, i)
                roots = [out]
            else:
                send(h, stage + 1, 2 * i)
                roots = [h]
            if extra is not None:
                roots.append(extra)
            if backward:
                held[i] = (h_in, roots)
                stats.live_peak = max(stats.live_peak, len(held))
            continue
        h_in, roots = held.pop(i)
        grads = [torch.ones_like(r) for r in roots]
        if not is_last:
            grads[0] = receive(stage + 1, 2 * i + 1)
        torch.autograd.backward(roots, grads)
        if not is_first:
            send(h_in.grad, stage - 1, 2 * i + 1)
        del h_in, roots, grads
    t0 = time.perf_counter()
    for p in pending:
        p.wait()
    stats.exchange_s += time.perf_counter() - t0
    LAST = stats
    return stats
