"""Request-side state of the serving stack.

Counterpart of ``mingpt_distributed_tpu/serving/requests.py``. A request
outlives the replica serving it, while slot state dies with its engine, so
the two live apart: this module is the request half,
``scheduler.SlotTable`` the slot half.

* :class:`Request` — the submission (prompt, sampling params, stop
  conditions, deadline). ``validate()`` rejects malformed requests at the
  door with actionable messages instead of letting NaN temperatures or
  impossible windows fail deep inside the decode step.
* :class:`RequestHandle` — the live per-attempt view one
  ``InferenceServer`` maintains (tokens stream in, ``finished`` /
  ``finish_reason`` flip on retirement).
* :class:`QueueFullError` / :class:`ShedError` — typed backpressure. Both
  carry a suggested ``retry_after_s`` so callers can back off instead of
  hammering; rejections are counted per reason in
  ``mingpt_serving_rejected_total{reason=...}``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

__all__ = [
    "QueueFullError",
    "Request",
    "RequestHandle",
    "ShedError",
]


class QueueFullError(RuntimeError):
    """submit() refused: the bounded request queue is at max depth.
    Callers should shed load or retry after ``retry_after_s`` —
    backpressure, not OOM. ``queue_depth`` is the depth observed at
    rejection time."""

    def __init__(
        self,
        msg: str,
        queue_depth: Optional[int] = None,
        retry_after_s: Optional[float] = None,
    ):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s


class ShedError(RuntimeError):
    """Request refused by fleet overload control before touching any
    replica. ``reason`` is the `mingpt_serving_rejected_total` label:
    ``shed`` (global queue depth crossed the watermark),
    ``breaker_open`` (no replica's circuit breaker admits traffic),
    ``deadline`` (the request's deadline cannot be met by the estimated
    queue wait), or ``draining`` (graceful shutdown in progress)."""

    def __init__(
        self,
        msg: str,
        reason: str = "shed",
        retry_after_s: Optional[float] = None,
    ):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_s = retry_after_s


@dataclass
class Request:
    """One generation request with its own sampling + stop parameters
    (the per-request analogue of generate()'s keyword surface)."""

    prompt: Sequence[int]
    max_new_tokens: int = 16
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    do_sample: bool = False
    eos_id: Optional[int] = None   # stop when this token is produced
    seed: int = 0                  # per-request sampling PRNG seed
    deadline_s: Optional[float] = None  # expire this long after submit
    request_id: Optional[str] = None
    tenant: Optional[str] = None   # trace baggage: who submitted this
    # request-scoped trace context (telemetry/tracing.py): a request that
    # arrives with one parents its spans into that trace; without one a
    # server with a trace recorder mints it
    trace: Optional[Any] = None

    def validate(
        self,
        block_size: Optional[int] = None,
        prefill_len: Optional[int] = None,
    ) -> None:
        """Reject malformed requests with actionable messages.

        The base checks guard every parameter that would otherwise fail
        deep inside the compiled sampler (a NaN temperature poisons the
        logits of its slot; a negative top_k threshold is garbage).
        The window checks are opt-in: with ``block_size`` /
        ``prefill_len`` given (``InferenceServer(strict_window=True)``),
        a prompt that would be cropped or a ``max_new_tokens`` that
        would be clamped is rejected instead — callers that prefer the
        documented crop/clamp semantics simply don't pass them.
        """
        if len(self.prompt) < 1:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if not math.isfinite(self.temperature) or self.temperature < 0:
            raise ValueError(
                f"temperature must be finite and >= 0, got "
                f"{self.temperature}")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(
                f"top_k must be >= 1 (or None to disable), got {self.top_k}")
        if self.top_p is not None and (
                not math.isfinite(self.top_p) or not 0.0 < self.top_p <= 1.0):
            raise ValueError(
                f"top_p must be in (0, 1] (or None to disable), got "
                f"{self.top_p}")
        if self.deadline_s is not None and (
                not math.isfinite(self.deadline_s) or self.deadline_s < 0):
            raise ValueError(
                f"deadline_s must be finite and >= 0, got {self.deadline_s}")
        if prefill_len is not None and len(self.prompt) > prefill_len:
            raise ValueError(
                f"prompt length {len(self.prompt)} exceeds prefill_len "
                f"{prefill_len} (strict window mode rejects instead of "
                f"cropping to the last {prefill_len} tokens)")
        if block_size is not None and (
                len(self.prompt) + self.max_new_tokens - 1 > block_size):
            raise ValueError(
                f"prompt ({len(self.prompt)} tokens) + max_new_tokens "
                f"({self.max_new_tokens}) overruns block_size {block_size}: "
                f"decode feeds positions up to prompt+new-1, so "
                f"max_new_tokens <= {block_size - len(self.prompt) + 1} "
                f"here (strict window mode rejects instead of clamping)")


@dataclass
class RequestHandle:
    """Live view of a submitted request: ``tokens`` grows as the request
    decodes; ``finished``/``finish_reason`` flip on retirement."""

    request: Request
    request_id: str
    prompt_used: List[int]        # after cropping to prefill_len
    max_new_effective: int        # after clamping to the block_size window
    tokens: List[int] = field(default_factory=list)
    finished: bool = False
    finish_reason: Optional[str] = None  # "length" | "eos" | "deadline" | "error"
    slot: Optional[int] = None
    submit_time: float = 0.0
    deadline: Optional[float] = None     # absolute clock time; None = never
    error: Optional[BaseException] = None  # a raising on_token callback
    first_token_time: Optional[float] = None
    last_token_time: Optional[float] = None
    # admission progress: cache rows [0, prefill_pos) of the slot hold
    # this request's prompt (prefix-hit rows + completed chunks)
    prefilling: bool = False
    prefill_pos: int = 0
    prefix_rows: int = 0          # rows served from the shared-prefix store
    admit_time: Optional[float] = None
    # the request's trace context, and whether this server minted it (and
    # so records the emit events and ends the trace)
    trace: Optional[Any] = None
    trace_owner: bool = False
    # speculative decoding (serving/speculative.py): draft tokens this
    # request was offered / accepted over its verify rounds (its accept
    # rate is spec_accepted / spec_proposed)
    spec_proposed: int = 0
    spec_accepted: int = 0

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time
