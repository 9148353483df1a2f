"""Continuous-batching scheduler: queue → slots → decode-step boundaries.

Counterpart of ``mingpt_distributed_tpu/serving/scheduler.py``. The loop the
server runs (``step()`` = one scheduling round):

1. **Admit** — while the queue is non-empty and the pool has a free slot,
   pop the request the :class:`AdmissionPolicy` selects (FIFO by default),
   claim the slot, and try a shared-prefix cache hit (a device row copy:
   the prompt's cached head costs no FLOPs, only the tail is prefilled).
2. **Prefill** — every slot still prefilling advances by at most ONE chunk
   of <= ``prefill_chunk`` tokens (padded to the smallest covering bucket
   of the engine's ladder). Short prompts finish in the round they were
   admitted; a long prompt spreads its chunks across rounds, so a
   co-tenant's inter-token latency is bounded by one chunk, not one whole
   prompt. The final chunk samples the request's first token and flips the
   slot to decoding.
3. **Decode** — one shared step advances every *decoding* slot one token
   (per-slot positions and sampling params; prefilling and free lanes ride
   along parked at position block_size-1, a row the stale-row invariant
   makes unobservable until its legitimate writer fills it).
4. **Retire** — requests hitting a stop condition (per-request
   ``max_new_tokens`` or EOS token) finish, free their slot, and the next
   round's admissions reuse it. New prompts join while others are half-way
   through decoding.

Determinism: policy-ordered admission (FIFO default; every policy
tie-breaks by queue position), lowest-free-slot placement, and one device
``torch.Generator`` per sampled request, seeded with the request's
``seed`` and drawn from once per generated token, so a sampled request's
output depends only on (params, prompt, sampling params, seed), never on
which other requests share the batch. Greedy requests are token-identical
to solo ``generate()`` on the same prompt under every combination of
bucketing, chunking and prefix reuse: chunked prefill is row-equivalent to
the one-shot forward, and prefix rows are bit-identical to what recomputing
them would produce.

Prompt bounds: prompts longer than ``prefill_len`` are cropped to their
last ``prefill_len`` tokens (the server has no sliding-window decode path;
positions restart at 0 for the cropped prompt), and ``max_new_tokens`` is
clamped so decode positions never leave the ``block_size`` window.
``strict_window=True`` rejects instead of cropping or clamping.

Robustness under sustained traffic:

* **bounded queue** — ``max_queue`` caps waiting requests; beyond it,
  ``submit`` raises :class:`QueueFullError` carrying the observed depth and
  a suggested retry-after;
* **deadlines** — a per-request ``deadline_s`` (or the server-wide
  ``default_deadline_s``) expires requests at step boundaries, whether
  still queued, mid-prefill or mid-decode (``finish_reason="deadline"``);
* **callback isolation** — a raising ``on_token`` callback retires the
  request and frees its slot (``finish_reason="error"``, the exception on
  ``handle.error``) instead of leaking the slot or tearing down the loop.

Speculative decoding (``draft_params``, ``draft_cfg``, ``spec_k``;
serving/speculative.py): greedy lanes with ``k + 1`` rows of window
headroom run propose → verify → accept-n each round while the plain step
advances the others (the speculating lanes parked during it, since verify
writes their rows); every emitted token is still the target's own greedy
choice. ``kv_dtype`` int8/fp8 stores the pool quantized (serving/quant.py).

Telemetry, as in the JAX scheduler:

* **recompile watchdog** — armed after ``warmup``, checked every round
  over ``compile_counts()`` (the new input shapes of each call family);
  ``recompile_fail=True`` (or ``MINGPT_RECOMPILE_FATAL=1``) raises on
  growth;
* **request tracing** (``trace_recorder``, telemetry/tracing.py) — a
  request without a trace context gets one minted at submit, and this
  server then records its ``emit`` events and ends it; spans for the queue
  wait, the prefix lookup, each prefill chunk and each decode or
  speculation round, all on the injected clock;
* **attribution** (``attrib=True``, telemetry/attribution.py) — a program
  ledger with every family's shapes registered at construction and each
  call's device seconds (CUDA events around the call on a card, the
  injected clock on the CPU), and an HBM ledger of bytes by owner;
  ``attrib_report()`` is the ``mingpt-attrib/1`` document.

Chaos (``fault_hook``, serving/fleet.py): called with the fault point's
name, ``"decode_round"``, once per round after the decode step (and the
speculating lanes' verify) and before any of the round's tokens is emitted.
A raise there loses the round's computed tokens, so a replica that fails
mid-round never streams a token twice; the fleet's retry recomputes them.

Not ported yet: tensor parallelism (``mesh``), ROADMAP.md Queue 1 item 9.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models import gpt
from mingpt_distributed_tpu_torch.serving.admission import AdmissionPolicy, FifoPolicy
from mingpt_distributed_tpu_torch.serving import quant as quant_lib
from mingpt_distributed_tpu_torch.serving.engine import DecodeEngine
from mingpt_distributed_tpu_torch.serving.metrics import ServingMetrics, kv_dtype_gauges
from mingpt_distributed_tpu_torch.serving.requests import (
    QueueFullError,
    Request,
    RequestHandle,
)
from mingpt_distributed_tpu_torch.serving.speculative import SpeculativeDecoder
from mingpt_distributed_tpu_torch.telemetry import (
    HBMLedger,
    MetricsRegistry,
    ProgramLedger,
    RecompileWatchdog,
    SpanTracer,
    TraceRecorder,
    build_attrib_report,
    log_event,
    trace_baggage,
    tree_bytes,
)
from mingpt_distributed_tpu_torch.utils.device import Device


def _trace_attrs(handle: RequestHandle) -> Dict[str, Any]:
    """The trace_id attribute for the process SpanTracer's spans, so its
    wall-time spans land in the per-request timeline too."""
    if handle.trace is None:
        return {}
    return {"trace_id": handle.trace.trace_id}


class SlotTable:
    """Slot-side state of one engine replica: the handle occupying each KV
    lane plus the per-slot decode-state arrays fed whole to the shared
    decode step.

    Non-decoding lanes (free or still prefilling) are PARKED at position
    ``block_size - 1``: the decode step writes one row per slot
    unconditionally, and that row is the only one a later legitimate writer
    is guaranteed to refill before any query can attend it; parking lower
    could clobber rows a chunked prefill has already written.
    """

    def __init__(self, n_slots: int, block_size: int):
        self.n_slots = n_slots
        self.parked = block_size - 1
        self.handles: List[Optional[RequestHandle]] = [None] * n_slots
        self.tokens = np.zeros(n_slots, np.int64)
        self.positions = np.full(n_slots, self.parked, np.int64)
        self.temps = np.ones(n_slots, np.float32)
        self.top_ks = np.zeros(n_slots, np.int64)
        self.top_ps = np.ones(n_slots, np.float32)
        self.do_sample = np.zeros(n_slots, bool)
        self.generators: List[Optional[torch.Generator]] = [None] * n_slots

    def bind(self, slot: int, handle: RequestHandle,
             generator: Optional[torch.Generator]) -> None:
        handle.slot = slot
        self.handles[slot] = handle
        self.generators[slot] = generator

    def release(self, slot: int) -> None:
        self.handles[slot] = None
        self.generators[slot] = None
        self.positions[slot] = self.parked
        self.do_sample[slot] = False

    def start_decode(self, slot: int, token: int, position: int,
                     req: Request) -> None:
        """Flip a freshly prefilled slot to decoding: the first generated
        token is fed at ``position`` (= len(prompt)) next round."""
        self.tokens[slot] = token
        self.positions[slot] = position
        self.temps[slot] = req.temperature
        self.top_ks[slot] = 0 if req.top_k is None else req.top_k
        self.top_ps[slot] = 1.0 if req.top_p is None else req.top_p
        self.do_sample[slot] = req.do_sample

    def live_handles(self) -> List[RequestHandle]:
        return [h for h in self.handles if h is not None]

    def decoding_slots(self) -> List[int]:
        return [s for s, h in enumerate(self.handles)
                if h is not None and not h.prefilling]

    @property
    def occupied(self) -> int:
        return sum(h is not None for h in self.handles)


class InferenceServer:
    """Slot-scheduled continuous-batching server over a DecodeEngine. Runs
    on ``device`` (cuda unless the caller asks for the CPU), where the
    params must live."""

    def __init__(
        self,
        params,
        cfg: GPTConfig,
        n_slots: int = 4,
        prefill_len: Optional[int] = None,
        metrics: Optional[ServingMetrics] = None,
        on_token: Optional[Callable[[RequestHandle, int], None]] = None,
        log_every: int = 0,
        max_queue: Optional[int] = None,
        default_deadline_s: Optional[float] = None,
        clock: Callable[[], float] = time.perf_counter,
        prefill_buckets: Optional[Sequence[int]] = None,
        prefill_chunk: Optional[int] = None,
        prefix_cache_mb: float = 0.0,
        warmup: bool = False,
        registry: Optional[MetricsRegistry] = None,
        tracer: Optional[SpanTracer] = None,
        recompile_fail: bool = False,
        strict_window: bool = False,
        fault_hook: Optional[Callable[[str], None]] = None,
        trace_recorder: Optional[TraceRecorder] = None,
        draft_params=None,
        draft_cfg: Optional[GPTConfig] = None,
        spec_k: int = 0,
        admission_policy: Optional[AdmissionPolicy] = None,
        attrib: bool = False,
        mesh=None,
        kv_dtype: Optional[str] = None,
        device: Optional[Device] = None,
    ):
        self.cfg = cfg
        self.engine = DecodeEngine(
            params, cfg, n_slots, prefill_len,
            prefill_buckets=prefill_buckets, prefill_chunk=prefill_chunk,
            prefix_cache_mb=prefix_cache_mb, mesh=mesh, kv_dtype=kv_dtype,
            device=device)
        # speculative decoding: a draft model and spec_k >= 1 turn the
        # decode round into propose → verify → accept-n; off by default,
        # and then the round is the plain one
        self.spec: Optional[SpeculativeDecoder] = None
        if draft_params is not None:
            if draft_cfg is None:
                raise ValueError("draft_params given without draft_cfg")
            if spec_k < 1:
                raise ValueError(
                    "draft model given but spec_k < 1: pass spec_k >= 1 to "
                    "enable speculation (or drop the draft)")
            self.spec = SpeculativeDecoder(self.engine, draft_params,
                                           draft_cfg, spec_k)
        elif spec_k >= 1:
            raise ValueError("spec_k >= 1 requires draft_params/draft_cfg")
        # round-level speculation on/off: token-exact either way (a gated
        # round's draft rows merely go stale)
        self.spec_enabled = True
        self.metrics = metrics or ServingMetrics(
            n_slots, log_every=log_every, registry=registry)
        # disabled by default: span() returns a shared no-op, so the
        # scheduling loop pays nothing unless telemetry is wired in
        self.tracer = tracer if tracer is not None else SpanTracer(enabled=False)
        reg = self.metrics.registry if registry is None else registry
        # post-warmup growth of the shape families (draft and verify
        # included): armed after warmup(), checked every round
        self.watchdog = RecompileWatchdog(self.compile_counts, registry=reg,
                                          tracer=self.tracer,
                                          hard_fail=recompile_fail)
        self._quant_err_gauge = kv_dtype_gauges(reg, self.engine.kv_dtype)
        # request tracing: a settable attribute, as in the JAX scheduler
        self.trace_recorder = trace_recorder
        # attribution: the program and HBM ledgers on this server's registry
        self.attrib: Optional[ProgramLedger] = None
        self.hbm: Optional[HBMLedger] = None
        if attrib:
            self.attrib = ProgramLedger(registry=reg)
            self.hbm = HBMLedger(registry=reg, device=self.engine.device)
            self.engine.register_attrib(self.attrib)
            if self.spec is not None:
                self.spec.register_attrib(self.attrib)
            self._account_hbm()
        self.on_token = on_token
        # the chaos harness's hook (serving/fleet.py): called with a fault
        # point's name; a raise propagates out of step() to the fleet
        self.fault_hook = fault_hook
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.default_deadline_s = default_deadline_s
        self.clock = clock  # injectable for deterministic deadline tests
        self.strict_window = strict_window
        self.admission_policy = (admission_policy if admission_policy
                                 is not None else FifoPolicy())
        self.queue: Deque[RequestHandle] = deque()
        self.slots = SlotTable(n_slots, cfg.block_size)
        self._ids = itertools.count()
        if warmup:
            self.engine.warmup()
            if self.spec is not None:
                self.spec.warmup()
            self.watchdog.arm()

    # -- attribution ---------------------------------------------------
    def _account_hbm(self) -> None:
        """Declare bytes by owner from shapes and dtypes: params, the KV
        pool (a quantized pool's scale planes apart), the prefix store's
        current residency and, with speculation, the draft's params and
        pool. Re-run before each report, so prefix-store churn shows."""
        if self.hbm is None:
            return
        eng = self.engine
        self.hbm.account("params", tree_bytes(eng.params))
        if eng.kv_quant is not None:
            data, scales = quant_lib.split_scales(eng.pool.cache)
            self.hbm.account("kv_pool", tree_bytes(data))
            self.hbm.account("kv_scales", tree_bytes(scales))
        else:
            self.hbm.account("kv_pool", tree_bytes(eng.pool.cache))
        store = eng.prefix_store
        self.hbm.account("prefix_store", 0 if store is None else store.used_bytes)
        if self.spec is not None:
            de = self.spec.draft.engine
            # a draft that shares the target's storage ("self", "self:N")
            # holds no bytes of its own
            own = {t.untyped_storage().data_ptr() for t in gpt._leaves(eng.params)}
            self.hbm.account("draft_params", sum(
                int(t.nbytes) for t in gpt._leaves(de.params)
                if t.untyped_storage().data_ptr() not in own))
            self.hbm.account("draft_pool", tree_bytes(de.pool.cache))

    def attrib_report(self, include_live: bool = False) -> Dict[str, Any]:
        """This server's ``mingpt-attrib/1`` report (raises when it was
        built without ``attrib=True``)."""
        if self.attrib is None:
            raise ValueError("attribution not enabled: construct with attrib=True")
        self._account_hbm()
        return build_attrib_report(self.attrib, self.hbm, include_live=include_live)

    def _attrib_begin(self):
        """Start timing one engine call for the program ledger (None when
        attribution is off): a CUDA event on a card, the clock on the CPU."""
        if self.attrib is None:
            return None
        if self.engine.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return self.clock()

    def _attrib_end(self, start, family: str, variant: str = "", n: int = 1) -> None:
        """Add the call's device seconds to ``family``. The engine calls end
        in a read of their result, so the end event has little to wait for."""
        if start is None:
            return
        if isinstance(start, torch.cuda.Event):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            seconds = self.clock() - start
        self.attrib.observe_call(family, seconds, variant=variant, n=n)

    def observe_quant_logit_error(self, err: float) -> None:
        """Record a sampled quantization quality number (max |Δlogit| of a
        KV round trip, ``quant.max_abs_logit_error``) into the
        ``mingpt_serve_quant_logit_err_max`` gauge; a no-op on an fp32
        server."""
        if self._quant_err_gauge is not None:
            self._quant_err_gauge.set(float(err))

    # -- submission ----------------------------------------------------
    def submit(self, request: Request) -> RequestHandle:
        if self.strict_window:
            request.validate(block_size=self.cfg.block_size,
                             prefill_len=self.engine.prefill_len)
        else:
            request.validate()
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            depth = len(self.queue)
            self.metrics.on_reject(reason="queue_full")
            # suggested retry-after: roughly how long the queue takes to
            # move one slot's worth of work (depth x observed ITL), with a
            # floor so a cold server still suggests a sane backoff
            itl = self.metrics.itl_mean_s
            retry_after = max(0.05, depth * (itl if itl else 0.02))
            raise QueueFullError(
                f"request queue full ({depth}/{self.max_queue} waiting, "
                f"{self.engine.pool.used_count} decoding) — shed load or "
                f"retry in ~{retry_after:.2f}s",
                queue_depth=depth,
                retry_after_s=retry_after,
            )
        pl = self.engine.prefill_len
        prompt = [int(t) for t in list(request.prompt)[-pl:]]
        # decode feeds generated tokens at positions len(prompt) ..
        # len(prompt)+n-2 (the last token is never fed), all < block_size
        max_new = min(request.max_new_tokens,
                      self.cfg.block_size - len(prompt) + 1)
        now = self.clock()
        deadline_s = (request.deadline_s if request.deadline_s is not None
                      else self.default_deadline_s)
        handle = RequestHandle(
            request=request,
            request_id=request.request_id or f"req-{next(self._ids)}",
            prompt_used=prompt,
            max_new_effective=max_new,
            submit_time=now,
            deadline=None if deadline_s is None else now + deadline_s,
        )
        rec = self.trace_recorder
        if request.trace is not None:
            handle.trace = request.trace
        elif rec is not None:
            handle.trace = rec.start_trace(handle.request_id, now=now,
                                           baggage=trace_baggage(request))
            handle.trace_owner = True
        if rec is not None and handle.trace is not None:
            rec.add_event(handle.trace, "queued", now, request_id=handle.request_id,
                          queue_depth=len(self.queue))
        self.queue.append(handle)
        self.metrics.on_submit()
        return handle

    # -- scheduling ----------------------------------------------------
    def _check_stop(self, handle: RequestHandle, token: int) -> bool:
        if (handle.request.eos_id is not None
                and token == handle.request.eos_id):
            handle.finish_reason = "eos"
            return True
        if len(handle.tokens) >= handle.max_new_effective:
            handle.finish_reason = "length"
            return True
        return False

    def _emit(self, handle: RequestHandle, token: int) -> bool:
        """Record a decoded token and stream it. Returns False when the
        user's on_token callback raised: the caller must retire the request
        (freeing its slot) instead of leaking it."""
        now = self.clock()
        if handle.first_token_time is None:
            handle.first_token_time = now
        handle.last_token_time = now
        handle.tokens.append(token)
        self.metrics.on_tokens(1)
        # the server that minted the trace records its emit events, so each
        # visible token is one event
        if (self.trace_recorder is not None and handle.trace is not None
                and handle.trace_owner):
            self.trace_recorder.add_event(handle.trace, "emit", now,
                                          token_index=len(handle.tokens) - 1)
        if self.on_token is not None:
            try:
                self.on_token(handle, token)
            except Exception as e:  # the callback is user code: isolate it
                handle.error = e
                log_event(
                    f"[serve] on_token callback raised for "
                    f"{handle.request_id}: {e!r} — retiring request, "
                    f"freeing its slot",
                    tracer=self.tracer, request_id=handle.request_id,
                )
                return False
        return True

    def _release_slot(self, handle: RequestHandle) -> None:
        slot = handle.slot
        if slot is not None:
            handle.slot = None
            handle.prefilling = False
            self.slots.release(slot)
            self.engine.pool.free(slot)
            if self.spec is not None:
                self.spec.release(slot)

    def _retire(self, handle: RequestHandle) -> None:
        handle.finished = True
        self._release_slot(handle)
        span = (handle.last_token_time or 0.0) - (handle.first_token_time or 0.0)
        self.metrics.on_complete(len(handle.tokens), span)
        self._end_owned_trace(handle)

    def _end_owned_trace(self, handle: RequestHandle) -> None:
        if (self.trace_recorder is not None and handle.trace is not None
                and handle.trace_owner):
            extra: Dict[str, Any] = {}
            if self.spec is not None:
                # the request's speculation outcome rides on its summary
                extra = dict(spec_proposed=handle.spec_proposed,
                             spec_accepted=handle.spec_accepted)
            self.trace_recorder.end_trace(
                handle.trace, now=self.clock(),
                outcome=handle.finish_reason or "error",
                n_tokens=len(handle.tokens), attempts=1, **extra)

    def _fail(self, handle: RequestHandle, reason: str) -> None:
        """Terminal non-success: deadline expiry (queued, mid-prefill or
        mid-decode), a raising callback or a cancel. Frees the slot so it
        can never stay pinned."""
        handle.finished = True
        handle.finish_reason = reason
        self._release_slot(handle)
        if reason == "deadline":
            self.metrics.on_expire()
        else:
            self.metrics.on_error()
        self._end_owned_trace(handle)

    def _expire_if_due(self, handle: RequestHandle, now: float) -> bool:
        if handle.deadline is not None and now >= handle.deadline:
            self._fail(handle, "deadline")
            return True
        return False

    def cancel(self, request_id: str) -> bool:
        """Terminate one accepted-but-unfinished request: a queued request
        leaves the queue, an in-flight one frees its slot. Either way the
        handle finishes with reason "cancelled" and the error counter ticks.
        Returns False when no live request carries the id."""
        for h in list(self.queue):
            if h.request_id == request_id and not h.finished:
                self.queue.remove(h)
                self._fail(h, "cancelled")
                return True
        for h in self.slots.live_handles():
            if h.request_id == request_id and not h.finished:
                self._fail(h, "cancelled")
                return True
        return False

    def _admit(self, handle: RequestHandle) -> None:
        """Claim a slot and start admission: a shared-prefix hit installs
        its rows now (device copy); prompt tokens beyond it prefill in the
        chunk phase."""
        slot = self.engine.pool.allocate()
        if slot is None:
            raise RuntimeError("admission without a free slot")
        if self.spec is not None:
            # the mirrored draft lane: both pools allocate the lowest free
            # index and free together, so the indices coincide (bind
            # raises otherwise)
            self.spec.bind(slot)
        handle.prefilling = True
        handle.admit_time = self.clock()
        rec = self.trace_recorder
        if rec is not None and handle.trace is not None:
            rec.add_span(handle.trace, "serve.queue_wait", ts=handle.submit_time,
                         dur_s=handle.admit_time - handle.submit_time,
                         request_id=handle.request_id)
        req = handle.request
        generator = None
        if req.do_sample:
            generator = torch.Generator(device=self.engine.device)
            generator.manual_seed(req.seed)
        self.slots.bind(slot, handle, generator)
        t0 = self.clock()
        a0 = self._attrib_begin()
        hit = self.engine.try_load_prefix(slot, handle.prompt_used)
        if hit > 0:
            self._attrib_end(a0, "prefix_load", variant=f"b{hit}")
        if rec is not None and handle.trace is not None:
            rec.add_span(handle.trace, "serve.prefix_lookup", ts=t0,
                         dur_s=self.clock() - t0, hit_rows=hit,
                         request_id=handle.request_id)
        self.metrics.on_prefix_lookup(
            hit > 0, hit, enabled=self.engine.prefix_store is not None)
        handle.prefix_rows = hit
        handle.prefill_pos = hit

    def _prefill_one_chunk(self, handle: RequestHandle) -> None:
        """Advance a prefilling slot by one chunk; the final chunk samples
        the request's first token and flips the slot to decoding."""
        req = handle.request
        slot = handle.slot
        prompt = handle.prompt_used
        n_total = len(prompt)
        pos = handle.prefill_pos
        take = min(n_total - pos, self.engine.chunk_size)
        end = pos + take
        last = end == n_total
        off = pos
        bucket = self.engine.bucket_for(take)
        if off + bucket > self.cfg.block_size:
            # the final bucket would overrun the cache window: shift the
            # chunk window back and re-prefill the overlap. Rewriting rows
            # with the values they already hold is exact (the forward is
            # deterministic and row-wise), so parity is unaffected.
            off = self.cfg.block_size - bucket
        t0 = self.clock()
        a0 = self._attrib_begin()
        # only the final chunk's token is used, and only it may draw from
        # the request's generator (a prefix hit changes the chunk count)
        tok, padded = self.engine.prefill_chunk_call(
            slot, prompt[off:end], off,
            req.temperature, req.top_k, req.top_p, req.do_sample and last,
            self.slots.generators[slot],
        )
        self._attrib_end(a0, "prefill", variant=f"b{padded}")
        t1 = self.clock()
        self.metrics.on_prefill_chunk(end - pos, padded, t1 - t0)
        if self.trace_recorder is not None and handle.trace is not None:
            self.trace_recorder.add_span(
                handle.trace, "serve.prefill_chunk", ts=t0, dur_s=t1 - t0,
                pos=pos, tokens=end - pos, padded=padded,
                request_id=handle.request_id)
        handle.prefill_pos = end
        if not last:
            return
        handle.prefilling = False
        if self.engine.prefix_store is not None:
            a0 = self._attrib_begin()
            rows = self.engine.save_prefix(slot, prompt)
            if rows > 0:
                self._attrib_end(a0, "prefix_save", variant=f"b{rows}")
        if self.spec is not None:
            a0 = self._attrib_begin()
            self.metrics.on_spec_prime(self.spec.prime(slot, prompt))
            b = self.spec.draft.engine.bucket_for(len(prompt))
            self._attrib_end(a0, "draft_prefill", variant=f"b{b}")
        ok = self._emit(handle, tok)
        now = self.clock()
        self.metrics.on_prefill(
            handle.ttft_s or 0.0, now - (handle.admit_time or now))
        self.slots.start_decode(slot, tok, n_total, req)
        if not ok:
            self._fail(handle, "error")
        elif self._check_stop(handle, tok):
            self._retire(handle)

    def _fire_fault(self, where: str) -> None:
        if self.fault_hook is not None:
            self.fault_hook(where)

    def step(self) -> bool:
        """One scheduling round (expire → admit → prefill chunks → decode
        → retire). Returns True while any request is queued or in flight."""
        # deadline sweep first: expired queued requests never take a slot,
        # expired in-flight requests release theirs before admission
        now = self.clock()
        expired_queued = [h for h in self.queue
                          if self._expire_if_due(h, now)]
        if expired_queued:
            self.queue = deque(h for h in self.queue if not h.finished)
        for h in self.slots.live_handles():
            self._expire_if_due(h, now)

        while self.queue and self.engine.pool.free_count:
            idx = self.admission_policy.select(self.queue, now)
            h = self.queue[idx]
            del self.queue[idx]
            self.admission_policy.on_admit(h)
            with self.tracer.span("serve.admit", request_id=h.request_id,
                                  **_trace_attrs(h)):
                self._admit(h)

        # one chunk per prefilling slot per round: a long prompt's
        # admission cost is spread out, so co-tenant inter-token latency
        # is bounded by one chunk forward, not one full-prompt forward
        for h in self.slots.live_handles():
            if h.prefilling:
                with self.tracer.span("serve.prefill_chunk",
                                      request_id=h.request_id,
                                      pos=h.prefill_pos, **_trace_attrs(h)):
                    self._prefill_one_chunk(h)

        active = self.slots.decoding_slots()
        if active:
            with self.tracer.span("serve.decode_round", lanes=len(active)):
                self._decode_round(active)

        occupied = self.slots.occupied
        self.metrics.on_step(len(self.queue), occupied, lanes_used=len(active))
        self.watchdog.check()
        return bool(self.queue) or occupied > 0

    def _decode_round(self, active: List[int]) -> None:
        """Advance every decoding slot. Greedy lanes with k+1 rows of
        window headroom speculate when a draft is configured; the rest take
        the plain one-token step, with the speculating lanes parked (verify
        is their row writer this round). Then each lane emits its burst."""
        st = self.slots
        td0 = self.clock()
        spec_slots: List[int] = []
        if self.spec is not None and self.spec_enabled:
            spec_slots = [s for s in active if self.spec.eligible(
                bool(st.do_sample[s]), int(st.positions[s]))]
        plain = [s for s in active if s not in spec_slots]
        burst: Dict[int, List[int]] = {}
        if plain:
            pos = st.positions
            if spec_slots:
                pos = np.where(np.isin(np.arange(st.n_slots), plain), pos, st.parked)
            a0 = self._attrib_begin()
            nxt = self.engine.decode_step(st.tokens, pos, st.temps, st.top_ks,
                                          st.top_ps, st.do_sample, st.generators)
            self._attrib_end(a0, "decode")
            for s in plain:
                burst[s] = [int(nxt[s])]
        if spec_slots:
            self._spec_round(spec_slots, burst)
        # per-request round spans are recorded before the emits: a retiring
        # emit ends its trace, and a later span would be an orphan
        if self.trace_recorder is not None:
            td1 = self.clock()
            for s in active:
                h = st.handles[s]
                if h.trace is None:
                    continue
                if s in spec_slots:
                    self.trace_recorder.add_span(
                        h.trace, "serve.spec_round", ts=td0, dur_s=td1 - td0,
                        lanes=len(active), proposed=self.spec.k,
                        accepted=len(burst[s]) - 1, request_id=h.request_id)
                else:
                    self.trace_recorder.add_span(
                        h.trace, "serve.decode_round", ts=td0, dur_s=td1 - td0,
                        lanes=len(active), request_id=h.request_id)
        # the chaos fault point, reached once per round by the plain and the
        # speculating lanes alike: a raise here loses the round's computed
        # tokens (a whole accepted burst included) before any is emitted
        self._fire_fault("decode_round")
        for s in active:
            handle = st.handles[s]
            toks = burst[s]
            if s in spec_slots:
                handle.spec_proposed += self.spec.k
                handle.spec_accepted += len(toks) - 1
                self.metrics.on_spec_round(self.spec.k, len(toks))
            for token in toks:
                ok = self._emit(handle, token)
                st.tokens[s] = token
                st.positions[s] += 1
                if not ok:
                    self._fail(handle, "error")
                    break
                if self._check_stop(handle, token):
                    self._retire(handle)
                    break
                # a burst is the round's granularity now: a deadline that
                # passes mid-burst drops the burst's tail and frees both
                # the target and the draft slot
                if handle.deadline is not None and self.clock() >= handle.deadline:
                    self._fail(handle, "deadline")
                    break

    def _spec_round(self, spec_slots: List[int], burst: Dict[int, List[int]]) -> None:
        """propose (k draft steps over every speculating lane), one verify
        per speculating slot, accept-n into ``burst``; then the draft
        backfill of the fully accepted lanes."""
        st, spec = self.slots, self.spec
        smask = np.zeros(st.n_slots, bool)
        smask[spec_slots] = True
        a0 = self._attrib_begin()
        proposals = spec.propose(st.tokens, st.positions, smask)
        self._attrib_end(a0, "draft_decode", n=spec.k)
        fill_mask = np.zeros(st.n_slots, bool)
        fill_toks = np.zeros(st.n_slots, np.int64)
        fill_pos = np.zeros(st.n_slots, np.int64)
        for s in spec_slots:
            rows = [int(st.tokens[s])] + [int(t) for t in proposals[s]]
            a0 = self._attrib_begin()
            g = spec.verify(s, rows, int(st.positions[s]), float(st.temps[s]),
                            int(st.top_ks[s]), float(st.top_ps[s]))
            self._attrib_end(a0, "verify", variant=f"k{spec.k}")
            n_acc = spec.accept_len(proposals[s], g)
            burst[s] = [int(t) for t in g[:n_acc]]
            if n_acc == spec.k + 1:
                # full acceptance: the draft row pos+k was never written;
                # backfill d_k there so the next propose attends a real row
                fill_mask[s] = True
                fill_toks[s] = int(proposals[s][-1])
                fill_pos[s] = int(st.positions[s]) + spec.k
        spec.backfill(fill_toks, fill_pos, fill_mask)

    def unfinished(self) -> List[RequestHandle]:
        """Every accepted-but-unfinished request (queued, prefilling or
        decoding), queue first."""
        live = [h for h in self.slots.live_handles() if not h.finished]
        return list(self.queue) + live

    def run_until_drained(self, max_steps: Optional[int] = None) -> None:
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"server not drained after {max_steps} steps "
                    f"(queued={len(self.queue)}, "
                    f"active={self.engine.pool.used_count})")

    # -- offline convenience -------------------------------------------
    def generate_batch(self, requests: Sequence[Request]) -> List[RequestHandle]:
        """Submit everything, drain, return handles in submission order."""
        handles = [self.submit(r) for r in requests]
        self.run_until_drained()
        return handles

    def compile_counts(self) -> Dict[str, int]:
        """The engine's shape families, plus verify and the draft's when
        speculation is on (absent otherwise)."""
        counts = self.engine.compile_counts()
        if self.spec is not None:
            counts.update(self.spec.compile_counts())
        return counts

    def summary(self) -> Dict[str, Any]:
        return self.metrics.summary()
