"""Serving observability on the port's metrics registry.

Counterpart of ``mingpt_distributed_tpu/serving/metrics.py``. Counters
(requests by outcome, prefills, tokens generated), per-step gauges (queue
depth, slot utilisation) and per-request latency (time to first token,
mean inter-token latency) are typed instruments registered in a
:class:`~mingpt_distributed_tpu_torch.telemetry.MetricsRegistry` under
``mingpt_serve_*``. TTFT, ITL, admission-stall and prefill-chunk latencies
are fixed-ladder histograms (``LATENCY_BUCKETS_S``); tokens/s is computed
over log windows with ``RateWindow``. Read-only attributes
(``metrics.requests_completed``, ``metrics.bucket_histogram``, ...) view
the instruments; ``summary()``/``write_json()`` give the JSON summary of an
offline batch and of ``serve.py --selftest``, ``log_line()`` the periodic
log line (every ``log_every`` scheduler steps). Speculative decoding adds
its rounds, proposed and accepted draft tokens, the tokens-per-verify
histogram, the accept rate and the draft primes by path
(``mingpt_serve_spec_*``); ``kv_dtype_gauges`` registers the KV storage
dtype as a build-info gauge and, on a quantized pool, the sampled
quantization error gauge.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from mingpt_distributed_tpu_torch.telemetry import (
    LATENCY_BUCKETS_S,
    MetricsRegistry,
    RateWindow,
    log_event,
)


class ServingMetrics:
    def __init__(
        self,
        n_slots: int,
        log_every: int = 0,
        enabled: bool = True,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.n_slots = max(n_slots, 1)
        self.log_every = log_every
        self.enabled = enabled
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        # counters
        self._requests = r.counter(
            "mingpt_serve_requests_total",
            help="requests by outcome (submitted counts admissions to the "
                 "queue; rejected = bounded-queue refusals; expired = "
                 "deadline hits; failed = on_token callback raised)",
            labels=("outcome",),
        )
        self._prefills = r.counter(
            "mingpt_serve_prefills_total", help="admissions fully prefilled")
        self._tokens = r.counter(
            "mingpt_serve_tokens_generated_total",
            help="decode tokens emitted")
        # fleet-facing rejection family: every refused admission
        # lands here with WHY it was refused — queue_full (bounded queue),
        # shed (global depth watermark), breaker_open (no replica's
        # circuit breaker admits traffic), deadline (cannot be met),
        # draining (graceful shutdown). The legacy outcome="rejected"
        # counter keeps aggregating them all.
        self._rejected = r.counter(
            "mingpt_serving_rejected_total",
            help="refused admissions by reason (queue_full | shed | "
                 "breaker_open | deadline | draining)",
            labels=("reason",),
        )
        for _reason in ("queue_full", "shed", "breaker_open",
                        "deadline", "draining"):
            # pre-touch so every reason is scrape-visible at zero
            self._rejected.labels(reason=_reason).inc(0)
        self._steps = r.counter(
            "mingpt_serve_steps_total", help="scheduler rounds executed")
        # prefill accounting: real prompt tokens forwarded, the
        # padded bucket fit (how well the ladder matches the traffic), and
        # wall time inside prefill calls — the decode-stall budget
        # admissions consume
        self._prefill_chunks = r.counter(
            "mingpt_serve_prefill_chunks_total",
            help="padded prefill calls issued")
        self._prefill_tokens = r.counter(
            "mingpt_serve_prefill_tokens_total",
            help="real (unpadded) prompt tokens prefilled")
        self._prefill_padded = r.counter(
            "mingpt_serve_prefill_padded_tokens_total",
            help="bucket lengths actually forwarded (incl. padding and "
                 "shifted-final-chunk overlap)")
        self._prefill_seconds = r.counter(
            "mingpt_serve_prefill_seconds_total",
            help="wall seconds spent inside prefill calls")
        self._bucket_counter = r.counter(
            "mingpt_serve_prefill_bucket_total",
            help="prefill chunks by padded bucket length",
            labels=("bucket",),
        )
        # shared-prefix store
        self._prefix_lookups = r.counter(
            "mingpt_serve_prefix_lookups_total",
            help="prefix-cache lookups at admission")
        self._prefix_hits = r.counter(
            "mingpt_serve_prefix_hits_total", help="prefix-cache hits")
        self._prefix_rows = r.counter(
            "mingpt_serve_prefix_rows_reused_total",
            help="KV rows restored from the prefix cache instead of "
                 "recomputed")
        # latency histograms (fixed ladder — comparable across scrapes)
        self._ttft = r.histogram(
            "mingpt_serve_ttft_seconds",
            help="time to first token per admission",
            buckets=LATENCY_BUCKETS_S,
        )
        self._itl = r.histogram(
            "mingpt_serve_itl_seconds",
            help="mean inter-token latency per completed request",
            buckets=LATENCY_BUCKETS_S,
        )
        self._stall = r.histogram(
            "mingpt_serve_admission_stall_seconds",
            help="slot claim to first token — decode stall an admission "
                 "costs its co-tenants",
            buckets=LATENCY_BUCKETS_S,
        )
        self._chunk_hist = r.histogram(
            "mingpt_serve_prefill_chunk_seconds",
            help="wall time of one padded prefill call",
            buckets=LATENCY_BUCKETS_S,
        )
        # speculative decoding (serving/speculative.py): proposal volume,
        # acceptance and the emitted-tokens-per-verify distribution, what
        # speculation bought per target forward (1 = draft useless, k+1 =
        # full acceptance)
        self._spec_rounds = r.counter(
            "mingpt_serve_spec_rounds_total",
            help="verify rounds executed (one batched target forward each)")
        self._spec_proposed = r.counter(
            "mingpt_serve_spec_proposed_total",
            help="draft tokens proposed across verify rounds")
        self._spec_accepted = r.counter(
            "mingpt_serve_spec_accepted_total",
            help="draft tokens accepted (matched the target's greedy "
                 "choice)")
        self._spec_tokens_per_verify = r.histogram(
            "mingpt_serve_spec_tokens_per_verify",
            help="tokens emitted per verify round (accepted prefix + the "
                 "bonus token)",
            buckets=(1, 2, 3, 4, 6, 8, 12, 16),
        )
        self._spec_accept_rate = r.gauge(
            "mingpt_serve_spec_accept_rate",
            help="cumulative accepted/proposed draft tokens")
        self._spec_prime = r.counter(
            "mingpt_serve_spec_prime_total",
            help="draft primes by path: full = paid a draft prefill, "
                 "adopted = resumed from migrated draft rows",
            labels=("mode",))
        for mode in ("full", "adopted"):
            self._spec_prime.labels(mode=mode).inc(0)
        # gauges sampled at step boundaries
        self._queue_depth = r.gauge(
            "mingpt_serve_queue_depth", help="queued requests after the "
            "last scheduler round")
        self._slots_active = r.gauge(
            "mingpt_serve_slots_active", help="occupied slots after the "
            "last scheduler round")
        self._util = r.gauge(
            "mingpt_serve_slot_utilization",
            help="mean fraction of decode lanes doing useful work")
        self._tps = r.gauge(
            "mingpt_serve_tokens_per_sec",
            help="decode tokens/sec over the last log window")
        self._prefill_tps = r.gauge(
            "mingpt_serve_prefill_tokens_per_sec",
            help="real prompt tokens/sec over the last prefill window")
        self._hit_rate = r.gauge(
            "mingpt_serve_prefix_hit_rate",
            help="prefix-cache hits / lookups so far")
        self._util_sum = 0.0
        self._prefill_rate = RateWindow()
        self._prefill_tokens_per_sec: Optional[float] = None
        self._rate = RateWindow()
        self._tokens_per_sec: Optional[float] = None

    # -- back-compat attribute views over the instruments ---------------
    @property
    def requests_submitted(self) -> int:
        return int(self._requests.labels(outcome="submitted").value)

    @property
    def requests_completed(self) -> int:
        return int(self._requests.labels(outcome="completed").value)

    @property
    def requests_rejected(self) -> int:
        return int(self._requests.labels(outcome="rejected").value)

    @property
    def requests_expired(self) -> int:
        return int(self._requests.labels(outcome="expired").value)

    @property
    def requests_failed(self) -> int:
        return int(self._requests.labels(outcome="failed").value)

    @property
    def prefills(self) -> int:
        return int(self._prefills.value)

    @property
    def tokens_generated(self) -> int:
        return int(self._tokens.value)

    @property
    def steps(self) -> int:
        return int(self._steps.value)

    @property
    def prefill_chunks(self) -> int:
        return int(self._prefill_chunks.value)

    @property
    def prefill_tokens(self) -> int:
        return int(self._prefill_tokens.value)

    @property
    def prefill_padded_tokens(self) -> int:
        return int(self._prefill_padded.value)

    @property
    def bucket_histogram(self) -> Dict[int, int]:
        return {
            int(labels["bucket"]): int(child.value)
            for labels, child in self._bucket_counter.children()
        }

    @property
    def prefix_lookups(self) -> int:
        return int(self._prefix_lookups.value)

    @property
    def prefix_hits(self) -> int:
        return int(self._prefix_hits.value)

    @property
    def prefix_rows_reused(self) -> int:
        return int(self._prefix_rows.value)

    @property
    def queue_depth(self) -> int:
        return int(self._queue_depth.value)

    @property
    def slots_active(self) -> int:
        return int(self._slots_active.value)

    # -- event hooks (called by the scheduler) -------------------------
    def on_submit(self) -> None:
        self._requests.labels(outcome="submitted").inc()

    def on_reject(self, reason: str = "queue_full") -> None:
        self._requests.labels(outcome="rejected").inc()
        self._rejected.labels(reason=reason).inc()

    def on_expire(self) -> None:
        self._requests.labels(outcome="expired").inc()

    def on_error(self) -> None:
        self._requests.labels(outcome="failed").inc()

    def on_prefill(self, ttft_s: float, stall_s: float = 0.0) -> None:
        """One admission finished prefilling. ``stall_s`` is the wall time
        from slot claim to first token — what this admission cost its
        co-tenants in decode stall."""
        self._prefills.inc()
        self._ttft.observe(ttft_s)
        self._stall.observe(stall_s)

    def on_prefill_chunk(self, n_tokens: int, bucket: int, seconds: float) -> None:
        """One prefill call: ``n_tokens`` real prompt tokens forwarded as
        a ``bucket``-length padded chunk."""
        self._prefill_chunks.inc()
        self._prefill_tokens.inc(n_tokens)
        self._prefill_padded.inc(bucket)
        self._bucket_counter.labels(bucket=bucket).inc()
        self._prefill_seconds.inc(seconds)
        self._chunk_hist.observe(seconds)
        rate = self._prefill_rate.observe(self.prefill_tokens)
        if rate is not None:
            self._prefill_tokens_per_sec = rate
            self._prefill_tps.set(rate)

    def on_prefix_lookup(self, hit: bool, rows: int, enabled: bool = True) -> None:
        if not enabled:
            return
        self._prefix_lookups.inc()
        if hit:
            self._prefix_hits.inc()
            self._prefix_rows.inc(rows)
        self._hit_rate.set(self.prefix_hits / self.prefix_lookups)

    def on_tokens(self, n: int) -> None:
        self._tokens.inc(n)

    def on_spec_prime(self, mode: str) -> None:
        """One draft prime: ``mode`` is ``"full"`` (paid a prefill) or
        ``"adopted"`` (resumed from migrated draft rows)."""
        self._spec_prime.labels(mode=mode).inc()

    def on_spec_round(self, proposed: int, emitted: int) -> None:
        """One verify round on one slot: ``proposed`` = k draft tokens
        offered, ``emitted`` = accepted prefix + bonus token (>= 1), so
        accepted draft tokens = emitted - 1."""
        self._spec_rounds.inc()
        self._spec_proposed.inc(proposed)
        self._spec_accepted.inc(emitted - 1)
        self._spec_tokens_per_verify.observe(emitted)
        if self.spec_proposed:
            self._spec_accept_rate.set(self.spec_accepted / self.spec_proposed)

    def on_complete(self, n_generated: int, gen_span_s: float) -> None:
        """gen_span_s: first-token to last-token wall time."""
        self._requests.labels(outcome="completed").inc()
        if n_generated > 1:
            self._itl.observe(gen_span_s / (n_generated - 1))

    def on_step(
        self, queue_depth: int, slots_active: int, lanes_used: Optional[int] = None
    ) -> None:
        """queue_depth/slots_active: end-of-round gauges (occupancy after
        retirement). lanes_used: slots that actually decoded this step —
        what utilization of the shared decode batch means."""
        self._steps.inc()
        self._queue_depth.set(queue_depth)
        self._slots_active.set(slots_active)
        used = slots_active if lanes_used is None else lanes_used
        self._util_sum += used / self.n_slots
        self._util.set(self._util_sum / self.steps)
        rate = self._rate.observe(self.tokens_generated)
        if rate is not None:
            self._tokens_per_sec = rate
            self._tps.set(rate)
        if self.enabled and self.log_every and self.steps % self.log_every == 0:
            log_event(self.log_line())

    # -- read-out ------------------------------------------------------
    @property
    def ttft_mean_s(self) -> Optional[float]:
        return self._ttft.sum / self._ttft.count if self._ttft.count else None

    @property
    def itl_mean_s(self) -> Optional[float]:
        return self._itl.sum / self._itl.count if self._itl.count else None

    @property
    def ttft_p99_s(self) -> Optional[float]:
        """Ladder-resolution p99 (upper bound) — the health-gate signal."""
        return self._ttft.quantile(0.99)

    @property
    def itl_p99_s(self) -> Optional[float]:
        """Ladder-resolution p99 (upper bound) — the health-gate signal."""
        return self._itl.quantile(0.99)

    @property
    def rejected_by_reason(self) -> Dict[str, int]:
        return {
            labels["reason"]: int(child.value)
            for labels, child in self._rejected.children()
        }

    @property
    def spec_rounds(self) -> int:
        return int(self._spec_rounds.value)

    @property
    def spec_proposed(self) -> int:
        return int(self._spec_proposed.value)

    @property
    def spec_accepted(self) -> int:
        return int(self._spec_accepted.value)

    @property
    def spec_accept_rate(self) -> Optional[float]:
        if not self.spec_proposed:
            return None
        return self.spec_accepted / self.spec_proposed

    @property
    def spec_tokens_per_verify_mean(self) -> Optional[float]:
        h = self._spec_tokens_per_verify
        return h.sum / h.count if h.count else None

    @property
    def admission_stall_mean_s(self) -> Optional[float]:
        return self._stall.sum / self.prefills if self.prefills else None

    @property
    def prefix_hit_rate(self) -> Optional[float]:
        if not self.prefix_lookups:
            return None
        return self.prefix_hits / self.prefix_lookups

    @property
    def prefill_pad_overhead(self) -> Optional[float]:
        """Padded-to-real token ratio — 1.0 means the ladder fits the
        traffic perfectly; the redundant-overlap rows of shifted final
        chunks count as padding here too."""
        if not self.prefill_tokens:
            return None
        return self.prefill_padded_tokens / self.prefill_tokens

    @property
    def slot_utilization(self) -> Optional[float]:
        return self._util_sum / self.steps if self.steps else None

    def log_line(self) -> str:
        parts = [
            f"serve step {self.steps}",
            f"active {self.slots_active}/{self.n_slots}",
            f"queued {self.queue_depth}",
            f"done {self.requests_completed}/{self.requests_submitted}",
            f"tokens {self.tokens_generated}",
        ]
        dropped = (self.requests_rejected + self.requests_expired
                   + self.requests_failed)
        if dropped:
            parts.append(
                f"dropped {dropped} (rej {self.requests_rejected} / exp "
                f"{self.requests_expired} / err {self.requests_failed})"
            )
        if self._tokens_per_sec is not None:
            parts.append(f"tokens/sec {self._tokens_per_sec:.4g}")
        if self._prefill_tokens_per_sec is not None:
            parts.append(f"prefill_tok/s {self._prefill_tokens_per_sec:.4g}")
        if self.ttft_mean_s is not None:
            parts.append(f"ttft_ms {self.ttft_mean_s * 1e3:.4g}")
        if self.itl_mean_s is not None:
            parts.append(f"itl_ms {self.itl_mean_s * 1e3:.4g}")
        if self.prefix_lookups:
            parts.append(
                f"prefix_hit {self.prefix_hits}/{self.prefix_lookups}")
        if self.spec_rounds:
            parts.append(
                f"spec_accept {self.spec_accepted}/{self.spec_proposed}")
        return " | ".join(parts)

    def summary(self) -> Dict[str, Any]:
        return {
            "requests_submitted": self.requests_submitted,
            "requests_completed": self.requests_completed,
            "requests_rejected": self.requests_rejected,
            "requests_expired": self.requests_expired,
            "requests_failed": self.requests_failed,
            "prefills": self.prefills,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens": self.prefill_tokens,
            "prefill_padded_tokens": self.prefill_padded_tokens,
            "prefill_pad_overhead": self.prefill_pad_overhead,
            "prefill_time_s": self._prefill_seconds.value,
            "prefill_tokens_per_sec": self._prefill_tokens_per_sec,
            "bucket_histogram": {
                str(k): v for k, v in sorted(self.bucket_histogram.items())
            },
            "admission_stall_mean_s": self.admission_stall_mean_s,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": self.prefix_hit_rate,
            "prefix_rows_reused": self.prefix_rows_reused,
            "tokens_generated": self.tokens_generated,
            "steps": self.steps,
            "queue_depth": self.queue_depth,
            "slots_active": self.slots_active,
            "slot_utilization": self.slot_utilization,
            "tokens_per_sec": self._tokens_per_sec,
            "ttft_mean_s": self.ttft_mean_s,
            "itl_mean_s": self.itl_mean_s,
            "spec_rounds": self.spec_rounds,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_accept_rate": self.spec_accept_rate,
            "spec_tokens_per_verify_mean": self.spec_tokens_per_verify_mean,
        }

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
            f.write("\n")


def kv_dtype_gauges(registry: MetricsRegistry, kv_dtype: str):
    """The KV storage dtype as a build-info gauge (``mingpt_serve_kv_dtype``:
    the child labelled with the dtype is 1) and, on a quantized pool, the
    ``mingpt_serve_quant_logit_err_max`` gauge, which is returned (None on
    an fp32 pool, whose page carries no quantization family)."""
    registry.gauge(
        "mingpt_serve_kv_dtype",
        help="KV-cache storage dtype (build-info style: the labeled child "
             "is 1)",
        labels=("kv_dtype",),
    ).labels(kv_dtype=kv_dtype).set(1)
    if kv_dtype == "fp32":
        return None
    return registry.gauge(
        "mingpt_serve_quant_logit_err_max",
        help="max |logit delta| of a KV quantize/dequantize round trip, as "
             "sampled by the quant selftest")
