"""Training metrics: the FLOP model, the card's peak table and bounds, and
the step line (stdout, optionally a JSONL file and TensorBoard).

Counterpart of ``mingpt_distributed_tpu/training/metrics.py``. The step
line carries step, loss, lr, grad_norm, update_norm, tokens/s and MFU;
tokens/s and MFU are taken over the window since the previous logged step
(the loop syncs with the card only at logged steps). Every scalar is also
set on a ``mingpt_train_*`` gauge of a metrics registry: pass the process
registry (``telemetry.get_registry()``) to put them on the ``/metrics``
page beside the serving families. ``tensorboard_dir`` adds a TensorBoard
sink (``torch.utils.tensorboard``); where that cannot be imported the
logger says so once and keeps its other sinks.
"""

from __future__ import annotations

import functools
import json
import re
import subprocess
import time
from typing import Any, Dict, Iterable, Optional, Tuple

from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.telemetry import MetricsRegistry, log_event
# the card's peaks live in one table (telemetry/peaks.py), re-exported here
from mingpt_distributed_tpu_torch.telemetry.peaks import (  # noqa: F401
    H100_SXM,
    PEAKS,
    peak_flops,
)

_GAUGE_SAFE_RE = re.compile(r"[^a-zA-Z0-9_]")
# Exponentials per clock per SM: the special-function unit's MUFU.EX2 on
# compute capability 9.0 (CUDA C++ programming guide, throughput of
# arithmetic instructions), where the FMA pipes give 128 results. Every
# exponential (expf, exp2f, __expf) issues one.
SFU_EXPS_PER_CLOCK_PER_SM = 16


@functools.cache
def sfu_exp_rate(index: int = 0) -> Tuple[float, float]:
    """(exponentials per second, max SM clock in MHz) of CUDA card
    ``index``: SMs x SFU_EXPS_PER_CLOCK_PER_SM x the clock that nvidia-smi
    reports as ``clocks.max.sm``."""
    import torch

    sms = torch.cuda.get_device_properties(index).multi_processor_count
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    mhz = float(out.stdout.split()[0])
    return sms * SFU_EXPS_PER_CLOCK_PER_SM * mhz * 1e6, mhz


def roofline_ms(nbytes: float,
                work: Iterable[Tuple[float, float]] = ()) -> Tuple[float, str]:
    """The least time in ms the card could take for a function that moves
    ``nbytes`` through device memory and does, for each (count, rate) of
    ``work``, ``count`` operations at ``rate`` per second (products at the
    peak of their type, exponentials at ``sfu_exp_rate``): the largest of
    those times, and what bounds it ("bytes" or "operations")."""
    t_bytes = nbytes / H100_SXM["hbm_bytes_per_s"]
    t_ops = max((count / rate for count, rate in work if count), default=0.0)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flops_per_token(cfg: GPTConfig, seq_len: Optional[int] = None) -> float:
    """Training FLOPs per token: 6 N_matmul plus the attention term
    12 L d T (the 6ND model with the quadratic-attention correction)."""
    t = seq_len or cfg.block_size
    d, l, v = cfg.n_embd, cfg.n_layer, cfg.vocab_size
    ffn = int(cfg.ffn_mult * d)
    kv = cfg.kv_heads * cfg.head_dim
    per_layer = d * (d + 2 * kv) + d * d  # qkv + out proj
    per_layer += (3 if cfg.swiglu else 2) * d * ffn
    n_matmul = l * per_layer + d * v  # + lm head (embeddings are gathers)
    return 6 * n_matmul + 12 * l * d * t


class MetricsLogger:
    """The step line to stdout and, with ``jsonl_path``, one JSON object
    per logged step (``kind: "train_step"``); with ``tensorboard_dir``, one
    TensorBoard scalar per key; always the ``mingpt_train_*`` gauges of
    ``registry`` (a private one by default)."""

    def __init__(self, cfg: GPTConfig, *, jsonl_path: Optional[str] = None,
                 peak: Optional[float] = None, enabled: bool = True,
                 tensorboard_dir: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.cfg = cfg
        self.peak = peak
        self.enabled = enabled
        self._jsonl = open(jsonl_path, "a") if (enabled and jsonl_path) else None
        self._tb = None
        if enabled and tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=tensorboard_dir)
            except Exception as e:  # an optional sink: keep the others
                log_event(f"tensorboard sink unavailable ({e}); continuing")
        self._last: Optional[tuple] = None  # (step, perf_counter)
        self.registry = registry if registry is not None else MetricsRegistry()
        self._step_gauge = self.registry.gauge(
            "mingpt_train_step", help="last logged training step")
        # the headline families are on the page from the start: MFU may
        # never be observed on a card missing from the peak table
        self._gauges = {
            key: self.registry.gauge(f"mingpt_train_{key}", help=help_)
            for key, help_ in (
                ("loss", "training loss (global mean over the batch)"),
                ("mfu", "model FLOPs utilization against the card's peak"))}

    def _gauge(self, key: str):
        g = self._gauges.get(key)
        if g is None:
            g = self.registry.gauge(f"mingpt_train_{_GAUGE_SAFE_RE.sub('_', key)}",
                                    help=f"training scalar {key!r}")
            self._gauges[key] = g
        return g

    def log_step(self, step: int, tokens_per_step: int, seq_len: int,
                 scalars: Dict[str, Any]) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"step": step}
        rec.update({k: float(v) for k, v in scalars.items()})
        now = time.perf_counter()
        if self._last is not None and step > self._last[0]:
            tps = tokens_per_step * (step - self._last[0]) / (now - self._last[1])
            rec["tokens_per_sec"] = tps
            flops = flops_per_token(self.cfg, seq_len) * tps
            rec["flops_per_sec"] = flops
            if self.peak:
                rec["mfu"] = flops / self.peak
        self._last = (step, now)
        self._step_gauge.set(step)
        for k, v in rec.items():
            if k != "step":
                self._gauge(k).set(v)
        if self.enabled:
            # graftlint: disable-next=GL010 (the CLI's step line, read from its start)
            print(" | ".join([f"step {step}"] + [
                f"{k} {v:.4g}" for k, v in rec.items() if k != "step"]),
                flush=True)
            if self._jsonl is not None:
                self._jsonl.write(json.dumps({"kind": "train_step", **rec}) + "\n")
                self._jsonl.flush()
            if self._tb is not None:
                for k, v in rec.items():
                    if k != "step":
                        self._tb.add_scalar(k, v, step)
        return rec

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
