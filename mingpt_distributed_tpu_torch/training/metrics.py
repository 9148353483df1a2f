"""Training metrics: the FLOP model, the card's peak table, and the step
line (stdout, optionally a JSONL file).

Counterpart of ``mingpt_distributed_tpu/training/metrics.py``. The step
line carries step, loss, lr, grad_norm, update_norm, tokens/s and MFU;
tokens/s and MFU are taken over the window since the previous logged step
(the loop syncs with the card only at logged steps).
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional

from mingpt_distributed_tpu_torch.config import GPTConfig

# Published peaks of the cards the port runs on (NVIDIA data sheets; dense,
# no sparsity), keyed by a substring of torch.cuda.get_device_name(). The
# rates assume the card's full power limit (700 W for the H100 SXM).
PEAKS: Dict[str, Dict[str, float]] = {
    "H100": {"bfloat16": 989e12, "float32": 67e12, "hbm_bytes_per_s": 3.35e12},
}
H100_SXM = PEAKS["H100"]


def peak_flops(device_name: str, dtype: str) -> Optional[float]:
    """The card's peak operations per second for ``dtype``, or None when the
    card (or the CPU) is not in the table."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks.get(dtype)
    return None


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
    per logged step (``kind: "train_step"``)."""

    def __init__(self, cfg: GPTConfig, *, jsonl_path: Optional[str] = None,
                 peak: Optional[float] = None, enabled: bool = True):
        self.cfg = cfg
        self.peak = peak
        self.enabled = enabled
        self._jsonl = open(jsonl_path, "a") if (enabled and jsonl_path) else None
        self._last: Optional[tuple] = None  # (step, perf_counter)

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
        if self.enabled:
            print(" | ".join([f"step {step}"] + [
                f"{k} {v:.4g}" for k, v in rec.items() if k != "step"]),
                flush=True)
            if self._jsonl is not None:
                self._jsonl.write(json.dumps({"kind": "train_step", **rec}) + "\n")
                self._jsonl.flush()
        return rec

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
