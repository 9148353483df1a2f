"""Performance attribution: where the operations, bytes and device time go.

Counterpart of ``mingpt_distributed_tpu/telemetry/attribution.py``: two
ledgers and one ``mingpt-attrib/1`` report, which the JAX package's
validator accepts.

* :class:`ProgramLedger`: every call family (a prefill bucket, the decode
  step, verify, the draft's families, a train step) registers once per
  input shape with the operations and bytes of one call, then accumulates
  call counts and device seconds from the loop that owns the clock. The
  JAX engine registers compiled programs with XLA's ``cost_analysis()``
  and their compile time; PyTorch runs eagerly, so the port's counts are
  analytic (``forward_cost``: the model's matrix products, as
  ``torch.utils.flop_counter`` counts them, and the bytes each call must
  read and write at least) and ``compile_s`` stays 0.0. Device seconds come
  from CUDA events around each call on a card, the injected clock on the
  CPU. Per family the report gives the roofline position against
  ``telemetry/peaks.py``: arithmetic intensity, the roofline ceiling on MFU
  (``min(1, intensity / machine balance)``) and the measured MFU.
* :class:`HBMLedger`: bytes by owner from shapes and dtypes (params,
  optimizer moments, the KV pool and its scale planes, the prefix store,
  the draft's params and pool), a leak audit against what the CUDA caching
  allocator holds (``torch.cuda.memory_allocated``, where JAX reads
  ``jax.live_arrays()``), and the headroom against the card's capacity.
  Each owner also has a per-device column: under serving tensor
  parallelism a rank holds ``1/tp`` of the KV pool, so ``kv_pool``'s
  per-device bytes are the rank's own (``per_device_tree_bytes``) and its
  total those times the shard count; a rank's audit and headroom read
  the owners' per-device bytes against its own allocator and card (JAX's
  ``jax.live_arrays()`` sees every device, so it audits the totals).

Clock discipline: this module reads no clock. Durations arrive measured.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import torch

from mingpt_distributed_tpu_torch.telemetry.peaks import (
    peak_flops_per_chip,
    peak_hbm_bytes_per_chip,
    peak_hbm_capacity_per_chip,
)
from mingpt_distributed_tpu_torch.telemetry.registry import MetricsRegistry

__all__ = [
    "ATTRIB_SCHEMA",
    "HBMLedger",
    "ProgramLedger",
    "build_attrib_report",
    "dump_attrib_report",
    "forward_cost",
    "per_device_tree_bytes",
    "render_attrib_report",
    "tree_bytes",
    "validate_attrib_report",
]

ATTRIB_SCHEMA = "mingpt-attrib/1"


# ---------------------------------------------------------------------
# Program ledger
# ---------------------------------------------------------------------


class _ProgramStats:
    __slots__ = ("compiles", "compile_s", "flops", "bytes_accessed",
                 "calls", "device_s")

    def __init__(self) -> None:
        self.compiles = 0
        self.compile_s = 0.0
        self.flops: Optional[float] = None
        self.bytes_accessed: Optional[float] = None
        self.calls = 0
        self.device_s = 0.0


class ProgramLedger:
    """Per-call-family cost ledger. ``variant`` separates the shapes of a
    family (prefill buckets, verify's k) inside one row group."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self._programs: Dict[Tuple[str, str], _ProgramStats] = {}
        r = self.registry
        labels = ("family", "variant")
        self._g_flops = r.gauge(
            "mingpt_attrib_flops",
            help="operations of one call of this family (analytic)",
            labels=labels)
        self._g_bytes = r.gauge(
            "mingpt_attrib_bytes_accessed",
            help="device bytes one call reads and writes at least",
            labels=labels)
        self._g_compile = r.gauge(
            "mingpt_attrib_compile_seconds",
            help="cumulative compile wall-time of this family (0 when eager)",
            labels=labels)
        self._c_calls = r.counter(
            "mingpt_attrib_calls_total",
            help="invocations observed for this program family",
            labels=labels)
        self._c_device = r.counter(
            "mingpt_attrib_device_seconds_total",
            help="device seconds spent in this family (CUDA events)",
            labels=labels)
        self._g_mfu = r.gauge(
            "mingpt_attrib_mfu",
            help="measured model FLOPs utilisation vs the card's peak "
                 "(absent off the peak table)",
            labels=labels)

    def observe_compile(self, family: str, compile_s: float,
                        flops: Optional[float], bytes_accessed: Optional[float],
                        variant: str = "") -> None:
        """Register one shape of a family with the cost of one call (a
        re-registration without a cost keeps the last one)."""
        st = self._programs.setdefault((family, variant), _ProgramStats())
        st.compiles += 1
        st.compile_s += float(compile_s)
        if flops is not None:
            st.flops = float(flops)
        if bytes_accessed is not None:
            st.bytes_accessed = float(bytes_accessed)
        lab = dict(family=family, variant=variant)
        self._g_compile.labels(**lab).set(st.compile_s)
        if st.flops is not None:
            self._g_flops.labels(**lab).set(st.flops)
        if st.bytes_accessed is not None:
            self._g_bytes.labels(**lab).set(st.bytes_accessed)
        # pre-touch the call counters: a registered family that is never
        # called still shows on the scrape page at 0
        self._c_calls.labels(**lab)
        self._c_device.labels(**lab)

    def observe_call(self, family: str, seconds: float, variant: str = "",
                     n: int = 1) -> None:
        st = self._programs.setdefault((family, variant), _ProgramStats())
        st.calls += int(n)
        st.device_s += float(seconds)
        lab = dict(family=family, variant=variant)
        self._c_calls.labels(**lab).inc(int(n))
        self._c_device.labels(**lab).inc(float(seconds))
        mfu = _measured_mfu(st, peak_flops_per_chip())
        if mfu is not None:
            self._g_mfu.labels(**lab).set(mfu)

    def families(self) -> List[str]:
        return sorted({fam for fam, _ in self._programs})

    def rows(self) -> List[Dict[str, Any]]:
        """One report row per (family, variant), sorted; the roofline
        fields against the peak table (None off it, e.g. on the CPU)."""
        peak_f = peak_flops_per_chip()
        peak_bw = peak_hbm_bytes_per_chip()
        out = []
        for family, variant in sorted(self._programs):
            st = self._programs[(family, variant)]
            ai = None
            if st.flops is not None and st.bytes_accessed:
                ai = st.flops / st.bytes_accessed
            expected_mfu = None
            if ai is not None and peak_f and peak_bw:
                expected_mfu = min(1.0, ai / (peak_f / peak_bw))
            out.append({
                "family": family, "variant": variant,
                "compiles": st.compiles, "compile_s": st.compile_s,
                "flops": st.flops, "bytes_accessed": st.bytes_accessed,
                "calls": st.calls, "device_s": st.device_s,
                "arith_intensity": ai, "expected_mfu": expected_mfu,
                "measured_mfu": _measured_mfu(st, peak_f),
            })
        return out


def _measured_mfu(st: _ProgramStats, peak_f: Optional[float]) -> Optional[float]:
    if st.flops is None or not peak_f or st.device_s <= 0 or st.calls < 1:
        return None
    return (st.flops * st.calls / st.device_s) / peak_f


def forward_cost(cfg: Any, rows: int, tokens: int, context: int,
                 weight_bytes: int, kv_bytes_per_token: int,
                 per_row: bool = False, head_rows: Optional[int] = None
                 ) -> Tuple[float, float]:
    """(operations, bytes) of one cached forward of ``rows`` x ``tokens``
    new tokens against ``context`` cache positions per row, with the LM
    head at ``head_rows`` positions (default: one per row; verify reads
    every row).

    Operations: 2 x multiply-adds of the matrix products (q/k/v/o, the MLP
    or the routed experts as ``ops/moe.moe_flops`` counts them, the
    attention's two products over the whole cache slice, the head).
    Bytes: every weight once (``weight_bytes``), the cache rows attended
    once (``kv_bytes_per_token`` x context x rows) and the new rows written."""
    from mingpt_distributed_tpu_torch.ops import moe

    d, nl, nh, hd = cfg.n_embd, cfg.n_layer, cfg.n_head, cfg.head_dim
    kv = cfg.kv_heads
    ffn = int(cfg.ffn_mult * d)
    n = rows * tokens
    proj = 2 * n * d * (nh * hd + 2 * kv * hd) + 2 * n * nh * hd * d
    if cfg.n_experts:
        mlp = moe.moe_flops(n, d, ffn, cfg.n_experts, cfg.moe_top_k,
                            cfg.moe_capacity_factor, cfg.swiglu,
                            per_row=per_row, rows=rows)
    else:
        mlp = 2 * n * d * ffn * (3 if cfg.swiglu else 2)
    attn = 2 * 2 * n * nh * hd * context
    head = 2 * (rows if head_rows is None else head_rows) * d * cfg.vocab_size
    flops = nl * (proj + mlp + attn) + head
    nbytes = weight_bytes + kv_bytes_per_token * (rows * context + n)
    return float(flops), float(nbytes)


# ---------------------------------------------------------------------
# HBM ledger
# ---------------------------------------------------------------------


def tree_bytes(tree: Any) -> int:
    """Bytes of a (nested dict / list) tree of tensors, from shapes and
    dtypes."""
    if torch.is_tensor(tree):
        return int(tree.numel()) * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def per_device_tree_bytes(tree: Any) -> int:
    """Bytes one device holds of a tree. The port's tensors are a rank's
    own (a tp rank's pool holds its kv_heads/tp heads), so a rank's tree
    counts its size: ``tree_bytes`` under the name the JAX package gives
    the per-device column."""
    return tree_bytes(tree)


class HBMLedger:
    """Bytes-by-owner device-memory accounting plus the leak audit.

    ``account(owner, nbytes, per_device_bytes=None)`` is declarative (set,
    not add); ``per_device_bytes`` is the owner's residency on one device
    (total/tp for a tp-sharded owner; default ``nbytes``). ``audit()``
    compares the bytes the owners hold on this rank's device
    (``per_device_total``) with what the CUDA caching allocator holds on
    ``device`` (``torch.cuda.memory_allocated``, this rank's alone): a
    growing unattributed residue is the leak signal. The headroom is the
    card's capacity less the same per-device bytes."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 capacity_bytes: Optional[float] = None,
                 device: Optional[torch.device] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.capacity_bytes = (capacity_bytes if capacity_bytes is not None
                               else peak_hbm_capacity_per_chip())
        self.device = device
        self._owners: Dict[str, int] = {}
        self._per_device: Dict[str, int] = {}
        r = self.registry
        self._g_owner = r.gauge(
            "mingpt_attrib_hbm_bytes",
            help="accounted HBM bytes by owner (shapes/dtypes, exact)",
            labels=("owner",))
        self._g_owner_pd = r.gauge(
            "mingpt_attrib_hbm_per_device_bytes",
            help="accounted HBM bytes by owner on one device (total/tp for "
                 "tp-sharded owners, == total unsharded)",
            labels=("owner",))
        self._g_total = r.gauge(
            "mingpt_attrib_hbm_total_bytes",
            help="sum of accounted HBM bytes across owners")
        self._g_live = r.gauge(
            "mingpt_attrib_hbm_live_bytes",
            help="bytes the CUDA caching allocator holds in tensors")
        self._g_unattr = r.gauge(
            "mingpt_attrib_hbm_unattributed_bytes",
            help="allocated bytes no owner accounts for (leak audit residue)")
        self._g_headroom = r.gauge(
            "mingpt_attrib_hbm_headroom_bytes",
            help="card memory capacity minus the bytes accounted on this "
                 "device (absent "
                 "without a card)")

    def account(self, owner: str, nbytes: int,
                per_device_bytes: Optional[int] = None) -> None:
        if nbytes < 0:
            raise ValueError(f"owner {owner!r}: negative bytes {nbytes}")
        if per_device_bytes is None:
            per_device_bytes = nbytes
        if not 0 <= per_device_bytes <= nbytes:
            raise ValueError(f"owner {owner!r}: per_device_bytes "
                             f"{per_device_bytes} outside [0, {nbytes}]")
        self._owners[owner] = int(nbytes)
        self._per_device[owner] = int(per_device_bytes)
        self._g_owner.labels(owner=owner).set(int(nbytes))
        self._g_owner_pd.labels(owner=owner).set(int(per_device_bytes))
        self._g_total.set(self.total_bytes())
        if self.capacity_bytes is not None:
            self._g_headroom.set(self.capacity_bytes - self.per_device_total())

    def owners(self) -> Dict[str, int]:
        return dict(sorted(self._owners.items()))

    def per_device(self) -> Dict[str, int]:
        """Per-owner bytes on one device, the keys of ``owners()``."""
        return dict(sorted(self._per_device.items()))

    def total_bytes(self) -> int:
        return sum(self._owners.values())

    def per_device_total(self) -> int:
        """Bytes the owners hold on this rank's device: ``total_bytes()``
        on one device, the rank's share under tp."""
        return sum(self._per_device.values())

    def live_bytes(self) -> int:
        if self.device is None or torch.device(self.device).type != "cuda":
            raise RuntimeError("the leak audit reads the CUDA caching "
                               "allocator: give the ledger a cuda device")
        return int(torch.cuda.memory_allocated(self.device))

    def audit(self) -> Dict[str, int]:
        """This rank's owned bytes against its allocator's. Process state
        (every tensor on the card counts), so reports leave it out unless
        asked."""
        owned = self.per_device_total()
        live = self.live_bytes()
        self._g_live.set(live)
        self._g_unattr.set(max(0, live - owned))
        return {"owned_bytes": owned, "live_bytes": live,
                "unattributed_bytes": max(0, live - owned)}


# ---------------------------------------------------------------------
# mingpt-attrib/1 report
# ---------------------------------------------------------------------


def build_attrib_report(programs: ProgramLedger, hbm: Optional[HBMLedger] = None,
                        include_live: bool = False) -> Dict[str, Any]:
    """The versioned report; ``include_live`` folds the allocator audit in
    (off by default: allocated bytes are process history, not run state,
    and would break the byte-identical reports of two identical runs)."""
    report: Dict[str, Any] = {
        "schema": ATTRIB_SCHEMA,
        "programs": programs.rows(),
        "peaks": {
            "flops_per_chip": peak_flops_per_chip(),
            "hbm_bandwidth_per_chip": peak_hbm_bytes_per_chip(),
            "hbm_capacity_per_chip": peak_hbm_capacity_per_chip(),
        },
    }
    if hbm is not None:
        owners = hbm.owners()
        block: Dict[str, Any] = {
            "owners": owners,
            "per_device_bytes": hbm.per_device(),
            "total_bytes": hbm.total_bytes(),
            "capacity_bytes": hbm.capacity_bytes,
            "headroom_bytes": (None if hbm.capacity_bytes is None
                               else hbm.capacity_bytes - hbm.per_device_total()),
        }
        if include_live:
            block["audit"] = hbm.audit()
        report["hbm"] = block
    return report


_PROGRAM_KEYS = {
    "family": str, "variant": str, "compiles": int, "compile_s": float,
    "flops": float, "bytes_accessed": float, "calls": int,
    "device_s": float, "arith_intensity": float, "expected_mfu": float,
    "measured_mfu": float,
}
_NULLABLE = {"flops", "bytes_accessed", "arith_intensity", "expected_mfu",
             "measured_mfu"}


def validate_attrib_report(report: Dict[str, Any]) -> None:
    """Strict structural validation (raises ValueError): the JAX package's
    rules for rows, owners and totals."""
    if report.get("schema") != ATTRIB_SCHEMA:
        raise ValueError(
            f"not a {ATTRIB_SCHEMA} report: schema={report.get('schema')!r}")
    progs = report.get("programs")
    if not isinstance(progs, list):
        raise ValueError("programs must be a list")
    seen = set()
    for i, row in enumerate(progs):
        if not isinstance(row, dict):
            raise ValueError(f"programs[{i}] is not an object")
        missing = set(_PROGRAM_KEYS) - set(row)
        if missing:
            raise ValueError(f"programs[{i}] missing {sorted(missing)}")
        for key, typ in _PROGRAM_KEYS.items():
            v = row[key]
            if v is None:
                if key in _NULLABLE:
                    continue
                raise ValueError(f"programs[{i}].{key} must not be null")
            if typ is float and isinstance(v, int):
                v = float(v)
            if not isinstance(v, typ) or isinstance(v, bool):
                raise ValueError(f"programs[{i}].{key}={v!r} is not {typ.__name__}")
        if row["compiles"] < 0 or row["calls"] < 0 or row["compile_s"] < 0 \
                or row["device_s"] < 0:
            raise ValueError(f"programs[{i}] has negative accounting")
        key = (row["family"], row["variant"])
        if key in seen:
            raise ValueError(f"duplicate program row {key}")
        seen.add(key)
    hbm = report.get("hbm")
    if hbm is not None:
        owners = hbm.get("owners")
        if not isinstance(owners, dict):
            raise ValueError("hbm.owners must be an object")
        for owner, nb in owners.items():
            if not isinstance(nb, int) or isinstance(nb, bool) or nb < 0:
                raise ValueError(f"hbm.owners[{owner!r}]={nb!r} is not a "
                                 "non-negative integer")
        if hbm.get("total_bytes") != sum(owners.values()):
            raise ValueError(f"hbm.total_bytes={hbm.get('total_bytes')!r} != "
                             f"sum of owners {sum(owners.values())}")
        pd = hbm.get("per_device_bytes")
        if pd is not None and (not isinstance(pd, dict) or set(pd) != set(owners)):
            raise ValueError("hbm.per_device_bytes must name the owners")
    if not isinstance(report.get("peaks"), dict):
        raise ValueError("peaks must be an object")


def dump_attrib_report(report: Dict[str, Any]) -> str:
    """Canonical serialisation: sorted keys, fixed separators."""
    return json.dumps(report, sort_keys=True, indent=2)


def render_attrib_report(report: Dict[str, Any]) -> str:
    """Human-readable per-family table, line for line the JAX package's
    (its ``compile_s`` column shows what ``observe_compile`` recorded: 0
    unless a caller reports compile time)."""

    def _cell(v: Optional[float]) -> str:
        return "n/a" if v is None else f"{v:.4g}"

    lines = [f"Attribution report ({report['schema']}): "
             f"{len(report['programs'])} program rows",
             f"  {'family':<16} {'variant':<10} {'flops':>10} {'bytes':>10} "
             f"{'compile_s':>10} {'calls':>7} {'device_s':>10} {'mfu':>8}"]
    for row in report["programs"]:
        lines.append(
            f"  {row['family']:<16} {row['variant']:<10} "
            f"{_cell(row['flops']):>10} {_cell(row['bytes_accessed']):>10} "
            f"{row['compile_s']:>10.4g} {row['calls']:>7} "
            f"{row['device_s']:>10.4g} {_cell(row['measured_mfu']):>8}")
    hbm = report.get("hbm")
    if hbm:
        lines.append(f"  HBM: total {hbm['total_bytes']} bytes"
                     + ("" if hbm.get("headroom_bytes") is None else
                        f", headroom {hbm['headroom_bytes']:.3g}"))
        per_device = hbm.get("per_device_bytes") or {}
        for owner, nb in hbm["owners"].items():
            one = per_device.get(owner)
            suffix = "" if one is None or one == nb else f"  ({one} / device)"
            lines.append(f"    {owner:<20} {nb:>14}{suffix}")
    return "\n".join(lines)
