"""Per-policy cost model: what a cell (or a live fleet) actually paid.

Counterpart of ``mingpt_distributed_tpu/control/cost.py``, the port's own
copy.

``deadline_hit_rate`` alone ranks policies only on the axis they were
tuned for. The cost model folds the two failure currencies the traffic
lab observes into one comparable figure per cell:

* **deadline misses per token served** — a miss on a fleet that served
  a million tokens is cheaper than a miss on one that served ten;
  normalising by tokens makes cells at different rungs comparable.
* **shed-weighted goodput** — tokens that reached callers, discounted
  by the fraction of demand the fleet refused at the door. A policy
  that "wins" p99 by shedding half its load pays for it here.

One implementation serves both inputs: :func:`cost_from_cell` adapts a
trafficlab policy cell, :func:`cost_from_signals` adapts a live
:class:`~mingpt_distributed_tpu_torch.control.signals.SignalSampler` — both
reduce to the same ``counts`` dict and call :func:`compute_cost`, so a
number in a sweep report and the same number scraped live can never
drift apart.

All arithmetic is exact over ints (one final division per figure), so
byte-identical cells produce byte-identical cost blocks.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

__all__ = ["compute_cost", "cost_from_cell", "cost_from_signals"]

#: input shape shared by both adapters
_COUNT_KEYS = ("completed", "shed", "expired", "errors", "tokens",
               "deadline_requests", "deadline_hits")


def compute_cost(counts: Mapping[str, int]) -> Dict[str, Any]:
    """The shared cost implementation over terminal-outcome counts.

    Returns:
      * ``deadline_miss_per_ktok`` — deadline misses per 1000 tokens
        served (0.0 when no deadlines were in play).
      * ``shed_rate`` — refused / demanded.
      * ``goodput_tokens`` — tokens served × (1 − shed_rate).
      * ``cost`` — the headline scalar, lower is better:
        misses-per-token + shed_rate. Both terms are dimensionless
        failure fractions, so the sum orders policies sensibly without
        tuned weights.
    """
    missing = [k for k in _COUNT_KEYS if k not in counts]
    if missing:
        raise ValueError(f"cost counts missing keys: {missing}")
    vals = {k: int(counts[k]) for k in _COUNT_KEYS}
    bad = {k: v for k, v in vals.items() if v < 0}
    if bad:
        raise ValueError(f"cost counts must be >= 0, got {bad}")
    if vals["deadline_hits"] > vals["deadline_requests"]:
        raise ValueError(
            f"deadline_hits {vals['deadline_hits']} > deadline_requests "
            f"{vals['deadline_requests']}")
    tokens = vals["tokens"]
    demanded = (vals["completed"] + vals["shed"] + vals["expired"]
                + vals["errors"])
    misses = vals["deadline_requests"] - vals["deadline_hits"]
    shed_rate = vals["shed"] / demanded if demanded else 0.0
    miss_per_tok = misses / tokens if tokens else float(misses)
    return {
        "deadline_miss_per_ktok": 1000.0 * miss_per_tok,
        "shed_rate": shed_rate,
        "goodput_tokens": tokens * (1.0 - shed_rate),
        "cost": miss_per_tok + shed_rate,
    }


def cost_from_cell(cell: Mapping[str, Any]) -> Dict[str, Any]:
    """Adapt one trafficlab policy cell (runner.py ``_run_one`` output).

    The cell stores ``deadline_hit_rate`` rather than the hit count;
    hits = rate × requests round-trips exactly because the rate was
    computed as hits/requests over small ints. A cell with no
    deadline-carrying requests stores ``None`` for the rate — zero
    requests, zero hits."""
    requests = int(cell["deadline_requests"])
    rate_raw = cell["deadline_hit_rate"]
    hits = 0 if rate_raw is None else int(round(float(rate_raw) * requests))
    return compute_cost({
        "completed": cell["completed"],
        "shed": cell["shed"],
        "expired": cell["expired"],
        "errors": cell["errors"],
        "tokens": cell["tokens"],
        "deadline_requests": requests,
        "deadline_hits": hits,
    })


def cost_from_signals(sampler) -> Dict[str, Any]:
    """Adapt a live :class:`SignalSampler`'s cumulative counters."""
    return compute_cost(sampler.counts())
