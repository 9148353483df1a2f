"""Multi-tenant workload mixes rendered into concrete Requests.

Counterpart of ``mingpt_distributed_tpu/trafficlab/workloads.py``: the
same ``(seed, mix, arrival trace)`` renders the same requests, and the
same ``trace_digest``, in both packages.

A :class:`WorkloadMix` is a weighted set of :class:`TenantSpec`s —
request *families* (chat, completion, long-context, shared-prefix) with
per-tenant prompt-length and max-token distributions, deadlines, and
optional shared-prefix pools that exercise the PrefixKVStore (many
requests opening with the same system-prompt tokens, so replica-level
prefix reuse and the router's prefix affinity both engage).

``render(arrivals, seed, ...)`` marries an arrival-time list from
``arrivals.py`` to sampled request bodies, producing a list of
:class:`TimedRequest` — plain data, fully determined by
``(seed, mix, arrival trace)``. ``TimedRequest.to_request()`` mints a
FRESH ``Request`` object on every call: the sweep runner replays the
same rendered trace once per policy, and handing each run its own
Request objects keeps them from seeing each other's mutations (the
router stamps ``trace`` onto the Request it routes).

Token ids are synthetic (uniform over the vocab) — the virtual schedule
depends on token counts, not on token *values*, and synthetic ids keep
the lab free of tokenizer dependencies.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mingpt_distributed_tpu_torch.serving.requests import Request
from mingpt_distributed_tpu_torch.trafficlab.arrivals import _stream_seed

__all__ = [
    "TenantSpec",
    "TimedRequest",
    "WorkloadMix",
    "default_mix",
    "trace_digest",
]

_FAMILIES = ("chat", "completion", "longctx", "prefix")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's request family.

    ``prompt_len`` / ``max_new`` are inclusive uniform-integer ranges.
    ``deadline_s`` is the per-request relative deadline (None = no
    deadline; the fleet then never sheds or expires it). A positive
    ``prefix_pool`` gives the tenant that many distinct shared prefixes
    of ``prefix_len`` tokens; each request opens with one of them, so
    ``prefix_pool=1`` is a single hot system prompt."""

    name: str
    family: str = "completion"
    weight: float = 1.0
    prompt_len: Tuple[int, int] = (4, 8)
    max_new: Tuple[int, int] = (4, 8)
    deadline_s: Optional[float] = None
    prefix_pool: int = 0
    prefix_len: int = 0

    def validate(self) -> None:
        if self.family not in _FAMILIES:
            raise ValueError(f"unknown family {self.family!r} "
                             f"(want one of {_FAMILIES})")
        if self.weight <= 0.0:
            raise ValueError(f"tenant {self.name!r} weight must be > 0")
        for label, (lo, hi) in (("prompt_len", self.prompt_len),
                                ("max_new", self.max_new)):
            if lo < 1 or hi < lo:
                raise ValueError(
                    f"tenant {self.name!r} {label} range ({lo}, {hi}) "
                    "must satisfy 1 <= lo <= hi")
        if self.prefix_pool < 0 or self.prefix_len < 0:
            raise ValueError("prefix_pool/prefix_len must be >= 0")
        if (self.prefix_pool > 0) != (self.prefix_len > 0):
            raise ValueError("prefix_pool and prefix_len go together")
        if self.prefix_len >= self.prompt_len[0]:
            if self.prefix_len > 0:
                raise ValueError(
                    f"tenant {self.name!r} prefix_len {self.prefix_len} "
                    f"must be < min prompt_len {self.prompt_len[0]} so "
                    "every prompt has a unique suffix")

    def to_json(self) -> Dict[str, object]:
        out = dataclasses.asdict(self)
        out["prompt_len"] = list(self.prompt_len)
        out["max_new"] = list(self.max_new)
        return out


@dataclasses.dataclass(frozen=True)
class WorkloadMix:
    """A weighted multi-tenant mix plus the vocab the synthetic token
    ids draw from."""

    tenants: Tuple[TenantSpec, ...]
    vocab_size: int = 96

    def validate(self) -> None:
        if not self.tenants:
            raise ValueError("workload mix needs at least one tenant")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in mix: {names}")
        if self.vocab_size < 4:
            raise ValueError("vocab_size must be >= 4")
        for t in self.tenants:
            t.validate()

    def canonical(self) -> str:
        """Stable string form — part of the RNG stream key."""
        return json.dumps(
            {"vocab_size": self.vocab_size,
             "tenants": [t.to_json() for t in self.tenants]},
            sort_keys=True, separators=(",", ":"))

    def to_json(self) -> Dict[str, object]:
        return {"vocab_size": self.vocab_size,
                "tenants": [t.to_json() for t in self.tenants]}

    def render(self, arrivals: Sequence[float],
               seed: int) -> List["TimedRequest"]:
        """Attach a sampled request body to each arrival timestamp."""
        self.validate()
        rng = np.random.RandomState(_stream_seed(seed, self.canonical()))
        weights = np.asarray([t.weight for t in self.tenants], dtype=float)
        weights = weights / weights.sum()
        # pre-draw each tenant's shared-prefix pool so pool contents
        # don't depend on which requests happened to arrive first
        pools: Dict[str, List[Tuple[int, ...]]] = {}
        for t in self.tenants:
            if t.prefix_pool > 0:
                pools[t.name] = [
                    tuple(int(x) for x in rng.randint(
                        1, self.vocab_size, size=t.prefix_len))
                    for _ in range(t.prefix_pool)
                ]
        out: List[TimedRequest] = []
        for i, ts in enumerate(arrivals):
            t = self.tenants[int(rng.choice(len(self.tenants), p=weights))]
            n_prompt = int(rng.randint(t.prompt_len[0], t.prompt_len[1] + 1))
            n_new = int(rng.randint(t.max_new[0], t.max_new[1] + 1))
            if t.prefix_pool > 0:
                prefix = pools[t.name][int(rng.randint(0, t.prefix_pool))]
                suffix_len = max(1, n_prompt - len(prefix))
                body = tuple(int(x) for x in rng.randint(
                    1, self.vocab_size, size=suffix_len))
                prompt = prefix + body
            else:
                prompt = tuple(int(x) for x in rng.randint(
                    1, self.vocab_size, size=n_prompt))
            out.append(TimedRequest(
                t=float(ts),
                tenant=t.name,
                prompt=prompt,
                max_new_tokens=n_new,
                deadline_s=t.deadline_s,
                request_id=f"tr{i:05d}-{t.name}",
            ))
        return out


@dataclasses.dataclass(frozen=True)
class TimedRequest:
    """One rendered arrival: WHEN (absolute virtual seconds) and WHAT."""

    t: float
    tenant: str
    prompt: Tuple[int, ...]
    max_new_tokens: int
    deadline_s: Optional[float]
    request_id: str

    def to_request(self) -> Request:
        """Mint a fresh Request (greedy decode: policy comparisons grade
        scheduling, not sampling). Fresh per call — see module docstring."""
        return Request(
            prompt=list(self.prompt),
            max_new_tokens=self.max_new_tokens,
            do_sample=False,
            deadline_s=self.deadline_s,
            request_id=self.request_id,
            tenant=self.tenant,
        )

    def to_json(self) -> Dict[str, object]:
        return {
            "t": self.t,
            "tenant": self.tenant,
            "prompt": list(self.prompt),
            "max_new_tokens": self.max_new_tokens,
            "deadline_s": self.deadline_s,
            "request_id": self.request_id,
        }


def trace_digest(timed: Sequence[TimedRequest]) -> str:
    """sha256 over the canonical rendered trace — the report embeds it so
    "both policies saw the identical arrival trace" is checkable."""
    blob = json.dumps([tr.to_json() for tr in timed],
                      sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def default_mix(vocab_size: int = 96, block_size: int = 48) -> WorkloadMix:
    """The stock four-tenant mix, scaled to fit ``block_size`` (prompt +
    max_new - 1 must stay inside the decode window so strict validation
    passes on the tiny selftest config).

    * ``chat`` — short prompts, tight deadline: the tenant EDF saves.
    * ``batch`` — completion jobs, no deadline: the tenant that clogs
      FIFO queues ahead of chat under overload.
    * ``longctx`` — long prompts exercising chunked prefill.
    * ``assist`` — shared-prefix family over a small pool of system
      prompts, exercising the PrefixKVStore + router prefix affinity.
    """
    # proportions of the block budget; floors keep tiny configs sane
    long_prompt = max(6, (block_size * 2) // 3)
    mid_prompt = max(4, block_size // 4)
    short_new = max(2, block_size // 12)
    mid_new = max(3, block_size // 8)
    prefix_len = max(2, block_size // 8)
    return WorkloadMix(
        vocab_size=vocab_size,
        tenants=(
            TenantSpec(name="chat", family="chat", weight=4.0,
                       prompt_len=(3, mid_prompt),
                       max_new=(2, short_new), deadline_s=0.8),
            TenantSpec(name="batch", family="completion", weight=3.0,
                       prompt_len=(4, mid_prompt),
                       max_new=(mid_new, 2 * mid_new)),
            TenantSpec(name="longctx", family="longctx", weight=1.0,
                       prompt_len=(mid_prompt, long_prompt),
                       max_new=(2, short_new)),
            TenantSpec(name="assist", family="prefix", weight=2.0,
                       prompt_len=(prefix_len + 2, mid_prompt + prefix_len),
                       max_new=(2, mid_new), deadline_s=1.5,
                       prefix_pool=3, prefix_len=prefix_len),
        ),
    )
