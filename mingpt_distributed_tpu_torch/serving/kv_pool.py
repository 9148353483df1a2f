"""Slot-based KV-cache pool and the shared-prefix KV store.

Counterpart of ``mingpt_distributed_tpu/serving/kv_pool.py``. One fixed
``(n_layer, n_slots, block_size, kv_heads, head_dim)`` pair of K/V buffers:
``models/generate.init_cache`` with the batch axis read as a *slot* axis.
Each slot holds one in-flight request's cache; a request is admitted by
prefilling its prompt into a free slot and retired by returning the slot
to the free list. Stale K/V from a previous tenant never leaks into
attention, because masking is positional and every writer fills a row with
real data before the first query that could see it (the stale-row
invariant, serving/engine.py). The buffers never change shape: the engine
writes into them in place. A quantized pool (``quant``: int8 or fp8)
holds four leaves, the payloads ``k``/``v`` and their fp32 scale planes
``k_scale``/``v_scale`` shaped like the data with ``head_dim -> 1``
(serving/quant.py).

Allocation is deterministic (lowest free index first), so a given arrival
order always produces the same slot placement.

Under tensor parallelism (serving/engine.py) each rank's pool holds its
``kv_heads/tp`` heads (``kv_heads``), and each rank's prefix entries the
same heads of their rows. The driver's store then counts every entry's
bytes times ``shard_count``, the whole entry's size, so the budget means
what it means at tp = 1 and evicts alike; ``on_evict`` tells the driver
which entries its followers must drop.

``PrefixKVStore`` is the byte-bounded LRU behind shared-prefix reuse (the
system-prompt case): entries are device-resident ``(L, 1, P, KV, hd)`` K/V
row blocks keyed by the exact token tuple they encode (with the scale
planes on a quantized pool), with P on the engine's bucket ladder. A
request whose prompt extends a stored entry copies its rows instead of
recomputing them and prefills only the tail.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import torch

from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models.generate import Cache, init_cache
from mingpt_distributed_tpu_torch.serving import quant as quant_lib
from mingpt_distributed_tpu_torch.utils.device import Device, resolve_device


class SlotKVPool:
    """Fixed-slot KV cache + host-side free list. The device tensors live in
    ``.cache`` (``{"k", "v"}``, plus ``{"k_scale", "v_scale"}`` with a
    ``quant`` descriptor) and are written in place by the engine."""

    def __init__(self, cfg: GPTConfig, n_slots: int,
                 dtype: Optional[torch.dtype] = None,
                 device: Optional[Device] = None,
                 quant: Optional[quant_lib.KVQuant] = None,
                 kv_heads: Optional[int] = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.cfg = cfg
        self.n_slots = n_slots
        self.quant = quant
        dev = resolve_device(device)
        self.cache: Cache = (
            init_cache(cfg, n_slots, dev, dtype, kv_heads) if quant is None
            else quant_lib.init_quant_cache(cfg, n_slots, quant, dev, kv_heads))
        self._free: List[int] = list(range(n_slots))  # kept sorted
        # the lockstep engine's driver mirrors each claim and release to its
        # followers' pools: called with ("allocate" | "free", slot)
        self.mirror: Optional[Callable[[str, int], None]] = None

    @property
    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in self.cache.values())

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.n_slots - len(self._free)

    def allocate(self) -> Optional[int]:
        """Claim the lowest free slot index, or None when exhausted."""
        if not self._free:
            return None
        slot = self._free.pop(0)
        if self.mirror is not None:
            self.mirror("allocate", slot)
        return slot

    def free(self, slot: int) -> None:
        """Return a slot to the pool (a double free would let two requests
        share a cache slot, so it raises)."""
        if not (0 <= slot < self.n_slots):
            raise ValueError(f"slot {slot} outside [0, {self.n_slots})")
        if slot in self._free:
            raise ValueError(f"slot {slot} is already free (double free)")
        self._free.append(slot)
        self._free.sort()
        if self.mirror is not None:
            self.mirror("free", slot)

    def claim(self, slot: int) -> None:
        """Take ``slot`` off the free list (a follower replaying its
        driver's ``allocate``); raises when the lists disagree."""
        if not self._free or self._free[0] != slot:
            raise RuntimeError(f"slot {slot} claimed, the pool's next free "
                               f"slot is {self._free[:1]}")
        self._free.pop(0)


class PrefixKVStore:
    """Bounded LRU of shared-prefix KV entries.

    Keys are exact token tuples (the prefix the rows encode, so a hit can
    never alias two different prefixes); values are lane dicts
    (``{"k", "v"}``, plus the ``{"k_scale", "v_scale"}`` planes of a
    quantized pool) of shape (L, 1, P, KV, hd) with P = len(key).
    ``capacity_bytes`` bounds the sum of every leaf's bytes (a quantized
    store fits ~4x the prefixes of an fp32 one); inserting past it
    evicts least-recently-used entries first. An entry larger than the
    whole budget is refused rather than thrashing the store empty.
    """

    def __init__(self, capacity_bytes: int, shard_count: int = 1,
                 on_evict: Optional[Callable[[Tuple[int, ...]], None]] = None):
        if capacity_bytes < 1:
            raise ValueError(
                f"capacity_bytes must be >= 1, got {capacity_bytes}")
        self.capacity_bytes = capacity_bytes
        self.shard_count = int(shard_count)
        self.on_evict = on_evict
        self.used_bytes = 0
        self._entries: "OrderedDict[Tuple[int, ...], dict]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def contains(self, key: Tuple[int, ...]) -> bool:
        return key in self._entries

    def entries(self):
        """(key, lane-dict) pairs in LRU order (read-only introspection)."""
        return list(self._entries.items())

    def _nbytes(self, kv) -> int:
        return self.shard_count * sum(int(a.nbytes) for a in kv.values())

    def lookup(self, tokens: Tuple[int, ...]):
        """Longest stored entry that is a *proper* prefix of ``tokens``
        (P < len(tokens): the tail must keep >= 1 token to prefill, since
        the first sampled token needs the last prompt position's logits).
        Returns (rows, lane-dict) or None; a hit refreshes LRU order."""
        best_key = None
        for key in self._entries:
            p = len(key)
            if p < len(tokens) and tokens[:p] == key:
                if best_key is None or p > len(best_key):
                    best_key = key
        if best_key is None:
            return None
        self._entries.move_to_end(best_key)
        return len(best_key), self._entries[best_key]

    def insert(self, key: Tuple[int, ...], kv) -> bool:
        """Store rows for ``key``; evict LRU entries until it fits.
        Returns False when the entry alone exceeds the byte budget or the
        key is already present (refreshed, not replaced: the rows are
        deterministic functions of the tokens)."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        need = self._nbytes(kv)
        if need > self.capacity_bytes:
            return False
        while self.used_bytes + need > self.capacity_bytes:
            old_key, old = self._entries.popitem(last=False)
            self.used_bytes -= self._nbytes(old)
            if self.on_evict is not None:
                self.on_evict(old_key)
        self._entries[key] = kv
        self.used_bytes += need
        return True
