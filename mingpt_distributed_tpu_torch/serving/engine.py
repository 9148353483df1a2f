"""Prefill and multi-slot decode for the continuous-batching server.

Counterpart of ``mingpt_distributed_tpu/serving/engine.py``. The JAX engine
compiles a bounded family of programs; PyTorch runs eagerly, so here the
same three families are plain calls on the port's cached forward
(``models/generate.py``: ``_forward_cached_hidden`` → ``_cached_block``, the
chain solo ``generate()`` runs, with the einsum ``causal_attention``):

1. **prefill-at-offset** — one forward over a right-padded token chunk
   against the slot's cache lane (a view of the pool, written in place) at
   absolute ``offset``; logits are read at ``length - 1`` and the next token
   is chosen on the device. The chunk is padded to the smallest covering
   **bucket** of a power-of-two ladder (``prefill_buckets``), so prefill
   work tracks the chunk length while the set of shapes stays bounded. The
   same call serves whole short prompts (offset 0), the per-round chunks
   of a long prompt (``prefill_chunk``) and the tail after a prefix hit.

2. **decode-step** — one token for every slot at once: the cached forward
   with a (S,) position tensor, each slot at its own position (its own
   K/V row written by advanced indexing, its own mask, ``wpe`` row or RoPE
   table: the batched form of the JAX engine's ``vmap`` over the solo
   decode body). Positions are clipped to ``block_size - 1``, where free
   and prefilling lanes are parked.

3. **prefix extract / install** (only when the prefix store is on) — row
   copies between a slot lane and a shared-prefix entry.

4. **verify** (speculative decoding, serving/speculative.py) — the
   prefill-at-offset forward over a fixed ``k + 1``-row chunk with the
   logits read at every row, each through the slot's own sampler.

A quantized pool (``kv_dtype`` int8 or fp8, serving/quant.py) keeps the
same calls and shapes. The JAX engine dequantizes the whole slot lane
before every prefill, decode and verify forward and requantizes the whole
lane after it; here each layer attends its dequantized rows and only the
rows the call writes are quantized into the pool
(``quant.write_layer_rows``). Power-of-two scales make requantizing an
untouched row return it bit for bit, so the int8 pool is the JAX engine's
(``tests/test_torch_quant.py``) without two whole-lane passes per call.

Padding correctness: the *stale-row invariant*. A cache row only becomes
visible to attention once a query position reaches it, and every writer
(prefill chunk or decode step) writes real K/V to a row *before* the first
query that could attend it (causal masking is positional, not value-based),
so rows past the real-token frontier may hold anything: pad garbage from a
bucket, a previous tenant's K/V, or a parked lane's scribbles at
``block_size - 1``. So admission never zeroes a slot, and chunked prefill
can interleave with decode.

Sampling: ``_select_next_slots`` applies ``generate._select_next``'s filter
order (temperature → top-k → top-p) with per-slot parameters. Greedy lanes
take the argmax of ``logits / temperature`` (the filters cannot move it)
and touch no generator, so a greedy request's tokens match solo
``generate()`` exactly whatever shares the batch. Each sampled request
draws from its own ``torch.Generator`` on the device, seeded from the
request, once per token, so a seed reproduces its request whatever its
co-tenants. ``jax.random`` and ``torch.Generator`` draw different numbers,
so sampled tokens are not compared with the JAX package's.

Bounded shapes: ``compile_counts()`` counts the distinct input shapes each
family has run (decode: the slot count; prefill: the bucket; prefix
copies: the row count), the JAX engine's contract of one decode program and
at most ``len(ladder)`` prefill programs, which is what a later CUDA-graph
capture of these calls needs.

5. **the migration seam** — ``migratable_rows``, ``extract_slot_rows``,
   ``install_slot_rows`` and ``adopt_prefix_entry`` move a slot's leading
   rows (on the bucket ladder only, through the prefix copies' shapes) to
   another engine: into its prefix store, or straight into a slot of an
   engine without one (the draft engine). A quantized pool's payloads and
   scale planes move as they are, bytes for bytes: nothing is requantized.
   The process fleet's wire that carries them is ROADMAP.md Queue 1 item
   15b.

Attribution (``register_attrib``) registers each family's shapes with
analytic costs. Tensor-parallel serving (``mesh``) is ROADMAP.md Queue 1
item 9, and the audit contracts (``audit_contracts``) item 16b.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models import generate as gen
from mingpt_distributed_tpu_torch.serving import quant as quant_lib
from mingpt_distributed_tpu_torch.serving.kv_pool import PrefixKVStore, SlotKVPool
from mingpt_distributed_tpu_torch.utils.device import Device, resolve_device

#: smallest default bucket: prompts below this pay one 64-token forward,
#: which already beats a block_size² prefill by >100x at block_size 1024
DEFAULT_MIN_BUCKET = 64

FAMILIES = ("prefill", "decode", "prefix_load", "prefix_save")


def bucket_ladder(
    prefill_len: int,
    buckets: Optional[Sequence[int]] = None,
    chunk: Optional[int] = None,
) -> Tuple[int, ...]:
    """The sorted ladder of prefill lengths.

    Default: powers of two from ``min(DEFAULT_MIN_BUCKET, prefill_len)``
    up to ``prefill_len``, always including ``prefill_len`` itself (and
    ``chunk`` when chunked prefill is on, so full chunks never pad):
    O(log prefill_len) entries.
    """
    if buckets is not None:
        vals = {int(b) for b in buckets}
        for b in vals:
            if not (1 <= b <= prefill_len):
                raise ValueError(
                    f"prefill bucket {b} outside [1, {prefill_len}]")
    else:
        vals = set()
        b = min(DEFAULT_MIN_BUCKET, prefill_len)
        while b < prefill_len:
            vals.add(b)
            b *= 2
    vals.add(prefill_len)
    if chunk is not None:
        vals.add(int(chunk))
    return tuple(sorted(vals))


def _filter_rows(logits: torch.Tensor, top_ks: torch.Tensor,
                 top_ps: torch.Tensor) -> torch.Tensor:
    """Per-row top-k (``top_ks`` 0 = off), then top-p (``top_ps`` >= 1 =
    off) over (S, V) temperature-scaled logits; filtered tokens get -inf.
    The JAX engine's semantics: top_k clamped to V, the top token always
    survives top-p."""
    v = logits.shape[-1]
    neg_inf = torch.full((), float("-inf"), device=logits.device)
    k_eff = torch.where(top_ks > 0, top_ks.clamp_max(v), v)
    desc = torch.sort(logits, dim=-1, descending=True).values
    kth = desc.gather(-1, (k_eff - 1)[:, None])
    logits = torch.where(logits < kth, neg_inf, logits)
    desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_ps[:, None]
    keep[:, 0] = True
    kth = torch.where(keep, desc, torch.full((), float("inf"),
                                             device=logits.device))
    kth = kth.min(dim=-1, keepdim=True).values
    nucleus = (top_ps < 1.0)[:, None]
    return torch.where(nucleus & (logits < kth), neg_inf, logits)


def _draw(probs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One token from a (V,) distribution: ``torch.multinomial``'s one-draw
    method (argmax of p / q, q ~ Exp(1)) without its host-side validity
    checks, which would synchronise every decode step with the host. The
    probabilities are a softmax with the top token always kept, so valid."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q)


def _select_next_slots(
    logits: torch.Tensor,        # (S, V) float32
    temps: torch.Tensor,         # (S,) float32
    top_ks: torch.Tensor,        # (S,) int64, 0 = off
    top_ps: torch.Tensor,        # (S,) float32, >= 1 = off
    do_sample: Sequence[bool],   # (S,) host flags
    generators: Sequence[Optional[torch.Generator]],
) -> torch.Tensor:
    """``generate._select_next`` with per-slot parameters: (S,) tokens on
    the device. Greedy rows: argmax of ``logits / temperature``. Sampled
    rows: the filters, then one draw from the row's own generator."""
    logits = logits / temps.clamp_min(1e-8)[:, None]
    nxt = torch.argmax(logits, dim=-1)
    sampled = [s for s, on in enumerate(do_sample) if on]
    if sampled:
        probs = torch.softmax(_filter_rows(logits, top_ks, top_ps), dim=-1)
        for s in sampled:
            nxt[s] = _draw(probs[s], generators[s])
    return nxt


class DecodeEngine:
    """Owns the slot pool, the bucket ladder, the optional prefix store and
    the prefill/decode/prefix-copy calls. Runs where ``device`` says (cuda
    unless the caller asks for the CPU), where the params must live."""

    def __init__(
        self,
        params,
        cfg: GPTConfig,
        n_slots: int,
        prefill_len: Optional[int] = None,
        prefill_buckets: Optional[Sequence[int]] = None,
        prefill_chunk: Optional[int] = None,
        prefix_cache_mb: float = 0.0,
        mesh=None,
        kv_dtype: Optional[str] = None,
        device: Optional[Device] = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving (mesh) is not ported yet "
                "(ROADMAP.md Queue 1 item 9)")
        self.device = resolve_device(device)
        if params["wte"].device.type != self.device.type:
            raise ValueError(f"params live on {params['wte'].device}, the "
                             f"engine was asked for {self.device}")
        self.cfg = cfg
        self.kv_quant = quant_lib.resolve_kv_dtype(kv_dtype)
        self.kv_dtype = "fp32" if self.kv_quant is None else self.kv_quant.name
        self.params = params
        self.prefill_len = int(prefill_len or cfg.block_size)
        if not (1 <= self.prefill_len <= cfg.block_size):
            raise ValueError(
                f"prefill_len {self.prefill_len} outside [1, "
                f"{cfg.block_size}]")
        if prefill_chunk is not None:
            prefill_chunk = int(prefill_chunk)
            if not (1 <= prefill_chunk <= self.prefill_len):
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} outside [1, "
                    f"{self.prefill_len}]")
        self.prefill_chunk = prefill_chunk
        self.buckets = bucket_ladder(
            self.prefill_len, prefill_buckets, prefill_chunk)
        self.pool = SlotKVPool(cfg, n_slots, device=self.device,
                               quant=self.kv_quant)
        self.prefix_store = (
            PrefixKVStore(int(prefix_cache_mb * (1 << 20)))
            if prefix_cache_mb > 0 else None)
        # distinct input shapes per family (the JAX engine's trace counts);
        # verify's rows are speculation's family (SpeculativeDecoder)
        self._shapes: Dict[str, Set[int]] = {f: set() for f in FAMILIES}
        self.verify_shapes: Set[int] = set()

    @property
    def n_slots(self) -> int:
        return self.pool.n_slots

    @property
    def chunk_size(self) -> int:
        """Max tokens one prefill call processes (= prefill_len when
        chunking is off)."""
        return self.prefill_chunk or self.prefill_len

    def bucket_for(self, n: int) -> int:
        """Smallest ladder bucket covering an n-token chunk."""
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(
            f"chunk length {n} exceeds largest bucket {self.buckets[-1]}")

    def _lane(self, slot: int, rows: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Views of one slot's (L, 1, rows, KV, hd) cache rows in the pool."""
        return {name: a[:, slot:slot + 1, :rows]
                for name, a in self.pool.cache.items()}

    @torch.no_grad()
    def prefill_chunk_call(
        self,
        slot: int,
        chunk_ids: Sequence[int],
        offset: int,
        temperature: float,
        top_k: Optional[int],
        top_p: Optional[float],
        do_sample: bool,
        generator: Optional[torch.Generator],
    ) -> Tuple[int, int]:
        """Prefill ``chunk_ids`` into ``slot`` at absolute ``offset``.
        Returns (token chosen at the chunk's last real position, only
        meaningful on a prompt's final chunk, and the padded bucket length
        actually forwarded). A sampled token draws from ``generator``."""
        n = len(chunk_ids)
        if n < 1:
            raise ValueError("empty prefill chunk")
        bucket = self.bucket_for(n)
        if offset + bucket > self.cfg.block_size:
            raise ValueError(
                f"chunk bucket {bucket} at offset {offset} overruns the "
                f"{self.cfg.block_size} cache window (the scheduler "
                "shifts the final chunk back to keep buckets in-window)")
        padded = np.zeros(bucket, np.int64)
        padded[:n] = np.asarray(chunk_ids, np.int64)
        tokens = torch.from_numpy(padded).to(self.device)[None]
        x = gen._forward_cached_hidden(self.params, tokens, self._lane(slot),
                                       offset, self.cfg)
        logits = gen._head_logits(self.params, x[:, n - 1:n], self.cfg)[:, 0]
        dev = self.device
        tok = _select_next_slots(
            logits, torch.tensor([temperature], dtype=torch.float32, device=dev),
            torch.tensor([top_k or 0], device=dev),
            torch.tensor([1.0 if top_p is None else top_p],
                         dtype=torch.float32, device=dev),
            [do_sample], [generator])
        self._shapes["prefill"].add(bucket)
        return int(tok[0]), bucket

    @torch.no_grad()
    def verify_call(
        self,
        slot: int,
        row_tokens: Sequence[int],
        offset: int,
        temperature: float,
        top_k: Optional[int],
        top_p: Optional[float],
    ) -> np.ndarray:
        """Forward ``row_tokens`` into ``slot`` at absolute positions
        ``offset ..`` and return the next token chosen at EVERY row by
        ``_select_next_slots`` with the slot's own greedy parameters (the
        plain decode step's selector, so ties break alike). All rows are
        written; the ones a caller rejects go stale."""
        rows = len(row_tokens)
        if offset + rows > self.cfg.block_size:
            raise ValueError(
                f"{rows} verify rows at offset {offset} overrun the "
                f"{self.cfg.block_size} cache window")
        dev = self.device
        tokens = torch.as_tensor(np.asarray(row_tokens, np.int64)).to(dev)[None]
        x = gen._forward_cached_hidden(self.params, tokens, self._lane(slot),
                                       offset, self.cfg)
        logits = gen._head_logits(self.params, x, self.cfg)[0]  # (rows, V)
        nxt = _select_next_slots(
            logits, torch.full((rows,), temperature, dtype=torch.float32, device=dev),
            torch.full((rows,), top_k or 0, device=dev),
            torch.full((rows,), 1.0 if top_p is None else top_p,
                       dtype=torch.float32, device=dev),
            [False] * rows, [None] * rows)
        self.verify_shapes.add(rows)
        return nxt.cpu().numpy()

    # -- shared-prefix KV reuse ----------------------------------------
    def quantized_prefix_len(self, prompt_len: int) -> int:
        """Rows worth storing for an n-token prompt: the largest bucket
        <= prompt_len - 1 (a hit must leave >= 1 tail token to prefill,
        because the first sampled token needs the last prompt position's
        logits). 0 = too short to store."""
        best = 0
        for b in self.buckets:
            if b <= prompt_len - 1:
                best = b
        return best

    @torch.no_grad()
    def try_load_prefix(self, slot: int, prompt_ids: Sequence[int]) -> int:
        """Install the longest stored prefix of ``prompt_ids`` into
        ``slot`` (a device row copy, no recompute). Returns the number of
        rows installed (0 = miss / store disabled)."""
        if self.prefix_store is None:
            return 0
        hit = self.prefix_store.lookup(tuple(prompt_ids))
        if hit is None:
            return 0
        rows, entry = hit
        for name, lane in self._lane(slot, rows).items():
            lane.copy_(entry[name])
        self._shapes["prefix_load"].add(rows)
        return rows

    @torch.no_grad()
    def save_prefix(self, slot: int, prompt_ids: Sequence[int]) -> int:
        """After a slot finished prefilling ``prompt_ids``, copy its
        bucket-sized leading rows into the prefix store. Returns rows
        stored (0 = skipped: disabled, too short, or already present)."""
        if self.prefix_store is None:
            return 0
        rows = self.quantized_prefix_len(len(prompt_ids))
        if rows == 0:
            return 0
        key = tuple(prompt_ids[:rows])
        if self.prefix_store.contains(key):
            return 0
        entry = {name: lane.clone() for name, lane in self._lane(slot, rows).items()}
        self._shapes["prefix_save"].add(rows)
        return rows if self.prefix_store.insert(key, entry) else 0

    # -- the migration seam --------------------------------------------
    def migratable_rows(self, prompt_len: int, frontier: int) -> int:
        """Rows worth moving from a slot whose cache holds ``frontier``
        valid leading rows of a ``prompt_len``-token prompt: the largest
        ladder bucket <= min(frontier, prompt_len - 1). Capped at the
        frontier (past it a mid-prefill slot holds garbage) and one short
        of the prompt (a hit on the peer must leave >= 1 tail token to
        prefill); ``quantized_prefix_len`` for a slot that finished its
        prefill. 0 = nothing to move."""
        cap = min(frontier, prompt_len - 1)
        best = 0
        for b in self.buckets:
            if b <= cap:
                best = b
        return best

    def _check_ladder(self, rows: int, what: str) -> None:
        if rows not in self.buckets:
            raise ValueError(
                f"{what} rows {rows} not on the bucket ladder {self.buckets}: "
                "migration moves the prefix copies' shapes only")

    def _place_entry(self, entry) -> Dict[str, torch.Tensor]:
        """An entry dict (tensors on any device, or numpy arrays) on this
        engine's device, leaf for leaf in the pool's dtypes: the bytes move
        unchanged, and a dtype or leaf-set mismatch raises rather than
        being cast."""
        if set(entry) != set(self.pool.cache):
            raise ValueError(f"entry leaves {sorted(entry)} != the pool's "
                             f"{sorted(self.pool.cache)}")
        out = {}
        for name, a in entry.items():
            t = torch.as_tensor(a)
            want = self.pool.cache[name].dtype
            if t.dtype != want:
                raise ValueError(f"entry leaf {name} is {t.dtype}, the pool "
                                 f"holds {want}: rows move as bytes, never recast")
            out[name] = t.to(self.device).contiguous()
        return out

    @torch.no_grad()
    def extract_slot_rows(self, slot: int, rows: int) -> Dict[str, torch.Tensor]:
        """Copies of ``slot``'s ``rows`` leading cache rows as an
        (L, 1, rows, KV, hd) entry dict (payloads and scale planes on a
        quantized pool): the extract half of migration, ``save_prefix``'s
        copy. ``rows`` must sit on the bucket ladder."""
        self._check_ladder(rows, "extract")
        self._shapes["prefix_save"].add(rows)
        return {name: lane.clone() for name, lane in self._lane(slot, rows).items()}

    @torch.no_grad()
    def install_slot_rows(self, slot: int, entry) -> int:
        """Copy an extracted entry dict into ``slot``'s leading rows: the
        install half of migration for an engine with no prefix store (the
        draft engine), ``try_load_prefix``'s copy. Returns the rows
        installed."""
        placed = self._place_entry(entry)
        rows = int(placed["k"].shape[2])
        self._check_ladder(rows, "install")
        for name, lane in self._lane(slot, rows).items():
            lane.copy_(placed[name])
        self._shapes["prefix_load"].add(rows)
        return rows

    def adopt_prefix_entry(self, key: Sequence[int], entry) -> bool:
        """Put a migrated entry dict into this engine's prefix store under
        the token tuple ``key``. Returns False when the store is off, holds
        the key already, or cannot fit the entry."""
        if self.prefix_store is None:
            return False
        key = tuple(int(t) for t in key)
        if self.prefix_store.contains(key):
            return False
        return self.prefix_store.insert(key, self._place_entry(entry))

    # -- warmup --------------------------------------------------------
    def warmup(self) -> None:
        """Run the whole shape family once before serving: one prefill per
        ladder bucket, the decode step and (with the prefix store) the copy
        calls per storable bucket, so no request pays a first call's
        set-up (cuBLAS handles, allocator growth). Only while the pool has
        no tenants: it scribbles over slot 0's rows, which the stale-row
        invariant makes harmless."""
        if self.pool.used_count:
            raise RuntimeError("warmup requires an empty pool")
        for b in self.buckets:
            self.prefill_chunk_call(0, [0] * b, 0, 1.0, None, None, False, None)
        s = self.n_slots
        self.decode_step(
            np.zeros(s, np.int64), np.full(s, self.cfg.block_size - 1),
            np.ones(s, np.float32), np.zeros(s, np.int64),
            np.ones(s, np.float32), np.zeros(s, bool), [None] * s)
        if self.prefix_store is not None:
            for b in (b for b in self.buckets if b <= self.prefill_len - 1):
                for lane in self._lane(0, b).values():
                    lane.copy_(lane.clone())  # an extract, then an install
                self._shapes["prefix_save"].add(b)
                self._shapes["prefix_load"].add(b)

    @torch.no_grad()
    def decode_on_device(
        self,
        tokens: torch.Tensor,      # (S,) int64 on the device
        positions: torch.Tensor,   # (S,) int64 on the device
        temps: torch.Tensor,
        top_ks: torch.Tensor,
        top_ps: torch.Tensor,
        do_sample: Sequence[bool],
        generators: Sequence[Optional[torch.Generator]],
    ) -> torch.Tensor:
        """One token for every slot, from and to device tensors: nothing in
        it waits for the device, so a caller can queue steps back to back."""
        safe_pos = positions.clamp(0, self.cfg.block_size - 1)
        logits = gen._forward_cached(self.params, tokens[:, None],
                                     self.pool.cache, safe_pos, self.cfg)
        self._shapes["decode"].add(int(tokens.shape[0]))
        return _select_next_slots(logits, temps, top_ks, top_ps, do_sample,
                                  generators)

    def decode_step(
        self,
        tokens: np.ndarray,
        positions: np.ndarray,
        temps: np.ndarray,
        top_ks: np.ndarray,
        top_ps: np.ndarray,
        do_sample: np.ndarray,
        generators: Sequence[Optional[torch.Generator]],
    ) -> np.ndarray:
        """Advance every slot one token; the caller masks inactive lanes."""
        put = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt).to(  # noqa: E731
            self.device)
        nxt = self.decode_on_device(
            put(tokens, torch.int64), put(positions, torch.int64),
            put(temps, torch.float32), put(top_ks, torch.int64),
            put(top_ps, torch.float32), [bool(d) for d in do_sample],
            generators)
        return nxt.cpu().numpy()

    def compile_counts(self) -> Dict[str, int]:
        """Distinct input shapes per call family. After warmup: decode 1,
        prefill <= len(self.buckets), prefix copies <= len(self.buckets)
        each, bounded for the server's lifetime however many requests it
        serves."""
        return {f: len(self._shapes[f]) for f in FAMILIES}

    def kv_bytes_per_row(self) -> int:
        """Pool bytes of one cache row (one position of one slot, every
        layer, K and V with their scale planes)."""
        total = sum(int(a.nbytes) for a in self.pool.cache.values())
        return total // (self.n_slots * self.cfg.block_size)

    def register_attrib(self, ledger, family_prefix: str = "") -> None:
        """Register every call family of this engine with a
        ``telemetry.attribution.ProgramLedger``, one row per shape, with the
        analytic operations and bytes of one call
        (``attribution.forward_cost``): a prefill per ladder bucket, the
        decode step and, with the prefix store, the row copies per storable
        bucket. Family names are ``compile_counts()``'s keys (prefixed for
        a draft engine); nothing runs, so the shape counts are unchanged."""
        from mingpt_distributed_tpu_torch.telemetry import attribution

        cfg, row = self.cfg, self.kv_bytes_per_row()
        weights = attribution.tree_bytes(self.params)
        for b in self.buckets:
            flops, nbytes = attribution.forward_cost(
                cfg, 1, b, cfg.block_size, weights, row)
            ledger.observe_compile(family_prefix + "prefill", 0.0, flops, nbytes,
                                   variant=f"b{b}")
        flops, nbytes = attribution.forward_cost(
            cfg, self.n_slots, 1, cfg.block_size, weights, row, per_row=True)
        ledger.observe_compile(family_prefix + "decode", 0.0, flops, nbytes)
        if self.prefix_store is not None:
            for b in (b for b in self.buckets if b <= self.prefill_len - 1):
                for fam in ("prefix_save", "prefix_load"):
                    ledger.observe_compile(family_prefix + fam, 0.0, 0.0,
                                           float(2 * b * row), variant=f"b{b}")

    def audit_contracts(self, *args, **kwargs):
        raise NotImplementedError(
            "the static audit contracts are not ported yet (ROADMAP.md "
            "Queue 1 item 16b)")
