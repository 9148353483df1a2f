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
   The process fleet's wire (``procfleet/worker.py``) carries them between
   processes, each leaf as its raw bytes under its dtype's name.

6. **tensor parallelism** (``mesh``, a ``parallel.mesh.Mesh.serving``
   mesh of tp = N ranks): one engine per rank, kept in lockstep by the
   command channel of ``serving/lockstep.py``. The group's first rank, the
   driver, is the engine the scheduler holds: it alone samples, owns the
   prefix store's keys and keeps the metrics; every other rank runs
   ``follow()``. The driver's engine is built from the whole parameters and
   ships each follower its slices by ``PARAM_RULES`` (``build``: a new
   target engine replaces whatever the followers held, so a respawned
   replica's followers never keep a stale pool). Each rank's pool, and
   each of its prefix entries, holds its ``kv_heads/tp`` heads
   (``kv_shard_count``): a prefix save or load is a rank-local row copy,
   and no collective touches K or V. The forward sums its row-parallel
   partials over tp (``models/generate.py``); the read-out rows' partial
   logits are summed to the driver. Every call that touches the pool, the
   prefix store or the group goes through one dispatch point (``_call``),
   which broadcasts the command first. Migration's seam moves whole-head
   entries: ``extract_slot_rows`` gathers the followers' heads to the
   driver, ``install_slot_rows`` and ``adopt_prefix_entry`` send each its
   heads. ``compile_counts()`` equals the tp = 1 engine's, family by
   family. When the Megatron split does not apply (``Mesh.tp_manual``:
   heads, KV heads or the FFN width not divisible by tp; the pool's
   downgrade is counted once as ``kv_cache``) every rank holds the whole
   model and pool and computes alike, still in lockstep. A
   mixture-of-experts model runs the split too: its router replicated, each
   rank holding F/tp of every expert, the routed outputs summed over tp in
   float32; the decode step still routes each slot on its own.

Attribution (``register_attrib``) registers each family's shapes with
analytic costs; ``audit_contracts`` gives each family's contract for the
program audit (``analysis/program_audit.py``), family for family as the
JAX engine's.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.models import convert
from mingpt_distributed_tpu_torch.models import generate as gen
from mingpt_distributed_tpu_torch.parallel import mesh as mesh_lib
from mingpt_distributed_tpu_torch.serving import quant as quant_lib
from mingpt_distributed_tpu_torch.serving.kv_pool import PrefixKVStore, SlotKVPool
from mingpt_distributed_tpu_torch.serving.lockstep import LockstepError, channel_for, release
from mingpt_distributed_tpu_torch.utils.device import Device, resolve_device

#: smallest default bucket: prompts below this pay one 64-token forward,
#: which already beats a block_size² prefill by >100x at block_size 1024
DEFAULT_MIN_BUCKET = 64

FAMILIES = ("prefill", "decode", "prefix_load", "prefix_save")
#: device<->host copies of one public call per family on a card (the
#: program audit's ``host_transfers``): a prefill uploads its chunk and
#: the sampler's temperature, top-k and top-p and reads its token; a
#: decode step uploads its tokens, positions and the three sampler rows
#: and reads the tokens (under tp the driver also reads the step's tokens
#: for the followers' command); the prefix copies stay on the device
HOST_COPIES = {"prefill": 5, "decode": 6, "prefix_save": 0, "prefix_load": 0}


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


def _tp_specs(mesh, flat: Dict[str, torch.Tensor], manual: bool) -> Dict[str, tuple]:
    """Every leaf's PARAM_RULES spec on the serving mesh (downgrades
    counted), or all-replicated when the Megatron split does not apply."""
    if not manual:
        return {p: (None,) * t.dim() for p, t in flat.items()}
    return {p: mesh_lib.shard_by_rule(mesh.shape, tuple(t.shape),
                                      mesh_lib.PARAM_RULES[p.rsplit("/", 1)[-1]],
                                      name=p.rsplit("/", 1)[-1])
            for p, t in flat.items()}


def _tp_slice(full: torch.Tensor, spec: tuple, n: int, coord: int) -> torch.Tensor:
    """The tp coordinate ``coord``'s slice of a whole leaf by its spec."""
    t = full
    for dim, axis in enumerate(spec):
        if axis == "tp":
            t = t.chunk(n, dim)[coord]
    return t.contiguous()


def _tp_shape(shape: tuple, spec: tuple, n: int) -> tuple:
    return tuple(d // n if axis == "tp" else d for d, axis in zip(shape, spec))


def _launch_counts() -> Dict[str, int]:
    """The flash kernels' launch counts in this process."""
    from mingpt_distributed_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.flash_fwd.launches,
            "flash_lse_fwd": fa.flash_lse_fwd.launches,
            "flash_bwd_prep": fa.flash_bwd_prep.launches,
            "flash_dq": fa.flash_bwd.dq_launches,
            "flash_dkv": fa.flash_bwd.dkv_launches,
            "flash_bwd_fused": fa.flash_bwd.fused_launches}


class DecodeEngine:
    """Owns the slot pool, the bucket ladder, the optional prefix store and
    the prefill/decode/prefix-copy calls. Runs where ``device`` says (cuda
    unless the caller asks for the CPU), where the params must live. With a
    serving ``mesh`` of tp > 1 this is the driver's engine of a lockstep
    group (module docstring, item 6): build it on the group's first rank
    while the others run ``DecodeEngine.follow``."""

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
        *,
        _role: str = "target",
        _local=None,
    ):
        self.device = resolve_device(device)
        if params["wte"].device.type != self.device.type:
            raise ValueError(f"params live on {params['wte'].device}, the "
                             f"engine was asked for {self.device}")
        self.cfg = cfg
        self.kv_quant = quant_lib.resolve_kv_dtype(kv_dtype)
        self.kv_dtype = "fp32" if self.kv_quant is None else self.kv_quant.name
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
        if mesh is not None and not hasattr(mesh, "cmd_group"):
            raise ValueError("serving takes a parallel.mesh.Mesh.serving mesh")
        self.mesh = mesh if mesh is not None and mesh.tp > 1 else None
        self.channel = None
        self.tp: Optional[gen.TPShard] = None
        self.kv_shard_count = 1
        kv_heads = cfg.kv_heads
        # the whole model's bytes (this rank holds its slices under tp)
        self.whole_param_bytes = sum(
            int(t.numel()) * t.element_size() for t in convert.flatten(params).values())
        if self.mesh is not None:
            kv_heads, params = self._join_group(
                params, cfg, n_slots, prefix_cache_mb, _role, _local)
        self.params = params
        before = self._allocated()
        self.pool = SlotKVPool(cfg, n_slots, device=self.device,
                               quant=self.kv_quant, kv_heads=kv_heads)
        # the pool's bytes as the allocator saw them arrive (None off a card)
        after = self._allocated()
        self.pool_alloc_bytes = None if before is None else after - before
        follower = self.channel is not None and not self.channel.is_driver
        self.prefix_store = (
            PrefixKVStore(int(prefix_cache_mb * (1 << 20)),
                          shard_count=self.kv_shard_count,
                          on_evict=self._evicted_key)
            if prefix_cache_mb > 0 and not follower else None)
        # tp: the driver's entry id per stored key and the ids its last
        # insert evicted; a follower's entries by id
        self._prefix_ids: Dict[Tuple[int, ...], int] = {}
        self._evicted: List[int] = []
        self._next_entry = 0
        self._held: Dict[int, Dict[str, torch.Tensor]] = {}
        if self.channel is not None and self.channel.is_driver:
            self.pool.mirror = self._mirror_slot
        # distinct input shapes per family (the JAX engine's trace counts);
        # verify's rows are speculation's family (SpeculativeDecoder)
        self._shapes: Dict[str, Set[int]] = {f: set() for f in FAMILIES}
        self.verify_shapes: Set[int] = set()

    # -- the lockstep group (tp > 1) -------------------------------------
    def _join_group(self, params, cfg, n_slots, prefix_cache_mb, role, local):
        """Take this rank's place in the mesh's lockstep group: on the
        driver, ship every follower its slices of ``params`` with the build
        command; on a follower, ``local`` holds what that command carried.
        Returns (this rank's KV heads, this rank's params)."""
        mesh = self.mesh
        self.channel = channel_for(mesh)
        cache_shape = (cfg.n_layer, n_slots, cfg.block_size, cfg.kv_heads,
                       cfg.head_dim)
        manual = (mesh.tp_manual(cfg) and mesh_lib.shard_by_rule(
            mesh.shape, cache_shape, (None, None, None, "tp"),
            name="kv_cache")[3] == "tp")
        if local is None:
            if not self.channel.is_driver:
                raise ValueError("a follower's engines are built by its "
                                 "driver's commands (DecodeEngine.follow)")
            flat = convert.flatten(params)
            specs = _tp_specs(mesh, flat, manual)
            self.eid = self.channel.next_eid
            self.channel.next_eid += 1
            kwargs = dict(n_slots=n_slots, prefill_len=self.prefill_len,
                          prefill_buckets=self.buckets,
                          prefill_chunk=self.prefill_chunk,
                          prefix_cache_mb=prefix_cache_mb, kv_dtype=self.kv_dtype)
            leaves = [(p, tuple(t.shape), t.dtype) for p, t in flat.items()]
            blob = pickle.dumps(dict(cfg=cfg, kwargs=kwargs, leaves=leaves,
                                     specs=specs, role=role))
            self.channel.send("build", self.eid, (), blob)
            try:
                for j, dst in enumerate(self.channel.followers, start=1):
                    self.channel.send_tensors(
                        [_tp_slice(flat[p], specs[p], mesh.tp, j) for p, _, _ in leaves],
                        dst)
            except Exception as e:
                self.channel.fail(e)
                raise LockstepError(f"tp group {mesh.ranks}: the build's "
                                    f"parameters did not reach the followers: {e}") from e
            params = convert.unflatten({p: _tp_slice(t, specs[p], mesh.tp, 0)
                                        for p, t in flat.items()})
        else:
            params, specs, self.eid = local
        if not manual:
            return cfg.kv_heads, params
        self.kv_shard_count = mesh.tp
        embd = specs["wte"][-1] == "tp"
        self.tp = gen.TPShard(mesh.tp_group, mesh.tp, mesh.tp_rank, embd_split=embd,
                              head_split=embd if cfg.tie_weights
                              else specs["head"][0] == "tp")
        return cfg.kv_heads // mesh.tp, params

    def _allocated(self) -> Optional[int]:
        if self.device.type != "cuda":
            return None
        torch.cuda.synchronize(self.device)
        return int(torch.cuda.memory_allocated(self.device))

    def _call(self, op: str, ints: Sequence[int] = (), *extra):
        """The one dispatch point of every engine call that touches the
        group: broadcast ``op`` and its integer arguments to the followers,
        then run ``_op_<op>`` here (with ``extra``, the driver's own
        arguments). A failure after the broadcast leaves the group out of
        step, so it breaks the channel and raises LockstepError."""
        ints = np.asarray(list(ints), np.int64)
        ch = self.channel
        ch.send(op, self.eid, ints)
        ch.active += 1
        try:
            return getattr(self, "_op_" + op)(ints, *extra)
        except Exception as e:
            ch.fail(e)
            if isinstance(e, LockstepError):
                raise
            raise LockstepError(f"tp group {self.mesh.ranks}: {op} failed on "
                                f"the driver: {e!r}") from e
        finally:
            ch.active -= 1

    def _check_dispatch(self) -> None:
        """A call that joins the group's collectives must run inside
        ``_call`` (or a follower's loop): raise at once for one that a
        driver forgot to mirror, instead of waiting on peers that never
        join."""
        if self.channel is not None and not self.channel.active:
            raise LockstepError(
                f"rank {self.mesh.rank}: an engine call that needs the tp "
                f"group ran outside the lockstep dispatch (not mirrored)")

    def _mirror_slot(self, what: str, slot: int) -> None:
        self.channel.send("slot", self.eid, (0 if what == "allocate" else 1, slot))

    def _op_slot(self, ints) -> None:
        what, slot = int(ints[0]), int(ints[1])
        if what == 0:
            self.pool.claim(slot)
        else:
            self.pool.free(slot)

    def _evicted_key(self, key) -> None:
        gone = self._prefix_ids.pop(key, None)
        if gone is not None:
            self._evicted.append(gone)

    def _store(self, key, entry) -> Optional[List[int]]:
        """Insert a (this rank's heads) entry into the prefix store under
        ``key``: the entry id and the ids the insert evicted, or None when
        the store refused it."""
        self._evicted = []
        if not self.prefix_store.insert(key, entry):
            return None
        eid = self._next_entry
        self._next_entry += 1
        self._prefix_ids[key] = eid
        return [eid] + self._evicted

    def _hold(self, ints, entry) -> None:
        """A follower keeps ``entry`` under id ints[0] and drops the ids
        after it (the driver's store evicted them)."""
        for gone in ints[1:]:
            self._held.pop(int(gone), None)
        self._held[int(ints[0])] = entry

    def _heads(self, t: torch.Tensor, j: int) -> torch.Tensor:
        """Rank j's heads of a whole-head entry leaf."""
        return t.chunk(self.kv_shard_count, 3)[j].contiguous()

    def _lane_likes(self, rows: int):
        return [(tuple(a[:, :1, :rows].shape), a.dtype)
                for _, a in sorted(self.pool.cache.items())]

    def shutdown(self) -> None:
        """Release the followers from ``follow`` (the driver of a tp
        engine; a no-op otherwise and on a broken group)."""
        if self.channel is not None:
            release(self.mesh)

    @staticmethod
    def follow(mesh, device: Optional[Device] = None) -> int:
        """A follower's loop (every rank of ``mesh`` but the first): run the
        driver's commands, building the engines it builds, until it shuts
        the group down. Returns the number of commands run. Raises on any
        failure (LockstepError for a command out of step); the caller's
        process should then exit, which fails the driver's next
        collective."""
        dev = resolve_device(device)
        ch = channel_for(mesh)
        if ch.is_driver:
            raise ValueError("the group's first rank drives; follow() runs "
                             "on the others")
        n = 0
        while True:
            op, eid, ints, blob = ch.recv()
            n += 1
            if op == "shutdown":
                return n
            if op == "build":
                DecodeEngine._build_follower(mesh, ch, dev, eid, blob)
                continue
            engine = ch.engines.get(eid)
            if engine is None:
                raise LockstepError(f"rank {mesh.rank}: command {op} for engine "
                                    f"{eid}, which this follower does not hold")
            ch.active += 1
            try:
                getattr(engine, "_op_" + op)(ints)
            finally:
                ch.active -= 1

    @staticmethod
    def _build_follower(mesh, ch, dev, eid, blob) -> None:
        d = pickle.loads(blob)
        specs = d["specs"]
        likes = [(_tp_shape(shape, specs[p], mesh.tp), dtype)
                 for p, shape, dtype in d["leaves"]]
        got = ch.recv_tensors(likes, mesh.driver)
        local = convert.unflatten({p: t.to(dev) for (p, _, _), t in zip(d["leaves"], got)})
        if d["role"] == "target":  # a new server: its predecessor's engines go
            ch.engines.clear()
        ch.engines[eid] = DecodeEngine(local, d["cfg"], mesh=mesh, device=dev,
                                       _role=d["role"], _local=(local, specs, eid),
                                       **d["kwargs"])

    def local_report(self) -> Dict[str, Any]:
        """This rank's view of the engine: shapes, the pool's heads and
        bytes (and the allocator's delta when it was made), the heads of
        each held prefix entry and the flash kernels' launch counts."""
        entries = ([e for _, e in self.prefix_store.entries()]
                   if self.prefix_store is not None else list(self._held.values()))
        return dict(rank=0 if self.mesh is None else self.mesh.rank,
                    compile_counts=self.compile_counts(),
                    verify_shapes=sorted(self.verify_shapes),
                    kv_shard_count=self.kv_shard_count,
                    kv_heads=int(self.pool.cache["k"].shape[3]),
                    pool_bytes=self.pool.nbytes,
                    pool_alloc_bytes=self.pool_alloc_bytes,
                    free_slots=self.pool.free_count,
                    prefix_heads=[int(e["k"].shape[3]) for e in entries],
                    launches=_launch_counts())

    def follower_reports(self) -> List[Dict[str, Any]]:
        """Every follower's ``local_report()``, in rank order (the driver
        of a tp engine; [] otherwise)."""
        if self.channel is None:
            return []
        return self._call("report")

    def _op_report(self, ints):
        self._check_dispatch()
        ch = self.channel
        if ch.is_driver:
            return [ch.recv_object(src) for src in ch.followers]
        ch.send_object(self.local_report(), self.mesh.driver)
        return None

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
        ints = [slot, offset, n, bucket, *(int(t) for t in chunk_ids)]
        logits = (self._op_prefill(np.asarray(ints, np.int64)) if self.channel is None
                  else self._call("prefill", ints))[:, 0]
        dev = self.device
        tok = _select_next_slots(
            logits, torch.tensor([temperature], dtype=torch.float32, device=dev),
            torch.tensor([top_k or 0], device=dev),
            torch.tensor([1.0 if top_p is None else top_p],
                         dtype=torch.float32, device=dev),
            [do_sample], [generator])
        return int(tok[0]), bucket

    def _op_prefill(self, ints):
        """The prefill forward: (1, 1, V) logits at the chunk's last real
        row (None on a follower)."""
        self._check_dispatch()
        slot, offset, n, bucket = (int(v) for v in ints[:4])
        padded = np.zeros(bucket, np.int64)
        padded[:n] = ints[4:4 + n]
        tokens = torch.from_numpy(padded).to(self.device)[None]
        x = gen._forward_cached_hidden(self.params, tokens, self._lane(slot),
                                       offset, self.cfg, self.tp)
        self._shapes["prefill"].add(bucket)
        return gen.tp_head_logits(self.params, x[:, n - 1:n], self.cfg, self.tp)

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
        ints = [slot, offset, *(int(t) for t in row_tokens)]
        logits = (self._op_verify(np.asarray(ints, np.int64)) if self.channel is None
                  else self._call("verify", ints))
        nxt = _select_next_slots(
            logits, torch.full((rows,), temperature, dtype=torch.float32, device=dev),
            torch.full((rows,), top_k or 0, device=dev),
            torch.full((rows,), 1.0 if top_p is None else top_p,
                       dtype=torch.float32, device=dev),
            [False] * rows, [None] * rows)
        return nxt.cpu().numpy()

    def _op_verify(self, ints):
        """The verify forward: (rows, V) logits at every row (None on a
        follower)."""
        self._check_dispatch()
        slot, offset = int(ints[0]), int(ints[1])
        tokens = torch.from_numpy(np.asarray(ints[2:], np.int64)).to(self.device)[None]
        x = gen._forward_cached_hidden(self.params, tokens, self._lane(slot),
                                       offset, self.cfg, self.tp)
        self.verify_shapes.add(int(tokens.shape[1]))
        logits = gen.tp_head_logits(self.params, x, self.cfg, self.tp)
        return None if logits is None else logits[0]

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
        if self.channel is not None:  # a rank-local copy on every rank
            self.channel.send("prefix_load", self.eid,
                              (slot, rows, self._prefix_ids[tuple(prompt_ids[:rows])]))
        self._copy_in(slot, rows, entry)
        return rows

    def _copy_in(self, slot: int, rows: int, entry) -> None:
        for name, lane in self._lane(slot, rows).items():
            lane.copy_(entry[name])
        self._shapes["prefix_load"].add(rows)

    def _op_prefix_load(self, ints) -> None:
        slot, rows, eid = (int(v) for v in ints)
        if eid not in self._held:
            raise LockstepError(f"rank {self.mesh.rank}: prefix entry {eid} "
                                "is not held here")
        self._copy_in(slot, rows, self._held[eid])

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
        entry = self._copy_out(slot, rows)
        if self.channel is None:
            return rows if self.prefix_store.insert(key, entry) else 0
        # no collective: the driver stores first, then its followers copy
        # the same rows under the entry's id (and drop what it evicted)
        stored = self._store(key, entry)
        if stored is None:
            return 0
        self.channel.send("prefix_save", self.eid, (slot, rows, *stored))
        return rows

    def _copy_out(self, slot: int, rows: int) -> Dict[str, torch.Tensor]:
        self._shapes["prefix_save"].add(rows)
        return {name: lane.clone() for name, lane in self._lane(slot, rows).items()}

    def _op_prefix_save(self, ints) -> None:
        self._hold(ints[2:], self._copy_out(int(ints[0]), int(ints[1])))

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
        if self.channel is None:
            return self._copy_out(slot, rows)
        return self._call("extract", (slot, rows))

    def _op_extract(self, ints):
        """Every rank copies its heads of the rows; the followers' heads
        go to the driver, which returns the whole-head entry."""
        self._check_dispatch()
        mine = self._copy_out(int(ints[0]), int(ints[1]))
        if self.kv_shard_count == 1:
            return mine
        ch, names = self.channel, sorted(mine)
        if not ch.is_driver:
            ch.send_tensors([mine[n] for n in names], self.mesh.driver)
            return None
        likes = [(tuple(mine[n].shape), mine[n].dtype) for n in names]
        parts = [[mine[n] for n in names]] + [
            [t.to(self.device) for t in ch.recv_tensors(likes, src)]
            for src in ch.followers]
        return {n: torch.cat([p[i] for p in parts], dim=3) for i, n in enumerate(names)}

    @torch.no_grad()
    def install_slot_rows(self, slot: int, entry) -> int:
        """Copy an extracted entry dict into ``slot``'s leading rows: the
        install half of migration for an engine with no prefix store (the
        draft engine), ``try_load_prefix``'s copy. Returns the rows
        installed."""
        placed = self._place_entry(entry)
        rows = int(placed["k"].shape[2])
        self._check_ladder(rows, "install")
        if self.channel is None:
            self._copy_in(slot, rows, placed)
        else:
            self._call("install", (slot, rows), placed)
        return rows

    def _scatter(self, rows: int, whole=None) -> Dict[str, torch.Tensor]:
        """This rank's heads of a whole-head entry of ``rows`` rows: the
        driver (``whole``) sends each follower its heads; a follower
        receives them."""
        ch, names = self.channel, sorted(self.pool.cache)
        if whole is None:
            got = ch.recv_tensors(self._lane_likes(rows), self.mesh.driver)
            return {n: t.to(self.device) for n, t in zip(names, got)}
        for j, dst in enumerate(ch.followers, start=1):
            ch.send_tensors([self._heads(whole[n], j) for n in names], dst)
        return {n: self._heads(whole[n], 0) for n in names}

    def _op_install(self, ints, whole=None) -> None:
        self._check_dispatch()
        slot, rows = int(ints[0]), int(ints[1])
        self._copy_in(slot, rows, self._scatter(rows, whole))

    def adopt_prefix_entry(self, key: Sequence[int], entry) -> bool:
        """Put a migrated entry dict into this engine's prefix store under
        the token tuple ``key``. Returns False when the store is off, holds
        the key already, or cannot fit the entry."""
        if self.prefix_store is None:
            return False
        key = tuple(int(t) for t in key)
        if self.prefix_store.contains(key):
            return False
        placed = self._place_entry(entry)
        if self.channel is None:
            return self.prefix_store.insert(key, placed)
        stored = self._store(key, {n: self._heads(t, 0) for n, t in placed.items()})
        if stored is None:
            return False
        self._call("adopt", (int(placed["k"].shape[2]), *stored), placed)
        return True

    def _op_adopt(self, ints, whole=None) -> None:
        """The driver stored its heads already; each follower receives and
        holds its own."""
        self._check_dispatch()
        heads = self._scatter(int(ints[0]), whole)
        if whole is None:
            self._hold(ints[1:], heads)

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
            storable = [b for b in self.buckets if b <= self.prefill_len - 1]
            if self.channel is not None:
                self.channel.send("warm", self.eid, storable)
            self._op_warm(storable)

    def _op_warm(self, ints) -> None:
        """The prefix copies per storable bucket: an extract, then an
        install."""
        for b in (int(v) for v in ints):
            self._copy_in(0, b, self._copy_out(0, b))

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
        if self.channel is None:
            logits = self._decode_logits(tokens, positions)
        else:  # the followers need the step's tokens: one read to the host
            logits = self._call("decode", torch.cat([tokens, positions]).tolist())
        return _select_next_slots(logits, temps, top_ks, top_ps, do_sample,
                                  generators)

    def _decode_logits(self, tokens: torch.Tensor, positions: torch.Tensor):
        """The decode forward: (S, V) logits (None on a follower)."""
        safe_pos = positions.clamp(0, self.cfg.block_size - 1)
        x = gen._forward_cached_hidden(self.params, tokens[:, None],
                                       self.pool.cache, safe_pos, self.cfg, self.tp)
        self._shapes["decode"].add(int(tokens.shape[0]))
        logits = gen.tp_head_logits(self.params, x[:, -1:], self.cfg, self.tp)
        return None if logits is None else logits[:, 0]

    def _op_decode(self, ints):
        self._check_dispatch()
        s = len(ints) // 2
        put = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(self.device)  # noqa: E731
        return self._decode_logits(put(ints[:s]), put(ints[s:]))

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

    def audit_contracts(self, family_prefix: str = "") -> Dict[str, dict]:
        """Per-family contracts for ``analysis/program_audit.py``, keyed
        like ``register_attrib``'s families (plain dicts: serving never
        imports the analysis layer):

        * ``allowed_collectives``: at tp > 1 the forwarding families sum
          partial products over tp (``all-reduce``; the JAX programs also
          gather small activations, ``all-gather``); the prefix copies are
          rank-local row moves and allow none, at any tp.
        * ``donated``: the pool leaves the call writes in place, every one
          (k and v, and a quantized pool's scale planes); 0 for
          ``prefix_save``, which must leave the pool as it was.
        * ``kv_local_heads``: each K/V leaf's heads on this rank, its tp
          share of ``kv_heads``.
        * ``pool_leaf_elems`` / ``pool_leaf_bytes``: one K/V pool buffer; a
          collective at least this large, or an allocator growth of a
          leaf's bytes, is moving the pool.
        * ``host_transfers``: the public call's device<->host copies
          (``HOST_COPIES``)."""
        leaf = self.pool.cache["k"]
        tp = 1 if self.mesh is None else self.mesh.tp
        model = {
            "allowed_collectives": ("all-gather", "all-reduce") if tp > 1 else (),
            "donated": len(self.pool.cache),
            "kv_local_heads": self.cfg.kv_heads // self.kv_shard_count,
            "pool_leaf_elems": int(leaf.numel()),
            "pool_leaf_bytes": int(leaf.numel() * leaf.element_size()),
        }
        copies = dict(HOST_COPIES, decode=HOST_COPIES["decode"] + (tp > 1))
        out = {family_prefix + f: dict(model, host_transfers=copies[f])
               for f in ("prefill", "decode")}
        out[family_prefix + "prefix_save"] = dict(
            model, allowed_collectives=(), donated=0, host_transfers=0)
        out[family_prefix + "prefix_load"] = dict(
            model, allowed_collectives=(), host_transfers=0)
        return out
