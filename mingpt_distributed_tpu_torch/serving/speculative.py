"""Speculative decoding: a draft model proposes, the target verifies.

Counterpart of ``mingpt_distributed_tpu/serving/speculative.py``. The plain
decode round emits one token per step per slot. Speculation emits up to
``k + 1`` per round without changing a single emitted token:

* a **DraftEngine**, a ``DecodeEngine`` over the draft model's params with
  its own ``SlotKVPool`` whose slot indices mirror the target's 1:1,
  proposes ``k`` tokens autoregressively (k draft decode steps over every
  speculating lane at once, queued back to back on the device and read
  once), and
* the target scores all ``k + 1`` positions of a slot in one forward
  (``DecodeEngine.verify_call``: the prefill-at-offset body with a fixed
  ``k + 1``-row chunk and logits read at every row), one call per
  speculating slot, one input shape for the server's lifetime
  (``compile_counts()``).

Acceptance is greedy longest-matching-prefix: feeding ``[cur, d_1..d_k]``
at positions ``pos..pos+k`` gives the target's own next-token choice
``g_j`` at every row; proposals are accepted while ``d_{j+1} == g_j``, and
``g_{n_acc-1}`` rides along as the bonus token, so every emitted token is
the target's own greedy choice (token-exact with the plain path) and a
verify emits at least one token even when the draft is useless.

**Rollback is free.** Rejected rows on both engines stay where they are:
the stale-row invariant (a row is visible only once a query position
reaches it, and every writer fills a row before its first reader) means
the next verify or decode at ``pos + n_acc`` rewrites them before anything
attends that far. The only extra write is the draft **backfill** on full
acceptance: one more draft decode step feeding ``d_k`` at ``pos + k`` so
the draft row the next propose round attends is real.

**Draft-row migration.** A migrated request's draft rows travel with it:
``extract_draft_rows`` copies a primed draft lane (``migratable_draft_rows``:
the largest ladder bucket <= the prompt, no ``- 1``, since the draft never
regenerates prompt logits), ``adopt_draft_rows`` parks them on the peer
(``pending_draft``, a FIFO of at most 32 entries) and the re-routed
request's ``prime`` installs them and prefills only the uncovered tail
(``"adopted"``). The process fleet carries them between workers as
``draft_rows`` frames (``procfleet/worker.py``).

**Tensor parallelism.** The draft engine takes the target's mesh (the JAX
package's ``speculative.py:119``): its pool is head-sharded and mirrored to
the followers like the target's, each draft step is one lockstep command
whose tokens the driver chose, and rejected rows go stale on every rank
alike, so rollback stays free under sharding.

Not ported yet: the audit contracts (``audit_contracts``), item 16b.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mingpt_distributed_tpu_torch.config import GPTConfig
from mingpt_distributed_tpu_torch.serving.engine import DecodeEngine

__all__ = ["DraftEngine", "SpeculativeDecoder"]


def _refuse(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1 item {item})")


class DraftEngine:
    """The proposal model: a ``DecodeEngine`` over the draft params whose
    slot pool mirrors the target's slot indices 1:1.

    Mirroring works because both pools allocate the lowest free index and
    this wrapper binds and frees in lockstep with the target; ``bind``
    raises when the indices do not coincide, so a drifted mirror fails
    loudly instead of attending the wrong lane. Draft state only shapes
    proposal quality, never emitted tokens, so the draft prefill is one
    un-chunked call with no prefix store."""

    def __init__(self, params, cfg: GPTConfig, target: DecodeEngine):
        if cfg.vocab_size != target.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {cfg.vocab_size} != target {target.cfg.vocab_size}")
        if cfg.block_size < target.cfg.block_size:
            raise ValueError(
                f"draft block_size {cfg.block_size} < target "
                f"{target.cfg.block_size}: draft must cover the window")
        self.engine = DecodeEngine(
            params, cfg, target.n_slots, prefill_len=target.prefill_len,
            prefill_buckets=target.buckets, mesh=target.mesh,
            kv_dtype=target.kv_dtype, device=target.device, _role="draft")

    def bind(self, slot: int) -> None:
        got = self.engine.pool.allocate()
        if got != slot:
            if got is not None:
                self.engine.pool.free(got)
            raise RuntimeError(
                f"draft/target slot mirror broken: target gave {slot}, "
                f"draft gave {got}")

    def release(self, slot: int) -> None:
        self.engine.pool.free(slot)

    def prime(self, slot: int, prompt_ids: Sequence[int]) -> None:
        """Prefill the draft lane with the whole prompt in one call (the
        ladder always covers prefill_len, so one bucket suffices)."""
        self.engine.prefill_chunk_call(
            slot, list(prompt_ids), 0, 1.0, None, None, False, None)


class SpeculativeDecoder:
    """propose → verify → accept-n for the scheduler's decode round.

    Owns the draft engine. The scheduler calls ``bind``/``release`` in
    lockstep with the target pool, ``prime`` at the end of a prefill, and
    per round: ``propose`` (k draft steps), ``verify`` per speculating
    slot, ``accept_len``, then ``backfill`` for fully accepted slots."""

    def __init__(self, target: DecodeEngine, draft_params, draft_cfg: GPTConfig,
                 k: int):
        k = int(k)
        if k < 1:
            raise ValueError(f"spec_k must be >= 1, got {k}")
        if k + 1 > target.cfg.block_size:
            raise ValueError(
                f"spec_k {k} leaves no room for the bonus row in a "
                f"{target.cfg.block_size}-position window")
        self.target = target
        self.k = k
        self.rows = k + 1
        self.draft = DraftEngine(draft_params, draft_cfg, target)
        self._parked = target.cfg.block_size - 1
        # migrated draft rows parked until their request primes: prompt
        # prefix -> entry dict on the draft's device. A bounded FIFO of
        # advisory state (a miss only costs a full draft prefill)
        self.pending_draft: Dict[tuple, dict] = {}
        self.pending_draft_cap = 32
        self.prime_full = 0     # primes that paid a full draft prefill
        self.prime_adopted = 0  # primes served from migrated rows

    # -- slot lifecycle (mirrors the target pool) ----------------------
    def bind(self, slot: int) -> None:
        self.draft.bind(slot)

    def release(self, slot: int) -> None:
        self.draft.release(slot)

    def prime(self, slot: int, prompt_ids: Sequence[int]) -> str:
        """Fill the draft lane of a freshly prefilled request: one full
        un-chunked draft prefill or, when migration parked draft rows for a
        prefix of this prompt (``adopt_draft_rows``), a row install plus a
        prefill of the uncovered tail only (none for a bucket-aligned
        prompt). Returns the path taken, "full" or "adopted"."""
        prompt = [int(t) for t in prompt_ids]
        best = None
        for key in self.pending_draft:
            if len(key) <= len(prompt) and list(key) == prompt[:len(key)]:
                if best is None or len(key) > len(best):
                    best = key
        if best is not None:
            # one-shot: the rows now live in the slot's lane
            entry = self.pending_draft.pop(best)
            eng = self.draft.engine
            rows = eng.install_slot_rows(slot, entry)
            if rows < len(prompt):
                eng.prefill_chunk_call(slot, prompt[rows:], rows, 1.0, None,
                                       None, False, None)
            self.prime_adopted += 1
            return "adopted"
        self.draft.prime(slot, prompt)
        self.prime_full += 1
        return "full"

    # -- draft-row migration -------------------------------------------
    def migratable_draft_rows(self, prompt_len: int) -> int:
        """Rows worth moving from a primed draft lane: the largest ladder
        bucket <= prompt_len (no ``- 1``: the draft never regenerates
        prompt logits, so a bucket-aligned prompt moves its whole lane)."""
        best = 0
        for b in self.draft.engine.buckets:
            if b <= prompt_len:
                best = b
        return best

    def extract_draft_rows(self, slot: int, rows: int) -> Dict[str, torch.Tensor]:
        """The extract half of draft migration: the target's row copy, on
        the draft pool."""
        return self.draft.engine.extract_slot_rows(slot, rows)

    def adopt_draft_rows(self, key: Sequence[int], entry: dict) -> bool:
        """Park a migrated draft entry (a quantized lane with its scale
        planes) under the prompt prefix ``key`` until the re-routed
        request's ``prime``; the oldest entry leaves past the cap. Returns
        False when ``key`` is parked already."""
        key = tuple(int(t) for t in key)
        if key in self.pending_draft:
            return False
        entry = self.draft.engine._place_entry(entry)
        while len(self.pending_draft) >= self.pending_draft_cap:
            self.pending_draft.pop(next(iter(self.pending_draft)))
        self.pending_draft[key] = entry
        return True

    # -- eligibility ---------------------------------------------------
    def eligible(self, do_sample: bool, position: int) -> bool:
        """A lane speculates only when greedy (sampled lanes keep the plain
        path's one draw per token) and when all k+1 verify rows fit inside
        the cache window; near-window tails take the plain decode step."""
        return (not do_sample) and position + self.rows <= self.target.cfg.block_size

    # -- the round -----------------------------------------------------
    @torch.no_grad()
    def propose(self, tokens: np.ndarray, positions: np.ndarray,
                spec_mask: np.ndarray) -> np.ndarray:
        """k greedy draft decode steps over every speculating lane at once,
        queued on the device and read once at the end; the other lanes ride
        along parked (their draft rows at block_size-1 go stale, never
        read). Returns (S, k) proposals; rows where ``spec_mask`` is False
        are meaningless."""
        eng = self.draft.engine
        dev = eng.device
        s = len(tokens)
        mask = torch.as_tensor(np.asarray(spec_mask, bool)).to(dev)
        parked = torch.full((s,), self._parked, dtype=torch.int64, device=dev)
        toks = torch.where(mask, torch.as_tensor(np.asarray(tokens, np.int64)).to(dev), 0)
        pos = torch.where(mask, torch.as_tensor(np.asarray(positions, np.int64)).to(dev),
                          parked)
        ones = torch.ones(s, dtype=torch.float32, device=dev)
        zeros = torch.zeros(s, dtype=torch.int64, device=dev)
        out = []
        for _ in range(self.k):
            nxt = eng.decode_on_device(toks, pos, ones, zeros, ones, [False] * s,
                                       [None] * s)
            out.append(nxt)
            toks = torch.where(mask, nxt, 0)
            pos = torch.where(mask, pos + 1, parked)
        return torch.stack(out, dim=1).cpu().numpy()

    def verify(self, slot: int, row_tokens: Sequence[int], offset: int,
               temperature: float, top_k: Optional[int],
               top_p: Optional[float]) -> np.ndarray:
        """One target forward over the k+1 rows at ``offset..offset+k``;
        returns the target's greedy choice at every row (the lane keeps
        all k+1 written rows; rejected ones go stale)."""
        if len(row_tokens) != self.rows:
            raise ValueError(
                f"verify expects {self.rows} rows, got {len(row_tokens)}")
        if offset + self.rows > self.target.cfg.block_size:
            raise ValueError(
                f"verify rows at offset {offset} overrun the "
                f"{self.target.cfg.block_size} cache window (the scheduler "
                "gates eligibility on window headroom)")
        return self.target.verify_call(slot, row_tokens, offset, temperature,
                                       top_k, top_p)

    def accept_len(self, proposals: np.ndarray, greedy: np.ndarray) -> int:
        """Longest matching prefix + 1: the round emits ``greedy[:n_acc]``,
        always >= 1 token (the bonus) and all the target's own choices."""
        n_acc = 1
        while n_acc <= self.k and int(proposals[n_acc - 1]) == int(greedy[n_acc - 1]):
            n_acc += 1
        return n_acc

    def backfill(self, tokens: np.ndarray, positions: np.ndarray,
                 fill_mask: np.ndarray) -> None:
        """On full acceptance the draft row ``pos+k`` was never written (the
        k-th draft step read ``d_k`` as its output, not its input), but the
        next propose round attends it: one more draft step feeds ``d_k``
        there. Skipped when no lane fully accepted."""
        if not np.any(fill_mask):
            return
        s = len(tokens)
        toks = np.where(fill_mask, tokens, 0)
        pos = np.where(fill_mask, positions, self._parked)
        self.draft.engine.decode_step(
            toks, pos, np.ones(s, np.float32), np.zeros(s, np.int64),
            np.ones(s, np.float32), np.zeros(s, bool), [None] * s)

    # -- warmup / accounting -------------------------------------------
    def warmup(self) -> None:
        """Run the draft family (ladder and decode) and the verify call
        once. Scribbles slot 0 rows on both engines, harmless under the
        stale-row invariant, so both pools must be empty."""
        if self.target.pool.used_count:
            raise RuntimeError("spec warmup requires an empty target pool")
        self.draft.engine.warmup()
        self.verify(0, [0] * self.rows, 0, 1.0, None, None)

    def compile_counts(self) -> Dict[str, int]:
        """Speculation's shape families: verify 1 for the server's lifetime
        (fixed row count), draft prefill <= len(ladder), draft decode 1."""
        draft = self.draft.engine.compile_counts()
        return {"verify": len(self.target.verify_shapes),
                "draft_prefill": draft["prefill"],
                "draft_decode": draft["decode"]}

    def register_attrib(self, ledger, family_prefix: str = "") -> None:
        """Register verify (one row per k) and the draft engine's families
        under the ``draft_`` prefix, the ``compile_counts()`` names, with
        analytic costs (``DecodeEngine.register_attrib``)."""
        from mingpt_distributed_tpu_torch.telemetry import attribution

        tgt = self.target
        flops, nbytes = attribution.forward_cost(
            tgt.cfg, 1, self.rows, tgt.cfg.block_size,
            attribution.tree_bytes(tgt.params), tgt.kv_bytes_per_row(),
            head_rows=self.rows)
        ledger.observe_compile(f"{family_prefix}verify", 0.0, flops, nbytes,
                               variant=f"k{self.k}")
        self.draft.engine.register_attrib(ledger, family_prefix=f"{family_prefix}draft_")

    def audit_contracts(self, *args, **kwargs):
        _refuse("the static audit contracts (audit_contracts)", "16b")
