"""Character-level dataset: vocabulary, (x, y) windows, the contiguous
train/test split and the resumable batch iterator.

Counterpart of ``mingpt_distributed_tpu/data/char_dataset.py``: the same
ids (the sorted set of characters of the leading ``truncate`` fraction of
the corpus), the same windows and split, and the same shuffled order: the
permutation of an epoch is numpy's ``default_rng(seed + epoch)``, so for a
given seed and resume position the port yields exactly the JAX package's
batches. Under dp x sp each process takes its share of every global batch:
its dp replica's rows (``process_index`` of ``process_count``, as in JAX)
and its sp rank's columns (``seq_index`` of ``seq_count``), so the ranks
together hold exactly the JAX global batch. The corpus is a local file;
batches are gathered by the C loop of ``data/native_batcher.py`` (built with
gcc at first use; the port's copy of ``runtime/native_batcher.c``), which
releases the GIL so a prefetch thread overlaps it with the step;
``gather_numpy`` is its plain version.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from mingpt_distributed_tpu_torch.config import DataConfig
from mingpt_distributed_tpu_torch.data import native_batcher


class CharDataset:
    """A corpus of characters with next-char (x, y) windows of
    ``block_size``."""

    def __init__(self, config: DataConfig, text: Optional[str] = None):
        self.config = config
        if text is None:
            with open(config.path, encoding="utf-8", errors="replace") as f:
                text = f.read()
        text = text[: int(len(text) * config.truncate)]
        # np.unique sorts, so ids match sorted(set(text))
        vocab, inverse = np.unique(np.array(list(text)), return_inverse=True)
        self.stoi = {ch: i for i, ch in enumerate(vocab.tolist())}
        self.itos = {i: ch for ch, i in self.stoi.items()}
        self.vocab_size = len(vocab)
        self.block_size = config.block_size
        self.data = inverse.astype(np.int32)
        if len(self.data) <= self.block_size:
            raise ValueError(
                f"corpus ({len(self.data)} chars) must exceed block_size "
                f"({self.block_size})")

    def __len__(self) -> int:
        return len(self.data) - self.block_size

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        chunk = self.data[idx: idx + self.block_size + 1]
        return chunk[:-1].astype(np.int32), chunk[1:].astype(np.int32)

    def encode(self, text: str) -> np.ndarray:
        return np.array([self.stoi[c] for c in text], dtype=np.int32)

    def decode(self, ids) -> str:
        return "".join(self.itos[int(i)] for i in np.asarray(ids).reshape(-1))

    def split(self, train_split: Optional[float] = None
              ) -> Tuple["CharView", "CharView"]:
        """Contiguous train/test split; no window spans the cut."""
        frac = self.config.train_split if train_split is None else train_split
        cut = int(len(self.data) * frac)
        return CharView(self, 0, cut), CharView(self, cut, len(self.data))


class CharView:
    """A contiguous [start, stop) character range of a CharDataset."""

    def __init__(self, parent: CharDataset, start: int, stop: int):
        self.parent = parent
        self.start = start
        self.stop = stop
        self.block_size = parent.block_size
        self.vocab_size = parent.vocab_size

    def __len__(self) -> int:
        return max(0, (self.stop - self.start) - self.block_size)

    def gather(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(x, y) int32 batch for window start offsets within this view,
        gathered by the C loop."""
        starts = np.asarray(indices, dtype=np.int64) + self.start
        chunks = native_batcher.gather_windows(self.parent.data, starts,
                                               self.block_size)
        return chunks[:, :-1], chunks[:, 1:]

    def gather_numpy(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``gather``'s plain version: numpy fancy indexing."""
        starts = np.asarray(indices, dtype=np.int64) + self.start
        offs = np.arange(self.block_size + 1, dtype=np.int64)
        chunks = self.parent.data[starts[:, None] + offs[None, :]]
        return chunks[:, :-1].astype(np.int32), chunks[:, 1:].astype(np.int32)


@dataclass
class IteratorState:
    """Resumable position of a ShardedBatchIterator."""

    epoch: int = 0
    step_in_epoch: int = 0
    seed: int = 0

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "step_in_epoch": self.step_in_epoch,
                "seed": self.seed}

    @classmethod
    def from_dict(cls, d: dict) -> "IteratorState":
        return cls(**d)


class ShardedBatchIterator:
    """Batches of a view in the JAX package's order: each epoch a
    permutation seeded ``seed + epoch`` (or the plain order), cut into
    global batches of ``batch_size`` windows, the ragged tail dropped. This
    process yields rows ``[process_index * b, (process_index + 1) * b)`` of
    each (b = batch_size / process_count) and, of those, the
    ``seq_index``-th of ``seq_count`` equal column chunks."""

    def __init__(self, view: CharView, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, process_index: int = 0, process_count: int = 1,
                 seq_index: int = 0, seq_count: int = 1):
        if batch_size % process_count:
            raise ValueError(f"batch_size={batch_size} not divisible by "
                             f"process_count={process_count}")
        if view.block_size % seq_count:
            raise ValueError(f"block_size={view.block_size} not divisible by "
                             f"seq_count={seq_count}")
        if len(view) < batch_size:
            raise ValueError(
                f"view has {len(view)} windows < batch {batch_size}")
        self.view = view
        self.batch_size = batch_size
        self.local_batch_size = batch_size // process_count
        self.process_index = process_index
        self.seq_index, self.seq_count = seq_index, seq_count
        self.shuffle = shuffle
        self.state = IteratorState(seed=seed)

    @property
    def steps_per_epoch(self) -> int:
        return len(self.view) // self.batch_size

    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.view)
        if self.shuffle:
            return np.random.default_rng(self.state.seed + epoch).permutation(n)
        return np.arange(n)

    def epoch_batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield the remaining batches of the current epoch, then advance the
        epoch counter; a restored state resumes at its step."""
        order = self._epoch_order(self.state.epoch)
        c = self.view.block_size // self.seq_count
        cols = slice(self.seq_index * c, (self.seq_index + 1) * c)
        for step in range(self.state.step_in_epoch, self.steps_per_epoch):
            base = step * self.batch_size + self.process_index * self.local_batch_size
            self.state.step_in_epoch = step + 1
            x, y = self.view.gather(order[base: base + self.local_batch_size])
            yield (x, y) if self.seq_count == 1 else (x[:, cols], y[:, cols])
        self.state.epoch += 1
        self.state.step_in_epoch = 0
