"""BPE-token dataset: the CharDataset surface over subword tokens.

Counterpart of ``mingpt_distributed_tpu/data/token_dataset.py``: the same
public surface as ``CharDataset`` (``data``, ``vocab_size``, ``block_size``,
``encode``/``decode``, ``split()`` into contiguous views), so the trainer and
the entry points run unchanged with ``data_config.tokenizer: bpe``. The
tokenizer loads from ``bpe_path`` (a saved ``BPETokenizer``) or is trained
on the corpus to ``bpe_vocab_size``. The corpus is a local file.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from mingpt_distributed_tpu_torch.config import DataConfig
from mingpt_distributed_tpu_torch.data.bpe import BPETokenizer
from mingpt_distributed_tpu_torch.data.char_dataset import CharDataset, CharView


class TokenDataset:
    """Corpus of BPE tokens with next-token (x, y) windows."""

    def __init__(
        self,
        config: DataConfig,
        text: Optional[str] = None,
        tokenizer: Optional[BPETokenizer] = None,
    ):
        self.config = config
        if text is None:
            with open(config.path, encoding="utf-8", errors="replace") as f:
                text = f.read()
        text = text[: int(len(text) * config.truncate)]
        if tokenizer is not None:
            self.tokenizer = tokenizer
        elif config.bpe_path:
            self.tokenizer = BPETokenizer.load(config.bpe_path)
        else:
            self.tokenizer = BPETokenizer.train(text, config.bpe_vocab_size)
        self.vocab_size = self.tokenizer.vocab_size
        self.block_size = config.block_size
        self.data = self.tokenizer.encode(text)
        if len(self.data) <= self.block_size:
            raise ValueError(
                f"corpus ({len(self.data)} tokens) must exceed block_size "
                f"({self.block_size})")

    def __len__(self) -> int:
        return len(self.data) - self.block_size

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        chunk = self.data[idx: idx + self.block_size + 1]
        return chunk[:-1].astype(np.int32), chunk[1:].astype(np.int32)

    def encode(self, text: str) -> np.ndarray:
        return self.tokenizer.encode(text)

    def decode(self, ids) -> str:
        return self.tokenizer.decode(ids)

    def split(self, train_split: Optional[float] = None
              ) -> Tuple[CharView, CharView]:
        frac = self.config.train_split if train_split is None else train_split
        cut = int(len(self.data) * frac)
        return CharView(self, 0, cut), CharView(self, cut, len(self.data))


def make_dataset(config: DataConfig, text: Optional[str] = None):
    """Dataset factory keyed by ``data_config.tokenizer``."""
    if config.tokenizer == "bpe":
        return TokenDataset(config, text=text)
    return CharDataset(config, text=text)
