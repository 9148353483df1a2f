"""Character vocabulary of a text corpus.

Counterpart of the vocabulary part of
``mingpt_distributed_tpu/data/char_dataset.py``: the same ids (the sorted
set of characters of the leading ``truncate`` fraction of the corpus), with
``encode`` and ``decode``. The corpus is a local file. The training windows
and the batch iterator come with the training slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from mingpt_distributed_tpu_torch.config import DataConfig


class CharDataset:
    """The character vocabulary of ``config.path`` (or of ``text``)."""

    def __init__(self, config: DataConfig, text: Optional[str] = None):
        self.config = config
        if text is None:
            with open(config.path, encoding="utf-8", errors="replace") as f:
                text = f.read()
        text = text[: int(len(text) * config.truncate)]
        chars = sorted(set(text))
        self.stoi = {ch: i for i, ch in enumerate(chars)}
        self.itos = {i: ch for ch, i in self.stoi.items()}
        self.vocab_size = len(chars)
        self.block_size = config.block_size

    def encode(self, text: str) -> np.ndarray:
        return np.array([self.stoi[c] for c in text], dtype=np.int32)

    def decode(self, ids) -> str:
        return "".join(self.itos[int(i)] for i in np.asarray(ids).reshape(-1))
