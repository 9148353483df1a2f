"""Byte-level BPE tokenizer: GPT-2's files, or merges learned offline.

Counterpart of ``mingpt_distributed_tpu/data/bpe.py`` with the same ids,
merges and file format:

* ``BPETokenizer.from_gpt2_files(encoder_json, vocab_bpe)`` loads the
  OpenAI vocabulary and merges from local files (exact GPT-2
  tokenization: the byte-to-unicode table, merge ranks and GPT-2's
  contraction/letter/number split pattern);
* ``BPETokenizer.train(text, vocab_size)`` learns merges from a corpus
  (``data_config.tokenizer: bpe``);
* ``save``/``load`` write and read the JAX package's JSON layout, so a
  tokenizer saved by either package loads in the other.

The split pattern is written with the ``regex`` module's ``\\p{L}`` and
``\\p{N}``, which the standard library's ``re`` lacks. ``_compile`` turns it
into an ``re`` pattern with explicit character classes built from
``unicodedata`` (general categories L* and N*) and Unicode's White_Space
set, which is ``regex``'s ``\\s``. Python's ``[^\\W\\d_]`` would not do for
``\\p{L}``: it admits No and Nl characters such as ``½``, ``²`` and ``Ⅻ``.
"""

from __future__ import annotations

import functools
import json
import re
import sys
import unicodedata
from typing import Dict, Iterable, List, Tuple

import numpy as np

# GPT-2's pre-tokenization pattern: contractions, letter runs, number runs,
# punctuation runs, and whitespace handling.
GPT2_SPLIT_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)

# Unicode's White_Space property (what ``regex`` matches with \s); Python's
# str.isspace() also admits U+001C..U+001F, which regex does not
_WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029"
                "\u202f\u205f\u3000")


def _ranges(codepoints: List[int]) -> str:
    """A character-class body (``a-z...``, escaped) of sorted code points."""
    out: List[str] = []
    i = 0
    while i < len(codepoints):
        j = i
        while j + 1 < len(codepoints) and codepoints[j + 1] == codepoints[j] + 1:
            j += 1
        lo, hi = re.escape(chr(codepoints[i])), re.escape(chr(codepoints[j]))
        out.append(lo if i == j else f"{lo}-{hi}")
        i = j + 1
    return "".join(out)


@functools.lru_cache(maxsize=None)
def _classes() -> Tuple[str, str]:
    """(letters, numbers): the class bodies of \\p{L} and \\p{N}, built
    once per process from every code point's general category."""
    letters: List[int] = []
    numbers: List[int] = []
    for cp in range(sys.maxunicode + 1):
        major = unicodedata.category(chr(cp))[0]
        if major == "L":
            letters.append(cp)
        elif major == "N":
            numbers.append(cp)
    return _ranges(letters), _ranges(numbers)


@functools.lru_cache(maxsize=None)
def _compile(pattern: str) -> "re.Pattern[str]":
    """``pattern`` (``regex`` syntax) as an ``re`` pattern: ``\\p{L}``,
    ``\\p{N}``, ``\\s`` and ``\\S`` become explicit classes. Raises for any
    other ``\\p{...}``/``\\P{...}`` property, which ``re`` cannot express."""
    letters, numbers = _classes()
    ws = _WHITE_SPACE
    out = (pattern
           .replace(r"[^\s\p{L}\p{N}]", f"[^{ws}{letters}{numbers}]")
           .replace(r"\p{L}", f"[{letters}]")
           .replace(r"\p{N}", f"[{numbers}]")
           .replace(r"\S", f"[^{ws}]")
           .replace(r"\s", f"[{ws}]"))
    if r"\p{" in out or r"\P{" in out:
        raise ValueError(
            f"split pattern {pattern!r} uses a Unicode property other than "
            r"\p{L} and \p{N}; only those are translated to the standard "
            "library's re")
    return re.compile(out)


def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte -> printable-unicode bijection: printable ASCII and
    latin-1 map to themselves; the rest shift into 256+ codepoints."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _merge_pair(parts: Tuple[str, ...], pair: Tuple[str, str]) -> List[str]:
    """``parts`` with every left-to-right occurrence of ``pair`` merged."""
    merged = pair[0] + pair[1]
    out: List[str] = []
    i = 0
    while i < len(parts):
        if i + 1 < len(parts) and (parts[i], parts[i + 1]) == pair:
            out.append(merged)
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return out


class BPETokenizer:
    """Byte-level BPE with GPT-2-compatible loading and offline training."""

    def __init__(
        self,
        encoder: Dict[str, int],
        merge_ranks: Dict[Tuple[str, str], int],
        split_pattern: str = GPT2_SPLIT_PATTERN,
    ):
        self.encoder = dict(encoder)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.merge_ranks = dict(merge_ranks)
        self.split_pattern = split_pattern
        self.pattern = _compile(split_pattern)
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, List[str]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_gpt2_files(cls, encoder_json: str, vocab_bpe: str) -> "BPETokenizer":
        """Exact GPT-2 tokenizer from the standard OpenAI artifacts."""
        with open(encoder_json) as f:
            encoder = json.load(f)
        with open(vocab_bpe, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(ln.split()) for ln in lines
                  if ln and not ln.startswith("#")]
        ranks = {m: i for i, m in enumerate(m for m in merges if len(m) == 2)}
        return cls(encoder, ranks)

    @classmethod
    def train(
        cls, text: str, vocab_size: int, split_pattern: str = GPT2_SPLIT_PATTERN
    ) -> "BPETokenizer":
        """Learn merges from a corpus (offline path). vocab_size >= 256.
        Each round merges the most frequent adjacent pair (ties broken by
        the larger pair), until the vocabulary is full or no pair occurs
        twice."""
        if vocab_size < 256:
            raise ValueError("byte-level BPE needs vocab_size >= 256")
        byte_enc = bytes_to_unicode()
        # word -> frequency, each word as a tuple of unicode-mapped bytes
        words: Dict[Tuple[str, ...], int] = {}
        for piece in _compile(split_pattern).findall(text):
            w = tuple(byte_enc[b] for b in piece.encode("utf-8"))
            if w:
                words[w] = words.get(w, 0) + 1

        encoder = {ch: i for i, ch in enumerate(byte_enc[b] for b in range(256))}
        ranks: Dict[Tuple[str, str], int] = {}
        while len(encoder) < vocab_size:
            pair_counts: Dict[Tuple[str, str], int] = {}
            for w, c in words.items():
                for a, b in zip(w, w[1:]):
                    pair_counts[(a, b)] = pair_counts.get((a, b), 0) + c
            if not pair_counts:
                break
            best = max(pair_counts, key=lambda p: (pair_counts[p], p))
            if pair_counts[best] < 2:
                break
            ranks[best] = len(ranks)
            encoder[best[0] + best[1]] = len(encoder)
            new_words: Dict[Tuple[str, ...], int] = {}
            for w, c in words.items():
                t = tuple(_merge_pair(w, best))
                new_words[t] = new_words.get(t, 0) + c
            words = new_words
        return cls(encoder, ranks, split_pattern)

    # ------------------------------------------------------------------
    # encode / decode
    # ------------------------------------------------------------------
    def _bpe(self, token: str) -> List[str]:
        """Apply merges to one pre-token (unicode-mapped byte string)."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts = list(token)
        while len(parts) > 1:
            pairs = {(a, b) for a, b in zip(parts, parts[1:])}
            best = min(pairs, key=lambda p: self.merge_ranks.get(p, float("inf")))
            if best not in self.merge_ranks:
                break
            parts = _merge_pair(tuple(parts), best)
        self._cache[token] = parts
        return parts

    def encode(self, text: str) -> np.ndarray:
        ids: List[int] = []
        for piece in self.pattern.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            ids.extend(self.encoder[part] for part in self._bpe(mapped))
        return np.array(ids, dtype=np.int32)

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in np.asarray(ids).reshape(-1))
        raw = bytes(self.byte_decoder[ch] for ch in text)
        return raw.decode("utf-8", errors="replace")

    # ------------------------------------------------------------------
    # persistence (the JAX package's JSON layout)
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "encoder": self.encoder,
                    "merges": [list(k) for k in sorted(
                        self.merge_ranks, key=self.merge_ranks.get)],
                    "pattern": self.split_pattern,
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            blob = json.load(f)
        ranks = {tuple(m): i for i, m in enumerate(blob["merges"])}
        return cls(blob["encoder"], ranks, blob["pattern"])
