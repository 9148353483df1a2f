"""Tokenizers and datasets: the character vocabulary and byte-level BPE."""
