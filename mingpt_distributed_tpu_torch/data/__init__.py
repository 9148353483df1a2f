"""Tokenizers: the character vocabulary."""
