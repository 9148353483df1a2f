"""Layers, the attention oracle and the hand-written CUDA kernels."""
