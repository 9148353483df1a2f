"""mingpt_distributed_tpu_torch: the PyTorch/CUDA port of
mingpt_distributed_tpu for NVIDIA Hopper (H100), beside the JAX package,
which stays the reference it is held against.

It keeps the JAX package's module layout and names, imports torch and
numpy and never jax or anything of mingpt_distributed_tpu, and replaces
each Pallas TPU kernel on its path with a hand-written CUDA kernel
(ops/csrc/, built with nvcc at first use). Entry points run on CUDA unless
the caller asks for the CPU; on the CPU the kernels' plain PyTorch
versions run instead.

This slice: the inference path (config, layers, attention, the causal
flash-attention forward kernel, the GPT forward, KV-cached and
sliding-window generation, the char vocabulary, the sample CLI).
"""

from mingpt_distributed_tpu_torch.config import (  # noqa: F401
    MODEL_PRESETS,
    ConfigError,
    DataConfig,
    ExperimentConfig,
    GPTConfig,
    apply_overrides,
    load_config,
)

__version__ = "0.1.0"
