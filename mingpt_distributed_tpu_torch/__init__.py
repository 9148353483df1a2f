"""mingpt_distributed_tpu_torch: the PyTorch/CUDA port of
mingpt_distributed_tpu for NVIDIA Hopper (H100), beside the JAX package,
which stays the reference it is held against.

It keeps the JAX package's module layout and names, imports torch and
numpy and never jax or anything of mingpt_distributed_tpu, and replaces
each Pallas TPU kernel on its path with a hand-written CUDA kernel
(ops/csrc/, built with nvcc at first use). Entry points run on CUDA unless
the caller asks for the CPU; on the CPU the kernels' plain PyTorch
versions run instead.

Ported so far: the inference path (config, layers, attention, the causal
flash-attention forward kernel, the GPT forward, KV-cached and
sliding-window generation, the sample CLI), training on one GPU and dp x
sp across processes (the flash-attention backward kernels, chunked
cross-entropy, remat, AdamW, the data iterator with its C batch gather,
durable and asynchronous snapshots, the trainer, its telemetry and the
train CLI; ring and Ulysses attention), mixture-of-experts blocks in one
process, the char and byte-level BPE tokenizers, the HuggingFace GPT-2 and
Llama weight loaders, and serving (the continuous-batching engine and
scheduler, speculative decoding, int8/fp8 KV pools, their metrics, request
tracing, the flight recorder, SLO reports, attribution and the recompile
watchdog, the /metrics, /debug/flight and /attrib endpoints, the serve
CLI).
"""

from mingpt_distributed_tpu_torch.config import (  # noqa: F401
    MODEL_PRESETS,
    ConfigError,
    DataConfig,
    ExperimentConfig,
    GPTConfig,
    MeshConfig,
    OptimizerConfig,
    TrainerConfig,
    apply_overrides,
    load_config,
)

__version__ = "0.1.0"
