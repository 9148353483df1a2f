// float16 instances of the flash-attention forward: K1 (flash_fwd) and K3
// (flash_lse_fwd) for float16 q, k and v, dtype code 2. The TPU kernels
// (`_fwd_kernel_btd`, `_fwd_kernel` in mingpt_distributed_tpu/ops/
// flash_attention.py) run float16 as they run bfloat16: P rounded to the
// input dtype before P V, float32 accumulation, a float32 lse. This file
// compiles flash_fwd.cu's tensor-core kernel for __half (the kernels
// flash_fwd_f16_kernel<HD, kLse, kNat>) into a library of its own, so that
// nvcc builds it beside the float32 and bfloat16 one (ops/_build.py runs
// one nvcc per source, all at once). Design and bounds: flash_fwd.cu.
#define FLASH_F16 1
#include "flash_fwd.cu"
