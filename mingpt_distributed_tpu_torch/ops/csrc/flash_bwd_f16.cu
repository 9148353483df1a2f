// float16 instances of the flash-attention backward: K2a (flash_bwd_dq),
// K2b (flash_bwd_dkv), K2c (flash_bwd_fused), K4a (flash_lse_bwd_dq), K4b
// (flash_lse_bwd_dkv) and the prep pass (flash_bwd_prep) for float16 q, k,
// v, out and dO, dtype code 2. The TPU kernels (`_dq_kernel_btd`,
// `_dkv_kernel_btd`, `_dqkv_kernel_btd`, `_dq_kernel`, `_dkv_kernel` in
// mingpt_distributed_tpu/ops/flash_attention.py) run float16 as they run
// bfloat16: P and dS rounded to the input dtype before their products,
// float32 accumulation, float32 lse and delta. This file compiles
// flash_bwd.cu's kernel bodies for __half (flash_dq_f16_kernel,
// flash_dkv_f16_kernel, flash_bwd_prep_kernel<__half, G>) into a library of
// its own, so that nvcc builds it beside the float32 and bfloat16 one
// (ops/_build.py runs one nvcc per source, all at once). Design and bounds:
// flash_bwd.cu.
#define FLASH_F16 1
#include "flash_bwd.cu"
