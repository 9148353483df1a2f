"""Causal flash attention: the dispatch, the hand-written CUDA kernel's
wrapper, and the kernel's plain PyTorch version.

Counterpart of ``mingpt_distributed_tpu/ops/flash_attention.py:1230-1315``.
The kernel (``csrc/flash_fwd.cu``) replaces the TPU kernel
``_fwd_kernel_btd``; see the source for its design and what bounds it.

* ``causal_attention`` takes the einsum oracle exactly where the JAX
  package does, for semantic reasons: attention dropout active, q and k
  lengths differ (decode against a cache), or a non-zero or tensor
  ``kv_offset``. Otherwise it runs ``flash_fwd``. The TPU-only machinery
  (block-size ladder, lane packing, odd-head padding, layout switches) has
  no counterpart: the kernel takes any T >= 1 and any head count.
* ``flash_fwd`` runs the plain version for tensors on the CPU. For CUDA
  tensors it launches the kernel or raises; nothing falls back. It is
  forward-only in this slice: the gradient (the backward kernels) comes
  with the training slice.
* ``flash_fwd_plain`` is dense masked softmax in float32 with the
  natural-domain log-sum-exp: what the kernel computes, written plainly.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from mingpt_distributed_tpu_torch.ops import _build
from mingpt_distributed_tpu_torch.ops import attention as attn_ops

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    window: Optional[int] = None, softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, T, H, hd), k/v (B, T, KV, hd) -> (out (B, T, H, hd) in q's
    dtype, lse (B, H, T) float32, natural domain). The probabilities stay
    float32 here; the kernel's bf16 path rounds them to bf16 before P V,
    as the TPU kernel does."""
    h = q.shape[2]
    k = attn_ops.repeat_kv(k, h // k.shape[2])
    v = attn_ops.repeat_kv(v, h // v.shape[2])
    t = q.shape[1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    s = attn_ops.softcap(s, softcap)
    pos = torch.arange(t, device=q.device)
    allowed = pos[:, None] >= pos[None, :]
    if window is not None:
        allowed = allowed & (pos[:, None] - pos[None, :] < window)
    s = torch.where(allowed, s, torch.full((), attn_ops.NEG_INF, device=q.device))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhts,bshd->bthd", p, v.float())
    return out.to(q.dtype), lse


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.flash_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr,            # q, k, v, out, lse
        i32, i32, i32, i32, i32,            # B, T, H, KV, hd
        i64, i64, i64, i64, i64, i64, i64, i64, i64,  # b/t/h strides of q, k, v
        f32, i32, f32, i32,                 # scale, window, softcap, dtype
        ptr,                                # stream
    ]
    lib.flash_fwd.restype = ctypes.c_int


def _kernel() -> ctypes.CDLL:
    lib = _build.load("flash_fwd")
    if lib.flash_fwd.argtypes is None:
        _declare(lib)
    return lib


def _check_cuda_inputs(q, k, v) -> None:
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_fwd is forward-only: its gradient needs the backward "
            "kernels (K2 in ROADMAP.md Queue 2), ported with the training "
            "slice; run inference under torch.no_grad()"
        )
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on the same device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_fwd takes float32 or bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, t, h, hd = q.shape
    if k.shape[0] != b or k.shape[1] != t or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    if t < 1:
        raise ValueError("empty sequence")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_fwd needs a dense last (head_dim) axis")
    if q.dtype == torch.bfloat16 and not all(
            x.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in x.stride()[:3])
            for x in (q, k, v)):
        raise ValueError("flash_fwd loads bf16 rows with 16-byte loads: "
                         "q/k/v rows must start on 16-byte boundaries")


def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    window: Optional[int] = None, softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper: q (B, T, H, hd), k/v (B, T, KV, hd) ->
    (out (B, T, H, hd) in q's dtype, lse (B, H, T) float32).

    CPU tensors take ``flash_fwd_plain``. CUDA tensors launch the kernel
    (counted in ``flash_fwd.launches``) or raise.
    """
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale=scale, window=window,
                               softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu tensors, not {q.device}")
    _check_cuda_inputs(q, k, v)
    b, t, h, hd = q.shape
    lib = _kernel()
    out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, t, h, k.shape[2], hd,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), 0 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            _DTYPE_CODES[q.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def causal_attention(
    q: torch.Tensor,  # (B, T, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,
    *,
    attn_pdrop: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    kv_offset: Union[int, torch.Tensor] = 0,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Drop-in for ops.attention.causal_attention that runs the flash
    kernel wherever the JAX package runs its flash kernel."""
    use_flash = (
        q.shape[1] == k.shape[1]
        and (deterministic or attn_pdrop == 0.0)
        and isinstance(kv_offset, int)
        and kv_offset == 0
    )
    if not use_flash:
        return attn_ops.causal_attention(
            q, k, v, attn_pdrop=attn_pdrop, generator=generator,
            deterministic=deterministic, kv_offset=kv_offset, window=window,
            logit_softcap=logit_softcap,
        )
    out, _ = flash_fwd(
        q, k, v, scale=1.0 / math.sqrt(q.shape[3]),
        window=None if window is None else int(window),
        softcap=None if logit_softcap is None else float(logit_softcap),
    )
    return out
