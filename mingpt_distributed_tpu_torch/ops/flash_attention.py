"""Flash attention: the dispatch, the autograd Functions, the hand-written
CUDA kernels' wrappers, and the kernels' plain PyTorch versions.

Counterpart of ``mingpt_distributed_tpu/ops/flash_attention.py:280-645`` and
``:1089-1315``. The kernels replace the TPU kernels ``_fwd_kernel_btd`` (K1)
and ``_fwd_kernel`` (K3) (``csrc/flash_fwd.cu``: ``flash_fwd``,
``flash_lse_fwd``), ``_dq_kernel_btd`` + ``_dkv_kernel_btd`` (K2a, K2b),
the fused ``_dqkv_kernel_btd`` (K2c) and ``_dq_kernel`` + ``_dkv_kernel``
(K4a, K4b) (``csrc/flash_bwd.cu``: ``flash_bwd_dq``/``_dkv``,
``flash_bwd_fused``, ``flash_lse_bwd_dq``/``_dkv``). The same sources'
``nh_*`` entry points replace the per-head-grid prototype's kernels (K5,
wrapped in ``tools/proto_nh_kernel.py``). ``flash_bwd_prep`` (also
``csrc/flash_bwd.cu``) computes every backward's delta = rowsum(out * dO)
(minus the lse cotangent) and zeroes K2c's float32 dq in one pass; it
replaces no TPU kernel (the JAX package sums delta with ``jnp.sum``). See
the sources for their design and what bounds them.

* ``causal_attention`` takes the einsum oracle exactly where the JAX
  package does, for semantic reasons: attention dropout active, q and k
  lengths differ (decode against a cache), or a non-zero or tensor
  ``kv_offset``. Otherwise it runs ``FlashAttention``, whose forward is
  ``flash_fwd`` and whose backward is ``flash_bwd``, as ``_flash_btd``'s
  custom VJP is in the JAX package. The TPU-only machinery (block-size
  ladder, lane packing, odd-head padding, layout switches, the fused
  backward's VMEM budget) has no counterpart: the kernels take any T >= 1
  and any head count.
* Head widths: the kernels have instances at ``NATIVE_HEAD_DIMS`` (16, 32,
  64, 80, 96, 128, 256). Any other width in ``HEAD_DIM_RANGE`` (8 to 256)
  runs the next instance up (``head_plan``): the wrappers copy q, k, v (and
  out, dO in the backward) zero-padded to that width, which changes no dot
  product, softmax or lse (the scale stays the caller's 1/sqrt(true hd)),
  and return out, dq, dk and dv at the true width (views of the padded
  results). The copy costs one read of each input and one write of its
  padded form, and the kernels do the instance's work: at hd 48, 2 x 48 +
  2 x 64 bytes per bf16 row of each input beside the kernel's own, and 4/3
  of its products. Beyond 256 the kernels raise: wgmma's N is at most 256,
  and the JAX package's public configs need no more. Native widths are
  read in place through the caller's strides (a q/k/v view of one qkv
  projection is not copied).
* ``FLASH_FUSED_BWD=1``, the JAX package's own switch, read at each call as
  ``_flash_bwd_btd`` reads it, sends ``flash_bwd`` on CUDA tensors to the
  fused kernel K2c (``flash_bwd_fused``) in place of K2a + K2b, at any T.
* dtypes: float32 (SIMT kernels), bfloat16 and float16 (the TMA + wgmma
  kernels; float16's instances live in libraries of their own,
  ``csrc/flash_fwd_f16.cu`` and ``csrc/flash_bwd_f16.cu``, which compile
  the same kernel bodies for ``__half``). A 16-bit kernel rounds P and dS
  to its input dtype before their products, as the TPU kernels do, and
  accumulates in float32; lse and delta stay float32. The prototype's K5
  keeps float32 and bfloat16, as its JAX tool does.
* ``flash_fwd`` and ``flash_bwd`` run the plain versions for tensors on the
  CPU. For CUDA tensors they launch the kernels or raise; nothing falls
  back (a float16 CUDA tensor launches a float16 instance, never a
  float32 one).
* ``flash_fwd_plain`` is dense masked softmax with the natural-domain
  log-sum-exp, ``flash_bwd_plain`` the dense gradient from the saved lse:
  what the kernels compute, written plainly, in float32 (float64 for
  float64 inputs, so ``gradcheck`` can run on the CPU).
* ``flash_with_lse`` is the ring-attention building block (JAX
  ``flash_with_lse``): ``FlashLse``, differentiable in both outputs, over
  ``flash_lse_fwd`` and ``flash_lse_bwd`` (plain versions
  ``flash_lse_fwd_plain``/``flash_lse_bwd_plain``), with a ``causal`` flag
  and a ``q_offset`` that places query row i at key position q_offset + i.
  Dead rows (no key of the chunk inside an offset band) come out as out = 0
  and a finite lse <= -1e29, and their probabilities are exactly 0, so an
  lse merge weights them 0 and their gradients vanish. The lse cotangent
  folds into delta (delta' = delta - dlse) in ``flash_bwd_prep``. The JAX
  ``_flash`` (``FLASH_LAYOUT=bh``) is TPU layout machinery and has no
  counterpart.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional, Tuple, Union

import torch

from mingpt_distributed_tpu_torch.ops import _build
from mingpt_distributed_tpu_torch.ops import attention as attn_ops

NATIVE_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
HEAD_DIM_RANGE = (8, 256)
# dtype: its code in the C entry points. Each library holds some codes and
# refuses the others (cudaErrorInvalidValue): flash_fwd and flash_bwd 0 and
# 1, their float16 builds flash_fwd_f16 and flash_bwd_f16 2.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# entry points the float16 libraries do not have: K5 keeps its JAX tool's
# dtypes
_NOT_IN_F16 = ("nh_fwd", "nh_bwd_dq", "nh_bwd_dkv")


def head_plan(hd: int) -> Tuple[int, int]:
    """(instance, pad) for head width ``hd``: the kernel instance that runs
    it (``hd`` itself where one exists, else the next of
    ``NATIVE_HEAD_DIMS`` up) and the zero columns the wrappers append to
    reach it. Raises ValueError outside ``HEAD_DIM_RANGE``."""
    lo, hi = HEAD_DIM_RANGE
    if not lo <= hd <= hi:
        raise ValueError(f"head_dim {hd} is outside the flash kernels' range {lo}..{hi} "
                         "(wgmma's N is at most 256)")
    inst = next(n for n in NATIVE_HEAD_DIMS if n >= hd)
    return inst, inst - hd


def _padded(pad: int, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each of ``xs`` with ``pad`` zero columns appended to its last (head)
    axis, as a dense copy; the tensors themselves when ``pad`` is 0."""
    if pad == 0:
        return xs
    return tuple(torch.nn.functional.pad(x, (0, pad)) for x in xs)


def _true_width(pad: int, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each of ``xs`` without its last ``pad`` columns (views)."""
    if pad == 0:
        return xs
    return tuple(x[..., :x.shape[-1] - pad] for x in xs)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' working type: float64 for float64, else
    float32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _allowed(t: int, window: Optional[int], device, causal: bool = True,
             q_offset: int = 0) -> torch.Tensor:
    """(T, T) mask of the visible (query, key) pairs: query row i at key
    position q_offset + i sees the keys at or before it, banded to the last
    ``window``; every pair when not causal (the window is then unused, as in
    the TPU kernels)."""
    pos = torch.arange(t, device=device)
    if not causal:
        return torch.ones((t, t), dtype=torch.bool, device=device)
    qg = pos[:, None] + q_offset
    allowed = qg >= pos[None, :]
    if window is not None:
        allowed = allowed & (qg - pos[None, :] < window)
    return allowed


def flash_lse_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None, q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, T, H, hd), k/v (B, T, KV, hd) -> (out (B, T, H, hd) in q's
    dtype, lse (B, H, T) float32, natural domain). The probabilities stay
    float32 here; the kernel's bf16 path rounds them to bf16 before P V,
    as the TPU kernel does. p is exactly 0 off the band, so a dead row gets
    out = 0 and lse = logsumexp of its masked scores (~ -1e30)."""
    acc = _acc_dtype(q)
    h = q.shape[2]
    k = attn_ops.repeat_kv(k, h // k.shape[2])
    v = attn_ops.repeat_kv(v, h // v.shape[2])
    s = torch.einsum("bthd,bshd->bhts", q.to(acc), k.to(acc)) * scale
    s = attn_ops.softcap(s, softcap)
    allowed = _allowed(q.shape[1], window, q.device, causal, q_offset)
    s = torch.where(allowed, s, torch.full((), attn_ops.NEG_INF, dtype=acc,
                                           device=q.device))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.where(allowed, torch.exp(s - lse[..., None]),
                    torch.zeros((), dtype=acc, device=q.device))
    out = torch.einsum("bhts,bshd->bthd", p, v.to(acc))
    return out.to(q.dtype), lse


def flash_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    window: Optional[int] = None, softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_lse_fwd_plain`` with the causal mask: what ``flash_fwd``
    computes."""
    return flash_lse_fwd_plain(q, k, v, scale=scale, window=window,
                               softcap=softcap)


def flash_lse_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor] = None,
    *, scale: float, causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None, q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_lse_fwd`` from its saved lse (B, H, T), with
    the TPU kernels' formulas: p = exp(s - lse) on allowed pairs, 0
    elsewhere; ds = p (dO V^T - delta) scale, times (1 - t^2) under
    soft-capping, with delta = rowsum(out dO) - dlse (the lse cotangent,
    (B, H, T), none = 0); dq = ds K, dk = ds^T Q and dv = p^T dO, dk/dv
    summed over each GQA group. Returns (dq, dk, dv) in the dtypes of q, k,
    v."""
    acc = _acc_dtype(q)
    b, t, h, hd = q.shape
    kv = k.shape[2]
    kf = attn_ops.repeat_kv(k, h // kv).to(acc)
    vf = attn_ops.repeat_kv(v, h // kv).to(acc)
    qf, dof = q.to(acc), do.to(acc)
    delta = flash_bwd_prep_plain(out, do, dlse)
    s = torch.einsum("bthd,bshd->bhts", qf, kf) * scale
    dfac = scale
    if softcap:
        tanh = torch.tanh(s / softcap)
        s = softcap * tanh
        dfac = scale * (1.0 - tanh * tanh)
    allowed = _allowed(t, window, q.device, causal, q_offset)
    p = torch.where(allowed, torch.exp(s - lse.to(acc)[..., None]),
                    torch.zeros((), dtype=acc, device=q.device))
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = p * (dp - delta[..., None]) * dfac
    dq = torch.einsum("bhts,bshd->bthd", ds, kf)
    dk = torch.einsum("bhts,bthd->bshd", ds, qf)
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    rep = h // kv
    dk = dk.reshape(b, t, kv, rep, hd).sum(3)
    dv = dv.reshape(b, t, kv, rep, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_prep_plain(
    out: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """What ``flash_bwd_prep`` computes, written plainly: delta =
    rowsum(out * dO) - dlse (B, H, T) from out and dO (B, T, H, hd), in
    float32 (float64 for float64 inputs), with the lse cotangent ``dlse``
    (B, H, T) or None (zero)."""
    acc = _acc_dtype(out)
    delta = (out.to(acc) * do.to(acc)).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.to(acc)
    return delta


def flash_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, scale: float,
    window: Optional[int] = None, softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``flash_lse_bwd_plain`` with the causal mask and no lse cotangent:
    what ``flash_bwd`` computes, with either setting of FLASH_FUSED_BWD, so
    the plain version of K2c (``flash_bwd_fused``) as well as of K2a +
    K2b."""
    return flash_lse_bwd_plain(q, k, v, out, lse, do, scale=scale,
                               window=window, softcap=softcap)


_PTR = ctypes.c_void_p
_I32 = ctypes.c_int
_STRIDES = [ctypes.c_longlong] * 9  # b/t/h strides of q, k, v
# scale, window, softcap, [causal, q_offset,] dtype, stream
_TAIL = [ctypes.c_float, _I32, ctypes.c_float, _I32, _PTR]
_LSE_TAIL = [ctypes.c_float, _I32, ctypes.c_float, _I32, _I32, _I32, _PTR]


def _attn_args(n_ptr: int, tail) -> list:
    """An attention entry point's arguments: ``n_ptr`` pointers, B, T, H,
    KV, hd, the strides, the tail."""
    return [_PTR] * n_ptr + [_I32] * 5 + _STRIDES + tail


# entry point: its ctypes argument types
_ENTRIES = {
    "flash_fwd": {"flash_fwd": _attn_args(5, _TAIL),  # q, k, v, out, lse
                  "flash_lse_fwd": _attn_args(5, _LSE_TAIL),
                  "nh_fwd": _attn_args(5, _TAIL)},
    "flash_bwd": {"flash_bwd_dq": _attn_args(7, _TAIL),  # q, k, v, do, lse, delta, dq
                  "flash_bwd_dkv": _attn_args(8, _TAIL),  # ... dk, dv
                  "flash_bwd_fused": _attn_args(9, _TAIL),  # ... dq (float32), dk, dv
                  "flash_lse_bwd_dq": _attn_args(7, _LSE_TAIL),
                  "flash_lse_bwd_dkv": _attn_args(8, _LSE_TAIL),
                  "nh_bwd_dq": _attn_args(7, _TAIL),
                  "nh_bwd_dkv": _attn_args(8, _TAIL),
                  # out, do, dlse, delta, dq; B, T, H, hd, dtype; stream
                  "flash_bwd_prep": [_PTR] * 5 + [_I32] * 5 + [_PTR]},
}


def library_name(name: str, dtype: torch.dtype) -> str:
    """The library (a ``csrc`` source) that holds ``name``'s kernels for
    ``dtype``: ``name`` itself, or its float16 build ``name_f16``."""
    return name + "_f16" if dtype == torch.float16 else name


def _kernel(name: str, dtype: torch.dtype) -> ctypes.CDLL:
    """The loaded library of ``name``'s ("flash_fwd", "flash_bwd") kernels
    for ``dtype``, its entry points typed."""
    lib = _build.load(library_name(name, dtype))
    for fn, argtypes in _ENTRIES[name].items():
        if dtype == torch.float16 and fn in _NOT_IN_F16:
            continue
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    return lib


def _qkv_strides(q, k, v):
    return [x.stride(i) for x in (q, k, v) for i in range(3)]


def _tail(q, scale, window, softcap, stream, lse_opts=None):
    """The entry point's trailing arguments; ``lse_opts`` = (causal,
    q_offset) for the flash_lse_* entry points."""
    head = [float(scale), 0 if window is None else int(window),
            0.0 if softcap is None else float(softcap)]
    opts = [] if lse_opts is None else [int(bool(lse_opts[0])), int(lse_opts[1])]
    return head + opts + [_DTYPE_CODES[q.dtype], stream]


def _check_lse_opts(window, q_offset) -> None:
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"q_offset must be an int >= 0, got {q_offset!r}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _check_cuda_inputs(q, k, v, name: str) -> None:
    """Refuse what the kernels do not take; ``name`` is the wrapper that
    was called."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            f"{name}: the kernel wrappers build no autograd graph: "
            "differentiate through causal_attention (FlashAttention), or call "
            "them under torch.no_grad()"
        )
    if not (k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k and v must be on the same device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{name} takes float32, bfloat16 or float16 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dtype == torch.float16 and name.startswith("nh_"):
        raise TypeError(f"{name} (the per-head-grid prototype, K5) takes float32 or "
                        "bfloat16, as its JAX tool does, not float16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, t, h, hd = q.shape
    if k.shape[0] != b or k.shape[1] != t or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    try:
        _, pad = head_plan(hd)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if t < 1:
        raise ValueError(f"{name}: empty sequence")
    if pad:
        return  # the wrapper reads a dense, aligned zero-padded copy
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{name} needs a dense last (head_dim) axis")
    if q.dtype in (torch.bfloat16, torch.float16) and not all(
            x.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in x.stride()[:3])
            for x in (q, k, v)):
        raise ValueError(f"{name} loads {q.dtype} rows with 16-byte TMA boxes: "
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
    out, lse = _launch_fwd("flash_fwd", q, k, v, scale, window, softcap)
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def _launch_fwd(fn_name, q, k, v, scale, window, softcap, lse_opts=None):
    if q.device.type != "cuda":
        raise ValueError(f"{fn_name} runs on cuda or cpu tensors, not {q.device}")
    _check_cuda_inputs(q, k, v, fn_name)
    _, pad = head_plan(q.shape[3])
    q, k, v = _padded(pad, q, k, v)
    b, t, h, hd = q.shape
    lib = _kernel("flash_fwd", q.dtype)
    out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn_name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, t, h, k.shape[2], hd, *_qkv_strides(q, k, v),
            *_tail(q, scale, window, softcap, stream, lse_opts),
        )
    if rc != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {rc}")
    return (*_true_width(pad, out), lse)


def flash_lse_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None, q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K3 kernel's wrapper: ``flash_fwd`` with a ``causal`` flag and a
    ``q_offset`` (query row i at key position q_offset + i). q (B, T, H,
    hd), k/v (B, T, KV, hd), any strides with a dense last axis -> (out
    (B, T, H, hd) dense in q's dtype, lse (B, H, T) float32).

    CPU tensors take ``flash_lse_fwd_plain``. CUDA tensors launch the kernel
    (counted in ``flash_lse_fwd.launches``) or raise.
    """
    _check_lse_opts(window, q_offset)
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_lse_fwd_plain(q, k, v, **kw)
    out, lse = _launch_fwd("flash_lse_fwd", q, k, v, scale, window, softcap,
                           (causal, q_offset))
    flash_lse_fwd.launches += 1
    return out, lse


flash_lse_fwd.launches = 0


def _dense(x: torch.Tensor) -> torch.Tensor:
    """x as a dense tensor whose rows start on 16-byte boundaries: autograd
    may hand the backward a strided or expanded (stride 0) gradient."""
    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _check_bwd_inputs(q, out, lse, do) -> None:
    b, t, h, _ = q.shape
    for name, x in (("out", out), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype} does not "
                             f"match q {tuple(q.shape)} {q.dtype}")
    if (lse.shape != (b, h, t) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"lse must be float32 (B, H, T) = {(b, h, t)}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")


def fused_bwd_enabled() -> bool:
    """Whether ``FLASH_FUSED_BWD=1`` is set now: the JAX package's switch
    for its fused backward, read at each call as ``_flash_bwd_btd`` reads
    it."""
    return os.environ.get("FLASH_FUSED_BWD", "0") == "1"


def _bwd_inputs(name, q, k, v, out, lse, do, dlse=None, dq=None):
    """Checked CUDA inputs of a backward wrapper at the kernel instance's
    width (``head_plan``: q, k, v, out and dO zero-padded where the true
    width has no instance of its own): (pad, q, k, v, dO dense with 16-byte
    rows, lse dense, delta = rowsum(out * dO) - dlse (B, H, T) float32 from
    ``flash_bwd_prep``, which also zeroes ``dq``, a float32 buffer of K2c's
    at the instance's width, where one is given)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {q.device}")
    _check_cuda_inputs(q, k, v, name)
    _check_bwd_inputs(q, out, lse, do)
    _, pad = head_plan(q.shape[3])
    q, k, v, out, do = _padded(pad, q, k, v, out, do)
    do = _dense(do)
    return pad, q, k, v, do, lse.contiguous(), flash_bwd_prep(out, do, dlse, dq=dq)


def _check_prep_inputs(out, do, dlse, dq) -> None:
    """Refuse what the prep kernel does not take."""
    if (out.dim() != 4 or do.shape != out.shape or do.dtype != out.dtype
            or do.device != out.device or out.dtype not in _DTYPE_CODES):
        raise ValueError(f"flash_bwd_prep takes out and do of one shape (B, T, H, hd) "
                         f"and dtype (float32, bfloat16 or float16), got {tuple(out.shape)} "
                         f"{out.dtype}, {tuple(do.shape)} {do.dtype}")
    b, t, h, hd = out.shape
    try:
        _, pad = head_plan(hd)
    except ValueError as e:
        raise ValueError(f"flash_bwd_prep: {e}") from None
    if dq is not None and pad:
        raise ValueError(f"flash_bwd_prep zeroes K2c's dq at a kernel instance's width "
                         f"{NATIVE_HEAD_DIMS}, not at head_dim {hd}")
    if dlse is not None and (dlse.shape != (b, h, t) or dlse.device != out.device):
        raise ValueError(f"dlse {tuple(dlse.shape)} does not match lse {(b, h, t)}")
    if dq is not None and (dq.dtype != torch.float32 or dq.shape != out.shape
                           or not dq.is_contiguous() or dq.device != out.device
                           or dq.data_ptr() % 16):
        raise ValueError(f"flash_bwd_prep zeroes a dense float32 {tuple(out.shape)} dq "
                         f"on a 16-byte boundary (float4 stores), got "
                         f"{tuple(dq.shape)} {dq.dtype} at {dq.data_ptr() % 16} past one")


def flash_bwd_prep(out: torch.Tensor, do: torch.Tensor,
                   dlse: Optional[torch.Tensor] = None, *,
                   dq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The prep kernel's wrapper: delta = rowsum(out * dO) - dlse (B, H, T)
    float32 from out and dO (B, T, H, hd) of one dtype, with the lse
    cotangent ``dlse`` (B, H, T) or None (zero); ``dq``, a dense float32
    buffer of out's shape (K2c's, at a width of ``NATIVE_HEAD_DIMS``), is
    zeroed in the same pass.

    CPU tensors take ``flash_bwd_prep_plain``. CUDA tensors launch the
    kernel (counted in ``flash_bwd_prep.launches``), on out and dO
    zero-padded to the instance's width where ``head_plan`` says so, or
    raise.
    """
    if out.device.type == "cpu":
        if dq is not None:
            dq.zero_()
        return flash_bwd_prep_plain(out, do, dlse)
    if out.device.type != "cuda":
        raise ValueError(f"flash_bwd_prep runs on cuda or cpu tensors, not {out.device}")
    _check_prep_inputs(out, do, dlse, dq)
    _, pad = head_plan(out.shape[3])
    out, do = _padded(pad, out, do)
    b, t, h, hd = out.shape
    if dlse is not None:
        dlse = dlse.float().contiguous()
    out, do = _dense(out), _dense(do)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=out.device)
    lib = _kernel("flash_bwd", out.dtype)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_bwd_prep(
            out.data_ptr(), do.data_ptr(), None if dlse is None else dlse.data_ptr(),
            delta.data_ptr(), None if dq is None else dq.data_ptr(), b, t, h, hd,
            _DTYPE_CODES[out.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_prep kernel launch failed: CUDA error {rc}")
    flash_bwd_prep.launches += 1
    return delta


flash_bwd_prep.launches = 0


def flash_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, scale: float,
    window: Optional[int] = None, softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' wrapper: the gradient of ``flash_fwd`` ->
    (dq (B, T, H, hd), dk, dv (B, T, KV, hd)) in the inputs' dtype.

    CPU tensors take ``flash_bwd_plain``. CUDA tensors launch the prep
    kernel (delta), the dq kernel and the dk/dv kernel (counted in
    ``flash_bwd_prep.launches``, ``flash_bwd.dq_launches`` and
    ``flash_bwd.dkv_launches``) or raise; with FLASH_FUSED_BWD=1 they go to
    ``flash_bwd_fused`` instead.
    """
    kw = dict(scale=scale, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, do, **kw)
    if fused_bwd_enabled():
        return flash_bwd_fused(q, k, v, out, lse, do, **kw)
    pad, q, k, v, do, lse, delta = _bwd_inputs("flash_bwd", q, k, v, out, lse, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return _true_width(pad, dq, dk, dv)


def flash_bwd_fused(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, scale: float,
    window: Optional[int] = None, softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused backward kernel's wrapper (K2c): ``flash_bwd``'s function
    in one launch of K2c. CPU tensors take ``flash_bwd_plain``. CUDA
    tensors get delta and a zeroed float32 dq buffer from one
    ``flash_bwd_prep`` launch, the kernel (``flash_bwd_dqkv``) and dq cast
    to q's dtype (a tensor op); a failed build or launch raises."""
    kw = dict(scale=scale, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, do, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_fused runs on cuda or cpu tensors, not {q.device}")
    inst, _ = head_plan(q.shape[3])
    dq = torch.empty((*q.shape[:3], inst), dtype=torch.float32, device=q.device)
    pad, q, k, v, do, lse, delta = _bwd_inputs("flash_bwd_fused", q, k, v, out, lse, do,
                                               dq=dq)
    dk, dv = flash_bwd_dqkv(q, k, v, do, lse, delta, dq, **kw)
    return _true_width(pad, dq.to(q.dtype), dk, dv)


def _launch_bwd(fn_name, outs, q, k, v, do, lse, delta, scale, window,
                softcap, lse_opts=None) -> None:
    b, t, h, hd = q.shape
    if hd not in NATIVE_HEAD_DIMS:
        raise ValueError(f"{fn_name} takes a kernel instance's width {NATIVE_HEAD_DIMS}, "
                         f"not {hd}: flash_bwd and flash_lse_bwd pad other widths")
    if q.dtype == torch.float16 and fn_name in _NOT_IN_F16:
        raise TypeError(f"{fn_name} (K5) has no float16 instance")
    lib = _kernel("flash_bwd", q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn_name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
            b, t, h, k.shape[2], hd, *_qkv_strides(q, k, v),
            *_tail(q, scale, window, softcap, stream, lse_opts))
    if rc != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {rc}")


def flash_bwd_dq(q, k, v, do, lse, delta, *, scale, window=None, softcap=None):
    """Launch the dq kernel (K2a) on checked CUDA inputs: dO dense
    (B, T, H, hd) with 16-byte rows, lse and delta dense (B, H, T) float32.
    Counted in ``flash_bwd.dq_launches``."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("flash_bwd_dq", (dq,), q, k, v, do, lse, delta, scale,
                window, softcap)
    flash_bwd.dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, scale, window=None, softcap=None):
    """Launch the dk/dv kernel (K2b) on the inputs ``flash_bwd_dq`` takes.
    Counted in ``flash_bwd.dkv_launches``."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    _launch_bwd("flash_bwd_dkv", (dk, dv), q, k, v, do, lse, delta, scale,
                window, softcap)
    flash_bwd.dkv_launches += 1
    return dk, dv


def flash_bwd_dqkv(q, k, v, do, lse, delta, dq, *, scale, window=None,
                   softcap=None):
    """Launch the fused kernel (K2c) on the inputs ``flash_bwd_dq`` takes:
    it adds dq to ``dq``, a dense float32 (B, T, H, hd) buffer (zeroed by
    ``flash_bwd_prep``), and returns (dk, dv). Counted in
    ``flash_bwd.fused_launches``."""
    if (dq.dtype != torch.float32 or dq.shape != q.shape or not dq.is_contiguous()
            or dq.data_ptr() % 8):
        raise ValueError(f"flash_bwd_dqkv adds into a dense float32 {tuple(q.shape)} "
                         f"dq on an 8-byte boundary (float2 atomics), got "
                         f"{tuple(dq.shape)} {dq.dtype} at {dq.data_ptr() % 8} past one")
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    _launch_bwd("flash_bwd_fused", (dq, dk, dv), q, k, v, do, lse, delta,
                scale, window, softcap)
    flash_bwd.fused_launches += 1
    return dk, dv


flash_bwd.dq_launches = 0
flash_bwd.dkv_launches = 0
flash_bwd.fused_launches = 0


def flash_lse_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor] = None,
    *, scale: float, causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None, q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The K4 kernels' wrapper: the gradient of ``flash_lse_fwd`` in both
    outputs -> (dq (B, T, H, hd), dk, dv (B, T, KV, hd)) in the inputs'
    dtype. ``dlse`` is the lse cotangent (B, H, T) or None (zero).

    delta' = rowsum(out * do) - dlse comes from ``flash_bwd_prep`` (the JAX
    ``_flash_bwd`` folds dlse into delta the same way). CPU tensors take
    ``flash_lse_bwd_plain``. CUDA tensors launch the dq kernel (K4a) and the
    dk/dv kernel (K4b), counted in ``flash_lse_bwd.dq_launches`` and
    ``flash_lse_bwd.dkv_launches``, or raise.
    """
    _check_lse_opts(window, q_offset)
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_lse_bwd_plain(q, k, v, out, lse, do, dlse, **kw)
    if dlse is not None and dlse.shape != lse.shape:
        raise ValueError(f"dlse {tuple(dlse.shape)} does not match lse "
                         f"{tuple(lse.shape)}")
    pad, q, k, v, do, lse, delta = _bwd_inputs("flash_lse_bwd", q, k, v, out, lse, do,
                                               dlse)
    dq = flash_lse_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_lse_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return _true_width(pad, dq, dk, dv)


def flash_lse_bwd_dq(q, k, v, do, lse, delta, *, scale, causal=True,
                     window=None, softcap=None, q_offset=0):
    """Launch the K4a dq kernel on the inputs ``flash_bwd_dq`` takes, delta
    already holding delta - dlse. Counted in
    ``flash_lse_bwd.dq_launches``."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("flash_lse_bwd_dq", (dq,), q, k, v, do, lse, delta, scale,
                window, softcap, (causal, q_offset))
    flash_lse_bwd.dq_launches += 1
    return dq


def flash_lse_bwd_dkv(q, k, v, do, lse, delta, *, scale, causal=True,
                      window=None, softcap=None, q_offset=0):
    """Launch the K4b dk/dv kernel on the inputs ``flash_lse_bwd_dq`` takes.
    Counted in ``flash_lse_bwd.dkv_launches``."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    _launch_bwd("flash_lse_bwd_dkv", (dk, dv), q, k, v, do, lse, delta, scale,
                window, softcap, (causal, q_offset))
    flash_lse_bwd.dkv_launches += 1
    return dk, dv


flash_lse_bwd.dq_launches = 0
flash_lse_bwd.dkv_launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable causal flash attention: ``flash_fwd`` forward, saving
    (q, k, v, out, lse); ``flash_bwd`` backward. The counterpart of the
    custom VJP around ``_flash_btd`` in the JAX package."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, window: Optional[int],
                softcap: Optional[float]):
        out, lse = flash_fwd(q, k, v, scale=scale, window=window,
                             softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attn = (scale, window, softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        scale, window, softcap = ctx.attn
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do, scale=scale,
                               window=window, softcap=softcap)
        return dq, dk, dv, None, None, None


class FlashLse(torch.autograd.Function):
    """Flash attention differentiable in both outputs (out, lse):
    ``flash_lse_fwd`` forward, saving (q, k, v, out, lse); ``flash_lse_bwd``
    backward with the lse cotangent folded into delta. The counterpart of
    the custom VJP of ``flash_with_lse`` in the JAX package."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool,
                window: Optional[int], softcap: Optional[float],
                q_offset: int):
        out, lse = flash_lse_fwd(q, k, v, scale=scale, causal=causal,
                                 window=window, softcap=softcap,
                                 q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attn = dict(scale=scale, causal=causal, window=window,
                        softcap=softcap, q_offset=q_offset)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        dq, dk, dv = flash_lse_bwd(q, k, v, out, lse, do, dlse, **ctx.attn)
        return dq, dk, dv, None, None, None, None, None


def attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None, q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``FlashLse`` in the model's layout: q (B, T, H, hd), k/v (B, T, KV,
    hd) -> (out (B, T, H, hd), lse (B, H, T) float32), both
    differentiable."""
    return FlashLse.apply(q, k, v, float(scale), bool(causal),
                          None if window is None else int(window),
                          None if softcap is None else float(softcap),
                          int(q_offset))


def flash_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None, q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, k, v) (BH, T, hd) -> (out (BH, T, hd), lse (BH, T, 1) float32),
    the JAX ``flash_with_lse``'s layout and arguments (less its TPU block
    size). Differentiable in both outputs. Rows with no live key under an
    offset band return out = 0 and lse <= -1e29: merge by lse."""
    bh, t, hd = q.shape
    out, lse = attention_with_lse(
        q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), scale=scale,
        causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    return out.squeeze(2), lse.reshape(bh, t, 1)


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
    kernels wherever the JAX package runs its flash kernels."""
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
    return FlashAttention.apply(
        q, k, v, 1.0 / math.sqrt(q.shape[3]),
        None if window is None else int(window),
        None if logit_softcap is None else float(logit_softcap),
    )
