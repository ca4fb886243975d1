"""ctypes binding of `csrc/flash_fwd.cu`, the flash-attention forward kernel.

`flash_fwd` takes CUDA tensors in the BSHD layout and launches the kernel on
PyTorch's current stream. It raises on anything the kernel does not take (a
strided head_dim axis, a row start that is not 16-byte aligned); it never
falls back to another implementation.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel, raise_on_error

__all__ = ["FLASH_FWD", "flash_fwd", "check_attention_inputs",
           "MAX_HEAD_DIM", "DTYPES", "DTYPE_NAMES"]

MAX_HEAD_DIM = 512
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_MAX_GRID_Y = 65535

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
FLASH_FWD = CudaKernel(
    "flash_fwd.cu", "vq_flash_fwd",
    [_p, _p, _p, _p, _p,              # q, k, v, o, lse
     _i, _i, _i, _i, _i,              # B, H, Sq, Skv, D
     *([_i64] * 12),                  # (batch, seq, head) strides of q, k, v, o
     ctypes.c_float, _i, _p])         # scale, dtype, stream


def check_attention_inputs(name: str, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *more: torch.Tensor):
    """Raise unless q [B, Sq, H, D] and k/v [B, Skv, H, D] (and `more`
    tensors shaped like q) lie on one CUDA device in one dtype the kernels
    take, with a head_dim the kernels take and a contiguous last axis.
    Returns (B, Sq, Skv, H, D)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {q.device}")
    if any(t.device != q.device for t in (k, v, *more)):
        raise ValueError(f"{name}: every input must lie on one device")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in (k, v, *more)):
        raise TypeError(f"{name} takes float32 or bfloat16 inputs of one "
                        f"dtype, got {[str(t.dtype) for t in (q, k, v, *more)]}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k and v must be [batch, seq, heads, head_dim]")
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    if (k.shape != (b, s_kv, h, d) or v.shape != k.shape
            or any(t.shape != q.shape for t in more)):
        raise ValueError(f"{name}: shape mismatch, q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, others "
                         f"{[tuple(t.shape) for t in more]}")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 8 in [8, "
                         f"{MAX_HEAD_DIM}], got {d}")
    if s_q < 1 or s_kv < 1 or b * h > _MAX_GRID_Y:
        raise ValueError(f"unsupported sizes: B*H={b * h}, Sq={s_q}, "
                         f"Skv={s_kv}")
    if any(t.stride(-1) != 1 for t in (q, k, v, *more)):
        raise ValueError(f"{name}: the head_dim axis of every input must be "
                         f"contiguous")
    return b, s_q, s_kv, h, d


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float):
    """q [B, Sq, H, D], k/v [B, Skv, H, D] on one CUDA device, fp32 or bf16,
    last axis contiguous, row starts 16-byte aligned. Returns (out
    [B, Sq, H, D] in q's dtype, lse [B, H, Sq] fp32)."""
    b, s_q, s_kv, h, d = check_attention_inputs("flash_fwd", q, k, v)

    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    err = FLASH_FWD.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, s_q, s_kv, d, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], float(scale),
        DTYPES[q.dtype])
    raise_on_error("flash_fwd", err, q, k, v)
    FLASH_FWD.count((b, s_q, h, d, DTYPE_NAMES[q.dtype]))
    return out, lse
