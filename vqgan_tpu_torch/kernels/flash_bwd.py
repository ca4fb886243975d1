"""ctypes bindings of the flash-attention backward kernels, both on the
tensor cores: dQ (`csrc/flash_bwd_dq.cu`) and dK with dV
(`csrc/flash_bwd_dkv.cu`).

`flash_bwd_dq` and `flash_bwd_dkv` take CUDA tensors in the BSHD layout and
launch on PyTorch's current stream. They raise on anything the kernels do not
take (a strided head_dim axis included: the caller makes dO contiguous where
it has to; also a row start that is not 16-byte aligned, which the entry
points refuse); they never fall back to another implementation.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel, raise_on_error
from .flash_fwd import DTYPE_NAMES, DTYPES, check_attention_inputs

__all__ = ["FLASH_BWD_DQ", "FLASH_BWD_DKV", "flash_bwd_dq", "flash_bwd_dkv"]

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_STRIDES = ctypes.c_int64 * 12
_COMMON = [_p] * 6                          # q, k, v, dO, lse, delta
FLASH_BWD_DQ = CudaKernel(
    "flash_bwd_dq.cu", "vq_flash_bwd_dq",
    [*_COMMON, _p,                          # dq
     _i, _i, _i, _i, _i,                    # B, H, Sq, Skv, D
     ctypes.POINTER(_i64),                  # strides of q, k, v, dO
     _i64, _i64, _i64,                      # strides of dq
     ctypes.c_float, _i, _p])               # scale, dtype, stream
FLASH_BWD_DKV = CudaKernel(
    "flash_bwd_dkv.cu", "vq_flash_bwd_dkv",
    [*_COMMON, _p, _p,                      # dk, dv
     _i, _i, _i, _i, _i,                    # B, H, Sq, Skv, D
     ctypes.POINTER(_i64),                  # strides of q, k, v, dO
     _i64, _i64, _i64, _i64, _i64, _i64,    # strides of dk, dv
     ctypes.c_float, _i, _p])               # scale, dtype, stream


def _check(name, q, k, v, do, lse, delta):
    b, s_q, s_kv, h, d = check_attention_inputs(name, q, k, v, do)
    for label, t in (("lse", lse), ("delta", delta)):
        if (t.device != q.device or t.dtype != torch.float32
                or t.shape != (b, h, s_q) or not t.is_contiguous()):
            raise ValueError(f"{name}: {label} must be a contiguous "
                             f"[{b}, {h}, {s_q}] float32 tensor on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    return b, s_q, s_kv, h, d


def _launch(kernel: CudaKernel, name: str, q, k, v, do, lse, delta,
            outputs, scale: float):
    """Launch `kernel` writing `outputs`; count it by (B, Sq, H, D, dtype)."""
    b, s_q, h, d = q.shape
    strides = _STRIDES(*(s for t in (q, k, v, do) for s in t.stride()[:3]))
    out_strides = [s for t in outputs for s in t.stride()[:3]]
    err = kernel.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outputs),
        b, h, s_q, k.shape[1], d, strides, *out_strides, float(scale),
        DTYPES[q.dtype])
    raise_on_error(name, err, q, k, v, do)
    kernel.count((b, s_q, h, d, DTYPE_NAMES[q.dtype]))


def flash_bwd_dq(q, k, v, do, lse, delta, scale: float) -> torch.Tensor:
    """q/dO [B, Sq, H, D], k/v [B, Skv, H, D] on one CUDA device, fp32 or
    bf16, last axis contiguous, row starts 16-byte aligned; lse and delta
    [B, H, Sq] fp32. Returns dq [B, Sq, H, D] in q's dtype."""
    b, s_q, _, h, d = _check("flash_bwd_dq", q, k, v, do, lse, delta)
    dq = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    _launch(FLASH_BWD_DQ, "flash_bwd_dq", q, k, v, do, lse, delta, [dq],
            scale)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float):
    """As `flash_bwd_dq`; returns (dk, dv), each [B, Skv, H, D] in the input
    dtype."""
    b, s_q, s_kv, h, d = _check("flash_bwd_dkv", q, k, v, do, lse, delta)
    dk = torch.empty((b, s_kv, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _launch(FLASH_BWD_DKV, "flash_bwd_dkv", q, k, v, do, lse, delta,
            [dk, dv], scale)
    return dk, dv
