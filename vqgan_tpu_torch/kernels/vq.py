"""ctypes binding of `csrc/vq.cu`, the nearest-codebook kernel.

`vq_nearest` takes CUDA tensors and launches the kernel on PyTorch's current
stream. It raises on anything the kernel does not take; it never falls back
to another implementation.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import CudaKernel, raise_on_error

__all__ = ["VQ_NEAREST", "vq_nearest", "staged", "MODES", "DTYPES"]

MODES = {"fp32": 0, "bf16": 1}
# the kernel's operand type in each mode
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
_MAX_ROWS = 2**31 - 64

_p, _i = ctypes.c_void_p, ctypes.c_int
VQ_NEAREST = CudaKernel(
    "vq.cu", "vq_nearest",
    [_p, _p, _p, _p, _p,     # z, codebook, e_sq, idx, usage
     _i, _i, _i, _i, _p])    # N, K, D, mode, stream


def staged(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x [R, C] as the kernel reads it: `dtype`, contiguous, each row a
    multiple of 16 bytes (zero columns appended) and starting on 16 bytes.
    Zero columns add exactly 0 to every dot product and every norm. x
    itself when it is so already."""
    y = x.to(dtype)
    pad = -y.shape[1] % (16 // dtype.itemsize)
    if pad:
        return F.pad(y, (0, pad))
    if y.is_contiguous() and y.data_ptr() % 16 == 0:
        return y
    return y.clone(memory_format=torch.contiguous_format)


def vq_nearest(z: torch.Tensor, codebook: torch.Tensor, e_sq: torch.Tensor,
               mode: str = "fp32"):
    """z [N, D], codebook [K, D] and e_sq [K] (|e|^2 per code): float32 on
    one CUDA device. Returns (idx [N] int32, usage [K] int32, the per-code
    count of idx). `mode` "fp32" scores (|z|^2 + |e|^2) - 2 z.e exactly;
    "bf16" scores |e|^2 - 2 z.e with the cross term over bf16-rounded
    inputs (z and the codebook are cast to bf16 before the launch)."""
    if z.device.type != "cuda":
        raise ValueError(f"vq_nearest needs CUDA tensors, got {z.device}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    for name, t, ndim in (("z", z, 2), ("codebook", codebook, 2),
                          ("e_sq", e_sq, 1)):
        if (t.device != z.device or t.dtype != torch.float32
                or t.ndim != ndim):
            raise ValueError(f"vq_nearest: {name} must be a {ndim}-D "
                             f"float32 tensor on {z.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    n, d = z.shape
    k = codebook.shape[0]
    if codebook.shape[1] != d or e_sq.shape != (k,):
        raise ValueError(f"vq_nearest: shape mismatch, z {tuple(z.shape)}, "
                         f"codebook {tuple(codebook.shape)}, e_sq "
                         f"{tuple(e_sq.shape)}")
    if not (1 <= n <= _MAX_ROWS and 1 <= k < 2**31 and d >= 1):
        raise ValueError(f"vq_nearest: unsupported sizes N={n}, K={k}, D={d}")

    zs, es = staged(z, DTYPES[mode]), staged(codebook, DTYPES[mode])
    e_sq = e_sq.contiguous()
    idx = torch.empty((n,), dtype=torch.int32, device=z.device)
    usage = torch.zeros((k,), dtype=torch.int32, device=z.device)
    err = VQ_NEAREST.launch(z.device, zs.data_ptr(), es.data_ptr(),
                            e_sq.data_ptr(), idx.data_ptr(),
                            usage.data_ptr(), n, k, zs.shape[1], MODES[mode])
    raise_on_error("vq_nearest", err, zs, es)
    VQ_NEAREST.count((n, k, d, mode))
    return idx, usage
