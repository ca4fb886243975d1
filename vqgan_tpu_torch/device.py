"""Device selection and float precision for the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "set_full_fp32_precision"]


def resolve_device(device="cuda") -> torch.device:
    """The device to run on. The default is the GPU; a missing GPU raises
    rather than falling back to the CPU, which runs only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def set_full_fp32_precision() -> None:
    """fp32 matmuls and convolutions in full fp32, no TF32: the JAX package is
    held to "highest" matmul precision, and the port matches it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
