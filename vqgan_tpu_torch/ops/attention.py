"""Attention for the port: the hand-written flash-attention forward kernel on
CUDA tensors, its plain PyTorch version on CPU tensors.

Counterpart of vqgan_tpu/ops/attention.py. API layout is
[batch, seq, heads, head_dim] (BSHD), as there.

- `sdpa_reference`: plain softmax attention, fp32 accumulation, the
  probabilities cast to v's dtype before the second product (as the JAX
  reference does).
- `flash_forward_reference`: the kernel's plain version; returns (out, lse)
  computed entirely in fp32 like the kernel.
- `flash_forward` / `flash_attention`: the kernel for a CUDA tensor, the
  plain version for a CPU tensor, an error otherwise.
- `sdpa`: the entry the models call. Every call on a CUDA tensor goes
  through the kernel; there is no size threshold.

Forward only: generation needs no gradient, and the backward kernels come
with the training slice.
"""

from __future__ import annotations

import math

import torch

from ..kernels.flash_fwd import flash_fwd

__all__ = ["sdpa", "sdpa_reference", "flash_attention", "flash_forward",
           "flash_forward_reference"]

def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def sdpa_reference(q, k, v, scale: float | None = None):
    """Plain softmax attention, fp32 accumulation. [B, S, H, D] layout."""
    scale = _scale(q, scale)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flash_forward_reference(q, k, v, scale: float | None = None):
    """What the kernel computes, in plain PyTorch: (out [B,Sq,H,D] in q's
    dtype, lse [B,H,Sq] fp32), all math in fp32 with the kernel's 1e-30
    floor on the row sum."""
    scale = _scale(q, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out.to(q.dtype), lse


def flash_forward(q, k, v, scale: float | None = None):
    """Flash-attention forward → (out [B,Sq,H,D], lse [B,H,Sq] fp32).

    A CUDA tensor goes to the hand-written kernel (csrc/flash_fwd.cu); a CPU
    tensor to `flash_forward_reference`."""
    scale = _scale(q, scale)
    if q.device.type == "cuda":
        return flash_fwd(q, k, v, scale)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, scale)
    raise ValueError(f"flash_forward runs on CUDA or CPU tensors, "
                     f"not {q.device}")


def flash_attention(q, k, v, scale: float | None = None):
    """Fused attention output. [B, S, H, D] layout."""
    return flash_forward(q, k, v, scale)[0]


def sdpa(q, k, v, scale: float | None = None):
    """Attention dispatcher called by the models. Unlike the JAX package's
    `sdpa`, which keeps short sequences and wide heads off its kernel with
    thresholds tuned for another chip, every shape takes the flash path:
    the kernel on CUDA, its plain version on CPU."""
    return flash_attention(q, k, v, scale)
