"""Attention for the port: hand-written flash-attention kernels on CUDA
tensors (forward; backward as dQ and dK+dV), their plain PyTorch versions on
CPU tensors, both reached through the operators of `kernels/ops.py`.

Counterpart of vqgan_tpu/ops/attention.py. API layout is
[batch, seq, heads, head_dim] (BSHD), as there.

- `sdpa_reference`: plain softmax attention, fp32 accumulation, the
  probabilities cast to v's dtype before the second product (as the JAX
  reference does).
- `flash_forward_reference`, `flash_bwd_dq_reference`,
  `flash_bwd_dkv_reference`: the kernels' plain versions
  (`kernels/reference.py`), all math in fp32 like the kernels.
- `flash_forward`, `flash_bwd_dq`, `flash_bwd_dkv`: the operators
  `torch.ops.vqgan_tpu_torch.flash_*`, whose dispatcher takes the kernel for
  a CUDA tensor and the plain version for a CPU tensor; any other device
  raises. Training, generation and `torch.export` all take this one route.
- `FlashAttentionFunction`: the autograd wiring (the JAX package's
  `custom_vjp`): the forward saves (q, k, v, out, lse); the backward
  computes delta = rowsum(dO * O) in plain PyTorch, as the JAX package does
  outside its kernels, then dQ and dK/dV. P is recomputed from the LSE and
  never stored.
- `flash_attention` / `sdpa`: the entries the models call. Every call on a
  CUDA tensor goes through the kernels; there is no size threshold. Where
  no gradient is wanted (generation under `torch.inference_mode()`, an
  export), nothing is saved and no backward kernel runs.
"""

from __future__ import annotations

import torch

from ..kernels.ops import flash_bwd_dkv_op, flash_bwd_dq_op, flash_fwd_op
from ..kernels.reference import (
    default_scale,
    flash_bwd_dkv_reference,
    flash_bwd_dq_reference,
    flash_forward_reference,
)

__all__ = ["sdpa", "sdpa_reference", "flash_attention", "flash_forward",
           "flash_forward_reference", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_bwd_dq_reference", "flash_bwd_dkv_reference",
           "flash_delta", "FlashAttentionFunction"]


def check_device(name, t) -> None:
    """Raise unless `t` lies on a CUDA device (the kernel) or the CPU (the
    plain version)."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not "
                         f"{t.device}")


def sdpa_reference(q, k, v, scale: float | None = None):
    """Plain softmax attention, fp32 accumulation. [B, S, H, D] layout."""
    scale = default_scale(q, scale)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flash_forward(q, k, v, scale: float | None = None):
    """Flash-attention forward -> (out [B,Sq,H,D], lse [B,H,Sq] fp32):
    the kernel (csrc/flash_fwd.cu) for a CUDA tensor, the plain version for
    a CPU tensor."""
    check_device("flash_forward", q)
    return flash_fwd_op(q, k, v, default_scale(q, scale))


def flash_bwd_dq(q, k, v, do, lse, delta, scale: float | None = None):
    """dQ of flash attention: the kernel (csrc/flash_bwd_dq.cu) for a CUDA
    tensor, `flash_bwd_dq_reference` for a CPU tensor."""
    check_device("flash_bwd_dq", q)
    return flash_bwd_dq_op(q, k, v, do, lse, delta, default_scale(q, scale))


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float | None = None):
    """(dK, dV) of flash attention: the kernel (csrc/flash_bwd_dkv.cu) for
    a CUDA tensor, `flash_bwd_dkv_reference` for a CPU tensor."""
    check_device("flash_bwd_dkv", q)
    return flash_bwd_dkv_op(q, k, v, do, lse, delta,
                            default_scale(q, scale))


def flash_delta(out, do):
    """delta = rowsum(dO * O) in fp32, [B, H, Sq] contiguous."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its gradient: the forward kernel, then the dQ
    and dK/dV kernels, P recomputed from the saved LSE."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            # the cotangent of `from_heads` is a view whose head_dim axis is
            # strided; the kernels read other strides in place, not this one
            do = do.contiguous()
        delta = flash_delta(out, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: float | None = None):
    """Fused attention output, differentiable. [B, S, H, D] layout. Where no
    gradient is wanted it is the forward alone: nothing is saved."""
    scale = default_scale(q, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, scale)
    return flash_forward(q, k, v, scale)[0]


def sdpa(q, k, v, scale: float | None = None):
    """Attention dispatcher called by the models. Unlike the JAX package's
    `sdpa`, which keeps short sequences and wide heads off its kernel with
    thresholds tuned for another chip, every shape takes the flash path:
    the kernels on CUDA, their plain versions on CPU."""
    return flash_attention(q, k, v, scale)
