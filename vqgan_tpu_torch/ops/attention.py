"""Attention for the port: hand-written flash-attention kernels on CUDA
tensors (forward; backward as dQ and dK+dV), their plain PyTorch versions on
CPU tensors.

Counterpart of vqgan_tpu/ops/attention.py. API layout is
[batch, seq, heads, head_dim] (BSHD), as there.

- `sdpa_reference`: plain softmax attention, fp32 accumulation, the
  probabilities cast to v's dtype before the second product (as the JAX
  reference does).
- `flash_forward_reference`, `flash_bwd_dq_reference`,
  `flash_bwd_dkv_reference`: the kernels' plain versions, all math in fp32
  like the kernels.
- `flash_forward`, `flash_bwd_dq`, `flash_bwd_dkv`: the kernel for a CUDA
  tensor, the plain version for a CPU tensor, an error otherwise.
- `FlashAttentionFunction`: the autograd wiring (the JAX package's
  `custom_vjp`): the forward saves (q, k, v, out, lse); the backward
  computes delta = rowsum(dO * O) in plain PyTorch, as the JAX package does
  outside its kernels, then dQ and dK/dV. P is recomputed from the LSE and
  never stored.
- `flash_attention` / `sdpa`: the entries the models call. Every call on a
  CUDA tensor goes through the kernels; there is no size threshold. Where
  no gradient is wanted (generation under `torch.inference_mode()`), nothing
  is saved and no backward kernel runs.
"""

from __future__ import annotations

import math

import torch

from ..kernels.flash_bwd import flash_bwd_dkv as _dkv_kernel
from ..kernels.flash_bwd import flash_bwd_dq as _dq_kernel
from ..kernels.flash_fwd import flash_fwd

__all__ = ["sdpa", "sdpa_reference", "flash_attention", "flash_forward",
           "flash_forward_reference", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_bwd_dq_reference", "flash_bwd_dkv_reference",
           "flash_delta", "FlashAttentionFunction"]


def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _on_kernel_device(name, t) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU tensor (the
    plain version); any other device raises."""
    if t.device.type in ("cuda", "cpu"):
        return t.device.type == "cuda"
    raise ValueError(f"{name} runs on CUDA or CPU tensors, not {t.device}")


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


def _probs_and_dscores(q, k, v, do, lse, delta, scale):
    """(scale * q, P, dS = P * (dP - delta)) in fp32; P [B,H,Sq,Skv] from the
    saved LSE."""
    qs = q.float() * scale
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
                  - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return qs, p, p * (dp - delta[..., None])


def flash_bwd_dq_reference(q, k, v, do, lse, delta,
                           scale: float | None = None):
    """What the dQ kernel computes, in plain PyTorch and fp32:
    dq = scale * [P * (dP - delta)] K, in q's dtype."""
    scale = _scale(q, scale)
    _, _, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                            scale: float | None = None):
    """What the dK/dV kernel computes, in plain PyTorch and fp32:
    (dk = [P * (dP - delta)]^T (scale * q), dv = P^T dO), in k's dtype."""
    scale = _scale(q, scale)
    qs, p, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_forward(q, k, v, scale: float | None = None):
    """Flash-attention forward -> (out [B,Sq,H,D], lse [B,H,Sq] fp32).

    A CUDA tensor goes to the hand-written kernel (csrc/flash_fwd.cu); a CPU
    tensor to `flash_forward_reference`."""
    scale = _scale(q, scale)
    if _on_kernel_device("flash_forward", q):
        return flash_fwd(q, k, v, scale)
    return flash_forward_reference(q, k, v, scale)


def flash_bwd_dq(q, k, v, do, lse, delta, scale: float | None = None):
    """dQ of flash attention: the kernel (csrc/flash_bwd_dq.cu) for a CUDA
    tensor, `flash_bwd_dq_reference` for a CPU tensor."""
    scale = _scale(q, scale)
    if _on_kernel_device("flash_bwd_dq", q):
        return _dq_kernel(q, k, v, do, lse, delta, scale)
    return flash_bwd_dq_reference(q, k, v, do, lse, delta, scale)


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float | None = None):
    """(dK, dV) of flash attention: the kernel (csrc/flash_bwd_dkv.cu) for
    a CUDA tensor, `flash_bwd_dkv_reference` for a CPU tensor."""
    scale = _scale(q, scale)
    if _on_kernel_device("flash_bwd_dkv", q):
        return _dkv_kernel(q, k, v, do, lse, delta, scale)
    return flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale)


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
    scale = _scale(q, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, scale)
    return flash_forward(q, k, v, scale)[0]


def sdpa(q, k, v, scale: float | None = None):
    """Attention dispatcher called by the models. Unlike the JAX package's
    `sdpa`, which keeps short sequences and wide heads off its kernel with
    thresholds tuned for another chip, every shape takes the flash path:
    the kernels on CUDA, their plain versions on CPU."""
    return flash_attention(q, k, v, scale)
