"""Sequence-parallel (ring) attention over the flash kernels.

Counterpart of vqgan_tpu/ops/ring_attention.py. Q, K and V are split over
the sequence into n blocks; each Q block meets every K/V block as the K/V
blocks pass around the ring, and the partial results merge by the online
softmax rule, in fp32:

    lse = logaddexp(lse_acc, lse_blk)
    out = out_acc * e^(lse_acc - lse) + out_blk * e^(lse_blk - lse)

Non-causal attention only, as in JAX: the order of the K/V blocks does not
matter and nothing is masked.

The JAX ring computes each block with an einsum (its kernel lost to the
einsum under about 1k tokens on its chip). Here each block is the port's
flash kernels, as every CUDA attention is:
- forward: `flash_forward` (kernel #1, csrc/flash_fwd.cu) gives each
  block's (out, lse [B, H, S]);
- backward: with the merged LSE and delta = rowsum(dO * O) of the whole
  output, `flash_bwd_dq` (kernel #2) adds each block's share into dQ and
  `flash_bwd_dkv` (kernel #3) each Q block's share into that K/V block's
  dK/dV accumulator, which travels with its block and is home after n
  steps. Accumulators are fp32.
On CPU tensors the same calls take the kernels' plain versions.

Two forms share the step functions (`_forward_step`, `_backward_step`):
- `ring_attention_shards(q, k, v, n)`: one process runs the ring over n
  blocks of whole tensors (at step s, block i meets K/V block (i - s) mod
  n, as on a ring of n ranks);
- `ring_attention(q, k, v, mesh, axis="seq")`: each rank of the mesh axis
  holds its sequence blocks; K/V rotate rank i -> i + 1 with
  `batch_isend_irecv` (parallel/comm.py).
Both are differentiable (`torch.autograd.Function`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..parallel import comm
from .attention import flash_bwd_dkv, flash_bwd_dq, flash_delta, flash_forward

__all__ = ["attention_with_lse", "ring_attention", "ring_attention_shards"]


def attention_with_lse(q, k, v, scale: Optional[float] = None):
    """Softmax attention -> (out [B,S,H,D] in q's dtype, lse [B,H,S] fp32):
    the mergeable form of one block, from the flash forward."""
    return flash_forward(q, k, v, scale)


def _merge(out_a, lse_a, out_b, lse_b):
    """Online-softmax merge of two partial results, fp32."""
    lse = torch.logaddexp(lse_a, lse_b)
    wa = torch.exp(lse_a - lse).transpose(1, 2)[..., None]  # [B,Q,H,1]
    wb = torch.exp(lse_b - lse).transpose(1, 2)[..., None]
    return out_a * wa + out_b.float() * wb, lse


def _init(q):
    b, s, h, _ = q.shape
    return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full((b, h, s), -math.inf, dtype=torch.float32,
                       device=q.device))


def _forward_step(q, k, v, out, lse, scale):
    """Merge one K/V block's attention into (out, lse)."""
    out_b, lse_b = flash_forward(q, k, v, scale)
    return _merge(out, lse, out_b, lse_b)


def _backward_step(q, k, v, do, lse, delta, dq, dk, dv, scale):
    """Add one (Q block, K/V block) pair's gradients into the fp32
    accumulators dq, dk, dv."""
    dq.add_(flash_bwd_dq(q, k, v, do, lse, delta, scale).float())
    dk_b, dv_b = flash_bwd_dkv(q, k, v, do, lse, delta, scale)
    dk.add_(dk_b.float())
    dv.add_(dv_b.float())


def _check(q, k, n, axis):
    assert q.shape[1] % n == 0 and k.shape[1] % n == 0, (
        f"sequence lengths {q.shape[1]}/{k.shape[1]} must divide over "
        f"{n} '{axis}' shards")


def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


class _RingShards(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, n, scale):
        qs = [t.contiguous() for t in q.chunk(n, dim=1)]
        ks = [t.contiguous() for t in k.chunk(n, dim=1)]
        vs = [t.contiguous() for t in v.chunk(n, dim=1)]
        outs, lses = [], []
        for i in range(n):
            out, lse = _init(qs[i])
            for s in range(n):
                j = (i - s) % n
                out, lse = _forward_step(qs[i], ks[j], vs[j], out, lse, scale)
            outs.append(out.to(q.dtype))
            lses.append(lse)
        ctx.n, ctx.scale = n, scale
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        return torch.cat(outs, dim=1)

    @staticmethod
    def backward(ctx, do):
        n, scale = ctx.n, ctx.scale
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * n:(i + 1) * n] for i in range(5))
        dos = [t.contiguous() for t in do.chunk(n, dim=1)]
        deltas = [flash_delta(o, g) for o, g in zip(outs, dos)]
        dq = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
              for t in qs]
        dk = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
              for t in ks]
        dv = [torch.zeros_like(t) for t in dk]
        for s in range(n):
            for i in range(n):
                j = (i - s) % n
                _backward_step(qs[i], ks[j], vs[j], dos[i], lses[i],
                               deltas[i], dq[i], dk[j], dv[j], scale)
        return (torch.cat(dq, 1).to(qs[0].dtype),
                torch.cat(dk, 1).to(ks[0].dtype),
                torch.cat(dv, 1).to(vs[0].dtype), None, None)


def ring_attention_shards(q, k, v, n: int, scale: Optional[float] = None):
    """Attention of whole q [B, Sq, H, D] and k/v [B, Skv, H, D] computed
    as a ring over n sequence blocks in this process (n^2 launches of the
    forward kernel; n^2 of each backward kernel). Sq and Skv must each
    divide by n. Equals `sdpa_reference(q, k, v)` up to rounding."""
    _check(q, k, n, "seq")
    return _RingShards.apply(q, k, v, n, _scale(q, scale))


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        n = comm.group_size(group)
        perm = [(i, (i + 1) % n) for i in range(n)]
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _init(q)
        kb, vb = k, v
        for s in range(n):
            out, lse = _forward_step(q, kb, vb, out, lse, scale)
            if s < n - 1:
                kb, vb = comm.ppermute([kb, vb], perm, group)
        out = out.to(q.dtype)
        ctx.group, ctx.scale, ctx.perm, ctx.n = group, scale, perm, n
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_delta(out, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        kb, vb = k, v
        for s in range(ctx.n):
            _backward_step(q, kb, vb, do, lse, delta, dq, dk, dv, ctx.scale)
            # each block's accumulators travel with it: home after n hops
            moving = [dk, dv] if s == ctx.n - 1 else [kb, vb, dk, dv]
            moved = comm.ppermute(moving, ctx.perm, ctx.group)
            if s < ctx.n - 1:
                kb, vb, dk, dv = moved
            else:
                dk, dv = moved
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_attention(q, k, v, mesh, axis: str = "seq",
                   scale: Optional[float] = None):
    """Attention with Q, K and V split over the sequence on the mesh axis
    `axis`: q [B, Sq/n, H, D] and k/v [B, Skv/n, H, D] are this rank's
    blocks (block i on the axis's rank i); returns this rank's block of the
    output. Equals the matching rows of `sdpa_reference` of the whole
    sequences up to rounding."""
    n = mesh.shape[axis]
    if not mesh.distributed or n == 1:
        return _RingShards.apply(q, k, v, 1, _scale(q, scale))
    return _Ring.apply(q, k, v, mesh.group(axis), _scale(q, scale))
