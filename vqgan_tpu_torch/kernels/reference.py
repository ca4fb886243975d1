"""The kernels' plain PyTorch versions: what each hand-written kernel
computes, all math in fp32 like the kernels. They are the CPU
implementations of the operators in `ops.py` and the references the tests
and `chip_smoke.py` hold the kernels against. `ops/attention.py` and
`ops/vq.py` export them under the same names.
"""

from __future__ import annotations

import math

import torch

__all__ = ["default_scale", "flash_forward_reference",
           "flash_bwd_dq_reference", "flash_bwd_dkv_reference",
           "vq_scores", "vq_lookup_reference", "codebook_usage"]


def default_scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def flash_forward_reference(q, k, v, scale: float | None = None):
    """What the kernel computes, in plain PyTorch: (out [B,Sq,H,D] in q's
    dtype, lse [B,H,Sq] fp32), all math in fp32 with the kernel's 1e-30
    floor on the row sum."""
    scale = default_scale(q, scale)
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
    scale = default_scale(q, scale)
    _, _, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                            scale: float | None = None):
    """What the dK/dV kernel computes, in plain PyTorch and fp32:
    (dk = [P * (dP - delta)]^T (scale * q), dv = P^T dO), in k's dtype."""
    scale = default_scale(q, scale)
    qs, p, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    return dk.to(k.dtype), dv.to(v.dtype)


def vq_scores(z, codebook, mode: str = "fp32"):
    """[N, K] fp32 scores of the plain version, whose row argmin is the
    nearest code."""
    z32, e32 = z.float(), codebook.float()
    e_sq = (e32 * e32).sum(1)
    if mode == "bf16":
        cross = (z32.to(torch.bfloat16).float()
                 @ e32.to(torch.bfloat16).float().T)
        return e_sq - 2.0 * cross
    return ((z32 * z32).sum(1, keepdim=True) + e_sq) - 2.0 * (z32 @ e32.T)


def vq_lookup_reference(z, codebook, mode: str = "fp32"):
    """What the kernel computes, in plain PyTorch: (z_q [N, D] in the
    codebook's dtype, indices [N] int32), ties to the lowest index."""
    if mode not in ("fp32", "bf16"):
        raise ValueError(f"mode must be 'fp32' or 'bf16', got {mode!r}")
    idx = torch.argmin(vq_scores(z, codebook, mode), dim=1).to(torch.int32)
    return codebook.index_select(0, idx), idx


def codebook_usage(indices, num_embeddings: int):
    """Per-code use counts [K] int32 (a bincount of fixed length)."""
    return torch.bincount(indices.reshape(-1).long(),
                          minlength=num_embeddings).to(torch.int32)
