"""Classifier-free guidance combination math.

Counterpart of vqgan_tpu/core/guidance.py: standard CFG with the component
parallel to the conditional prediction removed, and rescaled-phi
interpolation (arXiv 2305.08891). The projection runs in fp32.
"""

from __future__ import annotations

import torch

__all__ = ["project", "apply_cfg"]


def project(x: torch.Tensor, y: torch.Tensor):
    """Decompose x into (parallel, orthogonal) components with respect to y,
    per batch element, over all non-batch dims."""
    b = x.shape[0]
    xf = x.reshape(b, -1).float()
    yf = y.reshape(b, -1).float()
    unit = yf / torch.clamp(torch.linalg.norm(yf, dim=-1, keepdim=True),
                            min=1e-12)
    parallel = (xf * unit).sum(dim=-1, keepdim=True) * unit
    orthogonal = xf - parallel
    return (parallel.reshape(x.shape).to(x.dtype),
            orthogonal.reshape(x.shape).to(x.dtype))


def apply_cfg(logits, null_logits, cond_scale: float,
              rescaled_phi: float = 0.0,
              remove_parallel_component: bool = True,
              keep_parallel_frac: float = 0.0):
    """scaled = cond + (cond_scale - 1) * update, with update = cond - null
    (its part parallel to cond optionally removed); then optionally rescaled
    to the conditional prediction's per-sample std and interpolated by
    `rescaled_phi`."""
    update = logits - null_logits
    if remove_parallel_component:
        parallel, orthog = project(update, logits)
        update = orthog + parallel * keep_parallel_frac

    scaled = logits + update * (cond_scale - 1.0)
    if rescaled_phi == 0.0:
        return scaled

    dims = tuple(range(1, scaled.ndim))
    # unbiased (ddof=1), as torch.std and the JAX package
    std_logits = torch.std(logits, dim=dims, keepdim=True, correction=1)
    std_scaled = torch.std(scaled, dim=dims, keepdim=True, correction=1)
    rescaled = scaled * (std_logits / torch.clamp(std_scaled, min=1e-12))
    return rescaled * rescaled_phi + scaled * (1.0 - rescaled_phi)
