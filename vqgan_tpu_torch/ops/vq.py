"""Vector-quantization lookup for the port: a hand-written nearest-code
kernel on CUDA tensors, its plain PyTorch version on CPU tensors, both
reached through the operator `torch.ops.vqgan_tpu_torch.vq_nearest`
(`kernels/ops.py`).

Counterpart of vqgan_tpu/ops/vq.py. z is [N, D] and the codebook [K, D].

- `vq_lookup_reference`: the plain version (`kernels/reference.py`),
  (z_q, indices int32), in either of the kernel's modes. "fp32" scores
  (|z|^2 + |e|^2) - 2 z.e exactly as the JAX package's plain version;
  "bf16" scores |e|^2 - 2 z.e with the cross term over bf16-rounded
  inputs, as its fast kernel.
- `vq_nearest_indices`: (indices, usage [K] int32) from the operator: the
  kernel (csrc/vq.cu, usage counted in the kernel) for a CUDA tensor, the
  plain version and `codebook_usage` for a CPU tensor, an error otherwise.
- `vq_lookup`: the differentiable op the quantizer calls, with the JAX
  package's custom VJP: zero gradient to z, the cotangent of z_q
  scatter-added (`index_add_`) into the selected codebook rows. The JAX
  package has no backward kernel, so neither has the port. The gather
  z_q = E[idx] stays outside the kernel (`index_select`), as in JAX.
  `use_kernel` "auto" and "fp32" take the exact mode, True the bf16 mode.
  The JAX package's TPU dispatch thresholds are not carried over. "auto"
  stays exact: it picks the codes the CPU picks, and at the VQ-GAN's
  [8192,256]x[128,256] it takes 0.0175 ms of device time against 0.0123
  for the bf16 mode and 0.0461 for addmm + argmin + index_select; at
  K = 8192, 0.694 / 0.201 / 1.385 ms (CUDA graphs, chip_smoke.py, NVIDIA
  H100 80GB HBM3, 700.00 W): 0.017 ms of a 115 ms G step either way.
- `codebook_usage`, `revive_dead_codes`: the non-kernel parts of the JAX
  module that the trainer uses.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.ops import vq_nearest_op
from ..kernels.reference import codebook_usage, vq_lookup_reference, vq_scores
from .attention import check_device

__all__ = ["vq_lookup", "vq_lookup_reference", "vq_nearest_indices",
           "codebook_usage", "revive_dead_codes", "vq_scores",
           "VQLookupFunction"]

_MODES = {"auto": "fp32", "fp32": "fp32", True: "bf16"}


def vq_nearest_indices(z, codebook, mode: str = "fp32"):
    """(indices [N] int32, usage [K] int32): the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    check_device("vq_lookup", z)
    return vq_nearest_op(z, codebook, mode)


class VQLookupFunction(torch.autograd.Function):
    """z_q = codebook[nearest(z)]: gradient to the codebook only."""

    @staticmethod
    def forward(ctx, z, codebook, mode):
        idx, usage = vq_nearest_indices(z, codebook, mode)
        ctx.mark_non_differentiable(idx, usage)
        ctx.save_for_backward(idx)
        ctx.codebook_shape = codebook.shape
        return codebook.index_select(0, idx), idx, usage

    @staticmethod
    def backward(ctx, g_zq, _g_idx, _g_usage):
        (idx,) = ctx.saved_tensors
        g_codebook = None
        if ctx.needs_input_grad[1]:
            g_codebook = torch.zeros(ctx.codebook_shape, dtype=g_zq.dtype,
                                     device=g_zq.device).index_add_(0, idx, g_zq)
        return None, g_codebook, None  # no gradient to z (None means zero)


def vq_lookup(z, codebook, use_kernel="auto"):
    """Nearest-codebook lookup. z [N, D], codebook [K, D]. Returns (z_q
    [N, D], indices [N] int32, usage [K] int32); z_q carries gradient to
    the codebook only, so compose the straight-through estimator outside.
    use_kernel: "auto" or "fp32" (exact scores) or True (bf16 cross term);
    the plain version is `vq_lookup_reference`."""
    if use_kernel not in _MODES:
        raise ValueError(f"use_kernel must be 'auto', 'fp32' or True, got "
                         f"{use_kernel!r}")
    return VQLookupFunction.apply(z, codebook, _MODES[use_kernel])


def revive_dead_codes(codebook, usage_counts, z, generator:
                      Optional[torch.Generator] = None, threshold: int = 1):
    """Re-anchor under-used codes to random encoder outputs: every code whose
    accumulated usage is below `threshold` becomes a row of z drawn
    uniformly (from `generator`). z: [..., D] pre-quant features. Returns
    (new codebook, number revived (0-d tensor), dead mask [K] bool)."""
    k, d = codebook.shape
    z2 = z.reshape(-1, z.shape[-1]).to(codebook.dtype)
    if z2.shape[-1] != d:
        raise ValueError(f"z rows have {z2.shape[-1]} features, the codebook "
                         f"{d}")
    dead = usage_counts < threshold
    rows = torch.randint(0, z2.shape[0], (k,), generator=generator,
                         device=z2.device)
    new_codebook = torch.where(dead[:, None], z2.index_select(0, rows),
                               codebook)
    return new_codebook, dead.sum(), dead
