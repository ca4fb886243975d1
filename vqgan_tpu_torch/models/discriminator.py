"""PatchGAN discriminator for adversarial VQ-GAN training.

Counterpart of vqgan_tpu/models/discriminator.py, NCHW: Conv(k4 s2) +
LeakyReLU(0.2) with channels doubling up to 8x, a stride-1 penultimate
conv, and 1-channel patch logits. The layers sit in the reference's
`main` Sequential: conv_0 at 0, conv_n at 3n - 1 with its norm at 3n, the
output conv at 3 * n_layers + 2; reference state dicts load directly.
Convolutions compute in `dtype`; norms and the output conv in fp32.

Norms (`norm`):
- "batch": `BatchNorm` (models/layers.py, shared with the ResNet), flax's
  BatchNorm semantics, which the JAX package holds. In a step on a mesh
  its statistics are the global batch's: the JAX module's docstring says
  they stay per device, but its trainer jits one program over the batch
  placed P("data"), where GSPMD takes the mean over the global batch.
- "act": `ActNorm`, an affine whose scale and shift live in buffers, set
  from the first batch only when called with init_actnorm=True (the
  discriminator never asks, as in the JAX package).
- "group": GroupNorm with one channel per group, eps 1e-6.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import batch_mesh, sum_over_data
from .layers import BatchNorm, Conv2d

__all__ = ["BatchNorm", "ActNorm", "PatchGANDiscriminator",
           "MultiScaleDiscriminator"]


class ActNorm(nn.Module):
    """Per-channel affine x * weight + bias with data-dependent
    initialisation from the first batch passed with init_actnorm=True
    (bias = -mean, weight = 1 / (std + 1e-6)), chosen by `torch.where` on
    the `initialized` flag on the device. The three values are buffers,
    not trained, as the JAX package's 'actnorm_stats' collection. Inside
    `parallel.mesh.global_batch` on a mesh, the mean and std are the global
    batch's, as jnp.mean / jnp.std give them under the JAX package's jit:
    the sum of x over the ranks, then that of (x - mean)^2."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("initialized", torch.zeros((), dtype=torch.int32))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("weight", torch.ones(channels))

    def forward(self, x, init_actnorm: bool = False):
        if init_actnorm:
            # decided on the device, as JAX's jnp.where: no host read, so
            # a CUDA graph holds it
            with torch.no_grad():
                std, mean = _batch_std_mean(x.float())
                do_init = self.initialized == 0
                self.bias.copy_(torch.where(do_init, -mean, self.bias))
                self.weight.copy_(torch.where(do_init, 1.0 / (std + 1e-6),
                                              self.weight))
                self.initialized.fill_(1)
        return x * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


def _batch_std_mean(x):
    """(std, mean) per channel of NCHW `x`, biased, over the batch: this
    rank's, or inside `global_batch` the global batch's in two passes."""
    mesh = batch_mesh()
    if mesh is None:
        return torch.std_mean(x, dim=(0, 2, 3), unbiased=False)
    n = x.numel() // x.shape[1] * mesh.shape["data"]
    mean = sum_over_data(x.sum(dim=(0, 2, 3))) / n
    var = sum_over_data(((x - mean[None, :, None, None]) ** 2).sum(
        dim=(0, 2, 3))) / n
    return var.sqrt(), mean


class _GroupNorm(nn.GroupNorm):
    """One channel per group, eps 1e-6, fp32 math and output."""

    def __init__(self, channels: int):
        super().__init__(channels, channels, eps=1e-6)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps)


def _norm(kind: str, channels: int) -> nn.Module:
    if kind == "batch":
        return BatchNorm(channels)
    if kind == "act":
        return ActNorm(channels)
    if kind == "group":
        return _GroupNorm(channels)
    raise ValueError(f"unknown norm kind {kind!r}")


class PatchGANDiscriminator(nn.Module):
    """NCHW images -> NCHW patch logits [B, 1, h, w] in fp32."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 norm: str = "batch", dtype=torch.float32):
        super().__init__()
        layers: List[nn.Module] = [
            Conv2d(input_nc, ndf, 4, stride=2, padding=1, dtype=dtype),
            nn.LeakyReLU(0.2)]
        nf_mult = 1
        for n in range(1, n_layers + 1):
            nf_prev, nf_mult = nf_mult, min(2**n, 8)
            layers += [
                Conv2d(ndf * nf_prev, ndf * nf_mult, 4,
                       stride=2 if n < n_layers else 1, padding=1,
                       bias=False, dtype=dtype),
                _norm(norm, ndf * nf_mult),
                nn.LeakyReLU(0.2)]
        layers.append(Conv2d(ndf * nf_mult, 1, 4, stride=1, padding=1,
                             dtype=torch.float32))
        self.main = nn.Sequential(*layers)

    def forward(self, x):
        return self.main(x)


def _avg_pool_same(x, k: int = 3, s: int = 2):
    """flax avg_pool(k, s, padding="SAME"): zero padding split low/high as
    XLA's SAME (the extra pad on the high side), padding counted."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):  # F.pad order: W then H
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.avg_pool2d(F.pad(x, pads), k, stride=s)


class MultiScaleDiscriminator(nn.Module):
    """`num_scales` PatchGANs (`scales.{i}`) at successive 2x average-pool
    downsamplings; returns their logits as a list."""

    def __init__(self, num_scales: int = 2, input_nc: int = 3, ndf: int = 64,
                 n_layers: int = 3, norm: str = "batch", dtype=torch.float32):
        super().__init__()
        self.scales = nn.ModuleList(
            PatchGANDiscriminator(input_nc, ndf, n_layers, norm, dtype)
            for _ in range(num_scales))

    def forward(self, x):
        outs = []
        for i, disc in enumerate(self.scales):
            outs.append(disc(x))
            if i != len(self.scales) - 1:
                x = _avg_pool_same(x)
        return outs
