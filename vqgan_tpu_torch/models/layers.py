"""Shared NCHW building blocks for the autoencoders and U-Nets.

Counterpart of vqgan_tpu/models/layers.py. Parameters are fp32; each layer
computes in its `dtype` (the JAX package's `dtype`, with
`param_dtype=float32`): convolutions and dense layers cast their input and
weights to it, norms compute in fp32 and return the input's dtype.
Parameter names are those of the reference PyTorch models, so their state
dicts load directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from ..parallel.mesh import batch_mesh, sum_over_data

__all__ = [
    "lecun_normal_init_",
    "BatchNorm",
    "Conv2d",
    "Linear",
    "GroupNorm",
    "RMSNorm",
    "ResnetBlock",
    "Dropout",
    "AttnBlock",
    "with_memory_tokens",
    "Downsample",
    "UpsampleTranspose",
    "UpsampleNearest",
]


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """Conv2d with fp32 parameters that computes in `dtype`."""

    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        d = self.compute_dtype
        return self._conv_forward(x.to(d), self.weight.to(d), _cast(self.bias, d))


class Linear(nn.Linear):
    """Linear with fp32 parameters that computes in `dtype`."""

    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), _cast(self.bias, d))


def lecun_normal_init_(module: nn.Module, generator=None) -> nn.Module:
    """flax's default initialisation of every Conv2d and Linear in
    `module`: weights from lecun_normal (a normal truncated at two standard
    deviations, scaled so that the variance is 1 / fan_in), zero biases."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)):
            std = (1.0 / m.weight[0].numel()) ** 0.5 / .87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module


class BatchNorm(nn.Module):
    """BatchNorm over NCHW channels with flax's semantics, which the JAX
    package holds: momentum 0.1 (flax 0.9), eps 1e-5, normalisation by the
    biased batch variance, and the running variance averaging that biased
    variance. torch's BatchNorm2d averages the unbiased one (n / (n - 1)),
    so it is not used. Train or eval mode follows `module.train()` /
    `.eval()`; computes in fp32.

    Inside `parallel.mesh.global_batch` on a mesh whose "data" axis has
    more than one rank, the train-mode statistics are the global batch's,
    as under the JAX package's jit over a batch placed P("data"): the
    per-channel sums of x and x^2 in fp32 summed over the ranks (their
    gradient too), then flax's E[x^2] - E[x]^2 clipped at 0; the running
    statistics follow the global values."""

    def __init__(self, channels: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        x = x.float()
        if self.training and batch_mesh() is not None:
            return self._global_batch_forward(x)
        if self.training:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * var)
            return F.batch_norm(x, None, None, self.weight, self.bias,
                                training=True, eps=self.eps)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=self.eps)

    def _global_batch_forward(self, x):
        n = x.numel() // x.shape[1] * batch_mesh().shape["data"]
        sums = sum_over_data(torch.stack([x.sum(dim=(0, 2, 3)),
                                          (x * x).sum(dim=(0, 2, 3))]))
        mean = sums[0] / n
        var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return ((x - mean[None, :, None, None]) * scale[None, :, None, None]
                + self.bias[None, :, None, None])


def group_count(channels: int, num_groups: int = 32) -> int:
    """32 groups, or fewer where the channels do not divide (small test
    configs), as in the JAX package."""
    groups = min(num_groups, channels)
    while channels % groups:
        groups -= 1
    return groups


class GroupNorm(nn.GroupNorm):
    """GroupNorm(32) with eps 1e-6 in fp32 math."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__(group_count(channels, num_groups), channels, eps=eps)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)


class RMSNorm(nn.Module):
    """Channel RMSNorm with a learned gain, fp32 math:
    x * rsqrt(sum(x^2) + 1e-12) * g * sqrt(C). The epsilon sits inside the
    root, unlike F.normalize's max(|x|, eps). `g` is [1, C, 1, 1] (with
    spatial_dims 2; [1, C, 1] over [B, C, L] with 1)."""

    def __init__(self, channels: int, spatial_dims: int = 2):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, channels, *((1,) * spatial_dims)))

    def forward(self, x):
        x32 = x.float()
        normed = x32 * torch.rsqrt((x32 * x32).sum(dim=1, keepdim=True) + 1e-12)
        return (normed * self.g * (x.shape[1] ** 0.5)).to(x.dtype)


class Dropout(nn.Module):
    """Dropout with the JAX package's switch: it runs only when the caller
    passes deterministic=False (flax's `nn.Dropout(deterministic=)`), never
    because the module is in train mode. The JAX package's trainers never
    pass it, so they train without dropout, and so do the port's. Where it
    runs it keeps each element with probability 1 - p and scales the kept
    ones by 1 / (1 - p), as flax does, with the mask drawn from `generator`
    (the default generator where None); JAX draws its mask from its own
    key, so the two agree in distribution only."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, deterministic: bool = True,
                generator: torch.Generator | None = None):
        if deterministic or self.p == 0.0:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class ResnetBlock(nn.Module):
    """GroupNorm, SiLU, conv3x3 twice, with a 1x1 shortcut when the channel
    count changes; with `dropout` > 0, a `Dropout` between the second SiLU
    and conv2 that runs only under deterministic=False."""

    def __init__(self, in_channels: int, out_channels: int | None = None,
                 dtype=torch.float32, dropout: float = 0.0):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = GroupNorm(in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1,
                            dtype=dtype)
        self.norm2 = GroupNorm(out_channels)
        self.dropout = Dropout(dropout) if dropout > 0.0 else None
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1,
                            dtype=dtype)
        self.nin_shortcut = (Conv2d(in_channels, out_channels, 1, dtype=dtype)
                             if in_channels != out_channels else None)

    def forward(self, x, deterministic: bool = True,
                generator: torch.Generator | None = None):
        h = self.conv1(F.silu(self.norm1(x)))
        h = F.silu(self.norm2(h))
        if self.dropout is not None:
            h = self.dropout(h, deterministic, generator)
        h = self.conv2(h)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


def to_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, heads*dh, H, W] -> [B, H*W, heads, dh] (BSHD, contiguous: the
    reshape alone can return a view whose head_dim axis is strided, which
    the flash kernel refuses)."""
    b, c, h, w = t.shape
    return t.permute(0, 2, 3, 1).reshape(b, h * w, heads, c // heads
                                         ).contiguous()


def from_heads(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H*W, heads, dh] -> [B, heads*dh, H, W]."""
    b = t.shape[0]
    return t.reshape(b, h, w, -1).permute(0, 3, 1, 2)


def with_memory_tokens(mem_kv: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor):
    """k, v [B, S, heads, dh] with the learned memory tokens (mem_kv
    [2, heads, M, dh]) in front: [B, M + S, heads, dh] each, new
    contiguous tensors in k's dtype."""
    b = k.shape[0]
    mk, mv = (m.transpose(0, 1)[None].expand(b, -1, -1, -1).to(k.dtype)
              for m in mem_kv)
    return torch.cat([mk, k], dim=1), torch.cat([mv, v], dim=1)


class AttnBlock(nn.Module):
    """Single-head self-attention over spatial positions with 1x1 q/k/v
    projections and a residual, through the port's `sdpa` (the flash
    kernel on CUDA)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.norm = GroupNorm(channels)
        self.q = Conv2d(channels, channels, 1, dtype=dtype)
        self.k = Conv2d(channels, channels, 1, dtype=dtype)
        self.v = Conv2d(channels, channels, 1, dtype=dtype)
        self.proj_out = Conv2d(channels, channels, 1, dtype=dtype)

    def forward(self, x):
        _, _, h, w = x.shape
        hn = self.norm(x)
        out = sdpa(to_heads(self.q(hn), 1), to_heads(self.k(hn), 1),
                   to_heads(self.v(hn), 1))
        return x + self.proj_out(from_heads(out, h, w))


class Downsample(Conv2d):
    """Stride-2 3x3 conv."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__(channels, channels, 3, stride=2, padding=1,
                         dtype=dtype)


class UpsampleTranspose(nn.ConvTranspose2d):
    """ConvTranspose k4 s2 p1: exact 2x upsampling. The JAX package's
    `ConvTranspose(padding="SAME")` holds the same taps spatially flipped."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__(channels, channels, 4, stride=2, padding=1)
        self.compute_dtype = dtype

    def forward(self, x):
        d = self.compute_dtype
        return F.conv_transpose2d(x.to(d), self.weight.to(d),
                                  self.bias.to(d), stride=2, padding=1)


class UpsampleNearest(nn.Sequential):
    """Nearest-neighbour 2x upsample, then a 3x3 conv (parameters at `.1`)."""

    def __init__(self, in_channels: int, out_channels: int | None = None,
                 dtype=torch.float32):
        super().__init__(
            nn.Upsample(scale_factor=2, mode="nearest"),
            Conv2d(in_channels, out_channels or in_channels, 3, padding=1,
                   dtype=dtype))
