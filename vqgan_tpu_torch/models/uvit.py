"""UViT: a convolutional U-Net with a ViT middle (simple diffusion, arXiv
2301.11093).

Counterpart of vqgan_tpu/models/uvit.py, NCHW inside. ResNet blocks of its
own (conv, RMSNorm, time FiLM, SiLU, conv, RMSNorm, SiLU: not the CFG
U-Net's block), linear attention per stage, space-to-depth downsampling and
depth-to-space upsampling by each stage's factor (the JAX package's (dy,
dx, c) channel order), a ViT middle over the flattened tokens (RMSNorm'd
attention through the port's `sdpa`, q, k and v views of one projection;
a feedforward FiLM'd by the time embedding with a zero-initialised scale
and shift), optional patching (a strided conv, or dual patch-norm: space-
to-depth, LayerNorm, dense, LayerNorm) and the `init_img_transform` /
`final_img_itransform` hooks, which see NCHW tensors here.

Parameters are fp32 with flax's default initialisation; the trunk
computes in `dtype`, norms in fp32 (flax's LayerNorm returns fp32, so a
dual-patch-normed stem is fp32, as in JAX), `final_conv` and the
unpatchify in fp32. Dropout (default 0.2 in the ViT) runs only with
`deterministic=False`, as in the JAX package, whose trainers never pass
it. The names are the port's; `checkpoint/from_jax.uvit_state_from_jax`
maps the JAX tree onto them.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from .dit import layer_norm
from .layers import Conv2d, Dropout, Linear, RMSNorm, lecun_normal_init_
from .unet import _cast_tuple, depth_to_space, space_to_depth
from .unet_cfg import RandomOrLearnedSinusoidalPosEmb

__all__ = ["UViT"]


class _TokenRMSNorm(nn.Module):
    """RMSNorm over the last axis of [B, N, C] tokens, g [C]; fp32 math,
    the input's dtype out."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        normed = x32 * torch.rsqrt((x32 * x32).sum(-1, keepdim=True) + 1e-12)
        return (normed * self.g * x.shape[-1] ** 0.5).to(x.dtype)


class _LayerNorm(nn.Module):
    """flax's LayerNorm over the last axis (`dit.layer_norm`) with scale
    and bias; fp32 out."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, torch.float32) * self.weight + self.bias


class _ResnetBlock(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, time_dim: int, dtype):
        super().__init__()
        self.mlp = Linear(time_dim, dim_out * 2, dtype=dtype)
        self.proj1 = Conv2d(dim_in, dim_out, 3, padding=1, dtype=dtype)
        self.norm1 = RMSNorm(dim_out)
        self.proj2 = Conv2d(dim_out, dim_out, 3, padding=1, dtype=dtype)
        self.norm2 = RMSNorm(dim_out)
        self.res_conv = (Conv2d(dim_in, dim_out, 1, dtype=dtype)
                         if dim_in != dim_out else None)

    def forward(self, x, t):
        scale, shift = self.mlp(F.silu(t))[:, :, None, None].chunk(2, dim=1)
        h = self.norm1(self.proj1(x))
        h = F.silu(h * (scale + 1.0) + shift)
        h = F.silu(self.norm2(self.proj2(h)))
        return h + (self.res_conv(x) if self.res_conv is not None else x)


class _LinearAttention(nn.Module):
    """RMSNorm, linear attention (two fp32 einsums, no kernel), a 1x1
    output conv and the residual."""

    def __init__(self, dim: int, dtype, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.norm = RMSNorm(dim)
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False, dtype=dtype)
        self.to_out = Conv2d(hidden, dim, 1, dtype=dtype)

    def forward(self, x):
        b, _, h, w = x.shape
        xn = self.norm(x)
        q, k, v = (t.reshape(b, self.heads, self.dim_head, h * w)
                   for t in self.to_qkv(xn).chunk(3, dim=1))
        q = torch.softmax(q.float(), dim=-2) * self.dim_head ** -0.5
        k = torch.softmax(k.float(), dim=-1)
        ctx = torch.einsum("bhdn,bhen->bhde", k, v.float())
        out = torch.einsum("bhde,bhdn->bhen", ctx, q).to(xn.dtype)
        return x + self.to_out(out.reshape(b, -1, h, w))


class _VitAttention(nn.Module):
    """RMSNorm'd attention over tokens [B, N, C] through `sdpa`: q, k and
    v [B, N, heads, dim_head] are views of one bias-free projection."""

    def __init__(self, dim: int, heads: int, dim_head: int, dropout: float,
                 dtype):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.norm = _TokenRMSNorm(dim)
        self.to_qkv = Linear(dim, hidden * 3, bias=False, dtype=dtype)
        self.dropout = Dropout(dropout)
        self.to_out = Linear(hidden, dim, bias=False, dtype=dtype)

    def forward(self, x, deterministic: bool = True):
        b, n, _ = x.shape
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head)
                   for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        out = sdpa(q, k, v).reshape(b, n, -1)
        return self.to_out(self.dropout(out, deterministic))


class _VitFeedForward(nn.Module):
    """RMSNorm, a bias-free projection up, SiLU, a time FiLM whose scale
    and shift projection starts at zero, dropout, a projection down."""

    def __init__(self, dim: int, time_dim: int, mult: int, dropout: float,
                 dtype):
        super().__init__()
        hidden = dim * mult
        self.norm = _TokenRMSNorm(dim)
        self.proj_in = Linear(dim, hidden, bias=False, dtype=dtype)
        self.to_scale_shift = Linear(time_dim, hidden * 2, dtype=dtype)
        self.dropout = Dropout(dropout)
        self.proj_out = Linear(hidden, dim, bias=False, dtype=dtype)

    def forward(self, x, t, deterministic: bool = True):
        h = F.silu(self.proj_in(self.norm(x)))
        scale, shift = self.to_scale_shift(F.silu(t))[:, None, :].chunk(
            2, dim=-1)
        h = self.dropout(h * (scale + 1.0) + shift, deterministic)
        return self.proj_out(h)


class UViT(nn.Module):
    """forward(x [B,C,H,W], time [B], *, deterministic=True) -> [B, C', H,
    W] fp32 (C' = out_dim, or C)."""

    def __init__(
        self,
        dim: int,
        init_dim: Optional[int] = None,
        out_dim: Optional[int] = None,
        dim_mults: Tuple[int, ...] = (1, 2, 4, 8),
        downsample_factor: Union[int, Tuple[int, ...]] = 2,
        channels: int = 3,
        vit_depth: int = 6,
        vit_dropout: float = 0.2,
        attn_dim_head: int = 32,
        attn_heads: int = 4,
        ff_mult: int = 4,
        learned_sinusoidal_dim: int = 16,
        patch_size: int = 1,
        dual_patchnorm: bool = False,
        init_img_transform: Optional[Callable] = None,
        final_img_itransform: Optional[Callable] = None,
        dtype=torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.patch_size = patch_size
        self.dual_patchnorm = dual_patchnorm
        self.init_img_transform = init_img_transform
        self.final_img_itransform = final_img_itransform
        init_dim = init_dim or dim
        p = patch_size
        input_channels = channels * p * p
        if p > 1 and dual_patchnorm:
            self.patch_norm_in = _LayerNorm(input_channels)
            self.patch_proj = Linear(input_channels, init_dim, dtype=dtype)
            self.patch_norm_out = _LayerNorm(init_dim)
        elif p > 1:
            self.init_conv = Conv2d(channels, init_dim, p, stride=p,
                                    dtype=dtype)
        else:
            self.init_conv = Conv2d(channels, init_dim, 7, padding=3,
                                    dtype=dtype)

        time_dim = dim * 4
        self.time_mlp = nn.Sequential(
            RandomOrLearnedSinusoidalPosEmb(learned_sinusoidal_dim, False),
            Linear(learned_sinusoidal_dim + 1, time_dim, dtype=dtype),
            nn.GELU(approximate="tanh"),
            Linear(time_dim, time_dim, dtype=dtype))

        dims = [init_dim, *(dim * m for m in dim_mults)]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.factors = _cast_tuple(downsample_factor, len(dim_mults))
        self.downs = nn.ModuleList()
        for (dim_in, dim_out), f in zip(in_out, self.factors):
            self.downs.append(nn.ModuleList([
                _ResnetBlock(dim_in, dim_in, time_dim, dtype),
                _ResnetBlock(dim_in, dim_in, time_dim, dtype),
                _LinearAttention(dim_in, dtype),
                Conv2d(dim_in * f * f, dim_out, 1, dtype=dtype)]))
        mid = dims[-1]
        self.vit_attns = nn.ModuleList([
            _VitAttention(mid, attn_heads, attn_dim_head, vit_dropout, dtype)
            for _ in range(vit_depth)])
        self.vit_ffs = nn.ModuleList([
            _VitFeedForward(mid, time_dim, ff_mult, vit_dropout, dtype)
            for _ in range(vit_depth)])
        self.ups = nn.ModuleList()
        for (dim_in, dim_out), f in zip(reversed(in_out),
                                        reversed(self.factors)):
            self.ups.append(nn.ModuleList([
                Conv2d(dim_out, dim_in * f * f, 1, dtype=dtype),
                _ResnetBlock(dim_in * 2, dim_in, time_dim, dtype),
                _ResnetBlock(dim_in * 2, dim_in, time_dim, dtype),
                _LinearAttention(dim_in, dtype)]))
        self.final_res_block = _ResnetBlock(init_dim * 2, init_dim, time_dim,
                                            dtype)
        self.out_dim = out_dim or input_channels
        self.final_conv = Conv2d(init_dim, self.out_dim, 1)  # fp32
        if p > 1:
            self.unpatchify = nn.ConvTranspose2d(self.out_dim, channels, p,
                                                 stride=p)
        lecun_normal_init_(self)
        if p > 1:  # flax initialises ConvTranspose the same way
            std = (1.0 / (self.out_dim * p * p)) ** 0.5 / .87962566103423978
            nn.init.trunc_normal_(self.unpatchify.weight, 0.0, std, -2 * std,
                                  2 * std)
            nn.init.zeros_(self.unpatchify.bias)
        for ff in self.vit_ffs:
            nn.init.zeros_(ff.to_scale_shift.weight)
            nn.init.zeros_(ff.to_scale_shift.bias)

    def _stem(self, x):
        p = self.patch_size
        if p > 1 and self.dual_patchnorm:
            x = space_to_depth(x, p).permute(0, 2, 3, 1)
            x = self.patch_norm_out(self.patch_proj(self.patch_norm_in(x)))
            return x.permute(0, 3, 1, 2)
        return self.init_conv(x)

    def forward(self, x, time, *, deterministic: bool = True):
        if self.init_img_transform is not None:
            x = self.init_img_transform(x)
        x = self._stem(x.to(self.dtype))
        r = x
        t = self.time_mlp(time)

        hs = []
        for (block1, block2, attn, downsample), f in zip(self.downs,
                                                          self.factors):
            x = block1(x, t)
            hs.append(x)
            x = attn(block2(x, t))
            hs.append(x)
            x = downsample(space_to_depth(x, f))

        b, c, h, w = x.shape
        x = x.flatten(2).transpose(1, 2)
        for attn, ff in zip(self.vit_attns, self.vit_ffs):
            x = x + attn(x, deterministic)
            x = x + ff(x, t, deterministic)
        x = x.transpose(1, 2).reshape(b, c, h, w)

        for (upsample, block1, block2, attn), f in zip(
                self.ups, reversed(self.factors)):
            x = depth_to_space(upsample(x), f)
            x = block1(torch.cat([x, hs.pop()], dim=1), t)
            x = block2(torch.cat([x, hs.pop()], dim=1), t)
            x = attn(x)

        x = self.final_res_block(torch.cat([x, r], dim=1), t)
        x = self.final_conv(x)
        if self.patch_size > 1:
            x = self.unpatchify(x.float())
        if self.final_img_itransform is not None:
            x = self.final_img_itransform(x)
        return x
