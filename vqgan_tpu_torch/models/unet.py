"""Unconditional DDPM U-Net.

Counterpart of vqgan_tpu/models/unet.py, NCHW inside: self-conditioning,
space-to-depth downsampling, attention with 4 learned memory key/value
tokens (linear on the outer stages, full where `full_attn` says, always in
the middle), time FiLM in every ResNet block. Parameters are fp32 with
flax's default initialisation; the trunk computes in `dtype`, norms in fp32,
`final_conv` in fp32. The JAX package has no PyTorch reader for this model,
so the names are the port's (those of lucidrains' `Unet`: `downs.{i}.{0-3}`,
`mid_attn`, `ups.{i}.{0-3}`, `time_mlp.{1,3}`, ...), and
`checkpoint/from_jax.ddpm_unet_state_from_jax` maps the JAX tree onto them.

Parity points with the JAX package:
- Space-to-depth orders the 4C new channels as (dy, dx, c), c fastest,
  not as einops' `b c (h p1) (w p2) -> b (c p1 p2) h w`.
- Full attention hands `sdpa` q as a view of the `to_qkv` projection and k,
  v as new tensors with the memory tokens in front: Skv = H * W + 4.
- `dropout` sits in the first conv block of every ResNet block and runs
  only under deterministic=False, as in the JAX package, whose trainers
  never pass it (nor do the port's).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..ops.attention import sdpa
from .layers import (
    Conv2d,
    Linear,
    RMSNorm,
    UpsampleNearest,
    from_heads,
    lecun_normal_init_,
    with_memory_tokens,
)
from .unet_cfg import (
    RandomOrLearnedSinusoidalPosEmb,
    ResnetBlock,
    SinusoidalPosEmb,
)

__all__ = ["Unet", "SpaceToDepthDownsample", "LinearAttention",
           "Attention", "ResnetBlock", "space_to_depth", "depth_to_space"]


def _cast_tuple(t, length: int) -> tuple:
    if isinstance(t, (tuple, list)):
        if len(t) != length:
            raise ValueError(f"expected {length} values, got {t}")
        return tuple(t)
    return (t,) * length


def space_to_depth(x: torch.Tensor, f: int = 2) -> torch.Tensor:
    """[B, C, H, W] -> [B, f*f*C, H/f, W/f]; new channel (dy * f + dx) * C
    + c holds x[:, c, f*i + dy, f*j + dx], the JAX package's order."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // f, f, w // f, f).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, f * f * c, h // f, w // f)


def depth_to_space(x: torch.Tensor, f: int = 2) -> torch.Tensor:
    """The inverse of `space_to_depth`: [B, f*f*C, H, W] -> [B, C, H*f,
    W*f], x[:, (dy * f + dx) * C + c, i, j] to [:, c, f*i + dy, f*j + dx]."""
    b, c, h, w = x.shape
    x = x.reshape(b, f, f, c // (f * f), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c // (f * f), h * f, w * f)


class SpaceToDepthDownsample(nn.Sequential):
    """2x2 space-to-depth, then a 1x1 conv (its parameters at `.1`)."""

    def __init__(self, dim: int, dim_out: int, dtype):
        super().__init__(_SpaceToDepth(), Conv2d(dim * 4, dim_out, 1,
                                                 dtype=dtype))


class _SpaceToDepth(nn.Module):
    def forward(self, x):
        return space_to_depth(x)


class LinearAttention(nn.Module):
    """Pre-normed linear attention with memory key/value tokens and an
    RMSNorm'd output; two einsums in fp32, no kernel."""

    def __init__(self, dim: int, heads: int, dim_head: int, dtype,
                 num_mem_kv: int = 4):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.norm = RMSNorm(dim)
        self.mem_kv = nn.Parameter(torch.randn(2, heads, dim_head,
                                               num_mem_kv))
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False, dtype=dtype)
        self.to_out = nn.Sequential(Conv2d(hidden, dim, 1, dtype=dtype),
                                    RMSNorm(dim))

    def forward(self, x):
        b, _, h, w = x.shape
        q, k, v = (t.reshape(b, self.heads, self.dim_head, h * w)
                   for t in self.to_qkv(self.norm(x)).chunk(3, dim=1))
        mk, mv = (m.expand(b, -1, -1, -1) for m in self.mem_kv)
        k = torch.cat([mk, k.float()], dim=-1)
        v = torch.cat([mv, v.float()], dim=-1)
        q = torch.softmax(q.float(), dim=-2) * (self.dim_head ** -0.5)
        k = torch.softmax(k, dim=-1)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        return self.to_out(out.reshape(b, -1, h, w).to(x.dtype))


class Attention(nn.Module):
    """Pre-normed full attention with memory key/value tokens, through the
    port's `sdpa` (the flash kernels on CUDA): q [B, H*W, heads, dh] is a
    view of the projection (row stride 3 * heads * dh), k and v
    [B, 4 + H*W, heads, dh] are the memory tokens followed by the
    projection's."""

    def __init__(self, dim: int, heads: int, dim_head: int, dtype,
                 num_mem_kv: int = 4):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.norm = RMSNorm(dim)
        self.mem_kv = nn.Parameter(torch.randn(2, heads, num_mem_kv,
                                               dim_head))
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False, dtype=dtype)
        self.to_out = Conv2d(hidden, dim, 1, dtype=dtype)

    def forward(self, x):
        b, _, h, w = x.shape
        qkv = self.to_qkv(self.norm(x)).permute(0, 2, 3, 1).contiguous()
        qkv = qkv.view(b, h * w, 3, self.heads, self.dim_head)
        q, k, v = qkv.unbind(dim=2)
        k, v = with_memory_tokens(self.mem_kv, k, v)
        return self.to_out(from_heads(sdpa(q, k, v), h, w))


class Unet(nn.Module):
    """forward(x [B,C,H,W], time [B], x_self_cond=None, *,
    return_features=False, deterministic=True, generator=None) -> [B,
    out_dim, H, W] fp32 (and the mid-block features [B, mid_dim],
    L2-normalised, with return_features). Dropout runs only under
    deterministic=False, its masks drawn from `generator`."""

    def __init__(
        self,
        dim: int,
        init_dim: Optional[int] = None,
        out_dim: Optional[int] = None,
        dim_mults: Tuple[int, ...] = (1, 2, 4, 8),
        channels: int = 3,
        self_condition: bool = False,
        learned_variance: bool = False,
        learned_sinusoidal_cond: bool = False,
        random_fourier_features: bool = False,
        learned_sinusoidal_dim: int = 16,
        dropout: float = 0.0,
        attn_dim_head: Union[int, Tuple[int, ...]] = 32,
        attn_heads: Union[int, Tuple[int, ...]] = 4,
        full_attn: Optional[Tuple[bool, ...]] = None,
        dtype=torch.float32,
    ):
        super().__init__()
        self.channels = channels
        self.self_condition = self_condition
        self.dtype = dtype
        num_stages = len(dim_mults)
        self.downsample_factor = 2 ** (num_stages - 1)
        full_attn = _cast_tuple(
            full_attn or ((False,) * (num_stages - 1) + (True,)), num_stages)
        heads = _cast_tuple(attn_heads, num_stages)
        dim_head = _cast_tuple(attn_dim_head, num_stages)

        init_dim = init_dim or dim
        input_channels = channels * (2 if self_condition else 1)
        self.init_conv = Conv2d(input_channels, init_dim, 7, padding=3,
                                dtype=dtype)

        time_dim = dim * 4
        if learned_sinusoidal_cond or random_fourier_features:
            sinu = RandomOrLearnedSinusoidalPosEmb(learned_sinusoidal_dim,
                                                   random_fourier_features)
            fourier_dim = learned_sinusoidal_dim + 1
        else:
            sinu = SinusoidalPosEmb(dim)
            fourier_dim = dim
        self.time_mlp = nn.Sequential(
            sinu,
            Linear(fourier_dim, time_dim, dtype=dtype),
            nn.GELU(approximate="tanh"),
            Linear(time_dim, time_dim, dtype=dtype))

        def attention(stage, d):
            cls = Attention if full_attn[stage] else LinearAttention
            return cls(d, heads[stage], dim_head[stage], dtype)

        dims = [init_dim, *(dim * m for m in dim_mults)]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.downs = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(in_out):
            is_last = ind == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(dim_in, dim_in, time_dim, dtype, dropout),
                ResnetBlock(dim_in, dim_in, time_dim, dtype, dropout),
                attention(ind, dim_in),
                Conv2d(dim_in, dim_out, 3, padding=1, dtype=dtype) if is_last
                else SpaceToDepthDownsample(dim_in, dim_out, dtype),
            ]))

        mid_dim = dims[-1]
        self.mid_block1 = ResnetBlock(mid_dim, mid_dim, time_dim, dtype,
                                      dropout)
        self.mid_attn = Attention(mid_dim, heads[-1], dim_head[-1], dtype)
        self.mid_block2 = ResnetBlock(mid_dim, mid_dim, time_dim, dtype,
                                      dropout)

        self.ups = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(reversed(in_out)):
            is_last = ind == len(in_out) - 1
            stage = num_stages - 1 - ind
            self.ups.append(nn.ModuleList([
                ResnetBlock(dim_out + dim_in, dim_out, time_dim, dtype,
                            dropout),
                ResnetBlock(dim_out + dim_in, dim_out, time_dim, dtype,
                            dropout),
                attention(stage, dim_out),
                Conv2d(dim_out, dim_in, 3, padding=1, dtype=dtype) if is_last
                else UpsampleNearest(dim_out, dim_in, dtype=dtype),
            ]))

        self.out_dim = out_dim or channels * (2 if learned_variance else 1)
        self.final_res_block = ResnetBlock(init_dim * 2, init_dim, time_dim,
                                           dtype, dropout)
        self.final_conv = Conv2d(init_dim, self.out_dim, 1)  # fp32
        lecun_normal_init_(self)

    def forward(self, x, time, x_self_cond=None, *,
                return_features: bool = False, deterministic: bool = True,
                generator=None):
        drop = (deterministic, generator)
        if self.self_condition:
            if x_self_cond is None:
                x_self_cond = torch.zeros_like(x)
            x = torch.cat([x_self_cond, x], dim=1)
        x = self.init_conv(x.to(self.dtype))
        r = x
        t = self.time_mlp(time)

        hs = []
        for block1, block2, attn, downsample in self.downs:
            x = block1(x, t, *drop)
            hs.append(x)
            x = block2(x, t, *drop)
            x = attn(x) + x
            hs.append(x)
            x = downsample(x)

        x = self.mid_block1(x, t, *drop)
        x = self.mid_attn(x) + x
        features = None
        if return_features:
            pooled = x.float().mean(dim=(2, 3))
            features = pooled / torch.clamp(
                torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-12)
        x = self.mid_block2(x, t, *drop)

        for block1, block2, attn, upsample in self.ups:
            x = block1(torch.cat([x, hs.pop()], dim=1), t, *drop)
            x = block2(torch.cat([x, hs.pop()], dim=1), t, *drop)
            x = attn(x) + x
            x = upsample(x)

        x = self.final_res_block(torch.cat([x, r], dim=1), t, *drop)
        out = self.final_conv(x)
        if return_features:
            return out, features
        return out
