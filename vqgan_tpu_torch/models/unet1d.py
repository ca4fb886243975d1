"""1-D U-Net for sequence diffusion.

Counterpart of vqgan_tpu/models/unet1d.py, [B, C, L] inside (the JAX
package's [B, L, C] with the channels first): RMSNorm blocks with time
FiLM, linear attention in every stage, full attention in the middle
through the port's `sdpa` (q, k and v views of one projection), stride-2
conv downsampling and nearest-neighbour upsampling.

Parameters are fp32 with flax's default initialisation; the trunk computes
in `dtype`, norms in fp32, `final_conv` in fp32. Dropout (default 0) runs
only with `deterministic=False`, as in the JAX package. The names are the
port's; `checkpoint/from_jax.unet1d_state_from_jax` maps the JAX tree onto
them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from .layers import Dropout, Linear, RMSNorm, lecun_normal_init_
from .unet_cfg import RandomOrLearnedSinusoidalPosEmb, SinusoidalPosEmb

__all__ = ["Unet1D"]


class Conv1d(nn.Conv1d):
    """Conv1d with fp32 parameters that computes in `dtype`."""

    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return self._conv_forward(x.to(d), self.weight.to(d), bias)


def _norm(dim):
    return RMSNorm(dim, spatial_dims=1)


class _Block(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dropout: float, dtype):
        super().__init__()
        self.proj = Conv1d(dim_in, dim_out, 3, padding=1, dtype=dtype)
        self.norm = _norm(dim_out)
        self.dropout = Dropout(dropout)

    def forward(self, x, scale_shift=None, deterministic: bool = True):
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return self.dropout(F.silu(x), deterministic)


class _ResnetBlock(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, time_dim: int,
                 dropout: float, dtype):
        super().__init__()
        self.mlp = Linear(time_dim, dim_out * 2, dtype=dtype)
        self.block1 = _Block(dim_in, dim_out, dropout, dtype)
        self.block2 = _Block(dim_out, dim_out, 0.0, dtype)
        self.res_conv = (Conv1d(dim_in, dim_out, 1, dtype=dtype)
                         if dim_in != dim_out else None)

    def forward(self, x, t, deterministic: bool = True):
        scale_shift = self.mlp(F.silu(t))[:, :, None].chunk(2, dim=1)
        h = self.block2(self.block1(x, scale_shift, deterministic))
        return h + (self.res_conv(x) if self.res_conv is not None else x)


class _LinearAttention1D(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, dtype):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.norm = _norm(dim)
        self.to_qkv = Conv1d(dim, hidden * 3, 1, bias=False, dtype=dtype)
        self.to_out = Conv1d(hidden, dim, 1, dtype=dtype)

    def forward(self, x):
        b, _, n = x.shape
        xn = self.norm(x)
        q, k, v = (t.reshape(b, self.heads, self.dim_head, n)
                   for t in self.to_qkv(xn).chunk(3, dim=1))
        q = torch.softmax(q.float(), dim=-2) * self.dim_head ** -0.5
        k = torch.softmax(k.float(), dim=-1)
        ctx = torch.einsum("bhdn,bhen->bhde", k, v.float())
        out = torch.einsum("bhde,bhdn->bhen", ctx, q).to(xn.dtype)
        return x + self.to_out(out.reshape(b, -1, n))


class _Attention1D(nn.Module):
    """Full attention over the positions through `sdpa`: q, k and v [B,
    L, heads, dim_head] are views of one projection (row stride 3 * heads
    * dim_head)."""

    def __init__(self, dim: int, heads: int, dim_head: int, dtype):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.norm = _norm(dim)
        self.to_qkv = Conv1d(dim, hidden * 3, 1, bias=False, dtype=dtype)
        self.to_out = Conv1d(hidden, dim, 1, dtype=dtype)

    def forward(self, x):
        b, _, n = x.shape
        qkv = self.to_qkv(self.norm(x)).transpose(1, 2).contiguous()
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head)
                   for t in qkv.chunk(3, dim=-1))
        out = sdpa(q, k, v).reshape(b, n, -1).transpose(1, 2)
        return x + self.to_out(out)


class Unet1D(nn.Module):
    """forward(x [B, C, L], time [B], x_self_cond=None, *,
    deterministic=True) -> [B, out_dim, L] fp32."""

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
        attn_dim_head: int = 32,
        attn_heads: int = 4,
        dtype=torch.float32,
    ):
        super().__init__()
        self.channels = channels
        self.self_condition = self_condition
        self.dtype = dtype
        init_dim = init_dim or dim
        input_channels = channels * (2 if self_condition else 1)
        self.init_conv = Conv1d(input_channels, init_dim, 7, padding=3,
                                dtype=dtype)
        time_dim = dim * 4
        if learned_sinusoidal_cond or random_fourier_features:
            sinu = RandomOrLearnedSinusoidalPosEmb(learned_sinusoidal_dim,
                                                   random_fourier_features)
            fourier_dim = learned_sinusoidal_dim + 1
        else:
            sinu, fourier_dim = SinusoidalPosEmb(dim), dim
        self.time_mlp = nn.Sequential(
            sinu, Linear(fourier_dim, time_dim, dtype=dtype),
            nn.GELU(approximate="tanh"),
            Linear(time_dim, time_dim, dtype=dtype))

        def resnet(d_in, d_out):
            return _ResnetBlock(d_in, d_out, time_dim, dropout, dtype)

        def linear_attention(d):
            return _LinearAttention1D(d, attn_heads, attn_dim_head, dtype)

        dims = [init_dim, *(dim * m for m in dim_mults)]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.downs = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(in_out):
            is_last = ind == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                resnet(dim_in, dim_in), resnet(dim_in, dim_in),
                linear_attention(dim_in),
                Conv1d(dim_in, dim_out, 3, padding=1, dtype=dtype) if is_last
                else Conv1d(dim_in, dim_out, 4, stride=2, padding=1,
                            dtype=dtype)]))
        mid = dims[-1]
        self.mid_block1 = resnet(mid, mid)
        self.mid_attn = _Attention1D(mid, attn_heads, attn_dim_head, dtype)
        self.mid_block2 = resnet(mid, mid)
        self.ups = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(reversed(in_out)):
            self.ups.append(nn.ModuleList([
                resnet(dim_out + dim_in, dim_out),
                resnet(dim_out + dim_in, dim_out),
                linear_attention(dim_out),
                Conv1d(dim_out, dim_in, 3, padding=1, dtype=dtype)]))
        self.final_res_block = resnet(init_dim * 2, init_dim)
        self.out_dim = out_dim or channels * (2 if learned_variance else 1)
        self.final_conv = Conv1d(init_dim, self.out_dim, 1)  # fp32
        lecun_normal_init_(self)

    def forward(self, x, time, x_self_cond=None, *,
                deterministic: bool = True):
        if self.self_condition:
            if x_self_cond is None:
                x_self_cond = torch.zeros_like(x)
            x = torch.cat([x_self_cond, x], dim=1)
        x = self.init_conv(x.to(self.dtype))
        r = x
        t = self.time_mlp(time)
        kw = dict(deterministic=deterministic)

        hs = []
        for block1, block2, attn, downsample in self.downs:
            x = block1(x, t, **kw)
            hs.append(x)
            x = attn(block2(x, t, **kw))
            hs.append(x)
            x = downsample(x)

        x = self.mid_block2(self.mid_attn(self.mid_block1(x, t, **kw)), t,
                            **kw)

        for i, (block1, block2, attn, upsample) in enumerate(self.ups):
            x = block1(torch.cat([x, hs.pop()], dim=1), t, **kw)
            x = attn(block2(torch.cat([x, hs.pop()], dim=1), t, **kw))
            if i < len(self.ups) - 1:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = upsample(x)

        x = self.final_res_block(torch.cat([x, r], dim=1), t, **kw)
        return self.final_conv(x)
