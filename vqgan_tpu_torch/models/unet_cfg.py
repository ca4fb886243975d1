"""Class-conditional U-Net for classifier-free-guidance latent diffusion.

Counterpart of vqgan_tpu/models/unet_cfg.py, NCHW inside. Parameters are
fp32 and named as in the reference PyTorch `Unet` (`downs.{i}.2.fn.fn.to_qkv`,
`classes_mlp.0`, `time_mlp.1`, `ups.{i}.4.1`, ...); the trunk computes in
`dtype` (bf16 in LDMConfig), norms in fp32, `final_conv` in fp32.

Parity points with the JAX package:
- GELU is the tanh approximation (flax's `nn.gelu` default).
- LinearAttention always has 4 heads x 32, whatever attn_heads says.
- CrossAttentionCond with one context token is the broadcast of
  `to_out(to_v(context))`; `to_q` and `to_k` exist as parameters all the same.
- The mid-block `Attention` runs through the port's `sdpa` (the flash kernel
  on CUDA).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from ..parallel.mesh import draw_rows
from .layers import (
    Conv2d,
    Dropout,
    Linear,
    RMSNorm,
    UpsampleNearest,
    from_heads,
    to_heads,
)

__all__ = ["CFGUnet", "SinusoidalPosEmb", "draw_cond_drop_mask"]


def draw_cond_drop_mask(b: int, p: float,
                        generator: Optional[torch.Generator], device):
    """The training-time class dropout: bool [B], True with probability p,
    drawn from `generator`; None when p is 0. The denoisers draw it here,
    and so does the rematerialised forward before its checkpoint. Inside
    `parallel.mesh.global_batch` the global batch's draw, this rank's
    rows."""
    if p > 0.0:
        return draw_rows(lambda shape: torch.rand(
            shape, generator=generator, device=device), (b,)) < p
    return None


class SinusoidalPosEmb(nn.Module):
    """Transformer sinusoidal timestep embedding."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        half_dim = self.dim // 2
        emb = math.log(10000) / (half_dim - 1)
        emb = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                     device=t.device) * -emb)
        emb = t.float()[:, None] * emb[None, :]
        return torch.cat([emb.sin(), emb.cos()], dim=-1)


class RandomOrLearnedSinusoidalPosEmb(nn.Module):
    """Fourier-feature time embedding, optionally frozen; output dim is
    dim + 1 (raw t first)."""

    def __init__(self, dim: int, is_random: bool = False):
        super().__init__()
        self.weights = nn.Parameter(torch.randn(dim // 2),
                                    requires_grad=not is_random)

    def forward(self, t):
        t = t.float()[:, None]
        freqs = t * self.weights[None, :] * 2 * math.pi
        return torch.cat([t, freqs.sin(), freqs.cos()], dim=-1)


class Block(nn.Module):
    """conv3x3, RMSNorm, optional FiLM scale/shift, SiLU, and with `dropout`
    > 0 a `Dropout` that runs only under deterministic=False."""

    def __init__(self, dim: int, dim_out: int, dtype, dropout: float = 0.0):
        super().__init__()
        self.proj = Conv2d(dim, dim_out, 3, padding=1, dtype=dtype)
        self.norm = RMSNorm(dim_out)
        self.dropout = Dropout(dropout) if dropout > 0.0 else None

    def forward(self, x, scale_shift=None, deterministic: bool = True,
                generator=None):
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        x = F.silu(x)
        if self.dropout is not None:
            x = self.dropout(x, deterministic, generator)
        return x


class ResnetBlock(nn.Module):
    """Two conv blocks with FiLM from one conditioning vector (the CFG U-Net
    passes time and class embeddings concatenated, the DDPM U-Net the time
    embedding) and a 1x1 residual conv when the channel count changes. The
    first block's `dropout` (the DDPM U-Net's; 0 in the CFG U-Net) runs
    only under deterministic=False."""

    def __init__(self, dim: int, dim_out: int, cond_dim: int, dtype,
                 dropout: float = 0.0):
        super().__init__()
        self.mlp = nn.Sequential(nn.SiLU(),
                                 Linear(cond_dim, dim_out * 2, dtype=dtype))
        self.block1 = Block(dim, dim_out, dtype, dropout)
        self.block2 = Block(dim_out, dim_out, dtype)
        self.res_conv = (Conv2d(dim, dim_out, 1, dtype=dtype)
                         if dim != dim_out else None)

    def forward(self, x, cond, deterministic: bool = True, generator=None):
        scale_shift = self.mlp(cond)[:, :, None, None].chunk(2, dim=1)
        h = self.block2(self.block1(x, scale_shift, deterministic, generator))
        return h + (self.res_conv(x) if self.res_conv is not None else x)


class LinearAttention(nn.Module):
    """Kernel-feature-map linear attention with an RMSNorm'd output
    projection; O(n d^2), two einsums, no kernel."""

    def __init__(self, dim: int, dtype, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False, dtype=dtype)
        self.to_out = nn.Sequential(Conv2d(hidden, dim, 1, dtype=dtype),
                                    RMSNorm(dim))

    def forward(self, x):
        b, _, h, w = x.shape
        q, k, v = (t.reshape(b, self.heads, self.dim_head, h * w)
                   for t in self.to_qkv(x).chunk(3, dim=1))
        q = torch.softmax(q.float(), dim=-2) * (self.dim_head ** -0.5)
        k = torch.softmax(k.float(), dim=-1)
        context = torch.einsum("bhdn,bhen->bhde", k, v.float())
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        out = out.reshape(b, -1, h, w).to(x.dtype)
        return self.to_out(out)


class Attention(nn.Module):
    """Full multi-head self-attention over spatial tokens."""

    def __init__(self, dim: int, dtype, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads = heads
        hidden = heads * dim_head
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False, dtype=dtype)
        self.to_out = Conv2d(hidden, dim, 1, dtype=dtype)

    def forward(self, x):
        _, _, h, w = x.shape
        q, k, v = (to_heads(t, self.heads)
                   for t in self.to_qkv(x).chunk(3, dim=1))
        return self.to_out(from_heads(sdpa(q, k, v), h, w))


class CrossAttentionCond(nn.Module):
    """Image queries attend to the condition vector. With one context token
    the softmax puts all mass on it, so the output is `to_out` of the value
    projection, broadcast over every position."""

    def __init__(self, dim: int, context_dim: int, dtype, heads: int = 4,
                 dim_head: int = 32):
        super().__init__()
        self.heads = heads
        hidden = heads * dim_head
        self.to_q = Conv2d(dim, hidden, 1, bias=False, dtype=dtype)
        self.to_k = Linear(context_dim, hidden, bias=False, dtype=dtype)
        self.to_v = Linear(context_dim, hidden, bias=False, dtype=dtype)
        self.to_out = Conv2d(hidden, dim, 1, dtype=dtype)

    def forward(self, x, context):
        b, c, h, w = x.shape
        if context.ndim == 2:
            context = context[:, None, :]
        n = context.shape[1]
        v = self.to_v(context)  # [B, n, hidden]
        if n == 1:
            tok = self.to_out(v.reshape(b, -1, 1, 1))
            return tok.expand(b, c, h, w)
        q = to_heads(self.to_q(x), self.heads)
        k = self.to_k(context).reshape(b, n, self.heads, -1)
        v = v.reshape(b, n, self.heads, -1)
        return self.to_out(from_heads(sdpa(q, k, v), h, w))


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.norm = RMSNorm(dim)

    def forward(self, x, *args):
        return self.fn(self.norm(x), *args)


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, *args):
        return x + self.fn(x, *args)


def _prenorm_residual(dim, fn):
    return Residual(PreNorm(dim, fn))


class CFGUnet(nn.Module):
    """The stage-2 denoiser. forward(x [B,C,H,W], time [B], classes [B]) ->
    [B, out_dim, H, W] fp32."""

    def __init__(
        self,
        dim: int,
        num_classes: int,
        cond_drop_prob: float = 0.5,
        init_dim: Optional[int] = None,
        out_dim: Optional[int] = None,
        dim_mults: Tuple[int, ...] = (1, 2, 4, 8),
        channels: int = 3,
        learned_variance: bool = False,
        learned_sinusoidal_cond: bool = False,
        random_fourier_features: bool = False,
        learned_sinusoidal_dim: int = 16,
        attn_dim_head: int = 32,
        attn_heads: int = 4,
        dtype=torch.float32,
    ):
        super().__init__()
        self.cond_drop_prob = cond_drop_prob
        self.dtype = dtype
        init_dim = init_dim or dim
        time_dim = classes_dim = dim * 4
        cond_dim = time_dim + classes_dim

        self.classes_emb = nn.Embedding(num_classes, dim)
        self.null_classes_emb = nn.Parameter(torch.randn(dim))
        self.classes_mlp = nn.Sequential(
            Linear(dim, classes_dim, dtype=dtype),
            nn.GELU(approximate="tanh"),
            Linear(classes_dim, classes_dim, dtype=dtype))

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

        self.init_conv = Conv2d(channels, init_dim, 7, padding=3, dtype=dtype)
        dims = [init_dim, *(dim * m for m in dim_mults)]
        in_out = list(zip(dims[:-1], dims[1:]))

        def cross(d):
            return _prenorm_residual(d, CrossAttentionCond(
                d, classes_dim, dtype, attn_heads, attn_dim_head))

        self.downs = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(in_out):
            is_last = ind >= len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(dim_in, dim_in, cond_dim, dtype),
                ResnetBlock(dim_in, dim_in, cond_dim, dtype),
                _prenorm_residual(dim_in, LinearAttention(dim_in, dtype)),
                cross(dim_in),
                Conv2d(dim_in, dim_out, 4, stride=2, padding=1, dtype=dtype)
                if not is_last
                else Conv2d(dim_in, dim_out, 3, padding=1, dtype=dtype),
            ]))

        mid_dim = dims[-1]
        self.mid_block1 = ResnetBlock(mid_dim, mid_dim, cond_dim, dtype)
        self.mid_attn = _prenorm_residual(mid_dim, Attention(
            mid_dim, dtype, attn_heads, attn_dim_head))
        self.mid_cross_attn = cross(mid_dim)
        self.mid_block2 = ResnetBlock(mid_dim, mid_dim, cond_dim, dtype)

        self.ups = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(reversed(in_out)):
            is_last = ind == len(in_out) - 1
            self.ups.append(nn.ModuleList([
                ResnetBlock(dim_out + dim_in, dim_out, cond_dim, dtype),
                ResnetBlock(dim_out + dim_in, dim_out, cond_dim, dtype),
                _prenorm_residual(dim_out, LinearAttention(dim_out, dtype)),
                cross(dim_out),
                UpsampleNearest(dim_out, dim_in, dtype=dtype)
                if not is_last
                else Conv2d(dim_out, dim_in, 3, padding=1, dtype=dtype),
            ]))

        self.out_dim = out_dim or channels * (2 if learned_variance else 1)
        self.final_res_block = ResnetBlock(init_dim * 2, init_dim, cond_dim,
                                           dtype)
        self.final_conv = Conv2d(init_dim, self.out_dim, 1)  # fp32

    def forward(self, x, time, classes, *,
                cond_drop_mask: Optional[torch.Tensor] = None,
                cond_drop_prob: Optional[float] = None,
                generator: Optional[torch.Generator] = None,
                return_features: bool = False):
        """cond_drop_mask (bool [B], True selects the learned null class
        embedding) is what the CFG sampler passes. Without it, classes are
        dropped at random with `cond_drop_prob` (default: the model's) drawn
        from `generator`."""
        b = x.shape[0]
        classes_emb = self.classes_emb(classes)
        if cond_drop_mask is None:
            p = self.cond_drop_prob if cond_drop_prob is None else cond_drop_prob
            cond_drop_mask = draw_cond_drop_mask(b, p, generator, x.device)
        if cond_drop_mask is not None:
            classes_emb = torch.where(cond_drop_mask[:, None],
                                      self.null_classes_emb[None, :],
                                      classes_emb)
        c = self.classes_mlp(classes_emb)
        tc = torch.cat([self.time_mlp(time), c], dim=-1)

        x = self.init_conv(x.to(self.dtype))
        r = x
        hs = []
        for block1, block2, attn, cross_attn, downsample in self.downs:
            x = block1(x, tc)
            hs.append(x)
            x = block2(x, tc)
            x = cross_attn(attn(x), c)
            hs.append(x)
            x = downsample(x)

        x = self.mid_block1(x, tc)
        x = self.mid_attn(x)
        features = None
        if return_features:
            pooled = x.float().mean(dim=(2, 3))
            features = pooled / torch.clamp(
                torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-12)
        x = self.mid_cross_attn(x, c)
        x = self.mid_block2(x, tc)

        for block1, block2, attn, cross_attn, upsample in self.ups:
            x = block1(torch.cat([x, hs.pop()], dim=1), tc)
            x = block2(torch.cat([x, hs.pop()], dim=1), tc)
            x = cross_attn(attn(x), c)
            x = upsample(x)

        x = self.final_res_block(torch.cat([x, r], dim=1), tc)
        out = self.final_conv(x)
        if return_features:
            return out, features
        return out
