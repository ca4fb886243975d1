"""Karras magnitude-preserving U-Net (EDM2, arXiv 2312.02696, config G).

Counterpart of vqgan_tpu/models/karras_unet.py, NCHW inside: MP SiLU, MP
cat and MP add, pixel norm, bias-less convolutions and linears with forced
weight normalisation, the MP Fourier time embedding (a frozen buffer),
bilinear-resample encoder and decoder blocks, cosine attention with 4
memory key/value tokens, one-hot class conditioning scaled by sqrt(C), the
MP transformer blocks and the inverse-sqrt learning-rate decay.

- Forced weight normalisation: every forward uses normalize_weight(w) /
  sqrt(fan_in), as the JAX package does; `normalize_karras_params`
  re-projects the stored weights in place after an optimizer step (the JAX
  package's functional form). With `normalize_forward=False` the forward
  skips the re-normalisation, which is exact on weights kept normalised.
- Bilinear resizing is `F.interpolate(mode="bilinear", antialias=True,
  align_corners=False)` in fp32: `jax.image.resize` antialiases when it
  downsamples and renormalises its taps at the borders, as this does.
- `KarrasAttention` takes max(ceil(dim / 64), 2) heads and pixel-norms q,
  k and v after the memory tokens are put in front of k and v; `sdpa` (the
  flash kernels on CUDA) sees Skv = H * W + 4.
- `Gain` promotes to fp32, as JAX's bf16 * f32 does, so a bf16 model's
  output is fp32.
- Dropout (default 0.1) runs only when the caller passes
  `deterministic=False`, as in the JAX package, whose trainers never do;
  `.train()` alone does not turn it on. Its bits cannot match JAX's.

The names are the port's (`downs.{i}`, `mids.{i}`, `ups.{i}`, `weight` for
each `mp_kernel`); `checkpoint/from_jax.karras_unet_state_from_jax` maps
the JAX tree onto them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from .layers import Dropout, from_heads, with_memory_tokens

__all__ = [
    "mp_silu",
    "mp_cat",
    "mp_add",
    "pixel_norm",
    "normalize_weight",
    "normalize_karras_params",
    "bilinear_resize",
    "MPConv",
    "MPLinear",
    "Gain",
    "MPFourierEmbedding",
    "KarrasAttention",
    "KarrasEncoderBlock",
    "KarrasDecoderBlock",
    "KarrasUnet",
    "MPFeedForward",
    "MPAttentionTokens",
    "MPTransformer",
    "inv_sqrt_decay_schedule",
]


def mp_silu(x):
    return F.silu(x) / 0.596


def mp_cat(a, b, t: float = 0.5, dim: int = 1):
    na, nb = a.shape[dim], b.shape[dim]
    c = math.sqrt((na + nb) / ((1.0 - t) ** 2 + t ** 2))
    a = a * (1.0 - t) / math.sqrt(na)
    b = b * t / math.sqrt(nb)
    return c * torch.cat([a, b], dim=dim)


def mp_add(x, res, t: float = 0.3):
    return (x * (1.0 - t) + res * t) / math.sqrt((1 - t) ** 2 + t ** 2)


def pixel_norm(x, dim: int = 1, eps: float = 1e-4):
    """x / max(|x|, eps) * sqrt(n) along `dim`, in fp32, in x's dtype."""
    x32 = x.float()
    n = x32 / torch.clamp(torch.linalg.vector_norm(x32, dim=dim,
                                                    keepdim=True), min=eps)
    return (n * math.sqrt(x.shape[dim])).to(x.dtype)


def normalize_weight(w: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Each output filter (row of an OIHW conv weight or of an [out, in]
    linear weight) scaled to norm sqrt(fan_in)."""
    flat = w.reshape(w.shape[0], -1)
    normed = flat / torch.clamp(torch.linalg.vector_norm(
        flat, dim=1, keepdim=True), min=eps)
    return (normed * math.sqrt(flat.shape[1])).reshape(w.shape)


@torch.no_grad()
def normalize_karras_params(module: nn.Module) -> nn.Module:
    """Re-project every MPConv / MPLinear weight of `module` in place (after
    an optimizer step)."""
    for m in module.modules():
        if isinstance(m, (MPConv, MPLinear)):
            m.weight.copy_(normalize_weight(m.weight, m.eps))
    return module


def bilinear_resize(x, factor: float):
    """[B, C, H, W] -> [B, C, int(H * factor), int(W * factor)], as
    jax.image.resize(..., "bilinear")."""
    h, w = x.shape[-2:]
    out = F.interpolate(x.float(), size=(int(h * factor), int(w * factor)),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.to(x.dtype)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


class MPConv(nn.Module):
    """Bias-less conv over `spatial_rank` dims (2: images) with forced
    weight normalisation, "same" padding; with `concat_ones_to_input` a
    channel of ones goes in front of the input."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int = 3, *,
                 spatial_rank: int = 2, concat_ones_to_input: bool = False,
                 eps: float = 1e-4, normalize_forward: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.spatial_rank = spatial_rank
        self.concat_ones_to_input = concat_ones_to_input
        self.eps = eps
        self.normalize_forward = normalize_forward
        self.dtype = dtype
        dim_in += int(concat_ones_to_input)
        self.weight = nn.Parameter(torch.randn(
            dim_out, dim_in, *((kernel_size,) * spatial_rank)))

    def forward(self, x):
        if self.concat_ones_to_input:
            x = torch.cat([torch.ones_like(x[:, :1]), x], dim=1)
        w = self.weight
        if self.normalize_forward:
            w = normalize_weight(w, self.eps)
        w = w / math.sqrt(w[0].numel())
        return _CONV[self.spatial_rank](x.to(self.dtype), w.to(self.dtype),
                                        padding=w.shape[-1] // 2)


class MPLinear(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, *, eps: float = 1e-4,
                 normalize_forward: bool = True, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.normalize_forward = normalize_forward
        self.dtype = dtype
        self.weight = nn.Parameter(torch.randn(dim_out, dim_in))

    def forward(self, x):
        w = self.weight
        if self.normalize_forward:
            w = normalize_weight(w, self.eps)
        w = w / math.sqrt(w.shape[1])
        return F.linear(x.to(self.dtype), w.to(self.dtype))


class Gain(nn.Module):
    """x * g, g a learned fp32 scalar initialised to 0; fp32 out."""

    def __init__(self):
        super().__init__()
        self.gain = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return x.float() * self.gain


class MPFourierEmbedding(nn.Module):
    """[B] -> [B, dim]: sqrt(2) (sin, cos) of 2 pi t w, w a frozen normal
    draw."""

    def __init__(self, dim: int):
        super().__init__()
        self.register_buffer("weights", torch.randn(dim // 2))

    def forward(self, t):
        freqs = t.float()[:, None] * self.weights[None, :] * 2 * math.pi
        return torch.cat([freqs.sin(), freqs.cos()], dim=-1) * math.sqrt(2)


class KarrasAttention(nn.Module):
    """Cosine attention over the pixels: pixel-normed q, k and v with 4
    memory key/value tokens, an MP add residual."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64,
                 num_mem_kv: int = 4, mp_add_t: float = 0.3,
                 normalize_forward: bool = True, dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head, self.mp_add_t = heads, dim_head, mp_add_t
        hidden = heads * dim_head
        kw = dict(normalize_forward=normalize_forward, dtype=dtype)
        self.to_qkv = MPConv(dim, hidden * 3, 1, **kw)
        self.mem_kv = nn.Parameter(torch.randn(2, heads, num_mem_kv,
                                               dim_head))
        self.to_out = MPConv(hidden, dim, 1, **kw)

    def forward(self, x):
        b, _, h, w = x.shape
        qkv = self.to_qkv(x).permute(0, 2, 3, 1).contiguous()
        q, k, v = qkv.view(b, h * w, 3, self.heads, self.dim_head).unbind(2)
        k, v = with_memory_tokens(self.mem_kv, k, v)
        q, k, v = (pixel_norm(t, dim=-1) for t in (q, k, v))
        out = self.to_out(from_heads(sdpa(q, k, v), h, w))
        return mp_add(out, x, self.mp_add_t)


def _attention_heads(dim: int, dim_head: int) -> int:
    return max(-(-dim // dim_head), 2)


class _KarrasBlock(nn.Module):
    """What the encoder and decoder blocks share: conv1, the embedding's
    scale, dropout, conv2, the MP add and the optional attention."""

    def __init__(self, dim_in: int, dim_out: int, emb_dim: Optional[int], *,
                 dropout: float, mp_add_t: float, has_attn: bool,
                 attn_dim_head: int, attn_res_mp_add_t: float,
                 normalize_forward: bool, dtype):
        super().__init__()
        kw = dict(normalize_forward=normalize_forward, dtype=dtype)
        self.mp_add_t = mp_add_t
        self.conv1 = MPConv(dim_in, dim_out, 3, **kw)
        if emb_dim is not None:
            self.to_emb = MPLinear(emb_dim, dim_out, **kw)
            self.emb_gain = Gain()
        self.dropout = Dropout(dropout)
        self.conv2 = MPConv(dim_out, dim_out, 3, **kw)
        self.attn = (KarrasAttention(
            dim_out, _attention_heads(dim_out, attn_dim_head), attn_dim_head,
            mp_add_t=attn_res_mp_add_t, **kw) if has_attn else None)

    def residual(self, x, res, emb, deterministic: bool):
        h = self.conv1(mp_silu(x))
        if emb is not None:
            scale = self.emb_gain(self.to_emb(emb)) + 1.0
            h = h * scale[:, :, None, None]
        h = self.conv2(self.dropout(mp_silu(h), deterministic))
        x = mp_add(h, res, self.mp_add_t)
        return self.attn(x) if self.attn is not None else x


class KarrasEncoderBlock(_KarrasBlock):
    def __init__(self, dim_in: int, dim_out: int, emb_dim: Optional[int],
                 *, downsample: bool = False, **kw):
        super().__init__(dim_out, dim_out, emb_dim, **kw)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = MPConv(
                dim_in, dim_out, 1,
                normalize_forward=kw["normalize_forward"], dtype=kw["dtype"])

    def forward(self, x, emb=None, *, deterministic: bool = True):
        if self.downsample:
            x = self.downsample_conv(bilinear_resize(x, 0.5))
        x = pixel_norm(x)
        return self.residual(x, x, emb, deterministic)


class KarrasDecoderBlock(_KarrasBlock):
    def __init__(self, dim_in: int, dim_out: int, emb_dim: Optional[int],
                 *, upsample: bool = False, **kw):
        super().__init__(dim_in, dim_out, emb_dim, **kw)
        self.upsample = upsample
        self.res_conv = (MPConv(dim_in, dim_out, 1,
                                normalize_forward=kw["normalize_forward"],
                                dtype=kw["dtype"])
                         if dim_in != dim_out else None)

    def forward(self, x, emb=None, *, deterministic: bool = True):
        if self.upsample:
            x = bilinear_resize(x, 2.0)
        res = self.res_conv(x) if self.res_conv is not None else x
        return self.residual(x, res, emb, deterministic)


class KarrasUnet(nn.Module):
    """Figure 21 config G: bias-less, norm-free, magnitude preserving.
    forward(x [B,C,H,W], time [B] (EDM's c_noise), self_cond=None,
    class_labels=None, *, deterministic=True) -> [B, C, H, W] fp32;
    dropout only with deterministic=False."""

    # continuous noise conditioning: EDM pairs it with ElucidatedDiffusion
    random_or_learned_sinusoidal_cond = True

    def __init__(
        self,
        image_size: int,
        dim: int = 192,
        dim_max: int = 768,
        num_classes: Optional[int] = None,
        channels: int = 4,
        num_downsamples: int = 3,
        num_blocks_per_stage: int = 4,
        attn_res: Tuple[int, ...] = (16, 8),
        fourier_dim: int = 16,
        attn_dim_head: int = 64,
        mp_cat_t: float = 0.5,
        mp_add_emb_t: float = 0.5,
        attn_res_mp_add_t: float = 0.3,
        resnet_mp_add_t: float = 0.3,
        dropout: float = 0.1,
        self_condition: bool = False,
        normalize_forward: bool = True,
        dtype=torch.float32,
    ):
        super().__init__()
        self.image_size = image_size
        self.channels = channels
        self.num_classes = num_classes
        self.self_condition = self_condition
        self.mp_cat_t = mp_cat_t
        self.mp_add_emb_t = mp_add_emb_t
        self.downsample_factor = 2 ** num_downsamples
        mp = dict(normalize_forward=normalize_forward, dtype=dtype)
        emb_dim = dim * 4
        self.fourier = MPFourierEmbedding(fourier_dim)
        self.to_time_emb = MPLinear(fourier_dim, emb_dim, **mp)
        if num_classes is not None:
            self.to_class_emb = MPLinear(num_classes, emb_dim, **mp)

        # the stage plan of the JAX package (and the reference)
        downs, ups = [], []
        curr_dim, curr_res = dim, image_size
        attn_res = set(attn_res)
        ups.insert(0, (dim, False, False))
        for _ in range(num_blocks_per_stage):
            downs.append((curr_dim, False, False))
            ups.insert(0, (curr_dim, False, False))
        for _ in range(num_downsamples):
            dim_out = min(dim_max, curr_dim * 2)
            ups.insert(0, (curr_dim, curr_res in attn_res, True))
            curr_res //= 2
            has_attn = curr_res in attn_res
            downs.append((dim_out, has_attn, True))
            ups.insert(0, (dim_out, has_attn, False))
            for _ in range(num_blocks_per_stage):
                downs.append((dim_out, has_attn, False))
                ups.insert(0, (dim_out, has_attn, False))
            curr_dim = dim_out

        block = dict(dropout=dropout, attn_dim_head=attn_dim_head,
                     attn_res_mp_add_t=attn_res_mp_add_t,
                     mp_add_t=resnet_mp_add_t, **mp)
        in_channels = channels * (2 if self_condition else 1)
        self.input_block = MPConv(in_channels, dim, 3,
                                  concat_ones_to_input=True, **mp)
        skips, x_dim = [dim], dim
        self.downs = nn.ModuleList()
        for d_out, has_attn, downsample in downs:
            self.downs.append(KarrasEncoderBlock(
                x_dim, d_out, emb_dim, has_attn=has_attn,
                downsample=downsample, **block))
            x_dim = d_out
            skips.append(x_dim)
        self.mids = nn.ModuleList([
            KarrasDecoderBlock(curr_dim, curr_dim, emb_dim,
                               has_attn=curr_res in attn_res, **block)
            for _ in range(2)])
        self.ups = nn.ModuleList()
        for d_out, has_attn, upsample in ups:
            if not upsample:
                x_dim += skips.pop()
            self.ups.append(KarrasDecoderBlock(
                x_dim, d_out, emb_dim, has_attn=has_attn, upsample=upsample,
                **block))
            x_dim = d_out
        self.output_conv = MPConv(x_dim, channels, 3, **mp)
        self.output_gain = Gain()

    def forward(self, x, time, self_cond=None, class_labels=None, *,
                deterministic: bool = True):
        if self.self_condition:
            if self_cond is None:
                self_cond = torch.zeros_like(x)
            x = torch.cat([self_cond, x], dim=1)

        emb = self.to_time_emb(self.fourier(time))
        if self.num_classes is not None:
            if class_labels is None:
                raise ValueError("a class-conditional KarrasUnet needs "
                                 "class_labels")
            if not torch.is_floating_point(class_labels):
                class_labels = F.one_hot(class_labels.long(),
                                         self.num_classes)
            class_labels = class_labels.float() * math.sqrt(self.num_classes)
            emb = mp_add(emb, self.to_class_emb(class_labels),
                         self.mp_add_emb_t)
        emb = mp_silu(emb)

        x = self.input_block(x)
        skips = [x]
        for down in self.downs:
            x = down(x, emb, deterministic=deterministic)
            skips.append(x)
        for mid in self.mids:
            x = mid(x, emb, deterministic=deterministic)
        for up in self.ups:
            if not up.upsample:
                x = mp_cat(x, skips.pop(), t=self.mp_cat_t)
            x = up(x, emb, deterministic=deterministic)
        return self.output_gain(self.output_conv(x))


class MPFeedForward(nn.Module):
    """Pixel norm, MP linear up, MP SiLU, MP linear down, MP add residual,
    over tokens [B, N, D]."""

    def __init__(self, dim: int, mult: int = 4, mp_add_t: float = 0.3,
                 dtype=torch.float32):
        super().__init__()
        self.mp_add_t = mp_add_t
        self.proj_in = MPLinear(dim, dim * mult, dtype=dtype)
        self.proj_out = MPLinear(dim * mult, dim, dtype=dtype)

    def forward(self, x):
        h = self.proj_out(mp_silu(self.proj_in(pixel_norm(x, dim=-1))))
        return mp_add(h, x, self.mp_add_t)


class MPAttentionTokens(nn.Module):
    """Cosine attention over tokens [B, N, D] with 4 memory key/value
    tokens, through `sdpa`."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 64,
                 num_mem_kv: int = 4, mp_add_t: float = 0.3,
                 dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head, self.mp_add_t = heads, dim_head, mp_add_t
        hidden = heads * dim_head
        self.to_qkv = MPLinear(dim, hidden * 3, dtype=dtype)
        self.mem_kv = nn.Parameter(torch.randn(2, heads, num_mem_kv,
                                               dim_head))
        self.to_out = MPLinear(hidden, dim, dtype=dtype)

    def forward(self, x):
        b, n, _ = x.shape
        qkv = self.to_qkv(pixel_norm(x, dim=-1))
        q, k, v = qkv.view(b, n, 3, self.heads, self.dim_head).unbind(2)
        k, v = with_memory_tokens(self.mem_kv, k, v)
        q, k, v = (pixel_norm(t, dim=-1) for t in (q, k, v))
        out = self.to_out(sdpa(q, k, v).reshape(b, n, -1))
        return mp_add(out, x, self.mp_add_t)


class MPTransformer(nn.Module):
    """`depth` MP attention + MP feedforward blocks over [B, N, D]."""

    def __init__(self, dim: int, depth: int, heads: int = 4,
                 dim_head: int = 64, ff_mult: int = 4, mp_add_t: float = 0.3,
                 dtype=torch.float32):
        super().__init__()
        self.attns = nn.ModuleList([
            MPAttentionTokens(dim, heads, dim_head, mp_add_t=mp_add_t,
                              dtype=dtype) for _ in range(depth)])
        self.ffs = nn.ModuleList([
            MPFeedForward(dim, ff_mult, mp_add_t, dtype=dtype)
            for _ in range(depth)])

    def forward(self, x):
        for attn, ff in zip(self.attns, self.ffs):
            x = ff(attn(x))
        return x


def inv_sqrt_decay_schedule(base_lr: float, t_ref: int = 70000,
                            sigma_ref: float = 0.01):
    """step -> the learning rate, EDM2 eq. 67 as the JAX package writes it:
    base_lr * sigma_ref / sqrt(max(step / t_ref, 1))."""

    def fn(step):
        return base_lr * sigma_ref / math.sqrt(max(step / t_ref, 1.0))

    return fn
