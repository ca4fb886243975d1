"""Karras magnitude-preserving U-Nets for sequences (1-D) and video (3-D).

Counterpart of vqgan_tpu/models/karras_unet_nd.py, channels first inside
([B, C, L] and [B, C, T, H, W]; the JAX package's [B, L, C] and [B, T, H,
W, C] with the channels moved): `MPConvND`, cosine attention with 4 memory
key/value tokens and pixel-normed q, k and v over all positions or, for
video, factorised into a pass over space (per frame) and one over time
(per pixel), the shared encoder / decoder block, and the stage plan with
the 3-D per-stage downsampling ("all", "frame", "image"). The MP ops are
those of `models/karras_unet.py`; `MPConvND` is its `MPConv` at rank 1 or
3.

- Resizing is `jax.image.resize(..., "linear")`'s: separable, a triangle
  filter widened by 1 / scale when downsampling (antialiasing), weights
  renormalised at the borders; each axis is a product with that [in, out]
  weight matrix, in fp32.
- Dropout (default 0.1) runs only with `deterministic=False`, as in the
  JAX package, whose trainers never pass it.
- The JAX package gives these models no diffusion wrapper (its EDM is 2-D
  only), so the port gives them forward and gradients.

The names are the port's; `checkpoint/from_jax.karras_unet_nd_state_from_jax`
maps the JAX tree onto them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from .karras_unet import (
    Gain,
    MPConv,
    MPFourierEmbedding,
    MPLinear,
    _attention_heads,
    mp_add,
    mp_cat,
    mp_silu,
    pixel_norm,
)
from .layers import Dropout, with_memory_tokens

__all__ = ["MPConvND", "resize_nd", "KarrasUnet1D", "KarrasUnet3D"]

class MPConvND(MPConv):
    """`MPConv` over `spatial_rank` dims, under the JAX package's name."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int,
                 spatial_rank: int, **kwargs):
        super().__init__(dim_in, dim_out, kernel_size,
                         spatial_rank=spatial_rank, **kwargs)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] fp32 weights of jax.image.resize's antialiased linear
    resize along one axis (scale n_out / n_in, no translation)."""
    scale = np.float32(n_out / n_in)
    inv = np.float32(1.0) / scale
    kernel_scale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]
               ) / kernel_scale
    w = np.maximum(0.0, 1.0 - x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_nd(x, factors):
    """[B, C, *spatial] -> each spatial size times its factor (int()), as
    jax.image.resize(..., "linear") does it; fp32 math, x's dtype out."""
    out = x.float()
    for i, f in enumerate(factors):
        axis = 2 + i
        n_in = out.shape[axis]
        n_out = int(n_in * f)
        if n_out == n_in:
            continue
        w = torch.from_numpy(_resize_weights(n_in, n_out)).to(out.device)
        out = (out.movedim(axis, -1) @ w).movedim(-1, axis)
    return out.to(x.dtype)


class KarrasAttentionND(nn.Module):
    """Cosine attention: over all positions, or for video (`only_space`)
    over the pixels of each frame or (`only_time`) over the frames of each
    pixel. q, k and v are pixel-normed after 4 memory tokens go in front
    of k and v; an MP add residual."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64,
                 num_mem_kv: int = 4, mp_add_t: float = 0.3,
                 spatial_rank: int = 2, only_space: bool = False,
                 only_time: bool = False, dtype=torch.float32):
        super().__init__()
        if only_space and only_time:
            raise ValueError("only_space and only_time exclude each other")
        self.heads, self.dim_head, self.mp_add_t = heads, dim_head, mp_add_t
        self.factorized = "space" if only_space else (
            "time" if only_time else None)
        if self.factorized is not None and spatial_rank != 3:
            raise ValueError("factorised attention needs video")
        hidden = heads * dim_head
        self.to_qkv = MPConvND(dim, hidden * 3, 1, spatial_rank, dtype=dtype)
        self.mem_kv = nn.Parameter(torch.randn(2, heads, num_mem_kv,
                                               dim_head))
        self.to_out = MPConvND(hidden, dim, 1, spatial_rank, dtype=dtype)

    def forward(self, x):
        qkv = self.to_qkv(x).movedim(1, -1)  # [B, *spatial, 3 * hidden]
        spatial = qkv.shape[1:-1]
        if self.factorized == "space":
            b, t, h, w, c3 = qkv.shape
            qkv = qkv.reshape(b * t, h * w, c3)
        elif self.factorized == "time":
            b, t, h, w, c3 = qkv.shape
            qkv = qkv.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c3)
        else:
            qkv = qkv.reshape(qkv.shape[0], -1, qkv.shape[-1])
        bb, n, _ = qkv.shape
        q, k, v = qkv.contiguous().view(bb, n, 3, self.heads,
                                        self.dim_head).unbind(2)
        k, v = with_memory_tokens(self.mem_kv, k, v)
        q, k, v = (pixel_norm(z, dim=-1) for z in (q, k, v))
        out = sdpa(q, k, v).reshape(bb, n, -1)
        if self.factorized == "time":
            out = out.reshape(b, h, w, t, -1).permute(0, 3, 1, 2, 4)
        out = out.reshape(x.shape[0], *spatial, -1).movedim(-1, 1)
        return mp_add(self.to_out(out), x, self.mp_add_t)


class _EncDecBlockND(nn.Module):
    """The MP encoder / decoder block: an optional resize (and, in the
    encoder, a 1x1 conv to dim_out), pixel norm (encoder) or a 1x1
    residual conv (decoder, when the channels change), conv, the
    embedding's scale, MP SiLU, dropout, conv, MP add, optional
    attention."""

    def __init__(self, dim_in: int, dim_out: int, emb_dim: int, *,
                 is_decoder: bool, spatial_rank: int, dropout: float,
                 mp_add_t: float, has_attn: bool, attn_dim_head: int,
                 attn_res_mp_add_t: float, factorize_space_time_attn: bool,
                 resample_factors: Optional[Tuple[float, ...]], dtype):
        super().__init__()
        self.is_decoder = is_decoder
        self.mp_add_t = mp_add_t
        self.resample_factors = resample_factors
        sr = spatial_rank
        if resample_factors is not None and not is_decoder:
            self.downsample_conv = MPConvND(dim_in, dim_out, 1, sr,
                                            dtype=dtype)
            dim_in = dim_out
        self.res_conv = (MPConvND(dim_in, dim_out, 1, sr, dtype=dtype)
                         if is_decoder and dim_in != dim_out else None)
        self.conv1 = MPConvND(dim_in, dim_out, 3, sr, dtype=dtype)
        self.to_emb = MPLinear(emb_dim, dim_out, dtype=dtype)
        self.emb_gain = Gain()
        self.dropout = Dropout(dropout)
        self.conv2 = MPConvND(dim_out, dim_out, 3, sr, dtype=dtype)
        self.attns = nn.ModuleList()
        if has_attn:
            kw = dict(heads=_attention_heads(dim_out, attn_dim_head),
                      dim_head=attn_dim_head, mp_add_t=attn_res_mp_add_t,
                      spatial_rank=sr, dtype=dtype)
            if sr == 3 and factorize_space_time_attn:
                self.attns.append(KarrasAttentionND(dim_out, only_space=True,
                                                    **kw))
                self.attns.append(KarrasAttentionND(dim_out, only_time=True,
                                                    **kw))
            else:
                self.attns.append(KarrasAttentionND(dim_out, **kw))

    def forward(self, x, emb, deterministic: bool = True):
        if self.resample_factors is not None:
            x = resize_nd(x, self.resample_factors)
            if not self.is_decoder:
                x = self.downsample_conv(x)
        if not self.is_decoder:
            x = pixel_norm(x)
            res = x
        else:
            res = self.res_conv(x) if self.res_conv is not None else x
        h = self.conv1(mp_silu(x))
        scale = self.emb_gain(self.to_emb(emb)) + 1.0
        h = h * scale.reshape(*scale.shape, *((1,) * (h.ndim - 2)))
        h = self.conv2(self.dropout(mp_silu(h), deterministic))
        x = mp_add(h, res, self.mp_add_t)
        for attn in self.attns:
            x = attn(x)
        return x


_DOWNSAMPLE_3D = {"all": (0.5, 0.5, 0.5), "frame": (0.5, 1.0, 1.0),
                  "image": (1.0, 0.5, 0.5)}


class _KarrasUnetND(nn.Module):
    """forward(x [B, C, *spatial], time [B], self_cond=None,
    class_labels=None, *, deterministic=True) -> [B, C, *spatial] fp32."""

    spatial_rank = 2

    def __init__(self, spatial_size: Tuple[int, ...], dim: int = 192,
                 dim_max: int = 768, num_classes: Optional[int] = None,
                 channels: int = 4, num_downsamples: int = 3,
                 num_blocks_per_stage: int = 4,
                 attn_res: Tuple[int, ...] = (16, 8), fourier_dim: int = 16,
                 attn_dim_head: int = 64, mp_cat_t: float = 0.5,
                 mp_add_emb_t: float = 0.5, attn_res_mp_add_t: float = 0.3,
                 resnet_mp_add_t: float = 0.3, dropout: float = 0.1,
                 self_condition: bool = False,
                 downsample_types: Optional[Tuple[str, ...]] = None,
                 factorize_space_time_attn: bool = False,
                 dtype=torch.float32):
        super().__init__()
        sr = self.spatial_rank
        self.spatial_size = tuple(spatial_size)
        self.channels = channels
        self.num_classes = num_classes
        self.self_condition = self_condition
        self.mp_cat_t = mp_cat_t
        self.mp_add_emb_t = mp_add_emb_t
        emb_dim = dim * 4
        self.fourier = MPFourierEmbedding(fourier_dim)
        self.to_time_emb = MPLinear(fourier_dim, emb_dim, dtype=dtype)
        if num_classes is not None:
            self.to_class_emb = MPLinear(num_classes, emb_dim, dtype=dtype)

        types = downsample_types or ("all",) * num_downsamples
        if any(t not in _DOWNSAMPLE_3D for t in types):
            raise ValueError(f"unknown downsample types {types}")
        # the stage plan of the JAX package: (dim_out, has_attn, factors)
        downs, ups = [], []
        curr_dim, curr_res = dim, self.spatial_size[-1]
        attn_res = set(attn_res)
        ups.insert(0, (dim, False, None))
        for _ in range(num_blocks_per_stage):
            downs.append((curr_dim, False, None))
            ups.insert(0, (curr_dim, False, None))
        for _, ds_type in zip(range(num_downsamples), types):
            dim_out = min(dim_max, curr_dim * 2)
            df = _DOWNSAMPLE_3D[ds_type] if sr == 3 else (0.5,) * sr
            uf = tuple(1.0 / f for f in df)
            ups.insert(0, (curr_dim, curr_res in attn_res, uf))
            if df[-1] != 1.0:
                curr_res //= 2
            has_attn = curr_res in attn_res
            downs.append((dim_out, has_attn, df))
            ups.insert(0, (dim_out, has_attn, None))
            for _ in range(num_blocks_per_stage):
                downs.append((dim_out, has_attn, None))
                ups.insert(0, (dim_out, has_attn, None))
            curr_dim = dim_out

        block = dict(spatial_rank=sr, dropout=dropout,
                     attn_dim_head=attn_dim_head,
                     attn_res_mp_add_t=attn_res_mp_add_t,
                     mp_add_t=resnet_mp_add_t,
                     factorize_space_time_attn=factorize_space_time_attn,
                     dtype=dtype)
        in_channels = channels * (2 if self_condition else 1)
        self.input_block = MPConvND(in_channels, dim, 3, sr,
                                    concat_ones_to_input=True, dtype=dtype)
        skips, x_dim = [dim], dim
        self.downs = nn.ModuleList()
        for d_out, has_attn, factors in downs:
            self.downs.append(_EncDecBlockND(
                x_dim, d_out, emb_dim, is_decoder=False, has_attn=has_attn,
                resample_factors=factors, **block))
            x_dim = d_out
            skips.append(x_dim)
        self.mids = nn.ModuleList([
            _EncDecBlockND(curr_dim, curr_dim, emb_dim, is_decoder=True,
                           has_attn=curr_res in attn_res,
                           resample_factors=None, **block)
            for _ in range(2)])
        self.ups = nn.ModuleList()
        for d_out, has_attn, factors in ups:
            if factors is None:
                x_dim += skips.pop()
            self.ups.append(_EncDecBlockND(
                x_dim, d_out, emb_dim, is_decoder=True, has_attn=has_attn,
                resample_factors=factors, **block))
            x_dim = d_out
        self.output_conv = MPConvND(x_dim, channels, 3, sr, dtype=dtype)
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
                raise ValueError("a class-conditional model needs "
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
            x = down(x, emb, deterministic)
            skips.append(x)
        for mid in self.mids:
            x = mid(x, emb, deterministic)
        for up in self.ups:
            if up.resample_factors is None:
                x = mp_cat(x, skips.pop(), t=self.mp_cat_t)
            x = up(x, emb, deterministic)
        return self.output_gain(self.output_conv(x))


class KarrasUnet1D(_KarrasUnetND):
    """The MP U-Net over [B, C, L] sequences."""

    spatial_rank = 1

    def __init__(self, spatial_size: Tuple[int, ...] = (64,), **kw):
        super().__init__(spatial_size, **kw)


class KarrasUnet3D(_KarrasUnetND):
    """The MP U-Net over [B, C, T, H, W] video, with per-stage "all" /
    "frame" / "image" downsampling and optional factorised space / time
    attention."""

    spatial_rank = 3

    def __init__(self, spatial_size: Tuple[int, ...] = (16, 32, 32), **kw):
        super().__init__(spatial_size, **kw)
