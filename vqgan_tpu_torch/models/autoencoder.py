"""Conv encoder/decoder trunk and the KL-VAE.

Counterpart of vqgan_tpu/models/autoencoder.py, NCHW inside. The public
image functions (`encode_images`, `encode_images_mean`, `decode_latents`)
take and return NHWC like the JAX package; `encode`/`decode` are the NCHW
module methods. Parameter names are the reference `KL_VAE`'s
(`encoder.down.{i}.block.{j}.conv1`, `decoder.up.{i}.upsample`, ...).
`kl_vae_loss` is the stage-1 training loss of the JAX package's
`kl_vae_loss`, over NCHW tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import draw_rows
from .layers import (
    AttnBlock,
    Conv2d,
    Downsample,
    GroupNorm,
    ResnetBlock,
    UpsampleTranspose,
)

__all__ = ["AutoencoderConfig", "Encoder", "Decoder", "DiagonalGaussian",
           "KLVAE", "kl_vae_loss"]


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    """Topology shared by encoder and decoder."""

    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    dropout: float = 0.0
    resolution: int = 256  # resolution assumed for attention placement
    z_channels: int = 4
    in_ch: int = 3
    out_ch: int = 3
    double_z: bool = True
    final_sigmoid: bool = False


class _Mid(nn.Module):
    def __init__(self, channels: int, dtype, dropout: float = 0.0):
        super().__init__()
        self.block_1 = ResnetBlock(channels, dtype=dtype, dropout=dropout)
        self.attn_1 = AttnBlock(channels, dtype=dtype)
        self.block_2 = ResnetBlock(channels, dtype=dtype, dropout=dropout)

    def forward(self, h, deterministic: bool = True, generator=None):
        h = self.block_1(h, deterministic, generator)
        return self.block_2(self.attn_1(h), deterministic, generator)


class _Level(nn.Module):
    """One resolution: res blocks, attention after each where the tracked
    resolution is in attn_resolutions, then an optional resampler."""

    def __init__(self, blocks, attns, resample_name=None, resample=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)
        if resample is not None:
            self.add_module(resample_name, resample)
        self.resample_name = resample_name if resample is not None else None

    def forward(self, h, deterministic: bool = True, generator=None):
        for i, block in enumerate(self.block):
            h = block(h, deterministic, generator)
            if len(self.attn):
                h = self.attn[i](h)
        if self.resample_name is not None:
            h = getattr(self, self.resample_name)(h)
        return h


class Encoder(nn.Module):
    def __init__(self, cfg: AutoencoderConfig, dtype=torch.float32):
        super().__init__()
        self.conv_in = Conv2d(cfg.in_ch, cfg.ch, 3, padding=1, dtype=dtype)
        curr_res = cfg.resolution
        block_in = cfg.ch
        levels = []
        for i_level, mult in enumerate(cfg.ch_mult):
            block_out = cfg.ch * mult
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(block_in, block_out, dtype=dtype,
                                          dropout=cfg.dropout))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    attns.append(AttnBlock(block_in, dtype=dtype))
            down = None
            if i_level != len(cfg.ch_mult) - 1:
                down = Downsample(block_in, dtype=dtype)
                curr_res //= 2
            levels.append(_Level(blocks, attns, "downsample", down))
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(block_in, dtype, cfg.dropout)
        self.norm_out = GroupNorm(block_in)
        out_ch = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1, dtype=dtype)
        self.dtype = dtype

    def forward(self, x, deterministic: bool = True, generator=None):
        h = self.conv_in(x.to(self.dtype))
        for level in self.down:
            h = level(h, deterministic, generator)
        h = self.mid(h, deterministic, generator)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: AutoencoderConfig, dtype=torch.float32):
        super().__init__()
        n = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        curr_res = cfg.resolution // 2 ** (n - 1)
        self.conv_in = Conv2d(cfg.z_channels, block_in, 3, padding=1,
                              dtype=dtype)
        self.mid = _Mid(block_in, dtype, cfg.dropout)
        levels = [None] * n
        for i_level in reversed(range(n)):
            block_out = cfg.ch * cfg.ch_mult[i_level]
            blocks, attns = [], []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, block_out, dtype=dtype,
                                          dropout=cfg.dropout))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    attns.append(AttnBlock(block_in, dtype=dtype))
            up = None
            if i_level != 0:
                up = UpsampleTranspose(block_in, dtype=dtype)
                curr_res *= 2
            levels[i_level] = _Level(blocks, attns, "upsample", up)
        self.up = nn.ModuleList(levels)  # indexed by level, run top-down
        self.norm_out = GroupNorm(block_in)
        self.conv_out = Conv2d(block_in, cfg.out_ch, 3, padding=1,
                               dtype=dtype)
        self.final_sigmoid = cfg.final_sigmoid
        self.dtype = dtype

    def forward(self, z, deterministic: bool = True, generator=None):
        h = self.mid(self.conv_in(z.to(self.dtype)), deterministic, generator)
        for level in reversed(self.up):
            h = level(h, deterministic, generator)
        h = self.conv_out(F.silu(self.norm_out(h)))
        return torch.sigmoid(h) if self.final_sigmoid else h


class DiagonalGaussian:
    """Diagonal Gaussian posterior from (mean, logvar) moments concatenated on
    the channel axis (dim 1, NCHW); logvar clamped to [-30, 20]."""

    def __init__(self, parameters: torch.Tensor, deterministic: bool = False):
        mean, logvar = torch.chunk(parameters, 2, dim=1)
        self.mean = mean.float()
        self.logvar = torch.clamp(logvar.float(), -30.0, 20.0)
        self.deterministic = deterministic
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)
        if deterministic:
            self.std = self.var = torch.zeros_like(self.mean)

    def sample(self, generator: torch.Generator | None = None,
               noise=None):
        """mean + std * noise, the noise drawn from `generator` unless
        given (a tensor or array of the mean's shape); inside
        `parallel.mesh.global_batch`, this rank's rows of the global
        batch's draw."""
        if noise is None:
            noise = draw_rows(lambda shape: torch.randn(
                shape, generator=generator, device=self.mean.device,
                dtype=torch.float32), self.mean.shape)
        else:
            noise = torch.as_tensor(noise, dtype=torch.float32,
                                    device=self.mean.device)
        return self.mean + self.std * noise

    def kl(self) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros(self.mean.shape[0], device=self.mean.device)
        return 0.5 * torch.sum(self.mean**2 + self.var - 1.0 - self.logvar,
                               dim=tuple(range(1, self.mean.ndim)))


class KLVAE(nn.Module):
    """SD-style AutoencoderKL. `encode_images` applies `scale_factor`
    (0.18215); `decode_latents` removes it and clamps to [0, 1]."""

    def __init__(self, config: AutoencoderConfig = AutoencoderConfig(),
                 scale_factor: float = 0.18215, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.scale_factor = scale_factor
        self.dtype = dtype
        self.encoder = Encoder(dataclasses.replace(config, double_z=True),
                               dtype)
        self.decoder = Decoder(config, dtype)
        self.quant_conv = Conv2d(2 * config.z_channels, 2 * config.z_channels,
                                 1, dtype=dtype)
        self.post_quant_conv = Conv2d(config.z_channels, config.z_channels, 1,
                                      dtype=dtype)

    def encode(self, x, *, deterministic: bool = True,
               generator=None) -> DiagonalGaussian:
        """NCHW images -> posterior over NCHW latents. Dropout runs only
        under deterministic=False, its masks drawn from `generator`."""
        return DiagonalGaussian(self.quant_conv(
            self.encoder(x, deterministic, generator)))

    def decode(self, z, *, deterministic: bool = True, generator=None):
        """NCHW latents -> NCHW images."""
        return self.decoder(self.post_quant_conv(z.to(self.dtype)),
                            deterministic, generator)

    def forward(self, x, *, generator=None, noise=None,
                sample_posterior: bool = True, deterministic: bool = True):
        """NCHW images -> (NCHW reconstruction, posterior); the latent is
        sampled with `noise` (NCHW) or from `generator`, which also draws
        the dropout masks under deterministic=False."""
        posterior = self.encode(x, deterministic=deterministic,
                                generator=generator)
        z = (posterior.sample(generator, noise) if sample_posterior
             else posterior.mean)
        return self.decode(z, deterministic=deterministic,
                           generator=generator), posterior

    def encode_images(self, x, *, generator=None):
        """NHWC images in [0, 1] -> scaled NHWC latents."""
        z = self.encode(x.permute(0, 3, 1, 2)).sample(generator)
        return (z * self.scale_factor).permute(0, 2, 3, 1)

    def encode_images_mean(self, x):
        """Deterministic variant (posterior mean), NHWC in and out."""
        z = self.encode(x.permute(0, 3, 1, 2)).mean
        return (z * self.scale_factor).permute(0, 2, 3, 1)

    def decode_latents(self, z):
        """Scaled NHWC latents -> NHWC images clamped to [0, 1]."""
        x = self.decode(z.permute(0, 3, 1, 2) / self.scale_factor)
        return torch.clamp(x, 0.0, 1.0).permute(0, 2, 3, 1)


def kl_vae_loss(recon, inputs, posterior: DiagonalGaussian,
                kl_weight: float = 1e-6, perceptual_fn=None) -> dict:
    """MSE (or the pluggable `perceptual_fn(recon, inputs)` -> {"total",
    optional "perceptual"}) plus kl_weight * the batch mean of the KL, as
    vqgan_tpu/models/autoencoder.py:kl_vae_loss. Returns 0-d tensors under
    "loss", "rec_loss", "kl_loss" and "perceptual_loss"."""
    zero = torch.zeros((), device=recon.device)
    if perceptual_fn is not None:
        parts = perceptual_fn(recon, inputs)
        rec_loss = parts["total"]
        perceptual = parts.get("perceptual", zero)
    else:
        rec_loss = torch.mean((inputs - recon) ** 2)
        perceptual = zero
    kl = torch.mean(posterior.kl())
    return {"loss": rec_loss + kl_weight * kl, "rec_loss": rec_loss,
            "kl_loss": kl, "perceptual_loss": perceptual}
