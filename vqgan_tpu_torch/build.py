"""Build the CFG U-Net and its GaussianDiffusion from an LDMConfig.

Counterpart of `build_cfg_unet_diffusion` in
vqgan_tpu/training/ldm_trainer.py (model_type "unet"; the DiT waits for a
later slice).
"""

from __future__ import annotations

import torch

from .configs.ldm_config import LDMConfig
from .device import resolve_device
from .diffusion.gaussian import GaussianDiffusion
from .models.unet_cfg import CFGUnet

__all__ = ["build_cfg_unet_diffusion"]


def build_cfg_unet_diffusion(cfg: LDMConfig, dtype=None, device="cuda"):
    """(model, diffusion) on `device`, the model in eval mode."""
    device = resolve_device(device)
    if cfg.model_type != "unet":
        raise NotImplementedError(
            f"model_type {cfg.model_type!r} is not ported yet; use 'unet'")
    dtype = dtype or (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
    model = CFGUnet(
        dim=cfg.dim, num_classes=cfg.num_users,
        cond_drop_prob=cfg.cond_drop_prob, dim_mults=tuple(cfg.dim_mults),
        channels=cfg.latent_channels, attn_dim_head=cfg.attn_dim_head,
        attn_heads=cfg.attn_heads, dtype=dtype,
    ).to(device).eval()
    diffusion = GaussianDiffusion(
        model, image_size=cfg.latent_size, channels=cfg.latent_channels,
        timesteps=cfg.timesteps, sampling_timesteps=cfg.sampling_timesteps,
        objective=cfg.objective, beta_schedule=cfg.beta_schedule,
        min_snr_loss_weight=cfg.min_snr_loss_weight,
        min_snr_gamma=cfg.min_snr_gamma, auto_normalize=cfg.auto_normalize,
        device=device,
    )
    return model, diffusion
