"""Build the stage-2 denoiser (the CFG U-Net or the DiT) and its
GaussianDiffusion from an LDMConfig.

Counterpart of `build_cfg_unet_diffusion` in
vqgan_tpu/training/ldm_trainer.py: model_type "unet" is the CFG U-Net,
"dit" the DiT (dim = 4 x cfg.dim, cfg.dit_depth blocks of cfg.attn_heads x
cfg.attn_dim_head, patch cfg.dit_patch_size); both keep one call contract,
so everything downstream is shared. `gradient_checkpointing` recomputes the
whole denoiser forward in the backward pass, as the JAX package wraps its
apply in `jax.checkpoint`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .configs.ldm_config import LDMConfig
from .device import resolve_device
from .diffusion.gaussian import GaussianDiffusion
from .models.dit import DiT
from .models.unet_cfg import CFGUnet, draw_cond_drop_mask

__all__ = ["build_cfg_unet_diffusion", "Rematerialized"]


class Rematerialized(nn.Module):
    """A denoiser whose forward is recomputed in the backward pass
    (`torch.utils.checkpoint`) rather than kept, when a gradient is wanted
    and no features are asked for (the JAX package skips its remat there
    too). The random class dropout is drawn before the checkpointed call:
    the recomputation would restore the global RNG, not an explicit
    generator, and draw another mask. The draw is the model's own, so with
    and without recomputation the same generator gives the same mask. The
    denoiser then draws nothing, so the global RNG state is not stashed
    (`preserve_rng_state=False`): reading it is refused while a CUDA graph
    is captured, and the captured training modes recompute too."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x, time, classes, *,
                cond_drop_mask: Optional[torch.Tensor] = None,
                cond_drop_prob: Optional[float] = None,
                generator: Optional[torch.Generator] = None,
                return_features: bool = False):
        if return_features or not torch.is_grad_enabled():
            return self.model(x, time, classes, cond_drop_mask=cond_drop_mask,
                              cond_drop_prob=cond_drop_prob,
                              generator=generator,
                              return_features=return_features)
        if cond_drop_mask is None:
            p = (self.model.cond_drop_prob if cond_drop_prob is None
                 else cond_drop_prob)
            cond_drop_mask = draw_cond_drop_mask(x.shape[0], p, generator,
                                                 x.device)

        def run(x, time, classes, cond_drop_mask):
            return self.model(x, time, classes, cond_drop_mask=cond_drop_mask)

        return checkpoint(run, x, time, classes, cond_drop_mask,
                          use_reentrant=False, preserve_rng_state=False)


def build_cfg_unet_diffusion(cfg: LDMConfig, dtype=None, device="cuda",
                             gradient_checkpointing: bool = False):
    """(model, diffusion) on `device`, the model in eval mode. With
    `gradient_checkpointing` the diffusion calls the model through
    `Rematerialized`; `model` is the denoiser itself either way."""
    device = resolve_device(device)
    dtype = dtype or (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
    if cfg.model_type == "dit":
        model = DiT(
            dim=cfg.dim * 4, depth=cfg.dit_depth, heads=cfg.attn_heads,
            dim_head=cfg.attn_dim_head, patch_size=cfg.dit_patch_size,
            image_size=cfg.latent_size, channels=cfg.latent_channels,
            num_classes=cfg.num_users, cond_drop_prob=cfg.cond_drop_prob,
            dtype=dtype)
    elif cfg.model_type == "unet":
        model = CFGUnet(
            dim=cfg.dim, num_classes=cfg.num_users,
            cond_drop_prob=cfg.cond_drop_prob, dim_mults=tuple(cfg.dim_mults),
            channels=cfg.latent_channels, attn_dim_head=cfg.attn_dim_head,
            attn_heads=cfg.attn_heads, dtype=dtype)
    else:
        raise ValueError(f"model_type must be 'unet' or 'dit', got "
                         f"{cfg.model_type!r}")
    model = model.to(device).eval()
    diffusion = GaussianDiffusion(
        Rematerialized(model) if gradient_checkpointing else model,
        image_size=cfg.latent_size, channels=cfg.latent_channels,
        timesteps=cfg.timesteps, sampling_timesteps=cfg.sampling_timesteps,
        objective=cfg.objective, beta_schedule=cfg.beta_schedule,
        min_snr_loss_weight=cfg.min_snr_loss_weight,
        min_snr_gamma=cfg.min_snr_gamma, auto_normalize=cfg.auto_normalize,
        device=device,
    )
    return model, diffusion
