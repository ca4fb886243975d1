from .from_jax import (
    cfg_unet_state_from_jax,
    ddpm_unet_state_from_jax,
    dit_state_from_jax,
    inception_state_from_jax,
    karras_unet_nd_state_from_jax,
    karras_unet_state_from_jax,
    klvae_state_from_jax,
    learned_log_snr_state_from_jax,
    lpips_state_from_jax,
    patchgan_state_from_jax,
    resnet_state_from_jax,
    unet1d_state_from_jax,
    uvit_state_from_jax,
    vqvae_state_from_jax,
)
from .load import load_weights, read_state_dict
from .manager import CheckpointManager
from .train_state import optimizer_state_from_jax, train_state_from_jax

__all__ = ["CheckpointManager", "cfg_unet_state_from_jax",
           "ddpm_unet_state_from_jax", "dit_state_from_jax",
           "karras_unet_state_from_jax", "karras_unet_nd_state_from_jax",
           "learned_log_snr_state_from_jax", "unet1d_state_from_jax",
           "uvit_state_from_jax",
           "inception_state_from_jax", "klvae_state_from_jax",
           "load_weights", "lpips_state_from_jax",
           "optimizer_state_from_jax", "patchgan_state_from_jax",
           "read_state_dict", "resnet_state_from_jax",
           "train_state_from_jax", "vqvae_state_from_jax"]
