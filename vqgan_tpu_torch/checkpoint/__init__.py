from .from_jax import cfg_unet_state_from_jax, klvae_state_from_jax
from .load import load_weights, read_state_dict

__all__ = ["cfg_unet_state_from_jax", "klvae_state_from_jax", "load_weights",
           "read_state_dict"]
