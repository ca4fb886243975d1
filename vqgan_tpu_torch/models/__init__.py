from .autoencoder import AutoencoderConfig, DiagonalGaussian, KLVAE
from .unet_cfg import CFGUnet

__all__ = ["AutoencoderConfig", "DiagonalGaussian", "KLVAE", "CFGUnet"]
