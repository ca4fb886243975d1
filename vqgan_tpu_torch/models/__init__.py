from .autoencoder import AutoencoderConfig, DiagonalGaussian, KLVAE, kl_vae_loss
from .discriminator import MultiScaleDiscriminator, PatchGANDiscriminator
from .dit import DiT, DiTBlock
from .karras_unet import KarrasUnet, MPTransformer
from .lpips import LPIPS
from .unet import Unet
from .unet_cfg import CFGUnet
from .vq_vae import VQVAE, VectorQuantizer

__all__ = ["AutoencoderConfig", "DiagonalGaussian", "KLVAE", "CFGUnet",
           "DiT", "DiTBlock", "KarrasUnet", "MPTransformer", "Unet",
           "LPIPS", "MultiScaleDiscriminator", "PatchGANDiscriminator",
           "VQVAE", "VectorQuantizer", "kl_vae_loss"]
