from .autoencoder import AutoencoderConfig, DiagonalGaussian, KLVAE, kl_vae_loss
from .discriminator import MultiScaleDiscriminator, PatchGANDiscriminator
from .dit import DiT, DiTBlock
from .karras_unet import KarrasUnet, MPTransformer
from .karras_unet_nd import KarrasUnet1D, KarrasUnet3D
from .lpips import LPIPS
from .unet import Unet
from .unet1d import Unet1D
from .unet_cfg import CFGUnet
from .uvit import UViT
from .vq_vae import VQVAE, VectorQuantizer

__all__ = ["AutoencoderConfig", "DiagonalGaussian", "KLVAE", "CFGUnet",
           "DiT", "DiTBlock", "KarrasUnet", "KarrasUnet1D", "KarrasUnet3D",
           "MPTransformer", "Unet", "Unet1D", "UViT",
           "LPIPS", "MultiScaleDiscriminator", "PatchGANDiscriminator",
           "VQVAE", "VectorQuantizer", "kl_vae_loss"]
