"""VQ-VAE: the shared conv trunk around a vector quantizer.

Counterpart of vqgan_tpu/models/vq_vae.py, NCHW inside like the port's
KL-VAE: `encode`, `encode_pre_quant`, `decode`, `forward`,
`encode_to_indices` and `decode_from_indices` take and return NCHW;
`encode_images` and `decode_latents` take and return NHWC like the JAX
package. Parameter names are those of the reference PyTorch VQVAE
(`encoder.*`, `decoder.*`, `quantizer.embedding.weight`, and
`pre_quant_conv` / `post_quant_conv` where z_channels != embedding_dim).

The lookup runs through `ops.vq.vq_lookup` (the nearest-code kernel on
CUDA); the straight-through estimator and the codebook and commitment
losses are composed here. `loss_convention`:
- "paper": vq_loss = mse(z_q, sg(z)) + beta * mse(sg(z_q), z), the
  codebook trained by the unweighted term;
- "reference": the reference implementation's swapped stop-gradients, beta
  weighting the codebook update. The loss value is the same; only the
  gradient routing differs (see the JAX module's note).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.vq import vq_lookup
from .autoencoder import AutoencoderConfig, Decoder, Encoder
from .layers import Conv2d

__all__ = ["VQVAE", "VectorQuantizer"]


class VectorQuantizer(nn.Module):
    """Codebook `embedding.weight` [K, D], initialised U(-1/K, 1/K).
    forward takes NCHW z and returns (z_q_ste NCHW in z's dtype, loss dict,
    indices [B, h, w] int32)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 commitment_cost: float = 0.25,
                 loss_convention: str = "paper"):
        super().__init__()
        if loss_convention not in ("paper", "reference"):
            raise ValueError(f"loss_convention must be 'paper' or "
                             f"'reference', got {loss_convention!r}")
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.commitment_cost = commitment_cost
        self.loss_convention = loss_convention
        self.embedding = nn.Embedding(num_embeddings, embedding_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / num_embeddings,
                         1.0 / num_embeddings)

    def forward(self, z):
        b, c, h, w = z.shape
        z32 = z.float()
        z_flat = z32.permute(0, 2, 3, 1).reshape(-1, c)
        z_q_flat, idx, usage = vq_lookup(z_flat, self.embedding.weight)
        z_q = z_q_flat.reshape(b, h, w, c).permute(0, 3, 1, 2)

        to_codebook = torch.mean((z_q - z32.detach()) ** 2)
        to_encoder = torch.mean((z_q.detach() - z32) ** 2)
        if self.loss_convention == "reference":
            codebook_loss, commitment_loss = to_encoder, to_codebook
        else:
            codebook_loss, commitment_loss = to_codebook, to_encoder
        vq_loss = codebook_loss + self.commitment_cost * commitment_loss
        z_q_ste = z32 + (z_q - z32).detach()

        loss_dict = {
            "usage_counts": usage,  # [K] int32, for dead-code revival
            "vq_loss": vq_loss,
            "codebook_loss": codebook_loss.detach(),
            "commitment_loss": commitment_loss.detach(),
            "codebook_usage_ratio": (usage > 0).float().mean(),
        }
        return z_q_ste.to(z.dtype), loss_dict, idx.reshape(b, h, w)

    def lookup(self, indices):
        """indices [B, h, w] -> z_q [B, h, w, D] (NHWC, as in JAX)."""
        return self.embedding.weight[indices.long()]


class VQVAE(nn.Module):
    """Encoder -> pre-quant 1x1 -> VQ -> post-quant 1x1 -> Decoder(sigmoid).
    Defaults are VQGANConfig's: ch 128, mults 1-2-2-4, z 256, codebook
    128 x 256, beta 0.25, a sigmoid head forcing [0, 1] output."""

    def __init__(self, ch: int = 128, ch_mult: Tuple[int, ...] = (1, 2, 2, 4),
                 num_res_blocks: int = 2,
                 attn_resolutions: Tuple[int, ...] = (16,),
                 dropout: float = 0.0, resolution: int = 256,
                 z_channels: int = 256, num_embeddings: int = 128,
                 embedding_dim: int = 256, commitment_cost: float = 0.25,
                 out_channels: int = 3, loss_convention: str = "paper",
                 dtype=torch.float32):
        super().__init__()
        cfg = AutoencoderConfig(
            ch=ch, ch_mult=tuple(ch_mult), num_res_blocks=num_res_blocks,
            attn_resolutions=tuple(attn_resolutions), dropout=dropout,
            resolution=resolution, z_channels=z_channels,
            out_ch=out_channels, double_z=False, final_sigmoid=True)
        self.encoder = Encoder(cfg, dtype)
        self.decoder = Decoder(cfg, dtype)
        if z_channels != embedding_dim:
            self.pre_quant_conv = Conv2d(z_channels, embedding_dim, 1,
                                         dtype=dtype)
            self.post_quant_conv = Conv2d(embedding_dim, z_channels, 1,
                                          dtype=dtype)
        else:
            self.pre_quant_conv = self.post_quant_conv = nn.Identity()
        self.quantizer = VectorQuantizer(num_embeddings, embedding_dim,
                                         commitment_cost, loss_convention)

    def encode(self, x, *, deterministic: bool = True, generator=None):
        """NCHW images -> (z_q NCHW, indices [B, h, w], loss dict). Dropout
        runs only under deterministic=False, its masks drawn from
        `generator`."""
        z = self.pre_quant_conv(self.encoder(x, deterministic, generator))
        z_q, loss_dict, indices = self.quantizer(z)
        return self.post_quant_conv(z_q), indices, loss_dict

    def encode_pre_quant(self, x, *, deterministic: bool = True,
                         generator=None):
        """NCHW images -> pre-quant encoder features, NCHW: the candidate
        pool for dead-code revival."""
        return self.pre_quant_conv(self.encoder(x, deterministic, generator))

    def decode(self, z_q, *, deterministic: bool = True, generator=None):
        return self.decoder(z_q, deterministic, generator)

    def forward(self, x, *, deterministic: bool = True, generator=None):
        """NCHW images -> (reconstruction NCHW, loss dict, indices)."""
        z_q, indices, loss_dict = self.encode(
            x, deterministic=deterministic, generator=generator)
        return (self.decode(z_q, deterministic=deterministic,
                            generator=generator), loss_dict, indices)

    def encode_to_indices(self, x):
        return self.encode(x)[1]

    def decode_from_indices(self, indices):
        """indices [B, h, w] -> NCHW images."""
        z_q = self.quantizer.lookup(indices).permute(0, 3, 1, 2)
        return self.decode(self.post_quant_conv(z_q))

    def encode_images(self, x):
        """NHWC images -> quantized NHWC latents."""
        return self.encode(x.permute(0, 3, 1, 2))[0].permute(0, 2, 3, 1)

    def decode_latents(self, z_q):
        """NHWC latents -> NHWC images clamped to [0, 1]."""
        x = self.decode(z_q.permute(0, 3, 1, 2))
        return torch.clamp(x, 0.0, 1.0).permute(0, 2, 3, 1)
