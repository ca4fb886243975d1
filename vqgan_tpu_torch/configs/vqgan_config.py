"""Stage-1 VQ-GAN training configuration: the port's own copy of the JAX
package's VQGANConfig (vqgan_tpu/configs/vqgan_config.py), field for field,
with its checks and summary.

`compute_dtype` is the models' compute dtype (bf16 by default; parameters
stay fp32). `native_input` chooses the trainer's image loader, as in the
JAX package (`data.native_image.make_batch_loader`): "auto" takes the C++
decode ring where it builds and the host has the cores for it, else the
Python BatchLoader (the reason printed); True requires the ring and raises
without it; False keeps the Python BatchLoader.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["VQGANConfig"]


@dataclasses.dataclass
class VQGANConfig:
    # --- paths ---
    data_path: str = "./data/Normal_line"
    results_folder: str = "./results/vqgan"

    # --- data ---
    num_users: int = 31
    images_per_user_train: int = 50
    image_size: int = 256

    # --- VQ-VAE architecture (the KL-VAE trunk) ---
    in_channels: int = 3
    out_channels: int = 3
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 2, 4)  # 8x downsampling, 256 -> 32
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    dropout: float = 0.0

    # --- VQ ---
    z_channels: int = 256
    num_embeddings: int = 128
    embedding_dim: int = 256
    commitment_cost: float = 0.25

    # --- discriminator ---
    disc_type: str = "PatchGAN"
    disc_ndf: int = 64
    disc_n_layers: int = 3
    disc_start: int = 10000
    disc_weight: float = 0.1
    disc_loss_type: str = "hinge"
    use_adaptive_weight: bool = False
    disc_norm: str = "batch"  # "batch" | "act" | "group"

    # --- loss weights ---
    perceptual_weight: float = 1.0

    # --- training ---
    batch_size: int = 8
    learning_rate: float = 4.5e-5
    disc_learning_rate: float = 4.5e-5
    adam_betas: Tuple[float, float] = (0.5, 0.9)
    weight_decay: float = 0.0
    train_steps: int = 30000
    gradient_accumulate_every: int = 1
    max_grad_norm: float = 1.0

    # --- codebook health (see ops.vq.revive_dead_codes) ---
    revive_dead_codes_every: int = 0  # 0 = off
    revive_usage_threshold: int = 1

    # --- intentionally unused (paper baseline) ---
    use_ema: bool = False
    ema_decay: Optional[float] = None
    ema_update_every: Optional[int] = None

    # --- monitoring / saving ---
    save_and_sample_every: int = 1000
    num_samples: int = 8

    # --- misc ---
    compute_dtype: str = "bfloat16"
    seed: int = 42
    # input pipeline: "auto" = the C++ async decode ring where it applies,
    # else the Python BatchLoader; True requires the ring; False disables it
    native_input: bool | str = "auto"

    @property
    def total_train_images(self) -> int:
        return self.num_users * self.images_per_user_train

    def __post_init__(self):
        if self.num_embeddings > self.total_train_images:
            raise ValueError(
                f"codebook too large ({self.num_embeddings}) > train images "
                f"({self.total_train_images})")
        if self.disc_start < 0:
            raise ValueError("disc_start must be non-negative")
        if not 0 < self.disc_weight <= 1.0:
            raise ValueError("disc_weight must be in (0, 1]")

    @classmethod
    def from_dict(cls, raw: dict) -> "VQGANConfig":
        """Known fields of `raw` (e.g. a saved config), lists as tuples."""
        fields = cls.__dataclass_fields__
        kwargs = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in raw.items() if k in fields}
        return cls(**kwargs)

    def print_config_summary(self):
        print("=" * 60)
        print("VQ-GAN training configuration")
        print("=" * 60)
        print(f"data: {self.num_users} users x {self.images_per_user_train} "
              f"= {self.total_train_images} images @ {self.image_size}px")
        print(f"VQ: {self.num_embeddings} codes x {self.embedding_dim} dim, "
              f"8x downsample, z={self.z_channels}")
        print(f"disc: {self.disc_type} start={self.disc_start} "
              f"w={self.disc_weight} loss={self.disc_loss_type}")
        print(f"train: batch={self.batch_size} lr={self.learning_rate} "
              f"steps={self.train_steps:,} clip={self.max_grad_norm}")
        print(f"dtype: {self.compute_dtype}")
        print("=" * 60)
