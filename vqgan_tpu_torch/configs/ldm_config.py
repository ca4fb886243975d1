"""Stage-2 latent-diffusion configuration: the port's own copy of the JAX
package's LDMConfig (vqgan_tpu/configs/ldm_config.py), field for field.

CFG is off by default (cond_drop_prob 0.0, cond_scale 1.0) and latents are
not renormalized (auto_normalize False: the VAE's 0.18215 scale already
brings them near N(0, 1)). compute_dtype is the U-Net's compute dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["LDMConfig"]


@dataclasses.dataclass
class LDMConfig:
    # --- paths ---
    vae_path: str = "./results/kl_vae_best"
    data_path: str = "./data/Normal_line"
    results_folder: str = "./results"
    latents_cache_folder: str = "./latents_cache"

    # --- data ---
    num_users: int = 31
    images_per_user_total: int = 150
    images_per_user_train: int = 50
    image_size: int = 256
    latent_size: int = 32  # 8x downsampling: 256/8
    latent_channels: int = 4

    # --- model (about 44M parameters) ---
    model_type: str = "unet"  # "unet" | "dit" (not ported yet)
    dim: int = 96
    dim_mults: Tuple[int, ...] = (1, 2, 4, 4)
    attn_dim_head: int = 64
    attn_heads: int = 8
    cond_drop_prob: float = 0.0
    dit_depth: int = 8
    dit_patch_size: int = 2

    # --- diffusion ---
    timesteps: int = 1000
    sampling_timesteps: int = 150
    objective: str = "pred_v"
    beta_schedule: str = "cosine"
    cond_scale: float = 1.0
    rescaled_phi: float = 0.0

    # --- training ---
    train_batch_size: int = 8
    gradient_accumulate_every: int = 1
    train_lr: float = 4e-5
    train_num_steps: int = 5000
    use_lr_warmup: bool = False
    warmup_steps: int = 0

    # --- regularization / optimizer ---
    use_ema: bool = True
    ema_decay: float = 0.995
    ema_update_every: int = 10
    max_grad_norm: float = 1.0
    adam_betas: Tuple[float, float] = (0.9, 0.99)
    weight_decay: float = 1e-4

    # --- Min-SNR ---
    min_snr_loss_weight: bool = True
    min_snr_gamma: float = 5.0

    # --- contrastive ---
    use_contrastive_loss: bool = False
    contrastive_weight: float = 0.0
    contrastive_temperature: float = 0.07
    contrastive_start_step: int = 5000

    # --- normalization ---
    auto_normalize: bool = False

    # --- monitoring ---
    save_and_sample_every: int = 500
    num_samples: int = 16

    # --- misc ---
    compute_dtype: str = "bfloat16"
    seed: int = 42

    @classmethod
    def from_dict(cls, raw: dict) -> "LDMConfig":
        """Known fields of `raw` (e.g. a saved config), lists as tuples."""
        fields = cls.__dataclass_fields__
        kwargs = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in raw.items() if k in fields}
        return cls(**kwargs)
