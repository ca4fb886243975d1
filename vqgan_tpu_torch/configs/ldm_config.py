"""Stage-2 latent-diffusion configuration: the port's own copy of the JAX
package's LDMConfig (vqgan_tpu/configs/ldm_config.py), field for field.

CFG is off by default (cond_drop_prob 0.0, cond_scale 1.0) and latents are
not renormalized (auto_normalize False: the VAE's 0.18215 scale already
brings them near N(0, 1)). compute_dtype is the U-Net's compute dtype.
`BaselineLDMConfig` is the ablation baseline with every optimization off.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["LDMConfig", "BaselineLDMConfig"]


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
    model_type: str = "unet"  # "unet" (the CFG U-Net) | "dit"
    dim: int = 96
    dim_mults: Tuple[int, ...] = (1, 2, 4, 4)
    attn_dim_head: int = 64
    attn_heads: int = 8
    cond_drop_prob: float = 0.0
    # DiT only (ignored for the U-Net)
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

    def print_config_summary(self):
        n_img = self.num_users * self.images_per_user_train
        print("=" * 60)
        print("LDM training configuration")
        print("=" * 60)
        print(f"data: {self.num_users} users x {self.images_per_user_train} "
              f"= {n_img} images")
        print(f"model: dim={self.dim}, levels={len(self.dim_mults)}, "
              f"{self.attn_heads} heads x {self.attn_dim_head}")
        print(f"CFG: drop={self.cond_drop_prob}, scale={self.cond_scale}")
        print(f"train: batch={self.train_batch_size}"
              f"x{self.gradient_accumulate_every}, lr={self.train_lr}, "
              f"steps={self.train_num_steps:,}")
        print(f"EMA: {self.use_ema} (decay={self.ema_decay})  "
              f"Min-SNR: {self.min_snr_loss_weight} (gamma={self.min_snr_gamma})")
        print(f"contrastive: {self.use_contrastive_loss}")
        print(f"dtype: {self.compute_dtype}")
        print("=" * 60)

    @classmethod
    def from_dict(cls, raw: dict) -> "LDMConfig":
        """Known fields of `raw` (e.g. a saved config), lists as tuples."""
        fields = cls.__dataclass_fields__
        kwargs = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in raw.items() if k in fields}
        return cls(**kwargs)


@dataclasses.dataclass
class BaselineLDMConfig(LDMConfig):
    """The ablation baseline: every optimization switched off."""

    cond_drop_prob: float = 0.0
    use_contrastive_loss: bool = False
    contrastive_weight: float = 0.0
    min_snr_loss_weight: bool = False
    use_ema: bool = False
    use_lr_warmup: bool = False
    warmup_steps: int = 0
    max_grad_norm: float = 0.0  # 0 = off
    weight_decay: float = 0.0
    results_folder: str = "./results_baseline"

    def print_ablation_table(self):
        rows = [
            ("CFG (cond_drop_prob)", self.cond_drop_prob > 0),
            ("contrastive loss", self.use_contrastive_loss),
            ("Min-SNR weighting", self.min_snr_loss_weight),
            ("EMA", self.use_ema),
            ("LR warmup", self.use_lr_warmup),
            ("grad clipping", self.max_grad_norm > 0),
            ("weight decay", self.weight_decay > 0),
        ]
        print("baseline ablation (all optimizations off):")
        for name, on in rows:
            print(f"  {'ON ' if on else 'OFF'}  {name}")
