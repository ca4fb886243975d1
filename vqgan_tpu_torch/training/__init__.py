from .ddpm_trainer import FolderDataset, Trainer
from .ema import ema_decay_at_step, ema_update
from .kl_vae_step import (
    lpips_perceptual_fn,
    make_kl_vae_optimizer,
    make_kl_vae_train_step,
)
from .ldm_step import (
    CapturableOptimizer,
    LDMOptimizer,
    LDMTrainState,
    global_norm,
    make_ldm_optimizer,
    make_ldm_scan_step,
    make_ldm_train_step,
    warmup_cosine_decay_schedule,
)
from .vqgan_step import (
    VQGANTrainState,
    make_gan_optimizers,
    make_vqgan_scan_steps,
    make_vqgan_split_steps,
    make_vqgan_train_step,
    reset_codebook_moments,
)
from .watchdog import TrainingDiverged, TrainingWatchdog, check_sample_range

__all__ = ["CapturableOptimizer", "FolderDataset", "Trainer", "LDMOptimizer", "LDMTrainState", "TrainingDiverged",
           "TrainingWatchdog", "check_sample_range", "ema_decay_at_step",
           "ema_update", "global_norm", "make_ldm_optimizer",
           "make_ldm_scan_step", "make_ldm_train_step", "VQGANTrainState",
           "make_gan_optimizers", "make_vqgan_scan_steps",
           "make_vqgan_split_steps", "make_vqgan_train_step", "reset_codebook_moments",
           "lpips_perceptual_fn", "make_kl_vae_optimizer",
           "make_kl_vae_train_step", "warmup_cosine_decay_schedule"]
