"""Noise schedules and precomputed diffusion constants.

Counterpart of vqgan_tpu/core/schedules.py: built on the host in float64
with numpy, stored once as float32 tensors on the chosen device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np
import torch

Objective = Literal["pred_noise", "pred_x0", "pred_v"]

__all__ = [
    "linear_beta_schedule",
    "cosine_beta_schedule",
    "sigmoid_beta_schedule",
    "make_beta_schedule",
    "DiffusionSchedule",
    "make_schedule",
]


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    """Linear betas, scaled so the range matches T=1000 conventions."""
    scale = 1000 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps,
                       dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cosine schedule (Nichol & Dhariwal 2021)."""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def sigmoid_beta_schedule(
    timesteps: int, start: float = -3, end: float = 3, tau: float = 1.0
) -> np.ndarray:
    """Sigmoid schedule (Jabri et al.)."""
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    v_start = 1.0 / (1.0 + math.exp(-start / tau))
    v_end = 1.0 / (1.0 + math.exp(-end / tau))
    sig = 1.0 / (1.0 + np.exp(-((t * (end - start) + start) / tau)))
    alphas_cumprod = (-sig + v_end) / (v_end - v_start)
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


_SCHEDULES = {
    "linear": linear_beta_schedule,
    "cosine": cosine_beta_schedule,
    "sigmoid": sigmoid_beta_schedule,
}


def make_beta_schedule(name: str, timesteps: int, **kwargs) -> np.ndarray:
    try:
        fn = _SCHEDULES[name]
    except KeyError:
        raise ValueError(
            f"unknown beta schedule {name!r}; choose from {sorted(_SCHEDULES)}"
        ) from None
    return fn(timesteps, **kwargs)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed DDPM constants, all float32 tensors of shape [T]."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    snr: torch.Tensor
    loss_weight: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def make_schedule(
    beta_schedule: str = "cosine",
    timesteps: int = 1000,
    objective: Objective = "pred_noise",
    min_snr_loss_weight: bool = False,
    min_snr_gamma: float = 5.0,
    device="cpu",
    **schedule_kwargs,
) -> DiffusionSchedule:
    """Build the full constant pack in float64, stored as float32 tensors."""
    betas = make_beta_schedule(beta_schedule, timesteps, **schedule_kwargs)

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.pad(alphas_cumprod[:-1], (1, 0),
                                 constant_values=1.0)

    posterior_variance = (betas * (1.0 - alphas_cumprod_prev)
                          / (1.0 - alphas_cumprod))

    snr = alphas_cumprod / (1.0 - alphas_cumprod)
    maybe_clipped_snr = (np.minimum(snr, min_snr_gamma) if min_snr_loss_weight
                         else snr)

    if objective == "pred_noise":
        loss_weight = maybe_clipped_snr / snr
    elif objective == "pred_x0":
        loss_weight = maybe_clipped_snr
    elif objective == "pred_v":
        loss_weight = maybe_clipped_snr / (snr + 1)
    else:
        raise ValueError(f"unknown objective {objective!r}")

    def as_f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return DiffusionSchedule(
        betas=as_f32(betas),
        alphas_cumprod=as_f32(alphas_cumprod),
        alphas_cumprod_prev=as_f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=as_f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=as_f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=as_f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=as_f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=as_f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_variance=as_f32(posterior_variance),
        posterior_log_variance_clipped=as_f32(
            np.log(np.clip(posterior_variance, 1e-20, None))),
        posterior_mean_coef1=as_f32(
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=as_f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
            / (1.0 - alphas_cumprod)),
        snr=as_f32(snr),
        loss_weight=as_f32(loss_weight),
    )
