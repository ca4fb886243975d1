"""Diffusion-process math: q_sample, parameterization conversions, posterior,
DDIM step.

Counterpart of vqgan_tpu/core/diffusion_math.py. `t` is an int64 tensor of
shape [B]; gathered schedule coefficients broadcast over the trailing dims.
"""

from __future__ import annotations

import torch

from .schedules import DiffusionSchedule

__all__ = [
    "extract",
    "q_sample",
    "predict_start_from_noise",
    "predict_noise_from_start",
    "predict_v",
    "predict_start_from_v",
    "q_posterior",
    "ddim_step",
    "normalize_to_neg_one_to_one",
    "unnormalize_to_zero_to_one",
]


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients: [B] -> [B, 1, ..., 1]."""
    out = a[t]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def normalize_to_neg_one_to_one(img):
    return img * 2.0 - 1.0


def unnormalize_to_zero_to_one(t):
    return (t + 1.0) * 0.5


def q_sample(sched: DiffusionSchedule, x_start, t, noise):
    """Forward diffusion q(x_t | x_0), in fp32 whatever the input dtype."""
    x32 = x_start.float()
    n32 = noise.float()
    out = (extract(sched.sqrt_alphas_cumprod, t, x32.ndim) * x32
           + extract(sched.sqrt_one_minus_alphas_cumprod, t, x32.ndim) * n32)
    return out.to(x_start.dtype)


def predict_start_from_noise(sched, x_t, t, noise):
    return (extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise)


def predict_noise_from_start(sched, x_t, t, x0):
    return ((extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t - x0)
            / extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim))


def predict_v(sched, x_start, t, noise):
    return (extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * noise
            - extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
            * x_start)


def predict_start_from_v(sched, x_t, t, v):
    return (extract(sched.sqrt_alphas_cumprod, t, x_t.ndim) * x_t
            - extract(sched.sqrt_one_minus_alphas_cumprod, t, x_t.ndim) * v)


def q_posterior(sched, x_start, x_t, t):
    """Posterior q(x_{t-1} | x_t, x_0): (mean, variance, log_variance)."""
    mean = (extract(sched.posterior_mean_coef1, t, x_t.ndim) * x_start
            + extract(sched.posterior_mean_coef2, t, x_t.ndim) * x_t)
    variance = extract(sched.posterior_variance, t, x_t.ndim)
    log_variance = extract(sched.posterior_log_variance_clipped, t, x_t.ndim)
    return mean, variance, log_variance


def ddim_step(sched: DiffusionSchedule, img, x_start, pred_noise,
              time: int, time_next: int, noise, eta: float):
    """One DDIM update for Python-int `time`/`time_next`. At `time_next < 0`
    (the final step) the result is `x_start`."""
    if time_next < 0:
        return x_start
    alpha = sched.alphas_cumprod[time]
    alpha_next = sched.alphas_cumprod[time_next]
    sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next)
                             / (1 - alpha))
    c = torch.sqrt(torch.clamp(1.0 - alpha_next - sigma**2, min=0.0))
    return x_start * torch.sqrt(alpha_next) + c * pred_noise + sigma * noise
