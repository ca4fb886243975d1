"""Improved-DDPM learned-variance diffusion (Nichol & Dhariwal 2021).

Counterpart of vqgan_tpu/diffusion/learned_variance.py. The model emits 2C
channels (the prediction, then the variance-interpolation fraction in
[-1, 1]); the hybrid loss is the simple MSE plus vb_loss_weight times the
VLB: KL(q || p) per step, the discretized Gaussian NLL (tanh-approximate
CDF) at t = 0, both on the model mean detached. NCHW inside, the 2C split
on the channel axis; the public functions take and return NHWC, as the
base class's do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..core import diffusion_math as dm
from ..parallel.mesh import draw_rows
from .gaussian import GaussianDiffusion, _nchw

__all__ = [
    "LearnedVarianceGaussianDiffusion",
    "normal_kl",
    "discretized_gaussian_log_likelihood",
]

NAT = 1.0 / math.log(2.0)


def normal_kl(mean1, logvar1, mean2, logvar2):
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def _approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales,
                                        thres: float = 0.999):
    """Log-likelihood of 8-bit-discretized data under a Gaussian."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = _approx_standard_normal_cdf(inv_stdv * (centered + 1 / 255))
    cdf_min = _approx_standard_normal_cdf(inv_stdv * (centered - 1 / 255))

    def log(t):
        return torch.log(torch.clamp(t, min=1e-15))

    return torch.where(x < -thres, log(cdf_plus),
                       torch.where(x > thres, log(1.0 - cdf_min),
                                   log(cdf_plus - cdf_min)))


def _meanflat(x):
    return x.mean(dim=tuple(range(1, x.ndim)))


@dataclasses.dataclass
class LearnedVarianceGaussianDiffusion(GaussianDiffusion):
    """The model must emit 2 * channels channels (`Unet(learned_variance=
    True)`); unconditional, pred_noise or pred_x0."""

    vb_loss_weight: float = 0.001

    def model_predictions(self, x, t, classes=None, *,
                          cond_scale: float = 1.0, rescaled_phi: float = 0.0,
                          clip_x_start: bool = False, x_self_cond=None):
        pred, _ = self.model(x, t).chunk(2, dim=1)
        if self.objective == "pred_noise":
            x_start = dm.predict_start_from_noise(self.schedule, x, t, pred)
            if clip_x_start:
                x_start = torch.clamp(x_start, -1.0, 1.0)
            return pred, x_start
        if self.objective == "pred_x0":
            x_start = torch.clamp(pred, -1.0, 1.0) if clip_x_start else pred
            return (dm.predict_noise_from_start(self.schedule, x, t, x_start),
                    x_start)
        raise ValueError("learned variance supports pred_noise / pred_x0")

    def p_mean_variance(self, x, t, *, clip_denoised: bool = False,
                        model_output=None):
        """(mean, variance, log variance, x_0) of p(x_{t-1} | x_t): the log
        variance interpolates between the clipped posterior's and log
        beta_t by the model's fraction."""
        if model_output is None:
            model_output = self.model(x, t)
        pred_noise, var_frac_raw = model_output.chunk(2, dim=1)
        sched = self.schedule
        min_log = dm.extract(sched.posterior_log_variance_clipped, t, x.ndim)
        max_log = dm.extract(torch.log(sched.betas), t, x.ndim)
        frac = dm.unnormalize_to_zero_to_one(var_frac_raw)
        model_log_variance = frac * max_log + (1 - frac) * min_log
        x_start = dm.predict_start_from_noise(sched, x, t, pred_noise)
        if clip_denoised:
            x_start = torch.clamp(x_start, -1.0, 1.0)
        model_mean, _, _ = dm.q_posterior(sched, x_start, x, t)
        return (model_mean, torch.exp(model_log_variance),
                model_log_variance, x_start)

    def p_losses(self, x_start, t, classes=None, *, noise=None,
                 clip_denoised: bool = False,
                 generator: torch.Generator = None, **_):
        """The hybrid loss at times `t` [B]; x_start and `noise` NHWC, the
        noise drawn from `generator` when not given."""
        x_start = _nchw(torch.as_tensor(x_start, device=self.device))
        noise = (draw_rows(lambda shape: torch.randn(
                     shape, generator=generator, device=self.device),
                     x_start.shape) if noise is None
                 else _nchw(torch.as_tensor(noise, dtype=torch.float32,
                                            device=self.device)))
        t = torch.as_tensor(t, device=self.device)
        x_t = dm.q_sample(self.schedule, x_start, t, noise)
        model_output = self.model(x_t, t)
        true_mean, _, true_log_var = dm.q_posterior(self.schedule, x_start,
                                                    x_t, t)
        model_mean, _, model_log_var, _ = self.p_mean_variance(
            x_t, t, clip_denoised=clip_denoised, model_output=model_output)
        detached_mean = model_mean.detach()
        kl = _meanflat(normal_kl(true_mean, true_log_var, detached_mean,
                                 model_log_var)) * NAT
        decoder_nll = -_meanflat(discretized_gaussian_log_likelihood(
            x_start, means=detached_mean,
            log_scales=0.5 * model_log_var)) * NAT
        vb_losses = torch.where(t == 0, decoder_nll, kl)
        pred_noise, _ = model_output.chunk(2, dim=1)
        simple = ((pred_noise - noise) ** 2).mean()
        return simple + vb_losses.mean() * self.vb_loss_weight

    @torch.inference_mode()
    def p_sample_loop(self, shape, classes=None, *, cond_scale: float = 1.0,
                      rescaled_phi: float = 0.0, clip_denoised: bool = True,
                      return_all_timesteps: bool = False, init_noise=None,
                      step_noise=None, generator: torch.Generator = None,
                      graph: Optional[bool] = None):
        """Ancestral sampling with the learned variance; `shape` NHWC,
        init_noise ([*shape]), step_noise ([timesteps, *shape]) and
        `graph` as in `GaussianDiffusion.p_sample_loop`."""
        def mean_and_log_var(img, tb, _):
            mean, _, log_var, _ = self.p_mean_variance(
                img, tb, clip_denoised=clip_denoised)
            return mean, log_var

        return self._ancestral_loop(
            shape, mean_and_log_var, ("learned variance", clip_denoised),
            return_all_timesteps, init_noise, step_noise, generator,
            graph=graph)
