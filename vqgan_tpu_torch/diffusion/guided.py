"""Classifier-guided diffusion (Sohl-Dickstein / Dhariwal-Nichol style).

Counterpart of vqgan_tpu/diffusion/guided.py: the ancestral sampler shifts
the posterior mean by variance * grad_x log p(y | x), and DDIM folds the
gradient into the predicted noise. `make_classifier_cond_fn` takes that
gradient with `torch.autograd.grad` under `torch.enable_grad()`, inside the
samplers' `torch.no_grad()` (the JAX package's `jax.grad`). The samplers
hand cond_fn their NCHW x_t and t [B]; it returns a gradient of x's shape.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core import diffusion_math as dm
from .gaussian import GaussianDiffusion, _nhwc

__all__ = ["GuidedGaussianDiffusion", "make_classifier_cond_fn"]


def make_classifier_cond_fn(classifier: Callable, scale: float = 1.0):
    """cond_fn(x, t, y) = scale * grad_x sum_i log p(y_i | x_i, t) for a
    classifier(x, t) -> logits [B, classes]."""

    def cond_fn(x, t, y):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            log_probs = torch.log_softmax(classifier(x, t).float(), dim=-1)
            selected = log_probs.gather(1, y.long()[:, None]).sum()
            return torch.autograd.grad(selected, x)[0] * scale

    return cond_fn


@dataclasses.dataclass
class GuidedGaussianDiffusion(GaussianDiffusion):
    """Unconditional sampling guided by `cond_fn(x, t, **guidance_kwargs)
    -> grad`."""

    def condition_mean(self, mean, variance, x, t, cond_fn, guidance_kwargs):
        return mean + variance * cond_fn(x, t, **guidance_kwargs)

    @torch.no_grad()
    def p_sample_loop_guided(self, shape, cond_fn: Optional[Callable] = None,
                             guidance_kwargs: Optional[dict] = None, *,
                             clip_denoised: bool = True, init_noise=None,
                             step_noise=None,
                             generator: torch.Generator = None):
        """Ancestral sampling with the mean shifted by the guidance; noise
        as in `GaussianDiffusion.p_sample_loop`."""
        guidance_kwargs = guidance_kwargs or {}

        def mean_and_log_var(img, tb):
            _, x_start = self.model_predictions(img, tb, cond_scale=1.0)
            if clip_denoised:
                x_start = torch.clamp(x_start, -1.0, 1.0)
            mean, var, log_var = dm.q_posterior(self.schedule, x_start, img,
                                                tb)
            if cond_fn is not None:
                mean = self.condition_mean(mean, var, img, tb, cond_fn,
                                           guidance_kwargs)
            return mean, log_var

        return self._ancestral_loop(shape, mean_and_log_var, False,
                                    init_noise, step_noise, generator)

    @torch.no_grad()
    def ddim_sample_guided(self, shape, cond_fn: Optional[Callable] = None,
                           guidance_kwargs: Optional[dict] = None, *,
                           clip_denoised: bool = True, init_noise=None,
                           step_noise=None,
                           generator: torch.Generator = None):
        """DDIM with eps' = eps - sqrt(1 - alpha_bar) * grad; noise as in
        `GaussianDiffusion.ddim_sample`."""
        guidance_kwargs = guidance_kwargs or {}
        sched = self.schedule
        img, noise_at = self._noise_source(shape, init_noise, step_noise,
                                           generator)
        for i, (time, time_next) in enumerate(self.ddim_time_pairs()):
            tb = torch.full((shape[0],), time, dtype=torch.long,
                            device=self.device)
            pred_noise, x_start = self.model_predictions(
                img, tb, cond_scale=1.0, clip_x_start=clip_denoised)
            if cond_fn is not None:
                grad = cond_fn(img, tb, **guidance_kwargs)
                pred_noise = pred_noise - dm.extract(
                    sched.sqrt_one_minus_alphas_cumprod, tb, img.ndim) * grad
                x_start = dm.predict_start_from_noise(sched, img, tb,
                                                      pred_noise)
                if clip_denoised:
                    x_start = torch.clamp(x_start, -1.0, 1.0)
            img = dm.ddim_step(sched, img, x_start, pred_noise, time,
                               time_next, noise_at(i), self.ddim_sampling_eta)
        return self.unnormalize(_nhwc(img))
