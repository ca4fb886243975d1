"""Weighted-objective diffusion: the model predicts the noise, x_0 and a
2-way softmax weighting per pixel; the posterior uses the weighted x_0.

Counterpart of vqgan_tpu/diffusion/weighted_objective.py. The model's
output has C + C + 2 channels (NCHW inside); DDIM is refused, as there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import diffusion_math as dm
from ..parallel.mesh import draw_rows
from .gaussian import GaussianDiffusion, _nchw

__all__ = ["WeightedObjectiveGaussianDiffusion"]


@dataclasses.dataclass
class WeightedObjectiveGaussianDiffusion(GaussianDiffusion):
    pred_noise_loss_weight: float = 0.1
    pred_x_start_loss_weight: float = 0.1

    def __post_init__(self):
        super().__post_init__()
        if self.is_ddim_sampling:
            raise ValueError("ddim sampling cannot be used")

    def _split(self, model_output):
        c = self.channels
        return (model_output[:, :c], model_output[:, c:2 * c],
                model_output[:, 2 * c:])

    def _weighted_x_start(self, x, t, pred_noise, pred_x_start, weights,
                          noise_clip=None):
        x_from_noise = dm.predict_start_from_noise(self.schedule, x, t,
                                                   pred_noise)
        if noise_clip is not None:
            x_from_noise = torch.clamp(x_from_noise, -noise_clip, noise_clip)
        w = torch.softmax(weights, dim=1)  # [B, 2, H, W], per pixel
        return w[:, 0:1] * x_from_noise + w[:, 1:2] * pred_x_start

    def p_mean_variance(self, x, t, *, clip_denoised: bool = True):
        pred_noise, pred_x_start, weights = self._split(self.model(x, t))
        weighted = self._weighted_x_start(x, t, pred_noise, pred_x_start,
                                          weights)
        if clip_denoised:
            weighted = torch.clamp(weighted, -1.0, 1.0)
        return dm.q_posterior(self.schedule, weighted, x, t)

    def p_losses(self, x_start, t, classes=None, *, noise=None,
                 generator: torch.Generator = None, **_):
        """The noise, x_0 and weighted-x_0 losses at times `t` [B]; NHWC
        x_start and `noise`, the noise drawn from `generator` when not
        given."""
        x_start = _nchw(torch.as_tensor(x_start, device=self.device))
        noise = (draw_rows(lambda shape: torch.randn(
                     shape, generator=generator, device=self.device),
                     x_start.shape) if noise is None
                 else _nchw(torch.as_tensor(noise, dtype=torch.float32,
                                            device=self.device)))
        t = torch.as_tensor(t, device=self.device)
        x_t = dm.q_sample(self.schedule, x_start, t, noise)
        pred_noise, pred_x_start, weights = self._split(self.model(x_t, t))
        noise_loss = ((noise - pred_noise) ** 2).mean() \
            * self.pred_noise_loss_weight
        x_start_loss = ((x_start - pred_x_start) ** 2).mean() \
            * self.pred_x_start_loss_weight
        weighted = self._weighted_x_start(x_t, t, pred_noise, pred_x_start,
                                          weights, noise_clip=2.0)
        return ((x_start - weighted) ** 2).mean() + x_start_loss + noise_loss

    @torch.inference_mode()
    def p_sample_loop(self, shape, classes=None, *, cond_scale: float = 1.0,
                      rescaled_phi: float = 0.0, clip_denoised: bool = True,
                      return_all_timesteps: bool = False, init_noise=None,
                      step_noise=None, generator: torch.Generator = None,
                      graph: Optional[bool] = None):
        """Ancestral sampling from the weighted x_0; noise and `graph` as
        in `GaussianDiffusion.p_sample_loop`."""
        def mean_and_log_var(img, tb, _):
            mean, _, log_var = self.p_mean_variance(
                img, tb, clip_denoised=clip_denoised)
            return mean, log_var

        return self._ancestral_loop(
            shape, mean_and_log_var, ("weighted objective", clip_denoised),
            return_all_timesteps, init_noise, step_noise, generator,
            graph=graph)
