"""Simple diffusion: continuous-time log-SNR diffusion for the UViT
(arXiv 2301.11093).

Counterpart of vqgan_tpu/diffusion/simple.py: the cosine log-SNR with its
min / max clamps, the shifted schedule (+ 2 log(noise_d / image_d)) and the
t-interpolated low / high one, v or eps objectives, the ancestral sampler
with the corrected posterior mean, Min-SNR weighting clamped from above.
NCHW inside; `loss` takes NHWC images in [0, 1], `sample` returns NHWC in
[0, 1]; every draw can be injected or comes from a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..core.diffusion_math import normalize_to_neg_one_to_one
from ..device import resolve_device
from ..graphs import ChainGraphs
from .continuous_time import (
    _noise_for,
    _pad,
    _times_for,
    alpha_sigma,
    logsnr_sample,
)
from .gaussian import _nchw

__all__ = [
    "logsnr_schedule_cosine",
    "logsnr_schedule_shifted",
    "logsnr_schedule_interpolated",
    "SimpleDiffusion",
]


def logsnr_schedule_cosine(t, logsnr_min: float = -15.0,
                           logsnr_max: float = 15.0):
    t_min = math.atan(math.exp(-0.5 * logsnr_max))
    t_max = math.atan(math.exp(-0.5 * logsnr_min))
    return -2.0 * torch.log(torch.clamp(
        torch.tan(t_min + t * (t_max - t_min)), min=1e-20))


def logsnr_schedule_shifted(fn: Callable, image_d: float, noise_d: float):
    shift = 2.0 * math.log(noise_d / image_d)

    def inner(t, *args, **kwargs):
        return fn(t, *args, **kwargs) + shift

    return inner


def logsnr_schedule_interpolated(fn: Callable, image_d: float,
                                 noise_d_low: float, noise_d_high: float):
    low = logsnr_schedule_shifted(fn, image_d, noise_d_low)
    high = logsnr_schedule_shifted(fn, image_d, noise_d_high)

    def inner(t, *args, **kwargs):
        return t * low(t, *args, **kwargs) + (1 - t) * high(t, *args,
                                                            **kwargs)

    return inner


@dataclasses.dataclass
class SimpleDiffusion:
    """model(x [B,C,H,W], log_snr [B]) -> the prediction (v or eps)."""

    model: Callable[..., torch.Tensor]
    image_size: int
    channels: int = 3
    pred_objective: str = "v"  # "v" | "eps"
    noise_schedule: Callable = logsnr_schedule_cosine
    noise_d: Optional[float] = None
    noise_d_low: Optional[float] = None
    noise_d_high: Optional[float] = None
    num_sample_steps: int = 500
    clip_sample_denoised: bool = True
    min_snr_loss_weight: bool = True
    min_snr_gamma: float = 5.0
    device: str | torch.device = "cuda"  # no GPU raises; "cpu" on ask
    # the sampler's captured steps, by their key
    _graphs: ChainGraphs = dataclasses.field(
        default_factory=ChainGraphs, init=False, repr=False, compare=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.pred_objective not in ("v", "eps"):
            raise ValueError(f"unknown objective {self.pred_objective!r}")
        if self.noise_d is not None and self.noise_d_low is not None:
            raise ValueError("set noise_d OR (noise_d_low, noise_d_high), "
                             "not both")
        self.log_snr = self.noise_schedule
        if self.noise_d is not None:
            self.log_snr = logsnr_schedule_shifted(
                self.log_snr, self.image_size, self.noise_d)
        if self.noise_d_low is not None or self.noise_d_high is not None:
            if self.noise_d_low is None or self.noise_d_high is None:
                raise ValueError("set both noise_d_low and noise_d_high")
            self.log_snr = logsnr_schedule_interpolated(
                self.noise_schedule, self.image_size, self.noise_d_low,
                self.noise_d_high)

    def p_losses(self, x_start, times, *, noise=None,
                 generator: torch.Generator = None):
        """The (Min-SNR weighted) MSE at `times` [B] in [0, 1]; NHWC
        x_start and `noise`, the noise drawn from `generator` when not
        given."""
        x_start = _nchw(torch.as_tensor(x_start, device=self.device))
        noise = _noise_for(x_start, noise, generator)
        log_snr = self.log_snr(times)
        alpha, sigma = alpha_sigma(_pad(log_snr, x_start.ndim))
        pred = self.model(alpha * x_start + sigma * noise, log_snr)
        target = (alpha * noise - sigma * x_start
                  if self.pred_objective == "v" else noise)
        losses = ((pred - target) ** 2).mean(dim=tuple(range(1, pred.ndim)))
        if self.min_snr_loss_weight:
            snr = torch.exp(log_snr)
            clamped = torch.clamp(snr, max=self.min_snr_gamma)
            losses = losses * (clamped / snr if self.pred_objective == "eps"
                               else clamped / (snr + 1))
        return losses.mean()

    def loss(self, img, *, times=None, noise=None,
             generator: torch.Generator = None):
        """The training loss of NHWC images in [0, 1]: times uniform in
        [0, 1), then the noise, from `generator` unless given."""
        img = torch.as_tensor(img, device=self.device)
        times = _times_for(img, times, generator)
        return self.p_losses(normalize_to_neg_one_to_one(img), times,
                             noise=noise, generator=generator)

    def _posterior(self, img, time, time_next):
        log_snr, log_snr_next = self.log_snr(time), self.log_snr(time_next)
        c = -torch.expm1(log_snr - log_snr_next)
        alpha, sigma = alpha_sigma(log_snr)
        alpha_next = torch.sqrt(torch.sigmoid(log_snr_next))
        pred = self.model(img, log_snr.expand(img.shape[0]))
        if self.pred_objective == "v":
            x_start = alpha * img - sigma * pred
        else:
            x_start = (img - sigma * pred) / torch.clamp(alpha, min=1e-8)
        if self.clip_sample_denoised:
            x_start = torch.clamp(x_start, -1.0, 1.0)
        mean = alpha_next * (img * (1 - c) / alpha + c * x_start)
        return mean, torch.sigmoid(-log_snr_next) * c

    @torch.inference_mode()
    def sample(self, batch_size: int = 16, *, init_noise=None,
               step_noise=None, generator: torch.Generator = None,
               graph: Optional[bool] = None):
        """Ancestral sampling over `num_sample_steps`; see
        `continuous_time.logsnr_sample`."""
        return logsnr_sample(self, batch_size, self._posterior, init_noise,
                             step_noise, generator, graph)
