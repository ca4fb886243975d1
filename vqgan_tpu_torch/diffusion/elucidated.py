"""Elucidated diffusion (EDM, Karras et al. 2022).

Counterpart of vqgan_tpu/diffusion/elucidated.py: the Table-1
preconditioners (c_skip, c_out, c_in, c_noise = log(sigma) / 4), the
rho-schedule with a trailing 0, the stochastic Heun sampler with churn, the
DPM-Solver++(2M) sampler, the log-normal training sigma and the EDM loss
weight, with optional self-conditioning.

- The schedule lives on the host as float32 numpy, so the per-step scalar
  arithmetic (sigma_hat, the churn, DPM++'s log-sigma steps) is float32
  as in the JAX package's scan, and no step reads the device.
- Heun's second-order forward always runs, 2 forwards per step, and its
  result is discarded at sigma_next = 0, as the JAX package masks it.
- Every random draw can be passed in as a tensor: the samplers' initial
  noise and each Heun step's eps (unit normal draws, NHWC), the loss's
  sigmas, noise and self-conditioning coin. Otherwise they come from a
  `torch.Generator`.
- The public functions take and return NHWC images, in [0, 1]; NCHW
  inside.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..core.diffusion_math import (
    normalize_to_neg_one_to_one,
    unnormalize_to_zero_to_one,
)
from ..device import resolve_device

__all__ = ["ElucidatedDiffusion"]


def _nchw(x, device):
    return torch.as_tensor(x, dtype=torch.float32,
                           device=device).permute(0, 3, 1, 2)


@dataclasses.dataclass
class ElucidatedDiffusion:
    """net(x [B,C,H,W], c_noise [B], self_cond=None) -> the network's raw
    output; the net takes continuous (Fourier) noise conditioning."""

    net: Callable[..., torch.Tensor]
    image_size: int
    channels: int = 3
    num_sample_steps: int = 32
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    sigma_data: float = 0.5
    rho: float = 7.0
    P_mean: float = -1.2
    P_std: float = 1.2
    S_churn: float = 80.0
    S_tmin: float = 0.05
    S_tmax: float = 50.0
    S_noise: float = 1.003
    self_condition: bool = False
    device: str | torch.device = "cuda"  # no GPU raises; "cpu" on ask

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # Table-1 preconditioners ------------------------------------------------

    def c_skip(self, sigma):
        return (self.sigma_data ** 2) / (sigma ** 2 + self.sigma_data ** 2)

    def c_out(self, sigma):
        return sigma * self.sigma_data * (self.sigma_data ** 2
                                          + sigma ** 2) ** -0.5

    def c_in(self, sigma):
        return (sigma ** 2 + self.sigma_data ** 2) ** -0.5

    def c_noise(self, sigma):
        return torch.log(torch.clamp(sigma, min=1e-20)) * 0.25

    def preconditioned_forward(self, noised, sigma, self_cond=None,
                               clamp: bool = False):
        """EDM eq. (7), NCHW: D(x) = c_skip x + c_out F(c_in x, c_noise) at
        per-sample sigma [B]."""
        padded = sigma[:, None, None, None]
        net_out = self.net(self.c_in(padded) * noised, self.c_noise(sigma),
                           self_cond)
        out = self.c_skip(padded) * noised + self.c_out(padded) * net_out
        return torch.clamp(out, -1.0, 1.0) if clamp else out

    # schedule ---------------------------------------------------------------

    def sample_schedule(self, num_sample_steps: Optional[int] = None):
        """sigma_i per EDM eq. (5) and a trailing 0, float32 numpy."""
        n = num_sample_steps or self.num_sample_steps
        inv_rho = 1.0 / self.rho
        steps = np.arange(n, dtype=np.float64)
        sigmas = (self.sigma_max ** inv_rho + steps / (n - 1)
                  * (self.sigma_min ** inv_rho
                     - self.sigma_max ** inv_rho)) ** self.rho
        return np.append(sigmas, 0.0).astype(np.float32)

    # samplers ---------------------------------------------------------------

    def _initial(self, shape, sigma0, init_noise, generator):
        if init_noise is None:
            b, h, w, c = shape
            z = torch.randn((b, c, h, w), generator=generator,
                            device=self.device)
        else:
            z = _nchw(init_noise, self.device)
        return float(sigma0) * z

    def _full(self, b, value):
        return torch.full((b,), float(value), dtype=torch.float32,
                          device=self.device)

    @staticmethod
    def _finish(images):
        return unnormalize_to_zero_to_one(
            torch.clamp(images, -1.0, 1.0)).permute(0, 2, 3, 1)

    @torch.inference_mode()
    def sample(self, batch_size: int = 16,
               num_sample_steps: Optional[int] = None, clamp: bool = True,
               *, init_noise=None, step_noise=None,
               generator: Optional[torch.Generator] = None):
        """Stochastic Heun sampler with churn -> NHWC images in [0, 1].
        init_noise ([B, H, W, C]) and step_noise ([steps, B, H, W, C]) are
        the unit normal draws, NHWC; otherwise drawn from `generator`, the
        initial one first."""
        n = num_sample_steps or self.num_sample_steps
        b = batch_size
        shape = (b, self.image_size, self.image_size, self.channels)
        sigmas = self.sample_schedule(n)
        churn = np.float32(min(self.S_churn / n, math.sqrt(2) - 1))
        gammas = np.where((sigmas >= self.S_tmin) & (sigmas <= self.S_tmax),
                          churn, np.float32(0.0)).astype(np.float32)
        images = self._initial(shape, sigmas[0], init_noise, generator)
        steps = (None if step_noise is None else torch.as_tensor(
            step_noise, dtype=torch.float32,
            device=self.device).permute(0, 1, 4, 2, 3))
        x_start = torch.zeros_like(images)
        for i in range(n):
            sigma, sigma_next, gamma = sigmas[i], sigmas[i + 1], gammas[i]
            eps = (torch.randn(images.shape, generator=generator,
                               device=self.device)
                   if steps is None else steps[i]) * self.S_noise
            sigma_hat = sigma + gamma * sigma
            churn_std = np.sqrt(np.maximum(sigma_hat ** 2 - sigma ** 2,
                                           np.float32(0.0)))
            images_hat = images + float(churn_std) * eps

            model_output = self.preconditioned_forward(
                images_hat, self._full(b, sigma_hat),
                x_start if self.self_condition else None, clamp=clamp)
            denoised_over_sigma = (images_hat - model_output) / float(
                sigma_hat)
            images_next = images_hat + float(sigma_next - sigma_hat) \
                * denoised_over_sigma

            # the second-order correction, discarded at sigma_next == 0
            sigma_next_c = np.maximum(sigma_next, np.float32(1e-8))
            model_output_next = self.preconditioned_forward(
                images_next, self._full(b, sigma_next_c),
                model_output if self.self_condition else None, clamp=clamp)
            denoised_prime = (images_next - model_output_next) / float(
                sigma_next_c)
            images_heun = images_hat + float(
                np.float32(0.5) * (sigma_next - sigma_hat)) * (
                denoised_over_sigma + denoised_prime)
            if sigma_next == 0.0:
                images, x_start = images_next, model_output
            else:
                images, x_start = images_heun, model_output_next
        return self._finish(images)

    @torch.inference_mode()
    def sample_using_dpmpp(self, batch_size: int = 16,
                           num_sample_steps: Optional[int] = None, *,
                           init_noise=None,
                           generator: Optional[torch.Generator] = None):
        """DPM-Solver++(2M) -> NHWC images in [0, 1]; init_noise, the unit
        normal draw [B, H, W, C], or one from `generator`."""
        n = num_sample_steps or self.num_sample_steps
        b = batch_size
        shape = (b, self.image_size, self.image_size, self.channels)
        sigmas = self.sample_schedule(n)
        images = self._initial(shape, sigmas[0], init_noise, generator)

        def t_fn(s):
            return -np.log(np.maximum(s, np.float32(1e-20)))

        def sigma_fn(t):
            return np.exp(-t)

        old_denoised = None
        for i in range(n):
            sigma, sigma_next = sigmas[i], sigmas[i + 1]
            denoised = self.preconditioned_forward(images,
                                                   self._full(b, sigma))
            t, t_next = t_fn(sigma), t_fn(sigma_next)
            h = t_next - t
            if old_denoised is None or sigma_next == 0.0:
                denoised_d = denoised
            else:
                h_last = t - t_fn(sigmas[i - 1])
                r = h_last / (h if h != 0 else np.float32(1.0))
                gamma = np.float32(-1.0) / (
                    np.float32(2.0) * (r if r != 0 else np.float32(1.0)))
                denoised_d = (float(np.float32(1.0) - gamma) * denoised
                              + float(gamma) * old_denoised)
            images = float(sigma_fn(t_next) / sigma_fn(t)) * images \
                - float(np.expm1(-h)) * denoised_d
            old_denoised = denoised
        return self._finish(images)

    # training ---------------------------------------------------------------

    def loss_weight(self, sigma):
        return (sigma ** 2 + self.sigma_data ** 2) * (
            sigma * self.sigma_data) ** -2

    def noise_distribution(self, batch_size: int,
                           generator: Optional[torch.Generator] = None):
        return torch.exp(self.P_mean + self.P_std * torch.randn(
            (batch_size,), generator=generator, device=self.device))

    def loss(self, images, *, sigmas=None, noise=None, self_cond_coin=None,
             generator: Optional[torch.Generator] = None):
        """The EDM training loss of NHWC images in [0, 1]: sigmas [B]
        log-normal, noise NHWC and the self-conditioning coin (a bool, True
        feeds the stop-gradient estimate) are drawn from `generator` unless
        given, in that order."""
        images = normalize_to_neg_one_to_one(_nchw(images, self.device))
        b = images.shape[0]
        sigmas = (self.noise_distribution(b, generator) if sigmas is None
                  else torch.as_tensor(sigmas, dtype=torch.float32,
                                       device=self.device))
        noise = (torch.randn(images.shape, generator=generator,
                             device=self.device)
                 if noise is None else _nchw(noise, self.device))
        noised = images + sigmas[:, None, None, None] * noise

        self_cond = None
        if self.self_condition:
            with torch.no_grad():
                sc = self.preconditioned_forward(noised, sigmas)
            if self_cond_coin is None:
                self_cond_coin = torch.rand((), generator=generator,
                                            device=self.device) < 0.5
            coin = torch.as_tensor(self_cond_coin, device=self.device)
            self_cond = torch.where(coin, sc, torch.zeros_like(sc))

        denoised = self.preconditioned_forward(noised, sigmas, self_cond)
        losses = ((denoised - images) ** 2).mean(dim=(1, 2, 3))
        return (losses * self.loss_weight(sigmas)).mean()
