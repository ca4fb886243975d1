"""Continuous-time (VDM-style) diffusion over log-SNR: the linear, cosine
and learned monotonic schedules, and the v-parameterised variant.

Counterpart of vqgan_tpu/diffusion/continuous_time.py. As there, Min-SNR in
`ContinuousTimeGaussianDiffusion` clamps the SNR from BELOW (the reference
file's convention, unlike the discrete-time files).

The learned schedule trains, and is averaged by the EMA, with the
denoiser: JAX keeps its parameters in the same trained pytree, the port in
the same module, `LearnedScheduleDenoiser(net, LearnedLogSNR(...))`, which
is the diffusion's `model`. The DDPM `Trainer` then optimises and copies
both, and its EMA diffusion reads the EMA copy's schedule.

NCHW inside; `loss` takes NHWC images in [0, 1] and `sample` returns NHWC
in [0, 1]. Every draw can be injected (`times`, `noise`, `init_noise`,
`step_noise`) or comes from a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..core.diffusion_math import (
    normalize_to_neg_one_to_one,
    unnormalize_to_zero_to_one,
)
from ..device import resolve_device
from ..graphs import ChainGraphs, ChainStep, resolve_graph, run_chain
from ..parallel.mesh import draw_rows
from .gaussian import _channels_first, _nchw, _nhwc, _row_noise

__all__ = [
    "beta_linear_log_snr",
    "alpha_cosine_log_snr",
    "LearnedLogSNR",
    "LearnedScheduleDenoiser",
    "ContinuousTimeGaussianDiffusion",
    "VParamContinuousTimeGaussianDiffusion",
]


def _log(t, eps: float = 1e-20):
    return torch.log(torch.clamp(t, min=eps))


def beta_linear_log_snr(t):
    """log-SNR approximating the original linear beta schedule."""
    return -_log(torch.expm1(1e-4 + 10 * t ** 2))


def alpha_cosine_log_snr(t, s: float = 0.008):
    return -_log(torch.cos((t + s) / (1 + s) * math.pi * 0.5) ** -2 - 1,
                 eps=1e-5)


class _MonotonicDense(nn.Module):
    """x @ |W|^T + |b|: monotonically increasing in its input. weight
    [out, in] (flax's kernel transposed), lecun-normal; bias zero."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        std = (1.0 / dim_in) ** 0.5 / .87962566103423978
        self.weight = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(dim_out, dim_in), 0.0, std, -2 * std, 2 * std))
        self.bias = nn.Parameter(torch.zeros(dim_out))

    def forward(self, x):
        return x @ self.weight.abs().T + self.bias.abs()


class LearnedLogSNR(nn.Module):
    """Learned monotonic log-SNR (VDM appendix H / I.2): a monotone MLP
    normalised so t = 0 gives log_snr_max and t = 1 log_snr_min; only
    `frac_gradient` of the gradient reaches its parameters."""

    def __init__(self, log_snr_max: float, log_snr_min: float,
                 hidden_dim: int = 1024, frac_gradient: float = 1.0):
        super().__init__()
        self.log_snr_max, self.log_snr_min = log_snr_max, log_snr_min
        self.frac_gradient = frac_gradient
        self.lin1 = _MonotonicDense(1, 1)
        self.lin2 = _MonotonicDense(1, hidden_dim)
        self.lin3 = _MonotonicDense(hidden_dim, 1)

    def _net(self, x):
        x = self.lin1(x[..., None])
        return (x + self.lin3(torch.sigmoid(self.lin2(x))))[..., 0]

    def forward(self, t):
        t = torch.as_tensor(t, dtype=torch.float32,
                            device=self.lin1.weight.device)
        out_zero = self._net(torch.zeros_like(t))
        out_one = self._net(torch.ones_like(t))
        normed = (self.log_snr_min - self.log_snr_max) * (
            (self._net(t) - out_zero) / (out_one - out_zero)) \
            + self.log_snr_max
        return normed * self.frac_gradient \
            + normed.detach() * (1 - self.frac_gradient)


class LearnedScheduleDenoiser(nn.Module):
    """The denoiser and its learned log-SNR schedule as one module:
    forward(x, log_snr) = net(x, log_snr); `log_snr(t)` is the schedule."""

    def __init__(self, net: nn.Module, log_snr: LearnedLogSNR):
        super().__init__()
        self.net = net
        self.log_snr = log_snr

    def forward(self, x, log_snr, *args, **kwargs):
        return self.net(x, log_snr, *args, **kwargs)


def _pad(t, ndim: int):
    return t.reshape(*t.shape, *((1,) * (ndim - t.ndim)))


def alpha_sigma(log_snr):
    """(alpha, sigma) = (sqrt(sigmoid(log_snr)), sqrt(sigmoid(-log_snr)))."""
    return torch.sqrt(torch.sigmoid(log_snr)), torch.sqrt(
        torch.sigmoid(-log_snr))


def logsnr_sample(diffusion, batch_size: int, step: Callable, init_noise,
                  step_noise, generator, graph=None):
    """The samplers of the log-SNR diffusions: times 1 -> 0 in
    `num_sample_steps` steps; `step(img, time, time_next)` (0-d fp32
    tensors) gives the posterior (mean, variance); noise is added except at
    time_next = 0 (a device mask on the last step); the result clipped to
    [-1, 1] and mapped to [0, 1], NHWC. init_noise ([B, H, W, C]) and
    step_noise ([steps, B, H, W, C]) replace the draws from `generator`,
    the initial one first. On the card each step replays one captured
    graph of the step (`graph` None; False and the CPU run it eagerly;
    True on the CPU raises), kept on `diffusion._graphs`."""
    dev = diffusion.device
    shape = (batch_size, diffusion.image_size, diffusion.image_size,
             diffusion.channels)
    img = (_nchw(torch.as_tensor(init_noise, dtype=torch.float32,
                                 device=dev)) if init_noise is not None
           else torch.randn(_channels_first(shape), generator=generator,
                            device=dev))
    steps_noise = (None if step_noise is None else torch.as_tensor(
        step_noise, dtype=torch.float32, device=dev).movedim(-1, 2))
    n = diffusion.num_sample_steps
    times = torch.from_numpy(np.linspace(
        1.0, 0.0, n + 1).astype(np.float32)).to(dev)

    def body(generators, carry, consts, row):
        img = carry["img"]
        mean, var = step(img, row["time"], row["time_next"])
        noise = _row_noise(row, img, generators)
        return {"img": torch.where(row["last"], mean,
                                   mean + torch.sqrt(var) * noise)}

    chain = ChainStep(body, graphs=diffusion._graphs, key=("logsnr", getattr(step, "__func__", step)),
                      graph=resolve_graph(graph, dev),
                      name=f"{type(diffusion).__name__} step")
    img = run_chain(chain, {"img": img}, n, table={
        "time": times[:-1], "time_next": times[1:],
        "last": torch.arange(n, device=dev) == n - 1,
        "noise": steps_noise}, generators=[generator])["img"]
    return unnormalize_to_zero_to_one(_nhwc(torch.clamp(img, -1.0, 1.0)))


def _noise_for(x_start, noise, generator):
    """The NCHW noise: `noise` (NHWC) as given, else a draw."""
    if noise is None:
        return draw_rows(lambda shape: torch.randn(
            shape, generator=generator, device=x_start.device),
            x_start.shape)
    return _nchw(torch.as_tensor(noise, dtype=torch.float32,
                                 device=x_start.device))


def _times_for(img, times, generator):
    if times is None:
        return draw_rows(lambda shape: torch.rand(
            shape, generator=generator, device=img.device),
            (img.shape[0],))
    return torch.as_tensor(times, dtype=torch.float32, device=img.device)


@dataclasses.dataclass
class ContinuousTimeGaussianDiffusion:
    """model(x [B,C,H,W], log_snr [B]) -> predicted noise. With
    noise_schedule "learned" the model must be a `LearnedScheduleDenoiser`,
    whose `log_snr` is the schedule."""

    model: Callable[..., torch.Tensor]
    image_size: int
    channels: int = 3
    noise_schedule: str = "linear"  # "linear" | "cosine" | "learned"
    num_sample_steps: int = 500
    clip_sample_denoised: bool = True
    min_snr_loss_weight: bool = False
    min_snr_gamma: float = 5.0
    device: str | torch.device = "cuda"  # no GPU raises; "cpu" on ask
    # the sampler's captured steps, by their key
    _graphs: ChainGraphs = dataclasses.field(
        default_factory=ChainGraphs, init=False, repr=False, compare=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.noise_schedule not in ("linear", "cosine", "learned"):
            raise ValueError(
                f"unknown noise schedule {self.noise_schedule!r}")
        if self.noise_schedule == "learned" and not isinstance(
                self.model, LearnedScheduleDenoiser):
            raise ValueError("the learned schedule needs a "
                             "LearnedScheduleDenoiser as the model")

    def log_snr(self, t):
        if self.noise_schedule == "linear":
            return beta_linear_log_snr(t)
        if self.noise_schedule == "cosine":
            return alpha_cosine_log_snr(t)
        return self.model.log_snr(t)

    @staticmethod
    def learned_endpoints():
        """(log_snr_max, log_snr_min) of the linear schedule, which anchor
        the learned one."""
        return (float(beta_linear_log_snr(torch.tensor(0.0))),
                float(beta_linear_log_snr(torch.tensor(1.0))))

    def q_sample(self, x_start, times, noise):
        """NCHW x_start and noise -> (x_t, log_snr [B])."""
        log_snr = self.log_snr(times)
        alpha, sigma = alpha_sigma(_pad(log_snr, x_start.ndim))
        return x_start * alpha + noise * sigma, log_snr

    def p_losses(self, x_start, times, *, noise=None,
                 generator: torch.Generator = None):
        """The noise-prediction MSE at `times` [B] in [0, 1]; NHWC x_start
        and `noise`, the noise drawn from `generator` when not given."""
        x_start = _nchw(torch.as_tensor(x_start, device=self.device))
        noise = _noise_for(x_start, noise, generator)
        x, log_snr = self.q_sample(x_start, times, noise)
        losses = ((self.model(x, log_snr) - noise) ** 2).mean(
            dim=tuple(range(1, x.ndim)))
        if self.min_snr_loss_weight:
            snr = torch.exp(log_snr)
            losses = losses * (torch.clamp(snr, min=self.min_snr_gamma)
                               / snr)
        return losses.mean()

    def loss(self, img, *, times=None, noise=None,
             generator: torch.Generator = None):
        """The training loss of NHWC images in [0, 1]: times uniform in
        [0, 1), then the noise, from `generator` unless given."""
        img = torch.as_tensor(img, device=self.device)
        times = _times_for(img, times, generator)
        return self.p_losses(normalize_to_neg_one_to_one(img), times,
                             noise=noise, generator=generator)

    def _posterior(self, x, time, time_next):
        log_snr, log_snr_next = self.log_snr(time), self.log_snr(time_next)
        c = -torch.expm1(log_snr - log_snr_next)
        alpha, sigma = alpha_sigma(log_snr)
        alpha_next = torch.sqrt(torch.sigmoid(log_snr_next))
        pred_noise = self.model(x, log_snr.expand(x.shape[0]))
        if self.clip_sample_denoised:
            x_start = torch.clamp((x - sigma * pred_noise) / alpha, -1.0, 1.0)
            mean = alpha_next * (x * (1 - c) / alpha + c * x_start)
        else:
            mean = alpha_next / alpha * (x - c * sigma * pred_noise)
        return mean, torch.sigmoid(-log_snr_next) * c

    @torch.inference_mode()
    def sample(self, batch_size: int = 16, *, init_noise=None,
               step_noise=None, generator: torch.Generator = None,
               graph=None):
        """Ancestral sampling over `num_sample_steps`; see
        `logsnr_sample`."""
        return logsnr_sample(self, batch_size, self._posterior, init_noise,
                             step_noise, generator, graph)


@dataclasses.dataclass
class VParamContinuousTimeGaussianDiffusion:
    """The v objective over the cosine log-SNR schedule (appendix D of the
    progressive-distillation paper); model(x, log_snr) -> v."""

    model: Callable[..., torch.Tensor]
    image_size: int
    channels: int = 3
    num_sample_steps: int = 500
    clip_sample_denoised: bool = True
    device: str | torch.device = "cuda"  # no GPU raises; "cpu" on ask
    _graphs: ChainGraphs = dataclasses.field(
        default_factory=ChainGraphs, init=False, repr=False, compare=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def p_losses(self, x_start, times, *, noise=None,
                 generator: torch.Generator = None):
        x_start = _nchw(torch.as_tensor(x_start, device=self.device))
        noise = _noise_for(x_start, noise, generator)
        log_snr = alpha_cosine_log_snr(times)
        alpha, sigma = alpha_sigma(_pad(log_snr, x_start.ndim))
        x = x_start * alpha + noise * sigma
        v = alpha * noise - sigma * x_start
        return ((self.model(x, log_snr) - v) ** 2).mean()

    def loss(self, img, *, times=None, noise=None,
             generator: torch.Generator = None):
        img = torch.as_tensor(img, device=self.device)
        times = _times_for(img, times, generator)
        return self.p_losses(normalize_to_neg_one_to_one(img), times,
                             noise=noise, generator=generator)

    def _posterior(self, img, time, time_next):
        log_snr = alpha_cosine_log_snr(time)
        log_snr_next = alpha_cosine_log_snr(time_next)
        c = -torch.expm1(log_snr - log_snr_next)
        alpha, sigma = alpha_sigma(log_snr)
        alpha_next = torch.sqrt(torch.sigmoid(log_snr_next))
        pred_v = self.model(img, log_snr.expand(img.shape[0]))
        x_start = alpha * img - sigma * pred_v  # appendix D
        if self.clip_sample_denoised:
            x_start = torch.clamp(x_start, -1.0, 1.0)
        mean = alpha_next * (img * (1 - c) / alpha + c * x_start)
        return mean, torch.sigmoid(-log_snr_next) * c

    @torch.inference_mode()
    def sample(self, batch_size: int = 16, *, init_noise=None,
               step_noise=None, generator: torch.Generator = None,
               graph=None):
        return logsnr_sample(self, batch_size, self._posterior, init_noise,
                             step_noise, generator, graph)
