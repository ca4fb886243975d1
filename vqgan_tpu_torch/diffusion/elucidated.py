"""Elucidated diffusion (EDM, Karras et al. 2022).

Counterpart of vqgan_tpu/diffusion/elucidated.py: the Table-1
preconditioners (c_skip, c_out, c_in, c_noise = log(sigma) / 4), the
rho-schedule with a trailing 0, the stochastic Heun sampler with churn, the
DPM-Solver++(2M) sampler, the log-normal training sigma and the EDM loss
weight, with optional self-conditioning.

- The schedule lives on the host as float32 numpy, so the per-step scalar
  arithmetic (sigma_hat, the churn, DPM++'s log-sigma steps) is float32
  as in the JAX package's scan, and no step reads the device: each
  sampler computes its per-step table once (`heun_table`, `dpmpp_table`)
  and feeds row i to one step body as a tensor.
- The body branches on no step: Heun's second-order forward always runs,
  2 forwards per step, and its result is discarded at sigma_next = 0, and
  DPM++'s first and last steps take the plain update, each by a device
  mask (`torch.where`), as the JAX package masks them. On the card each
  step replays the body's captured CUDA graph (`graphs.run_chain`;
  `graph=False`, and the CPU, run it eagerly).
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
from ..graphs import ChainGraphs, ChainStep, resolve_graph, run_chain
from ..parallel.mesh import draw_rows

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
    # the samplers' captured steps, by their key
    _graphs: ChainGraphs = dataclasses.field(
        default_factory=ChainGraphs, init=False, repr=False, compare=False)

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

    @staticmethod
    def _finish(images):
        return unnormalize_to_zero_to_one(
            torch.clamp(images, -1.0, 1.0)).permute(0, 2, 3, 1)

    def heun_table(self, num_sample_steps: Optional[int] = None):
        """Heun's per-step scalars, [steps, 6] float32 numpy, by column:
        sigma_hat, the churn's std, sigma_next clamped to 1e-8, sigma_next
        - sigma_hat, half of it, and 1 where sigma_next = 0 (the last
        step: the first-order result is kept)."""
        n = num_sample_steps or self.num_sample_steps
        sigmas = self.sample_schedule(n)
        churn = np.float32(min(self.S_churn / n, math.sqrt(2) - 1))
        gammas = np.where((sigmas >= self.S_tmin) & (sigmas <= self.S_tmax),
                          churn, np.float32(0.0)).astype(np.float32)
        rows = []
        for i in range(n):
            sigma, sigma_next, gamma = sigmas[i], sigmas[i + 1], gammas[i]
            sigma_hat = sigma + gamma * sigma
            churn_std = np.sqrt(np.maximum(sigma_hat ** 2 - sigma ** 2,
                                           np.float32(0.0)))
            rows.append([sigma_hat, churn_std,
                         np.maximum(sigma_next, np.float32(1e-8)),
                         sigma_next - sigma_hat,
                         np.float32(0.5) * (sigma_next - sigma_hat),
                         sigma_next == 0.0])
        return np.asarray(rows, dtype=np.float32)

    def dpmpp_table(self, num_sample_steps: Optional[int] = None):
        """DPM++(2M)'s per-step scalars, [steps, 6] float32 numpy, by
        column: sigma, sigma(t_next) / sigma(t), expm1(-h), 1 - gamma,
        gamma, and 1 where the plain update is taken (the first step, which
        has no previous denoised, and sigma_next = 0)."""
        n = num_sample_steps or self.num_sample_steps
        sigmas = self.sample_schedule(n)

        def t_fn(s):
            return -np.log(np.maximum(s, np.float32(1e-20)))

        def sigma_fn(t):
            return np.exp(-t)

        rows = []
        for i in range(n):
            sigma, sigma_next = sigmas[i], sigmas[i + 1]
            t, t_next = t_fn(sigma), t_fn(sigma_next)
            h = t_next - t
            plain = i == 0 or sigma_next == 0.0
            gamma = np.float32(0.0)
            if not plain:
                h_last = t - t_fn(sigmas[i - 1])
                r = h_last / (h if h != 0 else np.float32(1.0))
                gamma = np.float32(-1.0) / (
                    np.float32(2.0) * (r if r != 0 else np.float32(1.0)))
            rows.append([sigma, sigma_fn(t_next) / sigma_fn(t), np.expm1(-h),
                         np.float32(1.0) - gamma, gamma, plain])
        return np.asarray(rows, dtype=np.float32)

    def _chain(self, images, body, key, table, *, carry_old: bool,
               generator, graph, name: str):
        step = ChainStep(body, graphs=self._graphs, key=key,
                         graph=resolve_graph(graph, self.device),
                         name=f"EDM {name}")
        carry = run_chain(
            step, {"img": images,
                   "old": torch.zeros_like(images) if carry_old else None},
            len(table["s"]), table=table, generators=[generator])
        return self._finish(carry["img"])

    def _table(self, rows):
        return torch.from_numpy(rows).to(self.device)

    @torch.inference_mode()
    def sample(self, batch_size: int = 16,
               num_sample_steps: Optional[int] = None, clamp: bool = True,
               *, init_noise=None, step_noise=None,
               generator: Optional[torch.Generator] = None,
               graph: Optional[bool] = None):
        """Stochastic Heun sampler with churn -> NHWC images in [0, 1].
        init_noise ([B, H, W, C]) and step_noise ([steps, B, H, W, C]) are
        the unit normal draws, NHWC; otherwise drawn from `generator`, the
        initial one first. `graph` None replays one captured step's graph
        per step on the card and runs the steps eagerly on the CPU; False
        runs them eagerly; True on the CPU raises."""
        n = num_sample_steps or self.num_sample_steps
        b = batch_size
        shape = (b, self.image_size, self.image_size, self.channels)
        images = self._initial(shape, self.sample_schedule(n)[0], init_noise,
                               generator)
        steps = (None if step_noise is None else torch.as_tensor(
            step_noise, dtype=torch.float32,
            device=self.device).permute(0, 1, 4, 2, 3))
        self_cond = self.self_condition

        def body(generators, carry, consts, row):
            images, s = carry["img"], row["s"]
            sigma_hat, churn_std, sigma_next_c, dt, half_dt = s[:5]
            eps = (row["eps"] if "eps" in row else torch.randn(
                images.shape, generator=generators[0],
                device=images.device)) * self.S_noise
            images_hat = images + churn_std * eps

            model_output = self.preconditioned_forward(
                images_hat, sigma_hat.expand(b), carry.get("old"),
                clamp=clamp)
            denoised_over_sigma = (images_hat - model_output) / sigma_hat
            images_next = images_hat + dt * denoised_over_sigma

            # the second-order correction, discarded at sigma_next == 0
            model_output_next = self.preconditioned_forward(
                images_next, sigma_next_c.expand(b),
                model_output if self_cond else None, clamp=clamp)
            denoised_prime = (images_next - model_output_next) / sigma_next_c
            images_heun = images_hat + half_dt * (denoised_over_sigma
                                                  + denoised_prime)
            last = s[5] != 0
            return {"img": torch.where(last, images_next, images_heun),
                    "old": torch.where(last, model_output, model_output_next)
                    if self_cond else None}

        return self._chain(images, body, ("heun", clamp),
                           {"s": self._table(self.heun_table(n)),
                            "eps": steps},
                           carry_old=self_cond, generator=generator,
                           graph=graph, name="Heun step")

    @torch.inference_mode()
    def sample_using_dpmpp(self, batch_size: int = 16,
                           num_sample_steps: Optional[int] = None, *,
                           init_noise=None,
                           generator: Optional[torch.Generator] = None,
                           graph: Optional[bool] = None):
        """DPM-Solver++(2M) -> NHWC images in [0, 1]; init_noise, the unit
        normal draw [B, H, W, C], or one from `generator`; `graph` as in
        `sample`."""
        n = num_sample_steps or self.num_sample_steps
        b = batch_size
        shape = (b, self.image_size, self.image_size, self.channels)
        images = self._initial(shape, self.sample_schedule(n)[0], init_noise,
                               generator)

        def body(generators, carry, consts, row):
            images, s = carry["img"], row["s"]
            sigma, ratio, expm1_neg_h, one_minus_gamma, gamma = s[:5]
            denoised = self.preconditioned_forward(images, sigma.expand(b))
            denoised_d = torch.where(
                s[5] != 0, denoised,
                one_minus_gamma * denoised + gamma * carry["old"])
            return {"img": ratio * images - expm1_neg_h * denoised_d,
                    "old": denoised}

        return self._chain(images, body, ("dpmpp",),
                           {"s": self._table(self.dpmpp_table(n))},
                           carry_old=True, generator=generator, graph=graph,
                           name="DPM++ step")

    # training ---------------------------------------------------------------

    def loss_weight(self, sigma):
        return (sigma ** 2 + self.sigma_data ** 2) * (
            sigma * self.sigma_data) ** -2

    def noise_distribution(self, batch_size: int,
                           generator: Optional[torch.Generator] = None):
        return torch.exp(self.P_mean + self.P_std * draw_rows(
            lambda shape: torch.randn(shape, generator=generator,
                                      device=self.device), (batch_size,)))

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
        noise = (draw_rows(lambda shape: torch.randn(
                     shape, generator=generator, device=self.device),
                     images.shape)
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
