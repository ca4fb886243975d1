"""Gaussian diffusion with classifier-free guidance: the training loss and
the DDIM sampler.

Counterpart of vqgan_tpu/diffusion/gaussian.py for training and generation:
`p_losses` and `loss` (Min-SNR weighted, offset noise, cond-drop; t, noise
and the cond-drop mask can be injected), `model_predictions` (with the CFG
[cond; null] pair as one 2B-batch forward), `ddim_sample` (a Python loop
over the (time, time_next) pairs, with injectable noise) and `sample`. NCHW
inside; the public functions take and return NHWC latents, like the JAX
package. The ancestral sampler, `interpolate`, immiscible noise,
self-conditioning, CFG++ and `return_all_timesteps` come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core import diffusion_math as dm
from ..core.guidance import apply_cfg
from ..core.schedules import DiffusionSchedule, make_schedule

__all__ = ["GaussianDiffusion"]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


@dataclasses.dataclass
class GaussianDiffusion:
    """Diffusion wrapper around a denoiser.

    model(x [B,C,H,W], t [B], classes [B], *, cond_drop_mask) -> prediction.
    Defaults as in the JAX package: DDIM eta 1.0, cosine betas.
    """

    model: Callable[..., torch.Tensor]
    image_size: int
    channels: int = 3
    timesteps: int = 1000
    sampling_timesteps: Optional[int] = None
    objective: str = "pred_noise"
    beta_schedule: str = "cosine"
    ddim_sampling_eta: float = 1.0
    offset_noise_strength: float = 0.0
    min_snr_loss_weight: bool = False
    min_snr_gamma: float = 5.0
    auto_normalize: bool = True
    device: torch.device = torch.device("cpu")
    schedule: DiffusionSchedule = None

    def __post_init__(self):
        if self.objective not in ("pred_noise", "pred_x0", "pred_v"):
            raise ValueError(f"unknown objective {self.objective!r}")
        if self.schedule is None:
            self.schedule = make_schedule(
                self.beta_schedule, self.timesteps, objective=self.objective,
                min_snr_loss_weight=self.min_snr_loss_weight,
                min_snr_gamma=self.min_snr_gamma, device=self.device)
        if self.sampling_timesteps is None:
            self.sampling_timesteps = self.timesteps
        if self.sampling_timesteps > self.timesteps:
            raise ValueError("sampling_timesteps exceeds timesteps")
        self.is_ddim_sampling = self.sampling_timesteps < self.timesteps

    def normalize(self, x):
        return dm.normalize_to_neg_one_to_one(x) if self.auto_normalize else x

    def unnormalize(self, x):
        return dm.unnormalize_to_zero_to_one(x) if self.auto_normalize else x

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def p_losses(self, x_start, t, classes, *, noise=None,
                 cond_drop_mask=None, cond_drop_prob: Optional[float] = None,
                 generator: torch.Generator = None,
                 return_features: bool = False):
        """Min-SNR-weighted MSE of the model's prediction at times `t` [B].
        x_start and `noise` are NHWC; noise is drawn from `generator` when
        not given, as are the offset noise and, without `cond_drop_mask`,
        the model's random class dropout. Returns the scalar loss, and the
        model's mid-block features with `return_features`."""
        x_start = _nchw(torch.as_tensor(x_start, device=self.device))
        b, c = x_start.shape[:2]
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator,
                                device=x_start.device)
        else:
            noise = _nchw(torch.as_tensor(noise, dtype=torch.float32,
                                          device=x_start.device))
        if self.offset_noise_strength > 0.0:
            # per-(sample, channel) constant offset
            offset = torch.randn((b, c), generator=generator,
                                 device=x_start.device)
            noise = noise + self.offset_noise_strength * offset[:, :, None,
                                                                None]
        t = torch.as_tensor(t, device=x_start.device)
        x = dm.q_sample(self.schedule, x_start, t, noise)
        model_out = self.model(x, t, classes, cond_drop_mask=cond_drop_mask,
                               cond_drop_prob=cond_drop_prob,
                               generator=generator,
                               return_features=return_features)
        features = None
        if return_features:
            model_out, features = model_out

        if self.objective == "pred_noise":
            target = noise
        elif self.objective == "pred_x0":
            target = x_start
        else:
            target = dm.predict_v(self.schedule, x_start, t, noise)
        loss = ((model_out.float() - target.float()) ** 2).mean(
            dim=tuple(range(1, model_out.ndim)))
        loss = (loss * self.schedule.loss_weight[t]).mean()
        return (loss, features) if return_features else loss

    def loss(self, img, classes, *, t=None, generator: torch.Generator = None,
             **kwargs):
        """The training objective: t uniform in [0, T) from `generator`
        (unless given), normalize, then `p_losses`. `img` is NHWC."""
        img = torch.as_tensor(img, device=self.device)
        if t is None:
            t = torch.randint(0, self.timesteps, (img.shape[0],),
                              generator=generator, device=img.device)
        return self.p_losses(self.normalize(img), t, classes,
                             generator=generator, **kwargs)

    def model_predictions(self, x, t, classes, *, cond_scale: float = 6.0,
                          rescaled_phi: float = 0.7,
                          clip_x_start: bool = False):
        """NCHW x, t [B], classes [B] -> (pred_noise, pred_x_start)."""
        sched = self.schedule
        b = x.shape[0]
        if cond_scale == 1.0:
            # one conditional forward
            model_output = self.model(
                x, t, classes,
                cond_drop_mask=torch.zeros(b, dtype=torch.bool,
                                           device=x.device))
        else:
            # [cond; null] as one 2B-batch forward
            mask = torch.cat([torch.zeros(b, dtype=torch.bool),
                              torch.ones(b, dtype=torch.bool)]).to(x.device)
            both = self.model(torch.cat([x, x]), torch.cat([t, t]),
                              torch.cat([classes, classes]),
                              cond_drop_mask=mask)
            model_output = apply_cfg(both[:b], both[b:], cond_scale,
                                     rescaled_phi)

        def maybe_clip(z):
            return torch.clamp(z, -1.0, 1.0) if clip_x_start else z

        if self.objective == "pred_noise":
            pred_noise = model_output
            x_start = maybe_clip(
                dm.predict_start_from_noise(sched, x, t, model_output))
        elif self.objective == "pred_x0":
            x_start = maybe_clip(model_output)
            pred_noise = dm.predict_noise_from_start(sched, x, t, x_start)
        else:  # pred_v
            x_start = maybe_clip(
                dm.predict_start_from_v(sched, x, t, model_output))
            pred_noise = dm.predict_noise_from_start(sched, x, t, x_start)
        return pred_noise, x_start

    def ddim_time_pairs(self):
        """[(T-1, ...), ..., (0, -1)] as Python ints."""
        times = np.linspace(-1, self.timesteps - 1,
                            num=self.sampling_timesteps + 1).astype(int)[::-1]
        return [(int(a), int(b)) for a, b in zip(times[:-1], times[1:])]

    @torch.inference_mode()
    def ddim_sample(self, shape, classes, *, cond_scale: float = 6.0,
                    rescaled_phi: float = 0.7, clip_denoised: bool = True,
                    init_noise=None, step_noise=None,
                    generator: torch.Generator = None):
        """DDIM sampler. `shape` is NHWC. init_noise ([*shape]) and step_noise
        ([sampling_timesteps, *shape]), NHWC, replace the drawn noise; the
        tests drive the port and the JAX package with the same numbers.
        Otherwise noise comes from `generator`."""
        b, h, w, c = shape
        dev = self.device

        def randn():
            return torch.randn((b, c, h, w), generator=generator, device=dev)

        img = (_nchw(torch.as_tensor(init_noise, dtype=torch.float32,
                                     device=dev))
               if init_noise is not None else randn())
        if step_noise is not None:
            step_noise = torch.as_tensor(step_noise, dtype=torch.float32,
                                         device=dev).permute(0, 1, 4, 2, 3)
        classes = torch.as_tensor(classes, device=dev)
        for i, (time, time_next) in enumerate(self.ddim_time_pairs()):
            tb = torch.full((b,), time, dtype=torch.long, device=dev)
            pred_noise, x_start = self.model_predictions(
                img, tb, classes, cond_scale=cond_scale,
                rescaled_phi=rescaled_phi, clip_x_start=clip_denoised)
            noise = step_noise[i] if step_noise is not None else randn()
            img = dm.ddim_step(self.schedule, img, x_start, pred_noise, time,
                               time_next, noise, self.ddim_sampling_eta)
        return self.unnormalize(_nhwc(img))

    def sample(self, batch_size: Optional[int] = None, classes=None, *,
               cond_scale: float = 6.0, rescaled_phi: float = 0.7,
               generator: torch.Generator = None):
        """NHWC samples for `classes`; DDIM when sampling_timesteps < T."""
        if batch_size is None:
            batch_size = len(classes)
        if not self.is_ddim_sampling:
            raise NotImplementedError(
                "the ancestral (DDPM) sampler is not ported yet; set "
                "sampling_timesteps below timesteps for DDIM")
        shape = (batch_size, self.image_size, self.image_size, self.channels)
        return self.ddim_sample(shape, classes, cond_scale=cond_scale,
                                rescaled_phi=rescaled_phi, generator=generator)
