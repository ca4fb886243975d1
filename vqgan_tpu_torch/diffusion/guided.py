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
from .gaussian import GaussianDiffusion, _row_noise

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


def _guidance(cond_fn, guidance_kwargs):
    """(consts, guide) of a guided chain: the tensors of guidance_kwargs
    are the step graph's inputs; cond_fn and the other kwargs, the guide,
    what the graph was captured for (`graphs.ChainStep`'s `latest`: a new
    guide replaces the sampler's graph). The guide must be hashable, on
    every device: a list kwarg raises TypeError here."""
    kwargs = guidance_kwargs or {}
    consts = {f"guide_{k}": v for k, v in kwargs.items() if torch.is_tensor(v)}
    others = {k: v for k, v in kwargs.items() if not torch.is_tensor(v)}
    guide = (cond_fn, tuple(sorted(others.items())))
    try:
        hash(guide)
    except TypeError as e:
        raise TypeError(f"guidance_kwargs that are not tensors must be "
                        f"hashable: {e}") from None
    return consts, guide


def _guide_kwargs(consts, guide):
    """The guidance kwargs of a step: its tensors from `consts`, the rest
    from `guide` (`_guidance`)."""
    return {**dict(guide[1]), **{k[len("guide_"):]: v for k, v in
                                 consts.items() if k.startswith("guide_")}}


@dataclasses.dataclass
class GuidedGaussianDiffusion(GaussianDiffusion):
    """Unconditional sampling guided by `cond_fn(x, t, **guidance_kwargs)
    -> grad`. On the card each sampler step replays one captured graph
    (`graph` as in `GaussianDiffusion.ddim_sample`), cond_fn's
    `torch.autograd.grad` inside it, the kwargs' tensors copied in at
    every step. Each sampler keeps the graph of the latest cond_fn and
    non-tensor kwargs only: a call with others captures anew."""

    def condition_mean(self, mean, variance, x, t, cond_fn, guidance_kwargs):
        return mean + variance * cond_fn(x, t, **guidance_kwargs)

    @torch.no_grad()
    def p_sample_loop_guided(self, shape, cond_fn: Optional[Callable] = None,
                             guidance_kwargs: Optional[dict] = None, *,
                             clip_denoised: bool = True, init_noise=None,
                             step_noise=None,
                             generator: torch.Generator = None,
                             graph: Optional[bool] = None):
        """Ancestral sampling with the mean shifted by the guidance; noise
        as in `GaussianDiffusion.p_sample_loop`."""
        consts, guide = _guidance(cond_fn, guidance_kwargs)

        def mean_and_log_var(img, tb, consts):
            _, x_start = self.model_predictions(img, tb, cond_scale=1.0)
            if clip_denoised:
                x_start = torch.clamp(x_start, -1.0, 1.0)
            mean, var, log_var = dm.q_posterior(self.schedule, x_start, img,
                                                tb)
            if cond_fn is not None:
                mean = self.condition_mean(mean, var, img, tb, cond_fn,
                                           _guide_kwargs(consts, guide))
            return mean, log_var

        return self._ancestral_loop(
            shape, mean_and_log_var, ("guided", clip_denoised), False,
            init_noise, step_noise, generator, consts=consts, graph=graph,
            latest=guide)

    @torch.no_grad()
    def ddim_sample_guided(self, shape, cond_fn: Optional[Callable] = None,
                           guidance_kwargs: Optional[dict] = None, *,
                           clip_denoised: bool = True, init_noise=None,
                           step_noise=None,
                           generator: torch.Generator = None,
                           graph: Optional[bool] = None):
        """DDIM with eps' = eps - sqrt(1 - alpha_bar) * grad; noise and
        `graph` as in `GaussianDiffusion.ddim_sample`."""
        consts, guide = _guidance(cond_fn, guidance_kwargs)
        sched = self.schedule

        def body(generators, carry, consts, row):
            img, tb = carry["img"], row["time"]
            noise = _row_noise(row, img, generators)
            pred_noise, x_start = self.model_predictions(
                img, tb, cond_scale=1.0, clip_x_start=clip_denoised)
            if cond_fn is not None:
                grad = cond_fn(img, tb, **_guide_kwargs(consts, guide))
                pred_noise = pred_noise - dm.extract(
                    sched.sqrt_one_minus_alphas_cumprod, tb, img.ndim) * grad
                x_start = dm.predict_start_from_noise(sched, img, tb,
                                                      pred_noise)
                if clip_denoised:
                    x_start = torch.clamp(x_start, -1.0, 1.0)
            return {"img": dm.ddim_step(sched, img, x_start, pred_noise, tb,
                                        row["time_next"], noise,
                                        self.ddim_sampling_eta)}

        pairs = torch.tensor(self.ddim_time_pairs(), dtype=torch.long,
                             device=self.device)[:, :, None].expand(
                                 -1, -1, shape[0])
        img = self._initial_noise(shape, init_noise, generator)
        return self._chain(
            img, body, ("guided DDIM", clip_denoised),
            {"time": pairs[:, 0], "time_next": pairs[:, 1]}, consts=consts,
            step_noise=step_noise, generator=generator, graph=graph,
            latest=guide, name="DDIM step")
