"""The two-optimizer VQ-GAN training step.

Counterpart of vqgan_tpu/training/vqgan_step.py's split steps
(`make_vqgan_split_steps`), eager: a G step and a D step per call, the
caller dispatching the D step only from `disc_start` on.

- G step: L1 + LPIPS + VQ loss, plus the adversarial term gated by
  `step >= disc_start`. It reads the discriminator in eval mode (running
  BatchNorm statistics, no update of them) with its parameters frozen, so
  no gradient reaches D. Before `disc_start` the D logits are computed
  without a graph: the term is multiplied by 0, and its gradient is 0.
- D step: two train-mode passes, real images then the detached
  reconstruction, so the BatchNorm running statistics update twice, in
  that order, as the JAX package's.
- Adaptive weight (`use_adaptive_weight`): ||grad nll|| / (||grad g|| +
  1e-4) at `decoder.conv_out.weight`, by `torch.autograd.grad` on the
  step's own graph (the JAX package recomputes the forward for each of its
  two `jax.grad` calls; the gradients are the same). As there, g is
  -mean(logits) whatever the loss type. It is computed only while the
  term is active: before that its factor is 0.
- Both optimizers are `LDMOptimizer` chains without warm-up: Adam(W) with
  optax's clipping rule and MultiSteps accumulation.
- `reset_codebook_moments` zeroes the Adam moments (and the accumulated
  gradient) of revived codebook rows.

Images and reconstructions cross the step functions in NHWC, as in JAX;
the modules run NCHW. The JAX package's fused and scan step modes exist to
amortise XLA compiles and dispatch and are not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..losses.gan import (
    adaptive_disc_weight,
    discriminator_loss,
    generator_loss,
)
from .ldm_step import LDMOptimizer

__all__ = ["VQGANTrainState", "make_gan_optimizers",
           "make_vqgan_split_steps", "reset_codebook_moments"]


def make_gan_optimizers(vqvae_params, disc_params,
                        learning_rate: float = 4.5e-5,
                        disc_learning_rate: float = 4.5e-5,
                        betas: Tuple[float, float] = (0.5, 0.9),
                        weight_decay: float = 0.0,
                        max_grad_norm: Optional[float] = 1.0,
                        gradient_accumulate_every: int = 1):
    """(G optimizer, D optimizer): Adam (AdamW when weight_decay > 0) with
    global-norm clipping; k > 1 averages k gradients per update."""

    def chain(params, lr):
        return LDMOptimizer(params, learning_rate=lr,
                            weight_decay=weight_decay, betas=betas,
                            max_grad_norm=max_grad_norm,
                            gradient_accumulate_every=gradient_accumulate_every)

    return (chain(vqvae_params, learning_rate),
            chain(disc_params, disc_learning_rate))


def reset_codebook_moments(optimizer: LDMOptimizer, codebook: nn.Parameter,
                           dead_mask: torch.Tensor) -> None:
    """Zero the optimizer's per-row state of the codebook rows in
    `dead_mask` [K]: Adam's moments and, under accumulation, the running
    gradient mean. A revived code's stale moments would drag it away from
    its new anchor."""
    rows = dead_mask[:, None]
    state = optimizer.inner.state.get(codebook, {})
    for key in ("exp_avg", "exp_avg_sq"):
        if key in state:
            state[key].masked_fill_(rows, 0.0)
    if optimizer.acc is not None:
        i = next(i for i, p in enumerate(optimizer.params) if p is codebook)
        optimizer.acc[i].masked_fill_(rows, 0.0)


@dataclasses.dataclass
class VQGANTrainState:
    """step (a host integer: G steps taken), the VQ-VAE, the discriminator
    and their optimizers."""

    step: int
    vqvae: nn.Module
    disc: nn.Module
    opt_g: LDMOptimizer
    opt_d: LDMOptimizer

    def state_dict(self) -> dict:
        """Step, both models (the discriminator with its BatchNorm running
        statistics) and both optimizer states."""
        return {"step": self.step, "vqvae": self.vqvae.state_dict(),
                "disc": self.disc.state_dict(),
                "opt_g": self.opt_g.state_dict(),
                "opt_d": self.opt_d.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.vqvae.load_state_dict(state["vqvae"])
        self.disc.load_state_dict(state["disc"])
        self.opt_g.load_state_dict(state["opt_g"])
        self.opt_d.load_state_dict(state["opt_d"])


@contextlib.contextmanager
def _frozen(module: nn.Module):
    """No parameter of `module` takes a gradient inside the block."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def _nchw(images):
    return images.permute(0, 3, 1, 2)


def make_vqgan_split_steps(*, disc_start: int = 10000,
                           disc_weight: float = 0.1,
                           perceptual_weight: float = 1.0,
                           disc_loss_type: str = "hinge",
                           perceptual_fn: Optional[Callable] = None,
                           use_adaptive_weight: bool = False):
    """(g_step, d_step):

        g_step(state, images)        -> (recon NHWC, detached; G log)
        d_step(state, images, recon) -> D log

    images [B, H, W, C] in [0, 1]. `g_step` updates the VQ-VAE and advances
    `state.step`; `d_step` updates the discriminator and is unconditional:
    the caller runs it only where the pre-increment step >= disc_start.
    Logs hold detached tensors on the device (usage_counts is [K])."""

    def g_step(state: VQGANTrainState, images):
        x = _nchw(images)
        active = state.step >= disc_start
        state.vqvae.train()
        state.disc.eval()
        state.opt_g.zero_grad()
        with _frozen(state.disc):
            recon, loss_dict, _ = state.vqvae(x)
            with torch.set_grad_enabled(active):
                logits_fake = state.disc(recon)
            adaptive = None
            if use_adaptive_weight and active:
                last = state.vqvae.decoder.conv_out.weight
                nll = torch.mean(torch.abs(x - recon))
                if perceptual_fn is not None:
                    nll = nll + perceptual_weight * torch.mean(
                        perceptual_fn(recon, x))
                nll_grad, = torch.autograd.grad(nll, last, retain_graph=True)
                g_grad, = torch.autograd.grad(-torch.mean(logits_fake), last,
                                              retain_graph=True)
                adaptive = adaptive_disc_weight(torch.linalg.norm(nll_grad),
                                                torch.linalg.norm(g_grad))
            gan_total, log = generator_loss(
                x, recon, logits_fake, disc_active=active,
                disc_weight=disc_weight, perceptual_weight=perceptual_weight,
                disc_loss_type=disc_loss_type, perceptual_fn=perceptual_fn,
                adaptive_weight=adaptive)
            total = gan_total + loss_dict["vq_loss"]
            total.backward()
        state.opt_g.step(state.opt_g.grads())
        state.step += 1
        log = {**log, **loss_dict, "loss_total": total}
        return (recon.detach().permute(0, 2, 3, 1),
                {k: v.detach() for k, v in log.items()})

    def d_step(state: VQGANTrainState, images, recon):
        state.disc.train()
        state.opt_d.zero_grad()
        logits_real = state.disc(_nchw(images))
        logits_fake = state.disc(_nchw(recon).detach())
        d_loss, log = discriminator_loss(logits_real, logits_fake,
                                         disc_active=True,
                                         disc_loss_type=disc_loss_type)
        d_loss.backward()
        state.opt_d.step(state.opt_d.grads())
        return {k: v.detach() for k, v in log.items()}

    return g_step, d_step
