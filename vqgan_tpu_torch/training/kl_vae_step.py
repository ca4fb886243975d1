"""The stage-1 KL-VAE training step.

Counterpart of the jitted `train_step` of cli/train_kl_vae.py: the sampled
posterior, `kl_vae_loss` (MSE, or L1 + w * LPIPS), backward, then the
optax chain `clip_by_global_norm(1.0)` + `adam(lr)`, which is
`LDMOptimizer` with no weight decay and `max_grad_norm` 1.0, its learning
rate constant or from `warmup_cosine_decay_schedule`. Eager, one step per
call; the logs stay on the device.

The posterior noise comes from a `torch.Generator` on the model's device,
or is injected (`noise`, NCHW), so that a test can drive the port and the
JAX package with the same numbers: the two cannot share a random stream.

On a mesh (`mesh`, the JAX CLI's batch placed P("data")) each rank steps
on its rows of the global batch: the posterior noise is the global
batch's draw (`parallel.mesh.draw_rows`: drawn from one generator in the
single-device order, then sliced; injected noise is the global batch's
too), the gradients are averaged over "data" before the clip, and the
logs are the global batch's, the same on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..models.autoencoder import kl_vae_loss
from ..models.lpips import perceptual_loss_fn
from ..parallel.mesh import global_batch, local_rows, mean_over_data
from .ldm_step import LDMOptimizer, warmup_cosine_decay_schedule

__all__ = ["lpips_perceptual_fn", "make_kl_vae_optimizer",
           "make_kl_vae_train_step"]


def make_kl_vae_optimizer(params, learning_rate: float, lr_schedule: str,
                          train_steps: int) -> LDMOptimizer:
    """Adam after a global-norm clip of 1.0, as the JAX CLI's chain. Under
    "cosine" the learning rate warms up from lr / 10 over max(1, steps //
    20) updates, then falls by a cosine to lr / 20 at `train_steps`."""
    schedule = None
    if lr_schedule == "cosine":
        schedule = warmup_cosine_decay_schedule(
            learning_rate / 10, learning_rate, max(1, train_steps // 20),
            train_steps, learning_rate / 20)
    elif lr_schedule != "constant":
        raise ValueError(f"unknown lr_schedule {lr_schedule!r}")
    return LDMOptimizer(params, learning_rate=learning_rate,
                        weight_decay=0.0, betas=(0.9, 0.999),
                        max_grad_norm=1.0, schedule=schedule)


def lpips_perceptual_fn(lpips: nn.Module, weight: float) -> Callable:
    """The JAX CLI's perceptual term for `kl_vae_loss`: fn(recon, inputs)
    (NCHW in [0, 1]) -> {"total": L1 + weight * mean LPIPS, "perceptual":
    mean LPIPS}, LPIPS read on [-1, 1] images."""
    distance = perceptual_loss_fn(lpips)

    def fn(recon, inputs):
        p = torch.mean(distance(recon, inputs))
        l1 = torch.mean(torch.abs(recon - inputs))
        return {"total": l1 + weight * p, "perceptual": p}

    return fn


def make_kl_vae_train_step(vae: nn.Module, optimizer: LDMOptimizer, *,
                           kl_weight: float = 1e-6,
                           perceptual_fn: Optional[Callable] = None,
                           mesh=None):
    """train_step(images [B, H, W, C] in [0, 1], *, generator=None,
    noise=None) -> {"loss", "rec_loss", "kl_loss", "perceptual_loss"},
    detached 0-d tensors on the device. One update of `vae` by
    `optimizer`. On `mesh`, images are this rank's rows and `noise` (if
    given) the global batch's."""

    def train_step(images, *, generator: Optional[torch.Generator] = None,
                   noise=None) -> dict:
        optimizer.zero_grad()
        x = images.permute(0, 3, 1, 2)
        if noise is not None and mesh is not None:
            noise = local_rows(torch.as_tensor(noise), mesh)
        with global_batch(mesh):
            recon, posterior = vae(x, generator=generator, noise=noise)
        parts = kl_vae_loss(recon, x, posterior, kl_weight=kl_weight,
                            perceptual_fn=perceptual_fn)
        parts["loss"].backward()
        optimizer.step(mean_over_data(optimizer.grads(), mesh))
        keys = list(parts)
        return dict(zip(keys, mean_over_data(
            [parts[k].detach() for k in keys], mesh)))

    return train_step
