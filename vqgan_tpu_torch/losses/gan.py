"""GAN losses for stage-1 VQ-GAN training.

Counterpart of vqgan_tpu/losses/gan.py: hinge and vanilla losses for D and
G, the adaptive weight ||grad nll|| / (||grad g|| + 1e-4) clipped to
[0, 1e4], the generator loss (L1 + perceptual + gated adversarial) and the
discriminator loss with its accuracy monitor. Pure functions of tensors;
`disc_active` may be a bool or a 0-d tensor.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["hinge_d_loss", "vanilla_d_loss", "hinge_g_loss",
           "vanilla_g_loss", "adaptive_disc_weight", "generator_loss",
           "discriminator_loss"]


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real))
                  + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.softplus(-logits_real))
                  + torch.mean(F.softplus(logits_fake)))


def hinge_g_loss(logits_fake):
    return -torch.mean(logits_fake)


def vanilla_g_loss(logits_fake):
    return torch.mean(F.softplus(-logits_fake))


_G_LOSSES = {"hinge": hinge_g_loss, "vanilla": vanilla_g_loss}
_D_LOSSES = {"hinge": hinge_d_loss, "vanilla": vanilla_d_loss}


def adaptive_disc_weight(nll_grad_norm, g_grad_norm, clip_max: float = 1e4):
    """w = ||grad nll|| / (||grad g|| + 1e-4), clipped, no gradient."""
    w = nll_grad_norm / (g_grad_norm + 1e-4)
    return torch.clamp(w, 0.0, clip_max).detach()


def _scalar(value, like) -> torch.Tensor:
    """`value` (a number or a 0-d tensor) as a float32 tensor on `like`'s
    device; a number is filled in on the device (no host copy, which a
    CUDA graph could not capture)."""
    if torch.is_tensor(value):
        return value.to(device=like.device, dtype=torch.float32)
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def _active(disc_active, like) -> torch.Tensor:
    return _scalar(disc_active, like)


def generator_loss(inputs, reconstructions, logits_fake, *, disc_active,
                   disc_weight: float = 0.1, perceptual_weight: float = 1.0,
                   disc_loss_type: str = "hinge",
                   perceptual_fn: Optional[Callable] = None,
                   adaptive_weight=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """L1 + perceptual + adversarial (gated by `disc_active`) generator
    loss. perceptual_fn(recon, inputs) takes [0, 1] images."""
    rec_loss = torch.mean(torch.abs(inputs - reconstructions))
    if perceptual_fn is not None:
        p_loss = torch.mean(perceptual_fn(reconstructions, inputs))
    else:
        p_loss = torch.zeros((), device=rec_loss.device)
    nll_loss = rec_loss + perceptual_weight * p_loss
    log = {"rec_loss": rec_loss, "perceptual_loss": p_loss,
           "nll_loss": nll_loss}
    if logits_fake is None:
        return nll_loss, {**log, "total_loss": nll_loss}

    g_loss = _G_LOSSES[disc_loss_type](logits_fake)
    weight = disc_weight if adaptive_weight is None else (
        adaptive_weight * disc_weight)
    active = _active(disc_active, rec_loss)
    loss = nll_loss + active * weight * g_loss
    log.update({"g_loss": g_loss,
                "disc_weight": _scalar(weight, rec_loss) * active,
                "total_loss": loss})
    return loss, log


def discriminator_loss(logits_real, logits_fake, *, disc_active,
                       disc_loss_type: str = "hinge"
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Hinge or vanilla D loss (times `disc_active`) with the accuracy
    monitor."""
    d_loss = _D_LOSSES[disc_loss_type](logits_real, logits_fake)
    active = _active(disc_active, d_loss)
    real_acc = torch.mean((logits_real > 0).float())
    fake_acc = torch.mean((logits_fake < 0).float())
    log = {"d_loss": active * d_loss,
           "logits_real": torch.mean(logits_real),
           "logits_fake": torch.mean(logits_fake),
           "d_acc": 0.5 * (real_acc + fake_acc) * active}
    return active * d_loss, log
