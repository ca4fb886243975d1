"""The stage-2 training step over a mesh: data parallel, ZeRO-1, FSDP, TP
and FSDP x TP (`parallel/fsdp.py`'s `ShardedState`).

The JAX package jits one step over a global batch placed on its mesh. Here
each rank runs the step on its rows of the global batch, and the step is
the single-device step's math:
- the draws (t, the noise, the class-dropout mask) are the global batch's,
  made on every rank from the same generator in the single-device order
  (or given), and each rank takes its rows;
- the loss is the mean over the global batch: each rank's mean over its
  rows, averaged over "data"; the gradient likewise (`reduce_grads`);
- the SupCon branch, where on, is computed over the whole batch from
  every rank's features (a differentiable gather);
- clipping is by the global norm of the whole averaged gradient; Adam and
  the EMA update each rank's pieces.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..losses.contrastive import supcon_loss
from ..models.unet_cfg import draw_cond_drop_mask
from ..parallel import comm
from ..parallel.fsdp import (
    ShardedState,
    all_gather_rows,
    pin_state_shardings,
)
from ..parallel.mesh import local_rows
from .ema import ema_update
from .ldm_step import LDMTrainState, global_norm

__all__ = ["draw_global", "make_sharded_ldm_train_step"]


def draw_global(diffusion, b: int, generator, *, cond_drop_prob: float,
                t=None, noise=None, cond_drop_mask=None):
    """(t [b], noise [b, H, W, C], mask [b] or None) for a global batch of
    b, drawn from `generator` in the order the single-device step draws
    them (t, the noise, the class dropout) where not given."""
    if diffusion.offset_noise_strength > 0.0 or diffusion.immiscible:
        raise NotImplementedError(
            "offset noise and immiscible noise are drawn per rank; the "
            "sharded step takes neither")
    dev = diffusion.device
    if t is None:
        t = torch.randint(0, diffusion.timesteps, (b,), generator=generator,
                          device=dev)
    if noise is None:
        c, h, w = diffusion.channels, diffusion.image_size, diffusion.image_size
        noise = torch.randn((b, c, h, w), generator=generator,
                            device=dev).permute(0, 2, 3, 1)
    if cond_drop_mask is None:
        net = getattr(diffusion.model, "model", diffusion.model)
        p = net.cond_drop_prob if cond_drop_prob is None else cond_drop_prob
        cond_drop_mask = draw_cond_drop_mask(b, p, generator, dev)
    return (torch.as_tensor(t, device=dev),
            torch.as_tensor(noise, dtype=torch.float32, device=dev),
            None if cond_drop_mask is None
            else torch.as_tensor(cond_drop_mask, device=dev))


def make_sharded_ldm_train_step(diffusion, placed: ShardedState, *,
                                cond_drop_prob: float = 0.0,
                                contrastive_weight: float = 0.0,
                                contrastive_start_step: int = 0,
                                contrastive_temperature: float = 0.07,
                                ema_decay: float = 0.995,
                                ema_update_every: int = 10,
                                ema_update_after_step: int = 100):
    """train_step(state, latents, classes, *, generator, t, noise,
    cond_drop_mask) -> logs, as `make_ldm_train_step`'s, where `latents`
    [B/data, H, W, C] and `classes` are this rank's rows of the global
    batch, and t, the noise and the mask (if given) are the global
    batch's. The logs are the global batch's, the same on every rank.
    Under ZeRO-1 the step is wrapped in `pin_state_shardings`."""
    mesh = placed.mesh
    group = mesh.group("data")
    n_data = mesh.shape["data"]
    use_contrastive = contrastive_weight > 0.0

    def mean_over_data(x):
        x = x.detach().float().clone()
        if mesh.distributed:
            comm.all_reduce_(x, group)
        return x / n_data

    def train_step(state: LDMTrainState, latents, classes, *,
                   generator: Optional[torch.Generator] = None, t=None,
                   noise=None, cond_drop_mask=None) -> dict:
        latents = torch.as_tensor(latents, device=diffusion.device)
        classes = torch.as_tensor(classes, device=diffusion.device)
        t, noise, mask = draw_global(
            diffusion, latents.shape[0] * n_data, generator,
            cond_drop_prob=cond_drop_prob, t=t, noise=noise,
            cond_drop_mask=cond_drop_mask)
        t, noise = local_rows(t, mesh), local_rows(noise, mesh)
        mask = None if mask is None else local_rows(mask, mesh)
        placed.unshard()
        kwargs = dict(t=t, noise=noise, cond_drop_mask=mask,
                      cond_drop_prob=cond_drop_prob, generator=generator)
        if use_contrastive:
            diff_loss, feats = diffusion.loss(latents, classes,
                                              return_features=True, **kwargs)
            feats = all_gather_rows(feats, mesh)
            labels = all_gather_rows(classes, mesh) if mesh.distributed \
                else classes
            closs = supcon_loss(feats[:, None, :], labels,
                                temperature=contrastive_temperature)
            gate = float(state.step >= contrastive_start_step)
            total = diff_loss + contrastive_weight * gate * closs
            log = {"diffusion_loss": mean_over_data(diff_loss),
                   "contrastive_loss": closs.detach()}
            log["loss"] = (log["diffusion_loss"]
                           + contrastive_weight * gate * log[
                               "contrastive_loss"])
        else:
            total = diff_loss = diffusion.loss(latents, classes, **kwargs)
            log = {"diffusion_loss": mean_over_data(diff_loss)}
            log["loss"] = log["diffusion_loss"]
        total.backward()
        grads = placed.reduce_grads()
        log["grad_norm"] = global_norm(grads)
        placed.optimizer.step(placed.pieces_of(grads), norm=log["grad_norm"])
        ema_update(placed.ema_targets(), placed.ema_sources(), state.step,
                   decay=ema_decay, update_every=ema_update_every,
                   update_after_step=ema_update_after_step)
        placed.reshard()
        state.step += 1
        return log

    if placed.mode == "zero1":
        # the whole parameters follow their updated pieces
        return pin_state_shardings(train_step, placed)
    return train_step
