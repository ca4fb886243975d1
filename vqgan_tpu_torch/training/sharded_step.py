"""The stage-2 training step over a mesh: data parallel, ZeRO-1, FSDP, TP
and FSDP x TP (`parallel/fsdp.py`'s `ShardedState`), eager or captured.

The JAX package jits one step over a global batch placed on its mesh. Here
each rank runs the step on its rows of the global batch, and the step is
the single-device step's math:
- the draws (t, the noise, the offset noise, the class-dropout mask) are
  the global batch's, made inside `global_batch(mesh)` on every rank from
  the same generator in the single-device order, each rank keeping its
  rows (`parallel.mesh.draw_rows`); given draws are the global batch's
  too, and each rank takes its rows of them. Immiscible noise is assigned
  over the whole batch (`diffusion/gaussian.py`);
- the loss is the mean over the global batch: each rank's mean over its
  rows, averaged over "data"; the gradient likewise;
- the forward runs inside `ShardedState.holding_pieces`: each module
  gathers its own split parameters just before it runs and drops them
  after, the backward gathers them again where it needs them, and each
  split gradient is reduce-scattered into this rank's piece as soon as it
  is complete (`parallel/fsdp.py`); the whole model is never gathered
  for a step, and no whole gradient of a split parameter is all-reduced.
  The gradients of what is stored whole take one flat all-reduce after
  the backward (`ShardedState.gradients`);
- the SupCon branch, where on, is computed over the whole batch from
  every rank's features (a differentiable gather);
- clipping is by the global norm of the whole averaged gradient, summed
  from the pieces where any gradient is split (`piece_norm`), else as the
  single-device step computes it; Adam and the EMA update each rank's
  pieces.

`make_sharded_ldm_scan_step` runs the same step body in blocks, as
`make_ldm_scan_step` does off the mesh: on the card one step's CUDA graph
with its NCCL collectives (each module's gathers in the forward and in
the backward, the reduce-scatters and all-reduces the backward's hooks
make, the flat all-reduce, ZeRO-1's gathers of the updated pieces)
replayed per step. The hooks decide nothing from the data, so the
capture records what every step runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..losses.contrastive import supcon_loss
from ..parallel.fsdp import (
    ShardedState,
    all_gather_rows,
    pin_state_shardings,
)
from ..parallel.mesh import global_batch, local_rows, mean_over_data
from .ema import ema_update
from .ldm_step import LDMTrainState, global_norm, make_ldm_scan_step

__all__ = ["make_sharded_ldm_scan_step", "make_sharded_ldm_train_step"]


def _make_sharded_core(diffusion, placed: ShardedState, *,
                       cond_drop_prob: float = 0.0,
                       contrastive_weight: float = 0.0,
                       contrastive_start_step: int = 0,
                       contrastive_temperature: float = 0.07,
                       ema_decay: float = 0.995,
                       ema_update_every: int = 10,
                       ema_update_after_step: int = 100):
    """core(state, step, latents, classes, *, generator, t, noise,
    cond_drop_mask) -> logs, `ldm_step._make_step_core`'s contract on a
    mesh: `step` a host integer or a 0-d device tensor, latents and
    classes this rank's rows, the draws (where given) the global
    batch's."""
    mesh = placed.mesh
    use_contrastive = contrastive_weight > 0.0

    def rows(x):
        if x is None:
            return None
        return local_rows(torch.as_tensor(x, device=diffusion.device), mesh)

    def forward(step, latents, classes, kwargs):
        """(the loss to differentiate, the logs)."""
        if use_contrastive:
            with global_batch(mesh):
                diff_loss, feats = diffusion.loss(
                    latents, classes, return_features=True, **kwargs)
            feats = all_gather_rows(feats, mesh)
            labels = all_gather_rows(classes, mesh) if mesh.distributed \
                else classes
            closs = supcon_loss(feats[:, None, :], labels,
                                temperature=contrastive_temperature)
            gate = ((step >= contrastive_start_step).float()
                    if torch.is_tensor(step)
                    else float(step >= contrastive_start_step))
            total = diff_loss + contrastive_weight * gate * closs
            log = {"diffusion_loss": mean_over_data(
                       [diff_loss.detach().float()], mesh)[0],
                   "contrastive_loss": closs.detach()}
            log["loss"] = (log["diffusion_loss"]
                           + contrastive_weight * gate * log[
                               "contrastive_loss"])
            return total, log
        with global_batch(mesh):
            total = diffusion.loss(latents, classes, **kwargs)
        log = {"diffusion_loss": mean_over_data(
            [total.detach().float()], mesh)[0]}
        log["loss"] = log["diffusion_loss"]
        return total, log

    def core(state: LDMTrainState, step, latents, classes, *,
             generator: Optional[torch.Generator] = None, t=None,
             noise=None, cond_drop_mask=None) -> dict:
        latents = torch.as_tensor(latents, device=diffusion.device)
        classes = torch.as_tensor(classes, device=diffusion.device)
        placed.zero_grad()
        kwargs = dict(t=rows(t), noise=rows(noise),
                      cond_drop_mask=rows(cond_drop_mask),
                      cond_drop_prob=cond_drop_prob, generator=generator)
        with placed.holding_pieces():
            total, log = forward(step, latents, classes, kwargs)
        total.backward()
        grads = placed.gradients()
        log["grad_norm"] = (placed.piece_norm(grads) if placed.splits
                            else global_norm(grads))
        placed.optimizer.step(grads, norm=log["grad_norm"])
        ema_update(placed.ema_targets(), placed.ema_sources(), step,
                   decay=ema_decay, update_every=ema_update_every,
                   update_after_step=ema_update_after_step)
        return log

    if placed.mode == "zero1":
        # the whole parameters follow their updated pieces
        return pin_state_shardings(core, placed)
    return core


def make_sharded_ldm_train_step(diffusion, placed: ShardedState,
                                **step_kwargs):
    """train_step(state, latents, classes, *, generator, t, noise,
    cond_drop_mask) -> logs, as `make_ldm_train_step`'s, where `latents`
    [B/data, H, W, C] and `classes` are this rank's rows of the global
    batch, and t, the noise and the mask (if given) are the global
    batch's. The logs are the global batch's, the same on every rank.
    Under ZeRO-1 the step is wrapped in `pin_state_shardings`.
    `step_kwargs` are `ldm_step._make_step_core`'s."""
    core = _make_sharded_core(diffusion, placed, **step_kwargs)

    def train_step(state: LDMTrainState, latents, classes, **draws) -> dict:
        log = core(state, state.step, latents, classes, **draws)
        state.step += 1
        return log

    return train_step


def make_sharded_ldm_scan_step(diffusion, placed: ShardedState, *,
                               graph: bool = True, **step_kwargs):
    """`make_ldm_scan_step`'s block dispatch over the sharded step:
    latents [K, B/data, H, W, C] and classes [K, B/data] this rank's rows
    of K global batches, the draws (if given) [K, B, ...] the global
    batches'. The state's optimizer must be a `CapturableOptimizer` (the
    trainer makes one for step_mode "scan")."""
    core = _make_sharded_core(diffusion, placed, **step_kwargs)
    return make_ldm_scan_step(diffusion, placed.optimizer, graph=graph,
                              core=core)
