"""The stage-2 latent-diffusion training step.

Counterpart of vqgan_tpu/training/ldm_step.py: the diffusion loss (plus the
optional SupCon branch gated by `contrastive_start_step`), global-norm grad
clipping, linear LR warmup, Adam or AdamW, gradient accumulation, and the
EMA update, one step per call. The JAX package compiles the step into one
program; here it is eager PyTorch, and the step's logs stay on the device
so that no call waits for it.

`LDMOptimizer` is `make_ldm_optimizer`'s optax chain written over torch
parameters:
- clipping as `optax.clip_by_global_norm`: g * max / |g| when |g| > max
  (no `clip_grad_norm_` epsilon);
- AdamW (decoupled weight decay, as `optax.adamw`) when weight_decay > 0,
  Adam otherwise; eps 1e-8;
- the learning rate rises linearly from 0 at update 0 over `warmup_steps`
  updates, as `optax.linear_schedule`; or `schedule(count)` gives it, as
  an optax schedule is read at the update count before its increment
  (`warmup_cosine_decay_schedule`, the KL-VAE trainer's);
- k > 1 accumulates as `optax.MultiSteps`: the running (Welford) mean of k
  gradients, then one update; the calls in between leave the parameters.
Parameters that get no gradient (the single-token cross-attention's `to_q`
and `to_k`) take a zero gradient, as in JAX, so weight decay still applies.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..losses.contrastive import supcon_loss
from .ema import ema_update

__all__ = ["LDMOptimizer", "LDMTrainState", "global_norm",
           "make_ldm_optimizer", "make_ldm_train_step",
           "warmup_cosine_decay_schedule"]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """count -> learning rate, as `optax.warmup_cosine_decay_schedule`:
    linear from init_value at count 0 to peak_value at `warmup_steps`,
    then a cosine over the remaining `decay_steps - warmup_steps` counts
    down to end_value, which it keeps."""
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"the cosine needs decay_steps > warmup_steps, got "
                         f"{decay_steps} and {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element, on the device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class LDMOptimizer:
    def __init__(self, params, learning_rate: float = 1e-4,
                 weight_decay: float = 1e-4, betas=(0.9, 0.999),
                 max_grad_norm: Optional[float] = 1.0, warmup_steps: int = 0,
                 gradient_accumulate_every: int = 1,
                 schedule: Optional[Callable[[int], float]] = None):
        self.params = [p for p in params if p.requires_grad]
        self.learning_rate = learning_rate
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm or None
        self.warmup_steps = warmup_steps
        self.every = gradient_accumulate_every
        if weight_decay > 0:
            self.inner = torch.optim.AdamW(
                self.params, lr=learning_rate, betas=tuple(betas), eps=1e-8,
                weight_decay=weight_decay, foreach=True)
        else:
            self.inner = torch.optim.Adam(
                self.params, lr=learning_rate, betas=tuple(betas), eps=1e-8,
                foreach=True)
        self.count = 0       # updates applied
        self.mini_step = 0   # gradients accumulated towards the next update
        self.acc = None      # their running mean (k > 1)
        self._zeros = {}     # index -> zero gradient of an unused parameter

    def lr_at(self, count: int) -> float:
        """The learning rate of the update that follows `count` updates."""
        if self.schedule is not None:
            return self.schedule(count)
        if self.warmup_steps > 0:
            return (self.learning_rate * min(count, self.warmup_steps)
                    / self.warmup_steps)
        return self.learning_rate

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def grads(self) -> list:
        """This step's gradients, one per parameter; zero where a
        parameter took no part in the loss."""
        out = []
        for i, p in enumerate(self.params):
            if p.grad is None:
                if i not in self._zeros:
                    self._zeros[i] = torch.zeros_like(p)
                out.append(self._zeros[i])
            else:
                out.append(p.grad)
        return out

    def step(self, grads: list, norm: Optional[torch.Tensor] = None) -> bool:
        """Take one gradient per parameter (`norm`: their global norm, if
        known). Returns whether the parameters were updated."""
        if self.every > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, delta)
            self.mini_step += 1
            if self.mini_step < self.every:
                return False
            self.mini_step = 0
            grads, norm = self.acc, None
        if self.max_grad_norm is not None:
            norm = global_norm(grads) if norm is None else norm
            factor = torch.where(norm < self.max_grad_norm,
                                 torch.ones_like(norm),
                                 self.max_grad_norm / norm)
            torch._foreach_mul_(grads, factor)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.inner.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.inner.step()
        self.count += 1
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        self.zero_grad()
        return True

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        self.acc = (None if state["acc"] is None else
                    [a.to(p.device) for a, p in zip(state["acc"],
                                                    self.params)])


def make_ldm_optimizer(params, learning_rate: float = 1e-4,
                       weight_decay: float = 1e-4, betas=(0.9, 0.999),
                       max_grad_norm: Optional[float] = 1.0,
                       warmup_steps: int = 0,
                       gradient_accumulate_every: int = 1) -> LDMOptimizer:
    """Adam(W) with clipping and linear warmup, as the JAX package's."""
    return LDMOptimizer(params, learning_rate, weight_decay, betas,
                        max_grad_norm, warmup_steps, gradient_accumulate_every)


@dataclasses.dataclass
class LDMTrainState:
    """step (a host integer: steps taken), the online model, its EMA copy and
    the optimizer."""

    step: int
    model: nn.Module
    ema_model: nn.Module
    optimizer: LDMOptimizer

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "ema": self.ema_model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.ema_model.load_state_dict(state["ema"])
        self.optimizer.load_state_dict(state["optimizer"])


def make_ldm_train_step(diffusion, optimizer: LDMOptimizer, *,
                        cond_drop_prob: float = 0.0,
                        contrastive_weight: float = 0.0,
                        contrastive_start_step: int = 0,
                        contrastive_temperature: float = 0.07,
                        ema_decay: float = 0.995, ema_update_every: int = 10,
                        ema_update_after_step: int = 100):
    """train_step(state, latents [B,H,W,C], classes [B], *, generator, t,
    noise, cond_drop_mask) -> {"loss", "diffusion_loss", "grad_norm"} (and
    "contrastive_loss" with that branch on), 0-d tensors on the device.
    `diffusion` is the GaussianDiffusion over `state.model`. t, noise and the
    cond-drop mask are drawn from `generator` unless given."""
    use_contrastive = contrastive_weight > 0.0

    def train_step(state: LDMTrainState, latents, classes, *,
                   generator: Optional[torch.Generator] = None, t=None,
                   noise=None, cond_drop_mask=None) -> dict:
        optimizer.zero_grad()
        kwargs = dict(t=t, noise=noise, cond_drop_mask=cond_drop_mask,
                      cond_drop_prob=cond_drop_prob, generator=generator)
        if use_contrastive:
            diff_loss, feats = diffusion.loss(latents, classes,
                                              return_features=True, **kwargs)
            closs = supcon_loss(feats[:, None, :], classes,
                                temperature=contrastive_temperature)
            gate = float(state.step >= contrastive_start_step)
            total = diff_loss + contrastive_weight * gate * closs
            log = {"diffusion_loss": diff_loss, "contrastive_loss": closs,
                   "loss": total}
        else:
            total = diff_loss = diffusion.loss(latents, classes, **kwargs)
            log = {"diffusion_loss": diff_loss, "loss": diff_loss}
        total.backward()
        grads = optimizer.grads()
        log["grad_norm"] = global_norm(grads)
        optimizer.step(grads, norm=log["grad_norm"])
        ema_update(list(state.ema_model.parameters()),
                   list(state.model.parameters()), state.step,
                   decay=ema_decay, update_every=ema_update_every,
                   update_after_step=ema_update_after_step)
        state.step += 1
        return {k: v.detach() for k, v in log.items()}

    return train_step
