"""Exponential moving average of parameters, updated in place.

Counterpart of vqgan_tpu/training/ema.py, with ema_pytorch's update rule: at
step `s` (one `ema_update` call per train step),

  - ``s % update_every != 0``        -> no-op
  - ``s <= update_after_step``       -> copy the online params into the EMA
  - otherwise                        -> ``ema = d*ema + (1-d)*online`` with
      ``epoch = max(s - update_after_step - 1, 0)``
      ``d = 0 if epoch <= 0 else
           clip(1 - (1 + epoch/inv_gamma)**(-power), min_value, beta)``

The step is a host integer, so the cadence costs no device sync; the eager
per-step path calls it so. Given a step as a 0-d tensor (the captured
modes, whose step lives on the device), the update is the JAX package's
branchless form: the cadence gate, the warm copy and the ramped decay are
computed from that tensor, and every call runs the same kernels, as a CUDA
graph needs:

  ``ema = ema * keep + online * w``: (1, 0) off the cadence, (0, 1) for a
  warm copy, (d, 1 - d) otherwise, ``e * d + p * (1 - d)`` as in JAX.

The JAX package returns a new tree; the port writes the EMA tensors in
place.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["ema_decay_at_step", "ema_update"]


def ema_decay_at_step(step, *, beta: float = 0.995,
                      update_after_step: int = 100, inv_gamma: float = 1.0,
                      power: float = 2.0 / 3.0, min_value: float = 0.0):
    """ema_pytorch's `get_current_decay` as a function of the step: a
    float for a host integer, a float32 tensor for a step tensor."""
    if torch.is_tensor(step):
        epoch = torch.clamp(step.float() - update_after_step - 1.0, min=0.0)
        value = 1.0 - (1.0 + epoch / inv_gamma) ** (-power)
        ramped = torch.clamp(value, min_value, beta)
        return torch.where(epoch <= 0.0, torch.zeros_like(ramped), ramped)
    epoch = max(step - update_after_step - 1.0, 0.0)
    if epoch <= 0.0:
        return 0.0
    value = 1.0 - (1.0 + epoch / inv_gamma) ** (-power)
    return min(max(value, min_value), beta)


@torch.no_grad()
def ema_update(ema_params: Sequence[torch.Tensor],
               new_params: Sequence[torch.Tensor], step, *,
               decay: float = 0.995, update_every: int = 10,
               update_after_step: int = 100) -> None:
    """Update `ema_params` in place from `new_params` at `step` (a host
    integer, or a 0-d tensor on the parameters' device). `decay` is the
    asymptotic decay (ema_pytorch's `beta`); the effective decay ramps up
    from 0 as in `ema_decay_at_step`."""
    if torch.is_tensor(step):
        _ema_update_branchless(list(ema_params), list(new_params), step,
                               decay, update_every, update_after_step)
        return
    if step % update_every != 0:
        return
    ema_params, new_params = list(ema_params), list(new_params)
    if step <= update_after_step:
        torch._foreach_copy_(ema_params, new_params)
        return
    d = ema_decay_at_step(step, beta=decay,
                          update_after_step=update_after_step)
    torch._foreach_mul_(ema_params, d)
    torch._foreach_add_(ema_params, new_params, alpha=1.0 - d)


def _ema_update_branchless(ema_params, new_params, step, decay: float,
                           update_every: int, update_after_step: int):
    d = ema_decay_at_step(step, beta=decay,
                          update_after_step=update_after_step)
    one, zero = torch.ones_like(d), torch.zeros_like(d)
    warm = step <= update_after_step
    due = step % update_every == 0
    keep = torch.where(due, torch.where(warm, zero, d), one)
    w = torch.where(due, torch.where(warm, one, 1.0 - d), zero)
    torch._foreach_mul_(ema_params, keep)
    torch._foreach_add_(ema_params, torch._foreach_mul(new_params, w))
