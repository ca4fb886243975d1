"""Exponential moving average of parameters, updated in place.

Counterpart of vqgan_tpu/training/ema.py, with ema_pytorch's update rule: at
step `s` (one `ema_update` call per train step),

  - ``s % update_every != 0``        -> no-op
  - ``s <= update_after_step``       -> copy the online params into the EMA
  - otherwise                        -> ``ema = d*ema + (1-d)*online`` with
      ``epoch = max(s - update_after_step - 1, 0)``
      ``d = 0 if epoch <= 0 else
           clip(1 - (1 + epoch/inv_gamma)**(-power), min_value, beta)``

The step is a host integer, so the cadence costs no device sync. The JAX
package returns a new tree; the port writes the EMA tensors in place.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["ema_decay_at_step", "ema_update"]


def ema_decay_at_step(step: int, *, beta: float = 0.995,
                      update_after_step: int = 100, inv_gamma: float = 1.0,
                      power: float = 2.0 / 3.0,
                      min_value: float = 0.0) -> float:
    """ema_pytorch's `get_current_decay` as a function of the step."""
    epoch = max(step - update_after_step - 1.0, 0.0)
    if epoch <= 0.0:
        return 0.0
    value = 1.0 - (1.0 + epoch / inv_gamma) ** (-power)
    return min(max(value, min_value), beta)


@torch.no_grad()
def ema_update(ema_params: Sequence[torch.Tensor],
               new_params: Sequence[torch.Tensor], step: int, *,
               decay: float = 0.995, update_every: int = 10,
               update_after_step: int = 100) -> None:
    """Update `ema_params` in place from `new_params` at `step`. `decay` is
    the asymptotic decay (ema_pytorch's `beta`); the effective decay ramps
    up from 0 as in `ema_decay_at_step`."""
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
