"""The stage-2 latent-diffusion training step.

Counterpart of vqgan_tpu/training/ldm_step.py: the diffusion loss (plus the
optional SupCon branch gated by `contrastive_start_step`), global-norm grad
clipping, linear LR warmup, Adam or AdamW, gradient accumulation, and the
EMA update. `make_ldm_train_step` is one eager step per call, its logs left
on the device so that no call waits for it; `make_ldm_scan_step` runs a
block of K steps, on the card as CUDA graphs (the counterpart of the JAX
package's one-program `lax.scan` over whole steps). Both share the step
body, `_make_step_core`, as in JAX.

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

`CapturableOptimizer` is the same chain with all of its state on the
parameters' device: the update count, the accumulation counter, the
learning rate (the schedule evaluated on the device) and the moments, and
no host branch, so that a CUDA graph can hold the step. Accumulation is
optax.MultiSteps' masked form, every call running the same kernels. It
saves and loads the same state dict as `LDMOptimizer`, so a checkpoint of
one resumes in the other, and it loads in place (`copy_`): a captured
graph that writes its tensors stays valid.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..losses.contrastive import supcon_loss
from ..graphs import BlockRunner
from .ema import ema_update

__all__ = ["CapturableOptimizer", "LDMOptimizer", "LDMTrainState",
           "global_norm", "make_ldm_optimizer", "make_ldm_scan_step",
           "make_ldm_train_step", "warmup_cosine_decay_schedule"]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """count -> learning rate, as `optax.warmup_cosine_decay_schedule`:
    linear from init_value at count 0 to peak_value at `warmup_steps`,
    then a cosine over the remaining `decay_steps - warmup_steps` counts
    down to end_value, which it keeps. A count tensor gives a float32
    tensor, computed on its device."""
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"the cosine needs decay_steps > warmup_steps, got "
                         f"{decay_steps} and {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count):
        if torch.is_tensor(count):
            c = count.float()
            frac = 1.0 - torch.clamp(c, min=0.0) / warmup_steps
            warm = (init_value - peak_value) * frac + peak_value
            t = torch.clamp(c - warmup_steps, 0.0, cosine_steps)
            cosine = 0.5 * (1.0 + torch.cos(math.pi * t / cosine_steps))
            decayed = peak_value * ((1.0 - alpha) * cosine + alpha)
            return torch.where(c < warmup_steps, warm, decayed)
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
        # the clipping norm of an accumulated gradient; a sharded state
        # sets one that sums over the ranks' pieces
        self.norm_fn = global_norm
        self.acc = None      # their running mean (k > 1)
        self._zeros = {}     # index -> zero gradient of an unused parameter

    def lr_at(self, count: int) -> float:
        """The learning rate of the update that follows `count` updates."""
        if self.schedule is not None:
            return self.schedule(count)
        if self.warmup_steps > 0:
            capped = (torch.clamp(count, max=self.warmup_steps)
                      if torch.is_tensor(count)
                      else min(count, self.warmup_steps))
            return self.learning_rate * capped / self.warmup_steps
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
            norm = self.norm_fn(grads) if norm is None else norm
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


def _select(cond: torch.Tensor, tensors: list, before: list) -> None:
    """Each tensor keeps its new value where the 0-d `cond` holds and takes
    back its value `before` otherwise: `torch.where`, so a taken update is
    bit for bit the unmasked one and a dropped one leaves no trace."""
    for t, old in zip(tensors, before):
        t.copy_(torch.where(cond, t, old))


class CapturableOptimizer(LDMOptimizer):
    """`LDMOptimizer`'s chain with its state on the parameters' device (see
    the module docstring). `step(grads, norm, active=)` takes an optional
    0-d bool tensor: where it is False the call leaves the parameters,
    the moments, the counts and the accumulated gradient as they were (the
    VQ-GAN's discriminator before `disc_start`), as the JAX package's
    `jnp.where` over the updated state does; MultiSteps' k > 1 selects its
    update the same way. The Adam update is torch's, written with foreach kernels over
    device scalars: AdamW's decay p *= 1 - lr wd, then p -= lr / (1 -
    b1^n) * m / (sqrt(v) / sqrt(1 - b2^n) + eps), n the update's count."""

    def __init__(self, params, *args, **kwargs):
        super().__init__(params, *args, **kwargs)
        inner = self.inner.param_groups[0]
        self.betas = tuple(inner["betas"])
        self.eps = inner["eps"]
        self.weight_decay = inner["weight_decay"]
        dev = self.params[0].device
        self.count_t = torch.zeros((), dtype=torch.float32, device=dev)
        self.mini_t = torch.zeros((), dtype=torch.float32, device=dev)
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        if self.every > 1:
            self.acc = [torch.zeros_like(p) for p in self.params]
        # the torch optimizer holds these tensors as its state, so that
        # `state_dict` writes LDMOptimizer's format; it never steps
        for p, m, v in zip(self.params, self.exp_avg, self.exp_avg_sq):
            self.inner.state[p] = {"step": self.count_t, "exp_avg": m,
                                   "exp_avg_sq": v}

    @torch.no_grad()
    def step(self, grads: list, norm: Optional[torch.Tensor] = None,
             active: Optional[torch.Tensor] = None) -> None:
        kept = None
        if active is not None:
            kept = [t.clone() for t in self._state()]
        if self.every > 1:
            mini = self.mini_t
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, mini + 1.0)
            torch._foreach_add_(self.acc, delta)
            due = mini + 1.0 >= self.every
            grads, norm = torch._foreach_mul(self.acc, 1.0), None
        if self.max_grad_norm is not None:
            norm = self.norm_fn(grads) if norm is None else norm
            factor = torch.where(norm < self.max_grad_norm,
                                 torch.ones_like(norm),
                                 self.max_grad_norm / norm)
            torch._foreach_mul_(grads, factor)
        if self.every > 1:
            updated = [*self.params, *self.exp_avg, *self.exp_avg_sq,
                       self.count_t]
            before = [t.clone() for t in updated]
            self._adam(grads)
            _select(due, updated, before)
            torch._foreach_mul_(self.acc, (~due).to(torch.float32))
            self.mini_t.copy_(torch.where(due, torch.zeros_like(mini),
                                          mini + 1.0))
        else:
            self._adam(grads)
        if kept is not None:
            _select(active, self._state(), kept)
        self.zero_grad()

    def _state(self) -> list:
        """Every tensor a step writes."""
        return [*self.params, *self.exp_avg, *self.exp_avg_sq, self.count_t,
                self.mini_t, *(self.acc or [])]

    def _adam(self, grads: list) -> None:
        b1, b2 = self.betas
        m, v = self.exp_avg, self.exp_avg_sq
        lr = self.lr_at(self.count_t)
        torch._foreach_lerp_(m, grads, 1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
        n = self.count_t + 1.0
        bias1 = 1.0 - torch.pow(b1, n)
        bias2 = 1.0 - torch.pow(b2, n)
        if self.weight_decay > 0:
            torch._foreach_mul_(self.params, 1.0 - lr * self.weight_decay)
        denom = torch._foreach_sqrt(v)
        torch._foreach_div_(denom, torch.sqrt(bias2))
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(m, denom)
        torch._foreach_mul_(update, -lr / bias1)
        torch._foreach_add_(self.params, update)
        self.count_t.add_(1.0)

    def state_dict(self) -> dict:
        inner = self.inner.state_dict()
        step = self.count_t.detach().cpu()
        inner["state"] = {i: {**s, "step": step.clone()}
                          for i, s in inner["state"].items()}
        return {"inner": inner, "count": int(step),
                "mini_step": int(self.mini_t), "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        saved = state["inner"]["state"]
        for i, (m, v) in enumerate(zip(self.exp_avg, self.exp_avg_sq)):
            if i in saved:
                m.copy_(saved[i]["exp_avg"])
                v.copy_(saved[i]["exp_avg_sq"])
            else:
                m.zero_()
                v.zero_()
        self.count_t.fill_(float(state["count"]))
        self.mini_t.fill_(float(state["mini_step"]))
        if self.acc is not None:
            if state["acc"] is None:
                torch._foreach_zero_(self.acc)
            else:
                torch._foreach_copy_(self.acc, [
                    a.to(p.device) for a, p in zip(state["acc"],
                                                   self.params)])


def make_ldm_optimizer(params, learning_rate: float = 1e-4,
                       weight_decay: float = 1e-4, betas=(0.9, 0.999),
                       max_grad_norm: Optional[float] = 1.0,
                       warmup_steps: int = 0,
                       gradient_accumulate_every: int = 1,
                       capturable: bool = False) -> LDMOptimizer:
    """Adam(W) with clipping and linear warmup, as the JAX package's; with
    `capturable`, its state on the device (`CapturableOptimizer`)."""
    cls = CapturableOptimizer if capturable else LDMOptimizer
    return cls(params, learning_rate, weight_decay, betas, max_grad_norm,
               warmup_steps, gradient_accumulate_every)


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


def _make_step_core(diffusion, optimizer: LDMOptimizer, *,
                    cond_drop_prob: float = 0.0,
                    contrastive_weight: float = 0.0,
                    contrastive_start_step: int = 0,
                    contrastive_temperature: float = 0.07,
                    ema_decay: float = 0.995, ema_update_every: int = 10,
                    ema_update_after_step: int = 100):
    """The step body shared by the eager step and the block:
    core(state, step, latents, classes, *, generator, t, noise,
    cond_drop_mask) -> logs. `step` is the steps taken so far: a host
    integer (the eager step), or a 0-d integer tensor on the device (the
    captured modes), and then the contrastive gate and the EMA are
    computed on the device. It advances no step counter."""
    use_contrastive = contrastive_weight > 0.0

    def core(state: LDMTrainState, step, latents, classes, *,
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
            gate = ((step >= contrastive_start_step).float()
                    if torch.is_tensor(step)
                    else float(step >= contrastive_start_step))
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
                   list(state.model.parameters()), step,
                   decay=ema_decay, update_every=ema_update_every,
                   update_after_step=ema_update_after_step)
        return {k: v.detach() for k, v in log.items()}

    return core


def make_ldm_train_step(diffusion, optimizer: LDMOptimizer, **step_kwargs):
    """train_step(state, latents [B,H,W,C], classes [B], *, generator, t,
    noise, cond_drop_mask) -> {"loss", "diffusion_loss", "grad_norm"} (and
    "contrastive_loss" with that branch on), 0-d tensors on the device.
    `diffusion` is the GaussianDiffusion over `state.model`. t, noise and the
    cond-drop mask are drawn from `generator` unless given. `step_kwargs`
    are `_make_step_core`'s: cond_drop_prob, contrastive_weight,
    contrastive_start_step, contrastive_temperature, ema_decay,
    ema_update_every, ema_update_after_step."""
    core = _make_step_core(diffusion, optimizer, **step_kwargs)

    def train_step(state: LDMTrainState, latents, classes, **draws) -> dict:
        log = core(state, state.step, latents, classes, **draws)
        state.step += 1
        return log

    return train_step


def make_ldm_scan_step(diffusion, optimizer: LDMOptimizer, *,
                       graph: bool = True, core=None, **step_kwargs):
    """Block dispatch, the counterpart of the JAX package's
    `make_ldm_scan_step`: block_step(state, latents [K,B,H,W,C], classes
    [K,B], *, generator, t=None [K,B], noise=None [K,B,H,W,C],
    cond_drop_mask=None [K,B]) -> logs, each stacked on a leading [K]
    axis. Step for step the same math and the same draws from `generator`
    as K eager steps; the step counter, the contrastive gate and the EMA
    live on the device. `optimizer` should be a `CapturableOptimizer`.

    On the card one step's CUDA graph is replayed K times
    (`graphs.BlockRunner`), captured at its second call (the first runs
    eagerly: the warm-up) and kept; `block_step.runners` holds them. On
    the CPU, and on the card with `graph` False, the same steps run
    eagerly. The graphs hold `state`'s tensors: a checkpoint loaded into
    them in place (`load_state_dict` does so) leaves the graphs valid.
    `core`, a step body with `_make_step_core`'s contract (the sharded
    step's, `sharded_step.make_sharded_ldm_scan_step`), replaces the one
    built from `step_kwargs`."""
    if core is None:
        core = _make_step_core(diffusion, optimizer, **step_kwargs)
    device = diffusion.device
    counter = torch.zeros((), dtype=torch.long, device=device)
    runners = {}
    names = []  # the logs' keys, in the order of the stacked log rows

    def runner(state, draw_keys):
        def body(generators, latents, classes, *draw_values):
            rows = []
            for i in range(latents.shape[0]):
                log = core(state, counter, latents[i], classes[i],
                           generator=generators[0],
                           **{k: v[i] for k, v in zip(draw_keys,
                                                      draw_values)})
                counter.add_(1)
                rows.append(log)
            if not names:
                names.extend(rows[0])
            return (torch.stack([torch.stack([r[k].float() for k in names])
                                 for r in rows]),)

        return BlockRunner(body, name="LDM steps", graph=graph)

    def block_step(state: LDMTrainState, latents, classes, *,
                   generator: Optional[torch.Generator] = None, t=None,
                   noise=None, cond_drop_mask=None) -> dict:
        draws = {k: torch.as_tensor(v, device=device) for k, v in
                 (("t", t), ("noise", noise),
                  ("cond_drop_mask", cond_drop_mask)) if v is not None}
        if "noise" in draws:
            draws["noise"] = draws["noise"].float()
        key = (id(state), tuple(draws))
        if key not in runners:
            runners[key] = runner(state, tuple(draws))
        latents = torch.as_tensor(latents, device=device)
        counter.fill_(state.step)
        rows, = runners[key](latents, torch.as_tensor(classes, device=device),
                             *draws.values(), generators=[generator])
        state.step += latents.shape[0]
        return {name: rows[:, j] for j, name in enumerate(names)}

    block_step.runners = runners
    return block_step
