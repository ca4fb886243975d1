"""RePaint inpainting (Lugmayr et al. 2022) on top of GaussianDiffusion.

Counterpart of vqgan_tpu/diffusion/repaint.py: at every ancestral step the
known region is overwritten with the forward-noised ground truth, the final
step pastes the ground truth, and a resampling schedule (jump back
`resample_jump` steps, `resample_iter` times, every `resample_every` steps)
re-harmonises the boundary. Like the JAX package it follows the published
Algorithm 1 (renoise one beta-step at a time up to the jump height, then
denoise back down), not the reference's constant-t inner loop.

Where the resampling reaches t >= timesteps (resample_every within
resample_jump of T), the JAX package's gathers clamp the index to T - 1
and the model sees t itself; the port extends the schedule's tables by
their last entry to do the same.

The (op, t) schedule is built on the host; the loop runs the model on
DENOISE ops only (the JAX scan evaluates it on every op and discards it on
RENOISE ones: the same result). Each op has two noise draws, the blend's
and the step's; a RENOISE op uses the step's, as the JAX package draws both
branches' step noise from one key. The two kinds of op are two step bodies
(`graphs.ChainStep`), on the card two captured graphs replayed in the
schedule's order; the final denoise (t = 0) pastes the ground truth by a
device mask, not a branch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import diffusion_math as dm
from ..graphs import ChainStep, resolve_graph
from .gaussian import GaussianDiffusion, _nchw, _nhwc, _row_noise

__all__ = ["RePaintDiffusion", "build_repaint_schedule"]

_OP_DENOISE = 0
_OP_RENOISE = 1


def _extend_schedule(sched, n: int):
    """The schedule's [T] tables extended to [n] by repeating their last
    entry: a lookup at t >= T reads T - 1, as a clamped gather does."""
    def extend(v):
        return torch.cat([v, v[-1:].expand(n - v.shape[0])])

    return dataclasses.replace(sched, **{
        f.name: extend(getattr(sched, f.name))
        for f in dataclasses.fields(sched)})


def build_repaint_schedule(timesteps: int, resample: bool = True,
                           resample_iter: int = 10, resample_jump: int = 3,
                           resample_every: int = 50) -> np.ndarray:
    """[n_ops, 2] int32 (op, t): op 0 an ancestral denoise at t, op 1 a
    single-beta renoise from t to t + 1."""
    ops = []
    for t in range(timesteps - 1, -1, -1):
        ops.append((_OP_DENOISE, t))
        if resample and t > 0 and (t % resample_every == 0 or t == 1):
            for _ in range(resample_iter):
                for j in range(resample_jump):
                    ops.append((_OP_RENOISE, t + j))
                for j in range(resample_jump - 1, -1, -1):
                    ops.append((_OP_DENOISE, t + j))
    return np.asarray(ops, dtype=np.int32)


@dataclasses.dataclass
class RePaintDiffusion(GaussianDiffusion):
    resample: bool = True
    resample_iter: int = 10
    resample_jump: int = 3
    resample_every: int = 50

    def schedule_ops(self) -> np.ndarray:
        return build_repaint_schedule(self.timesteps, self.resample,
                                      self.resample_iter, self.resample_jump,
                                      self.resample_every)

    @torch.inference_mode()
    def inpaint(self, gt, mask, *, classes=None, cond_scale: float = 1.0,
                clip_denoised: bool = True, init_noise=None,
                blend_noise=None, step_noise=None,
                generator: torch.Generator = None,
                graph: Optional[bool] = None):
        """gt [B, H, W, C] in data space ([0, 1] with auto_normalize); mask
        NHWC, broadcastable to gt, 1 = the KNOWN region. init_noise
        ([*gt.shape]), blend_noise and step_noise ([n_ops, *gt.shape],
        row i for op i of `schedule_ops()`, NHWC) replace the draws from
        `generator` (initial, then per op the blend's and the step's).
        `graph` as in `GaussianDiffusion.ddim_sample`: on the card each op
        replays its kind's captured graph."""
        dev = self.device
        gt = torch.as_tensor(gt, dtype=torch.float32, device=dev)
        shape = tuple(gt.shape)
        ops = self.schedule_ops()
        diffusion, sched = self, self.schedule
        top = int(ops[:, 1].max())
        if top >= self.timesteps:
            sched = _extend_schedule(sched, top + 1)
            diffusion = dataclasses.replace(self, schedule=sched)
        b = shape[0]

        def renoise(generators, carry, consts, row):
            # after DENOISE at t the state sits at level t-1; the RENOISE
            # op recorded with t ascends x_{t-1} -> x_t by beta_t
            img = carry["img"]
            noise = _row_noise(row, img, generators, "step")
            beta = sched.betas[row["t"]]
            return {"img": torch.sqrt(1 - beta) * img
                    + torch.sqrt(beta) * noise}

        def denoise(generators, carry, consts, row):
            img, t, gt_n, mask = (carry["img"], row["t"], consts["gt"],
                                  consts["mask"])
            blend = _row_noise(row, img, generators, "blend")
            ac = sched.alphas_cumprod[t]
            noised_gt = torch.sqrt(ac) * gt_n + torch.sqrt(1 - ac) * blend
            img = mask * noised_gt + (1 - mask) * img
            tb = t.expand(b)
            _, x_start = diffusion.model_predictions(
                img, tb, consts.get("classes"), cond_scale=cond_scale)
            if clip_denoised:
                x_start = torch.clamp(x_start, -1.0, 1.0)
            mean, _, log_var = dm.q_posterior(sched, x_start, img, tb)
            noise = _row_noise(row, img, generators, "step")
            # the final step pastes the ground truth
            return {"img": torch.where(
                t > 0, mean + torch.exp(0.5 * log_var) * noise,
                mask * gt_n + (1 - mask) * mean)}

        use_graph = resolve_graph(graph, dev)
        steps = {op: ChainStep(body, graphs=self._graphs,
                               key=("repaint", op, cond_scale,
                                    clip_denoised, top),
                               graph=use_graph,
                               name=f"RePaint {name} op")
                 for op, body, name in ((_OP_RENOISE, renoise, "renoise"),
                                        (_OP_DENOISE, denoise, "denoise"))}
        consts = {"gt": _nchw(self.normalize(gt)),
                  "mask": _nchw(torch.as_tensor(mask, dtype=torch.float32,
                                                device=dev)),
                  "classes": self._classes(classes)}
        carry = {"img": self._initial_noise(shape, init_noise, generator)}
        # t as [1] rows: a gather by a tensor index, no host read
        table = {"t": torch.from_numpy(ops[:, 1:].astype(np.int64)).to(dev),
                 "blend": self._given_steps(blend_noise),
                 "step": self._given_steps(step_noise)}
        for i, op in enumerate(ops[:, 0].tolist()):
            row = {k: v[i] for k, v in table.items() if v is not None}
            if op == _OP_RENOISE:
                row.pop("blend", None)
            carry = steps[op](carry, consts, row, [generator])
        return self.unnormalize(_nhwc(carry["img"]))
