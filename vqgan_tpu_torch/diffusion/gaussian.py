"""Gaussian diffusion, class-conditional with classifier-free guidance or
unconditional: the training loss and the samplers.

Counterpart of vqgan_tpu/diffusion/gaussian.py: `p_losses` and `loss`
(Min-SNR weighted, offset noise, cond-drop; t, noise, the cond-drop mask
and the self-conditioning coin can be injected), `model_predictions` (with
the CFG [cond; null] pair as one 2B-batch forward, and CFG++), `ddim_step`
(one CFG DDIM step with t, t_next and the noise as tensors, traceable by
`torch.export`; `DDIMStep` is it as a module), `ddim_sample` (that step
over the (time, time_next) pairs), `p_sample_loop` (the ancestral sampler),
`sample` (DDIM when sampling_timesteps < T, else ancestral) and
`interpolate`. Each sampler is one step body run over a per-step table
(`graphs.run_chain`): on the card each step a replay of the body's
captured CUDA graph, the counterpart of the JAX package's one `lax.scan`
program; on the CPU, or with `graph=False`, the body called from a Python
loop. The body branches on no step: the last ancestral step's missing
noise is a device mask (`torch.where`), as JAX's `jnp.where` is. Every
random draw can be passed in as a tensor, or comes from an explicit
`torch.Generator`, drawn inside the body in the eager loop's order. NCHW inside; the
public functions take and return NHWC latents, like the JAX package, or
[B, L, C] sequences ([B, C, L] inside) for a 1-D denoiser.

With `classes=None` the model is unconditional: model(x, t) or, with
`self_condition`, model(x, t, x_self_cond). Self-conditioning feeds, on
half of the training steps (one coin per batch), the model's own x_0
estimate from a first forward under `torch.no_grad()` (JAX's
`stop_gradient`; no graph is kept, so that forward launches no backward
kernel), and in the samplers the previous step's x_0. `immiscible` permutes
each batch's noise to the assignment of least total squared distance to the
images: `immiscible_method` "host" is scipy's `linear_sum_assignment` on
the fp32 distances (a host sync per step, as JAX's `pure_callback` is),
"auction" the port's `ops/assignment.auction_assignment` on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..core import diffusion_math as dm
from ..core.guidance import apply_cfg
from ..core.schedules import DiffusionSchedule, make_schedule
from ..device import resolve_device
from ..graphs import ChainGraphs, ChainStep, resolve_graph, run_chain
from ..ops.assignment import auction_assignment
from ..parallel.mesh import (
    draw_rows,
    gather_rows,
    global_shape,
    own_rows,
)

__all__ = ["GaussianDiffusion", "DDIMStep", "immiscible_permutation"]


def _nchw(x):
    """Channels last -> channels first: NHWC -> NCHW, [B, L, C] ->
    [B, C, L]."""
    return x.movedim(-1, 1)


def _nhwc(x):
    """Channels first -> channels last, the inverse of `_nchw`."""
    return x.movedim(1, -1)


def _channels_first(shape):
    """An NHWC (or [B, L, C]) shape as NCHW (or [B, C, L])."""
    return (shape[0], shape[-1], *shape[1:-1])


def immiscible_permutation(x_start, noise, method: str = "host",
                           graphs: Optional[ChainGraphs] = None):
    """[B] int64 on x_start's device: row i of the batch gets noise row
    perm[i], the assignment of least total squared distance between the
    flattened images and noise draws. "host": scipy's exact Hungarian
    solver on the fp32 distance matrix, copied to the host; "auction": the
    on-device epsilon-auction, within B * eps of the least cost, its
    blocks of bids replayed from `graphs` on the card."""
    b = x_start.shape[0]
    xf = x_start.reshape(b, -1).float()
    nf = noise.reshape(b, -1).float()
    dist = ((xf * xf).sum(1, keepdim=True) - 2.0 * (xf @ nf.T)
            + (nf * nf).sum(1)[None, :])
    if method == "auction":
        return auction_assignment(dist, graphs=graphs)
    if method != "host":
        raise ValueError(f"unknown immiscible_method {method!r}")
    from scipy.optimize import linear_sum_assignment

    _, cols = linear_sum_assignment(dist.detach().cpu().numpy())
    return torch.from_numpy(cols.astype(np.int64)).to(x_start.device)


@dataclasses.dataclass
class GaussianDiffusion:
    """Diffusion wrapper around a denoiser.

    model(x [B,C,H,W], t [B], classes [B], *, cond_drop_mask) -> prediction
    for a class-conditional denoiser; model(x, t[, x_self_cond]) for an
    unconditional one (`classes=None` throughout). Defaults as in the JAX
    package: DDIM eta 1.0, cosine betas.
    """

    model: Callable[..., torch.Tensor]
    image_size: int
    channels: int = 3
    timesteps: int = 1000
    sampling_timesteps: Optional[int] = None
    objective: str = "pred_noise"
    beta_schedule: str = "cosine"
    ddim_sampling_eta: float = 1.0
    offset_noise_strength: float = 0.0
    min_snr_loss_weight: bool = False
    min_snr_gamma: float = 5.0
    use_cfg_plus_plus: bool = False
    auto_normalize: bool = True
    immiscible: bool = False
    immiscible_method: str = "host"
    self_condition: bool = False  # unconditional models only
    device: str | torch.device = "cuda"  # no GPU raises; "cpu" on ask
    schedule: DiffusionSchedule = None
    # the samplers' captured steps (and the auction's bids), by their key
    _graphs: ChainGraphs = dataclasses.field(
        default_factory=ChainGraphs, init=False, repr=False, compare=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.objective not in ("pred_noise", "pred_x0", "pred_v"):
            raise ValueError(f"unknown objective {self.objective!r}")
        if self.immiscible_method not in ("host", "auction"):
            raise ValueError(
                f"unknown immiscible_method {self.immiscible_method!r}")
        if self.schedule is None:
            self.schedule = make_schedule(
                self.beta_schedule, self.timesteps, objective=self.objective,
                min_snr_loss_weight=self.min_snr_loss_weight,
                min_snr_gamma=self.min_snr_gamma, device=self.device)
        if self.sampling_timesteps is None:
            self.sampling_timesteps = self.timesteps
        if self.sampling_timesteps > self.timesteps:
            raise ValueError("sampling_timesteps exceeds timesteps")
        self.is_ddim_sampling = self.sampling_timesteps < self.timesteps

    def normalize(self, x):
        return dm.normalize_to_neg_one_to_one(x) if self.auto_normalize else x

    def unnormalize(self, x):
        return dm.unnormalize_to_zero_to_one(x) if self.auto_normalize else x

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def p_losses(self, x_start, t, classes=None, *, noise=None,
                 cond_drop_mask=None, cond_drop_prob: Optional[float] = None,
                 self_cond_coin=None, generator: torch.Generator = None,
                 return_features: bool = False):
        """Min-SNR-weighted MSE of the model's prediction at times `t` [B].
        x_start and `noise` are NHWC; noise is drawn from `generator` when
        not given (then permuted under `immiscible`), as are the offset
        noise and, without `cond_drop_mask`, the model's random class
        dropout, and without `self_cond_coin` (a bool, True feeds the x_0
        estimate) the self-conditioning coin. Inside
        `parallel.mesh.global_batch` (a step on a mesh, x_start this rank's
        rows) the draws and the immiscible assignment are the global
        batch's, and each rank keeps its rows of them. Returns the scalar
        loss, and the model's mid-block features with `return_features`."""
        x_start = _nchw(torch.as_tensor(x_start, device=self.device))
        b, c = x_start.shape[:2]
        dev = x_start.device
        if noise is not None:
            noise = _nchw(torch.as_tensor(noise, dtype=torch.float32,
                                          device=dev))
        if self.immiscible:
            # one assignment over the whole batch: on a mesh every rank
            # solves the same one over the global noise (drawn whole, or
            # gathered where given) and keeps its rows
            whole = (torch.randn(global_shape(x_start.shape),
                                 generator=generator, device=dev)
                     if noise is None else gather_rows(noise))
            noise = own_rows(whole[immiscible_permutation(
                gather_rows(x_start), whole, self.immiscible_method,
                self._graphs)])
        elif noise is None:
            noise = draw_rows(lambda shape: torch.randn(
                shape, generator=generator, device=dev), x_start.shape)
        if self.offset_noise_strength > 0.0:
            # per-(sample, channel) constant offset
            offset = draw_rows(lambda shape: torch.randn(
                shape, generator=generator, device=dev), (b, c))
            noise = noise + self.offset_noise_strength * offset.reshape(
                b, c, *((1,) * (x_start.ndim - 2)))
        t = torch.as_tensor(t, device=x_start.device)
        x = dm.q_sample(self.schedule, x_start, t, noise)
        if classes is not None:
            model_out = self.model(x, t, classes,
                                   cond_drop_mask=cond_drop_mask,
                                   cond_drop_prob=cond_drop_prob,
                                   generator=generator,
                                   return_features=return_features)
        else:
            # an unconditional model need not take `return_features` (the
            # 1-D U-Net does not) unless features are asked for
            feats = {"return_features": True} if return_features else {}
            if self.self_condition:
                with torch.no_grad():
                    x0_est = self._x_start_from_output(
                        x, t, self.model(x, t, torch.zeros_like(x)))
                if self_cond_coin is None:
                    self_cond_coin = torch.rand((), generator=generator,
                                                device=x.device) < 0.5
                coin = torch.as_tensor(self_cond_coin, device=x.device)
                model_out = self.model(
                    x, t, torch.where(coin, x0_est,
                                      torch.zeros_like(x0_est)), **feats)
            else:
                model_out = self.model(x, t, **feats)
        features = None
        if return_features:
            model_out, features = model_out

        if self.objective == "pred_noise":
            target = noise
        elif self.objective == "pred_x0":
            target = x_start
        else:
            target = dm.predict_v(self.schedule, x_start, t, noise)
        loss = ((model_out.float() - target.float()) ** 2).mean(
            dim=tuple(range(1, model_out.ndim)))
        loss = (loss * self.schedule.loss_weight[t]).mean()
        return (loss, features) if return_features else loss

    def _x_start_from_output(self, x, t, model_output):
        if self.objective == "pred_noise":
            return dm.predict_start_from_noise(self.schedule, x, t,
                                               model_output)
        if self.objective == "pred_x0":
            return model_output
        return dm.predict_start_from_v(self.schedule, x, t, model_output)

    def loss(self, img, classes=None, *, t=None,
             generator: torch.Generator = None, **kwargs):
        """The training objective: t uniform in [0, T) from `generator`
        (unless given), normalize, then `p_losses`. `img` is NHWC."""
        img = torch.as_tensor(img, device=self.device)
        if t is None:
            t = draw_rows(lambda shape: torch.randint(
                0, self.timesteps, shape, generator=generator,
                device=img.device), (img.shape[0],))
        return self.p_losses(self.normalize(img), t, classes,
                             generator=generator, **kwargs)

    def model_predictions(self, x, t, classes=None, *,
                          cond_scale: float = 6.0, rescaled_phi: float = 0.7,
                          clip_x_start: bool = False, x_self_cond=None):
        """NCHW x, t [B], classes [B] -> (pred_noise, pred_x_start). Under
        CFG++ (`use_cfg_plus_plus`, cond_scale != 1) the noise comes from
        the null branch's prediction, x_start from the guided one. With
        classes None, one unconditional forward (given x_self_cond, or
        zeros, under `self_condition`)."""
        sched = self.schedule
        b = x.shape[0]
        model_output_null = None
        if classes is None:
            if self.self_condition:
                model_output = self.model(
                    x, t, torch.zeros_like(x) if x_self_cond is None
                    else x_self_cond)
            else:
                model_output = self.model(x, t)
        elif cond_scale == 1.0:
            # one conditional forward
            model_output = self.model(
                x, t, classes,
                cond_drop_mask=torch.zeros(b, dtype=torch.bool,
                                           device=x.device))
        else:
            # [cond; null] as one 2B-batch forward
            mask = torch.arange(2 * b, device=x.device) >= b
            both = self.model(torch.cat([x, x]), torch.cat([t, t]),
                              torch.cat([classes, classes]),
                              cond_drop_mask=mask)
            model_output = apply_cfg(both[:b], both[b:], cond_scale,
                                     rescaled_phi)
            if self.use_cfg_plus_plus:
                model_output_null = both[b:]

        def maybe_clip(z):
            return torch.clamp(z, -1.0, 1.0) if clip_x_start else z

        if self.objective == "pred_noise":
            pred_noise = (model_output if model_output_null is None
                          else model_output_null)
            x_start = maybe_clip(
                dm.predict_start_from_noise(sched, x, t, model_output))
        elif self.objective == "pred_x0":
            x_start = maybe_clip(model_output)
            x_for_noise = (x_start if model_output_null is None
                           else maybe_clip(model_output_null))
            pred_noise = dm.predict_noise_from_start(sched, x, t, x_for_noise)
        else:  # pred_v
            x_start = maybe_clip(
                dm.predict_start_from_v(sched, x, t, model_output))
            x_for_noise = (x_start if model_output_null is None
                           else maybe_clip(dm.predict_start_from_v(
                               sched, x, t, model_output_null)))
            pred_noise = dm.predict_noise_from_start(sched, x, t, x_for_noise)
        return pred_noise, x_start

    def ddim_time_pairs(self):
        """[(T-1, ...), ..., (0, -1)] as Python ints."""
        times = np.linspace(-1, self.timesteps - 1,
                            num=self.sampling_timesteps + 1).astype(int)[::-1]
        return [(int(a), int(b)) for a, b in zip(times[:-1], times[1:])]

    def _given_steps(self, step_noise):
        """Given per-step noise, NHWC [steps, *shape] -> NCHW; None stays
        None."""
        if step_noise is None:
            return None
        return torch.as_tensor(step_noise, dtype=torch.float32,
                               device=self.device).movedim(-1, 2)

    def _initial_noise(self, shape, init_noise, generator):
        """The initial NCHW noise for an NHWC `shape`: init_noise ([*shape],
        NHWC) as given, else a draw from `generator`."""
        if init_noise is not None:
            return _nchw(torch.as_tensor(init_noise, dtype=torch.float32,
                                         device=self.device))
        return torch.randn(_channels_first(shape), generator=generator,
                           device=self.device)

    def _finish(self, img, trajectory, return_all_timesteps: bool):
        """NHWC result, unnormalised: the final latents, or with
        `return_all_timesteps` the initial noise and every step's latents
        stacked on axis 1 ([B, steps + 1, H, W, C])."""
        if return_all_timesteps:
            return self.unnormalize(torch.stack(
                [_nhwc(x) for x in trajectory], dim=1))
        return self.unnormalize(_nhwc(img))

    def _chain(self, img, body, key, table: dict, *, classes=None,
               consts=None, step_noise=None, generator=None, graph=None,
               carry_x_start: bool = False,
               return_all_timesteps: bool = False, name: str = "step",
               latest=None):
        """The samplers' loop: `body` (a `ChainStep` body over the carry
        {"img"[, "x_start"]}) over the per-step `table` from NCHW `img`,
        given noise as its "noise" column; on the card each step a replay
        of the body's graph, kept under `key` for `latest` (see
        `graphs.ChainStep`). Returns the NHWC result (`_finish`)."""
        step = ChainStep(body, graphs=self._graphs, key=key,
                         graph=resolve_graph(graph, self.device),
                         name=f"{type(self).__name__} {name}", latest=latest)
        trajectory = [img]
        carry = run_chain(
            step, {"img": img,
                   "x_start": torch.zeros_like(img) if carry_x_start
                   else None},
            len(next(iter(table.values()))),
            consts={"classes": self._classes(classes), **(consts or {})},
            table={**table, "noise": self._given_steps(step_noise)},
            generators=[generator],
            each=((lambda c: trajectory.append(c["img"]))
                  if return_all_timesteps else None))
        return self._finish(carry["img"], trajectory, return_all_timesteps)

    def _times(self, start: int, batch: int):
        """The ancestral chain's t = start .. 0, [start + 1, batch] int64."""
        return torch.arange(start, -1, -1, device=self.device)[:, None].expand(
            -1, batch)

    @torch.inference_mode()
    def ddim_sample(self, shape, classes, *, cond_scale: float = 6.0,
                    rescaled_phi: float = 0.7, clip_denoised: bool = True,
                    return_all_timesteps: bool = False,
                    init_noise=None, step_noise=None,
                    generator: torch.Generator = None,
                    graph: Optional[bool] = None):
        """DDIM sampler. `shape` is NHWC. init_noise ([*shape]) and step_noise
        ([sampling_timesteps, *shape]), NHWC, replace the drawn noise; the
        tests drive the port and the JAX package with the same numbers.
        Otherwise noise comes from `generator`: the initial noise, then one
        draw per step.

        On the card (`graph` None) each step of the chain is a replay of one
        captured CUDA graph, the counterpart of the JAX package's one
        `lax.scan` program: the graph is captured per (shape, cond_scale,
        rescaled_phi, clip, which noise is given) at the chain's second
        step, the first running eagerly, and kept on this diffusion. Given
        noise goes in through the graph's static buffers, drawn noise comes
        from `generator` in the eager loop's order, and the self-condition
        carry is one of the graph's inputs. `graph` False runs the Python
        loop of steps (the CPU's path); True on the CPU raises."""
        kw = dict(cond_scale=cond_scale, rescaled_phi=rescaled_phi,
                  clip_denoised=clip_denoised)

        def body(generators, carry, consts, row):
            img = carry["img"]
            noise = _row_noise(row, img, generators)
            img, x_start = self._ddim_update(
                img, row["time"], row["time_next"], consts.get("classes"),
                noise, x_self_cond=carry.get("x_start"), **kw)
            return {"img": img, "x_start": x_start}

        pairs = torch.tensor(self.ddim_time_pairs(), dtype=torch.long,
                             device=self.device)[:, :, None].expand(
                                 -1, -1, shape[0])
        img = self._initial_noise(shape, init_noise, generator)
        return self._chain(
            img, body, ("ddim", *kw.values()),
            {"time": pairs[:, 0], "time_next": pairs[:, 1]}, classes=classes,
            step_noise=step_noise, generator=generator, graph=graph,
            carry_x_start=self.self_condition,
            return_all_timesteps=return_all_timesteps, name="DDIM step")

    def _classes(self, classes):
        return (None if classes is None
                else torch.as_tensor(classes, device=self.device))

    def _p_predict(self, img, tb, classes, *, cond_scale: float,
                   rescaled_phi: float, clip_denoised: bool,
                   x_self_cond=None):
        """(posterior mean, clipped log variance, x_0 estimate) at x_t:
        the model's x_0, clipped after `model_predictions`."""
        _, x_start = self.model_predictions(
            img, tb, classes, cond_scale=cond_scale,
            rescaled_phi=rescaled_phi, x_self_cond=x_self_cond)
        if clip_denoised:
            x_start = torch.clamp(x_start, -1.0, 1.0)
        mean, _, log_var = dm.q_posterior(self.schedule, x_start, img, tb)
        return mean, log_var, x_start

    def _ancestral_body(self, predict):
        """The ancestral chain's step body: (mean, log_var, x_0) =
        predict(x_t, t [B], consts, x_self_cond), then
        `ancestral_update` with this step's noise (drawn first, as the
        eager loop draws it)."""
        def body(generators, carry, consts, row):
            img, tb = carry["img"], row["t"]
            noise = _row_noise(row, img, generators)
            mean, log_var, x_start = predict(img, tb, consts,
                                             carry.get("x_start"))
            return {"img": ancestral_update(mean, log_var, noise, tb),
                    "x_start": x_start}

        return body

    def _cfg_ancestral(self, img, start: int, classes, *, cond_scale,
                       rescaled_phi, clip_denoised, carry_x_start,
                       step_noise, generator, graph,
                       return_all_timesteps=False):
        """Ancestral steps from t = start down to 0 over NCHW `img`
        (`_p_predict`, then `ancestral_update`), the x_0 estimate carried
        into the next step with `carry_x_start`."""
        kw = dict(cond_scale=cond_scale, rescaled_phi=rescaled_phi,
                  clip_denoised=clip_denoised)

        def predict(x, tb, consts, x_self_cond):
            return self._p_predict(x, tb, consts.get("classes"),
                                   x_self_cond=x_self_cond, **kw)

        return self._chain(
            img, self._ancestral_body(predict),
            ("ancestral", *kw.values(), carry_x_start),
            {"t": self._times(start, img.shape[0])}, classes=classes,
            step_noise=step_noise, generator=generator, graph=graph,
            carry_x_start=carry_x_start,
            return_all_timesteps=return_all_timesteps,
            name="ancestral step")

    @torch.inference_mode()
    def p_sample_loop(self, shape, classes, *, cond_scale: float = 6.0,
                      rescaled_phi: float = 0.7, clip_denoised: bool = True,
                      return_all_timesteps: bool = False, init_noise=None,
                      step_noise=None, generator: torch.Generator = None,
                      graph: Optional[bool] = None):
        """Ancestral (DDPM) sampler over every t from T-1 down to 0. `shape`
        is NHWC; init_noise ([*shape]) and step_noise ([timesteps, *shape],
        row i for t = T-1-i; the row for t = 0 is unused), NHWC, replace the
        draws from `generator` (one per step, t = 0 included, as the JAX
        package draws). `graph` as in `ddim_sample`: each step a replay of
        one captured graph on the card."""
        img = self._initial_noise(shape, init_noise, generator)
        return self._cfg_ancestral(
            img, self.timesteps - 1, classes, cond_scale=cond_scale,
            rescaled_phi=rescaled_phi, clip_denoised=clip_denoised,
            carry_x_start=self.self_condition, step_noise=step_noise,
            generator=generator, graph=graph,
            return_all_timesteps=return_all_timesteps)

    def _ancestral_loop(self, shape, mean_and_log_var, key,
                        return_all_timesteps: bool, init_noise, step_noise,
                        generator, *, consts=None, graph=None,
                        latest=None):
        """The ancestral loop of the learned-variance, weighted-objective
        and guided samplers: from x_T, x_{t-1} = mean + exp(log_var / 2) *
        noise for t = T-1 .. 0 (no noise at t = 0), (mean, log_var) =
        mean_and_log_var(x_t, t [B], consts). Noise and `graph` as in
        `p_sample_loop`; `key` and `latest` (`graphs.ChainStep`) name
        what the caller's mean_and_log_var reads besides its arguments.
        Their JAX counterparts return the final samples only."""
        if return_all_timesteps:
            raise ValueError("this sampler returns the final samples only")
        img = self._initial_noise(shape, init_noise, generator)

        def predict(x, tb, consts, _):
            return (*mean_and_log_var(x, tb, consts), None)

        return self._chain(
            img, self._ancestral_body(predict), key,
            {"t": self._times(self.timesteps - 1, shape[0])}, consts=consts,
            step_noise=step_noise, generator=generator, graph=graph,
            latest=latest, name="ancestral step")

    def ddim_step(self, img, time, time_next, classes, noise, *,
                  cond_scale: float = 6.0, rescaled_phi: float = 0.7,
                  clip_denoised: bool = True):
        """One CFG DDIM step, NCHW: the model's prediction at `time` [B],
        then the update to `time_next` [B] with `noise`; at time_next < 0
        the prediction of x_0. `ddim_sample` runs it (`_ddim_update`) and
        `DDIMStep` exports it, so the live pipeline and a served artifact
        run one code path."""
        return self._ddim_update(img, time, time_next, classes, noise,
                                 cond_scale=cond_scale,
                                 rescaled_phi=rescaled_phi,
                                 clip_denoised=clip_denoised)[0]

    def _ddim_update(self, img, time, time_next, classes, noise, *,
                     cond_scale: float, rescaled_phi: float,
                     clip_denoised: bool, x_self_cond=None):
        """`ddim_step`, returning (the next img, the x_0 estimate)."""
        pred_noise, x_start = self.model_predictions(
            img, time, classes, cond_scale=cond_scale,
            rescaled_phi=rescaled_phi, clip_x_start=clip_denoised,
            x_self_cond=x_self_cond)
        return dm.ddim_step(self.schedule, img, x_start, pred_noise, time,
                            time_next, noise, self.ddim_sampling_eta), x_start

    def sample(self, batch_size: Optional[int] = None, classes=None, *,
               cond_scale: float = 6.0, rescaled_phi: float = 0.7,
               return_all_timesteps: bool = False,
               generator: torch.Generator = None,
               graph: Optional[bool] = None):
        """NHWC samples for `classes` (unconditional with classes None):
        DDIM when sampling_timesteps < T, the ancestral sampler when they
        are equal; `graph` as in `ddim_sample`."""
        if batch_size is None:
            if classes is None:
                raise ValueError("sample needs batch_size or classes")
            batch_size = len(classes)
        shape = (batch_size, self.image_size, self.image_size, self.channels)
        fn = self.ddim_sample if self.is_ddim_sampling else self.p_sample_loop
        return fn(shape, classes, cond_scale=cond_scale,
                  rescaled_phi=rescaled_phi,
                  return_all_timesteps=return_all_timesteps,
                  generator=generator, graph=graph)

    @torch.inference_mode()
    def interpolate(self, x1, x2, classes, t: Optional[int] = None,
                    lam: float = 0.5, *, noise1=None, noise2=None,
                    step_noise=None, generator: torch.Generator = None,
                    graph: Optional[bool] = None):
        """Diffuse NHWC x1 and x2 to time t (default T-1), mix them as
        (1 - lam) x1_t + lam x2_t, then denoise ancestrally from t-1 down
        to 0 at cond_scale 1.0. noise1 / noise2 (the two q_sample draws,
        NHWC) and step_noise ([t, *shape]) replace the draws from
        `generator`, in that order. `graph` as in `ddim_sample`: the
        steps replay `p_sample_loop`'s graph at cond_scale 1.0."""
        t = self.timesteps - 1 if t is None else t
        dev = self.device
        x1 = _nchw(torch.as_tensor(x1, dtype=torch.float32, device=dev))
        x2 = _nchw(torch.as_tensor(x2, dtype=torch.float32, device=dev))

        def given_or_drawn(noise):
            if noise is not None:
                return _nchw(torch.as_tensor(noise, dtype=torch.float32,
                                             device=dev))
            return torch.randn(x1.shape, generator=generator, device=dev)

        tb = torch.full((x1.shape[0],), t, dtype=torch.long, device=dev)
        xt1 = dm.q_sample(self.schedule, self.normalize(x1), tb,
                          given_or_drawn(noise1))
        xt2 = dm.q_sample(self.schedule, self.normalize(x2), tb,
                          given_or_drawn(noise2))
        img = (1 - lam) * xt1 + lam * xt2
        return self._cfg_ancestral(
            img, t - 1, classes, cond_scale=1.0, rescaled_phi=0.0,
            clip_denoised=True, carry_x_start=False, step_noise=step_noise,
            generator=generator, graph=graph)


def _row_noise(row: dict, img, generators, name: str = "noise"):
    """A step's noise: its row `name` of the given noise, else a draw of
    img's shape from the step's generator."""
    if name in row:
        return row[name]
    return torch.randn(img.shape, generator=generators[0], device=img.device)


def ancestral_update(mean, log_var, noise, tb):
    """x_{t-1} = mean + exp(log_var / 2) * noise, and the mean alone where
    t [B] is 0: a device mask, as JAX's `jnp.where`, both sides always
    computed."""
    last = (tb == 0).reshape(-1, *((1,) * (mean.ndim - 1)))
    return torch.where(last, mean, mean + torch.exp(0.5 * log_var) * noise)


class DDIMStep(nn.Module):
    """`GaussianDiffusion.ddim_step` at a fixed cond_scale and rescaled_phi,
    as a module: forward(img [B,C,H,W], time [B], time_next [B], classes
    [B], noise [B,C,H,W]) -> the next img. The model is a submodule, so
    `torch.export` keeps its weights as the program's parameters; the
    schedule's tensors become the program's constants."""

    def __init__(self, diffusion: GaussianDiffusion, cond_scale: float,
                 rescaled_phi: float, clip_denoised: bool = True):
        super().__init__()
        self.diffusion = diffusion
        self.model = diffusion.model
        self.cond_scale = cond_scale
        self.rescaled_phi = rescaled_phi
        self.clip_denoised = clip_denoised

    def forward(self, img, time, time_next, classes, noise):
        return self.diffusion.ddim_step(
            img, time, time_next, classes, noise,
            cond_scale=self.cond_scale, rescaled_phi=self.rescaled_phi,
            clip_denoised=self.clip_denoised)
