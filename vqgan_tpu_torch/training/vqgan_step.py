"""The two-optimizer VQ-GAN training step, in the JAX package's three
dispatch forms (vqgan_tpu/training/vqgan_step.py):

- `make_vqgan_split_steps`: eager, a G step and a D step per call, the
  caller dispatching the D step only from `disc_start` on (the gate a host
  comparison);
- `make_vqgan_train_step`, the fused step: G then D in one call, the D
  update computed every step and masked by a device `disc_active`, so
  that before `disc_start` the discriminator's parameters, its BatchNorm
  running statistics and `opt_d` keep their old values;
- `make_vqgan_scan_steps` -> (scan_gd, scan_g): a block of K fused steps
  (G, then D on that step's detached reconstruction; the next step's G
  sees the updated D), or of K G-only steps for blocks that end by
  `disc_start`.

The fused and scan forms run on the card as CUDA graphs
(`graphs.BlockRunner`), eagerly on the CPU; their step counter lives on
the device and their optimizers are `CapturableOptimizer`s (the masked D
update). Their G step always computes D's logits with a graph, and the
adaptive weight, and gates the adversarial term on the device.

- G step: L1 + LPIPS + VQ loss, plus the adversarial term gated by
  `step >= disc_start`. It reads the discriminator in eval mode (running
  BatchNorm statistics, no update of them) with its parameters frozen, so
  no gradient reaches D. Before `disc_start` the D logits are computed
  without a graph: the term is multiplied by 0, and its gradient is 0.
- D step: two train-mode passes, real images then the detached
  reconstruction, so the BatchNorm running statistics update twice, in
  that order, as the JAX package's.
- Adaptive weight (`use_adaptive_weight`): ||grad nll|| / (||grad g|| +
  1e-4) at `decoder.conv_out.weight`, by `torch.autograd.grad` on the
  step's own graph (the JAX package recomputes the forward for each of its
  two `jax.grad` calls; the gradients are the same). As there, g is
  -mean(logits) whatever the loss type. It is computed only while the
  term is active: before that its factor is 0.
- Both optimizers are `LDMOptimizer` chains without warm-up: Adam(W) with
  optax's clipping rule and MultiSteps accumulation.
- `reset_codebook_moments` zeroes the Adam moments (and the accumulated
  gradient) of revived codebook rows.
- On a mesh (`mesh`, its "data" axis over the ranks, each step given this
  rank's rows of the global batch), every form computes the step of the
  global batch, as the JAX package's jit over a batch placed P("data"):
  the discriminator's BatchNorm statistics over the global batch (its
  passes run inside `parallel.mesh.global_batch`), the adaptive weight
  from the last layer's gradients of nll and g averaged over "data"
  before their norms are taken, the G and D gradients averaged over
  "data" before clipping and Adam, and the logs the global batch's and
  the same on every rank (`usage_counts` the sum over the ranks, the
  usage ratio from that sum, the losses averaged). With no mesh, or one
  rank on "data", each is the single-device step bit for bit.

Images and reconstructions cross the step functions in NHWC, as in JAX;
the modules run NCHW.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..losses.gan import (
    adaptive_disc_weight,
    discriminator_loss,
    generator_loss,
)
from ..graphs import BlockRunner, GraphPool
from ..parallel import comm
from ..parallel.mesh import global_batch, mean_over_data
from .ldm_step import LDMOptimizer, make_ldm_optimizer

__all__ = ["VQGANTrainState", "make_gan_optimizers",
           "make_vqgan_scan_steps", "make_vqgan_split_steps",
           "make_vqgan_train_step", "reset_codebook_moments"]


def make_gan_optimizers(vqvae_params, disc_params,
                        learning_rate: float = 4.5e-5,
                        disc_learning_rate: float = 4.5e-5,
                        betas: Tuple[float, float] = (0.5, 0.9),
                        weight_decay: float = 0.0,
                        max_grad_norm: Optional[float] = 1.0,
                        gradient_accumulate_every: int = 1,
                        capturable: bool = False):
    """(G optimizer, D optimizer): Adam (AdamW when weight_decay > 0) with
    global-norm clipping; k > 1 averages k gradients per update. The fused
    and scan steps need `capturable` ones."""

    def chain(params, lr):
        return make_ldm_optimizer(
            params, learning_rate=lr, weight_decay=weight_decay, betas=betas,
            max_grad_norm=max_grad_norm,
            gradient_accumulate_every=gradient_accumulate_every,
            capturable=capturable)

    return (chain(vqvae_params, learning_rate),
            chain(disc_params, disc_learning_rate))


def reset_codebook_moments(optimizer: LDMOptimizer, codebook: nn.Parameter,
                           dead_mask: torch.Tensor) -> None:
    """Zero the optimizer's per-row state of the codebook rows in
    `dead_mask` [K]: Adam's moments and, under accumulation, the running
    gradient mean. A revived code's stale moments would drag it away from
    its new anchor."""
    rows = dead_mask[:, None]
    state = optimizer.inner.state.get(codebook, {})
    for key in ("exp_avg", "exp_avg_sq"):
        if key in state:
            state[key].masked_fill_(rows, 0.0)
    if optimizer.acc is not None:
        i = next(i for i, p in enumerate(optimizer.params) if p is codebook)
        optimizer.acc[i].masked_fill_(rows, 0.0)


@dataclasses.dataclass
class VQGANTrainState:
    """step (a host integer: G steps taken), the VQ-VAE, the discriminator
    and their optimizers."""

    step: int
    vqvae: nn.Module
    disc: nn.Module
    opt_g: LDMOptimizer
    opt_d: LDMOptimizer

    def state_dict(self) -> dict:
        """Step, both models (the discriminator with its BatchNorm running
        statistics) and both optimizer states."""
        return {"step": self.step, "vqvae": self.vqvae.state_dict(),
                "disc": self.disc.state_dict(),
                "opt_g": self.opt_g.state_dict(),
                "opt_d": self.opt_d.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.vqvae.load_state_dict(state["vqvae"])
        self.disc.load_state_dict(state["disc"])
        self.opt_g.load_state_dict(state["opt_g"])
        self.opt_d.load_state_dict(state["opt_d"])


@contextlib.contextmanager
def _frozen(module: nn.Module):
    """No parameter of `module` takes a gradient inside the block."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def _nchw(images):
    return images.permute(0, 3, 1, 2)


# logs that are already the global batch's on every rank: the adaptive
# weight (from the averaged gradients) and the usage ratio (from the
# summed histogram)
_GLOBAL_LOGS = ("disc_weight", "codebook_usage_ratio")


def _global_logs(log: dict, mesh) -> dict:
    """The global batch's logs from this rank's: the usage histogram summed
    over "data", the usage ratio from that sum, every other 0-d log (a
    mean over this rank's rows) averaged over "data"."""
    if mesh is None or not mesh.distributed:
        return log
    log = dict(log)
    if "usage_counts" in log:
        usage = comm.all_reduce_(log["usage_counts"].clone(),
                                 mesh.group("data"))
        log["usage_counts"] = usage
        log["codebook_usage_ratio"] = (usage > 0).float().mean()
    keys = [k for k, v in log.items()
            if v.ndim == 0 and k not in _GLOBAL_LOGS]
    log.update(zip(keys, mean_over_data([log[k] for k in keys], mesh)))
    return log


def _make_phases(*, disc_start: int, disc_weight: float,
                 perceptual_weight: float, disc_loss_type: str,
                 perceptual_fn: Optional[Callable],
                 use_adaptive_weight: bool, mesh=None):
    """The G and D updates, shared by the three dispatch forms, as the JAX
    package shares its `_make_phases`; on `mesh` the global batch's (see
    the module docstring)."""

    def g_phase(state: VQGANTrainState, images, step):
        """The G update at `step` (steps taken): a host integer, or a 0-d
        tensor on the device, and then D's logits and the adaptive weight
        are computed at every step and the gate is a device predicate.
        Returns (recon NHWC, detached; the G log; disc_active)."""
        x = _nchw(images)
        traced = torch.is_tensor(step)
        active = step >= disc_start
        state.vqvae.train()
        state.disc.eval()
        state.opt_g.zero_grad()
        with _frozen(state.disc), global_batch(mesh):
            recon, loss_dict, _ = state.vqvae(x)
            with torch.set_grad_enabled(traced or active):
                logits_fake = state.disc(recon)
            adaptive = None
            if use_adaptive_weight and (traced or active):
                last = state.vqvae.decoder.conv_out.weight
                nll = torch.mean(torch.abs(x - recon))
                if perceptual_fn is not None:
                    nll = nll + perceptual_weight * torch.mean(
                        perceptual_fn(recon, x))
                nll_grad, = torch.autograd.grad(nll, last, retain_graph=True)
                g_grad, = torch.autograd.grad(-torch.mean(logits_fake), last,
                                              retain_graph=True)
                nll_grad, g_grad = mean_over_data([nll_grad, g_grad], mesh)
                adaptive = adaptive_disc_weight(torch.linalg.norm(nll_grad),
                                                torch.linalg.norm(g_grad))
            gan_total, log = generator_loss(
                x, recon, logits_fake, disc_active=active,
                disc_weight=disc_weight, perceptual_weight=perceptual_weight,
                disc_loss_type=disc_loss_type, perceptual_fn=perceptual_fn,
                adaptive_weight=adaptive)
            total = gan_total + loss_dict["vq_loss"]
            total.backward()
        state.opt_g.step(mean_over_data(state.opt_g.grads(), mesh))
        log = {**log, **loss_dict, "loss_total": total}
        log = _global_logs({k: v.detach() for k, v in log.items()}, mesh)
        return recon.detach().permute(0, 2, 3, 1), log, active

    def d_phase(state: VQGANTrainState, images, recon, active=None):
        """The D update on the detached reconstruction: two train-mode
        passes, real then fake. With `active` (a 0-d bool tensor) it is
        masked: where False, the parameters, `opt_d` and the BatchNorm
        running statistics keep their old values."""
        state.disc.train()
        state.opt_d.zero_grad()
        kept = (None if active is None
                else [b.clone() for b in state.disc.buffers()])
        with global_batch(mesh):
            logits_real = state.disc(_nchw(images))
            logits_fake = state.disc(_nchw(recon).detach())
        d_loss, log = discriminator_loss(
            logits_real, logits_fake,
            disc_active=True if active is None else active,
            disc_loss_type=disc_loss_type)
        d_loss.backward()
        grads = mean_over_data(state.opt_d.grads(), mesh)
        if active is None:
            state.opt_d.step(grads)
        else:
            state.opt_d.step(grads, active=active)
            with torch.no_grad():
                for buf, old in zip(state.disc.buffers(), kept):
                    buf.copy_(torch.where(active, buf, old))
        return _global_logs({k: v.detach() for k, v in log.items()}, mesh)

    return g_phase, d_phase


def make_vqgan_split_steps(*, disc_start: int = 10000,
                           disc_weight: float = 0.1,
                           perceptual_weight: float = 1.0,
                           disc_loss_type: str = "hinge",
                           perceptual_fn: Optional[Callable] = None,
                           use_adaptive_weight: bool = False, mesh=None):
    """(g_step, d_step):

        g_step(state, images)        -> (recon NHWC, detached; G log)
        d_step(state, images, recon) -> D log

    images [B, H, W, C] in [0, 1]. `g_step` updates the VQ-VAE and advances
    `state.step`; `d_step` updates the discriminator and is unconditional:
    the caller runs it only where the pre-increment step >= disc_start.
    Logs hold detached tensors on the device (usage_counts is [K]). On
    `mesh`, images are this rank's rows of the global batch."""
    g_phase, d_phase = _make_phases(
        disc_start=disc_start, disc_weight=disc_weight,
        perceptual_weight=perceptual_weight, disc_loss_type=disc_loss_type,
        perceptual_fn=perceptual_fn, use_adaptive_weight=use_adaptive_weight,
        mesh=mesh)

    def g_step(state: VQGANTrainState, images):
        recon, log, _ = g_phase(state, images, state.step)
        state.step += 1
        return recon, log

    def d_step(state: VQGANTrainState, images, recon):
        return d_phase(state, images, recon)

    return g_step, d_step


def make_vqgan_scan_steps(*, disc_start: int = 10000,
                          disc_weight: float = 0.1,
                          perceptual_weight: float = 1.0,
                          disc_loss_type: str = "hinge",
                          perceptual_fn: Optional[Callable] = None,
                          use_adaptive_weight: bool = False,
                          usage_accum: Optional[torch.Tensor] = None,
                          mesh=None, graph: bool = True):
    """(scan_gd, scan_g), the counterpart of the JAX package's
    `make_vqgan_scan_steps`:

        scan_gd(state, superbatch [K, B, H, W, C]) -> stacked logs
        scan_g(state, superbatch)                  -> stacked G logs

    `scan_gd` runs K fused steps (G, then D masked by the device
    `disc_active`), correct at any step; `scan_g` runs K G-only steps,
    for blocks that end by `disc_start`. Every log has a leading [K] axis.
    `usage_accum` ([num_embeddings] int32), when given, adds each step's
    codebook usage inside the steps (the trainer's revival window). On the
    card each step replays one CUDA graph (`graphs.BlockRunner`), on the
    CPU the steps run eagerly; `scan_gd.runners` and `scan_g.runners` hold
    the graphs, which share one memory pool (a run replays one or the
    other, never both at once). Both optimizers must be
    `CapturableOptimizer`s. On `mesh` the superbatch is [K, B/data, H, W,
    C], this rank's rows of each batch, and on the card the graphs hold
    the steps' NCCL collectives. `graph` False runs the steps eagerly on
    the card too (the reference a captured run is held against)."""
    g_phase, d_phase = _make_phases(
        disc_start=disc_start, disc_weight=disc_weight,
        perceptual_weight=perceptual_weight, disc_loss_type=disc_loss_type,
        perceptual_fn=perceptual_fn, use_adaptive_weight=use_adaptive_weight,
        mesh=mesh)
    counters = {}  # device -> the device step counter
    pool = GraphPool()

    def one_step(state, counter, images, with_d: bool) -> dict:
        recon, log, active = g_phase(state, images, counter)
        counter.add_(1)
        if with_d:
            log.update(d_phase(state, images, recon, active))
        if usage_accum is not None:
            usage_accum.add_(log["usage_counts"])
        return log

    def make(with_d: bool):
        runners = {}
        names = []

        def scan(state: VQGANTrainState, superbatch) -> dict:
            dev = superbatch.device
            if dev not in counters:
                counters[dev] = torch.zeros((), dtype=torch.long, device=dev)
            counter = counters[dev]

            def body(generators, images):
                logs = [one_step(state, counter, x, with_d) for x in images]
                if not names:
                    names.extend(logs[0])
                return tuple(torch.stack([log[k] for log in logs])
                             for k in names)

            if id(state) not in runners:
                runners[id(state)] = BlockRunner(
                    body,
                    name="VQ-GAN G+D steps" if with_d else "VQ-GAN G steps",
                    graph=graph, pool=pool)
            counter.fill_(state.step)
            out = runners[id(state)](superbatch)
            state.step += superbatch.shape[0]
            return dict(zip(names, out))

        scan.runners = runners
        return scan

    return make(True), make(False)


def make_vqgan_train_step(**step_kwargs):
    """The fused step, the counterpart of the JAX package's
    `make_vqgan_train_step`: train_step(state, images [B, H, W, C]) -> the
    merged G and D logs, one `scan_gd` step (G, then D masked by the
    device `disc_active`); as a CUDA graph on the card.
    `step_kwargs` are `make_vqgan_scan_steps`'."""
    scan_gd, _ = make_vqgan_scan_steps(**step_kwargs)

    def train_step(state: VQGANTrainState, images) -> dict:
        return {k: v[0] for k, v in scan_gd(state, images[None]).items()}

    train_step.runners = scan_gd.runners
    return train_step
