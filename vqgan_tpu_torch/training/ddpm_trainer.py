"""Unconditional DDPM trainer.

Counterpart of vqgan_tpu/training/ddpm_trainer.py: an image-folder dataset,
Adam with clipping, an EMA copy, periodic sample grids, optional FID at
each milestone with best/latest-only checkpoint retention
(`save_best_and_latest_only`), milestone save and load.

- The optimizer is `make_ldm_optimizer` (weight decay 0, so Adam), the EMA
  the port's `ema_update` every `ema_update_every` steps after step 100.
- The loader is `make_batch_loader`'s, as in the JAX trainer: an image
  folder of JPEGs takes the C++ decode ring (`FolderDataset.items`), any
  other dataset (`Dataset1D`, PNGs) the threaded `BatchLoader`, repeating
  epochs; `train` names it under "loader". Batches go through
  `device_prefetch` (depth 2): the copy of batch n + 2 from pinned memory
  is enqueued while step n runs.
- Losses stay on the device until a log line or the end of the run reads
  them, so the loop does not wait for each step.
- Errors propagate: the JAX package prints a warning when a sample grid
  fails and goes on; here a failed grid (a kernel that does not launch,
  say) stops the run.

Under a process group (torchrun) the trainer is data parallel, as the JAX
trainer on its mesh (`make_mesh_for_batch`, the state replicated, the
batch placed P("data")): every rank reads the same global batch from the
same seeded loader and steps on its rows. The loss runs inside
`parallel.mesh.global_batch`, so that every draw over the batch (t, the
noise, the offset noise, a variant's times or sigmas) is the global
batch's, drawn in the single-device order and sliced, the scalar
self-conditioning coin is the same on every rank, and the immiscible
assignment is solved once over the whole batch; the gradients are
averaged over "data" before the clip, so the online weights and the EMA
stay the same on every rank. Every rank samples its share of the FID's
images (`eval.fid`); rank 0 samples the grids, keeps best / latest and writes the checkpoints while the others
wait at a barrier, and every rank resumes from them. Any diffusion this
trainer trains runs so: its draws go through `draw_rows`.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..data.datasets import load_image
from ..data.native_image import loader_kind, make_batch_loader
from ..data.prefetch import device_prefetch, to_device
from ..data.splits import IMAGE_EXTENSIONS
from ..parallel.init import barrier, process_index
from ..parallel.mesh import (
    global_batch,
    is_main_process,
    local_rows,
    make_mesh_for_batch,
    mean_over_data,
    replicate_module,
)
from .ema import ema_update
from .ldm_step import LDMTrainState, global_norm, make_ldm_optimizer

__all__ = ["FolderDataset", "Trainer"]


class FolderDataset:
    """Every image under `folder` (recursively, sorted), resized and
    centre-cropped to `image_size`, as (image [H, W, 3] in [0, 1], 0)."""

    def __init__(self, folder: str | Path, image_size: int):
        self.image_size = image_size
        self.paths = sorted(p for p in Path(folder).rglob("*")
                            if p.suffix.lower() in IMAGE_EXTENSIONS)
        if not self.paths:
            raise ValueError(f"no images under {folder}")

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        return load_image(self.paths[i], self.image_size), 0

    @property
    def items(self):
        """[(path, 0)]: the view that `make_batch_loader` takes for the
        native C++ decode ring."""
        return [(p, 0) for p in self.paths]


def _with_denoiser(diffusion, model):
    """A copy of `diffusion` (GaussianDiffusion's `model`, or
    ElucidatedDiffusion's `net`) over `model`."""
    field = "model" if hasattr(diffusion, "model") else "net"
    return dataclasses.replace(diffusion, **{field: model})


class Trainer:
    """Trains `model` through `diffusion` (an unconditional
    GaussianDiffusion, or any object with `.loss(images, generator=)`, a
    `.sample(batch_size=, generator=)` returning NHWC images in [0, 1] (or
    a 1-D diffusion's sequences), a `device` and the model as `model` or
    `net`)."""

    def __init__(
        self,
        diffusion,
        model: torch.nn.Module,
        folder: Optional[str] = None,
        *,
        train_batch_size: int = 16,
        train_lr: float = 8e-5,
        train_num_steps: int = 100_000,
        adam_betas=(0.9, 0.99),
        max_grad_norm: float = 1.0,
        ema_decay: float = 0.995,
        ema_update_every: int = 10,
        save_and_sample_every: int = 1000,
        num_samples: int = 25,
        results_folder: str = "./results",
        calculate_fid: bool = False,
        fid_evaluator=None,  # eval.fid.FIDEvaluation with the real stats
        save_best_and_latest_only: bool = False,
        seed: int = 0,
        dataset=None,  # any indexable dataset of (item, label), e.g.
        # Dataset1D, instead of the folder
    ):
        if math.isqrt(num_samples) ** 2 != num_samples:
            raise ValueError(f"num_samples must be a square, got "
                             f"{num_samples}")
        self.diffusion = diffusion
        self.device = diffusion.device
        self.batch_size = train_batch_size
        self.train_num_steps = train_num_steps
        self.save_and_sample_every = save_and_sample_every
        self.num_samples = num_samples
        self.results_folder = Path(results_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)
        self.calculate_fid = calculate_fid
        self.fid_evaluator = fid_evaluator
        self.save_best_and_latest_only = save_best_and_latest_only
        self.best_fid = float("inf")
        self.last_fid = None  # the last milestone's FID
        self.ema_decay = ema_decay
        self.ema_update_every = ema_update_every

        self.mesh = (make_mesh_for_batch(train_batch_size, device=self.device)
                     if torch.distributed.is_initialized() else None)
        self.main = is_main_process()
        if self.mesh is not None:  # every rank starts from rank 0's values
            replicate_module(model, self.mesh)
        self.model = model.train()
        self.ema_model = copy.deepcopy(model).eval().requires_grad_(False)
        self.ema_diffusion = _with_denoiser(diffusion, self.ema_model)
        self.optimizer = make_ldm_optimizer(
            model.parameters(), learning_rate=train_lr, weight_decay=0.0,
            betas=adam_betas, max_grad_norm=max_grad_norm)
        self.state = LDMTrainState(0, model, self.ema_model, self.optimizer)
        self.generator = torch.Generator(self.device).manual_seed(seed)

        self.loader = self.loader_kind = None
        if dataset is None and folder is not None:
            dataset = FolderDataset(folder, diffusion.image_size)
        if dataset is not None:
            self.loader = make_batch_loader(dataset, train_batch_size,
                                            shuffle=True, seed=seed)
            self.loader_kind = loader_kind(self.loader)
        self.ckpt = CheckpointManager(self.results_folder, prefix="model")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train_step(self, images, **loss_kwargs) -> torch.Tensor:
        """One optimizer step on NHWC images in [0, 1] (`loss_kwargs` go to
        the diffusion's loss: t, noise, self_cond_coin, ...); the loss,
        detached, on the device. On a mesh, images are this rank's rows,
        the loss kwargs the global batch's (each rank takes its rows of
        every one with a batch axis; a 0-d one is shared), and the loss is
        the global batch's."""
        self.optimizer.zero_grad()
        if self.mesh is not None:
            loss_kwargs = {k: local_rows(torch.as_tensor(v), self.mesh)
                           if torch.as_tensor(v).ndim else v
                           for k, v in loss_kwargs.items()}
        with global_batch(self.mesh):
            loss = self.diffusion.loss(images, generator=self.generator,
                                       **loss_kwargs)
        loss.backward()
        grads = mean_over_data(self.optimizer.grads(), self.mesh)
        self.optimizer.step(grads, norm=global_norm(grads))
        ema_update(list(self.ema_model.parameters()),
                   list(self.model.parameters()), self.state.step,
                   decay=self.ema_decay, update_every=self.ema_update_every,
                   update_after_step=100)
        self.state.step += 1
        return mean_over_data([loss.detach()], self.mesh)[0]

    def train(self, log_every: int = 100, timing_warmup: int = 5) -> dict:
        """Train up to `train_num_steps`. Returns {"losses": every step's
        loss, "timed_steps", "timed_seconds", "images_per_s", "loader"}:
        host seconds of the steps after the first `timing_warmup`, the
        device synchronised at both ends, milestones (grids, FID, saves)
        excluded; the loader's `loader_kind`."""
        if self.loader is None:
            raise RuntimeError("no dataset: pass a folder or a dataset")
        start = self.state.step
        losses = []
        timed_from, timed_seconds = None, 0.0
        t_log = time.perf_counter()
        rows = ((lambda x: local_rows(x, self.mesh)) if self.mesh is not None
                else (lambda x: x))
        batches = device_prefetch(
            iter(self.loader), lambda b: to_device(rows(b[0]), self.device),
            depth=2)
        try:
            for step in range(start, self.train_num_steps):
                if step - start == timing_warmup:
                    self._sync()
                    timed_from = time.perf_counter()
                _, images = next(batches)
                losses.append(self.train_step(images))
                if (step + 1) % log_every == 0 and self.main:
                    ips = log_every * self.batch_size / (
                        time.perf_counter() - t_log)
                    print(f"step {step + 1}: loss={float(losses[-1]):.4f} "
                          f"({ips:.1f} img/s)")
                    t_log = time.perf_counter()
                if (step + 1) % self.save_and_sample_every == 0:
                    if timed_from is not None:
                        self._sync()
                        timed_seconds += time.perf_counter() - timed_from
                    self.save_and_sample(
                        (step + 1) // self.save_and_sample_every)
                    if timed_from is not None:
                        timed_from = time.perf_counter()
        finally:
            batches.close()  # stops the loader's thread
        self._sync()
        if timed_from is not None:
            timed_seconds += time.perf_counter() - timed_from
        timed_steps = max(self.train_num_steps - start - timing_warmup, 0)
        return {"losses": [float(x) for x in losses],
                "timed_steps": timed_steps, "timed_seconds": timed_seconds,
                "images_per_s": (timed_steps * self.batch_size / timed_seconds
                                 if timed_seconds else None),
                "loader": self.loader_kind}

    def sample_grid(self, milestone: int):
        """`num_samples` EMA samples as a square grid,
        sample-{milestone}.png; returns the NHWC samples. Samples that are
        not images (a 1-D diffusion's sequences) make no grid: the JAX
        trainer's grid fails on them and it prints a warning."""
        from PIL import Image

        n = self.num_samples
        gen = torch.Generator(self.device).manual_seed(milestone)
        out = self.ema_diffusion.sample(batch_size=n, generator=gen)
        if out.ndim != 4:
            print(f"milestone {milestone}: samples of shape "
                  f"{tuple(out.shape)} are not images; no grid")
            return out
        imgs = out.float().cpu().numpy()
        side = math.isqrt(n)
        h, w, c = imgs.shape[1:]
        grid = imgs.reshape(side, side, h, w, c).transpose(
            0, 2, 1, 3, 4).reshape(side * h, side * w, c)
        Image.fromarray((np.clip(grid, 0, 1) * 255).astype(np.uint8)).save(
            self.results_folder / f"sample-{milestone}.png")
        return out

    def save_and_sample(self, milestone: int):
        """The grid, the FID (with `calculate_fid`) and the checkpoint of
        milestone `milestone`. On a mesh every rank samples its share of
        the FID's images, from a generator seeded with its rank, and every rank gets the score; rank 0 makes
        the grid and writes the checkpoints while the others wait."""
        if self.main:
            self.sample_grid(milestone)
        fid = None
        if self.calculate_fid and self.fid_evaluator is not None:
            def sampler(generator, n):
                return self.ema_diffusion.sample(batch_size=n,
                                                 generator=generator)

            fid = self.fid_evaluator.fid_score(
                sampler, torch.Generator(self.device).manual_seed(
                    process_index()))
            if self.main:
                print(f"milestone {milestone}: FID {fid:.2f}")
        self.last_fid = fid
        if self.save_best_and_latest_only:
            # keep only "best" (by FID) and "latest"
            if fid is not None and fid < self.best_fid:
                self.best_fid = fid
                self._save(0, {"tag": "best", "fid": fid})
            self._save(1, {"tag": "latest"})
        else:
            self._save(milestone)
        if self.mesh is not None:
            barrier()

    def _save(self, milestone: int, config=None):
        if self.main:
            self.ckpt.save(milestone, self.state.state_dict(), config=config)

    def load(self, milestone: Optional[int] = None) -> int:
        """Resume from `milestone` (the latest when None): a `.pt` file of
        the port, or a JAX package's Orbax milestone `model-{m}/` of a
        model family with a converter (`checkpoint.load.jax_state_for`;
        another raises TypeError). Returns the step. On a mesh every rank
        reads the same checkpoint."""
        self.state.load_state_dict(self.ckpt.restore(milestone,
                                                     state=self.state))
        return self.state.step
