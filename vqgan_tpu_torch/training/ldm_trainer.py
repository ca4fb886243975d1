"""Stage-2 latent-diffusion trainer.

Counterpart of vqgan_tpu/training/ldm_trainer.py with its per-step loop:
the denoiser (the CFG U-Net, or the DiT with model_type "dit") and
GaussianDiffusion from an LDMConfig, optionally with gradient checkpointing
(the whole denoiser forward recomputed in the backward pass, as the JAX
package's Diffusers-style trainer rebuilds its step), `LatentDataset` over
the cached latents, Adam(W) with clipping and warmup, an EMA copy, the
loss-health watchdog, `sample-{m}.png` grids and milestone + latest
checkpoints every `save_and_sample_every` steps, and `load(milestone)` to
resume.

- The watchdog reads each step's loss one step late, after the next step
  is queued, so the loop never waits for the device to drain.
- A save first drains that pending loss, and a cadence of 0 turns its event
  off (the two faults ADVICE.md records in the JAX package's scan loop).
- A run that ends off the save cadence still leaves a loadable checkpoint.
- Errors propagate: a failed sample or save stops the run.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..build import build_cfg_unet_diffusion
from ..checkpoint.manager import CheckpointManager
from ..configs.ldm_config import LDMConfig
from ..data import BatchLoader, LatentCache, LatentDataset, load_split
from ..device import resolve_device
from ..utils.metrics_log import MetricsLogger
from .ldm_step import LDMTrainState, make_ldm_optimizer, make_ldm_train_step
from .watchdog import TrainingWatchdog, check_sample_range

__all__ = ["LatentDiffusionTrainer"]


class LatentDiffusionTrainer:
    def __init__(self, config: LDMConfig, split_path: Optional[str] = None,
                 vae=None, device="cuda",
                 gradient_checkpointing: bool = False):
        """`vae`: the port's KLVAE on `device`, for sample grids and for
        encoding latents missing from the cache; None trains from a full
        cache and saves checkpoints without grids. `gradient_checkpointing`
        trades a second denoiser forward per step for the activations it
        would keep."""
        self.config = cfg = config
        self.device = resolve_device(device)
        torch.manual_seed(cfg.seed)  # initial weights
        self.model, self.diffusion = build_cfg_unet_diffusion(
            cfg, device=self.device,
            gradient_checkpointing=gradient_checkpointing)
        self.model.train()
        n_params = sum(p.numel() for p in self.model.parameters())
        name = "DiT" if cfg.model_type == "dit" else "CFG U-Net"
        print(f"{name} parameters: {n_params / 1e6:.1f}M")
        self.ema_model = copy.deepcopy(self.model).eval().requires_grad_(False)

        self.optimizer = make_ldm_optimizer(
            self.model.parameters(), learning_rate=cfg.train_lr,
            weight_decay=cfg.weight_decay, betas=cfg.adam_betas,
            max_grad_norm=cfg.max_grad_norm or None,
            warmup_steps=cfg.warmup_steps if cfg.use_lr_warmup else 0,
            gradient_accumulate_every=cfg.gradient_accumulate_every)
        self.train_step = make_ldm_train_step(
            self.diffusion, self.optimizer,
            cond_drop_prob=cfg.cond_drop_prob,
            contrastive_weight=(cfg.contrastive_weight
                                if cfg.use_contrastive_loss else 0.0),
            contrastive_start_step=cfg.contrastive_start_step,
            contrastive_temperature=cfg.contrastive_temperature,
            ema_decay=cfg.ema_decay, ema_update_every=cfg.ema_update_every)
        self.state = LDMTrainState(0, self.model, self.ema_model,
                                   self.optimizer)

        self.vae = vae
        self.loader = None
        if split_path is not None:
            dataset = LatentDataset(
                cfg.data_path, load_split(split_path),
                LatentCache(cfg.latents_cache_folder),
                image_size=cfg.image_size,
                encode_fn=self._encode if vae is not None else None,
                images_per_user=cfg.images_per_user_train, seed=cfg.seed)
            self.loader = BatchLoader(dataset, cfg.train_batch_size,
                                      shuffle=True, seed=cfg.seed,
                                      repeat=True)

        self.ckpt = CheckpointManager(cfg.results_folder, prefix="model")
        self.watchdog = TrainingWatchdog()
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed + 1)
        self.metrics = MetricsLogger(cfg.results_folder, run_name="ldm")

    def _encode(self, images: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            z = self.vae.encode_images_mean(
                torch.from_numpy(images).to(self.device))
        return z.float().cpu().numpy()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------

    def train(self, num_steps: Optional[int] = None, log_every: int = 50,
              timing_warmup: int = 5) -> dict:
        """Train up to step `num_steps` (default cfg.train_num_steps).
        Returns {"losses": every step's loss, "timed_steps", "timed_seconds",
        "latents_per_s"}: host seconds of the steps after the first
        `timing_warmup`, the device synchronised at both ends, checkpoint
        saves excluded."""
        cfg = self.config
        num_steps = num_steps or cfg.train_num_steps
        if self.loader is None:
            raise RuntimeError("no dataset configured: pass split_path")
        every = cfg.save_and_sample_every
        start = self.state.step
        losses = []
        pending = None  # (step, loss on the device)

        def drain():
            nonlocal pending
            if pending is not None:
                value = float(pending[1])
                losses.append(value)
                for w in self.watchdog.check(pending[0], value):
                    print(f"  [watchdog] {w}")
                pending = None

        batches = iter(self.loader)
        timed_from = None
        timed_seconds = 0.0
        t_log, n_log = time.perf_counter(), 0
        try:
            for step in range(start, num_steps):
                if step - start == timing_warmup:
                    self._sync()
                    timed_from = time.perf_counter()
                latents, labels = next(batches)
                log = self.train_step(
                    self.state, torch.from_numpy(latents).to(self.device),
                    torch.from_numpy(labels).to(self.device, torch.long),
                    generator=self.generator)
                drain()  # the previous step's loss; this step stays queued
                pending = (step + 1, log["loss"])
                n_log += 1

                if log_every and (step + 1) % log_every == 0:
                    host = {k: float(v) for k, v in log.items()}
                    ips = n_log * cfg.train_batch_size / (
                        time.perf_counter() - t_log)
                    self.metrics.log(step + 1, host)
                    msg = f"step {step + 1}/{num_steps} loss={host['loss']:.4f}"
                    if "contrastive_loss" in host:
                        msg += f" contrastive={host['contrastive_loss']:.4f}"
                    print(msg + f" ({ips:.1f} latents/s)")
                    t_log, n_log = time.perf_counter(), 0

                if every and (step + 1) % every == 0:
                    drain()
                    if timed_from is not None:
                        timed_seconds += time.perf_counter() - timed_from
                    self.save_and_sample((step + 1) // every)
                    if timed_from is not None:
                        timed_from = time.perf_counter()
        finally:
            batches.close()  # stops the loader's thread
        drain()
        self._sync()
        if timed_from is not None:
            timed_seconds += time.perf_counter() - timed_from
        timed_steps = max(num_steps - start - timing_warmup, 0)
        if num_steps > start and (not every or num_steps % every):
            self.save_and_sample(num_steps // every + 1 if every else 1)
        return {"losses": losses, "timed_steps": timed_steps,
                "timed_seconds": timed_seconds,
                "latents_per_s": (timed_steps * cfg.train_batch_size
                                  / timed_seconds if timed_seconds else None)}

    # ------------------------------------------------------------------

    def sample(self, num_samples: Optional[int] = None,
               use_ema: Optional[bool] = None,
               generator: Optional[torch.Generator] = None):
        """(NHWC latents, classes) of `num_samples` (cfg.num_samples) DDIM
        samples, classes cycling over the users."""
        cfg = self.config
        n = num_samples or cfg.num_samples
        use_ema = cfg.use_ema if use_ema is None else use_ema
        diffusion = dataclasses.replace(
            self.diffusion, model=self.ema_model if use_ema else self.model)
        classes = torch.arange(n) % cfg.num_users
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        latents = diffusion.sample(classes=classes, cond_scale=cfg.cond_scale,
                                   rescaled_phi=cfg.rescaled_phi,
                                   generator=generator)
        return latents, classes

    def save_and_sample(self, milestone: int):
        if self.vae is not None:
            latents, _ = self.sample()
            with torch.inference_mode():
                images = self.vae.decode_latents(latents).float().cpu().numpy()
            warn = check_sample_range(images)
            if warn:
                print(f"  [watchdog] {warn}")
            self._save_grid(images, milestone)
        self.ckpt.save(milestone, self.state.state_dict(),
                       config=dataclasses.asdict(self.config))

    def _save_grid(self, images: np.ndarray, milestone: int, ncol: int = 4):
        from PIL import Image

        n = len(images)
        ncol = min(ncol, n)
        nrow = -(-n // ncol)
        h, w, c = images.shape[1:]
        grid = np.zeros((nrow * h, ncol * w, c), np.float32)
        for i, img in enumerate(images):
            r, col = divmod(i, ncol)
            grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = img
        out = Path(self.config.results_folder)
        out.mkdir(parents=True, exist_ok=True)
        Image.fromarray((np.clip(grid, 0, 1) * 255).astype(np.uint8)).save(
            out / f"sample-{milestone}.png")

    def load(self, milestone: Optional[int] = None) -> int:
        """Resume from `milestone` (the latest when None); returns the step."""
        self.state.load_state_dict(self.ckpt.restore(milestone))
        return self.state.step
