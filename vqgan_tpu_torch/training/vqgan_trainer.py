"""Stage-1 VQ-GAN trainer.

Counterpart of vqgan_tpu/training/vqgan_trainer.py with its per-step loop:
the VQ-VAE, PatchGAN and LPIPS of a VQGANConfig; `ImageFolderDataset` over
the split's training images; the G step each step and the D step from
`disc_start` on (`vqgan_step.make_vqgan_split_steps`); the optional
dead-code revival; `reconstruction-{m}.png` grids and milestone + latest
checkpoints (`vqgan-{m}.pt`: step, VQ-VAE, discriminator with its BatchNorm
statistics, both optimizer states) every `save_and_sample_every` steps; and
`load(milestone)` to resume.

- The watchdog reads each step's loss one step late, after the next step
  is queued, so the loop never waits for the device to drain.
- A save first drains that pending loss, and a cadence of 0 turns its event
  off (the two faults ADVICE.md records in the JAX package's scan loop).
- A run that ends off the save cadence still leaves a loadable checkpoint,
  numbered as the JAX trainer numbers it (steps // every + 1).
- Errors propagate: a failed grid or save stops the run.
- Revival draws its rows from one generator seeded with seed ^ 0x5EED; the
  JAX trainer folds the step into its key, so the two draw other rows, and
  a resumed run starts the generator anew.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..configs.vqgan_config import VQGANConfig
from ..data import BatchLoader, ImageFolderDataset, load_split
from ..device import resolve_device
from ..models import LPIPS, VQVAE, PatchGANDiscriminator
from ..models.lpips import perceptual_loss_fn
from ..ops.vq import revive_dead_codes
from ..utils.metrics_log import MetricsLogger
from .vqgan_step import (
    VQGANTrainState,
    make_gan_optimizers,
    make_vqgan_split_steps,
    reset_codebook_moments,
)
from .watchdog import TrainingWatchdog

__all__ = ["VQGANTrainer"]


class VQGANTrainer:
    def __init__(self, config: VQGANConfig, split_path: Optional[str] = None,
                 lpips_weights: Optional[Dict[str, Dict]] = None,
                 device="cuda"):
        """`lpips_weights`: {"vgg": torchvision VGG16 state, "lin": lpips
        lin state} for `LPIPS.load_torch_weights`; None keeps LPIPS at its
        random initialisation, as the JAX trainer does without weights."""
        self.config = cfg = config
        self.device = resolve_device(device)
        dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                 else torch.float32)
        torch.manual_seed(cfg.seed)  # initial weights
        self.vqvae = VQVAE(
            ch=cfg.ch, ch_mult=cfg.ch_mult, num_res_blocks=cfg.num_res_blocks,
            attn_resolutions=cfg.attn_resolutions, dropout=cfg.dropout,
            resolution=cfg.image_size, z_channels=cfg.z_channels,
            num_embeddings=cfg.num_embeddings,
            embedding_dim=cfg.embedding_dim,
            commitment_cost=cfg.commitment_cost,
            out_channels=cfg.out_channels, dtype=dtype).to(self.device)
        self.disc = PatchGANDiscriminator(
            input_nc=cfg.in_channels, ndf=cfg.disc_ndf,
            n_layers=cfg.disc_n_layers, norm=cfg.disc_norm,
            dtype=dtype).to(self.device)
        self.lpips = LPIPS(dtype)
        if lpips_weights is not None:
            self.lpips.load_torch_weights(lpips_weights["vgg"],
                                          lpips_weights["lin"])
        self.lpips = self.lpips.to(self.device).eval().requires_grad_(False)
        n_params = sum(p.numel() for p in self.vqvae.parameters())
        print(f"VQ-VAE parameters: {n_params / 1e6:.1f}M")

        self.opt_g, self.opt_d = make_gan_optimizers(
            self.vqvae.parameters(), self.disc.parameters(),
            learning_rate=cfg.learning_rate,
            disc_learning_rate=cfg.disc_learning_rate,
            betas=cfg.adam_betas, weight_decay=cfg.weight_decay,
            max_grad_norm=cfg.max_grad_norm or None,
            gradient_accumulate_every=cfg.gradient_accumulate_every)
        self.g_step, self.d_step = make_vqgan_split_steps(
            disc_start=cfg.disc_start, disc_weight=cfg.disc_weight,
            perceptual_weight=cfg.perceptual_weight,
            disc_loss_type=cfg.disc_loss_type,
            perceptual_fn=perceptual_loss_fn(self.lpips),
            use_adaptive_weight=cfg.use_adaptive_weight)
        self.state = VQGANTrainState(0, self.vqvae, self.disc, self.opt_g,
                                     self.opt_d)

        self.loader = None
        if split_path is not None:
            dataset = ImageFolderDataset(cfg.data_path, load_split(split_path),
                                         "train", image_size=cfg.image_size)
            self.loader = BatchLoader(dataset, cfg.batch_size, shuffle=True,
                                      seed=cfg.seed, repeat=True)

        self.ckpt = CheckpointManager(cfg.results_folder, prefix="vqgan")
        self.watchdog = TrainingWatchdog()
        self.metrics = MetricsLogger(cfg.results_folder, run_name="vqgan")
        self._revive_every = int(cfg.revive_dead_codes_every or 0)
        self._usage_accum = torch.zeros((cfg.num_embeddings,),
                                        dtype=torch.int32, device=self.device)
        self._revive_gen = torch.Generator(self.device).manual_seed(
            cfg.seed ^ 0x5EED)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, images: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(images).to(self.device)

    # ------------------------------------------------------------------

    def dispatch_step(self, images: torch.Tensor, step: int) -> dict:
        """One full training step: the G update, plus the D update where
        `step >= disc_start`. Returns the merged logs."""
        recon, log = self.g_step(self.state, images)
        if step >= self.config.disc_start:
            log.update(self.d_step(self.state, images, recon))
        return log

    def revive(self, images: torch.Tensor, step: int) -> int:
        """Re-anchor the codes unused since the last revival to random
        pre-quant features of `images` (NHWC) and zero their Adam moments."""
        codebook = self.vqvae.quantizer.embedding.weight
        with torch.no_grad():
            z = self.vqvae.encode_pre_quant(images.permute(0, 3, 1, 2))
            new, n, dead = revive_dead_codes(
                codebook, self._usage_accum, z.permute(0, 2, 3, 1),
                self._revive_gen, self.config.revive_usage_threshold)
            codebook.copy_(new)
        reset_codebook_moments(self.opt_g, codebook, dead)
        self._usage_accum.zero_()
        n = int(n)
        print(f"  [revive] step {step}: re-anchored {n} dead codes")
        return n

    def train(self, num_steps: Optional[int] = None, log_every: int = 50,
              timing_warmup: int = 5) -> dict:
        """Train up to step `num_steps` (default cfg.train_steps). Returns
        {"losses": every step's loss_total, "timed_steps", "timed_seconds",
        "images_per_s"}: host seconds of the steps after the first
        `timing_warmup`, the device synchronised at both ends, grids and
        checkpoint saves excluded."""
        cfg = self.config
        num_steps = num_steps or cfg.train_steps
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
        images_np = None
        timed_from = None
        timed_seconds = 0.0
        t_log, n_log = time.perf_counter(), 0
        try:
            for step in range(start, num_steps):
                if step - start == timing_warmup:
                    self._sync()
                    timed_from = time.perf_counter()
                images_np, _ = next(batches)
                images = self._to_device(images_np)
                log = self.dispatch_step(images, step)
                if self._revive_every:
                    self._usage_accum += log["usage_counts"]
                    if (step + 1) % self._revive_every == 0:
                        self.revive(images, step + 1)
                drain()  # the previous step's loss; this step stays queued
                pending = (step + 1, log["loss_total"])
                n_log += 1

                if log_every and (step + 1) % log_every == 0:
                    host = {k: float(v) for k, v in log.items()
                            if v.ndim == 0}  # usage_counts is [K]
                    ips = n_log * cfg.batch_size / (
                        time.perf_counter() - t_log)
                    self.metrics.log(step + 1,
                                     {**host, "images_per_sec": ips})
                    print(f"step {step + 1}/{num_steps} "
                          f"g={host['total_loss']:.4f} "
                          f"d={host.get('d_loss', 0.0):.4f} "
                          f"vq={host['vq_loss']:.4f} "
                          f"usage={host['codebook_usage_ratio']:.2f} "
                          f"({ips:.1f} img/s)")
                    t_log, n_log = time.perf_counter(), 0

                if every and (step + 1) % every == 0:
                    drain()
                    if timed_from is not None:
                        timed_seconds += time.perf_counter() - timed_from
                    self.save_and_sample((step + 1) // every, images_np)
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
            self.save_and_sample(num_steps // every + 1 if every else 1,
                                 images_np)
        return {"losses": losses, "timed_steps": timed_steps,
                "timed_seconds": timed_seconds,
                "images_per_s": (timed_steps * cfg.batch_size / timed_seconds
                                 if timed_seconds else None)}

    # ------------------------------------------------------------------

    def reconstruct(self, images: np.ndarray) -> np.ndarray:
        """NHWC images in [0, 1] -> their NHWC reconstructions."""
        with torch.inference_mode():
            recon, _, _ = self.vqvae(
                self._to_device(images).permute(0, 3, 1, 2))
        return recon.permute(0, 2, 3, 1).float().cpu().numpy()

    def save_and_sample(self, milestone: int, images=None):
        if images is not None:
            n = min(self.config.num_samples, len(images))
            self._save_grid(images[:n], self.reconstruct(images[:n]),
                            milestone)
        self.ckpt.save(milestone, self.state.state_dict(),
                       config=dataclasses.asdict(self.config))

    def _save_grid(self, images, recon, milestone: int):
        """One row per image: the input, then its reconstruction."""
        from PIL import Image

        rows = [np.concatenate([img, rec], axis=1)
                for img, rec in zip(images, recon)]
        grid = (np.clip(np.concatenate(rows, axis=0), 0, 1) * 255).astype(
            np.uint8)
        out = Path(self.config.results_folder)
        out.mkdir(parents=True, exist_ok=True)
        Image.fromarray(grid).save(out / f"reconstruction-{milestone}.png")

    def load(self, milestone: Optional[int] = None) -> int:
        """Resume from `milestone` (the latest when None); returns the step."""
        self.state.load_state_dict(self.ckpt.restore(milestone))
        return self.state.step
