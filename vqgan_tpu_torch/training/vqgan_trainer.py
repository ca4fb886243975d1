"""Stage-1 VQ-GAN trainer.

Counterpart of vqgan_tpu/training/vqgan_trainer.py with its three step
modes: the VQ-VAE, PatchGAN and LPIPS of a VQGANConfig;
`ImageFolderDataset` over the split's training images; the optional
dead-code revival; `reconstruction-{m}.png` grids and milestone + latest
checkpoints (`vqgan-{m}.pt`: step, VQ-VAE, discriminator with its BatchNorm
statistics, both optimizer states) every `save_and_sample_every` steps; and
`load(milestone)` to resume.

`step_mode` "split": per batch the G step, and the D step from
`disc_start` on (`vqgan_step.make_vqgan_split_steps`), eagerly. "fused":
per batch one G+D step with the D update masked before `disc_start`
(`make_vqgan_train_step`), a CUDA graph on the card. "scan": `scan_block`
steps per dispatch (`make_vqgan_scan_steps`: G-only blocks where the block
ends by `disc_start`, G+D otherwise), CUDA graphs on the card, with
`scan_loop.run_scan_loop` and the JAX package's event rule: full blocks where the next event (a log, a
revival, a save with its grid, the end) is at least a block away, single
steps up to it. The captured modes keep the codebook-usage window inside
the steps, and their watchdog reads each dispatch's stacked losses one
dispatch late (a non-finite loss drains the dispatch just queued at once).
Checkpoints are the same in every mode, so a run resumes in any of them.

The images come from `make_batch_loader` with `native_input`, as in the
JAX trainer: the C++ decode ring where it applies, else the Python
BatchLoader; `loader_kind` names the one taken, and `train` returns it
under "loader". Every mode draws its batches through `device_prefetch`
(depth 2): the copy of batch n + 2 from pinned memory is enqueued while
step n runs. The captured modes take the prefetched device batch into
their static inputs by a device-to-device copy.

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

Under a process group (torchrun) the trainer is data parallel, as the JAX
trainer on its mesh (`make_mesh_for_batch`, the state replicated, the
batch placed P("data")): every rank reads the same global batch from the
same seeded loader and steps on its rows (`local_rows`; a scan superbatch
is [K, B/data, ...]); the steps (`vqgan_step`, on the mesh) compute the
global batch's BatchNorm statistics, adaptive weight, gradients and logs,
so the state stays the same on every rank; the revival window sums the
global usage and draws from the global batch's z rows with the same draw
on every rank. Rank 0 writes the grids, the checkpoints (whole tensors,
those of the single-device trainer) and the metrics log; every rank
resumes from them. Every step mode runs on the mesh; on the card the
captured ones hold the NCCL collectives in their graphs. With no process
group it is the single-device trainer.
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
from ..data import ImageFolderDataset, load_split
from ..data.native_image import loader_kind, make_batch_loader
from ..data.prefetch import device_prefetch, to_device
from ..device import resolve_device
from ..models import LPIPS, VQVAE, PatchGANDiscriminator
from ..models.lpips import perceptual_loss_fn
from ..ops.vq import revive_dead_codes
from ..parallel.init import barrier
from ..parallel.mesh import (
    global_batch,
    is_main_process,
    local_rows,
    make_mesh_for_batch,
    replicate_module,
)
from ..utils.metrics_log import MetricsLogger
from .vqgan_step import (
    VQGANTrainState,
    make_gan_optimizers,
    make_vqgan_scan_steps,
    make_vqgan_split_steps,
    make_vqgan_train_step,
    reset_codebook_moments,
)
from .scan_loop import capture_seconds, run_scan_loop
from .scan_loop import resolve_step_mode as _resolve_step_mode
from .watchdog import TrainingWatchdog

__all__ = ["STEP_MODES", "VQGANTrainer", "resolve_step_mode"]

STEP_MODES = ("split", "fused", "scan")


def resolve_step_mode(mode: str, train_steps: int) -> str:
    """"auto" gives "scan" for runs of 1000 steps or more and "split"
    otherwise, as the JAX CLI's `resolve_step_mode`; any other mode is
    itself."""
    return _resolve_step_mode(mode, train_steps, eager="split")


class VQGANTrainer:
    def __init__(self, config: VQGANConfig, split_path: Optional[str] = None,
                 lpips_weights: Optional[Dict[str, Dict]] = None,
                 device="cuda", step_mode: str = "split",
                 scan_block: int = 8, graph: bool = True):
        """`lpips_weights`: {"vgg": torchvision VGG16 state, "lin": lpips
        lin state} for `LPIPS.load_torch_weights`; None keeps LPIPS at its
        random initialisation, as the JAX trainer does without weights.
        `step_mode`, `scan_block`: see the module docstring. `graph` False
        runs the fused and scan modes' steps eagerly on the card as well:
        the reference a captured run is held against."""
        if step_mode not in STEP_MODES:
            raise ValueError(f"step_mode must be one of {STEP_MODES}, got "
                             f"{step_mode!r}")
        self.step_mode = step_mode
        self.scan_block = max(1, int(scan_block))
        self.config = cfg = config
        self.device = resolve_device(device)
        self.mesh = (make_mesh_for_batch(cfg.batch_size, device=self.device)
                     if torch.distributed.is_initialized() else None)
        self.main = is_main_process()
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
        if self.mesh is not None:  # every rank starts from rank 0's values
            for module in (self.vqvae, self.disc, self.lpips):
                replicate_module(module, self.mesh)
        n_params = sum(p.numel() for p in self.vqvae.parameters())
        print(f"VQ-VAE parameters: {n_params / 1e6:.1f}M")

        self.opt_g, self.opt_d = make_gan_optimizers(
            self.vqvae.parameters(), self.disc.parameters(),
            learning_rate=cfg.learning_rate,
            disc_learning_rate=cfg.disc_learning_rate,
            betas=cfg.adam_betas, weight_decay=cfg.weight_decay,
            max_grad_norm=cfg.max_grad_norm or None,
            gradient_accumulate_every=cfg.gradient_accumulate_every,
            capturable=step_mode != "split")
        self._revive_every = int(cfg.revive_dead_codes_every or 0)
        self._usage_accum = torch.zeros((cfg.num_embeddings,),
                                        dtype=torch.int32, device=self.device)
        step_kwargs = dict(
            disc_start=cfg.disc_start, disc_weight=cfg.disc_weight,
            perceptual_weight=cfg.perceptual_weight,
            disc_loss_type=cfg.disc_loss_type,
            perceptual_fn=perceptual_loss_fn(self.lpips),
            use_adaptive_weight=cfg.use_adaptive_weight, mesh=self.mesh)
        if step_mode == "split":
            self.g_step, self.d_step = make_vqgan_split_steps(**step_kwargs)
        else:
            captured = dict(step_kwargs, graph=graph,
                            usage_accum=(self._usage_accum
                                         if self._revive_every else None))
            if step_mode == "fused":
                self.train_step = make_vqgan_train_step(**captured)
            else:
                self.scan_gd, self.scan_g = make_vqgan_scan_steps(**captured)
        self.state = VQGANTrainState(0, self.vqvae, self.disc, self.opt_g,
                                     self.opt_d)

        self.loader = None
        self.loader_kind = None
        if split_path is not None:
            dataset = ImageFolderDataset(cfg.data_path, load_split(split_path),
                                         "train", image_size=cfg.image_size)
            self.loader = make_batch_loader(
                dataset, cfg.batch_size, shuffle=True, seed=cfg.seed,
                native=cfg.native_input)
            self.loader_kind = loader_kind(self.loader)
            print(f"input pipeline: {self.loader_kind}")

        self.ckpt = CheckpointManager(cfg.results_folder, prefix="vqgan")
        self.watchdog = TrainingWatchdog()
        self.metrics = (MetricsLogger(cfg.results_folder, run_name="vqgan")
                        if self.main else None)
        self._revive_gen = torch.Generator(self.device).manual_seed(
            cfg.seed ^ 0x5EED)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, images: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(images).to(self.device)

    def _prefetched(self):
        """The loader's ((images, labels), device images) pairs, each copy
        enqueued two batches ahead; on a mesh the device images are this
        rank's rows."""
        rows = ((lambda x: local_rows(x, self.mesh)) if self.mesh is not None
                else (lambda x: x))
        return device_prefetch(
            iter(self.loader), lambda b: to_device(rows(b[0]), self.device),
            depth=2)

    # ------------------------------------------------------------------

    def dispatch_step(self, images: torch.Tensor, step: int) -> dict:
        """One full training step: the G update, plus the D update where
        `step >= disc_start` (the fused step masks it on the device).
        Returns the merged logs."""
        if self.step_mode == "fused":
            return self.train_step(self.state, images)
        if self.step_mode == "scan":
            return {k: v[0] for k, v in
                    self.dispatch_block(images[None], step).items()}
        recon, log = self.g_step(self.state, images)
        if step >= self.config.disc_start:
            log.update(self.d_step(self.state, images, recon))
        return log

    def dispatch_block(self, superbatch: torch.Tensor, step: int) -> dict:
        """Run len(superbatch) steps ([K, B, H, W, C]) from `step` as one
        dispatch (step_mode "scan"): G-only where the block ends by
        `disc_start`, G+D otherwise. Returns the logs stacked on [K]."""
        if step + superbatch.shape[0] <= self.config.disc_start:
            return self.scan_g(self.state, superbatch)
        return self.scan_gd(self.state, superbatch)

    def graph_stats(self) -> list:
        """Each captured graph's name, capture seconds, pool bytes, replays
        and kernel launches per replay (the fused and scan modes)."""
        if self.step_mode == "fused":
            runners = list(self.train_step.runners.values())
        elif self.step_mode == "scan":
            runners = [*self.scan_gd.runners.values(),
                       *self.scan_g.runners.values()]
        else:
            runners = []
        return [st for r in runners for st in r.stats()]

    def revive(self, images: torch.Tensor, step: int) -> int:
        """Re-anchor the codes unused since the last revival to random
        pre-quant features of `images` (NHWC; on a mesh this rank's rows,
        and the draw is over every rank's) and zero their Adam moments."""
        codebook = self.vqvae.quantizer.embedding.weight
        with torch.no_grad(), global_batch(self.mesh):
            z = self.vqvae.encode_pre_quant(images.permute(0, 3, 1, 2))
            new, n, dead = revive_dead_codes(
                codebook, self._usage_accum, z.permute(0, 2, 3, 1),
                self._revive_gen, self.config.revive_usage_threshold)
            codebook.copy_(new)
        reset_codebook_moments(self.opt_g, codebook, dead)
        self._usage_accum.zero_()
        n = int(n)
        if self.main:
            print(f"  [revive] step {step}: re-anchored {n} dead codes")
        return n

    def train(self, num_steps: Optional[int] = None, log_every: int = 50,
              timing_warmup: int = 5) -> dict:
        """Train up to step `num_steps` (default cfg.train_steps). Returns
        {"losses": every step's loss_total, "timed_steps", "timed_seconds",
        "images_per_s", "loader"}: host seconds of the steps after the first
        `timing_warmup`, the device synchronised at both ends, grids and
        checkpoint saves (and the graph captures) excluded; the loader's
        `loader_kind`."""
        if self.step_mode == "scan":
            return self._train_scan(num_steps, log_every, timing_warmup)
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

        batches = self._prefetched()
        images_np = None
        timed_from = None
        timed_seconds = captures = 0.0
        t_log, n_log = time.perf_counter(), 0
        try:
            for step in range(start, num_steps):
                if step - start == timing_warmup:
                    self._sync()
                    timed_from = time.perf_counter()
                    captures = capture_seconds(self.graph_stats())
                (images_np, _), images = next(batches)
                log = self.dispatch_step(images, step)
                if self._revive_every:
                    if self.step_mode == "split":
                        self._usage_accum += log["usage_counts"]
                    if (step + 1) % self._revive_every == 0:
                        self.revive(images, step + 1)
                drain()  # the previous step's loss; this step stays queued
                pending = (step + 1, log["loss_total"])
                n_log += 1

                if log_every and (step + 1) % log_every == 0:
                    host = {k: float(v) for k, v in log.items()
                            if v.ndim == 0}  # usage_counts is [K]
                    self._log(step + 1, num_steps, host, n_log * cfg.batch_size
                              / (time.perf_counter() - t_log))
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
            timed_seconds -= capture_seconds(self.graph_stats()) - captures
        timed_steps = max(num_steps - start - timing_warmup, 0)
        if num_steps > start and (not every or num_steps % every):
            self.save_and_sample(num_steps // every + 1 if every else 1,
                                 images_np)
        return {"losses": losses, "timed_steps": timed_steps,
                "timed_seconds": timed_seconds,
                "images_per_s": (timed_steps * cfg.batch_size / timed_seconds
                                 if timed_seconds else None),
                "loader": self.loader_kind}

    def _train_scan(self, num_steps: Optional[int], log_every: int,
                    timing_warmup: int) -> dict:
        """The scan-mode loop (`scan_loop.run_scan_loop`, with the
        revival cadence as an event); returns what `train` returns."""
        cfg = self.config
        num_steps = num_steps or cfg.train_steps
        if self.loader is None:
            raise RuntimeError("no dataset configured: pass split_path")
        last = [None]  # the last host batch, for grids

        def dispatch(step, drawn):  # drawn: ((images, labels), device)
            last[0] = drawn[-1][0][0]
            superbatch = torch.stack([d[1] for d in drawn])
            logs = self.dispatch_block(superbatch, step)
            end = step + len(drawn)
            if self._revive_every and end % self._revive_every == 0:
                self.revive(superbatch[-1], end)
            return logs, logs["loss_total"]

        def log(step, logs, steps_per_s):
            host = {k: float(v[-1]) for k, v in logs.items()
                    if v.ndim == 1}  # usage_counts is [n, K]
            self._log(step, num_steps, host, steps_per_s * cfg.batch_size)

        out = run_scan_loop(
            start=self.state.step, num_steps=num_steps,
            scan_block=self.scan_block, batches=self._prefetched(),
            dispatch=dispatch, log_every=log_every, log=log,
            save_every=cfg.save_and_sample_every,
            save=lambda m: self.save_and_sample(m, last[0]),
            watchdog=self.watchdog, sync=self._sync,
            graph_stats=self.graph_stats, timing_warmup=timing_warmup,
            cadences=(self._revive_every,))
        seconds = out["timed_seconds"]
        return {**out, "images_per_s": (
            out["timed_steps"] * cfg.batch_size / seconds
            if seconds else None), "loader": self.loader_kind}

    def _log(self, step: int, num_steps: int, host: dict, ips: float):
        if not self.main:
            return
        self.metrics.log(step, {**host, "images_per_sec": ips})
        print(f"step {step}/{num_steps} g={host['total_loss']:.4f} "
              f"d={host.get('d_loss', 0.0):.4f} vq={host['vq_loss']:.4f} "
              f"usage={host['codebook_usage_ratio']:.2f} ({ips:.1f} img/s)")

    # ------------------------------------------------------------------

    def reconstruct(self, images: np.ndarray) -> np.ndarray:
        """NHWC images in [0, 1] -> their NHWC reconstructions."""
        with torch.inference_mode():
            recon, _, _ = self.vqvae(
                self._to_device(images).permute(0, 3, 1, 2))
        return recon.permute(0, 2, 3, 1).float().cpu().numpy()

    def save_and_sample(self, milestone: int, images=None):
        """The reconstruction grid of `images` (the host batch) and
        milestone `milestone`; on a mesh rank 0 writes both and the others
        wait for it."""
        if self.main:
            if images is not None:
                n = min(self.config.num_samples, len(images))
                self._save_grid(images[:n], self.reconstruct(images[:n]),
                                milestone)
            self.ckpt.save(milestone, self.state.state_dict(),
                           config=dataclasses.asdict(self.config))
        if self.mesh is not None:
            barrier()

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
        """Resume from `milestone` (the latest when None): a `.pt` file of
        the port, or a JAX package's Orbax milestone `vqgan-{m}/` (both
        optax states mapped onto this trainer's optimizers, whatever the
        step mode). Returns the step. On a mesh every rank reads the same
        checkpoint."""
        self.state.load_state_dict(self.ckpt.restore(milestone,
                                                     state=self.state))
        return self.state.step
