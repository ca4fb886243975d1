"""Stage-2 latent-diffusion trainer.

Counterpart of vqgan_tpu/training/ldm_trainer.py with its two step modes:
the denoiser (the CFG U-Net, or the DiT with model_type "dit") and
GaussianDiffusion from an LDMConfig, optionally with gradient checkpointing
(the whole denoiser forward recomputed in the backward pass, as the JAX
package's Diffusers-style trainer rebuilds its step), `LatentDataset` over
the cached latents, Adam(W) with clipping and warmup, an EMA copy, the
loss-health watchdog, `sample-{m}.png` grids and milestone + latest
checkpoints every `save_and_sample_every` steps, and `load(milestone)` to
resume.

`step_mode` "step" runs one eager step per loader batch. "scan" runs
`scan_block` steps per dispatch (`make_ldm_scan_step`), on the card as
one step's CUDA graph replayed per step, over a `CapturableOptimizer`.
Its loop (`scan_loop.run_scan_loop`) keeps the
JAX package's event rule: full blocks run where the next event (a log, a
save with its grid, the end) is at least a block away, and the steps that
lead up to an event run one at a time. Its watchdog reads each dispatch's
stacked losses one dispatch late; a non-finite loss drains the dispatch
just queued at once. Its checkpoints are those of the step mode, so a run
resumes in either mode.

- The watchdog reads each step's loss one step late, after the next step
  is queued, so the loop never waits for the device to drain.
- A save first drains that pending loss, and a cadence of 0 turns its event
  off (the two faults ADVICE.md records in the JAX package's scan loop).
- A run that ends off the save cadence still leaves a loadable checkpoint.
- Errors propagate: a failed sample or save stops the run.

The batches come from the C++ latent batch reader
(`LatentDataset.native_batch_loader`) when the cache holds every item as
`.npy`, and from the Python BatchLoader otherwise, as in the JAX trainer;
`train` names the one taken under "loader" ("native_latents" or
"python"). Both modes draw through `device_prefetch` (depth 2): the copy
of batch n + 2 from pinned memory is enqueued while step n runs.

`param_sharding` places the state on a mesh, as the JAX trainer does:
"replicated" (data parallel: the mean gradient over the global batch),
"zero1", "fsdp", "tp" or "fsdp_tp" (parallel/fsdp.py). Under a process
group (torchrun) the mesh spans every rank, with a "model" axis of 2 for
the TP modes where the world size is even, and each rank reads its rows of
the global batch (`mesh.local_rows`); rank 0 logs, samples and writes the
checkpoints, which hold whole tensors. With no process group, "replicated"
is the single-device trainer and the other modes place the state on a
mesh of one. Step mode "scan" runs on a mesh in every mode
(`sharded_step.make_sharded_ldm_scan_step`): on the card each step's
graph holds its NCCL collectives, ZeRO-1's gathers of the updated pieces
included. Every rank reads the same losses, so every rank takes the same
branch of the scan loop's one-dispatch-late read.
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
from ..data.native_loader import load_native_lib
from ..data.prefetch import device_prefetch, to_device
from ..device import resolve_device
from ..parallel.fsdp import _DEFAULT_MIN_SIZE, MODES, place_state
from ..parallel.init import barrier, process_count
from ..parallel.mesh import (
    is_main_process,
    local_rows,
    make_mesh_for_batch,
    named_mesh,
)
from ..utils.metrics_log import MetricsLogger
from .ldm_step import (
    LDMTrainState,
    make_ldm_optimizer,
    make_ldm_scan_step,
    make_ldm_train_step,
)
from .scan_loop import resolve_step_mode as _resolve_step_mode
from .scan_loop import run_scan_loop
from .sharded_step import (
    make_sharded_ldm_scan_step,
    make_sharded_ldm_train_step,
)
from .watchdog import TrainingWatchdog, check_sample_range

__all__ = ["LatentDiffusionTrainer", "STEP_MODES", "resolve_step_mode"]

STEP_MODES = ("step", "scan")


def resolve_step_mode(mode: str, train_num_steps: int) -> str:
    """"auto" gives "scan" from 1000 steps and "step" below, as the JAX
    CLI resolves it; any other mode is itself."""
    return _resolve_step_mode(mode, train_num_steps, eager="step")


class LatentDiffusionTrainer:
    def __init__(self, config: LDMConfig, split_path: Optional[str] = None,
                 vae=None, device="cuda",
                 gradient_checkpointing: bool = False,
                 step_mode: str = "step", scan_block: int = 8,
                 param_sharding: str = "replicated",
                 fsdp_min_size: Optional[int] = None, graph: bool = True):
        """`vae`: the port's KLVAE on `device`, for sample grids and for
        encoding latents missing from the cache; None trains from a full
        cache and saves checkpoints without grids. `gradient_checkpointing`
        trades a second denoiser forward per step for the activations it
        would keep. `step_mode` and `scan_block`, `param_sharding` and
        `fsdp_min_size` (the FSDP rule's size cutoff, 2^14 elements by
        default): see the module docstring. `graph` False runs the scan
        mode's steps eagerly on the card as well: the reference a captured
        run is held against."""
        if step_mode not in STEP_MODES:
            raise ValueError(f"step_mode must be one of {STEP_MODES}, got "
                             f"{step_mode!r}")
        assert param_sharding in MODES, param_sharding
        self.param_sharding = param_sharding
        self.mesh = None
        if torch.distributed.is_initialized():
            world = process_count()
            self.mesh = make_mesh_for_batch(
                config.train_batch_size,
                model=2 if "tp" in param_sharding and world % 2 == 0 else 1,
                device=resolve_device(device))
        elif param_sharding != "replicated":
            self.mesh = named_mesh({"data": 1, "model": 1},
                                   resolve_device(device))
        self.main = is_main_process()
        self.step_mode = step_mode
        self.scan_block = max(1, int(scan_block))
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
            gradient_accumulate_every=cfg.gradient_accumulate_every,
            capturable=step_mode == "scan")
        step_kwargs = dict(
            cond_drop_prob=cfg.cond_drop_prob,
            contrastive_weight=(cfg.contrastive_weight
                                if cfg.use_contrastive_loss else 0.0),
            contrastive_start_step=cfg.contrastive_start_step,
            contrastive_temperature=cfg.contrastive_temperature,
            ema_decay=cfg.ema_decay, ema_update_every=cfg.ema_update_every)
        self.state = LDMTrainState(0, self.model, self.ema_model,
                                   self.optimizer)
        self.placed = None
        if self.mesh is not None:
            self.placed = place_state(self.state, self.mesh, param_sharding,
                                      fsdp_min_size or _DEFAULT_MIN_SIZE)
            self.optimizer = self.state.optimizer
            if step_mode == "scan":
                self.scan_step = make_sharded_ldm_scan_step(
                    self.diffusion, self.placed, graph=graph, **step_kwargs)
            else:
                self.train_step = make_sharded_ldm_train_step(
                    self.diffusion, self.placed, **step_kwargs)
        elif step_mode == "scan":
            self.scan_step = make_ldm_scan_step(
                self.diffusion, self.optimizer, graph=graph, **step_kwargs)
        else:
            self.train_step = make_ldm_train_step(
                self.diffusion, self.optimizer, **step_kwargs)

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
        self.metrics = (MetricsLogger(cfg.results_folder, run_name="ldm")
                        if self.main else None)

    def _encode(self, images: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            z = self.vae.encode_images_mean(
                torch.from_numpy(images).to(self.device))
        return z.float().cpu().numpy()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _make_batch_iter(self):
        """(the host batch iterator, its loader kind): the native latent
        batch reader over a fully populated cache, else the BatchLoader."""
        cfg = self.config
        ds = self.loader.dataset
        if ds.fully_cached() and load_native_lib() is not None:
            print("using native latent batch loader")
            return ds.native_batch_loader(
                cfg.train_batch_size, shuffle=True, seed=cfg.seed,
                repeat=True), "native_latents"
        return iter(self.loader), "python"

    def _prefetched(self):
        """(((latents, labels), (device latents, device labels)) pairs,
        each copy enqueued two batches ahead; the loader kind)."""
        it, kind = self._make_batch_iter()
        rows = ((lambda x: local_rows(x, self.mesh)) if self.mesh is not None
                else (lambda x: x))
        return device_prefetch(it, lambda b: (
            to_device(rows(b[0]), self.device),
            to_device(rows(b[1]), self.device, torch.long)), depth=2), kind

    # ------------------------------------------------------------------

    def train(self, num_steps: Optional[int] = None, log_every: int = 50,
              timing_warmup: int = 5) -> dict:
        """Train up to step `num_steps` (default cfg.train_num_steps).
        Returns {"losses": every step's loss, "timed_steps", "timed_seconds",
        "latents_per_s", "loader"}: host seconds of the steps after the
        first `timing_warmup`, the device synchronised at both ends,
        checkpoint saves (and in scan mode the graph captures) excluded;
        the loader's kind. In step mode on the card also "resident_bytes"
        and "peak_bytes": for each step the bytes allocated on the device
        as it starts and the most allocated while it runs (the caching
        allocator's counts, kept on the host: nothing waits for them)."""
        if self.step_mode == "scan":
            return self._train_scan(num_steps, log_every, timing_warmup)
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

        batches, kind = self._prefetched()
        timed_from = None
        timed_seconds = 0.0
        t_log, n_log = time.perf_counter(), 0
        on_card = self.device.type == "cuda"
        resident, peak = [], []
        try:
            for step in range(start, num_steps):
                if step - start == timing_warmup:
                    self._sync()
                    timed_from = time.perf_counter()
                _, (latents, labels) = next(batches)
                if on_card:
                    resident.append(torch.cuda.memory_allocated(self.device))
                    torch.cuda.reset_peak_memory_stats(self.device)
                log = self.train_step(self.state, latents, labels,
                                      generator=self.generator)
                if on_card:
                    peak.append(torch.cuda.max_memory_allocated(self.device))
                drain()  # the previous step's loss; this step stays queued
                pending = (step + 1, log["loss"])
                n_log += 1

                if log_every and (step + 1) % log_every == 0:
                    host = {k: float(v) for k, v in log.items()}
                    ips = n_log * cfg.train_batch_size / (
                        time.perf_counter() - t_log)
                    if self.main:
                        self.metrics.log(step + 1, host)
                        msg = (f"step {step + 1}/{num_steps} "
                               f"loss={host['loss']:.4f}")
                        if "contrastive_loss" in host:
                            msg += (f" contrastive="
                                    f"{host['contrastive_loss']:.4f}")
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
        out = {"losses": losses, "timed_steps": timed_steps,
               "timed_seconds": timed_seconds,
               "latents_per_s": (timed_steps * cfg.train_batch_size
                                 / timed_seconds if timed_seconds else None),
               "loader": kind}
        if on_card:
            out.update(resident_bytes=resident, peak_bytes=peak)
        return out

    def dispatch_block(self, latents, labels) -> dict:
        """Run len(latents) steps as one dispatch (step_mode "scan") on
        device batches latents [K, B, H, W, C] and labels [K, B] (long);
        returns the logs stacked on a leading [K] axis, on the device."""
        return self.scan_step(self.state, latents, labels,
                              generator=self.generator)

    def graph_stats(self) -> list:
        """Each captured graph's name, capture seconds, pool bytes, replays
        and kernel launches per replay (scan mode on the card)."""
        if self.step_mode != "scan":
            return []
        return [st for r in self.scan_step.runners.values()
                for st in r.stats()]

    def _train_scan(self, num_steps: Optional[int], log_every: int,
                    timing_warmup: int) -> dict:
        """The scan-mode loop (`scan_loop.run_scan_loop`); returns what
        `train` returns."""
        cfg = self.config
        num_steps = num_steps or cfg.train_num_steps
        if self.loader is None:
            raise RuntimeError("no dataset configured: pass split_path")

        def dispatch(step, drawn):  # drawn: (host, (latents, labels))
            logs = self.dispatch_block(torch.stack([d[1][0] for d in drawn]),
                                       torch.stack([d[1][1] for d in drawn]))
            return logs, logs["loss"]

        def log(step, logs, steps_per_s):
            host = {k: float(v[-1]) for k, v in logs.items()}
            if not self.main:
                return
            self.metrics.log(step, host)
            msg = f"step {step}/{num_steps} loss={host['loss']:.4f}"
            if "contrastive_loss" in host:
                msg += f" contrastive={host['contrastive_loss']:.4f}"
            print(msg + f" ({steps_per_s * cfg.train_batch_size:.1f} "
                  f"latents/s)")

        batches, kind = self._prefetched()
        out = run_scan_loop(
            start=self.state.step, num_steps=num_steps,
            scan_block=self.scan_block, batches=batches,
            dispatch=dispatch, log_every=log_every, log=log,
            save_every=cfg.save_and_sample_every, save=self.save_and_sample,
            watchdog=self.watchdog, sync=self._sync,
            graph_stats=self.graph_stats, timing_warmup=timing_warmup)
        seconds = out["timed_seconds"]
        return {**out, "latents_per_s": (
            out["timed_steps"] * cfg.train_batch_size / seconds
            if seconds else None), "loader": kind}

    # ------------------------------------------------------------------

    def sample(self, num_samples: Optional[int] = None,
               use_ema: Optional[bool] = None,
               generator: Optional[torch.Generator] = None):
        """(NHWC latents, classes) of `num_samples` (cfg.num_samples) DDIM
        samples, classes cycling over the users. On a mesh every rank
        calls it: the split parameters are gathered for it."""
        if self.placed is None:
            return self._sample(num_samples, use_ema, generator)
        self.placed.materialize("model")
        self.placed.materialize("ema")
        try:
            return self._sample(num_samples, use_ema, generator)
        finally:
            self.placed.reshard()

    def _sample(self, num_samples, use_ema, generator):
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
        """Sample a grid (with a VAE) and write milestone `milestone`. On a
        mesh every rank gathers the whole state and rank 0 samples and
        writes."""
        if self.placed is not None:
            self.placed.materialize("model")
            self.placed.materialize("ema")
            state = self.placed.state_dict()
        else:
            state = self.state.state_dict()
        if self.vae is not None and self.main:
            latents, _ = self._sample(None, None, None)
            with torch.inference_mode():
                images = self.vae.decode_latents(latents).float().cpu().numpy()
            warn = check_sample_range(images)
            if warn:
                print(f"  [watchdog] {warn}")
            self._save_grid(images, milestone)
        if self.main:
            self.ckpt.save(milestone, state,
                           config=dataclasses.asdict(self.config))
        if self.placed is not None:
            self.placed.reshard()
            barrier()

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
        """Resume from `milestone` (the latest when None): a `.pt` file of
        the port, or a JAX package's Orbax milestone `model-{m}/` (its
        optax state mapped onto this trainer's optimizer, whatever the
        step mode). Returns the step. On a mesh each rank reads the whole
        state and keeps its pieces."""
        full = self.ckpt.restore(milestone, state=self.placed or self.state)
        if self.placed is not None:
            self.placed.load_state_dict(full)
        else:
            self.state.load_state_dict(full)
        return self.state.step
