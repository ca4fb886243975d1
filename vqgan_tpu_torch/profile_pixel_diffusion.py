"""Where the time of pixel-space diffusion goes on the GPU.

    python -m vqgan_tpu_torch.profile_pixel_diffusion [--steps 10] \
        [--self_condition] [--immiscible host|auction]

Builds `train_ddpm`'s defaults (the bf16 DDPM U-Net, dim 64, mults
1-2-4-8, at 128 px; Adam with clipping; the EMA past its warm-copy steps)
and `bench_edm`'s (the bf16 KarrasUnet, dim 64, at 64 px) with random
weights from `--seed`, on random images, then measures, after a warm-up,
with `profile_generate.profile_steps`:
- one DDPM training step at batch 16 (`Trainer.train_step`: the loss,
  backward, clipping, Adam, EMA);
- one DDIM step of the sample grid at batch 25 (the U-Net forward and the
  update);
- one Heun step of `bench_edm` at batch 16 (two KarrasUnet forwards and
  the update);
each as host wall ms (read first, with no profiler run yet in the
process), device kernel ms, the device's idle share, launches and the top
kernels, and each flash kernel's launches and device ms per step;
- whole sampler chains, eager (`graph=False`) and captured (one step's
  CUDA graph replayed per step), host wall ms in turns (eager, captured,
  captured, eager; one untimed call of each before), then one profiled
  call of each: `bench_edm`'s Heun-32 and DPM++(2M)-32 batches of 16, and
  an ancestral batch of 16 of the DDPM U-Net over a schedule cut to
  `ANCESTRAL_TIMESTEPS` (100) steps; with each graph's capture seconds
  and pool bytes.
Prints one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time

import numpy as np
import torch

from . import bench_edm, train_ddpm
from .core import diffusion_math as dm
from .device import resolve_device, set_full_fp32_precision
from .profile_generate import (
    KERNEL_FUNCTIONS,
    counting,
    profile_steps,
    profiled,
)
from .training.ddpm_trainer import Trainer

# the profiled ancestral chain's schedule, cut from the DDPM's 1000 steps
ANCESTRAL_TIMESTEPS = 100


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--self_condition", action="store_true")
    ap.add_argument("--immiscible", choices=("host", "auction"),
                    default=None)
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    set_full_fp32_precision()
    ddpm_args = train_ddpm.parse_args(
        ["--folder", "", *(["--self_condition"] if args.self_condition
                           else []),
         *(["--immiscible"] if args.immiscible else []),
         "--seed", str(args.seed)])
    model, diffusion = train_ddpm.build(ddpm_args, device)
    if args.immiscible:
        diffusion.immiscible_method = args.immiscible
    gen = torch.Generator(device).manual_seed(args.seed)
    size = ddpm_args.image_size
    images = torch.rand((ddpm_args.train_batch_size, size, size, 3),
                        generator=gen, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(diffusion, model, results_folder=tmp,
                          train_batch_size=ddpm_args.train_batch_size,
                          train_lr=ddpm_args.train_lr,
                          ema_decay=ddpm_args.ema_decay, seed=args.seed)
    trainer.state.step = 1000  # past the EMA's warm copies

    grid = torch.randn((ddpm_args.num_samples, 3, size, size),
                       generator=gen, device=device)
    t = torch.full((ddpm_args.num_samples,), 500, device=device)
    t_next = torch.full_like(t, 496)
    ema = trainer.ema_diffusion

    @torch.inference_mode()
    def ddim_step():
        pred_noise, x_start = ema.model_predictions(grid, t, None,
                                                    clip_x_start=True)
        return dm.ddim_step(ema.schedule, grid, x_start, pred_noise, t,
                            t_next, torch.zeros_like(grid), 0.0)

    edm_args = bench_edm.parse_args(["--seed", str(args.seed)])
    _, ed = bench_edm.build(edm_args, device)
    x_edm = torch.randn((edm_args.batch, 3, edm_args.image_size,
                         edm_args.image_size), generator=gen, device=device)
    sigma = torch.full((edm_args.batch,), 10.0, device=device)

    @torch.inference_mode()
    def heun_step():
        # the sampler's two forwards at sigma_hat and sigma_next, and the
        # update between them
        d = (x_edm - ed.preconditioned_forward(x_edm, sigma, clamp=True)) \
            / 10.0
        x_next = x_edm - 2.0 * d
        d2 = (x_next - ed.preconditioned_forward(x_next, sigma * 0.8,
                                                 clamp=True)) / 8.0
        return x_edm - 1.0 * (d + d2)

    cut = dataclasses.replace(ema, timesteps=ANCESTRAL_TIMESTEPS,
                              sampling_timesteps=None, schedule=None)
    b = edm_args.batch

    def chain(run):
        def fn(graph):
            g = torch.Generator(device).manual_seed(args.seed)
            return lambda: run(g, graph)
        return fn

    chains = {
        "edm_heun_chain": chain(lambda g, graph: ed.sample(
            b, generator=g, graph=graph)),
        "edm_dpmpp_chain": chain(lambda g, graph: ed.sample_using_dpmpp(
            b, generator=g, graph=graph)),
        f"ddpm_ancestral_t{ANCESTRAL_TIMESTEPS}_chain": chain(
            lambda g, graph: cut.sample(batch_size=b, generator=g,
                                        graph=graph)),
    }
    chain_walls = {}
    for label, make in chains.items():
        for graph in (None, False):  # the capture; the warm-up
            make(graph)()
        walls = chain_walls[label] = {"eager": [], "captured": []}
        for name in ("eager", "captured", "captured", "eager"):
            fn = make(None if name == "captured" else False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)

    steps, tallies = {}, {}
    for label, fn in (("ddpm_train_step_b16",
                       lambda: trainer.train_step(images)),
                      ("ddpm_ddim_step_b25", ddim_step),
                      ("edm_heun_step_b16", heun_step)):
        steps[label], tallies[label] = counting(fn)
        steps[label] = (steps[label], args.steps)
    out = {
        "device": torch.cuda.get_device_name(0),
        "self_condition": args.self_condition,
        "immiscible": args.immiscible,
        **profile_steps(steps, named=KERNEL_FUNCTIONS),
    }
    for label, tally in tallies.items():
        out[label]["flash_launches_per_step"] = {
            name: n / tally["calls"] for name, n in tally["launches"].items()}
    graphs = {"edm": ed._graphs, "ddpm": cut._graphs}
    for label, make in chains.items():
        for name, walls in chain_walls[label].items():
            fn, tally = counting(make(None if name == "captured" else False))
            out[f"{label}_{name}"] = {
                **profiled(fn, 1, sum(walls) / len(walls)),
                "wall_ms_turns": walls,
                "kernel_launches_per_chain": tally["launches"]}
    out["graphs"] = {k: g.stats() for k, g in graphs.items()}
    print(json.dumps(out, default=lambda v: float(np.asarray(v))))
    return out


if __name__ == "__main__":
    main()
