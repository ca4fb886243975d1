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
kernels, and each flash kernel's launches and device ms per step. Prints
one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch

from . import bench_edm, train_ddpm
from .core import diffusion_math as dm
from .device import resolve_device, set_full_fp32_precision
from .profile_generate import KERNEL_FUNCTIONS, counting, profile_steps
from .training.ddpm_trainer import Trainer


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
    print(json.dumps(out, default=lambda v: float(np.asarray(v))))
    return out


if __name__ == "__main__":
    main()
