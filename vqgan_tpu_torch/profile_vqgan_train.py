"""Where a stage-1 VQ-GAN training step's time goes on the GPU.

    python -m vqgan_tpu_torch.profile_vqgan_train [--batch_size 8] [--steps 5] \
        [--step_mode split|fused|scan]

Counterpart of cli/profile_training.py for the port. Builds the full-width
VQGANConfig models (VQ-VAE ch 128, mults 1-2-2-4, codebook 128 x 256;
PatchGAN ndf 64, 3 layers, BatchNorm; VGG16-LPIPS; bf16 compute, fp32
parameters) and their two Adam chains with random weights from `--seed`,
and a batch of random [B, 256, 256, 3] images. Then measures, with
`profile_generate.profile_steps` after a warm-up:
- one G step before `disc_start` (the discriminator read without a graph);
- one G step plus one D step from `disc_start` on;
each as host wall ms, device kernel ms, the device's idle share, launches
and the top kernels, plus the launches and device ms of each hand-written
kernel per step, and the peak of allocated device memory over one step
above what was allocated before it (`step_peak_bytes`: an eager step's
intermediates; a replay's live in its graph's pool, `graphs`' pool_bytes).
Both wall times are read first, G only then G + D, and
only then the profiled repeats of each: once torch.profiler has run in a
process, every later launch costs more host time. `--step_mode` is the
trainer's: in "fused" and "scan" each step is a CUDA graph (captured
before the measurement; the fused step runs the masked D update before
`disc_start` too), its launches counted through the replays. Prints one
JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import torch

from .configs.vqgan_config import VQGANConfig
from .device import resolve_device, set_full_fp32_precision
from .profile_generate import KERNEL_FUNCTIONS, counting, profile_steps
from .profile_train import peak_above_start
from .training.vqgan_trainer import VQGANTrainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--step_mode", choices=("split", "fused", "scan"),
                    default="split")
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    set_full_fp32_precision()
    with tempfile.TemporaryDirectory(prefix="profile_vqgan_") as work:
        cfg = VQGANConfig(batch_size=args.batch_size, seed=args.seed,
                          results_folder=work)
        trainer = VQGANTrainer(cfg, device=device, step_mode=args.step_mode)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        s = cfg.image_size
        images = torch.rand((args.batch_size, s, s, cfg.in_channels),
                            generator=gen, device=device)

        def step_at(step):
            def run():
                trainer.state.step = step
                trainer.dispatch_step(images, step)
            return run

        counted = {"g_step": counting(step_at(0)),
                   "g_and_d_step": counting(step_at(cfg.disc_start))}
        if args.step_mode != "split":
            for fn, _ in counted.values():
                fn()
                fn()  # the warm-up, then the capture
        out = {
            "device": torch.cuda.get_device_name(0),
            "batch_size": args.batch_size,
            "step_mode": args.step_mode,
            **profile_steps({label: (fn, args.steps)
                             for label, (fn, _) in counted.items()},
                            named=KERNEL_FUNCTIONS),
        }
        for label, (fn, tally) in counted.items():
            out[label]["kernel_launches_per_step"] = {
                name: n / tally["calls"]
                for name, n in tally["launches"].items()}
            out[label]["step_peak_bytes"] = peak_above_start(fn)
        out["graphs"] = trainer.graph_stats()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
