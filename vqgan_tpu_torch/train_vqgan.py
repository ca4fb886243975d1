"""Stage-1 VQ-GAN training.

    python -m vqgan_tpu_torch.train_vqgan --split data_split.json \\
        --data_path data/Normal_line --results_folder results/vqgan
    python -m vqgan_tpu_torch.train_vqgan ... --resume -1  # latest

Counterpart of cli/train_vqgan.py: VQGANConfig with the flags' overrides,
and a JSON of further VQGANConfig fields with `--config`; the VQ-VAE,
PatchGAN and LPIPS losses trained on the split's images, with resume,
reconstruction grids and `vqgan-{m}.pt` checkpoints. `--lpips_weights` is
the JAX CLI's `.npz` of exported weights: torchvision VGG16 tensors under
`vgg.` (`vgg.features.0.weight`, ...) and lpips ones under `lin.`
(`lin.lin0.model.1.weight`, ...). `--step_mode` is the JAX CLI's:
`split` (eager G and D steps), `fused` (one G+D step, a CUDA graph on the
card) or `scan` (`--scan_block` steps per dispatch, CUDA graphs on the
card); `auto` (the default) gives `scan` from 1000 steps and `split`
below. The JAX CLI's `--fast_compile` tunes XLA and has no counterpart.
`--resume` takes the port's `vqgan-{m}.pt` and the JAX package's Orbax
`vqgan-{m}/` alike (both optax states mapped onto the port's optimizers,
the discriminator's BatchNorm statistics with it), printing the step.

Under torchrun each process takes one GPU and joins an NCCL group (gloo
with `--device cpu`), and the trainer is data parallel over the ranks, as
the JAX CLI's mesh over its chips; every step mode runs there:

    torchrun --nproc_per_node 4 -m vqgan_tpu_torch.train_vqgan \
        --step_mode scan ...

Runs on the GPU by default (`--device cpu` to run on the CPU), with TF32
off for fp32 matmuls and convolutions.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .configs.vqgan_config import VQGANConfig
from .device import resolve_device, set_full_fp32_precision
from .parallel.init import initialize_distributed

__all__ = ["main", "parse_args", "read_lpips_npz"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data_path", default=None)
    ap.add_argument("--split", default=None, help="data split JSON")
    ap.add_argument("--results_folder", default=None)
    ap.add_argument("--train_steps", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--image_size", type=int, default=None)
    ap.add_argument("--num_embeddings", type=int, default=None)
    ap.add_argument("--disc_start", type=int, default=None)
    ap.add_argument("--save_every", type=int, default=None,
                    dest="save_and_sample_every",
                    help="checkpoint + reconstruction-grid cadence in steps")
    ap.add_argument("--resume", type=int, default=None,
                    help="milestone to resume from (a .pt file of the port "
                         "or an Orbax directory of the JAX package); -1 "
                         "for the latest")
    ap.add_argument("--revive_dead_codes_every", type=int, default=None,
                    help="re-anchor codes unused for this many steps to "
                         "random encoder outputs (0 or unset: off)")
    ap.add_argument("--revive_usage_threshold", type=int, default=None)
    ap.add_argument("--lpips_weights", default=None,
                    help=".npz of exported VGG16 + lpips weights")
    ap.add_argument("--config", default=None,
                    help="JSON of further VQGANConfig fields")
    ap.add_argument("--step_mode", default="auto",
                    choices=("auto", "split", "fused", "scan"),
                    help="'split': eager G and D steps; 'fused': one G+D "
                         "step per batch; 'scan': scan_block steps per "
                         "dispatch (both CUDA graphs on the card); 'auto': "
                         "scan from 1000 steps on, else split")
    ap.add_argument("--scan_block", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def read_lpips_npz(path) -> dict:
    """{"vgg": {...}, "lin": {...}} from the `vgg.` / `lin.` keys of an
    `.npz`, for `VQGANTrainer(lpips_weights=...)`."""
    import numpy as np

    with np.load(path) as data:
        return {part: {k[len(part) + 1:]: data[k] for k in data.files
                       if k.startswith(part + ".")}
                for part in ("vgg", "lin")}


def main(argv=None) -> dict:
    """Train. Returns the trainer's `train` result (every step's loss, and
    images/s after the warm-up) with the trainer under "trainer"."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    initialize_distributed(device)  # a no-op outside torchrun
    set_full_fp32_precision()
    raw = json.loads(Path(args.config).read_text()) if args.config else {}
    raw.update({k: v for k, v in vars(args).items()
                if v is not None and k in VQGANConfig.__dataclass_fields__})
    config = VQGANConfig.from_dict(raw)
    config.print_config_summary()
    lpips_weights = (read_lpips_npz(args.lpips_weights)
                     if args.lpips_weights else None)

    from .training.vqgan_trainer import VQGANTrainer, resolve_step_mode

    step_mode = resolve_step_mode(args.step_mode, config.train_steps)
    if step_mode != args.step_mode:
        print(f"step_mode auto -> {step_mode} ({config.train_steps} steps)")
    trainer = VQGANTrainer(config, split_path=args.split,
                           lpips_weights=lpips_weights, device=device,
                           step_mode=step_mode, scan_block=args.scan_block)
    if args.resume is not None:
        step = trainer.load(None if args.resume < 0 else args.resume)
        print(f"resumed from step {step}")
    result = trainer.train(num_steps=args.train_steps)
    if result["images_per_s"] is not None:
        print(f"{result['timed_steps']} steps after warm-up: "
              f"{result['images_per_s']:.2f} images/s")
    return {**result, "trainer": trainer}


if __name__ == "__main__":
    main()
