"""Stage-2 latent-diffusion training.

    python -m vqgan_tpu_torch.train_latent_cfg --split data_split.json \\
        --data_path data/Normal_line --latents_cache_folder latents_cache \\
        --vae_path kl_vae_best.pt --results_folder results
    python -m vqgan_tpu_torch.train_latent_cfg ... --resume -1  # latest

Counterpart of cli/train_latent_cfg.py: LDMConfig (or, with `--baseline`,
the all-optimizations-off BaselineLDMConfig) with the flags' overrides, and
a JSON of further LDMConfig fields with `--config`; the CFG U-Net (or,
with `--model_type dit`, the DiT) trained on the cached latents, with
resume. `--vae_path` is a KL-VAE state dict (`.pt`) or an Orbax
directory of the JAX package (`kl_vae-{m}/`); with it, latents missing
from the cache are encoded and every checkpoint comes with a sample grid.
`--step_mode scan` runs `--scan_block` steps per dispatch, on the card as
CUDA graphs (the JAX package's one-program scan); `auto` (the default)
picks it for runs of 1000 steps or more, as the JAX CLI does, and the
eager `step` mode otherwise.
`--resume` takes the port's `model-{m}.pt` milestones and the JAX
package's Orbax milestones `model-{m}/` alike: the JAX train state (step,
weights, EMA, optax's Adam moments and counts, a MultiSteps accumulator)
is mapped onto this trainer's optimizer in any step and sharding mode,
and the step printed is the JAX step; the noise stream is the port's own.

`--param_sharding` is the JAX CLI's flag with its choices: "replicated"
(data parallel), "zero1", "fsdp", "tp" or "fsdp_tp" (parallel/fsdp.py).
Under torchrun each process takes one GPU and joins an NCCL group (gloo
with `--device cpu`), the mesh spans the ranks, and each rank trains on
its rows of the global batch:

    torchrun --nproc_per_node 4 -m vqgan_tpu_torch.train_latent_cfg \
        --param_sharding fsdp --step_mode scan ...

With one process the modes place the state on a mesh of one. The captured
`scan` mode runs on the mesh in every mode, its graphs holding the NCCL
collectives; where ranks share a card over gloo, whose collectives cannot
be captured, `auto` picks `step`.

Runs on the GPU by default (`--device cpu` to run on the CPU), with TF32
off for fp32 matmuls and convolutions.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from .configs.ldm_config import BaselineLDMConfig, LDMConfig
from .device import resolve_device, set_full_fp32_precision
from .parallel.init import initialize_distributed, process_count

__all__ = ["main", "parse_args"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vae_path", default=None,
                    help="KL-VAE state dict (.pt) or Orbax "
                         "checkpoint directory")
    ap.add_argument("--data_path", default=None)
    ap.add_argument("--split", default=None, help="data split JSON")
    ap.add_argument("--results_folder", default=None)
    ap.add_argument("--latents_cache_folder", default=None)
    ap.add_argument("--train_num_steps", type=int, default=None)
    ap.add_argument("--train_batch_size", type=int, default=None)
    ap.add_argument("--resume", type=int, default=None,
                    help="milestone to resume from (a .pt file of the port "
                         "or an Orbax directory of the JAX package); -1 "
                         "for the latest")
    ap.add_argument("--model_type", choices=("unet", "dit"), default=None,
                    help="denoiser backbone: the CFG U-Net (default) or the "
                         "DiT transformer (models/dit.py)")
    ap.add_argument("--baseline", action="store_true",
                    help="ablation baseline config (all optimizations off)")
    ap.add_argument("--config", default=None,
                    help="JSON of further LDMConfig fields")
    ap.add_argument("--step_mode", default="auto",
                    choices=("auto", "step", "scan"),
                    help="'step': one eager step per batch; 'scan': "
                         "scan_block steps per dispatch, as CUDA graphs on "
                         "the card; 'auto': scan from 1000 steps on")
    ap.add_argument("--scan_block", type=int, default=8)
    ap.add_argument("--param_sharding", default="replicated",
                    choices=["replicated", "zero1", "fsdp", "tp", "fsdp_tp"],
                    help="parameter layout over the device mesh: replicated"
                         " (reference-style DP), zero1 (Adam moments and "
                         "EMA over 'data'), fsdp (ZeRO-3 over 'data'), tp "
                         "(attention kernels over 'model'), fsdp_tp (2D)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train. Returns the trainer's `train` result (every step's loss, and
    latents/s after the warm-up) with the trainer under "trainer"."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    initialize_distributed(device)  # a no-op outside torchrun
    set_full_fp32_precision()
    cls = BaselineLDMConfig if args.baseline else LDMConfig
    raw = json.loads(Path(args.config).read_text()) if args.config else {}
    raw.update({k: v for k, v in vars(args).items()
                if v is not None and k in cls.__dataclass_fields__})
    config = cls.from_dict(raw)
    config.print_config_summary()
    if args.baseline:
        config.print_ablation_table()

    vae = None
    if args.vae_path:
        from .generate import load_vae

        vae = load_vae(args.vae_path, config.latent_channels,
                       config.image_size, device=device)

    from .training.ldm_trainer import (
        LatentDiffusionTrainer,
        resolve_step_mode,
    )

    step_mode = resolve_step_mode(args.step_mode, config.train_num_steps)
    if (args.step_mode == "auto" and device.type == "cuda"
            and process_count() > 1
            and torch.distributed.get_backend() != "nccl"):
        step_mode = "step"  # gloo collectives cannot be captured
    if step_mode != args.step_mode:
        print(f"step_mode auto -> {step_mode} "
              f"({config.train_num_steps} steps)")
    trainer = LatentDiffusionTrainer(config, split_path=args.split, vae=vae,
                                     device=device, step_mode=step_mode,
                                     scan_block=args.scan_block,
                                     param_sharding=args.param_sharding)
    if args.resume is not None:
        step = trainer.load(None if args.resume < 0 else args.resume)
        print(f"resumed from step {step}")
    result = trainer.train(num_steps=args.train_num_steps)
    if result["latents_per_s"] is not None:
        print(f"{result['timed_steps']} steps after warm-up: "
              f"{result['latents_per_s']:.2f} latents/s")
    if result.get("resident_bytes"):
        print(f"device bytes of the last step: {result['resident_bytes'][-1]}"
              f" resident at its start, {result['peak_bytes'][-1]} at its "
              f"peak")
    return {**result, "trainer": trainer}


if __name__ == "__main__":
    main()
