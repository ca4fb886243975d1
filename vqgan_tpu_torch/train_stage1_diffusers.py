"""Stage-2 latent-diffusion training with the Diffusers-path feature set.

    python -m vqgan_tpu_torch.train_stage1_diffusers --split data_split.json \\
        --latents_cache_folder latents_cache --output_dir results_stage1 \\
        --pretrained_vae_path kl_vae_best.pt --gradient_checkpointing
    python -m vqgan_tpu_torch.train_stage1_diffusers ... \\
        --resume_from_checkpoint latest

Counterpart of cli/train_stage1_diffusers.py, with its arguments and
defaults: despite the name, a second trainer of the stage-2 CFG U-Net on
cached latents (batch 24, lr 1e-4 with 500 warm-up steps, bf16, EMA 0.9999,
Min-SNR gamma 5, pred_v, cosine betas, DDIM-100 sample grids, milestones
every 500 steps, resume from "latest" or a milestone). The csv
`--dim_mults` / `--attention_head_dim` are validated with the JAX CLI's
error cases, and the arguments map to the same LDMConfig.
`--gradient_checkpointing` recomputes the U-Net forward in the backward
pass. `--pretrained_vae_path` is a KL-VAE state dict (`.pt`) or an Orbax
directory of the JAX package, read as
`train_latent_cfg --vae_path` reads one: with it, every milestone writes a
sample grid, and latents missing from the cache are encoded.
`--resume_from_checkpoint` resumes a milestone of the port or of the JAX
package (an Orbax `model-{m}/`, its optax state mapped onto the port's
optimizer), printing the step it resumes at.

Runs on the GPU by default (`--device cpu` to run on the CPU), with TF32
off for fp32 matmuls and convolutions.
"""

from __future__ import annotations

import argparse

from .configs.ldm_config import LDMConfig
from .device import resolve_device, set_full_fp32_precision

__all__ = ["build_config", "main", "parse_args"]


def parse_args(argv=None):
    """The JAX CLI's arguments (and `--device`), validated; adds
    `dim_mults_tuple` and `head_dim`."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pretrained_vae_path", required=False, default=None)
    ap.add_argument("--data_dir", default=None)
    ap.add_argument("--split", default=None)
    ap.add_argument("--output_dir", default="./results_stage1")
    ap.add_argument("--latents_cache_folder", default="./latents_cache")
    ap.add_argument("--num_classes", type=int, default=31)
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--train_batch_size", type=int, default=24)
    ap.add_argument("--max_train_steps", type=int, default=5000)
    ap.add_argument("--learning_rate", type=float, default=1e-4)
    ap.add_argument("--lr_warmup_steps", type=int, default=500)
    ap.add_argument("--gradient_accumulation_steps", type=int, default=1)
    ap.add_argument("--gradient_checkpointing", action="store_true")
    ap.add_argument("--mixed_precision", choices=["no", "bf16"],
                    default="bf16")
    ap.add_argument("--use_ema", action=argparse.BooleanOptionalAction,
                    default=True, help="--no-use_ema disables EMA")
    ap.add_argument("--ema_decay", type=float, default=0.9999)
    ap.add_argument("--snr_gamma", type=float, default=5.0)
    ap.add_argument("--prediction_type", default="v_prediction",
                    choices=["v_prediction", "epsilon"])
    ap.add_argument("--num_inference_steps", type=int, default=100)
    ap.add_argument("--checkpointing_steps", type=int, default=500)
    ap.add_argument("--resume_from_checkpoint", default=None,
                    help="'latest' or a milestone number (a .pt file "
                         "of the port or an Orbax directory of the JAX "
                         "package)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--dim_mults", default="1,2,4,4",
                    help="csv per-level width multipliers")
    ap.add_argument("--attention_head_dim", default="64",
                    help="attention head dim; csv per level accepted, "
                         "uniform values required")
    ap.add_argument("--model_dim", type=int, default=96)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # the JAX CLI's validation and messages: per-level lengths agree, level
    # channels divide by the head dim, head dims are a multiple of 8 (the
    # flash kernels' rule here)
    try:
        dim_mults = tuple(int(x) for x in str(args.dim_mults).split(","))
        head_dims = tuple(
            int(x) for x in str(args.attention_head_dim).split(","))
    except ValueError:
        ap.error("--dim_mults / --attention_head_dim must be csv integers")
    if len(head_dims) not in (1, len(dim_mults)):
        ap.error(
            f"attention_head_dim length ({len(head_dims)}) must be 1 or "
            f"equal dim_mults length ({len(dim_mults)})")
    if len(set(head_dims)) > 1:
        ap.error("per-level head dims must be uniform in this build "
                 f"(got {head_dims})")
    head_dim = head_dims[0]
    for i, m in enumerate(dim_mults):
        if (args.model_dim * m) % head_dim != 0:
            ap.error(f"Layer {i}: {args.model_dim * m} channels not "
                     f"divisible by head_dim={head_dim}")
    if head_dim % 8 != 0:
        ap.error(f"head_dim={head_dim} must be a multiple of 8 (the flash "
                 "kernels' rule; the reference enforces the same "
                 "multiple-of-8 rule for xformers)")
    args.dim_mults_tuple, args.head_dim = dim_mults, head_dim
    return args


def build_config(args) -> LDMConfig:
    """The LDMConfig that cli/train_stage1_diffusers.py builds from the
    same arguments."""
    return LDMConfig(
        data_path=args.data_dir or "",
        results_folder=args.output_dir,
        latents_cache_folder=args.latents_cache_folder,
        num_users=args.num_classes,
        image_size=args.resolution,
        latent_size=args.resolution // 8,
        dim=args.model_dim,
        dim_mults=args.dim_mults_tuple,
        attn_dim_head=args.head_dim,
        train_batch_size=args.train_batch_size,
        train_num_steps=args.max_train_steps,
        train_lr=args.learning_rate,
        use_lr_warmup=args.lr_warmup_steps > 0,
        warmup_steps=args.lr_warmup_steps,
        gradient_accumulate_every=args.gradient_accumulation_steps,
        use_ema=args.use_ema,
        ema_decay=args.ema_decay,
        min_snr_loss_weight=args.snr_gamma > 0,
        min_snr_gamma=args.snr_gamma or 5.0,
        objective=("pred_v" if args.prediction_type == "v_prediction"
                   else "pred_noise"),
        beta_schedule="cosine",
        sampling_timesteps=args.num_inference_steps,
        save_and_sample_every=args.checkpointing_steps,
        compute_dtype=("bfloat16" if args.mixed_precision == "bf16"
                       else "float32"),
        seed=args.seed,
    )


def main(argv=None) -> dict:
    """Train. Returns the trainer's `train` result (every step's loss, and
    latents/s after the warm-up) with the trainer under "trainer"."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_full_fp32_precision()
    config = build_config(args)
    config.print_config_summary()
    if args.gradient_checkpointing:
        print("gradient checkpointing: ON (the U-Net forward recomputed in "
              "the backward pass)")

    vae = None
    if args.pretrained_vae_path:
        from .generate import load_vae

        vae = load_vae(args.pretrained_vae_path, config.latent_channels,
                       config.image_size, device=device)

    from .training.ldm_trainer import LatentDiffusionTrainer

    trainer = LatentDiffusionTrainer(
        config, split_path=args.split, vae=vae, device=device,
        gradient_checkpointing=args.gradient_checkpointing)
    if args.resume_from_checkpoint:
        milestone = (None if args.resume_from_checkpoint == "latest"
                     else int(args.resume_from_checkpoint))
        step = trainer.load(milestone)
        print(f"resumed from step {step}")
    result = trainer.train()
    if result["latents_per_s"] is not None:
        print(f"{result['timed_steps']} steps after warm-up: "
              f"{result['latents_per_s']:.2f} latents/s")
    return {**result, "trainer": trainer}


if __name__ == "__main__":
    main()
