"""Generation: sample per-user images with the CFG latent-diffusion model.

    python -m vqgan_tpu_torch.generate --unet_weights model.pt \\
        --vae_weights kl_vae_best.pt --output_dir generated --all_users
    python -m vqgan_tpu_torch.generate --random_init --seed 0 ...  # smoke

Counterpart of cli/generate.py, with its flags and its output layout:
per user, batches of at most `--batch_size` DDIM samples, decoded by the
KL-VAE and written as `ID_{user}/generated_{i:03d}.jpg` at quality 95.
Denoiser weights come from a results folder of the port's trainer or of
the JAX package's (`--checkpoint DIR [--milestone M]`: its config, which
names the backbone, the CFG U-Net or the DiT, and its EMA weights, as the
JAX CLI reads its checkpoints; a JAX milestone is the Orbax directory
`model-{m}/`), or from a PyTorch state-dict file (the port's or the
reference models'), or are drawn at random from `--seed` with
`--random_init`. `--vae_path` is a KL-VAE state dict or an Orbax
directory (`train_kl_vae`'s `kl_vae-{m}/` of the JAX package).

Runs on the GPU by default (`--device cpu` to run on the CPU). fp32 matmuls
and convolutions run in full fp32 (TF32 off), as the JAX package's "highest"
precision.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from .build import build_cfg_unet_diffusion
from .checkpoint.load import load_weights
from .checkpoint.manager import CheckpointManager
from .configs.ldm_config import LDMConfig
from .device import resolve_device, set_full_fp32_precision
from .models.autoencoder import AutoencoderConfig, KLVAE

__all__ = ["load_model", "load_checkpoint", "load_vae", "generate_samples",
           "main"]


def load_model(config: LDMConfig, unet_weights=None, device="cuda"):
    """(diffusion, model) from `config`, with weights from `unet_weights`
    or as initialised (seed torch first for reproducible random weights)."""
    model, diffusion = build_cfg_unet_diffusion(config, device=device)
    if unet_weights is not None:
        load_weights(model, unet_weights)
    return diffusion, model


def load_checkpoint(checkpoint, milestone=None):
    """(LDMConfig, weights) of a results folder of the port's trainer or
    the JAX package's: the config saved with `milestone` (the latest when
    None) and the milestone's `model-{m}.pt` or Orbax directory
    `model-{m}/`, whose EMA weights `load_weights` reads."""
    ckpt = CheckpointManager(checkpoint, prefix="model")
    weights = ckpt.checked_path(milestone)
    milestone = int(weights.stem.rsplit("-", 1)[-1])
    return LDMConfig.from_dict(ckpt.load_config(milestone) or {}), weights


def load_vae(vae_weights=None, latent_channels: int = 4,
             image_size: int = 256, scale_factor: float = 0.18215,
             device="cuda") -> KLVAE:
    """The fp32 KL-VAE of cli/_common.py:load_vae on `device`."""
    device = resolve_device(device)
    vae = KLVAE(AutoencoderConfig(resolution=image_size,
                                  z_channels=latent_channels),
                scale_factor=scale_factor)
    if vae_weights is not None:
        load_weights(vae, vae_weights)
    return vae.to(device).eval()


def generate_samples(diffusion, user_label: int, n: int, cond_scale: float,
                     rescaled_phi: float, generator: torch.Generator):
    """n NHWC latents of class `user_label` (0-based)."""
    classes = torch.full((n,), user_label, dtype=torch.long)
    return diffusion.sample(classes=classes, cond_scale=cond_scale,
                            rescaled_phi=rescaled_phi, generator=generator)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", default=None,
                    help="results folder of the port's trainer "
                         "(model-{milestone}.pt and its config) or the JAX "
                         "package's (model-{milestone}/, Orbax)")
    ap.add_argument("--milestone", type=int, default=None,
                    help="with --checkpoint; default the latest")
    ap.add_argument("--unet_weights", default=None,
                    help="CFG U-Net state dict (.pt), port or reference")
    ap.add_argument("--vae_weights", "--vae_path", dest="vae_weights",
                    default=None, help="KL-VAE state dict (.pt) or Orbax "
                    "checkpoint directory")
    ap.add_argument("--config", default=None,
                    help="JSON of LDMConfig fields (default: LDMConfig())")
    ap.add_argument("--random_init", action="store_true",
                    help="random weights from --seed instead of files")
    ap.add_argument("--output_dir", default="./generated")
    ap.add_argument("--user_ids", type=int, nargs="*", default=None,
                    help="1-based user ids; default all users")
    ap.add_argument("--all_users", action="store_true")
    ap.add_argument("--num_images", type=int, default=50)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--cond_scale", type=float, default=None)
    ap.add_argument("--rescaled_phi", type=float, default=0.7)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.checkpoint is not None and args.unet_weights is not None:
        ap.error("pass --checkpoint or --unet_weights, not both")
    if not args.random_init and (args.vae_weights is None or (
            args.unet_weights is None and args.checkpoint is None)):
        ap.error("pass --checkpoint or --unet_weights, and --vae_weights; "
                 "or --random_init")
    return args


def main(argv=None):
    """Run generation. Returns {"images": paths written, "batch_seconds":
    host seconds of each batch, sampling through JPEG writing}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_full_fp32_precision()
    unet_weights = args.unet_weights
    if args.checkpoint is not None:
        config, unet_weights = load_checkpoint(args.checkpoint, args.milestone)
    elif args.config:
        config = LDMConfig.from_dict(json.loads(Path(args.config).read_text()))
    else:
        config = LDMConfig()

    torch.manual_seed(args.seed)  # random weights, where no file is given
    diffusion, _ = load_model(
        config, unet_weights if args.checkpoint or not args.random_init
        else None, device)
    vae = load_vae(None if args.random_init else args.vae_weights,
                   config.latent_channels, config.image_size, device=device)
    cond_scale = (args.cond_scale if args.cond_scale is not None
                  else config.cond_scale)
    users = (args.user_ids if args.user_ids
             else list(range(1, config.num_users + 1)))
    generator = torch.Generator(device=device).manual_seed(args.seed)

    written, batch_seconds = [], []
    out_root = Path(args.output_dir)
    for user in users:
        user_dir = out_root / f"ID_{user}"
        user_dir.mkdir(parents=True, exist_ok=True)
        produced = 0
        while produced < args.num_images:
            n = min(args.batch_size, args.num_images - produced)
            t0 = time.perf_counter()
            latents = generate_samples(diffusion, user - 1, n, cond_scale,
                                       args.rescaled_phi, generator)
            with torch.inference_mode():
                images = vae.decode_latents(latents).float().cpu().numpy()
            if not np.isfinite(images).all():
                raise FloatingPointError(f"non-finite images for ID_{user}")
            for img in images:
                arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
                path = user_dir / f"generated_{produced:03d}.jpg"
                Image.fromarray(arr).save(path, quality=95)
                written.append(path)
                produced += 1
            batch_seconds.append(time.perf_counter() - t0)
        print(f"ID_{user}: {produced} images -> {user_dir}")
    return {"images": written, "batch_seconds": batch_seconds}


if __name__ == "__main__":
    main()
