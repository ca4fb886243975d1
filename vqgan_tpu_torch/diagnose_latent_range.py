"""Latent-distribution audit of a trained stage-1 model.

    python -m vqgan_tpu_torch.diagnose_latent_range --vae_path kl_vae-1.pt \\
        --data_path images [--num_images 100] [--image_size 256]
    python -m vqgan_tpu_torch.diagnose_latent_range \\
        --vqgan_path results/vqgan/vqgan-1.pt --data_path images

Counterpart of cli/diagnose_latent_range.py: encode the first N images
under `--data_path` (sorted, in zero-padded batches of `--batch_size`) with
the KL-VAE's posterior mean (`encode_images_mean`) or the VQ-VAE's
quantised latents (`encode_images`), print the latents' min, max, mean,
std, p1 and p99, the normalisation advice, and for a VQ-VAE the codebook's
statistics. Runs on the GPU by default (`--device cpu` for the CPU).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from .checkpoint.load import load_vqvae
from .data.datasets import load_image, pad_to_batch
from .data.splits import IMAGE_EXTENSIONS
from .device import resolve_device, set_full_fp32_precision
from .generate import load_vae

__all__ = ["latent_stats", "normalization_advice", "main"]


def latent_stats(lat: np.ndarray) -> dict:
    """min, max, mean, std, p1 and p99 of [N, ...] latents."""
    return {"min": float(lat.min()), "max": float(lat.max()),
            "mean": float(lat.mean()), "std": float(lat.std()),
            "p1": float(np.percentile(lat, 1)),
            "p99": float(np.percentile(lat, 99))}


def normalization_advice(stats: dict) -> str:
    mn, mx = stats["min"], stats["max"]
    if -1.2 < mn and mx < 1.2:
        return "latents already ≈[-1,1]; auto_normalize=False is correct"
    if 0.0 <= mn and mx <= 1.0:
        return "latents in [0,1]; set auto_normalize=True for the LDM"
    return (f"latents outside [-1,1]; consider normalizing with "
            f"mean={stats['mean']:.4f} std={stats['std']:.4f} before "
            f"diffusion")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vae_path", default=None, help="KL-VAE state dict")
    ap.add_argument("--vqgan_path", default=None,
                    help="vqgan-*.pt of the port's VQ-GAN trainer, or a "
                         "VQ-VAE state dict")
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--num_images", type=int, default=100)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not (args.vae_path or args.vqgan_path):
        ap.error("pass --vae_path or --vqgan_path")
    return args


def main(argv=None) -> dict:
    """Print the audit; returns {"images", "latents": latent_stats,
    "advice", "codebook": its statistics or None}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_full_fp32_precision()
    root = Path(args.data_path)
    files = sorted(p for p in root.rglob("*")
                   if p.suffix.lower() in IMAGE_EXTENSIONS)[: args.num_images]

    codebook = None
    if args.vqgan_path:
        model, _ = load_vqvae(args.vqgan_path, args.image_size, device)
        encode = model.encode_images
        codebook = model.quantizer.embedding.weight.detach().float().cpu()
        codebook = codebook.numpy()
    else:
        model = load_vae(args.vae_path, image_size=args.image_size,
                         device=device)
        encode = model.encode_images_mean

    lat = []
    with torch.inference_mode():
        for s in range(0, len(files), args.batch_size):
            chunk = files[s: s + args.batch_size]
            imgs = np.stack([load_image(p, args.image_size) for p in chunk])
            imgs = pad_to_batch(imgs, args.batch_size)
            z = encode(torch.from_numpy(imgs).to(device)).float().cpu()
            lat.append(z.numpy()[: len(chunk)].reshape(len(chunk), -1))
    lat = np.concatenate(lat)

    stats = latent_stats(lat)
    print(f"latents over {len(lat)} images:")
    print(f"  min={stats['min']:.4f} max={stats['max']:.4f} "
          f"mean={stats['mean']:.4f} std={stats['std']:.4f}")
    print(f"  p1={stats['p1']:.4f} p99={stats['p99']:.4f}")
    advice = normalization_advice(stats)
    print("\nnormalization advice:")
    print(f"  {advice}")

    book = None
    if codebook is not None:
        norms = np.linalg.norm(codebook, axis=1)
        book = {"shape": list(codebook.shape), "min": float(codebook.min()),
                "max": float(codebook.max()), "mean": float(codebook.mean()),
                "std": float(codebook.std()),
                "norm_min": float(norms.min()),
                "norm_max": float(norms.max())}
        print(f"\ncodebook: {codebook.shape[0]} x {codebook.shape[1]}")
        print(f"  weight min={book['min']:.4f} max={book['max']:.4f} "
              f"mean={book['mean']:.4f} std={book['std']:.4f}")
        print(f"  row norms: min={book['norm_min']:.4f} "
              f"max={book['norm_max']:.4f}")
    return {"images": len(lat), "latents": stats, "advice": advice,
            "codebook": book}


if __name__ == "__main__":
    main()
