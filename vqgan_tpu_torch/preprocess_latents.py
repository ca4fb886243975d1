"""Latent preprocessing: write the split, then encode its images into the
latent cache.

    python -m vqgan_tpu_torch.preprocess_latents \\
        --vae_path results/kl_vae/kl_vae-50.pt --data_path data/Normal_line \\
        --output_split data_split.json --cache_folder latents_cache

Counterpart of cli/preprocess_latents.py, with its flags: the stratified
uniform split (`create_data_split`, checked by `verify_split`) is written
to `--output_split`; then every train image (and test image, unless
`--no-encode_test`) not yet in the cache is encoded to its posterior mean
times the scale factor (`KLVAE.encode_images_mean`, NHWC) in batches of
`--batch_size`, the last batch as short as it falls, and stored as
`user_{label:02d}_{stem}.npy` (`LatentCache`), which `train_latent_cfg`
reads. `--vae_path` is a KL-VAE state dict (.pt): a `train_kl_vae`
milestone or a reference `kl_vae_best.pt`; or an Orbax directory of the
JAX package's `train_kl_vae` (`kl_vae-{m}/`).

Runs on the GPU by default (`--device cpu` to run on the CPU), with TF32
off for fp32 matmuls and convolutions.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from .data import (
    LatentCache,
    create_data_split,
    load_image,
    save_split,
    verify_split,
)
from .device import resolve_device, set_full_fp32_precision
from .generate import load_vae

__all__ = ["main", "parse_args"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vae_path", required=True,
                    help="KL-VAE state dict (.pt) or Orbax "
                         "checkpoint directory")
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--output_split", default="data_split.json")
    ap.add_argument("--cache_folder", default="./latents_cache")
    ap.add_argument("--num_users", type=int, default=31)
    ap.add_argument("--images_per_user_train", type=int, default=50)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--batch_size", type=int, default=56)
    ap.add_argument("--encode_test", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="also encode test images (--no-encode_test to skip)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Write the split and fill the cache. Returns {"split", "encoded":
    the number of images encoded, "seconds": host seconds of the
    encoding, image loading included}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_full_fp32_precision()
    vae = load_vae(args.vae_path, image_size=args.image_size, device=device)

    split = create_data_split(args.data_path, args.num_users,
                              args.images_per_user_train, args.seed)
    problems = verify_split(split)
    if problems:
        raise RuntimeError(f"the new split is not sound: {problems}")
    save_split(split, args.output_split)
    print(f"wrote {args.output_split}")

    cache = LatentCache(args.cache_folder)
    root = Path(args.data_path)
    todo = []  # (user, name, label)
    for user, info in split["users"].items():
        label = int(user.split("_")[1]) - 1
        names = info["train_images"] + (
            info["test_images"] if args.encode_test else [])
        todo += [(user, name, label) for name in names
                 if not cache.has(label, name)]

    print(f"encoding {len(todo)} images (batch {args.batch_size})")
    t0 = time.perf_counter()
    for s in range(0, len(todo), args.batch_size):
        chunk = todo[s:s + args.batch_size]
        images = np.stack([load_image(root / user / name, args.image_size)
                           for user, name, _ in chunk])
        with torch.inference_mode():
            latents = vae.encode_images_mean(
                torch.from_numpy(images).to(device)).cpu().numpy()
        for (_, name, label), z in zip(chunk, latents):
            cache.save(label, name, z)
        print(f"  {s + len(chunk)}/{len(todo)}", end="\r")
    seconds = time.perf_counter() - t0
    print(f"\ncache populated at {args.cache_folder}")
    return {"split": split, "encoded": len(todo), "seconds": seconds}


if __name__ == "__main__":
    main()
