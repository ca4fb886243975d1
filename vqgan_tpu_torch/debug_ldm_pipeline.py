"""LDM pipeline sanity checks on a KL-VAE checkpoint.

    python -m vqgan_tpu_torch.debug_ldm_pipeline --vae_path kl_vae-2.pt \\
        [--data_path data/Normal_line] [--image_size 256] \\
        [--latent_channels 4] [--device cpu]

Counterpart of cli/debug_ldm_pipeline.py, on a KL-VAE checkpoint (a
`train_kl_vae` milestone of the port or, as an Orbax directory, of the JAX
package, or a state dict):

1. a decode from a random latent (normal x 0.18215, from a generator
   seeded with 0) must not be constant: std > 0.01;
2. with `--data_path`, the encode-decode MSE of its first 8 images (sorted,
   any depth): < 0.01 excellent, < 0.05 good, else POOR (a failure);
3. the scale factor's normalise / denormalise invariance:
   `decode(z / 0.18215)` clamped equals `decode_latents(z)` within 1e-5;
4. the checkpoint holds every tensor of the KL-VAE (loading raises
   otherwise); its parameter count.

Prints one line per check and "pipeline HEALTHY" or "pipeline HAS
PROBLEMS"; exits 1 on a problem. Runs on the GPU unless given
`--device cpu`, with TF32 off.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

__all__ = ["main"]


def main(argv=None) -> bool:
    """Run the checks; returns True when healthy (the CLI exits 1 when
    not)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vae_path", required=True)
    ap.add_argument("--data_path", default=None)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--latent_channels", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .data import load_image
    from .data.splits import IMAGE_EXTENSIONS
    from .device import resolve_device, set_full_fp32_precision
    from .generate import load_vae

    device = resolve_device(args.device)
    set_full_fp32_precision()
    model = load_vae(args.vae_path, args.latent_channels, args.image_size,
                     device=device)
    latent_size = args.image_size // 8
    ok = True

    with torch.inference_mode():
        # 1. a decode from a random latent must not be constant
        gen = torch.Generator(device).manual_seed(0)
        z = torch.randn((1, latent_size, latent_size, args.latent_channels),
                        generator=gen, device=device) * 0.18215
        std = float(model.decode_latents(z).std())
        ok &= std > 0.01
        print(f"[{'OK' if std > 0.01 else 'FAIL'}] random-latent decode std "
              f"= {std:.4f} (want > 0.01)")

        # 2. real encode-decode MSE tiers
        if args.data_path:
            files = sorted(p for p in Path(args.data_path).rglob("*")
                           if p.suffix.lower() in IMAGE_EXTENSIONS)[:8]
            imgs = torch.from_numpy(np.stack(
                [load_image(p, args.image_size) for p in files])).to(device)
            z = model.encode_images_mean(imgs)
            rec = model.decode_latents(z)
            mse = float(((rec - imgs) ** 2).mean())
            tier = ("excellent" if mse < 0.01 else
                    "good" if mse < 0.05 else "POOR")
            ok &= mse < 0.05
            print(f"[{'OK' if mse < 0.05 else 'FAIL'}] real recon MSE = "
                  f"{mse:.5f} ({tier})")

        # 3. decode_latents must undo the scale factor that encode applied
        post = model.decode(z.permute(0, 3, 1, 2) / model.scale_factor)
        post = torch.clamp(post, 0, 1).permute(0, 2, 3, 1)
        diff = float((post - model.decode_latents(z)).abs().max())
        ok &= diff < 1e-5
        print(f"[{'OK' if diff < 1e-5 else 'FAIL'}] scale-factor "
              f"normalize/denormalize invariance (max diff {diff:.2e})")

    # 4. the checkpoint's fields (load_vae raised had any been missing)
    n_tensors = len(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[OK] checkpoint loads; all {n_tensors} KL-VAE tensors present, "
          f"{n_params / 1e6:.1f}M parameters")

    print("\npipeline " + ("HEALTHY" if ok else "HAS PROBLEMS"))
    return bool(ok)


if __name__ == "__main__":
    raise SystemExit(0 if main() else 1)
