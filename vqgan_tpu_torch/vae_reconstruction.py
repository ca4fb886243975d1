"""KL-VAE reconstruction report: MSE, PSNR and SSIM of encode -> decode.

    python -m vqgan_tpu_torch.vae_reconstruction \\
        --vae_path results/kl_vae/kl_vae-50.pt --data_path data/Normal_line

Counterpart of cli/test_vae_reconstruction.py (renamed so that no test
run collects it), with its flags: `--num_images` images picked from every
image under `--data_path` (sorted, `np.random.default_rng(seed).choice`,
as there), each through the posterior mean and the decoder
(`encode_images_mean`, `decode_latents`), then per image MSE, PSNR and the
reference's simplified SSIM, the table, the verdict by the reference's
thresholds (PSNR > 30 and SSIM > 0.9 "very good"; PSNR > 25 and SSIM >
0.85 "medium"; else "bad"), and in `--output_dir` a `reconstructions.png`
of [input | reconstruction] rows and `metrics.json`. `--vae_path` is a
KL-VAE state dict (.pt) or an Orbax directory of the JAX package
(`kl_vae-{m}/`).

Runs on the GPU by default (`--device cpu` to run on the CPU), with TF32
off for fp32 matmuls and convolutions.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from .data import IMAGE_EXTENSIONS, load_image
from .device import resolve_device, set_full_fp32_precision
from .eval.metrics import mse, psnr, ssim_simplified
from .generate import load_vae

__all__ = ["main", "parse_args", "verdict"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vae_path", required=True,
                    help="KL-VAE state dict (.pt) or Orbax "
                         "checkpoint directory")
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--num_images", type=int, default=10)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--latent_channels", type=int, default=4)
    ap.add_argument("--output_dir", default="./vae_reconstruction_test")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def verdict(mean_psnr: float, mean_ssim: float) -> str:
    if mean_psnr > 30 and mean_ssim > 0.9:
        return "very good — VAE reconstruction quality is excellent"
    if mean_psnr > 25 and mean_ssim > 0.85:
        return "medium — usable, but check latent-space quality"
    return "bad — VAE needs retraining"


def main(argv=None) -> dict:
    """Write the report; returns what metrics.json holds."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_full_fp32_precision()
    vae = load_vae(args.vae_path, args.latent_channels, args.image_size,
                   device=device)

    root = Path(args.data_path)
    files = sorted(p for p in root.rglob("*")
                   if p.suffix.lower() in IMAGE_EXTENSIONS)
    rng = np.random.default_rng(args.seed)
    picks = rng.choice(len(files), min(args.num_images, len(files)),
                       replace=False)
    images = np.stack([load_image(files[i], args.image_size) for i in picks])

    with torch.inference_mode():
        x = torch.from_numpy(images).to(device)
        recon = vae.decode_latents(vae.encode_images_mean(x))
        m, p, s = (f(x, recon).cpu().numpy()
                   for f in (mse, psnr, ssim_simplified))
        recon = recon.cpu().numpy()

    print(f"{'image':<30} {'MSE':>10} {'PSNR':>8} {'SSIM':>8}")
    for i, idx in enumerate(picks):
        print(f"{files[idx].name:<30} {m[i]:>10.6f} {p[i]:>8.2f} {s[i]:>8.4f}")
    mean_psnr, mean_ssim = float(p.mean()), float(s.mean())
    print("-" * 60)
    print(f"{'mean':<30} {float(m.mean()):>10.6f} {mean_psnr:>8.2f} "
          f"{mean_ssim:>8.4f}")
    result = {"mse": m.tolist(), "psnr": p.tolist(), "ssim": s.tolist(),
              "mean_psnr": mean_psnr, "mean_ssim": mean_ssim,
              "verdict": verdict(mean_psnr, mean_ssim)}
    print(f"verdict: {result['verdict']}")

    from PIL import Image

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    rows = [np.concatenate([a, b], axis=1) for a, b in zip(images, recon)]
    grid = (np.clip(np.concatenate(rows, axis=0), 0, 1) * 255).astype(np.uint8)
    Image.fromarray(grid).save(out / "reconstructions.png")
    (out / "metrics.json").write_text(json.dumps(result, indent=2))
    print(f"saved grid + metrics to {out}")
    return result


if __name__ == "__main__":
    main()
