"""Benchmark: CFG latent-diffusion sampling throughput at 256 px.

    python3 -m vqgan_tpu_torch.bench_sampling
    python3 -m vqgan_tpu_torch.bench_sampling --cond_scale 3.0 --no-decode

Counterpart of cli/bench_sampling.py (BASELINE config #4), with its flags
and defaults: LDMConfig's CFG U-Net (dim 96, mults 1-2-4-4, 8 heads x 64,
bf16) with random weights from `--seed`, DDIM over 32 x 32 x 4 latents
(`--sampling_timesteps`, 150), classes arange(batch) % num_users, then
the KL-VAE decode to 256 px in bf16 as the JAX CLI builds it (`--no-decode`
times the sampler alone). On the card each DDIM step replays one captured
CUDA graph (`ddim_sample`'s default). One untimed call (the capture and
the warm-up), then `--iters` timed calls: host seconds with the device
synchronised at both ends. Prints the device (on the card its name and
power limit as nvidia-smi gives them), then, as its last line, the JAX
CLI's JSON line.

Runs on the GPU by default (`--device cpu` to run on the CPU).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from .configs import LDMConfig
from .device import resolve_device, set_full_fp32_precision
from .generate import load_model
from .models import KLVAE
from .models.autoencoder import AutoencoderConfig

__all__ = ["main", "parse_args"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--sampling_timesteps", type=int, default=150)
    ap.add_argument("--cond_scale", type=float, default=1.0,
                    help="1.0 = reference inference config (CFG disabled); "
                         ">1 doubles U-Net work per step")
    ap.add_argument("--decode", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="include the KL-VAE decode to 256px (full "
                         "pipeline); --no-decode times the DDIM chain alone")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def device_line(device: torch.device) -> str:
    """The card's name and power limit (nvidia-smi), or the CPU."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        check=True, capture_output=True, text=True).stdout.strip()


def main(argv=None) -> dict:
    """Run the benchmark; returns {"first_s", "seconds" (mean per batch),
    "samples_per_s", "images" (the last batch), "line" (the JSON line)}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_full_fp32_precision()
    cfg = LDMConfig(sampling_timesteps=args.sampling_timesteps)
    torch.manual_seed(args.seed)
    diffusion, _ = load_model(cfg, device=device)
    vae = (KLVAE(AutoencoderConfig(resolution=cfg.image_size,
                                   z_channels=cfg.latent_channels),
                 dtype=torch.bfloat16).to(device).eval()
           if args.decode else None)
    b = args.batch
    classes = torch.arange(b, device=device) % cfg.num_users
    print(f"device: {device_line(device)}")

    def pipeline(i: int):
        gen = torch.Generator(device).manual_seed(args.seed + 1 + i)
        latents = diffusion.sample(classes=classes,
                                   cond_scale=args.cond_scale,
                                   rescaled_phi=cfg.rescaled_phi,
                                   generator=gen)
        if vae is None:
            return latents
        with torch.inference_mode():
            return vae.decode_latents(latents)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    out = pipeline(0)
    sync()
    first = time.perf_counter() - t0
    print(f"capture + first run: {first:.1f}s", file=sys.stderr)
    t0 = time.perf_counter()
    for i in range(args.iters):
        out = pipeline(1 + i)
    sync()
    seconds = (time.perf_counter() - t0) / args.iters
    line = {
        "metric": f"CFG DDIM-{args.sampling_timesteps} sampling + VAE decode "
                  f"at 256px (dim=96 U-Net, cond_scale={args.cond_scale})",
        "value": round(b / seconds, 3),
        "unit": "samples/sec/chip",
        "vs_baseline": None,
    }
    print(json.dumps(line))
    return {"first_s": first, "seconds": seconds, "samples_per_s": b / seconds,
            "images": out, "line": line}


if __name__ == "__main__":
    main()
