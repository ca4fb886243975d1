"""Where a stage-1 KL-VAE training step's time goes on the GPU.

    python -m vqgan_tpu_torch.profile_kl_vae_train [--batch_size 8] [--steps 5]

The counterpart of `profile_vqgan_train` for `train_kl_vae`'s step. Builds
the default KL-VAE (`AutoencoderConfig()`: ch 128, mults 1-2-2-4, 2 res
blocks, z 4, 256 px, fp32 with TF32 off) with random weights from
`--seed`, the trainer's optimizer (clip 1.0 + Adam at lr 4.5e-6) and a
batch of random [B, 256, 256, 3] images. Then measures one training step
(encode, sampled posterior, decode, MSE + KL, backward, clip, Adam) with
`profile_generate.profile_steps` after a warm-up: host wall ms per step,
read before any profiled run, then device kernel ms per step, the device's
idle share, launches per step, the top kernels, each hand-written kernel's
launches and device ms per step, and the peak of allocated device memory.
Prints one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from .device import resolve_device, set_full_fp32_precision
from .models.autoencoder import AutoencoderConfig, KLVAE
from .profile_generate import KERNEL_FUNCTIONS, counting, profile_steps
from .training.kl_vae_step import make_kl_vae_optimizer, make_kl_vae_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    set_full_fp32_precision()
    torch.manual_seed(args.seed)
    config = AutoencoderConfig()
    vae = KLVAE(config).to(device)
    optimizer = make_kl_vae_optimizer(vae.parameters(), 4.5e-6, "constant",
                                      50000)
    train_step = make_kl_vae_train_step(vae, optimizer, kl_weight=1e-6)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    s = config.resolution
    images = torch.rand((args.batch_size, s, s, config.in_ch),
                        generator=gen, device=device)
    step, tally = counting(lambda: train_step(images, generator=gen))
    torch.cuda.reset_peak_memory_stats(device)
    out = {
        "device": torch.cuda.get_device_name(0),
        "batch_size": args.batch_size,
        **profile_steps({"kl_vae_step": (step, args.steps)},
                        named=KERNEL_FUNCTIONS),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device),
    }
    out["kl_vae_step"]["kernel_launches_per_step"] = {
        name: n / tally["calls"] for name, n in tally["launches"].items()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
