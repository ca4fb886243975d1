"""Where a training step's time goes on the GPU.

    python -m vqgan_tpu_torch.profile_train [--batch_size 8] [--steps 10]

Builds the full-width LDMConfig U-Net (bf16 compute), its AdamW optimizer
with clipping and its EMA copy with random weights from `--seed`, and a
batch of random [B, 32, 32, 4] latents with classes. Then measures one whole
training step (forward, backward, clipping, AdamW, EMA update) after a
warm-up, with `profile_generate.profile_steps`: host wall ms per step (read
first, with no profiler run yet in the process), then device kernel ms per
step, the device's idle share, launches per step and the top kernels. The
EMA step counter starts past the warm-copy regime with the LDMConfig
cadence, so one step in `ema_update_every` updates the EMA, as in a long
run. Also counts the flash kernels' launches per step. Prints one JSON
object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import copy
import json

import torch

from .build import build_cfg_unet_diffusion
from .configs.ldm_config import LDMConfig
from .device import resolve_device, set_full_fp32_precision
from .kernels import KERNELS
from .profile_generate import profile_steps
from .training.ldm_step import (
    LDMTrainState,
    make_ldm_optimizer,
    make_ldm_train_step,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    set_full_fp32_precision()
    torch.manual_seed(args.seed)
    cfg = LDMConfig()
    model, diffusion = build_cfg_unet_diffusion(cfg, device=device)
    model.train()
    optimizer = make_ldm_optimizer(
        model.parameters(), learning_rate=cfg.train_lr,
        weight_decay=cfg.weight_decay, betas=cfg.adam_betas,
        max_grad_norm=cfg.max_grad_norm)
    state = LDMTrainState(1000, model,
                          copy.deepcopy(model).requires_grad_(False),
                          optimizer)
    train_step = make_ldm_train_step(diffusion, optimizer,
                                     ema_decay=cfg.ema_decay,
                                     ema_update_every=cfg.ema_update_every)
    b, s, c = args.batch_size, cfg.latent_size, cfg.latent_channels
    gen = torch.Generator(device=device).manual_seed(args.seed)
    latents = torch.randn((b, s, s, c), generator=gen, device=device)
    classes = torch.arange(b, device=device) % cfg.num_users

    def step():
        return train_step(state, latents, classes, generator=gen)

    for k in KERNELS.values():
        k.launches = 0
    n_before = state.step
    out = {
        "device": torch.cuda.get_device_name(0),
        "batch_size": b,
        **profile_steps({"train_step": (step, args.steps)}),
    }
    n_steps = state.step - n_before
    out["flash_launches_per_step"] = {
        name: k.launches / n_steps for name, k in KERNELS.items()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
