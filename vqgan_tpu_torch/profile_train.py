"""Where a training step's time goes on the GPU.

    python -m vqgan_tpu_torch.profile_train [--batch_size 8] [--steps 10] \
        [--config fields.json] [--gradient_checkpointing] \
        [--step_mode step|scan] [--scan_block K]

Builds the full-width denoiser of LDMConfig (the CFG U-Net, or with a
`--config` JSON of further LDMConfig fields another one, such as
{"model_type": "dit"}; bf16 compute), optionally with gradient
checkpointing, its AdamW optimizer with clipping and its EMA copy with
random weights from `--seed`, and a batch of random [B, 32, 32, 4] latents
with classes. Then measures one whole training step (forward, backward,
clipping, AdamW, EMA update) after a warm-up, with
`profile_generate.profile_steps`: host wall ms per step (read first, with
no profiler run yet in the process), then device kernel ms per step, the
device's idle share, launches per step and the top kernels. The EMA step
counter starts past the warm-copy regime with the LDMConfig cadence, so
one step in `ema_update_every` updates the EMA, as in a long run. Also
counts the flash kernels' launches per step, and reads the peak of
allocated memory above what is allocated before a step, over one whole
step and over its forward and backward alone (what gradient checkpointing
acts on). With `--step_mode scan` the step is the scan mode's
(`make_ldm_scan_step` over a `CapturableOptimizer`): one call runs a block
of `--scan_block` steps, one step's CUDA graph replayed per step, captured
before the measurement; every figure is then per step, the launches
counted through the replays, with each graph's capture seconds and pool
bytes. Prints one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import copy
import json
from pathlib import Path

import torch

from .build import build_cfg_unet_diffusion
from .configs.ldm_config import LDMConfig
from .device import resolve_device, set_full_fp32_precision
from .kernels import KERNELS
from .profile_generate import profile_steps
from .training.ldm_step import (
    LDMTrainState,
    make_ldm_optimizer,
    make_ldm_scan_step,
    make_ldm_train_step,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--config", default=None,
                    help="JSON of further LDMConfig fields")
    ap.add_argument("--gradient_checkpointing", action="store_true")
    ap.add_argument("--step_mode", choices=("step", "scan"), default="step")
    ap.add_argument("--scan_block", type=int, default=1)
    args = ap.parse_args(argv)
    scan = args.step_mode == "scan"
    k = args.scan_block if scan else 1

    device = resolve_device("cuda")
    set_full_fp32_precision()
    torch.manual_seed(args.seed)
    cfg = LDMConfig.from_dict(
        json.loads(Path(args.config).read_text()) if args.config else {})
    model, diffusion = build_cfg_unet_diffusion(
        cfg, device=device,
        gradient_checkpointing=args.gradient_checkpointing)
    model.train()
    optimizer = make_ldm_optimizer(
        model.parameters(), learning_rate=cfg.train_lr,
        weight_decay=cfg.weight_decay, betas=cfg.adam_betas,
        max_grad_norm=cfg.max_grad_norm, capturable=scan)
    state = LDMTrainState(1000, model,
                          copy.deepcopy(model).requires_grad_(False),
                          optimizer)
    ema_kw = dict(ema_decay=cfg.ema_decay,
                  ema_update_every=cfg.ema_update_every)
    b, s, c = args.batch_size, cfg.latent_size, cfg.latent_channels
    gen = torch.Generator(device=device).manual_seed(args.seed)
    latents = torch.randn((k, b, s, s, c), generator=gen, device=device)
    classes = (torch.arange(b, device=device) % cfg.num_users).expand(k, b)
    if scan:
        block_step = make_ldm_scan_step(diffusion, optimizer, **ema_kw)

        def step():
            return block_step(state, latents, classes, generator=gen)

        step()
        step()  # the warm-up, then the capture
    else:
        train_step = make_ldm_train_step(diffusion, optimizer, **ema_kw)

        def step():
            return train_step(state, latents[0], classes[0], generator=gen)

    def forward_backward():
        diffusion.loss(latents[0], classes[0], generator=gen).backward()

    for kernel in KERNELS.values():
        kernel.launches = 0
    n_before = state.step
    stats = profile_steps({"train_step": (step, args.steps)})["train_step"]
    out = {
        "device": torch.cuda.get_device_name(0),
        "model_type": cfg.model_type,
        "gradient_checkpointing": args.gradient_checkpointing,
        "step_mode": args.step_mode,
        "batch_size": b,
        "train_step": per_step(stats, k),
    }
    if scan:
        out["scan_block"] = k
        out["graphs"] = [st for r in block_step.runners.values()
                         for st in r.stats()]
    n_steps = state.step - n_before
    out["flash_launches_per_step"] = {
        name: kernel.launches / n_steps for name, kernel in KERNELS.items()}
    out["step_peak_bytes"] = peak_above_start(step)
    optimizer.zero_grad()
    forward_backward()  # the gradients' storage, as a step finds it
    out["forward_backward_peak_bytes"] = peak_above_start(forward_backward)
    print(json.dumps(out))
    return out


def per_step(stats: dict, k: int) -> dict:
    """`profiled` stats of calls that each ran k steps, per step."""
    if k == 1:
        return stats
    out = dict(stats)
    for key in ("wall_ms", "device_ms", "launches"):
        if out[key] is not None:
            out[key] = out[key] / k
    out["top"] = [{**t, "ms": t["ms"] / k, "count": t["count"] / k}
                  for t in stats["top"]]
    return out


def peak_above_start(fn) -> int:
    """Bytes of device memory allocated at the peak of one `fn()` call
    above what was allocated when it began."""
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - start


if __name__ == "__main__":
    main()
