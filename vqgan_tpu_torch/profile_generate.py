"""Where the generation time goes on the GPU.

    python -m vqgan_tpu_torch.profile_generate [--batch_size 16] [--steps 10]

Builds the full-width LDMConfig U-Net and the default fp32 KL-VAE with
random weights from `--seed`, then measures, after a warm-up:
- one DDIM step (U-Net forward + update) at cond_scale 1.0 and 3.0: host
  wall time per step, device kernel time per step and the device's idle
  share, from torch.profiler over `--steps` steps;
- the VAE decode of one batch: wall time and device kernel time;
- the whole DDIM chain (LDMConfig's sampling steps) of one batch at
  cond_scale 1.0, eager (`graph=False`) and as one captured CUDA graph:
  host wall time in turns (eager, captured, captured, eager; the capture
  before them), then device kernel time, the idle share and the launches
  of each, the hand-written kernels' launches counted through the replay,
  and the graph's capture seconds and pool bytes;
- the kernels that take the most device time, and the launches per step.
Every wall time is read before the first profiled run (`profile_steps`):
once torch.profiler has run in a process, every later launch costs more
host time. Prints one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .build import build_cfg_unet_diffusion
from .configs.ldm_config import LDMConfig
from .core.diffusion_math import ddim_step
from .device import resolve_device, set_full_fp32_precision
from .generate import load_vae
from .kernels import KERNELS

# the device functions of the hand-written kernels, by KERNELS name
KERNEL_FUNCTIONS = {"flash_fwd": "flash_fwd_kernel",
                    "flash_bwd_dq": "flash_bwd_dq_kernel",
                    "flash_bwd_dkv": "flash_bwd_dkv_kernel",
                    "vq_nearest": "vq_nearest_kernel"}


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total", None) \
        or getattr(event, "self_cuda_time_total", 0.0)


def wall_ms(fn, reps: int) -> float:
    """Host wall ms per call of `fn`: `reps` calls after one warm-up call,
    the device synchronised at both ends, no profiler running."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def profiled(fn, reps: int, wall: float, top: int = 8,
             named: dict | None = None) -> dict:
    """From `reps` calls under torch.profiler: device kernel ms per call,
    the idle share of `wall` (the unprofiled wall ms per call, read before
    any profiler ran), kernel launches per call and the top kernels by
    device time. `named` ({label: substring of a kernel name}) adds the
    device ms per call of the kernels whose names hold each substring."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # device events, less user annotations (the optimizer's step range spans
    # kernels that are counted already)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3 / reps
    ranked = sorted(kernels, key=_device_us, reverse=True)[:top]
    out = {
        "wall_ms": wall,
        "device_ms": device_ms if kernels else None,
        "idle_share": 1.0 - device_ms / wall if kernels else None,
        "launches": sum(e.count for e in kernels) / reps,
        "top": [{"kernel": e.key[:80], "ms": _device_us(e) / 1e3 / reps,
                 "count": e.count / reps} for e in ranked],
    }
    if named:
        out["named_ms"] = {
            label: sum(_device_us(e) for e in kernels if part in e.key)
            / 1e3 / reps for label, part in named.items()}
    return out


def counting(step_fn):
    """(fn, tally): fn runs `step_fn` and adds to tally the call and each
    hand-written kernel's launches in it."""
    tally = {"calls": 0, "launches": dict.fromkeys(KERNELS, 0)}

    def fn():
        before = {name: k.launches for name, k in KERNELS.items()}
        step_fn()
        tally["calls"] += 1
        for name, k in KERNELS.items():
            tally["launches"][name] += k.launches - before[name]

    return fn, tally


def profile_steps(steps: dict, named: dict | None = None) -> dict:
    """{label: (fn, reps)} -> {label: `profiled` stats}, in two passes:
    first every label's wall ms (`wall_ms`), then every label's profiled
    repeats. Once torch.profiler has run in a process, every later launch
    costs more host time, so no wall time is read after the first profiled
    call."""
    walls = {label: wall_ms(fn, reps) for label, (fn, reps) in steps.items()}
    return {label: profiled(fn, reps, walls[label], named=named)
            for label, (fn, reps) in steps.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    set_full_fp32_precision()
    torch.manual_seed(args.seed)
    config = LDMConfig()
    _, diffusion = build_cfg_unet_diffusion(config, device=device)
    vae = load_vae(None, config.latent_channels, config.image_size,
                   device=device)
    b, s, c = args.batch_size, config.latent_size, config.latent_channels
    gen = torch.Generator(device=device).manual_seed(args.seed)
    x = torch.randn((b, c, s, s), generator=gen, device=device)
    t = torch.full((b,), 500, dtype=torch.long, device=device)
    classes = torch.arange(b, device=device) % config.num_users
    noise = torch.randn_like(x)

    def step(cond_scale):
        def run():
            with torch.inference_mode():
                pred_noise, x_start = diffusion.model_predictions(
                    x, t, classes, cond_scale=cond_scale, rescaled_phi=0.7,
                    clip_x_start=True)
                return ddim_step(diffusion.schedule, x, x_start, pred_noise,
                                 500, 493, noise, diffusion.ddim_sampling_eta)
        return run

    latents = torch.randn((b, s, s, c), generator=gen, device=device) * 0.5

    def decode():
        with torch.inference_mode():
            return vae.decode_latents(latents)

    def chain(graph):
        def run():
            g = torch.Generator(device=device).manual_seed(args.seed)
            with torch.inference_mode():
                return diffusion.ddim_sample((b, s, s, c), classes,
                                             cond_scale=1.0, rescaled_phi=0.7,
                                             generator=g, graph=graph)
        return counting(run)

    chains = {"eager": chain(False), "captured": chain(True)}
    chains["captured"][0]()  # the capture
    chain_walls = {"eager": [], "captured": []}
    for name in ("eager", "captured", "captured", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chains[name][0]()
        torch.cuda.synchronize()
        chain_walls[name].append((time.perf_counter() - t0) * 1e3)
    out = {
        "device": torch.cuda.get_device_name(0),
        "batch_size": b,
        **profile_steps({"ddim_step_cond_scale_1": (step(1.0), args.steps),
                         "ddim_step_cond_scale_3": (step(3.0), args.steps),
                         "vae_decode": (decode, 2)}),
    }
    graph = next(iter(diffusion._graphs.values()))
    for name, (fn, tally) in chains.items():
        walls = chain_walls[name]
        out[f"ddim_chain_{name}"] = {
            **profiled(fn, 1, sum(walls) / len(walls)), "wall_ms_turns": walls,
            "kernel_launches_per_chain": {
                k: n / tally["calls"] for k, n in tally["launches"].items()}}
    out["ddim_chain_captured"].update(
        capture_seconds=graph.capture_seconds, pool_bytes=graph.pool_bytes)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
