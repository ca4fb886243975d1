"""Host seconds of the latent-diffusion samplers at full width.

    python -m vqgan_tpu_torch.time_sampling [--dit_batches 4] [--label NAME]

With random weights from `--seed` (LDMConfig's defaults, the fp32 KL-VAE):
- the DiT (`model_type` "dit"), a DDIM-150 batch of 16 at cond_scale 1.0
  from `ddim_sample`, then the decode: as `generate` samples (one captured
  CUDA graph on the card; "dit_generate_s") and eagerly (`graph=False`;
  "dit_eager_s"), in turns (eager, captured, captured, eager)
  `--dit_batches` / 4 times, after one untimed batch of each (the capture
  and the warm-up);
- an ancestral batch of 16 of the CFG U-Net (sampling_timesteps =
  timesteps = 1000), then the decode: captured and eagerly in turns after
  one untimed batch of each ("ancestral_turns_s"), the means as
  "ancestral_s" (captured, the default) and "ancestral_eager_s";
- the live `DDIMStep` (the function `export_serving` exports) at batch 16
  and cond_scale 1.0: host ms per step over 20 steps, three times.
Each is timed on the host with the device synchronised at both ends, JPEG
writing left out, and reports the hand-written kernels' launches. It
reaches the package only through `generate`, `diffusion.gaussian.DDIMStep`
and `kernels.KERNELS`, so a copy of this file placed in another checkout
of the package (one whose `ddim_sample` takes `graph`) times that
checkout's samplers: run both in turns in one process tree on one card to
compare them. Prints one JSON object. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from . import generate
from .configs.ldm_config import LDMConfig
from .device import resolve_device, set_full_fp32_precision
from .diffusion.gaussian import DDIMStep
from .kernels import KERNELS


def timed(fn):
    """(seconds, {kernel: launches}) of one call of `fn`."""
    before = {name: k.launches for name, k in KERNELS.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not bool(torch.isfinite(out).all()):
        raise FloatingPointError("non-finite output")
    return secs, {name: k.launches - before[name]
                  for name, k in KERNELS.items()
                  if k.launches != before[name]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dit_batches", type=int, default=4)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    set_full_fp32_precision()
    b = args.batch_size
    config = LDMConfig()
    vae = generate.load_vae(None, config.latent_channels, config.image_size,
                            device=device)
    out = {"device": torch.cuda.get_device_name(0), "label": args.label,
           "batch_size": b}
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def sample_and_decode(diffusion, graph=None):
        def run():
            latents = diffusion.ddim_sample(
                (b, config.latent_size, config.latent_size,
                 config.latent_channels), torch.zeros(b, dtype=torch.long),
                cond_scale=1.0, rescaled_phi=0.0, generator=gen, graph=graph)
            with torch.inference_mode():
                return vae.decode_latents(latents)
        return run

    torch.manual_seed(args.seed)
    dit, _ = generate.load_model(
        dataclasses.replace(config, model_type="dit"), None, device)
    # the default sampler (one captured graph on the card) and the eager
    # loop; keys "dit_generate_*" for the default, "dit_eager_*" for eager
    modes = {"dit_generate": sample_and_decode(dit, None),
             "dit_eager": sample_and_decode(dit, False)}
    for name, fn in modes.items():
        fn()  # the capture; the warm-up
        out[f"{name}_s"] = []
    for _ in range(max(1, args.dit_batches // 4)):
        for name in ("dit_eager", "dit_generate", "dit_generate",
                     "dit_eager"):
            secs, out[f"{name}_launches"] = timed(modes[name])
            out[f"{name}_s"].append(secs)
    del dit, modes

    torch.manual_seed(args.seed)
    unet, _ = generate.load_model(
        dataclasses.replace(config, sampling_timesteps=config.timesteps),
        None, device)

    def ancestral(graph):
        def run():
            latents = unet.p_sample_loop(
                (b, config.latent_size, config.latent_size,
                 config.latent_channels), torch.zeros(b, dtype=torch.long),
                cond_scale=1.0, rescaled_phi=0.0, generator=gen, graph=graph)
            with torch.inference_mode():
                return vae.decode_latents(latents)
        return run

    # the default sampler (one captured step's graph replayed per step on
    # the card) as "ancestral_*", the eager loop as "ancestral_eager_*"
    modes = {"ancestral": ancestral(None), "ancestral_eager": ancestral(False)}
    turns = {name: [] for name in modes}
    for fn in modes.values():
        fn()  # the capture; the warm-up
    for name in ("ancestral_eager", "ancestral", "ancestral",
                 "ancestral_eager"):
        secs, out[f"{name}_launches"] = timed(modes[name])
        turns[name].append(secs)
    for name, secs in turns.items():
        out[f"{name}_s"] = sum(secs) / len(secs)
    out["ancestral_turns_s"] = turns

    step = DDIMStep(unet, 1.0, 0.0)
    s, c = config.latent_size, config.latent_channels
    img = torch.randn((b, c, s, s), generator=gen, device=device)
    noise = torch.randn((b, c, s, s), generator=gen, device=device)
    t = torch.full((b,), config.timesteps - 1, dtype=torch.long,
                   device=device)
    t_next = t - 7
    classes = torch.zeros((b,), dtype=torch.long, device=device)

    def steps():
        with torch.inference_mode():
            for _ in range(20):
                x = step(img, t, t_next, classes, noise)
        return x

    steps()  # warm-up
    out["ddim_step_ms"] = [timed(steps)[0] / 20 * 1e3 for _ in range(3)]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
