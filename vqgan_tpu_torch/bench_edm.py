"""EDM sampling with the Karras magnitude-preserving U-Net: samples/s of
the stochastic Heun sampler and of DPM-Solver++(2M).

    python3 -m vqgan_tpu_torch.bench_edm
    python3 -m vqgan_tpu_torch.bench_edm --sampler dpmpp --batch 64

Counterpart of cli/bench_edm.py (BASELINE config #5), with its flags and
defaults: a class-conditional KarrasUnet (dim 64, dim_max 4 x dim, 31
classes, 2 downsamples, 2 blocks per stage, attention at 16 and 8 px,
bf16, eval mode) at 64 px with random weights from `--seed`; batch 16,
32 steps, one untimed batch per sampler (on the card it holds the
capture: each sampler step then replays one captured CUDA graph, the
samplers' default), then `--iters` timed batches. Times are host seconds
with the device synchronised at both ends. Prints
each sampler's samples/s on stderr and, as its last line, the JSON line of
the JAX CLI (the Heun rate, or DPM++'s with `--sampler dpmpp`).

Runs on the GPU by default (`--device cpu` to run on the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .device import resolve_device, set_full_fp32_precision
from .diffusion import ElucidatedDiffusion
from .models import KarrasUnet

__all__ = ["main", "parse_args", "build"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--image_size", type=int, default=64)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--num_sample_steps", type=int, default=32)
    ap.add_argument("--num_classes", type=int, default=31)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--sampler", choices=("both", "heun", "dpmpp"),
                    default="both")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args, device):
    """(the bf16 KarrasUnet in eval mode on `device`, its
    ElucidatedDiffusion over classes arange(batch) % num_classes)."""
    torch.manual_seed(args.seed)
    model = KarrasUnet(
        image_size=args.image_size, dim=args.dim, dim_max=args.dim * 4,
        num_classes=args.num_classes, channels=3, num_downsamples=2,
        num_blocks_per_stage=2, attn_res=(16, 8),
        dtype=torch.bfloat16).to(device).eval()
    classes = torch.arange(args.batch, device=device) % args.num_classes

    def net(x, t_noise, self_cond=None):
        return model(x, t_noise, class_labels=classes)

    ed = ElucidatedDiffusion(net, image_size=args.image_size, channels=3,
                             num_sample_steps=args.num_sample_steps,
                             device=device)
    return model, ed


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_sampler(fn, device, iters: int, seed: int) -> dict:
    """One untimed call, then `iters` timed ones: {"first_s", "seconds"
    (mean per batch), "images"} (the last batch)."""
    t0 = time.perf_counter()
    out = fn(torch.Generator(device).manual_seed(seed))
    _sync(device)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(iters):
        out = fn(torch.Generator(device).manual_seed(seed + 1 + i))
    _sync(device)
    return {"first_s": first, "seconds": (time.perf_counter() - t0) / iters,
            "images": out}


def main(argv=None) -> dict:
    """Run the benchmark; returns {sampler: time_sampler's result plus
    "samples_per_s"} and the last line's JSON under "line"."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_full_fp32_precision()
    model, ed = build(args, device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"KarrasUnet parameters: {n_params / 1e6:.1f}M", file=sys.stderr)

    b, results = args.batch, {}
    samplers = {
        "heun": lambda g: ed.sample(batch_size=b, generator=g),
        "dpmpp": lambda g: ed.sample_using_dpmpp(batch_size=b, generator=g),
    }
    for offset, (name, fn) in enumerate(samplers.items()):
        if args.sampler not in ("both", name):
            continue
        r = time_sampler(fn, device, args.iters, args.seed + 100 * offset)
        r["samples_per_s"] = b / r["seconds"]
        results[name] = r
        print(f"{name}: first batch {r['first_s']:.1f} s, "
              f"{r['samples_per_s']:.2f} samples/s", file=sys.stderr)

    key = "heun" if "heun" in results else "dpmpp"
    name = "Heun" if key == "heun" else "DPM++(2M)"
    line = {
        "metric": f"EDM {name}-{args.num_sample_steps} sampling, KarrasUnet "
                  f"dim={args.dim} @ {args.image_size}px b{b}",
        "value": round(results[key]["samples_per_s"], 3),
        "unit": "samples/sec/chip",
        "vs_baseline": None,
    }
    print(json.dumps(line))
    return {**results, "line": line}


if __name__ == "__main__":
    main()
