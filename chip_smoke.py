#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vqgan_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # build + kernel-vs-plain checks

Phases, in order; any failure exits non-zero:
1. A CUDA device must be present; print its name and power limit.
2. Build every hand-written kernel from the sources in this checkout.
3. Hold each kernel against its plain PyTorch version on the card (TF32
   off) at the main path's shapes and at ragged shapes; time the kernel,
   the plain version and one PyTorch library call, and compute the bound.
4. Run the whole slice on a small input (tiny U-Net and KL-VAE in fp32,
   5 DDIM steps at cond_scale 3.0 with injected noise, then the decode)
   on the card and on the CPU, where attention takes the plain version,
   and hold the two images against each other.
5. Drive the main path, `python -m vqgan_tpu_torch.generate`, at full width
   with seeded random weights: LDMConfig defaults (dim 96, mults 1-2-4-4,
   8 heads x 64, T=1000, DDIM-150, pred_v, cosine, bf16 U-Net) and the
   default fp32 KL-VAE at 256 px; two users of one batch of 16 at
   cond_scale 1.0, then one batch at cond_scale 3.0 / rescaled_phi 0.7.
   The kernel launch counts are reset just before and read just after, and
   must be 151 per batch (150 U-Net steps + 1 VAE decode). The JPG layout
   must be written and every image finite.
6. Print the kernels' JSON line, then the device line last.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# NVIDIA data-sheet peaks (SXM parts, dense, at the full 700 W limit).
_PEAKS = {
    "H100": {"bytes_per_s": 3.35e12, "bfloat16": 989e12, "float32": 67e12},
    "H200": {"bytes_per_s": 4.8e12, "bfloat16": 989e12, "float32": 67e12},
}

# tolerance of kernel vs plain version, both fp32 math on the card: they
# differ only in summation order (fp32) or in one final bf16 rounding step
_ATOL = {"float32": {"out": 2e-5, "lse": 1e-4},
         "bfloat16": {"out": 1e-2, "lse": 1e-4}}


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str) -> dict:
    return _PEAKS["H200"] if "H200" in name else _PEAKS["H100"]


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean time of one call on the card, by CUDA events over `iters`
    calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_cases():
    """(label, B, Sq, Skv, H, D, dtype, main_path)."""
    return [
        ("unet_mid", 16, 16, 16, 8, 64, "bfloat16", True),
        ("unet_mid_cfg", 32, 16, 16, 8, 64, "bfloat16", True),
        ("vae_mid", 16, 1024, 1024, 1, 512, "float32", True),
        ("ragged_d512", 2, 100, 100, 1, 512, "float32", False),
        ("ragged_cross", 2, 64, 17, 4, 32, "float32", False),
        ("ragged_tiny_bf16", 1, 7, 7, 2, 16, "bfloat16", False),
    ]


def check_flash_fwd(torch, peaks, seed: int):
    import torch.nn.functional as F

    from vqgan_tpu_torch.kernels.flash_fwd import flash_fwd
    from vqgan_tpu_torch.ops.attention import flash_forward_reference

    rows = {}
    rng = np.random.default_rng(seed)
    for label, b, s_q, s_kv, h, d, dt, main in attention_cases():
        dtype = getattr(torch, dt)

        def make(s):
            x = rng.standard_normal((b, s, h, d)).astype(np.float32)
            return torch.from_numpy(x).to("cuda", dtype)

        q, k, v = make(s_q), make(s_kv), make(s_kv)
        if label == "ragged_cross":
            # strided views: the kernel reads BSHD in place
            q = torch.cat([q, q], dim=-1)[..., :d]
        scale = 1.0 / np.sqrt(d)
        out, lse = flash_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_forward_reference(q, k, v, scale)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
        print(f"flash_fwd {label} [{b},{s_q},{h},{d}] kv={s_kv} {dt}: "
              f"max|out-plain|={err_out:.3e} max|lse-plain|={err_lse:.3e}")
        if (not finite or err_out > _ATOL[dt]["out"]
                or err_lse > _ATOL[dt]["lse"]):
            fail(f"flash_fwd disagrees with its plain version at {label} "
                 f"(tolerance {_ATOL[dt]})")
        if not main:
            continue

        iters = 20 if s_q >= 1024 else 200
        kernel_ms = cuda_ms(torch, lambda: flash_fwd(q, k, v, scale), iters)
        plain_ms = cuda_ms(
            torch, lambda: flash_forward_reference(q, k, v, scale), iters)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = cuda_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=scale), iters)
        itemsize = q.element_size()
        n_bytes = (2 * b * s_q * h * d + 2 * b * s_kv * h * d) * itemsize \
            + 4 * b * h * s_q
        flops = 4 * b * h * s_q * s_kv * d
        t_bytes = n_bytes / peaks["bytes_per_s"] * 1e3
        t_ops = flops / peaks[dt] * 1e3
        rows[label] = {
            "name": "flash_fwd",
            "key": (b, s_q, h, d, dt),
            "shape": f"[{b},{s_q},{h},{d}] {dt}",
            "route": "cuda",
            "source": "vqgan_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "vqgan_tpu/ops/attention.py:86",
            "launches": None,
            "max_abs_err": max(err_out, err_lse),
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        print(f"flash_fwd {label}: kernel_ms={kernel_ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"bound_ms={rows[label]['bound_ms']:.4f} "
              f"({rows[label]['bound_by']})")
    return rows


def check_small_pipeline(torch, kernels, seed: int):
    """The slice on a small input, card (kernel) against CPU (plain
    version): same weights, same injected noise, fp32 with TF32 off. The
    CPU port matches the JAX package to 2e-5 on such a chain
    (tests/test_torch_port_generate.py); cuDNN and the kernel sum in
    other orders, hence 1e-3."""
    from vqgan_tpu_torch.diffusion import GaussianDiffusion
    from vqgan_tpu_torch.models import CFGUnet, KLVAE
    from vqgan_tpu_torch.models.autoencoder import AutoencoderConfig

    torch.manual_seed(seed)
    unet = CFGUnet(dim=16, num_classes=3, cond_drop_prob=0.0,
                   dim_mults=(1, 2), channels=4, attn_dim_head=16,
                   attn_heads=2).eval()
    vae = KLVAE(AutoencoderConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                                  attn_resolutions=(8,), resolution=16)).eval()
    rng = np.random.default_rng(seed)
    shape = (3, 8, 8, 4)
    init = rng.standard_normal(shape).astype(np.float32)
    steps = rng.standard_normal((5, *shape)).astype(np.float32)
    images = {}
    before = kernels["flash_fwd"].launches
    for dev in ("cpu", "cuda"):
        diffusion = GaussianDiffusion(
            unet.to(dev), image_size=8, channels=4, timesteps=20,
            sampling_timesteps=5, objective="pred_v", auto_normalize=False,
            device=torch.device(dev))
        z = diffusion.ddim_sample(shape, torch.tensor([0, 2, 1]),
                                  cond_scale=3.0, rescaled_phi=0.7,
                                  init_noise=init, step_noise=steps)
        with torch.inference_mode():
            images[dev] = vae.to(dev).decode_latents(z).float().cpu()
    launched = kernels["flash_fwd"].launches - before
    err = (images["cuda"] - images["cpu"]).abs().max().item()
    print(f"small pipeline, card vs CPU: max|image diff|={err:.3e} "
          f"({launched} kernel launches on the card)")
    if not torch.isfinite(images["cuda"]).all() or err > 1e-3 \
            or launched != 5 * 1 + 3:
        fail("the slice on the card disagrees with the CPU, or skipped the "
             "kernel (expected 5 U-Net + 3 VAE attention launches)")


def run_generate(torch, argv):
    """generate.main(argv) -> (its result, host seconds of the whole call)."""
    from vqgan_tpu_torch import generate

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = generate.main(argv)
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def check_images(paths, n_expected):
    from PIL import Image

    if len(paths) != n_expected:
        fail(f"expected {n_expected} images, got {len(paths)}")
    for p in paths:
        if not p.exists() or p.parent.name[:3] != "ID_" \
                or not p.name.startswith("generated_"):
            fail(f"unexpected output path {p}")
        arr = np.asarray(Image.open(p), dtype=np.float32)
        if arr.shape != (256, 256, 3) or not np.isfinite(arr).all():
            fail(f"bad image {p}: shape {arr.shape}")


def drive_main_path(torch, kernels, seed: int):
    """Full-width generation; returns (launches by shape, samples/s)."""
    flash = kernels["flash_fwd"]
    batch = 16
    common = ["--random_init", "--seed", str(seed), "--batch_size",
              str(batch), "--num_images", str(batch)]
    if OUT.exists():
        shutil.rmtree(OUT)

    # untimed warm-up batch: cuDNN picks its algorithms, caches fill
    run_generate(torch, [*common, "--output_dir", str(OUT / "warmup"),
                         "--user_ids", "1", "--num_images", "2",
                         "--batch_size", "2"])

    runs = [("cond_scale 1.0", ["--user_ids", "1", "2", "--cond_scale", "1.0"],
             2),
            ("cond_scale 3.0", ["--user_ids", "3", "--cond_scale", "3.0",
                                "--rescaled_phi", "0.7"], 1)]
    by_shape = {}
    rates = {}
    for label, extra, n_batches in runs:
        for k in kernels.values():
            k.launches = 0
            k.launches_by_shape.clear()
        result, secs = run_generate(
            torch, [*common, *extra, "--output_dir", str(OUT / "generated")])
        launches = flash.launches
        shapes = dict(flash.launches_by_shape)
        check_images(result["images"], n_batches * batch)
        batch_secs = sum(result["batch_seconds"])
        rates[label] = n_batches * batch / batch_secs
        print(f"generate {label}: {n_batches} batch(es) of {batch} in "
              f"{batch_secs:.3f} s = {rates[label]:.4f} samples/s (whole "
              f"call with model set-up {secs:.3f} s); flash_fwd launches "
              f"{launches} by shape {shapes}")
        if launches != 151 * n_batches:
            fail(f"flash_fwd launched {launches} times for {n_batches} "
                 f"batch(es); expected 151 per batch")
        for shape, n in shapes.items():
            by_shape[shape] = by_shape.get(shape, 0) + n
    return by_shape, rates


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels; skip generation")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    from vqgan_tpu_torch.device import set_full_fp32_precision
    from vqgan_tpu_torch.kernels import KERNELS, build_all

    if not torch.cuda.is_available():
        fail("no CUDA device")
    card = card_line()
    print(f"card: {card}")
    name = torch.cuda.get_device_name(0)
    peaks = peaks_for(name)
    set_full_fp32_precision()
    t0 = time.perf_counter()
    build_all(KERNELS.values())
    print(f"kernel build: {time.perf_counter() - t0:.3f} s "
          f"({', '.join(KERNELS)})")
    for kname, k in KERNELS.items():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {kname} ptxas: {line.strip()}")

    rows = check_flash_fwd(torch, peaks, args.seed)
    check_small_pipeline(torch, KERNELS, args.seed)

    if not args.kernels_only:
        by_shape, rates = drive_main_path(torch, KERNELS, args.seed)
        for row in rows.values():
            row["launches"] = by_shape.get(row["key"], 0)
            if not row["launches"]:
                fail(f"main-path shape {row['shape']} never reached the "
                     f"kernel: {by_shape}")
        print("samples/s: " + json.dumps(rates))

    for row in rows.values():
        del row["key"]
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
