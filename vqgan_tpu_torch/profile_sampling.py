"""Roofline attribution for the sampling paths (BASELINE configs #4 and #5).

    python3 -m vqgan_tpu_torch.profile_sampling [--batch 16] [--steps 150] \
        [--cond_scale 1.0] [--trace] [--out FILE]

Counterpart of cli/profile_sampling.py. For each timed program it reports,
as one JSON record (`utils/flops.roofline`; keys as the JAX CLI's but for
the compute bound, `t_tensor_core_ms` and `bound` "tensor_core" or "hbm"):
FLOPs and least bytes (`utils/flops.count_work` of the eager body, under
fake tensors), the host wall ms per run (device synchronised), the bounds
at the card's peaks, the achieved share of the larger one, MFU and
arithmetic intensity.

cfg4: LDMConfig's CFG U-Net (dim 96, mults 1-2-4-4, 8 heads x 64, bf16)
and the KL-VAE in bf16 (as the JAX CLI builds it), random weights from
`SEED`, batch `--batch`, DDIM-`--steps` at `--cond_scale`: the full
pipeline (DDIM + decode), DDIM alone, the decode alone, one
`model_predictions` call (the sampler step's network call), and the
attribution of the chain's per-step time to that call's bounds. cfg5: the
Karras U-Net (dim 64, 64 px, 31 classes, bf16) under EDM Heun-32, and one
preconditioned forward, with its attribution. The samplers run as the port
runs them by default on the card: each step a replay of one captured CUDA
graph (`graph=None`); the first call (the capture) is untimed, then
`ITERS` timed runs. A replay dispatches nothing a counter sees, so each
chain's count is its eager body's times the steps, which is exact
(Heun: two preconditioned forwards a step); `flops_true` and `mfu_true`
repeat `flops` and `mfu` to keep the JAX CLI's keys. A chain's bytes are
its body's times the steps (the weights are read again each step) plus the
decode's. `--trace` writes a torch.profiler trace of one full pipeline
run to `TRACE_DIR`. Writes the records to `--out` (by default under
results/roofline_torch/, not the JAX CLI's file).

Runs on the GPU by default (`--device cpu` runs it on the CPU, where it
gives counts and host times and no device metric; the CPU runs the
samplers eagerly).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from .bench_edm import build as build_karras
from .configs import LDMConfig
from .device import resolve_device, set_full_fp32_precision
from .generate import load_model
from .models import KLVAE
from .models.autoencoder import AutoencoderConfig
from .profile_training import OUT as TRAINING_OUT
from .profile_training import measure
from .utils.flops import count_work, roofline
from .utils.profiling import trace

__all__ = ["main", "parse_args", "OUT"]

OUT = TRAINING_OUT.parent / "sampling_roofline.json"
TRACE_DIR = TRAINING_OUT.parent / "profiler_trace"
ITERS = 3  # timed runs of each program (the JAX CLI's)
KARRAS_STEPS = 32  # EDM Heun steps of cfg5 (the JAX CLI's)
SEED = 0  # of the weights, the inputs and the samplers' draws


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--cond_scale", type=float, default=1.0)
    ap.add_argument("--trace", action="store_true",
                    help="also write a torch.profiler trace of the pipeline")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(OUT))
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Run the profile; returns the records (each also printed)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_full_fp32_precision()
    b, steps = args.batch, args.steps
    records = []

    def emit(rec):
        print(json.dumps(rec))
        records.append(rec)
        return rec

    def timed(name, fn, flops, n_bytes, chain=False):
        """Time `fn` and emit its record, with its kernels' launches per
        call."""
        dt, launched = measure(fn, ITERS, device)
        rec = {**roofline(name, flops, n_bytes, dt, b, device=device),
               "kernel_launches": launched}
        if chain:
            rec["flops_true"], rec["mfu_true"] = rec["flops"], rec["mfu"]
            rec["scan_body_counted_once_by_xla"] = False
        return emit(rec)

    # --- config #4 ---------------------------------------------------------
    cfg = LDMConfig(sampling_timesteps=steps)
    torch.manual_seed(SEED)
    diffusion, _ = load_model(cfg, device=device)
    vae = KLVAE(AutoencoderConfig(resolution=cfg.image_size,
                                  z_channels=cfg.latent_channels),
                dtype=torch.bfloat16).to(device).eval()
    classes = torch.arange(b, device=device) % cfg.num_users
    s, c = cfg.latent_size, cfg.latent_channels
    gen = torch.Generator(device).manual_seed(SEED + 3)
    x = torch.randn((b, c, s, s), generator=gen, device=device)
    t = torch.full((b,), cfg.timesteps // 2, dtype=torch.long,
                   device=device)
    latents = torch.randn((b, s, s, c), generator=gen, device=device) * 0.5

    def sample():
        return diffusion.sample(classes=classes, cond_scale=args.cond_scale,
                                rescaled_phi=cfg.rescaled_phi,
                                generator=torch.Generator(device)
                                .manual_seed(SEED + 1))

    def decode(z):
        with torch.inference_mode():
            return vae.decode_latents(z)

    def pipeline():
        return decode(sample())

    def body():
        with torch.inference_mode():
            return diffusion.model_predictions(
                x, t, classes, cond_scale=args.cond_scale,
                rescaled_phi=cfg.rescaled_phi, clip_x_start=True)

    body_flops, body_bytes = count_work(body)
    dec_flops, dec_bytes = count_work(decode, latents)
    sample()  # the capture of the step's graph
    timed(f"cfg4 full pipeline (DDIM-{steps} + VAE decode, b{b}, "
          f"cond_scale={args.cond_scale})", pipeline,
          steps * body_flops + dec_flops, steps * body_bytes + dec_bytes,
          chain=True)
    scan = timed(f"cfg4 DDIM-{steps} captured chain only", sample,
                 steps * body_flops, steps * body_bytes, chain=True)
    timed("cfg4 VAE decode only", lambda: decode(latents), dec_flops,
          dec_bytes)
    one = timed("cfg4 single U-Net forward (the chain step's network "
                "call)", body, body_flops, body_bytes)
    per_step_ms = scan["t_measured_ms"] / steps
    bound_ms = max(one["t_tensor_core_ms"] or 0.0, one["t_hbm_ms"] or 0.0)
    emit({
        "program": "cfg4 chain attribution",
        "scan_ms": scan["t_measured_ms"], "steps": steps,
        "per_step_in_scan_ms": round(per_step_ms, 3),
        "standalone_body_ms": one["t_measured_ms"],
        "body_t_tensor_core_ms": one["t_tensor_core_ms"],
        "body_t_hbm_ms": one["t_hbm_ms"],
        "per_step_vs_body_roofline": (round(bound_ms / per_step_ms, 6)
                                      if bound_ms else None),
        "note": "per step in the captured chain below the standalone call "
                "means the replay saves the host's dispatch; the ratio to "
                "the body's bound is the share of the card's peak each "
                "step reaches.",
    })
    if args.trace:
        with trace(TRACE_DIR):
            pipeline()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        print(f"trace written to {TRACE_DIR}")
    del diffusion, vae

    # --- config #5 (EDM Heun, the Karras U-Net) ---------------------------
    karras_args = argparse.Namespace(
        seed=SEED, image_size=64, dim=64, num_classes=31, batch=b,
        num_sample_steps=KARRAS_STEPS)
    _, ed = build_karras(karras_args, device)
    n5 = KARRAS_STEPS
    noised = torch.zeros((b, 3, 64, 64), device=device)
    sigma = torch.ones((b,), device=device)

    def kfwd():
        with torch.inference_mode():
            return ed.preconditioned_forward(noised, sigma, clamp=True)

    k_flops, k_bytes = count_work(kfwd)

    def heun():
        return ed.sample(batch_size=b, generator=torch.Generator(device)
                         .manual_seed(SEED + 2))

    heun()  # the capture
    heun_rec = timed(f"cfg5 EDM Heun-{n5} (KarrasUnet dim=64 @64px, b{b})",
                     heun, 2 * n5 * k_flops, 2 * n5 * k_bytes, chain=True)
    fwd = timed("cfg5 single Karras U-Net forward (preconditioned)", kfwd,
                k_flops, k_bytes)
    per_nfe = heun_rec["t_measured_ms"] / (2 * n5)
    bound_ms = max(fwd["t_tensor_core_ms"] or 0.0, fwd["t_hbm_ms"] or 0.0)
    emit({
        "program": "cfg5 Heun attribution",
        "per_nfe_in_scan_ms": round(per_nfe, 3),
        "standalone_fwd_ms": fwd["t_measured_ms"],
        "fwd_t_tensor_core_ms": fwd["t_tensor_core_ms"],
        "fwd_t_hbm_ms": fwd["t_hbm_ms"],
        "per_nfe_vs_fwd_roofline": (round(bound_ms / per_nfe, 6)
                                    if bound_ms else None),
        "note": "two preconditioned forwards per Heun step; the ratio is "
                "the share of the forward's bound each captured NFE "
                "reaches.",
    })

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(records, indent=1))
    print(f"wrote {out_path}")
    return records


if __name__ == "__main__":
    main()
