"""Roofline attribution for the stage-1 VQ-GAN training step (BASELINE
config #2: 128 px, codebook 8192 x 256, batch 8).

    python3 -m vqgan_tpu_torch.profile_training [--iters 20] [--out FILE]

Counterpart of cli/profile_training.py. Builds VQGANConfig's models at
those sizes (bf16 compute, fp32 parameters) with random weights from
`SEED` and a batch of random images, and reports for each program, as
one JSON record each (keys as the JAX CLI's, but for the compute bound,
which is the tensor cores' and not the TPU's MXU: `t_tensor_core_ms` and
`bound` "tensor_core" or "hbm"; `utils/flops.roofline`):

  flops / bytes    FLOPs (`utils/flops.count_work`: convolutions by
                   in-image taps, the kernels by their formulas) and the
                   least bytes (state and batch read once, what it updates
                   or returns written once)
  t_measured       host wall ms per call, the device synchronised
  t_tensor_core /  FLOPs over the card's peak at the program's dtype /
  t_hbm            bytes over its memory rate (`utils/flops.PEAKS`)
  bound            which bound dominates, and the achieved share of it

Programs: the G step and the D step of the split dispatch
(`make_vqgan_split_steps`, the step at `disc_start` so both losses are
live) and their sum; the host floor (a trivial program timed the same
way); the device-only chains, where the port's captured scan mode
(`make_vqgan_scan_steps`, one step's CUDA graph replayed per step) takes
the place of the JAX CLI's in-jit `lax.scan`: `CHAIN` G steps and `CHAIN`
G + D steps (the D step's device time is their difference); the attribution; and the forward-only constituents (VQ-VAE,
LPIPS, the discriminator with its running statistics). Each step's count
is one real eager call (`fake=False`: a step updates its parameters and
moments in place, which fake tensors cannot stand in for); the forwards
are counted under fake tensors. A chain's count is its step's times the
trips: replays dispatch nothing a counter sees, and the product is exact
(`flops_true` and `mfu_true` repeat `flops` and `mfu` to keep the JAX
CLI's keys). Writes the records to `--out` (by default under
results/roofline_torch/, not the JAX CLI's file).

Runs on the GPU by default (`--device cpu` runs it on the CPU, where it
gives counts and host times and no device metric).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import torch

from .configs.vqgan_config import VQGANConfig
from .device import resolve_device, set_full_fp32_precision
from .kernels import KERNELS
from .training.vqgan_trainer import VQGANTrainer
from .utils.flops import count_work, peak_tflops, roofline

__all__ = ["main", "parse_args", "OUT"]

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "results" / "roofline_torch" / "training_roofline.json"

# BASELINE config #2 sizes (the JAX CLI's)
IMAGE_SIZE, CODEBOOK, EMBED_DIM, BATCH = 128, 8192, 256, 8
# steps per captured chain and timed runs of each chain (the JAX CLI's)
CHAIN, CHAIN_ITERS = 10, 5
SEED = 0  # of the weights and the images


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--image_size", type=int, default=IMAGE_SIZE)
    ap.add_argument("--codebook", type=int, default=CODEBOOK)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(OUT))
    return ap.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(fn, iters: int, device, warmup: int = 1) -> tuple:
    """(host seconds per call of `fn` over `iters` calls after `warmup`
    calls, the device synchronised at both ends; {kernel: launches per
    call} of the hand-written kernels over all the calls)."""
    before = {n: k.launches for n, k in KERNELS.items()}
    for _ in range(warmup):
        fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    seconds = (time.perf_counter() - t0) / iters
    return seconds, {n: (k.launches - before[n]) / (warmup + iters)
                     for n, k in KERNELS.items() if k.launches != before[n]}


def main(argv=None) -> list:
    """Run the profile; returns the records (each also printed)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_full_fp32_precision()
    batch, chain = args.batch, CHAIN
    records = []

    def emit(rec):
        print(json.dumps(rec))
        records.append(rec)
        return rec

    with tempfile.TemporaryDirectory(prefix="profile_training_") as work:
        cfg = VQGANConfig(
            image_size=args.image_size, num_embeddings=args.codebook,
            embedding_dim=EMBED_DIM, batch_size=batch, seed=SEED,
            images_per_user_train=300,  # the codebook's dataset check
            results_folder=work)
        trainer = VQGANTrainer(cfg, device=device)
        dtype = cfg.compute_dtype  # the compute bound's rate
        state = trainer.state
        state.step = cfg.disc_start
        gen = torch.Generator(device).manual_seed(SEED + 3)
        s = args.image_size
        images = torch.rand((batch, s, s, cfg.in_channels), generator=gen,
                            device=device)

        def g_call():
            return trainer.g_step(state, images)[0]

        recon = None
        for _ in range(3):  # warm-up: the optimizers' moments exist
            recon = g_call()
            trainer.d_step(state, images, recon)
        g_flops, g_bytes = count_work(g_call, fake=False)
        recon = g_call()
        d_flops, d_bytes = count_work(trainer.d_step, state, images, recon,
                                      fake=False)
        g_dt, g_launches = measure(g_call, args.iters, device, warmup=0)
        d_dt, d_launches = measure(
            lambda: trainer.d_step(state, images, recon), args.iters,
            device, warmup=0)
        emit({**roofline(
            "g_step (VQ-VAE fwd + LPIPS + disc fwd + full backward + Adam)",
            g_flops, g_bytes, g_dt, batch, dtype, device),
            "counted": "one eager call", "kernel_launches": g_launches})
        emit({**roofline(
            "d_step (disc real/fake fwd + backward + Adam)", d_flops,
            d_bytes, d_dt, batch, dtype, device),
            "counted": "one eager call", "kernel_launches": d_launches})

        peak = peak_tflops(device)
        tot_dt, tot_flops = g_dt + d_dt, g_flops + d_flops
        tot = roofline("dispatch_step = g_step + d_step (steady state)",
                       tot_flops, g_bytes + d_bytes, tot_dt, batch, dtype,
                       device)
        emit({"program": tot["program"],
              "t_measured_ms": tot["t_measured_ms"],
              "images_per_sec": round(batch / tot_dt, 2),
              "flops": tot_flops, "bytes": g_bytes + d_bytes,
              "mfu": tot["mfu"], "hbm_util": tot["hbm_util"],
              "roofline_fraction": tot.get("roofline_fraction"),
              "g_share_of_time": round(g_dt / tot_dt, 4),
              "g_share_of_flops": round(g_flops / tot_flops, 4)})

        # the host floor: a trivial program timed in the same loop style
        tiny = torch.zeros((8,), device=device)
        f_flops, f_bytes = count_work(lambda: tiny + 1.0)
        f_dt, launched = measure(lambda: tiny + 1.0, 50, device)
        floor = emit({**roofline(
            "host dispatch floor (trivial program)", f_flops, f_bytes, f_dt,
            1, dtype, device), "kernel_launches": launched})

        # device-only: the captured scan mode, one step's graph per step
        scan = VQGANTrainer(cfg, device=device, step_mode="scan",
                            scan_block=chain)
        superbatch = images.expand(chain, *images.shape).contiguous()
        chains = {}
        for label, step, n_flops, n_bytes in (
                ("g_step", 0, g_flops, g_bytes),
                ("g_and_d_step", cfg.disc_start, tot_flops,
                 g_bytes + d_bytes)):
            def run(step=step):
                scan.state.step = step
                return scan.dispatch_block(superbatch, step)

            run()  # the capture (eager warm-up, then the graph)
            dt, launched = measure(run, CHAIN_ITERS, device)
            rec = emit({**roofline(
                f"{label} x{chain} captured (device-only per step)",
                n_flops * chain, n_bytes * chain, dt, batch * chain, dtype,
                device),
                "counted": f"one eager step x {chain}",
                "kernel_launches": launched})
            rec["flops_true"], rec["mfu_true"] = rec["flops"], rec["mfu"]
            rec["scan_body_counted_once_by_xla"] = False
            chains[label] = rec

        g_dev = chains["g_step"]["t_measured_ms"] / chain / 1e3
        gd_dev = chains["g_and_d_step"]["t_measured_ms"] / chain / 1e3
        d_dev = gd_dev - g_dev
        emit({
            "program": "dispatch_step device-only attribution",
            "host_floor_ms_per_call": floor["t_measured_ms"],
            "g_device_ms": round(g_dev * 1e3, 3),
            "d_device_ms": round(d_dev * 1e3, 3),
            "g_host_overhead_ms": round((g_dt - g_dev) * 1e3, 3),
            "d_host_overhead_ms": round((d_dt - d_dev) * 1e3, 3),
            "images_per_sec_device_only": round(batch / gd_dev, 2),
            "mfu_device_only": (round(tot_flops / gd_dev / (peak * 1e12), 6)
                                if peak else None),
            "hbm_util_device_only": chains["g_and_d_step"]["hbm_util"],
            "note": "device-only = per-step time in a captured chain (one "
                    "step's CUDA graph replayed per step); D = the G + D "
                    "chain less the G chain. The gap to the per-call rows "
                    "is the host's dispatch of the eager steps.",
        })
        del scan

        # forward-only constituents (where the FLOPs come from)
        nchw = images.permute(0, 3, 1, 2)
        disc = trainer.disc

        def disc_eval(x):
            was = disc.training
            disc.eval()
            try:
                return disc(x)
            finally:
                disc.train(was)

        for name, fn, fargs in (
                ("vqvae forward (encode+VQ+decode+losses)", trainer.vqvae,
                 (nchw,)),
                ("LPIPS forward (VGG16 on both inputs)", trainer.lpips,
                 (nchw, nchw)),
                ("discriminator forward (eval stats)", disc_eval,
                 (nchw,))):
            with torch.no_grad():
                flops, n_bytes = count_work(fn, *fargs)
                dt, launched = measure(lambda: fn(*fargs), 10, device)
            emit({**roofline(name, flops, n_bytes, dt, batch, dtype,
                             device), "kernel_launches": launched})

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(records, indent=1))
    print(f"wrote {out_path}")
    return records


if __name__ == "__main__":
    main()
