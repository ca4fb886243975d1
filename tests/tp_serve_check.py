"""Tensor-parallel serving on several ranks against the artifact of whole
weights on the same mesh.

    python3 -m torch.distributed.run --nproc_per_node 4 \\
        tests/tp_serve_check.py                         # four GPUs, NCCL
    python3 -m torch.distributed.run --nproc_per_node 4 \\
        tests/tp_serve_check.py --device cpu --tiny     # gloo, the CPU

Rank 0 exports two serving artifacts of one seeded CFG U-Net (LDMConfig's
defaults: dim 96, mults 1-2-4-4, 8 heads x 64, random weights from seed
0) and KL-VAE decode, at batch 16 and cond_scale 3.0 over the DDIM-150
chain, on a mesh of 2 x 2 ranks ("data" x "model", JAX's order): "tp" with every TP kernel split
(`parallel.tp.tp_param_specs`), "whole" with the weights whole. Every
rank then loads both (the mesh built from meta.json over the process
group), runs an untimed call of each (on the card the captures: NCCL
runs the weights' gathers inside the graphs), then 4 calls of each in
turns (whole, tp, tp, whole, twice), captured on the card, from one
seed, cuDNN held to deterministic algorithms (each call must repeat the
first bit for bit). Per rank, one JSON line: the seconds of each call, the served
samples/s over the timed calls (the batch of 16 each rank returns, and
the rows it samples), the weight bytes its programs hold (and of them the split pieces, against
their whole bytes) for each artifact, the device bytes allocated when
each was loaded, and max |tp - whole| of the images (the gathered kernels
are the whole ones, so they should agree bit for bit). Then rank 0 prints
the summary line with "ok", false unless every rank's images agree within
rtol 1e-4, atol 1e-5 (tests/test_torch_port_tp_serving.py's rule) and
every rank holds half of the split kernels' bytes, and the card's name
and power limit where there is a card. `--tiny` uses a narrow U-Net and
KL-VAE at 64 px and a DDIM-5 chain (a CPU rehearsal).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vqgan_tpu_torch import export_serving  # noqa: E402
from vqgan_tpu_torch.build import build_cfg_unet_diffusion  # noqa: E402
from vqgan_tpu_torch.configs.ldm_config import LDMConfig  # noqa: E402
from vqgan_tpu_torch.device import set_full_fp32_precision  # noqa: E402
from vqgan_tpu_torch.models.autoencoder import (  # noqa: E402
    AutoencoderConfig,
    KLVAE,
)
from vqgan_tpu_torch.parallel import initialize_distributed  # noqa: E402
from vqgan_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from vqgan_tpu_torch.parallel.tp import tp_param_specs  # noqa: E402
from vqgan_tpu_torch.serving import (  # noqa: E402
    export_cfg_sampler,
    load_cfg_sampler,
)

BATCH, COND_SCALE, SEED = 16, 3.0, 0
DATA, MODEL = 2, 2
TURNS = 2  # of (whole, tp, tp, whole)
RTOL, ATOL = 1e-4, 1e-5
TINY = dict(dim=32, dim_mults=(1, 2), attn_heads=2, attn_dim_head=16,
            image_size=64, latent_size=8, sampling_timesteps=5,
            timesteps=20)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no card"


def export(args, device, out: Path) -> None:
    """The "tp" and "whole" artifacts into `out`, from one seeded model."""
    cfg = LDMConfig(**(TINY if args.tiny else {}))
    torch.manual_seed(SEED)
    _, diffusion = build_cfg_unet_diffusion(cfg, device=device)
    vae = KLVAE(AutoencoderConfig(
        resolution=cfg.image_size, z_channels=cfg.latent_channels,
        **(dict(ch=32, ch_mult=(1, 2, 2, 2)) if args.tiny else {})))
    vae = vae.to(device).eval()
    step, decode = export_serving.cfg_programs(diffusion, vae, COND_SCALE,
                                               0.7)
    mesh = Mesh({"data": DATA, "model": MODEL}, device)
    for name, specs in (("tp", {"step": tp_param_specs(step, mesh),
                                "decode": tp_param_specs(decode, mesh)}),
                        ("whole", None)):
        t0 = time.perf_counter()
        meta = export_cfg_sampler(
            step, decode, out / name, batch_size=BATCH,
            latent_shape=(diffusion.channels, diffusion.image_size,
                          diffusion.image_size),
            ddim_pairs=diffusion.ddim_time_pairs(), num_users=cfg.num_users,
            cond_scale=COND_SCALE, rescaled_phi=0.7, mesh=mesh,
            arg_specs=(("data",),) * 5, param_specs=specs,
            config=dataclasses.asdict(cfg))
        print(json.dumps({"export": name, "mesh": meta["mesh"],
                          "seconds": time.perf_counter() - t0,
                          "programs": meta["programs"]}), flush=True)


def serve(device, out: Path) -> dict:
    """This rank's line: both artifacts loaded and called in turns."""
    samplers, allocated = {}, {}
    for name in ("whole", "tp"):
        if device.type == "cuda":
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
        samplers[name] = load_cfg_sampler(out / name, device)
        if device.type == "cuda":
            torch.cuda.synchronize()
            allocated[name] = torch.cuda.memory_allocated() - before
    classes = torch.arange(BATCH, device=device) % 31

    def call(name):
        gen = torch.Generator(device=device).manual_seed(SEED + 1)
        images = samplers[name](classes, generator=gen)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return images

    images = {name: call(name) for name in samplers}  # the captures
    times = {name: [] for name in samplers}
    for _ in range(TURNS):
        for name in ("whole", "tp", "tp", "whole"):
            t0 = time.perf_counter()
            got = call(name)
            times[name].append(time.perf_counter() - t0)
            if not torch.equal(got, images[name]):
                raise AssertionError(f"{name}: a call differs from its "
                                     f"first")
    diff = (images["tp"] - images["whole"]).abs()
    mesh = samplers["tp"].mesh
    rank_rows = BATCH // mesh.shape["data"]
    return {
        "rank": dist.get_rank(), "coords": {a: mesh.coord(a)
                                            for a in mesh.axis_names},
        "seconds": times,
        "samples_per_s": {n: BATCH * len(ts) / sum(ts)
                          for n, ts in times.items()},
        "rank_rows_per_s": {n: rank_rows * len(ts) / sum(ts)
                            for n, ts in times.items()},
        "weight_bytes": {n: s.weight_bytes() for n, s in samplers.items()},
        "allocated_at_load": allocated,
        "max_abs_diff": diff.max().item(),
        "within_rule": bool(
            (diff <= ATOL + RTOL * images["whole"].abs()).all()),
        "finite": bool(torch.isfinite(images["tp"]).all()),
        "graph": device.type == "cuda"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    initialize_distributed(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    set_full_fp32_precision()
    # the KL-VAE decode's transposed convolution sums in a varying order
    # under cuDNN's default algorithms (the selftests pin it too)
    torch.backends.cudnn.deterministic = True
    if dist.get_world_size() != DATA * MODEL:
        raise SystemExit(f"{dist.get_world_size()} ranks for a mesh of "
                         f"{DATA} x {MODEL}")
    # rank 0's directory, which every rank reads
    with tempfile.TemporaryDirectory(prefix="tp_serve_") as tmp:
        box = [tmp]
        dist.broadcast_object_list(box, src=0)
        out = Path(box[0])
        if dist.get_rank() == 0:
            export(args, device, out)
        dist.barrier()
        line = serve(device, out)
        print(json.dumps(line), flush=True)
        lines = [None] * dist.get_world_size()
        dist.all_gather_object(lines, line)
        dist.barrier()  # every rank is done with rank 0's directory
    ok = all(r["within_rule"] and r["finite"]
             and r["weight_bytes"]["tp"]["split_held"] * MODEL
             == r["weight_bytes"]["tp"]["split_whole"] > 0 for r in lines)
    if dist.get_rank() == 0:
        print(card_line())
        print(json.dumps({"ok": ok, "ranks": len(lines),
                          "mesh": {"data": DATA, "model": MODEL},
                          "max_abs_diff": max(r["max_abs_diff"]
                                              for r in lines)}), flush=True)
    # no destroy_process_group, as the trainers under torchrun: on four
    # H100s, with the samplers' captured NCCL gathers alive, it did not
    # return
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
