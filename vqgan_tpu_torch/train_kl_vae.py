"""Stage-1 KL-VAE training.

    python -m vqgan_tpu_torch.train_kl_vae --data_path data/Normal_line \\
        --split data_split.json --results_folder results/kl_vae

Counterpart of cli/train_kl_vae.py, with its flags: the default KL-VAE
(`AutoencoderConfig()` at `--image_size`, `--latent_channels` latent
channels, fp32) trained on the split's training images with `kl_vae_loss`
(MSE, or L1 + `--perceptual_weight` x LPIPS with `--lpips_weights`, the
`.npz` that `train_vqgan` reads), Adam after a global-norm clip of 1.0 at a
constant or warmup-cosine learning rate, and milestone checkpoints
`kl_vae-{m}.pt` every `--save_every` steps: {"model": the state dict},
which `generate.load_vae`, `preprocess_latents` and `vae_reconstruction`
read, beside `kl_vae-{m}.config.json`. As in the JAX CLI there is no
resume, and no checkpoint off the save cadence.

The JAX CLI replicates the state over a mesh and places each batch
P("data"). Here, under torchrun, each process takes one GPU and joins an
NCCL group (gloo with `--device cpu`); every rank reads the same global
batch from the same seeded loader and steps on its rows, with the
posterior noise of the global batch and the gradients averaged over the
ranks (`training/kl_vae_step.py`), and rank 0 writes the milestones:

    torchrun --nproc_per_node 4 -m vqgan_tpu_torch.train_kl_vae ...

Runs on the GPU by default (`--device cpu` to run on the CPU), with TF32
off for fp32 matmuls and convolutions.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .checkpoint.manager import CheckpointManager
from .data import BatchLoader, ImageFolderDataset, load_split
from .device import resolve_device, set_full_fp32_precision
from .models.autoencoder import AutoencoderConfig, KLVAE
from .models.lpips import LPIPS
from .parallel.init import barrier, initialize_distributed
from .parallel.mesh import (
    is_main_process,
    local_rows,
    make_mesh_for_batch,
    replicate_module,
)
from .train_vqgan import read_lpips_npz
from .training.kl_vae_step import (
    lpips_perceptual_fn,
    make_kl_vae_optimizer,
    make_kl_vae_train_step,
)

__all__ = ["main", "parse_args", "train"]

# steps before the images/s window opens (cuDNN's first calls, the loader)
TIMING_WARMUP = 5


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--split", required=True)
    ap.add_argument("--results_folder", default="./results/kl_vae")
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--latent_channels", type=int, default=4)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=4.5e-6)
    ap.add_argument("--lr_schedule", choices=["constant", "cosine"],
                    default="constant",
                    help="cosine: linear warmup (5%% of steps) then cosine "
                         "decay to lr/20")
    ap.add_argument("--train_steps", type=int, default=50000)
    ap.add_argument("--kl_weight", type=float, default=1e-6)
    ap.add_argument("--perceptual_weight", type=float, default=0.0,
                    help="LPIPS weight (needs --lpips_weights for calibrated"
                         " loss)")
    ap.add_argument("--lpips_weights", default=None,
                    help=".npz of exported VGG16 + lpips weights")
    ap.add_argument("--save_every", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train the default KL-VAE. Returns `train`'s result."""
    args = parse_args(argv)
    result = train(args, AutoencoderConfig(resolution=args.image_size,
                                           z_channels=args.latent_channels))
    if result["images_per_s"] is not None:
        print(f"{result['timed_steps']} steps after warm-up: "
              f"{result['images_per_s']:.2f} images/s")
    return result


def train(args, ae_config: AutoencoderConfig) -> dict:
    """Train a KL-VAE of `ae_config` as `args` say. Returns {"losses",
    "rec_losses", "kl_losses": every step's, "timed_steps",
    "timed_seconds", "images_per_s", "peak_memory_bytes" (CUDA only),
    "vae"}: images/s over the host seconds of the steps after the first
    `TIMING_WARMUP`, the device synchronised at both ends, saves
    excluded. Under torchrun, data parallel over the ranks (see the module
    docstring); the losses are the global batch's on every rank."""
    device = resolve_device(args.device)
    initialize_distributed(device)  # a no-op outside torchrun
    set_full_fp32_precision()
    mesh = (make_mesh_for_batch(args.batch_size, device=device)
            if torch.distributed.is_initialized() else None)
    main_rank = is_main_process()
    torch.manual_seed(args.seed)  # initial weights
    vae = KLVAE(ae_config).to(device)
    if mesh is not None:  # every rank starts from rank 0's values
        replicate_module(vae, mesh)

    perceptual_fn = None
    if args.perceptual_weight > 0:
        lpips = LPIPS()
        if args.lpips_weights:
            weights = read_lpips_npz(args.lpips_weights)
            lpips.load_torch_weights(weights["vgg"], weights["lin"])
        else:
            print("warning: LPIPS running with random weights")
        lpips = lpips.to(device).eval().requires_grad_(False)
        if mesh is not None:
            replicate_module(lpips, mesh)
        perceptual_fn = lpips_perceptual_fn(lpips, args.perceptual_weight)

    optimizer = make_kl_vae_optimizer(vae.parameters(), args.lr,
                                      args.lr_schedule, args.train_steps)
    train_step = make_kl_vae_train_step(vae, optimizer,
                                        kl_weight=args.kl_weight,
                                        perceptual_fn=perceptual_fn,
                                        mesh=mesh)
    dataset = ImageFolderDataset(args.data_path, load_split(args.split),
                                 "train", image_size=args.image_size)
    loader = BatchLoader(dataset, args.batch_size, repeat=True,
                         seed=args.seed)
    ckpt = CheckpointManager(args.results_folder, prefix="kl_vae")
    config = {**vars(args), "autoencoder": dataclasses.asdict(ae_config)}
    generator = torch.Generator(device).manual_seed(args.seed + 2)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # (loss, rec_loss, kl_loss) of every step, kept on the device
    history = torch.zeros((args.train_steps, 3), device=device)
    batches = iter(loader)
    timed_from, timed_seconds = None, 0.0
    try:
        for step in range(args.train_steps):
            if step == TIMING_WARMUP:
                sync()
                timed_from = time.perf_counter()
            images, _ = next(batches)
            images = torch.from_numpy(images)
            if mesh is not None:
                images = local_rows(images, mesh)
            parts = train_step(images.to(device), generator=generator)
            history[step] = torch.stack(
                [parts["loss"], parts["rec_loss"], parts["kl_loss"]])
            if (step + 1) % 50 == 0 and main_rank:
                loss, rec, kl = history[step].tolist()
                print(f"step {step + 1}: loss={loss:.5f} rec={rec:.5f} "
                      f"kl={kl:.1f}")
            if (step + 1) % args.save_every == 0:
                if timed_from is not None:
                    sync()
                    timed_seconds += time.perf_counter() - timed_from
                if main_rank:
                    ckpt.save((step + 1) // args.save_every,
                              {"model": vae.state_dict()}, config=config)
                if mesh is not None:
                    barrier()
                if timed_from is not None:
                    timed_from = time.perf_counter()
    finally:
        batches.close()  # stops the loader's thread
    sync()
    if timed_from is not None:
        timed_seconds += time.perf_counter() - timed_from
    timed_steps = max(args.train_steps - TIMING_WARMUP, 0)
    losses, rec_losses, kl_losses = history.cpu().T.tolist()
    print("done")
    return {"losses": losses, "rec_losses": rec_losses,
            "kl_losses": kl_losses, "timed_steps": timed_steps,
            "timed_seconds": timed_seconds,
            "images_per_s": (timed_steps * args.batch_size / timed_seconds
                             if timed_seconds else None),
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None),
            "vae": vae}


if __name__ == "__main__":
    main()
