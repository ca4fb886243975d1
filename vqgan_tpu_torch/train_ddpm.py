"""Unconditional DDPM training on an image folder.

    python -m vqgan_tpu_torch.train_ddpm --folder images
    python -m vqgan_tpu_torch.train_ddpm --folder images --resume -1

Counterpart of cli/train_ddpm.py, with its flags and defaults: the bf16
U-Net (dim 64, mults 1-2-4-8, full attention in the innermost stage) at
128 px, GaussianDiffusion with T 1000, DDIM-250 grids, pred_v, sigmoid
betas, DDIM eta 0, auto-normalisation; batch 16, lr 8e-5, EMA 0.995, 25
samples per grid; optional self-conditioning, immiscible noise (scipy's
exact assignment on the host, as the JAX CLI's default), offset noise, and
FID at each milestone with best/latest-only retention.
`--inception_weights` is a torchvision / pytorch-fid InceptionV3 state
dict (`.pt`); without it the FID uses a random-init Inception and is not
calibrated. `--resume` takes the port's `model-{m}.pt` and the JAX
package's Orbax `model-{m}/` alike (its optax state mapped onto the
port's optimizer), printing the step.

Under torchrun each process takes one GPU and joins an NCCL group (gloo
with `--device cpu`), and the trainer is data parallel over the ranks, as
the JAX CLI's mesh (`training/ddpm_trainer.py`); every rank computes
its share of the dataset statistics and of each FID's samples, and rank 0
writes the grids and checkpoints:

    torchrun --nproc_per_node 4 -m vqgan_tpu_torch.train_ddpm \
        --folder images --self_condition --immiscible

Runs on the GPU by default (`--device cpu` to run on the CPU), with TF32
off for fp32 matmuls and convolutions.
"""

from __future__ import annotations

import argparse

__all__ = ["main", "parse_args", "build"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--folder", required=True)
    ap.add_argument("--results_folder", default="./results/ddpm")
    ap.add_argument("--image_size", type=int, default=128)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--dim_mults", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--timesteps", type=int, default=1000)
    ap.add_argument("--sampling_timesteps", type=int, default=250)
    ap.add_argument("--objective", default="pred_v",
                    choices=["pred_noise", "pred_x0", "pred_v"])
    ap.add_argument("--beta_schedule", default="sigmoid",
                    choices=["linear", "cosine", "sigmoid"])
    ap.add_argument("--train_batch_size", type=int, default=16)
    ap.add_argument("--train_lr", type=float, default=8e-5)
    ap.add_argument("--train_num_steps", type=int, default=100000)
    ap.add_argument("--ema_decay", type=float, default=0.995)
    ap.add_argument("--save_and_sample_every", type=int, default=1000)
    ap.add_argument("--num_samples", type=int, default=25)
    ap.add_argument("--self_condition", action="store_true")
    ap.add_argument("--immiscible", action="store_true")
    ap.add_argument("--offset_noise_strength", type=float, default=0.0)
    ap.add_argument("--calculate_fid", action="store_true")
    ap.add_argument("--num_fid_samples", type=int, default=50000)
    ap.add_argument("--save_best_and_latest_only", action="store_true")
    ap.add_argument("--inception_weights", default=None,
                    help="torchvision / pytorch-fid InceptionV3 state dict "
                         "(.pt)")
    ap.add_argument("--resume", type=int, default=None,
                    help="milestone to resume from (a .pt file of the port "
                         "or an Orbax directory of the JAX package); -1 "
                         "for the latest")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args, device):
    """(the bf16 Unet on `device`, its GaussianDiffusion) from the flags;
    the weights from `args.seed`."""
    import torch

    from .diffusion import GaussianDiffusion
    from .models import Unet

    torch.manual_seed(args.seed)
    model = Unet(dim=args.dim, dim_mults=tuple(args.dim_mults), channels=3,
                 self_condition=args.self_condition,
                 dtype=torch.bfloat16).to(device)
    diffusion = GaussianDiffusion(
        model, image_size=args.image_size, channels=3,
        timesteps=args.timesteps, sampling_timesteps=args.sampling_timesteps,
        objective=args.objective, beta_schedule=args.beta_schedule,
        ddim_sampling_eta=0.0, immiscible=args.immiscible,
        offset_noise_strength=args.offset_noise_strength,
        self_condition=args.self_condition, auto_normalize=True,
        device=device)
    return model, diffusion


def main(argv=None) -> dict:
    """Train. Returns the trainer's `train` result (every step's loss, and
    images/s after the warm-up) with the trainer under "trainer"."""
    args = parse_args(argv)

    from .device import resolve_device, set_full_fp32_precision
    from .parallel.init import initialize_distributed
    from .training.ddpm_trainer import FolderDataset, Trainer

    device = resolve_device(args.device)
    initialize_distributed(device)  # a no-op outside torchrun
    set_full_fp32_precision()
    model, diffusion = build(args, device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"U-Net parameters: {n_params / 1e6:.1f}M")

    fid_eval = None
    if args.calculate_fid:  # each rank its share of the images
        import torch

        from .data import BatchLoader
        from .eval.fid import (FIDEvaluation, make_inception_feature_fn,
                               rank_batches)

        state_dict = None
        if args.inception_weights:
            state_dict = torch.load(args.inception_weights,
                                    map_location="cpu", weights_only=True)
        else:
            print("warning: FID uses a random-init Inception "
                  "(pass --inception_weights for calibrated scores)")
        fid_eval = FIDEvaluation(
            make_inception_feature_fn(state_dict, device=device),
            batch_size=args.train_batch_size,
            num_fid_samples=args.num_fid_samples,
            stats_path=f"{args.results_folder}/dataset_stats.npz")
        real = FolderDataset(args.folder, args.image_size)
        real.paths = [p for a, b in rank_batches(
            len(real.paths), args.train_batch_size) for p in real.paths[a:b]]
        loader = BatchLoader(real, args.train_batch_size, shuffle=False,
                             drop_last=False)
        fid_eval.load_or_precalc_real_stats(img for img, _ in iter(loader))

    trainer = Trainer(
        diffusion, model, args.folder,
        train_batch_size=args.train_batch_size, train_lr=args.train_lr,
        train_num_steps=args.train_num_steps, ema_decay=args.ema_decay,
        save_and_sample_every=args.save_and_sample_every,
        num_samples=args.num_samples, results_folder=args.results_folder,
        calculate_fid=args.calculate_fid, fid_evaluator=fid_eval,
        save_best_and_latest_only=args.save_best_and_latest_only,
        seed=args.seed)
    if args.resume is not None:
        step = trainer.load(None if args.resume < 0 else args.resume)
        print(f"resumed from step {step}")
    result = trainer.train()
    if result["images_per_s"] is not None:
        print(f"{result['timed_steps']} steps after warm-up: "
              f"{result['images_per_s']:.2f} images/s")
    return {**result, "trainer": trainer}


if __name__ == "__main__":
    main()
