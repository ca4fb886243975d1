"""Data-parallel training held to one process, through the entry points.

    python3 tests/dp_check.py --nproc 4              # four GPUs
    python3 tests/dp_check.py --nproc 2 --device cpu --tiny
    python3 tests/dp_check.py --witness              # one GPU

Writes a data set from `--seed` (31 users of 8 JPGs each, and a cache of
1550 latents), then runs each trainer's entry point twice on the same
global batches: under `torch.distributed.run` with `--nproc` processes
(one GPU each over NCCL, or gloo ranks of the CPU), and as one process:

- `train_vqgan --step_mode split` and `--step_mode scan` (batch 8);
- `train_kl_vae` (batch 8);
- `train_ddpm --self_condition --immiscible` (batch 16);
- `train_latent_cfg --param_sharding replicated`, `zero1`, `fsdp` and
  `fsdp_tp` (batch 8), in `--step_mode step` and `scan`, each held to the
  one-process replicated run of its step mode, and the sharded modes to
  the replicated one at `--nproc` (the same rows a rank: bit for bit
  where the step's math is the same; the sharded modes' clipping norm is
  summed from the ranks' pieces, so not bit for bit). Beside each rank's
  latents/s, on the card, each rank's bytes allocated on the device at
  the last step's start and at its peak (step mode), and in step mode
  the sharded modes' largest resident bytes as a share of replicated's.

Each pair's checkpoints after `--steps` steps are read back and compared:
bit for bit, or the weights' moves from the seeded start within 5% of the
move in norm (the norm part of the tests' whole-step rule). The share of
elements whose moves differ by more than 5% of the learning rate is
reported beside it: the tests hold it under 1% over their two or three
steps, but Adam's sign-like steps turn rounding-noise gradients into
moves of lr either way, and over more steps those flips add up (the ranks
sum the batch in another order, in bf16 at another batch shape a rank).
One JSON line per run (the distances, whether bit for bit, each rank's
images/s or latents/s as the entry point prints it), then a summary line
with "ok". `--tiny` trains narrow models at small sizes (a CPU rehearsal).

`--witness` tells rounding apart from the method for the VQ-GAN on one
card (or the CPU, with `--device cpu`): its split steps at full width
(batch 8, D and the adaptive weight from the second of `--steps` steps),
in bf16 and in fp32, as one process and on 2 gloo ranks sharing the card
(so every cross-rank sum, gather and the global BatchNorm run on CUDA
tensors), the ranks given each global batch as it is and with its rows
interleaved (rank 0 the even rows).
Both 2-rank runs compute the same function of the same global batch, at
the same rows a rank, so their distance is rounding alone (in the batch
sums only: a convolution's rows do not depend on the rows beside them);
so is the distance between one process and the same process with cuDNN
off (other convolution algorithms, as another batch shape picks). One
JSON line per dtype gives both beside the distance from one process.

The tests import `compare`; run from the repository's root, or with it on
the path.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":  # the repository's package, from its root
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

__all__ = ["main", "parse_args", "compare", "witness"]

_ROOT = Path(__file__).resolve().parents[1]

# the tests' whole-step rule (tests/test_torch_port_vqgan_train.py): the
# norm part decides here, the element part (MOVE_ATOL x lr) is reported
MOVE_ATOL, MOVE_NORM = 0.05, 0.05

_TINY_VQGAN = dict(ch=8, ch_mult=[1, 2], num_res_blocks=1, z_channels=8,
                   num_embeddings=8, embedding_dim=8, disc_ndf=8,
                   disc_n_layers=2, compute_dtype="float32")
LDM_MODES = ("replicated", "zero1", "fsdp", "fsdp_tp")
_TINY_LDM = dict(dim=16, dim_mults=[1, 2], attn_heads=2, attn_dim_head=16,
                 latent_size=4, image_size=32, timesteps=20,
                 sampling_timesteps=3)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="narrow models at small sizes")
    ap.add_argument("--witness", action="store_true",
                    help="the VQ-GAN's rounding witness on one GPU")
    ap.add_argument("--runs", nargs="*", default=None,
                    help="names of the runs to make (default: all)")
    ap.add_argument("--work", default=None,
                    help="folder for data and results (default: a "
                         "temporary one)")
    return ap.parse_args(argv)


def write_data(root: Path, seed: int, size: int, latent: int) -> dict:
    """31 users of 8 JPGs of seeded gratings, their split, and a latent
    cache of 50 latents [latent, latent, 4] per user with its split."""
    from PIL import Image

    from vqgan_tpu_torch.data import LatentCache, save_split

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    images = {"metadata": {"seed": seed}, "users": {}}
    latents = {"metadata": {"seed": seed}, "users": {}}
    cache = LatentCache(root / "latents_cache")
    for user in range(1, 32):
        names = [f"frame_{i:03d}.jpg" for i in range(8)]
        folder = root / "images" / f"ID_{user}"
        folder.mkdir(parents=True)
        for name in names:
            f = rng.uniform(1.0, 8.0, (2, 3, 1, 1))
            phase = rng.uniform(0, 2 * np.pi, (2, 3, 1, 1))
            img = 0.5 + 0.25 * (np.sin(2 * np.pi * f[0] * xx + phase[0])
                                + np.cos(2 * np.pi * f[1] * yy + phase[1]))
            Image.fromarray((img.transpose(1, 2, 0) * 255).astype(
                np.uint8)).save(folder / name, quality=90)
        images["users"][f"ID_{user}"] = {"train_images": names,
                                         "test_images": []}
        stems = [f"frame_{i:03d}.png" for i in range(50)]
        latents["users"][f"ID_{user}"] = {"train_images": stems,
                                          "test_images": []}
        for stem, z in zip(stems, rng.standard_normal(
                (50, latent, latent, 4)).astype(np.float32)):
            cache.save(user - 1, stem, z)
    save_split(images, root / "image_split.json")
    save_split(latents, root / "latent_split.json")
    return {"images": root / "images", "split": root / "image_split.json",
            "latent_split": root / "latent_split.json",
            "cache": root / "latents_cache"}


def _runs(args, data: dict, work: Path) -> list:
    """(name, module, argv without the results folder, checkpoint prefix,
    learning rate, initial-weights function) of every run."""
    n = args.steps
    device = ["--device", args.device]
    vq_cfg = work / "vqgan.json"
    vq_cfg.write_text(json.dumps({
        "seed": args.seed, "images_per_user_train": 8,
        **(_TINY_VQGAN if args.tiny else {})}))
    ldm_cfg = work / "ldm.json"
    ldm_cfg.write_text(json.dumps({
        "save_and_sample_every": 1000, "images_per_user_train": 50,
        **(_TINY_LDM if args.tiny else {})}))
    size = "32" if args.tiny else "256"
    vqgan = ["--config", str(vq_cfg), "--split", str(data["split"]),
             "--data_path", str(data["images"]), "--image_size", size,
             "--batch_size", "8", "--disc_start", str(n // 2),
             "--save_every", "1000", "--train_steps", str(n),
             "--scan_block", "4", *device]
    kl_vae = ["--data_path", str(data["images"]), "--split",
              str(data["split"]), "--image_size", size, "--batch_size", "8",
              "--train_steps", str(n), "--save_every", str(n), "--seed",
              str(args.seed), *device]
    ddpm = ["--folder", str(data["images"]), "--train_batch_size", "16",
            "--train_num_steps", str(n), "--save_and_sample_every", str(n),
            "--num_samples", "4", "--sampling_timesteps", "10",
            "--self_condition", "--immiscible", "--seed", str(args.seed),
            *(["--image_size", "16", "--dim", "8", "--dim_mults", "1", "2",
               "--timesteps", "20", "--sampling_timesteps", "3"]
              if args.tiny else []), *device]
    ldm = ["--config", str(ldm_cfg), "--split", str(data["latent_split"]),
           "--latents_cache_folder", str(data["cache"]), "--data_path",
           str(data["images"]), "--seed", str(args.seed),
           "--train_num_steps", str(n), "--scan_block", "4", *device]

    def vqgan_init():
        from vqgan_tpu_torch.configs import VQGANConfig
        from vqgan_tpu_torch.training.vqgan_trainer import VQGANTrainer

        raw = json.loads(vq_cfg.read_text())
        cfg = VQGANConfig.from_dict({**raw, "image_size": int(size)})
        tr = VQGANTrainer(cfg, device="cpu")
        return {"vqvae": tr.vqvae.state_dict(), "disc": tr.disc.state_dict()}

    def kl_vae_init():
        from vqgan_tpu_torch.models.autoencoder import (AutoencoderConfig,
                                                        KLVAE)

        torch.manual_seed(args.seed)
        return {"model": KLVAE(AutoencoderConfig(resolution=int(size),
                                                 z_channels=4)).state_dict()}

    def ddpm_init():
        from vqgan_tpu_torch import train_ddpm

        model, _ = train_ddpm.build(train_ddpm.parse_args(ddpm), "cpu")
        state = model.state_dict()
        return {"model": state, "ema": state}

    def ldm_init():
        from vqgan_tpu_torch.configs.ldm_config import LDMConfig
        from vqgan_tpu_torch.training.ldm_trainer import (
            LatentDiffusionTrainer)

        cfg = LDMConfig.from_dict({**json.loads(ldm_cfg.read_text()),
                                   "seed": args.seed})
        state = LatentDiffusionTrainer(cfg, device="cpu").model.state_dict()
        return {"model": state, "ema": state}

    out = [("train_vqgan split", "train_vqgan",
            [*vqgan, "--step_mode", "split"], "vqgan", 4.5e-5, vqgan_init),
           ("train_vqgan scan", "train_vqgan",
            [*vqgan, "--step_mode", "scan"], "vqgan", 4.5e-5, vqgan_init),
           ("train_kl_vae", "train_kl_vae", kl_vae, "kl_vae", 4.5e-6,
            kl_vae_init),
           ("train_ddpm", "train_ddpm", ddpm, "model", 8e-5, ddpm_init)]
    for step_mode in ("step", "scan"):
        for mode in LDM_MODES:
            out.append((f"train_latent_cfg {step_mode} {mode}",
                        "train_latent_cfg",
                        [*ldm, "--step_mode", step_mode, "--param_sharding",
                         mode], "model", 4e-5, ldm_init))
    return out


def _launch(module: str, argv: list, nproc: int, results: Path,
            log: Path) -> tuple:
    """Run the entry point (under torch.distributed.run with `nproc` > 1)
    into `results`; returns the rates every process printed, and the
    (resident, peak) device bytes of the last step that each printed (the
    LDM trainer's step mode on the card)."""
    from vqgan_tpu_torch.parallel.launch import free_port

    cmd = [sys.executable, "-m", f"vqgan_tpu_torch.{module}", *argv,
           "--results_folder", str(results)]
    if nproc > 1:
        cmd[1:1] = ["-m", "torch.distributed.run", "--nproc_per_node",
                    str(nproc), "--master_port", str(free_port())]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=_ROOT)
    log.write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}: "
                           f"{(proc.stdout + proc.stderr)[-3000:]}")
    rates = [float(m.group(1)) for m in re.finditer(
        r"steps after warm-up: ([\d.]+) (?:images|latents)/s", proc.stdout)]
    memory = [(int(m.group(1)), int(m.group(2))) for m in re.finditer(
        r"device bytes of the last step: (\d+) resident at its start, "
        r"(\d+) at its peak", proc.stdout)]
    return rates, memory


def _card() -> str:
    """The first card's name and power limit as nvidia-smi gives them,
    else its name."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    return out[0] if out else torch.cuda.get_device_name(0)


def _checkpoint(results: Path, prefix: str) -> dict:
    from vqgan_tpu_torch.checkpoint.manager import CheckpointManager

    saved = CheckpointManager(results, prefix=prefix).restore()
    return {f"{part}.{k}": v.float() for part, sd in saved.items()
            if isinstance(sd, dict) and part in (
                "vqvae", "disc", "model", "ema")
            for k, v in sd.items() if torch.is_tensor(v)}


def compare(got: dict, want: dict, init: dict, lr: float) -> dict:
    """Two checkpoints' weights: bit for bit, or the moves from `init`
    within MOVE_NORM in norm (running statistics and counters compared
    element-wise only)."""
    keys = [k for k in want if k in init and want[k].is_floating_point()
            and "running" not in k]
    d_max = max((got[k] - want[k]).abs().max().item() for k in want)
    moves = torch.cat([(got[k] - init[k]).flatten() for k in keys])
    want_moves = torch.cat([(want[k] - init[k]).flatten() for k in keys])
    diff = moves - want_moves
    miss = (diff.abs() > MOVE_ATOL * lr).float().mean().item()
    norm = (diff.norm() / want_moves.norm()).item()
    return {"max_abs_diff": d_max, "bit_for_bit": d_max == 0.0,
            "elements_over_5pct_lr": miss, "move_diff_norm_share": norm,
            "within_rule": d_max == 0.0 or norm <= MOVE_NORM}


def _witness_rank(rank, world, images, cfg_kwargs, device, cudnn=True):
    """The VQ-GAN trainer's split steps (VQGANConfig(**cfg_kwargs)) in
    bf16 and in fp32 on `device` (`cudnn` False: PyTorch's own
    convolutions), on this rank's rows of each global batch of `images`
    [n, B, H, W, C] as it is and (on a group) with its rows interleaved.
    Returns {(dtype, rows): weights}, and the initial weights under
    "init"."""
    from vqgan_tpu_torch.configs import VQGANConfig
    from vqgan_tpu_torch.device import set_full_fp32_precision
    from vqgan_tpu_torch.parallel.mesh import local_rows
    from vqgan_tpu_torch.training.vqgan_trainer import VQGANTrainer

    set_full_fp32_precision()  # as train_vqgan: no TF32 in fp32
    order = np.arange(images.shape[1])
    perms = {"as_is": order}
    if world > 1:
        perms["interleaved"] = np.concatenate([order[0::2], order[1::2]])
    out = {}
    with torch.backends.cudnn.flags(enabled=cudnn, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        for dtype in ("bfloat16", "float32"):
            for name, perm in perms.items():
                tr = VQGANTrainer(VQGANConfig(**{**cfg_kwargs,
                                                 "compute_dtype": dtype}),
                                  device=device, step_mode="split")
                out.setdefault("init", _weights(tr))
                for i, x in enumerate(images):
                    x = torch.from_numpy(x[perm])
                    if tr.mesh is not None:
                        x = local_rows(x, tr.mesh)
                    tr.dispatch_step(x.to(device), i)
                out[(dtype, name)] = _weights(tr)
                del tr
                if torch.device(device).type == "cuda":
                    torch.cuda.empty_cache()
    return out


def _weights(trainer) -> dict:
    """A copy of the VQ-GAN's and the discriminator's weights, fp32 on the
    host."""
    return {f"{part}.{k}": v.detach().float().cpu().clone()
            for part in ("vqvae", "disc")
            for k, v in getattr(trainer, part).state_dict().items()}


def witness(args) -> dict:
    """`--witness`: one JSON line per dtype with the 2-rank run's distance
    from one process and from the 2-rank run on interleaved rows."""
    from vqgan_tpu_torch.configs import VQGANConfig
    from vqgan_tpu_torch.parallel.launch import spawn

    size = 32 if args.tiny else 256
    cfg = {**(_TINY_VQGAN if args.tiny else {}), "image_size": size,
           "batch_size": 8, "disc_start": 1, "seed": args.seed}
    rng = np.random.default_rng(args.seed)
    images = rng.random((args.steps, 8, size, size, 3), dtype=np.float32)
    card = _card() if args.device != "cpu" else "cpu"
    one = _witness_rank(0, 1, images, cfg, args.device)
    other = _witness_rank(0, 1, images, cfg, args.device, cudnn=False)
    two = spawn(_witness_rank, 2, (images, cfg, args.device),
                timeout=1200.0, device=args.device)
    lr = VQGANConfig().learning_rate
    report = {}
    for dtype in ("bfloat16", "float32"):
        a, b = two[0][(dtype, "as_is")], two[0][(dtype, "interleaved")]
        line = {"witness": "train_vqgan split", "dtype": dtype,
                "world": 2, "steps": args.steps, "device": card,
                "ranks_equal": all(torch.equal(v, two[1][(dtype, "as_is")][k])
                                   for k, v in a.items()),
                "vs_one_process": compare(a, one[(dtype, "as_is")],
                                          one["init"], lr),
                "vs_interleaved_rows": compare(a, b, one["init"], lr),
                "one_process_vs_its_run_without_cudnn": compare(
                    other[(dtype, "as_is")], one[(dtype, "as_is")],
                    one["init"], lr)}
        report[dtype] = line
        print(json.dumps(line), flush=True)
    return report


def main(argv=None) -> dict:
    """Run and compare; returns {run: its JSON line} and "ok"."""
    args = parse_args(argv)
    if args.witness:
        return witness(args)
    if args.device != "cpu" and torch.cuda.device_count() < args.nproc:
        raise RuntimeError(f"--nproc {args.nproc} needs {args.nproc} GPUs, "
                           f"found {torch.cuda.device_count()}")
    tmp = None if args.work else tempfile.TemporaryDirectory(
        prefix="dp_check_")
    work = Path(args.work or tmp.name)
    work.mkdir(parents=True, exist_ok=True)
    card = _card() if args.device != "cpu" else "cpu"
    try:
        data = write_data(work / "data", args.seed,
                          40 if args.tiny else 256, 4 if args.tiny else 32)
        runs = _runs(args, data, work)
        report, ldm_world = {}, {}
        for name, module, argv_, prefix, lr, init_fn in runs:
            if args.runs and name not in args.runs:
                continue
            tag = name.replace(" ", "_")
            many = work / f"{tag}_n{args.nproc}"
            one = work / f"{tag}_n1"
            rates, memory = _launch(module, argv_, args.nproc, many,
                                    work / f"{tag}_n{args.nproc}.log")
            step_mode = name.split()[1] if module == "train_latent_cfg" \
                else None
            want_dir = (work / f"train_latent_cfg_{step_mode}_replicated_n1"
                        if step_mode else one)
            rates_one = memory_one = None
            if not want_dir.exists():
                rates_one, memory_one = _launch(
                    module, argv_ if not step_mode else
                    [*argv_[:-1], "replicated"], 1, want_dir,
                    work / f"{tag}_n1.log")
            got = _checkpoint(many, prefix)
            line = {"run": name, "world": args.nproc, "steps": args.steps,
                    "device": card, "rates_per_rank": rates,
                    "rate_one_process": rates_one[0] if rates_one else None,
                    **({"resident_bytes_per_rank": [m[0] for m in memory],
                        "peak_bytes_per_rank": [m[1] for m in memory]}
                       if memory else {}),
                    **({"resident_bytes_one_process": memory_one[0][0],
                        "peak_bytes_one_process": memory_one[0][1]}
                       if memory_one else {}),
                    **compare(got, _checkpoint(want_dir, prefix),
                              {k: v.float() for part, sd in init_fn().items()
                               for k, v in ((f"{part}.{k}", v)
                                            for k, v in sd.items())},
                              lr)}
            if step_mode:
                if name.endswith(" replicated"):
                    ldm_world[step_mode] = (got, memory)
                elif step_mode in ldm_world:
                    base, base_memory = ldm_world[step_mode]
                    line["vs_replicated_at_world"] = max(
                        (got[k] - v).abs().max().item()
                        for k, v in base.items())
                    if memory and base_memory:
                        line["resident_share_of_replicated"] = (
                            max(m[0] for m in memory)
                            / max(m[0] for m in base_memory))
            report[name] = line
            print(json.dumps(line), flush=True)
        ok = all(r["within_rule"] for r in report.values())
        print(json.dumps({"ok": ok, "runs": len(report), "world":
                          args.nproc, "device": card}))
        return {**report, "ok": ok}
    finally:
        if tmp is not None:
            tmp.cleanup()


if __name__ == "__main__":
    main()
