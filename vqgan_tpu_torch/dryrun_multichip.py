"""The multi-device dry run: one training step and each scale-out path over
N ranks, each held against the single-process result.

    python -m vqgan_tpu_torch.dryrun_multichip --n 4 --device cpu
    torchrun --nproc_per_node 4 -m vqgan_tpu_torch.dryrun_multichip

Counterpart of `dryrun_multichip` in the JAX package's graft entry, with
its checks at its sizes (the CFG U-Net at dim 16, mults 1-2-4-4, 8 x 64
heads, 8 x 8 x 4 latents, 31 classes, T = 100; batch max(N, 2)):
- dp: one full training step (loss, backward, Adam, EMA) over a "data"
  mesh of N ranks, each on its rows; the loss within 1e-3 of the
  single-process step on the whole batch; CFG sampling of each rank's
  classes, finite;
- fsdp: the same step with parameters, moments and EMA split over "data"
  (min_size 128); loss within 1e-3 of the single process;
- dp x tp: a (N/2, 2) mesh, the attention kernels split over "model";
  loss within 1e-3 (even N);
- pp: a DiT of depth 2 x stages (4 stages, 2 when N < 4) pipelined over
  "stage" against its sequential forward (rtol 2e-4, atol 1e-5);
- sp: ring attention at seq max(1024, 8N), 2 heads x 64, each rank's block
  against full attention (`sdpa_reference`) at atol 1e-4;
- serving: a data-parallel artifact at dp = 2 (export, load, run on 2
  ranks, gather) against the single-process DDIM sampler on the whole
  batch with the same draws (rtol 1e-4, atol 1e-5);
- and, beyond JAX's dry run, the step under zero1 (N >= 2) and fsdp x tp
  (even N) within 1e-3 of the single process.
A check the world size cannot hold prints "skipped (n=...)", as JAX's
does. It spawns N processes (gloo on the CPU; NCCL on CUDA where each rank
has a card of its own, gloo with the ranks sharing cards otherwise), or,
under torchrun, runs in the launched processes. The last line of its
output is the summary.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
from torch import nn

from .device import resolve_device, set_full_fp32_precision

__all__ = ["dryrun_multichip", "run_rank", "main"]


def _build_flagship(device, dim=16, image_size=8, channels=4,
                    num_classes=31, timesteps=100, sampling_timesteps=10):
    from .diffusion.gaussian import GaussianDiffusion
    from .models.unet_cfg import CFGUnet

    torch.manual_seed(0)
    model = CFGUnet(dim=dim, num_classes=num_classes, dim_mults=(1, 2, 4, 4),
                    channels=channels, cond_drop_prob=0.0, attn_heads=8,
                    attn_dim_head=64).to(device)
    diffusion = GaussianDiffusion(
        model, image_size=image_size, channels=channels, timesteps=timesteps,
        sampling_timesteps=sampling_timesteps, objective="pred_v",
        beta_schedule="cosine", min_snr_loss_weight=True, min_snr_gamma=5.0,
        auto_normalize=False, device=device)
    return model, diffusion


_STEP = dict(cond_drop_prob=0.5, ema_decay=0.995, ema_update_every=1,
             ema_update_after_step=0)


def _step_loss(device, batch, mesh=None, mode=None, min_size=2 ** 14):
    """(loss of one training step, the diffusion): single-process on the
    whole batch without a mesh, else this rank's rows on `mesh`."""
    import copy

    from .parallel.fsdp import place_state
    from .parallel.mesh import local_rows
    from .training.ldm_step import (
        LDMTrainState,
        make_ldm_optimizer,
        make_ldm_train_step,
    )
    from .training.sharded_step import make_sharded_ldm_train_step

    model, diffusion = _build_flagship(device)
    opt = make_ldm_optimizer(model.parameters(), learning_rate=1e-4,
                             warmup_steps=10)
    state = LDMTrainState(0, model, copy.deepcopy(model).requires_grad_(False),
                          opt)
    g = torch.Generator(device).manual_seed(1)
    latents = torch.randn((batch, 8, 8, 4), generator=g, device=device)
    classes = torch.arange(batch, device=device) % 31
    gen = torch.Generator(device).manual_seed(2)
    if mesh is None:
        step = make_ldm_train_step(diffusion, opt, **_STEP)
    else:
        placed = place_state(state, mesh, mode, min_size)
        step = make_sharded_ldm_train_step(diffusion, placed, **_STEP)
        latents, classes = local_rows(latents, mesh), local_rows(classes, mesh)
    log = step(state, latents, classes, generator=gen)
    loss = float(log["loss"])
    assert torch.isfinite(log["loss"]), f"loss not finite ({mode})"
    assert state.step == 1
    return loss, diffusion, state


class _Latents(nn.Module):
    """The served program's decode: the final latents, NHWC."""

    def forward(self, img):
        return img.permute(0, 2, 3, 1)


def run_rank(n: int, device) -> str:
    """The dry run on this rank of a process group of `n` ranks (or in a
    process with no group when n is 1); returns the summary line."""
    from .parallel.mesh import make_mesh, named_mesh
    from .parallel.pp import make_pipeline_mesh

    device = torch.device(device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    t0 = time.perf_counter()

    def done(check):  # progress on stderr; the summary is stdout's
        print(f"[rank {rank}] {check} done at {time.perf_counter() - t0:.1f}"
              f" s", file=sys.stderr, flush=True)

    batch = max(n, 2)
    single, _, _ = _step_loss(device, batch)
    done("single-process step")

    # --- dp: the full step over a "data" mesh, then CFG sampling ---------
    mesh = make_mesh(data=n, model=1, device=device)
    loss, diffusion, state = _step_loss(device, batch, mesh, "replicated")
    assert abs(loss - single) < 1e-3, (loss, single)
    classes = (torch.arange(batch, device=device) % 31).chunk(n)[
        mesh.coord("data")]
    with torch.inference_mode():
        diffusion.model = state.ema_model
        out = diffusion.sample(classes=classes, cond_scale=3.0,
                               generator=torch.Generator(device).manual_seed(3))
    assert bool(torch.isfinite(out).all()), "non-finite samples"
    done("dp")

    # --- fsdp ---------------------------------------------------------------
    fsdp_note = f"skipped (n={n})"
    if n >= 2:
        loss_f, _, _ = _step_loss(device, batch, mesh, "fsdp", min_size=128)
        assert abs(loss_f - single) < 1e-3, (loss_f, single)
        fsdp_note = f"OK loss={loss_f:.4f}"
        done("fsdp")

    # --- dp x tp --------------------------------------------------------------
    tp_note = "skipped (need even device count)"
    if n >= 2 and n % 2 == 0:
        mesh_tp = make_mesh(data=n // 2, model=2, device=device)
        loss_tp, _, _ = _step_loss(device, batch, mesh_tp, "tp")
        assert abs(loss_tp - single) < 1e-3, (loss_tp, single)
        tp_note = f"OK loss={loss_tp:.4f} mesh={mesh_tp.shape}"
        done("tp")

    # --- pp: the DiT's block stack over "stage" -----------------------------
    pp_note = f"skipped (n={n})"
    stages = 4 if n >= 4 else 2
    if n >= 2 and n % stages == 0:
        from .models.dit import DiT, dit_pipeline_forward
        from .parallel.mesh import local_rows

        mesh_pp = make_pipeline_mesh(stages, data=n // stages, device=device)
        torch.manual_seed(8)
        dit = DiT(dim=64, depth=2 * stages, heads=2, dim_head=32,
                  patch_size=2, image_size=8, channels=4, num_classes=31,
                  cond_drop_prob=0.0).to(device)
        for p in dit.parameters():  # adaLN-zero starts as the identity
            nn.init.normal_(p, std=0.05)
        g = torch.Generator(device).manual_seed(5)
        xpp = torch.randn((4, 4, 8, 8), generator=g, device=device)
        tpp = torch.arange(4, device=device)
        cpp = tpp % 31
        mask = torch.zeros(4, dtype=torch.bool, device=device)
        with torch.no_grad():
            want = local_rows(dit(xpp, tpp, cpp, cond_drop_mask=mask),
                              mesh_pp)
            got = dit_pipeline_forward(
                dit, *(local_rows(a, mesh_pp) for a in (xpp, tpp, cpp)),
                mesh_pp, num_microbatches=2,
                cond_drop_mask=local_rows(mask, mesh_pp))
        assert torch.allclose(got, want, rtol=2e-4, atol=1e-5), \
            "DiT pipeline != sequential"
        pp_note = (f"OK DiT(depth={2 * stages}) stages={stages} "
                   f"(CFGUnet deliberately unpipelined)")
        done("pp")

    # --- sp: ring attention over "seq" -------------------------------------
    sp_note = f"skipped (n={n})"
    if n >= 2:
        from .ops.attention import sdpa_reference
        from .ops.ring_attention import ring_attention

        mesh_sp = named_mesh({"seq": n}, device)
        seq, dhead = max(1024, 8 * n), 64
        g = torch.Generator(device).manual_seed(7)
        qs, ks, vs = (torch.randn((2, seq, 2, dhead), generator=g,
                                  device=device) for _ in range(3))
        i = mesh_sp.coord("seq")
        with torch.no_grad():
            ring = ring_attention(*(t.chunk(n, 1)[i] for t in (qs, ks, vs)),
                                  mesh_sp)
            want = sdpa_reference(qs, ks, vs).chunk(n, 1)[i]
        assert torch.allclose(ring, want, atol=1e-4), "ring != full attention"
        sp_note = f"OK seq={seq} dhead={dhead} shards={n}"
        done("sp")

    # --- serving: a data-parallel artifact at dp = 2 -------------------------
    serve_note = f"skipped (n={n})"
    if n >= 2 and n % 2 == 0:
        from .diffusion.gaussian import DDIMStep
        from .parallel.mesh import Mesh
        from .serving import export_cfg_sampler, load_cfg_sampler

        dp = 2
        bsrv = dp * max(1, batch // dp)
        step = DDIMStep(diffusion, 1.0, 0.0)
        common = dict(batch_size=bsrv, latent_shape=(4, 8, 8),
                      ddim_pairs=diffusion.ddim_time_pairs(), num_users=31,
                      cond_scale=1.0, rescaled_phi=0.0)
        box = [tempfile.mkdtemp(prefix="dryrun_serving_") if rank == 0
               else None]
        if dist.is_initialized():
            dist.broadcast_object_list(box, 0)
        root = box[0]
        if rank == 0:
            export_cfg_sampler(step, _Latents(), root,
                               mesh=Mesh({"data": dp}, device),
                               arg_specs=(("data",),), **common)
        if dist.is_initialized():
            dist.barrier()
        csrv = torch.arange(bsrv, device=device) % 31
        mesh_srv = named_mesh({"data": dp, "model": n // dp}, device)
        imgs = load_cfg_sampler(root, device, mesh=mesh_srv)(
            csrv, generator=torch.Generator(device).manual_seed(11))
        # the single process: the live sampler on the whole batch, the
        # same draws from the same seed
        with torch.inference_mode():
            want = diffusion.ddim_sample(
                (bsrv, 8, 8, 4), csrv, cond_scale=1.0, rescaled_phi=0.0,
                generator=torch.Generator(device).manual_seed(11))
        assert imgs.shape == (bsrv, 8, 8, 4), imgs.shape
        assert bool(torch.isfinite(imgs).all()), "non-finite serving"
        assert torch.allclose(imgs, want, rtol=1e-4, atol=1e-5), \
            "dp artifact != the single-process sampler"
        if dist.is_initialized():
            dist.barrier()
        if rank == 0:
            import shutil

            shutil.rmtree(root, ignore_errors=True)
        serve_note = f"OK dp={dp}"
        done("serving")

    # --- the two placements JAX's dry run leaves out: zero1, fsdp x tp ----
    extra = ""
    for mode in ("zero1", "fsdp_tp"):
        if n < 2 or ("tp" in mode and n % 2):
            extra += f" {mode}=skipped (n={n})"
            continue
        mesh_x = (make_mesh(data=n // 2, model=2, device=device)
                  if "tp" in mode else mesh)
        loss_x, _, _ = _step_loss(device, batch, mesh_x, mode, min_size=128)
        assert abs(loss_x - single) < 1e-3, (mode, loss_x, single)
        extra += f" {mode}=OK loss={loss_x:.4f}"

    return (f"dryrun_multichip({n}): OK loss={loss:.4f} "
            f"sample_shape={tuple(out.shape)} fsdp={fsdp_note} tp={tp_note} "
            f"pp={pp_note} sp={sp_note} serving={serve_note}{extra}")


def _spawned(rank, world, device):
    set_full_fp32_precision()
    if torch.device(device).type == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    return run_rank(world, device)


def dryrun_multichip(n: int, device="cuda", timeout: float = 600.0) -> str:
    """Spawn n ranks and run the dry run; returns the summary line. NCCL
    where every rank has a card of its own, gloo otherwise (ranks sharing
    a card: the collectives go through host memory)."""
    from .parallel.launch import spawn

    device = resolve_device(device)
    backend = ("nccl" if device.type == "cuda"
               and torch.cuda.device_count() >= n else "gloo")
    return spawn(_spawned, n, (str(device),), timeout=timeout,
                 backend=backend, device=device, threads=2)[0]


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=None,
                    help="ranks (default: the launcher's world size, else "
                         "the visible cards)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_full_fp32_precision()
    if "WORLD_SIZE" in os.environ:  # torchrun
        from .parallel.init import initialize_distributed

        initialize_distributed(device)
        line = run_rank(dist.get_world_size(),
                        torch.device("cuda", torch.cuda.current_device())
                        if device.type == "cuda" else device)
        main_rank = dist.get_rank() == 0
        dist.destroy_process_group()
    else:
        n = args.n or (torch.cuda.device_count() if device.type == "cuda"
                       else 1)
        line = dryrun_multichip(n, device)
        main_rank = True
    if main_rank:
        print(line)
    return line


if __name__ == "__main__":
    main()
