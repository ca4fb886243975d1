#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vqgan_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # build + kernel and small checks

Phases, in order; any failure exits non-zero:
1. A CUDA device must be present; print its name and power limit.
2. Build every hand-written kernel from the sources in this checkout, one
   nvcc per source, all at once; print each instance's registers, spills
   and shared memory, and the count of tensor-core (HMMA) instructions in
   each library's SASS, which must not be 0 for any of them.
3. Hold each kernel against its plain PyTorch version on the card (TF32
   off): the flash forward at the main paths' shapes and at ragged shapes
   (Sq not a multiple of the q tile, head_dim padded to 16, Skv shorter
   than a K/V tile, strided q, every head-width instance); the backward
   kernels (dQ; dK and dV) at the LDM training shape, the KL-VAE
   training shape (fp32 d = 512 at batch 8), the VQ-VAE's bf16 d = 512
   shape, the same ragged shapes and with strided dO; at the VQ-VAE shape every backward output within 2e-3 of
   its largest plain value, or, where the plain version is itself farther
   than that from an fp64 evaluation, no farther from it than the plain
   version, and dK/dV equal bit for bit in two runs; a view whose rows are
   not 16-byte aligned must be refused by each flash kernel; the VQ
   kernel in both modes at the VQ-GAN main-path shape
   [8192,256]x[128,256], at K = 8192, at ragged shapes (D = 40; D = 33,
   which the wrapper pads; D = 300, past the kernel's 256 resident
   columns) and on a codebook of repeated rows, with its fused usage
   histogram against bincount; and every other shape the end-to-end demo
   launches (the VQ-GAN at 128 px: flash forward and backward at
   [8,256,1,512] bf16, forward at [16,256,1,512], VQ at [2048,256] and
   [4096,256] x [128,256]; serving at batch 4). Time each kernel through
   its operator (the host time every path pays; the flash forward also
   through its ctypes wrapper alone), its plain version and one PyTorch
   library call at the main paths' shapes (and a few others), the kernel
   and the library call also as device time (in a CUDA graph), and
   compute the bound. For bf16, print the share of elements that differ
   from the plain version's.
4. Run the generation slice on a small input (tiny U-Net and KL-VAE in
   fp32, 5 DDIM steps at cond_scale 3.0 with injected noise, then the
   decode) on the card and on the CPU, where attention takes the plain
   version, and hold the two images against each other.
4b. Run three training steps of a tiny fp32 U-Net on the card and on the
   CPU from the same weights with injected t, noise and cond-drop mask;
   hold the gradients, losses, parameters and EMA against each other, and
   require one launch of each flash kernel per step.
4c. Run three VQ-GAN training steps (disc_start 1) of a tiny fp32 config
   on the card and on the CPU from the same weights and images; hold the
   indices, losses, first G step's gradients, BatchNorm statistics and
   parameter moves against each other; one VQ launch per step and five of
   each flash kernel per G step.
4d. Run three KL-VAE training steps of a small fp32 config whose mid
   blocks keep the main path's d = 512 attention (ch 128, mults 1-4, 64
   px) on the card and on the CPU from the same weights, images and
   injected posterior noise; hold the loss parts, the first step's
   gradients and the parameter moves against each other; two launches of
   each flash kernel per step.
5. Drive generation, `python -m vqgan_tpu_torch.generate`, at full width
   with seeded random weights: LDMConfig defaults (dim 96, mults 1-2-4-4,
   8 heads x 64, T=1000, DDIM-150, pred_v, cosine, bf16 U-Net) and the
   default fp32 KL-VAE at 256 px; two users of one batch of 16 at
   cond_scale 1.0, then one batch at cond_scale 3.0 / rescaled_phi 0.7.
   The kernel launch counts are reset just before and read just after, and
   must be 151 forward launches per batch (150 U-Net steps + 1 VAE decode)
   and no other launch. The JPG layout must be written and every image
   finite.
5b. Drive training, `python -m vqgan_tpu_torch.train_latent_cfg`, at full
   width (LDMConfig defaults, batch 8, no VAE) on a split and latent cache
   of 31 users x 50 seeded random [32, 32, 4] latents: 41 steps, then a
   resume from that checkpoint to step 50. Every loss must be finite; each
   flash kernel must launch once per step at [8, 16, 8, 64] bf16; the EMA
   must equal the online weights after step 40 (the last warm copy:
   update_every 10, update_after_step 100) and differ from the final ones;
   the checkpoint and its latest pointer must load back. Then generate 16
   images from that checkpoint (EMA weights) with a seeded random KL-VAE
   state dict: 151 forward launches, no backward launch.
5c. Drive stage-1 VQ-GAN training, `python -m vqgan_tpu_torch.train_vqgan`,
   at full width (VQGANConfig defaults: batch 8 at 256 px, bf16) on 31
   users x 8 seeded smooth-pattern JPGs: 10 G-only steps (disc_start 10),
   then a resume to step 30 (G + D). Every loss finite; per G step one VQ
   launch at [8192,256]x[128,256] and two of each flash kernel at
   [8,1024,1,512] bf16, plus one VQ and two forward launches per
   reconstruction grid; the discriminator unchanged after the first call
   and moved after the second; checkpoints and the latest pointer load
   back; the grids exist. Prints images/s.
5d. Drive the stage-1 KL-VAE slice at full width on 31 users x 8 seeded
   JPGs, entry point by entry point: `create_data_split`, then
   `train_kl_vae` at its defaults (AutoencoderConfig(), batch 8 at 256
   px, fp32) for 20 steps with milestones at 10 and 20, then
   `preprocess_latents` from the last milestone, `vae_reconstruction`,
   and `train_latent_cfg` for 2 steps on the split and cache just
   written. Every loss finite; per KL-VAE step two launches of each flash
   kernel at [8, 1024, 1, 512] fp32, one forward per encode batch, two per
   reconstruction report, one of each per LDM step, and no other launch;
   the milestone loads into `generate.load_vae`; a finite [32, 32, 4]
   latent for every image; a finite PSNR in metrics.json. Prints KL-VAE
   training images/s and the peak of allocated device memory.
4e. The GMM split, the classifier and FID on small inputs, card against
   CPU: `gmm_fit` with the same initial indices on one user's projected
   latents (60 x 4096, PCA to 95%: the diagonal fallback) and on a
   well-conditioned set (full covariances): labels equal up to the order
   of the components, covariance type equal, means within 1e-4 of the
   largest, log-likelihood 1e-4 relative;
   three ResNet18 `ClassifierExperiment` steps at 64 px, batch 8, lr 1e-5,
   same weights and batches: losses rtol 1e-4, first gradients 1e-3 of the
   largest, parameters after the steps within 2% of the CPU's move in norm
   (over lr / 2 apart in at most 0.1% of the elements), running statistics
   1e-4 of the largest; Inception features of 2 images within 1e-4 of the
   largest; no hand-written kernel launched.
5e. Drive the GMM split, the cluster validation, the classifier and FID at
   full width on 31 users x 60 seeded JPGs (256 px) with a random default
   KL-VAE saved as a checkpoint: `preprocess_latents_with_gmm` (one flash
   forward per padded encode batch at [16, 1024, 1, 512] fp32: 4 per
   user; a sound split; each cluster's gen and class counts its
   largest-remainder quotas; exactly the 930 gen-train latents cached),
   `validate_cluster_number` for 2 users and k 2-4 (its JSON report),
   `generate --random_init` for 4 users x 16 images (151 forwards each, at
   phase 3's unet_mid and vae_mid shapes), `classifier_experiment` on the
   real class-train images and those 64 synthetic ones for 2 epochs
   (finite losses, 310 test samples, the results JSON, no hand-written
   kernel), and FID with a random-init
   Inception: test images against the generated ones (finite, >= 0) and
   against themselves (under 2 x 2048 x sqrt(eps) x the covariance's
   largest eigenvalue, the square root's rounding). Prints
   encode and PCA + GMM seconds per user, the users that fell back to
   diagonal covariances, classifier training images/s over epoch 2 (and
   the loader's alone, and the step's on a batch resident on the card),
   Inception images/s, the FIDs and the phase's seconds.
5f. Drive the serving path at full width through its entry points, from
   the checkpoints of 5b (LDM, with its seeded KL-VAE), 5c (VQ-GAN) and
   5d (KL-VAE): `export_serving --selftest` at batch 16, cond_scale 1.0
   and 3.0 / rescaled_phi 0.7 (artifact vs live pipeline within rtol
   1e-4, atol 1e-5; 151 flash forwards per generated batch, counted
   through the operators, and no other launch); one DDIM step timed in
   turns as the live module, as the served program and as the program
   with the no-op nodes `torch.export` keeps (one forward launch each);
   two live decodes of one batch, which must agree bit for bit with cuDNN
   held to deterministic algorithms (the selftests run so);
   `serve_generate` of 2 users x 16 (the JPG layout, finite images); `serve_http --port 0` in a
   subprocess (/healthz warm, POSTs of 2 images returning 256 x 256 JPEGs,
   user_id 0 answered 400); the VQ codec of 5c's milestone at batch 8
   (`--mode vq_codec --selftest`: indices equal to the live codec's; 1 VQ
   launch at [8192,256]x[128,256] and 1 forward at [8,1024,1,512] bf16 per
   encode, 1 forward per decode), its encode and decode timed; and
   `diagnose_latent_range` of 5d's KL-VAE and 5c's VQ-GAN over 100 images
   (finite statistics). Prints, each beside the card's name and power
   limit, the export seconds and bytes of each program, the step's host
   ms, serve_generate's samples/s beside phase 5's, the HTTP latency per
   request and the codec's ms per batch.
6. Print the kernels' JSON line, then the card line, then the device line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# NVIDIA data-sheet peaks (SXM parts, dense, at the full 700 W limit). The
# fastest fp32-accurate product on these cards is 3xTF32, three TF32
# products on the tensor cores (495 TFLOP/s), so fp32's rate is a third of
# that, not the 67 TFLOP/s of the fp32 units.
_PEAKS = {
    "H100": {"bytes_per_s": 3.35e12, "bfloat16": 989e12,
             "float32": 495e12 / 3},
    "H200": {"bytes_per_s": 4.8e12, "bfloat16": 989e12,
             "float32": 495e12 / 3},
}

# tolerance of kernel vs plain version, both fp32 math on the card: they
# differ only in summation order (fp32) or in one final bf16 rounding step
_ATOL = {"float32": {"out": 2e-5, "lse": 1e-4},
         "bfloat16": {"out": 1e-2, "lse": 1e-4}}

FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# sources whose products are mma.sync on the tensor cores
TENSOR_CORE_SOURCES = ("flash_fwd.cu", "flash_bwd_dq.cu",
                       "flash_bwd_dkv.cu", "vq.cu")
# bf16 backward at the VQ-VAE's [8, 1024, 1, 512]: each output within this
# share of its largest plain value (a bf16 step at the top of the range is
# 2^-8 to 2^-7 of it, so this allows rounding flips only below ~max / 4).
# Where the plain fp32 version itself lies farther than this from an fp64
# evaluation of the same math (rounding flips of its own), the kernel must
# instead lie no farther from that evaluation than the plain version does.
_BF16_RULE = 2e-3


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def tensor_core_instructions(kernels) -> dict:
    """{source name: count of HMMA (tensor-core) instructions in the SASS of
    its built library}, read with the toolkit's cuobjdump."""
    from vqgan_tpu_torch.kernels.build import nvcc_path

    tool = Path(nvcc_path()).parent / "cuobjdump"
    counts = {}
    for k in kernels.values():
        if k.source.name not in counts:
            sass = subprocess.run(
                [str(tool), "--dump-sass", str(k.library_path)],
                capture_output=True, text=True, check=True, timeout=300)
            counts[k.source.name] = sum(
                "HMMA" in line for line in sass.stdout.splitlines())
    return counts


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


def device_ms(torch, fn, iters: int, stream=None) -> float:
    """Time of one call on the card with the host out of the way: `iters`
    calls captured in one CUDA graph (on `stream`, if given), replayed and
    timed by CUDA events (at the U-Net's small shapes `cuda_ms` reads the
    host's time of a call). Not torch.profiler: once it has run, every
    later launch of the process pays more host time, and the main-path
    phases come after this one."""
    fn()  # outside the capture: the kernel is built and configured
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    return cuda_ms(torch, graph.replay, 3) / iters


def bound(peaks: dict, n_bytes: int, flops: int, dtype: str):
    """(bound ms, "bytes" or "operations"): the least time the card could
    take to move `n_bytes` once or to do `flops` at `dtype`'s peak rate."""
    t_bytes = n_bytes / peaks["bytes_per_s"] * 1e3
    t_ops = flops / peaks[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def differ(got, ref) -> str:
    """For bf16 outputs, ", x% differ": the share of elements where the
    kernel's rounded value is not the plain version's."""
    if got.dtype != ref.dtype or got.element_size() != 2:
        return ""
    return f", {100 * (got != ref).float().mean().item():.4f}% differ"


def attention_cases():
    """(label, B, Sq, Skv, H, D, dtype, main_path)."""
    return [
        ("unet_mid_train", 8, 16, 16, 8, 64, "bfloat16", True),
        ("unet_mid", 16, 16, 16, 8, 64, "bfloat16", True),
        ("unet_mid_cfg", 32, 16, 16, 8, 64, "bfloat16", True),
        ("vae_mid", 16, 1024, 1024, 1, 512, "float32", True),
        ("kl_vae_mid_train", 8, 1024, 1024, 1, 512, "float32", True),
        ("vqvae_mid_train", 8, 1024, 1024, 1, 512, "bfloat16", True),
        ("ragged_d512", 2, 100, 100, 1, 512, "float32", False),
        ("ragged_cross", 2, 64, 17, 4, 32, "float32", False),
        ("ragged_tiny_bf16", 1, 7, 7, 2, 16, "bfloat16", False),
        # the tensor-core tiling's edges: Sq not a multiple of the 64-row
        # tile (with a strided, 16-byte-aligned q), head columns padded to
        # 16, Skv shorter than one K/V tile
        ("ragged_d512_bf16", 2, 100, 100, 1, 512, "bfloat16", False),
        ("ragged_d24_bf16", 2, 40, 40, 3, 24, "bfloat16", False),
        ("ragged_d24", 2, 40, 40, 3, 24, "float32", False),
        ("short_kv_bf16", 3, 130, 9, 2, 64, "bfloat16", False),
        # every other head-width instance of the kernels
        ("ragged_d64", 1, 33, 47, 2, 64, "float32", False),
        ("ragged_d128", 2, 70, 50, 2, 128, "float32", False),
        ("ragged_d128_bf16", 2, 70, 50, 2, 128, "bfloat16", False),
        ("ragged_d256", 1, 80, 90, 2, 256, "float32", False),
        ("ragged_d256_bf16", 1, 80, 90, 2, 256, "bfloat16", False),
        # the end-to-end demo's other shapes: the VQ-GAN at 128 px
        # (training and grids; the latent audit's batches of 16) and the
        # serving stage's batch of 4 (U-Net, decode)
        ("vqvae128_mid_train", 8, 256, 256, 1, 512, "bfloat16", False),
        ("vqvae128_mid", 16, 256, 256, 1, 512, "bfloat16", False),
        ("unet_mid_b4", 4, 16, 16, 8, 64, "bfloat16", False),
        ("vae_mid_b4", 4, 1024, 1024, 1, 512, "float32", False),
    ]


def check_flash_fwd(torch, peaks, seed: int):
    import torch.nn.functional as F

    from vqgan_tpu_torch.kernels.flash_fwd import flash_fwd
    from vqgan_tpu_torch.kernels.ops import flash_fwd_op
    from vqgan_tpu_torch.ops.attention import flash_forward_reference

    rows = {}
    rng = np.random.default_rng(seed)
    for label, b, s_q, s_kv, h, d, dt, main in attention_cases():
        dtype = getattr(torch, dt)

        def make(s):
            x = rng.standard_normal((b, s, h, d)).astype(np.float32)
            return torch.from_numpy(x).to("cuda", dtype)

        q, k, v = make(s_q), make(s_kv), make(s_kv)
        if label in ("ragged_cross", "ragged_d512_bf16"):
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
              f"max|out-plain|={err_out:.3e} (max|plain| "
              f"{ref_out.float().abs().max().item():.3e}"
              f"{differ(out, ref_out)}) max|lse-plain|={err_lse:.3e}")
        if (not finite or err_out > _ATOL[dt]["out"]
                or err_lse > _ATOL[dt]["lse"]):
            fail(f"flash_fwd disagrees with its plain version at {label} "
                 f"(tolerance {_ATOL[dt]})")
        if not main:
            continue

        iters = 20 if s_q >= 1024 else 200
        # the kernel as every path reaches it, through its operator; and
        # the ctypes wrapper under it, called directly
        kernel_ms = cuda_ms(torch, lambda: flash_fwd_op(q, k, v, scale),
                            iters)
        wrapper_ms = cuda_ms(torch, lambda: flash_fwd(q, k, v, scale), iters)
        dev_ms = device_ms(torch, lambda: flash_fwd_op(q, k, v, scale),
                           iters)
        plain_ms = cuda_ms(
            torch, lambda: flash_forward_reference(q, k, v, scale), iters)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, scale=scale)

        library_ms = cuda_ms(torch, library, iters)
        lib_dev_ms = device_ms(torch, library, iters)
        itemsize = q.element_size()
        n_bytes = (2 * b * s_q * h * d + 2 * b * s_kv * h * d) * itemsize \
            + 4 * b * h * s_q
        bound_ms, bound_by = bound(peaks, n_bytes,
                                   4 * b * h * s_q * s_kv * d, dt)
        row = rows[("flash_fwd", label)] = {
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
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
        }
        print(f"flash_fwd {label}: kernel_ms={kernel_ms:.4f} "
              f"(device {dev_ms:.4f}; the wrapper without the operator "
              f"{wrapper_ms:.4f}) plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} (device {lib_dev_ms:.4f}) "
              f"bound_ms={bound_ms:.6f} ({bound_by})")
    check_layout_refused(torch)
    return rows


def check_layout_refused(torch):
    """The wrappers raise on a view whose rows do not start on 16 bytes
    (the kernels stage rows by 16-byte copies), and launch nothing."""
    from vqgan_tpu_torch.kernels import KERNELS
    from vqgan_tpu_torch.kernels.flash_bwd import flash_bwd_dkv, flash_bwd_dq
    from vqgan_tpu_torch.kernels.flash_fwd import flash_fwd

    flat = torch.zeros(2 * 8 * 64 + 1, device="cuda", dtype=torch.bfloat16)
    bad = flat[1:].view(2, 8, 1, 64)  # base 2 bytes past 16
    good = torch.zeros_like(bad)
    stats = torch.zeros(2, 1, 8, device="cuda")
    before = {name: k.launches for name, k in KERNELS.items()}
    for name, call in (
            ("flash_fwd", lambda: flash_fwd(bad, good, good, 0.125)),
            ("flash_bwd_dq", lambda: flash_bwd_dq(good, good, good, bad,
                                                   stats, stats, 0.125)),
            ("flash_bwd_dkv", lambda: flash_bwd_dkv(good, bad, good, good,
                                                     stats, stats, 0.125))):
        try:
            call()
        except ValueError as e:
            print(f"{name} refuses a misaligned view: {e}")
        else:
            fail(f"{name} took a view whose rows are not 16-byte aligned")
    if {name: k.launches for name, k in KERNELS.items()} != before:
        fail("a refused call launched a kernel")


def bwd_cases():
    """(label, B, Sq, Skv, H, D, dtype, timed, strided dO, main_path).
    The KL-VAE's mid-block attention in stage-1 KL-VAE training is the
    fp32 d = 512 shape at batch 8, the VQ-VAE's in VQ-GAN training the
    bf16 one."""
    return [
        ("unet_mid_train", 8, 16, 16, 8, 64, "bfloat16", True, False, True),
        ("unet_mid_train_strided_do", 8, 16, 16, 8, 64, "bfloat16", False,
         True, False),
        ("kl_vae_mid_train", 8, 1024, 1024, 1, 512, "float32", True, False,
         True),
        ("vqvae_mid_train", 8, 1024, 1024, 1, 512, "bfloat16", True, False,
         True),
        ("ragged_d512", 2, 100, 100, 1, 512, "float32", False, True, False),
        ("ragged_cross", 2, 64, 17, 4, 32, "float32", False, True, False),
        ("ragged_tiny_bf16", 1, 7, 7, 2, 16, "bfloat16", False, False,
         False),
        ("ragged_d512_bf16", 2, 100, 100, 1, 512, "bfloat16", False, True,
         False),
        ("ragged_d24_bf16", 2, 40, 40, 3, 24, "bfloat16", False, False,
         False),
        ("ragged_d24", 2, 40, 40, 3, 24, "float32", False, True, False),
        ("short_kv_bf16", 3, 130, 9, 2, 64, "bfloat16", False, True, False),
        ("ragged_d64", 1, 33, 47, 2, 64, "float32", False, False, False),
        ("ragged_d128", 2, 70, 50, 2, 128, "float32", False, True, False),
        ("ragged_d128_bf16", 2, 70, 50, 2, 128, "bfloat16", False, False,
         False),
        ("ragged_d256", 1, 80, 90, 2, 256, "float32", False, False, False),
        ("ragged_d256_bf16", 1, 80, 90, 2, 256, "bfloat16", False, True,
         False),
        # the end-to-end demo's VQ-GAN at 128 px
        ("vqvae128_mid_train", 8, 256, 256, 1, 512, "bfloat16", False,
         False, False),
    ]


def backward_work(b, s_q, s_kv, h, d, itemsize) -> dict:
    """{kernel name: (bytes, operations)} of the backward kernels at
    [b, s_q, h, d] with s_kv kv rows: each input read once and each output
    written once (LSE and delta in fp32), 2 operations per multiply-add of
    the products (dQ: S, dP, dS K; dK/dV: S, dP, P^T dO, dS^T Q)."""
    n_q, n_kv = b * s_q * h * d, b * s_kv * h * d
    stats = 2 * 4 * b * h * s_q
    return {
        "flash_bwd_dq": ((3 * n_q + 2 * n_kv) * itemsize + stats,
                         6 * b * h * s_q * s_kv * d),
        "flash_bwd_dkv": ((2 * n_q + 4 * n_kv) * itemsize + stats,
                          8 * b * h * s_q * s_kv * d),
    }


def backward_in_fp64(torch, q, k, v, do, lse, delta, scale) -> dict:
    """{"dq", "dk", "dv"}: the backward kernels' math on the same inputs
    (the same LSE and delta) in fp64, rounded once to the input dtype."""
    qs = q.double() * scale
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qs, k.double())
                  - lse.double()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.double(), v.double())
    ds = p * (dp - delta.double()[..., None])
    return {"dq": (torch.einsum("bhqk,bkhd->bqhd", ds, k.double())
                   * scale).to(q.dtype),
            "dk": torch.einsum("bhqk,bqhd->bkhd", ds, qs).to(k.dtype),
            "dv": torch.einsum("bhqk,bqhd->bkhd", p, do.double()).to(
                v.dtype)}


def check_flash_bwd(torch, peaks, seed: int):
    """dQ and dK/dV kernels against their plain versions on the card, on
    (q, k, v, dO) from a seed and the forward kernel's out and LSE.
    Tolerance, relative to the largest plain value: fp32 2e-5 (the same
    fp32 math summed in another order), bf16 1e-2 (the same fp32 sums, then
    one rounding to bf16's 8 bits, at most 2^-7 of the value), and at the
    VQ-VAE's bf16 shape `_BF16_RULE`; there dK/dV must also repeat bit for
    bit (each element is summed in one fixed order)."""
    import torch.nn.functional as F

    from vqgan_tpu_torch.kernels.flash_bwd import flash_bwd_dkv, flash_bwd_dq
    from vqgan_tpu_torch.kernels.flash_fwd import flash_fwd
    from vqgan_tpu_torch.kernels.ops import flash_bwd_dkv_op, flash_bwd_dq_op
    from vqgan_tpu_torch.ops.attention import (
        flash_bwd_dkv_reference,
        flash_bwd_dq_reference,
        flash_delta,
    )

    rows = {}
    rng = np.random.default_rng(seed + 1)
    for label, b, s_q, s_kv, h, d, dt, timed, strided, main in bwd_cases():
        dtype = getattr(torch, dt)

        def make(s):
            x = rng.standard_normal((b, s, h, d)).astype(np.float32)
            return torch.from_numpy(x).to("cuda", dtype)

        q, k, v, do = make(s_q), make(s_kv), make(s_kv), make(s_q)
        if strided:
            # batch/sequence/head strides the kernels read in place
            do = torch.cat([do, do], dim=-1)[..., :d]
            k = torch.cat([k, k], dim=-1)[..., :d]
        scale = 1.0 / np.sqrt(d)
        out, lse = flash_fwd(q, k, v, scale)
        delta = flash_delta(out, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale)
        torch.cuda.synchronize()
        ref_dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, scale)
        ref_dk, ref_dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 scale)
        tol = 2e-5 if dt == "float32" else 1e-2
        errs, sizes, shares = {}, {}, {}
        for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                               ("dv", dv, ref_dv)):
            err = (got.float() - ref.float()).abs().max().item()
            size = sizes[name] = ref.float().abs().max().item()
            errs[name] = err
            shares[name] = differ(got, ref)
            if (not bool(torch.isfinite(got).all())
                    or err > tol * max(size, 1.0)):
                fail(f"flash_bwd {name} disagrees with its plain version at "
                     f"{label}: max err {err:.3e}, max |plain| {size:.3e}, "
                     f"tolerance {tol} relative")
        print(f"flash_bwd {label} [{b},{s_q},{h},{d}] kv={s_kv} {dt}"
              f"{' strided dO' if strided else ''}: "
              + " ".join(f"max|{n}-plain|={e:.3e} (max|plain| "
                         f"{sizes[n]:.3e}, {e / sizes[n]:.3e} of it"
                         f"{shares[n]})"
                         for n, e in errs.items()))
        if label == "vqvae_mid_train":
            exact = backward_in_fp64(torch, q, k, v, do, lse, delta, scale)
            for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                                   ("dv", dv, ref_dv)):
                size = sizes[name]
                got_off = (got.float() - exact[name].float()).abs().max()
                plain_off = (ref.float() - exact[name].float()).abs().max()
                print(f"flash_bwd {name} {label}: {errs[name] / size:.3e} of "
                      f"max|plain| from plain (rule {_BF16_RULE}); from an "
                      f"fp64 evaluation: kernel {got_off.item() / size:.3e}, "
                      f"plain {plain_off.item() / size:.3e}")
                if errs[name] > _BF16_RULE * size and not (
                        plain_off > _BF16_RULE * size
                        and got_off <= plain_off):
                    fail(f"flash_bwd {name} at {label}: over {_BF16_RULE} "
                         f"of the largest plain value from plain")
            dk2, dv2 = flash_bwd_dkv(q, k, v, do, lse, delta, scale)
            repeat = torch.equal(dk2, dk) and torch.equal(dv2, dv)
            print(f"flash_bwd_dkv {label}: a second run is "
                  f"{'equal bit for bit' if repeat else 'NOT equal'}")
            if not repeat:
                fail(f"flash_bwd_dkv does not repeat bit for bit at {label}")
        if not timed:
            continue

        iters = 20 if s_q >= 1024 else 200
        ms = {
            "flash_bwd_dq": cuda_ms(torch, lambda: flash_bwd_dq_op(
                q, k, v, do, lse, delta, scale), iters),
            "flash_bwd_dkv": cuda_ms(torch, lambda: flash_bwd_dkv_op(
                q, k, v, do, lse, delta, scale), iters),
        }
        dev = {
            "flash_bwd_dq": device_ms(torch, lambda: flash_bwd_dq_op(
                q, k, v, do, lse, delta, scale), iters),
            "flash_bwd_dkv": device_ms(torch, lambda: flash_bwd_dkv_op(
                q, k, v, do, lse, delta, scale), iters),
        }
        plain = {
            "flash_bwd_dq": cuda_ms(torch, lambda: flash_bwd_dq_reference(
                q, k, v, do, lse, delta, scale), iters),
            "flash_bwd_dkv": cuda_ms(torch, lambda: flash_bwd_dkv_reference(
                q, k, v, do, lse, delta, scale), iters),
        }
        # library yardstick: the whole backward (dQ, dK and dV) of PyTorch's
        # fused attention, its forward outside the timed loop
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        g = do.transpose(1, 2)
        library_ms = cuda_ms(
            torch, lambda: lib_out.backward(g, retain_graph=True), iters)
        # its device time: autograd runs each backward op on its forward
        # op's stream, so fresh leaves and the forward go on the stream the
        # graph captures, and autograd.grad returns the gradients without
        # accumulating them into the leaves
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
            side_out = F.scaled_dot_product_attention(*leaves, scale=scale)
        lib_dev_ms = device_ms(
            torch, lambda: torch.autograd.grad(side_out, leaves, g,
                                               retain_graph=True),
            iters, stream=side)
        work = backward_work(b, s_q, s_kv, h, d, q.element_size())
        for name, (n_bytes, flops) in work.items():
            bound_ms, bound_by = bound(peaks, n_bytes, flops, dt)
            err = errs["dq"] if name == "flash_bwd_dq" else max(
                errs["dk"], errs["dv"])
            row = {
                "name": name,
                "key": (b, s_q, h, d, dt),
                "shape": f"[{b},{s_q},{h},{d}] {dt}",
                "route": "cuda",
                "source": f"vqgan_tpu_torch/csrc/{name}.cu",
                "replaces": ("vqgan_tpu/ops/attention.py:190"
                             if name == "flash_bwd_dq"
                             else "vqgan_tpu/ops/attention.py:221"),
                "launches": None,
                "max_abs_err": err,
                "ms": ms[name],
                "plain_ms": plain[name],
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": library_ms,
            }
            if main:
                rows[(name, label)] = row
            print(f"{name} {label}: kernel_ms={ms[name]:.4f} (device "
                  f"{dev[name]:.4f}) plain_ms={plain[name]:.4f} "
                  f"bound_ms={bound_ms:.6f} ({bound_by})")
        print(f"flash_bwd {label}: dq+dkv kernel_ms="
              f"{sum(ms.values()):.4f} (device {sum(dev.values()):.4f}) vs "
              f"library backward (dq, dk, dv) ms={library_ms:.4f} (device "
              f"{lib_dev_ms:.4f})")
    return rows


# A kernel index may differ from the plain version's only where the plain
# version's two scores lie within this fraction of |z|^2 + |e|^2, the size
# of the terms the score sums: the dot product is summed in another order
# (fp32 rounding of a 256-term sum is ~1e-7 of that size) and, in the exact
# mode, as 3xTF32 on the tensor cores (the dropped lo*lo term and the
# rounding of lo are ~2^-21 of each product), so a near-tie can go either
# way. z_q must then equal wherever the indices do.
_VQ_FLIP_RTOL = 1e-6


def vq_index_flips(torch, z, codebook, got, want, mode: str, rtol: float):
    """(number of rows where `got` != `want`, number of them that are not
    near-ties within `rtol` by the plain version's scores, the largest
    score excess of a `got` pick over the `want` pick)."""
    from vqgan_tpu_torch.ops.vq import vq_scores

    rows = torch.nonzero(got != want).flatten()
    if rows.numel() == 0:
        return 0, 0, 0.0
    scores = vq_scores(z[rows], codebook, mode)
    got_s = scores.gather(1, got[rows].long()[:, None]).squeeze(1)
    want_s = scores.gather(1, want[rows].long()[:, None]).squeeze(1)
    e_sq = (codebook.float() ** 2).sum(1)
    scale = (z[rows].float() ** 2).sum(1) + e_sq[want[rows].long()]
    far = (got_s - want_s).abs() > rtol * scale
    return (int(rows.numel()), int(far.sum()),
            (got_s - want_s).max().item())


def vq_cases():
    """(label, N, K, D, duplicates, main_path): the main path's shape (a
    batch of 8 32x32 latent grids against the 128-code codebook), the
    JAX package's bench shape (K = 8192), a ragged one, one whose codebook
    repeats rows (ties must go to the lowest index), one whose rows
    (D = 33) are not a multiple of 16 bytes, so the wrapper pads them, and
    one wider than the kernel's 256 resident columns (D = 300)."""
    return [
        ("vqgan_main", 8192, 128, 256, False, True),
        ("bench_k8192", 8192, 8192, 256, False, False),
        ("ragged", 777, 130, 40, False, False),
        ("ties", 777, 130, 40, True, False),
        ("ragged_d33", 777, 130, 33, False, False),
        ("wide_d300", 300, 70, 300, False, False),
        # the end-to-end demo's VQ-GAN at 128 px: training (batch 8) and
        # the latent audit (batch 16)
        ("vqgan128_train", 2048, 128, 256, False, False),
        ("vqgan128_audit", 4096, 128, 256, False, False),
    ]


def vq_work(n: int, k: int, d: int):
    """(bytes, operations) of one nearest-code search: z, the codebook and
    |e|^2 read once (fp32, as the wrapper takes them), the indices and the
    usage written once; 2 N K D operations for the cross term."""
    return 4 * (n * d + k * d + k + n + k), 2 * n * k * d


def check_vq(torch, peaks, seed: int):
    """The VQ kernel in both modes against its plain version on the card:
    indices (exact but for near-ties, `_VQ_FLIP_RTOL`), z_q where the
    indices agree, the fused usage histogram against `bincount`. Times the
    kernel, the plain version and the reference's own route (addmm,
    argmin, index_select) at the timed shapes."""
    from vqgan_tpu_torch.kernels.ops import vq_nearest_op
    from vqgan_tpu_torch.kernels.vq import vq_nearest
    from vqgan_tpu_torch.ops.vq import (
        codebook_usage,
        vq_lookup,
        vq_lookup_reference,
    )

    rows = {}
    device_times = {}  # device ms of each timed shape and mode
    rng = np.random.default_rng(seed + 3)
    for label, n, k, d, dup, main in vq_cases():
        cb = rng.standard_normal((k, d)).astype(np.float32)
        if dup:
            cb[k // 2:] = cb[:k - k // 2]  # every code twice
            z = cb[rng.integers(0, k, n)] + 0.05 * rng.standard_normal(
                (n, d)).astype(np.float32)
        else:
            z = rng.standard_normal((n, d)).astype(np.float32)
        z, cb = (torch.from_numpy(a).to("cuda") for a in (z, cb))
        e_sq = (cb * cb).sum(1)
        for mode, use_kernel in (("fp32", "fp32"), ("bf16", True)):
            idx, usage = vq_nearest(z, cb, e_sq, mode)
            zq, idx_op, usage_op = vq_lookup(z, cb, use_kernel)
            torch.cuda.synchronize()
            ref_zq, ref_idx = vq_lookup_reference(z, cb, mode)
            flips, far, score_err = vq_index_flips(
                torch, z, cb, idx, ref_idx, mode, _VQ_FLIP_RTOL)
            same = idx == ref_idx
            zq_err = (zq - ref_zq)[same].abs().max().item() if same.any() \
                else 0.0
            hist_ok = torch.equal(usage, codebook_usage(idx, k)) and \
                torch.equal(usage_op, usage) and torch.equal(idx_op, idx)
            print(f"vq_nearest {label} [{n},{d}]x[{k},{d}] {mode}: "
                  f"{flips} index flips vs plain ({far} not near-ties, "
                  f"largest score excess {score_err:.3e}), "
                  f"max|z_q-plain| where equal {zq_err:.3e}, usage "
                  f"{'= bincount' if hist_ok else '!= bincount'}")
            if far or zq_err != 0.0 or not hist_ok or int(usage.sum()) != n:
                fail(f"vq_nearest disagrees with its plain version at "
                     f"{label} {mode}")
            if dup and (idx >= k // 2).any():  # the upper copies
                fail("vq_nearest broke a tie toward a higher index")
            if label not in ("vqgan_main", "bench_k8192"):
                continue

            iters = 20 if k >= 8192 else 200
            # the host time through the operator (which also computes
            # |e|^2), the device time of the kernel alone
            kernel_ms = cuda_ms(
                torch, lambda: vq_nearest_op(z, cb, mode), iters)
            dev_ms = device_ms(
                torch, lambda: vq_nearest(z, cb, e_sq, mode), iters)
            plain_ms = cuda_ms(
                torch, lambda: vq_lookup_reference(z, cb, mode), iters)

            def library():
                dist = torch.addmm((z * z).sum(1, keepdim=True) + e_sq, z,
                                   cb.t(), alpha=-2.0)
                return cb.index_select(0, torch.argmin(dist, dim=1))

            library_ms = cuda_ms(torch, library, iters)
            lib_dev_ms = device_ms(torch, library, iters)
            bound_ms, bound_by = bound(
                peaks, *vq_work(n, k, d),
                "float32" if mode == "fp32" else "bfloat16")
            row = {
                "name": "vq_nearest",
                "key": (n, k, d, mode),
                "shape": f"[{n},{d}]x[{k},{d}] {mode}",
                "route": "cuda",
                "source": "vqgan_tpu_torch/csrc/vq.cu",
                "replaces": "vqgan_tpu/ops/vq.py:76",
                "launches": None,
                "max_abs_err": score_err,  # of the picked code's score
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": library_ms,
            }
            if main and mode == "fp32":  # the main path's mode
                rows[("vq_nearest", label)] = row
            device_times[f"{label} {mode}"] = {
                "kernel": dev_ms, "library": lib_dev_ms, "bound": bound_ms}
            print(f"vq_nearest {label} {mode}: kernel_ms={kernel_ms:.4f} "
                  f"(device {dev_ms:.4f}) plain_ms={plain_ms:.4f} "
                  f"library_ms={library_ms:.4f} (device {lib_dev_ms:.4f}) "
                  f"bound_ms={bound_ms:.6f} ({bound_by})")
    print("vq_nearest device ms (CUDA graph): " + json.dumps(device_times))
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


def reset_counts(kernels):
    for k in kernels.values():
        k.launches = 0
        k.launches_by_shape.clear()


def read_counts(kernels) -> dict:
    """{(kernel name, shape key): launches} since the last reset."""
    return {(name, key): n for name, k in kernels.items()
            for key, n in k.launches_by_shape.items()}


def check_small_training(torch, kernels, seed: int):
    """Three training steps of a tiny fp32 U-Net on the card and on the CPU
    from the same weights, with injected t, noise and cond-drop mask (TF32
    off). Tolerances:
    - first-step gradients, 1e-3 of the largest: the same fp32 math through
      ~40 layers forward and back, summed in other orders (cuDNN, the
      kernels) on the two devices;
    - losses, rtol 1e-3;
    - parameters and EMA, as their moves from the initial weights: the
      card's move differs from the CPU's by at most 5% in norm (a card run
      that skipped one of the 3 updates would be ~30% off, one with no
      update 100%), and by more than lr / 2 in at most 10 elements. Adam's
      first steps are sign-like (m / sqrt(v) is +-1 for a lone gradient),
      so a gradient element near zero whose sign differs between the
      devices moves its weight by about lr one way on one and the other
      way on the other; every other element agrees to rounding (2.4e-6 at
      lr 1e-4 in the runs so far)."""
    import copy

    from vqgan_tpu_torch.diffusion import GaussianDiffusion
    from vqgan_tpu_torch.models import CFGUnet
    from vqgan_tpu_torch.training.ldm_step import (
        LDMTrainState,
        make_ldm_optimizer,
        make_ldm_train_step,
    )

    n_steps, b, lr = 3, 4, 1e-4
    torch.manual_seed(seed)
    init = CFGUnet(dim=16, num_classes=3, cond_drop_prob=0.0,
                   dim_mults=(1, 2), channels=4, attn_dim_head=16,
                   attn_heads=2)
    rng = np.random.default_rng(seed + 2)
    lat = rng.standard_normal((n_steps, b, 8, 8, 4)).astype(np.float32)
    noise = rng.standard_normal((n_steps, b, 8, 8, 4)).astype(np.float32)
    ts = rng.integers(0, 20, (n_steps, b))
    classes = rng.integers(0, 3, (n_steps, b))
    masks = rng.random((n_steps, b)) < 0.5
    out = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(init).to(dev).train()
        diffusion = GaussianDiffusion(
            model, image_size=8, channels=4, timesteps=20,
            objective="pred_v", min_snr_loss_weight=True,
            auto_normalize=False, device=torch.device(dev))

        def inputs(i):
            return dict(latents=torch.from_numpy(lat[i]).to(dev),
                        classes=torch.from_numpy(classes[i]).to(dev),
                        t=torch.from_numpy(ts[i]).to(dev),
                        noise=noise[i],
                        cond_drop_mask=torch.from_numpy(masks[i]).to(dev))

        first = inputs(0)
        diffusion.loss(first["latents"], first["classes"], t=first["t"],
                       noise=first["noise"],
                       cond_drop_mask=first["cond_drop_mask"]).backward()
        grads = torch.cat([p.grad.flatten().cpu() for p in model.parameters()
                           if p.grad is not None])
        model.zero_grad(set_to_none=True)

        opt = make_ldm_optimizer(model.parameters(), learning_rate=lr,
                                 weight_decay=1e-4, betas=(0.9, 0.99),
                                 max_grad_norm=1.0)
        state = LDMTrainState(0, model,
                              copy.deepcopy(model).requires_grad_(False), opt)
        step = make_ldm_train_step(diffusion, opt, ema_update_every=1,
                                   ema_update_after_step=1)
        reset_counts(kernels)
        losses = []
        for i in range(n_steps):
            x = inputs(i)
            log = step(state, x.pop("latents"), x.pop("classes"), **x)
            losses.append(float(log["loss"]))
        launches = {name: kernels[name].launches for name in FLASH}

        def flat(m):
            return torch.cat([p.detach().flatten().cpu()
                              for p in m.parameters()])
        out[dev] = (grads, losses, flat(model), flat(state.ema_model),
                    launches)

    (g_cpu, l_cpu, p_cpu, e_cpu, _), (g_gpu, l_gpu, p_gpu, e_gpu, launches) \
        = out["cpu"], out["cuda"]
    p_init = torch.cat([p.detach().flatten() for p in init.parameters()])
    grad_err = (g_gpu - g_cpu).abs().max().item()
    grad_size = g_cpu.abs().max().item()
    loss_err = max(abs(a - c) / abs(c) for a, c in zip(l_gpu, l_cpu))
    moves = {}  # name: (max|diff|, |move diff| / |CPU move|, n over lr/2)
    for name, on_card, on_cpu in (("param", p_gpu, p_cpu),
                                  ("ema", e_gpu, e_cpu)):
        diff = on_card - on_cpu
        cpu_move = (on_cpu - p_init).norm().item()
        if cpu_move == 0.0:
            fail(f"the CPU's {name}s did not move in {n_steps} steps")
        moves[name] = (diff.abs().max().item(), diff.norm().item() / cpu_move,
                       int((diff.abs() > lr / 2).sum()))
    print(f"small training, card vs CPU: max|grad diff|={grad_err:.3e} "
          f"(max|grad| {grad_size:.3e}), losses card {l_gpu} cpu {l_cpu} "
          f"(max rel diff {loss_err:.3e}); "
          + ", ".join(f"{n}s: max|diff|={m:.3e}, |move diff|/|cpu move|="
                      f"{r:.3e}, {k} over lr/2"
                      for n, (m, r, k) in moves.items())
          + f"; launches on the card {launches}")
    if grad_err > 1e-3 * grad_size or loss_err > 1e-3 \
            or any(r > 0.05 or k > 10 for _, r, k in moves.values()) \
            or not all(np.isfinite(l_gpu)):
        fail("training on the card disagrees with the CPU")
    if any(n != n_steps for n in launches.values()):
        fail(f"expected {n_steps} launches of each flash kernel in "
             f"{n_steps} training steps, got {launches}")


def _flat(torch, module, params_only=True):
    """The module's parameters (or its BatchNorm running statistics) as
    one CPU vector."""
    return torch.cat([v.detach().flatten().cpu().float()
                      for k, v in module.state_dict().items()
                      if params_only != ("running" in k)])


def check_small_vqgan(torch, kernels, seed: int):
    """Three VQ-GAN training steps of a tiny fp32 config on the card and on
    the CPU from the same weights and images (TF32 off), disc_start 1: step
    0 is G only, steps 1-2 G + D. Tolerances:
    - indices of the initial encoder's z, exact but for near-ties within
      1e-4 of |z|^2 + |e|^2 by the CPU's scores: the encoders' outputs
      differ by cuDNN's and the CPU's summation orders (~1e-6 relative);
    - usage counts of every step, exact where the indices agree;
    - losses, rtol 1e-4;
    - the first G step's gradients, codebook included, 1e-3 of the largest;
    - BatchNorm running statistics, 1e-4 (convolutions summed in other
      orders before each norm);
    - parameter moves from the initial weights: the card's differs from
      the CPU's by at most 5% in norm and by over lr / 2 in at most 1% of
      the elements (Adam's first steps are sign-like, and conv biases under
      GroupNorm have a gradient of exactly 0 in exact arithmetic, rounding
      noise in practice: such an element moves by about lr either way).
    One VQ launch per step and 5 launches of each flash kernel per G step
    (attention at 16 px: 1 in the encoder's level, 2 in the decoder's, and
    the two mid blocks); none in the D steps."""
    import copy

    from vqgan_tpu_torch.models import LPIPS, VQVAE, PatchGANDiscriminator
    from vqgan_tpu_torch.models.lpips import perceptual_loss_fn
    from vqgan_tpu_torch.training import (
        VQGANTrainState,
        make_gan_optimizers,
        make_vqgan_split_steps,
    )

    n_steps, b, lr = 3, 4, 4.5e-5
    torch.manual_seed(seed)
    vq_init = VQVAE(ch=16, ch_mult=(1, 2), num_res_blocks=1, resolution=32,
                    z_channels=16, num_embeddings=8, embedding_dim=16)
    d_init = PatchGANDiscriminator(ndf=8, n_layers=2)
    lpips_init = LPIPS()
    images = np.random.default_rng(seed + 4).random(
        (n_steps, b, 32, 32, 3)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        vqvae = copy.deepcopy(vq_init).to(dev)
        disc = copy.deepcopy(d_init).to(dev)
        lpips = copy.deepcopy(lpips_init).to(dev).eval().requires_grad_(False)
        opt_g, opt_d = make_gan_optimizers(vqvae.parameters(),
                                           disc.parameters(),
                                           learning_rate=lr,
                                           disc_learning_rate=lr)
        grads = []
        g_update = opt_g.step

        def record(g, norm=None, g_update=g_update, grads=grads):
            if not grads:  # the first G step's gradients, before clipping
                grads.append(torch.cat([t.detach().flatten().cpu()
                                        for t in g]))
            return g_update(g, norm)

        opt_g.step = record
        g_step, d_step = make_vqgan_split_steps(
            disc_start=1, perceptual_fn=perceptual_loss_fn(lpips))
        state = VQGANTrainState(0, vqvae, disc, opt_g, opt_d)
        with torch.no_grad():
            x0 = torch.from_numpy(images[0]).to(dev).permute(0, 3, 1, 2)
            z = vqvae.encode_pre_quant(x0).permute(0, 2, 3, 1).reshape(-1, 16)
            idx = vqvae.encode_to_indices(x0).flatten()
        reset_counts(kernels)
        logs = []
        for i in range(n_steps):
            x = torch.from_numpy(images[i]).to(dev)
            recon, log = g_step(state, x)
            if i >= 1:
                log.update(d_step(state, x, recon))
            logs.append({k: v.cpu() for k, v in log.items()})
        launches = {name: k.launches for name, k in kernels.items()}
        out[dev] = dict(z=z.cpu(), idx=idx.cpu(), logs=logs, grads=grads[0],
                        vq=_flat(torch, vqvae), d=_flat(torch, disc),
                        stats=_flat(torch, disc, params_only=False),
                        launches=launches)

    cpu, gpu = out["cpu"], out["cuda"]
    codebook = vq_init.quantizer.embedding.weight.detach()
    flips, far, _ = vq_index_flips(torch, cpu["z"], codebook, gpu["idx"],
                                   cpu["idx"], "fp32", 1e-4)
    loss_err = max(abs(g[k].item() - c[k].item()) / max(abs(c[k].item()),
                                                        1e-12)
                   for g, c in zip(gpu["logs"], cpu["logs"])
                   for k in c if k != "usage_counts")
    usage_ok = flips > 0 or all(
        torch.equal(g["usage_counts"], c["usage_counts"])
        for g, c in zip(gpu["logs"], cpu["logs"]))
    grad_err = (gpu["grads"] - cpu["grads"]).abs().max().item()
    grad_size = cpu["grads"].abs().max().item()
    stats_err = (gpu["stats"] - cpu["stats"]).abs().max().item()
    moves = {}
    for name, init in (("vq", _flat(torch, vq_init)),
                       ("d", _flat(torch, d_init))):
        cpu_move = cpu[name] - init
        diff = gpu[name] - cpu[name]
        if cpu_move.norm().item() == 0.0:
            fail(f"the CPU's {name} parameters did not move")
        moves[name] = (diff.norm().item() / cpu_move.norm().item(),
                       (diff.abs() > lr / 2).float().mean().item())
    expected = {"vq_nearest": n_steps, "flash_fwd": 5 * n_steps,
                "flash_bwd_dq": 5 * n_steps, "flash_bwd_dkv": 5 * n_steps}
    print(f"small VQ-GAN training, card vs CPU: {flips} index flips ({far} "
          f"not near-ties); max rel loss diff {loss_err:.3e}; max|grad "
          f"diff|={grad_err:.3e} (max|grad| {grad_size:.3e}); max|BN stats "
          f"diff|={stats_err:.3e}; "
          + ", ".join(f"{n} moves: |diff|/|cpu move|={r:.3e}, {f:.2%} over "
                      f"lr/2" for n, (r, f) in moves.items())
          + f"; launches on the card {gpu['launches']}")
    if far or not usage_ok or loss_err > 1e-4 \
            or grad_err > 1e-3 * grad_size or stats_err > 1e-4 \
            or any(r > 0.05 or f > 0.01 for r, f in moves.values()):
        fail("VQ-GAN training on the card disagrees with the CPU")
    if gpu["launches"] != expected:
        fail(f"expected launches {expected} in {n_steps} VQ-GAN steps, got "
             f"{gpu['launches']}")


def check_small_kl_vae(torch, kernels, seed: int):
    """Three KL-VAE training steps of a small fp32 config on the card and
    on the CPU from the same weights, images and injected posterior noise
    (TF32 off), at the CLI's learning rate and KL weight. The config (ch
    128, mults 1-4, 1 res block, 64 px) keeps the main path's attention:
    its mid blocks run at 32x32 with 512 channels, so each flash kernel
    runs its fp32 d = 512 instance at [2, 1024, 1, 512]. Tolerances, of
    phase 4c's kind:
    - loss parts, rtol 1e-4;
    - the first step's gradients, 1e-3 of the largest;
    - parameter moves from the initial weights: the card's differs from
      the CPU's by at most 5% in norm and by over lr / 2 in at most 1% of
      the elements (Adam's first steps are sign-like, and conv biases under
      GroupNorm have a gradient of exactly 0 in exact arithmetic, rounding
      noise in practice: such an element moves by about lr either way).
    Two launches of each flash kernel per step (the encoder's and the
    decoder's mid block) and no VQ launch."""
    import copy

    from vqgan_tpu_torch.models.autoencoder import AutoencoderConfig, KLVAE
    from vqgan_tpu_torch.training import (
        make_kl_vae_optimizer,
        make_kl_vae_train_step,
    )

    n_steps, b, lr = 3, 2, 4.5e-6
    torch.manual_seed(seed)
    init = KLVAE(AutoencoderConfig(ch=128, ch_mult=(1, 4), num_res_blocks=1,
                                   resolution=64))
    rng = np.random.default_rng(seed + 5)
    images = rng.random((n_steps, b, 64, 64, 3)).astype(np.float32)
    noise = rng.standard_normal((n_steps, b, 4, 32, 32)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        vae = copy.deepcopy(init).to(dev)
        opt = make_kl_vae_optimizer(vae.parameters(), lr, "constant", 50000)
        grads, update = [], opt.step

        def record(g, norm=None, update=update, grads=grads):
            if not grads:  # the first step's gradients, before clipping
                grads.append(torch.cat([t.detach().flatten().cpu()
                                        for t in g]))
            return update(g, norm)

        opt.step = record
        step = make_kl_vae_train_step(vae, opt)
        reset_counts(kernels)
        logs = []
        for i in range(n_steps):
            parts = step(torch.from_numpy(images[i]).to(dev),
                         noise=noise[i])
            logs.append({k: v.item() for k, v in parts.items()})
        out[dev] = dict(logs=logs, grads=grads[0], params=_flat(torch, vae),
                        launches=read_counts(kernels))

    cpu, gpu = out["cpu"], out["cuda"]
    loss_err = max(abs(g[k] - c[k]) / max(abs(c[k]), 1e-12)
                   for g, c in zip(gpu["logs"], cpu["logs"])
                   for k in ("loss", "rec_loss", "kl_loss"))
    grad_err = (gpu["grads"] - cpu["grads"]).abs().max().item()
    grad_size = cpu["grads"].abs().max().item()
    cpu_move = cpu["params"] - _flat(torch, init)
    diff = gpu["params"] - cpu["params"]
    if cpu_move.norm().item() == 0.0:
        fail("the CPU's KL-VAE parameters did not move")
    move_norm = diff.norm().item() / cpu_move.norm().item()
    move_miss = (diff.abs() > lr / 2).float().mean().item()
    key = (b, 1024, 1, 512, "float32")
    expected = {(name, key): 2 * n_steps for name in FLASH}
    print(f"small KL-VAE training, card vs CPU: losses card "
          f"{[g['loss'] for g in gpu['logs']]} cpu "
          f"{[c['loss'] for c in cpu['logs']]} (max rel diff of the parts "
          f"{loss_err:.3e}); max|grad diff|={grad_err:.3e} (max|grad| "
          f"{grad_size:.3e}); moves: |diff|/|cpu move|={move_norm:.3e}, "
          f"{move_miss:.2%} over lr/2; launches on the card "
          f"{gpu['launches']}")
    if loss_err > 1e-4 or grad_err > 1e-3 * grad_size or move_norm > 0.05 \
            or move_miss > 0.01:
        fail("KL-VAE training on the card disagrees with the CPU")
    if gpu["launches"] != expected:
        fail(f"expected launches {expected} in {n_steps} KL-VAE steps, got "
             f"{gpu['launches']}")


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
    """Full-width generation; returns ({(kernel, shape): launches},
    samples/s)."""
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
    counts = {}
    rates = {}
    for label, extra, n_batches in runs:
        reset_counts(kernels)
        result, secs = run_generate(
            torch, [*common, *extra, "--output_dir", str(OUT / "generated")])
        run_counts = read_counts(kernels)
        launches = flash.launches
        shapes = dict(flash.launches_by_shape)
        check_images(result["images"], n_batches * batch)
        batch_secs = sum(result["batch_seconds"])
        rates[label] = n_batches * batch / batch_secs
        print(f"generate {label}: {n_batches} batch(es) of {batch} in "
              f"{batch_secs:.3f} s = {rates[label]:.4f} samples/s (whole "
              f"call with model set-up {secs:.3f} s); flash_fwd launches "
              f"{launches} by shape {shapes}")
        if launches != 151 * n_batches or any(
                k.launches for name, k in kernels.items()
                if name != "flash_fwd"):
            fail(f"flash_fwd launched {launches} times for {n_batches} "
                 f"batch(es), expected 151 per batch and no backward "
                 f"launch: {run_counts}")
        for key, n in run_counts.items():
            counts[key] = counts.get(key, 0) + n
    return counts, rates


def write_latent_data(work: Path, seed: int):
    """A split of 31 users ID_1..ID_31 with 50 training images each, and
    their latents, [32, 32, 4] fp32 from a numpy seed, in the latent cache's
    `user_{label:02d}_{stem}.npy` naming (about 25 MB)."""
    from vqgan_tpu_torch.data import LatentCache, save_split

    rng = np.random.default_rng(seed)
    cache = LatentCache(work / "latents_cache")
    split = {"metadata": {"method": "chip_smoke", "seed": seed}, "users": {}}
    for user in range(1, 32):
        names = [f"frame_{i:03d}.png" for i in range(50)]
        split["users"][f"ID_{user}"] = {"train_images": names,
                                        "test_images": []}
        latents = rng.standard_normal((50, 32, 32, 4)).astype(np.float32)
        for name, z in zip(names, latents):
            cache.save(user - 1, name, z)
    save_split(split, work / "data_split.json")
    return work / "data_split.json", cache.folder


def drive_training(torch, kernels, seed: int, work: Path):
    """Full-width training through `train_latent_cfg.main`: 41 steps, then a
    resume to step 50; then generation from its checkpoint. Returns
    ({(kernel, shape): launches} of the training steps and of that
    generation, latents/s)."""
    from vqgan_tpu_torch import generate, train_latent_cfg
    from vqgan_tpu_torch.checkpoint import CheckpointManager
    from vqgan_tpu_torch.models import KLVAE

    split, cache = write_latent_data(work, seed)
    results = work / "results"
    common = ["--split", str(split), "--latents_cache_folder", str(cache),
              "--data_path", str(work / "images"), "--results_folder",
              str(results), "--seed", str(seed)]
    train_key = (8, 16, 8, 64, "bfloat16")

    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = train_latent_cfg.main([*common, "--train_num_steps", "41"])
    secs = time.perf_counter() - t0
    counts = read_counts(kernels)
    # the EMA's last warm copy is of these weights (step 40's update)
    warm = {k: v.detach().clone()
            for k, v in first["trainer"].model.state_dict().items()}
    del first["trainer"]
    reset_counts(kernels)
    second = train_latent_cfg.main([*common, "--train_num_steps", "50",
                                    "--resume", "-1"])
    trainer = second.pop("trainer")
    for key, n in read_counts(kernels).items():
        counts[key] = counts.get(key, 0) + n

    losses = first["losses"] + second["losses"]
    print(f"train_latent_cfg: {len(first['losses'])} + "
          f"{len(second['losses'])} steps (resumed), whole first call "
          f"{secs:.3f} s; {first['timed_steps']} steps after a warm-up of "
          f"5 in {first['timed_seconds']:.3f} s = "
          f"{first['latents_per_s']:.4f} latents/s; losses {losses}; "
          f"launches {counts}")
    if len(losses) != 50 or not all(np.isfinite(losses)):
        fail(f"expected 50 finite losses, got {losses}")
    expected = {(name, train_key): 50 for name in FLASH}
    if counts != expected:
        fail(f"expected one launch of each flash kernel per step at "
             f"{train_key}: {counts}")
    ema = trainer.ema_model.state_dict()
    online = trainer.model.state_dict()
    if trainer.state.step != 50 or any(
            not torch.equal(ema[k], warm[k]) for k in warm):
        fail("the EMA weights are not the warm copy of step 40")
    if all(torch.equal(ema[k], online[k]) for k in online):
        fail("the EMA weights equal the final online weights")
    ckpt = CheckpointManager(results, prefix="model")
    saved = ckpt.restore()
    if ckpt.latest_milestone() != 1 or saved["step"] != 50 or any(
            not torch.equal(saved["ema"][k], ema[k].cpu()) for k in ema):
        fail(f"checkpoint {ckpt.all_milestones()} does not load back")
    print(f"checkpoint {ckpt.path(1).name} ({ckpt.path(1).stat().st_size} "
          f"bytes) loads back at step {saved['step']}; EMA = step-40 warm "
          f"copy, != final weights")
    rate = first["latents_per_s"]
    del trainer, saved, warm, ema, online

    # generation from that checkpoint, with a seeded random KL-VAE file
    vae_pt = work / "kl_vae.pt"
    torch.manual_seed(seed)
    torch.save(KLVAE().state_dict(), vae_pt)
    reset_counts(kernels)
    result, gen_secs = run_generate(torch, [
        "--checkpoint", str(results), "--vae_weights", str(vae_pt),
        "--num_images", "16", "--batch_size", "16", "--user_ids", "1",
        "--seed", str(seed), "--output_dir", str(OUT / "from_checkpoint")])
    gen_counts = read_counts(kernels)
    check_images(result["images"], 16)
    print(f"generate --checkpoint: 16 images in {gen_secs:.3f} s; launches "
          f"{gen_counts}")
    if kernels["flash_fwd"].launches != 151 or any(
            k.launches for name, k in kernels.items() if name != "flash_fwd"):
        fail(f"generation from the checkpoint: expected 151 forward "
             f"launches and no backward launch, got {gen_counts}")
    for key, n in gen_counts.items():
        counts[key] = counts.get(key, 0) + n
    return counts, rate


def write_image_data(work: Path, seed: int):
    """A split of 31 users ID_1..ID_31 with 8 training JPGs each (the
    reference's 31 users; 8 images each instead of its 50, to keep the
    set-up short), 256x256: smooth seeded patterns (two colour gratings per
    image), not white noise, so the files stay small."""
    from PIL import Image

    from vqgan_tpu_torch.data import save_split

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32) / 256.0
    split = {"metadata": {"method": "chip_smoke", "seed": seed}, "users": {}}
    for user in range(1, 32):
        names = [f"frame_{i:03d}.jpg" for i in range(8)]
        folder = work / "images" / f"ID_{user}"
        folder.mkdir(parents=True)
        for name in names:
            f = rng.uniform(1.0, 8.0, (2, 3, 1, 1))
            phase = rng.uniform(0, 2 * np.pi, (2, 3, 1, 1))
            img = 0.5 + 0.25 * (np.sin(2 * np.pi * f[0] * xx + phase[0])
                                + np.cos(2 * np.pi * f[1] * yy + phase[1]))
            Image.fromarray((img.transpose(1, 2, 0) * 255).astype(
                np.uint8)).save(folder / name, quality=90)
        split["users"][f"ID_{user}"] = {"train_images": names,
                                        "test_images": []}
    save_split(split, work / "data_split.json")
    return work / "data_split.json", work / "images"


def drive_vqgan_training(torch, kernels, seed: int, work: Path):
    """Full-width stage-1 training through `train_vqgan.main` (VQGANConfig
    defaults: batch 8 at 256 px, bf16): 10 G-only steps (disc_start 10)
    with the off-cadence final save, then a resume to step 30 (G + D from
    step 10, saves at steps 20 and 30). Returns ({(kernel, shape):
    launches}, {"G only": images/s, "G + D": images/s})."""
    from vqgan_tpu_torch import train_vqgan
    from vqgan_tpu_torch.checkpoint import CheckpointManager
    from vqgan_tpu_torch.training.vqgan_trainer import VQGANTrainer

    split, images = write_image_data(work, seed)
    config = work / "vqgan_config.json"
    config.write_text(json.dumps({"seed": seed, "images_per_user_train": 8}))
    results = work / "vqgan"
    common = ["--config", str(config), "--split", str(split), "--data_path",
              str(images), "--results_folder", str(results),
              "--disc_start", "10", "--save_every", "20"]
    vq_key = (8192, 128, 256, "fp32")
    attn_key = (8, 1024, 1, 512, "bfloat16")

    def expected(g_steps, grids):
        return {("vq_nearest", vq_key): g_steps + grids,
                ("flash_fwd", attn_key): 2 * (g_steps + grids),
                ("flash_bwd_dq", attn_key): 2 * g_steps,
                ("flash_bwd_dkv", attn_key): 2 * g_steps}

    reset_counts(kernels)
    first = train_vqgan.main([*common, "--train_steps", "10"])
    first_counts = read_counts(kernels)
    trainer = first.pop("trainer")
    cfg = trainer.config
    fresh = VQGANTrainer(cfg, device="cpu")  # the seeded initial weights
    d_init = {k: v.clone() for k, v in fresh.disc.state_dict().items()}
    del fresh
    d_first = {k: v.cpu() for k, v in trainer.disc.state_dict().items()}
    del trainer
    reset_counts(kernels)
    second = train_vqgan.main([*common, "--train_steps", "30",
                               "--resume", "-1"])
    second_counts = read_counts(kernels)
    trainer = second.pop("trainer")

    losses = first["losses"] + second["losses"]
    rates = {"G only": first["images_per_s"], "G + D": second["images_per_s"]}
    print(f"train_vqgan: {len(first['losses'])} G-only steps + "
          f"{len(second['losses'])} G+D steps (resumed); images/s after a "
          f"warm-up of 5: {rates}; losses {losses}; launches "
          f"{first_counts} then {second_counts}")
    if len(losses) != 30 or not all(np.isfinite(losses)):
        fail(f"expected 30 finite losses, got {losses}")
    if first_counts != expected(10, 1) or second_counts != expected(20, 2):
        fail(f"expected 1 VQ and 2 of each flash launch per G step and 1 VQ "
             f"+ 2 forward launches per grid: {first_counts}, "
             f"{second_counts}")
    if any(not torch.equal(d_first[k], v) for k, v in d_init.items()):
        fail("the discriminator moved before disc_start")
    d_final = {k: v.cpu() for k, v in trainer.disc.state_dict().items()}
    moved = [k for k, v in d_init.items() if not torch.equal(d_final[k], v)]
    if len(moved) != len(d_init):
        fail(f"only {moved} of the discriminator moved after disc_start")
    ckpt = CheckpointManager(results, prefix="vqgan")
    saved = ckpt.restore()
    if (ckpt.all_milestones() != [1, 2] or ckpt.latest_milestone() != 2
            or saved["step"] != 30 or ckpt.restore(1)["step"] != 20
            or any(not torch.equal(saved["disc"][k], v)
                   for k, v in d_final.items())):
        fail(f"checkpoint {ckpt.all_milestones()} does not load back")
    for m in (1, 2):
        if not (results / f"reconstruction-{m}.png").exists():
            fail(f"reconstruction-{m}.png was not written")
    print(f"checkpoint {ckpt.path(2).name} ({ckpt.path(2).stat().st_size} "
          f"bytes) loads back at step {saved['step']}; discriminator "
          f"unchanged through step 10, moved by step 30; reconstruction "
          f"grids written")
    counts = dict(first_counts)
    for key, n in second_counts.items():
        counts[key] = counts.get(key, 0) + n
    return counts, rates


def drive_kl_vae_slice(torch, kernels, seed: int, work: Path):
    """The stage-1 KL-VAE slice at full width through its entry points, on
    31 users x 8 seeded JPGs (`write_image_data`), in order:
    `create_data_split` (6 training images per user, 2 for test);
    `train_kl_vae` at its defaults (AutoencoderConfig(), 256 px, batch 8,
    fp32, lr 4.5e-6) for 20 steps, saving milestones at steps 10 and 20;
    `preprocess_latents` from the last milestone (every train and test
    image, batches of 56: four full, one of 24); `vae_reconstruction` of
    10 images; `train_latent_cfg` for 2 steps on the split and cache just
    written. Gates: every loss finite; per KL-VAE step 2 launches of each
    flash kernel at [8, 1024, 1, 512] fp32, per encode batch one forward
    launch and no backward, per report 2 forwards, 1 of each flash kernel
    per LDM step at [8, 16, 8, 64] bf16, and no other launch; the milestone
    loads into `generate.load_vae` equal to the trained weights; the cache
    holds a finite [32, 32, 4] latent for every image of the split;
    metrics.json a finite PSNR. Returns ({(kernel, shape): launches},
    KL-VAE training images/s)."""
    from vqgan_tpu_torch import (
        create_data_split,
        generate,
        preprocess_latents,
        train_kl_vae,
        train_latent_cfg,
        vae_reconstruction,
    )
    from vqgan_tpu_torch.checkpoint import CheckpointManager
    from vqgan_tpu_torch.data import LatentCache, load_split

    _, images = write_image_data(work, seed)
    split_path, results = work / "kl_split.json", work / "kl_vae"
    kl_key = (8, 1024, 1, 512, "float32")
    counts = {}

    def run(label, fn, expected):
        return run_gated(torch, kernels, label, fn, expected, counts)[0]

    split = run("create_data_split", lambda: create_data_split.main([
        "--data_path", str(images), "--output", str(split_path),
        "--images_per_user_train", "6", "--seed", str(seed)]), {})
    trained = run("train_kl_vae", lambda: train_kl_vae.main([
        "--data_path", str(images), "--split", str(split_path),
        "--results_folder", str(results), "--train_steps", "20",
        "--save_every", "10", "--seed", str(seed)]),
        {(name, kl_key): 40 for name in FLASH})
    losses, rate = trained["losses"], trained["images_per_s"]
    print(f"train_kl_vae: 20 steps at batch 8, {trained['timed_steps']} "
          f"after a warm-up of 5 in {trained['timed_seconds']:.3f} s = "
          f"{rate:.4f} images/s; peak device memory "
          f"{trained['peak_memory_bytes'] / 2**30:.2f} GiB; losses {losses}; "
          f"rec {trained['rec_losses']}; kl {trained['kl_losses']}")
    if len(losses) != 20 or not all(np.isfinite(losses)):
        fail(f"expected 20 finite KL-VAE losses, got {losses}")
    ckpt = CheckpointManager(results, prefix="kl_vae")
    if ckpt.all_milestones() != [1, 2] or ckpt.latest_milestone() != 2:
        fail(f"KL-VAE milestones {ckpt.all_milestones()}, expected [1, 2]")
    loaded = generate.load_vae(ckpt.path(2), device="cuda").state_dict()
    final = trained.pop("vae").state_dict()
    if any(not torch.equal(loaded[k], v) for k, v in final.items()):
        fail("the last KL-VAE milestone does not load back into load_vae")
    print(f"checkpoint {ckpt.path(2).name} ({ckpt.path(2).stat().st_size} "
          f"bytes) loads into generate.load_vae")
    del trained, loaded, final
    torch.cuda.empty_cache()

    latent_split, cache_dir = work / "latent_split.json", work / "latents"
    n_images = sum(len(u["train_images"]) + len(u["test_images"])
                   for u in split["users"].values())
    full, rest = divmod(n_images, 56)
    encoded = run("preprocess_latents", lambda: preprocess_latents.main([
        "--vae_path", str(ckpt.path(2)), "--data_path", str(images),
        "--output_split", str(latent_split), "--cache_folder",
        str(cache_dir), "--images_per_user_train", "6", "--seed",
        str(seed)]),
        {("flash_fwd", (56, 1024, 1, 512, "float32")): full,
         **({("flash_fwd", (rest, 1024, 1, 512, "float32")): 1}
            if rest else {})})
    cache = LatentCache(cache_dir)
    latents = [cache.load(int(user.split("_")[1]) - 1, name)
               for user, info in load_split(latent_split)["users"].items()
               for name in info["train_images"] + info["test_images"]]
    if load_split(latent_split) != split or encoded["encoded"] != n_images \
            or len(latents) != n_images or any(
                z.shape != (32, 32, 4) or not np.isfinite(z).all()
                for z in latents):
        fail("preprocess_latents did not write the split and a finite "
             "[32, 32, 4] latent for every image")
    print(f"preprocess_latents: {n_images} latents in "
          f"{encoded['seconds']:.3f} s, |z| up to "
          f"{max(float(np.abs(z).max()) for z in latents):.3f}")

    report = run("vae_reconstruction", lambda: vae_reconstruction.main([
        "--vae_path", str(ckpt.path(2)), "--data_path", str(images),
        "--output_dir", str(OUT / "vae_reconstruction"), "--seed",
        str(seed)]),
        {("flash_fwd", (10, 1024, 1, 512, "float32")): 2})
    saved = json.loads((OUT / "vae_reconstruction" / "metrics.json"
                        ).read_text())
    if not np.isfinite(saved["mean_psnr"]) or saved != report:
        fail(f"metrics.json holds no finite PSNR: {saved}")
    print(f"vae_reconstruction: mean PSNR {saved['mean_psnr']:.4f} dB, "
          f"mean SSIM {saved['mean_ssim']:.4f} ({saved['verdict']})")

    ldm = run("train_latent_cfg", lambda: train_latent_cfg.main([
        "--split", str(latent_split), "--latents_cache_folder",
        str(cache_dir), "--data_path", str(images), "--results_folder",
        str(work / "ldm"), "--train_num_steps", "2", "--seed", str(seed)]),
        {(name, (8, 16, 8, 64, "bfloat16")): 2 for name in FLASH})
    del ldm["trainer"]
    if len(ldm["losses"]) != 2 or not all(np.isfinite(ldm["losses"])):
        fail(f"LDM training on the new cache: losses {ldm['losses']}")
    print(f"train_latent_cfg on the new cache: losses {ldm['losses']}")
    return counts, rate


def check_small_gmm_classifier_fid(torch, kernels, seed: int):
    """Phase 4e, the GMM split, the classifier and FID on small inputs,
    card against CPU (TF32 off), the kind of 4c and 4d:
    - `gmm_fit` with the same `init_idx` on the same projected features:
      one user's (60 images in 4096 latent features, 4 clusters,
      standardized, PCA to 95% of the variance: ~15 points per component
      in more dims, so both sides fall back to diagonal covariances) and a
      well-conditioned set (2 clusters of 40 points in 3 dims, full
      covariances; no restart ends with a component of a few points,
      whose singular covariance would leave the outcome to rounding).
      Labels equal up to the order of the components (restarts that
      reach one solution in another order tie up to rounding), covariance
      type equal, means within 1e-4 of the largest |mean|, the mean
      log-likelihood within 1e-4 relative.
    - Three `ClassifierExperiment` train steps of ResNet18 at 64 px, batch
      8, from the same weights on the same batches, at lr 1e-5: losses
      rtol 1e-4, the first step's gradients within 1e-3 of the largest,
      the parameters after the steps within 2% of the CPU's move in norm
      and off by over lr / 2 in at most 0.1% of the elements, the running
      statistics within 1e-4 of the largest.
      (Adam's sign-like first steps move all 11M parameters by about lr
      and amplify fp32 rounding step by step, faster the larger lr; the
      CPU parity against the JAX package, tests/test_torch_port_
      classifier.py, runs at lr 1e-5 for that reason.)
    - Inception features of 2 images, weights from the seed: within 1e-4
      of the largest |feature|.
    No flash or VQ kernel runs in any of them."""
    from vqgan_tpu_torch.data import BatchLoader
    from vqgan_tpu_torch.data.gmm import (
        draw_init_idx,
        gmm_fit,
        gmm_predict,
        pca_fit,
        standardize,
    )
    from vqgan_tpu_torch.eval.classifier import ClassifierExperiment
    from vqgan_tpu_torch.eval.fid import make_inception_feature_fn

    reset_counts(kernels)
    rng = np.random.default_rng(seed + 8)
    centers = rng.standard_normal((4, 4096)).astype(np.float32)
    latents = np.concatenate([c + 0.5 * rng.standard_normal((15, 4096))
                              for c in centers]).astype(np.float32)
    x = torch.from_numpy(latents)
    xs, _, _ = standardize(x)
    comps, k_pca, _ = pca_fit(xs)
    cases = {"one user, PCA to 95%": ((xs @ comps).contiguous(), 4)}
    small = rng.standard_normal((2, 3)) * 5
    cases["2 x 40 points in 3 dims"] = (torch.from_numpy(np.concatenate(
        [c + rng.standard_normal((40, 3)) for c in small]).astype(
            np.float32)), 2)
    for label, (feats, k) in cases.items():
        idx = draw_init_idx(torch.Generator().manual_seed(seed), len(feats),
                            k, 10)
        out = {}
        for dev in ("cpu", "cuda"):
            f = feats.to(dev)
            params, ll = gmm_fit(None, f, k, init_idx=idx)
            out[dev] = (params, ll, gmm_predict(params, f).cpu())
        (pc, llc, lc), (pg, llg, lg) = out["cpu"], out["cuda"]
        # restarts that reach one solution with its components in another
        # order tie in likelihood up to rounding, and either may win: the
        # labels must be equal up to that renumbering, the means in it
        pairs = set(zip(lg.tolist(), lc.tolist()))
        order = dict(pairs)
        # every component holds points on both sides, one to one
        same = len(pairs) == len(order) == len(set(order.values())) == k
        mean_err = mean_size = 0.0
        if same:
            perm = [order[j] for j in range(k)]
            means = torch.empty_like(pc.means)
            means[perm] = pg.means.cpu()
            mean_err = (means - pc.means).abs().max().item()
            mean_size = pc.means.abs().max().item()
        ll_err = abs(llg - llc) / abs(llc)
        print(f"small GMM ({label}, {feats.shape[1]} dims), card vs CPU: "
              f"{pg.covariance_type} / {pc.covariance_type} covariances, "
              f"labels equal {bool(torch.equal(lg, lc))} (up to the "
              f"components' order {same}), max|mean diff| {mean_err:.3e} "
              f"(max|mean| {mean_size:.3e}), ll {llg:.6f} / {llc:.6f} (rel "
              f"diff {ll_err:.3e})")
        if not same or pg.covariance_type != pc.covariance_type \
                or mean_err > 1e-4 * mean_size or not ll_err <= 1e-4:
            fail(f"the GMM on the card disagrees with the CPU ({label})")
    if out["cpu"][0].covariance_type != "full":
        fail("the well-conditioned GMM case fell back to diagonal "
             "covariances")

    n_steps, batch, size, lr = 3, 8, 64, 1e-5
    images = rng.standard_normal((n_steps * batch + 2, size, size, 3))
    items = [(img.astype(np.float32), i % 31) for i, img in
             enumerate(images)]
    out = {}
    for dev in ("cpu", "cuda"):
        exp = ClassifierExperiment(num_classes=31, lr=lr, epochs=1,
                                   batch_size=batch, seed=seed, device=dev)
        start = {k: v.detach().cpu().clone()
                 for k, v in exp.model.named_parameters()}
        losses, grads = [], None
        for xb, yb in BatchLoader(items, batch, shuffle=True, seed=seed,
                                  drop_last=True):
            loss, _ = exp.train_step(xb, yb)
            losses.append(loss.item())
            if grads is None:
                grads = torch.cat([p.grad.flatten().cpu()
                                   for p in exp.model.parameters()])
        state = {k: v.detach().cpu() for k, v in
                 exp.model.state_dict().items()}
        out[dev] = losses, grads, start, state
    (lc, gc, p0, sc), (lg, gg, _, sg) = out["cpu"], out["cuda"]
    loss_err = max(abs(g - c) / abs(c) for g, c in zip(lg, lc))
    grad_err = (gg - gc).abs().max().item()
    grad_size = gc.abs().max().item()
    # the parameters after the steps, by the rule of the CPU parity test
    # (tests/test_torch_port_classifier.py): the card's differ from the
    # CPU's by at most 2% of the CPU's move in norm, and by over lr / 2 in
    # at most 0.1% of the elements; the running statistics within 1e-4 of
    # each tensor's largest
    diff = move = 0.0
    miss = n = 0
    for key, start in p0.items():
        gap = sg[key] - sc[key]
        diff += gap.double().square().sum().item()
        move += (sc[key] - start).double().square().sum().item()
        miss += int((gap.abs() > lr / 2).sum())
        n += gap.numel()
    move_rel = (diff / move) ** 0.5 if move > 0 else float("inf")
    stat_err = max(
        ((sg[k] - sc[k]).abs().max() / sc[k].abs().max()).item()
        for k in sc if "running" in k)
    print(f"small classifier training, card vs CPU: losses card {lg} cpu "
          f"{lc} (max rel diff {loss_err:.3e}); max|grad diff| "
          f"{grad_err:.3e} (max|grad| {grad_size:.3e}); parameters after "
          f"{n_steps} steps: |card - cpu| / |cpu move| {move_rel:.3e}, "
          f"{miss} of {n} elements over lr / 2; running statistics "
          f"{stat_err:.3e} of the largest")
    if len(lg) != n_steps or loss_err > 1e-4 or grad_err > 1e-3 * grad_size \
            or not move_rel <= 0.02 or miss > 1e-3 * n \
            or not stat_err <= 1e-4:
        fail("classifier training on the card disagrees with the CPU")

    pics = rng.random((2, 256, 256, 3)).astype(np.float32)
    feats = {dev: make_inception_feature_fn(seed=seed, device=dev)(
        pics).cpu() for dev in ("cpu", "cuda")}
    err = (feats["cuda"] - feats["cpu"]).abs().max().item()
    size = feats["cpu"].abs().max().item()
    print(f"small Inception features, card vs CPU: max|diff| {err:.3e} "
          f"(max|feature| {size:.3e})")
    if not torch.isfinite(feats["cuda"]).all() or err > 1e-4 * size:
        fail("Inception features on the card disagree with the CPU")
    if read_counts(kernels):
        fail(f"phase 4e launched a hand-written kernel: "
             f"{read_counts(kernels)}")


def write_user_images(root: Path, seed: int, n_users: int, per_user: int,
                      size: int):
    """`ID_1`..`ID_{n_users}` folders of `per_user` seeded JPGs each: a
    per-user grating (frequency and orientation fixed by the user, phase
    and colour per image) under three random blobs and a little noise,
    after cli/e2e_demo.py's `make_user_image`, so users differ and images
    of a user vary. Users are written on 8 threads, each from its own
    generator (seed, user)."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    axis = np.arange(size, dtype=np.float32) / size
    yy, xx = np.meshgrid(axis, axis, indexing="ij")

    def write(user):
        rng = np.random.default_rng([seed, user])
        folder = root / f"ID_{user}"
        folder.mkdir(parents=True)
        f, theta = 3.0 + user % 8, (user * 0.37) % (np.pi / 2)
        carrier = 2 * np.pi * f * (np.cos(theta) * xx + np.sin(theta) * yy)
        for i in range(per_user):
            grating = 0.5 + 0.5 * np.sin(carrier + rng.uniform(0, 2 * np.pi))
            img = grating[..., None] * rng.uniform(0.2, 0.5, 3).astype(
                np.float32)
            for bx, by, s in rng.uniform((0, 0, 0.04), (1, 1, 0.16), (3, 3)):
                # a Gaussian blob, the outer product of its two profiles
                blob = np.outer(np.exp(-(axis - by) ** 2 / (2 * s * s)),
                                np.exp(-(axis - bx) ** 2 / (2 * s * s)))
                img += blob[..., None] * (0.6 * rng.random(3, np.float32))
            img += 0.05 * rng.random((size, size, 3), np.float32)
            img *= 255 / img.max()
            Image.fromarray(img.astype(np.uint8)).save(
                folder / f"frame_{i:03d}.jpg", quality=90)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(1, n_users + 1)))
    return root


def run_gated(torch, kernels, label, fn, expected, counts):
    """fn() with the launch counts reset just before and read just after;
    fails unless they equal `expected`; adds them to `counts`. Returns
    (fn's result, host seconds of the call, the device synchronised at
    both ends)."""
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = read_counts(kernels)
    print(f"{label}: whole call {secs:.3f} s; launches {got}")
    if got != expected:
        fail(f"{label}: expected launches {expected}, got {got}")
    for key, n in got.items():
        counts[key] = counts.get(key, 0) + n
    return result, secs


def drive_gmm_classifier_slice(torch, kernels, seed: int, work: Path,
                               n_users: int = 31, per_user: int = 60,
                               size: int = 256):
    """Phase 5e, the GMM split, the cluster validation, the classifier and
    FID at full width through their entry points, on `n_users` x
    `per_user` seeded JPGs (`write_user_images`; the reference has ~150
    per user), with a random `AutoencoderConfig()` KL-VAE from the seed
    saved as a port checkpoint:
    - `preprocess_latents_with_gmm` at its defaults (30 gen-train, 20
      class-train per user; batches of 16, the last zero-padded): one
      flash forward per encode batch at [16, 1024, 1, 512] fp32 and no
      other launch; the split passes `verify_split`; each cluster's gen
      and class counts are `largest_remainder_quotas` of its members; the
      cache holds exactly the 930 gen-train latents, finite [32, 32, 4];
    - `validate_cluster_number --num_users 2 --k_min 2 --k_max 4`: its
      JSON report, 4 forwards per user;
    - `generate --random_init --user_ids 1 2 3 4 --num_images 16` into
      `ID_x` folders: 151 forwards per user (150 U-Net steps at [16, 16,
      8, 64] bf16, 1 decode at [16, 1024, 1, 512] fp32, phase 3's
      unet_mid and vae_mid rows);
    - `classifier_experiment` on the real class-train images and that
      synthetic folder (ResNet18 at 256 px, batch 64, Adam 1e-4, ImageNet
      normalisation), one seed, 2 epochs of 15: finite losses, 310 test
      samples, the results JSON; no hand-written kernel; then, untimed by
      the CLI, the loader alone over the real class-train images and 5
      train steps on one batch resident on the card;
    - FID with the port's Inception (random init from the seed: not
      calibrated) of the 310 test images against the 16 generated ones
      (finite, >= 0), and of the test images against themselves, which
      is 0 but for the square root's rounding: the covariance has rank
      309 of 2048, so ~1700 eigenvalues of its square are float64
      rounding noise of order eps x lambda_max^2, each of whose roots
      can leave sqrt(eps) x lambda_max in the trace. Bound: 2 x 2048 x
      sqrt(eps) x lambda_max.
    Returns ({(kernel, shape): launches}, {metric: value})."""
    from vqgan_tpu_torch import (
        classifier_experiment,
        generate,
        preprocess_latents_with_gmm,
        validate_cluster_number,
    )
    from vqgan_tpu_torch.data import (
        BatchLoader,
        ImageFolderDataset,
        LatentCache,
        SyntheticDataset,
        largest_remainder_quotas,
        load_split,
        verify_split,
    )
    from vqgan_tpu_torch.eval.fid import (
        FIDEvaluation,
        frechet_distance,
        make_inception_feature_fn,
    )
    from vqgan_tpu_torch.models import KLVAE, AutoencoderConfig

    t_phase = time.perf_counter()
    images = write_user_images(work / "images", seed, n_users, per_user,
                               size)
    torch.manual_seed(seed)
    vae_path = work / "kl_vae.pt"
    torch.save(KLVAE(AutoencoderConfig(resolution=size)).state_dict(),
               vae_path)
    print(f"phase 5e set-up ({n_users} x {per_user} JPGs, KL-VAE "
          f"checkpoint): {time.perf_counter() - t_phase:.3f} s")
    counts, metrics = {}, {}
    latent = size // 8
    batches = -(-per_user // 16)
    enc_key = ("flash_fwd", (16, latent * latent, 1, 512, "float32"))

    split_path, cache_dir = work / "gmm_split.json", work / "latents"
    result, secs = run_gated(
        torch, kernels, "preprocess_latents_with_gmm",
        lambda: preprocess_latents_with_gmm.main([
            "--vae_path", str(vae_path), "--data_path", str(images),
            "--output_split", str(split_path), "--cache_folder",
            str(cache_dir), "--num_users", str(n_users), "--image_size",
            str(size), "--seed", str(seed)]),
        {enc_key: n_users * batches}, counts)
    split = load_split(split_path)
    problems = verify_split(split)
    if problems or split != result["split"] or len(split["users"]) != \
            n_users:
        fail(f"the GMM split is not sound: {problems}")
    for user, info in split["users"].items():
        labels = np.asarray(info["cluster_labels"])
        names = [f"frame_{i:03d}.jpg" for i in range(per_user)]
        uniq = np.unique(labels)
        members = [set(np.flatnonzero(labels == c)) for c in uniq]
        gen = {names.index(n) for n in info["gen_train_images"]}
        cls = {names.index(n) for n in info["class_train_images"]}
        gen_q = largest_remainder_quotas([len(m) for m in members], 30)
        cls_q = largest_remainder_quotas(
            [len(m - gen) for m in members], 20)
        if [len(m & gen) for m in members] != gen_q.tolist() or \
                [len(m & cls) for m in members] != cls_q.tolist():
            fail(f"{user}: gen / class counts per cluster are not the "
                 f"largest-remainder quotas of {[len(m) for m in members]}")
    cache = LatentCache(cache_dir)
    cached = sorted(cache_dir.glob("*.npy"))
    n_gen = sum(len(u["gen_train_images"]) for u in split["users"].values())
    latents = [cache.load(int(user.split("_")[1]) - 1, name)
               for user, info in split["users"].items()
               for name in info["gen_train_images"]]
    if len(cached) != n_gen or n_gen != 30 * n_users or any(
            z.shape != (latent, latent, 4) or not np.isfinite(z).all()
            for z in latents):
        fail(f"the latent cache holds {len(cached)} files for {n_gen} "
             f"gen-train images")
    stats = result["users"].values()
    enc = [u["encode_seconds"] for u in stats]
    gmm = [u["gmm_seconds"] for u in stats]
    n_diag = sum(u["covariance_type"] == "diag" for u in stats)
    metrics.update(gmm_encode_seconds_per_user=float(np.mean(enc)),
                   gmm_pca_gmm_seconds_per_user=float(np.mean(gmm)),
                   gmm_seconds_per_user=secs / n_users,
                   gmm_diag_fallback_users=n_diag)
    print(f"preprocess_latents_with_gmm: {n_users} users in {secs:.3f} s "
          f"({secs / n_users:.4f} s per user); encode {np.mean(enc):.4f} s "
          f"per user (max {max(enc):.4f}), PCA + GMM + predict "
          f"{np.mean(gmm):.4f} s per user (max {max(gmm):.4f}); "
          f"{n_diag} of {n_users} users fell back to diagonal covariances; "
          f"PCA dims {[u['pca_dims'] for u in stats]}; {len(cached)} "
          f"latents cached")

    out_dir = work / "cluster_validation"
    report, _ = run_gated(
        torch, kernels, "validate_cluster_number",
        lambda: validate_cluster_number.main([
            "--vae_path", str(vae_path), "--data_path", str(images),
            "--output_dir", str(out_dir), "--num_users", "2", "--k_min", "2",
            "--k_max", "4", "--image_size", str(size), "--seed",
            str(seed)]),
        {enc_key: 2 * batches}, counts)
    saved = json.loads((out_dir / "cluster_validation.json").read_text())
    if sorted(saved) != ["ID_1", "ID_2", "summary"] or not all(
            np.isfinite(v).all() for u in ("ID_1", "ID_2")
            for v in saved[u]["metrics"].values()):
        fail(f"cluster_validation.json is not complete: {sorted(saved)}")
    print(f"validate_cluster_number: majority k "
          f"{[saved[u]['majority_vote'] for u in ('ID_1', 'ID_2')]}, "
          f"summary {saved['summary']}")

    # one DDIM batch of 16 per user: the shapes of phase 3's unet_mid and
    # vae_mid rows
    synth = work / "synthetic"
    gen_users, per_gen = (1, 2, 3, 4), 16
    run_gated(
        torch, kernels, "generate (synthetic folder)",
        lambda: generate.main([
            "--random_init", "--seed", str(seed), "--user_ids",
            *map(str, gen_users), "--num_images", str(per_gen),
            "--output_dir", str(synth)]),
        {("flash_fwd", (per_gen, 16, 8, 64, "bfloat16")):
             150 * len(gen_users),
         ("flash_fwd", (per_gen, latent * latent, 1, 512, "float32")):
             len(gen_users)},
        counts)
    n_synth = len(SyntheticDataset(synth, size))
    if n_synth != per_gen * len(gen_users):
        fail(f"generate wrote {n_synth} images, expected "
             f"{per_gen * len(gen_users)}")

    out = work / "classifier" / "results.json"
    result, secs = run_gated(
        torch, kernels, "classifier_experiment",
        lambda: classifier_experiment.main([
            "--data_root", str(images), "--split", str(split_path),
            "--synthetic_folder", str(synth), "--num_classes", "31",
            "--epochs", "2", "--image_size", str(size), "--seed",
            str(seed), "--output", str(out)]),
        {}, counts)
    history = result["experiment"].history
    saved = json.loads(out.read_text())
    n_test = sum(len(u["test_images"]) for u in split["users"].values())
    losses = [x for h in history for x in h["losses"]]
    if not losses or not np.isfinite(losses).all() or len(history) != 2 \
            or saved["n_samples"] != n_test or n_test != 10 * n_users:
        fail(f"classifier: losses {losses}, {saved['n_samples']} test "
             f"samples of {n_test}")
    rate = history[1]["images"] / history[1]["seconds"]
    # what bounds the epoch: the loader alone (decode, normalise, stack on
    # its thread) over the real class-train images, and the train step on
    # one batch already on the card
    real_train = ImageFolderDataset(images, split, "class_train", size,
                                    imagenet_norm=True)
    t0 = time.perf_counter()
    n_loaded = sum(len(y) for _, y in BatchLoader(
        real_train, 64, shuffle=True, seed=seed, drop_last=True))
    load_rate = n_loaded / (time.perf_counter() - t0)
    exp = result["experiment"]
    xb, yb = (torch.from_numpy(np.stack(v)).cuda()
              for v in zip(*(real_train[i] for i in range(64))))
    exp.train_step(xb, yb)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        exp.train_step(xb, yb)
    torch.cuda.synchronize()
    step_rate = 5 * 64 / (time.perf_counter() - t0)
    metrics.update(classifier_images_per_s=rate,
                   classifier_loader_images_per_s=load_rate,
                   classifier_resident_step_images_per_s=step_rate,
                   classifier_accuracy=saved["accuracy"])
    print(f"classifier_experiment: {len(history[0]['losses'])} steps per "
          f"epoch at batch 64; epoch 2: {history[1]['images']} images in "
          f"{history[1]['seconds']:.3f} s = {rate:.4f} images/s; losses "
          f"{losses}; test accuracy {saved['accuracy']:.4f} on "
          f"{saved['n_samples']} images (random-weight data path, 2 "
          f"epochs); the loader alone {load_rate:.4f} images/s, the step "
          f"on a resident batch {step_rate:.4f} images/s")

    features = make_inception_feature_fn(seed=seed)
    test_set = ImageFolderDataset(images, split, "test", size)
    real = [np.stack([test_set[i][0] for i in range(s, min(s + 64, n_test))])
            for s in range(0, n_test, 64)]
    features(real[0])  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = FIDEvaluation(features, batch_size=64, num_fid_samples=n_synth)
    mu, cov = ev.load_or_precalc_real_stats(iter(real))
    torch.cuda.synchronize()
    inception_rate = n_test / (time.perf_counter() - t0)
    fake = SyntheticDataset(synth, size)
    fake = np.stack([fake[i][0] for i in range(n_synth)])
    t0 = time.perf_counter()
    score = ev.fid_score(lambda gen, n: fake[:n])
    fid_secs = time.perf_counter() - t0
    itself = frechet_distance(mu, cov, mu, cov)
    lam = float(np.linalg.eigvalsh(cov).max())
    bound = 2 * len(cov) * np.sqrt(np.finfo(np.float64).eps) * lam
    metrics.update(inception_images_per_s=inception_rate, fid=score,
                   fid_real_vs_itself=itself)
    print(f"FID (random-init Inception, not calibrated): test images vs "
          f"{n_synth} generated {score:.6e} ({fid_secs:.3f} s); test "
          f"images vs themselves {itself:.6e} (bound {bound:.6e} = 2 x "
          f"2048 x sqrt(eps) x the largest eigenvalue {lam:.6e}; trace "
          f"{np.trace(cov):.6e}); Inception features of {n_test} "
          f"test images at {inception_rate:.4f} images/s (host batches "
          f"included; statistics on the host)")
    if not np.isfinite(score) or score < 0 or not abs(itself) <= bound:
        fail(f"FID {score}, against itself {itself} (bound {bound})")
    metrics["phase_seconds"] = time.perf_counter() - t_phase
    print(f"phase 5e: {metrics['phase_seconds']:.3f} s")
    return counts, metrics


def wait_for_port(proc, timeout: float) -> int:
    """The port a `serve_http` subprocess announces on its startup line;
    fails if it exits or stays silent for `timeout` seconds."""
    import re

    deadline = time.time() + timeout
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line and proc.poll() is not None:
            fail(f"serve_http exited ({proc.returncode}) before it served")
        print(f"  serve_http: {line.rstrip()}")
        m = re.search(r"serving on http://[\d.]+:(\d+)", line)
        if m:
            return int(m.group(1))
    fail(f"serve_http announced no port within {timeout} s")


def http_json(url: str, body: dict | None = None, timeout: float = 300):
    """(status, JSON reply) of a GET, or of a POST of `body`."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def time_served_step(torch, kernels, counts, card: str, ldm_results: Path,
                     artifact: Path, unet_key) -> dict:
    """Host ms of one DDIM step at batch 16, cond_scale 1.0, in turns in
    this process: the live `DDIMStep` of the checkpoint, the artifact's
    step program as `load_program` gives it, and the same program with the
    no-op nodes that `torch.export` keeps. One flash forward per step, and
    no other launch. Returns {variant: [ms per step of each turn]}."""
    import torch.export as export

    from vqgan_tpu_torch import generate
    from vqgan_tpu_torch.diffusion.gaussian import DDIMStep
    from vqgan_tpu_torch.serving import load_program

    config, weights = generate.load_checkpoint(ldm_results)
    diffusion, _ = generate.load_model(config, weights, "cuda")
    variants = {"live": DDIMStep(diffusion, 1.0, 0.0),
                "served": load_program(artifact / "step.pt2"),
                "served, no-op nodes kept":
                    export.load(str(artifact / "step.pt2")).module()}
    g = torch.Generator("cuda").manual_seed(0)
    img = torch.randn((16, 4, 32, 32), generator=g, device="cuda")
    noise = torch.randn((16, 4, 32, 32), generator=g, device="cuda")
    t = torch.full((16,), 999, dtype=torch.long, device="cuda")
    t_next = torch.full((16,), 992, dtype=torch.long, device="cuda")
    classes = torch.zeros((16,), dtype=torch.long, device="cuda")
    steps, turns = 20, 3
    times = {name: [] for name in variants}

    def run():
        with torch.inference_mode():
            for _ in range(turns):
                for name, step in variants.items():
                    step(img, t, t_next, classes, noise)  # warm
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(steps):
                        step(img, t, t_next, classes, noise)
                    torch.cuda.synchronize()
                    times[name].append(
                        (time.perf_counter() - t0) / steps * 1e3)

    run_gated(torch, kernels, "DDIM step timing", run,
              {("flash_fwd", unet_key): turns * len(variants) * (steps + 1)},
              counts)
    print(f"[{card}] one DDIM step at batch 16, cond_scale 1.0, host ms in "
          f"{turns} turns of {steps}: " + "; ".join(
              f"{name} {', '.join(f'{v:.3f}' for v in vals)}"
              for name, vals in times.items()))
    return times


def decode_repeatability(torch, kernels, counts, card: str, vae_pt: Path,
                         vae_key) -> dict:
    """max |difference| of two decodes of the same latents (batch 16,
    256 px, fp32) by the live KL-VAE, with cuDNN's default algorithms and
    with deterministic ones; the second must be 0, since the selftests
    compare the artifact and the live pipeline under it. One flash
    forward per decode."""
    from vqgan_tpu_torch import generate

    vae = generate.load_vae(vae_pt, device="cuda")
    z = torch.randn((16, 32, 32, 4), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    out = {}

    def run():
        with torch.inference_mode():
            for deterministic in (False, True):
                torch.backends.cudnn.deterministic = deterministic
                first, second = vae.decode_latents(z), vae.decode_latents(z)
                out[deterministic] = (first - second).abs().max().item()
        torch.backends.cudnn.deterministic = False

    run_gated(torch, kernels, "decode twice", run, {("flash_fwd", vae_key): 4},
              counts)
    print(f"[{card}] two live decodes of one batch of 16: max|d| "
          f"{out[False]:.3e} with cuDNN's default algorithms, "
          f"{out[True]:.3e} with deterministic ones")
    if out[True] != 0.0:
        fail("two deterministic decodes differ: the selftests' premise")
    return {"default": out[False], "deterministic": out[True]}


def drive_serving(torch, kernels, seed: int, work: Path, card: str,
                  ldm_results: Path, vae_pt: Path, vqgan_ckpt: Path,
                  kl_ckpt: Path, images: Path, generate_rates: dict):
    """Phase 5f, the serving path at full width through its entry points:
    - `export_serving --selftest` of phase 5b's LDM checkpoint with its
      seeded KL-VAE at batch 16, at cond_scale 1.0 and at 3.0 / rescaled_phi
      0.7: the artifact against the live pipeline within rtol 1e-4, atol
      1e-5; 151 flash forwards per generated batch (the artifact's and the
      live one): 150 at [16 or 32, 16, 8, 64] bf16 and 1 at [16, 1024, 1,
      512] fp32, and no other launch;
    - one DDIM step timed live and served, in turns (`time_served_step`);
    - two live decodes of one batch, with cuDNN's default algorithms and
      with deterministic ones, which must agree bit for bit;
    - `serve_generate` of 2 users x 16 images from the cond_scale 1.0
      artifact: the JPG layout, finite images, 151 forwards per batch;
    - `serve_http --port 0` in a subprocess: /healthz warm, one POST of 2
      images (two decodable 256 x 256 JPEGs), user_id 0 answered 400;
    - `export_serving --mode vq_codec --selftest` of phase 5c's last VQ-GAN
      milestone at batch 8, 256 px: indices equal to the live codec's, the
      reconstruction within rtol 1e-4, atol 1e-5; per encode 1 VQ launch
      at [8192,256]x[128,256] and 1 flash forward at [8, 1024, 1, 512]
      bf16, per decode 1 forward; then encode and decode timed;
    - `diagnose_latent_range` of phase 5d's KL-VAE milestone (batches of
      16: [16, 1024, 1, 512] fp32) and of the VQ-GAN (batches of 8) over
      100 of 5d's images: finite statistics.
    Returns ({(kernel, shape): launches}, {metric: value})."""
    import base64
    import io

    from PIL import Image

    from vqgan_tpu_torch import (
        diagnose_latent_range,
        export_serving,
        serve_generate,
    )
    from vqgan_tpu_torch.serving import load_vq_codec

    t_phase = time.perf_counter()
    counts, metrics = {}, {}
    unet_key = {1.0: (16, 16, 8, 64, "bfloat16"),
                3.0: (32, 16, 8, 64, "bfloat16")}
    vae_key = (16, 1024, 1, 512, "float32")
    vq_key, codec_key = (8192, 128, 256, "fp32"), (8, 1024, 1, 512,
                                                   "bfloat16")

    def gated(label, fn, expected):
        return run_gated(torch, kernels, label, fn, expected, counts)

    def per_batch(cond_scale, n_batches):
        return {("flash_fwd", unet_key[cond_scale]): 150 * n_batches,
                ("flash_fwd", vae_key): n_batches}

    artifacts = {}
    for cond_scale, phi in ((1.0, 0.0), (3.0, 0.7)):
        out = artifacts[cond_scale] = work / f"cfg_sampler_{cond_scale}"
        # the selftest generates one batch from the artifact and one from
        # the live pipeline
        result, secs = gated(
            f"export_serving cond_scale {cond_scale} --selftest",
            lambda: export_serving.main([
                "--checkpoint", str(ldm_results), "--vae_path", str(vae_pt),
                "--out", str(out), "--batch_size", "16", "--cond_scale",
                str(cond_scale), "--rescaled_phi", str(phi), "--selftest"]),
            per_batch(cond_scale, 2))
        programs = result["meta"]["programs"]
        err = result["selftest"]["max_abs_diff"]
        metrics[f"export cond_scale {cond_scale}"] = {
            "programs": programs, "selftest_max_abs_diff": err,
            "whole_call_s": secs}
        print(f"[{card}] export_serving cond_scale {cond_scale}: "
              + ", ".join(f"{k}.pt2 exported and saved in "
                          f"{v['seconds']:.3f} s, {v['bytes']} bytes"
                          for k, v in programs.items())
              + f"; selftest max|artifact - live| {err:.3e}")

    metrics["step_ms"] = time_served_step(torch, kernels, counts, card,
                                          ldm_results, artifacts[1.0],
                                          unet_key[1.0])
    metrics["decode_repeat"] = decode_repeatability(
        torch, kernels, counts, card, vae_pt, vae_key)

    result, secs = gated(
        "serve_generate 2 users x 16",
        lambda: serve_generate.main([
            "--artifact", str(artifacts[1.0]), "--output_dir",
            str(OUT / "served"), "--user_ids", "1", "2", "--num_images",
            "16", "--seed", str(seed)]),
        per_batch(1.0, 2))
    check_images(result["images"], 32)
    rate = 32 / sum(result["batch_seconds"])
    metrics["serve_generate_samples_per_s"] = rate
    print(f"[{card}] serve_generate: {rate:.4f} samples/s at batch 16, "
          f"cond_scale 1.0 (phase 5's generate: "
          f"{generate_rates['cond_scale 1.0']:.4f}); whole call "
          f"{secs:.3f} s")

    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "vqgan_tpu_torch.serve_http",
         "--artifact", str(artifacts[1.0]), "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT)
    try:
        port = wait_for_port(proc, 300)
        base = f"http://127.0.0.1:{port}"
        status, health = http_json(f"{base}/healthz")
        if status != 200 or health.get("warm") is not True:
            fail(f"/healthz: {status} {health}")
        latencies = []
        for i in range(3):
            t0 = time.perf_counter()
            status, reply = http_json(f"{base}/generate", {
                "user_id": 2, "num_images": 2, "seed": seed + i})
            latencies.append(time.perf_counter() - t0)
            if status != 200 or len(reply.get("images", [])) != 2:
                fail(f"/generate: {status} {str(reply)[:200]}")
        for b64 in reply["images"]:
            with Image.open(io.BytesIO(base64.b64decode(b64))) as img:
                if img.size != (256, 256) or img.mode != "RGB":
                    fail(f"/generate returned a {img.size} {img.mode} image")
        status, bad = http_json(f"{base}/generate", {"user_id": 0})
        if status != 400:
            fail(f"/generate with user_id 0 answered {status}, not 400")
        metrics["http_latency_s"] = latencies
        print(f"[{card}] serve_http: /healthz warm; 3 requests of 2 images "
              f"(a batch of 16 each) in {latencies} s (the daemon's own: "
              f"{reply['latency_s']:.4f} s for the last); user_id 0 -> 400")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()

    codec = work / "vq_codec"
    result, secs = gated(
        "export_serving vq_codec --selftest",
        lambda: export_serving.main([
            "--mode", "vq_codec", "--vqgan_path", str(vqgan_ckpt), "--out",
            str(codec), "--batch_size", "8", "--image_size", "256",
            "--selftest"]),
        # the artifact's encode and decode, then the live codec's
        {("vq_nearest", vq_key): 2, ("flash_fwd", codec_key): 4})
    programs = result["meta"]["programs"]
    print(f"[{card}] export_serving vq_codec: "
          + ", ".join(f"{k}.pt2 exported and saved in {v['seconds']:.3f} s, "
                      f"{v['bytes']} bytes" for k, v in programs.items())
          + f"; selftest: indices equal, recon max|d| "
            f"{result['selftest']['recon_max_abs_diff']:.3e}, "
            f"{result['selftest']['codes_used']} codes used")
    metrics["codec_export"] = programs
    enc, dec = load_vq_codec(codec)
    x = torch.rand((8, 256, 256, 3), device="cuda",
                   generator=torch.Generator("cuda").manual_seed(seed))
    idx = enc(x)
    dec(idx)  # warm
    reps = 5
    _, enc_s = gated("codec encode x5", lambda: [enc(x) for _ in range(reps)],
                     {("vq_nearest", vq_key): reps,
                      ("flash_fwd", codec_key): reps})
    _, dec_s = gated("codec decode x5",
                     lambda: [dec(idx) for _ in range(reps)],
                     {("flash_fwd", codec_key): reps})
    metrics["codec_encode_ms"] = enc_s / reps * 1e3
    metrics["codec_decode_ms"] = dec_s / reps * 1e3
    print(f"[{card}] VQ codec at batch 8, 256 px: encode "
          f"{metrics['codec_encode_ms']:.3f} ms, decode "
          f"{metrics['codec_decode_ms']:.3f} ms per batch (host, the card "
          f"synchronised at both ends of 5 batches)")

    for label, flag, ckpt, batch, expected in (
            ("KL-VAE", "--vae_path", kl_ckpt, 16,
             {("flash_fwd", vae_key): 7}),
            ("VQ-GAN", "--vqgan_path", vqgan_ckpt, 8,
             {("flash_fwd", codec_key): 13, ("vq_nearest", vq_key): 13})):
        audit, secs = gated(
            f"diagnose_latent_range {label}",
            lambda: diagnose_latent_range.main([
                flag, str(ckpt), "--data_path", str(images), "--num_images",
                "100", "--batch_size", str(batch)]), expected)
        stats = audit["latents"]
        if audit["images"] != 100 or not all(
                np.isfinite(v) for v in stats.values()):
            fail(f"diagnose_latent_range {label}: {audit}")
        metrics[f"diagnose {label}"] = stats
    metrics["phase_seconds"] = time.perf_counter() - t_phase
    print(f"phase 5f: {metrics['phase_seconds']:.3f} s")
    return counts, metrics


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels and the small "
                         "chains; skip the full-width drives")
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
    for k in KERNELS.values():  # kernels of one source share its build log
        for line in k.build_log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                print(f"  {k.source.name} ptxas: {line.strip()}")
    hmma = tensor_core_instructions(KERNELS)
    print("HMMA instructions in the built SASS: " + json.dumps(hmma))
    if any(not hmma[source] for source in TENSOR_CORE_SOURCES):
        fail(f"{TENSOR_CORE_SOURCES} must run on the tensor cores: {hmma}")

    rows = {**check_flash_fwd(torch, peaks, args.seed),
            **check_flash_bwd(torch, peaks, args.seed),
            **check_vq(torch, peaks, args.seed)}
    check_small_pipeline(torch, KERNELS, args.seed)
    check_small_training(torch, KERNELS, args.seed)
    check_small_vqgan(torch, KERNELS, args.seed)
    check_small_kl_vae(torch, KERNELS, args.seed)
    check_small_gmm_classifier_fid(torch, KERNELS, args.seed)

    if not args.kernels_only:
        counts, rates = drive_main_path(torch, KERNELS, args.seed)
        print("samples/s: " + json.dumps(rates))
        # one directory for phases 5b-5f: 5f serves 5b's, 5c's and 5d's
        # checkpoints
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            work = Path(work)
            for phase in ("ldm", "vqgan", "kl_vae", "gmm", "serving"):
                (work / phase).mkdir()
            train_counts, rate = drive_training(torch, KERNELS, args.seed,
                                                work / "ldm")
            print(f"latents/s: {rate}")
            vq_counts, vq_rates = drive_vqgan_training(
                torch, KERNELS, args.seed, work / "vqgan")
            print("images/s: " + json.dumps(vq_rates))
            kl_counts, kl_rate = drive_kl_vae_slice(torch, KERNELS,
                                                    args.seed, work / "kl_vae")
            print(f"KL-VAE training images/s: {kl_rate}")
            gmm_counts, gmm_metrics = drive_gmm_classifier_slice(
                torch, KERNELS, args.seed, work / "gmm")
            print("GMM / classifier / FID slice: " + json.dumps(gmm_metrics))
            serving_counts, serving_metrics = drive_serving(
                torch, KERNELS, args.seed, work / "serving", card,
                ldm_results=work / "ldm" / "results",
                vae_pt=work / "ldm" / "kl_vae.pt",
                vqgan_ckpt=work / "vqgan" / "vqgan" / "vqgan-2.pt",
                kl_ckpt=work / "kl_vae" / "kl_vae" / "kl_vae-2.pt",
                images=work / "kl_vae" / "images", generate_rates=rates)
            print("serving slice: " + json.dumps(serving_metrics))
        for key, n in [*train_counts.items(), *vq_counts.items(),
                       *kl_counts.items(), *gmm_counts.items(),
                       *serving_counts.items()]:
            counts[key] = counts.get(key, 0) + n
        for row in rows.values():
            row["launches"] = counts.get((row["name"], row["key"]), 0)
            if not row["launches"]:
                fail(f"main-path shape {row['shape']} never reached "
                     f"{row['name']}: {counts}")

    for row in rows.values():
        del row["key"]
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
