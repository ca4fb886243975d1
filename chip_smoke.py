#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vqgan_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # build + kernel and small checks

Phases, in order; any failure exits non-zero:
1. A CUDA device must be present; print its name and power limit, and
   the version of the system's zstd library (`libzstd.so.1`, which the
   reader of the JAX package's checkpoints binds; without it the run
   stops). Probe
   whether g++ finds libjpeg's `jpeglib.h` (installing nothing): with it,
   the image trainers of 5c and 5h must read through the native C++ ring
   ("native_ring"), without it through the Python BatchLoader ("python").
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
   [4096,256] x [128,256]; serving at batch 4); phase 5k's bf16 KL-VAE
   decode (`bench_sampling`) at [16,1024,1,512]; phase 5g's: the DiT's
   multi-tile S = 256 at d = 64, forward at [8, 16 and 32,256,8,64] and
   backward at [8,256,8,64] bf16, q, k and v as views of one projection as
   the model makes them, and the Diffusers-style trainer's U-Net, forward
   and backward at [24,16,8,32] and forward at [16,16,8,32]; phase 5h's:
   the pixel-space U-Nets' attention with 4 memory key/value tokens in
   front of the keys (Skv = Sq + 4 = 260: five K/V tiles, the last with 4
   rows), forward at the DDPM's [16, 25 and 2,256,4,32] and the Karras
   U-Net's [16,256,4,64] bf16, backward at [16,256,4,32], built as the
   models build them (q a view of one projection, k and v concatenated
   behind the memory tokens; the Karras U-Net's pixel-normed); phase 5i's:
   the DDPM U-Net's RePaint batch, forward at [4,256,4,32] against 260
   keys; the UViT's ViT middle at [16,256,4,32] (q, k and v views of one
   projection; its launches counted apart from the DDPM's at that shape),
   the Unet1D's mid attention in fp32 at [32,16,4,32] and, forward only,
   [16,16,4,32], and the Karras N-D U-Nets' (4 memory tokens, pixel-
   normed): 1-D [2,16,12,64] against 20 keys and [2,8,12,64] against 12,
   3-D full [2,2048,6,64] against 2052 and [2,256,12,64] against 260, 3-D
   factorised into space [16,256,6,64] against 260 and [8,64,12,64]
   against 68 and time [512,8,6,64] against 12 and [128,4,12,64] against
   8, forward and backward, bf16; phase 6's, a rank's rows at world 4:
   the VQ-VAE's and the KL-VAE's mid attention at [2,1024,1,512] bf16
   and fp32, the DDPM's at [4,256,4,32] against 260 keys, forward and
   backward, and VQ at [2048,256] x [128,256], each under the rule of its
   dtype (the VQ-VAE shape's 2e-3 rule stays with batch 8: at batch 2 the
   largest dQ lies in [0.25, 0.5), where half a bf16 step is 2.4e-3 of
   it); phase 8's, the JAX fixture's fp32 U-Net (head width 8, alone
   and in the guided chain), KL-VAE and VQ-VAE (head width 16) and its
   VQ at [768,8]x[8,8], and its resumed training steps: flash forward
   and backward at [8,64,2,8] and [8,256,1,16], VQ at [2048,8]x[8,8].
   Time each
   kernel through its operator (the host time every path pays; the flash
   forward also through its ctypes wrapper alone), its plain version and
   one PyTorch library call at the main paths' shapes (and a few others),
   the kernel and the library call also as device time (in a CUDA graph),
   and compute the bound. For bf16, print the share of elements that differ
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
4f. Run three training steps of a small fp32 DiT (dim 64, depth 2, 2
   heads x 32, 8 x 8 latents) and three of phase 4b's U-Net with gradient
   checkpointing, each on the card and on the CPU from the same weights,
   with injected t, noise and cond-drop mask; hold them as 4b does; per
   step `depth` launches of each flash kernel for the DiT, and 2 forward,
   1 dQ and 1 dK/dV for the recomputed U-Net.
4g. Pixel-space diffusion on small inputs, card against CPU: three
   training steps of a tiny fp32 DDPM U-Net through the DDPM trainer's
   step, self-conditioned, with immiscible noise by the on-device auction,
   t, noise and coin injected, held as 4b is held (6 forward, 3 dQ and 3
   dK/dV launches per step; the auction's permutations equal on both
   devices); and Heun-4 with a tiny KarrasUnet from injected noise (images
   within 1e-3, 88 forward launches).
4h. The rest of the diffusion library on small inputs, card against CPU,
   each held as 4b is held: three DDPM-trainer steps each of a tiny
   learned-variance U-Net (t and noise injected; 3 forward, 3 dQ and 3
   dK/dV launches per step), a tiny UViT under simple diffusion (times and
   noise; 2 / 2 / 2) and a tiny Unet1D under 1-D diffusion (1 / 1 / 1);
   one forward and backward of a tiny KarrasUnet3D with factorised
   attention (output 1e-4, gradients 1e-3 of the largest CPU value; 12
   launches of each kernel).
4i. The captured modes (CUDA graphs; TF32 off, cudnn.deterministic
   pinned): a block of 4 `make_ldm_scan_step` steps of 4b's tiny U-Net
   from step 97 (the EMA's cadence and warm copy at step 100 inside),
   injected t, noise and mask, captured on the card against the CPU's
   eager block, held as 4b holds; 8 steps of it from one generator, eager
   on the card and as one step's graph replayed, which must equal bit for
   bit; 4c's VQ-GAN as `scan_g` over steps 0-1
   and `scan_gd` over 2-5 (disc_start 3), captured, against the CPU's
   split steps, held as 4c holds; DDIM-150 + decode at LDMConfig's full
   width, batch 16, cond_scale 1 and 3, the captured sampler (one step's
   graph replayed per step) against the eager loop (images within 1e-5 of the largest; 151 forwards per batch
   either way), timed in turns (eager, captured; the pass back cut to
   pay for phase 6's TP serving). Every launch gate counts through the
   replays.
5. Drive generation, `python -m vqgan_tpu_torch.generate`, at full width
   with seeded random weights: LDMConfig defaults (dim 96, mults 1-2-4-4,
   8 heads x 64, T=1000, DDIM-150, pred_v, cosine, bf16 U-Net) and the
   default fp32 KL-VAE at 256 px; two users of one batch of 16 at
   cond_scale 1.0, then one batch at cond_scale 3.0 / rescaled_phi 0.7.
   The kernel launch counts are reset just before and read just after, and
   must be 151 forward launches per batch (150 U-Net steps + 1 VAE decode)
   and no other launch. The JPG layout must be written and every image
   finite. The sampler replays one captured graph per step (generate's
   default on the card); phase 4i's eager and captured samples/s are
   printed beside.
5b. Drive training, `python -m vqgan_tpu_torch.train_latent_cfg`, at full
   width (LDMConfig defaults, batch 8, no VAE) on a split and latent cache
   of 31 users x 50 seeded random [32, 32, 4] latents: 41 steps, then a
   resume from that checkpoint to step 50. Every loss must be finite; each
   flash kernel must launch once per step at [8, 16, 8, 64] bf16; the EMA
   must equal the online weights after step 40 (the last warm copy:
   update_every 10, update_after_step 100) and differ from the final ones;
   the checkpoint and its latest pointer must load back; both calls must
   read through the native latent batch reader ("native_latents", with
   device prefetch). Then generate 16
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
   back; the grids exist; both calls read through the loader the probe
   expects (`native_input` true in the config where libjpeg is present).
   Prints images/s.
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
   full width on 16 users x 60 seeded JPGs (256 px; 16 of the reference's
   31 users, cut to keep the smoke within its time) with a random default
   KL-VAE saved as a checkpoint: `preprocess_latents_with_gmm` (one flash
   forward per padded encode batch at [16, 1024, 1, 512] fp32: 4 per
   user; a sound split; each cluster's gen and class counts its
   largest-remainder quotas; exactly the 480 gen-train latents cached),
   `validate_cluster_number` for 2 users and k 2-4 (its JSON report),
   `generate --random_init` for 4 users x 16 images (151 forwards each, at
   phase 3's unet_mid and vae_mid shapes), `classifier_experiment` on the
   real class-train images and those 64 synthetic ones for 2 epochs
   (finite losses, 160 test samples, the results JSON, no hand-written
   kernel), and FID with a random-init
   Inception: test images against the generated ones (finite, >= 0) and
   against themselves (under 2 x 2048 x sqrt(eps) x the covariance's
   largest eigenvalue, the square root's rounding). Prints
   encode and PCA + GMM seconds per user, the users that fell back to
   diagonal covariances, classifier training images/s over epoch 2 (and
   the loader's alone, and the step's on a batch resident on the card),
   Inception images/s, the FIDs and the phase's seconds. Runs in a
   process of its own (`PhaseProcess`) beside 5f and 5g, joined after 5g.
5f. Drive the serving path at full width through its entry points, from
   the checkpoints of 5b (LDM, with its seeded KL-VAE), 5c (VQ-GAN) and
   5d (KL-VAE): `export_serving --selftest` at batch 16, cond_scale 1.0
   and 3.0 / rescaled_phi 0.7 (artifact vs live pipeline within rtol
   1e-4, atol 1e-5; 151 flash forwards per generated batch, counted
   through the operators, and no other launch); one DDIM step timed in
   turns (2 of 10 steps, cut from 3 of 20 to pay for phase 6's TP
   serving) as the live module, as the served program and as the program
   with the no-op nodes `torch.export` keeps (one forward launch each),
   the live pipeline loaded once for it and the next;
   two live decodes of one batch, which must agree bit for bit with cuDNN
   held to deterministic algorithms (the selftests run so);
   one batch of 16 from the live sampler and from the served one, each
   eager and captured, in one pass of turns (images within 1e-5, 151
   forwards each; the pass back was cut to pay for phase 6's trainers);
   `serve_generate` of 1 user x 16 (the JPG layout, finite images);
   `serve_http --port 0` in a subprocess, started as the cond_scale 3.0
   export begins and answered and stopped as it ends, before anything is
   timed (/healthz warm, 2 POSTs of 2 images returning 256 x 256 JPEGs,
   cut from 3; user_id 0 answered 400); the VQ codec of 5c's milestone at batch 8
   (`--mode vq_codec --selftest`: indices equal to the live codec's; 1 VQ
   launch at [8192,256]x[128,256] and 1 forward at [8,1024,1,512] bf16 per
   encode, 1 forward per decode), its encode and decode timed; and
   `diagnose_latent_range` of 5d's KL-VAE and 5c's VQ-GAN over 100 images
   (finite statistics). Prints, each beside the card's name and power
   limit, the export seconds and bytes of each program, the step's host
   ms, serve_generate's samples/s beside phase 5's, the HTTP latency per
   request and the codec's ms per batch.
5g. Drive the rest of stage 2 at full width through its entry points, on
   5b's data, checkpoint and KL-VAE: `train_latent_cfg --model_type dit`
   (LDMConfig defaults: dim 384, depth 8, 8 heads x 64, patch 2, bf16,
   batch 8; 11 steps and a resume to 16; 8 launches of each flash kernel
   per step at [8,256,8,64]); `generate` of 16 images from that checkpoint
   at cond_scale 1.0 and 3.0 (1200 + 1 forwards per batch);
   `export_serving --selftest` of it (5f's gate); `train_stage1_diffusers
   --gradient_checkpointing` (batch 24, DDIM-100 grids, head dim 32: at
   its default of 64 it refuses, as the JAX CLI does) for 10 steps with
   milestones at 5 and 10 and a resume from "latest" to 12 (2 forward, 1
   dQ and 1 dK/dV launches per step at [24,16,8,32]; 100 forwards and a
   decode per grid; every grid written); 12 steps at batch 24 with and
   without gradient checkpointing for the peak of allocated memory and
   latents/s; and
   one ancestral batch of 16 (1000 steps) from 5b's checkpoint (1000 + 1
   forwards, finite images). Prints DiT latents/s and samples/s, the
   Diffusers trainer's latents/s, both peaks and the ancestral samples/s,
   each beside the card's name and power limit.
5h. Drive pixel-space diffusion at full width through its entry points on
   31 users x 8 seeded JPGs (128 px): `train_ddpm` at the JAX CLI's
   defaults (dim 64, mults 1-2-4-8, bf16, batch 16, pred_v, sigmoid
   betas) for 20 steps with one DDIM-250 grid of 25 (3 forward, 3 dQ and
   3 dK/dV launches per step at [16,256,4,32]; 750 forwards per grid at
   [25,256,4,32]), then the grid alone, timed; the auction at batch 16
   (ms per call, its cost within its bound of scipy's exact assignment);
   `train_ddpm --self_condition --immiscible --sampling_timesteps 50
   --calculate_fid --num_fid_samples 50 --save_best_and_latest_only` for
   10 steps with one milestone and a resume to 12 (6 / 3 / 3 launches per
   step; a finite FID >= 0, the "best" and "latest" checkpoints); and
   `bench_edm` at its defaults (KarrasUnet dim 64 at 64 px, bf16, batch
   16: 8 forward launches per network forward at [16,256,4,64], 512 per
   Heun-32 batch and 256 per DPM++(2M) batch, 4 batches of each; finite
   images). The first `train_ddpm` must read through the loader the
   probe expects. Prints DDPM images/s, the grid's samples/s, the
   auction's ms and the EDM samplers' samples/s, each beside the card's
   name and power limit.
5l. The input pipeline on the files 5c and 5b wrote (`drive_input_pipeline`,
   about 30 s): `bench_decode` over 5c's 248 JPEGs at 256 -> 256 and 256
   -> 128 px, 8 threads (PIL and, with libjpeg, native images/s);
   `bench_input_pipeline` at 128 px, batch 8, --step_ms 0 and 20
   (batches/s of each loader); the latent loader alone at batch 24,
   `native_batch_loader` against the BatchLoader; gates: device batches
   from `device_prefetch` equal their host batches bit for bit (latents
   and images), and with libjpeg the ring's batches equal the batch decode
   of their indices and repeat across two rings of one seed;
   `debug_ldm_pipeline` on 5d's KL-VAE milestone and images (1 forward at
   [1,1024,1,512] and 4 at [8,1024,1,512] fp32); one A/B in turns
   (python, native; the pass back cut for phase 6) of 5g's Diffusers-style trainer
   (batch 24, no VAE, 20 steps, 1 launch of each flash kernel per step at
   [24,16,8,32]): the BatchLoader with a synchronous copy against the
   native latent reader with prefetch, latents/s. Each number beside the
   card's name and power limit.
5i. Drive the rest of the diffusion library at full width through the
   DDPM `Trainer` and the samplers (random weights from a seed; only steps
   cut, each cut listed): train_ddpm's U-Net (dim 64, mults 1-2-4-8, bf16,
   batch 16) on 31 x 8 seeded 128 px JPGs with learned variance and with
   the weighted objective, 10 + 2 timed steps each (3 / 3 / 3 launches
   per step at [16,256,4,32]) and an ancestral batch of 16 (T cut from
   1000 to 50: 150 forwards); RePaint of 4 with the left half known (T
   100, 160 denoise ops, 480 forwards at [4,256,4,32]; the known half
   equal to the image); classifier guidance by a seeded ResNet18 over
   DDIM-50 and the ancestral sampler (150 and 300 forwards); simple
   diffusion (v) over the UViT at its defaults at 256 px, 10 + 2 steps at
   batch 16 (6 / 6 / 6 at [16,256,4,32]) and a grid of 16 (50 of 500
   steps: 300 forwards); continuous time with the learned log-SNR
   schedule and the v variant over the U-Net with learned sinusoidal time,
   10 + 2 steps each and a batch of 16 (50 of 500 steps: 150 forwards;
   these three sampler cuts halved from 100 to keep the smoke within its
   time);
   the upstream 1-D example (Unet1D dim 64, 32 channels, seq 128, pred_v)
   on a seeded Dataset1D, 10 + 2 steps at batch 32 (1 / 1 / 1 at
   [32,16,4,32] fp32) and DDIM-250 of 16 (250 forwards); the Karras 1-D (L
   = 64) and 3-D (16 x 32 x 32 x 4, full and factorised attention) U-Nets
   at their defaults in bf16, forward + backward at batch 2, one untimed
   and three timed (per pass 11 + 12 launches of each kernel in 1-D, 11 +
   11 in 3-D, 4 x 11 factorised). Every loss and sample finite. Prints
   each path's images/s, samples/s, sequences/s or ms per forward +
   backward beside the card's name and power limit.
5j. Drive the captured training modes at full width through their entry
   points (`drive_captured_training`): `train_latent_cfg --step_mode scan
   --scan_block 8` for the U-Net and the DiT (41 steps and a resume to 50
   each, on 5b's data; 1 / 8 launches of each flash kernel per step
   through the replays; the EMA gate and checkpoint checks of 5b), and
   `train_vqgan --step_mode scan` and `--step_mode fused` (16 steps
   across disc_start 8, on 5c's images; 1 VQ and 2 of each flash launch
   per G step, 1 VQ and 2 forwards per grid; D unchanged to step 8, moved
   by 16); then the eager and captured modes' latents/s and images/s in
   turns, with each graph's capture seconds and pool bytes: each run 16
   steps, 8 timed after 8 (cut from 32 to keep the smoke within its
   time), one pass of each sequence (the pass back cut for phase 6).
4j. The captured samplers (one step's CUDA graph replayed per step;
   cudnn.deterministic pinned) at 4g-4h's tiny widths, fp32: the
   ancestral sampler (CFG U-Net at cond_scale 3; a self-conditioned DDPM
   U-Net), self-conditioned DDIM, `interpolate`, learned variance, the
   weighted objective, the guided ancestral and DDIM samplers (a ResNet18's
   `autograd.grad` inside the graph), EDM Heun and DPM++(2M) (KarrasUnet),
   continuous time (learned log-SNR; v), simple diffusion (UViT), RePaint
   (both kinds of op) and the 1-D ancestral and DDIM chains: each from
   injected noise captured on the card against the CPU's eager loop
   (1e-3), and from one generator captured against the eager loop on the
   card, equal bit for bit with the generator left where the eager loop
   leaves it; every run's launches, through the replays, equal to the
   eager loop's and a whole number per forward. The auction at batch 16,
   captured blocks against eager against the CPU (one permutation), its
   default calls keeping one graph of 16 bids across calls; 4c's
   VQ-GAN with the ActNorm discriminator as the scan mode's programs,
   captured, against the CPU's split steps, held as 4c.
5k. The captured samplers at full width, each timed in turns (eager,
   then captured, after the untimed capture; cut from eager, captured,
   captured, eager after an untimed call of each, to pay for phase 6's
   trainers; the
   ancestral sampler's and `interpolate`'s untimed eager call is a 3-step
   `interpolate`, cut from a full batch to keep the smoke within its
   time; the other paths' first eager call is timed apart, its cold rate
   printed beside the warm one of the turns), every
   call's launches gated exactly, captured within 1e-5 of the largest
   eager value (`drive_sampler_graphs`): the ancestral sampler at
   LDMConfig's width (T cut from 1000 to 250 for phase 6's 2-rank run,
   batch 16, cond_scale 1) and the decode (250 + 1 forwards);
   `interpolate` from t = 125 (cut from T - 1; 125);
   `bench_edm`'s Heun-32 and DPM++(2M) (512 and 256 at [16,256,4,64]);
   the library at 5i's widths with steps cut (learned variance and the
   weighted objective at T 20, guided ancestral T 20 and DDIM-20, RePaint
   at T 20, continuous time and the UViT at 20 steps, the 1-D DDIM-50);
   and `python -m vqgan_tpu_torch.bench_sampling` at its defaults (bf16
   decode: 4 x (150 + 1) forwards), its JSON line printed. Prints each
   path's eager and captured samples/s, capture seconds and pool bytes.
   Phases 5g, 5h and 5i sample through the graphs too (the samplers'
   default on the card), their launch gates unchanged. 5h and 5i each run
   in a process of their own (`PhaseProcess`) beside 5j and 5k, started
   after 5l (whose loaders' rates run alone) and joined after 5k.
6. Scale-out (`drive_scale_out`): before the group, `train_vqgan`
   (split), `train_kl_vae` and `train_ddpm --self_condition --immiscible`
   at full width and a rank's batch of a world of 4 (2, 2 and 4), the
   references; then a real NCCL process group of world 1 in this process,
   with cuDNN's and PyTorch's deterministic algorithms: the same three on
   it, each equal bit for bit to its reference, `train_vqgan
   --step_mode fused` and `scan`, captured with the collectives in their
   graphs, each equal bit for bit to its step bodies run eagerly there,
   every run's flash and VQ launches per step as on one device (the
   per-rank rows of phase 3); `train_latent_cfg --step_mode scan` in each
   `--param_sharding` mode, captured, equal bit for bit to eager;
   `train_latent_cfg` at full width under each of the
   five `--param_sharding` modes (each equal to the replicated run);
   ring attention through the kernels, forward and backward, at
   [2,4096,8,64] bf16 over 4 blocks (held to the whole-sequence flash
   attention, the plain version and fp64) and [2,1024,2,64] fp32 over 8
   (held to `sdpa_reference`), with the kernels' rows at the block
   shapes; `dryrun_multichip` at the card's world size; and on 2 gloo
   ranks sharing the card (`start_two_ranks`, which run beside this
   process's trainers above and are joined before the ring's timed rows),
   `train_latent_cfg` at full width, `--param_sharding fsdp` against
   `replicated`, _GLOO2_STEPS eager steps each: each rank's bytes
   allocated at the last step's start (resident) and at its peak, fsdp's
   resident at most _GLOO2_RESIDENT_SHARE of replicated's, the weights
   within the norm rule of replicated's, then on the same ranks the dry
   run at n = 2 (what `dryrun_multichip(2)` runs on each rank; it fails on
   any check skipped). Tensor-parallel serving: from
   5b's checkpoint, the step and decode exported at batch 16 with every
   TP kernel split (`tp_param_specs`: the U-Net's 54 to_qkv, to_q, to_k,
   to_v and to_out kernels; the KL-VAE's attention names match no TP key,
   so the decode stays whole, as in JAX) at model 2 (cond_scale 3.0, the
   first _TP_CHAIN DDIM pairs) and at model 1 (cond_scale 1.0, DDIM-150);
   on the NCCL group of world 1 the model-1 artifact (each gather over a
   group of one, captured with the step) against 5f's data-only one,
   captured, _TP_TURNS calls each in turns (151 forwards per call, the
   images within the tests' rule); on the same 2 gloo ranks as the fsdp
   run, the model-2 artifact against 5f's cond_scale 3.0 artifact of whole
   weights (its chain cut to the same pairs), eagerly: each rank's images
   within rtol 1e-4, atol 1e-5 of the whole-weight ones and equal on both
   ranks, _TP_CHAIN + 1 forwards per call at shapes phase 3 holds (added
   to the kernels' line), its split kernels' pieces half their whole
   bytes, graph=True refused over gloo. Steps cut to pay for it:
   _SCAN_STEPS 12 -> 8, _GLOO2_STEPS 3 -> 2.
7. The FLOP accounting and the roofline tools (`drive_measurement_tools`):
   each operator's registered FLOP formula (`utils/flops.py`) equal to the
   counter's count of its plain version on the card, at one shape each;
   then, in this process, `bench_attention`, `bench_vq`,
   `profile_training` and `profile_sampling` at the JAX CLIs' defaults,
   their records under this run's work directory: each flash row
   launching each of its kernels once per iteration, each kernel row of
   `bench_vq` once per call, its indices at each K against the library's
   (exact mode) or the plain version's (bf16 mode) under the flip rule of
   phase 3, the G step and its captured chains launching the VQ kernel
   once and each flash kernel 7 times per step (at 128 px the VQ-VAE
   attends at 16 x 16 in 7 blocks), the samplers 1 forward per U-Net or
   VAE call and 8 per Karras forward; every timed record of the four
   tools but the host floor (a trivial program, no FLOPs by design)
   carrying an MFU and a bound share, and every share any record carries
   above 0 and at most 1 (a missing or zero share is a count that
   collapsed, one over 1 a count too high). Prints the phase's seconds.
8. The JAX package's Orbax checkpoints (`check_jax_fixture`): the
   committed fixture tests/fixtures/jax_orbax/ (a small LDM after two
   steps of the JAX trainer, a narrow KL-VAE, a tiny VQ-GAN;
   tests/_make_jax_orbax_fixture.py) read with no JAX by the port's
   reader (each checkpoint's read seconds and MB/s beside the card line)
   and its CLIs' loaders (`generate.load_checkpoint` + `load_model`,
   `load_weights`, `load_vqvae`), then run on the card with TF32 off:
   the U-Net on the EMA weights, a DDIM-10 chain at cond_scale 3.0 from
   the stored noise decoded by the KL-VAE, the VQ-VAE's indices (exact
   but for JAX's near-ties, `_FIXTURE_TIE`) and reconstruction, each
   within `_FIXTURE_ATOL` of the JAX outputs in expected.npz, with the
   launches of `_FIXTURE_LAUNCHES`. Then (`check_jax_resume`) the port's
   trainers resume the fixture's LDM milestone (step mode, and scan mode
   over the `CapturableOptimizer`, its second step a captured graph) and
   VQ-GAN milestone by their own `load` (the JAX optax state mapped onto
   the port's optimizers) and take the two steps that the JAX trainers
   took from them, with the same batches and draws (resume_expected.npz):
   losses and gradient norms within `_RESUME_RTOL` of JAX's, parameter
   and EMA updates by `_RESUME_MOVE` (the VQ-GAN's by its share rule),
   each kernel of `_RESUME_KEYS` launched. Prints each resume's seconds
   and the phase's.
9. Print the kernels' JSON line, then the card line, then the device line.

A `[clock]` line before each phase gives the seconds since the start: the
run's timeline against the 1200 s it may take. Phases 5e, 5h and 5i and
phase 6's two gloo ranks run beside the main process, so the host-timed
numbers of the phases they run beside are taken with a neighbour on the
card and the host; the kernels' rows (phases 3 and 6's ring) and phase
6's world-1 serving turns are timed with none.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

from vqgan_tpu_torch.utils.flops import (  # the peaks and work formulas
    backward_work,
    bound,
    flash_fwd_work,
    peaks_for,
    vq_work,
)

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# tolerance of kernel vs plain version, both fp32 math on the card: they
# differ only in summation order (fp32) or in one final bf16 rounding step
# (1e-2 covers one step under |value| 2; `outside_rounding` above it)
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


def libjpeg_headers() -> bool:
    """Whether g++ finds `jpeglib.h`, which the native JPEG decoder builds
    against (the latent batch reader needs g++ alone). Installs nothing."""
    try:
        proc = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                              input="#include <jpeglib.h>\n",
                              capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return proc.returncode == 0


def expected_image_loader(jpeg: bool) -> str:
    """The loader an image trainer must name: the C++ ring where libjpeg's
    headers are present, else the Python BatchLoader (PIL)."""
    return "native_ring" if jpeg else "python"


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


def outside_rounding(torch, got, ref, atol: float):
    """(elements of `got` off `ref` by more than `atol`, and for bf16 also
    by more than one rounding step of the plain value, a note). `_ATOL`'s
    bf16 1e-2 is one final rounding step for values under 2; at |value| in
    [2, 4) one step is 2^-6 (pixel-normed q, k, v put outputs there), so a
    bf16 element may differ by one step of its own magnitude and no more."""
    diff = (got.float() - ref.float()).abs()
    over = diff > atol
    if got.dtype != torch.bfloat16 or not bool(over.any()):
        return int(over.sum()), ""
    r = ref.float().abs()
    step = torch.exp2(torch.floor(torch.log2(r.clamp(min=2.0 ** -126))) - 7)
    outside = int((over & (diff > step)).sum())
    return outside, (
        f", {int(over.sum())} over {atol} at |plain| >= "
        f"{r[over].min().item():.3e}, {outside} of them more than one "
        f"rounding step")


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
        # bench_sampling's decode: the KL-VAE in bf16, as the JAX CLI has it
        ("vae_mid_bf16", 16, 1024, 1024, 1, 512, "bfloat16", True),
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
        # the DiT (LDMConfig defaults: 16 x 16 patches, 8 heads x 64), q, k
        # and v as views of one qkv projection: training at batch 8, DDIM
        # generation and serving at 16, CFG generation at 2 x 16
        ("dit_train", 8, 256, 256, 8, 64, "bfloat16", True),
        ("dit_gen", 16, 256, 256, 8, 64, "bfloat16", True),
        ("dit_cfg", 32, 256, 256, 8, 64, "bfloat16", True),
        # the Diffusers-style trainer's U-Net (head dim 32, the one change
        # from its refused defaults): training at batch 24, its DDIM-100
        # grids at 16
        ("unet32_mid_train_b24", 24, 16, 16, 8, 32, "bfloat16", True),
        ("unet32_mid", 16, 16, 16, 8, 32, "bfloat16", True),
        # the pixel-space U-Nets at 16 x 16, 4 memory key/value tokens in
        # front of the keys (Skv = 260), built as the models build them:
        # the DDPM's (4 heads x 32) in training at batch 16 (and its FID
        # batches of 16), its grids of 25 and the last FID batch of 2;
        # the Karras U-Net's (4 heads x 64, q, k and v pixel-normed) in
        # EDM sampling at batch 16
        ("ddpm_mid_train", 16, 256, 260, 4, 32, "bfloat16", True),
        ("ddpm_mid_grid", 25, 256, 260, 4, 32, "bfloat16", True),
        ("ddpm_mid_fid_tail", 2, 256, 260, 4, 32, "bfloat16", True),
        ("karras_mid", 16, 256, 260, 4, 64, "bfloat16", True),
        # one rank's rows at world 4 (phase 6 trains at these batches):
        # the VQ-VAE's and the KL-VAE's mid attention at batch 2 of 8, the
        # DDPM U-Net's at 4 of 16
        ("vqvae_mid_rank4", 2, 1024, 1024, 1, 512, "bfloat16", True),
        ("kl_vae_mid_rank4", 2, 1024, 1024, 1, 512, "float32", True),
        ("ddpm_mid_rank4", 4, 256, 260, 4, 32, "bfloat16", True),
        # phase 8's, the JAX package's fixture (fp32): its U-Net's mid
        # attention in one forward of 3 and in the CFG chain (6 rows), the
        # KL-VAE's mid attention, the VQ-VAE's attention at 16 x 16
        ("fixture_unet_mid", 3, 64, 64, 2, 8, "float32", True),
        ("fixture_unet_cfg", 6, 64, 64, 2, 8, "float32", True),
        ("fixture_kl_vae_mid", 3, 64, 64, 1, 16, "float32", True),
        ("fixture_vqvae_attn", 3, 256, 256, 1, 16, "float32", True),
        # phase 8's resumed training steps at the fixture's batch of 8: the
        # U-Net's mid attention, the VQ-VAE's attentions at 16 x 16
        ("fixture_unet_train", 8, 64, 64, 2, 8, "float32", True),
        ("fixture_vqvae_train", 8, 256, 256, 1, 16, "float32", True),
    ] + library_attention_cases()


def library_attention_cases():
    """Phase 5i's shapes (the rest of the diffusion library), built as the
    models build them: the DDPM U-Net's RePaint batch of 4 (Skv 260); the
    UViT's ViT middle (16 x 16 tokens, 4 heads x 32, q, k and v views of
    one projection; its launches are counted apart from the DDPM's at the
    same shape, `row_key`); the Unet1D's mid attention (seq 128 / 8 = 16
    positions, fp32, views of one projection) in training at batch 32 and
    sampling at 16; the Karras 1-D U-Net at L = 64 (attention at 16 and 8
    positions, 12 heads x 64) and the 3-D one at 16 x 32 x 32 (6 heads at
    16 x 16 px, 12 at 8 x 8), full or factorised into space (per frame)
    and time (per pixel), all with 4 memory tokens and pixel-normed."""
    return [
        ("ddpm_mid_repaint", 4, 256, 260, 4, 32, "bfloat16", True),
        ("uvit_vit", 16, 256, 256, 4, 32, "bfloat16", True),
        ("unet1d_mid_train", 32, 16, 16, 4, 32, "float32", True),
        ("unet1d_mid_gen", 16, 16, 16, 4, 32, "float32", True),
        ("karras1d_16", 2, 16, 20, 12, 64, "bfloat16", True),
        ("karras1d_8", 2, 8, 12, 12, 64, "bfloat16", True),
        ("karras3d_16", 2, 2048, 2052, 6, 64, "bfloat16", True),
        ("karras3d_8", 2, 256, 260, 12, 64, "bfloat16", True),
        ("karras3d_space_16", 16, 256, 260, 6, 64, "bfloat16", True),
        ("karras3d_time_16", 512, 8, 12, 6, 64, "bfloat16", True),
        ("karras3d_space_8", 8, 64, 68, 12, 64, "bfloat16", True),
        ("karras3d_time_8", 128, 4, 8, 12, 64, "bfloat16", True),
    ]


def row_key(label, b, s_q, h, d, dt):
    """The launch-count key of a phase-3 row: (B, Sq, H, D, dtype) as the
    wrappers count, tagged "uvit" for the UViT's rows, whose shape the
    DDPM U-Net shares (phase 5i counts the UViT's launches apart)."""
    key = (b, s_q, h, d, dt)
    return key + ("uvit",) if label.startswith("uvit") else key


def memory_qkv(torch, rng, b, s, h, d, dtype, pixel_normed: bool):
    """q [B, S, H, D] and k, v [B, 4 + S, H, D] as the pixel-space U-Nets
    make them: q a view of one [B, S, 3 * H * D] projection, k and v new
    tensors with 4 memory tokens in front (`with_memory_tokens`); the
    Karras U-Net's then pixel-normed along D."""
    from vqgan_tpu_torch.models.karras_unet import pixel_norm
    from vqgan_tpu_torch.models.layers import with_memory_tokens

    x = rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)
    q, k, v = torch.from_numpy(x).to("cuda", dtype).view(
        b, s, 3, h, d).unbind(2)
    mem = torch.from_numpy(rng.standard_normal((2, h, 4, d)).astype(
        np.float32)).to("cuda")
    k, v = with_memory_tokens(mem, k, v)
    if pixel_normed:
        q, k, v = (pixel_norm(t, dim=-1) for t in (q, k, v))
    return q, k, v


def model_qkv(torch, rng, label, b, s_q, h, d, dtype):
    """The main paths' q, k and v for `label`, or None for a case whose
    inputs are plain random [B, S, H, D] tensors."""
    if label.startswith(("dit", "uvit", "unet1d")):
        return packed_qkv(torch, rng, b, s_q, h, d, dtype)
    if label.startswith(("ddpm", "karras")):
        return memory_qkv(torch, rng, b, s_q, h, d, dtype,
                          pixel_normed=label.startswith("karras"))
    return None


def packed_qkv(torch, rng, b, s, h, d, dtype):
    """q, k and v [B, S, H, D] as the DiT makes them: views of one
    [B, S, 3 * H * D] projection, row stride 3 * H * D."""
    x = rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)
    packed = torch.from_numpy(x).to("cuda", dtype)
    return tuple(t.reshape(b, s, h, d) for t in packed.chunk(3, dim=-1))


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
        q, k, v = model_qkv(torch, rng, label, b, s_q, h, d, dtype) or (
            q, k, v)
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
        over, steps = outside_rounding(torch, out, ref_out, _ATOL[dt]["out"])
        print(f"flash_fwd {label} [{b},{s_q},{h},{d}] kv={s_kv} {dt}: "
              f"max|out-plain|={err_out:.3e} (max|plain| "
              f"{ref_out.float().abs().max().item():.3e}"
              f"{differ(out, ref_out)}{steps}) max|lse-plain|="
              f"{err_lse:.3e}")
        if not finite or over or err_lse > _ATOL[dt]["lse"]:
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
        bound_ms, bound_by = bound(
            peaks, *flash_fwd_work(b, s_q, s_kv, h, d, q.element_size()), dt)
        row = rows[("flash_fwd", label)] = {
            "name": "flash_fwd",
            "key": row_key(label, b, s_q, h, d, dt),
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
        # the DiT's training shape (q, k, v as views of one projection) and
        # the Diffusers-style trainer's U-Net at batch 24
        ("dit_train", 8, 256, 256, 8, 64, "bfloat16", True, False, True),
        ("unet32_mid_train_b24", 24, 16, 16, 8, 32, "bfloat16", True, False,
         True),
        # the DDPM U-Net's training shape, 4 memory tokens in front of the
        # keys: the last 64-row K/V tile holds 4 rows
        ("ddpm_mid_train", 16, 256, 260, 4, 32, "bfloat16", True, False,
         True),
        # one rank's rows at world 4 (phase 6)
        ("vqvae_mid_rank4", 2, 1024, 1024, 1, 512, "bfloat16", True, False,
         True),
        ("kl_vae_mid_rank4", 2, 1024, 1024, 1, 512, "float32", True, False,
         True),
        ("ddpm_mid_rank4", 4, 256, 260, 4, 32, "bfloat16", True, False,
         True),
        # phase 8's resumed training steps (the JAX fixture, fp32)
        ("fixture_unet_train", 8, 64, 64, 2, 8, "float32", True, False,
         True),
        ("fixture_vqvae_train", 8, 256, 256, 1, 16, "float32", True, False,
         True),
    ] + [  # phase 5i's training and forward + backward shapes
        (label, b, s_q, s_kv, h, d, dt, True, False, True)
        for label, b, s_q, s_kv, h, d, dt, _ in library_attention_cases()
        if label not in ("ddpm_mid_repaint", "unet1d_mid_gen")]


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
        q, k, v = model_qkv(torch, rng, label, b, s_q, h, d, dtype) or (
            q, k, v)
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
                "key": row_key(label, b, s_q, h, d, dt),
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
        # one rank's rows at world 4 (phase 6's VQ-GAN at batch 2 of 8),
        # also the end-to-end demo's VQ-GAN at 128 px in training (batch
        # 8); and its latent audit (batch 16)
        ("vqgan_rank4", 2048, 128, 256, False, True),
        ("vqgan128_audit", 4096, 128, 256, False, False),
        # phase 8's: the JAX fixture's VQ-VAE, 3 grids of 16 x 16 against
        # its 8 codes of 8 dims
        ("fixture_vq", 768, 8, 8, False, True),
        # and phase 8's resumed VQ-GAN steps: 8 grids of 16 x 16
        ("fixture_vq_train", 2048, 8, 8, False, True),
    ]


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
            if label not in ("vqgan_main", "vqgan_rank4", "bench_k8192",
                             "fixture_vq", "fixture_vq_train"):
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
    """Phase 4b: three training steps of a tiny fp32 U-Net, card against
    CPU (`card_vs_cpu_training`); one launch of each flash kernel per
    step."""
    from vqgan_tpu_torch.models import CFGUnet

    torch.manual_seed(seed)
    init = CFGUnet(dim=16, num_classes=3, cond_drop_prob=0.0,
                   dim_mults=(1, 2), channels=4, attn_dim_head=16,
                   attn_heads=2)
    card_vs_cpu_training(torch, kernels, "small training", init, seed,
                         remat=False, per_step={name: 1 for name in FLASH})


def check_small_dit_and_remat(torch, kernels, seed: int):
    """Phase 4f: three training steps, card against CPU
    (`card_vs_cpu_training`), of a small fp32 DiT (dim 64, depth 2, 2 heads
    x 32, 8 x 8 latents: 16 tokens), `depth` launches of each flash kernel
    per step; and of phase 4b's tiny U-Net with gradient checkpointing,
    whose recomputed forward launches the forward kernel a second time:
    2 forward, 1 dQ and 1 dK/dV launches per step."""
    from vqgan_tpu_torch.models import CFGUnet, DiT

    torch.manual_seed(seed + 6)
    dit = DiT(dim=64, depth=2, heads=2, dim_head=32, patch_size=2,
              image_size=8, channels=4, num_classes=3, cond_drop_prob=0.0)
    # past the adaLN-zero initialisation, so that every block carries a
    # gradient from the first step
    with torch.no_grad():
        for name, p in dit.named_parameters():
            if "ada_mod" in name or "final_" in name:
                p.normal_(0.0, 0.02)
    card_vs_cpu_training(torch, kernels, "small DiT training", dit, seed,
                         remat=False, per_step={name: 2 for name in FLASH})
    torch.manual_seed(seed)
    unet = CFGUnet(dim=16, num_classes=3, cond_drop_prob=0.0,
                   dim_mults=(1, 2), channels=4, attn_dim_head=16,
                   attn_heads=2)
    card_vs_cpu_training(torch, kernels, "small U-Net training, remat",
                         unet, seed, remat=True,
                         per_step={"flash_fwd": 2, "flash_bwd_dq": 1,
                                   "flash_bwd_dkv": 1})


def card_vs_cpu_training(torch, kernels, label, init, seed: int, *,
                         remat: bool, per_step: dict, n_steps: int = 3,
                         scan_start=None):
    """Three training steps of the small fp32 denoiser `init` on the card
    and on the CPU from the same weights, with injected t, noise and
    cond-drop mask (TF32 off), through `Rematerialized` with `remat`.
    Tolerances:
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
      lr 1e-4 in the runs so far).
    The card's launches of each flash kernel in the 3 steps must be 3 x
    `per_step`. With `scan_start`, the `n_steps` steps run as one block of
    `make_ldm_scan_step` from that step (the EMA at its defaults: every 10
    steps, warm copies to step 100), on the card as CUDA graphs, their
    launches counted through the replays."""
    import copy

    from vqgan_tpu_torch.build import Rematerialized
    from vqgan_tpu_torch.diffusion import GaussianDiffusion
    from vqgan_tpu_torch.training.ldm_step import (
        LDMTrainState,
        make_ldm_optimizer,
        make_ldm_scan_step,
        make_ldm_train_step,
    )

    b, lr = 4, 1e-4
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
            Rematerialized(model) if remat else model, image_size=8,
            channels=4, timesteps=20, objective="pred_v",
            min_snr_loss_weight=True, auto_normalize=False,
            device=torch.device(dev))

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
                                 max_grad_norm=1.0,
                                 capturable=scan_start is not None)
        state = LDMTrainState(scan_start or 0, model,
                              copy.deepcopy(model).requires_grad_(False), opt)
        if scan_start is None:
            step = make_ldm_train_step(diffusion, opt, ema_update_every=1,
                                       ema_update_after_step=1)
            reset_counts(kernels)
            losses = []
            for i in range(n_steps):
                x = inputs(i)
                log = step(state, x.pop("latents"), x.pop("classes"), **x)
                losses.append(float(log["loss"]))
        else:
            block = make_ldm_scan_step(diffusion, opt)
            xs = [inputs(i) for i in range(n_steps)]
            stacked = {k: torch.stack([torch.as_tensor(x[k]).to(dev)
                                       for x in xs]) for k in xs[0]}
            reset_counts(kernels)
            log = block(state, stacked.pop("latents"),
                        stacked.pop("classes"), **stacked)
            losses = [float(v) for v in log["loss"]]
        launches = {name: kernels[name].launches for name in FLASH}

        def flat(m):
            return torch.cat([p.detach().flatten().cpu()
                              for p in m.parameters()])
        out[dev] = (grads, losses, flat(model), flat(state.ema_model),
                    launches)
    hold_card_to_cpu(torch, label, init, out, n_steps, lr, per_step)


def hold_card_to_cpu(torch, label, init, out, n_steps: int, lr: float,
                     per_step: dict):
    """The gates of `card_vs_cpu_training` on out = {"cpu": ..., "cuda":
    ...}, each (first-step gradients, losses, parameters, EMA parameters,
    flash launches of the card's steps), from the weights of `init`."""
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
            fail(f"{label}: the CPU's {name}s did not move in {n_steps} "
                 f"steps")
        moves[name] = (diff.abs().max().item(), diff.norm().item() / cpu_move,
                       int((diff.abs() > lr / 2).sum()))
    print(f"{label}, card vs CPU: max|grad diff|={grad_err:.3e} "
          f"(max|grad| {grad_size:.3e}), losses card {l_gpu} cpu {l_cpu} "
          f"(max rel diff {loss_err:.3e}); "
          + ", ".join(f"{n}s: max|diff|={m:.3e}, |move diff|/|cpu move|="
                      f"{r:.3e}, {k} over lr/2"
                      for n, (m, r, k) in moves.items())
          + f"; launches on the card {launches}")
    if grad_err > 1e-3 * grad_size or loss_err > 1e-3 \
            or any(r > 0.05 or k > 10 for _, r, k in moves.values()) \
            or not all(np.isfinite(l_gpu)):
        fail(f"{label} on the card disagrees with the CPU")
    expected = {name: n_steps * n for name, n in per_step.items()}
    if launches != expected:
        fail(f"{label}: expected {expected} flash launches in {n_steps} "
             f"steps, got {launches}")


def _flat(torch, module, params_only=True):
    """The module's parameters (or its BatchNorm running statistics) as
    one CPU vector."""
    return torch.cat([v.detach().flatten().cpu().float()
                      for k, v in module.state_dict().items()
                      if params_only != ("running" in k)])


def check_small_vqgan(torch, kernels, seed: int, *, scan: bool = False,
                      disc_norm: str = "batch"):
    """Three VQ-GAN training steps of a tiny fp32 config on the card and on
    the CPU from the same weights and images (TF32 off), disc_start 1: step
    0 is G only, steps 1-2 G + D. With `scan` (phase 4i), six steps with
    disc_start 3, the card's as `make_vqgan_scan_steps`' CUDA graphs:
    `scan_g` over steps 0-1, then `scan_gd` over steps 2-5, which straddle
    disc_start (step 2's D update masked); the CPU's split steps as
    before. `disc_norm` the discriminator's norm (phase 4j: "act").
    Tolerances:
    - indices of the initial encoder's z, exact but for near-ties within
      1e-4 of |z|^2 + |e|^2 by the CPU's scores: the encoders' outputs
      differ by cuDNN's and the CPU's summation orders (~1e-6 relative);
    - usage counts of every step, exact where the indices agree;
    - losses, rtol 1e-4;
    - the first G step's gradients, codebook included, 1e-3 of the largest;
    - BatchNorm running statistics, 1e-4 (convolutions summed in other
      orders before each norm); ActNorm's buffers, which no step changes;
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
        make_vqgan_scan_steps,
        make_vqgan_split_steps,
    )

    n_steps, disc_start = (6, 3) if scan else (3, 1)
    b, lr = 4, 4.5e-5
    label = "small VQ-GAN scan steps" if scan else "small VQ-GAN training"
    label += "" if disc_norm == "batch" else f", {disc_norm} norm"
    torch.manual_seed(seed)
    vq_init = VQVAE(ch=16, ch_mult=(1, 2), num_res_blocks=1, resolution=32,
                    z_channels=16, num_embeddings=8, embedding_dim=16)
    d_init = PatchGANDiscriminator(ndf=8, n_layers=2, norm=disc_norm)
    lpips_init = LPIPS()
    images = np.random.default_rng(seed + 4).random(
        (n_steps, b, 32, 32, 3)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        vqvae = copy.deepcopy(vq_init).to(dev)
        disc = copy.deepcopy(d_init).to(dev)
        lpips = copy.deepcopy(lpips_init).to(dev).eval().requires_grad_(False)
        captured = scan and dev == "cuda"
        opt_g, opt_d = make_gan_optimizers(vqvae.parameters(),
                                           disc.parameters(),
                                           learning_rate=lr,
                                           disc_learning_rate=lr,
                                           capturable=captured)
        grads = []
        g_update = opt_g.step

        def record(g, norm=None, g_update=g_update, grads=grads):
            if not grads:  # the first G step's gradients, before clipping
                grads.append(torch.cat([t.detach().flatten().cpu()
                                        for t in g]))
            return g_update(g, norm)

        opt_g.step = record
        step_kw = dict(disc_start=disc_start,
                       perceptual_fn=perceptual_loss_fn(lpips))
        g_step, d_step = make_vqgan_split_steps(**step_kw)
        state = VQGANTrainState(0, vqvae, disc, opt_g, opt_d)
        with torch.no_grad():
            x0 = torch.from_numpy(images[0]).to(dev).permute(0, 3, 1, 2)
            z = vqvae.encode_pre_quant(x0).permute(0, 2, 3, 1).reshape(-1, 16)
            idx = vqvae.encode_to_indices(x0).flatten()
        reset_counts(kernels)
        logs = []
        if captured:
            scan_gd, scan_g = make_vqgan_scan_steps(**step_kw)
            x = torch.from_numpy(images).to(dev)
            for fn, part in ((scan_g, x[:2]), (scan_gd, x[2:])):
                block = fn(state, part)
                logs += [{k: v[i].cpu() for k, v in block.items()}
                         for i in range(len(part))]
        for i in range(len(logs), n_steps):
            x = torch.from_numpy(images[i]).to(dev)
            recon, log = g_step(state, x)
            if i >= disc_start:
                log.update(d_step(state, x, recon))
            logs.append({k: v.cpu() for k, v in log.items()})
        launches = {name: k.launches for name, k in kernels.items()}
        out[dev] = dict(z=z.cpu(), idx=idx.cpu(), logs=logs, grads=grads[0],
                        vq=_flat(torch, vqvae), d=_flat(torch, disc),
                        stats=(_flat(torch, disc, params_only=False)
                               if disc_norm == "batch" else torch.cat(
                                   [v.flatten().cpu().float()
                                    for v in disc.buffers()])),
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
    print(f"{label}, card vs CPU: {flips} index flips ({far} "
          f"not near-ties); max rel loss diff {loss_err:.3e}; max|grad "
          f"diff|={grad_err:.3e} (max|grad| {grad_size:.3e}); max|BN stats "
          f"diff|={stats_err:.3e}; "
          + ", ".join(f"{n} moves: |diff|/|cpu move|={r:.3e}, {f:.2%} over "
                      f"lr/2" for n, (r, f) in moves.items())
          + f"; launches on the card {gpu['launches']}")
    if far or not usage_ok or loss_err > 1e-4 \
            or grad_err > 1e-3 * grad_size or stats_err > 1e-4 \
            or any(r > 0.05 or f > 0.01 for r, f in moves.values()):
        fail(f"{label} on the card disagree with the CPU")
    if gpu["launches"] != expected:
        fail(f"{label}: expected launches {expected} in {n_steps} steps, "
             f"got {gpu['launches']}")


def check_small_captured(torch, kernels, seed: int) -> dict:
    """Phase 4i: the captured modes (CUDA graphs), TF32 off and
    cudnn.deterministic pinned. Returns phase 5's eager and captured
    DDIM samples/s.
    (a) a block of 4 `make_ldm_scan_step` steps of phase 4b's tiny U-Net
        from step 97 (the EMA's cadence and its warm copy at step 100
        inside), injected t, noise and mask, captured on the card against
        the CPU's eager block, held as 4b holds; one launch of each flash
        kernel per step, counted through the replays;
    (b) `ldm_captured_vs_eager`;
    (c) phase 4c's VQ-GAN as scan_g then scan_gd across disc_start,
        captured, against the CPU's split steps (`check_small_vqgan`);
    (d) `ddim_captured_vs_eager`."""
    from vqgan_tpu_torch.models import CFGUnet

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.manual_seed(seed)
        init = CFGUnet(dim=16, num_classes=3, cond_drop_prob=0.0,
                       dim_mults=(1, 2), channels=4, attn_dim_head=16,
                       attn_heads=2)
        card_vs_cpu_training(torch, kernels, "small U-Net scan block", init,
                             seed, remat=False, n_steps=4, scan_start=97,
                             per_step={name: 1 for name in FLASH})
        ldm_captured_vs_eager(torch, kernels, init, seed)
        check_small_vqgan(torch, kernels, seed, scan=True)
        return ddim_captured_vs_eager(torch, kernels, seed)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def ldm_captured_vs_eager(torch, kernels, init, seed: int):
    """Phase 4i (b): two blocks of 4 steps of the tiny U-Net, t, noise and
    the cond-drop mask (p 0.5) drawn from a generator of one seed, two
    ways on the card: eagerly (`graph=False`), and as one step's graph
    replayed per step (its first step eager, the warm-up). The captured
    run must equal the eager one bit for bit in
    every loss, parameter and EMA value (the same kernels on the same
    inputs: cudnn.deterministic, the flash kernels' fixed order, the same
    Philox draws), leave the generator where the eager run leaves it, and
    launch each flash kernel once per step."""
    import copy

    from vqgan_tpu_torch.diffusion import GaussianDiffusion
    from vqgan_tpu_torch.training.ldm_step import (
        LDMTrainState,
        make_ldm_optimizer,
        make_ldm_scan_step,
    )

    rng = np.random.default_rng(seed + 12)
    lat = torch.from_numpy(rng.standard_normal((2, 4, 4, 8, 8, 4)).astype(
        np.float32)).cuda()
    cls = torch.from_numpy(rng.integers(0, 3, (2, 4, 4))).cuda()
    runs = {}
    for label, kw in (("eager", dict(graph=False)),
                      ("step graphs", {})):
        model = copy.deepcopy(init).cuda().train()
        diffusion = GaussianDiffusion(
            model, image_size=8, channels=4, timesteps=20,
            objective="pred_v", min_snr_loss_weight=True,
            auto_normalize=False, device=torch.device("cuda"))
        opt = make_ldm_optimizer(model.parameters(), learning_rate=1e-4,
                                 weight_decay=1e-4, betas=(0.9, 0.99),
                                 max_grad_norm=1.0, capturable=True)
        state = LDMTrainState(97, model,
                              copy.deepcopy(model).requires_grad_(False), opt)
        block = make_ldm_scan_step(diffusion, opt, cond_drop_prob=0.5, **kw)
        gen = torch.Generator("cuda").manual_seed(seed + 13)
        reset_counts(kernels)
        losses = torch.cat([block(state, lat[i], cls[i],
                                  generator=gen)["loss"] for i in range(2)])
        runs[label] = dict(
            losses=losses.cpu(), params=_flat(torch, model),
            ema=_flat(torch, state.ema_model), rng=gen.get_state(),
            launches={name: kernels[name].launches for name in FLASH})
    ref = runs.pop("eager")
    for label, run in runs.items():
        diffs = {k: (run[k] - ref[k]).abs().max().item()
                 for k in ("losses", "params", "ema")}
        print(f"LDM {label} vs eager on the card, 8 steps from one "
              f"generator: max|diff| {diffs}; launches {run['launches']}")
        if any(diffs.values()) or not torch.equal(run["rng"], ref["rng"]):
            fail(f"LDM {label} differ from the eager steps")
        if run["launches"] != {name: 8 for name in FLASH} \
                or ref["launches"] != run["launches"]:
            fail(f"LDM {label}: expected 8 launches of each flash kernel, "
                 f"got {run['launches']} (eager {ref['launches']})")


def ddim_captured_vs_eager(torch, kernels, seed: int) -> dict:
    """Phase 4i (d): DDIM-150 at LDMConfig's full width (seeded random
    U-Net, the default KL-VAE decode), batch 16, cond_scale 1.0 and 3.0,
    noise drawn from a generator of one seed: the captured sampler against
    the eager loop (`graph=False`), images within 1e-5 of the largest
    eager value, 151 forward launches per decoded batch either way, the
    first captured call (a step, the capture, the replays) equal to the
    later ones. Timed in turns (eager, captured; the pass back cut to pay
    for phase 6) after that first call; returns samples/s."""
    from vqgan_tpu_torch.configs import LDMConfig
    from vqgan_tpu_torch.generate import load_model, load_vae

    cfg = LDMConfig()
    torch.manual_seed(seed)
    diffusion, _ = load_model(cfg, device="cuda")
    vae = load_vae(None, cfg.latent_channels, cfg.image_size, device="cuda")
    classes = torch.arange(16) % cfg.num_users
    rates = {}
    for cond_scale in (1.0, 3.0):
        def run(graph):
            gen = torch.Generator("cuda").manual_seed(seed + 14)
            reset_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            z = diffusion.ddim_sample((16, 32, 32, 4), classes,
                                      cond_scale=cond_scale,
                                      rescaled_phi=0.7, generator=gen,
                                      graph=graph)
            with torch.inference_mode():
                images = vae.decode_latents(z).float()
            torch.cuda.synchronize()
            return (images.cpu(), time.perf_counter() - t0,
                    read_counts(kernels))

        first = run(True)  # the capture, before the turns
        # (eager, captured): the pass back was cut to pay for phase 6
        out = [run(graph) for graph in (False, True)]
        eager, captured = out[0][0], out[1][0]
        err = (captured - eager).abs().max().item()
        size = eager.abs().max().item()
        for images, _, counts in [first, *out]:
            fwd = sum(n for (name, _), n in counts.items()
                      if name == "flash_fwd")
            if fwd != 151 or sum(counts.values()) != 151:
                fail(f"DDIM-150 + decode at cond_scale {cond_scale}: "
                     f"expected 151 forward launches, got {counts}")
        if not torch.equal(first[0], captured):
            fail("the captured sampler's first call (its capture) differs "
                 "from its replays")
        secs = {"eager": out[0][1], "captured": out[1][1]}
        rates[cond_scale] = {k: 16 / v for k, v in secs.items()}
        graph = next(iter(diffusion._graphs.values()))
        print(f"DDIM-150 + decode, batch 16, cond_scale {cond_scale}: "
              f"captured vs eager max|diff| {err:.3e} (max|image| "
              f"{size:.3e}); seconds per batch in turns (eager, captured) "
              f"{[round(o[1], 4) for o in out]}; "
              f"samples/s {rates[cond_scale]}; capture "
              f"{graph.capture_seconds:.3f} s, pool {graph.pool_bytes} B")
        diffusion._graphs.clear()
        if not np.isfinite(captured.numpy()).all() or err > 1e-5 * size:
            fail(f"the captured DDIM sampler disagrees with the eager loop "
                 f"at cond_scale {cond_scale}")
    return rates


def sampler_cases(torch, seed: int) -> list:
    """Phase 4j's samplers at 4g-4h's tiny widths, fp32: (label,
    make(device) -> the diffusion on that device, run(diffusion, graph,
    generator, draws) -> the output, draws(rng) -> the injected noise
    (numpy), model forwards per call)."""
    import copy

    from vqgan_tpu_torch.diffusion import (
        ContinuousTimeGaussianDiffusion,
        ElucidatedDiffusion,
        GaussianDiffusion,
        GaussianDiffusion1D,
        GuidedGaussianDiffusion,
        LearnedLogSNR,
        LearnedScheduleDenoiser,
        LearnedVarianceGaussianDiffusion,
        RePaintDiffusion,
        SimpleDiffusion,
        VParamContinuousTimeGaussianDiffusion,
        WeightedObjectiveGaussianDiffusion,
        make_classifier_cond_fn,
    )
    from vqgan_tpu_torch.models import CFGUnet, KarrasUnet, Unet, Unet1D, UViT
    from vqgan_tpu_torch.models.resnet import ResNet18

    img, lat, seq = (4, 16, 16, 3), (4, 8, 8, 4), (4, 32, 4)
    t_steps = 10
    classes = np.array([0, 1, 2, 0])

    def noise(shape, n=None):
        def draw(rng):
            return {"init_noise": rng.standard_normal(shape).astype(
                np.float32), **({} if n is None else {
                    "step_noise": rng.standard_normal(
                        (n, *shape)).astype(np.float32)})}
        return draw

    def on(init, dev):
        return copy.deepcopy(init).to(torch.device(dev)).eval()

    torch.manual_seed(seed + 30)
    unet = Unet(dim=16, dim_mults=(1, 2), full_attn=(False, True))
    unet_sc = Unet(dim=16, dim_mults=(1, 2), full_attn=(False, True),
                   self_condition=True)
    unet_lv = Unet(dim=16, dim_mults=(1, 2), full_attn=(False, True),
                   learned_variance=True)
    unet_wo = Unet(dim=16, dim_mults=(1, 2), full_attn=(False, True),
                   out_dim=8)
    unet_ct = Unet(dim=16, dim_mults=(1, 2), full_attn=(False, True),
                   learned_sinusoidal_cond=True)
    schedule = LearnedLogSNR(
        *ContinuousTimeGaussianDiffusion.learned_endpoints(), hidden_dim=32)
    cfg = CFGUnet(dim=16, num_classes=3, cond_drop_prob=0.0, dim_mults=(1, 2),
                  channels=4, attn_dim_head=16, attn_heads=2)
    uvit = UViT(dim=16, dim_mults=(1, 2), vit_depth=2, attn_heads=2)
    unet1d = Unet1D(dim=16, dim_mults=(1, 2), channels=4)
    karras = KarrasUnet(image_size=16, dim=16, dim_max=64, num_classes=3,
                        channels=3, num_downsamples=2,
                        num_blocks_per_stage=1, attn_res=(8, 4),
                        attn_dim_head=16)
    classifier = ResNet18(3)
    with torch.no_grad():
        for name, p in karras.named_parameters():
            if name.endswith("gain"):
                p.fill_(0.5)
    gd_kw = dict(image_size=16, timesteps=t_steps, objective="pred_v")

    def gaussian(cls, init, **kw):
        return lambda dev: cls(on(init, dev), **{**gd_kw, **kw},
                               device=torch.device(dev))

    def cls_on(dev):
        return torch.from_numpy(classes).to(dev)

    def edm(dev):
        net = on(karras, dev)
        labels = cls_on(dev)
        return ElucidatedDiffusion(
            lambda x, t, self_cond=None: net(x, t, class_labels=labels),
            image_size=16, num_sample_steps=4, device=torch.device(dev))

    def guided(dev):
        d = GuidedGaussianDiffusion(on(unet, dev), **gd_kw,
                                    sampling_timesteps=4,
                                    device=torch.device(dev))
        net = on(classifier, dev)
        d.guide = (make_classifier_cond_fn(lambda x, t: net(x), 2.0),
                   {"y": cls_on(dev)})
        return d

    rp_kw = dict(resample_iter=2, resample_jump=2, resample_every=4)
    n_denoise = int((RePaintDiffusion(unet, **gd_kw, **rp_kw, device="cpu")
                     .schedule_ops()[:, 0] == 0).sum())
    n_ops = len(RePaintDiffusion(unet, **gd_kw, **rp_kw,
                                 device="cpu").schedule_ops())

    def repaint_draws(rng):
        return {"init_noise": rng.standard_normal(img).astype(np.float32),
                "blend_noise": rng.standard_normal((n_ops, *img)).astype(
                    np.float32),
                "step_noise": rng.standard_normal((n_ops, *img)).astype(
                    np.float32)}

    gt = np.random.default_rng(seed + 31).random(img).astype(np.float32)
    mask = np.zeros((4, 16, 16, 1), np.float32)
    mask[:, :, :8] = 1.0
    x1, x2 = np.random.default_rng(seed + 32).random((2, *img)).astype(
        np.float32)

    def ct(learned: bool):
        def make(dev):
            kw = dict(image_size=16, num_sample_steps=4,
                      device=torch.device(dev))
            if learned:
                return ContinuousTimeGaussianDiffusion(
                    LearnedScheduleDenoiser(on(unet_ct, dev),
                                            on(schedule, dev)),
                    noise_schedule="learned", **kw)
            return VParamContinuousTimeGaussianDiffusion(on(unet_ct, dev),
                                                         **kw)
        return make

    def sample(d, graph, gen, draws):
        return d.sample(4, generator=gen, graph=graph, **(draws or {}))

    return [
        ("ancestral, CFG U-Net at cond_scale 3", gaussian(
            GaussianDiffusion, cfg, image_size=8, channels=4,
            objective="pred_v"),
         lambda d, graph, gen, draws: d.p_sample_loop(
             lat, cls_on(d.device), cond_scale=3.0, rescaled_phi=0.7,
             generator=gen, graph=graph, **(draws or {})),
         noise(lat, t_steps), t_steps),
        ("ancestral, self-conditioned DDPM U-Net", gaussian(
            GaussianDiffusion, unet_sc, self_condition=True),
         lambda d, graph, gen, draws: d.p_sample_loop(
             img, None, generator=gen, graph=graph, **(draws or {})),
         noise(img, t_steps), t_steps),
        ("DDIM-4, self-conditioned DDPM U-Net", gaussian(
            GaussianDiffusion, unet_sc, self_condition=True,
            sampling_timesteps=4),
         lambda d, graph, gen, draws: d.ddim_sample(
             img, None, generator=gen, graph=graph, **(draws or {})),
         noise(img, 4), 4),
        ("interpolate from t = 6", gaussian(GaussianDiffusion, unet),
         lambda d, graph, gen, draws: d.interpolate(
             x1, x2, None, t=6, lam=0.3, generator=gen, graph=graph,
             **({} if draws is None else {
                 "noise1": draws["init_noise"], "noise2": draws["noise2"],
                 "step_noise": draws["step_noise"]})),
         lambda rng: {**noise(img, 6)(rng), "noise2": rng.standard_normal(
             img).astype(np.float32)}, 6),
        ("learned variance, ancestral", gaussian(
            LearnedVarianceGaussianDiffusion, unet_lv,
            objective="pred_noise"),
         lambda d, graph, gen, draws: d.p_sample_loop(
             img, generator=gen, graph=graph, **(draws or {})),
         noise(img, t_steps), t_steps),
        ("weighted objective, ancestral", gaussian(
            WeightedObjectiveGaussianDiffusion, unet_wo,
            objective="pred_noise"),
         lambda d, graph, gen, draws: d.p_sample_loop(
             img, generator=gen, graph=graph, **(draws or {})),
         noise(img, t_steps), t_steps),
        ("guided ancestral (ResNet18's autograd.grad inside)", guided,
         lambda d, graph, gen, draws: d.p_sample_loop_guided(
             img, *d.guide, generator=gen, graph=graph, **(draws or {})),
         noise(img, t_steps), t_steps),
        ("guided DDIM-4", guided,
         lambda d, graph, gen, draws: d.ddim_sample_guided(
             img, *d.guide, generator=gen, graph=graph, **(draws or {})),
         noise(img, 4), 4),
        ("EDM Heun-4, KarrasUnet", edm,
         lambda d, graph, gen, draws: d.sample(
             4, generator=gen, graph=graph, **(draws or {})),
         noise(img, 4), 8),
        ("EDM DPM++(2M)-4, KarrasUnet", edm,
         lambda d, graph, gen, draws: d.sample_using_dpmpp(
             4, generator=gen, graph=graph, **(draws or {})),
         noise(img), 4),
        ("continuous time, learned log-SNR", ct(True), sample,
         noise(img, 4), 4),
        ("continuous time, v", ct(False), sample, noise(img, 4), 4),
        ("simple diffusion, UViT", lambda dev: SimpleDiffusion(
            on(uvit, dev), image_size=16, num_sample_steps=4,
            device=torch.device(dev)), sample, noise(img, 4), 4),
        (f"RePaint ({n_denoise} denoise of {n_ops} ops)", gaussian(
            RePaintDiffusion, unet, **rp_kw),
         lambda d, graph, gen, draws: d.inpaint(
             gt, mask, generator=gen, graph=graph, **(draws or {})),
         repaint_draws, n_denoise),
        ("1-D, ancestral", lambda dev: GaussianDiffusion1D(
            on(unet1d, dev), image_size=32, seq_length=32, channels=4,
            timesteps=t_steps, objective="pred_v",
            device=torch.device(dev)),
         lambda d, graph, gen, draws: d.p_sample_loop(
             seq, None, generator=gen, graph=graph, **(draws or {})),
         noise(seq, t_steps), t_steps),
        ("1-D, DDIM-4", lambda dev: GaussianDiffusion1D(
            on(unet1d, dev), image_size=32, seq_length=32, channels=4,
            timesteps=t_steps, sampling_timesteps=4, objective="pred_v",
            device=torch.device(dev)),
         lambda d, graph, gen, draws: d.ddim_sample(
             seq, None, generator=gen, graph=graph, **(draws or {})),
         noise(seq, 4), 4),
    ]


def check_small_sampler_graphs(torch, kernels, seed: int):
    """Phase 4j: every captured sampler (`graphs.run_chain`: one step's
    CUDA graph replayed per step) at tiny widths, cudnn.deterministic
    pinned (`sampler_cases`):
    - from injected noise, captured on the card against the CPU's eager
      loop: outputs within 1e-3 (phase 4's rule: cuDNN and the kernels sum
      in other orders);
    - from one generator, captured against the eager loop (`graph=False`)
      on the card: equal bit for bit, the generator left where the eager
      loop leaves it;
    - the launches of every run, counted through the replays, equal to the
      eager loop's, a whole number per model forward;
    - the auction at batch 16: captured blocks of bids (three default
      calls, which keep one graph of 16 bids in the module's
      `DEFAULT_GRAPHS`)
      against eager against the CPU, the same permutation;
    - phase 4c's VQ-GAN with the ActNorm discriminator as the scan mode's
      programs (`make_vqgan_scan_steps`, what `VQGANTrainer(step_mode=
      "scan")` dispatches), captured, against the CPU's split steps
      (`check_small_vqgan`)."""
    from vqgan_tpu_torch.ops.assignment import auction_assignment

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    try:
        for label, make, run, draws, n_fwd in sampler_cases(torch, seed):
            inject = draws(np.random.default_rng(seed + 33))
            cpu = run(make("cpu"), None, None, inject).float()
            card = make("cuda")
            runs = {}
            for name, graph, drawn in (("captured, injected", None, False),
                                       ("eager, drawn", False, True),
                                       ("captured, drawn", None, True)):
                gen = (torch.Generator("cuda").manual_seed(seed + 34)
                       if drawn else None)
                reset_counts(kernels)
                out = run(card, graph, gen, None if drawn else inject)
                torch.cuda.synchronize()
                runs[name] = (out.float().cpu(), read_counts(kernels),
                              gen.get_state() if drawn else None)
            got, counts, _ = runs["captured, injected"]
            err = (got - cpu).abs().max().item()
            eager, captured = runs["eager, drawn"], runs["captured, drawn"]
            fwd = sum(n for (k, _), n in eager[1].items() if k == "flash_fwd")
            stats = card._graphs.stats()
            print(f"{label}: captured vs CPU max|diff| {err:.3e}; captured "
                  f"vs eager from one generator "
                  f"{(captured[0] - eager[0]).abs().max().item():.3e}; "
                  f"launches {eager[1]}; {len(stats['graphs'])} graph(s), "
                  f"capture {stats['capture_seconds']:.3f} s, pool "
                  f"{stats['pool_bytes']} B")
            if not bool(torch.isfinite(got).all()) or err > 1e-3:
                fail(f"{label}: the captured chain on the card disagrees "
                     f"with the CPU")
            if not torch.equal(captured[0], eager[0]) \
                    or not torch.equal(captured[2], eager[2]):
                fail(f"{label}: the captured chain differs from the eager "
                     f"loop on the card")
            if not fwd or fwd % n_fwd or any(
                    r[1] != eager[1] for r in runs.values()) or any(
                    k != "flash_fwd" for (k, _) in eager[1]):
                fail(f"{label}: expected the eager loop's launches, a "
                     f"whole number per forward ({n_fwd} forwards), "
                     f"through the replays: "
                     f"{ {k: r[1] for k, r in runs.items()} }")

        dist = torch.from_numpy(np.random.default_rng(seed + 35).random(
            (16, 16)).astype(np.float32))
        perms = {"cpu": auction_assignment(dist).tolist(),
                 "eager": auction_assignment(dist.cuda(), graph=False)
                 .tolist()}
        from vqgan_tpu_torch.ops.assignment import DEFAULT_GRAPHS

        for i in range(3):  # the capture, then the replays alone
            perms[f"captured {i}"] = auction_assignment(
                dist.cuda()).tolist()
        stats = DEFAULT_GRAPHS.stats()
        print(f"auction at batch 16: {perms}; the default calls' graphs "
              f"{stats}")
        if any(p != perms["cpu"] for p in perms.values()) \
                or sorted(perms["cpu"]) != list(range(16)):
            fail("the captured auction's permutation differs")
        if [g["name"] for g in stats["graphs"]].count(
                "auction, 16 bids") != 1:
            fail("the auction's default calls at batch 16 did not keep "
                 "one graph of their blocks of bids")
        check_small_vqgan(torch, kernels, seed, scan=True, disc_norm="act")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"phase 4j: {time.perf_counter() - t0:.3f} s")


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
    print(f"train_latent_cfg loaders: {first['loader']}, "
          f"{second['loader']} (with device prefetch)")
    if (first["loader"], second["loader"]) != ("native_latents",) * 2:
        fail(f"train_latent_cfg read through {first['loader']} / "
             f"{second['loader']}, not the native latent batch reader")
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


def drive_vqgan_training(torch, kernels, seed: int, work: Path,
                         jpeg: bool):
    """Full-width stage-1 training through `train_vqgan.main` (VQGANConfig
    defaults: batch 8 at 256 px, bf16): 10 G-only steps (disc_start 10)
    with the off-cadence final save, then a resume to step 30 (G + D from
    step 10, saves at steps 20 and 30). With libjpeg's headers (`jpeg`)
    the config sets `native_input` true, so the run reads through the C++
    ring or raises; without, the Python loader. Returns ({(kernel, shape):
    launches}, {"G only": images/s, "G + D": images/s})."""
    from vqgan_tpu_torch import train_vqgan
    from vqgan_tpu_torch.checkpoint import CheckpointManager
    from vqgan_tpu_torch.training.vqgan_trainer import VQGANTrainer

    split, images = write_image_data(work, seed)
    config = work / "vqgan_config.json"
    config.write_text(json.dumps({"seed": seed, "images_per_user_train": 8,
                                  **({"native_input": True} if jpeg
                                     else {})}))
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
    want = expected_image_loader(jpeg)
    print(f"train_vqgan loaders: {first['loader']}, {second['loader']} "
          f"(with device prefetch; libjpeg headers {jpeg})")
    if (first["loader"], second["loader"]) != (want, want):
        fail(f"train_vqgan read through {first['loader']} / "
             f"{second['loader']}, expected {want}")
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


def drive_captured_training(torch, kernels, seed: int, work: Path,
                            ldm: Path, vqgan: Path, card: str):
    """Phase 5j, the captured training modes at full width through their
    entry points, with seeded random weights:
    - `train_latent_cfg --step_mode scan --scan_block 8` (LDMConfig
      defaults: batch 8, bf16) on phase 5b's split and latent cache, 41
      steps, then a resume to 50: finite losses, one launch of each flash
      kernel per step at [8, 16, 8, 64] bf16 counted through the replays,
      the EMA the warm copy of step 40's weights and not the final ones,
      the checkpoint loading back;
    - the same with `--model_type dit`: 8 launches of each per step at
      [8, 256, 8, 64];
    - `train_vqgan --step_mode scan` and `--step_mode fused` (VQGANConfig
      defaults: batch 8 at 256 px, bf16) on phase 5c's images, 16 steps
      with disc_start 8 and a save every 8: finite losses, per G step one
      VQ and two of each flash launch, one VQ and two forwards per grid,
      the discriminator unchanged at the step-8 milestone and moved by
      step 16;
    - rates in turns in this process, each run a fresh trainer of 16 steps
      (cut from 32 to keep the smoke in its time) timed after its first 8
      (captures excluded): the U-Net's and the
      DiT's step and scan modes (step, scan); the VQ-GAN's split, scan and
      fused at disc_start 0 (split, scan, fused; the pass back of each
      sequence cut to pay for phase 6's TP serving); with each graph's
      capture seconds and pool bytes.
    Returns ({(kernel, shape): launches}, {metric: value})."""
    from vqgan_tpu_torch import train_latent_cfg, train_vqgan
    from vqgan_tpu_torch.checkpoint import CheckpointManager
    from vqgan_tpu_torch.configs import LDMConfig, VQGANConfig
    from vqgan_tpu_torch.training.ldm_trainer import LatentDiffusionTrainer
    from vqgan_tpu_torch.training.vqgan_trainer import VQGANTrainer

    t_phase = time.perf_counter()
    counts, metrics = {}, {}
    split, cache = ldm / "data_split.json", ldm / "latents_cache"

    def gated(label, fn, expected):
        return run_gated(torch, kernels, label, fn, expected, counts)

    # --- stage 2: the U-Net and the DiT in scan mode, with a resume -----
    for model_type, per_step, key in (
            ("unet", 1, (8, 16, 8, 64, "bfloat16")),
            ("dit", 8, (8, 256, 8, 64, "bfloat16"))):
        results = work / f"scan_{model_type}"
        common = ["--model_type", model_type, "--step_mode", "scan",
                  "--scan_block", "8", "--split", str(split),
                  "--latents_cache_folder", str(cache), "--results_folder",
                  str(results), "--seed", str(seed)]
        first, _ = gated(
            f"train_latent_cfg --model_type {model_type} --step_mode scan "
            f"(41 steps)",
            lambda: train_latent_cfg.main([*common, "--train_num_steps",
                                           "41"]),
            {(name, key): 41 * per_step for name in FLASH})
        trainer = first.pop("trainer")
        warm = {k: v.detach().clone()
                for k, v in trainer.model.state_dict().items()}
        graphs = trainer.graph_stats()
        del trainer
        second, _ = gated(
            f"train_latent_cfg --model_type {model_type} --step_mode scan "
            f"(resumed to 50)",
            lambda: train_latent_cfg.main([*common, "--train_num_steps",
                                           "50", "--resume", "-1"]),
            {(name, key): 9 * per_step for name in FLASH})
        trainer = second.pop("trainer")
        losses = first["losses"] + second["losses"]
        if len(losses) != 50 or not all(np.isfinite(losses)):
            fail(f"scan {model_type}: expected 50 finite losses, got "
                 f"{losses}")
        ema = trainer.ema_model.state_dict()
        online = trainer.model.state_dict()
        if trainer.state.step != 50 or any(
                not torch.equal(ema[k], warm[k]) for k in warm):
            fail(f"scan {model_type}: the EMA is not the step-40 warm copy")
        if all(torch.equal(ema[k], online[k]) for k in online):
            fail(f"scan {model_type}: the EMA equals the final weights")
        saved = CheckpointManager(results, prefix="model").restore()
        if saved["step"] != 50 or any(
                not torch.equal(saved["ema"][k], ema[k].cpu()) for k in ema):
            fail(f"scan {model_type}: the checkpoint does not load back")
        metrics[f"scan_{model_type}"] = {
            "latents_per_s": first["latents_per_s"], "graphs": graphs}
        print(f"[{card}] train_latent_cfg --model_type {model_type} "
              f"--step_mode scan: 41 + 9 steps (resumed), "
              f"{first['latents_per_s']:.4f} latents/s over "
              f"{first['timed_steps']} steps; EMA = step-40 warm copy; "
              f"checkpoint loads back; graphs {graphs}; losses {losses}")
        del trainer, saved, warm, ema, online

    # --- stage 1: the VQ-GAN's scan and fused modes across disc_start ---
    images = vqgan / "images"
    vq_key = (8192, 128, 256, "fp32")
    attn_key = (8, 1024, 1, 512, "bfloat16")
    config = work / "vqgan_config.json"
    config.write_text(json.dumps({"seed": seed, "images_per_user_train": 8}))
    d_init = {k: v.clone() for k, v in VQGANTrainer(
        VQGANConfig.from_dict(json.loads(config.read_text())),
        device="cpu").disc.state_dict().items()}
    for mode in ("scan", "fused"):
        results = work / f"vqgan_{mode}"
        result, _ = gated(
            f"train_vqgan --step_mode {mode} (16 steps, disc_start 8)",
            lambda: train_vqgan.main([
                "--config", str(config), "--split",
                str(vqgan / "data_split.json"), "--data_path", str(images),
                "--results_folder", str(results), "--disc_start", "8",
                "--save_every", "8", "--train_steps", "16", "--step_mode",
                mode]),
            {("vq_nearest", vq_key): 16 + 2,
             ("flash_fwd", attn_key): 2 * (16 + 2),
             ("flash_bwd_dq", attn_key): 2 * 16,
             ("flash_bwd_dkv", attn_key): 2 * 16})
        trainer = result.pop("trainer")
        losses = result["losses"]
        ckpt = CheckpointManager(results, prefix="vqgan")
        at8 = ckpt.restore(1)["disc"]
        final = {k: v.cpu() for k, v in trainer.disc.state_dict().items()}
        if len(losses) != 16 or not all(np.isfinite(losses)):
            fail(f"train_vqgan {mode}: expected 16 finite losses, got "
                 f"{losses}")
        if ckpt.restore()["step"] != 16 or any(
                not torch.equal(at8[k].cpu(), v) for k, v in d_init.items()):
            fail(f"train_vqgan {mode}: the discriminator moved before "
                 f"disc_start, or the checkpoints do not load back")
        if any(torch.equal(final[k], v) for k, v in d_init.items()
               if "num_batches" not in k):
            fail(f"train_vqgan {mode}: the discriminator did not move "
                 f"after disc_start")
        metrics[f"vqgan_{mode}"] = {"images_per_s": result["images_per_s"],
                                    "graphs": trainer.graph_stats()}
        print(f"[{card}] train_vqgan --step_mode {mode}: 16 steps, "
              f"{result['images_per_s']:.4f} images/s over "
              f"{result['timed_steps']} steps; discriminator unchanged to "
              f"step 8, moved by 16; graphs {trainer.graph_stats()}; losses "
              f"{losses}")
        del trainer

    # --- rates in turns --------------------------------------------------
    def ldm_run(model_type, mode):
        cfg = LDMConfig.from_dict({
            "model_type": model_type, "latents_cache_folder": str(cache),
            "results_folder": str(work / "turns"), "seed": seed})
        trainer = LatentDiffusionTrainer(cfg, split_path=str(split),
                                         device="cuda", step_mode=mode)
        return trainer, "latents_per_s"

    def vqgan_run(mode):
        cfg = VQGANConfig.from_dict({
            "seed": seed, "images_per_user_train": 8, "disc_start": 0,
            "data_path": str(images), "results_folder": str(work / "turns")})
        trainer = VQGANTrainer(cfg, split_path=str(vqgan / "data_split.json"),
                               device="cuda", step_mode=mode)
        return trainer, "images_per_s"

    sequences = {
        "unet": [("step", lambda: ldm_run("unet", "step")),
                 ("scan", lambda: ldm_run("unet", "scan"))],
        "dit": [("step", lambda: ldm_run("dit", "step")),
                ("scan", lambda: ldm_run("dit", "scan"))],
        "vqgan": [("split", lambda: vqgan_run("split")),
                  ("scan", lambda: vqgan_run("scan")),
                  ("fused", lambda: vqgan_run("fused"))]}
    turns = {}
    for model, runs in sequences.items():
        rates = {label: [] for label, _ in runs}
        graphs = {}
        for label, make in runs:  # the pass back cut to pay for phase 6
            reset_counts(kernels)
            trainer, rate_key = make()
            trainer.save_and_sample = lambda *args: None  # no checkpoints
            result = trainer.train(num_steps=16, log_every=0,
                                   timing_warmup=8)
            rates[label].append(result[rate_key])
            graphs.setdefault(label, trainer.graph_stats())
            del trainer, result
        turns[model] = {"rates": rates, "graphs": graphs}
        print(f"[{card}] {model} training rates in turns "
              f"({' '.join(label for label, _ in runs)}), 8 "
              f"steps after 8 each: " + "; ".join(
                  f"{label} {[round(r, 4) for r in vals]}"
                  for label, vals in rates.items())
              + f"; graphs {graphs}")
    metrics["turns"] = turns
    metrics["phase_seconds"] = time.perf_counter() - t_phase
    print(f"phase 5j: {metrics['phase_seconds']:.3f} s")
    return counts, metrics


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


def run_gated_tagged(torch, kernels, label, fn, expected, counts,
                     tag=None):
    """`run_gated`, its launches added to `counts` under (kernel, shape +
    (tag,)) for a tagged path, as `row_key` keys its rows."""
    mine = {}
    result = run_gated(torch, kernels, label, fn, expected, mine)
    for (name, shape), n in mine.items():
        key = (name, shape + (tag,) if tag else shape)
        counts[key] = counts.get(key, 0) + n
    return result


def drive_gmm_classifier_slice(torch, kernels, seed: int, work: Path,
                               n_users: int = 16, per_user: int = 60,
                               size: int = 256):
    """Phase 5e, the GMM split, the cluster validation, the classifier and
    FID at full width through their entry points, on `n_users` x
    `per_user` seeded JPGs (`write_user_images`; the reference has 31
    users of ~150; 16 users keep the smoke within its time), with a
    random `AutoencoderConfig()` KL-VAE from the seed
    saved as a port checkpoint:
    - `preprocess_latents_with_gmm` at its defaults (30 gen-train, 20
      class-train per user; batches of 16, the last zero-padded): one
      flash forward per encode batch at [16, 1024, 1, 512] fp32 and no
      other launch; the split passes `verify_split`; each cluster's gen
      and class counts are `largest_remainder_quotas` of its members; the
      cache holds exactly the 480 gen-train latents, finite [32, 32, 4];
    - `validate_cluster_number --num_users 2 --k_min 2 --k_max 4`: its
      JSON report, 4 forwards per user;
    - `generate --random_init --user_ids 1 2 3 4 --num_images 16` into
      `ID_x` folders: 151 forwards per user (150 U-Net steps at [16, 16,
      8, 64] bf16, 1 decode at [16, 1024, 1, 512] fp32, phase 3's
      unet_mid and vae_mid rows);
    - `classifier_experiment` on the real class-train images and that
      synthetic folder (ResNet18 at 256 px, batch 64, Adam 1e-4, ImageNet
      normalisation), one seed, 2 epochs: finite losses, 160 test
      samples, the results JSON; no hand-written kernel; then, untimed by
      the CLI, the loader alone over the real class-train images and 5
      train steps on one batch resident on the card;
    - FID with the port's Inception (random init from the seed: not
      calibrated) of the 160 test images against the 16 generated ones
      (finite, >= 0), and of the test images against themselves, which
      is 0 but for the square root's rounding: the covariance has rank
      159 of 2048, so ~1890 eigenvalues of its square are float64
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


def time_served_step(torch, kernels, counts, card: str, diffusion,
                     artifact: Path, unet_key) -> dict:
    """Host ms of one DDIM step at batch 16, cond_scale 1.0, in turns in
    this process: the live `DDIMStep` of the checkpoint, the artifact's
    step program as `load_program` gives it, and the same program with the
    no-op nodes that `torch.export` keeps. One flash forward per step, and
    no other launch. Returns {variant: [ms per step of each turn]}."""
    import torch.export as export

    from vqgan_tpu_torch.diffusion.gaussian import DDIMStep
    from vqgan_tpu_torch.serving import load_program

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
    # 2 turns of 10, cut from 3 turns of 20 to pay for phase 6
    steps, turns = 10, 2
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


def served_vs_live(torch, kernels, counts, card: str, diffusion, vae,
                   artifact: Path, expected) -> dict:
    """Seconds per batch of 16 at cond_scale 1.0 (150 DDIM steps and the
    decode), from one generator seed, in turns in this process: the live
    sampler (`ddim_sample` and `decode_latents`, as `generate` runs them)
    and the served one (`CFGSampler`), each eagerly (`graph=False`) and
    captured: live eager, live captured, served eager, served captured
    (one pass; the pass back, ~11 s, was cut to pay for phase 6's
    trainers). The captured runs' first calls (the captures) come before
    the turns. The served images equal the live ones (within 1e-5 of the
    largest) in each mode; 151 forwards per batch (`expected`: 4
    batches). Returns {variant: [seconds per batch]}."""
    from vqgan_tpu_torch.serving import load_cfg_sampler

    sampler = load_cfg_sampler(artifact, "cuda")
    classes = torch.zeros((16,), dtype=torch.long, device="cuda")

    def live(graph):
        gen = torch.Generator("cuda").manual_seed(5)
        z = diffusion.ddim_sample((16, 32, 32, 4), classes, cond_scale=1.0,
                                  rescaled_phi=0.0, generator=gen,
                                  graph=graph)
        with torch.inference_mode():
            return vae.decode_latents(z).float()

    def served(graph):
        gen = torch.Generator("cuda").manual_seed(5)
        return sampler(classes, generator=gen, graph=graph)

    variants = {"live eager": lambda: live(False),
                "live captured": lambda: live(True),
                "served eager": lambda: served(False),
                "served captured": lambda: served(True)}
    reset_counts(kernels)
    live(True), served(True)  # the captures, before the turns
    times = {name: [] for name in variants}
    images = {}

    def run():
        for name in variants:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            images[name] = variants[name]().cpu()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)

    run_gated(torch, kernels, "live and served sampler in turns", run,
              expected, counts)
    size = images["live eager"].abs().max().item()
    errs = {name: (img - images["live eager"]).abs().max().item()
            for name, img in images.items()}
    print(f"[{card}] one batch of 16 at cond_scale 1.0 (DDIM-150 + decode), "
          f"seconds in turns: " + "; ".join(
              f"{name} {', '.join(f'{v:.4f}' for v in vals)}"
              for name, vals in times.items())
          + f"; max|image - live eager| {errs} (max|image| {size:.3e})")
    if any(e > 1e-5 * size for e in errs.values()):
        fail(f"the served and live samplers disagree: {errs}")
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


def stop_process(proc) -> None:
    """Terminate a subprocess this script started (kill it after 60 s)."""
    if proc is None or proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def serve_over_http(proc, card: str, seed: int) -> list:
    """The `serve_http --port 0` subprocess `proc` of 5f's cond_scale 1.0
    artifact: /healthz warm, two POSTs of 2 images (two decodable 256 x 256
    JPEGs each), user_id 0 answered 400; then it is stopped. Returns the
    requests' seconds."""
    import base64
    import io

    from PIL import Image

    try:
        port = wait_for_port(proc, 300)
        base = f"http://127.0.0.1:{port}"
        status, health = http_json(f"{base}/healthz")
        if status != 200 or health.get("warm") is not True:
            fail(f"/healthz: {status} {health}")
        latencies = []
        for i in range(2):  # cut from 3 to pay for phase 6
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
        print(f"[{card}] serve_http: /healthz warm; 2 requests of 2 images "
              f"(a batch of 16 each) in {latencies} s (the daemon's own: "
              f"{reply['latency_s']:.4f} s for the last); user_id 0 -> 400")
        return latencies
    finally:
        stop_process(proc)


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
    - `serve_generate` of 1 user x 16 images from the cond_scale 1.0
      artifact (cut from 2 users to pay for phase 6's trainers): the JPG
      layout, finite images, 151 forwards per batch;
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
    from vqgan_tpu_torch import (
        diagnose_latent_range,
        export_serving,
        generate,
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

    artifacts, daemon = {}, None
    try:
        for cond_scale, phi in ((1.0, 0.0), (3.0, 0.7)):
            if cond_scale == 3.0:
                # serve_http starts up (imports, loads, captures) while the
                # cond_scale 3.0 artifact is exported; it is answered and
                # stopped before anything below is timed
                daemon = subprocess.Popen(
                    [sys.executable, "-u", "-m",
                     "vqgan_tpu_torch.serve_http", "--artifact",
                     str(artifacts[1.0]), "--port", "0"],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, cwd=ROOT)
            out = artifacts[cond_scale] = work / f"cfg_sampler_{cond_scale}"
            # the selftest generates one batch from the artifact and one
            # from the live pipeline
            result, secs = gated(
                f"export_serving cond_scale {cond_scale} --selftest",
                lambda: export_serving.main([
                    "--checkpoint", str(ldm_results), "--vae_path",
                    str(vae_pt), "--out", str(out), "--batch_size", "16",
                    "--cond_scale", str(cond_scale), "--rescaled_phi",
                    str(phi), "--selftest"]),
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
        metrics["http_latency_s"] = serve_over_http(daemon, card, seed)
    finally:
        stop_process(daemon)

    # the live pipeline of the timed step and of the samplers in turns,
    # loaded once
    config, weights = generate.load_checkpoint(ldm_results)
    diffusion, _ = generate.load_model(config, weights, "cuda")
    vae = generate.load_vae(vae_pt, config.latent_channels,
                            config.image_size, device="cuda")
    metrics["step_ms"] = time_served_step(torch, kernels, counts, card,
                                          diffusion, artifacts[1.0],
                                          unet_key[1.0])
    metrics["decode_repeat"] = decode_repeatability(
        torch, kernels, counts, card, vae_pt, vae_key)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the decoders' upsampling,
    try:                                       # as in the export selftest
        metrics["served_vs_live"] = served_vs_live(
            torch, kernels, counts, card, diffusion, vae, artifacts[1.0],
            per_batch(1.0, 4))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del diffusion, vae, weights

    result, secs = gated(
        "serve_generate 1 user x 16",
        lambda: serve_generate.main([
            "--artifact", str(artifacts[1.0]), "--output_dir",
            str(OUT / "served"), "--user_ids", "1", "--num_images",
            "16", "--seed", str(seed)]),
        per_batch(1.0, 1))
    check_images(result["images"], 16)
    rate = 16 / sum(result["batch_seconds"])
    metrics["serve_generate_samples_per_s"] = rate
    print(f"[{card}] serve_generate: {rate:.4f} samples/s at batch 16, "
          f"cond_scale 1.0 (phase 5's generate: "
          f"{generate_rates['cond_scale 1.0']:.4f}); whole call "
          f"{secs:.3f} s")

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


def drive_stage2_rest(torch, kernels, seed: int, work: Path, ldm: Path,
                      card: str):
    """Phase 5g, the rest of stage-2 latent diffusion at full width through
    its entry points, on phase 5b's split, latent cache, checkpoint and
    seeded KL-VAE (`ldm`):
    - DiT training, `train_latent_cfg --model_type dit` (LDMConfig
      defaults: dim 384, depth 8, 8 heads x 64, patch 2, bf16, batch 8): 11
      steps, then a resume from the latest milestone to step 16; finite
      losses, 8 launches of each flash kernel per step at [8, 256, 8, 64]
      bf16, the step restored;
    - DiT generation, `generate` from that checkpoint, 16 images at
      cond_scale 1.0 and 16 at 3.0: per batch 1200 forwards (150 steps x 8
      blocks) at [16 or 32, 256, 8, 64] bf16 and 1 decode;
    - DiT serving, `export_serving --selftest` of that checkpoint at
      cond_scale 1.0 (the gate of 5f), 1200 + 1 forwards per batch;
    - the Diffusers-style trainer, `train_stage1_diffusers
      --gradient_checkpointing` at its defaults but for the head dim of 32
      (batch 24, warm-up 500, EMA 0.9999, DDIM-100 grids; at head dim 64
      it refuses, as the JAX CLI does) with `--pretrained_vae_path`: 10
      steps with milestones at 5 and 10, then a resume from "latest" to
      step 12; per step 2 forwards (the recomputation) and 1 of each
      backward at [24, 16, 8, 32] bf16, per grid 100 forwards at [16, 16,
      8, 32] and 1 decode; every grid written;
    - the peak of allocated device memory, and latents/s after a warm-up
      of 5, over 12 steps at batch 24 with and without gradient
      checkpointing (no VAE, so no grid);
    - the trainer's latent loader alone at batch 24, latents/s;
    - one ancestral batch (sampling_timesteps = timesteps = 1000) of 16
      from 5b's checkpoint: 1000 forwards at [16, 16, 8, 64] and 1 decode,
      finite images.
    Returns ({(kernel, shape): launches}, {metric: value})."""
    from vqgan_tpu_torch import (
        export_serving,
        generate,
        train_latent_cfg,
        train_stage1_diffusers,
    )
    from vqgan_tpu_torch.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    counts, metrics = {}, {}
    split, cache = ldm / "data_split.json", ldm / "latents_cache"
    vae_pt = ldm / "kl_vae.pt"
    vae_key = (16, 1024, 1, 512, "float32")
    dit_train = (8, 256, 8, 64, "bfloat16")
    dit_gen = {1.0: (16, 256, 8, 64, "bfloat16"),
               3.0: (32, 256, 8, 64, "bfloat16")}
    unet_b24 = (24, 16, 8, 32, "bfloat16")
    unet_grid = (16, 16, 8, 32, "bfloat16")

    def gated(label, fn, expected):
        return run_gated(torch, kernels, label, fn, expected, counts)

    # --- DiT training, with a resume -----------------------------------
    dit_results = work / "dit"
    common = ["--model_type", "dit", "--split", str(split),
              "--latents_cache_folder", str(cache), "--data_path",
              str(work / "images"), "--results_folder", str(dit_results),
              "--seed", str(seed)]
    runs = {}
    for label, extra, n in (("first", ["--train_num_steps", "11"], 11),
                            ("resumed", ["--train_num_steps", "16",
                                         "--resume", "-1"], 5)):
        result, secs = gated(
            f"train_latent_cfg --model_type dit ({label})",
            lambda extra=extra: train_latent_cfg.main([*common, *extra]),
            {(name, dit_train): 8 * n for name in FLASH})
        trainer = result.pop("trainer")
        runs[label] = result
        if type(trainer.model).__name__ != "DiT" or trainer.state.step != (
                11 if label == "first" else 16):
            fail(f"DiT training ({label}): a {type(trainer.model).__name__} "
                 f"at step {trainer.state.step}")
        del trainer
    losses = runs["first"]["losses"] + runs["resumed"]["losses"]
    if len(losses) != 16 or not all(np.isfinite(losses)):
        fail(f"DiT training: expected 16 finite losses, got {losses}")
    ckpt = CheckpointManager(dit_results, prefix="model")
    if ckpt.restore()["step"] != 16:
        fail(f"DiT checkpoint {ckpt.all_milestones()} does not load back")
    metrics["dit_latents_per_s"] = runs["first"]["latents_per_s"]
    print(f"[{card}] DiT training: {runs['first']['timed_steps']} steps "
          f"after a warm-up of 5 in {runs['first']['timed_seconds']:.3f} s "
          f"= {metrics['dit_latents_per_s']:.4f} latents/s at batch 8; "
          f"losses {losses}")

    # --- DiT generation and serving ------------------------------------
    for cond_scale in (1.0, 3.0):
        out = OUT / f"dit_generated_{cond_scale}"
        result, secs = gated(
            f"generate DiT cond_scale {cond_scale}",
            lambda out=out, cond_scale=cond_scale: generate.main([
                "--checkpoint", str(dit_results), "--vae_weights",
                str(vae_pt), "--num_images", "16", "--batch_size", "16",
                "--user_ids", "1", "--cond_scale", str(cond_scale),
                "--rescaled_phi", "0.7", "--seed", str(seed),
                "--output_dir", str(out)]),
            {("flash_fwd", dit_gen[cond_scale]): 1200,
             ("flash_fwd", vae_key): 1})
        check_images(result["images"], 16)
        rate = metrics[f"dit_samples_per_s {cond_scale}"] = \
            16 / sum(result["batch_seconds"])
        print(f"[{card}] generate DiT cond_scale {cond_scale}: {rate:.4f} "
              f"samples/s (batch 16, DDIM-150, JPGs written)")
    result, secs = gated(
        "export_serving DiT cond_scale 1.0 --selftest",
        lambda: export_serving.main([
            "--checkpoint", str(dit_results), "--vae_path", str(vae_pt),
            "--out", str(work / "dit_artifact"), "--batch_size", "16",
            "--cond_scale", "1.0", "--selftest"]),
        {("flash_fwd", dit_gen[1.0]): 2400, ("flash_fwd", vae_key): 2})
    programs = result["meta"]["programs"]
    metrics["dit_export"] = {
        "programs": programs,
        "selftest_max_abs_diff": result["selftest"]["max_abs_diff"]}
    print(f"[{card}] export_serving DiT: "
          + ", ".join(f"{k}.pt2 {v['bytes']} bytes in {v['seconds']:.3f} s"
                      for k, v in programs.items())
          + f"; selftest max|artifact - live| "
            f"{result['selftest']['max_abs_diff']:.3e}")

    # --- the Diffusers-style trainer -----------------------------------
    diffusers_out = work / "diffusers"
    common = ["--split", str(split), "--latents_cache_folder", str(cache),
              "--output_dir", str(diffusers_out), "--attention_head_dim",
              "32", "--gradient_checkpointing", "--pretrained_vae_path",
              str(vae_pt), "--checkpointing_steps", "5", "--seed", str(seed)]

    def remat_steps(n, grids):
        return {("flash_fwd", unet_b24): 2 * n,
                ("flash_bwd_dq", unet_b24): n,
                ("flash_bwd_dkv", unet_b24): n,
                ("flash_fwd", unet_grid): 100 * grids,
                ("flash_fwd", vae_key): grids}

    first, _ = gated("train_stage1_diffusers --gradient_checkpointing",
                     lambda: train_stage1_diffusers.main(
                         [*common, "--max_train_steps", "10"]),
                     remat_steps(10, 2))
    first.pop("trainer")
    second, _ = gated("train_stage1_diffusers --resume_from_checkpoint "
                      "latest",
                      lambda: train_stage1_diffusers.main(
                          [*common, "--max_train_steps", "12",
                           "--resume_from_checkpoint", "latest"]),
                      remat_steps(2, 1))
    trainer = second.pop("trainer")
    losses = first["losses"] + second["losses"]
    grids = [diffusers_out / f"sample-{m}.png" for m in (1, 2, 3)]
    ckpt = CheckpointManager(diffusers_out, prefix="model")
    if len(losses) != 12 or not all(np.isfinite(losses)) \
            or trainer.state.step != 12 or ckpt.restore()["step"] != 12 \
            or not all(g.exists() for g in grids):
        fail(f"train_stage1_diffusers: losses {losses}, step "
             f"{trainer.state.step}, milestones {ckpt.all_milestones()}, "
             f"grids {[g.exists() for g in grids]}")
    for g in grids:
        shutil.copy(g, OUT / f"diffusers_{g.name}")
    del trainer
    metrics["diffusers_latents_per_s"] = first["latents_per_s"]
    print(f"[{card}] train_stage1_diffusers --gradient_checkpointing: "
          f"{first['timed_steps']} steps after a warm-up of 5 in "
          f"{first['timed_seconds']:.3f} s (milestone saves and their "
          f"DDIM-100 grids excluded) = "
          f"{metrics['diffusers_latents_per_s']:.4f} latents/s at batch 24; "
          f"losses {losses}")

    peaks, rates = {}, {}
    for remat in (False, True):
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = work / f"diffusers_peak_{remat}"
        result, _ = gated(
            f"train_stage1_diffusers 12 steps, remat {remat}",
            lambda out=out, remat=remat: train_stage1_diffusers.main([
                "--split", str(split), "--latents_cache_folder", str(cache),
                "--output_dir", str(out), "--attention_head_dim", "32",
                "--max_train_steps", "12", "--seed", str(seed),
                *(["--gradient_checkpointing"] if remat else [])]),
            {("flash_fwd", unet_b24): 12 * (2 if remat else 1),
             ("flash_bwd_dq", unet_b24): 12,
             ("flash_bwd_dkv", unet_b24): 12})
        peaks[remat] = torch.cuda.max_memory_allocated() - before
        rates[remat] = result["latents_per_s"]
        del result["trainer"], result
    metrics["peak_bytes_b24"] = {"plain": peaks[False], "remat": peaks[True]}
    metrics["diffusers_latents_per_s_no_grids"] = {"plain": rates[False],
                                                   "remat": rates[True]}
    print(f"[{card}] train_stage1_diffusers at batch 24 without a VAE, 12 "
          f"steps: peak allocated memory above what was allocated before "
          f"{peaks[False]} B without, {peaks[True]} B with gradient "
          f"checkpointing ({peaks[True] / peaks[False]:.4f} of it); "
          f"{rates[False]:.4f} / {rates[True]:.4f} latents/s over the 7 "
          f"steps after a warm-up of 5")

    # the trainer's latent loader alone at batch 24 (the step waits on it
    # when it falls behind)
    from vqgan_tpu_torch.data import (
        BatchLoader,
        LatentCache,
        LatentDataset,
        load_split,
    )

    batches = iter(BatchLoader(
        LatentDataset("", load_split(split), LatentCache(cache),
                      images_per_user=50, seed=seed),
        24, shuffle=True, seed=seed, repeat=True))
    try:
        next(batches)
        t0 = time.perf_counter()
        for _ in range(20):
            next(batches)
        loader_rate = 20 * 24 / (time.perf_counter() - t0)
    finally:
        batches.close()
    metrics["latent_loader_per_s_b24"] = loader_rate
    print(f"the latent loader alone at batch 24: {loader_rate:.4f} latents/s "
          f"(20 batches after the first)")

    # --- one ancestral batch -------------------------------------------
    config, weights = generate.load_checkpoint(ldm / "results")
    config = dataclasses.replace(config, sampling_timesteps=config.timesteps)
    diffusion, _ = generate.load_model(config, weights, "cuda")
    vae = generate.load_vae(vae_pt, config.latent_channels, config.image_size,
                            device="cuda")

    def ancestral():
        latents = generate.generate_samples(
            diffusion, 0, 16, 1.0, 0.0,
            torch.Generator("cuda").manual_seed(seed))
        with torch.inference_mode():
            return vae.decode_latents(latents)

    images, secs = gated("ancestral sample, 1000 steps x 16",
                         ancestral,
                         {("flash_fwd", (16, 16, 8, 64, "bfloat16")): 1000,
                          ("flash_fwd", vae_key): 1})
    if tuple(images.shape) != (16, 256, 256, 3) \
            or not bool(torch.isfinite(images).all()):
        fail(f"ancestral sample: {tuple(images.shape)}, finite "
             f"{bool(torch.isfinite(images).all())}")
    metrics["ancestral_samples_per_s"] = 16 / secs
    print(f"[{card}] ancestral sampler: 16 samples in {secs:.3f} s = "
          f"{metrics['ancestral_samples_per_s']:.4f} samples/s (1000 U-Net "
          f"steps and the decode)")
    metrics["phase_seconds"] = time.perf_counter() - t_phase
    print(f"phase 5g: {metrics['phase_seconds']:.3f} s")
    return counts, metrics


def check_small_ddpm_and_karras(torch, kernels, seed: int):
    """Phase 4g, pixel-space diffusion on small inputs, card against CPU:
    - three training steps of a tiny fp32 DDPM U-Net (dim 16, mults 1-2,
      full attention on the inner stage, 16 px, batch 4) through the
      DDPM trainer's step, with self-conditioning and immiscible noise by
      the on-device auction, t, noise and the coin injected; held as 4b
      is held (`hold_card_to_cpu`). The EMA after 3 steps is the copy made
      at step 0. Each step launches 2 forwards (one of them the
      self-conditioning pass without a graph), 1 dQ and 1 dK/dV per
      full-attention block (3: down, mid, up): 6 / 3 / 3. The auction's
      permutation of each step's noise must be the same on both devices.
    - Heun-4 with a tiny KarrasUnet (dim 16 at 16 px, 3 classes, eval
      mode, the gains set past their zero initialisation), initial and
      step noise injected; the images within 1e-3 (phase 4's rule: cuDNN
      and the kernel sum in other orders). 8 forwards of 11 attention
      blocks each (2 at 8 px and 2 at 4 px in the encoder, 2 in the
      middle, 2 at 4 px and 3 at 8 px in the decoder): 88 launches."""
    import copy

    from vqgan_tpu_torch.diffusion import ElucidatedDiffusion, GaussianDiffusion
    from vqgan_tpu_torch.diffusion.gaussian import immiscible_permutation
    from vqgan_tpu_torch.models import KarrasUnet, Unet
    from vqgan_tpu_torch.training.ddpm_trainer import Trainer

    n_steps, b, lr = 3, 4, 8e-5
    torch.manual_seed(seed + 7)
    init = Unet(dim=16, dim_mults=(1, 2), full_attn=(False, True),
                self_condition=True)
    rng = np.random.default_rng(seed + 8)
    images = rng.random((n_steps, b, 16, 16, 3)).astype(np.float32)
    noise = rng.standard_normal((n_steps, b, 16, 16, 3)).astype(np.float32)
    ts = rng.integers(0, 1000, (n_steps, b))
    coins = (True, False, True)
    out, perms = {}, {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(init).to(dev)
        diffusion = GaussianDiffusion(
            model, image_size=16, timesteps=1000, sampling_timesteps=250,
            objective="pred_v", beta_schedule="sigmoid",
            ddim_sampling_eta=0.0, self_condition=True, immiscible=True,
            immiscible_method="auction", device=torch.device(dev))

        def inputs(i):
            return (torch.from_numpy(images[i]).to(dev),
                    dict(t=torch.from_numpy(ts[i]).to(dev), noise=noise[i],
                         self_cond_coin=coins[i]))

        x, kw = inputs(0)
        diffusion.loss(x, **kw).backward()
        grads = torch.cat([p.grad.flatten().cpu() for p in model.parameters()
                           if p.grad is not None])
        model.zero_grad(set_to_none=True)
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer(diffusion, model, train_batch_size=b,
                              train_lr=lr, results_folder=tmp)
            perms[dev] = []
            reset_counts(kernels)
            losses = []
            for i in range(n_steps):
                x, kw = inputs(i)
                perms[dev].append(immiscible_permutation(
                    diffusion.normalize(x).permute(0, 3, 1, 2),
                    torch.from_numpy(noise[i]).to(dev).permute(0, 3, 1, 2),
                    "auction").cpu().tolist())
                losses.append(float(trainer.train_step(x, **kw)))
            launches = {name: kernels[name].launches for name in FLASH}
        out[dev] = (grads, losses, _flat(torch, model),
                    _flat(torch, trainer.ema_model), launches)
    print(f"small DDPM training: the auction's permutations card "
          f"{perms['cuda']} cpu {perms['cpu']}")
    if perms["cuda"] != perms["cpu"]:
        fail("small DDPM training: the auction permuted the noise "
             "differently on the card")
    hold_card_to_cpu(torch, "small DDPM training, self-conditioned, "
                     "immiscible", init, out, n_steps, lr,
                     {"flash_fwd": 6, "flash_bwd_dq": 3, "flash_bwd_dkv": 3})

    torch.manual_seed(seed + 9)
    net = KarrasUnet(image_size=16, dim=16, dim_max=64, num_classes=3,
                     channels=3, num_downsamples=2, num_blocks_per_stage=1,
                     attn_res=(8, 4), attn_dim_head=16).eval()
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("gain"):
                p.fill_(0.5)
    init_noise = rng.standard_normal((b, 16, 16, 3)).astype(np.float32)
    step_noise = rng.standard_normal((4, b, 16, 16, 3)).astype(np.float32)
    sampled = {}
    for dev in ("cpu", "cuda"):
        m = net.to(dev)
        classes = torch.tensor([0, 1, 2, 0], device=dev)
        ed = ElucidatedDiffusion(
            lambda x, t, self_cond=None: m(x, t, class_labels=classes),
            image_size=16, num_sample_steps=4, device=torch.device(dev))
        reset_counts(kernels)
        sampled[dev] = ed.sample(batch_size=b, init_noise=init_noise,
                                 step_noise=step_noise).cpu()
        launches = {name: kernels[name].launches for name in FLASH}
    err = (sampled["cuda"] - sampled["cpu"]).abs().max().item()
    print(f"small EDM Heun-4 with a KarrasUnet, card vs CPU: max|image "
          f"diff|={err:.3e}; launches on the card {launches}")
    if not bool(torch.isfinite(sampled["cuda"]).all()) or err > 1e-3:
        fail("small EDM sampling on the card disagrees with the CPU")
    if launches != {"flash_fwd": 88, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
        fail(f"small EDM sampling: expected 88 forward launches, got "
             f"{launches}")


def drive_pixel_diffusion(torch, kernels, seed: int, work: Path, card: str,
                          jpeg: bool):
    """Phase 5h, pixel-space diffusion at full width through its entry
    points, on 31 x 8 seeded JPGs (128 px):
    - `train_ddpm` at the JAX CLI's defaults (128 px, dim 64, mults
      1-2-4-8, bf16, batch 16, T 1000, pred_v, sigmoid betas): 20 steps
      and one sample grid of 25 at DDIM-250. Full attention sits at
      16 x 16 in the down, mid and up blocks: per step 3 forward, 3 dQ and
      3 dK/dV launches at [16, 256, 4, 32] (Skv 260); per grid 750
      forwards (250 x 3) at [25, 256, 4, 32]. Finite losses, the grid and
      the checkpoint written; then the grid alone, timed.
    - the auction at batch 16 on the card (128 px images against noise),
      ms per call with its blocks of bids captured (the graphs kept
      across calls: the diffusion's, and `auction_assignment`'s default)
      and eager, against scipy's exact assignment's cost.
    - `train_ddpm --self_condition --immiscible --sampling_timesteps 50
      --calculate_fid --num_fid_samples 50 --save_best_and_latest_only`:
      10 steps with one milestone, then `--resume -1` to step 12; per
      step 6 / 3 / 3 launches; the milestone's grid 150 forwards at
      [25, ...], the FID's 50 samples in batches of 16, 16, 16 and 2
      (450 at [16, ...], 150 at [2, ...]); a finite FID >= 0, milestones
      0 ("best") and 1 ("latest").
    - `bench_edm` at its defaults (KarrasUnet dim 64, dim_max 256, 31
      classes, 64 px, bf16, batch 16): 8 attention blocks per forward at
      16 x 16 ([16, 256, 4, 64], Skv 260: 3 in the encoder, 2 in the
      middle, 3 in the decoder), 64 forwards per Heun-32 batch (512
      launches) and 32 per DPM++(2M) batch (256), 4 batches of each (one
      untimed): 3072; finite images in [0, 1].
    Returns ({(kernel, shape): launches}, {metric: value})."""
    from vqgan_tpu_torch import bench_edm, train_ddpm
    from vqgan_tpu_torch.checkpoint import CheckpointManager
    from vqgan_tpu_torch.diffusion.gaussian import immiscible_permutation
    from vqgan_tpu_torch.graphs import ChainGraphs
    from vqgan_tpu_torch.ops.assignment import auction_assignment
    from vqgan_tpu_torch.training.ddpm_trainer import FolderDataset

    t_phase = time.perf_counter()
    counts, metrics = {}, {}
    images = write_user_images(work / "images", seed, 31, 8, 128)
    train = (16, 256, 4, 32, "bfloat16")
    grid = (25, 256, 4, 32, "bfloat16")
    fid_tail = (2, 256, 4, 32, "bfloat16")
    karras = (16, 256, 4, 64, "bfloat16")

    def gated(label, fn, expected):
        return run_gated(torch, kernels, label, fn, expected, counts)

    def steps(n, forwards):
        return {("flash_fwd", train): forwards * n,
                ("flash_bwd_dq", train): 3 * n,
                ("flash_bwd_dkv", train): 3 * n}

    # --- DDPM training at the CLI's defaults ---------------------------
    res = work / "ddpm"
    common = ["--folder", str(images), "--seed", str(seed)]
    first, _ = gated(
        "train_ddpm (defaults, 20 steps, one DDIM-250 grid of 25)",
        lambda: train_ddpm.main([*common, "--results_folder", str(res),
                                 "--train_num_steps", "20",
                                 "--save_and_sample_every", "20"]),
        {**steps(20, 3), ("flash_fwd", grid): 750})
    trainer = first.pop("trainer")
    print(f"train_ddpm loader: {first['loader']} (with device prefetch; "
          f"libjpeg headers {jpeg})")
    if first["loader"] != expected_image_loader(jpeg):
        fail(f"train_ddpm read through {first['loader']}, expected "
             f"{expected_image_loader(jpeg)}")
    png = res / "sample-1.png"
    if len(first["losses"]) != 20 or not all(np.isfinite(first["losses"])) \
            or not png.exists() \
            or CheckpointManager(res, prefix="model").restore()["step"] != 20:
        fail(f"train_ddpm: losses {first['losses']}, grid {png.exists()}, "
             f"milestones {trainer.ckpt.all_milestones()}")
    from PIL import Image

    if np.asarray(Image.open(png)).shape != (640, 640, 3):
        fail(f"train_ddpm: the grid is {np.asarray(Image.open(png)).shape}")
    shutil.copy(png, OUT / "ddpm_sample-1.png")
    metrics["ddpm_images_per_s"] = first["images_per_s"]
    print(f"[{card}] train_ddpm: {first['timed_steps']} steps after a "
          f"warm-up of 5 in {first['timed_seconds']:.3f} s = "
          f"{first['images_per_s']:.4f} images/s at batch 16, 128 px; "
          f"losses {first['losses']}")
    samples, secs = gated(
        "DDIM-250 grid of 25 (the EMA U-Net)",
        lambda: trainer.ema_diffusion.sample(
            batch_size=25, generator=torch.Generator("cuda").manual_seed(seed)),
        {("flash_fwd", grid): 750})
    if tuple(samples.shape) != (25, 128, 128, 3) \
            or not bool(torch.isfinite(samples).all()):
        fail(f"DDIM-250 grid: {tuple(samples.shape)}")
    metrics["ddpm_grid_samples_per_s"] = 25 / secs
    print(f"[{card}] DDIM-250 grid of 25: {secs:.3f} s = "
          f"{metrics['ddpm_grid_samples_per_s']:.4f} samples/s")
    del trainer, samples

    # --- the auction at batch 16 ---------------------------------------
    ds = FolderDataset(images, 128)
    x = torch.from_numpy(np.stack([ds[i][0] for i in range(16)])).to(
        "cuda").permute(0, 3, 1, 2) * 2 - 1
    z = torch.randn(x.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(seed))
    graphs = ChainGraphs()  # the blocks of bids' graphs, kept across calls
    perm = immiscible_permutation(x, z, "auction", graphs)
    exact = immiscible_permutation(x, z, "host")
    dist = ((x.flatten(1)[:, None] - z.flatten(1)[None]) ** 2).sum(-1)
    rows = torch.arange(16, device="cuda")
    got, best = dist[rows, perm].sum().item(), dist[rows, exact].sum().item()
    bound = (dist.max() - dist.min()).item() / 2  # the auction's b * eps
    auction_ms = cuda_ms(
        torch, lambda: immiscible_permutation(x, z, "auction", graphs), 20)
    eager_ms = cuda_ms(
        torch, lambda: auction_assignment(dist, graph=False), 20)
    # the default call: its graphs kept in the module's ChainGraphs
    default_ms = cuda_ms(torch, lambda: auction_assignment(dist), 20)
    host_ms = cuda_ms(torch, lambda: immiscible_permutation(x, z, "host"), 20)
    metrics["auction_ms_b16"] = auction_ms
    metrics["auction_eager_ms_b16"] = eager_ms
    metrics["auction_default_ms_b16"] = default_ms
    metrics["host_assignment_ms_b16"] = host_ms
    print(f"[{card}] immiscible assignment at batch 16, 128 px: auction "
          f"{auction_ms:.4f} ms per call (its blocks of bids captured; "
          f"eager {eager_ms:.4f}; auction_assignment's default call "
          f"{default_ms:.4f}), scipy on the host {host_ms:.4f} "
          f"ms; cost {got:.1f} against the exact {best:.1f} (bound "
          f"+{bound:.1f}), permutations {'equal' if torch.equal(perm, exact) else 'differ'}; "
          f"{graphs.stats()}")
    if sorted(perm.tolist()) != list(range(16)) or got > best + bound:
        fail("the auction at batch 16 is no permutation, or costs more "
             "than its bound")

    # --- self-conditioned, immiscible, FID, best / latest, resume -------
    res = work / "ddpm_sc"
    common = [*common, "--results_folder", str(res), "--self_condition",
              "--immiscible", "--sampling_timesteps", "50",
              "--calculate_fid", "--num_fid_samples", "50",
              "--save_best_and_latest_only", "--save_and_sample_every", "10"]
    expected = steps(10, 6)
    expected[("flash_fwd", train)] += 3 * 50 * 3
    expected[("flash_fwd", grid)] = 150
    expected[("flash_fwd", fid_tail)] = 150
    second, secs = gated(
        "train_ddpm --self_condition --immiscible --calculate_fid "
        "--save_best_and_latest_only (10 steps, one milestone)",
        lambda: train_ddpm.main([*common, "--train_num_steps", "10"]),
        expected)
    trainer = second.pop("trainer")
    fid = trainer.last_fid
    tags = {m: json.loads((res / f"model-{m}.config.json").read_text())
            for m in trainer.ckpt.all_milestones()}
    if fid is None or not np.isfinite(fid) or fid < 0 \
            or sorted(tags) != [0, 1] or tags[0]["tag"] != "best" \
            or tags[1]["tag"] != "latest" \
            or not all(np.isfinite(second["losses"])):
        fail(f"train_ddpm with FID: FID {fid}, checkpoints {tags}, losses "
             f"{second['losses']}")
    metrics["ddpm_sc_fid"] = fid
    metrics["ddpm_sc_images_per_s"] = second["images_per_s"]
    del trainer
    third, _ = gated("train_ddpm --resume -1 (to step 12)",
                     lambda: train_ddpm.main([*common, "--train_num_steps",
                                              "12", "--resume", "-1"]),
                     steps(2, 6))
    trainer = third.pop("trainer")
    if trainer.state.step != 12 or len(third["losses"]) != 2 \
            or not all(np.isfinite(third["losses"])):
        fail(f"train_ddpm --resume: step {trainer.state.step}, losses "
             f"{third['losses']}")
    del trainer
    print(f"[{card}] train_ddpm self-conditioned, immiscible: "
          f"{second['images_per_s']:.4f} images/s after a warm-up of 5; "
          f"FID of 50 DDIM-50 samples {fid:.4f} (random-init Inception); "
          f"losses {second['losses'] + third['losses']}")

    # --- EDM sampling ---------------------------------------------------
    edm, _ = gated("bench_edm (defaults)", lambda: bench_edm.main([]),
                   {("flash_fwd", karras): 4 * 64 * 8 + 4 * 32 * 8})
    for name in ("heun", "dpmpp"):
        imgs = edm[name]["images"]
        if tuple(imgs.shape) != (16, 64, 64, 3) \
                or not bool(torch.isfinite(imgs).all()) \
                or imgs.min() < 0 or imgs.max() > 1:
            fail(f"bench_edm {name}: {tuple(imgs.shape)}")
        metrics[f"edm_{name}_samples_per_s"] = edm[name]["samples_per_s"]
    print(f"[{card}] bench_edm: Heun-32 "
          f"{metrics['edm_heun_samples_per_s']:.4f}, DPM++(2M) "
          f"{metrics['edm_dpmpp_samples_per_s']:.4f} samples/s at batch 16, "
          f"64 px (first batches {edm['heun']['first_s']:.3f} / "
          f"{edm['dpmpp']['first_s']:.3f} s)")
    metrics["phase_seconds"] = time.perf_counter() - t_phase
    print(f"phase 5h: {metrics['phase_seconds']:.3f} s")
    return counts, metrics


def python_sync_batches(trainer):
    """The LDM trainer's input before the native reader: the Python
    BatchLoader and a synchronous pageable copy per batch (the A/B's other
    arm), as `LatentDiffusionTrainer._prefetched` returns its batches."""
    import torch

    def batches():
        it = iter(trainer.loader)
        try:
            for latents, labels in it:
                yield (latents, labels), (
                    torch.from_numpy(latents).to(trainer.device),
                    torch.from_numpy(labels).to(trainer.device, torch.long))
        finally:
            it.close()

    return batches(), "python_sync_copy"


def drive_input_pipeline(torch, kernels, seed: int, vqgan: Path, ldm: Path,
                         kl_ckpt: Path, kl_images: Path, card: str,
                         jpeg: bool):
    """Phase 5l, the input pipeline on the card's host, on the files 5c
    (31 x 8 JPEGs at 256 px) and 5b (the latent cache of 31 x 50 [32, 32,
    4] latents) wrote:
    - `bench_decode` over 5c's JPEGs at 256 -> 256 and 256 -> 128, 8
      threads: PIL and (with libjpeg's headers) native images/s;
    - `bench_input_pipeline` over the same folder at 128 px, batch 8, at
      --step_ms 0 and 20: batches/s of the PIL BatchLoader, and with
      libjpeg the BatchLoader over native get_batch and the async ring;
    - the latent loader alone at batch 24: `native_batch_loader` against
      the BatchLoader, latents/s over 20 batches after the first;
    - gates: every device batch that `device_prefetch` (`to_device`: a
      pinned copy, non_blocking) hands over equals its host batch bit for
      bit, for 5b's latents and 5c's images; with libjpeg, the native
      decode of a batch equals the ring's batch of the same indices bit
      for bit, and two rings of one seed give the same batches and
      indices;
    - `debug_ldm_pipeline` on 5d's KL-VAE milestone and its images at
      256 px: every check printed with a finite value; 1 forward launch
      at [1, 1024, 1, 512] fp32 (the random-latent decode) and 4 at [8,
      1024, 1, 512] (encode, decode, the invariance check's two decodes);
      healthy or not (a 20-step KL-VAE may reconstruct poorly) reported;
    - one A/B in turns (python, native; the pass back cut for phase 6): the
      Diffusers-style trainer of 5g (batch 24, head dim 32, no VAE, 20
      steps, 1 launch of each flash kernel per step at [24, 16, 8, 32])
      with the BatchLoader and a synchronous copy against the native
      latent reader with prefetch; latents/s of each run after a warm-up
      of 5.
    Returns ({(kernel, shape): launches}, {metric: value})."""
    from vqgan_tpu_torch import (
        bench_decode,
        bench_input_pipeline,
        debug_ldm_pipeline,
        train_stage1_diffusers,
    )
    from vqgan_tpu_torch.data import (
        BatchLoader,
        ImageFolderDataset,
        LatentCache,
        LatentDataset,
        load_split,
    )
    from vqgan_tpu_torch.data.native_image import (
        NativePipeline,
        decode_jpeg_batch,
    )
    from vqgan_tpu_torch.data.prefetch import device_prefetch, to_device
    from vqgan_tpu_torch.training import ldm_trainer

    t_phase = time.perf_counter()
    counts, metrics = {}, {}
    images, image_split = vqgan / "images", load_split(
        vqgan / "data_split.json")
    paths = sorted(str(p) for p in images.rglob("*.jpg"))
    split, cache = ldm / "data_split.json", ldm / "latents_cache"

    # --- decode rates ---------------------------------------------------
    for size in (256, 128):
        result = bench_decode.main(["--paths", *paths, "--size", str(size),
                                    "--threads", "8", "--iters", "2"])
        metrics[f"decode_{size}"] = result
        print(f"[{card}] bench_decode {len(paths)} JPEGs 256 -> {size} px, "
              f"8 threads: PIL {result['pil_img_per_s']:.4f} images/s, "
              f"native {result['native_img_per_s']} images/s")
        if jpeg and not result["native_img_per_s"]:
            fail("bench_decode: the native decoder did not run")

    # --- loaders --------------------------------------------------------
    for step_ms in (0, 20):
        rates = bench_input_pipeline.main(
            ["--decode_size", "128", "--batch", "8", "--n_batches", "20",
             "--step_ms", str(step_ms)], data_path=images,
            split=image_split)
        metrics[f"pipeline_step_{step_ms}ms"] = rates
        print(f"[{card}] bench_input_pipeline 128 px batch 8, step "
              f"{step_ms} ms: batches/s {json.dumps(rates)}")
        if jpeg and len(rates) != 3:
            fail(f"bench_input_pipeline: native loaders missing: {rates}")

    latent_ds = LatentDataset("", load_split(split), LatentCache(cache),
                              images_per_user=50, seed=seed)
    for name, it in (("native_batch_loader", latent_ds.native_batch_loader(
                         24, seed=seed, repeat=True)),
                     ("BatchLoader", iter(BatchLoader(
                         latent_ds, 24, shuffle=True, seed=seed,
                         repeat=True)))):
        try:
            next(it)
            t0 = time.perf_counter()
            for _ in range(20):
                next(it)
            metrics[f"latents_per_s_b24_{name}"] = 20 * 24 / (
                time.perf_counter() - t0)
        finally:
            it.close()
        print(f"[{card}] the latent loader alone at batch 24, {name}: "
              f"{metrics[f'latents_per_s_b24_{name}']:.4f} latents/s (20 "
              f"batches after the first)")

    # --- gates ----------------------------------------------------------
    device = torch.device("cuda")
    sources = [("latents", latent_ds.native_batch_loader(24, seed=seed,
                                                         repeat=True), 8),
               ("images", iter(BatchLoader(
                   ImageFolderDataset(images, image_split, "train",
                                      image_size=256), 8, seed=seed,
                   repeat=True)), 4)]
    for name, it, n in sources:
        pre = device_prefetch(it, lambda b: to_device(b[0], device), depth=2)
        try:
            for _ in range(n):
                (host, _), dev = next(pre)
                torch.cuda.synchronize()
                if not torch.equal(dev.cpu(), torch.from_numpy(host)):
                    fail(f"device_prefetch ({name}): a device batch differs "
                         f"from its host batch")
        finally:
            pre.close()
    print(f"device_prefetch: {sources[0][2]} latent and {sources[1][2]} "
          f"image batches on the card equal their host batches bit for bit")
    if jpeg:
        def stream():
            with NativePipeline(paths, 256, 8, seed=seed) as pipe:
                return [pipe.next(return_indices=True) for _ in range(4)]

        first, again = stream(), stream()
        for (a, ia), (b, ib) in zip(first, again):
            if not (np.array_equal(a, b) and np.array_equal(ia, ib)):
                fail("two rings of one seed gave different batches")
            if not np.array_equal(a, decode_jpeg_batch(
                    [paths[i] for i in ia], 256)):
                fail("the ring's batch differs from the decode of its "
                     "indices")
        print("native ring: batches and indices repeat across two rings of "
              "one seed and equal the batch decode bit for bit")
    else:
        print("native decoder gates not run: g++ finds no jpeglib.h on this "
              "host (the probe); the image trainers read with PIL")

    # --- debug_ldm_pipeline on 5d's KL-VAE -------------------------------
    kl_key = (8, 1024, 1, 512, "float32")
    healthy, secs = run_gated(
        torch, kernels, "debug_ldm_pipeline (5d's KL-VAE, 256 px)",
        lambda: debug_ldm_pipeline.main(["--vae_path", str(kl_ckpt),
                                         "--data_path", str(kl_images)]),
        {("flash_fwd", (1, 1024, 1, 512, "float32")): 1,
         ("flash_fwd", kl_key): 4}, counts)
    metrics["debug_ldm_pipeline_healthy"] = healthy
    print(f"[{card}] debug_ldm_pipeline: {secs:.3f} s, healthy {healthy} "
          f"(the KL-VAE trained 20 steps)")

    # --- the A/B in turns -----------------------------------------------
    key = (24, 16, 8, 32, "bfloat16")
    patched = ldm_trainer.LatentDiffusionTrainer._prefetched
    turns = {"python_sync_copy": [], "native_latents": []}
    # one pair: the pass back was cut to pay for phase 6
    for arm in ("python_sync_copy", "native_latents"):
        if arm == "python_sync_copy":
            ldm_trainer.LatentDiffusionTrainer._prefetched = \
                python_sync_batches
        try:
            result, _ = run_gated(
                torch, kernels, f"train_stage1_diffusers 20 steps, {arm}",
                lambda: train_stage1_diffusers.main([
                    "--split", str(split), "--latents_cache_folder",
                    str(cache), "--output_dir",
                    str(ldm.parent / "input_ab" / str(len(turns[arm]))
                        / arm), "--attention_head_dim", "32",
                    "--max_train_steps", "20", "--seed", str(seed)]),
                {(name, key): 20 for name in FLASH}, counts)
        finally:
            ldm_trainer.LatentDiffusionTrainer._prefetched = patched
        del result["trainer"]
        if result["loader"] != arm or not all(np.isfinite(result["losses"])):
            fail(f"A/B {arm}: loader {result['loader']}, losses "
                 f"{result['losses']}")
        turns[arm].append(result["latents_per_s"])
    metrics["diffusers_ab_latents_per_s"] = turns
    print(f"[{card}] A/B in turns (python, native), "
          f"train_stage1_diffusers batch 24, 15 steps after a warm-up of "
          f"5: "
          f"latents/s {json.dumps(turns)}")
    metrics["phase_seconds"] = time.perf_counter() - t_phase
    print(f"phase 5l: {metrics['phase_seconds']:.3f} s")
    return counts, metrics


def card_vs_cpu_trainer(torch, kernels, label, init, make_diffusion,
                        batches, per_step, lr: float = 8e-5):
    """Three steps of the DDPM `Trainer` over `make_diffusion(model,
    device)` on the card and on the CPU from the weights of `init`, each
    step's (images, loss kwargs) from `batches` (numpy, the draws
    injected), held as 4b is held (`hold_card_to_cpu`, `per_step` flash
    launches per step)."""
    import copy

    from vqgan_tpu_torch.training.ddpm_trainer import Trainer

    out = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(init).to(dev)
        diffusion = make_diffusion(model, torch.device(dev))
        x, kw = batches[0]
        diffusion.loss(torch.from_numpy(x).to(dev), **kw).backward()
        grads = torch.cat([p.grad.flatten().cpu() for p in model.parameters()
                           if p.grad is not None])
        model.zero_grad(set_to_none=True)
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer(diffusion, model, train_batch_size=len(x),
                              train_lr=lr, results_folder=tmp)
            reset_counts(kernels)
            losses = [float(trainer.train_step(
                torch.from_numpy(x).to(dev), **kw)) for x, kw in batches]
            launches = {name: kernels[name].launches for name in FLASH}
        out[dev] = (grads, losses, _flat(torch, model),
                    _flat(torch, trainer.ema_model), launches)
    hold_card_to_cpu(torch, label, init, out, len(batches), lr, per_step)


def check_small_diffusion_library(torch, kernels, seed: int):
    """Phase 4h, the rest of the diffusion library on small inputs, card
    against CPU, each held as 4b is held (`card_vs_cpu_trainer`), the
    draws injected:
    - three DDPM-trainer steps of a tiny learned-variance U-Net (dim 16,
      mults 1-2, full attention on the inner stage, 16 px, batch 4; t and
      noise): 3 forward, 3 dQ and 3 dK/dV launches per step (down, mid,
      up);
    - three of a tiny UViT (dim 16, mults 1-2, a ViT middle of depth 2, 2
      heads x 32 over 4 x 4 tokens) under `SimpleDiffusion` (times and
      noise): 2 / 2 / 2 per step;
    - three of a tiny Unet1D (dim 16, mults 1-2, 4 channels, L = 32)
      under `GaussianDiffusion1D` (pred_v; t and noise): 1 / 1 / 1;
    - one forward and backward of a tiny KarrasUnet3D with factorised
      attention (dim 16, dim_max 32, 4 x 8 x 8 x 2, attention at 4 px: 2
      encoder, 2 middle and 2 decoder blocks, a space and a time pass
      each), the gains set past their zero initialisation: output within
      1e-4 and gradients within 1e-3 of the largest CPU value (4b's rule),
      12 launches of each flash kernel."""
    from vqgan_tpu_torch.diffusion import (
        GaussianDiffusion1D,
        LearnedVarianceGaussianDiffusion,
        SimpleDiffusion,
    )
    from vqgan_tpu_torch.models import KarrasUnet3D, Unet, Unet1D, UViT

    rng = np.random.default_rng(seed + 10)

    def batches(shape, **draws):
        return [(rng.random(shape).astype(np.float32),
                 {name: draw(shape) for name, draw in draws.items()})
                for _ in range(3)]

    def noise(shape):
        return rng.standard_normal(shape).astype(np.float32)

    def steps_t(shape):
        return rng.integers(0, 1000, shape[0])

    torch.manual_seed(seed + 11)
    card_vs_cpu_trainer(
        torch, kernels, "small learned-variance DDPM training",
        Unet(dim=16, dim_mults=(1, 2), full_attn=(False, True),
             learned_variance=True),
        lambda m, dev: LearnedVarianceGaussianDiffusion(
            m, image_size=16, timesteps=1000, device=dev),
        batches((4, 16, 16, 3), t=steps_t, noise=noise),
        {name: 3 for name in FLASH})
    torch.manual_seed(seed + 12)
    card_vs_cpu_trainer(
        torch, kernels, "small UViT simple-diffusion training",
        UViT(dim=16, dim_mults=(1, 2), vit_depth=2, attn_heads=2),
        lambda m, dev: SimpleDiffusion(m, image_size=16, device=dev),
        batches((4, 16, 16, 3), times=lambda shape: rng.random(
            shape[0]).astype(np.float32), noise=noise),
        {name: 2 for name in FLASH})
    torch.manual_seed(seed + 13)
    card_vs_cpu_trainer(
        torch, kernels, "small Unet1D training",
        Unet1D(dim=16, dim_mults=(1, 2), channels=4),
        lambda m, dev: GaussianDiffusion1D(
            m, image_size=32, seq_length=32, channels=4, timesteps=1000,
            objective="pred_v", device=dev),
        batches((4, 32, 4), t=steps_t, noise=noise),
        {name: 1 for name in FLASH})

    torch.manual_seed(seed + 14)
    net = KarrasUnet3D(spatial_size=(4, 8, 8), dim=16, dim_max=32,
                       channels=2, num_downsamples=1, num_blocks_per_stage=1,
                       attn_res=(4,), attn_dim_head=16,
                       factorize_space_time_attn=True)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("gain"):
                p.fill_(0.5)
    x = torch.from_numpy(noise((2, 2, 4, 8, 8)))
    t = torch.tensor([0.3, -0.9])
    got = {}
    for dev in ("cpu", "cuda"):
        net.to(dev).zero_grad(set_to_none=True)
        reset_counts(kernels)
        out = net(x.to(dev), t.to(dev))
        out.pow(2).mean().backward()
        launches = {name: kernels[name].launches for name in FLASH}
        got[dev] = (out.detach().cpu(), torch.cat(
            [p.grad.flatten().cpu() for p in net.parameters()]))
    out_err = (got["cuda"][0] - got["cpu"][0]).abs().max().item()
    out_size = got["cpu"][0].abs().max().item()
    grad_err = (got["cuda"][1] - got["cpu"][1]).abs().max().item()
    grad_size = got["cpu"][1].abs().max().item()
    print(f"small KarrasUnet3D, factorised, forward + backward, card vs "
          f"CPU: max|out diff|={out_err:.3e} (max|out| {out_size:.3e}), "
          f"max|grad diff|={grad_err:.3e} (max|grad| {grad_size:.3e}); "
          f"launches on the card {launches}")
    if out_err > 1e-4 * out_size or grad_err > 1e-3 * grad_size \
            or not bool(torch.isfinite(got["cuda"][1]).all()):
        fail("small KarrasUnet3D on the card disagrees with the CPU")
    if launches != {name: 12 for name in FLASH}:
        fail(f"small KarrasUnet3D: expected 12 launches of each flash "
             f"kernel, got {launches}")


def drive_diffusion_library(torch, kernels, seed: int, work: Path,
                            card: str):
    """Phase 5i, the rest of the diffusion library at full width through
    the DDPM `Trainer` and the samplers, random weights from a seed:
    (a) train_ddpm's U-Net (dim 64, mults 1-2-4-8, bf16, batch 16) on 31 x
        8 seeded 128 px JPGs, full attention at 16 x 16 (down, mid, up:
        3 launches of each flash kernel per step at [16, 256, 4, 32], Skv
        260), T cut from 1000 to 100 for the samplers that walk every t
        (to 50 for the ancestral batches; these and (b)'s and (c)'s
        sampling steps were halved to keep the smoke within its time):
        learned variance (pred_noise) and the weighted objective (out_dim
        2C + 2) 10 + 2 timed steps each at T 1000, then one ancestral batch
        of 16 from the EMA weights over a T 50 schedule (150 forwards);
        RePaint of a batch of 4 with the left half known
        (resampling at its defaults: 160 denoise ops, 480 forwards at
        [4, 256, 4, 32]; the known half equal to the image); classifier
        guidance by a seeded ResNet18 (31 classes, t ignored) over DDIM-50
        (150 forwards) and the ancestral sampler (300).
    (b) `SimpleDiffusion` (v) over the UViT (dim 64, mults 1-2-4-8, bf16;
        ViT depth 6, 4 heads x 32) on 31 x 8 JPGs at 256 px: 10 + 2 timed
        steps at batch 16 (6 / 6 / 6 per step at [16, 256, 4, 32], Skv
        256), then one grid of 16 with 50 of its 500 sampling steps (300
        forwards).
    (c) continuous time over (a)'s U-Net with learned sinusoidal time
        features: the learned log-SNR schedule (its MLP trained and
        averaged with the U-Net) and the v-parameterised variant, 10 + 2
        timed steps each, then a batch of 16 with 50 of 500 sampling
        steps (150 forwards).
    (d) the upstream README's 1-D example: Unet1D(dim 64, mults 1-2-4-8,
        32 channels), GaussianDiffusion1D(seq_length 128, T 1000, pred_v)
        on a seeded Dataset1D of 64 sequences: 10 + 2 timed steps at batch
        32 (1 / 1 / 1 at [32, 16, 4, 32] fp32), then DDIM-250 of 16 (250
        forwards at [16, 16, 4, 32]).
    (e) the Karras N-D U-Nets at their defaults (dim 192, dim_max 768, 4
        blocks a stage, attention at 16 and 8, bf16), the gains set past
        their zero initialisation, forward + backward at batch 2, one
        untimed and three timed: KarrasUnet1D at L = 64 (11 launches of
        each kernel at [2, 16, 12, 64], 12 at [2, 8, 12, 64] per pass);
        KarrasUnet3D at 16 x 32 x 32 x 4 with full attention (11 at [2,
        2048, 6, 64] and 11 at [2, 256, 12, 64]) and factorised (11 at
        each of [16, 256, 6, 64], [512, 8, 6, 64], [8, 64, 12, 64] and
        [128, 4, 12, 64]).
    Every loss and sample finite. Returns ({(kernel, shape): launches},
    {metric: value})."""
    from vqgan_tpu_torch.diffusion import (
        ContinuousTimeGaussianDiffusion,
        Dataset1D,
        GaussianDiffusion1D,
        GuidedGaussianDiffusion,
        LearnedLogSNR,
        LearnedScheduleDenoiser,
        LearnedVarianceGaussianDiffusion,
        RePaintDiffusion,
        SimpleDiffusion,
        VParamContinuousTimeGaussianDiffusion,
        WeightedObjectiveGaussianDiffusion,
        make_classifier_cond_fn,
    )
    from vqgan_tpu_torch.models import (
        KarrasUnet1D,
        KarrasUnet3D,
        Unet,
        Unet1D,
        UViT,
    )
    from vqgan_tpu_torch.models.resnet import ResNet18
    from vqgan_tpu_torch.training.ddpm_trainer import FolderDataset, Trainer

    t_phase = time.perf_counter()
    counts, metrics = {}, {}
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    ddpm = (16, 256, 4, 32, "bfloat16")
    repaint = (4, 256, 4, 32, "bfloat16")
    uvit = (16, 256, 4, 32, "bfloat16")
    seq_train = (32, 16, 4, 32, "float32")
    seq_gen = (16, 16, 4, 32, "float32")

    def gated(label, fn, expected, tag=None):
        return run_gated_tagged(torch, kernels, label, fn, expected, counts,
                                tag)

    def per_step(shapes, n):
        return {(name, shape): k * n for shape, k in shapes.items()
                for name in FLASH}

    def unet(**kw):
        return Unet(dim=64, dim_mults=(1, 2, 4, 8), channels=3, dtype=bf16,
                    **kw).to(dev)

    def train(label, diffusion, model, folder=None, dataset=None,
              batch=16, shapes=None, tag=None, unit="images"):
        """10 + 2 timed `Trainer` steps; returns the trainer."""
        trainer = Trainer(diffusion, model, folder, dataset=dataset,
                          train_batch_size=batch, train_num_steps=12,
                          num_samples=16, results_folder=work / label)
        log, _ = gated(f"{label}: 12 trainer steps",
                       lambda: trainer.train(timing_warmup=10),
                       per_step(shapes or {ddpm: 3}, 12), tag)
        if not all(np.isfinite(log["losses"])):
            fail(f"{label}: losses {log['losses']}")
        metrics[f"{label}_{unit}_per_s"] = log["images_per_s"]
        print(f"[{card}] {label}: {log['timed_steps']} steps after a warm-up "
              f"of 10 in {log['timed_seconds']:.4f} s = "
              f"{log['images_per_s']:.4f} {unit}/s at batch {batch}; losses "
              f"{log['losses']}")
        return trainer

    def sampled(key, label, fn, expected, n, shape, tag=None):
        out, secs = gated(label, fn, expected, tag)
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            fail(f"{label}: {tuple(out.shape)}, finite "
                 f"{bool(torch.isfinite(out).all())}")
        metrics[f"{key}_samples_per_s"] = n / secs
        print(f"[{card}] {label}: {secs:.4f} s = {n / secs:.4f} samples/s")
        return out

    def gen(s):
        return torch.Generator("cuda").manual_seed(seed + s)

    # --- (a) the DDPM U-Net: learned variance, weighted objective ------
    images = write_user_images(work / "images128", seed, 31, 8, 128)
    for label, cls, kw in (
            ("learned_variance", LearnedVarianceGaussianDiffusion,
             dict(learned_variance=True)),
            ("weighted_objective", WeightedObjectiveGaussianDiffusion,
             dict(out_dim=8))):
        torch.manual_seed(seed + 20)
        model = unet(**kw)
        diffusion = cls(model, image_size=128, device=dev)
        trainer = train(label, diffusion, model, folder=images)
        cut = dataclasses.replace(trainer.ema_diffusion, timesteps=50,
                                  sampling_timesteps=None, schedule=None)
        sampled(f"{label}_ancestral",
                f"{label} ancestral batch of 16 (T 50)",
                lambda: cut.sample(batch_size=16, generator=gen(1)),
                {("flash_fwd", ddpm): 150}, 16, (16, 128, 128, 3))
        del trainer, model, diffusion

    # --- (a) RePaint and classifier guidance ----------------------------
    torch.manual_seed(seed + 21)
    model = unet().eval()
    rp = RePaintDiffusion(model, image_size=128, timesteps=100,
                          objective="pred_v", device=dev)
    n_denoise = int((rp.schedule_ops()[:, 0] == 0).sum())
    ds = FolderDataset(images, 128)
    gt = torch.from_numpy(np.stack([ds[i][0] for i in range(4)])).to(dev)
    mask = torch.zeros(4, 128, 128, 1, device=dev)
    mask[:, :, :64] = 1.0
    out = sampled("repaint", f"RePaint of 4 ({n_denoise} denoise ops)",
                  lambda: rp.inpaint(gt, mask, generator=gen(2)),
                  {("flash_fwd", repaint): 3 * n_denoise}, 4,
                  (4, 128, 128, 3))
    known = (out[:, :, :64] - gt[:, :, :64]).abs().max().item()
    print(f"RePaint: max|known half - image| = {known:.3e}")
    if n_denoise != 160 or known > 1e-5:
        fail(f"RePaint: {n_denoise} denoise ops, known half off by {known}")
    gd = GuidedGaussianDiffusion(model, image_size=128, timesteps=100,
                                 sampling_timesteps=50, objective="pred_v",
                                 device=dev)
    torch.manual_seed(seed + 22)
    classifier = ResNet18(31).to(dev).eval()
    cond_fn = make_classifier_cond_fn(lambda x, t: classifier(x))
    y = {"y": torch.arange(16, device=dev) % 31}
    for key, label, fn, n_fwd in (
            ("guided_ddim", "guided DDIM-50 of 16", gd.ddim_sample_guided,
             150),
            ("guided_ancestral", "guided ancestral of 16 (T 100)",
             gd.p_sample_loop_guided, 300)):
        sampled(key, label, lambda: fn((16, 128, 128, 3), cond_fn, y,
                                       generator=gen(3)),
                {("flash_fwd", ddpm): n_fwd}, 16, (16, 128, 128, 3))
    del model, rp, gd, classifier

    # --- (b) simple diffusion over the UViT at 256 px --------------------
    images256 = write_user_images(work / "images256", seed, 31, 8, 256)
    torch.manual_seed(seed + 23)
    model = UViT(dim=64, dim_mults=(1, 2, 4, 8), dtype=bf16).to(dev)
    sd = SimpleDiffusion(model, image_size=256, pred_objective="v",
                         num_sample_steps=50, device=dev)
    trainer = train("uvit_simple", sd, model, folder=images256,
                    shapes={uvit: 6}, tag="uvit")
    grid = sampled("uvit_grid", "UViT grid of 16 (50 of 500 steps)",
                   lambda: trainer.sample_grid(1),
                   {("flash_fwd", uvit): 300}, 16, (16, 256, 256, 3),
                   tag="uvit")
    shutil.copy(trainer.results_folder / "sample-1.png",
                OUT / "uvit_sample-1.png")
    del trainer, model, sd, grid

    # --- (c) continuous time ---------------------------------------------
    torch.manual_seed(seed + 24)
    model = LearnedScheduleDenoiser(
        unet(learned_sinusoidal_cond=True),
        LearnedLogSNR(*ContinuousTimeGaussianDiffusion.learned_endpoints()
                      ).to(dev))
    for label, diffusion in (
            ("continuous_learned", ContinuousTimeGaussianDiffusion(
                model, image_size=128, noise_schedule="learned",
                num_sample_steps=50, device=dev)),
            ("continuous_v", VParamContinuousTimeGaussianDiffusion(
                model.net, image_size=128, num_sample_steps=50,
                device=dev))):
        trainer = train(label, diffusion, diffusion.model, folder=images)
        sampled(label, f"{label} batch of 16 (50 of 500 steps)",
                lambda: trainer.ema_diffusion.sample(16, generator=gen(4)),
                {("flash_fwd", ddpm): 150}, 16, (16, 128, 128, 3))
        del trainer
    del model

    # --- (d) the 1-D example -------------------------------------------
    torch.manual_seed(seed + 25)
    model = Unet1D(dim=64, dim_mults=(1, 2, 4, 8), channels=32).to(dev)
    d1 = GaussianDiffusion1D(model, image_size=128, seq_length=128,
                             channels=32, timesteps=1000,
                             sampling_timesteps=250, objective="pred_v",
                             device=dev)
    data = Dataset1D(np.random.default_rng(seed + 26).random(
        (64, 128, 32)).astype(np.float32))
    trainer = train("unet1d", d1, model, dataset=data, batch=32,
                    shapes={seq_train: 1}, unit="sequences")
    sampled("unet1d_ddim", "Unet1D DDIM-250 of 16",
            lambda: trainer.ema_diffusion.sample(16, generator=gen(5)),
            {("flash_fwd", seq_gen): 250}, 16, (16, 128, 32))
    del trainer, model, d1

    # --- (e) the Karras N-D U-Nets -----------------------------------------
    for label, cls, x_shape, kw, shapes in (
            ("karras_unet_1d", KarrasUnet1D, (2, 4, 64), {},
             {(2, 16, 12, 64, "bfloat16"): 11,
              (2, 8, 12, 64, "bfloat16"): 12}),
            ("karras_unet_3d", KarrasUnet3D, (2, 4, 16, 32, 32), {},
             {(2, 2048, 6, 64, "bfloat16"): 11,
              (2, 256, 12, 64, "bfloat16"): 11}),
            ("karras_unet_3d_factorized", KarrasUnet3D, (2, 4, 16, 32, 32),
             dict(factorize_space_time_attn=True),
             {(16, 256, 6, 64, "bfloat16"): 11,
              (512, 8, 6, 64, "bfloat16"): 11,
              (8, 64, 12, 64, "bfloat16"): 11,
              (128, 4, 12, 64, "bfloat16"): 11})):
        torch.manual_seed(seed + 27)
        net = cls(dtype=bf16, **kw).to(dev)
        with torch.no_grad():
            for name, p in net.named_parameters():
                if name.endswith("gain"):
                    p.fill_(0.5)
        x = torch.randn(x_shape, device=dev, generator=gen(6))
        t = torch.randn(2, device=dev, generator=gen(7))

        def step():
            net.zero_grad(set_to_none=True)
            out = net(x, t)
            out.float().pow(2).mean().backward()
            return out

        out, _ = gated(f"{label} forward + backward (warm-up)", step,
                       per_step(shapes, 1))
        _, secs = gated(f"{label} forward + backward x 3", lambda: [
            step() for _ in range(3)], per_step(shapes, 3))
        grads = torch.cat([p.grad.flatten() for p in net.parameters()])
        if not bool(torch.isfinite(out).all()) \
                or not bool(torch.isfinite(grads).all()) \
                or not grads.abs().max().item() > 0:
            fail(f"{label}: output or gradients not finite, or all zero")
        metrics[f"{label}_fwd_bwd_ms"] = secs / 3 * 1e3
        print(f"[{card}] {label} at batch 2, bf16: "
              f"{metrics[f'{label}_fwd_bwd_ms']:.4f} ms per forward + "
              f"backward")
        del net, out, grads
    metrics["phase_seconds"] = time.perf_counter() - t_phase
    print(f"phase 5i: {metrics['phase_seconds']:.3f} s")
    return counts, metrics


def drive_sampler_graphs(torch, kernels, seed: int, card: str):
    """Phase 5k, the captured samplers at full width, random weights from
    a seed, cudnn.deterministic pinned (as 4i); each path timed in turns
    (`SAMPLER_TURNS`: eager, then captured) after an untimed captured call
    (the capture) and an eager warm-up: for the ancestral sampler and
    `interpolate` an untimed 3-step `interpolate`, for the other paths
    their first eager call, timed apart (its cold rate is printed beside
    the warm one), every call's launches gated exactly; captured
    within 1e-5 of the largest eager value; samples/s of each, the
    graphs' capture seconds and pool bytes:
    - the ancestral sampler at LDMConfig's full width (T cut from 1000 to
      250 to pay for phase 6's 2-rank run; batch 16, cond_scale 1.0), then
      the fp32 decode: 250 + 1 forwards;
    - `interpolate` at that width from t = 125 (cut from T - 1): 125
      forwards;
    - `bench_edm`'s Heun-32 and DPM++(2M) at its defaults (512 and 256
      forwards at [16, 256, 4, 64]);
    - the library's samplers at 5i's widths (train_ddpm's U-Net at 128 px,
      bf16, batch 16; the UViT at 256 px; the 1-D example), steps cut:
      learned variance and the weighted objective ancestral at T 20, the
      guided ancestral (T 20) and DDIM-20 (T 100) with a seeded ResNet18,
      RePaint of 4 at T 20 (50 denoise ops), continuous time (learned
      log-SNR) and simple diffusion (UViT) at 20 steps, the 1-D DDIM-50;
    - `python -m vqgan_tpu_torch.bench_sampling` at its defaults (its
      first call untimed, 3 timed: 4 x (150 + 1) forwards, the decode in
      bf16), its JSON line printed.
    Returns ({(kernel, shape): launches}, {metric: value})."""
    import contextlib
    import io

    from vqgan_tpu_torch import bench_edm, bench_sampling
    from vqgan_tpu_torch.configs import LDMConfig
    from vqgan_tpu_torch.diffusion import (
        ContinuousTimeGaussianDiffusion,
        GaussianDiffusion1D,
        GuidedGaussianDiffusion,
        LearnedLogSNR,
        LearnedScheduleDenoiser,
        LearnedVarianceGaussianDiffusion,
        RePaintDiffusion,
        SimpleDiffusion,
        WeightedObjectiveGaussianDiffusion,
        make_classifier_cond_fn,
    )
    from vqgan_tpu_torch.generate import load_model, load_vae
    from vqgan_tpu_torch.models import Unet, Unet1D, UViT
    from vqgan_tpu_torch.models.resnet import ResNet18

    t_phase = time.perf_counter()
    counts, metrics = {}, {}
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    unet16 = (16, 16, 8, 64, "bfloat16")
    vae16 = (16, 1024, 1, 512, "float32")
    ddpm = (16, 256, 4, 32, "bfloat16")

    def gated(label, fn, expected, tag=None):
        return run_gated_tagged(torch, kernels, label, fn, expected, counts,
                                tag)

    def turns(label, run, expected, n, graphs, tag=None, warm=None):
        """run(graph) -> the output; in turns after an untimed captured
        call (the capture) and an eager warm-up: `warm` ((fn, expected)),
        untimed, or else the first eager call, timed apart; records
        samples/s (the first eager call's too), capture seconds and pool
        bytes."""
        gated(f"{label}, captured (untimed)", lambda: run(True), expected,
              tag)
        first = None
        if warm is not None:
            gated(f"{label}, eager warm-up (untimed)", *warm, tag)
        else:
            _, first = gated(f"{label}, eager first call",
                             lambda: run(False), expected, tag)
        outs, secs = {}, {"eager": [], "captured": []}
        for name in SAMPLER_TURNS:
            out, sec = gated(f"{label}, {name}",
                             lambda: run(name == "captured"), expected, tag)
            outs.setdefault(name, out.float().cpu())
            secs[name].append(sec)
        eager, captured = outs["eager"], outs["captured"]
        err = (captured - eager).abs().max().item()
        size = eager.abs().max().item()
        stats = graphs.stats()
        rates = {k: n / (sum(v) / len(v)) for k, v in secs.items()}
        metrics[label] = {"eager_samples_per_s": rates["eager"],
                          "eager_first_call_samples_per_s": (
                              n / first if first else None),
                          "captured_samples_per_s": rates["captured"],
                          "capture_seconds": stats["capture_seconds"],
                          "pool_bytes": stats["pool_bytes"]}
        print(f"[{card}] {label}: seconds per batch in turns (eager, "
              f"captured) {secs['eager'][0]:.4f}, "
              f"{secs['captured'][0]:.4f}; samples/s eager "
              f"{rates['eager']:.4f} (first eager call "
              f"{'warmed' if first is None else f'{n / first:.4f}'}), "
              f"captured {rates['captured']:.4f}; "
              f"captured vs eager max|diff| {err:.3e} (max {size:.3e}); "
              f"{len(stats['graphs'])} graph(s), capture "
              f"{stats['capture_seconds']:.3f} s, pool "
              f"{stats['pool_bytes']} B")
        if not np.isfinite(captured.numpy()).all() or err > 1e-5 * size:
            fail(f"{label}: the captured sampler disagrees with the eager "
                 f"loop")

    def gen(s):
        return torch.Generator("cuda").manual_seed(seed + s)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # --- the LDM U-Net: ancestral (T 250) and interpolate --------------
        # T 250 (cut from 1000 to pay for phase 6's 2-rank run)
        cfg = LDMConfig(timesteps=250, sampling_timesteps=250)
        torch.manual_seed(seed + 40)
        diffusion, _ = load_model(cfg, device=dev)
        vae = load_vae(None, cfg.latent_channels, cfg.image_size, device=dev)
        classes = torch.arange(16, device=dev) % cfg.num_users

        def ancestral(graph):
            latents = diffusion.p_sample_loop(
                (16, 32, 32, 4), classes, cond_scale=1.0,
                rescaled_phi=cfg.rescaled_phi, generator=gen(41),
                graph=graph)
            with torch.inference_mode():
                return vae.decode_latents(latents)

        x1, x2 = torch.randn((2, 16, 32, 32, 4), device=dev,
                             generator=gen(42))

        def interpolate(t, graph):
            return diffusion.interpolate(x1, x2, classes, t=t, lam=0.5,
                                         generator=gen(43), graph=graph)

        # the eager warm-up of both: the same ancestral step, 3 times (the
        # captured call before it ran the step eagerly once, and the decode)
        warm = (lambda: interpolate(3, False), {("flash_fwd", unet16): 3})
        turns("ancestral_t250_decode", ancestral,
              {("flash_fwd", unet16): 250, ("flash_fwd", vae16): 1}, 16,
              diffusion._graphs, warm=warm)
        turns("interpolate_from_t125",
              lambda graph: interpolate(125, graph),
              {("flash_fwd", unet16): 125}, 16, diffusion._graphs, warm=warm)
        del diffusion, vae

        # --- EDM at bench_edm's defaults -----------------------------------
        _, ed = bench_edm.build(bench_edm.parse_args([]), dev)
        karras = (16, 256, 4, 64, "bfloat16")
        turns("edm_heun32", lambda graph: ed.sample(
            16, generator=gen(44), graph=graph),
            {("flash_fwd", karras): 512}, 16, ed._graphs)
        turns("edm_dpmpp32", lambda graph: ed.sample_using_dpmpp(
            16, generator=gen(45), graph=graph),
            {("flash_fwd", karras): 256}, 16, ed._graphs)
        del ed

        # --- the library at 5i's widths ------------------------------------
        def unet(**kw):
            return Unet(dim=64, dim_mults=(1, 2, 4, 8), channels=3,
                        dtype=bf16, **kw).to(dev).eval()

        img = (16, 128, 128, 3)
        torch.manual_seed(seed + 46)
        for label, d in (
                ("learned_variance_ancestral_t20",
                 LearnedVarianceGaussianDiffusion(
                     unet(learned_variance=True), image_size=128,
                     timesteps=20, device=dev)),
                ("weighted_objective_ancestral_t20",
                 WeightedObjectiveGaussianDiffusion(
                     unet(out_dim=8), image_size=128, timesteps=20,
                     device=dev))):
            turns(label, lambda graph, d=d: d.p_sample_loop(
                img, generator=gen(47), graph=graph),
                {("flash_fwd", ddpm): 60}, 16, d._graphs)
        model = unet()
        classifier = ResNet18(31).to(dev).eval()
        cond = (make_classifier_cond_fn(lambda x, t: classifier(x)),
                {"y": torch.arange(16, device=dev) % 31})
        for label, d, name, n_fwd in (
                ("guided_ancestral_t20", GuidedGaussianDiffusion(
                    model, image_size=128, timesteps=20, objective="pred_v",
                    device=dev), "p_sample_loop_guided", 20),
                ("guided_ddim20", GuidedGaussianDiffusion(
                    model, image_size=128, timesteps=100,
                    sampling_timesteps=20, objective="pred_v", device=dev),
                 "ddim_sample_guided", 20)):
            turns(label, lambda graph, d=d, name=name: getattr(d, name)(
                img, *cond, generator=gen(48), graph=graph),
                {("flash_fwd", ddpm): 3 * n_fwd}, 16, d._graphs)
        rp = RePaintDiffusion(model, image_size=128, timesteps=20,
                              objective="pred_v", device=dev)
        n_denoise = int((rp.schedule_ops()[:, 0] == 0).sum())
        gt = torch.rand((4, 128, 128, 3), device=dev, generator=gen(49))
        mask = torch.zeros(4, 128, 128, 1, device=dev)
        mask[:, :, :64] = 1.0
        turns(f"repaint_t20_{n_denoise}_denoise_ops",
              lambda graph: rp.inpaint(gt, mask, generator=gen(50),
                                       graph=graph),
              {("flash_fwd", (4, 256, 4, 32, "bfloat16")): 3 * n_denoise},
              4, rp._graphs)
        ct = ContinuousTimeGaussianDiffusion(
            LearnedScheduleDenoiser(
                unet(learned_sinusoidal_cond=True), LearnedLogSNR(
                    *ContinuousTimeGaussianDiffusion.learned_endpoints()
                ).to(dev)),
            image_size=128, noise_schedule="learned", num_sample_steps=20,
            device=dev)
        turns("continuous_learned_20_steps",
              lambda graph: ct.sample(16, generator=gen(51), graph=graph),
              {("flash_fwd", ddpm): 60}, 16, ct._graphs)
        del model, classifier, rp, ct
        sd = SimpleDiffusion(UViT(dim=64, dim_mults=(1, 2, 4, 8),
                                  dtype=bf16).to(dev).eval(),
                             image_size=256, pred_objective="v",
                             num_sample_steps=20, device=dev)
        turns("uvit_simple_20_steps",
              lambda graph: sd.sample(16, generator=gen(52), graph=graph),
              {("flash_fwd", ddpm): 120}, 16, sd._graphs, tag="uvit")
        del sd
        d1 = GaussianDiffusion1D(
            Unet1D(dim=64, dim_mults=(1, 2, 4, 8), channels=32).to(
                dev).eval(), image_size=128, seq_length=128, channels=32,
            timesteps=1000, sampling_timesteps=50, objective="pred_v",
            device=dev)
        turns("unet1d_ddim50", lambda graph: d1.sample(
            16, generator=gen(53), graph=graph),
            {("flash_fwd", (16, 16, 4, 32, "float32")): 50}, 16, d1._graphs)
        del d1
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # --- bench_sampling at its defaults ------------------------------------
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        bench, _ = gated("bench_sampling (defaults)",
                         lambda: bench_sampling.main([]),
                         {("flash_fwd", unet16): 4 * 150,
                          ("flash_fwd", (16, 1024, 1, 512, "bfloat16")): 4})
    lines = stdout.getvalue().strip().splitlines()
    print("\n".join(lines))
    line = json.loads([x for x in lines if x.startswith("{")][-1])
    if set(line) != {"metric", "value", "unit", "vs_baseline"} \
            or not line["value"] > 0 \
            or not bool(torch.isfinite(bench["images"]).all()) \
            or tuple(bench["images"].shape) != (16, 256, 256, 3):
        fail(f"bench_sampling: {line}, {tuple(bench['images'].shape)}")
    metrics["bench_sampling_samples_per_s"] = bench["samples_per_s"]
    metrics["bench_sampling_first_s"] = bench["first_s"]
    metrics["phase_seconds"] = time.perf_counter() - t_phase
    print(f"phase 5k: {metrics['phase_seconds']:.3f} s")
    return counts, metrics


# phase 5k's timed calls of each sampler, after its untimed capture and
# its eager warm-up (one of each: the repeats of (eager, captured,
# captured, eager) went to pay for phase 6)
SAMPLER_TURNS = ("eager", "captured")

# phase 6's ring shapes: (label, whole [B, S, H, D], shards, dtype)
RING_CASES = (("ring_4096_bf16", (2, 4096, 8, 64), 4, "bfloat16"),
              ("ring_1024_fp32", (2, 1024, 2, 64), 8, "float32"))
# phase 6: bf16 ring output and gradients at most this many times as far
# from fp64 as the whole-sequence flash attention's (each K/V block's
# dK/dV partial is rounded to bf16 before the fp32 sum)
_RING_BF16_FACTOR = 2.0
_SCALE_OUT_STEPS = 6
# phase 6's full-width run on 2 gloo ranks sharing the card: steps per
# mode, and fsdp's resident bytes at a step's start as a share of
# replicated's (parameters, Adam moments and EMA in halves: ~0.5)
_GLOO2_STEPS = 2  # cut from 3 to pay for the TP serving check
_GLOO2_RESIDENT_SHARE = 0.55
# the tests' norm rule (tests/dp_check.py): the weights' moves from the
# start within this share of the reference's moves, in norm
_MOVE_NORM = 0.05
# phase 6's tensor-parallel serving artifacts (batch 16, every TP kernel
# split): the 2-rank check runs the first _TP_CHAIN (t, t_next) pairs of
# the checkpoint's DDIM chain; its images and the world-1 run's are held
# to the artifact of whole weights by the tests' rule
# (tests/test_torch_port_tp_serving.py: the JAX CLI's selftest rule);
# _TP_TURNS timed calls of each artifact at world 1
_TP_CHAIN = 5
_TP_RTOL, _TP_ATOL = 1e-4, 1e-5
_TP_TURNS = 2


def ring_ref(torch, q, k, v, do, dtype):
    """(out, [dq, dk, dv]) with autograd: `sdpa_reference` on inputs cast
    to `dtype`, or with float64 softmax attention in float64 throughout
    (`sdpa_reference` computes in fp32)."""
    from vqgan_tpu_torch.ops.attention import sdpa_reference

    ins = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
    if dtype == torch.float64:
        scale = 1.0 / np.sqrt(q.shape[-1])
        p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", ins[0], ins[1])
                          * scale, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, ins[2])
    else:
        out = sdpa_reference(*ins)
    out.backward(do.to(dtype))
    return out.detach(), [t.grad for t in ins]


def ring_run(torch, q, k, v, do, n):
    """(out, [dq, dk, dv]) of `ring_attention_shards` over n blocks."""
    from vqgan_tpu_torch.ops.ring_attention import ring_attention_shards

    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = ring_attention_shards(*ins, n)
    out.backward(do)
    return out.detach(), [t.grad for t in ins]


def ring_rows(torch, peaks, label, shape, n, dt):
    """Phase 6's rows of kernels #1-#3 at one ring block's shape: device
    ms from a CUDA graph of the operator, the plain version's and SDPA's
    ms (its fused backward for #2-#3), the bound, the error against the
    plain version at that block."""
    import torch.nn.functional as F

    from vqgan_tpu_torch.kernels.ops import (
        flash_bwd_dkv_op,
        flash_bwd_dq_op,
        flash_fwd_op,
    )
    from vqgan_tpu_torch.ops.attention import (
        flash_bwd_dkv_reference,
        flash_bwd_dq_reference,
        flash_delta,
        flash_forward_reference,
    )

    b, s, h, d = shape
    blk = s // n
    dtype = getattr(torch, dt)
    g = torch.Generator("cuda").manual_seed(17)
    q, k, v, do = (torch.randn((b, blk, h, d), generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    out, lse = flash_fwd_op(q, k, v, scale)
    delta = flash_delta(out, do)
    ref_out, ref_lse = flash_forward_reference(q, k, v, scale)
    dq = flash_bwd_dq_op(q, k, v, do, lse, delta, scale)
    dk, dv = flash_bwd_dkv_op(q, k, v, do, lse, delta, scale)
    ref_dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, scale)
    ref_dk, ref_dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()

    def err(a, b_):
        return (a.float() - b_.float()).abs().max().item()

    errs = {"flash_fwd": max(err(out, ref_out), err(lse, ref_lse)),
            "flash_bwd_dq": err(dq, ref_dq),
            "flash_bwd_dkv": max(err(dk, ref_dk), err(dv, ref_dv))}
    iters = 50
    calls = {
        "flash_fwd": (lambda: flash_fwd_op(q, k, v, scale),
                      lambda: flash_forward_reference(q, k, v, scale)),
        "flash_bwd_dq": (
            lambda: flash_bwd_dq_op(q, k, v, do, lse, delta, scale),
            lambda: flash_bwd_dq_reference(q, k, v, do, lse, delta, scale)),
        "flash_bwd_dkv": (
            lambda: flash_bwd_dkv_op(q, k, v, do, lse, delta, scale),
            lambda: flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                            scale)),
    }
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_fwd = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, scale=scale), iters)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        side_out = F.scaled_dot_product_attention(*leaves, scale=scale)
    gt = do.transpose(1, 2)
    lib_bwd = device_ms(torch, lambda: torch.autograd.grad(
        side_out, leaves, gt, retain_graph=True), iters, stream=side)
    work = backward_work(b, blk, blk, h, d, q.element_size())
    work["flash_fwd"] = flash_fwd_work(b, blk, blk, h, d, q.element_size())
    rows = {}
    for name, (kernel, plain) in calls.items():
        ms = device_ms(torch, kernel, iters)
        plain_ms = cuda_ms(torch, plain, 10)
        bound_ms, bound_by = bound(peaks, *work[name], dt)
        replaces = {"flash_fwd": "vqgan_tpu/ops/attention.py:86",
                    "flash_bwd_dq": "vqgan_tpu/ops/attention.py:190",
                    "flash_bwd_dkv": "vqgan_tpu/ops/attention.py:221"}[name]
        rows[(name, label)] = {
            "name": name, "key": (b, blk, h, d, dt),
            "shape": f"[{b},{blk},{h},{d}] {dt} ({label}: {n} blocks of "
                     f"[{b},{s},{h},{d}])",
            "route": "cuda", "source": f"vqgan_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_fwd if name == "flash_fwd" else lib_bwd}
        print(f"{name} {label} block [{b},{blk},{h},{d}] {dt}: device "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library (SDPA"
              f"{' fused backward, dq+dk+dv' if name != 'flash_fwd' else ''})"
              f" device ms={rows[(name, label)]['library_ms']:.4f} "
              f"bound_ms={bound_ms:.6f} ({bound_by}) max|kernel-plain|="
              f"{errs[name]:.3e}; launches per ring call: {n * n}")
    return rows


# phase 6's data-parallel trainers: the per-rank batch of a world of 4 at
# full width, so that each rank's shapes reach the kernels on this card
_DP_STEPS = 8
_DP_VQGAN_KEY = (2, 1024, 1, 512, "bfloat16")
_DP_VQ_KEY = (2048, 128, 256, "fp32")
_DP_KL_KEY = (2, 1024, 1, 512, "float32")
_DP_DDPM_KEY = (4, 256, 4, 32, "bfloat16")
_LDM_KEY = (8, 16, 8, 64, "bfloat16")
# the scan runs on the group: blocks of 2, timed from step 6
_SCAN_STEPS = 8  # cut from 12 to pay for the TP serving check


def _dp_vqgan_counts(g_steps: int, grids: int) -> dict:
    """One VQ and two of each flash launch per G step, one VQ and two
    forwards per reconstruction grid, at a rank's shapes."""
    return {("vq_nearest", _DP_VQ_KEY): g_steps + grids,
            ("flash_fwd", _DP_VQGAN_KEY): 2 * (g_steps + grids),
            ("flash_bwd_dq", _DP_VQGAN_KEY): 2 * g_steps,
            ("flash_bwd_dkv", _DP_VQGAN_KEY): 2 * g_steps}


def _state_of(torch, modules) -> dict:
    """Every tensor of the modules' state dicts, on the host."""
    return {f"{i}.{k}": v.detach().float().cpu()
            for i, m in enumerate(modules) for k, v in m.state_dict().items()}


def _same_run(label, got, ref):
    """(losses, state) against (losses, state): bit for bit, or fail."""
    (g_losses, g_state), (r_losses, r_state) = got, ref
    d_loss = max(abs(a - b) for a, b in zip(g_losses, r_losses))
    d_state = max((g_state[k] - v).abs().max().item()
                  for k, v in r_state.items())
    print(f"{label}: max |d loss| {d_loss:.3e}, max |d state| "
          f"{d_state:.3e} over {len(r_state)} tensors")
    if len(g_losses) != len(r_losses) or not all(np.isfinite(g_losses)) \
            or d_loss or d_state:
        fail(f"{label}: not equal bit for bit")


def _rate(result, key):
    value = result.get(key)
    return f"{value:.4f}" if value is not None else "not measured"


def _free(torch):
    """Return a dropped trainer's memory, its graphs' pools included."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def dp_trainers(torch, kernels, seed: int, vqgan: Path, work: Path,
                card: str, counts: dict, grouped: bool) -> dict:
    """Phase 6's VQ-GAN, KL-VAE and DDPM training through their entry
    points at full width, each at a rank's batch of a world of 4 (VQ-GAN
    and KL-VAE 2 of 8 at 256 px, DDPM 4 of 16 at 128 px; phase 5c's
    images), _DP_STEPS steps, every call's launches gated exactly (per
    step as on one device). Without a process group (`grouped` False):
    `train_vqgan --step_mode split`, `train_kl_vae`, `train_ddpm
    --self_condition --immiscible`, returned as the references. On the
    group: the same three, each equal bit for bit to its reference, and
    `train_vqgan --step_mode fused` and `scan`, captured, each equal bit
    for bit to its step bodies run eagerly on the group (`graph=False`).
    Returns {run: (losses, state)} and adds the launches to `counts`."""
    from vqgan_tpu_torch import train_ddpm, train_kl_vae, train_vqgan
    from vqgan_tpu_torch.training.vqgan_trainer import VQGANTrainer

    split, images = vqgan / "data_split.json", vqgan / "images"
    where = "NCCL world 1" if grouped else "no process group"
    tag = "group" if grouped else "single"
    config = work / "dp_vqgan.json"
    config.write_text(json.dumps({"seed": seed, "images_per_user_train": 8}))
    runs = {}

    def gated(label, fn, expected):
        return run_gated(torch, kernels, f"{label} ({where})", fn, expected,
                         counts)

    def vqgan_cli(mode):
        result, secs = gated(
            f"train_vqgan --step_mode {mode} --batch_size 2",
            lambda: train_vqgan.main([
                "--config", str(config), "--split", str(split),
                "--data_path", str(images), "--results_folder",
                str(work / f"vqgan_{mode}_{tag}"), "--batch_size", "2",
                "--disc_start", str(_DP_STEPS // 2), "--save_every", "1000",
                "--train_steps", str(_DP_STEPS), "--step_mode", mode,
                "--scan_block", "2"]),
            _dp_vqgan_counts(_DP_STEPS, 1))
        trainer = result.pop("trainer")
        print(f"[{card}] train_vqgan --step_mode {mode} at batch 2 "
              f"({where}, mesh {trainer.mesh and trainer.mesh.shape}): "
              f"{_rate(result, 'images_per_s')} images/s over "
              f"{result['timed_steps']} steps; losses {result['losses']}")
        run = (result["losses"], _state_of(torch, (trainer.vqvae,
                                                   trainer.disc)))
        return run, trainer

    runs["vqgan_split"], _ = vqgan_cli("split")
    if grouped:
        for mode in ("fused", "scan"):
            captured, trainer = vqgan_cli(mode)
            graphs = trainer.graph_stats()
            cfg = trainer.config
            del trainer

            def eager():
                tr = VQGANTrainer(cfg, split_path=str(split), device="cuda",
                                  step_mode=mode, scan_block=2, graph=False)
                tr.save_and_sample = lambda *args: None  # no checkpoints
                return tr.train(num_steps=_DP_STEPS)["losses"], tr

            (losses, tr), _ = gated(
                f"VQGANTrainer {mode} eager (graph=False)", eager,
                _dp_vqgan_counts(_DP_STEPS, 0))
            print(f"[{card}] train_vqgan --step_mode {mode} graphs on the "
                  f"group: {graphs}")
            _same_run(f"train_vqgan {mode}, captured vs eager on the group",
                      captured, (losses, _state_of(torch, (tr.vqvae,
                                                           tr.disc))))
            del tr
            _free(torch)

    result, _ = gated(
        "train_kl_vae --batch_size 2",
        lambda: train_kl_vae.main([
            "--device", "cuda", "--data_path", str(images), "--split",
            str(split), "--results_folder", str(work / f"kl_vae_{tag}"),
            "--image_size", "256", "--batch_size", "2", "--train_steps",
            str(_DP_STEPS), "--save_every", str(_DP_STEPS), "--seed",
            str(seed)]),
        {(k, _DP_KL_KEY): 2 * _DP_STEPS for k in FLASH})
    print(f"[{card}] train_kl_vae at batch 2 ({where}): "
          f"{_rate(result, 'images_per_s')} images/s over "
          f"{result['timed_steps']} steps; losses {result['losses']}")
    runs["kl_vae"] = (result["losses"], _state_of(torch, (result["vae"],)))
    del result

    result, _ = gated(
        "train_ddpm --self_condition --immiscible --train_batch_size 4",
        lambda: train_ddpm.main([
            "--folder", str(images), "--results_folder",
            str(work / f"ddpm_{tag}"), "--train_batch_size", "4",
            "--train_num_steps", str(_DP_STEPS), "--self_condition",
            "--immiscible", "--seed", str(seed)]),
        {("flash_fwd", _DP_DDPM_KEY): 6 * _DP_STEPS,
         ("flash_bwd_dq", _DP_DDPM_KEY): 3 * _DP_STEPS,
         ("flash_bwd_dkv", _DP_DDPM_KEY): 3 * _DP_STEPS})
    trainer = result.pop("trainer")
    print(f"[{card}] train_ddpm --self_condition --immiscible at batch 4 "
          f"({where}, mesh {trainer.mesh and trainer.mesh.shape}): "
          f"{_rate(result, 'images_per_s')} images/s over "
          f"{result['timed_steps']} steps; losses {result['losses']}")
    runs["ddpm"] = (result["losses"], _state_of(
        torch, (trainer.model, trainer.ema_model)))
    del trainer, result
    return runs


def ldm_scan_on_the_group(torch, kernels, common: list, work: Path,
                          card: str, counts: dict) -> dict:
    """`train_latent_cfg --step_mode scan --scan_block 2` for
    _SCAN_STEPS steps in each `--param_sharding` mode on the NCCL group
    (its steps' graphs holding the collectives), each equal bit for bit to
    the same trainer's step bodies run eagerly (`graph=False`); one launch
    of each flash kernel per step. Returns {mode: latents/s}."""
    import dataclasses as dc

    from vqgan_tpu_torch import train_latent_cfg
    from vqgan_tpu_torch.training.ldm_trainer import LatentDiffusionTrainer

    args = [a if a != "step" else "scan" for a in common]
    steps = _SCAN_STEPS
    args[args.index("--train_num_steps") + 1] = str(steps)
    split = args[args.index("--split") + 1]
    per_run = {(k, _LDM_KEY): steps for k in FLASH}
    rates = {}
    for mode in ("replicated", "zero1", "fsdp", "tp", "fsdp_tp"):
        result, _ = run_gated(
            torch, kernels, f"train_latent_cfg --step_mode scan "
            f"--param_sharding {mode} (NCCL world 1)",
            lambda: train_latent_cfg.main([
                *args, "--scan_block", "2", "--param_sharding", mode,
                "--results_folder", str(work / f"scan_{mode}")]),
            per_run, counts)
        trainer = result.pop("trainer")
        captured = (result["losses"], {
            f"{part}.{k}": v.float().cpu()
            for part in ("model", "ema")
            for k, v in trainer.placed.gathered(part).items()})
        graphs = trainer.graph_stats()
        cfg = dc.replace(trainer.config,
                         results_folder=str(work / f"scan_{mode}_eager"))
        del trainer

        def eager():
            tr = LatentDiffusionTrainer(cfg, split_path=split, device="cuda",
                                        step_mode="scan", scan_block=2,
                                        param_sharding=mode, graph=False)
            tr.save_and_sample = lambda *a: None  # no checkpoints
            out = tr.train(num_steps=steps)
            return out["losses"], {
                f"{part}.{k}": v.float().cpu() for part in ("model", "ema")
                for k, v in tr.placed.gathered(part).items()}

        ref, _ = run_gated(torch, kernels, f"LatentDiffusionTrainer scan "
                           f"{mode} eager (graph=False)", eager, per_run,
                           counts)
        rates[mode] = result["latents_per_s"]
        print(f"[{card}] train_latent_cfg --step_mode scan --param_sharding "
              f"{mode} (NCCL world 1): {_rate(result, 'latents_per_s')} "
              f"latents/s over {result['timed_steps']} steps; graphs "
              f"{graphs}")
        _same_run(f"scan {mode}, captured vs eager on the group", captured,
                  ref)
        _free(torch)
    return rates


def _state_bytes(trainer) -> tuple:
    """(the device bytes of the train state a rank holds: the model's and
    the EMA copy's tensors, the optimizer's pieces and its moments, each
    storage once; the sizes of the other blocks the caching allocator
    holds allocated, largest first)."""
    import torch

    placed, opt = trainer.placed, trainer.placed.optimizer
    tensors = [*trainer.model.parameters(), *trainer.ema_model.parameters(),
               *placed.opt_tensors.values(), *placed.ema_tensors.values(),
               *(t for s in opt.inner.state.values() for t in s.values()
                 if torch.is_tensor(t))]
    seen = {}
    for t in tensors:
        if t.is_cuda:
            s = t.untyped_storage()
            seen[s.data_ptr()] = s.nbytes()
    other = sorted((b["size"] for seg in torch.cuda.memory_snapshot()
                    for b in seg["blocks"]
                    if b["state"] == "active_allocated"
                    and b["address"] not in seen), reverse=True)
    return sum(seen.values()), other


def _tp_rank(tp_dirs) -> dict:
    """On one of 2 gloo ranks sharing the card: the model-2 artifact
    ("tp2") and the artifact of whole weights ("whole3") on the same noise
    and classes, eagerly (gloo's gathers go through the host, which a CUDA
    graph cannot capture), cuDNN pinned to deterministic algorithms.
    Returns {name: {"images", "launches", "seconds", "weight_bytes",
    "allocated"}} and under "refused" what graph=True raised."""
    import torch

    from vqgan_tpu_torch.kernels import KERNELS
    from vqgan_tpu_torch.serving import load_cfg_sampler

    torch.backends.cudnn.deterministic = True
    g = torch.Generator("cuda").manual_seed(0)
    init = torch.randn((16, 32, 32, 4), generator=g, device="cuda")
    steps = torch.randn((_TP_CHAIN, 16, 32, 32, 4), generator=g,
                        device="cuda")
    classes = torch.arange(16, device="cuda") % 31
    out = {}
    for name in ("tp2", "whole3"):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        sampler = load_cfg_sampler(tp_dirs[name], "cuda")
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated() - before
        reset_counts(KERNELS)
        t0 = time.perf_counter()
        images = sampler(classes, init_noise=init, step_noise=steps,
                         graph=False)
        torch.cuda.synchronize()
        out[name] = {"images": images.cpu(), "launches": read_counts(KERNELS),
                     "seconds": time.perf_counter() - t0,
                     "weight_bytes": sampler.weight_bytes(),
                     "allocated": allocated}
        if name == "tp2":
            try:
                sampler(classes, init_noise=init, step_noise=steps,
                        graph=True)
                out["refused"] = None
            except ValueError as e:
                out["refused"] = str(e)
        del sampler, images
        gc.collect()  # the loaded programs hold cycles
        torch.cuda.empty_cache()
    return out


def _gloo2_rank(rank, world, argv, work, modes, tp_dirs):
    """On one of 2 gloo ranks sharing the card: `train_latent_cfg.main` on
    `argv` under each mode, into `work`/gloo2_{mode} (first, so that its
    resident bytes are a fresh process's), then the dry run at n = 2 (what
    `dryrun_multichip(2)` runs on each of its ranks), then the
    tensor-parallel serving check (`_tp_rank`). Returns ({mode: (each step's resident bytes, each step's
    peak bytes, the losses, the learning rate, `_state_bytes` after the
    run, rank 0's gathered weights)}, `_tp_rank`'s result, the dry run's
    line)."""
    import torch

    from vqgan_tpu_torch import train_latent_cfg
    from vqgan_tpu_torch.device import set_full_fp32_precision
    from vqgan_tpu_torch.dryrun_multichip import run_rank

    out = {}
    for mode in modes:
        res = train_latent_cfg.main([*argv, "--param_sharding", mode,
                                     "--results_folder",
                                     str(Path(work) / f"gloo2_{mode}")])
        trainer = res["trainer"]
        weights = {k: v.float().cpu() for k, v in
                   trainer.placed.gathered("model").items()}  # collective
        out[mode] = (res["resident_bytes"], res["peak_bytes"],
                     res["losses"], trainer.config.train_lr,
                     _state_bytes(trainer), weights if rank == 0 else None)
        del trainer, res, weights
        gc.collect()  # the hooks tie the state to the model in a cycle
    set_full_fp32_precision()  # as dryrun_multichip's ranks run
    t0 = time.perf_counter()
    line = run_rank(world, f"cuda:{torch.cuda.current_device()}")
    line = f"{line} ({time.perf_counter() - t0:.3f} s)"
    gc.collect()
    torch.cuda.empty_cache()
    return out, _tp_rank(tp_dirs), line


def _gloo2_argv(common: list) -> list:
    argv = list(common)
    argv[argv.index("--train_num_steps") + 1] = str(_GLOO2_STEPS)
    return argv


_GLOO2_MODES = ("replicated", "fsdp")


def start_two_ranks(common: list, work: Path, tp_dirs: dict):
    """Start `_gloo2_rank` on 2 gloo ranks sharing the card in a thread of
    this process, so that the main process goes on with its own runs while
    the ranks run; returns a function that joins them and returns (each
    rank's result, the seconds they took). The thread only waits on the
    ranks: nothing in it touches this process's random state or card."""
    import threading

    from vqgan_tpu_torch.parallel.launch import spawn

    box = {}

    def run():
        t0 = time.perf_counter()
        try:
            box["ranks"] = spawn(
                _gloo2_rank, 2, (_gloo2_argv(common), str(work),
                                 _GLOO2_MODES,
                                 {k: str(v) for k, v in tp_dirs.items()}),
                timeout=600, device="cuda", threads=2)
        except BaseException as e:  # re-raised by the join
            box["error"] = e
        box["seconds"] = time.perf_counter() - t0

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            fail(f"the 2 gloo ranks failed: {box['error']!r}")
        return box["ranks"], box["seconds"]

    return join


def fsdp_on_two_ranks(torch, common: list, seed: int, card: str,
                      ranks: list, seconds: float) -> tuple:
    """`train_latent_cfg` at full width on the 2 gloo ranks of
    `start_two_ranks` sharing the card (their collectives take the CUDA
    tensors through host memory), `--param_sharding fsdp` against
    `replicated`, _GLOO2_STEPS eager steps each. Fails unless fsdp's
    resident bytes at the last step's start are at most
    _GLOO2_RESIDENT_SHARE of replicated's on each rank and its weights'
    moves lie within _MOVE_NORM of replicated's in norm. The same ranks ran
    the dry run at n = 2 and the tensor-parallel serving check
    (`_tp_rank`, held by `check_tp_ranks`). Returns (the bytes and the
    distances, each rank's `_tp_rank` result, rank 0's dry-run line)."""
    from vqgan_tpu_torch.build import build_cfg_unet_diffusion
    from vqgan_tpu_torch.configs.ldm_config import LDMConfig

    argv, modes = _gloo2_argv(common), _GLOO2_MODES
    tp_ranks = [r[1] for r in ranks]
    dry_line = ranks[0][2]
    ranks = [r[0] for r in ranks]
    config = json.loads(Path(argv[argv.index("--config") + 1]).read_text())
    cfg = LDMConfig.from_dict({**config, "seed": seed})
    torch.manual_seed(cfg.seed)  # the trainer's initial weights
    init, _ = build_cfg_unet_diffusion(cfg, device="cpu")
    init = {k: v.detach().float() for k, v in init.named_parameters()}
    (_, _, _, lr, _, want), (_, _, losses, _, _, got) = (ranks[0][m]
                                                         for m in modes)
    keys = list(init)
    moves = torch.cat([(got[k] - init[k]).flatten() for k in keys])
    want_moves = torch.cat([(want[k] - init[k]).flatten() for k in keys])
    norm = ((moves - want_moves).norm() / want_moves.norm()).item()
    d_max = (moves - want_moves).abs().max().item()
    out = {"seconds": seconds, "move_diff_norm_share": norm,
           "max_abs_diff": d_max, "ranks": []}
    for rank, result in enumerate(ranks):
        line = {m: {"resident_bytes": result[m][0][-1],
                    "peak_bytes": result[m][1][-1],
                    "state_bytes": result[m][4][0],
                    "other_blocks": result[m][4][1][:8]} for m in modes}
        share = (line["fsdp"]["resident_bytes"]
                 / line["replicated"]["resident_bytes"])
        line["fsdp_resident_share"] = share
        out["ranks"].append(line)
        print(f"[{card}] train_latent_cfg on 2 gloo ranks sharing the card, "
              f"rank {rank}, bytes at the start of step {_GLOO2_STEPS} / "
              f"its peak: replicated {line['replicated']['resident_bytes']}"
              f" / {line['replicated']['peak_bytes']}, fsdp "
              f"{line['fsdp']['resident_bytes']} / "
              f"{line['fsdp']['peak_bytes']} (resident share {share:.4f}); "
              f"of it the train state (parameters, EMA, Adam) "
              f"{line['replicated']['state_bytes']} / "
              f"{line['fsdp']['state_bytes']}, the largest other blocks "
              f"after the run {line['replicated']['other_blocks']} / "
              f"{line['fsdp']['other_blocks']}")
        if share > _GLOO2_RESIDENT_SHARE:
            fail(f"fsdp's resident bytes on rank {rank} are {share:.4f} of "
                 f"replicated's, over {_GLOO2_RESIDENT_SHARE}")
    print(f"[{card}] fsdp vs replicated on 2 gloo ranks: {_GLOO2_STEPS} "
          f"steps, losses {losses}, moves differ by {norm:.3e} of "
          f"replicated's in norm (rule {_MOVE_NORM}), max|d| {d_max:.3e} "
          f"(lr {lr}); {seconds:.3f} s")
    if not all(np.isfinite(losses)) or norm > _MOVE_NORM:
        fail("fsdp on 2 gloo ranks left the norm rule of replicated's")
    return out, tp_ranks, dry_line


def export_tp_artifacts(torch, ldm: Path, served: Path, work: Path,
                        card: str) -> dict:
    """Phase 6's tensor-parallel serving artifacts, exported from phase
    5b's checkpoint and its KL-VAE at batch 16 by `export_cfg_sampler` with
    `tp_param_specs` of the step and the decode (every to_qkv, to_q, to_k,
    to_v and to_out kernel of the U-Net; the KL-VAE's attention, q, k, v
    and proj_out, matches no TP key and stays whole, as in JAX):
    - "tp2": model 2, cond_scale 3.0 / rescaled_phi 0.7, the first
      _TP_CHAIN pairs of the DDIM chain (the 2-rank check);
    - "tp1": model 1, cond_scale 1.0, the whole chain (NCCL world 1, each
      gather over a group of one);
    - "whole3": phase 5f's cond_scale 3.0 artifact of whole weights, its
      programs linked and its meta.json's chain cut to tp2's pairs;
    - "whole1": phase 5f's cond_scale 1.0 artifact as it is.
    Returns {name: directory} and, under "metrics", each export's seconds
    and bytes."""
    import os

    from vqgan_tpu_torch import export_serving, generate
    from vqgan_tpu_torch.parallel.mesh import Mesh
    from vqgan_tpu_torch.parallel.tp import tp_param_specs
    from vqgan_tpu_torch.serving import export_cfg_sampler

    config, weights = generate.load_checkpoint(ldm / "results")
    diffusion, _ = generate.load_model(config, weights, "cuda")
    vae = generate.load_vae(ldm / "kl_vae.pt", config.latent_channels,
                            config.image_size, device="cuda")
    pairs = diffusion.ddim_time_pairs()
    dirs, metrics = {}, {}
    for name, model, cond_scale, phi, chain in (
            ("tp2", 2, 3.0, 0.7, pairs[:_TP_CHAIN]),
            ("tp1", 1, 1.0, 0.0, pairs)):
        step, decode = export_serving.cfg_programs(diffusion, vae,
                                                   cond_scale, phi)
        mesh = Mesh({"data": 1, "model": model}, "cuda")
        specs = {"step": tp_param_specs(step, mesh),
                 "decode": tp_param_specs(decode, mesh)}
        if not specs["step"] or specs["decode"]:
            fail(f"TP specs: {len(specs['step'])} split step kernels, "
                 f"decode {specs['decode']}")
        dirs[name] = work / name
        meta = export_cfg_sampler(
            step, decode, dirs[name], batch_size=16,
            latent_shape=(diffusion.channels, diffusion.image_size,
                          diffusion.image_size), ddim_pairs=chain,
            num_users=config.num_users, cond_scale=cond_scale,
            rescaled_phi=phi, mesh=mesh, param_specs=specs)
        metrics[name] = {
            "programs": meta["programs"], "split_kernels": len(specs["step"]),
            "split_weights_bytes": (dirs[name] / "split_weights.pt").stat()
            .st_size}
        print(f"[{card}] TP artifact {name} (model {model}, cond_scale "
              f"{cond_scale}, {len(chain)} DDIM pairs, "
              f"{len(specs['step'])} split kernels): "
              + ", ".join(f"{k}.pt2 {v['bytes']} bytes in "
                          f"{v['seconds']:.3f} s"
                          for k, v in meta["programs"].items())
              + f", split_weights.pt {metrics[name]['split_weights_bytes']}"
                f" bytes")
    del diffusion, vae, weights
    dirs["whole1"] = served / "cfg_sampler_1.0"
    dirs["whole3"] = work / "whole3"
    dirs["whole3"].mkdir()
    for f in ("step.pt2", "decode.pt2"):
        os.link(served / "cfg_sampler_3.0" / f, dirs["whole3"] / f)
    meta = json.loads((served / "cfg_sampler_3.0" / "meta.json").read_text())
    if meta["ddim_pairs"][:_TP_CHAIN] != [list(p) for p in
                                          pairs[:_TP_CHAIN]]:
        fail("5f's artifact runs another DDIM chain than the checkpoint's")
    meta["ddim_pairs"] = meta["ddim_pairs"][:_TP_CHAIN]
    (dirs["whole3"] / "meta.json").write_text(json.dumps(meta))
    torch.cuda.empty_cache()
    return {**dirs, "metrics": metrics}


def check_tp_ranks(torch, tp_ranks, card: str, held_keys) -> tuple:
    """The 2-rank tensor-parallel check's results: on each rank the model-2
    artifact's images within _TP_RTOL, _TP_ATOL of the whole-weight
    artifact's (and their largest difference), both ranks' images equal,
    _TP_CHAIN + 1 flash forwards per call at shapes that phase 3 holds,
    the split kernels' pieces 1 / 2 of their whole bytes, graph=True
    refused over gloo. Returns the metrics and the ranks' launches (both
    artifacts', for the kernels' line)."""
    counts, metrics = {}, {"ranks": []}
    want = {("flash_fwd", (32, 16, 8, 64, "bfloat16")): _TP_CHAIN,
            ("flash_fwd", (16, 1024, 1, 512, "float32")): 1}
    for rank, res in enumerate(tp_ranks):
        tp, whole = res["tp2"], res["whole3"]
        d = (tp["images"] - whole["images"]).abs()
        bound = _TP_ATOL + _TP_RTOL * whole["images"].abs()
        rec = {"max_abs_diff": d.max().item(),
               "bit_for_bit": bool(d.max().item() == 0.0),
               "seconds": {"tp2": tp["seconds"], "whole3": whole["seconds"]},
               "weight_bytes": {"tp2": tp["weight_bytes"],
                                "whole3": whole["weight_bytes"]},
               "allocated_at_load": {"tp2": tp["allocated"],
                                     "whole3": whole["allocated"]}}
        metrics["ranks"].append(rec)
        wb = tp["weight_bytes"]
        print(f"[{card}] TP artifact on 2 gloo ranks sharing the card, rank "
              f"{rank}: {_TP_CHAIN} DDIM steps at cond_scale 3.0 + decode, "
              f"eager, {tp['seconds']:.3f} s (whole weights "
              f"{whole['seconds']:.3f} s); max|TP - whole| "
              f"{rec['max_abs_diff']:.3e} (bit for bit: "
              f"{rec['bit_for_bit']}); weights held {wb['held']} bytes, of "
              f"them split pieces {wb['split_held']} of {wb['split_whole']}"
              f" whole (whole-weight artifact: "
              f"{whole['weight_bytes']['held']}); allocated at load "
              f"{tp['allocated']} / {whole['allocated']}; launches "
              f"{tp['launches']}; graph=True: {res['refused']!r}")
        if not bool((d <= bound).all()) or not bool(
                torch.isfinite(tp["images"]).all()):
            fail(f"rank {rank}: the TP artifact's images leave the rule of "
                 f"the whole-weight artifact's")
        if not torch.equal(tp["images"], tp_ranks[0]["tp2"]["images"]):
            fail(f"rank {rank}'s images differ from rank 0's")
        for label, got in (("tp2", tp["launches"]),
                           ("whole3", whole["launches"])):
            if got != want:
                fail(f"rank {rank} {label}: launches {got}, expected {want}")
            for key, n in got.items():
                if key not in held_keys:
                    fail(f"{label} launched {key}, no shape of phase 3")
                counts[key] = counts.get(key, 0) + n
        if wb["split_held"] * 2 != wb["split_whole"] or wb["held"] != (
                whole["weight_bytes"]["held"] - wb["split_held"]):
            fail(f"rank {rank} holds {wb}, not the pieces alone")
        if not res["refused"] or "gloo" not in res["refused"]:
            fail(f"graph=True over gloo was not refused: {res['refused']}")
    return metrics, counts


def time_tp_world1(torch, kernels, tp_dirs: dict, card: str) -> tuple:
    """On the NCCL group of world 1: the model-1 artifact ("tp1", every
    gather over a group of one, captured with the step) against phase 5f's
    data-only artifact ("whole1") at batch 16, cond_scale 1.0, the DDIM-150
    chain and the decode, captured (the loader's default on the card): an
    untimed capture of each, then _TP_TURNS calls of each in turns (whole,
    tp, tp, whole), from one seed. The images of each call within
    _TP_RTOL, _TP_ATOL of whole1's first; 151 forwards per call through
    the replays. Returns ({variant: [seconds per call]}, launches)."""
    from vqgan_tpu_torch.serving import load_cfg_sampler

    samplers = {name: load_cfg_sampler(tp_dirs[name], "cuda")
                for name in ("whole1", "tp1")}
    classes = torch.zeros((16,), dtype=torch.long, device="cuda")

    def call(name):
        gen = torch.Generator("cuda").manual_seed(5)
        return samplers[name](classes, generator=gen)

    for name in samplers:
        call(name)  # the capture
    order = ["whole1", "tp1", "tp1", "whole1"] * (_TP_TURNS // 2)
    times = {name: [] for name in samplers}
    images = {}
    counts = {}

    def run():
        for name in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            images.setdefault(name, []).append(call(name))
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)

    run_gated(torch, kernels, "whole-weight and TP (model 1) artifacts in "
              "turns, captured", run,
              {("flash_fwd", (16, 16, 8, 64, "bfloat16")): 150 * len(order),
               ("flash_fwd", (16, 1024, 1, 512, "float32")): len(order)},
              counts)
    ref = images["whole1"][0]
    errs = [(img - ref).abs().max().item() for name in images
            for img in images[name]]
    within = all(bool(((img - ref).abs()
                       <= _TP_ATOL + _TP_RTOL * ref.abs()).all())
                 for name in images for img in images[name])
    wb = samplers["tp1"].weight_bytes()
    per_step = {name: [t / 150 * 1e3 for t in ts]
                for name, ts in times.items()}
    print(f"[{card}] NCCL world 1, batch 16, cond_scale 1.0, DDIM-150 + "
          f"decode captured, seconds per call in turns: "
          + "; ".join(f"{n} {', '.join(f'{t:.4f}' for t in ts)}"
                      for n, ts in times.items())
          + " (ms per DDIM step, the decode included: "
          + "; ".join(f"{n} {', '.join(f'{t:.3f}' for t in ts)}"
                      for n, ts in per_step.items())
          + f"); max|image - whole1's first| {max(errs):.3e}; TP weights "
            f"{wb}; graphs {samplers['tp1'].graphs.stats()}")
    if not within:
        fail(f"the model-1 artifact and the data-only one disagree: {errs}")
    return {"seconds_per_call": times, "ms_per_step": per_step,
            "max_abs_diff": max(errs), "weight_bytes": wb}, counts


def drive_scale_out(torch, kernels, peaks, seed: int, ldm: Path,
                    vqgan: Path, work: Path, card: str, served: Path,
                    held_keys):
    """Phase 6, scale-out on the card. Returns ({(kernel, shape):
    launches} of its main path, its kernel rows, metrics).

    - A real NCCL process group of world 1 in this process; on it
      `train_latent_cfg` at the full width (phase 5b's split and cache,
      batch 8, bf16) for each `--param_sharding` mode, _SCALE_OUT_STEPS
      steps each, cuDNN pinned to deterministic algorithms: each mode's
      losses within rtol 1e-4 of the replicated run's and its parameters
      and EMA within 0.05 x lr per step (the tests' whole-step rule); one
      launch of each flash kernel per step at [8,16,8,64] bf16; latents/s.
    - `ring_attention_shards` forward and backward with the kernels: at
      [2,4096,8,64] bf16 over 4 blocks against the whole-sequence flash
      attention and the plain `sdpa_reference`, each output at most
      _RING_BF16_FACTOR times as far from an fp64 evaluation as the flash
      attention's; at the dry run's [2,1024,2,64] fp32 over 8 blocks
      against `sdpa_reference` at atol 1e-4. n^2 launches of each kernel
      per call; the kernels' rows at the block shapes.
    - `dryrun_multichip` at the card's world size, in this group.
    - World 2 on the one card: gloo takes the CUDA tensors through host
      memory (parallel/comm.py), so the dry run at n = 2 runs there too;
      it fails on any check skipped.
    - The data-parallel trainers (`dp_trainers`), before the group and on
      it, and `train_latent_cfg --step_mode scan` in each mode on it
      (`ldm_scan_on_the_group`), with cuDNN and PyTorch's deterministic
      algorithms (the VQ lookup's codebook gradient is an `index_add_`),
      every run gated by its launches and bit for bit.
    - Tensor-parallel serving (`export_tp_artifacts`): on the group, the
      model-1 artifact against 5f's data-only one, captured, in turns
      (`time_tp_world1`); on the 2 gloo ranks of `fsdp_on_two_ranks`, the
      model-2 artifact against the whole-weight one (`check_tp_ranks`),
      every launch at a shape of `held_keys` (phase 3's rows).
    """
    import torch.distributed as dist

    from vqgan_tpu_torch import train_latent_cfg
    from vqgan_tpu_torch.dryrun_multichip import run_rank
    from vqgan_tpu_torch.ops.attention import flash_attention
    from vqgan_tpu_torch.parallel import initialize_distributed
    from vqgan_tpu_torch.parallel.launch import free_port

    t_phase = time.perf_counter()
    tp_dirs = export_tp_artifacts(torch, ldm, served, work, card)
    t_export = time.perf_counter() - t_phase
    config = work / "scale_out.json"
    config.write_text(json.dumps({"save_and_sample_every": 1000}))
    common = ["--split", str(ldm / "data_split.json"),
              "--latents_cache_folder", str(ldm / "latents_cache"),
              "--data_path", str(ldm / "images"), "--seed", str(seed),
              "--config", str(config), "--step_mode", "step",
              "--train_num_steps", str(_SCALE_OUT_STEPS)]
    # the 2 gloo ranks run beside this process's trainers (bit-for-bit and
    # launch gates only), and are joined before the timed ring rows and
    # the world-1 serving turns
    join_two_ranks = start_two_ranks(common, work, tp_dirs)
    t_dp0 = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    dp_counts = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # cuBLAS's workspace
        refs = dp_trainers(torch, kernels, seed, vqgan, work, card,
                           dp_counts, grouped=False)
    torch.use_deterministic_algorithms(False)
    t_refs = time.perf_counter() - t_dp0
    initialize_distributed("cuda", backend="nccl",
                           init_method=f"tcp://127.0.0.1:{free_port()}",
                           world_size=1, rank=0)
    print(f"phase 6: process group {dist.get_backend()} world "
          f"{dist.get_world_size()} on {card}")
    train_key = (8, 16, 8, 64, "bfloat16")
    g = torch.Generator("cuda").manual_seed(seed)
    ring_inputs = {}
    for label, shape, n, dt in RING_CASES:
        ring_inputs[label] = [torch.randn(shape, generator=g, device="cuda")
                              .to(getattr(torch, dt)) for _ in range(4)]

    # --- the main path, counted ------------------------------------------
    reset_counts(kernels)
    runs = {}
    for mode in ("replicated", "zero1", "fsdp", "tp", "fsdp_tp"):
        t0 = time.perf_counter()
        res = train_latent_cfg.main([*common, "--param_sharding", mode,
                                     "--results_folder",
                                     str(work / mode)])
        trainer = res.pop("trainer")
        runs[mode] = {
            "losses": res["losses"], "latents_per_s": res["latents_per_s"],
            "mesh": dict(trainer.mesh.shape), "lr": trainer.config.train_lr,
            "model": trainer.placed.gathered("model"),
            "ema": trainer.placed.gathered("ema"),
            "seconds": time.perf_counter() - t0}
        del trainer, res
    ring_out = {label: ring_run(torch, *ring_inputs[label], n)
                for label, _, n, _ in RING_CASES}
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    print(f"phase 6 launches: {counts}")

    base = runs["replicated"]
    for mode, run in runs.items():
        steps = len(run["losses"])
        d_loss = max(abs(a - b) / abs(b)
                     for a, b in zip(run["losses"], base["losses"]))
        d_par = max((run[p][k].float() - base[p][k].float()).abs().max()
                    .item() for p in ("model", "ema") for k in base[p])
        atol = 0.05 * run["lr"] * steps
        print(f"train_latent_cfg --param_sharding {mode} on {run['mesh']} "
              f"(NCCL world 1): {steps} steps in {run['seconds']:.3f} s, "
              f"{run['latents_per_s']:.4f} latents/s; losses "
              f"{run['losses']}; vs replicated: max rel |d loss| "
              f"{d_loss:.3e}, max |d param| {d_par:.3e} (rule {atol:.2e})")
        if steps != _SCALE_OUT_STEPS or not all(np.isfinite(run["losses"])):
            fail(f"{mode}: expected {_SCALE_OUT_STEPS} finite losses")
        if d_loss > 1e-4 or d_par > atol:
            fail(f"--param_sharding {mode} differs from replicated")
    want = {(k, train_key): 5 * _SCALE_OUT_STEPS for k in FLASH}
    for label, shape, n, dt in RING_CASES:
        b, s, h, d = shape
        for k in FLASH:
            want[(k, (b, s // n, h, d, dt))] = n * n
    if counts != want:
        fail(f"phase 6 launches {counts}, expected {want}")

    # --- the data-parallel trainers and the scan mode on the group -------
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        grouped = dp_trainers(torch, kernels, seed, vqgan, work, card,
                              dp_counts, grouped=True)
        for name, ref in refs.items():
            _same_run(f"{name}: NCCL world 1 vs no process group",
                      grouped[name], ref)
        del grouped, refs
        scan_rates = ldm_scan_on_the_group(torch, kernels, common, work,
                                           card, dp_counts)
    torch.use_deterministic_algorithms(False)
    t_dp = time.perf_counter() - t0 + t_refs
    print(f"phase 6 data-parallel trainers and scan on the group: "
          f"{t_dp:.3f} s (of it {t_refs:.3f} s before the group)")
    t0 = time.perf_counter()
    two_ranks, two_seconds = join_two_ranks()
    print(f"phase 6: the 2 gloo ranks took {two_seconds:.3f} s; waited "
          f"{time.perf_counter() - t0:.3f} s for them after the trainers")

    # --- the ring against flash attention, the plain version, fp64 -------
    metrics = {"modes": {m: {"latents_per_s": r["latents_per_s"],
                             "seconds": r["seconds"]}
                         for m, r in runs.items()},
               "scan_latents_per_s": scan_rates,
               "data_parallel_seconds": t_dp}
    del runs, base
    for label, shape, n, dt in RING_CASES:
        q, k, v, do = ring_inputs[label]
        out, grads = ring_out[label]
        exact = ring_ref(torch, q, k, v, do, torch.float64)
        names = ("out", "dq", "dk", "dv")
        got = [out, *grads]
        if dt == "float32":
            plain = ring_ref(torch, q, k, v, do, torch.float32)
            errs = [(a.double() - b.double()).abs().max().item()
                    for a, b in zip(got, [plain[0], *plain[1]])]
            print(f"ring {label}: max|ring - sdpa_reference| "
                  + " ".join(f"{n_}={e:.3e}" for n_, e in zip(names, errs)))
            if max(errs) > 1e-4:
                fail(f"ring {label} differs from sdpa_reference (atol 1e-4)")
            metrics[label] = {"max_abs_vs_plain": max(errs)}
            continue
        ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        flash_out = flash_attention(*ins)
        flash_out.backward(do)
        flash = [flash_out.detach(), *(t.grad for t in ins)]
        plain = ring_ref(torch, q, k, v, do, q.dtype)
        plain = [plain[0], *plain[1]]
        ex = [exact[0], *exact[1]]
        rec = {}
        for n_, a, f, p_, e in zip(names, got, flash, plain, ex):
            d_ring = (a.double() - e).abs().max().item()
            d_flash = (f.double() - e).abs().max().item()
            d_plain = (p_.double() - e).abs().max().item()
            rec[n_] = {"ring_vs_fp64": d_ring, "flash_vs_fp64": d_flash,
                       "plain_vs_fp64": d_plain,
                       "ring_vs_flash": (a.float() - f.float()).abs().max()
                       .item(),
                       "ring_vs_plain": (a.float() - p_.float()).abs().max()
                       .item()}
            print(f"ring {label} {n_}: from fp64 ring {d_ring:.3e}, flash "
                  f"{d_flash:.3e}, plain {d_plain:.3e}; |ring - flash| "
                  f"{rec[n_]['ring_vs_flash']:.3e}, |ring - plain| "
                  f"{rec[n_]['ring_vs_plain']:.3e}")
            if d_ring > _RING_BF16_FACTOR * d_flash:
                fail(f"ring {label} {n_}: {d_ring:.3e} from fp64, over "
                     f"{_RING_BF16_FACTOR} x the flash attention's")
        metrics[label] = rec
        del flash, plain, ex, exact
    del ring_out, ring_inputs
    torch.cuda.empty_cache()
    rows = {}
    for label, shape, n, dt in RING_CASES:
        rows.update(ring_rows(torch, peaks, label, shape, n, dt))

    # --- tensor-parallel serving at world 1, then the dry run ----------
    t0 = time.perf_counter()
    metrics["tp_world1"], tp_counts = time_tp_world1(torch, kernels, tp_dirs,
                                                     card)
    metrics["tp_world1"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line = run_rank(dist.get_world_size(), "cuda")
    print(f"{line} ({time.perf_counter() - t0:.3f} s, NCCL world 1)")
    dist.destroy_process_group()
    torch.backends.cudnn.deterministic = deterministic
    metrics["fsdp_gloo2"], tp_ranks, line2 = fsdp_on_two_ranks(
        torch, common, seed, card, two_ranks, two_seconds)
    print(f"{line2}, 2 ranks on one card over gloo")
    if "skipped" in line2:
        fail(f"the 2-rank dry run skipped a check: {line2}")
    metrics["tp_gloo2"], tp2_counts = check_tp_ranks(torch, tp_ranks, card,
                                                     held_keys)
    metrics["tp_export"] = {**tp_dirs.pop("metrics"), "seconds": t_export}
    print("phase 6: with more than one rank, every mode ran on the card "
          "only over gloo (2 ranks sharing the card, at the dry run's "
          "small U-Net; fsdp and replicated also at full width); at full "
          "width and over NCCL, one rank; no mode ran on several GPUs")
    metrics["dryrun_1"] = line
    metrics["dryrun_2_gloo"] = line2
    metrics["phase_seconds"] = time.perf_counter() - t_phase
    print(f"phase 6: {metrics['phase_seconds']:.3f} s")
    for key, n in [*dp_counts.items(), *tp_counts.items(),
                   *tp2_counts.items()]:
        counts[key] = counts.get(key, 0) + n
    return counts, rows, metrics


# the one timed record without FLOPs by design: a trivial program's time
HOST_FLOOR = "host dispatch floor"
SHARE_KEYS = ("mfu", "mfu_true", "mfu_device_only", "roofline_fraction",
              "per_step_vs_body_roofline", "per_nfe_vs_fwd_roofline")


def _shares_in_range(label: str, records):
    """Fail on any record whose MFU or share of a bound is missing, <= 0
    or over 1: a share over 1 means a count that is too high, a missing or
    zero one a count that collapsed (a program with no FLOPs or no bytes
    gives no MFU or no bound share). Every timed record (wall or device
    ms) must carry both "mfu" and "roofline_fraction", but the host floor;
    every share key a record has must hold a value in (0, 1]."""
    for rec in records:
        name = rec.get("program") or rec
        timed = "t_measured_ms" in rec or "ms" in rec or "us" in rec
        if timed and not str(name).startswith(HOST_FLOOR):
            for key in ("mfu", "roofline_fraction"):
                if rec.get(key) is None:
                    fail(f"{label}: {name} has no {key}")
        for key in SHARE_KEYS:
            if key not in rec:
                continue
            value = rec[key]
            if value is None:
                if str(name).startswith(HOST_FLOOR):
                    continue
                fail(f"{label}: {name} has {key} None")
            if not 0.0 < value <= 1.0:
                fail(f"{label}: {name} has {key} {value}, outside (0, 1]")


def drive_measurement_tools(torch, kernels, work: Path, card: str) -> dict:
    """Phase 7: the FLOP formulas against the plain versions' counts, then
    the four measurement tools at the JAX CLIs' defaults, gated by their
    launches, the VQ indices and their shares (module docstring)."""
    from vqgan_tpu_torch import (
        bench_attention,
        bench_vq,
        profile_sampling,
        profile_training,
    )
    from vqgan_tpu_torch.kernels.ops import OPS
    from vqgan_tpu_torch.ops.attention import (
        flash_bwd_dkv_reference,
        flash_bwd_dq_reference,
        flash_forward_reference,
    )
    from vqgan_tpu_torch.ops.vq import vq_lookup_reference
    from vqgan_tpu_torch.utils.flops import count_flops

    t_phase = time.perf_counter()
    metrics = {}
    gen = torch.Generator("cuda").manual_seed(7)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v, do = (randn(2, 256, 4, 64) for _ in range(4))
    lse = randn(2, 4, 256, dtype=torch.float32)
    delta = randn(2, 4, 256, dtype=torch.float32)
    z, cb = randn(8192, 256, dtype=torch.float32), randn(
        1024, 256, dtype=torch.float32)
    pairs = {
        "flash_fwd": ((OPS["flash_fwd"], q, k, v, 0.125),
                      (flash_forward_reference, q, k, v, 0.125)),
        "flash_bwd_dq": ((OPS["flash_bwd_dq"], q, k, v, do, lse, delta,
                          0.125),
                         (flash_bwd_dq_reference, q, k, v, do, lse, delta,
                          0.125)),
        "flash_bwd_dkv": ((OPS["flash_bwd_dkv"], q, k, v, do, lse, delta,
                           0.125),
                          (flash_bwd_dkv_reference, q, k, v, do, lse, delta,
                           0.125)),
        "vq_nearest": ((OPS["vq_nearest"], z, cb, "fp32"),
                       (vq_lookup_reference, z, cb, "fp32")),
    }
    formulas = {}
    for name, (op_call, plain_call) in pairs.items():
        by_formula = count_flops(*op_call)
        by_plain = count_flops(*plain_call, fake=False)
        formulas[name] = by_formula
        print(f"phase 7 {name}: formula {by_formula} FLOPs, the counter's "
              f"count of the plain version on the card {by_plain}")
        if by_formula != by_plain or by_formula <= 0:
            fail(f"{name}'s FLOP formula {by_formula} != its plain "
                 f"version's count {by_plain}")
    metrics["formula_flops"] = formulas
    del q, k, v, do, lse, delta, z, cb

    t0 = time.perf_counter()
    rows = bench_attention.main([])
    for row in rows:
        if row["route"] != "flash":
            continue
        want = ({"flash_fwd": 1.0} if row["pass"] == "fwd" else
                {"flash_fwd": 1.0, "flash_bwd_dq": 1.0,
                 "flash_bwd_dkv": 1.0})
        if row["launches_per_iter"] != want:
            fail(f"bench_attention S={row['seq']} {row['pass']}: launches "
                 f"per iteration {row['launches_per_iter']}, want {want}")
    _shares_in_range("bench_attention", rows)
    metrics["bench_attention"] = {
        f"S={r['seq']} {r['route']} {r['pass']}": {
            key: r.get(key) for key in ("ms", "flops_per_step", "bytes",
                                        "tflops_per_sec", "mfu",
                                        "t_tensor_core_ms", "t_hbm_ms",
                                        "roofline_fraction")}
        for r in rows}
    metrics["bench_attention_seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rows = bench_vq.main([])
    _shares_in_range("bench_vq", rows)
    for row in rows:
        want = 0.0 if row["route"] == "library" else 1.0
        if row["launches_per_call"] != want:
            fail(f"bench_vq K={row['k']} {row['route']}: "
                 f"{row['launches_per_call']} launches per call, want "
                 f"{want}")
    by_k = {}
    for row in rows:
        by_k.setdefault(row["k"], {})[row["route"]] = row
    for kk, routes in by_k.items():
        lib = routes["library"]
        z, cb = lib["z"], lib["codebook"]
        for route, mode, want in (
                ("kernel_fp32", "fp32", lib["indices"]),
                ("kernel", "bf16", vq_lookup_reference(z, cb, "bf16")[1])):
            flips, far, excess = vq_index_flips(
                torch, z, cb, routes[route]["indices"].int(), want.int(),
                mode, _VQ_FLIP_RTOL)
            against = ("the library" if mode == "fp32"
                       else "the plain bf16 version")
            print(f"bench_vq K={kk} {route}: {flips} index flips against "
                  f"{against} ({far} not near-ties, largest score excess "
                  f"{excess:.3e})")
            if far:
                fail(f"bench_vq K={kk} {route}: {far} indices that are "
                     f"not near-ties differ")
    metrics["bench_vq"] = {
        f"K={r['k']} {r['route']}": {
            key: r[key] for key in ("us", "gb_per_s", "flops_per_step",
                                    "bytes", "mfu", "t_tensor_core_ms",
                                    "t_hbm_ms", "roofline_fraction")}
        for r in rows}
    metrics["bench_vq_seconds"] = time.perf_counter() - t0
    del rows, by_k

    t0 = time.perf_counter()
    records = profile_training.main(
        ["--out", str(work / "training_roofline.json")])
    # at 128 px the VQ-VAE attends at 16 x 16 in its last encoder level (2
    # blocks), both mid blocks and its first decoder level (3 blocks)
    per_step = {"vq_nearest": 1.0, "flash_fwd": 7.0, "flash_bwd_dq": 7.0,
                "flash_bwd_dkv": 7.0}
    for rec in records:
        name = rec["program"]
        if " captured " in name:  # a chain of CHAIN steps
            want = {key: profile_training.CHAIN * n
                    for key, n in per_step.items()}
        elif name.startswith("g_step"):
            want = per_step
        elif name.startswith("d_step"):
            want = {}
        else:
            continue
        if rec["kernel_launches"] != want:
            fail(f"profile_training {name}: launches "
                 f"{rec['kernel_launches']}, want {want}")
    _shares_in_range("profile_training", records)
    metrics["profile_training"] = records
    metrics["profile_training_seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    records = profile_sampling.main(
        ["--out", str(work / "sampling_roofline.json")])
    wants = {"cfg4 full": 151.0, "cfg4 DDIM": 150.0, "cfg4 VAE": 1.0,
             "cfg4 single": 1.0, "cfg5 EDM": 512.0, "cfg5 single": 8.0}
    for rec in records:
        want = [n for prefix, n in wants.items()
                if rec["program"].startswith(prefix)]
        if want and rec["kernel_launches"] != {"flash_fwd": want[0]}:
            fail(f"profile_sampling {rec['program']}: launches "
                 f"{rec['kernel_launches']}, want {want[0]} flash_fwd")
    _shares_in_range("profile_sampling", records)
    metrics["profile_sampling"] = records
    metrics["profile_sampling_seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    metrics["phase_seconds"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 7: {metrics['phase_seconds']:.3f} s")
    return metrics


FIXTURE = ROOT / "tests" / "fixtures" / "jax_orbax"
# phase 8's tolerances against the JAX package's fp32 outputs on its CPU
# (expected.npz): the port computes in fp32 with TF32 off, so only the
# order of summation differs (every output measured within 1e-6 to 5e-6
# of JAX's, on a CPU and on an H100). The DDIM-10 chain at cond_scale 3.0
# carries each step's difference into the next and scales it by the
# guidance, as phase 4's chain does: a 20x margin for it and the rest.
_FIXTURE_ATOL = {"unet_out": 1e-4, "sample_latents": 1e-4,
                 "sample_images": 1e-4, "vq_recon": 1e-4}
# phase 8's launches on the card: the U-Net forward, the DDIM-10 chain
# (both halves of the guidance in one batch of 6), the KL-VAE decode, and
# the VQ-VAE's encode to indices (attention at 16 x 16 in the encoder's
# second level and its middle) and decode (its middle and 16 x 16 level)
_FIXTURE_LAUNCHES = {
    ("flash_fwd", (3, 64, 2, 8, "float32")): 1,
    ("flash_fwd", (6, 64, 2, 8, "float32")): 10,
    ("flash_fwd", (3, 64, 1, 16, "float32")): 1,
    ("flash_fwd", (3, 256, 1, 16, "float32")): 5,
    ("vq_nearest", (768, 8, 8, "fp32")): 1,
}
# a VQ index may differ from JAX's only where JAX's two nearest codes lie
# within this share of |z|^2 + |e|^2 (the encoders' fp32 sums differ in
# order, so a near-tie can go either way)
_FIXTURE_TIE = 1e-5


def dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def tree_bytes(node) -> int:
    """Bytes of the arrays in a tree of dicts and lists."""
    if isinstance(node, dict):
        node = list(node.values())
    if isinstance(node, list):
        return sum(tree_bytes(v) for v in node)
    return node.nbytes if isinstance(node, np.ndarray) else 0


def check_jax_fixture(torch, kernels, device, fixture: Path = FIXTURE):
    """Phase 8: the JAX package's Orbax checkpoints in
    tests/fixtures/jax_orbax/ (tests/_make_jax_orbax_fixture.py) read by
    the port's CLI loaders and run on `device`, held to the JAX modules'
    outputs in expected.npz under `_FIXTURE_ATOL`. Returns ({(kernel,
    shape): launches}, metrics: each whole checkpoint's read seconds and
    MB/s on disk, the loaders' seconds, the errors)."""
    from vqgan_tpu_torch import generate
    from vqgan_tpu_torch.checkpoint.load import load_vqvae, load_weights
    from vqgan_tpu_torch.checkpoint.orbax import read_orbax
    from vqgan_tpu_torch.models.autoencoder import AutoencoderConfig, KLVAE

    t_phase = time.perf_counter()
    meta = json.loads((fixture / "fixture.json").read_text())
    want = dict(np.load(fixture / "expected.npz"))
    paths = {"ldm": fixture / "ldm" / f"model-{meta['ldm_milestone']}",
             "kl_vae": (fixture / "kl_vae"
                        / f"kl_vae-{meta['kl_vae_milestone']}"),
             "vqgan": fixture / "vqgan" / f"vqgan-{meta['vqgan_milestone']}"}
    metrics = {"reads": {}}  # each whole checkpoint, optimizer state too
    for name, path in paths.items():
        t = time.perf_counter()
        tree = read_orbax(path)
        secs = time.perf_counter() - t
        disk = dir_bytes(path)
        metrics["reads"][name] = {
            "read_s": secs, "disk_bytes": disk,
            "param_bytes": tree_bytes(tree), "mb_per_s": disk / 1e6 / secs}

    t = time.perf_counter()
    config, weights = generate.load_checkpoint(fixture / "ldm")
    diffusion, unet = generate.load_model(config, weights, device)
    unet.eval()
    vae_cfg = {k: tuple(v) if isinstance(v, list) else v
               for k, v in meta["kl_vae"].items()}
    vae = load_weights(KLVAE(AutoencoderConfig(**vae_cfg)),
                       paths["kl_vae"]).to(device).eval()
    vqvae, _ = load_vqvae(paths["vqgan"], device=device)
    metrics["load_s"] = time.perf_counter() - t

    def put(name, dtype=None):
        x = torch.from_numpy(want[name]).to(device)
        return x if dtype is None else x.to(dtype)

    def nchw(x):
        return x.permute(0, 3, 1, 2)

    reset_counts(kernels)
    with torch.inference_mode():
        x = put("unet_x")
        got = {"unet_out": unet(
            nchw(x), put("unet_t", torch.long),
            put("unet_classes", torch.long),
            cond_drop_mask=torch.zeros(len(x), dtype=torch.bool,
                                       device=device)).permute(0, 2, 3, 1)}
        init = put("init_noise")
        got["sample_latents"] = diffusion.ddim_sample(
            tuple(init.shape), put("sample_classes", torch.long),
            cond_scale=meta["cond_scale"], rescaled_phi=meta["rescaled_phi"],
            init_noise=init, step_noise=put("step_noise"))
        got["sample_images"] = vae.decode_latents(got["sample_latents"])
        vq_x = nchw(put("vq_x"))
        idx = vqvae.encode_to_indices(vq_x)
        got["vq_recon"] = vqvae.decode_from_indices(idx).permute(0, 2, 3, 1)
    counts = read_counts(kernels)

    want_idx = want["vq_indices"].astype(np.int64)
    got_idx = idx.long().cpu().numpy()
    flips = got_idx != want_idx
    far = int((flips.reshape(-1) & (want["vq_gap"] > _FIXTURE_TIE)).sum())
    metrics["vq_index_flips"] = int(flips.sum())
    errors = {name: float(np.abs(got[name].float().cpu().numpy()
                                 - want[name]).max()) for name in got}
    metrics["max_abs_err"] = errors
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    print(f"phase 8, the JAX fixture on {device}: reads "
          + json.dumps(metrics["reads"])
          + f"; loaders {metrics['load_s']:.3f} s"
          f"; max|port - JAX| {json.dumps(errors)} (tolerance "
          f"{json.dumps(_FIXTURE_ATOL)}); VQ index flips {int(flips.sum())} "
          f"({far} not near-ties); launches {counts}")
    if not finite or far or any(
            errors[k] > _FIXTURE_ATOL[k] for k in errors
            if not (k == "vq_recon" and flips.any())):
        fail("the JAX fixture's outputs on the port disagree with "
             "expected.npz")
    if torch.device(device).type == "cuda" and counts != _FIXTURE_LAUNCHES:
        fail(f"the JAX fixture launched {counts}, expected "
             f"{_FIXTURE_LAUNCHES}")
    metrics["seconds"] = time.perf_counter() - t_phase
    print(f"phase 8 seconds: {metrics['seconds']:.3f}")
    return counts, metrics


# phase 8's resumed steps (`check_jax_resume`), against the JAX trainers'
# steps from the same milestones (resume_expected.npz): the losses and
# gradient norms at the tests' rtol (fp32 on both sides, TF32 off: the
# sums differ in order only); each parameter's update within 0.05 x lr of
# JAX's (the tests' rule), plus float16's rounding of the stored update
# (2^-11 of it; the writer stores update / lr in fp16): the LDM's in
# every element. The VQ-GAN's by test_torch_port_vqgan_train's rule
# instead: its fixture resumes at Adam's count 0, whose first updates are
# sign-like (m / sqrt(v) = +-1 for a lone gradient), so a conv bias under
# GroupNorm, whose gradient is 0 in exact arithmetic and rounding noise in
# practice, moves about lr one way on one side and the other way on the
# other; its updates agree within the rule in all but 1% of the elements,
# and differ by at most 5% of JAX's in norm. Its logs bar
# "perceptual_loss": both sides resume at perceptual weight 0 over LPIPS
# networks of random weights of their own.
_RESUME_RTOL = 1e-4
_RESUME_MOVE = 0.05
_RESUME_FP16 = 2.0 ** -11
_RESUME_VQGAN_MISS = 0.01
_RESUME_VQGAN_NORM = 0.05
# the kernels the resumed steps must reach, by shape: the U-Net's mid
# attention at batch 8 (2 heads x 8) and the VQ-VAE's four attentions at
# 16 x 16 (1 x 16), forward and backward; the VQ-VAE's quantizer, 8 grids
# of 16 x 16 against 8 codes of 8 dims
_RESUME_KEYS = {
    *((k, (8, 64, 2, 8, "float32")) for k in FLASH),
    *((k, (8, 256, 1, 16, "float32")) for k in FLASH),
    ("vq_nearest", (2048, 8, 8, "fp32")),
}


def _moves_within(torch, label, got_before, got_after, want, prefix, lr,
                  miss: float = 0.0, norm=None):
    """Each parameter's update (after - before) / lr against JAX's in
    `want` under `prefix`: at most a `miss` share of the elements beyond
    `_RESUME_MOVE` (+ the fp16 rounding), and with `norm` the difference
    at most that share of JAX's updates in norm. Returns (the largest
    difference, the share beyond, the difference's norm share)."""
    diffs, refs, beyond = [], [], []
    for key, stored in want.items():
        if not key.startswith(prefix):
            continue
        name = key[len(prefix):]
        move = ((got_after[name].double() - got_before[name].double()) / lr
                ).cpu().reshape(-1)
        ref = torch.from_numpy(stored.astype(np.float64)).reshape(-1)
        diffs.append(move - ref)
        refs.append(ref)
        beyond.append((move - ref).abs() > _RESUME_MOVE
                      + _RESUME_FP16 * ref.abs())
    diff, ref, beyond = torch.cat(diffs), torch.cat(refs), torch.cat(beyond)
    worst = float(diff.abs().max())
    share = float(beyond.double().mean())
    norm_share = float(diff.norm() / ref.norm()) if ref.norm() > 0 else 0.0
    if share > miss or (norm is not None and norm_share > norm):
        fail(f"{label}: {share:.3%} of the updates off JAX's by more than "
             f"{_RESUME_MOVE} x lr (allowed {miss:.0%}), the difference "
             f"{norm_share:.3%} of them in norm (largest {worst:.3e} x lr)")
    return worst, share, norm_share


def _logs_within(label, got: dict, want: dict) -> float:
    """The largest relative difference of the logged values from JAX's."""
    worst = 0.0
    for key, ref in want.items():
        ref = np.asarray(ref, np.float64)
        err = np.abs(np.asarray(got[key], np.float64) - ref)
        worst = max(worst, float((err / np.maximum(np.abs(ref), 1e-30)
                                  ).max()))
        if (err > _RESUME_RTOL * np.abs(ref) + 1e-7).any():
            fail(f"{label}: {key} {got[key]} against JAX's {ref.tolist()} "
                 f"(rtol {_RESUME_RTOL})")
    return worst


def check_jax_resume(torch, kernels, device, fixture: Path = FIXTURE):
    """Phase 8's resume: the port's trainers resumed from the committed JAX
    milestones by their own `load` (the LDM in step mode and in scan mode
    over the `CapturableOptimizer`, the VQ-GAN in split mode), each taking
    the two steps the JAX trainers took from them with the same batches
    and draws (resume_expected.npz, tests/_make_jax_orbax_fixture.py),
    held to JAX's by `_RESUME_RTOL` and `_RESUME_MOVE`. Returns ({(kernel,
    shape): launches}, metrics: each resume's seconds, the largest
    differences)."""
    from vqgan_tpu_torch.configs import LDMConfig, VQGANConfig
    from vqgan_tpu_torch.training.ldm_trainer import LatentDiffusionTrainer
    from vqgan_tpu_torch.training.vqgan_trainer import VQGANTrainer

    t_phase = time.perf_counter()
    want = dict(np.load(fixture / "resume_expected.npz"))
    metrics = {"resume_s": {}, "log_rel_err": {}, "move_err_x_lr": {}}

    def put(name, dtype=None):
        x = torch.from_numpy(want[name]).to(device)
        return x if dtype is None else x.to(dtype)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def params(module):
        return {k: v.detach().clone() for k, v in module.state_dict().items()}

    def resumed(label, make, milestone):
        trainer = make()
        sync()
        t = time.perf_counter()
        start = trainer.load(milestone)
        sync()
        metrics["resume_s"][label] = time.perf_counter() - t
        return trainer, start

    reset_counts(kernels)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as work:
        work = Path(work)
        for name in ("ldm", "vqgan"):
            shutil.copytree(fixture / name, work / name)
        raw = json.loads((work / "ldm" / "model-1.config.json").read_text())
        cfg = LDMConfig.from_dict({**raw, "results_folder":
                                   str(work / "ldm")})
        lat, lab = put("ldm_latents"), put("ldm_labels", torch.long)
        t_draw, noise = put("ldm_t", torch.long), put("ldm_noise")
        want_logs = {"loss": want["ldm_loss"],
                     "grad_norm": want["ldm_grad_norm"]}
        for mode in ("step", "scan"):
            label = f"ldm_{mode}"
            trainer, start = resumed(label, lambda: LatentDiffusionTrainer(
                cfg, device=device, step_mode=mode), 1)
            if start != int(want["ldm_start"]):
                fail(f"{label} resumed at step {start}, JAX's trainer at "
                     f"{int(want['ldm_start'])}")
            before = (params(trainer.model), params(trainer.ema_model))
            if mode == "step":
                logs = [trainer.train_step(
                    trainer.state, lat[i], lab[i], generator=trainer.generator,
                    t=t_draw[i], noise=noise[i]) for i in range(len(lat))]
                got = {k: [float(log[k]) for log in logs] for k in want_logs}
            else:
                logs = trainer.scan_step(
                    trainer.state, lat, lab, generator=trainer.generator,
                    t=t_draw, noise=noise)
                got = {k: logs[k].float().cpu().tolist() for k in want_logs}
            sync()
            metrics["log_rel_err"][label] = _logs_within(label, got,
                                                         want_logs)
            metrics["move_err_x_lr"][label] = max(
                _moves_within(torch, f"{label} params", before[0],
                              params(trainer.model), want, "ldm_params.",
                              cfg.train_lr)[0],
                _moves_within(torch, f"{label} EMA", before[1],
                              params(trainer.ema_model), want, "ldm_ema.",
                              cfg.train_lr)[0])
            if trainer.state.step != start + len(lat):
                fail(f"{label}: step {trainer.state.step} after the steps")
            del trainer, logs

        raw = json.loads((work / "vqgan" / "vqgan-1.config.json"
                          ).read_text())
        vcfg = VQGANConfig.from_dict({**raw, "perceptual_weight": 0.0,
                                      "results_folder": str(work / "vqgan")})
        trainer, start = resumed("vqgan_split", lambda: VQGANTrainer(
            vcfg, device=device, step_mode="split"), 1)
        if start != int(want["vqgan_start"]):
            fail(f"vqgan resumed at step {start}, JAX's trainer at "
                 f"{int(want['vqgan_start'])}")
        before = (params(trainer.vqvae), params(trainer.disc))
        images = put("vqgan_images", torch.float32) / 255.0
        logs = [trainer.dispatch_step(images[i], start + i)
                for i in range(len(images))]
        sync()
        want_logs = {k[len("vqgan_log."):]: v for k, v in want.items()
                     if k.startswith("vqgan_log.")
                     and k != "vqgan_log.perceptual_loss"}
        got = {k: [float(log[k]) for log in logs] for k in want_logs}
        metrics["log_rel_err"]["vqgan_split"] = _logs_within(
            "vqgan_split", got, want_logs)
        (metrics["move_err_x_lr"]["vqgan_split"],
         metrics["vqgan_moves_beyond"], metrics["vqgan_move_norm_share"]) = (
            _moves_within(torch, "vqgan_split params", before[0],
                          params(trainer.vqvae), want, "vqgan_params.",
                          vcfg.learning_rate, miss=_RESUME_VQGAN_MISS,
                          norm=_RESUME_VQGAN_NORM))
        # disc_start lies past these steps: the discriminator stays put
        if any(not torch.equal(v, trainer.disc.state_dict()[k])
               for k, v in before[1].items()):
            fail("vqgan_split: the discriminator moved before disc_start")
        del trainer, logs
    counts = read_counts(kernels)
    metrics["seconds"] = time.perf_counter() - t_phase
    print(f"phase 8, resumed from the JAX milestones on {device}: resume "
          f"seconds {json.dumps(metrics['resume_s'])}; largest relative "
          f"log difference {json.dumps(metrics['log_rel_err'])} (rtol "
          f"{_RESUME_RTOL}); largest update difference x lr "
          f"{json.dumps(metrics['move_err_x_lr'])} (rule {_RESUME_MOVE} + "
          f"fp16 rounding; the VQ-GAN's beyond it in "
          f"{metrics['vqgan_moves_beyond']:.3%} of its elements, "
          f"{metrics['vqgan_move_norm_share']:.3%} in norm); launches "
          f"{counts}")
    if torch.device(device).type == "cuda" and (
            set(counts) != _RESUME_KEYS or not all(counts.values())):
        fail(f"the resumed steps launched {counts}, expected each of "
             f"{sorted(_RESUME_KEYS)}")
    print(f"phase 8 resume seconds: {metrics['seconds']:.3f}")
    return counts, metrics


_START = time.perf_counter()


def clock(label: str) -> None:
    """The seconds since the script started, before `label`'s phase: the
    run's timeline against its 1200 s limit."""
    print(f"[clock] {time.perf_counter() - _START:.1f} s: {label}")


def _phase_child(conn, name: str, args: tuple) -> None:
    """In a process of its own: load the kernels (built by the main
    process), run this script's phase function `name` on `args`, send its
    (launches, metrics) back. Its counts start at 0 in this process."""
    import torch

    from vqgan_tpu_torch.device import set_full_fp32_precision
    from vqgan_tpu_torch.kernels import KERNELS, build_all

    set_full_fp32_precision()
    build_all(KERNELS.values())
    conn.send(globals()[name](torch, KERNELS, *args))
    conn.close()


class PhaseProcess:
    """A self-contained phase (its own data, models and directory) run in
    a process of its own while the main process goes on with the next
    phases; `result()` joins it. The phases share the card and the host's
    cores, so their host-timed numbers are taken beside a neighbour. A
    failure in the phase fails the run when it is joined; its process is
    a daemon, so it ends with the script whatever happens."""

    def __init__(self, label: str, name: str, *args):
        import multiprocessing as mp
        import os

        ctx = mp.get_context("spawn")
        self.label, self.t0 = label, time.perf_counter()
        self.conn, child = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_phase_child, args=(child, name, args),
                                daemon=True)
        # the phase's host linear algebra (FID's square root) on 2 cores
        before = {k: os.environ.get(k) for k in ("OPENBLAS_NUM_THREADS",
                                                 "MKL_NUM_THREADS")}
        os.environ.update({k: "2" for k in before})
        try:
            self.proc.start()
        finally:
            for k, v in before.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        child.close()

    def result(self, timeout: float = 900):
        sys.stdout.flush()
        result = None
        try:
            if self.conn.poll(timeout):
                result = self.conn.recv()
        except EOFError:  # the phase exited without a result
            pass
        self.proc.join(60)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()
        if result is None or self.proc.exitcode:
            fail(f"{self.label} failed in its process (exit code "
                 f"{self.proc.exitcode})")
        print(f"{self.label}: joined {time.perf_counter() - self.t0:.3f} "
              f"s after its process started")
        return result


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels and the small "
                         "chains; skip the full-width drives")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    from vqgan_tpu_torch.checkpoint import _zstd
    from vqgan_tpu_torch.device import set_full_fp32_precision
    from vqgan_tpu_torch.kernels import KERNELS, build_all

    if not torch.cuda.is_available():
        fail("no CUDA device")
    card = card_line()
    print(f"card: {card}")
    # the JAX package's checkpoints (phase 8) need the system's zstd
    print(f"zstd: {_zstd.LIBRARY} {_zstd.version()} through ctypes")
    jpeg = libjpeg_headers()
    print(f"libjpeg headers (g++ finds jpeglib.h): {jpeg}; image trainers "
          f"must read through {expected_image_loader(jpeg)}")
    name = torch.cuda.get_device_name(0)
    peaks = peaks_for(name)
    if peaks is None:
        fail(f"no data-sheet peaks for {name} in utils/flops.PEAKS")
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

    clock("phase 3")
    rows = {**check_flash_fwd(torch, peaks, args.seed),
            **check_flash_bwd(torch, peaks, args.seed),
            **check_vq(torch, peaks, args.seed)}
    clock("phase 4")
    check_small_pipeline(torch, KERNELS, args.seed)
    check_small_training(torch, KERNELS, args.seed)
    check_small_vqgan(torch, KERNELS, args.seed)
    check_small_kl_vae(torch, KERNELS, args.seed)
    check_small_gmm_classifier_fid(torch, KERNELS, args.seed)
    check_small_dit_and_remat(torch, KERNELS, args.seed)
    check_small_ddpm_and_karras(torch, KERNELS, args.seed)
    check_small_diffusion_library(torch, KERNELS, args.seed)
    clock("phase 4i")
    eager_rates = check_small_captured(torch, KERNELS, args.seed)
    clock("phase 4j")
    check_small_sampler_graphs(torch, KERNELS, args.seed)

    if not args.kernels_only:
        clock("phase 5")
        counts, rates = drive_main_path(torch, KERNELS, args.seed)
        print("samples/s (captured sampler): " + json.dumps(rates)
              + f"; phase 4i's DDIM-150 + decode at batch 16, eager and "
              f"captured in turns: {json.dumps(eager_rates)}")
        # one directory for phases 5b-5f: 5f serves 5b's, 5c's and 5d's
        # checkpoints
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            work = Path(work)
            for phase in ("ldm", "vqgan", "kl_vae", "gmm", "serving",
                          "stage2", "pixel", "library", "captured",
                          "scale_out", "tools"):
                (work / phase).mkdir()
            clock("phase 5b")
            train_counts, rate = drive_training(torch, KERNELS, args.seed,
                                                work / "ldm")
            print(f"latents/s: {rate}")
            clock("phase 5c")
            vq_counts, vq_rates = drive_vqgan_training(
                torch, KERNELS, args.seed, work / "vqgan", jpeg)
            print("images/s: " + json.dumps(vq_rates))
            clock("phase 5d")
            kl_counts, kl_rate = drive_kl_vae_slice(torch, KERNELS,
                                                    args.seed, work / "kl_vae")
            print(f"KL-VAE training images/s: {kl_rate}")
            # 5e, 5h and 5i each run in a process of their own beside the
            # phases after them (5e beside 5f and 5g; 5h and 5i beside 5j
            # and 5k): each makes its own data and models, no other phase
            # reads their files, and their host-bound parts (FID's square
            # roots, eager launches, start-ups) overlap the main process's
            clock("phase 5e (its own process, beside 5f-5g)")
            gmm = PhaseProcess("phase 5e", "drive_gmm_classifier_slice",
                               args.seed, work / "gmm")
            clock("phase 5f")
            serving_counts, serving_metrics = drive_serving(
                torch, KERNELS, args.seed, work / "serving", card,
                ldm_results=work / "ldm" / "results",
                vae_pt=work / "ldm" / "kl_vae.pt",
                vqgan_ckpt=work / "vqgan" / "vqgan" / "vqgan-2.pt",
                kl_ckpt=work / "kl_vae" / "kl_vae" / "kl_vae-2.pt",
                images=work / "kl_vae" / "images", generate_rates=rates)
            print("serving slice: " + json.dumps(serving_metrics))
            clock("phase 5g")
            stage2_counts, stage2_metrics = drive_stage2_rest(
                torch, KERNELS, args.seed, work / "stage2", work / "ldm",
                card)
            print("stage-2 rest: " + json.dumps(stage2_metrics))
            gmm_counts, gmm_metrics = gmm.result()
            print("GMM / classifier / FID slice: " + json.dumps(gmm_metrics))
            # the loaders' rates first, with no phase beside them
            clock("phase 5l")
            input_counts, input_metrics = drive_input_pipeline(
                torch, KERNELS, args.seed, work / "vqgan", work / "ldm",
                work / "kl_vae" / "kl_vae" / "kl_vae-2.pt",
                work / "kl_vae" / "images", card, jpeg)
            print("input pipeline: " + json.dumps(input_metrics))
            clock("phase 5h (its own process, beside 5j-5k)")
            pixel = PhaseProcess("phase 5h", "drive_pixel_diffusion",
                                 args.seed, work / "pixel", card, jpeg)
            clock("phase 5i (its own process, beside 5j-5k)")
            library = PhaseProcess("phase 5i", "drive_diffusion_library",
                                   args.seed, work / "library", card)
            clock("phase 5j")
            captured_counts, captured_metrics = drive_captured_training(
                torch, KERNELS, args.seed, work / "captured", work / "ldm",
                work / "vqgan", card)
            print("captured training: " + json.dumps(captured_metrics))
            clock("phase 5k")
            sampler_counts, sampler_metrics = drive_sampler_graphs(
                torch, KERNELS, args.seed, card)
            print("captured samplers: " + json.dumps(sampler_metrics))
            pixel_counts, pixel_metrics = pixel.result()
            print("pixel-space diffusion: " + json.dumps(pixel_metrics))
            library_counts, library_metrics = library.result()
            print("diffusion library: " + json.dumps(library_metrics))
            clock("phase 6")
            scale_counts, scale_rows, scale_metrics = drive_scale_out(
                torch, KERNELS, peaks, args.seed, work / "ldm",
                work / "vqgan", work / "scale_out", card, work / "serving",
                {(row["name"], row["key"]) for row in rows.values()})
            rows.update(scale_rows)
            print("scale-out: " + json.dumps(scale_metrics))
            clock("phase 7")
            tool_metrics = drive_measurement_tools(
                torch, KERNELS, work / "tools", card)
            print("measurement tools: " + json.dumps(tool_metrics))
        clock("phase 8")
        fixture_counts, fixture_metrics = check_jax_fixture(
            torch, KERNELS, "cuda")
        print(f"JAX fixture ({card}): " + json.dumps(fixture_metrics))
        resume_counts, resume_metrics = check_jax_resume(torch, KERNELS,
                                                         "cuda")
        print(f"JAX resume ({card}): " + json.dumps(resume_metrics))
        for key, n in resume_counts.items():
            fixture_counts[key] = fixture_counts.get(key, 0) + n
        for key, n in [*train_counts.items(), *vq_counts.items(),
                       *kl_counts.items(), *gmm_counts.items(),
                       *serving_counts.items(), *stage2_counts.items(),
                       *pixel_counts.items(), *input_counts.items(),
                       *library_counts.items(),
                       *captured_counts.items(), *sampler_counts.items(),
                       *scale_counts.items(), *fixture_counts.items()]:
            counts[key] = counts.get(key, 0) + n
        for row in rows.values():
            row["launches"] = counts.get((row["name"], row["key"]), 0)
            if not row["launches"]:
                fail(f"main-path shape {row['shape']} never reached "
                     f"{row['name']}: {counts}")

    clock("phase 9")
    for row in rows.values():
        del row["key"]
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
