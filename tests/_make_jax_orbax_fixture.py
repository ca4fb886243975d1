"""Write tests/fixtures/jax_orbax/: checkpoints of the JAX package, saved by
its own trainers, and the JAX modules' outputs on fixed inputs.

    JAX_PLATFORMS=cpu python tests/_make_jax_orbax_fixture.py [--out DIR]

Runs with JAX on the CPU (8 virtual devices, as the tests). Writes:

- `ldm/`: the `LatentDiffusionTrainer` of a small CFG U-Net (dim 8, one
  level, fp32) after two of its training steps on seeded
  latents, saved by `save_and_sample` as `model-1/` with
  `model-1.config.json` and `model-latest.json`. With the default EMA
  cadence (every 10 steps, the params copied until step 100) its
  `ema_params` are the params after the first step, so they differ from
  `params`;
- `kl_vae/kl_vae-1/`: a narrow KL-VAE's parameters as `cli/train_kl_vae.py`
  saves them (`CheckpointManager(prefix="kl_vae").save(m, params,
  config=vars(args))`); the CLI's own model is full width, whose 260 MB
  would not fit the fixture's budget;
- `vqgan/`: the `VQGANTrainer` of README's tiny VQ-GAN (ch 8, ch_mult
  [1, 2], 8 codes of 8 dims, fp32 at 32 px), saved by `save_and_sample`
  as `vqgan-1/` with its config;
- `fixture.json`: the widths the port needs beyond the saved configs (the
  KL-VAE's) and the sampling settings;
- `expected.npz`: the JAX modules' fp32 outputs on inputs drawn from a
  numpy seed (stored beside them): the U-Net on `ema_params`; a DDIM-10
  sample at cond_scale 3.0 from `init_noise` / `step_noise`, decoded by the
  KL-VAE; the VQ-VAE's indices and its reconstruction from them, with the
  gap between each row's nearest and second-nearest codebook distance as a
  share of |z|^2 + |e|^2.

- `resume_expected.npz`: the JAX trainers resumed from `ldm/model-1/`
  and `vqgan/vqgan-1/` by their own `load`, two steps each on batches
  drawn from a numpy seed: the LDM's batches, the `t` and noise its steps
  drew (replayed from its PRNG key, and checked against the step's loss),
  each step's loss and gradient norm; the VQ-GAN's uint8 images, each
  step's scalar logs. The VQ-GAN resumes at perceptual weight 0: its
  LPIPS network is a random initialisation (no weights in the
  checkpoint), which the port cannot rebuild without JAX. Each
  parameter's update after - before, over the learning rate, in the
  port's names and layout, as float16: the rule that `chip_smoke.py`
  applies is |port update / lr - stored| <= 0.05 + 2^-11 |stored| (the
  tests' 0.05 x lr, plus float16's rounding of the stored value).

    JAX_PLATFORMS=cpu python tests/_make_jax_orbax_fixture.py --resume_only

writes only `resume_expected.npz`, from the committed milestones, which
stay byte for byte.

The whole directory stays under 2 MB. The tests read it with `orbax` and
with the port and hold the two equal, so a fixture that no longer matches
its checkpoints fails; `chip_smoke.py` (phase 8) runs it on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "jax_orbax"

# the small LDM, the narrow KL-VAE and the tiny VQ-GAN of the fixture
LDM = dict(num_users=3, latent_size=8, image_size=16, latent_channels=4,
           dim=8, dim_mults=(1,), attn_heads=2, attn_dim_head=8,
           train_batch_size=8, timesteps=100, sampling_timesteps=10,
           cond_scale=3.0, rescaled_phi=0.7, compute_dtype="float32",
           train_lr=1e-3, seed=0)
KL_VAE = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
              resolution=16, z_channels=4)
VQGAN = dict(image_size=32, ch=8, ch_mult=(1, 2), num_res_blocks=1,
             z_channels=8, num_embeddings=8, embedding_dim=8, disc_ndf=8,
             disc_n_layers=2, compute_dtype="float32", batch_size=8, seed=0)
BATCH = 3
SEED = 20
RESUME_SEED = 21
RESUME_STEPS = 2


def _copy_milestone(src: Path, dst: Path, prefix: str, milestone: int):
    """The milestone's directory, config and latest pointer, as written."""
    dst.mkdir(parents=True, exist_ok=True)
    name = f"{prefix}-{milestone}"
    shutil.copytree(src / name, dst / name)
    for name in (f"{prefix}-{milestone}.config.json", f"{prefix}-latest.json"):
        if (src / name).exists():
            shutil.copy2(src / name, dst / name)


def _updates(port_state, before, after, lr: float, prefix: str) -> dict:
    """Each parameter's (after - before) / lr in the port's names, fp16."""
    import numpy as np

    a, b = port_state(after), port_state(before)
    return {f"{prefix}.{k}": ((a[k].double() - b[k].double()) / lr).numpy()
            .astype(np.float16) for k in a}


def write_resume_expected(out: Path) -> dict:
    """resume_expected.npz from the milestones under `out` (see the module
    docstring); returns its arrays."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vqgan_tpu.configs import LDMConfig, VQGANConfig
    from vqgan_tpu.training.ldm_trainer import LatentDiffusionTrainer
    from vqgan_tpu.training.vqgan_trainer import VQGANTrainer
    from vqgan_tpu_torch.checkpoint.from_jax import (
        cfg_unet_state_from_jax,
        vqvae_state_from_jax,
    )

    rng = np.random.default_rng(RESUME_SEED)
    want = {}
    here = Path.cwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)
        # --- the LDM trainer, resumed ------------------------------------
        shutil.copytree(out / "ldm", tmp / "ldm")
        cfg = LDMConfig(results_folder="ldm", **LDM)
        trainer = LatentDiffusionTrainer(cfg)
        start = trainer.load(1)
        before = jax.device_get(trainer.state)
        shape = (cfg.train_batch_size, cfg.latent_size, cfg.latent_size,
                 cfg.latent_channels)
        rows = {k: [] for k in ("latents", "labels", "t", "noise", "loss",
                                "grad_norm")}
        for i in range(RESUME_STEPS):
            latents = rng.standard_normal(shape).astype(np.float32)
            labels = rng.integers(0, cfg.num_users, shape[0], dtype=np.int32)
            # the draws of the JAX step (ldm_step: fold_in(rng, step), then
            # GaussianDiffusion.loss's split and p_losses' split)
            key = jax.random.fold_in(trainer._rng, start + i)
            k_t, k_p = jax.random.split(key)
            t = jax.random.randint(k_t, (shape[0],), 0, cfg.timesteps)
            noise = jax.random.normal(jax.random.split(k_p, 3)[0], shape,
                                      jnp.float32)
            replayed = trainer.diffusion.p_losses(
                trainer.state.params, k_p,
                trainer.diffusion.normalize(jnp.asarray(latents)), t,
                jnp.asarray(labels), noise=noise,
                cond_drop_prob=cfg.cond_drop_prob)
            trainer.state, log = trainer.train_step(
                trainer.state, trainer._put(jnp.asarray(latents)),
                trainer._put(jnp.asarray(labels)), trainer._rng)
            log = {k: float(v) for k, v in jax.device_get(log).items()}
            assert abs(float(replayed) - log["loss"]) <= 1e-5 * log["loss"], \
                (float(replayed), log["loss"])
            for k, v in (("latents", latents), ("labels", labels),
                         ("t", np.asarray(t)), ("noise", np.asarray(noise)),
                         ("loss", log["loss"]),
                         ("grad_norm", log["grad_norm"])):
                rows[k].append(v)
        after = jax.device_get(trainer.state)
        want.update({f"ldm_{k}": np.asarray(v) for k, v in rows.items()})
        want["ldm_start"] = np.asarray(start)
        want.update(_updates(cfg_unet_state_from_jax, before.params,
                             after.params, cfg.train_lr, "ldm_params"))
        want.update(_updates(cfg_unet_state_from_jax, before.ema_params,
                             after.ema_params, cfg.train_lr, "ldm_ema"))

        # --- the VQ-GAN trainer, resumed ----------------------------------
        shutil.copytree(out / "vqgan", tmp / "vqgan")
        vcfg = VQGANConfig(results_folder="vqgan", perceptual_weight=0.0,
                           **VQGAN)
        vtrainer = VQGANTrainer(vcfg)
        vstart = vtrainer.load(1)
        vbefore = jax.device_get(vtrainer.state)
        images, logs = [], []
        for i in range(RESUME_STEPS):
            x = rng.integers(0, 256, (vcfg.batch_size, vcfg.image_size,
                                      vcfg.image_size, 3), dtype=np.uint8)
            vtrainer.state, log = vtrainer.dispatch_step(
                vtrainer.state,
                vtrainer._put(jnp.asarray(x.astype(np.float32) / 255.0)),
                vstart + i)
            images.append(x)
            logs.append({k: float(v) for k, v in jax.device_get(log).items()
                         if np.ndim(v) == 0})
        vafter = jax.device_get(vtrainer.state)
        want["vqgan_images"] = np.stack(images)
        want["vqgan_start"] = np.asarray(vstart)
        for k in logs[0]:
            want[f"vqgan_log.{k}"] = np.asarray([log[k] for log in logs])
        want.update(_updates(vqvae_state_from_jax, vbefore.vqvae_params,
                             vafter.vqvae_params, vcfg.learning_rate,
                             "vqgan_params"))
        os.chdir(here)
    np.savez_compressed(out / "resume_expected.npz", **want)
    return want


def _check_size(out: Path) -> None:
    total = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
    print(f"{out}: {total} bytes in "
          f"{sum(1 for p in out.rglob('*') if p.is_file())} files")
    if total > 2 * 2**20:
        raise SystemExit(f"the fixture is {total} bytes, over 2 MiB")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(FIXTURE))
    ap.add_argument("--resume_only", action="store_true",
                    help="write only resume_expected.npz, from the "
                         "milestones already under --out")
    args = ap.parse_args(argv)

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    sys.path.insert(0, str(REPO))
    out = Path(args.out).resolve()
    if args.resume_only:
        write_resume_expected(out)
        _check_size(out)
        return
    from vqgan_tpu.checkpoint import CheckpointManager
    from vqgan_tpu.configs import LDMConfig, VQGANConfig
    from vqgan_tpu.models import KLVAE, VQVAE
    from vqgan_tpu.models.autoencoder import AutoencoderConfig
    from vqgan_tpu.training.ldm_trainer import LatentDiffusionTrainer
    from vqgan_tpu.training.vqgan_trainer import VQGANTrainer

    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    rng = np.random.default_rng(SEED)
    expected = {}

    here = Path.cwd()
    with tempfile.TemporaryDirectory() as tmp:
        # the trainers record their results folder in the saved config:
        # relative names keep the temporary directory out of the fixture
        tmp = Path(tmp)
        os.chdir(tmp)
        # --- the LDM trainer, two steps --------------------------------
        cfg = LDMConfig(results_folder="ldm", **LDM)
        trainer = LatentDiffusionTrainer(cfg)
        for _ in range(2):
            latents = rng.standard_normal(
                (cfg.train_batch_size, cfg.latent_size, cfg.latent_size,
                 cfg.latent_channels)).astype(np.float32)
            labels = rng.integers(0, cfg.num_users, cfg.train_batch_size,
                                  dtype=np.int32)
            trainer.state, _ = trainer.train_step(
                trainer.state, trainer._put(jnp.asarray(latents)),
                trainer._put(jnp.asarray(labels)), trainer._rng)
        trainer.save_and_sample(1)
        _copy_milestone(tmp / "ldm", out / "ldm", "model", 1)
        state = jax.device_get(trainer.state)
        ema = state.ema_params
        assert int(state.step) == 2
        assert any(np.any(np.asarray(a) != np.asarray(b)) for a, b in zip(
            jax.tree.leaves(ema), jax.tree.leaves(state.params))), \
            "ema_params should differ from params after two steps"

        # the U-Net on ema_params
        s = (BATCH, cfg.latent_size, cfg.latent_size, cfg.latent_channels)
        x = rng.standard_normal(s).astype(np.float32)
        t = np.array([0, 41, 99], np.int32)
        classes = np.array([0, 2, 1], np.int32)
        expected.update(unet_x=x, unet_t=t, unet_classes=classes)
        expected["unet_out"] = np.asarray(trainer.model.apply(
            ema, jnp.asarray(x), jnp.asarray(t), jnp.asarray(classes),
            cond_drop_mask=jnp.zeros((BATCH,), bool)))

        # --- the narrow KL-VAE, in train_kl_vae's layout ----------------
        vae = KLVAE(config=AutoencoderConfig(**KL_VAE))
        vae_params = jax.jit(vae.init)(
            {"params": jax.random.PRNGKey(1),
             "gaussian": jax.random.PRNGKey(2)},
            jnp.zeros((1, KL_VAE["resolution"], KL_VAE["resolution"], 3)))
        kl_args = dict(data_path="images", split="split.json",
                       results_folder="kl_vae",
                       image_size=KL_VAE["resolution"],
                       latent_channels=KL_VAE["z_channels"], batch_size=8,
                       lr=4.5e-6, lr_schedule="constant",
                       train_steps=1, kl_weight=1e-6, perceptual_weight=0.0,
                       lpips_weights=None, save_every=1, seed=42)
        CheckpointManager(tmp / "kl_vae", prefix="kl_vae").save(
            1, jax.device_get(vae_params), config=kl_args)
        _copy_milestone(tmp / "kl_vae", out / "kl_vae", "kl_vae", 1)

        # the DDIM-10 chain at cond_scale 3.0, decoded by the KL-VAE
        init = rng.standard_normal(s).astype(np.float32)
        steps = rng.standard_normal(
            (cfg.sampling_timesteps, *s)).astype(np.float32)
        sample_classes = np.array([2, 0, 1], np.int32)
        z = trainer.diffusion.ddim_sample(
            ema, jax.random.PRNGKey(0), s, jnp.asarray(sample_classes),
            cond_scale=cfg.cond_scale, rescaled_phi=cfg.rescaled_phi,
            init_noise=init, step_noise=steps)
        images = vae.apply(vae_params, z, method=KLVAE.decode_latents)
        expected.update(init_noise=init, step_noise=steps,
                        sample_classes=sample_classes,
                        sample_latents=np.asarray(z),
                        sample_images=np.asarray(images))

        # --- the VQ-GAN trainer ------------------------------------------
        vcfg = VQGANConfig(results_folder="vqgan", **VQGAN)
        vtrainer = VQGANTrainer(vcfg)
        vtrainer.save_and_sample(1)
        _copy_milestone(tmp / "vqgan", out / "vqgan", "vqgan", 1)
        vq_params = jax.device_get(vtrainer.state.vqvae_params)
        os.chdir(here)

    # the VQ-VAE as the JAX CLIs build it from the config
    vq = VQVAE(ch=vcfg.ch, ch_mult=tuple(vcfg.ch_mult),
               num_res_blocks=vcfg.num_res_blocks,
               attn_resolutions=tuple(vcfg.attn_resolutions),
               resolution=vcfg.image_size, z_channels=vcfg.z_channels,
               num_embeddings=vcfg.num_embeddings,
               embedding_dim=vcfg.embedding_dim)
    vq_x = rng.uniform(0, 1, (BATCH, vcfg.image_size, vcfg.image_size, 3)
                       ).astype(np.float32)
    idx = vq.apply(vq_params, jnp.asarray(vq_x),
                   method=VQVAE.encode_to_indices)
    pre = np.asarray(vq.apply(vq_params, jnp.asarray(vq_x),
                              method=VQVAE.encode_pre_quant))
    codebook = np.asarray(vq_params["params"]["quantizer"]["embedding"])
    flat = pre.reshape(-1, pre.shape[-1]).astype(np.float64)
    dist = ((flat[:, None, :] - codebook[None]) ** 2).sum(-1)
    nearest = np.sort(dist, axis=1)
    scale = (flat ** 2).sum(1) + (codebook[dist.argmin(1)] ** 2).sum(1)
    expected.update(vq_x=vq_x, vq_indices=np.asarray(idx),
                    vq_gap=((nearest[:, 1] - nearest[:, 0]) / scale
                            ).astype(np.float32),
                    vq_recon=np.asarray(vq.apply(
                        vq_params, idx, method=VQVAE.decode_from_indices)))

    np.savez_compressed(out / "expected.npz", **expected)
    (out / "fixture.json").write_text(json.dumps({
        "kl_vae": dict(KL_VAE), "ldm_milestone": 1, "kl_vae_milestone": 1,
        "vqgan_milestone": 1, "cond_scale": cfg.cond_scale,
        "rescaled_phi": cfg.rescaled_phi,
        "written_by": "tests/_make_jax_orbax_fixture.py"}, indent=2))
    print(f"smallest relative VQ distance gap "
          f"{expected['vq_gap'].min():.3e}")
    write_resume_expected(out)
    _check_size(out)


if __name__ == "__main__":
    main()
