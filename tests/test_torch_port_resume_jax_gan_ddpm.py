"""Resuming the port's VQ-GAN and DDPM trainers and their CLIs from the
JAX package's train states (vqgan_tpu_torch/checkpoint/train_state.py);
the LDM, DiT and Diffusers-style cases, the committed fixture and the
refusals are in test_torch_port_resume_jax.py, whose helpers and rules
this file shares (losses at rtol 1e-4, parameters and EMA at atol 0.05 x
lr, JAX's draws replayed).

- VQ-GAN with MultiSteps (k = 2) and the discriminator active from step
  0: a state of the JAX package's own types, optimizers and split steps
  (perceptual weight 0: no LPIPS program to compile), saved after 3 G + D
  steps (mid-accumulation) by its `CheckpointManager` as the trainer saves
  it; the port's `VQGANTrainer` resumes it and takes the next two steps:
  every logged loss, the BatchNorm statistics of the D passes, and the
  moves by test_torch_port_vqgan_train.py's rule (`VQ_MOVE_MISS`).
- DDPM: the JAX DDPM `Trainer` at a small fp32 width, 3 steps, saved as
  its `save_and_sample` saves; the port's `Trainer` resumes and takes the
  next two steps.
- `train_vqgan --resume -1` and `train_ddpm --resume -1` on a JAX
  milestone of their own model: they print the JAX step, train on, and
  write a `.pt` milestone that the port resumes again.
"""

import dataclasses
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_port_resume_jax import (
    MOVE,
    RTOL,
    VQ_MOVE_MISS,
    VQ_MOVE_NORM,
    assert_logs,
    assert_moves,
    fill,
    jax_draws,
    optax_state,
    port_config,
)
from vqgan_tpu.checkpoint import CheckpointManager as JCheckpointManager
from vqgan_tpu.configs import VQGANConfig as JVQGANConfig
from vqgan_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from vqgan_tpu.models import VQVAE as JVQVAE
from vqgan_tpu.models.discriminator import PatchGANDiscriminator as JPatchGAN
from vqgan_tpu.models.unet import Unet as JUnet
from vqgan_tpu.training.ddpm_trainer import Trainer as JDDPMTrainer
from vqgan_tpu.training.ldm_step import LDMTrainState as JLDMState
from vqgan_tpu.training.ldm_step import make_ldm_optimizer as j_ldm_optimizer
from vqgan_tpu.training.vqgan_step import VQGANTrainState as JVQGANState
from vqgan_tpu.training.vqgan_step import make_gan_optimizers as j_gan_opts
from vqgan_tpu.training.vqgan_step import (
    make_vqgan_split_steps as j_split_steps,
)
from vqgan_tpu_torch import train_ddpm, train_vqgan
from vqgan_tpu_torch.checkpoint import (
    ddpm_unet_state_from_jax,
    patchgan_state_from_jax,
    vqvae_state_from_jax,
)
from vqgan_tpu_torch.configs import VQGANConfig
from vqgan_tpu_torch.diffusion import GaussianDiffusion
from vqgan_tpu_torch.models import Unet
from vqgan_tpu_torch.training.ddpm_trainer import Trainer
from vqgan_tpu_torch.training.vqgan_trainer import VQGANTrainer

torch.set_num_threads(2)

VQ_TINY = dict(image_size=32, ch=8, ch_mult=(1, 2), num_res_blocks=1,
               z_channels=8, num_embeddings=8, embedding_dim=8, disc_ndf=8,
               disc_n_layers=2, compute_dtype="float32", batch_size=2,
               disc_start=0, perceptual_weight=0.0,
               gradient_accumulate_every=2, save_and_sample_every=2, seed=0)


def write_images(root: Path, n=4) -> Path:
    rng = np.random.default_rng(1)
    folder = root / "images" / "ID_1"
    folder.mkdir(parents=True)
    names = []
    for i in range(n):
        names.append(f"f{i}.jpg")
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
                        ).save(folder / names[-1])
    split = {"metadata": {}, "users": {"ID_1": {"train_images": names,
                                                "test_images": []}}}
    (root / "split.json").write_text(json.dumps(split))
    return root / "split.json"


# --- VQ-GAN with MultiSteps, the discriminator active -----------------------


@pytest.fixture(scope="module")
def vqgan_jax(tmp_path_factory):
    """A JAX VQ-GAN state after 3 G + D steps (k = 2: one gradient
    accumulated), saved as the JAX trainer saves it, then its next two
    steps: their images, logs and the parameters and statistics after."""
    root = tmp_path_factory.mktemp("vqgan_jax")
    cfg = JVQGANConfig(**VQ_TINY, results_folder=str(root))
    vq = JVQVAE(ch=cfg.ch, ch_mult=cfg.ch_mult,
                num_res_blocks=cfg.num_res_blocks,
                attn_resolutions=cfg.attn_resolutions,
                resolution=cfg.image_size, z_channels=cfg.z_channels,
                num_embeddings=cfg.num_embeddings,
                embedding_dim=cfg.embedding_dim)
    disc = JPatchGAN(ndf=cfg.disc_ndf, n_layers=cfg.disc_n_layers,
                     norm=cfg.disc_norm)
    x0 = jnp.zeros((1, cfg.image_size, cfg.image_size, 3))
    vq_params = fill(jax.eval_shape(vq.init, jax.random.PRNGKey(0), x0), 0)
    disc_vars = fill(dict(jax.eval_shape(disc.init, jax.random.PRNGKey(1),
                                         x0)), 1)

    def disc_apply(params, stats, images, train):
        if train:
            logits, upd = disc.apply({**params, **stats}, images, train=True,
                                     mutable=["batch_stats"])
            return logits, {"batch_stats": upd["batch_stats"]}
        return disc.apply({**params, **stats}, images, train=False), stats

    opt_g, opt_d = j_gan_opts(
        learning_rate=cfg.learning_rate,
        disc_learning_rate=cfg.disc_learning_rate, betas=cfg.adam_betas,
        weight_decay=cfg.weight_decay, max_grad_norm=cfg.max_grad_norm,
        gradient_accumulate_every=cfg.gradient_accumulate_every)
    g_step, d_step = j_split_steps(
        vq.apply, disc_apply, opt_g, opt_d, disc_start=cfg.disc_start,
        disc_weight=cfg.disc_weight, perceptual_weight=0.0,
        disc_loss_type=cfg.disc_loss_type, perceptual_fn=None,
        use_adaptive_weight=cfg.use_adaptive_weight, donate=False)
    disc_params = {"params": disc_vars["params"]}
    state = JVQGANState(
        step=jnp.asarray(0), vqvae_params=vq_params, disc_params=disc_params,
        disc_stats={"batch_stats": disc_vars["batch_stats"]},
        opt_g=opt_g.init(vq_params), opt_d=opt_d.init(disc_params))
    images = np.random.default_rng(2).random(
        (5, cfg.batch_size, cfg.image_size, cfg.image_size, 3)
    ).astype(np.float32)
    logs = []
    for i, x in enumerate(images):
        if i == 3:
            JCheckpointManager(root, prefix="vqgan").save(
                1, jax.device_get(state), config=dataclasses.asdict(cfg))
            saved = jax.device_get(state)
        state, recon, log = g_step(state, jnp.asarray(x))
        state, d_log = d_step(state, jnp.asarray(x), recon)
        logs.append({k: float(v) for k, v in {**log, **d_log}.items()
                     if np.ndim(v) == 0 and k != "perceptual_loss"})
    assert int(saved.opt_g.mini_step) == 1
    after = jax.device_get(state)

    def port_names(s):
        return {"vqvae": vqvae_state_from_jax(s.vqvae_params),
                "disc": patchgan_state_from_jax({**s.disc_params,
                                                 **s.disc_stats})}

    return {"root": root, "images": images[3:], "logs": logs[3:],
            "before": port_names(saved), "after": port_names(after),
            "lr": cfg.learning_rate}


def test_vqgan_resumes_a_jax_multisteps_state_and_steps_as_jax(vqgan_jax):
    cfg = port_config(VQGANConfig, vqgan_jax["root"], "vqgan")
    trainer = VQGANTrainer(cfg, device="cpu", step_mode="split")
    assert trainer.load() == 3
    assert (trainer.opt_g.count, trainer.opt_g.mini_step) == (1, 1)
    assert (trainer.opt_d.count, trainer.opt_d.mini_step) == (1, 1)
    logs = [trainer.dispatch_step(torch.from_numpy(x), 3 + i)
            for i, x in enumerate(vqgan_jax["images"])]
    for i, want in enumerate(vqgan_jax["logs"]):
        assert_logs({k: float(logs[i][k]) for k in want}, want,
                    f"step {3 + i}")
    lr = vqgan_jax["lr"]
    for part, module in (("vqvae", trainer.vqvae), ("disc", trainer.disc)):
        got = module.state_dict()
        want, before = vqgan_jax["after"][part], vqgan_jax["before"][part]
        stats = [k for k in want if k.endswith(("running_mean",
                                                "running_var"))]
        for k in stats:  # the BatchNorm statistics of the D passes
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-5)
        names = [k for k in want if k not in stats]
        moves = torch.cat([(got[k] - before[k]).reshape(-1) for k in names])
        want_moves = torch.cat([(want[k] - before[k]).reshape(-1)
                                for k in names])
        diff = moves - want_moves
        assert want_moves.abs().max() > 0.5 * lr, part
        assert (diff.abs() > MOVE * lr).float().mean() <= VQ_MOVE_MISS, part
        assert diff.norm() <= VQ_MOVE_NORM * want_moves.norm(), part


# --- DDPM -------------------------------------------------------------------


DDPM_UNET = dict(dim=8, dim_mults=(1,), channels=3, attn_heads=2,
                 attn_dim_head=16)
DDPM_DIFF = dict(image_size=8, channels=3, timesteps=20, sampling_timesteps=3,
                 objective="pred_v", beta_schedule="sigmoid",
                 ddim_sampling_eta=0.0, auto_normalize=True)
DDPM_LR = 8e-5


def test_ddpm_resumes_a_jax_state_and_steps_as_jax(tmp_path):
    jnet = JUnet(**DDPM_UNET)
    x0 = jnp.zeros((1, 8, 8, 3))
    params = fill(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x0,
                                 jnp.zeros((1,), jnp.int32)), 4)

    def model_apply(p, x, t, x_self_cond=None, return_features=False):
        return jnet.apply(p, x, t, x_self_cond,
                          return_features=return_features)

    j = JDDPMTrainer(JGaussianDiffusion(model_apply, **DDPM_DIFF), params,
                     train_batch_size=4, train_lr=DDPM_LR, use_mesh=False,
                     results_folder=str(tmp_path))
    key = jax.random.PRNGKey(7)
    images = np.random.default_rng(3).random((5, 4, 8, 8, 3)).astype(
        np.float32)
    for x in images[:3]:
        j.state, _ = j.train_step(j.state, jnp.asarray(x), key)
    j.ckpt.save(1, jax.device_get(j.state))  # as Trainer.save_and_sample
    before = jax.device_get(j.state)
    losses, draws = [], []
    for i, x in enumerate(images[3:]):
        draws.append(jax_draws(key, 3 + i, x.shape, DDPM_DIFF["timesteps"]))
        j.state, loss = j.train_step(j.state, jnp.asarray(x), key)
        losses.append(float(loss))
    after = jax.device_get(j.state)

    net = Unet(**DDPM_UNET)
    trainer = Trainer(GaussianDiffusion(net, **DDPM_DIFF, device="cpu"), net,
                      train_batch_size=4, train_lr=DDPM_LR,
                      results_folder=str(tmp_path))
    assert trainer.load() == 3
    got = [float(trainer.train_step(torch.from_numpy(x),
                                    t=torch.from_numpy(t).long(),
                                    noise=torch.from_numpy(noise)))
           for x, (t, noise) in zip(images[3:], draws)]
    np.testing.assert_allclose(got, losses, rtol=RTOL)
    assert_moves(trainer.model.state_dict(),
                 ddpm_unet_state_from_jax(after.params),
                 ddpm_unet_state_from_jax(before.params), DDPM_LR, "params")
    # steps 3 and 4 are off the EMA's cadence of 10: it stays as loaded
    assert_moves(trainer.ema_model.state_dict(),
                 ddpm_unet_state_from_jax(after.ema_params), None, DDPM_LR,
                 "EMA")



def test_train_vqgan_resumes_a_jax_milestone(vqgan_jax, tmp_path, capsys):
    results = tmp_path / "res"
    shutil.copytree(vqgan_jax["root"], results)
    split = write_images(tmp_path)
    config = tmp_path / "config.json"
    config.write_text(json.dumps(VQ_TINY))
    out = train_vqgan.main([
        "--device", "cpu", "--config", str(config), "--split", str(split),
        "--data_path", str(tmp_path / "images"), "--results_folder",
        str(results), "--train_steps", "4", "--save_every", "2",
        "--resume", "-1"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()
    assert (results / "vqgan-2.pt").exists()
    again = VQGANTrainer(port_config(VQGANConfig, results, "vqgan"),
                         device="cpu")
    assert again.load() == 4 and again.opt_g.count == 2


def test_train_ddpm_resumes_a_jax_milestone(tmp_path, capsys):
    results = tmp_path / "res"
    write_images(tmp_path)
    jnet = JUnet(dim=8, dim_mults=(1, 2), channels=3, dtype=jnp.bfloat16)
    x0 = jnp.zeros((1, 16, 16, 3))
    params = fill(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x0,
                                 jnp.zeros((1,), jnp.int32)), 8)
    tx = j_ldm_optimizer(learning_rate=8e-5, weight_decay=0.0,
                         betas=(0.9, 0.99), max_grad_norm=1.0)
    state = JLDMState(step=jnp.asarray(2), params=params,
                      opt_state=optax_state(tx, params, 2, 9),
                      ema_params=fill(jax.eval_shape(
                          jnet.init, jax.random.PRNGKey(0), x0,
                          jnp.zeros((1,), jnp.int32)), 10))
    JCheckpointManager(results, prefix="model").save(
        1, jax.device_get(state))
    out = train_ddpm.main([
        "--device", "cpu", "--folder", str(tmp_path / "images"),
        "--results_folder", str(results), "--image_size", "16", "--dim",
        "8", "--dim_mults", "1", "2", "--timesteps", "20",
        "--sampling_timesteps", "3", "--train_batch_size", "4",
        "--num_samples", "4", "--save_and_sample_every", "2",
        "--train_num_steps", "4", "--resume", "-1"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert len(out["losses"]) == 2
    assert out["trainer"].optimizer.count == 4
    assert (results / "model-2.pt").exists()
