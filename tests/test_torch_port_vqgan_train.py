"""Port parity: stage-1 VQ-GAN training (vqgan_tpu_torch/training/
vqgan_step.py, vqgan_trainer.py, train_vqgan.py) against the JAX package.

A tiny config in fp32 on both sides (VQ-VAE ch 16, mults 1-2, 1 res block,
32 px, codebook 8 x 16; PatchGAN ndf 8, 2 layers, BatchNorm; LPIPS at its
fixed widths), JAX variables filled from a numpy seed and carried into the
port with `checkpoint/from_jax.py`.

- Three steps against JAX `make_vqgan_split_steps` with disc_start 1: step
  0 is G only, steps 1-2 G + D. Every logged loss, the discriminator left
  untouched by the G-only step, and after three steps the parameter moves
  and BatchNorm running statistics.
- The adaptive-weight branch against JAX.
- The optimizers against optax with clipping and gradient accumulation 2.
- `python -m vqgan_tpu_torch.train_vqgan --device cpu` on a tiny PIL image
  folder: milestones on and off the save cadence, the reconstruction grid,
  the revival cadence, and resume to the final step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from PIL import Image

from vqgan_tpu.models import VQVAE as JVQVAE
from vqgan_tpu.models.discriminator import PatchGANDiscriminator as JPatchGAN
from vqgan_tpu.models.lpips import LPIPS as JLPIPS
from vqgan_tpu.models.lpips import perceptual_loss_fn as j_perceptual_fn
from vqgan_tpu.training.vqgan_step import VQGANTrainState as JState
from vqgan_tpu.training.vqgan_step import make_gan_optimizers as j_gan_opts
from vqgan_tpu.training.vqgan_step import (
    make_vqgan_split_steps as j_split_steps,
)
from vqgan_tpu_torch.checkpoint import (
    CheckpointManager,
    lpips_state_from_jax,
    patchgan_state_from_jax,
    vqvae_state_from_jax,
)
from vqgan_tpu_torch.models import LPIPS, VQVAE, PatchGANDiscriminator
from vqgan_tpu_torch.models.lpips import perceptual_loss_fn
from vqgan_tpu_torch.training import (
    VQGANTrainState,
    make_gan_optimizers,
    make_vqgan_split_steps,
)

torch.set_num_threads(2)

VQ = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, resolution=32,
          z_channels=16, num_embeddings=8, embedding_dim=16)
DISC = dict(ndf=8, n_layers=2, norm="batch")
B, LR = 2, 4.5e-5  # VQGANConfig's learning rate
# fp32 forward and backward through VQ-VAE, LPIPS and PatchGAN in other
# summation orders (measured: 6e-6 relative at most)
LOSS_RTOL = 1e-4
# Parameter moves. Adam's first steps are sign-like (m / sqrt(v) is +-1 for
# a lone gradient), so an element whose gradient is near zero moves by
# about lr one way on one side and the other way on the other; conv biases
# under GroupNorm and attention key biases have a gradient of exactly 0 in
# exact arithmetic, rounding noise in practice. So: the moves agree to
# 5% of lr in all but 1% of the elements, and the move difference is at
# most 5% of the move in norm (measured: 0.3% of the VQ-VAE's elements,
# 1.0% in norm; the discriminator's all agree). A side whose optimizer
# never stepped is 100% off in norm.
MOVE_ATOL = 0.05 * LR
MOVE_MISS = 0.01
MOVE_NORM = 0.05
STATS_ATOL = 1e-5


def fill(shapes_tree, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for path, sds in flatten_dict(shapes_tree).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "kernel":
            n /= np.sqrt(np.prod(sds.shape[:-1]))
        elif path[-1] == "scale":
            n = 1.0 + 0.05 * n
        elif path[-1] in ("bias", "mean"):
            n *= 0.05
        elif path[-1] == "var":
            n = np.ones_like(n)
        out[path] = n
    return unflatten_dict(out)


def batches(n_steps=3, seed=1):
    return np.random.default_rng(seed).random((n_steps, B, 32, 32, 3)).astype(
        np.float32)


class JaxSide:
    """The JAX package's models and split steps on the tiny config."""

    def __init__(self, disc_start=1, use_adaptive_weight=False,
                 perceptual=True):
        x0 = jnp.zeros((1, 32, 32, 3))
        self.vqvae = JVQVAE(**VQ)
        self.disc = JPatchGAN(**DISC)
        self.lpips = JLPIPS()
        self.vq_params = fill(jax.eval_shape(
            self.vqvae.init, jax.random.PRNGKey(0), x0), seed=0)
        disc_vars = fill(dict(jax.eval_shape(
            self.disc.init, jax.random.PRNGKey(1), x0)), seed=1)
        self.disc_params = {"params": disc_vars["params"]}
        self.disc_stats = {"batch_stats": disc_vars["batch_stats"]}
        self.lpips_params = fill(jax.eval_shape(
            self.lpips.init, jax.random.PRNGKey(2), x0, x0), seed=2)
        disc = self.disc

        def vqvae_apply(params, images):
            return self.vqvae.apply(params, images)

        def disc_apply(params, stats, images, train):
            if train:
                logits, upd = disc.apply({**params, **stats}, images,
                                         train=True, mutable=["batch_stats"])
                return logits, {"batch_stats": upd["batch_stats"]}
            return disc.apply({**params, **stats}, images, train=False), stats

        self.opt_g, self.opt_d = j_gan_opts(learning_rate=LR,
                                            disc_learning_rate=LR)
        self.g_step, self.d_step = j_split_steps(
            vqvae_apply, disc_apply, self.opt_g, self.opt_d,
            disc_start=disc_start,
            perceptual_fn=(j_perceptual_fn(self.lpips_params, self.lpips)
                           if perceptual else None),
            use_adaptive_weight=use_adaptive_weight, donate=False)

    def state(self):
        return JState(step=jnp.asarray(0), vqvae_params=self.vq_params,
                      disc_params=self.disc_params,
                      disc_stats=self.disc_stats,
                      opt_g=self.opt_g.init(self.vq_params),
                      opt_d=self.opt_d.init(self.disc_params))

    def port(self, disc_start=1, use_adaptive_weight=False, perceptual=True):
        """The port's state and steps from the same variables."""
        vqvae = VQVAE(**VQ)
        vqvae.load_state_dict(vqvae_state_from_jax(self.vq_params))
        disc = PatchGANDiscriminator(**DISC)
        disc.load_state_dict(patchgan_state_from_jax(
            {**self.disc_params, **self.disc_stats}))
        lpips = LPIPS()
        lpips.load_state_dict(lpips_state_from_jax(self.lpips_params))
        lpips.eval().requires_grad_(False)
        opt_g, opt_d = make_gan_optimizers(
            vqvae.parameters(), disc.parameters(), learning_rate=LR,
            disc_learning_rate=LR)
        steps = make_vqgan_split_steps(
            disc_start=disc_start,
            perceptual_fn=perceptual_loss_fn(lpips) if perceptual else None,
            use_adaptive_weight=use_adaptive_weight)
        return VQGANTrainState(0, vqvae, disc, opt_g, opt_d), steps


@pytest.fixture(scope="module")
def jax_side():
    return JaxSide()


@pytest.fixture(scope="module")
def three_steps(jax_side):
    """Both sides through steps 0 (G), 1 and 2 (G + D) on the same images."""
    data = batches()
    j_state, j_logs = jax_side.state(), []
    for i in range(3):
        j_state, recon, log = jax_side.g_step(j_state, jnp.asarray(data[i]))
        if i >= 1:
            j_state, d_log = jax_side.d_step(j_state, jnp.asarray(data[i]),
                                             recon)
            log = {**log, **d_log}
        j_logs.append(jax.tree.map(np.asarray, log))

    state, (g_step, d_step) = jax_side.port()
    disc_init = {k: v.clone() for k, v in state.disc.state_dict().items()}
    logs, disc_after_g = [], None
    for i in range(3):
        images = torch.from_numpy(data[i])
        recon, log = g_step(state, images)
        if i == 0:
            disc_after_g = {k: v.clone()
                            for k, v in state.disc.state_dict().items()}
            no_grad = all(p.grad is None for p in state.disc.parameters())
        if i >= 1:
            log.update(d_step(state, images, recon))
        logs.append(log)
    return dict(j_state=j_state, j_logs=j_logs, state=state, logs=logs,
                disc_init=disc_init, disc_after_g=disc_after_g,
                no_grad=no_grad)


def test_step_losses_match_jax(three_steps):
    for i, (log, j_log) in enumerate(zip(three_steps["logs"],
                                         three_steps["j_logs"])):
        assert set(log) == set(j_log), i
        np.testing.assert_array_equal(log["usage_counts"].numpy(),
                                      j_log["usage_counts"])
        for key, value in log.items():
            if key != "usage_counts":
                np.testing.assert_allclose(value.item(), float(j_log[key]),
                                           rtol=LOSS_RTOL, atol=1e-7,
                                           err_msg=f"step {i}: {key}")
    assert "d_loss" not in three_steps["logs"][0]
    assert three_steps["logs"][0]["disc_weight"].item() == 0.0
    assert three_steps["logs"][2]["disc_weight"].item() == pytest.approx(0.1)


def test_g_step_reads_the_discriminator_frozen(three_steps):
    # the G-only step 0 changed neither D's weights nor its BN statistics,
    # and no gradient reached D
    for name, value in three_steps["disc_init"].items():
        torch.testing.assert_close(three_steps["disc_after_g"][name], value,
                                   rtol=0, atol=0, msg=name)
    assert three_steps["no_grad"]


def test_parameter_moves_and_bn_stats_match_jax(three_steps, jax_side):
    state, j_state = three_steps["state"], three_steps["j_state"]
    assert state.step == int(j_state.step) == 3
    assert state.opt_g.count == 3 and state.opt_d.count == 2
    checks = (
        ("vqvae", state.vqvae, vqvae_state_from_jax(
            jax.tree.map(np.asarray, j_state.vqvae_params)),
         vqvae_state_from_jax(jax_side.vq_params)),
        ("disc", state.disc, patchgan_state_from_jax(jax.tree.map(
            np.asarray, {**j_state.disc_params, **j_state.disc_stats})),
         patchgan_state_from_jax({**jax_side.disc_params,
                                  **jax_side.disc_stats})),
    )
    for label, module, want, init in checks:
        moves, want_moves = [], []
        for name, value in module.state_dict().items():
            if "running" in name:  # BatchNorm statistics: no Adam in them
                torch.testing.assert_close(value, want[name], rtol=0,
                                           atol=STATS_ATOL, msg=name)
            else:
                moves.append((value - init[name]).flatten())
                want_moves.append((want[name] - init[name]).flatten())
        moves, want_moves = torch.cat(moves), torch.cat(want_moves)
        diff = moves - want_moves
        assert want_moves.abs().max() > 0.5 * LR, label
        assert (diff.abs() > MOVE_ATOL).float().mean() <= MOVE_MISS, label
        assert diff.norm() <= MOVE_NORM * want_moves.norm(), label


def test_adaptive_weight_branch_matches_jax():
    side = JaxSide(disc_start=0, use_adaptive_weight=True, perceptual=False)
    data = batches(1, seed=4)[0]
    _, _, j_log = side.g_step(side.state(), jnp.asarray(data))
    state, (g_step, _) = side.port(disc_start=0, use_adaptive_weight=True,
                                   perceptual=False)
    _, log = g_step(state, torch.from_numpy(data))
    # 0.1 x the adaptive weight
    assert log["disc_weight"].item() != pytest.approx(0.1)
    for key in ("disc_weight", "g_loss", "total_loss", "loss_total"):
        np.testing.assert_allclose(log[key].item(), float(j_log[key]),
                                   rtol=LOSS_RTOL, err_msg=key)


def test_optimizers_match_optax_with_clipping_and_accumulation():
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 3), "b": (5,)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    kw = dict(learning_rate=1e-2, disc_learning_rate=2e-2, betas=(0.5, 0.9),
              max_grad_norm=1.0, gradient_accumulate_every=2)
    j_opts = j_gan_opts(**kw)
    t_params = [[torch.nn.Parameter(torch.from_numpy(v.copy()))
                 for v in init.values()] for _ in range(2)]
    t_opts = make_gan_optimizers(t_params[0], t_params[1], **kw)
    for which in range(2):  # G, then D (its own learning rate)
        tx = j_opts[which]
        j_params = {k: jnp.asarray(v) for k, v in init.items()}
        j_state = tx.init(j_params)
        updated = []
        for i in range(6):
            scale = [0.3, 2.0, 0.5, 3.0, 0.2, 0.4][i]  # some calls clip
            grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                     for k, s in shapes.items()}
            upd, j_state = tx.update({k: jnp.asarray(v)
                                      for k, v in grads.items()},
                                     j_state, j_params)
            j_params = optax.apply_updates(j_params, upd)
            updated.append(t_opts[which].step(
                [torch.from_numpy(g) for g in grads.values()]))
            for t, key in zip(t_params[which], shapes):
                # elementwise fp32 Adam arithmetic
                np.testing.assert_allclose(t.detach().numpy(),
                                           np.asarray(j_params[key]),
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=f"{which} {i} {key}")
        assert updated == [False, True] * 3


def write_image_folder(root, users=3, per_user=6):
    """ID_1..ID_3 with per_user 40x40 JPGs and a split listing them all."""
    rng = np.random.default_rng(0)
    split = {"metadata": {}, "users": {}}
    for u in range(1, users + 1):
        names = [f"f{i:02d}.jpg" for i in range(per_user)]
        (root / f"ID_{u}").mkdir(parents=True)
        for name in names:
            Image.fromarray(rng.integers(0, 255, (40, 40, 3),
                                         dtype=np.uint8)).save(
                root / f"ID_{u}" / name)
        split["users"][f"ID_{u}"] = {"train_images": names,
                                     "test_images": []}
    (root / "split.json").write_text(json.dumps(split))
    return root / "split.json"


def test_train_vqgan_entry_point_saves_and_resumes(tmp_path, capsys):
    from vqgan_tpu_torch import train_vqgan

    split = write_image_folder(tmp_path / "data")
    config = tmp_path / "config.json"
    config.write_text(json.dumps(dict(
        num_users=3, images_per_user_train=6, ch=8, ch_mult=[1, 2],
        num_res_blocks=1, z_channels=8, num_embeddings=8, embedding_dim=8,
        disc_ndf=8, disc_n_layers=2, compute_dtype="float32",
        revive_dead_codes_every=2)))
    results = tmp_path / "vqgan"
    common = ["--device", "cpu", "--config", str(config), "--split",
              str(split), "--data_path", str(tmp_path / "data"),
              "--results_folder", str(results), "--image_size", "32",
              "--batch_size", "4", "--disc_start", "2", "--save_every", "3"]
    first = train_vqgan.main([*common, "--train_steps", "4"])
    ckpt = CheckpointManager(results, prefix="vqgan")
    # milestone 1 at step 3 (cadence), milestone 2 the off-cadence final save
    assert ckpt.all_milestones() == [1, 2] and ckpt.latest_milestone() == 2
    assert ckpt.restore(1)["step"] == 3 and ckpt.restore()["step"] == 4
    assert (results / "reconstruction-1.png").exists()
    with Image.open(results / "reconstruction-2.png") as grid:
        assert grid.size == (64, 4 * 32)  # [input | recon] per image
    assert len(first["losses"]) == 4 and all(np.isfinite(first["losses"]))
    assert first["timed_steps"] == 0 and first["images_per_s"] is None
    assert "[revive] step 2" in capsys.readouterr().out
    saved = ckpt.restore()
    assert set(saved) == {"step", "vqvae", "disc", "opt_g", "opt_d"}
    assert "main.3.running_var" in saved["disc"]
    assert saved["opt_d"]["count"] == 2  # D stepped at steps 2 and 3

    second = train_vqgan.main([*common, "--train_steps", "6",
                               "--resume", "-1"])
    trainer = second["trainer"]
    assert trainer.state.step == 6 and len(second["losses"]) == 2
    assert trainer.opt_g.count == 6 and trainer.opt_d.count == 4
    # step 6 is on the cadence: milestone 2 now holds it
    assert ckpt.all_milestones() == [1, 2] and ckpt.restore()["step"] == 6
    assert ckpt.load_config()["num_embeddings"] == 8
    assert trainer.load(1) == 3  # an explicit milestone still loads
