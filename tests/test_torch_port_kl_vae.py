"""Port parity: stage-1 KL-VAE training (vqgan_tpu_torch/models/
autoencoder.py `kl_vae_loss`, training/kl_vae_step.py, the warmup-cosine
schedule of training/ldm_step.py, train_kl_vae.py) against the JAX package
and optax.

A small KL-VAE (ch 32, mults 1-2, 1 res block, 32 px, z 4; attention in
the second level and the mid blocks) in fp32 on both sides, JAX params
filled from a numpy seed and carried into the port with
`klvae_state_from_jax`; LPIPS weights with `lpips_state_from_jax`. The
two sides cannot share a random stream, so the posterior noise is the same
numpy array on both: JAX composes the CLI's loss from `KLVAE.encode`,
mean + std * eps, `KLVAE.decode` and `kl_vae_loss`.

- `kl_vae_loss` with the MSE term and with the CLI's L1 + w * LPIPS term.
- One training step: loss parts and every parameter's gradient against
  `jax.value_and_grad`.
- Three steps of clip + Adam under the constant and the warmup-cosine
  schedule: the parameters against optax's chain on the same model, and
  the optimizer alone on set gradients.
- `lr_at` against `optax.warmup_cosine_decay_schedule` and the constant
  schedule at every count from 0 to steps + 1.
- `python -m vqgan_tpu_torch.train_kl_vae --device cpu`: milestones,
  logging, checkpoints that `generate.load_vae` reads.
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

from vqgan_tpu.models import KLVAE as JKLVAE
from vqgan_tpu.models import kl_vae_loss as j_kl_vae_loss
from vqgan_tpu.models.autoencoder import AutoencoderConfig as JConfig
from vqgan_tpu.models.autoencoder import DiagonalGaussian as JGaussian
from vqgan_tpu.models.lpips import LPIPS as JLPIPS
from vqgan_tpu_torch import generate, profile_kl_vae_train, train_kl_vae
from vqgan_tpu_torch.checkpoint import (
    CheckpointManager,
    klvae_state_from_jax,
    load_weights,
    lpips_state_from_jax,
)
from vqgan_tpu_torch.models import LPIPS
from vqgan_tpu_torch.models.autoencoder import (
    AutoencoderConfig,
    DiagonalGaussian,
    KLVAE,
    kl_vae_loss,
)
from vqgan_tpu_torch.training import (
    lpips_perceptual_fn,
    make_kl_vae_optimizer,
    make_kl_vae_train_step,
)

torch.set_num_threads(2)

CFG = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=32,
           z_channels=4)
B, S, LATENT = 2, 32, 16
# a KL weight large enough that the KL term's gradient shows beside the
# MSE's (the CLI default 1e-6 leaves it under the tolerance)
KL_WEIGHT = 1e-3
LPIPS_WEIGHT = 0.5
LR, TRAIN_STEPS = 1e-4, 3
# fp32 forward through ~15 layers (and VGG16 for LPIPS) in other summation
# orders: loss parts relative to themselves
LOSS_RTOL = 1e-5
# fp32 backward: relative to the largest gradient
GRAD_RTOL = 1e-4
# Parameter moves after three steps. Adam's first steps are sign-like
# (m / sqrt(v) is +-1 for a lone gradient), so an element whose gradient
# is rounding noise (conv biases under GroupNorm have a gradient of exactly
# 0 in exact arithmetic) moves by about lr either way on either side. So:
# the moves agree to 5% of lr in all but 1% of the elements, and differ by
# at most 5% of the move in norm. A side that skipped one of the three
# updates would be ~30% off in norm.
MOVE_ATOL, MOVE_MISS, MOVE_NORM = 0.05 * LR, 0.01, 0.05


def fill(shapes_tree, seed):
    """A parameter tree of these shapes from a numpy seed: fan-in scaled
    kernels, gains near 1, biases near 0 but not 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, sds in flatten_dict(shapes_tree).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "kernel":
            n /= np.sqrt(np.prod(sds.shape[:-1]))
        elif path[-1] == "scale":
            n = 1.0 + 0.05 * n
        elif path[-1] == "bias":
            n *= 0.05
        out[path] = n
    return unflatten_dict(out)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


class JaxSide:
    """The JAX KL-VAE and LPIPS on the small config, and the CLI's loss."""

    def __init__(self):
        x0 = jnp.zeros((1, S, S, 3))
        self.vae = JKLVAE(config=JConfig(**CFG))
        self.params = fill(jax.eval_shape(
            self.vae.init, {"params": jax.random.PRNGKey(0),
                            "gaussian": jax.random.PRNGKey(1)}, x0), seed=0)
        self.lpips = JLPIPS()
        self.lpips_params = fill(jax.eval_shape(
            self.lpips.init, jax.random.PRNGKey(2), x0, x0), seed=2)
        rng = np.random.default_rng(1)
        self.images = rng.random((3, B, S, S, 3)).astype(np.float32)
        self.eps = rng.standard_normal((3, B, LATENT, LATENT, 4)).astype(
            np.float32)
        self._grad = {}

    def perceptual_fn(self, recon, inputs):
        """cli/train_kl_vae.py's L1 + w * LPIPS."""
        p = jnp.mean(self.lpips.apply(self.lpips_params, recon * 2 - 1,
                                      inputs * 2 - 1))
        l1 = jnp.mean(jnp.abs(recon - inputs))
        return {"total": l1 + LPIPS_WEIGHT * p, "perceptual": p}

    def value_and_grad(self, perceptual: bool):
        """jit(value_and_grad) of the CLI's loss with injected eps."""
        if perceptual not in self._grad:
            vae, fn = self.vae, self.perceptual_fn if perceptual else None

            def loss_fn(p, images, eps):
                posterior = vae.apply(p, images, method=JKLVAE.encode)
                z = posterior.mean + posterior.std * eps
                recon = vae.apply(p, z, method=JKLVAE.decode)
                parts = j_kl_vae_loss(recon, images, posterior,
                                      kl_weight=KL_WEIGHT, perceptual_fn=fn)
                return parts["loss"], parts

            self._grad[perceptual] = jax.jit(
                jax.value_and_grad(loss_fn, has_aux=True))
        return self._grad[perceptual]

    def port(self, lr_schedule="constant", perceptual=False):
        """The port's model, optimizer and step from the same weights;
        the step's optimizer records each update's gradients before it
        clips them."""
        vae = KLVAE(AutoencoderConfig(**CFG))
        vae.load_state_dict(klvae_state_from_jax(self.params))
        fn = None
        if perceptual:
            lpips = LPIPS()
            lpips.load_state_dict(lpips_state_from_jax(self.lpips_params))
            fn = lpips_perceptual_fn(lpips.eval().requires_grad_(False),
                                     LPIPS_WEIGHT)
        opt = make_kl_vae_optimizer(vae.parameters(), LR, lr_schedule,
                                    TRAIN_STEPS)
        grads, update = [], opt.step

        def record(g, norm=None):
            grads.append([t.detach().clone() for t in g])
            return update(g, norm)

        opt.step = record
        step = make_kl_vae_train_step(vae, opt, kl_weight=KL_WEIGHT,
                                      perceptual_fn=fn)
        return vae, opt, step, grads


@pytest.fixture(scope="module")
def jax_side():
    return JaxSide()


@pytest.mark.parametrize("perceptual", [False, True], ids=["mse", "lpips"])
def test_kl_vae_loss_matches_jax(jax_side, perceptual):
    rng = np.random.default_rng(4)
    recon = rng.random((B, S, S, 3)).astype(np.float32)
    inputs = rng.random((B, S, S, 3)).astype(np.float32)
    # moments with logvar past the [-30, 20] clamp on both ends
    moments = rng.standard_normal((B, LATENT, LATENT, 8)).astype(np.float32)
    moments[0, 0, 0, 4:] = (-40.0, 25.0, 3.0, -2.0)
    want = j_kl_vae_loss(
        jnp.asarray(recon), jnp.asarray(inputs), JGaussian(
            jnp.asarray(moments)), kl_weight=KL_WEIGHT,
        perceptual_fn=jax_side.perceptual_fn if perceptual else None)
    fn = None
    if perceptual:
        lpips = LPIPS()
        lpips.load_state_dict(lpips_state_from_jax(jax_side.lpips_params))
        fn = lpips_perceptual_fn(lpips.eval(), LPIPS_WEIGHT)
    got = kl_vae_loss(nchw(recon), nchw(inputs),
                      DiagonalGaussian(nchw(moments)), kl_weight=KL_WEIGHT,
                      perceptual_fn=fn)
    assert set(got) == set(want) == {"loss", "rec_loss", "kl_loss",
                                     "perceptual_loss"}
    for key, value in got.items():
        assert value.ndim == 0, key
        np.testing.assert_allclose(value.item(), float(want[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    assert (got["perceptual_loss"].item() > 0) == perceptual


def test_posterior_sample_takes_injected_noise():
    rng = np.random.default_rng(5)
    moments = torch.from_numpy(rng.standard_normal((2, 8, 3, 3)).astype(
        np.float32))
    noise = rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
    posterior = DiagonalGaussian(moments)
    want = posterior.mean + posterior.std * torch.from_numpy(noise)
    torch.testing.assert_close(posterior.sample(noise=noise), want,
                               rtol=0, atol=0)
    gen = torch.Generator().manual_seed(0)
    drawn = posterior.sample(gen)
    again = posterior.sample(torch.Generator().manual_seed(0))
    torch.testing.assert_close(drawn, again, rtol=0, atol=0)


@pytest.mark.parametrize("perceptual", [False, True], ids=["mse", "lpips"])
def test_train_step_parts_and_gradients_match_jax(jax_side, perceptual):
    x, eps = jax_side.images[0], jax_side.eps[0]
    (_, j_parts), j_grads = jax_side.value_and_grad(perceptual)(
        jax_side.params, jnp.asarray(x), jnp.asarray(eps))
    vae, _, step, grads = jax_side.port(perceptual=perceptual)
    parts = step(torch.from_numpy(x), noise=nchw(eps))
    for key, value in parts.items():
        np.testing.assert_allclose(value.item(), float(j_parts[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    assert parts["kl_loss"].item() * KL_WEIGHT > 1e-3 * parts["loss"].item()

    want = klvae_state_from_jax(jax.tree.map(np.asarray, j_grads))
    names = [n for n, _ in vae.named_parameters()]
    assert len(grads) == 1 and len(grads[0]) == len(names) == len(want)
    largest = max(v.abs().max().item() for v in want.values())
    for name, g in zip(names, grads[0]):
        torch.testing.assert_close(g, want[name], rtol=0,
                                   atol=GRAD_RTOL * largest,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("lr_schedule", ["constant", "cosine"])
def test_three_steps_match_the_optax_chain(jax_side, lr_schedule):
    lr = (optax.warmup_cosine_decay_schedule(
        LR / 10, LR, max(1, TRAIN_STEPS // 20), TRAIN_STEPS, LR / 20)
        if lr_schedule == "cosine" else LR)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr))

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params = jax_side.params
    opt_state = tx.init(params)
    grad_fn = jax_side.value_and_grad(False)
    vae, opt, step, _ = jax_side.port(lr_schedule)
    for i in range(3):
        (_, j_parts), g = grad_fn(params, jnp.asarray(jax_side.images[i]),
                                  jnp.asarray(jax_side.eps[i]))
        params, opt_state = update(g, opt_state, params)
        parts = step(torch.from_numpy(jax_side.images[i]),
                     noise=nchw(jax_side.eps[i]))
        np.testing.assert_allclose(parts["loss"].item(),
                                   float(j_parts["loss"]), rtol=LOSS_RTOL,
                                   err_msg=f"step {i}")
    assert opt.count == 3
    init = klvae_state_from_jax(jax_side.params)
    want = klvae_state_from_jax(jax.tree.map(np.asarray, params))
    moves = torch.cat([(p.detach() - init[n]).flatten()
                       for n, p in vae.named_parameters()])
    want_moves = torch.cat([(want[n] - init[n]).flatten()
                            for n, _ in vae.named_parameters()])
    diff = moves - want_moves
    assert want_moves.abs().max() > 0.5 * LR
    assert (diff.abs() > MOVE_ATOL).float().mean() <= MOVE_MISS
    assert diff.norm() <= MOVE_NORM * want_moves.norm()


@pytest.mark.parametrize("lr_schedule", ["constant", "cosine"])
def test_optimizer_matches_optax_on_set_gradients(lr_schedule):
    # the chain alone, on gradients whose global norm is over and under
    # the clip: elementwise fp32 Adam arithmetic on both sides, but for
    # the bias corrections 1 - b^t, which optax forms in fp32 (1 - 0.999
    # loses 1.3e-5 of itself there) and the port in float64; so each
    # update may differ by ~1e-5 of lr, and six of them by 6e-5 of lr
    steps = 40  # warm-up 2 updates, cosine over 38
    lr = 1e-2
    atol = 6e-5 * lr
    schedule = (optax.warmup_cosine_decay_schedule(
        lr / 10, lr, max(1, steps // 20), steps, lr / 20)
        if lr_schedule == "cosine" else lr)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(schedule))
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 3), "b": (5,)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    j_state = tx.init(j_params)
    t_params = [torch.nn.Parameter(torch.from_numpy(v.copy()))
                for v in init.values()]
    opt = make_kl_vae_optimizer(t_params, lr, lr_schedule, steps)
    for i in range(6):
        scale = [0.3, 2.0, 0.5, 3.0, 0.2, 0.4][i]  # some updates clip
        grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        upd, j_state = tx.update({k: jnp.asarray(v) for k, v in
                                  grads.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        assert opt.step([torch.from_numpy(g) for g in grads.values()])
        for t, key in zip(t_params, shapes):
            np.testing.assert_allclose(t.detach().numpy(),
                                       np.asarray(j_params[key]), rtol=0,
                                       atol=atol, err_msg=f"{i} {key}")


@pytest.mark.parametrize("steps", [1, 2, 3, 19, 20, 41, 1000])
def test_lr_at_matches_optax_at_every_count(steps):
    lr = 4.5e-6
    params = [torch.nn.Parameter(torch.zeros(2))]
    constant = make_kl_vae_optimizer(params, lr, "constant", steps)
    assert [constant.lr_at(c) for c in range(steps + 2)] == \
        [lr] * (steps + 2)
    warmup = max(1, steps // 20)
    if steps <= warmup:  # no count is left for the cosine
        with pytest.raises(ValueError):
            optax.warmup_cosine_decay_schedule(lr / 10, lr, warmup, steps,
                                               lr / 20)
        with pytest.raises(ValueError, match="decay_steps"):
            make_kl_vae_optimizer(params, lr, "cosine", steps)
        return
    want = optax.warmup_cosine_decay_schedule(lr / 10, lr, warmup, steps,
                                              lr / 20)
    opt = make_kl_vae_optimizer(params, lr, "cosine", steps)
    got = [opt.lr_at(c) for c in range(steps + 2)]
    np.testing.assert_allclose(got, [float(want(c))
                                     for c in range(steps + 2)], rtol=1e-6)
    assert got[0] == pytest.approx(lr / 10)  # the first update
    assert got[warmup] == pytest.approx(lr)
    assert got[steps] == got[steps + 1] == pytest.approx(lr / 20)


def write_images(root, users=2, per_user=3, size=40):
    rng = np.random.default_rng(0)
    split = {"metadata": {}, "users": {}}
    for u in range(1, users + 1):
        names = [f"f{i:02d}.jpg" for i in range(per_user)]
        (root / f"ID_{u}").mkdir(parents=True)
        for name in names:
            Image.fromarray(rng.integers(0, 255, (size, size, 3),
                                         dtype=np.uint8)).save(
                root / f"ID_{u}" / name)
        split["users"][f"ID_{u}"] = {"train_images": names,
                                     "test_images": []}
    (root / "split.json").write_text(json.dumps(split))
    return root / "split.json"


def test_train_kl_vae_trains_logs_and_saves(tmp_path, capsys):
    split = write_images(tmp_path / "data")
    results = tmp_path / "kl_vae"
    args = train_kl_vae.parse_args([
        "--device", "cpu", "--data_path", str(tmp_path / "data"), "--split",
        str(split), "--results_folder", str(results), "--image_size", "16",
        "--batch_size", "2", "--train_steps", "50", "--save_every", "20",
        "--lr", "1e-3", "--lr_schedule", "cosine"])
    small = AutoencoderConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                              resolution=16)
    result = train_kl_vae.train(args, small)
    out = capsys.readouterr().out
    assert "step 50: loss=" in out and "done" in out
    assert len(result["losses"]) == 50 and np.isfinite(result["losses"]).all()
    for a, r, k in zip(result["losses"], result["rec_losses"],
                       result["kl_losses"]):
        assert a == pytest.approx(r + 1e-6 * k, rel=1e-6)
    assert result["losses"][-1] < result["losses"][0]
    assert result["timed_steps"] == 45 and result["images_per_s"] > 0
    assert result["peak_memory_bytes"] is None  # CPU

    ckpt = CheckpointManager(results, prefix="kl_vae")
    # milestones at steps 20 and 40; no save off the cadence, as in JAX
    assert ckpt.all_milestones() == [1, 2] and ckpt.latest_milestone() == 2
    assert set(ckpt.restore()) == {"model"}
    config = ckpt.load_config()
    assert config["save_every"] == 20 and config["lr_schedule"] == "cosine"
    assert config["autoencoder"]["ch_mult"] == [1, 2]
    loaded = load_weights(KLVAE(small), ckpt.path(1))
    assert not all(torch.equal(v, result["vae"].state_dict()[k])
                   for k, v in loaded.state_dict().items())


def test_train_kl_vae_default_model_loads_into_generate(tmp_path, capsys):
    split = write_images(tmp_path / "data", users=1, per_user=2)
    results = tmp_path / "kl_vae"
    result = train_kl_vae.main([
        "--device", "cpu", "--data_path", str(tmp_path / "data"), "--split",
        str(split), "--results_folder", str(results), "--image_size", "32",
        "--batch_size", "2", "--train_steps", "1", "--save_every", "1",
        "--perceptual_weight", "0.1"])
    assert "LPIPS running with random weights" in capsys.readouterr().out
    assert np.isfinite(result["losses"]).all()
    path = CheckpointManager(results, prefix="kl_vae").checked_path()
    vae = generate.load_vae(path, image_size=32, device="cpu")
    for k, v in vae.state_dict().items():
        torch.testing.assert_close(v, result["vae"].state_dict()[k],
                                   rtol=0, atol=0, msg=k)


def test_training_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_kl_vae.main(["--data_path", str(tmp_path), "--split",
                           str(tmp_path / "split.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_kl_vae_train.main([])
