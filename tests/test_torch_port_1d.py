"""Port parity: the 1-D stack, `Unet1D` (vqgan_tpu_torch/models/unet1d.py)
and `GaussianDiffusion1D` / `Dataset1D` (vqgan_tpu_torch/diffusion/
gaussian_1d.py), against the JAX package's.

A tiny Unet1D (dim 8, mults (1, 2), 2 heads x 8, sequences of 16 x 3) in
fp32 on both sides, its JAX params filled from a numpy seed and carried
over with `unet1d_state_from_jax`; T = 6, pred_v. The JAX loss and
samplers draw from PRNG keys; the tests replay the key splits and hand the
draws to the port.

Tolerances: module outputs 1e-5 of the largest JAX value, losses 1e-4
relative and absolute, gradients 1e-4 of the largest JAX gradient, samplers
of 3-6 model steps 1e-3 (absolute, on outputs in [0, 1]).

- Unet1D: plain, self-conditioned, learned variance with learned
  sinusoidal time, random Fourier features; gradients; the dropout switch.
- GaussianDiffusion1D: the loss from JAX's draws with gradients, on
  [B, L, C] and on channel-first [B, C, L] data; DDIM and the ancestral
  sampler from JAX's draws; `sample`'s layout.
- `Dataset1D` through the DDPM `Trainer`: one step against JAX's loss, and
  a short run with milestones (checkpoints, no image grid).
"""

import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vqgan_tpu.diffusion.gaussian_1d import Dataset1D as JDataset1D
from vqgan_tpu.diffusion.gaussian_1d import (
    GaussianDiffusion1D as JGaussianDiffusion1D,
)
from vqgan_tpu.models.unet1d import Unet1D as JUnet1D
from vqgan_tpu_torch.checkpoint import unet1d_state_from_jax
from vqgan_tpu_torch.diffusion import Dataset1D, GaussianDiffusion1D
from vqgan_tpu_torch.models import Unet1D
from vqgan_tpu_torch.training.ddpm_trainer import Trainer

torch.set_num_threads(2)

UNET = dict(dim=8, dim_mults=(1, 2), channels=3, attn_heads=2,
            attn_dim_head=8)
B, L, C = 4, 16, 3
SHAPE = (B, L, C)
T = 6
DIFF = dict(image_size=L, seq_length=L, channels=C, timesteps=T,
            objective="pred_v")


def fill(shapes, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for path, sds in flatten_dict(shapes).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "kernel":
            n /= np.sqrt(np.prod(sds.shape[:-1]))
        elif path[-1] == "g":
            n = 1.0 + 0.05 * n
        elif path[-1] == "bias":
            n *= 0.05
        out[path] = n
    return unflatten_dict(out)


def unet_pair(seed=0, **kw):
    kw = {**UNET, **kw}
    jnet = JUnet1D(**kw)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, L, C)), jnp.zeros((1,)))
    params = fill(shapes, seed)
    net = Unet1D(**kw)
    net.load_state_dict(unet1d_state_from_jax(params))
    return jnet, params, net


def ncl(x):
    return torch.from_numpy(np.ascontiguousarray(x)).transpose(1, 2)


def grads_close(net, j_grads):
    want = unet1d_state_from_jax(jax.tree.map(np.asarray, j_grads))
    size = max(float(v.abs().max()) for v in want.values())
    for name, p in net.named_parameters():
        torch.testing.assert_close(p.grad, want[name], rtol=0,
                                   atol=1e-4 * size,
                                   msg=lambda m: f"{name}: {m}")


# --- Unet1D ------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, dict(self_condition=True),
    dict(learned_variance=True, learned_sinusoidal_cond=True),
    dict(random_fourier_features=True, init_dim=12)],
    ids=["plain", "self_cond", "learned_variance", "random_fourier"])
def test_unet1d_matches_jax(kw):
    jnet, params, net = unet_pair(**kw)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    sc = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.array([0.0, 3.0, 250.0, 999.0], np.float32)
    args = (jnp.asarray(sc),) if kw.get("self_condition") else ()
    j = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x),
                                       jnp.asarray(t), *args))
    with torch.no_grad():
        p = net(ncl(x), torch.from_numpy(t),
                *((ncl(sc),) if args else ())).transpose(1, 2).numpy()
    assert p.shape == j.shape
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-5 * np.abs(j).max())


def test_unet1d_gradients_match_jax():
    jnet, params, net = unet_pair(seed=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    target = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.array([1, 40, 500, 900], np.float32)

    def j_loss(p):
        return jnp.mean((jnet.apply(p, jnp.asarray(x), jnp.asarray(t))
                         - target) ** 2)

    j_val, j_grads = jax.jit(jax.value_and_grad(j_loss))(params)
    loss = ((net(ncl(x), torch.from_numpy(t)) - ncl(target)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=1e-4,
                               atol=1e-4)
    grads_close(net, j_grads)


def test_unet1d_dropout_follows_the_caller():
    _, _, net = unet_pair(seed=4, dropout=0.5)
    x = ncl(np.random.default_rng(5).standard_normal(SHAPE).astype(
        np.float32))
    t = torch.tensor([1.0, 2.0, 3.0, 4.0])
    with torch.no_grad():
        a = net(x, t)
        net.train()  # train mode alone does not turn dropout on
        b = net(x, t)
        torch.manual_seed(0)
        d = net(x, t, deterministic=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (d - a).abs().max() > 1e-3


# --- GaussianDiffusion1D -----------------------------------------------------


def pair(seed=6, **kw):
    jnet, params, net = unet_pair(seed=seed)
    kw = {**DIFF, **kw}

    def model_apply(p, x, t, return_features=False):
        return jnet.apply(p, x, t)  # the JAX Unet1D has no features

    return (JGaussianDiffusion1D(model_apply, **kw),
            params, GaussianDiffusion1D(net, **kw, device="cpu"))


def loss_draws(key):
    """GaussianDiffusion1D.loss's draws: k_t, k_p = split(key); t from
    k_t; the noise from the first of split(k_p, 3), on [B, L, C]."""
    k_t, k_p = jax.random.split(key)
    t = np.array(jax.random.randint(k_t, (B,), 0, T))
    noise = np.array(jax.random.normal(jax.random.split(k_p, 3)[0], SHAPE,
                                       jnp.float32))
    return t, noise


@pytest.mark.parametrize("channel_first_data", [False, True])
def test_loss_and_gradients_match_jax_from_its_draws(channel_first_data):
    jd, params, td = pair(channel_first_data=channel_first_data)
    seq = np.random.default_rng(7).random(SHAPE).astype(np.float32)
    if channel_first_data:
        seq = np.ascontiguousarray(seq.transpose(0, 2, 1))
    key = jax.random.PRNGKey(8)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jd.loss(p, key, jnp.asarray(seq))))(params)
    t, noise = loss_draws(key)
    loss = td.loss(seq, t=torch.from_numpy(t).long(), noise=noise)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4,
                               atol=1e-4)
    grads_close(td.model, j_grads)


@pytest.mark.parametrize("sampling_timesteps", [3, None],
                         ids=["ddim", "ancestral"])
@pytest.mark.parametrize("channel_first_data", [False, True])
def test_samplers_match_jax_from_their_draws(sampling_timesteps,
                                             channel_first_data):
    jd, params, td = pair(sampling_timesteps=sampling_timesteps,
                          channel_first_data=channel_first_data)
    key = jax.random.PRNGKey(9)
    j_seq = np.asarray(jax.jit(lambda p: jd.sample(p, key, B))(params))
    k_init, k = jax.random.split(key)
    init = np.array(jax.random.normal(k_init, SHAPE, jnp.float32))
    steps = []
    for _ in range(sampling_timesteps or T):
        k, kn = jax.random.split(k)
        steps.append(np.array(jax.random.normal(kn, SHAPE, jnp.float32)))
    fn = td.ddim_sample if sampling_timesteps else td.p_sample_loop
    t_seq = fn(SHAPE, None, init_noise=init, step_noise=np.stack(steps))
    assert t_seq.shape == SHAPE
    if channel_first_data:  # `sample` hands back the data's layout
        t_seq = t_seq.transpose(1, 2)
    np.testing.assert_allclose(t_seq.numpy(), j_seq, atol=1e-3)
    # `sample` is that sampler from a generator, in the data's layout
    got = td.sample(batch_size=2, generator=torch.Generator().manual_seed(1))
    want = fn((2, L, C), None, generator=torch.Generator().manual_seed(1))
    if channel_first_data:
        want = want.transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- Dataset1D through the trainer -------------------------------------------


def test_dataset1d_matches_jax_and_feeds_the_trainer():
    data = np.random.default_rng(10).random((12, L, C)).astype(np.float32)
    ours, theirs = Dataset1D(data), JDataset1D(data)
    assert len(ours) == len(theirs) == 12
    for i in (0, 11):
        np.testing.assert_array_equal(ours[i][0], theirs[i][0])
        assert ours[i][1] == theirs[i][1] == 0

    jd, params, td = pair(seed=11)
    key = jax.random.PRNGKey(12)
    j_loss = float(jax.jit(lambda p: jd.loss(p, key, jnp.asarray(
        data[:B])))(params))
    t, noise = loss_draws(key)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(td, td.model, train_batch_size=B, num_samples=4,
                          train_num_steps=4, save_and_sample_every=2,
                          results_folder=tmp, dataset=ours)
        loss = trainer.train_step(torch.from_numpy(data[:B]),
                                  t=torch.from_numpy(t).long(), noise=noise)
        np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-4, atol=1e-4)
        log = trainer.train(log_every=2)
        files = sorted(p.name for p in Path(tmp).iterdir())
    assert len(log["losses"]) == 3 and np.isfinite(log["losses"]).all()
    assert trainer.state.step == 4
    # milestone 2 (step 4) is saved; 1-D samples make no image grid
    assert "model-2.pt" in files and not any(
        f.endswith(".png") for f in files)
