"""Port parity: unconditional, self-conditioned and immiscible Gaussian
diffusion (vqgan_tpu_torch/diffusion/gaussian.py with classes=None) and the
on-device auction (vqgan_tpu_torch/ops/assignment.py) against the JAX
package's.

A tiny DDPM U-Net (dim 8, mults (1, 2), 8 x 8 x 3 images, 2 heads x 16) in
fp32 on both sides, T = 20, pred_v, sigmoid betas, the JAX params filled
from a numpy seed and carried over with `ddpm_unet_state_from_jax`. The
JAX functions draw from PRNG keys; the tests compute those draws (t, the
noise, the self-conditioning coin, the samplers' noise) and hand them to
the port as tensors.

- `auction_assignment` on random [b, b] costs, b in {1, 2, 16, 64}: the
  same permutation as JAX's; with tied rows, both permutations and their
  costs equal to 1e-6 relative; the iteration cap and its greedy fix-up.
- Immiscible noise: "host" (scipy's exact assignment) costs no more than
  JAX's assignment (+1e-5 relative); "auction" picks JAX's permutation.
- `p_losses` and `loss` with classes=None, with and without
  self-conditioning (both coin values) and with immiscible noise: losses
  to 1e-5 relative, every parameter's gradient within 1e-4 of the largest
  JAX gradient.
- `ddim_sample` and `p_sample_loop` with self-conditioning, from JAX's
  draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vqgan_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from vqgan_tpu.diffusion.gaussian import _immiscible_assignment
from vqgan_tpu.models.unet import Unet as JUnet
from vqgan_tpu.ops.assignment import auction_assignment as j_auction
from vqgan_tpu_torch.checkpoint import ddpm_unet_state_from_jax
from vqgan_tpu_torch.diffusion import GaussianDiffusion
from vqgan_tpu_torch.diffusion.gaussian import immiscible_permutation
from vqgan_tpu_torch.models import Unet
from vqgan_tpu_torch.ops.assignment import auction_assignment

torch.set_num_threads(2)

UNET = dict(dim=8, dim_mults=(1, 2), channels=3, attn_heads=2,
            attn_dim_head=16)
DIFF = dict(image_size=8, channels=3, timesteps=20, sampling_timesteps=5,
            objective="pred_v", beta_schedule="sigmoid",
            ddim_sampling_eta=0.0, auto_normalize=True)
B = 4
SHAPE = (B, 8, 8, 3)


def random_params(module, seed=0):
    x = jnp.zeros((1, 8, 8, 3))
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x,
                            jnp.zeros((1,), jnp.int32))
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


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain", "self_cond"])
def models(request):
    self_condition = request.param
    jnet = JUnet(**UNET, self_condition=self_condition)
    params = random_params(jnet)

    def model_apply(p, x, t, x_self_cond=None, return_features=False):
        return jnet.apply(p, x, t, x_self_cond,
                          return_features=return_features)

    net = Unet(**UNET, self_condition=self_condition)
    net.load_state_dict(ddpm_unet_state_from_jax(params))
    return self_condition, model_apply, params, net


def pair(models, **kw):
    self_condition, model_apply, params, net = models
    kw = {**DIFF, "self_condition": self_condition, **kw}
    return (JGaussianDiffusion(model_apply, **kw), params,
            GaussianDiffusion(net, **kw, device="cpu"))


def cost(dist, perm):
    return float(np.asarray(dist, np.float64)[np.arange(len(perm)),
                                              np.asarray(perm)].sum())


# --- the auction ------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 2, 7, 16, 64])
def test_auction_matches_jax(b):
    """Most auctions end inside a block of b bids, so the masked bids after
    the last assignment run here too and must change nothing."""
    dist = np.random.default_rng(b).standard_normal((b, b)).astype(
        np.float32) ** 2
    want = np.asarray(j_auction(jnp.asarray(dist)))
    got = auction_assignment(torch.from_numpy(dist))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(np.sort(got.numpy()), np.arange(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_auction_with_tied_rows_matches_jax_cost():
    rng = np.random.default_rng(11)
    rows = rng.random((4, 12)).astype(np.float32)
    dist = np.repeat(rows, 3, axis=0)  # 12 rows, each three times
    want = np.asarray(j_auction(jnp.asarray(dist)))
    got = auction_assignment(torch.from_numpy(dist)).numpy()
    np.testing.assert_array_equal(np.sort(got), np.arange(12))
    np.testing.assert_array_equal(np.sort(want), np.arange(12))
    assert cost(dist, got) == pytest.approx(cost(dist, want), rel=1e-6)


@pytest.mark.parametrize("max_iters", [0, 5])
def test_auction_cap_and_fixup_match_jax(max_iters):
    """At the cap the greedy fix-up completes a permutation, as in JAX."""
    dist = np.random.default_rng(3).random((16, 16)).astype(np.float32)
    want = np.asarray(j_auction(jnp.asarray(dist), max_iters=max_iters))
    got = auction_assignment(torch.from_numpy(dist),
                             max_iters=max_iters).numpy()
    np.testing.assert_array_equal(np.sort(got), np.arange(16))
    np.testing.assert_array_equal(got, want)


# --- immiscible noise -------------------------------------------------------


def immiscible_inputs(seed=6, b=16):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (b, 8, 8, 3)).astype(np.float32)
    noise = rng.standard_normal((b, 8, 8, 3)).astype(np.float32)
    return x, noise


def sq_dist(x, noise):
    xf = x.reshape(len(x), -1).astype(np.float64)
    nf = noise.reshape(len(noise), -1).astype(np.float64)
    return ((xf[:, None] - nf[None]) ** 2).sum(-1)


def test_immiscible_host_costs_no_more_than_jax():
    x, noise = immiscible_inputs()
    j_noise = np.asarray(_immiscible_assignment(jnp.asarray(x),
                                                jnp.asarray(noise), "host"))
    perm = immiscible_permutation(torch.from_numpy(x),
                                  torch.from_numpy(noise), "host").numpy()
    np.testing.assert_array_equal(np.sort(perm), np.arange(len(x)))
    dist = sq_dist(x, noise)
    j_cost = float(((x - j_noise) ** 2).sum())
    assert cost(dist, perm) <= j_cost * (1 + 1e-5)
    # and it beats the identity matching
    assert cost(dist, perm) < np.trace(dist)


def test_immiscible_auction_matches_jax():
    x, noise = immiscible_inputs(seed=7)
    j_noise = np.asarray(_immiscible_assignment(
        jnp.asarray(x), jnp.asarray(noise), "auction"))
    perm = immiscible_permutation(torch.from_numpy(x),
                                  torch.from_numpy(noise), "auction")
    np.testing.assert_array_equal(noise[perm.numpy()], j_noise)


# --- the loss ---------------------------------------------------------------


def coin_keys():
    """Two keys whose p_losses coin (uniform(split(key, 3)[2]) < 0.5) is
    True and False."""
    found = {}
    for s in range(20):
        key = jax.random.PRNGKey(s)
        k_drop = jax.random.split(key, 3)[2]
        found.setdefault(bool(jax.random.uniform(k_drop, ()) < 0.5), key)
    return found


def loss_inputs(seed=8):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    noise = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.array([0, 5, 13, 19], np.int32)
    return x, noise, t


def grads_close(net, j_grads):
    want = ddpm_unet_state_from_jax(jax.tree.map(np.asarray, j_grads))
    size = max(float(np.abs(v.numpy()).max()) for v in want.values())
    for name, p in net.named_parameters():
        # fp32 backward through ~20 layers in other summation orders
        torch.testing.assert_close(p.grad, want[name], rtol=0,
                                   atol=1e-4 * size,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("coin", [True, False])
@pytest.mark.parametrize("immiscible", [False, True])
def test_p_losses_and_gradients_match_jax(models, coin, immiscible):
    jd, params, td = pair(models, immiscible=immiscible,
                          immiscible_method="auction")
    key = coin_keys()[coin]
    x, noise, t = loss_inputs()
    j_loss, j_grads = jax.jit(jax.value_and_grad(lambda p: jd.p_losses(
        p, key, jnp.asarray(x), jnp.asarray(t), noise=jnp.asarray(noise))))(
        params)
    net = td.model.train()
    net.zero_grad(set_to_none=True)
    loss = td.p_losses(x, torch.from_numpy(t).long(), noise=noise,
                       self_cond_coin=torch.tensor(coin))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    grads_close(net, j_grads)


def test_loss_matches_jax_from_its_draws(models):
    jd, params, td = pair(models)
    key = jax.random.PRNGKey(12)
    rng = np.random.default_rng(9)
    img = rng.random(SHAPE).astype(np.float32)
    j_loss = float(jax.jit(lambda p: jd.loss(p, key, jnp.asarray(img)))(
        params))
    k_t, k_p = jax.random.split(key)
    t = np.array(jax.random.randint(k_t, (B,), 0, DIFF["timesteps"]))
    k_noise, _, k_drop = jax.random.split(k_p, 3)
    noise = np.array(jax.random.normal(k_noise, SHAPE, jnp.float32))
    coin = bool(jax.random.uniform(k_drop, ()) < 0.5)
    with torch.no_grad():
        loss = td.loss(img, t=torch.from_numpy(t).long(), noise=noise,
                       self_cond_coin=coin)
    np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-5)


def test_self_condition_draws_its_coin_from_the_generator(models):
    """With self-conditioning the coin decides the loss and comes from the
    generator when not given; without it the coin changes nothing."""
    self_condition, _, _, _ = models
    _, _, td = pair(models)
    x, noise, t = loss_inputs()
    tt = torch.from_numpy(t).long()
    with torch.no_grad():
        both = {c: td.p_losses(x, tt, noise=noise, self_cond_coin=c).item()
                for c in (True, False)}
        drawn = [td.p_losses(x, tt, noise=noise,
                             generator=torch.Generator().manual_seed(s))
                 .item() for s in range(8)]
    assert set(drawn) == set(both.values())
    assert (both[True] != both[False]) == self_condition


# --- the samplers -----------------------------------------------------------


def test_ddim_sample_matches_jax(models):
    jd, params, td = pair(models)
    rng = np.random.default_rng(10)
    init = rng.standard_normal(SHAPE).astype(np.float32)
    steps = rng.standard_normal((5, *SHAPE)).astype(np.float32)
    j_img = jax.jit(lambda p: jd.ddim_sample(
        p, jax.random.PRNGKey(0), SHAPE, None, init_noise=init,
        step_noise=steps))(params)
    t_img = td.ddim_sample(SHAPE, None, init_noise=init, step_noise=steps)
    assert t_img.shape == SHAPE
    # 5 fp32 steps, each x_start clipped (the CFG chain's tolerance,
    # tests/test_torch_port_samplers.py)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-4)


def test_p_sample_loop_matches_jax_from_its_draws(models):
    jd, params, td = pair(models, sampling_timesteps=None)
    key = jax.random.PRNGKey(5)
    j_img = jax.jit(lambda p: jd.p_sample_loop(p, key, SHAPE))(params)
    k_init, k = jax.random.split(key)
    init = np.asarray(jax.random.normal(k_init, SHAPE, jnp.float32))
    steps = []
    for _ in range(DIFF["timesteps"]):
        k, kn = jax.random.split(k)
        steps.append(np.asarray(jax.random.normal(kn, SHAPE, jnp.float32)))
    t_img = td.p_sample_loop(SHAPE, None, init_noise=init,
                             step_noise=np.stack(steps))
    assert t_img.shape == SHAPE
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-4)


def test_sample_is_unconditional_ddim(models):
    _, _, td = pair(models)
    got = td.sample(batch_size=B, generator=torch.Generator().manual_seed(3))
    want = td.ddim_sample(SHAPE, None,
                          generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
