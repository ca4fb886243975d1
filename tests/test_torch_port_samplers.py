"""Port parity: the samplers of GaussianDiffusion against the JAX package's.

A tiny CFG U-Net (dim 16, mults (1, 2), 2 heads x 16, 8x8x4 latents, 3
classes) in fp32 on both sides, T = 20, the JAX params filled from a numpy
seed and carried into the port with `cfg_unet_state_from_jax`. The JAX
samplers draw their noise from a PRNG key; the tests replay that key
stream with `jax.random.split` / `jax.random.normal` and hand the draws to
the port as tensors.

- CFG++ in `model_predictions` under all three objectives.
- `p_sample_loop` (the ancestral sampler) at cond_scale 1.0 and 3.0, and
  `sample` choosing it when sampling_timesteps == timesteps.
- `interpolate` at the default t (T - 1) and at t = 10.
- `return_all_timesteps` on both samplers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vqgan_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from vqgan_tpu.models import CFGUnet as JCFGUnet
from vqgan_tpu_torch.checkpoint.from_jax import cfg_unet_state_from_jax
from vqgan_tpu_torch.diffusion import GaussianDiffusion
from vqgan_tpu_torch.models import CFGUnet

torch.set_num_threads(2)

UNET = dict(dim=16, num_classes=3, cond_drop_prob=0.0, dim_mults=(1, 2),
            channels=4, attn_dim_head=16, attn_heads=2)
DIFF = dict(image_size=8, channels=4, timesteps=20, objective="pred_v",
            beta_schedule="cosine", auto_normalize=False)
B = 3
SHAPE = (B, 8, 8, 4)
CLASSES = np.array([0, 2, 1], np.int32)


def random_params(module, seed=0):
    """Parameter tree from jax.eval_shape, filled from a numpy seed."""
    x = jnp.zeros((1, 8, 8, 4))
    i = jnp.zeros((1,), jnp.int32)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x, i, i,
                            cond_drop_mask=jnp.zeros((1,), bool))
    rng = np.random.default_rng(seed)
    out = {}
    for path, sds in flatten_dict(shapes).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "kernel":
            n /= np.sqrt(np.prod(sds.shape[:-1]))
        elif path[-1] in ("scale", "g"):
            n = 1.0 + 0.05 * n
        elif path[-1] == "bias":
            n *= 0.05
        out[path] = n
    return unflatten_dict(out)


@pytest.fixture(scope="module")
def models():
    jnet = JCFGUnet(**UNET)
    params = random_params(jnet)

    def model_apply(p, x, t, classes, cond_drop_mask=None, **_):
        return jnet.apply(p, x, t, classes, cond_drop_mask=cond_drop_mask)

    tnet = CFGUnet(**UNET).eval()
    tnet.load_state_dict(cfg_unet_state_from_jax(params))
    return model_apply, params, tnet


def pair(models, **kw):
    model_apply, params, tnet = models
    return (JGaussianDiffusion(model_apply, **{**DIFF, **kw}), params,
            GaussianDiffusion(tnet, **{**DIFF, **kw}, device="cpu"))


def ancestral_draws(key, shape, n_steps):
    """p_sample_loop's noise, drawn as the JAX sampler draws it: the
    initial noise from the first half of a split, then one draw per step
    from a split of the running key."""
    k_init, k = jax.random.split(key)
    init = jax.random.normal(k_init, shape, jnp.float32)
    steps = []
    for _ in range(n_steps):
        k, kn = jax.random.split(k)
        steps.append(jax.random.normal(kn, shape, jnp.float32))
    return np.array(init), np.stack([np.asarray(s) for s in steps])


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0", "pred_v"])
def test_cfg_plus_plus_matches_jax(models, objective):
    jd, params, td = pair(models, objective=objective,
                          use_cfg_plus_plus=True)
    plain = pair(models, objective=objective)[2]
    rng = np.random.default_rng(3)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.array([19, 7, 1], np.int32)
    j = jd.model_predictions(params, jnp.asarray(x), jnp.asarray(t),
                             jnp.asarray(CLASSES), cond_scale=3.0,
                             rescaled_phi=0.7, clip_x_start=True)
    args = (nchw(x), torch.from_numpy(t).long(),
            torch.from_numpy(CLASSES).long())
    kw = dict(cond_scale=3.0, rescaled_phi=0.7, clip_x_start=True)
    with torch.no_grad():
        p = td.model_predictions(*args, **kw)
        q = plain.model_predictions(*args, **kw)
    # one fp32 CFG forward, then conversions that scale its rounding ~30x
    # near t = T and t = 0 (tests/test_torch_port_generate.py's tolerance)
    for a, b in zip(j, p):
        np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(a), atol=2e-3, rtol=1e-4)
    # CFG++ takes the noise from the null branch and leaves x_start alone
    torch.testing.assert_close(p[1], q[1], rtol=0, atol=0)
    assert (p[0] - q[0]).abs().max() > 1e-3
    # at cond_scale 1.0 there is no null branch: CFG++ changes nothing
    with torch.no_grad():
        one = td.model_predictions(*args, cond_scale=1.0)
        ref = plain.model_predictions(*args, cond_scale=1.0)
    for a, b in zip(one, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("cond_scale,phi", [(1.0, 0.0), (3.0, 0.7)])
def test_p_sample_loop_matches_jax_from_its_draws(models, cond_scale, phi):
    jd, params, td = pair(models)
    key = jax.random.PRNGKey(5)
    j_img = jax.jit(lambda p: jd.p_sample_loop(
        p, key, SHAPE, CLASSES, cond_scale=cond_scale, rescaled_phi=phi))(
        params)
    init, steps = ancestral_draws(key, SHAPE, DIFF["timesteps"])
    t_img = td.p_sample_loop(SHAPE, torch.from_numpy(CLASSES).long(),
                             cond_scale=cond_scale, rescaled_phi=phi,
                             init_noise=init, step_noise=steps)
    assert t_img.shape == SHAPE
    # 20 fp32 U-Net steps, each x_start clipped to [-1, 1] and mixed into
    # the posterior mean; measured max difference 7.7e-7, the DDIM chain's
    # tolerance (tests/test_torch_port_generate.py)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-4)


def test_sample_takes_the_ancestral_sampler_at_full_steps(models):
    _, _, td = pair(models, sampling_timesteps=20)
    assert not td.is_ddim_sampling
    classes = torch.from_numpy(CLASSES).long()
    got = td.sample(classes=classes, cond_scale=1.0,
                    generator=torch.Generator().manual_seed(9))
    want = td.p_sample_loop(SHAPE, classes, cond_scale=1.0,
                            generator=torch.Generator().manual_seed(9))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the generator is the only source of randomness
    other = td.sample(classes=classes, cond_scale=1.0,
                      generator=torch.Generator().manual_seed(10))
    assert (other - got).abs().max() > 1e-3


@pytest.mark.parametrize("t,lam", [(None, 0.5), (10, 0.3)])
def test_interpolate_matches_jax_from_its_draws(models, t, lam):
    jd, params, td = pair(models, auto_normalize=True)
    rng = np.random.default_rng(6)
    x1, x2 = (rng.random(SHAPE).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(7)
    j_img = jax.jit(lambda p: jd.interpolate(p, key, x1, x2, CLASSES, t=t,
                                             lam=lam))(params)
    k_q1, k_q2, k = jax.random.split(key, 3)
    noise1 = np.array(jax.random.normal(k_q1, SHAPE, jnp.float32))
    noise2 = np.array(jax.random.normal(k_q2, SHAPE, jnp.float32))
    steps = []
    for _ in range(DIFF["timesteps"] - 1 if t is None else t):
        k, kn = jax.random.split(k)
        steps.append(np.asarray(jax.random.normal(kn, SHAPE, jnp.float32)))
    t_img = td.interpolate(x1, x2, torch.from_numpy(CLASSES).long(), t=t,
                           lam=lam, noise1=noise1, noise2=noise2,
                           step_noise=np.stack(steps))
    assert t_img.shape == SHAPE
    # the ancestral chain's tolerance (above); measured max 1.3e-5 from T-1
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-4)


@pytest.mark.parametrize("sampler", ["ddim", "ancestral"])
def test_return_all_timesteps_matches_jax(models, sampler):
    if sampler == "ddim":
        jd, params, td = pair(models, sampling_timesteps=5,
                              auto_normalize=True)
        rng = np.random.default_rng(8)
        init = rng.standard_normal(SHAPE).astype(np.float32)
        steps = rng.standard_normal((5, *SHAPE)).astype(np.float32)
        j_all = jax.jit(lambda p: jd.ddim_sample(
            p, jax.random.PRNGKey(0), SHAPE, CLASSES, cond_scale=3.0,
            rescaled_phi=0.7, return_all_timesteps=True, init_noise=init,
            step_noise=steps))(params)
        run = td.ddim_sample
    else:
        jd, params, td = pair(models, auto_normalize=True)
        key = jax.random.PRNGKey(11)
        j_all = jax.jit(lambda p: jd.p_sample_loop(
            p, key, SHAPE, CLASSES, cond_scale=3.0, rescaled_phi=0.7,
            return_all_timesteps=True))(params)
        init, steps = ancestral_draws(key, SHAPE, DIFF["timesteps"])
        run = td.p_sample_loop
    kw = dict(cond_scale=3.0, rescaled_phi=0.7, init_noise=init,
              step_noise=steps)
    classes = torch.from_numpy(CLASSES).long()
    t_all = run(SHAPE, classes, return_all_timesteps=True, **kw)
    final = run(SHAPE, classes, **kw)
    # the initial noise first, each step's latents after it, on axis 1,
    # unnormalised; NHWC
    assert t_all.shape == (B, len(steps) + 1, *SHAPE[1:])
    torch.testing.assert_close(t_all[:, 0], torch.from_numpy(init) * 0.5
                               + 0.5, rtol=0, atol=0)
    torch.testing.assert_close(t_all[:, -1], final, rtol=0, atol=0)
    # the chains' tolerances above; measured max 4.5e-6
    np.testing.assert_allclose(t_all.numpy(), np.asarray(j_all), atol=1e-4)
