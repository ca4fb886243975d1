"""Port parity: the UViT (vqgan_tpu_torch/models/uvit.py) and simple
diffusion (vqgan_tpu_torch/diffusion/simple.py) against the JAX package's.

A tiny UViT (dim 8, mults (1, 2), a ViT middle of depth 2 with 2 heads x 8
over 4 x 4 tokens, 16 x 16 x 3 images) in fp32 on both sides, its JAX
params filled from a numpy seed and carried over with
`uvit_state_from_jax`. The JAX loss and sampler draw from PRNG keys; the
tests replay the key splits and hand the draws to the port.

Tolerances: module outputs 1e-5 of the largest JAX value (fp32 rounding
through ~30 layers), losses 1e-4 relative and absolute, gradients 1e-4 of
the largest JAX gradient, samplers of 3-4 model steps 1e-3 (absolute, on
outputs in [0, 1]).

- The UViT forward: plain, patched by a strided conv, patched with dual
  patch-norm, a per-stage downsample factor, the image transform hooks;
  its gradients; bf16 against JAX's bf16 noise; the dropout switch; the
  space-to-depth / depth-to-space channel order.
- The log-SNR schedules (cosine, shifted, interpolated); the loss (v and
  eps, with and without Min-SNR, shifted and interpolated schedules) with
  gradients; the sampler (v and eps); one step of the DDPM `Trainer`.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vqgan_tpu.diffusion import simple as jsimple
from vqgan_tpu.models.uvit import UViT as JUViT
from vqgan_tpu_torch.checkpoint import uvit_state_from_jax
from vqgan_tpu_torch.diffusion import SimpleDiffusion
from vqgan_tpu_torch.diffusion import simple as tsimple
from vqgan_tpu_torch.models import UViT
from vqgan_tpu_torch.models.unet import depth_to_space, space_to_depth
from vqgan_tpu_torch.training.ddpm_trainer import Trainer

torch.set_num_threads(2)

UVIT = dict(dim=8, dim_mults=(1, 2), vit_depth=2, attn_heads=2,
            attn_dim_head=8)
B = 2
SHAPE = (B, 16, 16, 3)


def fill(shapes, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for path, sds in flatten_dict(shapes).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "kernel":
            n /= np.sqrt(np.prod(sds.shape[:-1]))
        elif path[-1] in ("g", "scale"):
            n = 1.0 + 0.05 * n
        elif path[-1] == "bias":
            n *= 0.05
        out[path] = n
    return unflatten_dict(out)


def uvit_pair(seed=0, **kw):
    kw = {**UVIT, **kw}
    jnet = JUViT(**kw)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)))
    params = fill(shapes, seed)
    net = UViT(**kw)
    net.load_state_dict(uvit_state_from_jax(params))
    return jnet, params, net


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(SHAPE).astype(np.float32),
            np.array([3.5, -7.0], np.float32))


def grads_close(net, j_grads):
    want = uvit_state_from_jax(jax.tree.map(np.asarray, j_grads))
    size = max(float(v.abs().max()) for v in want.values())
    for name, p in net.named_parameters():
        torch.testing.assert_close(p.grad, want[name], rtol=0,
                                   atol=1e-4 * size,
                                   msg=lambda m: f"{name}: {m}")


# --- the UViT ----------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, dict(patch_size=2), dict(patch_size=2, dual_patchnorm=True),
    dict(downsample_factor=(2, 1), init_dim=12, out_dim=6)],
    ids=["plain", "patch_conv", "dual_patchnorm", "factors"])
def test_uvit_matches_jax(kw):
    jnet, params, net = uvit_pair(**kw)
    x, t = inputs()
    j = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x),
                                       jnp.asarray(t)))
    with torch.no_grad():
        p = net(nchw(x), torch.from_numpy(t))
    assert p.dtype == torch.float32
    np.testing.assert_allclose(nhwc(p), j, rtol=0,
                               atol=1e-5 * np.abs(j).max())


def test_uvit_image_transform_hooks_match_jax():
    """The hooks see the model's layout (NHWC in JAX, NCHW in the port);
    elementwise ones act alike."""
    kw = dict(init_img_transform=lambda x: 2.0 * x - 0.5,
              final_img_itransform=lambda x: x * 0.25 + 1.0)
    jnet, params, net = uvit_pair(seed=2, **kw)
    x, t = inputs(3)
    j = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x),
                                       jnp.asarray(t)))
    with torch.no_grad():
        p = nhwc(net(nchw(x), torch.from_numpy(t)))
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-5 * np.abs(j).max())


@pytest.mark.parametrize("kw", [{}, dict(patch_size=2, dual_patchnorm=True)],
                         ids=["plain", "dual_patchnorm"])
def test_uvit_gradients_match_jax(kw):
    jnet, params, net = uvit_pair(seed=4, **kw)
    x, t = inputs(5)
    target = np.random.default_rng(6).standard_normal(SHAPE).astype(
        np.float32)

    def j_loss(p):
        return jnp.mean((jnet.apply(p, jnp.asarray(x), jnp.asarray(t))
                         - target) ** 2)

    j_val, j_grads = jax.jit(jax.value_and_grad(j_loss))(params)
    loss = ((net(nchw(x), torch.from_numpy(t)) - nchw(target)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=1e-4,
                               atol=1e-4)
    grads_close(net, j_grads)


def test_uvit_bf16_matches_jax_to_its_noise():
    jnet, params, net = uvit_pair(seed=7)
    net16 = UViT(**UVIT, dtype=torch.bfloat16)
    net16.load_state_dict(net.state_dict())
    x, t = inputs(8)
    args = (jnp.asarray(x), jnp.asarray(t))
    j32 = np.asarray(jax.jit(jnet.apply)(params, *args))
    j16 = np.asarray(jax.jit(JUViT(**UVIT, dtype=jnp.bfloat16).apply)(
        params, *args))
    with torch.no_grad():
        p = nhwc(net16(nchw(x), torch.from_numpy(t)))
    assert p.dtype == np.float32 and j16.dtype == np.float32
    # two bf16 implementations: the port no farther from the fp32 output
    # than JAX's bf16 output is (x 1.5), the rule of the DDPM U-Net's test
    noise = np.abs(j16 - j32).max()
    assert 0 < noise < 5e-2 * np.abs(j32).max()
    assert np.abs(p - j32).max() <= 1.5 * noise


def test_uvit_dropout_follows_the_caller():
    _, _, net = uvit_pair(seed=9, vit_dropout=0.5)
    x, t = inputs(10)
    with torch.no_grad():
        a = net(nchw(x), torch.from_numpy(t))
        net.train()  # train mode alone does not turn dropout on
        b = net(nchw(x), torch.from_numpy(t))
        torch.manual_seed(0)
        d = net(nchw(x), torch.from_numpy(t), deterministic=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (d - a).abs().max() > 1e-3


@pytest.mark.parametrize("f", [2, 4])
def test_space_to_depth_order_matches_jax(f):
    x = np.random.default_rng(11).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    b, h, w, c = x.shape
    want = x.reshape(b, h // f, f, w // f, f, c).transpose(
        0, 1, 3, 2, 4, 5).reshape(b, h // f, w // f, c * f * f)
    got = space_to_depth(nchw(x), f)
    np.testing.assert_array_equal(nhwc(got), want)
    np.testing.assert_array_equal(nhwc(depth_to_space(got, f)), x)


# --- simple diffusion --------------------------------------------------------


def test_logsnr_schedules_match_jax():
    t = np.linspace(0, 1, 51).astype(np.float32)
    tt, jt = torch.from_numpy(t), jnp.asarray(t)
    pairs = [
        (tsimple.logsnr_schedule_cosine, jsimple.logsnr_schedule_cosine),
        (tsimple.logsnr_schedule_shifted(tsimple.logsnr_schedule_cosine, 64,
                                         32),
         jsimple.logsnr_schedule_shifted(jsimple.logsnr_schedule_cosine, 64,
                                         32)),
        (tsimple.logsnr_schedule_interpolated(
            tsimple.logsnr_schedule_cosine, 64, 32, 128),
         jsimple.logsnr_schedule_interpolated(
             jsimple.logsnr_schedule_cosine, 64, 32, 128))]
    for port, ref in pairs:
        np.testing.assert_allclose(port(tt).numpy(), np.asarray(ref(jt)),
                                   rtol=1e-5, atol=1e-4)


def simple_pair(**kw):
    jnet, params, net = uvit_pair(seed=12)
    common = dict(image_size=16, channels=3, num_sample_steps=4, **kw)
    return (jsimple.SimpleDiffusion(lambda p, x, s: jnet.apply(p, x, s),
                                    **common),
            params, SimpleDiffusion(net, **common, device="cpu"))


def simple_draws(key):
    """SimpleDiffusion.loss's draws: k_t, k_p = split(key); times from
    k_t, the noise from k_p."""
    k_t, k_p = jax.random.split(key)
    return (np.array(jax.random.uniform(k_t, (B,))),
            np.array(jax.random.normal(k_p, SHAPE, jnp.float32)))


@pytest.mark.parametrize("kw", [
    dict(pred_objective="v"), dict(pred_objective="eps"),
    dict(pred_objective="v", min_snr_loss_weight=False, noise_d=8),
    dict(pred_objective="eps", noise_d_low=8, noise_d_high=32)],
    ids=["v", "eps", "v_shifted", "eps_interpolated"])
def test_simple_loss_and_gradients_match_jax(kw):
    jd, params, td = simple_pair(**kw)
    img = np.random.default_rng(13).random(SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(14)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jd.loss(p, key, jnp.asarray(img))))(params)
    times, noise = simple_draws(key)
    loss = td.loss(img, times=times, noise=noise)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4,
                               atol=1e-4)
    grads_close(td.model, j_grads)


@pytest.mark.parametrize("pred_objective", ["v", "eps"])
def test_simple_sampler_matches_jax_from_its_draws(pred_objective):
    jd, params, td = simple_pair(pred_objective=pred_objective)
    key = jax.random.PRNGKey(15)
    j_img = np.asarray(jax.jit(lambda p: jd.sample(p, key, B))(params))
    k_init, k = jax.random.split(key)
    init = np.array(jax.random.normal(k_init, SHAPE, jnp.float32))
    steps = []
    for _ in range(4):
        k, kn = jax.random.split(k)
        steps.append(np.array(jax.random.normal(kn, SHAPE, jnp.float32)))
    t_img = td.sample(B, init_noise=init, step_noise=np.stack(steps))
    assert t_img.shape == SHAPE
    np.testing.assert_allclose(t_img.numpy(), j_img, atol=1e-3)


def test_simple_trainer_step_matches_jax():
    """One step of the DDPM `Trainer` over the UViT (train mode, dropout
    0.2 left off as JAX's trainer leaves it) computes JAX's loss."""
    jd, params, td = simple_pair()
    img = np.random.default_rng(16).random(SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(17)
    j_loss = float(jax.jit(lambda p: jd.loss(p, key, jnp.asarray(img)))(
        params))
    times, noise = simple_draws(key)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(td, td.model, train_batch_size=B,
                          results_folder=tmp)
        loss = trainer.train_step(torch.from_numpy(img), times=times,
                                  noise=noise)
    np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-4, atol=1e-4)
