"""Port parity: the KL-VAE and its layers against vqgan_tpu.models.

JAX param trees are filled from a numpy seed (no bias zero, no norm gain
one), carried into the port with
`klvae_state_from_jax`, and both sides see the same numpy inputs in fp32.
The round trip through the JAX package's `load_torch_klvae` must give back
the JAX tree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vqgan_tpu.checkpoint.torch_import import load_torch_klvae
from vqgan_tpu.models import KLVAE as JKLVAE
from vqgan_tpu.models import layers as jlayers
from vqgan_tpu.models.autoencoder import AutoencoderConfig as JConfig
from vqgan_tpu_torch.checkpoint.from_jax import klvae_state_from_jax
from vqgan_tpu_torch.models import layers as tlayers
from vqgan_tpu_torch.models.autoencoder import AutoencoderConfig, KLVAE

torch.set_num_threads(2)

# ch 32, two levels, 16 px: attention at resolution 8 is hit per level in
# the encoder (after the downsample) and the decoder (before the upsample)
CFG = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
           resolution=16, z_channels=4)
# fp32 convs through ~12 layers with GroupNorm: rounding in two summation
# orders, relative to activations of O(1-10)
ATOL, RTOL = 2e-4, 1e-4


def random_params(module, *args, seed=0, **kwargs):
    """The module's parameter tree (shapes from jax.eval_shape, no init
    compute) filled from a numpy seed: fan-in scaled kernels, gains near 1,
    biases near 0 but not 0."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args,
                            **kwargs)
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


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def vae_pair():
    jvae = JKLVAE(config=JConfig(**CFG))
    params = random_params(jvae, jnp.zeros((1, 16, 16, 3)), seed=0)
    tvae = KLVAE(AutoencoderConfig(**CFG)).eval()
    tvae.load_state_dict(klvae_state_from_jax(params))
    images = np.random.default_rng(1).uniform(size=(2, 16, 16, 3)).astype(
        np.float32)
    latents = np.random.default_rng(2).standard_normal((2, 8, 8, 4)).astype(
        np.float32) * 0.18215
    return jvae, params, tvae, images, latents


def test_klvae_state_roundtrips_through_torch_import(vae_pair):
    _, params, tvae, _, _ = vae_pair
    back = flatten_dict(load_torch_klvae(tvae.state_dict()))
    orig = flatten_dict(params)
    assert back.keys() == orig.keys()
    for key, value in orig.items():
        np.testing.assert_array_equal(np.asarray(back[key]), value,
                                      err_msg="/".join(key))


def test_per_level_attention_is_built(vae_pair):
    tvae = vae_pair[2]
    assert len(tvae.encoder.down[1].attn) == 1
    assert len(tvae.decoder.up[1].attn) == 2


def test_encode_mean_and_logvar_match_jax(vae_pair):
    jvae, params, tvae, images, _ = vae_pair
    def encode(p, x):
        post = jvae.apply(p, x, method=JKLVAE.encode)
        return post.mean, post.logvar

    j_mean, j_logvar = jax.jit(encode)(params, jnp.asarray(images))
    with torch.no_grad():
        tpost = tvae.encode(nchw(images))
    np.testing.assert_allclose(nhwc(tpost.mean), np.asarray(j_mean),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(nhwc(tpost.logvar), np.asarray(j_logvar),
                               atol=ATOL, rtol=RTOL)
    mean = tvae.encode_images_mean(torch.from_numpy(images))
    np.testing.assert_allclose(
        mean.detach().numpy(), np.asarray(j_mean) * 0.18215,
        atol=ATOL, rtol=RTOL)


def test_decode_and_decode_latents_match_jax(vae_pair):
    jvae, params, tvae, _, latents = vae_pair
    with torch.no_grad():
        dec = tvae.decode(nchw(latents))
        imgs = tvae.decode_latents(torch.from_numpy(latents))
    j_dec, j_imgs = jax.jit(lambda p, z: (
        jvae.apply(p, z, method=JKLVAE.decode),
        jvae.apply(p, z, method=JKLVAE.decode_latents)))(
            params, jnp.asarray(latents))
    np.testing.assert_allclose(nhwc(dec), np.asarray(j_dec), atol=ATOL,
                               rtol=RTOL)
    assert imgs.shape == (2, 16, 16, 3)
    assert float(imgs.min()) >= 0.0 and float(imgs.max()) <= 1.0
    np.testing.assert_allclose(imgs.numpy(), j_imgs, atol=ATOL, rtol=RTOL)


def test_posterior_kl_and_sample_match_jax():
    from vqgan_tpu.models.autoencoder import DiagonalGaussian as JGaussian
    from vqgan_tpu_torch.models.autoencoder import DiagonalGaussian

    moments = np.random.default_rng(9).standard_normal((2, 4, 4, 8)).astype(
        np.float32)
    jpost = JGaussian(jnp.asarray(moments))
    tpost = DiagonalGaussian(nchw(moments))
    np.testing.assert_allclose(tpost.kl().numpy(), np.asarray(jpost.kl()),
                               rtol=1e-6)
    # the noise comes from the torch generator: mean + std * randn
    sample = tpost.sample(torch.Generator().manual_seed(3))
    noise = torch.randn(tpost.mean.shape,
                        generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(sample, tpost.mean + tpost.std * noise)
    np.testing.assert_allclose(nhwc(tpost.std), np.asarray(jpost.std),
                               rtol=1e-6)


def test_encode_images_samples_the_scaled_posterior(vae_pair):
    _, _, tvae, images, _ = vae_pair
    x = torch.from_numpy(images)
    with torch.no_grad():
        z = tvae.encode_images(x, generator=torch.Generator().manual_seed(4))
        post = tvae.encode(x.permute(0, 3, 1, 2))
    expected = post.sample(torch.Generator().manual_seed(4)) * 0.18215
    torch.testing.assert_close(z, expected.permute(0, 2, 3, 1))


def test_logvar_is_clamped():
    from vqgan_tpu_torch.models.autoencoder import DiagonalGaussian

    moments = torch.tensor([-100.0, 100.0, 0.0, 0.0]).reshape(1, 4, 1, 1)
    post = DiagonalGaussian(moments.roll(2, dims=1))  # mean 0, logvar +-100
    assert post.logvar.min() == -30.0 and post.logvar.max() == 20.0


def _layer_pair(jmodule, x, seed):
    params = random_params(jmodule, jnp.asarray(x), seed=seed)
    return params, np.asarray(jmodule.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("channels", [12, 48])
def test_groupnorm_group_fallback_matches_jax(channels):
    # 12 -> 12 groups, 48 -> 24 groups: the fallback below 32 channels and
    # for channel counts 32 does not divide
    x = np.random.default_rng(3).standard_normal((2, 4, 4, channels)).astype(
        np.float32) * 3 + 1
    params, jout = _layer_pair(jlayers.GroupNorm(), x, seed=4)
    tnorm = tlayers.GroupNorm(channels)
    assert tnorm.num_groups == {12: 12, 48: 24}[channels]
    gp = params["params"]["GroupNorm_0"]
    tnorm.load_state_dict({"weight": torch.from_numpy(gp["scale"]),
                           "bias": torch.from_numpy(gp["bias"])})
    np.testing.assert_allclose(nhwc(tnorm(nchw(x))), jout, atol=1e-5)


def test_conv_transpose_flipped_taps_match_jax():
    from vqgan_tpu_torch.checkpoint.from_jax import _conv_transpose

    x = np.random.default_rng(5).standard_normal((2, 5, 5, 8)).astype(
        np.float32)
    params, jout = _layer_pair(jlayers.UpsampleTranspose(), x, seed=6)
    tup = tlayers.UpsampleTranspose(8)
    state = {}
    _conv_transpose(state, "up", params["params"]["ConvTranspose_0"])
    tup.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
    with torch.no_grad():
        out = nhwc(tup(nchw(x)))
    assert out.shape == (2, 10, 10, 8)
    np.testing.assert_allclose(out, jout, atol=1e-5)


def test_attnblock_matches_jax():
    x = np.random.default_rng(7).standard_normal((2, 4, 4, 16)).astype(
        np.float32)
    params, jout = _layer_pair(jlayers.AttnBlock(), x, seed=8)
    tblock = tlayers.AttnBlock(16)
    state = {}
    from vqgan_tpu_torch.checkpoint.from_jax import _attnblock
    _attnblock(state, "a", params["params"])
    tblock.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(tblock(nchw(x))), jout, atol=1e-5)
