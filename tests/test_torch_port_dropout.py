"""Port parity: dropout in the ResNet blocks (models/layers.py `ResnetBlock`,
models/unet_cfg.py `Block` under the DDPM `Unet`) against the JAX package,
which takes it in vqgan_tpu/models/layers.py, vqgan_tpu/models/unet.py and
`VQGANConfig.dropout`.

- The DDPM `Unet`, the KL-VAE and the VQ-VAE at dropout 0.1 equal JAX's
  (`deterministic=True`, flax's default, as every trainer of both runs
  them) on the same weights, within the tolerances of
  test_torch_port_ddpm_unet.py and test_torch_port_vqvae.py, and equal
  the same port model at dropout 0 bit for bit.
- Under `deterministic=False` the mask comes from the caller's generator.
  Its bits cannot match JAX's, so both sides are held in distribution:
  the dropped share of a large tensor within 4 binomial standard
  deviations of p, the kept values scaled by 1 / (1 - p). The mask sits
  where JAX puts it: between the second SiLU and conv2 of a ResNet block,
  after the SiLU of the DDPM block's first conv block.
- A JAX Orbax milestone, or a config, with `dropout: 0.1` loads through
  `checkpoint/load.py` and computes what the fixture's JAX modules did.
"""

import json
import shutil
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict, unflatten_dict

from vqgan_tpu.models import VQVAE as JVQVAE
from vqgan_tpu.models.autoencoder import KLVAE as JKLVAE
from vqgan_tpu.models.autoencoder import AutoencoderConfig as JConfig
from vqgan_tpu.models.unet import Unet as JUnet
from vqgan_tpu_torch.checkpoint import (
    ddpm_unet_state_from_jax,
    klvae_state_from_jax,
    vqvae_state_from_jax,
)
from vqgan_tpu_torch.checkpoint.load import load_vqvae, load_weights
from vqgan_tpu_torch.models import VQVAE, Unet
from vqgan_tpu_torch.models.autoencoder import AutoencoderConfig, KLVAE
from vqgan_tpu_torch.models.layers import Dropout, ResnetBlock
from vqgan_tpu_torch.models.unet_cfg import ResnetBlock as FiLMResnetBlock

torch.set_num_threads(2)

P = 0.1
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "jax_orbax"
# fp32 through ~20 layers in other summation orders: rounding only, as in
# test_torch_port_ddpm_unet.py and test_torch_port_vqvae.py
FWD_ATOL = 1e-5
# the fixture's outputs, as phase 8 of chip_smoke.py holds them
FIXTURE_ATOL = 1e-4
UNET = dict(dim=8, dim_mults=(1, 2), channels=3, attn_heads=2,
            attn_dim_head=16)
VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=16,
           z_channels=4)
VQ = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, resolution=32,
          z_channels=16, num_embeddings=8, embedding_dim=16)


def random_params(module, *args, seed=0):
    """Parameter tree from jax.eval_shape, filled from a numpy seed."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
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
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def unet_case(seed):
    """(JAX's output, build(p): the port's model at dropout p with JAX's
    weights, run(model, **kw): its forward)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.array([3, 17], np.int32)
    jnet = JUnet(**UNET, dropout=P)
    params = random_params(jnet, jnp.zeros((1, 8, 8, 3)),
                           jnp.zeros((1,), jnp.int32), seed=seed)
    want = np.asarray(jnet.apply(params, jnp.asarray(x), jnp.asarray(t)))

    def build(p):
        net = Unet(**UNET, dropout=p).eval()
        net.load_state_dict(ddpm_unet_state_from_jax(params))
        return net

    def run(net, **kw):
        return net(nchw(x), torch.from_numpy(t), **kw).permute(0, 2, 3, 1)

    return want, build, run


def kl_vae_case(seed):
    x = np.random.default_rng(seed).random((2, 16, 16, 3)).astype(np.float32)
    jvae = JKLVAE(config=JConfig(**VAE, dropout=P))
    params = random_params(jvae, jnp.zeros((1, 16, 16, 3)), seed=seed)
    want = np.asarray(jvae.apply(params, jnp.asarray(x),
                                 sample_posterior=False)[0])

    def build(p):
        vae = KLVAE(AutoencoderConfig(**VAE, dropout=p)).eval()
        vae.load_state_dict(klvae_state_from_jax(params))
        return vae

    def run(vae, **kw):
        return vae(nchw(x), sample_posterior=False, **kw)[0].permute(
            0, 2, 3, 1)

    return want, build, run


def vq_vae_case(seed):
    x = np.random.default_rng(seed).random((2, 32, 32, 3)).astype(np.float32)
    jnet = JVQVAE(**VQ, dropout=P)
    params = random_params(jnet, jnp.zeros((1, 32, 32, 3)), seed=seed)
    want = np.asarray(jnet.apply(params, jnp.asarray(x))[0])

    def build(p):
        net = VQVAE(**VQ, dropout=p).eval()
        net.load_state_dict(vqvae_state_from_jax(params))
        return net

    def run(net, **kw):
        return net(nchw(x), **kw)[0].permute(0, 2, 3, 1)

    return want, build, run


CASES = {"ddpm_unet": unet_case, "kl_vae": kl_vae_case,
         "vq_vae": vq_vae_case}


@pytest.mark.parametrize("case", sorted(CASES))
def test_deterministic_model_at_dropout_matches_jax(case):
    want, build, run = CASES[case](seed=3)
    net, plain = build(P), build(0.0)
    assert any(isinstance(m, Dropout) for m in net.modules())
    assert not any(isinstance(m, Dropout) for m in plain.modules())
    with torch.no_grad():
        got = run(net)
        net.train()  # train mode alone does not turn dropout on
        got_train = run(net)
        got_plain = run(plain)
    torch.testing.assert_close(got, got_plain, rtol=0, atol=0)
    torch.testing.assert_close(got_train, got_plain, rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=FWD_ATOL * np.abs(want).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_stochastic_model_draws_from_the_callers_generator(case):
    _, build, run = CASES[case](seed=4)
    net = build(P)
    with torch.no_grad():
        quiet = run(net)
        a = run(net, deterministic=False,
                generator=torch.Generator().manual_seed(7))
        b = run(net, deterministic=False,
                generator=torch.Generator().manual_seed(7))
        c = run(net, deterministic=False,
                generator=torch.Generator().manual_seed(8))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - quiet).abs().max() > 1e-3
    assert (a - c).abs().max() > 1e-3


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropped_share_and_scale_match_jax_in_distribution(p):
    n = 1 << 20
    sigma = np.sqrt(p * (1 - p) / n)
    x = np.full((n,), 1.5, np.float32)
    got = Dropout(p)(torch.from_numpy(x), deterministic=False,
                     generator=torch.Generator().manual_seed(0)).numpy()
    want = np.asarray(fnn.Dropout(p, deterministic=False).apply(
        {}, jnp.asarray(x), rngs={"dropout": jax.random.PRNGKey(0)}))
    scale = np.float32(1.5) / np.float32(1 - p)
    for side in (got, want):
        dropped = side == 0
        assert abs(dropped.mean() - p) < 4 * sigma
        np.testing.assert_allclose(side[~dropped], scale, rtol=1e-6)
    # the two masks are drawn by different generators
    assert (got != want).any()


def test_mask_sits_where_jax_puts_it():
    """A ResNet block's dropout between its second SiLU and conv2; the DDPM
    block's after the SiLU of its first conv block, before the second."""
    keep = 1.0 - P
    x = torch.randn(2, 8, 6, 6, generator=torch.Generator().manual_seed(1))
    block = ResnetBlock(8, 16, dropout=P)
    with torch.no_grad():
        got = block(x, deterministic=False,
                    generator=torch.Generator().manual_seed(5))
        h = F.silu(block.norm2(block.conv1(F.silu(block.norm1(x)))))
        mask = torch.rand(h.shape,
                          generator=torch.Generator().manual_seed(5)) < keep
        want = block.nin_shortcut(x) + block.conv2(
            torch.where(mask, h / keep, torch.zeros_like(h)))
    torch.testing.assert_close(got, want, rtol=0, atol=0)

    film = FiLMResnetBlock(8, 16, 12, torch.float32, dropout=P)
    cond = torch.randn(2, 12, generator=torch.Generator().manual_seed(2))
    assert film.block2.dropout is None
    with torch.no_grad():
        got = film(x, cond, deterministic=False,
                   generator=torch.Generator().manual_seed(6))
        scale, shift = film.mlp(cond)[:, :, None, None].chunk(2, dim=1)
        h = F.silu(film.block1.norm(film.block1.proj(x)) * (scale + 1.0)
                   + shift)
        mask = torch.rand(h.shape,
                          generator=torch.Generator().manual_seed(6)) < keep
        h = film.block2(torch.where(mask, h / keep, torch.zeros_like(h)))
        want = h + film.res_conv(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_jax_kl_vae_milestone_at_dropout_loads_and_decodes():
    meta = json.loads((FIXTURE / "fixture.json").read_text())
    cfg = {k: tuple(v) if isinstance(v, list) else v
           for k, v in meta["kl_vae"].items()}
    path = FIXTURE / "kl_vae" / f"kl_vae-{meta['kl_vae_milestone']}"
    vae = load_weights(KLVAE(AutoencoderConfig(**cfg, dropout=P)),
                       path).eval()
    want = np.load(FIXTURE / "expected.npz")
    with torch.no_grad():
        images = vae.decode_latents(torch.from_numpy(want["sample_latents"]))
    np.testing.assert_allclose(images.numpy(), want["sample_images"],
                               rtol=0, atol=FIXTURE_ATOL)


def test_jax_vqgan_config_at_dropout_loads_through_load_vqvae(tmp_path):
    meta = json.loads((FIXTURE / "fixture.json").read_text())
    name = f"vqgan-{meta['vqgan_milestone']}"
    shutil.copytree(FIXTURE / "vqgan" / name, tmp_path / name)
    config = json.loads((FIXTURE / "vqgan" / f"{name}.config.json")
                        .read_text())
    assert config["dropout"] == 0.0
    (tmp_path / f"{name}.config.json").write_text(
        json.dumps({**config, "dropout": P}))
    vqvae, cfg = load_vqvae(tmp_path / name, device="cpu")
    assert cfg.dropout == P
    assert sum(isinstance(m, Dropout) for m in vqvae.modules()) > 0
    want = np.load(FIXTURE / "expected.npz")
    with torch.no_grad():
        idx = vqvae.encode_to_indices(nchw(want["vq_x"]))
        recon = vqvae.decode_from_indices(idx).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(idx.numpy(), want["vq_indices"])
    np.testing.assert_allclose(recon.numpy(), want["vq_recon"], rtol=0,
                               atol=FIXTURE_ATOL)


def test_ddpm_unet_state_at_dropout_loads_through_load_weights(tmp_path):
    want, build, run = unet_case(seed=5)
    torch.save(build(0.0).state_dict(), tmp_path / "unet.pt")
    net = load_weights(Unet(**UNET, dropout=P), tmp_path / "unet.pt").eval()
    with torch.no_grad():
        got = run(net)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=FWD_ATOL * np.abs(want).max())
