"""Port parity: LPIPS, the PatchGAN discriminator and the GAN losses
(vqgan_tpu_torch/models/{lpips,discriminator}.py, losses/gan.py) against
the JAX package's, on numpy-seeded weights and inputs, in fp32.

- LPIPS distance and its input gradient at 32 px; its state dict back to
  JAX through `load_torch_lpips_weights`.
- PatchGAN logits in each norm mode; the BatchNorm running statistics
  after two train passes, which average the biased batch variance as flax
  does (torch's BatchNorm2d would average n / (n - 1) times it); the state
  dict back to JAX through `load_torch_patchgan`; ActNorm's data-dependent
  initialisation; the multi-scale discriminator.
- The seven GAN loss functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vqgan_tpu.checkpoint.torch_import import load_torch_patchgan
from vqgan_tpu.losses import gan as jgan
from vqgan_tpu.models.discriminator import ActNorm as JActNorm
from vqgan_tpu.models.discriminator import (
    MultiScaleDiscriminator as JMultiScale,
)
from vqgan_tpu.models.discriminator import PatchGANDiscriminator as JPatchGAN
from vqgan_tpu.models.lpips import LPIPS as JLPIPS
from vqgan_tpu.models.lpips import load_torch_lpips_weights
from vqgan_tpu_torch.checkpoint import (
    lpips_state_from_jax,
    patchgan_state_from_jax,
)
from vqgan_tpu_torch.losses import gan
from vqgan_tpu_torch.models import (
    LPIPS,
    MultiScaleDiscriminator,
    PatchGANDiscriminator,
)
from vqgan_tpu_torch.models.discriminator import ActNorm

torch.set_num_threads(2)

# fp32 through 13 VGG convs (or 4 PatchGAN convs) in other summation orders
LPIPS_RTOL = 1e-5
LOGITS_ATOL = 1e-6
STATS_ATOL = 1e-6


def fill(shapes_tree, seed):
    """numpy-seeded values for every leaf of an eval_shape tree."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, sds in flatten_dict(shapes_tree).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "kernel":
            n /= np.sqrt(np.prod(sds.shape[:-1]))
        elif path[-1] == "scale":
            n = 1.0 + 0.1 * n
        elif path[-1] in ("bias", "mean"):
            n *= 0.1
        elif path[-1] == "var":
            n = 1.0 + 0.1 * np.abs(n)
        out[path] = n
    return unflatten_dict(out)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_lpips_distance_and_input_gradient_match_jax():
    jnet = JLPIPS()
    x0 = jnp.zeros((1, 32, 32, 3))
    params = fill(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x0, x0),
                  seed=0)  # lin weights of both signs: |w| matters
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)

    def j_fn(x):
        return jnp.sum(jnet.apply(params, x, jnp.asarray(y)) * jnp.array(
            [1.0, 2.0]))

    j_dist = jnet.apply(params, jnp.asarray(x), jnp.asarray(y))
    j_grad = jax.grad(j_fn)(jnp.asarray(x))

    net = LPIPS()
    net.load_state_dict(lpips_state_from_jax(params))
    tx = nchw(x).requires_grad_()
    dist = net(tx, nchw(y))
    (dist * torch.tensor([1.0, 2.0])).sum().backward()
    np.testing.assert_allclose(dist.detach().numpy(), np.asarray(j_dist),
                               rtol=LPIPS_RTOL)
    grad = tx.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(grad, np.asarray(j_grad), rtol=0,
                               atol=LPIPS_RTOL * np.abs(j_grad).max())

    # back to JAX: the state dict split into torchvision and lpips parts
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    back = load_torch_lpips_weights(
        {k[len("vgg."):]: v for k, v in state.items() if k.startswith("vgg.")},
        {k: v for k, v in state.items() if k.startswith("lin")})
    for key, value in flatten_dict(params["params"]).items():
        np.testing.assert_array_equal(
            np.asarray(flatten_dict(back["params"])[key]), value)


def test_lpips_loads_torchvision_and_lpips_state_dicts():
    net = LPIPS()
    vgg = {k[len("vgg."):]: torch.randn_like(v)
           for k, v in net.state_dict().items() if k.startswith("vgg.")}
    vgg["classifier.0.weight"] = torch.zeros(3, 3)  # not LPIPS's: ignored
    lin = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1)
           for i, c in enumerate([64, 128, 256, 512, 512])}
    net.load_torch_weights(vgg, lin)
    state = net.state_dict()
    torch.testing.assert_close(state["vgg.features.28.weight"],
                               vgg["features.28.weight"], rtol=0, atol=0)
    torch.testing.assert_close(state["lin4.model.1.weight"],
                               lin["lin4.model.1.weight"], rtol=0, atol=0)


def patchgan_pair(norm, seed=2, n_layers=2, ndf=8):
    jnet = JPatchGAN(ndf=ndf, n_layers=n_layers, norm=norm)
    variables = dict(jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                                    jnp.zeros((1, 32, 32, 3))))
    variables = fill(variables, seed)
    if norm == "act":  # ActNorm's stats: an int flag and an affine
        stats = variables["actnorm_stats"]
        for name in stats:
            stats[name]["initialized"] = np.ones((), np.int32)
    net = PatchGANDiscriminator(ndf=ndf, n_layers=n_layers, norm=norm)
    net.load_state_dict(patchgan_state_from_jax(variables))
    return jnet, variables, net


@pytest.mark.parametrize("norm", ["batch", "act", "group"])
def test_patchgan_logits_match_jax(norm):
    jnet, variables, net = patchgan_pair(norm)
    x = np.random.default_rng(3).random((2, 32, 32, 3)).astype(np.float32)
    j_eval = jnet.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = net.eval()(nchw(x))
    assert out.shape == (2, 1, 6, 6) and out.dtype == torch.float32
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_eval), rtol=0, atol=LOGITS_ATOL)
    if norm == "batch":  # train mode normalises by the batch statistics
        j_train, _ = jnet.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
        with torch.no_grad():
            out = net.train()(nchw(x))
        np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(j_train), rtol=0,
                                   atol=LOGITS_ATOL)


def test_batchnorm_running_stats_after_two_train_passes_match_flax():
    # 2 images of 24 px: the last BatchNorm sees 2 x 2 x 2 = 8 values per
    # channel, where the unbiased variance is 8/7 of the biased one
    jnet, variables, net = patchgan_pair("batch", seed=4, n_layers=3)
    rng = np.random.default_rng(5)
    real = rng.random((2, 24, 24, 3)).astype(np.float32)
    fake = rng.random((2, 24, 24, 3)).astype(np.float32)
    stats = {"batch_stats": variables["batch_stats"]}
    for x in (real, fake):  # the D step's order: real, then fake
        _, stats = jnet.apply({"params": variables["params"], **stats},
                              jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    net.train()
    last = net.main[9]
    seen = []
    last.register_forward_hook(lambda mod, args, out: seen.append(args[0]))
    with torch.no_grad():
        net(nchw(real))
        after_real = last.running_var.clone()
        net(nchw(fake))
    h = seen[1].float()  # what the last BatchNorm saw in the fake pass
    n = h.shape[0] * h.shape[2] * h.shape[3]
    batch_var = h.var(dim=(0, 2, 3), unbiased=False)
    assert n == 8
    want = patchgan_state_from_jax({"params": variables["params"], **stats})
    for name, value in net.state_dict().items():
        if "running" in name:
            torch.testing.assert_close(value, want[name], rtol=0,
                                       atol=STATS_ATOL, msg=name)
    # momentum 0.1 over the biased variance; the unbiased one would land
    # 0.1 * var / (n - 1) higher
    torch.testing.assert_close(last.running_var,
                               0.9 * after_real + 0.1 * batch_var,
                               rtol=0, atol=STATS_ATOL)
    assert (0.1 * batch_var / (n - 1)).max() > 100 * STATS_ATOL


def test_patchgan_state_dict_goes_back_to_jax():
    _, variables, net = patchgan_pair("batch", n_layers=3)
    back = load_torch_patchgan({k: v.clone()
                                for k, v in net.state_dict().items()},
                               n_layers=3)
    for tree in ("params", "batch_stats"):
        for key, value in flatten_dict(variables[tree]).items():
            np.testing.assert_array_equal(
                np.asarray(flatten_dict(back[tree])[key]), value)


def test_actnorm_data_dependent_init_matches_jax():
    x = np.random.default_rng(6).standard_normal((3, 4, 4, 5)).astype(
        np.float32) * 2.0 + 1.0
    jnorm = JActNorm()
    variables = jnorm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    j_out, j_stats = jnorm.apply(variables, jnp.asarray(x),
                                 init_actnorm=True, mutable=["actnorm_stats"])
    norm = ActNorm(5)
    with torch.no_grad():
        out = norm(nchw(x), init_actnorm=True)
        again = norm(nchw(x) + 1.0, init_actnorm=True)  # initialised once
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_out), atol=1e-5)
    np.testing.assert_allclose(norm.weight.numpy(), np.asarray(
        j_stats["actnorm_stats"]["weight"]), rtol=1e-6)
    torch.testing.assert_close(again, out + norm.weight.view(1, -1, 1, 1))
    assert int(norm.initialized) == 1


def test_multiscale_discriminator_matches_jax():
    jnet = JMultiScale(num_scales=2, ndf=8, n_layers=2, norm="batch")
    x = np.random.default_rng(7).random((2, 33, 33, 3)).astype(np.float32)
    variables = fill(dict(jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                                         jnp.asarray(x))), seed=8)
    net = MultiScaleDiscriminator(num_scales=2, ndf=8, n_layers=2)
    state = {}
    for i in range(2):
        sub = {tree: variables[tree][f"scale_{i}"]
               for tree in ("params", "batch_stats")}
        state.update({f"scales.{i}.{k}": v
                      for k, v in patchgan_state_from_jax(sub).items()})
    net.load_state_dict(state)
    j_outs = jnet.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        outs = net.eval()(nchw(x))
    for out, j_out in zip(outs, j_outs):
        np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(j_out), rtol=0,
                                   atol=LOGITS_ATOL)


def _logits(seed):
    return np.random.default_rng(seed).standard_normal((2, 1, 5, 5)).astype(
        np.float32) * 1.5


@pytest.mark.parametrize("name", ["hinge_d_loss", "vanilla_d_loss"])
def test_d_losses_match_jax(name):
    real, fake = _logits(9), _logits(10)
    got = getattr(gan, name)(torch.from_numpy(real), torch.from_numpy(fake))
    want = getattr(jgan, name)(jnp.asarray(real), jnp.asarray(fake))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", ["hinge_g_loss", "vanilla_g_loss"])
def test_g_losses_match_jax(name):
    fake = _logits(11)
    got = getattr(gan, name)(torch.from_numpy(fake))
    np.testing.assert_allclose(
        got.item(), float(getattr(jgan, name)(jnp.asarray(fake))), rtol=1e-6)


def test_adaptive_disc_weight_matches_jax():
    for a, b in ((3.0, 0.5), (1e3, 1e-9), (0.0, 2.0)):  # incl. the clip
        got = gan.adaptive_disc_weight(torch.tensor(a), torch.tensor(b))
        want = jgan.adaptive_disc_weight(jnp.float32(a), jnp.float32(b))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
        assert not got.requires_grad


@pytest.mark.parametrize("loss_type", ["hinge", "vanilla"])
@pytest.mark.parametrize("active", [False, True])
def test_generator_and_discriminator_loss_match_jax(loss_type, active):
    rng = np.random.default_rng(12)
    inputs = rng.random((2, 3, 8, 8)).astype(np.float32)
    recon = rng.random((2, 3, 8, 8)).astype(np.float32)
    real, fake = _logits(13), _logits(14)

    def j_perceptual(r, x):
        return jnp.mean((r - x) ** 2, axis=(1, 2, 3))

    def t_perceptual(r, x):
        return torch.mean((r - x) ** 2, dim=(1, 2, 3))

    kw = dict(disc_active=active, disc_weight=0.1, perceptual_weight=0.7,
              disc_loss_type=loss_type)
    j_loss, j_log = jgan.generator_loss(
        jnp.asarray(inputs), jnp.asarray(recon), jnp.asarray(fake),
        perceptual_fn=j_perceptual, adaptive_weight=jnp.float32(2.5), **kw)
    loss, log = gan.generator_loss(
        torch.from_numpy(inputs), torch.from_numpy(recon),
        torch.from_numpy(fake), perceptual_fn=t_perceptual,
        adaptive_weight=torch.tensor(2.5), **kw)
    assert log.keys() == j_log.keys()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-6)
    for key in log:
        np.testing.assert_allclose(log[key].item(), float(j_log[key]),
                                   rtol=1e-6, err_msg=key)
    nll, nll_log = gan.generator_loss(torch.from_numpy(inputs),
                                      torch.from_numpy(recon), None, **kw)
    assert set(nll_log) == {"rec_loss", "perceptual_loss", "nll_loss",
                            "total_loss"} and nll.item() > 0

    d_loss, d_log = gan.discriminator_loss(
        torch.from_numpy(real), torch.from_numpy(fake), disc_active=active,
        disc_loss_type=loss_type)
    j_d, j_dlog = jgan.discriminator_loss(
        jnp.asarray(real), jnp.asarray(fake), disc_active=active,
        disc_loss_type=loss_type)
    np.testing.assert_allclose(d_loss.item(), float(j_d), rtol=1e-6)
    for key in d_log:
        np.testing.assert_allclose(d_log[key].item(), float(j_dlog[key]),
                                   rtol=1e-6, err_msg=key)
