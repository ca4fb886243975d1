"""Port parity: EDM (vqgan_tpu_torch/diffusion/elucidated.py) and the Karras
magnitude-preserving U-Net (vqgan_tpu_torch/models/karras_unet.py) against
the JAX package's.

The JAX samplers and loss draw from PRNG keys; the tests compute those
draws and hand them to the port as tensors. The U-Net is tiny (dim 16,
dim_max 64, 16 x 16 x 3 images, 2 downsamples, 1 block per stage,
attention at 8 and 4 px, 3 classes), fp32, dropout off (the default, as
in JAX: its bits could not match), its JAX params filled from a numpy seed (the gains too, which
JAX initialises to 0) and carried over with `karras_unet_state_from_jax`.

- The preconditioners, c_noise and the loss weight; the sigma schedule.
- Heun (with and without self-conditioning, clamped or not) and
  DPM-Solver++(2M) with an analytic "oracle" net, and Heun with the U-Net,
  from JAX's draws; the loss with its sigmas, noise and coin.
- The U-Net forward with `normalize_forward` on and off, with and without
  classes, with self-conditioning; `normalize_karras_params`.
- The MP ops, `MPTransformer` and the bilinear resize (down with the
  antialiasing filter and up, borders included) against JAX.
- On a card (marker `gpu`, skipped without one): `KarrasAttention` at the
  bench's 16 x 16 x 256 shape (Skv = 260), kernels against plain.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vqgan_tpu.diffusion import ElucidatedDiffusion as JEDM
from vqgan_tpu.models import karras_unet as jk
from vqgan_tpu_torch.checkpoint import karras_unet_state_from_jax
from vqgan_tpu_torch.diffusion import ElucidatedDiffusion
from vqgan_tpu_torch.models import karras_unet as tk

torch.set_num_threads(2)

KARRAS = dict(image_size=16, dim=16, dim_max=64, num_classes=3, channels=3,
              num_downsamples=2, num_blocks_per_stage=1, attn_res=(8, 4),
              attn_dim_head=16, dropout=0.1)
B = 2
SHAPE = (B, 16, 16, 3)
CLASSES = np.array([0, 2], np.int32)


def fill(shapes, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for path, sds in flatten_dict(shapes).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "gain":
            n = 0.5 + 0.1 * n  # JAX initialises the gains to 0
        out[path] = n
    return unflatten_dict(out)


def karras_pair(seed=0, **kw):
    kw = {**KARRAS, **kw}
    jnet = jk.KarrasUnet(**kw)
    x = jnp.zeros((1, 16, 16, 3))
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x,
                            jnp.zeros((1,)), class_labels=jnp.zeros(
                                (1,), jnp.int32))
    params = fill(shapes, seed)
    net = tk.KarrasUnet(**kw).eval()
    net.load_state_dict(karras_unet_state_from_jax(params))
    return jnet, params, net


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


# --- the U-Net --------------------------------------------------------------


@pytest.mark.parametrize("normalize_forward", [True, False])
@pytest.mark.parametrize("classes", [True, False])
def test_karras_unet_matches_jax(normalize_forward, classes):
    kw = dict(normalize_forward=normalize_forward)
    if not classes:
        kw["num_classes"] = None
    jnet, params, net = karras_pair(**kw)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.array([0.3, -0.9], np.float32)
    labels = jnp.asarray(CLASSES) if classes else None
    j = np.asarray(jnet.apply(params, jnp.asarray(x), jnp.asarray(t),
                              class_labels=labels))
    with torch.no_grad():
        p = net(nchw(x), torch.from_numpy(t), class_labels=(
            torch.from_numpy(CLASSES) if classes else None))
    assert p.dtype == torch.float32
    # fp32 through ~12 weight-normalised blocks: rounding only
    np.testing.assert_allclose(nhwc(p), j, rtol=0,
                               atol=1e-5 * np.abs(j).max())


def test_karras_unet_self_condition_and_float_labels_match_jax():
    jnet, params, net = karras_pair(seed=2, self_condition=True)
    rng = np.random.default_rng(3)
    x, sc = (rng.standard_normal(SHAPE).astype(np.float32) for _ in "ab")
    t = np.array([1.2, 0.1], np.float32)
    soft = rng.random((B, 3)).astype(np.float32)  # float labels pass as is
    j = np.asarray(jnet.apply(params, jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(sc), class_labels=jnp.asarray(soft)))
    with torch.no_grad():
        p = net(nchw(x), torch.from_numpy(t), nchw(sc),
                class_labels=torch.from_numpy(soft))
    np.testing.assert_allclose(nhwc(p), j, rtol=0,
                               atol=1e-5 * np.abs(j).max())


def test_karras_unet_bf16_matches_jax_to_its_noise():
    jnet, params, net = karras_pair(seed=4)
    net16 = tk.KarrasUnet(**KARRAS, dtype=torch.bfloat16).eval()
    net16.load_state_dict(net.state_dict())
    x = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    t = np.array([0.3, -0.9], np.float32)
    args = (jnp.asarray(x), jnp.asarray(t))
    j32 = np.asarray(jnet.apply(params, *args,
                                class_labels=jnp.asarray(CLASSES)))
    j16 = np.asarray(jk.KarrasUnet(**KARRAS, dtype=jnp.bfloat16).apply(
        params, *args, class_labels=jnp.asarray(CLASSES)))
    with torch.no_grad():
        p = nhwc(net16(nchw(x), torch.from_numpy(t),
                       class_labels=torch.from_numpy(CLASSES)))
    # the Gain promotes to fp32, as JAX's bf16 * f32 does
    assert p.dtype == np.float32 and j16.dtype == np.float32
    # bf16 rounding of two implementations: the port's output lies no
    # farther from the fp32 one than JAX's bf16 output does (x 1.5)
    noise = np.abs(j16 - j32).max()
    assert 0 < noise < 5e-2 * np.abs(j32).max()
    assert np.abs(p - j32).max() <= 1.5 * noise


def test_dropout_is_active_only_in_train_mode():
    """Dropout follows the caller, as in the JAX package: off by default
    (`deterministic=True`) in eval and in `nn.Module.train()` mode alike,
    on only when a forward asks for it with deterministic=False, which is
    the JAX package's train mode that the name means."""
    _, _, net = karras_pair(seed=6)
    x = torch.randn(B, 3, 16, 16)
    t = torch.tensor([0.1, 0.2])
    c = torch.from_numpy(CLASSES)
    with torch.no_grad():
        a = net(x, t, class_labels=c)
        net.train()
        b = net(x, t, class_labels=c)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.manual_seed(0)
        d = net(x, t, class_labels=c, deterministic=False)
    assert (d - a).abs().max() > 1e-3


def test_normalize_karras_params_matches_jax():
    jnet, params, net = karras_pair(seed=7)
    j = jk.normalize_karras_params(params)
    want = karras_unet_state_from_jax(jax.tree.map(np.asarray, j))
    tk.normalize_karras_params(net)
    for name, value in net.state_dict().items():
        torch.testing.assert_close(value, want[name], rtol=1e-5, atol=1e-6,
                                   msg=lambda m: f"{name}: {m}")
    # idempotent: the forward with and without re-normalisation agree
    fast = tk.KarrasUnet(**KARRAS, normalize_forward=False).eval()
    fast.load_state_dict(net.state_dict())
    x, t = torch.randn(B, 3, 16, 16), torch.tensor([0.5, -0.5])
    c = torch.from_numpy(CLASSES)
    with torch.no_grad():
        torch.testing.assert_close(fast(x, t, class_labels=c),
                                   net(x, t, class_labels=c),
                                   rtol=1e-5, atol=1e-5)


# --- MP ops, the transformer, the resize ------------------------------------


def test_mp_ops_match_jax():
    rng = np.random.default_rng(8)
    a = rng.standard_normal((2, 5, 3, 3)).astype(np.float32)
    b = rng.standard_normal((2, 7, 3, 3)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = (jnp.asarray(np.moveaxis(v, 1, -1)) for v in (a, b))

    def close(got, want):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=1e-6, atol=1e-6)

    close(tk.mp_silu(ta), jk.mp_silu(ja))
    close(tk.mp_cat(ta, tb, t=0.3), jk.mp_cat(ja, jb, t=0.3))
    close(tk.mp_add(ta, ta * 2, t=0.4), jk.mp_add(ja, ja * 2, t=0.4))
    close(tk.pixel_norm(ta), jk.pixel_norm(ja))
    close(tk.pixel_norm(ta * 1e-7), jk.pixel_norm(ja * 1e-7))  # eps 1e-4
    w = rng.standard_normal((3, 3, 5, 4)).astype(np.float32)  # HWIO
    np.testing.assert_allclose(
        tk.normalize_weight(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        .numpy().transpose(2, 3, 1, 0),
        np.asarray(jk.normalize_weight(jnp.asarray(w))), rtol=1e-6,
        atol=1e-6)
    fourier = jk.MPFourierEmbedding(8)
    tt = np.array([0.1, -2.0, 3.0], np.float32)
    fp = fourier.init(jax.random.PRNGKey(1), jnp.asarray(tt))
    emb = tk.MPFourierEmbedding(8)
    emb.weights.copy_(torch.from_numpy(np.array(fp["params"]["weights"])))
    np.testing.assert_allclose(emb(torch.from_numpy(tt)).numpy(),
                               np.asarray(fourier.apply(fp, jnp.asarray(tt))),
                               rtol=1e-5, atol=1e-5)
    assert "weights" in dict(emb.named_buffers())  # frozen: not a parameter
    sched_j = jk.inv_sqrt_decay_schedule(1e-2, t_ref=100)
    sched_t = tk.inv_sqrt_decay_schedule(1e-2, t_ref=100)
    for step in (0, 50, 100, 400, 10000):
        assert sched_t(step) == pytest.approx(float(sched_j(step)),
                                              rel=1e-6)


def test_mp_transformer_matches_jax():
    jt = jk.MPTransformer(depth=2, heads=2, dim_head=16)
    x = np.random.default_rng(9).standard_normal((2, 10, 32)).astype(
        np.float32)
    params = fill(jax.eval_shape(jt.init, jax.random.PRNGKey(0),
                                 jnp.asarray(x)), seed=10)
    net = tk.MPTransformer(32, 2, heads=2, dim_head=16)
    state = karras_unet_state_from_jax(params)
    assert set(state) == set(net.state_dict())
    net.load_state_dict(state)
    j = np.asarray(jt.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        p = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-5 * np.abs(j).max())


@pytest.mark.parametrize("size", [(16, 16), (10, 6), (1, 4)])
@pytest.mark.parametrize("factor", [0.5, 2.0])
def test_bilinear_resize_matches_jax_at_the_borders(size, factor):
    h, w = size
    if factor < 1 and min(h, w) < 2:
        return  # a 1-pixel axis has no half
    x = np.random.default_rng(h * w).standard_normal(
        (2, h, w, 3)).astype(np.float32)
    j = np.asarray(jk._bilinear_resize(jnp.asarray(x), factor))
    p = tk.bilinear_resize(nchw(x), factor)
    assert p.shape[-2:] == (int(h * factor), int(w * factor))
    np.testing.assert_allclose(nhwc(p), j, rtol=0, atol=2e-6)


# --- EDM --------------------------------------------------------------------


def oracle_net(xp):
    """A fixed smooth function of (x, c_noise, self_cond) in either
    library."""
    def net(x, c_noise, self_cond=None):
        out = 0.8 * xp.tanh(x) + 0.1 * c_noise[:, None, None, None]
        if self_cond is not None:
            out = out + 0.2 * self_cond
        return out
    return net


def jax_oracle(p, x, t, self_cond=None):
    return oracle_net(jnp)(x, t, self_cond)


def torch_oracle(x, t, self_cond=None):
    return oracle_net(torch)(x, t, self_cond)


def edm_pair(net=torch_oracle, jnet=jax_oracle, **kw):
    kw = {"image_size": 16, "channels": 3, "num_sample_steps": 6, **kw}
    return JEDM(jnet, **kw), ElucidatedDiffusion(net, **kw, device="cpu")


def heun_draws(key, n):
    k_init, k = jax.random.split(key)
    init = np.array(jax.random.normal(k_init, SHAPE, jnp.float32))
    steps = []
    for _ in range(n):
        k, ke = jax.random.split(k)
        steps.append(np.array(jax.random.normal(ke, SHAPE, jnp.float32)))
    return init, np.stack(steps)


def test_preconditioners_and_schedule_match_jax():
    jd, td = edm_pair()
    s = np.array([0.002, 0.1, 0.5, 3.0, 80.0], np.float32)
    ts = torch.from_numpy(s)
    for name in ("c_skip", "c_out", "c_in", "c_noise", "loss_weight"):
        np.testing.assert_allclose(
            getattr(td, name)(ts).numpy(),
            np.asarray(getattr(jd, name)(jnp.asarray(s))), rtol=1e-6,
            err_msg=name)
    assert td.c_noise(torch.tensor([0.0])).item() == pytest.approx(
        math.log(1e-20) / 4)
    for n in (2, 6, 32):
        sched = td.sample_schedule(n)
        assert sched.dtype == np.float32 and sched[-1] == 0.0
        np.testing.assert_array_equal(sched, np.asarray(
            jd.sample_schedule(n)))
    assert sched[0] == pytest.approx(80.0) and sched[-2] == pytest.approx(
        0.002)


@pytest.mark.parametrize("self_condition", [False, True])
@pytest.mark.parametrize("clamp", [True, False])
def test_heun_matches_jax_from_its_draws(self_condition, clamp):
    jd, td = edm_pair(self_condition=self_condition)
    key = jax.random.PRNGKey(3)
    j = np.asarray(jax.jit(lambda k: jd.sample(
        None, k, batch_size=B, clamp=clamp))(key))
    init, steps = heun_draws(key, 6)
    p = td.sample(batch_size=B, clamp=clamp, init_noise=init,
                  step_noise=steps)
    assert p.shape == SHAPE
    # 12 fp32 evaluations from sigma 80; scalars in float32 on both sides
    np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=2e-5)


def test_dpmpp_matches_jax_from_its_draws():
    jd, td = edm_pair()
    key = jax.random.PRNGKey(4)
    j = np.asarray(jax.jit(lambda k: jd.sample_using_dpmpp(
        None, k, batch_size=B))(key))
    init = np.array(jax.random.normal(key, SHAPE, jnp.float32))
    p = td.sample_using_dpmpp(batch_size=B, init_noise=init)
    np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=2e-5)


def test_heun_with_the_karras_unet_matches_jax():
    jnet, params, net = karras_pair(seed=11)

    def j_apply(p, x, t, self_cond=None):
        return jnet.apply(p, x, t, class_labels=jnp.asarray(CLASSES))

    def t_apply(x, t, self_cond=None):
        return net(x, t, class_labels=torch.from_numpy(CLASSES))

    jd, td = edm_pair(t_apply, j_apply, num_sample_steps=4)
    key = jax.random.PRNGKey(5)
    j = np.asarray(jax.jit(lambda p, k: jd.sample(p, k, batch_size=B))(
        params, key))
    init, steps = heun_draws(key, 4)
    p = td.sample(batch_size=B, init_noise=init, step_noise=steps)
    np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("self_condition", [False, True])
def test_loss_matches_jax_from_its_draws(self_condition):
    jd, td = edm_pair(self_condition=self_condition)
    images = np.random.default_rng(12).random(SHAPE).astype(np.float32)
    for seed in range(4):  # both coin values among these keys
        key = jax.random.PRNGKey(seed)
        j = float(jax.jit(lambda k: jd.loss(None, k, jnp.asarray(images)))(
            key))
        k_sigma, k_noise, k_flip = jax.random.split(key, 3)
        sigmas = np.array(jd.noise_distribution(k_sigma, B))
        noise = np.array(jax.random.normal(k_noise, SHAPE, jnp.float32))
        coin = bool(jax.random.uniform(k_flip, ()) < 0.5)
        p = td.loss(images, sigmas=sigmas, noise=noise, self_cond_coin=coin)
        assert p.item() == pytest.approx(j, rel=1e-5)


def test_loss_draws_from_the_generator():
    _, td = edm_pair()
    images = np.random.default_rng(13).random(SHAPE).astype(np.float32)
    a = td.loss(images, generator=torch.Generator().manual_seed(1))
    b = td.loss(images, generator=torch.Generator().manual_seed(1))
    c = td.loss(images, generator=torch.Generator().manual_seed(2))
    assert a.item() == b.item() != c.item()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_karras_attention_at_skv_plus_4_on_gpu(cuda_device, dtype):
    """KarrasAttention at bench_edm's 16 x 16 x 256 stage (4 heads x 64,
    Skv = 260) on the card (the flash forward) against the CPU (its plain
    version)."""
    from vqgan_tpu_torch.kernels import KERNELS

    dt = getattr(torch, dtype)
    torch.manual_seed(0)
    attn = tk.KarrasAttention(256, heads=4, dim_head=64, dtype=dt)
    x = torch.randn(16, 256, 16, 16).to(dt)
    with torch.no_grad():
        want = attn(x).float()
        before = KERNELS["flash_fwd"].launches
        got = attn.to(cuda_device)(x.to(cuda_device)).float().cpu()
    assert KERNELS["flash_fwd"].launches == before + 1
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert (got - want).abs().max() <= tol * want.abs().max()
