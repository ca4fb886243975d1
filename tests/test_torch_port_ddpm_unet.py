"""Port parity: the unconditional DDPM U-Net (vqgan_tpu_torch/models/unet.py)
against the JAX package's (vqgan_tpu/models/unet.py).

A tiny U-Net (dim 8, mults (1, 2), 8 x 8 x 3 images, 2 heads x 16 in the
attention) on both sides, the JAX params filled from a numpy seed and
carried into the port with `ddpm_unet_state_from_jax`.

- The fp32 forward, within 1e-5 of the largest output: plain, with
  self-conditioning, `learned_variance`, `return_features`, full attention
  on every stage, and learned / random Fourier time features.
- The bf16 forward: no farther from the fp32 output than JAX's bf16
  output is (x 1.5), and within 5e-2 of the largest output of it.
- The space-to-depth channel order, pinned alone.
- The names `ddpm_unet_state_from_jax` defines, and that it copies.
- Dropout: test_torch_port_dropout.py.
- On a card (marker `gpu`, skipped without one): the full attention at the
  training shape's Skv = Sq + 4, kernels against the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vqgan_tpu.models.unet import Unet as JUnet
from vqgan_tpu_torch.checkpoint import ddpm_unet_state_from_jax
from vqgan_tpu_torch.models import Unet
from vqgan_tpu_torch.models.unet import Attention, space_to_depth

torch.set_num_threads(2)

UNET = dict(dim=8, dim_mults=(1, 2), channels=3, attn_heads=2,
            attn_dim_head=16)
B, S = 2, 8


def random_params(module, seed=0):
    """Parameter tree from jax.eval_shape, filled from a numpy seed."""
    x = jnp.zeros((1, S, S, module.channels))
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


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def inputs(seed=1, channels=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, S, channels)).astype(np.float32)
    sc = rng.standard_normal((B, S, S, channels)).astype(np.float32)
    t = np.array([3, 17], np.int32)
    return x, sc, t


CASES = {
    "plain": {},
    "self_condition": dict(self_condition=True),
    "learned_variance": dict(learned_variance=True),
    "full_attn_everywhere": dict(full_attn=(True, True)),
    "learned_sinusoidal": dict(learned_sinusoidal_cond=True),
    "random_fourier": dict(random_fourier_features=True),
    "three_stages": dict(dim_mults=(1, 2, 2), full_attn=(False, True, True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    kw = {**UNET, **CASES[case]}
    jnet = JUnet(**kw)
    params = random_params(jnet)
    net = Unet(**kw).eval()
    net.load_state_dict(ddpm_unet_state_from_jax(params))
    x, sc, t = inputs()
    self_cond = kw.get("self_condition", False)
    j = np.asarray(jnet.apply(params, jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(sc) if self_cond else None))
    with torch.no_grad():
        p = net(nchw(x), torch.from_numpy(t),
                nchw(sc) if self_cond else None).permute(0, 2, 3, 1)
    assert p.dtype == torch.float32
    assert p.shape == j.shape == (B, S, S, 6 if case == "learned_variance"
                                  else 3)
    # fp32 through ~20 layers summed in other orders: rounding only
    np.testing.assert_allclose(p.numpy(), j, rtol=0,
                               atol=1e-5 * np.abs(j).max())


def test_return_features_match_jax():
    jnet = JUnet(**UNET, self_condition=True)
    params = random_params(jnet, seed=3)
    net = Unet(**UNET, self_condition=True).eval()
    net.load_state_dict(ddpm_unet_state_from_jax(params))
    x, sc, t = inputs(seed=4)
    j_out, j_feat = jnet.apply(params, jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(sc), return_features=True)
    with torch.no_grad():
        out, feat = net(nchw(x), torch.from_numpy(t), nchw(sc),
                        return_features=True)
    assert feat.shape == (B, 16)
    np.testing.assert_allclose(feat.numpy(), np.asarray(j_feat), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_out), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(j_out)).max())


def test_bf16_forward_matches_jax():
    kw = dict(UNET, full_attn=(True, True))
    jnet = JUnet(**kw, dtype=jnp.bfloat16)
    params = random_params(jnet, seed=5)
    net = Unet(**kw, dtype=torch.bfloat16).eval()
    net.load_state_dict(ddpm_unet_state_from_jax(params))
    x, _, t = inputs(seed=6)
    j = np.asarray(jnet.apply(params, jnp.asarray(x), jnp.asarray(t)))
    j32 = np.asarray(JUnet(**kw).apply(params, jnp.asarray(x),
                                       jnp.asarray(t)))
    with torch.no_grad():
        p = net(nchw(x), torch.from_numpy(t)).permute(0, 2, 3, 1).numpy()
    # the final conv is fp32 in a bf16 model, as in JAX
    assert p.dtype == np.float32 and j.dtype == np.float32
    # bf16 activations (8 bits) through ~20 layers: JAX's own bf16 output
    # lies ~2% of the largest output from its fp32 one, so two bf16
    # implementations cannot agree to 1e-2 of it. The port's bf16 output
    # must lie no farther from the fp32 result than JAX's bf16 output does
    # (x 1.5), and within 5e-2 of the largest output from it.
    size = np.abs(j32).max()
    jax_noise = np.abs(j - j32).max()
    assert 1e-3 * size < jax_noise < 5e-2 * size
    assert np.abs(p - j32).max() <= 1.5 * jax_noise
    np.testing.assert_allclose(p, j, rtol=0, atol=5e-2 * size)


def test_space_to_depth_channel_order():
    """New channel (dy * 2 + dx) * C + c holds x[c, 2i + dy, 2j + dx], the
    JAX package's NHWC reshape order, not einops' (c, dy, dx)."""
    b, c, h, w = 2, 3, 4, 6
    x = torch.arange(b * c * h * w, dtype=torch.float32).reshape(b, c, h, w)
    y = space_to_depth(x)
    assert y.shape == (b, 4 * c, h // 2, w // 2)
    for dy in range(2):
        for dx in range(2):
            for ch in range(c):
                torch.testing.assert_close(
                    y[:, (dy * 2 + dx) * c + ch], x[:, ch, dy::2, dx::2],
                    rtol=0, atol=0)
    xj = np.asarray(x.permute(0, 2, 3, 1))
    want = xj.reshape(b, h // 2, 2, w // 2, 2, c).transpose(
        0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    np.testing.assert_array_equal(y.permute(0, 2, 3, 1).numpy(), want)


def test_state_names_are_pinned_and_copied():
    jnet = JUnet(**UNET, self_condition=True)
    params = random_params(jnet)
    state = ddpm_unet_state_from_jax(params)
    net = Unet(**UNET, self_condition=True)
    assert set(state) == set(net.state_dict())
    for name in ("init_conv.weight", "time_mlp.1.weight", "time_mlp.3.bias",
                 "downs.0.0.mlp.1.weight", "downs.0.1.block2.norm.g",
                 "downs.0.2.mem_kv", "downs.0.2.to_out.1.g",
                 "downs.0.3.1.weight", "downs.1.3.weight",
                 "mid_attn.mem_kv", "mid_attn.to_qkv.weight",
                 "ups.0.0.res_conv.weight", "ups.0.3.1.weight",
                 "ups.1.3.weight", "final_conv.weight"):
        assert name in state, name
    # the RMSNorm gain [C] -> [1, C, 1, 1]; the memory tokens keep the
    # layout of each attention ([2, heads, dh, M] linear, [2, heads, M, dh]
    # full)
    assert state["downs.0.0.block1.norm.g"].shape == (1, 8, 1, 1)
    assert state["downs.0.2.mem_kv"].shape == (2, 2, 16, 4)
    assert state["mid_attn.mem_kv"].shape == (2, 2, 4, 16)
    state["init_conv.bias"].add_(1.0)
    assert np.abs(np.asarray(params["params"]["init_conv"]["bias"])).max() \
        < 1.0


def test_full_attention_hands_sdpa_a_view_and_memory_tokens(monkeypatch):
    """q is a strided view of the projection, k and v have 4 memory tokens
    in front: Skv = Sq + 4."""
    from vqgan_tpu_torch.models import unet as unet_module

    seen = []

    def spy(q, k, v, scale=None):
        seen.append((q, k, v))
        return torch.zeros_like(q)

    monkeypatch.setattr(unet_module, "sdpa", spy)
    attn = Attention(16, heads=2, dim_head=8, dtype=torch.float32)
    attn(torch.randn(3, 16, 4, 4))
    (q, k, v), = seen
    assert q.shape == (3, 16, 2, 8) and k.shape == v.shape == (3, 20, 2, 8)
    assert q.stride() == (16 * 48, 48, 8, 1)
    assert k.is_contiguous() and v.is_contiguous()
    mk = attn.mem_kv[0].transpose(0, 1)
    torch.testing.assert_close(k[1, :4], mk, rtol=0, atol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_at_skv_plus_4_on_gpu(cuda_device, dtype):
    """The U-Net's full attention at its training shape, 16 x 16 pixels, 4
    heads x 32, Skv = 260: forward and gradients on the card (the flash
    kernels) against the same module on the CPU (their plain versions)."""
    from vqgan_tpu_torch.kernels import KERNELS

    dt = getattr(torch, dtype)
    torch.manual_seed(0)
    attn = Attention(256, heads=4, dim_head=32, dtype=dt)
    x = torch.randn(4, 256, 16, 16)
    out = {}
    for dev in ("cpu", cuda_device):
        m = attn.to(dev)
        xi = x.to(dev).requires_grad_()
        before = {n: k.launches for n, k in KERNELS.items()}
        y = m(xi)
        y.float().square().mean().backward()
        launched = {n: k.launches - before[n] for n, k in KERNELS.items()}
        out[str(dev)] = (y.detach().float().cpu(), xi.grad.cpu(),
                         m.mem_kv.grad.cpu(), launched)
        m.zero_grad()
    (y0, g0, m0, _), (y1, g1, m1, launched) = out["cpu"], out["cuda"]
    tol = 1e-4 if dtype == "float32" else 2e-2
    for a, b in ((y1, y0), (g1, g0), (m1, m0)):
        assert (a - b).abs().max() <= tol * b.abs().max()
    assert launched["flash_fwd"] == 1 and launched["flash_bwd_dq"] == 1 \
        and launched["flash_bwd_dkv"] == 1
