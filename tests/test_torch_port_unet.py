"""Port parity: the CFG U-Net against vqgan_tpu.models.CFGUnet.

A small U-Net (dim 16, mults (1, 2), 2 heads x 16, 8x8x4 latents, 3
classes) in fp32 on both sides; JAX param trees are filled from a numpy
seed and carried into the port with `cfg_unet_state_from_jax`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.traverse_util import flatten_dict, unflatten_dict

from vqgan_tpu.checkpoint.torch_import import load_torch_cfg_unet
from vqgan_tpu.models import CFGUnet as JCFGUnet
from vqgan_tpu.models.layers import RMSNorm as JRMSNorm
from vqgan_tpu.models.unet_cfg import CrossAttentionCond as JCross
from vqgan_tpu_torch.checkpoint.from_jax import cfg_unet_state_from_jax
from vqgan_tpu_torch.models.layers import RMSNorm
from vqgan_tpu_torch.models.unet_cfg import CFGUnet, CrossAttentionCond

torch.set_num_threads(2)

KW = dict(dim=16, num_classes=3, cond_drop_prob=0.0, dim_mults=(1, 2),
          channels=4, attn_dim_head=16, attn_heads=2)
B, SIZE = 4, 8
# fp32 through ~40 conv/dense layers with RMSNorms: summation-order
# rounding relative to outputs of O(1)
ATOL, RTOL = 2e-4, 1e-4


def random_params(module, *args, seed=0, **kwargs):
    """Parameter tree from jax.eval_shape, filled from a numpy seed."""
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


def make_pair(**extra):
    kw = {**KW, **extra}
    jnet = JCFGUnet(**kw)
    x = jnp.zeros((1, SIZE, SIZE, 4))
    params = random_params(jnet, x, jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1,), jnp.int32),
                           cond_drop_mask=jnp.zeros((1,), bool), seed=0)
    tnet = CFGUnet(**kw).eval()
    tnet.load_state_dict(cfg_unet_state_from_jax(params))
    return jnet, params, tnet


@pytest.fixture(scope="module")
def unet_pair():
    return make_pair()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, SIZE, SIZE, 4)).astype(np.float32)
    t = np.array([0, 3, 11, 19], np.int32)
    classes = np.array([0, 1, 2, 1], np.int32)
    mask = np.array([False, True, False, True])
    return x, t, classes, mask


def _forward_both(jnet, params, tnet, x, t, classes, mask):
    j_out, j_feat = jax.jit(lambda p, *a: jnet.apply(
        p, *a[:3], cond_drop_mask=a[3], return_features=True))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(classes),
        jnp.asarray(mask))
    with torch.no_grad():
        t_out, t_feat = tnet(nchw(x), torch.from_numpy(t).long(),
                             torch.from_numpy(classes).long(),
                             cond_drop_mask=torch.from_numpy(mask),
                             return_features=True)
    return (np.asarray(j_out), np.asarray(j_feat)), (nhwc(t_out),
                                                    t_feat.numpy())


def test_forward_with_mixed_cond_drop_mask_matches_jax(unet_pair, inputs):
    (j_out, j_feat), (t_out, t_feat) = _forward_both(*unet_pair, *inputs)
    assert t_out.shape == (B, SIZE, SIZE, 4)
    np.testing.assert_allclose(t_out, j_out, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(t_feat, j_feat, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(t_feat, axis=-1), 1.0,
                               atol=1e-5)


def test_null_class_replaces_the_class_embedding(unet_pair, inputs):
    # with every sample dropped the class no longer matters
    _, _, tnet = unet_pair
    x, t, _, _ = inputs
    mask = torch.ones(B, dtype=torch.bool)
    with torch.no_grad():
        a = tnet(nchw(x), torch.from_numpy(t).long(),
                 torch.zeros(B, dtype=torch.long), cond_drop_mask=mask)
        b = tnet(nchw(x), torch.from_numpy(t).long(),
                 torch.full((B,), 2, dtype=torch.long), cond_drop_mask=mask)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_learned_sinusoidal_variant_matches_jax(inputs):
    (j_out, _), (t_out, _) = _forward_both(
        *make_pair(learned_sinusoidal_cond=True), *inputs)
    np.testing.assert_allclose(t_out, j_out, atol=ATOL, rtol=RTOL)


def test_cfg_unet_state_roundtrips_through_torch_import(unet_pair):
    _, params, tnet = unet_pair
    back = flatten_dict(load_torch_cfg_unet(tnet.state_dict()))
    orig = flatten_dict(params)
    assert back.keys() == orig.keys()
    for key, value in orig.items():
        np.testing.assert_array_equal(np.asarray(back[key]), value,
                                      err_msg="/".join(key))


def test_linear_attention_is_4_heads_of_32(unet_pair):
    # whatever attn_heads / attn_dim_head say (here 2 x 16)
    tnet = unet_pair[2]
    assert tnet.downs[0][2].fn.fn.to_qkv.weight.shape[0] == 3 * 4 * 32
    assert tnet.mid_attn.fn.fn.to_qkv.weight.shape[0] == 3 * 2 * 16


def test_single_token_cross_attention_is_a_broadcast(unet_pair):
    cross = unet_pair[2].mid_cross_attn.fn.fn
    assert cross.to_q.weight.shape == (32, 32, 1, 1)  # kept as a parameter
    x = torch.randn(2, 32, 2, 2)
    ctx = torch.randn(2, 64)
    with torch.no_grad():
        out = cross(x, ctx)
        tok = cross.to_out(cross.to_v(ctx)[:, :, None, None])
    torch.testing.assert_close(out, tok.expand_as(out))


def test_multi_token_cross_attention_matches_jax():
    # n > 1 context tokens: the general path through sdpa
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 3, 24)).astype(np.float32)
    jmod = JCross(heads=2, dim_head=8)
    params = random_params(jmod, jnp.asarray(x), jnp.asarray(ctx), seed=5)
    j = np.asarray(jmod.apply(params, jnp.asarray(x), jnp.asarray(ctx)))
    from vqgan_tpu_torch.checkpoint.from_jax import _cross_attention

    state = {}
    _cross_attention(state, "c", {"norm": {"g": np.ones(16, np.float32)}},
                     params["params"])
    tmod = CrossAttentionCond(16, 24, torch.float32, heads=2, dim_head=8)
    tmod.load_state_dict({k.removeprefix("c.fn.fn."): v
                          for k, v in state.items() if ".fn.fn." in k})
    with torch.no_grad():
        t = nhwc(tmod(nchw(x), torch.from_numpy(ctx)))
    np.testing.assert_allclose(t, j, atol=1e-5)


def test_random_class_drop_draws_from_the_generator(unet_pair, inputs):
    # without a mask, cond_drop_prob 1.0 drops every class: the output is
    # the all-null output
    _, _, tnet = unet_pair
    x, t, classes, _ = inputs
    args = (nchw(x), torch.from_numpy(t).long(),
            torch.from_numpy(classes).long())
    with torch.no_grad():
        dropped = tnet(*args, cond_drop_prob=1.0,
                       generator=torch.Generator().manual_seed(0))
        null = tnet(*args, cond_drop_mask=torch.ones(B, dtype=torch.bool))
        kept = tnet(*args)  # the model's cond_drop_prob is 0.0
    torch.testing.assert_close(dropped, null, rtol=0, atol=0)
    assert not torch.equal(kept, null)


def test_rmsnorm_keeps_epsilon_inside_the_root():
    # tiny activations: x * rsqrt(sum x^2 + 1e-12) differs from
    # F.normalize's x / max(|x|, 1e-12)
    x = (np.random.default_rng(2).standard_normal((2, 3, 3, 8)) * 1e-7
         ).astype(np.float32)
    params = random_params(JRMSNorm(), jnp.asarray(x), seed=3)
    j = np.asarray(JRMSNorm().apply(params, jnp.asarray(x)))
    norm = RMSNorm(8)
    norm.g.data = torch.from_numpy(params["params"]["g"]).reshape(1, 8, 1, 1)
    with torch.no_grad():
        t = nhwc(norm(nchw(x)))
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    f = torch.nn.functional.normalize(nchw(x), dim=1) * norm.g * 8**0.5
    assert np.abs(nhwc(f.detach()) - j).max() > 1e-2


def test_gelu_is_flax_tanh_approximation(unet_pair):
    gelu = unet_pair[2].classes_mlp[1]
    x = np.linspace(-4, 4, 101).astype(np.float32)
    j = np.asarray(fnn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(gelu(torch.from_numpy(x)).numpy(), j,
                               atol=1e-6)
    exact = torch.nn.GELU()(torch.from_numpy(x)).numpy()
    assert np.abs(exact - j).max() > 1e-4


@pytest.mark.parametrize("module", ["unet", "vae"])
def test_attention_inputs_meet_the_kernel_contract(monkeypatch, unet_pair,
                                                   inputs, module):
    # the CUDA kernel takes BSHD with a contiguous head_dim axis and raises
    # otherwise; on the CPU the plain path would not notice, so check here
    import vqgan_tpu_torch.models.layers as tl
    import vqgan_tpu_torch.models.unet_cfg as tu
    from vqgan_tpu_torch.ops.attention import sdpa

    seen = []

    def checked(q, k, v, scale=None):
        seen.append(q.shape)
        assert all(t.stride(-1) == 1 for t in (q, k, v))
        return sdpa(q, k, v, scale)

    monkeypatch.setattr(tu, "sdpa", checked)
    monkeypatch.setattr(tl, "sdpa", checked)
    x, t, classes, mask = inputs
    with torch.no_grad():
        if module == "unet":
            unet_pair[2](nchw(x), torch.from_numpy(t).long(),
                         torch.from_numpy(classes).long(),
                         cond_drop_mask=torch.from_numpy(mask))
            assert seen == [(B, 16, 2, 16)]  # 4x4 mid grid, 2 heads x 16
        else:
            tl.AttnBlock(32)(torch.randn(2, 32, 4, 4))
            assert seen == [(2, 16, 1, 32)]
