"""Port parity: the Karras magnitude-preserving U-Nets for sequences and
video (vqgan_tpu_torch/models/karras_unet_nd.py) against the JAX
package's.

Tiny models in fp32 on both sides (dim 8, dim_max 16, 1 block per stage,
2 heads x 8 where attention runs), their JAX params filled from a numpy
seed (the gains too, which JAX initialises to 0) and carried over with
`karras_unet_nd_state_from_jax`: a KarrasUnet1D over 16 x 2 sequences
(attention at 8 and 4, 3 classes) and a KarrasUnet3D over 4 x 8 x 8 x 2
video ("image" then "all" downsampling, attention at 4 px), with full and
with factorised space / time attention.

Tolerances: outputs 1e-5 of the largest JAX value (fp32 rounding), the
resize 2e-6, gradients 1e-4 of the largest JAX gradient.

- The forward of both, self-conditioned, with float labels, every 3-D
  downsample type; gradients; the dropout switch.
- `MPConvND` at ranks 1 and 3; the N-D linear resize (down with the
  antialiasing filter and up, odd sizes, borders) against jax.image.resize.
- The attention's shapes: what `sdpa` sees (q against Skv = Sq + 4 keys;
  per frame and per pixel when factorised).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vqgan_tpu.models import karras_unet_nd as jnd
from vqgan_tpu_torch.checkpoint import karras_unet_nd_state_from_jax
from vqgan_tpu_torch.models import karras_unet_nd as tnd

torch.set_num_threads(2)

COMMON = dict(dim=8, dim_max=16, num_blocks_per_stage=1, attn_dim_head=8,
              channels=2)
ONE_D = dict(COMMON, num_downsamples=2, spatial_size=(16,), attn_res=(8, 4),
             num_classes=3)
THREE_D = dict(COMMON, num_downsamples=2, spatial_size=(4, 8, 8),
               attn_res=(4,), downsample_types=("image", "all"))


def fill(shapes, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for path, sds in flatten_dict(shapes).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "gain":
            n = 0.5 + 0.1 * n
        out[path] = n
    return unflatten_dict(out)


def pair(rank, seed=0, **kw):
    jcls, tcls, cfg = ((jnd.KarrasUnet1D, tnd.KarrasUnet1D, ONE_D)
                       if rank == 1 else
                       (jnd.KarrasUnet3D, tnd.KarrasUnet3D, THREE_D))
    cfg = {**cfg, **kw}
    jnet = jcls(**cfg)
    x = jnp.zeros((1, *cfg["spatial_size"], cfg["channels"]))
    labels = (jnp.zeros((1,), jnp.int32) if cfg.get("num_classes")
              else None)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x,
                            jnp.zeros((1,)), class_labels=labels)
    params = fill(shapes, seed)
    net = tcls(**cfg)
    net.load_state_dict(karras_unet_nd_state_from_jax(params))
    return jnet, params, net


def first(x):
    """Channels last -> first."""
    return torch.from_numpy(np.ascontiguousarray(x)).movedim(-1, 1)


def last(x):
    return x.detach().movedim(1, -1).numpy()


def inputs(rank, seed=1, b=2):
    shape = (b, 16, 2) if rank == 1 else (b, 4, 8, 8, 2)
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            np.array([0.3, -0.9][:b], np.float32))


def close(p, j):
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-5 * np.abs(j).max())


# --- forward ----------------------------------------------------------------


@pytest.mark.parametrize("self_condition", [False, True])
def test_karras_unet_1d_matches_jax(self_condition):
    jnet, params, net = pair(1, self_condition=self_condition)
    x, t = inputs(1)
    sc = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    labels = np.array([0, 2])
    j = np.asarray(jax.jit(jnet.apply)(
        params, jnp.asarray(x), jnp.asarray(t),
        jnp.asarray(sc) if self_condition else None,
        class_labels=jnp.asarray(labels)))
    with torch.no_grad():
        p = net(first(x), torch.from_numpy(t),
                first(sc) if self_condition else None,
                class_labels=torch.from_numpy(labels))
    assert p.dtype == torch.float32
    close(last(p), j)


def test_karras_unet_1d_float_labels_match_jax():
    jnet, params, net = pair(1, seed=3)
    x, t = inputs(1, 4)
    soft = np.random.default_rng(5).random((2, 3)).astype(np.float32)
    j = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x),
                                       jnp.asarray(t),
                                       class_labels=jnp.asarray(soft)))
    with torch.no_grad():
        p = net(first(x), torch.from_numpy(t),
                class_labels=torch.from_numpy(soft))
    close(last(p), j)


@pytest.mark.parametrize("factorize", [False, True],
                         ids=["full", "factorized"])
@pytest.mark.parametrize("types", [("image", "all"), ("frame", "image")])
def test_karras_unet_3d_matches_jax(factorize, types):
    jnet, params, net = pair(3, seed=6, factorize_space_time_attn=factorize,
                             downsample_types=types)
    x, t = inputs(3, 7)
    j = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x),
                                       jnp.asarray(t)))
    with torch.no_grad():
        p = net(first(x), torch.from_numpy(t))
    close(last(p), j)


# --- gradients --------------------------------------------------------------


@pytest.mark.parametrize("rank,kw", [
    (1, {}), (3, dict(factorize_space_time_attn=True))],
    ids=["1d", "3d_factorized"])
def test_gradients_match_jax(rank, kw):
    jnet, params, net = pair(rank, seed=8, **kw)
    x, t = inputs(rank, 9)
    target = np.random.default_rng(10).standard_normal(x.shape).astype(
        np.float32)
    labels = np.array([1, 0]) if rank == 1 else None

    def j_loss(p):
        out = jnet.apply(p, jnp.asarray(x), jnp.asarray(t),
                         class_labels=None if labels is None
                         else jnp.asarray(labels))
        return jnp.mean((out - target) ** 2)

    j_val, j_grads = jax.jit(jax.value_and_grad(j_loss))(params)
    out = net(first(x), torch.from_numpy(t),
              class_labels=None if labels is None
              else torch.from_numpy(labels))
    loss = ((out - first(target)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=1e-4,
                               atol=1e-4)
    want = karras_unet_nd_state_from_jax(jax.tree.map(np.asarray, j_grads))
    size = max(float(v.abs().max()) for v in want.values())
    for name, p in net.named_parameters():
        # fp32 backward through the weight normalisation of ~20 layers
        torch.testing.assert_close(p.grad, want[name], rtol=0,
                                   atol=1e-4 * size,
                                   msg=lambda m: f"{name}: {m}")


def test_dropout_follows_the_caller():
    _, _, net = pair(3, seed=11, dropout=0.5)
    x, t = inputs(3, 12)
    with torch.no_grad():
        a = net(first(x), torch.from_numpy(t))
        net.train()  # train mode alone does not turn dropout on
        b = net(first(x), torch.from_numpy(t))
        torch.manual_seed(0)
        d = net(first(x), torch.from_numpy(t), deterministic=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (d - a).abs().max() > 1e-3


# --- the pieces -------------------------------------------------------------


@pytest.mark.parametrize("rank,ones", [(1, False), (3, True)])
def test_mp_conv_nd_matches_jax(rank, ones):
    jconv = jnd.MPConvND(6, 3, rank, concat_ones_to_input=ones)
    shape = (2, 9, 5) if rank == 1 else (2, 3, 5, 4, 5)
    x = np.random.default_rng(13).standard_normal(shape).astype(np.float32)
    params = fill(jax.eval_shape(jconv.init, jax.random.PRNGKey(0),
                                 jnp.asarray(x)), 14)
    conv = tnd.MPConvND(5, 6, 3, rank, concat_ones_to_input=ones)
    conv.load_state_dict(karras_unet_nd_state_from_jax(params))
    j = np.asarray(jconv.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        close(last(conv(first(x))), j)


@pytest.mark.parametrize("shape,factors", [
    ((2, 16, 3), (0.5,)), ((2, 9, 3), (0.5,)), ((2, 8, 3), (2.0,)),
    ((2, 4, 8, 6, 3), (0.5, 0.5, 0.5)), ((2, 4, 8, 6, 3), (0.5, 1.0, 1.0)),
    ((2, 2, 4, 3, 3), (2.0, 2.0, 2.0)), ((2, 3, 5, 7, 3), (1.0, 0.5, 2.0))])
def test_resize_nd_matches_jax(shape, factors):
    x = np.random.default_rng(15).standard_normal(shape).astype(np.float32)
    j = np.asarray(jnd._resize_nd(jnp.asarray(x), factors))
    p = last(tnd.resize_nd(first(x), factors))
    assert p.shape == j.shape
    np.testing.assert_allclose(p, j, rtol=0, atol=2e-6)


@pytest.mark.parametrize("rank,factorize", [(1, False), (3, False),
                                            (3, True)])
def test_attention_shapes(monkeypatch, rank, factorize):
    """q [B', S, heads, dh] against S + 4 keys: all positions, or per frame
    (B' = B T, S = H W) then per pixel (B' = B H W, S = T)."""
    seen = []
    real = tnd.sdpa

    def spy(q, k, v):
        seen.append((tuple(q.shape), k.shape[1]))
        return real(q, k, v)

    monkeypatch.setattr(tnd, "sdpa", spy)
    kw = dict(factorize_space_time_attn=True) if factorize else {}
    _, _, net = pair(rank, seed=16, **kw)
    x, t = inputs(rank, 17)
    with torch.no_grad():
        net(first(x), torch.from_numpy(t),
            class_labels=torch.tensor([0, 1]) if rank == 1 else None)
    b = 2
    if rank == 1:
        # 16 -> 8 (attention, 16 channels: 2 heads) -> 4 (attention)
        want = {((b, 8, 2, 8), 12), ((b, 4, 2, 8), 8)}
    elif not factorize:
        # "image" then "all": frames 4 -> 4 -> 2, pixels 8 -> 4 -> 2;
        # attention at 4 px (4 frames) only
        want = {((b, 4 * 16, 2, 8), 68)}
    else:
        want = {((b * 4, 16, 2, 8), 20), ((b * 16, 4, 2, 8), 8)}
    assert set(seen) == want
    assert all(s_kv == q[1] + 4 for q, s_kv in seen)
