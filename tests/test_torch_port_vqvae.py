"""Port parity: the VQ-VAE (vqgan_tpu_torch/models/vq_vae.py) against the
JAX package's (vqgan_tpu/models/vq_vae.py).

A tiny config (ch 16, mults 1-2, 1 res block, 32 px, z 16, codebook 8 x
16, as tests/test_train_steps.py) in fp32 on both sides, the JAX params
filled from a numpy seed and carried into the port with
`vqvae_state_from_jax`; gradients come back the same way.

- Forward under both loss conventions: reconstruction, losses, indices
  and usage; the gradients of L1 + vq_loss, whose routing the conventions
  swap.
- With z_channels != embedding_dim (pre/post-quant 1x1 convs).
- The index codec round trip and the NHWC image functions.
- A port state dict goes back to JAX through `load_torch_vqvae`.
- Dropout: test_torch_port_dropout.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vqgan_tpu.checkpoint.torch_import import load_torch_vqvae
from vqgan_tpu.models import VQVAE as JVQVAE
from vqgan_tpu_torch.checkpoint import vqvae_state_from_jax
from vqgan_tpu_torch.models import VQVAE

torch.set_num_threads(2)

TINY = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, resolution=32,
            z_channels=16, num_embeddings=8, embedding_dim=16)
B = 2
# fp32 forward through ~20 layers in other summation orders; values O(1)
FWD_ATOL = 1e-5
# fp32 backward: relative to the largest gradient
GRAD_RTOL = 1e-4


def random_params(module, *args, seed=0):
    """Parameter tree from jax.eval_shape, filled from a numpy seed. The
    codebook is N(0, 1), so codes sit far apart against the features."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)
    out = {}
    for path, sds in flatten_dict(shapes).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "kernel":
            n /= np.sqrt(np.prod(sds.shape[:-1]))
        elif path[-1] == "scale":
            n = 1.0 + 0.05 * n
        elif path[-1] == "bias":
            n *= 0.05
        out[path] = n
    return unflatten_dict(out)


def images(seed=1):
    return np.random.default_rng(seed).random((B, 32, 32, 3)).astype(
        np.float32)


def build(convention="paper", seed=0, **over):
    cfg = {**TINY, **over}
    jnet = JVQVAE(**cfg, loss_convention=convention)
    params = random_params(jnet, jnp.zeros((1, 32, 32, 3)), seed=seed)
    net = VQVAE(**cfg, loss_convention=convention)
    net.load_state_dict(vqvae_state_from_jax(params))
    return jnet, params, net


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("convention", ["paper", "reference"])
def test_forward_and_gradients_match_jax(convention):
    jnet, params, net = build(convention)
    x = images()

    def j_loss(p):
        recon, losses, idx = jnet.apply(p, jnp.asarray(x))
        total = jnp.mean(jnp.abs(recon - x)) + losses["vq_loss"]
        return total, (recon, losses, idx)

    (j_total, (j_recon, j_losses, j_idx)), j_grads = jax.value_and_grad(
        j_loss, has_aux=True)(params)

    recon, losses, idx = net(nchw(x))
    total = torch.mean(torch.abs(recon - nchw(x))) + losses["vq_loss"]
    total.backward()

    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(losses["usage_counts"].numpy(),
                                  np.asarray(j_losses["usage_counts"]))
    np.testing.assert_allclose(recon.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_recon), atol=FWD_ATOL)
    for key in ("vq_loss", "codebook_loss", "commitment_loss",
                "codebook_usage_ratio"):
        np.testing.assert_allclose(losses[key].item(),
                                   float(j_losses[key]), rtol=FWD_ATOL,
                                   err_msg=key)
    np.testing.assert_allclose(total.item(), float(j_total), rtol=FWD_ATOL)
    assert len(np.unique(idx.numpy())) > 1  # more than one code in use

    want = vqvae_state_from_jax(jax.tree.map(np.asarray, j_grads))
    largest = max(v.abs().max().item() for v in want.values())
    for name, p in net.named_parameters():
        torch.testing.assert_close(p.grad, want[name], rtol=0,
                                   atol=GRAD_RTOL * largest,
                                   msg=lambda m: f"{name}: {m}")
    # the conventions route the codebook's gradient differently: its scale
    # follows beta under "reference"
    assert net.quantizer.embedding.weight.grad.abs().max() > 0


def test_conventions_swap_the_gradient_routing():
    _, _, paper = build("paper")
    _, _, ref = build("reference")
    x = nchw(images())
    grads = {}
    for name, net in (("paper", paper), ("reference", ref)):
        _, losses, _ = net(x)
        losses["vq_loss"].backward()
        grads[name] = net.quantizer.embedding.weight.grad.clone()
    # same loss value, the codebook's gradient scaled by beta = 0.25
    torch.testing.assert_close(grads["reference"], 0.25 * grads["paper"],
                               rtol=1e-5, atol=1e-8)


def test_pre_and_post_quant_convs_match_jax():
    jnet, params, net = build(seed=3, z_channels=12)
    assert "pre_quant_conv" in params["params"]
    x = images(4)
    j_recon, j_losses, j_idx = jnet.apply(params, jnp.asarray(x))
    with torch.no_grad():
        recon, losses, idx = net(nchw(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(recon.permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_recon), atol=FWD_ATOL)
    np.testing.assert_allclose(float(losses["vq_loss"]),
                               float(j_losses["vq_loss"]), rtol=FWD_ATOL)


def test_index_codec_and_image_functions_match_jax():
    jnet, params, net = build(seed=5)
    x = images(6)
    j_idx = jnet.apply(params, jnp.asarray(x), method=JVQVAE.encode_to_indices)
    j_dec = jnet.apply(params, j_idx, method=JVQVAE.decode_from_indices)
    j_lat = jnet.apply(params, jnp.asarray(x), method=JVQVAE.encode_images)
    j_img = jnet.apply(params, j_lat, method=JVQVAE.decode_latents)
    with torch.no_grad():
        idx = net.encode_to_indices(nchw(x))
        dec = net.decode_from_indices(idx)
        lat = net.encode_images(torch.from_numpy(x))
        img = net.decode_latents(lat)
        # the round trip: decoding the indices is decoding the quantized z
        # (whose straight-through form z + (z_q - z) rounds z_q in fp32)
        recon, _, _ = net(nchw(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(dec.permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_dec), atol=FWD_ATOL)
    np.testing.assert_allclose(lat.numpy(), np.asarray(j_lat), atol=FWD_ATOL)
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), atol=FWD_ATOL)
    torch.testing.assert_close(dec, recon, rtol=0, atol=1e-6)
    assert img.shape == (B, 32, 32, 3) and lat.shape == (B, 16, 16, 16)


def test_state_dict_goes_back_to_jax():
    _, params, net = build(seed=7, z_channels=12)
    back = load_torch_vqvae({k: v.detach().clone()
                             for k, v in net.state_dict().items()})
    flat_back = flatten_dict(back["params"])
    flat = flatten_dict(params["params"])
    assert flat_back.keys() == flat.keys()
    for key, value in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[key]), value,
                                      err_msg=str(key))
