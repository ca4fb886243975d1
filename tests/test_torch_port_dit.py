"""Port parity: the DiT denoiser (vqgan_tpu_torch/models/dit.py) against the
JAX package's (vqgan_tpu/models/dit.py).

A tiny DiT (dim 32, depth 2, 2 heads x 16, patch 2, 8x8x4 latents, 3
classes) in fp32 on both sides, the JAX params filled from a numpy seed and
carried into the port with `dit_state_from_jax`; gradients come back the
same way.

- The forward, the mid-stack features and the null-class mask, with and
  without `learned_variance`.
- The parameter names and shapes `dit_state_from_jax` defines, and that it
  copies.
- `p_losses` and every parameter's gradient, t, noise and the cond-drop
  mask injected on both sides.
- A DDIM chain from injected noise at cond_scale 1.0 and 3.0.
- `build_cfg_unet_diffusion(model_type="dit")` builds the JAX package's
  DiT, with and without gradient checkpointing.
- A checkpoint of JAX weights read back by `generate --device cpu`.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from PIL import Image

from vqgan_tpu.configs import LDMConfig as JLDMConfig
from vqgan_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from vqgan_tpu.models import DiT as JDiT
from vqgan_tpu.training.ldm_trainer import (
    build_cfg_unet_diffusion as j_build,
)
from vqgan_tpu_torch.build import Rematerialized, build_cfg_unet_diffusion
from vqgan_tpu_torch.checkpoint import CheckpointManager, dit_state_from_jax
from vqgan_tpu_torch.configs import LDMConfig
from vqgan_tpu_torch.diffusion import GaussianDiffusion
from vqgan_tpu_torch.models import DiT

torch.set_num_threads(2)

DIT = dict(dim=32, depth=2, heads=2, dim_head=16, patch_size=2, image_size=8,
           channels=4, num_classes=3, cond_drop_prob=0.0)
DIFF = dict(image_size=8, channels=4, timesteps=20, sampling_timesteps=5,
            objective="pred_v", beta_schedule="cosine",
            min_snr_loss_weight=True, min_snr_gamma=5.0,
            auto_normalize=False)
B = 3


def random_params(module, seed=0):
    """Parameter tree from jax.eval_shape, filled from a numpy seed (the
    zero-initialised adaLN projections too, so every path carries signal)."""
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
        elif path[-1] == "bias":
            n *= 0.05
        elif path[-1] == "pos_emb":
            n *= 0.1
        out[path] = n
    return unflatten_dict(out)


def port_dit(params, **kw):
    net = DiT(**{**DIT, **kw})
    net.load_state_dict(dit_state_from_jax(params))
    return net


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal((B, 8, 8, 4)).astype(np.float32),
                t=np.array([19, 7, 0], np.int32),
                classes=np.array([2, 0, 1], np.int32),
                noise=rng.standard_normal((B, 8, 8, 4)).astype(np.float32),
                mask=np.array([False, True, False]))


@pytest.fixture(scope="module")
def jax_dit():
    model = JDiT(**DIT)
    return model, random_params(model)


@pytest.mark.parametrize("learned_variance", [False, True])
def test_forward_features_and_null_mask_match_jax(learned_variance):
    jmodel = JDiT(**DIT, learned_variance=learned_variance)
    params = random_params(jmodel, seed=1)
    net = port_dit(params, learned_variance=learned_variance).eval()
    d = inputs(0)
    j_out, j_feat = jmodel.apply(params, d["x"], d["t"], d["classes"],
                                 cond_drop_mask=d["mask"],
                                 return_features=True)
    with torch.no_grad():
        out, feat = net(nchw(d["x"]), torch.from_numpy(d["t"]).long(),
                        torch.from_numpy(d["classes"]).long(),
                        cond_drop_mask=torch.from_numpy(d["mask"]),
                        return_features=True)
        null_a = net(nchw(d["x"]), torch.from_numpy(d["t"]).long(),
                     torch.tensor([0, 1, 2]),
                     cond_drop_mask=torch.ones(B, dtype=torch.bool))
        null_b = net(nchw(d["x"]), torch.from_numpy(d["t"]).long(),
                     torch.tensor([2, 2, 0]),
                     cond_drop_mask=torch.ones(B, dtype=torch.bool))
    assert out.shape == (B, 8 if learned_variance else 4, 8, 8)
    assert out.dtype == torch.float32 and feat.shape == (B, 32)
    # one fp32 forward through 2 blocks: rounding only (measured max
    # difference 4.1e-5 on outputs of up to a few tens)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(feat.numpy(), np.asarray(j_feat), rtol=1e-5,
                               atol=1e-5)
    # the null mask erases the class: any classes give the same output
    torch.testing.assert_close(null_a, null_b, rtol=0, atol=0)


def test_state_names_are_pinned_and_copied(jax_dit):
    _, params = jax_dit
    state = dit_state_from_jax(params)
    blocks = [f"blocks.{i}.{n}.{w}" for i in range(2)
              for n, w in (("ada_mod", "weight"), ("ada_mod", "bias"),
                           ("to_qkv", "weight"), ("to_out", "weight"),
                           ("mlp_in", "weight"), ("mlp_in", "bias"),
                           ("mlp_out", "weight"), ("mlp_out", "bias"))]
    assert sorted(state) == sorted([
        "pos_emb", "classes_emb.weight", "null_classes_emb",
        "patch_embed.weight", "patch_embed.bias", "time_mlp_in.weight",
        "time_mlp_in.bias", "time_mlp_out.weight", "time_mlp_out.bias",
        "final_mod.weight", "final_mod.bias", "final_proj.weight",
        "final_proj.bias", *blocks])
    assert sorted(state) == sorted(DiT(**DIT).state_dict())
    p = params["params"]
    assert state["patch_embed.weight"].shape == (32, 4, 2, 2)  # OIHW
    np.testing.assert_array_equal(state["patch_embed.weight"][5, 1].numpy(),
                                  p["patch_embed"]["kernel"][:, :, 1, 5])
    np.testing.assert_array_equal(state["blocks.1.to_qkv.weight"].numpy(),
                                  p["blocks_1"]["to_qkv"]["kernel"].T)
    before = state["pos_emb"].clone()
    p["pos_emb"][...] += 1.0  # the state dict holds copies
    torch.testing.assert_close(state["pos_emb"], before, rtol=0, atol=0)
    p["pos_emb"][...] -= 1.0


def test_p_losses_and_gradients_match_jax(jax_dit):
    jmodel, params = jax_dit
    d = inputs(1)

    def model_apply(p, x, t, classes, **_):
        return jmodel.apply(p, x, t, classes, cond_drop_mask=d["mask"])

    jdiff = JGaussianDiffusion(model_apply, **DIFF)

    @jax.jit
    def loss_and_grads(p):
        return jax.value_and_grad(lambda p: jdiff.p_losses(
            p, jax.random.PRNGKey(0), d["x"], d["t"], d["classes"],
            noise=d["noise"]))(p)

    j_loss, j_grads = loss_and_grads(params)
    net = port_dit(params).train()
    loss = GaussianDiffusion(net, **DIFF, device="cpu").p_losses(
        d["x"], torch.from_numpy(d["t"]).long(),
        torch.from_numpy(d["classes"]).long(), noise=d["noise"],
        cond_drop_mask=torch.from_numpy(d["mask"]))
    loss.backward()
    # one fp32 forward, Min-SNR weights <= 5: rounding only
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    want = dit_state_from_jax(jax.tree.map(np.asarray, j_grads))
    for name, p in net.named_parameters():
        # fp32 backward through 2 blocks in other summation orders; the
        # largest gradient is O(1)
        torch.testing.assert_close(p.grad, want[name], rtol=1e-4, atol=2e-5,
                                   msg=lambda m: f"{name}: {m}")
    # the attention's gradient went through the flash backward
    assert net.blocks[0].to_qkv.weight.grad.abs().max() > 0


@pytest.mark.parametrize("cond_scale,phi", [(1.0, 0.0), (3.0, 0.7)])
def test_ddim_chain_matches_jax(jax_dit, cond_scale, phi):
    jmodel, params = jax_dit

    def model_apply(p, x, t, classes, cond_drop_mask=None, **_):
        return jmodel.apply(p, x, t, classes, cond_drop_mask=cond_drop_mask)

    jdiff = JGaussianDiffusion(model_apply, **DIFF)
    rng = np.random.default_rng(2)
    shape = (B, 8, 8, 4)
    init = rng.standard_normal(shape).astype(np.float32)
    steps = rng.standard_normal((5, *shape)).astype(np.float32)
    classes = np.array([0, 2, 1], np.int32)
    j_z = jax.jit(lambda p: jdiff.ddim_sample(
        p, jax.random.PRNGKey(0), shape, classes, cond_scale=cond_scale,
        rescaled_phi=phi, init_noise=init, step_noise=steps))(params)
    tdiff = GaussianDiffusion(port_dit(params).eval(), **DIFF, device="cpu")
    t_z = tdiff.ddim_sample(shape, torch.from_numpy(classes).long(),
                            cond_scale=cond_scale, rescaled_phi=phi,
                            init_noise=init, step_noise=steps)
    assert t_z.shape == shape
    # five fp32 DiT steps and DDIM updates on clipped x_start in [-1, 1]
    # (the tolerance of the U-Net's chain, tests/test_torch_port_generate.py)
    np.testing.assert_allclose(t_z.numpy(), np.asarray(j_z), atol=1e-4)


TINY_LDM = dict(model_type="dit", dim=8, attn_heads=2, attn_dim_head=16,
                dit_depth=2, dit_patch_size=2, num_users=3, latent_size=8,
                image_size=64, timesteps=20, sampling_timesteps=3,
                cond_drop_prob=0.1, compute_dtype="float32")


@pytest.mark.parametrize("remat", [False, True])
def test_build_makes_the_jax_packages_dit(remat):
    jmodel, jdiff = j_build(JLDMConfig(**TINY_LDM),
                            gradient_checkpointing=remat)
    model, diffusion = build_cfg_unet_diffusion(
        LDMConfig(**TINY_LDM), device="cpu", gradient_checkpointing=remat)
    assert isinstance(model, DiT) and isinstance(jmodel, JDiT)
    assert (model.dim, model.depth, model.patch_size, model.grid,
            model.out_ch, model.cond_drop_prob, model.dtype) == (
        jmodel.dim, jmodel.depth, jmodel.patch_size,
        jmodel.image_size // jmodel.patch_size, jmodel.channels,
        jmodel.cond_drop_prob, torch.float32)
    assert isinstance(diffusion.model, Rematerialized) == remat
    params = random_params(jmodel, seed=3)
    state = dit_state_from_jax(params)
    assert {k: v.shape for k, v in state.items()} == {
        k: v.shape for k, v in model.state_dict().items()}
    model.load_state_dict(state)
    assert (model.blocks[0].heads, model.blocks[0].dim_head) == (2, 16)
    d = inputs(3)
    mask = jnp.asarray(d["mask"])
    j_out = jdiff.model_apply(params, d["x"], d["t"], d["classes"],
                              cond_drop_mask=mask)
    with torch.no_grad():
        out = diffusion.model(nchw(d["x"]), torch.from_numpy(d["t"]).long(),
                              torch.from_numpy(d["classes"]).long(),
                              cond_drop_mask=torch.from_numpy(d["mask"]))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_out), rtol=1e-5, atol=1e-5)
    for field in ("timesteps", "sampling_timesteps", "objective",
                  "auto_normalize"):
        assert getattr(diffusion, field) == getattr(jdiff, field)


def test_generate_reads_a_dit_checkpoint(tmp_path):
    from vqgan_tpu_torch import generate

    cfg = LDMConfig(**TINY_LDM, results_folder=str(tmp_path / "res"))
    jmodel, _ = j_build(JLDMConfig(**TINY_LDM))
    state = dit_state_from_jax(random_params(jmodel, seed=4))
    CheckpointManager(tmp_path / "res", prefix="model").save(
        1, {"step": 7, "ema": state}, config=dataclasses.asdict(cfg))

    config, weights = generate.load_checkpoint(tmp_path / "res")
    assert config == cfg
    _, model = generate.load_model(config, weights, "cpu")
    assert isinstance(model, DiT)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)

    out = tmp_path / "generated"
    result = generate.main([
        "--checkpoint", str(tmp_path / "res"), "--random_init", "--seed",
        "0", "--device", "cpu", "--output_dir", str(out), "--user_ids", "2",
        "--num_images", "3", "--batch_size", "2", "--cond_scale", "3.0"])
    assert result["images"] == [out / "ID_2" / f"generated_{i:03d}.jpg"
                                for i in range(3)]
    for path in result["images"]:
        with Image.open(path) as img:
            assert img.size == (64, 64) and img.mode == "RGB"
    assert json.loads((tmp_path / "res" / "model-1.config.json").read_text()
                      )["model_type"] == "dit"
