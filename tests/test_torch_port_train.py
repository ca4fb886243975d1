"""Port parity: the training slice's modules against the JAX package's.

A small CFG U-Net (dim 16, mults (1, 2), 2 heads x 16, 8x8x4 latents, 3
classes) in fp32 on both sides, the JAX params filled from a numpy seed and
carried into the port with `cfg_unet_state_from_jax`; gradients come back
the same way. t, noise and the cond-drop mask are injected on both sides
(the JAX model's mask through its apply function).

- `p_losses` and `loss`: the loss and every parameter's gradient.
- `supcon_loss` with labels, an explicit mask, or neither.
- `ema_update` over 15 steps through the warm-copy and ramp regimes.
- The optimizer over 6 gradients (3 updates) against `make_ldm_optimizer`:
  clipping, weight decay, warmup and MultiSteps k = 2.
- Whole training steps against the JAX composition: `value_and_grad` of
  `p_losses`, `optimizer.update`, `apply_updates`, `ema_update`.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vqgan_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from vqgan_tpu.losses.contrastive import supcon_loss as j_supcon
from vqgan_tpu.models import CFGUnet as JCFGUnet
from vqgan_tpu.training.ema import ema_update as j_ema_update
from vqgan_tpu.training.ldm_step import make_ldm_optimizer as j_optimizer
from vqgan_tpu_torch.checkpoint.from_jax import cfg_unet_state_from_jax
from vqgan_tpu_torch.diffusion import GaussianDiffusion
from vqgan_tpu_torch.losses import supcon_loss
from vqgan_tpu_torch.models import CFGUnet
from vqgan_tpu_torch.training import (
    LDMTrainState,
    ema_update,
    make_ldm_optimizer,
    make_ldm_train_step,
)

torch.set_num_threads(2)

UNET = dict(dim=16, num_classes=3, cond_drop_prob=0.0, dim_mults=(1, 2),
            channels=4, attn_dim_head=16, attn_heads=2)
DIFF = dict(image_size=8, channels=4, timesteps=20, objective="pred_v",
            beta_schedule="cosine", min_snr_loss_weight=True,
            min_snr_gamma=5.0, auto_normalize=False)
B = 4


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


class JaxSide:
    """The JAX U-Net and diffusion with an injectable cond-drop mask."""

    def __init__(self, **diff):
        self.net = JCFGUnet(**UNET)
        self.params = random_params(
            self.net, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1,), jnp.int32), cond_drop_mask=jnp.zeros((1,), bool))
        self.mask = None

        def model_apply(p, x, t, classes, cond_drop_mask=None,
                        cond_drop_prob=None, rng=None,
                        return_features=False):
            return self.net.apply(p, x, t, classes,
                                  cond_drop_mask=self.mask,
                                  return_features=return_features)

        self.diffusion = JGaussianDiffusion(model_apply, **{**DIFF, **diff})

        @jax.jit
        def loss_and_grads(params, x, t, classes, noise, mask):
            self.mask = mask  # read by model_apply while this traces

            def loss_fn(p):
                return self.diffusion.p_losses(
                    p, jax.random.PRNGKey(0), x, t, classes, noise=noise)

            return jax.value_and_grad(loss_fn)(params)

        self._loss_and_grads = loss_and_grads

    def loss_and_grads(self, params, x, t, classes, noise, mask):
        return self._loss_and_grads(params, x, t, classes, noise, mask)


@pytest.fixture(scope="module")
def jax_side():
    return JaxSide()


def port_model(jax_params):
    net = CFGUnet(**UNET)
    net.load_state_dict(cfg_unet_state_from_jax(jax_params))
    return net.train()


def batch(seed, b=B):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal((b, 8, 8, 4)).astype(np.float32),
                t=rng.integers(0, 20, b).astype(np.int32),
                classes=rng.integers(0, 3, b).astype(np.int32),
                noise=rng.standard_normal((b, 8, 8, 4)).astype(np.float32),
                mask=rng.random(b) < 0.5)


def assert_grads_match(net, jax_grads, atol):
    """Port gradients (None for a parameter the loss does not reach, i.e.
    zero) against the JAX gradients carried into the port's names."""
    want = cfg_unet_state_from_jax(jax.tree.map(np.asarray, jax_grads))
    for name, p in net.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        torch.testing.assert_close(got, want[name], rtol=1e-4, atol=atol,
                                   msg=lambda m: f"{name}: {m}")


def test_p_losses_and_gradients_match_jax(jax_side):
    data = batch(1)
    j_loss, j_grads = jax_side.loss_and_grads(jax_side.params, **data)
    net = port_model(jax_side.params)
    diffusion = GaussianDiffusion(net, **DIFF, device="cpu")
    loss = diffusion.p_losses(
        data["x"], torch.from_numpy(data["t"]).long(),
        torch.from_numpy(data["classes"]).long(), noise=data["noise"],
        cond_drop_mask=torch.from_numpy(data["mask"]))
    loss.backward()
    # one fp32 forward of O(1) values, Min-SNR weights <= 5: rounding only
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    # fp32 backward through ~40 layers in other summation orders; the
    # largest gradient is O(1)
    assert_grads_match(net, j_grads, atol=2e-5)
    # the mid-block attention's gradient went through the flash backward
    assert net.mid_attn.fn.fn.to_qkv.weight.grad.abs().max() > 0


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0"])
def test_loss_normalizes_and_matches_jax_p_losses(objective):
    # `loss` with auto_normalize and an injected t is JAX's p_losses of the
    # normalized input; the other two objectives' targets
    side = JaxSide(objective=objective, auto_normalize=True,
                   min_snr_loss_weight=False)
    data = batch(2)
    img = (data["x"] * 0.25 + 0.5).astype(np.float32)  # images in [0, 1]
    j_loss, _ = side.loss_and_grads(side.params, img * 2.0 - 1.0,
                                    data["t"], data["classes"],
                                    data["noise"], data["mask"])
    net = port_model(side.params)
    diffusion = GaussianDiffusion(net, **{**DIFF, "objective": objective,
                                          "auto_normalize": True,
                                          "min_snr_loss_weight": False},
                                  device="cpu")
    with torch.no_grad():
        loss = diffusion.loss(
            img, torch.from_numpy(data["classes"]).long(),
            t=torch.from_numpy(data["t"]).long(), noise=data["noise"],
            cond_drop_mask=torch.from_numpy(data["mask"]))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)


def test_offset_noise_adds_a_per_channel_constant(jax_side):
    net = port_model(jax_side.params)
    data = batch(3)
    args = (data["x"], torch.from_numpy(data["t"]).long(),
            torch.from_numpy(data["classes"]).long())
    mask = torch.from_numpy(data["mask"])
    with torch.no_grad():
        offset = torch.randn((B, 4), generator=torch.Generator().manual_seed(5))
        shifted = data["noise"] + 0.1 * offset.numpy()[:, None, None, :]
        plain = GaussianDiffusion(net, **DIFF, device="cpu").p_losses(
            *args, noise=shifted, cond_drop_mask=mask)
        with_offset = GaussianDiffusion(
            net, **DIFF, offset_noise_strength=0.1, device="cpu").p_losses(
            *args, noise=data["noise"], cond_drop_mask=mask,
            generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(with_offset, plain, rtol=1e-6, atol=0)


def features(seed=4):
    """[6, 2, 8] L2-normalised fp32 views from a numpy seed."""
    f = np.random.default_rng(seed).standard_normal((6, 2, 8)).astype(
        np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


@pytest.mark.parametrize("mode,labelled", [("all", True), ("one", True),
                                           ("all", False), ("one", False)])
def test_supcon_matches_jax(mode, labelled):
    f = features()
    labels = np.array([0, 1, 0, 2, 1, 2]) if labelled else None
    j = j_supcon(jnp.asarray(f),
                 None if labels is None else jnp.asarray(labels),
                 contrast_mode=mode)
    t = supcon_loss(torch.from_numpy(f),
                    None if labels is None else torch.from_numpy(labels),
                    contrast_mode=mode)
    # fp32 logits / 0.07 of O(1) dots, then a log-sum-exp
    np.testing.assert_allclose(t.item(), float(j), rtol=1e-5)


def test_supcon_with_a_mask_matches_jax():
    # an asymmetric mask: positives that no labelling gives, and an anchor
    # with none (left out of the mean)
    f = features(5)
    mask = (np.random.default_rng(6).random((6, 6)) < 0.4).astype(np.float32)
    mask[3] = 0.0
    j = j_supcon(jnp.asarray(f), mask=jnp.asarray(mask))
    t = supcon_loss(torch.from_numpy(f), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(t.item(), float(j), rtol=1e-5)


def test_ema_update_matches_jax_through_warm_and_ramp():
    # update_every 2, update_after_step 6: steps 0-6 copy on even steps,
    # 8-14 mix with the ramped decay, odd steps leave the EMA alone
    rng = np.random.default_rng(6)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    j_ema = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    t_ema = [torch.from_numpy(a.copy()) for a in j_ema]
    kw = dict(decay=0.9, update_every=2, update_after_step=6)
    for step in range(15):
        new = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        j_ema = j_ema_update(j_ema, [jnp.asarray(a) for a in new],
                             jnp.asarray(step), **kw)
        ema_update(t_ema, [torch.from_numpy(a) for a in new], step, **kw)
        for a, b in zip(t_ema, j_ema):
            # one fp32 multiply-add per step
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       err_msg=f"step {step}")


def test_optimizer_matches_optax_with_clip_decay_warmup_and_accumulation():
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 3), "b": (6,), "c": (2, 5)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    kw = dict(learning_rate=1e-2, weight_decay=1e-2, betas=(0.9, 0.99),
              max_grad_norm=1.0, warmup_steps=2, gradient_accumulate_every=2)
    tx = j_optimizer(**kw)
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    j_state = tx.init(j_params)
    t_params = [torch.nn.Parameter(torch.from_numpy(v.copy()))
                for v in init.values()]
    opt = make_ldm_optimizer(t_params, **kw)
    updated = []
    for i in range(6):
        # grad norms around the clip threshold: some calls clip, some not
        scale = [0.3, 2.0, 0.5, 3.0, 0.2, 0.4][i]
        grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        upd, j_state = tx.update({k: jnp.asarray(v)
                                  for k, v in grads.items()},
                                 j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        updated.append(opt.step([torch.from_numpy(g)
                                 for g in grads.values()]))
        for t, key in zip(t_params, shapes):
            # elementwise fp32 Adam arithmetic, no reductions but the norm
            np.testing.assert_allclose(t.detach().numpy(),
                                       np.asarray(j_params[key]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"call {i}, {key}")
    assert updated == [False, True] * 3 and opt.count == 3
    # warmup: the first update ran at learning rate 0 and only its moments
    # moved the state; the parameters moved from the second update on
    assert opt.lr_at(0) == 0.0 and opt.lr_at(1) == 5e-3


def test_train_steps_match_the_jax_composition(jax_side):
    lr = 1e-3
    kw = dict(learning_rate=lr, weight_decay=1e-4, betas=(0.9, 0.99),
              max_grad_norm=1.0)
    ema_kw = dict(decay=0.995, update_every=1, update_after_step=0)

    # JAX: value_and_grad of p_losses, optimizer.update, ema_update
    tx = j_optimizer(**kw)

    @jax.jit
    def j_update(grads, opt_state, params, ema, step):
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = j_ema_update(ema, params, step, **ema_kw)
        return opt_state, params, ema, optax.global_norm(grads)

    params = jax.tree.map(jnp.asarray, jax_side.params)
    opt_state, ema = tx.init(params), params
    j_logs = []
    for step in range(3):
        loss, grads = jax_side.loss_and_grads(params, **batch(10 + step))
        opt_state, params, ema, norm = j_update(grads, opt_state, params,
                                                ema, jnp.asarray(step))
        j_logs.append((float(loss), float(norm)))

    net = port_model(jax_side.params)
    diffusion = GaussianDiffusion(net, **DIFF, device="cpu")
    opt = make_ldm_optimizer(net.parameters(), **kw)
    state = LDMTrainState(0, net, copy.deepcopy(net).requires_grad_(False),
                          opt)
    train_step = make_ldm_train_step(
        diffusion, opt, ema_decay=ema_kw["decay"],
        ema_update_every=ema_kw["update_every"],
        ema_update_after_step=ema_kw["update_after_step"])
    for step in range(3):
        data = batch(10 + step)
        log = train_step(state, torch.from_numpy(data["x"]),
                         torch.from_numpy(data["classes"]).long(),
                         t=torch.from_numpy(data["t"]).long(),
                         noise=data["noise"],
                         cond_drop_mask=torch.from_numpy(data["mask"]))
        assert set(log) == {"loss", "diffusion_loss", "grad_norm"}
        # fp32 forward and backward: rounding in another summation order
        np.testing.assert_allclose(
            [log["loss"].item(), log["grad_norm"].item()], j_logs[step],
            rtol=1e-4)
    assert state.step == 3 and opt.count == 3

    # Adam divides each gradient by its own running RMS, so a gradient
    # element that rounds differently moves its weight by up to ~lr; the
    # fp32 gradients agree to ~1e-6 relative, far from such flips, and the
    # weights agree to a small fraction of lr
    for tree, module in ((params, net), (ema, state.ema_model)):
        want = cfg_unet_state_from_jax(jax.tree.map(np.asarray, tree))
        for name, value in module.state_dict().items():
            torch.testing.assert_close(value, want[name], rtol=0,
                                       atol=0.05 * lr,
                                       msg=lambda m: f"{name}: {m}")
