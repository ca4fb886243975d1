"""Port parity: the diffusion variants (vqgan_tpu_torch/diffusion/
{learned_variance,weighted_objective,repaint,guided,continuous_time}.py)
against the JAX package's, and dropout under the DDPM trainer.

A tiny DDPM U-Net (dim 8, mults (1, 2), 8 x 8 x 3 images, 2 heads x 16) in
fp32 on both sides, its JAX params filled from a numpy seed and carried
over with `ddpm_unet_state_from_jax` (at out_dim 2C for the learned
variance, 2C + 2 for the weighted objective; with learned sinusoidal time
features for continuous time, whose schedule goes over with
`learned_log_snr_state_from_jax`). The JAX functions draw from PRNG keys;
the tests replay the key splits and hand the draws to the port.

Tolerances: losses and module outputs 1e-4 (relative and absolute),
gradients 1e-4 of the largest JAX gradient, samplers of 3-5 model steps
1e-3 (absolute, on outputs in [0, 1]).

- Dropout: a KarrasUnet with dropout 0.1 under the port's `Trainer`
  computes JAX's `ElucidatedDiffusion.loss` (JAX's trainers never ask for
  dropout, so neither does the port's).
- Learned variance: `normal_kl`, the discretized log-likelihood, the
  hybrid loss and its gradients, `loss` from JAX's draws, the ancestral
  sampler.
- Weighted objective: the triple loss and its gradients, the sampler, DDIM
  refused.
- RePaint: the (op, t) schedule, `inpaint` from JAX's draws.
- Classifier guidance: the cond_fn's gradient, the guided ancestral and
  DDIM samplers from JAX's draws.
- Continuous time: the schedules, `LearnedLogSNR` (values, endpoints,
  monotonicity, the gradient fraction), the losses (linear, cosine,
  learned, Min-SNR; the v variant) with gradients, the samplers; the
  learned schedule trains and is averaged with the denoiser in `Trainer`.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vqgan_tpu.diffusion import ElucidatedDiffusion as JEDM
from vqgan_tpu.diffusion import continuous_time as jct
from vqgan_tpu.diffusion import guided as jguided
from vqgan_tpu.diffusion import learned_variance as jlv
from vqgan_tpu.diffusion.repaint import RePaintDiffusion as JRePaint
from vqgan_tpu.diffusion.repaint import build_repaint_schedule as j_schedule
from vqgan_tpu.diffusion.weighted_objective import (
    WeightedObjectiveGaussianDiffusion as JWeighted,
)
from vqgan_tpu.models import karras_unet as jk
from vqgan_tpu.models.unet import Unet as JUnet
from vqgan_tpu_torch.checkpoint import (
    ddpm_unet_state_from_jax,
    karras_unet_state_from_jax,
    learned_log_snr_state_from_jax,
)
from vqgan_tpu_torch.diffusion import (
    ContinuousTimeGaussianDiffusion,
    ElucidatedDiffusion,
    GuidedGaussianDiffusion,
    LearnedLogSNR,
    LearnedScheduleDenoiser,
    LearnedVarianceGaussianDiffusion,
    RePaintDiffusion,
    VParamContinuousTimeGaussianDiffusion,
    WeightedObjectiveGaussianDiffusion,
)
from vqgan_tpu_torch.diffusion import continuous_time as tct
from vqgan_tpu_torch.diffusion import learned_variance as tlv
from vqgan_tpu_torch.diffusion.guided import make_classifier_cond_fn
from vqgan_tpu_torch.diffusion.repaint import build_repaint_schedule
from vqgan_tpu_torch.models import KarrasUnet, Unet
from vqgan_tpu_torch.training.ddpm_trainer import Trainer

torch.set_num_threads(2)

UNET = dict(dim=8, dim_mults=(1, 2), channels=3, attn_heads=2,
            attn_dim_head=16)
B = 4
SHAPE = (B, 8, 8, 3)
T = 5
DIFF = dict(image_size=8, channels=3, timesteps=T, objective="pred_noise",
            beta_schedule="cosine")


def fill(shapes, seed=0):
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
        elif path[-1] == "gain":
            n = 0.5 + 0.1 * n  # JAX initialises the gains to 0
        out[path] = n
    return unflatten_dict(out)


def unet_pair(seed=0, time=np.float32, **kw):
    kw = {**UNET, **kw}
    jnet = JUnet(**kw)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,), time))
    params = fill(shapes, seed)
    net = Unet(**kw)
    net.load_state_dict(ddpm_unet_state_from_jax(params))
    return jnet, params, net


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def grads_close(named_params, want):
    size = max(float(v.abs().max()) for v in want.values())
    for name, p in named_params:
        # fp32 backward through ~20 layers in other summation orders
        torch.testing.assert_close(p.grad, want[name], rtol=0,
                                   atol=1e-4 * size,
                                   msg=lambda m: f"{name}: {m}")


def ancestral_draws(key, n, shape=SHAPE):
    """JAX's samplers' draws: k_init, k_loop = split(key); the initial
    noise from k_init; per step k, kn = split(k) and a draw from kn."""
    k_init, k = jax.random.split(key)
    init = np.array(jax.random.normal(k_init, shape, jnp.float32))
    steps = []
    for _ in range(n):
        k, kn = jax.random.split(k)
        steps.append(np.array(jax.random.normal(kn, shape, jnp.float32)))
    return init, np.stack(steps)


def loss_inputs(seed=8):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    noise = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.array([0, 1, 3, 4], np.int32)
    return x, noise, t


# --- dropout under the trainer ----------------------------------------------


def test_trainer_loss_over_a_dropout_karras_unet_matches_jax():
    """The port's `Trainer` puts its model in train mode; dropout must
    still stay off unless the caller asks, as in JAX's trainer, so one
    `train_step` computes JAX's EDM loss on the same weights and draws."""
    kw = dict(image_size=16, dim=16, dim_max=32, channels=3,
              num_downsamples=1, num_blocks_per_stage=1, attn_res=(8,),
              attn_dim_head=16, dropout=0.1)
    jnet = jk.KarrasUnet(**kw)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)))
    params = fill(shapes, 1)
    net = KarrasUnet(**kw)
    net.load_state_dict(karras_unet_state_from_jax(params))
    jd = JEDM(lambda p, x, t, self_cond=None: jnet.apply(p, x, t, self_cond),
              image_size=16, channels=3)
    td = ElucidatedDiffusion(net, image_size=16, channels=3, device="cpu")
    images = np.random.default_rng(2).random((2, 16, 16, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    j_loss = float(jax.jit(lambda p: jd.loss(p, key, jnp.asarray(images)))(
        params))
    k_sigma, k_noise, _ = jax.random.split(key, 3)
    sigmas = np.array(jd.noise_distribution(k_sigma, 2))
    noise = np.array(jax.random.normal(k_noise, images.shape, jnp.float32))
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(td, net, train_batch_size=2, results_folder=tmp)
        assert trainer.model.training
        loss = trainer.train_step(torch.from_numpy(images), sigmas=sigmas,
                                  noise=noise)
    np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-4, atol=1e-4)


# --- the diffusions run on the card unless asked for the CPU ----------------


@pytest.mark.parametrize("name", [
    "GaussianDiffusion", "GaussianDiffusion1D", "ElucidatedDiffusion",
    "LearnedVarianceGaussianDiffusion", "WeightedObjectiveGaussianDiffusion",
    "RePaintDiffusion", "GuidedGaussianDiffusion",
    "ContinuousTimeGaussianDiffusion",
    "VParamContinuousTimeGaussianDiffusion", "SimpleDiffusion"])
def test_diffusion_defaults_to_the_card_and_raises_without_one(
        name, monkeypatch):
    """A diffusion built with no device, as the DDPM `Trainer` is handed
    one, runs on the GPU; with no GPU it raises rather than training on the
    CPU, which runs only when asked for. The trainer takes its device from
    the diffusion."""
    import vqgan_tpu_torch.diffusion as tdiff
    cls = getattr(tdiff, name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(lambda x, t: x, image_size=8)
    on_cpu = cls(lambda x, t: x, image_size=8, device="cpu")
    assert on_cpu.device == torch.device("cpu")
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(on_cpu, torch.nn.Linear(1, 1), train_batch_size=1,
                          num_samples=1, results_folder=tmp)
    assert trainer.device == torch.device("cpu")


# --- learned variance -------------------------------------------------------


def test_normal_kl_and_discretized_log_likelihood_match_jax():
    rng = np.random.default_rng(4)
    m1, v1, m2, v2 = (rng.standard_normal((3, 5)).astype(np.float32)
                      for _ in range(4))
    np.testing.assert_allclose(
        tlv.normal_kl(*map(torch.from_numpy, (m1, v1, m2, v2))).numpy(),
        np.asarray(jlv.normal_kl(m1, v1, m2, v2)), rtol=1e-5, atol=1e-6)
    x = np.concatenate([np.array([-1.0, 1.0, -0.9995, 0.9995], np.float32),
                        rng.uniform(-1, 1, 60).astype(np.float32)])
    # means near x and scales that keep the CDFs off their saturation: where
    # both CDFs round to within a few ulp of 1, their fp32 difference is
    # cancellation on both sides (the tanh approximation's), not a value
    means = x + 0.1 * rng.standard_normal(64).astype(np.float32)
    log_scales = rng.uniform(-2, 0, 64).astype(np.float32)
    got = tlv.discretized_gaussian_log_likelihood(
        torch.from_numpy(x), means=torch.from_numpy(means),
        log_scales=torch.from_numpy(log_scales)).numpy()
    want = np.asarray(jlv.discretized_gaussian_log_likelihood(
        x, means=means, log_scales=log_scales))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def lv_pair(objective="pred_noise"):
    jnet, params, net = unet_pair(seed=5, learned_variance=True)
    kw = {**DIFF, "objective": objective}
    jd = jlv.LearnedVarianceGaussianDiffusion(
        lambda p, x, t: jnet.apply(p, x, t), **kw)
    return jd, params, LearnedVarianceGaussianDiffusion(net, **kw,
                                                        device="cpu")


@pytest.mark.parametrize("clip_denoised", [False, True])
def test_learned_variance_loss_and_gradients_match_jax(clip_denoised):
    jd, params, td = lv_pair()
    x, noise, t = loss_inputs()
    j_loss, j_grads = jax.jit(jax.value_and_grad(lambda p: jd.p_losses(
        p, None, jnp.asarray(x), jnp.asarray(t), noise=jnp.asarray(noise),
        clip_denoised=clip_denoised)))(params)
    loss = td.p_losses(x, torch.from_numpy(t).long(), noise=noise,
                       clip_denoised=clip_denoised)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4,
                               atol=1e-4)
    grads_close(td.model.named_parameters(), ddpm_unet_state_from_jax(
        jax.tree.map(np.asarray, j_grads)))


def test_learned_variance_mean_variance_and_loss_from_jax_draws():
    jd, params, td = lv_pair()
    x, _, t = loss_inputs()
    got = td.p_mean_variance(nchw(x), torch.from_numpy(t).long(),
                             clip_denoised=True)
    want = jd.p_mean_variance(params, jnp.asarray(x), jnp.asarray(t),
                              clip_denoised=True)
    for g, w in zip(got, want):  # mean, variance, log variance, x_0
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-4, atol=1e-4)
    img = np.random.default_rng(9).random(SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(12)
    j_loss = float(jax.jit(lambda p: jd.loss(p, key, jnp.asarray(img)))(
        params))
    k_t, k_p = jax.random.split(key)
    tt = np.array(jax.random.randint(k_t, (B,), 0, T))
    noise = np.array(jax.random.normal(k_p, SHAPE, jnp.float32))
    with torch.no_grad():
        loss = td.loss(img, t=torch.from_numpy(tt).long(), noise=noise)
    np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-4, atol=1e-4)


def test_learned_variance_sampler_matches_jax_from_its_draws():
    jd, params, td = lv_pair()
    key = jax.random.PRNGKey(6)
    j_img = jax.jit(lambda p: jd.p_sample_loop(p, key, SHAPE))(params)
    init, steps = ancestral_draws(key, T)
    t_img = td.p_sample_loop(SHAPE, init_noise=init, step_noise=steps)
    assert t_img.shape == SHAPE
    # 5 fp32 steps from the same draws
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-3)


# --- weighted objective -----------------------------------------------------


def weighted_pair():
    jnet, params, net = unet_pair(seed=7, out_dim=8)
    jd = JWeighted(lambda p, x, t: jnet.apply(p, x, t), **DIFF)
    return jd, params, WeightedObjectiveGaussianDiffusion(net, **DIFF,
                                                          device="cpu")


def test_weighted_objective_loss_gradients_and_sampler_match_jax():
    jd, params, td = weighted_pair()
    x, noise, t = loss_inputs()
    j_loss, j_grads = jax.jit(jax.value_and_grad(lambda p: jd.p_losses(
        p, None, jnp.asarray(x), jnp.asarray(t), noise=jnp.asarray(noise))))(
        params)
    loss = td.p_losses(x, torch.from_numpy(t).long(), noise=noise)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4,
                               atol=1e-4)
    grads_close(td.model.named_parameters(), ddpm_unet_state_from_jax(
        jax.tree.map(np.asarray, j_grads)))

    key = jax.random.PRNGKey(8)
    j_img = jax.jit(lambda p: jd.p_sample_loop(p, key, SHAPE))(params)
    init, steps = ancestral_draws(key, T)
    t_img = td.p_sample_loop(SHAPE, init_noise=init, step_noise=steps)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=1e-3)


def test_weighted_objective_refuses_ddim():
    with pytest.raises(ValueError, match="ddim"):
        WeightedObjectiveGaussianDiffusion(lambda x, t: x, **DIFF,
                                           sampling_timesteps=2, device="cpu")


# --- RePaint ----------------------------------------------------------------


REPAINT = dict(resample_iter=1, resample_jump=2, resample_every=2)


@pytest.mark.parametrize("timesteps,kw", [
    (1000, {}), (20, dict(resample_iter=3, resample_jump=4,
                          resample_every=5)), (T, REPAINT),
    (T, dict(resample=False))])
def test_repaint_schedule_matches_jax(timesteps, kw):
    np.testing.assert_array_equal(build_repaint_schedule(timesteps, **kw),
                                  j_schedule(timesteps, **kw))


def test_repaint_inpaint_matches_jax_from_its_draws():
    jnet, params, net = unet_pair(seed=9)
    kw = {**DIFF, **REPAINT}
    jd = JRePaint(lambda p, x, t: jnet.apply(p, x, t), **kw)
    td = RePaintDiffusion(net, **kw, device="cpu")
    rng = np.random.default_rng(10)
    gt = rng.random(SHAPE).astype(np.float32)
    mask = np.zeros((B, 8, 8, 1), np.float32)
    mask[:, :, :4] = 1.0  # the left half known
    key = jax.random.PRNGKey(11)
    j_img = np.asarray(jax.jit(lambda p: jd.inpaint(
        p, key, jnp.asarray(gt), jnp.asarray(mask)))(params))
    n_ops = len(td.schedule_ops())
    k_init, k = jax.random.split(key)
    init = np.array(jax.random.normal(k_init, SHAPE, jnp.float32))
    blend, step = [], []
    for _ in range(n_ops):
        k, k_blend, k_step = jax.random.split(k, 3)
        blend.append(np.array(jax.random.normal(k_blend, SHAPE, jnp.float32)))
        step.append(np.array(jax.random.normal(k_step, SHAPE, jnp.float32)))
    t_img = td.inpaint(gt, mask, init_noise=init, blend_noise=np.stack(blend),
                       step_noise=np.stack(step)).numpy()
    # the known region is the ground truth, exactly as JAX pastes it
    np.testing.assert_allclose(t_img[:, :, :4], gt[:, :, :4], atol=1e-6)
    # 8 model steps (denoise ops) from the same draws
    np.testing.assert_allclose(t_img, j_img, atol=1e-3)


# --- classifier guidance ----------------------------------------------------


def classifier_pair(seed=12, n_classes=3):
    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((8 * 8 * 3, 16)).astype(np.float32) * 0.2
    w2 = rng.standard_normal((16, n_classes)).astype(np.float32)

    def j_apply(x, t):
        return jnp.tanh(x.reshape(x.shape[0], -1) @ w1) @ w2

    tw1, tw2 = torch.from_numpy(w1), torch.from_numpy(w2)

    def t_apply(x, t):  # NCHW in, the JAX feature order
        return torch.tanh(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
                          @ tw1) @ tw2

    return j_apply, t_apply


def test_classifier_cond_fn_matches_jax():
    j_apply, t_apply = classifier_pair()
    x = np.random.default_rng(13).standard_normal(SHAPE).astype(np.float32)
    y = np.array([0, 2, 1, 2])
    t = np.zeros(B, np.int32)
    want = np.asarray(jguided.make_classifier_cond_fn(j_apply, 2.5)(
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)))
    with torch.no_grad():  # as inside the samplers
        got = make_classifier_cond_fn(t_apply, 2.5)(
            nchw(x), torch.from_numpy(t), torch.from_numpy(y))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sampler", ["p_sample_loop_guided",
                                     "ddim_sample_guided"])
def test_guided_samplers_match_jax_from_their_draws(sampler):
    jnet, params, net = unet_pair(seed=14)
    kw = {**DIFF, "sampling_timesteps": 3}
    jd = jguided.GuidedGaussianDiffusion(
        lambda p, x, t: jnet.apply(p, x, t), **kw)
    td = GuidedGaussianDiffusion(net, **kw, device="cpu")
    j_apply, t_apply = classifier_pair()
    y = np.array([0, 2, 1, 2])
    key = jax.random.PRNGKey(15)
    j_img = np.asarray(jax.jit(lambda p: getattr(jd, sampler)(
        p, key, SHAPE, jguided.make_classifier_cond_fn(j_apply, 3.0),
        {"y": jnp.asarray(y)}))(params))
    n = 3 if sampler.startswith("ddim") else T
    init, steps = ancestral_draws(key, n)
    t_img = getattr(td, sampler)(
        SHAPE, make_classifier_cond_fn(t_apply, 3.0),
        {"y": torch.from_numpy(y)}, init_noise=init, step_noise=steps)
    unguided = getattr(td, sampler)(SHAPE, None, init_noise=init,
                                    step_noise=steps)
    assert (t_img - unguided).abs().max() > 1e-3  # the guidance acts
    np.testing.assert_allclose(t_img.numpy(), j_img, atol=1e-3)


# --- continuous time --------------------------------------------------------


def test_log_snr_schedules_match_jax():
    t = np.linspace(0, 1, 101).astype(np.float32)
    for name in ("beta_linear_log_snr", "alpha_cosine_log_snr"):
        np.testing.assert_allclose(
            getattr(tct, name)(torch.from_numpy(t)).numpy(),
            np.asarray(getattr(jct, name)(jnp.asarray(t))), rtol=1e-5,
            atol=1e-5, err_msg=name)
    assert ContinuousTimeGaussianDiffusion.learned_endpoints() == \
        pytest.approx(jct.ContinuousTimeGaussianDiffusion.learned_endpoints(),
                      rel=1e-6)


def learned_pair(frac_gradient=1.0, seed=16):
    lo_hi = jct.ContinuousTimeGaussianDiffusion.learned_endpoints()
    jsched = jct.LearnedLogSNR(*lo_hi, hidden_dim=8,
                               frac_gradient=frac_gradient)
    params = fill(jax.eval_shape(jsched.init, jax.random.PRNGKey(0),
                                 jnp.zeros((2,))), seed)
    sched = LearnedLogSNR(*lo_hi, hidden_dim=8, frac_gradient=frac_gradient)
    sched.load_state_dict(learned_log_snr_state_from_jax(params))
    return jsched, params, sched


def test_learned_log_snr_matches_jax_and_is_monotone():
    jsched, params, sched = learned_pair()
    t = np.linspace(0, 1, 65).astype(np.float32)
    want = np.asarray(jsched.apply(params, jnp.asarray(t)))
    with torch.no_grad():
        got = sched(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the endpoints exactly as JAX's: the linear schedule's range
    assert got[0] == want[0] == np.float32(sched.log_snr_max)
    assert got[-1] == pytest.approx(float(want[-1]), abs=1e-5)
    assert got[-1] == pytest.approx(sched.log_snr_min, abs=1e-4)
    assert (np.diff(got) < 0).all() and (np.diff(want) < 0).all()


def test_learned_log_snr_gradient_fraction_matches_jax():
    jsched, params, sched = learned_pair(frac_gradient=0.25)
    t = np.array([0.1, 0.5, 0.8], np.float32)
    j_grads = jax.grad(lambda p: jnp.sum(jsched.apply(p, jnp.asarray(t))
                                         ** 2))(params)
    (sched(torch.from_numpy(t)) ** 2).sum().backward()
    grads_close(sched.named_parameters(), learned_log_snr_state_from_jax(
        jax.tree.map(np.asarray, j_grads)))


def ct_pair(noise_schedule, **kw):
    jnet, jp, net = unet_pair(seed=17, learned_sinusoidal_cond=True)
    common = dict(image_size=8, channels=3, num_sample_steps=4, **kw)
    if noise_schedule != "learned":
        jd = jct.ContinuousTimeGaussianDiffusion(
            lambda p, x, s: jnet.apply(p, x, s), noise_schedule=noise_schedule,
            **common)
        return jd, jp, ContinuousTimeGaussianDiffusion(
            net, noise_schedule=noise_schedule, **common, device="cpu")
    jsched, sp, sched = learned_pair()
    jd = jct.ContinuousTimeGaussianDiffusion(
        lambda p, x, s: jnet.apply(p["net"], x, s), noise_schedule="learned",
        log_snr_apply=lambda p, t: jsched.apply(p["sched"], t), **common)
    return jd, {"net": jp, "sched": sp}, ContinuousTimeGaussianDiffusion(
        LearnedScheduleDenoiser(net, sched), noise_schedule="learned",
        **common, device="cpu")


def ct_state(params):
    """The JAX tree of a pair as the port module's state dict."""
    params = jax.tree.map(np.asarray, params)
    if "net" not in params:
        return ddpm_unet_state_from_jax(params)
    out = {f"net.{k}": v for k, v in
           ddpm_unet_state_from_jax(params["net"]).items()}
    out.update({f"log_snr.{k}": v for k, v in
                learned_log_snr_state_from_jax(params["sched"]).items()})
    return out


@pytest.mark.parametrize("noise_schedule,min_snr", [
    ("linear", False), ("cosine", True), ("learned", False)])
def test_continuous_time_loss_and_gradients_match_jax(noise_schedule,
                                                      min_snr):
    jd, params, td = ct_pair(noise_schedule, min_snr_loss_weight=min_snr)
    img = np.random.default_rng(18).random(SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(19)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jd.loss(p, key, jnp.asarray(img))))(params)
    k_t, k_p = jax.random.split(key)
    times = np.array(jax.random.uniform(k_t, (B,)))
    noise = np.array(jax.random.normal(jax.random.split(k_p)[0], SHAPE,
                                       jnp.float32))
    loss = td.loss(img, times=times, noise=noise)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4,
                               atol=1e-4)
    grads_close(td.model.named_parameters(), ct_state(j_grads))


@pytest.mark.parametrize("noise_schedule,clip", [
    ("linear", False), ("cosine", True), ("learned", True)])
def test_continuous_time_sampler_matches_jax_from_its_draws(noise_schedule,
                                                            clip):
    jd, params, td = ct_pair(noise_schedule, clip_sample_denoised=clip)
    key = jax.random.PRNGKey(20)
    j_img = np.asarray(jax.jit(lambda p: jd.sample(p, key, B))(params))
    init, steps = ancestral_draws(key, 4)
    t_img = td.sample(B, init_noise=init, step_noise=steps).numpy()
    assert t_img.shape == SHAPE
    np.testing.assert_allclose(t_img, j_img, atol=1e-3)


def test_v_param_continuous_time_loss_and_sampler_match_jax():
    jnet, params, net = unet_pair(seed=21, learned_sinusoidal_cond=True)
    kw = dict(image_size=8, channels=3, num_sample_steps=3)
    jd = jct.VParamContinuousTimeGaussianDiffusion(
        lambda p, x, s: jnet.apply(p, x, s), **kw)
    td = VParamContinuousTimeGaussianDiffusion(net, **kw, device="cpu")
    img = np.random.default_rng(22).random(SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(23)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jd.loss(p, key, jnp.asarray(img))))(params)
    k_t, k_p = jax.random.split(key)
    loss = td.loss(img, times=np.array(jax.random.uniform(k_t, (B,))),
                   noise=np.array(jax.random.normal(k_p, SHAPE, jnp.float32)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-4,
                               atol=1e-4)
    grads_close(net.named_parameters(), ct_state(j_grads))
    j_img = np.asarray(jax.jit(lambda p: jd.sample(p, key, B))(params))
    init, steps = ancestral_draws(key, 3)
    np.testing.assert_allclose(
        td.sample(B, init_noise=init, step_noise=steps).numpy(), j_img,
        atol=1e-3)


def test_learned_schedule_trains_and_averages_with_the_denoiser():
    """`Trainer` optimises the schedule with the denoiser (one module), and
    its EMA diffusion reads the EMA copy's schedule."""
    _, _, td = ct_pair("learned")
    images = np.random.default_rng(24).random((8, 8, 8, 3)).astype(
        np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(td, td.model, train_batch_size=B, train_lr=1e-3,
                          results_folder=tmp, dataset=[(im, 0)
                                                       for im in images])
        before = trainer.model.log_snr.lin2.weight.detach().clone()
        trainer.train_step(torch.from_numpy(images[:B]))
        moved = trainer.model.log_snr.lin2.weight
        assert not torch.equal(moved, before)
        ema = trainer.ema_diffusion
        assert ema.model is trainer.ema_model
        assert ema.model.log_snr is not td.model.log_snr
        # step 0 copies the online weights into the EMA, schedule included
        torch.testing.assert_close(ema.model.log_snr.lin2.weight, moved,
                                   rtol=0, atol=0)
        out = ema.sample(2, generator=torch.Generator().manual_seed(0))
        assert out.shape == (2, 8, 8, 3) and bool(torch.isfinite(out).all())
