"""Port parity: vqgan_tpu_torch.core against vqgan_tpu.core.

Same numpy inputs through both; schedules must agree bit for bit (both are
float64 numpy math cast once to float32), the elementwise math to fp32
rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.core import diffusion_math as jdm
from vqgan_tpu.core.guidance import apply_cfg as j_apply_cfg
from vqgan_tpu.core.guidance import project as j_project
from vqgan_tpu.core.schedules import make_schedule as j_make_schedule
from vqgan_tpu_torch.core import diffusion_math as tdm
from vqgan_tpu_torch.core.guidance import apply_cfg as t_apply_cfg
from vqgan_tpu_torch.core.guidance import project as t_project
from vqgan_tpu_torch.core.schedules import make_schedule as t_make_schedule

torch.set_num_threads(2)

FIELDS = [
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2", "snr", "loss_weight",
]
# elementwise fp32 math on the same inputs: a few ulps of the values (~1-10)
ATOL = 1e-5
# c = sqrt(1 - alpha_next - sigma^2) cancels near t = T: at T=20, 19 -> 15
# both frameworks' fp32 c is ~5e-6 off the float64 value (0.0072721), in
# opposite directions, and c multiplies noise of magnitude ~3
DDIM_ATOL = 1e-4


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0", "pred_v"])
@pytest.mark.parametrize("schedule", ["linear", "cosine", "sigmoid"])
def test_schedule_fields_match_jax(schedule, objective):
    j = j_make_schedule(schedule, 100, objective=objective,
                        min_snr_loss_weight=True, min_snr_gamma=5.0)
    t = t_make_schedule(schedule, 100, objective=objective,
                        min_snr_loss_weight=True, min_snr_gamma=5.0)
    assert t.num_timesteps == j.num_timesteps == 100
    for name in FIELDS:
        tv = getattr(t, name)
        assert tv.dtype == torch.float32, name
        np.testing.assert_array_equal(tv.numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)


@pytest.fixture(scope="module")
def math_inputs():
    rng = np.random.default_rng(0)
    shape = (4, 4, 8, 8)
    x0, xt, noise, out = (rng.standard_normal(shape).astype(np.float32)
                          for _ in range(4))
    t = np.array([0, 5, 17, 19])
    return x0, xt, noise, out, t


@pytest.mark.parametrize("name", [
    "q_sample", "predict_start_from_noise", "predict_noise_from_start",
    "predict_v", "predict_start_from_v", "q_posterior"])
def test_diffusion_math_matches_jax(name, math_inputs):
    x0, xt, noise, out, t = math_inputs
    js = j_make_schedule("cosine", 20, objective="pred_v")
    ts = t_make_schedule("cosine", 20, objective="pred_v")
    tt = torch.from_numpy(t)
    jt = jnp.asarray(t, jnp.int32)
    if name == "q_sample":
        j = jdm.q_sample(js, jnp.asarray(x0), jt, jnp.asarray(noise))
        p = tdm.q_sample(ts, torch.from_numpy(x0), tt, torch.from_numpy(noise))
    elif name == "q_posterior":
        j = jdm.q_posterior(js, jnp.asarray(x0), jnp.asarray(xt), jt)
        p = tdm.q_posterior(ts, torch.from_numpy(x0), torch.from_numpy(xt), tt)
    elif name in ("predict_v",):
        j = jdm.predict_v(js, jnp.asarray(x0), jt, jnp.asarray(noise))
        p = tdm.predict_v(ts, torch.from_numpy(x0), tt, torch.from_numpy(noise))
    else:
        j = getattr(jdm, name)(js, jnp.asarray(xt), jt, jnp.asarray(out))
        p = getattr(tdm, name)(ts, torch.from_numpy(xt), tt,
                               torch.from_numpy(out))
    j = j if isinstance(j, tuple) else (j,)
    p = p if isinstance(p, tuple) else (p,)
    for a, b in zip(j, p):
        np.testing.assert_allclose(b.numpy(), np.broadcast_to(
            np.asarray(a), b.shape), rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("time,time_next", [(19, 15), (4, 0), (0, -1)])
@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_step_matches_jax(time, time_next, eta, math_inputs):
    x0, xt, noise, out, _ = math_inputs
    js = j_make_schedule("cosine", 20, objective="pred_v")
    ts = t_make_schedule("cosine", 20, objective="pred_v")
    j = jdm.ddim_step(js, jnp.asarray(xt), jnp.asarray(x0), jnp.asarray(out),
                      jnp.int32(time), jnp.int32(time_next),
                      jnp.asarray(noise), eta)
    p = tdm.ddim_step(ts, torch.from_numpy(xt), torch.from_numpy(x0),
                      torch.from_numpy(out), time, time_next,
                      torch.from_numpy(noise), eta)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=DDIM_ATOL)
    if time_next < 0:  # final step returns x_start exactly
        np.testing.assert_array_equal(p.numpy(), x0)


@pytest.mark.parametrize("phi", [0.0, 0.7])
def test_apply_cfg_matches_jax(phi, math_inputs):
    _, _, cond, null, _ = math_inputs
    j = j_apply_cfg(jnp.asarray(cond), jnp.asarray(null), 3.0, phi)
    p = t_apply_cfg(torch.from_numpy(cond), torch.from_numpy(null), 3.0, phi)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5, atol=ATOL)


def test_project_matches_jax(math_inputs):
    x, y, *_ = math_inputs
    for a, b in zip(j_project(jnp.asarray(x), jnp.asarray(y)),
                    t_project(torch.from_numpy(x), torch.from_numpy(y))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)
