"""Port parity: the samplers as one step body over a per-step table
(`graphs.ChainStep` / `run_chain`), the body that the card captures as a
CUDA graph and replays, run here eagerly on the CPU (`graph=None` and
`graph=False`), against the JAX package's one-program samplers; the
auction's block of bids; the ActNorm discriminator decided on the device
and in the captured VQ-GAN modes; `bench_sampling`.

The denoisers are "oracle" functions of (x, t[, classes][, self-cond]),
the same numpy weights on both sides (a 1 x 1 channel mix, a tanh, a time
and a class term), so the JAX programs compile in a fraction of a second
and the tests hold the samplers' arithmetic: the per-step tables, the last
step's device mask, the carries (self-conditioning, DPM++'s previous
denoised), the guidance, RePaint's two kinds of op. The model forwards
themselves are held to JAX by each sampler's own parity file. T = 4, 3-4
steps; the draws are JAX's own key splits, handed to the port as tensors.

Tolerances: the samplers 1e-4 absolute on [0, 1] outputs (fp32 oracles,
a few steps; their parity files hold the U-Net chains to 1e-3 / 1e-4);
the EDM tables bit for bit against today's host arithmetic; drawn noise
bit for bit against a loop written here from the same generator; the
VQ-GAN block as `test_torch_port_scan_vqgan.py` holds its blocks (every
log at LOSS_RTOL, the usage counts equal, the weights' moves by
MOVE_ATOL / MOVE_MISS).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.diffusion import ElucidatedDiffusion as JEDM
from vqgan_tpu.diffusion import GaussianDiffusion as JGaussian
from vqgan_tpu.diffusion import continuous_time as jct
from vqgan_tpu.diffusion import guided as jguided
from vqgan_tpu.diffusion import simple as jsimple
from vqgan_tpu.diffusion.gaussian_1d import (
    GaussianDiffusion1D as JGaussian1D,
)
from vqgan_tpu.diffusion.learned_variance import (
    LearnedVarianceGaussianDiffusion as JLearnedVariance,
)
from vqgan_tpu.diffusion.repaint import RePaintDiffusion as JRePaint
from vqgan_tpu.diffusion.weighted_objective import (
    WeightedObjectiveGaussianDiffusion as JWeighted,
)
from vqgan_tpu.ops.assignment import auction_assignment as j_auction
from vqgan_tpu_torch.diffusion import (
    ContinuousTimeGaussianDiffusion,
    ElucidatedDiffusion,
    GaussianDiffusion,
    GaussianDiffusion1D,
    GuidedGaussianDiffusion,
    LearnedVarianceGaussianDiffusion,
    RePaintDiffusion,
    SimpleDiffusion,
    VParamContinuousTimeGaussianDiffusion,
    WeightedObjectiveGaussianDiffusion,
    make_classifier_cond_fn,
)
from vqgan_tpu_torch.graphs import (
    ChainGraphs,
    ChainStep,
    LaunchRecord,
    resolve_graph,
    run_chain,
)
from vqgan_tpu_torch.ops.assignment import auction_assignment

torch.set_num_threads(2)

B, T, C, N_CLASSES = 3, 4, 3, 3
SHAPE = (B, 8, 8, C)
CLASSES = np.array([0, 2, 1], np.int32)
ATOL = 1e-4


def weights(out_dim=C, seed=0):
    rng = np.random.default_rng(seed)
    return {"mix": rng.standard_normal((C, out_dim)).astype(np.float32) * 0.5,
            "self": rng.standard_normal((C, out_dim)).astype(np.float32) * 0.2,
            "emb": rng.standard_normal((N_CLASSES + 1, out_dim)).astype(
                np.float32) * 0.3}


def oracle(xp, w, x, t, classes=None, cond_drop_mask=None, self_cond=None):
    """A fixed function of channels-last x [B, ..., C] in either library:
    tanh(x W) + a time term (+ a class term, the null row where dropped)
    (+ the self-condition's mix)."""
    pad = (-1,) + (1,) * (x.ndim - 1)
    out = xp.tanh(x @ w["mix"]) + 0.1 * xp.reshape(
        xp.sin(0.3 * t.astype(xp.float32) if xp is jnp
               else 0.3 * t.float()), pad)
    if self_cond is not None:
        out = out + self_cond @ w["self"]
    if classes is not None:
        if cond_drop_mask is not None:
            classes = xp.where(cond_drop_mask, N_CLASSES, classes)
        out = out + xp.reshape(w["emb"][classes], (x.shape[0],) + (1,) * (
            x.ndim - 2) + (-1,))
    return out


def jax_model(w, conditional=False, self_condition=False):
    w = {k: jnp.asarray(v) for k, v in w.items()}
    if conditional:
        return lambda p, x, t, classes, cond_drop_mask=None, **_: oracle(
            jnp, w, x, t, classes, cond_drop_mask)
    if self_condition:
        return lambda p, x, t, x_self_cond=None, **_: oracle(
            jnp, w, x, t, self_cond=x_self_cond)
    return lambda p, x, t, **_: oracle(jnp, w, x, t)


def torch_model(w, conditional=False, self_condition=False):
    """The same function over channels-first x, as the port's models
    take it."""
    w = {k: torch.from_numpy(v) for k, v in w.items()}

    def last(x):
        return None if x is None else x.movedim(1, -1)

    if conditional:
        def model(x, t, classes, cond_drop_mask=None, **_):
            return oracle(torch, w, last(x), t, classes.long(),
                          cond_drop_mask).movedim(-1, 1)
    elif self_condition:
        def model(x, t, x_self_cond=None):
            return oracle(torch, w, last(x), t,
                          self_cond=last(x_self_cond)).movedim(-1, 1)
    else:
        def model(x, t, *_):
            return oracle(torch, w, last(x), t).movedim(-1, 1)
    return model


def ancestral_draws(key, n, shape=SHAPE):
    """JAX's samplers' draws: k_init, k = split(key); the initial noise
    from k_init; per step k, kn = split(k) and a draw from kn."""
    k_init, k = jax.random.split(key)
    init = np.array(jax.random.normal(k_init, shape, jnp.float32))
    steps = []
    for _ in range(n):
        k, kn = jax.random.split(k)
        steps.append(np.array(jax.random.normal(kn, shape, jnp.float32)))
    return init, np.stack(steps)


def unjitted(fn):
    """fn run op by op (`jax.disable_jit`): the oracles' tiny primitives
    compile once for the whole file, where each sampler's whole program
    would compile anew (about 1.5 s each)."""
    def run(*args):
        with jax.disable_jit():
            return np.asarray(fn(*args))
    return run


def close(got, want, atol=ATOL):
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


DIFF = dict(image_size=8, channels=C, timesteps=T, objective="pred_v",
            beta_schedule="cosine")


# --- the helper ---------------------------------------------------------


class StubKernel:
    """A launch counter as `kernels.build.CudaKernel` keeps one."""

    def __init__(self):
        self.launches, self.launches_by_shape = 0, {}

    def count(self, shape):
        self.launches += 1
        self.launches_by_shape[shape] = self.launches_by_shape.get(
            shape, 0) + 1


def test_chain_runs_the_body_once_per_step_and_counts_launches():
    kernel, rows = StubKernel(), []

    def body(generators, carry, consts, row):
        rows.append(int(row["t"]))
        kernel.count(tuple(carry["x"].shape))
        return {"x": carry["x"] * consts["k"] + row["t"], "extra": None}

    step = ChainStep(body, graphs=ChainGraphs(), key="k",
                     graph=resolve_graph(None, "cpu"))
    out = run_chain(step, {"x": torch.ones(2)}, 3,
                    consts={"k": torch.tensor(2.0), "unused": None},
                    table={"t": torch.tensor([5.0, 6.0, 7.0])})
    assert rows == [5, 6, 7] and set(out) == {"x"}
    torch.testing.assert_close(out["x"], torch.full((2,), 47.0))
    assert kernel.launches == 3 and kernel.launches_by_shape == {(2,): 3}
    assert step.graphs == {}  # eager: nothing captured
    # on the card a capture's counts are taken back and added at each
    # replay (graphs.LaunchRecord), so a captured chain counts the same
    record = LaunchRecord({"kernel": kernel})
    with record.capturing():
        body([], {"x": torch.ones(2)}, {"k": torch.tensor(1.0)},
             {"t": torch.tensor(0.0)})
    assert kernel.launches == 3
    for _ in range(3):
        record.replay()
    assert kernel.launches == 6
    assert resolve_graph(False, "cpu") is False
    with pytest.raises(ValueError, match="graph=True"):
        resolve_graph(True, "cpu")


def test_a_key_keeps_the_graph_of_its_latest_value_only():
    """`ChainStep(latest=)`: a new value (a guide's cond_fn) replaces the
    key's graph, the same value keeps it. On the CPU the graph refuses
    its tensors at the call, after the cache has decided."""
    graphs = ChainGraphs()

    def body(generators, carry, consts, row):
        return {"x": carry["x"] + 1}

    def kept(latest):
        with pytest.raises(ValueError, match="CUDA graph"):
            ChainStep(body, graphs=graphs, key="k", graph=True,
                      latest=latest)({"x": torch.ones(2)})
        assert len(graphs) == 1
        return next(iter(graphs.values()))

    first = kept("a")
    assert kept("a") is first
    second = kept("b")
    assert second is not first and kept("b") is second
    assert kept("a") is not second


def test_a_carry_less_step_returns_every_entry_and_blocks_share_one_cache():
    from vqgan_tpu_torch.graphs import BlockRunner, GraphPool

    def body(generators, carry, consts, row):
        return {"y": row["x"] * 2, "z": row["x"] + 1, "none": None}

    out = ChainStep(body, graphs=ChainGraphs(), key="k", graph=False)(
        {}, row={"x": torch.ones(2)})
    assert set(out) == {"y", "z"}
    pool = GraphPool()
    runner = BlockRunner(lambda gens, x: (x * 2,), pool=pool)
    assert isinstance(runner.graphs, ChainGraphs)
    assert runner.graphs.pool is pool


def test_guidance_kwargs_must_be_hashable_on_every_device():
    gd = GuidedGaussianDiffusion(torch_model(weights()), **DIFF,
                                 device="cpu")

    def cond_fn(x, t, y, w):
        return torch.zeros_like(x)

    kwargs = {"y": torch.zeros(B, dtype=torch.long), "w": [1.0, 2.0]}
    for sample in (gd.p_sample_loop_guided, gd.ddim_sample_guided):
        with pytest.raises(TypeError, match="hashable"):
            sample(SHAPE, cond_fn, kwargs)


def _graph_true_calls():
    gd = GaussianDiffusion(torch_model(weights(), conditional=True), **DIFF,
                           sampling_timesteps=2, device="cpu")
    ed = ElucidatedDiffusion(lambda x, t, s=None: x, image_size=8,
                             num_sample_steps=2, device="cpu")
    ct = ContinuousTimeGaussianDiffusion(torch_model(weights()), image_size=8,
                                         num_sample_steps=2, device="cpu")
    rp = RePaintDiffusion(torch_model(weights()), image_size=8, timesteps=T,
                          device="cpu")
    cls = torch.from_numpy(CLASSES).long()
    return {
        "ddim": lambda: gd.ddim_sample(SHAPE, cls, graph=True),
        "ancestral": lambda: gd.p_sample_loop(SHAPE, cls, graph=True),
        "interpolate": lambda: gd.interpolate(
            np.zeros(SHAPE, np.float32), np.zeros(SHAPE, np.float32), cls,
            t=2, graph=True),
        "heun": lambda: ed.sample(2, graph=True),
        "dpmpp": lambda: ed.sample_using_dpmpp(2, graph=True),
        "logsnr": lambda: ct.sample(2, graph=True),
        "repaint": lambda: rp.inpaint(np.zeros(SHAPE, np.float32),
                                      np.ones((B, 8, 8, 1), np.float32),
                                      graph=True),
        "auction": lambda: auction_assignment(torch.rand(4, 4), graph=True),
    }


@pytest.mark.parametrize("sampler", ["ddim", "ancestral", "interpolate",
                                     "heun", "dpmpp", "logsnr", "repaint",
                                     "auction"])
def test_graph_true_on_the_cpu_raises(sampler):
    with pytest.raises(ValueError, match="graph=True"):
        _graph_true_calls()[sampler]()


# --- GaussianDiffusion: ancestral, DDIM, interpolate ------------------------


@pytest.mark.parametrize("case", ["cfg", "self_condition"])
def test_ancestral_chain_matches_jax(case):
    w = weights(seed=1)
    conditional = case == "cfg"
    kw = dict(DIFF, self_condition=not conditional)
    jd = JGaussian(jax_model(w, conditional, not conditional), **kw)
    td = GaussianDiffusion(torch_model(w, conditional, not conditional),
                           **kw, device="cpu")
    cls = CLASSES if conditional else None
    key = jax.random.PRNGKey(2)
    j_img = unjitted(lambda: jd.p_sample_loop(
        None, key, SHAPE, cls, cond_scale=3.0, rescaled_phi=0.7))()
    init, steps = ancestral_draws(key, T)
    args = (SHAPE, None if cls is None else torch.from_numpy(cls).long())
    kw = dict(cond_scale=3.0, rescaled_phi=0.7, init_noise=init,
              step_noise=steps)
    got = td.p_sample_loop(*args, **kw)
    close(got, j_img)  # the last step (t = 0) by the device mask
    # graph=False is the same eager body
    torch.testing.assert_close(td.p_sample_loop(*args, graph=False, **kw),
                               got, rtol=0, atol=0)


def test_ddim_self_condition_carry_matches_jax():
    w = weights(seed=3)
    kw = dict(DIFF, sampling_timesteps=3, self_condition=True,
              ddim_sampling_eta=0.5)
    jd = JGaussian(jax_model(w, self_condition=True), **kw)
    td = GaussianDiffusion(torch_model(w, self_condition=True), **kw,
                           device="cpu")
    rng = np.random.default_rng(4)
    init = rng.standard_normal(SHAPE).astype(np.float32)
    steps = rng.standard_normal((3, *SHAPE)).astype(np.float32)
    j_img = unjitted(lambda: jd.ddim_sample(
        None, jax.random.PRNGKey(0), SHAPE, None, init_noise=init,
        step_noise=steps))()
    close(td.ddim_sample(SHAPE, None, init_noise=init, step_noise=steps),
          j_img)


def test_interpolate_matches_jax():
    w = weights(seed=5)
    jd = JGaussian(jax_model(w, conditional=True), **DIFF)
    td = GaussianDiffusion(torch_model(w, conditional=True), **DIFF,
                           device="cpu")
    rng = np.random.default_rng(6)
    x1, x2 = (rng.random(SHAPE).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(7)
    j_img = unjitted(lambda: jd.interpolate(None, key, x1, x2, CLASSES, t=3,
                                           lam=0.3))()
    k_q1, k_q2, k = jax.random.split(key, 3)
    noise1, noise2 = (np.array(jax.random.normal(kq, SHAPE, jnp.float32))
                      for kq in (k_q1, k_q2))
    steps = []
    for _ in range(3):
        k, kn = jax.random.split(k)
        steps.append(np.asarray(jax.random.normal(kn, SHAPE, jnp.float32)))
    close(td.interpolate(x1, x2, torch.from_numpy(CLASSES).long(), t=3,
                         lam=0.3, noise1=noise1, noise2=noise2,
                         step_noise=np.stack(steps)), j_img)


# --- the library's ancestral and guided samplers -----------------------------


def _classifier():
    rng = np.random.default_rng(8)
    w1 = rng.standard_normal((8 * 8 * C, 5)).astype(np.float32) * 0.2
    w2 = rng.standard_normal((5, N_CLASSES)).astype(np.float32)
    tw1, tw2 = torch.from_numpy(w1), torch.from_numpy(w2)

    def j_apply(x, t):
        return jnp.tanh(x.reshape(x.shape[0], -1) @ w1) @ w2

    def t_apply(x, t):  # NCHW in, the JAX feature order
        return torch.tanh(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
                          @ tw1) @ tw2

    return j_apply, t_apply


@pytest.mark.parametrize("sampler", ["learned_variance", "weighted_objective",
                                     "guided_ancestral", "guided_ddim"])
def test_library_samplers_match_jax(sampler):
    kw = dict(DIFF, objective="pred_noise")
    if sampler == "learned_variance":
        w = weights(out_dim=2 * C, seed=9)
        jd, td = JLearnedVariance(jax_model(w), **kw), \
            LearnedVarianceGaussianDiffusion(torch_model(w), **kw,
                                             device="cpu")
        j_run = lambda key: jd.p_sample_loop(None, key, SHAPE)  # noqa: E731
        t_run = td.p_sample_loop
        n = T
    elif sampler == "weighted_objective":
        w = weights(out_dim=2 * C + 2, seed=10)
        jd, td = JWeighted(jax_model(w), **kw), \
            WeightedObjectiveGaussianDiffusion(torch_model(w), **kw,
                                               device="cpu")
        j_run = lambda key: jd.p_sample_loop(None, key, SHAPE)  # noqa: E731
        t_run = td.p_sample_loop
        n = T
    else:
        w = weights(seed=11)
        kw["sampling_timesteps"] = 3
        jd = jguided.GuidedGaussianDiffusion(jax_model(w), **kw)
        td = GuidedGaussianDiffusion(torch_model(w), **kw, device="cpu")
        j_apply, t_apply = _classifier()
        y = np.array([0, 2, 1])
        name = ("p_sample_loop_guided" if sampler == "guided_ancestral"
                else "ddim_sample_guided")
        j_run = lambda key: getattr(jd, name)(  # noqa: E731
            None, key, SHAPE, jguided.make_classifier_cond_fn(j_apply, 3.0),
            {"y": jnp.asarray(y)})

        def t_run(shape, **noise):
            return getattr(td, name)(
                shape, make_classifier_cond_fn(t_apply, 3.0),
                {"y": torch.from_numpy(y)}, **noise)
        n = T if sampler == "guided_ancestral" else 3
    key = jax.random.PRNGKey(12)
    j_img = unjitted(j_run)(key)
    init, steps = ancestral_draws(key, n)
    close(t_run(SHAPE, init_noise=init, step_noise=steps), j_img)


# --- EDM ----------------------------------------------------------------


def edm_net(xp):
    def net(x, c_noise, self_cond=None):
        out = 0.8 * xp.tanh(x) + 0.1 * c_noise[:, None, None, None]
        return out if self_cond is None else out + 0.2 * self_cond
    return net


@pytest.mark.parametrize("sampler", ["heun", "heun_self_condition",
                                     "dpmpp"])
def test_edm_samplers_match_jax(sampler):
    kw = dict(image_size=8, channels=C, num_sample_steps=4,
              self_condition=sampler == "heun_self_condition")
    jnet = edm_net(jnp)
    jd = JEDM(lambda p, x, t, s=None: jnet(x, t, s), **kw)
    td = ElucidatedDiffusion(edm_net(torch), **kw, device="cpu")
    key = jax.random.PRNGKey(13)
    if sampler == "dpmpp":
        j_img = unjitted(lambda k: jd.sample_using_dpmpp(None, k, B))(key)
        init = np.array(jax.random.normal(key, SHAPE, jnp.float32))
        close(td.sample_using_dpmpp(B, init_noise=init), j_img)
        return
    j_img = unjitted(lambda k: jd.sample(None, k, B, clamp=False))(key)
    init, steps = ancestral_draws(key, 4)
    close(td.sample(B, clamp=False, init_noise=init, step_noise=steps),
          j_img)


def test_edm_tables_equal_the_host_arithmetic():
    """The tables against the per-step float32 host arithmetic the eager
    loops did before they were one body (copied here), bit for bit."""
    ed = ElucidatedDiffusion(lambda x, t, s=None: x, image_size=8,
                             device="cpu")
    for n in (2, 5, 32):
        sigmas = ed.sample_schedule(n)
        churn = np.float32(min(ed.S_churn / n, math.sqrt(2) - 1))
        gammas = np.where((sigmas >= ed.S_tmin) & (sigmas <= ed.S_tmax),
                          churn, np.float32(0.0)).astype(np.float32)
        heun, dpmpp = ed.heun_table(n), ed.dpmpp_table(n)
        assert heun.dtype == dpmpp.dtype == np.float32
        assert heun.shape == dpmpp.shape == (n, 6)

        def t_fn(s):
            return -np.log(np.maximum(s, np.float32(1e-20)))

        for i in range(n):
            sigma, sigma_next, gamma = sigmas[i], sigmas[i + 1], gammas[i]
            sigma_hat = sigma + gamma * sigma
            want = [sigma_hat,
                    np.sqrt(np.maximum(sigma_hat ** 2 - sigma ** 2,
                                       np.float32(0.0))),
                    np.maximum(sigma_next, np.float32(1e-8)),
                    sigma_next - sigma_hat,
                    np.float32(0.5) * (sigma_next - sigma_hat),
                    np.float32(sigma_next == 0.0)]
            np.testing.assert_array_equal(heun[i], np.array(want, np.float32))
            t, t_next = t_fn(sigma), t_fn(sigma_next)
            h = t_next - t
            plain = i == 0 or sigma_next == 0.0
            row = [sigma, np.exp(-t_next) / np.exp(-t), np.expm1(-h)]
            if plain:
                np.testing.assert_array_equal(dpmpp[i, :3], np.array(
                    row, np.float32))
                assert dpmpp[i, 5] == 1.0
                continue
            h_last = t - t_fn(sigmas[i - 1])
            r = h_last / (h if h != 0 else np.float32(1.0))
            g = np.float32(-1.0) / (np.float32(2.0) * (
                r if r != 0 else np.float32(1.0)))
            np.testing.assert_array_equal(dpmpp[i], np.array(
                row + [np.float32(1.0) - g, g, 0.0], np.float32))


# --- continuous time, simple diffusion ------------------------------------


@pytest.mark.parametrize("kind", ["linear", "v_param", "simple"])
def test_logsnr_samplers_match_jax(kind):
    w = weights(seed=14)
    kw = dict(image_size=8, channels=C, num_sample_steps=3)
    jm, tm = jax_model(w), torch_model(w)
    if kind == "linear":
        jd = jct.ContinuousTimeGaussianDiffusion(jm, **kw)
        td = ContinuousTimeGaussianDiffusion(tm, **kw, device="cpu")
    elif kind == "v_param":
        jd = jct.VParamContinuousTimeGaussianDiffusion(jm, **kw)
        td = VParamContinuousTimeGaussianDiffusion(tm, **kw, device="cpu")
    else:
        jd = jsimple.SimpleDiffusion(jm, pred_objective="eps", noise_d=4,
                                     **kw)
        td = SimpleDiffusion(tm, pred_objective="eps", noise_d=4, **kw,
                             device="cpu")
    key = jax.random.PRNGKey(15)
    j_img = unjitted(lambda k: jd.sample(None, k, B))(key)
    init, steps = ancestral_draws(key, 3)
    close(td.sample(B, init_noise=init, step_noise=steps), j_img)


# --- RePaint -----------------------------------------------------------


def test_repaint_two_kinds_of_op_match_jax():
    w = weights(seed=16)
    kw = dict(DIFF, resample_iter=1, resample_jump=2, resample_every=2)
    jd = JRePaint(jax_model(w), **kw)
    td = RePaintDiffusion(torch_model(w), **kw, device="cpu")
    ops = td.schedule_ops()
    assert set(ops[:, 0].tolist()) == {0, 1}  # both kinds, and t = 0 last
    rng = np.random.default_rng(17)
    gt = rng.random(SHAPE).astype(np.float32)
    mask = np.zeros((B, 8, 8, 1), np.float32)
    mask[:, :, :4] = 1.0
    key = jax.random.PRNGKey(18)
    j_img = unjitted(lambda k: jd.inpaint(None, k, jnp.asarray(gt),
                                         jnp.asarray(mask)))(key)
    k_init, k = jax.random.split(key)
    init = np.array(jax.random.normal(k_init, SHAPE, jnp.float32))
    blend, step = [], []
    for _ in range(len(ops)):
        k, k_blend, k_step = jax.random.split(k, 3)
        blend.append(np.array(jax.random.normal(k_blend, SHAPE, jnp.float32)))
        step.append(np.array(jax.random.normal(k_step, SHAPE, jnp.float32)))
    got = td.inpaint(gt, mask, init_noise=init, blend_noise=np.stack(blend),
                     step_noise=np.stack(step))
    close(got, j_img)
    np.testing.assert_allclose(got[:, :, :4].numpy(), gt[:, :, :4],
                               atol=1e-6)


# --- 1-D ----------------------------------------------------------------


@pytest.mark.parametrize("sampling_timesteps", [3, None],
                         ids=["ddim", "ancestral"])
def test_1d_chains_match_jax(sampling_timesteps):
    w = weights(seed=19)
    kw = dict(image_size=8, channels=C, timesteps=T, seq_length=8,
              sampling_timesteps=sampling_timesteps, objective="pred_v")
    jd = JGaussian1D(jax_model(w), **kw)
    td = GaussianDiffusion1D(torch_model(w), **kw, device="cpu")
    key = jax.random.PRNGKey(20)
    j_seq = unjitted(lambda k: jd.sample(None, k, B))(key)
    init, steps = ancestral_draws(key, sampling_timesteps or T, (B, 8, C))
    fn = td.ddim_sample if sampling_timesteps else td.p_sample_loop
    close(fn((B, 8, C), None, init_noise=init, step_noise=steps), j_seq)


# --- drawn noise: the eager loop's order ------------------------------------


def _draws(gen, n, shape):
    """A loop written here: the initial draw, then one per step, NHWC
    (drawn channels-first as the samplers draw)."""
    b, *space, c = shape

    def one():
        return torch.randn((b, c, *space), generator=gen).movedim(1, -1)

    return one(), torch.stack([one() for _ in range(n)])


@pytest.mark.parametrize("sampler", ["ancestral", "ddim", "heun", "logsnr"])
def test_drawn_noise_follows_the_eager_loops_order(sampler):
    w = weights(seed=21)
    if sampler in ("ancestral", "ddim"):
        td = GaussianDiffusion(torch_model(w, conditional=True), **DIFF,
                               sampling_timesteps=3 if sampler == "ddim"
                               else None, device="cpu")
        cls = torch.from_numpy(CLASSES).long()
        fn = td.ddim_sample if sampler == "ddim" else td.p_sample_loop

        def run(**kw):
            return fn(SHAPE, cls, cond_scale=3.0, **kw)
        n = 3 if sampler == "ddim" else T
    elif sampler == "heun":
        td = ElucidatedDiffusion(edm_net(torch), image_size=8, channels=C,
                                 num_sample_steps=3, device="cpu")

        def run(**kw):
            return td.sample(B, **kw)
        n = 3
    else:
        td = ContinuousTimeGaussianDiffusion(torch_model(w), image_size=8,
                                             num_sample_steps=3, device="cpu")

        def run(**kw):
            return td.sample(B, **kw)
        n = 3
    gen = torch.Generator().manual_seed(22)
    drawn = run(generator=gen)
    after = torch.randn(1, generator=gen)
    ref_gen = torch.Generator().manual_seed(22)
    init, steps = _draws(ref_gen, n, SHAPE)
    torch.testing.assert_close(drawn, run(init_noise=init, step_noise=steps),
                               rtol=0, atol=0)
    # the generator left where the eager loop leaves it
    torch.testing.assert_close(after, torch.randn(1, generator=ref_gen))


# --- the auction ---------------------------------------------------------


@pytest.mark.parametrize("b", [1, 5, 16])
def test_auction_blocks_match_jax(b):
    dist = np.random.default_rng(23 + b).random((b, b)).astype(np.float32)
    want = np.asarray(j_auction(jnp.asarray(dist)))
    graphs = ChainGraphs()
    for graph in (None, False):
        got = auction_assignment(torch.from_numpy(dist), graph=graph,
                                 graphs=graphs)
        np.testing.assert_array_equal(got.numpy(), want)
    assert graphs == {}  # the CPU runs the blocks eagerly


# --- ActNorm ------------------------------------------------------------


def test_actnorm_initialises_on_the_device_as_jax(monkeypatch):
    from vqgan_tpu.models.discriminator import ActNorm as JActNorm
    from vqgan_tpu_torch.models.discriminator import ActNorm

    x = np.random.default_rng(24).standard_normal((3, 4, 4, 5)).astype(
        np.float32) * 2.0 + 1.0
    jnorm = JActNorm()
    variables = jnorm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    j_out, j_stats = jnorm.apply(variables, jnp.asarray(x),
                                 init_actnorm=True, mutable=["actnorm_stats"])
    j_again, _ = jnorm.apply({**variables, **j_stats}, jnp.asarray(x) + 1.0,
                             init_actnorm=True, mutable=["actnorm_stats"])
    norm = ActNorm(5)

    def no_host_read(self):
        raise AssertionError("ActNorm read a tensor on the host")

    monkeypatch.setattr(torch.Tensor, "__bool__", no_host_read)
    with torch.no_grad():
        out = norm(torch.from_numpy(x).permute(0, 3, 1, 2),
                   init_actnorm=True)
        again = norm(torch.from_numpy(x + 1.0).permute(0, 3, 1, 2),
                     init_actnorm=True)  # initialised once: kept
    monkeypatch.undo()
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_out), atol=1e-5)
    np.testing.assert_allclose(again.permute(0, 2, 3, 1).numpy(),
                               np.asarray(j_again), atol=1e-5)
    for name in ("weight", "bias"):
        np.testing.assert_allclose(getattr(norm, name).numpy(), np.asarray(
            j_stats["actnorm_stats"][name]), rtol=1e-6, atol=1e-6)
    assert int(norm.initialized) == 1


def test_vqgan_scan_block_with_actnorm_matches_jax(tmp_path):
    from test_torch_port_scan_vqgan import assert_logs_match
    from test_torch_port_vqgan_train import (
        LR,
        MOVE_ATOL,
        MOVE_MISS,
        VQ,
        JaxSide,
        batches,
        fill,
    )

    from vqgan_tpu.models.discriminator import PatchGANDiscriminator as JD
    from vqgan_tpu.models.lpips import perceptual_loss_fn as j_perceptual
    from vqgan_tpu.training.vqgan_step import (
        make_vqgan_scan_steps as j_scan_steps,
    )
    from vqgan_tpu_torch.checkpoint import (
        lpips_state_from_jax,
        patchgan_state_from_jax,
        vqvae_state_from_jax,
    )
    from vqgan_tpu_torch.configs import VQGANConfig
    from vqgan_tpu_torch.training.vqgan_trainer import VQGANTrainer

    side = JaxSide()
    jdisc = JD(ndf=8, n_layers=2, norm="act")
    shapes = jax.eval_shape(jdisc.init, jax.random.PRNGKey(1),
                            jnp.zeros((1, 32, 32, 3)))
    disc_params = fill({"params": shapes["params"]}, seed=1)
    rng = np.random.default_rng(25)
    stats = {"actnorm_stats": {
        layer: {"initialized": np.zeros((), np.int32),
                "bias": 0.05 * rng.standard_normal(v["bias"].shape).astype(
                    np.float32),
                "weight": (1 + 0.05 * rng.standard_normal(
                    v["weight"].shape)).astype(np.float32)}
        for layer, v in shapes["actnorm_stats"].items()}}

    def disc_apply(params, s, images, train):
        return jdisc.apply({**params, **s}, images, train=train), s

    j_gd, _ = j_scan_steps(
        lambda p, x: side.vqvae.apply(p, x), disc_apply, side.opt_g,
        side.opt_d, disc_start=0, donate=False,
        perceptual_fn=j_perceptual(side.lpips_params, side.lpips))
    data = batches(2, seed=3)
    j_state = side.state().replace(disc_params=disc_params, disc_stats=stats,
                                   opt_d=side.opt_d.init(disc_params))
    j_state, j_logs = j_gd(j_state, jnp.asarray(data))

    cfg = VQGANConfig(
        image_size=32, ch=VQ["ch"], ch_mult=VQ["ch_mult"],
        num_res_blocks=VQ["num_res_blocks"], z_channels=VQ["z_channels"],
        num_embeddings=VQ["num_embeddings"],
        embedding_dim=VQ["embedding_dim"], disc_ndf=8, disc_n_layers=2,
        disc_norm="act", disc_start=0, learning_rate=LR,
        disc_learning_rate=LR, compute_dtype="float32",
        results_folder=str(tmp_path))
    trainer = VQGANTrainer(cfg, device="cpu", step_mode="scan")
    disc_init = patchgan_state_from_jax({**disc_params, **stats})
    trainer.vqvae.load_state_dict(vqvae_state_from_jax(side.vq_params))
    trainer.disc.load_state_dict(disc_init)
    trainer.lpips.load_state_dict(lpips_state_from_jax(side.lpips_params))
    buffers = {k: v.clone() for k, v in trainer.disc.named_buffers()}
    logs = trainer.dispatch_block(torch.from_numpy(data), 0)
    assert trainer.state.step == 2
    assert_logs_match(logs, j_logs, 2)
    want = patchgan_state_from_jax(jax.tree.map(
        np.asarray, {**j_state.disc_params, **j_state.disc_stats}))
    names = [k for k, _ in trainer.disc.named_parameters()]
    moves = torch.cat([(trainer.disc.state_dict()[k] - disc_init[k]).flatten()
                       for k in names])
    want_moves = torch.cat([(want[k] - disc_init[k]).flatten()
                            for k in names])
    assert want_moves.abs().max() > 0.5 * LR  # D took its two updates
    assert ((moves - want_moves).abs() > MOVE_ATOL).float().mean() \
        <= MOVE_MISS
    # the affine's statistics are buffers, JAX's as loaded: no step
    # touches them (no trainer asks for the data-dependent initialisation)
    assert len(buffers) == 3 * 2
    for k, v in trainer.disc.named_buffers():
        assert torch.equal(v, buffers[k]) and torch.equal(v, want[k]), k


# --- bench_sampling ------------------------------------------------------


def test_bench_sampling_prints_the_jax_cli_line(capsys):
    import json

    from vqgan_tpu_torch import bench_sampling

    out = bench_sampling.main(["--device", "cpu", "--batch", "1",
                               "--sampling_timesteps", "2", "--no-decode",
                               "--iters", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert lines[0] == "device: cpu"
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == ("CFG DDIM-2 sampling + VAE decode at 256px "
                              "(dim=96 U-Net, cond_scale=1.0)")
    assert line["unit"] == "samples/sec/chip" and line["value"] > 0
    assert tuple(out["images"].shape) == (1, 32, 32, 4)
    assert bool(torch.isfinite(out["images"]).all())
