"""Port parity: FID and the reports (vqgan_tpu_torch/models/inception.py,
eval/fid.py, eval/tsne.py, eval/plots.py) against the JAX package.

- InceptionV3 features against flax at inputs of 64 px (upsampled to 299)
  and 320 px (downsampled, antialiased), weights and BatchNorm statistics
  from a numpy seed carried over with `inception_state_from_jax`.
- The JAX package's `load_torch_inception_weights` reads the port's
  `state_dict()` unchanged and gives the port's features; a pytorch-fid
  layout (with `fc.` and `AuxLogits.` entries, without
  `num_batches_tracked`) loads with `load_inception_weights`.
- `FIDStats` streaming, `frechet_distance`, `FIDEvaluation` (real
  statistics, their .npz cache, `fid_score`) on the same features.
- `tsne`, `embed_user_features`, `select_extreme_users`: equal to JAX's.
- The plots are written when matplotlib is present, and skipped without.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from vqgan_tpu.eval import fid as jfid
from vqgan_tpu.eval import plots as jplots
from vqgan_tpu.models.inception import InceptionV3Features as JInception
from vqgan_tpu.models.inception import load_torch_inception_weights
from vqgan_tpu_torch.checkpoint import inception_state_from_jax
from vqgan_tpu_torch.eval import fid, plots
from vqgan_tpu_torch.models.inception import (
    InceptionV3Features,
    load_inception_weights,
)

# the packages' `eval.tsne` attribute is the function of that name
jtsne = importlib.import_module("vqgan_tpu.eval.tsne")
tsne = importlib.import_module("vqgan_tpu_torch.eval.tsne")

torch.set_num_threads(4)

# fp32 through 94 conv layers and the resize, other summation orders:
# features to 1e-5 of the largest (measured 4e-7)
FEATURE_RTOL = 1e-5


def random_inception_variables(seed):
    """flax InceptionV3Features variables from a numpy seed: He-scaled
    kernels, BN scale near 1, small biases and running means, running
    variances near 1."""
    shapes = jax.eval_shape(JInception().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, sds in flatten_dict(shapes).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "kernel":
            n *= np.sqrt(2.0 / np.prod(sds.shape[:-1]))
        elif path[-1] == "scale":
            n = 1.0 + 0.1 * n
        elif path[-1] in ("bias", "mean"):
            n *= 0.1
        elif path[-1] == "var":
            n = 1.0 + 0.2 * np.abs(n)
        flat[path] = n
    return unflatten_dict(flat)


@functools.lru_cache(maxsize=None)
def _jax_apply():
    model = JInception()
    return jax.jit(lambda v, x: model.apply(v, x))


def port_features(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()


def assert_rel(got, want, rtol, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=msg)


@pytest.fixture(scope="module")
def inception():
    variables = random_inception_variables(0)
    model = InceptionV3Features().eval()
    model.load_state_dict(inception_state_from_jax(variables))
    return variables, model


@pytest.mark.parametrize("size", [64, 320])
def test_inception_features_match_flax(inception, size):
    variables, model = inception
    x = np.random.default_rng(size).random(
        (2, size, size, 3)).astype(np.float32)
    want = _jax_apply()(variables, jnp.asarray(x))
    got = port_features(model, x)
    assert got.shape == (2, 2048) and got.dtype == np.float32
    assert_rel(got, want, FEATURE_RTOL)


def test_jax_loader_reads_the_port_state_dict():
    model = InceptionV3Features(
        generator=torch.Generator().manual_seed(1)).eval()
    variables = load_torch_inception_weights(model.state_dict())
    x = np.random.default_rng(2).random((2, 64, 64, 3)).astype(np.float32)
    assert_rel(port_features(model, x),
               _jax_apply()(variables, jnp.asarray(x)), FEATURE_RTOL)


def test_pytorch_fid_layout_loads(inception):
    _, model = inception
    state = {k: v for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    state["fc.weight"] = torch.zeros(1008, 2048)
    state["fc.bias"] = torch.zeros(1008)
    state["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    fresh = load_inception_weights(InceptionV3Features(), state).eval()
    x = np.random.default_rng(3).random((1, 80, 80, 3)).astype(np.float32)
    np.testing.assert_array_equal(port_features(fresh, x),
                                  port_features(model, x))
    del state["Mixed_7c.branch_pool.bn.running_var"]
    with pytest.raises(KeyError, match="missing"):
        load_inception_weights(InceptionV3Features(), state)


def test_inception_feature_fn(inception):
    variables, model = inception
    fn = fid.make_inception_feature_fn(
        inception_state_from_jax(variables), device="cpu")
    x = np.random.default_rng(4).random((3, 48, 48, 3)).astype(np.float32)
    got = fn(x)
    assert isinstance(got, torch.Tensor) and got.shape == (3, 2048)
    np.testing.assert_array_equal(got.numpy(), port_features(model, x))
    # random init from the seed: the same seed, the same features
    a = fid.make_inception_feature_fn(seed=3, device="cpu")(x)
    b = fid.make_inception_feature_fn(seed=3, device="cpu")(x)
    assert torch.equal(a, b) and torch.isfinite(a).all()


def test_fid_stats_streaming_equals_jax():
    x = np.random.default_rng(5).standard_normal((100, 6))
    got, want = fid.FIDStats(6), jfid.FIDStats(6)
    for s in range(0, 100, 32):
        got.update(x[s:s + 32])
        want.update(x[s:s + 32])
    for g, w in zip(got.finalize(), want.finalize()):
        np.testing.assert_array_equal(g, w)
    mu, cov = got.finalize()
    np.testing.assert_allclose(cov, np.cov(x.T), rtol=1e-10)
    np.testing.assert_allclose(mu, x.mean(0), rtol=1e-12)


def _covs(case):
    rng = np.random.default_rng(6)
    d = 8
    if case == "isotropic":
        return np.zeros(d), np.eye(d), np.full(d, 2.0), 4 * np.eye(d)
    a, b = rng.standard_normal((50, d)), rng.standard_normal((40, d)) * 2
    mu1, mu2 = a.mean(0), b.mean(0) + 1
    if case == "identical":
        return mu1, np.cov(a.T), mu1, np.cov(a.T)
    if case == "rank_deficient":  # fewer samples than dims
        a, b = a[:5], b[:6]
    return mu1, np.cov(a.T), mu2, np.cov(b.T)


@pytest.mark.parametrize("case", ["isotropic", "identical", "random",
                                  "rank_deficient"])
def test_frechet_distance_equals_jax(case):
    args = _covs(case)
    got = fid.frechet_distance(*args)
    assert got == jfid.frechet_distance(*args)
    if case == "isotropic":  # |mu1 - mu2|^2 + d (1 + 4 - 2 * 2)
        assert got == pytest.approx(4.0 * 8 + 8, rel=1e-12)
    if case == "identical":
        assert abs(got) < 1e-9


def test_fid_evaluation_equals_jax(tmp_path):
    """The same feature function and the same batches on both sides (the
    samplers ignore the key / generator): the same statistics and FID."""
    rng = np.random.default_rng(7)
    real = [rng.random((16, 4, 4, 1)).astype(np.float32) for _ in range(4)]
    fakes = [rng.random((n, 4, 4, 1)).astype(np.float32) * 0.8
             for n in (16, 16, 8)]

    def feature_fn(x):
        flat = np.asarray(x).reshape(len(x), -1)
        return np.concatenate([flat[:, :6], flat[:, :2] ** 2], axis=1)

    def sampler(batches):
        it = iter(batches)
        return lambda _key, n: next(it)[:n]

    got = fid.FIDEvaluation(feature_fn, batch_size=16, num_fid_samples=40,
                            stats_path=str(tmp_path / "p.npz"), dim=8)
    want = jfid.FIDEvaluation(feature_fn, batch_size=16,
                              num_fid_samples=40,
                              stats_path=str(tmp_path / "j.npz"), dim=8)
    for g, w in zip(got.load_or_precalc_real_stats(iter(real)),
                    want.load_or_precalc_real_stats(iter(real))):
        np.testing.assert_array_equal(g, w)
    score = got.fid_score(sampler(fakes), torch.Generator())
    assert score == want.fid_score(sampler(fakes), jax.random.PRNGKey(0))
    assert score > 0
    # the cache: a new evaluation reads the statistics back
    again = fid.FIDEvaluation(feature_fn, batch_size=16, num_fid_samples=40,
                              stats_path=str(tmp_path / "p.npz"), dim=8)
    for g, w in zip(again.load_or_precalc_real_stats(iter([])),
                    got.load_or_precalc_real_stats(iter([]))):
        np.testing.assert_array_equal(g, w)
    assert again.fid_score(sampler(fakes)) == score
    # the real batches as the generated ones: 0 but for the rounding of
    # the square root (float64, full rank here)
    again.num_fid_samples = 64
    assert abs(again.fid_score(sampler(real))) < 1e-9 * np.trace(
        again._real[1])


def test_fid_statistics_of_torch_features(inception):
    """A feature function that returns tensors (the port's Inception) is
    read back to the host."""
    variables, _ = inception
    fn = fid.make_inception_feature_fn(inception_state_from_jax(variables),
                                       device="cpu")
    rng = np.random.default_rng(8)
    real = [rng.random((3, 40, 40, 3)).astype(np.float32) for _ in range(2)]
    ev = fid.FIDEvaluation(fn, batch_size=3, num_fid_samples=6)
    mu, cov = ev.load_or_precalc_real_stats(iter(real))
    feats = np.concatenate([fn(b).numpy() for b in real]).astype(np.float64)
    np.testing.assert_allclose(mu, feats.mean(0), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(cov, np.cov(feats.T), rtol=1e-8,
                               atol=1e-12 * np.abs(cov).max())


@pytest.mark.parametrize("seed,perplexity", [(0, 10.0), (3, 30.0)])
def test_tsne_equals_jax(seed, perplexity):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(0, 0.3, (20, 10)) + 3,
                        rng.normal(0, 0.3, (20, 10)) - 3])
    got = tsne.tsne(x, perplexity=perplexity, n_iter=150, seed=seed)
    want = jtsne.tsne(x, perplexity=perplexity, n_iter=150, seed=seed)
    np.testing.assert_array_equal(got, want)


def test_embed_and_select_users_equal_jax():
    rng = np.random.default_rng(9)
    feats = rng.normal(size=(40, 8))
    labels = np.repeat(np.arange(4), 10)
    got = tsne.embed_user_features(feats, labels, users=[1, 3],
                                   perplexity=5)
    want = jtsne.embed_user_features(feats, labels, users=[1, 3],
                                     perplexity=5)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    accs = {i: (i * 7 % 10) / 10 for i in range(10)}
    assert tsne.select_extreme_users(accs, k=3) == \
        jtsne.select_extreme_users(accs, k=3)


def _cluster_report():
    ks = [2, 3, 4]
    metrics = {m: [1.0, 0.5, 0.7] for m in (
        "bic", "aic", "silhouette", "davies_bouldin", "calinski_harabasz")}
    sizes = {2: [6, 6], 3: [4, 4, 4], 4: [3, 3, 3, 3]}
    recommendations = {"bic_elbow": 3, "aic_elbow": 3, "silhouette_best": 2,
                       "davies_bouldin_best": 3, "calinski_best": 4}
    return ks, metrics, sizes, recommendations


@pytest.mark.parametrize("kind", ["cluster_validation", "tsne"])
def test_plots_written(tmp_path, kind):
    if kind == "tsne":
        emb = np.random.default_rng(10).normal(size=(12, 2))
        labels = np.repeat(np.arange(3), 4)
        out = plots.plot_tsne(emb, labels, tmp_path / "t.png",
                              highlight=[1])
        ref = jplots.plot_tsne(emb, labels, tmp_path / "j.png",
                               highlight=[1])
    else:
        out = plots.plot_cluster_validation("ID_1", *_cluster_report(),
                                            tmp_path / "v" / "c.png")
        ref = jplots.plot_cluster_validation("ID_1", *_cluster_report(),
                                             tmp_path / "j.png")
    assert out.exists() and out.stat().st_size > 0 and ref.exists()


def test_plots_do_nothing_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setattr(plots, "_get_plt", lambda: None)
    assert plots.plot_cluster_validation("ID_1", *_cluster_report(),
                                         tmp_path / "c.png") is None
    assert plots.plot_tsne(np.zeros((2, 2)), np.zeros(2),
                           tmp_path / "t.png") is None
    assert not list(tmp_path.iterdir())
