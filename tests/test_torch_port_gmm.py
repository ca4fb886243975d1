"""Port parity: the GMM-stratified data path (vqgan_tpu_torch/data/gmm.py,
preprocess_latents_with_gmm.py, validate_cluster_number.py) against the
JAX package.

- `standardize` and `pca_fit` on the same features: k equal, projections
  equal up to the sign of each column.
- One EM step, then whole `gmm_fit`s with JAX's own initial indices (the
  two packages cannot share a random stream: the indices are drawn as
  `jax.random.choice` draws them inside vqgan_tpu's `gmm_fit` and passed
  to the port as `init_idx`).
- The diagonal fallback on degenerate inputs where JAX's full fit is NaN,
  and the NaN semantics it rests on (a failed Cholesky, `jnp.argmax`);
  restarts that isolate about d points, where the packages may part: each
  side's fit is finite and falls back exactly when its own full fit is NaN.
- `gmm_predict`, `gmm_bic`, `gmm_aic`; the cluster metrics, the quotas and
  the stratified split, exactly equal on the same labels;
  `find_elbow_point`.
- Both CLIs with `--device cpu` on a tiny image folder and the default
  KL-VAE topology at 32 px (weights from a numpy seed in JAX, carried over
  with `klvae_state_from_jax`).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from PIL import Image

from vqgan_tpu.data import gmm as jgmm
from vqgan_tpu.data import load_image as j_load_image
from vqgan_tpu.data import splits as jsplits
from vqgan_tpu.models import KLVAE as JKLVAE
from vqgan_tpu.models.autoencoder import AutoencoderConfig as JConfig
from vqgan_tpu_torch import preprocess_latents_with_gmm, validate_cluster_number
from vqgan_tpu_torch.checkpoint import klvae_state_from_jax
from vqgan_tpu_torch.data import LatentCache, gmm, load_split, verify_split

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)

# fp32 on both sides, other summation orders: standardized features and
# PCA projections of O(1-10), relative to the largest value
PCA_RTOL = 1e-5
# one EM step: means/covs/weights to 1e-5 of the largest, the E-step's
# mean log-likelihood 1e-6 relative
STEP_RTOL = 1e-5
# 100 EM iterations of well-conditioned clusters: parameters to 1e-4 of
# the largest, the mean log-likelihood 1e-5 relative
FIT_RTOL, LL_RTOL = 1e-4, 1e-5
# the default KL-VAE's encoder on the CPU in two summation orders
LATENT_ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def jax_init_idx(key, n, k, n_init):
    """The initial means' row indices vqgan_tpu's `gmm_fit(key, ...)`
    draws: one `jax.random.choice` per split key."""
    return np.stack([np.asarray(jax.random.choice(kk, n, (k,),
                                                  replace=False))
                     for kk in jax.random.split(key, n_init)])


def clustered(seed, k=4, per=25, d=3, spread=5.0):
    """k well-separated Gaussian clusters of `per` points in d dims. With
    these seeds no restart of the fits below ends with a component of as
    few points as dims + 1: such a covariance is singular but for reg
    1e-6, its likelihood the largest of the restarts, and both its
    Cholesky's success and its log-likelihood are decided by fp32
    rounding, which differs between the packages (`with_tight_group`
    makes that case)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * spread
    x = np.concatenate([c + rng.standard_normal((per, d)) for c in centers])
    return x[rng.permutation(len(x))].astype(np.float32)


def assert_rel(got, want, rtol, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=msg)


def test_standardize_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((30, 12)) * rng.uniform(0.1, 5, 12)
         + rng.standard_normal(12)).astype(np.float32)
    # a constant feature: std floored at 1e-8 (0, whose mean is exact on
    # both sides; another constant's mean is off by rounding, which the
    # floor turns into +-1)
    x[:, 3] = 0.0
    got = gmm.standardize(_t(x))
    want = jgmm.standardize(jnp.asarray(x))
    for g, w, name in zip(got, want, ("x_std", "mean", "std")):
        assert_rel(g.numpy(), w, 1e-6, name)
    assert got[2][3].item() == pytest.approx(1e-8)


@pytest.mark.parametrize("var_ratio,max_components", [
    (0.5, None), (0.95, None), (0.95, 4)])
def test_pca_fit_matches_jax_up_to_sign(var_ratio, max_components):
    rng = np.random.default_rng(1)
    # 12 latent directions of decaying scale mixed into 64 features, plus
    # noise: after standardizing, the leading singular values stay well
    # separated, so the singular vectors are well conditioned
    x = ((rng.standard_normal((40, 12)) * np.geomspace(10, 0.5, 12))
         @ rng.standard_normal((12, 64))
         + 0.1 * rng.standard_normal((40, 64))).astype(np.float32)
    xs, _, _ = gmm.standardize(_t(x))
    comps, k, ratio = gmm.pca_fit(xs, var_ratio, max_components)
    jxs, _, _ = jgmm.standardize(jnp.asarray(x))
    jcomps, jk, jratio = jgmm.pca_fit(jxs, var_ratio, max_components)
    assert k == jk and comps.shape == (64, k)
    assert_rel(ratio.numpy(), jratio, PCA_RTOL, "ratio")
    proj = gmm.pca_transform(xs, comps, torch.zeros(64)).numpy()
    jproj = np.asarray(jgmm.pca_transform(jxs, jcomps, jnp.zeros(64)))
    signs = np.sign((proj * jproj).sum(0))
    assert_rel(proj * signs, jproj, PCA_RTOL, "projections")


@pytest.mark.parametrize("diag_only", [False, True])
def test_one_em_step_matches_jax(diag_only):
    x = clustered(2)
    idx = np.array([[3, 17, 29, 41]])
    jparams = jgmm._init_params(jax.random.PRNGKey(0), jnp.asarray(x), 4)
    jparams = jgmm.GMMParams(jparams.weights, jnp.asarray(x[idx[0]]),
                             jparams.covs)
    want, want_ll = jgmm._em_step(jnp.asarray(x), jparams, 1e-6, diag_only)
    init = gmm._init_params(_t(x), torch.from_numpy(idx))
    got, ll = gmm._em_step(_t(x), init, 1e-6, diag_only)
    for name in ("weights", "means", "covs"):
        assert_rel(getattr(got, name)[0].numpy(), getattr(want, name),
                   STEP_RTOL, name)
    assert ll[0].item() == pytest.approx(float(want_ll), rel=1e-6)
    # the initial covariances: global (ddof 1) + 1e-3 I
    assert_rel(init.covs[0, 2].numpy(), jparams.covs[2], 1e-6)


@pytest.mark.parametrize("k,seed", [(2, 3), (3, 4), (4, 5)])
def test_gmm_fit_matches_jax_with_its_init_indices(k, seed):
    x = clustered(seed, k=k)
    key = jax.random.PRNGKey(seed)
    _, full_ll = jgmm._gmm_fit_impl(key, jnp.asarray(x), k, 10, 100,
                                    jnp.float32(1e-6), False)
    assert np.isfinite(float(full_ll))  # JAX keeps full covariances here
    want, want_ll = jgmm.gmm_fit(key, jnp.asarray(x), k, n_init=10)
    got, ll = gmm.gmm_fit(None, _t(x), k, n_init=10,
                          init_idx=jax_init_idx(key, len(x), k, 10))
    assert got.covariance_type == "full" and np.isfinite(ll)
    np.testing.assert_array_equal(
        gmm.gmm_predict(got, _t(x)).numpy(),
        np.asarray(jgmm.gmm_predict(want, jnp.asarray(x))))
    for name in ("weights", "means", "covs"):
        assert_rel(getattr(got, name).numpy(), getattr(want, name),
                   FIT_RTOL, name)
    assert ll == pytest.approx(float(want_ll), rel=LL_RTOL)


def _degenerate(case):
    rng = np.random.default_rng(6)
    if case == "low_rank":
        # 60 points on a 3-dim subspace of 10 dims, at scale 10: every
        # component's covariance is singular, its rounding noise far above
        # reg 1e-6
        return (rng.standard_normal((60, 3)) @ rng.standard_normal((3, 10))
                * 10).astype(np.float32)
    # PCA-like: 60 points in 40 dims, ~15 per component
    return (rng.standard_normal((60, 40))
            * np.linspace(3, 0.3, 40)).astype(np.float32)


@pytest.mark.parametrize("case", ["low_rank", "pca_like"])
def test_degenerate_input_takes_the_diagonal_fallback_as_jax(case):
    x = _degenerate(case)
    key = jax.random.PRNGKey(3)
    _, full_ll = jgmm._gmm_fit_impl(key, jnp.asarray(x), 4, 10, 100,
                                    jnp.float32(1e-6), False)
    assert not np.isfinite(float(full_ll))  # JAX falls back here
    want, want_ll = jgmm.gmm_fit(key, jnp.asarray(x), 4, n_init=10)
    got, ll = gmm.gmm_fit(None, _t(x), 4, n_init=10,
                          init_idx=jax_init_idx(key, 60, 4, 10))
    assert got.covariance_type == "diag"
    covs = got.covs.numpy()
    assert (covs == covs * np.eye(x.shape[1])).all()
    np.testing.assert_array_equal(
        gmm.gmm_predict(got, _t(x)).numpy(),
        np.asarray(jgmm.gmm_predict(want, jnp.asarray(x))))
    assert_rel(got.means.numpy(), want.means, FIT_RTOL, "means")
    assert ll == pytest.approx(float(want_ll), rel=LL_RTOL)


def with_tight_group(seed, d=3):
    """Three clusters of 25 points in d dims and a tight group of d + 1
    points: restarts end with a component of d or d + 1 points, whose
    covariance is singular but for reg 1e-6."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((3, d)) * 5
    x = np.concatenate(
        [c + rng.standard_normal((25, d)) for c in centers]
        + [rng.standard_normal(d) * 5 + 0.01 * rng.standard_normal(
            (d + 1, d))])
    return x[rng.permutation(len(x))].astype(np.float32)


@pytest.mark.parametrize("seed", [0, 3])
def test_near_singular_restarts_keep_each_side_sound(seed):
    """Where a restart isolates about d points, each package decides that
    component's Cholesky, and so the fallback and the split, by its own
    fp32 rounding: the two may part. What each must still do: a finite
    fit, diagonal covariances exactly when its own best full-covariance
    log-likelihood is NaN, and labels in range."""
    x = with_tight_group(seed)
    key, k = jax.random.PRNGKey(seed), 4
    idx = jax_init_idx(key, len(x), k, 10)
    params = gmm._init_params(_t(x), torch.from_numpy(idx))
    for _ in range(100):
        params, _ = gmm._em_step(_t(x), params, 1e-6, False)
    smallest = (params.weights * len(x)).min(dim=1).values
    # the case is there: some restart ends with <= d points or fails
    assert ((smallest < x.shape[1] + 0.5) | smallest.isnan()).any()
    for side in ("jax", "port"):
        if side == "jax":
            _, full_ll = jgmm._gmm_fit_impl(key, jnp.asarray(x), k, 10, 100,
                                            jnp.float32(1e-6), False)
            fit, ll = jgmm.gmm_fit(key, jnp.asarray(x), k, n_init=10)
            labels = np.asarray(jgmm.gmm_predict(fit, jnp.asarray(x)))
            covs = np.asarray(fit.covs)
        else:
            _, full_ll = gmm._gmm_fit_impl(_t(x), torch.from_numpy(idx),
                                           100, 1e-6, False)
            fit, ll = gmm.gmm_fit(None, _t(x), k, n_init=10, init_idx=idx)
            labels = gmm.gmm_predict(fit, _t(x)).numpy()
            covs = fit.covs.numpy()
            assert fit.covariance_type == (
                "full" if np.isfinite(full_ll) else "diag")
        diag = bool((covs == covs * np.eye(x.shape[1])).all())
        assert diag == (not np.isfinite(float(full_ll))), side
        assert np.isfinite(float(ll)) and np.isfinite(covs).all(), side
        assert labels.shape == (len(x),) and labels.min() >= 0 \
            and labels.max() < k, side


def test_failed_cholesky_and_argmax_are_nan_as_in_jax():
    # [[1, 2], [2, 1]] is not positive definite: JAX's factor is NaN
    assert np.isnan(np.diag(np.asarray(jnp.linalg.cholesky(
        jnp.array([[1.0, 2.0], [2.0, 1.0]]))))).all()
    covs = torch.tensor([[[1.0, 0.0], [0.0, 1.0]], [[1.0, 2.0], [2.0, 1.0]]])
    lp = gmm._log_gaussian_full(torch.zeros(3, 2), torch.zeros(2, 2), covs,
                                0.0)
    assert torch.isfinite(lp[:, 0]).all() and torch.isnan(lp[:, 1]).all()
    for row in ([1.0, np.nan, 3.0], [np.nan, 5.0, np.nan], [1.0, 4.0, 2.0]):
        assert int(gmm._nan_argmax(torch.tensor(row))) == int(
            jnp.argmax(jnp.array(row)))


def test_gmm_predict_bic_aic_match_jax():
    x = clustered(7, k=3, d=5)
    want, ll = jgmm.gmm_fit(jax.random.PRNGKey(1), jnp.asarray(x), 3)
    params = gmm.GMMParams(_t(want.weights), _t(want.means), _t(want.covs))
    np.testing.assert_array_equal(
        gmm.gmm_predict(params, _t(x)).numpy(),
        np.asarray(jgmm.gmm_predict(want, jnp.asarray(x))))
    for cov_type in ("full", "diag"):
        assert gmm.gmm_bic(params, x, float(ll), cov_type) == \
            jgmm.gmm_bic(want, x, float(ll), cov_type)
        assert gmm.gmm_aic(params, x, float(ll), cov_type) == \
            jgmm.gmm_aic(want, x, float(ll), cov_type)


@pytest.mark.parametrize("metric", ["silhouette_score",
                                    "davies_bouldin_score",
                                    "calinski_harabasz_score"])
@pytest.mark.parametrize("n_labels", [1, 3, 5])
def test_cluster_metrics_equal_jax(metric, n_labels):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((40, 6))
    labels = rng.integers(0, n_labels, 40)
    assert getattr(gmm, metric)(x, labels) == getattr(jgmm, metric)(x, labels)


@pytest.mark.parametrize("counts,total", [
    ([15, 15, 15, 15], 30), ([20, 7, 3, 30], 30), ([1, 1, 40], 20),
    ([2, 2, 2], 10), ([0, 0], 5), ([9, 8, 13, 5, 25], 20)])
def test_largest_remainder_quotas_equal_jax(counts, total):
    got = gmm.largest_remainder_quotas(np.array(counts), total)
    np.testing.assert_array_equal(
        got, jgmm.largest_remainder_quotas(np.array(counts), total))


@pytest.mark.parametrize("n,k,n_gen,n_class,seed", [
    (60, 4, 30, 20, 43), (60, 5, 30, 20, 44), (12, 2, 4, 3, 7),
    (40, 3, 30, 20, 1)])
def test_stratified_sample_equals_jax(n, k, n_gen, n_class, seed):
    labels = np.random.default_rng(seed).integers(0, k, n)
    got = gmm.stratified_sample_from_clusters(labels, n_gen, n_class, seed)
    want = jgmm.stratified_sample_from_clusters(labels, n_gen, n_class, seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sum(map(len, got)) == n


def _jax_validate_cli():
    sys.path.insert(0, str(REPO / "cli"))
    try:
        import validate_cluster_number as jcli
    finally:
        sys.path.pop(0)
    return jcli


@pytest.mark.parametrize("values", [
    [100.0, 60.0, 40.0, 35.0, 33.0, 32.0], [5.0, 4.0, 3.0, 2.0],
    [1.0, 2.0], [3.0, 1.0, 2.0, 0.5, 0.4], [-10.0, -30.0, -35.0, -36.0]])
def test_find_elbow_point_equals_jax(values):
    jcli = _jax_validate_cli()
    got = validate_cluster_number.find_elbow_point(values)
    assert got == jcli.find_elbow_point(values)


# --- the CLIs --------------------------------------------------------------

SIZE = 32


@pytest.fixture(scope="module")
def vae_and_images(tmp_path_factory):
    """The default KL-VAE topology at 32 px in JAX, its parameters from a
    numpy seed, the same weights as a `.pt` file, and a folder of 3 users
    (14, 12 and 11 JPGs of smooth random patterns)."""
    jvae = JKLVAE(config=JConfig(resolution=SIZE, z_channels=4))
    shapes = jax.eval_shape(jvae.init, {"params": jax.random.PRNGKey(0),
                                        "gaussian": jax.random.PRNGKey(1)},
                            jnp.zeros((1, SIZE, SIZE, 3)))
    rng = np.random.default_rng(3)
    flat = {}
    for path, sds in flatten_dict(shapes).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "kernel":
            n /= np.sqrt(np.prod(sds.shape[:-1]))
        elif path[-1] == "scale":
            n = 1.0 + 0.05 * n
        elif path[-1] == "bias":
            n *= 0.05
        flat[path] = n
    params = unflatten_dict(flat)
    vae_path = tmp_path_factory.mktemp("vae") / "kl_vae.pt"
    torch.save({"model_state_dict": klvae_state_from_jax(params)}, vae_path)

    root = tmp_path_factory.mktemp("data") / "images"
    yy, xx = np.mgrid[0:40, 0:40] / 40.0
    for user, n in ((1, 14), (2, 12), (3, 11)):
        folder = root / f"ID_{user}"
        folder.mkdir(parents=True)
        for i in range(n):
            f = rng.uniform(1, 4, (2, 3))
            img = 0.5 + 0.25 * (np.sin(2 * np.pi * f[0] * xx[..., None])
                                + np.cos(2 * np.pi * f[1] * yy[..., None]))
            Image.fromarray((img * 255).astype(np.uint8)).save(
                folder / f"frame_{i:03d}.jpg")
        (folder / "notes.txt").write_text("not an image")
    return jvae, params, vae_path, root


def test_gmm_cli_split_is_the_stratified_sample_of_its_labels(
        vae_and_images, tmp_path, capsys):
    jvae, params, vae_path, root = vae_and_images
    out_split, cache_dir = tmp_path / "split.json", tmp_path / "cache"
    result = preprocess_latents_with_gmm.main([
        "--device", "cpu", "--vae_path", str(vae_path), "--data_path",
        str(root), "--output_split", str(out_split), "--cache_folder",
        str(cache_dir), "--num_users", "4", "--n_gen_train", "5",
        "--n_class_train", "3", "--image_size", str(SIZE), "--batch_size",
        "8", "--seed", "11"])
    split = load_split(out_split)
    assert split == result["split"]
    assert "missing" in capsys.readouterr().out  # ID_4
    assert verify_split(split) == [] and jsplits.verify_split(split) == []
    assert split["metadata"] == {
        "method": "gmm_stratified", "num_users": 4, "n_gen_train": 5,
        "n_class_train": 3, "seed": 11}

    encode = jax.jit(lambda x: jvae.apply(
        params, x, method=JKLVAE.encode_images_mean))
    cache = LatentCache(cache_dir)
    for uid, n in ((1, 14), (2, 12), (3, 11)):
        user = f"ID_{uid}"
        info = split["users"][user]
        names = sorted(p.name for p in (root / user).glob("*.jpg"))
        k = min(preprocess_latents_with_gmm.USER_K_VALUES[uid],
                max(2, n // 5))
        assert info["n_clusters"] == k == result["users"][user]["n_clusters"]
        labels = np.array(info["cluster_labels"])
        assert len(labels) == n and labels.max() < k
        gen, cls, rest = jgmm.stratified_sample_from_clusters(
            labels, 5, 3, seed=11 + uid)
        assert info["gen_train_images"] == [names[i] for i in gen]
        assert info["class_train_images"] == [names[i] for i in cls]
        assert info["test_images"] == [names[i] for i in rest]
        assert info["train_indices"] == np.concatenate([gen, cls]).tolist()
        assert info["test_indices"] == rest.tolist()
        # only the gen-train latents are cached, each JAX's encode of it
        cached = sorted(p.name for p in cache_dir.glob(
            f"user_{uid - 1:02d}_*.npy"))
        assert len(cached) == len(gen)
        want = np.asarray(encode(jnp.asarray(np.stack(
            [j_load_image(root / user / names[i], SIZE) for i in gen]))))
        got = np.stack([cache.load(uid - 1, names[i]) for i in gen])
        np.testing.assert_allclose(got, want, rtol=0, atol=LATENT_ATOL)
        assert result["users"][user]["covariance_type"] in ("full", "diag")


def test_gmm_cli_labels_are_gmm_of_the_features(vae_and_images, tmp_path):
    """The CLI's labels are gmm_predict of a fit on its own features, with
    the restarts the seeded generator draws."""
    _, _, vae_path, root = vae_and_images
    out_split = tmp_path / "split.json"
    preprocess_latents_with_gmm.main([
        "--device", "cpu", "--vae_path", str(vae_path), "--data_path",
        str(root), "--output_split", str(out_split), "--cache_folder",
        str(tmp_path / "cache"), "--num_users", "1", "--image_size",
        str(SIZE), "--batch_size", "16", "--seed", "5"])
    from vqgan_tpu_torch.generate import load_vae

    vae = load_vae(vae_path, image_size=SIZE, device="cpu")
    files = preprocess_latents_with_gmm.user_images(root / "ID_1")
    latents = preprocess_latents_with_gmm.encode_user(vae, files, SIZE, 16,
                                                      "cpu")
    proj, _ = preprocess_latents_with_gmm.project_features(latents, "cpu")
    params, _ = gmm.gmm_fit(torch.Generator().manual_seed(6), proj, k=2)
    assert load_split(out_split)["users"]["ID_1"]["cluster_labels"] == \
        gmm.gmm_predict(params, proj).tolist()


def test_validate_cluster_number_cli(vae_and_images, tmp_path):
    jcli = _jax_validate_cli()
    _, _, vae_path, root = vae_and_images
    out = tmp_path / "validation"
    report = validate_cluster_number.main([
        "--device", "cpu", "--vae_path", str(vae_path), "--data_path",
        str(root), "--output_dir", str(out), "--num_users", "2", "--k_min",
        "2", "--k_max", "4", "--image_size", str(SIZE)])
    saved = json.loads((out / "cluster_validation.json").read_text())
    assert saved == json.loads(json.dumps(report))
    assert sorted(saved) == ["ID_1", "ID_2", "summary"]
    votes = []
    for user in ("ID_1", "ID_2"):
        r = saved[user]
        assert r["ks"] == [2, 3, 4]
        m = r["metrics"]
        assert all(len(v) == 3 and np.isfinite(v).all() for v in m.values())
        rec = r["recommendations"]
        assert rec["bic_elbow"] == 2 + jcli.find_elbow_point(m["bic"])
        assert rec["aic_elbow"] == 2 + jcli.find_elbow_point(m["aic"])
        assert rec["silhouette_best"] == 2 + int(np.argmax(m["silhouette"]))
        assert [sum(s) for s in r["cluster_sizes"].values()] == \
            [14 if user == "ID_1" else 12] * 3
        vals, counts = np.unique(list(rec.values()), return_counts=True)
        assert r["majority_vote"] == int(vals[np.argmax(counts)])
        votes.append(r["majority_vote"])
        assert (out / f"{user}_validation.png").stat().st_size > 0
    overall = int(np.bincount(votes).argmax())
    assert saved["summary"] == {"overall_majority_k": overall,
                                "gait_theory_k": 4,
                                "agreement_with_theory": overall == 4}


def test_gmm_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module in (preprocess_latents_with_gmm, validate_cluster_number):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main(["--vae_path", str(tmp_path / "v.pt"),
                         "--data_path", str(tmp_path)])
