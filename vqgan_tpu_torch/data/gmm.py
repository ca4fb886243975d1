"""Gaussian-mixture clustering + PCA on the device, and stratified quota
sampling.

Counterpart of vqgan_tpu/data/gmm.py, which replaces the reference's
sklearn pipeline (StandardScaler -> PCA(0.95) -> GaussianMixture(full,
n_init=10) with a diagonal fallback) and its largest-remainder quotas.

- `standardize`, `pca_fit` (SVD, the smallest k reaching `var_ratio`),
  `pca_transform`: tensors on any device.
- `gmm_fit`: EM with closed-form M-steps, the `n_init` restarts carried as
  a leading batch dimension through batched Cholesky factors and
  triangular solves. The restarts' initial means are the rows `init_idx`
  [n_init, k] of x; without it they are drawn from `generator` (a CPU
  `torch.Generator`, k distinct rows per restart). The two packages cannot
  share a random stream, so the tests inject JAX's own indices.
- A Cholesky that fails (`info > 0`) gives that restart a NaN
  log-likelihood, as JAX's NaN factor does, and the pick of the best
  restart treats NaN as the maximum, as `jnp.argmax` does. So any
  degenerate restart makes the fit non-finite and `gmm_fit` refits
  diagonal covariances at reg 1e-3 from the same initial means.
- `gmm_predict` (reg 1e-6), `gmm_bic`, `gmm_aic`.
- The cluster metrics (silhouette, Davies-Bouldin, Calinski-Harabasz),
  `largest_remainder_quotas` and `stratified_sample_from_clusters` are
  numpy, copied from the JAX package: the same labels give the same split.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "standardize",
    "pca_fit",
    "pca_transform",
    "GMMParams",
    "gmm_fit",
    "gmm_predict",
    "gmm_bic",
    "gmm_aic",
    "silhouette_score",
    "davies_bouldin_score",
    "calinski_harabasz_score",
    "largest_remainder_quotas",
    "stratified_sample_from_clusters",
]


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------


def standardize(x: torch.Tensor):
    """Zero-mean unit-variance per feature (StandardScaler: biased std,
    floored at 1e-8). Returns (x_std, mean, std)."""
    mean = x.mean(dim=0)
    std = x.std(dim=0, correction=0).clamp_min(1e-8)
    return (x - mean) / std, mean, std


def pca_fit(x: torch.Tensor, var_ratio: float = 0.95,
            max_components: Optional[int] = None):
    """PCA by SVD. Returns (components [D, k], k, explained_variance_ratio),
    k the smallest count whose cumulative ratio reaches var_ratio. Columns
    are signed as the SVD library returns them."""
    xc = x - x.mean(dim=0)
    _, s, vt = torch.linalg.svd(xc, full_matrices=False)
    var = s**2
    ratio = var / var.sum()
    cum = torch.cumsum(ratio, dim=0)
    k = int(torch.searchsorted(
        cum, torch.tensor([var_ratio], dtype=cum.dtype, device=cum.device)))
    k += 1
    if max_components is not None:
        k = min(k, max_components)
    return vt[:k].T, k, ratio


def pca_transform(x: torch.Tensor, components: torch.Tensor,
                  mean: torch.Tensor) -> torch.Tensor:
    return (x - mean) @ components


# ---------------------------------------------------------------------------
# GMM via EM
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GMMParams:
    weights: torch.Tensor  # [..., K]
    means: torch.Tensor  # [..., K, D]
    covs: torch.Tensor  # [..., K, D, D] (diagonal stored as full matrices)
    # "diag" when gmm_fit fell back to diagonal covariances
    covariance_type: str = "full"


def _nan_argmax(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """argmax that takes the first NaN as the maximum, as `jnp.argmax`."""
    nan = torch.isnan(t)
    return torch.where(nan.any(dim=dim), nan.int().argmax(dim=dim),
                       t.argmax(dim=dim))


def _log_gaussian_full(x, means, covs, reg):
    """log N(x | mu_k, Sigma_k) for every k by Cholesky: x [N, D], means
    [..., K, D], covs [..., K, D, D] -> [..., N, K]. A component whose
    Cholesky fails gets NaN."""
    d = means.shape[-1]
    eye = torch.eye(d, dtype=covs.dtype, device=covs.device) * reg
    chol, info = torch.linalg.cholesky_ex(covs + eye)
    diff = x - means.unsqueeze(-2)  # [..., K, N, D]
    sol = torch.linalg.solve_triangular(chol, diff.transpose(-1, -2),
                                        upper=False)  # [..., K, D, N]
    maha = (sol**2).sum(dim=-2)  # [..., K, N]
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    log_prob = -0.5 * (d * math.log(2 * math.pi) + logdet.unsqueeze(-1)
                       + maha)
    log_prob = torch.where((info > 0).unsqueeze(-1), math.nan, log_prob)
    return log_prob.transpose(-1, -2)


def _em_step(x, params: GMMParams, reg, diag_only):
    """One EM step of every restart. Returns (the parameters after the
    M-step, the mean log-likelihood of the E-step before it)."""
    log_prob = _log_gaussian_full(x, params.means, params.covs, reg)
    log_weighted = log_prob + torch.log(
        params.weights.clamp_min(1e-12)).unsqueeze(-2)
    log_norm = torch.logsumexp(log_weighted, dim=-1, keepdim=True)
    resp = torch.exp(log_weighted - log_norm)  # [..., N, K]

    nk = resp.sum(dim=-2) + 1e-10
    means = (resp.transpose(-1, -2) @ x) / nk.unsqueeze(-1)
    diff = x - means.unsqueeze(-2)  # [..., K, N, D]
    r = resp.transpose(-1, -2)  # [..., K, N]
    covs = torch.einsum("...kn,...kni,...knj->...kij", r, diff, diff)
    covs = covs / (r + 1e-10).sum(dim=-1)[..., None, None]
    if diag_only:
        covs = torch.diag_embed(torch.diagonal(covs, dim1=-2, dim2=-1))
    weights = nk / x.shape[0]
    ll = log_norm.mean(dim=(-2, -1))
    return GMMParams(weights, means, covs), ll


def _init_params(x, init_idx):
    """Means at the rows init_idx [n_init, k] of x; every covariance the
    global one (ddof 1) plus 1e-3 I; uniform weights."""
    n_init, k = init_idx.shape
    d = x.shape[1]
    means = x[init_idx]
    global_cov = torch.cov(x.T).reshape(d, d) + torch.eye(
        d, dtype=x.dtype, device=x.device) * 1e-3
    covs = global_cov.expand(n_init, k, d, d).clone()
    weights = torch.full((n_init, k), 1.0 / k, dtype=x.dtype,
                         device=x.device)
    return GMMParams(weights, means, covs)


def _gmm_fit_impl(x, init_idx, max_iter, reg, diag_only):
    params = _init_params(x, init_idx)
    ll = torch.full((init_idx.shape[0],), -math.inf, dtype=x.dtype,
                    device=x.device)
    for _ in range(max_iter):
        params, ll = _em_step(x, params, reg, diag_only)
    all_ll = ll.cpu()  # the one read of the host per fit
    best = int(_nan_argmax(all_ll))
    return GMMParams(params.weights[best], params.means[best],
                     params.covs[best]), float(all_ll[best])


def draw_init_idx(generator: torch.Generator, n: int, k: int,
                  n_init: int) -> torch.Tensor:
    """k distinct row indices in [0, n) per restart, [n_init, k] int64."""
    return torch.stack([torch.randperm(n, generator=generator)[:k]
                        for _ in range(n_init)])


def gmm_fit(
    generator: Optional[torch.Generator],
    x: torch.Tensor,
    k: int,
    n_init: int = 10,
    max_iter: int = 100,
    reg_covar: float = 1e-6,
    covariance_type: str = "full",
    init_idx=None,
) -> Tuple[GMMParams, float]:
    """Fit a k-component mixture to x [N, D]; (params, mean log-likelihood
    of the last E-step). Degenerate full-covariance EM falls back to
    diagonal covariances at reg 1e-3 (params.covariance_type "diag")."""
    if init_idx is None:
        init_idx = draw_init_idx(generator, x.shape[0], k, n_init)
    init_idx = torch.as_tensor(np.asarray(init_idx), dtype=torch.long,
                               device=x.device)
    if init_idx.shape != (n_init, k):
        raise ValueError(f"init_idx has shape {tuple(init_idx.shape)}, "
                         f"expected {(n_init, k)}")
    diag_only = covariance_type == "diag"
    params, ll = _gmm_fit_impl(x, init_idx, max_iter, reg_covar, diag_only)
    if not diag_only and not math.isfinite(ll):
        params, ll = _gmm_fit_impl(x, init_idx, max_iter, 1e-3, True)
        diag_only = True
    params.covariance_type = "diag" if diag_only else "full"
    return params, ll


def gmm_predict(params: GMMParams, x: torch.Tensor) -> torch.Tensor:
    log_prob = _log_gaussian_full(x, params.means, params.covs, 1e-6)
    log_weighted = log_prob + torch.log(
        params.weights.clamp_min(1e-12)).unsqueeze(-2)
    return _nan_argmax(log_weighted, dim=1)


def _n_parameters(k: int, d: int, covariance_type: str = "full") -> int:
    cov_params = k * d * (d + 1) // 2 if covariance_type == "full" else k * d
    return int(cov_params + k * d + k - 1)


def gmm_bic(params: GMMParams, x, mean_ll, covariance_type="full"):
    n, d = x.shape
    k = params.weights.shape[0]
    return float(
        -2 * mean_ll * n + _n_parameters(k, d, covariance_type) * np.log(n))


def gmm_aic(params: GMMParams, x, mean_ll, covariance_type="full"):
    n, d = x.shape
    k = params.weights.shape[0]
    return float(-2 * mean_ll * n + 2 * _n_parameters(k, d, covariance_type))


# ---------------------------------------------------------------------------
# cluster-quality metrics (numpy, small data)
# ---------------------------------------------------------------------------


def silhouette_score(x: np.ndarray, labels: np.ndarray) -> float:
    x = np.asarray(x, np.float64)
    labels = np.asarray(labels)
    n = len(x)
    uniq = np.unique(labels)
    if len(uniq) < 2:
        return 0.0
    d = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))
    sil = np.zeros(n)
    for i in range(n):
        same = labels == labels[i]
        same[i] = False
        a = d[i, same].mean() if same.any() else 0.0
        b = np.inf
        for c in uniq:
            if c == labels[i]:
                continue
            b = min(b, d[i, labels == c].mean())
        sil[i] = 0.0 if max(a, b) == 0 else (b - a) / max(a, b)
    return float(sil.mean())


def davies_bouldin_score(x: np.ndarray, labels: np.ndarray) -> float:
    x = np.asarray(x, np.float64)
    uniq = np.unique(labels)
    k = len(uniq)
    if k < 2:
        return 0.0
    centroids = np.stack([x[labels == c].mean(0) for c in uniq])
    scatter = np.array(
        [np.linalg.norm(x[labels == c] - centroids[i], axis=1).mean()
         for i, c in enumerate(uniq)])
    db = 0.0
    for i in range(k):
        ratios = [
            (scatter[i] + scatter[j]) /
            max(np.linalg.norm(centroids[i] - centroids[j]), 1e-12)
            for j in range(k) if j != i
        ]
        db += max(ratios)
    return float(db / k)


def calinski_harabasz_score(x: np.ndarray, labels: np.ndarray) -> float:
    x = np.asarray(x, np.float64)
    uniq = np.unique(labels)
    k = len(uniq)
    n = len(x)
    if k < 2:
        return 0.0
    overall = x.mean(0)
    bss = wss = 0.0
    for c in uniq:
        xc = x[labels == c]
        centroid = xc.mean(0)
        bss += len(xc) * ((centroid - overall) ** 2).sum()
        wss += ((xc - centroid) ** 2).sum()
    return float((bss / max(k - 1, 1)) / max(wss / max(n - k, 1), 1e-12))


# ---------------------------------------------------------------------------
# stratified quota sampling
# ---------------------------------------------------------------------------


def largest_remainder_quotas(counts: np.ndarray, total: int) -> np.ndarray:
    """Allocate `total` picks across clusters proportional to `counts` by the
    largest-remainder method, capped at cluster sizes."""
    counts = np.asarray(counts, np.float64)
    n = counts.sum()
    if n == 0:
        return np.zeros_like(counts, dtype=int)
    exact = counts / n * total
    floor = np.floor(exact).astype(int)
    floor = np.minimum(floor, counts.astype(int))
    remainder = exact - floor
    left = total - floor.sum()
    # hand out remaining picks to largest remainders with available capacity
    order = np.argsort(-remainder)
    quotas = floor.copy()
    for idx in order:
        if left <= 0:
            break
        if quotas[idx] < counts[idx]:
            quotas[idx] += 1
            left -= 1
    # if still short (tiny clusters), fill anywhere with capacity
    while left > 0:
        space = np.where(quotas < counts)[0]
        if len(space) == 0:
            break
        quotas[space[0]] += 1
        left -= 1
    return quotas


def stratified_sample_from_clusters(
    labels: np.ndarray,
    n_gen: int = 30,
    n_class: int = 20,
    seed: int = 42,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-cluster proportional picks -> (gen_train_idx, class_train_idx,
    rest_idx), pairwise disjoint."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    uniq = np.unique(labels)
    counts = np.array([(labels == c).sum() for c in uniq])

    gen_quota = largest_remainder_quotas(counts, n_gen)
    gen_idx, remaining_per_cluster = [], []
    for c, q in zip(uniq, gen_quota):
        members = np.where(labels == c)[0]
        # uniform (evenly spaced) picks within the cluster
        if q > 0:
            pick_pos = np.unique(
                np.linspace(0, len(members) - 1, q).astype(int))
            while len(pick_pos) < q:
                pool = np.setdiff1d(np.arange(len(members)), pick_pos)
                pick_pos = np.sort(np.append(pick_pos, pool[0]))
            picked = members[pick_pos]
        else:
            picked = np.array([], int)
        gen_idx.append(picked)
        remaining_per_cluster.append(np.setdiff1d(members, picked))
    gen_idx = np.concatenate(gen_idx) if gen_idx else np.array([], int)

    rem_counts = np.array([len(r) for r in remaining_per_cluster])
    class_quota = largest_remainder_quotas(rem_counts, n_class)
    class_idx = []
    for rem, q in zip(remaining_per_cluster, class_quota):
        if q > 0:
            picked = rng.choice(rem, size=min(q, len(rem)), replace=False)
        else:
            picked = np.array([], int)
        class_idx.append(picked)
    class_idx = np.concatenate(class_idx) if class_idx else np.array([], int)

    rest = np.setdiff1d(np.arange(len(labels)),
                        np.concatenate([gen_idx, class_idx]))

    assert len(np.intersect1d(gen_idx, class_idx)) == 0
    assert len(np.intersect1d(gen_idx, rest)) == 0
    assert len(np.intersect1d(class_idx, rest)) == 0
    return np.sort(gen_idx), np.sort(class_idx), rest
