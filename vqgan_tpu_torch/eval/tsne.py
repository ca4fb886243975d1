"""t-SNE embedding for classifier-feature visualisation, in numpy.

Counterpart of vqgan_tpu/eval/tsne.py, a numpy copy: exact-gradient t-SNE
(no Barnes-Hut) for the few hundred points a plot of the classifier's
penultimate features holds, the top-5 / bottom-5 users by accuracy, and a
user filter. The same inputs and seed give the JAX package's embedding.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["tsne", "select_extreme_users", "embed_user_features"]


def _pairwise_sq_dists(x: np.ndarray) -> np.ndarray:
    s = (x**2).sum(1)
    return np.maximum(s[:, None] + s[None, :] - 2 * x @ x.T, 0.0)


def _binary_search_perplexity(dists: np.ndarray, perplexity: float,
                              tol: float = 1e-5, max_iter: int = 50):
    """Per-point precision betas matching the target perplexity."""
    n = dists.shape[0]
    target = np.log(perplexity)
    P = np.zeros((n, n))
    for i in range(n):
        beta, beta_min, beta_max = 1.0, -np.inf, np.inf
        di = np.delete(dists[i], i)
        for _ in range(max_iter):
            p = np.exp(-di * beta)
            sum_p = max(p.sum(), 1e-12)
            h = np.log(sum_p) + beta * (di * p).sum() / sum_p
            diff = h - target
            if abs(diff) < tol:
                break
            if diff > 0:
                beta_min = beta
                beta = beta * 2 if beta_max == np.inf else (beta + beta_max) / 2
            else:
                beta_max = beta
                beta = beta / 2 if beta_min == -np.inf else (beta + beta_min) / 2
        row = np.exp(-dists[i] * beta)
        row[i] = 0.0
        P[i] = row / max(row.sum(), 1e-12)
    return P


def tsne(
    x: np.ndarray,
    n_components: int = 2,
    perplexity: float = 30.0,
    n_iter: int = 500,
    learning_rate: float = 200.0,
    seed: int = 0,
) -> np.ndarray:
    """Exact t-SNE; x: [N, D] → [N, n_components]."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    perplexity = min(perplexity, max((n - 1) / 3.0, 2.0))

    P = _binary_search_perplexity(_pairwise_sq_dists(x), perplexity)
    P = (P + P.T) / (2.0 * n)
    P = np.maximum(P, 1e-12)
    P_early = P * 4.0  # early exaggeration

    rng = np.random.default_rng(seed)
    y = rng.normal(0, 1e-4, (n, n_components))
    gains = np.ones_like(y)
    update = np.zeros_like(y)
    momentum = 0.5

    for it in range(n_iter):
        cur_P = P_early if it < 100 else P
        if it == 250:
            momentum = 0.8
        d = _pairwise_sq_dists(y)
        num = 1.0 / (1.0 + d)
        np.fill_diagonal(num, 0.0)
        Q = np.maximum(num / num.sum(), 1e-12)

        PQ = (cur_P - Q) * num
        grad = 4.0 * ((np.diag(PQ.sum(1)) - PQ) @ y)

        gains = np.where(np.sign(grad) != np.sign(update),
                         gains + 0.2, gains * 0.8)
        gains = np.maximum(gains, 0.01)
        update = momentum * update - learning_rate * gains * grad
        y = y + update
        y = y - y.mean(0)
    return y


def select_extreme_users(per_class_accuracy: Dict[int, float],
                         k: int = 5) -> Tuple[list, list]:
    """(top-k, bottom-k) user labels by accuracy."""
    items = sorted(per_class_accuracy.items(), key=lambda kv: -kv[1])
    top = [c for c, _ in items[:k]]
    bottom = [c for c, _ in items[-k:]]
    return top, bottom


def embed_user_features(
    features: np.ndarray,
    labels: np.ndarray,
    users: Optional[Sequence[int]] = None,
    perplexity: float = 30.0,
    seed: int = 0,
):
    """t-SNE over (optionally user-filtered) features. Returns
    (embedding [M, 2], filtered labels [M])."""
    features = np.asarray(features)
    labels = np.asarray(labels)
    if users is not None:
        mask = np.isin(labels, list(users))
        features, labels = features[mask], labels[mask]
    emb = tsne(features, perplexity=perplexity, seed=seed)
    return emb, labels
