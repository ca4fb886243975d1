"""Matplotlib reports: cluster-validation panels and the t-SNE scatter.

Counterpart of vqgan_tpu/eval/plots.py, a numpy copy: the reference's
six-panel per-user cluster report and the t-SNE scatter of classifier
features. Headless (Agg); each function does nothing and returns None when
matplotlib is missing. That is reporting only; no computation depends on
it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["plot_cluster_validation", "plot_tsne"]


def _get_plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def plot_cluster_validation(
    user: str,
    ks: Sequence[int],
    metrics: Dict[str, Sequence[float]],
    cluster_sizes: Dict[int, Sequence[int]],
    recommendations: Dict[str, int],
    out_path: str | Path,
):
    """6 panels: BIC, AIC, silhouette, Davies-Bouldin, Calinski-Harabasz,
    cluster-size distribution at the majority-vote k."""
    plt = _get_plt()
    if plt is None:
        return None

    fig, axes = plt.subplots(2, 3, figsize=(15, 8))
    panels = [
        ("bic", "BIC (lower better)"),
        ("aic", "AIC (lower better)"),
        ("silhouette", "Silhouette (higher better)"),
        ("davies_bouldin", "Davies-Bouldin (lower better)"),
        ("calinski_harabasz", "Calinski-Harabasz (higher better)"),
    ]
    for ax, (key, title) in zip(axes.flat, panels):
        ax.plot(list(ks), metrics[key], marker="o")
        ax.set_title(title)
        ax.set_xlabel("k")
        ax.grid(alpha=0.3)

    votes = list(recommendations.values())
    majority = max(set(votes), key=votes.count)
    sizes = cluster_sizes.get(majority, [])
    ax = axes.flat[5]
    ax.bar(range(len(sizes)), sizes)
    ax.set_title(f"cluster sizes at k={majority} (majority vote)")
    ax.set_xlabel("cluster")

    fig.suptitle(f"{user} — cluster-count validation")
    fig.tight_layout()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def plot_tsne(
    embedding: np.ndarray,
    labels: np.ndarray,
    out_path: str | Path,
    title: str = "t-SNE of classifier features",
    highlight: Optional[Sequence[int]] = None,
):
    plt = _get_plt()
    if plt is None:
        return None

    fig, ax = plt.subplots(figsize=(8, 7))
    uniq = np.unique(labels)
    cmap = plt.get_cmap("tab20")
    for i, c in enumerate(uniq):
        m = labels == c
        ax.scatter(embedding[m, 0], embedding[m, 1], s=14,
                   color=cmap(i % 20),
                   label=f"ID_{int(c) + 1}",
                   edgecolors="black" if highlight and c in highlight
                   else "none", linewidths=0.5)
    ax.legend(fontsize=7, ncol=2, markerscale=1.2)
    ax.set_title(title)
    fig.tight_layout()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
