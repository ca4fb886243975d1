"""Per-user sweep of the GMM cluster count.

    python -m vqgan_tpu_torch.validate_cluster_number \\
        --vae_path results/kl_vae/kl_vae-50.pt --data_path data/Normal_line \\
        --output_dir cluster_validation

Counterpart of cli/validate_cluster_number.py, with its flags. Per user:
the features of `preprocess_latents_with_gmm` (encode in padded batches,
flatten, standardize, PCA to 95% of the variance), then for every k in
[k_min, k_max] a GMM (5 restarts, generator seeded with seed + uid * 100 +
k) and its BIC, AIC, silhouette, Davies-Bouldin and Calinski-Harabasz
scores and cluster sizes; the knee of BIC and AIC (`find_elbow_point`),
the best k of the other three, their majority vote, a six-panel plot
(`eval/plots.py`, written when matplotlib is present) and, over all users,
the majority k against the gait-theory prior k = 4. The JSON report
`cluster_validation.json` is always written.

Runs on the GPU by default (`--device cpu` to run on the CPU), with TF32
off for fp32 matmuls and convolutions.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from .data import (
    calinski_harabasz_score,
    davies_bouldin_score,
    gmm_aic,
    gmm_bic,
    gmm_fit,
    gmm_predict,
    silhouette_score,
)
from .device import resolve_device, set_full_fp32_precision
from .eval.plots import plot_cluster_validation
from .generate import load_vae
from .preprocess_latents_with_gmm import (
    encode_user,
    project_features,
    user_images,
)

__all__ = ["find_elbow_point", "main", "parse_args"]


def find_elbow_point(values) -> int:
    """Knee of a decreasing curve: the index farthest from the chord
    between its first and last points."""
    v = np.asarray(values, np.float64)
    n = len(v)
    if n < 3:
        return 0
    x = np.arange(n)
    # |(p2 - p1) x (p - p1)|, the 2-D cross product written out
    dx, dy = n - 1, v[-1] - v[0]
    d = np.abs(dx * (v - v[0]) - dy * x) / np.linalg.norm([dx, dy])
    return int(np.argmax(d))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vae_path", required=True,
                    help="KL-VAE state dict (.pt) or Orbax "
                         "checkpoint directory")
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--output_dir", default="./cluster_validation")
    ap.add_argument("--num_users", type=int, default=31)
    ap.add_argument("--k_min", type=int, default=2)
    ap.add_argument("--k_max", type=int, default=8)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the sweep; returns the report written to
    `cluster_validation.json`."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_full_fp32_precision()
    vae = load_vae(args.vae_path, image_size=args.image_size, device=device)

    root = Path(args.data_path)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    report = {}
    votes = []
    for uid in range(1, args.num_users + 1):
        d = root / f"ID_{uid}"
        if not d.is_dir():
            continue
        files = user_images(d)
        latents = encode_user(vae, files, args.image_size, args.batch_size,
                              device)
        proj, _ = project_features(latents, device)
        proj_np = proj.cpu().numpy()

        ks = list(range(args.k_min, args.k_max + 1))
        metrics = {m: [] for m in ("bic", "aic", "silhouette",
                                   "davies_bouldin", "calinski_harabasz")}
        sizes = {}
        for k in ks:
            generator = torch.Generator().manual_seed(
                args.seed + uid * 100 + k)
            params, ll = gmm_fit(generator, proj, k=k, n_init=5)
            labels = gmm_predict(params, proj).cpu().numpy()
            metrics["bic"].append(gmm_bic(params, proj_np, ll))
            metrics["aic"].append(gmm_aic(params, proj_np, ll))
            metrics["silhouette"].append(silhouette_score(proj_np, labels))
            metrics["davies_bouldin"].append(
                davies_bouldin_score(proj_np, labels))
            metrics["calinski_harabasz"].append(
                calinski_harabasz_score(proj_np, labels))
            sizes[k] = np.bincount(labels, minlength=k).tolist()

        recommendations = {
            "bic_elbow": ks[find_elbow_point(metrics["bic"])],
            "aic_elbow": ks[find_elbow_point(metrics["aic"])],
            "silhouette_best": ks[int(np.argmax(metrics["silhouette"]))],
            "davies_bouldin_best": ks[int(np.argmin(
                metrics["davies_bouldin"]))],
            "calinski_best": ks[int(np.argmax(
                metrics["calinski_harabasz"]))],
        }
        vals, counts = np.unique(
            list(recommendations.values()), return_counts=True)
        majority = int(vals[np.argmax(counts)])
        votes.append(majority)
        report[f"ID_{uid}"] = {
            "ks": ks, "metrics": metrics, "cluster_sizes": sizes,
            "recommendations": recommendations, "majority_vote": majority,
        }
        print(f"ID_{uid}: majority k={majority} "
              f"(votes: {recommendations})")
        plot_cluster_validation(
            f"ID_{uid}", ks, metrics, sizes, recommendations,
            out / f"ID_{uid}_validation.png")

    overall = int(np.bincount(votes).argmax()) if votes else None
    report["summary"] = {
        "overall_majority_k": overall,
        "gait_theory_k": 4,
        "agreement_with_theory": overall == 4,
    }
    (out / "cluster_validation.json").write_text(json.dumps(report, indent=2))
    print(f"overall majority k={overall} (gait theory suggests 4); "
          f"report -> {out / 'cluster_validation.json'}")
    return report


if __name__ == "__main__":
    main()
