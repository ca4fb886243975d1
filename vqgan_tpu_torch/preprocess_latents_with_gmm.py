"""Latent preprocessing with a per-user GMM-stratified split.

    python -m vqgan_tpu_torch.preprocess_latents_with_gmm \\
        --vae_path results/kl_vae/kl_vae-50.pt --data_path data/Normal_line \\
        --output_split data_split.json --cache_folder latents_cache

Counterpart of cli/preprocess_latents_with_gmm.py, with its flags. Per
user: encode every image to its posterior mean times the scale factor
(`KLVAE.encode_images_mean`, NHWC) in batches of `--batch_size`, the last
one zero-padded to a whole batch and sliced back; flatten each latent to
h * w * c features; standardize; PCA to `--pca_var` of the variance;
fit a GMM with the user's K (`USER_K_VALUES`, capped at max(2, n // 5)),
full covariances with the diagonal fallback, restarts drawn from a
generator seeded with seed + uid; pick `--n_gen_train` gen-train and
`--n_class_train` class-train images per cluster by largest-remainder
quotas; the rest is the test set. The split JSON carries the JAX CLI's
fields (cluster labels included); only the gen-train latents go into
the latent cache (`LatentCache`), which `train_latent_cfg` reads.

Runs on the GPU by default (`--device cpu` to run on the CPU), with TF32
off for fp32 matmuls and convolutions.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from .data import (
    IMAGE_EXTENSIONS,
    LatentCache,
    gmm_fit,
    gmm_predict,
    load_image,
    pca_fit,
    standardize,
    stratified_sample_from_clusters,
)
from .data.datasets import pad_to_batch
from .device import resolve_device, set_full_fp32_precision
from .generate import load_vae

__all__ = ["USER_K_VALUES", "encode_user", "main", "parse_args",
           "project_features", "user_images"]

# hand-tuned per-user cluster counts of the reference: 4 (gait theory),
# with these overrides
USER_K_VALUES = {i: 4 for i in range(1, 32)}
USER_K_VALUES.update({2: 5, 7: 3, 13: 5, 19: 3, 26: 5})


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vae_path", required=True,
                    help="KL-VAE state dict (.pt) or Orbax "
                         "checkpoint directory")
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--output_split", default="data_split.json")
    ap.add_argument("--cache_folder", default="./latents_cache")
    ap.add_argument("--num_users", type=int, default=31)
    ap.add_argument("--n_gen_train", type=int, default=30)
    ap.add_argument("--n_class_train", type=int, default=20)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--pca_var", type=float, default=0.95)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def user_images(folder: Path):
    return [p for p in sorted(folder.iterdir())
            if p.suffix.lower() in IMAGE_EXTENSIONS]


def encode_user(vae, files, image_size: int, batch_size: int,
                device) -> np.ndarray:
    """NHWC latents [N, h, w, c] of `files`, encoded in whole batches."""
    latents = []
    for s in range(0, len(files), batch_size):
        chunk = files[s:s + batch_size]
        imgs = pad_to_batch(
            np.stack([load_image(p, image_size) for p in chunk]), batch_size)
        with torch.inference_mode():
            z = vae.encode_images_mean(torch.from_numpy(imgs).to(device))
        latents.append(z.cpu().numpy()[:len(chunk)])
    return np.concatenate(latents)


def project_features(latents: np.ndarray, device, pca_var: float = 0.95):
    """Flattened (h, w, c order) latents -> standardized -> PCA.
    Returns (projected features [N, k] on `device`, k)."""
    feats = torch.from_numpy(latents.reshape(len(latents), -1)).to(device)
    feats_std, _, _ = standardize(feats)
    comps, k_pca, _ = pca_fit(feats_std, var_ratio=pca_var)
    return feats_std @ comps, k_pca


def main(argv=None) -> dict:
    """Write the split and the gen-train latents. Returns {"split",
    "users": {user: {"encode_seconds", "gmm_seconds" (PCA + GMM +
    predict), "covariance_type", "n_clusters", "pca_dims"}}}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_full_fp32_precision()
    vae = load_vae(args.vae_path, image_size=args.image_size, device=device)

    cache = LatentCache(args.cache_folder)
    root = Path(args.data_path)
    split = {
        "metadata": {
            "method": "gmm_stratified",
            "num_users": args.num_users,
            "n_gen_train": args.n_gen_train,
            "n_class_train": args.n_class_train,
            "seed": args.seed,
        },
        "users": {},
    }
    stats = {}
    for uid in range(1, args.num_users + 1):
        user = f"ID_{uid}"
        d = root / user
        if not d.is_dir():
            print(f"warning: missing {d}, skipping")
            continue
        files = user_images(d)
        label = uid - 1

        t0 = time.perf_counter()
        latents = encode_user(vae, files, args.image_size, args.batch_size,
                              device)
        t1 = time.perf_counter()
        proj, k_pca = project_features(latents, device, args.pca_var)
        k = USER_K_VALUES.get(uid, 4)
        k = min(k, max(2, len(files) // 5))
        generator = torch.Generator().manual_seed(args.seed + uid)
        params, _ = gmm_fit(generator, proj, k=k, n_init=10)
        labels = gmm_predict(params, proj).cpu().numpy()
        t2 = time.perf_counter()

        gen_idx, class_idx, rest_idx = stratified_sample_from_clusters(
            labels, args.n_gen_train, args.n_class_train,
            seed=args.seed + uid)
        train_idx = np.concatenate([gen_idx, class_idx])
        split["users"][user] = {
            "total_images": len(files),
            "n_clusters": int(k),
            "cluster_labels": labels.tolist(),
            "gen_train_images": [files[i].name for i in gen_idx],
            "class_train_images": [files[i].name for i in class_idx],
            "train_images": [files[i].name for i in train_idx],
            "test_images": [files[i].name for i in rest_idx],
            "test_indices": rest_idx.tolist(),
            "train_indices": train_idx.tolist(),
        }
        for i in gen_idx:
            cache.save(label, files[i].name, latents[i])
        stats[user] = {"encode_seconds": t1 - t0, "gmm_seconds": t2 - t1,
                       "covariance_type": params.covariance_type,
                       "n_clusters": int(k), "pca_dims": int(k_pca)}
        print(f"{user}: {len(files)} imgs, k={k}, pca_dims={k_pca}, "
              f"gen={len(gen_idx)} class={len(class_idx)} "
              f"test={len(rest_idx)} ({params.covariance_type} covariances)")

    Path(args.output_split).write_text(json.dumps(split, indent=2))
    print(f"wrote {args.output_split}")
    return {"split": split, "users": stats}


if __name__ == "__main__":
    main()
