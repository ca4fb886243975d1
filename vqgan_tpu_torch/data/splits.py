"""Dataset splits: the port's copy of vqgan_tpu/data/splits.py.

The split file is the JSON the JAX package and the reference tooling write:
{"metadata": {...}, "users": {"ID_1": {"total_images": N,
"train_indices": [...], "train_images": [...], "test_indices": [...],
"test_images": [...], optional "gen_train_images", "class_train_images",
"cluster_labels"}, ...}}.

- `create_data_split`: per user folder `ID_1..ID_{num_users}`, stratified
  uniform temporal sampling of the training frames (`uniform_indices`),
  the rest for test; a missing folder is skipped with a warning.
- `verify_split`: its integrity checks, as problem strings (empty: OK).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np

__all__ = ["IMAGE_EXTENSIONS", "create_data_split", "load_split",
           "save_split", "train_images_for_user", "uniform_indices",
           "user_dirs", "verify_split"]

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def user_dirs(data_path: str | Path, num_users: int = 31) -> Dict[str, Path]:
    """ID_1..ID_{num_users} folders under the dataset root."""
    root = Path(data_path)
    return {f"ID_{i}": root / f"ID_{i}" for i in range(1, num_users + 1)}


def _list_images(user_dir: Path) -> List[Path]:
    return [p for p in sorted(user_dir.iterdir())
            if p.suffix.lower() in IMAGE_EXTENSIONS]


def uniform_indices(n_total: int, n_pick: int) -> np.ndarray:
    """Stratified uniform temporal sampling: linspace indices, deduplicated,
    topped up from the lowest unused indices."""
    if n_pick >= n_total:
        return np.arange(n_total)
    idx = np.unique(np.linspace(0, n_total - 1, n_pick).astype(int))
    if len(idx) < n_pick:
        unused = np.setdiff1d(np.arange(n_total), idx)
        idx = np.sort(np.concatenate([idx, unused[: n_pick - len(idx)]]))
    return idx


def create_data_split(data_path: str | Path, num_users: int = 31,
                      images_per_user_train: int = 50,
                      seed: int = 42) -> Dict:
    """The uniform-sampling split of the user folders under `data_path`
    (`seed` is recorded; the sampling draws nothing at random)."""
    split = {
        "metadata": {
            "method": "stratified_uniform",
            "num_users": num_users,
            "images_per_user_train": images_per_user_train,
            "seed": seed,
            "data_path": str(data_path),
        },
        "users": {},
    }
    for user, d in user_dirs(data_path, num_users).items():
        if not d.is_dir():
            print(f"warning: missing user directory {d}, skipping")
            continue
        files = _list_images(d)
        n = len(files)
        train_idx = uniform_indices(n, images_per_user_train)
        test_idx = np.setdiff1d(np.arange(n), train_idx)
        split["users"][user] = {
            "total_images": n,
            "train_indices": train_idx.tolist(),
            "train_images": [files[i].name for i in train_idx],
            "test_indices": test_idx.tolist(),
            "test_images": [files[i].name for i in test_idx],
        }
    return split


def verify_split(split: Dict) -> List[str]:
    """Problems of a split: duplicates, train/test overlap, counts that do
    not add up to the user's total, GMM lists that repeat, reach into test
    or overlap each other. Empty when the split is sound."""
    problems = []
    for user, info in split["users"].items():
        train = info["train_images"]
        test = info["test_images"]
        if len(set(train)) != len(train):
            problems.append(f"{user}: duplicate train images")
        if len(set(test)) != len(test):
            problems.append(f"{user}: duplicate test images")
        overlap = set(train) & set(test)
        if overlap:
            problems.append(f"{user}: train/test overlap {sorted(overlap)[:3]}")
        if "total_images" in info:
            if len(train) + len(test) != info["total_images"]:
                problems.append(
                    f"{user}: train+test != total "
                    f"({len(train)}+{len(test)} != {info['total_images']})")
        for key in ("gen_train_images", "class_train_images"):
            if key in info:
                extra = info[key]
                if len(set(extra)) != len(extra):
                    problems.append(f"{user}: duplicates in {key}")
                if set(extra) & set(test):
                    problems.append(f"{user}: {key} overlaps test")
        if "gen_train_images" in info and "class_train_images" in info:
            if set(info["gen_train_images"]) & set(info["class_train_images"]):
                problems.append(f"{user}: gen/class train overlap")
    return problems


def save_split(split: Dict, path: str | Path):
    Path(path).write_text(json.dumps(split, indent=2))


def load_split(path: str | Path) -> Dict:
    return json.loads(Path(path).read_text())


def train_images_for_user(split: Dict, user: str) -> List[str]:
    """The reference LatentDataset's preference: gen_train_images (GMM
    split), else train_images (uniform split)."""
    info = split["users"][user]
    if "gen_train_images" in info:
        return info["gen_train_images"]
    return info["train_images"]
