"""Reading dataset splits: the port's copy of what it needs from
vqgan_tpu/data/splits.py.

The split file is the JSON the JAX package and the reference tooling write:
{"metadata": {...}, "users": {"ID_1": {"train_images": [...],
"test_images": [...], optional "gen_train_images", ...}, ...}}.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

__all__ = ["load_split", "save_split", "train_images_for_user"]


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
