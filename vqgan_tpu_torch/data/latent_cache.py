"""Latent cache: VAE-encoded latents stored one file per item.

Counterpart of vqgan_tpu/data/latent_cache.py, with its naming scheme
`user_{label:02d}_{stem}.npy` ([H, W, C] float32 NHWC latents). A `.pt`
file of the reference pipeline under the same stem is read as well (CHW
tensors become HWC).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .datasets import load_image
from .splits import train_images_for_user

__all__ = ["cache_filename", "LatentCache", "LatentDataset"]


def cache_filename(label: int, image_name: str) -> str:
    """`user_{label:02d}_{stem}.npy`: the reference's naming, .npy payload."""
    return f"user_{label:02d}_{Path(image_name).stem}.npy"


class LatentCache:
    def __init__(self, folder: str | Path):
        self.folder = Path(folder)
        self.folder.mkdir(parents=True, exist_ok=True)

    def path(self, label: int, image_name: str) -> Path:
        return self.folder / cache_filename(label, image_name)

    def has(self, label: int, image_name: str) -> bool:
        return self.path(label, image_name).exists()

    def save(self, label: int, image_name: str, latent: np.ndarray):
        np.save(self.path(label, image_name), np.asarray(latent, np.float32))

    def load(self, label: int, image_name: str) -> np.ndarray:
        p = self.path(label, image_name)
        if p.exists():
            return np.load(p)
        pt = p.with_suffix(".pt")
        if pt.exists():
            arr = torch.load(pt, map_location="cpu",
                             weights_only=True).float().numpy()
            if arr.ndim == 3 and arr.shape[0] in (1, 3, 4):  # CHW -> HWC
                arr = arr.transpose(1, 2, 0)
            return np.ascontiguousarray(arr)
        raise FileNotFoundError(p)


class LatentDataset:
    """Cached latents and labels for stage-2 training.

    Per user: gen_train_images (GMM split), else train_images; with
    `images_per_user` below their number, a per-user seeded random choice
    (`default_rng(seed + label)`), as the JAX package picks them.

    encode_fn(images [1, H, W, 3] float32 in [0, 1]) -> latents [1, h, w, c]
    encodes an item missing from the cache and stores it; without it a
    missing item raises.
    """

    def __init__(self, data_path: str | Path, split: Dict,
                 cache: LatentCache, image_size: int = 256,
                 encode_fn: Optional[Callable] = None,
                 images_per_user: Optional[int] = None, seed: int = 42):
        self.data_path = Path(data_path)
        self.cache = cache
        self.image_size = image_size
        self.encode_fn = encode_fn
        self.items: List[Tuple[str, str, int]] = []  # (user, name, label)
        for user in split["users"]:
            label = int(user.split("_")[1]) - 1
            names = train_images_for_user(split, user)
            if images_per_user is not None and len(names) > images_per_user:
                user_rng = np.random.default_rng(seed + label)
                names = list(user_rng.choice(names, images_per_user,
                                             replace=False))
            self.items += [(user, name, label) for name in names]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        user, name, label = self.items[i]
        try:
            return self.cache.load(label, name), label
        except FileNotFoundError:
            if self.encode_fn is None:
                raise
        img = load_image(self.data_path / user / name, self.image_size)
        latent = np.asarray(self.encode_fn(img[None]))[0]
        self.cache.save(label, name, latent)
        return latent, label

    def fully_cached(self) -> bool:
        return all(self.cache.has(label, name)
                   for _, name, label in self.items)

    def native_batch_loader(self, batch_size: int, shuffle: bool = True,
                            seed: int = 0, repeat: bool = False,
                            n_threads: int = 8):
        """(latents, labels) batches over a fully populated `.npy` cache
        through the C++ batch reader (`native_loader.NativeLatentBatcher`):
        one multi-threaded pread fan-out per batch instead of a Python loop
        over items. Its own `default_rng(seed)` permutation per epoch,
        drop-last; `repeat` goes on over epochs. As the JAX package's."""
        from .native_loader import NativeLatentBatcher

        paths = [self.cache.path(label, name)
                 for _, name, label in self.items]
        labels = np.asarray([label for _, _, label in self.items], np.int32)
        batcher = NativeLatentBatcher(paths, n_threads=n_threads)
        rng = np.random.default_rng(seed)
        n = len(paths)

        def iterator():
            while True:
                order = rng.permutation(n) if shuffle else np.arange(n)
                end = n - (n % batch_size)
                for s in range(0, end, batch_size):
                    idx = order[s:s + batch_size]
                    yield batcher.gather(idx.tolist()), labels[idx]
                if not repeat:
                    return

        return iterator()
