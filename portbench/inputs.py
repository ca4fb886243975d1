"""Inputs made from the seed: host pools of synthetic images or latents
and the order in which a run feeds them.

The users' spectrograms and latents are not in the repository, so a pool
stands in for them: smooth random images in [0, 1] (a 16 x 16 field
upsampled bilinearly, fine noise added, through a sigmoid), or latents
drawn from N(0, 1) (the KL-VAE's 0.18215 scale brings real latents near
it) with class labels uniform over the users. Every seed gets the same
sizes; only the values and the order differ.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["image_pool", "latent_pool", "batch_order", "batches"]


def image_pool(n: int, size: int, channels: int, seed: int) -> np.ndarray:
    """[n, size, size, channels] float32 NHWC images in [0, 1]."""
    gen = torch.Generator().manual_seed(seed)
    coarse = torch.randn((n, channels, 16, 16), generator=gen)
    fine = torch.randn((n, channels, size, size), generator=gen)
    x = F.interpolate(coarse, size=(size, size), mode="bilinear",
                      align_corners=False) * 1.5 + 0.3 * fine
    return torch.sigmoid(x).permute(0, 2, 3, 1).contiguous().numpy()


def latent_pool(n: int, size: int, channels: int, classes: int,
                seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """([n, size, size, channels] float32 NHWC latents, [n] int64 labels)."""
    rng = np.random.default_rng(seed)
    latents = rng.standard_normal((n, size, size, channels),
                                  dtype=np.float32)
    return latents, rng.integers(0, classes, size=n, dtype=np.int64)


def batch_order(n: int, batch: int, seed: int) -> Iterator[np.ndarray]:
    """Endless row indices, `batch` at a time: each pass over the pool in
    a new order drawn from the seed, so the rows of one pass all differ."""
    if n % batch:
        raise ValueError(f"a pool of {n} rows does not split into batches "
                         f"of {batch}")
    rng = np.random.default_rng(seed)
    while True:
        perm = rng.permutation(n)
        for i in range(0, n, batch):
            yield perm[i:i + batch]


def batches(arrays, batch: int, seed: int) -> Iterator[tuple]:
    """Endless tuples of the arrays' rows, in `batch_order`."""
    for rows in batch_order(len(arrays[0]), batch, seed):
        yield tuple(a[rows] for a in arrays)
