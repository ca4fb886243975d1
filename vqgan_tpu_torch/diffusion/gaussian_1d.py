"""1-D Gaussian diffusion over sequences.

Counterpart of vqgan_tpu/diffusion/gaussian_1d.py: `GaussianDiffusion` over
[B, L, C] sequences ([B, C, L] inside, for `models/unet1d.py`), with
`channel_first_data` for [B, C, L] data as the reference's torch code
holds it; `Dataset1D` is an in-memory dataset the DDPM `Trainer` takes as
`dataset=`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .gaussian import GaussianDiffusion

__all__ = ["GaussianDiffusion1D", "Dataset1D"]


@dataclasses.dataclass
class GaussianDiffusion1D(GaussianDiffusion):
    seq_length: int = 128
    channel_first_data: bool = False  # [B, C, L] data in and out

    def _swap(self, x):
        return x.transpose(1, 2) if self.channel_first_data else x

    def loss(self, seq, classes=None, **kwargs):
        """The training loss of a batch of sequences ([B, L, C], or [B, C,
        L] with `channel_first_data`); as `GaussianDiffusion.loss`."""
        seq = self._swap(torch.as_tensor(seq, device=self.device))
        return super().loss(seq, classes, **kwargs)

    def sample(self, batch_size: int = 16, classes=None, *,
               cond_scale: float = 1.0, rescaled_phi: float = 0.0,
               generator: torch.Generator = None,
               graph: Optional[bool] = None):
        """[B, L, C] samples (or [B, C, L] with `channel_first_data`):
        DDIM when sampling_timesteps < T, else ancestral; `graph` as in
        `GaussianDiffusion.ddim_sample` (the graphs keyed by the [B, C, L]
        shape apart from the images')."""
        shape = (batch_size, self.seq_length, self.channels)
        fn = self.ddim_sample if self.is_ddim_sampling else self.p_sample_loop
        out = fn(shape, classes, cond_scale=cond_scale,
                 rescaled_phi=rescaled_phi, generator=generator, graph=graph)
        return self._swap(out)


class Dataset1D:
    """In-memory sequences as (sequence, 0) items."""

    def __init__(self, tensor):
        self.data = np.asarray(tensor, dtype=np.float32)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return self.data[idx], 0
