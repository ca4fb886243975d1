"""FID evaluation: Inception features on the device, the Fréchet distance
on the host.

Counterpart of vqgan_tpu/eval/fid.py (the reference's fid_evaluation.py):
- `FIDStats`: streaming float64 mean / covariance of feature batches on
  the host (sums and the sum of outer products; no feature matrix kept);
- `frechet_distance`: ||mu1 - mu2||^2 + tr(S1 + S2 - 2 (S1 S2)^(1/2)),
  the square root by scipy (a symmetric-eigendecomposition fallback
  without it), retried with eps * I added to both covariances when it is
  not finite;
- `make_inception_feature_fn`: the port's `InceptionV3Features` on a
  device, NHWC images in [0, 1] in, [B, 2048] features out; weights from
  a torchvision / pytorch-fid state dict, or flax's default
  initialisation from `seed` (the pipeline runs, the FID is not
  calibrated);
- `FIDEvaluation`: real statistics, cached to an .npz when a path is
  given, and `fid_score(sampler_fn, generator)` over `num_fid_samples`
  generated images; sampler_fn(generator, n) returns n NHWC images in
  [0, 1], where the JAX package passes a key.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.inception import InceptionV3Features, load_inception_weights

__all__ = ["FIDStats", "FIDEvaluation", "frechet_distance",
           "make_inception_feature_fn"]


class FIDStats:
    """Streaming mean/covariance accumulator for feature batches."""

    def __init__(self, dim: int = 2048):
        self.n = 0
        self.sum = np.zeros((dim,), np.float64)
        self.outer = np.zeros((dim, dim), np.float64)

    def update(self, feats: np.ndarray):
        feats = np.asarray(feats, np.float64)
        self.n += feats.shape[0]
        self.sum += feats.sum(axis=0)
        self.outer += feats.T @ feats

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        mu = self.sum / self.n
        cov = (self.outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov


def _sqrtm_psd(a: np.ndarray) -> np.ndarray:
    """Matrix square root; scipy when available, symmetric-eig fallback.
    `sqrtm` is called without `disp`, which scipy 1.18 removed (the JAX
    package's `disp=False` raises there); the square root is the same."""
    try:
        from scipy import linalg

        return np.real(linalg.sqrtm(a))
    except ImportError:
        sym = (a + a.T) / 2
        vals, vecs = np.linalg.eigh(sym)
        vals = np.clip(vals, 0, None)
        return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """FID = |mu1 - mu2|^2 + tr(cov1 + cov2 - 2 (cov1 cov2)^(1/2))."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1, cov2 = np.asarray(cov1, np.float64), np.asarray(cov2, np.float64)
    diff = mu1 - mu2

    covmean = _sqrtm_psd(cov1 @ cov2)
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = _sqrtm_psd((cov1 + offset) @ (cov2 + offset))
    return float(
        diff @ diff + np.trace(cov1) + np.trace(cov2)
        - 2 * np.trace(covmean))


def _numpy(feats) -> np.ndarray:
    if isinstance(feats, torch.Tensor):
        return feats.detach().cpu().numpy()
    return np.asarray(feats)


def make_inception_feature_fn(state_dict=None, seed: int = 0,
                              device="cuda") -> Callable:
    """images [B, H, W, 3] in [0, 1] (numpy or tensor) -> [B, 2048] fp32
    features on `device`. `state_dict`: torchvision / pytorch-fid
    InceptionV3 weights; None for flax's default init from `seed`."""
    device = resolve_device(device)
    model = InceptionV3Features(
        generator=torch.Generator().manual_seed(seed))
    if state_dict is not None:
        load_inception_weights(model, state_dict)
    model = model.to(device).eval()

    def features(images):
        x = torch.as_tensor(images).to(device)
        with torch.inference_mode():
            return model(x.permute(0, 3, 1, 2))

    return features


class FIDEvaluation:
    """feature_fn(images [B, H, W, 3] in [0, 1]) -> [B, dim] (the port's
    Inception by default elsewhere: `make_inception_feature_fn`);
    sampler_fn(generator, batch_size) -> images in [0, 1]."""

    def __init__(
        self,
        feature_fn: Callable,
        batch_size: int = 64,
        num_fid_samples: int = 50000,
        stats_path: Optional[str] = None,
        dim: int = 2048,
    ):
        self.feature_fn = feature_fn
        self.batch_size = batch_size
        self.num_fid_samples = num_fid_samples
        self.stats_path = Path(stats_path) if stats_path else None
        self.dim = dim
        self._real: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def load_or_precalc_real_stats(self, real_batches: Iterator):
        """Real-data (mu, cov): loaded from `stats_path` when it exists,
        else computed over `real_batches` and saved there."""
        if self.stats_path is not None and self.stats_path.exists():
            data = np.load(self.stats_path)
            self._real = (data["mu"], data["sigma"])
            return self._real

        acc = FIDStats(self.dim)
        for batch in real_batches:
            acc.update(_numpy(self.feature_fn(batch)))
        self._real = acc.finalize()
        if self.stats_path is not None:
            self.stats_path.parent.mkdir(parents=True, exist_ok=True)
            np.savez(self.stats_path, mu=self._real[0], sigma=self._real[1])
        return self._real

    def fid_score(self, sampler_fn: Callable,
                  generator: Optional[torch.Generator] = None) -> float:
        """Generate num_fid_samples images through sampler_fn and score
        them against the real statistics."""
        assert self._real is not None, "call load_or_precalc_real_stats first"
        acc = FIDStats(self.dim)
        remaining = self.num_fid_samples
        while remaining > 0:
            n = min(self.batch_size, remaining)
            acc.update(_numpy(self.feature_fn(sampler_fn(generator, n))))
            remaining -= n
        mu_f, cov_f = acc.finalize()
        mu_r, cov_r = self._real
        return frechet_distance(mu_r, cov_r, mu_f, cov_f)
