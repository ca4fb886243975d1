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

Under a process group (a data-parallel trainer under torchrun) every
rank calls each `FIDEvaluation` method together and makes its share of
the batches, rank r the r-th of every `world` (`rank_batches`); the
statistics are summed over the ranks, as the JAX trainer's one program
spreads its samples over the mesh: no rank waits for another to make
them all.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.inception import InceptionV3Features, load_inception_weights
from ..parallel import comm
from ..parallel.init import process_count, process_index

__all__ = ["FIDStats", "FIDEvaluation", "frechet_distance",
           "make_inception_feature_fn", "rank_batches"]


def rank_batches(n: int, batch_size: int) -> list:
    """(start, stop) of this rank's batches of `n` items in batches of
    `batch_size`: the r-th of every `world` batches on rank r, every batch
    without a process group."""
    starts = range(0, n, batch_size)[process_index()::process_count()]
    return [(i, min(i + batch_size, n)) for i in starts]


def _group_device() -> torch.device:
    """Where the default group's collectives take their tensors."""
    if torch.distributed.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


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

    def all_reduce(self) -> "FIDStats":
        """The statistics summed over every rank of the default group, in
        float64, on every rank."""
        dim = self.sum.shape[0]
        flat = torch.from_numpy(np.concatenate(
            [[float(self.n)], self.sum, self.outer.reshape(-1)]))
        flat = comm.all_reduce_(flat.to(_group_device())).cpu().numpy()
        self.n = int(round(flat[0]))
        self.sum = flat[1:1 + dim]
        self.outer = flat[1 + dim:].reshape(dim, dim)
        return self

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
    sampler_fn(generator, batch_size) -> images in [0, 1]. Under a
    process group every rank calls each method together (see the module
    docstring)."""

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
        else computed over `real_batches` and saved there. Under a
        process group `real_batches` is this rank's share of the data (its
        `rank_batches`), and rank 0 saves the whole set's statistics."""
        if self.stats_path is not None and self.stats_path.exists():
            data = np.load(self.stats_path)
            self._real = (data["mu"], data["sigma"])
            return self._real

        acc = FIDStats(self.dim)
        for batch in real_batches:
            acc.update(_numpy(self.feature_fn(batch)))
        if process_count() > 1:
            acc.all_reduce()
        self._real = acc.finalize()
        if self.stats_path is not None and process_index() == 0:
            self.stats_path.parent.mkdir(parents=True, exist_ok=True)
            np.savez(self.stats_path, mu=self._real[0], sigma=self._real[1])
        return self._real

    def fid_score(self, sampler_fn: Callable,
                  generator: Optional[torch.Generator] = None) -> float:
        """Generate num_fid_samples images through sampler_fn and score
        them against the real statistics. Under a process group this rank
        generates its `rank_batches` of them from `generator` (a generator
        of its own), and every rank returns rank 0's score."""
        assert self._real is not None, "call load_or_precalc_real_stats first"
        acc = FIDStats(self.dim)
        for start, stop in rank_batches(self.num_fid_samples,
                                        self.batch_size):
            acc.update(_numpy(self.feature_fn(
                sampler_fn(generator, stop - start))))
        shared = process_count() > 1
        if shared:
            acc.all_reduce()
        score = torch.zeros((), dtype=torch.float64)
        if process_index() == 0:
            mu_f, cov_f = acc.finalize()
            score.fill_(frechet_distance(*self._real, mu_f, cov_f))
        if shared:
            # the square root takes seconds: rank 0 computes it for all
            score = comm.broadcast_(score.to(_group_device()))
        return float(score)
