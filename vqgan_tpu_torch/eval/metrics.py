"""Image quality metrics: MSE, PSNR, and SSIM in two forms.

Counterpart of vqgan_tpu/eval/metrics.py, over NHWC tensors in [0, 1], one
value per image:
- `ssim_simplified`: the reference's global-statistics SSIM (no window),
  which its reconstruction report's thresholds were set on;
- `ssim`: Wang et al.'s SSIM with an 11x11 Gaussian window (sigma 1.5),
  a depthwise convolution with VALID padding, averaged over space and
  channels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["mse", "psnr", "ssim", "ssim_simplified"]


def _image_axes(a: torch.Tensor) -> tuple:
    return tuple(range(1, a.ndim))


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-image mean squared error."""
    return torch.mean((a - b) ** 2, dim=_image_axes(a))


def psnr(a: torch.Tensor, b: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse(a, b), min=1e-12))


def ssim_simplified(a: torch.Tensor, b: torch.Tensor,
                    max_val: float = 1.0) -> torch.Tensor:
    """SSIM from each image's global mean, variance and covariance."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    axes = _image_axes(a)
    mu_a = torch.mean(a, dim=axes, keepdim=True)
    mu_b = torch.mean(b, dim=axes, keepdim=True)
    var_a = torch.var(a, dim=axes, correction=0)
    var_b = torch.var(b, dim=axes, correction=0)
    cov = torch.mean((a - mu_a) * (b - mu_b), dim=axes)
    mu_a, mu_b = mu_a.flatten(), mu_b.flatten()
    return ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))


def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0,
         window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Windowed SSIM of NHWC images, averaged over space and channels."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    chans = a.shape[-1]
    window = torch.from_numpy(_gaussian_window(window_size, sigma)).to(
        a.device, a.dtype).expand(chans, 1, window_size, window_size)
    a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)

    def filt(x):
        return F.conv2d(x, window, groups=chans)

    mu_a, mu_b = filt(a), filt(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_aa = filt(a * a) - mu_aa
    sigma_bb = filt(b * b) - mu_bb
    sigma_ab = filt(a * b) - mu_ab
    ssim_map = ((2 * mu_ab + c1) * (2 * sigma_ab + c2)) / (
        (mu_aa + mu_bb + c1) * (sigma_aa + sigma_bb + c2))
    return torch.mean(ssim_map, dim=(1, 2, 3))
