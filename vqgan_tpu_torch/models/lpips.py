"""LPIPS perceptual distance (Zhang et al. 2018) on a VGG16 trunk.

Counterpart of vqgan_tpu/models/lpips.py, NCHW. Parameter names follow the
published weights, so they load directly:
- `vgg.features.{i}.weight/bias`: torchvision VGG16's `features` Sequential
  (convolutions at their Sequential positions, up to relu5_3);
- `lin{i}.model.1.weight`: the lpips package's 1x1 linear layers,
  [1, C, 1, 1] (position 0 of `model` is the package's dropout, unused).
`load_torch_weights(vgg_state, lin_state)` takes the two state dicts, as the
JAX package's `load_torch_lpips_weights`.

The arithmetic is the JAX package's, not the lpips package's: features are
unit-normalised as f * rsqrt(sum_c f^2 + 1e-10), in fp32, and the lin
weights enter as |w|. Without a weight file the module keeps its random
initialisation (lin weights 1), as the JAX trainer does: it exercises the
training path but is not a calibrated perceptual metric.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d

__all__ = ["VGG16Features", "LPIPS", "perceptual_loss_fn"]

# torchvision VGG16 conv layout: channels per conv, "M" = 2x2 max pool
_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512]
_TAP_AFTER_CONV = [1, 3, 6, 9, 12]  # relu1_2 ... relu5_3, 0-based conv index
_TAP_CHANNELS = [64, 128, 256, 512, 512]
# the lpips "scaling layer" for inputs in [-1, 1]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """VGG16 trunk returning the five LPIPS tap activations, NCHW. Convs
    compute in `dtype` with fp32 parameters."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        layers: List[nn.Module] = []
        taps = []
        in_ch, conv_idx = 3, 0
        for spec in _VGG16_CFG:
            if spec == "M":
                layers.append(nn.MaxPool2d(2))
                continue
            layers += [Conv2d(in_ch, spec, 3, padding=1, dtype=dtype),
                       nn.ReLU()]
            if conv_idx in _TAP_AFTER_CONV:
                taps.append(len(layers) - 1)  # Sequential index of the ReLU
            in_ch, conv_idx = spec, conv_idx + 1
        self.features = nn.Sequential(*layers)
        self.taps = taps

    def forward(self, x) -> List[torch.Tensor]:
        out = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps:
                out.append(x)
        return out


class _Lin(nn.Module):
    """The lpips package's NetLinLayer layout: `model.1` is the 1x1 conv."""

    def __init__(self, channels: int):
        super().__init__()
        conv = nn.Conv2d(channels, 1, 1, bias=False)
        nn.init.ones_(conv.weight)
        self.model = nn.Sequential(nn.Identity(), conv)


class LPIPS(nn.Module):
    """forward(x, y): NCHW images in [-1, 1] -> [B] distances."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.vgg = VGG16Features(dtype)
        for i, c in enumerate(_TAP_CHANNELS):
            self.add_module(f"lin{i}", _Lin(c))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x, y):
        b = x.shape[0]
        both = torch.cat([x.float(), y.float()])
        feats = self.vgg((both - self.shift) / self.scale)
        total = 0.0
        for i, f in enumerate(feats):
            f = f.float()
            unit = f * torch.rsqrt((f * f).sum(dim=1, keepdim=True) + 1e-10)
            diff = (unit[:b] - unit[b:]) ** 2
            w = getattr(self, f"lin{i}").model[1].weight.abs()  # [1, C, 1, 1]
            total = total + (diff * w).sum(dim=1).mean(dim=(1, 2))
        return total

    def load_torch_weights(self, vgg_state: Dict[str, torch.Tensor],
                           lin_state: Dict[str, torch.Tensor]) -> None:
        """torchvision VGG16 `features.*` tensors (other keys, such as the
        classifier's, are ignored) and lpips `lin{i}.model.1.weight`."""
        self.vgg.load_state_dict(
            {k: torch.as_tensor(v) for k, v in vgg_state.items()
             if k.startswith("features.")})
        for i in range(len(_TAP_CHANNELS)):
            w = torch.as_tensor(lin_state[f"lin{i}.model.1.weight"])
            getattr(self, f"lin{i}").model[1].weight.data.copy_(
                w.reshape(1, -1, 1, 1))


def perceptual_loss_fn(lpips: LPIPS):
    """fn(recon, inputs) over NCHW images in [0, 1]: LPIPS after mapping
    both to [-1, 1]."""

    def fn(recon, inputs):
        return lpips(recon * 2.0 - 1.0, inputs * 2.0 - 1.0)

    return fn
