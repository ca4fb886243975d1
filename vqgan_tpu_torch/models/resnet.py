"""ResNet-18 classifier, trained from scratch.

Counterpart of vqgan_tpu/models/resnet.py (the reference trains
torchvision's resnet18 with weights=None), NCHW:
- a 7x7 stride-2 stem, BatchNorm, ReLU and a 3x3 stride-2 max pool
  padded with -inf (flax's `finfo.min` padding is the same);
- `BasicBlock`s of two 3x3 convolutions, a 1x1 convolution + BatchNorm on
  the shortcut where the shape changes;
- features: the fp32 spatial mean; logits: a Linear on them.
BatchNorm is models/layers.py's, with flax's statistics (momentum 0.1,
biased running variance). Parameter names are torchvision's (`conv1`,
`bn1`, `layer1.0.conv1`, `layer1.0.downsample.0` / `.1`, `fc`);
`checkpoint/from_jax.py:resnet_state_from_jax` maps the JAX package's
`layer{i}_block{j}` / `downsample_conv` / `downsample_bn` onto them.
A fresh model takes flax's default initialisation (`lecun_normal_init_`,
from `generator`), which the JAX package's ResNet keeps: it sets no
kernel_init. Everything computes in fp32.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv2d, lecun_normal_init_

__all__ = ["BasicBlock", "ResNet", "ResNet18"]


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_channels, filters, 3, stride, padding=1,
                            bias=False)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv2d(filters, filters, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(filters)
        self.downsample = None
        if stride != 1 or in_channels != filters:
            self.downsample = nn.Sequential(
                Conv2d(in_channels, filters, 1, stride, bias=False),
                BatchNorm(filters))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """forward(x [B, 3, H, W]) -> logits [B, num_classes], or (logits,
    features [B, width * 8]) with return_features."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int,
                 width: int = 64, generator=None):
        super().__init__()
        self.conv1 = Conv2d(3, width, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm(width)
        channels = width
        for i, n_blocks in enumerate(stage_sizes):
            blocks = []
            for j in range(n_blocks):
                filters = width * 2**i
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(BasicBlock(channels, filters, stride))
                channels = filters
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.fc = nn.Linear(channels, num_classes)
        lecun_normal_init_(self, generator)

    def forward(self, x, return_features: bool = False):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(self.n_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        feats = x.mean(dim=(2, 3))
        logits = self.fc(feats)
        if return_features:
            return logits, feats
        return logits


def ResNet18(num_classes: int, generator=None) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), num_classes=num_classes,
                  generator=generator)
