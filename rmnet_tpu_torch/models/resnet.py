"""ResNet-50 trunk through layer3 (counterpart of rmnet_tpu/models/resnet.py).

torchvision's "v1.5" bottleneck (stride on the 3x3 conv). BatchNorm is
frozen (every module stays in eval mode) unless ``train_batch_norm`` runs
it on batch statistics (TRAIN.USE_BATCH_NORM); the convs take a compute
dtype (models/layers.py). Attribute names follow the reference encoders
(conv1, bn1, res2, res3, res4), so reference state dicts load as they are.
Under a width mesh (``space``, parallel/space.py) the trunk holds the rank's
columns: its convolutions and the stem's max pool exchange halos.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rmnet_tpu_torch.models.layers import BatchNorm2d, Conv2d


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4) + residual."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        cout = planes * 4
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, cout, 1, bias=False)
        self.bn3 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride=stride, bias=False), BatchNorm2d(cout)
            )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def _make_layer(cin: int, planes: int, blocks: int, stride: int) -> nn.Sequential:
    mods = [Bottleneck(cin, planes, stride)]
    mods += [Bottleneck(planes * 4, planes) for _ in range(blocks - 1)]
    return nn.Sequential(*mods)


class ResNet50Trunk(nn.Module):
    """conv1..layer3 of ResNet-50 on NCHW; returns (r4 1/16, r3 1/8, r2 1/4, c1 1/2)."""

    space = None  # a width mesh: the rank's columns (parallel/space.py)

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.res2 = _make_layer(64, 64, 3, 1)
        self.res3 = _make_layer(256, 128, 4, 2)
        self.res4 = _make_layer(512, 256, 6, 2)

    def trunk(self, x: Optional[torch.Tensor], extra_stem=None, conv1_out=None):
        """``extra_stem`` (64-ch, 1/2) is added to conv1's output before bn1 —
        the memory encoder's mask stems hook in here; ``conv1_out`` replaces
        ``conv1(x)`` (the memory encoder's merged 5-channel stem)."""
        x = self.conv1(x) if conv1_out is None else conv1_out
        if extra_stem is not None:
            x = x + extra_stem
        c1 = F.relu(self.bn1(x))
        if self.space is None:
            r2 = self.res2(F.max_pool2d(c1, 3, 2, 1))
        else:
            r2 = self.res2(self.space.max_pool(c1, 3, 2, 1))
        r3 = self.res3(r2)
        r4 = self.res4(r3)
        return r4, r3, r2, c1

    def forward(self, x):
        return self.trunk(x)
