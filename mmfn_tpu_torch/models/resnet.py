"""ResNet backbones (torchvision BasicBlock topology), staged execution.

The MMFN encoder interleaves fusion transformers between ResNet stages, so
the backbone exposes ``stem`` and ``stage(i)`` instead of one forward.
Parameter names are torchvision's (``conv1``, ``bn1``, ``layer2.0.downsample.0``
...), so reference checkpoints load unchanged. BatchNorm eps is 1e-5 and runs
from its running statistics in eval mode.

``first_stage=2`` builds a backbone without ``conv1``/``bn1``/``layer1``: the
vec and rad map streams are seeded at layer2 by VectorNet and never run them.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from mmfn_tpu_torch.models.common import max_pool_3x3_s2_p1

WIDTHS = (64, 128, 256, 512)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout, eps=1e-5)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout, eps=1e-5)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False), nn.BatchNorm2d(cout, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Staged ResNet; ``stage_sizes`` (2,2,2,2) is resnet18, (3,4,6,3) resnet34."""

    def __init__(self, stage_sizes: Sequence[int], in_channels: int = 3,
                 first_stage: int = 1):
        super().__init__()
        self.first_stage = first_stage
        if first_stage == 1:
            self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
            self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        for i, (width, blocks) in enumerate(zip(WIDTHS, stage_sizes)):
            if i + 1 < first_stage:
                continue
            cin = WIDTHS[max(i - 1, 0)]
            layer = [BasicBlock(cin if j == 0 else width, width,
                                2 if (i > 0 and j == 0) else 1) for j in range(blocks)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_3x3_s2_p1(F.relu(self.bn1(self.conv1(x))))

    def stage(self, x: torch.Tensor, index: int) -> torch.Tensor:
        """Run layer{index} (1-based, torchvision naming)."""
        return getattr(self, f"layer{index}")(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for i in range(1, 5):
            x = self.stage(x, i)
        return x.mean(dim=(2, 3))


def resnet18(in_channels: int = 3, first_stage: int = 1) -> ResNet:
    return ResNet((2, 2, 2, 2), in_channels, first_stage)


def resnet34(in_channels: int = 3, first_stage: int = 1) -> ResNet:
    return ResNet((3, 4, 6, 3), in_channels, first_stage)
