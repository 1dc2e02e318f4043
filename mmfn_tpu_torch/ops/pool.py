"""Adaptive average pooling (NCHW, as the models hold their feature maps).

Every fusion stage pools its feature maps to 8x8 anchors. MMFN's maps have
sides divisible by 8 (64/32/16/8), where the pool is an exact block mean;
other sides take torch's own adaptive pool, which the JAX package emulates.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    out_h, out_w = out_hw
    b, c, h, w = x.shape
    if h % out_h == 0 and w % out_w == 0:
        return x.reshape(b, c, out_h, h // out_h, out_w, w // out_w).mean(dim=(3, 5))
    return F.adaptive_avg_pool2d(x, (out_h, out_w))
