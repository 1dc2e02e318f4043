"""Bilinear resize with ``align_corners=True`` (NCHW).

The fused 8x8 token grids go back to each stream's resolution this way. With
one output pixel, align_corners samples source pixel 0 (torch semantics,
which the JAX package reproduces with its interpolation matrices).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    out_h, out_w = out_hw
    if tuple(x.shape[2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)
