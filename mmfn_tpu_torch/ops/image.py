"""Camera image preprocessing on the device.

The network consumes raw 0-255 pixel values through the ImageNet mean/std
affine: images are never divided by 255. That quirk comes from the reference
lineage and is kept for checkpoint parity. The host half, the downscale and
crop (``scale_and_crop_image``), is in ``data/host_ops.py``.
"""

from __future__ import annotations

import torch

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """ImageNet per-channel affine on an NHWC tensor of raw 0-255 values."""
    mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std
