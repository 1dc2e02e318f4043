"""Camera image preprocessing.

``scale_and_crop_image`` runs on the host (uint8 HWC in and out). The
network consumes raw 0-255 pixel values through the ImageNet mean/std
affine: images are never divided by 255. That quirk comes from the reference
lineage and is kept for checkpoint parity.
"""

from __future__ import annotations

import numpy as np
import torch

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def scale_and_crop_image(image: np.ndarray, scale: int = 1, crop: int = 256) -> np.ndarray:
    """Downscale by an integer factor (PIL's default resample, as the
    reference's ``image.resize((w, h))``) and center-crop to (crop, crop, C).
    The row offset comes from the height and the column offset from the
    width, as in the reference."""
    image = np.asarray(image)
    h, w = image.shape[:2]
    if scale != 1:
        from PIL import Image

        new_w, new_h = int(w // scale), int(h // scale)
        image = np.asarray(Image.fromarray(
            np.ascontiguousarray(image)).resize((new_w, new_h)))
        h, w = new_h, new_w
    row0 = h // 2 - crop // 2
    col0 = w // 2 - crop // 2
    return image[row0:row0 + crop, col0:col0 + crop]


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """ImageNet per-channel affine on an NHWC tensor of raw 0-255 values."""
    mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std
