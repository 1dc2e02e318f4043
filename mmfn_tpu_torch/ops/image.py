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
_CONSTANTS = {}   # (device, dtype) -> (mean, std), never written again


def _constants(device: torch.device, dtype: torch.dtype):
    return (torch.tensor(_IMAGENET_MEAN, dtype=dtype, device=device),
            torch.tensor(_IMAGENET_STD, dtype=dtype, device=device))


def imagenet_constants(device: torch.device, dtype: torch.dtype):
    """The mean and std on ``device``, built once per (device, dtype): a
    tensor built from host values is a host-to-device copy, which a CUDA
    graph's capture refuses. They are normal tensors, usable under autograd
    too."""
    key = (device, dtype)
    constants = _CONSTANTS.get(key)
    if constants is None:
        with torch.inference_mode(False):
            constants = _CONSTANTS[key] = _constants(device, dtype)
    return constants


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """ImageNet per-channel affine on an NHWC tensor of raw 0-255 values.
    While ``torch.export`` or ``torch.compile`` traces, the constants are
    built in the traced graph (a cache would hold the tracer's fake
    tensors)."""
    if torch.compiler.is_compiling():
        mean, std = _constants(x.device, x.dtype)
    else:
        mean, std = imagenet_constants(x.device, x.dtype)
    return (x - mean) / std
