"""Where the port's entry points run: on the GPU unless the caller asks for
the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` or, when None, the CUDA device; raises when there is none
    rather than carrying on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
