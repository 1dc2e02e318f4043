"""Radar preprocessing.

- ``radar_adjacency``: dense ``adj[i, j] = alt[j] - alt[i]`` from column 1.
  The GAT masks attention to entries > 0.

``radar_to_size_np``, the fit of a return set to 81 rows, is in
``data/host_ops.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def radar_adjacency_np(radar: np.ndarray) -> np.ndarray:
    alt = np.asarray(radar)[:, 1]
    return (alt[None, :] - alt[:, None]).astype(np.float32)


def radar_adjacency(radar: torch.Tensor) -> torch.Tensor:
    """radar (..., N, F) -> (..., N, N)."""
    alt = radar[..., 1]
    return alt[..., None, :] - alt[..., :, None]
