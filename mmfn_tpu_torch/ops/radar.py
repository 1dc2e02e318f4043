"""Radar preprocessing.

- ``radar_to_size_np``: fit a variable-length return set to exactly 81 rows.
  Surplus rows with the largest |velocity/depth| are deleted, keeping the
  survivors in their original order; a short set is zero-padded.
- ``radar_adjacency``: dense ``adj[i, j] = alt[j] - alt[i]`` from column 1.
  The GAT masks attention to entries > 0.
"""

from __future__ import annotations

import numpy as np
import torch


def radar_to_size_np(data: np.ndarray, target_size=(81, 5)) -> np.ndarray:
    data = np.asarray(data)
    out = np.zeros(target_size)
    if data.shape[0] >= target_size[0]:
        n_extra = data.shape[0] - target_size[0]
        order = (-np.abs(data[:, 0] / data[:, 3])).argsort()
        out = np.delete(data, order[:n_extra], 0)
    else:
        out[:data.shape[0], :] = data
    return out


def radar_adjacency_np(radar: np.ndarray) -> np.ndarray:
    alt = np.asarray(radar)[:, 1]
    return (alt[None, :] - alt[:, None]).astype(np.float32)


def radar_adjacency(radar: torch.Tensor) -> torch.Tensor:
    """radar (..., N, F) -> (..., N, N)."""
    alt = radar[..., 1]
    return alt[..., None, :] - alt[..., :, None]
