"""Deterministic synthetic data for tests and the GPU smoke run (no CARLA
needed). The draws are the JAX package's, in the same order from the same
numpy seed, so both packages can be fed identical data."""

from __future__ import annotations

import numpy as np
import torch

from mmfn_tpu_torch.data.batch import Batch
from mmfn_tpu_torch.device import resolve_device


def synthetic_samples(n: int, max_lanes: int = 64, seed: int = 0,
                      resolution: int = 256):
    """``n`` phase-1-format sample dicts (the pickle payload
    ``PreprocessedDataset`` reads): f32 image/bev/map rasters, ragged lane
    tensors, 81-row radar, waypoint/control labels."""
    rng = np.random.default_rng(seed)
    r = resolution
    out = []
    for _ in range(n):
        n_lanes = int(rng.integers(1, max_lanes + 1))
        lanes = (rng.normal(size=(n_lanes, 10, 5)) * 10).astype(np.float32)
        lanes[..., 2:] = rng.integers(0, 2, size=lanes[..., 2:].shape)
        out.append({
            "image": rng.integers(0, 256, size=(r, r, 3)).astype(np.float32),
            "lidar_bev": (rng.integers(0, 6, size=(r, r, 2))
                          .astype(np.float32) / 5.0),
            "map_img": rng.integers(0, 256, size=(r, r, 3)).astype(np.float32),
            "lanes": lanes,
            "radar": rng.normal(size=(81, 5)).astype(np.float32),
            "target_point": (rng.normal(size=2) * 5).astype(np.float32),
            "waypoints": rng.normal(size=(4, 2)).astype(np.float32),
            "steer": np.float32(rng.uniform(-1, 1)),
            "throttle": np.float32(rng.uniform(0, 1)),
            "brake": np.float32(0.0),
            "command": np.float32(rng.integers(1, 7)),
            "velocity": np.float32(abs(rng.normal()) * 5),
        })
    return out


def synthetic_batch(batch_size: int = 2, max_lanes: int = 64, seed: int = 0,
                    resolution: int = 256, device=None) -> Batch:
    """One random :class:`Batch` of tensors on ``device`` (the CUDA device
    when None; ``"cpu"`` on request)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    r = resolution
    lanes = rng.normal(size=(batch_size, max_lanes, 10, 5)).astype(np.float32) * 10
    lanes[..., 2:] = rng.integers(0, 2, size=lanes[..., 2:].shape)
    lane_num = rng.integers(1, max_lanes + 1, size=(batch_size,))
    radar = rng.normal(size=(batch_size, 81, 5)).astype(np.float32)
    adj = radar[:, None, :, 1] - radar[:, :, None, 1]
    fields = dict(
        image=rng.integers(0, 256, size=(batch_size, r, r, 3)).astype(np.float32),
        lidar_bev=rng.integers(0, 6, size=(batch_size, r, r, 2)).astype(np.float32) / 5.0,
        map_img=rng.integers(0, 256, size=(batch_size, r, r, 3)).astype(np.float32),
        lanes=lanes,
        lane_num=lane_num.astype(np.int32),
        radar=radar,
        radar_adj=adj.astype(np.float32),
        target_point=rng.normal(size=(batch_size, 2)).astype(np.float32) * 5,
        velocity=np.abs(rng.normal(size=(batch_size,))).astype(np.float32) * 5,
        waypoints=rng.normal(size=(batch_size, 4, 2)).astype(np.float32),
        command=rng.integers(1, 7, size=(batch_size,)).astype(np.int32),
        action=rng.uniform(0, 1, size=(batch_size, 3)).astype(np.float32),
    )
    return Batch(**{k: torch.from_numpy(v).to(device) for k, v in fields.items()})
