"""GPU-resident dataset cache: epochs served from device memory.

A streaming loader decodes and copies every batch from the host each step.
MMFN-scale datasets are small (10k frames are about 5.4 GB in transport
dtypes), so the whole dataset is uploaded once in the lossless transport
dtypes the loader already uses (camera and map rasters as uint8, the BEV
grid as uint8 counts), and each shuffled batch is one on-device gather and
cast. After the one-time fill, epochs read neither disk nor the host link.

Single-process use only; a multi-process run keeps the streaming loader,
whose per-process sharding replaces DistributedSampler.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from mmfn_tpu_torch.data.batch import Batch
from mmfn_tpu_torch.data.collate import collate_samples
from mmfn_tpu_torch.device import resolve_device
from mmfn_tpu_torch.ops.lidar import HIST_MAX_PER_PIXEL
from mmfn_tpu_torch.ops.radar import radar_adjacency

_COLUMNS = ("image", "bev", "map", "lanes", "lane_num", "radar", "target_point",
            "velocity", "waypoints", "command", "action")


def estimate_cache_bytes(n_samples: int, max_lanes: int, resolution: int = 256,
                         need_map: bool = True) -> int:
    """Transport-dtype footprint of ``n_samples`` cached frames (uint8
    rasters + f32 tensors), for the auto-enable gate. ``need_map=False``
    drops the birdview raster (only the img variant reads
    ``Batch.map_img``): 3 of the 8 uint8 planes, about 37% of the
    footprint."""
    per = (resolution * resolution * 3          # image u8
           + resolution * resolution * 2        # bev counts u8
           + (resolution * resolution * 3 if need_map else 0)  # map u8
           + max_lanes * 10 * 5 * 4             # lanes f32
           + 81 * 5 * 4                         # radar f32
           + (4 * 2 + 2 + 1 + 3 + 1 + 1) * 4)  # labels/scalars
    return n_samples * per


class DeviceDataset:
    """Uploads an indexable dataset of phase-1 samples once; serves shuffled
    device batches.

    ``batches(batch_size, shuffle, seed)`` yields :class:`Batch` objects on
    ``device`` (the CUDA device when None), each one gather and cast of the
    resident columns. They equal the streaming loader's batches: the uint8
    transport is exact for raw 0-255 rasters and counts/5 BEV grids, and
    ``radar_adj`` is recomputed on the device as collate computes it on the
    host. ``need_map=False`` neither stages nor uploads the birdview column.
    """

    def __init__(self, dataset, max_lanes: int, chunk: int = 256,
                 progress: bool = False, need_map: bool = True, device=None):
        self.device = resolve_device(device)
        self.n = len(dataset)
        self.max_lanes = max_lanes
        cols = {k: [] for k in _COLUMNS}
        for lo in range(0, self.n, chunk):
            b = collate_samples([dataset[i] for i in range(lo, min(lo + chunk, self.n))],
                                max_lanes)
            cols["image"].append(b.image.astype(np.uint8))
            cols["bev"].append(np.rint(b.lidar_bev * HIST_MAX_PER_PIXEL).astype(np.uint8))
            cols["map"].append(b.map_img.astype(np.uint8)
                               if need_map and b.map_img is not None else None)
            cols["lanes"].append(b.lanes)
            cols["lane_num"].append(b.lane_num)
            cols["radar"].append(b.radar)
            cols["target_point"].append(b.target_point)
            cols["velocity"].append(b.velocity)
            cols["waypoints"].append(b.waypoints)
            cols["command"].append(b.command)
            cols["action"].append(b.action)
            if progress:
                print(f"device cache: {min(lo + chunk, self.n)}/{self.n} samples staged",
                      flush=True)

        def put(parts):
            if not parts or any(p is None for p in parts):
                return None
            return torch.from_numpy(np.concatenate(parts)).to(self.device)

        self._cols = {k: put(v) for k, v in cols.items()}

    @property
    def nbytes(self) -> int:
        return sum(c.numel() * c.element_size() for c in self._cols.values()
                   if c is not None)

    def _gather(self, idx: torch.Tensor) -> Batch:
        c = self._cols
        radar = c["radar"][idx]

        def take(name, dtype=None):
            col = c[name]
            if col is None:
                return None
            return col[idx] if dtype is None else col[idx].to(dtype)

        return Batch(
            image=take("image", torch.float32),
            lidar_bev=take("bev", torch.float32) / HIST_MAX_PER_PIXEL,
            map_img=take("map", torch.float32),
            lanes=take("lanes"),
            lane_num=take("lane_num"),
            radar=radar,
            radar_adj=radar_adjacency(radar),
            target_point=take("target_point"),
            velocity=take("velocity"),
            waypoints=take("waypoints"),
            command=take("command"),
            action=take("action"),
        )

    def batches(self, batch_size: int, *, shuffle: bool = False, seed: int = 0,
                drop_last: bool = True) -> Iterator[Batch]:
        """The batches of one epoch, in the order of ``data_loader`` with the
        same ``shuffle`` and ``seed``."""
        order = (np.random.default_rng(seed).permutation(self.n)
                 if shuffle else np.arange(self.n))
        order = torch.from_numpy(order.astype(np.int64)).to(self.device)
        stop = self.n - batch_size + 1 if drop_last else self.n
        for lo in range(0, max(stop, 0), batch_size):
            yield self._gather(order[lo:lo + batch_size])


def maybe_device_cache(train_set, val_set, gconf, mode, world_size: int = 1,
                       budget_bytes: int = 8 << 30, need_map: bool = True,
                       device=None) -> Optional[tuple]:
    """phase2's gate: ``(train_cache, val_cache)`` when the cached path
    applies, else None. ``mode``: "auto" | True | False. The cache lives on
    one device, so it needs a single-process run (``world_size`` 1); "auto"
    also requires the footprint to fit ``budget_bytes``, and True on a
    multi-process run raises."""
    enabled = mode if isinstance(mode, bool) else None
    if enabled is False:
        return None
    single = world_size == 1
    est = estimate_cache_bytes(len(train_set) + len(val_set), gconf.max_lanes,
                               need_map=need_map)
    if enabled is None:
        if not single or est > budget_bytes:
            return None
    elif not single:
        raise ValueError("device_data_cache=true needs a single-process, single-device "
                         f"run (got world size {world_size})")
    return (DeviceDataset(train_set, gconf.max_lanes, progress=True, need_map=need_map,
                          device=device),
            DeviceDataset(val_set, gconf.max_lanes, need_map=need_map, device=device))
