"""LiDAR preprocessing: ego-frame re-registration and the BEV histogram.

- ``transform_2d_points``: rigid SE(2) re-registration of a cloud from a
  capture pose into the current ego pose (z and further columns unchanged).
- ``lidar_to_histogram_features``: two height slices (z <= -2 m, z > -2 m) on
  a 256x256 grid at 8 px/m over x in [-16, 16], y in [-24, 8], clipped at 5
  points per cell and divided by 5. On a CUDA tensor it launches the
  hand-written kernel ``csrc/bev_hist.cu``; on a CPU tensor it takes the
  plain PyTorch version :func:`bev_histogram_plain`, which does the same bin
  math.
- ``bev_counts_np`` / ``pad_points``: the host helpers of the serving
  pipeline.

Phase 1's numpy binning (``np.histogramdd``) and the grid's constants are in
``data/host_ops.py``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mmfn_tpu_torch.data.host_ops import (HEIGHT_SPLIT, HIST_MAX_PER_PIXEL,
                                          PIXELS_PER_METER, X_RANGE, Y_RANGE)
from mmfn_tpu_torch.ops._cuda import CudaKernel, check_cuda_tensor, stream_handle

GRID = 256
CLUSTERS = (8, 16)   # thread blocks per cloud the kernel can take

BEV_HIST = CudaKernel("bev_hist.cu", "mmfn_bev_hist", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p])


def transform_2d_points(xyz: torch.Tensor, r1, t1_x, t1_y, r2, t2_x, t2_y) -> torch.Tensor:
    """Map (N, >=3) points from the pose-1 frame to the pose-2 frame. The
    frame-to-world transform is ``[[cos r, sin r, tx], [-sin r, cos r, ty]]``
    applied to [x, y, 1]."""
    def scalar(a):
        return torch.as_tensor(a, dtype=xyz.dtype, device=xyz.device)

    r1, r2 = scalar(r1), scalar(r2)
    c1, s1 = torch.cos(r1), torch.sin(r1)
    c2, s2 = torch.cos(r2), torch.sin(r2)
    x, y = xyz[:, 0], xyz[:, 1]
    wx = c1 * x + s1 * y + scalar(t1_x)
    wy = -s1 * x + c1 * y + scalar(t1_y)
    dx, dy = wx - scalar(t2_x), wy - scalar(t2_y)
    nx = c2 * dx - s2 * dy
    ny = s2 * dx + c2 * dy
    return torch.cat([torch.stack([nx, ny], dim=1), xyz[:, 2:]], dim=1)


def bev_histogram_plain(points4: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, N, 4) [x, y, z, valid] ->
    (B, 256, 256, 2) f32, bin math in f32 whatever the input type.

    Same expressions as the JAX kernel's ``_bin_indices``. A point whose f32
    ``(x + 16) * 8`` or ``(y + 24) * 8`` rounds up to 256 (the largest f32
    below 16, or the two below 8) has no bin there and is dropped, as the JAX
    package's XLA path drops it. (Its Pallas kernel sends such a point, when
    below the height split, to the above channel's y-bin 0.)"""
    b = points4.shape[0]
    p = points4.to(torch.float32)
    x, y, z, valid = p.unbind(-1)
    in_range = (x >= X_RANGE[0]) & (x <= X_RANGE[1]) & (y >= Y_RANGE[0]) & (y <= Y_RANGE[1])
    ok = in_range & (valid > 0.0)
    # clamp before the integer cast: out-of-range and NaN rows are masked
    # off, but must not overflow the cast
    fx = torch.floor((x - X_RANGE[0]) * PIXELS_PER_METER).clamp(0, GRID)
    fy = torch.floor((y - Y_RANGE[0]) * PIXELS_PER_METER).clamp(0, GRID)
    ix = torch.where(x == X_RANGE[1], GRID - 1, torch.nan_to_num(fx).to(torch.int64))
    iy = torch.where(y == Y_RANGE[1], GRID - 1, torch.nan_to_num(fy).to(torch.int64))
    ok = ok & (ix < GRID) & (iy < GRID)
    above = (~(z <= HEIGHT_SPLIT)).to(torch.int64)
    batch = torch.arange(b, device=points4.device)[:, None]
    cells = b * GRID * GRID * 2
    # dropped rows count into one spare cell past the end (no boolean
    # indexing, so no device-to-host sync)
    idx = torch.where(ok, ((batch * GRID + ix) * GRID + iy) * 2 + above, cells)
    counts = torch.zeros(cells + 1, dtype=torch.int64, device=points4.device)
    counts.index_put_((idx.reshape(-1),), torch.ones_like(idx.reshape(-1)), accumulate=True)
    hist = counts[:cells].clamp(max=int(HIST_MAX_PER_PIXEL)).to(torch.float32) / HIST_MAX_PER_PIXEL
    return hist.view(b, GRID, GRID, 2)


def cluster_size(batch: int) -> int:
    """Thread blocks per cloud. One cloud cannot fill the card, and 16
    blocks halve the band each SM zeroes and writes; with more clouds a
    cluster of 8 is the faster (PERF.md, kernel 1's cluster sizes)."""
    return 16 if batch == 1 else 8


def bev_histogram(points4: torch.Tensor) -> torch.Tensor:
    """(B, N, 4) [x, y, z, valid] in f16 or f32 -> (B, 256, 256, 2) f32.

    A CUDA tensor launches ``csrc/bev_hist.cu`` (one launch for the whole
    batch, reading f16 directly, its counts in the shared memory of one
    thread-block cluster per cloud, of :func:`cluster_size` blocks); a CPU
    tensor takes :func:`bev_histogram_plain`."""
    if points4.device.type == "cpu":
        return bev_histogram_plain(points4)
    return _bev_histogram_cuda(points4, cluster_size(points4.shape[0]))


def _bev_histogram_cuda(points4: torch.Tensor, cluster: int) -> torch.Tensor:
    """Launch the kernel with ``cluster`` (one of :data:`CLUSTERS`) blocks per
    cloud."""
    align = 8 if points4.dtype == torch.float16 else 16
    check_cuda_tensor("points4", points4, (torch.float16, torch.float32), 3, align)
    b, n, cols = points4.shape
    if cols != 4:
        raise ValueError(f"points4: expected (B, N, 4), got {tuple(points4.shape)}")
    if n >= 2 ** 31 or b > 65535 or b * n >= 2 ** 31:
        raise ValueError(f"points4: shape {tuple(points4.shape)} too large")
    out = torch.empty((b, GRID, GRID, 2), dtype=torch.float32, device=points4.device)
    if b:
        BEV_HIST.launch(points4.data_ptr(), int(points4.dtype == torch.float16),
                        out.data_ptr(), b, n, cluster, stream_handle(points4.device))
    return out


def lidar_to_histogram_features(points4: torch.Tensor) -> torch.Tensor:
    """(N, 4) -> (256, 256, 2), or (B, N, 4) -> (B, 256, 256, 2), NHWC."""
    if points4.dim() == 2:
        return bev_histogram(points4[None])[0]
    return bev_histogram(points4)


def bev_counts_np(points: np.ndarray) -> np.ndarray:
    """Host-side binning: (N, >=3) ragged cloud -> (256, 256, 2) uint8 counts
    clipped at 5, in float64 (the serving pipeline's ``host_bev`` mode)."""
    pts = np.asarray(points)
    x, y, z = (pts[:, 0].astype(np.float64), pts[:, 1].astype(np.float64),
               pts[:, 2])
    ix = np.floor((x - X_RANGE[0]) * PIXELS_PER_METER).astype(np.int64)
    iy = np.floor((y - Y_RANGE[0]) * PIXELS_PER_METER).astype(np.int64)
    ix[x == X_RANGE[1]] = GRID - 1
    iy[y == Y_RANGE[1]] = GRID - 1
    ok = ((x >= X_RANGE[0]) & (x <= X_RANGE[1])
          & (y >= Y_RANGE[0]) & (y <= Y_RANGE[1]))
    above = (z > HEIGHT_SPLIT).astype(np.int64)
    idx = (above * GRID * GRID + ix * GRID + iy)[ok]
    counts = np.bincount(idx, minlength=2 * GRID * GRID).reshape(2, GRID, GRID)
    return np.minimum(counts, int(HIST_MAX_PER_PIXEL)).astype(
        np.uint8).transpose(1, 2, 0)


def pad_points(points: np.ndarray, max_points: int) -> np.ndarray:
    """(N, >=3) ragged cloud -> (max_points, 4) [x, y, z, valid] f32."""
    out = np.zeros((max_points, 4), dtype=np.float32)
    n = min(points.shape[0], max_points)
    out[:n, :3] = points[:n, :3]
    out[:n, 3] = 1.0
    return out
