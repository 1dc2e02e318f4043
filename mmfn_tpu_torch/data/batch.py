"""The canonical inference batch: a NamedTuple of tensors.

Same fields and layouts as the JAX package's ``Batch``: images and the LiDAR
BEV are NHWC, images are raw 0-255 floats (the network applies the ImageNet
affine), the ragged lane list is padded to (B, max_lanes, 10, 5) with a
``lane_num`` count. The models turn NHWC into NCHW themselves.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Batch(NamedTuple):
    image: torch.Tensor                 # (B, H, W, 3) float, raw 0-255
    lidar_bev: torch.Tensor             # (B, 256, 256, 2) float
    target_point: torch.Tensor          # (B, 2)
    velocity: torch.Tensor              # (B,)
    map_img: Optional[torch.Tensor] = None      # (B, H, W, 3) rasterized HD-map
    lanes: Optional[torch.Tensor] = None        # (B, L, 10, 5) vectorized lanes
    lane_num: Optional[torch.Tensor] = None     # (B,) valid-lane counts
    radar: Optional[torch.Tensor] = None        # (B, 81, 5)
    radar_adj: Optional[torch.Tensor] = None    # (B, 81, 81)
    waypoints: Optional[torch.Tensor] = None    # (B, 4, 2) ground-truth labels
    command: Optional[torch.Tensor] = None      # (B,) navigational command (1-based)
    action: Optional[torch.Tensor] = None       # (B, 3) expert steer/throttle/brake
