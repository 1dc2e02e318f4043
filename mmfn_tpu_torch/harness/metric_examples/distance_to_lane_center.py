"""Signed lateral offset of the ego from the nearest lane centerline — the
map-API example metric (reference
srunner/metrics/examples/distance_to_lane_center.py:22-70: distance to the
`town_map.get_waypoint` projection, left-of-lane positive). The waypoint
query here is a vectorized projection onto the rough map's centerline
segments; the sign comes from the segment direction's cross product, same
convention as the reference's right-vector projection.

The port's own copy of ``examples/metrics/distance_to_lane_center.py``."""

import json
import os

import numpy as np

from mmfn_tpu_torch.harness.metrics_log import BasicMetric


def _signed_lateral_offset(points, lanes):
    """points (n,2) -> signed distance to the nearest centerline segment
    across all lanes (positive = left of segment direction)."""
    best = np.full(len(points), np.inf)
    signed = np.zeros(len(points))
    for lane in lanes:
        xy = lane.nodes[:, :2]
        if len(xy) < 2:
            continue
        a, b = xy[:-1], xy[1:]
        ab = b - a                                     # (s, 2)
        denom = np.maximum((ab * ab).sum(-1), 1e-12)
        ap = points[:, None, :] - a[None, :, :]        # (n, s, 2)
        t = np.clip((ap * ab[None]).sum(-1) / denom, 0.0, 1.0)
        proj = a[None] + t[..., None] * ab[None]
        d = np.linalg.norm(points[:, None, :] - proj, axis=-1)   # (n, s)
        seg = np.argmin(d, axis=1)
        dmin = d[np.arange(len(points)), seg]
        closer = dmin < best
        # left-positive sign: cross(segment dir, point - proj)
        dirs = ab[seg]
        rel = points - proj[np.arange(len(points)), seg]
        cross = dirs[:, 0] * rel[:, 1] - dirs[:, 1] * rel[:, 0]
        signed = np.where(closer, np.sign(cross) * dmin, signed)
        best = np.minimum(best, dmin)
    return signed


class DistanceToLaneCenter(BasicMetric):

    def _create_metric(self, town_map, log, criteria):
        if town_map is None:
            raise ValueError("DistanceToLaneCenter needs the vectorized map")
        ego_id = log.get_ego_vehicle_id()
        start, end = log.get_actor_alive_frames(ego_id)
        pts = log.get_all_actor_transforms(ego_id, start, end)[:, :2]
        offs = _signed_lateral_offset(pts, town_map.lanes)

        self.frames = list(range(start, end + 1))
        self.offsets = offs.round(3).tolist()
        with open(os.path.join(self.out_dir,
                               "DistanceToLaneCenter.json"), "w") as f:
            json.dump({"frames": self.frames,
                       "lateral_offset_m": self.offsets}, f)
