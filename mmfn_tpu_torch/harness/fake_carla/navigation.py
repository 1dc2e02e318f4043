"""Shim for ``agents.navigation.global_route_planner`` — the CARLA
PythonAPI helper ``carla_glue.interpolate_route_carla`` imports. The port's
own copy of the JAX package's ``tests/fake_carla/navigation.py``.

The real GlobalRoutePlanner searches the road graph; this one interpolates
linearly between keypoints at ``hop`` spacing with RoadOption.LANEFOLLOW (4),
which is exact for the straight/loop fake towns the mock tests drive.
"""

from __future__ import annotations

import math

LANEFOLLOW = 4


class _WP:
    def __init__(self, x: float, y: float):
        from mmfn_tpu_torch.harness.fake_carla import Location, Transform

        self.transform = Transform(Location(x, y, 0.0))


class GlobalRoutePlanner:
    def __init__(self, world_map, hop: float = 1.0):
        self._hop = hop

    def trace_route(self, loc_a, loc_b):
        ax, ay, bx, by = loc_a.x, loc_a.y, loc_b.x, loc_b.y
        dist = math.hypot(bx - ax, by - ay)
        n = max(1, int(dist / self._hop))
        out = []
        for i in range(n + 1):
            t = i / n
            out.append((_WP(ax + (bx - ax) * t, ay + (by - ay) * t),
                        LANEFOLLOW))
        return out
