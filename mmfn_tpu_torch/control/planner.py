"""Route planner: tracks the global plan and yields the next target waypoint.

The port's own copy of the JAX package's ``RoutePlanner``, after
team_code/e2e_agent/planner.py:7-56. GPS positions are scaled to meters
with the CARLA 0.9.10 constants; passed waypoints are popped once a nearer
one is within ``min_distance``; the returned target is route[1].
"""

from __future__ import annotations

import math
from collections import deque
from typing import Tuple

import numpy as np

# meters per degree at the CARLA 0.9.10 reference latitude
GPS_SCALE = np.array([111324.60662786, 111319.490945])
EARTH_RADIUS_EQUA = 6378137.0


def gps_to_location(latitude: float, longitude: float, altitude: float = 0.0,
                    lat_ref: float = 0.0, lon_ref: float = 0.0) -> Tuple[float, float, float]:
    """Inverse web-mercator GPS -> CARLA world (x, y, z).

    Reference: from_gps (team_code/expert_agent/common/utils.py:125-152) — the
    inverse of scenario_runner's _location_to_gps, including the y sign flip.
    """
    scale = math.cos(lat_ref * math.pi / 180.0)
    basex = scale * math.pi * EARTH_RADIUS_EQUA / 180.0 * lon_ref
    basey = scale * EARTH_RADIUS_EQUA * math.log(math.tan((90.0 + lat_ref) * math.pi / 360.0))
    x = scale * math.pi * EARTH_RADIUS_EQUA / 180.0 * longitude - basex
    y = scale * EARTH_RADIUS_EQUA * math.log(math.tan((90.0 + latitude) * math.pi / 360.0)) - basey
    return x, -y, altitude


def location_to_gps(x: float, y: float, z: float = 0.0,
                    lat_ref: float = 0.0, lon_ref: float = 0.0) -> Tuple[float, float, float]:
    """World -> GPS, matching leaderboard route_manipulation.py:21-41."""
    scale = math.cos(lat_ref * math.pi / 180.0)
    mx = scale * lon_ref * math.pi * EARTH_RADIUS_EQUA / 180.0 + x
    my = scale * EARTH_RADIUS_EQUA * math.log(math.tan((90.0 + lat_ref) * math.pi / 360.0)) - y
    lon = mx * 180.0 / (math.pi * EARTH_RADIUS_EQUA * scale)
    lat = 360.0 * math.atan(math.exp(my / (EARTH_RADIUS_EQUA * scale))) / math.pi - 90.0
    return lat, lon, z


class RoutePlanner:
    def __init__(self, min_distance: float, max_distance: float):
        self.route = deque()
        self.min_distance = min_distance
        self.max_distance = max_distance
        self.mean = np.array([0.0, 0.0])
        self.scale = GPS_SCALE.copy()

    def set_route(self, global_plan, gps: bool = False) -> None:
        """global_plan: iterable of (pos, command). With gps=True, pos is a
        {'lat','lon'} dict, decoded with the same linear (mean, scale) map
        the agents apply to their own position; otherwise an (x, y)
        array-like in world meters."""
        self.route.clear()
        for pos, cmd in global_plan:
            if gps:
                pos = (np.array([pos["lat"], pos["lon"]]) - self.mean) * self.scale
            else:
                pos = np.asarray(pos, dtype=np.float64)[:2] - self.mean
            self.route.append((pos, cmd))

    def run_step(self, gps: np.ndarray):
        """gps: current (x, y) in world meters. Returns (pos, command)."""
        if len(self.route) == 1:
            return self.route[0]

        to_pop = 0
        farthest_in_range = -math.inf
        cumulative_distance = 0.0
        gx, gy = float(gps[0]), float(gps[1])
        for i in range(1, len(self.route)):
            if cumulative_distance > self.max_distance:
                break
            a, b = self.route[i][0], self.route[i - 1][0]
            cumulative_distance += math.hypot(a[0] - b[0], a[1] - b[1])
            distance = math.hypot(a[0] - gx, a[1] - gy)
            if distance <= self.min_distance and distance > farthest_in_range:
                farthest_in_range = distance
                to_pop = i
        for _ in range(to_pop):
            if len(self.route) > 2:
                self.route.popleft()
        return self.route[1]
