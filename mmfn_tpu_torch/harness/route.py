"""Route files, downsampling, and indexing.

Route XML format (leaderboard/data/*.xml):
    <routes>
      <route id="0" town="Town01">
        <waypoint x=".." y=".." z=".." pitch=".." roll=".." yaw=".."/>
        ...
      </route>
    </routes>

``downsample_route`` mirrors route_manipulation.py:86-129: keep waypoints at
lane changes, at road-option transitions, every ``sample_factor`` meters, and
at the end. ``RouteIndexer`` mirrors the resume-from-checkpoint iteration
(route_indexer.py:13-71).

The port's own copy of the JAX package's ``harness/route.py``.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from mmfn_tpu_torch.harness.events import RoadOption  # noqa: F401  (re-exported)
from mmfn_tpu_torch.harness.statistics import (default_checkpoint, fetch_checkpoint,
                                               save_checkpoint)
from mmfn_tpu_torch.harness.weather import preset_from_params


@dataclass
class RouteConfig:
    route_id: str
    town: str
    trajectory: List[Tuple[float, float, float]]  # (x, y, z) keypoints
    index: int = 0
    scenarios: list = field(default_factory=list)
    # per-route weather preset from the route's <weather> element(s)
    # (route_parser.py:62-110 reads raw carla.WeatherParameters fields;
    # here they quantize onto the preset table) — None = no element,
    # the caller's global weather config applies
    weather: Optional[str] = None


def parse_routes_file(path: str, single_route: str = None) -> List[RouteConfig]:
    configs = []
    tree = ET.parse(path)
    for route in tree.iter("route"):
        route_id = route.attrib["id"]
        if single_route is not None and route_id != single_route:
            continue
        waypoints = [
            (float(w.attrib["x"]), float(w.attrib["y"]), float(w.attrib.get("z", 0.0)))
            for w in route.iter("waypoint")]
        weather = None
        # the reference merges attributes across ALL <weather> elements of a
        # route, later elements overriding (RouteParser.parse_weather iterates
        # route.iter('weather'), route_parser.py:62-110)
        attrs = {}
        saw_element = False
        for weather_el in route.iter("weather"):
            saw_element = True
            attrs.update({k: float(weather_el.attrib[k])
                          for k in ("cloudiness", "precipitation",
                                    "precipitation_deposits", "wetness",
                                    "sun_altitude_angle")
                          if k in weather_el.attrib})
        if saw_element:
            # element PRESENCE is the override: the reference builds a
            # zero-initialized carla.WeatherParameters() when any <weather>
            # exists (route_parser.py:93-94) — unset attributes are 0.0,
            # which puts the sun at the horizon (Sunset suffix), NOT the
            # quantizer's no-element noon default
            for key in ("cloudiness", "precipitation",
                        "precipitation_deposits", "wetness",
                        "sun_altitude_angle"):
                attrs.setdefault(key, 0.0)
            weather = preset_from_params(**attrs)
        configs.append(RouteConfig(route_id=route_id, town=route.attrib["town"],
                                   trajectory=waypoints, weather=weather))
    for i, c in enumerate(configs):
        c.index = i
    return configs


def route_length(trajectory: Sequence[Tuple[float, float, float]]) -> float:
    total = 0.0
    for a, b in zip(trajectory[:-1], trajectory[1:]):
        total += math.dist(a, b)
    return total


def downsample_route(route: Sequence[Tuple[Tuple[float, float], RoadOption]],
                     sample_factor: float) -> List[int]:
    """route: [((x, y), RoadOption), ...] dense (1 m) plan -> kept indices."""
    ids_to_sample = []
    prev_option = None
    dist = 0.0
    for i, (pos, option) in enumerate(route):
        if option in (RoadOption.CHANGELANELEFT, RoadOption.CHANGELANERIGHT):
            ids_to_sample.append(i)
            dist = 0.0
        elif prev_option != option and prev_option not in (
                RoadOption.CHANGELANELEFT, RoadOption.CHANGELANERIGHT):
            ids_to_sample.append(i)
            dist = 0.0
        elif dist > sample_factor:
            ids_to_sample.append(i)
            dist = 0.0
        elif i == len(route) - 1:
            ids_to_sample.append(i)
            dist = 0.0
        else:
            prev = route[i - 1][0]
            dist += math.hypot(pos[0] - prev[0], pos[1] - prev[1])
        prev_option = option
    return ids_to_sample


def interpolate_trajectory(keypoints: Sequence[Tuple[float, float, float]],
                           hop_resolution: float = 1.0
                           ) -> List[Tuple[Tuple[float, float], RoadOption]]:
    """Densify route keypoints to ~hop_resolution spacing.

    The reference uses CARLA's GlobalRoutePlanner over the road graph
    (route_manipulation.py:132); without a simulator we interpolate linearly,
    which matches on straight segments and is the best map-free approximation.
    """
    dense: List[Tuple[Tuple[float, float], RoadOption]] = []
    for a, b in zip(keypoints[:-1], keypoints[1:]):
        seg = math.dist(a[:2], b[:2])
        n = max(1, int(seg / hop_resolution))
        for k in range(n):
            t = k / n
            pos = (a[0] + t * (b[0] - a[0]), a[1] + t * (b[1] - a[1]))
            dense.append((pos, RoadOption.LANEFOLLOW))
    dense.append(((keypoints[-1][0], keypoints[-1][1]), RoadOption.LANEFOLLOW))
    return dense


def offset_route_start(trajectory: Sequence[Tuple[float, float, float]],
                       lateral: float) -> List[Tuple[float, float, float]]:
    """Shift the first keypoint laterally (left-positive along the initial
    heading): the expert starts off-lane and its PID corrects back, recording
    recovery demonstrations — the classic behavior-cloning covariate-shift
    fix (the reference gets the same effect from steering dither +
    weather/traffic variation over long runs; see README's demo results:
    without recovery passes the cloned policy deviates)."""
    if not lateral or len(trajectory) < 2:
        return list(trajectory)
    (x0, y0, z0), (x1, y1, _) = trajectory[0], trajectory[1]
    yaw = math.atan2(y1 - y0, x1 - x0)
    return [(x0 - math.sin(yaw) * lateral, y0 + math.cos(yaw) * lateral, z0)] \
        + list(trajectory[1:])


def collect_offset_for(repetition: int, magnitude: float = 0.9) -> float:
    """The demo's alternating-and-growing recovery-offset schedule: rep 0
    drives on-lane; later reps start ±magnitude, ±1.5*magnitude, ..."""
    if repetition <= 0:
        return 0.0
    side = magnitude if repetition % 2 else -magnitude
    return side * (1.0 + 0.5 * ((repetition - 1) // 2))


class RouteIndexer:
    """Iterates route configs with checkpoint resume (route_indexer.py:13-71)."""

    def __init__(self, routes_file: str, repetitions: int = 1):
        self._configs = self._expand(parse_routes_file(routes_file), repetitions)
        self._index = 0

    @classmethod
    def from_configs(cls, configs: Sequence["RouteConfig"],
                     repetitions: int = 1) -> "RouteIndexer":
        """Build an indexer from in-memory configs (e.g. a route derived from
        an OpenSCENARIO file) instead of a routes XML."""
        out = cls.__new__(cls)
        out._configs = cls._expand(configs, repetitions)
        out._index = 0
        return out

    @staticmethod
    def _expand(base: Sequence["RouteConfig"],
                repetitions: int) -> List["RouteConfig"]:
        configs = [
            RouteConfig(route_id=c.route_id, town=c.town,
                        trajectory=list(c.trajectory),
                        scenarios=list(c.scenarios), weather=c.weather)
            for _ in range(repetitions) for c in base]
        for i, c in enumerate(configs):
            c.index = i
        return configs

    def __len__(self) -> int:
        return len(self._configs)

    @property
    def total(self) -> int:
        return len(self._configs)

    def peek(self) -> bool:
        return self._index < len(self._configs)

    def next(self) -> RouteConfig:
        config = self._configs[self._index]
        self._index += 1
        return config

    def resume(self, endpoint: str) -> None:
        data = fetch_checkpoint(endpoint)
        if data:
            progress = data.get("_checkpoint", {}).get("progress", [])
            if progress:
                self._index = min(progress[0], len(self._configs))

    def save_state(self, endpoint: str) -> None:
        data = fetch_checkpoint(endpoint) or default_checkpoint()
        data["_checkpoint"]["progress"] = [self._index, len(self._configs)]
        save_checkpoint(endpoint, data)
