"""Route criteria — simulator-independent infraction/compleition detectors.

Event-emitting equivalents of the py_trees criteria RouteScenario assembles
(leaderboard route_scenario.py:526-561 / srunner atomic_criteria.py):
RouteCompletion, AgentBlocked (<0.1 m/s for 180 s), RouteDeviation (30 m),
RunningRedLight / RunningStop against the fake world's signal model
(harness/traffic.py), and the route timeout (0.8 s/m + 5 s,
route_scenario.py:51-52,260-272). Collision criteria require actor ground
truth and live with the scenario engine / CARLA glue; the scoring layer
consumes whatever events exist.

The port's own copy of the JAX package's ``harness/criteria.py``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mmfn_tpu_torch.harness.events import TrafficEvent, TrafficEventType


class Criterion:
    def __init__(self):
        self.events: List[TrafficEvent] = []

    def update(self, position: Tuple[float, float], speed: float, game_time: float) -> None:
        raise NotImplementedError

    def terminate(self) -> None:
        pass


class RouteCompletionCriterion(Criterion):
    """Tracks progress along the dense route polyline (atomic_criteria.py:1587).

    DISTANCE_THRESHOLD controls snapping to the route; completion is the
    arclength fraction of the furthest reached waypoint.
    """

    DISTANCE_THRESHOLD = 10.0
    TERMINATION_THRESHOLD = 15.0  # distance to goal that counts as arrival

    def __init__(self, route_xy: Sequence[Tuple[float, float]]):
        super().__init__()
        self.route = np.asarray(route_xy, dtype=np.float64)
        seg = np.linalg.norm(np.diff(self.route, axis=0), axis=1)
        self.cumdist = np.concatenate([[0.0], np.cumsum(seg)])
        self.total = max(self.cumdist[-1], 1e-9)
        self._index = 0
        self._percent = 0.0
        self._completed = False
        self._window = 50  # waypoints ahead to scan, mirrors WINDOWS_SIZE

    @property
    def percent(self) -> float:
        return self._percent

    @property
    def completed(self) -> bool:
        return self._completed

    def update(self, position, speed, game_time) -> None:
        if self._completed:
            return
        pos = np.asarray(position, dtype=np.float64)
        end = min(self._index + self._window, len(self.route))
        seg = self.route[self._index:end] - pos
        d2 = np.einsum("ij,ij->i", seg, seg)     # squared: no sqrt needed
        near = np.nonzero(d2 < self.DISTANCE_THRESHOLD ** 2)[0]
        if near.size:
            self._index += int(near[-1])
            self._percent = 100.0 * self.cumdist[self._index] / self.total
        end_d = math.hypot(self.route[-1][0] - pos[0],
                           self.route[-1][1] - pos[1])
        if (end_d < self.TERMINATION_THRESHOLD
                and self._percent > 99.0) or self._percent >= 99.5:
            self._completed = True
            self.events.append(TrafficEvent(TrafficEventType.ROUTE_COMPLETED,
                                            "Destination was successfully reached"))

    def terminate(self) -> None:
        if not self._completed:
            event = TrafficEvent(TrafficEventType.ROUTE_COMPLETION)
            event.set_dict({"route_completed": round(self._percent, 2)})
            event.set_message(f"Agent completed {self._percent:.2f}% of the route")
            self.events.append(event)


class AgentBlockedCriterion(Criterion):
    """Speed < SPEED_THRESHOLD sustained BLOCKED_SECONDS -> VEHICLE_BLOCKED
    (route_scenario.py:547-551)."""

    SPEED_THRESHOLD = 0.1
    BLOCKED_SECONDS = 180.0

    def __init__(self):
        super().__init__()
        self._below_since: Optional[float] = None
        self.triggered = False

    def update(self, position, speed, game_time) -> None:
        if self.triggered:
            return
        if speed < self.SPEED_THRESHOLD:
            if self._below_since is None:
                self._below_since = game_time
            elif game_time - self._below_since > self.BLOCKED_SECONDS:
                self.triggered = True
                self.events.append(TrafficEvent(
                    TrafficEventType.VEHICLE_BLOCKED,
                    f"Agent got blocked at ({position[0]:.2f}, {position[1]:.2f})"))
        else:
            self._below_since = None


class RouteDeviationCriterion(Criterion):
    """Off-route beyond MAX_ROUTE_PERCENTAGE-style deviation (simplified to a
    fixed 30 m corridor, matching InRouteTest's wrong-distance gate)."""

    MAX_DISTANCE = 30.0

    def __init__(self, route_xy: Sequence[Tuple[float, float]]):
        super().__init__()
        self.route = np.asarray(route_xy, dtype=np.float64)
        self.triggered = False
        self._idx = 0       # last nearest route index (motion is continuous)
        self._window = 50

    def update(self, position, speed, game_time) -> None:
        if self.triggered:
            return
        pos = np.asarray(position, dtype=np.float64)
        # windowed scan around the last nearest point first — the full-route
        # distance field every tick was the single largest criteria cost in
        # the fleet host profile (scripts/_fleet_profile.py). The full scan
        # only runs as a fallback before TRIGGERING, so the decision is
        # identical to the all-points test (looping routes whose tail passes
        # near the ego still count).
        lo = max(0, self._idx - 10)
        seg = self.route[lo:self._idx + self._window] - pos
        d2 = np.einsum("ij,ij->i", seg, seg)
        j = int(np.argmin(d2))
        if d2[j] <= self.MAX_DISTANCE ** 2:
            self._idx = lo + j
            return
        full = self.route - pos
        d2f = np.einsum("ij,ij->i", full, full)
        j = int(np.argmin(d2f))
        if d2f[j] <= self.MAX_DISTANCE ** 2:
            self._idx = j
            return
        self.triggered = True
        self.events.append(TrafficEvent(
            TrafficEventType.ROUTE_DEVIATION,
            f"Agent deviated from the route at ({pos[0]:.2f}, {pos[1]:.2f})"))


def subdivide_lane_ribbon(lane_polylines: Sequence[np.ndarray],
                          lane_widths: Optional[Sequence] = None,
                          default_half_width: float = 1.75
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten lane centerlines into ~1 m-spaced sample points with a
    per-point half width (interpolated along each segment). Lane membership
    of a position is then ``min(|points - pos| - halfw) <= margin`` — shared
    by OutsideRouteLanesCriterion and the OpenSCENARIO Offroad/EndOfRoad
    conditions."""
    pts = []
    halfw = []
    for li, poly in enumerate(lane_polylines):
        poly = np.asarray(poly, dtype=np.float64)[:, :2]
        w = None if lane_widths is None else lane_widths[li]
        hw = (np.full(len(poly), default_half_width) if w is None
              else np.asarray(w, dtype=np.float64) / 2.0)
        if len(poly) < 2:
            if len(poly):
                pts.append(poly)
                halfw.append(hw[:1])
            continue
        for k, (a, b) in enumerate(zip(poly[:-1], poly[1:])):
            n = max(1, int(np.linalg.norm(b - a)))
            frac = np.linspace(0, 1, n, endpoint=False)
            pts.append(a + (b - a) * frac[:, None])
            halfw.append(hw[k] + (hw[k + 1] - hw[k]) * frac)
    return (np.concatenate(pts, axis=0) if pts else np.zeros((0, 2)),
            np.concatenate(halfw) if halfw else np.zeros((0,)))


class OutsideRouteLanesCriterion(Criterion):
    """Percentage of driven distance spent outside any drivable lane
    (atomic_criteria.py OutsideRouteLanesTest semantics: the composed score is
    discounted by (1 - percentage/100)).

    Lane membership is distance-to-centerline over the vectorized map's
    polylines against each lane's OWN half width (the rmap v2 width column;
    OpenDRIVE lanes are variable-width) plus a margin — pass ``lane_widths``
    aligned with ``lane_polylines``; lanes without widths fall back to the
    3.5 m default.
    """

    DEFAULT_HALF_WIDTH = 1.75
    MARGIN = 0.6              # bbox margin tolerance

    def __init__(self, lane_polylines: Sequence[np.ndarray],
                 lane_widths: Optional[Sequence] = None):
        super().__init__()
        self._points, self._halfw = subdivide_lane_ribbon(
            lane_polylines, lane_widths,
            default_half_width=self.DEFAULT_HALF_WIDTH)
        self._outside_m = 0.0
        self._driven_m = 0.0
        self._last: Optional[np.ndarray] = None

    def update(self, position, speed, game_time) -> None:
        pos = np.asarray(position, dtype=np.float64)
        if self._last is not None:
            step = float(np.linalg.norm(pos - self._last))
            self._driven_m += step
            if self._points.shape[0] and step > 0:
                slack = np.linalg.norm(self._points - pos, axis=1) - self._halfw
                if float(np.min(slack)) > self.MARGIN:
                    self._outside_m += step
        self._last = pos

    @property
    def percentage(self) -> float:
        if self._driven_m <= 0:
            return 0.0
        return 100.0 * self._outside_m / self._driven_m

    def terminate(self) -> None:
        if self._outside_m > 0:
            event = TrafficEvent(TrafficEventType.OUTSIDE_ROUTE_LANES_INFRACTION)
            event.set_dict({"percentage": round(self.percentage, 2)})
            event.set_message(
                f"Agent went outside its route lanes for about "
                f"{self._outside_m:.3f} meters ({self.percentage:.2f}% of the route)")
            self.events.append(event)


class RunningRedLightCriterion(Criterion):
    """Crossing a signal's stop line while its state is red
    (atomic_criteria.py RunningRedLightTest:1690 semantics — the reference
    checks the ego's track against the light's trigger-volume stop line)."""

    def __init__(self, lights):
        super().__init__()
        self.lights = list(lights)
        self._last = None
        self._done = set()

    def update(self, position, speed, game_time) -> None:
        pos = np.asarray(position, dtype=np.float64)
        if self._last is not None:
            for li in self.lights:
                if li.light_id in self._done:
                    continue
                if li.state(game_time) == "red" and li.crossed(self._last, pos):
                    self._done.add(li.light_id)
                    event = TrafficEvent(TrafficEventType.TRAFFIC_LIGHT_INFRACTION)
                    event.set_dict({"id": li.light_id,
                                    "x": float(li.position[0]),
                                    "y": float(li.position[1])})
                    event.set_message(
                        f"Agent ran a red light {li.light_id} at "
                        f"({li.position[0]:.2f}, {li.position[1]:.2f})")
                    self.events.append(event)
        self._last = pos


class RunningStopCriterion(Criterion):
    """Leaving a stop sign's zone without the speed ever dropping below the
    stop threshold (atomic_criteria.py RunningStopTest:1877 semantics)."""

    EXIT_HYSTERESIS = 1.0  # meters beyond the zone before judging

    def __init__(self, stop_signs):
        super().__init__()
        self.signs = list(stop_signs)
        self._entered = set()
        self._served = set()
        self._done = set()

    def _infraction(self, sign) -> None:
        self._done.add(sign.stop_id)
        event = TrafficEvent(TrafficEventType.STOP_INFRACTION)
        event.set_dict({"id": sign.stop_id,
                        "x": float(sign.position[0]),
                        "y": float(sign.position[1])})
        event.set_message(
            f"Agent ran a stop sign {sign.stop_id} at "
            f"({sign.position[0]:.2f}, {sign.position[1]:.2f})")
        self.events.append(event)

    def update(self, position, speed, game_time) -> None:
        pos = np.asarray(position, dtype=np.float64)
        for sign in self.signs:
            if sign.stop_id in self._done:
                continue
            d = float(np.linalg.norm(pos - sign.position))
            if d < sign.ZONE_RADIUS:
                self._entered.add(sign.stop_id)
                if speed < sign.SPEED_THRESHOLD:
                    self._served.add(sign.stop_id)
            elif (sign.stop_id in self._entered
                  and d > sign.ZONE_RADIUS + self.EXIT_HYSTERESIS):
                if sign.stop_id not in self._served:
                    self._infraction(sign)
                self._done.add(sign.stop_id)


def route_timeout_seconds(route_length_m: float) -> float:
    """0.8 s per route meter + 5 s (route_scenario.py:51-52,272)."""
    return 0.8 * route_length_m + 5.0
