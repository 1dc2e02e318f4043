"""Traffic lights and stop signs for the simulator-free world.

The reference takes signal ground truth from CARLA: traffic-light actors with
trigger volumes feed the expert (team_code/expert_agent/common/map_agent.py:38-76)
and the RunningRedLightTest / RunningStopTest criteria
(srunner/scenariomanager/scenarioatomics/atomic_criteria.py:1690,1877) score
crossings. Without a simulator we model each signal as a stop line placed on
the route:

- ``TrafficLight`` cycles deterministically through green/yellow/red on game
  time; the ego "runs" it when its track crosses the stop line while the state
  is red.
- ``StopSign`` defines a zone around its line; the sign is served only if the
  ego's speed dropped below SPEED_THRESHOLD while inside the zone.

Both also answer ``gates(ego)`` — whether the signal currently obliges the ego
to brake — which the closed-loop runner publishes on the privileged channel so
rule-based experts see the same ground truth the CARLA glue provides
(world_view_from_carla).

The port's own copy of the JAX package's ``harness/traffic.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _unit(yaw: float) -> np.ndarray:
    return np.array([math.cos(yaw), math.sin(yaw)])


def _heading_aligned(ego_yaw: float, yaw: float, tol_deg: float = 60.0) -> bool:
    d = (math.degrees(ego_yaw - yaw) + 180.0) % 360.0 - 180.0
    return abs(d) < tol_deg


@dataclass
class TrafficLight:
    """A signalized stop line.

    ``position`` is the stop-line center (world meters), ``yaw`` the direction
    of travel it governs. The phase cycle starts at ``offset`` seconds into
    green (CARLA defaults are ~10 s green / 3 s yellow / 2 s red per leg; the
    exact split is configurable per light).
    """

    position: np.ndarray
    yaw: float
    green: float = 10.0
    yellow: float = 3.0
    red: float = 10.0
    offset: float = 0.0
    light_id: int = 0
    TRIGGER_DISTANCE: float = 16.0      # gating lookahead, meters
    LATERAL_HALF_WIDTH: float = 4.0     # stop-line half length, meters

    def __post_init__(self):
        self.position = np.asarray(self.position, dtype=np.float64)
        self.forced_green_until = -1.0  # fault removal: force_destory_actor's
        #                                 "set light green" analog (base_agent.py:273-289)
        # scenario override: TrafficLightStateSetter's carla
        # TrafficLight.set_state analog (atomic_behaviors.py:1902) — holds
        # any state until the deadline, then the cycle resumes
        self.forced_state = None
        self.forced_state_until = -1.0

    @property
    def cycle(self) -> float:
        return self.green + self.yellow + self.red

    def state(self, game_time: float) -> str:
        # fault removal outranks a scenario's forced state: a jammed ego must
        # be able to recover even from a TrafficLightStateSetter'd red
        if game_time < self.forced_green_until:
            return "green"
        if self.forced_state is not None \
                and game_time < self.forced_state_until:
            return self.forced_state
        if self.cycle <= 0.0:       # degenerate config: fail safe (always red)
            return "red"
        t = (game_time + self.offset) % self.cycle
        if t < self.green:
            return "green"
        if t < self.green + self.yellow:
            return "yellow"
        return "red"

    # ---- geometry -------------------------------------------------------- #

    def _along_lateral(self, xy: np.ndarray) -> Tuple[float, float]:
        """Signed (along-track, lateral) offsets of ``xy`` from the stop line."""
        rel = np.asarray(xy, dtype=np.float64) - self.position
        fwd = _unit(self.yaw)
        return float(rel @ fwd), float(rel @ np.array([-fwd[1], fwd[0]]))

    def crossed(self, prev_xy: np.ndarray, xy: np.ndarray) -> bool:
        """True when the segment prev->xy crosses the stop line in the
        governed direction within the line's lateral extent."""
        s0, _ = self._along_lateral(prev_xy)
        s1, lat = self._along_lateral(xy)
        return s0 < 0.0 <= s1 and abs(lat) < self.LATERAL_HALF_WIDTH

    def gates(self, ego_xy: np.ndarray, ego_yaw: float, game_time: float) -> bool:
        """The light is red/yellow and the ego is approaching its stop line
        (mirrors the expert's trigger-volume distance test, map_agent.py:38-76)."""
        if self.state(game_time) == "green":
            return False
        s, lat = self._along_lateral(ego_xy)
        return (-self.TRIGGER_DISTANCE < s < 0.5
                and abs(lat) < self.LATERAL_HALF_WIDTH
                and _heading_aligned(ego_yaw, self.yaw))


@dataclass
class StopSign:
    """An unsignalized stop line; served by a full stop inside its zone
    (RunningStopTest: speed < SPEED_THRESHOLD while affected,
    atomic_criteria.py:1877)."""

    position: np.ndarray
    yaw: float
    stop_id: int = 0
    TRIGGER_DISTANCE: float = 12.0
    # The serving zone covers the whole braking envelope from the gating
    # distance (the reference's trigger volumes are similarly generous — the
    # stop registers while the ego is "affected by" the sign).
    ZONE_RADIUS: float = 13.0
    SPEED_THRESHOLD: float = 0.1
    LATERAL_HALF_WIDTH: float = 4.0

    def __post_init__(self):
        self.position = np.asarray(self.position, dtype=np.float64)

    def _along_lateral(self, xy: np.ndarray) -> Tuple[float, float]:
        rel = np.asarray(xy, dtype=np.float64) - self.position
        fwd = _unit(self.yaw)
        return float(rel @ fwd), float(rel @ np.array([-fwd[1], fwd[0]]))

    def in_zone(self, xy: np.ndarray) -> bool:
        return bool(np.linalg.norm(np.asarray(xy, dtype=np.float64)
                                   - self.position) < self.ZONE_RADIUS)

    def gates(self, ego_xy: np.ndarray, ego_yaw: float) -> bool:
        """The ego is approaching the sign and has not passed its line yet."""
        s, lat = self._along_lateral(ego_xy)
        return (-self.TRIGGER_DISTANCE < s < 0.5
                and abs(lat) < self.LATERAL_HALF_WIDTH
                and _heading_aligned(ego_yaw, self.yaw))


@dataclass
class SignalSet:
    """All signals of one route plus the per-tick gating computation."""

    lights: List[TrafficLight] = field(default_factory=list)
    stop_signs: List[StopSign] = field(default_factory=list)

    def gating(self, ego_xy: np.ndarray, ego_yaw: float,
               game_time: float) -> Tuple[bool, bool]:
        red = any(li.gates(ego_xy, ego_yaw, game_time) for li in self.lights)
        stop = any(ss.gates(ego_xy, ego_yaw) for ss in self.stop_signs)
        return red, stop

    def light_states(self, game_time: float) -> List[Tuple[float, float, str]]:
        """[(x, y, state)] for rasterization."""
        return [(float(li.position[0]), float(li.position[1]),
                 li.state(game_time)) for li in self.lights]

    def force_green(self, game_time: float, duration: float = 10.0) -> None:
        """Fault removal: force every light green for ``duration`` seconds
        (the reference unsticks jammed egos this way, base_agent.py:273-289)."""
        for li in self.lights:
            li.forced_green_until = max(li.forced_green_until,
                                        game_time + duration)


def signals_from_rough_map(rough_map, route_xy: Sequence[Tuple[float, float]],
                           max_dist: float = 6.0,
                           min_spacing: float = 25.0) -> SignalSet:
    """Derive route traffic lights from the vectorized map.

    The .rmap node attribute ``traffic_control`` marks signal-controlled lane
    nodes (feature semantics documented at reference model_vec.py:370-377); we
    place one light where the route first enters a controlled stretch, oriented
    along the route, and dedupe by ``min_spacing``. Mirrors how the reference's
    expert discovers lights from trigger volumes along its plan."""
    route = np.asarray(route_xy, dtype=np.float64)
    controlled = []
    for lane in rough_map.lanes:
        nodes = np.asarray(lane.nodes, dtype=np.float64)
        if nodes.shape[1] >= 5:
            controlled.extend(nodes[nodes[:, 4] > 0.5, :2])
    signals = SignalSet()
    if not controlled or len(route) < 2:
        return signals
    controlled = np.asarray(controlled)
    placed: List[np.ndarray] = []
    was_controlled = True   # suppress a light at the very start of the route
    for i in range(len(route) - 1):
        p = route[i]
        is_controlled = bool(
            np.min(np.linalg.norm(controlled - p, axis=1)) <= max_dist)
        # rising edge only: the route entering a controlled stretch gets ONE
        # light at the entry point (OpenDRIVE signals apply road-wide, so the
        # vectorizer marks whole roads controlled; a light per node would
        # sprinkle the route with stop lines)
        if (not is_controlled or was_controlled
                or any(np.linalg.norm(p - q) < min_spacing for q in placed)):
            was_controlled = is_controlled
            continue
        was_controlled = True
        placed.append(p)
        d = route[i + 1] - p
        yaw = math.atan2(d[1], d[0])
        signals.lights.append(TrafficLight(
            position=p, yaw=yaw, light_id=len(signals.lights),
            offset=7.0 * len(signals.lights)))
    return signals
