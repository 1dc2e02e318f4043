"""Privileged world access for rule-based experts.

The reference experts read the CARLA world directly (MapAgent/CarlaDataProvider,
team_code/expert_agent/common/map_agent.py:38-76). Here that access is behind a
small data protocol so the expert's decision logic is simulator-independent
and unit-testable. The fake world's runner fills it from its privileged
channel; tests fill it by hand.

The port's own copy of the JAX package's ``harness/experts/world_view.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class Actor:
    position: np.ndarray            # (2,) world meters
    velocity: np.ndarray            # (2,) m/s
    yaw: float = 0.0                # radians, world frame
    extent: float = 1.5             # bounding radius, meters
    lane_id: int = 0
    in_junction: bool = False
    actor_id: int = 0


@dataclass
class EgoState:
    position: np.ndarray
    velocity: np.ndarray
    yaw: float = 0.0                # radians
    lane_id: int = 0
    in_junction: bool = False

    @property
    def speed(self) -> float:
        return float(np.linalg.norm(self.velocity))


@dataclass
class WorldView:
    """One tick's privileged snapshot within the expert's sensing radius."""

    ego: EgoState
    vehicles: List[Actor] = field(default_factory=list)
    walkers: List[Actor] = field(default_factory=list)
    red_light: bool = False          # a red/yellow light currently gates the ego
    stop_sign: bool = False          # an un-served stop sign gates the ego
    car_in_front: Optional[Actor] = None
    cars_behind: List[Actor] = field(default_factory=list)
    # route requires a lane change (the planner targets sit on another lane);
    # change_lane_ids = the lane ids the ego must cross into
    # (mmfn_pilot.py:_is_change_lane route/lane-id tests)
    lane_change_required: bool = False
    change_lane_ids: List[int] = field(default_factory=list)
