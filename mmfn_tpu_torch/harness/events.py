"""Traffic events and road options.

Mirrors srunner/scenariomanager/traffic_events.py:13-84 and the agents'
RoadOption enum — the vocabulary shared by criteria, scoring, and planners.

The port's own copy of the JAX package's ``harness/events.py``; the one
``RoadOption`` of the port (``harness/route.py`` re-exports it).
"""

from __future__ import annotations

from enum import Enum, IntEnum
from typing import Optional


class TrafficEventType(Enum):
    NORMAL_DRIVING = 0
    COLLISION_STATIC = 1
    COLLISION_VEHICLE = 2
    COLLISION_PEDESTRIAN = 3
    ROUTE_DEVIATION = 4
    ROUTE_COMPLETION = 5
    ROUTE_COMPLETED = 6
    TRAFFIC_LIGHT_INFRACTION = 7
    WRONG_WAY_INFRACTION = 8
    ON_SIDEWALK_INFRACTION = 9
    STOP_INFRACTION = 10
    OUTSIDE_LANE_INFRACTION = 11
    OUTSIDE_ROUTE_LANES_INFRACTION = 12
    VEHICLE_BLOCKED = 13


class RoadOption(IntEnum):
    """High-level navigation command (carla agents' RoadOption values)."""
    VOID = -1
    LEFT = 1
    RIGHT = 2
    STRAIGHT = 3
    LANEFOLLOW = 4
    CHANGELANELEFT = 5
    CHANGELANERIGHT = 6


class TrafficEvent:
    def __init__(self, event_type: TrafficEventType,
                 message: str = "", dictionary: Optional[dict] = None):
        self._type = event_type
        self._message = message
        self._dict = dictionary

    def get_type(self) -> TrafficEventType:
        return self._type

    def get_message(self) -> str:
        return self._message

    def set_message(self, message: str) -> None:
        self._message = message

    def get_dict(self) -> Optional[dict]:
        return self._dict

    def set_dict(self, dictionary: dict) -> None:
        self._dict = dictionary
