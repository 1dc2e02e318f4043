"""Road options and route downsampling.

The port's own copies of the JAX package's ``RoadOption``
(``harness/events.py``) and ``downsample_route`` (``harness/route.py``),
after route_manipulation.py:86-129: keep waypoints at lane changes, at
road-option transitions, every ``sample_factor`` meters, and at the end.
"""

from __future__ import annotations

import math
from enum import IntEnum
from typing import List, Sequence, Tuple


class RoadOption(IntEnum):
    """High-level navigation command (carla agents' RoadOption values)."""
    VOID = -1
    LEFT = 1
    RIGHT = 2
    STRAIGHT = 3
    LANEFOLLOW = 4
    CHANGELANELEFT = 5
    CHANGELANERIGHT = 6


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
