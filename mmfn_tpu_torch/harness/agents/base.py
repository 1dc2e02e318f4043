"""Agent contract (leaderboard/leaderboard/autoagents/autonomous_agent.py:29-126).

The port's own copy of the JAX package's ``harness/agents/base.py``. Agents
implement setup/sensors/run_step/destroy; ``__call__`` drains the sensor mux
and invokes run_step. ``set_global_plan`` stores the route downsampled to
~50 m hops. Controls are a simulator-neutral dataclass.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Optional

from mmfn_tpu_torch.harness.route import downsample_route
from mmfn_tpu_torch.harness.sensor_interface import SensorInterface


@dataclass
class VehicleControl:
    steer: float = 0.0
    throttle: float = 0.0
    brake: float = 0.0
    hand_brake: bool = False
    reverse: bool = False


class Track(Enum):
    SENSORS = "SENSORS"
    MAP = "MAP"


class AutonomousAgent:
    def __init__(self, path_to_conf_file: Optional[str] = None):
        self.track = Track.SENSORS
        self._global_plan = None
        self._global_plan_world_coord = None
        self.sensor_interface = SensorInterface()
        self.wallclock_t0 = None
        self.setup(path_to_conf_file)

    # ---- to implement ------------------------------------------------------ #

    def setup(self, path_to_conf_file: Optional[str]) -> None:
        pass

    def sensors(self) -> List[dict]:
        """Sensor suite spec (same dict schema as the reference)."""
        return []

    def run_step(self, input_data: dict, timestamp: float) -> VehicleControl:
        raise NotImplementedError

    def destroy(self) -> None:
        pass

    # ---- harness side ------------------------------------------------------ #

    def __call__(self, timestamp: float) -> VehicleControl:
        input_data = self.sensor_interface.get_data()
        return self.run_step(input_data, timestamp)

    def set_global_plan(self, global_plan_gps, global_plan_world_coord) -> None:
        """Downsample the dense (1 m) route to ~50 m hops
        (autonomous_agent.py:120-126); the dense plans are kept too."""
        self._global_plan_dense = list(global_plan_gps)
        self._global_plan_world_coord_dense = list(global_plan_world_coord)
        ds_ids = downsample_route(global_plan_world_coord, 50)
        self._global_plan_world_coord = [
            (global_plan_world_coord[x][0], global_plan_world_coord[x][1])
            for x in ds_ids]
        self._global_plan = [global_plan_gps[x] for x in ds_ids]
