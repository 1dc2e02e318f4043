"""Trivial agents for exercising the harness without a model
(leaderboard/leaderboard/autoagents/{dummy_agent,npc_agent}.py analogs).

The port's own copies of the JAX package's ``NpcAgent`` and ``DummyAgent``
(``harness/agents/trivial.py``).
"""

from __future__ import annotations

import math

import numpy as np

from mmfn_tpu_torch.harness.agents.base import AutonomousAgent, Track, VehicleControl


class DummyAgent(AutonomousAgent):
    """Full sensor suite, constant idle control — validates sensor plumbing."""

    def setup(self, conf) -> None:
        self.track = Track.SENSORS

    def sensors(self):
        return [
            {"type": "sensor.camera.rgb", "x": 0.7, "y": 0.0, "z": 1.6,
             "roll": 0.0, "pitch": 0.0, "yaw": 0.0,
             "width": 300, "height": 200, "fov": 100, "id": "Center"},
            {"type": "sensor.lidar.ray_cast", "x": 0.7, "y": -0.4, "z": 1.6,
             "roll": 0.0, "pitch": 0.0, "yaw": -45.0, "id": "LIDAR"},
            {"type": "sensor.other.gnss", "x": 0.7, "y": -0.4, "z": 1.6, "id": "GPS"},
            {"type": "sensor.speedometer", "reading_frequency": 25, "id": "speed"},
        ]

    def run_step(self, input_data, timestamp) -> VehicleControl:
        return VehicleControl(throttle=0.0, steer=0.0, brake=0.0)


class NpcAgent(AutonomousAgent):
    """Follows its route with a simple P-controller at a fixed cruise speed —
    the harness's model-free agent (npc_agent.py uses CARLA's BasicAgent; this
    version is simulator-free and used as the fake-world reference agent)."""

    CRUISE_SPEED = 7.0

    def setup(self, conf) -> None:
        self.track = Track.SENSORS
        self._planner = None

    def sensors(self):
        return [
            {"type": "sensor.other.gnss", "x": 0.0, "y": 0.0, "z": 0.0, "id": "gps"},
            {"type": "sensor.other.imu", "x": 0.0, "y": 0.0, "z": 0.0, "id": "imu"},
            {"type": "sensor.speedometer", "reading_frequency": 20, "id": "speed"},
        ]

    def run_step(self, input_data, timestamp) -> VehicleControl:
        from mmfn_tpu_torch.control.planner import GPS_SCALE, RoutePlanner

        if self._planner is None:
            self._planner = RoutePlanner(4.0, 50.0)
            self._planner.set_route(self._global_plan, gps=True)
        gps = input_data["gps"][1]
        pos = np.array([gps[0], gps[1]]) * GPS_SCALE
        yaw = input_data["imu"][1][-1]
        speed = input_data["speed"][1]["speed"]
        target, _ = self._planner.run_step(pos)
        desired = math.atan2(target[1] - pos[1], target[0] - pos[0])
        err = (desired - yaw + math.pi) % (2 * math.pi) - math.pi
        return VehicleControl(
            steer=float(np.clip(err, -1.0, 1.0)),
            throttle=0.7 if speed < self.CRUISE_SPEED else 0.0)
