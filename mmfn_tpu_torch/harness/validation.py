"""Sensor-suite validation against track rules.

Simulator-independent port of AgentWrapper.validate_sensor_configuration
(leaderboard/leaderboard/autoagents/agent_wrapper.py:23-33,177-226): the MAP
track allows the opendrive pseudo-sensor, SENSORS forbids it; per-type count
limits; extrinsics must stay within a 3 m radius of the ego origin. The port's own
copy of the JAX package's ``harness/validation.py``, over the port's
``Track`` and ``SensorConfigurationInvalid``.
"""

from __future__ import annotations

import math
from typing import List

from mmfn_tpu_torch.harness.agents.base import Track
from mmfn_tpu_torch.harness.sensor_interface import SensorConfigurationInvalid

MAX_ALLOWED_RADIUS_SENSOR = 3.0

SENSORS_LIMITS = {
    "sensor.camera.rgb": 4,
    "sensor.lidar.ray_cast": 1,
    "sensor.other.radar": 2,
    "sensor.other.gnss": 1,
    "sensor.other.imu": 1,
    "sensor.opendrive_map": 1,
    "sensor.speedometer": 1,
}

ALLOWED_SENSORS = (
    "sensor.opendrive_map", "sensor.speedometer", "sensor.camera.rgb",
    "sensor.camera", "sensor.lidar.ray_cast", "sensor.other.radar",
    "sensor.other.gnss", "sensor.other.imu",
)


def validate_sensor_configuration(sensors: List[dict], track: Track,
                                  selected_track: Track) -> None:
    """Raises SensorConfigurationInvalid on any rule violation."""
    if track != selected_track:
        raise SensorConfigurationInvalid(
            f"You are submitting to the wrong track [{selected_track}]!")

    sensor_count = {}
    sensor_ids = []
    for sensor in sensors:
        sensor_id, sensor_type = sensor["id"], sensor["type"]

        if sensor_id in sensor_ids:
            raise SensorConfigurationInvalid(
                f"Duplicated sensor tag [{sensor_id}]")
        sensor_ids.append(sensor_id)

        if track == Track.SENSORS and sensor_type.startswith("sensor.opendrive_map"):
            raise SensorConfigurationInvalid(
                "Illegal sensor used for Track [{}]!".format(track))

        if sensor_type not in ALLOWED_SENSORS:
            raise SensorConfigurationInvalid(
                f"Illegal sensor used. {sensor_type} are not allowed!")

        if sensor_type not in ("sensor.opendrive_map", "sensor.speedometer"):
            radius = math.sqrt(sensor.get("x", 0.0) ** 2 + sensor.get("y", 0.0) ** 2
                               + sensor.get("z", 0.0) ** 2)
            if radius > MAX_ALLOWED_RADIUS_SENSOR:
                raise SensorConfigurationInvalid(
                    f"Illegal sensor extrinsics used for Sensor [{sensor_id}]; "
                    f"radius {radius:.2f} > {MAX_ALLOWED_RADIUS_SENSOR}")

        sensor_count[sensor_type] = sensor_count.get(sensor_type, 0) + 1

    for sensor_type, count in sensor_count.items():
        if count > SENSORS_LIMITS.get(sensor_type, 0):
            raise SensorConfigurationInvalid(
                f"Too many sensors of type {sensor_type} "
                f"({count} > {SENSORS_LIMITS.get(sensor_type, 0)})")
