"""Waypoint-following PID control (host-side, 20 Hz scalar state).

The port's own copy of the JAX package's ``control/pid.py``, after the
reference's windowed PID (model_img.py:426-448) and ``MMFN.control_pid``
(model_img.py:509-550). It runs per tick on scalars with deque state, so it
stays on the host; only the waypoints cross from the device.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Tuple

import numpy as np

from mmfn_tpu_torch.config import GlobalConfig


class PIDController:
    """P + I (window mean) + D (last difference) over a fixed-length
    window, its mean kept as a running sum."""

    def __init__(self, k_p: float = 1.0, k_i: float = 0.0, k_d: float = 0.0, n: int = 20):
        self.k_p, self.k_i, self.k_d = k_p, k_i, k_d
        self._window = deque([0.0] * n, maxlen=n)   # always full
        self._sum = 0.0

    def step(self, error: float) -> float:
        w = self._window
        if w:
            self._sum += error - w[0]   # evicted by the append below
            w.append(error)
        if len(w) >= 2:
            integral = self._sum / len(w)
            derivative = w[-1] - w[-2]
        else:
            integral = derivative = 0.0  # degenerate window: P-only
        return self.k_p * error + self.k_i * integral + self.k_d * derivative

    def reset(self) -> None:
        self._window.extend([0.0] * self._window.maxlen)
        self._sum = 0.0


class WaypointController:
    """Predicted waypoints + current speed -> steer, throttle, brake, as
    ``MMFN.control_pid``: desired speed from the first segment's length x2;
    steering from the angle to the midpoint of the first two waypoints;
    brake when (nearly) stopped or overspeeding."""

    def __init__(self, config: GlobalConfig):
        self.config = config
        self.turn_controller = PIDController(config.turn_KP, config.turn_KI,
                                             config.turn_KD, config.turn_n)
        self.speed_controller = PIDController(config.speed_KP, config.speed_KI,
                                              config.speed_KD, config.speed_n)

    def control_pid(self, waypoints: np.ndarray, speed: float) -> Tuple[float, float, bool, dict]:
        """waypoints: (pred_len, 2) in the ego frame (y forward-negative); speed m/s."""
        cfg = self.config
        waypoints = np.asarray(waypoints)
        # the y-flip mirrors the model's forward-negative output space
        w0x, w0y = float(waypoints[0][0]), -float(waypoints[0][1])
        w1x, w1y = float(waypoints[1][0]), -float(waypoints[1][1])
        speed = float(speed)

        desired_speed = math.hypot(w0x - w1x, w0y - w1y) * 2.0
        if desired_speed > 0.0:
            brake = (desired_speed < cfg.brake_speed
                     or (speed / desired_speed) > cfg.brake_ratio)
        else:
            brake = True    # coincident waypoints: full stop requested

        aim = ((w0x + w1x) / 2.0, (w0y + w1y) / 2.0)
        angle = math.degrees(math.pi / 2 - math.atan2(aim[1], aim[0])) / 90.0
        if speed < 0.01:
            angle = 0.0  # don't accumulate integral error while stopped
        steer = min(1.0, max(-1.0, self.turn_controller.step(angle)))

        delta = min(float(cfg.clip_delta), max(0.0, desired_speed - speed))
        throttle = min(float(cfg.max_throttle),
                       max(0.0, self.speed_controller.step(delta)))
        throttle = 0.0 if brake else throttle

        metadata = {
            "speed": speed, "steer": steer, "throttle": throttle, "brake": bool(brake),
            "wp_2": (w1x, w1y), "wp_1": (w0x, w0y),
            "desired_speed": desired_speed, "angle": angle,
            "aim": aim, "delta": delta,
        }
        return steer, throttle, bool(brake), metadata
