"""Localization: GPS/IMU pose assembly + 9-state error-state EKF.

The port's own numpy copy of the JAX package's ``control/localization.py``
(no torch): the same float64 arithmetic in the same order, so both give the
same poses. Simulator-free port of the reference's pylot-derived localization stack
(team_code/expert_agent/common/{pylot_utils.py, utils.py:215-344}):

- Unreal-convention rotation math: Rotation(pitch, yaw, roll) in degrees;
  quaternion conversions match pylot's from_rotation/as_rotation exactly
  (including the UE-ordered quaternion product), so converted poses agree
  with the reference numerically.
- ``LocalizationOperator``: holds the latest pose; with ``use_ekf=True`` fuses
  IMU accelerometer/gyro (process model) with GNSS position (measurement) via
  the standard error-state EKF — the reference ships this filter but keeps it
  disabled (USE_EKF=False at call sites); here it is tested and usable.
- ``compass_to_yaw``: the reference's from_imu mapping (utils.py:154-165).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Rotation:
    """Degrees; applied roll(X) -> pitch(Y) -> yaw(Z), Unreal convention."""
    pitch: float = 0.0
    yaw: float = 0.0
    roll: float = 0.0

    def as_numpy_array(self) -> np.ndarray:
        return np.array([self.pitch, self.yaw, self.roll])


class Quaternion:
    def __init__(self, w: float, x: float, y: float, z: float):
        norm = np.linalg.norm([w, x, y, z])
        if norm < 1e-50:
            self.w = self.x = self.y = self.z = 0.0
        else:
            self.w, self.x, self.y, self.z = w / norm, x / norm, y / norm, z / norm

    @property
    def matrix(self) -> np.ndarray:
        """Body -> world rotation matrix."""
        w, x, y, z = self.w, self.x, self.y, self.z
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])

    @classmethod
    def from_rotation(cls, rotation: Rotation) -> "Quaternion":
        r2 = math.radians(rotation.roll) / 2.0
        p2 = math.radians(rotation.pitch) / 2.0
        y2 = math.radians(rotation.yaw) / 2.0
        cr, sr = math.cos(r2), math.sin(r2)
        cp, sp = math.cos(p2), math.sin(p2)
        cy, sy = math.cos(y2), math.sin(y2)
        return cls(
            cr * cp * cy + sr * sp * sy,
            cr * sp * sy - sr * cp * cy,
            -cr * sp * cy - sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        )

    @classmethod
    def from_angular_velocity(cls, omega: np.ndarray, dt: float) -> "Quaternion":
        rot_vec = np.asarray(omega, dtype=np.float64) * dt
        magnitude = np.linalg.norm(rot_vec)
        w = math.cos(magnitude / 2.0)
        if magnitude < 1e-50:
            return cls(w, 0.0, 0.0, 0.0)
        axis = rot_vec / magnitude * math.sin(magnitude / 2.0)
        return cls(w, axis[0], axis[1], axis[2])

    def as_rotation(self) -> Rotation:
        singularity = self.z * self.x - self.w * self.y
        yaw_y = 2.0 * (self.w * self.z + self.x * self.y)
        yaw_x = 1.0 - 2.0 * (self.y ** 2 + self.z ** 2)
        thresh = 0.4999995
        if singularity < -thresh:
            pitch = -90.0
            yaw = math.degrees(math.atan2(yaw_y, yaw_x))
            roll = -yaw - 2.0 * math.degrees(math.atan2(self.x, self.w))
        elif singularity > thresh:
            pitch = 90.0
            yaw = math.degrees(math.atan2(yaw_y, yaw_x))
            roll = yaw - 2.0 * math.degrees(math.atan2(self.x, self.w))
        else:
            pitch = math.degrees(math.asin(2.0 * singularity))
            yaw = math.degrees(math.atan2(yaw_y, yaw_x))
            roll = math.degrees(math.atan2(-2.0 * (self.w * self.x + self.y * self.z),
                                           1.0 - 2.0 * (self.x ** 2 + self.y ** 2)))
        return Rotation(pitch=pitch, yaw=yaw, roll=roll)

    def __mul__(self, other: "Quaternion") -> "Quaternion":
        # Unreal's XMQuaternionMultiply ordering (q2 = self, q1 = other).
        q1, q2 = other, self
        return Quaternion(
            (q2.w * q1.w) - (q2.x * q1.x) - (q2.y * q1.y) - (q2.z * q1.z),
            (q2.w * q1.x) + (q2.x * q1.w) + (q2.y * q1.z) - (q2.z * q1.y),
            (q2.w * q1.y) - (q2.x * q1.z) + (q2.y * q1.w) + (q2.z * q1.x),
            (q2.w * q1.z) + (q2.x * q1.y) - (q2.y * q1.x) + (q2.z * q1.w),
        )


@dataclass
class IMUReading:
    accelerometer: np.ndarray = field(default_factory=lambda: np.zeros(3))
    gyroscope: np.ndarray = field(default_factory=lambda: np.zeros(3))
    compass: float = 0.0
    timestamp: float = 0.0


@dataclass
class Pose:
    location: np.ndarray = field(default_factory=lambda: np.zeros(3))
    rotation: Rotation = field(default_factory=Rotation)
    velocity: np.ndarray = field(default_factory=lambda: np.zeros(3))


def compass_to_yaw(compass_rad: float, last_yaw: float = 0.0) -> float:
    """IMU compass (radians) -> CARLA yaw degrees (utils.py:154-165)."""
    if np.isnan(compass_rad):
        return last_yaw
    compass = math.degrees(compass_rad)
    return compass - 90.0 if compass < 270.0 else compass - 450.0


def _skew(v: np.ndarray) -> np.ndarray:
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]],
                    dtype=np.float64)


class LocalizationOperator:
    """GNSS+IMU pose tracker with an optional error-state EKF.

    State: [position(3), velocity(3), orientation-error(3)] with IMU-driven
    prediction and GNSS position correction (utils.py:252-337 semantics).
    """

    def __init__(self, var_imu_f: float = 0.5, var_imu_w: float = 0.5,
                 var_gnss: float = 0.1):
        self.pose = Pose()
        self._g = np.array([0.0, 0.0, -9.81])
        self._last_pose: Optional[Pose] = None
        self._last_timestamp: Optional[float] = None
        self._started = False
        self._q = np.identity(6)
        self._q[0:3, 0:3] *= var_imu_f
        self._q[3:6, 3:6] *= var_imu_w
        self._f = np.identity(9)
        self._l = np.zeros((9, 6))
        self._l[3:9, :] = np.identity(6)
        self._r_gnss = np.identity(3) * var_gnss
        self._covariance = np.zeros((9, 9))
        self.last_yaw = 0.0

    def update_pose(self, location: np.ndarray, speed: float, imu: IMUReading,
                    yaw_deg: float, rotation: Rotation,
                    use_ekf: bool = False) -> Pose:
        yaw = math.radians(yaw_deg)
        self.pose = Pose(
            location=np.asarray(location, dtype=np.float64),
            rotation=rotation,
            velocity=np.array([speed * math.cos(yaw), speed * math.sin(yaw), 0.0]))
        if use_ekf:
            self._estimate(imu)
            return self._last_pose or self.pose
        return self.pose

    # ---- EKF ----------------------------------------------------------------- #

    def _estimate(self, imu: IMUReading) -> None:
        # the vehicle free-falls at spawn; wait for the IMU to stabilize
        if self._last_pose is None or (abs(imu.accelerometer[1]) > 100 and not self._started):
            self._last_pose = self.pose
            self._last_timestamp = imu.timestamp
            return
        self._started = True
        dt = imu.timestamp - self._last_timestamp
        if dt <= 0:
            return

        last_q = Quaternion.from_rotation(self._last_pose.rotation)
        rotation_estimate = last_q * Quaternion.from_angular_velocity(imu.gyroscope, dt)

        accel_world = last_q.matrix @ np.asarray(imu.accelerometer) + self._g
        location_estimate = (self._last_pose.location + dt * self._last_pose.velocity
                             + (dt ** 2 / 2.0) * accel_world)
        velocity_estimate = self._last_pose.velocity + dt * accel_world

        self._f[0:3, 3:6] = np.identity(3) * dt
        self._f[3:6, 6:9] = last_q.matrix @ (-_skew(accel_world)) * dt

        gnss = self.pose.location
        location_estimate, velocity_estimate, rotation_estimate = self._gnss_update(
            location_estimate, velocity_estimate, rotation_estimate, gnss, dt)

        self._last_pose = Pose(location=location_estimate,
                               rotation=rotation_estimate.as_rotation(),
                               velocity=velocity_estimate)
        self._last_timestamp = imu.timestamp

    def _gnss_update(self, location, velocity, rotation_q, gnss, dt):
        h = np.zeros((3, 9))
        h[:, :3] = np.identity(3)
        q = self._q * dt * dt
        self._covariance = self._f @ self._covariance @ self._f.T + self._l @ q @ self._l.T
        k = self._covariance @ h.T @ np.linalg.inv(
            h @ self._covariance @ h.T + self._r_gnss)
        delta = k @ (gnss - location)
        location = location + delta[0:3]
        velocity = velocity + delta[3:6]
        roll, pitch, yaw = delta[6:9]
        rotation_q = Quaternion.from_rotation(
            Rotation(pitch=pitch, yaw=yaw, roll=roll)) * rotation_q
        self._covariance = (np.identity(9) - k @ h) @ self._covariance
        return location, velocity, rotation_q
