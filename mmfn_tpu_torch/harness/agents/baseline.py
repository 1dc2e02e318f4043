"""Closed-loop agents for the benchmark baselines
(team_code/e2e_agent/{aim,cilrs,transfuser}_agent.py analogs).

- ``aim``:        camera + target point -> waypoints -> PID
- ``transfuser``: camera + two-sweep LiDAR BEV + target + velocity ->
  waypoints -> PID
- ``cilrs``:      camera + velocity + navigational command -> direct control

The tick protocol of the JAX package's ``BaselineAgent``: the route planner's
target rotated into the ego frame, the planner's command (LANEFOLLOW when it
has none), LiDAR double-buffering for TransFuser (the first tick only stores
its sweep and returns a zero control). Each tick is one forward under
``torch.inference_mode()``. TransFuser's padded f32 cloud is uploaded and
binned on the device (``ops/lidar.py``, the BEV kernel on the GPU: one
launch a tick); AIM and CILRS get a zero BEV and launch no kernel. With
``config.attn_impl == "pallas"`` TransFuser's four fusion transformers
launch the fused attention kernel, ``4 * n_layer`` times a tick.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.control.pid import WaypointController
from mmfn_tpu_torch.control.planner import RoutePlanner
from mmfn_tpu_torch.data.batch import Batch
from mmfn_tpu_torch.data.host_ops import scale_and_crop_image
from mmfn_tpu_torch.device import resolve_device
from mmfn_tpu_torch.harness.agents.base import AutonomousAgent, Track, VehicleControl
from mmfn_tpu_torch.models.baselines import BASELINES, build_baseline
from mmfn_tpu_torch.ops.lidar import GRID, lidar_to_histogram_features, pad_points
from mmfn_tpu_torch.utils.weights import load_reference_state_dict


class BaselineAgent(AutonomousAgent):
    """Config keys: ``kind`` (aim | cilrs | transfuser), ``model`` (a port
    baseline, or a reference state_dict that is loaded into a fresh one),
    optional ``config``, ``points_per_sweep`` and ``device`` (the CUDA
    device when absent; raises when there is none)."""

    def setup(self, conf) -> None:
        conf = conf or {}
        self.track = Track.SENSORS
        self.kind = conf.get("kind", "aim")
        if self.kind not in BASELINES:
            raise ValueError(f"kind must be one of {BASELINES}, got {self.kind!r}")
        self.config: GlobalConfig = conf.get("config") or GlobalConfig()
        self.device = resolve_device(conf.get("device"))
        model = conf["model"]
        if isinstance(model, Mapping):
            state_dict = model
            model = build_baseline(self.kind, self.config, device="cpu")
            load_reference_state_dict(model, state_dict)
        if model.variant != self.kind:
            raise ValueError(f"kind {self.kind!r} but the model is {model.variant!r}")
        self.model = model.to(self.device).eval()
        self.points_per_sweep = conf.get("points_per_sweep", 32768)
        self.controller = WaypointController(self.config)
        self.step = -1
        self.initialized = False
        self.prev_lidar: Optional[np.ndarray] = None
        self._zero_bev = torch.zeros((1, GRID, GRID, 2), device=self.device)

    def sensors(self):
        sensors = [
            {"type": "sensor.camera.rgb", "x": 1.3, "y": 0.0, "z": 2.3,
             "roll": 0.0, "pitch": 0.0, "yaw": 0.0,
             "width": 400, "height": 300, "fov": 100, "id": "rgb"},
            {"type": "sensor.other.imu", "x": 0.0, "y": 0.0, "z": 0.0,
             "roll": 0.0, "pitch": 0.0, "yaw": 0.0, "sensor_tick": 0.05, "id": "imu"},
            {"type": "sensor.other.gnss", "x": 0.0, "y": 0.0, "z": 0.0,
             "roll": 0.0, "pitch": 0.0, "yaw": 0.0, "sensor_tick": 0.01, "id": "gps"},
            {"type": "sensor.speedometer", "reading_frequency": 20, "id": "speed"},
        ]
        if self.kind == "transfuser":
            sensors.append({"type": "sensor.lidar.ray_cast", "x": 1.3, "y": 0.0,
                            "z": 2.5, "roll": 0.0, "pitch": 0.0, "yaw": -90.0,
                            "id": "lidar"})
        return sensors

    def _init_route(self) -> None:
        self._route_planner = RoutePlanner(4.0, 50.0)
        self._route_planner.set_route(self._global_plan, gps=True)
        self.initialized = True

    @torch.inference_mode()
    def _forward(self, image: np.ndarray, points4: Optional[np.ndarray], target: np.ndarray,
                 speed: float, command: int):
        """One forward on the agent's device: the raw model output, not
        fetched. ``points4`` is the padded (N, 4) cloud for TransFuser, else
        None."""
        dev = self.device
        if points4 is None:
            bev = self._zero_bev
        else:
            bev = lidar_to_histogram_features(torch.from_numpy(points4).to(dev))[None]
        batch = Batch(image=torch.from_numpy(image).to(dev)[None], lidar_bev=bev,
                      target_point=torch.from_numpy(target).to(dev)[None],
                      velocity=torch.tensor([speed], dtype=torch.float32, device=dev))
        if self.kind == "cilrs":
            return self.model(batch, torch.tensor([command], dtype=torch.int32, device=dev))
        return self.model(batch)

    def run_step(self, input_data, timestamp) -> VehicleControl:
        control = VehicleControl()
        if not self.initialized:
            self._init_route()
        self.step += 1

        rp = self._route_planner
        pos = (np.asarray(input_data["gps"][1][:2]) - rp.mean) * rp.scale
        compass = input_data["imu"][1][-1]
        if math.isnan(compass):
            compass = 0.0
        speed = float(input_data["speed"][1]["speed"])
        next_wp, next_cmd = rp.run_step(pos)
        theta = compass + np.pi / 2
        rot = np.array([[np.cos(theta), -np.sin(theta)],
                        [np.sin(theta), np.cos(theta)]])
        target = (rot.T @ np.array([next_wp[0] - pos[0], next_wp[1] - pos[1]])).astype(np.float32)

        points4 = None
        if self.kind == "transfuser":
            cur = input_data["lidar"][1]
            if self.step == 0:
                self.prev_lidar = cur
                return control
            points = np.concatenate([cur, self.prev_lidar], axis=0)[:, :3].copy()
            points[:, 1] *= -1
            self.prev_lidar = cur
            points4 = pad_points(points, 2 * self.points_per_sweep)

        image = scale_and_crop_image(
            np.ascontiguousarray(input_data["rgb"][1][:, :, :3][:, :, ::-1]),
            scale=self.config.scale, crop=self.config.input_resolution
        ).astype(np.float32)

        command = int(getattr(next_cmd, "value", next_cmd) or 4)
        out = self._forward(image, points4, target, np.float32(speed), command)

        if self.kind == "cilrs":
            steer, throttle, brake = torch.cat(out[:3]).cpu().numpy()   # one fetch
            return VehicleControl(steer=float(steer), throttle=float(throttle),
                                  brake=float(brake > 0.5))
        waypoints = out[0].cpu().numpy()
        steer, throttle, brake, _ = self.controller.control_pid(waypoints, speed)
        if float(brake) < 0.05:
            brake = 0.0
        if throttle > brake:
            brake = 0.0
        return VehicleControl(steer=float(steer), throttle=float(throttle),
                              brake=float(brake))
