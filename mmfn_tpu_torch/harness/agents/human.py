"""Keyboard-driven human agent (reference team_code/expert_agent/human_agent.py).

Drives with WASD/arrow keys through a pygame window showing the front camera,
and can record/replay control logs. pygame is optional — importing this module
without it raises only at construction time. Without a display, pygame's
dummy video backend (``SDL_VIDEODRIVER=dummy``) runs the reader headless. The
port's own copy of the JAX package's ``harness/agents/human.py`` (no torch).
"""

from __future__ import annotations

import json
from typing import List, Optional

from mmfn_tpu_torch.harness.agents.base import AutonomousAgent, Track, VehicleControl


class KeyboardReader:
    def __init__(self, width: int = 400, height: int = 300):
        import pygame  # noqa: optional dependency

        self._pygame = pygame
        pygame.init()
        self._display = pygame.display.set_mode((width, height))
        pygame.display.set_caption("mmfn_tpu_torch human agent")
        self.control = VehicleControl()

    def render(self, rgb) -> None:
        surface = self._pygame.surfarray.make_surface(rgb.swapaxes(0, 1))
        self._display.blit(surface, (0, 0))
        self._pygame.display.flip()

    def parse(self) -> VehicleControl:
        pg = self._pygame
        pg.event.pump()
        keys = pg.key.get_pressed()
        c = VehicleControl()
        c.throttle = 0.7 if (keys[pg.K_UP] or keys[pg.K_w]) else 0.0
        c.brake = 1.0 if (keys[pg.K_DOWN] or keys[pg.K_s]) else 0.0
        steer = 0.0
        if keys[pg.K_LEFT] or keys[pg.K_a]:
            steer -= 0.6
        if keys[pg.K_RIGHT] or keys[pg.K_d]:
            steer += 0.6
        c.steer = steer
        c.reverse = bool(keys[pg.K_q])
        return c


class HumanAgent(AutonomousAgent):
    """Config keys: 'record' (path to write a control log),
    'replay' (path to replay one)."""

    def setup(self, conf) -> None:
        conf = conf or {}
        self.track = Track.SENSORS
        self._record_path: Optional[str] = conf.get("record")
        self._log: List[dict] = []
        self._replay: Optional[List[dict]] = None
        if conf.get("replay"):
            with open(conf["replay"]) as f:
                self._replay = json.load(f)
        self._step = -1
        self._reader: Optional[KeyboardReader] = None

    def sensors(self):
        return [{"type": "sensor.camera.rgb", "x": 1.3, "y": 0.0, "z": 2.3,
                 "roll": 0.0, "pitch": 0.0, "yaw": 0.0,
                 "width": 400, "height": 300, "fov": 100, "id": "rgb"},
                {"type": "sensor.speedometer", "reading_frequency": 20, "id": "speed"}]

    def run_step(self, input_data, timestamp) -> VehicleControl:
        self._step += 1
        if self._replay is not None:
            if self._step < len(self._replay):
                return VehicleControl(**self._replay[self._step])
            return VehicleControl(brake=1.0)

        if self._reader is None:
            self._reader = KeyboardReader()
        if "rgb" in input_data:
            self._reader.render(input_data["rgb"][1][:, :, :3])
        control = self._reader.parse()
        if self._record_path:
            self._log.append({"steer": control.steer, "throttle": control.throttle,
                              "brake": control.brake, "reverse": control.reverse})
        return control

    def destroy(self) -> None:
        if self._record_path and self._log:
            with open(self._record_path, "w") as f:
                json.dump(self._log, f)
