"""Dataset writer — the expert's frame-saving side (base_agent.py:58-74,224-271).

Creates the per-route directory tree our CarlaDataset reads back:
    rgb_front/  lidar/  radar/  maps/  vectormap/  measurements/
Frames are saved every ``SAVE_EVERY`` simulator ticks (10 -> 2 Hz at the 20 Hz
sim rate, mmfn_pilot.py:97) with 1-based zero-padded ids.

The port's own copy of the JAX package's ``data/writer.py``: the same tree,
file names and measurement keys. Images go through the port's PNG codec
(``data/png.py``) instead of PIL, or to ``.npy`` with ``image_ext="npy"``;
any other extension raises.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from mmfn_tpu_torch.data import png

# matches base_agent.py:67-74's per-route tree (opendrive/ holds the map
# string the route was collected on, written once by the expert's _save_map)
SUBDIRS = ("rgb_front", "lidar", "radar", "maps", "vectormap", "measurements",
           "opendrive")
SAVE_EVERY = 10


class DatasetWriter:
    def __init__(self, route_dir: str, image_ext: str = "png"):
        if image_ext not in ("png", "npy"):
            raise ValueError(f"image_ext {image_ext!r}: frames are written as png or npy")
        self.route_dir = route_dir
        self.image_ext = image_ext
        self._frame_id = 0
        for sub in SUBDIRS:
            os.makedirs(os.path.join(route_dir, sub), exist_ok=True)

    def should_save(self, step: int) -> bool:
        return step % SAVE_EVERY == 0 and step != 0

    def _path(self, sub: str, ext: str) -> str:
        return os.path.join(self.route_dir, sub,
                            f"{str(self._frame_id).zfill(4)}.{ext}")

    def _save_image(self, sub: str, image: np.ndarray) -> None:
        if self.image_ext == "npy":
            np.save(self._path(sub, "npy"), image)
        else:
            png.write(self._path(sub, "png"), np.asarray(image, dtype=np.uint8))

    def save_frame(self, *, rgb_front: np.ndarray, lidar: np.ndarray,
                   radar: np.ndarray, vectormap: np.ndarray,
                   map_raster: Optional[np.ndarray],
                   x: float, y: float, theta: float, speed: float,
                   target_speed: float, x_command: float, y_command: float,
                   command: int, steer: float, throttle: float, brake: float,
                   reverse: bool = False, weather: int = 0) -> int:
        """Persist one frame; returns its id."""
        self._frame_id += 1
        self._save_image("rgb_front", rgb_front)
        if map_raster is not None:
            self._save_image("maps", map_raster)
        np.save(self._path("lidar", "npy"), np.asarray(lidar, dtype=np.float32))
        np.save(self._path("radar", "npy"), np.asarray(radar, dtype=np.float32))
        np.save(self._path("vectormap", "npy"), np.asarray(vectormap, dtype=np.float32))
        measurements = {
            "x": x, "y": y, "theta": theta, "speed": speed,
            "target_speed": target_speed, "x_command": x_command,
            "y_command": y_command, "command": command, "steer": steer,
            "throttle": throttle, "brake": brake, "reverse": reverse,
            "weather": weather,
        }
        with open(self._path("measurements", "json"), "w") as f:
            json.dump(measurements, f)
        return self._frame_id
