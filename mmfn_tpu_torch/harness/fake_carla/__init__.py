"""In-process mock of the ``carla`` Python API surface used by
``mmfn_tpu_torch.harness.carla_glue``: the port's own copy of the JAX
package's test double (``tests/fake_carla``), so that the glue runs where
neither CARLA nor the JAX package is installed. It is a test double: real
driving still needs a CARLA server and the ``carla`` package.

Implements exactly what the glue touches — Client/World/Map/blueprints,
actor spawning, sensor ``listen`` callbacks with raw-buffer payloads shaped
like CARLA's (camera BGRA bytes, lidar/radar float32 buffers, geodetic GNSS,
IMU with sensor transform), a synchronous ``tick`` that integrates a
bicycle-model ego, and a collision sensor. Nothing installs it implicitly::

    from mmfn_tpu_torch.harness import fake_carla
    glue = fake_carla.install({"TownTest": xodr})   # carla + agents.navigation
    ...                                             # glue.run_carla_evaluation(...)
    fake_carla.uninstall()

or, around the phase0 CLI, ``python -m mmfn_tpu_torch.harness.fake_carla
--town TownTest=<map.xodr> [phase0 arguments] simulator=carla``.

Physics constants mirror the fake world's KinematicWorld (harness/replay.py)
so expert PID gains behave identically. GNSS emits true geodetic (mercator)
coordinates via control.planner.location_to_gps — the glue's
_LinearGnssParser must invert them back to world meters; if the two frames
ever diverge the end-to-end test drives off-route and fails.
"""

from __future__ import annotations

import fnmatch
import importlib
import math
import sys
import threading
import types
from typing import Callable, List, Optional

import numpy as np

# town name -> OpenDRIVE string; tests register entries before load_world
TOWN_MAPS = {}


# --------------------------------------------------------------------------- #
# Geometry value types
# --------------------------------------------------------------------------- #

class Location:
    def __init__(self, x: float = 0.0, y: float = 0.0, z: float = 0.0):
        self.x, self.y, self.z = float(x), float(y), float(z)

    def distance(self, other: "Location") -> float:
        return math.dist((self.x, self.y, self.z), (other.x, other.y, other.z))


class Rotation:
    def __init__(self, pitch: float = 0.0, yaw: float = 0.0, roll: float = 0.0):
        self.pitch, self.yaw, self.roll = float(pitch), float(yaw), float(roll)


class Vector3D:
    def __init__(self, x: float = 0.0, y: float = 0.0, z: float = 0.0):
        self.x, self.y, self.z = float(x), float(y), float(z)


class Transform:
    def __init__(self, location: Location = None, rotation: Rotation = None):
        self.location = location or Location()
        self.rotation = rotation or Rotation()

    def transform(self, point: Location) -> Location:
        """Apply this transform to a point (yaw-only, like the glue needs
        for stop-sign trigger volumes)."""
        c, s = math.cos(math.radians(self.rotation.yaw)), math.sin(
            math.radians(self.rotation.yaw))
        return Location(self.location.x + c * point.x - s * point.y,
                        self.location.y + s * point.x + c * point.y,
                        self.location.z + point.z)


class VehicleControl:
    def __init__(self, throttle: float = 0.0, steer: float = 0.0,
                 brake: float = 0.0, reverse: bool = False,
                 hand_brake: bool = False, manual_gear_shift: bool = False):
        self.throttle, self.steer, self.brake = throttle, steer, brake
        self.reverse = reverse
        self.hand_brake = hand_brake
        self.manual_gear_shift = manual_gear_shift


class TrafficLightState:
    Red = "Red"
    Yellow = "Yellow"
    Green = "Green"
    Off = "Off"


class _WeatherPreset:
    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return f"WeatherParameters.{self.name}"


class WeatherParameters:
    pass


for _p in ("ClearNoon", "CloudyNoon", "WetNoon", "WetCloudyNoon", "MidRainyNoon",
           "HardRainNoon", "SoftRainNoon", "ClearSunset", "CloudySunset",
           "WetSunset", "WetCloudySunset", "MidRainSunset", "HardRainSunset",
           "SoftRainSunset"):
    setattr(WeatherParameters, _p, _WeatherPreset(_p))


# --------------------------------------------------------------------------- #
# Blueprints
# --------------------------------------------------------------------------- #

class _Attribute:
    def __init__(self, values):
        self.recommended_values = values


class Blueprint:
    def __init__(self, type_id: str):
        self.id = type_id
        self.attributes = {}

    def set_attribute(self, name: str, value: str) -> None:
        self.attributes[name] = value

    def has_attribute(self, name: str) -> bool:
        return name == "color"

    def get_attribute(self, name: str) -> _Attribute:
        return _Attribute(["0,0,0", "255,255,255"])


class BlueprintLibrary:
    _TYPES = [
        "vehicle.lincoln.mkz2017", "vehicle.tesla.model3", "vehicle.audi.tt",
        "walker.pedestrian.0001",
        "sensor.camera.rgb", "sensor.lidar.ray_cast", "sensor.other.radar",
        "sensor.other.gnss", "sensor.other.imu", "sensor.other.collision",
    ]

    def find(self, type_id: str) -> Blueprint:
        if type_id not in self._TYPES:
            raise KeyError(f"blueprint {type_id} not found")
        return Blueprint(type_id)

    def filter(self, pattern: str) -> List[Blueprint]:
        return [Blueprint(t) for t in self._TYPES if fnmatch.fnmatch(t, pattern)]


# --------------------------------------------------------------------------- #
# Sensor payloads (attribute layout matches what the glue parsers read)
# --------------------------------------------------------------------------- #

class _CameraData:
    def __init__(self, height, width, frame):
        # BGRA gradient so crops/channel flips are observable downstream
        img = np.zeros((height, width, 4), np.uint8)
        img[:, :, 0] = np.linspace(0, 255, width, dtype=np.uint8)[None, :]
        img[:, :, 1] = 64
        img[:, :, 2] = np.linspace(255, 0, height, dtype=np.uint8)[:, None]
        img[:, :, 3] = 255
        self.raw_data = img.tobytes()
        self.height, self.width, self.frame = height, width, frame


class _LidarData:
    def __init__(self, rng, frame):
        n = 400
        pts = np.zeros((n, 4), np.float32)
        pts[:, 0] = rng.uniform(-20, 20, n)
        pts[:, 1] = rng.uniform(-20, 20, n)
        pts[:, 2] = rng.uniform(-2.4, 0.5, n)
        pts[:, 3] = rng.uniform(0, 1, n)
        self.raw_data = pts.astype(np.float32).tobytes()
        self.frame = frame


class _RadarData:
    def __init__(self, rng, frame):
        n = 24
        # carla layout [velocity, azimuth, altitude, depth] raw -> the glue
        # flips each row; emit so the flipped rows are [vel, alt, az, depth]
        pts = np.zeros((n, 4), np.float32)
        pts[:, 0] = rng.uniform(10, 60, n)          # depth (flips to col 3)
        pts[:, 1] = rng.uniform(-0.3, 0.3, n)       # azimuth
        pts[:, 2] = rng.uniform(-0.05, 0.05, n)     # altitude
        pts[:, 3] = rng.uniform(-5, 5, n)           # velocity (flips to col 0)
        self.raw_data = pts.astype(np.float32).tobytes()
        self.frame = frame


class _GnssData:
    def __init__(self, lat, lon, alt, frame):
        self.latitude, self.longitude, self.altitude = lat, lon, alt
        self.frame = frame


class _ImuData:
    def __init__(self, transform, frame):
        self.accelerometer = Vector3D(0.0, 0.0, 9.81)
        self.gyroscope = Vector3D()
        self.compass = math.pi / 2 - math.radians(transform.rotation.yaw)
        self.transform = transform
        self.frame = frame


class _CollisionEvent:
    def __init__(self, actor, other_actor, frame):
        self.actor, self.other_actor, self.frame = actor, other_actor, frame


# --------------------------------------------------------------------------- #
# Actors
# --------------------------------------------------------------------------- #

class Actor:
    _next_id = [1]

    def __init__(self, world: "World", type_id: str, transform: Transform,
                 parent: Optional["Actor"] = None):
        self.id = Actor._next_id[0]
        Actor._next_id[0] += 1
        self.type_id = type_id
        self.parent = parent
        self._world = world
        self._transform = Transform(
            Location(transform.location.x, transform.location.y,
                     transform.location.z),
            Rotation(transform.rotation.pitch, transform.rotation.yaw,
                     transform.rotation.roll))
        self.is_alive = True

    def get_world(self) -> "World":
        return self._world

    def get_location(self) -> Location:
        return self.get_transform().location

    def get_transform(self) -> Transform:
        if self.parent is not None:
            return self.parent.get_transform()
        return self._transform

    def get_velocity(self) -> Vector3D:
        return Vector3D()

    def destroy(self) -> None:
        self.is_alive = False
        if self in self._world._actors:
            self._world._actors.remove(self)


class Vehicle(Actor):
    """Bicycle model matching harness/replay.py KinematicWorld constants."""

    MAX_STEER_ANGLE = math.radians(35.0)
    WHEELBASE = 2.9
    MAX_ACCEL = 4.0
    MAX_BRAKE = 8.0
    DRAG = 0.1

    def __init__(self, world, type_id, transform):
        super().__init__(world, type_id, transform)
        self.speed = 0.0
        self._control = VehicleControl()
        self._autopilot = False

    def apply_control(self, control: VehicleControl) -> None:
        self._control = control

    def set_autopilot(self, enabled: bool = True, tm_port: int = 8000) -> None:
        self._autopilot = enabled

    def is_at_traffic_light(self) -> bool:
        return False

    def get_traffic_light_state(self):
        return TrafficLightState.Green

    def get_velocity(self) -> Vector3D:
        yaw = math.radians(self._transform.rotation.yaw)
        return Vector3D(self.speed * math.cos(yaw), self.speed * math.sin(yaw))

    def _integrate(self, dt: float) -> None:
        c = VehicleControl(throttle=0.35) if self._autopilot else self._control
        if getattr(c, "reverse", False):
            accel = (-c.throttle * self.MAX_ACCEL + c.brake * self.MAX_BRAKE
                     - self.DRAG * self.speed)
            self.speed = float(np.clip(self.speed + accel * dt, -3.0, 0.0))
        else:
            accel = (c.throttle * self.MAX_ACCEL - c.brake * self.MAX_BRAKE
                     - self.DRAG * self.speed)
            self.speed = max(0.0, self.speed + accel * dt)
        yaw = math.radians(self._transform.rotation.yaw)
        yaw += (self.speed / self.WHEELBASE) * math.tan(
            c.steer * self.MAX_STEER_ANGLE) * dt
        self._transform.rotation.yaw = math.degrees(yaw)
        self._transform.location.x += self.speed * math.cos(yaw) * dt
        self._transform.location.y += self.speed * math.sin(yaw) * dt


class TrafficLight(Actor):
    """Pole-mounted light; group membership mirrors carla's
    get_group_traffic_lights (all lights of one junction controller)."""

    def __init__(self, world, transform, group_id: int = 0):
        super().__init__(world, "traffic.traffic_light", transform)
        self._state = TrafficLightState.Red
        self._frozen = False
        self._group_id = group_id
        self.trigger_volume = _TriggerVolume(Location(0.0, 0.0, 0.0))

    def get_state(self) -> str:
        return self._state

    @property
    def state(self) -> str:
        return self._state

    def set_state(self, state) -> None:
        self._state = state

    def set_green_time(self, seconds: float) -> None:
        self.green_time = seconds

    def set_red_time(self, seconds: float) -> None:
        self.red_time = seconds

    def freeze(self, frozen: bool) -> None:
        self._frozen = frozen

    def is_frozen(self) -> bool:
        return self._frozen

    def get_group_traffic_lights(self):
        return [a for a in self._world._actors
                if isinstance(a, TrafficLight) and a._group_id == self._group_id]


class _TriggerVolume:
    def __init__(self, location: Location):
        self.location = location
        self.extent = Vector3D(1.5, 1.5, 1.0)


class Sensor(Actor):
    def __init__(self, world, bp: Blueprint, transform, parent):
        super().__init__(world, bp.id, transform, parent)
        self._bp = bp
        self._callback: Optional[Callable] = None
        self._rng = np.random.default_rng(world._seed + self.id)

    def listen(self, callback: Callable) -> None:
        self._callback = callback

    def stop(self) -> None:
        self._callback = None

    def _emit(self, frame: int) -> None:
        if self._callback is None:
            return
        t = self.type_id
        if t.startswith("sensor.camera"):
            h = int(self._bp.attributes.get("image_size_y", 300))
            w = int(self._bp.attributes.get("image_size_x", 400))
            self._callback(_CameraData(h, w, frame))
        elif t.startswith("sensor.lidar"):
            self._callback(_LidarData(self._rng, frame))
        elif t.startswith("sensor.other.radar"):
            self._callback(_RadarData(self._rng, frame))
        elif t.startswith("sensor.other.gnss"):
            from mmfn_tpu_torch.control.planner import location_to_gps

            loc = self.get_transform().location
            lat, lon, alt = location_to_gps(
                loc.x, loc.y, loc.z, *self._world._latlon_ref)
            self._callback(_GnssData(lat, lon, alt, frame))
        elif t.startswith("sensor.other.imu"):
            self._callback(_ImuData(self.get_transform(), frame))
        elif t.startswith("sensor.other.collision"):
            me = self.parent
            for other in list(self._world._actors):
                if other.id in (me.id, self.id) or not isinstance(other, Vehicle):
                    continue
                if not other.type_id.startswith(("vehicle", "walker")):
                    continue
                d = other.get_location().distance(me.get_location())
                if d < 3.0 and other.id not in self._world._collided:
                    self._world._collided.add(other.id)
                    self._callback(_CollisionEvent(me, other, frame))


# --------------------------------------------------------------------------- #
# Map / world
# --------------------------------------------------------------------------- #

class Waypoint:
    def __init__(self, transform: Transform):
        self.transform = transform


class Map:
    def __init__(self, name: str, xodr: str):
        self.name = name
        self._xodr = xodr

    def to_opendrive(self) -> str:
        return self._xodr

    def get_waypoint(self, location: Location, **kw) -> Waypoint:
        return Waypoint(Transform(Location(location.x, location.y, location.z)))

    def get_spawn_points(self) -> List[Transform]:
        return [Transform(Location(10.0 + 12.0 * i, 1.75, 0.2))
                for i in range(8)]


class _Settings:
    def __init__(self):
        self.fixed_delta_seconds = None
        self.synchronous_mode = False
        self.no_rendering_mode = False


class _Timestamp:
    def __init__(self, frame: int, elapsed_seconds: float):
        self.frame = frame
        self.elapsed_seconds = elapsed_seconds
        self.delta_seconds = 0.05


class _Snapshot:
    def __init__(self, frame, elapsed):
        self.timestamp = _Timestamp(frame, elapsed)


class _ActorList(list):
    def filter(self, pattern: str) -> "_ActorList":
        return _ActorList(a for a in self if fnmatch.fnmatch(a.type_id, pattern))


class World:
    def __init__(self, name: str, xodr: str, seed: int = 0):
        self._map = Map(name, xodr)
        self._settings = _Settings()
        self._actors: List[Actor] = []
        self._frame = 0
        self._elapsed = 0.0
        self._seed = seed
        self._weather = None
        self._collided = set()
        from mmfn_tpu_torch.harness.carla_glue import latlon_ref_from_opendrive

        self._latlon_ref = latlon_ref_from_opendrive(xodr)

    # -- api ---------------------------------------------------------------- #

    def get_settings(self) -> _Settings:
        return self._settings

    def apply_settings(self, settings: _Settings) -> None:
        self._settings = settings

    def get_blueprint_library(self) -> BlueprintLibrary:
        return BlueprintLibrary()

    def get_map(self) -> Map:
        return self._map

    def get_actors(self) -> _ActorList:
        return _ActorList(self._actors)

    def spawn_actor(self, bp: Blueprint, transform: Transform,
                    attach_to: Actor = None) -> Actor:
        if bp.id.startswith("sensor"):
            actor = Sensor(self, bp, transform, attach_to)
        elif bp.id.startswith("vehicle"):
            actor = Vehicle(self, bp.id, transform)
        else:
            actor = Actor(self, bp.id, transform)
        self._actors.append(actor)
        return actor

    def try_spawn_actor(self, bp, transform, attach_to=None) -> Optional[Actor]:
        for a in self._actors:
            if isinstance(a, Vehicle) and \
                    a.get_location().distance(transform.location) < 4.0:
                return None
        return self.spawn_actor(bp, transform, attach_to)

    def set_weather(self, weather) -> None:
        self._weather = weather

    def tick(self) -> int:
        dt = self._settings.fixed_delta_seconds or 0.05
        self._frame += 1
        self._elapsed += dt
        for a in list(self._actors):
            if isinstance(a, Vehicle):
                a._integrate(dt)
        for a in list(self._actors):
            if isinstance(a, Sensor):
                a._emit(self._frame)
        return self._frame

    def get_snapshot(self) -> _Snapshot:
        return _Snapshot(self._frame, self._elapsed)

    def add_traffic_light_group(self, poses, group_id: int = 0):
        """Test helper: spawn a junction's light group at [(x, y, yaw_deg)]."""
        lights = [TrafficLight(self, Transform(Location(x, y, 0.0),
                                               Rotation(yaw=yaw)), group_id)
                  for (x, y, yaw) in poses]
        self._actors.extend(lights)
        return lights


class _TrafficManager:
    def __init__(self, port: int):
        self._port = port

    def set_synchronous_mode(self, enabled: bool) -> None:
        self.synchronous = enabled

    def get_port(self) -> int:
        return self._port


class Client:
    def __init__(self, host: str = "localhost", port: int = 2000,
                 worker_threads: int = 0):
        self._host, self._port = host, port
        self._world: Optional[World] = None

    def set_timeout(self, seconds: float) -> None:
        self._timeout = seconds

    def load_world(self, name: str) -> World:
        if name not in TOWN_MAPS:
            raise RuntimeError(f"town {name!r} not registered in "
                               f"mmfn_tpu_torch.harness.fake_carla.TOWN_MAPS")
        self._world = World(name, TOWN_MAPS[name])
        return self._world

    def get_world(self) -> World:
        return self._world

    def get_trafficmanager(self, port: int = 8000) -> _TrafficManager:
        return _TrafficManager(port)


# --------------------------------------------------------------------------- #
# Installation
# --------------------------------------------------------------------------- #

_MODULES = ("carla", "agents", "agents.navigation",
            "agents.navigation.global_route_planner")
_saved: Optional[dict] = None


def install(towns: Optional[dict] = None):
    """Place this mock in ``sys.modules`` as ``carla`` and its route planner
    as ``agents.navigation.global_route_planner``, register ``towns`` (name
    -> OpenDRIVE string) in ``TOWN_MAPS``, and reload the port's glue so it
    binds them. Returns the reloaded glue module; :func:`uninstall` undoes
    it."""
    global _saved
    from mmfn_tpu_torch.harness.fake_carla import navigation

    if _saved is None:
        _saved = {k: sys.modules.get(k) for k in _MODULES}
    agents_pkg = types.ModuleType("agents")
    navigation_pkg = types.ModuleType("agents.navigation")
    agents_pkg.navigation = navigation_pkg
    navigation_pkg.global_route_planner = navigation
    sys.modules["carla"] = sys.modules[__name__]
    sys.modules["agents"] = agents_pkg
    sys.modules["agents.navigation"] = navigation_pkg
    sys.modules["agents.navigation.global_route_planner"] = navigation
    TOWN_MAPS.update(towns or {})
    import mmfn_tpu_torch.harness.carla_glue as glue

    return importlib.reload(glue)


def uninstall():
    """Restore the modules :func:`install` replaced and reload the glue
    (without a real ``carla`` it then refuses to run again)."""
    global _saved
    if _saved is not None:
        for k, v in _saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
        _saved = None
    import mmfn_tpu_torch.harness.carla_glue as glue

    return importlib.reload(glue)
