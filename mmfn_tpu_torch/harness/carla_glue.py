"""CARLA integration layer (requires the ``carla`` package + a server).

The port's own copy of the JAX package's ``harness/carla_glue.py``, wiring
the live world into the port's simulator-independent harness: raw
sensor-buffer parsing into the sensor mux, pseudo-sensors, sensor spawning
with the leaderboard intrinsics, the 20 Hz synchronous tick loop under a
2 s per-tick watchdog, ego/criteria bookkeeping, and the evaluation loop
the port's phase0 (``mmfn_tpu_torch.harness.phase0``) runs for
``simulator: carla``.

Reference mapping:
- CallBack parsers        <- leaderboard/envs/sensor_interface.py:133-195
- pseudo-sensors          <- sensor_interface.py:50-130
- setup_sensors           <- autoagents/agent_wrapper.py:77-174
- tick loop               <- scenarios/scenario_manager.py:118-181
- evaluation loop         <- leaderboard_evaluator.py:242-411
- server manager          <- run_steps/utils.py:23-65

Without a CARLA server the module runs against the port's in-process mock
of the carla API (``harness/fake_carla``, installed only on request). The
sensor callbacks and the pseudo-sensor readers run on other threads and only
parse into numpy; the agent, and with it every CUDA call, runs on the
thread that calls :func:`run_carla_evaluation`. Build the kernels
(``utils/compile_cache.enable_persistent_cache``) and warm the agent before
the loop: the watchdog allows 2 s a tick.
"""

from __future__ import annotations

import math
import subprocess
import threading
import time
from typing import List, Optional

import numpy as np

try:
    import carla  # type: ignore
    HAS_CARLA = True
except ImportError:  # pragma: no cover - exercised only with a simulator
    carla = None
    HAS_CARLA = False

from mmfn_tpu_torch.control.planner import GPS_SCALE
from mmfn_tpu_torch.harness.agents.base import VehicleControl
from mmfn_tpu_torch.harness.criteria import (
    AgentBlockedCriterion, RouteCompletionCriterion, RouteDeviationCriterion,
    route_timeout_seconds)
from mmfn_tpu_torch.harness.events import RoadOption, TrafficEvent, TrafficEventType
from mmfn_tpu_torch.harness.game_time import GameTime
from mmfn_tpu_torch.harness.route import route_length
from mmfn_tpu_torch.harness.sensor_interface import SensorInterface
from mmfn_tpu_torch.harness.watchdog import Watchdog

FIXED_DELTA_SECONDS = 1.0 / 20.0  # leaderboard_evaluator.py:61,203-205


# --------------------------------------------------------------------------- #
# Server lifecycle
# --------------------------------------------------------------------------- #

def kill_carla() -> None:
    subprocess.run(["pkill", "-9", "-f", "CarlaUE4"], check=False)


class CarlaServerManager:
    """Spawns a CarlaUE4 server per RPC port (run_steps/utils.py:30-65)."""

    def __init__(self, carla_sh: str, port: int = 2000, quality: str = "Epic"):
        self.carla_sh = carla_sh
        self.port = port
        self.quality = quality
        self._proc: Optional[subprocess.Popen] = None

    def start(self, wait: float = 10.0) -> None:
        cmd = [self.carla_sh, f"--quality-level={self.quality}",
               f"-carla-rpc-port={self.port}"]
        self._proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                      stderr=subprocess.DEVNULL)
        time.sleep(wait)

    def stop(self) -> None:
        if self._proc is not None:
            self._proc.terminate()
            self._proc = None
        kill_carla()


# --------------------------------------------------------------------------- #
# Raw-buffer parsing (sensor_interface.py:133-195)
# --------------------------------------------------------------------------- #

def parse_image(image) -> np.ndarray:
    array = np.frombuffer(image.raw_data, dtype=np.uint8)
    return np.reshape(array.copy(), (image.height, image.width, 4))


def parse_lidar(data) -> np.ndarray:
    points = np.frombuffer(data.raw_data, dtype=np.float32)
    return np.reshape(points.copy(), (-1, 4))


def parse_radar(data) -> np.ndarray:
    points = np.frombuffer(data.raw_data, dtype=np.float32)
    points = np.reshape(points.copy(), (-1, 4))
    return np.flip(points, axis=1)  # -> [velocity, altitude, azimuth, depth]


def parse_gnss(data) -> np.ndarray:
    return np.array([data.latitude, data.longitude, data.altitude], dtype=np.float64)


def parse_imu(data) -> np.ndarray:
    return np.array([data.accelerometer.x, data.accelerometer.y, data.accelerometer.z,
                     data.gyroscope.x, data.gyroscope.y, data.gyroscope.z,
                     data.compass], dtype=np.float64)


def latlon_ref_from_opendrive(xodr: str):
    """Map geo-reference (lat_0, lon_0) from the OpenDRIVE header — the
    origin CARLA's GnssSensor projects through (route_manipulation.py
    _get_latlon_ref)."""
    lat_ref, lon_ref = 42.0, 2.0   # CARLA's default georeference
    try:
        import xml.etree.ElementTree as ET

        geo = ET.fromstring(xodr).find(".//geoReference")
        for token in (geo.text or "").split(" "):
            if token.startswith("+lat_0="):
                lat_ref = float(token.split("=")[1])
            elif token.startswith("+lon_0="):
                lon_ref = float(token.split("=")[1])
    except Exception:
        pass
    return lat_ref, lon_ref


class _LinearGnssParser:
    """Re-encode geodetic GNSS into the harness's linear convention.

    Agents decode gps with the linear GPS_SCALE mapping (docs/PARITY.md: the
    reference mixes web-mercator routes with linearly-decoded positions — two
    subtly different frames). Here the mercator reading is inverted back to
    CARLA world (x, y) with the map's georeference and re-encoded linearly,
    so decoded agent positions land in the same world frame as the native
    vectorizer's lanes and the (linearly encoded) route plan.
    """

    def __init__(self, lat_ref: float, lon_ref: float):
        self._ref = (lat_ref, lon_ref)

    def __call__(self, data) -> np.ndarray:
        from mmfn_tpu_torch.control.planner import GPS_SCALE, gps_to_location

        x, y, alt = gps_to_location(data.latitude, data.longitude,
                                    data.altitude, *self._ref)
        return np.array([x / GPS_SCALE[0], y / GPS_SCALE[1], alt],
                        dtype=np.float64)


def parse_imu_world_yaw(data) -> np.ndarray:
    """IMU parse with the compass column replaced by the sensor's world yaw.

    The harness pose convention is theta = world yaw (the fake world emits it
    directly); CARLA's compass is measured from north in the UE frame, and
    decoding it would re-introduce the frame mismatch the linear GNSS parser
    removes. The attached sensor's transform gives the exact world heading.
    """
    return np.array([data.accelerometer.x, data.accelerometer.y, data.accelerometer.z,
                     data.gyroscope.x, data.gyroscope.y, data.gyroscope.z,
                     math.radians(data.transform.rotation.yaw)], dtype=np.float64)


class _Callback:
    _PARSERS = {
        "sensor.camera.rgb": parse_image,
        "sensor.lidar.ray_cast": parse_lidar,
        "sensor.other.radar": parse_radar,
        "sensor.other.gnss": parse_gnss,
        "sensor.other.imu": parse_imu,
    }

    def __init__(self, tag: str, sensor_type: str, interface: SensorInterface,
                 parse=None):
        self._tag = tag
        self._parse = parse or self._PARSERS[sensor_type]
        self._interface = interface

    def __call__(self, data) -> None:
        self._interface.update_sensor(self._tag, self._parse(data), data.frame)


class _BaseReader(threading.Thread):
    """Daemon poller for pseudo-sensors (sensor_interface.py:50-87)."""

    def __init__(self, vehicle, tag: str, interface: SensorInterface,
                 reading_frequency: float):
        super().__init__(daemon=True)
        self._vehicle = vehicle
        self._tag = tag
        self._interface = interface
        self._period = 1.0 / reading_frequency
        self._running = True
        self.start()

    def stop(self) -> None:
        self._running = False

    def read(self):
        raise NotImplementedError

    def run(self) -> None:
        last_time = GameTime.get_time()
        while self._running:
            # epsilon: game time accumulates 0.05 floats, so an exact >=
            # period test misses alternate ticks and starves the sensor mux
            if (GameTime.get_time() - last_time >= self._period - 1e-9
                    or last_time == 0):
                try:
                    self._interface.update_sensor(self._tag, self.read(),
                                                  GameTime.get_frame())
                except Exception:
                    pass
                last_time = GameTime.get_time()
            time.sleep(0.001)


class SpeedometerReader(_BaseReader):
    def read(self):
        velocity = self._vehicle.get_velocity()
        transform = self._vehicle.get_transform()
        yaw = math.radians(transform.rotation.yaw)
        pitch = math.radians(transform.rotation.pitch)
        heading = np.array([math.cos(pitch) * math.cos(yaw),
                            math.cos(pitch) * math.sin(yaw), math.sin(pitch)])
        speed = np.dot([velocity.x, velocity.y, velocity.z], heading)
        return {"speed": float(speed)}


class OpenDriveMapReader(_BaseReader):
    def read(self):
        return {"opendrive": self._vehicle.get_world().get_map().to_opendrive()}


# --------------------------------------------------------------------------- #
# Sensor spawning (agent_wrapper.py:77-174 intrinsics)
# --------------------------------------------------------------------------- #

def setup_sensors(agent, vehicle, world) -> List:
    bp_library = world.get_blueprint_library()
    lat_ref, lon_ref = latlon_ref_from_opendrive(world.get_map().to_opendrive())
    actors = []
    for spec in agent.sensors():
        stype, tag = spec["type"], spec["id"]
        if stype.startswith("sensor.opendrive_map"):
            agent.sensor_interface.register_opendrive(tag)
            actors.append(OpenDriveMapReader(vehicle, tag, agent.sensor_interface,
                                             spec["reading_frequency"]))
            continue
        if stype.startswith("sensor.speedometer"):
            agent.sensor_interface.register_sensor(tag)
            actors.append(SpeedometerReader(vehicle, tag, agent.sensor_interface,
                                            1.0 / FIXED_DELTA_SECONDS))
            continue

        bp = bp_library.find(stype)
        if stype.startswith("sensor.camera"):
            bp.set_attribute("image_size_x", str(spec["width"]))
            bp.set_attribute("image_size_y", str(spec["height"]))
            bp.set_attribute("fov", str(spec["fov"]))
            bp.set_attribute("lens_circle_multiplier", "3.0")
            bp.set_attribute("lens_circle_falloff", "3.0")
            bp.set_attribute("chromatic_aberration_intensity", "0.5")
            bp.set_attribute("chromatic_aberration_offset", "0")
        elif stype.startswith("sensor.lidar"):
            bp.set_attribute("range", "85")
            bp.set_attribute("rotation_frequency", "10")
            bp.set_attribute("channels", "64")
            bp.set_attribute("upper_fov", "10")
            bp.set_attribute("lower_fov", "-30")
            bp.set_attribute("points_per_second", "600000")
            bp.set_attribute("atmosphere_attenuation_rate", "0.004")
            bp.set_attribute("dropoff_general_rate", "0.45")
            bp.set_attribute("dropoff_intensity_limit", "0.8")
            bp.set_attribute("dropoff_zero_intensity", "0.4")
        elif stype.startswith("sensor.other.radar"):
            bp.set_attribute("horizontal_fov", str(spec["fov"]))
            bp.set_attribute("vertical_fov", str(spec["fov"]))
            bp.set_attribute("points_per_second", "1500")
            bp.set_attribute("range", "100")
        elif stype.startswith("sensor.other.gnss"):
            for attr, v in (("noise_alt_stddev", 0.000005), ("noise_lat_stddev", 0.000005),
                            ("noise_lon_stddev", 0.000005), ("noise_alt_bias", 0.0),
                            ("noise_lat_bias", 0.0), ("noise_lon_bias", 0.0)):
                bp.set_attribute(attr, str(v))
            bp.set_attribute("sensor_tick", str(spec.get("sensor_tick", 0.01)))
        elif stype.startswith("sensor.other.imu"):
            for attr in ("noise_accel_stddev_x", "noise_accel_stddev_y",
                         "noise_accel_stddev_z", "noise_gyro_stddev_x",
                         "noise_gyro_stddev_y", "noise_gyro_stddev_z"):
                bp.set_attribute(attr, "0.001" if "accel" in attr else "0.000001")
            bp.set_attribute("sensor_tick", str(spec.get("sensor_tick", 0.05)))

        location = carla.Location(x=spec.get("x", 0.0), y=spec.get("y", 0.0),
                                  z=spec.get("z", 0.0))
        rotation = carla.Rotation(pitch=spec.get("pitch", 0.0),
                                  roll=spec.get("roll", 0.0),
                                  yaw=spec.get("yaw", 0.0))
        sensor = world.spawn_actor(bp, carla.Transform(location, rotation),
                                   attach_to=vehicle)
        agent.sensor_interface.register_sensor(tag)
        # gnss/imu feed the harness's world-linear pose frame (see the
        # parser docstrings) so lane crops match the native vectorizer
        parse = None
        if stype.startswith("sensor.other.gnss"):
            parse = _LinearGnssParser(lat_ref, lon_ref)
        elif stype.startswith("sensor.other.imu"):
            parse = parse_imu_world_yaw
        sensor.listen(_Callback(tag, stype, agent.sensor_interface, parse))
        actors.append(sensor)
    return actors


# --------------------------------------------------------------------------- #
# CarlaDataProvider equivalent (srunner/scenariomanager/carla_data_provider.py)
# --------------------------------------------------------------------------- #

class CarlaDataProvider:
    """Per-tick cached world state + actor factory.

    The srunner original (carla_data_provider.py:23-687) funnels every
    actor-state read through one cache refreshed once per tick — under
    synchronous mode an RPC per query would dominate the 50 ms budget — and
    owns blueprint creation, (batch) spawning, and the traffic-light group
    annotations the scripted scenarios freeze junctions with. This is the
    same surface keyed by ``actor.id``.
    """

    _actor_velocity_map: dict = {}
    _actor_transform_map: dict = {}
    _actors: dict = {}
    _client = None
    _world = None
    _map = None
    _spawn_points: list = []
    _rng = None

    # ---- lifecycle (carla_data_provider.py:161-243) ----------------------- #

    @staticmethod
    def set_client(client) -> None:
        CarlaDataProvider._client = client

    @staticmethod
    def set_world(world, seed: int = 2000) -> None:
        import random

        CarlaDataProvider._world = world
        CarlaDataProvider._map = world.get_map()
        CarlaDataProvider._rng = random.Random(seed)
        pts = list(CarlaDataProvider._map.get_spawn_points())
        CarlaDataProvider._rng.shuffle(pts)
        CarlaDataProvider._spawn_points = pts

    @staticmethod
    def get_world():
        return CarlaDataProvider._world

    @staticmethod
    def get_map():
        return CarlaDataProvider._map

    @staticmethod
    def is_sync_mode() -> bool:
        w = CarlaDataProvider._world
        return bool(w and w.get_settings().synchronous_mode)

    @staticmethod
    def generate_spawn_points() -> list:
        return list(CarlaDataProvider._spawn_points)

    @staticmethod
    def cleanup() -> None:
        CarlaDataProvider._actor_velocity_map = {}
        CarlaDataProvider._actor_transform_map = {}
        CarlaDataProvider._actors = {}
        CarlaDataProvider._client = None
        CarlaDataProvider._world = None
        CarlaDataProvider._map = None
        CarlaDataProvider._spawn_points = []

    # ---- per-tick cache (carla_data_provider.py:66-158) ------------------- #

    @staticmethod
    def register_actor(actor) -> None:
        CarlaDataProvider._actors[actor.id] = actor
        CarlaDataProvider._actor_velocity_map.setdefault(actor.id, 0.0)
        CarlaDataProvider._actor_transform_map.setdefault(
            actor.id, actor.get_transform())

    @staticmethod
    def register_actors(actors) -> None:
        for actor in actors:
            CarlaDataProvider.register_actor(actor)

    @staticmethod
    def on_carla_tick() -> None:
        for aid, actor in CarlaDataProvider._actors.items():
            if getattr(actor, "is_alive", True):
                v = actor.get_velocity()
                CarlaDataProvider._actor_velocity_map[aid] = math.sqrt(
                    v.x ** 2 + v.y ** 2 + v.z ** 2)
                CarlaDataProvider._actor_transform_map[aid] = actor.get_transform()

    @staticmethod
    def get_velocity(actor) -> float:
        try:
            return CarlaDataProvider._actor_velocity_map[actor.id]
        except KeyError:
            v = actor.get_velocity()   # unregistered: direct read, like srunner
            return math.sqrt(v.x ** 2 + v.y ** 2 + v.z ** 2)

    @staticmethod
    def get_transform(actor):
        return CarlaDataProvider._actor_transform_map.get(
            actor.id, actor.get_transform())

    @staticmethod
    def get_location(actor):
        return CarlaDataProvider.get_transform(actor).location

    @staticmethod
    def get_actors() -> list:
        return list(CarlaDataProvider._actors.values())

    @staticmethod
    def actor_id_exists(actor_id: int) -> bool:
        return actor_id in CarlaDataProvider._actors

    # ---- actor factory (carla_data_provider.py:412-676) ------------------- #

    @staticmethod
    def create_blueprint(model: str, rolename: str = "scenario",
                         color: Optional[str] = None):
        bp_library = CarlaDataProvider._world.get_blueprint_library()
        candidates = bp_library.filter(model)
        bp = (candidates[CarlaDataProvider._rng.randrange(len(candidates))]
              if candidates else bp_library.find(model))
        if bp.has_attribute("color"):
            bp.set_attribute("color", color or CarlaDataProvider._rng.choice(
                bp.get_attribute("color").recommended_values))
        bp.set_attribute("role_name", rolename)
        return bp

    @staticmethod
    def request_new_actor(model: str, spawn_point, rolename: str = "scenario",
                          autopilot: bool = False, color: Optional[str] = None,
                          tm_port: int = 8000):
        bp = CarlaDataProvider.create_blueprint(model, rolename, color)
        actor = CarlaDataProvider._world.try_spawn_actor(bp, spawn_point)
        if actor is None:
            return None
        if autopilot and hasattr(actor, "set_autopilot"):
            actor.set_autopilot(True, tm_port)
        CarlaDataProvider.register_actor(actor)
        return actor

    @staticmethod
    def request_new_batch_actors(model: str, amount: int, spawn_points,
                                 autopilot: bool = False,
                                 rolename: str = "scenario",
                                 tm_port: int = 8000) -> List:
        """Spawn up to ``amount`` actors over the given points
        (request_new_batch_actors, carla_data_provider.py:622-676 — the RPC
        batch command becomes a loop; failed spawns are skipped)."""
        actors = []
        for transform in list(spawn_points)[:amount]:
            actor = CarlaDataProvider.request_new_actor(
                model, transform, rolename, autopilot, tm_port=tm_port)
            if actor is not None:
                actors.append(actor)
        return actors

    # ---- traffic-light registry (carla_data_provider.py:245-346) ---------- #

    @staticmethod
    def annotate_trafficlight_in_group(traffic_light) -> dict:
        """Classify a junction's light group relative to ``traffic_light``:
        {'ref', 'opposite', 'left', 'right'} by heading difference
        (annotate_trafficlight_in_group, carla_data_provider.py:245-279)."""
        annotations = {"ref": [], "opposite": [], "left": [], "right": []}
        ref_yaw = traffic_light.get_transform().rotation.yaw
        for light in traffic_light.get_group_traffic_lights():
            delta = (light.get_transform().rotation.yaw - ref_yaw + 180.0) \
                % 360.0 - 180.0
            if light.id == traffic_light.id or abs(delta) < 45.0:
                annotations["ref"].append(light)
            elif abs(abs(delta) - 180.0) < 45.0:
                annotations["opposite"].append(light)
            elif delta < 0:
                annotations["right"].append(light)
            else:
                annotations["left"].append(light)
        return annotations

    @staticmethod
    def update_light_states(ego_light, annotations: dict, states: dict,
                            freeze: bool = False, timeout: float = 1e9) -> list:
        """Apply per-direction light states, optionally freezing them
        (update_light_states, carla_data_provider.py:305-335). Returns reset
        parameters for ``reset_lights``."""
        reset_params = []
        for direction, lights in annotations.items():
            state = states.get(direction)
            if state is None:
                continue
            for light in lights:
                reset_params.append({"light": light,
                                     "state": light.get_state()})
                light.set_state(state)
                if freeze:
                    light.set_green_time(timeout)
                    light.freeze(True)
        return reset_params

    @staticmethod
    def reset_lights(reset_params: list) -> None:
        for p in reset_params:
            p["light"].freeze(False)
            p["light"].set_state(p["state"])


# --------------------------------------------------------------------------- #
# World population / maintenance (RouteScenario + expert behaviors)
# --------------------------------------------------------------------------- #

# background vehicles per town (route_scenario.py:449-460)
TOWN_TRAFFIC = {
    "Town01": 120, "Town02": 100, "Town03": 120, "Town04": 200, "Town05": 120,
    "Town06": 150, "Town07": 110, "Town08": 180, "Town09": 300, "Town10": 120,
    "Town10HD": 120,
}

from mmfn_tpu_torch.harness.weather import WEATHER_PRESETS  # noqa: E402  (shared table)


def spawn_background_traffic(client, world, town: str, tm_port: int = 8000):
    """Populate the town with autopilot NPCs (route_scenario.py:444-475),
    batched through the CarlaDataProvider factory like srunner's
    _initialize_actors."""
    amount = TOWN_TRAFFIC.get(town, 120)
    tm = client.get_trafficmanager(tm_port)
    tm.set_synchronous_mode(True)
    if CarlaDataProvider.get_world() is not world:
        CarlaDataProvider.set_client(client)
        CarlaDataProvider.set_world(world)
    return CarlaDataProvider.request_new_batch_actors(
        "vehicle.*", amount, CarlaDataProvider.generate_spawn_points(),
        autopilot=True, rolename="background", tm_port=tm.get_port())


def set_weather(world, preset: str) -> None:
    """Apply a named weather preset (base_agent.py:291-295 randomization)."""
    world.set_weather(getattr(carla.WeatherParameters, preset))


def force_destroy_blockers(world, ego_vehicle, radius: float = 15.0) -> int:
    """Unstick the expert: delete blocking NPCs ahead and force nearby lights
    green (base_agent.py:273-289 / mmfn_ppilot.py:142-145)."""
    import numpy as np

    removed = 0
    ego_loc = ego_vehicle.get_location()
    tf = ego_vehicle.get_transform()
    heading = np.array([math.cos(math.radians(tf.rotation.yaw)),
                        math.sin(math.radians(tf.rotation.yaw))])
    for actor in world.get_actors().filter("vehicle.*"):
        if actor.id == ego_vehicle.id:
            continue
        loc = actor.get_location()
        rel = np.array([loc.x - ego_loc.x, loc.y - ego_loc.y])
        if np.linalg.norm(rel) < radius and rel.dot(heading) > 0:
            actor.destroy()
            removed += 1
    for light in world.get_actors().filter("traffic.traffic_light*"):
        if light.get_location().distance(ego_loc) < 30.0:
            light.set_state(carla.TrafficLightState.Green)
            light.set_green_time(10.0)
    return removed


# --------------------------------------------------------------------------- #
# Evaluation loop
# --------------------------------------------------------------------------- #

def world_view_from_carla(world, ego_vehicle, nearby_dis: float = 30.0):
    """Builds the experts' privileged WorldView from a live CARLA world —
    the CarlaDataProvider-equivalent per-tick snapshot (carla_data_provider.py:
    32-792 caches the same state; here we read it directly under synchronous
    mode, where actor state is stable within a tick)."""
    import numpy as np

    from mmfn_tpu_torch.harness.experts.world_view import Actor, EgoState, WorldView

    tf = ego_vehicle.get_transform()
    vel = ego_vehicle.get_velocity()
    ego = EgoState(position=np.array([tf.location.x, tf.location.y]),
                   velocity=np.array([vel.x, vel.y]),
                   yaw=math.radians(tf.rotation.yaw))

    vehicles, walkers = [], []
    for actor in world.get_actors():
        if actor.id == ego_vehicle.id:
            continue
        tid = actor.type_id
        if not (tid.startswith("vehicle") or tid.startswith("walker.pedestrian")):
            continue
        loc = actor.get_location()
        pos = np.array([loc.x, loc.y])
        if np.linalg.norm(pos - ego.position) > nearby_dis:
            continue
        v = actor.get_velocity()
        a = Actor(position=pos, velocity=np.array([v.x, v.y]),
                  yaw=math.radians(actor.get_transform().rotation.yaw),
                  actor_id=actor.id)
        (walkers if tid.startswith("walker") else vehicles).append(a)

    red_light = False
    if ego_vehicle.is_at_traffic_light():
        state = ego_vehicle.get_traffic_light_state()
        red_light = state in (carla.TrafficLightState.Red,
                              carla.TrafficLightState.Yellow)

    # stop signs: trigger-volume distance + forward-cone test, the reference's
    # MapAgent.get_nearby_lights pattern applied to traffic.stop actors
    # (map_agent.py:38-76)
    stop_sign = False
    for actor in world.get_actors().filter("*traffic.stop*"):
        trigger = actor.get_transform().transform(
            actor.trigger_volume.location)
        pos = np.array([trigger.x, trigger.y])
        rel = pos - ego.position
        dist = float(np.linalg.norm(rel))
        if dist > 12.0:
            continue
        ahead = math.degrees(math.atan2(rel[1], rel[0])) - tf.rotation.yaw
        ahead = (ahead + 180.0) % 360.0 - 180.0
        if abs(ahead) < 60.0:
            stop_sign = True
            break
    return WorldView(ego=ego, vehicles=vehicles, walkers=walkers,
                     red_light=red_light, stop_sign=stop_sign)


class CollisionCriterion:
    """Collision-sensor-backed infractions (atomic_criteria.py CollisionTest)."""

    def __init__(self, world, vehicle):
        self.events: List[TrafficEvent] = []
        bp = world.get_blueprint_library().find("sensor.other.collision")
        self._sensor = world.spawn_actor(bp, carla.Transform(), attach_to=vehicle)
        self._sensor.listen(self._on_collision)

    def _on_collision(self, event) -> None:
        other = event.other_actor
        if "walker" in other.type_id:
            etype = TrafficEventType.COLLISION_PEDESTRIAN
        elif "vehicle" in other.type_id:
            etype = TrafficEventType.COLLISION_VEHICLE
        else:
            etype = TrafficEventType.COLLISION_STATIC
        self.events.append(TrafficEvent(etype, f"collided with {other.type_id}"))

    def stop(self) -> None:
        if self._sensor is not None:
            self._sensor.stop()
            self._sensor.destroy()
            self._sensor = None


def interpolate_route_carla(world_map, keypoints, hop: float = 1.0):
    """Dense route over the road graph via carla's GlobalRoutePlanner
    (route_manipulation.py:132)."""
    from agents.navigation.global_route_planner import GlobalRoutePlanner  # type: ignore

    grp = GlobalRoutePlanner(world_map, hop)
    dense = []
    for a, b in zip(keypoints[:-1], keypoints[1:]):
        loc_a = carla.Location(x=a[0], y=a[1], z=a[2])
        loc_b = carla.Location(x=b[0], y=b[1], z=b[2])
        for wp, option in grp.trace_route(loc_a, loc_b):
            dense.append(((wp.transform.location.x, wp.transform.location.y),
                          RoadOption(int(option))))
    return dense


def run_carla_evaluation(cfg, indexer, statistics, build_agent, endpoint) -> None:
    if not HAS_CARLA:
        raise RuntimeError("simulator: carla requested but the carla package "
                           "is not installed")
    client = carla.Client(cfg.get("host", "localhost"), int(cfg.get("port", 2000)))
    client.set_timeout(float(cfg.get("timeout", 60.0)))

    while indexer.peek():
        config = indexer.next()
        world = client.load_world(config.town)
        settings = world.get_settings()
        settings.fixed_delta_seconds = FIXED_DELTA_SECONDS
        settings.synchronous_mode = True
        world.apply_settings(settings)
        GameTime.restart()
        CarlaDataProvider.cleanup()
        CarlaDataProvider.set_client(client)
        CarlaDataProvider.set_world(world)

        agent = build_agent(cfg)
        dense = interpolate_route_carla(world.get_map(), config.trajectory)
        # linear world-frame encoding, matching the GNSS parser and the
        # native vectorizer's lane frame (docs/PARITY.md gps deviation)
        gps_plan = [({"lat": x / GPS_SCALE[0], "lon": y / GPS_SCALE[1],
                      "z": 0.0}, opt) for (x, y), opt in dense]
        agent.set_global_plan(gps_plan, dense)

        # spawn ego at the first keypoint (route_scenario.py:249)
        bp = world.get_blueprint_library().filter("vehicle.lincoln.mkz2017")[0]
        x0, y0, z0 = config.trajectory[0]
        spawn = world.get_map().get_waypoint(
            carla.Location(x=x0, y=y0, z=z0)).transform
        spawn.location.z += 0.5
        vehicle = world.spawn_actor(bp, spawn)
        CarlaDataProvider.register_actor(vehicle)
        sensors = setup_sensors(agent, vehicle, world)
        collision = CollisionCriterion(world, vehicle)
        route_xy = [p for p, _ in dense]
        criteria = [RouteCompletionCriterion(route_xy), AgentBlockedCriterion(),
                    RouteDeviationCriterion(route_xy)]

        length = route_length(config.trajectory)
        timeout = route_timeout_seconds(length)
        watchdog = Watchdog(timeout=FIXED_DELTA_SECONDS * 40)
        watchdog.start()
        statistics.set_route(config.route_id, config.index)
        t0, game_time, timed_out, failure = time.time(), 0.0, False, ""
        try:
            agent.sensor_interface.register_sensor("privileged")
            while True:
                world.tick()
                snapshot = world.get_snapshot()
                GameTime.on_carla_tick(snapshot.timestamp)
                CarlaDataProvider.on_carla_tick()
                watchdog.update()
                # privileged channel: ground-truth WorldView for the experts
                # (the fake world publishes the same channel, replay.py)
                agent.sensor_interface.update_sensor(
                    "privileged", world_view_from_carla(world, vehicle),
                    GameTime.get_frame())
                control = agent(GameTime.get_time())
                vc = carla.VehicleControl(throttle=float(control.throttle),
                                          steer=float(control.steer),
                                          brake=float(control.brake),
                                          reverse=bool(control.reverse))
                vehicle.apply_control(vc)
                loc = vehicle.get_location()
                vel = vehicle.get_velocity()
                speed = math.hypot(vel.x, vel.y)
                game_time = GameTime.get_time()
                for c in criteria:
                    c.update((loc.x, loc.y), speed, game_time)
                if criteria[0].completed or any(
                        getattr(c, "triggered", False) for c in criteria[1:]):
                    break
                if game_time > timeout or not watchdog.get_status():
                    timed_out = True
                    break
        except Exception as e:  # agent/simulation crash -> recorded failure
            failure = f"Agent crashed: {e}"
        finally:
            watchdog.stop()
            collision.stop()
            for s in sensors:
                if hasattr(s, "stop"):
                    s.stop()
                if hasattr(s, "destroy"):
                    s.destroy()
            vehicle.destroy()
            agent.destroy()

        events = list(collision.events)
        for c in criteria:
            c.terminate()
            events.extend(c.events)
        record = statistics.compute_route_statistics(
            config.index, length, events, time.time() - t0, game_time,
            timed_out=timed_out, failure=failure)
        statistics.save_record(record, config.index, endpoint)
        indexer.save_state(endpoint)

    g = statistics.compute_global_statistics(indexer.total)
    statistics.save_global_record(g, indexer.total, endpoint)
