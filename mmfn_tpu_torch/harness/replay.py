"""CARLA-free closed-loop evaluation: a kinematic fake world + route runner.

The reference's QA relies on driving one smoke route in CARLA
(leaderboard/data/only_one_town.xml, SURVEY.md §4); without a simulator we
close the loop around a bicycle-model ego with synthetic sensors. This
exercises the ENTIRE agent path — opendrive string -> native rough_map_node ->
RoughMap crop -> route planner -> jitted TPU inference -> PID -> control ->
vehicle dynamics -> criteria -> driving score — making it both the integration
test and the template for the real CARLA glue.

GPS convention: readings are (lat, lon) = (x / 111324.60662786,
y / 111319.490945), the inverse of the linear decoding agents apply, so the
agent's recovered position equals the world position exactly.

The port's own copy of the JAX package's ``harness/replay.py``; it draws
from numpy's ``default_rng(seed)`` in the same order, so its frames are the
JAX package's bit for bit; with ``compact_sensors`` it ships the same
``world_state`` frames for the device world (``harness/device_world.py``).
The runner takes the JAX runner's background traffic
(``harness/npc_traffic.py``), ``WeatherSim``, the experts' fault-removal
request, a pre-built scenario manager (``harness/openscenario.py``'s
``OpenScenarioManager``, whose storyboard may stop the episode) and the
episode recorder (``harness/recording.py``), in the JAX runner's order.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from mmfn_tpu_torch.control.planner import GPS_SCALE
from mmfn_tpu_torch.harness.criteria import (
    AgentBlockedCriterion, Criterion, OutsideRouteLanesCriterion, RouteCompletionCriterion,
    RouteDeviationCriterion, RunningRedLightCriterion, RunningStopCriterion,
    route_timeout_seconds, subdivide_lane_ribbon)
from mmfn_tpu_torch.harness.events import TrafficEvent, TrafficEventType
from mmfn_tpu_torch.harness.route import RouteConfig, interpolate_trajectory, route_length
from mmfn_tpu_torch.harness.scenarios import ScenarioManagerLite, check_collision
from mmfn_tpu_torch.harness.statistics import RouteRecord, StatisticsManager

DT = 0.05  # 20 Hz fixed step, matching leaderboard_evaluator.py:203-205


@dataclass
class KinematicWorld:
    """Bicycle-model ego with synthetic sensor frames.

    The camera is random noise by default; pass ``camera_birdview`` (a
    BirdViewProducer) to render a deterministic ego-centric map raster instead,
    giving learned agents a real visual signal in the fake world.
    """

    opendrive_str: str
    start: Tuple[float, float, float]        # x, y, yaw
    seed: int = 0
    lidar_points: int = 1200
    camera_birdview: object = None
    signals: object = None                   # harness.traffic.SignalSet
    actors: list = field(default_factory=list)  # ScenarioActors, set per tick
    # weather preset name (harness.weather.WEATHER_PRESETS): rain degrades
    # the lidar (range loss, return dropout, backscatter clutter) and adds
    # radar clutter — the kinematic analog of CARLA's weather affecting the
    # raycast sensors, so EnvironmentAction/`weather:` have physical meaning
    weather: str = "ClearNoon"
    # compact_sensors=True: skip host sensor synthesis and emit one
    # "world_state" entry per tick (pose, speed, actor and light slabs,
    # weather) for agents that synthesize their sensors on the device
    # (harness/device_world.py): ~260 B a vehicle-tick
    compact_sensors: bool = False
    x: float = field(init=False)
    y: float = field(init=False)
    yaw: float = field(init=False)
    v: float = field(init=False, default=0.0)
    frame: int = field(init=False, default=0)

    MAX_STEER_ANGLE = math.radians(35.0)
    WHEELBASE = 2.9
    MAX_ACCEL = 4.0
    MAX_BRAKE = 8.0
    DRAG = 0.1

    # rain intensity per preset family (0 = dry): drives the sensor
    # degradation below. Values are modeling choices, not CARLA constants —
    # ordered like the preset severity (Wet < SoftRain < MidRain < HardRain).
    RAIN_LEVELS = (("HardRain", 1.0), ("MidRain", 0.6), ("SoftRain", 0.3),
                   ("Wet", 0.15))

    def __post_init__(self):
        self.x, self.y, self.yaw = self.start
        if self.compact_sensors:
            from mmfn_tpu_torch.harness.device_world import GROUND_POINTS
            if self.lidar_points != GROUND_POINTS:
                import warnings
                warnings.warn(
                    f"compact_sensors ignores lidar_points={self.lidar_points}: the "
                    f"device world synthesizes its fixed ground density "
                    f"(device_world.GROUND_POINTS={GROUND_POINTS}); host and device "
                    "sensor statistics will diverge", stacklevel=2)
        self._rng = np.random.default_rng(self.seed)
        self.sun_altitude_deg = 70.0
        # noise-camera pool: the no-birdview camera is information-free
        # noise, but regenerating 480 KB of random bytes per tick was the
        # single largest host cost in the fleet profile
        # (scripts/_fleet_profile.py: ~2 ms/vehicle-tick of the 4.6 total).
        # A small seeded pool served round-robin keeps the signal identical
        # in kind (fresh-looking noise every tick) at ~zero per-tick cost.
        self._noise_pool: Optional[list] = None
        self._noise_dim_cache: Dict[Tuple[int, int], np.ndarray] = {}
        self.set_weather(self.weather)

    def set_weather(self, preset: str, sun_altitude_deg: float = None) -> None:
        """Apply a (possibly animated) weather preset mid-route: rain level
        re-derives from the preset name; a low sun dims the camera (the
        kinematic analog of CARLA's sun_altitude_angle lighting)."""
        self.weather = preset
        self._rain = next((r for key, r in self.RAIN_LEVELS
                           if key in str(preset)), 0.0)
        if sun_altitude_deg is not None:
            self.sun_altitude_deg = float(sun_altitude_deg)
        elif "Sunset" in str(preset):
            self.sun_altitude_deg = min(self.sun_altitude_deg, 10.0)

    def _camera_brightness(self) -> float:
        """1.0 at high sun, dimming toward dusk (floor keeps frames usable)."""
        return max(0.25, min(1.0, 0.25 + 0.75
                             * math.sin(math.radians(
                                 max(0.0, self.sun_altitude_deg)))
                             / math.sin(math.radians(35.0))))

    def tick(self, control) -> None:
        if getattr(control, "reverse", False):
            # reverse gear: throttle accelerates backwards (capped), brake
            # still pushes toward standstill
            accel = (-control.throttle * self.MAX_ACCEL
                     + control.brake * self.MAX_BRAKE - self.DRAG * self.v)
            self.v = float(np.clip(self.v + accel * DT, -3.0, 0.0))
        else:
            accel = (control.throttle * self.MAX_ACCEL
                     - control.brake * self.MAX_BRAKE - self.DRAG * self.v)
            self.v = max(0.0, self.v + accel * DT)
        self.yaw += (self.v / self.WHEELBASE) * math.tan(
            control.steer * self.MAX_STEER_ANGLE) * DT
        self.x += self.v * math.cos(self.yaw) * DT
        self.y += self.v * math.sin(self.yaw) * DT
        self.frame += 1

    # sensor synthesis geometry: the lidar/radar returns reflect the actors
    # in view so learned agents get a real obstacle signal (the reference's
    # sensors are CARLA raycasts; here actor outlines are sampled directly)
    LIDAR_RANGE = 30.0          # actor-return synthesis radius, m
    LIDAR_PER_ACTOR = 40        # outline samples per visible actor
    GROUND_Z = -2.4             # sensor 2.5 m up -> ground in "below" slice
    RADAR_FOV = math.radians(35.0)
    RADAR_RANGE = 100.0
    RADAR_CLUTTER = 20
    RAIN_POINTS = 150           # backscatter cloud size at full rain

    def _ego_frame(self, position: np.ndarray) -> Tuple[float, float]:
        """(lateral, forward) offsets of a world point in the sensor frame
        (pre-y-flip: +forward maps to the BEV's far side after the agents'
        ``points[:, 1] *= -1``)."""
        rel = np.asarray(position, dtype=np.float64) - np.array([self.x, self.y])
        fwd = float(rel @ np.array([math.cos(self.yaw), math.sin(self.yaw)]))
        lat = float(rel @ np.array([math.sin(self.yaw), -math.cos(self.yaw)]))
        return lat, fwd

    def _synth_lidar(self) -> np.ndarray:
        rng = self._rng
        n_ground = self.lidar_points
        ground = np.empty((n_ground, 4), np.float32)
        ground[:, 0] = rng.uniform(-20, 20, n_ground)          # lateral
        ground[:, 1] = rng.uniform(-8, 24, n_ground)           # forward
        ground[:, 2] = self.GROUND_Z + rng.normal(0, 0.05, n_ground)
        ground[:, 3] = rng.uniform(0.2, 0.6, n_ground)         # intensity
        chunks = [ground]
        # rain: range loss (attenuation), per-return dropout, and a
        # backscatter cloud of weak near-range returns — the standard
        # degradation modes of spinning lidars in rain
        lidar_range = self.LIDAR_RANGE * (1.0 - 0.35 * self._rain)
        keep = max(1, int(round(self.LIDAR_PER_ACTOR
                                * (1.0 - 0.45 * self._rain))))
        for a in self.actors:
            if not a.visible_sensors:     # VisibilityAction sensors=false
                continue
            lat, fwd = self._ego_frame(a.position)
            if math.hypot(lat, fwd) > lidar_range:
                continue
            ang = rng.uniform(0, 2 * math.pi, keep)
            r = a.extent * rng.uniform(0.8, 1.0, keep)
            pts = np.empty((keep, 4), np.float32)
            pts[:, 0] = lat + r * np.cos(ang)
            pts[:, 1] = fwd + r * np.sin(ang)
            pts[:, 2] = rng.uniform(-1.8, -0.5, keep)  # body
            pts[:, 3] = rng.uniform(0.4, 0.9, keep)
            chunks.append(pts)
        if self._rain > 0:
            n_rain = int(self.RAIN_POINTS * self._rain)
            rain = np.empty((n_rain, 4), np.float32)
            rain[:, 0] = rng.uniform(-12, 12, n_rain)
            rain[:, 1] = rng.uniform(-12, 12, n_rain)
            rain[:, 2] = rng.uniform(-2.0, 0.0, n_rain)   # above ground
            rain[:, 3] = rng.uniform(0.05, 0.15, n_rain)  # weak returns
            chunks.append(rain)
        return np.concatenate(chunks, axis=0)

    def _synth_radar(self, rear: bool) -> np.ndarray:
        """Rows [velocity, altitude, azimuth, depth] (the parsed CARLA layout,
        sensor_interface.py:169-175); negative velocity = approaching."""
        rng = self._rng
        # radar is the weather-robust modality: actor returns are untouched,
        # rain only thickens the clutter floor (mild, vs the lidar's losses)
        n_clut = int(round(self.RADAR_CLUTTER * (1.0 + self._rain)))
        clutter = np.empty((n_clut, 4), np.float32)
        clutter[:, 0] = rng.normal(0, 0.05 * (1 + self._rain), n_clut)
        clutter[:, 1] = rng.normal(0, 0.02, n_clut)
        clutter[:, 2] = rng.uniform(-self.RADAR_FOV / 2, self.RADAR_FOV / 2,
                                    n_clut)
        clutter[:, 3] = rng.uniform(5, self.RADAR_RANGE, n_clut)
        rows = [clutter]
        face_yaw = self.yaw + (math.pi if rear else 0.0)
        face = np.array([math.cos(face_yaw), math.sin(face_yaw)])
        side = np.array([math.sin(face_yaw), -math.cos(face_yaw)])
        ego_vel = self.v * np.array([math.cos(self.yaw), math.sin(self.yaw)])
        for a in self.actors:
            if not a.visible_sensors:     # VisibilityAction sensors=false
                continue
            rel = np.asarray(a.position, dtype=np.float64) \
                - np.array([self.x, self.y])
            depth = float(np.linalg.norm(rel))
            if not 0.5 < depth < self.RADAR_RANGE:
                continue
            azimuth = math.atan2(float(rel @ side), float(rel @ face))
            if abs(azimuth) > self.RADAR_FOV / 2:
                continue
            closing = float((rel / depth) @ (np.asarray(a.velocity) - ego_vel))
            altitude = math.atan2(-1.0 + 0.1 * (a.actor_id % 5), depth)
            rows.append(np.array(
                [[closing, altitude, azimuth, depth]], np.float32))
        return np.concatenate(rows, axis=0)

    def sensor_frame(self) -> Dict[str, Tuple[int, object]]:
        f = self.frame
        rng = self._rng
        gps = np.array([self.x / GPS_SCALE[0], self.y / GPS_SCALE[1], 0.0])
        imu = np.array([0.0, 0.0, 9.81, 0.0, 0.0, 0.0, self.yaw])
        if self.compact_sensors:
            from mmfn_tpu_torch.harness.device_world import actor_slab_np, light_slab_np

            ego_xy = np.array([self.x, self.y])
            slab, slab_valid = actor_slab_np(self.actors, ego_xy)
            lights = light_slab_np(self.signals.light_states(f * DT)
                                   if self.signals is not None else None, ego_xy)
            data = {
                "gps": (f, gps),
                "imu": (f, imu),
                "speed": (f, {"speed": self.v}),
                "world_state": (f, {
                    "pose": np.array([self.x, self.y, self.yaw], np.float32),
                    "speed": self.v,
                    "actors": slab,
                    "actors_valid": slab_valid,
                    "lights": lights,
                    "rain": self._rain,
                    "brightness": self._camera_brightness(),
                    "frame": f,
                }),
            }
            if f == 0:
                data["opendrive"] = (f, {"opendrive": self.opendrive_str})
            return data
        lidar = self._synth_lidar()
        if self.camera_birdview is not None:
            from mmfn_tpu_torch.mapping.birdview import BirdViewProducer

            lights = (self.signals.light_states(f * DT)
                      if self.signals is not None else None)
            def box(a):
                return (float(a.position[0]), float(a.position[1]),
                        float(a.yaw), 2 * float(a.extent), 1.4 * float(a.extent))

            drawn = [a for a in self.actors if a.visible_graphics]
            boxes = [box(a) for a in drawn if a.kind != "walker"]
            walker_boxes = [box(a) for a in drawn if a.kind == "walker"]
            raster = BirdViewProducer.as_rgb(
                self.camera_birdview.produce([self.x, self.y, self.yaw],
                                             actors=boxes, lights=lights,
                                             walkers=walker_boxes))
            # the img variant's map stream: the reference's e2e img agent
            # rebuilds this raster host-side every tick (mmfn_imgnet.py:
            # 129-245); the fake world ships it as a pseudo-sensor instead
            # (undimmed — a map, not a camera)
            map_raster = raster
            raster = (raster * self._camera_brightness()).astype(np.uint8)
            rgb = np.zeros((300, 400, 4), np.uint8)
            rgb[22:278, 72:328, :3] = raster[..., ::-1]  # BGR like CARLA frames
        else:
            if self._noise_pool is None:
                self._noise_pool = [
                    rng.integers(0, 255, size=(300, 400, 4), dtype=np.uint8)
                    for _ in range(4)]
            k = f % len(self._noise_pool)
            bright = self._camera_brightness()
            if bright >= 0.999:
                rgb = self._noise_pool[k]
            else:
                # quantize brightness to 1/64 so dimmed frames cache too
                qb = int(round(bright * 64))
                rgb = self._noise_dim_cache.get((k, qb))
                if rgb is None:
                    rgb = (self._noise_pool[k] * (qb / 64.0)).astype(np.uint8)
                    self._noise_dim_cache[(k, qb)] = rgb
                    if len(self._noise_dim_cache) > 64:
                        self._noise_dim_cache.clear()
        data = {
            "rgb": (f, rgb),
            "lidar": (f, lidar),
            "radar_front": (f, self._synth_radar(rear=False)),
            "radar_rear": (f, self._synth_radar(rear=True)),
            "gps": (f, gps),
            "imu": (f, imu),
            "speed": (f, {"speed": self.v}),
        }
        if self.camera_birdview is not None:
            data["map_raster"] = (f, map_raster)
        if f == 0:
            data["opendrive"] = (f, {"opendrive": self.opendrive_str})
        return data


def plan_from_trajectory(trajectory) -> Tuple[list, list]:
    """Dense-interpolate keypoints and produce (gps_plan, world_plan) the way
    the evaluator hands them to agents (route gps encoded with the linear
    convention above)."""
    dense = interpolate_trajectory(trajectory, hop_resolution=1.0)
    world_plan = [((x, y), opt) for (x, y), opt in dense]
    gps_plan = [({"lat": x / GPS_SCALE[0], "lon": y / GPS_SCALE[1], "z": 0.0}, opt)
                for (x, y), opt in dense]
    return gps_plan, world_plan


def route_environment(rough_map, trajectory, traffic: int = 0, seed: int = 0):
    """(signals, background) for a route on a vectorized map — the shared
    assembly every entry point needs: traffic lights derived from the map's
    signal-controlled nodes along the route, and optional ambient NPC traffic
    gated by those lights."""
    if rough_map is None:
        return None, None
    from mmfn_tpu_torch.harness.traffic import signals_from_rough_map

    _, world_plan = plan_from_trajectory(trajectory)
    signals = signals_from_rough_map(rough_map, [p for p, _ in world_plan])
    return signals, background_traffic(rough_map, trajectory, traffic, seed, signals)


def background_traffic(rough_map, trajectory, amount: int, seed: int, signals):
    """``amount`` ambient NPC vehicles on the map's lanes, kept clear of the
    route's start and gated by ``signals`` (None for no lights); None when
    ``amount`` is 0."""
    if amount <= 0:
        return None
    from mmfn_tpu_torch.harness.npc_traffic import BackgroundTraffic

    return BackgroundTraffic([lane.nodes for lane in rough_map.lanes], amount, seed=seed,
                             signals=signals, ego_start=trajectory[0][:2])


class _AgentCrash(Exception):
    """Thrown into the route generator when the agent callable raised; the
    generator converts it into a scored failure (leaderboard semantics,
    leaderboard_evaluator.py:279-384)."""

    def __init__(self, cause: Exception):
        super().__init__(str(cause))
        self.cause = cause


class ClosedLoopRunner:
    """Drives one agent through one route in the fake world and scores it.

    The per-tick body lives in the :meth:`drive` generator (yields the game
    time whenever a control is needed, receives the control via ``send``);
    :meth:`run_route` drives one agent synchronously, while
    `harness.fleet.FleetRunner` drives many route generators in lockstep with
    one batched device forward per tick.
    """

    def __init__(self, statistics: Optional[StatisticsManager] = None,
                 max_wall_seconds: float = 120.0):
        self.statistics = statistics or StatisticsManager()
        self.max_wall_seconds = max_wall_seconds

    def run_route(self, agent, config: RouteConfig, opendrive_str: str,
                  max_ticks: Optional[int] = None,
                  triggers: Optional[list] = None,
                  rough_map=None,
                  signals=None,
                  background=None,
                  world_kwargs: Optional[dict] = None,
                  scenario_manager=None,
                  recorder=None,
                  weather_sim=None) -> RouteRecord:
        """triggers: optional ScenarioTrigger list -> adversarial events are
        activated along the route and collisions are scored.
        rough_map: optional mmfn_tpu_torch.mapping.RoughMap -> enables the
        outside-route-lanes percentage penalty.
        signals: optional harness.traffic.SignalSet -> traffic lights / stop
        signs gate the expert (privileged channel), are drawn by the birdview
        camera and are scored by the RunningRedLight / RunningStop criteria.
        background: optional harness.npc_traffic.BackgroundTraffic -> ambient
        lane-following vehicles (the reference's 120-300 background actors,
        route_scenario.py:444-475) are stepped each tick, shown to the expert,
        and scored on collision.
        scenario_manager: optional pre-built manager (e.g.
        harness.openscenario.OpenScenarioManager) used instead of the
        trigger-list ScenarioManagerLite; if it exposes ``stop_triggered()``
        (OpenSCENARIO storyboard stop trigger) the episode ends there.
        recorder: optional harness.recording.EpisodeRecorder -> every tick's
        ground truth (actors, control, lights, collisions) plus the criteria
        summary is captured for post-hoc metrics (the srunner
        ``--record`` + metrics_manager.py analog).
        weather_sim: optional harness.weather.WeatherSim -> the sun position
        evolves over game time and the live preset drives the fake world's
        sensor synthesis (srunner WeatherBehavior, weather_sim.py:91-152).
        An agent with ``consume_unblock_request`` (the expert) may ask, once
        a tick, for blockers within 15 m to be removed and the lights forced
        green."""
        gen = self.drive(agent, config, opendrive_str, max_ticks=max_ticks,
                         triggers=triggers, rough_map=rough_map,
                         signals=signals, background=background,
                         world_kwargs=world_kwargs,
                         scenario_manager=scenario_manager,
                         recorder=recorder, weather_sim=weather_sim)
        try:
            game_time = next(gen)
            while True:
                try:
                    control = agent(game_time)
                except Exception as e:  # agent crash -> scored failure
                    gen.throw(_AgentCrash(e))
                game_time = gen.send(control)
        except StopIteration as stop:
            return stop.value

    def drive(self, agent, config: RouteConfig, opendrive_str: str,
              max_ticks: Optional[int] = None,
              triggers: Optional[list] = None,
              rough_map=None,
              signals=None,
              background=None,
              world_kwargs: Optional[dict] = None,
              scenario_manager=None,
              recorder=None,
              weather_sim=None):
        """Generator form of :meth:`run_route` (same arguments): writes the
        tick's sensor frames into ``agent.sensor_interface``, yields the game
        time, and expects the agent's control via ``send``; its return value
        (StopIteration.value) is the scored RouteRecord."""
        trajectory = config.trajectory
        gps_plan, world_plan = plan_from_trajectory(trajectory)
        agent.set_global_plan(gps_plan, world_plan)

        x0, y0 = trajectory[0][:2]
        x1, y1 = trajectory[1][:2] if len(trajectory) > 1 else (x0 + 1, y0)
        world = KinematicWorld(opendrive_str, (x0, y0, math.atan2(y1 - y0, x1 - x0)),
                               **(world_kwargs or {}))
        if signals is not None and world.signals is None:
            world.signals = signals   # camera renders 3-state light markers

        route_xy = [p for p, _ in world_plan]
        length = route_length(trajectory)
        criteria: List[Criterion] = [
            RouteCompletionCriterion(route_xy),
            AgentBlockedCriterion(),
            RouteDeviationCriterion(route_xy),
        ]
        if rough_map is not None:
            criteria.append(OutsideRouteLanesCriterion(
                [lane.nodes for lane in rough_map.lanes],
                [lane.widths for lane in rough_map.lanes]))
        if signals is not None:
            criteria.append(RunningRedLightCriterion(signals.lights))
            criteria.append(RunningStopCriterion(signals.stop_signs))
        timeout = route_timeout_seconds(length)
        max_ticks = max_ticks or int(timeout / DT)

        if scenario_manager is not None and triggers:
            raise ValueError("pass either scenario_manager or triggers, not "
                             "both — the manager replaces the trigger list")
        scenario_mgr = scenario_manager or ScenarioManagerLite(triggers or [])
        # auto-wire world context into a manager left unwired: 'signal'
        # conditions need the SignalSet, alongRoute 'distance' conditions
        # need the ego route polyline
        if getattr(scenario_mgr, "signals", "absent") is None:
            scenario_mgr.signals = signals
        if getattr(scenario_mgr, "route_xy", "absent") is None:
            scenario_mgr.route_xy = route_xy
        # the world-service atoms (ChangeWeather, TimeOfDayComparison) reach
        # the fake world / WeatherSim the same way
        if getattr(scenario_mgr, "world", "absent") is None:
            scenario_mgr.world = world
        if getattr(scenario_mgr, "weather_sim", "absent") is None:
            scenario_mgr.weather_sim = weather_sim
        # lane-topology atoms (next-intersection distance, rightmost lane)
        # query the vectorized map the way srunner queries the Waypoint API
        if getattr(scenario_mgr, "rough_map", "absent") is None:
            scenario_mgr.rough_map = rough_map
        # OSC OffroadCondition needs the drivable-lane ribbon (same geometry
        # as OutsideRouteLanesCriterion)
        if getattr(scenario_mgr, "lane_ribbon", "absent") is None \
                and rough_map is not None:
            scenario_mgr.lane_ribbon = subdivide_lane_ribbon(
                [lane.nodes for lane in rough_map.lanes],
                [lane.widths for lane in rough_map.lanes])
        collision_events: List[TrafficEvent] = []
        collided_ids = set()
        if recorder is not None:
            recorder.start(opendrive_str, DT, config.route_id, signals=signals)

        self.statistics.set_route(config.route_id, config.index)
        t_start = time.time()
        game_time = 0.0
        timed_out = False
        failure = ""
        for _ in range(max_ticks):
            if weather_sim is not None:   # WeatherBehavior per-tick update
                world.set_weather(weather_sim.update(game_time),
                                  weather_sim.sun_altitude_deg)
            scenario_actors = scenario_mgr.tick(np.array([world.x, world.y]), DT)
            n_scenario = len(scenario_actors)
            if background is not None:
                # an actor hidden from traffic (visible_traffic false) is no
                # obstacle to the NPCs
                scenario_actors = scenario_actors + background.tick(
                    np.array([world.x, world.y]), world.v, DT,
                    game_time=game_time,
                    other_actors=[a for a in scenario_actors
                                  if a.visible_traffic])
            world.actors = scenario_actors   # sensors reflect the live actors
            frame = world.sensor_frame()
            # privileged channel: ground-truth ego + scenario actors, consumed
            # by rule-based experts (the leaderboard gives experts direct world
            # access; the fake world provides it explicitly). It is the last
            # entry, so the agents' sensor mux reads the opendrive entry on
            # the first tick, as in the JAX package.
            red_light = stop_sign = False
            if signals is not None:
                red_light, stop_sign = signals.gating(
                    np.array([world.x, world.y]), world.yaw, game_time)
            light_states = (signals.light_states(game_time)
                            if signals is not None else [])
            frame["privileged"] = (world.frame, {
                "ego": (world.x, world.y, world.yaw, world.v),
                "actors": scenario_actors,
                "red_light": red_light,
                "stop_sign": stop_sign,
                "light_states": light_states,
            })
            for tag, (f, payload) in frame.items():
                if tag not in agent.sensor_interface._sensors:
                    if tag == "opendrive":
                        agent.sensor_interface.register_opendrive(tag)
                    else:
                        agent.sensor_interface.register_sensor(tag)
                agent.sensor_interface.update_sensor(tag, payload, f)
            try:
                control = yield game_time
            except _AgentCrash as e:  # thrown in by run_route or the fleet
                failure = f"Agent crashed: {e.cause}"
                break
            noise = scenario_mgr.steer_noise()
            if noise:
                control.steer = float(np.clip(control.steer + noise, -1.0, 1.0))
            # fault removal (force_destory_actor analog): a stop-counter-
            # triggered request deletes blockers and forces lights green
            if getattr(agent, "consume_unblock_request", None) is not None \
                    and agent.consume_unblock_request():
                scenario_mgr.remove_actors_near(
                    np.array([world.x, world.y]), radius=15.0)
                if background is not None:
                    background.remove_near(
                        np.array([world.x, world.y]), radius=15.0)
                if signals is not None:
                    signals.force_green(game_time, duration=10.0)
            if recorder is not None:
                recorder.record_tick(game_time, time.time() - t_start, world,
                                     scenario_actors, n_scenario, control,
                                     light_states)
            world.tick(control)
            game_time += DT
            position = (world.x, world.y)
            hit = check_collision(np.asarray(position), world.yaw, scenario_actors)
            if hit is not None and hit.actor_id not in collided_ids:
                collided_ids.add(hit.actor_id)
                if recorder is not None:
                    recorder.record_collision(hit.actor_id)
                etype = (TrafficEventType.COLLISION_PEDESTRIAN if hit.kind == "walker"
                         else TrafficEventType.COLLISION_VEHICLE)
                collision_events.append(TrafficEvent(
                    etype, f"collided with scenario {hit.kind} {hit.actor_id}"))
            for c in criteria:
                c.update(position, abs(world.v), game_time)
            if criteria[0].completed:
                break
            if getattr(scenario_mgr, "stop_triggered", None) is not None \
                    and scenario_mgr.stop_triggered():
                break
            if any(getattr(c, "triggered", False) for c in criteria[1:]):
                break
            if game_time > timeout:
                timed_out = True
                break
            if time.time() - t_start > self.max_wall_seconds:
                timed_out = True
                break
        else:
            # ticks exhausted without completing: the default max_ticks IS
            # the timeout budget (int(timeout/DT) iterations never push
            # game_time past timeout except by float drift) — record it as
            # the timeout it is, not an anonymous failure
            timed_out = True

        events: List[TrafficEvent] = list(collision_events)
        for c in criteria:
            c.terminate()
            events.extend(c.events)

        record = self.statistics.compute_route_statistics(
            config.index, length, events,
            duration_time_system=time.time() - t_start,
            duration_time_game=game_time,
            timed_out=timed_out, failure=failure)
        if recorder is not None:
            recorder.finish(criteria, record)
        return record
