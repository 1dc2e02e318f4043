"""Post-hoc metrics over episode recordings — the srunner metrics analog.

The reference vendors scenario_runner's metrics module: ``MetricsLog`` wraps a
CARLA recorder log with per-actor/per-frame query methods and user metrics
subclass ``BasicMetric`` (reference srunner/metrics/tools/metrics_log.py:20-416,
srunner/metrics/examples/basic_metric.py:13-43, driven by
scenario_runner/metrics_manager.py:31-120). CARLA replays the binary log
through the simulator to answer queries; here the recording
(`harness.recording`, a self-contained JSON document) is parsed once into
columnar numpy arrays per actor, so every "all frames" query is a slice — no
simulator, no per-frame RPC.

API parity: the method names and semantics below match the reference's
MetricsLog for everything the fake world represents (transforms, velocities,
angular velocity, acceleration, alive frames, role/type lookups, vehicle
controls, walker speed, traffic-light state/freeze/phase/trigger geometry,
physics envelopes, vehicle light flags, scene lighting, collisions, frame
times). Angular velocity and acceleration are finite-differenced from the
recorded states — the recorder stores the kinematic ground truth, not sensor
estimates. The CARLA-only surfaces map onto fake-world analogs rather than
being omitted: ``get_vehicle_physics_control`` returns the kinematic motion
envelope the recorder captured, ``get_vehicle_lights`` derives
carla.VehicleLightState-style flags (Brake/Reverse from the recorded
control and velocities, Position/LowBeam from the recorded weather — CARLA's
automatic-lights behavior), and ``get_scene_light_state`` reports the
day-night street lighting CARLA toggles at dusk, driven by the recorded
preset's time-of-day suffix.

The port's own copy of the JAX package's ``harness/metrics_log.py``. A
metric file subclasses the port's ``BasicMetric``; the port ships its own
copies of the example metrics in ``harness/metric_examples/``, and
``load_metric_class`` refuses a file that imports ``mmfn_tpu`` or ``jax``
before running any of it.
"""

from __future__ import annotations

import importlib.util
import inspect
import math
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from mmfn_tpu_torch.harness.recording import EpisodeRecorder


class MetricsLog:
    """Query interface over one ``mmfn_tpu-episode-v1`` recording."""

    def __init__(self, recording):
        """recording: a dict (EpisodeRecorder.data) or a path to one."""
        if isinstance(recording, str):
            recording = EpisodeRecorder.load(recording)
        self._rec = recording
        self._dt = float(recording["dt"])
        self._actors = recording["actors"]
        frames = recording["frames"]
        self._times = np.array([f["time"] for f in frames])
        self._platform = np.array([f["platform_time"] for f in frames])
        self._controls = np.array([f["control"] for f in frames]
                                  or np.zeros((0, 3)))
        self._lights = [f["lights"] for f in frames]
        self._lights_frozen = [f.get("lights_frozen", []) for f in frames]
        self._lights_meta = recording.get("lights_meta", [])
        # columnar per-actor state over the alive span: [x, y, yaw, vx, vy]
        self._states: Dict[str, np.ndarray] = {}
        for aid, meta in self._actors.items():
            n = meta["last_frame"] - meta["first_frame"] + 1
            arr = np.full((n, 5), np.nan)
            for i in range(n):
                s = frames[meta["first_frame"] + i]["states"].get(aid)
                if s is not None:
                    arr[i] = s
            self._states[aid] = arr
        self._collisions: Dict[str, Dict[int, int]] = {}
        for fi, f in enumerate(frames):
            for other in f["collisions"]:
                self._collisions.setdefault("0", {})[fi] = int(other)

    # -- frame/time queries (metrics_log.py:52-79) -------------------------

    def get_total_frame_count(self) -> int:
        return len(self._times)

    def get_elapsed_time(self, frame: int) -> float:
        return float(self._times[frame])

    def get_delta_time(self, frame: int) -> float:
        return self._dt

    def get_platform_time(self, frame: int) -> float:
        return float(self._platform[frame])

    # -- actor lookups (metrics_log.py:81-181) ------------------------------

    def get_ego_vehicle_id(self) -> int:
        return self.get_actor_ids_with_role_name("hero")[0]

    def get_actor_ids_with_role_name(self, role_name: str) -> List[int]:
        return [int(aid) for aid, m in self._actors.items()
                if m["role_name"] == role_name]

    def get_actor_ids_with_type_id(self, type_pattern: str) -> List[int]:
        """Prefix/wildcard match as in the reference (fnmatch semantics)."""
        import fnmatch
        return [int(aid) for aid, m in self._actors.items()
                if fnmatch.fnmatch(m["type_id"], type_pattern)]

    def get_actor_attributes(self, actor_id: int) -> Optional[dict]:
        m = self._actors.get(str(actor_id))
        return dict(m) if m else None

    def get_actor_bounding_box(self, actor_id: int) -> Optional[float]:
        """Half-extent (m) of the actor's footprint (the fake world's actors
        are discs/squares; CARLA's 3-D box reduces to this)."""
        m = self._actors.get(str(actor_id))
        return float(m["extent"]) if m else None

    def get_actor_alive_frames(self, actor_id: int) -> Tuple[int, int]:
        m = self._actors[str(actor_id)]
        return m["first_frame"], m["last_frame"]

    # -- per-frame state (metrics_log.py:184-358) ---------------------------

    def _state(self, actor_id: int, frame: int) -> Optional[np.ndarray]:
        m = self._actors.get(str(actor_id))
        if m is None or not (m["first_frame"] <= frame <= m["last_frame"]):
            return None
        row = self._states[str(actor_id)][frame - m["first_frame"]]
        return None if np.isnan(row[0]) else row

    def _all_states(self, actor_id: int, first_frame=None, last_frame=None):
        m = self._actors[str(actor_id)]
        lo = m["first_frame"] if first_frame is None else first_frame
        hi = m["last_frame"] if last_frame is None else last_frame
        lo, hi = max(lo, m["first_frame"]), min(hi, m["last_frame"])
        return self._states[str(actor_id)][lo - m["first_frame"]:
                                           hi - m["first_frame"] + 1]

    def get_actor_transform(self, actor_id: int, frame: int):
        """(x, y, yaw) or None if the actor isn't alive at ``frame``."""
        s = self._state(actor_id, frame)
        return None if s is None else (float(s[0]), float(s[1]), float(s[2]))

    def get_all_actor_transforms(self, actor_id: int, first_frame=None,
                                 last_frame=None) -> np.ndarray:
        """[n, 3] array of (x, y, yaw) over the (clamped) frame span."""
        return self._all_states(actor_id, first_frame, last_frame)[:, :3]

    def get_actor_transforms_at_frame(self, frame: int,
                                      actor_list=None) -> Dict[int, tuple]:
        ids = actor_list or [int(a) for a in self._actors]
        out = {}
        for aid in ids:
            t = self.get_actor_transform(aid, frame)
            if t is not None:
                out[aid] = t
        return out

    def get_actor_velocity(self, actor_id: int, frame: int):
        s = self._state(actor_id, frame)
        return None if s is None else (float(s[3]), float(s[4]))

    def get_all_actor_velocities(self, actor_id: int, first_frame=None,
                                 last_frame=None) -> np.ndarray:
        return self._all_states(actor_id, first_frame, last_frame)[:, 3:5]

    def get_actor_velocities_at_frame(self, frame: int,
                                      actor_list=None) -> Dict[int, tuple]:
        ids = actor_list or [int(a) for a in self._actors]
        out = {}
        for aid in ids:
            v = self.get_actor_velocity(aid, frame)
            if v is not None:
                out[aid] = v
        return out

    def get_actor_angular_velocity(self, actor_id: int, frame: int):
        """Yaw rate (rad/s), central-differenced from recorded headings."""
        a = self._state(actor_id, frame)
        if a is None:
            return None
        b = self._state(actor_id, frame - 1)
        if b is None:
            return 0.0
        dyaw = (a[2] - b[2] + math.pi) % (2 * math.pi) - math.pi
        return float(dyaw / self._dt)

    def get_all_actor_angular_velocities(self, actor_id: int,
                                         first_frame=None,
                                         last_frame=None) -> np.ndarray:
        """[n] yaw rates over the span (first entry 0, like the per-frame
        query at the actor's first alive frame)."""
        yaw = self._all_states(actor_id, first_frame, last_frame)[:, 2]
        dyaw = (np.diff(yaw) + math.pi) % (2 * math.pi) - math.pi
        return np.concatenate([[0.0], dyaw / self._dt])

    def get_actor_angular_velocities_at_frame(self, frame: int,
                                              actor_list=None
                                              ) -> Dict[int, float]:
        ids = actor_list or [int(a) for a in self._actors]
        out = {}
        for aid in ids:
            w = self.get_actor_angular_velocity(aid, frame)
            if w is not None:
                out[aid] = w
        return out

    def get_actor_acceleration(self, actor_id: int, frame: int):
        """(ax, ay) m/s^2, backward-differenced from recorded velocities."""
        a = self._state(actor_id, frame)
        b = self._state(actor_id, frame - 1)
        if a is None:
            return None
        if b is None:
            return (0.0, 0.0)
        return (float((a[3] - b[3]) / self._dt),
                float((a[4] - b[4]) / self._dt))

    def get_all_actor_accelerations(self, actor_id: int, first_frame=None,
                                    last_frame=None) -> np.ndarray:
        """[n, 2] (ax, ay) over the span (first entry 0)."""
        v = self._all_states(actor_id, first_frame, last_frame)[:, 3:5]
        return np.concatenate([np.zeros((1, 2)),
                               np.diff(v, axis=0) / self._dt])

    def get_actor_accelerations_at_frame(self, frame: int,
                                         actor_list=None) -> Dict[int, tuple]:
        ids = actor_list or [int(a) for a in self._actors]
        out = {}
        for aid in ids:
            acc = self.get_actor_acceleration(aid, frame)
            if acc is not None:
                out[aid] = acc
        return out

    def get_vehicle_control(self, vehicle_id: int, frame: int):
        """(steer, throttle, brake) — recorded for the ego only (the fake
        world's other actors are kinematic, they have no control channel)."""
        if int(vehicle_id) != self.get_ego_vehicle_id():
            return None
        c = self._controls[frame]
        return (float(c[0]), float(c[1]), float(c[2]))

    def get_vehicle_physics_control(self, vehicle_id: int, frame: int):
        """Kinematic motion envelope of the vehicle — the
        carla.VehiclePhysicsControl analog (reference metrics_log.py:342
        scans recorder physics events backward from ``frame``; the fake
        world's envelopes are static so the recorder captures them once at
        registration). dict(max_accel, max_brake[, drag]) or None."""
        m = self._actors.get(str(vehicle_id))
        if m is None or "physics_control" not in m:
            return None
        if not (m["first_frame"] <= frame):   # not yet registered at frame
            return None
        return dict(m["physics_control"])

    def get_walker_speed(self, walker_id: int, frame: int):
        """Walker speed (m/s) at ``frame`` (reference metrics_log.py:356 —
        CARLA records walker speed as a scalar; here it is the norm of the
        recorded velocity). None when not alive or not a walker."""
        m = self._actors.get(str(walker_id))
        if m is None or m["kind"] != "walker":
            return None
        v = self.get_actor_velocity(walker_id, frame)
        return None if v is None else float(math.hypot(v[0], v[1]))

    # -- traffic lights (metrics_log.py:363-396) -----------------------------

    def get_traffic_light_state(self, light_index: int,
                                frame: int) -> Optional[str]:
        lights = self._lights[frame]
        return lights[light_index] if light_index < len(lights) else None

    def get_traffic_light_elapsed_time(self, light_index: int,
                                       frame: int) -> Optional[float]:
        """Seconds the light has held its state at ``frame``."""
        state = self.get_traffic_light_state(light_index, frame)
        if state is None:
            return None
        f = frame
        while f > 0 and self.get_traffic_light_state(light_index,
                                                     f - 1) == state:
            f -= 1
        return (frame - f) * self._dt

    def is_traffic_light_frozen(self, light_index: int, frame: int) -> bool:
        """Whether a hold overrides the light's phase cycle at ``frame`` —
        a fault-removal force-green grant or a scenario's
        TrafficLightStateSetter (reference metrics_log.py:369 reads the
        recorded carla TrafficLight.freeze flag)."""
        flags = self._lights_frozen[frame]
        return bool(flags[light_index]) if light_index < len(flags) else False

    def get_traffic_light_state_time(self, light_index: int, state: str,
                                     frame: int) -> Optional[float]:
        """Configured duration (s) of the light's ``state`` phase (reference
        metrics_log.py:381 returns the recorded green_time/yellow_time/
        red_time; the fake world's phase splits are static per light).
        ``frame`` is accepted for signature parity."""
        if light_index >= len(self._lights_meta):
            return None
        meta = self._lights_meta[light_index]
        key = state.lower()
        return float(meta[key]) if key in ("green", "yellow", "red") else None

    def get_traffic_light_trigger_volume(self, light_index: int
                                         ) -> Optional[dict]:
        """Stop-line trigger geometry of the light (reference
        metrics_log.py:146 returns the actor's carla trigger_volume):
        dict(x, y, yaw, trigger_distance, lateral_half_width) — the gating
        box TrafficLight.gates tests, in world coordinates."""
        if light_index >= len(self._lights_meta):
            return None
        m = self._lights_meta[light_index]
        return {k: m[k] for k in ("x", "y", "yaw", "trigger_distance",
                                  "lateral_half_width")}

    def get_weather(self, frame: int) -> str:
        """Weather preset in effect at ``frame`` (animates under a
        WeatherSim; empty for recordings made before weather capture)."""
        return str(self._rec["frames"][frame].get("weather", ""))

    # -- vehicle / scene lights (metrics_log.py:398-416) ---------------------

    NPC_BRAKE_THRESHOLD = 1.0     # m/s^2 of decel that lights NPC brake lamps

    def _lights_weather_on(self, frame: int) -> bool:
        """CARLA's automatic light manager turns on Position/LowBeam in rain
        and from dusk; the recorded preset name carries both signals."""
        preset = self.get_weather(frame)
        return ("Rain" in preset or preset.endswith("Sunset")
                or preset.endswith("Night"))

    def get_vehicle_lights(self, vehicle_id: int,
                           frame: int) -> Optional[List[str]]:
        """carla.VehicleLightState-style flags at ``frame`` (reference
        metrics_log.py:398 returns the recorded light state). The fake
        world's lamps are derived from recorded ground truth: Brake from the
        ego's brake pedal / an NPC's longitudinal deceleration, Reverse from
        the ego's reverse gear (v < 0), Position+LowBeam from the recorded
        weather (rain or dusk). None when not a live vehicle at ``frame``."""
        m = self._actors.get(str(vehicle_id))
        if m is None or m["kind"] != "vehicle":
            return None
        s = self._state(vehicle_id, frame)
        if s is None:
            return None
        lights = []
        if int(vehicle_id) == self.get_ego_vehicle_id():
            c = self._controls[frame]
            if float(c[2]) > 0.0:
                lights.append("Brake")
            heading_v = (s[3] * math.cos(s[2]) + s[4] * math.sin(s[2]))
            if heading_v < -1e-3:
                lights.append("Reverse")
        else:
            prev = self._state(vehicle_id, frame - 1)
            if prev is not None:
                dv = (math.hypot(s[3], s[4])
                      - math.hypot(prev[3], prev[4])) / self._dt
                if dv < -self.NPC_BRAKE_THRESHOLD:
                    lights.append("Brake")
        if self._lights_weather_on(frame):
            lights.extend(["Position", "LowBeam"])
        return lights

    def is_vehicle_light_active(self, light: str, vehicle_id: int,
                                frame: int) -> bool:
        lights = self.get_vehicle_lights(vehicle_id, frame)
        return lights is not None and light in lights

    def get_scene_light_state(self, light_id: int,
                              frame: int) -> Optional[dict]:
        """Street lighting at ``frame`` (reference metrics_log.py:416 returns
        the recorded carla.LightState). CARLA toggles street lamps as a group
        at dusk; the analog derives is_on from the recorded preset's
        time-of-day. ``light_id`` is accepted for signature parity (all
        street lights switch together)."""
        preset = self.get_weather(frame)
        if not preset:
            return None
        is_on = preset.endswith("Sunset") or preset.endswith("Night")
        return {"is_on": bool(is_on),
                "intensity": 100.0 if is_on else 0.0,
                "group": "Street"}

    # -- collisions (metrics_log.py:34-50) -----------------------------------

    def get_actor_collisions(self, actor_id: int) -> Dict[int, int]:
        """{frame: other_actor_id} for the actor's recorded collisions."""
        return dict(self._collisions.get(str(actor_id), {}))

    # -- criteria ------------------------------------------------------------

    def get_criteria(self) -> dict:
        return dict(self._rec.get("criteria", {}))


class BasicMetric:
    """Base class of user metrics (basic_metric.py:13-43): subclasses
    implement ``_create_metric(town_map, log, criteria)``; instantiation runs
    it. ``town_map`` is the vectorized map (`mapping.RoughMap`) — the
    Waypoint-API analog — or None when the runner was asked to skip it.
    ``self.out_dir`` is where metrics should write their outputs."""

    out_dir = "."

    def __init__(self, town_map, log: MetricsLog, criteria=None):
        self._create_metric(town_map, log, criteria)

    def _create_metric(self, town_map, log, criteria):
        raise NotImplementedError("metrics must implement _create_metric")


def _foreign_imports(metric_file: str) -> List[str]:
    """The modules of the JAX stack (``mmfn_tpu``, ``jax``, ``flax``) that
    ``metric_file`` imports, read from its source without running it."""
    import ast

    with open(metric_file) as f:
        tree = ast.parse(f.read(), metric_file)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.append(node.module or "")
    return sorted({n for n in names if n.split(".")[0] in ("mmfn_tpu", "jax", "flax")})


def load_metric_class(metric_file: str):
    """First BasicMetric subclass found in the module at ``metric_file``
    (metrics_manager.py:92-113 semantics, without mutating sys.path). A file
    that imports the JAX package (its metrics subclass that package's
    ``BasicMetric``) is refused before any of it runs."""
    foreign = _foreign_imports(metric_file)
    if foreign:
        raise ImportError(
            f"{metric_file} imports {', '.join(foreign)}: a metric for mmfn_tpu_torch "
            "subclasses mmfn_tpu_torch.harness.metrics_log.BasicMetric and imports "
            "nothing of the JAX package (the port's copies of examples/metrics/ are "
            "in mmfn_tpu_torch/harness/metric_examples/)")
    name = os.path.basename(metric_file).rsplit(".", 1)[0]
    spec = importlib.util.spec_from_file_location(name, metric_file)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    for _, member in inspect.getmembers(module, inspect.isclass):
        if issubclass(member, BasicMetric) and member is not BasicMetric:
            return member
    raise ValueError(f"{metric_file}: no BasicMetric subclass found")


def run_metric(metric, recording, town_map=None, criteria=None,
               out_dir: str = "."):
    """Run one metric (class or .py path) over a recording (dict or path).

    Builds the map from the recording's embedded OpenDRIVE when ``town_map``
    is None (metrics_manager.py loads the recorded map the same way).
    Returns the metric instance (metrics expose results as attributes and/or
    files under ``out_dir``).
    """
    if isinstance(metric, str):
        metric = load_metric_class(metric)
    log = MetricsLog(recording)
    if town_map is None and log._rec.get("opendrive"):
        from mmfn_tpu_torch.mapping import vectorize_xodr
        town_map, _, _ = vectorize_xodr(log._rec["opendrive"],
                                        birdview=False)
    if criteria is None:
        criteria = log.get_criteria()
    metric.out_dir = out_dir
    return metric(town_map, log, criteria)
