"""Episode recording — the CARLA recorder-log analog for the fake world.

The reference stack analyzes runs post-hoc with scenario_runner's metrics
module: ``scenario_runner.py --record`` saves a CARLA recorder ``.log`` plus a
criteria JSON, and ``metrics_manager.py`` replays them through a ``MetricsLog``
query API into user-defined metrics (reference
scenario_runner/metrics_manager.py:31-120,
srunner/metrics/tools/metrics_log.py:20-416).

This module is the recording side: :class:`EpisodeRecorder` captures one
ground-truth snapshot per closed-loop tick (ego + scenario/background actors,
applied control, traffic-light states, collisions) from
``ClosedLoopRunner.drive`` and serializes it — together with the OpenDRIVE
string and a criteria summary — as one JSON document. CARLA's recorder is an
opaque binary replayed through the simulator; ours is a self-contained file
whose queries (`harness.metrics_log.MetricsLog`) are columnar numpy slices,
so metrics run anywhere without a simulator.

Format (``mmfn_tpu-episode-v1``)::

    {
      "format": "mmfn_tpu-episode-v1",
      "dt": 0.05,
      "opendrive": "<OpenDRIVE ...>",         # map the episode ran on
      "route_id": "...",
      "actors":  {id: {type_id, role_name, kind, extent,
                       first_frame, last_frame,
                       physics_control?: {max_accel, max_brake, drag?}}},
      "lights_meta": [{light_id, x, y, yaw, green, yellow, red,
                       trigger_distance, lateral_half_width}, ...],
      "frames":  [{"time": t, "platform_time": wall,
                   "states": {id: [x, y, yaw, vx, vy]},
                   "control": [steer, throttle, brake],
                   "lights": ["Red"|"Yellow"|"Green", ...],   # by light index
                   "lights_frozen": [bool, ...],              # hold active
                   "weather": "<preset>",
                   "collisions": [other_id, ...]}, ...],
      "criteria": {Name: {test_status, actual_value,
                          expected_value_success}},
      "record": {...}                          # scored RouteRecord dict
    }

The ego is actor id 0 with role_name "hero" (the leaderboard's ego role);
scenario actors carry role_name "scenario" and background traffic
"background", matching the role names srunner metrics filter on
(srunner/metrics/examples/distance_between_vehicles.py:36).

The port's own copy of the JAX package's ``harness/recording.py``. It
writes the same format, ``mmfn_tpu-episode-v1``, so a recording made by
either package loads in the other's ``MetricsLog``.
"""

from __future__ import annotations

import json
import math
from typing import List, Optional

EGO_ID = 0
EGO_TYPE_ID = "vehicle.lincoln.mkz2017"   # leaderboard ego model
EGO_EXTENT = 2.45                         # ~half-length of the mkz
FORMAT = "mmfn_tpu-episode-v1"


class EpisodeRecorder:
    """Collects per-tick ground truth from the closed-loop runner.

    Pass one to ``ClosedLoopRunner.run_route(..., recorder=...)``; after the
    route returns, call :meth:`save` (or read :attr:`data`).
    """

    # kinematic motion envelope of scenario/background vehicles — the
    # recorder's carla.VehiclePhysicsControl analog (atoms.py
    # AccelerateToVelocity.MAX_ACCEL / StopVehicle.MAX_DECEL)
    NPC_PHYSICS = {"max_accel": 4.0, "max_brake": 8.0}

    def __init__(self):
        self.data = {
            "format": FORMAT,
            "dt": None,
            "opendrive": "",
            "route_id": "",
            "actors": {},
            "lights_meta": [],
            "frames": [],
            "criteria": {},
            "record": None,
        }
        self._signals = None

    # -- runner hooks -----------------------------------------------------

    def start(self, opendrive_str: str, dt: float, route_id: str,
              signals=None) -> None:
        """``signals``: the route's harness.traffic.SignalSet, if any — its
        static light configuration (stop-line pose, phase durations, trigger
        geometry) is captured once, the CARLA-recorder analog of traffic-light
        actor registration with a trigger_volume
        (srunner/metrics/tools/metrics_log.py:146 + :381)."""
        self.data["opendrive"] = opendrive_str
        self.data["dt"] = dt
        self.data["route_id"] = str(route_id)
        self._register(EGO_ID, EGO_TYPE_ID, "hero", "vehicle", EGO_EXTENT)
        self._signals = signals
        if signals is not None:
            self.data["lights_meta"] = [{
                "light_id": int(li.light_id),
                "x": float(li.position[0]), "y": float(li.position[1]),
                "yaw": float(li.yaw),
                "green": float(li.green), "yellow": float(li.yellow),
                "red": float(li.red),
                "trigger_distance": float(li.TRIGGER_DISTANCE),
                "lateral_half_width": float(li.LATERAL_HALF_WIDTH),
            } for li in signals.lights]

    def _register(self, actor_id: int, type_id: str, role: str, kind: str,
                  extent: float, physics: Optional[dict] = None) -> None:
        key = str(actor_id)
        if key not in self.data["actors"]:
            self.data["actors"][key] = {
                "type_id": type_id, "role_name": role, "kind": kind,
                "extent": float(extent),
                "first_frame": len(self.data["frames"]),
                "last_frame": len(self.data["frames"]),
            }
            if physics is not None:
                self.data["actors"][key]["physics_control"] = dict(physics)

    def record_tick(self, game_time: float, platform_time: float, world,
                    actors: List, n_scenario: int, control,
                    light_states: List) -> None:
        """One frame: the pre-tick state the recorded control responds to.

        ``actors`` is the runner's live actor list whose first ``n_scenario``
        entries come from the scenario manager (role "scenario") and the rest
        from background traffic (role "background") — ids don't collide
        (behaviors allocate small ids, npc_traffic starts at 5000) but the
        positional split is what defines the role, as in the runner itself.
        """
        frame = len(self.data["frames"])
        states = {
            str(EGO_ID): [float(world.x), float(world.y), float(world.yaw),
                          float(world.v * math.cos(world.yaw)),
                          float(world.v * math.sin(world.yaw))],
        }
        ego_meta = self.data["actors"][str(EGO_ID)]
        ego_meta["last_frame"] = frame
        if "physics_control" not in ego_meta:   # once, at first sight of world
            ego_meta["physics_control"] = {
                "max_accel": float(getattr(world, "MAX_ACCEL", 4.0)),
                "max_brake": float(getattr(world, "MAX_BRAKE", 8.0)),
                "drag": float(getattr(world, "DRAG", 0.0)),
            }
        for i, a in enumerate(actors):
            role = "scenario" if i < n_scenario else "background"
            type_id = ("walker.pedestrian.0001" if a.kind == "walker"
                       else "vehicle.tesla.model3")
            self._register(a.actor_id, type_id, role, a.kind, a.extent,
                           physics=(self.NPC_PHYSICS if a.kind == "vehicle"
                                    else None))
            self.data["actors"][str(a.actor_id)]["last_frame"] = frame
            vx, vy = float(a.velocity[0]), float(a.velocity[1])
            states[str(a.actor_id)] = [float(a.position[0]),
                                       float(a.position[1]),
                                       float(a.yaw), vx, vy]
        # a light is "frozen" while a hold overrides its phase cycle — the
        # fault-removal force-green grant or a scenario's
        # TrafficLightStateSetter (the carla TrafficLight.freeze analog
        # queried by metrics_log.is_traffic_light_frozen)
        frozen = []
        if self._signals is not None:
            frozen = [bool(game_time < li.forced_green_until
                           or (li.forced_state is not None
                               and game_time < li.forced_state_until))
                      for li in self._signals.lights]
        self.data["frames"].append({
            "time": float(game_time),
            "platform_time": float(platform_time),
            "states": states,
            "control": [float(control.steer), float(control.throttle),
                        float(control.brake)],
            "lights": [s for _, _, s in light_states],
            "lights_frozen": frozen,
            "collisions": [],
            # live preset (animates under a WeatherSim — weather_sim.py
            # analog); CARLA's recorder captures weather implicitly in
            # the replay, here it is explicit per frame
            "weather": str(getattr(world, "weather", "")),
        })

    def record_collision(self, other_id: int) -> None:
        if self.data["frames"]:
            self.data["frames"][-1]["collisions"].append(int(other_id))

    def finish(self, criteria: List, record=None) -> None:
        """Summarize the run's criteria the way scenario_runner's ``--json``
        output feeds metrics (srunner CriterionRecord fields consumed by
        srunner/metrics/examples/criteria_filter.py:35-42)."""
        self.data["criteria"] = criteria_summary(criteria)
        if record is not None:
            self.data["record"] = record.to_dict()

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.data, f)

    @staticmethod
    def load(path: str) -> dict:
        with open(path) as f:
            data = json.load(f)
        if data.get("format") != FORMAT:
            raise ValueError(f"{path}: not a {FORMAT} recording")
        return data


def criteria_summary(criteria: List) -> dict:
    """criterion objects -> {Name: {test_status, actual_value,
    expected_value_success}} (the srunner criteria-JSON contract).

    Per-class actual values mirror the srunner criteria they rebuild
    (harness/criteria.py docstrings): completion percent, outside-lanes
    percent, and event counts for the boolean/counting criteria whose
    success value is 0 infractions.
    """
    out = {}
    for c in criteria:
        name = type(c).__name__.replace("Criterion", "")
        if hasattr(c, "percent"):            # RouteCompletion
            actual, expected = round(float(c.percent), 2), 100.0
            ok = bool(getattr(c, "completed", False))
        elif hasattr(c, "percentage"):       # OutsideRouteLanes
            actual, expected = round(float(c.percentage), 2), 0.0
            ok = actual == 0.0
        elif hasattr(c, "triggered"):        # blocked / deviation
            actual, expected = int(bool(c.triggered)), 0
            ok = not c.triggered
        else:                                # red light / stop: event counts
            actual, expected = len(c.events), 0
            ok = not c.events
        out[name] = {
            "test_status": "SUCCESS" if ok else "FAILURE",
            "actual_value": actual,
            "expected_value_success": expected,
        }
    return out
