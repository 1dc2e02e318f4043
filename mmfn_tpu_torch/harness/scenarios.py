"""Trigger-based adversarial scenarios.

The reference samples srunner scenario classes (cut-in, control-loss,
object-crash, ...) at trigger positions along routes from a JSON placement
file (route_scenario.py:377,449-475; srunner/scenarios/). This module provides
the same machinery for the simulator-free harness:

- ``parse_scenario_file``: reads the reference's placement JSON
  ({available_scenarios: [{Town: [{scenario_type, available_event_configurations
  [{transform}]}]}]}), returning per-town trigger lists;
- scenario behaviors that activate when the ego enters the trigger radius and
  inject/drive actors in the KinematicWorld: a crossing walker
  (object-crash analog), a stopped vehicle blocking the lane, and a cut-in
  vehicle;
- ``ScenarioManagerLite``: per-tick activation + actor stepping, feeding actor
  state to criteria and the expert's WorldView.

The CARLA path keeps using srunner's own scenario classes via the glue; this
lite engine exists so closed-loop behavior (hazard braking, collisions,
scoring) is exercisable without a simulator.

The port's own copy of the JAX package's ``harness/scenarios.py``.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class ScenarioTrigger:
    x: float
    y: float
    yaw: float = 0.0
    scenario_type: str = "Scenario3"


def parse_scenario_file(path: str, town: str) -> List[ScenarioTrigger]:
    with open(path) as f:
        data = json.load(f)
    triggers: List[ScenarioTrigger] = []
    for block in data.get("available_scenarios", []):
        for scenario in block.get(town, []):
            stype = scenario.get("scenario_type", "Scenario3")
            for event in scenario.get("available_event_configurations", []):
                t = event["transform"]
                triggers.append(ScenarioTrigger(
                    x=float(t["x"]), y=float(t["y"]),
                    yaw=math.radians(float(t.get("yaw", 0.0))),
                    scenario_type=stype))
    return triggers


# trigger-to-route matching thresholds (route_parser.py:19-20)
TRIGGER_THRESHOLD = 2.0          # meters: same-position / on-route test
TRIGGER_ANGLE_THRESHOLD = 10.0   # degrees: heading agreement


def scan_route_for_scenarios(route_xy: Sequence,
                             triggers: Sequence[ScenarioTrigger],
                             position_threshold: float = TRIGGER_THRESHOLD,
                             angle_threshold: float = TRIGGER_ANGLE_THRESHOLD,
                             ) -> dict:
    """Group the town's trigger positions that lie ON the route.

    The reference walks every route waypoint against every trigger transform
    with a 2 m position and 10 deg heading threshold
    (route_parser.py:137-178 scan_route_for_possible_scenarios /
    match_world_location_to_route). Returns {position key: [triggers]} —
    several scenario types can share one trigger position.
    """
    pts = np.asarray([p[:2] for p in route_xy], dtype=np.float64)
    if len(pts) < 2:
        return {}
    headings = np.degrees(np.arctan2(*(np.diff(pts, axis=0)[:, ::-1]).T))
    grouped: dict = {}
    for trig in triggers:
        d = np.linalg.norm(pts[:-1] - np.array([trig.x, trig.y]), axis=1)
        near = d < position_threshold
        if not near.any():
            continue
        ang = np.abs((headings - math.degrees(trig.yaw) + 180.0) % 360.0 - 180.0)
        if not (near & (ang < angle_threshold)).any():
            continue
        key = (round(trig.x, 1), round(trig.y, 1))
        grouped.setdefault(key, []).append(trig)
    return grouped


def sample_scenarios(grouped: dict, seed: int = 0) -> List[ScenarioTrigger]:
    """One scenario per trigger position, reproducing the reference's
    sampling (route_scenario.py:304-357 _scenario_sampling): the
    highest-numbered ScenarioN wins each position; a position already used by
    an earlier pick falls back to a seeded random alternative or is dropped.
    ``seed`` varies per repetition so reruns see different fallbacks.
    """
    rng = np.random.default_rng(seed)

    def number(t: ScenarioTrigger) -> int:
        try:
            return int(t.scenario_type.split("Scenario")[1])
        except (IndexError, ValueError):
            return -1

    def position_used(t: ScenarioTrigger, chosen) -> bool:
        # position ONLY — compare_scenarios (route_scenario.py:134-169) never
        # looks at the scenario type (its yaw term is even a self-subtraction,
        # always 0), so any earlier pick within 2 m consumes the position
        return any(math.hypot(t.x - c.x, t.y - c.y) < TRIGGER_THRESHOLD
                   for c in chosen)

    sampled: List[ScenarioTrigger] = []
    for key in sorted(grouped):
        options = list(grouped[key])
        # reference select_scenario: >= comparison means the LAST max wins
        choice = None
        best = -1
        for t in options:
            if number(t) >= best:
                best, choice = number(t), t
        options.remove(choice)
        while choice is not None and position_used(choice, sampled):
            if not options:
                choice = None
                break
            choice = options[int(rng.integers(len(options)))]
            options.remove(choice)
        if choice is not None:
            sampled.append(choice)
    return sampled


@dataclass
class ScenarioActor:
    kind: str                      # 'walker' | 'vehicle'
    position: np.ndarray
    velocity: np.ndarray
    yaw: float = 0.0
    extent: float = 1.0
    actor_id: int = 0
    # OpenSCENARIO VisibilityAction state (CARLA actor-visibility semantics:
    # physics/collisions always stay on). sensors: ego sensor synthesis;
    # graphics: camera/birdview rendering; traffic: other participants'
    # obstacle awareness.
    visible_sensors: bool = True
    visible_graphics: bool = True
    visible_traffic: bool = True

    def step(self, dt: float) -> None:
        self.position = self.position + self.velocity * dt


class ScenarioBehavior:
    """Activates once when the ego enters the trigger radius."""

    TRIGGER_RADIUS = 15.0
    # back-pointer to the driving ScenarioManagerLite (set at construction):
    # world-service atoms (traffic lights, weather, time-of-day) reach the
    # SignalSet / world / WeatherSim through it — the analog of srunner
    # atoms reading CarlaDataProvider's world singletons. None for behaviors
    # constructed standalone (unit tests); service atoms then FAIL/RUN
    # gracefully instead of crashing.
    manager = None

    def __init__(self, trigger: ScenarioTrigger, actor_id: int):
        self.trigger = trigger
        self.actor_id = actor_id
        self.active = False
        self.done = False
        self.actors: List[ScenarioActor] = []

    def maybe_activate(self, ego_xy: np.ndarray) -> None:
        if self.active or self.done:
            return
        d = math.hypot(ego_xy[0] - self.trigger.x, ego_xy[1] - self.trigger.y)
        if d < self.TRIGGER_RADIUS:
            self.active = True
            self.on_activate()

    def observe(self, ego_xy: np.ndarray) -> None:
        """Per-tick ego position hook (distance-gated behaviors override)."""

    def on_activate(self) -> None:
        raise NotImplementedError

    def step(self, dt: float) -> None:
        for a in self.actors:
            a.step(dt)

    def discard_actors(self, keep_fn) -> int:
        """Fault-removal hook: drop actors failing ``keep_fn``. Subclasses
        whose step() rebuilds ``self.actors`` from private state (the atom
        behaviors) override this so removals stick."""
        keep = [a for a in self.actors if keep_fn(a)]
        removed = len(self.actors) - len(keep)
        self.actors = keep
        return removed

    def steer_noise(self) -> float:
        """Additive ego steering perturbation (only ControlLoss uses this)."""
        return 0.0


class CrossingWalker(ScenarioBehavior):
    """A pedestrian crosses the road ahead of the trigger (srunner
    object_crash_vehicle.py DynamicObjectCrossing:153-166).

    Parameters from the source: crossing speed 3 + 0.4*num_lane_changes with
    one lane to cross -> 3.4 m/s (line 207); the scenario retires once the
    ego has driven _ego_vehicle_distance_driven = 40 m past it (line 153)."""

    WALK_SPEED = 3.4        # object_crash_vehicle.py:207 (num_lane_changes=1)
    SPAWN_AHEAD = 12.0
    SPAWN_LATERAL = 6.0
    RETIRE_DIST = 40.0      # object_crash_vehicle.py:153

    def on_activate(self) -> None:
        t = self.trigger
        ahead = np.array([math.cos(t.yaw), math.sin(t.yaw)])
        lateral = np.array([-ahead[1], ahead[0]])
        start = np.array([t.x, t.y]) + ahead * self.SPAWN_AHEAD + lateral * self.SPAWN_LATERAL
        self.actors = [ScenarioActor("walker", start, -lateral * self.WALK_SPEED,
                                     extent=0.5, actor_id=self.actor_id)]

    def step(self, dt: float) -> None:
        super().step(dt)
        if self.actors and np.linalg.norm(
                self.actors[0].position
                - np.array([self.trigger.x, self.trigger.y])) > self.RETIRE_DIST:
            self.actors = []
            self.done = True


class ControlLoss(ScenarioBehavior):
    """Srunner Scenario1 (control_loss.py:44-90): the EGO's steering is
    perturbed at three jitter points along the road, simulating loss of
    control (e.g. ice); the agent must recover and stay in its lane.

    Parameters from the source: the jitter locations sit at driven distances
    [14, 48, 74] m past the trigger (line 80, the no-randomization branch);
    each perturbation is a short pulse whose amplitude is seeded from the
    trigger position so runs are deterministic (the source draws per-tick
    normal(0, 0.01) noise, line 44-45 — pulses of equivalent integral are
    used here because the fake world has no per-tick actuator jitter)."""

    JITTER_DISTANCES = (14.0, 48.0, 74.0)   # control_loss.py:80
    PULSE_METERS = 4.0                      # pulse length along the road
    MAX_OFFSET = 0.12

    def on_activate(self) -> None:
        rng = np.random.default_rng(
            abs(hash((round(self.trigger.x, 1), round(self.trigger.y, 1)))) % (2 ** 32))
        self._offsets = rng.uniform(0.06, self.MAX_OFFSET, len(self.JITTER_DISTANCES)) \
            * rng.choice([-1.0, 1.0], len(self.JITTER_DISTANCES))
        self._driven = 0.0
        self._last_xy = None

    def observe(self, ego_xy: np.ndarray) -> None:
        if self._last_xy is not None:
            self._driven += float(np.linalg.norm(ego_xy - self._last_xy))
        self._last_xy = np.asarray(ego_xy, dtype=np.float64)

    def step(self, dt: float) -> None:
        if self._driven > self.JITTER_DISTANCES[-1] + self.PULSE_METERS:
            self.done = True

    def steer_noise(self) -> float:
        if self.done or not self.active:
            return 0.0
        for i, d in enumerate(self.JITTER_DISTANCES):
            if d <= self._driven <= d + self.PULSE_METERS:
                return float(self._offsets[i])
        return 0.0


class StoppedVehicle(ScenarioBehavior):
    """A stalled vehicle blocks the lane past the trigger (srunner
    object_crash_vehicle.py StationaryObjectCrossing:52-55: static prop,
    scenario ends after _ego_vehicle_distance_driven = 40 m)."""

    SPAWN_AHEAD = 20.0

    def on_activate(self) -> None:
        t = self.trigger
        ahead = np.array([math.cos(t.yaw), math.sin(t.yaw)])
        pos = np.array([t.x, t.y]) + ahead * self.SPAWN_AHEAD
        self.actors = [ScenarioActor("vehicle", pos, np.zeros(2), yaw=t.yaw,
                                     extent=2.2, actor_id=self.actor_id)]


class CutInVehicle(ScenarioBehavior):
    """A vehicle merges into the ego lane from the side (srunner
    cut_in.py:48-50): velocity 40 km/h -> 11.1 m/s, activation when the ego
    closes within _trigger_distance = 30 m (the source's speeds feed
    WaypointFollower in km/h-scaled town traffic)."""

    SPEED = 40.0 / 3.6       # cut_in.py:48 (_velocity = 40)
    TRIGGER_RADIUS = 30.0    # cut_in.py:50 (_trigger_distance)

    def on_activate(self) -> None:
        t = self.trigger
        ahead = np.array([math.cos(t.yaw), math.sin(t.yaw)])
        lateral = np.array([-ahead[1], ahead[0]])
        pos = np.array([t.x, t.y]) + ahead * 8.0 + lateral * 3.5
        vel = ahead * self.SPEED - lateral * 0.8
        self.actors = [ScenarioActor("vehicle", pos, vel, yaw=t.yaw,
                                     extent=2.2, actor_id=self.actor_id)]


class LeadVehicleSlows(ScenarioBehavior):
    """A lead vehicle ahead brakes to a stop (srunner
    follow_leading_vehicle.py:61-65): spawns _first_vehicle_location = 25 m
    ahead, cruises at _first_vehicle_speed = 10 m/s, stops with
    _other_actor_max_brake = 1.0 (full brake, ~8 m/s^2 in our kinematics)."""

    START_SPEED = 10.0       # follow_leading_vehicle.py:62
    DECEL = 8.0              # max_brake 1.0 * KinematicWorld.MAX_BRAKE
    SPAWN_AHEAD = 25.0       # follow_leading_vehicle.py:61

    def on_activate(self) -> None:
        t = self.trigger
        ahead = np.array([math.cos(t.yaw), math.sin(t.yaw)])
        pos = np.array([t.x, t.y]) + ahead * self.SPAWN_AHEAD
        self.actors = [ScenarioActor("vehicle", pos, ahead * self.START_SPEED,
                                     yaw=t.yaw, extent=2.2, actor_id=self.actor_id)]

    def step(self, dt: float) -> None:
        for a in self.actors:
            speed = float(np.linalg.norm(a.velocity))
            if speed > 0:
                new_speed = max(0.0, speed - self.DECEL * dt)
                a.velocity = a.velocity * (new_speed / speed if speed else 0.0)
        super().step(dt)


class OppositeDirection(ScenarioBehavior):
    """An oncoming vehicle in the opposing lane (srunner
    maneuver_opposite_direction.py:48-53): spawns _first_vehicle_location =
    50 m out, oncoming at _opposite_speed = 5.56 m/s."""

    SPEED = 5.56             # maneuver_opposite_direction.py:52
    SPAWN_AHEAD = 50.0       # maneuver_opposite_direction.py:48

    def on_activate(self) -> None:
        t = self.trigger
        ahead = np.array([math.cos(t.yaw), math.sin(t.yaw)])
        lateral = np.array([-ahead[1], ahead[0]])
        pos = np.array([t.x, t.y]) + ahead * self.SPAWN_AHEAD - lateral * 3.5
        self.actors = [ScenarioActor("vehicle", pos, -ahead * self.SPEED,
                                     yaw=t.yaw + math.pi, extent=2.2,
                                     actor_id=self.actor_id)]

    def step(self, dt: float) -> None:
        super().step(dt)
        if self.actors and np.linalg.norm(
                self.actors[0].position - np.array([self.trigger.x, self.trigger.y])) > 120:
            self.actors = []
            self.done = True


class JunctionCrossing(ScenarioBehavior):
    """A vehicle crosses the ego path perpendicularly at the trigger
    (srunner no_signal_junction_crossing.py:39-44 /
    opposite_vehicle_taking_priority.py).

    Two phases, matching the srunner behavior tree
    (no_signal_junction_crossing.py:78-118): first **SyncArrival**
    (atomic_behaviors.py:1210-1274) — per tick the crossing vehicle's
    throttle/brake is ``gain * (t_self - t_ego)`` where each ``t`` is
    distance-to-collision-point over current speed, so it arrives at the
    conflict point exactly when the ego does (and waits if the ego waits:
    ego speed 0 makes t_ego infinite, braking the actor — the "crossing
    negotiation"); then, once the ego is close to the junction
    (pass_through_trigger), **KeepVelocity** at
    _other_actor_target_velocity = 15 m/s until clear."""

    SPEED = 15.0             # no_signal_junction_crossing.py:44
    START_SPEED = 0.0        # sync-arrival accelerates it from rest
    SYNC_GAIN = 1.0          # atomic_behaviors.py:1229 (gain default)
    ACCEL = 4.0              # kinematic full-throttle accel, m/s^2
    BRAKE = 8.0              # kinematic full-brake decel, m/s^2
    PASS_DIST = 8.0          # ego closer than this -> keep-velocity phase
    SPAWN_AHEAD = 18.0
    SPAWN_LATERAL = 25.0
    RETIRE_DIST = 60.0

    # class-level defaults so subclasses that override on_activate (the
    # turning variants) still satisfy the inherited observe() hook
    _ego_xy: Optional[np.ndarray] = None
    _ego_prev: Optional[np.ndarray] = None

    def on_activate(self) -> None:
        t = self.trigger
        ahead = np.array([math.cos(t.yaw), math.sin(t.yaw)])
        lateral = np.array([-ahead[1], ahead[0]])
        # the crossing path intersects the ego path at trigger + ahead*18
        self._cp = np.array([t.x, t.y]) + ahead * self.SPAWN_AHEAD
        self._dir = -lateral
        self._ego_xy: Optional[np.ndarray] = None
        self._ego_prev: Optional[np.ndarray] = None
        self._passed = False
        pos = self._cp + lateral * self.SPAWN_LATERAL
        self.actors = [ScenarioActor("vehicle", pos,
                                     self._dir * self.START_SPEED,
                                     yaw=t.yaw - math.pi / 2, extent=2.2,
                                     actor_id=self.actor_id)]

    def observe(self, ego_xy: np.ndarray) -> None:
        self._ego_prev = self._ego_xy
        self._ego_xy = np.asarray(ego_xy, dtype=float).copy()

    def _sync_arrival(self, a: ScenarioActor, dt: float) -> None:
        """SyncArrival pacing (atomic_behaviors.py:1242-1272), as an
        acceleration command on the kinematic actor."""
        ego_speed = 0.0
        if self._ego_xy is not None and self._ego_prev is not None and dt > 0:
            ego_speed = float(np.linalg.norm(self._ego_xy - self._ego_prev)) / dt
        d_ego = (float(np.linalg.norm(self._ego_xy - self._cp))
                 if self._ego_xy is not None else math.inf)
        d_act = float(np.linalg.norm(a.position - self._cp))
        speed = float(np.linalg.norm(a.velocity))
        t_ego = d_ego / ego_speed if ego_speed > 0.1 else math.inf
        t_act = d_act / speed if speed > 0.1 else math.inf
        if math.isinf(t_ego):
            control = -1.0         # ego waiting: wait too (negotiation)
        elif math.isinf(t_act):
            control = 1.0          # from rest: throttle toward the junction
        else:
            control = max(-1.0, min(1.0, self.SYNC_GAIN * (t_act - t_ego)))
        dv = (self.ACCEL if control > 0 else self.BRAKE) * control * dt
        speed = max(0.0, min(self.SPEED, speed + dv))
        a.velocity = self._dir * speed

    def step(self, dt: float) -> None:
        if self.actors and not self._passed:
            d_ego = (float(np.linalg.norm(self._ego_xy - self._cp))
                     if self._ego_xy is not None else math.inf)
            if d_ego <= self.PASS_DIST:
                self._passed = True   # pass_through_trigger reached
            else:
                self._sync_arrival(self.actors[0], dt)
        if self.actors and self._passed:
            self.actors[0].velocity = self._dir * self.SPEED  # KeepVelocity
        super().step(dt)
        if self.actors and np.linalg.norm(
                self.actors[0].position
                - np.array([self.trigger.x, self.trigger.y])) > self.RETIRE_DIST:
            self.actors = []
            self.done = True


class OppositeVehicleRunningRedLight(JunctionCrossing):
    """An opposing vehicle 'illegally' takes priority by running its red
    light while the ego has green (srunner
    opposite_vehicle_taking_priority.py:37-60): sync-arrival to the
    geometric intersection point, crosses at _other_actor_target_velocity =
    10 m/s (line 56), and retires after driving _other_actor_distance =
    50 m (line 58)."""

    SPEED = 10.0             # opposite_vehicle_taking_priority.py:56
    DRIVE_DIST = 50.0        # opposite_vehicle_taking_priority.py:58
    RETIRE_DIST = math.inf   # retires on driven distance instead

    def on_activate(self) -> None:
        super().on_activate()
        self._spawn = self.actors[0].position.copy()

    def step(self, dt: float) -> None:
        JunctionCrossing.step(self, dt)
        if self.actors and np.linalg.norm(
                self.actors[0].position - self._spawn) > self.DRIVE_DIST:
            self.actors = []
            self.done = True


class JunctionLeftTurn(JunctionCrossing):
    """An oncoming vehicle turns left across the ego's path (srunner
    SignalizedJunctionLeftTurn): spawns ahead in the opposing lane and arcs
    across the junction."""

    SPEED = 6.9       # signalized_junction_left_turn.py:49 (_target_vel)
    TURN_RATE = 0.35  # rad/s yaw change through the junction
    RETIRE_DIST = 110.0  # signalized_junction_left_turn.py:51 (_ego_distance)

    def on_activate(self) -> None:
        t = self.trigger
        ahead = np.array([math.cos(t.yaw), math.sin(t.yaw)])
        lateral = np.array([-ahead[1], ahead[0]])
        pos = np.array([t.x, t.y]) + ahead * 35.0 - lateral * 3.5
        self.actors = [ScenarioActor("vehicle", pos, -ahead * self.SPEED,
                                     yaw=t.yaw + math.pi, extent=2.2,
                                     actor_id=self.actor_id)]

    def step(self, dt: float) -> None:
        for a in self.actors:
            # arc: rotate the velocity toward the ego's lane (a left turn in
            # the oncoming vehicle's frame)
            c, s = math.cos(-self.TURN_RATE * dt), math.sin(-self.TURN_RATE * dt)
            a.velocity = np.array([c * a.velocity[0] - s * a.velocity[1],
                                   s * a.velocity[0] + c * a.velocity[1]])
            a.yaw = math.atan2(a.velocity[1], a.velocity[0])
            a.step(dt)
        if self.actors and np.linalg.norm(
                self.actors[0].position
                - np.array([self.trigger.x, self.trigger.y])) > self.RETIRE_DIST:
            self.actors = []
            self.done = True


class JunctionRightTurn(JunctionCrossing):
    """A crossing vehicle turns right into the ego's lane (srunner
    SignalizedJunctionRightTurn): enters perpendicular, then merges to travel
    in the ego's direction ahead of it."""

    SPEED = 6.9       # signalized_junction_right_turn.py:50 (_target_vel)
    START_SPEED = 6.9  # enters the junction already moving (no sync phase)
    TURN_RATE = 0.5
    # _ego_distance = 40 (signalized_junction_right_turn.py:52) + the 40 m
    # the merged actor keeps driving ahead of the ego before it retires
    RETIRE_DIST = 80.0

    def step(self, dt: float) -> None:
        t = self.trigger
        ahead = np.array([math.cos(t.yaw), math.sin(t.yaw)])
        for a in self.actors:
            # rotate velocity toward the ego heading until aligned
            if float(a.velocity @ ahead) < 0.95 * np.linalg.norm(a.velocity):
                c, s = math.cos(self.TURN_RATE * dt), math.sin(self.TURN_RATE * dt)
                a.velocity = np.array([c * a.velocity[0] - s * a.velocity[1],
                                       s * a.velocity[0] + c * a.velocity[1]])
                a.yaw = math.atan2(a.velocity[1], a.velocity[0])
            a.step(dt)
        if self.actors and np.linalg.norm(
                self.actors[0].position
                - np.array([self.trigger.x, self.trigger.y])) > self.RETIRE_DIST:
            self.actors = []
            self.done = True


class VehicleTurningRoute(ScenarioBehavior):
    """A cyclist cuts across the road right after the ego turns at a junction
    (srunner object_crash_intersection.py VehicleTurningRoute:459-470):
    closer and faster than the walker crossing, with a vehicle-class
    collision penalty. _other_actor_target_velocity = 10 m/s (line 459)."""

    BIKE_SPEED = 10.0       # object_crash_intersection.py:459
    SPAWN_AHEAD = 9.0
    SPAWN_LATERAL = 5.0

    def on_activate(self) -> None:
        t = self.trigger
        ahead = np.array([math.cos(t.yaw), math.sin(t.yaw)])
        lateral = np.array([-ahead[1], ahead[0]])
        start = np.array([t.x, t.y]) + ahead * self.SPAWN_AHEAD \
            + lateral * self.SPAWN_LATERAL
        self.actors = [ScenarioActor(
            "vehicle", start, -lateral * self.BIKE_SPEED,
            yaw=math.atan2(-lateral[1], -lateral[0]),
            extent=0.8, actor_id=self.actor_id)]

    def step(self, dt: float) -> None:
        super().step(dt)
        if self.actors and np.linalg.norm(
                self.actors[0].position - np.array([self.trigger.x, self.trigger.y])) > 30:
            self.actors = []
            self.done = True


class OtherLeadingVehicle(ScenarioBehavior):
    """Srunner other_leading_vehicle.py: a lead vehicle ahead brakes hard
    mid-cruise while a second vehicle paces the ego in the adjacent lane,
    blocking the overtake — the ego must brake, not swerve. Like the
    reference, the lead slows to cruise/3.2 and keeps driving (it does not
    park), and the behavior retires once the pair has driven clear.

    Parameters from other_leading_vehicle.py:50-56: lead spawns
    _first_vehicle_location = 35 m out; speeds 55 / 45 are the source's
    WaypointFollower targets, read as km/h town speeds -> 15.3 / 12.5 m/s."""

    CRUISE = 55.0 / 3.6         # other_leading_vehicle.py:53
    PACE_SPEED = 45.0 / 3.6     # other_leading_vehicle.py:54
    HARD_DECEL = 4.0
    BRAKE_AFTER = 2.0      # seconds of cruising before the sudden brake
    SLOW_SPEED = CRUISE / 3.2   # srunner's decrease_velocity target (line 135)
    SPAWN_AHEAD = 35.0          # other_leading_vehicle.py:50
    RETIRE_DIST = 200.0

    def on_activate(self) -> None:
        t = self.trigger
        ahead = np.array([math.cos(t.yaw), math.sin(t.yaw)])
        lateral = np.array([-ahead[1], ahead[0]])
        base = np.array([t.x, t.y])
        self.actors = [
            ScenarioActor("vehicle", base + ahead * self.SPAWN_AHEAD,
                          ahead * self.CRUISE,
                          yaw=t.yaw, extent=2.2, actor_id=self.actor_id),
            ScenarioActor("vehicle", base + ahead * 20.0 - lateral * 3.5,
                          ahead * self.PACE_SPEED, yaw=t.yaw, extent=2.2,
                          actor_id=self.actor_id + 500),
        ]
        self._t = 0.0

    def step(self, dt: float) -> None:
        self._t += dt
        lead = self.actors[0] if self.actors else None
        if lead is not None and self._t > self.BRAKE_AFTER:
            speed = float(np.linalg.norm(lead.velocity))
            if speed > self.SLOW_SPEED:
                new_speed = max(self.SLOW_SPEED, speed - self.HARD_DECEL * dt)
                lead.velocity = lead.velocity * (new_speed / speed)
        super().step(dt)
        if self.actors and all(
                np.linalg.norm(a.position - np.array([self.trigger.x, self.trigger.y]))
                > self.RETIRE_DIST for a in self.actors):
            self.actors = []
            self.done = True


class ChangeLane(ScenarioBehavior):
    """Srunner change_lane.py: the ego follows a fast car; a slow car drives
    far ahead in the same lane; the fast car swerves into the adjacent lane
    at the last moment, revealing the slow car — the ego must brake (or
    change lanes) quickly.

    Parameters from change_lane.py:61-68: fast vehicle 70 km/h -> 19.4 m/s
    spawned _fast_vehicle_distance = 20 m out; slow vehicle STANDS
    (_slow_vehicle_velocity = 0) at _slow_vehicle_distance = 100 m;
    activation radius _trigger_distance = 30 m."""

    FAST_SPEED = 70.0 / 3.6   # change_lane.py:61
    SLOW_SPEED = 0.0          # change_lane.py:62
    FAST_AHEAD = 20.0         # change_lane.py:66
    SLOW_AHEAD = 100.0        # change_lane.py:65
    TRIGGER_RADIUS = 30.0     # change_lane.py:67
    SWERVE_GAP = 14.0       # fast car starts its lane change this far out
    SWERVE_SECONDS = 1.5
    RETIRE_DIST = 200.0

    def on_activate(self) -> None:
        t = self.trigger
        ahead = np.array([math.cos(t.yaw), math.sin(t.yaw)])
        self._ahead = ahead
        self._lateral = np.array([-ahead[1], ahead[0]])
        base = np.array([t.x, t.y])
        self.actors = [
            ScenarioActor("vehicle", base + ahead * self.FAST_AHEAD,
                          ahead * self.FAST_SPEED,
                          yaw=t.yaw, extent=2.2, actor_id=self.actor_id),
            ScenarioActor("vehicle", base + ahead * self.SLOW_AHEAD,
                          ahead * self.SLOW_SPEED,
                          yaw=t.yaw, extent=2.2, actor_id=self.actor_id + 500),
        ]
        self._swerving = 0.0

    def step(self, dt: float) -> None:
        if len(self.actors) == 2:
            fast, slow = self.actors
            gap = float((slow.position - fast.position) @ self._ahead)
            if 0.0 < self._swerving < self.SWERVE_SECONDS:
                self._swerving += dt
                fast.velocity = self._ahead * self.FAST_SPEED \
                    + self._lateral * (3.5 / self.SWERVE_SECONDS)
            elif self._swerving >= self.SWERVE_SECONDS:
                fast.velocity = self._ahead * self.FAST_SPEED
            elif gap < self.SWERVE_GAP:
                self._swerving = dt
        super().step(dt)
        if self.actors and all(
                np.linalg.norm(a.position - np.array([self.trigger.x, self.trigger.y]))
                > self.RETIRE_DIST for a in self.actors):
            self.actors = []
            self.done = True


class LeadVehicleWithObstacle(ScenarioBehavior):
    """Srunner follow_leading_vehicle.py FollowLeadingVehicleWithObstacle:
    the lead vehicle brakes for a cyclist crossing ITS path and resumes once
    the cyclist has cleared — the ego must keep a safe following distance
    through the lead's unexplained stop.

    Parameters from follow_leading_vehicle.py:191-196: lead spawns
    _first_actor_location = 25 m out at _first_actor_speed = 10 m/s; the
    crossing cyclist rides at _second_actor_speed = 1.5 m/s; the lead stops
    with _other_actor_max_brake = 1.0 (~8 m/s^2 here)."""

    CRUISE = 10.0            # follow_leading_vehicle.py:193
    DECEL = 8.0              # _other_actor_max_brake = 1.0 (line 196)
    BIKE_SPEED = 1.5         # follow_leading_vehicle.py:194
    SPAWN_AHEAD = 25.0       # follow_leading_vehicle.py:191
    RETIRE_DIST = 150.0

    def on_activate(self) -> None:
        t = self.trigger
        ahead = np.array([math.cos(t.yaw), math.sin(t.yaw)])
        lateral = np.array([-ahead[1], ahead[0]])
        base = np.array([t.x, t.y])
        self._ahead = ahead
        self.actors = [
            ScenarioActor("vehicle", base + ahead * self.SPAWN_AHEAD,
                          ahead * self.CRUISE,
                          yaw=t.yaw, extent=2.2, actor_id=self.actor_id),
            # cyclist crossing the lead's path ~35 m out
            ScenarioActor("vehicle", base + ahead * 60.0 + lateral * 7.0,
                          -lateral * self.BIKE_SPEED,
                          yaw=math.atan2(-lateral[1], -lateral[0]),
                          extent=0.8, actor_id=self.actor_id + 500),
        ]

    def step(self, dt: float) -> None:
        if len(self.actors) == 2:
            lead, bike = self.actors
            gap = float((bike.position - lead.position) @ self._ahead)
            lateral_off = abs(float((bike.position - lead.position)
                                    @ np.array([-self._ahead[1], self._ahead[0]])))
            speed = float(np.linalg.norm(lead.velocity))
            blocking = 0.0 < gap < 18.0 and lateral_off < 4.0
            if blocking and speed > 0.0:
                new_speed = max(0.0, speed - self.DECEL * dt)
                lead.velocity = self._ahead * new_speed
            elif not blocking and speed < self.CRUISE:
                lead.velocity = self._ahead * min(self.CRUISE, speed + 2.0 * dt)
        super().step(dt)
        if self.actors and np.linalg.norm(
                self.actors[0].position
                - np.array([self.trigger.x, self.trigger.y])) > self.RETIRE_DIST:
            self.actors = []
            self.done = True


class FreeRide(ScenarioBehavior):
    """Srunner freeride.py: no adversarial actors — ordinary driving with
    only the criteria watching."""

    def on_activate(self) -> None:
        self.done = True


# srunner's NUMBER_CLASS_TRANSLATION analog (route_scenario.py:377)
SCENARIO_CLASSES = {
    "Scenario1": ControlLoss,          # ego steering perturbation (control_loss.py)
    "Scenario2": LeadVehicleSlows,     # follow leading vehicle
    "Scenario3": CrossingWalker,       # dynamic object crossing
    "Scenario4": VehicleTurningRoute,  # cyclist crossing after a junction turn
    "Scenario5": OtherLeadingVehicle,  # lead brakes hard, adjacent lane blocked
    "Scenario6": OppositeDirection,    # maneuver opposite direction
    "Scenario7": JunctionCrossing,     # signalized junction straight crossing
    "Scenario8": JunctionLeftTurn,     # signalized junction left turn
    "Scenario9": JunctionRightTurn,    # signalized junction right turn
    "Scenario10": JunctionCrossing,    # no-signal junction
    # srunner classes outside NUMBER_CLASS_TRANSLATION, reachable by name in
    # placement JSONs (srunner/scenarios/*.py analogs)
    "CutIn": CutInVehicle,                              # cut_in.py
    "StoppedVehicle": StoppedVehicle,                   # object_crash StationaryObject
    "ChangeLane": ChangeLane,                           # change_lane.py
    "FollowLeadingVehicleWithObstacle": LeadVehicleWithObstacle,  # follow_leading_vehicle.py
    "FreeRide": FreeRide,                               # freeride.py
    "NoSignalJunctionCrossing": JunctionCrossing,       # no_signal_junction_crossing.py
    "OppositeVehicleRunningRedLight": OppositeVehicleRunningRedLight,  # opposite_vehicle_taking_priority.py
}


class ScenarioManagerLite:
    def __init__(self, triggers: Sequence[ScenarioTrigger]):
        # world services for the behavior atoms (the CarlaDataProvider-
        # singleton analog): replay.run_route auto-wires signals / world /
        # weather_sim onto any manager that left them None, exactly as it
        # already does for the OpenScenarioManager (replay.py run_route).
        self.signals = None        # harness.traffic.SignalSet
        self.world = None          # the fake world (set_weather target)
        self.weather_sim = None    # harness.weather.WeatherSim
        self.rough_map = None      # mapping.rough_map.RoughMap (topology)
        self.game_time = 0.0       # accumulated sim seconds (light phases)
        self.behaviors: List[ScenarioBehavior] = []
        for i, trig in enumerate(triggers):
            cls = SCENARIO_CLASSES.get(trig.scenario_type, CrossingWalker)
            b = cls(trig, actor_id=1000 + i)
            b.manager = self
            self.behaviors.append(b)

    def tick(self, ego_xy: np.ndarray, dt: float) -> List[ScenarioActor]:
        self.game_time += dt
        actors: List[ScenarioActor] = []
        for b in self.behaviors:
            b.maybe_activate(np.asarray(ego_xy))
            if b.active and not b.done:
                b.observe(np.asarray(ego_xy))
                b.step(dt)
                actors.extend(b.actors)
        return actors

    def steer_noise(self) -> float:
        """Aggregate ego steering perturbation from active behaviors."""
        return float(sum(b.steer_noise() for b in self.behaviors
                         if b.active and not b.done))

    def remove_actors_near(self, xy: np.ndarray, radius: float = 15.0) -> int:
        """Fault removal: delete scenario actors blocking the ego (the
        reference's force_destory_actor deletes nearby NPCs,
        base_agent.py:273-289). Returns the number of actors removed."""
        removed = 0
        xy = np.asarray(xy, dtype=np.float64)
        for b in self.behaviors:
            if not b.active or b.done:
                continue
            removed += b.discard_actors(
                lambda a: np.linalg.norm(a.position - xy) > radius)
            if not b.actors:
                b.done = True
        return removed


# vehicle footprint: CARLA lincoln.mkz2017 is ~4.9 x 2.1 m; actor boxes are
# derived from the scalar extent the same way the birdview draws them
EGO_HALF = (2.45, 1.05)            # (half length, half width), meters


def _obb_axes(yaw: float):
    c, s = math.cos(yaw), math.sin(yaw)
    return np.array([c, s]), np.array([-s, c])


def _obb_overlap(ca, yaw_a, half_a, cb, yaw_b, half_b) -> bool:
    """Separating-axis test for two oriented rectangles."""
    ax = _obb_axes(yaw_a)
    bx = _obb_axes(yaw_b)
    d = np.asarray(cb, dtype=np.float64) - np.asarray(ca, dtype=np.float64)
    for axis in (*ax, *bx):
        ra = half_a[0] * abs(axis @ ax[0]) + half_a[1] * abs(axis @ ax[1])
        rb = half_b[0] * abs(axis @ bx[0]) + half_b[1] * abs(axis @ bx[1])
        if abs(d @ axis) > ra + rb:
            return False
    return True


def actor_half_extents(a: ScenarioActor):
    """(half length, half width) box for an actor: vehicles are elongated
    (matching the birdview raster, length 2*extent, width 1.4*extent);
    walkers are squares of their radius."""
    if a.kind == "vehicle":
        return (float(a.extent), 0.7 * float(a.extent))
    return (float(a.extent), float(a.extent))


def actors_collide(a: ScenarioActor, b: ScenarioActor) -> bool:
    """Oriented-box overlap between two scenario actors — the scripted-vs-
    scripted analog of :func:`check_collision` (OpenSCENARIO
    CollisionCondition between non-ego entities)."""
    if np.linalg.norm(a.position - b.position) > \
            math.hypot(*actor_half_extents(a)) \
            + math.hypot(*actor_half_extents(b)):
        return False
    return _obb_overlap(a.position, a.yaw, actor_half_extents(a),
                        b.position, b.yaw, actor_half_extents(b))


def check_collision(ego_xy: np.ndarray, ego_yaw: float,
                    actors: Sequence[ScenarioActor]) -> Optional[ScenarioActor]:
    """Oriented-box collision between the ego footprint and each actor.

    Circle tests cannot model cars: the ~4.9 m length would need a radius
    that false-positives on traffic one lane over (3.5 m lane spacing), and a
    width-sized radius misses real rear-ends. The reference relies on CARLA's
    physical collision sensor (box colliders); this is the kinematic analog.
    """
    ego_xy = np.asarray(ego_xy, dtype=np.float64)
    ego_diag = math.hypot(*EGO_HALF)
    for a in actors:
        # cheap reject: beyond the combined half-diagonals no overlap exists
        if np.linalg.norm(ego_xy - a.position) > ego_diag \
                + math.hypot(*actor_half_extents(a)):
            continue
        if _obb_overlap(ego_xy, ego_yaw, EGO_HALF,
                        a.position, a.yaw, actor_half_extents(a)):
            return a
    return None
