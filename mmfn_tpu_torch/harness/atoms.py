"""Composable behavior atoms — the srunner atomic-behavior vocabulary.

srunner builds every scenario out of ~40 reusable py_trees atoms
(scenario_runner/srunner/scenariomanager/scenarioatomics/atomic_behaviors.py
and atomic_trigger_conditions.py) composed with Sequence/Parallel operators;
adding a scenario type there means wiring atoms, not writing tick logic.
This module is the kinematic fake-world analog: an :class:`Atom` ticks
against a :class:`BehaviorContext` and returns RUNNING / SUCCESS / FAILURE,
:class:`Sequence` and :class:`Parallel` mirror the py_trees composition
semantics (Parallel's SUCCESS_ON_ONE / SUCCESS_ON_ALL policies), and
:class:`AtomBehavior` adapts a composed tree onto the ScenarioBehavior
protocol that ScenarioManagerLite drives — so new scenario types compose
instead of forking bespoke step() methods (harness/scenarios.py keeps the
original hand-written classes; the two catalogs interoperate).

Atom names follow their srunner sources so a scenario author can port a
behavior tree by transliteration:

- ActorTransformSetter   (atomic_behaviors.py:1849)
- KeepVelocity           (atomic_behaviors.py:1006)
- StopVehicle            (atomic_behaviors.py:1164)
- AccelerateToVelocity   (atomic_behaviors.py:874)
- AccelerateToCatchUp    (atomic_behaviors.py:927)
- LaneChange             (atomic_behaviors.py:1676)
- SyncArrival            (atomic_behaviors.py:1210)
- WaypointFollower       (atomic_behaviors.py:1456)
- Idle                   (atomic_behaviors.py:1416)
- HandBrakeVehicle       (atomic_behaviors.py:1780)
- ActorDestroy           (atomic_behaviors.py:1820)
- ChangeAutoPilot        (atomic_behaviors.py:760)
- KeepLongitudinalGap    (atomic_behaviors.py KeepLongitudinalGap)
- ActorSource            (atomic_behaviors.py:2119)
- ActorSink              (atomic_behaviors.py:2192)
- SetInitSpeed           (atomic_behaviors.py:1745)
- AddNoiseToVehicle      (atomic_behaviors.py:1288)
- BasicAgentBehavior     (atomic_behaviors.py:1367)
- ChangeWeather          (atomic_behaviors.py:190)
- TrafficLightStateSetter (atomic_behaviors.py:1902)
- InTriggerDistanceToVehicle   (atomic_trigger_conditions.py)
- InTriggerDistanceToLocation  (atomic_trigger_conditions.py)
- DriveDistance / EgoDriveDistance (atomic_trigger_conditions.py DriveDistance)
- StandStill             (atomic_trigger_conditions.py)
- InTimeToArrivalToVehicle     (atomic_trigger_conditions.py)
- InTimeToArrivalToLocation    (atomic_trigger_conditions.py:761)
- TriggerVelocity              (atomic_trigger_conditions.py:330)
- TriggerAcceleration          (atomic_trigger_conditions.py:374)
- RelativeVelocityToOtherActor (atomic_trigger_conditions.py:280)
- InTriggerRegion              (atomic_trigger_conditions.py:516)
- WaitUntilInFront             (atomic_trigger_conditions.py:965)
- WaitForTrafficLightState     (atomic_trigger_conditions.py:1128)
- TimeOfDayComparison          (atomic_trigger_conditions.py:421)
- ChangeNoiseParameters        (atomic_behaviors.py ChangeNoiseParameters)
- InTimeToArrivalToVehicleSideLane (atomic_trigger_conditions.py)
- InTriggerDistanceToNextIntersection (atomic_trigger_conditions.py:568)
- WaitEndIntersection          (atomic_trigger_conditions.py WaitEndIntersection)
- AtRightmostLane              (atomic_trigger_conditions.py AtRightmostLane)
- FailureIsSuccess             (py_trees decorators.FailureIsSuccess)

The world-service atoms (traffic lights, weather, time-of-day) reach the
route's SignalSet / fake world / WeatherSim through the driving
ScenarioManagerLite (``ctx.signals`` etc.) — the analog of srunner atoms
reading CarlaDataProvider's singletons; replay.run_route auto-wires them.

srunner atoms NOT mirrored here, and where their capability lives instead:

- ChangeActorControl / UpdateAllActorControls / ChangeActorTargetSpeed /
  ChangeActorWaypoints(+ToReachPosition) / ChangeActorLateralMotion /
  ActorTransformSetterToOSCPosition / OSCStartEndCondition /
  InTriggerDistanceToOSCPosition / InTimeToArrivalToOSCPosition — the
  OpenSCENARIO execution family; the OSC engine itself covers these
  (harness/openscenario.py actions + harness/actor_controls.py registry).
- StartRecorder / StopRecorder — harness/recording.py (EpisodeRecorder,
  driven by the runner, not by a scenario tree).
- ScenarioTriggerer / TrafficLightManipulator — route-scenario machinery:
  ScenarioManagerLite's trigger-radius activation and the SignalSet.
- RunScript — executes an external python during CARLA replay; no analog
  (the fake world has no out-of-band replay process).
- ChangeRoadFriction — no kinematic meaning (actors integrate velocities).
- InTimeToArrivalToVehicleSideLane's lane-topology variants beyond the
  trigger-frame lateral offset need a live adjacent-lane graph the trigger
  frame doesn't carry. (The junction/lane-id topology conditions —
  InTriggerDistanceToNextIntersection, WaitEndIntersection, AtRightmostLane
  — ARE mirrored: they query the route's vectorized map through
  ``ctx.rough_map``, auto-wired by replay.run_route, using the rmap's
  intersection flags, v3 road/lane ids and arclengths in place of the
  CARLA Waypoint API.)
- WaitForBlackboardVariable — py_trees blackboard plumbing; composition
  here passes Python state directly.

The port's own copy of the JAX package's ``harness/atoms.py``. Its last
lines register the atom-composed scenario types into the port's
``scenarios.SCENARIO_CLASSES``; ``mmfn_tpu_torch/harness/__init__.py``
imports this module for that, so the port's catalog equals the JAX
package's for any ``mmfn_tpu_torch.harness`` import.
"""

from __future__ import annotations

import math
import operator
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence as Seq, Tuple

import numpy as np

from mmfn_tpu_torch.harness.scenarios import (ScenarioActor, ScenarioBehavior,
                                        ScenarioTrigger)
from mmfn_tpu_torch.harness.weather import preset_family

RUNNING, SUCCESS, FAILURE = "running", "success", "failure"

EGO = "ego"   # reserved actor name resolving to the live ego state

# srunner's condition atoms take a comparison_operator (operator.gt default);
# composition sites here pass the name so trees stay declarative/serializable
_COMPARE = {"gt": operator.gt, "lt": operator.lt, "ge": operator.ge,
            "le": operator.le, "eq": operator.eq}


@dataclass
class BehaviorContext:
    """World state the atoms read and write: the trigger frame, the live ego,
    and the scenario's actors by name (py_trees atoms carry carla.Actor
    handles; here names key a dict so composition sites stay readable)."""

    trigger: ScenarioTrigger
    actor_id_base: int = 1000
    actors: Dict[str, ScenarioActor] = field(default_factory=dict)
    ego_xy: Optional[np.ndarray] = None
    ego_prev: Optional[np.ndarray] = None
    ego_speed: float = 0.0
    time: float = 0.0
    # monotonic spawn counter: actor ids are base + spawned*500 (the 500
    # stride matches the hand-written behaviors, scenarios.py:583-693).
    # len(actors) would REUSE a live id after an ActorSink/ActorDestroy
    # removal, and replay.py's per-id collision dedup would then silently
    # skip real collisions with the second holder.
    spawned: int = 0
    # additive ego steering perturbation set by AddNoiseToVehicle; the
    # AtomBehavior adapter surfaces it through ScenarioBehavior.steer_noise
    steer_noise: float = 0.0
    # back-pointer to the driving ScenarioManagerLite for world services
    # (None when the context is built standalone, e.g. unit tests)
    manager: object = None

    @property
    def signals(self):
        """The route's harness.traffic.SignalSet, or None."""
        return getattr(self.manager, "signals", None)

    @property
    def world(self):
        """The fake world (set_weather target), or None."""
        return getattr(self.manager, "world", None)

    @property
    def weather_sim(self):
        """The route's harness.weather.WeatherSim, or None."""
        return getattr(self.manager, "weather_sim", None)

    @property
    def rough_map(self):
        """The route's vectorized map (mapping.rough_map.RoughMap), or None —
        lane-topology atoms (next-intersection distance, rightmost lane)
        query it the way srunner atoms query the CARLA Waypoint API."""
        return getattr(self.manager, "rough_map", None)

    @property
    def game_time(self) -> float:
        """Sim seconds since ROUTE start (traffic-light phases run on this
        clock); scenario-local ``time`` is the fallback without a manager."""
        gt = getattr(self.manager, "game_time", None)
        return float(gt) if gt is not None else self.time

    def __post_init__(self):
        yaw = self.trigger.yaw
        self.ahead = np.array([math.cos(yaw), math.sin(yaw)])
        self.lateral = np.array([-self.ahead[1], self.ahead[0]])

    def observe(self, ego_xy: np.ndarray, dt: float) -> None:
        self.ego_prev = self.ego_xy
        self.ego_xy = np.asarray(ego_xy, dtype=np.float64).copy()
        if self.ego_prev is not None and dt > 0:
            self.ego_speed = float(
                np.linalg.norm(self.ego_xy - self.ego_prev)) / dt

    def position_of(self, name: str) -> Optional[np.ndarray]:
        if name == EGO:
            return self.ego_xy
        a = self.actors.get(name)
        return a.position if a is not None else None

    def speed_of(self, name: str) -> float:
        if name == EGO:
            return self.ego_speed
        a = self.actors.get(name)
        return float(np.linalg.norm(a.velocity)) if a is not None else 0.0

    def world_point(self, ahead: float, lateral: float) -> np.ndarray:
        """Trigger-frame offsets -> world coordinates."""
        return (np.array([self.trigger.x, self.trigger.y])
                + self.ahead * ahead + self.lateral * lateral)

    def velocity_of(self, name: str, dt: float) -> np.ndarray:
        """Velocity VECTOR of an actor (the ego's is the finite difference
        of its observed track, like CarlaDataProvider.get_velocity caches)."""
        if name == EGO:
            if self.ego_prev is not None and dt > 0:
                return (self.ego_xy - self.ego_prev) / dt
            return np.zeros(2)
        a = self.actors.get(name)
        return np.asarray(a.velocity, dtype=np.float64) if a is not None \
            else np.zeros(2)

    def pick_light(self, light_id: Optional[int] = None):
        """Resolve a TrafficLight from the route's SignalSet: by id, or the
        one nearest the trigger point (srunner atoms carry the actor handle;
        the trigger is the scenario's anchor here). None when the context has
        no signals — service atoms turn that into FAILURE, the 'actor is
        gone' analog of the srunner originals."""
        sig = self.signals
        if sig is None or not sig.lights:
            return None
        if light_id is not None:
            for li in sig.lights:
                if li.light_id == light_id:
                    return li
            return None
        anchor = np.array([self.trigger.x, self.trigger.y])
        return min(sig.lights,
                   key=lambda li: float(np.linalg.norm(li.position - anchor)))


class Atom:
    """One behavior-tree leaf/composite. tick() is called every world tick
    while the atom is active; initialise() runs on the first tick (py_trees'
    initialise contract), so Sequence children set up lazily in order."""

    def tick(self, ctx: BehaviorContext, dt: float) -> str:
        raise NotImplementedError

    def reset(self) -> None:
        """Return to the never-ticked state (Sequence reuse)."""


# --------------------------------------------------------------------------- #
# composites (py_trees.composites analog)
# --------------------------------------------------------------------------- #


class Sequence(Atom):
    """Children run one after another; SUCCESS when the last one succeeds,
    FAILURE aborts (py_trees.composites.Sequence)."""

    def __init__(self, *children: Atom):
        self.children = list(children)
        self._i = 0

    def tick(self, ctx, dt):
        while self._i < len(self.children):
            status = self.children[self._i].tick(ctx, dt)
            if status == RUNNING:
                return RUNNING
            if status == FAILURE:
                return FAILURE
            self._i += 1
            # a freshly-succeeded child yields the tick to its successor only
            # if that successor is instantaneous; motion atoms consume the
            # tick they were reached on (matches py_trees' one-tick cascade)
        return SUCCESS

    def reset(self):
        self._i = 0
        for c in self.children:
            c.reset()


class FailureIsSuccess(Atom):
    """Decorator converting a child's FAILURE into SUCCESS (py_trees
    decorators.FailureIsSuccess) — used to make world-service atoms optional
    on routes that lack the service (e.g. TrafficLightStateSetter on an
    unsignalized route)."""

    def __init__(self, child: Atom):
        self.child = child

    def tick(self, ctx, dt):
        status = self.child.tick(ctx, dt)
        return SUCCESS if status == FAILURE else status

    def reset(self):
        self.child.reset()


class Parallel(Atom):
    """Children tick together every cycle. policy='one': SUCCESS as soon as
    any child succeeds (py_trees SUCCESS_ON_ONE — srunner's usual "behavior
    races its end condition" shape); policy='all': all must succeed."""

    def __init__(self, *children: Atom, policy: str = "one"):
        assert policy in ("one", "all"), policy
        self.children = list(children)
        self.policy = policy
        self._done: List[bool] = [False] * len(children)

    def tick(self, ctx, dt):
        any_success = False
        for i, child in enumerate(self.children):
            if self._done[i]:
                continue
            status = child.tick(ctx, dt)
            if status == FAILURE:
                return FAILURE
            if status == SUCCESS:
                self._done[i] = True
                any_success = True
        if self.policy == "one" and any_success:
            return SUCCESS
        if self.policy == "all" and all(self._done):
            return SUCCESS
        return RUNNING

    def reset(self):
        self._done = [False] * len(self.children)
        for c in self.children:
            c.reset()


# --------------------------------------------------------------------------- #
# motion atoms (atomic_behaviors.py analogs)
# --------------------------------------------------------------------------- #


class ActorTransformSetter(Atom):
    """Spawn (or teleport) an actor at trigger-frame offsets
    (atomic_behaviors.py:1849 ActorTransformSetter — there it sets an
    existing carla.Actor's transform; here first use creates the actor).
    heading_deg is relative to the trigger yaw. Succeeds immediately."""

    def __init__(self, name: str, ahead: float, lateral: float = 0.0,
                 heading_deg: float = 0.0, kind: str = "vehicle",
                 extent: float = 2.2, speed: float = 0.0):
        self.name, self.ahead, self.lateral = name, ahead, lateral
        self.heading_deg, self.kind, self.extent = heading_deg, kind, extent
        self.speed = speed

    def tick(self, ctx, dt):
        yaw = ctx.trigger.yaw + math.radians(self.heading_deg)
        direction = np.array([math.cos(yaw), math.sin(yaw)])
        pos = ctx.world_point(self.ahead, self.lateral)
        actor = ctx.actors.get(self.name)
        if actor is None:
            actor = ScenarioActor(self.kind, pos, direction * self.speed,
                                  yaw=yaw, extent=self.extent,
                                  actor_id=ctx.actor_id_base
                                  + ctx.spawned * 500)
            ctx.spawned += 1
            ctx.actors[self.name] = actor
        else:
            actor.position = pos
            actor.velocity = direction * self.speed
            actor.yaw = yaw
        return SUCCESS


class KeepVelocity(Atom):
    """Hold a target speed along the actor's current heading
    (atomic_behaviors.py:1006). Bounded by duration and/or distance like the
    source (whichever first); unbounded -> RUNNING forever, meant to race an
    end condition inside a Parallel."""

    def __init__(self, name: str, speed: float,
                 duration: Optional[float] = None,
                 distance: Optional[float] = None):
        self.name, self.speed = name, speed
        self.duration, self.distance = duration, distance
        self._t = 0.0
        self._start: Optional[np.ndarray] = None

    def tick(self, ctx, dt):
        a = ctx.actors.get(self.name)
        if a is None:
            return FAILURE
        if self._start is None:
            self._start = a.position.copy()
        heading = np.array([math.cos(a.yaw), math.sin(a.yaw)])
        a.velocity = heading * self.speed
        self._t += dt
        if self.duration is not None and self._t >= self.duration:
            return SUCCESS
        if self.distance is not None and float(
                np.linalg.norm(a.position - self._start)) >= self.distance:
            return SUCCESS
        return RUNNING

    def reset(self):
        self._t, self._start = 0.0, None


class StopVehicle(Atom):
    """Full-brake to standstill (atomic_behaviors.py:1164): brake_value
    scales the kinematic max decel like CARLA's brake pedal."""

    MAX_DECEL = 8.0   # KinematicWorld full-brake decel, m/s^2

    def __init__(self, name: str, brake_value: float = 1.0):
        self.name = name
        self.decel = brake_value * self.MAX_DECEL

    def tick(self, ctx, dt):
        a = ctx.actors.get(self.name)
        if a is None:
            return FAILURE
        speed = float(np.linalg.norm(a.velocity))
        if speed <= 1e-3:
            a.velocity = np.zeros(2)
            return SUCCESS
        new_speed = max(0.0, speed - self.decel * dt)
        a.velocity = a.velocity * (new_speed / speed)
        return RUNNING


class AccelerateToVelocity(Atom):
    """Throttle until the target speed (atomic_behaviors.py:874)."""

    MAX_ACCEL = 4.0   # kinematic full-throttle accel, m/s^2

    def __init__(self, name: str, target_speed: float,
                 throttle_value: float = 1.0):
        self.name, self.target = name, target_speed
        self.accel = throttle_value * self.MAX_ACCEL

    def tick(self, ctx, dt):
        a = ctx.actors.get(self.name)
        if a is None:
            return FAILURE
        speed = float(np.linalg.norm(a.velocity))
        if speed >= self.target - 1e-3:
            return SUCCESS
        heading = (a.velocity / speed if speed > 1e-6
                   else np.array([math.cos(a.yaw), math.sin(a.yaw)]))
        a.velocity = heading * min(self.target, speed + self.accel * dt)
        return RUNNING


class AccelerateToCatchUp(Atom):
    """Accelerate up to (reference speed + delta) until the actor sits
    trigger_distance AHEAD of the reference along the trigger direction
    (atomic_behaviors.py:927: throttle_value/delta_velocity/trigger_distance/
    max_distance); FAILURE if it burns max_distance without catching up."""

    MAX_ACCEL = 4.0

    def __init__(self, name: str, reference: str = EGO,
                 delta_velocity: float = 10.0, trigger_distance: float = 5.0,
                 max_distance: float = 500.0, throttle_value: float = 1.0):
        self.name, self.reference = name, reference
        self.delta, self.trigger_distance = delta_velocity, trigger_distance
        self.max_distance = max_distance
        self.accel = throttle_value * self.MAX_ACCEL
        self._start: Optional[np.ndarray] = None

    def tick(self, ctx, dt):
        a = ctx.actors.get(self.name)
        ref_pos = ctx.position_of(self.reference)
        if a is None:
            return FAILURE
        if self._start is None:
            self._start = a.position.copy()
        target_speed = ctx.speed_of(self.reference) + self.delta
        speed = float(np.linalg.norm(a.velocity))
        heading = (a.velocity / speed if speed > 1e-6
                   else np.array([math.cos(a.yaw), math.sin(a.yaw)]))
        a.velocity = heading * min(target_speed, speed + self.accel * dt)
        if ref_pos is not None and float(
                (a.position - ref_pos) @ ctx.ahead) >= self.trigger_distance:
            return SUCCESS
        if float(np.linalg.norm(a.position - self._start)) > self.max_distance:
            return FAILURE
        return RUNNING

    def reset(self):
        self._start = None


class LaneChange(Atom):
    """Slide one lane over while keeping the longitudinal speed
    (atomic_behaviors.py:1676 LaneChange / :681 ChangeActorLateralMotion).
    direction follows the srunner convention: 'left' is +lateral in the
    trigger frame."""

    def __init__(self, name: str, direction: str = "left",
                 lane_width: float = 3.5, seconds: float = 1.5):
        self.name = name
        self.sign = 1.0 if direction == "left" else -1.0
        self.lane_width, self.seconds = lane_width, seconds
        self._t = 0.0

    def tick(self, ctx, dt):
        a = ctx.actors.get(self.name)
        if a is None:
            return FAILURE
        forward_speed = abs(float(a.velocity @ ctx.ahead))
        rate = self.lane_width / self.seconds
        a.velocity = (ctx.ahead * forward_speed
                      + ctx.lateral * self.sign * rate)
        self._t += dt
        if self._t >= self.seconds:
            a.velocity = ctx.ahead * forward_speed
            return SUCCESS
        return RUNNING

    def reset(self):
        self._t = 0.0


class SyncArrival(Atom):
    """Pace the actor so it reaches a conflict point exactly when the ego
    does (atomic_behaviors.py:1210-1274): per tick the control is
    ``gain * (t_actor - t_ego)`` where each t is distance-over-speed; an ego
    at rest makes t_ego infinite, braking the actor (the crossing
    negotiation). RUNNING forever — race it against a distance condition in
    a Parallel, like srunner does."""

    def __init__(self, name: str, conflict_ahead: float,
                 conflict_lateral: float = 0.0, target_speed: float = 15.0,
                 gain: float = 1.0, accel: float = 4.0, brake: float = 8.0):
        self.name = name
        self.conflict = (conflict_ahead, conflict_lateral)
        self.target_speed, self.gain = target_speed, gain
        self.accel, self.brake = accel, brake

    def tick(self, ctx, dt):
        a = ctx.actors.get(self.name)
        if a is None:
            return FAILURE
        cp = ctx.world_point(*self.conflict)
        d_ego = (float(np.linalg.norm(ctx.ego_xy - cp))
                 if ctx.ego_xy is not None else math.inf)
        d_act = float(np.linalg.norm(a.position - cp))
        speed = float(np.linalg.norm(a.velocity))
        t_ego = d_ego / ctx.ego_speed if ctx.ego_speed > 0.1 else math.inf
        t_act = d_act / speed if speed > 0.1 else math.inf
        if math.isinf(t_ego):
            control = -1.0        # ego waiting: wait too
        elif math.isinf(t_act):
            control = 1.0         # from rest: throttle toward the junction
        else:
            control = max(-1.0, min(1.0, self.gain * (t_act - t_ego)))
        dv = (self.accel if control > 0 else self.brake) * control * dt
        new_speed = max(0.0, min(self.target_speed, speed + dv))
        heading = ((cp - a.position) / d_act if d_act > 1e-6
                   else np.array([math.cos(a.yaw), math.sin(a.yaw)]))
        a.velocity = heading * new_speed
        return RUNNING


class WaypointFollower(Atom):
    """Drive through trigger-frame waypoints at a fixed speed
    (atomic_behaviors.py:1456, kinematic reduction). SUCCESS at the last
    waypoint."""

    def __init__(self, name: str, waypoints: Seq[Tuple[float, float]],
                 speed: float = 10.0, tolerance: float = 1.0):
        self.name = name
        self.waypoints = list(waypoints)
        self.speed, self.tolerance = speed, tolerance
        self._i = 0

    def tick(self, ctx, dt):
        a = ctx.actors.get(self.name)
        if a is None:
            return FAILURE
        while self._i < len(self.waypoints):
            target = ctx.world_point(*self.waypoints[self._i])
            gap = target - a.position
            d = float(np.linalg.norm(gap))
            if d > self.tolerance:
                a.velocity = gap / d * self.speed
                a.yaw = math.atan2(gap[1], gap[0])
                return RUNNING
            self._i += 1
        a.velocity = np.zeros(2)
        return SUCCESS

    def reset(self):
        self._i = 0


class Idle(Atom):
    """Do nothing for a duration (atomic_behaviors.py:1416)."""

    def __init__(self, duration: float):
        self.duration = duration
        self._t = 0.0

    def tick(self, ctx, dt):
        self._t += dt
        return SUCCESS if self._t >= self.duration else RUNNING

    def reset(self):
        self._t = 0.0


class HandBrakeVehicle(Atom):
    """Lock the actor in place (atomic_behaviors.py:1780)."""

    def __init__(self, name: str):
        self.name = name

    def tick(self, ctx, dt):
        a = ctx.actors.get(self.name)
        if a is None:
            return FAILURE
        a.velocity = np.zeros(2)
        return SUCCESS


class ActorDestroy(Atom):
    """Remove the actor from the world (atomic_behaviors.py:1820)."""

    def __init__(self, name: str):
        self.name = name

    def tick(self, ctx, dt):
        ctx.actors.pop(self.name, None)
        return SUCCESS


class ChangeAutoPilot(Atom):
    """Hand the actor to 'traffic-manager autopilot' at a target speed
    (atomic_behaviors.py:760 ChangeAutoPilot with its max_speed parameter).
    The kinematic analog of TM cruise is straight-line travel along the
    actor's heading at that speed — set it and SUCCEED immediately; the
    world integrates it thereafter (ScenarioActor.step)."""

    def __init__(self, name: str, target_speed: float):
        self.name, self.target_speed = name, target_speed

    def tick(self, ctx, dt):
        a = ctx.actors.get(self.name)
        if a is None:
            return FAILURE
        heading = np.array([math.cos(a.yaw), math.sin(a.yaw)])
        a.velocity = heading * self.target_speed
        return SUCCESS


class KeepLongitudinalGap(Atom):
    """Regulate the actor's speed to hold ``gap`` metres behind a reference
    along the trigger direction (atomic_behaviors.py KeepLongitudinalGap —
    srunner's TM distance_to_leading_vehicle analog). Proportional control
    bounded by kinematic accel/brake; RUNNING forever unless
    ``stop_on_reach`` (then SUCCESS inside ``tolerance``)."""

    ACCEL, BRAKE = 4.0, 8.0

    def __init__(self, name: str, reference: str = EGO, gap: float = 8.0,
                 gain: float = 0.5, max_speed: float = 25.0,
                 stop_on_reach: bool = False, tolerance: float = 1.0):
        self.name, self.reference, self.gap = name, reference, gap
        self.gain, self.max_speed = gain, max_speed
        self.stop_on_reach, self.tolerance = stop_on_reach, tolerance

    def tick(self, ctx, dt):
        a = ctx.actors.get(self.name)
        ref = ctx.position_of(self.reference)
        if a is None:
            return FAILURE
        if ref is None:
            return RUNNING
        actual = float((ref - a.position) @ ctx.ahead)   # + = actor behind
        err = actual - self.gap                          # + = too far back
        speed = float(np.linalg.norm(a.velocity))
        target = ctx.speed_of(self.reference) + self.gain * err
        target = max(0.0, min(self.max_speed, target))
        dv = target - speed
        dv = max(-self.BRAKE * dt, min(self.ACCEL * dt, dv))
        heading = (a.velocity / speed if speed > 1e-6
                   else np.array([math.cos(a.yaw), math.sin(a.yaw)]))
        a.velocity = heading * (speed + dv)
        if self.stop_on_reach and abs(err) <= self.tolerance:
            return SUCCESS
        return RUNNING


class ActorSource(Atom):
    """Stream actors into the world from a spawn transform
    (atomic_behaviors.py:2119 ActorSource): a new one appears whenever the
    previous spawn has cleared ``gap`` metres of the spawn point, each
    driving straight at ``speed`` along its heading. RUNNING forever —
    compose under a Parallel raced by the scenario's end condition."""

    def __init__(self, prefix: str, ahead: float, lateral: float = 0.0,
                 heading_deg: float = 0.0, speed: float = 10.0,
                 gap: float = 20.0, kind: str = "vehicle",
                 extent: float = 2.2, max_actors: int = 16):
        self.prefix = prefix
        self.ahead, self.lateral = ahead, lateral
        self.heading_deg, self.speed = heading_deg, speed
        self.gap, self.kind, self.extent = gap, kind, extent
        self.max_actors = max_actors
        self._count = 0

    def tick(self, ctx, dt):
        spawn = ctx.world_point(self.ahead, self.lateral)
        clear = all(
            float(np.linalg.norm(a.position - spawn)) >= self.gap
            for n, a in ctx.actors.items() if n.startswith(self.prefix))
        if clear and self._count < self.max_actors:
            ActorTransformSetter(
                f"{self.prefix}_{self._count}", self.ahead, self.lateral,
                heading_deg=self.heading_deg, kind=self.kind,
                extent=self.extent, speed=self.speed).tick(ctx, dt)
            self._count += 1
        return RUNNING

    def reset(self):
        self._count = 0


class ActorSink(Atom):
    """Retire streamed actors reaching a drain location
    (atomic_behaviors.py:2192 ActorSink): any ``prefix``-named actor within
    ``radius`` of the sink point is destroyed. RUNNING forever."""

    def __init__(self, ahead: float, lateral: float = 0.0,
                 radius: float = 6.0, prefix: str = ""):
        self.loc = (ahead, lateral)
        self.radius, self.prefix = radius, prefix

    def tick(self, ctx, dt):
        drain = ctx.world_point(*self.loc)
        for name in [n for n, a in ctx.actors.items()
                     if n.startswith(self.prefix)
                     and float(np.linalg.norm(a.position - drain))
                     < self.radius]:
            ctx.actors.pop(name)
        return RUNNING


class SetInitSpeed(Atom):
    """Set the actor's velocity along its heading once and succeed
    (atomic_behaviors.py:1745 SetInitSpeed: set_target_velocity from the
    transform yaw, SUCCESS on the first update)."""

    def __init__(self, name: str, init_speed: float = 10.0):
        self.name, self.init_speed = name, init_speed

    def tick(self, ctx, dt):
        a = ctx.actors.get(self.name)
        if a is None:
            return FAILURE
        heading = np.array([math.cos(a.yaw), math.sin(a.yaw)])
        a.velocity = heading * self.init_speed
        return SUCCESS


class AddNoiseToVehicle(Atom):
    """Jitter the ego's steering (atomic_behaviors.py:1288 AddNoiseToVehicle
    — srunner perturbs the ego control for the ticks it runs; ControlLoss
    fires it in short bursts). Kinematic analog: hold the additive
    perturbation on ``ctx.steer_noise`` for ``duration`` seconds (the
    AtomBehavior adapter publishes it through ScenarioBehavior.steer_noise,
    which replay.py adds to the ego command), then clear it and succeed.
    ``throttle_value`` is accepted for signature parity but has no kinematic
    counterpart (the ego integrates its own controller's speed)."""

    def __init__(self, steer_value: float, throttle_value: float = 0.0,
                 duration: float = 0.5):
        self.steer_value = steer_value
        self.throttle_value = throttle_value   # parity only, unused
        self.duration = duration
        self._t = 0.0

    def tick(self, ctx, dt):
        self._t += dt
        if self._t >= self.duration:
            ctx.steer_noise = 0.0
            return SUCCESS
        ctx.steer_noise = self.steer_value
        return RUNNING

    def reset(self):
        self._t = 0.0


class BasicAgentBehavior(Atom):
    """Drive the actor to a trigger-frame target location
    (atomic_behaviors.py:1367 BasicAgentBehavior: CARLA BasicAgent until
    within _acceptable_target_distance = 2 m). Kinematic reduction:
    straight-line pursuit at ``target_speed``, stop + SUCCESS inside 2 m."""

    ACCEPTABLE_TARGET_DISTANCE = 2.0   # atomic_behaviors.py:1379

    def __init__(self, name: str, ahead: float, lateral: float = 0.0,
                 target_speed: float = 10.0):
        self.name = name
        self.loc = (ahead, lateral)
        self.target_speed = target_speed

    def tick(self, ctx, dt):
        a = ctx.actors.get(self.name)
        if a is None:
            return FAILURE
        gap = ctx.world_point(*self.loc) - a.position
        d = float(np.linalg.norm(gap))
        if d < self.ACCEPTABLE_TARGET_DISTANCE:
            a.velocity = np.zeros(2)
            return SUCCESS
        a.velocity = gap / d * self.target_speed
        a.yaw = math.atan2(gap[1], gap[0])
        return RUNNING


class ChangeWeather(Atom):
    """Switch the route's weather preset (atomic_behaviors.py:190
    ChangeWeather writes the blackboard weather that WeatherBehavior then
    applies each tick; here the WeatherSim -> world.set_weather pipeline in
    replay.py IS that per-tick applier, so retargeting the sim sticks).
    Pushes once directly when the context has a world but no sim. FAILURE
    without either service (standalone context)."""

    def __init__(self, preset: str):
        self.preset = preset

    def tick(self, ctx, dt):
        ws, world = ctx.weather_sim, ctx.world
        if ws is None and world is None:
            return FAILURE
        if ws is not None:
            ws.preset = self.preset
            ws.family = preset_family(self.preset)
        if world is not None:
            if ws is not None:
                world.set_weather(ws.current_preset(), ws.sun_altitude_deg)
            else:
                world.set_weather(self.preset)
        return SUCCESS


class TrafficLightStateSetter(Atom):
    """Force a traffic light's state (atomic_behaviors.py:1902
    TrafficLightStateSetter -> carla TrafficLight.set_state). The light is
    ``light_id`` or the one nearest the trigger; the srunner setter persists
    until something else changes the light, which for our phase-cycling
    lights means an explicit ``duration`` hold (TrafficLight.forced_state),
    after which the cycle resumes. SUCCESS after setting; FAILURE when the
    route has no lights — the source's dead-actor branch."""

    def __init__(self, state: str, duration: float = 20.0,
                 light_id: Optional[int] = None):
        assert state in ("red", "yellow", "green"), state
        self.state, self.duration, self.light_id = state, duration, light_id

    def tick(self, ctx, dt):
        light = ctx.pick_light(self.light_id)
        if light is None:
            return FAILURE
        light.forced_state = self.state
        light.forced_state_until = ctx.game_time + self.duration
        return SUCCESS


# --------------------------------------------------------------------------- #
# condition atoms (atomic_trigger_conditions.py analogs: RUNNING until the
# condition holds, then SUCCESS — srunner races these against motion atoms)
# --------------------------------------------------------------------------- #


class ChangeNoiseParameters(Atom):
    """Re-draw the jitter magnitudes AddNoiseToVehicle applies
    (atomic_behaviors.py:1327 ChangeNoiseParameters: one gaussian draw
    |N(mean, std)|, steering cell gets min(0, -(draw - dynamic_mean)),
    SUCCESS after one iteration). Kinematic analog: writes the steering
    perturbation straight onto ``ctx.steer_noise``; the throttle cell has no
    kinematic counterpart (accepted for signature parity). Deterministic:
    the draw is seeded, not global-random."""

    def __init__(self, noise_mean: float = 0.02, noise_std: float = 0.01,
                 dynamic_mean_for_steer: float = 0.001,
                 dynamic_mean_for_throttle: float = 0.015,
                 seed: int = 0):
        self.dynamic_mean_for_steer = dynamic_mean_for_steer
        self.dynamic_mean_for_throttle = dynamic_mean_for_throttle  # parity
        self._draw = abs(float(
            np.random.default_rng(seed).normal(noise_mean, noise_std)))

    def tick(self, ctx, dt):
        ctx.steer_noise = min(0.0, -(self._draw
                                     - self.dynamic_mean_for_steer))
        return SUCCESS


class InTriggerDistanceToVehicle(Atom):
    def __init__(self, name: str, other: str = EGO, distance: float = 10.0):
        self.name, self.other, self.distance = name, other, distance

    def tick(self, ctx, dt):
        a, b = ctx.position_of(self.name), ctx.position_of(self.other)
        if a is None or b is None:
            return RUNNING
        return SUCCESS if float(np.linalg.norm(a - b)) < self.distance \
            else RUNNING


class InTriggerDistanceToLocation(Atom):
    def __init__(self, name: str, ahead: float, lateral: float = 0.0,
                 distance: float = 5.0):
        self.name = name
        self.loc = (ahead, lateral)
        self.distance = distance

    def tick(self, ctx, dt):
        pos = ctx.position_of(self.name)
        if pos is None:
            return RUNNING
        return SUCCESS if float(np.linalg.norm(
            pos - ctx.world_point(*self.loc))) < self.distance else RUNNING


class DriveDistance(Atom):
    """SUCCESS once the actor has accumulated `distance` of travel."""

    def __init__(self, name: str, distance: float):
        self.name, self.distance = name, distance
        self._driven = 0.0
        self._last: Optional[np.ndarray] = None

    def tick(self, ctx, dt):
        pos = ctx.position_of(self.name)
        if pos is None:
            return RUNNING
        if self._last is not None:
            self._driven += float(np.linalg.norm(pos - self._last))
        self._last = np.asarray(pos, dtype=np.float64).copy()
        return SUCCESS if self._driven >= self.distance else RUNNING

    def reset(self):
        self._driven, self._last = 0.0, None


def EgoDriveDistance(distance: float) -> DriveDistance:
    """srunner's scenario-ending DriveDistance(ego) shorthand."""
    return DriveDistance(EGO, distance)


class InTimeToArrivalToVehicle(Atom):
    """SUCCESS once the closing time between two actors drops under
    ``time`` seconds (atomic_trigger_conditions.py
    InTimeToArrivalToVehicle: gap distance over closing speed; a
    non-closing pair never triggers)."""

    def __init__(self, name: str, other: str = EGO, time: float = 3.0):
        self.name, self.other, self.time = name, other, time

    def tick(self, ctx, dt):
        a, b = ctx.position_of(self.name), ctx.position_of(self.other)
        if a is None or b is None:
            return RUNNING
        gap = float(np.linalg.norm(a - b))
        va = (ctx.actors[self.name].velocity
              if self.name in ctx.actors else np.zeros(2))
        if self.other == EGO:
            vb = ((ctx.ego_xy - ctx.ego_prev) / dt
                  if ctx.ego_prev is not None and dt > 0 else np.zeros(2))
        else:
            vb = (ctx.actors[self.other].velocity
                  if self.other in ctx.actors else np.zeros(2))
        closing = -float((np.asarray(va) - np.asarray(vb)) @ (a - b)) / gap \
            if gap > 1e-6 else math.inf
        if closing <= 0.01:
            return RUNNING
        return SUCCESS if gap / closing < self.time else RUNNING


class StandStill(Atom):
    """SUCCESS once the actor has been stationary for `duration` seconds."""

    def __init__(self, name: str, duration: float = 1.0):
        self.name, self.duration = name, duration
        self._still = 0.0

    def tick(self, ctx, dt):
        self._still = self._still + dt if ctx.speed_of(self.name) < 0.1 \
            else 0.0
        return SUCCESS if self._still >= self.duration else RUNNING

    def reset(self):
        self._still = 0.0


class InTimeToArrivalToLocation(Atom):
    """SUCCESS when the actor can reach a trigger-frame location within
    ``time`` seconds (atomic_trigger_conditions.py:761: distance over speed;
    at rest the time-to-arrival is infinite and the condition keeps
    RUNNING)."""

    def __init__(self, name: str, time: float, ahead: float,
                 lateral: float = 0.0, comparison: str = "lt"):
        self.name, self.time = name, time
        self.loc = (ahead, lateral)
        self.cmp = _COMPARE[comparison]

    def tick(self, ctx, dt):
        pos = ctx.position_of(self.name)
        if pos is None:
            return RUNNING
        d = float(np.linalg.norm(pos - ctx.world_point(*self.loc)))
        v = ctx.speed_of(self.name)
        tta = d / v if v > 1e-6 else math.inf
        return SUCCESS if self.cmp(tta, self.time) else RUNNING


class InTimeToArrivalToVehicleSideLane(Atom):
    """SUCCESS when the actor can reach the lane BESIDE another actor within
    ``time`` seconds — cut-in support (atomic_trigger_conditions.py
    InTimeToArrivalToVehicleSideLane: the target is one lane over from the
    other actor's live position; the source's ``cut_in_lane='right'`` maps
    to the other's get_left_lane(), i.e. +lateral here, and vice versa)."""

    def __init__(self, name: str, other: str = EGO, time: float = 3.0,
                 side_lane: str = "right", lane_width: float = 3.5):
        assert side_lane in ("left", "right"), side_lane
        self.name, self.other, self.time = name, other, time
        self.shift = lane_width if side_lane == "right" else -lane_width

    def tick(self, ctx, dt):
        pos = ctx.position_of(self.name)
        ref = ctx.position_of(self.other)
        if pos is None or ref is None:
            return RUNNING
        target = ref + ctx.lateral * self.shift
        v = ctx.speed_of(self.name)
        tta = float(np.linalg.norm(pos - target)) / v if v > 1e-6 \
            else math.inf
        return SUCCESS if tta < self.time else RUNNING


class TriggerVelocity(Atom):
    """SUCCESS when the actor's speed compares true against the target
    (atomic_trigger_conditions.py:330, comparison_operator default gt)."""

    def __init__(self, name: str, target_velocity: float,
                 comparison: str = "gt"):
        self.name, self.target = name, target_velocity
        self.cmp = _COMPARE[comparison]

    def tick(self, ctx, dt):
        return SUCCESS if self.cmp(ctx.speed_of(self.name), self.target) \
            else RUNNING


class TriggerAcceleration(Atom):
    """SUCCESS when the actor's linear acceleration compares true against
    the target (atomic_trigger_conditions.py:374 reads
    actor.get_acceleration(); the kinematic world differentiates the
    velocity vector across ticks)."""

    def __init__(self, name: str, target_acceleration: float,
                 comparison: str = "gt"):
        self.name, self.target = name, target_acceleration
        self.cmp = _COMPARE[comparison]
        self._prev: Optional[np.ndarray] = None

    def tick(self, ctx, dt):
        v = ctx.velocity_of(self.name, dt)
        if self._prev is None or dt <= 0:
            self._prev = v
            return RUNNING
        accel = float(np.linalg.norm(v - self._prev)) / dt
        self._prev = v
        return SUCCESS if self.cmp(accel, self.target) else RUNNING

    def reset(self):
        self._prev = None


class RelativeVelocityToOtherActor(Atom):
    """SUCCESS when (actor speed - other's speed) compares true against
    ``speed`` (atomic_trigger_conditions.py:280)."""

    def __init__(self, name: str, other: str = EGO, speed: float = 0.0,
                 comparison: str = "gt"):
        self.name, self.other, self.speed = name, other, speed
        self.cmp = _COMPARE[comparison]

    def tick(self, ctx, dt):
        rel = ctx.speed_of(self.name) - ctx.speed_of(self.other)
        return SUCCESS if self.cmp(rel, self.speed) else RUNNING


class InTriggerRegion(Atom):
    """SUCCESS when the actor sits inside a rectangle
    (atomic_trigger_conditions.py:516). srunner's box is world-axis-aligned;
    ours lives in the trigger frame (x = ahead, y = lateral) so the same
    scenario composes onto routes of any orientation."""

    def __init__(self, name: str, min_x: float, max_x: float,
                 min_y: float, max_y: float):
        self.name = name
        self.min_x, self.max_x = min_x, max_x
        self.min_y, self.max_y = min_y, max_y

    def tick(self, ctx, dt):
        pos = ctx.position_of(self.name)
        if pos is None:
            return RUNNING
        rel = pos - np.array([ctx.trigger.x, ctx.trigger.y])
        ax, lat = float(rel @ ctx.ahead), float(rel @ ctx.lateral)
        inside = (self.min_x <= ax <= self.max_x
                  and self.min_y <= lat <= self.max_y)
        return SUCCESS if inside else RUNNING


class WaitUntilInFront(Atom):
    """SUCCESS once the actor has passed ``other`` — cut-in support
    (atomic_trigger_conditions.py:965: in front = beyond a waypoint
    factor*(sum of bounding extents) ahead of the other actor, close-by =
    within 10 m of that waypoint). Kinematic reduction: the trigger
    direction stands in for the other actor's lane forward vector."""

    CLOSE_DISTANCE = 10.0            # the source's self._distance
    EGO_EXTENT = 2.45                # Lincoln MKZ half-length

    def __init__(self, name: str, other: str = EGO, factor: float = 1.0,
                 check_distance: bool = True):
        self.name, self.other = name, other
        self.factor = max(1e-6, factor)
        self.check_distance = check_distance

    def _extent(self, ctx, name: str) -> float:
        if name == EGO:
            return self.EGO_EXTENT
        a = ctx.actors.get(name)
        return float(a.extent) if a is not None else self.EGO_EXTENT

    def tick(self, ctx, dt):
        pos = ctx.position_of(self.name)
        ref = ctx.position_of(self.other)
        if pos is None or ref is None:
            return RUNNING
        length = self.factor * (self._extent(ctx, self.name)
                                + self._extent(ctx, self.other))
        front_point = ref + ctx.ahead * length
        in_front = float((pos - front_point) @ ctx.ahead) > 0.0
        close_by = (not self.check_distance
                    or float(np.linalg.norm(pos - front_point))
                    < self.CLOSE_DISTANCE)
        return SUCCESS if in_front and close_by else RUNNING


class WaitForTrafficLightState(Atom):
    """SUCCESS when the selected light shows ``state``
    (atomic_trigger_conditions.py:1128: poll actor.state; FAILURE on a dead
    actor — here, a route with no lights). Light selection as in
    TrafficLightStateSetter (id, else nearest to the trigger)."""

    def __init__(self, state: str, light_id: Optional[int] = None):
        assert state in ("red", "yellow", "green"), state
        self.state, self.light_id = state, light_id

    def tick(self, ctx, dt):
        light = ctx.pick_light(self.light_id)
        if light is None:
            return FAILURE
        return SUCCESS if light.state(ctx.game_time) == self.state \
            else RUNNING


class TimeOfDayComparison(Atom):
    """SUCCESS when the weather clock compares true against ``hour``
    (atomic_trigger_conditions.py:421 compares the blackboard "Datetime"
    that weather_sim advances; WeatherSim.clock_hour is that clock — it runs
    even with sun animation off). RUNNING without a weather sim, matching
    the source's missing-blackboard no-op."""

    def __init__(self, hour: float, comparison: str = "gt"):
        self.hour = hour
        self.cmp = _COMPARE[comparison]

    def tick(self, ctx, dt):
        ws = ctx.weather_sim
        if ws is None:
            return RUNNING
        return SUCCESS if self.cmp(ws.clock_hour, self.hour) else RUNNING


# --------------------------------------------------------------------------- #
# lane-topology conditions (query the vectorized map the way srunner
# queries the CARLA Waypoint API; RUNNING without a wired rough_map)
# --------------------------------------------------------------------------- #


def _distance_to_next_intersection(rough_map, xy: np.ndarray
                                   ) -> Optional[float]:
    """Arclength from the point's lane projection to the first
    intersection-flagged node AHEAD on that lane (rmap node column 2 is the
    OpenDRIVE junction flag); falls back to the euclidean distance to the
    nearest flagged node anywhere when the point's own lane has none (or
    the map carries no v3 arclengths). None when the map has no junctions."""
    from mmfn_tpu_torch.mapping.rough_map import locate_on_lane

    try:
        road_id, lane_id, s, _ = locate_on_lane(
            rough_map, float(xy[0]), float(xy[1]))
    except KeyError:
        road_id = None
    if road_id is not None:
        for lane in rough_map.lanes:
            if lane.road_id != road_id or lane.lane_id != lane_id \
                    or lane.node_s is None:
                continue
            flagged = (lane.nodes[:, 2] > 0.5) & (lane.node_s >= s)
            if flagged.any():
                return float(np.min(lane.node_s[flagged]) - s)
    best = None
    for lane in rough_map.lanes:
        flagged = lane.nodes[:, 2] > 0.5
        if not flagged.any():
            continue
        d = float(np.min(np.linalg.norm(
            lane.nodes[flagged, :2] - np.asarray(xy, np.float64), axis=1)))
        best = d if best is None else min(best, d)
    return best


def _inside_intersection(rough_map, xy: np.ndarray, margin: float = 2.0
                         ) -> bool:
    """Point is within a lane's half width (+margin) of an
    intersection-flagged node — the fake-world analog of
    ``waypoint.is_junction``."""
    xy = np.asarray(xy, np.float64)
    for lane in rough_map.lanes:
        flagged = lane.nodes[:, 2] > 0.5
        if not flagged.any():
            continue
        hw = (np.full(len(lane.nodes), 1.75) if lane.widths is None
              else np.asarray(lane.widths, np.float64) / 2.0)
        d = np.linalg.norm(lane.nodes[flagged, :2] - xy, axis=1)
        if bool(np.any(d <= hw[flagged] + margin)):
            return True
    return False


class InTriggerDistanceToNextIntersection(Atom):
    """SUCCESS when the actor is within ``distance`` (arclength along its
    lane) of the next junction (atomic_trigger_conditions.py
    InTriggerDistanceToNextIntersection:568 measures along the waypoint
    chain to the junction waypoint; the rmap arclength column is that
    chain). RUNNING without a wired map or when the map has no junctions."""

    def __init__(self, name: str, distance: float):
        self.name, self.distance = name, distance

    def tick(self, ctx, dt):
        rm = ctx.rough_map
        pos = ctx.position_of(self.name)
        if rm is None or pos is None:
            return RUNNING
        d = _distance_to_next_intersection(rm, pos)
        return SUCCESS if d is not None and d < self.distance else RUNNING


class WaitEndIntersection(Atom):
    """RUNNING until the actor has ENTERED a junction and then LEFT it
    (atomic_trigger_conditions.py WaitEndIntersection: waits on
    waypoint.is_junction turning true then false)."""

    def __init__(self, name: str):
        self.name = name
        self._entered = False

    def reset(self):
        self._entered = False

    def tick(self, ctx, dt):
        rm = ctx.rough_map
        pos = ctx.position_of(self.name)
        if rm is None or pos is None:
            return RUNNING
        inside = _inside_intersection(rm, pos)
        if inside:
            self._entered = True
            return RUNNING
        return SUCCESS if self._entered else RUNNING


class AtRightmostLane(Atom):
    """SUCCESS when the actor's nearest lane is the rightmost drivable lane
    of its road (atomic_trigger_conditions.py AtRightmostLane:
    get_right_lane() is None / not driving). OpenDRIVE id convention: in
    the direction of travel, "further right" is one MORE step away from the
    centerline on the actor's side (rmap carries driving lanes only), so
    rightmost = no same-road lane with |id| + 1 on the same sign."""

    def __init__(self, name: str):
        self.name = name

    def tick(self, ctx, dt):
        from mmfn_tpu_torch.mapping.rough_map import locate_on_lane

        rm = ctx.rough_map
        pos = ctx.position_of(self.name)
        if rm is None or pos is None:
            return RUNNING
        try:
            road_id, lane_id, _, _ = locate_on_lane(
                rm, float(pos[0]), float(pos[1]))
        except KeyError:
            return RUNNING
        righter = (lane_id + 1) if lane_id > 0 else (lane_id - 1)
        has_righter = any(l.road_id == road_id and l.lane_id == righter
                          for l in rm.lanes)
        return RUNNING if has_righter else SUCCESS


# --------------------------------------------------------------------------- #
# the ScenarioBehavior adapter + atom-composed scenario types
# --------------------------------------------------------------------------- #


class AtomBehavior(ScenarioBehavior):
    """Adapts a composed atom tree onto the ScenarioBehavior protocol
    ScenarioManagerLite drives. Subclasses implement build_tree(ctx); the
    behavior retires (actors cleared, done=True) when the tree finishes."""

    def build_tree(self, ctx: BehaviorContext) -> Atom:
        raise NotImplementedError

    def on_activate(self) -> None:
        self._ctx = BehaviorContext(self.trigger, actor_id_base=self.actor_id,
                                    manager=self.manager)
        self._tree = self.build_tree(self._ctx)

    def steer_noise(self) -> float:
        """Publish AddNoiseToVehicle's perturbation (summed by the manager,
        applied to the ego command in replay.py)."""
        ctx = getattr(self, "_ctx", None)
        return float(ctx.steer_noise) if ctx is not None else 0.0

    def observe(self, ego_xy: np.ndarray) -> None:
        self._pending_ego = np.asarray(ego_xy, dtype=np.float64)

    def step(self, dt: float) -> None:
        if getattr(self, "_pending_ego", None) is not None:
            self._ctx.observe(self._pending_ego, dt)
            self._pending_ego = None
        self._ctx.time += dt
        status = self._tree.tick(self._ctx, dt)
        for a in self._ctx.actors.values():
            a.step(dt)
        self.actors = list(self._ctx.actors.values())
        if status != RUNNING:
            self._ctx.actors.clear()
            self.actors = []
            self.done = True

    def discard_actors(self, keep_fn) -> int:
        """Fault removal must edit the CONTEXT dict — step() rebuilds
        ``self.actors`` from it every tick, so editing only the list would
        resurrect the removed actor next tick."""
        gone = [n for n, a in self._ctx.actors.items() if not keep_fn(a)]
        for n in gone:
            self._ctx.actors.pop(n)
        self.actors = list(self._ctx.actors.values())
        return len(gone)


class OccludedObjectCrossing(AtomBehavior):
    """DynamicObjectCrossing WITH the occluding prop
    (object_crash_vehicle.py:166-230 `_spawn_blocker`: a static vendor
    prop/vehicle stands between the walker and the road, hiding the walker
    until it steps out) — the harder variant of Scenario3; our catalog's
    CrossingWalker is the unoccluded one. Composed purely from atoms:
    spawn blocker + hidden walker -> when the ego closes to 18 m the walker
    crosses at the source's 3.4 m/s -> scenario ends after the ego drives
    40 m clear (the source's _ego_vehicle_distance_driven)."""

    def build_tree(self, ctx):
        return Sequence(
            ActorTransformSetter("blocker", ahead=14.0, lateral=4.2,
                                 kind="vehicle", extent=2.2),
            ActorTransformSetter("walker", ahead=15.5, lateral=6.5,
                                 heading_deg=-90.0, kind="walker",
                                 extent=0.5),
            InTriggerDistanceToVehicle("walker", EGO, distance=18.0),
            Parallel(
                KeepVelocity("walker", speed=3.4, distance=10.0),
                EgoDriveDistance(60.0),          # walker blocked: don't hang
            ),
            ActorDestroy("walker"),
            EgoDriveDistance(40.0),              # blocker persists meanwhile
            ActorDestroy("blocker"),
        )


class CutInFromLeftLane(AtomBehavior):
    """srunner cut_in.py with its REAL behavior tree (the catalog's CutIn is
    the simplified merge-from-ahead): the cut-in vehicle starts BEHIND the
    ego in the left-adjacent lane, accelerates to ego speed + delta
    (AccelerateToCatchUp, delta_velocity=10), swerves into the ego lane over
    ~1.5 s once it sits 10 m ahead, then keeps its speed until the scenario
    ends 50 m later."""

    def build_tree(self, ctx):
        return Sequence(
            ActorTransformSetter("cutin", ahead=-16.0, lateral=3.5,
                                 speed=8.0),
            AccelerateToCatchUp("cutin", EGO, delta_velocity=10.0,
                                trigger_distance=10.0, max_distance=300.0),
            LaneChange("cutin", direction="right", seconds=1.5),
            KeepVelocity("cutin", speed=40.0 / 3.6, distance=50.0),
            ActorDestroy("cutin"),
        )


class SignalizedJunctionLeftTurnTraffic(AtomBehavior):
    """The oncoming-traffic stream of srunner's SignalizedJunctionLeftTurn
    (scenario_runner/srunner/scenarios/signalized_junction_left_turn.py:
    ActorSource feeds opposing vehicles through the junction on a spacing
    interval, ActorSink retires them on the far side, and the scenario ends
    once the ego clears the junction). Composed purely from atoms: the
    source spawns 40 m ahead in the opposing lane heading back at 10 m/s
    with 20 m spacing, the sink drains 30 m behind the trigger, and
    EgoDriveDistance(70) — the only child that can succeed — ends it."""

    def build_tree(self, ctx):
        return Parallel(
            ActorSource("oncoming", ahead=40.0, lateral=-3.5,
                        heading_deg=180.0, speed=10.0, gap=20.0),
            ActorSink(ahead=-30.0, lateral=-3.5, radius=6.0,
                      prefix="oncoming"),
            EgoDriveDistance(70.0),
            policy="one",
        )


class PlatoonFollowLeadingVehicle(AtomBehavior):
    """FollowLeadingVehicleWithObstacle's platoon shape
    (srunner/scenarios/follow_leading_vehicle.py:216-330: the lead vehicle
    follows something slower ahead of IT, so the ego must regulate twice
    removed). Atom-composed: a slow head vehicle cruises via ChangeAutoPilot,
    the lead holds an 8 m gap to it with KeepLongitudinalGap, and the
    scenario ends when the ego closes to a 4 s time-to-collision with the
    lead and then drives clear — exercising the gap and TTC atoms."""

    def build_tree(self, ctx):
        return Sequence(
            ActorTransformSetter("head", ahead=45.0, speed=4.0),
            ActorTransformSetter("lead", ahead=25.0, speed=7.0),
            ChangeAutoPilot("head", target_speed=4.0),
            Parallel(
                KeepLongitudinalGap("lead", reference="head", gap=8.0,
                                    max_speed=12.0),
                InTimeToArrivalToVehicle("lead", EGO, time=4.0),
            ),
            Parallel(
                KeepLongitudinalGap("lead", reference="head", gap=8.0,
                                    max_speed=12.0),
                EgoDriveDistance(60.0),
            ),
            ActorDestroy("lead"),
            ActorDestroy("head"),
        )


class ManeuverOppositeDirection(AtomBehavior):
    """srunner maneuver_opposite_direction.py (Traffic Scenario 06): the ego
    must pass a blocking obstacle in its lane while an oncoming stream flows
    in the opposite lane. The source's tree verbatim: spawn the blocker at
    50 m (_first_vehicle_location) + the first oncoming car at 110 m in the
    left/opposite lane, then Parallel(EgoDriveDistance(220 — the source's
    second_vehicle_location*2), ActorSource(oncoming stream, 40 m gap at
    5.56 m/s = the source's _opposite_speed/_source_gap), ActorSink), then
    destroy. The sink drains behind the trigger (the source sinks at the
    previous junction)."""

    def build_tree(self, ctx):
        return Sequence(
            ActorTransformSetter("blocker", ahead=50.0, lateral=0.0,
                                 kind="vehicle", extent=2.2),
            ActorTransformSetter("oncoming_0", ahead=110.0, lateral=3.5,
                                 heading_deg=180.0, speed=5.56),
            Parallel(
                EgoDriveDistance(220.0),
                ActorSource("oncoming", ahead=110.0, lateral=3.5,
                            heading_deg=180.0, speed=5.56, gap=40.0),
                ActorSink(ahead=-30.0, lateral=3.5, radius=10.0,
                          prefix="oncoming"),
            ),
            ActorDestroy("blocker"),
        )


class OtherLeadingVehicle(AtomBehavior):
    """srunner other_leading_vehicle.py (Traffic Scenario 05,
    VehicleDeceleratingInMultiLaneSetUp): a lead vehicle 35 m ahead cruises
    until the ego closes to 55 m, then decelerates to speed/3.2, forcing the
    ego to change lane past it while a second vehicle occupies the left lane
    (spawned at 36 m, one metre past the lead — the source's
    second_vehicle_location = first + 1). Tree shape is the source's
    verbatim; the 55/45 speed literals are read as km/h (15.3/12.5 m/s):
    srunner hands them to WaypointFollower raw, where CARLA's physics caps
    real vehicles far below 55 m/s — a kinematic world must apply the cap
    the simulator provides implicitly. Ends when the ego drives 140 m
    (_first_vehicle_location * 4)."""

    FIRST_SPEED = 55.0 / 3.6
    SECOND_SPEED = 45.0 / 3.6

    def build_tree(self, ctx):
        return Sequence(
            ActorTransformSetter("lead", ahead=35.0, speed=self.FIRST_SPEED),
            ActorTransformSetter("left", ahead=36.0, lateral=3.5,
                                 speed=self.SECOND_SPEED),
            Parallel(
                EgoDriveDistance(140.0),
                Sequence(
                    Parallel(
                        KeepVelocity("lead", speed=self.FIRST_SPEED),
                        InTriggerDistanceToVehicle("lead", EGO,
                                                   distance=55.0),
                    ),
                    KeepVelocity("lead", speed=self.FIRST_SPEED / 3.2),
                ),
                KeepVelocity("left", speed=self.SECOND_SPEED),
            ),
            ActorDestroy("lead"),
            ActorDestroy("left"),
        )


class SignalizedJunctionRightTurn(AtomBehavior):
    """srunner signalized_junction_right_turn.py (Traffic Scenario 09,
    HeroActorTurningRightAtSignalizedJunction): the ego turns right on a red
    light while a crossing vehicle comes straight from its left on green.
    The source forces the ego's light Red and the other's Green for the
    scenario timeout (80 s) in __init__; here the tree head does it through
    TrafficLightStateSetter (wrapped FailureIsSuccess so unsignalized routes
    still run the kinematic part). Then the source's sequence verbatim:
    SyncArrival to the geometric collision point raced with a 5 m arrival
    condition, straight-through WaypointFollower at 6.9 m/s (_target_vel)
    raced with a 10 m end-of-plan condition, StopVehicle(0.5 =
    _brake_value), EgoDriveDistance(40 = _ego_distance), destroy."""

    def build_tree(self, ctx):
        return Sequence(
            ActorTransformSetter("crossing", ahead=20.0, lateral=20.0,
                                 heading_deg=-90.0),
            FailureIsSuccess(TrafficLightStateSetter("red", duration=80.0)),
            Parallel(
                SyncArrival("crossing", conflict_ahead=20.0,
                            target_speed=6.9),
                InTriggerDistanceToLocation("crossing", ahead=20.0,
                                            distance=5.0),
            ),
            Parallel(
                WaypointFollower("crossing", [(20.0, -15.0), (20.0, -40.0)],
                                 speed=6.9),
                InTriggerDistanceToLocation("crossing", ahead=20.0,
                                            lateral=-40.0, distance=10.0),
            ),
            StopVehicle("crossing", brake_value=0.5),
            EgoDriveDistance(40.0),
            ActorDestroy("crossing"),
        )


# scenario-catalog registration (route_scenario.py NUMBER_CLASS_TRANSLATION
# extras); lives here, not in scenarios.py, because atoms imports scenarios
from mmfn_tpu_torch.harness import scenarios as _scenarios  # noqa: E402

_scenarios.SCENARIO_CLASSES.update({
    "OccludedObjectCrossing": OccludedObjectCrossing,
    "CutInFromLeftLane": CutInFromLeftLane,
    "SignalizedJunctionLeftTurnTraffic": SignalizedJunctionLeftTurnTraffic,
    "PlatoonFollowLeadingVehicle": PlatoonFollowLeadingVehicle,
    "ManeuverOppositeDirection": ManeuverOppositeDirection,
    "OtherLeadingVehicle": OtherLeadingVehicle,
    "SignalizedJunctionRightTurn": SignalizedJunctionRightTurn,
})
