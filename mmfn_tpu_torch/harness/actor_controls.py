"""User-assignable actor controllers for scripted scenario entities.

The fake-world equivalent of srunner's actorcontrols package
(``scenario_runner/srunner/scenariomanager/actorcontrols/``): OpenSCENARIO's
``AssignControllerAction`` names a controller "module" (a ``Property`` of the
``Controller`` element — ``openscenario_parser.py:get_controller:340-376``),
and the named module then drives the actor every tick through the
``BasicControl`` contract (``actorcontrols/basic_control.py:17-107``:
waypoints + target speed + reached-goal flag).

Our actors are kinematic states, not CARLA physics bodies, so a controller
here is a pure function of the actor's pose: ``run_step`` returns the
``(velocity_xy, yaw)`` to apply for this tick, or ``None`` to leave the
actor to its default scripted motion (the ``external_control`` semantics —
something else, e.g. the ego agent stack, owns the actor).

Registry parity (same module names an .xosc would use against srunner):

- ``external_control``     — no-op (``actorcontrols/external_control.py``)
- ``simple_vehicle_control`` — direct-velocity waypoint follower with
  optional forward-obstacle consideration
  (``actorcontrols/simple_vehicle_control.py:29-281``)
- ``npc_vehicle_control``  — waypoint follower with a comfort acceleration
  limit, standing in for the LocalPlanner+PID stack of
  ``actorcontrols/npc_vehicle_control.py:22-100``
- ``vehicle_longitudinal_control`` — throttle-only bang-bang speed hold,
  heading untouched (``actorcontrols/vehicle_longitudinal_control.py:19-69``)
- ``pedestrian_control``   — walker waypoint follower
  (``actorcontrols/pedestrian_control.py:21-80``)

The port's own copy of the JAX package's ``harness/actor_controls.py``, in
the same float order, so a controller steps its actor bit for bit as there.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Vec2 = np.ndarray


class Obstacle:
    """Pose snapshot of another actor, for forward-obstacle checks."""

    __slots__ = ("position", "velocity", "extent")

    def __init__(self, position: Vec2, velocity: Vec2, extent: float = 2.2):
        self.position = np.asarray(position, dtype=np.float64)
        self.velocity = np.asarray(velocity, dtype=np.float64)
        self.extent = float(extent)          # half-length along heading


class BasicControl:
    """The srunner controller contract (basic_control.py:17-107), kinematic.

    Subclasses implement ``run_step``; the manager calls it once per tick
    with the actor's current pose and the other actors in the world.
    """

    def __init__(self, args: Optional[Dict[str, str]] = None):
        self.args = dict(args or {})
        self.waypoints: List[Vec2] = []
        self.target_speed = 0.0
        self.extent = 2.2          # own half-length, set by the owner
        self.reached_goal = False

    def update_target_speed(self, speed: float) -> None:
        self.target_speed = float(speed)

    def update_waypoints(self, waypoints: Sequence) -> None:
        self.waypoints = [np.asarray(w[:2], dtype=np.float64)
                          for w in waypoints]
        self.reached_goal = False

    def run_step(self, position: Vec2, yaw: float, speed: float, dt: float,
                 obstacles: Sequence[Obstacle] = ()
                 ) -> Optional[Tuple[Vec2, float]]:
        raise NotImplementedError

    # -- shared helpers -- #

    def _pop_reached(self, position: Vec2, reach: float, skip: float) -> None:
        """Drop leading waypoints closer than ``skip`` (too close to steer
        at — simple_vehicle_control.py:201), then mark the goal reached when
        the last waypoint comes within ``reach`` (ibid.:205-209)."""
        while self.waypoints and \
                float(np.linalg.norm(self.waypoints[0] - position)) < skip:
            self.waypoints.pop(0)
        if self.waypoints and \
                float(np.linalg.norm(self.waypoints[0] - position)) < reach:
            self.waypoints.pop(0)
            if not self.waypoints:
                self.reached_goal = True


class ExternalControl(BasicControl):
    """Actor is driven from outside the scenario (the ego stack, a human):
    the controller never touches it (external_control.py run_step is empty)."""

    def run_step(self, position, yaw, speed, dt, obstacles=()):
        return None


class SimpleVehicleControl(BasicControl):
    """Direct-velocity waypoint follower (simple_vehicle_control.py:29-281).

    Moves straight at the next waypoint at the target speed (no physics),
    yaw follows the motion direction. With ``consider_obstacles=true`` the
    speed is adapted to the closest obstacle inside ``proximity_threshold``
    in the forward channel using the same closing-speed braking law as the
    reference (ibid.:232-245): ``a = -(v - v_obs)^2 / (2 d)``.
    """

    REACH = 4.0       # waypoint pop radius (simple_vehicle_control.py:206)
    SKIP = 0.5        # too-close-to-steer drop radius (ibid.:201)
    CHANNEL_HALF_WIDTH = 1.8   # forward channel ~ one vehicle width

    def __init__(self, args=None):
        super().__init__(args)
        truthy = ("true", "1", "yes", "on")
        self.consider_obstacles = \
            str(self.args.get("consider_obstacles", "")).lower() in truthy
        self.proximity_threshold = float(
            self.args.get("proximity_threshold", math.inf))

    def _obstacle_speed_cap(self, position: Vec2, yaw: float, speed: float,
                            dt: float, obstacles: Sequence[Obstacle],
                            target_speed: float) -> float:
        heading = np.array([math.cos(yaw), math.sin(yaw)])
        best: Optional[Tuple[float, float]] = None   # (bumper gap, obs speed)
        for obs in obstacles:
            rel = obs.position - position
            ahead = float(rel @ heading)
            lateral = abs(float(rel[0] * -heading[1] + rel[1] * heading[0]))
            # bumper gap, not center distance: the reference's obstacle
            # sensor is mounted at the front bumper and ranges to the
            # obstacle's surface (simple_vehicle_control.py:100), so its
            # braking law stops with the bodies apart, never overlapping
            gap = ahead - self.extent - obs.extent
            if 0.0 < ahead and gap < self.proximity_threshold \
                    and lateral < self.CHANNEL_HALF_WIDTH \
                    and (best is None or gap < best[0]):
                best = (gap, float(np.linalg.norm(obs.velocity)))
        if best is None:
            return target_speed
        distance, other_speed = best
        if distance <= 1e-6:
            return 0.0
        if other_speed >= speed:
            return target_speed
        # reference braking law (simple_vehicle_control.py:241-242)
        acceleration = -0.5 * (speed - other_speed) ** 2 / distance
        return max(speed + acceleration * dt, 0.0)

    def run_step(self, position, yaw, speed, dt, obstacles=()):
        if self.reached_goal:
            return np.zeros(2), yaw          # reached: stop (ibid.:168-171)
        target_speed = self.target_speed
        if self.consider_obstacles:
            target_speed = self._obstacle_speed_cap(
                position, yaw, speed, dt, obstacles, target_speed)
        self._pop_reached(position, self.REACH, self.SKIP)
        if self.reached_goal or target_speed <= 0.0:
            return np.zeros(2), yaw
        if self.waypoints:
            direction = self.waypoints[0] - position
            norm = float(np.linalg.norm(direction))
            if norm < 1e-6:
                return np.zeros(2), yaw
            new_yaw = math.atan2(direction[1], direction[0])
            return direction / norm * target_speed, new_yaw
        # no waypoints: continue along the current heading (ibid.:157-158)
        heading = np.array([math.cos(yaw), math.sin(yaw)])
        return heading * target_speed, yaw


class NpcVehicleControl(SimpleVehicleControl):
    """Waypoint follower with a comfort acceleration limit — the kinematic
    stand-in for npc_vehicle_control.py's LocalPlanner + PID
    (K_P=1.0, dt=0.05 — npc_vehicle_control.py:33): instead of replaying the
    PID transient we rate-limit speed changes, which is what the PID
    converges to on straight segments."""

    ACCEL = 3.0       # m/s^2, comfort envelope of the tuned PID

    def run_step(self, position, yaw, speed, dt, obstacles=()):
        out = super().run_step(position, yaw, speed, dt, obstacles)
        if out is None:
            return None
        velocity, new_yaw = out
        desired = float(np.linalg.norm(velocity))
        step = self.ACCEL * max(dt, 1e-6)
        attained = float(np.clip(desired, speed - step, speed + step))
        if desired > 1e-6:
            velocity = velocity / desired * attained
        return velocity, new_yaw


class VehicleLongitudinalControl(BasicControl):
    """Throttle-only speed hold: below target accelerate, above coast —
    the bang-bang loop of vehicle_longitudinal_control.py:40-69. Steering is
    never touched, so the heading stays whatever the story last set."""

    THROTTLE_ACCEL = 3.0   # full-throttle surge of a leaderboard sedan
    DRAG_DECEL = 1.0       # engine-drag coast-down at throttle 0

    def run_step(self, position, yaw, speed, dt, obstacles=()):
        if speed < self.target_speed:
            new_speed = min(speed + self.THROTTLE_ACCEL * dt,
                            self.target_speed)
        else:
            new_speed = max(speed - self.DRAG_DECEL * dt, self.target_speed)
        heading = np.array([math.cos(yaw), math.sin(yaw)])
        return heading * new_speed, yaw


class PedestrianControl(BasicControl):
    """Walker waypoint follower (pedestrian_control.py:40-80): walk straight
    at the next waypoint at the target speed, pop within 1 m, stop at goal."""

    REACH = 1.0       # pedestrian_control.py:66

    def run_step(self, position, yaw, speed, dt, obstacles=()):
        if self.reached_goal:
            # the reference walker would keep strolling on its heading
            # (pedestrian_control.py:69-71 falls through to free walk) but
            # its scenarios stop it externally at goal; kinematically we
            # stop in place, like SimpleVehicleControl does at its goal
            return np.zeros(2), yaw
        if self.waypoints:
            direction = self.waypoints[0] - position
            norm = float(np.linalg.norm(direction))
            if norm < self.REACH:
                self.waypoints.pop(0)
                if not self.waypoints:
                    self.reached_goal = True
                    return np.zeros(2), yaw
                direction = self.waypoints[0] - position
                norm = float(np.linalg.norm(direction))
            if norm < 1e-6:
                return np.zeros(2), yaw
            new_yaw = math.atan2(direction[1], direction[0])
            return direction / norm * self.target_speed, new_yaw
        heading = np.array([math.cos(yaw), math.sin(yaw)])
        return heading * self.target_speed, yaw


CONTROL_REGISTRY = {
    "external_control": ExternalControl,
    "simple_vehicle_control": SimpleVehicleControl,
    "npc_vehicle_control": NpcVehicleControl,
    "vehicle_longitudinal_control": VehicleLongitudinalControl,
    "pedestrian_control": PedestrianControl,
}


def make_controller(module: str,
                    args: Optional[Dict[str, str]] = None) -> BasicControl:
    """Instantiate a controller by its srunner module name.

    Mirrors ``ChangeActorControl``'s module-path loading
    (``scenariomanager/scenarioatomics/atomic_behaviors.py``): unknown names
    raise, matching the reference's import failure."""
    try:
        cls = CONTROL_REGISTRY[module]
    except KeyError:
        raise ValueError(
            f"unknown controller module {module!r} "
            f"(known: {sorted(CONTROL_REGISTRY)})") from None
    return cls(args)
