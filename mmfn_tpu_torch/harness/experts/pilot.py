"""Rule-based expert pilot: PID steering + hazard-gated speed policy.

Simulator-independent core of the reference's MMFNPilot
(team_code/expert_agent/mmfn_pilot.py:36-192):

- steering: PID (1.25/0.75/0.3, n=40) on the angle to the near planner target,
  normalized by 90 deg; +-1 clip; halved while braking; the data-collection
  agent adds 1e-2 gaussian dither (mmfn_pilot.py:90);
- speed: 7 m/s cruise, 4 m/s when turning (|far angle| > 45 or |near| > 5),
  0 when any hazard gates; PID (5.0/0.5/1.0, n=40) with delta clipped to 0.8
  and throttle capped at 0.8;
- hazards (_should_brake, mmfn_pilot.py:259-553): vehicle TTC (projection with
  lateral gate + disc quadratic), walker TTC, red light, stop sign (released
  after a full stop);
- car-following override (mmfn_pilot.py:154-174): match the front car's speed
  when it is far enough (max(8 m, 1.5 x ego speed)) and actually moving.

The port's own copy of the JAX package's ``harness/experts/pilot.py``, on
the port's ``control/pid.py`` and ``control/geometry.py``; the same rules in
the same order, so its decisions equal the JAX package's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from mmfn_tpu_torch.control.geometry import predicted_min_distance, ttc_disc, ttc_projection
from mmfn_tpu_torch.control.pid import PIDController
from mmfn_tpu_torch.harness.experts.world_view import WorldView


def angle_to_target(pos: np.ndarray, yaw_rad: float, target: np.ndarray) -> float:
    """Signed angle (degrees, [-180, 180)) from the ego heading to the target."""
    rel = np.asarray(target, dtype=np.float64) - np.asarray(pos, dtype=np.float64)
    angle = math.degrees(math.atan2(rel[1], rel[0]) - yaw_rad)
    return (angle + 180.0) % 360.0 - 180.0


@dataclass
class ExpertDecision:
    steer: float
    throttle: float
    brake: bool
    target_speed: float
    hazard: Optional[str]
    reverse: bool = False


class ExpertPilot:
    CRUISE_SPEED = 7.0
    TURN_SPEED = 4.0
    MAX_THROTTLE = 0.8
    SPEED_DELTA = 0.8
    STOP_THRESHOLD = 8.0         # minimum following distance, meters
    CLOSE_OBS_SPEED = 1.0        # "moving" threshold for the front car
    VEHICLE_TTC = 2.5            # brake when a vehicle's TTC drops below
    WALKER_TTC = 3.5
    VEHICLE_LATERAL_GATE = 2.5   # meters; projection-TTC lateral miss gate
    VEHICLE_CROSS_SAFE = 6.0     # crossing traffic: predicted-approach disc,
    #                              center-to-center — the boxes themselves
    #                              consume up to ego half-length + crosser
    #                              half-length = 2.45 + 2.2 m of it
    VEHICLE_CROSS_HORIZON = 4.0  # seconds of closest-approach prediction
    WALKER_HORIZON = 4.0         # closest-approach prediction window, seconds
    WALKER_SAFE_DIST = 3.5       # brake when predicted approach is closer
    RED_ANGLE_DIFF = 20.0        # deg; misalignment triggering straightening
    STRAIGHTEN_SPEED = 0.4       # m/s creep while correcting the pose
    CHANGE_LANE_DIST = 8.0       # base merge-blocking window, meters
    CONSIDER_ANGLE = 120.0       # deg; heading-alignment cone for merges
    CHANGE_LANE_PATIENCE = 20    # decisions before giving up on the merge wait
    HAZARD_ORDER = ("vehicle", "walker", "change_lane", "red_light", "stop_sign")

    def __init__(self):
        self._turn_controller = PIDController(1.25, 0.75, 0.3, n=40)
        self._speed_controller = PIDController(5.0, 0.5, 1.0, n=40)
        self._stop_completed = False
        self._stop_for_change_lane = 0
        self._over_time = False

    # ---- hazards -------------------------------------------------------------- #

    def _vehicle_hazard(self, world: WorldView) -> Optional[str]:
        ego = world.ego
        for v in world.vehicles:
            ttc_a = ttc_projection(ego.position, v.position, ego.velocity,
                                   v.velocity, close_dis=self.VEHICLE_LATERAL_GATE)
            ttc_b = ttc_disc(ego.position, v.position, ego.velocity, v.velocity)
            if min(ttc_a, ttc_b) < self.VEHICLE_TTC:
                return f"vehicle:{v.actor_id}"
            # proximity gate: hold distance behind a slow/stopped vehicle in
            # MY lane corridor (TTC alone lets the ego creep into the bumper
            # as both speed and TTC decay together; reference STOP_THRESHOLD).
            # Corridor = ahead within STOP_THRESHOLD and laterally inside the
            # lane — an angle cone would latch onto stopped traffic one lane
            # over on curves and deadlock both parties.
            rel = v.position - ego.position
            fwd = float(rel @ np.array([math.cos(ego.yaw), math.sin(ego.yaw)]))
            lat = float(rel @ np.array([-math.sin(ego.yaw), math.cos(ego.yaw)]))
            # ANY leader slower than me inside the corridor closes the gap
            # (a 1.5 m/s crawler tailgated at matched TTC still ends in the
            # bumper — the stationary-only gate was too narrow)
            if (0.0 < fwd < self.STOP_THRESHOLD
                    and abs(lat) < self.VEHICLE_LATERAL_GATE
                    and np.linalg.norm(v.velocity) < max(
                        self.CLOSE_OBS_SPEED,
                        float(np.linalg.norm(ego.velocity)))):
                return f"vehicle:{v.actor_id}"
            # crossing traffic: the reference lifts the angle restriction
            # inside junctions so transverse movers near the ego gate it
            # (mmfn_pilot.py:473-481, rule 3). The map-free kinematic analog
            # gates on the mover's course being strongly transverse to mine
            # (45-135 deg — oncoming and same-lane traffic stay excluded,
            # so this can't deadlock two-way roads) with the walkers'
            # predicted-closest-approach test.
            sv = float(np.linalg.norm(v.velocity))
            if sv > self.CLOSE_OBS_SPEED:
                ego_dir = np.array([math.cos(ego.yaw), math.sin(ego.yaw)])
                if abs(float((v.velocity / sv) @ ego_dir)) < 0.7071:
                    if predicted_min_distance(
                            ego.position, v.position, ego.velocity,
                            v.velocity, self.VEHICLE_CROSS_HORIZON) \
                            < self.VEHICLE_CROSS_SAFE:
                        return f"vehicle:{v.actor_id}"
        return None

    def _walker_hazard(self, world: WorldView) -> Optional[str]:
        ego = world.ego
        for w in world.walkers:
            if ttc_disc(ego.position, w.position, ego.velocity, w.velocity,
                        ra=1.5, rb=1.0) < self.WALKER_TTC:
                return f"walker:{w.actor_id}"
            # crossing pedestrians: gate on the predicted closest approach,
            # which stays below threshold through the whole crossing
            if predicted_min_distance(ego.position, w.position, ego.velocity,
                                      w.velocity, self.WALKER_HORIZON) \
                    < self.WALKER_SAFE_DIST:
                return f"walker:{w.actor_id}"
        return None

    def _change_lane_hazard(self, world: WorldView):
        """A vehicle occupying the target lane of a route-required lane change
        (mmfn_pilot.py:_is_change_lane): roughly-aligned traffic inside a
        speed-scaled window blocks the merge; parked cars outside junctions
        are ignored. Returns the blocking Actor or None."""
        if not world.lane_change_required or not world.change_lane_ids:
            return None
        ego = world.ego
        for v in list(world.vehicles) + list(world.cars_behind):
            if v.lane_id == ego.lane_id or v.lane_id not in world.change_lane_ids:
                continue
            speed_v = float(np.linalg.norm(v.velocity))
            if speed_v < 0.1 and not world.ego.in_junction:
                continue      # parked car, not merging traffic
            dist = float(np.linalg.norm(v.position - ego.position))
            threshold = float(np.clip(
                max(self.CHANGE_LANE_DIST, 2.0 * ego.speed, 2.0 * speed_v),
                0.0, self.STOP_THRESHOLD * 1.5))
            heading_diff = abs((math.degrees(v.yaw - ego.yaw) + 180.0)
                               % 360.0 - 180.0)
            if dist < threshold and heading_diff < self.CONSIDER_ANGLE * 0.65:
                return v
        return None

    def _stop_sign_hazard(self, world: WorldView) -> Optional[str]:
        if not world.stop_sign:
            self._stop_completed = False
            return None
        if world.ego.speed < 0.05:
            self._stop_completed = True
        return None if self._stop_completed else "stop_sign"

    def _hazards(self, world: WorldView) -> dict:
        change = self._change_lane_hazard(world)
        return {
            "vehicle": self._vehicle_hazard(world),
            "walker": self._walker_hazard(world),
            "change_lane": f"change_lane:{change.actor_id}" if change else None,
            "red_light": "red_light" if world.red_light else None,
            "stop_sign": self._stop_sign_hazard(world),
            "_change_actor": change,
        }

    def should_brake(self, world: WorldView) -> Optional[str]:
        """First active hazard by priority. NOTE: raw rule output — the
        merge-wait patience that can override a change_lane hazard lives in
        get_control (it is tick-stateful)."""
        h = self._hazards(world)
        return next((h[k] for k in self.HAZARD_ORDER if h[k]), None)

    # ---- control -------------------------------------------------------------- #

    def get_control(self, world: WorldView, near_target: np.ndarray,
                    far_target: np.ndarray) -> ExpertDecision:
        ego = world.ego
        pos, speed = ego.position, ego.speed

        angle_unnorm = angle_to_target(pos, ego.yaw, near_target)
        steer = float(np.clip(self._turn_controller.step(angle_unnorm / 90.0), -1.0, 1.0))
        steer = round(steer, 3)

        angle_far_unnorm = angle_to_target(pos, ego.yaw, far_target)
        should_slow = abs(angle_far_unnorm) > 45.0 or abs(angle_unnorm) > 5.0
        h = self._hazards(world)
        hazard = next((h[k] for k in self.HAZARD_ORDER if h[k]), None)
        brake = hazard is not None
        target_speed = self.TURN_SPEED if should_slow else self.CRUISE_SPEED
        target_speed = 0.0 if brake else target_speed

        # merge-wait patience (mmfn_pilot.py:127-140): when only a stopped
        # vehicle in the target lane is holding us, count; past the patience
        # threshold ignore the change-lane hazard until it clears
        change_actor = h["_change_actor"]
        if (h["change_lane"] and not h["red_light"] and not h["stop_sign"]
                and float(np.linalg.norm(change_actor.velocity)) < 1.0):
            self._stop_for_change_lane += 1
        elif not self._over_time:
            self._stop_for_change_lane = 0
        if self._stop_for_change_lane > self.CHANGE_LANE_PATIENCE:
            self._over_time = True
            others = [h[k] for k in ("vehicle", "walker", "red_light", "stop_sign")]
            brake = any(x is not None for x in others)
            if brake:
                hazard = next(x for x in others if x)
            else:
                hazard = None
                target_speed = self.TURN_SPEED if should_slow else self.CRUISE_SPEED
            if h["change_lane"] is None:
                self._stop_for_change_lane = 0
                self._over_time = False

        # red-light pose straightening (mmfn_pilot.py:142-152, 266-273): gated
        # at a light with the heading badly off the lane, creep at 0.4 m/s —
        # in reverse when nobody is behind — steering back into alignment so
        # the restart after green is clean
        reverse = False
        if (world.red_light and abs(angle_unnorm) > self.RED_ANGLE_DIFF
                and not (hazard or "").startswith("walker")):
            target_speed = self.STRAIGHTEN_SPEED
            reverse = not world.cars_behind
            angle_turn = (-1.0 if reverse else 1.0) * angle_unnorm / 90.0
            steer = float(np.clip(self._turn_controller.step(angle_turn), -1.0, 1.0))
            brake = False

        # car-following: hold the leader's speed instead of hard-braking —
        # but never while the predicted closest approach is unsafe (a decel-
        # erating leader keeps shrinking the gap even at matched speed)
        leader = world.car_in_front
        if (leader is not None
                and not ego.in_junction and not leader.in_junction):
            gap = float(np.linalg.norm(leader.position - pos))
            leader_speed = float(np.linalg.norm(leader.velocity))
            safe_approach = predicted_min_distance(
                pos, leader.position, ego.velocity, leader.velocity, 3.0) > 6.0
            if (hazard is None and safe_approach
                    and gap > max(self.STOP_THRESHOLD, 1.5 * speed)
                    and leader_speed > self.CLOSE_OBS_SPEED * 0.5):
                target_speed = leader_speed
                brake = False

        delta = float(np.clip(target_speed - speed, 0.0, self.SPEED_DELTA))
        throttle = float(np.clip(self._speed_controller.step(delta), 0.0, self.MAX_THROTTLE))

        if brake:
            steer *= 0.5
            throttle = 0.0

        return ExpertDecision(steer=steer, throttle=throttle, brake=brake,
                              target_speed=target_speed, hazard=hazard,
                              reverse=reverse)


class SimplePilot(ExpertPilot):
    """LBC-style AutoPilot (reference team_code/expert_agent/auto_pilot.py:56):
    the same angle-PID steering stack but a lower fixed cruise speed and plain
    distance/cone hazard tests instead of TTC prediction — the cheaper, more
    conservative expert used for quick data collection.
    """

    CRUISE_SPEED = 4.0
    TURN_SPEED = 3.0
    BRAKE_DISTANCE = 9.0         # vehicles inside this forward-cone distance
    WALKER_DISTANCE = 9.0
    FRONT_CONE_DEG = 60.0

    def _vehicle_hazard(self, world: WorldView) -> Optional[str]:
        ego = world.ego
        for v in world.vehicles:
            gap = float(np.linalg.norm(v.position - ego.position))
            if (gap < self.BRAKE_DISTANCE
                    and abs(angle_to_target(ego.position, ego.yaw,
                                            v.position)) < self.FRONT_CONE_DEG):
                return f"vehicle:{v.actor_id}"
        return None

    def _walker_hazard(self, world: WorldView) -> Optional[str]:
        ego = world.ego
        for w in world.walkers:
            if float(np.linalg.norm(w.position - ego.position)) < self.WALKER_DISTANCE:
                return f"walker:{w.actor_id}"
        return None

    def get_control(self, world: WorldView, near_target: np.ndarray,
                    far_target: np.ndarray) -> ExpertDecision:
        # no car-following override: the simple pilot just keeps distance
        leader = world.car_in_front
        world.car_in_front = None
        decision = super().get_control(world, near_target, far_target)
        world.car_in_front = leader
        return decision
