"""Ambient background NPC traffic for the simulator-free closed loop.

The reference surrounds every route with 120-300 autopilot vehicles of
"background activity" (leaderboard route_scenario.py:444-475 spawning
`background_` actors; srunner/scenarios/background_activity.py) driven by the
CARLA traffic manager: they follow lanes, keep headway, and stop at red
lights. The JAX package's CARLA glue reproduces that through the traffic
manager; this module is the fake-world analog, so experts and learned agents
face moving traffic (car-following, hazard braking, collision scoring)
without a simulator.

Vehicles follow the vectorized lane polylines from the native rough_map_node
output (mapping.rough_map.RoughLane.nodes), keep headway to whatever is ahead
(other NPCs, scenario actors, and the ego), stop for red lights from a
harness.traffic.SignalSet, and respawn on a fresh lane when their polyline
ends, keeping the population constant like the traffic manager does.

The port's own copy of the JAX package's ``harness/npc_traffic.py``: spawns
and respawns draw from numpy's ``default_rng(seed)`` in the same order, so
the vehicles' poses are the JAX package's bit for bit.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from mmfn_tpu_torch.harness.scenarios import ScenarioActor

# car-following constants (traffic-manager-like defaults)
CRUISE_SPEED = (4.0, 7.0)     # per-vehicle cruise speed range, m/s
HEADWAY_STOP = 6.0            # bumper-to-bumper stop distance, m
HEADWAY_LOOK = 18.0           # look-ahead distance for the leader search, m
LANE_HALF_WIDTH = 2.8         # lateral window counting an actor as "in lane", m
#   (> combined box half-widths 2.6: a stopped ego cutting into the passing
#   margin on an arc makes the NPC yield instead of grazing it; oncoming
#   traffic one full lane over at 3.5 m still passes freely)
ACCEL = 3.0                   # m/s^2 toward target speed
DECEL = 6.0                   # m/s^2 when braking
MIN_SPAWN_GAP = 12.0          # spacing between spawned vehicles, m
EGO_CLEAR_RADIUS = 20.0       # never spawn this close to the ego start, m


class _Npc:
    __slots__ = ("lane_idx", "s", "speed", "cruise", "actor_id", "alive")

    def __init__(self, lane_idx: int, s: float, cruise: float, actor_id: int):
        self.lane_idx = lane_idx
        self.s = s                    # arc-length progress along the polyline
        self.speed = 0.0
        self.cruise = cruise
        self.actor_id = actor_id
        self.alive = True


class BackgroundTraffic:
    """Kinematic lane-following vehicles (background_activity analog).

    Parameters
    ----------
    lanes : sequence of (N, >=2) arrays — lane polylines in world meters
        (e.g. ``[lane.nodes for lane in rough_map.lanes]``).
    amount : target vehicle count (the reference uses 120-300 per town,
        route_scenario.py:449-460; the fake-world maps are far smaller, so
        callers scale to the map).
    signals : optional harness.traffic.SignalSet — NPCs brake for red lights.
    ego_start : optional (x, y) kept clear at spawn time.
    """

    def __init__(self, lanes: Sequence[np.ndarray], amount: int, seed: int = 0,
                 signals=None, ego_start=None):
        self._rng = np.random.default_rng(seed)
        self.signals = signals
        self._lanes: List[np.ndarray] = []
        self._cum: List[np.ndarray] = []   # cumulative arc length per polyline
        for nodes in lanes:
            pts = np.asarray(nodes, dtype=np.float64)[:, :2]
            if len(pts) < 2:
                continue
            seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
            if seg.sum() < MIN_SPAWN_GAP:    # too short to host a vehicle
                continue
            self._lanes.append(pts)
            self._cum.append(np.concatenate([[0.0], np.cumsum(seg)]))
        self.npcs: List[_Npc] = []
        self._next_id = 5000
        if not self._lanes:
            return
        occupied: List[tuple] = []         # (lane_idx, s) spawn reservations
        ego = None if ego_start is None else np.asarray(ego_start, float)
        attempts = 0
        while len(self.npcs) < amount and attempts < amount * 20:
            attempts += 1
            li = int(self._rng.integers(len(self._lanes)))
            s = float(self._rng.uniform(0.0, self._cum[li][-1]))
            if any(o_li == li and abs(o_s - s) < MIN_SPAWN_GAP
                   for o_li, o_s in occupied):
                continue
            pos, _ = self._locate(li, s)
            if ego is not None and np.linalg.norm(pos - ego) < EGO_CLEAR_RADIUS:
                continue
            occupied.append((li, s))
            cruise = float(self._rng.uniform(*CRUISE_SPEED))
            self.npcs.append(_Npc(li, s, cruise, self._next_id))
            self._next_id += 1

    # ---- geometry ------------------------------------------------------- #

    def _locate(self, lane_idx: int, s: float):
        """(position, yaw) at arc length s along lane lane_idx."""
        pts, cum = self._lanes[lane_idx], self._cum[lane_idx]
        s = min(max(s, 0.0), float(cum[-1]))
        i = int(np.searchsorted(cum, s, side="right") - 1)
        i = min(i, len(pts) - 2)
        seg_len = cum[i + 1] - cum[i]
        t = 0.0 if seg_len <= 0 else (s - cum[i]) / seg_len
        pos = pts[i] * (1 - t) + pts[i + 1] * t
        d = pts[i + 1] - pts[i]
        return pos, math.atan2(d[1], d[0])

    def _respawn(self, npc: _Npc, avoid_xy: Optional[np.ndarray]) -> None:
        for _ in range(10):
            li = int(self._rng.integers(len(self._lanes)))
            s = float(self._rng.uniform(0.0, max(self._cum[li][-1] - 5.0, 0.0)))
            pos, _ = self._locate(li, s)
            if avoid_xy is not None and np.linalg.norm(pos - avoid_xy) < EGO_CLEAR_RADIUS:
                continue
            npc.lane_idx, npc.s, npc.speed = li, s, 0.0
            # a respawn is logically a NEW vehicle: fresh id so a second
            # collision with it is scored independently (reference background
            # actors are distinct CARLA actors)
            npc.actor_id = self._next_id
            self._next_id += 1
            return
        npc.alive = False   # nowhere to respawn; retire

    # ---- per-tick update -------------------------------------------------- #

    def tick(self, ego_xy: np.ndarray, ego_v: float, dt: float,
             game_time: float = 0.0,
             other_actors: Sequence[ScenarioActor] = ()) -> List[ScenarioActor]:
        """Advance every NPC one step; returns their ScenarioActor snapshots.

        Leader search considers the ego, scenario actors, and the other NPCs;
        target speed ramps down linearly inside the headway window (the same
        shape the reference's TM produces: stopped at HEADWAY_STOP, cruise
        outside HEADWAY_LOOK).
        """
        ego_xy = np.asarray(ego_xy, dtype=np.float64)
        snapshots = []
        states = []   # (npc, pos, yaw) before moving, for mutual headway
        for npc in self.npcs:
            if not npc.alive:
                continue
            pos, yaw = self._locate(npc.lane_idx, npc.s)
            states.append((npc, pos, yaw))

        # loop-invariant obstacles (ego + scenario actors) hoisted out
        obstacles = [ego_xy] + [np.asarray(a.position, dtype=np.float64)
                                for a in other_actors]
        positions = [p for _, p, _ in states]
        for npc, pos, yaw in states:
            heading = np.array([math.cos(yaw), math.sin(yaw)])
            lateral = np.array([-heading[1], heading[0]])

            # nearest obstruction ahead in my lane corridor
            gap = float("inf")
            for oxy in obstacles + [p for p in positions if p is not pos]:
                rel = oxy - pos
                fwd = float(rel @ heading)
                if 0.1 < fwd < HEADWAY_LOOK and abs(float(rel @ lateral)) < LANE_HALF_WIDTH:
                    gap = min(gap, fwd)

            target = npc.cruise
            if gap < HEADWAY_LOOK:
                target = npc.cruise * max(0.0, (gap - HEADWAY_STOP)) \
                    / (HEADWAY_LOOK - HEADWAY_STOP)
            if self.signals is not None:
                red, _stop = self.signals.gating(pos, yaw, game_time)
                if red:
                    target = 0.0

            if npc.speed < target:
                npc.speed = min(target, npc.speed + ACCEL * dt)
            else:
                npc.speed = max(target, npc.speed - DECEL * dt)
            npc.s += npc.speed * dt
            if npc.s >= self._cum[npc.lane_idx][-1] - 1e-6:
                self._respawn(npc, ego_xy)
                if not npc.alive:
                    continue
            new_pos, new_yaw = self._locate(npc.lane_idx, npc.s)
            snapshots.append(ScenarioActor(
                "vehicle", new_pos,
                npc.speed * np.array([math.cos(new_yaw), math.sin(new_yaw)]),
                yaw=new_yaw, extent=2.2, actor_id=npc.actor_id))
        return snapshots

    def remove_near(self, xy: np.ndarray, radius: float = 15.0) -> int:
        """Fault removal (force_destory_actor analog, base_agent.py:273-289):
        retire NPCs blocking the given position. Returns how many."""
        xy = np.asarray(xy, dtype=np.float64)
        removed = 0
        for npc in self.npcs:
            if not npc.alive:
                continue
            pos, _ = self._locate(npc.lane_idx, npc.s)
            if np.linalg.norm(pos - xy) <= radius:
                npc.alive = False
                removed += 1
        return removed

    @property
    def population(self) -> int:
        return sum(1 for n in self.npcs if n.alive)
