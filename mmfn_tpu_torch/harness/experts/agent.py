"""Closed-loop data-collection expert agent.

The harness-facing wrapper around ExpertPilot — the rebuild of the reference's
MMFNPilot agent (team_code/expert_agent/mmfn_pilot.py + common/base_agent.py):
consumes the privileged channel for ground truth, follows the route with the
rule stack, perturbs steering with 1e-2 gaussian dither (mmfn_pilot.py:90),
and saves a dataset frame every 10 ticks (2 Hz at the 20 Hz sim rate) in the
exact directory tree CarlaDataset reads.

Frame conventions: measurements store theta = ego yaw and x/y_command = the
far planner target in the position frame — self-consistent with both the
dataset's target-point math (dataloader.py:250-261) and the e2e agents' tick
rotation. (The reference stores a CARLA-GPS-frame-swapped command
(x_command = -far_y, y_command = far_x, base_agent.py:224-271) — an artifact
of CARLA's gps frame that does not apply to this harness.)

The port's own copy of the JAX package's ``harness/experts/agent.py``, tick
for tick: the steer dither draws from numpy's ``default_rng(seed)``, one
``standard_normal()`` a tick, as the JAX expert does, so controls and
written frames are the JAX package's bit for bit. Frames are written by the
port's ``DatasetWriter`` (PNG through ``data/png.py``).
"""

from __future__ import annotations

import math
import os
import tempfile
from typing import Optional

import numpy as np

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.control.planner import RoutePlanner
from mmfn_tpu_torch.data.writer import DatasetWriter
from mmfn_tpu_torch.harness.agents.base import AutonomousAgent, Track, VehicleControl
from mmfn_tpu_torch.harness.experts.pilot import ExpertPilot, SimplePilot, angle_to_target
from mmfn_tpu_torch.harness.experts.world_view import Actor, EgoState, WorldView
# weather presets cycled during collection (base_agent.py:291-295);
# in CARLA these map to WeatherParameters, here they are recorded ids
from mmfn_tpu_torch.harness.weather import WEATHER_PRESETS as WEATHERS
from mmfn_tpu_torch.mapping import RoughMap, build_rmap
from mmfn_tpu_torch.mapping.birdview import BirdViewProducer


class ExpertCollectionAgent(AutonomousAgent):
    """Config keys: 'save_path' (enables dataset writing), 'rmap_tool',
    'tmp_dir', 'config' (GlobalConfig), 'seed'."""

    NEARBY_DIS = 30.0
    FRONT_CONE_DEG = 30.0

    def setup(self, conf) -> None:
        conf = conf or {}
        self.track = Track.MAP
        self.config: GlobalConfig = conf.get("config") or GlobalConfig()
        # 'mmfn' -> ExpertPilot (MMFNPilot rules); 'auto' -> SimplePilot
        # (the reference's LBC-style AutoPilot, auto_pilot.py:56)
        self.pilot = (SimplePilot() if conf.get("pilot") == "auto"
                      else ExpertPilot())
        # MMFNPPilot analog (mmfn_ppilot.py:142-145): a stop counter requests
        # fault removal (delete blockers / force lights green) from the world.
        # Defaults match the reference's SHIPPED expert config
        # (run_steps/config/agent_config/expert.yaml:1-2:
        # force_destory_actor: True, counter_destory: 200 = 10 s @ 20 Hz) —
        # without it the expert waits behind a stopped blocker forever and
        # times the route out.
        self.force_unblock = bool(conf.get("force_unblock", True))
        self.unblock_ticks = int(conf.get("unblock_ticks", 200))
        self._stop_counter = 0
        self._unblock_requested = False
        self.rough_map = RoughMap(self.config.up, self.config.down, self.config.left,
                                  self.config.right, self.config.lane_node_num,
                                  self.config.feature_num)
        self.rough_map_loaded = False
        self._tmp_dir = conf.get("tmp_dir") or tempfile.mkdtemp(prefix="mmfn_torch_expert_")
        self._rmap_tool = conf.get("rmap_tool")
        self._rng = np.random.default_rng(conf.get("seed", 0))
        self.writer: Optional[DatasetWriter] = None
        if conf.get("save_path"):
            self.writer = DatasetWriter(conf["save_path"],
                                        image_ext=conf.get("image_ext", "npy"))
        self.birdview: Optional[BirdViewProducer] = None
        self._lane_xy = np.zeros((0, 2))
        self._lane_idx = np.zeros((0,), np.int64)
        self.step = -1
        self.initialized = False

    def sensors(self):
        from mmfn_tpu_torch.harness.agents.e2e import MMFNAgent

        return MMFNAgent.sensors(self)

    # ---- helpers -------------------------------------------------------------- #

    def _init_route(self) -> None:
        # near planner steers on the DENSE plan (MMFNPilot's _waypoint_planner
        # over _plan_gps_HACK, mmfn_pilot.py:74-76 / map_agent.py:25-26); the
        # command planner hands out targets from the ~50 m downsampled plan
        self._waypoint_planner = RoutePlanner(4.0, 50.0)
        self._waypoint_planner.set_route(self._global_plan_dense, gps=True)
        self._command_planner = RoutePlanner(7.5, 25.0)
        self._command_planner.set_route(self._global_plan, gps=True)
        self.initialized = True

    def _save_map(self, opendrive_str: str) -> None:
        map_dir = os.path.join(self._tmp_dir, "opendrive")
        os.makedirs(map_dir, exist_ok=True)
        with open(os.path.join(map_dir, "opstr.txt"), "w") as f:
            f.write(opendrive_str)
        if build_rmap([map_dir], tool_path=self._rmap_tool):
            raise RuntimeError("rough_map_node failed")
        rmap_path = os.path.join(map_dir, "a.rmap")
        self.rough_map.read(rmap_path)
        self.birdview = BirdViewProducer.from_opendrive(
            rmap_path, target_size=self.config.input_resolution)
        self._build_lane_lookup()
        self.rough_map_loaded = True
        if self.writer is not None:
            od_dir = os.path.join(self.writer.route_dir, "opendrive")
            os.makedirs(od_dir, exist_ok=True)
            with open(os.path.join(od_dir, "opstr.txt"), "w") as f:
                f.write(opendrive_str)

    # ---- lane identity (for the change-lane hazard) ----------------------- #

    LANE_CORRIDOR = 2.0     # half lane width-ish: "on this polyline", meters

    def _build_lane_lookup(self) -> None:
        """Densify chunk polylines to ~1 m for nearest-lane queries (the
        reference reads lane ids off the CARLA map, mmfn_pilot.py
        _is_change_lane). Lane identity = CONNECTED-chunk group: the
        vectorizer tiles each physical lane into ~45 m chunks that share
        boundary nodes, so chunks are union-found by endpoint coincidence —
        otherwise every chunk seam would read as a fake 'lane change'."""
        lanes = self.rough_map.lanes
        group = list(range(len(lanes)))

        def find(i):
            while group[i] != i:
                group[i] = group[group[i]]
                i = group[i]
            return i

        ends = [(np.asarray(l.nodes[0, :2], dtype=np.float64),
                 np.asarray(l.nodes[-1, :2], dtype=np.float64)) for l in lanes]
        for i in range(len(lanes)):
            for j in range(len(lanes)):
                if i != j and np.linalg.norm(ends[i][1] - ends[j][0]) < 0.3:
                    gi, gj = find(i), find(j)
                    if gi != gj:
                        group[gj] = gi
        xs, idxs = [], []
        for i, lane in enumerate(lanes):
            pts = np.asarray(lane.nodes[:, :2], dtype=np.float64)
            gid = find(i)
            if len(pts) < 2:
                xs.append(pts)
                idxs.append(np.full(len(pts), gid))
                continue
            dense = [pts[:1]]
            for a, b in zip(pts[:-1], pts[1:]):
                n = max(1, int(np.linalg.norm(b - a)))
                t = np.linspace(0.0, 1.0, n + 1)[1:, None]
                dense.append(a * (1 - t) + b * t)
            dense = np.concatenate(dense, axis=0)
            xs.append(dense)
            idxs.append(np.full(len(dense), gid))
        self._lane_xy = (np.concatenate(xs, axis=0)
                         if xs else np.zeros((0, 2)))
        self._lane_idx = (np.concatenate(idxs, axis=0).astype(np.int64)
                          if idxs else np.zeros((0,), np.int64))
        # coarse bucket index for O(1) corridor queries (the CARLA path has
        # ~1e5 densified points; 3 full-array scans per 20 Hz tick would cost
        # host milliseconds)
        self._bucket_size = 8.0
        cells = np.floor(self._lane_xy / self._bucket_size).astype(np.int64)
        self._buckets = {}
        for n, cell in enumerate(map(tuple, cells)):
            self._buckets.setdefault(cell, []).append(n)

    def _chunks_near(self, xy, radius: Optional[float] = None) -> set:
        """Lane-group ids whose polyline passes within `radius` of xy
        (bucket-indexed: only the 3x3 cell neighborhood is scanned)."""
        if self._lane_xy.shape[0] == 0:
            return set()
        xy = np.asarray(xy, dtype=np.float64)
        r = self.LANE_CORRIDOR if radius is None else radius
        cx, cy = np.floor(xy / self._bucket_size).astype(np.int64)
        cand = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                cand.extend(self._buckets.get((cx + dx, cy + dy), ()))
        if not cand:
            return set()
        idx = np.asarray(cand)
        d = np.linalg.norm(self._lane_xy[idx] - xy, axis=1)
        return set(self._lane_idx[idx[d < r]].tolist())

    def _annotate_lane_change(self, view: WorldView, near_node, far_node) -> None:
        """Mark a route-required lane change and per-actor lane occupancy so
        the pilot's _change_lane_hazard can gate the merge."""
        ego_chunks = self._chunks_near(view.ego.position)
        if not ego_chunks:
            return
        target_chunks = (self._chunks_near(near_node)
                         | self._chunks_near(far_node))
        off_lane = target_chunks - ego_chunks
        if not off_lane or (target_chunks & ego_chunks):
            return   # targets still covered by the current lane's chunks
        view.lane_change_required = True
        view.change_lane_ids = sorted(off_lane)
        view.ego.lane_id = min(ego_chunks)
        for v in list(view.vehicles) + list(view.cars_behind):
            chunks = self._chunks_near(v.position)
            if chunks & off_lane:
                v.lane_id = min(chunks & off_lane)
            elif chunks & ego_chunks:
                v.lane_id = view.ego.lane_id
            elif chunks:
                v.lane_id = min(chunks)
            else:
                v.lane_id = -1

    def _detect_front_car(self, view: WorldView) -> Optional[Actor]:
        front, front_dist = None, float("inf")
        for actor in view.vehicles:
            dist = float(np.linalg.norm(actor.position - view.ego.position))
            if (dist < front_dist and dist <= self.NEARBY_DIS
                    and abs(angle_to_target(view.ego.position, view.ego.yaw,
                                            actor.position)) < self.FRONT_CONE_DEG):
                front, front_dist = actor, dist
        return front

    def _world_view(self, priv) -> WorldView:
        if isinstance(priv, WorldView):
            # a prebuilt snapshot on the privileged channel (the JAX
            # package's CARLA glue delivers one)
            view = priv
        else:
            x, y, yaw, v = priv["ego"]
            ego = EgoState(position=np.array([x, y]),
                           velocity=np.array([v * math.cos(yaw), v * math.sin(yaw)]),
                           yaw=yaw)
            vehicles, walkers = [], []
            for a in priv.get("actors", []):
                actor = Actor(position=np.asarray(a.position, dtype=np.float64),
                              velocity=np.asarray(a.velocity, dtype=np.float64),
                              yaw=a.yaw, extent=a.extent, actor_id=a.actor_id)
                if np.linalg.norm(actor.position - ego.position) > self.NEARBY_DIS:
                    continue
                (walkers if a.kind == "walker" else vehicles).append(actor)
            view = WorldView(ego=ego, vehicles=vehicles, walkers=walkers,
                             red_light=bool(priv.get("red_light", False)),
                             stop_sign=bool(priv.get("stop_sign", False)))
        if view.car_in_front is None:
            view.car_in_front = self._detect_front_car(view)
        return view

    # ---- main step ------------------------------------------------------------ #

    def run_step(self, input_data: dict, timestamp: float) -> VehicleControl:
        if not self.rough_map_loaded and "opendrive" not in input_data:
            return VehicleControl(brake=1.0)
        if not self.initialized:
            self._save_map(input_data["opendrive"][1]["opendrive"])
            self._init_route()
        self.step += 1

        priv = input_data["privileged"][1]
        self._light_states = (priv.get("light_states", [])
                              if isinstance(priv, dict) else [])
        world = self._world_view(priv)
        pos = world.ego.position

        near_node, near_cmd = self._waypoint_planner.run_step(pos)
        far_node, far_cmd = self._command_planner.run_step(pos)

        if self.rough_map_loaded:
            self._annotate_lane_change(world, near_node, far_node)
        decision = self.pilot.get_control(world, near_node, far_node)
        if self.force_unblock:
            self._stop_counter = (self._stop_counter + 1
                                  if world.ego.speed < 0.1 else 0)
            if self._stop_counter > self.unblock_ticks:
                self._unblock_requested = True
                self._stop_counter = 0
        steer = float(np.clip(decision.steer + 1e-2 * self._rng.standard_normal(),
                              -1.0, 1.0))
        control = VehicleControl(steer=steer, throttle=decision.throttle,
                                 brake=float(decision.brake),
                                 reverse=decision.reverse)

        if self.writer is not None and self.writer.should_save(self.step):
            self._save_frame(input_data, world, near_node, far_node, far_cmd,
                             decision, control)
        return control

    def _save_frame(self, input_data, world: WorldView, near_node, far_node,
                    far_cmd, decision, control) -> None:
        cfg = self.config
        x, y = world.ego.position
        yaw = world.ego.yaw
        rgb = input_data["rgb"][1][:, :, :3][:, :, ::-1]
        radar_front = np.hstack([input_data["radar_front"][1],
                                 np.ones((input_data["radar_front"][1].shape[0], 1))])
        radar_rear = np.hstack([input_data["radar_rear"][1],
                                np.zeros((input_data["radar_rear"][1].shape[0], 1))])
        vectormap = self.rough_map.process([x, y, yaw])
        if vectormap.shape[0] == 0:
            vectormap = np.zeros((1, cfg.lane_node_num, cfg.feature_num))
        actors = [(float(a.position[0]), float(a.position[1]), a.yaw, 4.5, 2.0)
                  for a in world.vehicles]
        walkers = [(float(a.position[0]), float(a.position[1]), a.yaw, 1.0, 1.0)
                   for a in world.walkers]
        raster = BirdViewProducer.as_rgb(
            self.birdview.produce([x, y, yaw], actors=actors,
                                  lights=self._light_states, walkers=walkers))
        self.writer.save_frame(
            rgb_front=np.ascontiguousarray(rgb),
            lidar=input_data["lidar"][1],
            radar=np.concatenate([radar_front, radar_rear], axis=0),
            vectormap=vectormap,
            map_raster=raster,
            x=float(x), y=float(y), theta=float(yaw),
            speed=world.ego.speed, target_speed=decision.target_speed,
            x_command=float(far_node[0]), y_command=float(far_node[1]),
            command=int(getattr(far_cmd, "value", far_cmd)),
            steer=control.steer, throttle=control.throttle, brake=control.brake,
            reverse=control.reverse,
            weather=self.step // 200 % len(WEATHERS))

    def consume_unblock_request(self) -> bool:
        """True once per triggered stop-counter threshold; the closed-loop
        runner answers by deleting blockers / forcing lights green."""
        req, self._unblock_requested = self._unblock_requested, False
        return req
