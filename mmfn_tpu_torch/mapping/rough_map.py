"""Vectorized-map (.rmap) reader and per-pose lane cropper.

The reference ships a closed-source C++ binary (assets/package/rough_map_node)
that converts OpenDRIVE XML into a ``.rmap`` text file, parsed by RoughMap
(team_code/expert_agent/common/utils.py:381-447). This module reads/writes the
same format and reimplements the per-pose crop in pure vectorized numpy (the
reference uses shapely polygon tests per lane).

.rmap format (recovered from the reference parser, utils.py:395-415):
    line 1: header (ignored)
    line 2: "lane_num <k>"  (the count is the SECOND token)
    per lane:
        "node_num <n>"
        8 floats: the lane's 4-point bounding polygon (4x2, row-major)
        node_num lines of feature_num=5 floats:
            [x, y, intersection, turn_dir, traffic_control]
            (feature semantics documented at model_vec.py:370-377)

The companion OpenDRIVE -> .rmap generator lives in native/rough_map_node.cpp
(our own C++ tool, built by scripts/build_native.sh); ``build_rmap`` runs it
as a program.

The port's own copy of the JAX package's ``mapping/rough_map.py``, with its
lane-position helpers (``locate_on_lane``, ``resolve_lane_position``,
``resolve_road_position``, ``road_position_of``), which resolve OpenSCENARIO
``LanePosition`` / ``RoadPosition`` through the rmap v3 ids;
``vectorize_xodr`` builds the port's own birdview (``mapping/birdview.py``).
"""

from __future__ import annotations

import math
import os
import subprocess
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class RoughLane:
    polygon: np.ndarray      # (4, 2) bounding polygon
    nodes: np.ndarray        # (node_num, feature_num) — the 5-feature contract
    widths: np.ndarray = None  # (node_num,) lane widths, meters (rmap v2) or None
    # rmap v3: OpenDRIVE ids + per-node road arclength, for OpenSCENARIO
    # LanePosition (roadId, laneId, s, offset) -> world resolution
    road_id: str = ""
    lane_id: int = 0
    node_s: np.ndarray = None  # (node_num,) road s of each sample or None


class RoughMap:
    """Reads a .rmap and crops lanes around an ego pose into model inputs."""

    def __init__(self, up: float = 28.0, down: float = 28.0, left: float = 28.0,
                 right: float = 28.0, lane_node_num: int = 10, feature_num: int = 5):
        # query box in ego frame; x forward (+up/-down), y lateral (-left/+right)
        self.base_polygon = np.array(
            [[up, -left], [-down, -left], [-down, right], [up, right]], dtype=np.float64)
        self.lane_node_num = lane_node_num
        self.feature_num = feature_num
        self.lanes: List[RoughLane] = []
        self._polys: Optional[np.ndarray] = None   # (L, 4, 2) stacked

    # ---- IO --------------------------------------------------------------- #

    def read(self, file_path: str) -> "RoughMap":
        with open(file_path) as f:
            f.readline()  # header
            lane_num = int(f.readline().strip().split(" ")[1])
            self.lanes = []
            for _ in range(lane_num):
                head = f.readline().strip().split(" ")
                node_num = int(head[1])
                # v3 lane headers: "node_num N road <id> lane <id>"
                road_id, lane_id = "", 0
                if "road" in head:
                    road_id = head[head.index("road") + 1]
                if "lane" in head:
                    lane_id = int(head[head.index("lane") + 1])
                polygon = np.array(f.readline().strip().split(), dtype=np.float64).reshape(4, 2)
                nodes = np.array(
                    [f.readline().strip().split(" ") for _ in range(node_num)],
                    dtype=np.float64)
                # v2 files append a 6th per-node column (lane width), v3 a
                # 7th (road arclength s); the model-facing feature contract
                # stays the reference's 5
                widths = node_s = None
                if nodes.ndim == 2 and nodes.shape[1] > 6:
                    node_s = nodes[:, 6].copy()
                if nodes.ndim == 2 and nodes.shape[1] > 5:
                    widths = nodes[:, 5].copy()
                    nodes = nodes[:, :5]
                self.lanes.append(RoughLane(polygon, nodes, widths,
                                            road_id, lane_id, node_s))
        self._build_crop_cache()
        return self

    def _build_crop_cache(self) -> None:
        """Precompute everything the per-pose crop needs that is constant per
        map: stacked polygons, padded node table, and the SAT quantities that
        depend only on the lane polygons (their edge normals and their own
        vertex projections onto them). Cuts the per-tick crop from ~0.55 ms
        to a handful of fused einsums (scripts/_fleet_profile.py)."""
        L = len(self.lanes)
        N, F = self.lane_node_num, self.feature_num
        self._polys = (np.stack([l.polygon for l in self.lanes])
                       if self.lanes else np.zeros((0, 4, 2)))
        nodes = np.zeros((L, N, F), dtype=np.float64)
        counts = np.zeros((L,), dtype=np.int64)
        for i, lane in enumerate(self.lanes):
            n = min(lane.nodes.shape[0], N)
            nodes[i, :n] = lane.nodes[:n, :F]
            counts[i] = n
        self._nodes_padded = nodes
        self._node_mask = (np.arange(N)[None, :]
                           < counts[:, None]).astype(np.float64)[..., None]
        e = np.roll(self._polys, -1, axis=1) - self._polys        # (L, 4, 2)
        self._lane_normals = np.stack([-e[..., 1], e[..., 0]], axis=-1)
        self._lane_axis_ok = np.any(self._lane_normals != 0.0, axis=2)
        # lane vertices projected onto the lane's OWN axes: (L, axis, vertex)
        self_proj = np.einsum("lqc,lac->laq", self._polys, self._lane_normals)
        self._self_proj_min = self_proj.min(axis=2)               # (L, 4)
        self._self_proj_max = self_proj.max(axis=2)

    # ---- crop ------------------------------------------------------------- #

    def process(self, pose2d: Sequence[float]) -> np.ndarray:
        """pose2d [x, y, theta] -> (num_lanes, lane_node_num, feature_num).

        Lanes whose bounding polygon intersects the ego query box are kept;
        nodes are expressed in the ego frame; short lanes are zero-padded.
        Returns an empty (0, ...) array when no lane is near (callers fall
        back to zeros(1, N, F) with a warning, reference base_agent.py:216-218).
        """
        x, y, theta = pose2d
        c, s = math.cos(theta), math.sin(theta)
        rot = np.array([[c, -s], [s, c]])
        t = np.array([x, y])
        query = self.base_polygon @ rot.T + t

        if getattr(self, "_nodes_padded", None) is None \
                or self._nodes_padded.shape[0] != len(self.lanes):
            self._build_crop_cache()   # lanes assigned outside read()
        if self._polys.shape[0] == 0:
            return np.zeros((0, self.lane_node_num, self.feature_num))

        # SAT against all lanes at once (touching counts as intersecting,
        # as shapely's ``disjoint``; per-map parts precomputed in read()):
        # axes from the query polygon ...
        eq = np.roll(query, -1, axis=0) - query
        qnorm = np.stack([-eq[:, 1], eq[:, 0]], axis=-1)          # (4, 2)
        q_ok = np.any(qnorm != 0.0, axis=1)
        a = query @ qnorm.T                                       # (vert, axis)
        b = np.einsum("lqc,ac->lqa", self._polys, qnorm)          # (L, q, axis)
        sep_q = ((a.max(axis=0)[None] < b.min(axis=1))
                 | (b.max(axis=1) < a.min(axis=0)[None])) & q_ok[None]
        # ... and axes from each lane polygon (self-projections precomputed)
        a2 = np.einsum("pc,lac->lap", query, self._lane_normals)  # (L, ax, p)
        a2min, a2max = a2.min(axis=2), a2.max(axis=2)
        sep_l = ((a2max < self._self_proj_min)
                 | (self._self_proj_max < a2min)) & self._lane_axis_ok
        keep = ~(sep_q.any(axis=1) | sep_l.any(axis=1))

        idx = np.nonzero(keep)[0]
        if idx.size == 0:
            return np.zeros((0, self.lane_node_num, self.feature_num))
        sel = self._nodes_padded[idx]                             # (K, N, F)
        out = sel.copy()
        # rotate real nodes into the ego frame; padded rows stay zero
        out[..., :2] = ((sel[..., :2] - t) @ rot) * self._node_mask[idx]
        return out

    def process_padded(self, pose2d: Sequence[float],
                       max_lanes: int) -> Tuple[np.ndarray, int]:
        """Crop and pad to the static (max_lanes, N, F) model input."""
        lanes = self.process(pose2d)
        n = lanes.shape[0]
        if n == 0:
            # reference fallback: a single all-zero lane (mmfn_vectornet.py:179-181)
            return np.zeros((max_lanes, self.lane_node_num, self.feature_num),
                            dtype=np.float32), 1
        out = np.zeros((max_lanes, self.lane_node_num, self.feature_num), dtype=np.float32)
        n = min(n, max_lanes)
        out[:n] = lanes[:n]
        return out, n


def locate_on_lane(rough_map: "RoughMap", x: float, y: float
                   ) -> Tuple[str, int, float, float]:
    """Inverse of :func:`resolve_lane_position`: nearest driving lane to a
    CARLA world point -> (road_id, lane_id, s, distance). Projects the point
    onto every v3 lane polyline segment and interpolates the arclength.
    Raises KeyError when the map carries no v3 ids."""
    p = np.array([x, y], dtype=np.float64)
    best = None
    for lane in rough_map.lanes:
        if lane.node_s is None or len(lane.node_s) < 2:
            continue
        a = lane.nodes[:-1, :2]
        ab = lane.nodes[1:, :2] - a
        denom = np.einsum("ij,ij->i", ab, ab)
        denom[denom == 0.0] = 1e-12
        t = np.clip(np.einsum("ij,ij->i", p - a, ab) / denom, 0.0, 1.0)
        proj = a + t[:, None] * ab
        d = np.linalg.norm(proj - p, axis=1)
        k = int(np.argmin(d))
        s = float(lane.node_s[k] + t[k] * (lane.node_s[k + 1] - lane.node_s[k]))
        if best is None or d[k] < best[3]:
            best = (lane.road_id, lane.lane_id, s, float(d[k]))
    if best is None:
        raise KeyError("map has no rmap v3 lanes (ids/arclength missing)")
    return best


def resolve_lane_position(rough_map: "RoughMap", road_id: str, lane_id: int,
                          s: float, offset: float = 0.0
                          ) -> Tuple[float, float, float]:
    """OpenSCENARIO LanePosition (roadId, laneId, s, offset) -> (x, y, yaw)
    in the CARLA world frame, through the rmap v3 ids/arclength columns.

    The lane-center point at road arclength ``s`` is interpolated along the
    matching lane polyline; ``yaw`` is the direction of travel there;
    ``offset`` displaces laterally toward the road's +t axis (left of the
    reference line), which in the y-flipped CARLA frame is right-of-travel
    for right-side lanes (id < 0) and left-of-travel for left-side lanes —
    the same convention CARLA's own map API applies.

    Raises KeyError when the map has no v3 ids or no such lane, ValueError
    when ``s`` is outside the road.
    """
    chunks = [l for l in rough_map.lanes
              if l.road_id == str(road_id) and l.lane_id == int(lane_id)
              and l.node_s is not None and len(l.node_s) >= 2]
    if not chunks:
        raise KeyError(f"no lane road={road_id} lane={lane_id} in the map "
                       f"(rmap v3 ids required for LanePosition)")
    best = None  # (clamped distance outside the chunk's s range, chunk)
    for lane in chunks:
        lo, hi = float(np.min(lane.node_s)), float(np.max(lane.node_s))
        gap = max(lo - s, s - hi, 0.0)
        if best is None or gap < best[0]:
            best = (gap, lane)
    gap, lane = best
    if gap > 1e-6:
        raise ValueError(f"s={s} outside road {road_id} lane {lane_id} "
                         f"(off by {gap:.2f} m)")
    # node_s runs descending for left-side lanes (polylines are emitted in
    # direction of travel); np.interp needs ascending xp
    s_arr, xy = lane.node_s, lane.nodes[:, :2]
    if s_arr[0] > s_arr[-1]:
        s_arr, xy = s_arr[::-1], xy[::-1]
    x = float(np.interp(s, s_arr, xy[:, 0]))
    y = float(np.interp(s, s_arr, xy[:, 1]))
    # direction of travel at s, from the polyline in emitted (travel) order
    travel_s = lane.node_s
    k = int(np.clip(np.searchsorted(s_arr, s), 1, len(s_arr) - 1))
    seg = xy[k] - xy[k - 1]               # ascending-s direction
    if travel_s[0] > travel_s[-1]:
        seg = -seg                        # travel runs against s
    yaw = math.atan2(float(seg[1]), float(seg[0]))
    if offset:
        # +t axis in the y-flipped frame: rotate travel -90 deg for right
        # lanes (travel == +s), +90 deg for left lanes (travel == -s)
        n = (np.array([seg[1], -seg[0]]) if lane_id < 0
             else np.array([-seg[1], seg[0]]))
        n = n / (np.linalg.norm(n) + 1e-12)
        x += float(n[0]) * offset
        y += float(n[1]) * offset
    return x, y, yaw


def _lane_at_s(rough_map: "RoughMap", road_id: str, s: float,
               prefer_inner: bool = True):
    """Pick the lane chunk of ``road_id`` covering arclength ``s``.
    ``prefer_inner`` favors the smallest |lane_id| (adjacent to the road
    reference line), ties to the right side (id < 0). Raises like
    :func:`resolve_lane_position`."""
    chunks = [l for l in rough_map.lanes
              if l.road_id == str(road_id)
              and l.node_s is not None and len(l.node_s) >= 2]
    if not chunks:
        raise KeyError(f"no road {road_id} in the map (rmap v3 ids required)")
    best = None
    for lane in chunks:
        lo, hi = float(np.min(lane.node_s)), float(np.max(lane.node_s))
        gap = max(lo - s, s - hi, 0.0)
        key = (gap > 1e-6, abs(lane.lane_id) if prefer_inner else 0,
               lane.lane_id > 0, gap)
        if best is None or key < best[0]:
            best = (key, lane)
    key, lane = best
    if key[0]:
        raise ValueError(f"s={s} outside road {road_id}")
    return lane


def _lane_frame_at(lane: RoughLane, s: float):
    """(center_xy, s_dir unit vector of increasing s, lane width) at ``s``."""
    if lane.widths is None:
        raise KeyError("rmap v2 lane widths required for road (s, t) "
                       "resolution — rebuild the map with the current tool")
    s_arr, xy, widths = lane.node_s, lane.nodes[:, :2], lane.widths
    if s_arr[0] > s_arr[-1]:
        s_arr, xy, widths = s_arr[::-1], xy[::-1], widths[::-1]
    cx = float(np.interp(s, s_arr, xy[:, 0]))
    cy = float(np.interp(s, s_arr, xy[:, 1]))
    w = float(np.interp(s, s_arr, widths))
    k = int(np.clip(np.searchsorted(s_arr, s), 1, len(s_arr) - 1))
    seg = xy[k] - xy[k - 1]
    seg = seg / (np.linalg.norm(seg) + 1e-12)
    return np.array([cx, cy]), seg, w


def _t_axis(s_dir: np.ndarray) -> np.ndarray:
    """The road's +t axis in the y-flipped CARLA frame: OpenDRIVE's +t
    (left of the reference line) maps to rotate(+s, -90 deg) here — the
    same handedness :func:`resolve_lane_position` applies per lane side."""
    return np.array([s_dir[1], -s_dir[0]])


def _t_of_lane_center(rough_map: "RoughMap", road_id: str, lane_id: int,
                      s: float) -> float:
    """t-coordinate of a lane's centerline at ``s``: the signed cumulative
    width of the lanes between it and the reference line plus half its own.
    Missing intermediate lanes (non-driving lanes the vectorizer skips)
    fall back to this lane's width."""
    side = {}
    for lane in rough_map.lanes:
        if lane.road_id != str(road_id) or lane.node_s is None \
                or np.sign(lane.lane_id) != np.sign(lane_id):
            continue
        lo, hi = float(np.min(lane.node_s)), float(np.max(lane.node_s))
        if lo - 1e-6 <= s <= hi + 1e-6 and lane.widths is not None:
            sa, wd = lane.node_s, lane.widths
            if sa[0] > sa[-1]:
                sa, wd = sa[::-1], wd[::-1]
            side[abs(lane.lane_id)] = float(np.interp(s, sa, wd))
    own = side.get(abs(lane_id), 3.5)
    total = sum(side.get(k, own) for k in range(1, abs(lane_id))) + own / 2.0
    return float(np.sign(lane_id)) * total


def resolve_road_position(rough_map: "RoughMap", road_id: str, s: float,
                          t: float = 0.0) -> Tuple[float, float, float]:
    """OpenSCENARIO RoadPosition (roadId, s, t) -> (x, y, yaw) in the CARLA
    world frame. The road reference line is reconstructed from the innermost
    emitted lane's centerline and width columns (rmap v2/v3): its center sits
    at t = sign(id) * (cumulative inner widths + w/2), so the reference line
    is that center displaced back to t = 0 along the road's t-axis. ``yaw``
    is the direction of increasing ``s`` (OSC's road-relative default).
    Reference conversion: srunner/tools/openscenario_parser.py:548-550
    (via the CARLA map API, which this environment has no server for)."""
    lane = _lane_at_s(rough_map, road_id, s, prefer_inner=True)
    center, s_dir, _ = _lane_frame_at(lane, s)
    t_center = _t_of_lane_center(rough_map, str(road_id), lane.lane_id, s)
    n_t = _t_axis(s_dir)
    p = center + n_t * (t - t_center)
    yaw = math.atan2(float(s_dir[1]), float(s_dir[0]))
    return float(p[0]), float(p[1]), yaw


def road_position_of(rough_map: "RoughMap", x: float, y: float
                     ) -> Tuple[str, float, float]:
    """Inverse of :func:`resolve_road_position`: world point -> road-frame
    (road_id, s, t) via the nearest lane (the srunner RelativeRoadPosition
    base: CARLA get_waypoint + the entity's own road coordinates)."""
    road_id, lane_id, s, _ = locate_on_lane(rough_map, x, y)
    # long lanes split into multiple chunks sharing (road_id, lane_id):
    # pick the one whose arclength range covers s (the first match may sit
    # hundreds of meters away, and _lane_frame_at clamps to chunk ends)
    cands = [l for l in rough_map.lanes
             if l.road_id == road_id and l.lane_id == lane_id
             and l.node_s is not None and len(l.node_s) >= 2]
    lane = min(cands, key=lambda l: max(float(np.min(l.node_s)) - s,
                                        s - float(np.max(l.node_s)), 0.0))
    center, s_dir, _ = _lane_frame_at(lane, s)
    t_center = _t_of_lane_center(rough_map, road_id, lane_id, s)
    lateral = float(_t_axis(s_dir) @ (np.array([x, y]) - center))
    return road_id, s, t_center + lateral


# --------------------------------------------------------------------------- #
# Native-tool runner + writer
# --------------------------------------------------------------------------- #

def default_tool_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "native", "build", "rough_map_node")


def build_rmap(dirs: Sequence[str], tool_path: Optional[str] = None) -> bool:
    """Run the OpenDRIVE vectorizer on each dir (expects <dir>/opstr.txt,
    writes <dir>/a.rmap). Returns True on error, like the reference
    (utils.py:348-367). The tool prints 'ok' on success."""
    tool = tool_path or default_tool_path()
    if not os.path.exists(tool):
        print(f"rough_map_node not found at {tool}; run scripts/build_native.sh")
        return True
    for d in dirs:
        proc = subprocess.run([tool, d], capture_output=True, text=True)
        if proc.returncode != 0 or not proc.stdout.rstrip().endswith("ok"):
            print(f"rough_map_node failed for {d}: {proc.stdout} {proc.stderr}")
            return True
    return False


def write_rmap(path: str, lanes: Sequence[Tuple[np.ndarray, np.ndarray]],
               header: str = "rmap v1") -> None:
    """Write lanes [(polygon (4,2), nodes (N,F)), ...] in the .rmap format."""
    with open(path, "w") as f:
        f.write(header + "\n")
        f.write(f"lane_num {len(lanes)}\n")
        for polygon, nodes in lanes:
            f.write(f"node_num {len(nodes)}\n")
            f.write(" ".join(f"{v:.6f}" for v in np.asarray(polygon).reshape(-1)) + "\n")
            for row in np.asarray(nodes):
                f.write(" ".join(f"{v:.6f}" for v in row) + "\n")


def vectorize_xodr(xodr: str, work_dir: Optional[str] = None,
                   tool_path: Optional[str] = None, birdview: bool = True):
    """OpenDRIVE string -> (RoughMap, BirdViewProducer-or-None, rmap_path).

    The one shared implementation of the write-opstr -> rough_map_node ->
    RoughMap.read (-> BirdViewProducer) sequence that phase0, the examples,
    and the agents each need. Raises RuntimeError when the native vectorizer
    fails — silent map loss must not silently disable signals/penalties.
    """
    import tempfile

    base = work_dir or tempfile.mkdtemp(prefix="mmfn_map_")
    map_dir = os.path.join(base, "opendrive")
    os.makedirs(map_dir, exist_ok=True)
    with open(os.path.join(map_dir, "opstr.txt"), "w") as f:
        f.write(xodr)
    if build_rmap([map_dir], tool_path=tool_path):
        raise RuntimeError(f"rough_map_node failed to vectorize the map "
                           f"(see {map_dir}); run ./scripts/build_native.sh?")
    rmap_path = os.path.join(map_dir, "a.rmap")
    rough_map = RoughMap().read(rmap_path)
    producer = None
    if birdview:
        from mmfn_tpu_torch.mapping.birdview import BirdViewProducer

        producer = BirdViewProducer.from_opendrive(rmap_path)
    return rough_map, producer, rmap_path
