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

The port's own copy of the JAX package's ``mapping/rough_map.py``. The
lane-position helpers there (``locate_on_lane``, ``resolve_lane_position``
and the rest) serve OpenSCENARIO and are not ported yet; ``vectorize_xodr``
builds the port's own birdview (``mapping/birdview.py``).
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
