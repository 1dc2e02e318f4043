"""The device world: the fake world's sensors synthesized on the GPU.

``KinematicWorld(compact_sensors=True)`` (``harness/replay.py``) skips the
host's sensor synthesis and ships one ``world_state`` frame a tick, about
260 B: pose, speed, an actor slab, a light slab, rain, brightness and the
frame number. :class:`DeviceWorldPipeline` turns a fleet's compact frames
into the model's inputs on the device (the camera or the birdview raster,
two LiDAR sweeps and their BEV, the radar set and the lane crop) and runs
the forward: one batched call a tick for the whole fleet.

The port's own copy of the JAX package's ``harness/device_world.py``, with
the same ranges, rates and weather model. What differs is the random
stream. JAX keys each vehicle by ``fold_in(fold_in(PRNGKey(seed), frame),
vehicle)``; here each draw is a 32-bit hash of (seed, frame, vehicle,
counter) in plain torch integer ops (:func:`hash_draws`), so a vehicle's
sensors depend only on those four numbers, never on the fleet's width or
the chunking, and the CPU and the GPU give the same bits. One tick's draws
for a vehicle are one counter range (:func:`draw_layout`), made by one hash
pass per chunk of vehicles. Each synthesizer is split into a core that
takes its draws as tensors (:func:`camera_core`, :func:`lidar_core`,
:func:`radar_core`) and a public function that makes them, so the tests can
feed the JAX package's own draws to the cores.

Transcendental functions of the geometry (cos, sin, atan2, hypot and the
inverse normal CDF) are evaluated in float64 and rounded to float32, so the
CPU's and the GPU's libraries, which differ in the last bit of a float32
result, give the same float32: the BEV of a vehicle is the same on both.

The BEV is binned by ``ops/lidar.py:lidar_to_histogram_features``, one
launch of kernel 1 (``csrc/bev_hist.cu``) for the whole fleet's stacked
clouds, and the model runs kernel 2 with ``attn_impl="pallas"``.

With a list of devices (the JAX pipeline's ``mesh``) the fleet splits as
``TorchPipeline``'s does (``harness/agents/pipeline.py:Replicas``): the
model and the map tables are replicated on each device, the ten payload
columns split into contiguous shards, each synthesized and run on its own
stream, one BEV launch a shard. The draws stay keyed by each vehicle's
global index, so a sharded fleet sees the sensors of an unsharded one.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Mapping, Optional

import numpy as np
import torch

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.data.batch import Batch
from mmfn_tpu_torch.harness.agents.pipeline import Replicas, resolve_devices, staging_buffer
from mmfn_tpu_torch.ops.lidar import lidar_to_histogram_features
from mmfn_tpu_torch.ops.radar import radar_adjacency

# actor slab width: scenario actors visible to the synthesizers (a static
# shape; actors beyond it are dropped, nearest kept)
ACTOR_SLAB = 8

# traffic-light slab for the birdview raster (nearest lights kept)
LIGHT_SLAB = 8
_LIGHT_CODE = {"green": 0.0, "yellow": 1.0, "red": 2.0}

GROUND_POINTS = 1200            # KinematicWorld's default lidar_points field


def _world():
    """``KinematicWorld`` owns the sensor constants; ``replay.py`` imports
    this module inside its methods, so the import stays inside too."""
    from mmfn_tpu_torch.harness.replay import KinematicWorld

    return KinematicWorld


# --------------------------------------------------------------------------- #
# Counter-based draws
# --------------------------------------------------------------------------- #

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): two 16-bit halves of c,
    so no product leaves int64's range."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def vehicle_keys(seed: int, frame: torch.Tensor, vehicle: torch.Tensor) -> torch.Tensor:
    """(V,) int64 frame and vehicle numbers -> (V,) 32-bit stream keys."""
    k = _fmix32(torch.full_like(frame, ((seed * _GOLDEN) ^ 0x243F6A88) & _M32))
    k = _fmix32(((k ^ _mul32(frame & _M32, _GOLDEN)) + 0x85A308D3) & _M32)
    return _fmix32(((k ^ _mul32(vehicle & _M32, _GOLDEN)) + 0x13198A2E) & _M32)


def hash_draws(seed: int, frame: torch.Tensor, vehicle: torch.Tensor,
               start: int, count: int) -> torch.Tensor:
    """(V, count) 32-bit hashes of counters ``start .. start + count - 1`` of
    each vehicle's stream, as int64."""
    ctr = torch.arange(start, start + count, dtype=torch.int64, device=frame.device)
    key = vehicle_keys(seed, frame, vehicle)
    return _fmix32((key[:, None] + _mul32(ctr, _GOLDEN)[None]) & _M32)


def draw_layout(camera_resolution: int = 0) -> "OrderedDict[str, tuple]":
    """One tick's draws for one vehicle: name -> (first counter, shape, kind).
    The LiDAR and radar draws come first, so they do not depend on whether
    (and at what resolution) the camera is drawn. Kinds: ``uniform`` in
    [0, 1), ``normal``, ``int255`` in 0..254."""
    A, W = ACTOR_SLAB, _world()
    maxc = 2 * W.RADAR_CLUTTER
    parts = [("ground", (2, GROUND_POINTS, 4), "uniform"),
             ("actor", (2, A, W.LIDAR_PER_ACTOR, 4), "uniform"),
             ("rain", (2, W.RAIN_POINTS, 3), "uniform"),
             ("radar_normal", (2, maxc, 2), "normal"),
             ("radar_uniform", (2, maxc, 2), "uniform")]
    if camera_resolution:
        parts.append(("camera", (camera_resolution, camera_resolution, 3), "int255"))
    out, at = OrderedDict(), 0
    for name, shape, kind in parts:
        out[name] = (at, shape, kind)
        at += math.prod(shape)
    return out


def _to_kind(h: torch.Tensor, kind: str) -> torch.Tensor:
    top = h >> 8                                        # 24 bits
    if kind == "int255":
        return (top * 255) >> 24
    if kind == "uniform":
        return top.to(torch.float32) * 2.0 ** -24
    # normal: the inverse CDF at the centre of the 24-bit cell, never 0 or 1
    return torch.special.ndtri((top.to(torch.float64) + 0.5) * 2.0 ** -24).to(torch.float32)


def make_draws(seed: int, frame: torch.Tensor, vehicle: torch.Tensor, names,
               camera_resolution: int = 0) -> dict:
    """The named draws of ``draw_layout`` for each vehicle, from one hash
    pass over the counter range that covers them: name -> (V, *shape)."""
    layout = draw_layout(camera_resolution)
    spans = [(layout[n][0], layout[n][0] + math.prod(layout[n][1])) for n in names]
    lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
    h = hash_draws(seed, frame, vehicle, lo, hi - lo)
    out = {}
    for name in names:
        at, shape, kind = layout[name]
        n = math.prod(shape)
        out[name] = _to_kind(h[:, at - lo:at - lo + n], kind).reshape((-1,) + shape)
    return out


# --------------------------------------------------------------------------- #
# Float64 transcendentals, rounded to float32
# --------------------------------------------------------------------------- #

def _cos(x):
    return torch.cos(x.double()).float()


def _sin(x):
    return torch.sin(x.double()).float()


# --------------------------------------------------------------------------- #
# The lane crop
# --------------------------------------------------------------------------- #

def map_tables(rough_map) -> dict:
    """A map's static arrays for :func:`crop_lanes` (from the RoughMap's crop
    cache): lane polygons, the zero-padded node table, the per-node validity
    mask and the query polygon."""
    if getattr(rough_map, "_nodes_padded", None) is None \
            or rough_map._nodes_padded.shape[0] != len(rough_map.lanes):
        rough_map._build_crop_cache()
    return {
        "polys": np.asarray(rough_map._polys, np.float32),
        "nodes": np.asarray(rough_map._nodes_padded, np.float32),
        "node_mask": np.asarray(rough_map._node_mask[..., 0], np.float32),
        "base_polygon": np.asarray(rough_map.base_polygon, np.float32),
    }


def crop_lanes(pose: torch.Tensor, tables: dict, max_lanes: int):
    """``RoughMap.process_padded`` for a batch: poses (V, 3) [x, y, theta] ->
    ((V, max_lanes, N, F) ego-frame lanes, (V,) int32 lane_num), in float32.
    Kept lanes come in map order; a map with fewer lanes than ``max_lanes``
    pads with zero rows; no kept lane gives all-zero lanes with lane_num 1
    (the reference's empty-crop fallback, mmfn_vectornet.py:179-181)."""
    polys, nodes, node_mask = tables["polys"], tables["nodes"], tables["node_mask"]
    bp = tables["base_polygon"]
    L = polys.shape[0]
    x, y = pose[:, 0:1], pose[:, 1:2]                              # (V, 1)
    c, s = _cos(pose[:, 2:3]), _sin(pose[:, 2:3])
    # query = base_polygon @ [[c, -s], [s, c]].T + t              (V, 4, 2)
    query = torch.stack([bp[:, 0] * c + bp[:, 1] * -s + x,
                         bp[:, 0] * s + bp[:, 1] * c + y], dim=-1)

    def proj(pts, axes):
        """pts (..., P, 2) onto axes (..., X, 2) -> (..., P, X)."""
        return (pts[..., :, None, 0] * axes[..., None, :, 0]
                + pts[..., :, None, 1] * axes[..., None, :, 1])

    # SAT separation on the query's axes ...
    eq = torch.roll(query, -1, dims=1) - query
    qnorm = torch.stack([-eq[..., 1], eq[..., 0]], dim=-1)         # (V, 4, 2)
    a = proj(query, qnorm)                                         # (V, vert, axis)
    b = proj(polys[None], qnorm[:, None])                          # (V, L, q, axis)
    sep_q = (a.amax(1)[:, None] < b.amin(2)) | (b.amax(2) < a.amin(1)[:, None])
    # ... and on each lane polygon's axes
    el = torch.roll(polys, -1, dims=1) - polys
    lnorm = torch.stack([-el[..., 1], el[..., 0]], dim=-1)         # (L, 4, 2)
    l_ok = (lnorm != 0.0).any(2)
    self_proj = proj(polys, lnorm)                                 # (L, q, axis)
    a2 = proj(query[:, None], lnorm[None])                         # (V, L, p, axis)
    sep_l = ((a2.amax(2) < self_proj.amin(1)) | (self_proj.amax(1) < a2.amin(2))) & l_ok
    keep = ~(sep_q.any(2) | sep_l.any(2))                          # (V, L)

    # stable compaction: kept lanes first, in map order
    ar = torch.arange(L, device=pose.device)
    order = torch.argsort(torch.where(keep, ar, L + ar), dim=1, stable=True)
    pad = max(0, max_lanes - L)
    take = torch.cat([order, order.new_zeros(len(order), pad)], 1)[:, :max_lanes]
    valid = torch.cat([torch.gather(keep, 1, order), keep.new_zeros(len(keep), pad)],
                      1)[:, :max_lanes].to(torch.float32)
    sel = nodes[take]                                              # (V, ML, N, F)
    mask = node_mask[take][..., None] * valid[:, :, None, None]
    dx = sel[..., 0] - x[:, :, None]
    dy = sel[..., 1] - y[:, :, None]
    cc, ss = c[:, :, None], s[:, :, None]
    # (sel[..., :2] - t) @ [[c, -s], [s, c]]
    local = torch.stack([dx * cc + dy * ss, dx * -ss + dy * cc], dim=-1) * mask
    lanes = torch.cat([local, sel[..., 2:] * mask], dim=-1)
    lane_num = keep.sum(1).clamp(1, max_lanes).to(torch.int32)
    return lanes, lane_num


# --------------------------------------------------------------------------- #
# The birdview raster (the img variant's map stream and camera)
# --------------------------------------------------------------------------- #

def raster_tables(producer) -> dict:
    """A map's static arrays for :func:`synth_birdview`: the producer's road,
    lane-marking and centreline canvases stacked as one (H, W, 3) uint8
    table, and the canvas origin."""
    canvas = np.stack([producer._road, producer._lanes_mask, producer._center], axis=-1)
    return {"bv_canvas": np.asarray(canvas, np.uint8),
            "bv_min_xy": np.asarray(producer.min_xy, np.float32)}


def synth_birdview(pose, actors, lights, tables: dict, ppm: int, target: int,
                   crop_size: int) -> torch.Tensor:
    """``BirdViewProducer.produce`` + ``as_rgb`` for a batch: the ego-centred,
    heading-up (V, target, target, 3) float raster (0-255, undimmed).

    Static layers: each output pixel samples the full-map canvas through the
    inverse of the host's crop -> rotate -> centre-crop chain, bilinear with
    4 taps, and a channel is on where any tap of positive weight lands on
    an occupied pixel (as_rgb's ``> 0`` of the bilinear value). The crop
    window is clamped to stay on the canvas, as ``jax.lax.dynamic_slice``
    clamps it; the producer's margin keeps an on-map ego clear of the edge.
    Dynamic layers: point-in-rotated-rectangle tests for vehicle, walker and
    ego boxes in the unrounded ego frame, and circles at the rounded
    crop-frame centres for the lights.

    pose (V, 3); actors (V, A, 9) [rel_x, rel_y, vel_x, vel_y, extent,
    id%5, yaw, is_walker, vis_graphics]; lights (V, LS, 4) [x, y,
    state_code, valid] in world coordinates (0 green, 1 yellow, else red)."""
    from mmfn_tpu_torch.mapping import birdview as bv

    dev = pose.device
    theta = pose[:, 2, None, None]                                 # (V, 1, 1)
    half = crop_size // 2
    off = (crop_size - target) // 2
    canvas, min_xy = tables["bv_canvas"], tables["bv_min_xy"]
    H, W = canvas.shape[0], canvas.shape[1]

    # output pixel (row i, col j) -> pre-rotation crop-frame coordinates
    ii, jj = torch.meshgrid(torch.arange(target, dtype=torch.float32, device=dev),
                            torch.arange(target, dtype=torch.float32, device=dev),
                            indexing="ij")
    a = theta + math.pi / 2
    ca, sa = _cos(a), _sin(a)
    dx = jj + off - half
    dy = ii + off - half
    src_x = ca * dx - sa * dy + half                               # (V, T, T)
    src_y = sa * dx + ca * dy + half

    # the host crops at the rounded ego pixel
    cx = torch.round((pose[:, 0] - min_xy[0]) * ppm).to(torch.int64)
    cy = torch.round((pose[:, 1] - min_xy[1]) * ppm).to(torch.int64)
    y0 = (cy - half).clamp(0, H - crop_size)[:, None, None]
    x0 = (cx - half).clamp(0, W - crop_size)[:, None, None]
    flat = canvas.reshape(H * W, 3)
    u0, v0 = torch.floor(src_x), torch.floor(src_y)
    fu, fv = src_x - u0, src_y - v0

    def tap(vi, ui, w):
        ok = (vi >= 0) & (vi < crop_size) & (ui >= 0) & (ui < crop_size) & (w > 0)
        row = vi.clamp(0, crop_size - 1).to(torch.int64) + y0
        col = ui.clamp(0, crop_size - 1).to(torch.int64) + x0
        return (flat[row * W + col] > 0) & ok[..., None]

    static = (tap(v0, u0, (1 - fu) * (1 - fv)) | tap(v0, u0 + 1, fu * (1 - fv))
              | tap(v0 + 1, u0, (1 - fu) * fv) | tap(v0 + 1, u0 + 1, fu * fv))
    road, lane_m, center = static.unbind(-1)

    # dynamic layers in the unrounded ego frame: world offset of each pixel
    wx = ((src_x - half) / ppm)[..., None]                         # (V, T, T, 1)
    wy = ((src_y - half) / ppm)[..., None]
    ax, ay = actors[:, None, None, :, 0], actors[:, None, None, :, 1]
    cb, sb = _cos(actors[..., 6])[:, None, None], _sin(actors[..., 6])[:, None, None]
    ox, oy = wx - ax, wy - ay
    fwd = ox * cb + oy * sb
    side = -ox * sb + oy * cb
    ext = actors[:, None, None, :, 4]
    inside = (fwd.abs() <= 2.0 * ext / 2) & (side.abs() <= 1.4 * ext / 2)
    gfx = actors[..., 8] > 0
    walker = actors[..., 7] > 0
    vehicles = (inside & (gfx & ~walker)[:, None, None]).any(-1)
    peds = (inside & (gfx & walker)[:, None, None]).any(-1)
    wx, wy = wx[..., 0], wy[..., 0]
    ct, st = _cos(theta), _sin(theta)
    ego = ((wx * ct + wy * st).abs() <= 4.9 / 2) & ((-wx * st + wy * ct).abs() <= 2.1 / 2)

    r_px = max(2, int(bv.LIGHT_RADIUS_M * ppm))
    lpx = torch.round((lights[..., 0] - pose[:, 0:1]) * ppm + half)[:, None, None]
    lpy = torch.round((lights[..., 1] - pose[:, 1:2]) * ppm + half)[:, None, None]
    d2 = (src_x[..., None] - lpx) ** 2 + (src_y[..., None] - lpy) ** 2
    hit = (d2 <= float(r_px) ** 2) & (lights[:, None, None, :, 3] > 0)
    code = lights[:, None, None, :, 2]
    green = (hit & (code == 0.0)).any(-1)
    yellow = (hit & (code == 1.0)).any(-1)
    red = (hit & (code != 0.0) & (code != 1.0)).any(-1)

    # palette composition, bottom to top (birdview._BOTTOM_TO_TOP)
    layers = [(road, bv.ROAD), (lane_m, bv.LANES), (center, bv.CENTERLINES),
              (green, bv.GREEN_LIGHTS), (yellow, bv.YELLOW_LIGHTS),
              (red, bv.RED_LIGHTS), (ego, bv.AGENT), (vehicles, bv.VEHICLES),
              (peds, bv.PEDESTRIANS)]
    rgb = torch.zeros(pose.shape[0], target, target, 3, dtype=torch.float32, device=dev)
    for mask, idx in layers:
        color = torch.tensor(bv._PALETTE[idx], dtype=torch.float32, device=dev)
        rgb = torch.where(mask[..., None], color, rgb)
    return rgb


# --------------------------------------------------------------------------- #
# Sensor synthesis: cores that take their draws, and the public functions
# --------------------------------------------------------------------------- #

def camera_core(raw: torch.Tensor, brightness: torch.Tensor) -> torch.Tensor:
    """Noise camera at the model's input crop: (V, R, R, 3) integers 0..254
    dimmed by the sun (``KinematicWorld._camera_brightness``), floored."""
    return torch.floor(raw.to(torch.float32) * brightness[:, None, None, None])


def synth_camera(seed: int, frame, vehicle, brightness, resolution: int = 256):
    raw = make_draws(seed, frame, vehicle, ["camera"], resolution)["camera"]
    return camera_core(raw, brightness)


def _actor_ego_frame(rel, yaw):
    """World-frame offsets (V, A, 2) -> (lateral, forward) in the sensor
    frame (``KinematicWorld._ego_frame``)."""
    rx, ry = rel[..., 0].double(), rel[..., 1].double()
    cy, sy = torch.cos(yaw.double())[:, None], torch.sin(yaw.double())[:, None]
    fwd = rx * cy + ry * sy
    lat = rx * sy - ry * cy
    return lat, fwd


def lidar_core(ground, actor_u, rain_u, actors, actors_valid, yaw, rain) -> torch.Tensor:
    """Two merged sweeps as post-y-flip points (V, P, 4) [x, y, z, valid],
    each sweep ground, then actor outlines, then rain backscatter.

    ground (V, 2, G, 4), actor_u (V, 2, A, 40, 4) and rain_u (V, 2, 150, 3)
    uniforms; actors (V, A, >=5) [rel_x, rel_y, vel_x, vel_y, extent, ...];
    actors_valid (V, A); yaw, rain (V,)."""
    W = _world()
    V, A = actors.shape[0], actors.shape[1]
    G, R = ground.shape[2], rain_u.shape[2]
    r1 = rain[:, None, None]                                       # (V, 1, 1)
    z = torch.special.ndtri(ground[..., 2].clamp(1e-6, 1.0 - 1e-6).double()).float()
    gpts = torch.stack([ground[..., 0] * 40.0 - 20.0,
                        -(ground[..., 1] * 32.0 - 8.0),
                        W.GROUND_Z + 0.05 * z,
                        torch.ones_like(z)], dim=-1)               # (V, 2, G, 4)

    lat64, fwd64 = _actor_ego_frame(actors[..., :2], yaw)          # (V, A) float64
    lat, fwd = lat64.float(), fwd64.float()
    dist = torch.hypot(lat64, fwd64).float()
    lidar_range = W.LIDAR_RANGE * (1.0 - 0.35 * rain)
    keep_frac = 1.0 - 0.45 * rain
    u = actor_u                                                    # (V, 2, A, K, 4)
    ang = u[..., 0] * 2 * math.pi
    r = actors[:, None, :, 4:5] * (0.8 + 0.2 * u[..., 1])
    ok = ((actors_valid[:, None, :, None] > 0)
          & (dist <= lidar_range[:, None])[:, None, :, None]
          & (u[..., 2] < keep_frac[:, None, None, None]))
    apts = torch.stack([lat[:, None, :, None] + r * _cos(ang),
                        -(fwd[:, None, :, None] + r * _sin(ang)),
                        -1.8 + 1.3 * u[..., 3],
                        ok.to(torch.float32)], dim=-1).reshape(V, 2, -1, 4)

    rain_ok = (torch.arange(R, device=rain.device) < R * r1).to(torch.float32)  # (V, 1, R)
    rpts = torch.stack([rain_u[..., 0] * 24.0 - 12.0,
                        -(rain_u[..., 1] * 24.0 - 12.0),
                        -2.0 + 2.0 * rain_u[..., 2],
                        rain_ok.expand(V, 2, R)], dim=-1)
    pts = torch.cat([gpts, apts, rpts], dim=2)                     # (V, 2, P/2, 4)
    assert pts.shape[2] == G + A * W.LIDAR_PER_ACTOR + R
    return pts.reshape(V, -1, 4)


def synth_lidar_points(seed: int, frame, vehicle, actors, actors_valid, yaw, rain):
    d = make_draws(seed, frame, vehicle, ["ground", "actor", "rain"])
    return lidar_core(d["ground"], d["actor"], d["rain"], actors, actors_valid, yaw, rain)


def radar_fit(rows: torch.Tensor, valid: torch.Tensor, out_rows: int = 81) -> torch.Tensor:
    """``radar_to_size`` for a batch, rows (V, R, F), valid (V, R): with more
    than ``out_rows`` valid rows, the surplus rows of largest |velocity /
    depth| go (reference dataloader.py:336-346), the survivors keep their
    order; otherwise zero-padded. Both sorts are stable: the invalid rows
    all score -inf and tie."""
    n_extra = (valid.sum(1).to(torch.int64) - out_rows).clamp(min=0)
    ttc = (rows[..., 0] / torch.where(rows[..., 3] == 0, 1e-9, rows[..., 3])).abs()
    score = torch.where(valid > 0, ttc, -math.inf)
    rank = torch.argsort(torch.argsort(-score, dim=1, stable=True), dim=1, stable=True)
    keep = (valid > 0) & (rank >= n_extra[:, None])
    pos = torch.cumsum(keep.to(torch.int64), 1) - 1
    idx = torch.where(keep & (pos < out_rows), pos, out_rows)
    out = rows.new_zeros(rows.shape[0], out_rows + 1, rows.shape[2])
    out.scatter_(1, idx[..., None].expand_as(rows), rows * keep[..., None])
    return out[:, :out_rows]


def radar_core(normal, uniform, actors, actors_valid, yaw, ego_vel, rain,
               radar_points: int = 81) -> torch.Tensor:
    """Front (tag 1) and rear (tag 0) radar rows [velocity, altitude,
    azimuth, depth, tag], each face's clutter then its actors, fitted to
    (V, radar_points, 5): ``KinematicWorld._synth_radar``, the agents'
    tag-and-stack and ``radar_to_size``.

    normal, uniform (V, 2, 2 * RADAR_CLUTTER, 2), face 0 front; actors
    (V, A, >=6); actors_valid (V, A); yaw, rain (V,); ego_vel (V, 2)."""
    W = _world()
    V, A = actors.shape[0], actors.shape[1]
    maxc = normal.shape[2]
    fov = float(W.RADAR_FOV)
    n_clut = torch.round(W.RADAR_CLUTTER * (1.0 + rain)).to(torch.int64)
    clut_valid = torch.arange(maxc, device=rain.device)[None] < n_clut[:, None]   # (V, C)
    rel = actors[..., :2]
    depth64 = torch.hypot(rel[..., 0].double(), rel[..., 1].double())
    depth = depth64.float()
    safe64 = torch.where(depth64 > 0, depth64, 1.0)
    safe_d = safe64.float()
    closing = ((rel[..., 0] / safe_d) * (actors[..., 2] - ego_vel[:, None, 0])
               + (rel[..., 1] / safe_d) * (actors[..., 3] - ego_vel[:, None, 1]))
    alt = torch.atan2(-1.0 + 0.1 * actors[..., 5].double(), safe64).float()
    rows, oks = [], []
    for f, (face_yaw, tag) in enumerate(((yaw, 1.0), (yaw + math.pi, 0.0))):
        g, u = normal[:, f], uniform[:, f]
        clutter = torch.stack([
            g[..., 0] * 0.05 * (1 + rain[:, None]),
            g[..., 1] * 0.02,
            (u[..., 0] - 0.5) * fov,
            5.0 + u[..., 1] * (W.RADAR_RANGE - 5.0),
            torch.full_like(g[..., 0], tag)], dim=-1)               # (V, C, 5)
        fy = face_yaw.double()[:, None]
        rx, ry = rel[..., 0].double(), rel[..., 1].double()
        azim = torch.atan2(rx * torch.sin(fy) - ry * torch.cos(fy),
                           rx * torch.cos(fy) + ry * torch.sin(fy)).float()
        a_ok = ((actors_valid > 0) & (depth > 0.5) & (depth < W.RADAR_RANGE)
                & (azim.abs() <= fov / 2))
        arows = torch.stack([closing, alt, azim, depth, torch.full_like(depth, tag)], dim=-1)
        rows += [clutter, arows]
        oks += [clut_valid, a_ok]
    return radar_fit(torch.cat(rows, 1), torch.cat(oks, 1).to(torch.float32), radar_points)


def synth_radar(seed: int, frame, vehicle, actors, actors_valid, yaw, ego_vel, rain,
                radar_points: int = 81):
    d = make_draws(seed, frame, vehicle, ["radar_normal", "radar_uniform"])
    return radar_core(d["radar_normal"], d["radar_uniform"], actors, actors_valid, yaw,
                      ego_vel, rain, radar_points)


# --------------------------------------------------------------------------- #
# The pipeline
# --------------------------------------------------------------------------- #

# one vehicle's compact payload as one float32 row: name -> width
_COLUMNS = (("pose", 3), ("target_point", 2), ("speed", 1), ("actors", ACTOR_SLAB * 9),
            ("actors_valid", ACTOR_SLAB), ("rain", 1), ("brightness", 1),
            ("lights", LIGHT_SLAB * 4), ("frame", 1))
_ROW = sum(w for _, w in _COLUMNS)


class DeviceWorldPipeline:
    """The serving pipeline of the device world: compact payloads in (from
    ``MMFNAgent(device_world=True)`` in a ``KinematicWorld(compact_sensors=
    True)``), waypoints out, with every sensor synthesized on the device.

    ``model`` is a port MMFN or a reference state dict (then ``variant``
    names the model to build). ``birdview`` (None: on for the img variant,
    which needs it, off for vec and rad) synthesizes the ego-centred map
    raster from the map's canvases: the camera becomes the sun-dimmed raster
    and the img variant's map stream the undimmed one. A fleet shares one
    pipeline and so one map: :meth:`set_map` registers it, and a different
    map raises. ``synth_chunk`` synthesizes at most that many vehicles at a
    time, which bounds the memory of the birdview's per-pixel box tests; the
    forward stays one batched call and the BEV one kernel launch. ``device``
    is the CUDA device when None (raises when there is none), or a list of
    devices to split the fleet over (module docstring).

    Same public calls as ``TorchPipeline``: ``dispatch``, ``dispatch_fleet``
    (the device tensor, not waited for) and ``__call__``; :meth:`synthesize`
    returns the model's input ``Batch``.
    """

    packed = False
    host_bev = False

    def __init__(self, model, config: GlobalConfig, seed: int = 0,
                 synth_chunk: Optional[int] = 32, birdview: Optional[bool] = None,
                 variant: Optional[str] = None, device=None):
        self.variant = variant or "vec" if isinstance(model, Mapping) else model.variant
        if birdview is None:
            birdview = self.variant == "img"
        if self.variant == "img" and not birdview:
            raise ValueError("the img variant needs the birdview raster stream "
                             "(DeviceWorldPipeline(birdview=True))")
        self.birdview = birdview
        devices = resolve_devices(device)
        if isinstance(model, Mapping):
            from mmfn_tpu_torch.models.mmfn import build_model
            from mmfn_tpu_torch.utils.weights import load_reference_state_dict

            state_dict = model
            model = build_model(config, self.variant, device="cpu")
            load_reference_state_dict(model, state_dict)
        self.replicas = Replicas(model, devices)
        self.device = devices[0]
        self.model = self.replicas.models[0]
        self.synth_chunk = synth_chunk
        self.config = config
        self.seed = seed
        self._tables: list = []            # the map's tables, one dict a device
        self._raster_meta = None           # (ppm, target, crop_size)
        self._fingerprint = None
        self._staging = [{} for _ in devices]   # a shard's bytes -> (pinned buffer, event)

    # ---- the map ----

    def set_map(self, rough_map) -> None:
        tables = map_tables(rough_map)
        if self.birdview:
            from mmfn_tpu_torch.mapping.birdview import BirdViewProducer

            producer = BirdViewProducer(rough_map, target_size=self.config.input_resolution)
            tables.update(raster_tables(producer))
            self._raster_meta = (producer.ppm, producer.target_size, producer.crop_size)
        self.set_map_tables(tables)

    def set_map_tables(self, tables: dict) -> None:
        """Register the map's static arrays directly (what :meth:`set_map`
        extracts from a RoughMap; the keys of :func:`map_tables` and, for
        the birdview, :func:`raster_tables`)."""
        if self.birdview and "bv_canvas" not in tables:
            raise ValueError("birdview mode needs the raster canvas tables "
                             "(set_map builds them from the RoughMap)")
        # every table counts: two maps that share lane geometry but differ in
        # the query box, node validity or canvas must still trip the guard
        fp = (tables["polys"].shape,
              *(float(np.asarray(tables[k]).sum()) for k in sorted(tables)))
        if self._fingerprint is not None and fp != self._fingerprint:
            raise ValueError("device-world fleet agents share one pipeline and therefore "
                             "one map; a different map was registered mid-run")
        if self._fingerprint == fp:
            return
        self._fingerprint = fp
        self._tables = [{k: torch.as_tensor(np.asarray(v)).to(d) for k, v in tables.items()}
                        for d in self.replicas.devices]

    # ---- host side ----

    def _upload(self, payloads, shard: int = 0) -> dict:
        """The payloads' columns as one float32 (V, row) host array, one
        copy to shard ``shard``'s device: name -> (V, ...) device tensors."""
        n = len(payloads)
        device = self.replicas.devices[shard]
        host, done = staging_buffer(self._staging[shard], n * _ROW * 4, device)
        host = host.view(torch.float32).view(n, _ROW)
        rows = host.numpy()
        for i, p in enumerate(payloads):
            lights = p.get("lights")
            frame = int(p["frame"])
            if not 0 <= frame < 2 ** 24:
                raise ValueError(f"frame {frame} does not fit a float32 row")
            rows[i] = np.concatenate([
                np.asarray(p["pose"], np.float32).reshape(3),
                np.asarray(p["target_point"], np.float32).reshape(2),
                [p["speed"]], np.asarray(p["actors"], np.float32).reshape(ACTOR_SLAB * 9),
                np.asarray(p["actors_valid"], np.float32).reshape(ACTOR_SLAB),
                [p["rain"], p["brightness"]],
                (np.zeros(LIGHT_SLAB * 4, np.float32) if lights is None
                 else np.asarray(lights, np.float32).reshape(-1)),
                [frame]])
        dev = host.to(device, non_blocking=True, copy=True)
        if done is not None:
            done.record()
        out, at = {}, 0
        for name, width in _COLUMNS:
            out[name] = dev[:, at:at + width]
            at += width
        out["speed"], out["rain"] = out["speed"][:, 0], out["rain"][:, 0]
        out["brightness"] = out["brightness"][:, 0]
        out["frame"] = out["frame"][:, 0].to(torch.int64)
        out["actors"] = out["actors"].reshape(n, ACTOR_SLAB, 9)
        out["lights"] = out["lights"].reshape(n, LIGHT_SLAB, 4)
        return out

    # ---- device side ----

    def _synth(self, cols: dict, vehicle: torch.Tensor, draws: Optional[dict],
               tables: dict) -> dict:
        """Every sensor of a chunk of vehicles (``cols`` sliced to it)."""
        cfg = self.config
        res = 0 if self.birdview else cfg.input_resolution
        if draws is None:
            names = list(draw_layout(res))
            draws = make_draws(self.seed, cols["frame"], vehicle, names, res)
        pose, actors, avalid = cols["pose"], cols["actors"], cols["actors_valid"]
        yaw, rain = pose[:, 2], cols["rain"]
        out = {"map_img": None}
        if self.birdview:
            ppm, target, crop_size = self._raster_meta
            raster = synth_birdview(pose, actors, cols["lights"], tables,
                                    ppm, target, crop_size)
            out["image"] = torch.floor(raster * cols["brightness"][:, None, None, None])
            if self.variant == "img":
                out["map_img"] = raster
        else:
            out["image"] = camera_core(draws["camera"], cols["brightness"])
        out["points"] = lidar_core(draws["ground"], draws["actor"], draws["rain"],
                                   actors, avalid, yaw, rain)
        ego_vel = cols["speed"][:, None] * torch.stack([_cos(yaw), _sin(yaw)], dim=1)
        out["radar"] = radar_core(draws["radar_normal"], draws["radar_uniform"], actors,
                                  avalid, yaw, ego_vel, rain, cfg.radar_points)
        out["lanes"], out["lane_num"] = crop_lanes(pose, tables, cfg.max_lanes)
        return out

    @torch.inference_mode()
    def sensors(self, payloads, draws: Optional[dict] = None, shard: int = 0,
                first: int = 0) -> dict:
        """The fleet's compact payloads -> every synthesized sensor on the
        device, vehicle ``i`` in row ``i``: ``image``, ``points`` (the merged
        sweeps, (V, 3340, 4) [x, y, z, valid]), ``radar``, ``lanes``,
        ``lane_num``, ``map_img`` (None without the img variant), and the
        payloads' ``target_point`` and ``speed``. ``draws`` (name -> (V, ...)
        tensors of :func:`draw_layout`) replaces the hashed draws. ``shard``
        picks the device and ``first`` is the fleet index of the first
        payload, which keys the draws."""
        if not self._tables:
            raise RuntimeError("set_map() must run before dispatch_fleet "
                               "(the agents' map bootstrap does this)")
        n = len(payloads)
        device, tables = self.replicas.devices[shard], self._tables[shard]
        cols = self._upload(payloads, shard)
        vehicle = torch.arange(first, first + n, dtype=torch.int64, device=device)
        chunk = self.synth_chunk or n
        parts = []
        for lo in range(0, n, chunk):
            sl = slice(lo, min(n, lo + chunk))
            parts.append(self._synth(
                {k: v[sl] for k, v in cols.items()}, vehicle[sl],
                None if draws is None else
                {k: torch.as_tensor(v, device=device)[sl] for k, v in draws.items()},
                tables))

        out = {k: None if v is None else torch.cat([p[k] for p in parts])
               for k, v in parts[0].items()}
        out["points"] = out["points"].contiguous()
        out["target_point"], out["speed"] = cols["target_point"], cols["speed"]
        return out

    @torch.inference_mode()
    def synthesize(self, payloads, draws: Optional[dict] = None, shard: int = 0,
                   first: int = 0) -> Batch:
        """The fleet's compact payloads -> the model's input ``Batch`` on the
        device (see :meth:`sensors`)."""
        s = self.sensors(payloads, draws, shard, first)
        # one BEV launch for the whole fleet's clouds
        return Batch(image=s["image"], lidar_bev=lidar_to_histogram_features(s["points"]),
                     map_img=s["map_img"], lanes=s["lanes"], lane_num=s["lane_num"],
                     radar=s["radar"], radar_adj=radar_adjacency(s["radar"]),
                     target_point=s["target_point"], velocity=s["speed"])

    @torch.inference_mode()
    def forward(self, batch: Batch, shard: int = 0) -> torch.Tensor:
        return self.replicas.models[shard](batch)

    # ---- public calls ----

    def dispatch_fleet(self, payloads) -> torch.Tensor:
        """One synthesis and one batched forward over N compact payloads a
        shard; returns the (N, pred_len, 2) tensor on the first device
        without waiting for it."""
        def shard(i, lo, hi, _):
            return self.forward(self.synthesize(payloads[lo:hi], shard=i, first=lo), i)

        return self.replicas.run(len(payloads), shard)

    def dispatch(self, payload) -> torch.Tensor:
        return self.dispatch_fleet([payload])[0]

    def __call__(self, payload) -> np.ndarray:
        return self.dispatch(payload).cpu().numpy()


# --------------------------------------------------------------------------- #
# Host helpers: the world's compact frame
# --------------------------------------------------------------------------- #

def actor_slab_np(actors, ego_xy, slab: int = ACTOR_SLAB):
    """Live scenario actors -> ((slab, 9) world-frame slab, (slab,) sensor
    validity), nearest first when over-full. Columns: [rel_x, rel_y, vel_x,
    vel_y, extent, id%5, yaw, is_walker, vis_graphics]; 0-5 feed the LiDAR
    and radar synthesizers, 6-8 the birdview boxes. ``valid`` is the sensor
    visibility; an actor drawn but not sensed rides with valid 0 and
    vis_graphics 1."""
    out = np.zeros((slab, 9), np.float32)
    valid = np.zeros((slab,), np.float32)
    vis = [a for a in actors if getattr(a, "visible_sensors", True)
           or getattr(a, "visible_graphics", True)]
    if not vis:
        return out, valid
    rel = np.stack([np.asarray(a.position, np.float64) - ego_xy for a in vis])
    order = np.argsort(np.linalg.norm(rel, axis=1))[:slab]
    for k, i in enumerate(order):
        a = vis[i]
        out[k, :2] = rel[i]
        out[k, 2:4] = np.asarray(a.velocity, np.float32)
        out[k, 4] = float(getattr(a, "extent", 1.0))
        out[k, 5] = float(getattr(a, "actor_id", 0) % 5)
        out[k, 6] = float(getattr(a, "yaw", 0.0))
        out[k, 7] = float(getattr(a, "kind", "vehicle") == "walker")
        out[k, 8] = float(getattr(a, "visible_graphics", True))
        valid[k] = float(getattr(a, "visible_sensors", True))
    return out, valid


def light_slab_np(light_states, ego_xy, slab: int = LIGHT_SLAB):
    """``SignalSet.light_states()`` rows [(x, y, state)] -> the (slab, 4)
    [x, y, state_code, valid] world-frame slab, nearest first (an unknown
    state draws red, as the host birdview's default)."""
    out = np.zeros((slab, 4), np.float32)
    if not light_states:
        return out
    rows = sorted(light_states,
                  key=lambda r: (r[0] - ego_xy[0]) ** 2 + (r[1] - ego_xy[1]) ** 2)
    for k, (lx, ly, state) in enumerate(rows[:slab]):
        out[k] = [lx, ly, _LIGHT_CODE.get(state, 2.0), 1.0]
    return out
