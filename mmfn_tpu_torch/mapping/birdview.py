"""Bird's-eye-view HD-map rasterizer, without cv2.

Produces the 256x256 @ 8 px/m ego-centric map raster that feeds the MMFN img
variant's map stream and the fake world's birdview camera (the reference
vendors deepsense-ai's carla_birdeye_view,
team_code/expert_agent/common/carla_birdeye_view/). It rasterizes straight
from the vectorized map (the .rmap lanes emitted by native/rough_map_node):

- static layers are drawn once over the whole map: the ROAD mask fills
  variable-width lane polygons from the vectorizer's per-node width column,
  LANES draws the lane-boundary markings, CENTERLINES the centerline
  polylines;
- the mask stack uses the reference's BirdViewMasks order: ROAD, LANES,
  CENTERLINES, VEHICLES, AGENT, GREEN/YELLOW/RED_LIGHTS, PEDESTRIANS;
- static layers cache in memory by content hash and optionally on disk
  (``cache_dir`` or ``MMFN_BIRDVIEW_CACHE``);
- ``produce(pose, actors, walkers, lights)`` crops a rotation-safe square
  around the ego, overlays dynamic masks, rotates heading-up, center-crops;
- ``as_rgb`` applies the reference's palette draw order (bottom to top).

The port's own copy of the JAX package's ``mapping/birdview.py``, which
draws with cv2. The machine that runs the port has no cv2, so the four
drawing calls are rewritten here in numpy after OpenCV's own algorithms, to
its pixels: ``fill_poly`` (``cv2.fillPoly``: the polygon's 8-connected
outline, then an even-odd scanline fill of 16.16 fixed-point edges),
``polyline`` (``cv2.polylines`` at thickness 1: 8-connected Bresenham
segments), ``fill_circle`` (``cv2.circle`` with thickness -1: the midpoint
circle's spans) and ``rotate`` (``cv2.getRotationMatrix2D`` then
``cv2.warpAffine``, bilinear, zero border: coordinates on a 1/32-pixel grid
and 15-bit fixed-point weights). tests/test_torch_harness.py holds each one,
and the whole raster, against cv2.
"""

from __future__ import annotations

import hashlib
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmfn_tpu_torch.mapping.rough_map import RoughMap

LANE_WIDTH_M = 3.5     # fallback for v1 .rmap files without a width column

# mask indices — the reference's BirdViewMasks values (__init__.py:41-50)
ROAD = 0
LANES = 1              # lane-boundary markings
CENTERLINES = 2
VEHICLES = 3
AGENT = 4
GREEN_LIGHTS = 5
YELLOW_LIGHTS = 6
RED_LIGHTS = 7
PEDESTRIANS = 8
N_MASKS = 9

# the reference's RGB_BY_MASK palette (__init__.py:61-71)
_PALETTE = {
    ROAD: (110, 110, 110),          # DIM_GRAY
    LANES: (255, 255, 255),         # WHITE
    CENTERLINES: (209, 92, 0),      # CHOCOLATE
    VEHICLES: (252, 175, 62),       # ORANGE
    AGENT: (138, 226, 52),          # CHAMELEON
    GREEN_LIGHTS: (78, 255, 78),    # GREEN
    YELLOW_LIGHTS: (252, 233, 79),  # YELLOW
    RED_LIGHTS: (255, 78, 78),      # RED
    PEDESTRIANS: (173, 127, 168),   # VIOLET
}
_LIGHT_MASK = {"red": RED_LIGHTS, "yellow": YELLOW_LIGHTS, "green": GREEN_LIGHTS}
LIGHT_RADIUS_M = 1.2

_static_cache: Dict[str, "BirdViewProducer"] = {}

# draw order for as_rgb: bottom to top (reference bottom_to_top())
_BOTTOM_TO_TOP = (ROAD, LANES, CENTERLINES, GREEN_LIGHTS, YELLOW_LIGHTS,
                  RED_LIGHTS, AGENT, VEHICLES, PEDESTRIANS)

# --------------------------------------------------------------------------- #
# OpenCV's drawing primitives (imgproc/src/drawing.cpp), on uint8 2-D masks
# --------------------------------------------------------------------------- #

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """``cv::clipLine`` on a width x height image: the clipped end points
    and whether any part of the segment lies inside."""
    if width <= 0 or height <= 0:
        return False, x1, y1, x2, y2
    right, bottom = width - 1, height - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, value: int) -> None:
    """``cv::line`` at thickness 1, 8-connected (``LineIterator`` walking
    left to right, clipped to the image)."""
    h, w = img.shape
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:                     # left to right
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    step_x, step_y = 1, 1
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    count = dx + 1
    # the minor coordinate advances on the steps where err < 0
    err = dx - 2 * dy
    minor = np.empty(count, np.int64)
    m = 0
    for k in range(count):
        minor[k] = m
        if err < 0:
            m += 1
            err += 2 * dx - 2 * dy
        else:
            err -= 2 * dy
    major = np.arange(count, dtype=np.int64)
    if vert:
        ys, xs = y1 + step_y * major, x1 + step_x * minor
    else:
        xs, ys = x1 + step_x * major, y1 + step_y * minor
    img[ys, xs] = value


def polyline(img: np.ndarray, pts: np.ndarray, value: int = 255) -> None:
    """``cv2.polylines(img, [pts], False, value, 1)`` on integer vertices."""
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    for (x0, y0), (x1, y1) in zip(pts[:-1].tolist(), pts[1:].tolist()):
        _line(img, x0, y0, x1, y1, value)


def fill_poly(img: np.ndarray, pts: np.ndarray, value: int = 255) -> None:
    """``cv2.fillPoly(img, [pts], value)`` on integer vertices: each edge's
    8-connected line, then the even-odd fill of 16.16 fixed-point edges
    (``CollectPolyEdges`` + ``FillEdgeCollection``). Equal to cv2's pixels
    except, for a polygon that leaves the image, on the image's outermost
    rows and columns, where cv2's edge clipping differs; ``produce`` never
    reads those of its crop."""
    h, w = img.shape
    v = np.asarray(pts, np.int64).reshape(-1, 2).tolist()
    n = len(v)
    edges = []                      # [y0, y1, x, dx], x in 16.16 fixed point
    px0, py0 = v[n - 1]
    for px1, py1 in v:
        _line(img, px0, py0, px1, py1, value)
        # an edge that leaves the image starts and ends at its clipped points
        x0c, y0c, x1c, y1c = px0 << XY_SHIFT, py0, px1 << XY_SHIFT, py1
        if not (0 <= px0 < w and 0 <= px1 < w and 0 <= py0 < h and 0 <= py1 < h):
            _, tx0, ty0, tx1, ty1 = _clip_line(w, h, px0, py0, px1, py1)
            if ty0 != ty1:
                x0c, y0c, x1c, y1c = tx0 << XY_SHIFT, ty0, tx1 << XY_SHIFT, ty1
        if py0 != py1:
            num, den = x1c - x0c, y1c - y0c
            dx = abs(num) // abs(den) * (1 if (num < 0) == (den < 0) else -1)
            if py0 < py1:
                edges.append([py0, py1, x0c + (py0 - y0c) * dx, dx])
            else:
                edges.append([py1, py0, x1c + (py1 - y1c) * dx, dx])
        px0, py0 = px1, py1
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    ends = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    if y_max < 0 or y_min >= h or max(ends) < 0 or min(ends) >= (w << XY_SHIFT):
        return
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    total = len(edges)
    i = 0
    active: List[list] = []
    for y in range(edges[0][0], min(y_max, h)):
        # walk the active list in x order, inserting the edges that start
        # on this row and dropping those that end; fill between pairs
        j = 0
        draw = False
        prev = None
        while j < len(active) or (i < total and edges[i][0] == y):
            last = active[j] if j < len(active) else None
            if last is not None and last[1] == y:
                del active[j]
                continue
            keep = prev
            if last is not None and (i >= total or edges[i][0] > y or last[2] < edges[i][2]):
                prev = last
                j += 1
            elif i < total:
                prev = edges[i]
                active.insert(j, prev)
                j += 1
                i += 1
            else:
                break
            if draw:
                if y >= 0:
                    # the pixels from ceil(left) to floor(right)
                    left, right = sorted((keep[2], prev[2]))
                    xa, xb = (left + XY_ONE - 1) >> XY_SHIFT, right >> XY_SHIFT
                    if xa < w and xb >= 0:
                        img[y, max(xa, 0):min(xb, w - 1) + 1] = value
                keep[2] += keep[3]
                prev[2] += prev[3]
            draw = not draw
        active.sort(key=lambda e: e[2])


def fill_circle(img: np.ndarray, cx: int, cy: int, radius: int, value: int = 255) -> None:
    """``cv2.circle(img, (cx, cy), radius, value, -1)``: the spans of the
    midpoint circle, clipped to the image."""
    h, w = img.shape
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, xa, xb in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= y < h and xa < w and xb >= 0:
                img[y, max(xa, 0):min(xb, w - 1) + 1] = value
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _round_half_even(x) -> np.ndarray:
    """``cvRound``: to the nearest integer, ties to even."""
    return np.rint(x).astype(np.int64)


def rotate(src: np.ndarray, center: float, angle_deg: float,
           out_slice: slice) -> np.ndarray:
    """``cv2.warpAffine(src, cv2.getRotationMatrix2D((center, center),
    angle_deg, 1.0), (W, H))`` (bilinear, zero border) of an (H, W, C) uint8
    image, evaluated only on the output rows and columns of ``out_slice``.

    OpenCV inverts the matrix in double, maps each output pixel to a source
    point on a 1/32-pixel grid (10-bit fixed-point steps, rounded half to
    even, then 5 bits down) and blends the four neighbours g with the
    weights W = 32 * (32 - fy or fy) * (32 - fx or fx) as
    (sum g * W + 2**14) >> 15, which equals (32 * top + fy * (bottom - top)
    + 512) >> 10 for the rows' x-blends top and bottom
    (32 * g0 + fx * (g1 - g0), which fit in 16 bits)."""
    a = math.radians(angle_deg)
    alpha, beta = math.cos(a), math.sin(a)
    m = [alpha, beta, (1 - alpha) * center - beta * center,
         -beta, alpha, beta * center + (1 - alpha) * center]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2

    idx = np.arange(out_slice.start, out_slice.stop, dtype=np.float64)
    adelta = _round_half_even(m[0] * idx * 1024)
    bdelta = _round_half_even(m[3] * idx * 1024)
    x0 = _round_half_even((m[1] * idx + m[2]) * 1024) + 16
    y0 = _round_half_even((m[4] * idx + m[5]) * 1024) + 16
    xs = (x0[:, None] + adelta[None, :]) >> 5                    # (rows, cols)
    ys = (y0[:, None] + bdelta[None, :]) >> 5

    h, w, c = src.shape
    pad = np.zeros((h + 4, w + 4, c), np.uint8)
    pad[2:h + 2, 2:w + 2] = src
    flat = pad.reshape(-1, c)
    # a point whose neighbours all lie outside reads the zero border
    i00 = (np.clip(ys >> 5, -2, h) + 2) * (w + 4) + np.clip(xs >> 5, -2, w) + 2
    fx = (xs & 31).astype(np.int16)[..., None]
    fy = (ys & 31).astype(np.int32)[..., None]

    def blend_x(i):
        g0 = np.take(flat, i, axis=0).astype(np.int16)
        g1 = np.take(flat, i + 1, axis=0).astype(np.int16)
        return (g0 * 32 + (g1 - g0) * fx).astype(np.int32)

    top, bottom = blend_x(i00), blend_x(i00 + w + 4)
    return ((top * 32 + (bottom - top) * fy + 512) >> 10).astype(np.uint8)


# --------------------------------------------------------------------------- #
# the producer
# --------------------------------------------------------------------------- #

def _boundaries(xy: np.ndarray, halfw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Left/right lane boundaries of a centerline polyline.

    Per-node unit normals come from the averaged segment directions, so
    consecutive chunks (which share their boundary node) tile seamlessly."""
    d = np.gradient(xy, axis=0)
    norm = np.linalg.norm(d, axis=1, keepdims=True)
    d = d / np.maximum(norm, 1e-9)
    perp = np.stack([-d[:, 1], d[:, 0]], axis=1)
    off = perp * halfw[:, None]
    return xy + off, xy - off


class BirdViewProducer:
    def __init__(self, rough_map: Optional[RoughMap], target_size: int = 256,
                 pixels_per_meter: int = 8, _static=None):
        self.target_size = target_size
        self.ppm = pixels_per_meter
        # rotation-safe intermediate crop (corner distance of the target)
        self.crop_size = int(math.ceil(target_size * math.sqrt(2) / 2) * 2 + 2)

        if _static is not None:   # restored from the on-disk cache
            self.min_xy, self.size_px, self._road, self._lanes_mask, \
                self._center = _static
            return

        pts = np.concatenate([l.nodes[:, :2] for l in rough_map.lanes]) \
            if rough_map.lanes else np.zeros((1, 2))
        margin = 2 * target_size / pixels_per_meter
        self.min_xy = pts.min(axis=0) - margin
        max_xy = pts.max(axis=0) + margin
        self.size_px = np.maximum(
            ((max_xy - self.min_xy) * pixels_per_meter).astype(int) + 1, 64)

        self._road = np.zeros((self.size_px[1], self.size_px[0]), np.uint8)
        self._lanes_mask = np.zeros_like(self._road)
        self._center = np.zeros_like(self._road)
        for lane in rough_map.lanes:
            xy = lane.nodes[:, :2]
            if len(xy) < 2:
                continue
            halfw = (lane.widths / 2.0 if lane.widths is not None
                     else np.full(len(xy), LANE_WIDTH_M / 2.0))
            left, right = _boundaries(xy, halfw)
            ring = np.concatenate([left, right[::-1]], axis=0)
            fill_poly(self._road, self._to_px(ring), 255)
            # boundary markings: thin lines along both lane edges
            polyline(self._lanes_mask, self._to_px(left), 255)
            polyline(self._lanes_mask, self._to_px(right), 255)
            polyline(self._center, self._to_px(xy), 255)

    @classmethod
    def from_opendrive(cls, rmap_path: str,
                       cache_dir: Optional[str] = None,
                       **kw) -> "BirdViewProducer":
        """Build from an .rmap file. Static layers cache in memory by content
        hash; pass ``cache_dir`` (or set MMFN_BIRDVIEW_CACHE) to also persist
        them on disk, like the reference's ~/birdview_v3_cache."""
        cache_dir = cache_dir or os.environ.get("MMFN_BIRDVIEW_CACHE")
        with open(rmap_path, "rb") as f:
            key = hashlib.sha1(f.read()).hexdigest() + str(sorted(kw.items()))
        if key in _static_cache:
            return _static_cache[key]

        producer = None
        disk_path = None
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            disk_path = os.path.join(
                cache_dir, hashlib.sha1(key.encode()).hexdigest() + ".npz")
            if os.path.exists(disk_path):
                z = np.load(disk_path)
                producer = cls(None, _static=(z["min_xy"], z["size_px"],
                                              z["road"], z["lanes_mask"],
                                              z["center"]), **kw)
        if producer is None:
            producer = cls(RoughMap().read(rmap_path), **kw)
            if disk_path is not None:
                np.savez_compressed(
                    disk_path, min_xy=producer.min_xy, size_px=producer.size_px,
                    road=producer._road, lanes_mask=producer._lanes_mask,
                    center=producer._center)
        _static_cache[key] = producer
        return producer

    # ---- coordinates ---------------------------------------------------------- #

    def _to_px(self, xy: np.ndarray) -> np.ndarray:
        px = (np.asarray(xy) - self.min_xy) * self.ppm
        return np.round(px).astype(np.int32)

    # ---- rasterization ---------------------------------------------------------- #

    def produce(self, pose2d: Sequence[float],
                actors: Optional[List[Tuple[float, float, float, float, float]]] = None,
                lights: Optional[List[Tuple[float, float, str]]] = None,
                walkers: Optional[List[Tuple[float, float, float, float, float]]] = None
                ) -> np.ndarray:
        """pose2d [x, y, theta]; actors/walkers: [(x, y, yaw, length, width)];
        lights: [(x, y, state)] with state in red|yellow|green (stop-line
        markers, the reference's 3-state light masks).

        Returns (target_size, target_size, N_MASKS) uint8 masks in
        BirdViewMasks order, ego centered and heading up.
        """
        x, y, theta = pose2d
        half = self.crop_size // 2
        cx, cy = self._to_px(np.array([[x, y]]))[0]

        def crop(canvas: np.ndarray) -> np.ndarray:
            out = np.zeros((self.crop_size, self.crop_size), np.uint8)
            x0, y0 = cx - half, cy - half
            sx0, sy0 = max(0, x0), max(0, y0)
            sx1 = min(canvas.shape[1], x0 + self.crop_size)
            sy1 = min(canvas.shape[0], y0 + self.crop_size)
            if sx1 > sx0 and sy1 > sy0:
                out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = canvas[sy0:sy1, sx0:sx1]
            return out

        # dynamic actors drawn in the crop frame
        def draw_box(mask, ax, ay, ayaw, length, width):
            corners = np.array([[length / 2, width / 2], [length / 2, -width / 2],
                                [-length / 2, -width / 2], [-length / 2, width / 2]])
            c, s = math.cos(ayaw), math.sin(ayaw)
            rot = np.array([[c, -s], [s, c]])
            world = corners @ rot.T + np.array([ax, ay])
            px = (world - np.array([x, y])) * self.ppm + half
            fill_poly(mask, np.round(px).astype(np.int32), 255)

        vehicles = np.zeros((self.crop_size, self.crop_size), np.uint8)
        for (ax, ay, ayaw, length, width) in actors or []:
            draw_box(vehicles, ax, ay, ayaw, length, width)
        peds = np.zeros_like(vehicles)
        for (ax, ay, ayaw, length, width) in walkers or []:
            draw_box(peds, ax, ay, ayaw, length, width)
        ego = np.zeros_like(vehicles)
        draw_box(ego, x, y, theta, 4.9, 2.1)

        light_masks = {GREEN_LIGHTS: np.zeros_like(vehicles),
                       YELLOW_LIGHTS: np.zeros_like(vehicles),
                       RED_LIGHTS: np.zeros_like(vehicles)}
        r_px = max(2, int(LIGHT_RADIUS_M * self.ppm))
        for (lx, ly, state) in lights or []:
            px = (np.array([lx, ly]) - np.array([x, y])) * self.ppm + half
            idx = _LIGHT_MASK.get(state, RED_LIGHTS)
            lx_px, ly_px = np.round(px).astype(int)
            fill_circle(light_masks[idx], int(lx_px), int(ly_px), r_px, 255)

        masks = np.stack(
            [crop(self._road), crop(self._lanes_mask), crop(self._center),
             vehicles, ego, light_masks[GREEN_LIGHTS],
             light_masks[YELLOW_LIGHTS], light_masks[RED_LIGHTS], peds],
            axis=-1)

        # rotate so the ego heading points up, keeping the center crop
        angle_deg = math.degrees(theta) + 90.0
        off = (self.crop_size - self.target_size) // 2
        return rotate(masks, half, angle_deg, slice(off, off + self.target_size))

    @staticmethod
    def as_rgb(masks: np.ndarray) -> np.ndarray:
        rgb = np.zeros(masks.shape[:2] + (3,), np.uint8)
        for idx in _BOTTOM_TO_TOP:         # later layers draw on top
            if idx < masks.shape[-1]:
                rgb[masks[..., idx] > 0] = _PALETTE[idx]
        return rgb
