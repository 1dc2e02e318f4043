"""Hazard geometry for the rule-based experts.

The port's own copy of the JAX package's ``control/geometry.py``, after
the reference's team_code/expert_agent/common/utils.py:30-122: the
time-to-collision estimates and the segment intersection of the expert's
brake logic. Pure numpy, on the host.
"""

from __future__ import annotations

import math

import numpy as np

MAX_TTC = 999.0


def segment_intersection(p1, v1, p2, v2):
    """Do segments p1+t*v1 and p2+s*v2 (t,s in [0,1]) intersect?

    Returns (collides, point_or_None). Reference get_collision (utils.py:30-40).
    """
    a = np.stack([v1, -v2], 1)
    b = p2 - p1
    if abs(np.linalg.det(a)) < 1e-3:
        return False, None
    x = np.linalg.solve(a, b)
    collides = bool(np.all(x >= 0) and np.all(x <= 1))
    return collides, p1 + x[0] * v1


def ttc_projection(pa, pb, va, vb, close_dis: float) -> float:
    """TTC via relative-velocity projection with a lateral-miss gate.

    Reference TTC_Time (utils.py:42-61): infinite when diverging, when the
    relative speed is negligible, or when the closest-approach lateral offset
    exceeds ``close_dis``.
    """
    rv = va - vb
    rp = pb - pa
    if rp.dot(rv) < 0.0:
        return MAX_TTC
    if np.linalg.norm(rv) < 1e-4:
        return MAX_TTC
    rv_proj_rp = rp * rp.dot(rv) / rp.dot(rp)
    rp_proj_rv = rv * rv.dot(rp) / rv.dot(rv)
    lateral_miss = np.linalg.norm(rp - rp_proj_rv)
    if lateral_miss > close_dis:
        return MAX_TTC
    return float(np.linalg.norm(rp) / np.linalg.norm(rv_proj_rp))


def ttc_disc(pa, pb, va, vb, ra: float = 1.5, rb: float = 1.5) -> float:
    """Disc-collision quadratic TTC (reference TTC_Judge, utils.py:63-91)."""
    p = pb - pa
    rv = vb - va
    a = rv.dot(rv)
    b = 2 * rv.dot(p)
    c = p.dot(p) - (ra + rb) ** 2
    det = b * b - 4 * a * c
    t1 = t2 = MAX_TTC
    if det > 0:
        t1 = (-b + math.sqrt(det)) / (2 * a)
        t2 = (-b - math.sqrt(det)) / (2 * a)
    t = min(t1, t2)
    if t < 0 and max(t1, t2) > 0:
        t = 0.0  # already overlapping
    if t < 0 or t > MAX_TTC:
        t = MAX_TTC
    return float(t)


def predicted_min_distance(pa, pb, va, vb, horizon: float) -> float:
    """Closest approach of two constant-velocity points within ``horizon`` s.

    Closed form: t* = clamp(-(p.rv)/(rv.rv), 0, horizon), d = |p + rv t*|.
    Monotonically informative while converging (unlike threshold TTC, which
    flickers near tangent geometries) — used by the expert's hazard gates.
    """
    p = np.asarray(pb, dtype=np.float64) - np.asarray(pa, dtype=np.float64)
    rv = np.asarray(vb, dtype=np.float64) - np.asarray(va, dtype=np.float64)
    denom = float(rv.dot(rv))
    t_star = 0.0 if denom < 1e-9 else float(np.clip(-p.dot(rv) / denom, 0.0, horizon))
    return float(np.linalg.norm(p + rv * t_star))


def heading_angle_deg(o1, o2) -> float:
    """Unsigned angle between two unit headings, in degrees (utils.py:93-96)."""
    angle = float(np.degrees(np.arccos(np.clip(o1.dot(o2), -1.0, 1.0))))
    return min(angle, 360.0 - angle)
