"""Terminal result tables (leaderboard/leaderboard/utils/result_writer.py:19).

Renders one route's record — status, scores, per-infraction counts — as an
ASCII table, and a compact summary table for a whole run.

The port's own copy of the JAX package's ``harness/result_writer.py``.
"""

from __future__ import annotations

from typing import Sequence

from mmfn_tpu_torch.harness.statistics import RouteRecord

_INFRACTION_LABELS = {
    "collisions_pedestrian": "Collisions with pedestrians",
    "collisions_vehicle": "Collisions with vehicles",
    "collisions_layout": "Collisions with layout",
    "red_light": "Red lights infractions",
    "stop_infraction": "Stop sign infractions",
    "outside_route_lanes": "Off-road infractions",
    "route_dev": "Route deviations",
    "route_timeout": "Route timeouts",
    "vehicle_blocked": "Agent blocked",
}


def _table(rows: Sequence[Sequence[str]], header: Sequence[str]) -> str:
    widths = [max(len(str(r[i])) for r in [header, *rows]) for i in range(len(header))]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def fmt(row):
        return "| " + " | ".join(str(c).ljust(w) for c, w in zip(row, widths)) + " |"

    lines = [sep, fmt(header), sep] + [fmt(r) for r in rows] + [sep]
    return "\n".join(lines)


def format_route_record(record: RouteRecord, title: str = "Route results") -> str:
    rows = [
        ["Start time / status", record.status],
        ["Driving score", f"{record.scores['score_composed']:.3f}"],
        ["Route completion", f"{record.scores['score_route']:.3f}"],
        ["Infraction penalty", f"{record.scores['score_penalty']:.3f}"],
    ]
    for key, label in _INFRACTION_LABELS.items():
        value = record.infractions.get(key, [])
        count = len(value) if isinstance(value, list) else value
        rows.append([label, f"{count}"])
    return _table(rows, [title, f"route {record.route_id}"])


def format_global_summary(records: Sequence[RouteRecord]) -> str:
    rows = [[r.route_id, r.status, f"{r.scores['score_composed']:.1f}",
             f"{r.scores['score_route']:.1f}", f"{r.scores['score_penalty']:.2f}"]
            for r in records]
    return _table(rows, ["route", "status", "score", "completion", "penalty"])
