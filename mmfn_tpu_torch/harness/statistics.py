"""Driving-score computation and checkpointed route records.

Scoring contract (leaderboard/leaderboard/utils/statistics_manager.py):
- per route: score_composed = score_route% x PRODUCT(infraction penalties),
  with fixed penalty factors (pedestrian 0.50, vehicle 0.60, static 0.65,
  red light 0.70, stop 0.80) and the outside-lanes percentage discount;
- globally: mean scores over routes, infractions normalized per driven km,
  sample std-dev across routes;
- records persist to a JSON checkpoint with resume support (route_indexer
  reads '_checkpoint.progress').

This implementation is event-driven: criteria (live CARLA or offline replay)
hand a list of TrafficEvents per route instead of a py_trees scenario object.

The port's own copy of the JAX package's ``harness/statistics.py``: the
same records and the same checkpoint JSON, so a results file of either
package reads in the other.
"""

from __future__ import annotations

import json
import math
import os
from typing import Iterable, List, Optional, Sequence

from mmfn_tpu_torch.harness.events import TrafficEvent, TrafficEventType

PENALTY_COLLISION_PEDESTRIAN = 0.50
PENALTY_COLLISION_VEHICLE = 0.60
PENALTY_COLLISION_STATIC = 0.65
PENALTY_TRAFFIC_LIGHT = 0.70
PENALTY_STOP = 0.80

_INFRACTION_KEYS = (
    "collisions_pedestrian", "collisions_vehicle", "collisions_layout",
    "red_light", "stop_infraction", "outside_route_lanes", "route_dev",
    "route_timeout", "vehicle_blocked",
)


class RouteRecord:
    def __init__(self):
        self.route_id = None
        self.index = None
        self.status = "Started"
        self.infractions = {k: [] for k in _INFRACTION_KEYS}
        self.scores = {"score_route": 0, "score_penalty": 0, "score_composed": 0}
        self.meta = {}

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    @classmethod
    def from_dict(cls, d: dict) -> "RouteRecord":
        record = cls()
        for k, v in d.items():
            setattr(record, k, v)
        return record


def default_checkpoint() -> dict:
    return {
        "_checkpoint": {"progress": [], "records": [], "global_record": {}},
        "values": [], "labels": [], "sensors": [],
        "entry_status": "Started", "eligible": False,
    }


def fetch_checkpoint(endpoint: str) -> Optional[dict]:
    if not os.path.exists(endpoint) or os.path.getsize(endpoint) == 0:
        return None
    with open(endpoint) as f:
        return json.load(f)


def save_checkpoint(endpoint: str, data: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(endpoint)), exist_ok=True)
    with open(endpoint, "w") as f:
        json.dump(data, f, indent=2)


class StatisticsManager:
    def __init__(self):
        self._records: List[RouteRecord] = []

    # ---- lifecycle ------------------------------------------------------- #

    def resume(self, endpoint: str) -> None:
        data = fetch_checkpoint(endpoint)
        if data and data.get("_checkpoint", {}).get("records"):
            self._records = [RouteRecord.from_dict(r)
                             for r in data["_checkpoint"]["records"]]

    def set_route(self, route_id, index: int) -> None:
        record = RouteRecord()
        record.route_id = route_id
        record.index = index
        if index < len(self._records):
            self._records[index] = record
        else:
            self._records.append(record)

    # ---- scoring ---------------------------------------------------------- #

    def compute_route_statistics(self, index: int, route_length_m: float,
                                 events: Iterable[TrafficEvent],
                                 duration_time_system: float = -1,
                                 duration_time_game: float = -1,
                                 timed_out: bool = False,
                                 failure: str = "") -> RouteRecord:
        if not self._records or index >= len(self._records):
            raise RuntimeError("route registry has no record for this index")
        record = self._records[index]

        target_reached = False
        score_penalty = 1.0
        score_route = 0.0
        record.meta["duration_system"] = duration_time_system
        record.meta["duration_game"] = duration_time_game
        record.meta["route_length"] = route_length_m

        if timed_out:
            record.infractions["route_timeout"].append("Route timeout.")
            failure = "Agent timed out"

        for event in events:
            etype = event.get_type()
            if etype == TrafficEventType.COLLISION_STATIC:
                score_penalty *= PENALTY_COLLISION_STATIC
                record.infractions["collisions_layout"].append(event.get_message())
            elif etype == TrafficEventType.COLLISION_PEDESTRIAN:
                score_penalty *= PENALTY_COLLISION_PEDESTRIAN
                record.infractions["collisions_pedestrian"].append(event.get_message())
            elif etype == TrafficEventType.COLLISION_VEHICLE:
                score_penalty *= PENALTY_COLLISION_VEHICLE
                record.infractions["collisions_vehicle"].append(event.get_message())
            elif etype == TrafficEventType.OUTSIDE_ROUTE_LANES_INFRACTION:
                score_penalty *= (1 - event.get_dict()["percentage"] / 100)
                record.infractions["outside_route_lanes"].append(event.get_message())
            elif etype == TrafficEventType.TRAFFIC_LIGHT_INFRACTION:
                score_penalty *= PENALTY_TRAFFIC_LIGHT
                record.infractions["red_light"].append(event.get_message())
            elif etype == TrafficEventType.ROUTE_DEVIATION:
                record.infractions["route_dev"].append(event.get_message())
                failure = "Agent deviated from the route"
            elif etype == TrafficEventType.STOP_INFRACTION:
                score_penalty *= PENALTY_STOP
                record.infractions["stop_infraction"].append(event.get_message())
            elif etype == TrafficEventType.VEHICLE_BLOCKED:
                record.infractions["vehicle_blocked"].append(event.get_message())
                failure = "Agent got blocked"
            elif etype == TrafficEventType.ROUTE_COMPLETED:
                score_route = 100.0
                target_reached = True
            elif etype == TrafficEventType.ROUTE_COMPLETION:
                if not target_reached:
                    d = event.get_dict()
                    score_route = d["route_completed"] if d else 0

        record.scores["score_route"] = score_route
        record.scores["score_penalty"] = score_penalty
        record.scores["score_composed"] = max(score_route * score_penalty, 0.0)
        record.status = "Completed" if target_reached else (
            "Failed" + (" - " + failure if failure else ""))
        return record

    def compute_global_statistics(self, total_routes: int) -> RouteRecord:
        g = RouteRecord()
        g.route_id = -1
        g.index = -1
        g.status = "Completed"
        g.scores_std_dev = RouteRecord().scores
        g.infractions = {k: 0.0 for k in _INFRACTION_KEYS}

        for record in self._records:
            for key in g.scores:
                g.scores[key] += record.scores[key]
            driven_km = max(
                record.scores["score_route"] / 100
                * record.meta.get("route_length", 0) / 1000.0, 0.001)
            for key in _INFRACTION_KEYS:
                g.infractions[key] += len(record.infractions[key]) / driven_km
            if record.status != "Completed":
                g.status = "Failed"
                g.meta.setdefault("exceptions", []).append(
                    (record.route_id, record.index, record.status))

        if self._records:
            for key in g.scores:
                g.scores[key] /= float(total_routes)
            if total_routes == 1:
                g.scores_std_dev = {k: "NaN" for k in g.scores_std_dev}
            else:
                for record in self._records:
                    for key in g.scores_std_dev:
                        g.scores_std_dev[key] += (record.scores[key] - g.scores[key]) ** 2
                for key in g.scores_std_dev:
                    g.scores_std_dev[key] = math.sqrt(
                        g.scores_std_dev[key] / float(total_routes - 1))
        return g

    # ---- persistence ------------------------------------------------------ #

    def save_record(self, record: RouteRecord, index: int, endpoint: str) -> None:
        data = fetch_checkpoint(endpoint) or default_checkpoint()
        if "_checkpoint" not in data:
            # endpoint points at a foreign JSON (e.g. a leftover scenario
            # file): start a fresh checkpoint rather than KeyError-crashing
            data = default_checkpoint()
        records = data["_checkpoint"]["records"]
        if index > len(records):
            raise RuntimeError("non-contiguous record index")
        if index == len(records):
            records.append(record.to_dict())
        else:
            records[index] = record.to_dict()
        save_checkpoint(endpoint, data)

    def save_progress(self, route_index: int, total_routes: int, endpoint: str) -> None:
        data = fetch_checkpoint(endpoint) or default_checkpoint()
        data["_checkpoint"]["progress"] = [route_index, total_routes]
        save_checkpoint(endpoint, data)

    def save_global_record(self, g: RouteRecord, total_routes: int, endpoint: str) -> None:
        data = fetch_checkpoint(endpoint) or default_checkpoint()
        data["_checkpoint"]["global_record"] = g.to_dict()
        data["values"] = (
            ["{:.3f}".format(g.scores[k]) for k in
             ("score_composed", "score_route", "score_penalty")]
            + ["{:.3f}".format(g.infractions[k]) for k in _INFRACTION_KEYS])
        data["labels"] = [
            "Avg. driving score", "Avg. route completion", "Avg. infraction penalty",
            "Collisions with pedestrians", "Collisions with vehicles",
            "Collisions with layout", "Red lights infractions",
            "Stop sign infractions", "Off-road infractions", "Route deviations",
            "Route timeouts", "Agent blocked"]
        records = data["_checkpoint"]["records"]
        progress = data["_checkpoint"]["progress"]
        entry_status, eligible = "Finished", True
        if len(records) != total_routes or (progress and progress[0] != progress[1]):
            entry_status, eligible = "Finished with missing data", False
        else:
            for route in records:
                if "Agent" in route["status"]:
                    entry_status = "Finished with agent errors"
                    break
        data["entry_status"] = entry_status
        data["eligible"] = eligible
        save_checkpoint(endpoint, data)

    @property
    def records(self) -> Sequence[RouteRecord]:
        return tuple(self._records)
