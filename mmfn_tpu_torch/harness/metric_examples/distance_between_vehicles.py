"""Ego-to-adversary distance per frame — the recorder-usage example metric
(reference srunner/metrics/examples/distance_between_vehicles.py:23-75, minus
the matplotlib popup: results go to JSON under ``out_dir``).

The port's own copy of ``examples/metrics/distance_between_vehicles.py``."""

import json
import os

import numpy as np

from mmfn_tpu_torch.harness.metrics_log import BasicMetric


class DistanceBetweenVehicles(BasicMetric):

    def _create_metric(self, town_map, log, criteria):
        ego_id = log.get_ego_vehicle_id()
        adv_id = log.get_actor_ids_with_role_name("scenario")[0]

        start_e, end_e = log.get_actor_alive_frames(ego_id)
        start_a, end_a = log.get_actor_alive_frames(adv_id)
        start, end = max(start_e, start_a), min(end_e, end_a)

        ego = log.get_all_actor_transforms(ego_id, start, end)[:, :2]
        adv = log.get_all_actor_transforms(adv_id, start, end)[:, :2]
        n = min(len(ego), len(adv))
        dist = np.linalg.norm(ego[:n] - adv[:n], axis=1)
        valid = ~np.isnan(dist)

        self.frames = (start + np.nonzero(valid)[0]).tolist()
        self.distances = dist[valid].round(3).tolist()
        with open(os.path.join(self.out_dir,
                               "DistanceBetweenVehicles.json"), "w") as f:
            json.dump({"frames": self.frames, "distance_m": self.distances},
                      f)
