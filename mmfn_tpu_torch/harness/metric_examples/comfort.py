"""Ride-comfort metric: longitudinal acceleration and jerk percentiles of the
ego over the episode — a standard AV evaluation quantity the reference's
example set does not include (beyond srunner/metrics/examples/; built from
the same MetricsLog surface its metrics use).

The port's own copy of ``examples/metrics/comfort.py``."""

import json
import os

import numpy as np

from mmfn_tpu_torch.harness.metrics_log import BasicMetric


class Comfort(BasicMetric):

    def _create_metric(self, town_map, log, criteria):
        ego = log.get_ego_vehicle_id()
        start, end = log.get_actor_alive_frames(ego)
        vel = log.get_all_actor_velocities(ego, start, end)
        dt = log.get_delta_time(start)

        speed = np.linalg.norm(vel, axis=1)
        accel = np.diff(speed) / dt
        jerk = np.diff(accel) / dt

        def pct(x, q):
            return float(np.percentile(np.abs(x), q)) if len(x) else 0.0

        self.results = {
            "accel_p50_mps2": round(pct(accel, 50), 3),
            "accel_p95_mps2": round(pct(accel, 95), 3),
            "accel_max_mps2": round(float(np.max(np.abs(accel))), 3)
            if len(accel) else 0.0,
            "jerk_p95_mps3": round(pct(jerk, 95), 3),
            "frames": int(len(speed)),
        }
        with open(os.path.join(self.out_dir, "Comfort.json"), "w") as f:
            json.dump(self.results, f, indent=2)
