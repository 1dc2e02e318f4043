"""Run a user-defined metric over a recorded episode, with mmfn_tpu_torch — the
scenario_runner ``metrics_manager.py`` analog.

The port of ``run_steps/metrics_run.py``, with the same flags and outputs.
The reference's flow (metrics_manager.py:31-120): point it at a CARLA
recorder ``.log`` + a criteria JSON + a metric ``.py``; it loads the
recorded map through a live CARLA server, wraps the log in a MetricsLog and
instantiates the first BasicMetric subclass found in the metric file. Here
the recording is the self-contained JSON that the port's phase0 ``record:``
or ``scenario_run --record`` writes (either package's: the format is one):
the map is vectorized from the embedded OpenDRIVE (no simulator) and the
criteria summary is already inside, so the only required inputs are the log
and the metric. The metric subclasses the port's ``BasicMetric``; the
port's copies of ``examples/metrics/*.py`` are in
``mmfn_tpu_torch/harness/metric_examples/``. Nothing here imports torch.

One flag the JAX CLI lacks: ``--rmap-tool`` (the map tool,
``native/build/rough_map_node`` when absent).

Usage:
    python -m mmfn_tpu_torch.harness.metrics_run --log episode.json \\
        --metric mmfn_tpu_torch/harness/metric_examples/distance_to_lane_center.py \\
        [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--log", required=True,
                    help="episode recording (JSON from --record)")
    ap.add_argument("--metric", required=True,
                    help="path to a .py defining a BasicMetric subclass")
    ap.add_argument("--criteria", default=None,
                    help="optional criteria JSON overriding the recording's")
    ap.add_argument("--out", default=".",
                    help="directory the metric writes its outputs to")
    ap.add_argument("--no-map", action="store_true",
                    help="skip vectorizing the recorded map (town_map=None)")
    ap.add_argument("--rmap-tool", default=None,
                    help="the map tool (default native/build/rough_map_node)")
    args = ap.parse_args(argv)

    from mmfn_tpu_torch.harness.metrics_log import MetricsLog, run_metric
    from mmfn_tpu_torch.harness.recording import EpisodeRecorder

    recording = EpisodeRecorder.load(args.log)
    criteria = None
    if args.criteria:
        with open(args.criteria) as f:
            criteria = json.load(f)

    town_map = None
    if args.no_map:
        recording = dict(recording, opendrive="")
    elif recording.get("opendrive"):
        from mmfn_tpu_torch.mapping import vectorize_xodr

        town_map, _, _ = vectorize_xodr(recording["opendrive"], tool_path=args.rmap_tool,
                                        birdview=False)
    os.makedirs(args.out, exist_ok=True)
    metric = run_metric(args.metric, recording, town_map=town_map,
                        criteria=criteria, out_dir=args.out)
    log = MetricsLog(recording)
    print(f"{type(metric).__name__}: ran over "
          f"{log.get_total_frame_count()} frames "
          f"({log.get_elapsed_time(log.get_total_frame_count() - 1):.1f} s "
          f"sim time); outputs in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
