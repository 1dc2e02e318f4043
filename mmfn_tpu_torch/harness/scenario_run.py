"""Standalone scenario runner — srunner's ``scenario_runner.py`` analog, with mmfn_tpu_torch.

The port of ``run_steps/scenario_run.py``, with the same flags and outputs.
srunner's standalone entry runs ONE named scenario class (or an
OpenSCENARIO file) outside the leaderboard route loop
(scenario_runner/scenario_runner.py:46-500, CLI at :503-541). This is the
fake-world equivalent: it places the named behavior's trigger on a straight
route — or ``--trigger-s`` meters along a ``--route`` XML over a ``--map``
OpenDRIVE world — drives the chosen agent through the same scored closed
loop the port's phase0 uses (signals and optional ``--traffic`` NPCs
derived the same way), and writes stdout / txt / JUnit results.

Two flags the JAX runner lacks: ``--device`` (where a model agent serves;
default the CUDA device, and the run raises when there is none) and
``--rmap-tool`` (the map tool, ``native/build/rough_map_node`` when absent).

Examples:
    python -m mmfn_tpu_torch.harness.scenario_run --list
    python -m mmfn_tpu_torch.harness.scenario_run --scenario CutInFromLeftLane
    python -m mmfn_tpu_torch.harness.scenario_run --scenario Scenario3 --agent npc \\
        --repetitions 3 --randomize --junit /tmp/s3.xml
    python -m mmfn_tpu_torch.harness.scenario_run \\
        --openscenario data/scenarios/cut_in_with_controller.xosc
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
import xml.etree.ElementTree as ET

import numpy as np


def list_scenarios() -> str:
    from mmfn_tpu_torch.harness.scenarios import SCENARIO_CLASSES

    lines = ["supported scenarios (harness/scenarios.py; srunner sources in"
             " each class docstring):"]
    for name, cls in SCENARIO_CLASSES.items():
        doc = (cls.__doc__ or "").strip().splitlines()[0]
        lines.append(f"  {name:36s} {cls.__name__:24s} {doc}")
    return "\n".join(lines)


def _pose_along(trajectory, s: float):
    """(x, y, yaw) at arclength ``s`` along a route's keypoint polyline."""
    if len(trajectory) < 2:
        raise ValueError("route needs >= 2 waypoints")
    acc = 0.0
    for (x0, y0, *_), (x1, y1, *_) in zip(trajectory, trajectory[1:]):
        seg = math.hypot(x1 - x0, y1 - y0)
        if acc + seg >= s and seg > 0:
            f = (s - acc) / seg
            return (x0 + f * (x1 - x0), y0 + f * (y1 - y0),
                    math.atan2(y1 - y0, x1 - x0))
        acc += seg
    x0, y0 = trajectory[-2][:2]
    x1, y1 = trajectory[-1][:2]
    return (x1, y1, math.atan2(y1 - y0, x1 - x0))


def _junit(path: str, scenario: str, records, elapsed: float) -> None:
    """Minimal JUnit XML, one testcase per repetition (srunner --junit)."""
    failures = sum(1 for r in records if not r.status.startswith("Completed"))
    suite = ET.Element("testsuite", name=scenario, tests=str(len(records)),
                       failures=str(failures), time=f"{elapsed:.2f}")
    for i, r in enumerate(records):
        case = ET.SubElement(suite, "testcase", classname=scenario,
                             name=f"repetition_{i}",
                             time=f"{r.meta.get('duration_game', 0.0):.2f}")
        if not r.status.startswith("Completed"):
            fail = ET.SubElement(case, "failure", message=r.status)
            fail.text = "; ".join(
                f"{k}: {len(v)}" for k, v in r.infractions.items() if v)
        sc = ET.SubElement(case, "system-out")
        sc.text = (f"score_composed={r.scores['score_composed']:.2f} "
                   f"route_completion={r.scores['score_route']:.2f}")
    ET.ElementTree(suite).write(path, encoding="unicode",
                                xml_declaration=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--scenario", help="scenario class name (see --list)")
    ap.add_argument("--openscenario", help="OpenSCENARIO .xosc file")
    ap.add_argument("--list", action="store_true",
                    help="list supported scenarios and exit")
    ap.add_argument("--agent", default="expert",
                    help="agent type: expert | auto | npc | e2e | aim | "
                         "cilrs | transfuser (default expert)")
    ap.add_argument("--repetitions", type=int, default=1)
    ap.add_argument("--randomize", action="store_true",
                    help="jitter the trigger position per repetition "
                         "(srunner --randomize)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--map", default=None,
                    help="OpenDRIVE file for the fake world (default: "
                         "straight road)")
    ap.add_argument("--route", default=None,
                    help="route XML to drive instead of the synthesized "
                         "straight route; the trigger lands --trigger-s "
                         "meters along it (srunner --route analog)")
    ap.add_argument("--trigger-s", type=float, default=40.0,
                    help="trigger arclength along the route (m)")
    ap.add_argument("--route-length", type=float, default=150.0)
    ap.add_argument("--output", default=None,
                    help="also write the result table to this txt file")
    ap.add_argument("--junit", default=None, help="write JUnit XML here")
    ap.add_argument("--record", default=None,
                    help="record each repetition's ground truth for post-hoc "
                         "metrics (srunner --record analog): writes "
                         "<record>_rep<N>.json consumable by "
                         "python -m mmfn_tpu_torch.harness.metrics_run")
    ap.add_argument("--weather", default=None,
                    help="fake-world weather preset (default ClearNoon; an "
                         ".xosc EnvironmentAction overrides it)")
    ap.add_argument("--weather-animation", type=float, default=0.0,
                    metavar="SCALE",
                    help="animate the sun over game time (srunner "
                         "weather_sim analog): SCALE = weather-clock seconds "
                         "per sim second (1 = real-time like the reference; "
                         "0 = static)")
    ap.add_argument("--weather-start-hour", type=float, default=11.0,
                    help="local solar hour at route start (with "
                         "--weather-animation)")
    ap.add_argument("--traffic", type=int, default=0,
                    help="ambient background NPC vehicles")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="wall-clock budget per repetition (s)")
    ap.add_argument("--device", default=None,
                    help="where a model agent serves (default: the CUDA "
                         "device; cpu runs it on the CPU)")
    ap.add_argument("--rmap-tool", default=None,
                    help="the map tool (default native/build/rough_map_node)")
    args = ap.parse_args(argv)

    if args.list:
        print(list_scenarios())
        return 0
    if not args.scenario and not args.openscenario:
        ap.error("one of --scenario / --openscenario / --list is required")

    from mmfn_tpu_torch.harness.phase0 import FALLBACK_XODR, build_agent
    from mmfn_tpu_torch.harness.replay import ClosedLoopRunner, route_environment
    from mmfn_tpu_torch.harness.result_writer import (format_global_summary,
                                                      format_route_record)
    from mmfn_tpu_torch.harness.route import RouteConfig
    from mmfn_tpu_torch.harness.scenarios import SCENARIO_CLASSES, ScenarioTrigger
    from mmfn_tpu_torch.harness.statistics import StatisticsManager

    if args.scenario and args.scenario not in SCENARIO_CLASSES:
        raise SystemExit(f"unknown scenario '{args.scenario}' — run --list "
                         f"({len(SCENARIO_CLASSES)} supported)")

    map_xodr = FALLBACK_XODR
    if args.map:
        with open(args.map) as f:
            map_xodr = f.read()
    rough_map = None
    try:
        from mmfn_tpu_torch.mapping import vectorize_xodr

        rough_map, _, _ = vectorize_xodr(map_xodr, tool_path=args.rmap_tool)
    except Exception:
        # an explicitly passed map MUST vectorize — otherwise the lane
        # penalty silently vanishes and scores stop being comparable
        # (same policy as phase0)
        if args.map:
            raise
        print("warning: map vectorization failed; lane penalty off")

    xcfg = None
    town = None
    if args.openscenario:
        from mmfn_tpu_torch.harness.openscenario import hero_trajectory, parse_xosc

        xcfg = parse_xosc(args.openscenario, rough_map=rough_map)
        trajectory = [(x, y, 0.0) for x, y in hero_trajectory(xcfg, rough_map)]
        town = xcfg.town
        name = os.path.splitext(os.path.basename(args.openscenario))[0]
    elif args.route:
        from mmfn_tpu_torch.harness.route import RouteIndexer

        rcfg = RouteIndexer(args.route).next()
        trajectory, town = rcfg.trajectory, rcfg.town
        name = args.scenario
    else:
        trajectory = [(0.0, 1.75, 0.0), (args.route_length, 1.75, 0.0)]
        name = args.scenario

    if len(trajectory) < 2:
        raise SystemExit("route needs >= 2 waypoints")

    weather = (xcfg.weather if xcfg and xcfg.weather
               else args.weather) or "ClearNoon"
    weather_sim = None
    if args.weather_animation:
        from mmfn_tpu_torch.harness.weather import WeatherSim

        weather_sim = WeatherSim(preset=weather,
                                 time_scale=args.weather_animation,
                                 start_hour=args.weather_start_hour)
    rng = np.random.default_rng(args.seed)
    statistics = StatisticsManager()
    runner = ClosedLoopRunner(statistics, max_wall_seconds=args.timeout)
    agent_cfg = {"agent": {"type": args.agent, "variant": "vec",
                           "rmap_tool": args.rmap_tool},
                 "device": args.device}
    shared = {}   # keeps a model agent's pipeline across repetitions

    records = []
    t0 = time.time()
    for rep in range(args.repetitions):
        # signals + optional NPC traffic, same assembly as phase0 — scores
        # on a signalized map stay comparable between the two entry points
        signals, background = route_environment(rough_map, trajectory,
                                                traffic=args.traffic,
                                                seed=rep)
        triggers = None
        scenario_manager = None
        title = f"{name} rep {rep}"
        if xcfg is not None:
            from mmfn_tpu_torch.harness.openscenario import OpenScenarioManager

            # fresh manager per repetition (fired-state lives on it)
            scenario_manager = OpenScenarioManager(xcfg)
        else:
            s = args.trigger_s
            if args.randomize:      # srunner --randomize analog
                s = max(15.0, s + float(rng.uniform(-10.0, 10.0)))
            tx, ty, tyaw = _pose_along(trajectory, s)
            triggers = [ScenarioTrigger(x=tx, y=ty, yaw=tyaw,
                                        scenario_type=args.scenario)]
            title += f" (trigger s={s:.1f})"
        config = RouteConfig(route_id=f"{name}_{rep}",
                             town=town or "ScenarioWorld",
                             trajectory=trajectory, index=rep)
        agent = build_agent(agent_cfg, shared=shared, route_index=rep)
        recorder = None
        if args.record:
            from mmfn_tpu_torch.harness.recording import EpisodeRecorder

            recorder = EpisodeRecorder()
        try:
            record = runner.run_route(agent, config, map_xodr,
                                      triggers=triggers,
                                      rough_map=rough_map,
                                      signals=signals,
                                      background=background,
                                      scenario_manager=scenario_manager,
                                      world_kwargs={"weather": weather},
                                      recorder=recorder,
                                      weather_sim=weather_sim)
        finally:
            agent.destroy()
        if recorder is not None:
            base, ext = os.path.splitext(args.record)
            rec_path = f"{base}_rep{rep}{ext or '.json'}"
            recorder.save(rec_path)
            print(f"recording written to {rec_path}")
        records.append(record)
        print(format_route_record(record, title=title))
    elapsed = time.time() - t0

    summary = format_global_summary(records)
    print(summary)
    if args.output:
        with open(args.output, "w") as f:
            f.write(summary + "\n")
    if args.junit:
        _junit(args.junit, name, records, elapsed)
        print(f"junit written to {args.junit}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
