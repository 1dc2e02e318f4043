"""Record a closed-loop episode as a birdview GIF.

The port of the JAX package's ``scripts/record_episode.py``: runs any agent
type over a route in the fake world (the scored loop phase0 uses) while
rasterizing the privileged ground truth — ego, scenario + NPC actors,
traffic-light states — through the birdview producer every few ticks, then
writes an animated GIF (``data/gif.py``: exact palettes, no PIL). Visual
evidence of the closed loop the way the reference's
``carla_birdeye_view/__main__.py`` previews its masks. The agent is built
by the port's phase0 (``agent.type`` = ``--agent``, the e2e agent as
MMFN-vec with random weights from seed 0 on the CUDA device unless
``--device cpu``).

Usage:
    python -m mmfn_tpu_torch.tools.record_episode --route data/routes/cross_left_turn.xml \\
        --map data/maps/fake_town_cross.xodr --traffic 4 --out docs/img/cross_episode.gif \\
        [--max-ticks N] [--device cpu] [--rmap-tool PATH]
"""

from __future__ import annotations

import argparse
import os
import sys


def record_episode(route: str, map_path=None, agent_type: str = "expert", traffic: int = 0,
                   scenario=None, trigger_s: float = 60.0, every: int = 4, device=None,
                   rmap_tool=None, max_ticks=None):
    """Drive the first route of ``route`` and return (the route record, the
    birdview frames: (H, W, 3) uint8 RGB, one every ``every`` ticks)."""
    from mmfn_tpu_torch.harness.phase0 import FALLBACK_XODR, build_agent
    from mmfn_tpu_torch.harness.replay import ClosedLoopRunner, route_environment
    from mmfn_tpu_torch.harness.route import RouteIndexer
    from mmfn_tpu_torch.harness.scenario_run import _pose_along
    from mmfn_tpu_torch.harness.scenarios import ScenarioTrigger, actor_half_extents
    from mmfn_tpu_torch.mapping import vectorize_xodr
    from mmfn_tpu_torch.mapping.birdview import BirdViewProducer

    map_xodr = FALLBACK_XODR
    if map_path:
        with open(map_path) as f:
            map_xodr = f.read()
    rough_map, producer, _ = vectorize_xodr(map_xodr, tool_path=rmap_tool)

    config = RouteIndexer(route).next()
    signals, background = route_environment(rough_map, config.trajectory, traffic=traffic)
    triggers = None
    if scenario:
        tx, ty, tyaw = _pose_along(config.trajectory, trigger_s)
        triggers = [ScenarioTrigger(x=tx, y=ty, yaw=tyaw, scenario_type=scenario)]

    agent_cfg = {"type": agent_type, "variant": "vec"}
    if rmap_tool:
        agent_cfg["rmap_tool"] = rmap_tool
    agent = build_agent({"agent": agent_cfg, "device": device}, shared={}, route_index=0)
    frames = []
    tick = [0]
    orig_run_step = agent.run_step

    def run_step(input_data, timestamp):
        if "privileged" in input_data and tick[0] % every == 0:
            _, p = input_data["privileged"]
            ex, ey, eyaw, _ = p["ego"]
            boxes, walkers = [], []
            for a in p["actors"]:
                if not a.visible_graphics:
                    continue
                hl, hw = actor_half_extents(a)
                row = (float(a.position[0]), float(a.position[1]),
                       float(a.yaw), 2 * hl, 2 * hw)
                (walkers if a.kind == "walker" else boxes).append(row)
            masks = producer.produce([ex, ey, eyaw], actors=boxes, walkers=walkers,
                                     lights=p["light_states"])
            frames.append(BirdViewProducer.as_rgb(masks))
        tick[0] += 1
        return orig_run_step(input_data, timestamp)

    agent.run_step = run_step
    runner = ClosedLoopRunner(max_wall_seconds=600)
    try:
        record = runner.run_route(agent, config, map_xodr, triggers=triggers,
                                  rough_map=rough_map, signals=signals,
                                  background=background, max_ticks=max_ticks)
    finally:
        agent.destroy()
    return record, frames


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", required=True, help="route XML")
    ap.add_argument("--map", default=None, help="OpenDRIVE map (default: straight road)")
    ap.add_argument("--agent", default="expert")
    ap.add_argument("--traffic", type=int, default=0, help="background NPC vehicles")
    ap.add_argument("--scenario", default=None,
                    help="optional scenario class triggered mid-route")
    ap.add_argument("--trigger-s", type=float, default=60.0)
    ap.add_argument("--every", type=int, default=4,
                    help="render every Nth tick (20 Hz sim -> 5 fps default)")
    ap.add_argument("--out", default="episode.gif")
    ap.add_argument("--max-ticks", type=int, default=None,
                    help="end the route after this many ticks (default: its own end)")
    ap.add_argument("--device", default=None,
                    help="cpu to run a model agent on the CPU; default: the CUDA device")
    ap.add_argument("--rmap-tool", default=None,
                    help="the map tool (default: native/build/rough_map_node)")
    args = ap.parse_args(argv)

    from mmfn_tpu_torch.data import gif
    from mmfn_tpu_torch.harness.result_writer import format_route_record

    record, frames = record_episode(args.route, args.map, args.agent, args.traffic,
                                    args.scenario, args.trigger_s, args.every, args.device,
                                    args.rmap_tool, args.max_ticks)
    print(format_route_record(record, title=f"recorded {record.route_id}"))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    gif.write(args.out, frames, duration_ms=int(args.every * 50))
    print(f"wrote {args.out} ({len(frames)} frames)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
