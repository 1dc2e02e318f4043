"""phase0: closed-loop evaluation of a route set in the fake world, with mmfn_tpu_torch.

The port of ``run_steps/phase0_run_eval.py``: the same config file
(``run_steps/config/eval.yaml``) and the same ``key=value`` overrides. It
iterates routes with resume, drives each through the kinematic fake world
(``harness/replay.py``), scores it, and writes the leaderboard-format
checkpoint JSON (``harness/statistics.py``), which either package reads.

Supported: ``routes``, ``map``, ``scenarios`` (JSON triggers), ``signals``,
``repetitions``, ``fleet`` (``harness/fleet.py``; ``agent.async_dispatch``
selects the pipelined fleet), ``weather`` presets and a route's own
``<weather>``, ``max_ticks``, ``max_wall_seconds``, ``resume`` /
``checkpoint``; ``agent.type`` e2e (``agent.variant`` vec | rad | img), npc,
aim, cilrs and transfuser; ``agent.n_layer``, ``agent.n_embd``,
``agent.n_head``, ``agent.attn_impl`` and ``agent.max_lanes``;
``agent.model_path``, a directory holding the port's ``best_model.pth``
(``train/engine.py``; random weights from seed 0 without one);
``agent.rmap_tool``, the map tool's path for the world's map and the agent's
(``native/build/rough_map_node`` when absent). One key the JAX CLI lacks:
``device`` (default: the CUDA device, and the run raises when there is none;
``device=cpu`` runs the model on the CPU). A model agent serves its forward
through ``TorchPipeline`` with ``host_bev`` off, so on the GPU each forward
launches the BEV kernel (unless ``agent.host_bev=true``), and with
``agent.attn_impl=pallas`` the attention kernel too. ``agent.device_world``
serves it through ``DeviceWorldPipeline`` instead, in a world that ships
compact ``world_state`` frames (``compact_sensors``): every sensor is
synthesized on the device, and each forward launches the BEV kernel once
for the whole batch.

Not ported yet, and refused, naming the ROADMAP item: ``simulator: carla``,
``.xosc`` routes, ``background_traffic`` > 0, ``weather_animation``,
``record``, ``collect_offsets`` with the expert, ``agent.type`` expert, auto
or remote (queue 1 item 2, the rest of the harness); ``agent.fleet_devices``
> 1 (item 4, multi-process).

Usage:
    python -m mmfn_tpu_torch.harness.phase0 --config run_steps/config/eval.yaml \\
        [agent.type=npc agent.variant=rad routes=path.xml device=cpu ...]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.device import resolve_device
from mmfn_tpu_torch.utils.cli import load_config
from mmfn_tpu_torch.utils.logging import bcolors as bc

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "run_steps", "config", "eval.yaml")
SEED = 0

FALLBACK_XODR = """<?xml version="1.0" standalone="yes"?>
<OpenDRIVE><header revMajor="1" revMinor="4" name="line"/>
<road name="R0" length="1000.0" id="0" junction="-1">
<planView><geometry s="0.0" x="-500.0" y="0.0" hdg="0.0" length="1000.0"><line/></geometry></planView>
<lanes><laneSection s="0.0"><center><lane id="0" type="none" level="false"/></center>
<right><lane id="-1" type="driving" level="false"><width sOffset="0.0" a="3.5" b="0.0" c="0.0" d="0.0"/></lane></right>
</laneSection></lanes></road></OpenDRIVE>
"""


def _refuse_unported(cfg) -> None:
    agent = cfg.get("agent") or {}
    item2 = "is not ported to mmfn_tpu_torch yet (ROADMAP queue 1 item 2, the rest of the harness)"
    if cfg.get("simulator", "fake") == "carla":
        raise NotImplementedError(f"simulator: carla: the CARLA glue {item2}")
    if str(cfg.get("routes", "")).endswith(".xosc"):
        raise NotImplementedError(f".xosc routes: OpenSCENARIO {item2}")
    if int(cfg.get("background_traffic", 0)) > 0:
        raise NotImplementedError(f"background_traffic > 0: npc_traffic {item2}")
    if cfg.get("weather_animation"):
        raise NotImplementedError(f"weather_animation: WeatherSim {item2}")
    if cfg.get("record"):
        raise NotImplementedError(f"record: the episode recorder {item2}")
    if cfg.get("collect_offsets") and agent.get("type") in ("expert", "auto"):
        raise NotImplementedError(f"collect_offsets: expert data collection {item2}")
    if agent.get("type") in ("expert", "auto", "remote"):
        raise NotImplementedError(f"agent.type={agent.get('type')}: that agent {item2}")
    if int(agent.get("fleet_devices", 1)) > 1:
        raise NotImplementedError("agent.fleet_devices > 1: serving across devices is not "
                                  "ported to mmfn_tpu_torch yet (ROADMAP queue 1 item 4, "
                                  "multi-process)")


def _load_weights(model, agent_cfg) -> None:
    """``agent.model_path``'s ``best_model.pth`` into ``model``, or say that
    the weights are random."""
    from mmfn_tpu_torch.utils.weights import load_reference_state_dict, load_torch_state_dict

    model_path = agent_cfg.get("model_path")
    ckpt = os.path.join(model_path or "", "best_model.pth")
    if model_path and os.path.exists(ckpt):
        load_reference_state_dict(model, load_torch_state_dict(ckpt))
        print(f"{bc.OKGREEN}loaded checkpoint {ckpt}{bc.ENDC}")
    else:
        print(f"{bc.WARNING}no checkpoint at {ckpt}; using random init "
              f"(seed {SEED}){bc.ENDC}")


def build_agent(cfg, shared=None):
    """Construct a fresh agent per route (leaderboard_evaluator.py:264).
    ``shared`` keeps the serving pipeline across routes and fleet members."""
    shared = shared if shared is not None else {}
    agent_cfg = cfg["agent"]
    agent_type = agent_cfg.get("type", "e2e")
    if agent_type == "npc":
        from mmfn_tpu_torch.harness.agents.trivial import NpcAgent

        return NpcAgent()
    device = resolve_device(cfg.get("device"))
    if agent_type in ("aim", "cilrs", "transfuser"):
        from mmfn_tpu_torch.harness.agents.baseline import BaselineAgent
        from mmfn_tpu_torch.models.baselines import build_baseline

        gconf = GlobalConfig(max_lanes=agent_cfg.get("max_lanes", 64))
        model = build_baseline(agent_type, gconf, torch.Generator().manual_seed(SEED),
                               device="cpu")
        _load_weights(model, agent_cfg)
        return BaselineAgent({"kind": agent_type, "model": model, "config": gconf,
                              "device": device})
    if agent_type != "e2e":
        raise ValueError(f"unknown agent.type {agent_type!r}")
    from mmfn_tpu_torch.harness.agents.e2e import MMFNAgent
    from mmfn_tpu_torch.harness.agents.pipeline import TorchPipeline
    from mmfn_tpu_torch.models.mmfn import build_model

    # model-shape overrides so checkpoints trained at other sizes load;
    # attn_impl=pallas selects the fused attention kernel
    overrides = {k: agent_cfg[k] for k in ("n_layer", "n_embd", "n_head", "attn_impl")
                 if k in agent_cfg}
    gconf = GlobalConfig(max_lanes=agent_cfg.get("max_lanes", 64), **overrides)
    variant = agent_cfg.get("variant", "vec")
    if "pipeline" not in shared:
        model = build_model(gconf, variant, torch.Generator().manual_seed(SEED), device="cpu")
        _load_weights(model, agent_cfg)
        if agent_cfg.get("device_world"):
            # sensors synthesized on the device from compact world frames
            from mmfn_tpu_torch.harness.device_world import DeviceWorldPipeline

            shared["pipeline"] = DeviceWorldPipeline(model, gconf, device=device)
        else:
            # agent.host_bev=true bins the LiDAR on the host (no BEV kernel)
            shared["pipeline"] = TorchPipeline(
                model, gconf, host_bev=bool(agent_cfg.get("host_bev", False)),
                device=device)
    return MMFNAgent({"variant": variant, "pipeline": shared["pipeline"], "config": gconf,
                      "rmap_tool": agent_cfg.get("rmap_tool"),
                      # opt-in pipelined inference (one-tick actuation latency)
                      "async_dispatch": agent_cfg.get("async_dispatch", False)})


def main(argv=None) -> int:
    from mmfn_tpu_torch.harness.replay import ClosedLoopRunner, plan_from_trajectory
    from mmfn_tpu_torch.harness.result_writer import format_global_summary, format_route_record
    from mmfn_tpu_torch.harness.route import RouteIndexer, interpolate_trajectory
    from mmfn_tpu_torch.harness.statistics import StatisticsManager

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    _refuse_unported(cfg)

    endpoint = cfg.get("checkpoint", "results/eval.json")
    statistics = StatisticsManager()
    indexer = RouteIndexer(cfg["routes"], repetitions=int(cfg.get("repetitions", 1)))
    if cfg.get("resume"):
        indexer.resume(endpoint)
        statistics.resume(endpoint)

    # the fake world's map: `map:` names an OpenDRIVE file; default is a
    # straight road. Vectorized once, so the outside-lanes penalty and the
    # signals apply and the birdview camera renders
    map_xodr = FALLBACK_XODR
    if cfg.get("map"):
        with open(cfg["map"]) as f:
            map_xodr = f.read()
    rough_map = birdview = None
    try:
        from mmfn_tpu_torch.mapping import vectorize_xodr

        rough_map, birdview, _ = vectorize_xodr(
            map_xodr, tool_path=cfg["agent"].get("rmap_tool"))
    except Exception as e:
        # an explicitly configured map MUST vectorize — otherwise signals and
        # the outside-lanes penalty would silently vanish
        if cfg.get("map"):
            raise
        print(f"{bc.WARNING}map vectorization unavailable ({e}); running "
              f"without signals/lane penalties{bc.ENDC}")

    def route_kwargs(config):
        """Per-route drive() kwargs: scenario triggers, signals, weather and
        the birdview camera."""
        triggers = None
        if cfg.get("scenarios"):
            from mmfn_tpu_torch.harness.scenarios import (
                parse_scenario_file, sample_scenarios, scan_route_for_scenarios)

            triggers = parse_scenario_file(cfg["scenarios"], config.town)
            if cfg.get("route_scenario_sampling", True):
                # match town triggers to THIS route, then sample one scenario
                # per position; the repetition index seeds the choices
                route_xy = [p for p, _ in interpolate_trajectory(config.trajectory)]
                triggers = sample_scenarios(scan_route_for_scenarios(route_xy, triggers),
                                            seed=config.index)
        signals = None
        if rough_map is not None and cfg.get("signals", True):
            from mmfn_tpu_torch.harness.traffic import signals_from_rough_map

            _, world_plan = plan_from_trajectory(config.trajectory)
            signals = signals_from_rough_map(rough_map, [p for p, _ in world_plan])
        max_ticks = cfg.get("max_ticks")
        # the route XML's own <weather> overrides the `weather:` knob
        weather = getattr(config, "weather", None) or cfg.get("weather") or "ClearNoon"
        world_kwargs = {"camera_birdview": birdview, "weather": weather}
        if cfg["agent"].get("device_world"):
            # the world skips host synthesis: one compact world_state a tick
            world_kwargs["compact_sensors"] = True
        return dict(triggers=triggers, rough_map=rough_map, signals=signals,
                    world_kwargs=world_kwargs,
                    max_ticks=None if max_ticks is None else int(max_ticks))

    shared = {}
    wall_budget = float(cfg.get("max_wall_seconds", 900.0))
    runner = ClosedLoopRunner(statistics, max_wall_seconds=wall_budget)
    # fleet: N — drive up to N routes in lockstep with ONE batched forward
    # per tick instead of the reference's strictly sequential route loop
    fleet_n = max(1, int(cfg.get("fleet", 1)))
    t0 = time.time()
    while indexer.peek():
        configs = []
        while indexer.peek() and len(configs) < fleet_n:
            configs.append(indexer.next())
        if len(configs) > 1:
            from mmfn_tpu_torch.harness.fleet import FleetRunner

            agents = [build_agent(cfg, shared) for _ in configs]
            if not all(hasattr(a, "prepare_step") for a in agents):
                raise SystemExit("fleet: N needs agents with the prepare_step/finish_step "
                                 "split (agent.type=e2e)")
            print(f"{bc.OKCYAN}fleet of {len(configs)}: routes "
                  f"{', '.join(c.route_id for c in configs)}{bc.ENDC}")
            try:
                records = FleetRunner(
                    statistics, max_wall_seconds=wall_budget,
                    pipelined=bool(cfg["agent"].get("async_dispatch", False)),
                ).run(agents, [dict(config=c, opendrive_str=map_xodr, **route_kwargs(c))
                               for c in configs])
            finally:
                for a in agents:
                    a.destroy()
        else:
            config = configs[0]
            agent = build_agent(cfg, shared)
            print(f"{bc.OKCYAN}route {config.route_id} "
                  f"({config.index + 1}/{indexer.total}){bc.ENDC}")
            try:
                records = [runner.run_route(agent, config, map_xodr, **route_kwargs(config))]
            finally:
                agent.destroy()
        for config, record in zip(configs, records):
            statistics.save_record(record, config.index, endpoint)
            print(format_route_record(record, title=f"route {config.route_id}"))
        indexer.save_state(endpoint)

    global_record = statistics.compute_global_statistics(indexer.total)
    statistics.save_global_record(global_record, indexer.total, endpoint)
    print(format_global_summary(statistics.records))
    print(f"{bc.OKGREEN}driving score: {global_record.scores['score_composed']:.2f} "
          f"({time.time() - t0:.0f}s){bc.ENDC}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
