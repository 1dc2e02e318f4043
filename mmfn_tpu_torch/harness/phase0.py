"""phase0: closed-loop evaluation of a route set in the fake world, with mmfn_tpu_torch.

The port of ``run_steps/phase0_run_eval.py``: the same config file
(``run_steps/config/eval.yaml``) and the same ``key=value`` overrides. It
iterates routes with resume, drives each through the kinematic fake world
(``harness/replay.py``), scores it, and writes the leaderboard-format
checkpoint JSON (``harness/statistics.py``), which either package reads.

Supported: ``routes`` (a route XML, or an OpenSCENARIO ``.xosc`` episode:
its route comes from the hero's init position, ``harness/openscenario.py``
runs its storyboard with a fresh ``OpenScenarioManager`` each repetition,
and its ``EnvironmentAction`` sets the weather), ``map``, ``scenarios``
(JSON triggers), ``signals``, ``repetitions``, ``fleet``
(``harness/fleet.py``; ``agent.async_dispatch`` selects the pipelined
fleet), ``weather`` presets and a route's own ``<weather>``,
``weather_animation`` (``WeatherSim``; a number is its time compression)
with ``weather_start_hour``, ``background_traffic``
(``harness/npc_traffic.py``, seeded with the route's index), ``max_ticks``,
``max_wall_seconds``, ``resume`` / ``checkpoint``, ``record`` (a
directory: each route's ground truth is recorded to
``{record}/{route}_rep{index}.json`` for post-hoc metrics, ``python -m
mmfn_tpu_torch.harness.metrics_run``; sequential routes only);
``agent.type`` e2e (``agent.variant`` vec | rad | img), npc, aim, cilrs,
transfuser, remote (``harness/agents/remote.py``: an external stack in its
own process, ``agent.stack_cmd``, for example ``python -m
mmfn_tpu_torch.harness.agents.remote``, with ``agent.stepping``,
``agent.sensors``, ``agent.socket``, ``agent.step_timeout``,
``agent.connect_timeout``, ``agent.send_timeout`` and ``agent.env``), and
the data-collection experts ``expert`` (``agent.pilot`` mmfn | auto) and
``auto`` (the expert with the simple pilot), which write a dataset frame
every 10 ticks under ``agent.data_save`` (one ``route_NN`` directory per
route unless the path names one) as ``agent.image_ext`` (png | npy), with
``agent.seed``, ``agent.force_unblock`` and ``collect_offsets`` (later
repetitions start laterally offset); ``agent.n_layer``, ``agent.n_embd``,
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
for the whole batch. The experts run on the host, as the JAX package's do,
and need no device.

``agent.fleet_devices=N`` splits a fleet's batched forward over the first N
CUDA devices (one model replica and one stream each,
``harness/agents/pipeline.py``), and exits when fewer are visible; under
``device=cpu`` over N CPU entries, which is how the CPU tests hold it to the
JAX CLI's split over its virtual devices.

``simulator: carla`` drives a CARLA server through the port's glue
(``harness/carla_glue.py``: XML routes only, as in the JAX CLI), with the
same agents; it raises when the ``carla`` package is missing. Without a
server, ``python -m mmfn_tpu_torch.harness.fake_carla --town NAME=<xodr>
...`` runs this CLI against the port's in-process mock of the carla API.
The first model agent a run builds first builds the CUDA kernels
(``utils/compile_cache.py``; nothing on a machine without CUDA), so that no
tick waits for ``nvcc``, and under ``simulator: carla`` one forward of
zeros warms the model before the glue's first tick.

Usage:
    python -m mmfn_tpu_torch.harness.phase0 --config run_steps/config/eval.yaml \\
        [agent.type=npc agent.variant=rad routes=path.xml device=cpu ...]
    python -m mmfn_tpu_torch.harness.phase0 --config run_steps/config/collect.yaml \\
        [routes=... map=... agent.data_save=<root>/<Town>_short ...]
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time

import numpy as np

from mmfn_tpu_torch.config import GlobalConfig
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


def fleet_devices(cfg, device: torch.device):
    """``device``, or with ``agent.fleet_devices=N`` > 1 the list of N
    devices to split the fleet over: the first N CUDA devices (exits when
    fewer are visible), or N CPU entries under ``device=cpu``."""
    n = int((cfg.get("agent") or {}).get("fleet_devices", 1))
    if n <= 1:
        return device
    if device.type == "cpu":
        return [device] * n
    import torch

    visible = torch.cuda.device_count()
    if visible < n:
        raise SystemExit(f"agent.fleet_devices={n} but only {visible} devices are visible")
    return [torch.device("cuda", i) for i in range(n)]


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


def _route_save_path(data_save, route_index):
    """Per-route dataset dir: writing several routes into one directory
    would overwrite frames (DatasetWriter restarts ids per agent). A path
    already naming a route (…/route_NN) is used as-is — single-route runs
    and tests address the exact directory."""
    if data_save is None or route_index is None \
            or re.search(r"route_\d+$", str(data_save)):
        return data_save
    return os.path.join(str(data_save), f"route_{route_index:02d}")


def build_agent(cfg, shared=None, route_index=None):
    """Construct a fresh agent per route (leaderboard_evaluator.py:264).
    ``shared`` keeps the serving pipeline across routes and fleet members;
    ``route_index`` names an expert's dataset directory."""
    shared = shared if shared is not None else {}
    agent_cfg = cfg["agent"]
    agent_type = agent_cfg.get("type", "e2e")
    if agent_type == "auto":
        # AutoPilot = the SimplePilot rule stack under the expert agent
        # (auto_pilot.py is MMFNPilot's simpler sibling in the reference)
        agent_type = "expert"
        agent_cfg = {**agent_cfg, "pilot": "auto"}
    if agent_type == "expert":
        # data collection (the reference's phase0 collect with MMFNPilot)
        from mmfn_tpu_torch.harness.experts.agent import ExpertCollectionAgent

        return ExpertCollectionAgent({
            "config": GlobalConfig(max_lanes=agent_cfg.get("max_lanes", 64)),
            "save_path": _route_save_path(agent_cfg.get("data_save"), route_index),
            "image_ext": agent_cfg.get("image_ext", "png"),
            "seed": agent_cfg.get("seed", 0),
            "pilot": agent_cfg.get("pilot", "mmfn"),
            # reference expert.yaml:1-2 ships force_destory_actor: True
            "force_unblock": agent_cfg.get("force_unblock", True),
            "rmap_tool": agent_cfg.get("rmap_tool"),
        })
    if agent_type == "npc":
        from mmfn_tpu_torch.harness.agents.trivial import NpcAgent

        return NpcAgent()
    if agent_type == "remote":
        # an external stack over the process bridge (RosAgent analog):
        # agent.stack_cmd="python -m mmfn_tpu_torch.harness.agents.remote"
        # (or $MMFN_STACK_CMD)
        from mmfn_tpu_torch.harness.agents.remote import RemoteAgent

        return RemoteAgent({k: agent_cfg[k] for k in
                            ("stack_cmd", "sensors", "stepping", "socket", "step_timeout",
                             "connect_timeout", "env", "send_timeout")
                            if k in agent_cfg})
    # the model agents: torch loads here, so that a run of the experts, the
    # NPC driver or a remote stack (collection, scoring the expert) does without
    import torch

    from mmfn_tpu_torch.device import resolve_device
    from mmfn_tpu_torch.utils.compile_cache import enable_persistent_cache

    device = resolve_device(cfg.get("device"))
    if agent_type in ("aim", "cilrs", "transfuser"):
        from mmfn_tpu_torch.harness.agents.baseline import BaselineAgent
        from mmfn_tpu_torch.models.baselines import build_baseline

        enable_persistent_cache()       # the kernels build before the first tick
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
        device = fleet_devices(cfg, device)
        enable_persistent_cache()       # the kernels build before the first tick
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


def warm_pipeline(shared) -> None:
    """One forward of zeros through ``shared``'s model pipeline, once: the
    CUDA context, cuBLAS and cuDNN start here rather than inside the CARLA
    glue's first tick, which its 2 s watchdog guards."""
    from mmfn_tpu_torch.harness.agents.pipeline import TorchPipeline

    pipe = shared.get("pipeline")
    if not isinstance(pipe, TorchPipeline) or shared.get("warm"):
        return
    cfg, res = pipe.config, pipe.config.input_resolution
    image_only = pipe.variant == "img"
    pipe(np.zeros((res, res, 3), np.uint8), np.zeros((8, 3), np.float32),
         None if image_only else pipe.zero_lanes, None if image_only else 1,
         np.zeros((cfg.radar_points, cfg.radar_features), np.float32),
         np.zeros((res, res, 3), np.uint8) if image_only else None,
         np.zeros(2, np.float32), 0.0)
    shared["warm"] = True


def main(argv=None) -> int:
    from mmfn_tpu_torch.harness.replay import (ClosedLoopRunner, background_traffic,
                                               plan_from_trajectory)
    from mmfn_tpu_torch.harness.result_writer import format_global_summary, format_route_record
    from mmfn_tpu_torch.harness.route import RouteIndexer, interpolate_trajectory
    from mmfn_tpu_torch.harness.statistics import StatisticsManager

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, args.overrides)

    endpoint = cfg.get("checkpoint", "results/eval.json")
    # OpenSCENARIO episodes (.xosc) take their route from the hero's init
    # position and run their storyboard through OpenScenarioManager below
    is_xosc = str(cfg.get("routes", "")).endswith(".xosc")
    indexer = None
    statistics = StatisticsManager()
    if not is_xosc:
        indexer = RouteIndexer(cfg["routes"], repetitions=int(cfg.get("repetitions", 1)))
        if cfg.get("resume"):
            indexer.resume(endpoint)
    if cfg.get("resume"):
        statistics.resume(endpoint)

    if cfg.get("simulator", "fake") == "carla":
        if is_xosc:
            raise SystemExit("OpenSCENARIO routes are supported by the fake "
                             "world; the CARLA path runs XML routes "
                             "(srunner owns .xosc there)")
        from mmfn_tpu_torch.harness.carla_glue import run_carla_evaluation

        shared = {}

        def build_warm_agent(cfg):
            agent = build_agent(cfg, shared)
            warm_pipeline(shared)
            return agent

        run_carla_evaluation(cfg, indexer, statistics, build_warm_agent, endpoint)
        return 0

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

    xcfg = None
    if is_xosc:
        from mmfn_tpu_torch.harness.openscenario import hero_trajectory, parse_xosc
        from mmfn_tpu_torch.harness.route import RouteConfig

        # the map's rmap v3 ids resolve LanePosition / RoadPosition
        xcfg = parse_xosc(cfg["routes"], rough_map=rough_map)
        trajectory = [(x, y, 0.0) for x, y in hero_trajectory(xcfg, rough_map)]
        route_id = os.path.splitext(os.path.basename(cfg["routes"]))[0]
        indexer = RouteIndexer.from_configs(
            [RouteConfig(route_id=route_id, town=xcfg.town or "XoscWorld",
                         trajectory=trajectory)],
            repetitions=int(cfg.get("repetitions", 1)))
        if cfg.get("resume"):
            indexer.resume(endpoint)

    def route_kwargs(config):
        """Per-route drive() kwargs: scenario triggers, signals, background
        traffic, weather, the birdview camera and, for an .xosc episode, a
        fresh storyboard manager."""
        scenario_manager = None
        if is_xosc:
            from mmfn_tpu_torch.harness.openscenario import OpenScenarioManager

            # a fresh manager a repetition over the shared parsed config (the
            # fired state and the actors live on the manager)
            scenario_manager = OpenScenarioManager(xcfg)
        triggers = None
        if not is_xosc and cfg.get("scenarios"):
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
        background = None if rough_map is None else background_traffic(
            rough_map, config.trajectory, int(cfg.get("background_traffic", 0)),
            config.index, signals)
        max_ticks = cfg.get("max_ticks")
        # the .xosc EnvironmentAction's preset, else the route XML's own
        # <weather>, which overrides the `weather:` knob
        if is_xosc and xcfg.weather:
            weather = xcfg.weather
        else:
            weather = getattr(config, "weather", None) or cfg.get("weather") or "ClearNoon"
        # weather_animation: the sun moves over game time (srunner
        # weather_sim.py analog); a number compresses time (60: one route
        # minute a sun hour), true is real time
        weather_sim = None
        anim = cfg.get("weather_animation")
        if anim:
            from mmfn_tpu_torch.harness.weather import WeatherSim

            weather_sim = WeatherSim(
                preset=weather,
                time_scale=1.0 if anim is True else float(anim),
                start_hour=float(cfg.get("weather_start_hour", 11.0)))
        world_kwargs = {"camera_birdview": birdview, "weather": weather}
        if cfg["agent"].get("device_world"):
            # the world skips host synthesis: one compact world_state a tick
            world_kwargs["compact_sensors"] = True
        return dict(triggers=triggers, rough_map=rough_map, signals=signals,
                    background=background, world_kwargs=world_kwargs,
                    scenario_manager=scenario_manager, weather_sim=weather_sim,
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

            agents = [build_agent(cfg, shared, route_index=c.index) for c in configs]
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
            agent = build_agent(cfg, shared, route_index=config.index)
            # expert collection with repetitions > 1: later repetitions start
            # laterally offset, so the dataset carries recovery-to-lane
            # demonstrations (harness/route.py:offset_route_start)
            if cfg.get("collect_offsets") and cfg["agent"].get("type") in ("expert", "auto"):
                from mmfn_tpu_torch.harness.route import collect_offset_for, offset_route_start

                reps = max(1, int(cfg.get("repetitions", 1)))
                rep = config.index // max(1, indexer.total // reps)
                lateral = collect_offset_for(rep)
                if lateral:
                    config.trajectory = offset_route_start(config.trajectory, lateral)
                    print(f"{bc.OKCYAN}collect offset {lateral:+.1f} m (rep {rep}){bc.ENDC}")
            print(f"{bc.OKCYAN}route {config.route_id} "
                  f"({config.index + 1}/{indexer.total}){bc.ENDC}")
            # record: DIR — the route's ground truth for post-hoc metrics,
            # named like the reference's recorder logs
            # (leaderboard_evaluator.py:319-320); sequential routes only
            recorder = None
            if cfg.get("record"):
                from mmfn_tpu_torch.harness.recording import EpisodeRecorder

                recorder = EpisodeRecorder()
            try:
                records = [runner.run_route(agent, config, map_xodr, recorder=recorder,
                                            **route_kwargs(config))]
            finally:
                agent.destroy()
            if recorder is not None:
                os.makedirs(cfg["record"], exist_ok=True)
                rec_path = os.path.join(cfg["record"],
                                        f"{config.route_id}_rep{config.index}.json")
                recorder.save(rec_path)
                print(f"recording written to {rec_path}")
        for config, record in zip(configs, records):
            statistics.save_record(record, config.index, endpoint)
            print(format_route_record(record, title=f"route {config.route_id}"))
        indexer.save_state(endpoint)

    global_record = statistics.compute_global_statistics(indexer.total)
    statistics.save_global_record(global_record, indexer.total, endpoint)
    print(format_global_summary(statistics.records))
    print(f"{bc.OKGREEN}driving score: {global_record.scores['score_composed']:.2f} "
          f"({time.time() - t0:.0f}s){bc.ENDC}")
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        print(f"peak card memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB allocated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
