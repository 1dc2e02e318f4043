"""Closed-loop soak benchmark of the port: full agent ticks/s in the fake world.

The port of ``bench_loop.py``. ``bench`` measures the device pipeline; this
measures the COMPLETE per-tick agent path (sensor mux, the camera crop, the
lane crop around the live pose, the radar TTC fit, the forward with its
host-card round trip, PID, control) plus world integration and criteria
scoring, exactly as the port's phase0 CLI runs it.

Modes (one JSON line each, ``vs_baseline`` = ticks/s / 20 Hz, the CARLA
synchronous rate the reference must keep up with):

- default: one agent soaked over a straight route, synchronous, pipelined
  (``async_dispatch``: steer from the previous tick) and synchronous through
  the per-array transport (``TorchPipeline(packed=False, host_bev=False)``:
  one copy per input and the padded f16 cloud binned on the card by kernel
  1), with the agent's time split from the harness's;
- ``--fleet N``: N vehicles in lockstep through ``FleetRunner``, one batched
  forward a tick (``--pipelined``: steer from the previous tick's);
- ``--fleet-sweep 8,16,...``: the host fleet and the device-world fleet
  (``DeviceWorldPipeline``, compact world frames, sensors synthesized on the
  card) at each width, and the device-side ceiling at the widest
  (``bench.timed_loop``).

``relay_rtt_ms`` keeps the JAX key: there is no relay here, and it reports
the host -> card -> host round trip of a one-element tensor (copy in, one
add, copy out), the latency floor of any synchronous tick.

Full flagship config (MMFN-rad, n_layer 8, 64 lanes, plain attention) with
random weights from seed 0; the map tool ``native/build/rough_map_node``
must be built (``scripts/build_native.sh``).

Usage:
    python -m mmfn_tpu_torch.bench_loop [--fleet 8 --pipelined] \\
        [--fleet-sweep 8,32,128] [--ticks N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.device import resolve_device
from mmfn_tpu_torch.harness.replay import ClosedLoopRunner
from mmfn_tpu_torch.harness.route import RouteConfig

XODR = """<?xml version="1.0" standalone="yes"?>
<OpenDRIVE>
  <header revMajor="1" revMinor="4" name="line"/>
  <road name="R0" length="3000.0" id="0" junction="-1">
    <planView>
      <geometry s="0.0" x="0.0" y="0.0" hdg="0.0" length="3000.0"><line/></geometry>
    </planView>
    <lanes>
      <laneSection s="0.0">
        <center><lane id="0" type="none" level="false"/></center>
        <right>
          <lane id="-1" type="driving" level="false">
            <width sOffset="0.0" a="3.5" b="0.0" c="0.0" d="0.0"/>
          </lane>
        </right>
      </laneSection>
    </lanes>
  </road>
</OpenDRIVE>
"""

SOAK_TICKS = 400
WARMUP_TICKS = 24


class _TimedAgent:
    """Wraps the agent callable to split agent time from harness time."""

    def __init__(self, agent):
        self._agent = agent
        self.agent_seconds = 0.0
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._agent, name)

    def __call__(self, timestamp):
        t0 = time.perf_counter()
        out = self._agent(timestamp)
        self.agent_seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def _build_agent(device=None):
    from mmfn_tpu_torch.harness.agents.e2e import MMFNAgent
    from mmfn_tpu_torch.models import build_model

    cfg = GlobalConfig()
    model = build_model(cfg, "rad", torch.Generator().manual_seed(0), device=device)
    return MMFNAgent({"variant": "rad", "model": model, "config": cfg, "device": device})


def _soak_mode(pipeline, config, async_dispatch: bool, ticks: int = SOAK_TICKS):
    from mmfn_tpu_torch.harness.agents.e2e import MMFNAgent

    agent = MMFNAgent({"variant": "rad", "pipeline": pipeline, "config": config,
                       "async_dispatch": async_dispatch})
    try:
        wall, timed, record = _soak(agent, ticks)
    finally:
        agent.destroy()
    return {
        "ticks_per_sec": round(timed.calls / wall, 2),
        "agent_ms_per_tick": round(timed.agent_seconds / timed.calls * 1e3, 2),
        "harness_ms_per_tick": round(
            (wall - timed.agent_seconds) / timed.calls * 1e3, 2),
        "route_status": record.status,
    }


def _soak(agent, ticks: int):
    timed = _TimedAgent(agent)
    config = RouteConfig(route_id="0", town="TownBench",
                         trajectory=[(0.0, 1.75, 0.0), (2900.0, 1.75, 0.0)],
                         index=0)
    runner = ClosedLoopRunner(max_wall_seconds=3600)
    t0 = time.perf_counter()
    record = runner.run_route(timed, config, XODR, max_ticks=ticks)
    wall = time.perf_counter() - t0
    return wall, timed, record


def _relay_rtt_ms(device, n: int = 20) -> float:
    """The host -> card -> host round trip of a one-element tensor, ms (see
    the module docstring)."""
    one = torch.zeros(())
    (one.to(device) + 1).item()
    t0 = time.perf_counter()
    for _ in range(n):
        (one.to(device) + 1).item()
    return (time.perf_counter() - t0) / n * 1e3


def _fleet_mode(pipeline, config, n: int, ticks: int, pipelined: bool,
                compact_world: bool = False):
    """Aggregate throughput of an N-vehicle lockstep fleet (harness/fleet.py):
    N fake worlds, N full host agent paths, ONE batched device forward per
    tick (``pipelined``: steer from the previous tick's forward while this
    tick's is in flight).

    ``compact_world=True`` runs the device-world mode: worlds emit compact
    state only and ``pipeline`` (a DeviceWorldPipeline) synthesizes sensors
    inside the forward, about 260 B a vehicle-tick over the link."""
    from mmfn_tpu_torch.harness.agents.e2e import MMFNAgent
    from mmfn_tpu_torch.harness.fleet import FleetRunner

    def run_once(run_ticks):
        agents = [MMFNAgent({"variant": "rad", "pipeline": pipeline,
                             "config": config}) for _ in range(n)]
        routes = [{"config": RouteConfig(
                       route_id=str(k), town="TownBench",
                       trajectory=[(0.0, 1.75, 0.0), (2900.0, 1.75, 0.0)],
                       index=k),
                   "opendrive_str": XODR, "max_ticks": run_ticks,
                   **({"world_kwargs": {"compact_sensors": True}}
                      if compact_world else {})}
                  for k in range(n)]
        t0 = time.perf_counter()
        try:
            records = FleetRunner(max_wall_seconds=3600,
                                  pipelined=pipelined).run(agents, routes)
        finally:
            for a in agents:
                a.destroy()
        wall = time.perf_counter() - t0
        total_ticks = sum(a.step + 1 for a in agents)  # ticks _tick() ran
        return wall, total_ticks, records

    run_once(WARMUP_TICKS)          # the width-N forward's first call
    wall, total_ticks, records = run_once(ticks)
    agg = total_ticks / wall
    return {
        "fleet": n,
        "agg_ticks_per_sec": round(agg, 2),
        "per_vehicle_ticks_per_sec": round(agg / n, 2),
        "vehicles_at_20hz": round(agg / 20.0, 1),
        "route_status": records[0].status,
    }


def _fleet_device_side(n: int, device, iters: int = 50):
    """Device-side fleet ticks/s at width ``n``: the batched sensor->waypoints
    pipeline enqueued back to back (``bench.timed_loop``: host prep and
    round trips amortized away). This is what the card sustains when the
    host feeds it."""
    import numpy as np

    from mmfn_tpu_torch import bench
    from mmfn_tpu_torch.models import build_model

    rng = np.random.default_rng(0)
    model = build_model(GlobalConfig(), "rad", torch.Generator().manual_seed(0),
                        device=device)
    bench.make_inputs(1, rng, device)
    step_s = bench.timed_loop(bench.pipeline_fn(model), bench.make_inputs(n, rng, device),
                              iters)
    ticks = n / step_s
    return {"width": n, "agg_ticks_per_sec": round(ticks, 2),
            "vehicles_at_20hz": round(ticks / 20.0, 1)}


def _device_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fleet", type=int, default=0,
                    help="N>0: measure an N-vehicle lockstep fleet instead "
                         "of the single-agent soak modes")
    ap.add_argument("--fleet-sweep", type=str, default="",
                    help="comma list of fleet widths, e.g. 8,16,32,64: "
                         "host-fleet scaling curve + a device-side point")
    ap.add_argument("--ticks", type=int, default=0,
                    help="override soak ticks per route")
    ap.add_argument("--pipelined", action="store_true",
                    help="fleet mode: steer from the previous tick's batched "
                         "forward while this tick's is in flight")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (no kernel); default: the CUDA device")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.fleet_sweep:
        from mmfn_tpu_torch.harness.device_world import DeviceWorldPipeline

        widths = [int(w) for w in args.fleet_sweep.split(",") if w]
        agent = _build_agent(device)
        curve = [dict(_fleet_mode(agent.pipeline, agent.config, w,
                                  args.ticks or 120, pipelined=True),
                      fleet=w) for w in widths]
        dw_pipe = DeviceWorldPipeline(agent.pipeline.model, agent.config, device=device)
        dw_curve = [dict(_fleet_mode(dw_pipe, agent.config, w,
                                     args.ticks or 120, pipelined=True,
                                     compact_world=True),
                         fleet=w) for w in widths]
        device_side = _fleet_device_side(max(widths), device)
        best = max(c["vehicles_at_20hz"] for c in curve + dw_curve)
        print(json.dumps({
            "metric": "fleet scaling sweep (host fleet ticks/s by width + "
                      "device-world mode + device-side ceiling, full "
                      "MMFN-rad)",
            "value": best,
            "unit": "vehicles@20Hz (best width, either fleet mode)",
            "vs_baseline": best,   # reference serves exactly 1 vehicle
            "host_fleet": curve,
            "device_world_fleet": dw_curve,
            "device_side": device_side,
            "relay_rtt_ms": round(_relay_rtt_ms(device), 2),
            "device": _device_name(device),
        }))
        return 0

    agent = _build_agent(device)

    if args.fleet > 0:
        out = _fleet_mode(agent.pipeline, agent.config, args.fleet,
                          args.ticks or 120, args.pipelined)
        agg = out["agg_ticks_per_sec"]
        mode = "pipelined" if args.pipelined else "sync"
        print(json.dumps({
            "metric": f"fleet aggregate agent ticks/sec ({args.fleet} vehicles, {mode}, "
                      f"fake world, full MMFN-rad)",
            "value": agg,
            "unit": "ticks/s",
            "vs_baseline": round(agg / 20.0, 2),
            **out,
            "relay_rtt_ms": round(_relay_rtt_ms(device), 2),
            "device": _device_name(device),
        }))
        return 0
    ticks = args.ticks or SOAK_TICKS
    # the warm-up run: the map build and the forward's first calls
    _soak(agent, WARMUP_TICKS)

    # fresh agent state but a shared (warm) pipeline, like phase0's route
    # loop; the default transport is packed and, at 32,768 points a sweep,
    # the host-binned BEV grid
    sync = _soak_mode(agent.pipeline, agent.config, async_dispatch=False, ticks=ticks)
    # pipelined: enqueue tick N, steer from tick N-1 (one 50 ms sim tick of
    # actuation latency)
    pipelined = _soak_mode(agent.pipeline, agent.config, async_dispatch=True, ticks=ticks)

    # the per-array transport for the A/B: one copy per input, the padded
    # f16 cloud shipped and binned by kernel 1 instead of the uint8 grid
    from mmfn_tpu_torch.harness.agents.e2e import MMFNAgent
    from mmfn_tpu_torch.harness.agents.pipeline import TorchPipeline

    legacy_pipeline = TorchPipeline(agent.pipeline.model, agent.config,
                                    host_bev=False, packed=False, device=device)
    legacy_warm = MMFNAgent({"variant": "rad", "pipeline": legacy_pipeline,
                             "config": agent.config})
    _soak(legacy_warm, WARMUP_TICKS)
    sync_legacy = _soak_mode(legacy_pipeline, agent.config, async_dispatch=False,
                             ticks=ticks)

    best = max(sync["ticks_per_sec"], pipelined["ticks_per_sec"])
    print(json.dumps({
        "metric": "closed-loop agent ticks/sec (fake world, full MMFN-rad)",
        "value": best,
        "unit": "ticks/s",
        "vs_baseline": round(best / 20.0, 2),
        "sync": sync,
        "pipelined": pipelined,
        "sync_per_array_transport": sync_legacy,
        "ticks": ticks,
        "relay_rtt_ms": round(_relay_rtt_ms(device), 2),
        "device": _device_name(device),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
