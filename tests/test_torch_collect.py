"""The port's data collection against the JAX package's, on the CPU: the
hazard geometry, both pilots, the expert agent, background traffic,
``WeatherSim``, the dataset writer and the phase0 CLI's collection options.

- ``control/geometry.py`` and both pilots' ``get_control`` on seeded random
  inputs: exact.
- ``ExpertCollectionAgent`` in each package's ``ClosedLoopRunner`` on a
  straight road, with ``BackgroundTraffic`` (6 vehicles), a stopped vehicle
  and a crossing walker: controls, the NPCs' poses every tick, the
  fault-removal requests and the route record exact. The written frame
  trees are equal file for file: ``.npy`` bytes, measurements JSON and the
  decoded pixels of every PNG (written by PIL in the JAX package, by
  ``data/png.py`` in the port; each read by both decoders).
- ``WeatherSim.update`` over a route's game times: equal.
- ``route_environment`` with traffic: the same vehicles and lights.
- The phase0 CLI with ``agent.type=expert``, ``agent.type=auto``,
  ``collect_offsets=true repetitions=2``, ``background_traffic=4`` and
  ``weather_animation=60``: the same checkpoint records and frame trees as
  the JAX CLI on the same route (60 ticks).

The map tool is ``native/rough_map_node.cpp``, built with g++ into this
module's own temporary directory (not the shared ``native/build/``).
"""

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from mmfn_tpu.config import GlobalConfig as JaxConfig
from mmfn_tpu.control import geometry as jax_geometry
from mmfn_tpu.harness import replay as jreplay
from mmfn_tpu.harness.experts import pilot as jax_pilot
from mmfn_tpu.harness.experts.agent import ExpertCollectionAgent as JaxExpert
from mmfn_tpu.harness.experts.world_view import Actor as JaxActor
from mmfn_tpu.harness.experts.world_view import EgoState as JaxEgoState
from mmfn_tpu.harness.experts.world_view import WorldView as JaxWorldView
from mmfn_tpu.harness.route import RouteConfig as JaxRouteConfig
from mmfn_tpu.harness.scenarios import ScenarioTrigger as JaxScenarioTrigger
from mmfn_tpu.harness.weather import WeatherSim as JaxWeatherSim
from mmfn_tpu.mapping import rough_map as jax_rough_map

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.control import geometry
from mmfn_tpu_torch.data import png
from mmfn_tpu_torch.data.writer import DatasetWriter
from mmfn_tpu_torch.harness import phase0, replay
from mmfn_tpu_torch.harness.experts import pilot
from mmfn_tpu_torch.harness.experts.agent import ExpertCollectionAgent
from mmfn_tpu_torch.harness.experts.world_view import Actor, EgoState, WorldView
from mmfn_tpu_torch.harness.route import RouteConfig
from mmfn_tpu_torch.harness.scenarios import ScenarioTrigger
from mmfn_tpu_torch.harness.weather import WeatherSim
from mmfn_tpu_torch.mapping.rough_map import RoughMap, build_rmap
from tests.test_harness import STRAIGHT_XODR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROSS_XODR = os.path.join(ROOT, "data", "maps", "fake_town_cross.xodr")
SCENARIOS = os.path.join(ROOT, "data", "scenarios", "fake_towns_scenarios.json")
COLLECT_YAML = os.path.join(ROOT, "run_steps", "config", "collect.yaml")
TRAJECTORY = [(0.0, 1.75, 0.0), (120.0, 1.75, 0.0)]
TICKS = 200


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads while this module runs: the tests run beside
    other workers, and a worker's default of one thread per core
    oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def map_tool(tmp_path_factory):
    """native/rough_map_node.cpp built into this module's own directory."""
    path = tmp_path_factory.mktemp("rough_map_node") / "rough_map_node"
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", str(path),
                    os.path.join(ROOT, "native", "rough_map_node.cpp")],
                   check=True, capture_output=True, timeout=300)
    return str(path)


@pytest.fixture(scope="module")
def rmaps(map_tool, tmp_path_factory):
    """name -> .rmap path of the straight road and the cross town."""
    with open(CROSS_XODR) as f:
        xodrs = {"straight": STRAIGHT_XODR, "cross": f.read()}
    out = {}
    for name, xodr in xodrs.items():
        d = tmp_path_factory.mktemp(name) / "opendrive"
        d.mkdir()
        (d / "opstr.txt").write_text(xodr)
        assert not build_rmap([str(d)], tool_path=map_tool)
        out[name] = str(d / "a.rmap")
    return out


# --------------------------------------------------------------------------- #
# geometry and the pilots
# --------------------------------------------------------------------------- #

def _vec(rng, scale=10.0):
    return rng.uniform(-scale, scale, 2)


@pytest.mark.parametrize("name", ["segment_intersection", "ttc_projection", "ttc_disc",
                                  "predicted_min_distance", "heading_angle_deg"])
def test_geometry_matches_jax(name):
    rng = np.random.default_rng(1)
    for _ in range(300):
        if name == "heading_angle_deg":
            a, b = rng.uniform(-math.pi, math.pi, 2)
            args = (np.array([math.cos(a), math.sin(a)]), np.array([math.cos(b), math.sin(b)]))
        elif name == "predicted_min_distance":
            args = (_vec(rng), _vec(rng), _vec(rng, 8), _vec(rng, 8), float(rng.uniform(0, 5)))
        elif name == "ttc_projection":
            args = (_vec(rng), _vec(rng), _vec(rng, 8), _vec(rng, 8), float(rng.uniform(0, 4)))
        else:
            args = (_vec(rng), _vec(rng), _vec(rng, 8), _vec(rng, 8))
        got, want = getattr(geometry, name)(*args), getattr(jax_geometry, name)(*args)
        if name == "segment_intersection":
            assert got[0] == want[0]
            assert (got[1] is None) == (want[1] is None)
            if want[1] is not None:
                np.testing.assert_array_equal(got[1], want[1])
        else:
            assert got == want


def _world_views(rng):
    """The same random privileged snapshot in both packages' classes."""
    ego = dict(position=_vec(rng, 20), velocity=_vec(rng, 6),
               yaw=float(rng.uniform(-math.pi, math.pi)), lane_id=int(rng.integers(3)),
               in_junction=bool(rng.random() < 0.3))

    def actors(n):
        return [dict(position=ego["position"] + _vec(rng, 15), velocity=_vec(rng, 5),
                     yaw=float(rng.uniform(-math.pi, math.pi)), extent=2.2,
                     lane_id=int(rng.integers(3)), in_junction=bool(rng.random() < 0.3),
                     actor_id=int(rng.integers(100))) for _ in range(n)]

    vehicles, walkers, behind = actors(int(rng.integers(4))), actors(int(rng.integers(3))), \
        actors(int(rng.integers(2)))
    front = actors(1)[0] if rng.random() < 0.5 else None
    flags = dict(red_light=bool(rng.random() < 0.3), stop_sign=bool(rng.random() < 0.2),
                 lane_change_required=bool(rng.random() < 0.4),
                 change_lane_ids=[int(i) for i in rng.integers(0, 3, int(rng.integers(3)))])
    views = []
    for act, ego_cls, view_cls in ((Actor, EgoState, WorldView),
                                   (JaxActor, JaxEgoState, JaxWorldView)):
        views.append(view_cls(
            ego=ego_cls(**ego), vehicles=[act(**a) for a in vehicles],
            walkers=[act(**a) for a in walkers],
            car_in_front=None if front is None else act(**front),
            cars_behind=[act(**a) for a in behind], **flags))
    return views


@pytest.mark.parametrize("kind", ["ExpertPilot", "SimplePilot"])
def test_pilot_matches_jax(kind):
    """300 decisions of one pilot on random snapshots (its PID windows and
    merge patience carry across them): every field exact."""
    rng = np.random.default_rng(2)
    got_pilot, want_pilot = getattr(pilot, kind)(), getattr(jax_pilot, kind)()
    hazards = set()
    for _ in range(300):
        view, jview = _world_views(rng)
        near, far = view.ego.position + _vec(rng, 8), view.ego.position + _vec(rng, 40)
        got = got_pilot.get_control(view, near, far)
        want = want_pilot.get_control(jview, near, far)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        hazards.add((want.hazard or "none").split(":")[0])
    assert {"none", "vehicle", "red_light"} <= hazards, hazards


# --------------------------------------------------------------------------- #
# the expert in both runners
# --------------------------------------------------------------------------- #

def _expert_run(pkg, rmap_path, map_tool, out_dir):
    """One expert route on the straight road with 6 background vehicles, a
    stopped vehicle and a crossing walker; returns the per-tick log, the
    record and the route's frame directory."""
    if pkg == "jax":
        mod, expert, trigger, route, rough, cfg = (jreplay, JaxExpert, JaxScenarioTrigger,
                                                   JaxRouteConfig, jax_rough_map.RoughMap,
                                                   JaxConfig())
    else:
        mod, expert, trigger, route, rough, cfg = (replay, ExpertCollectionAgent,
                                                   ScenarioTrigger, RouteConfig, RoughMap,
                                                   GlobalConfig())
    signals, background = mod.route_environment(rough().read(rmap_path), TRAJECTORY,
                                                traffic=6, seed=3)
    save = os.path.join(out_dir, pkg, "TownTest_short", "route_00")
    agent = expert({"rmap_tool": map_tool, "tmp_dir": os.path.join(out_dir, pkg + "_map"),
                    "config": cfg, "seed": 5, "save_path": save, "image_ext": "png",
                    "unblock_ticks": 20})
    log = {"controls": [], "unblock": [], "npcs": []}
    run_step, consume, tick = (agent.run_step, agent.consume_unblock_request,
                               background.tick)

    def logged_run_step(input_data, timestamp):
        c = run_step(input_data, timestamp)
        log["controls"].append((c.steer, c.throttle, c.brake, c.reverse))
        return c

    def logged_consume():
        r = consume()
        log["unblock"].append(r)
        return r

    def logged_tick(*args, **kw):
        out = tick(*args, **kw)
        log["npcs"].append([(a.position.tolist(), a.velocity.tolist(), a.yaw, a.actor_id)
                            for a in out])
        return out

    agent.run_step, agent.consume_unblock_request = logged_run_step, logged_consume
    background.tick = logged_tick
    triggers = [trigger(x=10.0, y=1.75, yaw=0.0, scenario_type="StoppedVehicle"),
                trigger(x=70.0, y=1.75, yaw=0.0, scenario_type="Scenario3")]
    record = mod.ClosedLoopRunner(max_wall_seconds=600).run_route(
        agent, route(route_id="0", town="TownTest", trajectory=TRAJECTORY, index=0),
        STRAIGHT_XODR, max_ticks=TICKS, triggers=triggers, rough_map=rough().read(rmap_path),
        signals=signals, background=background)
    return log, record, save


@pytest.fixture(scope="module")
def expert_runs(rmaps, map_tool, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("expert"))
    return {pkg: _expert_run(pkg, rmaps["straight"], map_tool, out) for pkg in ("port", "jax")}


def _record_dict(record):
    d = dict(record.to_dict())
    d["meta"] = {k: v for k, v in d["meta"].items() if k != "duration_system"}
    return d


def test_expert_matches_jax_tick_for_tick(expert_runs):
    (got, got_record, _), (want, want_record, _) = expert_runs["port"], expert_runs["jax"]
    assert len(want["controls"]) == TICKS
    for key in ("controls", "unblock", "npcs"):
        assert got[key] == want[key], key
    assert _record_dict(got_record) == _record_dict(want_record)
    # the run exercises what it claims: the expert stopped behind the stalled
    # vehicle long enough to ask for fault removal, which retired an NPC too,
    # and the NPCs drove off their lanes' ends and respawned
    first = want["unblock"].index(True)
    assert min(c[1] for c in want["controls"][first - 20:first]) == 0.0
    counts = [len(n) for n in want["npcs"]]
    assert set(counts[:first + 1]) == {6} and counts[-1] < 6
    assert len({a[3] for n in want["npcs"] for a in n}) > 6, "some NPC respawned"


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def assert_trees_equal(got_root, want_root):
    """Two raw route trees: the same files; .npy and opendrive bytes equal,
    measurements equal, PNG pixels equal through PIL and through data/png.py."""
    files = _tree(want_root)
    assert _tree(got_root) == files
    assert any(f.endswith(".png") for f in files)
    for name in files:
        got, want = os.path.join(got_root, name), os.path.join(want_root, name)
        if name.endswith(".json"):
            with open(got) as f, open(want) as g:
                assert json.load(f) == json.load(g), name
        elif name.endswith(".png"):
            pixels = np.asarray(Image.open(want))
            for decoded in (np.asarray(Image.open(got)), png.read(got), png.read(want)):
                assert decoded.dtype == pixels.dtype and decoded.shape == pixels.shape, name
                np.testing.assert_array_equal(decoded, pixels, err_msg=name)
        else:
            with open(got, "rb") as f, open(want, "rb") as g:
                assert f.read() == g.read(), name


def test_written_frames_match_jax(expert_runs):
    (_, _, got), (_, _, want) = expert_runs["port"], expert_runs["jax"]
    assert_trees_equal(got, want)
    # 200 ticks: a frame every 10th step after the first, 19 of them
    assert len(os.listdir(os.path.join(want, "rgb_front"))) == 19


def test_expert_sensors_match_jax(map_tool, tmp_path):
    got = ExpertCollectionAgent({"rmap_tool": map_tool, "tmp_dir": str(tmp_path)})
    want = JaxExpert({"rmap_tool": map_tool, "tmp_dir": str(tmp_path)})
    assert got.sensors() == want.sensors()


def test_writer_refuses_other_image_formats(tmp_path):
    with pytest.raises(ValueError, match="png or npy"):
        DatasetWriter(str(tmp_path / "route_00"), image_ext="jpg")


# --------------------------------------------------------------------------- #
# weather and background traffic
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("preset, hour, scale", [
    ("WetNoon", 17.97, 60.0), ("MidRainyNoon", 5.0, 3600.0), ("ClearSunset", 11.0, 1.0)])
def test_weather_sim_matches_jax(preset, hour, scale):
    """update() over 600 ticks of a route: the preset, the sun and the clock."""
    got = WeatherSim(preset=preset, start_hour=hour, time_scale=scale)
    want = JaxWeatherSim(preset=preset, start_hour=hour, time_scale=scale)
    seen = set()
    for tick in range(600):
        game_time = tick * replay.DT
        assert got.update(game_time) == want.update(game_time)
        assert (got.sun_altitude_deg, got.sun_azimuth_deg, got.clock_hour) == \
            (want.sun_altitude_deg, want.sun_azimuth_deg, want.clock_hour)
        seen.add(want.current_preset())
    if scale > 1.0:
        assert len(seen) == 2, "the route crosses a change of preset"


def test_route_environment_builds_background_traffic(rmaps):
    """route_environment(traffic > 0) on the cross town: the JAX package's
    lights and vehicles, and the same snapshots over 100 ticks of an ego
    crossing the junction."""
    trajectory = [(1.75, 80.0, 0.0), (1.75, -76.0, 0.0)]
    got_signals, got = replay.route_environment(RoughMap().read(rmaps["cross"]), trajectory,
                                                traffic=10, seed=2)
    want_signals, want = jreplay.route_environment(
        jax_rough_map.RoughMap().read(rmaps["cross"]), trajectory, traffic=10, seed=2)
    assert got_signals.light_states(0.0) == want_signals.light_states(0.0)
    assert [(n.lane_idx, n.s, n.cruise, n.actor_id) for n in got.npcs] == \
        [(n.lane_idx, n.s, n.cruise, n.actor_id) for n in want.npcs]
    assert got.population == want.population == 10
    for tick in range(100):
        ego = np.array([1.75, 80.0 - 0.4 * tick])
        snaps = [b.tick(ego, 8.0, replay.DT, game_time=tick * replay.DT) for b in (got, want)]
        assert [(a.position.tolist(), a.velocity.tolist(), a.yaw, a.actor_id)
                for a in snaps[0]] == \
            [(a.position.tolist(), a.velocity.tolist(), a.yaw, a.actor_id) for a in snaps[1]]
    assert got.remove_near(np.array([1.75, 40.0]), 40.0) == \
        want.remove_near(np.array([1.75, 40.0]), 40.0)


# --------------------------------------------------------------------------- #
# the phase0 CLI's collection options against the JAX CLI
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_phase0_run_eval", os.path.join(ROOT, "run_steps", "phase0_run_eval.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


PHASE0_CASES = {
    "expert": ["agent.type=expert"],
    "auto": ["agent.type=auto"],
    "collect_offsets": ["agent.type=expert", "collect_offsets=true", "repetitions=2"],
    "background_traffic": ["agent.type=expert", "background_traffic=4"],
    # the sun passes 15 degrees (WetNoon -> WetSunset) at about 17.99 h
    "weather_animation": ["agent.type=expert", "weather_animation=60",
                          "weather_start_hour=17.97"],
}


def _collect_args(tmp_path, who, extra):
    return ["--config", COLLECT_YAML,
            "routes=" + os.path.join(ROOT, "data", "routes", "cross_straight_sn.xml"),
            "map=" + CROSS_XODR, "scenarios=" + SCENARIOS, "resume=false", "max_ticks=60",
            "weather=WetNoon", "checkpoint=" + str(tmp_path / f"{who}.json"),
            "agent.data_save=" + str(tmp_path / who / "CrossWetNoon_short"), *extra]


@pytest.mark.parametrize("case", list(PHASE0_CASES))
def test_phase0_collects_like_the_jax_cli(case, map_tool, jax_cli, tmp_path, monkeypatch):
    """The port's phase0 and the JAX CLI with the same collection options:
    equal checkpoint records and equal frame trees, route by route."""
    extra = PHASE0_CASES[case]
    assert phase0.main(_collect_args(tmp_path, "port", extra)
                       + ["agent.rmap_tool=" + map_tool]) == 0
    monkeypatch.setattr(jax_rough_map, "default_tool_path", lambda: map_tool)
    monkeypatch.setattr(sys, "argv", ["phase0_run_eval.py"] + _collect_args(
        tmp_path, "jax", extra))
    jax_cli.main()
    with open(tmp_path / "port.json") as f:
        got = json.load(f)
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    for key in ("values", "labels", "entry_status", "eligible"):
        assert got[key] == want[key], key
    routes = 2 if case == "collect_offsets" else 1
    assert got["_checkpoint"]["progress"] == want["_checkpoint"]["progress"] == [routes, routes]
    rec_got, rec_want = got["_checkpoint"]["records"], want["_checkpoint"]["records"]
    assert len(rec_got) == len(rec_want) == routes
    for g, w in zip(rec_got, rec_want):
        g["meta"].pop("duration_system")
        w["meta"].pop("duration_system")
        assert g == w
    got_root, want_root = tmp_path / "port" / "CrossWetNoon_short", \
        tmp_path / "jax" / "CrossWetNoon_short"
    assert sorted(os.listdir(got_root)) == [f"route_{i:02d}" for i in range(routes)]
    for route in os.listdir(want_root):
        assert_trees_equal(str(got_root / route), str(want_root / route))
