"""The port's scored closed loop against the JAX package's, on the CPU: the
fake world, the scoring core, the map, the birdview and the phase0 CLI.

- World: ``KinematicWorld`` frames of both packages are bit-identical over
  20 ticks of scripted controls (noise or birdview camera, LiDAR and radar
  with actors in view, HardRain).
- Scoring: the same route through both ``ClosedLoopRunner``s with each
  package's ``NpcAgent`` gives equal ``RouteRecord``s: status, every
  infraction, every score and the route meta (all but the wall time).
- Checkpoint: a ``StatisticsManager`` checkpoint written by one package
  reads back equal in the other.
- Map: ``RoughMap.process_padded`` agrees exactly.
- Birdview: the port draws without cv2; its drawing calls and its whole
  raster equal cv2's pixels (the JAX package's ``BirdViewProducer``). The
  acceptance bar was 99% of the ``as_rgb`` pixels and 90% of every palette
  layer over 200 pixels; the port meets it exactly, so the tests hold it to
  equality. ``fill_poly`` of a polygon that leaves the image is held on the
  image's inner rows and columns (its docstring says why).
- CLI: the port's phase0 writes the same checkpoint records as the JAX CLI
  for ``agent.type=npc``, serves an MMFN on ``device=cpu``, and refuses each
  unported option with its ROADMAP item.

The map tool is ``native/rough_map_node.cpp``, built with g++ into this
module's own temporary directory (not the shared ``native/build/``).
"""

import importlib.util
import json
import math
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from mmfn_tpu.harness import replay as jreplay
from mmfn_tpu.harness.agents.base import AutonomousAgent as JaxAutonomousAgent
from mmfn_tpu.harness.agents.base import VehicleControl as JaxVehicleControl
from mmfn_tpu.harness.agents.trivial import NpcAgent as JaxNpcAgent
from mmfn_tpu.harness.route import parse_routes_file as jax_parse_routes_file
from mmfn_tpu.harness.scenarios import ScenarioActor as JaxScenarioActor
from mmfn_tpu.harness.scenarios import ScenarioTrigger as JaxScenarioTrigger
from mmfn_tpu.harness.scenarios import (parse_scenario_file as jax_parse_scenario_file,
                                        sample_scenarios as jax_sample_scenarios,
                                        scan_route_for_scenarios as jax_scan_route)
from mmfn_tpu.harness.statistics import StatisticsManager as JaxStatisticsManager
from mmfn_tpu.harness.traffic import signals_from_rough_map as jax_signals_from_rough_map
from mmfn_tpu.mapping import rough_map as jax_rough_map
from mmfn_tpu.mapping.birdview import BirdViewProducer as JaxBirdViewProducer

from mmfn_tpu_torch.harness import phase0, replay
from mmfn_tpu_torch.harness.agents.base import AutonomousAgent, VehicleControl
from mmfn_tpu_torch.harness.agents.trivial import NpcAgent
from mmfn_tpu_torch.harness.events import TrafficEvent, TrafficEventType
from mmfn_tpu_torch.harness.route import RouteConfig, RouteIndexer, parse_routes_file
from mmfn_tpu_torch.harness.scenarios import (ScenarioActor, ScenarioTrigger,
                                              parse_scenario_file, sample_scenarios,
                                              scan_route_for_scenarios)
from mmfn_tpu_torch.harness.statistics import StatisticsManager
from mmfn_tpu_torch.harness.traffic import signals_from_rough_map
from mmfn_tpu_torch.mapping import birdview as bv
from mmfn_tpu_torch.mapping.rough_map import RoughMap, build_rmap
from tests.test_device_world import CURVED_XODR
from tests.test_harness import STRAIGHT_XODR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROSS_XODR = os.path.join(ROOT, "data", "maps", "fake_town_cross.xodr")
SCENARIOS = os.path.join(ROOT, "data", "scenarios", "fake_towns_scenarios.json")
EVAL_YAML = os.path.join(ROOT, "run_steps", "config", "eval.yaml")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one CPU thread here: the test workers share the CPU, and
    torch's own thread pool oversubscribes it (with six workers this
    module's forwards ran 10-30 times slower than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tool(tmp_path_factory):
    """native/rough_map_node.cpp built into this module's own directory."""
    path = tmp_path_factory.mktemp("rough_map_node") / "rough_map_node"
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", str(path),
                    os.path.join(ROOT, "native", "rough_map_node.cpp")],
                   check=True, capture_output=True, timeout=300)
    return str(path)


@pytest.fixture(scope="module")
def rmaps(tool, tmp_path_factory):
    """name -> (OpenDRIVE string, .rmap path) for the three test maps."""
    with open(CROSS_XODR) as f:
        xodrs = {"cross": f.read(), "curved": CURVED_XODR, "straight": STRAIGHT_XODR}
    out = {}
    for name, xodr in xodrs.items():
        d = tmp_path_factory.mktemp(name) / "opendrive"
        d.mkdir()
        (d / "opstr.txt").write_text(xodr)
        assert not build_rmap([str(d)], tool_path=tool)
        out[name] = (xodr, str(d / "a.rmap"))
    return out


# --------------------------------------------------------------------------- #
# the fake world
# --------------------------------------------------------------------------- #

def _actors(cls, t):
    """A vehicle ahead, a walker crossing and a hidden vehicle, at tick t."""
    return [cls("vehicle", np.array([12.0 + 0.3 * t, 2.5]), np.array([6.0, 0.0]),
                yaw=0.1, extent=2.0, actor_id=1),
            cls("walker", np.array([8.0, -3.0 + 0.2 * t]), np.array([0.0, 4.0]),
                yaw=1.5, extent=0.5, actor_id=7),
            cls("vehicle", np.array([5.0, 6.0]), np.array([0.0, 0.0]),
                extent=2.2, actor_id=3, visible_sensors=False, visible_graphics=False)]


def _controls(t):
    return VehicleControl(steer=0.3 * math.sin(t / 3.0), throttle=0.8 if t % 5 else 0.2,
                          brake=0.4 if t % 7 == 6 else 0.0)


@pytest.mark.parametrize("camera", ["noise", "birdview"])
def test_world_frames_are_bit_identical(rmaps, camera):
    xodr, rmap = rmaps["straight"]
    kw = dict(seed=11, lidar_points=1200, weather="HardRainNoon")
    jworld = jreplay.KinematicWorld(xodr, (0.0, 1.75, 0.02), **kw)
    world = replay.KinematicWorld(xodr, (0.0, 1.75, 0.02), **kw)
    if camera == "birdview":
        jworld.camera_birdview = JaxBirdViewProducer(jax_rough_map.RoughMap().read(rmap))
        world.camera_birdview = bv.BirdViewProducer(RoughMap().read(rmap))
        jworld.signals = jax_signals_from_rough_map(jax_rough_map.RoughMap().read(rmap),
                                                    [(float(x), 1.75) for x in range(60)])
        world.signals = signals_from_rough_map(RoughMap().read(rmap),
                                               [(float(x), 1.75) for x in range(60)])
    for t in range(20):
        jworld.actors, world.actors = _actors(JaxScenarioActor, t), _actors(ScenarioActor, t)
        want, got = jworld.sensor_frame(), world.sensor_frame()
        assert sorted(got) == sorted(want)
        for tag, (frame, payload) in want.items():
            assert got[tag][0] == frame, tag
            if isinstance(payload, dict):
                assert got[tag][1] == payload, tag
            else:
                assert got[tag][1].dtype == payload.dtype, tag
                np.testing.assert_array_equal(got[tag][1], payload, err_msg=f"{tag} at {t}")
        jworld.tick(_controls(t))
        world.tick(_controls(t))
        assert (world.x, world.y, world.yaw, world.v) == (jworld.x, jworld.y, jworld.yaw, jworld.v)


def test_world_refuses_unported_options(rmaps):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 2"):
        replay.route_environment(RoughMap().read(rmaps["straight"][1]),
                                 [(0.0, 1.75, 0.0), (50.0, 1.75, 0.0)], traffic=3)


# --------------------------------------------------------------------------- #
# scoring
# --------------------------------------------------------------------------- #

def _record_dict(record):
    d = dict(record.to_dict())
    d["meta"] = {k: v for k, v in d["meta"].items() if k != "duration_system"}
    return d


def _route(name):
    if name == "cross":
        return parse_routes_file(os.path.join(ROOT, "data", "routes", "cross_left_turn.xml"))[0]
    return RouteConfig(route_id="0", town="TownTest",
                       trajectory=[(0.0, 1.75, 0.0), (60.0, 1.75, 0.0), (130.0, 1.75, 0.0)])


@pytest.mark.parametrize("name", ["cross", "straight"])
def test_npc_route_scores_equal_in_both_packages(rmaps, name):
    """One NpcAgent route in each package, with the map's traffic lights, the
    outside-lanes criterion and scenario triggers: equal records."""
    xodr, rmap = rmaps[name]
    config = _route(name)
    plan = [p for p, _ in replay.plan_from_trajectory(config.trajectory)[1]]
    if name == "cross":
        triggers = sample_scenarios(scan_route_for_scenarios(
            plan, parse_scenario_file(SCENARIOS, config.town)), seed=0)
        jtriggers = jax_sample_scenarios(jax_scan_route(
            plan, jax_parse_scenario_file(SCENARIOS, config.town)), seed=0)
    else:
        triggers = [ScenarioTrigger(40.0, 1.75, 0.0, "Scenario3"),
                    ScenarioTrigger(90.0, 1.75, 0.0, "Scenario2")]
        jtriggers = [JaxScenarioTrigger(t.x, t.y, t.yaw, t.scenario_type) for t in triggers]
    assert len(triggers) >= 2
    records = []
    for mod, agent, rough, sig, trig in (
            (replay, NpcAgent(), RoughMap().read(rmap), signals_from_rough_map, triggers),
            (jreplay, JaxNpcAgent(), jax_rough_map.RoughMap().read(rmap),
             jax_signals_from_rough_map, jtriggers)):
        signals = sig(rough, plan)
        records.append(mod.ClosedLoopRunner(max_wall_seconds=600).run_route(
            agent, config, xodr, triggers=trig, rough_map=rough, signals=signals,
            world_kwargs={"seed": 4}))
        if name == "cross":
            assert signals.lights, "the cross town has signalized junctions"
    got, want = records
    assert _record_dict(got) == _record_dict(want)
    assert any(got.infractions.values()) or got.status == "Completed"


def _recorder(base, control):
    """An agent that records which sensor entries (tag -> frame) each tick
    hands it."""
    class Recorder(base):
        def setup(self, conf):
            self.seen = []

        def run_step(self, input_data, timestamp):
            self.seen.append({tag: frame for tag, (frame, _) in input_data.items()})
            return control(steer=0.05, throttle=0.6)
    return Recorder()


def test_agents_see_the_same_sensor_ticks(rmaps):
    """Each runner hands its agent the same entries on every tick, through
    the sensor mux: the opendrive map on the first tick, which the e2e
    agents' map bootstrap waits for."""
    xodr, rmap = rmaps["cross"]
    config = _route("cross")
    plan = [p for p, _ in replay.plan_from_trajectory(config.trajectory)[1]]
    agents = []
    for mod, agent, rough, sig in (
            (replay, _recorder(AutonomousAgent, VehicleControl), RoughMap().read(rmap),
             signals_from_rough_map),
            (jreplay, _recorder(JaxAutonomousAgent, JaxVehicleControl),
             jax_rough_map.RoughMap().read(rmap), jax_signals_from_rough_map)):
        mod.ClosedLoopRunner(max_wall_seconds=600).run_route(
            agent, config, xodr, max_ticks=12, rough_map=rough, signals=sig(rough, plan))
        agents.append(agent)
    got, want = agents[0].seen, agents[1].seen
    assert len(got) == 12 and "opendrive" in got[0]
    assert got == want


def test_checkpoint_reads_in_both_packages(tmp_path):
    """Records, progress and the global record written by one package read
    back equal in the other, both ways."""
    events = [TrafficEvent(TrafficEventType.COLLISION_VEHICLE, "collided with 3"),
              TrafficEvent(TrafficEventType.TRAFFIC_LIGHT_INFRACTION, "ran a red light 0"),
              TrafficEvent(TrafficEventType.ROUTE_COMPLETION, "completed 40%",
                           {"route_completed": 40.0}),
              TrafficEvent(TrafficEventType.OUTSIDE_ROUTE_LANES_INFRACTION, "outside",
                           {"percentage": 12.5})]
    for writer_cls, reader_cls in ((StatisticsManager, JaxStatisticsManager),
                                   (JaxStatisticsManager, StatisticsManager)):
        path = str(tmp_path / f"{writer_cls.__module__}.json")
        writer = writer_cls()
        for i in range(3):
            writer.set_route(str(i), i)
            rec = writer.compute_route_statistics(i, 120.0 + i, events[i:],
                                                  duration_time_game=10.0 * i,
                                                  timed_out=i == 2)
            writer.save_record(rec, i, path)
            writer.save_progress(i + 1, 3, path)
        writer.save_global_record(writer.compute_global_statistics(3), 3, path)
        reader = reader_cls()
        reader.resume(path)
        assert [r.to_dict() for r in reader.records] == [r.to_dict() for r in writer.records]
        g_w, g_r = (writer.compute_global_statistics(3).to_dict(),
                    reader.compute_global_statistics(3).to_dict())
        assert json.dumps(g_w, sort_keys=True) == json.dumps(g_r, sort_keys=True)
        indexer = RouteIndexer(os.path.join(ROOT, "data", "routes", "benchmark_cross.xml"))
        indexer.resume(path)                 # progress [3, 3]: the 4th route is next
        assert indexer.next().index == 3 and not indexer.peek()


def test_route_files_parse_as_in_jax():
    routes = os.path.join(ROOT, "data", "routes")
    for name in sorted(os.listdir(routes)):
        got = parse_routes_file(os.path.join(routes, name))
        want = jax_parse_routes_file(os.path.join(routes, name))
        assert [vars(c) for c in got] == [vars(c) for c in want], name


# --------------------------------------------------------------------------- #
# the map and its birdview
# --------------------------------------------------------------------------- #

def test_lane_crop_matches_jax(rmaps):
    rng = np.random.default_rng(2)
    for name in ("cross", "curved"):
        rmap = rmaps[name][1]
        got_map, want_map = RoughMap().read(rmap), jax_rough_map.RoughMap().read(rmap)
        nodes = np.concatenate([lane.nodes[:, :2] for lane in got_map.lanes])
        poses = [(*nodes[rng.integers(len(nodes))], rng.uniform(-math.pi, math.pi))
                 for _ in range(9)] + [(5000.0, 5000.0, 0.0)]     # far: the empty crop
        for pose in poses:
            got, got_n = got_map.process_padded(np.array(pose), 16)
            want, want_n = want_map.process_padded(np.array(pose), 16)
            assert got_n == want_n
            np.testing.assert_array_equal(got, want)


def test_drawing_calls_match_cv2():
    rng = np.random.default_rng(0)
    for _ in range(400):
        n = int(rng.integers(2, 7))
        inside = rng.integers(0, 2) == 1
        pts = rng.integers(5, 55, (n + 1, 2)) if inside else rng.integers(-40, 110, (n + 1, 2))
        pts = pts.astype(np.int32)
        want, got = np.zeros((60, 70), np.uint8), np.zeros((60, 70), np.uint8)
        cv2.polylines(want, [pts], False, 255, 1)
        bv.polyline(got, pts, 255)
        np.testing.assert_array_equal(got, want)
        want[:], got[:] = 0, 0
        cv2.fillPoly(want, [pts], 255)
        bv.fill_poly(got, pts, 255)
        if inside:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_equal(got[1:-1, 1:-1], want[1:-1, 1:-1])
        want[:], got[:] = 0, 0
        (cx, cy), r = rng.integers(-15, 85, 2), int(rng.integers(0, 20))
        cv2.circle(want, (int(cx), int(cy)), r, 255, -1)
        bv.fill_circle(got, int(cx), int(cy), r, 255)
        np.testing.assert_array_equal(got, want)
    src = (rng.random((366, 366, 9)) < 0.3).astype(np.uint8) * 255
    src[..., 0] = rng.integers(0, 256, (366, 366))
    for angle in (0.0, 90.0, -180.0, 33.3, -71.92, 45.0, 271.5, 1e-3):
        want = cv2.warpAffine(src, cv2.getRotationMatrix2D((183, 183), angle, 1.0),
                              (366, 366))
        np.testing.assert_array_equal(bv.rotate(src, 183, angle, slice(55, 311)),
                                      want[55:311, 55:311])


@pytest.mark.parametrize("name", ["curved", "cross"])
def test_birdview_matches_cv2(rmaps, name):
    rmap = rmaps[name][1]
    want_bv = JaxBirdViewProducer(jax_rough_map.RoughMap().read(rmap))
    got_bv = bv.BirdViewProducer(RoughMap().read(rmap))
    for layer in ("_road", "_lanes_mask", "_center"):
        np.testing.assert_array_equal(getattr(got_bv, layer), getattr(want_bv, layer))
    rng = np.random.default_rng(5)
    nodes = np.concatenate([lane.nodes[:, :2] for lane in RoughMap().read(rmap).lanes])
    for _ in range(4):
        x, y = nodes[rng.integers(len(nodes))]
        pose = (float(x), float(y), float(rng.uniform(-math.pi, math.pi)))
        actors = [(x + rng.uniform(-30, 30), y + rng.uniform(-30, 30), rng.uniform(-3, 3),
                   4.0, 2.8) for _ in range(4)]
        walkers = [(x + rng.uniform(-15, 15), y + rng.uniform(-15, 15), rng.uniform(-3, 3),
                    0.8, 0.56) for _ in range(2)]
        lights = [(x + rng.uniform(-20, 20), y + rng.uniform(-20, 20), s)
                  for s in ("red", "yellow", "green")]
        want = want_bv.produce(pose, actors=actors, lights=lights, walkers=walkers)
        got = got_bv.produce(pose, actors=actors, lights=lights, walkers=walkers)
        assert got.shape == want.shape == (256, 256, bv.N_MASKS)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(bv.BirdViewProducer.as_rgb(got),
                                      JaxBirdViewProducer.as_rgb(want))


# --------------------------------------------------------------------------- #
# the phase0 CLI
# --------------------------------------------------------------------------- #

def _cli_args(tool, checkpoint, *extra):
    return ["--config", EVAL_YAML, "routes=" + os.path.join(ROOT, "data", "routes",
                                                           "cross_straight.xml"),
            "map=" + CROSS_XODR, "scenarios=" + SCENARIOS, "resume=false",
            "checkpoint=" + str(checkpoint), "agent.rmap_tool=" + tool, *extra]


def test_phase0_npc_matches_the_jax_cli(tool, tmp_path, monkeypatch):
    assert phase0.main(_cli_args(tool, tmp_path / "port.json", "agent.type=npc",
                                 "max_ticks=80", "repetitions=2", "device=cpu")) == 0
    spec = importlib.util.spec_from_file_location(
        "jax_phase0_run_eval", os.path.join(ROOT, "run_steps", "phase0_run_eval.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    monkeypatch.setattr(jax_rough_map, "default_tool_path", lambda: tool)
    monkeypatch.setattr(sys, "argv", ["phase0_run_eval.py"] + [
        a for a in _cli_args(tool, tmp_path / "jax.json", "agent.type=npc", "max_ticks=80",
                             "repetitions=2") if not a.startswith("agent.rmap_tool")])
    jax_cli.main()
    with open(tmp_path / "port.json") as f:
        got = json.load(f)
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    for key in ("values", "labels", "entry_status", "eligible"):
        assert got[key] == want[key], key
    assert got["_checkpoint"]["progress"] == want["_checkpoint"]["progress"] == [2, 2]
    rec_got, rec_want = got["_checkpoint"]["records"], want["_checkpoint"]["records"]
    assert len(rec_got) == len(rec_want) == 2
    for g, w in zip(rec_got, rec_want):
        g["meta"].pop("duration_system")
        w["meta"].pop("duration_system")
        assert g == w


def test_phase0_serves_an_mmfn_on_the_cpu(tool, tmp_path):
    """agent.type=e2e (vec) at n_layer 1 and 16 lanes through TorchPipeline:
    every record is scored and finite."""
    path = tmp_path / "vec.json"
    assert phase0.main(_cli_args(tool, path, "agent.variant=vec", "agent.n_layer=1",
                                 "agent.max_lanes=16", "agent.attn_impl=pallas",
                                 "max_ticks=6", "device=cpu")) == 0
    with open(path) as f:
        records = json.load(f)["_checkpoint"]["records"]
    assert len(records) == 1
    assert records[0]["status"].startswith(("Failed", "Completed"))
    assert np.isfinite(records[0]["scores"]["score_composed"])
    assert records[0]["meta"]["duration_game"] == pytest.approx(0.3)


@pytest.mark.parametrize("override, item", [
    ("simulator=carla", "item 2"), ("routes=x.xosc", "item 2"),
    ("background_traffic=4", "item 2"), ("weather_animation=true", "item 2"),
    ("record=recs", "item 2"), ("agent.type=expert", "item 2"), ("agent.type=auto", "item 2"),
    ("agent.type=remote", "item 2"), ("agent.fleet_devices=2", "item 4"),
], ids=lambda v: v.split("=")[0] if "=" in v else v)
def test_phase0_refuses_unported_options(tmp_path, override, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 {item}"):
        phase0.main(["--config", EVAL_YAML, "resume=false",
                     "checkpoint=" + str(tmp_path / "x.json"), override])
    assert not (tmp_path / "x.json").exists()


def test_phase0_refuses_expert_offsets(tmp_path):
    with pytest.raises(NotImplementedError, match="collect_offsets.*ROADMAP queue 1 item 2"):
        phase0.main(["--config", EVAL_YAML, "collect_offsets=true", "agent.type=expert"])
