"""The port's scenario layer against the JAX package's, on the CPU: the
catalog of scenario types, OpenSCENARIO storyboards, the actor controllers,
the lane-position helpers, the frozen sun, phase0 on an ``.xosc`` episode,
MMFN driving a storyboard and the standalone scenario runner.

- Catalog: the port's ``SCENARIO_CLASSES`` equals the JAX package's, key
  for key and class name for class name. Each of the seven atom-composed
  types, named in a placement JSON, drives the same episode through both
  packages' ``ScenarioManagerLite`` (the recordings, every tick's actor
  poses included, and the route records are equal); before the port had
  ``harness/atoms.py`` it spawned ``CrossingWalker`` for these names.
- Storyboards: every shipped ``data/scenarios/*.xosc`` parses to equal
  configs (with the straight road's rmap, through which the two
  ``LanePosition`` files resolve), and the expert drives each through both
  runners to equal recordings and records.
- Controllers, lane helpers and ``WeatherSim(animation=False)`` give the
  same numbers on the same inputs.
- The port's phase0 CLI writes the same checkpoint records and recording as
  the JAX CLI on ``follow_leading_vehicle.xosc``; ``MMFNAgent`` (n_layer 1,
  a 64-px camera, 16 lanes) drives ``cut_in_with_controller.xosc`` for 24
  ticks with waypoints within rtol 1e-4 / atol 2e-3 of the JAX agent's and
  the same record; ``scenario_run`` gives the same ``--list`` text and
  JUnit results.

Everything else is exact; recordings are compared with ``platform_time``
(wall clock) masked, records with ``duration_system`` masked. The map tool
is ``native/rough_map_node.cpp``, built with g++ into this module's own
temporary directory (not the shared ``native/build/``).
"""

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmfn_tpu.config import GlobalConfig as JaxConfig
from mmfn_tpu.data.synthetic import synthetic_batch
from mmfn_tpu.harness import actor_controls as jcontrols
from mmfn_tpu.harness import openscenario as josc
from mmfn_tpu.harness import recording as jrecording
from mmfn_tpu.harness import replay as jreplay
from mmfn_tpu.harness import scenarios as jscenarios
from mmfn_tpu.harness import weather as jweather
from mmfn_tpu.harness.agents import MMFNAgent as JaxMMFNAgent
from mmfn_tpu.harness.agents.pipeline import JitPipeline
from mmfn_tpu.harness.experts.agent import ExpertCollectionAgent as JaxExpert
from mmfn_tpu.harness.route import RouteConfig as JaxRouteConfig
from mmfn_tpu.harness.route import RouteIndexer as JaxRouteIndexer
from mmfn_tpu.harness.route import interpolate_trajectory as jinterpolate
from mmfn_tpu.mapping import rough_map as jrough_map
from mmfn_tpu.models import build_model as jax_build_model

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.harness import actor_controls, openscenario, phase0, recording, replay
from mmfn_tpu_torch.harness import scenario_run, scenarios, weather
from mmfn_tpu_torch.harness.agents import MMFNAgent
from mmfn_tpu_torch.harness.agents.base import VehicleControl
from mmfn_tpu_torch.harness.experts.agent import ExpertCollectionAgent
from mmfn_tpu_torch.harness.route import RouteConfig, RouteIndexer, interpolate_trajectory
from mmfn_tpu_torch.mapping import rough_map
from mmfn_tpu_torch.models.mmfn import MMFN
from mmfn_tpu_torch.utils.weights import from_flax_variables
from tests.test_torch_baselines import _draw
from tests.test_torch_models import _randomise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XOSC_DIR = os.path.join(ROOT, "data", "scenarios")
XOSCS = sorted(f for f in os.listdir(XOSC_DIR) if f.endswith(".xosc"))
LANE_POSITION_XOSCS = ("follow_leading_vehicle.xosc", "shoulder_merge.xosc")
CROSS_XODR = os.path.join(ROOT, "data", "maps", "fake_town_cross.xodr")
CROSS_STRAIGHT = os.path.join(ROOT, "data", "routes", "cross_straight.xml")
EVAL_YAML = os.path.join(ROOT, "run_steps", "config", "eval.yaml")
ATOM_SCENARIOS = ("OccludedObjectCrossing", "CutInFromLeftLane",
                  "SignalizedJunctionLeftTurnTraffic", "PlatoonFollowLeadingVehicle",
                  "ManeuverOppositeDirection", "OtherLeadingVehicle",
                  "SignalizedJunctionRightTurn")
WAYPOINT_TOL = dict(rtol=1e-4, atol=2e-3)
CONTROL_TOL = 1e-4
N_LAYER, RES, LANES, PPS = 1, 64, 16, 2048
STORY_TICKS = 24


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one CPU thread: the test workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
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
def maps(map_tool, tmp_path_factory):
    """name -> (OpenDRIVE string, JAX RoughMap, port RoughMap) for phase0's
    straight road (the .xosc episodes' world) and the cross town."""
    with open(CROSS_XODR) as f:
        xodrs = {"straight": phase0.FALLBACK_XODR, "cross": f.read()}
    out = {}
    for name, xodr in xodrs.items():
        d = tmp_path_factory.mktemp(name) / "opendrive"
        d.mkdir()
        (d / "opstr.txt").write_text(xodr)
        assert not rough_map.build_rmap([str(d)], tool_path=map_tool)
        rmap = str(d / "a.rmap")
        out[name] = (xodr, jrough_map.RoughMap().read(rmap), rough_map.RoughMap().read(rmap))
    return out


def _plain(obj):
    """A dataclass tree as comparable plain data, class names kept."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.dtype.str, obj.shape, obj.tolist())
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _masked(data):
    """A recording with its wall-clock fields masked."""
    data = json.loads(json.dumps(data))
    for frame in data["frames"]:
        frame.pop("platform_time")
    data["record"]["meta"].pop("duration_system")
    return data


def _masked_record(record):
    d = dict(record.__dict__)
    d["meta"] = {k: v for k, v in d["meta"].items() if k != "duration_system"}
    return d


# --------------------------------------------------------------------------- #
# the scenario catalog, and the seven atom-composed types
# --------------------------------------------------------------------------- #

def test_catalog_equals_jax():
    assert list(scenarios.SCENARIO_CLASSES) == list(jscenarios.SCENARIO_CLASSES)
    assert {k: v.__name__ for k, v in scenarios.SCENARIO_CLASSES.items()} == \
        {k: v.__name__ for k, v in jscenarios.SCENARIO_CLASSES.items()}
    for name in ATOM_SCENARIOS:
        assert scenarios.SCENARIO_CLASSES[name].__module__ == "mmfn_tpu_torch.harness.atoms"


def _run(pkg, maps, map_tool, route_file=None, xosc=None, triggers_json=None, cap=None):
    xodr, jmap, pmap = maps["cross" if route_file else "straight"]
    jax_side = pkg == "jax"
    m = jmap if jax_side else pmap
    rp = jreplay if jax_side else replay
    rec = (jrecording if jax_side else recording).EpisodeRecorder()
    agent = (JaxExpert if jax_side else ExpertCollectionAgent)({"rmap_tool": map_tool})
    manager = triggers = None
    if xosc is not None:
        osc = josc if jax_side else openscenario
        cfg = osc.parse_xosc(os.path.join(XOSC_DIR, xosc), rough_map=m)
        trajectory = [(x, y, 0.0) for x, y in osc.hero_trajectory(cfg, m)]
        config = (JaxRouteConfig if jax_side else RouteConfig)(
            route_id=xosc, town=cfg.town, trajectory=trajectory)
        manager = osc.OpenScenarioManager(cfg)
        weather_name = cfg.weather or "ClearNoon"
    else:
        config = (JaxRouteIndexer if jax_side else RouteIndexer)(route_file).next()
        trajectory = config.trajectory
        sc = jscenarios if jax_side else scenarios
        route_xy = [p for p, _ in (jinterpolate if jax_side else interpolate_trajectory)(
            trajectory)]
        triggers = sc.sample_scenarios(sc.scan_route_for_scenarios(
            route_xy, sc.parse_scenario_file(triggers_json, config.town)), seed=0)
        assert triggers
        weather_name = "ClearNoon"
    signals, _ = rp.route_environment(m, trajectory)
    record = rp.ClosedLoopRunner(max_wall_seconds=600).run_route(
        agent, config, xodr, max_ticks=cap, triggers=triggers, rough_map=m,
        signals=signals, scenario_manager=manager, recorder=rec,
        world_kwargs={"weather": weather_name, "lidar_points": 1200})
    agent.destroy()
    return record, rec.data


@pytest.mark.parametrize("name", ATOM_SCENARIOS)
def test_atom_scenario_drives_as_in_jax(maps, map_tool, tmp_path, name):
    """A placement JSON naming the type puts its trigger 40 m along the
    cross town's straight route; both runners drive the expert through it."""
    placement = tmp_path / "placement.json"
    placement.write_text(json.dumps({"available_scenarios": [{"TownCross": [{
        "scenario_type": name,
        "available_event_configurations": [{"transform": {"x": -40.0, "y": 1.75,
                                                          "yaw": 0.0}}]}]}]}))
    want, wrec = _run("jax", maps, map_tool, route_file=CROSS_STRAIGHT,
                      triggers_json=str(placement), cap=600)
    got, grec = _run("port", maps, map_tool, route_file=CROSS_STRAIGHT,
                     triggers_json=str(placement), cap=600)
    # the scenario spawned its own actors, not a crossing walker
    roles = {a["role_name"]: a for a in grec["actors"].values()}
    assert "scenario" in roles, grec["actors"]
    assert _masked(grec) == _masked(wrec)
    assert _masked_record(got) == _masked_record(want)


# --------------------------------------------------------------------------- #
# OpenSCENARIO storyboards
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("xosc", XOSCS)
def test_xosc_parses_as_in_jax(maps, xosc):
    _, jmap, pmap = maps["straight"]
    path = os.path.join(XOSC_DIR, xosc)
    want = josc.parse_xosc(path, rough_map=jmap)
    got = openscenario.parse_xosc(path, rough_map=pmap)
    assert _plain(got) == _plain(want)
    assert _plain(openscenario.hero_trajectory(got, pmap)) == \
        _plain(josc.hero_trajectory(want, jmap))
    if xosc in LANE_POSITION_XOSCS:
        # LanePosition resolves only through the map's rmap v3 ids
        with pytest.raises(Exception) as jerr:
            josc.parse_xosc(path)
        with pytest.raises(type(jerr.value), match=str(jerr.value)[:40]):
            openscenario.parse_xosc(path)
    else:
        assert _plain(openscenario.parse_xosc(path)) == _plain(josc.parse_xosc(path))


@pytest.mark.parametrize("xosc", XOSCS)
def test_xosc_episode_drives_as_in_jax(maps, map_tool, xosc):
    """The whole episode, the expert driving: every tick's actor states, the
    controls, the lights and the record are equal."""
    want, wrec = _run("jax", maps, map_tool, xosc=xosc)
    got, grec = _run("port", maps, map_tool, xosc=xosc)
    assert got.status.startswith("Completed"), got.status
    assert len(grec["frames"]) > 300
    assert _masked(grec) == _masked(wrec)
    assert _masked_record(got) == _masked_record(want)


def _step_controller(module, mod, args, ticks=80):
    """A kinematic actor stepped by one controller among two obstacles:
    every tick's (velocity, yaw) or None, and the reached-goal flag."""
    ctrl = mod.make_controller(module, args)
    ctrl.update_waypoints([(10.0, 0.5), (30.0, 3.0), (60.0, 3.5), (70.0, -2.0)])
    ctrl.update_target_speed(8.0)
    pos, yaw, speed = np.array([0.0, 0.0]), 0.05, 2.0
    obstacles = [mod.Obstacle(np.array([25.0, 2.5]), np.array([3.0, 0.0])),
                 mod.Obstacle(np.array([40.0, -8.0]), np.array([0.0, 1.0]), extent=0.5)]
    out = []
    for t in range(ticks):
        if t == 40:
            ctrl.update_target_speed(3.0)
        step = ctrl.run_step(pos.copy(), yaw, speed, 0.05, obstacles)
        if step is not None:
            vel, yaw = np.asarray(step[0], dtype=np.float64), float(step[1])
            pos = pos + vel * 0.05
            speed = float(np.linalg.norm(vel))
            step = (vel.tolist(), yaw)
        out.append((step, pos.tolist(), ctrl.reached_goal))
        for o in obstacles:
            o.position = o.position + o.velocity * 0.05
    return out


@pytest.mark.parametrize("module", sorted(jcontrols.CONTROL_REGISTRY))
@pytest.mark.parametrize("args", [{}, {"consider_obstacles": "true",
                                       "proximity_threshold": "30"}],
                         ids=["plain", "obstacles"])
def test_controller_steps_as_in_jax(module, args):
    assert sorted(actor_controls.CONTROL_REGISTRY) == sorted(jcontrols.CONTROL_REGISTRY)
    assert _step_controller(module, actor_controls, args) == \
        _step_controller(module, jcontrols, args)


def _outcome(fn, *args):
    try:
        return ("ok", _plain(fn(*args)))
    except Exception as e:          # the same refusal, with the same words
        return (type(e).__name__, str(e))


def test_lane_helpers_match_jax_on_the_cross_town(maps):
    _, jmap, pmap = maps["cross"]
    assert any(lane.road_id is not None for lane in pmap.lanes)
    rng = np.random.default_rng(4)
    points = rng.uniform(-90.0, 90.0, size=(60, 2))
    points[:20, 1] = rng.choice([-1.75, 1.75], 20)       # on the lanes
    seen = set()
    for x, y in points:
        want = _outcome(jrough_map.locate_on_lane, jmap, x, y)
        assert _outcome(rough_map.locate_on_lane, pmap, x, y) == want
        assert _outcome(rough_map.road_position_of, pmap, x, y) == \
            _outcome(jrough_map.road_position_of, jmap, x, y)
        if want[0] != "ok":
            continue
        road, lane_id, s, _ = want[1]
        seen.add((road, lane_id))
        for fn, args in (("resolve_lane_position", (road, lane_id, s, 0.4)),
                         ("resolve_lane_position", (road, lane_id, s + 500.0)),
                         ("resolve_road_position", (road, s, 0.8)),
                         ("_t_of_lane_center", (road, lane_id, s)),
                         ("_lane_at_s", (road, s))):
            assert _outcome(getattr(rough_map, fn), pmap, *args) == \
                _outcome(getattr(jrough_map, fn), jmap, *args), (fn, args)
        lane = rough_map._lane_at_s(pmap, road, s)
        jlane = jrough_map._lane_at_s(jmap, road, s)
        assert _plain(rough_map._lane_frame_at(lane, s)) == \
            _plain(jrough_map._lane_frame_at(jlane, s))
        s_dir = rough_map._lane_frame_at(lane, s)[1]
        assert _plain(rough_map._t_axis(s_dir)) == _plain(jrough_map._t_axis(s_dir))
    assert len(seen) >= 4


@pytest.mark.parametrize("animation", [False, True])
def test_weather_sim_matches_jax(animation):
    kw = dict(preset="WetCloudyNoon", animation=animation, time_scale=600.0, start_hour=16.5)
    got, want = weather.WeatherSim(**kw), jweather.WeatherSim(**kw)
    for t in np.arange(0.0, 90.0, 3.7):
        assert got.update(t) == want.update(t)
        assert (got.clock_hour, got.sun_altitude_deg, got.sun_azimuth_deg) == \
            (want.clock_hour, want.sun_altitude_deg, want.sun_azimuth_deg)
    if not animation:       # the clock runs on, the sun and the preset stand still
        assert got.current_preset() == "WetCloudyNoon"
        assert got.sun_altitude_deg == 90.0 and got.clock_hour != 16.5


# --------------------------------------------------------------------------- #
# phase0 and MMFN on a storyboard
# --------------------------------------------------------------------------- #

def _jax_cli(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "run_steps", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_phase0_xosc_matches_the_jax_cli(map_tool, tmp_path, monkeypatch):
    xosc = os.path.join(XOSC_DIR, "follow_leading_vehicle.xosc")

    def args(name):
        return ["--config", EVAL_YAML, "routes=" + xosc, "agent.type=expert",
                "resume=false", "checkpoint=" + str(tmp_path / f"{name}.json"),
                "record=" + str(tmp_path / name)]

    assert phase0.main(args("port") + ["agent.rmap_tool=" + map_tool]) == 0
    jax_cli = _jax_cli("phase0_run_eval")
    monkeypatch.setattr(jrough_map, "default_tool_path", lambda: map_tool)
    monkeypatch.setattr(sys, "argv", ["phase0_run_eval.py"] + args("jax"))
    jax_cli.main()
    got, want = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "jax"))
    for key in ("values", "labels", "entry_status", "eligible"):
        assert got[key] == want[key], key
    records = [r["_checkpoint"]["records"] for r in (got, want)]
    for rs in records:
        assert len(rs) == 1
        rs[0]["meta"].pop("duration_system")
    assert records[0] == records[1]
    assert records[0][0]["status"] == "Completed"
    rec = "follow_leading_vehicle_rep0.json"
    port_rec = json.loads((tmp_path / "port" / rec).read_text())
    jax_rec = json.loads((tmp_path / "jax" / rec).read_text())
    assert _masked(port_rec) == _masked(jax_rec)


@pytest.fixture(scope="module")
def rad_models():
    """MMFN-rad at the small template width: the JAX pipeline and the port
    model on one set of weights."""
    kw = dict(n_layer=N_LAYER, max_lanes=LANES, input_resolution=RES)
    jcfg, cfg = JaxConfig(matmul_precision="highest", **kw), GlobalConfig(attn_impl="pallas", **kw)
    jmodel = jax_build_model(jcfg, "rad")
    batch = synthetic_batch(batch_size=1, max_lanes=LANES, resolution=RES)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, batch, False))
    rng = np.random.default_rng(21)
    variables = {"params": _randomise(_draw(shapes["params"], rng), rng),
                 "batch_stats": _randomise(_draw(shapes["batch_stats"], rng), rng, stats=True)}
    with torch.device("meta"):
        port = MMFN(cfg, "rad")
    port.load_state_dict(from_flax_variables(variables, "rad", N_LAYER), strict=True, assign=True)
    port.eval()
    pipe = JitPipeline(jmodel, jax.tree.map(jnp.asarray, variables), jcfg, points_per_sweep=PPS)
    return jcfg, cfg, pipe, port


def _waypoint_log(agent, log):
    finish = agent.finish_step

    def finish_step(payload, waypoints):
        log.append(np.array(waypoints))
        return finish(payload, waypoints)
    agent.finish_step = finish_step


def test_mmfn_agent_drives_the_storyboard_as_in_jax(maps, map_tool, tmp_path, rad_models):
    """The JAX agent drives cut_in_with_controller.xosc through the JAX
    runner; the port agent sees the port runner's frames of the same
    episode, steered by the JAX agent's controls (so that a last-bit
    difference in a control cannot move the world): its waypoints and
    controls agree within the tolerances, the records and recordings are
    equal."""
    jcfg, cfg, jpipe, port = rad_models
    xodr, jmap, pmap = maps["straight"]
    path = os.path.join(XOSC_DIR, "cut_in_with_controller.xosc")
    common = {"variant": "rad", "points_per_sweep": PPS, "rmap_tool": map_tool}
    kw = dict(max_ticks=STORY_TICKS, world_kwargs={"lidar_points": 1500, "seed": 3})

    jagent = JaxMMFNAgent({**common, "pipeline": jpipe, "config": jcfg,
                           "tmp_dir": str(tmp_path / "jax")})
    jwp, jcontrols_ = [], []
    _waypoint_log(jagent, jwp)
    jrun = jagent.run_step

    def jax_step(input_data, timestamp):
        c = jrun(input_data, timestamp)
        jcontrols_.append((c.steer, c.throttle, c.brake))
        return c
    jagent.run_step = jax_step
    jcfg_x = josc.parse_xosc(path, rough_map=jmap)
    jtraj = [(x, y, 0.0) for x, y in josc.hero_trajectory(jcfg_x, jmap)]
    jrec = jrecording.EpisodeRecorder()
    want = jreplay.ClosedLoopRunner(max_wall_seconds=600).run_route(
        jagent, JaxRouteConfig(route_id="cut_in", town="T", trajectory=jtraj), xodr,
        rough_map=jmap, signals=jreplay.route_environment(jmap, jtraj)[0],
        scenario_manager=josc.OpenScenarioManager(jcfg_x), recorder=jrec, **kw)
    jagent.destroy()

    pagent = MMFNAgent({**common, "model": port, "config": cfg, "device": "cpu",
                        "tmp_dir": str(tmp_path / "port")})
    pwp, pcontrols = [], []
    _waypoint_log(pagent, pwp)
    prun = pagent.run_step

    def port_step(input_data, timestamp):
        c = prun(input_data, timestamp)
        pcontrols.append((c.steer, c.throttle, c.brake))
        return VehicleControl(*jcontrols_[len(pcontrols) - 1])
    pagent.run_step = port_step
    pcfg_x = openscenario.parse_xosc(path, rough_map=pmap)
    ptraj = [(x, y, 0.0) for x, y in openscenario.hero_trajectory(pcfg_x, pmap)]
    prec = recording.EpisodeRecorder()
    got = replay.ClosedLoopRunner(max_wall_seconds=600).run_route(
        pagent, RouteConfig(route_id="cut_in", town="T", trajectory=ptraj), xodr,
        rough_map=pmap, signals=replay.route_environment(pmap, ptraj)[0],
        scenario_manager=openscenario.OpenScenarioManager(pcfg_x), recorder=prec, **kw)
    pagent.destroy()

    assert len(pcontrols) == len(jcontrols_) == STORY_TICKS
    assert len(pwp) == len(jwp) == STORY_TICKS - 2
    for w, g in zip(jwp, pwp):
        assert g.shape == (4, 2)
        np.testing.assert_allclose(g, w, **WAYPOINT_TOL)
    np.testing.assert_allclose(np.array(pcontrols), np.array(jcontrols_), rtol=0,
                               atol=CONTROL_TOL)
    assert _masked_record(got) == _masked_record(want)
    assert len(prec.data["frames"]) == STORY_TICKS
    assert _masked(prec.data) == _masked(jrec.data)


# --------------------------------------------------------------------------- #
# the standalone scenario runner
# --------------------------------------------------------------------------- #

def test_scenario_run_lists_as_jax(capsys, monkeypatch):
    assert scenario_run.main(["--list"]) == 0
    got = capsys.readouterr().out
    monkeypatch.syspath_prepend(os.path.join(ROOT, "run_steps"))
    jax_run = _jax_cli("scenario_run")
    monkeypatch.setattr(sys, "argv", ["scenario_run.py", "--list"])
    jax_run.main()
    assert got == capsys.readouterr().out
    for name in ATOM_SCENARIOS:
        assert f"  {name}" in got


def _junit_cases(path):
    suite = ET.parse(path).getroot()
    suite.attrib.pop("time")                 # wall clock
    return suite.attrib, [(c.attrib, [(e.tag, e.attrib, e.text) for e in c]) for c in suite]


def test_scenario_run_cut_in_matches_jax(map_tool, tmp_path, monkeypatch):
    """--scenario CutInFromLeftLane --agent expert, two randomized
    repetitions, JUnit, table and recordings."""
    flags = ["--scenario", "CutInFromLeftLane", "--agent", "expert", "--repetitions", "2",
             "--randomize", "--seed", "3"]

    def outputs(name):
        return ["--junit", str(tmp_path / f"{name}.xml"), "--output",
                str(tmp_path / f"{name}.txt"), "--record", str(tmp_path / f"{name}_rec.json")]

    assert scenario_run.main(flags + outputs("port") + ["--rmap-tool", map_tool]) == 0
    monkeypatch.syspath_prepend(os.path.join(ROOT, "run_steps"))
    jax_run = _jax_cli("scenario_run")
    monkeypatch.setattr(jrough_map, "default_tool_path", lambda: map_tool)
    monkeypatch.setattr(sys, "argv", ["scenario_run.py"] + flags + outputs("jax"))
    jax_run.main()
    got, want = _junit_cases(tmp_path / "port.xml"), _junit_cases(tmp_path / "jax.xml")
    assert got == want
    assert got[0]["tests"] == "2"
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    for rep in range(2):
        port_rec = json.loads((tmp_path / f"port_rec_rep{rep}.json").read_text())
        jax_rec = json.loads((tmp_path / f"jax_rec_rep{rep}.json").read_text())
        assert _masked(port_rec) == _masked(jax_rec)
        assert any(a["type_id"] != "vehicle.lincoln.mkz2017"
                   for a in port_rec["actors"].values())
