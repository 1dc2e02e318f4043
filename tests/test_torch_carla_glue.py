"""The port's CARLA glue, its copy of the carla mock, phase0's
``simulator: carla`` and the compile cache, against the JAX package, on
the CPU.

The JAX glue runs on the JAX package's mock (``tests/fake_carla``), the
port's on the port's own copy (``mmfn_tpu_torch/harness/fake_carla``),
each installed only while its run lasts. As in
tests/test_carla_glue_e2e.py, the glue's per-tick watchdog is kept but
loosened from 2 s to 60 s here: the test workers share the CPU and stall
on first-tick map builds (the 2 s budget is held on the GPU by
``chip_smoke.py``).

The glue's sensor readers are threads that poll the game clock, so the
speed reading an agent gets on a tick depends on thread timing: two runs
of the JAX glue on one mock do not hand their agent the same inputs tick for
tick. The model agents are therefore held by record and replay: every
``input_data`` the port's glue hands its agent is recorded and replayed
through the JAX ``MMFNAgent`` on the same weights (n_layer 1, a 64-px
camera, 16 lanes, 2,048 points a sweep, carried with ``from_flax_variables``
as in tests/test_torch_agent.py).

Tolerances: controls 1e-4; waypoints rtol 1e-4 / atol 2e-3 (those of
tests/test_torch_agent.py) with the rtol taken against each tick's largest
waypoint coordinate rather than element by element. On the mock's bright
gradient camera the random weights put the waypoints at about 400 m, and
both packages' float32 forwards land 1e-3 to 3e-3 from a float64 forward of
the same weights (the port's model in float64 against both on the recorded
inputs of the rad run): an element near 40 m then differs by up to 7e-3,
which an element-wise rtol would refuse. Parsers, mock payloads, the data
provider and the expert's records exact. Checkpoint JSONs are compared
without ``meta.duration_system`` of each record, the only wall-clock field.
"""

import contextlib
import copy
import importlib
import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import mmfn_tpu.mapping.rough_map as jax_rough_map
from mmfn_tpu.config import GlobalConfig as JaxConfig
from mmfn_tpu.harness import carla_glue as jax_glue_module
from mmfn_tpu.harness.agents import MMFNAgent as JaxMMFNAgent
from mmfn_tpu.harness.experts.agent import ExpertCollectionAgent as JaxExpert
from mmfn_tpu.harness.route import RouteConfig as JaxRouteConfig
from mmfn_tpu.harness.route import RouteIndexer as JaxRouteIndexer
from mmfn_tpu.harness.statistics import StatisticsManager as JaxStatistics
from mmfn_tpu.harness.watchdog import Watchdog as JaxWatchdog

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.harness import fake_carla, phase0
from mmfn_tpu_torch.harness.agents import MMFNAgent
from mmfn_tpu_torch.harness.experts.agent import ExpertCollectionAgent
from mmfn_tpu_torch.harness.route import RouteConfig, RouteIndexer
from mmfn_tpu_torch.harness.sensor_interface import SensorInterface
from mmfn_tpu_torch.harness.statistics import StatisticsManager
from mmfn_tpu_torch.harness.watchdog import Watchdog
from mmfn_tpu_torch.utils import compile_cache
from tests.test_harness import STRAIGHT_XODR
from tests.test_torch_agent import CONTROL_TOL, PPS, WAYPOINT_TOL, _configs, models  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_YAML = os.path.join(ROOT, "run_steps", "config", "eval.yaml")
LOOSE_WATCHDOG_S = 60.0
EXPERT_ROUTE = [(0.0, 1.75, 0.0), (40.0, 1.75, 0.0)]
MODEL_ROUTE = [(0.0, 1.75, 0.0), (60.0, 1.75, 0.0)]
MODEL_ROUTE_SECONDS = 0.575        # 12 ticks: 2 warm-up, 10 forwards
CARLA_CFG = {"host": "localhost", "port": 2000, "timeout": 5.0}


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


@pytest.fixture()
def loose_watchdog(monkeypatch):
    """Every Watchdog of either package built while the test runs allows
    60 s a tick (the glues bind the class at each reload, so its
    constructor is patched)."""
    for cls in (Watchdog, JaxWatchdog):
        monkeypatch.setattr(cls, "__init__", lambda self, timeout=1.0, on_timeout=None,
                            init=cls.__init__: init(self, LOOSE_WATCHDOG_S, on_timeout))


_CARLA_MODULES = ("carla", "agents", "agents.navigation",
                  "agents.navigation.global_route_planner")


@contextlib.contextmanager
def jax_carla():
    """tests/fake_carla as ``carla`` and the JAX glue reloaded onto it, as
    tests/test_carla_glue_e2e.py's fixture does; undone on exit."""
    import tests.fake_carla as fc
    from tests.fake_carla import navigation as nav

    saved = {k: sys.modules.get(k) for k in _CARLA_MODULES}
    agents_pkg = types.ModuleType("agents")
    navigation_pkg = types.ModuleType("agents.navigation")
    agents_pkg.navigation = navigation_pkg
    navigation_pkg.global_route_planner = nav
    sys.modules.update({"carla": fc, "agents": agents_pkg, "agents.navigation": navigation_pkg,
                        "agents.navigation.global_route_planner": nav})
    fc.TOWN_MAPS["TownTest"] = STRAIGHT_XODR
    try:
        yield importlib.reload(jax_glue_module), fc
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
        importlib.reload(jax_glue_module)


@contextlib.contextmanager
def port_carla():
    glue = fake_carla.install({"TownTest": STRAIGHT_XODR})
    try:
        yield glue, fake_carla
    finally:
        fake_carla.uninstall()


@contextlib.contextmanager
def fresh_actor_ids(*mocks):
    """Both mocks number their actors from 1 (their sensors seed their
    generators with the world seed plus the actor id)."""
    saved = [m.Actor._next_id[0] for m in mocks]
    for m in mocks:
        m.Actor._next_id[0] = 1
    try:
        yield
    finally:
        for m, n in zip(mocks, saved):
            m.Actor._next_id[0] = n


def _evaluate(glue, route_cfg_cls, indexer_cls, statistics_cls, build_agent, trajectory,
              endpoint):
    indexer = indexer_cls.from_configs([route_cfg_cls(route_id="0", town="TownTest",
                                                      trajectory=trajectory, index=0)])
    glue.run_carla_evaluation(CARLA_CFG, indexer, statistics_cls(), build_agent, endpoint)
    with open(endpoint) as f:
        return json.load(f)


def _without_wall_clock(data):
    data = copy.deepcopy(data)
    for rec in data["_checkpoint"]["records"]:
        rec["meta"].pop("duration_system")
    return data


def _plain(x):
    """Dataclasses, arrays and enums as nested builtins, for ==."""
    if hasattr(x, "__dataclass_fields__"):
        return {k: _plain(getattr(x, k)) for k in x.__dataclass_fields__}
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "value") and hasattr(x, "name"):
        return (x.name, x.value)
    return x


# --------------------------------------------------------------------------- #
# parsers and pseudo-sensors
# --------------------------------------------------------------------------- #

def _payloads(fc):
    rng = np.random.default_rng(7)
    tf = fc.Transform(fc.Location(3.0, -2.0, 0.5), fc.Rotation(yaw=37.5))
    lat, lon, alt = 49.1234, 8.4321, 3.5
    return {
        "camera": fc._CameraData(30, 40, 5),
        "lidar": fc._LidarData(rng, 5),
        "radar": fc._RadarData(rng, 5),
        "gnss": fc._GnssData(lat, lon, alt, 5),
        "imu": fc._ImuData(tf, 5),
    }


PARSERS = {
    "parse_image": "camera", "parse_lidar": "lidar", "parse_radar": "radar",
    "parse_gnss": "gnss", "parse_imu": "imu", "parse_imu_world_yaw": "imu",
}


@pytest.mark.parametrize("name", sorted(PARSERS))
def test_parser_matches_jax(name):
    from mmfn_tpu_torch.harness import carla_glue as glue

    data = _payloads(fake_carla)[PARSERS[name]]
    got, want = getattr(glue, name)(data), getattr(jax_glue_module, name)(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_geodesy_matches_jax():
    """latlon_ref_from_opendrive and _LinearGnssParser on the mock's own
    GNSS readings (geodetic, through the port's location_to_gps)."""
    from mmfn_tpu.control.planner import gps_to_location as jax_from_gps
    from mmfn_tpu.control.planner import location_to_gps as jax_to_gps
    from mmfn_tpu_torch.control.planner import gps_to_location, location_to_gps
    from mmfn_tpu_torch.harness import carla_glue as glue

    geo = """<OpenDRIVE><header><geoReference><![CDATA[+proj=tmerc +lat_0=49.5
    +lon_0=8.25 +k=1]]></geoReference></header></OpenDRIVE>"""
    for xodr in (geo, STRAIGHT_XODR, "<OpenDRIVE/>", "not xml"):
        assert glue.latlon_ref_from_opendrive(xodr) == \
            jax_glue_module.latlon_ref_from_opendrive(xodr)
    ref = glue.latlon_ref_from_opendrive(geo)
    for x, y, z in ((0.0, 0.0, 0.0), (210.5, -87.25, 1.5), (-400.0, 250.0, 0.0)):
        gps = location_to_gps(x, y, z, *ref)
        assert gps == jax_to_gps(x, y, z, *ref)
        assert gps_to_location(*gps, *ref) == jax_from_gps(*gps, *ref)
        data = fake_carla._GnssData(*gps, 3)
        np.testing.assert_array_equal(glue._LinearGnssParser(*ref)(data),
                                      jax_glue_module._LinearGnssParser(*ref)(data))


def test_callback_and_speedometer_match_jax():
    """_Callback's routing into the sensor mux, and SpeedometerReader's
    forward speed, through both packages' SensorInterface."""
    from mmfn_tpu.harness.game_time import GameTime as JaxGameTime
    from mmfn_tpu.harness.sensor_interface import SensorInterface as JaxSensorInterface
    from mmfn_tpu_torch.harness import carla_glue as glue
    from mmfn_tpu_torch.harness.game_time import GameTime

    out = []
    for mod, si_cls, clock in ((glue, SensorInterface, GameTime),
                               (jax_glue_module, JaxSensorInterface, JaxGameTime)):
        si = si_cls()
        si.register_sensor("lidar")
        si.register_sensor("speed")
        mod._Callback("lidar", "sensor.lidar.ray_cast", si)(_payloads(fake_carla)["lidar"])
        clock.restart()
        vehicle = types.SimpleNamespace(
            get_velocity=lambda: fake_carla.Vector3D(3.0, 4.0, 0.5),
            get_transform=lambda: fake_carla.Transform(
                rotation=fake_carla.Rotation(pitch=4.0, yaw=50.0)))
        reader = mod.SpeedometerReader(vehicle, "speed", si, reading_frequency=20)
        clock.on_carla_tick((1, 0.05))
        try:
            data = si.get_data()
        finally:
            reader.stop()
            reader.join(1.0)
        out.append((data["lidar"][0], data["lidar"][1].tolist(), data["speed"][1]["speed"]))
    assert out[0] == out[1]


def test_world_view_matches_jax():
    """world_view_from_carla on one mock world, port against JAX: vehicles
    and a walker inside and outside the 30 m radius, and stop signs ahead,
    behind and too far."""
    from mmfn_tpu_torch.harness import carla_glue as glue

    fc = fake_carla
    world = fc.World("TownTest", STRAIGHT_XODR)
    lib = world.get_blueprint_library()
    ego = world.spawn_actor(lib.find("vehicle.lincoln.mkz2017"),
                            fc.Transform(fc.Location(5.0, 1.75), fc.Rotation(yaw=10.0)))
    ego.speed = 4.0
    for x, y, yaw in ((15.0, 1.75, 0.0), (-10.0, -1.75, 180.0), (60.0, 1.75, 0.0)):
        v = world.spawn_actor(lib.find("vehicle.audi.tt"),
                              fc.Transform(fc.Location(x, y), fc.Rotation(yaw=yaw)))
        v.speed = 2.5
    world.spawn_actor(lib.find("walker.pedestrian.0001"), fc.Transform(fc.Location(9.0, 5.0)))
    for x in (13.0, -3.0, 45.0):
        stop = world.spawn_actor(fc.Blueprint("traffic.stop"), fc.Transform(fc.Location(x, 0.0)))
        stop.trigger_volume = fc._TriggerVolume(fc.Location(0.0, 1.0, 0.0))
    got = glue.world_view_from_carla(world, ego)
    want = jax_glue_module.world_view_from_carla(world, ego)
    assert len(got.vehicles) == 2 and len(got.walkers) == 1 and got.stop_sign
    assert _plain(got) == _plain(want)


def test_interpolate_route_matches_jax():
    """interpolate_route_carla over each package's route planner shim."""
    keypoints = [(0.0, 1.75, 0.0), (23.5, 1.75, 0.0), (23.5, 40.0, 0.0)]
    with jax_carla() as (glue, fc):
        want = glue.interpolate_route_carla(fc.Map("TownTest", STRAIGHT_XODR), keypoints)
    with port_carla() as (glue, fc):
        got = glue.interpolate_route_carla(fc.Map("TownTest", STRAIGHT_XODR), keypoints)
    assert len(got) == len(want) == 63
    assert [(xy, int(opt)) for xy, opt in got] == [(xy, int(opt)) for xy, opt in want]


# --------------------------------------------------------------------------- #
# the mock
# --------------------------------------------------------------------------- #

def _drive_mock(fc, ticks=40):
    """Every sensor the glue spawns on an ego, two autopilot NPCs (one close
    enough to collide), ``ticks`` ticks of a scripted control; returns each
    callback's payload as builtins."""
    client = fc.Client()
    world = client.load_world("TownTest")
    settings = world.get_settings()
    settings.fixed_delta_seconds = 0.05
    world.apply_settings(settings)
    lib = world.get_blueprint_library()
    ego = world.spawn_actor(lib.find("vehicle.lincoln.mkz2017"),
                            fc.Transform(fc.Location(0.0, 1.75, 0.5)))
    for x in (4.5, 30.0):
        npc = world.try_spawn_actor(lib.find("vehicle.tesla.model3"),
                                    fc.Transform(fc.Location(x, 1.75, 0.2)))
        npc.set_autopilot(True)
    log = []
    for stype in ("sensor.camera.rgb", "sensor.lidar.ray_cast", "sensor.other.radar",
                  "sensor.other.gnss", "sensor.other.imu", "sensor.other.collision"):
        bp = lib.find(stype)
        if stype.startswith("sensor.camera"):
            bp.set_attribute("image_size_x", "40")
            bp.set_attribute("image_size_y", "30")
        sensor = world.spawn_actor(bp, fc.Transform(fc.Location(1.3, 0.0, 2.5)), attach_to=ego)

        def callback(data, stype=stype):
            fields = {k: v for k, v in vars(data).items() if k not in ("actor", "other_actor")}
            if "other_actor" in vars(data):
                fields["other"] = data.other_actor.type_id
            for k in ("accelerometer", "gyroscope"):
                if k in fields:
                    fields[k] = vars(fields[k])
            if "transform" in fields:
                t = fields["transform"]
                fields["transform"] = (vars(t.location), vars(t.rotation))
            log.append((stype, fields))
        sensor.listen(callback)
    for t in range(ticks):
        ego.apply_control(fc.VehicleControl(throttle=0.6, steer=0.3 * math.sin(0.2 * t),
                                            brake=0.1 * (t % 7 == 0)))
        world.tick()
    return log


def test_mock_copy_gives_the_same_payloads():
    """The port's fake_carla against tests/fake_carla: the same seeds and
    controls give byte-equal sensor payloads over 40 ticks."""
    import tests.fake_carla as jax_fc

    jax_fc.TOWN_MAPS["TownTest"] = fake_carla.TOWN_MAPS["TownTest"] = STRAIGHT_XODR
    with fresh_actor_ids(jax_fc, fake_carla):
        want = _drive_mock(jax_fc)
    with fresh_actor_ids(jax_fc, fake_carla):
        got = _drive_mock(fake_carla)
    assert len(got) == len(want) >= 5 * 40 + 1          # one collision at least
    assert sum(stype.endswith("collision") for stype, _ in got) >= 1
    assert got == want


# --------------------------------------------------------------------------- #
# CarlaDataProvider, background traffic and weather
# --------------------------------------------------------------------------- #

def _provider_and_traffic(glue, fc):
    """tests/test_carla_glue_e2e.py's data-provider and traffic cases, with
    what they observe returned rather than asserted."""
    out = {}
    client = fc.Client()
    world = client.load_world("TownTest")
    actors = glue.spawn_background_traffic(client, world, "TownTest")
    glue.set_weather(world, "ClearNoon")
    x0 = [a.get_location().x for a in actors]
    for _ in range(40):
        world.tick()
    out["traffic"] = [(x, a.get_location().x, a.get_location().y) for a, x in zip(actors, x0)]
    out["weather"] = repr(world._weather)

    P = glue.CarlaDataProvider
    client = fc.Client()
    world = client.load_world("TownTest")
    settings = world.get_settings()
    settings.synchronous_mode = True
    settings.fixed_delta_seconds = 0.05
    world.apply_settings(settings)
    P.cleanup()
    P.set_client(client)
    P.set_world(world)
    out["sync"] = P.is_sync_mode() and P.get_map() is world.get_map()
    out["spawn_points"] = [(t.location.x, t.location.y) for t in P.generate_spawn_points()]
    actors = P.request_new_batch_actors("vehicle.*", 4, P.generate_spawn_points(),
                                        autopilot=True)
    out["batch"] = [(a.type_id, a.get_location().x, P.actor_id_exists(a.id)) for a in actors]
    out["colors"] = [P.create_blueprint("vehicle.*").attributes["color"] for _ in range(4)]
    a0 = actors[0]
    v0 = P.get_velocity(a0)
    for _ in range(10):
        world.tick()
    v_stale = P.get_velocity(a0)
    P.on_carla_tick()
    out["velocity"] = (v0, v_stale, P.get_velocity(a0), P.get_location(a0).x)
    lights = world.add_traffic_light_group(
        [(50.0, 0.0, 0.0), (60.0, 10.0, 180.0), (55.0, 5.0, 90.0), (55.0, -5.0, -90.0)])
    ann = P.annotate_trafficlight_in_group(lights[0])
    out["annotations"] = {k: [lights.index(x) for x in v] for k, v in ann.items()}
    reset = P.update_light_states(lights[0], ann, {"ref": fc.TrafficLightState.Green,
                                                   "opposite": fc.TrafficLightState.Red},
                                  freeze=True)
    out["frozen"] = [(x.get_state(), x.is_frozen()) for x in lights]
    P.reset_lights(reset)
    out["reset"] = [(x.get_state(), x.is_frozen()) for x in lights]
    P.cleanup()
    return out


def test_data_provider_traffic_and_weather_match_jax():
    with jax_carla() as (glue, fc), fresh_actor_ids(fc):
        want = _provider_and_traffic(glue, fc)
    with port_carla() as (glue, fc), fresh_actor_ids(fc):
        got = _provider_and_traffic(glue, fc)
    assert 1 <= len(got["traffic"]) <= 8
    assert all(x1 - x > 0.5 for x, x1, _ in got["traffic"])
    assert got["velocity"][0] == got["velocity"][1] == 0.0 < got["velocity"][2]
    assert got["annotations"] == {"ref": [0], "opposite": [1], "left": [2], "right": [3]}
    assert got == want


# --------------------------------------------------------------------------- #
# the expert through the glue
# --------------------------------------------------------------------------- #

def test_expert_completes_like_the_jax_glue(map_tool, tmp_path, monkeypatch, loose_watchdog):
    """The JAX glue with the JAX expert on tests/fake_carla against the
    port's glue with the port's expert on its copy: both Completed at 100,
    the checkpoint JSONs equal but for the records' duration_system."""
    monkeypatch.setattr(jax_rough_map, "default_tool_path", lambda: map_tool)
    with jax_carla() as (glue, _):
        want = _evaluate(glue, JaxRouteConfig, JaxRouteIndexer, JaxStatistics,
                         lambda cfg: JaxExpert({"config": JaxConfig(max_lanes=16),
                                                "rmap_tool": map_tool,
                                                "tmp_dir": str(tmp_path / "jax")}),
                         EXPERT_ROUTE, str(tmp_path / "jax.json"))
    with port_carla() as (glue, _):
        got = _evaluate(glue, RouteConfig, RouteIndexer, StatisticsManager,
                        lambda cfg: ExpertCollectionAgent({
                            "config": GlobalConfig(max_lanes=16), "rmap_tool": map_tool,
                            "tmp_dir": str(tmp_path / "port")}),
                        EXPERT_ROUTE, str(tmp_path / "port.json"))
    rec = got["_checkpoint"]["records"][0]
    assert rec["status"] == "Completed" and rec["scores"]["score_composed"] == 100.0, rec
    assert got["_checkpoint"]["global_record"]["scores"]["score_composed"] == 100.0
    assert _without_wall_clock(got) == _without_wall_clock(want)


# --------------------------------------------------------------------------- #
# the MMFN agent through the glue, held by record and replay
# --------------------------------------------------------------------------- #

def _assert_waypoints_close(got, want):
    """rtol 1e-4 / atol 2e-3 taken against the tick's largest waypoint
    coordinate (module docstring)."""
    bound = WAYPOINT_TOL["atol"] + WAYPOINT_TOL["rtol"] * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


def _recorded(agent, log):
    """Record each tick's input_data as the glue hands it, the control, and
    the waypoints the control is computed from (None on warm-up ticks)."""
    run_step, finish = agent.run_step, agent.finish_step

    def wrapped_run_step(input_data, timestamp):
        log.append({"input": copy.deepcopy(input_data), "t": timestamp, "waypoints": None})
        log[-1]["control"] = run_step(input_data, timestamp)
        return log[-1]["control"]

    def finish_step(payload, waypoints):
        log[-1]["waypoints"] = np.array(waypoints)
        return finish(payload, waypoints)

    agent.run_step, agent.finish_step = wrapped_run_step, finish_step
    return agent


@pytest.mark.parametrize("variant", ["vec", "rad"])
def test_mmfn_agent_through_the_glue_matches_jax(models, map_tool, tmp_path, monkeypatch,  # noqa: F811
                                                 loose_watchdog, variant):
    jax_pipe, port = models[variant]
    jcfg, cfg = _configs()
    common = {"variant": variant, "points_per_sweep": PPS, "rmap_tool": map_tool}

    # the JAX glue, live, with the JAX agent: its number of agent steps
    jax_agents = []

    def build_jax(c):
        jax_agents.append(JaxMMFNAgent({**common, "pipeline": jax_pipe, "config": jcfg,
                                        "tmp_dir": str(tmp_path / "jax_live")}))
        return jax_agents[-1]
    with jax_carla() as (glue, _):
        monkeypatch.setattr(glue, "route_timeout_seconds", lambda length: MODEL_ROUTE_SECONDS)
        jax_rec = _evaluate(glue, JaxRouteConfig, JaxRouteIndexer, JaxStatistics, build_jax,
                            MODEL_ROUTE, str(tmp_path / "jax.json"))["_checkpoint"]["records"][0]

    # the port's glue with the port's agent, every tick recorded
    log, plans, agents = [], [], []

    def build_port(c):
        agent = MMFNAgent({**common, "model": port, "config": cfg, "device": "cpu",
                           "host_bev": False, "tmp_dir": str(tmp_path / "port")})
        set_plan = agent.set_global_plan

        def set_global_plan(gps, world):
            plans.append((copy.deepcopy(gps), copy.deepcopy(world)))
            set_plan(gps, world)
        agent.set_global_plan = set_global_plan
        agents.append(_recorded(agent, log))
        return agents[-1]
    with port_carla() as (glue, _):
        monkeypatch.setattr(glue, "route_timeout_seconds", lambda length: MODEL_ROUTE_SECONDS)
        rec = _evaluate(glue, RouteConfig, RouteIndexer, StatisticsManager, build_port,
                        MODEL_ROUTE, str(tmp_path / "port.json"))["_checkpoint"]["records"][0]

    for r in (rec, jax_rec):
        assert "Agent crashed" not in r["status"], r
        assert np.isfinite(r["scores"]["score_composed"])
    agent, jax_agent = agents[0], jax_agents[0]
    assert agent.rough_map_loaded and agent.pid_metadata
    assert agent.step == jax_agent.step >= 10, (agent.step, jax_agent.step)

    # replay: the JAX agent fed the port glue's inputs, tick for tick
    replayed = []
    replay = _recorded(JaxMMFNAgent({**common, "pipeline": jax_pipe, "config": jcfg,
                                     "tmp_dir": str(tmp_path / "jax_replay")}), replayed)
    replay.set_global_plan(*plans[0])
    for entry in log:
        replay.run_step(copy.deepcopy(entry["input"]), entry["t"])
    forwards = 0
    for entry, want in zip(log, replayed):
        for name in ("steer", "throttle", "brake"):
            assert abs(getattr(want["control"], name) - getattr(entry["control"], name)) \
                <= CONTROL_TOL, (name, entry["t"])
        assert (want["waypoints"] is None) == (entry["waypoints"] is None)
        if entry["waypoints"] is not None:
            forwards += 1
            _assert_waypoints_close(entry["waypoints"], want["waypoints"])
    assert forwards == agent.step - 1 >= 10
    agent.destroy()
    replay.destroy()


# --------------------------------------------------------------------------- #
# phase0's simulator: carla
# --------------------------------------------------------------------------- #

def _route_file(tmp_path, suffix=".xml"):
    path = tmp_path / f"straight{suffix}"
    points = "".join(f'<waypoint x="{x}" y="{y}" z="{z}" pitch="0" roll="0" yaw="0"/>'
                     for x, y, z in EXPERT_ROUTE)
    path.write_text(f'<routes><route id="0" town="TownTest">{points}</route></routes>')
    return str(path)


def _phase0_args(tmp_path, map_tool, checkpoint, *extra):
    return ["--config", EVAL_YAML, "routes=" + _route_file(tmp_path), "simulator=carla",
            "agent.type=expert", "agent.max_lanes=16", "agent.rmap_tool=" + map_tool,
            "resume=false", "checkpoint=" + str(checkpoint), *extra]


def test_phase0_carla_runs_the_glue_on_the_mock(map_tool, tmp_path, loose_watchdog):
    """``python -m mmfn_tpu_torch.harness.fake_carla --town ... [phase0
    arguments] simulator=carla``: the expert completes at 100, and the mock
    is gone again afterwards."""
    from mmfn_tpu_torch.harness.fake_carla.__main__ import main

    xodr = tmp_path / "straight.xodr"
    xodr.write_text(STRAIGHT_XODR)
    checkpoint = tmp_path / "carla.json"
    assert main(["--town", f"TownTest={xodr}"]
                + _phase0_args(tmp_path, map_tool, checkpoint)) == 0
    with open(checkpoint) as f:
        rec = json.load(f)["_checkpoint"]["records"][0]
    assert rec["status"] == "Completed" and rec["scores"]["score_composed"] == 100.0, rec
    assert "carla" not in sys.modules
    from mmfn_tpu_torch.harness import carla_glue
    assert not carla_glue.HAS_CARLA


def test_phase0_carla_warms_the_model_before_the_first_tick(map_tool, tmp_path, monkeypatch,
                                                          loose_watchdog):
    """phase0's carla path serves an MMFN (vec, n_layer 1, 16 lanes, on the
    CPU) and runs one forward of zeros before the glue's first tick, once."""
    from mmfn_tpu_torch.harness.agents import TorchPipeline

    events = []
    dispatch, run_step = TorchPipeline.dispatch, MMFNAgent.run_step
    monkeypatch.setattr(TorchPipeline, "dispatch",
                        lambda pipe, *a: events.append("forward") or dispatch(pipe, *a))
    monkeypatch.setattr(MMFNAgent, "run_step",
                        lambda agent, *a: events.append("tick") or run_step(agent, *a))
    checkpoint = tmp_path / "vec.json"
    with port_carla() as (glue, _):
        monkeypatch.setattr(glue, "route_timeout_seconds", lambda length: 0.175)
        assert phase0.main([
            "--config", EVAL_YAML, "routes=" + _route_file(tmp_path), "simulator=carla",
            "agent.type=e2e", "agent.variant=vec", "agent.n_layer=1", "agent.max_lanes=16",
            "agent.rmap_tool=" + map_tool, "device=cpu", "resume=false",
            "checkpoint=" + str(checkpoint)]) == 0
    with open(checkpoint) as f:
        rec = json.load(f)["_checkpoint"]["records"][0]
    assert "Agent crashed" not in rec["status"] and np.isfinite(rec["scores"]["score_composed"])
    assert events[:3] == ["forward", "tick", "tick"]
    assert events.count("tick") == 4 and events.count("forward") == 1 + 2


def test_phase0_carla_without_the_mock_raises(map_tool, tmp_path):
    """Without the mock (no carla package here) phase0 raises the JAX
    glue's error; an .xosc route is refused as the JAX CLI refuses it."""
    with pytest.raises(RuntimeError, match="the carla package is not installed"):
        phase0.main(_phase0_args(tmp_path, map_tool, tmp_path / "x.json"))
    with pytest.raises(SystemExit, match="OpenSCENARIO routes"):
        phase0.main(["--config", EVAL_YAML, "simulator=carla", "resume=false",
                     "routes=" + os.path.join(ROOT, "data", "scenarios",
                                              "cut_in_with_controller.xosc")])
    assert "carla" not in sys.modules


@pytest.mark.slow
def test_phase0_carla_matches_the_jax_cli(map_tool, tmp_path, monkeypatch, loose_watchdog):
    """The port's phase0 with simulator=carla on its mock against the JAX
    CLI (run_steps/phase0_run_eval.py) on tests/fake_carla: equal
    checkpoint JSONs but for the records' duration_system."""
    spec = importlib.util.spec_from_file_location(
        "jax_phase0_cli", os.path.join(ROOT, "run_steps", "phase0_run_eval.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    monkeypatch.setattr(jax_rough_map, "default_tool_path", lambda: map_tool)
    args = _phase0_args(tmp_path, map_tool, tmp_path / "jax.json")
    with jax_carla():
        monkeypatch.setattr(sys, "argv", ["phase0_run_eval.py"] + [
            a for a in args if not a.startswith("agent.rmap_tool")])
        jax_cli.main()
    with port_carla():
        assert phase0.main(_phase0_args(tmp_path, map_tool, tmp_path / "port.json")) == 0
    with open(tmp_path / "jax.json") as f, open(tmp_path / "port.json") as g:
        want, got = json.load(f), json.load(g)
    assert got["_checkpoint"]["records"][0]["scores"]["score_composed"] == 100.0
    assert _without_wall_clock(got) == _without_wall_clock(want)


# --------------------------------------------------------------------------- #
# the compile cache
# --------------------------------------------------------------------------- #

def test_compile_cache_builds_the_kernels_on_cuda_only(monkeypatch):
    """False and no build without CUDA (the JAX function's "TPU backend
    only"); with CUDA it builds every kernel through ops/_cuda.build_all."""
    from mmfn_tpu_torch.ops import _cuda

    calls = []
    monkeypatch.setattr(_cuda, "build_all", lambda: calls.append(1) or {})
    assert compile_cache.enable_persistent_cache() is False and not calls
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert compile_cache.enable_persistent_cache() is True and calls == [1]
