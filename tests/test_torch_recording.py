"""The port's episode recorder, ``MetricsLog``, metric copies and metrics CLI
against the JAX package's, on the CPU.

- Recording: one episode on the cross town (its lights, scenario triggers,
  6 background vehicles, an animated sun; ``NpcAgent``, which drives
  through the scenario actors, so collisions are recorded too) through both
  runners gives equal recordings with ``platform_time`` (wall clock) masked;
  ``platform_time`` is the only field left out. Each package's saved file
  loads in the other's ``EpisodeRecorder.load`` and ``MetricsLog``.
- Queries: every public ``MetricsLog`` query of the JAX package, called
  with every actor, a span of frames, every light, each role, state and
  light flag (and ids that do not exist), gives the same answer or the same
  refusal in both packages, over both packages' recordings.
- Metrics: the port's copies in ``harness/metric_examples/`` write the same
  files as ``examples/metrics/*.py`` under the JAX ``run_metric``, and the
  port's metrics CLI the same files and summary line as
  ``run_steps/metrics_run.py``; a metric file that imports the JAX package
  is refused before any of it runs.

The map tool is ``native/rough_map_node.cpp``, built with g++ into this
module's own temporary directory.
"""

import importlib.util
import inspect
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmfn_tpu.harness import metrics_log as jmetrics_log
from mmfn_tpu.harness import recording as jrecording
from mmfn_tpu.harness import replay as jreplay
from mmfn_tpu.harness import scenarios as jscenarios
from mmfn_tpu.harness.agents.trivial import NpcAgent as JaxNpcAgent
from mmfn_tpu.harness.route import RouteIndexer as JaxRouteIndexer
from mmfn_tpu.harness.route import interpolate_trajectory as jinterpolate
from mmfn_tpu.harness.weather import WeatherSim as JaxWeatherSim
from mmfn_tpu.mapping import rough_map as jrough_map

from mmfn_tpu_torch.harness import metrics_log, metrics_run, recording, replay, scenarios
from mmfn_tpu_torch.harness.agents.trivial import NpcAgent
from mmfn_tpu_torch.harness.route import RouteIndexer, interpolate_trajectory
from mmfn_tpu_torch.harness.weather import WeatherSim
from mmfn_tpu_torch.mapping import rough_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROSS_XODR = os.path.join(ROOT, "data", "maps", "fake_town_cross.xodr")
ROUTES = os.path.join(ROOT, "data", "routes", "benchmark_cross.xml")
SCENARIOS = os.path.join(ROOT, "data", "scenarios", "fake_towns_scenarios.json")
METRICS = ("comfort", "criteria_filter", "distance_between_vehicles", "distance_to_lane_center")
COPIES = os.path.join(ROOT, "mmfn_tpu_torch", "harness", "metric_examples")
TICKS = 400


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


def _record(pkg, map_tool, xodr):
    jax_side = pkg == "jax"
    rp = jreplay if jax_side else replay
    sc = jscenarios if jax_side else scenarios
    m, _, _ = (jrough_map if jax_side else rough_map).vectorize_xodr(
        xodr, tool_path=map_tool, birdview=False)
    config = (JaxRouteIndexer if jax_side else RouteIndexer)(ROUTES).next()
    route_xy = [p for p, _ in (jinterpolate if jax_side else interpolate_trajectory)(
        config.trajectory)]
    triggers = sc.sample_scenarios(sc.scan_route_for_scenarios(
        route_xy, sc.parse_scenario_file(SCENARIOS, config.town)), seed=0)
    signals, background = rp.route_environment(m, config.trajectory, traffic=6, seed=1)
    rec = (jrecording if jax_side else recording).EpisodeRecorder()
    sun = (JaxWeatherSim if jax_side else WeatherSim)(preset="WetNoon", time_scale=3000.0,
                                                       start_hour=17.0)
    record = rp.ClosedLoopRunner(max_wall_seconds=600).run_route(
        (JaxNpcAgent if jax_side else NpcAgent)(), config, xodr, max_ticks=TICKS,
        triggers=triggers, rough_map=m, signals=signals, background=background,
        recorder=rec, weather_sim=sun, world_kwargs={"lidar_points": 800})
    return record, rec


@pytest.fixture(scope="module")
def recordings(map_tool, tmp_path_factory):
    """pkg -> (RouteRecord, EpisodeRecorder, saved path) for one episode."""
    with open(CROSS_XODR) as f:
        xodr = f.read()
    d = tmp_path_factory.mktemp("recordings")
    out = {}
    for pkg in ("jax", "port"):
        record, rec = _record(pkg, map_tool, xodr)
        path = str(d / f"{pkg}.json")
        rec.save(path)
        out[pkg] = (record, rec, path)
    return out


def _masked(data):
    data = json.loads(json.dumps(data))
    for frame in data["frames"]:
        frame.pop("platform_time")
    data["record"]["meta"].pop("duration_system")
    return data


def test_recordings_are_equal(recordings):
    _, jrec, _ = recordings["jax"]
    record, rec, path = recordings["port"]
    data = rec.data
    assert data["format"] == jrecording.FORMAT == recording.FORMAT == "mmfn_tpu-episode-v1"
    assert len(data["frames"]) == TICKS and record.meta["duration_game"] > 0
    roles = {a["role_name"] for a in data["actors"].values()}
    assert roles == {"hero", "scenario", "background"}
    assert data["lights_meta"] and any(f["collisions"] for f in data["frames"])
    assert len({f["weather"] for f in data["frames"]}) > 1        # the sun set
    assert _masked(data) == _masked(jrec.data)
    # platform_time is the wall clock since the route started: the one field
    # the two runs may not share
    times = [f["platform_time"] for f in data["frames"]]
    assert times == sorted(times) and 0.0 <= times[0] < times[-1] < 600.0
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(data))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_recordings_load_in_either_package(recordings, writer):
    path = recordings[writer][2]
    jdata, pdata = jrecording.EpisodeRecorder.load(path), recording.EpisodeRecorder.load(path)
    assert jdata == pdata
    for log in (jmetrics_log.MetricsLog(path), metrics_log.MetricsLog(path)):
        assert log.get_total_frame_count() == TICKS
        assert log.get_ego_vehicle_id() == 0


def test_load_refuses_another_format(tmp_path):
    path = tmp_path / "other.json"
    path.write_text(json.dumps({"format": "something-else"}))
    for mod in (jrecording, recording):
        with pytest.raises(ValueError, match="not a mmfn_tpu-episode-v1 recording"):
            mod.EpisodeRecorder.load(str(path))


def _argument_values(log, name):
    actors = sorted(int(a) for a in log._actors) + [987654]
    n = log.get_total_frame_count()
    frames = sorted({0, 1, 2, n // 3, n // 2, n - 2, n - 1})
    n_lights = len(log._lights_meta)
    return {
        "actor_id": actors, "vehicle_id": actors, "walker_id": actors,
        "frame": frames,
        "first_frame": [None, 0, 5], "last_frame": [None, n // 2, n - 1],
        "actor_list": [None, actors[:2]],
        "light_index": list(range(n_lights + 1)), "light_id": [0],
        "state": ["Green", "Yellow", "Red"],
        "light": ["Brake", "Reverse", "Position", "LowBeam"],
        "role_name": ["hero", "scenario", "background", "nobody"],
        "type_pattern": ["vehicle.*", "walker.*", "*", "vehicle.tesla.model3"],
    }


def _answer(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:
        return (type(e).__name__, str(e))


QUERIES = sorted(n for n, _ in inspect.getmembers(jmetrics_log.MetricsLog, inspect.isfunction)
                 if not n.startswith("_"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_every_query_answers_as_in_jax(recordings, writer):
    path = recordings[writer][2]
    jlog, plog = jmetrics_log.MetricsLog(path), metrics_log.MetricsLog(path)
    assert sorted(n for n, _ in inspect.getmembers(metrics_log.MetricsLog, inspect.isfunction)
                  if not n.startswith("_")) == QUERIES
    calls = 0
    for name in QUERIES:
        params = list(inspect.signature(getattr(jlog, name)).parameters)
        values = _argument_values(jlog, name)
        for args in itertools.product(*(values[p] for p in params)):
            got = _answer(getattr(plog, name), *args)
            want = _answer(getattr(jlog, name), *args)
            np.testing.assert_equal(got, want, err_msg=f"{name}{args}")
            calls += 1
    assert calls > 1000


def _outputs(d):
    return {name: open(os.path.join(d, name)).read() for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("metric", METRICS)
def test_metric_copies_match_the_examples(recordings, map_tool, tmp_path, metric, monkeypatch):
    path = recordings["port"][2]
    monkeypatch.setattr(jrough_map, "default_tool_path", lambda: map_tool)
    monkeypatch.setattr(rough_map, "default_tool_path", lambda: map_tool)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jmetrics_log.run_metric(os.path.join(ROOT, "examples", "metrics", f"{metric}.py"),
                                   path, out_dir=str(tmp_path / "jax"))
    got = metrics_log.run_metric(os.path.join(COPIES, f"{metric}.py"), path,
                                 out_dir=str(tmp_path / "port"))
    assert isinstance(got, metrics_log.BasicMetric)
    assert type(got).__name__ == type(want).__name__
    outputs = _outputs(tmp_path / "port")
    assert outputs and outputs == _outputs(tmp_path / "jax")
    assert {k: v for k, v in vars(got).items() if k != "out_dir"} == \
        {k: v for k, v in vars(want).items() if k != "out_dir"}


def test_a_jax_metric_file_is_refused_before_it_runs(tmp_path):
    marker = tmp_path / "ran"
    path = tmp_path / "jax_metric.py"
    path.write_text(f"open({str(marker)!r}, 'w').close()\n"
                    "from mmfn_tpu.harness.metrics_log import BasicMetric\n")
    before = set(sys.modules)
    for metric in (str(path), os.path.join(ROOT, "examples", "metrics", "comfort.py")):
        with pytest.raises(ImportError, match="imports mmfn_tpu.harness.metrics_log"):
            metrics_log.load_metric_class(metric)
    assert not marker.exists() and "jax_metric" not in set(sys.modules) - before
    plain = tmp_path / "no_metric.py"
    plain.write_text("import numpy\n")
    with pytest.raises(ValueError, match="no BasicMetric subclass"):
        metrics_log.load_metric_class(str(plain))


@pytest.mark.parametrize("metric", METRICS)
def test_metrics_cli_matches_the_jax_cli(recordings, map_tool, tmp_path, metric, monkeypatch,
                                         capsys):
    path = recordings["jax"][2]
    assert metrics_run.main(["--log", path, "--metric", os.path.join(COPIES, f"{metric}.py"),
                             "--out", str(tmp_path / "port"), "--rmap-tool", map_tool]) == 0
    got = capsys.readouterr().out
    spec = importlib.util.spec_from_file_location(
        "jax_metrics_run", os.path.join(ROOT, "run_steps", "metrics_run.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    monkeypatch.setattr(jrough_map, "default_tool_path", lambda: map_tool)
    monkeypatch.setattr(sys, "argv", [
        "metrics_run.py", "--log", path, "--metric",
        os.path.join(ROOT, "examples", "metrics", f"{metric}.py"),
        "--out", str(tmp_path / "jax")])
    jax_cli.main()
    want = capsys.readouterr().out
    assert got.replace(str(tmp_path / "port"), "OUT") == want.replace(str(tmp_path / "jax"), "OUT")
    outputs = _outputs(tmp_path / "port")
    assert outputs and outputs == _outputs(tmp_path / "jax")


def test_metrics_cli_criteria_and_no_map(recordings, tmp_path, monkeypatch, capsys):
    """--criteria replaces the recording's criteria; --no-map runs a metric
    without the map, as the JAX CLI does."""
    path = recordings["port"][2]
    criteria = {"RouteCompletion": {"test_status": "SUCCESS", "actual_value": 100.0,
                                    "expected_value_success": 100.0}}
    (tmp_path / "c.json").write_text(json.dumps(criteria))
    spec = importlib.util.spec_from_file_location(
        "jax_metrics_run", os.path.join(ROOT, "run_steps", "metrics_run.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    for name, example in (("criteria_filter", "criteria_filter"), ("comfort", "comfort")):
        flags = ["--log", path, "--criteria", str(tmp_path / "c.json"), "--no-map"]
        assert metrics_run.main(flags + ["--metric", os.path.join(COPIES, f"{name}.py"),
                                         "--out", str(tmp_path / "port")]) == 0
        monkeypatch.setattr(sys, "argv", ["metrics_run.py"] + flags + [
            "--metric", os.path.join(ROOT, "examples", "metrics", f"{example}.py"),
            "--out", str(tmp_path / "jax")])
        jax_cli.main()
    capsys.readouterr()
    assert _outputs(tmp_path / "port") == _outputs(tmp_path / "jax")
    with open(tmp_path / "port" / "CriteriaFilter_results.json") as f:
        assert json.load(f) == {"RouteCompletion": {"test_status": "SUCCESS",
                                                    "actual_value": 100.0,
                                                    "success_value": 100.0}}
