"""The port's device world against the JAX package's, on the CPU.

- Host helpers: ``actor_slab_np`` and ``light_slab_np`` equal JAX's
  exactly, nearest-first order included; ``map_tables`` too.
- Lane crop: ``crop_lanes`` batched over poses on the cross and curved
  maps: lane_num and the kept rows exact, lanes within 1e-5 (float32, both
  sides); the static pad of a small map and the empty crop exact.
- ``radar_fit``: exact, over- and under-full, with ties.
- Synthesizers: each core fed the JAX package's own draws (its keys rebuilt
  here on its schedule, ``device_world.py:307,351,385-387,413,545-546``):
  the camera exact, the LiDAR points within rtol / atol 1e-6, the radar
  within 1e-5. ``synth_birdview`` against JAX's on one pose, actors and
  lights: at least 99.9% of the pixels equal (measured 100%); against the
  port's ``BirdViewProducer.produce`` + ``as_rgb``: above 95% (measured
  99.13%), with 70% of every layer of 200+ pixels, as
  ``tests/test_device_world.py`` holds JAX's to cv2.
- The slice: ``DeviceWorldPipeline`` of 3 vehicles against the JAX
  ``DeviceWorldPipeline`` (its one program for the fleet), the port fed
  JAX's draws: waypoints within rtol 1e-4 / atol 2e-3 (the whole-model
  tolerance of tests/test_torch_models.py).
- Within the port: chunked synthesis equals monolithic, vehicle 0 of a
  fleet of 4 equals a fleet of 1, the same (seed, frame, vehicle) gives the
  same draws, and the draws' mean and spread are those of JAX's.
- The world: ``KinematicWorld(compact_sensors=True)``'s ``world_state``
  frames equal JAX's tick for tick on the cross town, with scenario
  triggers and traffic lights; both warn when ``lidar_points`` is not the
  device world's ground density.
- The agent: ``MMFNAgent(device_world=True)`` through the phase0 CLI
  (``agent.device_world=true``), sync and async; the second-map guard and
  the img-without-birdview error.

Sizes: n_layer 1, a 64-px camera, 16 lanes. Torch runs on one thread. The
map tool is ``native/rough_map_node.cpp``, built with g++ into this
module's own temporary directory.
"""

import json
import os
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from mmfn_tpu.config import GlobalConfig as JaxConfig
from mmfn_tpu.data.synthetic import synthetic_batch
from mmfn_tpu.harness import device_world as jdw
from mmfn_tpu.harness import replay as jreplay
from mmfn_tpu.harness.agents.trivial import NpcAgent as JaxNpcAgent
from mmfn_tpu.harness.scenarios import ScenarioActor as JaxScenarioActor
from mmfn_tpu.harness.scenarios import (parse_scenario_file as jax_parse_scenario_file,
                                        sample_scenarios as jax_sample_scenarios,
                                        scan_route_for_scenarios as jax_scan_route)
from mmfn_tpu.harness.traffic import signals_from_rough_map as jax_signals_from_rough_map
from mmfn_tpu.mapping import rough_map as jax_rough_map
from mmfn_tpu.mapping.birdview import BirdViewProducer as JaxBirdViewProducer
from mmfn_tpu.models import build_model as jax_build_model

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.harness import device_world as dw
from mmfn_tpu_torch.harness import phase0, replay
from mmfn_tpu_torch.harness.agents import MMFNAgent
from mmfn_tpu_torch.harness.agents.trivial import NpcAgent
from mmfn_tpu_torch.harness.route import parse_routes_file
from mmfn_tpu_torch.harness.scenarios import (ScenarioActor, parse_scenario_file,
                                              sample_scenarios, scan_route_for_scenarios)
from mmfn_tpu_torch.harness.traffic import signals_from_rough_map
from mmfn_tpu_torch.mapping.birdview import BirdViewProducer
from mmfn_tpu_torch.mapping.rough_map import RoughMap, build_rmap
from mmfn_tpu_torch.models.mmfn import MMFN
from mmfn_tpu_torch.utils.weights import from_flax_variables
from tests.test_device_world import CURVED_XODR
from tests.test_torch_baselines import _draw
from tests.test_torch_models import _randomise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROSS_XODR = os.path.join(ROOT, "data", "maps", "fake_town_cross.xodr")
SCENARIOS = os.path.join(ROOT, "data", "scenarios", "fake_towns_scenarios.json")
EVAL_YAML = os.path.join(ROOT, "run_steps", "config", "eval.yaml")
N_LAYER, RES, LANES = 1, 64, 16
WAYPOINT_TOL = dict(rtol=1e-4, atol=2e-3)
SEED = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one CPU thread here: the test workers share the CPU, and
    torch's own thread pool oversubscribes it."""
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
    """name -> (OpenDRIVE string, port RoughMap, JAX RoughMap)."""
    with open(CROSS_XODR) as f:
        xodrs = {"cross": f.read(), "curved": CURVED_XODR}
    out = {}
    for name, xodr in xodrs.items():
        d = tmp_path_factory.mktemp(name) / "opendrive"
        d.mkdir()
        (d / "opstr.txt").write_text(xodr)
        assert not build_rmap([str(d)], tool_path=map_tool)
        rmap = str(d / "a.rmap")
        out[name] = (xodr, RoughMap().read(rmap), jax_rough_map.RoughMap().read(rmap))
    return out


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# --------------------------------------------------------------------------- #
# host helpers
# --------------------------------------------------------------------------- #

def _scene(cls, rng, n=11):
    """n actors around the origin: vehicles and walkers, some hidden from the
    sensors or the graphics, two at the same distance."""
    out = []
    for i in range(n):
        pos = rng.uniform(-30, 30, 2)
        if i == 5:
            pos = -out[4].position          # a tie in distance
        out.append(cls("walker" if i % 3 == 0 else "vehicle", pos, rng.normal(size=2),
                       yaw=float(rng.uniform(-3, 3)), extent=float(rng.uniform(0.4, 2.5)),
                       actor_id=i, visible_sensors=i % 4 != 1,
                       visible_graphics=i % 5 != 2))
    return out


@pytest.mark.parametrize("n", [3, 11])
def test_slabs_match_jax(n):
    rng = np.random.default_rng(n)
    ego = rng.normal(size=2)
    want = jdw.actor_slab_np(_scene(JaxScenarioActor, np.random.default_rng(n), n), ego)
    got = dw.actor_slab_np(_scene(ScenarioActor, np.random.default_rng(n), n), ego)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    lights = [(float(x), float(y), s) for (x, y), s in
              zip(rng.uniform(-50, 50, (n, 2)), ["red", "green", "yellow", "off"] * n)]
    np.testing.assert_array_equal(dw.light_slab_np(lights, ego), jdw.light_slab_np(lights, ego))
    assert not dw.light_slab_np([], ego).any()


@pytest.mark.parametrize("name", ["cross", "curved"])
def test_map_tables_match_jax(maps, name):
    _, port, jax_map = maps[name]
    got, want = dw.map_tables(port), jdw.map_tables(jax_map)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --------------------------------------------------------------------------- #
# the lane crop
# --------------------------------------------------------------------------- #

def _poses(name, rng):
    fixed = {"cross": [(0.0, 1.75, 0.0), (-40.0, -1.75, np.pi), (1.75, 30.0, np.pi / 2),
                       (20.0, 20.0, 0.8)],
             "curved": [(10.0, 1.75, 0.0), (120.0, 3.0, 0.2), (250.0, 30.0, 0.5),
                        (40.0, 0.0, 3.0)]}[name]
    far = [(5000.0, 5000.0, 0.0)]              # no lane near: the empty crop
    rand = [(*rng.uniform(-60, 60, 2), rng.uniform(-np.pi, np.pi)) for _ in range(6)]
    return np.asarray(fixed + far + rand, np.float32)


def _jax_crop(jax_map, poses, max_lanes):
    tables = {k: jnp.asarray(v) for k, v in jdw.map_tables(jax_map).items()}
    lanes, num = jax.jit(jax.vmap(lambda p: jdw.crop_lanes(p, tables, max_lanes)))(
        jnp.asarray(poses))
    return np.asarray(lanes), np.asarray(num)


def _crop(port_map, poses, max_lanes):
    tables = {k: torch.as_tensor(v) for k, v in dw.map_tables(port_map).items()}
    lanes, num = dw.crop_lanes(torch.as_tensor(poses), tables, max_lanes)
    return lanes.numpy(), num.numpy()


@pytest.mark.parametrize("name", ["cross", "curved"])
def test_crop_lanes_matches_jax(maps, name):
    _, port, jax_map = maps[name]
    poses = _poses(name, np.random.default_rng(1))
    got, got_n = _crop(port, poses, LANES)
    want, want_n = _jax_crop(jax_map, poses, LANES)
    assert got.shape == want.shape == (len(poses), LANES, 10, 5)
    assert got_n.dtype == np.int32
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_array_equal(np.abs(got).sum((2, 3)) > 0, np.abs(want).sum((2, 3)) > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got_n[4] == 1 and not got[4].any()            # the empty crop
    assert got_n[:4].min() >= 1 and got_n[:4].max() > 1


def test_crop_lanes_pads_a_small_map(maps):
    """Fewer lanes than max_lanes: the static shape, zero rows past the map."""
    _, port, jax_map = maps["curved"]
    n_lanes = len(port.lanes)
    poses = _poses("curved", np.random.default_rng(2))
    got, got_n = _crop(port, poses, n_lanes + 11)
    want, want_n = _jax_crop(jax_map, poses, n_lanes + 11)
    assert got.shape[1] == n_lanes + 11
    assert not got[:, n_lanes:].any()
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------- #
# the radar fit
# --------------------------------------------------------------------------- #

def test_radar_fit_matches_jax():
    rng = np.random.default_rng(7)
    rows, valid = [], []
    for n_valid in (5, 40, 81, 96, 120, 0):
        r = rng.normal(size=(128, 5)).astype(np.float32)
        r[:, 3] = rng.uniform(1.0, 90.0, 128)
        r[:, 0] = rng.normal(size=128) * 3
        r[10:14] = r[20]                              # equal |v/d|: ties
        r[30, 3] = 0.0                                # the depth guard
        v = np.zeros(128, np.float32)
        v[rng.permutation(128)[:n_valid]] = 1.0       # valid rows anywhere
        rows.append(r)
        valid.append(v)
    rows, valid = np.stack(rows), np.stack(valid)
    want = np.asarray(jax.vmap(jdw.radar_fit)(jnp.asarray(rows), jnp.asarray(valid)))
    got = dw.radar_fit(_t(rows), _t(valid)).numpy()
    assert got.shape == (6, 81, 5)
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# the synthesizers, fed JAX's draws
# --------------------------------------------------------------------------- #

def _jax_draws(seed, frames, vehicles, resolution=0):
    """JAX's draws for each (frame, vehicle) on its key schedule, in the
    port's layout (``draw_layout``): name -> (V, ...) numpy."""
    names = list(dw.draw_layout(resolution))
    out = {k: [] for k in names}
    A, K = dw.ACTOR_SLAB, replay.KinematicWorld.LIDAR_PER_ACTOR
    C, R = 2 * replay.KinematicWorld.RADAR_CLUTTER, replay.KinematicWorld.RAIN_POINTS
    uni = jax.random.uniform
    for frame, i in zip(frames, vehicles):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), frame), i)
        kc, kl, kr = jax.random.split(key, 3)
        sweeps = [jax.random.split(kl, 3), jax.random.split(jax.random.fold_in(kl, 1), 3)]
        out["ground"].append([uni(kg, (dw.GROUND_POINTS, 4)) for kg, _, _ in sweeps])
        out["actor"].append([uni(ka, (A, K, 4)) for _, ka, _ in sweeps])
        out["rain"].append([uni(kw, (R, 3)) for _, _, kw in sweeps])
        faces = [jax.random.split(k) for k in jax.random.split(kr)]
        out["radar_normal"].append([jax.random.normal(kg, (C, 2)) for kg, _ in faces])
        out["radar_uniform"].append([uni(ku, (C, 2)) for _, ku in faces])
        if resolution:
            out["camera"].append(jax.random.randint(kc, (resolution,) * 2 + (3,), 0, 255))
    return {k: np.asarray(v) for k, v in out.items()}


def _actors(rng, v):
    """(V, 8, 9) slabs: 5 actors in view (some beyond the LiDAR's range or
    out of the radar's field), 3 empty rows; validity mixed."""
    slab = np.zeros((v, dw.ACTOR_SLAB, 9), np.float32)
    valid = np.zeros((v, dw.ACTOR_SLAB), np.float32)
    for i in range(v):
        for k, dist in enumerate((6.0, 12.0, 25.0, 40.0, 80.0)):
            ang = rng.uniform(-0.4, 0.4) + (np.pi if k == 1 else 0.0)
            slab[i, k] = [dist * np.cos(ang), dist * np.sin(ang), *rng.normal(size=2),
                          rng.uniform(0.5, 2.5), k % 5, rng.uniform(-3, 3), k == 2, 1.0]
            valid[i, k] = float(k != 3 or i % 2)
    return slab, valid


def test_camera_core_matches_jax():
    frames, vehicles = [4, 9], [0, 5]
    draws = _jax_draws(SEED, frames, vehicles, RES)
    bright = np.array([1.0, 0.4], np.float32)
    got = dw.camera_core(torch.as_tensor(draws["camera"]), _t(bright)).numpy()
    for i, (f, v) in enumerate(zip(frames, vehicles)):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(SEED), f), v)
        want = np.asarray(jdw.synth_camera(jax.random.split(key, 3)[0], bright[i], RES))
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("rain", [0.0, 0.6])
def test_lidar_core_matches_jax(rain):
    rng = np.random.default_rng(11)
    frames, vehicles = [0, 17, 3], [2, 0, 7]
    slab, valid = _actors(rng, 3)
    yaw = rng.uniform(-3, 3, 3).astype(np.float32)
    draws = _jax_draws(SEED, frames, vehicles)
    got = dw.lidar_core(_t(draws["ground"]), _t(draws["actor"]), _t(draws["rain"]),
                        _t(slab), _t(valid), _t(yaw), _t(np.full(3, rain))).numpy()
    assert got.shape == (3, 3340, 4)
    for i, (f, v) in enumerate(zip(frames, vehicles)):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(SEED), f), v)
        want = np.asarray(jdw.synth_lidar_points(
            jax.random.split(key, 3)[1], jnp.asarray(slab[i]), jnp.asarray(valid[i]),
            jnp.float32(yaw[i]), jnp.float32(rain)))
        np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=1e-6)
        assert (got[i, :, 3] > 0).sum() > 2 * dw.GROUND_POINTS


def test_radar_core_matches_jax():
    rng = np.random.default_rng(12)
    frames, vehicles = [1, 2, 30], [0, 1, 2]
    slab, valid = _actors(rng, 3)
    yaw = rng.uniform(-3, 3, 3).astype(np.float32)
    speed = rng.uniform(0, 8, 3).astype(np.float32)
    ego_vel = (speed[:, None] * np.stack([np.cos(yaw), np.sin(yaw)], 1)).astype(np.float32)
    rain = np.array([0.0, 0.3, 1.0], np.float32)
    draws = _jax_draws(SEED, frames, vehicles)
    got = dw.radar_core(_t(draws["radar_normal"]), _t(draws["radar_uniform"]), _t(slab),
                        _t(valid), _t(yaw), _t(ego_vel), _t(rain), 81).numpy()
    for i, (f, v) in enumerate(zip(frames, vehicles)):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(SEED), f), v)
        want = np.asarray(jdw.synth_radar(
            jax.random.split(key, 3)[2], jnp.asarray(slab[i]), jnp.asarray(valid[i]),
            jnp.float32(yaw[i]), jnp.asarray(ego_vel[i]), jnp.float32(rain[i]), 81))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)
        assert set(np.unique(got[i][np.abs(got[i]).sum(1) > 0][:, 4])) <= {0.0, 1.0}


def test_birdview_matches_jax_and_the_host_producer(maps):
    _, port, jax_map = maps["curved"]
    pose = (120.0, 3.0, 0.35)
    host_actors = [(130.0, 5.0, 0.4, 4.0, 2.8), (112.0, -2.0, 3.3, 3.6, 2.52)]
    host_walkers = [(124.0, 8.0, 1.0, 0.8, 0.56)]
    host_lights = [(135.0, 3.5, "red"), (110.0, 0.0, "green"), (118.0, 9.0, "yellow")]
    slab = np.zeros((dw.ACTOR_SLAB, 9), np.float32)
    for k, (ax, ay, ayaw, length, _) in enumerate(host_actors + host_walkers):
        slab[k] = [ax - pose[0], ay - pose[1], 0, 0, length / 2.0, 0, ayaw,
                   k >= len(host_actors), 1.0]
    lights = dw.light_slab_np(host_lights, np.asarray(pose[:2]))

    producer = BirdViewProducer(port)
    jproducer = JaxBirdViewProducer(jax_map)
    jtables = {k: jnp.asarray(v) for k, v in jdw.raster_tables(jproducer).items()}
    want_jax = np.asarray(jdw.synth_birdview(
        jnp.asarray(pose, jnp.float32), jnp.asarray(slab), jnp.asarray(lights), jtables,
        jproducer.ppm, jproducer.target_size, jproducer.crop_size))
    tables = {k: torch.as_tensor(v) for k, v in dw.raster_tables(producer).items()}
    got = dw.synth_birdview(_t([pose]), _t(slab[None]), _t(lights[None]), tables,
                            producer.ppm, producer.target_size, producer.crop_size)[0].numpy()
    assert got.shape == want_jax.shape == (256, 256, 3)
    same_jax = (got == want_jax).all(-1).mean()
    assert same_jax >= 0.999, f"pixel agreement with JAX {same_jax:.5f}"

    want = BirdViewProducer.as_rgb(producer.produce(
        pose, actors=host_actors, lights=host_lights, walkers=host_walkers))
    same = (got.astype(np.int32) == want.astype(np.int32)).all(-1)
    assert same.mean() > 0.95, f"pixel agreement with the producer {same.mean():.4f}"
    for rgb in np.unique(want.reshape(-1, 3), axis=0):
        mask = (want == rgb).all(-1)
        if mask.sum() >= 200:
            assert (got[mask].astype(np.int32) == rgb).all(-1).mean() > 0.7, f"layer {rgb}"


# --------------------------------------------------------------------------- #
# the pipeline
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def rad_pair():
    """The JAX MMFN-rad and the port's on one set of weights."""
    jcfg = JaxConfig(matmul_precision="highest", n_layer=N_LAYER, max_lanes=LANES,
                     input_resolution=RES)
    cfg = GlobalConfig(attn_impl="pallas", n_layer=N_LAYER, max_lanes=LANES,
                       input_resolution=RES)
    jmodel = jax_build_model(jcfg, "rad")
    batch = synthetic_batch(batch_size=1, max_lanes=LANES, resolution=RES)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, batch, False))
    rng = np.random.default_rng(21)
    variables = {"params": _randomise(_draw(shapes["params"], rng), rng),
                 "batch_stats": _randomise(_draw(shapes["batch_stats"], rng), rng, stats=True)}
    with torch.device("meta"):
        port = MMFN(cfg, "rad")
    port.load_state_dict(from_flax_variables(variables, "rad", N_LAYER), strict=True,
                         assign=True)
    return (jmodel, jax.tree.map(jnp.asarray, variables), jcfg), (port.eval(), cfg)


def _payloads(n, rng, frame0=5):
    slab, valid = _actors(rng, n)
    return [{"compact": True,
             "pose": np.array([3.0 * i, 1.75 - 0.5 * i, 0.05 * i], np.float32),
             "target_point": rng.normal(size=2).astype(np.float32) * 5,
             "speed": float(2.0 + i), "actors": slab[i], "actors_valid": valid[i],
             "rain": [0.0, 0.6, 1.0][i % 3], "brightness": [1.0, 0.8, 0.4][i % 3],
             "frame": frame0 + 3 * i,
             "lights": dw.light_slab_np([(10.0, 3.0 + i, "red"), (-5.0, 0.0, "green")],
                                        np.array([3.0 * i, 1.75]))}
            for i in range(n)]


def _pipeline(rad_pair, maps, device="cpu", **kw):
    port, cfg = rad_pair[1]
    pipe = dw.DeviceWorldPipeline(port, cfg, device=device, **kw)
    pipe.set_map(maps["curved"][1])
    return pipe


def test_pipeline_matches_jax(rad_pair, maps):
    """Three vehicles through both pipelines; the port's synthesizers take
    JAX's draws, so both see the same sensors."""
    (jmodel, jvars, jcfg), _ = rad_pair
    payloads = _payloads(3, np.random.default_rng(5))
    jpipe = jdw.DeviceWorldPipeline(jmodel, jvars, jcfg, synth_chunk=None, seed=SEED)
    jpipe.set_map(maps["curved"][2])
    want = np.asarray(jpipe.dispatch_fleet(payloads))
    pipe = _pipeline(rad_pair, maps, seed=SEED)
    draws = _jax_draws(SEED, [p["frame"] for p in payloads], range(3), RES)
    batch = pipe.synthesize(payloads, draws=draws)
    got = pipe.forward(batch).numpy()
    assert got.shape == want.shape == (3, 4, 2)
    np.testing.assert_allclose(got, want, **WAYPOINT_TOL)
    assert batch.lidar_bev.shape == (3, 256, 256, 2) and batch.image.shape == (3, RES, RES, 3)
    assert batch.lane_num.dtype == torch.int32 and (batch.lane_num >= 1).all()


def _batches_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), name


def test_chunked_synthesis_equals_monolithic(rad_pair, maps):
    payloads = _payloads(5, np.random.default_rng(6))
    mono = _pipeline(rad_pair, maps, synth_chunk=None)
    chunked = _pipeline(rad_pair, maps, synth_chunk=2)      # 5 = 2 + 2 + 1
    _batches_equal(chunked.synthesize(payloads), mono.synthesize(payloads))
    # vehicle 0 of a fleet of 4 is the fleet of 1: its draws are its own
    four, one = mono.synthesize(payloads[:4]), mono.synthesize(payloads[:1])
    for name, x, y in zip(four._fields, four, one):
        if x is not None:
            assert torch.equal(x[:1], y), name
    # the same inputs; the forward's sums run in another order at batch 4
    wp4, wp1 = mono.dispatch_fleet(payloads[:4])[0].numpy(), mono(payloads[0])
    np.testing.assert_allclose(wp4, wp1, rtol=1e-5, atol=1e-5)


def test_draws_repeat_and_match_jax_statistics():
    frame, vehicle = torch.tensor([7, 7, 8]), torch.tensor([0, 1, 0])
    names = list(dw.draw_layout(RES))
    a = dw.make_draws(SEED, frame, vehicle, names, RES)
    b = dw.make_draws(SEED, frame, vehicle, names, RES)
    for k in names:
        assert torch.equal(a[k], b[k]), k
        assert not torch.equal(a[k][0], a[k][1]) and not torch.equal(a[k][0], a[k][2]), k
    # a function's own draws are the pipeline's slice of the counter range
    assert torch.equal(dw.make_draws(SEED, frame, vehicle, ["rain"])["rain"], a["rain"])
    want = _jax_draws(SEED, [7, 7, 8], [0, 1, 0], RES)
    for k, kind in (("ground", "uniform"), ("radar_normal", "normal"), ("camera", "int")):
        got, ref = a[k].double().numpy(), want[k].astype(np.float64)
        scale = ref.std()
        assert abs(got.mean() - ref.mean()) < 0.05 * scale, k
        assert abs(got.std() - scale) < 0.05 * scale, k
        assert got.min() >= ref.min() - (4 * scale if kind == "normal" else 0), k
    assert a["camera"].min() == 0 and a["camera"].max() == 254
    assert a["ground"].min() >= 0 and a["ground"].max() < 1


def test_synthesized_sensors_shapes_and_stats():
    """The public synthesizers on their own draws keep the host world's
    ranges (``test_synth_sensor_shapes_and_stats`` of the JAX package)."""
    one = torch.tensor([0])
    img = dw.synth_camera(0, one, one, _t([1.0]))[0].numpy()
    assert img.shape == (256, 256, 3) and img.min() >= 0 and img.max() <= 254
    assert dw.synth_camera(0, one, one, _t([0.25]))[0].max() <= 64
    actors = np.zeros((1, dw.ACTOR_SLAB, 6), np.float32)
    actors[0, 0] = [10.0, 0.0, 0.0, 0.0, 1.5, 2.0]          # 10 m ahead
    avalid = np.zeros((1, dw.ACTOR_SLAB), np.float32)
    avalid[0, 0] = 1.0
    pts = dw.synth_lidar_points(0, one, one, _t(actors), _t(avalid), _t([0.0]),
                                _t([0.0]))[0].numpy()
    valid = pts[pts[:, 3] > 0]
    assert valid.shape[0] > 2 * 1200
    body = valid[valid[:, 2] > -2.0]
    assert body.shape[0] > 0
    assert abs(np.median(body[:, 0])) < 2.5 and abs(np.median(body[:, 1]) + 10.0) < 2.5
    radar = dw.synth_radar(0, one, one, _t(actors), _t(avalid), _t([0.0]),
                           torch.zeros(1, 2), _t([0.0]))[0].numpy()
    assert radar.shape == (81, 5)
    nz = radar[np.abs(radar).sum(axis=1) > 0]
    assert set(np.unique(nz[:, 4])) <= {0.0, 1.0} and (nz[:, 3] >= 0).all()


def test_pipeline_guards(rad_pair, maps):
    port, cfg = rad_pair[1]
    pipe = _pipeline(rad_pair, maps)
    pipe.set_map(maps["curved"][1])                   # the same map again is fine
    with pytest.raises(ValueError, match="different map"):
        pipe.set_map(maps["cross"][1])
    with pytest.raises(RuntimeError, match="set_map"):
        dw.DeviceWorldPipeline(port, cfg, device="cpu").dispatch_fleet(_payloads(1, np.random.default_rng(0)))
    with pytest.raises(ValueError, match="img variant needs the birdview"):
        with torch.device("meta"):
            img = MMFN(cfg, "img")
        dw.DeviceWorldPipeline(img, cfg, birdview=False, device="cpu")
    sharded = dw.DeviceWorldPipeline(port, cfg, device=["cpu", "cpu"])
    sharded.set_map(maps["curved"][1])              # the map tables on every device
    assert len(sharded.replicas) == len(sharded._tables) == 2


def test_sharded_device_world_matches_jax_mesh(rad_pair, maps):
    """Three vehicles over two CPU shards (2 + 1), each synthesized from
    JAX's draws for its fleet index; JAX shards over 2 of its virtual
    devices, padding to 4 and slicing back."""
    (jmodel, jvars, jcfg), _ = rad_pair
    payloads = _payloads(3, np.random.default_rng(8))
    jpipe = jdw.DeviceWorldPipeline(jmodel, jvars, jcfg, seed=SEED,
                                    mesh=Mesh(np.array(jax.devices()[:2]), ("fleet",)))
    jpipe.set_map(maps["curved"][2])
    want = np.asarray(jpipe.dispatch_fleet(payloads))
    pipe = _pipeline(rad_pair, maps, seed=SEED, device=["cpu", "cpu"])
    draws = _jax_draws(SEED, [p["frame"] for p in payloads], range(3), RES)

    def shard(i, lo, hi, _):
        part = {k: v[lo:hi] for k, v in draws.items()}
        return pipe.forward(pipe.synthesize(payloads[lo:hi], part, shard=i, first=lo), i)

    assert pipe.replicas.bounds(3) == [(0, 2, 2), (2, 3, 2)]
    got = pipe.replicas.run(3, shard).numpy()
    assert got.shape == want.shape == (3, 4, 2)
    np.testing.assert_allclose(got, want, **WAYPOINT_TOL)


def test_sharded_device_world_keys_draws_by_the_global_vehicle(rad_pair, maps):
    """With the hashed draws, shard 1's vehicles see the sensors they see in
    the unsharded fleet: the draws ride the fleet index, not the index
    within a shard."""
    payloads = _payloads(5, np.random.default_rng(9))
    plain = _pipeline(rad_pair, maps, seed=SEED)
    sharded = _pipeline(rad_pair, maps, seed=SEED, device=["cpu", "cpu"])
    want = plain.synthesize(payloads)
    for i, (lo, hi, _) in enumerate(sharded.replicas.bounds(5)):
        got = sharded.synthesize(payloads[lo:hi], shard=i, first=lo)
        for name, x, y in zip(got._fields, got, want):
            if x is not None:
                assert torch.equal(x, y[lo:hi]), (i, name)
    np.testing.assert_allclose(sharded.dispatch_fleet(payloads).numpy(),
                               plain.dispatch_fleet(payloads).numpy(), **WAYPOINT_TOL)


# --------------------------------------------------------------------------- #
# the world and the agent
# --------------------------------------------------------------------------- #

def _compact_recorder(base):
    class Recorder(base):
        def run_step(self, input_data, timestamp):
            assert "rgb" not in input_data and "lidar" not in input_data
            self.__dict__.setdefault("frames", []).append(input_data["world_state"][1])
            return super().run_step(input_data, timestamp)
    return Recorder()


def test_world_state_frames_match_jax(maps):
    xodr, port, jax_map = maps["cross"]
    config = parse_routes_file(os.path.join(ROOT, "data", "routes", "cross_left_turn.xml"))[0]
    plan = [p for p, _ in replay.plan_from_trajectory(config.trajectory)[1]]
    triggers = sample_scenarios(scan_route_for_scenarios(
        plan, parse_scenario_file(SCENARIOS, config.town)), seed=0)
    jtriggers = jax_sample_scenarios(jax_scan_route(
        plan, jax_parse_scenario_file(SCENARIOS, config.town)), seed=0)
    agents = []
    for mod, agent, rough, sig, trig in (
            (replay, _compact_recorder(NpcAgent), port, signals_from_rough_map, triggers),
            (jreplay, _compact_recorder(JaxNpcAgent), jax_map, jax_signals_from_rough_map,
             jtriggers)):
        mod.ClosedLoopRunner(max_wall_seconds=600).run_route(
            agent, config, xodr, max_ticks=160, triggers=trig, rough_map=rough,
            signals=sig(rough, plan), world_kwargs={"compact_sensors": True, "seed": 4,
                                                    "weather": "MidRainSunset"})
        agents.append(agent)
    got, want = agents[0].frames, agents[1].frames
    assert len(got) == len(want) == 160
    for t, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=f"{k} at {t}")
    assert any(f["actors_valid"].any() for f in got), "no scenario actor in view"
    assert any(f["lights"][:, 3].any() for f in got), "no traffic light in the slab"
    for mod in (replay, jreplay):
        with pytest.warns(UserWarning, match="ignores lidar_points=900"):
            mod.KinematicWorld(xodr, (0.0, 0.0, 0.0), compact_sensors=True, lidar_points=900)


@pytest.mark.parametrize("extra", [[], ["agent.async_dispatch=true"]], ids=["sync", "async"])
def test_phase0_serves_the_device_world(map_tool, tmp_path, extra):
    """agent.device_world=true at n_layer 1 and 16 lanes: MMFNAgent over a
    DeviceWorldPipeline in compact world frames; every forward tick steers
    and the record is scored."""
    path = tmp_path / "dw.json"
    assert phase0.main(["--config", EVAL_YAML,
                        "routes=" + os.path.join(ROOT, "data", "routes", "cross_straight.xml"),
                        "map=" + CROSS_XODR, "scenarios=" + SCENARIOS, "resume=false",
                        "checkpoint=" + str(path), "agent.rmap_tool=" + map_tool,
                        "agent.variant=rad", "agent.n_layer=1", "agent.max_lanes=16",
                        "agent.attn_impl=pallas", "agent.device_world=true", "max_ticks=6",
                        "device=cpu", *extra]) == 0
    with open(path) as f:
        records = json.load(f)["_checkpoint"]["records"]
    assert len(records) == 1
    assert records[0]["status"].startswith(("Failed", "Completed"))
    assert "Agent crashed" not in records[0]["status"]
    assert np.isfinite(records[0]["scores"]["score_composed"])


def test_fleet_fills_finished_slots_with_zero_payloads(rad_pair, map_tool, tmp_path):
    """A device-world fleet of 2 whose first route ends first: the freed
    batch slot takes the zero payload, which synthesizes, and both routes
    are scored."""
    from mmfn_tpu_torch.harness.fleet import FleetRunner
    from mmfn_tpu_torch.harness.route import RouteConfig
    from tests.test_harness import STRAIGHT_XODR

    port, cfg = rad_pair[1]
    pipe = dw.DeviceWorldPipeline(port, cfg, device="cpu")
    widths = []
    dispatch = pipe.dispatch_fleet

    def recording(payloads):
        widths.append(sum(bool(p["frame"]) for p in payloads))
        return dispatch(payloads)
    pipe.dispatch_fleet = recording
    agents = [MMFNAgent({"variant": "rad", "pipeline": pipe, "config": cfg, "rmap_tool": map_tool,
                         "tmp_dir": str(tmp_path / str(i))}) for i in range(2)]
    routes = [{"config": RouteConfig(route_id=str(i), town="TownTest", index=i,
                                     trajectory=[(0.0, 1.75, 0.0), (60.0, 1.75, 0.0)]),
               "opendrive_str": STRAIGHT_XODR, "max_ticks": ticks,
               "world_kwargs": {"compact_sensors": True}} for i, ticks in enumerate((3, 6))]
    records = FleetRunner(max_wall_seconds=300, prep_workers=1).run(agents, routes)
    assert [r.route_id for r in records] == ["0", "1"]
    assert all("Agent crashed" not in r.status for r in records)
    assert widths == [2, 2, 1, 1, 1]          # a zero payload fills the freed slot


def test_agent_builds_its_device_world_pipeline(rad_pair, maps):
    port, cfg = rad_pair[1]
    agent = MMFNAgent({"variant": "rad", "model": port.state_dict(), "config": cfg,
                       "device": "cpu", "device_world": True})
    assert isinstance(agent.pipeline, dw.DeviceWorldPipeline)
    loaded = agent.pipeline.model.state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in port.state_dict().items())
    agent.pipeline.set_map(maps["curved"][1])
    with pytest.raises(ValueError, match="different map"):
        agent.pipeline.set_map(maps["cross"][1])
