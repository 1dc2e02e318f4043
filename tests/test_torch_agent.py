"""The port's MMFNAgent and FleetRunner against the JAX package's, on the CPU.

Both agents see the same ``input_data`` every tick: frames of the port's
``KinematicWorld`` on a straight road, with its birdview camera, LiDAR and
radar, stepped by the JAX agent's controls. Weights: the JAX MMFN's variable
tree comes from ``jax.eval_shape`` of its ``init``, drawn with numpy as in
tests/test_torch_baselines.py (its constant-initialised leaves randomised),
and is carried across with ``from_flax_variables``; JAX runs at
matmul_precision "highest". One JAX pipeline per variant serves the whole
module. Sizes: n_layer 1, a 64-px camera, 16 lanes, 2,048 points a sweep.
Tolerances: waypoints rtol 1e-4 / atol 2e-3 (the whole-model tolerance of
tests/test_torch_models.py), controls 1e-4.

The map tool is a stand-in script that copies a ``.rmap`` written with the
port's ``write_rmap`` and prints ``ok``, so the tests need no native build.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mmfn_tpu.config import GlobalConfig as JaxConfig
from mmfn_tpu.data.synthetic import synthetic_batch
from mmfn_tpu.harness.agents import MMFNAgent as JaxMMFNAgent
from mmfn_tpu.harness.agents.pipeline import JitPipeline
from mmfn_tpu.models import build_model as jax_build_model

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.harness.agents import HostCopy, MMFNAgent, TorchPipeline
from mmfn_tpu_torch.harness.fleet import FleetRunner
from mmfn_tpu_torch.harness.replay import ClosedLoopRunner, KinematicWorld, plan_from_trajectory
from mmfn_tpu_torch.harness.route import RouteConfig
from mmfn_tpu_torch.mapping.birdview import BirdViewProducer
from mmfn_tpu_torch.mapping.rough_map import RoughMap, write_rmap
from mmfn_tpu_torch.models.mmfn import MMFN
from mmfn_tpu_torch.utils.weights import from_flax_variables
from tests.test_harness import STRAIGHT_XODR
from tests.test_torch_baselines import _draw
from tests.test_torch_models import _randomise

N_LAYER, RES, LANES, PPS = 1, 64, 16, 2048
WAYPOINT_TOL = dict(rtol=1e-4, atol=2e-3)
CONTROL_TOL = 1e-4
TICKS = 8                      # 2 warm-up ticks, then forwards
TRAJECTORY = [(0.0, 1.75, 0.0), (120.0, 1.75, 0.0)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one CPU thread here: the test workers share the CPU, and
    torch's own thread pool oversubscribes it (with six workers this
    module's forwards ran 10-30 times slower than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs():
    kw = dict(n_layer=N_LAYER, max_lanes=LANES, input_resolution=RES)
    return JaxConfig(matmul_precision="highest", **kw), GlobalConfig(attn_impl="pallas", **kw)


@pytest.fixture(scope="module")
def rmap_tool(tmp_path_factory):
    """A stand-in for native/build/rough_map_node: copies a straight
    two-lane .rmap (along the test route) into the map directory."""
    d = tmp_path_factory.mktemp("rmap_tool")
    lanes = []
    for y in (1.75, -1.75):
        for x0 in range(-20, 140, 20):
            xs = np.linspace(x0, x0 + 20, 10)
            nodes = np.stack([xs, np.full(10, y), np.zeros(10), np.zeros(10),
                              np.zeros(10)], 1)
            poly = np.array([[x0, y - 1.75], [x0 + 20, y - 1.75],
                             [x0 + 20, y + 1.75], [x0, y + 1.75]])
            lanes.append((poly, nodes))
    rmap = d / "straight.rmap"
    write_rmap(str(rmap), lanes)
    tool = d / "rough_map_node"
    tool.write_text(f'#!/bin/sh\ncp "{rmap}" "$1/a.rmap" && echo ok\n')
    tool.chmod(0o755)
    return str(tool), str(rmap)


@pytest.fixture(scope="module")
def models():
    """Per variant: the JAX pipeline, the port model, both on one set of
    weights."""
    jcfg, cfg = _configs()
    out = {}
    for seed, variant in enumerate(("vec", "rad")):
        jmodel = jax_build_model(jcfg, variant)
        batch = synthetic_batch(batch_size=1, max_lanes=LANES, resolution=RES)
        shapes = jax.eval_shape(lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            batch, False))
        rng = np.random.default_rng(seed + 10)
        variables = {"params": _randomise(_draw(shapes["params"], rng), rng),
                     "batch_stats": _randomise(_draw(shapes["batch_stats"], rng), rng,
                                               stats=True)}
        jvars = jax.tree.map(jnp.asarray, variables)
        with torch.device("meta"):          # no weights drawn: all are assigned
            port = MMFN(cfg, variant)
        port.load_state_dict(from_flax_variables(variables, variant, N_LAYER),
                             strict=True, assign=True)
        port.eval()
        out[variant] = (JitPipeline(jmodel, jvars, jcfg, points_per_sweep=PPS), port)
    return out


def _recording(agent, log):
    """Record the waypoints each control is computed from."""
    finish = agent.finish_step

    def finish_step(payload, waypoints):
        log.append(np.array(waypoints))
        return finish(payload, waypoints)
    agent.finish_step = finish_step
    return agent


def _world(rmap_path, seed=3):
    bev = BirdViewProducer(RoughMap().read(rmap_path))
    return KinematicWorld(STRAIGHT_XODR, (2.0, 1.75, 0.05), seed=seed, lidar_points=1500,
                          camera_birdview=bev, weather="SoftRainNoon")


@pytest.mark.parametrize("async_dispatch", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("variant", ["vec", "rad"])
def test_agent_matches_jax_tick_for_tick(models, rmap_tool, tmp_path, variant, async_dispatch):
    jax_pipe, port = models[variant]
    jcfg, cfg = _configs()
    tool, rmap = rmap_tool
    common = {"variant": variant, "points_per_sweep": PPS, "rmap_tool": tool,
              "async_dispatch": async_dispatch}
    jlog, plog = [], []
    jagent = _recording(JaxMMFNAgent({**common, "pipeline": jax_pipe, "config": jcfg,
                                      "tmp_dir": str(tmp_path / "jax")}), jlog)
    pagent = _recording(MMFNAgent({**common, "model": port, "config": cfg, "device": "cpu",
                                   "tmp_dir": str(tmp_path / "port")}), plog)
    assert pagent.pipeline.host_bev is False      # the auto rule at 2,048 points
    gps_plan, world_plan = plan_from_trajectory(TRAJECTORY)
    for agent in (jagent, pagent):
        agent.set_global_plan(gps_plan, world_plan)

    world = _world(rmap)
    for t in range(TICKS):
        frame = world.sensor_frame()
        jc = jagent.run_step(copy.deepcopy(frame), t * 0.05)
        pc = pagent.run_step(frame, t * 0.05)
        for name in ("steer", "throttle", "brake"):
            assert abs(getattr(jc, name) - getattr(pc, name)) <= CONTROL_TOL, (t, name, jc, pc)
        world.tick(jc)
    forwards = TICKS - 2 - int(async_dispatch)
    assert len(jlog) == len(plog) == forwards
    for want, got in zip(jlog, plog):
        assert got.shape == (4, 2)
        np.testing.assert_allclose(got, want, **WAYPOINT_TOL)
    assert pagent.rough_map_loaded and len(pagent.rough_map.lanes) == 16
    pagent.destroy()
    jagent.destroy()


def test_agent_loads_a_reference_state_dict(models, rmap_tool):
    """``model`` given as a state_dict under the reference keys builds the
    same pipeline as the model itself."""
    _, port = models["rad"]
    _, cfg = _configs()
    tool, rmap = rmap_tool
    agent = MMFNAgent({"variant": "rad", "model": port.state_dict(), "config": cfg,
                       "device": "cpu", "points_per_sweep": PPS, "rmap_tool": tool})
    loaded = agent.pipeline.model.state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in port.state_dict().items())
    with pytest.raises(ValueError, match="variant"):
        MMFNAgent({"variant": "vec", "pipeline": agent.pipeline, "config": cfg})


@pytest.mark.parametrize("conf, match", [
    ({"mesh": object()}, "ROADMAP queue 1 item 4"),
    ({"device_world": True, "mesh": object()}, "ROADMAP queue 1 item 4"),
], ids=["mesh", "device_world"])
def test_agent_refuses_unported_options(models, conf, match):
    _, port = models["vec"]
    _, cfg = _configs()
    with pytest.raises(NotImplementedError, match=match):
        MMFNAgent({"variant": "vec", "model": port, "config": cfg, "device": "cpu", **conf})


def test_agent_refuses_compact_world_frames(models):
    """Compact world frames need the device world's pipeline."""
    _, port = models["vec"]
    _, cfg = _configs()
    agent = MMFNAgent({"variant": "vec", "model": port, "config": cfg, "device": "cpu"})
    with pytest.raises(TypeError, match="DeviceWorldPipeline"):
        agent.prepare_step({"world_state": (0, {})})


def test_host_copy_of_a_cpu_output_is_the_output():
    out = torch.arange(8.0).reshape(4, 2)
    np.testing.assert_array_equal(HostCopy(out).result(), out.numpy())


def _fleet_routes(n):
    return [RouteConfig(route_id=str(i), town="TownTest", index=i,
                        trajectory=[(0.0, 1.75 + 0.3 * i, 0.0), (120.0, 1.75 + 0.3 * i, 0.0)])
            for i in range(n)]


@pytest.mark.parametrize("pipelined", [False, True], ids=["lockstep", "pipelined"])
def test_fleet_matches_single_agent_runs(models, rmap_tool, tmp_path, pipelined):
    """Three agents on one shared pipeline, one batched forward a tick. In
    lockstep every record equals the single agent's on its own route; the
    pipelined fleet steers one tick late, so its records are only checked
    to be scored."""
    _, port = models["rad"]
    _, cfg = _configs()
    tool, rmap = rmap_tool
    pipe = TorchPipeline(port, cfg, points_per_sweep=PPS, device="cpu")
    routes = _fleet_routes(3)
    kw = dict(opendrive_str=STRAIGHT_XODR, max_ticks=7,
              world_kwargs={"lidar_points": 1500, "seed": 5})

    def agent(i):
        return MMFNAgent({"variant": "rad", "pipeline": pipe, "config": cfg,
                          "rmap_tool": tool, "tmp_dir": str(tmp_path / f"a{i}")})

    fleet = FleetRunner(max_wall_seconds=300, pipelined=pipelined, prep_workers=2).run(
        [agent(i) for i in range(3)], [dict(config=c, **kw) for c in routes])
    assert [r.route_id for r in fleet] == ["0", "1", "2"]
    for r in fleet:
        assert r.status.startswith(("Failed", "Completed"))
        assert np.isfinite(r.scores["score_composed"])
    if pipelined:
        return
    runner = ClosedLoopRunner(max_wall_seconds=300)
    for i, c in enumerate(routes):
        single = runner.run_route(
            agent(10 + i), c, kw["opendrive_str"], max_ticks=kw["max_ticks"],
            world_kwargs=kw["world_kwargs"])
        assert single.status == fleet[i].status
        assert single.scores == fleet[i].scores
        assert single.infractions == fleet[i].infractions
