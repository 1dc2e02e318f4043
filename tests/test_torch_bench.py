"""The port's bench (mmfn_tpu_torch.bench, mmfn_tpu_torch.bench_loop) against
bench.py and bench_loop.py, on the CPU and at a small size.

The pipeline (SE(2) transform, BEV, radar adjacency, MMFN-rad forward) is
held against the JAX bench's ``pipeline_fn`` on equal numpy inputs and
weights, through the port's plain attention and its kernel-2 path (on the
CPU the kernel's plain version), within rtol 1e-4 / atol 2e-3. The legs the
card times run here at a small size for their outputs' shape and keys; the
map tool is native/rough_map_node.cpp built by g++ into a temporary
directory.
"""

import ast
import json
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
import mmfn_tpu_torch.mapping.rough_map as port_rough_map
from mmfn_tpu_torch import bench, bench_loop
from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.models import build_model
from tests.test_torch_serving import port_and_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINTS = 4096


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


def _inputs(rng, b, res, max_lanes):
    return dict(
        image=rng.integers(0, 256, size=(b, res, res, 3)).astype(np.float32),
        points=rng.uniform(-30, 30, size=(b, POINTS, 4)).astype(np.float32),
        pose=rng.normal(size=(b, 6)).astype(np.float32),
        lanes=rng.normal(size=(b, max_lanes, 10, 5)).astype(np.float32) * 10,
        lane_num=rng.integers(1, max_lanes + 1, size=(b,)).astype(np.int32),
        radar=rng.normal(size=(b, 81, 5)).astype(np.float32),
        target_point=rng.normal(size=(b, 2)).astype(np.float32) * 5,
        velocity=np.abs(rng.normal(size=(b,))).astype(np.float32) * 5)


def test_pipeline_matches_the_jax_bench():
    port, jmodel, variables = port_and_jax("rad", 1, 6, "xla")
    data = _inputs(np.random.default_rng(3), 2, 64, 6)
    want = np.asarray(jax.jit(jax_bench.pipeline_fn(jmodel))(
        variables, {k: jnp.asarray(v) for k, v in data.items()}))
    inp = {k: torch.from_numpy(v) for k, v in data.items()}
    from mmfn_tpu_torch.models.gpt import SelfAttention

    for impl in ("xla", "pallas"):
        for m in port.modules():
            if isinstance(m, SelfAttention):
                m.attn_impl = impl
        with torch.inference_mode():
            got = bench.pipeline_fn(port)(inp).numpy()
        assert got.shape == want.shape == (2, 4, 2)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3, err_msg=impl)


def test_transform_points_is_the_per_cloud_transform():
    from mmfn_tpu_torch.ops.lidar import transform_2d_points

    rng = np.random.default_rng(4)
    pts = torch.from_numpy(rng.uniform(-30, 30, size=(3, 500, 4)).astype(np.float32))
    pose = torch.from_numpy(rng.normal(size=(3, 6)).astype(np.float32))
    got = bench.transform_points(pts, pose)
    for i in range(3):
        torch.testing.assert_close(got[i], transform_2d_points(pts[i], *pose[i]),
                                   rtol=0, atol=1e-5)


def test_make_inputs_draws_as_the_jax_bench(monkeypatch):
    monkeypatch.setattr(jax_bench, "MAX_POINTS", POINTS)
    monkeypatch.setattr(bench, "MAX_POINTS", POINTS)
    want = jax_bench.make_inputs(2, np.random.default_rng(0))
    got = bench.make_inputs(2, np.random.default_rng(0), "cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_timed_loop_and_timed_train_give_finite_times():
    cfg = GlobalConfig(n_layer=1, max_lanes=6, input_resolution=64)
    model = build_model(cfg, "rad", device="cpu")
    inputs = {k: torch.from_numpy(v) for k, v in
              _inputs(np.random.default_rng(5), 1, 64, 6).items()}
    step_s = bench.timed_loop(bench.pipeline_fn(model), inputs, 2)
    train_s = bench.timed_train(cfg, 2, "cpu", iters=1)
    assert np.isfinite([step_s, train_s]).all() and step_s > 0 and train_s > 0


def _returned_keys(path, function):
    """The keys of the dict literal that ``function`` in ``path`` returns."""
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == function)
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    return {k.value for k in ret[-1].value.keys}


@pytest.fixture
def port_tool(map_tool, monkeypatch):
    monkeypatch.setattr(port_rough_map, "default_tool_path", lambda: map_tool)
    monkeypatch.setattr(bench_loop, "WARMUP_TICKS", 3)


def test_fleet_mode_returns_the_jax_keys(port_tool):
    cfg = GlobalConfig(n_layer=1, max_lanes=8)
    model = build_model(cfg, "rad", device="cpu")
    want = _returned_keys(os.path.join(ROOT, "bench_loop.py"), "_fleet_mode")
    from mmfn_tpu_torch.harness.agents.e2e import MMFNAgent
    from mmfn_tpu_torch.harness.device_world import DeviceWorldPipeline

    agent = MMFNAgent({"variant": "rad", "model": model, "config": cfg, "device": "cpu"})
    for pipe, compact in ((agent.pipeline, False),
                          (DeviceWorldPipeline(model, cfg, device="cpu"), True)):
        out = bench_loop._fleet_mode(pipe, cfg, 2, ticks=5, pipelined=True,
                                     compact_world=compact)
        assert set(out) == want
        assert out["fleet"] == 2 and out["agg_ticks_per_sec"] > 0
        assert out["route_status"]


def test_soak_mode_returns_the_jax_keys(port_tool):
    cfg = GlobalConfig(n_layer=1, max_lanes=8)
    model = build_model(cfg, "rad", device="cpu")
    from mmfn_tpu_torch.harness.agents.pipeline import TorchPipeline

    pipe = TorchPipeline(model, cfg, host_bev=False, packed=False, device="cpu")
    out = bench_loop._soak_mode(pipe, cfg, async_dispatch=True, ticks=5)
    assert set(out) == _returned_keys(os.path.join(ROOT, "bench_loop.py"), "_soak_mode")
    assert out["ticks_per_sec"] > 0
    assert bench_loop._relay_rtt_ms(torch.device("cpu"), n=2) >= 0


def test_bench_line_has_the_keys_of_the_jax_bench():
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        want = json.load(f)["parsed"]
    fleet = {"agg_ticks_per_sec": 1.0, "vehicles_at_20hz": 0.1}
    disk = {"loader_fps": 1.0, "loader_fed_train_fps": 1.0, "loader_fed_train_fps_raw_f32": 1.0}
    line = bench.bench_line(8.0, 0.01, 1.0, 2.0, 8, fleet, fleet, 128, 3.0,
                            {"packed": True, "host_bev": True}, disk, True, "xla", "H100")
    assert set(line) == set(want)
    assert all(v is not None for v in line.values())
    assert set(line["transport"]) == set(want["transport"])
    assert json.loads(json.dumps(line)) == line


@pytest.mark.parametrize("main", [bench.main, bench_loop.main], ids=["bench", "bench_loop"])
def test_bench_runs_on_the_card_unless_asked_for_the_cpu(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
