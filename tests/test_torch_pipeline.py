"""The port's serving pipeline against the JAX package's JitPipeline, on the
CPU, and the port's import boundary.

Both pipelines serve MMFN-rad on the same weights (JAX init carried across
with from_flax_variables) from the same host payloads: a 64-px uint8 camera,
two sweeps of 2048 points shipped in f16 (or binned on the host with
host_bev), 16 lanes and 81 radar rows. Waypoints agree within rtol 1e-4 /
atol 2e-3, the whole-model tolerance of tests/test_torch_models.py.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch
from jax.sharding import Mesh

from mmfn_tpu.config import GlobalConfig as JaxConfig
from mmfn_tpu.data.synthetic import synthetic_batch
from mmfn_tpu.harness.agents.pipeline import JitPipeline
from mmfn_tpu.models import build_model as jax_build_model

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.harness.agents import TorchPipeline
from mmfn_tpu_torch.harness.agents import pipeline as tpipe
from mmfn_tpu_torch.models import build_model
from mmfn_tpu_torch.utils.weights import from_flax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LANES = 16
PPS = 2048


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
def models():
    kw = dict(n_layer=1, max_lanes=MAX_LANES, attn_impl="pallas")
    jmodel = jax_build_model(JaxConfig(matmul_precision="highest", **kw), "rad")
    variables = jax.jit(jmodel.init, static_argnums=(2,))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        synthetic_batch(batch_size=1, max_lanes=MAX_LANES, resolution=64), False)
    variables = jax.tree.map(np.asarray, dict(variables))
    cfg = GlobalConfig(**kw)
    port = build_model(cfg, "rad", device="cpu")
    port.load_state_dict(from_flax_variables(variables, "rad", n_layer=1))
    return jmodel, variables, port, cfg


def _payload(rng, n_points=3000):
    return {
        "image": rng.integers(0, 256, size=(64, 64, 3)).astype(np.uint8),
        "points": rng.uniform(low=[-20, -30, -4], high=[20, 12, 2],
                              size=(n_points, 3)).astype(np.float32),
        "lanes": (rng.normal(size=(MAX_LANES, 10, 5)) * 10).astype(np.float32),
        "lane_num": int(rng.integers(1, MAX_LANES + 1)),
        "radar": rng.normal(size=(81, 5)).astype(np.float32),
        "map_img": None,
        "target_point": (rng.normal(size=2) * 5).astype(np.float32),
        "speed": float(abs(rng.normal()) * 3),
    }


def _args(p):
    return (p["image"], p["points"], p["lanes"], p["lane_num"], p["radar"],
            p["map_img"], p["target_point"], p["speed"])


@pytest.mark.parametrize("host_bev", [False, True], ids=["device_bev", "host_bev"])
def test_pipeline_matches_jit_pipeline(models, host_bev):
    jmodel, variables, port, cfg = models
    jax_pipe = JitPipeline(jmodel, variables, JaxConfig(n_layer=1, max_lanes=MAX_LANES),
                           points_per_sweep=PPS, host_bev=host_bev)
    pipe = TorchPipeline(port, cfg, points_per_sweep=PPS, host_bev=host_bev, device="cpu")
    rng = np.random.default_rng(11)
    payloads = [_payload(rng), _payload(rng, 5000)]      # 5000 > 2 * PPS: truncated

    for p in payloads:
        want = jax_pipe(*_args(p))
        got = pipe(*_args(p))
        assert isinstance(got, np.ndarray) and got.shape == (4, 2)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)

    want = np.asarray(jax_pipe.dispatch_fleet(payloads))
    got = pipe.dispatch_fleet(payloads)
    assert tuple(got.shape) == (2, 4, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-3)
    np.testing.assert_array_equal(pipe.zero_lanes, jax_pipe.zero_lanes)


def test_packed_transport_matches_unpacked(models):
    """One byte buffer split by byte views gives the per-array transfers'
    tensors bit for bit, so the waypoints are identical."""
    _, _, port, cfg = models
    packed = TorchPipeline(port, cfg, points_per_sweep=PPS, device="cpu")
    plain = TorchPipeline(port, cfg, points_per_sweep=PPS, packed=False, device="cpu")
    rng = np.random.default_rng(5)
    payloads = [_payload(rng) for _ in range(3)]
    rows = [packed._host_args(*_args(p)) for p in payloads]
    for a, b in zip(packed._to_device(rows), plain._to_device(rows)):
        if a is None:
            assert b is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_array_equal(packed.dispatch_fleet(payloads).numpy(),
                                  plain.dispatch_fleet(payloads).numpy())


def test_pipeline_refuses_to_fall_back_to_the_cpu(models, monkeypatch):
    _, _, port, cfg = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchPipeline(port, cfg)
    assert tpipe.resolve_device("cpu") == torch.device("cpu")


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "mmfn_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _jax_mesh(n=2):
    return Mesh(np.array(jax.devices()[:n]), ("fleet",))


@pytest.fixture(scope="module")
def jax_sharded(models):
    jmodel, variables, _, _ = models
    return JitPipeline(jmodel, variables, JaxConfig(n_layer=1, max_lanes=MAX_LANES),
                       points_per_sweep=PPS, mesh=_jax_mesh())


@pytest.mark.parametrize("width", [8, 7])
def test_sharded_pipeline_matches_jax_mesh(models, jax_sharded, width):
    """Two CPU entries in ``device`` split ``dispatch_fleet``'s rows into
    contiguous shards, one replica each (the last shard of 7 padded with a
    zero row); JAX shards over 2 of its 8 virtual CPU devices."""
    _, _, port, cfg = models
    rng = np.random.default_rng(width)
    payloads = [_payload(rng) for _ in range(width)]
    want = np.asarray(jax_sharded.dispatch_fleet(payloads))
    sharded = TorchPipeline(port, cfg, points_per_sweep=PPS, device=["cpu", "cpu"])
    assert len(sharded.replicas) == 2
    got = sharded.dispatch_fleet(payloads).numpy()
    assert got.shape == want.shape == (width, 4, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)
    plain = TorchPipeline(port, cfg, points_per_sweep=PPS, device="cpu")
    np.testing.assert_allclose(got, plain.dispatch_fleet(payloads).numpy(),
                               rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(sharded(*[payloads[0][k] for k in (
        "image", "points", "lanes", "lane_num", "radar", "map_img", "target_point",
        "speed")]), got[0], rtol=1e-4, atol=2e-3)


def test_port_sources_import_neither_jax_nor_the_jax_package():
    # nor cv2 or PIL, which the GPU machine does not have
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "mmfn_tpu", "cv2", "PIL",
                                   "torchvision"), \
                    f"{path}: {name}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import mmfn_tpu_torch\n"
        "for m in pkgutil.walk_packages(mmfn_tpu_torch.__path__, 'mmfn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'mmfn_tpu', 'cv2', 'PIL', 'torchvision'))\n"
        "assert not bad, bad\n"
        "print(' '.join(sorted(m for m in new if m.startswith('mmfn_tpu_torch'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    imported = set(proc.stdout.split())
    assert len(imported) >= 20
    # every module of the harness, the metric copies and the CLIs among them
    missing = ({"mmfn_tpu_torch.harness." + m for m in HARNESS_MODULES}
               | {"mmfn_tpu_torch." + m for m in TOOL_MODULES}) - imported
    assert not missing, sorted(missing)


HARNESS_MODULES = (
    "actor_controls", "atoms", "openscenario", "recording", "metrics_log", "metrics_run",
    "scenario_run", "watchdog", "agents.remote", "metric_examples.comfort",
    "metric_examples.criteria_filter", "metric_examples.distance_between_vehicles",
    "metric_examples.distance_to_lane_center")


TOOL_MODULES = (
    "bench", "bench_loop", "harness.benchmark_run", "serving", "serving.export",
    "serving.export_model", "utils.profiling", "utils.introspection", "control.localization",
    "harness.validation", "harness.game_time", "harness.agents.human")


def _remote_stack_entry(tmp):
    """A RemoteAgent here, and ``python -m mmfn_tpu_torch.harness.agents.remote``
    run on a thread of this interpreter (runpy), answering 5 ticks."""
    return (
        "import os, runpy, threading, time, warnings\n"
        "import numpy as np\n"
        "from mmfn_tpu_torch.harness.agents.remote import RemoteAgent\n"
        f"sock = {os.path.join(tmp, 'stack.sock')!r}\n"
        "os.environ['MMFN_BRIDGE_SOCKET'] = sock\n"
        "warnings.simplefilter('ignore', RuntimeWarning)\n"
        "stack = threading.Thread(target=runpy.run_module, daemon=True, args=(\n"
        "    'mmfn_tpu_torch.harness.agents.remote',), kwargs={'run_name': '__main__'})\n"
        "stack.start()\n"
        "agent = RemoteAgent({'socket': sock, 'stepping': True})\n"
        "agent.set_global_plan([({'lat': 0.0, 'lon': 0.0, 'z': 0.0}, 4),\n"
        "                       ({'lat': 0.001, 'lon': 0.0, 'z': 0.0}, 4)],\n"
        "                      [((0.0, 0.0), 4), ((111.0, 0.0), 4)])\n"
        "for spec in agent.sensors():\n"
        "    agent.sensor_interface.register_sensor(spec['id'])\n"
        "for t in range(5):\n"
        "    agent.sensor_interface.update_sensor('gps', np.zeros(3), t)\n"
        "    agent.sensor_interface.update_sensor('imu', np.zeros(7), t)\n"
        "    agent.sensor_interface.update_sensor('speed', {'speed': 1.0}, t)\n"
        "    control = agent(0.05 * t)\n"
        "    while t == 0 and not agent.step_mode_possible:   # the first control\n"
        "        time.sleep(0.01)\n"
        "agent.destroy()\n"
        "stack.join(10)\n"
        "assert not stack.is_alive() and control.throttle == 0.7, control\n")


def _metrics_cli_entry(tmp):
    """A recording made here, then ``python -m mmfn_tpu_torch.harness.metrics_run``
    (runpy) with the port's comfort metric over it."""
    from mmfn_tpu_torch.harness.phase0 import FALLBACK_XODR

    return (
        "import runpy, sys\n"
        "from mmfn_tpu_torch.harness.agents.trivial import NpcAgent\n"
        "from mmfn_tpu_torch.harness.recording import EpisodeRecorder\n"
        "from mmfn_tpu_torch.harness.replay import ClosedLoopRunner\n"
        "from mmfn_tpu_torch.harness.route import RouteConfig\n"
        "rec = EpisodeRecorder()\n"
        "ClosedLoopRunner().run_route(NpcAgent(), RouteConfig(route_id='0', town='T',\n"
        f"    trajectory=[(0.0, 1.75, 0.0), (60.0, 1.75, 0.0)]), {FALLBACK_XODR!r},\n"
        "    max_ticks=20, recorder=rec, world_kwargs={'lidar_points': 100})\n"
        f"rec.save({os.path.join(tmp, 'episode.json')!r})\n"
        "sys.argv = ['metrics_run', '--no-map', '--log',\n"
        f"    {os.path.join(tmp, 'episode.json')!r}, '--out', {tmp!r}, '--metric',\n"
        "    'mmfn_tpu_torch/harness/metric_examples/comfort.py']\n"
        "try:\n"
        "    runpy.run_module('mmfn_tpu_torch.harness.metrics_run', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        f"assert open({os.path.join(tmp, 'Comfort.json')!r}).read()\n")


@pytest.mark.parametrize("entry", [_remote_stack_entry, _metrics_cli_entry],
                         ids=["remote_stack", "metrics_cli"])
def test_entry_runs_without_torch(tmp_path, entry):
    """The remote stack and the metrics CLI run in a fresh interpreter
    without importing torch (a torch import costs seconds a process)."""
    code = entry(str(tmp_path)) + (
        "import sys\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'jax', 'jaxlib', 'flax', 'mmfn_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-1] == "ok"
