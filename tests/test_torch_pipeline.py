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


def test_port_sources_import_neither_jax_nor_the_jax_package():
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
                assert top not in ("jax", "jaxlib", "flax", "mmfn_tpu"), f"{path}: {name}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import mmfn_tpu_torch\n"
        "for m in pkgutil.walk_packages(mmfn_tpu_torch.__path__, 'mmfn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'mmfn_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in new if m.startswith('mmfn_tpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.strip()) >= 20
