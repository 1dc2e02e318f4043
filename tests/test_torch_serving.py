"""The port's serving export (mmfn_tpu_torch.serving, torch.export) against the
JAX package's (mmfn_tpu.serving, jax.export), on the CPU; mirrors
tests/test_serving.py.

One artifact, exported at batch 2 with a symbolic batch dimension, is saved,
loaded and served at batches 1 and 3, against the port's eager forward and
JAX's ``model.apply`` on the same weights, within rtol 1e-4 / atol 1e-4.
Under ``attn_impl="pallas"`` the graph holds kernel 2's operator
(``mmfn::fused_attention``), whose CPU kernel is the plain version. The
weights stay outside the artifact.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmfn_tpu.config import GlobalConfig as JaxConfig
from mmfn_tpu.data.batch import Batch as JaxBatch
from mmfn_tpu.models import build_model as jax_build_model
from mmfn_tpu.utils.weights import convert_mmfn
from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.data.batch import Batch
from mmfn_tpu_torch.models import build_model
from mmfn_tpu_torch.models.resnet import resnet34
from mmfn_tpu_torch.ops import attention
from mmfn_tpu_torch.serving import export as ex
from mmfn_tpu_torch.serving import export_forward, load_exported, save_exported, serving_call
from mmfn_tpu_torch.utils.weights import _MAP_STEM
from tests.test_torch_models import _inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
OP = "mmfn.fused_attention.default"


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads while this module runs: the tests run beside
    other workers, and a worker's default of one thread per core
    oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def map_stem():
    """Zeros under the map ResNet's stem and layer1 keys, which vec and rad do
    not own but convert_mmfn reads."""
    stem = resnet34(3).state_dict()
    sd = {"encoder.img_map_encoder.features." + k: np.zeros(tuple(v.shape), np.float32)
          for k, v in stem.items()}
    return {k: v for k, v in sd.items() if k.startswith(_MAP_STEM)}


def port_and_jax(variant, n_layer, max_lanes, attn_impl, seed=0):
    """(port MMFN, JAX model, its variables) on one set of weights: the
    port's seeded init with every bias, norm scale and position embedding
    perturbed and the BN statistics drawn at random, carried to the JAX
    package by its own ``convert_mmfn`` (no JAX init to compile)."""
    kw = dict(n_layer=n_layer, max_lanes=max_lanes, attn_impl=attn_impl)
    port = build_model(GlobalConfig(**kw), variant, torch.Generator().manual_seed(seed),
                       device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in port.modules():
            for name in ("bias", "pos_emb") + (("weight",) if isinstance(
                    m, (torch.nn.LayerNorm, torch.nn.BatchNorm2d)) else ()):
                p = getattr(m, name, None)
                if isinstance(p, torch.Tensor):
                    p.add_(0.1 * torch.randn(p.shape, generator=g))
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.3, 0.3, generator=g)
                m.running_var.uniform_(0.7, 1.3, generator=g)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    if variant != "img":
        sd.update(map_stem())
    variables = convert_mmfn(sd, variant, n_layer)
    if variant != "img":
        for coll in variables.values():
            for name in ["conv1", "bn1"] + [f"layer1_{j}" for j in range(3)]:
                coll["encoder"]["img_map_encoder"].pop(name, None)
    jmodel = jax_build_model(JaxConfig(matmul_precision="highest", **kw), variant)
    return port, jmodel, variables


@pytest.fixture(scope="module")
def tiny_rad():
    """JAX MMFN-rad (n_layer 1, 8 lanes, 64 px), the port's on the same
    weights under the kernel-2 path, and its artifact."""
    port, jmodel, variables = port_and_jax("rad", 1, 8, "pallas")
    sample = _batch(2, seed=10)
    return jmodel, variables, port, export_forward(port, ex.model_params(port), sample)


def _data(b, seed):
    return _inputs(np.random.default_rng(seed), b, 64, 8)


def _batch(b, seed):
    return Batch(**{k: torch.from_numpy(v) for k, v in _data(b, seed).items()})


def _graph_ops(exported):
    return [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]


def test_export_roundtrip_symbolic_batch(tiny_rad, tmp_path):
    jmodel, variables, port, exported = tiny_rad
    path = str(tmp_path / "m.pt2")
    save_exported(exported, path)
    assert not os.path.exists(path + ".tmp")
    call = serving_call(load_exported(path))
    params = ex.model_params(port)
    data = _data(4, seed=20)
    # JAX's forward once over the 4 samples (its inference is per sample)
    want = np.asarray(jax.jit(jmodel.apply, static_argnums=(2,))(
        variables, JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()}), False))
    for rows in (slice(0, 1), slice(1, 4)):
        batch = Batch(**{k: torch.from_numpy(v[rows]) for k, v in data.items()})
        got = call(params, batch)
        with torch.inference_mode():
            eager = port(batch)
        assert got.shape == (rows.stop - rows.start, 4, 2)
        np.testing.assert_allclose(got.numpy(), eager.numpy(), **TOL)
        np.testing.assert_allclose(got.numpy(), want[rows], **TOL)


def test_the_graph_holds_kernel_2(tiny_rad):
    *_, port, exported = tiny_rad
    assert _graph_ops(exported).count(OP) == 4 * port.config.n_layer
    assert not exported.graph_signature.parameters and not exported.graph_signature.buffers


def test_the_artifact_holds_no_weights(tiny_rad, tmp_path):
    *_, port, exported = tiny_rad
    assert not exported.state_dict
    # the only constants: the ImageNet mean and std of the camera's affine
    assert sorted(tuple(c.shape) for c in exported.constants.values()) == [(3,), (3,)]
    path = tmp_path / "m.pt2"
    save_exported(exported, str(path))
    weight_bytes = sum(p.numel() * p.element_size() for p in ex.model_params(port).values())
    assert os.path.getsize(path) < weight_bytes / 50


def test_serving_moves_the_program_to_the_weights_device(tiny_rad):
    """An artifact traced on the CPU serves on another device: the devices
    tracing baked into the graph move with it (the meta device stands in for
    the card here)."""
    *_, port, exported = tiny_rad
    params = {k: v.to("meta") for k, v in ex.model_params(port).items()}
    batch = Batch(**{k: v.to("meta") for k, v in _batch(3, seed=30)._asdict().items()
                     if v is not None})
    out = serving_call(exported)(params, batch)
    assert out.device.type == "meta" and out.shape == (3, 4, 2)


@pytest.mark.slow
def test_plain_attention_exports_without_the_operator():
    port = build_model(GlobalConfig(n_layer=1, max_lanes=8), "vec", device="cpu")
    exported = export_forward(port, ex.model_params(port), _batch(2, seed=40),
                              symbolic_batch=False)
    assert OP not in _graph_ops(exported)
    got = serving_call(exported)(ex.model_params(port), _batch(2, seed=41))
    with torch.inference_mode():
        np.testing.assert_allclose(got.numpy(), port(_batch(2, seed=41)).numpy(), **TOL)


def test_the_operator_has_no_backward():
    q = torch.randn(1, 4, 8, 16, requires_grad=True)
    out = attention.fused_attention_op(q, q.detach(), q.detach())
    torch.testing.assert_close(out, attention.attention_plain(q, q, q))
    assert out.transpose(1, 2).is_contiguous()       # the kernel's layout
    with pytest.raises(RuntimeError, match="the CUDA kernel has no backward"):
        out.sum().backward()


def test_the_written_out_gru_step_is_the_cell():
    """While exporting, the decoder writes the GRU step out (nn.GRUCell's
    fused CUDA operator has no tracing rule): the same gates."""
    from mmfn_tpu_torch.models.decoder import gru_step

    g = torch.Generator().manual_seed(0)
    cell = torch.nn.GRUCell(2, 64)
    x, h = torch.randn(3, 2, generator=g), torch.randn(3, 64, generator=g)
    with torch.no_grad():
        torch.testing.assert_close(gru_step(cell, x, h), cell(x, h), rtol=1e-6, atol=1e-6)


def test_export_cli_refuses_platforms():
    from mmfn_tpu_torch.serving import export_model

    with pytest.raises(SystemExit):
        export_model.main(["--logdir", "x", "--out", "y", "--platforms", "tpu,cpu"])


@pytest.mark.slow
def test_export_cli(tmp_path):
    """python -m mmfn_tpu_torch.serving.export_model: checkpoint dir ->
    artifact + external weights, served as its docstring says."""
    from mmfn_tpu_torch.data.synthetic import synthetic_batch

    model = build_model(GlobalConfig(n_layer=1, max_lanes=8), "rad", device="cpu")
    logdir = tmp_path / "run"
    logdir.mkdir()
    torch.save(model.state_dict(), logdir / "best_model.pth")
    out = str(tmp_path / "rad.pt2")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "mmfn_tpu_torch.serving.export_model",
         "--logdir", str(logdir), "--variant", "rad", "--out", out, "--cpu",
         "--n-layer", "1", "--max-lanes", "8", "--resolution", "64"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    params = torch.load(os.path.splitext(out)[0] + ".vars.pth", weights_only=True)
    batch = synthetic_batch(batch_size=3, max_lanes=8, resolution=64, device="cpu")
    got = serving_call(load_exported(out))(params, batch)
    with torch.inference_mode():
        want = model(batch)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
