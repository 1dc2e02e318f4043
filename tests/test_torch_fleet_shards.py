"""Fleet serving split across devices, on the CPU: the port's counterpart
of ``shard_over_mesh`` / ``JitPipeline(mesh=)``.

``TorchPipeline`` and ``DeviceWorldPipeline`` given a list of devices hold
one replica per entry and split ``dispatch_fleet``'s rows into contiguous
shards (``harness/agents/pipeline.py:Replicas``). Both are held against the
JAX package's sharded pipelines beside their unsharded parity tests
(``tests/test_torch_pipeline.py``, ``tests/test_torch_device_world.py``),
whose models they share. Here:
- the split itself;
- the phase0 CLI with ``agent.fleet_devices=2 device=cpu fleet=2``: its
  fleet goes through two replicas, and its route records are those of
  ``agent.fleet_devices=1``; and (slow) those of the JAX CLI with
  ``agent.fleet_devices=2`` on the same weights;
- the device list ``agent.fleet_devices`` takes, and its refusal.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import jax
import pytest
import torch

from mmfn_tpu.config import GlobalConfig as JaxConfig
from mmfn_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from mmfn_tpu.mapping import rough_map as jax_rough_map
from mmfn_tpu.models import build_model as jax_build_model

from mmfn_tpu_torch.harness import phase0
from mmfn_tpu_torch.harness.agents.pipeline import Replicas
from mmfn_tpu_torch.utils.weights import from_flax_variables
from tests.test_torch_device_world import map_tool  # noqa: F401
from tests.test_torch_harness import _cli_args
from tests.test_torch_pipeline import MAX_LANES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET_ARGS = ["agent.variant=vec", "agent.n_layer=1", f"agent.max_lanes={MAX_LANES}",
              "fleet=2", "repetitions=2", "max_ticks=6"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def test_replicas_split_contiguously():
    reps = Replicas(torch.nn.Linear(2, 2), [torch.device("cpu")] * 2)
    assert reps.models[0] is not reps.models[1]
    assert all(torch.equal(a, b) for a, b in zip(reps.models[0].parameters(),
                                                 reps.models[1].parameters()))
    assert reps.bounds(8) == [(0, 4, 4), (4, 8, 4)]
    assert reps.bounds(7) == [(0, 4, 4), (4, 7, 4)]       # the last shard pads one row
    assert reps.bounds(1) == [(0, 1, 1)]                  # a shard with no row is skipped


def _phase0_records(map_tool, tmp_path, name, *extra):
    assert phase0.main(_cli_args(map_tool, tmp_path / f"{name}.json", *FLEET_ARGS, *extra)) == 0
    records = json.loads((tmp_path / f"{name}.json").read_text())["_checkpoint"]["records"]
    for r in records:
        r["meta"].pop("duration_system")
    return records


def test_phase0_fleet_devices_splits_the_fleet(map_tool, tmp_path, monkeypatch):  # noqa: F811
    """agent.fleet_devices=2 under device=cpu serves each fleet tick through
    two replicas, and writes the records of agent.fleet_devices=1."""
    widths = []
    run = Replicas.run

    def recording(self, n, shard_fn):
        widths.append(len(self.devices))
        return run(self, n, shard_fn)

    monkeypatch.setattr(Replicas, "run", recording)
    one = _phase0_records(map_tool, tmp_path, "one", "device=cpu", "agent.fleet_devices=1")
    assert set(widths) == {1}
    widths.clear()
    two = _phase0_records(map_tool, tmp_path, "two", "device=cpu", "agent.fleet_devices=2")
    assert widths and set(widths) == {2}
    assert len(one) == 2 and two == one


@pytest.mark.slow
def test_phase0_fleet_devices_matches_the_jax_cli(map_tool, tmp_path, monkeypatch):  # noqa: F811
    """Two routes in a fleet of 2 over two devices, MMFN-vec (n_layer 1, 16
    lanes) on the JAX CLI's own random init, carried to the port as a
    best_model.pth: the records are the JAX CLI's."""
    extra = [*FLEET_ARGS, "agent.fleet_devices=2"]
    jcfg = JaxConfig(max_lanes=MAX_LANES, n_layer=1)
    jmodel = jax_build_model(jcfg, "vec")
    variables = jax.jit(jmodel.init, static_argnums=(2,))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jax_synthetic_batch(batch_size=1, max_lanes=MAX_LANES), False)
    weights = tmp_path / "weights"
    weights.mkdir()
    torch.save(from_flax_variables(jax.tree.map(np.asarray, dict(variables)), "vec", 1),
               weights / "best_model.pth")
    assert phase0.main(_cli_args(map_tool, tmp_path / "port.json", *extra, "device=cpu",
                                 f"agent.model_path={weights}")) == 0

    spec = importlib.util.spec_from_file_location(
        "jax_phase0_run_eval", os.path.join(ROOT, "run_steps", "phase0_run_eval.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    monkeypatch.setattr(jax_rough_map, "default_tool_path", lambda: map_tool)
    monkeypatch.setattr(sys, "argv", ["phase0_run_eval.py"] + [
        a for a in _cli_args(map_tool, tmp_path / "jax.json", *extra)
        if not a.startswith("agent.rmap_tool")])
    jax_cli.main()
    got, want = (json.loads((tmp_path / f"{n}.json").read_text())["_checkpoint"]["records"]
                 for n in ("port", "jax"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        g["meta"].pop("duration_system")
        w["meta"].pop("duration_system")
        assert g == w


def test_phase0_fleet_devices_takes_the_first_visible_devices(monkeypatch):
    cfg = {"agent": {"fleet_devices": 2}}
    assert phase0.fleet_devices(cfg, torch.device("cpu")) == [torch.device("cpu")] * 2
    assert phase0.fleet_devices({"agent": {}}, torch.device("cpu")) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert phase0.fleet_devices(cfg, torch.device("cuda")) == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="fleet_devices=2 but only 1 devices"):
        phase0.fleet_devices(cfg, torch.device("cuda"))
