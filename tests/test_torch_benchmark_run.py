"""The port's benchmark runner (mmfn_tpu_torch.harness.benchmark_run) against
run_steps/benchmark_run.py, on the CPU.

The JAX script is loaded with importlib (it imports no jax). Its legs run
the JAX phase0 CLI; here that CLI runs in process, with the map tool of
this module (native/rough_map_node.cpp built by g++ into a temporary
directory). The port's legs run the port's phase0 CLI in subprocesses, as a
user runs them, with ``agent.rmap_tool`` pointed at the same tool.
"""

import glob
import importlib.util
import io
import json
import os
import subprocess
import sys
import types

import pytest
import torch

import mmfn_tpu.mapping.rough_map as jax_rough_map
from mmfn_tpu_torch.harness import benchmark_run as port_runner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R05 = os.path.join(ROOT, "results", "benchmark_r05")
SMOKE_LEGS = [("TownTest", "data/maps/fake_town_cross.xodr", "data/routes/smoke_route.xml")]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads while this module runs: the tests run beside
    other workers, and a worker's default of one thread per core
    oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_runner():
    return _load("jax_benchmark_run", os.path.join(ROOT, "run_steps", "benchmark_run.py"))


@pytest.fixture(scope="module")
def map_tool(tmp_path_factory):
    """native/rough_map_node.cpp built into this module's own directory."""
    path = tmp_path_factory.mktemp("rough_map_node") / "rough_map_node"
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", str(path),
                    os.path.join(ROOT, "native", "rough_map_node.cpp")],
                   check=True, capture_output=True, timeout=300)
    return str(path)


def _r05_paths():
    paths = {}
    for path in sorted(glob.glob(os.path.join(R05, "*.json"))):
        agent, town, weather = os.path.basename(path)[:-len(".json")].split("_")
        paths[(agent, town, weather)] = path
    return paths


def test_aggregate_matches_jax_byte_for_byte(jax_runner):
    paths = _r05_paths()
    assert len(paths) == 20
    got = port_runner.aggregate(paths)
    assert got == jax_runner.aggregate(paths)
    # the round-5 table was written by the JAX script from these legs
    with open(os.path.join(R05, "TABLE.md")) as f:
        assert got in f.read()
    # a leg without a checkpoint is a row without data, in both
    missing = {**paths, ("vec", "TownCross", "ClearNoon"): os.path.join(R05, "none.json")}
    assert port_runner.aggregate(missing) == jax_runner.aggregate(missing)
    assert "| vec | TownCross | ClearNoon | _no data_ |" in port_runner.aggregate(missing)


@pytest.mark.parametrize("agent", ["expert", "vec", "rad", "img", "aim", "cilrs", "transfuser"])
def test_agent_overrides_match_jax(jax_runner, agent):
    """The same overrides and checkpoint directory; the checkpoint inside it
    is the port's best_model.pth (phase0 reads it), the JAX one's
    best_model.msgpack."""
    assert port_runner.agent_overrides(agent, "/m") == jax_runner.agent_overrides(agent, "/m")


def _args(out, **kw):
    return types.SimpleNamespace(out=str(out), model_root="log", traffic=0, max_wall=60.0,
                                 device="cpu", **kw)


def test_leg_command_runs_the_port_phase0(tmp_path):
    cmd = port_runner.leg_command("rad", "m.xodr", "r.xml", "ClearNoon",
                                  str(tmp_path / "x.json"), _args(tmp_path))
    assert cmd[:3] == [sys.executable, "-m", "mmfn_tpu_torch.harness.phase0"]
    assert "device=cpu" in cmd and "agent.variant=rad" in cmd
    assert "agent.model_path=" + os.path.join("log", "mmfn_rad") in cmd
    on_card = _args(tmp_path)
    on_card.device = None
    on_card = port_runner.leg_command("rad", "m.xodr", "r.xml", "ClearNoon", "x.json", on_card)
    assert not any(a.startswith("device=") for a in on_card)


def test_complete_leg_is_skipped_without_a_subprocess(tmp_path, monkeypatch, capsys):
    endpoint = tmp_path / "expert_TownTest_ClearNoon.json"
    endpoint.write_text(json.dumps({"_checkpoint": {"progress": [1, 1]}}))

    def refuse(*a, **k):
        raise AssertionError("a complete leg launched a subprocess")

    monkeypatch.setattr(port_runner.subprocess, "run", refuse)
    got = port_runner.run_leg("expert", "TownTest", *SMOKE_LEGS[0][1:], "ClearNoon",
                              _args(tmp_path))
    assert got == str(endpoint)
    assert "already complete" in capsys.readouterr().out
    # an unfinished leg is run again
    endpoint.write_text(json.dumps({"_checkpoint": {"progress": [0, 1]}}))
    with pytest.raises(AssertionError, match="launched a subprocess"):
        port_runner.run_leg("expert", "TownTest", *SMOKE_LEGS[0][1:], "ClearNoon",
                            _args(tmp_path))


def test_a_failed_leg_fails_the_benchmark(tmp_path, monkeypatch):
    monkeypatch.setattr(port_runner, "LEGS", SMOKE_LEGS)
    monkeypatch.setattr(port_runner, "leg_command",
                        lambda *a: [sys.executable, "-c", "raise SystemExit(3)"])
    with pytest.raises(SystemExit, match="benchmark legs failed"):
        port_runner.main(["--agents", "expert", "--weathers", "ClearNoon",
                          "--out", str(tmp_path)])
    assert not (tmp_path / "TABLE.md").exists()


def _run_jax_phase0_in_process(jax_cli, tool, monkeypatch):
    """A stand-in for the JAX script's ``subprocess.run``: its phase0 command
    run in this interpreter, output to the leg's log."""
    def run(cmd, cwd, stdout, stderr):
        assert cmd[1].endswith(os.path.join("run_steps", "phase0_run_eval.py"))
        monkeypatch.setattr(jax_rough_map, "default_tool_path", lambda: tool)
        monkeypatch.setattr(sys, "argv", ["phase0_run_eval.py"] + cmd[2:])
        monkeypatch.chdir(cwd)
        out = io.StringIO()
        with monkeypatch.context() as m:
            m.setattr(sys, "stdout", out)
            jax_cli.main()
        stdout.write(out.getvalue())
        return subprocess.CompletedProcess(cmd, 0)

    return types.SimpleNamespace(run=run, STDOUT=subprocess.STDOUT)


def test_expert_leg_matches_jax(jax_runner, map_tool, tmp_path, monkeypatch):
    """One expert leg on smoke_route.xml (traffic 2) through both runners:
    equal global records and equal tables; a second run of the port's is
    complete and launches nothing; --aggregate-only rewrites TABLE.md byte
    for byte."""
    argv = ["--agents", "expert", "--weathers", "ClearNoon", "--traffic", "2",
            "--max-wall", "120"]
    monkeypatch.setattr(port_runner, "LEGS", SMOKE_LEGS)
    launch = port_runner.leg_command
    monkeypatch.setattr(port_runner, "leg_command",
                        lambda *a: launch(*a) + ["agent.rmap_tool=" + map_tool])
    port_out = tmp_path / "port"
    assert port_runner.main(argv + ["--out", str(port_out), "--device", "cpu"]) == 0

    jax_cli = _load("jax_phase0_run_eval", os.path.join(ROOT, "run_steps",
                                                         "phase0_run_eval.py"))
    monkeypatch.setattr(jax_runner, "LEGS", SMOKE_LEGS)
    monkeypatch.setattr(jax_runner, "subprocess",
                        _run_jax_phase0_in_process(jax_cli, map_tool, monkeypatch))
    jax_out = tmp_path / "jax"
    monkeypatch.setattr(sys, "argv", ["benchmark_run.py"] + argv + ["--out", str(jax_out)])
    jax_runner.main()

    name = "expert_TownTest_ClearNoon.json"
    records = []
    for out in (port_out, jax_out):
        with open(out / name) as f:
            records.append(json.load(f)["_checkpoint"]["global_record"])
    assert records[0] == records[1]
    assert records[0]["status"] == "Completed"
    assert (port_out / "TABLE.md").read_bytes() == (jax_out / "TABLE.md").read_bytes()

    table = (port_out / "TABLE.md").read_bytes()
    monkeypatch.setattr(port_runner.subprocess, "run", None)   # nothing may launch
    assert port_runner.main(argv + ["--out", str(port_out), "--device", "cpu"]) == 0
    (port_out / "TABLE.md").unlink()
    assert port_runner.main(argv + ["--out", str(port_out), "--aggregate-only"]) == 0
    assert (port_out / "TABLE.md").read_bytes() == table
