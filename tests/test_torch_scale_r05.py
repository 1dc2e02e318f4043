"""The port's round-5 recipe (``tools/scale_r05.py``) against the JAX
package's ``scripts/collect_r05.sh`` and ``scripts/train_r05.sh``, and the
preload caches' writer, on the CPU.

- The shell scripts, parsed: the same collection legs in the same order and
  the same phase0 overrides, the same phase1 and phase2 overrides, the same
  ``DONE`` and skip rules; only the entry points differ.
- One r05 collection leg with its whole override set (scenarios, 10
  background vehicles, offset repetitions, a rain weather), cut to 2
  repetitions and 20 ticks a route, through the port's phase0 and the JAX
  CLI: equal checkpoint records and equal frame trees; a collection leg
  loads no torch.
- ``PreprocessedDataset`` and ``CarlaDataset`` list their pool again when
  their preload cache is empty or half written, and the cache writer never
  leaves a partial file under the cache's name.
- What ``collect`` and ``train`` report of each stage, without their
  processes.
"""

import json
import os
import re
import shlex
import subprocess
import sys

import pytest
import torch

from mmfn_tpu.mapping import rough_map as jax_rough_map

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.data import dataset
from mmfn_tpu_torch.harness import phase0
from mmfn_tpu_torch.tools import scale_r05
from tests.test_torch_collect import assert_trees_equal, jax_cli, map_tool  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads while this module runs: the tests run beside
    other workers, and a worker's default of one thread per core
    oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------- #
# the recipe against the shell scripts
# --------------------------------------------------------------------------- #

def _script(name):
    """(variables, commands) of a recipe script: its ``X="..."`` lines, and
    each ``python ...`` command (continuation lines joined) as its words,
    quotes removed and variables left unexpanded."""
    with open(os.path.join(ROOT, "scripts", name)) as f:
        text = f.read().replace("\\\n", " ")
    variables = {}
    for m in re.finditer(r"^([A-Z_]+)=(.*)$", text, re.M):
        variables[m.group(1)] = shlex.split(m.group(2))[0] if m.group(2) else ""
    commands = [shlex.split(m.group(0))
                for m in re.finditer(r"^\s*python .*$", text, re.M)]
    return variables, commands


def _expand(word, variables):
    """The script's variables in the recipe's placeholders: $W / ${W} the
    weather, $DATA and $ROOT the folders; $SCEN and the town lists by value."""
    for name in ("SCEN", "TRAIN_TOWNS", "VAL_TOWNS"):
        if name in variables:
            word = word.replace(f"${name}", variables[name])
    return (word.replace("${W}", "{W}").replace("$W", "{W}")
            .replace("$DATA", "{DATA}").replace("$ROOT", "{ROOT}"))


def test_collect_legs_are_the_shell_scripts():
    variables, commands = _script("collect_r05.sh")
    assert re.search(r"for W in ClearNoon WetNoon MidRainNoon HardRainNoon; do",
                     open(os.path.join(ROOT, "scripts", "collect_r05.sh")).read())
    assert variables["ROOT"] == "${ROOT:-/tmp/mmfn_r05}" and variables["DATA"] == "$ROOT/data/mmfn"
    assert len(commands) == len(scale_r05.COLLECT_LEGS) == 3
    for words, (_, overrides) in zip(commands, scale_r05.COLLECT_LEGS):
        assert words[:4] == ["python", "run_steps/phase0_run_eval.py", "--config",
                             scale_r05.COLLECT_YAML]
        assert [_expand(w, variables) for w in words[4:]] == list(overrides)

    # every weather in the script's order, each with its three legs in turn
    root = "/r"
    cmds = scale_r05.collect_commands(root)
    assert len(cmds) == 12 and scale_r05.WEATHERS == (
        "ClearNoon", "WetNoon", "MidRainNoon", "HardRainNoon")
    subs = {"ROOT": root, "DATA": "/r/data/mmfn"}
    want = [[_expand(x, variables).format(W=w, **subs) for x in words[4:]]
            for w in scale_r05.WEATHERS for words in commands]
    assert all(c[3:5] == ["--config", scale_r05.COLLECT_YAML] for c in cmds)
    assert [c[:3] for c in cmds] == [[sys.executable, "-m",
                                      "mmfn_tpu_torch.harness.phase0"]] * 12
    assert [c[5:] for c in cmds] == want
    assert scale_r05.collect_commands(root, ["WetNoon"], legs=["val"], extra=["max_ticks=5"]) \
        == [cmds[5] + ["max_ticks=5"]]


def test_train_runs_are_the_shell_scripts():
    variables, commands = _script("train_r05.sh")
    assert variables["ROOT"] == "${ROOT:-/tmp/mmfn_r05}" and variables["DATA"] == "$ROOT/data/mmfn"
    phase1, phase2 = commands
    root = "/r"
    subs = {"ROOT": root, "DATA": "/r/data/mmfn"}

    def expand(words):
        return [_expand(w, variables).format(**subs) for w in words]

    assert phase1[:4] == ["python", "run_steps/phase1_preprocess_data.py", "--config",
                          scale_r05.TRAIN_YAML]
    assert scale_r05.phase1_command(root)[:3] == [sys.executable, "-m",
                                                  "mmfn_tpu_torch.data.phase1"]
    assert scale_r05.phase1_command(root)[3:] == ["--config", scale_r05.TRAIN_YAML] + \
        expand(phase1[4:])

    # train (): entry_point logdir extra-overrides... in the script's order
    calls = re.findall(r"^train (\w+) (\w+) (.*)$",
                       open(os.path.join(ROOT, "scripts", "train_r05.sh")).read(), re.M)
    assert [(e, d, tuple(o.split())) for e, d, o in calls] == list(scale_r05.TRAIN_RUNS)
    assert phase2[:5] == ["python", "-u", "run_steps/phase2_train_net.py", "--config",
                          scale_r05.TRAIN_YAML]
    for run in scale_r05.TRAIN_RUNS:
        entry, logdir, overrides = run
        words = [w.replace("$entry", entry).replace("$logdir", logdir) for w in phase2[5:]]
        want = expand(words[:-1]) + list(overrides)     # "$@": the run's own overrides
        assert words[-1] == '$@'
        got = scale_r05.train_command(root, run)
        assert got[:4] == [sys.executable, "-u", "-m", "mmfn_tpu_torch.train.phase2"]
        assert got[4:6] == ["--config", scale_r05.TRAIN_YAML] and got[6:] == want

    # the town lists follow the weathers given
    assert scale_r05.town_lists(["ClearNoon"]) == (
        "train_towns=[CrossClearNoon,LoopClearNoon]", "val_towns=[ValClearNoon]")


def _phase1_pools(root, train=5, eval=2):
    for split, n in (("train", train), ("eval", eval)):
        _pool(os.path.join(root, "data", f"pro_{split}_fmmfn"), n)


def test_train_skips_done_runs_and_existing_pools(tmp_path, monkeypatch):
    """phase1 is skipped once its training pool exists, a run with a DONE
    marker is skipped, and each run that ends gets its marker; each stage
    that ran is reported with its seconds, phase 1's with its pools."""
    ran = []

    def run(cmd):
        ran.append(cmd)
        if "mmfn_tpu_torch.data.phase1" in cmd:
            _phase1_pools(root)
        return 1.5
    monkeypatch.setattr(scale_r05, "_run", run)
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "log", "mmfn_vec"))
    open(os.path.join(root, "log", "mmfn_vec", "DONE"), "w").close()
    for name in ("mmfn_rad", "mmfn_img", "aim"):
        os.makedirs(os.path.join(root, "log", name))
    open(os.path.join(root, "log", "aim", "best_model.pth"), "w").close()
    stages = scale_r05.train(root, ["ClearNoon"], extra=["epochs=1"])
    assert [c[c.index("-m") + 1] for c in ran] == ["mmfn_tpu_torch.data.phase1"] + \
        ["mmfn_tpu_torch.train.phase2"] * 3
    assert [c[-1] for c in ran[1:]] == ["epochs=1"] * 3
    assert stages == [{"stage": "phase1", "seconds": 1.5, "train": 5, "eval": 2}] + [
        {"stage": name, "seconds": 1.5} for name in ("mmfn_rad", "mmfn_img", "aim")]
    assert scale_r05.best_checkpoints(root) == [
        os.path.join(root, "log", "aim", "best_model.pth")]
    for name in ("mmfn_rad", "mmfn_img", "aim"):
        assert os.path.exists(os.path.join(root, "log", name, "DONE"))
    ran.clear()
    assert scale_r05.train(root, ["ClearNoon"]) == [] and ran == []


def test_collect_reports_each_leg(tmp_path, monkeypatch):
    """Each leg in its own process, in the recipe's order, reported with its
    weather, seconds and the frames in its own data folder."""
    ran = []

    def run(cmd):
        ran.append(cmd)
        save = next(a for a in cmd if a.startswith("agent.data_save=")).split("=", 1)[1]
        meas = os.path.join(save, f"route_{len(ran):02d}", "measurements")
        os.makedirs(meas)
        for i in range(len(ran)):
            open(os.path.join(meas, f"{i:04d}.json"), "w").close()
        return 2.0
    monkeypatch.setattr(scale_r05, "_run", run)
    root = str(tmp_path)
    done = scale_r05.collect(root, ["WetNoon", "ClearNoon"], legs=["cross", "val"],
                             extra=["max_ticks=7"])
    assert ran == scale_r05.collect_commands(root, ["WetNoon", "ClearNoon"],
                                             legs=["cross", "val"], extra=["max_ticks=7"])
    assert [(d["weather"], d["leg"], d["seconds"], d["frames"]) for d in done] == [
        ("WetNoon", "cross", 2.0, 1), ("WetNoon", "val", 2.0, 2),
        ("ClearNoon", "cross", 2.0, 3), ("ClearNoon", "val", 2.0, 4)]
    assert scale_r05.frame_count(scale_r05.data_folder(root)) == 10


def test_a_failing_stage_ends_the_recipe():
    """``_run`` returns a stage's seconds, and raises when it fails."""
    assert scale_r05._run([sys.executable, "-c", "pass"]) >= 0.0
    with pytest.raises(subprocess.CalledProcessError):
        scale_r05._run([sys.executable, "-c", "raise SystemExit(3)"])


def test_cli_root_from_the_environment(monkeypatch):
    seen = []
    monkeypatch.setattr(scale_r05, "collect", lambda root: seen.append(("collect", root)))
    monkeypatch.setattr(scale_r05, "train", lambda root: seen.append(("train", root)))
    monkeypatch.setenv("ROOT", "/tmp/r05_env")
    assert scale_r05.main(["collect"]) == 0
    monkeypatch.delenv("ROOT")
    assert scale_r05.main(["train"]) == 0
    assert scale_r05.main(["train", "--root", "/tmp/x"]) == 0
    assert seen == [("collect", "/tmp/r05_env"), ("train", scale_r05.DEFAULT_ROOT),
                    ("train", "/tmp/x")]


# --------------------------------------------------------------------------- #
# one r05 leg through both CLIs
# --------------------------------------------------------------------------- #

def test_r05_leg_collects_like_the_jax_cli(map_tool, jax_cli, tmp_path, monkeypatch):
    """The cross-town leg's overrides, all together, in a rain weather, cut
    to 2 repetitions (the second offset) and 20 ticks a route: the port's
    phase0 and the JAX CLI write equal checkpoints and frame trees."""
    monkeypatch.chdir(ROOT)
    trees = {}
    for who in ("port", "jax"):
        root = str(tmp_path / who)
        cmd = scale_r05.collect_commands(root, ["MidRainNoon"], legs=["cross"],
                                         extra=["repetitions=2", "max_ticks=20"])[0]
        assert "background_traffic=10" in cmd and "collect_offsets=true" in cmd
        assert any(a.startswith("scenarios=") for a in cmd)
        args = cmd[3:]
        if who == "port":
            assert phase0.main(args + ["agent.rmap_tool=" + map_tool]) == 0
        else:
            monkeypatch.setattr(jax_rough_map, "default_tool_path", lambda: map_tool)
            monkeypatch.setattr(sys, "argv", ["phase0_run_eval.py"] + args)
            jax_cli.main()
        with open(os.path.join(root, "collect_cross_MidRainNoon.json")) as f:
            trees[who] = (json.load(f), os.path.join(scale_r05.data_folder(root),
                                                     "CrossMidRainNoon_short"))
    (got, got_root), (want, want_root) = trees["port"], trees["jax"]
    for key in ("values", "labels", "entry_status", "eligible"):
        assert got[key] == want[key], key
    assert got["_checkpoint"]["progress"] == want["_checkpoint"]["progress"] == [6, 6]
    rec_got, rec_want = got["_checkpoint"]["records"], want["_checkpoint"]["records"]
    assert len(rec_got) == len(rec_want) == 6
    for g, w in zip(rec_got, rec_want):
        g["meta"].pop("duration_system")
        w["meta"].pop("duration_system")
        assert g == w
    routes = sorted(os.listdir(want_root))
    assert sorted(os.listdir(got_root)) == routes == [f"route_{i:02d}" for i in range(6)]
    for route in routes:
        assert_trees_equal(os.path.join(got_root, route), os.path.join(want_root, route))
    assert scale_r05.frame_count(got_root) == scale_r05.frame_count(want_root) > 0


def test_collection_loads_no_torch(map_tool, tmp_path):
    """An expert run of phase0 (a collection leg, the expert's scored leg)
    never imports torch, so that the legs that run at once stay small."""
    code = ("import sys; from mmfn_tpu_torch.harness import phase0; "
            "phase0.main(sys.argv[1:]); sys.exit('torch' in sys.modules)")
    leg = scale_r05.collect_commands(str(tmp_path), ["ClearNoon"], legs=["val"], extra=[
        "max_ticks=12", "agent.rmap_tool=" + map_tool])[0]
    assert subprocess.run([sys.executable, "-c", code, *leg[3:]], cwd=ROOT,
                          capture_output=True).returncode == 0
    assert scale_r05.frame_count(scale_r05.data_folder(str(tmp_path))) == 1


# --------------------------------------------------------------------------- #
# the preload caches
# --------------------------------------------------------------------------- #

def _pool(root, n=3):
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        open(os.path.join(root, f"{i}.pkl"), "wb").close()
    return str(root)


def _town(root, frames=12):
    """A raw town tree as CarlaDataset indexes it: frame files in rgb_front."""
    d = os.path.join(root, "route_00", "rgb_front")
    os.makedirs(d)
    for i in range(frames):
        open(os.path.join(d, f"{i:04d}.png"), "wb").close()
    return str(root)


BROKEN = {"empty": "", "half_written": '["0.pkl", "1.p'}


@pytest.mark.parametrize("cache", list(BROKEN))
def test_preprocessed_pool_relists_a_broken_cache(tmp_path, cache):
    root = _pool(tmp_path / "pool")
    with open(os.path.join(root, "preload_files.json"), "w") as f:
        f.write(BROKEN[cache])
    files = dataset.PreprocessedDataset(root).files
    assert files == [os.path.join(root, f"{i}.pkl") for i in range(3)]
    with open(os.path.join(root, "preload_files.json")) as f:
        assert json.load(f) == ["0.pkl", "1.pkl", "2.pkl"]


@pytest.mark.parametrize("cache", list(BROKEN))
def test_raw_index_relists_a_broken_cache(tmp_path, cache):
    town = _town(tmp_path / "TownX_short")
    want = dataset.CarlaDataset([town], GlobalConfig(), use_preload=False).frames
    assert len(want) == 6
    with open(os.path.join(town, "preload_index_1_4.json"), "w") as f:
        f.write(BROKEN[cache])
    assert dataset.CarlaDataset([town], GlobalConfig()).frames == want
    with open(os.path.join(town, "preload_index_1_4.json")) as f:
        assert json.load(f) == want


@pytest.mark.parametrize("which", ["preprocessed", "raw_index"])
def test_cache_writer_leaves_no_partial_file(tmp_path, monkeypatch, which):
    """A writer that fails half way (here json.dump, after writing a part)
    leaves nothing under the cache's name, and nothing beside it."""
    if which == "preprocessed":
        root = _pool(tmp_path / "pool")
        cache = os.path.join(root, "preload_files.json")
        build = lambda: dataset.PreprocessedDataset(root)   # noqa: E731
    else:
        root = _town(tmp_path / "TownX_short")
        cache = os.path.join(root, "preload_index_1_4.json")
        build = lambda: dataset.CarlaDataset([root], GlobalConfig())   # noqa: E731
    before = sorted(os.listdir(root))

    def dump(obj, f):
        f.write(json.dumps(obj)[:5])
        f.flush()
        raise RuntimeError("stopped while writing")

    monkeypatch.setattr(dataset.json, "dump", dump)
    with pytest.raises(RuntimeError, match="stopped while writing"):
        build()
    assert not os.path.exists(cache)
    assert sorted(os.listdir(root)) == before
    monkeypatch.undo()
    build()
    with open(cache) as f:
        assert json.load(f)
