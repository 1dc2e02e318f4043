"""The round-5 reference-scale recipe: collect, preprocess and train from one root.

The port of the JAX package's ``scripts/collect_r05.sh`` and
``scripts/train_r05.sh``, run through the port's own CLIs, each stage in a
process of its own as the shell scripts run them:

- ``collect``: the expert drives both fake towns under the scenario triggers
  of ``data/scenarios/fake_towns_scenarios.json`` and 10 background
  vehicles, in four weathers (``COLLECT_LEGS``, one phase0 process a leg:
  ``python -m mmfn_tpu_torch.harness.phase0``). A weather is the three
  cross-town training routes with 10 laterally offset repetitions, the loop
  circuit with 4, and one pass of the held-out ``cross_straight_sn`` route:
  35 route-runs. Frames go to ``<root>/data/mmfn/<Town><Weather>_short``.
- ``train``: phase 1 over those trees (``python -m mmfn_tpu_torch.data.phase1``;
  skipped once ``<root>/data/pro_train_fmmfn`` exists), then phase 2 for the
  three MMFN variants and the AIM baseline (``TRAIN_RUNS``, one
  ``python -m mmfn_tpu_torch.train.phase2`` process each) with bfloat16
  activations. Each run writes ``<root>/log/<logdir>`` and a ``DONE`` marker
  there, and a marked run is skipped.

Every leg and run resumes (route checkpoints, ``recent.log``), so an
interrupted recipe continues where it stopped. The score step is the
benchmark runner over the trained checkpoints, whose logdir names are the
ones ``harness/benchmark_run.py`` reads.

Usage:
    python -m mmfn_tpu_torch.tools.scale_r05 collect [--root R]
    python -m mmfn_tpu_torch.tools.scale_r05 train [--root R]
    python -m mmfn_tpu_torch.harness.benchmark_run --model-root R/log \\
        --out results/benchmark_torch_r05 --agents expert,vec,rad,img,aim --jobs 3

The root is ``--root``, else ``$ROOT``, else ``/tmp/mmfn_r05``. From Python,
``collect(root, weathers)`` and ``train(root, weathers)`` take a subset of
``WEATHERS``; ``legs``, ``runs`` and ``extra`` (overrides appended to every
command, such as ``max_ticks=100`` or ``epochs=2``) cut the recipe further.
Both return what each stage took: a leg's seconds and frames, phase 1's
seconds and pool sizes, a training run's seconds.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
COLLECT_YAML = "run_steps/config/collect.yaml"
TRAIN_YAML = "run_steps/config/train.yaml"
DEFAULT_ROOT = "/tmp/mmfn_r05"

WEATHERS = ("ClearNoon", "WetNoon", "MidRainNoon", "HardRainNoon")
SCENARIOS = "scenarios=data/scenarios/fake_towns_scenarios.json"

# (leg, phase0 overrides) in the order the recipe runs them each weather;
# {W} is the weather, {DATA} the raw-data folder and {ROOT} the root
COLLECT_LEGS = (
    # the cross town: 3 training routes (straight_sn held out) x 10 offset
    # repetitions
    ("cross", ("routes=data/routes/cross_train_3.xml", "map=data/maps/fake_town_cross.xodr",
               "repetitions=10", "collect_offsets=true", "weather={W}", SCENARIOS,
               "background_traffic=10", "agent.data_save={DATA}/Cross{W}_short",
               "checkpoint={ROOT}/collect_cross_{W}.json", "resume=true")),
    # the loop circuit x 4 offset repetitions
    ("loop", ("routes=data/routes/fake_loop.xml", "map=data/maps/fake_town_loop.xodr",
              "repetitions=4", "collect_offsets=true", "weather={W}", SCENARIOS,
              "background_traffic=10", "agent.data_save={DATA}/Loop{W}_short",
              "checkpoint={ROOT}/collect_loop_{W}.json", "resume=true")),
    # the held-out validation route: one on-lane pass a weather
    ("val", ("routes=data/routes/cross_straight_sn.xml", "map=data/maps/fake_town_cross.xodr",
             "weather={W}", SCENARIOS, "background_traffic=10",
             "agent.data_save={DATA}/Val{W}_short/route_00",
             "checkpoint={ROOT}/collect_val_{W}.json", "resume=true")),
)

# (train_agent.entry_point, logdir under <root>/log, phase2 overrides)
TRAIN_RUNS = (
    # the reference's own schedule
    ("mmfn_vec", "mmfn_vec", ("batch_size=24", "epochs=101")),
    # batch 96, with the ResNets' per-block recomputation beside the
    # device data cache
    ("mmfn_rad", "mmfn_rad", ("batch_size=96", "epochs=60", "remat=true")),
    # img reads the birdview raster, so its cache needs the larger budget
    ("mmfn_img", "mmfn_img", ("batch_size=24", "epochs=40", "device_cache_budget_gb=12")),
    # the AIM baseline of the benchmark table
    ("aim", "aim", ("batch_size=24", "epochs=40")),
)
COMPUTE_DTYPE = "compute_dtype=bfloat16"


def data_folder(root: str) -> str:
    return os.path.join(root, "data", "mmfn")


def _legs(weathers, legs):
    """(weather, leg, overrides) in the recipe's order: each weather in
    turn, its legs in ``COLLECT_LEGS`` order (``legs`` keeps the named
    ones)."""
    return [(w, name, overrides) for w in weathers
            for name, overrides in COLLECT_LEGS if legs is None or name in legs]


def collect_commands(root: str, weathers=WEATHERS, legs=None, extra=()):
    """The phase0 command line of every collection leg, in the recipe's
    order."""
    subs = {"ROOT": root, "DATA": data_folder(root)}
    return [[sys.executable, "-m", "mmfn_tpu_torch.harness.phase0", "--config", COLLECT_YAML,
             *(o.format(W=w, **subs) for o in overrides), *extra]
            for w, _, overrides in _legs(weathers, legs)]


def town_lists(weathers=WEATHERS):
    """phase1's and phase2's ``train_towns`` and ``val_towns`` overrides:
    every cross-town weather, then every loop weather; the held-out route's."""
    train = [f"{town}{w}" for town in ("Cross", "Loop") for w in weathers]
    val = [f"Val{w}" for w in weathers]
    return f"train_towns=[{','.join(train)}]", f"val_towns=[{','.join(val)}]"


def phase1_command(root: str, weathers=WEATHERS, extra=()):
    return [sys.executable, "-m", "mmfn_tpu_torch.data.phase1", "--config", TRAIN_YAML,
            f"data_folder={data_folder(root)}", *town_lists(weathers), *extra]


def train_command(root: str, run, weathers=WEATHERS, extra=()):
    entry, logdir, overrides = run
    return [sys.executable, "-u", "-m", "mmfn_tpu_torch.train.phase2", "--config", TRAIN_YAML,
            f"data_folder={data_folder(root)}", *town_lists(weathers),
            f"train_agent.entry_point={entry}", f"logdir={os.path.join(root, 'log', logdir)}",
            COMPUTE_DTYPE, *overrides, *extra]


def _run(cmd) -> float:
    """One stage in its own process, from the repo's root (the recipe's
    paths are relative to it); a failing stage ends the recipe. Returns its
    seconds."""
    print("+ " + " ".join(cmd[1:]), flush=True)
    t0 = time.perf_counter()
    subprocess.run(cmd, cwd=REPO, check=True)
    return time.perf_counter() - t0


def frame_count(folder: str) -> int:
    """The frames collected under ``folder``: one measurements JSON each."""
    return sum(1 for d, _, files in os.walk(folder)
               if os.path.basename(d) == "measurements"
               for f in files if f.endswith(".json"))


def pool_sizes(root: str) -> dict:
    """The samples phase 1 wrote, by split: one pickle each."""
    out = os.path.dirname(data_folder(root))
    return {split: sum(f.endswith(".pkl") for f in os.listdir(
        os.path.join(out, f"pro_{split}_fmmfn"))) for split in ("train", "eval")}


def best_checkpoints(root: str):
    """The ``best_model.pth`` of every run under ``<root>/log``."""
    return sorted(os.path.join(d, f) for d, _, files in os.walk(os.path.join(root, "log"))
                  for f in files if f == "best_model.pth")


def collect(root: str, weathers=WEATHERS, legs=None, extra=()):
    """Run every collection leg in turn; returns each leg's weather, name,
    seconds and frames."""
    os.makedirs(data_folder(root), exist_ok=True)
    done = []
    for (w, name, _), cmd in zip(_legs(weathers, legs),
                                 collect_commands(root, weathers, legs, extra)):
        seconds = _run(cmd)
        save = next(a for a in cmd if a.startswith("agent.data_save="))
        frames = frame_count(save.split("=", 1)[1])
        print(f"== {name} {w}: {frames} frames ({seconds:.1f}s)", flush=True)
        done.append({"weather": w, "leg": name, "seconds": seconds, "frames": frames})
    print(f"frames collected: {frame_count(data_folder(root))}")
    return done


def train(root: str, weathers=WEATHERS, runs=None, extra=()):
    """Phase 1 unless its pools exist, then each of ``TRAIN_RUNS`` (``runs``
    keeps the named logdirs) that has no ``DONE`` marker; prints the best
    checkpoints under ``<root>/log`` and returns each stage that ran with
    its seconds (phase 1's with its pool sizes)."""
    done = []
    if not os.path.isdir(os.path.join(os.path.dirname(data_folder(root)), "pro_train_fmmfn")):
        seconds = _run(phase1_command(root, weathers))
        done.append({"stage": "phase1", "seconds": seconds, **pool_sizes(root)})
    for run in TRAIN_RUNS:
        logdir = os.path.join(root, "log", run[1])
        if runs is not None and run[1] not in runs:
            continue
        if os.path.exists(os.path.join(logdir, "DONE")):
            print(f"== {run[1]} already trained, skipping")
            continue
        done.append({"stage": run[1], "seconds": _run(train_command(root, run, weathers, extra))})
        open(os.path.join(logdir, "DONE"), "w").close()
    print("trained checkpoints:")
    for path in best_checkpoints(root):
        print(path)
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stage", choices=("collect", "train"))
    ap.add_argument("--root", default=os.environ.get("ROOT", DEFAULT_ROOT))
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    if args.stage == "collect":
        collect(root)
    else:
        train(root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
