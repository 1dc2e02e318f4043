"""phase1: decode raw collected routes once and pickle model-ready samples, with mmfn_tpu_torch.

The port of ``run_steps/phase1_preprocess_data.py``: the same config file
(``run_steps/config/train.yaml``) and ``key=value`` overrides. For each
split it indexes the raw per-town ``<data_folder>/<Town>_short`` trees
(``train_towns``, ``val_towns``) with ``CarlaDataset``, checks every sample
(``check_data``), and writes ``pro_train_f<name>/<i>.pkl`` and
``pro_eval_f<name>/<i>.pkl`` beside ``data_folder`` (``<name>`` is its last
path component): the pools that the port's phase2
(``python -m mmfn_tpu_torch.train.phase2``) and the JAX package's read.
``workers`` > 1 decodes on a spawned process pool; ``image_ext`` (png | npy)
names the frames' format. Everything runs on the host, with numpy.

Usage:
    python -m mmfn_tpu_torch.data.phase1 --config run_steps/config/train.yaml \\
        [data_folder=<root>/mmfn train_towns=[...] val_towns=[...] workers=4 ...]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.data.dataset import CarlaDataset, check_data, preprocess_to_pickles
from mmfn_tpu_torch.utils.cli import load_config
from mmfn_tpu_torch.utils.logging import bcolors as bc

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "run_steps", "config", "train.yaml")


def town_dirs(root: str, towns, suffix: str = "_short"):
    return [os.path.join(root, t + suffix) for t in towns]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, args.overrides)

    gconf = GlobalConfig(max_lanes=cfg.get("max_lanes", 64))
    root = cfg["data_folder"]
    name = os.path.basename(os.path.normpath(root))

    for split, towns in (("train", cfg["train_towns"]), ("eval", cfg["val_towns"])):
        dirs = [d for d in town_dirs(root, towns) if os.path.isdir(d)]
        if not dirs:
            print(f"{bc.WARNING}no data dirs for {split} ({towns}){bc.ENDC}")
            continue
        ds = CarlaDataset(dirs, gconf, image_ext=cfg.get("image_ext", "png"))
        bad = check_data(ds)
        if bad:
            print(f"{bc.FAIL}{len(bad)} corrupt samples in {split}: {bad[:10]}...{bc.ENDC}")
        out = os.path.join(os.path.dirname(root), f"pro_{split}_f{name}")
        t0 = time.perf_counter()
        n = preprocess_to_pickles(ds, out, workers=int(cfg.get("workers", 0)))
        print(f"{bc.OKGREEN}{split}: wrote {n} samples to {out} "
              f"({time.perf_counter() - t0:.3f}s){bc.ENDC}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
