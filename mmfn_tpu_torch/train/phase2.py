"""phase2: train an MMFN variant or a baseline on phase-1 pickles with mmfn_tpu_torch.

The port of ``run_steps/phase2_train_net.py``: the same config file and keys,
the same ``pro_train_f<name>`` / ``pro_eval_f<name>`` pools beside
``data_folder``, AdamW lr 1e-4, the mean-L1 waypoint loss (CILRS: its
control loss on the ``command`` and ``action`` labels), validation every
``val_every`` epochs, best-model checkpoints and a ``recent.log`` that a
rerun resumes from. ``seed`` seeds the initial weights, the data order
(``epoch + seed * 10007``) and the dropout masks. ``device_data_cache``
(auto | true | false) keeps the dataset in GPU memory (``data/device_cache.py``);
only the img variant stages the map raster.

One key the JAX CLI lacks: ``device`` (default: the CUDA device; the run
raises when there is none, and ``device=cpu`` trains on the CPU).
``pretrained_resnet34`` / ``pretrained_resnet18`` point at raw torchvision
``.pth`` files grafted into the ResNets before training or resuming
(``utils/weights.py:load_imagenet_backbones``; CILRS takes the ResNet18).
``multi_host`` and ``model_parallel`` > 1 are not ported yet and raise.

Usage:
    python -m mmfn_tpu_torch.train.phase2 --config run_steps/config/train.yaml \\
        [train_agent.entry_point=mmfn_rad|aim|cilrs|transfuser batch_size=24 \\
         epochs=101 device=cpu ...]
"""

from __future__ import annotations

import argparse
import os
import sys

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.data.collate import data_loader, to_batch
from mmfn_tpu_torch.data.dataset import PreprocessedDataset
from mmfn_tpu_torch.data.device_cache import maybe_device_cache
from mmfn_tpu_torch.device import resolve_device
from mmfn_tpu_torch.models.registry import get_entry_point
from mmfn_tpu_torch.train.engine import Engine
from mmfn_tpu_torch.utils.cli import load_config
from mmfn_tpu_torch.utils.logging import MetricsLogger, bcolors as bc
from mmfn_tpu_torch.utils.seeding import seed_everything
from mmfn_tpu_torch.utils.weights import load_imagenet_backbones

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "run_steps", "config", "train.yaml")


def _refuse_unported(cfg) -> None:
    if cfg.get("multi_host"):
        raise NotImplementedError("multi_host: multi-process training is not ported to "
                                  "mmfn_tpu_torch yet (ROADMAP queue 1 item 4, multi-process)")
    if int(cfg.get("model_parallel", 1)) > 1:
        raise NotImplementedError("model_parallel > 1: tensor parallelism is not ported "
                                  "to mmfn_tpu_torch yet (ROADMAP queue 1 item 4, multi-process)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    _refuse_unported(cfg)
    device = resolve_device(cfg.get("device"))

    model_overrides = dict(cfg.get("model", {}))
    gconf = GlobalConfig(
        lr=cfg.get("lr", 1e-4), max_lanes=cfg.get("max_lanes", 64),
        compute_dtype=cfg.get("compute_dtype",
                              model_overrides.pop("compute_dtype", "float32")),
        remat=cfg.get("remat", model_overrides.pop("remat", False)),
        checkpoint_backend=cfg.get("checkpoint_backend",
                                   model_overrides.pop("checkpoint_backend", "msgpack")),
        **model_overrides)
    root = cfg["data_folder"]
    name = os.path.basename(os.path.normpath(root))
    train_set = PreprocessedDataset(os.path.join(os.path.dirname(root), f"pro_train_f{name}"))
    val_set = PreprocessedDataset(os.path.join(os.path.dirname(root), f"pro_eval_f{name}"))
    print(f"{bc.OKGREEN}train frames: {len(train_set)}, val frames: {len(val_set)}{bc.ENDC}")

    seed = int(cfg.get("seed", 42))
    generator = seed_everything(seed)
    entry = cfg.get("train_agent", {}).get("entry_point", "mmfn_vec")
    model = get_entry_point(entry)(gconf, generator, device=device)
    print(f"{bc.OKCYAN}model: {entry} (variant {model.variant}) on {device}{bc.ENDC}")
    if cfg.get("pretrained_resnet34") or cfg.get("pretrained_resnet18"):
        # the reference's models.resnet*(pretrained=True) warm start
        model.load_state_dict(load_imagenet_backbones(
            model.state_dict(), resnet34_path=cfg.get("pretrained_resnet34"),
            resnet18_path=cfg.get("pretrained_resnet18")))
        print(f"{bc.OKGREEN}grafted ImageNet backbone weights{bc.ENDC}")

    logdir = cfg["logdir"]
    logger = MetricsLogger(logdir, mode=cfg.get("wandb_mode", "auto"), config=dict(cfg))
    try:
        engine = Engine(model, gconf, logdir, log_fn=logger.log)
        # one process on one device: the batch needs no rounding to a device count
        batch_size = int(cfg.get("batch_size", 24))
        if len(train_set) < batch_size:
            raise SystemExit(f"training pool has {len(train_set)} frames < batch_size "
                             f"{batch_size}; collect more data or lower batch_size")
        state = engine.initial_state()
        if engine.resume(state) is not None:
            print(f"{bc.OKGREEN}resumed from epoch {engine.cur_epoch}{bc.ENDC}")

        cached = maybe_device_cache(
            train_set, val_set, gconf, cfg.get("device_data_cache", "auto"), world_size=1,
            need_map=model.variant == "img",
            budget_bytes=int(float(cfg.get("device_cache_budget_gb", 8)) * 2**30),
            device=device)
        if cached is not None:
            print(f"{bc.OKCYAN}device data cache: "
                  f"{sum(c.nbytes for c in cached) / 2 ** 30:.2f} GiB resident on "
                  f"{device}{bc.ENDC}")
        train_cache, val_cache = cached or (None, None)

        def batches(split_set, cache, shuffle):
            def make(epoch):
                order_seed = epoch + seed * 10007
                if cache is not None:
                    return cache.batches(batch_size, shuffle=shuffle, seed=order_seed)
                return (to_batch(b, device) for b in data_loader(
                    split_set, batch_size, gconf.max_lanes, shuffle=shuffle, seed=order_seed))
            return make

        state = engine.fit(state, batches(train_set, train_cache, True),
                           batches(val_set, val_cache, False),
                           epochs=int(cfg.get("epochs", 101)), seed=seed,
                           val_every=int(cfg.get("val_every", 5)),
                           save_every=int(cfg.get("save_every", 20)))
        engine.save(state)
    finally:
        logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
