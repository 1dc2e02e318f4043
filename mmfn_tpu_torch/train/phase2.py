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

Two keys the JAX CLI lacks: ``device`` (default: the CUDA device; the run
raises when there is none, and ``device=cpu`` trains on the CPU), and
``log_every`` (N > 0: every N-th step's loss goes to ``metrics.jsonl`` as
``loss_iter``).
``pretrained_resnet34`` / ``pretrained_resnet18`` point at raw torchvision
``.pth`` files grafted into the ResNets before training or resuming
(``utils/weights.py:load_imagenet_backbones``; CILRS takes the ResNet18).

Multi-process. With ``multi_host=true``, or whenever ``torchrun``'s
environment is present, every process joins the process group
(``parallel/mesh.py:init_distributed``: NCCL on ``cuda:LOCAL_RANK``, gloo
under ``device=cpu``) and the run is data-parallel: DDP over the mesh's
``data`` axis, global-batch BatchNorm statistics, and each data rank loading
its own shard of the index space (``data_loader(shard_index=, shard_count=)``).
``batch_size`` is per process, as in the JAX CLI, whose loader yields
``batch_size`` rows a process and whose ``_place`` assembles the global
batch from the processes' rows: a step's global batch is ``batch_size`` x
the data size, and ``batch_size`` is rounded up to a multiple of the data
size as the JAX CLI rounds it. ``model_parallel=M`` (1, 2 or 4 for the
4-head fusion transformer) lays the world out as ``("data", "model") =
(world / M, M)`` and tensor-shards the fusion transformers over ``model``;
the ranks of one model group load the same rows, and every data rank
takes len(pool) // (data size x ``batch_size``) batches an epoch.
``checkpoint_backend=orbax`` writes DCP directories (``train/engine.py``).
The device cache needs a world of one process: ``auto`` gives none above
that, ``true`` raises. The process group is destroyed at the end.

Usage:
    python -m mmfn_tpu_torch.train.phase2 --config run_steps/config/train.yaml \\
        [train_agent.entry_point=mmfn_rad|aim|cilrs|transfuser batch_size=24 \\
         epochs=101 device=cpu ...]
    torchrun --nproc_per_node=2 -m mmfn_tpu_torch.train.phase2 \\
        --config run_steps/config/train.yaml [model_parallel=2 checkpoint_backend=orbax ...]
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

import torch
import torch.distributed as dist

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.data.collate import data_loader, to_batch
from mmfn_tpu_torch.data.dataset import PreprocessedDataset
from mmfn_tpu_torch.data.device_cache import maybe_device_cache
from mmfn_tpu_torch.device import resolve_device
from mmfn_tpu_torch.models.registry import get_entry_point
from mmfn_tpu_torch.parallel import mesh as pmesh
from mmfn_tpu_torch.train.engine import Engine
from mmfn_tpu_torch.utils.cli import load_config
from mmfn_tpu_torch.utils.compile_cache import enable_persistent_cache
from mmfn_tpu_torch.utils.logging import MetricsLogger, bcolors as bc
from mmfn_tpu_torch.utils.seeding import seed_everything
from mmfn_tpu_torch.utils.weights import load_imagenet_backbones

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "run_steps", "config", "train.yaml")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    # the kernels build before the first step is timed (no-op without CUDA)
    enable_persistent_cache()
    distributed = bool(cfg.get("multi_host")) or pmesh.torchrun_environment()
    try:
        return _run(cfg, distributed)
    finally:
        if distributed:
            pmesh.destroy_distributed()


def _layout(cfg, distributed):
    """(device, mesh or None, model_parallel) of this process."""
    tp = int(cfg.get("model_parallel", 1))
    if not distributed:
        if tp > 1:
            raise SystemExit(f"model_parallel={tp} does not divide 1 process; launch "
                             f"{tp} or more with torchrun (or set multi_host=true)")
        return resolve_device(cfg.get("device")), None, 1
    device = pmesh.init_distributed(cfg)
    world = dist.get_world_size()
    if world % max(tp, 1):
        raise SystemExit(f"model_parallel={tp} does not divide {world} processes")
    mesh = pmesh.make_mesh(world, ("data", "model"), (world // tp, tp))
    return device, mesh, tp


def _run(cfg, distributed: bool) -> int:
    device, mesh, tp = _layout(cfg, distributed)
    rank = dist.get_rank() if mesh is not None else 0
    n_data, data_rank = pmesh.axis_size(mesh, "data"), pmesh.axis_rank(mesh, "data")
    say = print if rank == 0 else (lambda *a, **k: None)

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
    say(f"{bc.OKGREEN}train frames: {len(train_set)}, val frames: {len(val_set)}{bc.ENDC}")

    seed = int(cfg.get("seed", 42))
    generator = seed_everything(seed)
    entry = cfg.get("train_agent", {}).get("entry_point", "mmfn_vec")
    model = get_entry_point(entry)(gconf, generator, device=device)
    say(f"{bc.OKCYAN}model: {entry} (variant {model.variant}) on {device}{bc.ENDC}")
    if cfg.get("pretrained_resnet34") or cfg.get("pretrained_resnet18"):
        # the reference's models.resnet*(pretrained=True) warm start
        model.load_state_dict(load_imagenet_backbones(
            model.state_dict(), resnet34_path=cfg.get("pretrained_resnet34"),
            resnet18_path=cfg.get("pretrained_resnet18")))
        say(f"{bc.OKGREEN}grafted ImageNet backbone weights{bc.ENDC}")
    if mesh is not None:
        pmesh.replicate(model, mesh)
        if tp > 1:
            pmesh.tensor_parallel_sharding(model, mesh)
        say(f"{bc.OKCYAN}mesh: data={n_data} x model={tp} over "
            f"{dist.get_backend()}{bc.ENDC}")

    logdir = cfg["logdir"]
    logger = (MetricsLogger(logdir, mode=cfg.get("wandb_mode", "auto"), config=dict(cfg))
              if rank == 0 else None)
    engine = None
    try:
        engine = Engine(model, gconf, logdir, log_fn=logger and logger.log, mesh=mesh)
        batch_size = int(cfg.get("batch_size", 24))
        if batch_size % n_data:
            batch_size = (batch_size // n_data + 1) * n_data
            say(f"{bc.WARNING}batch_size rounded to {batch_size} for {n_data} data "
                f"ranks{bc.ENDC}")
        if len(train_set) // n_data < batch_size:
            raise SystemExit(f"training pool has {len(train_set)} frames, "
                             f"{len(train_set) // n_data} a data rank < batch_size "
                             f"{batch_size}; collect more data or lower batch_size")
        state = engine.initial_state()
        if engine.resume(state) is not None:
            say(f"{bc.OKGREEN}resumed from epoch {engine.cur_epoch}{bc.ENDC}")

        cached = maybe_device_cache(
            train_set, val_set, gconf, cfg.get("device_data_cache", "auto"),
            world_size=dist.get_world_size() if mesh is not None else 1,
            need_map=model.variant == "img",
            budget_bytes=int(float(cfg.get("device_cache_budget_gb", 8)) * 2**30),
            device=device)
        if cached is not None:
            say(f"{bc.OKCYAN}device data cache: "
                  f"{sum(c.nbytes for c in cached) / 2 ** 30:.2f} GiB resident on "
                  f"{device}{bc.ENDC}")
        train_cache, val_cache = cached or (None, None)

        def batches(split_set, cache, shuffle):
            # every data rank takes the same number of batches, as
            # DistributedSampler's drop_last gives them: a rank with one more
            # would enter a DDP all-reduce that the others never join
            n_batches = len(split_set) // (n_data * batch_size)

            def make(epoch):
                order_seed = epoch + seed * 10007
                if cache is not None:
                    return cache.batches(batch_size, shuffle=shuffle, seed=order_seed)
                return (to_batch(b, device) for b in itertools.islice(data_loader(
                    split_set, batch_size, gconf.max_lanes, shuffle=shuffle, seed=order_seed,
                    shard_index=data_rank, shard_count=n_data), n_batches))
            return make

        state = engine.fit(state, batches(train_set, train_cache, True),
                           batches(val_set, val_cache, False),
                           epochs=int(cfg.get("epochs", 101)), seed=seed,
                           val_every=int(cfg.get("val_every", 5)),
                           save_every=int(cfg.get("save_every", 20)),
                           log_every=int(cfg.get("log_every", 0)))
        engine.save(state)
        if device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            say(f"peak card memory: {peak:.3f} GiB allocated")
            if logger is not None:
                logger.log({"peak_memory_gib": peak})
    finally:
        if engine is not None:
            engine.finalize()
        if logger is not None:
            logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
