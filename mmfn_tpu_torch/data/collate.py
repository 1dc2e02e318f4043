"""Static-shape collation, a threaded prefetching loader, and the host to
device step.

Every batch pads its lanes to the constant ``max_lanes`` and carries
per-sample lane counts (``lane_num = max(k, 1)``), so every batch has one
shape. ``radar_adj`` is derived at collate time as the reference's
PRE_Data.__getitem__ does (dataloader.py:376-385). Batches come out as
numpy; :func:`to_batch` makes the torch :class:`Batch` on a device.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from mmfn_tpu_torch.data.batch import Batch
from mmfn_tpu_torch.ops.radar import radar_adjacency_np


def collate_samples(samples: Sequence[Dict[str, np.ndarray]], max_lanes: int) -> Batch:
    """Phase-1 sample dicts -> one :class:`Batch` of numpy arrays."""
    n = len(samples)
    first = samples[0]
    lane_nodes, feat = first["lanes"].shape[1:]

    lanes = np.zeros((n, max_lanes, lane_nodes, feat), dtype=np.float32)
    lane_num = np.zeros((n,), dtype=np.int32)
    for i, s in enumerate(samples):
        k = min(s["lanes"].shape[0], max_lanes)
        lanes[i, :k] = s["lanes"][:k]
        lane_num[i] = max(k, 1)

    # astype(copy=False): the rasters are ~50 MB a batch, and np.stack of
    # f32 samples has already made the one copy
    def stack_f32(key):
        return np.stack([s[key] for s in samples]).astype(np.float32, copy=False)

    radar = stack_f32("radar")
    return Batch(
        image=stack_f32("image"),
        lidar_bev=stack_f32("lidar_bev"),
        map_img=stack_f32("map_img"),
        lanes=lanes,
        lane_num=lane_num,
        radar=radar,
        radar_adj=np.stack([radar_adjacency_np(r) for r in radar]),
        target_point=stack_f32("target_point"),
        velocity=np.asarray([s["velocity"] for s in samples], dtype=np.float32),
        waypoints=stack_f32("waypoints"),
        # action/command labels for the CILRS-style baselines (the reference
        # reads them from the same measurement dicts, cilrs/train.py:81-96)
        command=(np.asarray([s["command"] for s in samples], dtype=np.int32)
                 if "command" in first else None),
        action=(np.stack([[s["steer"], s["throttle"], s["brake"]]
                          for s in samples]).astype(np.float32)
                if "steer" in first else None),
    )


def to_batch(np_batch: Batch, device) -> Batch:
    """A numpy :class:`Batch` -> the same fields as tensors on ``device``
    (None kept)."""
    return Batch(*[None if v is None else torch.from_numpy(np.asarray(v)).to(device)
                   for v in np_batch])


def data_loader(dataset, batch_size: int, max_lanes: int, *,
                shuffle: bool = False, seed: int = 0, drop_last: bool = True,
                num_threads: Optional[int] = None, prefetch: int = 4,
                shard_index: int = 0, shard_count: int = 1) -> Iterator[Batch]:
    """Threaded iterator of numpy batches.

    ``num_threads=None`` adapts to the host: decode threads help only when
    cores are free to run them, so the default is ``min(4, cpu_count - 1)``
    and the single-thread path when that is zero or one. Batch order is the
    same for every thread count.

    ``shard_index``/``shard_count`` give each process its own slice of the
    (shuffled) index space, as DistributedSampler does.
    """
    if num_threads is None:
        num_threads = min(4, (os.cpu_count() or 1) - 1)
    indices = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(indices)
    indices = indices[shard_index::shard_count]

    n_batches = (len(indices) // batch_size if drop_last
                 else -(-len(indices) // batch_size))
    batches: List[np.ndarray] = [
        indices[i * batch_size:(i + 1) * batch_size] for i in range(n_batches)]

    if num_threads <= 1:
        for idx in batches:
            yield collate_samples([dataset[int(i)] for i in idx], max_lanes)
        return

    # worker w collates batches w, w+N, w+2N, ... into its own bounded queue;
    # the consumer round-robins the queues, preserving batch order. Workers
    # re-check `stop` while blocked on a full queue, so an abandoned iterator
    # cannot strand threads (or their decoded batches).
    num_threads = min(num_threads, len(batches)) or 1
    queues = [queue_mod.Queue(maxsize=max(1, prefetch // num_threads))
              for _ in range(num_threads)]
    stop = threading.Event()

    def put_checked(q, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker(w):
        q = queues[w]
        try:
            for idx in batches[w::num_threads]:
                if stop.is_set():
                    return
                if not put_checked(
                        q, collate_samples([dataset[int(i)] for i in idx], max_lanes)):
                    return
        except Exception as e:  # surface loader errors to the consumer
            put_checked(q, e)
        finally:
            put_checked(q, None)

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(num_threads)]
    for t in threads:
        t.start()
    try:
        done = 0
        w = 0
        while done < num_threads:
            item = queues[w].get()
            if item is None:
                done += 1
                queues[w] = None
            elif isinstance(item, Exception):
                raise item
            else:
                yield item
            # advance to the next live queue (exhausted workers drop out when
            # batch counts are uneven across workers)
            w = (w + 1) % num_threads
            while queues[w] is None and done < num_threads:
                w = (w + 1) % num_threads
    finally:
        stop.set()
