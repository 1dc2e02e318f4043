"""Raw collected routes and phase-1 sample pools (the reference's CARLA_Data /
PRE_Data, team_code/mmfn_utils/datasets/dataloader.py:11-385).

On-disk layout (written by the data-collection experts, base_agent.py:58-74;
the port's ``data/writer.py:DatasetWriter``):
    <town_dir>/<route_dir>/
        rgb_front/0001.png      camera frames (900x256 -> center-cropped 256)
        lidar/0001.npy          raw point clouds (N, 4)
        radar/0001.npy          radar returns (N, 5)
        maps/0001.png           rasterized HD-map birdview (256x256)
        vectormap/0001.npy      RoughMap.process output (n_lanes, 10, 5)
        measurements/0001.json  x, y, theta, speed, commands, controls

``CarlaDataset`` decodes raw frames into model-ready numpy samples (the heavy
path, run once by phase 1, ``data/phase1.py``); ``preprocess_to_pickles``
writes each sample to a pickle, serially or on a spawned process pool, and
``PreprocessedDataset`` reads the pickles back for ``collate.collate_samples``.

The port's own copy of the JAX package's ``data/dataset.py``. It reads PNG
frames through ``data/png.py``, not PIL, and makes the LiDAR BEV with the
JAX package's float64 re-registration and ``np.histogramdd``
(``data/host_ops.py``), so its samples and pickles equal the JAX
package's bit for bit, and either package reads the other's raw trees. The
decode is numpy on the host, and the module imports nothing of torch: the
pool's workers start without it and run no device code.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Sequence

import numpy as np

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.data import png
from mmfn_tpu_torch.data.host_ops import (lidar_to_histogram_features_np, radar_to_size_np,
                                          scale_and_crop_image, transform_2d_points_np)


def _load_image(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".png"):
        return png.read(path)
    raise ValueError(f"{path}: frames are read as png or npy")


def _frame_name(idx: int, ext: str) -> str:
    return f"{str(idx).zfill(4)}.{ext}"


def _read_cache(path: str):
    """A preload cache's contents, or None when it is absent or does not
    parse (another process may be writing it, or was killed doing so)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _write_cache(path: str, obj) -> None:
    """Write a preload cache so that no reader sees it half written: dump to
    a name of this process's own beside it, then rename it into place. A
    read-only root (``OSError``) leaves the pool uncached."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)
    except OSError:
        pass
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class CarlaDataset:
    """Index + decode raw collected routes into training samples."""

    def __init__(self, roots: Sequence[str], config: GlobalConfig,
                 image_ext: str = "png", use_preload: bool = True):
        self.config = config
        self.seq_len = config.seq_len
        self.pred_len = config.pred_len
        self.image_ext = image_ext
        self.frames: List[Dict] = []  # one entry per sample: file paths + poses

        for root in roots:
            self.frames.extend(self._index_root(root, use_preload))

    def _preload_path(self, root: str) -> str:
        # the reference caches its index per sub-root as
        # 'rg_lidar_mmfn_diag_pl_<seq>_<pred>.npy' (dataloader.py:44); same
        # idea, json of path entries keyed by the same two lengths
        return os.path.join(
            root, f"preload_index_{self.seq_len}_{self.pred_len}.json")

    def _index_root(self, root: str, use_preload: bool) -> List[Dict]:
        preload = self._preload_path(root)
        cached = _read_cache(preload) if use_preload else None
        if cached is not None:
            return cached

        frames: List[Dict] = []
        routes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        for route in routes:
            rd = os.path.join(root, route)
            n_frames = len(os.listdir(os.path.join(rd, "rgb_front")))
            # last pred_len frames lack future waypoints; first frame unused
            num_seq = (n_frames - self.pred_len - 2) // self.seq_len
            for seq in range(num_seq):
                ids = [seq * self.seq_len + 1 + i
                       for i in range(self.seq_len + self.pred_len)]
                frames.append({
                    "dir": rd,
                    "ids": ids,
                    "measurements": [
                        os.path.join(rd, "measurements", _frame_name(i, "json"))
                        for i in ids],
                })
        if use_preload:
            _write_cache(preload, frames)
        return frames

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.config
        entry = self.frames[index]
        rd, ids = entry["dir"], entry["ids"]

        meas = []
        for path in entry["measurements"]:
            with open(path) as f:
                meas.append(json.load(f))
        xs = np.array([m["x"] for m in meas])
        ys = np.array([m["y"] for m in meas])
        thetas = np.array([0.0 if np.isnan(m["theta"]) else m["theta"] for m in meas])

        cur = self.seq_len - 1           # index of the "current" frame
        ego_x, ego_y, ego_theta = xs[cur], ys[cur], thetas[cur]
        cur_id = ids[cur]

        # ---- camera ----
        image = scale_and_crop_image(
            _load_image(os.path.join(rd, "rgb_front", _frame_name(cur_id, self.image_ext))),
            scale=cfg.scale, crop=cfg.input_resolution)

        # ---- map raster ----
        map_path = os.path.join(rd, "maps", _frame_name(cur_id, self.image_ext))
        map_img = (_load_image(map_path) if os.path.exists(map_path)
                   else np.zeros_like(image))

        # ---- vectormap (variable lane count; padded at collate) ----
        vec_path = os.path.join(rd, "vectormap", _frame_name(cur_id, "npy"))
        if os.path.exists(vec_path):
            lanes = np.load(vec_path).astype(np.float32)
            if lanes.ndim != 3 or lanes.shape[0] == 0:
                lanes = np.zeros((1, cfg.lane_node_num, cfg.feature_num), np.float32)
        else:
            lanes = np.zeros((1, cfg.lane_node_num, cfg.feature_num), np.float32)

        # ---- radar ----
        radar = radar_to_size_np(
            np.load(os.path.join(rd, "radar", _frame_name(cur_id, "npy"))),
            (cfg.radar_points, cfg.radar_features)).astype(np.float32)

        # ---- lidar: flip y, re-register into current ego frame, rasterize ----
        pts = np.load(os.path.join(rd, "lidar", _frame_name(cur_id, "npy")))[..., :3]
        pts[:, 1] *= -1
        pts = transform_2d_points_np(
            pts, np.pi / 2 - ego_theta, -ego_x, -ego_y,
            np.pi / 2 - ego_theta, -ego_x, -ego_y)
        lidar_bev = lidar_to_histogram_features_np(pts)

        # ---- future waypoints in ego frame ----
        waypoints = []
        for i in range(self.seq_len, self.seq_len + self.pred_len):
            local = transform_2d_points_np(
                np.zeros((1, 3)), np.pi / 2 - thetas[i], -xs[i], -ys[i],
                np.pi / 2 - ego_theta, -ego_x, -ego_y)
            waypoints.append(local[0, :2])

        # ---- target (command) point rotated into ego frame ----
        m = meas[cur]
        rot = np.array([
            [np.cos(np.pi / 2 + ego_theta), -np.sin(np.pi / 2 + ego_theta)],
            [np.sin(np.pi / 2 + ego_theta), np.cos(np.pi / 2 + ego_theta)]])
        local_cmd = rot.T @ np.array([m["x_command"] - ego_x, m["y_command"] - ego_y])

        return {
            "image": image.astype(np.float32),
            "lidar_bev": lidar_bev.astype(np.float32),
            "map_img": np.asarray(map_img)[..., :3].astype(np.float32),
            "lanes": lanes,
            "radar": radar,
            "target_point": local_cmd.astype(np.float32),
            "waypoints": np.asarray(waypoints, dtype=np.float32),
            "steer": np.float32(m["steer"]),
            "throttle": np.float32(m["throttle"]),
            "brake": np.float32(m["brake"]),
            "command": np.float32(m["command"]),
            "velocity": np.float32(m["speed"]),
        }


class PreprocessedDataset:
    """Reads phase-1 pickles (one sample per .pkl under root).

    The sorted file list is cached in ``<root>/preload_files.json`` (the
    reference PRE_Data preload): listing and sorting hundreds of thousands
    of pickles on network filesystems dominates startup otherwise. The
    pickles are trusted input, written by phase1 of this project."""

    def __init__(self, root: str, use_preload: bool = True):
        preload = os.path.join(root, "preload_files.json")
        names = _read_cache(preload) if use_preload else None
        if names is None:
            names = sorted(f for f in os.listdir(root) if f.endswith(".pkl"))
            if use_preload:
                _write_cache(preload, names)
        self.files = [os.path.join(root, f) for f in names]

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        with open(self.files[index], "rb") as f:
            return pickle.load(f)


def _pickle_sample(dataset, index: int, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(dataset[index], f)


_WORKER_DATASET = None


def _pool_init(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _pool_job(args) -> None:
    index, path = args
    _pickle_sample(_WORKER_DATASET, index, path)


def preprocess_to_pickles(dataset: CarlaDataset, out_dir: str, workers: int = 0) -> int:
    """phase1: decode every raw sample once and pickle it (the reference's
    preprocess_dataset_for, phase1_preprocess_data.py:31-48). ``workers`` > 1
    fans the CPU-heavy decode out over a spawned process pool (fork is unsafe
    in a process whose threads hold locks, as torch's do; the dataset ships
    once via the initializer). The workers decode with numpy and touch no
    device; the pickles equal ``workers=0``'s file for file."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(dataset)
    jobs = [(i, os.path.join(out_dir, f"{i}.pkl")) for i in range(n)]
    if workers and workers > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(
                workers, initializer=_pool_init, initargs=(dataset,)) as pool:
            pool.map(_pool_job, jobs, chunksize=8)
    else:
        for index, path in jobs:
            _pickle_sample(dataset, index, path)
    return n


def check_data(dataset) -> List[int]:
    """Touch-read every sample, returning the indices that fail to decode
    (the reference's check_data validity pass, phase1_preprocess_data.py:50-66)."""
    bad = []
    for i in range(len(dataset)):
        try:
            sample = dataset[i]
            _ = sample["velocity"]
        except Exception:
            bad.append(i)
    return bad
