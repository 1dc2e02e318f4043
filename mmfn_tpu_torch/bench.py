"""End-to-end benchmark of the port: sensor -> waypoints frames/s on one card.

The port of ``bench.py``. The benched pipeline is the per-frame compute of
the reference's simulator tick (mmfn_vectornet.py:199-309 +
dataloader.py:271-346): the SE(2) re-registration of the LiDAR clouds, the
BEV histogram (kernel 1, ``csrc/bev_hist.cu``, one launch for the whole
batch), the radar adjacency and the full MMFN-rad forward to 4 waypoints
(with ``MMFN_BENCH_ATTN=pallas`` the attention through kernel 2,
``csrc/attention.cu``; default the plain attention, as in the JAX bench).

Timing. Eager PyTorch has no ``fori_loop``: :func:`timed_loop` enqueues
``iters`` pipeline steps back to back (each step's velocity perturbed by the
step index, each output summed into a device accumulator), synchronises the
card once at the end, and takes the minimum of 3 repeats divided by
``iters``. So ``batch1_latency_ms`` is the device-bound time of one step in
a back-to-back stream, with the host's issue overlapped, not a request's
round trip (``bench_loop`` and ``chip_smoke.py`` time those).

Legs, each on by default, each raising when it fails (the bench then exits
non-zero): batch-1 latency and batch-8 frames/s; bf16 training (autocast
over f32 master weights, ``train/engine.py``) at batch 24 and at the peak
batch 96 (``MMFN_BENCH_TRAIN=0`` skips training); the from-disk pipeline
(``MMFN_BENCH_TRAIN=fast`` skips it): phase-1-format pickles written once
under ``$TMPDIR/mmfn_torch_bench_disk``, the loader alone and the loader
feeding the train step, the rasters crossing as uint8 and cast on the card;
the host fleet of ``MMFN_BENCH_FLEET`` (8) vehicles and the device-world
fleet of ``MMFN_BENCH_FLEET_DW`` (128) through ``bench_loop._fleet_mode``
(the map tool ``native/build/rough_map_node`` must be built); the
device-side ceiling, the pipeline at width 128 in :func:`timed_loop`.

``pallas_ok`` keeps the JAX bench's key with the port's meaning: both CUDA
kernels against their plain PyTorch versions on the card, at the shapes the
JAX bench checks its Pallas kernels at (kernel 1 on one 65,536-point f32
cloud with an invalid tail, exactly; kernel 2 at (2, 4, T, D) for (T, D) in
(128, 16), (192, 32), (256, 64), (256, 128), within rtol/atol 1e-5). It is
null on the CPU, where no kernel runs.

Prints ONE JSON line with the JAX bench's keys (``BENCH_r05.json``);
``device`` names the card. ``vs_baseline`` is frames/s over the reference's
20 Hz closed-loop budget.

Usage:
    python -m mmfn_tpu_torch.bench [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.data.batch import Batch
from mmfn_tpu_torch.device import resolve_device
from mmfn_tpu_torch.models import build_model
from mmfn_tpu_torch.ops.lidar import HIST_MAX_PER_PIXEL, lidar_to_histogram_features
from mmfn_tpu_torch.ops.radar import radar_adjacency
from mmfn_tpu_torch.utils.compile_cache import enable_persistent_cache

MAX_POINTS = 65536  # two 64-ch sweeps at 600k pts/s / 20 Hz, padded
BATCH = 8
ITERS = 200
TRAIN_BATCH = 24     # reference training batch (train.yaml:18)
PEAK_BATCH = 96      # the JAX bench's peak batch
TRAIN_ITERS = 20
PEAK_ITERS = 10
DISK_SAMPLES = 192
FLEET_TICKS = 120
DEVICE_WIDTH = 128   # the device-side ceiling's width
DEVICE_ITERS = 25
SEED = 0


def make_inputs(batch, rng, device):
    """The JAX bench's inputs, drawn in its order from ``rng``, on ``device``."""
    arrays = dict(
        image=rng.integers(0, 256, size=(batch, 256, 256, 3)).astype(np.float32),
        points=rng.uniform(-30, 30, size=(batch, MAX_POINTS, 4)).astype(np.float32),
        pose=rng.normal(size=(batch, 6)).astype(np.float32),  # r1,t1x,t1y,r2,t2x,t2y
        lanes=rng.normal(size=(batch, 64, 10, 5)).astype(np.float32) * 10,
        lane_num=rng.integers(1, 64, size=(batch,)).astype(np.int32),
        radar=rng.normal(size=(batch, 81, 5)).astype(np.float32),
        target_point=rng.normal(size=(batch, 2)).astype(np.float32) * 5,
        velocity=np.abs(rng.normal(size=(batch,))).astype(np.float32) * 5,
    )
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def transform_points(points: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """(B, N, >=3) clouds from each one's pose 1 to its pose 2 (B, 6) =
    [r1, t1x, t1y, r2, t2x, t2y]: ``ops/lidar.py:transform_2d_points`` over
    the batch."""
    r1, t1x, t1y, r2, t2x, t2y = (pose[:, i:i + 1] for i in range(6))
    c1, s1, c2, s2 = torch.cos(r1), torch.sin(r1), torch.cos(r2), torch.sin(r2)
    x, y = points[..., 0], points[..., 1]
    wx = c1 * x + s1 * y + t1x
    wy = -s1 * x + c1 * y + t1y
    dx, dy = wx - t2x, wy - t2y
    return torch.cat([torch.stack([c2 * dx - s2 * dy, s2 * dx + c2 * dy], dim=-1),
                      points[..., 2:]], dim=-1)


def pipeline_fn(model):
    """``pipeline(inp) -> (B, 4, 2)``: transform, kernel 1, adjacency, forward."""
    def pipeline(inp):
        pts4 = transform_points(inp["points"], inp["pose"])
        batch = Batch(image=inp["image"], lidar_bev=lidar_to_histogram_features(pts4),
                      lanes=inp["lanes"], lane_num=inp["lane_num"], radar=inp["radar"],
                      radar_adj=radar_adjacency(inp["radar"]),
                      target_point=inp["target_point"], velocity=inp["velocity"])
        return model(batch)

    return pipeline


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_loop(pipeline, inputs, iters):
    """Per-step seconds of ``iters`` pipeline steps enqueued back to back."""
    device = inputs["velocity"].device

    @torch.inference_mode()
    def looped(n):
        acc = torch.zeros((), device=device)
        for i in range(n):
            inp = dict(inputs)
            # the JAX bench's loop-index perturbation (numerically negligible)
            inp["velocity"] = inputs["velocity"] + i * 1e-9
            acc = acc + pipeline(inp).sum()
        return acc

    looped(min(iters, 3))     # warm: kernel builds, cuDNN's algorithm choice
    _sync(device)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        s = looped(iters)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(s)):
        raise RuntimeError("bench: the pipeline's output is not finite")
    return min(ts) / iters


def _train_state(cfg, device):
    from mmfn_tpu_torch.train.engine import create_train_state

    model = build_model(cfg, "rad", torch.Generator().manual_seed(SEED), device=device)
    return create_train_state(model, cfg)


def timed_train(cfg, batch_size, device, iters=TRAIN_ITERS, compute_dtype="bfloat16"):
    """Per-step seconds of the engine's train step on one synthetic batch
    (bf16: autocast over f32 master weights), ``iters`` steps back to back,
    the minimum of 3 repeats."""
    from mmfn_tpu_torch.data.synthetic import synthetic_batch
    from mmfn_tpu_torch.train.engine import make_train_step

    batch = synthetic_batch(batch_size=batch_size, max_lanes=cfg.max_lanes,
                            resolution=cfg.input_resolution, device=device)
    state = _train_state(cfg, device)
    step = make_train_step(compute_dtype)

    def looped(n):
        acc = torch.zeros((), device=device)
        for i in range(n):
            b = batch._replace(velocity=batch.velocity + i * 1e-9)
            acc = acc + step(state, b, SEED)
        return float(acc)

    looped(2)                 # warm
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss = looped(iters)
        ts.append(time.perf_counter() - t0)
    if not np.isfinite(loss):
        raise RuntimeError(f"bench: non-finite training loss at batch {batch_size}")
    return min(ts) / iters


def disk_train_bench(cfg, device, batch_size=TRAIN_BATCH, n_samples=DISK_SAMPLES,
                     compute_dtype="bfloat16"):
    """From-disk training: phase-1-format pickles written once (f32 rasters,
    about 2.1 MB a sample), then (a) the loader alone (unpickle + collate,
    ``data/collate.py:data_loader``), the better of one thread and the
    adaptive default, and (b) the loader feeding the train step, the batch
    crossing as f32 (``raw``) or with the camera, map and BEV rasters as
    uint8 (the BEV as its counts) cast back on the card, where ``k / 5``
    reproduces the stored counts / 5 exactly."""
    from mmfn_tpu_torch.data.collate import data_loader, to_batch
    from mmfn_tpu_torch.data.dataset import PreprocessedDataset
    from mmfn_tpu_torch.data.synthetic import synthetic_samples
    from mmfn_tpu_torch.train.engine import make_train_step

    root = os.path.join(tempfile.gettempdir(), "mmfn_torch_bench_disk")
    marker = os.path.join(root, f"ok_{n_samples}_{cfg.max_lanes}_{cfg.input_resolution}")
    if not os.path.exists(marker):
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        for i, s in enumerate(synthetic_samples(n_samples, cfg.max_lanes,
                                                resolution=cfg.input_resolution)):
            with open(os.path.join(root, f"{i:06d}.pkl"), "wb") as f:
                pickle.dump(s, f)
        open(marker, "w").close()
    ds = PreprocessedDataset(root, use_preload=False)

    def epoch(n_threads):
        t0 = time.perf_counter()
        seen = 0
        for b in data_loader(ds, batch_size, cfg.max_lanes, num_threads=n_threads):
            seen += b.image.shape[0]
        return seen / (time.perf_counter() - t0)

    epoch(1)                       # warm the page cache
    loader_fps = max(epoch(1), epoch(None))

    state = _train_state(cfg, device)
    step = make_train_step(compute_dtype)

    def raw(b):
        return to_batch(b, device)

    def u8(b):
        rasters = to_batch(b._replace(
            image=b.image.astype(np.uint8),
            lidar_bev=np.rint(b.lidar_bev * HIST_MAX_PER_PIXEL).astype(np.uint8),
            map_img=b.map_img.astype(np.uint8)), device)
        return rasters._replace(image=rasters.image.float(),
                                lidar_bev=rasters.lidar_bev.float() / HIST_MAX_PER_PIXEL,
                                map_img=rasters.map_img.float())

    def fed_epoch(transport):
        t0 = time.perf_counter()
        seen, acc = 0, torch.zeros((), device=device)
        for b in data_loader(ds, batch_size, cfg.max_lanes):
            acc = acc + step(state, transport(b), SEED)
            seen += b.image.shape[0]
        if not np.isfinite(float(acc)):          # drains the queue
            raise RuntimeError("bench: non-finite loss in the from-disk leg")
        return seen / (time.perf_counter() - t0)

    b0 = next(iter(data_loader(ds, batch_size, cfg.max_lanes)))
    for transport in (raw, u8):                  # warm both
        float(step(state, transport(b0), SEED))
    fed_raw = fed_epoch(raw)
    fed_u8 = fed_epoch(u8)
    return {"loader_fps": round(loader_fps, 1),
            "loader_fed_train_fps": round(fed_u8, 1),
            "loader_fed_train_fps_raw_f32": round(fed_raw, 1),
            "samples": n_samples}


def check_kernels(device, rng) -> bool:
    """Both CUDA kernels against their plain versions at the JAX bench's
    check shapes (see the module docstring)."""
    from mmfn_tpu_torch.ops import attention, lidar

    pts = rng.uniform(-30, 30, size=(MAX_POINTS, 4)).astype(np.float32)
    pts[:, 3] = 1.0
    pts[-1000:, 3] = 0.0   # ragged tail: padded-invalid rows must not count
    x = torch.from_numpy(pts).to(device)[None]
    ok = bool(torch.equal(lidar._bev_histogram_cuda(x, lidar.cluster_size(1)),
                          lidar.bev_histogram_plain(x)))
    for t, d in ((128, 16), (192, 32), (256, 64), (256, 128)):
        q, k, v = (torch.from_numpy(rng.normal(size=(2, 4, t, d)).astype(np.float32))
                   .to(device) for _ in range(3))
        with torch.inference_mode():
            got = attention.fused_attention(q, k, v)
            want = attention.attention_plain(q, k, v)
        ok = ok and bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))
    return ok


def bench_line(fps, latency_s, train_fps, train_fps_peak, fleet_n, fleet, fleet_dw, dw_n,
               fleet_dev, transport, disk, pallas_ok, attn_impl, device_name) -> dict:
    """The JAX bench's JSON line, key for key."""
    return {
        "metric": "end-to-end frames/sec/chip (sensor->waypoints, full MMFN-rad)",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / 20.0, 2),
        "batch": BATCH,
        "batch1_latency_ms": round(latency_s * 1e3, 2),
        "batch1_fps": round(1.0 / latency_s, 2),
        "train_fps": train_fps,
        "train_batch": TRAIN_BATCH,
        "train_fps_peak": train_fps_peak,
        "train_peak_batch": PEAK_BATCH,
        "train_dtype": "bfloat16",
        "fleet_vehicles": fleet_n if fleet else None,
        "fleet_agg_ticks_per_sec": fleet and fleet["agg_ticks_per_sec"],
        "fleet_vehicles_at_20hz": fleet and fleet["vehicles_at_20hz"],
        "fleet_vehicles_at_20hz_devworld": fleet_dw and fleet_dw["vehicles_at_20hz"],
        "fleet_devworld_width": fleet_dw and dw_n,
        "fleet_vehicles_at_20hz_device": fleet_dev,
        "transport": transport,
        "disk_loader_fps": disk and disk["loader_fps"],
        "disk_loader_fed_train_fps": disk and disk["loader_fed_train_fps"],
        "disk_loader_fed_train_fps_raw_f32": disk and disk["loader_fed_train_fps_raw_f32"],
        "pallas_ok": pallas_ok,
        "attn_impl": attn_impl,
        "device": device_name,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (no kernel); default: the CUDA device")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # the kernels build before anything is timed (no-op without CUDA)
    enable_persistent_cache()
    rng = np.random.default_rng(SEED)
    # MMFN_BENCH_ATTN=pallas A/Bs kernel 2 against the default plain attention
    cfg = GlobalConfig(attn_impl=os.environ.get("MMFN_BENCH_ATTN", "xla"))
    model = build_model(cfg, "rad", torch.Generator().manual_seed(SEED), device=device)
    pipeline = pipeline_fn(model)
    make_inputs(1, rng, device)          # the JAX bench's init draws
    latency_s = timed_loop(pipeline, make_inputs(1, rng, device), ITERS)
    batch_s = timed_loop(pipeline, make_inputs(BATCH, rng, device), ITERS)
    fps = BATCH / batch_s

    train_mode = os.environ.get("MMFN_BENCH_TRAIN", "1")
    train_fps = train_fps_peak = disk = None
    if train_mode in ("1", "disk"):
        disk = disk_train_bench(cfg, device)
    if train_mode != "0":
        # a model in train mode takes the plain attention whatever attn_impl says
        train_fps = round(TRAIN_BATCH / timed_train(cfg, TRAIN_BATCH, device), 2)
        train_fps_peak = round(PEAK_BATCH / timed_train(cfg, PEAK_BATCH, device,
                                                        iters=PEAK_ITERS), 2)
        if device.type == "cuda":
            torch.cuda.empty_cache()

    from mmfn_tpu_torch import bench_loop

    fleet_n = int(os.environ.get("MMFN_BENCH_FLEET", "8"))
    dw_n = int(os.environ.get("MMFN_BENCH_FLEET_DW", "128"))
    fleet = fleet_dw = fleet_dev = transport = None
    if fleet_n > 0:
        from mmfn_tpu_torch.harness.agents.e2e import MMFNAgent

        agent = MMFNAgent({"variant": "rad", "model": model, "config": cfg,
                           "device": device})
        transport = {"packed": bool(agent.pipeline.packed),
                     "host_bev": bool(agent.pipeline.host_bev)}
        fleet = bench_loop._fleet_mode(agent.pipeline, cfg, fleet_n, ticks=FLEET_TICKS,
                                       pipelined=True)
        if dw_n > 0:
            from mmfn_tpu_torch.harness.device_world import DeviceWorldPipeline

            fleet_dw = bench_loop._fleet_mode(DeviceWorldPipeline(model, cfg, device=device),
                                              cfg, dw_n, ticks=FLEET_TICKS, pipelined=True,
                                              compact_world=True)
        # the device-side ceiling: the batched pipeline at width 128 back to
        # back (host prep and round trips amortized away)
        dev_s = timed_loop(pipeline, make_inputs(DEVICE_WIDTH, rng, device), DEVICE_ITERS)
        fleet_dev = round(DEVICE_WIDTH / dev_s / 20.0, 1)

    pallas_ok = check_kernels(device, rng) if device.type == "cuda" else None
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps(bench_line(fps, latency_s, train_fps, train_fps_peak, fleet_n, fleet,
                                fleet_dw, dw_n, fleet_dev, transport, disk, pallas_ok,
                                cfg.attn_impl, name)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
