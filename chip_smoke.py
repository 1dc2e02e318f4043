#!/usr/bin/env python3
"""GPU smoke run of mmfn_tpu_torch: builds, checks, serves and times the port.

Run from the root of the repository, on a machine with one NVIDIA Hopper GPU
(sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. build both CUDA kernels from mmfn_tpu_torch/csrc (nvcc, in parallel);
  2. BEV histogram kernel == its plain PyTorch version, exactly, with
     clusters of 8 and of 16 blocks per cloud, at 1 x 65,536 f16 (serving),
     8 x 65,536 f32 (bench) and 8 x 65,536 f16 points, on bin edges, on
     clouds with no valid rows, at N not a multiple of 256, at N = 5 and
     N = 0, and on a cloud with all 65,536 points in one cell (1.0 there, 0
     elsewhere);
  3. fused attention kernel vs its plain PyTorch version at every main-path
     shape (T in {192, 256}, D in {16, 32, 64, 128}, B in {1, 8}, H = 4;
     TransFuser's T = 128 with D in {16, 32, 64, 128} at B = 1), at T = 128
     with B = 8, a ragged T, T = 1 and T = 3072, each with q, k, v
     contiguous and in the projection layout the model passes (strided
     views of a (B, T, H*D) tensor), within rtol/atol 1e-5; the result must
     be the transposed view of a contiguous (B, T, H, D) buffer;
  4. serve full-width MMFN-rad (GlobalConfig defaults: n_layer 8, 256 px,
     64 lanes, 2 x 32,768 points per tick, attn_impl "pallas"; weights from a
     seeded generator) through TorchPipeline: 3 batch-1 requests and one
     fleet of 8, with the launch counters set to 0 just before and read just
     after. Waypoints must be finite, (4, 2) and (8, 4, 2), with 32 attention
     launches and 1 BEV launch per forward, and must agree with the same
     weights served with the plain attention on the GPU and with the plain
     versions of everything on the CPU;
  5. time batch-1 request latency and batch-8 frames/s, and profile both
     (torch.profiler: device busy time, idle share, top kernels);
  6. serve the AIM, CILRS and TransFuser baselines at full width (the same
     config and seed) through the port's ``BaselineAgent``: 4 ticks of
     synthetic sensors (a 300x400 BGRA camera, gps, imu, speed; for
     TransFuser 2 x 32,768 LiDAR points, its first tick only buffering) on a
     straight route, launch counters set to 0 just before and read just
     after: per forward 32 attention launches and 1 BEV launch for
     TransFuser, none for AIM and CILRS. The raw output of the last tick
     must agree with the same weights under the plain attention on the GPU
     and with the plain versions on the CPU; then the median of 25 timed
     ticks and a profile of 5 (device ops per forward);
  7. time each kernel at its main-path shapes (CUDA events, after warm-up;
     the attention in the projection layout, also at TransFuser's shapes;
     the BEV histogram with clusters of 8 and 16, interleaved, and as the
     wrapper picks it, also at TransFuser's 1 x 65,536 f32) beside its plain
     version, SDPA for attention, and its bounds on the H100;
  8. the scored closed loop through the port's phase0 CLI
     (``mmfn_tpu_torch.harness.phase0.main``, in process) on the cross town
     (data/maps/fake_town_cross.xodr, its scenario triggers and traffic
     lights, the birdview camera drawn without cv2), serving full-width
     MMFN-rad (attn_impl "pallas", host_bev off, random weights from seed 0):
     one agent on route 0 of data/routes/benchmark_cross.xml for 150 ticks,
     synchronous and with ``agent.async_dispatch``, then ``repetitions=2
     fleet=8`` (8 routes in one fleet) for 50 ticks, lockstep and
     pipelined. The map tool (native/build/rough_map_node) is built first by
     scripts/build_native.sh when missing; a failed build fails the run.
     Launch counters set to 0 just before and read just after each run;
     every route runs to the tick cap, with a forward on every tick after
     the two warm-up ticks (148 a single agent; 48 batched forwards a fleet,
     each steering all 8 agents); every forward tick of the single agent and
     every batched forward of the fleet: 1 BEV and 32 attention launches;
     every route record: a status, no agent crash and a finite driving
     score; the first forward
     tick's waypoints against the same tick under the plain attention on
     the GPU and under the plain versions on the CPU. Printed: tick ms
     (host clock around ``MMFNAgent.run_step``, median and p90), device ops,
     busy ms and idle share per forward tick (profiled over 5 ticks), world
     and birdview ms per vehicle-tick, fleet vehicle-ticks/s, the records;
  9. train full-width MMFN-rad (GlobalConfig defaults, dropouts 0.1) at batch
     24 from 96 synthetic samples in the GPU data cache (``DeviceDataset``,
     no map column): f32 (3 warm-up steps, then 5 epochs of 4 steps, one host
     fetch each; finite losses; parameters and BN buffers f32 and moved; no
     kernel launched by the train step), validation of 2 batches of 48
     samples through the fused attention (32 launches a forward, the loss
     within rtol 1e-4 of the plain attention's), a torch.profiler breakdown
     of 5 steps, 10 bf16 steps (finite, f32 state), one remat step against a
     plain one (loss and BN statistics within rtol 1e-4, both peak
     memories), one step at n_layer 1 / 64 px / batch 4 on the card against
     the CPU (loss rtol 1e-4, parameters within 2.5 lr), and 2 steps + save +
     resume + 1 step against 3 uninterrupted steps (loss rtol 1e-4, the same
     iteration count and recent.log);
  10. train each baseline 4 f32 steps at batch 24 from the same data cache
     (CILRS on its control loss; finite losses, every parameter moved, the
     last 3 steps timed), then validate TransFuser on 2 batches through the
     fused attention (32 launches a forward, within rtol 1e-4 of the plain
     attention's loss).

Output: JSON lines per phase (the summary has the device ops per batch-1
forward; ``baseline_summary`` the baselines' tick latency and device ops
per forward; ``closed_loop_summary`` the closed loop's numbers;
``train_summary`` the training rates, peak memory, idle share and device
ops per step; ``timing`` the seconds of each phase), then a ``kernels`` line whose launches count the served
paths, MMFN-rad's requests, the baselines' ticks and the closed loop's four
phase0 runs, the GPU's name and power limit as nvidia-smi gives them, and
last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
TF32 is off for matmuls and cuDNN convolutions throughout.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the f32
# rate of the CUDA cores, and the dense TF32 tensor-core rate over the three
# TF32 products that one f32-accurate product takes ("3xTF32", kernel 2).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 495e12 / 3
SEED = 0
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)      # f32 sums in another order
WAYPOINT_TOL = dict(rtol=1e-4, atol=2e-3)   # kernels vs plain, same GPU
CPU_TOL = dict(rtol=1e-3, atol=1e-2)        # GPU vs CPU convolution algorithms
STAGE_SHAPES = ((192, 16), (192, 32), (192, 64), (256, 128))   # (T, D) by fusion stage
# TransFuser's (T, D) by fusion stage: 2 token groups of 64, at batch 1
TRANSFUSER_SHAPES = ((128, 16), (128, 32), (128, 64), (128, 128))
# T = 128 at batch 8 too; 200 is ragged; 1 and 3072 are the ends
EXTRA_ATTN_SHAPES = ((128, 64), (200, 32), (1, 16), (3072, 128))
BASELINES = ("aim", "cilrs", "transfuser")
HOT_CELL = (1.0, 1.0, 1.0)   # -> ix 136, iy 200, channel 1


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok: bool, what: str) -> None:
    """A failed check ends the run (an ``assert`` would vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


class Laps:
    """Host-clock seconds of each phase of the run, in order."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.seconds = {}

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        self.seconds[phase] = now - self.last
        self.last = now

    def total(self) -> float:
        return time.perf_counter() - self.start


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` back-to-back calls.

    The calls queue up behind a device-side sleep that outlasts the time the
    host takes to enqueue them, so the events time the device running them
    back to back, not the host launching them (``fn`` must not synchronize)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * enqueue_s + 1e-3) * 2e9))  # >= 2x the enqueue time at <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, peak_flops: float = PEAK_F32_FLOPS) -> dict:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / peak_flops * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def attention_bounds(q) -> dict:
    """Both bounds of one attention call: at the 3xTF32 tensor-core rate the
    kernel computes at, and (``bound_f32_*``) at the CUDA cores' f32 rate,
    the yardstick of the first kernel."""
    b, h, t, d = q.shape
    nbytes, ops = 4 * q.numel() * 4, 4 * b * h * t * t * d
    f32 = bound(nbytes, ops)
    return {**bound(nbytes, ops, PEAK_3XTF32_FLOPS), "bound_f32_ms": f32["bound_ms"],
            "bound_f32_by": f32["bound_by"]}


def attention_inputs(b, t, d, layout, g, dev):
    """q, k, v of shape (b, 4, t, d): contiguous, or in the projection layout,
    the view(b, t, 4, d).transpose(1, 2) of a Linear's (b, t, 4*d) output."""
    if layout == "projection":
        return tuple(torch.randn(b, t, 4 * d, generator=g, device=dev).view(b, t, 4, d)
                     .transpose(1, 2) for _ in range(3))
    return tuple(torch.randn(b, 4, t, d, generator=g, device=dev) for _ in range(3))


# --------------------------------------------------------------------------- #
# inputs
# --------------------------------------------------------------------------- #

def lidar_sweep(rng, n):
    """A spinning-LiDAR-like cloud: ranges 2-50 m, z in [-2.5, 1]."""
    r = rng.uniform(2.0, 50.0, n)
    a = rng.uniform(-np.pi, np.pi, n)
    return np.stack([r * np.cos(a), r * np.sin(a), rng.uniform(-2.5, 1.0, n)], 1).astype(np.float32)


def edge_points():
    xs = [-16.0, 16.0, -16.125, 16.125, 0.0, 15.875, float(np.nextafter(np.float32(16), np.float32(0)))]
    ys = [-24.0, 8.0, -24.125, 8.125, 0.0, 7.875, float(np.nextafter(np.float32(8), np.float32(0)))]
    zs = [-2.0, -1.999, 0.5]
    return np.array([[x, y, z] for x in xs for y in ys for z in zs] * 3, np.float32)


def padded(points, rows):
    out = np.zeros((rows, 4), np.float32)
    n = min(len(points), rows)
    out[:n, :3], out[:n, 3] = points[:n], 1.0
    return out


def payload(rng, cfg):
    lane_num = int(rng.integers(8, cfg.max_lanes + 1))
    lanes = (rng.normal(size=(cfg.max_lanes, 10, 5)) * 10).astype(np.float32)
    lanes[lane_num:] = 0
    return {"image": rng.integers(0, 256, size=(256, 256, 3)).astype(np.uint8),
            "points": np.concatenate([lidar_sweep(rng, 30000), lidar_sweep(rng, 30000)]),
            "lanes": lanes, "lane_num": lane_num,
            "radar": rng.normal(size=(81, 5)).astype(np.float32), "map_img": None,
            "target_point": (rng.normal(size=2) * 5).astype(np.float32),
            "speed": float(abs(rng.normal()) * 5)}


def call_args(p):
    return (p["image"], p["points"], p["lanes"], p["lane_num"], p["radar"], p["map_img"],
            p["target_point"], p["speed"])


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #

def check_bev(lidar, rng, dev):
    cases = {
        "serving_1x65536_f16": np.stack([padded(np.concatenate(
            [lidar_sweep(rng, 60000), edge_points()]), 65536)]).astype(np.float16),
        "bench_8x65536_f32": np.stack([padded(lidar_sweep(rng, 65536), 65536)
                                       for _ in range(8)]),
        "edges_1x1024_f32": padded(edge_points(), 1024)[None],
        "no_valid_rows_2x4096_f32": np.zeros((2, 4096, 4), np.float32),
        "ragged_3x65537_f16": np.stack([padded(lidar_sweep(rng, 50000), 65537)
                                        for _ in range(3)]).astype(np.float16),
        "fleet_8x65536_f16": np.stack([padded(lidar_sweep(rng, 65536), 65536)
                                       for _ in range(8)]).astype(np.float16),
        "hot_cell_1x65536_f32": padded(np.tile(np.float32(HOT_CELL), (65536, 1)), 65536)[None],
        "five_points_1x5_f32": padded(lidar_sweep(rng, 5) / 8, 5)[None],
        "empty_2x0_f32": np.zeros((2, 0, 4), np.float32),
    }
    err = 0.0
    for name, pts in cases.items():
        x = torch.from_numpy(pts).to(dev)
        want = lidar.bev_histogram_plain(x)
        for cluster in lidar.CLUSTERS:
            got = lidar._bev_histogram_cuda(x, cluster)
            torch.cuda.synchronize()
            require(got.shape == want.shape == (pts.shape[0], 256, 256, 2),
                    f"BEV shape on {name}")
            diff = float((got - want).abs().max())
            occupied = int((got > 0).sum())
            emit("bev_check", case=name, cluster=cluster, max_abs_err=diff,
                 occupied_cells=occupied)
            require(diff == 0.0, f"BEV kernel == plain version on {name}, cluster {cluster}")
            require(name.startswith(("no_valid", "empty")) or occupied > 0,
                    f"occupied cells on {name}")
            if name.startswith("hot_cell"):
                want_hot = torch.zeros_like(got)
                want_hot[0, 136, 200, 1] = 1.0
                require(bool(torch.equal(got, want_hot)), "hot cell: 1.0 there and 0 elsewhere")
            err = max(err, diff)
    return err


def check_attention(attention, dev):
    g = torch.Generator(device=dev).manual_seed(SEED)
    err = 0.0
    main_path = [(t, d) for t in (192, 256) for d in (16, 32, 64, 128)]
    for b in (1, 8):
        baseline_path = list(TRANSFUSER_SHAPES) if b == 1 else []
        for t, d in main_path + baseline_path + list(EXTRA_ATTN_SHAPES):
            for layout in ("contiguous", "projection"):
                q, k, v = attention_inputs(b, t, d, layout, g, dev)
                got = attention.fused_attention(q, k, v)
                want = attention.attention_plain(q, k, v)
                torch.cuda.synchronize()
                diff = float((got - want).abs().max())
                emit("attention_check", shape=[b, 4, t, d], layout=layout, max_abs_err=diff)
                torch.testing.assert_close(got, want, **ATTN_TOL)
                require(got.shape == (b, 4, t, d) and got.transpose(1, 2).is_contiguous(),
                        f"attention output is the transposed view of a (B, T, H, D) buffer: "
                        f"shape {tuple(got.shape)}, strides {got.stride()}")
                if (t, d) in STAGE_SHAPES or (t, d) in baseline_path:
                    err = max(err, diff)
    return err


def serve(cfg, dev, ops, rng):
    from mmfn_tpu_torch.harness.agents import TorchPipeline
    from mmfn_tpu_torch.models import build_model
    from mmfn_tpu_torch.models.gpt import SelfAttention

    t0 = time.perf_counter()
    model = build_model(cfg, "rad", torch.Generator().manual_seed(SEED), device=dev)
    pipe = TorchPipeline(model, cfg, device=dev)
    payloads = [payload(rng, cfg) for _ in range(8)]
    emit("serve_setup", seconds=time.perf_counter() - t0,
         parameters=sum(p.numel() for p in model.parameters()))

    ops.reset_launch_counts()
    singles = [pipe(*call_args(p)) for p in payloads[:3]]
    fleet = pipe.dispatch_fleet(payloads).cpu().numpy()
    launches = {name: k.launches for name, k in ops.KERNELS.items()}
    forwards = 4
    emit("serve", launches=launches, forwards=forwards, waypoints_0=singles[0].tolist())
    for w in singles:
        require(w.shape == (4, 2) and bool(np.isfinite(w).all()), f"batch-1 waypoints {w}")
    require(fleet.shape == (8, 4, 2) and bool(np.isfinite(fleet).all()), "fleet waypoints")
    require(launches["fused_attention"] == 32 * forwards, f"32 attention launches a forward: {launches}")
    require(launches["bev_hist"] == forwards, f"one BEV launch a forward: {launches}")
    for i, w in enumerate(singles):
        np.testing.assert_allclose(fleet[i], w, **WAYPOINT_TOL)

    # the same weights with the plain attention on the GPU
    attn = [m for m in model.modules() if isinstance(m, SelfAttention)]
    for m in attn:
        m.attn_impl = "xla"
    plain_gpu = pipe(*call_args(payloads[0]))
    for m in attn:
        m.attn_impl = "pallas"
    # and with the plain versions of everything on the CPU
    cpu_pipe = TorchPipeline(build_model(cfg, "rad", torch.Generator().manual_seed(SEED),
                                         device="cpu"), cfg, device="cpu")
    plain_cpu = cpu_pipe(*call_args(payloads[0]))
    emit("serve_reference", max_abs_vs_plain_gpu=float(np.abs(singles[0] - plain_gpu).max()),
         max_abs_vs_cpu=float(np.abs(singles[0] - plain_cpu).max()),
         max_abs_waypoint=float(np.abs(plain_cpu).max()))
    np.testing.assert_allclose(singles[0], plain_gpu, **WAYPOINT_TOL)
    np.testing.assert_allclose(singles[0], plain_cpu, **CPU_TOL)
    return pipe, payloads, launches


def time_serving(pipe, payloads):
    args = call_args(payloads[0])
    for _ in range(5):
        pipe(*args)
    lat = []
    for i in range(40):
        t0 = time.perf_counter()
        pipe(*call_args(payloads[i % len(payloads)]))
        lat.append((time.perf_counter() - t0) * 1e3)
    for _ in range(3):
        pipe.dispatch_fleet(payloads).cpu()
    fleet = []
    for _ in range(20):
        t0 = time.perf_counter()
        pipe.dispatch_fleet(payloads).cpu()
        fleet.append(time.perf_counter() - t0)
    lat.sort()
    out = {"batch1_latency_ms_median": statistics.median(lat),
           "batch1_latency_ms_p90": lat[int(0.9 * len(lat)) - 1],
           "batch1_latency_ms_mean": statistics.fmean(lat),
           "batch8_step_ms_median": statistics.median(fleet) * 1e3,
           "batch8_frames_per_s": 8 / statistics.median(fleet)}
    emit("serving_time", **out)
    return out


def time_kernels(lidar, attention, dev, rng):
    import torch.nn.functional as F

    rows = {}
    for name, b, dtype in (("serving", 1, torch.float16), ("bench", 8, torch.float32),
                           ("fleet", 8, torch.float16), ("transfuser", 1, torch.float32)):
        pts = torch.from_numpy(np.stack([padded(lidar_sweep(rng, 60000), 65536)
                                         for _ in range(b)])).to(dev, dtype)
        nbytes = pts.numel() * pts.element_size() + b * 256 * 256 * 2 * 4
        ops = 12 * b * 65536 + 2 * b * 256 * 256 * 2
        # each cluster size twice, interleaved 8, 16, 16, 8, so drift falls on both
        by_cluster = {c: [] for c in lidar.CLUSTERS}
        for c in lidar.CLUSTERS + lidar.CLUSTERS[::-1]:
            by_cluster[c].append(cuda_ms(lambda: lidar._bev_histogram_cuda(pts, c)))
        rows[f"bev_{name}"] = {"shape": list(pts.shape), "dtype": str(dtype),
                               "cluster": lidar.cluster_size(b),
                               "ms": cuda_ms(lambda: lidar.bev_histogram(pts)),
                               "ms_by_cluster": {str(c): statistics.fmean(t)
                                                 for c, t in by_cluster.items()},
                               "plain_ms": cuda_ms(lambda: lidar.bev_histogram_plain(pts)),
                               "library_ms": None, **bound(nbytes, ops)}
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    shapes = [(b, t, d) for b in (1, 8) for t, d in STAGE_SHAPES]
    for b, t, d in shapes + [(1, t, d) for t, d in TRANSFUSER_SHAPES]:
        q, k, v = attention_inputs(b, t, d, "projection", g, dev)
        rows[f"attention_b{b}_t{t}_d{d}"] = {
            "shape": [b, 4, t, d], "layout": "projection",
            "ms": cuda_ms(lambda: attention.fused_attention(q, k, v)),
            "plain_ms": cuda_ms(lambda: attention.attention_plain(q, k, v)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
            **attention_bounds(q)}
    for key, row in rows.items():
        emit("kernel_time", name=key, **row)
    return rows


def profile_calls(fn, reps: int):
    """torch.profiler over ``reps`` calls of ``fn`` (which must end in a host
    fetch or synchronize): per call, wall time, device busy time (the sum of
    the kernels' and copies' device time; one stream, so they do not
    overlap; user annotations such as ``Optimizer.step``, which span other
    kernels, are left out), idle share and device ops, and the top 12 device
    ops."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    return device_summary(prof, wall_ms, reps)


def device_summary(prof, wall_ms: float, reps: int):
    """A finished profile's device numbers per call (see ``profile_calls``)."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3 / reps
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:12]
    summary = {"wall_ms_per_call": wall_ms, "device_busy_ms_per_call": busy_ms,
               "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
               "device_ops_per_call": sum(e.count for e in dev) / reps}
    return summary, [{"name": e.key[:100], "calls_per_call": e.count / reps,
                      "ms_per_call": e.self_device_time_total / 1e3 / reps} for e in top]


def profile_serving(pipe, payloads, reps: int = 10):
    """Where a request's time goes: torch.profiler over ``reps`` batch-1
    requests and ``reps`` fleets of 8."""
    out = {}
    for label, fn in (("batch1", lambda: pipe(*call_args(payloads[0]))),
                      ("batch8", lambda: pipe.dispatch_fleet(payloads).cpu())):
        fn()
        torch.cuda.synchronize()
        out[label], top = profile_calls(fn, reps)
        emit("profile", run=label, **out[label], top=top)
    return out


# --------------------------------------------------------------------------- #
# the baselines, served in the closed-loop agent
# --------------------------------------------------------------------------- #

BASELINE_TICKS = 4                # counted ticks per agent; TransFuser's first only buffers
POINTS_PER_SWEEP = 32768


def straight_plan(route_option):
    """A straight 100 m route along x: (gps plan, world plan), the gps plan
    in the evaluator's linear convention."""
    from mmfn_tpu_torch.control.planner import GPS_SCALE

    world = [((float(x), 0.0), route_option) for x in range(100)]
    return [({"lat": x / GPS_SCALE[0], "lon": y / GPS_SCALE[1], "z": 0.0}, o)
            for (x, y), o in world], world


def sensor_ticks(rng, n, lidar):
    """``n`` sensor dicts as the harness hands them to an agent: a 300x400
    BGRA camera, gps along the route, imu, speed and, with ``lidar``, one
    sweep of 32,768 points [x, y, z, intensity]."""
    from mmfn_tpu_torch.control.planner import GPS_SCALE

    ticks = []
    for i in range(n):
        x, y = 0.5 * i + rng.uniform(-0.2, 0.2), rng.uniform(-0.5, 0.5)
        tick = {"rgb": (i, rng.integers(0, 256, size=(300, 400, 4)).astype(np.uint8)),
                "gps": (i, np.array([x / GPS_SCALE[0], y / GPS_SCALE[1], 0.0])),
                "imu": (i, np.array([0.0, 0.0, 9.81, 0.0, 0.0, 0.0, rng.uniform(-0.1, 0.1)])),
                "speed": (i, {"speed": float(rng.uniform(0.0, 8.0))})}
        if lidar:
            sweep = lidar_sweep(rng, POINTS_PER_SWEEP)
            tick["lidar"] = (i, np.concatenate(
                [sweep, rng.uniform(0, 1, (POINTS_PER_SWEEP, 1)).astype(np.float32)], 1))
        ticks.append(tick)
    return ticks


def flat(out) -> np.ndarray:
    """A raw model output (waypoints, or CILRS's four tensors) as one array."""
    if isinstance(out, (tuple, list)):
        return torch.cat([o.reshape(-1) for o in out]).cpu().numpy()
    return out.cpu().numpy()


def serve_baseline(name, cfg, dev, ops, rng, gpu):
    """One baseline in the port's BaselineAgent at full width: counted ticks
    (launch counters set to 0 just before and read just after), its raw
    output against plain attention on the GPU and plain everything on the
    CPU, then tick latency and a profile."""
    from mmfn_tpu_torch.harness.agents import BaselineAgent
    from mmfn_tpu_torch.harness.route import RoadOption
    from mmfn_tpu_torch.models import build_baseline
    from mmfn_tpu_torch.models.gpt import SelfAttention

    t0 = time.perf_counter()
    model = build_baseline(name, cfg, torch.Generator().manual_seed(SEED), device=dev)
    agent = BaselineAgent({"kind": name, "model": model, "config": cfg, "device": dev,
                           "points_per_sweep": POINTS_PER_SWEEP})
    agent.set_global_plan(*straight_plan(RoadOption.LANEFOLLOW))
    calls = []
    forward = agent._forward

    def recording(*args):
        out = forward(*args)
        calls.append((args, out))
        return out
    agent._forward = recording
    lidar = name == "transfuser"
    ticks = sensor_ticks(rng, BASELINE_TICKS, lidar)
    setup_s = time.perf_counter() - t0

    ops.reset_launch_counts()
    controls = [agent.run_step(tick, 0.05 * i) for i, tick in enumerate(ticks)]
    launches = {k: kernel.launches for k, kernel in ops.KERNELS.items()}
    forwards = len(calls)
    require(forwards == BASELINE_TICKS - int(lidar), f"{name}: forwards {forwards}")
    per_forward = {k: v / forwards for k, v in launches.items()}
    want = ({"fused_attention": 4 * cfg.n_layer, "bev_hist": 1} if lidar
            else {"fused_attention": 0, "bev_hist": 0})
    require(per_forward == want, f"{name}: launches per forward {per_forward}, want {want}")
    outs = [flat(out) for _, out in calls]
    require(all(np.isfinite(o).all() and o.shape == ((4,) if name == "cilrs" else (1, 4, 2))
                for o in outs), f"{name}: finite outputs of the right shape")
    require(all(np.isfinite([c.steer, c.throttle, c.brake]).all() for c in controls),
            f"{name}: finite controls")

    args = calls[-1][0]
    attn = [m for m in model.modules() if isinstance(m, SelfAttention)]
    for m in attn:
        m.attn_impl = "xla"
    plain_gpu = flat(agent._forward(*args))
    for m in attn:
        m.attn_impl = "pallas"
    cpu_agent = BaselineAgent({"kind": name, "model": copy.deepcopy(model).cpu(),
                               "config": cfg, "device": "cpu",
                               "points_per_sweep": POINTS_PER_SWEEP})
    plain_cpu = flat(cpu_agent._forward(*args))
    del cpu_agent
    np.testing.assert_allclose(outs[-1], plain_gpu, **WAYPOINT_TOL)
    np.testing.assert_allclose(outs[-1], plain_cpu, **CPU_TOL)

    more = sensor_ticks(rng, 31, lidar)
    agent.run_step(more[0], 0.0)                 # fills TransFuser's sweep buffer
    lat = []
    for i, tick in enumerate(more[1:26]):
        t1 = time.perf_counter()
        agent.run_step(tick, 0.05 * i)
        lat.append((time.perf_counter() - t1) * 1e3)
    rest = iter(more[26:])
    prof, top = profile_calls(lambda: agent.run_step(next(rest), 0.0), 5)
    lat.sort()
    out = {"model": name, "gpu": gpu, "setup_seconds": setup_s,
           "parameters": sum(p.numel() for p in model.parameters()),
           "launches": launches, "forwards": forwards,
           "tick_ms_median": statistics.median(lat), "tick_ms_p90": lat[int(0.9 * len(lat)) - 1],
           "device_ops_per_forward": prof["device_ops_per_call"],
           "device_busy_ms_per_forward": prof["device_busy_ms_per_call"],
           "device_idle_share": prof["device_idle_share"],
           "max_abs_vs_plain_gpu": float(np.abs(outs[-1] - plain_gpu).max()),
           "max_abs_vs_cpu": float(np.abs(outs[-1] - plain_cpu).max()),
           "max_abs_output": float(np.abs(plain_cpu).max()), "output_0": outs[0].tolist(),
           "control_last": [controls[-1].steer, controls[-1].throttle, controls[-1].brake]}
    emit("baseline_serve", **out, top=top)
    return out


def serve_baselines(cfg, dev, ops, rng, gpu):
    out = {}
    for name in BASELINES:
        out[name] = serve_baseline(name, cfg, dev, ops, rng, gpu)
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# the scored closed loop, through the port's phase0 CLI
# --------------------------------------------------------------------------- #

CLOSED_LOOP_TICKS = 150           # one route, one agent; sync, then async
FLEET, FLEET_TICKS = 8, 50        # 4 routes x 2 repetitions in one fleet
PROFILED_TICKS = 5                # forward ticks profiled in each single-agent run
PROFILE_FROM = 40                 # ... from this forward tick on
MAP_TOOL = os.path.join("native", "build", "rough_map_node")
ROUTES = os.path.join("data", "routes", "benchmark_cross.xml")
CLI_ARGS = ["--config", os.path.join("run_steps", "config", "eval.yaml"),
            "map=" + os.path.join("data", "maps", "fake_town_cross.xodr"),
            "scenarios=" + os.path.join("data", "scenarios", "fake_towns_scenarios.json"),
            "agent.type=e2e", "agent.variant=rad", "agent.attn_impl=pallas",
            "agent.model_path=null", "resume=false", "max_wall_seconds=900"]


def map_tool() -> None:
    """Build the map tool with scripts/build_native.sh when it is missing
    (the checkout has no native/build/); a failed build fails the run."""
    built, t0 = not os.path.exists(MAP_TOOL), time.perf_counter()
    if built:
        out = subprocess.run(["bash", os.path.join("scripts", "build_native.sh")],
                             capture_output=True, text=True, timeout=600)
        require(out.returncode == 0,
                f"scripts/build_native.sh failed:\n{(out.stdout + out.stderr)[-2000:]}")
    require(os.access(MAP_TOOL, os.X_OK), f"an executable map tool at {MAP_TOOL}")
    emit("map_tool", path=MAP_TOOL, built_here=built, seconds=time.perf_counter() - t0)


class ClosedLoopProbe:
    """Times and counts what one phase0 CLI run does, by wrapping methods of
    the port's classes while the run lasts (``with probe:``): the host clock
    around each ``MMFNAgent.run_step`` and the kernel launches of each tick
    that dispatched a forward; the kernel launches of each
    ``dispatch_fleet``; the ``MMFNAgent.finish_step`` calls that returned a
    control; the world's ``sensor_frame`` and ``tick`` and the
    birdview's ``produce``; the first dispatch's pipeline, inputs and
    waypoints; ``FleetRunner.run``'s wall time; and a torch.profiler window
    over ``PROFILED_TICKS`` forward ticks of a single agent, whose ticks are
    left out of the latency figures."""

    def __init__(self, ops):
        self.ops = ops
        self.tick_ms, self.tick_launches, self.fleet_launches = [], [], []
        self.frame_ms, self.step_ms, self.birdview_ms = [], [], []   # the world
        self.dispatches = 0
        self.steered = 0                  # finish_step calls that returned
        self.fleet_seconds = 0.0
        self.first = None                 # (pipeline, args, waypoints)
        self.profile = None
        self._window = None               # [profiler, ms, ticks] while profiling
        self._saved = []

    def launches(self):
        return {name: k.launches for name, k in self.ops.KERNELS.items()}

    def _since(self, before):
        return {k: v - before[k] for k, v in self.launches().items()}

    def _wrap(self, cls, name, make):
        orig = getattr(cls, name)
        self._saved.append((cls, name, orig))
        setattr(cls, name, make(orig))

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        from mmfn_tpu_torch.harness.agents import MMFNAgent, TorchPipeline
        from mmfn_tpu_torch.harness.fleet import FleetRunner
        from mmfn_tpu_torch.harness.replay import KinematicWorld
        from mmfn_tpu_torch.mapping.birdview import BirdViewProducer
        probe = self

        def run_step(orig):
            def wrapped(agent, input_data, timestamp):
                if (probe._window is None and probe.profile is None
                        and len(probe.tick_launches) == PROFILE_FROM):
                    probe._window = [profile(activities=[ProfilerActivity.CPU,
                                                         ProfilerActivity.CUDA]), 0.0, 0]
                    probe._window[0].__enter__()
                before, dispatches = probe.launches(), probe.dispatches
                t0 = time.perf_counter()
                control = orig(agent, input_data, timestamp)
                ms = (time.perf_counter() - t0) * 1e3
                if probe.dispatches == dispatches:
                    return control            # a warm-up tick
                probe.tick_launches.append(probe._since(before))
                if probe._window is None:
                    probe.tick_ms.append(ms)
                    return control
                probe._window[1] += ms
                probe._window[2] += 1
                if probe._window[2] == PROFILED_TICKS:
                    prof, wall_ms, n = probe._window
                    torch.cuda.synchronize()
                    prof.__exit__(None, None, None)
                    probe.profile = device_summary(prof, wall_ms / n, n)
                    probe._window = None
                return control
            return wrapped

        def dispatch(orig):
            def wrapped(pipe, *args):
                out = orig(pipe, *args)
                probe.dispatches += 1
                if probe.first is None:
                    probe.first = (pipe, args, out.cpu().numpy())
                return out
            return wrapped

        def dispatch_fleet(orig):
            def wrapped(pipe, payloads):
                before = probe.launches()
                out = orig(pipe, payloads)
                probe.fleet_launches.append(probe._since(before))
                return out
            return wrapped

        def finish_step(orig):
            def wrapped(agent, payload, waypoints):
                control = orig(agent, payload, waypoints)
                probe.steered += 1
                return control
            return wrapped

        def timed(store):
            def make(orig):
                def wrapped(*args, **kw):
                    t0 = time.perf_counter()
                    out = orig(*args, **kw)
                    store.append((time.perf_counter() - t0) * 1e3)
                    return out
                return wrapped
            return make

        def fleet_run(orig):
            def wrapped(runner, agents, routes):
                t0 = time.perf_counter()
                out = orig(runner, agents, routes)
                probe.fleet_seconds += time.perf_counter() - t0
                return out
            return wrapped

        self._wrap(MMFNAgent, "run_step", run_step)
        self._wrap(MMFNAgent, "finish_step", finish_step)
        self._wrap(TorchPipeline, "dispatch", dispatch)
        self._wrap(TorchPipeline, "dispatch_fleet", dispatch_fleet)
        self._wrap(KinematicWorld, "sensor_frame", timed(self.frame_ms))
        self._wrap(KinematicWorld, "tick", timed(self.step_ms))
        self._wrap(BirdViewProducer, "produce", timed(self.birdview_ms))
        self._wrap(FleetRunner, "run", fleet_run)
        return self

    def __exit__(self, *exc):
        for cls, name, orig in reversed(self._saved):
            setattr(cls, name, orig)
        self._saved = []
        if self._window is not None:
            self._window[0].__exit__(None, None, None)
            self._window = None
        return False

    @property
    def vehicle_ticks(self) -> int:
        return len(self.step_ms)


def run_phase0(phase0, ops, name, extra, tmp):
    """One in-process run of the port's phase0 CLI under a probe, with the
    launch counters set to 0 just before and read just after."""
    checkpoint = os.path.join(tmp, f"{name}.json")
    probe = ClosedLoopProbe(ops)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with probe:
        require(phase0.main(CLI_ARGS + ["checkpoint=" + checkpoint] + extra) == 0,
                f"phase0 {name} exits 0")
    seconds = time.perf_counter() - t0
    launches = probe.launches()
    with open(checkpoint) as f:
        records = json.load(f)["_checkpoint"]["records"]
    for r in records:
        require(bool(r.get("status")) and np.isfinite(r["scores"]["score_composed"]),
                f"phase0 {name}: a status and a finite score_composed: {r}")
        # the runner scores an agent's exception as a failed route: here it fails the run
        require("Agent crashed" not in r["status"], f"phase0 {name}: {r['status']}")
    world_ms = sum(probe.frame_ms) + sum(probe.step_ms)
    return probe, {"run": name, "seconds": seconds, "launches": launches,
                   "routes": len(records),
                   "records": [[r["route_id"], r["status"], r["scores"]["score_composed"]]
                               for r in records],
                   "world_ms_per_tick": world_ms / max(1, probe.vehicle_ticks),
                   "birdview_ms_per_tick": sum(probe.birdview_ms) / max(1, probe.vehicle_ticks),
                   "vehicle_ticks": probe.vehicle_ticks}


def first_route_file(tmp) -> str:
    """Route 0 of data/routes/benchmark_cross.xml, alone in a routes file."""
    import xml.etree.ElementTree as ET

    tree = ET.parse(ROUTES)
    root = tree.getroot()
    for route in root.findall("route")[1:]:
        root.remove(route)
    path = os.path.join(tmp, "benchmark_cross_route0.xml")
    tree.write(path)
    return path


def closed_loop(cfg, ops, gpu):
    """The port's phase0 CLI over the cross town, full-width MMFN-rad
    (GlobalConfig defaults, attn_impl "pallas", random weights from seed 0,
    host_bev off): one agent on route 0 of data/routes/benchmark_cross.xml
    for CLOSED_LOOP_TICKS ticks, sync and async_dispatch, then a fleet of 8
    (the file's 4 routes, 2 repetitions) for FLEET_TICKS ticks, lockstep and
    pipelined. Every record needs a status, no agent crash and a finite
    score; every route runs to the tick cap with a forward on every tick after
    the two warm-up ticks, and every fleet agent steers from each batched
    forward; every forward tick of the single agent, and every batched
    forward of the fleet, 1 BEV and 4 * n_layer attention launches; the first
    forward tick's waypoints
    must agree with the plain attention on the GPU and with the plain
    versions on the CPU."""
    from mmfn_tpu_torch.harness import phase0
    from mmfn_tpu_torch.harness.agents import TorchPipeline
    from mmfn_tpu_torch.models.gpt import SelfAttention

    want = {"bev_hist": 1, "fused_attention": 4 * cfg.n_layer}
    out, total = {}, {name: 0 for name in ops.KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        route0 = first_route_file(tmp)
        for name, extra in (("sync", []), ("async", ["agent.async_dispatch=true"])):
            probe, row = run_phase0(phase0, ops, name, [
                "routes=" + route0, f"max_ticks={CLOSED_LOOP_TICKS}"] + extra, tmp)
            # every tick after the two warm-up ticks drives a forward, up to the cap
            require(probe.vehicle_ticks == CLOSED_LOOP_TICKS
                    and len(probe.tick_launches) == CLOSED_LOOP_TICKS - 2,
                    f"{name}: {probe.vehicle_ticks} world ticks, "
                    f"{len(probe.tick_launches)} forward ticks")
            bad = [n for n in probe.tick_launches if n != want]
            require(not bad, f"{name}: every forward tick launches {want}; got {bad[:3]}")
            lat = sorted(probe.tick_ms)
            row.update(forward_ticks=len(probe.tick_launches),
                       tick_ms_median=statistics.median(lat),
                       tick_ms_p90=lat[int(0.9 * len(lat)) - 1],
                       device_ops_per_forward=probe.profile[0]["device_ops_per_call"],
                       device_busy_ms_per_forward=probe.profile[0]["device_busy_ms_per_call"],
                       device_idle_share=probe.profile[0]["device_idle_share"],
                       profiled_tick_ms=probe.profile[0]["wall_ms_per_call"])
            if name == "sync":
                pipe, args, waypoints = probe.first
                attn = [m for m in pipe.model.modules() if isinstance(m, SelfAttention)]
                for m in attn:
                    m.attn_impl = "xla"
                plain_gpu = pipe(*args)
                for m in attn:
                    m.attn_impl = "pallas"
                cpu_pipe = TorchPipeline(copy.deepcopy(pipe.model).cpu(), pipe.config,
                                         points_per_sweep=pipe.points_per_sweep,
                                         host_bev=pipe.host_bev, device="cpu")
                plain_cpu = cpu_pipe(*args)
                probe.first = None            # the pipeline goes with the run
                del cpu_pipe, pipe
                row.update(first_waypoints=waypoints.tolist(),
                           max_abs_vs_plain_gpu=float(np.abs(waypoints - plain_gpu).max()),
                           max_abs_vs_cpu=float(np.abs(waypoints - plain_cpu).max()))
                require(waypoints.shape == (4, 2) and bool(np.isfinite(waypoints).all()),
                        f"first-tick waypoints {waypoints}")
                np.testing.assert_allclose(waypoints, plain_gpu, **WAYPOINT_TOL)
                np.testing.assert_allclose(waypoints, plain_cpu, **CPU_TOL)
            emit("closed_loop", gpu=gpu, **row, top=probe.profile[1])
            out[name] = row
            for k, v in row["launches"].items():
                total[k] += v
            torch.cuda.empty_cache()
        for name, extra in (("fleet_lockstep", []),
                            ("fleet_pipelined", ["agent.async_dispatch=true"])):
            probe, row = run_phase0(phase0, ops, name, [
                "routes=" + ROUTES, "repetitions=2", f"fleet={FLEET}",
                f"max_ticks={FLEET_TICKS}"] + extra, tmp)
            require(row["routes"] == FLEET, f"{name}: {FLEET} routes in one fleet")
            # all 8 routes live up to the cap: one batched forward a tick after
            # the two warm-up ticks, and every agent steered from each of them
            forwards = FLEET_TICKS - 2
            require(probe.vehicle_ticks == FLEET * FLEET_TICKS
                    and len(probe.fleet_launches) == forwards
                    and probe.steered == FLEET * forwards,
                    f"{name}: {probe.vehicle_ticks} world ticks, "
                    f"{len(probe.fleet_launches)} batched forwards, {probe.steered} steered")
            bad = [n for n in probe.fleet_launches if n != want]
            require(not bad,
                    f"{name}: every batched forward launches {want}; got {bad[:3]}")
            row.update(batched_forwards=len(probe.fleet_launches),
                       fleet_seconds=probe.fleet_seconds,
                       vehicle_ticks_per_s=probe.vehicle_ticks / probe.fleet_seconds)
            emit("closed_loop", gpu=gpu, **row)
            out[name] = row
            for k, v in row["launches"].items():
                total[k] += v
            torch.cuda.empty_cache()
    summary = {
        "gpu": gpu,
        "tick_ms_median": {k: out[k]["tick_ms_median"] for k in ("sync", "async")},
        "tick_ms_p90": {k: out[k]["tick_ms_p90"] for k in ("sync", "async")},
        "device_ops_per_forward": {k: out[k]["device_ops_per_forward"] for k in ("sync", "async")},
        "device_busy_ms_per_forward": {k: out[k]["device_busy_ms_per_forward"]
                                       for k in ("sync", "async")},
        "device_idle_share": {k: out[k]["device_idle_share"] for k in ("sync", "async")},
        "world_ms_per_tick": {k: r["world_ms_per_tick"] for k, r in out.items()},
        "birdview_ms_per_tick": {k: r["birdview_ms_per_tick"] for k, r in out.items()},
        "fleet_vehicle_ticks_per_s": {k: out[k]["vehicle_ticks_per_s"]
                                      for k in ("fleet_lockstep", "fleet_pipelined")},
        "records": {k: r["records"] for k, r in out.items()},
        "launches": total}
    emit("closed_loop_summary", **summary)
    return summary


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #

TRAIN_BATCH = 24                  # run_steps/config/train.yaml
TRAIN_SAMPLES, VAL_SAMPLES = 96, 48
TRAIN_RTOL = 1e-4
GRAD_F64_BOUND = 1e-6


def train_model(cfg, dev, seed=SEED):
    from mmfn_tpu_torch.models import build_model

    return build_model(cfg, "rad", torch.Generator().manual_seed(seed), device=dev)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b| (1 where b is all zero and a is not)."""
    scale = float(b.abs().max())
    diff = float((a.double() - b.double()).abs().max())
    return diff / scale if scale else float(diff > 0)


def running_stats(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def stay_f32(model, what: str) -> None:
    require(all(v.dtype == torch.float32 for k, v in model.state_dict().items()
                if not k.endswith("num_batches_tracked")),
            f"{what}: parameters and BN buffers stay f32")


def cycle_batches(cache, n: int, first_seed: int):
    """``n`` shuffled batch-24 gathers, epoch after epoch."""
    out, epoch = [], 0
    while len(out) < n:
        for b in cache.batches(TRAIN_BATCH, shuffle=True, seed=first_seed + epoch):
            if len(out) == n:
                break
            out.append(b)
        epoch += 1
    return out


def train_data(cfg, dev):
    from mmfn_tpu_torch.data.device_cache import DeviceDataset, estimate_cache_bytes
    from mmfn_tpu_torch.data.synthetic import synthetic_samples

    t0 = time.perf_counter()
    train = DeviceDataset(synthetic_samples(TRAIN_SAMPLES, cfg.max_lanes, seed=SEED + 1),
                          cfg.max_lanes, need_map=False, device=dev)
    val = DeviceDataset(synthetic_samples(VAL_SAMPLES, cfg.max_lanes, seed=SEED + 2),
                        cfg.max_lanes, need_map=False, device=dev)
    estimate = estimate_cache_bytes(TRAIN_SAMPLES, cfg.max_lanes, need_map=False)
    emit("train_data", seconds=time.perf_counter() - t0, train_bytes=train.nbytes,
         val_bytes=val.nbytes, estimate_train_bytes=estimate)
    require(0 < train.nbytes <= estimate, f"cache {train.nbytes} B within its estimate {estimate}")
    return train, val


def train_f32(cfg, dev, ops, train, val, logdir):
    """3 warm-up steps and 5 epochs of 4 batch-24 steps, each epoch ending in
    its one host fetch; then validation through the fused attention kernel
    against the plain attention on the same weights."""
    from mmfn_tpu_torch.models.gpt import SelfAttention
    from mmfn_tpu_torch.train import Engine

    model = train_model(cfg, dev)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    engine = Engine(model, cfg, logdir)
    state = engine.initial_state()
    ops.reset_launch_counts()
    for b in cycle_batches(train, 3, SEED):
        engine.train_step(state, b, SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps_per_epoch = TRAIN_SAMPLES // TRAIN_BATCH
    step_ms = []
    for epoch in range(5):
        t0 = time.perf_counter()
        engine.train(state, train.batches(TRAIN_BATCH, shuffle=True, seed=epoch + SEED * 10007),
                     SEED)
        step_ms.append((time.perf_counter() - t0) * 1e3 / steps_per_epoch)
    peak = torch.cuda.max_memory_allocated()
    train_launches = {name: k.launches for name, k in ops.KERNELS.items()}
    require(all(np.isfinite(engine.train_loss)), f"finite losses {engine.train_loss}")
    require(not any(train_launches.values()),
            f"the train step runs no fused kernel (plain attention, cached BEV): {train_launches}")
    stay_f32(model, "f32 training")
    unmoved = [k for k, p in model.named_parameters() if torch.equal(p, start[k])]
    # softmax ignores the key bias, so its gradient is zero up to rounding
    require(all(k.endswith("attn.key.bias") for k in unmoved), f"parameters moved: {unmoved}")
    stats = running_stats(model)
    require(all(not torch.equal(v, start[k]) for k, v in stats.items()), "BN statistics moved")

    val_batches = list(val.batches(TRAIN_BATCH))
    ops.reset_launch_counts()
    val_loss = engine.validate(state, val_batches)
    val_launches = {name: k.launches for name, k in ops.KERNELS.items()}
    attn = [m for m in model.modules() if isinstance(m, SelfAttention)]
    for m in attn:
        m.attn_impl = "xla"
    val_plain = engine.validate(state, val_batches)
    for m in attn:
        m.attn_impl = "pallas"
    require(val_launches["fused_attention"] == 32 * len(val_batches) and
            not val_launches["bev_hist"],
            f"32 attention launches per validation forward: {val_launches}")
    require(np.isfinite(val_loss) and abs(val_loss - val_plain) <= TRAIN_RTOL * abs(val_plain),
            f"validation loss {val_loss} with the kernel, {val_plain} with the plain attention")
    out = {"samples_per_s": TRAIN_BATCH / (statistics.median(step_ms) / 1e3),
           "step_ms_median": statistics.median(step_ms), "step_ms_by_epoch": step_ms,
           "peak_bytes": peak, "epoch_losses": engine.train_loss, "val_loss": val_loss,
           "val_loss_plain": val_plain, "unmoved_parameters": unmoved,
           "train_launches": train_launches, "val_launches": val_launches,
           "val_forwards": len(val_batches)}
    emit("train_f32", **out)
    return engine, state, out


def profile_training(label, engine, state, train, step_ms, reps: int = 5):
    """Where a train step's time goes: torch.profiler over ``reps`` steps,
    each a device gather of its batch, forward, backward and AdamW, ending in
    a synchronize. The profiler slows the host, so the idle share is also
    given against ``step_ms``, the unprofiled step time."""
    batches = iter(cycle_batches(train, reps + 1, SEED + 100))

    def step():
        engine.train_step(state, next(batches), SEED)
        torch.cuda.synchronize()

    step()
    out, top = profile_calls(step, reps)
    out["device_idle_share_unprofiled"] = 1 - out["device_busy_ms_per_call"] / step_ms
    emit("train_profile", run=label, **out, top=top)
    return out


def train_bf16(cfg, dev, train, logdir):
    """3 warm-up and 10 timed bf16 steps, then their profile."""
    from mmfn_tpu_torch.train import Engine

    cfg16 = cfg.replace(compute_dtype="bfloat16")
    model = train_model(cfg16, dev)
    engine = Engine(model, cfg16, logdir)
    state = engine.initial_state()
    batches = cycle_batches(train, 13, SEED + 200)
    for b in batches[:3]:
        engine.train_step(state, b, SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = torch.stack([engine.train_step(state, b, SEED) for b in batches[3:]]).tolist()
    seconds = time.perf_counter() - t0
    out = {"samples_per_s": TRAIN_BATCH * len(losses) / seconds,
           "step_ms_mean": seconds * 1e3 / len(losses),
           "peak_bytes": torch.cuda.max_memory_allocated(), "losses": losses}
    emit("train_bf16", **out)
    require(all(np.isfinite(losses)), f"finite bf16 losses {losses}")
    stay_f32(model, "bf16 training")
    require(all(s.dtype == torch.float32 for group in state.optimizer.state.values()
                for s in group.values() if s.dim()), "bf16 training: AdamW moments stay f32")
    profile_training("bf16", engine, state, train, out["step_ms_mean"])
    return out


def train_remat(cfg, dev, train):
    """One f32 step with remat against a plain one, from the same weights,
    batch and seed: a double BN update would show in the running stats."""
    from mmfn_tpu_torch.train import create_train_state, make_train_step

    batch = cycle_batches(train, 1, SEED + 300)[0]
    runs = {}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        model = train_model(c, dev)
        state = create_train_state(model, c)
        step = make_train_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = float(step(state, batch, SEED))
        runs[remat] = (loss, running_stats(model), torch.cuda.max_memory_allocated())
        del model, state, step
        torch.cuda.empty_cache()
    (loss_p, stats_p, peak_p), (loss_r, stats_r, peak_r) = runs[False], runs[True]
    stats_err = max(rel_err(stats_r[k], stats_p[k]) for k in stats_p)
    out = {"loss_plain": loss_p, "loss_remat": loss_r, "stats_max_rel_err": stats_err,
           "peak_bytes_plain": peak_p, "peak_bytes_remat": peak_r}
    emit("train_remat", **out)
    require(abs(loss_r - loss_p) <= TRAIN_RTOL * abs(loss_p), f"remat loss: {out}")
    require(stats_err <= TRAIN_RTOL, f"remat BN statistics: {out}")
    require(all(int(v) == 1 for k, v in stats_r.items() if k.endswith("num_batches_tracked")),
            "remat: each BN counted one update")
    return out


def train_gpu_vs_cpu(dev):
    """One step of the port on the card and one on the CPU from the same
    weights and batch: n_layer 1, 64 px, batch 4, dropouts 0. In f32 the
    losses agree within TRAIN_RTOL. The gradients are held to each other in
    float64, every tensor within GRAD_F64_BOUND in the relative L2 norm
    (floored at 1e-6 of the largest gradient element): this randomised
    network amplifies f32 rounding to about 1e-2 in some tensors
    (tests/test_torch_train_parity.py), which would hide a wrong gradient,
    and float64 rounding to far below the bound. The f32 gradients' worst
    relative error is reported."""
    from mmfn_tpu_torch.config import GlobalConfig
    from mmfn_tpu_torch.data.synthetic import synthetic_batch
    from mmfn_tpu_torch.train import create_train_state, make_train_step

    cfg = GlobalConfig(n_layer=1, max_lanes=8, embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)

    def one_step(where, dtype):
        model = train_model(cfg, where).to(dtype)
        state = create_train_state(model, cfg)
        batch = synthetic_batch(4, cfg.max_lanes, seed=SEED, resolution=64, device=where)
        batch = batch._replace(**{f: v.to(dtype) for f, v in batch._asdict().items()
                                  if v is not None and v.is_floating_point()})
        loss = float(make_train_step()(state, batch, SEED))
        return loss, {k: p.grad.detach().cpu() for k, p in model.named_parameters()}

    def worst(got, want):
        floor = 1e-6 * max(float(g.abs().max()) for g in want.values())
        errors = {k: float((got[k].double() - g.double()).norm()) / max(float(g.norm()), floor)
                  for k, g in want.items()}
        key = max(errors, key=errors.get)
        return key, errors[key]

    cpu = torch.device("cpu")
    (loss_g, grads_g), (loss_c, grads_c) = (one_step(d, torch.float32) for d in (dev, cpu))
    (loss_g64, grads_g64), (loss_c64, grads_c64) = (one_step(d, torch.float64)
                                                    for d in (dev, cpu))
    f32_key, f32_err = worst(grads_g, grads_c)
    f64_key, f64_err = worst(grads_g64, grads_c64)
    out = {"loss_gpu": loss_g, "loss_cpu": loss_c, "loss_gpu_f64": loss_g64,
           "loss_cpu_f64": loss_c64, "grad_f64_max_rel_l2": f64_err, "grad_f64_worst": f64_key,
           "grad_f32_max_rel_l2": f32_err, "grad_f32_worst": f32_key, "tensors": len(grads_c)}
    emit("train_gpu_vs_cpu", **out)
    require(abs(loss_g - loss_c) <= TRAIN_RTOL * abs(loss_c), f"GPU against CPU loss: {out}")
    require(grads_g64.keys() == grads_c64.keys() and f64_err <= GRAD_F64_BOUND,
            f"GPU against CPU float64 gradients: {out}")
    return out


def train_resume(cfg, dev, train, val, tmp):
    """2 steps, save, resume into a fresh Engine and model, 1 step; against 3
    uninterrupted steps, each run validating after steps 2 and 3. The
    resumed AdamW state (exp_avg, exp_avg_sq and step of every parameter)
    must equal the saved one exactly. The train losses are held at rtol
    1e-4, the validation losses at 1e-2, a sanity check: the
    eval-mode loss of a net 2 steps from its initialisation (3.7, against
    0.85 in training; its BN running statistics have moved twice) amplifies
    the card's run-to-run differences (atomics in backward kernels such as
    the bilinear upsampling's) to 1e-4 - 2e-3 between two runs of the same
    3 steps, measured with cuDNN's deterministic algorithms on and off."""
    from mmfn_tpu_torch.train import Engine

    batches = cycle_batches(train, 3, SEED + 400)
    val_batch = list(val.batches(TRAIN_BATCH))[:1]

    def epoch(engine, state, part):
        engine.train(state, part, SEED)
        engine.validate(state, val_batch)
        engine.save(state)
        return state

    straight = Engine(train_model(cfg, dev), cfg, os.path.join(tmp, "straight"))
    epoch(straight, epoch(straight, straight.initial_state(), batches[:2]), batches[2:])
    first = Engine(train_model(cfg, dev), cfg, os.path.join(tmp, "split"))
    saved = epoch(first, first.initial_state(), batches[:2]).optimizer.state_dict()
    saved = {i: {k: v.detach().cpu().clone() for k, v in s.items()}
             for i, s in saved["state"].items()}
    del first
    torch.cuda.empty_cache()
    second = Engine(train_model(cfg, dev, seed=SEED + 1), cfg, os.path.join(tmp, "split"))
    resumed = second.resume(second.initial_state())
    require(resumed is not None and resumed.step == 2, "resumed at step 2")
    restored = resumed.optimizer.state_dict()["state"]
    require(restored.keys() == saved.keys() and all(
        s.keys() == restored[i].keys() and all(torch.equal(v, restored[i][k].cpu())
                                               for k, v in s.items())
        for i, s in saved.items()), "resume restores the AdamW state exactly")
    del saved, restored
    epoch(second, resumed, batches[2:])
    logs = []
    for d in ("straight", "split"):
        with open(os.path.join(tmp, d, "recent.log")) as f:
            logs.append(json.load(f))
    out = {"cur_iter": [straight.cur_iter, second.cur_iter],
           "train_loss": [logs[0]["train_loss"], logs[1]["train_loss"]],
           "val_loss": [logs[0]["val_loss"], logs[1]["val_loss"]]}
    emit("train_resume", **out)
    require(straight.cur_iter == second.cur_iter == 3, f"cur_iter: {out}")
    require(logs[0].keys() == logs[1].keys() and all(
        logs[0][k] == logs[1][k] for k in ("epoch", "iter", "bestval_epoch")), f"recent.log: {logs}")
    for k, rtol in (("train_loss", TRAIN_RTOL), ("val_loss", 1e-2)):
        require(len(logs[0][k]) == len(logs[1][k]) == 2 and all(
            abs(a - b) <= rtol * abs(a) for a, b in zip(logs[0][k], logs[1][k])),
            f"recent.log {k}: {out}")
    return out


BASELINE_TRAIN_STEPS = 4          # the first a warm-up, the other 3 timed


def train_baseline(name, cfg, dev, ops, train, val):
    """A few f32 steps of one baseline at batch 24 from the GPU data cache
    (CILRS on its control loss, the others on the L1 waypoint loss); finite
    losses, every parameter moved. TransFuser then validates through the
    fused attention kernel against the plain attention."""
    from mmfn_tpu_torch.models import build_baseline
    from mmfn_tpu_torch.models.gpt import SelfAttention
    from mmfn_tpu_torch.train import Engine

    with tempfile.TemporaryDirectory() as logdir:
        model = build_baseline(name, cfg, torch.Generator().manual_seed(SEED), device=dev)
        start = {k: p.detach().clone() for k, p in model.named_parameters()}
        engine = Engine(model, cfg, logdir)
        state = engine.initial_state()
        batches = cycle_batches(train, BASELINE_TRAIN_STEPS, SEED + 500)
        ops.reset_launch_counts()
        losses = [engine.train_step(state, batches[0], SEED)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [engine.train_step(state, b, SEED) for b in batches[1:]]
        losses = torch.stack(losses).tolist()
        seconds = time.perf_counter() - t0
        train_launches = {k: kernel.launches for k, kernel in ops.KERNELS.items()}
        require(all(np.isfinite(losses)), f"{name}: finite losses {losses}")
        require(not any(train_launches.values()), f"{name}: the train step runs no fused "
                f"kernel: {train_launches}")
        stay_f32(model, f"{name} training")
        unmoved = [k for k, p in model.named_parameters() if torch.equal(p, start[k])]
        # softmax ignores the key bias, so its gradient is zero up to rounding
        require(all(k.endswith("attn.key.bias") for k in unmoved), f"{name}: unmoved {unmoved}")
        out = {"model": name, "batch": TRAIN_BATCH, "losses": losses,
               "samples_per_s": TRAIN_BATCH * (len(batches) - 1) / seconds,
               "step_ms_mean": seconds * 1e3 / (len(batches) - 1),
               "unmoved_parameters": unmoved}
        if name == "transfuser":
            val_batches = list(val.batches(TRAIN_BATCH))
            ops.reset_launch_counts()
            val_loss = engine.validate(state, val_batches)
            val_launches = {k: kernel.launches for k, kernel in ops.KERNELS.items()}
            attn = [m for m in model.modules() if isinstance(m, SelfAttention)]
            for m in attn:
                m.attn_impl = "xla"
            val_plain = engine.validate(state, val_batches)
            require(val_launches == {"fused_attention": 4 * cfg.n_layer * len(val_batches),
                                     "bev_hist": 0}, f"{name}: validation launches {val_launches}")
            require(np.isfinite(val_loss) and abs(val_loss - val_plain) <= TRAIN_RTOL * abs(val_plain),
                    f"{name}: validation loss {val_loss} with the kernel, {val_plain} plain")
            out.update(val_loss=val_loss, val_loss_plain=val_plain, val_launches=val_launches,
                       val_forwards=len(val_batches))
    emit("baseline_train", **out)
    return out


def run_training(cfg, dev, ops):
    """The training phase: full-width MMFN-rad at batch 24 from the GPU
    data cache, in f32 and bf16, with validation through the fused attention
    kernel, then the remat, GPU-against-CPU and save/resume checks."""
    with tempfile.TemporaryDirectory() as tmp:
        train, val = train_data(cfg, dev)
        engine, state, f32 = train_f32(cfg, dev, ops, train, val, os.path.join(tmp, "f32"))
        prof = profile_training("f32", engine, state, train, f32["step_ms_median"])
        del engine, state
        torch.cuda.empty_cache()
        bf16 = train_bf16(cfg, dev, train, os.path.join(tmp, "bf16"))
        torch.cuda.empty_cache()
        remat = train_remat(cfg, dev, train)
        train_gpu_vs_cpu(dev)
        train_resume(cfg, dev, train, val, tmp)
        torch.cuda.empty_cache()
        baselines = {}
        for name in BASELINES:
            baselines[name] = train_baseline(name, cfg, dev, ops, train, val)
            torch.cuda.empty_cache()
    summary = {"batch": TRAIN_BATCH, "f32_samples_per_s": f32["samples_per_s"],
               "bf16_samples_per_s": bf16["samples_per_s"],
               "f32_step_ms_median": f32["step_ms_median"],
               "f32_peak_bytes": f32["peak_bytes"], "bf16_peak_bytes": bf16["peak_bytes"],
               "one_step_peak_bytes": {"plain": remat["peak_bytes_plain"],
                                       "remat": remat["peak_bytes_remat"]},
               "device_idle_share": prof["device_idle_share"],
               "device_idle_share_unprofiled": prof["device_idle_share_unprofiled"],
               "device_busy_ms_per_step": prof["device_busy_ms_per_call"],
               "device_ops_per_step": prof["device_ops_per_call"],
               "val_attention_launches_per_forward":
                   f32["val_launches"]["fused_attention"] / f32["val_forwards"],
               "baseline_f32_samples_per_s": {k: b["samples_per_s"] for k, b in baselines.items()},
               "transfuser_val_attention_launches_per_forward":
                   baselines["transfuser"]["val_launches"]["fused_attention"]
                   / baselines["transfuser"]["val_forwards"]}
    emit("train_summary", **summary)
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one NVIDIA GPU", file=sys.stderr)
        return 2
    from mmfn_tpu_torch import ops
    from mmfn_tpu_torch.config import GlobalConfig
    from mmfn_tpu_torch.ops import _cuda, attention, lidar

    laps = Laps()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = gpu_name_and_power_limit()
    emit("setup", gpu=gpu, torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)),
         tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
               "cudnn": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    report = _cuda.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         sources={name: {"seconds": r["seconds"],
                         "ptxas": [line.strip() for line in r["log"].splitlines()
                                   if "registers" in line or "spill" in line]}
                  for name, r in report.items()})

    laps("build")

    rng = np.random.default_rng(SEED)
    bev_err = check_bev(lidar, rng, dev)
    attn_err = check_attention(attention, dev)
    laps("kernel_checks")
    cfg = GlobalConfig(attn_impl="pallas")
    pipe, payloads, launches = serve(cfg, dev, ops, rng)
    serving = time_serving(pipe, payloads)
    prof = profile_serving(pipe, payloads)
    del pipe
    laps("serve")
    baselines = serve_baselines(cfg, dev, ops, rng, gpu)
    laps("baselines")
    rows = time_kernels(lidar, attention, dev, rng)
    laps("kernel_times")
    map_tool()
    laps("map_tool")
    loop = closed_loop(cfg, ops, gpu)
    laps("closed_loop")
    run_training(cfg, dev, ops)
    laps("training")

    # the launches of the served paths: MMFN-rad's requests, the baselines'
    # ticks and the closed loop's four phase0 runs
    for b in baselines.values():
        for name, n in b["launches"].items():
            launches[name] += n
    for name, n in loop["launches"].items():
        launches[name] += n

    def per_forward_ms(b, shapes):
        """Kernel 2's times summed over one forward: n_layer launches a stage."""
        return {key: cfg.n_layer * sum(rows[f"attention_b{b}_t{t}_d{d}"][key] for t, d in shapes)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_f32_ms")}

    # one batch-1 forward: one BEV launch, 8 attention launches per stage shape
    per_forward = [rows[f"attention_b1_t{t}_d{d}"] for t, d in STAGE_SHAPES]
    attn_total = per_forward_ms(1, STAGE_SHAPES)
    bev = rows["bev_serving"]
    kernels = [
        {"name": "bev_hist", "route": "cuda", "source": "mmfn_tpu_torch/csrc/bev_hist.cu",
         "replaces": "mmfn_tpu/ops/lidar.py:113", "launches": launches["bev_hist"],
         "max_abs_err": bev_err, "ms": bev["ms"], "plain_ms": bev["plain_ms"],
         "bound_ms": bev["bound_ms"], "bound_by": bev["bound_by"], "library_ms": None},
        {"name": "fused_attention", "route": "cuda", "source": "mmfn_tpu_torch/csrc/attention.cu",
         "replaces": "mmfn_tpu/ops/attention.py:34", "launches": launches["fused_attention"],
         "max_abs_err": attn_err, "ms": attn_total["ms"], "plain_ms": attn_total["plain_ms"],
         "bound_ms": attn_total["bound_ms"],
         "bound_by": max(per_forward, key=lambda r: r["bound_ms"])["bound_by"],
         "library_ms": attn_total["library_ms"]},
    ]
    b8_forward = per_forward_ms(8, STAGE_SHAPES)["ms"]
    emit("summary", per_batch1_forward=True, **serving,
         device_ops_per_forward=prof["batch1"]["device_ops_per_call"],
         attention_ms_per_forward={"batch1": attn_total["ms"], "batch8": b8_forward},
         attention_bound_f32_ms_per_forward=attn_total["bound_f32_ms"],
         launches_served_paths=launches)
    emit("baseline_summary", gpu=gpu,
         tick_ms_median={k: b["tick_ms_median"] for k, b in baselines.items()},
         device_ops_per_forward={k: b["device_ops_per_forward"] for k, b in baselines.items()},
         transfuser_attention_per_forward=per_forward_ms(1, TRANSFUSER_SHAPES),
         transfuser_bev_ms=rows["bev_transfuser"]["ms"])
    emit("timing", gpu=gpu, seconds=laps.seconds, total_seconds=laps.total())
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
