#!/usr/bin/env python3
"""GPU smoke run of mmfn_tpu_torch: builds, checks, serves and times the port.

Run from the root of the repository, on a machine with one NVIDIA Hopper GPU
(sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. build both CUDA kernels from mmfn_tpu_torch/csrc (nvcc, in parallel);
  2. BEV histogram kernel == its plain PyTorch version, exactly, at
     1 x 65,536 f16 (serving) and 8 x 65,536 f32 (bench) points, on bin
     edges, on clouds with no valid rows and at N not a multiple of 256;
  3. fused attention kernel vs its plain PyTorch version at every main-path
     shape (T in {192, 256}, D in {16, 32, 64, 128}, B in {1, 8}, H = 4),
     within rtol/atol 1e-5;
  4. serve full-width MMFN-rad (GlobalConfig defaults: n_layer 8, 256 px,
     64 lanes, 2 x 32,768 points per tick, attn_impl "pallas"; weights from a
     seeded generator) through TorchPipeline: 3 batch-1 requests and one
     fleet of 8, with the launch counters set to 0 just before and read just
     after. Waypoints must be finite, (4, 2) and (8, 4, 2), with 32 attention
     launches and 1 BEV launch per forward, and must agree with the same
     weights served with the plain attention on the GPU and with the plain
     versions of everything on the CPU;
  5. time batch-1 request latency and batch-8 frames/s, profile both
     (torch.profiler: device busy time, idle share, top kernels), and time
     each kernel at its main-path shapes (CUDA events, after warm-up) beside
     its plain version, SDPA for attention, and its bound on the H100.

Output: JSON lines per phase, then a ``kernels`` line, the GPU's name and
power limit as nvidia-smi gives them, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
TF32 is off for matmuls and cuDNN convolutions throughout.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the f32
# rate of the CUDA cores (no tensor cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
SEED = 0
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)      # f32 sums in another order
WAYPOINT_TOL = dict(rtol=1e-4, atol=2e-3)   # kernels vs plain, same GPU
CPU_TOL = dict(rtol=1e-3, atol=1e-2)        # GPU vs CPU convolution algorithms
STAGE_SHAPES = ((192, 16), (192, 32), (192, 64), (256, 128))   # (T, D) by fusion stage


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok: bool, what: str) -> None:
    """A failed check ends the run (an ``assert`` would vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


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


def bound(nbytes: float, ops: float) -> dict:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
    }
    err = 0.0
    for name, pts in cases.items():
        x = torch.from_numpy(pts).to(dev)
        got = lidar.bev_histogram(x)
        want = lidar.bev_histogram_plain(x)
        torch.cuda.synchronize()
        require(got.shape == want.shape == (pts.shape[0], 256, 256, 2), f"BEV shape on {name}")
        diff = float((got - want).abs().max())
        occupied = int((got > 0).sum())
        emit("bev_check", case=name, max_abs_err=diff, occupied_cells=occupied)
        require(diff == 0.0, f"BEV kernel == plain version on {name}")
        require(name.startswith("no_valid") or occupied > 0, f"occupied cells on {name}")
        err = max(err, diff)
    return err


def check_attention(attention, dev):
    g = torch.Generator(device=dev).manual_seed(SEED)
    err = 0.0
    for b in (1, 8):
        for t in (192, 256):
            for d in (16, 32, 64, 128):
                q, k, v = (torch.randn(b, 4, t, d, generator=g, device=dev) for _ in range(3))
                got = attention.fused_attention(q, k, v)
                want = attention.attention_plain(q, k, v)
                torch.cuda.synchronize()
                diff = float((got - want).abs().max())
                emit("attention_check", shape=[b, 4, t, d], max_abs_err=diff)
                torch.testing.assert_close(got, want, **ATTN_TOL)
                err = max(err, diff)
    return err


def serve(cfg, dev, ops, rng):
    from mmfn_tpu_torch.harness.agents import TorchPipeline
    from mmfn_tpu_torch.models import build_model
    from mmfn_tpu_torch.models.gpt import SelfAttention

    t0 = time.perf_counter()
    model = build_model(cfg, "rad", torch.Generator().manual_seed(SEED))
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
    require(launches["bev_hist"] >= forwards, f"a BEV launch a forward: {launches}")
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
    cpu_pipe = TorchPipeline(build_model(cfg, "rad", torch.Generator().manual_seed(SEED)),
                             cfg, device="cpu")
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
    for name, b, dtype in (("serving", 1, torch.float16), ("bench", 8, torch.float32)):
        pts = torch.from_numpy(np.stack([padded(lidar_sweep(rng, 60000), 65536)
                                         for _ in range(b)])).to(dev, dtype)
        nbytes = pts.numel() * pts.element_size() + b * 256 * 256 * 2 * 4
        ops = 12 * b * 65536 + 2 * b * 256 * 256 * 2
        rows[f"bev_{name}"] = {"shape": list(pts.shape), "dtype": str(dtype),
                               "ms": cuda_ms(lambda: lidar.bev_histogram(pts)),
                               "plain_ms": cuda_ms(lambda: lidar.bev_histogram_plain(pts)),
                               "library_ms": None, **bound(nbytes, ops)}
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    for b in (1, 8):
        for t, d in STAGE_SHAPES:
            q, k, v = (torch.randn(b, 4, t, d, generator=g, device=dev) for _ in range(3))
            nbytes, ops = 4 * q.numel() * 4, 4 * b * 4 * t * t * d
            rows[f"attention_b{b}_t{t}_d{d}"] = {
                "shape": [b, 4, t, d],
                "ms": cuda_ms(lambda: attention.fused_attention(q, k, v)),
                "plain_ms": cuda_ms(lambda: attention.attention_plain(q, k, v)),
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                **bound(nbytes, ops)}
    for key, row in rows.items():
        emit("kernel_time", name=key, **row)
    return rows


def profile_serving(pipe, payloads, reps: int = 10):
    """Where a request's time goes: torch.profiler over ``reps`` batch-1
    requests and ``reps`` fleets of 8. Device busy time is the sum of the
    kernels' and copies' device time (one stream, so they do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for label, fn in (("batch1", lambda: pipe(*call_args(payloads[0]))),
                      ("batch8", lambda: pipe.dispatch_fleet(payloads).cpu())):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in dev) / 1e3 / reps
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:12]
        emit("profile", run=label, wall_ms_per_call=wall_ms, device_busy_ms_per_call=busy_ms,
             device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
             device_ops_per_call=sum(e.count for e in dev) / reps,
             top=[{"name": e.key[:100], "calls_per_call": e.count / reps,
                   "ms_per_call": e.self_device_time_total / 1e3 / reps} for e in top])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one NVIDIA GPU", file=sys.stderr)
        return 2
    from mmfn_tpu_torch import ops
    from mmfn_tpu_torch.config import GlobalConfig
    from mmfn_tpu_torch.ops import _cuda, attention, lidar

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

    rng = np.random.default_rng(SEED)
    bev_err = check_bev(lidar, rng, dev)
    attn_err = check_attention(attention, dev)
    cfg = GlobalConfig(attn_impl="pallas")
    pipe, payloads, launches = serve(cfg, dev, ops, rng)
    serving = time_serving(pipe, payloads)
    profile_serving(pipe, payloads)
    rows = time_kernels(lidar, attention, dev, rng)

    # one batch-1 forward: one BEV launch, 8 attention launches per stage shape
    per_forward = [rows[f"attention_b1_t{t}_d{d}"] for t, d in STAGE_SHAPES]
    attn_total = {key: cfg.n_layer * sum(r[key] for r in per_forward)
                  for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
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
    emit("summary", per_batch1_forward=True, **serving)
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
