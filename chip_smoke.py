#!/usr/bin/env python3
"""GPU smoke run of mmfn_tpu_torch: builds, checks, serves and times the port.

Run from the root of the repository, on a machine with one NVIDIA Hopper GPU
(sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. build both CUDA kernels from mmfn_tpu_torch/csrc (nvcc, in parallel);
  2. BEV histogram kernel == its plain PyTorch version, exactly, with
     clusters of 8 and of 16 blocks per cloud, at 1 x 65,536 f16 (serving),
     8 x 65,536 f32 (bench), 8 x 65,536 f16 and 128 x 65,536 f32 (the
     bench's device-side ceiling) points, on bin edges, on
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
     seeded generator) through TorchPipeline, which replays CUDA graphs
     after each key's first call (its warm-up): 3 batch-1 requests and one
     fleet of 8, with the launch counters set to 0 just before and read just
     after. Waypoints must be finite, (4, 2) and (8, 4, 2), with 32 attention
     launches and 1 BEV launch per forward, and must agree with the same
     weights served with the plain attention on the GPU and with the plain
     versions of everything on the CPU;
  5. time batch-1 request latency and batch-8 frames/s, and profile both
     (torch.profiler: device busy time, idle share, top kernels);
  5b. the graphs (``serve_graphs``): replies at batch 1 and for the fleet
     of 8 against the same model run eagerly (``cuda_graphs=False``) within
     rtol 1e-4 / atol 2e-3 (expected equal), 1 BEV and 32 attention launches
     counted for one replay, one capture anew under TF32 and one under the
     plain attention, each reply within that limit of the eager one under
     the same state and different from the f32 kernels' reply, as the eager
     one is; the p50 and p90 of 200 requests each, eager and graph in turns
     of 25; the graph pool's bytes and the card's name and power limit;
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
     wrapper picks it, also at TransFuser's 1 x 65,536 f32 and the bench's
     128 x 65,536 f32) beside its plain version, SDPA for attention, and its
     bounds on the H100;
  8. the scored closed loop through the port's phase0 CLI
     (``mmfn_tpu_torch.harness.phase0.main``, in process) on the cross town
     (data/maps/fake_town_cross.xodr, its scenario triggers and traffic
     lights, the birdview camera drawn without cv2), serving full-width
     MMFN-rad (attn_impl "pallas", host_bev off, random weights from seed 0):
     one agent on route 0 of data/routes/benchmark_cross.xml for 70 ticks,
     synchronous and with ``agent.async_dispatch``, then ``repetitions=2
     fleet=8`` (8 routes in one fleet) for 30 ticks, lockstep and
     pipelined. The map tool (native/build/rough_map_node) is built first by
     scripts/build_native.sh when missing; a failed build fails the run.
     Launch counters set to 0 just before and read just after each run;
     every route runs to the tick cap, with a forward on every tick after
     the two warm-up ticks (98 a single agent; 38 batched forwards a fleet,
     each steering all 8 agents); every forward tick of the single agent and
     every batched forward of the fleet: 1 BEV and 32 attention launches;
     every route record: a status, no agent crash and a finite driving
     score; the first forward
     tick's waypoints against the same tick under the plain attention on
     the GPU and under the plain versions on the CPU. Printed: tick ms
     (host clock around ``MMFNAgent.run_step``, median and p90), device ops,
     busy ms and idle share per forward tick (profiled over 5 ticks), world
     and birdview ms per vehicle-tick, fleet vehicle-ticks/s, the records;
  9. the rest of the harness, on eval.yaml's straight road: each of the
     seven data/scenarios/*.xosc through the port's phase0 CLI with the
     expert, each in its own process and all at once (no vehicle collision,
     a route score above 50); full-width MMFN-rad (attn_impl "pallas",
     random weights from seed 0) driving cut_in_with_controller.xosc
     through the phase0 CLI in process with ``record`` and 70 ticks (no
     agent crash, 98 forward ticks of 1 BEV and 32 attention launches, a
     recording of 70 frames; tick ms, device ops and busy ms per forward
     tick, the storyboard's and the recorder's host ms a tick); the metrics
     CLI (``python -m mmfn_tpu_torch.harness.metrics_run``, its own process)
     with each of the four metric copies over that recording (exit 0, each
     output file); ``scenario_run --scenario CutInFromLeftLane --agent
     e2e --junit`` in process (full-width MMFN-vec, plain attention, a 20 s
     wall budget: one testcase with a finite score, 1 BEV launch a forward
     tick); the phase0 CLI with ``agent.type=remote``, the port's stack in
     its own process and stepping, 70 ticks (every tick after the first
     acknowledged by its seq, the stack's exit code 0; the round trip ms a
     tick and the stack's start);
  10. the device world (``harness/device_world.py``) on the cross town, with
     random weights from seed 0: 128 compact payloads (poses along the four
     routes, actors and traffic lights around each). Kernel 1 on the
     synthesized 128 x 3,340 f32 clouds == its plain version exactly, with
     clusters of 8 and 16, and timed; kernel 2 at B = 128 (T in {192, 256},
     every D, both layouts) within rtol/atol 1e-5, and timed. Full-width
     MMFN-rad through ``DeviceWorldPipeline`` at width 128 and full-width
     MMFN-img (the birdview raster drawn on the card) at width 8: one
     batched forward with the counters set to 0 just before and read just
     after, 1 BEV and 32 attention launches; finite (N, 4, 2) waypoints,
     within rtol 1e-4 / atol 2e-3 of the plain attention and plain BEV on
     the card; the first 4 (img: 2) vehicles through a CPU pipeline of the
     same weights: every synthesized sensor equal (the BEV and lane counts
     exactly, the rest within 1e-5), waypoints within rtol 1e-3 / atol
     1e-2; chunked synthesis (32 vehicles) equal to monolithic; the fleet's
     zero payloads finite; a profile (device busy, ops, idle share, the
     synthesis' share of busy) and the peak memory. Then phase 8 again with
     ``agent.device_world=true`` (compact world frames; one warm-up tick;
     60 and 30 ticks),
     and 128 ``MMFNAgent(device_world=True)`` on one pipeline in
     ``FleetRunner`` on a straight road, pipelined and lockstep, 4 warm-up
     and 20 timed ticks: every route to its cap, one batched forward of 1
     BEV and 32 attention launches a tick steering all 128, no crash;
     vehicle-ticks/s, world and agent host ms per fleet tick;
  11. the data path, through the port's own CLIs (phase1 in its own
     process, as a user runs it; the others in process): the expert
     collects on the cross town with phase0 (``collect.yaml``;
     cross_train_3.xml, 2 repetitions with collect offsets,
     background_traffic=10, WetNoon, PNG frames, 160 ticks a route; then the
     held-out cross_straight_sn.xml with the simple pilot,
     ``agent.type=auto``, 310 ticks), phase1 preprocesses with 4 workers,
     phase2 trains full-width MMFN-rad at batch 24 in f32 for 2 epochs with
     validation through kernel 2, and phase0 serves its best_model.pth on
     the held-out route for 70 ticks. Checks: every collection record has
     a status, no agent crash and a finite score; every frame directory of
     each route holds the frames its expert's steps imply; every frame of a
     route decodes and each PNG re-encodes to the same pixels; a pickle per
     sample in each pool, four equal to a serial decode in this process, no
     bad sample under check_data; finite losses and a best_model.pth; 32
     kernel-2 launches a validation forward and none in training; the final
     weights' validation loss through kernel 2 within rtol 1e-4 of the plain
     attention's; the served run loads the checkpoint, launches 1 BEV and
     32 attention kernels every forward tick, and its first waypoints agree
     with the plain attention (rtol 1e-4 / atol 2e-3). Printed: the
     expert's vehicle-ticks/s and ms a tick (world, expert, writer), frames
     written per second, phase1 samples/s serial and with 4 workers (the
     pool's seconds with and without the workers' start, which is timed
     apart: 4 fresh interpreters importing the CLI, without torch), phase2
     samples/s by epoch, the validation loss by epoch, the served tick
     median (``data_collect``, ``data_preprocess``, ``data_train``,
     ``data_serve`` and, after training, ``data_path_summary`` beside the
     synthetic-data f32 rate). The trained best_model.pth is kept as
     ``<root>/mmfn_rad/best_model.pth`` for:
  11b. the benchmark runner (``python -m mmfn_tpu_torch.harness.benchmark_run``'s
     ``main`` in process; each leg a phase0 process on the card): both
     towns, ClearNoon, agents rad (that checkpoint) and expert, 6 s of wall
     a route, ``--jobs 2``. Every row of TABLE.md has a driving score, the
     rad legs load the checkpoint; a second run prints "already complete"
     for every leg and launches no process; ``--aggregate-only`` rewrites
     TABLE.md byte for byte. Printed: the table, each leg's seconds, each
     process's peak card memory (nvidia-smi, polled each second);
  12. train full-width MMFN-rad (GlobalConfig defaults, dropouts 0.1) at batch
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
  13. train each baseline 4 f32 steps at batch 24 from the same data cache
     (CILRS on its control loss; finite losses, every parameter moved, the
     last 3 steps timed), then validate TransFuser on 2 batches through the
     fused attention (32 launches a forward, within rtol 1e-4 of the plain
     attention's loss);
  14. ``mmfn_tpu_torch.bench.main`` in process, full width, its iteration
     and tick counts cut (BENCH_CUTS): one JSON line with bench.py's keys,
     all non-null, ``pallas_ok`` true, ``device`` the H100; kernel 1 once
     a pipeline step (the launches of ``pallas_ok``'s check counted apart);
     the peak memory (the batch-96 bf16 step);
  15. ``mmfn_tpu_torch.bench_loop.main``: the soak (sync, pipelined, the
     per-array transport, which bins on the card) at 60 ticks, then
     ``--fleet 8 --pipelined`` at 40;
  16. ``torch.export`` of full-width MMFN-rad under "pallas", on the card and
     on the CPU, each saved and loaded and served on the card at batches 1
     and 8: 32 kernel-2 launches a forward, waypoints within rtol 1e-4 /
     atol 2e-3 of the eager forward, both timed; the host cost of one
     attention call through the custom operator and through the direct
     launch;
  17. introspection at full width: 32 attention maps of (2, 4, T, T) with
     rows summing to 1 within 1e-5 on the plain path, none under "pallas";
  18. phase2 with ``pretrained_resnet34/18`` pointing at locally made
     torchvision-keyed files, 2 steps of full-width MMFN-rad at batch 24:
     the grafted tensors equal the files', the LiDAR conv1 kept its init,
     training starts from the grafted weights;
  19. multi-process (``multi_process``): (a) the phase2 CLI under
     ``torch.distributed.run --nproc_per_node=1`` over NCCL with
     ``multi_host=true checkpoint_backend=orbax model.attn_impl=pallas``,
     full-width MMFN-rad at batch 24 for ``MP_EPOCHS`` epoch on the data
     path's pools (kept from phase 11), then resumed from the DCP directory
     for one more:
     kernel 2 in every validation forward, ms a step over each epoch beside
     phase 11's one-process run on the same pools (epochs of a few steps:
     no rate is compared); (b) two ranks on cuda:0 over gloo (NCCL refuses
     two ranks on one device), TF32 off:
     full-width MMFN-rad's DDP step at batch 24 (12 a rank) against the
     one-process step on the same batch (|loss diff| < 1e-4, parameters
     within 2.5 lr, BN running statistics within relative 1e-3, and each
     parameter's gradient, AdamW's exp_avg after the step, within relative
     L2 ``MP_GRAD_REL``: one AdamW step moves every element by about lr
     whatever its gradient, so only the gradient shows a missing
     all-reduce), then model_parallel 2: the eval forward through kernel 2
     at 2 heads a rank (within 1e-4 of the largest waypoint of the
     one-process forward) and one step at the same bounds; (c) sharded
     serving in process, two shards on cuda:0 on two streams:
     ``TorchPipeline`` at fleets of 8 and 7 and ``DeviceWorldPipeline`` at
     128 agents, each against the
     unsharded pipeline (rtol 1e-4 / atol 2e-3; one launch of kernel 1 and
     32 of kernel 2 a shard), the sharded and unsharded fleet ticks timed,
     and the phase0 CLI with ``agent.fleet_devices=1`` (one device, the
     plain path: it checks the CLI's plumbing only). The ranks are this
     script started again with ``--rank-task``; they report their own
     launch counts;
  20. the CARLA glue and the tools (``carla_tools``): the port's carla mock
     (``harness/fake_carla``) installed, the phase0 CLI with
     ``simulator=carla`` in process on the mock's straight test town, under
     the glue's 2 s per-tick watchdog: (a) the expert drives a 40 m route to
     "Completed" at 100; (b) full-width MMFN-rad (attn_impl "pallas",
     host_bev off, random weights from seed 0; the CLI builds the kernels
     with ``enable_persistent_cache`` and warms the pipeline before the loop)
     for 68 forward ticks, then 30 with ``agent.async_dispatch``, the route's
     game timeout cut to end there: launch counters set to 0 just before
     each run and read just after, 1 BEV and 32 attention launches every
     forward tick, every launch from the loop's thread while the glue's
     reader threads poll, no watchdog trip and no agent crash; the last
     tick's payload (the mock's 400-point sweeps padded to 2 x 32,768 rows)
     replayed through the kernels, the plain attention on the card (rtol
     1e-4 / atol 2e-3) and the plain versions on the CPU (rtol 1e-3 / atol
     1e-2); the ticks' wall times as the watchdog sees them (median,
     largest); then (c) ``python -m mmfn_tpu_torch.tools.record_episode``'s
     ``main`` with the e2e agent (full-width MMFN-vec, plain attention) on
     the cross town for 40 ticks: 1 BEV launch every forward tick, a GIF of
     10 frames of 256 x 256 at 200 ms that loops, read by walking its
     blocks; (d) ``viz_attention`` for full-width MMFN-rad (272 PNGs) and
     ``render_birdview_samples`` (3 panels) into a temporary directory,
     every PNG decoded by ``data/png.py``;
  21. the round-5 recipe cut to size (``scale_r05``, ``tools/scale_r05.py``):
     ``scale_r05.collect`` on the cross-town leg in ClearNoon with the
     recipe's overrides (scenarios, 10 background vehicles, offset
     repetitions of 3 routes) in one phase0 process as the recipe runs it,
     cut to ``R05_REPETITIONS`` repetitions of ``R05_TICKS`` ticks a route;
     it is host work, so it starts once the map tool is built (phase 7 on)
     and runs beside the card's phases, in a process group of its own that
     is stopped at exit; this phase waits for it, then runs phase 1 on that
     pool (its own process, the pool in both splits); then
     the recipe's ``mmfn_rad`` run (batch 96, ``remat=true``, bfloat16) for
     ``R05_EPOCHS`` epoch on the card through ``scale_r05.train``: the
     frames, phase 1's seconds and samples, the epoch's samples/s, the peak
     card memory and the loss (finite), and a ``best_model.pth``.

Output: JSON lines per phase (the summary has the device ops per batch-1
forward; ``baseline_summary`` the baselines' tick latency and device ops
per forward; ``closed_loop_summary`` the closed loop's numbers, host world and device
world; ``scenarios_summary`` the storyboard's, the metrics', the scenario
runner's and the remote agent's; ``device_world_summary`` the device world's;
``train_summary`` the training rates, peak memory, idle share and device
ops per step; ``bench``, ``bench_loop``, ``benchmark``, ``export`` and
``slice9_summary`` the bench's line and the rest of phases 11b-18;
``carla_tools_summary`` phase 20's tick times, watchdog margins and launches;
``timing`` the seconds of each phase), then a ``kernels`` line whose launches count the served
paths, MMFN-rad's requests, the baselines' ticks, the closed loop's four
phase0 runs, the storyboard and the scenario runner, the device world's
forwards, phase0 runs and fleets, the data path's validation and served
run, the bench, bench_loop, the exported artifacts, introspection, the
pretrained run, the multi-process phase (its ranks' own counts, and the
sharded pipelines'; not the benchmark runner's legs, which are processes of
their own) and phase 20's MMFN-rad runs through the glue and
record_episode, the GPU's name and power limit as nvidia-smi gives them, and
last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
TF32 is off for matmuls and cuDNN convolutions throughout.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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


@contextlib.contextmanager
def plain_attention(model):
    """``model``'s attention through the plain PyTorch version while the
    block lasts."""
    from mmfn_tpu_torch.models.gpt import SelfAttention

    attn = [m for m in model.modules() if isinstance(m, SelfAttention)]
    for m in attn:
        m.attn_impl = "xla"
    try:
        yield
    finally:
        for m in attn:
            m.attn_impl = "pallas"


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
        "device_side_128x65536_f32": rng.uniform(-30, 30, (128, 65536, 4)).astype(np.float32),
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
    with plain_attention(model):
        plain_gpu = pipe(*call_args(payloads[0]))
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


GRAPH_REQUESTS = 200              # timed batch-1 requests each, graph and eager


@contextlib.contextmanager
def tf32_on():
    """TF32 in cuBLAS and cuDNN while the block lasts."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def serve_graphs(cfg, dev, ops, pipe, payloads, gpu):
    """The served forward replayed from CUDA graphs (``pipe``, whose batch-1
    and fleet-of-8 graphs ``serve`` captured) against the same model run
    eagerly on the card (``cuda_graphs=False``): the replies at batch 1 and
    for the fleet of 8 (expected equal; required within WAYPOINT_TOL), the
    launches of one replay with the counters set to 0 just before and read
    just after (1 and 32), a capture anew under TF32 and under the plain
    attention (in a pipeline of their own: ``serve`` already captured the
    plain attention's graph in ``pipe``), each reply agreeing with the eager
    one under the same state and differing from the f32 kernels' reply as
    the eager one does, the
    host-clock latency of GRAPH_REQUESTS requests each, eager and graph in
    turns of 25 (graph, eager, eager, graph, ...), and the pool's bytes."""
    from mmfn_tpu_torch.harness.agents import TorchPipeline

    eager = TorchPipeline(pipe.model, cfg, device=dev, cuda_graphs=False)
    graphs = pipe.graphs[0]
    require(graphs is not None and eager.graphs == [None], "graphs on the card, eager on request")
    for p in payloads:                    # every key captured before anything is counted
        pipe(*call_args(p))
    pipe.dispatch_fleet(payloads).cpu()
    captures = graphs.captures

    def counted(fn):
        ops.reset_launch_counts()
        out = fn()
        return out, {name: k.launches for name, k in ops.KERNELS.items()}

    want = {"bev_hist": 1, "fused_attention": 4 * cfg.n_layer}
    total = {name: 0 for name in ops.KERNELS}
    diffs = []
    for p in payloads:
        got, launches = counted(lambda: pipe(*call_args(p)))
        require(launches == want, f"one batch-1 replay launches {want}: {launches}")
        diffs.append(float(np.abs(got - eager(*call_args(p))).max()))
        np.testing.assert_allclose(got, eager(*call_args(p)), **WAYPOINT_TOL)
        for k, v in launches.items():
            total[k] += v
    fleet, fleet_launches = counted(lambda: pipe.dispatch_fleet(payloads).cpu().numpy())
    require(fleet_launches == want, f"one fleet replay launches {want}: {fleet_launches}")
    for k, v in fleet_launches.items():
        total[k] += v
    eager_fleet = eager.dispatch_fleet(payloads).cpu().numpy()
    np.testing.assert_allclose(fleet, eager_fleet, **WAYPOINT_TOL)
    require(graphs.captures == captures, "the replies above were replays")

    # a pipeline of its own, so that each state's graph is new to it
    fresh = TorchPipeline(pipe.model, cfg, device=dev)
    counted_graphs = fresh.graphs[0]
    args = call_args(payloads[0])
    f32 = [fresh(*args) for _ in range(2)][-1]            # a capture, then a replay
    states = {}
    for name, state in (("tf32", tf32_on), ("plain_attention", lambda: plain_attention(pipe.model))):
        before = counted_graphs.captures
        with state():
            first = fresh(*args)          # the warm-up of a new graph
            replayed = fresh(*args)
            eager_reply = eager(*args)
        require(counted_graphs.captures == before + 1, f"{name}: one capture anew")
        require(float(np.abs(fresh(*args) - f32).max()) == 0.0
                and counted_graphs.captures == before + 1,
                f"{name}: back outside, the f32 kernels' graph replays")
        graph_diff = float(np.abs(replayed - f32).max())
        eager_diff = float(np.abs(eager_reply - eager(*args)).max())
        states[name] = {"graph_vs_eager": float(np.abs(replayed - eager_reply).max()),
                        "warmup_vs_replay": float(np.abs(first - replayed).max()),
                        "graph_vs_f32_kernels": graph_diff, "eager_vs_f32_kernels": eager_diff}
        np.testing.assert_allclose(replayed, eager_reply, **WAYPOINT_TOL)
        require(graph_diff > 0.0 and eager_diff > 0.0,
                f"{name}: the graph's reply differs from the f32 kernels' as the eager one does: "
                f"{states[name]}")
    del fresh

    lat = {"graph": [], "eager": []}
    for turn in range(2 * GRAPH_REQUESTS // 25):
        name = "graph" if turn % 4 in (0, 3) else "eager"
        served = pipe if name == "graph" else eager
        for i in range(25):
            a = call_args(payloads[(turn * 25 + i) % len(payloads)])
            t0 = time.perf_counter()
            served(*a)
            lat[name].append((time.perf_counter() - t0) * 1e3)
    timing = {}
    for name, ms in lat.items():
        ms.sort()
        timing[name] = {"requests": len(ms), "p50_ms": statistics.median(ms),
                        "p90_ms": ms[math.ceil(0.9 * len(ms)) - 1]}
    out = {"gpu": gpu, "max_abs_graph_vs_eager_batch1": max(diffs),
           "max_abs_graph_vs_eager_fleet8": float(np.abs(fleet - eager_fleet).max()),
           "equal_batch1": max(diffs) == 0.0,
           "equal_fleet8": bool(np.array_equal(fleet, eager_fleet)),
           "launches_per_replay": {"batch1": launches, "fleet8": fleet_launches},
           "states": states, "latency": timing, "graphs": len(graphs),
           "captures": graphs.captures, "pool_bytes": graphs.pool_bytes(),
           "launches": total}
    emit("serve_graphs", **out)
    del eager
    return out


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
                           ("fleet", 8, torch.float16), ("transfuser", 1, torch.float32),
                           ("device_side", 128, torch.float32)):
        if name == "device_side":       # the bench's inputs: uniform over +-30 m, all valid
            pts = torch.from_numpy(rng.uniform(-30, 30, (b, 65536, 4)).astype(np.float32)
                                   ).to(dev)
        else:
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
                               "plain_ms": cuda_ms(lambda: lidar.bev_histogram_plain(pts),
                                                   *((3, 1) if b > 8 else ())),
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
    with plain_attention(model):
        plain_gpu = flat(agent._forward(*args))
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

CLOSED_LOOP_TICKS = 70            # one route, one agent; sync, then async
FLEET, FLEET_TICKS = 8, 30        # 4 routes x 2 repetitions in one fleet
DW_CLOSED_LOOP_TICKS, DW_FLEET_TICKS = 60, 30    # the same with the device world
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


class Timed:
    """Host-clock ms of each call of some methods or module functions while
    the block lasts (``with Timed({label: (owner, name)}) as t:``, then
    ``t.ms[label]``); ``_wrap`` patches any other attribute for the block."""

    def __init__(self, targets):
        self.targets = targets
        self.ms = {label: [] for label in targets}
        self._saved = []

    def _wrap(self, owner, name, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def __enter__(self):
        for label, (owner, name) in self.targets.items():
            self._wrap(owner, name, lambda orig, store=self.ms[label]: _timed(orig, store))
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved = []
        return False


def _timed(orig, store):
    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        store.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapped


class ClosedLoopProbe(Timed):
    """Times and counts what one phase0 CLI or ``FleetRunner`` run does, by
    wrapping methods of the port's classes while the run lasts (``with
    probe:``): the host clock around each ``MMFNAgent.run_step`` and the
    kernel launches of each tick that dispatched a forward; the host clock
    at each ``dispatch_fleet`` and its kernel launches; ``prepare_step`` and
    the ``finish_step`` calls that returned a control; the world's
    ``sensor_frame`` and ``tick`` and the birdview's ``produce``; the first
    dispatch's pipeline, inputs and waypoints; ``FleetRunner.run``'s wall
    time; and a torch.profiler window over ``PROFILED_TICKS`` forward ticks
    of a single agent, whose ticks are left out of the latency figures. The
    pipeline is ``pipeline_cls`` (``TorchPipeline`` when None)."""

    def __init__(self, ops, pipeline_cls=None):
        from mmfn_tpu_torch.harness.agents import MMFNAgent
        from mmfn_tpu_torch.harness.replay import KinematicWorld
        from mmfn_tpu_torch.mapping.birdview import BirdViewProducer

        super().__init__({"prepare": (MMFNAgent, "prepare_step"),
                          "frame": (KinematicWorld, "sensor_frame"),
                          "tick": (KinematicWorld, "tick"),
                          "birdview": (BirdViewProducer, "produce")})
        self.ops = ops
        self.pipeline_cls = pipeline_cls      # TorchPipeline when None
        self.tick_ms, self.tick_launches, self.fleet_launches = [], [], []
        self.fleet_t = []                 # host clock at each dispatch_fleet
        self.finish_ms = []               # MMFNAgent.finish_step
        self.prep_ms, self.frame_ms, self.step_ms, self.birdview_ms = (
            self.ms[k] for k in ("prepare", "frame", "tick", "birdview"))
        self.dispatches = 0
        self.steered = 0                  # finish_step calls that returned
        self.fleet_seconds = 0.0
        self.first = None                 # (pipeline, args, waypoints)
        self.profile = None
        self._window = None               # [profiler, ms, ticks] while profiling

    def launches(self):
        return {name: k.launches for name, k in self.ops.KERNELS.items()}

    def _since(self, before):
        return {k: v - before[k] for k, v in self.launches().items()}

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        from mmfn_tpu_torch.harness.agents import MMFNAgent, TorchPipeline
        from mmfn_tpu_torch.harness.fleet import FleetRunner
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
                probe.fleet_t.append(time.perf_counter())
                before = probe.launches()
                out = orig(pipe, payloads)
                probe.fleet_launches.append(probe._since(before))
                return out
            return wrapped

        def finish_step(orig):
            def wrapped(agent, payload, waypoints):
                t0 = time.perf_counter()
                control = orig(agent, payload, waypoints)
                probe.finish_ms.append((time.perf_counter() - t0) * 1e3)
                probe.steered += 1
                return control
            return wrapped

        def fleet_run(orig):
            def wrapped(runner, agents, routes):
                t0 = time.perf_counter()
                out = orig(runner, agents, routes)
                probe.fleet_seconds += time.perf_counter() - t0
                return out
            return wrapped

        pipeline_cls = self.pipeline_cls or TorchPipeline
        self._wrap(MMFNAgent, "run_step", run_step)
        self._wrap(MMFNAgent, "finish_step", finish_step)
        self._wrap(pipeline_cls, "dispatch", dispatch)
        self._wrap(pipeline_cls, "dispatch_fleet", dispatch_fleet)
        self._wrap(FleetRunner, "run", fleet_run)
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self._window is not None:
            self._window[0].__exit__(None, None, None)
            self._window = None
        return False

    @property
    def vehicle_ticks(self) -> int:
        return len(self.step_ms)


def run_phase0(phase0, ops, name, extra, tmp, pipeline_cls=None, base=None):
    """One in-process run of the port's phase0 CLI (``base``: CLI_ARGS when
    None, then ``extra``) under a probe, with the launch counters set to 0
    just before and read just after."""
    checkpoint = os.path.join(tmp, f"{name}.json")
    probe = ClosedLoopProbe(ops, pipeline_cls)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with probe:
        require(phase0.main((CLI_ARGS if base is None else base)
                            + ["checkpoint=" + checkpoint] + extra) == 0,
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


def closed_loop(cfg, ops, gpu, device_world=False):
    """The port's phase0 CLI over the cross town, full-width MMFN-rad
    (GlobalConfig defaults, attn_impl "pallas", random weights from seed 0,
    host_bev off): one agent on route 0 of data/routes/benchmark_cross.xml
    for CLOSED_LOOP_TICKS ticks, sync and async_dispatch, then a fleet of 8
    (the file's 4 routes, 2 repetitions) for FLEET_TICKS ticks, lockstep and
    pipelined (DW_CLOSED_LOOP_TICKS and DW_FLEET_TICKS with the device
    world). Every record needs a status, no agent crash and a finite
    score; every route runs to the tick cap with a forward on every tick after
    the warm-up ticks, and every fleet agent steers from each batched
    forward; every forward tick of the single agent, and every batched
    forward of the fleet, 1 BEV and 4 * n_layer attention launches. With
    ``device_world`` the agents serve through ``DeviceWorldPipeline`` in
    compact world frames (``agent.device_world=true``; one warm-up tick, the
    map bootstrap); without it the host world ticks (two warm-up ticks, the
    second filling the sweep buffer), and the first forward tick's waypoints
    must agree with the plain attention on the GPU and with the plain
    versions on the CPU."""
    from mmfn_tpu_torch.harness import phase0
    from mmfn_tpu_torch.harness.agents import TorchPipeline
    from mmfn_tpu_torch.harness.device_world import DeviceWorldPipeline

    want = {"bev_hist": 1, "fused_attention": 4 * cfg.n_layer}
    out, total = {}, {name: 0 for name in ops.KERNELS}
    world = ["agent.device_world=true"] if device_world else []
    pipeline_cls = DeviceWorldPipeline if device_world else TorchPipeline
    warmup = 1 if device_world else 2
    cap, fleet_cap = ((DW_CLOSED_LOOP_TICKS, DW_FLEET_TICKS) if device_world
                      else (CLOSED_LOOP_TICKS, FLEET_TICKS))
    with tempfile.TemporaryDirectory() as tmp:
        route0 = first_route_file(tmp)
        for name, extra in (("sync", []), ("async", ["agent.async_dispatch=true"])):
            probe, row = run_phase0(phase0, ops, name, [
                "routes=" + route0, f"max_ticks={cap}"] + world + extra, tmp, pipeline_cls)
            # every tick after the warm-up ticks drives a forward, up to the cap
            require(probe.vehicle_ticks == cap and len(probe.tick_launches) == cap - warmup,
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
            if name == "sync" and not device_world:
                pipe, args, waypoints = probe.first
                with plain_attention(pipe.model):
                    plain_gpu = pipe(*args)
                cpu_pipe = TorchPipeline(copy.deepcopy(pipe.model).cpu(), pipe.config,
                                         points_per_sweep=pipe.points_per_sweep,
                                         host_bev=pipe.host_bev, device="cpu")
                plain_cpu = cpu_pipe(*args)
                del cpu_pipe, pipe
                row.update(first_waypoints=waypoints.tolist(),
                           max_abs_vs_plain_gpu=float(np.abs(waypoints - plain_gpu).max()),
                           max_abs_vs_cpu=float(np.abs(waypoints - plain_cpu).max()))
                require(waypoints.shape == (4, 2) and bool(np.isfinite(waypoints).all()),
                        f"first-tick waypoints {waypoints}")
                np.testing.assert_allclose(waypoints, plain_gpu, **WAYPOINT_TOL)
                np.testing.assert_allclose(waypoints, plain_cpu, **CPU_TOL)
            probe.first = None                # the pipeline goes with the run
            emit("closed_loop", gpu=gpu, device_world=device_world, **row,
                 top=probe.profile[1])
            out[name] = row
            for k, v in row["launches"].items():
                total[k] += v
            torch.cuda.empty_cache()
        for name, extra in (("fleet_lockstep", []),
                            ("fleet_pipelined", ["agent.async_dispatch=true"])):
            probe, row = run_phase0(phase0, ops, name, [
                "routes=" + ROUTES, "repetitions=2", f"fleet={FLEET}",
                f"max_ticks={fleet_cap}"] + world + extra, tmp, pipeline_cls)
            require(row["routes"] == FLEET, f"{name}: {FLEET} routes in one fleet")
            # all 8 routes live up to the cap: one batched forward a tick after
            # the warm-up ticks, and every agent steered from each of them
            forwards = fleet_cap - warmup
            require(probe.vehicle_ticks == FLEET * fleet_cap
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
            emit("closed_loop", gpu=gpu, device_world=device_world, **row)
            out[name] = row
            for k, v in row["launches"].items():
                total[k] += v
            torch.cuda.empty_cache()
    summary = {
        "gpu": gpu,
        "device_world": device_world,
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
# the rest of the harness: storyboards, recording, post-hoc metrics, the
# scenario runner and the remote agent
# --------------------------------------------------------------------------- #

XOSC_DIR = os.path.join("data", "scenarios")
STORY_XOSC = os.path.join(XOSC_DIR, "cut_in_with_controller.xosc")
STORY_TICKS = 70                  # full-width MMFN-rad in the storyboard
REMOTE_TICKS = 70
SCENARIO_RUN_SECONDS = 20         # scenario_run's wall budget for its one repetition
# eval.yaml's straight road (map: null), the world of the shipped episodes
# and of its default route data/routes/smoke_route.xml
STORY_ARGS = ["--config", os.path.join("run_steps", "config", "eval.yaml"),
              "resume=false", "max_wall_seconds=900"]
STORY_EXTRA = []                  # CPU rehearsal: the map tool, device=cpu, a small model
SCENARIO_RUN_EXTRA = []           # CPU rehearsal: --device cpu --rmap-tool <tool>
METRIC_OUTPUTS = {"comfort": "Comfort.json", "criteria_filter": "CriteriaFilter_results.json",
                  "distance_between_vehicles": "DistanceBetweenVehicles.json",
                  "distance_to_lane_center": "DistanceToLaneCenter.json"}
METRICS_EXTRA = []                # CPU rehearsal: --rmap-tool <tool>


def shipped_episodes(tmp):
    """Each data/scenarios/*.xosc through the port's phase0 CLI with the
    expert, each in its own process and all at once (host work only): no
    vehicle collision and a route score above 50 each, as the JAX CLI's
    tests require."""
    runs = {}
    for name in sorted(f for f in os.listdir(XOSC_DIR) if f.endswith(".xosc")):
        checkpoint = os.path.join(tmp, f"xosc_{name}.json")
        log = open(os.path.join(tmp, f"xosc_{name}.log"), "w")
        cmd = [sys.executable, "-m", "mmfn_tpu_torch.harness.phase0", *STORY_ARGS,
               "routes=" + os.path.join(XOSC_DIR, name), "agent.type=expert",
               "checkpoint=" + checkpoint, *[a for a in STORY_EXTRA if "rmap_tool" in a]]
        runs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                      log, checkpoint, time.perf_counter())
    out = {}
    try:
        for name, (proc, log, checkpoint, t0) in runs.items():
            rc = proc.wait(timeout=600)
            seconds = time.perf_counter() - t0
            log.close()
            with open(log.name) as f:
                tail = f.read()[-1500:]
            require(rc == 0, f"phase0 on {name} exits 0 (rc {rc}):\n{tail}")
            with open(checkpoint) as f:
                records = json.load(f)["_checkpoint"]["records"]
            require(len(records) == 1, f"{name}: one record")
            r = records[0]
            out[name] = {"status": r["status"], "score_route": r["scores"]["score_route"],
                         "score_composed": r["scores"]["score_composed"],
                         "duration_game": r["meta"]["duration_game"], "seconds": seconds}
            require(not r["infractions"]["collisions_vehicle"],
                    f"{name}: no vehicle collision: {r['infractions']}")
            require(r["scores"]["score_route"] > 50, f"{name}: score_route above 50: {r}")
    finally:
        for proc, log, _, _ in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    emit("scenarios_xosc", episodes=out)
    return out


def storyboard_rad(phase0, ops, tmp):
    """Full-width MMFN-rad driving cut_in_with_controller.xosc through the
    port's phase0 CLI (in process) with ``record`` and a tick cap: no agent
    crash, every tick after the two warm-up ticks a forward of 1 BEV and 32
    attention launches, a recording of STORY_TICKS frames. Times the tick,
    profiles 5 forward ticks, and times the storyboard's and the recorder's
    host work a tick."""
    from mmfn_tpu_torch.harness.openscenario import OpenScenarioManager
    from mmfn_tpu_torch.harness.recording import EpisodeRecorder

    want = {"bev_hist": 1, "fused_attention": 32}
    record_dir = os.path.join(tmp, "record")
    with Timed({"story": (OpenScenarioManager, "tick"),
                "record": (EpisodeRecorder, "record_tick")}) as host:
        probe, row = run_phase0(phase0, ops, "storyboard", [
            "routes=" + STORY_XOSC, "agent.type=e2e", "agent.variant=rad",
            "agent.attn_impl=pallas", "agent.model_path=null", f"max_ticks={STORY_TICKS}",
            "record=" + record_dir] + STORY_EXTRA, tmp, base=STORY_ARGS)
    require(probe.vehicle_ticks == STORY_TICKS and len(probe.tick_launches) == STORY_TICKS - 2,
            f"storyboard: {probe.vehicle_ticks} world ticks, "
            f"{len(probe.tick_launches)} forward ticks")
    bad = [n for n in probe.tick_launches if n != want]
    require(not bad, f"storyboard: every forward tick launches {want}; got {bad[:3]}")
    recording = os.path.join(record_dir, "cut_in_with_controller_rep0.json")
    with open(recording) as f:
        frames = json.load(f)["frames"]
    require(len(frames) == STORY_TICKS, f"a recording of {STORY_TICKS} frames: {len(frames)}")
    lat = sorted(probe.tick_ms)
    prof = probe.profile[0]
    row.update(forward_ticks=len(probe.tick_launches), frames=len(frames),
               tick_ms_median=statistics.median(lat), tick_ms_p90=lat[int(0.9 * len(lat)) - 1],
               device_ops_per_forward=prof["device_ops_per_call"],
               device_busy_ms_per_forward=prof["device_busy_ms_per_call"],
               device_idle_share=prof["device_idle_share"],
               storyboard_ms_per_tick=statistics.mean(host.ms["story"]),
               recorder_ms_per_tick=statistics.mean(host.ms["record"]))
    probe.first = None
    emit("scenarios_storyboard", **row, top=probe.profile[1])
    return row, recording


def post_hoc_metrics(recording, tmp):
    """The port's metrics CLI, each in its own process as a user runs it,
    with each of the four metric copies over the storyboard's recording:
    exit 0 and the metric's output file."""
    out = {}
    for name, output in METRIC_OUTPUTS.items():
        out_dir = os.path.join(tmp, "metrics", name)
        cmd = [sys.executable, "-m", "mmfn_tpu_torch.harness.metrics_run", "--log", recording,
               "--metric", os.path.join("mmfn_tpu_torch", "harness", "metric_examples",
                                        f"{name}.py"), "--out", out_dir, *METRICS_EXTRA]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
        require(run.returncode == 0, f"metrics_run {name} exits 0:\n{run.stderr[-1500:]}")
        with open(os.path.join(out_dir, output)) as f:
            result = json.load(f)
        require(bool(result), f"metrics_run {name}: {output} holds a result")
        out[name] = {"seconds": seconds, "output": output, "line": run.stdout.strip()[-200:]}
    emit("scenarios_metrics", metrics=out)
    return out


def scenario_runner(ops, tmp):
    """``python -m mmfn_tpu_torch.harness.scenario_run --scenario
    CutInFromLeftLane --agent e2e --junit`` (its ``main``, in process, so
    that the launches are counted): eval.yaml's agent, full-width MMFN-vec,
    with the plain attention (no ``attn_impl``), so only the BEV kernel, once
    a forward tick. One testcase with a finite score."""
    from mmfn_tpu_torch.harness import scenario_run

    junit = os.path.join(tmp, "cut_in.xml")
    probe = ClosedLoopProbe(ops)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with probe:
        require(scenario_run.main(["--scenario", "CutInFromLeftLane", "--agent", "e2e",
                                   "--junit", junit, "--timeout", str(SCENARIO_RUN_SECONDS)]
                                  + SCENARIO_RUN_EXTRA) == 0, "scenario_run exits 0")
    seconds = time.perf_counter() - t0
    launches = probe.launches()
    want = {"bev_hist": 1, "fused_attention": 0}
    bad = [n for n in probe.tick_launches if n != want]
    require(probe.tick_launches and not bad,
            f"scenario_run: every forward tick launches {want}; got {bad[:3]}")
    import xml.etree.ElementTree as ET

    cases = ET.parse(junit).getroot().findall("testcase")
    require(len(cases) == 1, f"scenario_run: one testcase, {len(cases)}")
    text = cases[0].find("system-out").text
    score = float(re.search(r"score_composed=(\S+)", text).group(1))
    require(np.isfinite(score), f"scenario_run: a finite score: {text}")
    failure = cases[0].find("failure")
    row = {"seconds": seconds, "launches": launches, "forward_ticks": len(probe.tick_launches),
           "world_ticks": probe.vehicle_ticks, "score_composed": score,
           "status": "Completed" if failure is None else failure.get("message"),
           "tick_ms_median": statistics.median(probe.tick_ms) if probe.tick_ms else None}
    probe.first = None
    emit("scenarios_scenario_run", **row)
    return row


def remote_agent(phase0, tmp):
    """The port's phase0 CLI with ``agent.type=remote``, the port's stack
    (``python -m mmfn_tpu_torch.harness.agents.remote``, its own process) and
    stepping, on eval.yaml's straight route for REMOTE_TICKS ticks: every
    tick after the first acknowledged by its own seq (the first arms
    stepping), the stack's own exit (code 0) after ``destroy``. Times the
    round trip a tick and the stack's start (``RemoteAgent.setup``: the
    stack launched until it dials the bridge)."""
    from mmfn_tpu_torch.harness.agents.remote import RemoteAgent

    acks, exits = [], []

    def run_step(orig):
        def wrapped(agent, input_data, timestamp):
            control = orig(agent, input_data, timestamp)
            acks.append((agent._tick_seq, agent._control_seq))
            return control
        return wrapped

    def destroy(orig):
        def wrapped(agent):
            proc, sock = agent.stack_process, agent._sock_path
            orig(agent)
            exits.append((None if proc is None else proc.returncode, os.path.exists(sock)))
        return wrapped

    checkpoint = os.path.join(tmp, "remote.json")
    stack_cmd = f"{sys.executable} -m mmfn_tpu_torch.harness.agents.remote"
    with Timed({"setup": (RemoteAgent, "setup"), "tick": (RemoteAgent, "run_step")}) as t:
        t._wrap(RemoteAgent, "run_step", run_step)
        t._wrap(RemoteAgent, "destroy", destroy)
        t0 = time.perf_counter()
        require(phase0.main(STORY_ARGS + [
            "agent.type=remote", "agent.stack_cmd=" + stack_cmd, "agent.stepping=true",
            f"max_ticks={REMOTE_TICKS}", "checkpoint=" + checkpoint]
            + [a for a in STORY_EXTRA if "rmap_tool" in a]) == 0, "phase0 remote exits 0")
        seconds = time.perf_counter() - t0
    with open(checkpoint) as f:
        r = json.load(f)["_checkpoint"]["records"][0]
    require(np.isfinite(r["scores"]["score_composed"]) and "Agent crashed" not in r["status"],
            f"remote: a scored record: {r}")
    require(len(acks) == REMOTE_TICKS, f"remote: {len(acks)} ticks, want {REMOTE_TICKS}")
    require([a for a, _ in acks] == list(range(REMOTE_TICKS)), f"remote: tick seqs {acks[:3]}")
    unacked = [(a, c) for a, c in acks[1:] if c != a]
    require(not unacked, f"remote: every tick after the first acknowledged: {unacked[:3]}")
    require(exits == [(0, False)], f"remote: the stack exits 0, the bridge removed: {exits}")
    row = {"seconds": seconds, "ticks": len(acks), "status": r["status"],
           "score_composed": r["scores"]["score_composed"],
           "round_trip_ms_median": statistics.median(t.ms["tick"][1:]),
           "round_trip_ms_p90": sorted(t.ms["tick"][1:])[int(0.9 * (len(acks) - 1)) - 1],
           "stack_start_s": t.ms["setup"][0] / 1e3, "stack_exit_code": exits[0][0]}
    emit("scenarios_remote", **row)
    return row


def scenarios_phase(ops, gpu):
    """The rest of the harness on the card: the seven shipped episodes with
    the expert, full-width MMFN-rad in a storyboard with the recorder, the
    metrics CLI over its recording, the scenario runner on a repaired
    catalog name, and the remote agent. Returns the summary with the
    launches of the two runs that serve a model."""
    from mmfn_tpu_torch.harness import phase0

    laps = Laps()
    with tempfile.TemporaryDirectory() as tmp:
        episodes = shipped_episodes(tmp)
        laps("xosc")
        story, recording = storyboard_rad(phase0, ops, tmp)
        laps("storyboard")
        torch.cuda.empty_cache()
        metrics = post_hoc_metrics(recording, tmp)
        laps("metrics")
        runner = scenario_runner(ops, tmp)
        laps("scenario_run")
        torch.cuda.empty_cache()
        remote = remote_agent(phase0, tmp)
        laps("remote")
    launches = {k: story["launches"][k] + runner["launches"][k] for k in story["launches"]}
    summary = {
        "gpu": gpu,
        "episodes": {k: [e["status"], e["score_route"]] for k, e in episodes.items()},
        "storyboard_tick_ms_median": story["tick_ms_median"],
        "storyboard_tick_ms_p90": story["tick_ms_p90"],
        "storyboard_device_ops_per_forward": story["device_ops_per_forward"],
        "storyboard_device_busy_ms_per_forward": story["device_busy_ms_per_forward"],
        "storyboard_device_idle_share": story["device_idle_share"],
        "storyboard_host_ms_per_tick": story["storyboard_ms_per_tick"],
        "recorder_host_ms_per_tick": story["recorder_ms_per_tick"],
        "metrics_seconds": {k: m["seconds"] for k, m in metrics.items()},
        "scenario_run_bev_launches": runner["launches"]["bev_hist"],
        "scenario_run_forward_ticks": runner["forward_ticks"],
        "remote_round_trip_ms_median": remote["round_trip_ms_median"],
        "remote_round_trip_ms_p90": remote["round_trip_ms_p90"],
        "remote_stack_start_s": remote["stack_start_s"],
        "seconds": laps.seconds,
        "launches": launches}
    emit("scenarios_summary", **summary)
    return summary


# --------------------------------------------------------------------------- #
# the device world: sensors synthesized on the card
# --------------------------------------------------------------------------- #

DW_WIDTH = 128                    # the device-world fleet width of the JAX bench
DW_IMG_WIDTH = 8
DW_CPU_WIDTH = {"rad": 4, "img": 2}   # the vehicles held against the CPU
BIG_FLEET_WARMUP, BIG_FLEET_TICKS = 4, 20
CROSS_MAP = os.path.join("data", "maps", "fake_town_cross.xodr")
SENSOR_TOL = dict(rtol=1e-5, atol=1e-5)     # synthesized sensors, GPU against CPU


def compact_payloads(rough_map, n, rng):
    """``n`` compact payloads, as ``MMFNAgent`` hands them to the pipeline,
    at poses along the 4 routes of data/routes/benchmark_cross.xml: each
    with 3-8 actors within 25 m (walkers among them, some hidden from the
    sensors or the birdview), its route's traffic lights at a random time,
    a rain level and a brightness."""
    from types import SimpleNamespace

    from mmfn_tpu_torch.harness.device_world import actor_slab_np, light_slab_np
    from mmfn_tpu_torch.harness.route import interpolate_trajectory, parse_routes_file
    from mmfn_tpu_torch.harness.traffic import signals_from_rough_map

    routes = []
    for config in parse_routes_file(ROUTES):
        xy = [p for p, _ in interpolate_trajectory(config.trajectory)]
        routes.append((xy, signals_from_rough_map(rough_map, xy)))
    out = []
    for i in range(n):
        xy, signals = routes[i % len(routes)]
        k = int(rng.integers(0, len(xy) - 1))
        (x0, y0), (x1, y1) = xy[k], xy[k + 1]
        ego = np.array([x0, y0])
        actors = [SimpleNamespace(
            position=ego + rng.uniform(-25, 25, 2), velocity=rng.normal(size=2) * 3,
            extent=float(rng.uniform(0.4, 2.5)), actor_id=int(rng.integers(0, 100)),
            yaw=float(rng.uniform(-np.pi, np.pi)),
            kind="walker" if rng.random() < 0.3 else "vehicle",
            visible_sensors=bool(rng.random() < 0.85),
            visible_graphics=bool(rng.random() < 0.9))
            for _ in range(int(rng.integers(3, 9)))]
        slab, valid = actor_slab_np(actors, ego)
        out.append({"compact": True,
                    "pose": np.array([x0, y0, np.arctan2(y1 - y0, x1 - x0)], np.float32),
                    "target_point": (rng.normal(size=2) * 5).astype(np.float32),
                    "speed": float(rng.uniform(0, 8)), "actors": slab, "actors_valid": valid,
                    "lights": light_slab_np(signals.light_states(float(rng.uniform(0, 60))),
                                            ego),
                    "rain": float(rng.choice([0.0, 0.15, 0.6, 1.0])),
                    "brightness": float(rng.uniform(0.25, 1.0)),
                    "frame": int(rng.integers(0, 3000))})
    return out


def synced(fn):
    def run():
        fn()
        torch.cuda.synchronize()
    return run


def check_device_world_bev(lidar, points):
    """Kernel 1 on the device world's synthesized clouds (valid 0 and 1
    mixed) against its plain version, exactly, with clusters of 8 and 16;
    then its times beside the plain version's and the bound."""
    valid = points[..., 3]
    require(bool((valid == 0).any()) and bool((valid == 1).any()),
            "the synthesized clouds mix valid 0 and 1")
    want = lidar.bev_histogram_plain(points)
    name = f"device_world_{points.shape[0]}x{points.shape[1]}_f32"
    for cluster in lidar.CLUSTERS:
        got = lidar._bev_histogram_cuda(points, cluster)
        torch.cuda.synchronize()
        diff = float((got - want).abs().max())
        emit("bev_check", case=name, cluster=cluster, max_abs_err=diff,
             occupied_cells=int((got > 0).sum()))
        require(diff == 0.0, f"BEV kernel == plain version on {name}, cluster {cluster}")
    b, n = points.shape[:2]
    by_cluster = {c: [] for c in lidar.CLUSTERS}
    for c in lidar.CLUSTERS + lidar.CLUSTERS[::-1]:
        by_cluster[c].append(cuda_ms(lambda: lidar._bev_histogram_cuda(points, c)))
    return {"shape": list(points.shape), "dtype": str(points.dtype),
            "cluster": lidar.cluster_size(b),
            "ms": cuda_ms(lambda: lidar.bev_histogram(points)),
            "ms_by_cluster": {str(c): statistics.fmean(t) for c, t in by_cluster.items()},
            "plain_ms": cuda_ms(lambda: lidar.bev_histogram_plain(points)),
            "library_ms": None,
            **bound(points.numel() * 4 + b * 256 * 256 * 2 * 4,
                    12 * b * n + 2 * b * 256 * 256 * 2)}


def check_device_world_attention(attention, dev, rows):
    """Kernel 2 at the device-world fleet's batch (B = 128, every main-path
    T and D, both layouts) against its plain version, within rtol/atol 1e-5;
    then the fusion stages' shapes timed beside plain and SDPA."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    err = 0.0
    for t in (192, 256):
        for d in (16, 32, 64, 128):
            for layout in ("contiguous", "projection"):
                q, k, v = attention_inputs(DW_WIDTH, t, d, layout, g, dev)
                got = attention.fused_attention(q, k, v)
                want = attention.attention_plain(q, k, v)
                torch.cuda.synchronize()
                diff = float((got - want).abs().max())
                emit("attention_check", shape=[DW_WIDTH, 4, t, d], layout=layout,
                     max_abs_err=diff)
                torch.testing.assert_close(got, want, **ATTN_TOL)
                require(got.transpose(1, 2).is_contiguous(),
                        f"attention output at B = {DW_WIDTH} is a (B, T, H, D) buffer")
                if (t, d) in STAGE_SHAPES:
                    err = max(err, diff)
    for t, d in STAGE_SHAPES:
        q, k, v = attention_inputs(DW_WIDTH, t, d, "projection", g, dev)
        key = f"attention_b{DW_WIDTH}_t{t}_d{d}"
        rows[key] = {"shape": [DW_WIDTH, 4, t, d], "layout": "projection",
                     "ms": cuda_ms(lambda: attention.fused_attention(q, k, v)),
                     "plain_ms": cuda_ms(lambda: attention.attention_plain(q, k, v)),
                     "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                     **attention_bounds(q)}
        emit("kernel_time", name=key, **rows[key])
    return err


def plain_forward(pipe, lidar, payloads):
    """The same pipeline with the plain attention and the plain BEV."""
    from mmfn_tpu_torch.harness import device_world as dw

    kernel_bev = dw.lidar_to_histogram_features
    dw.lidar_to_histogram_features = lidar.bev_histogram_plain
    try:
        with plain_attention(pipe.model):
            return pipe.dispatch_fleet(payloads).cpu().numpy()
    finally:
        dw.lidar_to_histogram_features = kernel_bev


def hold_against_cpu(pipe, rough_map, payloads, waypoints):
    """The first vehicles through a CPU pipeline of the same weights (plain
    everything): every synthesized sensor equal to the card's (the BEV
    exactly, the rest within 1e-5), the waypoints within CPU_TOL."""
    from mmfn_tpu_torch.harness.device_world import DeviceWorldPipeline

    cpu_pipe = DeviceWorldPipeline(copy.deepcopy(pipe.model).cpu(), pipe.config,
                                   birdview=pipe.birdview, device="cpu")
    cpu_pipe.set_map(rough_map)
    want = cpu_pipe.synthesize(payloads)
    got = pipe.synthesize(payloads)
    errs = {}
    for name, g, c in zip(got._fields, got, want):
        require((g is None) == (c is None), f"{name} on both devices")
        if g is None:
            continue
        g = g.cpu()
        errs[name] = float((g.double() - c.double()).abs().max())
        if name in ("lidar_bev", "lane_num"):
            require(torch.equal(g, c), f"{name}: card == CPU exactly")
        else:
            torch.testing.assert_close(g, c, **SENSOR_TOL)
    cpu_wp = cpu_pipe.forward(want).numpy()
    np.testing.assert_allclose(waypoints, cpu_wp, **CPU_TOL)
    errs["waypoints"] = float(np.abs(waypoints - cpu_wp).max())
    return errs


def device_world_serve(variant, width, cfg, dev, ops, lidar, rough_map, payloads):
    """One batched device-world forward at ``width`` (launches counted from
    0 just before and read just after: 1 of kernel 1, 4 * n_layer of kernel
    2), held against the plain path on the card and the first vehicles
    against the CPU; the chunked synthesis against the monolithic one."""
    from mmfn_tpu_torch.harness.device_world import DeviceWorldPipeline
    from mmfn_tpu_torch.harness.fleet import _zero_like_payload
    from mmfn_tpu_torch.models import build_model

    t0 = time.perf_counter()
    model = build_model(cfg, variant, torch.Generator().manual_seed(SEED), device=dev)
    pipe = DeviceWorldPipeline(model, cfg, device=dev)
    require(pipe.birdview == (variant == "img"), f"{variant}: birdview auto")
    pipe.set_map(rough_map)
    setup_s = time.perf_counter() - t0
    payloads = payloads[:width]

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    waypoints = pipe.dispatch_fleet(payloads).cpu().numpy()
    launches = {k: kernel.launches for k, kernel in ops.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    want = {"bev_hist": 1, "fused_attention": 4 * cfg.n_layer}
    require(launches == want, f"{variant}: one forward launches {want}; got {launches}")
    require(waypoints.shape == (width, 4, 2) and bool(np.isfinite(waypoints).all()),
            f"{variant}: finite ({width}, 4, 2) waypoints")

    plain_gpu = plain_forward(pipe, lidar, payloads)
    np.testing.assert_allclose(waypoints, plain_gpu, **WAYPOINT_TOL)
    n_cpu = DW_CPU_WIDTH[variant]
    errs = hold_against_cpu(pipe, rough_map, payloads[:n_cpu], waypoints[:n_cpu])

    chunked = pipe.synthesize(payloads)
    pipe.synth_chunk = None
    whole = pipe.synthesize(payloads)
    pipe.synth_chunk = 32
    for name, a, b in zip(chunked._fields, chunked, whole):
        require((a is None and b is None) or torch.equal(a, b),
                f"{variant}: chunked synthesis == monolithic in {name}")
    del chunked, whole
    # the fleet's zero payloads for finished vehicles synthesize too
    zeros = pipe.dispatch_fleet([_zero_like_payload(payloads[0])] * 2).cpu().numpy()
    require(bool(np.isfinite(zeros).all()), f"{variant}: zero payloads")

    out = {"variant": variant, "width": width, "setup_seconds": setup_s,
           "launches": launches, "peak_bytes": peak,
           "max_abs_vs_plain_gpu": float(np.abs(waypoints - plain_gpu).max()),
           "max_abs_vs_cpu": errs, "max_abs_waypoint": float(np.abs(plain_gpu).max())}
    return pipe, out


def device_world(cfg, dev, ops, rng, gpu, lidar, attention, rows):
    """The device world on the cross town: kernel 1 at the synthesized
    128 x 3,340 f32 clouds and kernel 2 at B = 128; full-width MMFN-rad at
    width 128 and MMFN-img (birdview on the card) at width 8 through
    ``DeviceWorldPipeline``; the phase0 CLI with ``agent.device_world=true``;
    and a fleet of 128 ``MMFNAgent``s on one pipeline in ``FleetRunner``."""
    from mmfn_tpu_torch.mapping import vectorize_xodr

    with open(CROSS_MAP) as f:
        rough_map, _, _ = vectorize_xodr(f.read(), tool_path=MAP_TOOL, birdview=False)
    payloads = compact_payloads(rough_map, DW_WIDTH, rng)
    total = {name: 0 for name in ops.KERNELS}
    laps = Laps()

    pipe, rad = device_world_serve("rad", DW_WIDTH, cfg, dev, ops, lidar, rough_map, payloads)
    for k, v in rad["launches"].items():
        total[k] += v
    laps("rad_serve")
    rows["bev_device_world"] = check_device_world_bev(lidar, pipe.sensors(payloads)["points"])
    emit("kernel_time", name="bev_device_world", **rows["bev_device_world"])
    attn_err = check_device_world_attention(attention, dev, rows)
    laps("kernels")

    fwd, top = profile_calls(lambda: pipe.dispatch_fleet(payloads).cpu(), 3)
    syn, syn_top = profile_calls(synced(lambda: pipe.synthesize(payloads)), 3)
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        pipe.dispatch_fleet(payloads).cpu()
        lat.append((time.perf_counter() - t0) * 1e3)
    rad.update(gpu=gpu, step_ms_median=statistics.median(lat),
               vehicles_per_s=DW_WIDTH / statistics.median(lat) * 1e3,
               device_busy_ms_per_forward=fwd["device_busy_ms_per_call"],
               device_ops_per_forward=fwd["device_ops_per_call"],
               device_idle_share=fwd["device_idle_share"],
               profiled_forward_ms=fwd["wall_ms_per_call"],
               synthesis_busy_ms=syn["device_busy_ms_per_call"],
               synthesis_ops=syn["device_ops_per_call"],
               synthesis_share_of_busy=(syn["device_busy_ms_per_call"]
                                        / fwd["device_busy_ms_per_call"]
                                        if fwd["device_busy_ms_per_call"] else None))
    emit("device_world_serve", **rad, top=top, synthesis_top=syn_top)
    torch.cuda.empty_cache()
    laps("rad_profile")

    ipipe, img = device_world_serve("img", DW_IMG_WIDTH, cfg, dev, ops, lidar, rough_map,
                                    payloads)
    for k, v in img["launches"].items():
        total[k] += v
    ifwd, itop = profile_calls(lambda: ipipe.dispatch_fleet(payloads[:DW_IMG_WIDTH]).cpu(), 3)
    img.update(gpu=gpu, device_busy_ms_per_forward=ifwd["device_busy_ms_per_call"],
               device_ops_per_forward=ifwd["device_ops_per_call"],
               device_idle_share=ifwd["device_idle_share"],
               profiled_forward_ms=ifwd["wall_ms_per_call"])
    emit("device_world_serve", **img, top=itop)
    del ipipe
    torch.cuda.empty_cache()
    laps("img")

    loop = closed_loop(cfg, ops, gpu, device_world=True)
    for k, v in loop["launches"].items():
        total[k] += v
    laps("closed_loop")
    fleet = big_fleet(pipe, cfg, ops, gpu, rad["device_busy_ms_per_forward"])
    for k, v in fleet["launches"].items():
        total[k] += v
    laps("fleet128")
    summary = {"gpu": gpu, "launches": total, "seconds": laps.seconds,
               "attention_max_abs_err_at_fleet_width": attn_err,
               "rad_width128": {k: rad[k] for k in (
                   "step_ms_median", "vehicles_per_s", "device_busy_ms_per_forward",
                   "device_ops_per_forward", "device_idle_share", "synthesis_share_of_busy",
                   "peak_bytes")},
               "img_width8": {k: img[k] for k in (
                   "device_busy_ms_per_forward", "device_ops_per_forward",
                   "device_idle_share", "peak_bytes")},
               "closed_loop": {k: loop[k] for k in (
                   "tick_ms_median", "tick_ms_p90", "device_ops_per_forward",
                   "world_ms_per_tick", "fleet_vehicle_ticks_per_s")},
               "fleet128_vehicle_ticks_per_s": fleet["vehicle_ticks_per_s"]}
    emit("device_world_summary", **summary)
    return summary


def big_fleet(served, cfg, ops, gpu, busy_ms):
    """``DW_WIDTH`` ``MMFNAgent(device_world=True)`` on one pipeline of the
    ``served`` pipeline's model in ``FleetRunner`` (as bench_loop.py's compact-world fleet
    mode does), on a straight 960 m route each, one map: BIG_FLEET_WARMUP +
    BIG_FLEET_TICKS ticks, pipelined then lockstep. Every route runs to its
    cap with a batched forward on every tick after the first (1 kernel-1 and
    4 * n_layer kernel-2 launches each) that steers every agent, and no
    crash. Timed:
    the last BIG_FLEET_TICKS fleet ticks (between batched forwards), the
    worlds' and agents' host ms in them; ``busy_ms`` is the width's device
    busy time per batched forward, profiled apart."""
    from mmfn_tpu_torch.harness.agents import MMFNAgent
    from mmfn_tpu_torch.harness.device_world import DeviceWorldPipeline
    from mmfn_tpu_torch.harness.fleet import FleetRunner
    from mmfn_tpu_torch.harness.phase0 import FALLBACK_XODR
    from mmfn_tpu_torch.harness.route import RouteConfig

    n, ticks = DW_WIDTH, BIG_FLEET_WARMUP + BIG_FLEET_TICKS
    want = {"bev_hist": 1, "fused_attention": 4 * cfg.n_layer}
    out, total = {}, {name: 0 for name in ops.KERNELS}
    pipe = DeviceWorldPipeline(served.model, cfg, device=served.device)
    for name, pipelined in (("pipelined", True), ("lockstep", False)):
        probe = ClosedLoopProbe(ops, DeviceWorldPipeline)
        with tempfile.TemporaryDirectory() as tmp:
            agents = [MMFNAgent({"variant": "rad", "pipeline": pipe, "config": cfg,
                                 "rmap_tool": MAP_TOOL, "tmp_dir": os.path.join(tmp, str(i))})
                      for i in range(n)]
            routes = [{"config": RouteConfig(route_id=str(i), town="TownStraight", index=i,
                                             trajectory=[(-480.0, -1.75, 0.0),
                                                         (480.0, -1.75, 0.0)]),
                       "opendrive_str": FALLBACK_XODR, "max_ticks": ticks,
                       "world_kwargs": {"compact_sensors": True, "seed": i}}
                      for i in range(n)]
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                with probe:
                    records = FleetRunner(max_wall_seconds=900, pipelined=pipelined).run(
                        agents, routes)
            finally:
                for a in agents:
                    a.destroy()
            seconds = time.perf_counter() - t0
        launches = probe.launches()
        forwards = ticks - 1
        require(len(records) == n and all(
            r is not None and bool(r.status) and "Agent crashed" not in r.status
            and np.isfinite(r.scores["score_composed"]) for r in records),
            f"fleet of {n} {name}: every route scored, no crash")
        require(probe.vehicle_ticks == n * ticks and len(probe.fleet_t) == forwards
                and probe.steered == n * forwards,
                f"fleet of {n} {name}: {probe.vehicle_ticks} world ticks, "
                f"{len(probe.fleet_t)} batched forwards, {probe.steered} steered")
        bad = [x for x in probe.fleet_launches if x != want]
        require(not bad, f"fleet of {n} {name}: every batched forward launches {want}")
        last = n * BIG_FLEET_TICKS
        window_s = probe.fleet_t[-1] - probe.fleet_t[-1 - BIG_FLEET_TICKS]
        row = {"run": name, "gpu": gpu, "width": n, "ticks": ticks, "seconds": seconds,
               "launches": launches, "batched_forwards": len(probe.fleet_t),
               "vehicle_ticks_per_s": last / window_s,
               "fleet_tick_ms": window_s / BIG_FLEET_TICKS * 1e3,
               "world_ms_per_fleet_tick": (sum(probe.frame_ms[-last:])
                                           + sum(probe.step_ms[-last:])) / BIG_FLEET_TICKS,
               "agent_prep_thread_ms_per_fleet_tick": sum(probe.prep_ms[-last:])
               / BIG_FLEET_TICKS,
               "agent_finish_ms_per_fleet_tick": sum(probe.finish_ms[-last:])
               / BIG_FLEET_TICKS,
               "device_busy_ms_per_fleet_tick": busy_ms,
               "status": records[0].status}
        emit("device_world_fleet", **row)
        out[name] = row
        for k, v in launches.items():
            total[k] += v
    return {"launches": total,
            "vehicle_ticks_per_s": {k: r["vehicle_ticks_per_s"] for k, r in out.items()}}


# --------------------------------------------------------------------------- #
# the data path: collect, preprocess, train and serve through the port's CLIs
# --------------------------------------------------------------------------- #

DATA_TRAIN_TICKS = 160            # 15 frames a route: 6 routes, 54 samples, 2 batches
DATA_VAL_TICKS = 310              # 30 frames: 24 samples, 1 batch
DATA_EVAL_TICKS = 70
DATA_EPOCHS = 2
DATA_MODEL = {}                   # model overrides of phase2 and the served agent
DATA_DEVICE = []                  # ["device=cpu"] in a CPU rehearsal
TRAIN_ROUTES = os.path.join("data", "routes", "cross_train_3.xml")
VAL_ROUTE = os.path.join("data", "routes", "cross_straight_sn.xml")
COLLECT_ARGS = ["--config", os.path.join("run_steps", "config", "collect.yaml"),
                "map=" + CROSS_MAP,
                "scenarios=" + os.path.join("data", "scenarios", "fake_towns_scenarios.json"),
                "background_traffic=10", "weather=WetNoon", "agent.image_ext=png",
                "agent.rmap_tool=" + MAP_TOOL, "resume=false", "max_wall_seconds=900"]


def collect(phase0, tmp, name, extra):
    """One in-process collection run of the port's phase0 CLI (the expert
    on the host); returns its records, each finished route's (directory,
    expert steps), its seconds and the host ms of each world, expert,
    writer and birdview call."""
    from mmfn_tpu_torch.data.writer import DatasetWriter
    from mmfn_tpu_torch.harness.experts.agent import ExpertCollectionAgent
    from mmfn_tpu_torch.harness.replay import KinematicWorld
    from mmfn_tpu_torch.mapping.birdview import BirdViewProducer

    finished, destroy = [], ExpertCollectionAgent.destroy

    def record_route(agent):
        finished.append((agent.writer.route_dir, agent.step + 1))
        destroy(agent)

    checkpoint = os.path.join(tmp, f"collect_{name}.json")
    timed = Timed({"frame": (KinematicWorld, "sensor_frame"), "tick": (KinematicWorld, "tick"),
                   "expert": (ExpertCollectionAgent, "run_step"),
                   "writer": (DatasetWriter, "save_frame"),
                   "birdview": (BirdViewProducer, "produce")})
    ExpertCollectionAgent.destroy = record_route
    t0 = time.perf_counter()
    try:
        with timed:
            require(phase0.main(COLLECT_ARGS + ["checkpoint=" + checkpoint] + extra) == 0,
                    f"collect {name} exits 0")
    finally:
        ExpertCollectionAgent.destroy = destroy
    seconds = time.perf_counter() - t0
    with open(checkpoint) as f:
        records = json.load(f)["_checkpoint"]["records"]
    for r in records:
        require(bool(r.get("status")) and np.isfinite(r["scores"]["score_composed"])
                and "Agent crashed" not in r["status"],
                f"collect {name}: a status, no agent crash and a finite score: {r}")
    return records, finished, seconds, timed.ms


def check_frame_tree(route_dir, steps):
    """A route's frame directories each hold the frames its expert's steps
    imply under ``DatasetWriter.should_save``, and opendrive/ the map;
    returns the frame count."""
    from mmfn_tpu_torch.data.writer import SUBDIRS, DatasetWriter

    want = sum(DatasetWriter(route_dir).should_save(s) for s in range(steps))
    counts = {sub: len(os.listdir(os.path.join(route_dir, sub))) for sub in SUBDIRS}
    require(counts.pop("opendrive") == 1 and set(counts.values()) == {want} and want > 0,
            f"{route_dir}: {want} frames in every directory after {steps} steps: {counts}")
    return want


def check_frames_decode(route_dir):
    """Every frame of one route decodes, and each PNG re-encoded with
    data/png.py decodes to the same pixels; returns the PNG count."""
    from mmfn_tpu_torch.data import png

    pngs = 0
    for sub in ("rgb_front", "maps", "lidar", "radar", "vectormap", "measurements"):
        for name in sorted(os.listdir(os.path.join(route_dir, sub))):
            path = os.path.join(route_dir, sub, name)
            if name.endswith(".png"):
                pixels = png.read(path)
                require(pixels.dtype == np.uint8 and pixels.ndim == 3
                        and np.array_equal(png.decode(png.encode(pixels)), pixels),
                        f"{path} decodes, and re-encoded to the same pixels")
                pngs += 1
            elif name.endswith(".npy"):
                require(bool(np.isfinite(np.load(path)).all()), f"{path}: finite")
            else:
                with open(path) as f:
                    require(np.isfinite(json.load(f)["x"]), f"{path}: a measurement")
    require(pngs > 0, f"{route_dir}: PNG frames")
    return pngs


PHASE1_WORKERS = 4


def worker_start_seconds() -> float:
    """Wall seconds for PHASE1_WORKERS fresh interpreters, started together,
    to import what each spawned phase1 worker imports (the CLI's module, as
    its ``__main__``); each must leave torch unloaded."""
    code = "import sys, mmfn_tpu_torch.data.phase1; sys.exit('torch' in sys.modules)"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code]) for _ in range(PHASE1_WORKERS)]
    rcs = [p.wait(timeout=120) for p in procs]
    seconds = time.perf_counter() - t0
    require(rcs == [0] * PHASE1_WORKERS, f"phase1's workers start without torch: {rcs}")
    return seconds


def preprocess(root):
    """The port's phase1 CLI with 4 workers, in its own process as a user
    runs it, then the train split serially in this process: a pickle a
    sample in each pool, four of the pool's pickles equal to the serial
    ones, and no bad sample under check_data. The pools' seconds (the CLI
    prints each) include starting the workers, which is timed apart."""
    from mmfn_tpu_torch.config import GlobalConfig
    from mmfn_tpu_torch.data import dataset

    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "mmfn_tpu_torch.data.phase1", "--config",
                          os.path.join("run_steps", "config", "train.yaml"),
                          f"data_folder={root}", "train_towns=[CrossWetNoon]",
                          "val_towns=[ValWetNoon]", f"workers={PHASE1_WORKERS}"],
                         capture_output=True, text=True, timeout=600)
    cli_seconds = time.perf_counter() - t0
    print(run.stdout[-2000:] + run.stderr[-2000:], end="", flush=True)
    require(run.returncode == 0, "phase1 exits 0")
    pool_seconds = [float(s) for s in re.findall(r"wrote \d+ samples to .* \(([0-9.]+)s\)",
                                                 run.stdout)]
    require(len(pool_seconds) == 2, f"phase1 times both pools: {pool_seconds}")
    out = {"cli_seconds": cli_seconds, "pool_seconds": pool_seconds,
           "worker_start_seconds": worker_start_seconds()}
    base = os.path.dirname(root)
    for split, town in (("train", "CrossWetNoon"), ("eval", "ValWetNoon")):
        ds = dataset.CarlaDataset([os.path.join(root, f"{town}_short")], GlobalConfig())
        pool = os.path.join(base, f"pro_{split}_fmmfn")
        pickles = [n for n in os.listdir(pool) if n.endswith(".pkl")]
        require(len(pickles) == len(ds) > 0, f"{split}: {len(pickles)} pickles, {len(ds)} samples")
        require(dataset.check_data(ds) == [], f"{split}: check_data finds no bad sample")
        out[f"{split}_samples"] = len(ds)
        if split == "train":
            serial = os.path.join(base, "serial_train")
            t0 = time.perf_counter()
            dataset.preprocess_to_pickles(ds, serial)
            out["serial_seconds"] = time.perf_counter() - t0
            for i in np.linspace(0, len(ds) - 1, 4).astype(int):
                with open(os.path.join(pool, f"{i}.pkl"), "rb") as f, \
                        open(os.path.join(serial, f"{i}.pkl"), "rb") as g:
                    require(f.read() == g.read(), f"pickle {i}: the pool's equals the serial one")
    samples = out["train_samples"] + out["eval_samples"]
    out.update(samples_per_s_pool=samples / sum(pool_seconds),
               samples_per_s_pool_after_start=samples / (
                   sum(pool_seconds) - len(pool_seconds) * out["worker_start_seconds"]),
               samples_per_s_serial=out["train_samples"] / out["serial_seconds"])
    return out


def train_on_collected(phase2, ops, root, logdir, dev):
    """The port's phase2 CLI: full-width MMFN-rad at batch 24, f32, on the
    collected pools for DATA_EPOCHS epochs, validating after each through
    kernel 2; then the final weights' validation loss through kernel 2
    against the plain attention's on the same batches."""
    from mmfn_tpu_torch.config import GlobalConfig
    from mmfn_tpu_torch.data.dataset import PreprocessedDataset
    from mmfn_tpu_torch.data.device_cache import DeviceDataset
    from mmfn_tpu_torch.models.registry import get_entry_point
    from mmfn_tpu_torch.train import Engine

    timed = Timed({"epoch": (Engine, "train"), "validate": (Engine, "validate")})
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with timed:
        require(phase2.main(["--config", os.path.join("run_steps", "config", "train.yaml"),
                             f"data_folder={root}", f"logdir={logdir}",
                             "train_agent.entry_point=mmfn_rad", f"batch_size={TRAIN_BATCH}",
                             f"epochs={DATA_EPOCHS}", "val_every=1", "model.attn_impl=pallas",
                             "wandb_mode=disabled", f"seed={SEED}"]
                            + [f"model.{k}={v}" for k, v in DATA_MODEL.items()]
                            + DATA_DEVICE) == 0, "phase2 exits 0")
    seconds = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ops.KERNELS.items()}
    with open(os.path.join(logdir, "recent.log")) as f:
        log = json.load(f)
    steps_per_epoch = log["iter"] // DATA_EPOCHS
    require(log["epoch"] == DATA_EPOCHS and len(log["val_loss"]) == DATA_EPOCHS
            and steps_per_epoch >= 2, f"phase2 log: {log}")
    require(bool(np.isfinite(log["train_loss"] + log["val_loss"]).all()),
            f"finite losses: {log}")
    require(os.path.exists(os.path.join(logdir, "best_model.pth")), "best_model.pth written")
    val_set = PreprocessedDataset(os.path.join(os.path.dirname(root), "pro_eval_fmmfn"))
    val_forwards = len(val_set) // TRAIN_BATCH
    want = {"bev_hist": 0, "fused_attention": 4 * GlobalConfig(**DATA_MODEL).n_layer
            * val_forwards * DATA_EPOCHS}
    require(launches == want, f"phase2: a kernel-2 launch per attention layer of each "
            f"validation forward, none in training: {launches}, want {want}")

    gconf = GlobalConfig(attn_impl="pallas", **DATA_MODEL)
    model = get_entry_point("mmfn_rad")(gconf, device=dev)
    model.load_state_dict(torch.load(os.path.join(logdir, "model.pth"), map_location=dev,
                                     weights_only=True))
    engine = Engine(model, gconf, os.path.join(logdir, "check"))
    state = engine.initial_state()
    batches = list(DeviceDataset(val_set, gconf.max_lanes, need_map=False,
                                 device=dev).batches(TRAIN_BATCH))
    val_kernel = engine.validate(state, batches)
    with plain_attention(model):
        val_plain = engine.validate(state, batches)
    require(abs(val_kernel - val_plain) <= TRAIN_RTOL * abs(val_plain),
            f"validation loss {val_kernel} through kernel 2, {val_plain} plain")
    del model, engine, state, batches
    epoch_s = [ms / 1e3 for ms in timed.ms["epoch"]]
    return {"seconds": seconds, "epoch_seconds": epoch_s,
            "validate_seconds": [ms / 1e3 for ms in timed.ms["validate"]],
            "samples_per_s_by_epoch": [steps_per_epoch * TRAIN_BATCH / s for s in epoch_s],
            "steps_per_epoch": steps_per_epoch, "train_loss": log["train_loss"],
            "val_loss": log["val_loss"], "val_loss_final_kernel": val_kernel,
            "val_loss_final_plain": val_plain, "launches": launches}


def serve_trained(phase0, ops, tmp, logdir):
    """The port's phase0 CLI serving the trained best_model.pth on the
    held-out route for DATA_EVAL_TICKS ticks: it must load the checkpoint,
    every forward tick launches kernel 1 once and kernel 2 once per attention
    layer, and the first forward's waypoints agree with the plain attention
    on the same device."""
    from mmfn_tpu_torch.config import GlobalConfig

    captured = io.StringIO()
    try:
        with contextlib.redirect_stdout(captured):
            probe, row = run_phase0(phase0, ops, "trained", [
                "routes=" + VAL_ROUTE, f"max_ticks={DATA_EVAL_TICKS}",
                "agent.model_path=" + logdir]
                + [f"agent.{k}={v}" for k, v in DATA_MODEL.items()] + DATA_DEVICE, tmp)
    finally:
        print(captured.getvalue()[-3000:], end="", flush=True)
    text = captured.getvalue()
    ckpt = os.path.join(logdir, "best_model.pth")
    require(f"loaded checkpoint {ckpt}" in text and "random init" not in text,
            f"phase0 loaded {ckpt}")
    want = {"bev_hist": 1, "fused_attention": 4 * GlobalConfig(**DATA_MODEL).n_layer}
    require(probe.vehicle_ticks == DATA_EVAL_TICKS
            and len(probe.tick_launches) == DATA_EVAL_TICKS - 2,
            f"trained: {probe.vehicle_ticks} world ticks, {len(probe.tick_launches)} forwards")
    bad = [n for n in probe.tick_launches if n != want]
    require(not bad, f"trained: every forward tick launches {want}; got {bad[:3]}")
    pipe, args, waypoints = probe.first
    with plain_attention(pipe.model):
        plain = pipe(*args)
    require(waypoints.shape == (4, 2) and bool(np.isfinite(waypoints).all()),
            f"first-tick waypoints {waypoints}")
    np.testing.assert_allclose(waypoints, plain, **WAYPOINT_TOL)
    probe.first = None
    row.update(forward_ticks=len(probe.tick_launches),
               tick_ms_median=statistics.median(probe.tick_ms),
               first_waypoints=waypoints.tolist(),
               max_abs_vs_plain=float(np.abs(waypoints - plain).max()))
    if probe.profile is not None:     # PROFILED_TICKS forward ticks from PROFILE_FROM on
        prof = probe.profile[0]
        row.update(device_busy_ms_per_forward=prof["device_busy_ms_per_call"],
                   device_ops_per_forward=prof["device_ops_per_call"],
                   device_idle_share=prof["device_idle_share"])
    return row


def data_path(ops, gpu, dev, model_root):
    """Collect on the cross town with the port's expert (phase0, background
    traffic, both pilots), preprocess with the port's phase1 (4 workers),
    train full-width MMFN-rad on the result with the port's phase2, and serve
    its best_model.pth with the port's phase0: the reference's own pipeline,
    end to end, with the checks of each step. The checkpoint is kept as
    ``<model_root>/mmfn_rad/best_model.pth`` for the benchmark runner, and
    the phase-1 pools in ``<model_root>/pools`` for the multi-process phase."""
    from mmfn_tpu_torch.harness import phase0
    from mmfn_tpu_torch.train import phase2

    laps = Laps()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "mmfn")
        train = collect(phase0, tmp, "train", [
            "routes=" + TRAIN_ROUTES, "repetitions=2", "collect_offsets=true",
            f"max_ticks={DATA_TRAIN_TICKS}",
            "agent.data_save=" + os.path.join(root, "CrossWetNoon_short")])
        val = collect(phase0, tmp, "val", [
            "routes=" + VAL_ROUTE, "agent.type=auto", f"max_ticks={DATA_VAL_TICKS}",
            "agent.data_save=" + os.path.join(root, "ValWetNoon_short", "route_00")])
        require(len(train[0]) == len(train[1]) == 6 and len(val[0]) == len(val[1]) == 1,
                f"6 + 1 collected routes: {len(train[1])} + {len(val[1])}")
        frames = sum(check_frame_tree(d, steps) for d, steps in train[1] + val[1])
        pngs = check_frames_decode(train[1][0][0])
        ticks = sum(steps for _, steps in train[1] + val[1])
        ms = {k: sum(train[3][k]) + sum(val[3][k]) for k in train[3]}
        seconds = train[2] + val[2]
        collection = {
            "gpu": gpu, "vehicle_ticks": ticks, "frames": frames, "seconds": seconds,
            "vehicle_ticks_per_s": ticks / seconds, "frames_per_s": frames / seconds,
            "ms_per_tick": {"world": (ms["frame"] + ms["tick"]) / ticks,
                            "expert": (ms["expert"] - ms["writer"]) / ticks,
                            "writer": ms["writer"] / ticks},
            "writer_ms_per_frame": ms["writer"] / frames,
            "birdview_ms_per_tick": ms["birdview"] / ticks,
            "pngs_checked": pngs,
            "records": [[r["route_id"], r["status"], r["scores"]["score_composed"]]
                        for r in train[0] + val[0]]}
        emit("data_collect", **collection)
        laps("collect")
        pre = preprocess(root)
        require(pre["train_samples"] >= 2 * TRAIN_BATCH and pre["eval_samples"] >= TRAIN_BATCH,
                f"enough samples: {pre}")
        emit("data_preprocess", gpu=gpu, **pre)
        laps("preprocess")
        logdir = os.path.join(tmp, "log")
        trained = train_on_collected(phase2, ops, root, logdir, dev)
        emit("data_train", gpu=gpu, **trained)
        torch.cuda.empty_cache()
        laps("train")
        served = serve_trained(phase0, ops, tmp, logdir)
        emit("data_serve", gpu=gpu, **served)
        os.makedirs(os.path.join(model_root, "mmfn_rad"))
        shutil.copy(os.path.join(logdir, "best_model.pth"),
                    os.path.join(model_root, "mmfn_rad", "best_model.pth"))
        for pool in ("pro_train_fmmfn", "pro_eval_fmmfn"):     # for the multi-process phase
            shutil.copytree(os.path.join(tmp, pool), os.path.join(model_root, "pools", pool))
        laps("serve")
    launches = {name: trained["launches"][name] + served["launches"][name]
                for name in ops.KERNELS}
    return {"gpu": gpu, "collection": {k: collection[k] for k in (
                "vehicle_ticks_per_s", "ms_per_tick", "frames_per_s", "writer_ms_per_frame")},
            "phase1_samples_per_s": {"serial": pre["samples_per_s_serial"],
                                     "workers_4": pre["samples_per_s_pool"],
                                     "workers_4_after_start": pre["samples_per_s_pool_after_start"]},
            "phase1_worker_start_seconds": pre["worker_start_seconds"],
            "phase2_samples_per_s_by_epoch": trained["samples_per_s_by_epoch"],
            "val_loss_by_epoch": trained["val_loss"],
            "eval_tick_ms_median": served["tick_ms_median"],
            "seconds": laps.seconds, "launches": launches}


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
    with plain_attention(model):
        val_plain = engine.validate(state, val_batches)
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
            with plain_attention(model):
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


# --------------------------------------------------------------------------- #
# the benchmark runner, the bench, export, introspection, pretrained backbones
# --------------------------------------------------------------------------- #

BENCHMARK_WALL = 6                # seconds of wall a route in the runner's legs
BENCHMARK_EXTRA = []              # CPU rehearsal: ["--device", "cpu"]
BENCH_CUTS = {"ITERS": 30, "TRAIN_ITERS": 10, "PEAK_ITERS": 5, "DISK_SAMPLES": 96,
              "FLEET_TICKS": 30, "DEVICE_ITERS": 5}
BENCH_LOOP_WARMUP = 8             # bench_loop's warm-up ticks (24 uncut)
SOAK_TICKS, SOAK_FLEET_TICKS = 60, 40
EXPORT_TOL = dict(rtol=1e-4, atol=2e-3)
OP_CALLS = 500                    # host-timed calls of each attention route


class GpuMemory:
    """The card's memory while the block lasts, polled from nvidia-smi every
    second: the peak of the total in use, of one process's share and of
    the number of processes holding a context (MiB)."""

    def __init__(self):
        import threading

        self.peak = {"total_mib": 0, "one_process_mib": 0, "processes": 0}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)

    def _query(self, what, fields):
        out = subprocess.run(["nvidia-smi", f"--query-{what}={fields}",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return [line.split(",")[-1].strip() for line in out.stdout.strip().splitlines()]

    def _poll(self):
        while not self._stop.wait(1.0):
            apps = [int(m) for m in self._query("compute-apps", "pid,used_memory") if m.isdigit()]
            total = [int(m) for m in self._query("gpu", "memory.used") if m.isdigit()]
            for key, value in (("total_mib", sum(total)), ("one_process_mib", max(apps or [0])),
                               ("processes", len(apps))):
                self.peak[key] = max(self.peak[key], value)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        return False


def benchmark_phase(ops, gpu, model_root):
    """The port's benchmark runner (``python -m mmfn_tpu_torch.harness.
    benchmark_run``'s ``main``, in process; each leg a phase0 process) over
    both towns, ClearNoon, agents rad (the checkpoint the data path trained,
    ``<model_root>/mmfn_rad/best_model.pth``) and expert, BENCHMARK_WALL s of
    wall a route, two legs at once. Every row of TABLE.md has a driving
    score, the rad legs load the checkpoint; a second run finds every leg
    complete and launches no process; ``--aggregate-only`` rewrites TABLE.md
    byte for byte."""
    from mmfn_tpu_torch.harness import benchmark_run

    laps = Laps()
    with tempfile.TemporaryDirectory() as out:
        argv = ["--agents", "rad,expert", "--weathers", "ClearNoon", "--out", out,
                "--model-root", model_root, "--max-wall", str(BENCHMARK_WALL),
                "--jobs", "2"] + BENCHMARK_EXTRA
        text = io.StringIO()
        with GpuMemory() as memory, contextlib.redirect_stdout(text):
            require(benchmark_run.main(argv) == 0, "the benchmark runner exits 0")
        first = text.getvalue()
        print(first, end="", flush=True)
        laps("run")
        with open(os.path.join(out, "TABLE.md"), "rb") as f:
            table = f.read()
        rows = [r for r in table.decode().splitlines() if r.startswith("| ") and "---" not in r][1:]
        require(len(rows) == 4, f"4 legs in TABLE.md: {table.decode()}")
        scores = {}
        for r in rows:
            cells = [c.strip() for c in r.strip("|").split("|")]
            require(cells[3] != "_no data_" and np.isfinite(float(cells[3])),
                    f"a driving score in every row: {r}")
            scores[f"{cells[0]}_{cells[1]}"] = float(cells[3])
        ckpt = os.path.join(model_root, "mmfn_rad", "best_model.pth")
        for town in ("TownCross", "TownLoop"):
            with open(os.path.join(out, f"rad_{town}_ClearNoon.log")) as f:
                log = f.read()
            require(f"loaded checkpoint {ckpt}" in log, f"the rad leg on {town} loads {ckpt}")
        legs_s = {m.group(1).replace(" ", "_"): float(m.group(2)) for m in re.finditer(
            r"\[benchmark\] (\S+ \S+) ClearNoon: exit 0 \[(\d+)s\]", first)}

        launched = []
        real_run = benchmark_run.subprocess.run
        benchmark_run.subprocess.run = lambda *a, **k: launched.append(a)
        text = io.StringIO()
        try:
            with contextlib.redirect_stdout(text):
                require(benchmark_run.main(argv) == 0, "the resumed runner exits 0")
        finally:
            benchmark_run.subprocess.run = real_run
        require(not launched and text.getvalue().count("already complete") == 4,
                f"the second run finds every leg complete:\n{text.getvalue()}")
        os.remove(os.path.join(out, "TABLE.md"))
        with contextlib.redirect_stdout(io.StringIO()):
            require(benchmark_run.main(argv + ["--aggregate-only"]) == 0, "aggregate-only")
        with open(os.path.join(out, "TABLE.md"), "rb") as f:
            require(f.read() == table, "--aggregate-only rewrites TABLE.md byte for byte")
        laps("resume_and_aggregate")
    summary = {"gpu": gpu, "driving_scores": scores, "leg_seconds": legs_s,
               "card_memory_peak": memory.peak, "seconds": laps.seconds,
               "wall_per_route_s": BENCHMARK_WALL, "table": table.decode()}
    emit("benchmark", **summary)
    return summary


@contextlib.contextmanager
def cut(module, values):
    """``module``'s constants set to ``values`` while the block lasts."""
    saved = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def bench_phase(ops, gpu):
    """``mmfn_tpu_torch.bench.main`` in process at BENCH_CUTS (iteration and
    tick counts; full width): its JSON line has the JAX bench's keys, all
    non-null, ``pallas_ok`` true and ``device`` the H100. The launches of its
    kernel check (``pallas_ok``) are not counted."""
    from mmfn_tpu_torch import bench, bench_loop

    checks = {name: 0 for name in ops.KERNELS}
    check_kernels = bench.check_kernels

    def counted_apart(*args):
        before = {name: k.launches for name, k in ops.KERNELS.items()}
        try:
            return check_kernels(*args)
        finally:
            for name, k in ops.KERNELS.items():
                checks[name] += k.launches - before[name]

    text = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with cut(bench, {**BENCH_CUTS, "check_kernels": counted_apart}), \
            cut(bench_loop, {"WARMUP_TICKS": BENCH_LOOP_WARMUP}), contextlib.redirect_stdout(text):
        require(bench.main([]) == 0, "the bench exits 0")
    seconds = time.perf_counter() - t0
    launches = {name: k.launches - checks[name] for name, k in ops.KERNELS.items()}
    line = json.loads(text.getvalue().strip().splitlines()[-1])
    with open("BENCH_r05.json") as f:
        keys = set(json.load(f)["parsed"])
    require(set(line) == keys, f"the bench's keys are bench.py's: {sorted(set(line) ^ keys)}")
    require(all(v is not None for v in line.values()), f"every key non-null: {line}")
    require(line["pallas_ok"] is True, "pallas_ok: both kernels agree with their plain versions")
    require(line["device"] == torch.cuda.get_device_name(0) and "H100" in line["device"],
            f"device names the H100: {line['device']}")
    iters, dev_iters = BENCH_CUTS["ITERS"], BENCH_CUTS["DEVICE_ITERS"]
    want_bev = 2 * (3 + 3 * iters) + 3 + 3 * dev_iters      # + one a device-world fleet tick
    require(launches["bev_hist"] >= want_bev and launches["fused_attention"] == 0,
            f"kernel 1 once a pipeline step (plain attention): {launches}, want >= {want_bev}")
    require(checks == {"bev_hist": 1, "fused_attention": 4}, f"pallas_ok's launches {checks}")
    emit("bench", gpu=gpu, line=line, seconds=seconds, launches=launches,
         check_launches=checks, peak_bytes=torch.cuda.max_memory_allocated(),
         cuts=BENCH_CUTS, fleet_warmup_ticks=BENCH_LOOP_WARMUP)
    torch.cuda.empty_cache()
    return {"line": line, "seconds": seconds, "launches": launches}


def bench_loop_phase(ops, gpu):
    """``mmfn_tpu_torch.bench_loop.main`` in process: the soak (sync,
    pipelined, and the per-array transport, which bins on the card) at
    SOAK_TICKS ticks, then ``--fleet 8 --pipelined`` at SOAK_FLEET_TICKS."""
    from mmfn_tpu_torch import bench_loop

    lines, launches = [], {name: 0 for name in ops.KERNELS}
    t0 = time.perf_counter()
    for argv in (["--ticks", str(SOAK_TICKS)],
                 ["--fleet", "8", "--pipelined", "--ticks", str(SOAK_FLEET_TICKS)]):
        text = io.StringIO()
        ops.reset_launch_counts()
        with cut(bench_loop, {"WARMUP_TICKS": BENCH_LOOP_WARMUP}), \
                contextlib.redirect_stdout(text):
            require(bench_loop.main(argv) == 0, f"bench_loop {argv} exits 0")
        for name, k in ops.KERNELS.items():
            launches[name] += k.launches
        lines.append(json.loads(text.getvalue().strip().splitlines()[-1]))
        torch.cuda.empty_cache()
    soak, fleet = lines
    for mode in ("sync", "pipelined", "sync_per_array_transport"):
        require(soak[mode]["ticks_per_sec"] > 0 and soak[mode]["route_status"],
                f"soak {mode}: {soak[mode]}")
    require(fleet["fleet"] == 8 and fleet["agg_ticks_per_sec"] > 0, f"fleet: {fleet}")
    require(launches["bev_hist"] > 0, f"the per-array transport bins on the card: {launches}")
    seconds = time.perf_counter() - t0
    emit("bench_loop", gpu=gpu, soak=soak, fleet=fleet, launches=launches, seconds=seconds)
    return {"soak": soak, "fleet": fleet, "launches": launches, "seconds": seconds}


def host_us_per_call(fn, n: int) -> float:
    """Host microseconds to issue one call of ``fn`` (``n`` calls, no sync
    between them)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def served_ms(fn, reps: int = 20) -> float:
    """Host-clock median ms of a synchronized call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def export_phase(ops, gpu, dev):
    """Full-width MMFN-rad (attn_impl "pallas", seeded weights) exported with
    ``torch.export`` twice, on the card and on the CPU, each saved and
    loaded, then served on the card at batches 1 and 8: 32 kernel-2 launches
    a forward (none of kernel 1: the BEV comes in the batch) and the eager
    forward's waypoints within rtol 1e-4 / atol 2e-3; the exported forward
    timed against the eager one. Then the host cost of one attention call
    through the custom op against the direct launch."""
    from mmfn_tpu_torch.config import GlobalConfig
    from mmfn_tpu_torch.data.synthetic import synthetic_batch
    from mmfn_tpu_torch.models import build_model
    from mmfn_tpu_torch.ops import attention
    from mmfn_tpu_torch.serving import export_forward, load_exported, save_exported, serving_call
    from mmfn_tpu_torch.serving.export import model_params

    cfg = GlobalConfig(attn_impl="pallas")
    model = build_model(cfg, "rad", torch.Generator().manual_seed(SEED), device=dev)
    params = model_params(model)
    out = {"gpu": gpu}
    launches = {name: 0 for name in ops.KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        for where in (dev.type, "cpu"):
            src = model if where == dev.type else build_model(
                cfg, "rad", torch.Generator().manual_seed(SEED), device="cpu")
            t0 = time.perf_counter()
            exported = export_forward(src, model_params(src),
                                      synthetic_batch(2, cfg.max_lanes, seed=SEED, device=where))
            export_s = time.perf_counter() - t0
            path = os.path.join(tmp, f"mmfn_rad_{where}.pt2")
            save_exported(exported, path)
            loaded = load_exported(path)
            n_op = sum(str(n.target) == "mmfn.fused_attention.default"
                       for n in loaded.graph.nodes)
            require(n_op == 4 * cfg.n_layer, f"{where} artifact: {n_op} kernel-2 nodes")
            call = serving_call(loaded)
            row = {"export_s": export_s, "artifact_bytes": os.path.getsize(path)}
            for b in (1, 8):
                batch = synthetic_batch(b, cfg.max_lanes, seed=SEED + b, device=dev)
                ops.reset_launch_counts()
                served = call(params, batch)
                torch.cuda.synchronize()
                got = {name: k.launches for name, k in ops.KERNELS.items()}
                for name in launches:
                    launches[name] += got[name]
                require(got == {"bev_hist": 0, "fused_attention": 32},
                        f"{where} artifact at batch {b}: 32 kernel-2 launches, {got}")
                with torch.inference_mode():
                    eager = model(batch)
                require(served.shape == (b, 4, 2) and bool(torch.isfinite(served).all()),
                        f"served waypoints {tuple(served.shape)}")
                np.testing.assert_allclose(served.cpu().numpy(), eager.cpu().numpy(),
                                           **EXPORT_TOL)
                row[f"max_abs_vs_eager_b{b}"] = float((served - eager).abs().max())
                ops.reset_launch_counts()

                def eager_call(batch=batch):
                    with torch.inference_mode():
                        return model(batch)

                row[f"served_ms_b{b}"] = served_ms(lambda batch=batch: call(params, batch))
                row[f"eager_ms_b{b}"] = served_ms(eager_call)
                for name, k in ops.KERNELS.items():
                    launches[name] += k.launches
            out[f"exported_on_{where}"] = row
            emit("export", artifact=where, **row)
            del exported, loaded, call, src
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    q, k, v = attention_inputs(1, 192, 64, "projection", g, dev)
    with torch.inference_mode():
        host = {"direct": [], "op": []}
        for route in ("direct", "op", "op", "direct"):
            fn = attention.fused_attention if route == "direct" else attention.fused_attention_op
            host[route].append(host_us_per_call(lambda fn=fn: fn(q, k, v), OP_CALLS))
        require(torch.equal(attention.fused_attention(q, k, v),
                            attention.fused_attention_op(q, k, v)),
                "both routes launch the same kernel")
    out["attention_host_us_per_call"] = {r: statistics.fmean(t) for r, t in host.items()}
    emit("attention_op_overhead", gpu=gpu, shape=[1, 4, 192, 64], calls=OP_CALLS,
         host_us_per_call=out["attention_host_us_per_call"])
    del model, params
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def introspection_phase(ops, gpu, dev):
    """``utils/introspection.py`` on full-width MMFN-rad at batch 2: on the
    plain attention path 32 maps of (2, 4, T, T), T in {192, 256}, rows
    summing to 1 within 1e-5; under "pallas" no maps (the kernel forms
    none) and 32 kernel-2 launches."""
    from mmfn_tpu_torch.config import GlobalConfig
    from mmfn_tpu_torch.data.synthetic import synthetic_batch
    from mmfn_tpu_torch.models import build_model
    from mmfn_tpu_torch.utils.introspection import (attention_rollout, attention_weights,
                                                    forward_with_intermediates)

    model = build_model(GlobalConfig(attn_impl="pallas"), "rad",
                        torch.Generator().manual_seed(SEED), device=dev)
    batch = synthetic_batch(2, seed=SEED, device=dev)
    t0 = time.perf_counter()
    with plain_attention(model):
        _, tree = forward_with_intermediates(model, batch)
    seconds = time.perf_counter() - t0
    maps = attention_weights(tree)
    require(len(maps) == 32, f"32 attention maps, got {len(maps)}")
    worst = 0.0
    for key, att in maps.items():
        t = 256 if "transformer4" in key else 192
        require(att.shape == (2, 4, t, t), f"{key}: {att.shape}")
        worst = max(worst, float(np.abs(att.sum(-1) - 1.0).max()))
    require(worst <= 1e-5, f"attention rows sum to 1 within 1e-5: {worst}")
    rollout = attention_rollout(tree)
    require(rollout.shape == (256, 512) and bool(np.isfinite(rollout).all()),
            f"rollout {rollout.shape}")
    ops.reset_launch_counts()
    _, fused_tree = forward_with_intermediates(model, batch)
    launches = {name: k.launches for name, k in ops.KERNELS.items()}
    require(not attention_weights(fused_tree) and launches["fused_attention"] == 32,
            f"no maps under pallas, 32 kernel-2 launches: {launches}")
    emit("introspection", gpu=gpu, maps=len(maps), worst_row_sum_err=worst,
         rollout_shape=list(rollout.shape), plain_forward_s=seconds, launches=launches)
    del model
    torch.cuda.empty_cache()
    return {"launches": launches}


def torchvision_keyed(net, seed):
    """A torchvision-keyed state dict of ``net``'s shapes (plus ``fc``), drawn
    from ``seed``: the stand-in for an ImageNet file."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(1000)
        elif k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        else:
            sd[k] = torch.randn(v.shape, generator=g)
    sd["fc.weight"], sd["fc.bias"] = torch.randn(1000, 512, generator=g), torch.zeros(1000)
    return sd


def pretrained_phase(ops, gpu, dev):
    """phase2 with ``pretrained_resnet34/18`` pointing at locally made
    torchvision-keyed files: 2 steps of full-width MMFN-rad at batch 24.
    The grafted tensors equal the files', the LiDAR conv1 kept its init, and
    training starts from the grafted weights."""
    import pickle

    from mmfn_tpu_torch.data.synthetic import synthetic_samples
    from mmfn_tpu_torch.models.resnet import resnet18, resnet34
    from mmfn_tpu_torch.train import Engine, phase2

    with tempfile.TemporaryDirectory() as tmp:
        files = {}
        for name, net, seed in (("resnet34", resnet34(3), 34), ("resnet18", resnet18(3), 18)):
            files[name] = os.path.join(tmp, f"{name}.pth")
            torch.save(torchvision_keyed(net, seed), files[name])
        for split, n, seed in (("pro_train_fmmfn", 2 * TRAIN_BATCH, 1),
                               ("pro_eval_fmmfn", TRAIN_BATCH, 2)):
            os.makedirs(os.path.join(tmp, split))
            for i, s in enumerate(synthetic_samples(n, seed=seed)):
                with open(os.path.join(tmp, split, f"{i:04d}.pkl"), "wb") as f:
                    pickle.dump(s, f)
        seen = {}
        graft, fit = phase2.load_imagenet_backbones, Engine.fit

        def graft_seen(sd, **kw):
            seen["before"] = {k: v.cpu().clone() for k, v in sd.items()}
            seen["after"] = graft(sd, **kw)
            return seen["after"]

        def fit_seen(self, state, *a, **kw):
            seen["at_fit"] = {k: v.cpu().clone() for k, v in state.model.state_dict().items()}
            return fit(self, state, *a, **kw)

        phase2.load_imagenet_backbones, Engine.fit = graft_seen, fit_seen
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            require(phase2.main([
                "--config", os.path.join("run_steps", "config", "train.yaml"),
                f"data_folder={os.path.join(tmp, 'mmfn')}",
                f"logdir={os.path.join(tmp, 'log')}", "train_agent.entry_point=mmfn_rad",
                f"batch_size={TRAIN_BATCH}", "epochs=1", "val_every=1", "wandb_mode=disabled",
                f"pretrained_resnet34={files['resnet34']}",
                f"pretrained_resnet18={files['resnet18']}"] + DATA_DEVICE) == 0,
                "phase2 with pretrained files exits 0")
        finally:
            phase2.load_imagenet_backbones, Engine.fit = graft, fit
        seconds = time.perf_counter() - t0
        with open(os.path.join(tmp, "log", "recent.log")) as f:
            log = json.load(f)
        r34 = torch.load(files["resnet34"], weights_only=True)
        r18 = torch.load(files["resnet18"], weights_only=True)
    after = {k: v.cpu() for k, v in seen["after"].items()}
    before, at_fit = seen["before"], seen["at_fit"]
    grafted = 0
    for key, value in after.items():
        if key.endswith("num_batches_tracked"):
            continue
        for prefix, src, skip in (("encoder.image_encoder.features.", r34, ()),
                                  ("encoder.img_map_encoder.features.", r34, ()),
                                  ("encoder.lidar_encoder._model.", r18, ("conv1.",))):
            if key.startswith(prefix):
                tv = key[len(prefix):]
                if tv.startswith(skip):
                    require(torch.equal(value, before[key]), f"{key} kept its init")
                else:
                    require(torch.equal(value, src[tv]), f"{key} == the file's {tv}")
                    grafted += 1
        require(torch.equal(at_fit[key], value), f"training starts from the grafted {key}")
    require(grafted > 200, f"{grafted} grafted tensors")
    require(log["iter"] == 2 and bool(np.isfinite(log["train_loss"]).all()),
            f"2 finite steps: {log}")
    launches = {name: k.launches for name, k in ops.KERNELS.items()}
    emit("pretrained", gpu=gpu, grafted_tensors=grafted, seconds=seconds,
         train_loss=log["train_loss"], val_loss=log["val_loss"], launches=launches)
    torch.cuda.empty_cache()
    return {"launches": launches}


# --------------------------------------------------------------------------- #
# multi-process
# --------------------------------------------------------------------------- #

MP_EPOCHS = 1                     # the NCCL run's epochs before its resume
MP_TIMEOUT = 600                  # seconds a torch.distributed.run may take
MP_BATCH = 24                     # the two gloo ranks' global batch (12 a rank)
MP_GRAD_REL = 0.1                 # worst relative L2 error of a parameter's gradient
                                  # against one process: set between sound steps and steps
                                  # missing an all-reduce (PERF.md §6)
MP_FLEETS = (8, 7)                # the sharded TorchPipeline's fleet widths
MP_TICKS = 10                     # timed sharded and unsharded fleet ticks
MP_PHASE0_TICKS = 30
MP_DEVICE = "cuda:0"              # both gloo ranks' device ("cpu" in a CPU rehearsal)
MP_MODEL = {}                     # model overrides of the gloo ranks (a CPU rehearsal's small model)
NO_DROPOUT = dict(embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launch_ranks(n, task, out, args=()):
    """``n`` ranks of this script's ``--rank-task <task>`` under
    ``torch.distributed.run``, in a session of their own that is killed on
    a timeout; returns each rank's JSON, the seconds and the output."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={n}",
           "--master_addr=localhost", f"--master_port={free_port()}",
           os.path.abspath(__file__), "--rank-task", task, out, *args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=MP_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        print(stdout[-3000:], stderr[-6000:], file=sys.stderr, flush=True)
    require(proc.returncode == 0, f"{task}: {n} ranks under torch.distributed.run exit 0 "
            f"(got {proc.returncode})")
    results = []
    for r in range(n):
        with open(f"{out}.rank{r}.json") as f:
            results.append(json.load(f))
    return results, seconds, stdout


def rank_phase2(ops, args):
    """One rank of the phase2 CLI (``phase2.main(args)``), timed by epoch,
    its launches counted from 0; the process group's backend recorded."""
    import torch.distributed as dist

    from mmfn_tpu_torch.parallel import mesh as pmesh
    from mmfn_tpu_torch.train import Engine, phase2

    group = {}
    make_mesh = pmesh.make_mesh

    def recording(*a, **k):
        group.update(backend=str(dist.get_backend()), world=dist.get_world_size())
        return make_mesh(*a, **k)

    pmesh.make_mesh = recording
    timed = Timed({"epoch": (Engine, "train"), "validate": (Engine, "validate"),
                   "save": (Engine, "save")})
    ops.reset_launch_counts()
    captured = io.StringIO()
    with timed, contextlib.redirect_stdout(captured):
        code = phase2.main(args)
    return {"exit": code, "group": group,
            "launches": {name: k.launches for name, k in ops.KERNELS.items()},
            "epoch_seconds": [ms / 1e3 for ms in timed.ms["epoch"]],
            "validate_seconds": [ms / 1e3 for ms in timed.ms["validate"]],
            "save_seconds": [ms / 1e3 for ms in timed.ms["save"]],
            "stdout": captured.getvalue()[-3000:]}


def _moments(state):
    """AdamW's exp_avg by parameter name, tensor-parallel shards gathered (a
    collective on the model group); 0.1 x the gradient after one step."""
    from mmfn_tpu_torch.parallel import mesh as pmesh

    tp = pmesh.layout_of(state.model)
    out = {}
    for name, p in state.model.named_parameters():
        m = state.optimizer.state[p]["exp_avg"]
        if tp is not None and name in tp.dims:
            m = pmesh.gather_full(m, tp.dims[name], tp.group, tp.size)
        out[name] = m.detach().clone()
    return out


def _worst_grad_error(got, want):
    """The largest relative L2 error of a parameter's exp_avg, the norm of
    the reference floored at 1e-6 of its largest element, and its name."""
    floor = 1e-6 * max(float(v.abs().max()) for v in want.values())
    errors = {k: float((got[k].double() - v.double()).norm()) / max(float(v.double().norm()),
                                                                      floor)
              for k, v in want.items()}
    worst = max(errors, key=errors.get)
    return errors[worst], worst


def _max_diff(got, want, stats=False):
    keys = [k for k in want if k.endswith(("running_mean", "running_var")) == stats
            and not k.endswith("num_batches_tracked")]
    if stats:
        return max(float(((got[k].double() - want[k].double()).abs()
                          / (1 + want[k].double().abs())).max()) for k in keys)
    return max(float((got[k].double() - want[k].double()).abs().max()) for k in keys)


def rank_pair(ops, args):
    """Two ranks on cuda:0 over gloo: full-width MMFN-rad's DDP step and
    model_parallel 2 (the eval forward through kernel 2, one step), each
    against the one-process version on rank 0."""
    import torch.distributed as dist

    from mmfn_tpu_torch.config import GlobalConfig
    from mmfn_tpu_torch.data.synthetic import synthetic_batch
    from mmfn_tpu_torch.models import build_model
    from mmfn_tpu_torch.parallel import mesh as pmesh
    from mmfn_tpu_torch.train.engine import create_train_state, make_train_step

    dev = pmesh.init_distributed(device=MP_DEVICE, backend="gloo")
    rank = dist.get_rank()
    cfg = GlobalConfig(attn_impl="pallas", **NO_DROPOUT, **MP_MODEL)
    batch = synthetic_batch(MP_BATCH, cfg.max_lanes, seed=SEED,
                            resolution=cfg.input_resolution, device=dev)

    def model():
        return build_model(cfg, "rad", torch.Generator().manual_seed(SEED), device=dev)

    def step(state, b, data_rank=0):
        loss = make_train_step(data_rank=data_rank)(state, b, SEED)
        return float(loss)

    res = {"rank": rank, "backend": dist.get_backend()}
    if rank == 0:                                  # the one-process references
        ref = model()
        with torch.inference_mode():
            ref_forward = ref(batch)
        ref_state = create_train_state(ref, cfg)
        ref_loss = step(ref_state, batch)
        ref_after = {k: v.detach().clone() for k, v in ref.state_dict().items()}
        ref_mu = _moments(ref_state)
        del ref, ref_state

    mesh = pmesh.make_mesh(2)
    ddp = model()
    state = create_train_state(ddp, cfg, mesh)
    t0 = time.perf_counter()
    local = torch.tensor(step(state, pmesh.shard_batch(batch, mesh),
                              pmesh.axis_rank(mesh, "data")), device=dev)
    torch.cuda.synchronize()
    res["ddp_step_s"] = time.perf_counter() - t0
    dist.all_reduce(local)
    ddp_loss = float(local) / 2
    if rank == 0:
        after = ddp.state_dict()
        res.update(ddp_loss=ddp_loss, ref_loss=ref_loss,
                   ddp_param_max_diff=_max_diff(after, ref_after),
                   ddp_stats_rel_diff=_max_diff(after, ref_after, stats=True))
        res["ddp_grad_rel_err"], res["ddp_grad_worst"] = _worst_grad_error(_moments(state),
                                                                           ref_mu)
    del ddp, state

    tp_mesh = pmesh.make_mesh(2, ("data", "model"), (1, 2))
    tp = pmesh.tensor_parallel_sharding(model(), tp_mesh)
    heads = {m.local_heads for m in tp.modules() if hasattr(m, "local_heads")}
    ops.reset_launch_counts()
    with torch.inference_mode():
        tp_forward = tp(batch)
    torch.cuda.synchronize()
    res["tp_forward_launches"] = {name: k.launches for name, k in ops.KERNELS.items()}
    res["tp_local_heads"] = sorted(heads)
    state = create_train_state(tp, cfg, tp_mesh)
    tp_loss = step(state, batch)
    after, mu = pmesh.full_state_dict(tp), _moments(state)
    if rank == 0:
        scale = float(ref_forward.abs().max())
        res.update(tp_forward_max_diff=float((tp_forward - ref_forward).abs().max()),
                   forward_scale=scale, tp_loss=tp_loss,
                   tp_param_max_diff=_max_diff(after, ref_after),
                   tp_stats_rel_diff=_max_diff(after, ref_after, stats=True), lr=cfg.lr)
        res["tp_grad_rel_err"], res["tp_grad_worst"] = _worst_grad_error(mu, ref_mu)
    pmesh.destroy_distributed()
    return res


def rank_task(task, out, args) -> int:
    """The body of one rank of :func:`launch_ranks` (``--rank-task``)."""
    from mmfn_tpu_torch import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"phase2": rank_phase2, "pair": rank_pair}[task](ops, args)
    with open(f"{out}.rank{os.environ['RANK']}.json", "w") as f:
        json.dump(res, f)
    return 0


def mp_phase2(tmp, pools_root, one_process_rate):
    """(a): the phase2 CLI at world 1 over NCCL, then its DCP resume."""
    from mmfn_tpu_torch.config import GlobalConfig
    from mmfn_tpu_torch.data.dataset import PreprocessedDataset

    logdir = os.path.join(tmp, "mp_log")
    args = ["--config", os.path.join("run_steps", "config", "train.yaml"),
            f"data_folder={os.path.join(pools_root, 'mmfn')}", f"logdir={logdir}",
            "train_agent.entry_point=mmfn_rad", f"batch_size={TRAIN_BATCH}", "val_every=1",
            "model.attn_impl=pallas", "wandb_mode=disabled", f"seed={SEED}",
            "multi_host=true", "checkpoint_backend=orbax"] + [
            f"model.{k}={v}" for k, v in DATA_MODEL.items()]
    val_forwards = len(PreprocessedDataset(os.path.join(pools_root, "pro_eval_fmmfn"))) \
        // TRAIN_BATCH
    per_val = {"bev_hist": 0, "fused_attention": 4 * GlobalConfig(**DATA_MODEL).n_layer
               * val_forwards}
    runs = []
    for epochs in (MP_EPOCHS, MP_EPOCHS + 1):
        (rank0,), seconds, _ = launch_ranks(1, "phase2", os.path.join(tmp, f"p2_{epochs}"),
                                            args + [f"epochs={epochs}"])
        with open(os.path.join(logdir, "recent.log")) as f:
            log = json.load(f)
        fresh = epochs - (0 if not runs else MP_EPOCHS)
        require(rank0["exit"] == 0 and log["epoch"] == epochs
                and len(log["val_loss"]) == epochs, f"phase2 over NCCL: {log}")
        require(rank0["group"]["world"] == 1 and "nccl" in rank0["group"]["backend"],
                f"a world of 1 over NCCL (gloo for the CPU side of DCP): {rank0['group']}")
        require(rank0["launches"] == {k: v * fresh for k, v in per_val.items()},
                f"kernel 2 in each validation forward: {rank0['launches']}")
        require(bool(np.isfinite(log["train_loss"] + log["val_loss"]).all()),
                f"finite losses {log}")
        require(os.path.exists(os.path.join(logdir, "model.orbax", ".metadata")),
                "model.orbax is a DCP directory")
        if runs:
            require(f"resumed from epoch {MP_EPOCHS}" in rank0["stdout"],
                    f"the rerun resumed from the DCP directory: {rank0['stdout'][-500:]}")
        runs.append({"seconds": seconds, **{k: rank0[k] for k in (
            "epoch_seconds", "validate_seconds", "save_seconds", "launches")}})
    steps = log["iter"] // (MP_EPOCHS + 1)
    # ms a step over each epoch, beside the one-process run's; an epoch of
    # the data path's pools is a few steps, the first with its warm-up, too
    # few to resolve a ratio of the two, so none is taken
    step_ms = [s * 1e3 / steps for s in runs[0]["epoch_seconds"] + runs[1]["epoch_seconds"]]
    shutil.rmtree(logdir, ignore_errors=True)
    return {"runs": runs, "steps_per_epoch": steps, "epoch_ms_per_step": step_ms,
            "one_process_epoch_ms_per_step": [TRAIN_BATCH / r * 1e3 for r in one_process_rate],
            "launches": {k: sum(r["launches"][k] for r in runs) for k in per_val}}


def mp_pair(tmp):
    """(b): two ranks on cuda:0 over gloo, DDP then model_parallel 2."""
    ranks, seconds, _ = launch_ranks(2, "pair", os.path.join(tmp, "pair"))
    r0 = ranks[0]
    require(all(r["backend"] == "gloo" for r in ranks), f"gloo ranks: {ranks}")
    require(abs(r0["ddp_loss"] - r0["ref_loss"]) < 1e-4
            and r0["ddp_param_max_diff"] < 2.5 * r0["lr"] and r0["ddp_stats_rel_diff"] < 1e-3
            and r0["ddp_grad_rel_err"] < MP_GRAD_REL,
            f"DDP step against one process: {r0}")
    require(r0["tp_forward_max_diff"] < 1e-4 * r0["forward_scale"],
            f"model_parallel 2 forward through kernel 2: {r0}")
    require(abs(r0["tp_loss"] - r0["ref_loss"]) < 1e-4
            and r0["tp_param_max_diff"] < 2.5 * r0["lr"] and r0["tp_stats_rel_diff"] < 1e-3
            and r0["tp_grad_rel_err"] < MP_GRAD_REL,
            f"model_parallel 2 step against one process: {r0}")
    want = {"bev_hist": 0, "fused_attention": 32}
    require(all(r["tp_forward_launches"] == want and r["tp_local_heads"] == [2]
                for r in ranks), f"32 kernel-2 launches at 2 heads a rank: {ranks}")
    return {"seconds": seconds, **{k: r0[k] for k in (
                "ddp_loss", "ref_loss", "ddp_param_max_diff", "ddp_stats_rel_diff",
                "ddp_grad_rel_err", "ddp_grad_worst", "tp_forward_max_diff", "forward_scale",
                "tp_loss", "tp_param_max_diff", "tp_stats_rel_diff", "tp_grad_rel_err",
                "tp_grad_worst", "ddp_step_s")},
            "launches": {k: sum(r["tp_forward_launches"][k] for r in ranks) for k in want}}


def fleet_tick_ms(pipe, payloads) -> float:
    """Median host-clock ms of a fleet tick: dispatch and fetch (HostCopy)."""
    from mmfn_tpu_torch.harness.agents.pipeline import HostCopy

    for _ in range(2):
        HostCopy(pipe.dispatch_fleet(payloads)).result()
    ms = []
    for _ in range(MP_TICKS):
        t0 = time.perf_counter()
        HostCopy(pipe.dispatch_fleet(payloads)).result()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def mp_serving(cfg, dev, ops, rng, tmp):
    """(c): two shards on cuda:0 (two streams) against one, and phase0 with
    agent.fleet_devices=1; each path's launches counted from 0."""
    from mmfn_tpu_torch.harness import phase0
    from mmfn_tpu_torch.harness.agents.pipeline import TorchPipeline
    from mmfn_tpu_torch.harness.device_world import DeviceWorldPipeline
    from mmfn_tpu_torch.mapping import vectorize_xodr
    from mmfn_tpu_torch.models import build_model

    two = [dev, dev]
    model = build_model(cfg, "rad", torch.Generator().manual_seed(SEED), device=dev)
    plain, sharded = (TorchPipeline(model, cfg, device=d) for d in (dev, two))
    require(sharded.replicas.streams[0] is not None
            and sharded.replicas.streams[0] != sharded.replicas.streams[1],
            "two shards on two streams")
    out = {"launches": {name: 0 for name in ops.KERNELS}}
    per_shard = {"bev_hist": 1, "fused_attention": 4 * cfg.n_layer}
    for width in MP_FLEETS:
        payloads = [payload(rng, cfg) for _ in range(width)]
        want = plain.dispatch_fleet(payloads).cpu().numpy()
        ops.reset_launch_counts()
        got = sharded.dispatch_fleet(payloads).cpu().numpy()
        launches = {name: k.launches for name, k in ops.KERNELS.items()}
        require(launches == {k: 2 * v for k, v in per_shard.items()},
                f"fleet {width} over 2 shards: {launches}")
        require(got.shape == (width, 4, 2) and bool(np.isfinite(got).all()),
                f"sharded waypoints {got.shape}")
        np.testing.assert_allclose(got, want, **WAYPOINT_TOL)
        out[f"fleet{width}_max_abs_vs_unsharded"] = float(np.abs(got - want).max())
        for k, v in launches.items():
            out["launches"][k] += v
    out["fleet8_tick_ms"] = {"unsharded": fleet_tick_ms(plain, payloads),
                             "two_shards": fleet_tick_ms(sharded, payloads)}
    del plain, sharded

    with open(CROSS_MAP) as f:
        rough_map, _, _ = vectorize_xodr(f.read(), tool_path=MAP_TOOL, birdview=False)
    payloads = compact_payloads(rough_map, DW_WIDTH, rng)
    plain, sharded = (DeviceWorldPipeline(model, cfg, device=d) for d in (dev, two))
    for pipe in (plain, sharded):
        pipe.set_map(rough_map)
    want = plain.dispatch_fleet(payloads).cpu().numpy()
    ops.reset_launch_counts()
    got = sharded.dispatch_fleet(payloads).cpu().numpy()
    launches = {name: k.launches for name, k in ops.KERNELS.items()}
    require(launches == {k: 2 * v for k, v in per_shard.items()},
            f"device world over 2 shards: {launches}")
    np.testing.assert_allclose(got, want, **WAYPOINT_TOL)
    out["device_world_max_abs_vs_unsharded"] = float(np.abs(got - want).max())
    for k, v in launches.items():
        out["launches"][k] += v
    out["device_world_tick_ms"] = {"unsharded": fleet_tick_ms(plain, payloads),
                                   "two_shards": fleet_tick_ms(sharded, payloads)}
    out["sharded_launches"] = dict(out["launches"])
    del plain, sharded, model
    torch.cuda.empty_cache()

    # one device: phase0 takes the plain path, so this checks the CLI's
    # plumbing of agent.fleet_devices; its launches are not a sharded path's

    _, row = run_phase0(phase0, ops, "fleet_devices", [
        "routes=" + ROUTES, "fleet=4", f"max_ticks={MP_PHASE0_TICKS}",
        "agent.fleet_devices=1"], tmp)
    require(row["launches"]["bev_hist"] > 0
            and row["launches"]["fused_attention"] == 4 * cfg.n_layer * row["launches"][
                "bev_hist"], f"phase0 agent.fleet_devices=1: {row['launches']}")
    out["phase0"] = {k: row[k] for k in ("seconds", "routes", "vehicle_ticks", "records")}
    for k, v in row["launches"].items():
        out["launches"][k] += v
    return out


def multi_process_phase(cfg, dev, ops, rng, gpu, pools_root, one_process_rate):
    """Phase 19 (module docstring): NCCL world 1 through the phase2 CLI with a
    DCP resume, two gloo ranks on cuda:0 for DDP and model_parallel 2, and
    the sharded pipelines and phase0."""
    laps = Laps()
    with tempfile.TemporaryDirectory() as tmp:
        trained = mp_phase2(tmp, pools_root, one_process_rate)
        emit("multi_process_nccl", gpu=gpu, **trained)
        laps("nccl_phase2")
        pair = mp_pair(tmp)
        emit("multi_process_gloo_pair", gpu=gpu, **pair)
        laps("gloo_pair")
        served = mp_serving(cfg, dev, ops, rng, tmp)
        emit("multi_process_serving", gpu=gpu, **served)
        laps("serving")
    launches = {k: trained["launches"][k] + pair["launches"][k] + served["launches"][k]
                for k in ops.KERNELS}
    emit("multi_process_summary", gpu=gpu, seconds=laps.seconds,
         nccl_epoch_ms_per_step=trained["epoch_ms_per_step"],
         one_process_epoch_ms_per_step=trained["one_process_epoch_ms_per_step"],
         ddp_grad_rel_err=pair["ddp_grad_rel_err"], tp_grad_rel_err=pair["tp_grad_rel_err"],
         ddp_loss_diff=abs(pair["ddp_loss"] - pair["ref_loss"]),
         tp_forward_max_diff=pair["tp_forward_max_diff"],
         fleet8_tick_ms=served["fleet8_tick_ms"],
         device_world_tick_ms=served["device_world_tick_ms"], launches=launches)
    return {"launches": launches}


# --------------------------------------------------------------------------- #
# the CARLA glue and the tools
# --------------------------------------------------------------------------- #

GLUE_TICKS = 68                   # MMFN-rad forward ticks through the glue (after 2 warm-up)
GLUE_ASYNC_TICKS = 30             # the same under agent.async_dispatch
GLUE_ROUTE_M = 120.0              # the straight test town's route for MMFN-rad
EXPERT_ROUTE_M = 40.0             # ... and for the expert, which drives it to the end
EPISODE_TICKS = 40                # record_episode's ticks: 10 frames at --every 4
GLUE_EXTRA = []                   # CPU rehearsal: ["device=cpu", "agent.n_layer=1", ...]
TOOLS_EXTRA = []                  # CPU rehearsal: ["--device", "cpu"]
VIZ_CONFIG = None                 # CPU rehearsal: a small GlobalConfig for viz_attention


def town_test_route(tmp, length) -> str:
    """A route file of one straight route of ``length`` m on the mock's
    "TownTest" (the straight test road), along y = 1.75."""
    path = os.path.join(tmp, f"town_test_{int(length)}.xml")
    with open(path, "w") as f:
        f.write('<routes><route id="0" town="TownTest">'
                '<waypoint x="0.0" y="1.75" z="0.0"/>'
                f'<waypoint x="{length}" y="1.75" z="0.0"/></route></routes>')
    return path


def gif_blocks(path):
    """(width, height, [(frame width, frame height)], [delay cs], loop
    count) of a GIF file, read by walking its blocks."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    require(data[:6] == b"GIF89a" and data[-1:] == b"\x3b", f"{path}: a GIF89a file")
    width, height, packed = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
    frames, delays, loop = [], [], None

    def skip_sub_blocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    while data[pos] != 0x3b:
        if data[pos] == 0x21:
            label, pos = data[pos + 1], pos + 2
            if label == 0xf9:
                delays.append(struct.unpack("<H", data[pos + 2:pos + 4])[0])
            elif label == 0xff and data[pos + 1:pos + 12] == b"NETSCAPE2.0":
                loop = struct.unpack("<H", data[pos + 14:pos + 16])[0]
            pos = skip_sub_blocks(pos)
        else:
            require(data[pos] == 0x2c, f"{path}: an image block at byte {pos}")
            _, _, fw, fh, packed = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
            pos += 10 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)       # after the LZW minimum code size
            frames.append((fw, fh))
    return width, height, frames, delays, loop


class GlueProbe(Timed):
    """What one run through the CARLA glue (or any loop of ``MMFNAgent``)
    does, by wrapping methods of the port's classes while the run lasts:
    the host clock at each pet of the watchdog (one a tick, so the gaps are
    the ticks' wall times the watchdog sees) and any watchdog that expired;
    the kernel launches of each tick that dispatched a forward; the pipeline;
    the last ``finish_step``'s payload and waypoints (the input the glue
    handed the agent, as the pipeline takes it, and what it steered by); the
    threads the kernels were launched from, eagerly or by a graph replay
    (``ForwardGraphs.run``); and the glue's sensor reader
    threads alive on the first tick."""

    def __init__(self, ops, glue=None):
        super().__init__({})
        self.ops, self.glue = ops, glue
        self.updates, self.trips, self.tick_launches = [], 0, []
        self.threads, self.readers = set(), None
        self.pipeline, self.last, self.dispatches = None, None, 0

    def launches(self):
        return {name: k.launches for name, k in self.ops.KERNELS.items()}

    def __enter__(self):
        from mmfn_tpu_torch.harness.agents import MMFNAgent, TorchPipeline
        from mmfn_tpu_torch.harness.agents.graphs import ForwardGraphs
        from mmfn_tpu_torch.harness.watchdog import Watchdog
        from mmfn_tpu_torch.ops._cuda import CudaKernel
        probe = self

        def update(orig):
            def wrapped(dog):
                probe.updates.append(time.perf_counter())
                return orig(dog)
            return wrapped

        def expired(orig):
            def wrapped(dog):
                probe.trips += 1
                return orig(dog)
            return wrapped

        def run_step(orig):
            def wrapped(agent, input_data, timestamp):
                if probe.readers is None and probe.glue is not None:
                    probe.readers = sum(isinstance(t, probe.glue._BaseReader)
                                        for t in threading.enumerate())
                before, n = probe.launches(), probe.dispatches
                control = orig(agent, input_data, timestamp)
                if probe.dispatches > n:
                    after = probe.launches()
                    probe.tick_launches.append({k: after[k] - before[k] for k in after})
                return control
            return wrapped

        def dispatch(orig):
            def wrapped(pipe, *args):
                probe.dispatches += 1
                probe.pipeline = pipe
                return orig(pipe, *args)
            return wrapped

        def finish_step(orig):
            def wrapped(agent, payload, waypoints):
                probe.last = (payload, np.array(waypoints))
                return orig(agent, payload, waypoints)
            return wrapped

        def launch(orig):
            def wrapped(kernel, *args):
                probe.threads.add(threading.get_ident())
                return orig(kernel, *args)
            return wrapped

        self._wrap(Watchdog, "update", update)
        self._wrap(Watchdog, "_expired", expired)
        self._wrap(MMFNAgent, "run_step", run_step)
        self._wrap(MMFNAgent, "finish_step", finish_step)
        self._wrap(TorchPipeline, "dispatch", dispatch)
        self._wrap(CudaKernel, "launch", launch)
        self._wrap(ForwardGraphs, "run", launch)     # a replay launches its kernels
        return super().__enter__()

    def tick_ms(self) -> dict:
        gaps = np.diff(self.updates) * 1e3
        return {"ticks": len(self.updates), "median_ms": float(np.median(gaps)),
                "max_ms": float(gaps.max())}


def glue_checkpoint(path, name):
    with open(path) as f:
        records = json.load(f)["_checkpoint"]["records"]
    require(len(records) == 1, f"{name}: one route record")
    r = records[0]
    require("Agent crashed" not in r["status"], f"{name}: {r['status']}")
    require(np.isfinite(r["scores"]["score_composed"]), f"{name}: a finite score {r}")
    return r


def glue_expert(phase0, ops, tmp):
    """(a) The expert drives the straight test town's 40 m route to the end
    through the phase0 CLI with ``simulator=carla``."""
    checkpoint = os.path.join(tmp, "carla_expert.json")
    probe = GlueProbe(ops)
    t0 = time.perf_counter()
    with probe:
        require(phase0.main(["--config", os.path.join("run_steps", "config", "eval.yaml"),
                             "routes=" + town_test_route(tmp, EXPERT_ROUTE_M),
                             "simulator=carla", "agent.type=expert",
                             "agent.rmap_tool=" + MAP_TOOL, "resume=false",
                             "checkpoint=" + checkpoint]) == 0, "phase0 carla expert exits 0")
    r = glue_checkpoint(checkpoint, "carla expert")
    require(r["status"] == "Completed" and r["scores"]["score_composed"] == 100.0,
            f"the expert completes the route at 100 through the glue: {r}")
    require(probe.trips == 0, "no watchdog trip under the expert")
    return {"status": r["status"], "score_composed": r["scores"]["score_composed"],
            "duration_game": r["meta"]["duration_game"], "seconds": time.perf_counter() - t0,
            "tick": probe.tick_ms()}


def glue_rad(phase0, glue, ops, tmp, ticks, async_dispatch):
    """(b) Full-width MMFN-rad (attn_impl "pallas", host_bev off, random
    weights from seed 0) through the phase0 CLI with ``simulator=carla``: the
    CLI builds the kernels (``enable_persistent_cache``) and warms the
    pipeline before the loop; the route's game timeout is cut to end after
    ``ticks`` forward ticks. Launch counters set to 0 just before the run and
    read just after; every forward tick launches 1 BEV and 32 attention
    kernels, from the loop's thread; no watchdog trip, no crash. The last
    tick's payload is replayed through the kernels, under the plain attention
    on the card and through the plain versions on the CPU."""
    from mmfn_tpu_torch.harness.agents import TorchPipeline

    mode = "async" if async_dispatch else "sync"
    checkpoint = os.path.join(tmp, f"carla_rad_{mode}.json")
    warm_ups = 3 if async_dispatch else 2
    end = (ticks + warm_ups) * glue.FIXED_DELTA_SECONDS - glue.FIXED_DELTA_SECONDS / 2
    saved_timeout, glue.route_timeout_seconds = glue.route_timeout_seconds, lambda length: end
    probe = GlueProbe(ops, glue)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with probe:
            require(phase0.main(
                ["--config", os.path.join("run_steps", "config", "eval.yaml"),
                 "routes=" + town_test_route(tmp, GLUE_ROUTE_M), "simulator=carla",
                 "agent.type=e2e", "agent.variant=rad", "agent.attn_impl=pallas",
                 "agent.model_path=null", "agent.rmap_tool=" + MAP_TOOL,
                 f"agent.async_dispatch={str(async_dispatch).lower()}", "resume=false",
                 "checkpoint=" + checkpoint] + GLUE_EXTRA) == 0, f"phase0 carla rad {mode} exits 0")
    finally:
        glue.route_timeout_seconds = saved_timeout
    seconds = time.perf_counter() - t0
    launches = probe.launches()
    r = glue_checkpoint(checkpoint, f"carla rad {mode}")
    forwards = len(probe.tick_launches)
    require(probe.trips == 0, f"rad {mode}: no watchdog trip at 2 s a tick")
    require(forwards >= ticks, f"rad {mode}: {forwards} forward ticks, want {ticks}")
    bad = [t for t in probe.tick_launches if t != {"bev_hist": 1, "fused_attention": 32}]
    require(not bad, f"rad {mode}: 1 BEV and 32 attention launches every forward tick: {bad[:3]}")
    require(probe.threads == {threading.main_thread().ident},
            f"rad {mode}: every kernel launched from the loop's thread: {probe.threads}")
    require((probe.readers or 0) >= 2, f"rad: the glue's reader threads ran: {probe.readers}")

    payload, steered = probe.last
    pipe = probe.pipeline
    again = pipe(*call_args(payload))
    with plain_attention(pipe.model):
        plain_gpu = pipe(*call_args(payload))
    cpu_model = copy.deepcopy(pipe.model).to("cpu")
    plain_cpu = TorchPipeline(cpu_model, pipe.config, points_per_sweep=pipe.points_per_sweep,
                              host_bev=False, device="cpu")(*call_args(payload))
    del cpu_model
    errs = {"max_abs_vs_replay": float(np.abs(steered - again).max()),
            "max_abs_vs_plain_gpu": float(np.abs(steered - plain_gpu).max()),
            "max_abs_vs_cpu": float(np.abs(steered - plain_cpu).max()),
            "max_abs_waypoint": float(np.abs(plain_cpu).max())}
    require(steered.shape == (4, 2) and bool(np.isfinite(steered).all()),
            f"rad {mode}: finite (4, 2) waypoints")
    np.testing.assert_allclose(steered, again, **WAYPOINT_TOL)
    np.testing.assert_allclose(steered, plain_gpu, **WAYPOINT_TOL)
    np.testing.assert_allclose(steered, plain_cpu, **CPU_TOL)
    return {"status": r["status"], "score_composed": r["scores"]["score_composed"],
            "seconds": seconds, "forward_ticks": forwards, "launches": launches,
            "tick": probe.tick_ms(), "reader_threads": probe.readers,
            "points_in_last_tick": int(len(payload["points"])), **errs}


def glue_episode(ops, tmp):
    """(c) ``record_episode`` with the e2e agent (MMFN-vec at full width,
    random weights, plain attention) on the cross town, capped at
    EPISODE_TICKS: 1 BEV launch every forward tick; the GIF's frames counted
    and sized by walking its blocks."""
    from mmfn_tpu_torch.tools import record_episode

    out = os.path.join(tmp, "episode.gif")
    probe = GlueProbe(ops)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with probe:
        require(record_episode.main(
            ["--route", os.path.join("data", "routes", "cross_straight.xml"), "--map", CROSS_MAP,
             "--agent", "e2e", "--max-ticks", str(EPISODE_TICKS), "--out", out,
             "--rmap-tool", MAP_TOOL] + TOOLS_EXTRA) == 0, "record_episode exits 0")
    seconds = time.perf_counter() - t0
    launches = probe.launches()
    width, height, frames, delays, loop = gif_blocks(out)
    want_frames = -(-EPISODE_TICKS // 4)
    require(len(frames) == want_frames and set(frames) == {(width, height)} == {(256, 256)},
            f"record_episode: {want_frames} frames of 256 x 256: {width}x{height}, {frames}")
    require(set(delays) == {20} and loop == 0, f"record_episode: 200 ms frames, loop 0: "
                                               f"{delays}, {loop}")
    bad = [t for t in probe.tick_launches if t != {"bev_hist": 1, "fused_attention": 0}]
    require(probe.tick_launches and not bad,
            f"record_episode: 1 BEV launch every forward tick: {bad[:3]}")
    return {"seconds": seconds, "forward_ticks": len(probe.tick_launches), "frames": len(frames),
            "bytes": os.path.getsize(out), "launches": launches}


def glue_tools(ops, tmp):
    """(d) ``viz_attention`` for full-width MMFN-rad and
    ``render_birdview_samples``, into a temporary directory: the file counts,
    and every PNG decoded by ``data/png.py``."""
    from mmfn_tpu_torch.config import GlobalConfig
    from mmfn_tpu_torch.data import png
    from mmfn_tpu_torch.tools import render_birdview_samples, viz_attention

    cfg = VIZ_CONFIG or GlobalConfig()
    att_dir, bv_dir = os.path.join(tmp, "attention"), os.path.join(tmp, "birdview")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    require(viz_attention.main(["--variant", "rad", "--out", att_dir] + TOOLS_EXTRA,
                               config=VIZ_CONFIG) == 0, "viz_attention exits 0")
    viz_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ops.KERNELS.items()}
    files = sorted(os.listdir(att_dir))
    # per layer: 3 stages of 3 token groups (1 + 6 maps), 1 of 4 (1 + 12)
    require(len(files) == cfg.n_layer * (3 * 7 + 13), f"viz_attention: {len(files)} files")
    res = cfg.input_resolution
    for name in files:
        img = png.read(os.path.join(att_dir, name))
        want = (512, 512, 3) if name.endswith("_tokens.png") else (res, res, 3)
        require(img.shape == want, f"viz_attention {name}: {img.shape}")
    t0 = time.perf_counter()
    require(render_birdview_samples.main(["--out", bv_dir, "--rmap-tool", MAP_TOOL]) == 0,
            "render_birdview_samples exits 0")
    bv_s = time.perf_counter() - t0
    panels = sorted(os.listdir(bv_dir))
    require(panels == ["birdview_cross.png", "birdview_loop.png", "birdview_straight.png"],
            f"render_birdview_samples: {panels}")
    for name in panels:
        img = png.read(os.path.join(bv_dir, name))
        require(img.shape == (256, 1024, 3) and img.any(), f"{name}: {img.shape}")
    return {"viz_attention": {"files": len(files), "seconds": viz_s, "launches": launches},
            "render_birdview_samples": {"files": len(panels), "seconds": bv_s}}


def carla_phase(ops, gpu, build_seconds):
    """Phase 20: the CARLA glue on the port's carla mock (the expert; full-width
    MMFN-rad synchronous and with ``async_dispatch``) through the phase0 CLI,
    then ``record_episode``, ``viz_attention`` and
    ``render_birdview_samples``."""
    from mmfn_tpu_torch.harness import fake_carla, phase0
    from mmfn_tpu_torch.tools.render_birdview_samples import STRAIGHT_XODR
    from mmfn_tpu_torch.utils.compile_cache import enable_persistent_cache

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        glue = fake_carla.install({"TownTest": STRAIGHT_XODR})
        try:
            require(glue.HAS_CARLA, "the glue binds the mock once it is installed")
            out["expert"] = glue_expert(phase0, ops, tmp)
            t0 = time.perf_counter()
            require(enable_persistent_cache(), "enable_persistent_cache() on the card")
            out["cache"] = {"cold_build_s": build_seconds,
                            "warm_call_s": time.perf_counter() - t0}
            out["rad_sync"] = glue_rad(phase0, glue, ops, tmp, GLUE_TICKS, False)
            out["rad_async"] = glue_rad(phase0, glue, ops, tmp, GLUE_ASYNC_TICKS, True)
        finally:
            fake_carla.uninstall()
        require("carla" not in sys.modules, "the mock is gone after uninstall()")
        torch.cuda.empty_cache()
        out["episode"] = glue_episode(ops, tmp)
        torch.cuda.empty_cache()
        out.update(glue_tools(ops, tmp))
    launches = {k: sum(out[p]["launches"][k] for p in ("rad_sync", "rad_async", "episode"))
                + out["viz_attention"]["launches"][k] for k in ops.KERNELS}
    emit("carla_tools", gpu=gpu, **out)
    watchdog_s = 2.0
    emit("carla_tools_summary", gpu=gpu, watchdog_s=watchdog_s,
         expert_tick_ms=out["expert"]["tick"],
         rad_tick_ms={m: out[f"rad_{m}"]["tick"] for m in ("sync", "async")},
         watchdog_margin_s={m: watchdog_s - out[f"rad_{m}"]["tick"]["max_ms"] / 1e3
                            for m in ("sync", "async")},
         cache=out["cache"], launches=launches)
    torch.cuda.empty_cache()
    return {"launches": launches}


R05_REPETITIONS = 1               # of the leg's 10: 3 route-runs
R05_TICKS = 440                   # ticks a route: ~43 frames, ~111 samples in all
R05_EPOCHS = 1
R05_COLLECT_EXTRA = []            # CPU rehearsal: ["agent.rmap_tool=<tool>"]
R05_TRAIN_EXTRA = []              # CPU rehearsal: ["device=cpu", "model.n_layer=1"]


@contextlib.contextmanager
def output_to(path):
    """This process's file descriptor 1, which its subprocesses inherit,
    written to ``path`` while the block lasts."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def scale_r05_collect():
    """Start the recipe's cut collection leg (module docstring, 21) in a
    process group of its own, its output in a log beside its data; returns
    the process and the recipe's root. The group is stopped at exit."""
    root = tempfile.mkdtemp(prefix="scale_r05_")
    code = ("import json, sys; from mmfn_tpu_torch.tools import scale_r05; "
            "legs = scale_r05.collect(sys.argv[1], ['ClearNoon'], legs=['cross'], "
            "extra=sys.argv[2:]); json.dump(legs, open(sys.argv[1] + '/legs.json', 'w'))")
    with open(os.path.join(root, "collect.log"), "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", code, root,
                                 f"repetitions={R05_REPETITIONS}", f"max_ticks={R05_TICKS}",
                                 *R05_COLLECT_EXTRA], stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, 15)
            proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    atexit.register(stop)
    return proc, root


def scale_r05_phase(gpu, collector):
    """The round-5 recipe's stages, each in its own process as the recipe
    runs them, cut to one short leg and one epoch (module docstring, 21):
    waits for the collection ``scale_r05_collect`` started."""
    from mmfn_tpu_torch.tools import scale_r05

    proc, root = collector
    t0 = time.perf_counter()
    rc = proc.wait()
    waited = time.perf_counter() - t0
    with open(os.path.join(root, "collect.log")) as f:
        text = f.read()
    require(rc == 0, f"the recipe's collection exits 0, not {rc}:\n{text[-3000:]}")
    with open(os.path.join(root, "legs.json")) as f:
        legs = json.load(f)
    log = os.path.join(root, "stages.log")
    with output_to(log):
        # the held-out leg is not collected: the cross pool is both splits
        phase1_s = scale_r05._run(scale_r05.phase1_command(root, ["ClearNoon"], [
            "val_towns=[CrossClearNoon]"]))
        pools = scale_r05.pool_sizes(root)
        stages = scale_r05.train(root, ["ClearNoon"], runs=["mmfn_rad"], extra=[
            f"epochs={R05_EPOCHS}", "val_every=1", *R05_TRAIN_EXTRA])
    with open(log) as f:
        text += f.read()
    logdir = os.path.join(root, "log", "mmfn_rad")
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    best = scale_r05.best_checkpoints(root)
    shutil.rmtree(root, ignore_errors=True)
    frames = sum(leg["frames"] for leg in legs)
    require(frames > 0, f"frames collected:\n{text[-3000:]}")
    require(pools["train"] >= 96, f"phase 1 wrote a training pool of one batch of 96 at "
                                  f"least: {pools}\n{text[-3000:]}")
    losses = [r["loss"] for r in rows if "loss" in r]
    epoch_s = [r["epoch_minutes"] * 60 for r in rows if "epoch_minutes" in r]
    peak = [r["peak_memory_gib"] for r in rows if "peak_memory_gib" in r]
    require(len(losses) == R05_EPOCHS and all(math.isfinite(v) for v in losses),
            f"finite training losses, one an epoch: {losses}")
    require(best == [os.path.join(logdir, "best_model.pth")], f"best_model.pth: {best}")
    require(bool(peak), "phase2 reports its peak card memory")
    summary = {"gpu": gpu, "frames": frames, "collect_seconds": legs[0]["seconds"],
               "collect_waited_seconds": waited,
               "phase1_samples": pools, "phase1_seconds": phase1_s,
               "train_samples_per_s": pools["train"] // 96 * 96 / epoch_s[-1],
               "epoch_seconds": epoch_s, "train_seconds": stages[0]["seconds"],
               "losses": losses, "val_l1": [r["val_loss"] for r in rows if "val_loss" in r],
               "peak_memory_gib": peak[-1], "launches": {}}
    emit("scale_r05", **summary)
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one NVIDIA GPU", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--rank-task"]:
        return rank_task(sys.argv[2], sys.argv[3], sys.argv[4:])
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
    build_seconds = time.perf_counter() - t0
    emit("build", seconds=build_seconds,
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
    laps("serve")
    graphed = serve_graphs(cfg, dev, ops, pipe, payloads, gpu)
    del pipe
    laps("serve_graphs")
    baselines = serve_baselines(cfg, dev, ops, rng, gpu)
    laps("baselines")
    rows = time_kernels(lidar, attention, dev, rng)
    laps("kernel_times")
    map_tool()
    r05_collector = scale_r05_collect()
    laps("map_tool")
    loop = closed_loop(cfg, ops, gpu)
    laps("closed_loop")
    torch.cuda.empty_cache()
    scenes = scenarios_phase(ops, gpu)
    laps("scenarios")
    torch.cuda.empty_cache()
    world = device_world(cfg, dev, ops, rng, gpu, lidar, attention, rows)
    laps("device_world")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as model_root:
        data = data_path(ops, gpu, dev, model_root)
        laps("data_path")
        torch.cuda.empty_cache()
        runner = benchmark_phase(ops, gpu, model_root)
        laps("benchmark")
        torch.cuda.empty_cache()
        parallel = multi_process_phase(cfg, dev, ops, rng, gpu,
                                       os.path.join(model_root, "pools"),
                                       data["phase2_samples_per_s_by_epoch"])
        laps("multi_process")
        torch.cuda.empty_cache()
    training = run_training(cfg, dev, ops)
    laps("training")
    emit("data_path_summary", **data, training_f32_samples_per_s_synthetic=training[
        "f32_samples_per_s"])
    benched = bench_phase(ops, gpu)
    laps("bench")
    soaked = bench_loop_phase(ops, gpu)
    laps("bench_loop")
    exported = export_phase(ops, gpu, dev)
    laps("export")
    looked = introspection_phase(ops, gpu, dev)
    laps("introspection")
    grafted = pretrained_phase(ops, gpu, dev)
    laps("pretrained")
    carla = carla_phase(ops, gpu, build_seconds)
    laps("carla_tools")
    torch.cuda.empty_cache()
    scale_r05_phase(gpu, r05_collector)
    laps("scale_r05")

    # the launches of the served paths: MMFN-rad's requests, the baselines'
    # ticks, the closed loop's four phase0 runs, the storyboard and the
    # scenario runner, the device world's forwards, phase0 runs and fleets,
    # the data path's validation and serving, the bench's pipeline steps and
    # fleets, bench_loop's soaks and fleet, the exported artifacts' forwards,
    # introspection's fused forward, the pretrained run, the multi-process
    # phase (its ranks report their own counts; the benchmark runner's legs
    # launch in their own processes and are not counted here) and the CARLA
    # glue's MMFN-rad runs and record_episode
    for b in baselines.values():
        for name, n in b["launches"].items():
            launches[name] += n
    for phase in (graphed, loop, scenes, world, data, benched, soaked, exported, looked,
                  grafted, parallel, carla):
        for name, n in phase["launches"].items():
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
    emit("slice9_summary", gpu=gpu, bench=benched["line"],
         bench_loop={"soak": soaked["soak"], "fleet": soaked["fleet"]},
         benchmark={k: runner[k] for k in ("driving_scores", "leg_seconds", "card_memory_peak")},
         export={k: exported[k] for k in ("exported_on_cuda", "exported_on_cpu",
                                          "attention_host_us_per_call")})
    emit("timing", gpu=gpu, seconds=laps.seconds, total_seconds=laps.total())
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
