"""Profiling helpers.

``trace(logdir)`` records ``torch.profiler`` with the CPU and CUDA
activities and writes a Chrome trace under ``logdir`` that TensorBoard's
profile plugin or Perfetto opens; ``timeit`` is the host-clock timer that
waits for the device that holds the call's output.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; its trace goes to ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for x in out:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def timeit(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median seconds per call of ``fn(*args)``; each call waits for the
    device of its output's first tensor (nothing for a CPU output)."""
    def run():
        t = _first_tensor(fn(*args))
        if t is not None and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)

    for _ in range(warmup):
        run()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
