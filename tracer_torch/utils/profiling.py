"""Profiling and timing utilities (port of tracer/utils/profiling.py).

The reference's observability is a per-frame cudaEvent TSV
(src/camera.cu:333-346). Here: a `torch.profiler` trace context for
op-level analysis (with the card's kernels when there is a card), and a
timer that forces each run to completion.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the block with torch.profiler (CPU activity, and CUDA
    activity when a CUDA device is present) and write a Chrome trace,
    `trace.json`, into `log_dir` (made if missing); view it in
    chrome://tracing or Perfetto. Yields the profiler, whose
    `key_averages()` sums the operations by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def sync(x) -> None:
    """Wait until the device of tensor `x` has finished its queued work
    (nothing to wait for on the CPU)."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def time_fn(fn, *args, iters: int = 3, **kwargs):
    """Median wall time of fn(*args, **kwargs) over `iters` runs, each forced
    to completion, after one warm-up run. Returns (seconds, last result)."""
    out = fn(*args, **kwargs)
    sync(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], out


def mrays_per_s(width: int, height: int, spp: int, seconds: float) -> float:
    """reference camera.cu:344-345 convention: W*H*spp rays per frame."""
    return width * height * spp / seconds / 1e6
