"""Profiling utilities (port of tracer/utils/profiling.py) and the
program's named spans.

The reference's observability is a per-frame cudaEvent TSV
(src/camera.cu:333-346). Here: a `torch.profiler` trace context for
op-level analysis (with the card's kernels when there is a card), and
`span`, which names the program's own phases (set-up, the frame loop, the
row bands) when spans are turned on.

Spans are named `tracer.<layer>.<phase>` and are off unless
`set_spans(True)`: then each records `(name, start_ns, end_ns)` on
`time.perf_counter_ns()` into an in-process list (`take_spans`) and enters
`torch.profiler.record_function(name)`, so under a profiler the span is a
`user_annotation` on the same clock as the device's kernels and copies.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_SPANS_ON = False
_SPANS: list = []
_NO_SPAN = contextlib.nullcontext()


def set_spans(on: bool) -> None:
    """Turn the program's spans on or off (off at import)."""
    global _SPANS_ON
    _SPANS_ON = bool(on)


def span(name: str):
    """A context manager that records the block as the span `name` when
    spans are on; when they are off, one shared context that does nothing
    (no clock read, no allocation, no synchronize)."""
    if not _SPANS_ON:
        return _NO_SPAN
    return _Span(name)


def take_spans() -> list:
    """The spans recorded since the last call, `(name, start_ns, end_ns)`
    in order of their start; clears the list."""
    global _SPANS
    spans, _SPANS = _SPANS, []
    return sorted(spans, key=lambda s: s[1])


class _Span:
    __slots__ = ("name", "start", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.annotation.__exit__(*exc)
        _SPANS.append((self.name, self.start, end))
        return False


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
