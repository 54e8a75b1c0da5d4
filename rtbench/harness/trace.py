"""The traced window: torch.profiler over it, reduced to what the per-layer
metrics and the result's `breakdown` read.

The profiler's Chrome trace gives every device activity (kernels, copies,
sets) and every host operation on one clock. The window is the harness's
own span `WINDOW`. Device busy time is the union of device activity inside
it. An idle gap is named by the program's span (rtbench/harness/spans.py)
innermost over most of it, or, where no span of the program is open in it,
by the host operation that overlaps it most.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import NamedTuple

from rtbench.harness import spans as spans_mod

WINDOW = "rtbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Reduced(NamedTuple):
    window_s: float  # the traced window on the trace's clock
    busy_s: float  # union of device activity inside it
    kernels: dict  # kernel name -> [seconds, launches] inside the window
    gaps: list  # [(program span or host operation, seconds)] of the idle gaps, longest first
    device_events: int  # device activities seen inside the window
    launches: dict  # kernel name -> [(start, end)] in seconds from the window's start
    # spans.reduce's readings of the program's spans (rtbench/harness/spans.py)
    spans: dict = {}
    idle_by_span: dict = {}
    span_kernels: dict = {}


def short_name(name: str) -> str:
    """A kernel's name without its trailing argument list and its return
    type, `(anonymous namespace)::` dropped: `trace_kernel<false, 0, ...>`."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.endswith(")"):
        depth = 0
        for k in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[k], 0)
            if depth == 0:
                name = name[:k]
                break
    if name.startswith("void "):
        name = name[5:]
    return name.strip()[:160]


def _union(intervals):
    total, end, merged = 0.0, None, []
    for a, b in sorted(intervals):
        if end is None or a > end:
            merged.append([a, b])
            end = b
        elif b > end:
            merged[-1][1] = b
            end = b
    for a, b in merged:
        total += b - a
    return total, merged


def reduce_events(events) -> Reduced:
    """Reduce a Chrome trace's events (a list of dicts) to the window's
    device busy time, kernels and idle gaps. Raises when the trace holds no
    window span."""
    spans = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
             and e.get("cat") in ("user_annotation", "cpu_op")]
    if not spans:
        raise RuntimeError(f"the trace has no {WINDOW!r} span")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    dev, kernels, launches = [], {}, {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(w0, float(e["ts"]))
        b = min(w1, float(e["ts"]) + float(e.get("dur", 0.0)))
        if b <= a:
            continue
        dev.append((a, b))
        if e["cat"] == "kernel":
            name = short_name(e["name"])
            k = kernels.setdefault(name, [0.0, 0])
            k[0] += (b - a) * 1e-6
            k[1] += 1
            launches.setdefault(name, []).append(((a - w0) * 1e-6, (b - w0) * 1e-6))
    busy, merged = _union(dev)
    program = spans_mod.marks(events)
    cuts = spans_mod.cuts_of(program, w0, w1)
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
            for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    gaps, prev = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > prev:
            name = spans_mod.holder(program, cuts, prev, a)
            if name is None:
                best, name = 0.0, "no host operation recorded"
                for h0, h1, hn in host:
                    ov = min(h1, a) - max(h0, prev)
                    if ov > best:
                        best, name = ov, hn
            gaps.append((name, (a - prev) * 1e-6))
        prev = max(prev, b)
    gaps.sort(key=lambda g: -g[1])
    return Reduced((w1 - w0) * 1e-6, busy * 1e-6, kernels, gaps, len(dev), launches,
                   **spans_mod.reduce(events, w0, w1, merged))


@contextlib.contextmanager
def profiled(enabled: bool, tag: str = "0"):
    """Profile the block (CPU and CUDA activity) when `enabled`; yields a
    list that holds the Reduced trace after the block. The trace file goes
    to a fixed name under the temporary directory and is removed."""
    out = []
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield out
    path = os.path.join(tempfile.gettempdir(), f"rtbench_trace_{tag}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out.append(reduce_events(events))


def window_span():
    """The span that marks the traced window (record it around the window)."""
    import torch

    return torch.profiler.record_function(WINDOW)


def breakdown(red: Reduced) -> dict:
    ops = sorted(red.kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"device_ops": [[n, s] for n, (s, _k) in ops],
            "idle_gaps": [[n, s] for n, s in red.gaps[:TOP]]}
