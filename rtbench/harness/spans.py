"""The program's own spans (`tracer_torch.utils.profiling.span`, names
`tracer.<layer>.<phase>`), reduced to what the span metrics read.

Set-up: the spans a rank recorded in-process (`profiling.take_spans()`,
`time.perf_counter_ns` like the harness's own clock) that ended before the
window started. The window: the spans as `user_annotation` events of the
profiler's Chrome trace, on one clock with the device's kernels and copies,
so that each idle gap and each kernel is placed inside a phase of the
program. Nothing here runs unless the program was run with spans on.
"""

from __future__ import annotations

import bisect

PREFIX = "tracer."
OUTSIDE = "outside the program"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def setup(spans, t0: float, t_start: float) -> list:
    """`[name, start_s, end_s]` of the spans (name, start_ns, end_ns) that
    ended before `t_start`, in seconds from `t0` (both perf_counter
    seconds)."""
    return [[name, a * 1e-9 - t0, b * 1e-9 - t0] for name, a, b in spans
            if b * 1e-9 <= t_start]


def union_s(intervals) -> float:
    """Seconds covered by the union of `(start, end)` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _innermost(spans, t):
    """The innermost span covering time t: the host's spans nest, so of the
    spans that cover t it is the one that started last."""
    best = None
    for name, a, b in spans:
        if a > t:
            break
        if t < b:
            best = name
    return best


def marks(events) -> list:
    """The `tracer.*` annotations of a Chrome trace's events as `(name,
    start, end)` in us, in order of their start."""
    got = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                 for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith(PREFIX))
    return [(n, a, b) for a, b, n in got]


def cuts_of(spans, w0: float, w1: float) -> list:
    """Every span boundary strictly inside (w0, w1), sorted."""
    return sorted({t for _n, a, b in spans for t in (a, b) if w0 < t < w1})


def pieces(spans, cuts, a: float, b: float):
    """[a, b] cut at the span boundaries `cuts`: `(name, us)` a piece, the
    name of the span innermost at its start, or None where none is open."""
    edges = [a, *cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)], b]
    return [(_innermost(spans, x), y - x) for x, y in zip(edges, edges[1:])]


def holder(spans, cuts, a: float, b: float):
    """The span innermost over most of [a, b] (the first of equals), or None
    where no span is open in it."""
    held = {}
    for name, us in pieces(spans, cuts, a, b):
        if name is not None:
            held[name] = held.get(name, 0.0) + us
    return max(held, key=held.get) if held else None


def reduce(events, w0: float, w1: float, busy) -> dict:
    """The window's spans from a Chrome trace's events (times in us), the
    window [w0, w1] and `busy`, the merged intervals of device activity:

    - `spans`: name -> [count, seconds] of the `tracer.*` annotations that
      start inside the window;
    - `idle_by_span`: name -> seconds of device idle time inside the window
      while that span was the innermost one open on the host; idle time
      with no span open under OUTSIDE;
    - `span_kernels`: name -> seconds of the window's kernels whose launch
      (the runtime or driver call with the kernel's correlation id) lies
      in that span, innermost, or OUTSIDE.
    """
    spans = marks(events)
    counted = {}
    for n, a, b in spans:
        if w0 <= a < w1:
            c = counted.setdefault(n, [0, 0.0])
            c[0] += 1
            c[1] += (min(b, w1) - a) * 1e-6

    # idle time cut at every span boundary; each piece goes to the span
    # innermost at its start
    idle, prev = [], w0
    for a, b in list(busy) + [[w1, w1]]:
        if a > prev:
            idle.append((prev, min(a, w1)))
        prev = max(prev, b)
    cuts = cuts_of(spans, w0, w1)
    idle_by = {}
    for a, b in idle:
        for name, us in pieces(spans, cuts, a, b):
            name = name or OUTSIDE
            idle_by[name] = idle_by.get(name, 0.0) + us * 1e-6

    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    kernels = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        a = max(w0, float(e["ts"]))
        b = min(w1, float(e["ts"]) + float(e.get("dur", 0.0)))
        if b <= a:
            continue
        at = launches.get(e.get("args", {}).get("correlation"))
        name = (None if at is None else _innermost(spans, at)) or OUTSIDE
        kernels[name] = kernels.get(name, 0.0) + (b - a) * 1e-6
    return {"spans": counted, "idle_by_span": idle_by, "span_kernels": kernels}
