"""One run of one cell: the entry adapter's window, then the check against
the reference, the metrics and the result line.

The result is the last line of standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer ones), `device`, with a trace
`breakdown`, and last `checks`: each number compared beside its limit. The
same numbers end standard error.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from typing import NamedTuple

from rtbench.harness import check, ranks, spec


class Ctx(NamedTuple):
    workload: spec.Workload
    seed: int
    seconds: float
    trace: bool
    device: str  # "cuda" on the card; "cpu" in the CPU tests
    engine: str  # render_animation's engine: "cuda" on the card
    t0: float  # perf_counter at process start
    patches: tuple = ()  # "module:function" calls each rank makes first (tests)


def parse(argv):
    p = argparse.ArgumentParser(prog="rtbench/run.py", description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"rtbench: {msg}", file=sys.stderr, flush=True)
    return 2


def card_name_and_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv, t0: float) -> int:
    args = parse(argv)
    import torch

    try:
        wl = spec.workload(args.workload)
    except (KeyError, FileNotFoundError) as e:
        return fail(str(e))
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < wl.chips:
        return fail(f"{args.workload} needs {wl.chips} cards, {torch.cuda.device_count()} seen")
    ctx = Ctx(wl, args.seed, args.seconds, bool(args.trace), "cuda", "cuda", t0)
    return execute(ctx)


def execute(ctx: Ctx, out=None) -> int:
    """Run the cell, judge it and print the result line; returns the exit code."""
    import torch

    out = sys.stdout if out is None else out
    wl = ctx.workload
    res = spec.entry(wl.traffic["entry"]).run(ctx)
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    try:
        nums = check.judge(wl, ctx.seed, res, torch.device(ctx.device))
    finally:
        check.clean(res)
    loaded = sorted(set(res.forbidden) | set(ranks.forbidden_modules()))
    if loaded:
        return fail(f"modules of JAX or the JAX package were loaded: {', '.join(loaded)}")
    if ctx.trace:
        metrics = {}
        for m in wl.per_layer:
            value = spec.metric_reader(m["name"]).read(res.readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in wl.end_to_end}
    cuda = ctx.device == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": wl.chips, "memory_peak_bytes": res.memory_peak_bytes}
    line = {"correct": all(n.ok for n in nums), "attempted": len(res.frames),
            "failed": int(next(n.value for n in nums if n.name == "frames_missing")),
            "metrics": metrics, "device": device}
    if ctx.trace:
        rk = res.readings["ranks"]
        device["busy_s"] = sum(r["busy_s"] for r in rk) / len(rk)
        device["window_s"] = sum(r["window_s"] for r in rk) / len(rk)
        line["breakdown"] = res.readings["breakdown"]
    line["checks"] = {n.name: {"value": n.value if math.isfinite(n.value) else repr(n.value),
                               "limit": n.limit} for n in nums}
    err = sys.stderr
    print(f"rtbench: {wl.name} seed {ctx.seed}: {len(res.frames)} frames {res.frames}, frame ms "
          f"{[round(x, 3) for x in res.frame_ms]}, card {card_name_and_limit() if cuda else 'cpu'}",
          file=err)
    for n in nums:
        print(f"check {n.name} {n.value!r} limit {n.limit!r} {'ok' if n.ok else 'FAIL'}", file=err)
    err.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0
