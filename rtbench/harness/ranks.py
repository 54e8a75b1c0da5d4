"""Ranks beyond the first: one spawned process a rank, each running the
cell's entry adapter with the same context; and the check that no process
of a run loaded the JAX package or JAX itself."""

from __future__ import annotations

import importlib
import multiprocessing as mp
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "tracer")  # top-level module names, compared whole
JOIN_TIMEOUT_S = 300.0


def forbidden_modules() -> list:
    """The loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN: `tracer_torch` is not `tracer`."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def call(patch: str) -> None:
    """Call `module:function` (a test's fault, applied in every rank)."""
    mod, fn = patch.split(":")
    getattr(importlib.import_module(mod), fn)()


def _child(ctx, rank: int, world: int, port: int) -> None:
    from rtbench.harness import spec

    spec.entry(ctx.workload.traffic["entry"]).rank_main(ctx, rank, world, port)


def start(ctx, world: int, port: int) -> list:
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=_child, args=(ctx, r, world, port), daemon=True)
             for r in range(1, world)]
    for p in procs:
        p.start()
    return procs


def join(procs) -> None:
    """Wait for every rank; end any that outlives JOIN_TIMEOUT_S, and raise
    if one failed."""
    bad = []
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
        if p.is_alive():
            p.terminate()
            p.join(30)
            bad.append(f"{p.name} did not end")
        elif p.exitcode != 0:
            bad.append(f"{p.name} exited {p.exitcode}")
    if bad:
        raise RuntimeError("ranks failed: " + "; ".join(bad))
