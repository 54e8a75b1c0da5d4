"""A cell cut to a CPU-sized run for the tests: the same files, the scene
shrunk by its scene kind's `tiny` (config.txt and the field: 24x16 frames,
16 spp, depth 5; a 60-sphere field), the plain renderer (engine "torch")
on the CPU, gloo for several ranks.

    python rtbench/tests/tiny.py <workload> <seed> <seconds> <trace> [module:function ...]

prints the run's result line; the optional calls break the program first,
in every rank (rtbench/tests/faults.py)."""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny(wl):
    """The cell with its scene kind's `tiny` cut of the configuration, and
    every pixel of a 24x16 frame judged."""
    from rtbench.harness import spec

    cut = getattr(spec.scene_kind(wl.config["scene"]), "tiny", dict)
    return wl._replace(config=cut(dict(wl.config)),
                       check=dict(wl.check, pixels_per_frame=24 * 16))


def workload(name):
    """BENCHMARK.json's cell, or for a name `<config>.<traffic>` that is not
    a cell (yet), the cell those two files make."""
    from rtbench.harness import spec

    bench = spec.benchmark()
    if name not in {w["name"] for w in bench["workloads"]}:
        config, traffic = name.split(".", 1)
        ranks = spec.load_json(spec.BENCH_DIR / "traffic" / f"{traffic}.json").get("ranks", 1)
        bench = dict(bench, workloads=bench["workloads"] + [
            {"name": name, "config": config, "traffic": traffic, "chips": ranks, "why": name}])
    return spec.workload(name, bench)


def ctx(name, seed, seconds, trace=False, patches=()):
    from rtbench.harness import runner

    return runner.Ctx(tiny(workload(name)), seed, seconds, trace, "cpu", "torch", T0,
                      tuple(patches))


def main(argv):
    import torch

    from rtbench.harness import runner

    torch.set_num_threads(1)
    name, seed, seconds, trace = argv[0], int(argv[1]), float(argv[2]), bool(int(argv[3]))
    return runner.execute(ctx(name, seed, seconds, trace, argv[4:]))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
