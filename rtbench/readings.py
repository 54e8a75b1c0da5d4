"""The readings a cell's limits are set from: for each seed, one short window
of the program and its numbers against the reference, and with --control
the same numbers for the reference in bfloat16 put in the program's place.
One process for all seeds, so the build and the set-up are paid once.

    python3 rtbench/readings.py --workload <name> --seeds 1,2,3 --seconds 5 [--control]

One JSON line a seed; the benchmark's runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--patch", action="append", default=[],
                   help="module:function that breaks the program first (rtbench/tests/faults.py)")
    args = p.parse_args(argv)
    import torch

    from rtbench.harness import check, runner, spec

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    wl = spec.workload(args.workload)
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = runner.Ctx(wl, seed, args.seconds, False, "cuda", "cuda", time.perf_counter(),
                         tuple(args.patch))
        res = spec.entry(wl.traffic["entry"]).run(ctx)
        t = time.perf_counter()
        try:
            prog = check.judge(wl, seed, res, dev)
        finally:
            check.clean(res)
        line = {"seed": seed, "frames": res.frames, "e2e": res.end_to_end,
                "reference_s": time.perf_counter() - t,
                "program": {n.name: n.value for n in prog}}
        if args.control:
            t = time.perf_counter()
            line["control"] = {n.name: n.value for n in check.control(wl, seed, res, dev)}
            line["control_s"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        del res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
