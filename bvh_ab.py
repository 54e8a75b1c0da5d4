"""K1-bvh of this tree against K1-bvh of another checkout (its parent), on
one CUDA device: frames, work and times of the BVH kernel and its
reference-stream twin, the two trees in turns in one run.

    git archive <parent> | tar -x -C build/parent    # build/ is git-ignored
    python3 bvh_ab.py build/parent

Each tree runs in worker processes of its own (this script with
`--worker`), which import that tree's `tracer_torch` and build its kernels
into its own `build/tracer_torch/`:

- check workers build megakernel.cu with `-fmad=false`, so that every
  float operation rounds as written, and render K1-bvh (its uncounted and
  its counted instantiation, with the counters) and K1-bvh-ref at three
  shapes: canonical 64x48 spp2 d5 textured, the 2000-sphere field 256x192
  spp2 d10, canonical 800x600 spp32 d50 textured. The frames must be
  bit-equal between the trees, and the counted launches' node tests and
  leaves equal;
- time workers build with the default flags and time K1-bvh at the shapes
  of this tree's chip_smoke.py phase 13 (`chip_smoke.bvh_times`, which
  they call with their own tree's `tracer_torch`). TURNS turns run
  parent, change, change, parent, parent, change, ...; each shape's line
  gives every turn's time, the ratio of the best times and the spread of
  the ratios within turns. The first time workers also print each
  build's ptxas lines (registers, stack frame and spills); every
  instantiation other than K1-bvh's must be the parent's.

The card's name and power limit (nvidia-smi) go beside the numbers; the
summary goes to build/bvh_ab/summary.json. Exits 1 if a frame or a
count differs, a ptxas line of another kernel moved, or a worker fails.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "bvh_ab")
W, H = 800, 600
TURNS = 8  # pairs of time workers, one of each tree


def ptxas_lines(log: str) -> dict:
    """{mangled kernel name: its ptxas lines} from `nvcc -Xptxas -v` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:  # without the anonymous namespace's per-file hash
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", m.group(1))
            out[name] = []
        elif name and ("Used" in line or "spill" in line):
            out[name].append(line.strip().removeprefix("ptxas info    : "))
    return out


def is_bvh(name: str) -> bool:
    """K1-bvh's instantiations (ISECT == BVH == 2), K1-bvh-ref's included."""
    return re.search(r"trace_kernelILb\dELi2E", name) is not None


def worker(tree: str, role: str, out: str) -> int:
    sys.path[:0] = [tree, os.path.join(HERE, "tests")]
    import torch

    from torch_scenes import SKY, sphere_field
    from tracer_torch.bvh import builder as bb
    from tracer_torch.kernels import megakernel as mk
    from tracer_torch.kernels import nvcc
    from tracer_torch.render import camera as C
    from tracer_torch.scene import builders, config

    # this tree's chip_smoke.py, whatever tree the worker renders
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    if role == "check":
        nvcc.SOURCE_FLAGS = {**nvcc.SOURCE_FLAGS, "megakernel": ("-fmad=false",)}
    build = nvcc.build_all()["megakernel"]
    dev = torch.device("cuda", 0)
    p = config.read_scene_params(io.StringIO(config.default_config_text()))
    canon = builders.create_scene(p, with_bvh=True, texture_loader=smoke.synthetic_floor,
                                  device=dev)
    cam_at = lambda k, w, h, **kw: C.camera_at(p.camera_path, k, p.num_frames, w, h,
                                               p.fov_degrees, device=dev, **kw)
    field, _ = sphere_field(2000, dev)
    field = field._replace(bvh=bb.build_scene_bvh_from_scene(field))
    cams = [cam_at(k, W, H) for k in range(4)]
    res = {"ptxas": ptxas_lines(build.log), "build_s": build.seconds}
    if role == "check":
        import numpy as np

        shapes = {"canonical 64x48 spp2 d5": (canon, cam_at(0, 64, 48, background=SKY), 64, 48,
                                              2, 5),
                  "field n=2000 256x192 spp2 d10": (field, cam_at(1, 256, 192), 256, 192, 2, 10),
                  "canonical 800x600 spp32 d50": (canon, cams[1], W, H, 32, 50)}
        arrays = {}
        for name, (scene, cam, w, h, spp, d) in shapes.items():
            counts = torch.zeros(len(mk.COUNT_NAMES), dtype=torch.int64, device=dev)
            arrays[f"{name}|bvh"] = mk.render_frame_kernel(scene, cam, w, h, spp, d,
                                                           intersector="bvh")
            arrays[f"{name}|bvh counted"] = mk._render_bvh(scene, cam, w, h, spp, d, True, None,
                                                           0, counts)
            arrays[f"{name}|bvh-ref"] = mk.render_frame_kernel(scene, cam, w, h, spp, d,
                                                               intersector="bvh",
                                                               rng_mode="reference")
            arrays[f"{name}|counts"] = counts
        torch.cuda.synchronize()
        np.savez(out + ".npz", **{k: v.cpu().numpy() for k, v in arrays.items()})
    else:
        res["ms"] = smoke.bvh_times(dev, canon, field, cams, W, H)
    with open(out + ".json", "w") as f:
        json.dump(res, f)
    return 0


def run_worker(tree, role, tag):
    out = os.path.join(OUT, tag)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree, role, out],
                          capture_output=True, text=True, timeout=1500)
    print(f"  worker {tag}: rc {proc.returncode} in {time.perf_counter() - t0:.1f} s", flush=True)
    if proc.returncode != 0:
        print(proc.stdout[-2000:] + proc.stderr[-4000:], flush=True)
        raise RuntimeError(f"worker {tag} failed")
    with open(out + ".json") as f:
        return json.load(f)


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        return worker(*sys.argv[2:5])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", help="a checkout of the tree to compare with")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bvh_ab: needs a CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    trees = {"parent": os.path.abspath(args.parent), "change": HERE}
    print(f"bvh_ab on {torch.cuda.get_device_name(0)} ({card}); {TURNS} turns", flush=True)
    for tree in trees.values():  # so that the first workers print ptxas lines
        for lib in glob.glob(os.path.join(tree, "build", "tracer_torch", "libtracer_megakernel-*")):
            os.remove(lib)
    ok = True
    # frames and work, built with -fmad=false
    checks = {name: run_worker(tree, "check", f"check-{name}") for name, tree in trees.items()}
    base, new = (np.load(os.path.join(OUT, f"check-{name}.npz")) for name in trees)
    for key in new.files:
        same = np.array_equal(base[key], new[key])
        ok &= same
        extra = ""
        if key.endswith("|counts"):
            c = dict(zip(("queries", "hits", "visits", "tests", "passes", "active_lanes",
                          "node_tests"), new[key].tolist()))
            extra = f" {c}"
        print(f"  -fmad=false change vs parent, {key}: {'equal' if same else 'DIFFER'}{extra}",
              flush=True)
    # times, in turns: parent, change, change, parent, parent, change, ...
    order = [name for k in range(TURNS)
             for name in (("parent", "change") if k % 2 == 0 else ("change", "parent"))]
    times = {name: [] for name in trees}
    for k, name in enumerate(order):
        res = run_worker(trees[name], "time", f"time-{k}")
        times[name].append(res["ms"])
        if k == 0:
            parent_ptx = res["ptxas"]
        elif k == 1:
            moved = [n for n in set(parent_ptx) | set(res["ptxas"])
                     if not is_bvh(n) and parent_ptx.get(n) != res["ptxas"].get(n)]
            ok &= not moved
            print(f"  ptxas: {len(moved)} non-BVH instantiations differ from the parent's {moved}",
                  flush=True)
            for n, lines in sorted(res["ptxas"].items()):
                if is_bvh(n):
                    print(f"    {n}: {' | '.join(lines)} (parent: "
                          f"{' | '.join(parent_ptx.get(n, ['-']))})", flush=True)
    print(f"times in ms on {torch.cuda.get_device_name(0)} ({card}), run order {order}:",
          flush=True)
    def median_iqr(v):
        q = statistics.quantiles(v, n=4)
        return f"median {statistics.median(v):.3f}, quartiles {q[2] - q[0]:.3f} apart"

    for key in times["parent"][0]:
        pv, cv = ([r[key] for r in times[n]] for n in ("parent", "change"))
        turns = [p / c for p, c in zip(pv, cv)]
        print(f"  {key}: parent {', '.join(f'{v:.3f}' for v in pv)} ({median_iqr(pv)}); change "
              f"{', '.join(f'{v:.3f}' for v in cv)} ({median_iqr(cv)}); change faster in "
              f"{sum(t > 1 for t in turns)} of {TURNS} turns; parent/change of the best "
              f"{min(pv) / min(cv):.3f}, within turns {min(turns):.3f}-{max(turns):.3f} "
              f"(median {statistics.median(turns):.3f})", flush=True)
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump({"card": card, "device": torch.cuda.get_device_name(0), "order": order,
                   "times": times, "checks_build_s": {n: c["build_s"] for n, c in checks.items()},
                   "ok": bool(ok)}, f, indent=1)
    print(f"bvh_ab: {'every frame and count equal, no other kernel moved' if ok else 'FAIL'}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
