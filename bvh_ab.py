"""The nearest-hit kernels of this tree against those of another checkout
(its parent), on one CUDA device: frames, work and times, the two trees in
turns in one run.

    git archive <parent> | tar -x -C build/parent    # build/ is git-ignored
    python3 bvh_ab.py build/parent

Each tree runs in worker processes of its own (this script with
`--worker`), which import that tree's `tracer_torch` and build its kernels
into its own `build/tracer_torch/`:

- a ptxas worker builds megakernel.cu with the default flags and reads its
  ptxas lines (registers, stack frame and spills). The instantiations
  whose lines differ from the parent's, or that the parent lacks, are
  printed beside the parent's; the uncounted ones among those the parent
  has name the families that the time workers time: the brute kernels
  (K1, K1-rec, brute K1-ref: ISECT 0) and the BVH kernels (K1-bvh,
  K1-bvh-ref: ISECT 2). A trailing template flag that the parent's
  trace_kernel lacks (RTIOW) is left out of the names where it is false,
  so an instantiation keeps its parent's name. The lines of the three
  instantiations that the benchmark's cells time (`TIMED`) are printed
  beside the parent's, moved or not;
- check workers build megakernel.cu with `-fmad=false`, so that every
  float operation rounds as written, and render both families at three
  shapes: canonical 64x48 spp2 d5 textured, the 2000-sphere field 256x192
  spp2 d10, canonical 800x600 spp32 d50 textured. K1, K1-bvh (uncounted
  and counted, with the counters), K1-ref and K1-bvh-ref, and on the
  canonical scene K1-rec's frame, index tape and 13-field texture tape at
  spp2 (by their sha256). K1 and K1-bvh also at the benchmark cells'
  launches: one 172-spp launch of config.txt's frame 0 at 1080x720 d50
  textured, one 16-spp launch of the field at 3840x2160 d50 from its pose,
  one 139-spp launch of the RTIOW final scene at 1200x800 d50 (the tree's
  rtbench/ builds it). Frames and tapes must be bit-equal between the
  trees, and the counted launches' counters that the pixels' paths fix
  equal (`SAME`: queries, hits, groups or leaves reached, primitive
  tests, node tests, samples). The warp-level counters (passes, active
  lanes and lane use, drained passes) depend on which lane took which
  pixel from the launch's pool, and are printed for both trees. Where the
  trees' BVH builders give other trees for these scenes (their arrays are
  compared too), K1-bvh's family moved: its counted launches must keep
  their queries, hits and samples, and its other counters are printed;
- time workers build with the default flags and time the moved families:
  K1-bvh at the shapes of this tree's chip_smoke.py phase 13
  (`chip_smoke.bvh_times`) and at the field's and the RTIOW scene's cell
  launches, the brute kernels at `k1_times`' shapes, each
  called with the worker's own tree's `tracer_torch`. TURNS turns run
  parent, change, change, parent, parent, change, ...; each shape's line
  gives every turn's time, the ratio of the best times and the spread of
  the ratios within turns.

The card's name and power limit (nvidia-smi) go beside the numbers; the
summary goes to build/bvh_ab/summary.json. Exits 1 if a frame, a tape or
a count differs, or a worker fails.
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
        if m:  # without the anonymous namespace's per-file hash, nor a false 7th flag
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", m.group(1))
            name = re.sub(r"(trace_kernelI(?:L[bi]\d+E){6})Lb0E(E)", r"\1\2", name)
            out[name] = []
        elif name and ("Used" in line or "spill" in line):
            out[name].append(line.strip().removeprefix("ptxas info    : "))
    return out


def flags(name: str):
    """trace_kernel's seven template flags from a ptxas_lines name (a false
    7th flag dropped there), or None for another kernel."""
    m = re.search(r"trace_kernelI((?:L[bi]\d+E)+)E", name)
    if not m:
        return None
    got = tuple(int(x) for x in re.findall(r"L[bi](\d+)E", m.group(1)))
    return got + (0,) * (7 - len(got))


def lanes(c: dict) -> str:
    """The warp-level counters of one counted launch, with its lane use: the
    lanes take their pixels from the launch's pool in the order they reach
    it, so these move from launch to launch and are printed, not compared."""
    use = c["active_lanes"] / (32 * c["passes"]) if c["passes"] else 0.0
    return (f"passes {c['passes']}, active lanes {c['active_lanes']} (lane use {use:.5f}), "
            f"drained passes {c.get('drained_passes', '-')}")


def family(name: str):
    """"brute" for K1's, K1-rec's and brute K1-ref's uncounted (timed)
    instantiations (ISECT 0), "bvh" for K1-bvh's and K1-bvh-ref's (ISECT 2),
    else None (the counted ones, which count what a change may add)."""
    m = re.search(r"trace_kernelILb\dELi(\d)ELb\dELb\dELb(\d)E", name)
    return {"0": "brute", "2": "bvh"}.get(m.group(1)) if m and m.group(2) == "0" else None


# the counters that the pixels' paths fix, whatever lane renders a pixel
SAME = ("queries", "hits", "visits", "tests", "node_tests", "samples")
# those that a new tree leaves as they were (its walks are other walks)
SAME_TREE = ("queries", "hits", "samples")
COUNT_NAMES = ("queries", "hits", "visits", "tests", "passes", "active_lanes", "node_tests",
               "samples", "scatter_passes", "mixed_passes",
               "drained_passes")  # megakernel.COUNT_NAMES
# the instantiations the benchmark's cells time: trace_kernel's template flags
# (RECORD, ISECT, SMEM, NSMEM, COUNT, REF, RTIOW)
TIMED = {"field_2k.frames_bvh": (0, 2, 0, 0, 0, 0, 0),
         "rtiow_final.frames_bvh_auto": (0, 2, 1, 0, 0, 0, 1),
         "config_txt.frames": (0, 0, 1, 0, 0, 0, 0)}


def k1_times(smoke, dev, canon, cams, p):
    """The brute kernels' timed shapes, {shape: ms}: K1 on the canonical
    scene at 800x600 spp32 d50 textured (best of cams[1:]) and with its
    records in global memory, K1-ref there, the sum of one 172-spp launch
    at 1080x720 d50 (the benchmark's chunk) on frames 0, 4, 8 and 12,
    K1-rec at 800x600 spp32 d8 with 9 and 13 tape fields (the fit's shape;
    its tapes' fill included), and one l2_grads_deep(texture_grads=True)
    step at 800x600 spp32 d50 in chunks of 8 (chip_smoke.py's main
    gradient path; host clock, best of 2)."""
    import torch

    from tracer_torch.kernels import bwd
    from tracer_torch.kernels import megakernel as mk
    from tracer_torch.render import camera as C

    def t(**kw):
        return smoke.best_of_cameras(canon, cams, W, H, 32, 50, **kw)

    out = {"canonical textured spp32 d50": t(),
           "K1-ref canonical textured spp32 d50": t(rng_mode="reference")}
    saved, mk.TABLE_SHARED_BYTES_MAX = mk.TABLE_SHARED_BYTES_MAX, -1
    try:
        out["canonical textured, records in global memory"] = t()
    finally:
        mk.TABLE_SHARED_BYTES_MAX = saved
    frames = [C.camera_at(p.camera_path, k, p.num_frames, 1080, 720, p.fov_degrees, device=dev)
              for k in (0, 4, 8, 12)]
    mk.render_frame_kernel(canon, frames[0], 1080, 720, 172, 50)
    out["1080x720 spp172 d50, frames 0, 4, 8, 12"] = sum(
        smoke.cuda_ms(lambda c=c: mk.render_frame_kernel(canon, c, 1080, 720, 172, 50))
        for c in frames)
    for fields in (9, 13):
        rec = lambda c: mk.render_frame_kernel_record(canon, c, W, H, 32, 8, tape_fields=fields)
        rec(cams[0])
        out[f"K1-rec spp32 d8, {fields} fields"] = min(smoke.cuda_ms(lambda c=c: rec(c))
                                                       for c in cams[1:])
    truth = canon._replace(materials=canon.materials._replace(
        albedo=canon.materials.albedo * 0.85))
    target = mk.render_frame_kernel(truth, cams[1], W, H, 32, 50) / 32
    step = lambda: bwd.l2_grads_deep(canon, cams[1], target, W, H, 32, 50, spp_chunk=8,
                                     texture_grads=True)
    step()
    best = float("inf")
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    out["l2_grads_deep(texture_grads=True) spp32 d50, chunks of 8"] = best
    return out


def worker(tree: str, role: str, out: str, families: str) -> int:
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
    res = {"ptxas": ptxas_lines(build.log), "build_s": build.seconds}
    if role == "ptxas":
        with open(out + ".json", "w") as f:
            json.dump(res, f)
        return 0
    dev = torch.device("cuda", 0)
    p = config.read_scene_params(io.StringIO(config.default_config_text()))
    canon = builders.create_scene(p, with_bvh=True, texture_loader=smoke.synthetic_floor,
                                  device=dev)
    cam_at = lambda k, w, h, **kw: C.camera_at(p.camera_path, k, p.num_frames, w, h,
                                               p.fov_degrees, device=dev, **kw)
    field, _ = sphere_field(2000, dev)
    field = field._replace(bvh=bb.build_scene_bvh_from_scene(field))
    cams = [cam_at(k, W, H) for k in range(4)]
    field_cam = C.build_camera_data([80.0, 0.0, 36.0], [0.0, 0.0, 3.0], 3840, 2160, 55.0,
                                    device=dev)
    from rtbench.harness import spec  # the tree's own

    with open(os.path.join(tree, "rtbench", "configs", "rtiow_final.json")) as f:
        rt_cfg = json.load(f)
    rt_kind = spec.scene_kind("rtiow_final")
    rtiow, rt_params = rt_kind.program(rt_kind.inputs(rt_cfg, 1, dev), rt_cfg, dev, True)
    rt_cam = C.camera_at(rt_params.camera_path, 0, rt_params.num_frames, 1200, 800,
                         rt_params.fov_degrees, device=dev)
    if role == "check":
        import hashlib

        import numpy as np

        shapes = {"canonical 64x48 spp2 d5": (canon, cam_at(0, 64, 48, background=SKY), 64, 48,
                                              2, 5),
                  "field n=2000 256x192 spp2 d10": (field, cam_at(1, 256, 192), 256, 192, 2, 10),
                  "canonical 800x600 spp32 d50": (canon, cams[1], W, H, 32, 50)}
        arrays = {}
        for name, (scene, cam, w, h, spp, d) in shapes.items():
            brute, bvh = (torch.zeros(len(mk.COUNT_NAMES), dtype=torch.int64, device=dev)
                          for _ in range(2))
            arrays[f"{name}|K1"] = mk.render_frame_kernel(scene, cam, w, h, spp, d)
            arrays[f"{name}|K1 counted"] = mk._render(scene, cam, w, h, spp, d, True, None, 0,
                                                      brute)
            arrays[f"{name}|K1-ref"] = mk.render_frame_kernel(scene, cam, w, h, spp, d,
                                                              rng_mode="reference")
            arrays[f"{name}|brute counts"] = brute
            if scene is canon:  # the tapes (GBs at 800x600) by their hash
                rec = mk.render_frame_kernel_record(scene, cam, w, h, 2, d, tape_fields=13)
                for k, a in zip(("fb", "idx", "tex"), rec):
                    digest = hashlib.sha256(a.contiguous().cpu().numpy().tobytes())
                    arrays[f"{name}|K1-rec spp2 {k}"] = np.array(digest.hexdigest())
            arrays[f"{name}|bvh"] = mk.render_frame_kernel(scene, cam, w, h, spp, d,
                                                           intersector="bvh")
            arrays[f"{name}|bvh counted"] = mk._render_bvh(scene, cam, w, h, spp, d, True, None,
                                                           0, bvh)
            arrays[f"{name}|bvh-ref"] = mk.render_frame_kernel(scene, cam, w, h, spp, d,
                                                               intersector="bvh",
                                                               rng_mode="reference")
            arrays[f"{name}|bvh counts"] = bvh
        # the benchmark cells' launches: K1 on config.txt, K1-bvh on the field
        cells = {"config_txt launch 1080x720 spp172 d50": (canon, cam_at(0, 1080, 720), 1080,
                                                           720, 172, "K1"),
                 "field_2k launch 3840x2160 spp16 d50": (field, field_cam, 3840, 2160, 16,
                                                         "bvh"),
                 "rtiow_final launch 1200x800 spp139 d50": (rtiow, rt_cam, 1200, 800, 139,
                                                            "bvh")}
        for name, (scene, cam, w, h, spp, fam) in cells.items():
            counts = torch.zeros(len(mk.COUNT_NAMES), dtype=torch.int64, device=dev)
            fn, kw = (mk._render, {}) if fam == "K1" else (mk._render_bvh, {"intersector": "bvh"})
            arrays[f"{name}|{fam}"] = mk.render_frame_kernel(scene, cam, w, h, spp, 50, **kw)
            arrays[f"{name}|{fam} counted"] = fn(scene, cam, w, h, spp, 50, True, None, 0, counts)
            arrays[f"{name}|{'brute' if fam == 'K1' else 'bvh'} counts"] = counts
        for name, scene in (("canonical", canon), ("field n=2000", field), ("rtiow_final", rtiow)):
            arrays[f"{name}|tree"] = np.concatenate([a.flatten().cpu().numpy().view(np.int32)
                                                     for a in scene.bvh])
        torch.cuda.synchronize()
        np.savez(out + ".npz", **{k: v if isinstance(v, np.ndarray) else v.cpu().numpy()
                                  for k, v in arrays.items()})
    else:
        res["ms"] = {}
        if "brute" in families.split(","):
            res["ms"].update(k1_times(smoke, dev, canon, cams, p))
        if "bvh" in families.split(","):
            res["ms"].update(smoke.bvh_times(dev, canon, field, cams, W, H))
            for name, (scene, cam, w, h, spp) in {
                    "field_2k launch 3840x2160 spp16 d50": (field, field_cam, 3840, 2160, 16),
                    "rtiow_final launch 1200x800 spp139 d50": (rtiow, rt_cam, 1200, 800, 139)
            }.items():
                launch = lambda: mk.render_frame_kernel(scene, cam, w, h, spp, 50,
                                                        intersector="bvh")
                launch()
                res["ms"][name] = smoke.cuda_ms(launch, reps=3)
    with open(out + ".json", "w") as f:
        json.dump(res, f)
    return 0


def run_worker(tree, role, tag, families=""):
    out = os.path.join(OUT, tag)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree, role, out,
                           families], capture_output=True, text=True, timeout=1500)
    print(f"  worker {tag}: rc {proc.returncode} in {time.perf_counter() - t0:.1f} s", flush=True)
    if proc.returncode != 0:
        print(proc.stdout[-2000:] + proc.stderr[-4000:], flush=True)
        raise RuntimeError(f"worker {tag} failed")
    with open(out + ".json") as f:
        return json.load(f)


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        return worker(*sys.argv[2:6])
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
    for tree in trees.values():  # so that the ptxas workers build and print ptxas lines
        for lib in glob.glob(os.path.join(tree, "build", "tracer_torch", "libtracer_megakernel-*")):
            os.remove(lib)
    # which instantiations moved, with the default flags
    ptx = {name: run_worker(tree, "ptxas", f"ptxas-{name}")["ptxas"]
           for name, tree in trees.items()}
    moved = sorted(n for n in set(ptx["parent"]) | set(ptx["change"])
                   if ptx["parent"].get(n) != ptx["change"].get(n))
    families = sorted({family(n) for n in moved if n in ptx["parent"]} - {None})
    print(f"  ptxas: {len(moved)} instantiations differ from the parent's; timed families "
          f"{families or 'none'}", flush=True)
    for n in moved:
        print(f"    {n}: {' | '.join(ptx['change'].get(n, ['-']))} (parent: "
              f"{' | '.join(ptx['parent'].get(n, ['-']))})", flush=True)
    for cell, want in TIMED.items():  # what the benchmark's cells time, moved or not
        for n in sorted(n for n in ptx["change"] if flags(n) == want):
            print(f"  ptxas, timed by {cell}: change {' | '.join(ptx['change'][n])}; parent "
                  f"{' | '.join(ptx['parent'].get(n, ['-']))}", flush=True)
    ok = True
    # frames, tapes and work, built with -fmad=false
    checks = {name: run_worker(tree, "check", f"check-{name}") for name, tree in trees.items()}
    base, new = (np.load(os.path.join(OUT, f"check-{name}.npz")) for name in trees)
    moved_trees = [k for k in new.files if k.endswith("|tree")
                   and not np.array_equal(base[k], new[k])]
    if moved_trees:
        print(f"  BVH trees that differ from the parent's: {moved_trees}", flush=True)
        families = sorted(set(families) | {"bvh"})
    for key in new.files:
        if key.endswith("|tree"):
            continue
        same = np.array_equal(base[key], new[key])
        extra = ""
        if key.endswith(" counts"):  # the counters the paths fix; the warp-level ones printed
            c, b = (dict(zip(COUNT_NAMES, x[key].tolist())) for x in (new, base))
            fam = key.split("|")[1].split()[0]
            fixed = SAME_TREE if fam == "bvh" and moved_trees else SAME
            same = all(c[n] == b[n] for n in fixed)
            extra = (f" {({n: c[n] for n in fixed})}; change {lanes(c)}; parent {lanes(b)}"
                     + ("" if same else f" (parent's {({n: b[n] for n in fixed})})"))
        elif not same and base[key].shape == new[key].shape and new[key].dtype.kind == "f":
            extra = f" ({int((base[key] != new[key]).sum())} of {new[key].size} values)"
        ok &= same
        print(f"  -fmad=false change vs parent, {key}: {'equal' if same else 'DIFFER'}{extra}",
              flush=True)
    summary = {"card": card, "device": torch.cuda.get_device_name(0), "moved": moved,
               "families": families, "checks_build_s": {n: c["build_s"] for n, c in checks.items()}}
    if families:
        # times, in turns: parent, change, change, parent, parent, change, ...
        order = [name for k in range(TURNS)
                 for name in (("parent", "change") if k % 2 == 0 else ("change", "parent"))]
        times = {name: [] for name in trees}
        for k, name in enumerate(order):
            times[name].append(run_worker(trees[name], "time", f"time-{k}",
                                          ",".join(families))["ms"])
        print(f"times in ms on {torch.cuda.get_device_name(0)} ({card}), run order {order}:",
              flush=True)

        def median_iqr(v):
            q = statistics.quantiles(v, n=4)
            return f"median {statistics.median(v):.3f}, quartiles {q[2] - q[0]:.3f} apart"

        for key in times["parent"][0]:
            pv, cv = ([r[key] for r in times[n]] for n in ("parent", "change"))
            turns = [p / c for p, c in zip(pv, cv)]
            print(f"  {key}: parent {', '.join(f'{v:.3f}' for v in pv)} ({median_iqr(pv)}); "
                  f"change {', '.join(f'{v:.3f}' for v in cv)} ({median_iqr(cv)}); change faster "
                  f"in {sum(t > 1 for t in turns)} of {TURNS} turns; parent/change of the best "
                  f"{min(pv) / min(cv):.3f}, within turns {min(turns):.3f}-{max(turns):.3f} "
                  f"(median {statistics.median(turns):.3f})", flush=True)
        summary.update(order=order, times=times)
    summary["ok"] = bool(ok)
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"bvh_ab: {'every frame, tape and count equal' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
