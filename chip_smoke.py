#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. Device: the card's name and power limit.
2. Build: compiles every tracer_torch/csrc/*.cu with nvcc, one process per
   source, all started together (megakernel.cu, bwd.cu, tex_scatter.cu),
   and prints ptxas's registers and spills for every instantiation.
3. Each kernel against its plain PyTorch version, on the card, on the same
   inputs:
   - the forward megakernel (K1): smoke scene (quirk on and off), a partial
     tile, an 8x8 texture, the canonical scene with a synthetic 1330x2000
     floor texture (its records in shared memory, and in global memory),
     rr_start=3, and two sample chunks against one shot. A
     pixel agrees when its max channel |diff| < 1e-3 (float32
     reassociation and FMA contraction flip razor-edge hits, after which a
     sample takes another valid path); >= 99% of pixels must agree and the
     frame means must agree to a relative 1e-3;
   - the record mode (K1-rec) against the plain recording renderer: >= 99%
     of index-tape slots equal, the frame by K1's rule, and on >= 99% of
     those slots every texture field within 1e-3 of its scale (its max over
     the tape, at least 1: the derivative fields grow with the texture's
     size);
   - the backward kernel (K2) against the plain replay, both fed the same
     kernel-recorded tape, on the smoke scene and the canonical scene at a
     small shape: every scene and camera leaf within 1e-4 of its max|g|
     (atomics add in no fixed order; the kernel's cbrtf and the plain
     version's float64 cube root may differ in the last bit), the replayed
     frame within 1e-4 of the recorded one relative to its max (the record
     kernel contracts to FMA, the backward kernel does not);
   - the texture scatter (K3) against the plain index_add_ version, rtol
     1e-5, atol 1e-5;
   - render_frame_diff on the card against central finite differences in
     a sphere's z (rtol 2e-2, tests/test_grad.py's tie-free scene with a
     ramp texture on that sphere, so that the gradient is not 0).
4. Main render path at real size: render_animation(engine="cuda") on the
   canonical config (199 primitives, 1080x720, depth 50, synthetic floor
   texture), cut to 2 frames and sqrt_spp 4 for the time limit; checks the
   saved frames, K1's launch count, and a sample of pixels against the
   plain version. Then the CLI once, as a subprocess.
5. K1 at 800x600, spp 32, depth 50: Mrays/s textured, untextured and with
   rr_start=3 (best of 3 frames after a warm-up), each with its nearest-hit
   queries, hits and lane utilisation from the counted instantiation
   (megakernel.loop_work), and textured with the records in global memory
   instead of shared; the plain version at the same shape, textured,
   timed and held to the kernel's frame per pixel on its estimate (raw sum
   / spp, as phase 9's record frame); K1's bound from the exact queries.
6. Main gradient path at full width: opt.fit.fit(engine="cuda") on the
   canonical textured scene at 800x600, spp 32, depth 8, 3 Adam steps on
   materials.albedo and spheres.center toward a target rendered from a
   perturbed scene; the loss must be finite and lower at the end, and K1-rec
   and K2 must each launch 3 times.
7. One render_frame_diff(texture_grads=True) backward at that shape: K3
   launches once; the texture's cotangent is finite and non-zero.
8. `tracer_torch.cli --gpu --fit` on the default config cut to sqrt_spp 2,
   depth 8, 2 steps, as a subprocess.
9. The gradient path at the main shape:
   - K1-rec, K2 and K3 against their plain versions on the same inputs,
     by phase 3's rules (K2 and the plain replay fed the same
     kernel-recorded tape), except that the record's frame is judged per
     pixel on its estimate (raw sum / spp): K1-rec keeps the forward's FMA
     contraction, whose last-bit hit points, read through the noise floor
     texture (texel slopes near 2000 per unit of u) and summed over 32
     samples of bright paths, move about 1% of the raw sums by more than
     1e-3;
   - their times beside K1's (depth 8), the plain versions' and one
     index_add_ of the pre-weighted corners, and the fwd+bwd rate of one
     render_frame_diff step; K1's and K1-rec's lane utilisation; K2's
     grid (one wave of resident blocks); the mean number of distinct
     winners per group of 32 neighbouring pixels and tape row;
   - each kernel's bound (the larger of its FP32 operations over 67
     TFLOP/s and its bytes over 3.35 TB/s, counting the queries the
     counted instantiation saw and the slots this run's tapes hold).
10. The cluster-culled kernel (K1-cl) on benchmarks/prim_scaling.py's
    sphere field (2,000 spheres and a floor quad, bench.py's 2000-sphere
    scene), k = 16:
   - against its plain version (render_frame(cluster_k=16)) at 800x600,
     spp 2, depth 20, camera path frame 1, by phase 3's rules, both timed;
     its bound there (the larger of FP32 operations over 67 TFLOP/s and
     bytes over 3.35 TB/s: per nearest-hit query one slab test per
     cluster, plus the primitive tests of the visited clusters, both
     counted by the kernel's counted instantiation (megakernel.loop_work)
     in one launch, which is also timed beside the uncounted one);
   - the main path of this phase: render_frame_kernel(cluster_k=16) at
     800x600, spp 8, depth 20 on camera path frames 1-3 (bench.py's
     2000-sphere line), each frame against K1's on the same inputs by
     phase 3's rules, with the share of bit-equal pixels (built without
     FMA contraction the two kernels give bit-equal frames; with it, nvcc
     contracts their shared float code differently, and this field's
     paths amplify the last-bit differences); K1-cl's launch count;
   - K1 and K1-cl times at that shape, with and without rr_start=3 (best
     of 3 frames after a warm-up), with their lane utilisation, and again
     with the field's records in shared memory instead of global; and on
     prim_scaling.py's sweep (records in shared memory up to n = 1000,
     in global memory above): n in
     {2000, 5000, 10000, 20000} spheres and, for the crossing point, 250,
     500 and 1000; 800x600, spp 4, depth 10, rr_start=3, its camera (best
     of 3 after a warm-up).

The line before the last is a JSON object describing the kernels, with the
card's name and power limit on the line before it; the last is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TOL_PIXEL, TOL_FRAC, TOL_MEAN = 1e-3, 0.99, 1e-3
TOL_GRAD = 1e-4  # K2 against the plain replay, relative to each leaf's max|g|
# the card's peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit)
PEAK_FP32 = 67e12  # FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # bytes/s of HBM
# FP32 operations a kernel cannot avoid, counted from the sources' formulas
# as lower bounds: a ray-sphere test (oc, oc.d, oc.oc - r^2, disc, sqrt,
# t_near), a ray-plane test (n.d, n.o, the root), the shading of a hit
# bounce (normal, scatter directions, throughput), the adjoint of a hit
# bounce (its recompute and reverse, twice the forward shading at least),
# and one texel cotangent scattered to its four corners (weights and 12
# products).
OPS_SPHERE, OPS_PLANE, OPS_SHADE, OPS_ADJOINT, OPS_SCATTER = 20, 12, 60, 300, 30
# a ray against a cluster box: 6 differences and 6 products, the per-axis
# min and max, the interval's 3 max and 3 min, and the comparison
OPS_SLAB = 25
CLUSTER_K = 16


def instantiation(line: str) -> str:
    """A ptxas 'Compiling entry' line's kernel, by name and template arguments."""
    import re

    m = re.search(r"trace_kernelILb(\d)ELb(\d)ELb(\d)ELb(\d)E", line)
    if m:
        rec, clu, smem, count = (x == "1" for x in m.groups())
        name = "K1-rec" if rec else ("K1-cl" if clu else "K1")
        return (f"{name}, records in {'shared' if smem else 'global'} memory"
                + (", counted" if count else ""))
    m = re.search(r"bwd_kernelILb(\d)E", line)
    if m:
        return f"K2, dtable in {'shared' if m.group(1) == '1' else 'global'} memory"
    return "K3" if "scatter_kernel" in line else line


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def compare(name, got, want, errs, spp=1):
    """Kernel frame against the plain frame; prints and returns the verdict.
    With spp > 1 a pixel is judged on its estimate, the raw sum over spp."""
    import torch

    got, want = got.double(), want.double()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        print(f"  {name}: non-finite values")
        return False
    d = (got - want).abs().amax(dim=-1)
    frac = (d / spp < TOL_PIXEL).double().mean().item()
    mean_k, mean_p = got.mean().item(), want.mean().item()
    rel = abs(mean_k - mean_p) / max(abs(mean_p), 1e-30)
    lit = (want.amax(dim=-1) > 0).double().mean().item()
    ok = frac >= TOL_FRAC and rel < TOL_MEAN and mean_p > 0
    errs.append(d.max().item())
    print(f"  {name}: agree {frac:.6f} (>= {TOL_FRAC}), max|diff| {d.max().item():.6g}, "
          f"mean kernel {mean_k:.9g} plain {mean_p:.9g} rel {rel:.3g} (< {TOL_MEAN}), "
          f"lit pixels {lit:.4f} -> {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def synthetic_floor(_path):
    """Stand-in for floor.jpg at its real size, as bench.py makes it."""
    return np.random.default_rng(0).uniform(0.1, 1.0, size=(1330, 2000, 3)).astype(np.float32)


def cuda_ms(fn, reps=1):
    """Device time of `fn` in ms (CUDA events), best of `reps` runs."""
    import torch

    best = math.inf
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of ops over the FP32 peak and bytes
    over the memory rate."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def hit_bounces(idx):
    """(hit slots, primary misses) of an index tape [spp, D, N]: the bounces
    its paths executed, at least (a path's miss after a hit is not on the
    tape, so it is not counted)."""
    return int((idx >= 0).sum()), int((idx[:, 0] < 0).sum())


def winners_per_group(idx2):
    """(mean distinct winners, mean lanes that hit) per group of 32
    neighbouring pixels and tape row of an index tape [rows, N], over the
    groups with a hit: the lanes K2's aggregation adds with one atomic."""
    import torch

    g = idx2.reshape(idx2.shape[0], -1, 32).sort(dim=-1).values
    first = torch.ones_like(g, dtype=torch.bool)
    first[..., 1:] = g[..., 1:] != g[..., :-1]
    distinct = ((g >= 0) & first).sum(dim=-1)
    lanes = (g >= 0).sum(dim=-1)
    live = lanes > 0
    return float(distinct[live].double().mean()), float(lanes[live].double().mean())


def compare_record(name, got, want, errs, spp=1):
    """K1-rec's (fb, idx[, tex]) against the plain record's: the frame by
    compare(), >= TOL_FRAC of the index-tape slots equal and, on >= TOL_FRAC
    of those, every texture field within 1e-3 of its scale (its max over the
    tape, at least 1: the derivative fields grow with the texture's size).
    Walks the tapes one sample at a time, so that the comparison takes
    little memory beside them at the main shape."""
    import torch

    ok = compare(f"{name}: frame", got[0], want[0], errs, spp) and len(got) == len(want)
    textured = len(want) == 3
    if textured:
        scale = torch.maximum(want[2].amax(dim=(0, 1, 2)), -want[2].amin(dim=(0, 1, 2)))
        scale = scale.clamp_min(1.0)
    n_slots = n_same = n_tex = 0
    for s in range(want[1].shape[0]):
        same = got[1][s] == want[1][s]
        n_slots += same.numel()
        n_same += int(same.sum())
        if textured:
            d = (got[2][s][same] - want[2][s][same]).abs()
            n_tex += int((d <= 1e-3 * scale).all(dim=1).sum())
    frac = n_same / n_slots
    t_frac = n_tex / max(n_same, 1) if textured else 1.0
    ok &= frac >= TOL_FRAC and t_frac >= TOL_FRAC
    print(f"    index tape: {frac:.6f} of {n_slots} slots equal (>= {TOL_FRAC}); "
          f"texture tape: {t_frac:.6f} of those slots agree (>= {TOL_FRAC}) -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def compare_grads(name, scene, cam, got, want, fb_rec, errs):
    """K2's (dtable, dcam, fb, gtex) against the plain replay's."""
    import torch

    from tracer_torch.kernels import bwd

    ok = True
    worst, worst_abs = 0.0, 0.0
    for (leaf, a), (_, b) in zip(bwd.leaf_grads(scene, cam, got[0], got[1]),
                                 bwd.leaf_grads(scene, cam, want[0], want[1])):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        if not (torch.isfinite(a).all() and err <= TOL_GRAD * scale + 1e-30):
            print(f"    {leaf}: max|diff| {err:.3g} vs max|g| {scale:.3g} -> FAIL")
            ok = False
        worst = max(worst, err / scale if scale else 0.0)
        worst_abs = max(worst_abs, err)
    fb_scale = float(want[2].abs().max())
    fb_err = float((got[2] - fb_rec.reshape(-1, 3)).abs().max())
    ok &= fb_err <= TOL_GRAD * fb_scale
    if got[3] is not None:
        g_err = float((got[3] - want[3]).abs().max())
        g_scale = float(want[3].abs().max())
        ok &= g_err <= TOL_GRAD * g_scale and g_scale > 0
        print(f"    gtex: max|diff| {g_err:.3g} vs max {g_scale:.3g}")
    errs.append(worst_abs)
    print(f"  {name}: worst leaf max|diff|/max|g| {worst:.3g} (<= {TOL_GRAD}), max|diff| "
          f"{worst_abs:.3g}; replayed fb "
          f"vs recorded max|diff| {fb_err:.3g} (max {fb_scale:.3g}) -> {'ok' if ok else 'FAIL'}",
          flush=True)
    return ok


def clustered_phase(dev, kind, card, cams, W, H, PSPP):
    """Phase 10: K1-cl on the sphere field. Returns (error or None, the
    kernel's entry of the `kernels` line)."""
    import torch

    from torch_scenes import sphere_field, sphere_field_camera

    from tracer_torch.kernels import cluster
    from tracer_torch.kernels import megakernel as mk
    from tracer_torch.render import renderer

    plain = {}
    CK, CSPP, CD = CLUSTER_K, 8, 20
    field, cols = sphere_field(2000, dev)
    tables = cluster.pack_clustered(field, CK)
    n_fs, n_fp, n_c = field.num_spheres, field.num_planes, tables.num_clusters
    print(f"[10] cluster-culled kernel (K1-cl) on {kind} ({card}): sphere field of {n_fs} "
          f"spheres + {n_fp} floor quad, k {CK}: {n_c} clusters, "
          f"{int((tables.slots >= 0).sum())} filled slots of {tables.slots.numel()}", flush=True)
    cl_errs = []
    mk.render_frame_kernel(field, cams[0], W, H, PSPP, CD, cluster_k=CK)  # warm-up
    cl_ms = cuda_ms(lambda: mk.render_frame_kernel(field, cams[1], W, H, PSPP, CD, cluster_k=CK),
                    reps=3)
    got = mk.render_frame_kernel(field, cams[1], W, H, PSPP, CD, cluster_k=CK)
    pcl_ms = cuda_ms(lambda: plain.update(
        cl=renderer.render_frame(field, cams[1], W, H, PSPP, CD, cluster_k=CK)))
    if not compare(f"K1-cl vs plain, {W}x{H} spp{PSPP} d{CD} camera frame 1", got,
                   plain.pop("cl"), cl_errs):
        return "cluster-culled kernel and plain version disagree", None
    work = mk.loop_work(field, cams[1], W, H, PSPP, CD, cluster_k=CK)
    queries, visits, tested, hits = work.queries, work.visits, work.tests, work.hits
    counts = torch.zeros(len(mk.COUNT_NAMES), dtype=torch.int64, device=dev)
    cnt_ms = cuda_ms(lambda: mk._render_clustered(field, cams[1], W, H, PSPP, CD, True, None, 0,
                                                  CK, counts), reps=3)
    # every query slab-tests all clusters; every tested primitive costs at
    # least a plane test; a hit shades
    cl_ops = queries * n_c * OPS_SLAB + tested * OPS_PLANE + hits * OPS_SHADE
    cl_bytes = (4 * (n_fs * 4 + n_fp * 20 + (n_fs + n_fp) * 13) + 4 * n_c * 6
                + 4 * tables.slots.numel() + 15 * 4 + W * H * 3 * 4)
    cl_bound = bound(cl_ops, cl_bytes)
    print(f"    kernel {cl_ms:.3f} ms (counted instantiation {cnt_ms:.3f} ms), plain "
          f"{pcl_ms:.3f} ms; work: {queries} nearest-hit "
          f"queries, {visits} cluster visits ({visits / queries:.3f} per query), {tested} "
          f"primitive tests ({tested / queries:.3f} per query, brute: {n_fs + n_fp}), {hits} "
          f"hits; bound "
          f"{cl_bound[0]:.3f} ms ({cl_bound[1]}: {cl_ops:.4g} FP32 ops, {cl_bytes} bytes)",
          flush=True)

    # the main path of this phase, each frame against K1's
    print(f"    main path: render_frame_kernel(cluster_k={CK}) at {W}x{H} spp{CSPP} d{CD}, "
          f"camera path frames 1-3, against K1 (render_frame_kernel, cluster_k=0):", flush=True)
    mk.LAUNCHES_CLUSTERED = 0
    frames_cl = [mk.render_frame_kernel(field, c, W, H, CSPP, CD, cluster_k=CK)
                 for c in cams[1:]]
    torch.cuda.synchronize()
    cl_launches = mk.LAUNCHES_CLUSTERED
    print(f"    K1-cl launches {cl_launches} (3 frames)", flush=True)
    if cl_launches != 3:
        return f"the clustered main path launched K1-cl {cl_launches} times, not 3", None
    for k, (c, fb_cl) in enumerate(zip(cams[1:], frames_cl), start=1):
        if fb_cl.shape != (H, W, 3):
            return f"K1-cl frame {k} has shape {tuple(fb_cl.shape)}", None
        fb_k1 = mk.render_frame_kernel(field, c, W, H, CSPP, CD)
        if not compare(f"K1-cl vs K1, camera frame {k}", fb_cl, fb_k1, []):
            return "cluster-culled kernel and brute kernel disagree at the main shape", None
        same = (fb_cl == fb_k1).all(dim=-1).double().mean().item()
        print(f"    bit-equal pixels {same:.6f}", flush=True)
    del frames_cl, fb_cl, fb_k1

    def best_ms(scene, cam_list, spp, depth, **kw):
        mk.render_frame_kernel(scene, cam_list[0], W, H, spp, depth, **kw)  # warm-up
        return min(cuda_ms(lambda c=c: mk.render_frame_kernel(scene, c, W, H, spp, depth, **kw))
                   for c in cam_list[1:])

    crays = W * H * CSPP
    for rr in (None, 3):
        t_k1 = best_ms(field, cams, CSPP, CD, rr_start=rr)
        t_cl = best_ms(field, cams, CSPP, CD, rr_start=rr, cluster_k=CK)
        u_k1, u_cl = (mk.loop_work(field, cams[1], W, H, CSPP, CD, rr_start=rr, cluster_k=k)
                      .lane_utilisation for k in (0, CK))
        print(f"    {W}x{H} spp{CSPP} d{CD} rr_start={rr}: K1 {t_k1:.3f} ms = "
              f"{crays / t_k1 / 1e3:.3f} Mrays/s; K1-cl {t_cl:.3f} ms = "
              f"{crays / t_cl / 1e3:.3f} Mrays/s; K1/K1-cl {t_k1 / t_cl:.3f}; lane utilisation "
              f"K1 {u_k1:.4f}, K1-cl {u_cl:.4f}", flush=True)
    # the same frames with the field's records in shared memory
    saved, mk.TABLE_SHARED_BYTES_MAX = mk.TABLE_SHARED_BYTES_MAX, 48 * 1024
    try:
        t_k1 = best_ms(field, cams, CSPP, CD)
        t_cl = best_ms(field, cams, CSPP, CD, cluster_k=CK)
    finally:
        mk.TABLE_SHARED_BYTES_MAX = saved
    print(f"    records in shared memory instead of global ({(n_fs * 4 + n_fp * 20) * 4} bytes): "
          f"K1 {t_k1:.3f} ms, K1-cl {t_cl:.3f} ms", flush=True)

    SW_SPP, SW_D = 4, 10
    print(f"    sweep (benchmarks/prim_scaling.py): {W}x{H} spp{SW_SPP} d{SW_D} rr_start=3, its "
          f"camera, best of 3 after a warm-up; records in shared memory up to "
          f"{mk.TABLE_SHARED_BYTES_MAX} bytes, else global:", flush=True)
    print("      n | records | clusters | K1 ms | K1 Mrays/s | K1-cl ms | K1-cl Mrays/s | K1/K1-cl")
    srays = W * H * SW_SPP
    for n in (250, 500, 1000, 2000, 5000, 10000, 20000):
        scene_n, cols_n = sphere_field(n, dev)
        cam_n = sphere_field_camera(cols_n, W, H, dev)
        c_n = cluster.pack_clustered(scene_n, CK).num_clusters
        t_k1 = best_ms(scene_n, [cam_n] * 4, SW_SPP, SW_D, rr_start=3)
        t_cl = best_ms(scene_n, [cam_n] * 4, SW_SPP, SW_D, rr_start=3, cluster_k=CK)
        where = "shared" if (n * 4 + 20) * 4 <= mk.TABLE_SHARED_BYTES_MAX else "global"
        print(f"      {n} | {where} | {c_n} | {t_k1:.3f} | {srays / t_k1 / 1e3:.3f} | {t_cl:.3f} | "
              f"{srays / t_cl / 1e3:.3f} | {t_k1 / t_cl:.3f}", flush=True)
    print(f"    card: {card}", flush=True)

    return None, dict(name="megakernel_clustered", route="cuda",
                      source="tracer_torch/csrc/megakernel.cu",
                      replaces="tracer/pallas/culling.py:27", launches=cl_launches,
                      max_abs_err=max(cl_errs), ms=cl_ms, plain_ms=pcl_ms,
                      bound_ms=cl_bound[0], bound_by=cl_bound[1], library_ms=None)


def main() -> int:
    import torch

    # ---- 1. device ----------------------------------------------------
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this run needs a CUDA GPU")
    sys.path.insert(0, HERE)
    try:
        import tracer_torch
    except ImportError as e:
        return fail(f"tracer_torch is not importable next to this script ({e})")
    if not os.path.abspath(tracer_torch.__file__).startswith(HERE + os.sep):
        return fail(f"tracer_torch came from {tracer_torch.__file__}, not from {HERE}")
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_scenes import SKY, full_scene, sphere_field, sphere_field_camera, tie_free_scene

    from tracer_torch.io import image as image_io
    from tracer_torch.kernels import bwd, cluster, diff, nvcc, replay, tex_scatter
    from tracer_torch.kernels import megakernel as mk
    from tracer_torch.opt import fit as fit_mod
    from tracer_torch.render import camera as C
    from tracer_torch.render import driver, renderer
    from tracer_torch.scene import builders, config

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    builds = nvcc.build_all()
    print(f"[2] built {len(builds)} kernel libraries from tracer_torch/csrc in "
          f"{time.perf_counter() - t0:.2f} s (parallel nvcc "
          f"{max(b.seconds for b in builds.values()):.2f} s)", flush=True)
    for stem, b in builds.items():
        print(f"    {stem}: {os.path.relpath(b.path, HERE)}")
        for line in b.log.splitlines():
            if "Compiling entry" in line:
                print(f"      {instantiation(line)}:")
            elif "registers" in line or "spill" in line or "error" in line.lower():
                print(f"        ptxas: {line.strip().removeprefix('ptxas info    : ')}")

    # ---- 3. kernels against their plain versions ----------------------
    print(f"[3] kernels vs plain on {kind}", flush=True)
    errs, ok = [], True
    smoke_p = config.read_scene_params(io.StringIO(config.smoke_config_text()))
    smoke = builders.create_scene(smoke_p, texture_loader=lambda _: None, device=dev)
    cam = C.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], 64, 48, 90.0,
                              background=SKY, device=dev)

    def case(name, scene, cam, w, h, spp, depth, **kw):
        got = mk.render_frame_kernel(scene, cam, w, h, spp, depth, **kw)
        torch.cuda.synchronize()
        want = renderer.render_frame(scene, cam, w, h, spp, depth, **kw)
        return compare(name, got, want, errs)

    for quirk in (True, False):
        ok &= case(f"smoke 64x48 spp4 d8 quirk={quirk}", smoke, cam, 64, 48, 4, 8,
                   reference_quirk=quirk)
    cam_p = C.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], 20, 5, 90.0,
                                background=SKY, device=dev)
    ok &= case("partial tile 20x5 spp2 d4", smoke, cam_p, 20, 5, 2, 4)
    cam_f = C.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 64, 48, 55.0,
                                background=SKY, device=dev)
    ok &= case("8x8 texture, all materials, 64x48 spp4 d8", full_scene(dev), cam_f, 64, 48, 4, 8)
    canon_p = config.read_scene_params(io.StringIO(config.default_config_text()))
    canon = builders.create_scene(canon_p, texture_loader=synthetic_floor, device=dev)
    cam_c = C.camera_at(canon_p.camera_path, 0, canon_p.num_frames, 96, 64,
                        canon_p.fov_degrees, background=SKY, device=dev)
    ok &= case("canonical + 1330x2000 texture 96x64 spp4 d50", canon, cam_c, 96, 64, 4, 50)
    saved, mk.TABLE_SHARED_BYTES_MAX = mk.TABLE_SHARED_BYTES_MAX, 0
    try:  # the variant that reads the records from global memory
        ok &= case("same, records in global memory", canon, cam_c, 96, 64, 4, 50)
    finally:
        mk.TABLE_SHARED_BYTES_MAX = saved
    ok &= case("smoke rr_start=3 64x48 spp4 d8", smoke, cam, 64, 48, 4, 8, rr_start=3)
    one = mk.render_frame_kernel(smoke, cam, 64, 48, 4, 8)
    two = (mk.render_frame_kernel(smoke, cam, 64, 48, 2, 8)
           + mk.render_frame_kernel(smoke, cam, 64, 48, 2, 8, sample_start=2))
    torch.cuda.synchronize()
    ok &= compare("kernel 2+2 chunks vs one shot spp4", two, one, errs)
    ok &= compare("kernel 2+2 chunks vs plain spp4", two,
                  renderer.render_frame(smoke, cam, 64, 48, 4, 8), errs)
    if not ok:
        return fail("kernel and plain version disagree")
    max_abs_err = max(errs)

    # K1-rec against the plain recording renderer
    rec_errs = []
    for name, scene, cm, w, h, spp, depth, kw in (
            ("all materials, 8x8 texture, 64x48 spp4 d8, 13 fields", full_scene(dev), cam_f,
             64, 48, 4, 8, dict(tape_fields=13)),
            ("canonical + texture 96x64 spp4 d50 rr_start=3, 9 fields", canon, cam_c, 96, 64,
             4, 50, dict(tape_fields=9, rr_start=3))):
        got = mk.render_frame_kernel_record(scene, cm, w, h, spp, depth, **kw)
        torch.cuda.synchronize()
        want = renderer.render_frame_record(scene, cm, w, h, spp, depth, **kw)
        ok &= compare_record(f"record {name}", got, want, rec_errs)
    if not ok:
        return fail("record kernel and plain record disagree")

    # K2 against the plain replay, on the same kernel-recorded tape
    grad_errs = []
    g = torch.Generator(device=dev).manual_seed(0)
    for name, scene, cm, w, h, spp, depth, rr in (
            ("smoke 64x48 spp4 d8", smoke, cam, 64, 48, 4, 8, None),
            ("canonical + texture 96x64 spp2 d8 rr_start=3, 13 fields", canon, cam_c, 96, 64,
             2, 8, 3)):
        out = mk.render_frame_kernel_record(scene, cm, w, h, spp, depth, rr_start=rr,
                                            tape_fields=13)
        table, camv = bwd.pack_tables(scene, cm)
        idx2 = out[1].reshape(spp * depth, -1)
        g2 = torch.randn((w * h, 3), generator=g, device=dev)
        t2 = bwd._field_major(out[2], spp, depth, w * h) if len(out) == 3 else None
        kw = dict(rr_start=rr, t2=t2, want_texgrad=t2 is not None)
        got = bwd.bwd_kernel(table, camv, idx2, g2, w, spp, depth, **kw)
        torch.cuda.synchronize()
        want = replay.replay_cotangents(table, camv, idx2, g2, w, spp, depth, **kw)
        ok &= compare_grads(f"backward {name}", scene, cm, got, want, out[0], grad_errs)
    if not ok:
        return fail("backward kernel and plain replay disagree")

    # K3 against the plain scatter
    rng = np.random.default_rng(0)
    spp_s, d_s, p_s, th_s, tw_s = 2, 3, 4096, 1330, 2000
    r_s = spp_s * d_s
    gs = torch.tensor(rng.normal(size=(3 * r_s, p_s)).astype(np.float32), device=dev)
    t2s = torch.ones((13 * r_s, p_s), device=dev)
    t2s[9 * r_s:10 * r_s] = torch.tensor(rng.integers(0, tw_s, (r_s, p_s)), device=dev).float()
    t2s[10 * r_s:11 * r_s] = torch.tensor(rng.integers(0, th_s, (r_s, p_s)), device=dev).float()
    t2s[9 * r_s, :3], t2s[10 * r_s, :3] = tw_s - 1, th_s - 1  # three wrap corners
    t2s[11 * r_s:13 * r_s] = torch.rand((2 * r_s, p_s), generator=g, device=dev)
    got = tex_scatter.texture_image_grads_kernel(gs, t2s, spp_s, d_s, th_s, tw_s)
    torch.cuda.synchronize()
    want = bwd.texture_image_grads(gs, t2s, spp_s, d_s, th_s, tw_s)
    scatter_err = float((got - want).abs().max())
    s_ok = torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    print(f"  texture scatter {r_s}x{p_s} slots onto {th_s}x{tw_s}: max|diff| "
          f"{scatter_err:.3g} -> {'ok' if s_ok else 'FAIL'}", flush=True)
    if not s_ok:
        return fail("texture scatter kernel and plain version disagree")

    # finite differences through the kernels
    cam_t = C.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 12, 8, 55.0,
                                background=SKY, device=dev)

    def loss_at(cz, grad=False):
        scene = tie_free_scene(dev, cz, ramp=True)
        z = scene.spheres.center
        if grad:
            z.requires_grad_()
        fb = diff.render_frame_diff(scene, cam_t, 12, 8, 2, 4).double()
        loss = torch.sum(fb * fb) / (12 * 8 * 2)
        return (loss, z) if grad else float(loss)

    loss, z = loss_at(1.0, grad=True)
    (gz,) = torch.autograd.grad(loss, z)
    fd = (loss_at(1.0 + 1e-2) - loss_at(1.0 - 1e-2)) / 2e-2
    fd_ok = abs(float(gz[0, 2]) - fd) <= 2e-2 * abs(fd) and fd != 0.0
    print(f"  finite differences, sphere z: kernels {float(gz[0, 2]):.6g}, central "
          f"{fd:.6g} -> {'ok' if fd_ok else 'FAIL'}", flush=True)
    if not fd_ok:
        return fail("kernel gradient disagrees with finite differences")

    # ---- 4. main render path at real size ------------------------------
    main_p = config.read_scene_params(io.StringIO(config.default_config_text()))
    main_p.render.sqrt_rays_per_pixel = 4
    frames = range(2)
    spp = main_p.render.sqrt_rays_per_pixel ** 2
    with tempfile.TemporaryDirectory() as tmp:
        main_p.output_path = os.path.join(tmp, "frame_%d.bin")
        scene = builders.create_scene(main_p, texture_loader=synthetic_floor, device=dev)
        print(f"[4] main path: canonical config, {scene.num_spheres} spheres + "
              f"{scene.num_planes} planes, {main_p.width}x{main_p.height}, depth "
              f"{main_p.render.max_depth}, floor texture "
              f"{tuple(scene.textures.shape[1:3])}; reduced: frames 100 -> {len(frames)}, "
              f"sqrt_spp 50 -> {main_p.render.sqrt_rays_per_pixel} (run time limit)", flush=True)
        tsv = io.StringIO()
        mk.LAUNCHES = 0
        fb = driver.render_animation(scene, main_p, saver="bin", out=tsv, frames=frames,
                                     engine="cuda")
        launches = mk.LAUNCHES
        chunks = math.ceil(spp / max(1, driver.MAX_RAYS_PER_LAUNCH // (main_p.width * main_p.height)))
        print("    TSV: " + tsv.getvalue().strip().replace("\n", " | "))
        print(f"    kernel launches {launches} (frames x chunks = {len(frames)} x {chunks})")
        if launches != len(frames) * chunks:
            return fail(f"launch count {launches} != {len(frames) * chunks}")
        if len(tsv.getvalue().strip().splitlines()) != len(frames):
            return fail("TSV has not one line per frame")
        for n in frames:
            img = image_io.read_binary(main_p.output_path % n)
            print(f"    frame {n}: {img.shape} uint8, mean {img.mean():.4f}, "
                  f"nonzero {(img > 0).mean():.4f}")
            if img.shape != (main_p.height, main_p.width, 3) or not img.any():
                return fail(f"frame {n} is empty or misshapen")
    if fb.shape != (main_p.height, main_p.width, 3) or not np.isfinite(fb).all():
        return fail("main-path framebuffer is not finite [H, W, 3]")
    # the plain version on 4096 of the last frame's pixels, same samples
    sel = torch.randperm(main_p.width * main_p.height, generator=torch.Generator().manual_seed(0))[:4096]
    i_all, j_all, seeds = renderer.pixel_grid(main_p.width, main_p.height, device=dev)
    sel = sel.to(dev)
    cam_last = C.camera_at(main_p.camera_path, frames[-1], main_p.num_frames, main_p.width,
                           main_p.height, main_p.fov_degrees, device=dev)
    plain = renderer.render_pixels(scene, cam_last, i_all[sel], j_all[sel], seeds[sel], spp,
                                   main_p.render.max_depth)
    got = torch.tensor(fb, device=dev).reshape(-1, 3)[sel]
    if not compare(f"main path frame {frames[-1]}: 4096 pixels vs plain", got[:, None],
                   plain[:, None], []):
        return fail("main-path frame disagrees with the plain version")

    cfg = config.default_config_text().replace("\n50 50\n", "\n50 2\n")
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tracer_torch.cli", "--gpu", "--frames", "1", "--format", "bin"],
            input=cfg, capture_output=True, text=True, cwd=tmp, env=env, timeout=300,
        )
        print(f"    CLI --gpu (default config, sqrt_spp 2, untextured: no floor.jpg): rc "
              f"{proc.returncode} in {time.perf_counter() - t0:.1f} s, stdout "
              f"{proc.stdout.strip()!r}", flush=True)
        if proc.returncode != 0:
            return fail(f"CLI failed:\n{proc.stderr[-3000:]}")
        out_file = os.path.join(tmp, "images", "render_0.png")
        img = image_io.read_binary(out_file)
        line = proc.stdout.strip().split("\t")
        if len(line) != 3 or line[0] != "0" or int(line[2]) != 1080 * 720 * 4 or not img.any():
            return fail("CLI output is not one TSV line and a nonzero frame")

    # ---- 5. K1's times --------------------------------------------------
    W, H, SPP, D = 800, 600, 32, 50
    plain = {}  # the plain versions' outputs, kept from their timed runs
    cams = [C.camera_at(canon_p.camera_path, k, canon_p.num_frames, W, H, canon_p.fov_degrees,
                        device=dev) for k in range(4)]
    rays = W * H * SPP

    def kernel_best(scene, depth=D, **kw):
        mk.render_frame_kernel(scene, cams[0], W, H, SPP, depth, **kw)  # warm-up
        return min(cuda_ms(lambda c=c: mk.render_frame_kernel(scene, c, W, H, SPP, depth, **kw))
                   for c in cams[1:])

    print(f"[5] times on {kind} ({card}), canonical scene {W}x{H} d{D}, best of 3 frames "
          f"(camera path frames 1-3) after one warm-up, CUDA events; lane utilisation from the "
          f"counted instantiation on camera frame 1:", flush=True)
    untex = canon._replace(textures=None)
    n_s, n_p = canon.num_spheres, canon.num_planes
    k1_work = {}
    for name, scene, kw in (("textured", canon, {}), ("untextured", untex, {}),
                            ("untextured rr_start=3", untex, dict(rr_start=3))):
        t = kernel_best(scene, **kw)
        work = mk.loop_work(scene, cams[1], W, H, SPP, D, **kw)
        k1_work[name] = (t, work)
        print(f"    K1 {name} spp{SPP}: {t:.3f} ms/frame = {rays / t / 1e3:.3f} Mrays/s; "
              f"{work.queries} nearest-hit queries ({work.queries / rays:.4f} per sample), "
              f"{work.hits} hits, {work.passes} warp passes, lane utilisation "
              f"{work.lane_utilisation:.4f}", flush=True)
    k_ms, k1_work = k1_work["textured"]
    saved, mk.TABLE_SHARED_BYTES_MAX = mk.TABLE_SHARED_BYTES_MAX, 0
    try:
        t_glob = kernel_best(canon)
    finally:
        mk.TABLE_SHARED_BYTES_MAX = saved
    print(f"    K1 textured spp{SPP} with the records in global memory instead of shared: "
          f"{t_glob:.3f} ms", flush=True)
    fb_k1 = mk.render_frame_kernel(canon, cams[1], W, H, SPP, D)
    p_ms = cuda_ms(lambda: plain.update(k1=renderer.render_frame(canon, cams[1], W, H, SPP, D)))
    if not compare(f"K1 vs plain at {W}x{H} spp{SPP} d{D} textured, camera frame 1 (per-sample "
                   f"estimate)", fb_k1, plain.pop("k1"), errs, spp=SPP):
        return fail("kernel and plain version disagree at K1's timing shape")
    max_abs_err = max(errs)
    del fb_k1
    print(f"    plain PyTorch at that shape: {p_ms:.3f} ms = {rays / p_ms / 1e3:.3f} Mrays/s",
          flush=True)
    # K1's bound: every query tests every primitive, every hit shades
    k1_ops = k1_work.queries * (n_s * OPS_SPHERE + n_p * OPS_PLANE) + k1_work.hits * OPS_SHADE
    k1_bytes = (4 * (n_s * 4 + n_p * 20 + (n_s + n_p) * 13) + canon.textures.numel() * 4
                + 15 * 4 + W * H * 3 * 4)
    k1_bound, k1_by = bound(k1_ops, k1_bytes)
    print(f"    bound at spp{SPP}: {k1_work.queries} queries, {k1_work.hits} hits -> "
          f"{k1_ops:.4g} FP32 ops, {k1_bytes} bytes: {k1_bound:.3f} ms ({k1_by})", flush=True)

    # ---- 6. main gradient path at full width -----------------------------
    GW, GH, GSPP, GD, STEPS = 800, 600, 32, 8, 3
    paths = ("materials.albedo", "spheres.center")
    cam_g = C.camera_at(canon_p.camera_path, 0, canon_p.num_frames, GW, GH,
                        canon_p.fov_degrees, device=dev)
    true_scene = canon._replace(
        materials=canon.materials._replace(albedo=canon.materials.albedo * 0.85),
        spheres=canon.spheres._replace(center=canon.spheres.center + 0.02))
    target = mk.render_frame_kernel(true_scene, cam_g, GW, GH, GSPP, GD) / GSPP
    print(f"[6] main gradient path: fit(engine='cuda') on the canonical scene + 1330x2000 "
          f"texture, {GW}x{GH} spp{GSPP} d{GD}, {STEPS} Adam steps on {','.join(paths)} "
          f"toward a target from albedo*0.85, centres+0.02; reduced: depth 50 -> {GD} "
          f"(tape memory: the d50 tapes wait for the chunked backward)", flush=True)
    mk.LAUNCHES_RECORD = bwd.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted, losses = fit_mod.fit(canon, cam_g, target, GW, GH, spp=GSPP, max_depth=GD,
                                 param_paths=paths, steps=STEPS, learning_rate=1e-2,
                                 log_every=1, engine="cuda",
                                 log=lambda m: print(f"    {m}", flush=True))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    rec_launches, bwd_launches = mk.LAUNCHES_RECORD, bwd.LAUNCHES
    print(f"    losses {losses}; {fit_s:.2f} s for {STEPS} steps; launches: record "
          f"{rec_launches}, backward {bwd_launches}", flush=True)
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        return fail(f"fit loss is not finite and falling: {losses}")
    if rec_launches != STEPS or bwd_launches != STEPS:
        return fail(f"fit launched record {rec_launches} and backward {bwd_launches} times, "
                    f"not {STEPS}")
    for p in paths:
        if not torch.isfinite(fit_mod.get_path(fitted, p)).all():
            return fail(f"fitted {p} is not finite")

    # ---- 7. texture-image gradients at that shape -------------------------
    tex_leaf = canon.textures.detach().clone().requires_grad_()
    scene_t = canon._replace(textures=tex_leaf)
    tex_scatter.LAUNCHES = 0
    fb_t = diff.render_frame_diff(scene_t, cam_g, GW, GH, GSPP, GD, texture_grads=True)
    (g_tex,) = torch.autograd.grad(torch.mean((fb_t / GSPP - target) ** 2), tex_leaf)
    torch.cuda.synchronize()
    scatter_launches = tex_scatter.LAUNCHES
    nz = float((g_tex != 0).double().mean())
    print(f"[7] render_frame_diff(texture_grads=True) at {GW}x{GH} spp{GSPP} d{GD}: texture "
          f"cotangent finite {bool(torch.isfinite(g_tex).all())}, {nz:.4f} of texels touched; "
          f"scatter launches {scatter_launches}", flush=True)
    del fb_t, g_tex
    if scatter_launches != 1 or nz == 0.0:
        return fail("the texture scatter did not run once at the main shape")

    # ---- 8. the --fit CLI ---------------------------------------------------
    fit_cfg = config.default_config_text().replace("\n50 50\n", "\n8 2\n")
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([sys.executable, "-m", "tracer_torch.cli", "--gpu", "--frames", "1"],
                           input=fit_cfg, capture_output=True, text=True, cwd=tmp, env=env,
                           timeout=300)
        target_file = os.path.join(tmp, "images", "render_0.png")
        if r.returncode != 0 or not os.path.exists(target_file):
            return fail(f"CLI render of the fit target failed:\n{r.stderr[-3000:]}")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "tracer_torch.cli", "--gpu", "--fit",
                            target_file, "--fit-steps", "2", "--fit-params", "materials.albedo"],
                           input=fit_cfg, capture_output=True, text=True, cwd=tmp, env=env,
                           timeout=300)
        last = r.stdout.strip().splitlines()[-1:] or [""]
        print(f"[8] CLI --gpu --fit (default config, sqrt_spp 2, depth 8, 2 steps): rc "
              f"{r.returncode} in {time.perf_counter() - t0:.1f} s, {last[0]!r}", flush=True)
        if r.returncode != 0 or not last[0].startswith("final loss: ") \
                or not math.isfinite(float(last[0].split(": ")[1])):
            return fail(f"CLI --fit failed:\n{r.stderr[-3000:]}")

    # ---- 9. gradient-path times and checks at the main shape ------------------
    print(f"[9] gradient path at the main shape on {kind} ({card}), {GW}x{GH} spp{GSPP} d{GD}, "
          f"canonical + texture, camera frame 0, CUDA events, best of 3 after a warm-up; each "
          f"kernel against its plain version on the same inputs:", flush=True)
    grays = GW * GH * GSPP
    fwd_ms = cuda_ms(lambda: mk.render_frame_kernel(canon, cam_g, GW, GH, GSPP, GD), reps=3)
    mk.render_frame_kernel_record(canon, cam_g, GW, GH, GSPP, GD)
    rec_ms = cuda_ms(lambda: mk.render_frame_kernel_record(canon, cam_g, GW, GH, GSPP, GD),
                     reps=3)
    out = mk.render_frame_kernel_record(canon, cam_g, GW, GH, GSPP, GD)
    hits_g, miss_g = hit_bounces(out[1])
    tape_b = out[1].numel() * 4 + out[2].numel() * 4
    prec_ms = cuda_ms(lambda: plain.update(
        rec=renderer.render_frame_record(canon, cam_g, GW, GH, GSPP, GD)))
    ok = compare_record("record at the main shape (frame per-sample estimate)", out,
                        plain.pop("rec"), rec_errs, spp=GSPP)
    rec_err = max(rec_errs)
    if not ok:
        return fail("record kernel and plain record disagree at the main shape")
    table, camv = bwd.pack_tables(canon, cam_g)
    idx2 = out[1].reshape(GSPP * GD, -1)
    t2 = bwd._field_major(out[2], GSPP, GD, GW * GH)
    g2 = torch.randn((GW * GH, 3), generator=g, device=dev)
    bwd.bwd_kernel(table, camv, idx2, g2, GW, GSPP, GD, t2=t2)
    bwd_ms = cuda_ms(lambda: bwd.bwd_kernel(table, camv, idx2, g2, GW, GSPP, GD, t2=t2), reps=3)
    per_sm = bwd.blocks_per_sm(True, table.shape[1])
    distinct, hit_lanes = winners_per_group(idx2)
    got = bwd.bwd_kernel(table, camv, idx2, g2, GW, GSPP, GD, t2=t2)
    pbwd_ms = cuda_ms(lambda: plain.update(
        bwd=replay.replay_cotangents(table, camv, idx2, g2, GW, GSPP, GD, t2=t2)))
    ok = compare_grads("backward at the main shape", canon, cam_g, got, plain.pop("bwd"),
                       out[0], grad_errs)
    grad_err = max(grad_errs)
    if not ok:
        return fail("backward kernel and plain replay disagree at the main shape")
    del out, idx2, t2, got
    fwd_work = mk.loop_work(canon, cam_g, GW, GH, GSPP, GD)
    rec_work = mk.loop_work(canon, cam_g, GW, GH, GSPP, GD, record=True)
    print(f"    K1 forward {fwd_ms:.3f} ms (lane utilisation {fwd_work.lane_utilisation:.4f}); "
          f"K1-rec {rec_ms:.3f} ms (tapes {tape_b} bytes, {rec_work.queries} nearest-hit "
          f"queries, {rec_work.hits} hits = {hits_g} tape hit slots, {miss_g} primary misses; "
          f"lane utilisation {rec_work.lane_utilisation:.4f}), K1-rec - K1 "
          f"{rec_ms - fwd_ms:.3f} ms; plain record {prec_ms:.3f} ms", flush=True)
    print(f"    K2 {bwd_ms:.3f} ms with one wave of {per_sm} resident blocks an SM "
          f"({bwd.grid_blocks(GW * GH, True, table.shape[1], dev)} blocks); plain replay "
          f"{pbwd_ms:.3f} ms; "
          f"distinct winners per 32-pixel group and tape row {distinct:.4f}, among "
          f"{hit_lanes:.4f} lanes that hit (groups with a hit)", flush=True)
    # one fwd+bwd step as the user calls it, host clock to synchronize
    leaf = canon.materials.albedo.detach().clone().requires_grad_()
    scene_a = canon._replace(materials=canon.materials._replace(albedo=leaf))
    step_s = math.inf
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fb_s = diff.render_frame_diff(scene_a, cam_g, GW, GH, GSPP, GD)
        torch.autograd.grad(torch.mean((fb_s / GSPP - target) ** 2), leaf)
        torch.cuda.synchronize()
        step_s = min(step_s, time.perf_counter() - t0)
    del fb_s
    print(f"    fwd+bwd step (render_frame_diff + backward): {step_s * 1e3:.3f} ms = "
          f"{grays / step_s / 1e6:.3f} Mrays/s", flush=True)
    # K3 at the main shape: the texture-grads tapes of one frame
    out = mk.render_frame_kernel_record(canon, cam_g, GW, GH, GSPP, GD, tape_fields=13)
    idx2 = out[1].reshape(GSPP * GD, -1)
    t2 = bwd._field_major(out[2], GSPP, GD, GW * GH)
    del out
    gtex = bwd.bwd_kernel(table, camv, idx2, g2, GW, GSPP, GD, t2=t2, want_texgrad=True)[3]
    th, tw = canon.textures.shape[1:3]
    tex_scatter.texture_image_grads_kernel(gtex, t2, GSPP, GD, th, tw)
    k3_ms = cuda_ms(lambda: tex_scatter.texture_image_grads_kernel(gtex, t2, GSPP, GD, th, tw),
                    reps=3)
    got = tex_scatter.texture_image_grads_kernel(gtex, t2, GSPP, GD, th, tw)
    p3_ms = cuda_ms(lambda: plain.update(k3=bwd.texture_image_grads(gtex, t2, GSPP, GD, th, tw)))
    want = plain.pop("k3")
    k3_err = float((got - want).abs().max())
    scatter_err = max(scatter_err, k3_err)
    s_ok = torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    print(f"    texture scatter at the main shape: max|diff| {k3_err:.3g} (max "
          f"{float(want.abs().max()):.3g}) -> {'ok' if s_ok else 'FAIL'}", flush=True)
    if not s_ok:
        return fail("texture scatter kernel and plain version disagree at the main shape")
    del got, want
    live = int((gtex.reshape(3, -1) != 0).any(dim=0).sum())
    slots = gtex.shape[0] // 3 * gtex.shape[1]
    # one index_add_ of all four corners' weighted cotangents, inputs built first
    rows = GSPP * GD
    gg = gtex.reshape(3, rows, -1).permute(1, 2, 0)
    x0, y0 = t2[9 * rows:10 * rows].long(), t2[10 * rows:11 * rows].long()
    fu, fv = t2[11 * rows:12 * rows], t2[12 * rows:13 * rows]
    x1, y1 = torch.where(x0 + 1 < tw, x0 + 1, 0), torch.where(y0 + 1 < th, y0 + 1, 0)
    flat_idx = torch.cat([(y0 * tw + x0).reshape(-1), (y0 * tw + x1).reshape(-1),
                          (y1 * tw + x0).reshape(-1), (y1 * tw + x1).reshape(-1)])
    vals = torch.cat([(w[..., None] * gg).reshape(-1, 3) for w in
                      ((1 - fu) * (1 - fv), fu * (1 - fv), (1 - fu) * fv, fu * fv)])
    del gg, x0, y0, fu, fv, x1, y1
    acc = torch.zeros((th * tw, 3), device=dev)
    lib_ms = cuda_ms(lambda: acc.zero_().index_add_(0, flat_idx, vals), reps=3)
    print(f"    K3 scatter {slots} slots ({live} with a cotangent) onto {th}x{tw}: kernel "
          f"{k3_ms:.3f} ms, plain {p3_ms:.3f} ms, one index_add_ {lib_ms:.3f} ms", flush=True)
    del flat_idx, vals, acc, idx2

    # bounds: the record mode writes its whole tapes; the backward reads the
    # slots its paths reached (index and 9 texture fields each) and writes
    # dtable, dcam and fb; the scatter reads every cotangent and the
    # addressing of the slots that have one
    n_prims = canon.num_spheres + canon.num_planes
    reached = rec_work.queries  # every query's slot, a miss after a hit included
    rec_ops = reached * (n_s * OPS_SPHERE + n_p * OPS_PLANE) + rec_work.hits * OPS_SHADE
    rec_bound = bound(rec_ops, k1_bytes + tape_b)
    bwd_bound = bound(hits_g * OPS_ADJOINT, reached * 4 * 10 + 2 * 4 * n_prims * 30
                      + 2 * GW * GH * 3 * 4 + 2 * 15 * 4)
    k3_bound = bound(live * OPS_SCATTER, slots * 3 * 4 + live * 4 * 4 + th * tw * 3 * 4)
    for name, b in (("K1-rec", rec_bound), ("K2", bwd_bound), ("K3", k3_bound)):
        print(f"    {name} bound: {b[0]:.3f} ms ({b[1]})")
    print(f"    card: {card}", flush=True)
    del table, camv, g2, gtex, t2, target

    # ---- 10. the cluster-culled kernel on the sphere field ---------------------
    err, cl_entry = clustered_phase(dev, kind, card, cams, W, H, 2)
    if err:
        return fail(err)

    kernels = [
        dict(name="megakernel", route="cuda", source="tracer_torch/csrc/megakernel.cu",
             replaces="tracer/pallas/kernels.py:33", launches=launches, max_abs_err=max_abs_err,
             ms=k_ms, plain_ms=p_ms, bound_ms=k1_bound, bound_by=k1_by, library_ms=None),
        dict(name="megakernel_record", route="cuda", source="tracer_torch/csrc/megakernel.cu",
             replaces="tracer/pallas/kernels.py:411", launches=rec_launches,
             max_abs_err=rec_err, ms=rec_ms, plain_ms=prec_ms, bound_ms=rec_bound[0],
             bound_by=rec_bound[1], library_ms=None),
        dict(name="bwd", route="cuda", source="tracer_torch/csrc/bwd.cu",
             replaces="tracer/pallas/bwd.py:194", launches=bwd_launches, max_abs_err=grad_err,
             ms=bwd_ms, plain_ms=pbwd_ms, bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
             library_ms=None),
        dict(name="tex_scatter", route="cuda", source="tracer_torch/csrc/tex_scatter.cu",
             replaces="tracer/pallas/tex_scatter.py:41", launches=scatter_launches,
             max_abs_err=scatter_err, ms=k3_ms, plain_ms=p3_ms, bound_ms=k3_bound[0],
             bound_by=k3_bound[1], library_ms=lib_ms),
        cl_entry,
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
