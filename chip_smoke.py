#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. Device: the card's name and power limit.
2. Build: compiles every tracer_torch/csrc/*.cu with nvcc, one process per
   source, all started together (megakernel.cu, bwd.cu, tex_scatter.cu),
   and prints ptxas's registers and spills for every instantiation (K1-cl's
   and K1-bvh's four each: primitive records and nodes each in shared or
   global memory; K1-ref's brute two and BVH four, uncounted, and one
   counted brute instantiation; K1-bvh's RTIOW eight, its records and nodes
   each in shared or global memory, uncounted and counted).
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
     the walk's work there, counted by the kernel's counted instantiation
     (megakernel.loop_work) in one launch, which is also timed beside the
     uncounted one: node tests, leaves reached and primitive tests per
     nearest-hit query, beside the visit-every-box work of the flat loop
     it replaced (a slab test of every cluster per query); its bound (the
     larger of FP32 operations over 67 TFLOP/s and bytes over 3.35 TB/s)
     from work that does not depend on the traversal: one primitive test
     per query and the shading of every hit, and the tables and the frame
     read or written once;
   - the main path of this phase: render_frame_kernel(cluster_k=16) at
     800x600, spp 8, depth 20 on camera path frames 1-3 (bench.py's
     2000-sphere line), each frame against K1's on the same inputs by
     phase 3's rules, with the share of bit-equal pixels (built without
     FMA contraction the two kernels give bit-equal frames; with it, nvcc
     contracts their shared float code differently, and this field's
     paths amplify the last-bit differences); K1-cl's launch count;
   - K1 and K1-cl times at that shape, with and without rr_start=3 (best
     of 3 frames after a warm-up), with their lane utilisation, and again
     with the field's records in shared memory instead of global and with
     K1-cl's tree nodes in global memory instead of shared; and on
     prim_scaling.py's sweep (records in shared memory up to n = 1000,
     in global memory above; nodes in shared memory up to
     megakernel.NODE_SHARED_BYTES_MAX): n in {2000, 5000, 10000, 20000}
     spheres and, for the crossing point, 250, 500 and 1000; 800x600, spp
     4, depth 10, rr_start=3, its camera (best of 3 after a warm-up), with
     K1-cl's node tests, leaves reached and primitive tests per query and
     its time with the nodes in the other memory.

11. The depth-50 gradient path (kernels/bwd.py:scene_grads_chunked,
    l2_grads_deep; the 3-field tape; render_frame_diff's modes "replay"
    and "replay-sample"), on the canonical scene with the texture:
   - K1-rec's 3-field tape bit-equal to fields 0-2 of its 9-field tape
     (and the same frame and index tape), 256x192 spp4 d8;
   - scene_grads_chunked(spp_chunk=2) against render_frame_diff and its
     backward at 256x192 spp8 d50, where the one-shot tapes fit, by
     compare_grads's rule (every leaf within TOL_GRAD of its max|g|: the
     chunks record the same paths, so only the addition order differs);
   - scene_grads_chunked(spp_chunk=2, texture_grads=True) at 64x48 spp4
     d50 against the plain replay and the plain scatter fed each chunk's
     kernel-recorded tapes, by the same rule, the texture's cotangent
     included;
   - l2_grads_deep's loss against the loss of a K1 frame (relative 1e-6);
   - modes "replay" and "replay-sample" against "replay-kernel" at 64x48
     spp2 d8: the material colours' gradients by the same rule (the
     other leaves' worst relative difference is printed; "replay" freezes
     the texel, and "replay-sample" samples it where the replay's last-bit
     hit point lands on the 1330x2000 texture);
   - the main path of this phase: l2_grads_deep(texture_grads=True) at
     800x600 spp32 d50, spp_chunk 8, with every kernel's launches (K1 1,
     K1-rec, K2 and K3 one a chunk) and the peak device memory; then one
     chunk's 13-field tape (2.5 G elements, past 2^31): fields 0-8
     bit-equal to the 9-field tape, the addressing fields 9-12 fetching the
     recorded texel (1e-5), K3 against the plain scatter on it;
   - l2_grads_deep at 800x600 spp32 d50 textured and 1080x720 spp64 d50
     untextured, spp_chunk 8, best of 3 by host clock, with K1, K1-rec and
     K2 at their shapes in the step (CUDA events, best of 3), K1 at spp 8
     and the tapes' neutral fill alone (K1-rec's other parts), the
     launches, a chunk's tape bytes; and the tapes' share of slots with a
     winner, the mean last live bounce, its mean maximum over warps of 32
     pixels and the depth a 128-pixel tile needs (tracer/pallas/bwd.py:
     _needed_depth_per_tile), beside 800x600 d8's: whether depth buckets
     would pay;
   - at each of those two shapes, K1, K1-rec and K2 against their plain
     versions on the same inputs: K1's frame and the last chunk's tapes
     (13 fields textured) on 16384 sampled pixels by phase 3's rules (the
     frame on its per-sample estimate); K2 on that chunk's tapes against
     the plain replay over the last 40 image rows (row_offset), launched
     on those rows and over the whole grid (its replayed frame and texel
     cotangents there within TOL_GRAD of the plain version's max), and the
     whole-grid launch's dtable and dcam against the sum of its launches on
     those rows and the rows above them.

12. Stratified jitter (strat_k; tracer's `stratify`):
   - K1 and K1-cl (k = 16) stratified on the canonical scene with the
     texture at 96x64 d50, spp 4 and a chunk of 5 samples from sample 4 on
     a 3x3 grid, against their plain versions by phase 3's rules;
   - K1-rec stratified, 3, 9 and 13 fields, all materials 64x48 spp4 d8
     rr_start=3, against the plain record; K2 with strat_k 2 on the
     stratified 13-field tape against the plain replay by compare_grads's
     rule (its replayed frame is the recorded one), and without the grid
     (it must replay other rays);
   - render_animation(engine="cuda", stratify=True) on the canonical config
     at 1080x720 sqrt_spp 4 d50 with spp_chunk 6 (chunks 6, 6, 4: not
     square) against one stratified launch of the same 16 samples (rtol
     1e-5, atol 1e-4: float32 addition order);
   - K1 at 800x600 spp16 d50 textured, uniform and stratified in turns
     (best of 3 after a warm-up): what the grid costs.
13. The BVH path (`create_scene(with_bvh=True)`, `intersector="bvh"`, the
    BVH kernel K1-bvh):
   - build times of the native (g++) and NumPy builders for the canonical
     scene and prim_scaling.py's field at n = 2000 and 20,000;
   - K1-bvh against the plain traversal (tracer_torch/bvh/traverse.py) on
     the canonical scene with the texture at 64x48 spp2 d5 and on the field
     (n = 2000) at 256x192 spp2 d10, camera path frame 1 with a black
     background (phase 10's view), by phase 3's rules, with the share of
     bit-equal pixels and of pixels where K1-bvh agrees with K1, both
     timed (the field's times are the kernels line's `ms` and
     `plain_ms`), and K1 against the plain brute version beside it (at
     64x48 the field's frame mean moves by 2e-3 between K1 and its plain
     version already: the field turns last-bit differences, such as
     torch's CUDA sqrt and sin against the kernel's, into other paths);
   - the main path of this slice: render_animation(engine="cuda",
     intersector="bvh", stratify=True) on the canonical config, 1080x720
     d50, synthetic floor, 2 frames at sqrt_spp 4 in chunks of 6, every
     launch count set to 0 before it and read after (K1-bvh 6, the others
     0), the saved frames, and 512 sampled pixels of the last frame
     against the plain traversal (the same samples); then `tracer_torch.cli
     --gpu --bvh --stratify` once, as a subprocess;
   - K1-bvh's times and work (node tests, leaves reached = primitive tests
     per query, lane utilisation, from the counted instantiation): the
     canonical scene at 800x600 spp32 d50 textured (beside phase 5's K1
     and K1-bvh-ref, mode 5, which runs the same walk) and untextured, and
     with its child-pair records in global memory; the field at
     spp8 d20 with and without rr_start=3, beside K1-cl and K1; the sweep
     of phase 10 (n 250-20,000, spp4 d10 rr_start=3) beside K1-cl; its
     bound from work no traversal avoids (a plane test a query, each hit's
     shading; tables, the 64-byte child-pair records and frame once), as
     K1-cl's.

14. Distribution (tracer_torch.dist) on the one card:
   - K1 and K1-rec on row bands (`row_offset`) against one launch, bit for
     bit (frame, index tape, 9-field tape): 1080x720 in 3 bands of 240 and
     1080x719 in bands of 360 and 359, canonical + texture, K1 spp4 d50,
     K1-rec spp2 d8;
   - a gloo group of 2 worker processes (this script with `--dist-worker`,
     a free-port TCP store), both ranks on cuda:0, each loading the
     libraries of phase 2; a worker that fails, times out or prints no
     result fails the run. In it: the main forward path,
     render_animation_multihost(frame_shard=False, engine="cuda") on the
     canonical config as phase 4 (2 frames, sqrt_spp 4), every launch count
     set to 0 before it and read after (K1 2 a rank); rank 0's files and
     TSV against one process's render_animation (files max|diff| 0, frames
     bit-equal on both ranks), rank 1 writes and prints nothing; then
     frame_shard=True over 3 frames (rank r writes frames r, r+2);
     render_frame_spp_sharded (the plain path) at the smoke scene 64x48
     spp4 d8 by phase 3's rules; the main gradient path,
     l2_grads_deep_sharded(texture_grads=True) at 800x600 spp32 d50 in
     chunks of 8, against l2_grads_deep: loss bit-equal, every leaf and the
     texture within TOL_GRAD of its max|g|, K1 1, K1-rec, K2 and K3 4 each
     per rank; scene_grads_replay_sharded at 64x48 spp2 d8 against
     render_frame_diff(mode="replay"); the times of the sharded 1080x720
     spp16 d50 frame, its all_reduce alone and one launch (2 ranks share
     the card: not a scaling figure);
   - an NCCL group of one rank: render_frame_kernel_sharded bit-equal to
     render_frame_kernel, l2_grads_deep_sharded against l2_grads_deep.

15. The reference stream (rng_mode="reference", K1-ref), utils and the
    native frame writer:
   - K1-ref against the plain reference renderer on the canonical scene
     with the texture at 96x64 spp4 d50, by phase 3's rules: brute; brute
     stratified; BVH stratified with the quirk off; two sample chunks
     against one launch (and against the plain version); a row band
     bit-equal to one launch's rows; the fixed stream's frame must differ;
   - the plain rejection sampler on the card bit-equal to the CPU's on 4096
     seeds with the exhausted lanes (tests/torch_scenes.py:EXHAUSTED_SEEDS),
     and one-pixel K1-ref launches whose first bounce draws from each
     exhausted seed (tests/torch_scenes.py:exhausted_lane_view) against the
     plain version and the tail's radiance (the normal, into the light);
   - the slice's main path: render_animation(engine="cuda",
     rng_mode="reference") on the canonical config, 1080x720 d50, synthetic
     floor, 2 frames at sqrt_spp 4, every launch count set to 0 before it
     and read after (K1-ref 2, the others 0), the saved frames,
     check_framebuffer, 2048 sampled pixels against the plain version; then
     `tracer_torch.cli --gpu --ref-rng --retries 2` once, as a subprocess,
     its frame byte-equal to the driver's on the same config;
   - K1-ref and K1 at 800x600 spp32 d50 textured, in turns, best of 3
     frames each, with their queries, hits and lane utilisation, and K1-ref's
     bound by K1's formula; K1-ref and its plain version at 256x192 spp2 d50
     (the kernels line's ms, plain_ms and bound);
   - the main path's frame loop (sqrt_spp 2) with the native writer and with
     ThreadedWriter, bin (8 frames) and ppm (2), in turns: the loop's host
     time and the time spent in submit; the driver must pick the native
     writer here;
   - one main-path frame under utils.profiling.profile_trace (the trace must
     name trace_kernel; its top device operations printed), and a transient
     failure forced into the driver's first render call, which must retry.
16. The RTIOW book's estimator: K1-bvh's RTIOW instantiation (thin lens,
    sky, the book's materials) on the scene of the benchmark cell
    rtiow_final.frames_bvh_auto, built by its scene kind, at the cell's
    launch shape (a 12-row band of 1200x800, the driver's 139 spp of
    484, depth 50) against the plain version on the same band: L1 within
    1% and the mean within 1e-3, as one K1-bvh launch and no other; the
    first sample of each of the frame's chunks printed by sample. Then the
    same with megakernel.cu built with -fmad=false (a worker process, this
    script with `--rtiow-fmad-false`), where the samples are held to
    tests/test_torch_rtiow.py's rule: 99% within 1e-3, L1 within 1% (FMA
    contraction diverts a few percent of this scene's samples at depth
    50, on the radius-1000 ground sphere's roots).

The line before the last is a JSON object describing the kernels (with
`launches_d50`, each kernel's launches on phase 11's main path, and
`launches_dist`, rank 0's on phase 14's two main paths; each
`max_abs_err` is the largest over its checks in every phase), with the
card's name and power limit on the line before it; the last is
`{"ok": true, "device": {...}}`. The script's own time is printed before
those lines.
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

    m = re.search(r"trace_kernelILb(\d)ELi(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)E", line)
    if m:
        rec, isect = m.group(1) == "1", int(m.group(2))
        smem, nsmem, count, ref, rtiow = (x == "1" for x in m.groups()[2:])
        name = "K1-rec" if rec else ("K1", "K1-cl", "K1-bvh")[isect] + ("-ref" if ref else "")
        name += " (RTIOW)" if rtiow else ""
        return (f"{name}, records in {'shared' if smem else 'global'} memory"
                + (f", nodes in {'shared' if nsmem else 'global'} memory" if isect else "")
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


def compare_leaves(names, got, want):
    """(ok, worst max|diff|/max|g|, worst max|diff|): every leaf of `got`
    finite and within TOL_GRAD of the max|g| of its leaf in `want`."""
    import torch

    ok = True
    worst, worst_abs = 0.0, 0.0
    for leaf, a, b in zip(names, got, want):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        if not (torch.isfinite(a).all() and err <= TOL_GRAD * scale + 1e-30):
            print(f"    {leaf}: max|diff| {err:.3g} vs max|g| {scale:.3g} -> FAIL")
            ok = False
        worst = max(worst, err / scale if scale else 0.0)
        worst_abs = max(worst_abs, err)
    return ok, worst, worst_abs


def compare_grads(name, scene, cam, got, want, fb_rec, errs):
    """K2's (dtable, dcam, fb, gtex) against the plain replay's."""
    from tracer_torch.kernels import bwd

    ok, worst, worst_abs = compare_leaves(bwd.leaf_names(scene, cam),
                                          bwd.leaf_cotangents(scene, cam, got[0], got[1]),
                                          bwd.leaf_cotangents(scene, cam, want[0], want[1]))
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


def node_bytes(tables):
    return 4 * tables.nodes.numel()


def node_memory(mk, tables):
    """Where K1-cl reads these tables' tree nodes from."""
    return "shared" if node_bytes(tables) <= mk.NODE_SHARED_BYTES_MAX else "global"


def other_node_memory(mk, tables, timed):
    """(ms of `timed()` with K1-cl's nodes in the other memory, its name)."""
    saved = mk.NODE_SHARED_BYTES_MAX
    other = "global" if node_memory(mk, tables) == "shared" else "shared"
    mk.NODE_SHARED_BYTES_MAX = node_bytes(tables) if other == "shared" else -1
    try:
        return timed(), other
    finally:
        mk.NODE_SHARED_BYTES_MAX = saved


def walk_line(work, n_clusters):
    """K1-cl's walk per nearest-hit query, from a LoopWork."""
    q = max(work.queries, 1)
    return (f"{work.node_tests / q:.3f} node tests (flat loop: {n_clusters} boxes), "
            f"{work.visits / q:.3f} leaves reached, {work.tests / q:.3f} primitive tests")


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
          f"{int((tables.slots >= 0).sum())} filled slots of {tables.slots.numel()}, "
          f"{tables.nodes.shape[0]} tree nodes ({node_bytes(tables)} bytes) in "
          f"{node_memory(mk, tables)} memory", flush=True)
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
    queries, tested, hits = work.queries, work.tests, work.hits
    counts = torch.zeros(len(mk.COUNT_NAMES), dtype=torch.int64, device=dev)
    cnt_ms = cuda_ms(lambda: mk._render_clustered(field, cams[1], W, H, PSPP, CD, True, None, 0,
                                                  CK, counts), reps=3)
    # the bound reads work no traversal avoids: every query tests one
    # primitive at least (a plane test, the cheaper), every hit shades; the
    # bytes are the tables and the frame, each once
    cl_ops = queries * OPS_PLANE + hits * OPS_SHADE
    cl_bytes = (4 * (n_fs * 4 + n_fp * 20 + (n_fs + n_fp) * 13) + 4 * n_c * 6
                + 4 * tables.slots.numel() + 15 * 4 + W * H * 3 * 4)
    cl_bound = bound(cl_ops, cl_bytes)
    # the walk's own work, and that of the flat loop it replaced (a slab
    # test of every cluster box per query), each tested primitive at least
    # a plane test
    walk_ops = work.node_tests * OPS_SLAB + tested * OPS_PLANE + hits * OPS_SHADE
    flat_ops = queries * n_c * OPS_SLAB + tested * OPS_PLANE + hits * OPS_SHADE
    print(f"    kernel {cl_ms:.3f} ms (counted instantiation {cnt_ms:.3f} ms), plain "
          f"{pcl_ms:.3f} ms; work: {queries} nearest-hit queries, {hits} hits; per query "
          f"{walk_line(work, n_c)}, brute {n_fs + n_fp} tests", flush=True)
    print(f"    the walk's work {walk_ops:.4g} FP32 ops = {walk_ops / PEAK_FP32 * 1e3:.3f} ms at "
          f"peak; visit-every-box work {flat_ops:.4g} FP32 ops = "
          f"{flat_ops / PEAK_FP32 * 1e3:.3f} ms; bound {cl_bound[0]:.6f} ms ({cl_bound[1]}: "
          f"{cl_ops:.4g} FP32 ops, {cl_bytes} bytes)", flush=True)

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
        u_k1 = mk.loop_work(field, cams[1], W, H, CSPP, CD, rr_start=rr).lane_utilisation
        w_cl = mk.loop_work(field, cams[1], W, H, CSPP, CD, rr_start=rr, cluster_k=CK)
        print(f"    {W}x{H} spp{CSPP} d{CD} rr_start={rr}: K1 {t_k1:.3f} ms = "
              f"{crays / t_k1 / 1e3:.3f} Mrays/s; K1-cl {t_cl:.3f} ms = "
              f"{crays / t_cl / 1e3:.3f} Mrays/s; K1/K1-cl {t_k1 / t_cl:.3f}; lane utilisation "
              f"K1 {u_k1:.4f}, K1-cl {w_cl.lane_utilisation:.4f}; K1-cl per query "
              f"{walk_line(w_cl, n_c)}", flush=True)
    # the same frames with the field's records in shared memory, and with
    # K1-cl's nodes in the other memory
    saved, mk.TABLE_SHARED_BYTES_MAX = mk.TABLE_SHARED_BYTES_MAX, 48 * 1024
    try:
        t_k1 = best_ms(field, cams, CSPP, CD)
        t_cl = best_ms(field, cams, CSPP, CD, cluster_k=CK)
    finally:
        mk.TABLE_SHARED_BYTES_MAX = saved
    print(f"    records in shared memory instead of global ({(n_fs * 4 + n_fp * 20) * 4} bytes): "
          f"K1 {t_k1:.3f} ms, K1-cl {t_cl:.3f} ms", flush=True)
    t_other, other = other_node_memory(mk, tables, lambda: best_ms(field, cams, CSPP, CD,
                                                                   cluster_k=CK))
    print(f"    K1-cl with its nodes in {other} memory instead: {t_other:.3f} ms", flush=True)

    SW_SPP, SW_D = 4, 10
    print(f"    sweep (benchmarks/prim_scaling.py): {W}x{H} spp{SW_SPP} d{SW_D} rr_start=3, its "
          f"camera, best of 3 after a warm-up; records in shared memory up to "
          f"{mk.TABLE_SHARED_BYTES_MAX} bytes, nodes up to {mk.NODE_SHARED_BYTES_MAX}, else "
          f"global; K1-cl's work per query from the counted instantiation:", flush=True)
    print("      n | records | clusters | nodes | K1 ms | K1 Mrays/s | K1-cl ms | K1-cl Mrays/s | "
          "K1/K1-cl | per query | K1-cl ms, nodes in the other memory")
    srays = W * H * SW_SPP
    for n in (250, 500, 1000, 2000, 5000, 10000, 20000):
        scene_n, cols_n = sphere_field(n, dev)
        cam_n = sphere_field_camera(cols_n, W, H, dev)
        tables_n = cluster.pack_clustered(scene_n, CK)
        c_n = tables_n.num_clusters
        t_k1 = best_ms(scene_n, [cam_n] * 4, SW_SPP, SW_D, rr_start=3)
        t_cl = best_ms(scene_n, [cam_n] * 4, SW_SPP, SW_D, rr_start=3, cluster_k=CK)
        w_n = mk.loop_work(scene_n, cam_n, W, H, SW_SPP, SW_D, rr_start=3, cluster_k=CK)
        t_other, other = other_node_memory(mk, tables_n, lambda: best_ms(
            scene_n, [cam_n] * 4, SW_SPP, SW_D, rr_start=3, cluster_k=CK))
        where = "shared" if (n * 4 + 20) * 4 <= mk.TABLE_SHARED_BYTES_MAX else "global"
        print(f"      {n} | {where} | {c_n} | {node_memory(mk, tables_n)} | {t_k1:.3f} | "
              f"{srays / t_k1 / 1e3:.3f} | {t_cl:.3f} | {srays / t_cl / 1e3:.3f} | "
              f"{t_k1 / t_cl:.3f} | {walk_line(w_n, c_n)} | {other} {t_other:.3f}", flush=True)
    print(f"    card: {card}", flush=True)

    return None, dict(name="megakernel_clustered", route="cuda",
                      source="tracer_torch/csrc/megakernel.cu",
                      replaces="tracer/pallas/culling.py:27", launches=cl_launches,
                      max_abs_err=max(cl_errs), ms=cl_ms, plain_ms=pcl_ms,
                      bound_ms=cl_bound[0], bound_by=cl_bound[1], library_ms=None)


def bit_equal(a, b):
    """Two float32 tensors equal bit for bit."""
    import torch

    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def path_depths(idx, tile=128):
    """(share of slots with a winner, mean last live bounce, mean over warps
    of 32 neighbouring pixels of their longest path, mean over 128-pixel
    tiles of the depth they need) of an index tape [spp, D, N]. A path's
    last live bounce is 1 + the depth of its last winner (0 when its
    primary ray misses); a tile needs, as tracer/pallas/bwd.py:
    _needed_depth_per_tile counts it, its longest path's last live bounce +
    1 (the miss after it), at most D, over every sample."""
    import torch

    spp, depth, n = idx.shape
    hit = idx >= 0
    live = hit.double().mean().item()
    steps = torch.arange(1, depth + 1, dtype=torch.int16, device=idx.device)[None, :, None]
    last = (hit.to(torch.int16) * steps).amax(dim=1)  # [spp, N]
    mean_last = last.double().mean().item()
    warp = last.reshape(spp, n // 32, 32).amax(dim=-1).double().mean().item()
    need = torch.clamp(last + 1, max=depth)
    pad = -n % tile
    if pad:
        need = torch.nn.functional.pad(need, (0, pad))
    tiles = need.reshape(spp, -1, tile).amax(dim=-1).amax(dim=0).double().mean().item()
    return live, mean_last, warp, tiles


def hold_deep_shape(name, scene, cam, w, h, spp, chunk, depth, g, errs, band=40):
    """K1, K1-rec and K2 against their plain versions at one of phase 11's
    timed shapes, on the same inputs: K1's frame (all `spp` samples) and
    the last chunk's K1-rec tapes (13 fields textured) on 16384 pixels
    sampled over the frame (renderer.render_pixels, the same seeds), by
    phase 3's rules with the frame judged on its per-sample estimate; K2 on
    that chunk's tapes against the plain replay over the last `band` rows
    (row_offset): K2 launched on the band by compare_grads's rule, the
    whole-grid launch's replayed frame and texel cotangents on the band's
    pixels within TOL_GRAD of the plain version's max, and the whole-grid
    launch's dtable and dcam against the sum of its launches on the band
    and on the rows above it by compare_leaves's rule. Appends each
    comparison's max|diff| to `errs[kernel entry name]`; returns the
    verdict."""
    import torch

    from tracer_torch.kernels import bwd, replay
    from tracer_torch.kernels import megakernel as mk
    from tracer_torch.render import renderer

    dev, tex, n = scene.device, scene.textures is not None, w * h
    fields, start = (13 if tex else 9), spp - chunk
    i_all, j_all, seeds = renderer.pixel_grid(w, h, device=dev)
    sel = torch.randperm(n, generator=torch.Generator().manual_seed(0))[:16384].to(dev)
    npx = sel.numel()
    px = (i_all[sel], j_all[sel], seeds[sel])
    fb = mk.render_frame_kernel(scene, cam, w, h, spp, depth).reshape(-1, 3)
    ok = compare(f"K1 {name}: {npx} pixels vs plain (per-sample estimate)", fb[sel][:, None],
                 renderer.render_pixels(scene, cam, *px, spp, depth)[:, None],
                 errs["megakernel"], spp)
    del fb
    out = mk.render_frame_kernel_record(scene, cam, w, h, chunk, depth, sample_start=start,
                                        tape_fields=fields)
    want = renderer.render_pixels(scene, cam, *px, chunk, depth, sample_start=start,
                                  tape_fields=fields)
    got = (out[0].reshape(-1, 3)[sel][:, None], out[1][:, :, sel]) + (
        (out[2][:, :, sel],) if tex else ())
    want = (want[0][:, None], want[1]) + ((want[2],) if tex else ())
    ok &= compare_record(f"K1-rec {name}, samples {start}-{spp - 1}"
                         f"{f', {fields} fields' if tex else ''}: {npx} pixels vs plain", got,
                         want, errs["megakernel_record"], spp=chunk)
    del got, want

    table, camv = (t.detach() for t in bwd.pack_tables(scene, cam))
    rows, r0 = chunk * depth, h - band
    c0 = r0 * w
    idx2 = out[1].reshape(rows, n)
    t2 = bwd._field_major(out[2], chunk, depth, n) if tex else None
    g2 = torch.randn((n, 3), generator=g, device=dev)
    cols = lambda x, a, b: None if x is None else x[:, a:b].contiguous()
    kw = dict(sample_start=start, want_texgrad=tex)
    full = bwd.bwd_kernel(table, camv, idx2, g2, w, chunk, depth, t2=t2, **kw)
    b_idx, b_t2 = cols(idx2, c0, n), cols(t2, c0, n)
    k2_band = bwd.bwd_kernel(table, camv, b_idx, g2[c0:], w, chunk, depth, t2=b_t2,
                             row_offset=r0, **kw)
    plain = replay.replay_cotangents(table, camv, b_idx, g2[c0:], w, chunk, depth, t2=b_t2,
                                     row_offset=r0, **kw)
    ok &= compare_grads(f"K2 {name}, samples {start}-{spp - 1}, rows {r0}-{h - 1} "
                        f"(row_offset) vs the plain replay", scene, cam, k2_band, plain,
                        out[0].reshape(-1, 3)[c0:], errs["bwd"])
    del b_idx, b_t2
    fb_err, fb_scale = float((full[2][c0:] - plain[2]).abs().max()), float(plain[2].abs().max())
    col_ok = fb_err <= TOL_GRAD * fb_scale
    errs["bwd"].append(fb_err)
    gt = ""
    if tex:
        gt_err = float((full[3][:, c0:] - plain[3]).abs().max())
        gt_scale = float(plain[3].abs().max())
        col_ok &= gt_err <= TOL_GRAD * gt_scale and gt_scale > 0
        errs["bwd"].append(gt_err)
        gt = f", texel cotangents max|diff| {gt_err:.3g} (max {gt_scale:.3g})"
    rest = bwd.bwd_kernel(table, camv, cols(idx2, 0, c0), g2[:c0], w, chunk, depth,
                          t2=cols(t2, 0, c0), sample_start=start)
    s_ok, s_worst, s_abs = compare_leaves(
        bwd.leaf_names(scene, cam), bwd.leaf_cotangents(scene, cam, full[0], full[1]),
        bwd.leaf_cotangents(scene, cam, rest[0] + k2_band[0], rest[1] + k2_band[1]))
    errs["bwd"].append(s_abs)
    ok &= col_ok and s_ok
    print(f"    K2 {name}, whole grid: on rows {r0}-{h - 1} vs the plain replay, replayed frame "
          f"max|diff| {fb_err:.3g} (max {fb_scale:.3g}){gt}; dtable and dcam vs its launches on "
          f"rows 0-{r0 - 1} and {r0}-{h - 1} summed, worst leaf max|diff|/max|g| {s_worst:.3g} "
          f"(<= {TOL_GRAD}) -> {'ok' if col_ok and s_ok else 'FAIL'}", flush=True)
    return ok


def deep_phase(dev, kind, card, canon, canon_p, g):
    """Phase 11: the depth-50 gradient path (scene_grads_chunked,
    l2_grads_deep, the 3-field tape and the replay modes). Returns (error or
    None, its main path's launches {kernel entry name: n}, its comparisons'
    max|diff| {kernel entry name: [x, ...]})."""
    import torch

    from tracer_torch.kernels import bwd, diff, replay, tex_scatter
    from tracer_torch.kernels import megakernel as mk
    from tracer_torch.render import camera as C
    from tracer_torch.render import integrator

    D = 50
    errs = {k: [] for k in ("megakernel", "megakernel_record", "bwd", "tex_scatter")}
    cam_at = lambda w, h: C.camera_at(canon_p.camera_path, 0, canon_p.num_frames, w, h,
                                      canon_p.fov_degrees, device=dev)
    th, tw = canon.textures.shape[1:3]
    print(f"[11] depth-{D} gradient path on {kind} ({card}): canonical scene + {th}x{tw} "
          f"texture, camera path frame 0", flush=True)

    # the 3-field tape: fields 0-2 of the 9-field tape, bit for bit
    cam = cam_at(256, 192)
    three = mk.render_frame_kernel_record(canon, cam, 256, 192, 4, 8, tape_fields=3)
    nine = mk.render_frame_kernel_record(canon, cam, 256, 192, 4, 8, tape_fields=9)
    ok = (bit_equal(three[0], nine[0]) and torch.equal(three[1], nine[1])
          and bit_equal(three[2], nine[2][..., :3]) and bool((three[2] != 1.0).any()))
    print(f"  K1-rec 3-field tape vs fields 0-2 of the 9-field tape, 256x192 spp4 d8: "
          f"frame, index tape and texel fields bit-equal -> {'ok' if ok else 'FAIL'}", flush=True)
    del three, nine
    if not ok:
        return "the 3-field tape is not the head of the 9-field tape", None, None

    # chunked kernels against the one-shot kernels
    w, h, spp = 256, 192, 8
    cam = cam_at(w, h)
    g_fb = torch.randn((h, w, 3), generator=g, device=dev)
    names = bwd.leaf_names(canon, cam)
    got = bwd.float_grads(canon, *bwd.scene_grads_chunked(canon, cam, g_fb, w, h, spp, D,
                                                         spp_chunk=2))
    leaves = [x.detach().clone().requires_grad_() for x in bwd.float_leaves(canon, cam)]
    fb = diff.render_frame_diff(*bwd.with_float_leaves(canon, cam, leaves), w, h, spp, D)
    want = torch.autograd.grad(fb, leaves, g_fb)
    ok, worst, worst_abs = compare_leaves(names, got, want)
    errs["bwd"].append(worst_abs)
    print(f"  scene_grads_chunked(spp_chunk=2) vs render_frame_diff + backward, {w}x{h} spp{spp} "
          f"d{D}: worst leaf max|diff|/max|g| {worst:.3g} (<= {TOL_GRAD}) -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        return "chunked and one-shot gradients disagree", None, None
    del fb, want, leaves

    # chunked kernels against the chunked plain version, fed the same tapes
    w, h, spp, chunk = 64, 48, 4, 2
    cam = cam_at(w, h)
    g_fb = torch.randn((h, w, 3), generator=g, device=dev)
    g_scene, g_cam = bwd.scene_grads_chunked(canon, cam, g_fb, w, h, spp, D, spp_chunk=chunk,
                                             texture_grads=True)
    table, camv = (t.detach() for t in bwd.pack_tables(canon, cam))
    dtable, dcam = torch.zeros_like(table), torch.zeros_like(camv)
    dtex = torch.zeros((th, tw, 3), device=dev)
    for c in range(spp // chunk):
        out = mk.render_frame_kernel_record(canon, cam, w, h, chunk, D, sample_start=c * chunk,
                                            tape_fields=13)
        t2 = bwd._field_major(out[2], chunk, D, w * h)
        r = replay.replay_cotangents(table, camv, out[1].reshape(chunk * D, -1),
                                     g_fb.reshape(-1, 3), w, chunk, D, sample_start=c * chunk,
                                     t2=t2, want_texgrad=True)
        dtable += r[0]
        dcam += r[1]
        dtex += bwd.texture_image_grads(r[3], t2, chunk, D, th, tw)
    ok, worst, worst_abs = compare_leaves(names, bwd.float_grads(canon, g_scene, g_cam),
                                          bwd.leaf_cotangents(canon, cam, dtable, dcam))
    t_err, t_scale = float((g_scene.textures[0] - dtex).abs().max()), float(dtex.abs().max())
    ok &= t_err <= TOL_GRAD * t_scale and t_scale > 0
    errs["bwd"].append(worst_abs)
    errs["tex_scatter"].append(t_err)
    print(f"  scene_grads_chunked(spp_chunk={chunk}, texture_grads=True) vs the plain replay and "
          f"scatter on each chunk's tapes, {w}x{h} spp{spp} d{D}: worst leaf max|diff|/max|g| "
          f"{worst:.3g}, texture max|diff| {t_err:.3g} (max {t_scale:.3g}) -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        return "chunked kernels and chunked plain version disagree", None, None

    # l2_grads_deep's loss against the loss of a K1 frame
    target = torch.rand((h, w, 3), generator=g, device=dev)
    loss, _, _ = bwd.l2_grads_deep(canon, cam, target, w, h, spp, D, spp_chunk=chunk)
    ref = torch.mean((mk.render_frame_kernel(canon, cam, w, h, spp, D) / spp - target) ** 2)
    rel = abs(float(loss) - float(ref)) / float(ref)
    print(f"  l2_grads_deep loss {float(loss):.9g}, from a K1 frame {float(ref):.9g}: rel "
          f"{rel:.3g} (<= 1e-6) -> {'ok' if rel <= 1e-6 else 'FAIL'}", flush=True)
    if rel > 1e-6:
        return "l2_grads_deep's loss is not the K1 frame's", None, None

    # the replay modes against replay-kernel: the material colours' gradients
    w, h, spp, d8 = 64, 48, 2, 8
    cam = cam_at(w, h)
    g_fb = torch.randn((h, w, 3), generator=g, device=dev)
    grads = {}
    for mode in ("replay-kernel", "replay", "replay-sample"):
        leaves = [x.detach().clone().requires_grad_() for x in bwd.float_leaves(canon, cam)]
        fb = diff.render_frame_diff(*bwd.with_float_leaves(canon, cam, leaves), w, h, spp, d8,
                                    mode=mode)
        grads[mode] = torch.autograd.grad(fb, leaves, g_fb)
    colours = [k for k, n in enumerate(names) if n in ("materials.albedo", "materials.emit")]
    for mode in ("replay", "replay-sample"):
        ok, worst, _ = compare_leaves([names[k] for k in colours],
                                      [grads[mode][k] for k in colours],
                                      [grads["replay-kernel"][k] for k in colours])
        rest = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(grads[mode], grads["replay-kernel"]))
        print(f"  mode {mode!r} vs 'replay-kernel', {w}x{h} spp{spp} d{d8}: materials.albedo and "
              f"emit worst max|diff|/max|g| {worst:.3g} (<= {TOL_GRAD}); every leaf {rest:.3g} "
              f"-> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            return f"mode {mode!r} and replay-kernel disagree on the material colours", None, None
    del grads, leaves, fb

    # the main path of this phase: one l2_grads_deep with texture-image
    # gradients at 800x600 spp32 d50, chunks of 8 (13-field tapes of more
    # than 2^31 elements)
    w, h, spp, chunk = 800, 600, 32, 8
    cam = cam_at(w, h)
    truth = canon._replace(materials=canon.materials._replace(albedo=canon.materials.albedo * 0.85))
    target = mk.render_frame_kernel(truth, cam, w, h, spp, D) / spp
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    launch_counts(reset=True)
    t0 = time.perf_counter()
    loss, g_scene, g_cam = bwd.l2_grads_deep(canon, cam, target, w, h, spp, D, spp_chunk=chunk,
                                             texture_grads=True)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) - base
    tape13 = mk.tape_bytes(w, h, chunk, D, 13, True)
    flat = bwd.float_grads(canon, g_scene, g_cam)
    finite = math.isfinite(float(loss)) and all(bool(torch.isfinite(x).all()) for x in flat)
    tex_nz = float((g_scene.textures != 0).double().mean())
    print(f"  main path: l2_grads_deep(texture_grads=True) at {w}x{h} spp{spp} d{D}, spp_chunk "
          f"{chunk}: loss {float(loss):.9g}, {step_s * 1e3:.3f} ms (host clock, first call); "
          f"launches {launches}; gradients finite {finite}, {tex_nz:.4f} of texels touched; "
          f"a chunk's tapes {tape13} bytes ({13 * chunk * D * w * h} texture-tape elements), "
          f"peak device memory above the inputs {peak} bytes", flush=True)
    want = dict(megakernel=1, megakernel_record=spp // chunk, bwd=spp // chunk,
                tex_scatter=spp // chunk, megakernel_clustered=0, megakernel_bvh=0,
                megakernel_ref=0)
    if launches != want:
        return f"the d{D} main path launched {launches}, not {want}", None, None
    if not finite or tex_nz == 0.0:
        return f"the d{D} gradients are not finite, or the texture got none", None, None
    del g_scene, g_cam, flat

    # one chunk's 13-field tape past 2^31 elements: fields 0-8 are the
    # 9-field tape's bit for bit, the addressing fields 9-12 fetch the
    # recorded texel, and K3 agrees with the plain scatter on them
    out13 = mk.render_frame_kernel_record(canon, cam, w, h, chunk, D, tape_fields=13)
    out9 = mk.render_frame_kernel_record(canon, cam, w, h, chunk, D, tape_fields=9)
    ok = (bit_equal(out13[0], out9[0]) and torch.equal(out13[1], out9[1])
          and bit_equal(out13[2][..., :9], out9[2]))
    del out9
    tex0 = canon.textures[0]
    fetched = worst_fetch = 0
    for s in range(chunk):
        f = out13[2][s].reshape(-1, 13)
        sel = f[:, 9:].ne(0).any(dim=1)
        f = f[sel]
        x0, y0, fu, fv = f[:, 9].long(), f[:, 10].long(), f[:, 11:12], f[:, 12:13]
        x1, y1 = torch.where(x0 + 1 < tw, x0 + 1, 0), torch.where(y0 + 1 < th, y0 + 1, 0)
        top = tex0[y0, x0] * (1.0 - fu) + tex0[y0, x1] * fu
        bot = tex0[y1, x0] * (1.0 - fu) + tex0[y1, x1] * fu
        err = float((top * (1.0 - fv) + bot * fv - f[:, :3]).abs().max()) if len(f) else 0.0
        fetched += len(f)
        worst_fetch = max(worst_fetch, err)
    ok &= fetched > 0 and worst_fetch <= 1e-5
    table, camv = (t.detach() for t in bwd.pack_tables(canon, cam))
    t2 = bwd._field_major(out13[2], chunk, D, w * h)
    idx2 = out13[1].reshape(chunk * D, -1)
    g2 = torch.randn((w * h, 3), generator=g, device=dev)
    gtex = bwd.bwd_kernel(table, camv, idx2, g2, w, chunk, D, t2=t2, want_texgrad=True)[3]
    k3 = tex_scatter.texture_image_grads_kernel(gtex, t2, chunk, D, th, tw)
    plain3 = bwd.texture_image_grads(gtex, t2, chunk, D, th, tw)
    k3_ok = torch.allclose(k3, plain3, rtol=1e-5, atol=1e-5) and float(plain3.abs().max()) > 0
    errs["tex_scatter"].append(float((k3 - plain3).abs().max()))
    ok &= k3_ok
    print(f"  one chunk's 13-field tape at {w}x{h} spp{chunk} d{D} ({t2.numel()} elements): "
          f"fields 0-8 bit-equal to the 9-field tape's; {fetched} textured slots' addressing "
          f"fetches their texel to {worst_fetch:.3g} (<= 1e-5); K3 vs the plain scatter max|diff| "
          f"{float((k3 - plain3).abs().max()):.3g} -> {'ok' if ok else 'FAIL'}", flush=True)
    del out13, t2, idx2, gtex, k3, plain3
    if not ok:
        return "the 13-field tape past 2^31 elements is wrong", None, None

    # times: l2_grads_deep best of 3 (host clock), each kernel best of 3
    # (CUDA events) at its shape in the step; the tapes' live slots
    untex = canon._replace(textures=None)
    print(f"  times on {kind} ({card}), best of 3 after the main path's warm-up:", flush=True)
    print(f"    shape | fwd+bwd ms | fwd+bwd Mrays/s | K1 ms | K1 ms at spp{chunk} | K1-rec ms a "
          f"chunk | the tapes' neutral fill ms a chunk | K2 ms a chunk | chunks | a chunk's tapes "
          f"bytes | launches K1/K1-rec/K2 | peak bytes", flush=True)
    stats, checks = {}, []
    for name, scene, w, h, spp, tex in (("800x600 spp32 d50 textured", canon, 800, 600, 32, True),
                                        ("1080x720 spp64 d50 untextured", untex, 1080, 720, 64,
                                         False)):
        cam = cam_at(w, h)
        truth = scene._replace(materials=scene.materials._replace(
            albedo=scene.materials.albedo * 0.85))
        target = mk.render_frame_kernel(truth, cam, w, h, spp, D) / spp
        step_s = math.inf
        for _ in range(3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            mk.LAUNCHES = mk.LAUNCHES_RECORD = bwd.LAUNCHES = 0
            t0 = time.perf_counter()
            bwd.l2_grads_deep(scene, cam, target, w, h, spp, D, spp_chunk=chunk)
            torch.cuda.synchronize()
            step_s = min(step_s, time.perf_counter() - t0)
        counts = (mk.LAUNCHES, mk.LAUNCHES_RECORD, bwd.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev) - base
        k1_ms = cuda_ms(lambda: mk.render_frame_kernel(scene, cam, w, h, spp, D), reps=3)
        k1c_ms = cuda_ms(lambda: mk.render_frame_kernel(scene, cam, w, h, chunk, D), reps=3)
        rec_ms = cuda_ms(lambda: mk.render_frame_kernel_record(scene, cam, w, h, chunk, D),
                         reps=3)
        # the tapes' neutral fill alone, as megakernel._record makes them
        fill = lambda: (
            torch.full((chunk, D, w * h), -1, dtype=torch.int32, device=dev),
            torch.tensor(integrator.TAPE_NEUTRAL[:9], device=dev)[:, None, None, None]
            .expand(9, chunk, D, w * h).contiguous() if tex else None)
        fill_ms = cuda_ms(fill, reps=3)
        out = mk.render_frame_kernel_record(scene, cam, w, h, chunk, D)
        table, camv = (t.detach() for t in bwd.pack_tables(scene, cam))
        idx2 = out[1].reshape(chunk * D, -1)
        t2 = bwd._field_major(out[2], chunk, D, w * h) if tex else None
        g2 = torch.randn((w * h, 3), generator=g, device=dev)
        k2_ms = cuda_ms(lambda: bwd.bwd_kernel(table, camv, idx2, g2, w, chunk, D, t2=t2), reps=3)
        stats[name] = path_depths(out[1])
        rays = w * h * spp
        print(f"    {name} | {step_s * 1e3:.3f} | {rays / step_s / 1e6:.3f} | {k1_ms:.3f} | "
              f"{k1c_ms:.3f} | {rec_ms:.3f} | {fill_ms:.3f} | {k2_ms:.3f} | {spp // chunk} | "
              f"{mk.tape_bytes(w, h, chunk, D, 9, tex)} | {'/'.join(map(str, counts))} | {peak}",
              flush=True)
        del out, idx2, t2, target
        checks.append((name, scene, cam, w, h, spp))
    # the same chunk at depth 8: K2's time where no path outlives bounce 8
    cam = cam_at(800, 600)
    out = mk.render_frame_kernel_record(canon, cam, 800, 600, chunk, 8)
    table, camv = (t.detach() for t in bwd.pack_tables(canon, cam))
    idx2 = out[1].reshape(chunk * 8, -1)
    t2 = bwd._field_major(out[2], chunk, 8, 800 * 600)
    g2 = torch.randn((800 * 600, 3), generator=g, device=dev)
    k2_d8 = cuda_ms(lambda: bwd.bwd_kernel(table, camv, idx2, g2, 800, chunk, 8, t2=t2), reps=3)
    print(f"    K2 on a chunk of 8 samples at 800x600 d8 textured: {k2_d8:.3f} ms", flush=True)
    stats["800x600 spp8 d8 textured"] = path_depths(out[1])
    del out, idx2, t2
    print("    tape slots (one chunk of 8 samples, camera frame 0) | with a winner | mean last live "
          "bounce | mean over 32-pixel warps of the longest | mean over 128-pixel tiles of the "
          "depth needed (tracer/pallas/bwd.py:_needed_depth_per_tile)", flush=True)
    for name, (live, last, warp, tiles) in stats.items():
        print(f"    {name} | {live:.6f} | {last:.4f} | {warp:.4f} | {tiles:.4f}", flush=True)
    print(f"    card: {card}", flush=True)

    # K1, K1-rec and K2 against their plain versions at the timed shapes
    print("  K1, K1-rec and K2 vs plain at the timed shapes, camera frame 0:", flush=True)
    for name, scene, cam, w, h, spp in checks:
        if not hold_deep_shape(name, scene, cam, w, h, spp, chunk, D, g, errs):
            return f"a kernel and its plain version disagree at {name}", None, None
    return None, launches, errs


def stratify_phase(dev, kind, card, canon, canon_p, g):
    """Phase 12: stratified jitter (strat_k) in K1, K1-rec (3, 9 and 13
    fields), K1-cl and K2, each against its plain version by phase 3's
    rules and TOL_GRAD, then a chunked stratified animation against a
    one-launch frame of the same samples. Returns (error or None, the
    comparisons' max|diff| {kernel entry name: [x, ...]})."""
    import torch

    from torch_scenes import SKY, full_scene

    from tracer_torch.kernels import bwd, replay
    from tracer_torch.kernels import megakernel as mk
    from tracer_torch.render import camera as C
    from tracer_torch.render import driver, renderer

    errs = {k: [] for k in ("megakernel", "megakernel_record", "bwd", "megakernel_clustered")}
    t0 = time.perf_counter()
    print(f"[12] stratified jitter (strat_k) on {kind} ({card}):", flush=True)
    cam_c = C.camera_at(canon_p.camera_path, 0, canon_p.num_frames, 96, 64, canon_p.fov_degrees,
                        background=SKY, device=dev)
    ok = True
    for name, kw, key in (("K1", {}, "megakernel"),
                          ("K1-cl", dict(cluster_k=CLUSTER_K), "megakernel_clustered")):
        for spp, extra in ((4, {}), (5, dict(strat_sqrt_spp=3, sample_start=4))):
            got = mk.render_frame_kernel(canon, cam_c, 96, 64, spp, 50, stratify=True, **kw,
                                         **extra)
            torch.cuda.synchronize()
            want = renderer.render_frame(canon, cam_c, 96, 64, spp, 50, stratify=True, **kw,
                                         **extra)
            ok &= compare(f"{name} stratified, canonical + texture 96x64 spp{spp} d50 {extra}",
                          got, want, errs[key])
    if not ok:
        return "a stratified kernel and its plain version disagree", None
    full = full_scene(dev)
    cam_f = C.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 64, 48, 55.0, background=SKY,
                                device=dev)
    for fields in (3, 9, 13):
        got = mk.render_frame_kernel_record(full, cam_f, 64, 48, 4, 8, rr_start=3,
                                            tape_fields=fields, stratify=True)
        torch.cuda.synchronize()
        want = renderer.render_frame_record(full, cam_f, 64, 48, 4, 8, rr_start=3,
                                            tape_fields=fields, stratify=True)
        ok &= compare_record(f"K1-rec stratified, all materials 64x48 spp4 d8 rr_start=3, "
                             f"{fields} fields", got, want, errs["megakernel_record"])
    if not ok:
        return "the stratified record kernel and the plain record disagree", None
    # K2 on the stratified 13-field tape (the last one recorded)
    table, camv = bwd.pack_tables(full, cam_f)
    idx2 = got[1].reshape(4 * 8, -1)
    t2 = bwd._field_major(got[2], 4, 8, 64 * 48)
    g2 = torch.randn((64 * 48, 3), generator=g, device=dev)
    kw = dict(rr_start=3, t2=t2, want_texgrad=True, strat_k=2)
    k2 = bwd.bwd_kernel(table, camv, idx2, g2, 64, 4, 8, **kw)
    torch.cuda.synchronize()
    plain = replay.replay_cotangents(table, camv, idx2, g2, 64, 4, 8, **kw)
    if not compare_grads("K2 stratified (strat_k 2) on the stratified 13-field tape", full,
                         cam_f, k2, plain, got[0], errs["bwd"]):
        return "the stratified backward kernel and the plain replay disagree", None
    uniform = bwd.bwd_kernel(table, camv, idx2, g2, 64, 4, 8, rr_start=3, t2=t2)
    moved = float((uniform[2] - got[0].reshape(-1, 3)).abs().max())
    print(f"    K2 without the grid replays other rays: replayed frame vs recorded max|diff| "
          f"{moved:.3g}", flush=True)
    if moved <= TOL_GRAD * float(got[0].abs().max()):
        return "the backward kernel ignores strat_k", None
    del got, want, k2, plain, uniform, t2, idx2

    # a chunked stratified animation (chunks 6, 6, 4: not square) against
    # one launch of the same 16 samples
    params = config_copy(canon_p)
    params.render.sqrt_rays_per_pixel = 4
    w, h, d = params.width, params.height, params.render.max_depth
    with tempfile.TemporaryDirectory() as tmp:
        params.output_path = os.path.join(tmp, "frame_%d.bin")
        mk.LAUNCHES = 0
        fb = driver.render_animation(canon, params, saver="bin", out=io.StringIO(), frames=[0],
                                     engine="cuda", stratify=True, spp_chunk=6)
        chunks = mk.LAUNCHES
    cam0 = C.camera_at(params.camera_path, 0, params.num_frames, w, h, params.fov_degrees,
                       device=dev)
    one = mk.render_frame_kernel(canon, cam0, w, h, 16, d, stratify=True)
    got = torch.tensor(fb, device=dev)
    diff = float((got - one).abs().max())
    same = bool(torch.allclose(got, one, rtol=1e-5, atol=1e-4))
    uniform = mk.render_frame_kernel(canon, cam0, w, h, 16, d)
    print(f"    render_animation(stratify=True) at {w}x{h} sqrt_spp 4 d{d}, spp_chunk 6: "
          f"{chunks} launches (chunks 6, 6, 4); against one stratified launch of the 16 "
          f"samples max|diff| {diff:.3g} (max {float(one.abs().max()):.3g}; float32 addition "
          f"order: rtol 1e-5, atol 1e-4) -> {'ok' if same and chunks == 3 else 'FAIL'}; the "
          f"uniform frame differs by {float((uniform - one).abs().max()):.3g}", flush=True)
    if not same or chunks != 3:
        return "a chunked stratified frame is not the one-launch frame", None
    errs["megakernel"].append(diff)
    # what the grid costs K1: 800x600 spp16 d50 textured, camera path frames
    # 1-3, uniform and stratified in turns, best of 3 after a warm-up each
    cams = [C.camera_at(canon_p.camera_path, k, canon_p.num_frames, 800, 600,
                        canon_p.fov_degrees, device=dev) for k in range(4)]
    best = {False: math.inf, True: math.inf}
    for strat in (False, True):
        mk.render_frame_kernel(canon, cams[0], 800, 600, 16, 50, stratify=strat)
    for c in cams[1:]:
        for strat in (False, True):
            best[strat] = min(best[strat], cuda_ms(lambda: mk.render_frame_kernel(
                canon, c, 800, 600, 16, 50, stratify=strat)))
    print(f"    K1 800x600 spp16 d50 textured: uniform {best[False]:.3f} ms, stratified "
          f"{best[True]:.3f} ms ({(best[True] / best[False] - 1) * 100:+.2f}%); card: {card}",
          flush=True)
    print(f"    phase 12: {time.perf_counter() - t0:.1f} s", flush=True)
    return None, errs


def config_copy(params):
    import copy

    return copy.deepcopy(params)


def bvh_work_line(work):
    """K1-bvh's walk per nearest-hit query, from a LoopWork."""
    q = max(work.queries, 1)
    return (f"{work.node_tests / q:.3f} node tests, {work.visits / q:.3f} leaves reached "
            f"(= primitive tests), lane utilisation {work.lane_utilisation:.4f}")


BVH_SWEEP = (250, 500, 1000, 2000, 5000, 10000, 20000)  # benchmarks/prim_scaling.py's n
SW_SPP, SW_D = 4, 10


def best_of_cameras(scene, cam_list, w, h, spp, depth, **kw):
    """render_frame_kernel's best time over cam_list[1:] after a warm-up on
    cam_list[0], in ms (CUDA events)."""
    from tracer_torch.kernels import megakernel as mk

    mk.render_frame_kernel(scene, cam_list[0], w, h, spp, depth, **kw)
    return min(cuda_ms(lambda c=c: mk.render_frame_kernel(scene, c, w, h, spp, depth, **kw))
               for c in cam_list[1:])


def sweep_scene(n, dev, w, h):
    """The sweep's field of n spheres with its BVH, and its camera."""
    from torch_scenes import sphere_field, sphere_field_camera

    from tracer_torch.bvh import builder as bb

    scene, cols = sphere_field(n, dev)
    return (scene._replace(bvh=bb.build_scene_bvh_from_scene(scene)),
            sphere_field_camera(cols, w, h, dev))


def bvh_times(dev, canon, field, cams, w, h):
    """K1-bvh's timed shapes, {shape: best_of_cameras ms}: the canonical
    scene (`canon`, textured, with its BVH) at spp32 d50 textured,
    untextured, with its records in global memory, and K1-bvh-ref textured;
    the 2000-sphere `field` at spp8 d20 with and without rr_start=3; the
    sweep. Phase 13 prints them; bvh_ab.py times them on two trees."""
    from tracer_torch.kernels import megakernel as mk

    def t(scene, cam_list, spp, depth, **kw):
        return best_of_cameras(scene, cam_list, w, h, spp, depth, intersector="bvh", **kw)

    out = {"canonical textured spp32 d50": t(canon, cams, 32, 50),
           "canonical untextured spp32 d50": t(canon._replace(textures=None), cams, 32, 50),
           "K1-bvh-ref canonical textured spp32 d50": t(canon, cams, 32, 50,
                                                         rng_mode="reference")}
    saved, mk.NODE_SHARED_BYTES_MAX = mk.NODE_SHARED_BYTES_MAX, -1
    try:
        out["canonical textured, records in global memory"] = t(canon, cams, 32, 50)
    finally:
        mk.NODE_SHARED_BYTES_MAX = saved
    for rr in (None, 3):
        out[f"field n=2000 spp8 d20 rr_start={rr}"] = t(field, cams, 8, 20, rr_start=rr)
    for n in BVH_SWEEP:
        scene_n, cam_n = sweep_scene(n, dev, w, h)
        out[f"sweep n={n} spp{SW_SPP} d{SW_D} rr_start=3"] = t(scene_n, [cam_n] * 4, SW_SPP,
                                                               SW_D, rr_start=3)
    return out


def bvh_phase(dev, kind, card, canon_p, cams, W, H, k1_ms, env):
    """Phase 13: the BVH path. The builders' times; K1-bvh against the
    plain traversal; the slice's main path, render_animation(engine="cuda",
    intersector="bvh", stratify=True) at full width, and the CLI with
    --gpu --bvh --stratify; K1-bvh's times and work beside K1 and K1-cl.
    Returns (error or None, the kernel's entry of the `kernels` line)."""
    import numpy as np
    import torch

    from torch_scenes import SKY, sphere_field, sphere_field_fields

    from tracer_torch.bvh import builder as bb
    from tracer_torch.bvh import native
    from tracer_torch.io import image as image_io
    from tracer_torch.kernels import bwd, pack, tex_scatter
    from tracer_torch.kernels import megakernel as mk
    from tracer_torch.render import camera as C
    from tracer_torch.render import driver, renderer
    from tracer_torch.scene import builders, config

    t_phase = time.perf_counter()
    errs = []
    builder = "native (g++)" if bb.native_available() else "numpy (no g++ on this host)"
    print(f"[13] the BVH path on {kind} ({card}); create_scene(with_bvh=True) takes the "
          f"{builder} builder", flush=True)
    # the builders' times
    canon = builders.create_scene(canon_p, with_bvh=True, texture_loader=synthetic_floor,
                                  device=dev)
    sp, pl = canon.spheres, canon.planes
    host = lambda t: t.detach().cpu().numpy()
    sets = [("canonical", bb.primitive_boxes(host(sp.center), host(sp.radius), host(pl.base),
                                             host(pl.u), host(pl.v), host(pl.ptype)))]
    for n in (2000, 20000):
        f, _ = sphere_field_fields(n)
        sets.append((f"field n={n}", bb.primitive_boxes(
            f["spheres.center"], f["spheres.radius"], f["planes.base"], f["planes.u"],
            f["planes.v"], f["planes.ptype"])))
    for name, boxes in sets:
        times = {}
        for b_name, build in (("native", native.build_bvh if bb.native_available() else None),
                              ("numpy", bb.build_bvh_numpy)):
            if build is None:
                times[b_name] = "not available"
                continue
            t0 = time.perf_counter()
            tree = build(*boxes)
            times[b_name] = f"{(time.perf_counter() - t0) * 1e3:.3f} ms"
        print(f"    build {name} ({len(boxes[3])} primitives, {tree[2].shape[0]} nodes, depth "
              f"{bb.tree_depth(tree[2], tree[3])}): native {times['native']}, numpy "
              f"{times['numpy']}", flush=True)

    # K1-bvh against the plain traversal (and against K1)
    field, _ = sphere_field(2000, dev)
    field = field._replace(bvh=bb.build_scene_bvh_from_scene(field))
    nodes_b = lambda s: 4 * pack.pack_bvh(s, mk.BVH_STACK).numel()  # the child-pair records
    where = lambda s: "shared" if nodes_b(s) <= mk.NODE_SHARED_BYTES_MAX else "global"
    cam_c = C.camera_at(canon_p.camera_path, 0, canon_p.num_frames, 64, 48, canon_p.fov_degrees,
                        background=SKY, device=dev)
    # the field at 256x192, camera path frame 1, black background (phase 10's
    # view): its paths turn last-bit differences into other paths (a bounce
    # leaving a sphere may hit it again just past T_MIN), and torch's CUDA
    # sqrt, sin, cos, exp and atan2 round otherwise than the kernel's, so at
    # 64x48 the frame mean of K1 against the plain brute version already
    # moves by 2e-3; at 256x192 both hold phase 3's rules
    cam_f = C.camera_at(canon_p.camera_path, 1, canon_p.num_frames, 256, 192,
                        canon_p.fov_degrees, device=dev)
    timed = {}
    for name, scene, cam, w, h, spp, depth in (
            ("canonical + texture", canon, cam_c, 64, 48, 2, 5),
            ("sphere field n=2000", field, cam_f, 256, 192, 2, 10)):
        got = mk.render_frame_kernel(scene, cam, w, h, spp, depth, intersector="bvh")
        ms = cuda_ms(lambda: mk.render_frame_kernel(scene, cam, w, h, spp, depth,
                                                    intersector="bvh"), reps=3)
        out = {}
        p_ms = cuda_ms(lambda: out.update(fb=renderer.render_frame(
            scene, cam, w, h, spp, depth, intersector="bvh")))
        want = out.pop("fb")
        k1 = mk.render_frame_kernel(scene, cam, w, h, spp, depth)
        print(f"  {name}: {scene.bvh.left.shape[0]} nodes, {nodes_b(scene) // 64} child-pair "
              f"records ({nodes_b(scene)} bytes) in {where(scene)} memory", flush=True)
        if not compare(f"K1-bvh vs the plain traversal, {w}x{h} spp{spp} d{depth}", got, want,
                       errs):
            return f"K1-bvh and the plain traversal disagree on the {name}", None
        bit = (got == want).all(dim=-1).double().mean().item()
        agree_k1 = ((got - k1).abs().amax(dim=-1) < TOL_PIXEL).double().mean().item()
        bit_k1 = (got == k1).all(dim=-1).double().mean().item()
        print(f"    bit-equal to the plain traversal {bit:.6f}; agree with K1 {agree_k1:.6f} "
              f"(bit-equal {bit_k1:.6f}); K1-bvh {ms:.3f} ms, plain {p_ms:.3f} ms", flush=True)
        compare(f"  beside it, K1 vs the plain brute version (not a gate)", k1,
                renderer.render_frame(scene, cam, w, h, spp, depth), [])
        timed[name] = (ms, p_ms, scene, cam, w, h, spp, depth)
    del got, want, k1

    # the slice's main path at full width: 2 frames of the canonical config,
    # BVH and stratified, chunked
    main_p = config_copy(canon_p)
    main_p.render.sqrt_rays_per_pixel = 4
    spp, frames, chunk = 16, range(2), 6
    w, h, d = main_p.width, main_p.height, main_p.render.max_depth
    with tempfile.TemporaryDirectory() as tmp:
        main_p.output_path = os.path.join(tmp, "frame_%d.bin")
        print(f"  main path: render_animation(engine='cuda', intersector='bvh', stratify=True), "
              f"canonical config, {canon.num_spheres} spheres + {canon.num_planes} planes, "
              f"{w}x{h}, depth {d}, floor texture {tuple(canon.textures.shape[1:3])}; reduced: "
              f"frames 100 -> {len(frames)}, sqrt_spp 50 -> 4 (run time limit); spp_chunk "
              f"{chunk}", flush=True)
        tsv = io.StringIO()
        launch_counts(reset=True)
        fb = driver.render_animation(canon, main_p, saver="bin", out=tsv, frames=frames,
                                     engine="cuda", intersector="bvh", stratify=True,
                                     spp_chunk=chunk)
        launches = launch_counts()
        want_l = len(frames) * math.ceil(spp / chunk)
        print("    TSV: " + tsv.getvalue().strip().replace("\n", " | "))
        print(f"    launches {launches} (K1-bvh: frames x chunks = {want_l})", flush=True)
        if launches["megakernel_bvh"] != want_l or sum(launches.values()) != want_l:
            return f"the BVH main path launched {launches}, not K1-bvh {want_l} times", None
        for n in frames:
            img = image_io.read_binary(main_p.output_path % n)
            print(f"    frame {n}: {img.shape} uint8, mean {img.mean():.4f}, nonzero "
                  f"{(img > 0).mean():.4f}")
            if img.shape != (h, w, 3) or not img.any():
                return f"BVH main-path frame {n} is empty or misshapen", None
    if fb.shape != (h, w, 3) or not np.isfinite(fb).all():
        return "BVH main-path framebuffer is not finite [H, W, 3]", None
    npx = 512
    sel = torch.randperm(w * h, generator=torch.Generator().manual_seed(0))[:npx].to(dev)
    i_all, j_all, seeds = renderer.pixel_grid(w, h, device=dev)
    cam_last = C.camera_at(main_p.camera_path, frames[-1], main_p.num_frames, w, h,
                           main_p.fov_degrees, device=dev)
    t0 = time.perf_counter()
    plain = renderer.render_pixels(canon, cam_last, i_all[sel], j_all[sel], seeds[sel], spp, d,
                                   stratify=True, intersector="bvh")
    got = torch.tensor(fb, device=dev).reshape(-1, 3)[sel]
    if not compare(f"main path frame {frames[-1]}: {npx} pixels vs the plain traversal "
                   f"({time.perf_counter() - t0:.1f} s)", got[:, None], plain[:, None], errs):
        return "the BVH main-path frame disagrees with the plain version", None
    cfg = config.default_config_text().replace("\n50 50\n", "\n50 2\n")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tracer_torch.cli", "--gpu", "--bvh", "--stratify",
             "--frames", "1", "--format", "bin"],
            input=cfg, capture_output=True, text=True, cwd=tmp, env=env, timeout=300)
        print(f"    CLI --gpu --bvh --stratify (default config, sqrt_spp 2, untextured: no "
              f"floor.jpg): rc {proc.returncode} in {time.perf_counter() - t0:.1f} s, stdout "
              f"{proc.stdout.strip()!r}", flush=True)
        if proc.returncode != 0:
            return f"CLI --gpu --bvh --stratify failed:\n{proc.stderr[-3000:]}", None
        img = image_io.read_binary(os.path.join(tmp, "images", "render_0.png"))
        line = proc.stdout.strip().split("\t")
        if len(line) != 3 or line[0] != "0" or not img.any():
            return "CLI --bvh output is not one TSV line and a nonzero frame", None

    # times and work
    print(f"  times on {kind} ({card}), CUDA events, best of 3 after a warm-up; work from the "
          f"counted instantiation (megakernel.loop_work):", flush=True)
    untex = canon._replace(textures=None)
    t_bvh = bvh_times(dev, canon, field, cams, W, H)
    rays = W * H * 32
    for name, scene in (("textured", canon), ("untextured", untex)):
        t_b = t_bvh[f"canonical {name} spp32 d50"]
        t_k = best_of_cameras(scene, cams, W, H, 32, 50) if name == "untextured" else k1_ms
        work = mk.loop_work(scene, cams[1], W, H, 32, 50, intersector="bvh")
        print(f"    canonical {name} {W}x{H} spp32 d50: K1-bvh {t_b:.3f} ms = "
              f"{rays / t_b / 1e3:.3f} Mrays/s, K1 {t_k:.3f} ms ({'phase 5' if name == 'textured' else 'now'}), "
              f"K1/K1-bvh {t_k / t_b:.3f}; per query {bvh_work_line(work)} (brute: "
              f"{canon.num_spheres + canon.num_planes} tests)", flush=True)
        if name == "textured":
            canon_ms, canon_work = t_b, work
            t_ref = t_bvh["K1-bvh-ref canonical textured spp32 d50"]
            print(f"    canonical textured {W}x{H} spp32 d50: K1-bvh-ref (mode 5, the same "
                  f"walk on the reference stream) {t_ref:.3f} ms", flush=True)
    print(f"    canonical textured, K1-bvh with its records in global memory instead of shared: "
          f"{t_bvh['canonical textured, records in global memory']:.3f} ms", flush=True)
    frays = W * H * 8
    for rr in (None, 3):
        t_b = t_bvh[f"field n=2000 spp8 d20 rr_start={rr}"]
        t_c = best_of_cameras(field, cams, W, H, 8, 20, cluster_k=CLUSTER_K, rr_start=rr)
        t_k = best_of_cameras(field, cams, W, H, 8, 20, rr_start=rr)
        work = mk.loop_work(field, cams[1], W, H, 8, 20, intersector="bvh", rr_start=rr)
        if rr is None:
            field_work = work
        print(f"    sphere field n=2000 {W}x{H} spp8 d20 rr_start={rr}: K1-bvh {t_b:.3f} ms = "
              f"{frays / t_b / 1e3:.3f} Mrays/s, K1-cl {t_c:.3f} ms, K1 {t_k:.3f} ms; "
              f"K1-cl/K1-bvh {t_c / t_b:.3f}; per query {bvh_work_line(work)}", flush=True)
    print(f"    sweep (benchmarks/prim_scaling.py): {W}x{H} spp{SW_SPP} d{SW_D} rr_start=3, its "
          f"camera; records in shared memory up to {mk.NODE_SHARED_BYTES_MAX} bytes:", flush=True)
    print("      n | BVH nodes | records in | K1-bvh ms | K1-bvh Mrays/s | K1-cl ms | "
          "K1-cl/K1-bvh | K1-bvh per query")
    srays = W * H * SW_SPP
    for n in BVH_SWEEP:
        scene_n, cam_n = sweep_scene(n, dev, W, H)
        t_b = t_bvh[f"sweep n={n} spp{SW_SPP} d{SW_D} rr_start=3"]
        t_c = best_of_cameras(scene_n, [cam_n] * 4, W, H, SW_SPP, SW_D, rr_start=3,
                              cluster_k=CLUSTER_K)
        w_n = mk.loop_work(scene_n, cam_n, W, H, SW_SPP, SW_D, rr_start=3, intersector="bvh")
        print(f"      {n} | {scene_n.bvh.left.shape[0]} | {where(scene_n)} | {t_b:.3f} | "
              f"{srays / t_b / 1e3:.3f} | {t_c:.3f} | {t_c / t_b:.3f} | {bvh_work_line(w_n)}",
              flush=True)
    print(f"    card: {card}", flush=True)

    # the kernels line: the field check's times (where the plain traversal
    # runs in seconds); the bound from work no traversal avoids, as K1-cl's
    ms, p_ms, scene, cam, cw, ch, spp, depth = timed["sphere field n=2000"]
    work = mk.loop_work(scene, cam, cw, ch, spp, depth, intersector="bvh")
    n_s, n_p = scene.num_spheres, scene.num_planes
    b_ops = work.queries * OPS_PLANE + work.hits * OPS_SHADE
    tables_b = 4 * (n_s * 4 + n_p * 20 + (n_s + n_p) * 13) + nodes_b(scene) + 15 * 4
    b = bound(b_ops, tables_b + cw * ch * 12)
    c_ops = canon_work.queries * OPS_PLANE + canon_work.hits * OPS_SHADE
    c_bytes = (4 * (canon.num_spheres * 4 + canon.num_planes * 20
                    + (canon.num_spheres + canon.num_planes) * 13) + nodes_b(canon)
               + canon.textures.numel() * 4 + 15 * 4 + W * H * 12)
    cb = bound(c_ops, c_bytes)
    fb_ = bound(field_work.queries * OPS_PLANE + field_work.hits * OPS_SHADE,
                tables_b + W * H * 12)
    print(f"    bounds (work no traversal avoids: a plane test a query, each hit's shading; "
          f"tables, records and frame once): field {cw}x{ch} spp{spp} d{depth} {b[0]:.6f} ms "
          f"({b[1]}); field {W}x{H} spp8 d20 {fb_[0]:.6f} ms ({fb_[1]}); canonical {W}x{H} "
          f"spp32 d50 textured {cb[0]:.6f} ms ({cb[1]}) against K1-bvh's {canon_ms:.3f} ms",
          flush=True)
    print(f"    phase 13: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return None, dict(name="megakernel_bvh", route="cuda", source="tracer_torch/csrc/megakernel.cu",
                      replaces="tracer/bvh/traverse.py:38", launches=launches["megakernel_bvh"],
                      max_abs_err=max(errs), ms=ms, plain_ms=p_ms, bound_ms=b[0],
                      bound_by=b[1], library_ms=None)


# ---- phase 14: distribution (tracer_torch.dist) -----------------------------

LAUNCH_NAMES = ("megakernel", "megakernel_record", "bwd", "tex_scatter", "megakernel_clustered",
                "megakernel_bvh", "megakernel_ref")
DIST_TIMEOUT = 600  # seconds for a group of phase 14's workers, start to exit


def launch_counts(reset=False):
    """{kernel entry name: launches since the last reset}; with `reset`, set
    every count to 0 and return None."""
    from tracer_torch.kernels import bwd, tex_scatter
    from tracer_torch.kernels import megakernel as mk

    owners = ((mk, "LAUNCHES"), (mk, "LAUNCHES_RECORD"), (bwd, "LAUNCHES"),
              (tex_scatter, "LAUNCHES"), (mk, "LAUNCHES_CLUSTERED"), (mk, "LAUNCHES_BVH"),
              (mk, "LAUNCHES_REF"))
    if reset:
        for mod, attr in owners:
            setattr(mod, attr, 0)
        return None
    return {name: getattr(mod, attr) for name, (mod, attr) in zip(LAUNCH_NAMES, owners)}


def canonical(dev, sqrt_spp=None, num_frames=None, output_path=None):
    """(scene, params) of the canonical config with the synthetic floor."""
    from tracer_torch.scene import builders, config

    params = config.read_scene_params(io.StringIO(config.default_config_text()))
    if sqrt_spp is not None:
        params.render.sqrt_rays_per_pixel = sqrt_spp
    if num_frames is not None:
        params.num_frames = num_frames
    if output_path is not None:
        params.output_path = output_path
    return builders.create_scene(params, texture_loader=synthetic_floor, device=dev), params


def grad_leaves(scene, g_scene, g_cam):
    """[(name, gradient)] of the float leaves and the texture's layer 0."""
    from tracer_torch.kernels import bwd

    return (list(zip(bwd.leaf_names(scene, g_cam), bwd.float_grads(scene, g_scene, g_cam)))
            + [("textures[0]", g_scene.textures[0])])


# the shapes of phase 14
DIST_FRAMES, DIST_SQRT_SPP = 2, 4  # the main forward path (phase 4's cut)
DIST_G = (800, 600, 32, 50, 8)  # the main gradient path: w, h, spp, depth, spp_chunk
DIST_SMALL = (64, 48)  # the sample-sharded frame and the replay gradients


def dist_worker(spec_json: str) -> int:
    """One rank of phase 14 (`chip_smoke.py --dist-worker SPEC`): opens its
    group on cuda:0, runs the phase's checks for its group and prints one
    line `DIST_RESULT {json}`; tensors go to files in spec["out"]."""
    import datetime

    import torch
    import torch.distributed as dist

    spec = json.loads(spec_json)
    sys.path.insert(0, HERE)
    from tracer_torch.dist import multihost, sharding
    from tracer_torch.kernels import nvcc

    dev = torch.device("cuda", 0)  # every rank of the phase on the one card
    torch.cuda.set_device(dev)
    nvcc.build_all()  # loads the libraries phase 2 built
    world, rank = spec["world"], spec["rank"]
    if world > 1:
        multihost.initialize(spec["addr"], world, rank, backend=spec["backend"], timeout=300)
    else:  # multihost.initialize opens no group for one process
        dist.init_process_group(spec["backend"], init_method=f"tcp://{spec['addr']}",
                                world_size=1, rank=0, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = sharding.make_mesh(dev)
        res = (dist_group_checks if world > 1 else dist_nccl_checks)(mesh, spec["out"])
    finally:
        dist.destroy_process_group()
    print("DIST_RESULT " + json.dumps(res), flush=True)
    return 0


def dist_group_checks(mesh, out):
    """A rank of the 2-rank gloo group: the main forward path (row- and
    frame-sharded animations), the sample-sharded frame, the main gradient
    path, the replay gradients and the times."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_scenes import SKY

    from tracer_torch.dist import multihost, sharding
    from tracer_torch.kernels import bwd
    from tracer_torch.kernels import megakernel as mk
    from tracer_torch.render import camera as C
    from tracer_torch.scene import builders, config

    dev, rank = mesh.device, mesh.rank
    res = {"rank": rank}

    # the main forward path: every frame by row bands, rank 0 prints and
    # writes; each rank writes into its own directory
    for mode, frame_shard, kw in (("rows", False, dict(sqrt_spp=DIST_SQRT_SPP)),
                                  ("frames", True, dict(sqrt_spp=DIST_SQRT_SPP, num_frames=3))):
        own = os.path.join(out, mode, f"rank{rank}")
        os.makedirs(own)
        scene, params = canonical(dev, output_path=os.path.join(own, "frame_%d.bin"), **kw)
        tsv = io.StringIO()
        frames = range(DIST_FRAMES) if mode == "rows" else None
        torch.cuda.synchronize()
        launch_counts(reset=True)
        fb = multihost.render_animation_multihost(
            scene, params, frame_shard=frame_shard, engine="cuda", out=tsv,
            **({} if frames is None else dict(frames=frames)))
        torch.cuda.synchronize()
        res[f"{mode}_launches"] = launch_counts()
        res[f"{mode}_tsv"] = tsv.getvalue()
        if mode == "rows":
            np.save(os.path.join(out, f"rows_fb{rank}.npy"), fb)
    canon = scene

    # samples: the plain sample-sharded frame (tracer's XLA path)
    smoke = builders.create_scene(config.read_scene_params(io.StringIO(config.smoke_config_text())),
                                  texture_loader=lambda _: None, device=dev)
    w, h = DIST_SMALL
    cam = C.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], w, h, 90.0, background=SKY,
                              device=dev)
    fb = sharding.render_frame_spp_sharded(smoke, cam, w, h, 4, 8, mesh)
    np.save(os.path.join(out, f"spp{rank}.npy"), fb.cpu().numpy())

    # the main gradient path
    gw, gh, gspp, gd, chunk = DIST_G
    cam_g = C.camera_at(params.camera_path, 0, 100, gw, gh, params.fov_degrees, device=dev)
    target = torch.from_numpy(np.load(os.path.join(out, "target.npy"))).to(dev)
    dist.barrier()
    torch.cuda.synchronize()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    loss, g_scene, g_cam = sharding.l2_grads_deep_sharded(canon, cam_g, target, gw, gh, gspp, gd,
                                                          mesh, spp_chunk=chunk,
                                                          texture_grads=True)
    torch.cuda.synchronize()
    res["deep_ms"] = (time.perf_counter() - t0) * 1e3
    res["deep_launches"] = launch_counts()
    leaves = grad_leaves(canon, g_scene, g_cam)
    np.savez(os.path.join(out, f"deep{rank}.npz"), loss=loss.cpu().numpy(),
             **{n: g.cpu().numpy() for n, g in leaves})
    del g_scene, g_cam, leaves
    warm = math.inf  # the same step again, warm: best of 2, both ranks from a barrier
    for _ in range(2):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharding.l2_grads_deep_sharded(canon, cam_g, target, gw, gh, gspp, gd, mesh,
                                       spp_chunk=chunk, texture_grads=True)
        torch.cuda.synchronize()
        warm = min(warm, (time.perf_counter() - t0) * 1e3)
    res["deep_warm_ms"] = warm

    # the replay gradients at a small shape
    cam_s = C.camera_at(params.camera_path, 0, 100, w, h, params.fov_degrees, device=dev)
    target_s = torch.from_numpy(np.load(os.path.join(out, "target_small.npy"))).to(dev)
    loss, g_scene = sharding.scene_grads_replay_sharded(canon, cam_s, target_s, w, h, 2, 8, mesh)
    k = -len(cam_s)  # the scene's leaves: the camera takes no gradient here, as in tracer
    np.savez(os.path.join(out, f"replay{rank}.npz"), loss=loss.cpu().numpy(),
             **{n: g.cpu().numpy() for n, g in zip(bwd.leaf_names(canon, cam_s)[:k],
                                                   bwd.float_grads(canon, g_scene, cam_s)[:k])})

    # times at 1080x720 spp16 d50 (the main path's frame): the sharded frame
    # and the all_reduce of its 9.3 MB alone, both ranks from a barrier
    # (host clock to synchronize), then one launch on rank 0 alone (CUDA
    # events) while rank 1 waits
    cam_t = C.camera_at(params.camera_path, 1, 100, 1080, 720, params.fov_degrees, device=dev)
    spp = DIST_SQRT_SPP ** 2

    def host_best(fn, reps=3):
        fn()
        best = math.inf
        for _ in range(reps):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    sharded = {}
    res["sharded_ms"] = host_best(lambda: sharded.update(fb=sharding.render_frame_kernel_sharded(
        canon, cam_t, 1080, 720, spp, 50, mesh)))
    buf = torch.zeros((720, 1080, 3), device=dev)
    res["all_reduce_ms"] = host_best(lambda: dist.all_reduce(buf))
    dist.barrier()
    if rank == 0:
        one = mk.render_frame_kernel(canon, cam_t, 1080, 720, spp, 50)
        res["single_ms"] = cuda_ms(lambda: mk.render_frame_kernel(canon, cam_t, 1080, 720, spp, 50),
                                   reps=3)
        torch.cuda.synchronize()
        res["timed_frame_bit_equal"] = bit_equal(sharded["fb"], one)
    dist.barrier()
    return res


def dist_nccl_checks(mesh, out):
    """The one rank of an NCCL group: render_frame_kernel_sharded against
    render_frame_kernel, l2_grads_deep_sharded against l2_grads_deep."""
    import torch

    from tracer_torch.dist import sharding
    from tracer_torch.kernels import bwd
    from tracer_torch.kernels import megakernel as mk
    from tracer_torch.render import camera as C

    dev = mesh.device
    canon, params = canonical(dev)
    cam = C.camera_at(params.camera_path, 1, 100, 256, 192, params.fov_degrees, device=dev)
    frame_equal = bit_equal(sharding.render_frame_kernel_sharded(canon, cam, 256, 192, 4, 50, mesh),
                            mk.render_frame_kernel(canon, cam, 256, 192, 4, 50))
    w, h = DIST_SMALL
    cam = C.camera_at(params.camera_path, 0, 100, w, h, params.fov_degrees, device=dev)
    target = torch.rand((h, w, 3), generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    kw = dict(spp_chunk=2, texture_grads=True)
    l1, gs1, gc1 = sharding.l2_grads_deep_sharded(canon, cam, target, w, h, 4, 8, mesh, **kw)
    l0, gs0, gc0 = bwd.l2_grads_deep(canon, cam, target, w, h, 4, 8, **kw)
    got, want = grad_leaves(canon, gs1, gc1), grad_leaves(canon, gs0, gc0)
    ok, worst, worst_abs = compare_leaves([n for n, _ in got], [g for _, g in got],
                                          [g for _, g in want])
    return dict(frame_equal=frame_equal, loss_equal=bit_equal(l1, l0), grads_ok=ok, worst=worst,
                worst_abs=worst_abs)


def run_group(world, backend, out, env):
    """Start `world` workers of phase 14 (rank by rank), wait for all of
    them within DIST_TIMEOUT, kill any left; returns ([each rank's result],
    error or None). A worker that fails, times out or prints no result is
    an error."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    procs = []
    for rank in range(world):
        spec = dict(world=world, rank=rank, addr=addr, backend=backend, out=out)
        log = open(os.path.join(out, f"{backend}{world}_rank{rank}.log"), "w")
        procs.append((log, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-worker", json.dumps(spec)],
            stdout=log, stderr=subprocess.STDOUT, cwd=HERE, env=env)))
    deadline = time.monotonic() + DIST_TIMEOUT
    results, errors = [], []
    try:
        for rank, (log, proc) in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                errors.append(f"{backend} rank {rank} of {world} timed out after {DIST_TIMEOUT} s")
                continue
            log.close()
            text = open(log.name).read()
            line = [x for x in text.splitlines() if x.startswith("DIST_RESULT ")]
            if rc != 0 or not line:
                errors.append(f"{backend} rank {rank} of {world} exited {rc} with "
                              f"{'a' if line else 'no'} result:\n{text[-4000:]}")
            else:
                results.append(json.loads(line[-1][len("DIST_RESULT "):]))
    finally:
        for log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return results, ("\n".join(errors) or None)


def dist_phase(dev, kind, card, canon, canon_p, g, env):
    """Phase 14: tracer_torch.dist on the one card. K1's and K1-rec's row
    bands against one launch; then a gloo group of 2 ranks, both on cuda:0:
    the main forward path (render_animation_multihost, row- and
    frame-sharded) and the main gradient path (l2_grads_deep_sharded)
    against one process, the sample-sharded frame and the replay
    gradients, and the times; then an NCCL group of one rank. Returns
    (error or None, rank 0's launches on the phase's two main paths
    {kernel entry name: n}, its comparisons' max|diff| {name: [x, ...]})."""
    import torch

    from tracer_torch.dist import sharding
    from tracer_torch.io import image as image_io
    from tracer_torch.kernels import bwd, diff
    from tracer_torch.kernels import megakernel as mk
    from tracer_torch.render import camera as C
    from tracer_torch.render import driver, renderer
    from tracer_torch.scene import builders, config

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_scenes import SKY

    t_phase = time.perf_counter()
    errs = {k: [] for k in ("megakernel", "megakernel_record", "bwd", "tex_scatter")}
    print(f"[14] tracer_torch.dist on {kind} ({card}): 2 gloo ranks share the one card (NCCL "
          f"refuses two ranks on a device), then one NCCL rank", flush=True)

    # K1 and K1-rec on row bands against one launch, uneven splits included
    for h, n in ((720, 3), (719, 2)):
        cam = C.camera_at(canon_p.camera_path, 1, canon_p.num_frames, 1080, h,
                          canon_p.fov_degrees, device=dev)
        full = mk.render_frame_kernel(canon, cam, 1080, h, 4, 50)
        rec = mk.render_frame_kernel_record(canon, cam, 1080, h, 2, 8, tape_fields=9)
        bands = [sharding.row_band(h, n, r) for r in range(n)]
        ok = True
        for r0, rows in bands:
            cols = slice(r0 * 1080, (r0 + rows) * 1080)
            band = mk.render_frame_kernel(canon, cam, 1080, rows, 4, 50, row_offset=r0)
            brec = mk.render_frame_kernel_record(canon, cam, 1080, rows, 2, 8, tape_fields=9,
                                                 row_offset=r0)
            ok &= (bit_equal(band, full[r0:r0 + rows]) and bit_equal(brec[0], rec[0][r0:r0 + rows])
                   and torch.equal(brec[1], rec[1][:, :, cols])
                   and bit_equal(brec[2], rec[2][:, :, cols]))
        print(f"  row bands {[rows for _, rows in bands]} of 1080x{h}: K1 (spp4 d50) and K1-rec "
              f"(spp2 d8, 9 fields: frame, index and texture tapes) bit-equal to one launch's "
              f"rows -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            return "a row band is not the rows of one launch", None, None
        del full, rec, band, brec
    errs["megakernel"].append(0.0)
    errs["megakernel_record"].append(0.0)

    gw, gh, gspp, gd, chunk = DIST_G
    w, h = DIST_SMALL
    cam_g = C.camera_at(canon_p.camera_path, 0, canon_p.num_frames, gw, gh, canon_p.fov_degrees,
                        device=dev)
    truth = canon._replace(materials=canon.materials._replace(albedo=canon.materials.albedo * 0.85))
    target = mk.render_frame_kernel(truth, cam_g, gw, gh, gspp, gd) / gspp
    target_s = torch.rand((h, w, 3), generator=g, device=dev)
    # the workers share the card with this process: hand back the blocks
    # that the earlier phases left in this process's caching allocator
    held = torch.cuda.memory_reserved(dev)
    torch.cuda.empty_cache()
    print(f"  this process's cached device memory {held} -> {torch.cuda.memory_reserved(dev)} "
          f"bytes ({torch.cuda.memory_allocated(dev)} allocated) before the workers start",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "target.npy"), target.cpu().numpy())
        np.save(os.path.join(tmp, "target_small.npy"), target_s.cpu().numpy())
        t0 = time.perf_counter()
        res, err = run_group(2, "gloo", tmp, env)
        if err:
            return err, None, None
        res.sort(key=lambda r: r["rank"])
        print(f"  gloo group of 2 ranks on cuda:0: {time.perf_counter() - t0:.1f} s from start to "
              f"exit", flush=True)

        # the main forward path against one process
        tsv = io.StringIO()
        scene, params = canonical(dev, sqrt_spp=DIST_SQRT_SPP,
                                  output_path=os.path.join(tmp, "single", "frame_%d.bin"))
        os.makedirs(os.path.join(tmp, "single"))
        fb = driver.render_animation(scene, params, out=tsv, frames=range(DIST_FRAMES),
                                     engine="cuda")
        rows = os.path.join(tmp, "rows")
        lines = res[0]["rows_tsv"].strip().splitlines()
        rays = params.width * params.height * DIST_SQRT_SPP ** 2
        ok = ([x.split("\t")[0] for x in lines] == [str(n) for n in range(DIST_FRAMES)]
              and all(x.split("\t")[2] == str(rays) for x in lines)
              and res[1]["rows_tsv"] == "" and os.listdir(os.path.join(rows, "rank1")) == [])
        diff_max = 0.0
        for n in range(DIST_FRAMES):
            a = image_io.read_binary(os.path.join(rows, "rank0", f"frame_{n}.bin"))
            b = image_io.read_binary(os.path.join(tmp, "single", f"frame_{n}.bin"))
            diff_max = max(diff_max, float(np.abs(a.astype(np.int64) - b).max()))
        fbs = [np.load(os.path.join(tmp, f"rows_fb{r}.npy")) for r in range(2)]
        fb_equal = all(np.array_equal(x.view(np.int32), fb.view(np.int32)) for x in fbs)
        want = {n: (DIST_FRAMES if n == "megakernel" else 0) for n in LAUNCH_NAMES}
        ok &= diff_max == 0 and fb_equal and all(r["rows_launches"] == want for r in res)
        print(f"  main forward path: render_animation_multihost(frame_shard=False, engine='cuda'), "
              f"canonical config {params.width}x{params.height} d{params.render.max_depth}, "
              f"{DIST_FRAMES} frames sqrt_spp {DIST_SQRT_SPP}: rank 0 TSV "
              f"{' | '.join(lines)}; rank 1 printed {len(res[1]['rows_tsv'])} bytes and wrote "
              f"{len(os.listdir(os.path.join(rows, 'rank1')))} files; files max|diff| {diff_max:g} "
              f"against one process, last frame bit-equal on both ranks {fb_equal}; launches per "
              f"rank {[r['rows_launches'] for r in res]} (want {want}) -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            return "the row-sharded animation is not the one-process animation", None, None

        scene3, params3 = canonical(dev, sqrt_spp=DIST_SQRT_SPP, num_frames=3,
                                    output_path=os.path.join(tmp, "single3", "frame_%d.bin"))
        os.makedirs(os.path.join(tmp, "single3"))
        driver.render_animation(scene3, params3, out=io.StringIO(), engine="cuda")
        ok = True
        for r in range(2):
            own = os.path.join(tmp, "frames", f"rank{r}")
            mine = list(range(r, 3, 2))
            ok &= sorted(os.listdir(own)) == [f"frame_{n}.bin" for n in mine]
            ok &= [int(x.split("\t")[0]) for x in res[r]["frames_tsv"].splitlines()] == mine
            for n in mine:
                ok &= np.array_equal(image_io.read_binary(os.path.join(own, f"frame_{n}.bin")),
                                     image_io.read_binary(os.path.join(tmp, "single3",
                                                                       f"frame_{n}.bin")))
        print(f"  render_animation_multihost(frame_shard=True), 3 frames: rank r wrote and printed "
              f"frames r, r+2, bit-equal to one process -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            return "the frame-sharded animation split its frames wrongly", None, None

        # the sample-sharded frame (the plain renderer on the card)
        smoke = builders.create_scene(
            config.read_scene_params(io.StringIO(config.smoke_config_text())),
            texture_loader=lambda _: None, device=dev)
        cam = C.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], w, h, 90.0, background=SKY,
                                  device=dev)
        want = renderer.render_frame(smoke, cam, w, h, 4, 8)
        ok = True
        for r in range(2):
            ok &= compare(f"render_frame_spp_sharded rank {r}, smoke {w}x{h} spp4 d8 (2 ranks of 2 "
                          f"samples) vs render_frame", torch.from_numpy(
                              np.load(os.path.join(tmp, f"spp{r}.npy"))).to(dev), want, [])
        if not ok:
            return "the sample-sharded frame disagrees with the one-device frame", None, None

        # the main gradient path against one device
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g_scene, g_cam = bwd.l2_grads_deep(canon, cam_g, target, gw, gh, gspp, gd,
                                                 spp_chunk=chunk, texture_grads=True)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        want = grad_leaves(canon, g_scene, g_cam)
        del g_scene, g_cam
        ok = True
        for r in range(2):
            got = np.load(os.path.join(tmp, f"deep{r}.npz"))
            ok &= bool(got["loss"].view(np.int32) == loss.cpu().numpy().view(np.int32))
            leaf_ok, worst, worst_abs = compare_leaves(
                [n for n, _ in want], [torch.from_numpy(got[n]).to(dev) for n, _ in want],
                [x for _, x in want])
            ok &= leaf_ok
            t_err = float(np.abs(got["textures[0]"] - want[-1][1].cpu().numpy()).max())
            errs["bwd"].append(worst_abs)
            errs["tex_scatter"].append(t_err)
        want_l = {n: 0 for n in LAUNCH_NAMES}
        want_l.update(megakernel=1, megakernel_record=gspp // chunk, bwd=gspp // chunk,
                      tex_scatter=gspp // chunk)
        ok &= all(r["deep_launches"] == want_l for r in res)
        print(f"  main gradient path: l2_grads_deep_sharded(texture_grads=True) at {gw}x{gh} "
              f"spp{gspp} d{gd}, spp_chunk {chunk}, canonical + texture: loss {float(loss):.9g} "
              f"bit-equal to l2_grads_deep's on both ranks; worst leaf max|diff|/max|g| "
              f"{worst:.3g} (<= {TOL_GRAD}), texture max|diff| {t_err:.3g} (max "
              f"{float(want[-1][1].abs().max()):.3g}); host clock on rank 0: first call "
              f"{res[0]['deep_ms']:.3f} ms, warm {res[0]['deep_warm_ms']:.3f} ms (best of 2; the 2 "
              f"ranks share the card), one device in this process {one_ms:.3f} ms; launches per "
              f"rank {[r['deep_launches'] for r in res]} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            return "the sharded d50 gradients disagree with one device's", None, None
        del want

        # the replay gradients at a small shape against render_frame_diff's mode "replay"
        cam_s = C.camera_at(canon_p.camera_path, 0, canon_p.num_frames, w, h,
                            canon_p.fov_degrees, device=dev)
        leaves = [x.detach().requires_grad_() for x in bwd.float_leaves(canon, cam_s)]
        s, c = bwd.with_float_leaves(canon, cam_s, leaves)
        fb_r = diff.render_frame_diff(s, c, w, h, 2, 8, mode="replay")
        loss = torch.mean((fb_r / 2 - target_s) ** 2)
        k = len(leaves) - len(cam_s)
        want = torch.autograd.grad(loss, leaves[:k], allow_unused=True)
        loss = float(loss.detach())
        names = bwd.leaf_names(canon, cam_s)[:k]
        want = [torch.zeros_like(x) if v is None else v for x, v in zip(leaves, want)]
        ok = True
        for r in range(2):
            got = np.load(os.path.join(tmp, f"replay{r}.npz"))
            leaf_ok, worst, worst_abs = compare_leaves(
                names, [torch.from_numpy(got[n]).to(dev) for n in names], want)
            rel = abs(float(got["loss"]) - loss) / loss
            ok &= leaf_ok and rel <= 1e-6
        print(f"  scene_grads_replay_sharded, canonical + texture {w}x{h} spp2 d8, against "
              f"render_frame_diff(mode='replay'): worst leaf max|diff|/max|g| {worst:.3g} "
              f"(<= {TOL_GRAD}), loss rel {rel:.3g} (<= 1e-6) -> {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            return "the sharded replay gradients disagree with mode 'replay'", None, None

        t = res[0]
        print(f"  times on {kind} ({card}), canonical 1080x720 spp{DIST_SQRT_SPP ** 2} d50 "
              f"textured, camera path frame 1: 2 ranks sharing ONE card, so their ratio is not a "
              f"scaling figure: render_frame_kernel_sharded {t['sharded_ms']:.3f} ms (host clock "
              f"from a barrier, best of 3), of which the gloo all_reduce of the 9.3 MB frame "
              f"alone {t['all_reduce_ms']:.3f} ms; one launch of render_frame_kernel "
              f"{t['single_ms']:.3f} ms (CUDA events, best of 3); the sharded frame bit-equal to "
              f"it {t['timed_frame_bit_equal']}", flush=True)
        if not t["timed_frame_bit_equal"]:
            return "the timed sharded frame is not the one-launch frame", None, None
        launches = {n: res[0]["rows_launches"][n] + res[0]["deep_launches"][n]
                    for n in LAUNCH_NAMES}

        # one NCCL rank: the NCCL path starts on the card
        t0 = time.perf_counter()
        nres, err = run_group(1, "nccl", tmp, env)
        if err:
            return err, None, None
        r = nres[0]
        ok = r["frame_equal"] and r["loss_equal"] and r["grads_ok"]
        errs["bwd"].append(r["worst_abs"])
        print(f"  NCCL group of one rank ({time.perf_counter() - t0:.1f} s): "
              f"render_frame_kernel_sharded 256x192 spp4 d50 bit-equal to render_frame_kernel "
              f"{r['frame_equal']}; l2_grads_deep_sharded {w}x{h} spp4 d8 (chunks of 2, texture "
              f"grads) loss bit-equal {r['loss_equal']}, worst leaf max|diff|/max|g| "
              f"{r['worst']:.3g} (<= {TOL_GRAD}) -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            return "the NCCL rank's sharded paths disagree with one device's", None, None
    print(f"    phase 14: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return None, launches, errs


# ---- phase 15: the reference stream, utils and the native writer -----------

REF_CHECK = (96, 64, 4, 50)  # K1-ref against the plain version: w, h, spp, depth
REF_TIMED = (256, 192, 2, 50)  # the kernels line's ms, plain_ms and bound (plain in seconds)


def timed_writer(kind, spent):
    """A frame writer ("native" or "thread") whose submit adds its host
    seconds to `spent`."""
    from tracer_torch.io import image as image_io
    from tracer_torch.io import native as io_native

    w = io_native.AsyncFrameWriter() if kind == "native" else image_io.ThreadedWriter()
    submit = w.submit

    def timed(*a, **kw):
        t0 = time.perf_counter()
        submit(*a, **kw)
        spent.append(time.perf_counter() - t0)

    w.submit = timed
    return w


def ref_phase(dev, kind, card, canon_p, cams, W, H, env):
    """Phase 15: the reference-stream kernel K1-ref against the plain
    rng_mode="reference" renderer, the slice's main path
    (render_animation(engine="cuda", rng_mode="reference")) and the CLI
    with --gpu --ref-rng --retries 2, K1-ref's times beside K1's, the two
    frame writers in the main path's loop, and the utils (profile_trace,
    check_framebuffer, a forced transient failure). Returns (error or
    None, the kernel's entry of the `kernels` line)."""
    import contextlib

    import torch

    from torch_scenes import EXHAUSTED_SEEDS, SKY, exhausted_lane_view, sample_start_reaching

    from tracer_torch.core import rng
    from tracer_torch.io import image as image_io
    from tracer_torch.io import native as io_native
    from tracer_torch.kernels import megakernel as mk
    from tracer_torch.render import camera as C
    from tracer_torch.render import driver, renderer
    from tracer_torch.scene import builders, config
    from tracer_torch.utils import debug, profiling, resilience

    t_phase = time.perf_counter()
    errs = []
    REF = dict(rng_mode="reference")
    print(f"[15] the reference stream (K1-ref), utils and the native writer on {kind} ({card})",
          flush=True)
    canon = builders.create_scene(canon_p, with_bvh=True, texture_loader=synthetic_floor,
                                  device=dev)
    w, h, spp, d = REF_CHECK
    cam = C.camera_at(canon_p.camera_path, 0, canon_p.num_frames, w, h, canon_p.fov_degrees,
                      background=SKY, device=dev)
    # K1-ref against the plain version, by phase 3's rules
    one = None
    for name, kw in (("brute", {}), ("brute, stratified", dict(stratify=True)),
                     ("BVH, quirk off, stratified", dict(intersector="bvh",
                                                         reference_quirk=False, stratify=True))):
        got = mk.render_frame_kernel(canon, cam, w, h, spp, d, **REF, **kw)
        torch.cuda.synchronize()
        want = renderer.render_frame(canon, cam, w, h, spp, d, **REF, **kw)
        if not compare(f"K1-ref vs plain, canonical + texture {w}x{h} spp{spp} d{d}, {name}",
                       got, want, errs):
            return f"K1-ref and the plain reference renderer disagree ({name})", None
        if not kw:
            one, plain_one = got, want
    fixed = mk.render_frame_kernel(canon, cam, w, h, spp, d)
    differ = float((fixed - one).abs().max())
    print(f"  the fixed stream's frame differs from the reference stream's: max|diff| "
          f"{differ:.6g}", flush=True)
    if not differ > 1e-3:
        return "the reference-stream frame equals the fixed-stream frame", None
    two = (mk.render_frame_kernel(canon, cam, w, h, 2, d, **REF)
           + mk.render_frame_kernel(canon, cam, w, h, 2, d, sample_start=2, **REF))
    r0, rows = h // 4, h // 3
    band = mk.render_frame_kernel(canon, cam, w, rows, spp, d, row_offset=r0, **REF)
    torch.cuda.synchronize()
    ok = compare("K1-ref 2+2 sample chunks vs one launch", two, one, errs)
    ok &= compare("K1-ref 2+2 sample chunks vs plain", two, plain_one, errs)
    band_ok = bit_equal(band, one[r0:r0 + rows])
    print(f"  K1-ref row band {r0}..{r0 + rows - 1} bit-equal to one launch's rows -> "
          f"{'ok' if band_ok else 'FAIL'}", flush=True)
    if not (ok and band_ok):
        return "K1-ref's chunks or its row band disagree with one launch", None
    # the samplers' seeds: the plain sampler on the card against the CPU's
    # (which the CPU tests hold to tracer's, bit for bit) on 4096 seeds with
    # the exhausted lanes; then one-pixel K1-ref launches whose first
    # bounce draws from each exhausted seed (the tail: the normal, into the light)
    seeds = torch.arange(4096, dtype=torch.int64)
    seeds[:len(EXHAUSTED_SEEDS)] = torch.tensor(EXHAUSTED_SEEDS)
    s_dev, v_dev = rng.random_in_unit_sphere_rejection(seeds.to(dev))
    s_cpu, v_cpu = rng.random_in_unit_sphere_rejection(seeds)
    seeds_ok = torch.equal(s_dev.cpu(), s_cpu) and bit_equal(v_dev.cpu(), v_cpu)
    zero = int((v_cpu == 0).all(dim=-1).sum())
    scene_x, cam_x = exhausted_lane_view(dev)
    base = int(renderer.pixel_grid(1, 1, device=dev)[2][0])
    tail = []
    for seed in EXHAUSTED_SEEDS:
        start = sample_start_reaching(seed, base)
        got = mk.render_frame_kernel(scene_x, cam_x, 1, 1, 1, 6, sample_start=start, **REF)
        want = renderer.render_frame(scene_x, cam_x, 1, 1, 1, 6, sample_start=start, **REF)
        tail.append(max(float((got - want).abs().max()),
                        float((got.reshape(3).cpu() - torch.tensor([3.0, 2.5, 2.0])).abs().max())))
    tail_ok = max(tail) < 1e-5
    errs.append(max(tail))
    print(f"  samplers: 4096 seeds with {zero} exhausted lanes, the card's plain rejection "
          f"sampler bit-equal to the CPU's (seeds and points): {seeds_ok}; {len(tail)} "
          f"one-pixel K1-ref launches through the exhausted lanes {EXHAUSTED_SEEDS[:2]}...: "
          f"max|diff| against the plain version and the tail's radiance {max(tail):.3g} -> "
          f"{'ok' if seeds_ok and tail_ok and zero == len(EXHAUSTED_SEEDS) else 'FAIL'}",
          flush=True)
    if not (seeds_ok and tail_ok and zero == len(EXHAUSTED_SEEDS)):
        return "the reference stream's samplers or exhausted lanes disagree", None

    # the slice's main path at full width
    main_p = config_copy(canon_p)
    main_p.render.sqrt_rays_per_pixel = 4
    spp_m, frames = 16, range(2)
    mw, mh, md = main_p.width, main_p.height, main_p.render.max_depth
    with tempfile.TemporaryDirectory() as tmp:
        main_p.output_path = os.path.join(tmp, "frame_%d.bin")
        print(f"  main path: render_animation(engine='cuda', rng_mode='reference'), canonical "
              f"config, {canon.num_spheres} spheres + {canon.num_planes} planes, {mw}x{mh}, "
              f"depth {md}, floor texture {tuple(canon.textures.shape[1:3])}; reduced: frames "
              f"100 -> {len(frames)}, sqrt_spp 50 -> 4 (run time limit)", flush=True)
        tsv = io.StringIO()
        launch_counts(reset=True)
        fb = driver.render_animation(canon, main_p, saver="bin", out=tsv, frames=frames,
                                     engine="cuda", **REF)
        launches = launch_counts()
        chunks = math.ceil(spp_m / max(1, driver.MAX_RAYS_PER_LAUNCH // (mw * mh)))
        want_l = len(frames) * chunks
        print("    TSV: " + tsv.getvalue().strip().replace("\n", " | "))
        print(f"    launches {launches} (K1-ref: frames x chunks = {want_l})", flush=True)
        if launches["megakernel_ref"] != want_l or sum(launches.values()) != want_l:
            return f"the reference main path launched {launches}, not K1-ref {want_l} times", None
        for n in frames:
            img = image_io.read_binary(main_p.output_path % n)
            print(f"    frame {n}: {img.shape} uint8, mean {img.mean():.4f}, nonzero "
                  f"{(img > 0).mean():.4f}")
            if img.shape != (mh, mw, 3) or not img.any():
                return f"reference main-path frame {n} is empty or misshapen", None
    debug.check_framebuffer(fb, "reference main-path frame")
    print("    check_framebuffer: finite and non-negative -> ok", flush=True)
    npx = 2048
    sel = torch.randperm(mw * mh, generator=torch.Generator().manual_seed(0))[:npx].to(dev)
    i_all, j_all, seeds_all = renderer.pixel_grid(mw, mh, device=dev)
    cam_last = C.camera_at(main_p.camera_path, frames[-1], main_p.num_frames, mw, mh,
                           main_p.fov_degrees, device=dev)
    t0 = time.perf_counter()
    plain = renderer.render_pixels(canon, cam_last, i_all[sel], j_all[sel], seeds_all[sel],
                                   spp_m, md, **REF)
    got = torch.tensor(fb, device=dev).reshape(-1, 3)[sel]
    if not compare(f"main path frame {frames[-1]}: {npx} pixels vs plain "
                   f"({time.perf_counter() - t0:.1f} s)", got[:, None], plain[:, None], errs):
        return "the reference main-path frame disagrees with the plain version", None

    # the CLI, --gpu --ref-rng --retries 2: its frame is the driver's
    cfg = config.default_config_text().replace("\n50 50\n", "\n50 2\n")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tracer_torch.cli", "--gpu", "--ref-rng", "--retries", "2",
             "--frames", "1", "--format", "bin"],
            input=cfg, capture_output=True, text=True, cwd=tmp, env=env, timeout=300)
        print(f"    CLI --gpu --ref-rng --retries 2 (default config, sqrt_spp 2, untextured: no "
              f"floor.jpg): rc {proc.returncode} in {time.perf_counter() - t0:.1f} s, stdout "
              f"{proc.stdout.strip()!r}", flush=True)
        if proc.returncode != 0:
            return f"CLI --gpu --ref-rng --retries 2 failed:\n{proc.stderr[-3000:]}", None
        cli_img = image_io.read_binary(os.path.join(tmp, "images", "render_0.png"))
    cli_p = config.read_scene_params(io.StringIO(cfg))
    cli_scene = builders.create_scene(cli_p, texture_loader=lambda _p: None, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        cli_p.output_path = os.path.join(tmp, "f_%d.bin")
        driver.render_animation(cli_scene, cli_p, frames=[0], out=io.StringIO(), saver="bin",
                                engine="cuda", **REF)
        same = np.array_equal(image_io.read_binary(cli_p.output_path % 0), cli_img)
    print(f"    the CLI's frame equals the driver's (rng_mode='reference', same config): {same}",
          flush=True)
    if not same:
        return "the CLI's --ref-rng frame is not the driver's", None

    # times: K1-ref beside K1 at 800x600 spp32 d50 textured, in turns
    rays = W * H * 32
    best = {"K1": math.inf, "K1-ref": math.inf}
    for name in ("K1", "K1-ref", "K1-ref", "K1"):
        kw = REF if name == "K1-ref" else {}
        mk.render_frame_kernel(canon, cams[0], W, H, 32, 50, **kw)  # warm-up
        best[name] = min([best[name]] + [cuda_ms(
            lambda c=c: mk.render_frame_kernel(canon, c, W, H, 32, 50, **kw)) for c in cams[1:]])
    work = mk.loop_work(canon, cams[1], W, H, 32, 50, **REF)
    k1_work = mk.loop_work(canon, cams[1], W, H, 32, 50)
    n_s, n_p = canon.num_spheres, canon.num_planes
    tables = 4 * (n_s * 4 + n_p * 20 + (n_s + n_p) * 13) + 15 * 4

    def k1_bound(wk, npix):
        # K1's formula: every query tests every primitive, every hit shades;
        # of the texture, only what the hits can read (a bilinear sample's 4
        # texels of 12 bytes a hit, the whole texture at most)
        tex_b = min(canon.textures.numel() * 4, wk.hits * 4 * 12)
        return bound(wk.queries * (n_s * OPS_SPHERE + n_p * OPS_PLANE) + wk.hits * OPS_SHADE,
                     tables + tex_b + npix * 12)

    b_big = k1_bound(work, W * H)
    print(f"  times on {kind} ({card}), canonical + texture {W}x{H} spp32 d50, best of 3 frames "
          f"(camera path frames 1-3) after a warm-up, twice each in turns (K1, K1-ref, K1-ref, "
          f"K1), CUDA events:", flush=True)
    print(f"    K1 {best['K1']:.3f} ms = {rays / best['K1'] / 1e3:.3f} Mrays/s ({k1_work.queries} "
          f"queries, lane utilisation {k1_work.lane_utilisation:.4f}); K1-ref "
          f"{best['K1-ref']:.3f} ms = {rays / best['K1-ref'] / 1e3:.3f} Mrays/s ({work.queries} "
          f"queries, {work.hits} hits, lane utilisation {work.lane_utilisation:.4f}); "
          f"K1-ref/K1 {best['K1-ref'] / best['K1']:.4f}; K1-ref bound {b_big[0]:.3f} ms "
          f"({b_big[1]})", flush=True)
    # the kernels line: K1-ref and its plain version at a shape where the
    # plain version runs in seconds
    tw, th, tspp, td = REF_TIMED
    cam_t = C.camera_at(canon_p.camera_path, 1, canon_p.num_frames, tw, th, canon_p.fov_degrees,
                        background=SKY, device=dev)
    mk.render_frame_kernel(canon, cam_t, tw, th, tspp, td, **REF)
    ms = cuda_ms(lambda: mk.render_frame_kernel(canon, cam_t, tw, th, tspp, td, **REF), reps=3)
    got = mk.render_frame_kernel(canon, cam_t, tw, th, tspp, td, **REF)
    out = {}
    p_ms = cuda_ms(lambda: out.update(fb=renderer.render_frame(canon, cam_t, tw, th, tspp, td,
                                                               **REF)))
    if not compare(f"K1-ref vs plain at {tw}x{th} spp{tspp} d{td}", got, out.pop("fb"), errs):
        return "K1-ref and the plain version disagree at the kernels line's shape", None
    b = k1_bound(mk.loop_work(canon, cam_t, tw, th, tspp, td, **REF), tw * th)
    print(f"    at {tw}x{th} spp{tspp} d{td}: K1-ref {ms:.3f} ms, plain {p_ms:.3f} ms, bound "
          f"{b[0]:.6f} ms ({b[1]})", flush=True)

    # the writers: the main path's frame loop with each, bin and ppm
    print(f"  frame writers in the main path's loop (rng_mode='reference', {mw}x{mh} sqrt_spp 2 "
          f"d{md}: frames cheap beside their {mw * mh * 12} bytes), host clock:", flush=True)
    picked = driver.frame_writer("bin")
    native_ok = isinstance(picked, io_native.AsyncFrameWriter)
    picked.close()
    print(f"    the driver picks {type(picked).__name__} for bin here -> "
          f"{'ok' if native_ok else 'FAIL'}", flush=True)
    if not native_ok:
        return "the driver did not pick the native writer on this machine", None
    wp = config_copy(canon_p)
    wp.render.sqrt_rays_per_pixel = 2
    real_writer = driver.frame_writer
    try:
        for fmt, n_frames in (("bin", 8), ("ppm", 2)):
            for writer_kind in ("native", "thread", "thread", "native"):
                spent = []
                driver.frame_writer = lambda saver, k=writer_kind: timed_writer(k, spent)
                with tempfile.TemporaryDirectory() as tmp:
                    wp.output_path = os.path.join(tmp, "w_%d." + fmt)
                    tsv = io.StringIO()
                    t0 = time.perf_counter()
                    driver.render_animation(canon, wp, saver=fmt, out=tsv,
                                            frames=range(n_frames), engine="cuda", **REF)
                    total = (time.perf_counter() - t0) * 1e3
                    size = os.path.getsize(wp.output_path % 0)
                frame_ms = [float(x.split("\t")[1]) for x in tsv.getvalue().splitlines()]
                print(f"    {fmt} {writer_kind:6s}: {n_frames} frames in {total:.3f} ms (loop, "
                      f"close included); submit {sum(spent) * 1e3:.3f} ms in all, max "
                      f"{max(spent) * 1e3:.3f} ms; TSV frame ms median "
                      f"{sorted(frame_ms)[len(frame_ms) // 2]:.3f}; {size} bytes a file",
                      flush=True)
    finally:
        driver.frame_writer = real_writer

    # utils: a profiled frame, a forced transient failure in the driver
    with tempfile.TemporaryDirectory() as tmp:
        log_dir = os.path.join(tmp, "prof")
        wp.output_path = os.path.join(tmp, "p_%d.bin")
        with profiling.profile_trace(log_dir) as prof:
            driver.render_animation(canon, wp, saver="bin", out=io.StringIO(), frames=[0],
                                    engine="cuda", **REF)
        trace = open(os.path.join(log_dir, "trace.json")).read()
    dev_t = lambda e: (getattr(e, "self_device_time_total", 0)
                       or getattr(e, "self_cuda_time_total", 0))
    top = sorted(prof.key_averages(), key=dev_t, reverse=True)[:5]
    print(f"    profile_trace of one main-path frame: trace.json {len(trace)} bytes, names "
          f"trace_kernel: {'trace_kernel' in trace}; top device operations: "
          + "; ".join(f"{e.key[:60]} {dev_t(e) / 1e3:.3f} ms x{e.count}" for e in top),
          flush=True)
    if "trace_kernel" not in trace:
        return "the profiler's trace does not name the kernel", None
    real_render, saved_backoff = mk.render_frame_kernel, driver.RETRY_BACKOFF_S
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("UNAVAILABLE: connection reset by the test")
        return real_render(*a, **kw)

    err_out = io.StringIO()
    try:
        mk.render_frame_kernel, driver.RETRY_BACKOFF_S = flaky, 0.0
        with contextlib.redirect_stderr(err_out), tempfile.TemporaryDirectory() as tmp:
            cli_p.output_path = os.path.join(tmp, "r_%d.bin")
            fb_r = driver.render_animation(cli_scene, cli_p, frames=[0], out=io.StringIO(),
                                           saver="bin", engine="cuda", retries=2, **REF)
    finally:
        mk.render_frame_kernel, driver.RETRY_BACKOFF_S = real_render, saved_backoff
    retried = resilience.is_transient(RuntimeError("UNAVAILABLE")) and len(calls) == 2
    print(f"    a forced transient failure: {len(calls)} render calls, stderr "
          f"{err_out.getvalue().strip()!r} -> {'ok' if retried else 'FAIL'}", flush=True)
    if not retried or not np.isfinite(fb_r).all():
        return "the driver did not retry a transient failure", None
    print(f"    card: {card}; phase 15: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return None, dict(name="megakernel_ref", route="cuda", source="tracer_torch/csrc/megakernel.cu",
                      replaces="tracer/render/integrator.py:75", launches=launches["megakernel_ref"],
                      max_abs_err=max(errs), ms=ms, plain_ms=p_ms, bound_ms=b[0], bound_by=b[1],
                      library_ms=None)

# ---- phase 16: the RTIOW book's estimator (K1-bvh's RTIOW instantiation) ----

RTIOW_ROWS = (384, 12)  # the band's first image row and its height, across the spheres
RTIOW_TIMEOUT = 900  # seconds for the -fmad=false worker, build included


def rtiow_compare(dev, fmad: bool):
    """K1-bvh's RTIOW instantiation against the plain version on the
    rtiow_final scene's band (RTIOW_ROWS of 1200x800, depth 50), with the
    kernel as it was built: the driver's chunk of spp (139 at 484) in one
    launch, held to L1 within 1% and the mean within TOL_MEAN, as the only
    launch; then the first sample of each chunk alone, by sample. With
    `fmad` (the default build) FMA contraction rounds the kernel's sphere
    roots unlike the plain version's, and on the radius-1000 ground sphere
    that turns a few percent of the samples down another path, so the
    samples are printed but not held; without it (-fmad=false) every
    operation rounds as the plain one does, and the samples are held to
    tests/test_torch_rtiow.py's rule: 99% within 1e-3, L1 within 1%.
    Returns (error or None, the max |diff| of each sample)."""
    import torch

    from rtbench.harness import spec
    from tracer_torch.kernels import megakernel as mk
    from tracer_torch.render import camera as C
    from tracer_torch.render import driver, renderer

    build = "default build" if fmad else "-fmad=false build"
    wl = spec.workload("rtiow_final.frames_bvh_auto")
    scene_kind = spec.scene_kind(wl.config["scene"])
    inp = scene_kind.inputs(wl.config, 1, dev)
    scene, params = scene_kind.program(inp, wl.config, dev, with_bvh=True)
    w = params.width
    spp, depth = params.render.sqrt_rays_per_pixel ** 2, params.render.max_depth
    chunk = max(1, driver.MAX_RAYS_PER_LAUNCH // (w * params.height))
    cam = C.camera_at(params.camera_path, 0, params.num_frames, w, params.height,
                      params.fov_degrees, device=dev)
    row0, rows = RTIOW_ROWS
    band = dict(intersector="bvh", row_offset=row0)
    i, j, base = renderer.pixel_grid(w, rows, device=dev, row_offset=row0)

    def plain(samples):
        """The plain version's radiance `[len(samples), rows, w, 3]` of each
        sample: a one-spp render_pixels call over every (sample, pixel),
        since wang_hash(base + s) is sample s's seed whatever the call,
        so that the plain walk runs once over all of them."""
        n, k = i.shape[0], len(samples)
        s_of = torch.as_tensor(samples, device=dev).repeat_interleave(n)
        got = renderer.render_pixels(scene, cam, i.repeat(k), j.repeat(k), base.repeat(k) + s_of,
                                     1, depth, chunk=1 << 20, intersector="bvh")
        return got.reshape(k, rows, w, 3)

    launch_counts(reset=True)
    got = mk.render_frame_kernel(scene, cam, w, rows, chunk, depth, sample_start=chunk, **band)
    torch.cuda.synchronize()
    launches = launch_counts()
    t0 = time.perf_counter()
    want = plain(range(chunk, 2 * chunk)).double().sum(dim=0)
    torch.cuda.synchronize()
    p_s = time.perf_counter() - t0
    got = got.double()
    l1 = float((got - want).abs().sum() / want.abs().sum())
    rel = abs(float(got.mean() - want.mean())) / float(want.mean())
    ok = (bool(torch.isfinite(got).all()) and float(want.mean()) > 0 and l1 < 0.01
          and rel < TOL_MEAN)
    print(f"  {build}, {scene.num_spheres} spheres, band of {chunk} spp (samples {chunk}.."
          f"{2 * chunk - 1}): L1 {l1:.4g} (< 0.01), mean kernel {float(got.mean()):.9g} plain "
          f"{float(want.mean()):.9g} rel {rel:.3g} (< {TOL_MEAN}); plain {p_s:.1f} s; "
          f"launches {launches} -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        return f"K1-bvh's RTIOW instantiation ({build}) and the plain twin disagree on the band", []
    if launches["megakernel_bvh"] != 1 or sum(launches.values()) != 1:
        return f"the band's launch took {launches}, not one K1-bvh launch", []
    errs = []
    firsts = list(range(0, spp, chunk))
    for s0, want in zip(firsts, plain(firsts).double()):
        got = mk.render_frame_kernel(scene, cam, w, rows, 1, depth, sample_start=s0, **band)
        d = (got.double() - want).abs()
        frac = float((d.amax(dim=-1) < 1e-3).double().mean())
        l1 = float(d.sum() / want.abs().sum())
        ok = bool(torch.isfinite(got).all()) and frac >= TOL_FRAC and l1 < 0.01
        errs.append(float(d.max()))
        verdict = "printed" if fmad else ("ok" if ok else "FAIL")
        print(f"  {build}, sample {s0}: agree {frac:.6f} (>= {TOL_FRAC}), L1 {l1:.4g} (< 0.01), "
              f"max|diff| {float(d.max()):.6g} -> {verdict}", flush=True)
        if not (ok or fmad):
            return (f"K1-bvh's RTIOW instantiation ({build}) and the plain twin disagree on "
                    f"sample {s0}"), errs
    return None, errs


def rtiow_worker() -> int:
    """Phase 16's -fmad=false half (`chip_smoke.py --rtiow-fmad-false`):
    builds megakernel.cu without FMA contraction into its own library and
    runs rtiow_compare on it."""
    import torch

    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    from tracer_torch.kernels import nvcc

    nvcc.SOURCE_FLAGS = {**nvcc.SOURCE_FLAGS, "megakernel": ("-fmad=false",)}
    nvcc.build_all()
    err, _ = rtiow_compare(torch.device("cuda", 0), fmad=False)
    if err:
        print(f"chip_smoke: FAIL: {err}", flush=True)
    return 1 if err else 0


def rtiow_phase(dev, kind, card):
    """Phase 16: K1-bvh's RTIOW instantiation (thin lens, sky, the book's
    materials) on the benchmark cell rtiow_final.frames_bvh_auto's scene,
    built by its scene kind, at the cell's launch shape, against the plain
    version on the same band (rtiow_compare): as built, then built with
    -fmad=false in a worker process (rtiow_worker). Returns an error or
    None."""
    t_phase = time.perf_counter()
    print(f"[16] the RTIOW final scene on K1-bvh's RTIOW instantiation on {kind} ({card}): "
          f"rows {RTIOW_ROWS[0]}..{sum(RTIOW_ROWS) - 1} of 1200x800, depth 50", flush=True)
    err, _ = rtiow_compare(dev, fmad=True)
    if err:
        return err
    try:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--rtiow-fmad-false"],
                              capture_output=True, text=True, cwd=HERE, timeout=RTIOW_TIMEOUT)
    except subprocess.TimeoutExpired:
        return f"the -fmad=false worker timed out after {RTIOW_TIMEOUT} s"
    print("\n".join(x for x in proc.stdout.splitlines() if x.startswith("  ")), flush=True)
    if proc.returncode != 0:
        tail = (proc.stdout + proc.stderr).strip().splitlines()[-5:]
        return f"the -fmad=false worker exited {proc.returncode}: {' | '.join(tail)}"
    print(f"    phase 16: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return None

def main() -> int:
    import torch

    t_start = time.perf_counter()

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
          f"(the one-shot tapes; phase 11 takes the d50 gradients in spp chunks)", flush=True)
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

    # ---- 11. the depth-50 gradient path ------------------------------------
    err, deep_launches, deep_errs = deep_phase(dev, kind, card, canon, canon_p, g)
    if err:
        return fail(err)

    # ---- 12. stratified jitter ----------------------------------------------
    err, strat_errs = stratify_phase(dev, kind, card, canon, canon_p, g)
    if err:
        return fail(err)

    # ---- 13. the BVH path ----------------------------------------------------
    err, bvh_entry = bvh_phase(dev, kind, card, canon_p, cams, W, H, k_ms, env)
    if err:
        return fail(err)

    # ---- 14. distribution ----------------------------------------------------
    err, dist_launches, dist_errs = dist_phase(dev, kind, card, canon, canon_p, g, env)
    if err:
        return fail(err)

    # ---- 15. the reference stream, utils and the native writer ----------------
    err, ref_entry = ref_phase(dev, kind, card, canon_p, cams, W, H, env)
    if err:
        return fail(err)

    # ---- 16. the RTIOW book's estimator -----------------------------------------
    err = rtiow_phase(dev, kind, card)
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
        bvh_entry,
        ref_entry,
    ]
    for k in kernels:  # each kernel's launches on phase 11's and 14's main paths, and its checks
        k["launches_d50"] = deep_launches[k["name"]]
        k["launches_dist"] = dist_launches[k["name"]]
        k["max_abs_err"] = max([k["max_abs_err"], *deep_errs.get(k["name"], []),
                                *strat_errs.get(k["name"], []), *dist_errs.get(k["name"], [])])
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:  # one rank of phase 14, started by the phase
        sys.exit(dist_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--rtiow-fmad-false"]:  # phase 16's -fmad=false half
        sys.exit(rtiow_worker())
    sys.exit(main())
