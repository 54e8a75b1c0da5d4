"""The forward megakernel: build, binding and dispatch (port of
tracer/pallas/megakernel.py:render_frame_pallas, persistent brute path).

`render_frame_kernel` renders one frame as raw sample sums `[H, W, 3]`.
Its plain PyTorch version is `tracer_torch.render.renderer.render_frame`,
with the same signature. Dispatch goes by the device of the scene's
tensors, and only by that:

  - CPU tensors   -> the plain version;
  - CUDA tensors  -> the CUDA kernel (`csrc/megakernel.cu`), or an error.

There is no fallback: a CUDA scene never reaches the plain version, and a
launch the driver refuses raises.

With `cluster_k` > 0 `render_frame_kernel` launches the cluster-culled
kernel instead (port of render_frame_pallas with cluster_k > 0, tracer/
pallas/culling.py), whose plain version is `render_frame(...,
cluster_k=...)`: the same estimator, with each ray testing only the
primitives of the clusters whose box it may hit (kernels/cluster.py).

With `intersector="bvh"` it launches the BVH kernel (K1-bvh), whose
nearest hit walks `scene.bvh`'s child-pair records (kernels/pack.py:
pack_bvh) near child first, in the plain walk's order: the counterpart of
tracer/bvh/traverse.py:traverse, which tracer runs in XLA; its plain
version is `render_frame(..., intersector="bvh")`
(tracer_torch/bvh/traverse.py), the same walk in eager PyTorch.

`stratify=True` (every mode) confines each sample's jitter to its cell of
a k x k sub-pixel grid (`render.camera.get_rays`; tracer's `strat_k`),
k = sqrt(spp) or `strat_sqrt_spp`, which a sample chunk of a larger frame
passes as the whole frame's k.

`row_offset` (every mode; tracer's params slot 15) renders `height` rows
starting at that image row: a row band of a taller frame with the frame's
seeds and rays, which tracer_torch.dist.sharding launches on each rank.

With `rng_mode="reference"` it launches the reference-stream kernel
(K1-ref, brute force or BVH): the same bounce loop with the reference
binary's own scatter stream (rejection samplers, conditional draws) in
place of the 8-draw budget, whose plain version is `render_frame(...,
rng_mode="reference")`. tracer renders that stream with its XLA renderer
only (tracer/render/driver.py drops from Pallas to XLA for it); here the
card renders it with K1-ref. It refuses `rr_start` and `cluster_k` > 0,
as the plain version does.

`render_frame_kernel_record` is the record mode (port of
render_frame_pallas_record), whose plain version is
`tracer_torch.render.renderer.render_frame_record`: the same frame plus
the winner-index and texture tapes the backward kernel replays.

Every kernel launches one wave of the blocks the card holds at once for
its instantiation and shared bytes (a block for each 128 pixels of a
smaller band), and each lane, once its pixel's samples are done, takes
the next pixel from a counter that `_launch` zeroes for the launch: a
lane no longer waits for the slowest pixel of its warp. Which lane
renders a pixel changes nothing in the frame or the tapes.

`loop_work` launches the counted instantiation of the same kernels and
returns the launch's work (nearest-hit queries, hits, warp passes and
active lanes, and K1-cl's and K1-bvh's node tests, leaves reached and
primitive tests; camera samples, the warp passes that scatter and those
among them whose lanes take more than one material branch, and the warp
passes in the launch's tail, after a lane of the warp found the pool
empty); the plain query count is
`tracer_torch.render.renderer.query_count`.

The RTIOW book's estimator (a camera with a thin lens, a scene with a
sky, the material codes RTIOW_LAMBERTIAN and RTIOW_METAL; `pack.
rtiow_features`) renders with K1-bvh's RTIOW instantiation (entry mode
6), which `intersector="bvh"` takes on its own for such a scene or
camera; every other kernel (K1, K1-rec, K1-cl, K1-ref, K1-bvh-ref, and
K2 in kernels/bwd.py) raises a ValueError that names what it lacks.

The brute kernels (K1, K1-rec, brute K1-ref) cull by object
(`Scene.groups`; csrc/megakernel.cu's note, kernels/pack.py:pack_groups).

The scene's sphere and plane records (kernels/pack.py), with the brute
kernels' group records, are staged in shared memory when they take at
most `TABLE_SHARED_BYTES_MAX` bytes (the canonical scene, about 10 KB); a
larger scene, such as the 2000-sphere field (32 KB), takes the kernel's
variant that reads them from global memory. K1-cl's cluster-tree nodes
(kernels/cluster.py) and K1-bvh's BVH records (kernels/pack.py:pack_bvh)
are staged there too when they take at most `NODE_SHARED_BYTES_MAX` bytes.

The kernels are compiled at first use by `nvcc` (tracer_torch.kernels.
nvcc) into shared libraries with plain C entry points, loaded with ctypes.
`LAUNCHES`, `LAUNCHES_RECORD`, `LAUNCHES_CLUSTERED`, `LAUNCHES_BVH` and
`LAUNCHES_REF` count the five kernels' launches (K1-ref's brute and BVH
launches both in `LAUNCHES_REF`), so a run can show that its main path
went through them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tracer_torch.bvh import builder as bvh_builder
from tracer_torch.kernels import cluster as cluster_mod
from tracer_torch.kernels import nvcc
from tracer_torch.kernels import pack as pack_mod
from tracer_torch.render import camera as camera_mod
from tracer_torch.render import integrator, renderer
from tracer_torch.utils import profiling

LAUNCHES = 0  # launches of the forward kernel since import (or since reset to 0)
LAUNCHES_RECORD = 0  # launches of the record-mode kernel
LAUNCHES_CLUSTERED = 0  # launches of the cluster-culled kernel
LAUNCHES_BVH = 0  # launches of the BVH kernel
LAUNCHES_REF = 0  # launches of the reference-stream kernel (brute or BVH)
# scene records up to this many bytes are staged in shared memory: on the
# H100 that was faster for the canonical scene (10 KB) and slower for the
# 2000-sphere field (32 KB, fewer resident blocks); PERF.md has the times
TABLE_SHARED_BYTES_MAX = 16 * 1024
# K1-cl's tree nodes up to this many bytes (32 a node) are staged in shared
# memory: on the H100 that was faster for the 2000-sphere field's 8 KB and
# slower for the 5000-sphere field's 32 KB (fewer resident blocks); PERF.md
# has the times. K1-bvh's records (64 bytes an internal node) take the same
# rule: the canonical scene's 12.7 KB are staged, a 1000-sphere field's not.
NODE_SHARED_BYTES_MAX = 16 * 1024
# K1-bvh's per-thread stack and depth guard (BVH_STACK in csrc/megakernel.cu), the
# deepest tree the BVH builder makes
BVH_STACK = bvh_builder.BVH_STACK
# the counted instantiation's counters (COUNTS in csrc/megakernel.cu)
COUNT_NAMES = ("queries", "hits", "visits", "tests", "passes", "active_lanes", "node_tests",
               "samples", "scatter_passes", "mixed_passes", "drained_passes")
MODE_RENDER, MODE_RECORD, MODE_CLUSTERED, MODE_BVH, MODE_REF, MODE_BVH_REF = 0, 1, 2, 3, 4, 5
MODE_BVH_RTIOW = 6  # K1-bvh's RTIOW instantiation: lens, sky and the RTIOW materials
KERNEL_NAMES = {MODE_RENDER: "K1 (brute force)", MODE_RECORD: "K1-rec (record mode)",
                MODE_CLUSTERED: "K1-cl (cluster-culled)", MODE_BVH: "K1-bvh",
                MODE_REF: "K1-ref (reference stream)",
                MODE_BVH_REF: "K1-bvh-ref (reference stream)", MODE_BVH_RTIOW: "K1-bvh (RTIOW)"}


class LoopWork(NamedTuple):
    """One launch's bounce-loop work, counted by the kernel. The lanes take
    their pixels from the launch's pool in the order they reach it, so the
    warp-level counts (`passes`, `active_lanes`, `scatter_passes`,
    `mixed_passes`, `drained_passes`) vary from launch to launch; the
    others depend on the pixels' paths alone."""
    queries: int  # nearest-hit queries (one per pass of a lane)
    hits: int  # queries that hit a primitive
    visits: int  # K1-cl, K1-bvh: leaves the walks reached; brute: groups whose ball was entered
    tests: int  # primitives tested (K1-cl, K1-bvh: in those leaves)
    passes: int  # warp passes: loop passes, each counted once per warp
    active_lanes: int  # the active lanes of those passes, summed
    node_tests: int  # K1-cl, K1-bvh: the walks' slab tests of nodes (0 for K1, K1-rec)
    samples: int  # camera samples started
    scatter_passes: int  # warp passes in which some lane scatters
    mixed_passes: int  # those whose scattering lanes take more than one material branch
    drained_passes: int  # warp passes after a lane of the warp found the pool empty: the tail

    @property
    def lane_utilisation(self) -> float:
        """Active lanes per warp pass over the warp's 32."""
        return self.active_lanes / (32 * self.passes) if self.passes else 0.0


def library_path():
    return nvcc.library_path("megakernel")


def build() -> nvcc.Build:
    """Compile the kernels (once per source hash); the megakernel's Build."""
    return nvcc.build_all()["megakernel"]


def _fn():
    fn = build().lib.tracer_megakernel_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, p, i, p, i, p, p, i, i, p, p, i, i, i, i, ctypes.c_uint, i, i, p, p, i,
                   p, p, i, i, i, i, i, i, p, p, p]
    fn.restype = i
    return fn


def _check(name, t, device, shape=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the scene on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def _prepare(scene, cam, width, height, spp, max_depth, rr_start, sample_start, row_offset):
    """Check what the kernels take; returns (device, texture layer or None)."""
    device = scene.device
    for name, val in (("width", width), ("height", height), ("spp", spp),
                      ("max_depth", max_depth)):
        if not (isinstance(val, int) and val > 0):
            raise ValueError(f"{name} must be a positive int, got {val!r}")
    if isinstance(row_offset, bool) or not isinstance(row_offset, int) or row_offset < 0:
        raise ValueError(f"row_offset must be an int >= 0, got {row_offset!r}")
    if width * (row_offset + height) >= 2**31:
        raise ValueError(f"{width}x{row_offset + height} frame exceeds the kernel's int32 "
                         f"pixel index")
    if not (0 <= sample_start and sample_start + spp <= 2**32):
        raise ValueError(f"samples {sample_start}..+{spp} leave the uint32 sample range")
    if rr_start is not None and not (isinstance(rr_start, int) and rr_start >= 0):
        raise ValueError(f"rr_start must be None or an int >= 0, got {rr_start!r}")
    if scene.num_spheres + scene.num_planes == 0:
        raise ValueError("scene has no primitives")
    for f in scene.spheres + scene.planes + scene.materials:
        if f.device != device:
            raise ValueError(f"scene tensor on {f.device}, scene on {device}")
    tex = None
    if scene.textures is not None:
        _check("textures", scene.textures, device)
        if scene.textures.dim() != 4 or scene.textures.shape[-1] != 3:
            raise ValueError(f"textures must be [T, H, W, 3], got {tuple(scene.textures.shape)}")
        if scene.textures.shape[0] != 1:
            raise ValueError("megakernel: one texture layer only")
        tex = scene.textures[0].contiguous()
    for name, t in zip(cam._fields, cam):
        _check(f"cam.{name}", t, device, (3,))
    if cam.lens is not None:
        _check("cam.lens", cam.lens, device, (2, 3))
    if scene.sky is not None:
        for name, t in zip(scene.sky._fields, scene.sky):
            _check(f"scene.sky.{name}", t, device, (3,))
    return device, tex


def _kernel_mode(mode, scene, cam):
    """`mode`, or K1-bvh's RTIOW instantiation for a scene or camera that
    asks for the RTIOW book's estimator (pack.rtiow_features), which only
    K1-bvh on the fixed stream renders: every other kernel raises."""
    features = pack_mod.rtiow_features(scene, cam)
    if not features:
        return mode
    if mode != MODE_BVH:
        raise ValueError(f"{KERNEL_NAMES[mode]} does not support {', '.join(features)}: only "
                         f"K1-bvh (intersector='bvh', rng_mode='fixed') renders them")
    return MODE_BVH_RTIOW


def _launch(mode, scene, cam, tex, out, width, height, spp, max_depth, sample_start,
            reference_quirk, rr_start, idx=None, ttape=None, tape_f=0, tables=None,
            nodes=None, strat_k=0, counts=None, row_offset=0):
    """Pack the scene and camera and launch `mode` on the current stream;
    `nodes` is K1-cl's (`tables.nodes`) or K1-bvh's node records, and a
    brute mode's the scene's group records; the launch covers image rows
    row_offset .. row_offset + height - 1."""
    packed = pack_mod.pack_scene(scene)
    if mode == MODE_BVH_RTIOW:
        cam_t = pack_mod.pack_camera_rtiow(cam, scene)
    else:
        cam_t = pack_mod.pack_camera(cam)
    th, tw = (0, 0) if tex is None else (int(tex.shape[0]), int(tex.shape[1]))
    brute = mode in (MODE_RENDER, MODE_RECORD, MODE_REF)
    if brute:
        nodes = pack_mod.pack_groups(scene)  # staged with the tables
    table_bytes = 4 * (packed.sph.numel() + packed.pla.numel() + (nodes.numel() if brute else 0))
    ptr = lambda t: None if t is None else t.data_ptr()
    if counts is not None and (counts.dtype != torch.int64 or counts.numel() < len(COUNT_NAMES)):
        raise ValueError(f"counts must be {len(COUNT_NAMES)} int64 counters")
    if tables is not None:
        nodes = tables.nodes
    stream = torch.cuda.current_stream(out.device).cuda_stream
    nxt = torch.zeros(1, dtype=torch.int32, device=out.device)  # the lanes' pixel pool
    # the packed tensors live until the call returns, after the launch is enqueued
    return _fn()(mode, ptr(packed.sph), packed.num_s, ptr(packed.pla), packed.num_p,
                 ptr(packed.join), ptr(tex), th, tw, ptr(cam_t), ptr(out), width, height, spp,
                 max_depth, sample_start, int(reference_quirk),
                 -1 if rr_start is None else rr_start, ptr(idx), ptr(ttape), tape_f,
                 ptr(nodes), None if tables is None else ptr(tables.slots),
                 0 if nodes is None else nodes.shape[0],
                 0 if tables is None else tables.k, int(table_bytes <= TABLE_SHARED_BYTES_MAX),
                 int(nodes is not None and 4 * nodes.numel() <= NODE_SHARED_BYTES_MAX),
                 strat_k, row_offset, ptr(counts), ptr(nxt), stream)


def render_frame_kernel(scene, cam, width: int, height: int, spp: int, max_depth: int,
                        reference_quirk: bool = True, rr_start=None, sample_start: int = 0,
                        cluster_k: int = 0, stratify: bool = False, strat_sqrt_spp: int = 0,
                        intersector: str = "brute", row_offset: int = 0,
                        rng_mode: str = "fixed"):
    """Render one frame; returns `[height, width, 3]` raw sample sums of the
    global samples `sample_start .. sample_start + spp - 1`. With
    `row_offset` > 0 the `height` rows are the image rows `row_offset ..
    row_offset + height - 1` of a taller frame (every mode), bit for bit
    those rows of the frame's one launch: a row band of the sharded path
    (tracer_torch.dist.sharding).

    Same contract, RNG streams and estimator as
    `tracer_torch.render.renderer.render_frame`, which it calls for a scene
    on the CPU. For a CUDA scene it launches the kernel on the current
    stream without synchronising, or raises. `cluster_k` > 0 takes the
    cluster-culled kernel over clusters of at most that many primitives,
    `intersector="bvh"` the BVH kernel ("brute" and "fast" the brute one),
    `rng_mode="reference"` the reference-stream kernel K1-ref (brute or
    BVH; it refuses `rr_start` and `cluster_k` > 0). The host side of a
    CUDA launch is the span `tracer.launch` (utils/profiling.span).
    """
    if scene.device.type == "cpu":
        return renderer.render_frame(scene, cam, width, height, spp, max_depth,
                                     reference_quirk=reference_quirk, rr_start=rr_start,
                                     sample_start=sample_start, cluster_k=cluster_k,
                                     stratify=stratify, strat_sqrt_spp=strat_sqrt_spp,
                                     intersector=intersector, row_offset=row_offset,
                                     rng_mode=rng_mode)
    if scene.device.type != "cuda":
        raise ValueError(f"render_frame_kernel: no kernel for device {scene.device}")
    with profiling.span("tracer.launch"):
        k = camera_mod.strat_grid(stratify, spp, strat_sqrt_spp)
        integrator.check_intersector(intersector, scene)
        args = (scene, cam, width, height, spp, max_depth, reference_quirk, rr_start,
                sample_start)
        if integrator.check_rng_mode(rng_mode, rr_start) == "reference":
            if cluster_mod.check_k(cluster_k):
                raise ValueError("cluster_k > 0 runs the fixed-budget RNG stream only")
            return _render_ref(*args, None, intersector, strat_k=k, row_offset=row_offset)
        if cluster_mod.check_k(cluster_k):
            if intersector == "bvh":
                raise ValueError("intersector 'bvh' and cluster_k > 0 exclude each other")
            return _render_clustered(*args, cluster_k, None, strat_k=k, row_offset=row_offset)
        if intersector == "bvh":
            return _render_bvh(*args, None, strat_k=k, row_offset=row_offset)
        return _render(*args, None, strat_k=k, row_offset=row_offset)


def _forward(mode, scene, cam, width, height, spp, max_depth, reference_quirk, rr_start,
             sample_start, counts, strat_k, tables=None, nodes=None, row_offset=0):
    mode = _kernel_mode(mode, scene, cam)
    device, tex = _prepare(scene, cam, width, height, spp, max_depth, rr_start, sample_start,
                           row_offset)
    out = torch.empty((height, width, 3), dtype=torch.float32, device=device)
    err = _launch(mode, scene, cam, tex, out, width, height, spp, max_depth, sample_start,
                  reference_quirk, rr_start, tables=tables, nodes=nodes, strat_k=strat_k,
                  counts=counts, row_offset=row_offset)
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAMES[mode]} launch failed: CUDA error {err}")
    return out


def _render(scene, cam, width, height, spp, max_depth, reference_quirk, rr_start, sample_start,
            counts, strat_k=0, row_offset=0):
    out = _forward(MODE_RENDER, scene, cam, width, height, spp, max_depth, reference_quirk,
                   rr_start, sample_start, counts, strat_k, row_offset=row_offset)
    global LAUNCHES
    LAUNCHES += 1
    return out


def _render_clustered(scene, cam, width, height, spp, max_depth, reference_quirk, rr_start,
                      sample_start, cluster_k, counts, strat_k=0, row_offset=0):
    tables = cluster_mod.pack_clustered(scene, cluster_k)
    out = _forward(MODE_CLUSTERED, scene, cam, width, height, spp, max_depth, reference_quirk,
                   rr_start, sample_start, counts, strat_k, tables=tables, row_offset=row_offset)
    global LAUNCHES_CLUSTERED
    LAUNCHES_CLUSTERED += 1
    return out


def _render_bvh(scene, cam, width, height, spp, max_depth, reference_quirk, rr_start,
                sample_start, counts, strat_k=0, row_offset=0):
    nodes = pack_mod.pack_bvh(scene, BVH_STACK)
    out = _forward(MODE_BVH, scene, cam, width, height, spp, max_depth, reference_quirk,
                   rr_start, sample_start, counts, strat_k, nodes=nodes, row_offset=row_offset)
    global LAUNCHES_BVH
    LAUNCHES_BVH += 1
    return out


def _render_ref(scene, cam, width, height, spp, max_depth, reference_quirk, rr_start,
                sample_start, counts, intersector, strat_k=0, row_offset=0):
    nodes = pack_mod.pack_bvh(scene, BVH_STACK) if intersector == "bvh" else None
    out = _forward(MODE_BVH_REF if nodes is not None else MODE_REF, scene, cam, width, height,
                   spp, max_depth, reference_quirk, rr_start, sample_start, counts, strat_k,
                   nodes=nodes, row_offset=row_offset)
    global LAUNCHES_REF
    LAUNCHES_REF += 1
    return out


def loop_work(scene, cam, width: int, height: int, spp: int, max_depth: int,
              reference_quirk: bool = True, rr_start=None, sample_start: int = 0,
              cluster_k: int = 0, record: bool = False, stratify: bool = False,
              strat_sqrt_spp: int = 0, intersector: str = "brute",
              row_offset: int = 0, rng_mode: str = "fixed") -> LoopWork:
    """The bounce-loop work of one launch of K1 (or K1-cl with `cluster_k`
    > 0, K1-bvh with `intersector="bvh"`, K1-rec with `record`, or brute
    K1-ref with `rng_mode="reference"`, which has no other counted
    instantiation) with
    these arguments, counted by the kernel's counted instantiation: the
    counterpart of the TPU kernel's `debug_iters`. CUDA scenes only;
    synchronises. Its plain counterpart for the queries is
    `renderer.query_count`, for K1-bvh's walk the `work` of
    `renderer.render_pixels(intersector="bvh")`."""
    if scene.device.type != "cuda":
        raise ValueError("the work is counted inside the CUDA kernel: the scene must be on CUDA")
    k = camera_mod.strat_grid(stratify, spp, strat_sqrt_spp)
    integrator.check_intersector(intersector, scene)
    clustered = cluster_mod.check_k(cluster_k) > 0
    if record and (clustered or intersector == "bvh"):
        raise ValueError("the record kernel is brute force only: cluster_k must be 0 and "
                         "the intersector brute")
    if clustered and intersector == "bvh":
        raise ValueError("intersector 'bvh' and cluster_k > 0 exclude each other")
    ref = integrator.check_rng_mode(rng_mode, rr_start) == "reference"
    if ref and (record or clustered or intersector == "bvh"):
        raise ValueError("the counted reference-stream kernel is brute force only, and neither "
                         "records nor culls")
    args = (scene, cam, width, height, spp, max_depth, reference_quirk, rr_start, sample_start)
    kw = dict(strat_k=k, row_offset=row_offset)
    if ref:
        launch = lambda counts: _render_ref(*args, counts, "brute", **kw)
    elif record:
        launch = lambda counts: _record(*args, 9, counts, **kw)
    elif clustered:
        launch = lambda counts: _render_clustered(*args, cluster_k, counts, **kw)
    elif intersector == "bvh":
        launch = lambda counts: _render_bvh(*args, counts, **kw)
    else:
        launch = lambda counts: _render(*args, counts, **kw)
    counts = torch.zeros(len(COUNT_NAMES), dtype=torch.int64, device=scene.device)
    launch(counts)
    return LoopWork(**dict(zip(COUNT_NAMES, (int(c) for c in counts.tolist()))))


def tape_bytes(width: int, height: int, spp: int, max_depth: int, tape_fields: int,
               textured: bool) -> int:
    """Device bytes of the record mode's tapes (4 bytes per slot and field)."""
    return 4 * width * height * spp * max_depth * (1 + (tape_fields if textured else 0))


def render_frame_kernel_record(scene, cam, width: int, height: int, spp: int, max_depth: int,
                               reference_quirk: bool = True, rr_start=None,
                               sample_start: int = 0, tape_fields: int = 9,
                               stratify: bool = False, strat_sqrt_spp: int = 0,
                               row_offset: int = 0):
    """The recording forward: (fb `[H, W, 3]`, idx `[spp, D, H*W]` int32)
    for an untextured scene or `tape_fields=0` and (fb, idx, tex `[spp, D,
    H*W, F]`) for a textured one, with the contract of
    `tracer_torch.render.renderer.render_frame_record`, which it calls for
    a scene on the CPU. For a CUDA scene the tex tape it returns is a view
    of a field-major `[F, spp, D, H*W]` tensor, the layout the backward
    kernel reads. Raises, with the byte count, when the tapes would not fit
    in the device's free memory. Brute force only, as tracer's record
    kernel; `stratify` and `row_offset` as render_frame_kernel (a band's
    tapes hold its own pixels only)."""
    if scene.device.type == "cpu":
        return renderer.render_frame_record(scene, cam, width, height, spp, max_depth,
                                            reference_quirk=reference_quirk,
                                            rr_start=rr_start, sample_start=sample_start,
                                            tape_fields=tape_fields, stratify=stratify,
                                            strat_sqrt_spp=strat_sqrt_spp,
                                            row_offset=row_offset)
    if scene.device.type != "cuda":
        raise ValueError(f"render_frame_kernel_record: no kernel for device {scene.device}")
    return _record(scene, cam, width, height, spp, max_depth, reference_quirk, rr_start,
                   sample_start, tape_fields, None,
                   strat_k=camera_mod.strat_grid(stratify, spp, strat_sqrt_spp),
                   row_offset=row_offset)


def _record(scene, cam, width, height, spp, max_depth, reference_quirk, rr_start, sample_start,
            tape_fields, counts, strat_k=0, row_offset=0):
    if tape_fields not in integrator.TAPE_FIELDS:
        raise ValueError(f"tape_fields must be one of {integrator.TAPE_FIELDS}, got {tape_fields}")
    _kernel_mode(MODE_RECORD, scene, cam)
    device, tex = _prepare(scene, cam, width, height, spp, max_depth, rr_start, sample_start,
                           row_offset)
    need = tape_bytes(width, height, spp, max_depth, tape_fields, tex is not None)
    free, _total = torch.cuda.mem_get_info(device)
    if need > free:
        raise RuntimeError(f"record tapes need {need} bytes, the device has {free} free: "
                           f"cut spp or max_depth")
    npx = width * height
    out = torch.empty((height, width, 3), dtype=torch.float32, device=device)
    idx = torch.full((spp, max_depth, npx), -1, dtype=torch.int32, device=device)
    ttape = None
    if tex is not None and tape_fields:
        neutral = torch.tensor(integrator.TAPE_NEUTRAL[:tape_fields], device=device)
        ttape = neutral[:, None, None, None].expand(tape_fields, spp, max_depth, npx).contiguous()
    err = _launch(MODE_RECORD, scene, cam, tex, out, width, height, spp, max_depth,
                  sample_start, reference_quirk, rr_start, idx=idx, ttape=ttape,
                  tape_f=tape_fields if ttape is not None else 0, strat_k=strat_k,
                  counts=counts, row_offset=row_offset)
    if err != 0:
        raise RuntimeError(f"record kernel launch failed: CUDA error {err}")
    global LAUNCHES_RECORD
    LAUNCHES_RECORD += 1
    if ttape is None:
        return out, idx
    return out, idx, ttape.permute(1, 2, 3, 0)
