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

`render_frame_kernel_record` is the record mode (port of
render_frame_pallas_record), whose plain version is
`tracer_torch.render.renderer.render_frame_record`: the same frame plus
the winner-index and texture tapes the backward kernel replays.

`loop_work` launches the counted instantiation of the same kernels and
returns the launch's work (nearest-hit queries, hits, warp passes and
active lanes, and K1-cl's cluster visits and primitive tests); the plain
query count is `tracer_torch.render.renderer.query_count`.

The scene's sphere and plane records (kernels/pack.py) are staged in
shared memory when they take at most `TABLE_SHARED_BYTES_MAX` bytes (the
canonical scene, about 10 KB); a larger scene, such as the 2000-sphere
field (32 KB), takes the kernel's variant that reads them from global
memory.

The kernels are compiled at first use by `nvcc` (tracer_torch.kernels.
nvcc) into shared libraries with plain C entry points, loaded with ctypes.
`LAUNCHES`, `LAUNCHES_RECORD` and `LAUNCHES_CLUSTERED` count the three
kernels' launches, so a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tracer_torch.kernels import cluster as cluster_mod
from tracer_torch.kernels import nvcc
from tracer_torch.kernels import pack as pack_mod
from tracer_torch.render import integrator, renderer

LAUNCHES = 0  # launches of the forward kernel since import (or since reset to 0)
LAUNCHES_RECORD = 0  # launches of the record-mode kernel
LAUNCHES_CLUSTERED = 0  # launches of the cluster-culled kernel
# scene records up to this many bytes are staged in shared memory: on the
# H100 that was faster for the canonical scene (10 KB) and slower for the
# 2000-sphere field (32 KB, fewer resident blocks); PERF.md has the times
TABLE_SHARED_BYTES_MAX = 16 * 1024
# the counted instantiation's counters (COUNTS in csrc/megakernel.cu)
COUNT_NAMES = ("queries", "hits", "visits", "tests", "passes", "active_lanes")
MODE_RENDER, MODE_RECORD, MODE_CLUSTERED = 0, 1, 2


class LoopWork(NamedTuple):
    """One launch's bounce-loop work, counted by the kernel."""
    queries: int  # nearest-hit queries (one per pass of a lane)
    hits: int  # queries that hit a primitive
    visits: int  # K1-cl: clusters whose box a query's ray may hit (0 for K1, K1-rec)
    tests: int  # K1-cl: primitives tested in those clusters (0 for K1, K1-rec)
    passes: int  # warp passes: loop passes, each counted once per warp
    active_lanes: int  # the active lanes of those passes, summed

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
                   p, p, i, i, i, p, p]
    fn.restype = i
    return fn


def _check(name, t, device, shape=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the scene on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def _prepare(scene, cam, width, height, spp, max_depth, rr_start, sample_start):
    """Check what the kernels take; returns (device, texture layer or None)."""
    device = scene.device
    for name, val in (("width", width), ("height", height), ("spp", spp),
                      ("max_depth", max_depth)):
        if not (isinstance(val, int) and val > 0):
            raise ValueError(f"{name} must be a positive int, got {val!r}")
    if width * height >= 2**31:
        raise ValueError(f"{width}x{height} frame exceeds the kernel's int32 pixel index")
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
    return device, tex


def _launch(mode, scene, cam, tex, out, width, height, spp, max_depth, sample_start,
            reference_quirk, rr_start, idx=None, ttape=None, tape_f=0, tables=None,
            counts=None):
    """Pack the scene and camera and launch `mode` on the current stream."""
    packed = pack_mod.pack_scene(scene)
    cam_t = pack_mod.pack_camera(cam)
    th, tw = (0, 0) if tex is None else (int(tex.shape[0]), int(tex.shape[1]))
    table_bytes = 4 * (packed.sph.numel() + packed.pla.numel())
    ptr = lambda t: None if t is None else t.data_ptr()
    if counts is not None and (counts.dtype != torch.int64 or counts.numel() < len(COUNT_NAMES)):
        raise ValueError(f"counts must be {len(COUNT_NAMES)} int64 counters")
    stream = torch.cuda.current_stream(out.device).cuda_stream
    # the packed tensors live until the call returns, after the launch is enqueued
    return _fn()(mode, ptr(packed.sph), packed.num_s, ptr(packed.pla), packed.num_p,
                 ptr(packed.join), ptr(tex), th, tw, ptr(cam_t), ptr(out), width, height, spp,
                 max_depth, sample_start, int(reference_quirk),
                 -1 if rr_start is None else rr_start, ptr(idx), ptr(ttape), tape_f,
                 None if tables is None else ptr(tables.boxes),
                 None if tables is None else ptr(tables.slots),
                 0 if tables is None else tables.num_clusters,
                 0 if tables is None else tables.k, int(table_bytes <= TABLE_SHARED_BYTES_MAX),
                 ptr(counts), stream)


def render_frame_kernel(scene, cam, width: int, height: int, spp: int, max_depth: int,
                        reference_quirk: bool = True, rr_start=None, sample_start: int = 0,
                        cluster_k: int = 0):
    """Render one frame; returns `[height, width, 3]` raw sample sums of the
    global samples `sample_start .. sample_start + spp - 1`.

    Same contract, RNG streams and estimator as
    `tracer_torch.render.renderer.render_frame`, which it calls for a scene
    on the CPU. For a CUDA scene it launches the kernel on the current
    stream without synchronising, or raises. `cluster_k` > 0 takes the
    cluster-culled kernel over clusters of at most that many primitives.
    """
    if scene.device.type == "cpu":
        return renderer.render_frame(scene, cam, width, height, spp, max_depth,
                                     reference_quirk=reference_quirk, rr_start=rr_start,
                                     sample_start=sample_start, cluster_k=cluster_k)
    if scene.device.type != "cuda":
        raise ValueError(f"render_frame_kernel: no kernel for device {scene.device}")
    if cluster_mod.check_k(cluster_k):
        return _render_clustered(scene, cam, width, height, spp, max_depth, reference_quirk,
                                 rr_start, sample_start, cluster_k, None)
    return _render(scene, cam, width, height, spp, max_depth, reference_quirk, rr_start,
                   sample_start, None)


def _render(scene, cam, width, height, spp, max_depth, reference_quirk, rr_start, sample_start,
            counts):
    device, tex = _prepare(scene, cam, width, height, spp, max_depth, rr_start, sample_start)
    out = torch.empty((height, width, 3), dtype=torch.float32, device=device)
    err = _launch(MODE_RENDER, scene, cam, tex, out, width, height, spp, max_depth,
                  sample_start, reference_quirk, rr_start, counts=counts)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _render_clustered(scene, cam, width, height, spp, max_depth, reference_quirk, rr_start,
                      sample_start, cluster_k, counts):
    device, tex = _prepare(scene, cam, width, height, spp, max_depth, rr_start, sample_start)
    tables = cluster_mod.pack_clustered(scene, cluster_k)
    out = torch.empty((height, width, 3), dtype=torch.float32, device=device)
    err = _launch(MODE_CLUSTERED, scene, cam, tex, out, width, height, spp, max_depth,
                  sample_start, reference_quirk, rr_start, tables=tables, counts=counts)
    if err != 0:
        raise RuntimeError(f"clustered megakernel launch failed: CUDA error {err}")
    global LAUNCHES_CLUSTERED
    LAUNCHES_CLUSTERED += 1
    return out


def loop_work(scene, cam, width: int, height: int, spp: int, max_depth: int,
              reference_quirk: bool = True, rr_start=None, sample_start: int = 0,
              cluster_k: int = 0, record: bool = False) -> LoopWork:
    """The bounce-loop work of one launch of K1 (or K1-cl with `cluster_k`
    > 0, or K1-rec with `record`) with these arguments, counted by the
    kernel's counted instantiation: the counterpart of the TPU kernel's
    `debug_iters`. CUDA scenes only; synchronises. Its plain counterpart
    for the queries is `renderer.query_count`."""
    if scene.device.type != "cuda":
        raise ValueError("the work is counted inside the CUDA kernel: the scene must be on CUDA")
    if record and cluster_mod.check_k(cluster_k):
        raise ValueError("the record kernel is brute force only: cluster_k must be 0")
    if record:
        launch = lambda counts: _record(scene, cam, width, height, spp, max_depth,
                                        reference_quirk, rr_start, sample_start, 9, counts)
    elif cluster_mod.check_k(cluster_k):
        launch = lambda counts: _render_clustered(scene, cam, width, height, spp, max_depth,
                                                  reference_quirk, rr_start, sample_start,
                                                  cluster_k, counts)
    else:
        launch = lambda counts: _render(scene, cam, width, height, spp, max_depth,
                                        reference_quirk, rr_start, sample_start, counts)
    counts = torch.zeros(len(COUNT_NAMES), dtype=torch.int64, device=scene.device)
    launch(counts)
    return LoopWork(**dict(zip(COUNT_NAMES, (int(c) for c in counts.tolist()))))


def tape_bytes(width: int, height: int, spp: int, max_depth: int, tape_fields: int,
               textured: bool) -> int:
    """Device bytes of the record mode's tapes (4 bytes per slot and field)."""
    return 4 * width * height * spp * max_depth * (1 + (tape_fields if textured else 0))


def render_frame_kernel_record(scene, cam, width: int, height: int, spp: int, max_depth: int,
                               reference_quirk: bool = True, rr_start=None,
                               sample_start: int = 0, tape_fields: int = 9):
    """The recording forward: (fb `[H, W, 3]`, idx `[spp, D, H*W]` int32)
    for an untextured scene and (fb, idx, tex `[spp, D, H*W, F]`) for a
    textured one, with the contract of
    `tracer_torch.render.renderer.render_frame_record`, which it calls for
    a scene on the CPU. For a CUDA scene the tex tape it returns is a view
    of a field-major `[F, spp, D, H*W]` tensor, the layout the backward
    kernel reads. Raises, with the byte count, when the tapes would not fit
    in the device's free memory."""
    if scene.device.type == "cpu":
        return renderer.render_frame_record(scene, cam, width, height, spp, max_depth,
                                            reference_quirk=reference_quirk,
                                            rr_start=rr_start, sample_start=sample_start,
                                            tape_fields=tape_fields)
    if scene.device.type != "cuda":
        raise ValueError(f"render_frame_kernel_record: no kernel for device {scene.device}")
    return _record(scene, cam, width, height, spp, max_depth, reference_quirk, rr_start,
                   sample_start, tape_fields, None)


def _record(scene, cam, width, height, spp, max_depth, reference_quirk, rr_start, sample_start,
            tape_fields, counts):
    if tape_fields not in integrator.TAPE_FIELDS:
        raise ValueError(f"tape_fields must be one of {integrator.TAPE_FIELDS}, got {tape_fields}")
    device, tex = _prepare(scene, cam, width, height, spp, max_depth, rr_start, sample_start)
    need = tape_bytes(width, height, spp, max_depth, tape_fields, tex is not None)
    free, _total = torch.cuda.mem_get_info(device)
    if need > free:
        raise RuntimeError(f"record tapes need {need} bytes, the device has {free} free: "
                           f"cut spp or max_depth")
    npx = width * height
    out = torch.empty((height, width, 3), dtype=torch.float32, device=device)
    idx = torch.full((spp, max_depth, npx), -1, dtype=torch.int32, device=device)
    ttape = None
    if tex is not None:
        neutral = torch.tensor(integrator.TAPE_NEUTRAL[:tape_fields], device=device)
        ttape = neutral[:, None, None, None].expand(tape_fields, spp, max_depth, npx).contiguous()
    err = _launch(MODE_RECORD, scene, cam, tex, out, width, height, spp, max_depth,
                  sample_start, reference_quirk, rr_start, idx=idx, ttape=ttape,
                  tape_f=tape_fields if ttape is not None else 0, counts=counts)
    if err != 0:
        raise RuntimeError(f"record kernel launch failed: CUDA error {err}")
    global LAUNCHES_RECORD
    LAUNCHES_RECORD += 1
    if ttape is None:
        return out, idx
    return out, idx, ttape.permute(1, 2, 3, 0)
