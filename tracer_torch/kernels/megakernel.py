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

The kernels are compiled at first use by `nvcc` (tracer_torch.kernels.
nvcc) into shared libraries with plain C entry points, loaded with ctypes.
`LAUNCHES`, `LAUNCHES_RECORD` and `LAUNCHES_CLUSTERED` count the three
kernels' launches, so a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes

import torch

from tracer_torch.kernels import cluster as cluster_mod
from tracer_torch.kernels import nvcc
from tracer_torch.kernels import pack as pack_mod
from tracer_torch.render import integrator, renderer

LAUNCHES = 0  # launches of the forward kernel since import (or since reset to 0)
LAUNCHES_RECORD = 0  # launches of the record-mode kernel
LAUNCHES_CLUSTERED = 0  # launches of the cluster-culled kernel


def library_path():
    return nvcc.library_path("megakernel")


def build() -> nvcc.Build:
    """Compile the kernels (once per source hash); the megakernel's Build."""
    return nvcc.build_all()["megakernel"]


def _fns():
    lib = build().lib
    p, i = ctypes.c_void_p, ctypes.c_int
    common = [p, i, p, i, p, p, i, i, p, p, i, i, i, i, ctypes.c_uint, i, i]
    fns = lib.tracer_megakernel_render, lib.tracer_megakernel_record, \
        lib.tracer_megakernel_render_clustered
    for fn, extra in zip(fns, ([p], [p, p, i, p], [p, p, i, i, p, p])):
        fn.argtypes = common + extra
        fn.restype = i
    return fns


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


def _args(scene, cam, tex, out, width, height, spp, max_depth, sample_start, reference_quirk,
          rr_start):
    packed = pack_mod.pack_scene(scene)
    cam_t = pack_mod.pack_camera(cam)
    th, tw = (0, 0) if tex is None else (int(tex.shape[0]), int(tex.shape[1]))
    # the caller holds the packed tensors until the launch is enqueued
    keep = (packed, cam_t)
    return keep, [packed.sph.data_ptr(), packed.num_s, packed.pla.data_ptr(), packed.num_p,
                  packed.join.data_ptr(), tex.data_ptr() if tex is not None else None, th, tw,
                  cam_t.data_ptr(), out.data_ptr(), width, height, spp, max_depth,
                  sample_start, int(reference_quirk), -1 if rr_start is None else rr_start]


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
    device, tex = _prepare(scene, cam, width, height, spp, max_depth, rr_start, sample_start)
    out = torch.empty((height, width, 3), dtype=torch.float32, device=device)
    _keep, args = _args(scene, cam, tex, out, width, height, spp, max_depth, sample_start,
                        reference_quirk, rr_start)
    err = _fns()[0](*args, torch.cuda.current_stream(device).cuda_stream)
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
    _keep, args = _args(scene, cam, tex, out, width, height, spp, max_depth, sample_start,
                        reference_quirk, rr_start)
    err = _fns()[2](*args, tables.boxes.data_ptr(), tables.slots.data_ptr(),
                    tables.num_clusters, tables.k, None if counts is None else counts.data_ptr(),
                    torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"clustered megakernel launch failed: CUDA error {err}")
    global LAUNCHES_CLUSTERED
    LAUNCHES_CLUSTERED += 1
    return out


def cluster_work(scene, cam, width: int, height: int, spp: int, max_depth: int, cluster_k: int,
                 reference_quirk: bool = True, rr_start=None, sample_start: int = 0):
    """The work of one cluster-culled launch with these arguments, counted
    by the kernel: (nearest-hit queries, clusters visited, primitives
    tested), as Python ints. CUDA scenes only; synchronises."""
    if scene.device.type != "cuda":
        raise ValueError("cluster_work counts inside the CUDA kernel: the scene must be on CUDA")
    if not cluster_mod.check_k(cluster_k):
        raise ValueError("cluster_work needs cluster_k >= 1")
    counts = torch.zeros(3, dtype=torch.int64, device=scene.device)
    _render_clustered(scene, cam, width, height, spp, max_depth, reference_quirk, rr_start,
                      sample_start, cluster_k, counts)
    return tuple(int(c) for c in counts.tolist())


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
    _keep, args = _args(scene, cam, tex, out, width, height, spp, max_depth, sample_start,
                        reference_quirk, rr_start)
    err = _fns()[1](*args, idx.data_ptr(), None if ttape is None else ttape.data_ptr(),
                    tape_fields if ttape is not None else 0,
                    torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"record kernel launch failed: CUDA error {err}")
    global LAUNCHES_RECORD
    LAUNCHES_RECORD += 1
    if ttape is None:
        return out, idx
    return out, idx, ttape.permute(1, 2, 3, 0)
