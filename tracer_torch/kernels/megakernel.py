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

The kernel is compiled at first use by `nvcc` into a shared library with
a plain C entry point, loaded with ctypes. The library's file name carries
a hash of the sources and flags, so an edited source builds anew.
`LAUNCHES` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

from tracer_torch.kernels import pack as pack_mod
from tracer_torch.render import renderer

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tracer_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = 0  # launches of the CUDA kernel since import (or since reset to 0)


class Build(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (ptxas register and spill report), "" if cached


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtracer_megakernel-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin): "
                           "the CUDA megakernel cannot be built")
    return nvcc


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Compile `csrc/megakernel.cu` (once per source hash) and load it."""
    path = library_path()
    seconds, log = 0.0, ""
    if not path.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)  # atomic: a concurrent build never loads half a file
    lib = ctypes.CDLL(str(path))
    fn = lib.tracer_megakernel_render
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, i, p, p, i, i, p, p, i, i, i, i, ctypes.c_uint, i, i, p]
    fn.restype = ctypes.c_int
    return Build(lib, path, seconds, log)


def _check(name, t, device, shape=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the scene on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def render_frame_kernel(scene, cam, width: int, height: int, spp: int, max_depth: int,
                        reference_quirk: bool = True, rr_start=None, sample_start: int = 0):
    """Render one frame; returns `[height, width, 3]` raw sample sums of the
    global samples `sample_start .. sample_start + spp - 1`.

    Same contract, RNG streams and estimator as
    `tracer_torch.render.renderer.render_frame`, which it calls for a scene
    on the CPU. For a CUDA scene it launches the kernel on the current
    stream without synchronising, or raises.
    """
    device = scene.device
    if device.type == "cpu":
        return renderer.render_frame(scene, cam, width, height, spp, max_depth,
                                     reference_quirk=reference_quirk, rr_start=rr_start,
                                     sample_start=sample_start)
    if device.type != "cuda":
        raise ValueError(f"render_frame_kernel: no kernel for device {device}")

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
    tex, th, tw = None, 0, 0
    if scene.textures is not None:
        _check("textures", scene.textures, device)
        if scene.textures.dim() != 4 or scene.textures.shape[-1] != 3:
            raise ValueError(f"textures must be [T, H, W, 3], got {tuple(scene.textures.shape)}")
        if scene.textures.shape[0] != 1:
            raise ValueError("megakernel: one texture layer only")
        tex = scene.textures[0].contiguous()
        th, tw = int(tex.shape[0]), int(tex.shape[1])
    for name, t in zip(cam._fields, cam):
        _check(f"cam.{name}", t, device, (3,))

    packed = pack_mod.pack_scene(scene)
    cam_t = pack_mod.pack_camera(cam)
    out = torch.empty((height, width, 3), dtype=torch.float32, device=device)
    fn = build().lib.tracer_megakernel_render
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(packed.sph.data_ptr(), packed.num_s, packed.pla.data_ptr(), packed.num_p,
             packed.join.data_ptr(), tex.data_ptr() if tex is not None else None, th, tw,
             cam_t.data_ptr(), out.data_ptr(), width, height, spp, max_depth, sample_start,
             int(reference_quirk), -1 if rr_start is None else rr_start, stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
