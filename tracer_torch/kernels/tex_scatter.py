"""The texture-gradient scatter: binding and dispatch (port of
tracer/pallas/tex_scatter.py:texture_image_grads_kernel).

`texture_image_grads_kernel` scatters the backward kernel's per-bounce
texel cotangents onto the four bilinear corners of the texture image.
Its plain version is tracer_torch.kernels.bwd.texture_image_grads (four
`index_add_`s). CPU tensors go to the plain version, CUDA tensors to the
kernel (`csrc/tex_scatter.cu`) or an error. `LAUNCHES` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from tracer_torch.kernels import bwd, nvcc

LAUNCHES = 0  # launches of the CUDA scatter kernel since import (or since reset to 0)
THREADS = 256


def _fn():
    fn = nvcc.library("tex_scatter").tracer_tex_scatter
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, ctypes.c_longlong, ctypes.c_longlong, i, i, p, i, p]
    fn.restype = ctypes.c_int
    return fn


def texture_image_grads_kernel(gtex2, t2, spp: int, max_depth: int, th: int, tw: int):
    """`[th, tw, 3]` texture-image cotangent from `gtex2` `[3*R, P]`
    (channel-major texel cotangents, R = spp*max_depth) and the field-major
    13-field tape `t2` `[13*R, P]` (rows 9R..13R: x0, y0, fu, fv). Same
    value as the plain version up to float32 addition order (the kernel
    adds with atomics, in no fixed order)."""
    if gtex2.device.type == "cpu":
        return bwd.texture_image_grads(gtex2, t2, spp, max_depth, th, tw)
    if gtex2.device.type != "cuda":
        raise ValueError(f"texture_image_grads_kernel: no kernel for device {gtex2.device}")
    rows = spp * max_depth
    p = gtex2.shape[-1]
    if gtex2.shape != (3 * rows, p) or t2.shape != (13 * rows, p):
        raise ValueError(f"need gtex [3R, P] and a 13-field tape [13R, P] with R = {rows}, "
                         f"got {tuple(gtex2.shape)} and {tuple(t2.shape)}")
    for name, t in (("gtex", gtex2), ("tape", t2)):
        if t.device != gtex2.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous float32 on {gtex2.device}")
    if th * tw * 3 >= 2**31:
        raise ValueError(f"texture {th}x{tw} exceeds the kernel's int32 texel index")
    out = torch.zeros((th, tw, 3), dtype=torch.float32, device=gtex2.device)
    stream = torch.cuda.current_stream(gtex2.device).cuda_stream
    err = _fn()(gtex2.data_ptr(), t2[9 * rows:].data_ptr(), rows, p, th, tw, out.data_ptr(),
                THREADS, stream)
    if err != 0:
        raise RuntimeError(f"texture scatter launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
