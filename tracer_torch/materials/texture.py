"""Bilinear texture sampling with reference `tex2D_cpu` semantics (port
of tracer.materials.texture; include/materials.h:20-51): wrap by floor,
v flip, truncation to the texel, neighbour wrap by modulo, bilinear blend.

`bilinear_tape` adds what the recording renderer puts on its texture tape
(tracer/pallas/kernel_lib.py:_shade, `tape_fields`): the texel's
derivatives `tw * dT/dpx` and `-th * dT/dpy` (bilinear is separately linear
in px and py, so these are the exact d(texel)/du and d(texel)/dv) and the
addressing (x0, y0, fu, fv) of its four corners.
"""

from __future__ import annotations

import torch


def _tex_addressing(u, v, height: int, width: int):
    """tex2D_cpu address math (kernel_lib.py:_tex_addressing): wrap, v flip,
    truncation, neighbour wrap. Returns int64 corners and the weights."""
    u = u - torch.floor(u)  # materials.h:23
    v = v - torch.floor(v)  # materials.h:24
    px = u * width  # materials.h:26
    py = (1.0 - v) * height  # materials.h:27 (v flip)
    # truncation == floor for px >= 0; float32 rounding can land on W
    x0 = torch.clamp(px.to(torch.int64), 0, width - 1)
    y0 = torch.clamp(py.to(torch.int64), 0, height - 1)
    x1 = (x0 + 1) % width  # materials.h:30
    y1 = (y0 + 1) % height  # materials.h:31
    return x0, y0, x1, y1, px - x0.to(px.dtype), py - y0.to(py.dtype)


def _corners(textures, tex_id, u, v):
    _, height, width, _ = textures.shape
    tid = torch.clamp_min(tex_id, 0).long()
    x0, y0, x1, y1, dx, dy = _tex_addressing(u, v, height, width)
    c = (textures[tid, y0, x0], textures[tid, y0, x1],
         textures[tid, y1, x0], textures[tid, y1, x1])
    return c, x0, y0, dx[..., None], dy[..., None]


def sample_bilinear(textures: torch.Tensor, tex_id: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Sample `textures[tex_id]` (`[T, H, W, 3]` float32) at (u, v), both
    `[R]`. Negative ids are clamped to 0; callers mask untextured rays.
    Returns `[R, 3]`."""
    (c00, c10, c01, c11), _, _, dx, dy = _corners(textures, tex_id, u, v)
    top = c00 * (1.0 - dx) + c10 * dx
    bot = c01 * (1.0 - dx) + c11 * dx
    return top * (1.0 - dy) + bot * dy


def bilinear_tape(textures: torch.Tensor, tex_id: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor):
    """The texel at (u, v) and its tape fields: returns (value `[R, 3]`,
    `tw * dT/dpx` `[R, 3]`, `-th * dT/dpy` `[R, 3]`, addressing `[R, 4]` as
    float x0, y0, fu, fv), as the recording kernel computes them."""
    _, height, width, _ = textures.shape
    (c00, c10, c01, c11), x0, y0, dx, dy = _corners(textures, tex_id, u, v)
    top = c00 * (1.0 - dx) + c10 * dx
    bot = c01 * (1.0 - dx) + c11 * dx
    value = top * (1.0 - dy) + bot * dy
    dpx = (1.0 - dy) * (c10 - c00) + dy * (c11 - c01)
    dpy = bot - top
    addr = torch.stack([x0.to(u.dtype), y0.to(u.dtype), dx[..., 0], dy[..., 0]], dim=-1)
    return value, dpx * float(width), dpy * -float(height), addr
