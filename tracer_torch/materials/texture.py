"""Bilinear texture sampling with reference `tex2D_cpu` semantics (port
of tracer.materials.texture; include/materials.h:20-51): wrap by floor,
v flip, truncation to the texel, neighbour wrap by modulo, bilinear blend."""

from __future__ import annotations

import torch


def sample_bilinear(textures: torch.Tensor, tex_id: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Sample `textures[tex_id]` (`[T, H, W, 3]` float32) at (u, v), both
    `[R]`. Negative ids are clamped to 0; callers mask untextured rays.
    Returns `[R, 3]`."""
    _, height, width, _ = textures.shape
    tid = torch.clamp_min(tex_id, 0).long()

    u = u - torch.floor(u)  # materials.h:23
    v = v - torch.floor(v)  # materials.h:24
    px = u * width  # materials.h:26
    py = (1.0 - v) * height  # materials.h:27 (v flip)

    # truncation == floor for px >= 0; float32 rounding can land on W
    x0 = torch.clamp(px.to(torch.int64), 0, width - 1)
    y0 = torch.clamp(py.to(torch.int64), 0, height - 1)
    x1 = (x0 + 1) % width  # materials.h:30
    y1 = (y0 + 1) % height  # materials.h:31

    dx = (px - x0.to(px.dtype))[..., None]
    dy = (py - y0.to(py.dtype))[..., None]

    c00 = textures[tid, y0, x0]
    c10 = textures[tid, y0, x1]
    c01 = textures[tid, y1, x0]
    c11 = textures[tid, y1, x1]

    top = c00 * (1.0 - dx) + c10 * dx
    bot = c01 * (1.0 - dx) + c11 * dx
    return top * (1.0 - dy) + bot * dy
