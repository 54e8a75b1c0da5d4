"""The Perlin noise and marble of Shirley's "Ray Tracing: The Next Week"
(book 2, v3.2.3, section 5: `perlin::noise`, `perlin::turb`,
`noise_texture::value`), in float32, in the float forms of the CUDA
kernel's `turb` (csrc/megakernel.cu): each octave's corner sums in the
book's loop order (di, dj, dk), its Hermite weights u u (3 - 2 u), and the
octaves summed with weights 1, 1/2, 1/4, ...; the book computes in double.

The noise is taken in the book's y-up frame: a port point (x, y, z) is the
book's (x, z, -y) (scene/types.py: the convention of a scene with book 2's
fields).
"""

from __future__ import annotations

import torch

TURB_DEPTH = 7  # perlin::turb's default depth


def book_frame(p: torch.Tensor) -> torch.Tensor:
    """`[..., 3]` port points as the book's (x, z, -y)."""
    return torch.stack([p[..., 0], p[..., 2], -p[..., 1]], dim=-1)


def noise(vectors: torch.Tensor, perm: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """perlin::noise at book-frame points `p` `[R, 3]`: `[R]`."""
    f = torch.floor(p)
    uvw = p - f
    ijk = f.to(torch.int64)
    hw = uvw * uvw * (3.0 - 2.0 * uvw)  # Hermite weights
    perm = perm.long()
    acc = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for di in (0, 1):
        px = perm[0][(ijk[..., 0] + di) & 255]
        wx = hw[..., 0] if di else 1.0 - hw[..., 0]
        for dj in (0, 1):
            pxy = px ^ perm[1][(ijk[..., 1] + dj) & 255]
            wy = hw[..., 1] if dj else 1.0 - hw[..., 1]
            for dk in (0, 1):
                g = vectors[pxy ^ perm[2][(ijk[..., 2] + dk) & 255]]
                wz = hw[..., 2] if dk else 1.0 - hw[..., 2]
                dot = (g[..., 0] * (uvw[..., 0] - di) + g[..., 1] * (uvw[..., 1] - dj)
                       + g[..., 2] * (uvw[..., 2] - dk))
                acc = acc + wx * wy * wz * dot
    return acc


def turb(vectors: torch.Tensor, perm: torch.Tensor, p: torch.Tensor,
         depth: int = TURB_DEPTH) -> torch.Tensor:
    """perlin::turb at book-frame points `p` `[R, 3]`: |sum_k 2^-k
    noise(2^k p)| over `depth` octaves, `[R]`."""
    acc = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    weight = 1.0
    for _ in range(depth):
        acc = acc + weight * noise(vectors, perm, p)
        weight *= 0.5
        p = p * 2.0
    return acc.abs()


def marble(n, point: torch.Tensor) -> torch.Tensor:
    """noise_texture::value at port points `point` `[R, 3]` for a
    types.Noise `n`: 0.5 (1 + sin(scale z + 10 turb(p))) in the book's
    frame, `[R]`."""
    p = book_frame(point)
    return 0.5 * (1.0 + torch.sin(n.scale * p[..., 2] + 10.0 * turb(n.vectors, n.perm, p)))
