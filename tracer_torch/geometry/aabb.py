"""Axis-aligned boxes: the slab test on tensors and the host-side box
helpers (port of tracer.geometry.aabb; reference `AABB::hit`,
include/aabb.h:42-65, and `expand_to_min`, aabb.h:92-97, delta 1e-4).

The box helpers are NumPy, copied as they are, so that the port's cluster
boxes equal tracer's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

PAD_DELTA = 1e-4  # reference aabb.h:36, :93 (delta = 0.0001)


def slab_hit(origin, direction, box_min, box_max, t_min, t_max):
    """True where the ray crosses the box within (t_min, t_max).

    reference aabb.h:42-65: shrinking interval, strict `max <= min` exit.
    Shapes broadcast: origin/direction `[..., 3]`, box_min/box_max `[..., 3]`;
    `t_max` may be a tensor of the leading shape (the BVH walk's per-ray
    closest). The inverse direction is unguarded and every min and max
    propagates NaN, as tracer's jnp ones do: a NaN distance (0 x inf, an
    origin on a face with a zero direction component) misses the box.
    """
    inv_d = 1.0 / direction
    t1 = (box_min - origin) * inv_d
    t2 = (box_max - origin) * inv_d
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    tmin = torch.clamp_min(torch.amax(lo, dim=-1), t_min)
    tmax = torch.clamp_max(torch.amin(hi, dim=-1), t_max)
    return tmax > tmin


# ----------------------------------------------------------------------
# Host-side (NumPy) box construction.
# ----------------------------------------------------------------------


def _expand_to_min(lo: np.ndarray, hi: np.ndarray):
    """Pad degenerate axes by delta/2 each side (aabb.h:26-29, 92-97)."""
    size = hi - lo
    pad = np.where(size < PAD_DELTA, PAD_DELTA / 2.0, 0.0)
    return lo - pad, hi + pad


def sphere_boxes(centers: np.ndarray, radii: np.ndarray):
    """AABBs of spheres (reference bvh_builder.h:17-20)."""
    r = radii[:, None]
    lo, hi = centers - r, centers + r
    return _expand_to_min(lo, hi)


def plane_boxes(base, u, v, ptype):
    """AABBs of planar primitives (reference bvh_builder.h:22-50).

    Corners p0..p2 always included; p3 = base+u+v only for QUAD/ELLIPSE
    (triangles exclude it), then `pad()`.
    """
    p0 = base
    p1 = base + u
    p2 = base + v
    p3 = base + u + v
    corners3 = np.stack([p0, p1, p2], axis=1)  # [P, 3, 3]
    lo3 = corners3.min(axis=1)
    hi3 = corners3.max(axis=1)
    quadlike = (np.asarray(ptype) != 2)[:, None]  # TRIANGLE == 2
    lo = np.where(quadlike, np.minimum(lo3, p3), lo3)
    hi = np.where(quadlike, np.maximum(hi3, p3), hi3)
    return _expand_to_min(lo.astype(np.float32), hi.astype(np.float32))
