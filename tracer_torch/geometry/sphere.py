"""Ray-sphere intersection over `[R]` rays x `[S]` spheres (port of
tracer.geometry.sphere): a branchless `[R, S]` root matrix with misses
at K_INFINITY, from which the nearest hit is an argmin."""

from __future__ import annotations

import math

import torch

from tracer_torch.core import vec
from tracer_torch.scene.types import K_INFINITY


def sphere_ts(origin, direction, center, radius, t_min, t_max):
    """Nearest valid root per (ray, sphere), near root before far root
    (reference include/sphere.h:24-53), in the direct `oc = o - c` form.

    origin, direction: `[R, 3]` (direction not normalized); center `[S, 3]`,
    radius `[S]`. Returns `[R, S]` float32, K_INFINITY where no valid hit.
    """
    oc = origin[:, None, :] - center[None, :, :]  # [R, S, 3]
    a = vec.length_squared(direction)[:, None]  # [R, 1]
    half_b = torch.sum(oc * direction[:, None, :], dim=-1)  # [R, S]
    c = torch.sum(oc * oc, dim=-1) - (radius * radius)[None, :]
    disc = half_b * half_b - a * c
    hit = disc >= 0.0
    sqrt_d = torch.sqrt(torch.where(hit, disc, 1.0))
    inv_a = 1.0 / a
    t_near = (-half_b - sqrt_d) * inv_a
    t_far = (-half_b + sqrt_d) * inv_a
    near_ok = hit & (t_near >= t_min) & (t_near <= t_max)
    far_ok = hit & (t_far >= t_min) & (t_far <= t_max)
    return torch.where(near_ok, t_near, torch.where(far_ok, t_far, K_INFINITY))


def sphere_t_gathered(origin, direction, center, radius, t_min, t_max):
    """Nearest valid root for per-ray gathered spheres (one per ray; the
    BVH's leaf test and its winner's recompute): `sphere_ts` with every
    field already `[R, ...]`. Returns `[R]`, K_INFINITY where no valid hit."""
    oc = origin - center
    a = vec.length_squared(direction)
    half_b = torch.sum(oc * direction, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - radius * radius
    disc = half_b * half_b - a * c
    hit = disc >= 0.0
    sqrt_d = torch.sqrt(torch.where(hit, disc, 1.0))
    inv_a = 1.0 / a
    t_near = (-half_b - sqrt_d) * inv_a
    t_far = (-half_b + sqrt_d) * inv_a
    near_ok = hit & (t_near >= t_min) & (t_near <= t_max)
    far_ok = hit & (t_far >= t_min) & (t_far <= t_max)
    return torch.where(near_ok, t_near, torch.where(far_ok, t_far, K_INFINITY))


def sphere_uv(outward_normal):
    """Spherical UVs from the unit outward normal (reference
    include/sphere.h:16-22): u = (atan2(-z, x) + pi) / 2pi, v = acos(y) / pi."""
    p = outward_normal
    theta = torch.acos(torch.clamp(p[..., 1], -1.0, 1.0))
    phi = torch.atan2(-p[..., 2], p[..., 0]) + math.pi
    return phi / (2.0 * math.pi), theta / math.pi


def sphere_record(origin, direction, t, center, radius):
    """Hit point, face-oriented normal, front face and UVs for rays whose
    winner is a sphere (per-ray gathered fields; sphere.h:46-51)."""
    point = origin + t[..., None] * direction
    outward = (point - center) / radius[..., None]
    front_face = vec.dot(direction, outward) < 0.0
    normal = torch.where(front_face[..., None], outward, -outward)
    u, v = sphere_uv(outward)
    return point, normal, front_face, u, v
