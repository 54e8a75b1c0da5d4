"""Ray-sphere intersection over `[R]` rays x `[S]` spheres (port of
tracer.geometry.sphere): a branchless `[R, S]` root matrix with misses
at K_INFINITY, from which the nearest hit is an argmin."""

from __future__ import annotations

import math

import torch

from tracer_torch.core import vec
from tracer_torch.scene.types import K_INFINITY


def discriminant(oc, direction, a, half_b, radius, perpendicular: bool):
    """half_b^2 - a c, or with `perpendicular` a (r^2 - |l|^2), l = oc -
    (half_b / a) d the part of oc across the ray: the same in reals, but
    rounded near r^2 instead of near |oc|^2, so a sphere hundreds of radii
    away keeps its roots to float32 rounding of the hit (Haines, Guenther
    and Akenine-Moeller, "Precision Improvements for Ray/Sphere
    Intersection", Ray Tracing Gems, 2019, ch. 7)."""
    if perpendicular:
        k = half_b * (1.0 / a)
        lv = oc - direction * k[..., None]
        return a * (radius * radius - torch.sum(lv * lv, dim=-1))
    c = torch.sum(oc * oc, dim=-1) - radius * radius
    return half_b * half_b - a * c


def sphere_ts(origin, direction, center, radius, t_min, t_max, perpendicular: bool = False):
    """Nearest valid root per (ray, sphere), near root before far root
    (reference include/sphere.h:24-53), in the direct `oc = o - c` form.

    origin, direction: `[R, 3]` (direction not normalized); center `[S, 3]`,
    or `[R, S, 3]` per ray (moving spheres at each ray's time), radius
    `[S]`. Returns `[R, S]` float32, K_INFINITY where no valid hit. With
    `perpendicular`, the discriminant's perpendicular form (book 2's
    scenes; `discriminant`).
    """
    oc = origin[:, None, :] - (center if center.dim() == 3 else center[None, :, :])  # [R, S, 3]
    a = vec.length_squared(direction)[:, None]  # [R, 1]
    half_b = torch.sum(oc * direction[:, None, :], dim=-1)  # [R, S]
    disc = discriminant(oc, direction[:, None, :], a, half_b, radius[None, :], perpendicular)
    hit = disc >= 0.0
    sqrt_d = torch.sqrt(torch.where(hit, disc, 1.0))
    inv_a = 1.0 / a
    t_near = (-half_b - sqrt_d) * inv_a
    t_far = (-half_b + sqrt_d) * inv_a
    near_ok = hit & (t_near >= t_min) & (t_near <= t_max)
    far_ok = hit & (t_far >= t_min) & (t_far <= t_max)
    return torch.where(near_ok, t_near, torch.where(far_ok, t_far, K_INFINITY))


def sphere_t_gathered(origin, direction, center, radius, t_min, t_max,
                      perpendicular: bool = False):
    """Nearest valid root for per-ray gathered spheres (one per ray; the
    BVH's leaf test and its winner's recompute): `sphere_ts` with every
    field already `[R, ...]`. Returns `[R]`, K_INFINITY where no valid hit."""
    oc = origin - center
    a = vec.length_squared(direction)
    half_b = torch.sum(oc * direction, dim=-1)
    disc = discriminant(oc, direction, a, half_b, radius, perpendicular)
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


def sphere_uv_book(outward_normal):
    """The UVs of book 2's `sphere::get_sphere_uv` (v3.2.3) in its y-up frame,
    the port's (x, y, z) being the book's (x, z, -y): theta = acos(-y_book)
    = acos(-z), phi = atan2(-z_book, x_book) + pi = atan2(y, x) + pi."""
    p = outward_normal
    theta = torch.acos(torch.clamp(-p[..., 2], -1.0, 1.0))
    phi = torch.atan2(p[..., 1], p[..., 0]) + math.pi
    return phi / (2.0 * math.pi), theta / math.pi


def sphere_record(origin, direction, t, center, radius, book_uv: bool = False):
    """Hit point, face-oriented normal, front face and UVs for rays whose
    winner is a sphere (per-ray gathered fields; sphere.h:46-51); with
    `book_uv`, book 2's UVs (sphere_uv_book)."""
    point = origin + t[..., None] * direction
    outward = (point - center) / radius[..., None]
    front_face = vec.dot(direction, outward) < 0.0
    normal = torch.where(front_face[..., None], outward, -outward)
    u, v = (sphere_uv_book if book_uv else sphere_uv)(outward)
    return point, normal, front_face, u, v
