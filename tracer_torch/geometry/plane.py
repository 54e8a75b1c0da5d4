"""Ray-planar-primitive intersection over `[R]` rays x `[P]` planes (port
of tracer.geometry.plane): one branchless test for the quad, ellipse and
triangle interiors of reference `hit_plane` (include/plane.h:57-96)."""

from __future__ import annotations

import torch

from tracer_torch.core import vec
from tracer_torch.scene.types import ELLIPSE, K_INFINITY, QUAD

DENOM_EPS = 1e-8  # reference plane.h:59


def plane_alpha_beta(origin, direction, base, normal, d, w, u, v):
    """Plane root and planar (alpha, beta) coordinates (plane.h:58-70):
    root = (D - n.orig) / (n.dir); alpha = w . cross(p - base, v);
    beta = w . cross(u, p - base). Returns (denom, root, alpha, beta)."""
    denom = torch.sum(normal * direction, dim=-1)
    safe_denom = torch.where(torch.abs(denom) < DENOM_EPS, 1.0, denom)
    root = (d - torch.sum(normal * origin, dim=-1)) / safe_denom
    point = origin + root[..., None] * direction
    phv = point - base
    alpha = torch.sum(w * vec.cross(phv, v), dim=-1)
    beta = torch.sum(w * vec.cross(u, phv), dim=-1)
    return denom, root, alpha, beta


def interior_mask(ptype, alpha, beta):
    """QUAD closed [0,1]^2; ELLIPSE (a-.5)^2+(b-.5)^2 <= .25; TRIANGLE
    a>=0, b>=0, a+b<=1 (plane.h:30-55)."""
    in_quad = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
    in_ellipse = (alpha - 0.5) ** 2 + (beta - 0.5) ** 2 <= 0.25
    in_tri = (alpha >= 0.0) & (beta >= 0.0) & (alpha + beta <= 1.0)
    return torch.where(ptype == QUAD, in_quad, torch.where(ptype == ELLIPSE, in_ellipse, in_tri))


def plane_ts(origin, direction, planes, t_min, t_max):
    """Valid hit parameter per (ray, plane), `[R, P]`; K_INFINITY on a miss."""
    denom, root, alpha, beta = plane_alpha_beta(
        origin[:, None, :],
        direction[:, None, :],
        planes.base[None],
        planes.normal[None],
        planes.d[None],
        planes.w[None],
        planes.u[None],
        planes.v[None],
    )
    ok = (
        (torch.abs(denom) >= DENOM_EPS)
        & (root >= t_min)
        & (root <= t_max)
        & interior_mask(planes.ptype[None], alpha, beta)
    )
    return torch.where(ok, root, K_INFINITY)


def plane_t_gathered(origin, direction, ptype, base, u, v, normal, d, w, t_min, t_max):
    """Valid hit parameter for per-ray gathered planes (one per ray; the
    BVH's leaf test and its winner's recompute): `plane_ts` with every
    field already `[R, ...]`. Returns `[R]`, K_INFINITY on a miss."""
    denom, root, alpha, beta = plane_alpha_beta(origin, direction, base, normal, d, w, u, v)
    ok = (
        (torch.abs(denom) >= DENOM_EPS)
        & (root >= t_min)
        & (root <= t_max)
        & interior_mask(ptype, alpha, beta)
    )
    return torch.where(ok, root, K_INFINITY)


def plane_record(origin, direction, t, base, u, v, normal, w):
    """Hit point, face-oriented normal, front face and planar UVs for rays
    whose winner is a plane (per-ray gathered fields; plane.h:84-94)."""
    point = origin + t[..., None] * direction
    phv = point - base
    alpha = torch.sum(w * vec.cross(phv, v), dim=-1)
    beta = torch.sum(w * vec.cross(u, phv), dim=-1)
    front_face = vec.dot(direction, normal) < 0.0
    out_normal = torch.where(front_face[..., None], normal, -normal)
    return point, out_normal, front_face, alpha, beta
