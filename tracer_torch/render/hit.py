"""Brute nearest-hit over all primitives (port of tracer.render.hit;
reference `hit_scene`, include/scene.h:23-54).

The valid-hit parameter of every (ray, primitive) pair forms a dense
`[R, S+P]` matrix, spheres first; the argmin picks the winner, so ties go
to the lowest index with spheres before planes. The winner's record is
then recomputed from its gathered fields and joined with its material;
its index (`winner`) is what the recording renderer writes to its tape.
This one brute intersector stands in for both `hit.py` and `hit_fast.py`
of the JAX package (the latter is a TPU matrix-unit formulation).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tracer_torch.core import T_MAX, T_MIN
from tracer_torch.geometry import plane as plane_mod
from tracer_torch.geometry import sphere as sphere_mod
from tracer_torch.scene.types import K_INFINITY, Scene


class JoinedHit(NamedTuple):
    """Per-ray winner record with its material fields joined."""

    hit: torch.Tensor  # [R] bool
    t: torch.Tensor  # [R] f32
    point: torch.Tensor  # [R, 3]
    normal: torch.Tensor  # [R, 3] face-oriented
    front_face: torch.Tensor  # [R] bool
    u: torch.Tensor  # [R]
    v: torch.Tensor  # [R]
    mtype: torch.Tensor  # [R] i32
    fuzz: torch.Tensor  # [R]
    ir: torch.Tensor  # [R]
    absorption: torch.Tensor  # [R, 3]
    albedo: torch.Tensor  # [R, 3]
    emit: torch.Tensor  # [R, 3]
    tex_id: torch.Tensor  # [R] i32
    winner: torch.Tensor  # [R] i64 argmin over [spheres; planes] (meaningless on a miss)


def hit_scene_brute(scene: Scene, origin, direction, t_min=T_MIN, t_max=T_MAX) -> JoinedHit:
    """Nearest hit over all spheres and planes; origin/direction `[R, 3]`."""
    num_s, num_p = scene.num_spheres, scene.num_planes
    if num_s + num_p == 0:
        raise ValueError("scene has no primitives")
    ts = []
    if num_s:
        ts.append(sphere_mod.sphere_ts(origin, direction, scene.spheres.center,
                                       scene.spheres.radius, t_min, t_max))
    if num_p:
        ts.append(plane_mod.plane_ts(origin, direction, scene.planes, t_min, t_max))
    t_all = torch.cat(ts, dim=1)  # [R, S+P]
    t_best, winner = torch.min(t_all, dim=1)  # first minimum: lowest index
    hit = t_best < K_INFINITY
    # records of missing rays are computed at a harmless t and masked later
    t_calc = torch.where(hit, t_best, 1.0)
    is_sphere = winner < num_s
    s_idx = torch.where(is_sphere, winner, 0)
    p_idx = torch.where(is_sphere, 0, winner - num_s)

    fields = []
    if num_s:
        sp = scene.spheres
        rec = sphere_mod.sphere_record(origin, direction, t_calc, sp.center[s_idx], sp.radius[s_idx])
        fields.append(rec + (sp.material_idx[s_idx],))
    if num_p:
        pl = scene.planes
        rec = plane_mod.plane_record(origin, direction, t_calc, pl.base[p_idx], pl.u[p_idx],
                                     pl.v[p_idx], pl.normal[p_idx], pl.w[p_idx])
        fields.append(rec + (pl.material_idx[p_idx],))
    if len(fields) == 2:
        sel = [is_sphere[:, None] if f.dim() == 2 else is_sphere for f in fields[0]]
        point, normal, front, u, v, midx = (
            torch.where(m, a, b) for m, a, b in zip(sel, fields[0], fields[1]))
    else:
        point, normal, front, u, v, midx = fields[0]

    mats = scene.materials
    midx = midx.long()
    return JoinedHit(
        hit=hit, t=t_best, point=point, normal=normal, front_face=front, u=u, v=v,
        mtype=mats.mtype[midx], fuzz=mats.fuzz[midx], ir=mats.ir[midx],
        absorption=mats.absorption[midx], albedo=mats.albedo[midx],
        emit=mats.emit[midx], tex_id=mats.tex_id[midx], winner=winner,
    )
